#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA.  It imports only the port (``dt_tpu_torch``), never
JAX.  Phases, each fatal on failure:

1. setup: the card's name and power limit, versions, the kernels' build
   (``nvcc``, one process per source, all started together);
2. kernels: every distinct BatchNorm shape of ResNet-50 v1 at 224x224,
   batch 32 and batch 21 (the elastic job's three workers), plus ragged
   and misaligned cases (and, held in bfloat16 but not timed, the policy
   job's batches 13, 22, 25 and 26), in float32 and bfloat16 with
   ReLU on and off: the BN-inference kernel against its plain PyTorch
   version on the same inputs (max abs difference must be 0), and the times
   of the kernel, the plain version and ``F.batch_norm`` (a yardstick the
   port never calls) against the bytes bound;
3. training kernels: the BN-train pass 1 at the same shapes, held against
   its plain version (mean and var within 1e-5 of the largest E[x^2], two
   launches bit-identical, y bit-equal to the plain pass 2 on the kernel's
   stats, one CUDA kernel a call in a ``torch.profiler`` window, a window
   that recorded no device event taken again up to three times while the
   wrapper counts one launch in each), and the
   2-bit quantize/dequantize pair at ResNet-50's parameter
   count and at 0, 1, 15, 17 and 1000 elements with values at +-t, +-0,
   +-inf and NaN, bit for bit; each timed beside its bound, its plain
   version and, for BN, ``F.batch_norm(training=True)``;
4. serve: ResNet-50 v1 at full width (224x224x3, 1000 classes) from seeded
   weights carried in through ``load_jax_variables``, served through
   ``Predictor`` (buckets up to 64) in float32 and bfloat16: requests of 1,
   3, 32 and 130 rows, 53 kernel launches per chunk forward, float32 logits
   against the port on the CPU, bfloat16 against float32, and per-bucket
   latency and throughput;
5. train: ResNet-50 v1 at full width, batch 32, the same seeded weights,
   SGD (momentum 0.9, lr 0.1, wd 1e-4) through ``grad_step``/``apply_step``
   in three modes (bfloat16 compute on float32 params, float32, bfloat16
   with the 2-bit compressed leg): ten steps on one batch (loss finite and
   falling; 53 + 53 BN-train launches a step, 1 + 1 codec launches a
   compressed step), step time queued and synced, images/s, a profile of
   one step, model FLOPs; and one float32 step at batch 2 against the port
   on the CPU;
6. LM kernels: ``flash_attention`` at the TransformerLM's shape (B=8,
   S=2048, H=8, D=64, causal; q/k/v strided views of one qkv buffer, as the
   model hands them), at D=128 with S=1024 (causal) and at the LM's shape
   without the mask, each in bfloat16 and float32, out and lse held against
   ``flash_attention_plain``, two launches bit-identical, timed beside the
   bound (for f32 also the 3xTF32 bound of its tensor-core kernel), the
   plain version and ``F.scaled_dot_product_attention`` (a yardstick the
   port never calls), with TFLOP/s and the share of the bound;
   ``lstm_pointwise`` at B=32 and H=200 (the PTB example's default) and
   H=650, against its plain version, beside
   ``torch.ops.aten._thnn_fused_lstm_cell`` (also never called by the
   port); the LSTM layer kernel over a PTB window (T 35, B 32) at H 200
   and 650, forward and reverse, against its plain step loop (1e-5, bits
   repeated), timed alone and with its input product beside the per-step
   path, the plain loop, cuDNN's one-layer ``torch._VF.lstm`` (never
   called by the port), its bound and its serial floor; the bf16 layer
   kernel (tensor cores) at the same window, H 200 and 650, both
   directions, against its plain loop (2^-6 of each output's largest,
   bits repeated), timed beside its bound, the plain loop, the stepped bf16
   cell and cuDNN's bf16 ``_VF.lstm``; the BPTT kernel in f32 and bf16 at
   the same shapes against its plain loop (1e-5 / 2^-6), timed beside its
   bound, the plain loop, the stepped path's backward and cuDNN's (forward
   + backward less forward, CUDA events);
7. train the TransformerLM of ``bench.py:579-598`` at full width (vocab
   8192, 512 wide, 6 layers, 8 heads, S 2048, batch 8, bfloat16 compute,
   ``seq_parallel="flash"``, SGD lr 0.1 momentum 0.9) for ten steps on one
   batch (loss finite and falling; 6 flash launches a forward), step time
   queued and synced, tokens/s, a profile of one step, model FLOPs; then
   one float32 step at 2 layers, S 256, batch 2 against the port on the
   CPU;
8. train the LSTM LM of ``examples/train_lstm_ptb.py`` with its defaults
   (vocab 10000, 200/200, 2 layers, bptt 35, batch 32, SGD lr 1.0, clip
   0.25, dropout 0.2 from a seeded generator) for ten windows with the
   state carried (loss falling; 2 ``lstm_layer`` launches a forward, 2
   ``lstm_layer_bwd`` a backward and no ``lstm_pointwise``), window time,
   tokens/s, a profile; then one float32 window at dropout 0 against the
   port on the CPU (2 ``lstm_layer`` and 2 ``lstm_layer_bwd`` launches;
   the TransformerLM's f32 step: 2 f32 flash launches);
9. the PTB LSTM LM's forward in bfloat16 over one window, through the
   bf16 layer kernel (2 ``lstm_layer`` launches, no ``lstm_pointwise``),
   its logits against float32; then an f32 layer too wide for the layer
   kernels (B 1, H 6656, T 3), which steps the fused cell (3
   ``lstm_pointwise`` launches), against the plain cell;
10. ``Module.fit`` (run after the train phase, before the LM phases):
   ResNet-50 v1 in bfloat16 at full width from the port's own
   ``init_params(seed=0)``, SGD lr 0.0125 (0.1 scaled to batch 32),
   momentum 0.9, wd 1e-4, 4 epochs of a shuffled
   seeded 64-image ``NDArrayIter`` (batch 32) behind a
   ``DevicePrefetchIter``, with ``eval_data`` (32 images), metrics ce and
   acc, a ``Speedometer`` and ``do_checkpoint``: 53 ``bn_stats`` launches a
   step and 53 ``bn_act`` a step plus 53 an eval forward, train loss finite
   and falling, the last checkpoint reloaded into a bf16 ``Predictor``
   against ``Module.predict``; fit's step time and a profile of one epoch
   beside phase 5's bare step; then a small f32 ``fit`` (resnet20, 8x8x3)
   on the card against the CPU, per-epoch loss within 1e-4 relative.  The
   flash kernels of phase 6 are also held and timed at D 16 and D 8 (the
   heads of the repo's small flash models);
11. the elastic host-sync job (after ``fit``): the port's ``Scheduler`` in
   this process and ``tests/torch_elastic_worker.py`` processes on the
   card: ResNet-50 v1 at full width in bf16 on f32 params, global batch
   64, SGD lr 0.025 momentum 0.9 wd 1e-4, 2-bit at 0.005, the overlapped
   step, 3 epochs of 8 steps, 64 images scored after every epoch; ``w2``
   added at the epoch-1 boundary (bootstrapping from the snapshot) and
   removed at the epoch-2 one; the live workers' sha256 equal at every
   epoch end, 53 + 53 BN-train and 1 codec launch a step, 53 BN-inference
   launches a scored batch, 6,389,260 bytes of packed words a step; each
   epoch's steps after its first timed as a window on worker 0's clock
   (2, 3, 2 workers), the step's parts from worker 0's spans beside the
   bare step, and the scheduler's straggler board (it traces here) at
   every epoch's end; then 2-worker f32 resnet20 jobs (32x32x3) on the
   card, each step recorded and replayed on the CPU from the card's state
   (``tests/torch_elastic_drift.py``: loss, stats, update and, where no
   ReLU mask flipped, gradient within 1e-4; the applied average exact;
   per-epoch loss within 1e-4 of the replay and of the same job on the
   CPU up to the first flipped mask), and with ``DT_AR_OVERLAP=0`` (the
   same sha256 as the overlapped job);
12. sharded: the elastic job of phase 11 again with its data plane on 2
   port ``RangeServer`` processes (dense and 2-bit chunks round-robin
   across them); every worker's sha256 at every epoch end equal to phase
   11's (both run cuDNN's deterministic algorithms), its windows and
   ``pipeline.wire`` beside the funnel's;
13. async: ResNet-50 v1 bf16 through ``Module.fit(kvstore="dist_async")``,
   two workers at 32 images then a joiner at epoch 1 (2 epochs of 8
   steps), the port's ``Scheduler`` with the server-side sgd (lr 0.025,
   momentum 0.9, wd 1e-4) logging every applied push: applied pushes =
   steps taken, the first 8 replayed in the logged order by the port's
   ``NpUpdater`` on the CPU from the seeded master bit for bit, every
   worker's first params = the master it was served, 53 + 53 BN-train
   launches a step, no codec launch, and 53 BN-inference a scored batch;
   step 10 of w0 and the joiner's step 2 replayed on the CPU
   in bf16 from the weights the worker adopted, held to bf16 limits beside
   a control (another step's gradient); step ms split into grad,
   push-and-adopt and H2D, the server's update ms in the job and alone,
   staleness, MB a push;
14. failover: phase 11's job again under an HA pair of port
   ``scheduler_main`` processes (a journaled primary with a lease that
   replicates completed rounds to a ``--standby`` tailing the journal; the
   workers fail over through ``DT_CTRL_ENDPOINTS``), the primary SIGKILLed
   once worker 0 reported the third step of the 3-worker epoch: every
   live worker's sha256 at every epoch end equal to phase 11's, one
   ``leader.elected`` under the next incarnation, phase 11's audit rows and
   launch counts; the ``scheduler.failover`` span, the stall on worker 0's
   clock, ``client.failover`` counts, and the lease chosen from the
   renewal delay a probe thread measured under phase 11's load;
15. outage: the dense job (ResNet-50 v1 bf16, 2 x 32 images, 2 epochs of
   8 steps, a fleet checkpoint every 4 steps, a journaled port scheduler
   process) never killed, then killed whole after the step-12 commit, then
   resumed (``--resume``, ``DT_RESUME=1``): ``resumed_from_step`` 12 on
   every worker, the final sha256 equal to the never-killed run's, each
   blob's digest equal to the journal's, 53 + 53 BN-train launches a
   resumed step and no codec; the save's cost on the step, ``ckpt.save``
   spans, blob bytes and the resume time;
16. sparse: ``examples/train_sparse_embedding.py``'s defaults (vocab
   50,000, dim 64, batch 256, window 8, adagrad lr 0.1), 2 workers and 2
   range servers, 50 steps of ``allreduce_sparse`` on the card with
   ``ops.sparse`` and ``optim.sparse``, the sparse table within 1e-3 of
   the dense path's (the example's ``--dense`` check);
17. policy: the port's launcher (``python -m dt_tpu_torch.launcher.launch
   -n 2 --standby --elastic-training-enabled True``, host file ``w0``,
   ``w2``) runs phase 11's job (4 epochs of 4 steps, 32 images scored a
   worker-epoch) under ``DT_POLICY=1``, every round of a step in flight
   at once; ``w1``, added to the host file during epoch 0, is started by
   the launcher at the epoch-1 barrier and sleeps 0.8 s before each
   step's allreduce (scaled by its batch): its share halves at the
   epoch-2 barrier and it is evicted at the epoch-3 one.  The decision
   log rebuilt from the journal, the batches (32/32, 22/21/21, 26/25/13,
   32/32), the gradient weights (summing to W), the live sha256 at every
   epoch end, the launch counts, the dynamic mini-batch gain of epoch 2
   over epoch 1 and epoch 3's recovery to epoch 0's rate, each gated;
   the straggler boards at the barriers and where the wall time goes
   printed;
18. obs: phase 11's job (2 workers, 2 epochs of 8 steps) with the trace,
   metrics, blackbox and device planes armed: the epoch-0 sha256 equal to
   phase 11's, both worker tracks in ``obs_dump`` (16 steps each, their
   pipeline spans, every name in the catalog), the exported trace's
   critical path naming a worker, each worker's ``device.hbm_bytes`` in
   the scheduler's ``/metrics`` (non-zero, within the card), no SLO
   breach, and a 2-step ``profile_capture`` on ``w1`` holding exactly
   2 x 53 ``bn_stats`` and 2 ``quantize_2bit`` kernels; then the health
   halt (a ``nan`` on ``w1``'s 4th gradient: both workers halted at step
   3 with one sha256 and a valid bundle each) and the hang (a ``stall`` at
   ``w1``'s third step: its watchdog's bundle names ``stall_at`` within
   ``DT_HANG_S`` + 10 s and ``blackbox_index`` blames ``w1``);
19. gateway (after obs): the serving plane in this process, the port's
   ``Scheduler`` and two ``Replica``s, each a ``Predictor`` of ResNet-50 v1
   at full width in bf16 (a checkpoint of the seeded weights, buckets
   1-64, all warmed) on the one card, and 8 closed-loop ``InferClient``
   threads sending requests of 1-4 seeded images: (a) 400 requests, every
   answer a result, requests coalesced, nothing shed, client p50/p99,
   requests/s, rows/s and batches by bucket; (b) ``RollingRefresher.
   poll_once`` of a committed fleet-checkpoint manifest (the seed-1 state)
   under that load, both replicas applied and every later answer at the
   new step; (c) one replica closed under load, every request still
   answered and the replica pruned by the scheduler; 53
   ``fused_bn_inference`` launches a bucket forward, and every answer
   within bf16 tolerance of a direct ``predict`` at its step; at most 45 s;
20. mesh (after the gateway): the elastic mesh, ``Module.fit`` in the mesh
   sync mode over ``torch.distributed`` with a ``MeshManager`` a worker
   (``tests/torch_mesh_worker.py``): ResNet-50 v1 bf16 at full width,
   ZeRO-1 + FSDP, cuDNN deterministic, global batch 64, 3 epochs of 4
   steps, 2 -> 3 -> 2 ranks against the port's scheduler (the joiner
   bootstraps from the snapshot, a non-coordinator departs), gloo on CUDA
   tensors (the ranks share the card; NCCL refuses that): one sha256 of
   the whole state over the live ranks at every epoch end, the survivors'
   ``mesh_rebuilds`` 2, the joiner's first state rank 0's epoch-0 one,
   53 ``bn_sums`` (pass 1 whose sums cross the ranks), no ``bn_stats`` and
   53 ``bn_act`` a rank-step, 53 ``bn_act`` a rank's score of its part of
   64 images, ``sharding_report`` the plain rule's at 2 and 3 ranks, 106
   BN collectives a step; step ms per membership, the collectives' ms,
   barrier-to-step ms after a rebuild, bytes held; then (b) one step of
   the survivors' 2-rank mesh (bf16 plain and ZeRO-1 + FSDP, f32 plain)
   against one process on the 64 rows;
21. parallel (after the mesh): the parallel layer on the TransformerLM of
   phase 7 at full width (vocab 8192, 512 wide, 6 layers, 8 heads, S 2048,
   batch 8) from seeded weights carried in through ``load_jax_variables``,
   SGD lr 0.1 momentum 0.9: (a) ring, then Ulysses attention over 2 ranks
   of ``tests/torch_parallel_worker.py`` on the card (a ``model`` axis of
   2, gloo; the K/V hops and all-to-alls staged through pinned host
   memory): f32 logits within 1e-4 (of the largest) of one process's full
   attention, 3 bf16 ``Module.fit`` steps of one batch with the loss
   finite, falling and equal on both ranks, 3 more steps timed (median
   ms) with the bytes each rank sent a step; (b) the MoE LM (4 experts,
   flash attention, bf16) through ``Module.fit`` in this process, 3 steps:
   loss falling, the aux term > 0, the router moved, 6 flash launches a
   forward; then an f32 MoE layer of that width with its experts over the
   2 ranks within 1e-5 of the one-process layer; (c) the TransformerLM
   (flash, bf16) and ResNet-50 (bf16, batch 32) one step each without and
   with ``remat=True`` (cuDNN deterministic): gradients bit-equal (else
   within the bf16 gradient limit), ``max_memory_allocated`` of each, the
   running stats moved once, and the launches (flash 6 -> 12, BN-train 53
   -> 105: the recompute launches again); (d) the
   ``PipelinedTransformerLM`` (2 stages, 4 microbatches) over the 2 ranks:
   f32 logits within 1e-4 of the one-process sequential path and 3 bf16
   fit steps with the loss falling.  Each part's time and the phase's;
22. optim (after the parallel layer): the port's optimizers on the card.
   (a) ResNet-50 v1 bf16 through ``Module.fit`` as
   ``examples/common.py:115-126`` builds it (sgd momentum 0.9, wd 1e-4, a
   ``MultiFactorScheduler`` dropping after update 3, ``multi_precision``),
   batch 32, one epoch of 6 steps on one seeded batch: loss finite and
   falling, 53 ``bn_stats`` and 53 ``bn_act`` a step, one more update
   leaving every f32 param at ``w + (master - w)``; the median step ms
   beside the same fit without ``multi_precision``; (b) the TransformerLM
   of phase 7 at full width under adam (lr 3e-4, as
   ``examples/train_transformer_lm.py``), 5 steps, then 5 with
   ``multi_precision`` (the bf16 ``pos_embed`` gets an f32 master): loss
   falling, 6 flash launches a forward, the median step ms and the
   state's bytes; (c) one update of every registered name (and rmsprop
   centered) over ResNet-50's 161 parameters from seeded gradients, card
   against the same code on the CPU (1e-6 of each leaf's largest, 1e-5
   for lbsgd's and lamb's norms; sgld's key equal and its noise within 4
   sigma of N(0, lr)), and each update's ms (CUDA events, median of 5);
   (d) ZeRO-1 with adam over 2 gloo ranks of the card
   (``tests/torch_mesh_worker.py``), ResNet-50 f32 at global batch 64, one
   step: one sha256 over the ranks, ZeRO-1 equal to plain data
   parallelism bit for bit, the moments against one process's step within
   phase 20's f32 limits, the bytes held with and without ZeRO-1; (e)
   (b)'s adam + ``multi_precision`` state saved asynchronously through the
   pinned buffers, loaded into a fresh model's state bit-equal, and one
   more step of each bit-equal.  Each part's time and the phase's;
23. data (after the optimizers): the data pipeline and the recurrent
   cells, nothing of it needing PIL or ``ml_dtypes``.  (a) ResNet-50 v1
   bf16 ``Module.fit`` fed from a ``.rec`` as ``examples/common.py:74-126``
   builds it: 320 seeded raw u8 records of 256x256x3 (~63 MB, written with
   ``RecordIOWriter`` and ``pack_label``), ``ResizeIter(PrefetchingIter(
   ImageRecordIter(shuffle=True, augmenter=FusedCropMirrorNormalize(224,
   ImageNet mean/std), dtype="bfloat16")), 8)`` at batch 32, sgd momentum
   0.9 wd 1e-4 with ``multi_precision``, one epoch: loss finite and
   falling, 53 ``bn_stats`` and 53 ``bn_act`` a step, the first two
   batches of the pooled iterator equal to a serial one's byte for byte,
   ``num_parts=2`` shards disjoint and together every record; the
   iterator's images/s alone at 1 thread and at the pool's, the median
   step beside phase 10's and the idle share of a profiled 2-step epoch;
   (b) ``resnet20_cifar`` with ``stochastic_depth=0.5`` in f32 (the
   example's lr 0.05, momentum 0.9) from a ``.rec`` of 32x32x3 shapes
   through ``cifar_train_augmenter``, batch 64, 2 epochs: loss finite, 19
   + 19 BN-train launches a step, train forwards under other generators
   differ, eval repeats equal, and with one generator's keeps the kernel-BN
   logits within ``TOL_SD_PLAIN`` of the plain-BN run on the card; (c)
   ``bidirectional_lstm`` at the PTB example's width (emsize 200, nhid
   200, 2 layers, bptt 35, batch 32) forward and backward in f32 and bf16
   (each 4 ``lstm_layer`` and 4 ``lstm_layer_bwd`` launches) against
   ``fused=False`` on the card within ``TOL_BILSTM``, ms beside cuDNN's
   bidirectional ``torch.nn.LSTM`` (never called by the port); ``gru`` at
   that width, f32 card against the CPU; ``train_ner.py``'s BiLSTM tagger
   (E 32, H 32, adam lr 3e-3) 20 steps with the loss falling; (d)
   ``MNISTIter`` over seeded gzip idx files and an ``ArrayDataset``
   through a ``DataLoader`` of 2 workers forked after the card's launches,
   each feeding a LeNet ``Module.fit`` of one epoch: losses finite, every
   worker exited, all within ``LOADER_TIMEOUT_S``.  Each part's time and
   the phase's;
24. zoo (after the data phase): one model a family of the classification
   zoo at full width, 1000 classes, from the port's own ``init_params``:
   ``alexnet``, ``vgg16_bn``, ``squeezenet``, ``googlenet``,
   ``inception_bn``, ``inception_v3`` (299), ``inception_v4`` (299),
   ``inception_resnet_v2`` (299), ``resnext50``, ``mobilenet``,
   ``mobilenet_v2``, ``densenet121`` (224 but where named).  For each: (a)
   an f32 copy of the weights, its eval forward at batch 2 with the BN
   kernels and again on their plain versions, and every BN kernel held
   against its plain version on each BN input of the fit's own bf16 model
   in a training forward at batch 32 and an eval forward at batch 1, within
   ``TOL_ZOO``; (b) a bf16 ``Module.fit`` as ``examples/common.py:74-126``
   builds it (sgd, momentum 0.9, wd 1e-4, ``multi_precision``) of
   ``ZOO_STEPS`` steps of 32 synthetic images: losses finite, one
   ``bn_stats`` and one ``bn_act`` a BN a step (none for the models without
   BN), the median synced step of the last 2, images/s, peak HBM and the
   idle share of one profiled step; (c) the ``Predictor`` in bf16, built by
   name from a serving checkpoint of the fit (its weights and BN stats, no
   optimizer slots), at buckets 1 and 32: one ``bn_act`` a
   BN a request, bucket 32 against ``Module.predict``, ms a request and
   images/s.  The phase's time;
25. detection (after the zoo): the detectors at the sizes users train
   them, from the port's own ``init_params``: SSD at 300x300, batch 32, 20
   classes, and FasterRCNNMini's defaults at 512x512, batch 8 (3 classes,
   32 ROIs), on seeded batches of ``examples/train_ssd.py``'s and
   ``train_rcnn.py``'s generators.  For each: (a) every BN kernel held
   against its plain version on each BN input of a bf16 training forward
   at the card batch and an eval forward at batch 1 (``TOL_ZOO``); (b)
   adam (lr 1e-3, the examples' rule) in bf16 and in f32 on one batch,
   ``DETECT_STEPS`` steps with the last loss below 0.8 of the first (the
   JAX package's test gates), one ``bn_stats`` and one ``bn_act`` a BN a
   step (FasterRCNNMini's proposal stage one ``nms_keep``), the median of
   3 synced steps, images/s, peak HBM and one profiled step; (c) the
   trained model's eval forward on a fresh batch and on the batch it fit,
   and its detection stage (``ssd_detect``, ``rcnn_detect``) at its
   default score threshold, FasterRCNNMini's also at 0 on the fresh batch
   (every ROI scanned; something kept), held against the plain CPU version
   run on the card's class probabilities and other outputs (labels equal
   but named flips whose deciding IoU lies within ``TOL_DETECT["iou"]`` of
   the threshold; scores and boxes within ``TOL_DETECT["scores"]``), its
   ms and the forward's; every ``nms_keep`` call of (b)'s and (c)'s runs
   (the proposal stage's, unlabelled, and the detection stages') held
   against its plain version on the same sorted inputs (equal masks); on
   SSD's bf16 call the scan kernel's device time, the plain version's and
   its bound; SSD served by name through ``Predictor`` from a checkpoint
   of the bf16 state at buckets 1 and 32, bucket 32 within ``TOL_BF16`` of
   the model's eval forward; (d) SSD fed 3 bf16 steps from 96 raw u8
   detection records through ``ImageDetRecordIter`` with
   ``ssd_train_augmenter`` and, last in the chain, a ``native`` resize to
   300x300 (the phase fails if it imported PIL), the iterator's images/s
   alone.  The phase's time.
26. quantization and ONNX (after the detectors): (b)
   ``examples/quantize_model.py``'s flow in the port at its defaults (the
   4-way task of 64 features, 4096 rows and 1024 held out, the 64-128-128-4
   MLP, the port's adam at 1e-3 for 30 epochs of 256, 8 calibration
   batches): int8 top-1 within 0.02 of fp32 (the example's gate) with
   ``naive`` and ``entropy`` calibration, 3 ``qconv`` launches an int8
   forward (the int8 kernel's main path), each forward bit-equal to the
   same forward on the kernel's plain version; (a) the int8 kernel
   (``csrc/qconv.cu``) at every distinct convolution of ResNet-50 v1
   (224x224, batch 32) and its dense head, on int8 codes of a seeded float
   forward (``MinMaxCollector`` ranges, ``quantize_params`` weights), and
   at the example's three dense calls: bit-equal to ``qconv_plain`` in
   float32 and bfloat16 output, two launches bit-identical, the packed
   weight equal to ``qconv_pack_plain``, timed beside the bound, the plain
   version and ``torch._int_mm`` (a yardstick the port never calls) over
   the same GEMM, summed over one forward, each shape's route and tile
   printed, and the earlier ``mma.sync`` kernel's time printed beside it
   (``QCONV_MMA_SYNC_MS``, from an earlier run of
   ``tests/torch_qconv_ab.py``; on the print lines only); the weights
   quantized outside inference mode, so their packed copies are cached,
   and the example's three calls timed again on inference-mode weights,
   which are packed anew on every call; (c)
   ResNet-50 v1 exported by ``onnx.export_onnx`` from phase 4's seeded
   weights at batch 32 (bytes, seconds, nodes, initializers) and served by
   ``Predictor.from_onnx`` at bucket 32 (requests of 1, 32 and 130 rows)
   against the native ``Predictor`` on the same weights, f32 logits within
   1e-4 of its largest; ms a request and images/s of both, in turns.

The line before the last holds the card's name and power limit, the one
before it a JSON summary of the kernels, every number in it measured in
this run except the bounds, which it computes (the kernels redesigned
for Hopper carry ``redesigned_in``); the last line is
``{"ok": true, "device": {...}}``.  TF32 is off for every phase, timings
included.  The kernels line carries, beside each kernel's own launches,
its launches on ``fit`` and on the elastic, sharded, async, failover
(``ha_launches``), resumed (``resume_launches``), policy
(``policy_launches``, the three kernels of its path) and obs
(``obs_launches``, phase 18's armed job, the same three) jobs, each read from
the counters of that job's workers (the f32 BatchNorm rows carry none:
the jobs run bf16, and one counter serves both dtypes); the bf16
BN-inference row also carries ``gateway_launches``, phase 19's, and the
bf16 BN rows ``mesh_launches``, phase 20's (pass 1 there is ``bn_sums``,
whose own times sit in the BN-train rows' ``bn_sums``); the flash rows
and the bf16 BN rows carry ``parallel_launches``, phase 21's, and
``optim_launches``, phase 22's; the f32 BN-train row carries phase 22
(d)'s f32 ranks' ``bn_sums``/``bn_act`` as its ``optim_launches``; the BN
rows carry ``data_launches``, phase 23's ((a) in bf16, (b) in f32), and the
LSTM rows phase 23 (c)'s by part; the bf16 BN rows carry ``zoo_launches``,
phase 24's by model (the fits' pass 1 + pass 2, the requests' BN
inference), and every BN row ``detection_launches``, phase 25's by model
(training and SSD's record-fed steps: pass 1 + pass 2; the eval forwards
and SSD's requests: BN inference).  ``nms_keep`` (phase 25's scan kernel)
counts its launches over the phase's main-path runs, by model, dtype and
part.  ``quantized_conv2d`` (phase 26's int8 kernel) counts the launches of
(b)'s int8 forwards (6, all on the tma route, ``route_launches``); its
times are those of the example's three calls, and
``resnet50_int8_forward`` carries (a)'s sums, ``resnet50_shapes`` each
shape's and ``inference_weight_ms`` the three calls on inference-mode
weights; ``qconv_pack`` counts (b)'s weight packs (3, once a weight),
times the three and, as its library call, the one PyTorch copy that
gives the same bytes for these weights; the f32
BN-inference row carries the native Predictor's launches a request in
(c).
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3 rate of the H100 SXM data sheet
L2_BYTES = 2 * 50 * 2 ** 20  # twice the H100's 50 MB L2
BN_PER_FORWARD = 53  # ResNet-50 v1: stem + 16 bottlenecks x 3 + 4 shortcuts
# the LM kernels' counters, which every ResNet-50 job leaves at 0
LM_KERNELS = ("flash_attention", "lstm_pointwise", "lstm_layer",
              "lstm_layer_bwd")
BUCKET_MAX = 64
REQUESTS = (1, 3, 32, 130)  # 130 splits into 64 + 64 + 2
TOL_F32 = 1e-3  # card f32 (no TF32) against the CPU: summation order
TOL_BF16 = 1.5e-2  # of the largest |logit|: bf16 keeps 8 mantissa bits
# BN-train pass 1 against its plain version: f32 sums in another order, so
# mean and var may differ by a few ulps of E[x^2] (1e-5 of the largest)
TOL_STATS = 1e-5
BATCH = 32
IMAGE = 224  # ImageNet resolution of ResNet-50 v1
TRAIN_STEPS = 10  # steps on one batch in each mode: the loss must fall
TIME_STEPS = 5  # steps timed queued, and again synced
SGD = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
# The 2-bit leg's threshold ({'type': '2bit', 'threshold': ...}).  At the
# codec's default of 0.5 a step of this batch sends no element at all (the
# largest |g| is ~0.33, so the loss cannot fall in ten steps); at 0.005 it
# sends ~4 % of them (printed for 0.5 ... 0.0005 after the compressed run).
THRESHOLD_2BIT = 0.005
# one f32 step at batch 2, card against the port on the CPU, from the same
# state: the loss and new BN stats (forward only) tight; the gradient, the
# momentum and the params to 5e-2 of their norm, since a ReLU mask flips
# where the two devices' rounding puts a pre-activation on the other side
# of 0, and that moves every gradient below it (tests/test_torch_train.py)
TOL_STEP = dict(loss=1e-4, stats=1e-4, dense=1e-3, flat_g=5e-2, mom=5e-2,
                params=5e-2)
BF16_TFLOPS = 989.0  # H100 SXM dense bf16 peak, NVIDIA's data sheet
FP32_TFLOPS = 67.0  # H100 SXM f32 peak outside the tensor cores, same sheet
TF32_TFLOPS = 495.0  # H100 SXM dense TF32 tensor-core peak, same sheet
# TransformerLM of bench.py:579-581 and its batch (bench.py:572-574)
LM = dict(vocab_size=8192, embed_dim=512, num_layers=6, num_heads=8,
          max_len=2048)
LM_BATCH, LM_SEQ = 8, 2048
LM_SGD = dict(learning_rate=0.1, momentum=0.9)
# the PTB LSTM LM's defaults (examples/train_lstm_ptb.py:30-40)
PTB = dict(vocab_size=10000, embed_dim=200, hidden=200, num_layers=2,
           dropout=0.2)
PTB_BPTT, PTB_BATCH, PTB_LR, PTB_CLIP = 35, 32, 1.0, 0.25
# kernel against its plain version on the card: f32 sums in another order
# (flash out 2e-5 absolute in f32; in bf16 one ulp of each output row,
# 2**-7 of that row's largest |out|, where the f32 result rounds the other
# way; lse 1e-5 absolute, ~10 ulps at log(2048)); the LSTM cell's
# expf/tanhf against PyTorch's, a few ulps of values in [-1, 1] (1e-6)
TOL_FLASH = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
TOL_LSE = 1e-5
TOL_LSTM = 1e-6
# the LSTM layer kernel against its plain step loop: the recurrent product's
# f32 sums in another order, carried through 35 steps
TOL_LSTM_LAYER = 1e-5
# the PTB LM's forward in bf16 against f32, of the largest |logit|: h and c
# are rounded to bf16 at every one of the 35 steps
TOL_LSTM_BF16 = 5e-2
# one f32 LM step, card against the port on the CPU (no ReLU masks: the
# loss and gradient agree to f32 summation order)
TOL_LM_STEP = dict(loss=1e-5, flat_g=1e-4, mom=1e-4, params=1e-4)
# Module.fit: epochs of the bf16 ResNet-50 run (2 steps each), and the
# per-epoch train loss of the small f32 fit, card against CPU (relative)
FIT_EPOCHS = 4
FIT_ROUNDS = 3  # alternating rounds of bare steps and fit epochs, timed
TOL_FIT = 1e-4
# Module.fit's SGD: bench.py's momentum and weight decay, with lr 0.1 taken
# as the rate for a batch of 256 and scaled linearly to the batch of 32
# (Goyal et al.).  bench.py's own lr 0.1 at batch 32 is a timing setting:
# from linen's default init (BN scale 1) it sends ResNet-50's logits to
# ~1e15 within the 8 steps, so the loss check would pass or fail by chance.
FIT_SGD = dict(learning_rate=0.1 * BATCH / 256, momentum=0.9,
               weight_decay=1e-4)
# The elastic phase: ResNet-50 v1 workers of tests/torch_elastic_worker.py
# against the port's Scheduler, global batch 64 (2 x 32, 3 x 21), SGD lr
# 0.025 (0.1 scaled to 64 of 256), momentum 0.9, wd 1e-4, 2-bit at 0.005,
# the overlapped step, 3 epochs of ELASTIC_STEPS steps cycling over 128
# seeded images (each epoch's steps after its first are its timed window),
# and 64 seeded images scored after every epoch (batch 32).
ELASTIC_STEPS = 8
ELASTIC_ARGS = ["--model", "resnet50", "--dtype", "bfloat16",
                "--global-batch", "64", "--images", "128", "--lr", "0.025",
                "--wd", "1e-4", "--compress", "0.005", "--num-epoch", "3",
                "--epoch-steps", str(ELASTIC_STEPS), "--val-images", "64",
                "--deterministic"]
ELASTIC_VAL_FORWARDS = 2  # 64 images in batches of 32
RESNET50_PARAMS = 25_557_032
PACKED_BYTES = 4 * -(-RESNET50_PARAMS // 16)  # 6,389,260 a step a worker
ELASTIC_TIMEOUT = 420  # s, the whole job
# the sharded phase: the elastic job with its data plane on two range
# server processes
SHARDED_SERVERS = 2
# the async phase: ResNet-50 v1 bf16 through Module.fit over dist_async, 32
# images a worker, 2 epochs of ELASTIC_STEPS steps, w2 joining at epoch 1;
# the scheduler's sgd at lr 0.025 (0.1 scaled to 64 of 256), momentum 0.9,
# wd 1e-4; its first ASYNC_KEEP pushes replayed on the CPU
ASYNC_SGD = {"name": "sgd", "learning_rate": 0.025, "momentum": 0.9,
             "weight_decay": 1e-4}
ASYNC_ARGS = ["--model", "resnet50", "--dtype", "bfloat16", "--kvstore",
              "dist_async", "--fixed-batch", "--global-batch", "32",
              "--images", "128", "--lr", "0.025", "--wd", "1e-4",
              "--num-epoch", "2", "--epoch-steps", str(ELASTIC_STEPS),
              "--val-images", "64"]
ASYNC_KEEP = 8
# the 0-based steps async workers record, replayed on the CPU in bf16:
# step 10 of w0, step 2 of the joiner (it has no step 10). Each is a step
# whose bf16 gradient the CPU settles within TOL_ASYNC_BF16; the base
# workers' step 2, which bf16 leaves undetermined, and w1, whose steps run
# the same function from other masters, are not recorded, to keep the
# whole run short
ASYNC_RECORD = {"w0": (9,), "w2": (1,)}
# one bf16 ResNet-50 step, card against the port on the CPU from the same
# adopted weights and batch, relative to the largest |value|, whether or
# not a ReLU mask flipped (first readings, NVIDIA H100 80GB HBM3, 700.00 W:
# loss <= 8.3e-4, stats <= 7.0e-3, grad 0.016-0.023 where bf16 is within
# 0.08 of f32; a gradient from another step misses by >= 0.96, its loss
# by >= 2.2e-2; see _async_replay for the steps bf16 leaves undetermined)
TOL_ASYNC_BF16 = {"loss": 5e-3, "stats": 2e-2, "grad": 0.1}
# the sparse phase: examples/train_sparse_embedding.py's defaults, 50 steps
SPARSE = {"vocab": 50_000, "dim": 64, "batch": 256, "window": 8,
          "steps": 50, "lr": 0.1}
# the small jobs: f32 resnet20 at CIFAR's 32x32x3, 2 workers, 2 epochs of
# 2 steps over 128 seeded images (tests/torch_elastic_drift.py); the same
# jobs at a toy 8x8x3 ran beside them until the whole run neared its time
# limit (their 6 more processes shared the host's 8 cores)
SMALL_SIZES = (32,)
TOL_ELASTIC_LOSS = 1e-4  # card against CPU, relative
# the failover phase: the elastic job under an HA pair of port scheduler
# processes, the primary SIGKILLed once worker 0 reported the third step
# of the 3-worker epoch; the lease is the default unless the renewal
# delay measured under phase 11's load asks for more (3x its worst case)
FAILOVER_KILL_STEP = ELASTIC_STEPS + 3
LEASE_MIN_S = 2.0  # DT_CTRL_LEASE_S's default
# the policy phase: the port's launcher (-n 2 --standby, host file w0 w2)
# runs the elastic job's worker under DT_POLICY=1, 4 epochs of
# POLICY_STEPS steps (the gates take the least of the 7 after each epoch's
# first: with the mean of 3, the ratio of epoch 3's rate to epoch 0's
# ranged 0.635-1.437 over whole runs on one card), 32 seeded images scored
# after every epoch; w1 joins
# at the epoch-1 barrier and sleeps POLICY_DELAY_S before each step's
# allreduce (scaled by its batch over the equal split), breaches
# POLICY_THRESHOLD_MS at the epoch-2 barrier (its share halves) and again
# at the epoch-3 one (evicted after POLICY_EVICT_AFTER breaches).  Every
# round of a step is in flight at once (DT_AR_WINDOW 32 >= the 25 bucket
# rounds and the stats round; staging for 2 x 32 buckets of 4 MiB), so
# each round's lag is the step's and the board at a barrier is the last
# step's: with the default window (4) a step's lag reaches only its first
# window's rounds and the ~21 rounds after decay it by 0.7 each.  The
# threshold is >= 3x the worst score of a worker that does not straggle
# and <= the delay / 3 (on an H100 80GB HBM3 at 700 W: phase 11's board
# at most 7.2 ms, this job's at most 55.4 ms).
POLICY_STEPS = 8
# the most a step of epoch 3's window may take over epoch 0's least step:
# a stall after the eviction.  The host's other tenants stretched one step
# to at most 1.70 x over 11 runs of the phase on one card (H100 80GB HBM3,
# 700 W); w1 left in the fleet would hold every step to ~2.3-2.7 x, which
# the recovery gate sees
POLICY_STALL = 3.0
POLICY_ARGS = ["--model", "resnet50", "--dtype", "bfloat16",
               "--global-batch", "64", "--images", "128", "--lr", "0.025",
               "--wd", "1e-4", "--compress", "0.005", "--num-epoch", "4",
               "--epoch-steps", str(POLICY_STEPS), "--val-images", "32"]
POLICY_DELAY_S = 0.8
POLICY_THRESHOLD_MS = 250.0
POLICY_EVICT_AFTER = 2
POLICY_ENV = {"DT_POLICY": "1",
              "DT_POLICY_STRAGGLER_MS": str(POLICY_THRESHOLD_MS),
              "DT_POLICY_EVICT_AFTER": str(POLICY_EVICT_AFTER),
              "DT_AR_WINDOW": "32", "DT_AR_STAGING_MB": "256",
              "DT_OBS": "1", "DT_OBS_RING": "65536"}
POLICY_TIMEOUT = 240  # s, the whole launch
# the outage phase: dense ResNet-50 v1 bf16, 2 workers x 32 images, 2
# epochs of ELASTIC_STEPS steps, a fleet checkpoint every OUTAGE_EVERY
# steps; the whole job SIGKILLed after the step-OUTAGE_KILL_STEP commit
# (every worker held before its next step but one by a stall rule), then
# resumed on the same journal
OUTAGE_ARGS = ["--model", "resnet50", "--dtype", "bfloat16",
               "--global-batch", "64", "--images", "128", "--lr", "0.025",
               "--wd", "1e-4", "--num-epoch", "2", "--epoch-steps",
               str(ELASTIC_STEPS), "--deterministic"]
OUTAGE_EVERY = 4
OUTAGE_KILL_STEP = 12
OUTAGE_TIMEOUT = 300  # s, each of the three jobs

# Phase 20, the elastic mesh: ResNet-50 v1 bf16 workers of
# tests/torch_mesh_worker.py in the mesh sync mode (ZeRO-1 + FSDP, cuDNN's
# deterministic algorithms) against the port's Scheduler, global batch 64
# (2 x 32, 3 x 21), SGD lr 0.025 momentum 0.9 wd 1e-4, 3 epochs of
# MESH_STEPS steps cycling over 128 seeded images, 64 seeded images scored
# after every epoch (each rank its strided part); then one step of a fixed
# 2-rank mesh (plain and ZeRO-1 + FSDP) against one process on the 64 rows.
MESH_STEPS = 4
MESH_MODEL, MESH_DTYPE, MESH_DEVICE = "resnet50", "bfloat16", "cuda"


def mesh_args() -> list:
    return ["--model", MESH_MODEL, "--dtype", MESH_DTYPE, "--device",
            MESH_DEVICE, "--image-size", str(IMAGE), "--deterministic"]


MESH_ARGS = ["--global-batch", "64", "--images", "128", "--lr", "0.025",
             "--wd", "1e-4", "--num-epoch", "3", "--epoch-steps",
             str(MESH_STEPS), "--val-images", "64", "--zero", "--fsdp"]
MESH_TIMEOUT = 180  # s, the elastic mesh job
# Phase 21, the parallel layer: the TransformerLM of LM at full width over
# 2 ranks of tests/torch_parallel_worker.py on the card (gloo), PARALLEL_STEPS
# fit steps (then as many timed) of one batch each; the MoE LM (flash, 4
# experts) and the remat checks in this process
PARALLEL_STEPS = 3
PARALLEL_RANKS = 2
PARALLEL_EXPERTS = 4
PARALLEL_STAGES, PARALLEL_MICRO = 2, 4
PARALLEL_TIMEOUT = 240  # s, the 2-rank world
TOL_PARALLEL_F32 = 1e-4  # f32 logits against one process, of the largest
TOL_EP_F32 = 1e-5  # the expert-parallel layer against one process
MESH_BN_COLLECTIVES = 2 * BN_PER_FORWARD  # a step: forward and backward


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, inputs, iters: int = 20) -> float:
    """Device time of ``fn(inputs[i % len(inputs)])`` in ms: ``iters`` calls
    captured in one CUDA graph, replayed between two CUDA events, so the
    host's cost of a call (Python, checks, launch) is not in the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for i in range(3):
            fn(inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_us(fn, arg, iters: int = 200) -> float:
    """Host time of one call of ``fn(arg)`` in microseconds (what the
    caller's thread spends to enqueue it), synchronising only at the end."""
    import torch
    fn(arg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(arg)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def seeded_variables(model, seed: int):
    """Weights for ``model`` in the JAX layout, from numpy with ``seed``:
    He-normal convs, LeCun-normal dense, BN stats away from their initial
    values (mean ~ N(0, 0.1), var ~ U(0.5, 2))."""
    from dt_tpu_torch.interchange import export_jax_variables
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                gain = 2.0 if v.ndim == 4 else 1.0
                out[k] = (rng.normal(0, 1, v.shape)
                          * np.sqrt(gain / fan_in)).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            else:
                raise KeyError(f"unexpected leaf {k!r}")
        return out

    return fill(export_jax_variables(model))


def bn_shapes(model, x):
    """(N, C, H, W, relu) -> number of BatchNorm calls with that shape in
    one forward of ``model`` on ``x``."""
    import torch
    from dt_tpu_torch.models.common import FusedBatchNorm
    seen = {}

    def hook(mod, args):
        key = (*args[0].shape, mod.relu)
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, FusedBatchNorm)]
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return seen


def kernel_phase(shapes, dev, also=(), held=()):
    """Hold the kernel against its plain version at every shape, bit for
    bit, and time it; the shapes of ``also`` (``bn_shapes`` keys of another
    batch) too, both ways of ReLU; the shapes of ``held`` are held in
    bfloat16 with their own ReLU flag (a bf16 job's calls), not timed.
    Returns one summary per dtype, with times summed over the BatchNorm
    calls of one batch-32 forward."""
    import torch
    import torch.nn.functional as F
    from dt_tpu_torch.ops import kernels
    cases = {}
    for (n, c, h, w, _relu), count in shapes.items():
        for relu in (False, True):
            key = (n, c, h, w, relu)
            cases[key] = cases.get(key, 0) + (count if relu == _relu else 0)
    extra = [((37, 3), False), ((1001, 17), True), ((1001, 64), True),
             ((2, 3, 5, 7), True)]
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(0)
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0, "max_abs_err": 0.0}
        runs = [(k[:4], k[4], m) for k, m in cases.items()] + \
            [(k[:4], r, 0) for k in also for r in (False, True)] + \
            [(s, r, 0) for s, r in extra] + \
            [(k[:4], k[4], None) for k in held
             if dtype == torch.bfloat16]
        for shape, relu, per_fwd in runs:
            # a 2-D view one element into its storage is not 16-byte
            # aligned: it takes the kernel's scalar path
            for offset in [False, True] if len(shape) == 2 else [False]:
                numel = int(np.prod(shape))
                flat = torch.randn(numel + 1, generator=g, device=dev,
                                   dtype=torch.float32).to(dtype)
                if len(shape) == 4:
                    n, c, h, w = shape
                    x = flat[:numel].view(n, h, w, c).permute(0, 3, 1, 2)
                else:
                    c = shape[1]
                    x = flat[1:] if offset else flat[:numel]
                    x = x.view(shape)
                gamma = torch.rand(c, generator=g, device=dev) + 0.5
                beta, mean = (torch.randn(c, generator=g, device=dev)
                              for _ in range(2))
                var = torch.rand(c, generator=g, device=dev) * 1.5 + 0.5
                scale, bias = kernels.bn_scale_bias(gamma, beta, mean, var,
                                                    1e-5, dtype)
                x2 = kernels.rows_view(x)
                got = kernels.rows_view(kernels.bn_act(x, scale, bias, relu))
                want = kernels.bn_act_plain(x2, scale, bias, relu)
                err = (got.float() - want.float()).abs().max().item()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"bn_act {tuple(shape)} {dtype} relu={relu} "
                        f"misaligned={offset}: max abs err {err} != 0")
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
                if per_fwd is None:  # held, not timed
                    print(f"kernel bn_act {dtype} shape={tuple(shape)} "
                          f"relu={relu} held max_abs_err={err}", flush=True)
                    continue
                nbytes = (2 * x2.numel() + 2 * c) * x.element_size()
                bound = nbytes / H100_BYTES_PER_S * 1e3
                # time on copies that together exceed the 50 MB L2, so each
                # call reads its input from device memory, as the bound
                # does (the tiny extra shapes stay in L2 regardless)
                xs = [x] + [x.clone()
                            for _ in range(min(L2_BYTES // nbytes, 63))]
                def kernel(a):
                    return kernels.bn_act(a, scale, bias, relu)

                def plain(a):
                    return kernels.bn_act_plain(kernels.rows_view(a), scale,
                                                bias, relu)

                def library(a):
                    y = F.batch_norm(a, mean, var, gamma, beta,
                                     training=False, eps=1e-5)
                    return torch.relu_(y) if relu else y

                k_ms = cuda_ms(kernel, xs)
                k_host = host_us(kernel, x)
                p_ms = cuda_ms(plain, xs)
                lib_ms = cuda_ms(library, xs) if len(shape) == 4 else None
                del xs
                print(f"kernel bn_act {dtype} shape={tuple(shape)} "
                      f"relu={relu} misaligned={offset} max_abs_err={err} "
                      f"kernel_ms={k_ms:.5f} kernel_host_us={k_host:.1f} "
                      f"plain_ms={p_ms:.5f} "
                      f"library_ms={lib_ms and round(lib_ms, 5)} "
                      f"bound_ms={bound:.5f} "
                      f"per_forward={per_fwd}", flush=True)
                if per_fwd:
                    tot["ms"] += per_fwd * k_ms
                    tot["plain_ms"] += per_fwd * p_ms
                    tot["bound_ms"] += per_fwd * bound
                    tot["library_ms"] += per_fwd * lib_ms
        summary[dtype] = tot
    return summary


def serve(name, dtype, variables, dev, images, gpu):
    """Serve ResNet-50 through the Predictor: the port's main path.  Returns
    (launches of the kernel, chunk forwards, logits of ``images[:4]``)."""
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.predictor import Predictor

    model = load_jax_variables(models.create(name, device=dev, dtype=dtype),
                               variables)
    pred = Predictor.from_fn(lambda m, _stats, x: m(x), model, dtype=dtype,
                             max_batch=BUCKET_MAX, device=dev)
    pred.warmup(images.shape[1:])
    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
    chunks = 0
    first4 = None
    for n in REQUESTS:
        t0 = time.perf_counter()
        out = pred.predict(images[:n])
        ms = (time.perf_counter() - t0) * 1e3
        if out.shape != (n, 1000) or not np.isfinite(out).all():
            raise AssertionError(f"{dtype} request of {n}: bad output "
                                 f"{out.shape}")
        chunks += -(-n // BUCKET_MAX)
        if n >= 4 and first4 is None:
            first4 = out[:4]
        print(f"serve {dtype} request rows={n} ms={ms:.3f} gpu={gpu}",
              flush=True)
    counts = read_counts()  # ... and ends here
    launches = counts.pop("bn_act")
    if any(counts.values()):
        raise AssertionError(f"serving launched other kernels: {counts}")
    for b in pred.batch_buckets:
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.predict(images[:b])
        ms = (time.perf_counter() - t0) * 1e3 / reps
        print(f"serve {dtype} bucket={b} ms_per_request={ms:.3f} "
              f"img_per_s={b / ms * 1e3:.1f} gpu={gpu}", flush=True)
        if b in (1, BUCKET_MAX):
            profile_fn(lambda: pred.predict(images[:b]), ms,
                       f"{dtype} bucket={b}")
    return launches, chunks, first4


def profile_fn(fn, wall_ms: float, tag: str) -> dict:
    """Device time of one call of ``fn`` by kernel, from ``torch.profiler``,
    and the device's idle share against the call's unprofiled host time.
    Only device activity is recorded: the host's op events cost seconds a
    window for the deep zoo models' steps and no number here reads them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    busy = sum(r[2] for r in rows)
    if busy == 0:
        print(f"profile {tag}: device time not measured (the profiler saw "
              "no device events)", flush=True)
        return {}
    idle = max(0.0, 1 - busy / wall_ms)
    print(f"profile {tag} wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
          f"device_idle_share={idle:.3f}", flush=True)
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:10]:
        print(f"profile {tag} device_ms={ms:.3f} share={ms / busy:.3f} "
              f"calls={count} {key[:90]}", flush=True)
    return {"busy_ms": busy, "idle_share": idle}


def counted():
    """The launch counters of every kernel wrapper, by kernel."""
    from dt_tpu_torch.ops import attention, kernels
    return {"bn_act": kernels.bn_act, "bn_stats": kernels.bn_stats,
            "quantize_2bit": kernels.quantize_2bit,
            "dequantize_2bit": kernels.dequantize_2bit,
            "flash_attention": attention.flash_fwd,
            "lstm_pointwise": kernels.lstm_point,
            "lstm_layer": kernels.lstm_layer,
            "lstm_layer_bwd": kernels.lstm_layer_bwd,
            "nms_keep": kernels.nms_keep, "qconv": kernels.qconv,
            "qconv_pack": kernels.qconv_pack}


def reset_counts() -> None:
    from dt_tpu_torch.ops import kernels
    for wrapper in counted().values():
        wrapper.launches = 0
    kernels.qconv.routes = dict.fromkeys(kernels.QCONV_ROUTES, 0)


def read_counts() -> dict:
    return {k: w.launches for k, w in counted().items()}


#: profiler windows taken over one call before an empty trace fails (3
#: empty windows in a row, a second apart or less, happened in a whole
#: run on an H100 after 47 full ones)
PROFILE_WINDOWS = 5


def device_kernels(fn, wrapper, need=(), required=True) -> list:
    """``(name, device ms)`` of each CUDA kernel (and memset, copy) that one
    call of ``fn`` puts on the device, from a ``torch.profiler`` window over
    that call alone, synchronized before the window closes.  ``wrapper``
    is the kernel wrapper ``fn`` calls: its launch counter must advance by
    one in every window.  A window that recorded no device event at all
    (the profiler missed the call: it happened once in one of PR 9's
    runs), or none whose name holds one of ``need``, is taken again after
    a pause of as many seconds as windows taken, up to
    :data:`PROFILE_WINDOWS` windows; that many such windows fail where
    ``required``, else give ``[]`` (the caller reports its split as not
    measured).  The BN phases fail a window that recorded anything but
    exactly one kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for window in range(1, PROFILE_WINDOWS + 1):
        before = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if wrapper.launches != before + 1:
            raise AssertionError(f"profiler window {window}: the wrapper "
                                 f"counted {wrapper.launches - before} "
                                 "launches, not one")
        events = [(e.name, e.time_range.elapsed_us() / 1e3)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and all(any(w in name for name, _ in events)
                          for w in need):
            return events
        print(f"profiler window {window}: {len(events)} device events "
              f"recorded for one launch (needing {list(need)}); taking the "
              "window again", flush=True)
        time.sleep(window)
    if not required:
        return []
    raise AssertionError(f"{PROFILE_WINDOWS} profiler windows in a row "
                         f"recorded no device event (or none of "
                         f"{list(need)})")


def bn_train_phase(shapes, dev, also=(), held=()):
    """Hold the BN-train pass 1 against its plain version at every shape of
    a batch-32 forward, of ``also`` (``bn_shapes`` keys of another batch),
    and ragged and misaligned ones, check that two
    launches agree bit for bit and that y is the plain pass 2 on the
    kernel's stats, and time pass 1 + pass 2; the shapes of ``held`` are
    held the same ways in bfloat16 (a bf16 job's calls), not profiled or
    timed.  Returns one summary per dtype, times summed over the
    BatchNorm calls of one forward."""
    import torch
    import torch.nn.functional as F
    from dt_tpu_torch.ops import kernels
    extra = [((37, 3), False), ((1001, 17), True), ((1001, 64), True)]
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(3)
        tot = {"ms": 0.0, "pass1_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "pass1_bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0,
               "kernels_a_call": 0, "sums_ms": 0.0, "sums_plain_ms": 0.0,
               "sums_bound_ms": 0.0, "sums_max_abs_err": 0.0,
               "sums_kernels_a_call": 0}
        runs = [(k[:4], k[4], m) for k, m in shapes.items()] + \
            [(k[:4], k[4], 0) for k in also] + \
            [(sh, r, 0) for sh, r in extra] + \
            [(k[:4], k[4], None) for k in held if dtype == torch.bfloat16]
        for shape, relu, per_fwd in runs:
            for offset in [False, True] if shape == (1001, 64) else [False]:
                numel = int(np.prod(shape))
                flat = (torch.randn(numel + 1, generator=g, device=dev)
                        + 0.5).to(dtype)
                if len(shape) == 4:
                    n, c, h, w = shape
                    x = flat[:numel].view(n, h, w, c).permute(0, 3, 1, 2)
                else:
                    c = shape[1]
                    x = (flat[1:] if offset else flat[:numel]).view(shape)
                gamma = torch.rand(c, generator=g, device=dev) + 0.5
                beta = torch.randn(c, generator=g, device=dev)
                x2 = kernels.rows_view(x)
                mean, var = kernels.bn_stats(x)
                mean2, var2 = kernels.bn_stats(x)
                pm, pv = kernels.bn_stats_plain(x2)
                ex2 = float((x2.float() ** 2).mean(0).max())
                err = max(float((mean - pm).abs().max()),
                          float((var - pv).abs().max()))
                rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
                with torch.no_grad():
                    y, _, _ = kernels.fused_bn_train(x, gamma, beta, rm, rv,
                                                     relu=relu)
                scale, bias = kernels.bn_scale_bias(gamma, beta, mean, var,
                                                    1e-5, dtype)
                want = kernels.bn_act_plain(x2, scale, bias, relu)
                torch.cuda.synchronize()
                tag = (f"{dtype} shape={tuple(shape)} relu={relu} "
                       f"misaligned={offset}")
                if not (torch.equal(mean, mean2) and torch.equal(var, var2)):
                    raise AssertionError(f"bn_stats {tag}: two launches "
                                         "differ")
                if err > TOL_STATS * ex2:
                    raise AssertionError(f"bn_stats {tag}: max abs err "
                                         f"{err} > {TOL_STATS} * {ex2}")
                if not torch.equal(kernels.rows_view(y), want):
                    raise AssertionError(f"fused_bn_train {tag}: y differs "
                                         "from the plain pass 2")
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
                if per_fwd is None:  # held, not profiled or timed
                    print(f"kernel bn_train {tag} held stats_max_abs_err="
                          f"{err:.3e} ex2={ex2:.3f}", flush=True)
                    continue
                launched = [name for name, _ in device_kernels(
                    lambda: kernels.bn_stats(x), kernels.bn_stats)]
                print(f"kernel bn_train {tag} kernels_a_bn_stats_call="
                      f"{len(launched)} {launched}", flush=True)
                if len(launched) != 1:
                    raise AssertionError(f"bn_stats {tag}: one call put "
                                         f"{launched} on the device, not "
                                         "one kernel")
                tot["kernels_a_call"] = max(tot["kernels_a_call"],
                                            len(launched))
                # bn_sums, the mesh's pass 1: the same launch, unfinalized;
                # its error is taken over the rows, as pass 1's is
                s1, q1 = kernels.bn_sums(x)
                s2, q2 = kernels.bn_sums(x)
                ps, pq = kernels.bn_sums_plain(x2)
                torch.cuda.synchronize()
                rows = x2.shape[0]
                serr = max(float((s1 - ps).abs().max()),
                           float((q1 - pq).abs().max())) / rows
                if not (torch.equal(s1, s2) and torch.equal(q1, q2)) or \
                        serr > TOL_STATS * ex2:
                    raise AssertionError(f"bn_sums {tag}: launches agree "
                                         f"{torch.equal(s1, s2)}, max abs "
                                         f"err / rows {serr}")
                slaunched = [name for name, _ in device_kernels(
                    lambda: kernels.bn_sums(x), kernels.bn_sums)]
                if len(slaunched) != 1:
                    raise AssertionError(f"bn_sums {tag}: one call put "
                                         f"{slaunched} on the device")
                tot["sums_max_abs_err"] = max(tot["sums_max_abs_err"], serr)
                tot["sums_kernels_a_call"] = max(tot["sums_kernels_a_call"],
                                                 len(slaunched))
                nbytes = x2.numel() * x.element_size()
                b1 = (nbytes + 2 * c * 4) / H100_BYTES_PER_S * 1e3
                b2 = (2 * nbytes + 2 * c * x.element_size()) \
                    / H100_BYTES_PER_S * 1e3
                xs = [x] + [x.clone()
                            for _ in range(min(L2_BYTES // nbytes, 63))]

                def library(a):
                    out = F.batch_norm(a, rm, rv, gamma, beta, training=True,
                                       momentum=0.1, eps=1e-5)
                    return torch.relu_(out) if relu else out

                p1 = cuda_ms(kernels.bn_stats, xs)
                p2 = cuda_ms(lambda a: kernels.bn_act(a, scale, bias, relu),
                             xs)
                pl1 = cuda_ms(lambda a: kernels.bn_stats_plain(
                    kernels.rows_view(a)), xs)
                ps1 = cuda_ms(kernels.bn_sums, xs)
                psl = cuda_ms(lambda a: kernels.bn_sums_plain(
                    kernels.rows_view(a)), xs)
                pl2 = cuda_ms(lambda a: kernels.bn_act_plain(
                    kernels.rows_view(a), scale, bias, relu), xs)
                lib = cuda_ms(library, xs) if len(shape) == 4 else None
                del xs
                print(f"kernel bn_train {tag} stats_max_abs_err={err:.3e} "
                      f"ex2={ex2:.3f} pass1_ms={p1:.5f} "
                      f"pass1_bound_ms={b1:.5f} pass1_plain_ms={pl1:.5f} "
                      f"pass2_ms={p2:.5f} pass2_bound_ms={b2:.5f} "
                      f"fwd_ms={p1 + p2:.5f} fwd_plain_ms={pl1 + pl2:.5f} "
                      f"library_ms={lib and round(lib, 5)} "
                      f"bn_sums_ms={ps1:.5f} bn_sums_plain_ms={psl:.5f} "
                      f"bn_sums_err_over_rows={serr:.3e} "
                      f"per_forward={per_fwd}", flush=True)
                if per_fwd:
                    tot["ms"] += per_fwd * (p1 + p2)
                    tot["pass1_ms"] += per_fwd * p1
                    tot["plain_ms"] += per_fwd * (pl1 + pl2)
                    tot["bound_ms"] += per_fwd * (b1 + b2)
                    tot["pass1_bound_ms"] += per_fwd * b1
                    tot["library_ms"] += per_fwd * lib
                    tot["sums_ms"] += per_fwd * ps1
                    tot["sums_plain_ms"] += per_fwd * psl
                    tot["sums_bound_ms"] += per_fwd * b1
        print(f"kernel bn_train {dtype} per forward: " + " ".join(
            f"{k}={v:.5f}" for k, v in tot.items()), flush=True)
        summary[dtype] = tot
    return summary


def codec_phase(n_params: int, dev):
    """Hold the 2-bit quantize/dequantize kernels against their plain
    versions bit for bit at ``n_params`` (ResNet-50's gradient) and at small
    and ragged sizes with values at +-t, +-0, +-inf and NaN; time both at
    ``n_params``.  Returns ``{"quantize_2bit": {...}, "dequantize_2bit":
    {...}}``."""
    import torch
    from dt_tpu_torch.ops import kernels
    t = 0.5
    special = torch.tensor([t, -t, 0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), t], device=dev)
    special_r = torch.tensor([0.0, 0.0, 0.0, -0.0, 1.0, 1.0, 0.0, -1e-8],
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(4)

    def inputs(n):
        grad = torch.randn(n, generator=g, device=dev) * 0.6
        resid = torch.randn(n, generator=g, device=dev) * 0.2
        if n >= 16:
            grad[:8], resid[:8] = special, special_r
        return grad, resid

    for n in (0, 1, 15, 16, 17, 1000, n_params):
        grad, resid = inputs(n)
        words, res = kernels.quantize_2bit(grad, resid, t)
        pw, pr = kernels.quantize_2bit_plain(grad, resid, t)
        out = kernels.dequantize_2bit(words, n, t)
        pout = kernels.dequantize_2bit_plain(words, n, t)
        torch.cuda.synchronize()
        same = (torch.equal(words, pw)
                and torch.equal(res.view(torch.int32), pr.view(torch.int32))
                and torch.equal(out.view(torch.int32),
                                pout.view(torch.int32)))
        print(f"kernel quant2 n={n} words={words.numel()} bitwise={same}",
              flush=True)
        if not same:
            raise AssertionError(f"2-bit codec n={n}: kernel and plain "
                                 "version differ")
    n = n_params
    pairs = [inputs(n) for _ in range(2)]  # 2 x 204 MB: past the L2
    words = [kernels.quantize_2bit(*pr, t)[0] for pr in pairs]
    q_ms = cuda_ms(lambda a: kernels.quantize_2bit(*a, t), pairs, iters=10)
    qp_ms = cuda_ms(lambda a: kernels.quantize_2bit_plain(*a, t), pairs,
                    iters=4)
    d_ms = cuda_ms(lambda w: kernels.dequantize_2bit(w, n, t), words,
                   iters=10)
    dp_ms = cuda_ms(lambda w: kernels.dequantize_2bit_plain(w, n, t), words,
                    iters=4)
    nwords = -(-n // kernels.CODES_PER_WORD)
    out = {"quantize_2bit": {
        "ms": q_ms, "plain_ms": qp_ms, "max_abs_err": 0.0,
        "bound_ms": (12 * n + 4 * nwords) / H100_BYTES_PER_S * 1e3},
        "dequantize_2bit": {
        "ms": d_ms, "plain_ms": dp_ms, "max_abs_err": 0.0,
        "bound_ms": (4 * n + 4 * nwords) / H100_BYTES_PER_S * 1e3}}
    for name, r in out.items():
        print(f"kernel {name} n={n} kernel_ms={r['ms']:.5f} "
              f"plain_ms={r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f}",
              flush=True)
    return out


def _rel(a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def train_phase(variables, dev, gpu):
    """ResNet-50 training through ``train_step`` in three modes (the main
    path: counts are reset just before each mode's ten steps and read just
    after).  Returns ``{mode: {"launches": {...}, ...}}``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.parallel.compression import GradientCompression
    from dt_tpu_torch.ops import kernels
    from dt_tpu_torch.training.step import grad_step, train_step
    from dt_tpu_torch.training.train_state import TrainState
    rng = np.random.RandomState(2)
    images = rng.uniform(-1, 1, (BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    labels = torch.from_numpy(rng.randint(0, 1000, BATCH)).to(dev)
    results = {}
    for mode, dtype, compressed in (("bf16", torch.bfloat16, False),
                                    ("f32", torch.float32, False),
                                    ("bf16_2bit", torch.bfloat16, True)):
        model = load_jax_variables(models.create("resnet50", device=dev,
                                                 dtype=dtype), variables)
        state = TrainState.create(model, optim.create("sgd", **SGD))
        gc = GradientCompression(THRESHOLD_2BIT) if compressed else None
        x = torch.from_numpy(images).to(dev).permute(0, 3, 1, 2).to(dtype)

        def step():
            return train_step(state, x, labels, compression=gc)[1]

        step()  # warm up: cuDNN plans, the allocator's pool
        torch.cuda.synchronize()
        reset_counts()  # the main path's run starts here
        losses = [float(step()) for _ in range(TRAIN_STEPS)]
        counts = read_counts()  # ... and ends here
        want = {k: 0 for k in counts}
        want.update(bn_stats=BN_PER_FORWARD * TRAIN_STEPS,
                    bn_act=BN_PER_FORWARD * TRAIN_STEPS)
        if compressed:
            want.update(quantize_2bit=TRAIN_STEPS,
                        dequantize_2bit=TRAIN_STEPS)
        _falling(f"train {mode}", losses)
        _check_counts(f"train {mode}", counts, want)
        res = {"launches": counts, "losses": losses, **_timed_steps(step)}
        res["imgs_per_s"] = BATCH * 1e3 / res["step_ms"]
        if mode == "bf16":
            with FlopCounterMode(display=False) as fc:
                step()
            flops = fc.get_total_flops()
            res["model_tflops_per_s"] = flops / res["step_ms"] / 1e9
            res["share_of_bf16_peak"] = res["model_tflops_per_s"] \
                / BF16_TFLOPS
            res["step_gflop"] = flops / 1e9
        print(f"train {mode} " + " ".join(
            f"{k}={round(v, 4) if isinstance(v, float) else v}"
            for k, v in res.items() if k not in ("launches", "losses"))
            + f" gpu={gpu}", flush=True)
        res.update(profile_fn(step, res["step_ms"], f"train {mode} step"))
        if compressed:
            # the share of one step's gradient that a fresh codec sends
            # (code != 0) at each threshold, from the same gradient
            flat_g = grad_step(state, x, labels)[0]
            for t in (0.5, 0.05, 0.005, 0.0005):
                words = GradientCompression(t).compress_on_device(flat_g)
                sent = float((kernels.dequantize_2bit(
                    words, flat_g.numel(), t) != 0).float().mean())
                print(f"train {mode} threshold={t} sent_share={sent:.5f} "
                      f"grad_abs_max={float(flat_g.abs().max()):.4g}",
                      flush=True)
        results[mode] = res
        del model, state, x, gc
        torch.cuda.empty_cache()
    return results


def step_card_vs_cpu(variables, dev) -> None:
    """One f32 step of ResNet-50 at batch 2 on the card and on the CPU from
    the same state, compared within ``TOL_STEP``."""
    import torch
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.training.step import apply_step, grad_step
    from dt_tpu_torch.training.train_state import TrainState
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3))
                         .astype(np.float32)).permute(0, 3, 1, 2)
    y = torch.from_numpy(rng.randint(0, 1000, 2))
    got = {}
    for where in ("cuda", "cpu"):
        model = load_jax_variables(models.create("resnet50", device=where),
                                   variables)
        state = TrainState.create(model, optim.create("sgd", **SGD))
        t0 = time.perf_counter()
        flat_g, flat_s, loss, _ = grad_step(state, x.to(where), y.to(where))
        apply_step(state, flat_g, flat_s)
        lay = state.layout
        got[where] = {k: v.cpu() for k, v in {
            "loss": loss, "flat_g": flat_g, "stats": flat_s,
            "params": lay.params.ravel(state.params),
            "mom": lay.params.ravel(state.opt_state["mom"])}.items()}
        print(f"step card-vs-cpu {where} seconds="
              f"{time.perf_counter() - t0:.2f}", flush=True)
    dense = slice(*lay.params.span("Dense_0.weight"))
    card, cpu = got["cuda"], got["cpu"]
    card["dense"], cpu["dense"] = card["flat_g"][dense], cpu["flat_g"][dense]
    errs = {"loss": abs(float(card["loss"]) - float(cpu["loss"]))
            / abs(float(cpu["loss"]))}
    errs.update({k: _rel(card[k], cpu[k])
                 for k in ("stats", "dense", "flat_g", "mom", "params")})
    print("step card-vs-cpu f32 batch=2 " + " ".join(
        f"{k}_err={v:.3e} (tol {TOL_STEP[k]})" for k, v in errs.items()),
        flush=True)
    bad = {k: v for k, v in errs.items() if not v <= TOL_STEP[k]}
    if bad:
        raise AssertionError(f"f32 step, card against CPU: {bad}")


def flash_flops(bh: int, s: int, d: int, causal: bool = True) -> float:
    """Multiply-adds x 2 of one flash forward: q k^T and p v over the
    (query, key) pairs the mask leaves, S(S+1)/2 of them when causal."""
    pairs = s * (s + 1) / 2 if causal else s * s
    return 4.0 * bh * d * pairs


def flash_phase(dev):
    """Hold the flash kernel against its plain version in bf16 (the main
    path's type) and f32 at the TransformerLM's shape (causal), at D = 128
    with S = 1024 (causal) and at the LM's shape without the mask; two
    launches bit-identical; time kernel, plain version and SDPA.  Returns
    one summary per (shape name, dtype name)."""
    import torch
    import torch.nn.functional as F
    from dt_tpu_torch.ops import attention as TA
    h = LM["num_heads"]
    cases = {"lm": (LM_BATCH, LM_SEQ, h, LM["embed_dim"] // h, True),
             "d128": (LM_BATCH, 1024, 4, 128, True),
             "lm_full": (LM_BATCH, LM_SEQ, h, LM["embed_dim"] // h, False),
             # the small heads of the repo's own flash models (embed 64 or
             # 32 over 4 heads), at the LM's batch and length
             "d16": (LM_BATCH, LM_SEQ, 4, 16, True),
             "d8": (LM_BATCH, LM_SEQ, 4, 8, True)}
    out = {}
    for case, (b, s, h, d, causal) in cases.items():
        flops = flash_flops(b * h, s, d, causal)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            g = torch.Generator(device=dev).manual_seed(6)

            def qkv_views():
                qkv = torch.randn(b, s, 3 * h * d, generator=g, device=dev) \
                    .to(dtype)
                return tuple(t.reshape(b, s, h, d)
                             for t in qkv.split(h * d, dim=-1))

            def kernel(a):
                return TA.flash_fwd(*a, scale=d ** -0.5, causal=causal)

            q, k, v = qkv_views()
            o1, lse1 = kernel((q, k, v))
            o2, lse2 = kernel((q, k, v))
            p3, plse = TA.flash_attention_plain(
                TA._to3(q), TA._to3(k), TA._to3(v), scale=d ** -0.5,
                causal=causal)
            po = TA._from3(p3, b, h)
            torch.cuda.synchronize()
            same = torch.equal(o1, o2) and torch.equal(lse1, lse2)
            diff = (o1.float() - po.float()).abs()
            err = float(diff.max())
            lse_err = float((lse1 - plse).abs().max())
            # the tolerance of each output row (its D values)
            tol = TOL_FLASH[name] * (
                po.float().abs().amax(-1, keepdim=True)
                if dtype == torch.bfloat16 else torch.ones_like(diff[..., :1]))
            worst = float((diff / tol).max())  # 1 is the limit
            tag = f"{name} shape=({b},{s},{h},{d}) causal={causal}"
            print(f"kernel flash_attention {tag} max_abs_err={err:.3e} "
                  f"worst_row_err_over_tol={worst:.3f} "
                  f"lse_max_abs_err={lse_err:.3e} (tol {TOL_LSE}) "
                  f"bitwise_repeat={same}", flush=True)
            if not same or not worst <= 1.0 or lse_err > TOL_LSE:
                raise AssertionError(f"flash_attention {tag}: kernel "
                                     "against plain version failed")
            inputs = [(q, k, v), qkv_views()]
            heads = [tuple(t.transpose(1, 2).contiguous() for t in trio)
                     for trio in inputs]
            k_ms = cuda_ms(kernel, inputs)
            p_ms = cuda_ms(lambda a: TA.flash_attention_plain(
                TA._to3(a[0]), TA._to3(a[1]), TA._to3(a[2]),
                scale=d ** -0.5, causal=causal), inputs, iters=5)
            lib_ms = cuda_ms(lambda a: F.scaled_dot_product_attention(
                *a, is_causal=causal), heads)
            item = q.element_size()
            nbytes = 4 * b * s * h * d * item + b * h * s * 4
            peak = BF16_TFLOPS if dtype == torch.bfloat16 else FP32_TFLOPS
            bound = max(nbytes / H100_BYTES_PER_S,
                        flops / (peak * 1e12)) * 1e3
            out[case, name] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                "bound_ms": bound, "max_abs_err": err,
                "worst_row_err_over_tol": worst, "lse_max_abs_err": lse_err,
                "shape": [b, s, h, d],
                "causal": causal, "tflops_per_s": flops / k_ms / 1e9,
                "bound_share": bound / k_ms}
            if dtype == torch.float32:
                # the f32 kernel runs three TF32 products for each one
                out[case, name]["bound_3xtf32_ms"] = max(
                    nbytes / H100_BYTES_PER_S,
                    3 * flops / (TF32_TFLOPS * 1e12)) * 1e3
            print(f"kernel flash_attention {tag} kernel_ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={bound:.5f} "
                  f"bound_3xtf32_ms="
                  f"{out[case, name].get('bound_3xtf32_ms', float('nan')):.5f} "
                  f"gflop={flops / 1e9:.2f} "
                  f"kernel_tflops_per_s={flops / k_ms / 1e9:.2f} "
                  f"bound_share={bound / k_ms:.3f} "
                  f"library_tflops_per_s={flops / lib_ms / 1e9:.2f} "
                  f"kernel_over_library={k_ms / lib_ms:.3f} bytes={nbytes}",
                  flush=True)
            del inputs, heads, q, k, v, o1, o2, po, p3
    return out


def lstm_phase(dev):
    """Hold the LSTM pointwise kernel against its plain version at B=32,
    H=200 (the PTB default) and H=650, two launches bit-identical; time it
    beside its bound, the plain version and aten's fused LSTM cell.  Returns
    one summary per H."""
    import torch
    from dt_tpu_torch.ops import kernels
    out = {}
    for hidden in (200, 650):
        b = PTB_BATCH
        g = torch.Generator(device=dev).manual_seed(hidden)
        pairs = [(torch.randn(b, 4 * hidden, generator=g, device=dev) * 2,
                  torch.randn(b, hidden, generator=g, device=dev))
                 for _ in range(2)]
        gates, c = pairs[0]
        h1, c1 = kernels.lstm_point(gates, c)
        h2, c2 = kernels.lstm_point(gates, c)
        ph, pc = kernels.lstm_pointwise_plain(gates, c)
        torch.cuda.synchronize()
        same = torch.equal(h1, h2) and torch.equal(c1, c2)
        err = max(float((h1 - ph).abs().max()), float((c1 - pc).abs().max()))
        print(f"kernel lstm_pointwise B={b} H={hidden} max_abs_err={err:.3e} "
              f"(tol {TOL_LSTM}) bitwise_repeat={same}", flush=True)
        if not same or err > TOL_LSTM:
            raise AssertionError(f"lstm_pointwise H={hidden}: kernel against "
                                 "plain version failed")
        k_ms = cuda_ms(lambda a: kernels.lstm_point(*a), pairs, iters=100)
        p_ms = cuda_ms(lambda a: kernels.lstm_pointwise_plain(*a), pairs,
                       iters=100)
        lib_ms = cuda_ms(lambda a: torch.ops.aten._thnn_fused_lstm_cell(
            a[0], torch.zeros_like(a[0]), a[1]), pairs, iters=100)
        bound = 28 * b * hidden / H100_BYTES_PER_S * 1e3
        out[hidden] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                       "bound_ms": bound, "max_abs_err": err}
        print(f"kernel lstm_pointwise B={b} H={hidden} kernel_ms={k_ms:.5f} "
              f"plain_ms={p_ms:.5f} library_ms={lib_ms:.5f} "
              f"bound_ms={bound:.6f}", flush=True)
    return out


def layer_bound_ms(t: int, b: int, hidden: int) -> float:
    """Least time of one layer window from xw: 2 T B H 4H operations at the
    f32 peak against xw in, the gates out, h and c out, Wh, h0 and c0 once,
    in f32."""
    ops = 2.0 * t * b * hidden * 4 * hidden
    nbytes = 4.0 * (2 * t * b * 4 * hidden + 2 * t * b * hidden
                    + 4 * hidden * hidden + 2 * b * hidden)
    return max(nbytes / H100_BYTES_PER_S, ops / (FP32_TFLOPS * 1e12)) * 1e3


def lstm_layer_phase(dev):
    """Hold the LSTM layer kernel against its plain step loop at the PTB
    window (T 35, B 32) with H 200 and 650, forward and reverse, two
    launches bit-identical; time it alone, with its input product, beside
    the per-step path of the same window (the fused cell, pointwise kernel
    and all), the plain loop and cuDNN's one-layer LSTM (``torch._VF.lstm``,
    a yardstick the port never calls); and its serial floor, the same
    kernel at B 1, H 16.  Returns one summary per H."""
    import torch
    from dt_tpu_torch.ops import kernels
    t, b = PTB_BPTT, PTB_BATCH
    out = {}
    for hidden in (200, 650):
        g = torch.Generator(device=dev).manual_seed(hidden + 1)
        sets = []
        for _ in range(2):
            x, h0, c0, w = _draw_layer(g, dev, t, b, hidden, torch.float32)
            xw = (x.reshape(t * b, hidden) @ w.wx + w.b).reshape(t, b, -1)
            sets.append((x, h0, c0, w, xw))
        x, h0, c0, w, xw = sets[0]
        err, same = 0.0, True
        for reverse in (False, True):
            got = kernels.lstm_layer(xw, h0, c0, w.wh, reverse)
            again = kernels.lstm_layer(xw, h0, c0, w.wh, reverse)
            want = kernels.lstm_layer_plain(xw, h0, c0, w.wh, reverse)
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, a2)
                                for a, a2 in zip(got, again))
            err = max([err] + [float((a - p).abs().max())
                               for a, p in zip(got, want)])
        print(f"kernel lstm_layer T={t} B={b} H={hidden} "
              f"geometry={tuple(kernels.layer_geometry(b, hidden))} "
              f"max_abs_err={err:.3e} (tol {TOL_LSTM_LAYER}) "
              f"bitwise_repeat={same}", flush=True)
        if not same or not err <= TOL_LSTM_LAYER:
            raise AssertionError(f"lstm_layer H={hidden}: kernel against "
                                 "plain version failed")
        # cuDNN's layer on the same x and weights (the same function), its
        # weights in one flat buffer as torch.nn.LSTM keeps them
        flat = [_cudnn_layer(a, dev, torch.float32)._flat_weights
                for a in sets]

        def cudnn(a):
            return torch._VF.lstm(a[0], (a[1][None], a[2][None]), a[5],
                                  True, 1, 0.0, False, False, False)

        sets = [(*a, f) for a, f in zip(sets, flat)]
        y_lib = cudnn(sets[0])[0]
        lib_err = float((y_lib - kernels.lstm_layer(xw, h0, c0, w.wh)[0])
                        .abs().max())

        def per_step(a):  # today's path before this kernel: a cell a step
            hh, cc = a[1], a[2]
            for s_ in range(t):
                hh, cc = kernels.lstm_cell_fused(a[0][s_], hh, cc, a[3])
            return hh

        with torch.no_grad():
            k_ms = cuda_ms(lambda a: kernels.lstm_layer(a[4], a[1], a[2],
                                                        a[3].wh), sets)
            layer_ms = cuda_ms(lambda a: kernels.lstm_layer_fused(
                a[0], a[1], a[2], a[3]), sets)
            step_ms = cuda_ms(per_step, sets, iters=5)
            p_ms = cuda_ms(lambda a: kernels.lstm_layer_plain(
                a[4], a[1], a[2], a[3].wh), sets, iters=5)
            lib_ms = cuda_ms(cudnn, sets)
            tiny = [(torch.randn(t, 1, 64, generator=g, device=dev),
                     torch.zeros(1, 16, device=dev),
                     torch.zeros(1, 16, device=dev),
                     torch.randn(16, 64, generator=g, device=dev) * 0.25)]
            floor_ms = cuda_ms(lambda a: kernels.lstm_layer(*a), tiny)
        bound = layer_bound_ms(t, b, hidden)
        out[hidden] = {"ms": k_ms, "layer_ms": layer_ms,
                       "per_step_ms": step_ms, "plain_ms": p_ms,
                       "library_ms": lib_ms, "bound_ms": bound,
                       "serial_floor_ms": floor_ms, "max_abs_err": err,
                       "library_max_abs_diff": lib_err,
                       "shape": [t, b, hidden]}
        print(f"kernel lstm_layer T={t} B={b} H={hidden} kernel_ms={k_ms:.5f} "
              f"layer_ms={layer_ms:.5f} per_step_ms={step_ms:.5f} "
              f"plain_ms={p_ms:.5f} library_ms={lib_ms:.5f} "
              f"bound_ms={bound:.5f} serial_floor_ms={floor_ms:.5f} "
              f"kernel_over_library={k_ms / lib_ms:.3f} "
              f"layer_over_library={layer_ms / lib_ms:.3f} "
              f"library_max_abs_diff={lib_err:.3e}", flush=True)
        del sets, x, h0, c0, w, xw
    return out


#: the bf16 layer kernels against their plain loops, of each output's
#: largest magnitude: the product's f32 sums run in another order than
#: cuBLAS's, so a bf16 rounding can fall one ulp apart and the steps carry
#: it (the CPU tests' bf16 bound against JAX)
TOL_LAYER_BF16 = 2.0 ** -6


def layer_bf16_bound_ms(t: int, b: int, hidden: int) -> float:
    """Least time of one bf16 layer window from xw: 2 T B H 4H operations
    at the bf16 tensor-core peak against xw in (bf16), the f32 gates out,
    h and c out, Wh, b, h0 and c0 once (bf16); and which bounds it."""
    ops = 2.0 * t * b * hidden * 4 * hidden
    nbytes = 2.0 * t * b * 4 * hidden + 4.0 * t * b * 4 * hidden \
        + 2.0 * (2 * t * b * hidden + 4 * hidden * hidden + 4 * hidden
                 + 2 * b * hidden)
    by_bytes, by_ops = nbytes / H100_BYTES_PER_S, ops / (BF16_TFLOPS * 1e12)
    return max(by_bytes, by_ops) * 1e3, \
        "bytes" if by_bytes >= by_ops else "operations"


def layer_bwd_bound_ms(t: int, b: int, hidden: int, itemsize: int):
    """Least time of one BPTT window: 2 T B 4H H operations (dh = dG Wh^T)
    at the peak for the inputs' type (f32 67, bf16 989 TFLOP/s) against
    the f32 gates, c, dhs, dcs, c0 and Wh in and dG, dh0, dc0 out once;
    and which bounds it."""
    ops = 2.0 * t * b * 4 * hidden * hidden
    peak = FP32_TFLOPS if itemsize == 4 else BF16_TFLOPS
    nbytes = 4.0 * t * b * 4 * hidden + itemsize * (
        3 * t * b * hidden + b * hidden + 4 * hidden * hidden
        + t * b * 4 * hidden + 2 * b * hidden)
    by_bytes, by_ops = nbytes / H100_BYTES_PER_S, ops / (peak * 1e12)
    return max(by_bytes, by_ops) * 1e3, \
        "bytes" if by_bytes >= by_ops else "operations"


def _rel_of_max(a, w) -> float:
    """max |a - w| over max |w| (0 for an all-zero w equal to a)."""
    w = w.detach().float()
    err = float((a.detach().float() - w).abs().max())
    return err / max(float(w.abs().max()), 1e-30)


def _draw_layer(g, dev, t, b, hidden, dtype):
    """Seeded x (T, B, H), h0, c0 and PTB-scaled weights in ``dtype``."""
    import torch
    from dt_tpu_torch.ops import rnn
    lim = hidden ** -0.5
    x = torch.randn(t, b, hidden, generator=g, device=dev).to(dtype)
    h0, c0 = ((torch.randn(b, hidden, generator=g, device=dev) * 0.3)
              .to(dtype) for _ in range(2))
    wx, wh = (((torch.rand(hidden, 4 * hidden, generator=g, device=dev) * 2
                - 1) * lim).to(dtype) for _ in range(2))
    bias = (torch.randn(4 * hidden, generator=g, device=dev) * 0.02) \
        .to(dtype)
    return x, h0, c0, rnn.LSTMWeights(wx, wh, bias)


def _cudnn_layer(a, dev, dtype):
    """cuDNN's one-layer LSTM with the weights of ``a`` (x, h0, c0, w):
    its module (a yardstick the port never calls)."""
    import torch
    hidden = a[1].shape[-1]
    mod = torch.nn.LSTM(a[0].shape[-1], hidden, 1).to(dev, dtype)
    with torch.no_grad():
        for name, val in (("weight_ih_l0", a[3].wx.t()),
                          ("weight_hh_l0", a[3].wh.t()),
                          ("bias_ih_l0", a[3].b),
                          ("bias_hh_l0", torch.zeros_like(a[3].b))):
            getattr(mod, name).copy_(val)
    mod.flatten_parameters()
    return mod


def lstm_layer_bf16_phase(dev):
    """Hold the bf16 layer kernel against its plain step loop at the PTB
    window (T 35, B 32) with H 200 and 650, forward and reverse, within
    ``TOL_LAYER_BF16`` of each output's largest magnitude and two launches
    bit-identical; time it alone, with its input product, beside its
    bound, the plain loop, the stepped path (the bf16 fused cell a step,
    the pointwise kernel and all) and cuDNN's one-layer LSTM in bf16
    (``torch._VF.lstm``, a yardstick the port never calls).  Returns one
    summary per H."""
    import torch
    from dt_tpu_torch.ops import kernels
    t, b, bf = PTB_BPTT, PTB_BATCH, torch.bfloat16
    out = {}
    for hidden in (200, 650):
        g = torch.Generator(device=dev).manual_seed(hidden + 2)
        sets = []
        for _ in range(2):
            x, h0, c0, w = _draw_layer(g, dev, t, b, hidden, bf)
            xw = (x.reshape(t * b, hidden) @ w.wx).reshape(t, b, -1)
            sets.append((x, h0, c0, w, xw))
        x, h0, c0, w, xw = sets[0]
        err, abs_err, same = 0.0, 0.0, True
        for reverse in (False, True):
            got = kernels.lstm_layer(xw, h0, c0, w.wh, reverse, b=w.b)
            again = kernels.lstm_layer(xw, h0, c0, w.wh, reverse, b=w.b)
            want = kernels.lstm_layer_plain(xw, h0, c0, w.wh, reverse,
                                            b=w.b)
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, a2)
                                for a, a2 in zip(got, again))
            err = max([err] + [_rel_of_max(a, p) for a, p in zip(got, want)])
            abs_err = max([abs_err] + [float((a.float() - p.float()).abs()
                                             .max())
                                       for a, p in zip(got, want)])
        print(f"kernel lstm_layer[bfloat16] T={t} B={b} H={hidden} geometry="
              f"{tuple(kernels.layer_geometry(b, hidden, bf))} "
              f"max_abs_err={abs_err:.3e} max_rel_err={err:.3e} (tol "
              f"{TOL_LAYER_BF16:.3e} of the largest) bitwise_repeat={same}",
              flush=True)
        if not same or not err <= TOL_LAYER_BF16:
            raise AssertionError(f"lstm_layer[bfloat16] H={hidden}: kernel "
                                 "against plain version failed")
        mods = [_cudnn_layer(a, dev, bf) for a in sets]
        sets = [(*a, m._flat_weights) for a, m in zip(sets, mods)]

        def cudnn(a):
            return torch._VF.lstm(a[0], (a[1][None], a[2][None]), a[5],
                                  True, 1, 0.0, False, False, False)

        def per_step(a):  # the path before this kernel: a cell a step
            hh, cc = a[1], a[2]
            for s_ in range(t):
                hh, cc = kernels.lstm_cell_fused(a[0][s_], hh, cc, a[3])
            return hh

        with torch.no_grad():
            k_ms = cuda_ms(lambda a: kernels.lstm_layer(
                a[4], a[1], a[2], a[3].wh, b=a[3].b), sets)
            layer_ms = cuda_ms(lambda a: kernels.lstm_layer_fused(
                a[0], a[1], a[2], a[3]), sets)
            step_ms = cuda_ms(per_step, sets, iters=5)
            p_ms = cuda_ms(lambda a: kernels.lstm_layer_plain(
                a[4], a[1], a[2], a[3].wh, b=a[3].b), sets, iters=5)
            try:  # a yardstick only
                lib_ms = cuda_ms(cudnn, sets)
            except RuntimeError as e:
                print(f"kernel lstm_layer[bfloat16] H={hidden}: cuDNN's "
                      f"bf16 LSTM not measured ({e})", flush=True)
                lib_ms = None
        bound, bound_by = layer_bf16_bound_ms(t, b, hidden)
        out[hidden] = {"ms": k_ms, "layer_ms": layer_ms,
                       "per_step_ms": step_ms, "plain_ms": p_ms,
                       "library_ms": lib_ms, "bound_ms": bound,
                       "bound_by": bound_by, "max_abs_err": abs_err,
                       "max_rel_err": err, "shape": [t, b, hidden]}
        print(f"kernel lstm_layer[bfloat16] T={t} B={b} H={hidden} "
              f"kernel_ms={k_ms:.5f} layer_ms={layer_ms:.5f} "
              f"per_step_ms={step_ms:.5f} plain_ms={p_ms:.5f} "
              f"library_ms={lib_ms} bound_ms={bound:.5f} ({bound_by})",
              flush=True)
        del sets, mods
    return out


def _backward_ms(fwd, leaves, cot) -> float:
    """ms of a backward alone: forward + backward less forward (medians by
    CUDA events, grad mode on for both)."""
    import torch

    def both():
        y = fwd()
        torch.autograd.grad((y.float() * cot).sum(), leaves)

    return _events_ms(both) - _events_ms(fwd)


def lstm_layer_bwd_phase(dev):
    """Hold the BPTT kernel against its plain loop in f32 and bf16 at the
    PTB window (T 35, B 32) with H 200 and 650, forward and reverse, on the
    forward kernel's own gates and cs with seeded outside gradients: within
    1e-5 (f32) or ``TOL_LAYER_BF16`` (bf16) of each output's largest
    magnitude, two launches bit-identical; time it beside its bound, its
    plain loop (the port's backward before this kernel), the stepped path's
    backward (autograd through the fused cell a step) and cuDNN's (both:
    forward + backward less forward, CUDA events; cuDNN a yardstick the
    port never calls).  Returns one summary per (dtype name, H)."""
    import torch
    from dt_tpu_torch.ops import kernels
    t, b = PTB_BPTT, PTB_BATCH
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = 1e-5 if dtype == torch.float32 else TOL_LAYER_BF16
        for hidden in (200, 650):
            g = torch.Generator(device=dev).manual_seed(hidden + 3)
            draws = [_draw_layer(g, dev, t, b, hidden, dtype)
                     for _ in range(2)]
            err, abs_err, same = 0.0, 0.0, True
            sets = []
            for reverse in (False, True):
                for x, h0, c0, w in draws:
                    xw = (x.reshape(t * b, hidden) @ w.wx).reshape(t, b, -1)
                    if dtype == torch.float32:
                        _, cs, gates = kernels.lstm_layer(xw + w.b, h0, c0,
                                                          w.wh, reverse)
                    else:
                        _, cs, gates = kernels.lstm_layer(xw, h0, c0, w.wh,
                                                          reverse, b=w.b)
                    dhs, dcs = (torch.randn(t, b, hidden, generator=g,
                                            device=dev).to(dtype)
                                for _ in range(2))
                    args = (gates, cs, c0, w.wh, dhs, dcs, reverse)
                    if not reverse:
                        sets.append(args)
                got = kernels.lstm_layer_bwd(*args)
                again = kernels.lstm_layer_bwd(*args)
                want = kernels.lstm_layer_bwd_plain(*args)
                torch.cuda.synchronize()
                same = same and all(torch.equal(a, a2)
                                    for a, a2 in zip(got, again))
                err = max([err] + [_rel_of_max(a, p)
                                   for a, p in zip(got, want)])
                abs_err = max([abs_err] + [
                    float((a.float() - p.float()).abs().max())
                    for a, p in zip(got, want)])
            print(f"kernel lstm_layer_bwd[{name}] T={t} B={b} H={hidden} "
                  f"geometry="
                  f"{tuple(kernels.layer_bwd_geometry(b, hidden, dtype))} "
                  f"max_abs_err={abs_err:.3e} max_rel_err={err:.3e} (tol "
                  f"{tol:.3e} of the largest) bitwise_repeat={same}",
                  flush=True)
            if not same or not err <= tol:
                raise AssertionError(f"lstm_layer_bwd[{name}] H={hidden}: "
                                     "kernel against plain version failed")
            k_ms = cuda_ms(lambda a: kernels.lstm_layer_bwd(*a), sets)
            p_ms = cuda_ms(lambda a: kernels.lstm_layer_bwd_plain(*a), sets,
                           iters=5)
            x, h0, c0, w = draws[0]
            cot = torch.randn(t, b, hidden, generator=g, device=dev)
            leaves = [a.clone().requires_grad_() for a in (x, h0, c0, *w)]

            def stepped():
                hh, cc, ys = leaves[1], leaves[2], []
                lw = type(w)(*leaves[3:])
                for s_ in range(t):
                    hh, cc = kernels.lstm_cell_fused(leaves[0][s_], hh, cc,
                                                     lw)
                    ys.append(hh)
                return torch.stack(ys)

            step_ms = _backward_ms(stepped, leaves, cot)
            mod = _cudnn_layer(draws[0], dev, dtype)
            xl = x.clone().requires_grad_()
            try:  # a yardstick only
                lib_ms = _backward_ms(
                    lambda: mod(xl, (h0[None], c0[None]))[0],
                    [xl, *mod.parameters()], cot)
            except RuntimeError as e:
                print(f"kernel lstm_layer_bwd[{name}] H={hidden}: cuDNN's "
                      f"LSTM backward not measured ({e})", flush=True)
                lib_ms = None
            bound, bound_by = layer_bwd_bound_ms(t, b, hidden,
                                                 torch.tensor(
                                                     [], dtype=dtype)
                                                 .element_size())
            out[name, hidden] = {
                "ms": k_ms, "plain_ms": p_ms, "stepped_backward_ms": step_ms,
                "library_ms": lib_ms, "bound_ms": bound,
                "bound_by": bound_by, "max_abs_err": abs_err,
                "max_rel_err": err, "shape": [t, b, hidden]}
            print(f"kernel lstm_layer_bwd[{name}] T={t} B={b} H={hidden} "
                  f"kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} "
                  f"stepped_backward_ms={step_ms:.5f} library_ms={lib_ms} "
                  f"bound_ms={bound:.5f} ({bound_by})", flush=True)
            del draws, sets, leaves, mod, xl
    return out


def seeded_lm_variables(model, seed: int, head_std: float = 1.0):
    """Weights for an LM in the JAX layout from numpy with ``seed``:
    LeCun-normal kernels and MoE experts (the LM head's times
    ``head_std``; a pipelined model's stacked stages alike), N(0, 1)
    embeddings, N(0, 0.02) positions, LayerNorm scale 1 + N(0, 0.05), the
    LSTM's uniform(+-1/sqrt(H)), biases N(0, 0.02)."""
    from dt_tpu_torch.interchange import export_jax_variables
    rng = np.random.RandomState(seed)

    def fill(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,))
                continue
            shape = tuple(v.shape)
            if k in ("kernel", "wi", "wo"):  # fan-in: the axis before last
                std = 1.0 / np.sqrt(shape[-2])
                if path and path[-1] in ("lm_head", "Dense_0"):
                    std *= head_std
                w = rng.normal(0, std, shape)
            elif k == "embedding":
                w = rng.normal(0, 1.0, shape)
            elif k == "pos_embed":
                w = rng.normal(0, 0.02, shape)
            elif k == "scale":
                w = 1.0 + rng.normal(0, 0.05, shape)
            elif k.endswith(("_wx", "_wh")):
                lim = 1.0 / np.sqrt(shape[1] // 4)
                w = rng.uniform(-lim, lim, shape)
            elif k == "bias" or k.endswith("_b"):
                w = rng.normal(0, 0.02, shape)
            else:
                raise KeyError(f"unexpected leaf {k!r}")
            out[k] = w.astype(np.float32)
        return out

    return {"params": fill(export_jax_variables(model)["params"])}


def _timed_steps(step) -> dict:
    """Step time by the host clock, queued and synced (``bench.py:462-486,
    619-631``), and the smaller of the two."""
    import torch
    t0 = time.perf_counter()
    for _ in range(TIME_STEPS):
        step()
    torch.cuda.synchronize()
    queued = (time.perf_counter() - t0) / TIME_STEPS
    t0 = time.perf_counter()
    for _ in range(TIME_STEPS):
        step()
        torch.cuda.synchronize()
    synced = (time.perf_counter() - t0) / TIME_STEPS
    return {"step_ms": min(queued, synced) * 1e3,
            "step_ms_queued": queued * 1e3, "step_ms_synced": synced * 1e3,
            "sync_agreement": min(queued, synced) / max(queued, synced)}


def _check_counts(tag, counts, want):
    print(f"{tag} launches={json.dumps(counts)} expected={json.dumps(want)}",
          flush=True)
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want}")


def _falling(tag, losses):
    """Finite and falling: the mean of the last three steps below the first
    (lr 0.1 on one batch overshoots now and then)."""
    print(f"{tag} losses={[round(v, 5) for v in losses]}", flush=True)
    if not (np.isfinite(losses).all() and np.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"{tag}: loss not finite and falling: {losses}")


def lm_train_phase(dev, gpu):
    """The TransformerLM of ``bench.py:579-598`` trained through
    ``train_step`` with the next-token loss (the main path: counts reset
    just before the ten steps and read just after)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.training.step import next_token_loss, train_step
    from dt_tpu_torch.training.train_state import TrainState
    model = models.create("transformer_lm", device=dev, seq_parallel="flash",
                          dtype=torch.bfloat16, **LM)
    load_jax_variables(model, seeded_lm_variables(model, seed=0))
    state = TrainState.create(model, optim.create("sgd", **LM_SGD))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, LM["vocab_size"], (LM_BATCH, LM_SEQ))).to(dev)

    def step():
        return train_step(state, tokens, None, loss_fn=next_token_loss)[1]

    step()  # warm up: cuBLAS plans, the allocator's pool
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path's run starts here
    losses = [float(step()) for _ in range(TRAIN_STEPS)]
    counts = read_counts()  # ... and ends here
    want = {k: 0 for k in counts}
    want["flash_attention"] = LM["num_layers"] * TRAIN_STEPS
    _check_counts("lm_train bf16", counts, want)
    _falling("lm_train bf16", losses)
    res = {"launches": counts, "losses": losses, **_timed_steps(step),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["tokens_per_s"] = LM_BATCH * LM_SEQ * 1e3 / res["step_ms"]
    with FlopCounterMode(display=False) as fc:
        step()
    # FlopCounterMode sees the PyTorch ops (the matmuls, and the plain
    # attention backward's five per kv block) but not the ctypes flash
    # forward: add the causal work it does, once per layer
    attn = LM["num_layers"] * flash_flops(
        LM_BATCH * LM["num_heads"], LM_SEQ, LM["embed_dim"] // LM["num_heads"])
    flops = fc.get_total_flops() + attn
    res.update(step_gflop=flops / 1e9, flash_fwd_gflop=attn / 1e9,
               model_tflops_per_s=flops / res["step_ms"] / 1e9,
               share_of_bf16_peak=flops / res["step_ms"] / 1e9 / BF16_TFLOPS)
    print("lm_train bf16 " + " ".join(
        f"{k}={round(v, 4) if isinstance(v, float) else v}"
        for k, v in res.items() if k not in ("launches", "losses"))
        + f" gpu={gpu}", flush=True)
    res.update(profile_fn(step, res["step_ms"], "lm_train bf16 step"))
    del model, state, tokens
    torch.cuda.empty_cache()
    return res


def ptb_stream(vocab: int, seed: int = 0):
    """The PTB example's synthetic stream (``train_lstm_ptb.py:65-69``):
    200,000 seeded tokens batchified to ``(T_total, B)``."""
    toks = np.random.RandomState(seed).randint(0, vocab, 200000)
    nb = len(toks) // PTB_BATCH
    return toks[:nb * PTB_BATCH].reshape(PTB_BATCH, nb).T


def lstm_train_phase(dev, gpu):
    """The PTB LSTM LM trained through ``train_step`` with the BPTT loss
    and the clip, window after window with the state carried (the main
    path: counts reset just before the ten windows and read just
    after)."""
    import torch
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.training.step import BPTTLoss, train_step
    from dt_tpu_torch.training.train_state import TrainState
    model = models.create("lstm_lm", device=dev, **PTB)
    # the head at 40x LeCun: the LSTM's outputs are small (|h| ~ 0.03), so
    # at LeCun scale the logits are near-uniform and the loss starts at the
    # uniform stream's floor log(10000) = 9.21 with nothing to fall; at 40x
    # it starts ~1.1 nats above it (10.31 on the CPU at this seed)
    load_jax_variables(model, seeded_lm_variables(model, seed=1,
                                                  head_std=40.0))
    state = TrainState.create(model, optim.create("sgd",
                                                  learning_rate=PTB_LR))
    stream = torch.from_numpy(ptb_stream(PTB["vocab_size"])).to(dev)
    loss_fn = BPTTLoss(generator=torch.Generator(device=dev).manual_seed(2))
    window = iter(range(0, stream.shape[0] - 1 - PTB_BPTT, PTB_BPTT))

    def step():
        i = next(window)
        return train_step(state, stream[i:i + PTB_BPTT],
                          stream[i + 1:i + 1 + PTB_BPTT], loss_fn=loss_fn,
                          clip_norm=PTB_CLIP)[1]

    step()  # warm up
    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
    losses = [float(step()) for _ in range(TRAIN_STEPS)]
    counts = read_counts()  # ... and ends here
    want = {k: 0 for k in counts}
    want["lstm_layer"] = PTB["num_layers"] * TRAIN_STEPS
    want["lstm_layer_bwd"] = PTB["num_layers"] * TRAIN_STEPS
    _check_counts("lstm_train f32", counts, want)
    _falling("lstm_train f32", losses)
    res = {"launches": counts, "losses": losses, **_timed_steps(step)}
    res["tokens_per_s"] = PTB_BPTT * PTB_BATCH * 1e3 / res["step_ms"]
    print("lstm_train f32 " + " ".join(
        f"{k}={round(v, 4) if isinstance(v, float) else v}"
        for k, v in res.items() if k not in ("launches", "losses"))
        + f" gpu={gpu}", flush=True)
    res.update(profile_fn(step, res["step_ms"], "lstm_train f32 window"))
    del model, state, stream
    torch.cuda.empty_cache()
    return res


def lstm_bf16_forward(dev):
    """The PTB LSTM LM's forward in bf16 over one window (a bf16 layer is
    one launch of the bf16 layer kernel, no pointwise launch; counts reset
    just before and read just after), its logits against the same model in
    f32 within ``TOL_LSTM_BF16`` of the largest |logit|."""
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch.interchange import load_jax_variables
    cfg = dict(PTB, dropout=0.0)
    variables = seeded_lm_variables(models.create("lstm_lm", device="cpu",
                                                  **cfg), seed=1,
                                    head_std=40.0)
    tokens = torch.from_numpy(ptb_stream(PTB["vocab_size"])[:PTB_BPTT]) \
        .to(dev)
    logits = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = load_jax_variables(models.create("lstm_lm", device=dev,
                                                 dtype=dtype, **cfg),
                                   variables)
        with torch.no_grad():
            model(tokens, training=False)  # warm up
            torch.cuda.synchronize()
            reset_counts()  # the path's run starts here
            logits[dtype] = model(tokens, training=False)[0].float()
            counts = read_counts()  # ... and ends here
        if dtype == torch.bfloat16:
            want = {k: 0 for k in counts}
            want["lstm_layer"] = PTB["num_layers"]
            _check_counts("lstm_forward bf16", counts, want)
    f32, bf = logits[torch.float32], logits[torch.bfloat16]
    scale = float(f32.abs().max())
    err = float((bf - f32).abs().max())
    print(f"lstm_forward bf16 vs f32 max_abs_err={err:.3e} "
          f"max_abs_logit={scale:.3f} tol={TOL_LSTM_BF16 * scale:.3e} "
          f"finite={bool(torch.isfinite(bf).all())}", flush=True)
    if not (torch.isfinite(bf).all() and err <= TOL_LSTM_BF16 * scale):
        raise AssertionError("bf16 LSTM LM forward disagrees with f32")
    return {"launches": counts, "max_abs_err": err}


#: the wide-layer route: an f32 layer too wide for the layer kernels
#: (``layer_fits`` False past H 6404) steps the fused cell a step
WIDE_LSTM = dict(t=3, batch=1, inputs=64, hidden=6656)


def lstm_wide_forward(dev):
    """``ops.rnn.lstm`` on a layer too wide for the layer kernels (f32, B 1,
    H 6656): it steps ``lstm_cell_fused``, one pointwise launch a step and
    no layer launch (counts reset just before and read just after); its
    outputs against the plain cell (``fused=False``) within 1e-5."""
    import torch
    from dt_tpu_torch.ops import kernels, rnn
    t, b, i, h = (WIDE_LSTM[k] for k in ("t", "batch", "inputs", "hidden"))
    if kernels.layer_fits(b, h):
        raise AssertionError(f"H {h} fits the layer kernels")
    g = torch.Generator(device=dev).manual_seed(6)
    lim = h ** -0.5
    x = torch.randn(t, b, i, generator=g, device=dev)
    h0, c0 = (torch.randn(1, b, h, generator=g, device=dev) * 0.3
              for _ in range(2))
    w = [rnn.LSTMWeights(*(((torch.rand(n, 4 * h, generator=g, device=dev)
                             * 2 - 1) * lim) for n in (i, h)),
                         torch.randn(4 * h, generator=g, device=dev) * 0.02)]
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()  # the path's run starts here
        got = rnn.lstm(x, h0, c0, w)
        torch.cuda.synchronize()
        counts = read_counts()  # ... and ends here
        want = rnn.lstm(x, h0, c0, w, fused=False)
    expect = {k: 0 for k in counts}
    expect["lstm_pointwise"] = t
    _check_counts(f"lstm_wide f32 T{t} B{b} H{h}", counts, expect)
    err = max(float((a - e).abs().max()) for a, e in zip(got, want))
    print(f"lstm_wide f32 T{t} B{b} H{h} vs the plain cell max_abs_err="
          f"{err:.3e} (tol 1e-5)", flush=True)
    if not err <= 1e-5:
        raise AssertionError("the wide LSTM layer disagrees with the plain "
                             "cell")
    del w, x
    torch.cuda.empty_cache()
    return {"launches": counts, "max_abs_err": err}


def lm_steps_card_vs_cpu() -> dict:
    """One f32 step of each LM on the card and on the CPU from the same
    weights, compared within ``TOL_LM_STEP``: the TransformerLM at 2
    layers, S 256, batch 2 (flash: the f32 kernel on the card, the plain
    version on the CPU); the LSTM LM's first window at dropout 0 (the layer
    kernel).  Each card step is a path of its own: counts reset just before
    it and read just after.  Returns the counts by model."""
    import torch
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.ops.tensor import clip_global_norm
    from dt_tpu_torch.training.step import (BPTTLoss, apply_step, grad_step,
                                            next_token_loss)
    from dt_tpu_torch.training.train_state import TrainState
    lm = dict(LM, num_layers=2, max_len=256)
    stream = ptb_stream(PTB["vocab_size"])
    cases = {
        "transformer_lm": (dict(lm, seq_parallel="flash"), LM_SGD,
                           next_token_loss, None,
                           np.random.RandomState(7).randint(
                               0, LM["vocab_size"], (2, 256)), None),
        "lstm_lm": (dict(PTB, dropout=0.0), dict(learning_rate=PTB_LR),
                    None, PTB_CLIP, stream[:PTB_BPTT],
                    stream[1:1 + PTB_BPTT])}
    expected = {"transformer_lm": {"flash_attention": lm["num_layers"]},
                "lstm_lm": {"lstm_layer": PTB["num_layers"],
                            "lstm_layer_bwd": PTB["num_layers"]}}
    launched = {}
    for name, (kw, sgd, loss_fn, clip, x, y) in cases.items():
        variables = seeded_lm_variables(
            models.create(name, device="cpu", **kw), seed=3)
        got = {}
        for where in ("cuda", "cpu"):
            model = load_jax_variables(models.create(name, device=where,
                                                     **kw), variables)
            state = TrainState.create(model, optim.create("sgd", **sgd))
            xt = torch.from_numpy(x).to(where)
            yt = None if y is None else torch.from_numpy(y).to(where)
            t0 = time.perf_counter()
            reset_counts()  # the card step's run starts here
            flat_g, flat_s, loss, _ = grad_step(state, xt, yt,
                                                loss_fn or BPTTLoss())
            if where == "cuda":
                launched[name] = read_counts()  # ... and ends here
                want = {k: 0 for k in launched[name]}
                want.update(expected[name])
                _check_counts(f"lm step f32 {name}", launched[name], want)
            if clip is not None:
                flat_g = clip_global_norm({"g": flat_g}, clip)[0]["g"]
            apply_step(state, flat_g, flat_s)
            lay = state.layout
            got[where] = {"loss": loss.cpu(), "flat_g": flat_g.cpu(),
                          "params": lay.params.ravel(state.params).cpu()}
            if "mom" in state.opt_state:
                got[where]["mom"] = lay.params.ravel(
                    state.opt_state["mom"]).cpu()
            print(f"lm step card-vs-cpu {name} {where} seconds="
                  f"{time.perf_counter() - t0:.2f}", flush=True)
        card, cpu = got["cuda"], got["cpu"]
        errs = {"loss": abs(float(card["loss"]) - float(cpu["loss"]))
                / abs(float(cpu["loss"]))}
        errs.update({k: _rel(card[k], cpu[k]) for k in card if k != "loss"})
        print(f"lm step card-vs-cpu {name} f32 " + " ".join(
            f"{k}_err={v:.3e} (tol {TOL_LM_STEP[k]})"
            for k, v in errs.items()), flush=True)
        bad = {k: v for k, v in errs.items() if not v <= TOL_LM_STEP[k]}
        if bad:
            raise AssertionError(f"{name} f32 step, card against CPU: {bad}")
    return launched


def fit_phase(dev, gpu, train_bf16) -> dict:
    """``Module.fit`` on the card, the slice's main path: ResNet-50 v1 in
    bfloat16 at full width from the port's own ``init_params(seed=0)``, SGD
    lr 0.1 momentum 0.9 wd 1e-4, 4 epochs of a shuffled seeded 64-image
    ``NDArrayIter`` (batch 32, 8 steps) behind a ``DevicePrefetchIter``,
    ``eval_data`` of 32 images, metrics ce and acc, a ``Speedometer`` and
    ``do_checkpoint``.  Counts are reset just before ``fit`` and read just
    after: 53 ``bn_stats`` a step, and ``bn_act`` 53 a step plus 53 an eval
    forward.  The train cross-entropy is finite each epoch and lower in the
    last than in the first; the last checkpoint reloads into a bf16
    ``Predictor`` whose logits match ``Module.predict``'s within
    ``TOL_BF16`` of the largest |logit|.  Then fit's step time (3 epochs
    without eval or checkpoint, behind ``DevicePrefetchIter`` and without
    it) against the bare ``train_step`` on the same module, in alternating
    rounds, and profiles of a fit epoch and of bare steps."""
    import tempfile
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch.data import io
    from dt_tpu_torch.predictor import Predictor
    from dt_tpu_torch.training import callbacks
    from dt_tpu_torch.training.module import Module
    from dt_tpu_torch.training.step import train_step
    n_train, n_eval, epochs = 2 * BATCH, BATCH, FIT_EPOCHS
    rng = np.random.RandomState(7)
    images = rng.uniform(-1, 1, (n_train + n_eval, IMAGE, IMAGE, 3)) \
        .astype(np.float32)
    labels = rng.randint(0, 1000, n_train + n_eval).astype(np.int32)
    mod = Module(models.create("resnet50", device=dev, dtype=torch.bfloat16),
                 optimizer="sgd", optimizer_params=FIT_SGD, device=dev,
                 seed=0)
    mod.init_params()

    spare = Module(models.create("resnet50", device=dev,
                                 dtype=torch.bfloat16),
                   optimizer="sgd", optimizer_params=FIT_SGD, device=dev)
    spare.init_params()
    before = _fit_rounds(spare, images[:n_train], labels[:n_train], dev, 1,
                         0)
    del spare

    def train_iter():
        return io.DevicePrefetchIter(io.NDArrayIter(
            images[:n_train], labels[:n_train], batch_size=BATCH,
            shuffle=True, seed=0), device=dev)

    eval_iter = io.NDArrayIter(images[n_train:], labels[n_train:],
                               batch_size=BATCH)
    per_epoch = []

    def record(epoch, state, metric):
        per_epoch.append(dict(metric.get_name_value()))

    speed = callbacks.Speedometer(BATCH, frequent=1, auto_reset=False)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "resnet50")
        torch.cuda.synchronize()
        reset_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        mod.fit(train_iter(), eval_data=eval_iter, eval_metric=["ce", "acc"],
                num_epoch=epochs, batch_end_callback=speed,
                epoch_end_callback=[record,
                                    callbacks.do_checkpoint(prefix)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()  # ... and ends here
        steps = epochs * n_train // BATCH
        want = {k: 0 for k in counts}
        want.update(bn_stats=BN_PER_FORWARD * steps,
                    bn_act=BN_PER_FORWARD * (steps + epochs))
        _check_counts("fit bf16", counts, want)
        ce = [e["cross-entropy"] for e in per_epoch]
        print(f"fit bf16 epochs={epochs} steps={steps} wall_s={wall:.3f} "
              f"train_ce={[round(v, 5) for v in ce]} "
              f"train_acc={[e['accuracy'] for e in per_epoch]} "
              f"speedometer_samples_per_s="
              f"{[round(v, 1) for v in speed.speeds]} gpu={gpu}", flush=True)
        if not (np.isfinite(ce).all() and ce[-1] < ce[0]):
            raise AssertionError(f"fit: train cross-entropy not finite and "
                                 f"falling: {ce}")
        pred = Predictor("resnet50", prefix, epochs - 1, images[:1],
                         dtype=torch.bfloat16, max_batch=4, device=dev)
        got = pred.predict(images[:4])
    want_logits = mod.predict(images[:4])
    err = float(np.abs(got - want_logits).max())
    tol = TOL_BF16 * float(np.abs(want_logits).max())
    print(f"fit checkpoint -> Predictor bf16: max_abs_err={err:.3e} "
          f"tol={tol:.3e} step={int(np.asarray(pred.step))}", flush=True)
    if not (np.isfinite(got).all() and err <= tol):
        raise AssertionError("fit: the reloaded checkpoint's logits disagree "
                             "with Module.predict")

    # fit's own step time against the bare step on the same module, in
    # alternating rounds (host clocks drift within a run): medians over
    # FIT_ROUNDS rounds after the main path, and one round on a fresh
    # module run before it (does the main path's eval, checkpoints and
    # Predictor leave the process slower?)
    times = _fit_rounds(mod, images[:n_train], labels[:n_train], dev,
                        FIT_ROUNDS, epochs)
    med = {k: float(np.median(v)) for k, v in times.items()}
    nd = io.NDArrayIter(images[:n_train], labels[:n_train], batch_size=BATCH,
                        shuffle=True)
    t0 = time.perf_counter()
    batches = [nd.next().data for _ in range(2)]
    nd.reset()
    batches += [nd.next().data for _ in range(2)]
    t1 = time.perf_counter()
    for b in batches:
        torch.from_numpy(b).pin_memory()
    t2 = time.perf_counter()
    step_ms = med["prefetch"]
    res = {"launches": counts, "train_ce": ce, "wall_s": wall,
           "step_ms": step_ms, "imgs_per_s": BATCH * 1e3 / step_ms,
           "bare_step_ms": med["bare"],
           "bare_imgs_per_s": BATCH * 1e3 / med["bare"],
           "loop_overhead_ms": step_ms - med["bare"],
           "step_ms_without_prefetch_iter": med["plain"],
           "bare_cpu_ms": med["bare_cpu"], "fit_cpu_ms": med["prefetch_cpu"],
           "rounds_ms": times, "before_main_path_ms": before,
           "train_phase_step_ms": train_bf16["step_ms"],
           "host_gather_ms": (t1 - t0) * 1e3 / 4,
           "host_pin_ms": (t2 - t1) * 1e3 / 4,
           "checkpoint_max_abs_err": err}
    print(f"fit bf16 step_ms={step_ms:.3f} imgs_per_s="
          f"{res['imgs_per_s']:.1f} bare_step_ms={med['bare']:.3f} "
          f"bare_imgs_per_s={res['bare_imgs_per_s']:.1f} "
          f"loop_overhead_ms={res['loop_overhead_ms']:.3f} "
          f"step_ms_without_prefetch_iter={med['plain']:.3f} "
          f"bare_cpu_ms={med['bare_cpu']:.3f} "
          f"fit_cpu_ms={med['prefetch_cpu']:.3f} "
          f"train_phase_step_ms={train_bf16['step_ms']:.3f} "
          f"host_gather_ms={res['host_gather_ms']:.3f} "
          f"host_pin_ms={res['host_pin_ms']:.3f} gpu={gpu}", flush=True)
    for tag, t in (("after", times), ("before", before)):
        print(f"fit bf16 rounds_ms {tag} the main path " + json.dumps(
            {k: [round(v, 3) for v in vs] for k, vs in t.items()}),
            flush=True)
    it = io.DevicePrefetchIter(nd, device=dev)
    res.update(profile_fn(
        lambda: mod.fit(it, num_epoch=1), step_ms * n_train // BATCH,
        "fit bf16 epoch"))
    x, y = mod._place(images[:BATCH]), mod._place(labels[:BATCH], label=True)
    res.update({f"bare_{k}": v for k, v in profile_fn(
        lambda: [train_step(mod.state, x, y, loss_fn=mod._forward_loss)
                 for _ in range(2)], med["bare"] * 2,
        "fit bf16 bare 2 steps").items()})
    del mod, pred
    torch.cuda.empty_cache()
    return res


def _fit_rounds(mod, images, labels, dev, rounds: int,
                first_epoch: int) -> dict:
    """Rounds of: 6 bare ``train_step``s on ``mod`` (one batch, placed),
    3 epochs of ``mod.fit`` over ``images`` (2 steps an epoch) behind
    ``DevicePrefetchIter``, the same without it, 6 bare steps again; each
    fit after one epoch of warm-up.  ``{name: [ms a step]}`` by the host
    clock and (``*_cpu``) by the process's CPU time."""
    import torch
    from dt_tpu_torch.data import io
    from dt_tpu_torch.training.step import train_step
    x = mod._place(images[:BATCH])
    y = mod._place(labels[:BATCH], label=True)
    first = [first_epoch]  # the next epoch number, so each fit counts on
    steps = len(images) // BATCH

    def timed(fn, n):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        fn()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / n,
                (time.process_time() - c0) * 1e3 / n)

    def bare():
        for _ in range(6):
            train_step(mod.state, x, y, loss_fn=mod._forward_loss)

    def fit(it):
        mod.fit(it, num_epoch=first[0] + 1, begin_epoch=first[0])  # warm
        first[0] += 1
        out = timed(lambda: mod.fit(it, num_epoch=first[0] + 3,
                                    begin_epoch=first[0]), 3 * steps)
        first[0] += 3
        return out

    def nd():
        return io.NDArrayIter(images, labels, batch_size=BATCH, shuffle=True)

    times = {k: [] for k in ("bare", "prefetch", "plain", "bare_cpu",
                             "prefetch_cpu", "plain_cpu")}
    for _ in range(rounds):
        for name, fn in (("bare", lambda: timed(bare, 6)),
                         ("prefetch", lambda: fit(io.DevicePrefetchIter(
                             nd(), device=dev))),
                         ("plain", lambda: fit(nd())),
                         ("bare", lambda: timed(bare, 6))):
            wall, cpu = fn()
            times[name].append(wall)
            times[name + "_cpu"].append(cpu)
    return times


def fit_card_vs_cpu() -> dict:
    """A small f32 ``Module.fit`` (``resnet20``, 2 epochs of 64 seeded 8x8x3
    images, batch 32, SGD momentum, the port's own init) on the card and
    on the CPU: per-epoch train cross-entropy within ``TOL_FIT`` relative
    (f32 sums in another order; TF32 is off)."""
    from dt_tpu_torch import models
    from dt_tpu_torch.data import io
    from dt_tpu_torch.training.module import Module
    rng = np.random.RandomState(8)
    x = rng.uniform(-1, 1, (64, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    curves = {}
    for where in ("cuda", "cpu"):
        mod = Module(models.create("resnet20", device=where, num_classes=10),
                     optimizer="sgd", optimizer_params=dict(
                         learning_rate=0.1, momentum=0.9), device=where,
                     seed=1)
        per_epoch = []
        mod.fit(io.NDArrayIter(x, y, batch_size=32, shuffle=True),
                eval_metric="ce", num_epoch=2,
                epoch_end_callback=lambda e, s, m: per_epoch.append(
                    m.get()[1]))
        curves[where] = per_epoch
    rel = max(abs(a - b) / abs(b) for a, b in zip(curves["cuda"],
                                                    curves["cpu"]))
    print(f"fit card-vs-cpu f32 resnet20 ce_card={curves['cuda']} "
          f"ce_cpu={curves['cpu']} max_rel_err={rel:.3e} (tol {TOL_FIT})",
          flush=True)
    if not rel <= TOL_FIT:
        raise AssertionError(f"fit, card against CPU: {curves}")
    return {"max_rel_err": rel, **curves}


def _range_servers(port: int, n: int, tmp: str, sched, deadline_s=60):
    """``n`` port ``RangeServer`` processes registered with the scheduler
    at ``port`` (``python -m dt_tpu_torch.elastic.range_server``); fails
    when one does not come up by the deadline."""
    import os
    procs = []
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for i in range(n):
        log = open(os.path.join(tmp, f"rs{i}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dt_tpu_torch.elastic.range_server",
             "--scheduler-host", "127.0.0.1", "--scheduler-port", str(port),
             "--index", str(i), "--advertise-host", "127.0.0.1"],
            cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT))
    t_end = time.monotonic() + deadline_s
    while len(sched._server_list()) < n:
        dead = [i for i, p in enumerate(procs) if p.poll() is not None]
        if dead or time.monotonic() > t_end:
            _stop_procs(procs)
            raise AssertionError(
                f"range servers {dead or 'timed out'}: " + " | ".join(
                    open(os.path.join(tmp, f"rs{i}.log")).read()[-800:]
                    for i in range(n)))
        time.sleep(0.05)
    return procs


def _stop_procs(procs) -> None:
    """SIGTERM, then kill what is left after 10 s."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)


def _elastic_job(servers: int = 0, armed: Optional[dict] = None):
    """The elastic ResNet-50 job (see :func:`elastic_phase`) against the
    port's ``Scheduler`` in this process, with ``servers`` port
    ``RangeServer`` processes carrying the data plane (0: the scheduler's
    own).  With ``armed`` (phase 18) the job is ``w0`` and ``w1`` alone,
    no operator: ``armed["args"]`` follow ``ELASTIC_ARGS``, ``armed["env"]``
    joins the workers' environment, ``armed["probe"](sched, tmp)`` runs on
    a thread while they train (with ``armed["kill"]`` the workers are
    killed once it returns) and ``armed["final"](sched, tmp)`` before the
    scheduler closes.  Returns ``(results by host, audit, launched,
    wall_s, {"probe": ..., "final": ..., "tmp": ...})``."""
    import os
    import tempfile
    import threading

    import torch_elastic_drift as drift
    from torch_elastic_job import write_hosts

    from dt_tpu_torch.elastic.scheduler import Scheduler
    tmp = tempfile.mkdtemp(prefix="dt_elastic_")
    hw = os.path.join(tmp, "host_worker")
    write_hosts(hw, ["w0", "w1"])
    go = os.path.join(tmp, "go_w2")
    stems = {h: os.path.join(tmp, h) for h in ("w0", "w1", "w2")}
    launched = []

    def operator(epoch):
        if epoch == 1:
            write_hosts(hw, ["w0", "w1", "w2"])
        elif epoch == 2:
            write_hosts(hw, ["w0", "w1"])

    def launch(host, epoch):
        launched.append((host, epoch))
        open(go, "w").close()

    if armed is None:
        sched = Scheduler(host_worker_file=hw, launch_callback=launch,
                          pre_change_hook=operator)
    else:
        sched = Scheduler(host_worker_file=hw)
        del stems["w2"]
    procs, rs, extra = {}, [], {"tmp": tmp}
    t0 = time.monotonic()
    try:
        if servers:
            rs = _range_servers(sched.port, servers, tmp, sched)
        env = {"DT_OBS": "1", "DT_OBS_RING": "65536"}
        if armed is not None:
            env.update({k: v.replace("{tmp}", tmp)
                        for k, v in armed["env"].items()})
            for h in stems:
                procs[h] = drift.spawn(
                    sched.port, h, stems[h], ELASTIC_ARGS + [
                        a.replace("{tmp}", tmp).replace("{host}", h)
                        for a in armed["args"]], env)
            probe = threading.Thread(target=lambda: extra.update(
                probe=armed["probe"](sched, tmp)), daemon=True)
            probe.start()
            if armed.get("kill"):
                # a stalled fleet never ends (and the first SIGTERM only
                # asks for a drain): killed once the probe has its answer
                probe.join(ELASTIC_TIMEOUT)
                for p in procs.values():
                    p.kill()
                    p.wait(timeout=30)
            else:
                drift.wait_all(procs, stems, t0 + ELASTIC_TIMEOUT)
                probe.join(60)
            if probe.is_alive() or "probe" not in extra:
                raise AssertionError("phase 18's probe did not finish: "
                                     + " | ".join(open(stems[h] + ".log")
                                                  .read()[-1500:]
                                                  for h in stems))
            extra["final"] = armed["final"](sched, tmp)
        else:
            for h in ("w0", "w1"):
                procs[h] = drift.spawn(
                    sched.port, h, stems[h],
                    ELASTIC_ARGS + ["--bare-steps", "6", "--profile-epoch",
                                    "2"], env)
            procs["w2"] = drift.spawn(  # no bare steps: w0, w1 still train
                sched.port, "w2", stems["w2"], ELASTIC_ARGS,
                dict(env, NEW_WORKER="1", EPOCH_BEGIN="1", DT_WAIT_FILE=go))
            drift.wait_all(procs, stems, t0 + ELASTIC_TIMEOUT)
    finally:
        _stop_procs(rs + list(procs.values()))
        sched.close()
    wall = time.monotonic() - t0
    r = {h: json.load(open(stems[h] + ".json")) for h in stems
         if os.path.exists(stems[h] + ".json")}
    audit = [ln.split()[1:3] for ln in open(hw + "_log")] \
        if os.path.exists(hw + "_log") else []
    return r, audit, launched, wall, extra


def _elastic_gates(tag, r, audit, launched, wall, gpu):
    """The gates of the elastic job (see :func:`elastic_phase`); returns
    ``(per-epoch {host: sha256}, launches)``."""
    print(f"{tag} audit={audit} launched={launched} wall_s={wall:.1f} "
          f"gpu={gpu}", flush=True)
    if audit != [["ADDED", "w2"], ["REMOVED", "w2"]] or \
            launched != [("w2", 1)]:
        raise AssertionError(f"{tag} audit log {audit}, launched "
                             f"{launched}")
    if r["w2"]["bootstrap_step"] != ELASTIC_STEPS:
        raise AssertionError(f"{tag}: w2 bootstrapped at step "
                             f"{r['w2']['bootstrap_step']}, expected "
                             f"{ELASTIC_STEPS}")
    by_epoch = {}
    for h, res in r.items():
        for e in res["epochs"]:
            by_epoch.setdefault(e["epoch"], {})[h] = e
    want_live = {0: {"w0", "w1"}, 1: {"w0", "w1", "w2"}, 2: {"w0", "w1"}}
    launches = {"bn_stats": 0, "bn_act": 0, "quantize_2bit": 0,
                "dequantize_2bit": 0, **dict.fromkeys(LM_KERNELS, 0),
                "score_bn_act": 0}
    score_want = {"bn_stats": 0, "bn_act": BN_PER_FORWARD *
                  ELASTIC_VAL_FORWARDS}
    shas = {}
    for epoch, live in want_live.items():
        got = by_epoch.get(epoch, {})
        shas[epoch] = {h: got[h]["sha256"] for h in got}
        short = {h: v[:16] for h, v in shas[epoch].items()}
        losses = {h: got[h]["loss"] for h in got}
        print(f"{tag} epoch {epoch} workers={sorted(got)} sha256={short} "
              f"train_ce={losses}", flush=True)
        if set(got) != live or len(set(short.values())) != 1:
            raise AssertionError(f"{tag} epoch {epoch}: live {sorted(got)}, "
                                 f"digests {short}")
        for h, e in got.items():
            n = e["steps"]
            la = e["launches"]
            want = {"bn_stats": BN_PER_FORWARD * n,
                    "bn_act": BN_PER_FORWARD * n, "quantize_2bit": n,
                    "dequantize_2bit": 0, **dict.fromkeys(LM_KERNELS, 0),
                    "grad_bytes": PACKED_BYTES * n}
            got_la = {k: la[k] for k in want}
            if n != ELASTIC_STEPS or got_la != want or \
                    e["score_launches"] != score_want or \
                    not np.isfinite(e["loss"]):
                raise AssertionError(f"{tag} epoch {epoch} {h}: steps {n}, "
                                     f"launches {got_la} want {want}, "
                                     f"score {e['score_launches']} want "
                                     f"{score_want}, loss {e['loss']}")
            for k in want:
                if k in launches:
                    launches[k] += la[k]
            launches["score_bn_act"] += e["score_launches"]["bn_act"]
    return shas, launches


def elastic_phase(gpu) -> dict:
    """The main path of the elastic slice at full width: the port's
    ``Scheduler`` in this process with a host_worker file, two ResNet-50
    workers on ``cuda:0`` (bf16 on f32 params, 2-bit, overlapped step,
    cuDNN's deterministic algorithms, so the ``sharded`` phase can be
    held to it bit for bit);
    the operator adds ``w2`` at the epoch-1 boundary (started beforehand,
    released by the launch callback; it bootstraps from rank 0's
    snapshot) and removes it at the epoch-2 boundary.  Gates: every
    process exits 0, the live workers' sha256 of params, stats and
    optimizer state agree at every epoch end, ``w2`` bootstraps after
    epoch 0 (at step ``ELASTIC_STEPS``), the audit log reads ADDED then
    REMOVED w2, finite losses, per step and worker 53 ``bn_stats``, 53
    ``bn_act``, 1 ``quantize_2bit``, 0 ``dequantize_2bit`` and
    ``PACKED_BYTES`` of packed words, and per epoch and worker a score of
    the validation images through ``fused_bn_inference`` (53 ``bn_act``
    a forward, no ``bn_stats``).  Prints, for each epoch's window (its
    steps after the first) on worker 0's clock, the wall time, ms a step
    and the fleet's images/s, the step's parts from worker 0's spans, the
    bare step, and MB on the wire a step (two or three processes share
    the card)."""
    import tempfile

    from dt_tpu_torch.obs import trace as obs_trace
    # the scheduler here stamps round arrivals with tracing on (DT_OBS on a
    # scheduler), so its straggler board exists without the policy engine
    obs_trace.set_enabled(True)
    try:
        with _RenewalProbe(tempfile.mkdtemp(prefix="dt_probe_")) as probe:
            r, audit, launched, wall, _ = _elastic_job()
    finally:
        obs_trace.set_enabled(None)
    shas, launches = _elastic_gates("elastic", r, audit, launched, wall,
                                    gpu)
    out = _elastic_report("elastic", r, gpu)
    # the board at each epoch's end (what the next barrier would read),
    # no worker straggling: the policy phase's threshold comes from it
    boards = [e["board"] for e in r["w0"]["epochs"]]
    w1 = r["w1"]["epochs"][0]  # phase 18 sets the export's bytes beside it
    out["w1_epoch0_wire_bytes_a_step"] = \
        w1["launches"]["wire_bytes"] / w1["steps"]
    out.update(launches=launches, wall_s=wall, shas=shas,
               renewal=probe.summary(), boards=boards,
               board_max_ms=max((v for b in boards for v in b.values()),
                                default=None))
    print(f"elastic straggler board (round-lag EWMA ms at each epoch's "
          f"end, 4 MiB buckets, no straggler): {json.dumps(boards)} "
          f"worst={out['board_max_ms']}; gpu={gpu}", flush=True)
    return out


def _elastic_report(tag, r, gpu) -> dict:
    """Worker 0's windows and the step's parts of one elastic job."""
    want_live = {0: {"w0", "w1"}, 1: {"w0", "w1", "w2"}, 2: {"w0", "w1"}}
    w0 = r["w0"]
    spans = w0["spans"]
    k = ELASTIC_STEPS
    buckets = len(spans["pipeline.d2h"]) // max(len(spans["step"]), 1)
    if len(spans["step"]) != 3 * k or \
            len(spans["pipeline.d2h"]) != 3 * k * buckets:
        raise AssertionError(f"worker 0 recorded {len(spans['step'])} "
                             f"steps, {len(spans['pipeline.d2h'])} bucket "
                             f"copies; expected {3 * k} steps")
    windows = []
    for epoch, live in want_live.items():
        # the epoch's steps after its first (which carries the warm-up,
        # a joiner's first step or the first step after a removal)
        lo, hi = epoch * k + 1, epoch * k + k
        span = spans["step_start"][hi - 1] + spans["step"][hi - 1] - \
            spans["step_start"][lo]
        windows.append({"epoch": epoch, "workers": len(live),
                        "steps": hi - lo, "wall_ms": span,
                        "ms_a_step": span / (hi - lo),
                        "images_s": 64 * (hi - lo) / span * 1e3,
                        "step_ms": spans["step"][lo:hi]})
    # the parts, over epoch 0's window (two workers, not profiled)
    parts = {}
    for name in ("step.grad", "step.apply"):
        parts[name] = float(np.median(spans[name][1:k]))
    for name in ("pipeline.d2h", "pipeline.wire", "pipeline.h2d"):
        parts[name] = float(np.median(spans[name][buckets:k * buckets]))
    bare = float(np.median(w0["bare_step_ms"][1:]))
    last = w0["epochs"][-1]  # epoch 2, under torch.profiler
    busy, idle = last.get("device_busy_ms"), last.get("idle_share")
    # rank 1 publishes no snapshot: its frames are the step's own (the
    # packed words, the stats, barriers and heartbeats), up and down
    w1 = r["w1"]["epochs"]
    wire_mb = sum(e["launches"]["wire_bytes"] for e in w1) / \
        sum(e["steps"] for e in w1) / 1e6
    recv_mb = sum(e["launches"]["wire_recv_bytes"] for e in w1) / \
        sum(e["steps"] for e in w1) / 1e6
    out = {"step_ms": windows[0]["ms_a_step"], "windows": windows,
           "parts_ms": parts, "buckets_a_step": buckets,
           "bare_step_ms": bare, "wire_mb_a_step": wire_mb,
           "wire_recv_mb_a_step": recv_mb,
           "packed_mb_a_step": PACKED_BYTES / 1e6,
           "dense_mb_a_step": 4 * RESNET50_PARAMS / 1e6,
           "epoch2_device_busy_ms": busy, "epoch2_idle_share": idle,
           "epoch2_wall_ms": last["seconds"] * 1e3}
    for w in windows:
        print(f"{tag} resnet50 bf16 2-bit overlap window: epoch "
              f"{w['epoch']} workers={w['workers']} steps={w['steps']} "
              f"wall_ms={w['wall_ms']:.3f} ms_a_step={w['ms_a_step']:.3f} "
              f"fleet_images_s={w['images_s']:.2f} step_ms="
              f"{json.dumps([round(t, 3) for t in w['step_ms']])} (worker "
              f"0's clock; {w['workers']} processes share one card"
              f"{', profiled' if w['epoch'] == 2 else ''}); gpu={gpu}",
              flush=True)
    print(f"{tag} resnet50 bf16 2-bit overlap: parts_ms (epoch 0 window, "
          f"median each; d2h/wire/h2d per bucket, {buckets} buckets a "
          f"step)={json.dumps(parts)} bare_train_step_ms={bare:.3f} "
          f"w1_wire_mb_a_step sent={wire_mb:.3f} received={recv_mb:.3f} "
          f"packed_mb_a_step="
          f"{PACKED_BYTES / 1e6:.3f} (dense {4 * RESNET50_PARAMS / 1e6:.3f}) "
          f"epoch2 (profiled, worker 0): "
          f"wall_ms={last['seconds'] * 1e3:.1f} device_busy_ms={busy} "
          f"idle_share={idle}; gpu={gpu}", flush=True)
    return out


def sharded_phase(gpu, funnel: dict) -> dict:
    """The elastic job again, its data plane on ``SHARDED_SERVERS`` port
    ``RangeServer`` processes (dense and 2-bit chunks round-robin across
    them).  Gates: the elastic phase's, and every worker's sha256 of
    params, stats and optimizer state at every epoch end equal to the
    single-funnel job's (the same seeds, cuDNN deterministic).  Prints its
    windows and parts beside the funnel's; claims no gain."""
    r, audit, launched, wall, _ = _elastic_job(servers=SHARDED_SERVERS)
    shas, launches = _elastic_gates("sharded", r, audit, launched, wall,
                                    gpu)
    if shas != funnel["shas"]:
        raise AssertionError(f"sharded against single-funnel: {shas} != "
                             f"{funnel['shas']}")
    out = _elastic_report("sharded", r, gpu)
    print(f"sharded vs funnel ({SHARDED_SERVERS} range servers): "
          f"bit_identical=True ms_a_step "
          f"{[round(w['ms_a_step'], 3) for w in out['windows']]} vs "
          f"{[round(w['ms_a_step'], 3) for w in funnel['windows']]}; "
          f"pipeline.wire ms a bucket {out['parts_ms']['pipeline.wire']:.3f}"
          f" vs {funnel['parts_ms']['pipeline.wire']:.3f}; gpu={gpu}",
          flush=True)
    out.update(launches=launches, wall_s=wall)
    return out


class _PushLog:
    """An audit of the ``dist_async`` pushes a port ``Scheduler`` applies,
    installed from outside (:meth:`install`): the order (host, seq), each
    gradient's digest, the update's ms; copies of the first ``keep``
    gradients, of the master before the first push and after the
    ``keep``-th, to replay them.  The copies are made under the plane's
    lock; the digests are taken from them on a thread of their own."""

    def __init__(self, keep: int):
        import queue
        import threading
        self.keep = keep
        self.order, self.ms, self.grads = [], [], []
        self.digests, self.masters = [], []
        self.before = self.after = None
        self._who = threading.local()
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._digest, daemon=True)
        self._thread.start()

    def install(self, sched) -> None:
        """Wrap the scheduler's plane: its ``async_push`` notes who pushes
        (on the handler's thread), and the updater ``set_optimizer``
        installs is timed and logged (called under the plane's lock, so
        the log's order is the order of application)."""
        dp = sched._dp
        push, set_opt = dp.async_push, dp.async_set_optimizer
        log = self

        class Timed:
            def __init__(self, upd):
                self.upd = upd

            def __getattr__(self, name):  # spec_input, sparse
                return getattr(self.upd, name)

            def __call__(self, key, grad, stored):
                t0 = time.perf_counter()
                new = self.upd(key, grad, stored)
                log._applied(grad, stored, new,
                             (time.perf_counter() - t0) * 1e3)
                return new

        def async_push(host, key, value, seq=-1):
            log._who.pushed = (host, int(seq))
            return push(host, key, value, seq)

        def async_set_optimizer(spec):
            out = set_opt(spec)
            with dp._async_lock:
                if dp._async_updater is not None and \
                        not isinstance(dp._async_updater, Timed):
                    dp._async_updater = Timed(dp._async_updater)
            return out

        dp.async_push = async_push
        dp.async_set_optimizer = async_set_optimizer

    def _applied(self, grad, before, after, ms):
        n = len(self.order)
        self.order.append(self._who.pushed)
        self.ms.append(ms)
        grad, after = np.array(grad), np.array(after)
        if n == 0:
            self.before = np.array(before)
        if n < self.keep:
            self.grads.append(grad)
        if n + 1 == self.keep:
            self.after = after
        self._q.put((grad, after))

    def _digest(self):
        import hashlib
        while True:
            item = self._q.get()
            if item is None:
                return
            grad, after = item
            self.digests.append(hashlib.blake2b(
                memoryview(grad).cast("B"), digest_size=16).hexdigest())
            self.masters.append(hashlib.sha256(memoryview(after).cast("B"))
                                .hexdigest())

    def close(self, timeout: float = 120.0) -> None:
        self._q.put(None)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise AssertionError("push-log digests did not finish")


def async_phase(gpu) -> dict:
    """The ``dist_async`` path at full width: ResNet-50 v1 bf16 on f32
    params through ``Module.fit(kvstore="dist_async")``, two workers of
    ``tests/torch_elastic_worker.py`` on the card at batch 32 each, the
    port's ``Scheduler`` in this process with the server-side sgd
    (``ASYNC_SGD``), 2 epochs of ``ELASTIC_STEPS`` steps; the operator adds
    ``w2`` at the epoch-1 boundary, which adopts the live master.  ``w0``
    and ``w2`` record their steps ``ASYNC_RECORD`` (``tests/
    torch_elastic_drift.py``).  Gates: every process exits 0; per worker
    and step 53 ``bn_stats`` and 53 ``bn_act`` (``fused_bn_train``), no
    codec launch, 53 ``bn_act`` a scored batch (``fused_bn_inference``);
    the scheduler's applied pushes equal the steps the workers took (none
    lost or applied twice); its first ``ASYNC_KEEP`` pushes, applied again
    in the logged order by the port's ``NpUpdater`` on the CPU from the
    seeded master, give its master after push ``ASYNC_KEEP`` bit for bit;
    every worker's first params equal the master it was served, the
    joiner's one the scheduler applied; the recorded steps replay on the
    CPU (:func:`_async_replay`).  Also times ``NpUpdater`` alone on this
    host at the same size (:func:`_server_update_alone`)."""
    import hashlib
    import os
    import tempfile

    import torch_elastic_drift as drift
    from torch_elastic_job import write_hosts

    from dt_tpu_torch.elastic import server_optim
    from dt_tpu_torch.elastic.scheduler import Scheduler
    tmp = tempfile.mkdtemp(prefix="dt_async_")
    hw = os.path.join(tmp, "host_worker")
    write_hosts(hw, ["w0", "w1"])
    go = os.path.join(tmp, "go_w2")
    stems = {h: os.path.join(tmp, h) for h in ("w0", "w1", "w2")}
    launched = []

    def operator(epoch):
        if epoch == 1:
            write_hosts(hw, ["w0", "w1", "w2"])

    def launch(host, epoch):
        launched.append((host, epoch))
        open(go, "w").close()

    sched = Scheduler(host_worker_file=hw, launch_callback=launch,
                      pre_change_hook=operator)
    log = _PushLog(ASYNC_KEEP)
    log.install(sched)
    args = ASYNC_ARGS
    procs = {}
    t0 = time.monotonic()
    try:
        env = {"DT_OBS": "1", "DT_OBS_RING": "65536"}
        for h in ("w0", "w1"):
            procs[h] = drift.spawn(sched.port, h, stems[h], args, env,
                                   dump=h in ASYNC_RECORD,
                                   steps=ASYNC_RECORD.get(h))
        procs["w2"] = drift.spawn(
            sched.port, "w2", stems["w2"], args,
            dict(env, NEW_WORKER="1", EPOCH_BEGIN="1", DT_WAIT_FILE=go),
            dump=True, steps=ASYNC_RECORD["w2"])
        drift.wait_all(procs, stems, t0 + ELASTIC_TIMEOUT)
        stale = sched._dp.async_stats()
        master = np.array(sched._async_store["params"])
    finally:
        sched.close()
    wall = time.monotonic() - t0
    log.close()
    r, dumps = {}, {}
    for h in stems:
        r[h], dump = drift.load(stems[h], dump=h in ASYNC_RECORD)
        if h in ASYNC_RECORD:
            dumps[h] = dump
    steps = {h: sum(e["steps"] for e in r[h]["epochs"]) for h in r}
    pushes = {h: sum(1 for hh, _ in log.order if hh == h) for h in r}
    print(f"async launched={launched} steps={steps} applied={pushes} "
          f"wall_s={wall:.1f} staleness={json.dumps(stale)} gpu={gpu}",
          flush=True)
    if launched != [("w2", 1)] or pushes != steps or \
            steps != {"w0": 2 * ELASTIC_STEPS, "w1": 2 * ELASTIC_STEPS,
                      "w2": ELASTIC_STEPS}:
        raise AssertionError(f"async: launched {launched}, steps {steps}, "
                             f"applied {pushes}")
    if sorted(log.order) != sorted(set(log.order)) or \
            len(log.digests) != len(log.order):
        raise AssertionError("async: a push applied twice")
    for h in r:
        seqs = [q for hh, q in log.order if hh == h]
        if seqs != list(range(len(seqs))):
            raise AssertionError(f"async: {h} applied seqs {seqs}")
    # the first ASYNC_KEEP pushes again, in the logged order, on the CPU
    upd = server_optim.create(**ASYNC_SGD)
    w = np.array(log.before)
    for g in log.grads:
        w = upd("params", g, w)
    replay_ok = w.tobytes() == log.after.tobytes()
    print(f"async replay of the first {ASYNC_KEEP} pushes in order "
          f"{log.order[:ASYNC_KEEP]} with the port's NpUpdater on the CPU: "
          f"bit_identical={replay_ok} grad digests "
          f"{log.digests[:ASYNC_KEEP]}", flush=True)
    if not replay_ok:
        raise AssertionError("async: the replayed master differs")
    seeded = hashlib.sha256(log.before.tobytes()).hexdigest()
    served_ok = {}
    for h, res in r.items():
        att = res["attach"]
        served_ok[h] = att["served_sha256"] == att["first_params_sha256"] \
            and att["served_sha256"] in [seeded] + log.masters
    w2_served = r["w2"]["attach"]["served_sha256"]
    w2_push = log.masters.index(w2_served) + 1 \
        if w2_served in log.masters else None
    print(f"async first params equal the master served: {served_ok} "
          f"(w2: master after push {w2_push} of {len(log.order)})",
          flush=True)
    if not all(served_ok.values()) or w2_served == seeded:
        raise AssertionError(f"async: served masters {served_ok}")
    launches = {"bn_stats": 0, "bn_act": 0, "score_bn_act": 0,
                "quantize_2bit": 0, "dequantize_2bit": 0}
    for h, res in r.items():
        for e in res["epochs"]:
            n = e["steps"]
            la = e["launches"]
            want = {"bn_stats": BN_PER_FORWARD * n,
                    "bn_act": BN_PER_FORWARD * n, "quantize_2bit": 0,
                    "dequantize_2bit": 0}
            got = {k: la[k] for k in want}
            sc = e["score_launches"]
            if n != ELASTIC_STEPS or got != want or sc != {
                    "bn_stats": 0,
                    "bn_act": BN_PER_FORWARD * ELASTIC_VAL_FORWARDS} or \
                    not np.isfinite(e["loss"]):
                raise AssertionError(f"async epoch {e['epoch']} {h}: "
                                     f"steps {n} launches {got} want {want} "
                                     f"score {sc} loss {e['loss']}")
            for k in want:
                launches[k] += la[k]
            launches["score_bn_act"] += sc["bn_act"]
        print(f"async {h} epochs "
              f"{[(e['epoch'], e['num_workers'], e['loss']) for e in res['epochs']]}",
              flush=True)
    if not np.isfinite(master).all():
        raise AssertionError("async: the master is not finite")
    spans = r["w0"]["spans"]
    parts = {k: float(np.median(spans[k][1:])) for k in
             ("step", "step.grad", "step.push", "step.h2d")}
    w1 = r["w1"]["epochs"]
    n1 = sum(e["steps"] for e in w1)
    up = sum(e["launches"]["wire_bytes"] for e in w1) / n1 / 1e6
    down = sum(e["launches"]["wire_recv_bytes"] for e in w1) / n1 / 1e6
    upd_ms = float(np.median(log.ms))
    print(f"async resnet50 bf16 dist_async: step_ms (worker 0, median of "
          f"its steps after the first)={json.dumps(parts)} "
          f"server_update_ms_a_push={upd_ms:.3f} (median of {len(log.ms)}, "
          f"the updater call alone, in the job) "
          f"staleness max={stale['max_staleness']} "
          f"mean={stale['mean_staleness']:.3f} over "
          f"{stale['measured_pushes']} w1_mb_a_push up={up:.3f} "
          f"down={down:.3f} (2-3 processes share one card; 0-based "
          f"steps {ASYNC_RECORD} recorded); gpu={gpu}",
          flush=True)
    alone = _server_update_alone(log, gpu)
    replayed = _async_replay(dumps, log, gpu)
    return {"launches": launches, "parts_ms": parts,
            "server_update_ms": upd_ms, "server_update_alone": alone,
            "staleness": stale, "mb_a_push": (up, down),
            "pushes": len(log.order), "wall_s": wall, "replay": replayed}


def _async_replay(dumps, log, gpu) -> dict:
    """The async job's recorded steps again on the CPU, each from the
    weights its worker adopted (a master the scheduler answered), in bf16
    as on the card: the loss and the post-forward BN stats within
    ``TOL_ASYNC_BF16``, the gradient within its ``grad`` limit or, where
    it misses that, within twice what bf16 alone moves that step's
    gradient on the CPU (the CPU's bf16 gradient against its f32 one, from
    the same state): two bf16 implementations each that far from f32.
    Early in the job a step's bf16 gradient can be undetermined at that
    level (the stem's weight gradient, a large cancelling sum).  Each
    reading is printed beside the control, the card's gradient of one
    recorded step against the CPU's of another (what a gradient from the
    wrong weights or batch gives); every recording worker needs a step whose
    gradient limit lies below every control."""
    import hashlib

    import torch_elastic_drift as drift
    t0 = time.monotonic()
    answered = set(log.masters)
    adopted = {(h, k): hashlib.sha256(memoryview(np.ascontiguousarray(
        d[f"p{k}"], np.float32)).cast("B")).hexdigest() in answered
        for h, d in dumps.items() for k in d["recorded"] if k > 0}
    model = ASYNC_ARGS[ASYNC_ARGS.index("--model") + 1]
    cpu_g = {}
    rows, failures = drift.replay(
        dumps, dict(TOL_ASYNC_BF16, grad=float("inf")), host_sync=False,
        model=model, dtype=ASYNC_ARGS[ASYNC_ARGS.index("--dtype") + 1],
        grads_out=cpu_g)
    # bf16 against f32 on the CPU, for the steps over the fixed limit
    over = {(r["host"], r["step"] - 1) for r in rows
            if not r["grad"] <= TOL_ASYNC_BF16["grad"]}
    f32_g = {}
    if over:
        drift.replay({h: dict(d, recorded=[k for k in d["recorded"]
                                           if (h, k) in over])
                      for h, d in dumps.items()}, float("inf"),
                     host_sync=False, model=model, dtype="float32",
                     grads_out=f32_g)
    keys = sorted(cpu_g)
    # the worker's function again: each step on this process's card from
    # its recorded state, in bf16 and (over the fixed limit) in f32
    again = _card_grads(dumps, model, "bfloat16", keys)
    again32 = _card_grads(dumps, model, "float32", sorted(f32_g))

    def rel32(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    cross = {f"{a[0]}/{a[1] + 1} vs {b[0]}/{b[1] + 1}":
             rel32(dumps[a[0]][f"g{a[1]}"], cpu_g[b])
             for a in keys for b in keys if a != b}
    floor = min(cross.values())
    loss = {(row["host"], row["step"] - 1): row["cpu_loss"] for row in rows}
    cross_loss = min(abs(float(dumps[a[0]][f"loss{a[1]}"]) - loss[b]) /
                     abs(loss[b]) for a in keys for b in keys if a != b)
    separating = set()
    for row in rows:
        key = (row["host"], row["step"] - 1)
        row["bf16_vs_f32_cpu"] = rel32(cpu_g[key], f32_g[key]) \
            if key in f32_g else None
        row["grad_limit"] = TOL_ASYNC_BF16["grad"] if key not in f32_g \
            else max(TOL_ASYNC_BF16["grad"], 2 * row["bf16_vs_f32_cpu"])
        row["card_again_bitwise"] = bool(np.array_equal(
            again[key], dumps[key[0]][f"g{key[1]}"]))
        row["f32_card_vs_cpu"] = rel32(again32[key], f32_g[key]) \
            if key in f32_g else None
        if not row["grad"] <= row["grad_limit"]:
            failures.append(f"step {row['step']} {row['host']}: grad "
                            f"{row['grad']} over {row['grad_limit']}")
        if row["grad_limit"] < floor:
            separating.add(row["host"])
        print("async replay bf16 " + json.dumps(
            {k: row[k] for k in ("host", "step", "relu_flips", "cpu_loss",
                                 "loss", "stats", "grad", "bf16_vs_f32_cpu",
                                 "grad_limit", "card_again_bitwise",
                                 "f32_card_vs_cpu")}), flush=True)
    worst = {k: max(row[k] for row in rows) for k in ("loss", "stats",
                                                      "grad")}
    print(f"async card-vs-cpu bf16 {model} batch 32: {len(rows)} "
          f"recorded steps replayed, worst (rel) {json.dumps(worst)} limits "
          f"{json.dumps(TOL_ASYNC_BF16)}; control (card grad of one step "
          f"against the CPU's of another) min {floor:.4e} over "
          f"{len(cross)} pairs {json.dumps(cross)}, loss control min "
          f"{cross_loss:.4e}; workers with a separating step "
          f"{sorted(separating)}; adopted masters answered "
          f"{all(adopted.values())} ({len(adopted)}) wall_s="
          f"{time.monotonic() - t0:.1f} gpu={gpu}", flush=True)
    want_rows = sum(len(d["recorded"]) for d in dumps.values())
    if failures or len(rows) != want_rows or \
            not all(adopted.values()) or separating != set(dumps):
        raise AssertionError(f"async bf16 replay: {failures}, {len(rows)} "
                             f"rows, adopted {adopted}, separating "
                             f"{separating}")
    return {"worst": worst, "control_grad_min": floor,
            "control_loss_min": cross_loss,
            "rows": [{k: row[k] for k in ("host", "step", "relu_flips",
                                          "loss", "stats", "grad",
                                          "bf16_vs_f32_cpu", "grad_limit",
                                          "card_again_bitwise",
                                          "f32_card_vs_cpu")}
                     for row in rows]}


def _card_grads(dumps, model, dtype, keys) -> dict:
    """The gradient of each recorded ``(host, step)`` in ``keys`` on this
    process's card (the CPU without one), from the recorded params, BN
    stats and batch, in ``dtype``: ``{key: flat f32 numpy}``."""
    import torch

    from dt_tpu_torch import models
    from dt_tpu_torch.training.module import Module
    from dt_tpu_torch.training.step import grad_step
    if not keys:
        return {}
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    mod = Module(models.create(model, device=dev, dtype=getattr(torch, dtype),
                               num_classes=10 if model == "resnet20" else
                               1000), optimizer="sgd",
                 optimizer_params={
                     "learning_rate": ASYNC_SGD["learning_rate"]},
                 device=dev, seed=7)
    mod.init_params()
    st = mod.state
    out = {}
    for h, k in keys:
        d = dumps[h]
        with torch.no_grad():
            for tree, rec, leaves in ((st.params, "p", st.layout.params),
                                      (st.batch_stats, "st",
                                       st.layout.stats)):
                for name, t in leaves.unravel(
                        torch.from_numpy(d[f"{rec}{k}"])).items():
                    tree[name].copy_(t)
        x = torch.from_numpy(d[f"x{k}"]).to(dev, mod._dtype).contiguous(
            memory_format=torch.channels_last)
        g = grad_step(st, x, torch.from_numpy(d[f"y{k}"]).to(dev),
                      mod._forward_loss)[0]
        out[h, k] = g.float().cpu().numpy()
    return out


def _server_update_alone(log, gpu, n: int = 6) -> dict:
    """The server's sgd update (``ASYNC_SGD``, the port's ``NpUpdater``)
    of the ResNet-50 master timed alone on this host after the job, with
    no worker, handler or audit running: ``n`` updates from the seeded
    master with the job's first gradients, median of all but the first
    (which allocates the momentum slot)."""
    from dt_tpu_torch.elastic import server_optim
    upd = server_optim.create(**ASYNC_SGD)
    w = log.before
    ms = []
    for i in range(n):
        t0 = time.perf_counter()
        w = upd("params", log.grads[i % len(log.grads)], w)
        ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ms[1:]))
    print(f"async server update alone (NpUpdater sgd momentum wd, "
          f"{w.size} f32, this host, nothing else running): median "
          f"{med:.3f} ms of {json.dumps([round(t, 3) for t in ms])}; in "
          f"the job {float(np.median(log.ms)):.3f}; gpu={gpu}", flush=True)
    return {"median_ms": med, "ms": ms}


class _RenewalProbe:
    """What a lease renewal does, on a thread of this process while a job
    runs: sleep one renewal period (a third of the default lease), then
    write, fsync and rename a small file.  ``max_delay_s`` is the worst
    lateness of a renewal past its period, the slack a lease must leave a
    starved renewal thread."""

    def __init__(self, tmp: str, period: float = LEASE_MIN_S / 3.0):
        import os
        import threading
        self.path = os.path.join(tmp, "renewal.probe")
        self.period = period
        self.delays = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        import os
        while True:
            t0 = time.monotonic()
            if self._stop.wait(self.period):
                return
            with open(self.path + ".tmp", "w") as f:
                f.write(str(time.time()))
                f.flush()
                os.fsync(f.fileno())
            os.replace(self.path + ".tmp", self.path)
            self.delays.append(time.monotonic() - t0 - self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)

    def summary(self) -> dict:
        return {"renewals": len(self.delays),
                "max_delay_s": max(self.delays, default=0.0),
                "median_delay_s": float(np.median(self.delays))
                if self.delays else 0.0}


def _leader_status(ports):
    """The ``status`` of whichever scheduler endpoint leads, else None."""
    from dt_tpu_torch.elastic import protocol
    for port in ports:
        try:
            st = protocol.request("127.0.0.1", port, {"cmd": "status"},
                                  timeout=5)
        except (OSError, RuntimeError):
            continue
        if st.get("active"):
            return st
    return None


def _check_alive(procs, stems):
    """Raise with the log's tail when a worker exited before its job
    ended (the operator loops of the HA phases)."""
    for h, p in procs.items():
        if p.poll() is not None:
            raise AssertionError(f"{h} exited rc={p.returncode} before the "
                                 f"job ended:\n"
                                 f"{open(stems[h] + '.log').read()[-3000:]}")


def failover_phase(gpu, elastic: dict) -> dict:
    """Phase 11's job (the same args, seeds and operator) under an HA pair
    of port ``scheduler_main`` processes: the primary with ``--journal``,
    ``--lease`` and ``--peer`` (completed rounds replicated to the
    standby), a ``--standby`` process tailing the same journal, the
    workers given both through ``DT_CTRL_ENDPOINTS``.  The operator (this
    process, polling the leader's ``status``) lists ``w2`` after the
    epoch-0 barrier, releases it once the epoch-1 barrier added it, and
    unlists it after that barrier; the primary is SIGKILLed once worker 0
    reported step ``FAILOVER_KILL_STEP`` (the third of the 3-worker
    epoch).  Gates: every worker exits 0; every live worker's sha256 at
    every epoch end equals phase 11's; exactly one ``leader.elected`` on
    the standby, under the primary's incarnation + 1 (the fence the
    workers end under is printed: a request the successor took over for
    answers without a reattach); the audit log holds phase 11's rows;
    phase 11's launch counts.  Prints the ``scheduler.failover`` span, the
    stall on worker 0's clock (:func:`_failover_stall`; beside it the kill
    epoch's longest step and median), the workers' ``client.failover``
    counts and the lease with the renewal delay it was chosen from."""
    import math
    import os
    import signal
    import tempfile

    import torch_elastic_drift as drift
    from torch_elastic_job import (read_step, start_scheduler,
                                   stop_scheduler, write_hosts)

    from dt_tpu_torch.elastic import protocol
    probe = elastic["renewal"]
    lease_s = max(LEASE_MIN_S,
                  math.ceil(3.0 * probe["max_delay_s"] * 2.0) / 2.0)
    print(f"failover lease_s={lease_s} (renewal delay under phase 11's "
          f"load: max {probe['max_delay_s'] * 1e3:.3f} ms, median "
          f"{probe['median_delay_s'] * 1e3:.3f} ms over "
          f"{probe['renewals']} renewals of period "
          f"{LEASE_MIN_S / 3.0:.3f} s); gpu={gpu}", flush=True)
    tmp = tempfile.mkdtemp(prefix="dt_failover_")
    hw = os.path.join(tmp, "host_worker")
    write_hosts(hw, ["w0", "w1"])
    common = ["--journal", os.path.join(tmp, "ctrl.journal"),
              "--host-worker-file", hw, "--lease-s", str(lease_s)]
    go = os.path.join(tmp, "go_w2")
    progress = os.path.join(tmp, "w0.progress")
    stems = {h: os.path.join(tmp, h) for h in ("w0", "w1", "w2")}
    sb, sb_port = start_scheduler(
        tmp, "standby", ["--standby"] + common, env={"DT_OBS": "1"})
    pr, pr_port, procs = None, None, {}
    launched, kill = [], {}
    t0 = time.monotonic()
    try:
        pr, pr_port = start_scheduler(
            tmp, "primary", ["--peer", f"127.0.0.1:{sb_port}"] + common,
            env={"DT_OBS": "1"})
        inc0 = protocol.request("127.0.0.1", pr_port, {"cmd": "status"},
                                timeout=10)["incarnation"]
        env = {"DT_OBS": "1", "DT_OBS_RING": "65536",
               "DT_CTRL_ENDPOINTS": f"127.0.0.1:{pr_port},"
                                    f"127.0.0.1:{sb_port}"}
        for h in ("w0", "w1"):
            procs[h] = drift.spawn(
                pr_port, h, stems[h], ELASTIC_ARGS +
                (["--progress", progress] if h == "w0" else []), env)
        procs["w2"] = drift.spawn(
            pr_port, "w2", stems["w2"], ELASTIC_ARGS,
            dict(env, NEW_WORKER="1", EPOCH_BEGIN="1", DT_WAIT_FILE=go))
        deadline = t0 + ELASTIC_TIMEOUT
        listed = unlisted = False
        while not (unlisted and kill):  # the operator
            _check_alive(procs, stems)
            if time.monotonic() > deadline:
                raise AssertionError("failover: the operator timed out "
                                     f"(listed {listed}, unlisted "
                                     f"{unlisted}, killed {bool(kill)})")
            st = _leader_status((pr_port, sb_port))
            if st is not None:
                done = st["last_completed_epoch"]
                if not listed and done >= 0:
                    write_hosts(hw, ["w0", "w1", "w2"])
                    listed = True
                if listed and not launched and "w2" in st["workers"]:
                    launched.append(("w2", done))
                    open(go, "w").close()
                if listed and not unlisted and done >= 1:
                    write_hosts(hw, ["w0", "w1"])
                    unlisted = True
            step = read_step(progress)
            if not kill and step >= FAILOVER_KILL_STEP:
                pr.send_signal(signal.SIGKILL)
                kill = {"w0_step": step, "t": time.monotonic() - t0,
                        "wall_ms": time.time() * 1e3}
                pr.wait(timeout=30)
            time.sleep(0.005)
        drift.wait_all(procs, stems, deadline)
        # the standby's control-plane records and incarnation
        tr = protocol.request("127.0.0.1", sb_port, {"cmd": "obs_dump"},
                              timeout=30)["job"]["tracks"]["control-plane"]
        sb_inc = protocol.request("127.0.0.1", sb_port, {"cmd": "status"},
                                  timeout=30)["incarnation"]
    except BaseException:
        # what each process said, for the failure's cause: the schedulers'
        # logs hold a stuck round's waiters and seqs (DataPlane._stuck_locked)
        for name in ("primary", "standby", *stems):
            path = os.path.join(tmp, f"{name}.log")
            if os.path.exists(path):
                with open(path) as f:
                    print(f"failover: {name} log tail:\n{f.read()[-3000:]}",
                          flush=True)
        raise
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        if pr is not None:
            stop_scheduler(pr, pr_port)
        stop_scheduler(sb, sb_port)
    wall = time.monotonic() - t0
    r = {h: json.load(open(stems[h] + ".json")) for h in stems}
    audit = [ln.split()[1:3] for ln in open(hw + "_log")]
    shas, launches = _elastic_gates("failover", r, audit, launched, wall,
                                    gpu)
    if shas != elastic["shas"]:
        raise AssertionError(f"failover: sha256 by epoch {shas} differ from "
                             f"phase 11's {elastic['shas']}")
    elected = [rec[8] for rec in tr["records"] if rec[2] == "leader.elected"]
    spans = [rec for rec in tr["records"]
             if rec[0] == "X" and rec[2] == "scheduler.failover"]
    fences = {h: r[h]["fence"] for h in ("w0", "w1", "w2")}
    if [e["incarnation"] for e in elected] != [inc0 + 1] or \
            len(spans) != 1 or sb_inc != inc0 + 1:
        raise AssertionError(f"failover: leader.elected {elected}, "
                             f"{len(spans)} failover spans, standby "
                             f"incarnation {sb_inc} (primary {inc0}), "
                             f"fences {fences}")
    stall = _failover_stall(r["w0"]["spans"], kill["wall_ms"])
    failovers = {h: r[h]["failovers"] for h in r}
    span_ms = spans[0][4] / 1e3
    print(f"failover killed the primary at w0 step {kill['w0_step']} "
          f"({kill['t']:.3f} s in); standby incarnation {inc0} -> "
          f"{sb_inc}, leader.elected {elected}; "
          f"scheduler.failover span {span_ms:.3f} ms; client.failover "
          f"{failovers}; fences {fences}; audit {audit}; sha256 by epoch "
          f"equal to phase 11's; wall_s={wall:.1f} gpu={gpu}", flush=True)
    print(f"failover stall on worker 0's clock: the kill landed in global "
          f"step {stall['kill_step']} (0-based); the longest of it and the "
          f"next {stall['stall_step_ms']:.3f} ms against the median "
          f"{stall['median_step_ms']:.3f} ms of epoch 1's other steps after "
          f"its first (w2's bootstrap): stall {stall['stall_ms']:.3f} ms; "
          f"the epoch's longest step is step {stall['longest_step']}, its "
          f"median {stall['epoch_median_ms']:.3f} ms; "
          f"epoch 1 steps by global step "
          f"{json.dumps(stall['step_ms'])}; lease_s={lease_s}; gpu={gpu}",
          flush=True)
    return {"launches": launches, "failover_span_ms": span_ms,
            "stall": stall, "client_failovers": failovers,
            "lease_s": lease_s, "renewal": probe, "wall_s": wall}


def _failover_stall(spans, kill_ms) -> dict:
    """The failover's stall on a worker's clock: the step the kill landed
    in (the last to start before it) and the next one (the kill may land
    after the step's last request) against the median of epoch 1's other
    steps after its first (the joiner's bootstrap step, which the
    elastic windows leave out too)."""
    start, step = spans["step_start"], spans["step"]
    k = max(i for i, t in enumerate(start) if t <= kill_ms)
    window = range(ELASTIC_STEPS + 1, 2 * ELASTIC_STEPS)
    if k not in window:
        raise AssertionError(f"failover: the kill landed in step {k}, "
                             f"outside epoch 1's window {list(window)}")
    hit = [i for i in (k, k + 1) if i in window]
    rest = [step[i] for i in window if i not in hit]
    worst = max(step[i] for i in hit)
    med = float(np.median(rest))
    epoch = range(ELASTIC_STEPS, 2 * ELASTIC_STEPS)
    longest = max(epoch, key=lambda i: step[i])
    return {"kill_step": k, "stall_step_ms": worst, "median_step_ms": med,
            "stall_ms": worst - med, "longest_step": longest,
            "epoch_median_ms": float(np.median([step[i] for i in epoch])),
            "step_ms": {i: round(step[i], 3)
                        for i in range(ELASTIC_STEPS, 2 * ELASTIC_STEPS)}}


def _nvidia_pids() -> set:
    """The pids ``nvidia-smi`` lists with a compute context."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout
    return {int(t) for t in out.split() if t.strip().isdigit()}


def outage_phase(gpu) -> dict:
    """The dense job (``OUTAGE_ARGS``: ResNet-50 v1 bf16, 2 workers x 32
    images, 2 epochs of ``ELASTIC_STEPS`` steps, no 2-bit leg: the
    residual is not part of a checkpoint) with a fleet checkpoint every
    ``OUTAGE_EVERY`` steps, against a journaled port ``scheduler_main``
    process, three times: (a) never killed, beside (b) on the card (two
    jobs, four workers); (b) a stall rule holds every
    worker before its 14th step, and once the step-12 window committed
    (``ckpt_manifest``) every worker and the scheduler are SIGKILLed,
    reaped, and gone from ``nvidia-smi``'s compute apps; (c) ``--resume``
    on (b)'s journal and fresh workers with ``DT_RESUME=1``.  Gates: (b)'s
    commit is step 12 exactly; every worker of (c) reports
    ``resumed_from_step`` 12 and its final sha256 equals (a)'s bit for
    bit; each worker's blob digest equals its journaled sha256; (c)'s
    resumed steps launch 53 + 53 BN-train kernels a step and no codec.
    Prints the checkpointed steps' time (start to next start, the save's
    cost on the step path) against their epoch's median step, the
    ``ckpt.save`` spans, the blob bytes, and the resume time from the
    scheduler's start to the first resumed step."""
    import hashlib
    import os
    import shutil
    import signal
    import tempfile

    import torch_elastic_drift as drift
    from torch_elastic_job import (start_scheduler, stop_scheduler,
                                   write_hosts)

    from dt_tpu_torch.elastic import protocol
    tmp = tempfile.mkdtemp(prefix="dt_outage_")
    hosts = ("w0", "w1")

    def start(tag, journal, resume=False):
        hw = os.path.join(tmp, f"hw_{tag}")
        write_hosts(hw, list(hosts))
        t_start = time.time()
        sp, port = start_scheduler(
            tmp, f"sched_{tag}", ["--journal", journal, "--host-worker-file",
                                  hw] + (["--resume"] if resume else []))
        return sp, port, t_start

    def spawn(tag, port, ckpt_dir, extra):
        stems = {h: os.path.join(tmp, f"{h}_{tag}") for h in hosts}
        env = {"DT_OBS": "1", "DT_OBS_RING": "65536",
               "DT_CKPT_DIR": ckpt_dir, "DT_CKPT_EVERY": str(OUTAGE_EVERY),
               **extra}
        return stems, {h: drift.spawn(port, h, stems[h], OUTAGE_ARGS, env)
                       for h in hosts}

    def finish(stems, procs, sp, port):
        try:
            drift.wait_all(procs, stems, time.monotonic() + OUTAGE_TIMEOUT)
        finally:
            stop_scheduler(sp, port)
        return {h: json.load(open(stems[h] + ".json")) for h in hosts}

    t0 = time.monotonic()
    # (a) never killed, and beside it on the card (b), killed after the
    # step-12 commit
    ckpt_a = os.path.join(tmp, "ckpt_a")
    sp_a, port_a, _ = start("a", os.path.join(tmp, "a.journal"))
    stems_a, procs_a = spawn("a", port_a, ckpt_a, {})
    ckpt = os.path.join(tmp, "ckpt")
    journal = os.path.join(tmp, "b.journal")
    sp, port, _ = start("b", journal)
    stall = json.dumps({"seed": 0, "rules": [
        {"kind": "stall", "site": "worker.step",
         "after": OUTAGE_KILL_STEP + 1}]})
    stems, procs = spawn("b", port, ckpt, {"DT_FAULT_PLAN": stall})
    pids = {p.pid for p in procs.values()} | {sp.pid}
    try:
        try:
            deadline = time.monotonic() + OUTAGE_TIMEOUT
            while True:
                _check_alive(procs, stems)
                view = protocol.request("127.0.0.1", port,
                                        {"cmd": "ckpt_manifest"},
                                        timeout=10)
                com = view["committed"]
                if com is not None and com["step"] >= OUTAGE_KILL_STEP:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"outage: no step-"
                                         f"{OUTAGE_KILL_STEP} commit in "
                                         f"time ({view})")
                time.sleep(0.02)
        finally:
            for p in list(procs.values()) + [sp]:
                if p.poll() is None:
                    p.send_signal(signal.SIGKILL)
            for p in list(procs.values()) + [sp]:
                p.wait(timeout=60)
        base = finish(stems_a, procs_a, sp_a, port_a)
    finally:  # (a) ends with the phase whatever failed
        for p in list(procs_a.values()) + [sp_a]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    blob_bytes = os.path.getsize(os.path.join(ckpt_a, "w0",
                                              "fleet-0004.state"))
    shutil.rmtree(ckpt_a, ignore_errors=True)
    if com["step"] != OUTAGE_KILL_STEP:
        raise AssertionError(f"outage: the kill missed its window: commit "
                             f"at step {com['step']}")
    deadline = time.monotonic() + 60
    while pids & _nvidia_pids():
        if time.monotonic() > deadline:
            raise AssertionError(f"outage: {pids & _nvidia_pids()} still "
                                 "hold the card after the kill")
        time.sleep(0.2)
    digests = {}
    for h, ent in com["files"].items():
        with open(ent["path"], "rb") as f:
            digests[h] = (hashlib.sha256(f.read()).hexdigest(),
                          ent["sha256"])
    if any(a != b for a, b in digests.values()) or set(digests) != \
            set(hosts):
        raise AssertionError(f"outage: blob digests {digests}")
    # (c) resumed on the same journal
    sp, port, t_sched = start("c", journal, resume=True)
    stems, procs = spawn("c", port, ckpt, {"DT_RESUME": "1"})
    res = finish(stems, procs, sp, port)
    shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.monotonic() - t0
    resumed = {h: res[h]["resumed_from_step"] for h in hosts}
    finals = {h: (res[h]["epochs"][-1]["sha256"][:16],
                  base[h]["epochs"][-1]["sha256"][:16]) for h in hosts}
    launches = {"bn_stats": 0, "bn_act": 0, "quantize_2bit": 0,
                "dequantize_2bit": 0, **dict.fromkeys(LM_KERNELS, 0)}
    bad = []
    for h in hosts:
        ep = res[h]["epochs"]
        n = sum(e["steps"] for e in ep)
        got = {k: sum(e["launches"][k] for e in ep) for k in launches}
        want = {"bn_stats": BN_PER_FORWARD * n, "bn_act": BN_PER_FORWARD * n,
                "quantize_2bit": 0, "dequantize_2bit": 0,
                **dict.fromkeys(LM_KERNELS, 0)}
        if n != 2 * ELASTIC_STEPS - OUTAGE_KILL_STEP or got != want:
            bad.append((h, n, got, want))
        for k in launches:
            launches[k] += got[k]
    if set(resumed.values()) != {OUTAGE_KILL_STEP} or bad or \
            any(a != b for a, b in finals.values()):
        raise AssertionError(f"outage: resumed_from_step {resumed}, final "
                             f"sha256 (resumed, never killed) {finals}, "
                             f"launches {bad}")
    # the save's cost on the step path, on worker 0's clock in (a)
    start_ms = base["w0"]["spans"]["step_start"]
    gaps = np.diff(start_ms)  # gaps[k - 1]: step k's start to step k+1's
    ckpt_steps = [k for k in range(OUTAGE_EVERY, 2 * ELASTIC_STEPS,
                                   OUTAGE_EVERY)]
    cost = {k: {"step_ms": float(gaps[k - 1]),
                "epoch_median_ms": float(np.median(
                    gaps[(k - 1) // ELASTIC_STEPS * ELASTIC_STEPS:
                         ((k - 1) // ELASTIC_STEPS + 1) * ELASTIC_STEPS
                         - 1]))}
            for k in ckpt_steps}
    saves = base["w0"]["spans"]["ckpt.save"]
    resume_s = res["w0"]["spans"]["step_start"][0] / 1e3 - t_sched
    print(f"outage commit before the kill: step {com['step']}; "
          f"resumed_from_step {resumed}; final sha256 (resumed, never "
          f"killed) {finals}; blob digests equal to the journal's; "
          f"resumed launches {launches}; wall_s={wall:.1f} gpu={gpu}",
          flush=True)
    print(f"outage save cost on worker 0's clock (step start to next start "
          f"vs the epoch's median, never-killed run (a), the killed run (b) "
          f"beside it on the card until its kill): {json.dumps(cost)}; "
          f"ckpt.save spans ms {json.dumps([round(t, 3) for t in saves])}; "
          f"blob_bytes={blob_bytes}; resume_s (scheduler start to the first "
          f"resumed step)={resume_s:.3f}; gpu={gpu}", flush=True)
    return {"launches": launches, "save_cost": cost, "save_ms": saves,
            "blob_bytes": blob_bytes, "resume_s": resume_s, "wall_s": wall}


def sparse_phase(gpu, dev=None) -> dict:
    """The row-sparse plane at ``examples/train_sparse_embedding.py``'s
    defaults (``SPARSE``): the port's ``Scheduler``, two in-process
    ``RangeServer``s and two workers (threads), each on the card with its
    own table and ``optim.sparse.sparse_adagrad`` state; every step each
    worker's CBOW batch gives a row-sparse gradient
    (``ops.sparse.embedding_value_and_grad``), averaged by
    ``WorkerClient.allreduce_sparse`` across the two servers, then the lazy
    update.  Beside it the dense path: the two workers' dense gradients
    averaged and the dense AdaGrad.  Gates: the two workers' tables equal
    bit for bit, finite losses, and the sparse table within the example's
    1e-3 of the dense one at the end (its ``--dense`` check)."""
    import threading

    import torch

    from dt_tpu_torch.elastic.client import WorkerClient
    from dt_tpu_torch.elastic.range_server import RangeServer
    from dt_tpu_torch.elastic.scheduler import Scheduler
    from dt_tpu_torch.ops import sparse
    from dt_tpu_torch.optim import sparse as osparse
    dev = dev or torch.device("cuda")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    v, d, b, win, steps, lr = (SPARSE[k] for k in (
        "vocab", "dim", "batch", "window", "steps", "lr"))
    n_blocks = 64
    rng = np.random.RandomState(0)  # the example's draws, seed 0
    block_of = rng.randint(0, n_blocks, v)
    by_block = np.argsort(block_of, kind="stable")
    block_start = np.searchsorted(block_of[by_block], np.arange(n_blocks + 1))
    table0 = (rng.randn(v, d).astype(np.float32) * 0.05)
    proj = torch.from_numpy(rng.randn(d, n_blocks).astype(np.float32)
                            * 0.05).to(dev)

    def batch(step_rng):
        ctx = step_rng.randint(0, v, (b, win))
        tgt_blk = block_of[ctx[:, 0]]
        tgt = step_rng.randint(0, v, b)
        same = step_rng.rand(b) < 0.75
        lo, hi = block_start[tgt_blk], block_start[tgt_blk + 1]
        pick = lo + (step_rng.rand(b) * np.maximum(hi - lo, 1)).astype(
            np.int64)
        tok = by_block[np.minimum(pick, len(by_block) - 1)]
        tok = np.where(hi == lo, step_rng.randint(0, v, b), tok)
        tgt = np.where(same, tok, tgt)
        return (torch.from_numpy(ctx).to(dev),
                torch.from_numpy(block_of[tgt]).to(dev))

    def loss_of_rows(rows, tgt_blocks):
        logits = rows.mean(dim=1) @ proj
        return -torch.log_softmax(logits, dim=1)[
            torch.arange(logits.shape[0], device=dev), tgt_blocks].mean()

    vg = sparse.embedding_value_and_grad(loss_of_rows)
    opt = osparse.sparse_adagrad(lr)
    sched = Scheduler(initial_workers=["w0", "w1"])
    servers, clients = [], []
    try:
        servers = [RangeServer("127.0.0.1", sched.port, i,
                               advertise_host="127.0.0.1",
                               membership_ttl_s=0.2, poll_interval_s=0.2)
                   for i in range(2)]
        clients = [WorkerClient("127.0.0.1", sched.port, host=h)
                   for h in ("w0", "w1")]
        for c in clients:
            c.refresh_servers()
            if len(c.servers) != 2:
                raise AssertionError(f"sparse: {c.servers} range servers")
        tables = [torch.from_numpy(table0).to(dev) for _ in clients]
        states = [opt.init(t) for t in tables]
        dense = torch.from_numpy(table0).to(dev)
        hist = torch.zeros_like(dense)
        step_rngs = [np.random.RandomState(1000 + i) for i in range(2)]
        losses, t_sparse, t_dense, rows_a_step = [], 0.0, 0.0, []
        for _ in range(steps):
            data = [batch(r_) for r_ in step_rngs]
            sync()
            ts = time.perf_counter()
            grads, avg, errs = [], [None, None], []
            for i in range(2):
                loss, (g_rs, _) = vg(tables[i], *data[i])
                grads.append(g_rs)
                losses.append(float(loss))

            def push(i):
                try:
                    avg[i] = clients[i].allreduce_sparse("emb_grad",
                                                         grads[i])
                except Exception as e:  # noqa: BLE001 — raised below
                    errs.append(e)

            th = [threading.Thread(target=push, args=(i,)) for i in (0, 1)]
            for t in th:
                t.start()
            for t in th:
                t.join(60)
            if errs or any(t.is_alive() for t in th):
                raise AssertionError(f"sparse allreduce: {errs}")
            for i in range(2):
                tables[i], states[i] = opt.update(avg[i], states[i],
                                                  tables[i])
            rows_a_step.append(int((avg[0].indices < v).sum()))
            sync()
            t_sparse += time.perf_counter() - ts
            td = time.perf_counter()
            g = (grads[0].to_dense() + grads[1].to_dense()) / 2
            hist = hist + g * g
            dense = dense - lr * (g / torch.sqrt(hist + opt.epsilon))
            sync()
            t_dense += time.perf_counter() - td
        same = torch.equal(tables[0], tables[1])
        div = float((tables[0] - dense).abs().max())
    finally:
        for c in clients:
            c.close()
        for srv in servers:
            srv.close()
        sched.close()
    print(f"sparse embedding vocab={v} dim={d} batch={b} window={win} "
          f"steps={steps} adagrad lr={lr}, 2 workers x 2 range servers: "
          f"loss first={losses[0]:.4f} last={np.mean(losses[-2:]):.4f} "
          f"merged_rows_a_step={np.mean(rows_a_step):.1f} "
          f"({100 * np.mean(rows_a_step) / v:.2f}% of the table) "
          f"sparse_ms_a_step={t_sparse / steps * 1e3:.3f} "
          f"dense_ms_a_step={t_dense / steps * 1e3:.3f} "
          f"workers_bit_identical={same} max|sparse-dense|={div:.3e} "
          f"(tol 1e-3); gpu={gpu}", flush=True)
    if not same or not div < 1e-3 or not np.isfinite(losses).all():
        raise AssertionError(f"sparse: workers identical {same}, "
                             f"divergence {div}")
    return {"divergence": div, "sparse_ms": t_sparse / steps * 1e3,
            "dense_ms": t_dense / steps * 1e3}


def elastic_small_jobs(gpu) -> dict:
    """2-worker f32 resnet20 jobs (2 epochs of 2 steps) at ``SMALL_SIZES``
    images, each against its own port ``Scheduler``, all at once:
    on the card with the overlapped step, its workers recording every step
    (``tests/torch_elastic_drift.py``); on the card with
    ``DT_AR_OVERLAP=0`` (serial); on the CPU.  Gates: every step of the
    card job replayed on the CPU from its recorded state within
    ``TOL_ELASTIC_LOSS`` (loss, stats, update, and the gradient where no
    ReLU mask flipped), the applied gradient and stats the workers' f32
    average bit for bit, the per-epoch loss within ``TOL_ELASTIC_LOSS`` of
    the replay's and of the CPU job's up to the first flipped step, and
    overlap against serial (cuDNN deterministic in both): the same sha256
    of params, stats and optimizer state at every epoch end."""
    import os
    import tempfile

    import torch_elastic_drift as drift
    from dt_tpu_torch.elastic.scheduler import Scheduler
    tmp = tempfile.mkdtemp(prefix="dt_elastic_small_")
    jobs = {"card": (["--deterministic"], {}),
            "serial": (["--deterministic"], {"DT_AR_OVERLAP": "0"}),
            "cpu": (["--device", "cpu"], {})}
    scheds, procs, stems = {}, {}, {}
    t0 = time.monotonic()
    try:
        for size in SMALL_SIZES:
            for tag, (extra, env) in jobs.items():
                sc = scheds[size, tag] = Scheduler(
                    initial_workers=["w0", "w1"])
                for h in ("w0", "w1"):
                    key = (size, tag, h)
                    stems[key] = os.path.join(tmp, f"{size}_{tag}_{h}")
                    procs[key] = drift.spawn(
                        sc.port, h, stems[key],
                        drift.job_args(size, 128, 64) + extra, env,
                        dump=tag == "card")
        drift.wait_all(procs, stems, t0 + 300)
    finally:
        for sc in scheds.values():
            sc.close()
    out = {}
    for size in SMALL_SIZES:
        r = {tag: {h: drift.load(stems[size, tag, h], dump=tag == "card")
                   for h in ("w0", "w1")} for tag in jobs}
        summary, failures = drift.hold_card_job(r["card"], r["cpu"],
                                                TOL_ELASTIC_LOSS)
        shas = {tag: [e["sha256"] for e in r[tag]["w0"][0]["epochs"]]
                for tag in ("card", "serial")}
        same = shas["card"] == shas["serial"] == \
            [e["sha256"] for e in r["card"]["w1"][0]["epochs"]]
        for e in summary["epochs"]:
            print(f"elastic card-vs-cpu f32 resnet20 {size}x{size} "
                  f"{json.dumps(e)}", flush=True)
        print(f"elastic card-vs-cpu f32 resnet20 {size}x{size}: replay worst "
              f"(rel) {json.dumps(summary['replay_worst'])} applied_is_mean="
              f"{summary['applied_is_mean']} relu_flipped_steps="
              f"{summary['flipped_steps']} (tol {TOL_ELASTIC_LOSS}); overlap "
              f"vs serial on the card bit-identical={same} wall_s="
              f"{time.monotonic() - t0:.1f} gpu={gpu}", flush=True)
        if failures:
            raise AssertionError(f"elastic job {size}x{size}, card against "
                                 f"CPU: {failures}")
        if not same:
            raise AssertionError(f"overlap against serial: {shas}")
        out[size] = dict(summary, overlap_bit_identical=same)
    return out


def policy_phase(gpu) -> dict:
    """The policy engine's closed loop through the port's launcher (see
    ``POLICY_*``): ``python -m dt_tpu_torch.launcher.launch -n 2 -H hw
    --standby --elastic-training-enabled True -- tests/torch_elastic_
    worker.py ...``; ``w1`` is added to the host file during epoch 0 and
    the launcher starts it at the epoch-1 barrier.  Gates: the launcher
    returns 0 (every worker it started exited 0, the evicted one through
    ``WorkerRemoved``), it started ``w1`` once; the decision log rebuilt
    from the journal is ``PolicyEngine.decide``'s for ``w1`` breaching
    every epoch it trains and nobody else; every epoch's batches are the
    shares' ``batch_map`` and sum to 64; the workers' gradient weights sum
    to W within 1e-6; the live sha256 agree at every epoch end; 53 + 53
    BN-train and 1 ``quantize_2bit`` launches a worker-step, 53 ``bn_act``
    a scored batch, nothing else; on worker 0's clock epoch 2's least step
    (of its steps after the first) is >= 0.25 x the delay under epoch 1's,
    epoch 3's rate (images a least step) >= 80 % of epoch 0's, and no step
    of epoch 3's window takes more than :data:`POLICY_STALL` x epoch 0's
    least step."""
    import hashlib
    import os
    import signal
    import tempfile

    from torch_elastic_job import (load, policy_drill_log, read_step,
                                   write_hosts)

    from dt_tpu_torch.elastic import journal
    from dt_tpu_torch.policy import PolicyEngine, rescale
    tmp = tempfile.mkdtemp(prefix="dt_policy_")
    hw = os.path.join(tmp, "host_worker")
    write_hosts(hw, ["w0", "w2"])
    had = os.path.join(tmp, "ha")
    plan = {"rules": [{"kind": "delay", "site": "worker.step", "host": "w1",
                       "delay_s": POLICY_DELAY_S}], "seed": 0}
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               DT_FAULT_PLAN=json.dumps(plan), **POLICY_ENV)
    cmd = [sys.executable, "-m", "dt_tpu_torch.launcher.launch", "-n", "2",
           "-H", hw, "--standby", "--ha-dir", had,
           "--elastic-training-enabled", "True", "--", sys.executable,
           str(ROOT / "tests" / "torch_elastic_worker.py"), *POLICY_ARGS,
           "--out", os.path.join(tmp, "{host}.json"),
           "--progress", os.path.join(tmp, "{host}.step")]
    log_path = os.path.join(tmp, "launcher.log")
    t0 = time.monotonic()
    wall0_ms = time.time() * 1e3  # the spans' clock
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    added_at = None
    try:
        while proc.poll() is None:
            if time.monotonic() - t0 > POLICY_TIMEOUT:
                raise AssertionError(f"policy launch past {POLICY_TIMEOUT} s")
            step = read_step(os.path.join(tmp, "w0.step"))
            if added_at is None and step >= 1:
                if step >= POLICY_STEPS:
                    raise AssertionError("w0 left epoch 0 before w1 was "
                                         "added")
                write_hosts(hw, ["w0", "w2", "w1"])
                added_at = step
            time.sleep(0.02)
    finally:
        if proc.poll() is None:  # the launcher, its workers and standby
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    wall = time.monotonic() - t0
    text = open(log_path).read()
    started = text.count("launching elastic worker w1 (EPOCH_BEGIN=1)")
    if proc.returncode != 0 or started != 1 or \
            text.count("launching elastic worker") != 1:
        raise AssertionError(f"policy launch rc {proc.returncode}, w1 "
                             f"started {started}x:\n{text[-4000:]}")
    r = {h: load(os.path.join(tmp, f"{h}.json")) for h in ("w0", "w1", "w2")}
    engine = PolicyEngine(threshold_ms=POLICY_THRESHOLD_MS,
                          evict_after=POLICY_EVICT_AFTER)
    want_log, want_batches = policy_drill_log(engine, rescale)
    got_log = journal.ControlState.rebuild(
        os.path.join(had, "ctrl.journal")).policy_log
    log_sha = hashlib.sha256(json.dumps(got_log, sort_keys=True)
                             .encode()).hexdigest()
    audit = [ln.split()[1:3] for ln in open(hw + "_log")]
    boards = [e["board"] for e in r["w0"]["epochs"]]
    print(f"policy launch wall_s={wall:.1f} w1 added at w0 step {added_at}; "
          f"audit={audit}; decision log sha256={log_sha} "
          f"{json.dumps(got_log)}; boards at the barriers of epochs 1-4 "
          f"(ms): {json.dumps(boards)}; gpu={gpu}", flush=True)
    if got_log != want_log:
        raise AssertionError(f"policy decision log {got_log}, want "
                             f"{want_log}")
    if audit != [["ADDED", "w1"], ["REMOVED", "w1"]] or \
            r["w1"]["bootstrap_step"] != POLICY_STEPS:
        raise AssertionError(f"policy audit {audit}, w1 bootstrapped at "
                             f"{r['w1']['bootstrap_step']}")
    by_epoch = {}
    for h, res in r.items():
        for e in res["epochs"]:
            by_epoch.setdefault(e["epoch"], {})[h] = e
    launches = {"bn_stats": 0, "bn_act": 0, "quantize_2bit": 0,
                "dequantize_2bit": 0, **dict.fromkeys(LM_KERNELS, 0),
                "score_bn_act": 0}
    score_want = {"bn_stats": 0, "bn_act": BN_PER_FORWARD}
    for epoch, want in enumerate(want_batches):
        got = by_epoch.get(epoch, {})
        batches = {h: got[h]["batch"] for h in got}
        weights = {h: got[h]["grad_scale"] for h in got}
        short = {h: got[h]["sha256"][:16] for h in got}
        print(f"policy epoch {epoch} batches={batches} grad_weights="
              f"{weights} sha256={short} train_ce="
              f"{ {h: got[h]['loss'] for h in got} }", flush=True)
        if batches != want or sum(batches.values()) != 64:
            raise AssertionError(f"policy epoch {epoch}: batches {batches}, "
                                 f"want {want}")
        wsum = sum(weights.values())
        if abs(wsum - len(want)) > 1e-6 or any(
                weights[h] != rescale.grad_weight(want[h], len(want), 64)
                for h in want):
            raise AssertionError(f"policy epoch {epoch}: gradient weights "
                                 f"{weights} (sum {wsum})")
        if len(set(short.values())) != 1:
            raise AssertionError(f"policy epoch {epoch}: digests {short}")
        for h, e in got.items():
            n, la = e["steps"], e["launches"]
            lwant = {"bn_stats": BN_PER_FORWARD * n,
                     "bn_act": BN_PER_FORWARD * n, "quantize_2bit": n,
                     "dequantize_2bit": 0, **dict.fromkeys(LM_KERNELS, 0)}
            got_la = {k: la[k] for k in lwant}
            if n != POLICY_STEPS or got_la != lwant or \
                    e["score_launches"] != score_want or \
                    not np.isfinite(e["loss"]):
                raise AssertionError(f"policy epoch {epoch} {h}: steps {n}, "
                                     f"launches {got_la} want {lwant}, score "
                                     f"{e['score_launches']}, loss "
                                     f"{e['loss']}")
            for k in lwant:
                launches[k] += la[k]
            launches["score_bn_act"] += e["score_launches"]["bn_act"]
    spans, k = r["w0"]["spans"], POLICY_STEPS
    if len(spans["step"]) != len(want_batches) * k:
        raise AssertionError(f"worker 0 recorded {len(spans['step'])} "
                             "steps")
    windows = []
    for epoch, want in enumerate(want_batches):
        lo, hi = epoch * k + 1, epoch * k + k  # the steps after the first
        span = spans["step_start"][hi - 1] + spans["step"][hi - 1] - \
            spans["step_start"][lo]
        windows.append({"epoch": epoch, "batches": want, "steps": hi - lo,
                        "wall_ms": span, "ms_a_step": span / (hi - lo),
                        "median_step_ms": float(np.median(
                            spans["step"][lo:hi])),
                        "least_step_ms": float(min(spans["step"][lo:hi])),
                        "images_s": 64 * (hi - lo) / span * 1e3,
                        "step_ms": spans["step"][lo:hi]})
        w = windows[-1]
        print(f"policy window epoch {epoch} batches={want} wall_ms="
              f"{span:.3f} median_step_ms={w['median_step_ms']:.3f} "
              f"fleet_images_s={w['images_s']:.2f} step_ms="
              f"{json.dumps([round(t, 3) for t in w['step_ms']])} (worker "
              f"0's clock); gpu={gpu}", flush=True)
    # where the launch's wall time goes, on the spans' wall clock
    starts, ends = spans["step_start"], [
        a + d for a, d in zip(spans["step_start"], spans["step"])]
    w0 = r["w0"]
    parts = {"launch_to_standby_up": os.path.getmtime(
                 os.path.join(had, "standby.port")) * 1e3 - wall0_ms,
             "launch_to_w0_imported": w0["start_ms"]["main"] - wall0_ms,
             "w0_model_built": w0["start_ms"]["built"]
             - w0["start_ms"]["main"],
             "w0_built_to_first_barrier": w0["spans"]["mc_barrier_start"][0]
             - w0["start_ms"]["built"],
             "w0_first_barrier": w0["spans"]["mc_barrier"][0],
             "startup_to_w0_first_step": starts[0] - wall0_ms,
             "w1_join_to_first_step": r["w1"]["spans"]["step_start"][0]
             - starts[k],
             "epochs": [ends[e * k + k - 1] - starts[e * k]
                        for e in range(len(want_batches))],
             "between_epochs": [starts[e * k] - ends[e * k - 1]
                                for e in range(1, len(want_batches))],
             "after_w0_last_step": wall * 1e3 - (ends[-1] - wall0_ms)}
    print(f"policy wall parts_ms={json.dumps(parts)}; gpu={gpu}",
          flush=True)
    # w2 trains every epoch beside w0: its steps on the same clock, and w1's
    # exit (its result written) against epoch 3's window
    w2 = r["w2"]["spans"]
    for epoch in (0, 3):
        lo, hi = epoch * k + 1, epoch * k + k
        offsets = [round(b - a, 3) for a, b in
                   zip(starts[lo:hi], w2["step_start"][lo:hi])]
        print(f"policy epoch {epoch} steps after the first, start offset "
              f"w2 - w0 (ms): {json.dumps(offsets)}; w2 step_ms="
              f"{json.dumps([round(t, 3) for t in w2['step'][lo:hi]])}",
              flush=True)
    print(f"policy w1 wrote its result {r['w1']['end_ms'] - starts[3 * k]:.1f}"
          f" ms after epoch 3's first step began (its timed window: "
          f"{starts[3 * k + 1] - starts[3 * k]:.1f} to "
          f"{ends[4 * k - 1] - starts[3 * k]:.1f} ms)", flush=True)
    # the gain and recovery gates on each window's least step (a rate: 64
    # images a least step).  Every step waits for the fleet's allreduce, so
    # none can be faster than the fleet allows, while the host's other
    # tenants only add time: a slowdown of 10-20 s can cover most of a
    # 7-step window (median and wall span printed beside it).  A stall
    # inside epoch 3's window, which the least step cannot see, is gated
    # on its slowest step
    gain = windows[1]["least_step_ms"] - windows[2]["least_step_ms"]
    recovery = windows[0]["least_step_ms"] / windows[3]["least_step_ms"]
    stall = max(windows[3]["step_ms"]) / windows[0]["least_step_ms"]
    med = [w["median_step_ms"] for w in windows]
    print(f"policy dynamic mini-batch: epoch 2's least step {gain:.3f} ms "
          f"under epoch 1's (gate >= {0.25 * POLICY_DELAY_S * 1e3:.1f}; "
          f"medians {med[1] - med[2]:.3f}); epoch 3's rate by least steps "
          f"{recovery:.3f} of epoch 0's (gate >= 0.8; medians "
          f"{med[0] / med[3]:.3f}, wall spans "
          f"{windows[3]['images_s'] / windows[0]['images_s']:.3f}); epoch "
          f"3's slowest step {stall:.3f} x epoch 0's least (gate <= "
          f"{POLICY_STALL}), over {k - 1} steps an epoch; wall_s={wall:.1f} "
          f"gpu={gpu}", flush=True)
    if gain < 0.25 * POLICY_DELAY_S * 1e3 or recovery < 0.8 \
            or stall > POLICY_STALL:
        raise AssertionError(f"policy: step gain {gain} ms, recovery "
                             f"{recovery}, epoch 3's slowest step {stall} x "
                             "epoch 0's least")
    return {"launches": launches, "windows": windows, "boards": boards,
            "log_sha256": log_sha, "wall_s": wall, "gain_ms": gain,
            "recovery": recovery, "stall": stall, "wall_parts_ms": parts}


# Phase 18, the obs planes: phase 11's job at full width (ResNet-50 v1
# bf16, 2 workers x 32, 2-bit at 0.005, overlapped) with every plane armed,
# then the health-halt and hang drills on the same job.
OBS_EPOCHS = 2
OBS_PLANES = {"DT_OBS": "1", "DT_METRICS": "1", "DT_METRICS_PORT": "0",
              "DT_METRICS_INTERVAL_S": "0.5", "DT_BLACKBOX": "1",
              "DT_DEVICE_OBS": "1"}
OBS_CAPTURE_STEPS = 2
OBS_HANG_S = 8.0
OBS_NAN_AFTER = 3  # w1's 4th gradient is poisoned: both halt at step 3


class _PlanesArmed:
    """This process's side of phase 18: the scheduler built here reads the
    planes' gates and knobs (``env``) from the environment, so they are set
    for the phase and restored after."""

    def __init__(self, env: dict):
        self.env = env

    def __enter__(self):
        import os

        from dt_tpu_torch.obs import blackbox, metrics
        from dt_tpu_torch.obs import trace as obs_trace
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        self.mods = (obs_trace, metrics, blackbox)
        for m in self.mods:
            m.set_enabled(True)
        return self

    def __exit__(self, *exc):
        import os
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for m in self.mods:
            m.set_enabled(None)


def _sched_bundles() -> str:
    """A directory of its own for the bundles of the scheduler in this
    process (its hang detector's)."""
    import tempfile
    return tempfile.mkdtemp(prefix="dt_obs_sched_")


def _scrape(port: int):
    """``/metrics`` of the scheduler's ``HealthServer``: the text and the
    ms the GET took."""
    import urllib.request
    t0 = time.perf_counter()
    text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=30).read().decode()
    return text, (time.perf_counter() - t0) * 1e3


def _hbm_by_worker(text: str) -> dict:
    """``dt_device_hbm_bytes`` of each worker in a scrape."""
    import re
    out = {}
    for m in re.finditer(r'^dt_device_hbm_bytes\{([^}]*)\} (\S+)$', text,
                         re.M):
        labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
        if "worker" in labels:
            out[labels["worker"]] = float(m.group(2))
    return out


def _capture_kernels(path: str) -> dict:
    """The device kernels of a ``torch.profiler`` chrome trace, counted by
    the port's BN-train pass 1 and 2-bit quantize kernels."""
    import re
    events = json.load(open(path))["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"kernels": len(names),
            "bn_stats": sum("bn_stats_kernel" in n for n in names),
            "quantize_2bit": sum(bool(re.search(r"(?<!de)quantize_kernel",
                                                n)) for n in names)}


def _armed_drill(gpu, elastic) -> dict:
    """Drill (a): the job with every plane armed (see :func:`obs_phase`)."""
    import os

    from dt_tpu_torch.elastic import protocol
    from dt_tpu_torch.obs import blackbox, export, names

    def probe(sched, tmp):
        # one bounded capture on w1, queued at once: it rides w1's next
        # heartbeat and starts at the step after
        return protocol.request(
            "127.0.0.1", sched.port,
            {"cmd": "profile_capture", "target": "w1",
             "steps": OBS_CAPTURE_STEPS, "host": "chip_smoke",
             "post_seq": 1}, timeout=30)

    def final(sched, tmp):
        text, scrape_ms = _scrape(sched.metrics_port)
        return {"dump": sched.obs_dump(), "health": sched.health_view(),
                "scrape": text, "scrape_ms": scrape_ms}

    with _PlanesArmed({"DT_OBS_RING": "65536", "DT_METRICS_PORT": "0",
                       "DT_METRICS_INTERVAL_S": "0.5",
                       "DT_BLACKBOX_DIR": _sched_bundles()}):
        r, _, _, wall, extra = _elastic_job(armed={
            "args": ["--num-epoch", str(OBS_EPOCHS)],
            "env": dict(OBS_PLANES, DT_BLACKBOX_DIR="{tmp}/bb"),
            "probe": probe, "final": final})
    tmp = extra["tmp"]
    fin = extra["final"]
    tag = "obs (a)"
    # the planes change no bit: epoch 0 is phase 11's epoch 0
    want = elastic["shas"][0]["w0"]
    shas = {h: res["epochs"][0]["sha256"] for h, res in r.items()}
    short = {h: v[:16] for h, v in shas.items()}
    print(f"{tag} epoch-0 sha256 {json.dumps(short)} phase 11's "
          f"{want[:16]}; wall_s={wall:.1f}; gpu={gpu}", flush=True)
    if set(shas) != {"w0", "w1"} or set(shas.values()) != {want}:
        raise AssertionError(f"{tag}: epoch-0 digests {shas}, phase 11's "
                             f"{want}")
    launches = {"bn_stats": 0, "score_bn_act": 0, "quantize_2bit": 0}
    for res in r.values():
        if len(res["epochs"]) != OBS_EPOCHS:
            raise AssertionError(f"{tag}: {len(res['epochs'])} epochs")
        for e in res["epochs"]:
            launches["bn_stats"] += e["launches"]["bn_stats"]
            launches["quantize_2bit"] += e["launches"]["quantize_2bit"]
            launches["score_bn_act"] += e["score_launches"]["bn_act"]
    n = 2 * OBS_EPOCHS * ELASTIC_STEPS
    if launches != {"bn_stats": BN_PER_FORWARD * n, "quantize_2bit": n,
                    "score_bn_act": 2 * OBS_EPOCHS * BN_PER_FORWARD
                    * ELASTIC_VAL_FORWARDS}:
        raise AssertionError(f"{tag}: launches {launches}")
    # obs_dump: both worker tracks and the control plane's, 16 steps each
    # with their pipeline spans, every name in the catalog
    dump = fin["dump"]
    tracks = sorted(dump["tracks"])
    workers = [k for k in tracks if k != "control-plane"]
    steps = {k: sum(rec[2] == "step" and rec[0] == "X"
                    for rec in dump["tracks"][k]["records"])
             for k in workers}
    pipe = {k: sorted({rec[2] for rec in dump["tracks"][k]["records"]
                       if rec[2].startswith("pipeline.")})
            for k in workers}
    unknown = set()
    for k in tracks:
        for rec in dump["tracks"][k]["records"]:
            try:
                names.lookup(rec[2])
            except KeyError:
                unknown.add(rec[2])
    nrec = {k: len(v["records"]) for k, v in dump["tracks"].items()}
    print(f"{tag} obs_dump tracks={tracks} steps={steps} pipeline={pipe} "
          f"records={nrec} unknown_names={sorted(unknown)}", flush=True)
    if sorted(k.split("#")[0] for k in workers) != ["w0", "w1"] or \
            "control-plane" not in tracks or \
            set(steps.values()) != {n // 2} or unknown or \
            any(not {"pipeline.d2h", "pipeline.wire", "pipeline.h2d"}
                <= set(v) for v in pipe.values()):
        raise AssertionError(f"{tag}: obs_dump {tracks} {steps} {pipe} "
                             f"{unknown}")
    # the export: a chrome trace and a summary naming a worker
    path = os.path.join(tmp, "obs_trace.json")
    summary = export.write(path, dump)
    blame = summary["straggler_blame"]
    crit = {k: v["steps"] for k, v in summary["critical_path"].items()}
    print(f"{tag} export {path}: {os.path.getsize(path)} B trace, "
          f"{os.path.getsize(export.metrics_path(path))} B summary; "
          f"critical_path steps={crit} straggler_blame_ms={blame}",
          flush=True)
    if not blame or not set(blame) <= {"w0", "w1"} or \
            {k for k, v in crit.items() if v == n // 2} != set(workers):
        raise AssertionError(f"{tag}: critical path {crit}, blame {blame}")
    # the Prometheus scrape: each worker's HBM in use, within the card
    import torch
    card = torch.cuda.mem_get_info()[1]
    hbm = _hbm_by_worker(fin["scrape"])
    print(f"{tag} /metrics scrape {len(fin['scrape'])} B in "
          f"{fin['scrape_ms']:.3f} ms; device.hbm_bytes by worker "
          f"{json.dumps(hbm)} card_bytes={card}; gpu={gpu}", flush=True)
    if set(hbm) != {"w0", "w1"} or not all(0 < v <= card
                                           for v in hbm.values()):
        raise AssertionError(f"{tag}: HBM gauges {hbm}")
    # the SLOs: no breach stands at the job's end (the transitions on the
    # way, e.g. the first round's lag while a worker still starts, are
    # printed)
    slo = fin["health"]["slo"]
    print(f"{tag} health: slo active={slo['active']} transitions="
          f"{json.dumps(slo['history'])}", flush=True)
    if slo["active"]:
        raise AssertionError(f"{tag}: SLO breach {slo}")
    # the capture: 2 steps of w1, 53 bn_stats and one quantize a step
    if "seq" not in extra["probe"]:
        raise AssertionError(f"{tag}: profile_capture {extra['probe']}")
    bbdir = os.path.join(tmp, "bb")
    rows = [row for row in blackbox.read_manifest(bbdir)
            if row["kind"] == "profile_capture"]
    ok = [row for row in rows if row.get("host") == "w1"
          and row.get("steps") == OBS_CAPTURE_STEPS
          and not row.get("error") and not row.get("aborted")]
    if len(ok) != 1:
        raise AssertionError(f"{tag}: capture rows {rows}")
    trace = os.path.join(ok[0]["dir"], "trace.json")
    got = _capture_kernels(trace)
    bundles = [row for row in blackbox.read_manifest(bbdir)
               if row["kind"] == "bundle"]
    print(f"{tag} capture on w1: {json.dumps(got)} in "
          f"{os.path.getsize(trace)} B ({trace}); bundles={len(bundles)} "
          f"({sum(b['size'] for b in bundles)} B); gpu={gpu}", flush=True)
    if (got["bn_stats"], got["quantize_2bit"]) != \
            (OBS_CAPTURE_STEPS * BN_PER_FORWARD, OBS_CAPTURE_STEPS):
        raise AssertionError(f"{tag}: capture kernels {got}")
    # printed, not gated: the armed epoch-1 window beside phase 11's
    # 2-worker window, and the bytes the export adds a worker-step
    sp = r["w0"]["spans"]
    k = ELASTIC_STEPS
    lo, hi = k + 1, 2 * k
    span = sp["step_start"][hi - 1] + sp["step"][hi - 1] - sp["step_start"][lo]
    armed_ms = span / (hi - lo)
    w1 = r["w1"]["epochs"]
    wire = sum(e["launches"]["wire_bytes"] for e in w1) / \
        sum(e["steps"] for e in w1)
    plain = elastic["w1_epoch0_wire_bytes_a_step"]
    print(f"{tag} epoch-1 window ms_a_step={armed_ms:.3f} beside phase "
          f"11's epoch-0 window {elastic['step_ms']:.3f} (one run each, "
          f"not a measure of overhead); w1 sent {wire:.0f} B a step against "
          f"phase 11's {plain:.0f} (+{wire - plain:.0f} B a worker-step: "
          f"the heartbeat export); gpu={gpu}", flush=True)
    return {"launches": launches, "armed_step_ms": armed_ms,
            "export_bytes_a_step": wire - plain,
            "scrape_ms": fin["scrape_ms"], "capture": got,
            "trace_bytes": os.path.getsize(path),
            "capture_bytes": os.path.getsize(trace)}


def _halt_drill(gpu) -> dict:
    """Drill (b): the health halt (see :func:`obs_phase`)."""
    import os

    from dt_tpu_torch.obs import blackbox

    def final(sched, tmp):
        return {"dump": sched.obs_dump(), "health": sched.health_view()}

    plan = {"seed": 0, "rules": [{"kind": "nan", "site": "worker.grad",
                                  "host": ["w1"], "after": OBS_NAN_AFTER,
                                  "times": 1}]}
    with _PlanesArmed({"DT_OBS_RING": "65536",
                       "DT_BLACKBOX_DIR": _sched_bundles()}):
        r, _, _, wall, extra = _elastic_job(armed={
            "args": ["--num-epoch", "1"],
            "env": {"DT_HEALTH_HALT": "1", "DT_BLACKBOX": "1",
                    "DT_BLACKBOX_DIR": "{tmp}/bb", "DT_METRICS": "1",
                    "DT_FAULT_PLAN": json.dumps(plan)},
            "probe": lambda sched, tmp: {}, "final": final})
    tag = "obs (b)"
    got = {h: (res["final_step"], res["health_halted"],
               res["final_sha256"][:16]) for h, res in r.items()}
    bbdir = os.path.join(extra["tmp"], "bb")
    halts = [row for row in blackbox.read_manifest(bbdir)
             if row["kind"] == "bundle" and row["trigger"] == "health.halt"]
    problems = {row["host"]: blackbox.validate_bundle(json.load(open(
        os.path.join(bbdir, row["file"])))) for row in halts}
    dump, health = extra["final"]["dump"], extra["final"]["health"]
    events = {k.split("#")[0]: [rec[2] for rec in v["records"]
                                if rec[2].startswith("health.")]
              for k, v in dump["tracks"].items() if k != "control-plane"}
    steps = {k.split("#")[0]: v["gauges"].get("train.steps")
             for k, v in health["workers"].items()}
    print(f"{tag} (final_step, health_halted, sha256)={json.dumps(got)} "
          f"halt bundles={ {h: p for h, p in problems.items()} } "
          f"worker events={json.dumps(events)} health train.steps="
          f"{json.dumps(steps)} wall_s={wall:.1f}; gpu={gpu}", flush=True)
    shas = {v[2] for v in got.values()}
    if set(got) != {"w0", "w1"} or len(shas) != 1 or \
            {v[:2] for v in got.values()} != {(OBS_NAN_AFTER, True)} or \
            sorted(problems) != ["w0", "w1"] or \
            any(problems.values()) or \
            any("health.halt" not in ev for ev in events.values()) or \
            sorted(events) != ["w0", "w1"] or \
            set(steps.values()) != {float(OBS_NAN_AFTER)}:
        raise AssertionError(f"{tag}: {got} {problems} {events} {steps}")
    return {"final_step": OBS_NAN_AFTER, "wall_s": wall}


def _hang_drill(gpu) -> dict:
    """Drill (c): the hang (see :func:`obs_phase`)."""
    import os

    import torch_elastic_job
    from dt_tpu_torch.elastic import protocol
    from dt_tpu_torch.obs import blackbox

    def stalled_bundle(bbdir):
        for row in blackbox.read_manifest(bbdir):
            if row["kind"] != "bundle" or row["host"] != "w1" or \
                    row["trigger"] != "hang":
                continue
            b = json.load(open(os.path.join(bbdir, row["file"])))
            if any(fr[2] == "stall_at" for t in b["threads"]
                   for fr in t["frames"]):
                return b
        return None

    def probe(sched, tmp):
        prog = os.path.join(tmp, "w1.progress")
        end = time.monotonic() + ELASTIC_TIMEOUT
        while torch_elastic_job.read_step(prog) < 2:
            if time.monotonic() > end:
                return {"error": "w1 never reached step 2"}
            time.sleep(0.1)
        t_stall = time.monotonic()
        out = {}
        while time.monotonic() < t_stall + OBS_HANG_S + 10.0:
            if "bundle_s" not in out:
                b = stalled_bundle(os.path.join(tmp, "bb"))
                if b is not None:
                    out["bundle_s"] = time.monotonic() - t_stall
                    out["bundle"] = {"problems": blackbox.validate_bundle(b),
                                     "stalled_s": b["extra"]["stalled_s"]}
            if "suspect" not in out:
                idx = protocol.request("127.0.0.1", sched.port,
                                       {"cmd": "blackbox_index"},
                                       timeout=10)
                if idx["suspect"]:
                    out["suspect_s"] = time.monotonic() - t_stall
                    out["suspect"] = idx["suspect"]
            if "bundle_s" in out and "suspect" in out:
                break
            time.sleep(0.25)
        return out

    plan = {"seed": 0, "rules": [{"kind": "stall", "site": "worker.step",
                                  "host": ["w1"], "after": 2}]}
    with _PlanesArmed({"DT_HANG_S": str(OBS_HANG_S),
                       "DT_BLACKBOX_DIR": _sched_bundles()}):
        r, _, _, wall, extra = _elastic_job(armed={
            "args": ["--num-epoch", "1", "--progress",
                     "{tmp}/{host}.progress"],
            "env": {"DT_BLACKBOX": "1", "DT_BLACKBOX_DIR": "{tmp}/bb",
                    "DT_HANG_S": str(OBS_HANG_S),
                    "DT_FAULT_PLAN": json.dumps(plan)},
            "probe": probe, "final": lambda sched, tmp: {}, "kill": True})
    tag = "obs (c)"
    out = extra["probe"]
    sus = out.get("suspect") or {}
    print(f"{tag} w1's hang bundle {out.get('bundle')} at "
          f"{out.get('bundle_s', float('nan')):.1f} s after its step 2, "
          f"suspect {json.dumps(sus)} at "
          f"{out.get('suspect_s', float('nan')):.1f} s (DT_HANG_S "
          f"{OBS_HANG_S}); wall_s={wall:.1f}; gpu={gpu}", flush=True)
    if "bundle_s" not in out or out["bundle"]["problems"] or \
            out["bundle_s"] > OBS_HANG_S + 10.0 or \
            sus.get("blamed") != "w1" or sus.get("waiting") != ["w1"]:
        raise AssertionError(f"{tag}: {out}")
    return {"bundle_s": out["bundle_s"], "suspect_s": out["suspect_s"]}


def obs_phase(gpu, elastic) -> dict:
    """Phase 18, the obs planes, on phase 11's job (ResNet-50 v1 bf16 on
    f32 params, 2 workers x 32, 2-bit at 0.005, overlapped, lr 0.025,
    momentum 0.9, wd 1e-4, the seeded weights), three drills:

    (a) 2 epochs of ``ELASTIC_STEPS`` with every plane armed
        (``OBS_PLANES``): the epoch-0 sha256 of both workers equal to
        phase 11's; ``obs_dump`` holds both worker tracks and the control
        plane's, 16 ``step`` spans a worker with their ``pipeline.*``
        spans, every name in the port's catalog; ``export.write`` gives a
        chrome trace and a summary whose critical path names a worker; the
        scheduler's ``/metrics`` shows each worker's ``device.hbm_bytes``,
        non-zero and within the card; no SLO breach; one
        ``profile_capture`` on ``w1`` for 2 steps writes a
        ``torch.profiler`` trace with exactly 2 x 53 ``bn_stats`` and 2
        ``quantize_2bit`` kernels;
    (b) ``DT_HEALTH_HALT=1`` and a ``nan`` rule on ``w1``'s
        ``worker.grad`` after 3: both workers exit 0 halted at step 3 with
        one sha256, each leaves a valid ``health.halt`` bundle, and the
        scheduler holds their ``health.halt`` events and ``train.steps``;
    (c) ``DT_HANG_S=8`` and a ``stall`` rule on ``w1``'s ``worker.step``
        after 2: within ``DT_HANG_S`` + 10 s ``w1``'s watchdog writes a
        live bundle whose stacks name ``stall_at``, and ``blackbox_index``
        names ``w1`` the suspect; the fleet is then killed."""
    out = {"armed": _armed_drill(gpu, elastic)}
    out["halt"] = _halt_drill(gpu)
    out["hang"] = _hang_drill(gpu)
    return out


# phase 19, the serve gateway: two replicas of ResNet-50 v1 bf16 behind the
# port's scheduler, closed-loop InferClient threads on them
GATEWAY_MODEL = "resnet50"
GATEWAY_THREADS = 8
GATEWAY_LOAD = 400  # requests of drill (a)
GATEWAY_AFTER = 48  # requests sent after the wave (b) or the prune (c)
GATEWAY_POOL = 64  # seeded images the requests draw their 1-4 rows from
GATEWAY_STEP = 1  # the step of the refreshed (seed 1) checkpoint
GATEWAY_PRUNE_S = 15.0  # the scheduler drops a replica silent for 3 s
GATEWAY_LIMIT_S = 45.0  # the whole phase


class _Load:
    """``GATEWAY_THREADS`` closed-loop ``InferClient`` threads.  Thread i
    draws requests of 1-4 rows of ``pool`` from ``RandomState(seed + i)``
    and sends them one at a time until it sent ``count /
    GATEWAY_THREADS`` or :attr:`stop` is set.  Every answer is kept with
    its rows' indices, its send and answer times and its step; an answer
    that is not a result (shed) and an exception are kept as errors."""

    def __init__(self, eps: str, pool, seed: int,
                 count: Optional[int] = None):
        import threading

        from dt_tpu_torch.serve import InferClient
        self.answers = []  # (t_sent, t_done, idx, y, weights_step)
        self.errors = []
        self.stop = threading.Event()
        self._lock = threading.Lock()
        per = None if count is None else -(-count // GATEWAY_THREADS)
        self.threads = [
            threading.Thread(target=self._run, daemon=True,
                             args=(InferClient(scheduler=eps), pool,
                                   seed + i, per))
            for i in range(GATEWAY_THREADS)]

    def _run(self, client, pool, seed, per):
        rng = np.random.RandomState(seed)
        sent = 0
        try:
            while not self.stop.is_set() and (per is None or sent < per):
                idx = rng.randint(0, len(pool), rng.randint(1, 5))
                t0 = time.perf_counter()
                out = client.infer(pool[idx])
                t1 = time.perf_counter()
                sent += 1
                with self._lock:
                    if "y" not in out:
                        self.errors.append(repr(out))
                    else:
                        self.answers.append((t0, t1, idx, out["y"],
                                             int(out["weights_step"])))
        except Exception as e:  # noqa: BLE001 (the phase fails on it)
            with self._lock:
                self.errors.append(repr(e))

    def start(self) -> "_Load":
        for t in self.threads:
            t.start()
        return self

    def sent_after(self, t: float) -> int:
        with self._lock:
            return sum(1 for a in self.answers if a[0] >= t)

    def join(self, tag: str, timeout: float = 120.0) -> None:
        for t in self.threads:
            t.join(timeout)
            if t.is_alive():
                raise AssertionError(f"gateway {tag}: a client thread "
                                     f"is still waiting after {timeout} s")
        if self.errors:
            raise AssertionError(f"gateway {tag}: {len(self.errors)} "
                                 f"requests failed, e.g. {self.errors[:3]}")


def _wait_for(what: str, cond, timeout: float) -> float:
    """Poll ``cond`` every 20 ms; the time it took, or fail naming
    ``what``."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"gateway: {what} not seen within "
                                 f"{timeout} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


def gateway_phase(gpu) -> dict:
    """Phase 19, the serve gateway (``dt_tpu_torch.serve``), in this
    process: the port's ``Scheduler`` and two ``Replica``s, each serving a
    ``Predictor`` of ResNet-50 v1 at full width in bf16 from a checkpoint
    the port wrote of ``seeded_variables(seed=0)``, buckets 1-64, all
    warmed, both on the one card.  ``GATEWAY_THREADS`` closed-loop
    ``InferClient`` threads send requests of 1-4 rows of a seeded
    64-image pool, through discovery (``serve_endpoints``), round-robin.
    Three drills:

    (a) ``GATEWAY_LOAD`` requests: every answer a result; requests
        coalesced (``serve.batches`` < ``serve.requests``); nothing shed;
        client p50/p99 latency, requests/s and rows/s, batches by bucket;
    (b) a committed fleet-checkpoint manifest of ``seeded_variables(seed=
        1)`` (the port's checkpoint writer, then ``ckpt_intent``/
        ``ckpt_ack`` on the scheduler) rolled by ``RollingRefresher.
        poll_once`` while the threads run: both replicas applied, every
        request sent after the wave answered at the new step, and
        ``serve_endpoints`` shows the new step on both;
    (c) one replica closed while the threads run: every request still
        answered (``InferClient``'s same-token retry), the scheduler prunes
        the lost replica.

    Across the three, ``fused_bn_inference`` launches 53 times each bucket
    forward the gateways ran (``serve.batches``) and no other kernel runs.
    Then every answer is held against a direct ``Predictor.predict`` of its
    rows on the card at the step it names: within ``TOL_BF16`` x the
    largest |logit| of that reference, top-1 equal where the reference's
    margin exceeds twice that (the gateway's buckets may take other cuDNN
    algorithms than the reference's 64-row one).  Prints the poll_once wall
    time, one ``swap_params`` (a deep copy of the model), the phase's
    seconds (at most ``GATEWAY_LIMIT_S``).  Two gateways' socket and
    executor threads and the client threads share this process's GIL, so
    the latencies include host contention."""
    import collections
    import os
    import shutil
    import tempfile

    import torch

    from dt_tpu_torch import models, optim
    from dt_tpu_torch.elastic import protocol
    from dt_tpu_torch.elastic.scheduler import Scheduler
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.obs import trace as obs_trace
    from dt_tpu_torch.predictor import Predictor
    from dt_tpu_torch.serve import Replica, RollingRefresher
    from dt_tpu_torch.serve.refresh import manifest_loader
    from dt_tpu_torch.training import checkpoint
    from dt_tpu_torch.training.train_state import TrainState

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dt_gateway_")
    row = (IMAGE, IMAGE, 3)

    def cpu_state(seed=None, step=0):
        model = models.create(GATEWAY_MODEL, device="cpu")
        if seed is not None:
            load_jax_variables(model, seeded_variables(model, seed))
        state = TrainState.create(model, optim.create("sgd"))
        state.step = step
        return state

    def predictor():
        p = Predictor(GATEWAY_MODEL, prefix, 0, np.zeros((1,) + row,
                                                          np.float32),
                      dtype=torch.bfloat16, max_batch=BUCKET_MAX,
                      device="cuda")
        p.warmup(feature_shape=row)
        return p

    prefix = os.path.join(tmp, "served")
    checkpoint.save_checkpoint(prefix, 0, cpu_state(seed=0))
    sched = Scheduler(initial_workers=["trainer"])
    eps = f"127.0.0.1:{sched.port}"

    def req(msg):
        return protocol.request("127.0.0.1", sched.port, msg, timeout=30)

    reps = []
    obs_trace.set_enabled(True)  # the gateways' serve.batch spans
    try:
        # the seed-1 state as a committed fleet checkpoint
        fleet = os.path.join(tmp, "ckpt", "trainer", "fleet")
        path = checkpoint.save_checkpoint(
            fleet, GATEWAY_STEP, cpu_state(seed=1, step=GATEWAY_STEP))
        sha = checkpoint.checkpoint_info(fleet, GATEWAY_STEP)["sha256"]
        r = req({"cmd": "ckpt_intent", "host": "trainer",
                 "step": GATEWAY_STEP, "epoch": 0})
        if not r.get("ok"):
            raise AssertionError(f"gateway: ckpt_intent {r}")
        r = req({"cmd": "ckpt_ack", "host": "trainer", "step": GATEWAY_STEP,
                 "path": path, "sha256": sha, "cursor": {}})
        if not r.get("committed"):
            raise AssertionError(f"gateway: ckpt_ack {r}")
        manifest = req({"cmd": "ckpt_manifest"})["committed"]

        reps = [Replica(predictor(), host, eps, advertise_host="127.0.0.1",
                        refresh_loader=manifest_loader(cpu_state()))
                for host in ("s0", "s1")]
        ref = predictor()
        _wait_for("two registered replicas", lambda: sorted(req(
            {"cmd": "serve_endpoints"})["replicas"]) == ["s0", "s1"], 10.0)
        pool = np.random.RandomState(19).uniform(
            -1, 1, (GATEWAY_POOL,) + row).astype(np.float32)
        torch.cuda.synchronize()
        print(f"gateway setup_s={time.perf_counter() - t_phase:.1f} "
              f"gpu={gpu}", flush=True)

        # (a) steady load --------------------------------------------------
        reset_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        load_a = _Load(eps, pool, 1900, GATEWAY_LOAD).start()
        load_a.join("(a)")
        wall = time.perf_counter() - t0
        st = [rp.gateway.stats() for rp in reps]
        requests = sum(s["requests"] for s in st)
        batches = sum(s["batches"] for s in st)
        lats = sorted((a[1] - a[0]) * 1e3 for a in load_a.answers)
        rows = sum(len(a[2]) for a in load_a.answers)
        buckets = collections.Counter(
            rec[8]["bucket"] for rp in reps
            for rec in rp.gateway._obs.snapshot()["records"]
            if rec[2] == "serve.batch")
        print(f"gateway (a) requests={len(lats)} rows={rows} "
              f"batches={batches} p50_ms={lats[len(lats) // 2]:.2f} "
              f"p99_ms={lats[int(len(lats) * 0.99)]:.2f} "
              f"requests_per_s={len(lats) / wall:.1f} "
              f"rows_per_s={rows / wall:.1f} wall_s={wall:.2f} gpu={gpu}",
              flush=True)
        print(f"gateway (a) batches_by_bucket="
              f"{json.dumps(dict(sorted(buckets.items())))} gpu={gpu}",
              flush=True)
        if len(lats) != GATEWAY_LOAD or requests != GATEWAY_LOAD:
            raise AssertionError(f"gateway (a): {len(lats)} answers, "
                                 f"{requests} requests admitted, expected "
                                 f"{GATEWAY_LOAD}")
        if not batches < requests:
            raise AssertionError(f"gateway (a): {batches} batches for "
                                 f"{requests} requests: nothing coalesced")
        if any(s["shed"] for s in st) or \
                any(a[4] != 0 for a in load_a.answers):
            raise AssertionError(f"gateway (a): shed or a refreshed step "
                                 f"({[s['shed'] for s in st]})")

        # (b) rolling refresh under load -----------------------------------
        load_b = _Load(eps, pool, 1910).start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        wave = RollingRefresher(eps).poll_once(GATEWAY_STEP, manifest)
        t_wave = time.perf_counter()
        poll_ms = (t_wave - t0) * 1e3
        _wait_for("requests after the wave",
                  lambda: load_b.sent_after(t_wave) >= GATEWAY_AFTER, 60.0)
        load_b.stop.set()
        load_b.join("(b)")
        steps = collections.Counter(a[4] for a in load_b.answers)
        stale = sum(1 for a in load_b.answers
                    if a[0] >= t_wave and a[4] != GATEWAY_STEP)
        print(f"gateway (b) applied={wave['applied']} "
              f"poll_once_ms={poll_ms:.1f} answers_by_step="
              f"{json.dumps(dict(sorted(steps.items())))} "
              f"after_wave={load_b.sent_after(t_wave)} gpu={gpu}",
              flush=True)
        if sorted(wave["applied"]) != ["s0", "s1"] or stale:
            raise AssertionError(f"gateway (b): wave {wave}, {stale} "
                                 f"answers after it at the old step")
        _wait_for("the new step in serve_endpoints", lambda: all(
            e["weights_step"] == GATEWAY_STEP for e in req(
                {"cmd": "serve_endpoints"})["replicas"].values()), 10.0)

        # (c) replica loss -------------------------------------------------
        load_c = _Load(eps, pool, 1920).start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        reps[1].close()
        prune_s = _wait_for("the lost replica pruned", lambda: "s1" not in
                            req({"cmd": "serve_endpoints"})["replicas"],
                            GATEWAY_PRUNE_S)
        t_pruned = time.perf_counter()
        _wait_for("requests after the prune",
                  lambda: load_c.sent_after(t_pruned) >= GATEWAY_AFTER, 60.0)
        load_c.stop.set()
        load_c.join("(c)")
        reps[1].gateway._exec_thread.join(30)
        lats_c = sorted((a[1] - a[0]) * 1e3 for a in load_c.answers)
        print(f"gateway (c) answers={len(lats_c)} prune_s={prune_s:.2f} "
              f"max_latency_ms={lats_c[-1]:.1f} "
              f"p50_ms={lats_c[len(lats_c) // 2]:.2f} gpu={gpu}",
              flush=True)
        if any(a[4] != GATEWAY_STEP for a in load_c.answers):
            raise AssertionError("gateway (c): an answer at the old step")

        counts = read_counts()  # ... and ends here
        launches = counts.pop("bn_act")
        batches = sum(rp.gateway.stats()["batches"] for rp in reps)
        print(f"gateway launches={launches} bucket_forwards={batches} "
              f"expected={BN_PER_FORWARD * batches}", flush=True)
        if launches != BN_PER_FORWARD * batches or any(counts.values()):
            raise AssertionError(f"gateway: {launches} fused_bn_inference "
                                 f"launches for {batches} bucket forwards, "
                                 f"others {counts}")

        # every answer against a direct predict at its step ---------------
        want = {0: ref.predict(pool)}
        params, stats = manifest_loader(cpu_state())(GATEWAY_STEP, manifest)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref.swap_params(params, stats)
        torch.cuda.synchronize()
        swap_ms = (time.perf_counter() - t0) * 1e3
        want[GATEWAY_STEP] = ref.predict(pool)
        errs = {0: 0.0, GATEWAY_STEP: 0.0}
        tols = {s: TOL_BF16 * float(np.abs(w).max()) for s, w in want.items()}
        checked = disagree = 0
        for load in (load_a, load_b, load_c):
            for _, _, idx, y, step in load.answers:
                w = want[step][idx]
                errs[step] = max(errs[step], float(np.abs(y - w).max()))
                top = np.sort(w, axis=1)
                clear = top[:, -1] - top[:, -2] > 2 * tols[step]
                disagree += int((y.argmax(1) != w.argmax(1))[clear].sum())
                checked += len(idx)
        print(f"gateway check rows={checked} max_abs_err="
              f"{json.dumps({s: round(e, 6) for s, e in errs.items()})} "
              f"tol={json.dumps({s: round(t, 6) for s, t in tols.items()})} "
              f"top1_disagree_where_clear={disagree} "
              f"swap_params_ms={swap_ms:.1f} gpu={gpu}", flush=True)
        if any(errs[s] > tols[s] for s in errs) or disagree:
            raise AssertionError("gateway: answers disagree with the direct "
                                 "predict at their step")
        secs = time.perf_counter() - t_phase
        print(f"gateway phase_s={secs:.1f} gpu={gpu}", flush=True)
        if secs > GATEWAY_LIMIT_S:
            raise AssertionError(f"gateway: phase took {secs:.1f} s, over "
                                 f"{GATEWAY_LIMIT_S} s")
        return {"launches": launches, "batches": batches,
                "p50_ms": lats[len(lats) // 2],
                "p99_ms": lats[int(len(lats) * 0.99)],
                "poll_once_ms": poll_ms, "swap_ms": swap_ms,
                "seconds": secs}
    finally:
        obs_trace.set_enabled(None)
        for rp in reps:
            rp.close()
        sched.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _plain_coverage(shapes, n: int, extra: int = 0):
    """``(fraction, sharded_bytes, total_bytes)`` of f32 leaves of JAX-layout
    ``shapes`` under the JAX package's rule (a leaf splits when an axis of
    at least ``n`` divides by ``n``), written out here apart from
    ``parallel.zero``; ``extra`` bytes of replicated scalars."""
    sharded = total = 0
    for shape in shapes:
        nbytes = 4 * int(np.prod(shape, dtype=np.int64))
        total += nbytes
        if any(d >= n and d % n == 0 for d in shape):
            sharded += nbytes
    total += extra
    return [sharded / max(total, 1), sharded, total]


def _mesh_gates(res, audit, launched, gpu) -> dict:
    """The gates of phase 20's elastic job; returns the launch totals."""
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch.training.flat import FlatLayout
    print(f"mesh audit={audit} launched={launched}", flush=True)
    if audit != [["ADDED", "w2"], ["REMOVED", "w2"]] or \
            launched != [("w2", 1)]:
        raise AssertionError(f"mesh audit log {audit}, launched {launched}")
    shapes = FlatLayout(models.create(
        MESH_MODEL, device="cpu", dtype=getattr(torch, MESH_DTYPE),
        num_classes=10 if MESH_MODEL == "resnet20" else 1000)
    ).params.jax_shapes
    want_report = {n: {"opt_state": _plain_coverage(shapes, n, extra=4),
                       "params": _plain_coverage(shapes, n)}
                   for n in (2, 3)}
    live = {0: {"w0", "w1"}, 1: {"w0", "w1", "w2"}, 2: {"w0", "w1"}}
    tot = {"bn_sums": 0, "bn_stats": 0, "bn_act": 0, "score_bn_act": 0}
    for epoch, hosts in live.items():
        got = {h: e for h, r in res.items() for e in r["epochs"]
               if e["epoch"] == epoch}
        short = {h: e["sha256"][:16] for h, e in got.items()}
        print(f"mesh epoch {epoch} workers={sorted(got)} sha256={short} "
              f"train_ce={ {h: e['loss'] for h, e in got.items()} } "
              f"batch={ {h: e['batch'] for h, e in got.items()} }",
              flush=True)
        if set(got) != hosts or len(set(short.values())) != 1:
            raise AssertionError(f"mesh epoch {epoch}: live {sorted(got)}, "
                                 f"digests {short}")
        n = len(hosts)
        for h, e in got.items():
            k = e["steps"]
            la = e["launches"]
            want = {"bn_sums": BN_PER_FORWARD * k, "bn_stats": 0,
                    "bn_act": BN_PER_FORWARD * k}
            score = e["score_launches"]
            report = {key: list(v) for key, v in
                      e["sharding_report"].items()}
            if k != MESH_STEPS or la != want or score != {
                    "bn_sums": 0, "bn_stats": 0, "bn_act": BN_PER_FORWARD} \
                    or report != want_report[n] or \
                    e["batch"] != 64 // n or not np.isfinite(e["loss"]):
                raise AssertionError(
                    f"mesh epoch {epoch} {h}: steps {k}, launches {la} want "
                    f"{want}, score {score}, report {report} want "
                    f"{want_report[n]}, batch {e['batch']}, loss "
                    f"{e['loss']}")
            for key in want:
                tot[key] += la[key]
            tot["score_bn_act"] += score["bn_act"]
    for h in ("w0", "w1"):
        if (res[h]["mesh_rebuilds"], res[h]["resharded"]) != (2, 2):
            raise AssertionError(f"mesh {h}: {res[h]['mesh_rebuilds']} "
                                 f"rebuilds, {res[h]['resharded']} re-shards")
    boot = res["w2"]["bootstrap"]
    w0 = res["w0"]["epochs"][0]
    if boot != {"step": w0["step"], "sha256": w0["sha256"]}:
        raise AssertionError(f"mesh: the joiner bootstrapped from {boot}, "
                             f"rank 0's epoch-0 state is {w0['step']} "
                             f"{w0['sha256'][:16]}")
    e0 = res["w0"]["epochs"]
    print(f"mesh backend={e0[0]['backend']} ({e0[0]['backend_reason']}); "
          f"sharding_report n=2 {e0[0]['sharding_report']} n=3 "
          f"{e0[1]['sharding_report']} equal to the plain rule's; "
          f"survivors' mesh_rebuilds=2 resharded=2; the joiner started at "
          f"step {boot['step']} from sha256 {boot['sha256'][:16]}, rank 0's "
          f"epoch-0 end; launches a rank-step bn_sums={BN_PER_FORWARD} "
          f"bn_stats=0 bn_act={BN_PER_FORWARD}", flush=True)
    return tot


def _mesh_report(res, gpu) -> dict:
    """Worker 0's step, collective and rebuild times and the bytes it held,
    from its spans (the card's queue drained before each collective's
    span)."""
    sp = res["w0"]["spans"]
    k = MESH_STEPS
    steps = len(sp["step"])
    if steps != 3 * k or len(sp["mesh.bn_allreduce"]) != \
            MESH_BN_COLLECTIVES * steps or \
            len(sp["mesh.grad_allreduce"]) != steps:
        raise AssertionError(
            f"mesh worker 0 recorded {steps} steps, "
            f"{len(sp['mesh.bn_allreduce'])} BN and "
            f"{len(sp['mesh.grad_allreduce'])} gradient collectives; "
            f"expected {3 * k}, {MESH_BN_COLLECTIVES} and 1 a step")
    bn = np.asarray(sp["mesh.bn_allreduce"]).reshape(steps, -1).sum(1)
    out = {"epochs": []}
    for epoch, workers in ((0, 2), (1, 3), (2, 2)):
        lo, hi = epoch * k + 1, epoch * k + k  # past the epoch's first
        row = {"epoch": epoch, "workers": workers,
               "step_ms": float(np.median(sp["step"][lo:hi])),
               "first_step_ms": sp["step"][epoch * k],
               "grad_allreduce_ms": float(np.median(
                   sp["mesh.grad_allreduce"][lo:hi])),
               "bn_allreduce_ms": float(np.median(bn[lo:hi])),
               "memory_allocated": res["w0"]["epochs"][epoch][
                   "memory_allocated"]}
        if epoch:
            end = sp["mc_barrier_start"][epoch] + sp["mc_barrier"][epoch]
            row["barrier_to_first_step_ms"] = sp["step_start"][epoch * k] \
                - end
            row["rebuild_ms"] = sp["mesh.rebuild"][epoch - 1]
        out["epochs"].append(row)
        print(f"mesh {MESH_MODEL} {MESH_DTYPE} zero1+fsdp epoch {epoch} "
              f"workers={workers} step_ms={row['step_ms']:.3f} (median of "
              f"steps 2-{k}) first_step_ms={row['first_step_ms']:.3f} "
              f"grad_allreduce_ms={row['grad_allreduce_ms']:.3f} "
              f"bn_allreduce_ms_a_step={row['bn_allreduce_ms']:.3f} "
              f"({MESH_BN_COLLECTIVES} collectives) "
              + (f"barrier_to_first_step_ms="
                 f"{row['barrier_to_first_step_ms']:.3f} rebuild_ms="
                 f"{row['rebuild_ms']:.3f} " if epoch else "")
              + f"bytes_held_between_steps={row['memory_allocated']} "
              f"(worker 0's clock, {workers} processes share the card, "
              f"gloo); gpu={gpu}", flush=True)
    return out


def _mesh_pair_files(variables, tmp) -> list:
    """The inputs of (b) and the worker arguments that run it: the seeded
    weights (JAX layout), 64 seeded images, a rank's 32 rows each."""
    from torch_mesh_worker import flat_tree
    np.savez(f"{tmp}/init.npz", **flat_tree(variables))
    rng = np.random.RandomState(21)
    x = rng.uniform(-1, 1, (64, IMAGE, IMAGE, 3)).astype(np.float32)
    classes = 10 if MESH_MODEL == "resnet20" else 1000
    y = rng.randint(0, classes, 64).astype(np.int32)
    np.savez(f"{tmp}/pair.npz", x=x, y=y)
    for r in range(2):
        np.savez(f"{tmp}/data{r}.npz", x=x[32 * r:32 * r + 32],
                 y=y[32 * r:32 * r + 32])
    return ["--modes", "dp,zero1_fsdp,dp_f32", "--batch", "32",
            "--init-npz", f"{tmp}/init.npz", "--data-npz",
            f"{tmp}/data{{rank}}.npz", "--state-out",
            f"{tmp}/r{{rank}}_{{mode}}.npz"]


def _one_process_module(variables, dtype):
    """A ``MESH_MODEL`` ``Module`` in this process from the seeded weights,
    with the job's SGD."""
    import torch

    from dt_tpu_torch import models
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.training.module import Module
    dev = torch.device(MESH_DEVICE)
    mod = Module(models.create(
        MESH_MODEL, device=dev, dtype=getattr(torch, dtype),
        num_classes=10 if MESH_MODEL == "resnet20" else 1000),
        optimizer="sgd", optimizer_params=dict(
            learning_rate=0.025, momentum=0.9, weight_decay=1e-4),
        device=dev)
    mod.init_params()
    load_jax_variables(mod.model, variables)
    return mod


def _one_process_step(variables, x, y, dtype):
    """One step of ``MESH_MODEL`` over all of ``x`` in this process (cuDNN
    deterministic): ``(the state after it as flat JAX-layout numpy, the
    step's cross-entropy)``."""
    import torch
    from torch_mesh_worker import flat_tree

    from dt_tpu_torch.data import io
    from dt_tpu_torch.elastic.mesh_manager import snapshot_state
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mod = _one_process_module(variables, dtype)
        metric = mod.fit(io.NDArrayIter(x, y, batch_size=x.shape[0]),
                         num_epoch=1, eval_metric="ce")
        blob = snapshot_state(mod.state)
    finally:
        torch.backends.cudnn.deterministic = det
    return flat_tree({"params": blob["params"],
                      "batch_stats": blob["batch_stats"],
                      "mom": blob["opt_state"]["mom"]}), \
        dict(metric.get_name_value())["cross-entropy"]


def _batch_split_control(variables, x) -> dict:
    """The eval-mode ``MESH_DTYPE`` logits of the first half of ``x`` at
    that batch against the same rows inside the whole batch (cuDNN
    deterministic; BN from running stats, so the rows do not meet): how
    many differ and by how much.  A difference is the convolutions'
    arithmetic changing with the batch size."""
    import torch
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mod = _one_process_module(variables, MESH_DTYPE)
        half = len(x) // 2
        whole = mod.predict(x)[:half]
        part = mod.predict(x[:half])
    finally:
        torch.backends.cudnn.deterministic = det
    return {"differ": float(np.mean(whole != part)),
            "max_abs": float(np.abs(whole - part).max()),
            "max_abs_logit": float(np.abs(whole).max())}


def _mesh_pair(res, variables, tmp, gpu) -> dict:
    """(b): one step of the job's last world (2 ranks x 32 rows) from the
    seeded weights, in bf16 plain and ZeRO-1 + FSDP and in f32 plain,
    against one process's step over the 64 rows.  f32: the update, the
    momentum and the running stats within ``TOL_STEP``, the step's
    cross-entropy (the ranks' mean) within its ``loss`` limit.  bf16: one
    sha256 for both modes and ranks, params within ``TOL_STEP``, running
    stats and the cross-entropy within ``TOL_ASYNC_BF16``.  The f32
    comparison is the one that holds the update: bf16's update is printed
    beside two controls and not gated (one bf16 process moves it that far
    between two orders of the same rows and against f32)."""
    from torch_mesh_worker import flat_tree
    lines = [ln for h in ("w0", "w1") for ln in res[h]["pair"]]
    shas = {(ln["rank"], ln["mode"]): ln["sha256"] for ln in lines}
    if len({v for (r, m), v in shas.items() if m != "dp_f32"}) != 1 or \
            len({v for (r, m), v in shas.items() if m == "dp_f32"}) != 1:
        raise AssertionError(f"mesh pair: ranks or modes differ {shas}")
    mesh = {m: dict(np.load(f"{tmp}/r0_{m}.npz"))
            for m in ("dp", "zero1_fsdp", "dp_f32")}
    for key in mesh["dp"]:
        if not np.array_equal(mesh["dp"][key], mesh["zero1_fsdp"][key]):
            raise AssertionError(f"mesh pair: ZeRO-1 + FSDP differs from "
                                 f"plain data parallelism at {key}")
    with np.load(f"{tmp}/pair.npz") as z:
        x, y = z["x"], z["y"]
    one, one_loss = {}, {}
    for dt in (MESH_DTYPE, "float32"):
        one[dt], one_loss[dt] = _one_process_step(variables, x, y, dt)
    # the controls: one bf16 process over the same rows in another order,
    # and the batch size's own effect on the bf16 forward
    perm = np.random.RandomState(22).permutation(len(x))
    again, _ = _one_process_step(variables, x[perm], y[perm], MESH_DTYPE)
    split = _batch_split_control(variables, x)
    w0 = {k: np.asarray(v, np.float64) for k, v in flat_tree(
        {"params": variables["params"]}).items()}

    def leaves(state, coll, update=False):
        return {k: np.asarray(state[k], np.float64).ravel()
                - (w0[k].ravel() if update else 0.0)
                for k in sorted(one["float32"]) if k.startswith(coll + "/")}

    def norm_rel(a, b):  # over dicts of leaves, as one vector
        return float(np.sqrt(sum(np.square(a[k] - b[k]).sum() for k in b)
                             / sum(np.square(b[k]).sum() for k in b)))

    def max_rel(a, b):
        return float(max(np.abs(a[k] - b[k]).max() for k in b)
                     / max(np.abs(b[k]).max() for k in b))

    e = {}
    for key, dt, m in (("float32", "float32", "dp_f32"),
                       ("bfloat16", MESH_DTYPE, "dp")):
        a, b = mesh[m], one[dt]
        sa, sb = leaves(a, "batch_stats"), leaves(b, "batch_stats")
        loss = np.mean([ln["loss"] for ln in lines if ln["mode"] == m])
        e[key] = {"update": norm_rel(leaves(a, "params", True),
                                     leaves(b, "params", True)),
                  "params": norm_rel(leaves(a, "params"),
                                     leaves(b, "params")),
                  "mom": norm_rel(leaves(a, "mom"), leaves(b, "mom")),
                  "stats": norm_rel(sa, sb), "stats_max": max_rel(sa, sb),
                  "loss": abs(loss - one_loss[dt]) / abs(one_loss[dt])}
    u1 = leaves(one[MESH_DTYPE], "params", True)
    ub = leaves(mesh["dp"], "params", True)
    by_leaf = np.array([norm_rel({0: ub[k]}, {0: u1[k]}) for k in u1])
    ctrl = {"reordered": norm_rel(leaves(again, "params", True), u1),
            "vs_f32": norm_rel(u1, leaves(one["float32"], "params", True)),
            "leaves": [float(by_leaf.min()), float(np.median(by_leaf)),
                       float(by_leaf.max())]}
    held = {ln["mode"]: ln["memory_allocated"] for ln in res["w0"]["pair"]}
    print(f"mesh pair (b): one step of the job's last world, 2 ranks x 32 "
          f"rows, against one process on the 64 rows, from the seeded "
          f"weights: f32 update_rel_err={e['float32']['update']:.3e} (tol "
          f"{TOL_STEP['flat_g']}) mom={e['float32']['mom']:.3e} (tol "
          f"{TOL_STEP['mom']}) running_stats={e['float32']['stats']:.3e} "
          f"(tol {TOL_STEP['stats']}) ce_rel={e['float32']['loss']:.3e} "
          f"(tol {TOL_STEP['loss']}); bf16 (plain = ZeRO-1 + FSDP, one "
          f"sha256) params={e['bfloat16']['params']:.3e} (tol "
          f"{TOL_STEP['params']}) running_stats_max_rel="
          f"{e['bfloat16']['stats_max']:.3e} (tol "
          f"{TOL_ASYNC_BF16['stats']}) ce_rel={e['bfloat16']['loss']:.3e} "
          f"(tol {TOL_ASYNC_BF16['loss']}) update_norm_rel="
          f"{e['bfloat16']['update']:.3e} (a leaf's min / median / max "
          f"{' / '.join(f'{v:.3e}' for v in ctrl['leaves'])} over "
          f"{len(by_leaf)} leaves; not gated; one bf16 process "
          f"moves its update {ctrl['reordered']:.3e} over the rows "
          f"reordered and {ctrl['vs_f32']:.3e} against f32; the first "
          f"{len(x) // 2} rows' eval logits at batch {len(x) // 2} against "
          f"batch {len(x)}: {split['differ']:.3%} differ, max abs "
          f"{split['max_abs']:.3e} of {split['max_abs_logit']:.3f}); bytes "
          f"held after the step {json.dumps(held)}; gpu={gpu}", flush=True)
    bad = []
    if not (e["float32"]["update"] <= TOL_STEP["flat_g"]
            and e["float32"]["mom"] <= TOL_STEP["mom"]
            and e["float32"]["stats"] <= TOL_STEP["stats"]
            and e["float32"]["loss"] <= TOL_STEP["loss"]):
        bad.append(f"f32 {e['float32']}")
    if not (e["bfloat16"]["params"] <= TOL_STEP["params"]
            and e["bfloat16"]["stats_max"] <= TOL_ASYNC_BF16["stats"]
            and e["bfloat16"]["loss"] <= TOL_ASYNC_BF16["loss"]):
        bad.append(f"bf16 {e['bfloat16']}")
    if bad:
        raise AssertionError(f"mesh pair against one process: {bad}")
    return {"errs": e, "controls": ctrl, "batch_split": split,
            "held": held}


def mesh_phase(gpu, variables) -> dict:
    """Phase 20, the elastic mesh (see ``MESH_ARGS``): (a) the job 2 -> 3
    -> 2 against the port's scheduler, the joiner released by the launch
    callback and bootstrapping from rank 0's snapshot, the removed worker
    leaving through ``depart``; gates: one sha256 of the whole state over
    the live ranks at every epoch end, the survivors' ``mesh_rebuilds`` 2,
    the joiner's first state rank 0's epoch-0 one, 53 ``bn_sums``, no
    ``bn_stats`` and 53 ``bn_act`` a rank-step, 53 ``bn_act`` a rank's
    score, ``sharding_report`` the plain rule's at n 2 and 3, 106 BN
    collectives and one gradient collective a step on worker 0; (b)
    :func:`_mesh_pair`.  Prints the backend, step ms per membership, the
    collectives' ms, barrier-to-step ms after each rebuild and the bytes
    held with ZeRO-1 + FSDP and without.  The survivors run (b) after the
    job, over its last world."""
    import shutil
    import tempfile

    import torch_mesh_job as mjob
    tmp = tempfile.mkdtemp(prefix="dt_mesh_")
    try:
        pair = _mesh_pair_files(variables, tmp)
        res, audit, launched, wall = mjob.elastic_job(
            tmp, mesh_args() + MESH_ARGS + pair, MESH_TIMEOUT,
            env={"DT_OBS": "1", "DT_OBS_RING": "65536"})
        print(f"mesh job wall_s={wall:.1f} (with (b)'s steps: "
              f"{sum(ln['seconds'] for ln in res['w0']['pair']):.1f} s) "
              f"gpu={gpu}", flush=True)
        launches = _mesh_gates(res, audit, launched, gpu)
        out = _mesh_report(res, gpu)
        out["pair"] = _mesh_pair(res, variables, tmp, gpu)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(launches=launches, wall_s=wall)
    return out


def _parallel_world(gpu, tmp) -> list:
    """Phase 21 (a), (b)'s expert parallelism and (d) on 2 ranks of the
    card (``tests/torch_parallel_worker.py``'s ``card`` case): every gate
    but the one-process ones below."""
    import torch
    from torch_parallel_worker import flat, run_world

    from dt_tpu_torch import models
    lm = models.create("transformer_lm", device="cpu", **LM)
    pipe = models.create("transformer_lm_pipelined", device="cpu",
                         num_stages=PARALLEL_STAGES,
                         num_micro=PARALLEL_MICRO, **LM)
    inputs = dict(
        toks=np.random.RandomState(5).randint(
            0, LM["vocab_size"], (LM_BATCH, LM_SEQ)),
        steps=np.int64(PARALLEL_STEPS), moe_seed=np.int64(7),
        moe_experts=np.int64(PARALLEL_EXPERTS),
        stages=np.int64(PARALLEL_STAGES), micro=np.int64(PARALLEL_MICRO),
        **flat(seeded_lm_variables(lm, seed=0)["params"], "lm"),
        **flat(seeded_lm_variables(pipe, seed=1)["params"], "pipe"),
        **{f"cfg/{k}": np.int64(v) for k, v in LM.items()})
    del lm, pipe
    torch.cuda.empty_cache()  # the ranks are processes on the card
    ranks = run_world(tmp, "card", inputs, world=PARALLEL_RANKS,
                      timeout=PARALLEL_TIMEOUT, device="cuda")
    r0 = ranks[0]
    for part in ("ring", "ulysses", "pipe"):
        for r in ranks[1:]:  # the ranks compute the dense parts alike
            if r[part]["losses"] != r0[part]["losses"]:
                raise AssertionError(f"parallel {part}: the ranks' losses "
                                     f"differ {r[part]['losses']} against "
                                     f"{r0[part]['losses']}")
        err = r0[part]["f32_rel_err"]
        print(f"parallel {part} f32 logits against one process "
              f"rel_err={err:.3e} (tol {TOL_PARALLEL_F32}); bf16 fit "
              f"{PARALLEL_STEPS} steps; median step "
              f"{r0[part]['median_ms']:.3f} ms (steps "
              f"{[round(v, 3) for v in r0[part]['step_ms']]}); a rank "
              f"sent {r0[part]['p2p_bytes_a_step']} B point-to-point and "
              f"{r0[part]['a2a_bytes_a_step']} B all-to-all a step; "
              f"{r0[part]['seconds']:.1f} s gpu={gpu}", flush=True)
        _falling(f"parallel {part} bf16", r0[part]["losses"])
        if not err <= TOL_PARALLEL_F32:
            raise AssertionError(f"parallel {part}: f32 logits {err:.3e} "
                                 "off one process's")
    ep = r0["ep"]
    print(f"parallel ep: {PARALLEL_EXPERTS} experts over "
          f"{PARALLEL_RANKS} ranks ({ep['experts_here']} a rank), f32 "
          f"output against the one-process layer rel_err="
          f"{ep['rel_err']:.3e} (tol {TOL_EP_F32}) gpu={gpu}", flush=True)
    if not ep["rel_err"] <= TOL_EP_F32:
        raise AssertionError(f"parallel ep: {ep['rel_err']:.3e} off one "
                             "process's layer")
    print(f"parallel world launches a rank {[r['launches'] for r in ranks]}"
          f" (plain attention: no kernel); peak GB a rank "
          f"{[round(r.get('peak_mem_gb', 0), 3) for r in ranks]}",
          flush=True)
    return ranks


def _moe_one_process(dev, gpu) -> dict:
    """Phase 21 (b) in this process: the MoE LM (flash attention, 4
    experts, bf16) through ``Module.fit``, ``PARALLEL_STEPS`` steps of one
    batch: the loss finite and falling, the aux term positive, the router
    moved, ``num_layers`` flash launches a forward (counts reset just
    before the fit and read just after)."""
    import torch
    from torch_parallel_worker import shifted_loss

    from dt_tpu_torch import models
    from dt_tpu_torch.data import io
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.parallel.moe import aux_losses
    from dt_tpu_torch.training.module import Module
    model = models.create("transformer_lm", device=dev, seq_parallel="flash",
                          moe_experts=PARALLEL_EXPERTS, dtype=torch.bfloat16,
                          **LM)
    load_jax_variables(model, seeded_lm_variables(model, seed=3))
    router = model.block0.moe.router.weight.detach().clone()
    losses = []

    def loss_fn(logits, labels):
        loss = shifted_loss(logits, labels)
        losses.append(loss.detach())
        return loss

    mod = Module(model, loss_fn=loss_fn, optimizer="sgd",
                 optimizer_params=LM_SGD, device=dev)
    mod.init_params()
    load_jax_variables(model, seeded_lm_variables(model, seed=3))
    toks = np.random.RandomState(6).randint(0, LM["vocab_size"],
                                            (LM_BATCH, LM_SEQ))
    x = np.concatenate([toks] * PARALLEL_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_counts()  # the main path's run starts here
    mod.fit(io.NDArrayIter(x, x, batch_size=LM_BATCH), num_epoch=1,
            eval_metric="ce")
    counts = read_counts()  # ... and ends here
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = {k: 0 for k in counts}
    want["flash_attention"] = LM["num_layers"] * PARALLEL_STEPS
    _check_counts("parallel moe bf16", counts, want)
    losses = [float(v) for v in losses]
    _falling("parallel moe bf16", losses)
    aux = [float(a.detach()) for a in aux_losses(model)]
    moved = float((model.block0.moe.router.weight.detach() - router)
                  .abs().max())
    print(f"parallel moe bf16 aux (pre-weighted, a block)="
          f"{[round(a, 6) for a in aux]} router_moved_max={moved:.3e} "
          f"fit_s={seconds:.2f} gpu={gpu}", flush=True)
    if not (len(aux) == LM["num_layers"] and min(aux) > 0 and moved > 0):
        raise AssertionError(f"parallel moe: aux {aux}, router moved "
                             f"{moved}")
    del mod, model
    torch.cuda.empty_cache()
    return {"launches": counts, "losses": losses, "aux": aux,
            "seconds": seconds}


def _remat_pair(tag, make, x, y, loss_fn) -> dict:
    """One ``grad_step`` of ``make(remat)`` without and with remat from
    the same weights and batch (cuDNN deterministic): the flat gradients
    bit-equal, or their largest difference within the bf16 gradient
    limit ``TOL_ASYNC_BF16``; the running stats moved, once; peak bytes
    and launches of each."""
    import torch
    from dt_tpu_torch import optim
    from dt_tpu_torch.training.step import grad_step
    from dt_tpu_torch.training.train_state import TrainState
    out = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            model = make(remat)
            state = TrainState.create(model, optim.create("sgd", **LM_SGD))
            s0 = (state.layout.stats.ravel(state.batch_stats)
                  if state.layout.stats.size else None)
            grad_step(state, x, y, loss_fn)  # warm up, then from the start
            if s0 is not None:
                for name, t in state.layout.stats.unravel(s0).items():
                    state.batch_stats[name].copy_(t)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()  # the main path's run starts here
            flat_g, flat_s, _, _ = grad_step(state, x, y, loss_fn)
            counts = read_counts()  # ... and ends here
            torch.cuda.synchronize()
            out[remat] = {"g": flat_g, "s": flat_s, "s0": s0,
                          "peak": torch.cuda.max_memory_allocated(),
                          "launches": counts}
            del model, state
    finally:
        torch.backends.cudnn.deterministic = det
    g0, g1 = out[False]["g"], out[True]["g"]
    equal = bool(torch.equal(g0, g1))
    diff = float((g0 - g1).abs().max() / g0.abs().max())
    stats = None
    if out[False]["s0"] is not None:
        stats = {"equal": bool(torch.equal(out[False]["s"], out[True]["s"])),
                 "moved": bool(not torch.equal(out[True]["s"],
                                               out[True]["s0"]))}
    res = {"grads_bit_equal": equal, "grad_max_rel_diff": diff,
           "peak_bytes": {"plain": out[False]["peak"],
                          "remat": out[True]["peak"]},
           "launches": {"plain": out[False]["launches"],
                        "remat": out[True]["launches"]},
           "stats": stats}
    print(f"parallel remat {tag}: grads bit_equal={equal} max_rel_diff="
          f"{diff:.3e} (tol {TOL_ASYNC_BF16['grad']} unless equal) "
          f"max_memory_allocated plain={out[False]['peak']} remat="
          f"{out[True]['peak']} running_stats={stats} launches plain="
          f"{json.dumps(out[False]['launches'])} remat="
          f"{json.dumps(out[True]['launches'])}", flush=True)
    if not (equal or diff <= TOL_ASYNC_BF16["grad"]):
        raise AssertionError(f"parallel remat {tag}: gradients {diff:.3e} "
                             "apart")
    if stats is not None and not (stats["equal"] and stats["moved"]):
        raise AssertionError(f"parallel remat {tag}: running stats {stats}")
    return res


def _remat_phase(dev, variables, gpu) -> dict:
    """Phase 21 (c): the TransformerLM (flash, bf16) and ResNet-50 (bf16,
    batch 32) one step each without and with ``remat=True``
    (:func:`_remat_pair`); the recompute launches flash again in each of
    the 6 blocks and BN-train (pass 1 and pass 2) again in each of the 52
    BNs inside a residual block."""
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.training.step import classification_loss, \
        next_token_loss
    lm_vars = None

    def make_lm(remat):
        nonlocal lm_vars
        m = models.create("transformer_lm", device=dev, seq_parallel="flash",
                          dtype=torch.bfloat16, remat=remat, **LM)
        lm_vars = lm_vars or seeded_lm_variables(m, seed=0)
        return load_jax_variables(m, lm_vars)

    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, LM["vocab_size"], (LM_BATCH, LM_SEQ))).to(dev)
    lm = _remat_pair("lm", make_lm, toks, None, next_token_loss)
    want = {k: 0 for k in lm["launches"]["plain"]}
    _check_counts("parallel remat lm plain", lm["launches"]["plain"],
                  dict(want, flash_attention=LM["num_layers"]))
    _check_counts("parallel remat lm remat", lm["launches"]["remat"],
                  dict(want, flash_attention=2 * LM["num_layers"]))

    def make_resnet(remat):
        return load_jax_variables(models.create(
            "resnet50", device=dev, dtype=torch.bfloat16, remat=remat),
            variables)

    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.uniform(-1, 1, (BATCH, IMAGE, IMAGE, 3)).astype(
        np.float32)).to(dev).permute(0, 3, 1, 2).to(torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, 1000, BATCH)).to(dev)
    rn = _remat_pair("resnet50", make_resnet, x, y, classification_loss)
    in_blocks = BN_PER_FORWARD - 1  # all but the stem's
    _check_counts("parallel remat resnet50 plain", rn["launches"]["plain"],
                  dict(want, bn_stats=BN_PER_FORWARD, bn_act=BN_PER_FORWARD))
    _check_counts("parallel remat resnet50 remat", rn["launches"]["remat"],
                  dict(want, bn_stats=BN_PER_FORWARD + in_blocks,
                       bn_act=BN_PER_FORWARD + in_blocks))
    torch.cuda.empty_cache()
    return {"lm": lm, "resnet50": rn}


def parallel_phase(gpu, dev, variables) -> dict:
    """Phase 21, the parallel layer: (a) ring then Ulysses and (d) the
    pipeline over 2 ranks of the card, with (b)'s expert parallelism
    (:func:`_parallel_world`); (b) the MoE LM in this process
    (:func:`_moe_one_process`); (c) remat (:func:`_remat_phase`)."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dt_parallel_")
    try:
        ranks = _parallel_world(gpu, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t_world = time.perf_counter() - t0
    t1 = time.perf_counter()
    moe = _moe_one_process(dev, gpu)
    t_moe = time.perf_counter() - t1
    t1 = time.perf_counter()
    remat = _remat_phase(dev, variables, gpu)
    t_remat = time.perf_counter() - t1
    total = time.perf_counter() - t0
    print(f"parallel phase: world (a, b's EP, d) {t_world:.1f} s, moe (b) "
          f"{t_moe:.1f} s, remat (c) {t_remat:.1f} s, total {total:.1f} s "
          f"gpu={gpu}", flush=True)
    launches = {k: moe["launches"][k]
                + remat["lm"]["launches"]["plain"][k]
                + remat["lm"]["launches"]["remat"][k]
                + remat["resnet50"]["launches"]["plain"][k]
                + remat["resnet50"]["launches"]["remat"][k]
                for k in moe["launches"]}
    return {"world": ranks, "moe": moe, "remat": remat,
            "launches": launches, "seconds": total}


# Phase 22, the optimizers (dt_tpu_torch.optim) on the card: (a) ResNet-50
# v1 bf16 through Module.fit as examples/common.py:115-126 builds it (sgd,
# momentum 0.9, wd 1e-4, a MultiFactorScheduler, multi_precision) at batch
# 32, one epoch of OPT_FIT_STEPS steps on one seeded batch, beside the same
# fit without multi_precision; (b) the TransformerLM of LM under adam at
# examples/train_transformer_lm.py's lr, OPT_LM_STEPS steps on one batch,
# then as many under multi_precision; (c) one update of every registered
# name (and rmsprop centered) over ResNet-50's 161 parameters from seeded
# gradients, card against the same code on the CPU; (d) ZeRO-1 with adam
# over 2 gloo ranks of the card, one f32 step; (e) (b)'s checkpoint round
# trip.
OPT_FIT_STEPS = 6
OPT_FIT_DROP = [3]  # the schedule drops by 10 after update 3
OPT_LM_STEPS = 5
OPT_LM_ADAM = {"learning_rate": 3e-4}
OPT_RULES = {
    "sgd": ("sgd", dict(learning_rate=0.01, momentum=0.9,
                        weight_decay=1e-4)),
    "nag": ("nag", {}), "adam": ("adam", dict(weight_decay=1e-4)),
    "adagrad": ("adagrad", {}), "rmsprop": ("rmsprop", {}),
    "rmsprop_centered": ("rmsprop", dict(centered=True, momentum=0.9)),
    "adadelta": ("adadelta", {}), "ftrl": ("ftrl", {}),
    "adamax": ("adamax", {}), "nadam": ("nadam", {}),
    "signum": ("signum", {}), "signsgd": ("signsgd", {}),
    "ftml": ("ftml", {}), "sgld": ("sgld", dict(learning_rate=1e-4)),
    "dcasgd": ("dcasgd", dict(momentum=0.9)),
    "lbsgd": ("lbsgd", dict(eta=0.01)),
    "lamb": ("lamb", dict(weight_decay=1e-4))}
# card against CPU, per leaf of the max |value|: the elementwise rules are
# the same f32 ops on both, a last bit apart where one device divides by a
# scalar as a product with its reciprocal (up to 4.9e-7 on an H100);
# ftrl's soft threshold z - lamda1 cancels, so such a bit grows (3.5e-6);
# lbsgd's and lamb's norms sum in another order
TOL_OPT_CARD = {"ftrl": 1e-5, "lbsgd": 1e-5, "lamb": 1e-5}
OPT_ZERO_ADAM = {"learning_rate": 1e-4, "weight_decay": 1e-4}
OPT_ZERO_TIMEOUT = 240  # s, the 2-rank world


def _median_ms(times) -> float:
    return float(np.median(times)) * 1e3 if len(times) else float("nan")


def _opt_fit(dev, mp: bool, images, labels) -> dict:
    """(a) one run: a fresh ResNet-50 bf16 ``Module`` (``init_params(seed=
    0)``) fit for one epoch of the tiled batch; per-step cross-entropy from
    the running metric, step times from the batch-end callbacks (one step
    behind the launch), the launches of the fit."""
    import torch
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.data import io
    from dt_tpu_torch.training.module import Module
    sched = optim.MultiFactorScheduler(
        steps=OPT_FIT_DROP, factor=0.1, base_lr=FIT_SGD["learning_rate"])
    mod = Module(models.create("resnet50", device=dev, dtype=torch.bfloat16),
                 optimizer="sgd",
                 optimizer_params={"learning_rate": sched, "momentum": 0.9,
                                   "weight_decay": 1e-4,
                                   "multi_precision": mp},
                 device=dev, seed=0)
    mod.init_params()
    ends, cum = [], []

    def on_batch(param):
        ends.append(time.perf_counter())
        cum.append(dict(param.eval_metric.get_name_value())["cross-entropy"])

    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
    mod.fit(io.NDArrayIter(images, labels, batch_size=BATCH),
            eval_metric="ce", num_epoch=1, batch_end_callback=on_batch)
    torch.cuda.synchronize()
    counts = read_counts()  # ... and ends here
    losses = [cum[0]] + [cum[k] * (k + 1) - cum[k - 1] * k
                         for k in range(1, len(cum))]
    return {"mod": mod, "counts": counts, "losses": losses,
            "step_ms": _median_ms(np.diff(ends))}


def _opt_fit_phase(dev, gpu) -> dict:
    """(a): the multi-precision fit and the plain one; gates on the first:
    the loss finite and falling, 53 ``bn_stats`` and 53 ``bn_act`` a step,
    the state ``{"master", "inner"}``, and one more update on the card
    leaving every f32 param at ``w + (master - w)`` of that step."""
    import torch
    rng = np.random.RandomState(31)
    x = rng.uniform(-1, 1, (BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    y = rng.randint(0, 1000, BATCH).astype(np.int32)
    images = np.tile(x, (OPT_FIT_STEPS, 1, 1, 1))
    labels = np.tile(y, OPT_FIT_STEPS)
    out = {}
    for mp in (True, False):
        run = _opt_fit(dev, mp, images, labels)
        tag = f"optim (a) fit bf16 multi_precision={mp}"
        want = {k: 0 for k in run["counts"]}
        want.update(bn_stats=BN_PER_FORWARD * OPT_FIT_STEPS,
                    bn_act=BN_PER_FORWARD * OPT_FIT_STEPS)
        _check_counts(tag, run["counts"], want)
        _falling(tag, run["losses"])
        print(f"{tag} median_step_ms={run['step_ms']:.3f} gpu={gpu}",
              flush=True)
        if mp:
            st = run["mod"].state
            if set(st.opt_state) != {"master", "inner"}:
                raise AssertionError(f"{tag}: state {sorted(st.opt_state)}")
            g = torch.Generator(device=dev).manual_seed(5)
            grads = {n: torch.randn(p.shape, generator=g, device=dev) * 1e-3
                     for n, p in st.params.items()}
            before = {n: p.detach().clone() for n, p in st.params.items()}
            st.apply_gradients(grads)
            master = st.opt_state["master"]
            bad = [n for n, p in st.params.items()
                   if p.dtype == torch.float32 and not torch.equal(
                       p, before[n] + (master[n] - before[n]))]
            print(f"{tag} one more update: {len(st.params) - len(bad)} of "
                  f"{len(st.params)} f32 params at w + (master - w)",
                  flush=True)
            if bad:
                raise AssertionError(f"{tag}: params off w + (master - w): "
                                     f"{bad[:3]}")
        out[mp] = {k: run[k] for k in ("counts", "losses", "step_ms")}
        del run
        torch.cuda.empty_cache()
    return out


def _state_bytes(state) -> int:
    """Bytes of a train state's optimizer state: its slots' tensors and
    its other leaves as the JAX state holds them (int32 counts)."""
    from dt_tpu_torch.optim.state import export_leaf, leaves, slots
    names = set(state.params)
    return sum(t.numel() * t.element_size()
               for _, s in slots(state.opt_state, names)
               for t in s.values()) + sum(
        export_leaf(v).nbytes for v in leaves(state.opt_state, names))


def _opt_lm_phase(dev, gpu) -> dict:
    """(b) and (e): the TransformerLM at full width (flash, bf16) under
    adam, OPT_LM_STEPS steps on one batch, then as many under adam with
    multi_precision (the bf16 ``pos_embed`` gets an f32 master); each run
    6 ``flash_attention`` launches a forward and its loss falling.  Then
    (e): the multi-precision state saved (async, through the pinned
    buffers), loaded into a fresh model's state (bit-equal), and one more
    step of each bit-equal."""
    import tempfile
    import torch
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.optim.state import slots as opt_slots
    from dt_tpu_torch.training import checkpoint
    from dt_tpu_torch.training.step import next_token_loss, train_step
    from dt_tpu_torch.training.train_state import TrainState

    def make():
        return models.create("transformer_lm", device=dev,
                             seq_parallel="flash", dtype=torch.bfloat16,
                             **LM)

    model = make()
    load_jax_variables(model, seeded_lm_variables(model, seed=0))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, LM["vocab_size"], (LM_BATCH, LM_SEQ))).to(dev)
    out = {}
    state = None
    for mp in (False, True):
        state = TrainState.create(model, optim.create(
            "adam", multi_precision=mp, **OPT_LM_ADAM))
        tag = f"optim (b) lm adam multi_precision={mp}"
        torch.cuda.synchronize()
        reset_counts()  # the main path's run starts here
        losses, times = [], []
        for _ in range(OPT_LM_STEPS):
            t0 = time.perf_counter()
            losses.append(float(train_step(state, tokens, None,
                                           loss_fn=next_token_loss)[1]))
            times.append(time.perf_counter() - t0)
        counts = read_counts()  # ... and ends here
        want = {k: 0 for k in counts}
        want["flash_attention"] = LM["num_layers"] * OPT_LM_STEPS
        _check_counts(tag, counts, want)
        _falling(tag, losses)
        nbytes = _state_bytes(state)
        print(f"{tag} median_step_ms={_median_ms(times[1:]):.3f} "
              f"first_step_ms={times[0] * 1e3:.3f} opt_state_bytes={nbytes} "
              f"gpu={gpu}", flush=True)
        out[mp] = {"counts": counts, "losses": losses, "state_bytes": nbytes,
                   "step_ms": _median_ms(times[1:])}
    # (e) the checkpoint round trip of the multi-precision state
    names = set(state.params)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "lm")
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(prefix, state.step, state,
                                   async_save=True).result()
        save_s = time.perf_counter() - t0
        fresh = TrainState.create(make(), optim.create(
            "adam", multi_precision=True, **OPT_LM_ADAM))
        t0 = time.perf_counter()
        tag_step, _ = checkpoint.load_latest_checkpoint(prefix, fresh)
        load_s = time.perf_counter() - t0

    def same(a, b, what):
        bad = [n for n in a if not torch.equal(a[n], b[n])]
        if bad:
            raise AssertionError(f"optim (e) {what} differ after the "
                                 f"round trip: {bad[:3]}")

    def check(what):
        if fresh.step != state.step:
            raise AssertionError(f"optim (e) {what}: step {fresh.step} != "
                                 f"{state.step}")
        same(state.params, fresh.params, f"{what} params")
        for (path, a), (_, b) in zip(opt_slots(state.opt_state, names),
                                     opt_slots(fresh.opt_state, names)):
            same(a, b, f"{what} {'/'.join(path)}")
        if state.opt_state["inner"]["count"] != \
                fresh.opt_state["inner"]["count"]:
            raise AssertionError(f"optim (e) {what}: counts differ")

    check("loaded")
    reset_counts()
    la = float(train_step(state, tokens, None, loss_fn=next_token_loss)[1])
    lb = float(train_step(fresh, tokens, None, loss_fn=next_token_loss)[1])
    counts = read_counts()
    check("after one more step")
    if la != lb:
        raise AssertionError(f"optim (e) the next step's loss {lb} != {la}")
    print(f"optim (e) checkpoint of the adam + multi_precision LM state: "
          f"tag {tag_step}, save {save_s:.3f} s (async, pinned), load "
          f"{load_s:.3f} s, state bit-equal, one more step bit-equal "
          f"(loss {la:.6f}) gpu={gpu}", flush=True)
    out["roundtrip"] = {"counts": counts, "save_s": save_s,
                        "load_s": load_s}
    del model, state, fresh, tokens
    torch.cuda.empty_cache()
    return out


def _opt_rules_phase(dev, variables, gpu) -> dict:
    """(c): every rule of :data:`OPT_RULES`, one update over ResNet-50's
    161 parameters (seeded weights, seeded gradients of 1e-2) on the card
    and on the CPU: params and every state leaf within the rule's
    tolerance (sgld: its key equal, its noise's mean and standard
    deviation within 4 sigma of N(0, lr)); then the update's device time
    (CUDA events around each of 5 more updates, the median)."""
    import torch
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    cpu = load_jax_variables(models.create("resnet50", device="cpu"),
                             variables)
    w0 = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    del cpu
    rng = np.random.RandomState(41)
    g0 = {n: torch.from_numpy(rng.normal(0, 1e-2, p.shape).astype(
        np.float32)) for n, p in w0.items()}
    n_elems = sum(p.numel() for p in w0.values())
    out = {}
    for case, (name, kw) in OPT_RULES.items():
        sides = []
        for d in (dev, torch.device("cpu")):
            params = {n: p.to(d, copy=True) for n, p in w0.items()}
            grads = {n: g.to(d) for n, g in g0.items()}
            tx = optim.create(name, **kw)
            state = tx.update(grads, tx.init(params), params)
            sides.append((tx, params, grads, state))
        (tx, pc, gc, sc), (_, pk, _, sk) = sides
        tol = TOL_OPT_CARD.get(case, 1e-6)
        worst = 0.0
        if name == "sgld":
            lr = float(np.float32(kw["learning_rate"]))
            noise = torch.cat([(pc[n] - w0[n].to(dev)
                                + gc[n] * np.float32(lr / 2)).reshape(-1)
                               for n in pc]).double()
            mean, std = float(noise.mean()), float(noise.std())
            sigma = np.sqrt(lr)
            if abs(mean) > 4 * sigma / np.sqrt(n_elems) or \
                    abs(std - sigma) > 4 * sigma / np.sqrt(2 * n_elems):
                raise AssertionError(f"optim (c) sgld noise mean {mean} std "
                                     f"{std}, expected N(0, {sigma}^2)")
            if not np.array_equal(sc["mom"], sk["mom"]):
                raise AssertionError("optim (c) sgld: the keys differ")
            worst = abs(std - sigma) / sigma
        else:
            def pairs(a, b, prefix=""):
                for k, v in b.items():
                    if isinstance(v, dict):
                        yield from pairs(a[k], v, prefix + k + "/")
                    else:
                        yield prefix + k, a[k], v
            for what, a, b in list(pairs(pc, pk)) + list(pairs(sc, sk)):
                if isinstance(b, torch.Tensor):
                    scale = float(b.abs().max())
                    err = float((a.cpu() - b).abs().max())
                    worst = max(worst, err / max(scale, 1e-30))
                    if err > tol * scale:
                        raise AssertionError(f"optim (c) {case} {what}: "
                                             f"{err} of {scale}, tol {tol}")
                elif np.asarray(a).tobytes() != np.asarray(b).tobytes():
                    raise AssertionError(f"optim (c) {case} {what}: {a} "
                                         f"!= {b}")
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sc = tx.update(gc, sc, pc)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[case] = {"ms": float(np.median(times)), "max_rel_err": worst}
        print(f"optim (c) {case}: one update of {len(pc)} params "
              f"({n_elems} f32) card vs CPU max_rel_err={worst:.3e} (tol "
              f"{tol if name != 'sgld' else '4 sigma'}) update_ms="
              f"{out[case]['ms']:.3f} (median of 5, CUDA events) gpu={gpu}",
              flush=True)
        del sides, pc, pk, gc, sc, sk
        torch.cuda.empty_cache()
    return out


def _opt_zero_phase(variables, gpu, dev) -> dict:
    """(d): ZeRO-1 with adam over 2 gloo ranks of the card
    (``tests/torch_mesh_worker.py``, modes ``dp_f32`` and ``zero1_f32``),
    ResNet-50 f32 at global batch 64 (32 rows a rank), one step from the
    seeded weights: one sha256 over the ranks in each mode, ZeRO-1's
    state equal to plain data parallelism's bit for bit (Adam is
    elementwise), and against one process's step over the 64 rows: the
    moments (``a`` = 0.1 g, ``b`` = 0.001 g^2) and the running stats
    within the f32 limits of phase 20's pair (``TOL_STEP``: the 2-rank
    gradient holds one process's to ~2e-2).  The update, ``-lr*g/(|g| +
    eps)``, is printed, not gated: where |g| is at the two runs' noise it
    is +-lr on the sign of that noise.  Prints the bytes each rank holds
    after its step in both modes."""
    import shutil
    import tempfile
    import torch
    from torch_mesh_job import run_world
    from torch_mesh_worker import flat_tree

    from dt_tpu_torch import models
    from dt_tpu_torch.data import io
    from dt_tpu_torch.elastic.mesh_manager import snapshot_state
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.training.module import Module
    tmp = tempfile.mkdtemp(prefix="dt_optim_zero_")
    try:
        np.savez(f"{tmp}/init.npz", **flat_tree(variables))
        rng = np.random.RandomState(23)
        x = rng.uniform(-1, 1, (64, IMAGE, IMAGE, 3)).astype(np.float32)
        y = rng.randint(0, 1000, 64).astype(np.int32)
        for r in range(2):
            np.savez(f"{tmp}/data{r}.npz", x=x[32 * r:32 * r + 32],
                     y=y[32 * r:32 * r + 32])
        t0 = time.perf_counter()
        ranks = run_world(tmp, 2, [
            "--model", "resnet50", "--dtype", "float32", "--device", dev.type,
            "--image-size", str(IMAGE), "--deterministic", "--modes",
            "dp_f32,zero1_f32", "--batch", "32", "--init-npz",
            f"{tmp}/init.npz", "--data-npz", f"{tmp}/data{{rank}}.npz",
            "--out", f"{tmp}/r{{rank}}_{{mode}}.npz", "--optimizer", "adam",
            "--opt-params", json.dumps(OPT_ZERO_ADAM)],
            timeout=OPT_ZERO_TIMEOUT)
        world_s = time.perf_counter() - t0
        lines = [ln for r in ranks for ln in r]
        for mode in ("dp_f32", "zero1_f32"):
            shas = {ln["sha256"] for ln in lines if ln["mode"] == mode}
            if len(shas) != 1:
                raise AssertionError(f"optim (d) {mode}: ranks differ")
        dp = dict(np.load(f"{tmp}/r0_dp_f32.npz"))
        zero = dict(np.load(f"{tmp}/r0_zero1_f32.npz"))
        bad = [k for k in dp if not np.array_equal(dp[k], zero[k])]
        if bad or set(dp) != set(zero):
            raise AssertionError(f"optim (d) ZeRO-1 differs from plain "
                                 f"data parallelism at {bad[:3]}")
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            mod = Module(models.create("resnet50", device=dev),
                         optimizer="adam", optimizer_params=OPT_ZERO_ADAM,
                         device=dev)
            mod.init_params()
            load_jax_variables(mod.model, variables)
            mod.fit(io.NDArrayIter(x, y, batch_size=64), num_epoch=1,
                    eval_metric="ce")
            blob = snapshot_state(mod.state)
        finally:
            torch.backends.cudnn.deterministic = det
        one = flat_tree({"params": blob["params"],
                         "batch_stats": blob["batch_stats"],
                         "opt_state": blob["opt_state"]})
        del mod, blob
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    w0 = flat_tree({"params": variables["params"]})

    def rel(prefix, base=None):
        keys = sorted(k for k in one if k.startswith(prefix))
        a = np.concatenate([zero[k].ravel().astype(np.float64)
                            - (base[k[len(prefix):]].ravel()
                               if base else 0.0) for k in keys])
        b = np.concatenate([one[k].ravel().astype(np.float64)
                            - (base[k[len(prefix):]].ravel()
                               if base else 0.0) for k in keys])
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    w0p = {k[len("params/"):]: np.asarray(v, np.float64)
           for k, v in w0.items()}
    errs = {"update": rel("params/", w0p), "a": rel("opt_state/a/"),
            "b": rel("opt_state/b/"), "stats": rel("batch_stats/")}
    held = {ln["mode"]: ln["memory_allocated"] for ln in ranks[0]}
    launches = {m: [ln["launches"] for ln in lines if ln["mode"] == m]
                for m in ("dp_f32", "zero1_f32")}
    print(f"optim (d) ZeRO-1 adam 2 gloo ranks x 32 rows, ResNet-50 f32: "
          f"world {world_s:.1f} s, one sha256 a mode, ZeRO-1 = plain bit "
          f"for bit; against one process on the 64 rows: a "
          f"{errs['a']:.3e} (tol {TOL_STEP['flat_g']}) b {errs['b']:.3e} "
          f"(tol {2 * TOL_STEP['flat_g']}) update {errs['update']:.3e} "
          f"(not gated) running_stats {errs['stats']:.3e} (tol "
          f"{TOL_STEP['stats']}); bytes held after the step by rank 0 "
          f"{json.dumps(held)}; launches {json.dumps(launches)} gpu={gpu}",
          flush=True)
    if not (errs["a"] <= TOL_STEP["flat_g"]
            and errs["b"] <= 2 * TOL_STEP["flat_g"]
            and errs["stats"] <= TOL_STEP["stats"]):
        raise AssertionError(f"optim (d) against one process: {errs}")
    for m, per_rank in launches.items():
        for c in per_rank:
            if c != {"bn_sums": BN_PER_FORWARD, "bn_stats": 0,
                     "bn_act": BN_PER_FORWARD}:
                raise AssertionError(f"optim (d) {m} launches {c}")
    return {"errs": errs, "held": held, "launches": launches,
            "world_s": world_s}


def optim_phase(gpu, dev, variables) -> dict:
    """Phase 22, the optimizers: (a) :func:`_opt_fit_phase`, (b) and (e)
    :func:`_opt_lm_phase`, (c) :func:`_opt_rules_phase`, (d)
    :func:`_opt_zero_phase`.  Each part's time and the phase's."""
    t0 = time.perf_counter()
    times = {}
    t = time.perf_counter()
    fit = _opt_fit_phase(dev, gpu)
    times["a"] = time.perf_counter() - t
    t = time.perf_counter()
    lm = _opt_lm_phase(dev, gpu)
    times["b_e"] = time.perf_counter() - t
    t = time.perf_counter()
    rules = _opt_rules_phase(dev, variables, gpu)
    times["c"] = time.perf_counter() - t
    t = time.perf_counter()
    zero = _opt_zero_phase(variables, gpu, dev)
    times["d"] = time.perf_counter() - t
    total = time.perf_counter() - t0
    print(f"optim phase: fit (a) {times['a']:.1f} s, lm + checkpoint (b, "
          f"e) {times['b_e']:.1f} s, rules (c) {times['c']:.1f} s, zero "
          f"(d) {times['d']:.1f} s, total {total:.1f} s gpu={gpu}",
          flush=True)
    launches = {k: fit[True]["counts"][k] + lm[False]["counts"][k]
                + lm[True]["counts"][k] + lm["roundtrip"]["counts"][k]
                for k in fit[True]["counts"]}
    return {"fit": fit, "lm": lm, "rules": rules, "zero": zero,
            "launches": launches, "seconds": total}


# --- phase 23: the data pipeline and the recurrent cells ---------------------
DATA_RECORDS = 320  # seeded raw u8 records of DATA_RAW^2 x 3 (~63 MB)
DATA_RAW = 256  # stored side; FusedCropMirrorNormalize crops IMAGE from it
DATA_STEPS = 8  # one epoch of the .rec-fed fit
DATA_CLASSES = 10  # labels used of the 1000, each with its own colour
IMAGENET_MEAN = [123.68, 116.779, 103.939]
IMAGENET_STD = [58.393, 57.12, 57.375]
DATA_TIME_BATCHES = 4  # batches timed for the iterator's images/s
SD_RATE = 0.5  # examples/train_stochastic_depth.py --death-rate
SD_RECORDS = 512  # 32x32x3 raw u8 "shapes" records, 3 classes
SD_BATCH = 64
SD_EPOCHS = 2
SD_SGD = dict(learning_rate=0.05, momentum=0.9)  # the example's
SD_BLOCKS = 7  # resnet20's identity-shortcut blocks (9 less 2 downsampling)
RESNET20_BN = 19
# kernel BN against plain BN on the card, the same keeps, f32 logits: pass 1
# sums in another order (1e-6 relative a BN), through 19 BNs; of the largest
TOL_SD_PLAIN = 1e-4
RNN = dict(emsize=200, hidden=200, layers=2, bptt=35, batch=32)  # PTB's
# bidirectional_lstm with the kernels against fused=False on the card, of
# each output's or gradient's largest: f32 sums in another order (5.9e-7
# measured on an H100); in bf16 each step's h and c round to bf16, so a
# last-bit difference in the f32 gates (the kernel's exp against torch's)
# moves a bf16 value by an ulp (2^-8 relative) and the backward's 35 steps
# carry it (6.6e-3 measured in the gradients)
TOL_BILSTM = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
TOL_GRU_CARD = 1e-5  # gru, card against the CPU, f32, of the largest
NER = dict(vocab_words=200, entities=40, sentence=12, sentences=256,
           embed=32, hidden=32, lr=3e-3, steps=20, batch=32)
LOADER = dict(images=512, batch=64, workers=2)
LOADER_TIMEOUT_S = 120.0  # the MNIST and DataLoader fits together


def _record_ids(batch) -> list:
    """Record ids written into pixel (0, 0) of each real row (u8 batch)."""
    d = np.asarray(batch.data)[:len(batch.data) - batch.pad]
    return (d[:, 0, 0, 0].astype(int) + 256 * d[:, 0, 0, 1].astype(int)) \
        .tolist()


def _data_rec_fit(tmp, dev, gpu, fitted) -> dict:
    """(a) ResNet-50 v1 bf16 ``Module.fit`` fed from a ``.rec`` as
    ``examples/common.py:74-126`` builds it."""
    import os
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch.data import augment, io, recordio
    from dt_tpu_torch.training.module import Module
    path = str(Path(tmp) / "train.rec")
    rng = np.random.RandomState(23)
    # a class's colour under u8 noise: learnable, so the loss can fall
    colours = rng.randint(32, 192, (DATA_CLASSES, 1, 1, 3)).astype(np.uint8)
    t = time.perf_counter()
    with recordio.RecordIOWriter(path) as w:
        for i in range(DATA_RECORDS):
            img = rng.randint(0, 64, (DATA_RAW, DATA_RAW, 3), np.uint8) \
                + colours[i % DATA_CLASSES]
            img[0, 0, :2] = (i % 256, i // 256)  # the record's id
            w.write(recordio.pack_label(img.tobytes(), i % DATA_CLASSES,
                                        rec_id=i))
    write_s = time.perf_counter() - t
    size = Path(path).stat().st_size
    threads = min(os.cpu_count() or 1, 16)
    aug = augment.FusedCropMirrorNormalize((IMAGE, IMAGE), IMAGENET_MEAN,
                                           IMAGENET_STD)

    def rec_iter(**kw):
        kw = {"shuffle": True, "augmenter": aug, "seed": 0,
              "dtype": "bfloat16", **kw}
        return recordio.ImageRecordIter(path, (DATA_RAW, DATA_RAW, 3), BATCH,
                                        **kw)

    # the pooled decode against the serial one, byte for byte, then the
    # iterator's own rate (no consumer) at 1 thread and at the pool's
    rate = {}
    firsts = {}
    for n in (1, threads):
        it = rec_iter(num_decode_threads=n)
        firsts[n] = [it.next() for _ in range(2)]
        t = time.perf_counter()
        for _ in range(DATA_TIME_BATCHES):
            it.next()
        rate[n] = DATA_TIME_BATCHES * BATCH / (time.perf_counter() - t)
        it.close()
    for a, b in zip(firsts[1], firsts[threads]):
        if not (a.data.dtype == torch.bfloat16 and torch.equal(a.data, b.data)
                and np.array_equal(a.label, b.label) and a.pad == b.pad):
            raise AssertionError(f"data (a): {threads} decode threads gave "
                                 "other batches than one")
    shards = []
    for part in range(2):
        it = recordio.ImageRecordIter(path, (DATA_RAW, DATA_RAW, 3), BATCH,
                                      shuffle=True, num_parts=2,
                                      part_index=part, dtype="uint8",
                                      num_decode_threads=threads)
        shards.append([i for b in it for i in _record_ids(b)])
        it.close()
    a, b = set(shards[0]), set(shards[1])
    print(f"data (a) .rec {DATA_RECORDS} records {size} B written in "
          f"{write_s:.2f} s; iterator images/s (FusedCropMirrorNormalize "
          f"{IMAGE}, bf16 batches of {BATCH}) 1 thread {rate[1]:.1f}, "
          f"{threads} threads {rate[threads]:.1f}; first 2 batches equal "
          f"at 1 and {threads} threads; shards of num_parts=2: "
          f"{len(shards[0])} + {len(shards[1])} records, overlap "
          f"{len(a & b)}", flush=True)
    if a & b or a | b != set(range(DATA_RECORDS)) or \
            len(shards[0]) + len(shards[1]) != DATA_RECORDS:
        raise AssertionError("data (a): the two shards are not disjoint and "
                             "exhaustive")

    inner = rec_iter(num_decode_threads=threads)
    train = io.ResizeIter(io.PrefetchingIter(inner), DATA_STEPS)
    mod = Module(models.create("resnet50", device=dev, dtype=torch.bfloat16),
                 optimizer="sgd",
                 optimizer_params={"learning_rate": FIT_SGD["learning_rate"],
                                   "momentum": 0.9, "weight_decay": 1e-4,
                                   "multi_precision": True},
                 device=dev, seed=0)
    mod.init_params()
    ends, cum = [], []

    def on_batch(param):
        ends.append(time.perf_counter())
        cum.append(dict(param.eval_metric.get_name_value())["cross-entropy"])

    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
    mod.fit(train, eval_metric="ce", num_epoch=1, batch_end_callback=on_batch)
    torch.cuda.synchronize()
    counts = read_counts()  # ... and ends here
    tag = "data (a) .rec-fed fit ResNet-50 bf16"
    want = {k: 0 for k in counts}
    want.update(bn_stats=BN_PER_FORWARD * DATA_STEPS,
                bn_act=BN_PER_FORWARD * DATA_STEPS)
    _check_counts(tag, counts, want)
    losses = [cum[0]] + [cum[k] * (k + 1) - cum[k - 1] * k
                         for k in range(1, len(cum))]
    _falling(tag, losses)
    step_ms = _median_ms(np.diff(ends))
    inner.close()
    # one profiled 2-step epoch against the same epoch unprofiled
    inner = rec_iter(num_decode_threads=threads)
    short = io.ResizeIter(io.PrefetchingIter(inner), 2)
    torch.cuda.synchronize()
    t = time.perf_counter()
    mod.fit(short, num_epoch=1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    prof = profile_fn(lambda: mod.fit(short, num_epoch=1), wall_ms,
                      "data (a) .rec-fed fit 2-step epoch")
    inner.close()
    print(f"{tag} median_step_ms={step_ms:.3f} (phase 10's NDArrayIter fit "
          f"of ResNet-50 bf16 at batch {BATCH}: {fitted['step_ms']:.3f}) "
          f"imgs_per_s={BATCH * 1e3 / step_ms:.1f} gpu={gpu}", flush=True)
    del mod
    torch.cuda.empty_cache()
    return {"counts": counts, "losses": losses, "step_ms": step_ms,
            "phase10_step_ms": fitted["step_ms"], "imgs_per_s_1": rate[1],
            f"imgs_per_s_{threads}": rate[threads], "threads": threads,
            "rec_bytes": size, **prof}


def _shapes_rec(path: str, n: int, seed: int) -> None:
    """``examples/train_stochastic_depth.py``'s shapes at 32x32, as raw u8
    records: a vertical bar, a horizontal bar or a centre square (the
    label) on a noisy canvas."""
    from dt_tpu_torch.data import recordio
    rng = np.random.RandomState(seed)
    with recordio.RecordIOWriter(path) as w:
        for i in range(n):
            y = rng.randint(0, 3)
            x = rng.normal(110, 30, (32, 32, 3))
            c = 8 + rng.randint(16)
            if y == 0:
                x[4:28, c] += 120
            elif y == 1:
                x[c, 4:28] += 120
            else:
                x[10:22, 10:22] += 120
            w.write(recordio.pack_label(
                np.clip(x, 0, 255).astype(np.uint8).tobytes(), y, rec_id=i))


class _PlainBN:
    """Within the block, the BN wrappers run their plain versions on any
    device (no launch is counted): the plain-BN run of a model."""

    def __enter__(self):
        from dt_tpu_torch.ops import kernels as K
        self.saved = K.bn_stats, K.bn_act
        K.bn_stats = lambda x: K.bn_stats_plain(
            K.rows_view(x, "fused_bn_train"))
        K.bn_act = lambda x, scale, bias, relu=False: K._like_input(
            K.bn_act_plain(K.rows_view(x), scale, bias, relu), x)
        return self

    def __exit__(self, *exc):
        from dt_tpu_torch.ops import kernels as K
        K.bn_stats, K.bn_act = self.saved


def _data_stochastic_depth(tmp, dev, gpu) -> dict:
    """(b) ``resnet20_cifar`` with ``stochastic_depth=0.5`` in f32, as
    ``examples/train_stochastic_depth.py`` sets it, fed from a ``.rec``
    through ``cifar_train_augmenter``."""
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch.data import augment, recordio
    from dt_tpu_torch.training.module import Module
    path = str(Path(tmp) / "shapes.rec")
    _shapes_rec(path, SD_RECORDS, 5)
    it = recordio.ImageRecordIter(path, (32, 32, 3), SD_BATCH, shuffle=True,
                                  augmenter=augment.cifar_train_augmenter(),
                                  seed=0)
    mod = Module(models.create("resnet20_cifar", device=dev, num_classes=3,
                               stochastic_depth=SD_RATE),
                 optimizer="sgd", optimizer_params=SD_SGD, device=dev, seed=0)
    mod.init_params()
    ce = []
    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
    mod.fit(it, eval_metric="ce", num_epoch=SD_EPOCHS,
            epoch_end_callback=lambda e, s, m: ce.append(m.get()[1]))
    torch.cuda.synchronize()
    counts = read_counts()  # ... and ends here
    steps = SD_EPOCHS * (SD_RECORDS // SD_BATCH)
    tag = "data (b) resnet20_cifar stochastic_depth f32"
    want = {k: 0 for k in counts}
    want.update(bn_stats=RESNET20_BN * steps, bn_act=RESNET20_BN * steps)
    _check_counts(tag, counts, want)
    print(f"{tag} epochs={SD_EPOCHS} steps={steps} train_ce={ce}", flush=True)
    if not np.isfinite(ce).all():
        raise AssertionError(f"{tag}: cross-entropy not finite: {ce}")
    it.reset()
    x = mod._place(it.next().data)
    it.close()
    model = mod.model

    def train(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            return model(x, training=True, generator=g).float()

    base = train(1)
    differ = [not torch.equal(base, train(s)) for s in (2, 3, 4)]
    with torch.no_grad():
        e1, e2 = model(x).float(), model(x).float()
    with _PlainBN():
        plain = train(1)
    err = float((base - plain).abs().max())
    tol = TOL_SD_PLAIN * float(plain.abs().max())
    print(f"{tag} train forwards under other generators differ: {differ}; "
          f"eval repeated equal: {torch.equal(e1, e2)}; kernel BN against "
          f"plain BN, the same keeps: max_abs_err={err:.3e} tol={tol:.3e} "
          f"gpu={gpu}", flush=True)
    if not (any(differ) and torch.equal(e1, e2) and err <= tol
            and torch.isfinite(base).all()):
        raise AssertionError(f"{tag}: stochastic depth's checks failed")
    del mod, model
    return {"counts": counts, "train_ce": ce, "plain_max_abs_err": err}


def _bilstm_weights(g, dev, dtype):
    """Forward and backward weights of the PTB-width 2-layer BiLSTM: layer
    0 reads the embedding, layer 1 the 2H concat."""
    from dt_tpu_torch.ops import rnn
    e, h = RNN["emsize"], RNN["hidden"]
    out = []
    for _ in range(2):  # directions
        ws = rnn.init_lstm_weights(g, 1, e, h, dtype=dtype, device=dev)
        for _ in range(1, RNN["layers"]):
            ws += rnn.init_lstm_weights(g, 1, 2 * h, h, dtype=dtype,
                                        device=dev)
        out.append(ws)
    return out


def _events_ms(fn, iters: int = 5) -> float:
    """Median ms of ``fn`` by CUDA events, after one warm call."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _data_bilstm(dev, gpu) -> dict:
    """(c) ``bidirectional_lstm`` at the PTB example's width in f32 and
    bf16, forward and backward, against ``fused=False`` on the card; its
    launches; its ms beside cuDNN's bidirectional ``torch.nn.LSTM``."""
    import torch
    from dt_tpu_torch.ops import rnn
    t, b, e, h, layers = (RNN[k] for k in ("bptt", "batch", "emsize",
                                           "hidden", "layers"))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        g = torch.Generator(device=dev).manual_seed(3)
        fw, bw = _bilstm_weights(g, dev, dtype)
        x = torch.randn(t, b, e, generator=g, device=dev).to(dtype)
        h0 = (0.1 * torch.randn(2 * layers, b, h, generator=g, device=dev)) \
            .to(dtype)
        c0 = (0.1 * torch.randn(2 * layers, b, h, generator=g, device=dev)) \
            .to(dtype)
        cots = [torch.randn(s, generator=g, device=dev) for s in
                ((t, b, 2 * h), (2 * layers, b, h), (2 * layers, b, h))]

        def run(fused):
            leaves = [a.clone().requires_grad_() for a in
                      (x, h0, c0, *[p for w in fw + bw for p in w])]
            lw = [rnn.LSTMWeights(*leaves[3 + 3 * i:6 + 3 * i])
                  for i in range(2 * layers)]
            outs = rnn.bidirectional_lstm(leaves[0], leaves[1], leaves[2],
                                          lw[:layers], lw[layers:],
                                          fused=fused)
            loss = sum((o.float() * c).sum() for o, c in zip(outs, cots))
            return list(outs) + list(torch.autograd.grad(loss, leaves))

        torch.cuda.synchronize()
        reset_counts()  # the path's run starts here
        got = run(None)
        torch.cuda.synchronize()
        counts = read_counts()  # ... and ends here
        want_counts = {k: 0 for k in counts}
        want_counts["lstm_layer"] = 2 * layers  # both dtypes
        want_counts["lstm_layer_bwd"] = 2 * layers
        tag = f"data (c) bidirectional_lstm {name} T{t} B{b} E{e} H{h} L" \
              f"{layers} forward+backward"
        _check_counts(tag, counts, want_counts)
        want = run(False)
        errs = [float((a - w).detach().float().abs().max())
                / max(float(w.detach().float().abs().max()), 1e-30)
                for a, w in zip(got, want)]
        ms = _events_ms(lambda: run(None))
        plain_ms = _events_ms(lambda: run(False))
        cudnn = torch.nn.LSTM(e, h, num_layers=layers, bidirectional=True) \
            .to(dev, dtype)
        cudnn.flatten_parameters()
        xc = x.clone().requires_grad_()

        def cudnn_step():
            y, (hn, cn) = cudnn(xc, (h0, c0))
            loss = (y.float() * cots[0]).sum() + (hn.float() * cots[1]).sum() \
                + (cn.float() * cots[2]).sum()
            torch.autograd.grad(loss, [xc] + list(cudnn.parameters()))

        try:  # a yardstick only: the port never calls it
            lib_ms = _events_ms(cudnn_step)
        except RuntimeError as err:
            print(f"{tag}: cuDNN's LSTM in {name} not measured ({err})",
                  flush=True)
            lib_ms = float("nan")
        print(f"{tag}: max_rel_err={max(errs):.3e} (outputs "
              f"{max(errs[:3]):.3e}, gradients {max(errs[3:]):.3e}) "
              f"tol={TOL_BILSTM[name]:.3e}; ms={ms:.3f} plain_ms="
              f"{plain_ms:.3f} cudnn_lstm_ms={lib_ms:.3f} gpu={gpu}",
              flush=True)
        if not (max(errs) <= TOL_BILSTM[name]
                and all(torch.isfinite(a).all() for a in got)):
            raise AssertionError(f"{tag}: kernels against the plain cell "
                                 f"{errs}")
        out[name] = {"counts": counts, "max_rel_err": max(errs), "ms": ms,
                     "plain_ms": plain_ms, "cudnn_ms": lib_ms}
    return out


def _data_gru(dev, gpu) -> dict:
    """(c) ``gru`` at the PTB width, f32 on the card against the CPU, bf16
    finite; ms beside cuDNN's ``torch.nn.GRU`` (plain PyTorch both ways:
    the JAX package's GRU reaches no Pallas kernel)."""
    import torch
    from dt_tpu_torch.ops import rnn
    t, b, e, h, layers = (RNN[k] for k in ("bptt", "batch", "emsize",
                                           "hidden", "layers"))
    g = torch.Generator().manual_seed(4)
    s = 1.0 / h ** 0.5
    arrays = [torch.randn(t, b, e, generator=g),
              0.1 * torch.randn(layers, b, h, generator=g)]
    for layer in range(layers):
        i = e if layer == 0 else h
        arrays += [(torch.rand(shape, generator=g) * 2 - 1) * s
                   for shape in ((i, 3 * h), (h, 3 * h), (3 * h,), (3 * h,))]
    cot = torch.randn(t, b, h, generator=g)

    def run(where, dtype):
        leaves = [a.to(where, dtype).requires_grad_() for a in arrays]
        ws = [rnn.GRUWeights(*leaves[2 + 4 * i:6 + 4 * i])
              for i in range(layers)]
        y, hT = rnn.gru(leaves[0], leaves[1], ws)
        loss = (y.float() * cot.to(where)).sum() + hT.float().sum()
        return [y, hT] + list(torch.autograd.grad(loss, leaves))

    card = run(dev, torch.float32)
    cpu = run("cpu", torch.float32)
    err = max(float((a.detach().cpu() - w.detach()).abs().max())
              / float(w.detach().abs().max()) for a, w in zip(card, cpu))
    bf16 = run(dev, torch.bfloat16)
    ms = _events_ms(lambda: run(dev, torch.float32))
    ms_bf16 = _events_ms(lambda: run(dev, torch.bfloat16))
    cudnn = torch.nn.GRU(e, h, num_layers=layers).to(dev)
    cudnn.flatten_parameters()
    xc = arrays[0].to(dev).requires_grad_()
    h0 = arrays[1].to(dev)

    def cudnn_step():
        y, hn = cudnn(xc, h0)
        torch.autograd.grad((y * cot.to(dev)).sum() + hn.sum(),
                            [xc] + list(cudnn.parameters()))

    lib_ms = _events_ms(cudnn_step)
    print(f"data (c) gru f32 T{t} B{b} E{e} H{h} L{layers} card against cpu "
          f"max_rel_err={err:.3e} (tol {TOL_GRU_CARD}); forward+backward "
          f"ms f32 {ms:.3f} bf16 {ms_bf16:.3f} cudnn_gru_ms={lib_ms:.3f} "
          f"gpu={gpu}", flush=True)
    if not (err <= TOL_GRU_CARD
            and all(torch.isfinite(a).all() for a in bf16)):
        raise AssertionError("data (c): gru on the card disagrees")
    return {"max_rel_err": err, "ms": ms, "ms_bf16": ms_bf16,
            "cudnn_ms": lib_ms}


def _ner_batches():
    """Seeded sentences of ``train_ner.py``'s task: a token is an entity
    (tag 1) if it is an entity word, inside one (tag 2) if it follows an
    entity word, else outside (0)."""
    from dt_tpu_torch.text import Vocabulary
    rng = np.random.RandomState(11)
    words = [f"w{i}" for i in range(NER["vocab_words"])]
    ents = [f"E{i}" for i in range(NER["entities"])]
    sents, tags = [], []
    for _ in range(NER["sentences"]):
        toks, tg = [], []
        for k in range(NER["sentence"]):
            ent = rng.rand() < 0.2
            toks.append(ents[rng.randint(len(ents))] if ent
                        else words[rng.randint(len(words))])
            tg.append(1 if ent else (2 if k and tg[-1] == 1 else 0))
        sents.append(toks)
        tags.append(tg)
    vocab = Vocabulary(Vocabulary.count_tokens(t for s in sents for t in s),
                       reserved_tokens=["<pad>"])
    x = np.asarray([vocab.to_indices(s) for s in sents], np.int64)
    return vocab, x, np.asarray(tags, np.int64)


def _data_ner(dev, gpu) -> dict:
    """(c) ``train_ner.py``'s model on the card: a ``Vocabulary`` over the
    seeded tokens, an embedding, a BiLSTM (E 32, H 32), a linear tagger,
    adam lr 3e-3 (the port's), 20 steps with the loss falling."""
    import torch
    from dt_tpu_torch import optim
    from dt_tpu_torch.ops import rnn
    vocab, x, y = _ner_batches()
    e, h = NER["embed"], NER["hidden"]
    g = torch.Generator(device=dev).manual_seed(0)
    fw = rnn.init_lstm_weights(g, 1, e, h, device=dev)[0]
    bw = rnn.init_lstm_weights(g, 1, e, h, device=dev)[0]
    params = {"embed": 0.1 * torch.randn(len(vocab), e, generator=g,
                                         device=dev),
              "out_w": 0.1 * torch.randn(2 * h, 3, generator=g, device=dev),
              "out_b": torch.zeros(3, device=dev)}
    for d, w in (("fw", fw), ("bw", bw)):
        params.update({f"{d}_{k}": v for k, v in w._asdict().items()})
    params = {k: v.requires_grad_() for k, v in params.items()}
    tx = optim.create("adam", learning_rate=NER["lr"])
    state = tx.init(params)
    losses = []
    torch.cuda.synchronize()
    reset_counts()  # the path's run starts here
    for step in range(NER["steps"]):
        lo = step * NER["batch"] % len(x)
        xb = torch.from_numpy(x[lo:lo + NER["batch"]]).to(dev)
        yb = torch.from_numpy(y[lo:lo + NER["batch"]]).to(dev)
        emb = params["embed"][xb].transpose(0, 1)  # (L, B, E)
        h0 = torch.zeros(2, xb.shape[0], h, device=dev)
        outs, _, _ = rnn.bidirectional_lstm(
            emb, h0, h0, [rnn.LSTMWeights(*(params[f"fw_{k}"]
                                            for k in ("wx", "wh", "b")))],
            [rnn.LSTMWeights(*(params[f"bw_{k}"] for k in ("wx", "wh", "b")))])
        logits = outs.transpose(0, 1) @ params["out_w"] + params["out_b"]
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 3),
                                                 yb.reshape(-1))
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        state = tx.update(grads, state, params)
        losses.append(float(loss))
    torch.cuda.synchronize()
    counts = read_counts()  # ... and ends here
    want = {k: 0 for k in counts}
    want["lstm_layer"] = 2 * NER["steps"]
    want["lstm_layer_bwd"] = 2 * NER["steps"]
    tag = "data (c) train_ner BiLSTM E32 H32 adam"
    _check_counts(tag, counts, want)
    _falling(tag, losses)
    print(f"{tag} vocab={len(vocab)} gpu={gpu}", flush=True)
    return {"counts": counts, "losses": losses}


def _data_loaders(tmp, dev, gpu) -> dict:
    """(d) ``MNISTIter`` over seeded gzip idx files, then an
    ``ArrayDataset`` through a ``DataLoader`` of 2 forked workers, each
    feeding a LeNet ``Module.fit`` of one epoch, after the card's first
    launches (the workers fork from a process with a CUDA context and
    touch no CUDA).  A watchdog kills the workers and ends the script if
    the two fits take past ``LOADER_TIMEOUT_S``."""
    import gzip
    import os
    import signal
    import struct
    import threading
    from dt_tpu_torch import models
    from dt_tpu_torch.data import dataset, mnist
    from dt_tpu_torch.training.module import Module
    n, bs = LOADER["images"], LOADER["batch"]
    rng = np.random.RandomState(13)
    y = rng.randint(0, 10, n).astype(np.uint8)
    img = rng.randint(0, 60, (n, 28, 28)).astype(np.uint8)
    for i in range(n):  # a class-dependent bright row
        img[i, 2 + 2 * y[i], 4:24] = 250
    ip, lp = Path(tmp) / "train-images-idx3-ubyte.gz", \
        Path(tmp) / "train-labels-idx1-ubyte.gz"
    ip.write_bytes(gzip.compress(struct.pack(">IIII", 2051, n, 28, 28)
                                 + img.tobytes()))
    lp.write_bytes(gzip.compress(struct.pack(">II", 2049, n) + y.tobytes()))
    workers = []

    def fire():
        print(f"chip_smoke: data (d) hung past {LOADER_TIMEOUT_S} s; "
              f"killing workers {[p.pid for p in workers]}", file=sys.stderr,
              flush=True)
        for p in workers:
            try:
                os.kill(p.pid, signal.SIGKILL)
            except OSError:
                pass
        os._exit(3)

    dog = threading.Timer(LOADER_TIMEOUT_S, fire)
    dog.daemon = True
    dog.start()
    out = {}
    t0 = time.perf_counter()
    try:
        it = mnist.MNISTIter(str(ip), str(lp), batch_size=bs, shuffle=True)
        loader = dataset.DataLoader(
            dataset.ArrayDataset(mnist.read_idx_images(str(ip))
                                 .astype(np.float32) / 255.0,
                                 mnist.read_idx_labels(str(lp))),
            batch_size=bs, shuffle=True, num_workers=LOADER["workers"])
        workers = list(loader._it._pool._pool)
        for tag, data_iter in (("MNISTIter", it), ("DataLoader", loader)):
            mod = Module(models.create("lenet", device=dev, num_classes=10),
                         optimizer="sgd", optimizer_params=dict(
                             learning_rate=0.1, momentum=0.9),
                         device=dev, seed=0)
            ce = []
            mod.fit(data_iter, eval_metric="ce", num_epoch=1,
                    epoch_end_callback=lambda e, s, m: ce.append(m.get()[1]))
            out[tag] = ce[0]
        loader.close()
    finally:
        dog.cancel()
    alive = [p.pid for p in workers if p.is_alive()]
    codes = [p.exitcode for p in workers]
    secs = time.perf_counter() - t0
    print(f"data (d) LeNet fits, one epoch each: MNISTIter (gzip idx) ce="
          f"{out['MNISTIter']:.5f}, DataLoader({LOADER['workers']} forked "
          f"workers) ce={out['DataLoader']:.5f}; workers {len(workers)} "
          f"exit codes {codes}, alive {alive}; {secs:.2f} s (limit "
          f"{LOADER_TIMEOUT_S} s) gpu={gpu}", flush=True)
    if not (np.isfinite(list(out.values())).all() and not alive
            and len(workers) == LOADER["workers"]
            and all(c is not None for c in codes)):
        raise AssertionError("data (d): a fit's loss is not finite or a "
                             "worker outlived the loader")
    return {"ce": out, "worker_exit_codes": codes, "seconds": secs}


def data_phase(gpu, dev, fitted) -> dict:
    """Phase 23, the data pipeline and the recurrent cells: (a)
    :func:`_data_rec_fit`, (b) :func:`_data_stochastic_depth`, (c)
    :func:`_data_bilstm`, :func:`_data_gru` and :func:`_data_ner`, (d)
    :func:`_data_loaders`.  Nothing here needs PIL or ``ml_dtypes`` (the
    records are raw u8): the phase fails if it imported either.  Each
    part's time and the phase's."""
    import importlib.util
    import tempfile
    optional = ("PIL", "ml_dtypes")
    print("data phase: this host " + ", ".join(
        f"{m} {'installed' if importlib.util.find_spec(m) else 'missing'}"
        for m in optional), flush=True)
    loaded = {m for m in optional if m in sys.modules}
    t0 = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        rec = _data_rec_fit(tmp, dev, gpu, fitted)
        times["a"] = time.perf_counter() - t
        t = time.perf_counter()
        sd = _data_stochastic_depth(tmp, dev, gpu)
        times["b"] = time.perf_counter() - t
        t = time.perf_counter()
        bilstm = _data_bilstm(dev, gpu)
        gru = _data_gru(dev, gpu)
        ner = _data_ner(dev, gpu)
        times["c"] = time.perf_counter() - t
        t = time.perf_counter()
        loaders = _data_loaders(tmp, dev, gpu)
        times["d"] = time.perf_counter() - t
    total = time.perf_counter() - t0
    added = {m for m in optional if m in sys.modules} - loaded
    if added:
        raise AssertionError(f"data phase: imported {sorted(added)}")
    print(f"data phase: .rec fit (a) {times['a']:.1f} s, stochastic depth "
          f"(b) {times['b']:.1f} s, rnn (c) {times['c']:.1f} s, loaders (d) "
          f"{times['d']:.1f} s, total {total:.1f} s gpu={gpu}", flush=True)
    return {"rec": rec, "sd": sd, "bilstm": bilstm, "gru": gru, "ner": ner,
            "loaders": loaders, "times": times, "seconds": total}


# --- phase 24: the classification zoo ---------------------------------------
# one model a family at full width, 1000 classes: test_torch_shapes.ZOO
ZOO_STEPS = 3  # bf16 fit steps a model: the last 2 are timed
ZOO_EVAL_BATCH = 2
ZOO_BUCKETS = (1, 32)
ZOO_REPS = 2  # requests timed a bucket
# (a) kernel BN against plain BN.  The f32 eval forward of the whole model
# runs the same arithmetic either way (bn_act and its plain version are
# bit-equal): logits within TOL_ZOO["logits"] of the largest.  At the main
# path's own BN inputs, layer by layer: pass 1 within TOL_ZOO["stats"] of
# the layer's largest E[x^2] (its f32 sums run in another order), pass 2
# and the inference kernel bit-equal to bn_act_plain.
TOL_ZOO = {"logits": 1e-5, "stats": 1e-5}


def _zoo_bn_count(model) -> int:
    from dt_tpu_torch.models.common import FusedBatchNorm
    return sum(isinstance(m, FusedBatchNorm) for m in model.modules())


def _zoo_eval_vs_plain(name, size, mod, dev) -> dict:
    """(a) An f32 copy of ``mod``'s model (the weights carried once, by
    ``load_state_dict``): its eval forward at batch 2 with the BN kernels
    and again on their plain versions (:class:`_PlainBN`)."""
    import torch
    from dt_tpu_torch import models
    kw = {"image_size": size} if models.takes_image_size(name) else {}
    model = models.create(name, device=dev, num_classes=1000, **kw)
    model.load_state_dict(mod.model.state_dict())
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(ZOO_EVAL_BATCH, 3, size, size, generator=g,
                    device=dev).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model(x).float()
        with _PlainBN():
            want = model(x).float()
    out = {"eval_max_abs_err": float((got - want).abs().max()),
           "eval_max_abs_logit": float(want.abs().max())}
    del model
    return out


def _bn_kernels_on_path(model, runs) -> dict:
    """The BN kernels against their plain versions on the inputs the main
    path gives them: forward pre-hooks on every BN of ``model`` take each
    BN's input in the forwards ``runs`` (``(training, x, kwargs)``, no
    gradient) and hold each kernel there (``TOL_ZOO``): in a training
    forward pass 1, pass 2 with pass 1's statistics and the inference
    kernel, in an eval forward the inference kernel.  The running stats
    are put back after.  Launches here are not the main path's."""
    import torch
    from dt_tpu_torch.models.common import FusedBatchNorm
    from dt_tpu_torch.ops import kernels as K
    stats_err, mismatches, inputs = [], [], {}
    mode = {"training": True}

    def check(bn, args):
        x = args[0]
        x2 = K.rows_view(x)
        if mode["training"]:
            mean, var = K.bn_stats(x)
            pm, pv = K.bn_stats_plain(x2)
            ex2 = (x2.float() ** 2).mean(0).max().clamp_min(1e-30)
            stats_err.append(torch.maximum((mean - pm).abs().max(),
                                           (var - pv).abs().max()) / ex2)
            scale, bias = K.bn_scale_bias(bn.scale, bn.bias, mean, var,
                                          bn.epsilon, x.dtype)
            mismatches.append((K.rows_view(K.bn_act(x, scale, bias, bn.relu))
                               != K.bn_act_plain(x2, scale, bias, bn.relu))
                              .sum())
        y = K.fused_bn_inference(x, bn.scale, bn.bias, bn.mean, bn.var,
                                 eps=bn.epsilon, relu=bn.relu)
        scale, bias = K.bn_scale_bias(bn.scale, bn.bias, bn.mean, bn.var,
                                      bn.epsilon, x.dtype)
        mismatches.append((K.rows_view(y)
                           != K.bn_act_plain(x2, scale, bias, bn.relu)).sum())
        inputs[tuple(x2.shape)] = inputs.get(tuple(x2.shape), 0) + 1

    bns = [m for m in model.modules() if isinstance(m, FusedBatchNorm)]
    hooks = [m.register_forward_pre_hook(check) for m in bns]
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    try:
        with torch.no_grad():
            for training, rows, kw in runs:
                mode["training"] = training
                model(rows, training=training, **kw)
            for n, b in model.named_buffers():
                b.copy_(stats0[n])
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return {"bn_inputs": sum(inputs.values()), "shapes": len(inputs),
            "stats_rel_err": float(torch.stack(stats_err).max())
            if stats_err else 0.0,
            "mismatches": int(torch.stack(mismatches).sum())
            if mismatches else 0}


def _zoo_kernels_at_path_shapes(mod, size, dev) -> dict:
    """(a) :func:`_bn_kernels_on_path` on the fit's own bf16 model: one
    training forward at batch ``BATCH`` (the fit's and bucket 32's rows)
    and one eval forward at batch 1 (bucket 1's rows)."""
    import torch
    model = mod.model
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(BATCH, 3, size, size, generator=g, device=dev,
                    dtype=torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)
    takes_gen = "generator" in model.forward.__code__.co_varnames
    return _bn_kernels_on_path(model, [
        (True, x, {"generator": g} if takes_gen else {}), (False, x[:1], {})])


def _zoo_model(name, size, dev, gpu) -> dict:
    """One model of phase 24: (a) :func:`_zoo_eval_vs_plain` and
    :func:`_zoo_kernels_at_path_shapes`, (b) the bf16 ``Module.fit`` (the
    main path's training run: counts reset just before it, read just
    after), (c) the ``Predictor`` in bf16, built by name from a serving
    checkpoint of the fit's weights and BN stats (its requests the main
    path's serving run)."""
    import tempfile

    import torch
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.data import io
    from dt_tpu_torch.predictor import Predictor
    from dt_tpu_torch.training import checkpoint
    from dt_tpu_torch.training.module import Module
    from dt_tpu_torch.training.train_state import TrainState
    tag = f"zoo {name} {size}"
    t0 = time.perf_counter()
    kw = {"image_size": size} if models.takes_image_size(name) else {}
    mod = Module(models.create(name, device=dev, dtype=torch.bfloat16,
                               num_classes=1000, **kw),
                 optimizer="sgd",
                 optimizer_params={"learning_rate": FIT_SGD["learning_rate"],
                                   "momentum": 0.9, "weight_decay": 1e-4,
                                   "multi_precision": True},
                 device=dev, seed=0)
    mod.init_params()
    n_bn = _zoo_bn_count(mod.model)
    n_params = sum(p.numel() for p in mod.model.parameters())
    init_s = time.perf_counter() - t0

    # (a) the kernels against their plain versions
    t = time.perf_counter()
    held = _zoo_eval_vs_plain(name, size, mod, dev)
    held.update(_zoo_kernels_at_path_shapes(mod, size, dev))
    a_s = time.perf_counter() - t
    print(f"{tag} (a) f32 eval, kernel BN against plain BN: max_abs_err="
          f"{held['eval_max_abs_err']:.3e} (largest logit "
          f"{held['eval_max_abs_logit']:.3f}); bf16 at the main path's "
          f"{held['bn_inputs']} BN inputs ({held['shapes']} (rows, C)): pass "
          f"1 max_err/E[x^2]={held['stats_rel_err']:.3e} (tol "
          f"{TOL_ZOO['stats']:.0e}), pass 2 and inference elements unequal "
          f"to plain: {held['mismatches']}", flush=True)
    bad = []
    if not held["eval_max_abs_err"] <= \
            TOL_ZOO["logits"] * held["eval_max_abs_logit"]:
        bad.append("eval logits")
    if held["bn_inputs"] != 2 * n_bn:
        bad.append(f"{held['bn_inputs']} BN inputs held, not {2 * n_bn}")
    if not held["stats_rel_err"] <= TOL_ZOO["stats"]:
        bad.append("pass 1")
    if held["mismatches"]:
        bad.append("pass 2 / inference")
    if bad:
        raise AssertionError(f"{tag} (a): kernel BN against plain BN off "
                             f"in {bad}")

    # (b) the bf16 fit, as examples/common.py builds it
    ends, cum = [], []

    def on_batch(param):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        cum.append(dict(param.eval_metric.get_name_value())["cross-entropy"])

    train = io.SyntheticImageIter((size, size, 3), 1000, BATCH,
                                  num_batches=ZOO_STEPS, seed=0,
                                  dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    reset_counts()  # the main path's run starts here
    mod.fit(train, eval_metric="ce", num_epoch=1,
            batch_end_callback=on_batch)
    torch.cuda.synchronize()
    fit_counts = read_counts()  # ... and ends here
    fit_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [cum[0]] + [cum[k] * (k + 1) - cum[k - 1] * k
                         for k in range(1, len(cum))]
    want = {k: 0 for k in fit_counts}
    want.update(bn_stats=n_bn * ZOO_STEPS, bn_act=n_bn * ZOO_STEPS)
    _check_counts(f"{tag} (b) fit bf16", fit_counts, want)
    if len(losses) != ZOO_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{tag} (b): losses {losses}")
    step_ms = _median_ms(np.diff(ends))
    one = io.SyntheticImageIter((size, size, 3), 1000, BATCH, num_batches=1,
                                seed=1, dtype="bfloat16")
    torch.cuda.synchronize()
    t = time.perf_counter()
    mod.fit(one, num_epoch=1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    prof = profile_fn(lambda: mod.fit(one, num_epoch=1), wall_ms,
                      f"{tag} (b) one fit step")
    print(f"{tag} (b) fit bf16 batch {BATCH}: losses "
          f"{[round(v, 4) for v in losses]} median_synced_step_ms="
          f"{step_ms:.3f} (last {ZOO_STEPS - 1}) imgs_per_s="
          f"{BATCH * 1e3 / step_ms:.1f} peak_hbm_bytes={peak} bn_a_step="
          f"{fit_counts['bn_stats'] // ZOO_STEPS}+"
          f"{fit_counts['bn_act'] // ZOO_STEPS} params={n_params} "
          f"gpu={gpu}", flush=True)

    # (c) serving in bf16, buckets 1 and 32, by name from a checkpoint
    images = np.random.RandomState(3).uniform(
        -1, 1, (max(ZOO_BUCKETS), size, size, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        prefix = str(Path(tmp) / name)
        # a serving checkpoint: the fit's weights and BN stats, no
        # optimizer slots (what the Predictor reads; half the bytes)
        serving = TrainState.create(mod.model, optim.create("sgd"))
        checkpoint.save_checkpoint(prefix, 0, serving)
        pred = Predictor(name, prefix, 0, images[:1], dtype=torch.bfloat16,
                         batch_buckets=list(ZOO_BUCKETS), device=dev,
                         num_classes=1000)
        ckpt_s = time.perf_counter() - t
    pred.warmup((size, size, 3))
    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
    outs = [pred.predict(images[:b]) for b in ZOO_BUCKETS]
    serve_counts = read_counts()  # ... and ends here
    want = {k: 0 for k in serve_counts}
    want.update(bn_act=n_bn * len(ZOO_BUCKETS))
    _check_counts(f"{tag} (c) serve bf16", serve_counts, want)
    for b, out in zip(ZOO_BUCKETS, outs):
        if out.shape != (b, 1000) or not np.isfinite(out).all():
            raise AssertionError(f"{tag} (c): bucket {b} gave {out.shape}")
    ref = mod.predict(images)
    err = float(np.abs(outs[-1] - ref).max())
    if not err <= TOL_BF16 * float(np.abs(ref).max()):
        raise AssertionError(f"{tag} (c): the checkpoint's Predictor is "
                             f"{err:.3e} from Module.predict")
    serve_ms = {}
    for b in ZOO_BUCKETS:
        t = time.perf_counter()
        for _ in range(ZOO_REPS):
            pred.predict(images[:b])
        serve_ms[b] = (time.perf_counter() - t) * 1e3 / ZOO_REPS
    print(f"{tag} (c) serve bf16 by name from a checkpoint ({ckpt_s:.1f} s "
          f"to save and load; bucket {max(ZOO_BUCKETS)} {err:.3e} from "
          f"Module.predict) " + " ".join(
              f"bucket={b} ms_per_request={ms:.3f} img_per_s="
              f"{b / ms * 1e3:.1f}" for b, ms in serve_ms.items())
          + f" gpu={gpu}", flush=True)
    secs = time.perf_counter() - t0
    print(f"{tag} done in {secs:.1f} s (init {init_s:.1f}, (a) {a_s:.1f}, "
          f"fit {fit_s:.1f})", flush=True)
    del mod, pred
    torch.cuda.empty_cache()
    return {"bn": n_bn, "params": n_params, "held": held,
            "fit_counts": fit_counts, "serve_counts": serve_counts,
            "losses": losses, "step_ms": step_ms,
            "imgs_per_s": BATCH * 1e3 / step_ms, "peak_hbm_bytes": peak,
            "serve_ms": serve_ms, "seconds": secs, **prof}


def zoo_phase(gpu, dev) -> dict:
    """Phase 24, the classification zoo: :func:`_zoo_model` for each model
    of ``test_torch_shapes.ZOO`` in order.  The phase's time, and the
    launches of the main path's runs summed over the models."""
    from test_torch_shapes import ZOO
    t0 = time.perf_counter()
    runs = {}
    for name, size in ZOO:
        runs[name] = _zoo_model(name, size, dev, gpu)
    total = {k: sum(r["fit_counts"][k] + r["serve_counts"][k]
                    for r in runs.values()) for k in ("bn_stats", "bn_act")}
    secs = time.perf_counter() - t0
    print(f"zoo phase: {len(runs)} models, launches {json.dumps(total)}, "
          f"total {secs:.1f} s gpu={gpu}", flush=True)
    return {"runs": runs, "launches": total, "seconds": secs}


# --- phase 25: the detectors ------------------------------------------------
# test_torch_shapes.DETECTORS: SSD at 300x300, batch 32, 20 classes (the
# reference's SSD300 on VOC); FasterRCNNMini's defaults at 512x512, batch 8
DETECT_BOXES = {"ssd": 8, "faster_rcnn": 2}  # boxes an image at most
DETECT_CLASSES = {"ssd": 20, "faster_rcnn": 2}  # of the data's labels
DETECT_ADAM = {"learning_rate": 1e-3}  # examples/train_ssd.py, train_rcnn.py
# steps on one seeded batch, as many as tests/test_ssd.py:43 (12) and
# tests/test_rcnn.py:91 (15) take, gated as they gate: the last loss below
# 0.8 of the first (FasterRCNNMini fits its batch by ~20 steps on the card;
# past that adam's steps on a near-zero loss reshuffle the proposals and
# the loss spikes)
DETECT_STEPS = {"ssd": 12, "faster_rcnn": 15}
DETECT_TIMED = 3  # synced steps, their median
DETECT_REC = {"records": 96, "steps": 3}  # (d): raw u8 records, SSD steps
# (a) as TOL_ZOO; (c) scores and boxes relative to the largest, the
# deciding IoU's distance to the threshold that excuses a flipped keep
# decision (the two sides' decoded boxes may differ in their last bits)
TOL_DETECT = {"scores": 1e-6, "iou": 1e-6}


def _det_example(name):
    """``synthetic_batch`` of ``examples/train_ssd.py`` or
    ``train_rcnn.py`` (numpy only; the scripts' ``main`` is not run)."""
    import importlib.util
    stem = "train_ssd" if name == "ssd" else "train_rcnn"
    spec = importlib.util.spec_from_file_location(
        f"_det_{stem}", ROOT / "examples" / f"{stem}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.synthetic_batch


def _det_batch(name, size, batch, seed, dev, dtype):
    """A seeded batch of the example's generator on the card: NCHW
    channels_last images in ``dtype``, gt boxes (B, M, 4) f32 and labels
    (B, M) int64 (-1 padding)."""
    import torch
    imgs, boxes, labels = _det_example(name)(
        np.random.RandomState(seed), batch, size, DETECT_CLASSES[name],
        DETECT_BOXES[name])
    x = torch.from_numpy(imgs).to(dev, dtype).permute(0, 3, 1, 2)
    return (x, torch.from_numpy(boxes).to(dev),
            torch.from_numpy(labels).to(dev), imgs)


def _det_loss(name, model, out, gtb, gtl, size):
    from dt_tpu_torch import models
    if name == "ssd":
        return models.ssd_loss(*out, gtb, gtl)
    return models.rcnn_loss(out, model.anchors((size, size), gtb.device),
                            gtb, gtl)


def _det_detect(name, out, **kw):
    from dt_tpu_torch import models
    if name == "ssd":
        return models.ssd_detect(*out, **kw)
    return models.rcnn_detect(out, **kw)


def _det_model(name, dtype, dev, kw):
    from dt_tpu_torch import models
    return models.init_params(models.create(name, device=dev, dtype=dtype,
                                            **kw), seed=0)


def _det_step(name, model, state, size):
    """One training step of ``model``: forward, loss, gradients, adam
    (``TrainState.apply_gradients``).  Returns ``step(x, gtb, gtl) ->
    loss`` (a device scalar: no host sync)."""
    import torch
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]

    def step(x, gtb, gtl):
        out = model(x, training=True)
        loss = _det_loss(name, model, out, gtb, gtl, size)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        state.apply_gradients({n: torch.zeros_like(p) if g is None else g
                               for n, g, p in zip(names, grads, params)})
        return loss.detach()

    return step


def _det_train(name, size, batch, kw, dtype, dev, gpu) -> dict:
    """(b) ``DETECT_STEPS`` adam steps of a fresh seeded model on one
    seeded batch (the main path's run: counts reset just before, read just
    after), the loss gated as the JAX package's tests gate it; then the
    median of ``DETECT_TIMED`` synced steps, images/s, peak HBM and one
    profiled step.  Returns the trained model and state with the report."""
    import torch
    from dt_tpu_torch import optim
    from dt_tpu_torch.models.common import FusedBatchNorm
    from dt_tpu_torch.training.train_state import TrainState
    tag = f"detection {name} {str(dtype).split('.')[-1]}"
    model = _det_model(name, dtype, dev, kw)
    n_bn = sum(isinstance(m, FusedBatchNorm) for m in model.modules())
    state = TrainState.create(model, optim.create("adam", **DETECT_ADAM))
    step = _det_step(name, model, state, size)
    x, gtb, gtl, _ = _det_batch(name, size, batch, 0, dev, dtype)
    steps = DETECT_STEPS[name]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with _nms_captured() as nms_calls:
        reset_counts()  # the main path's run starts here
        losses = [step(x, gtb, gtl) for _ in range(steps)]
        torch.cuda.synchronize()
        counts = read_counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(v) for v in losses]
    want = {k: 0 for k in counts}
    want.update(bn_stats=n_bn * steps, bn_act=n_bn * steps)
    if name == "faster_rcnn":  # the proposal stage's scan, once a forward
        want["nms_keep"] = steps
    _check_counts(f"{tag} (b) train", counts, want)
    print(f"{tag} (b) losses={[round(v, 4) for v in losses]}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < 0.8 * losses[0]):
        raise AssertionError(f"{tag} (b): the loss did not fall below 0.8 "
                             f"of the first: {losses}")
    nms = _det_hold_nms(nms_calls, f"{tag} (b) train")
    times = []
    for _ in range(DETECT_TIMED):
        t = time.perf_counter()
        step(x, gtb, gtl)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    step_ms = _median_ms(times)
    prof = profile_fn(lambda: step(x, gtb, gtl), step_ms,
                      f"{tag} (b) one step")
    print(f"{tag} (b) batch {batch} at {size}x{size}: median_synced_step_ms="
          f"{step_ms:.3f} imgs_per_s={batch * 1e3 / step_ms:.1f} "
          f"peak_hbm_bytes={peak} bn_a_step={counts['bn_stats'] // steps}+"
          f"{counts['bn_act'] // steps} nms_keep_a_step="
          f"{counts['nms_keep'] // steps} gpu={gpu}", flush=True)
    return {"model": model, "state": state, "counts": counts,
            "losses": losses, "step_ms": step_ms,
            "imgs_per_s": batch * 1e3 / step_ms, "peak_hbm_bytes": peak,
            "bn": n_bn, "nms_held": nms, **prof}


@contextlib.contextmanager
def _nms_captured():
    """Every ``ops.kernels.nms_keep`` call made inside the block, as
    ``(boxes, labels, counts, threshold, keep)`` copies: ``ops.detection
    .nms`` calls the wrapper through its module, so it is swapped for one
    that calls it (which counts the launch) and keeps the copies."""
    from dt_tpu_torch.ops import kernels as K
    wrapper, calls = K.nms_keep, []

    def capture(boxes, labels, counts, iou_threshold):
        keep = wrapper(boxes, labels, counts, iou_threshold)
        calls.append((boxes.clone(), None if labels is None
                      else labels.clone(), counts.clone(), iou_threshold,
                      keep.clone()))
        return keep

    K.nms_keep = capture
    try:
        yield calls
    finally:
        K.nms_keep = wrapper


def _det_hold_nms(calls, tag) -> dict:
    """Each captured ``nms_keep`` call's keep mask against
    ``nms_keep_plain`` on the same sorted card tensors (its "over" rows
    computed by PyTorch on the card, the scan on the host): equal."""
    from dt_tpu_torch.ops import kernels as K
    mism, t = 0, time.perf_counter()
    for boxes, labels, counts, thr, keep in calls:
        plain = K.nms_keep_plain(boxes, labels, counts, thr)
        mism += int((keep != plain).sum())
    shapes = sorted({(*c[0].shape[:2], c[1] is not None, c[3])
                     for c in calls})
    print(f"{tag} nms_keep calls {len(calls)} (B, N, labelled, threshold) "
          f"{shapes}: elements unequal to plain {mism} (plain "
          f"{time.perf_counter() - t:.1f} s)", flush=True)
    if mism:
        raise AssertionError(f"{tag}: nms_keep differs from its plain "
                             f"version on {mism} elements")
    return {"calls": len(calls), "mismatches": mism,
            "shapes": [list(s) for s in shapes]}


def _det_flips(boxes, scores, labels_cpu, labels_card, thr) -> list:
    """Boxes whose keep decision differs between the card and the CPU.
    Both sides scan the same scores in the same order, so a flip comes
    from the decoded boxes alone: it is excused only where a same-class box
    before it (kept by either side) overlaps it at an IoU within
    ``TOL_DETECT["iou"]`` of the threshold.  Returns ``(position, the IoU
    nearest the threshold, excused)``."""
    import torch
    from dt_tpu_torch.ops.detection import box_iou
    order = torch.argsort(-scores, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(len(order))
    cls = torch.maximum(labels_cpu, labels_card)
    out = []
    for i in torch.nonzero(labels_cpu != labels_card).flatten().tolist():
        cand = torch.nonzero((cls == cls[i]) & (rank < rank[i])).flatten()
        if not len(cand):
            out.append((i, float("nan"), False))
            continue
        iou = box_iou(boxes[i:i + 1], boxes[cand])[0]
        near = float(iou[(iou - thr).abs().argmin()])
        out.append((i, near, abs(near - thr) <= TOL_DETECT["iou"]))
    return out


def _det_host_detect(name, out, kw):
    """The detection stage's plain CPU version on the card's class
    probabilities (the card's softmax, so both sides sort the same scores)
    and its other outputs, copied to the host."""
    import torch
    from dt_tpu_torch.models import rcnn, ssd
    if name == "ssd":
        return ssd._detect_probs(torch.softmax(out[0], dim=-1).cpu(),
                                 out[1].cpu(), out[2].cpu(), **kw)
    return rcnn._detect_probs(torch.softmax(out["cls_scores"], dim=-1).cpu(),
                              out["rois"].cpu(), out["box_deltas"].cpu(),
                              **kw)


def _det_hold_detect(name, out, got, thr, kw) -> dict:
    """(c) The detection stage's plain CPU version (keyword arguments
    ``kw``) on the card's outputs, against the card's labels, scores and
    boxes."""
    import torch
    want = _det_host_detect(name, out, kw)
    labels, scores, boxes = (t.cpu() for t in got)
    err = {}
    for what, g, w in (("scores", scores, want[1]), ("boxes", boxes,
                                                     want[2])):
        err[what] = float((g - w).abs().max() / w.abs().max())
        if not err[what] <= TOL_DETECT["scores"]:
            raise AssertionError(f"detection {name} (c): {what} {err[what]}"
                                 f" of the largest from the CPU's")
    flips = []
    for img in range(labels.shape[0]):
        if torch.equal(labels[img], want[0][img]):
            continue
        for pos, iou, excused in _det_flips(want[2][img], want[1][img],
                                            want[0][img], labels[img], thr):
            flips.append({"image": img, "box": pos, "iou": iou,
                          "excused": excused, "cpu": int(want[0][img][pos]),
                          "card": int(labels[img][pos])})
    for f in flips:
        print(f"detection {name} (c) flipped keep decision: {json.dumps(f)}",
              flush=True)
    if not all(f["excused"] for f in flips):
        raise AssertionError(f"detection {name} (c): labels differ from the "
                             f"CPU's beyond an IoU at the threshold: {flips}")
    return {"scores_rel_err": err["scores"], "boxes_rel_err": err["boxes"],
            "flips": len(flips), "kept": int((labels >= 0).sum())}


def _nms_runs(sl, counts, thr, keep) -> dict:
    """The label runs the scan kernel walks on one call's data, from the
    host: each image's prefix is one run a label when labels are given and
    the threshold is >= 0, else one run.  Runs an image, the longest run's
    boxes and kept boxes, and the pairs the greedy scan must compare (a
    run's K (K - 1) / 2)."""
    runs, pairs, longest, longest_kept = [], 0, 0, 0
    keep = keep.cpu().numpy()
    lab = None if sl is None or thr < 0 else sl.cpu().numpy()
    for img, k in enumerate(counts.tolist()):
        k = min(max(k, 0), keep.shape[1])
        if lab is None:
            sizes, kept = [k] if k else [], [int(keep[img, :k].sum())]
        else:
            vals, sizes = np.unique(lab[img, :k], return_counts=True)
            kept = [int(keep[img, :k][lab[img, :k] == v].sum())
                    for v in vals]
        runs.append(len(sizes))
        pairs += sum(int(m) * (int(m) - 1) // 2 for m in sizes)
        if len(sizes):
            i = int(np.argmax(sizes))
            if sizes[i] > longest:
                longest, longest_kept = int(sizes[i]), kept[i]
    return {"runs_an_image": runs, "pairs": pairs, "longest_run": longest,
            "longest_run_kept": longest_kept}


def _det_nms_kernel(call) -> dict:
    """The scan kernel on the sorted inputs of one captured main-path call
    (``_nms_captured``): its device time (CUDA graph; the wrapper's label
    reorder included), the plain version's time on the same card tensors,
    its bound from this run's data: 13 f32 operations (``csrc/nms.cu``) a
    pair of boxes the greedy scan must compare, over 67 TFLOP/s, against
    the boxes, labels and counts read and the keep mask written once over
    3.35 TB/s.  Boxes of two labels never suppress each other at a
    threshold >= 0, so with labels the pairs are the sum over images and
    labels of K_l (K_l - 1) / 2 (:func:`_nms_runs`, with the runs the
    kernel walks).  Also the device kernels one call puts on the card, by
    ``torch.profiler`` (:func:`device_kernels`: the reorder's PyTorch ops
    and the mask and scan kernels), with their device ms, and the bytes one
    call allocates on the card above what was allocated before it (the
    allocator's peak: the reorder's tensors, the sort's temporary storage,
    the mask scratch and ``keep``)."""
    import torch
    from dt_tpu_torch.ops import kernels as K
    sb, sl, counts, thr, keep = call
    ms = cuda_ms(lambda a: K.nms_keep(*a, thr), [(sb, sl, counts)], iters=5)
    torch.cuda.synchronize()
    t = time.perf_counter()
    K.nms_keep_plain(sb, sl, counts, thr)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    runs = _nms_runs(sl, counts, thr, keep)
    ops = runs["pairs"] * 13
    b, n = sb.shape[:2]
    nbytes = b * n * (16 + (0 if sl is None else 4) + 1) + b * 4
    bound_ms = max(ops / 67e12, nbytes / 3.35e12) * 1e3
    # the split is reported, not gated: in phase 25 the profiler has
    # recorded none of the scan's kernels in PROFILE_WINDOWS windows in a
    # row (two whole runs on an H100), while the launch count stays gated
    events = device_kernels(lambda: K.nms_keep(sb, sl, counts, thr),
                            K.nms_keep, required=False,
                            need=("nms_mask_kernel", "nms_scan_kernel"))
    by_kernel = {}
    for name, t in events:  # kernels, memsets and copies, by name
        c, total = by_kernel.get(name[:60], (0, 0.0))
        by_kernel[name[:60]] = [c + 1, total + t]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.nms_keep(sb, sl, counts, thr)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops / 67e12 > nbytes / 3.35e12
            else "bytes", "library_ms": None, "counts": counts.tolist(),
            "kept": int(keep.sum()), "shape": [b, n],
            # None and {}: not measured (the profiler recorded no window)
            "device_kernels": by_kernel, "kernels_a_call": len(events)
            or None,
            "peak_bytes_a_call": peak, **runs}


def _det_serve(trained, size, batch, dev, gpu) -> dict:
    """(c) SSD served by name through ``Predictor`` from a checkpoint of
    the bf16 training state, at buckets 1 and ``batch`` (one
    ``fused_bn_inference`` a BN a request); bucket ``batch`` against the
    model's own eval forward within ``TOL_BF16``."""
    import tempfile
    import torch
    from dt_tpu_torch.predictor import Predictor
    from dt_tpu_torch.training import checkpoint
    model = trained["model"]
    _, _, _, imgs = _det_batch("ssd", size, batch, 7, dev, torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "ssd")
        checkpoint.save_checkpoint(prefix, 0, trained["state"])
        pred = Predictor("ssd", prefix, 0, imgs[:1], dtype=torch.bfloat16,
                         batch_buckets=[1, batch], device=dev,
                         num_classes=20)
    pred.warmup((size, size, 3))
    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
    outs = [pred.predict(imgs[:b]) for b in (1, batch)]
    counts = read_counts()  # ... and ends here
    want = {k: 0 for k in counts}
    want.update(bn_act=2 * trained["bn"])
    _check_counts("detection ssd (c) serve bf16", counts, want)
    with torch.no_grad():
        ref = model(torch.from_numpy(imgs).to(dev, torch.bfloat16)
                    .permute(0, 3, 1, 2))[0].float().cpu().numpy()
    err = float(np.abs(outs[1] - ref).max())
    if outs[0].shape != (1,) + ref.shape[1:] or \
            not err <= TOL_BF16 * float(np.abs(ref).max()):
        raise AssertionError(f"detection ssd (c): the checkpoint's "
                             f"Predictor is {err:.3e} from the model")
    ms = {}
    for b in (1, batch):
        t = time.perf_counter()
        for _ in range(3):
            pred.predict(imgs[:b])
        ms[b] = (time.perf_counter() - t) * 1e3 / 3
    print(f"detection ssd (c) serve bf16 by name from a checkpoint: bucket "
          f"{batch} {err:.3e} from the model's eval forward (largest "
          f"{np.abs(ref).max():.3f}) " + " ".join(
              f"bucket={b} ms_per_request={v:.3f}" for b, v in ms.items())
          + f" gpu={gpu}", flush=True)
    return {"counts": counts, "err": err, "ms": ms}


def _det_records(path, n, size, seed) -> None:
    """``n`` raw u8 detection records of ``size``^2 x 3 from the SSD
    example's generator: labels ``[class, x1, y1, x2, y2]`` a box,
    normalized."""
    from dt_tpu_torch.data import recordio
    gen = _det_example("ssd")
    rng = np.random.RandomState(seed)
    with recordio.RecordIOWriter(path) as w:
        for i in range(n):
            img, boxes, labels = gen(rng, 1, size, DETECT_CLASSES["ssd"],
                                     DETECT_BOXES["ssd"])
            real = labels[0] >= 0
            lab = np.concatenate([labels[0][real, None].astype(np.float32),
                                  boxes[0][real]], 1)
            w.write(recordio.pack_label(
                (img[0] * 255).round().astype(np.uint8).tobytes(), lab,
                rec_id=i))


def _det_rec_steps(trained, size, batch, dev, gpu) -> dict:
    """(d) SSD fed from raw u8 records through ``ImageDetRecordIter`` with
    ``ssd_train_augmenter`` (colour distortion, mirror, zoom-out pad,
    IoU-constrained crop), as ``examples/train_ssd.py:73-93`` feeds it, and
    last in the chain a ``native`` resize to ``size`` (PIL-free; the boxes
    are normalized, so only the image moves), which leaves the iterator's
    own PIL resize nothing to do:
    ``DETECT_REC["steps"]`` steps of the bf16 state, loss finite; the
    iterator's images/s alone."""
    import tempfile
    import torch
    from dt_tpu_torch.data import augment, recordio
    model, state = trained["model"], trained["state"]
    step = _det_step("ssd", model, state, size)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "det.rec")
        t = time.perf_counter()
        _det_records(path, DETECT_REC["records"], size, 25)
        write_s = time.perf_counter() - t

        def make():
            return recordio.ImageDetRecordIter(
                path, (size, size, 3), batch, max_objs=DETECT_BOXES["ssd"],
                shuffle=True, seed=0, dtype="uint8",
                det_augmenter=augment.DetCompose(
                    augment.ssd_train_augmenter(seed=0),
                    augment.DetImageOnly(augment.Resize(
                        (size, size), backend="native"))))

        it = make()
        t = time.perf_counter()
        n = sum(len(b.data) - b.pad for b in it)
        iter_s = time.perf_counter() - t
        it = make()
        reset_counts()  # the main path's run starts here
        losses = []
        for b in it:
            x = torch.from_numpy(np.asarray(b.data)).to(dev).to(
                torch.bfloat16).div_(255.0).permute(0, 3, 1, 2)
            lab = torch.from_numpy(np.asarray(b.label)).to(dev)
            losses.append(step(x, lab[..., 1:5].contiguous(),
                               lab[..., 0].long()))
        torch.cuda.synchronize()
        counts = read_counts()  # ... and ends here
    losses = [float(v) for v in losses]
    steps = DETECT_REC["steps"]
    want = {k: 0 for k in counts}
    want.update(bn_stats=trained["bn"] * steps, bn_act=trained["bn"] * steps)
    _check_counts("detection ssd (d) .rec steps", counts, want)
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"detection ssd (d): losses {losses}")
    print(f"detection ssd (d) {DETECT_REC['records']} raw u8 records "
          f"({write_s:.1f} s to write) through ImageDetRecordIter + "
          f"ssd_train_augmenter: iterator alone {n / iter_s:.1f} images/s; "
          f"{steps} bf16 steps, losses {[round(v, 4) for v in losses]} "
          f"gpu={gpu}", flush=True)
    return {"counts": counts, "losses": losses, "iter_imgs_per_s":
            n / iter_s}


def detection_phase(gpu, dev) -> dict:
    """Phase 25, the detectors: for each of ``test_torch_shapes.DETECTORS``
    (a) the BN kernels held on the main path's own inputs, (b) training in
    bf16 and f32, (c) the detection stage on a fresh batch held against
    its plain CPU version, its ms, the scan kernel against its plain
    version; SSD served by name from a checkpoint; (d) SSD fed from
    detection records.  The phase's time and the main path's launches."""
    import torch
    from dt_tpu_torch.models.common import FusedBatchNorm
    from test_torch_shapes import DETECTORS
    t0 = time.perf_counter()
    pil = "PIL" in sys.modules
    runs, held, detect, launches = {}, {}, {}, {}
    for name, size, batch, kw in DETECTORS:
        # (a) the BN kernels on the main path's inputs (a fresh bf16 model)
        model = _det_model(name, torch.bfloat16, dev, kw)
        x = _det_batch(name, size, batch, 0, dev, torch.bfloat16)[0]
        held[name] = _bn_kernels_on_path(model, [(True, x, {}),
                                                 (False, x[:1], {})])
        n_bn = sum(isinstance(m, FusedBatchNorm) for m in model.modules())
        h = held[name]
        print(f"detection {name} (a) bf16 at the main path's {h['bn_inputs']}"
              f" BN inputs ({h['shapes']} (rows, C)): pass 1 max_err/E[x^2]="
              f"{h['stats_rel_err']:.3e} (tol {TOL_ZOO['stats']:.0e}), pass 2"
              f" and inference elements unequal to plain: "
              f"{h['mismatches']}", flush=True)
        if h["bn_inputs"] != 2 * n_bn or h["mismatches"] or \
                not h["stats_rel_err"] <= TOL_ZOO["stats"]:
            raise AssertionError(f"detection {name} (a): {h}")
        del model
        # (b) training
        for dtype in (torch.bfloat16, torch.float32):
            runs[name, dtype] = _det_train(name, size, batch, kw, dtype, dev,
                                           gpu)
        # (c) detection from each trained model, on a fresh batch and on
        # the batch it fit, at the default score threshold; FasterRCNNMini
        # also at threshold 0, which scans every ROI (after 15 steps its
        # head may call every ROI background at 0.05)
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"detection {name} {str(dtype).split('.')[-1]}"
            model = runs[name, dtype]["model"]
            xs = [_det_batch(name, size, batch, seed, dev, dtype)[0]
                  for seed in (5, 0)]
            calls = [(0, {}), (1, {})] + ([(0, {"score_threshold": 0.0})]
                                          if name == "faster_rcnn" else [])
            torch.cuda.synchronize()
            with _nms_captured() as nms_calls, torch.no_grad():
                reset_counts()  # the main path's run starts here
                outs = [model(x) for x in xs]
                gots = [_det_detect(name, outs[i], **kw) for i, kw in calls]
                torch.cuda.synchronize()
                counts = read_counts()  # ... and ends here
            want = {k: 0 for k in counts}
            want.update(bn_act=2 * runs[name, dtype]["bn"],
                        nms_keep=len(calls) + (2 if name == "faster_rcnn"
                                               else 0))
            _check_counts(f"{tag} (c) detect", counts, want)
            res_nms = _det_hold_nms(nms_calls, f"{tag} (c) detect")
            thr = 0.45 if name == "ssd" else 0.5
            held_c = [_det_hold_detect(name, outs[i], g, thr, kw)
                      for (i, kw), g in zip(calls, gots)]
            res = {k: max(h[k] for h in held_c)
                   for k in ("scores_rel_err", "boxes_rel_err")}
            res["flips"] = sum(h["flips"] for h in held_c)
            res["kept"] = [h["kept"] for h in held_c]
            if not res["kept"][-1]:
                raise AssertionError(f"{tag} (c): nothing kept: the scan "
                                     "was not exercised")
            x, out = xs[0], outs[0]
            with torch.no_grad():
                res["detect_ms"] = _events_ms(lambda: _det_detect(name, out))
                res["forward_ms"] = _events_ms(lambda: model(x))
            res["counts"], res["nms_held"] = counts, res_nms
            print(f"{tag} (c) detect batch {batch}: decode+nms_ms="
                  f"{res['detect_ms']:.3f} forward_ms={res['forward_ms']:.3f}"
                  f" kept (fresh, fit batch[, fresh at threshold 0])="
                  f"{res['kept']} scores/boxes rel err "
                  f"{res['scores_rel_err']:.2e}/{res['boxes_rel_err']:.2e} "
                  f"against the CPU, flipped decisions {res['flips']} "
                  f"gpu={gpu}", flush=True)
            if name == "ssd" and dtype == torch.bfloat16:
                # the fresh batch's call, the first of the run
                res["nms"] = k = _det_nms_kernel(nms_calls[0])
                print(f"{tag} (c) nms_keep at {k['shape']}: ms={k['ms']:.3f}"
                      f" plain_ms={k['plain_ms']:.1f} bound_ms="
                      f"{k['bound_ms']:.5f} ({k['bound_by']}, {k['pairs']} "
                      f"same-label pairs) scanned={sum(k['counts'])} "
                      f"kept={k['kept']} runs an image (min/max)="
                      f"{min(k['runs_an_image'])}/{max(k['runs_an_image'])}"
                      f" longest run {k['longest_run']} boxes, "
                      f"{k['longest_run_kept']} kept; device kernels a "
                      f"call {k['kernels_a_call'] or 'not measured'} "
                      f"{json.dumps(k['device_kernels'])}; bytes one call "
                      f"allocates (peak over what was allocated before) "
                      f"{k['peak_bytes_a_call']} gpu={gpu}",
                      flush=True)
            detect[name, dtype] = res
        launches[name] = {
            str(dt).split(".")[-1]: {
                "train": runs[name, dt]["counts"],
                "detect": detect[name, dt]["counts"]}
            for dt in (torch.bfloat16, torch.float32)}
    # SSD served, then fed from records (the bf16 state)
    size, batch = DETECTORS[0][1], DETECTORS[0][2]
    served = _det_serve(runs["ssd", torch.bfloat16], size, batch, dev, gpu)
    rec = _det_rec_steps(runs["ssd", torch.bfloat16], size, batch, dev, gpu)
    launches["ssd"]["bfloat16"]["serve"] = served["counts"]
    launches["ssd"]["bfloat16"]["rec"] = rec["counts"]
    if "PIL" in sys.modules and not pil:
        raise AssertionError("detection phase: imported PIL")
    secs = time.perf_counter() - t0
    print(f"detection phase: launches {json.dumps(launches)} total "
          f"{secs:.1f} s gpu={gpu}", flush=True)
    for r in runs.values():
        del r["model"], r["state"]
    torch.cuda.empty_cache()
    return {"runs": runs, "held": held, "detect": detect, "serve": served,
            "rec": rec, "launches": launches, "seconds": secs}


# --- phase 26: int8 quantization and ONNX -----------------------------------
# examples/quantize_model.py's defaults: a 4-way task of 64 features, 4096
# training rows and 1024 held out, a 64-128-128-4 MLP, adam 1e-3 for 30
# epochs of 256, 8 calibration batches; the int8 top-1 within 0.02 of fp32
QUANT = dict(features=64, hidden=128, classes=4, train=4096, val=1024,
             batch=256, epochs=30, calib_batches=8, lr=1e-3, seed=0)
QUANT_GATE = 0.02
QUANT_PER_FORWARD = 3  # quantized_dense calls an int8 forward
QUANT_MODEL = "resnet50"  # (a)'s shapes and (c)'s export, at full width
ONNX_REQUESTS = (1, 32, 130)  # 130: chunks of 32 + a padded 2
ONNX_BUCKET = 32
ONNX_REPS = 5  # requests timed a predictor, in turns
TOL_ONNX = 1e-4  # of the native Predictor's largest logit
INT8_TOPS = 1979e12  # H100 SXM dense int8 (data sheet)
HBM_BYTES_S = 3.35e12


def _quant_task(n: int, seed: int):
    """``examples/quantize_model.py``'s ``make_task``: the quadrant of the
    means of the two halves of 64 normal features."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (n, QUANT["features"])).astype("float32")
    a = x[:, :32].mean(1) > 0
    b = x[:, 32:].mean(1) > 0
    return x, (2 * a + b).astype("int64")


def _quant_forward(p, xb, taps=False):
    import torch
    h1 = torch.relu(xb @ p["w1"] + p["b1"])
    h2 = torch.relu(h1 @ p["w2"] + p["b2"])
    out = h2 @ p["w3"] + p["b3"]
    return (out, {"in": xb, "h1": h1, "h2": h2}) if taps else out


def _int8_forward(Q, p, ranges, qw, xb):
    """The example's int8 forward: each dense an int8 product with an int32
    accumulator (``quantized_dense``), the activations quantized again
    against the calibrated ranges between layers."""
    import torch
    xq, xs = Q.quantize(xb, *ranges["in"])
    h1 = torch.relu(Q.quantized_dense(xq, qw["w1"][0], xs, qw["w1"][1])
                    + p["b1"])
    h1q, h1s = Q.quantize(h1, *ranges["h1"])
    h2 = torch.relu(Q.quantized_dense(h1q, qw["w2"][0], h1s, qw["w2"][1])
                    + p["b2"])
    h2q, h2s = Q.quantize(h2, *ranges["h2"])
    return Q.quantized_dense(h2q, qw["w3"][0], h2s, qw["w3"][1]) + p["b3"]


def _quant_mlp(dev, gpu) -> dict:
    """Phase 26 (b): ``examples/quantize_model.py`` in the port on the card.
    Train fp32 (the port's adam), calibrate (naive and entropy), quantize
    the weights offline, serve int8: top-1 against fp32, 3 ``qconv``
    launches an int8 forward (counted over both modes' forwards, the main
    path's run), each forward bit-equal to the same forward on the kernel's
    plain version.  Returns the accuracies, the launches and the three
    ``quantized_dense`` calls of one int8 forward for (a)."""
    import torch
    from dt_tpu_torch.ops import kernels, losses
    from dt_tpu_torch.ops import quantization as Q
    from dt_tpu_torch.optim import optimizers
    t0 = time.perf_counter()
    q = QUANT
    x, y = _quant_task(q["train"], q["seed"])
    vx, vy = _quant_task(q["val"], q["seed"] + 1)
    rng = np.random.RandomState(q["seed"])
    f, h, c = q["features"], q["hidden"], q["classes"]
    shapes = {"w1": (f, h), "b1": (h,), "w2": (h, h), "b2": (h,),
              "w3": (h, c), "b3": (c,)}
    params = {k: torch.from_numpy(
        (rng.normal(0, 1, s) * 0.1 if k[0] == "w" else np.zeros(s))
        .astype(np.float32)).to(dev).requires_grad_(True)
        for k, s in shapes.items()}
    rule = optimizers.adam(learning_rate=q["lr"])
    state = rule.init(params)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    first = last = None
    for _ in range(q["epochs"]):
        for i in range(0, q["train"], q["batch"]):
            loss = losses.softmax_cross_entropy(
                _quant_forward(params, xt[i:i + q["batch"]]),
                yt[i:i + q["batch"]])
            grads = torch.autograd.grad(loss, list(params.values()))
            state = rule.update(dict(zip(params, grads)), state, params)
            first = float(loss.detach()) if first is None else first
    last = float(loss.detach())
    train_s = time.perf_counter() - t0
    p = {k: v.detach() for k, v in params.items()}
    vxt = torch.from_numpy(vx).to(dev)

    def acc(logits) -> float:
        return float((logits.argmax(-1).cpu().numpy() == vy).mean())

    with torch.no_grad():
        fp32 = acc(_quant_forward(p, vxt))
        collector = Q.MinMaxCollector()
        chunks = {"in": [], "h1": [], "h2": []}
        for i in range(q["calib_batches"]):
            _, taps = _quant_forward(p, xt[i * q["batch"]:(i + 1) * q["batch"]],
                                     taps=True)
            for name, v in taps.items():
                collector.collect(name, v)
                chunks[name].append(v.cpu().numpy())
        qw = {}
        for name in ("w1", "w2", "w3"):
            amax = float(p[name].abs().max())
            qw[name] = Q.quantize(p[name], -amax, amax)
        out = {"fp32": fp32, "loss": [first, last], "int8": {},
               "train_s": train_s}
        calls = []
        real_dense = Q.quantized_dense

        def recording(*args, **kw):  # the kernel's inputs, for (a)
            calls.append((args, kw))
            return real_dense(*args, **kw)

        torch.cuda.synchronize()
        reset_counts()  # the main path's run starts here
        logits = {}
        for mode in ("naive", "entropy"):
            if mode == "entropy":
                ranges = {}
                for name, parts in chunks.items():
                    t = Q.entropy_calibrate(np.concatenate(parts))
                    ranges[name] = (-t, t)
            else:
                ranges = collector.ranges
            Q.quantized_dense = recording if mode == "naive" else real_dense
            try:
                logits[mode] = (_int8_forward(Q, p, ranges, qw, vxt), ranges)
            finally:
                Q.quantized_dense = real_dense
        torch.cuda.synchronize()
        counts = read_counts()  # ... and ends here
        routes = dict(kernels.qconv.routes)
        counted = counts.pop("qconv")
        packed = counts.pop("qconv_pack")
        # one pack a weight (the first forward's), served from the cache
        # after; every dense call on the tma route (1x1, stride 1)
        if counted != 2 * QUANT_PER_FORWARD or packed != QUANT_PER_FORWARD \
                or routes != {"tma": counted, "gather": 0, "narrow": 0} \
                or any(counts.values()):
            raise AssertionError(f"phase 26 (b): launches {counted} qconv "
                                 f"(want {2 * QUANT_PER_FORWARD}), {packed} "
                                 f"qconv_pack (want {QUANT_PER_FORWARD}), "
                                 f"routes {routes} and {counts}")
        real_qconv = kernels.qconv
        for mode, (got, ranges) in logits.items():
            kernels.qconv = kernels.qconv_plain  # the same forward, plain
            try:
                plain = _int8_forward(Q, p, ranges, qw, vxt)
            finally:
                kernels.qconv = real_qconv
            top1 = acc(got)
            same = bool(torch.equal(got, plain))
            out["int8"][mode] = {"top1": top1, "bit_equal_to_plain": same,
                                 "ranges": {k: [round(a, 4), round(b, 4)]
                                            for k, (a, b) in ranges.items()}}
            print(f"quant (b) {mode}: fp32 top-1 {fp32:.4f} int8 top-1 "
                  f"{top1:.4f} (delta {fp32 - top1:+.4f}, gate "
                  f"{QUANT_GATE}) bit-equal to the plain forward {same} "
                  f"ranges {out['int8'][mode]['ranges']}", flush=True)
            if not same or fp32 - top1 > QUANT_GATE or fp32 < 0.5:
                raise AssertionError(f"phase 26 (b) {mode}: fp32 {fp32}, "
                                     f"int8 {top1}, bit-equal {same}")
    out.update(launches=counted, pack_launches=packed, routes=routes,
               calls=calls, seconds=time.perf_counter() - t0)
    print(f"quant (b) examples/quantize_model.py defaults: loss "
          f"{first:.4f} -> {last:.4f} in {q['epochs']} epochs "
          f"({train_s:.1f} s), qconv launches {counted} "
          f"({QUANT_PER_FORWARD} an int8 forward; routes {routes}), "
          f"qconv_pack launches {packed}, {out['seconds']:.1f} s "
          f"gpu={gpu}", flush=True)
    return out


def _resnet_qconv_cases(dev, variables, images) -> list:
    """Every distinct convolution of ResNet-50 v1 at 224x224, batch 32, and
    its dense head, on int8 codes of a seeded float forward: each layer's
    input captured by a pre-hook, quantized over its ``MinMaxCollector``
    range; the weights from ``quantize_params``.  Returns (tag, calls in a
    forward, xq NHWC, wq HWIO, x scale, w scale, stride, pads, bias)."""
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.models.common import Conv, Dense
    from dt_tpu_torch.ops import nn as nn_ops
    from dt_tpu_torch.ops import quantization as Q
    model = load_jax_variables(models.create(QUANT_MODEL, device=dev),
                               variables).eval()
    seen = {}

    def hook(mod, args):
        x = args[0]
        if isinstance(mod, Conv):
            kh, kw = mod.weight.shape[2:]
            pads = nn_ops._pads(mod.padding, tuple(x.shape[2:]), (kh, kw),
                                mod.strides)
            key = (tuple(x.shape), tuple(mod.weight.shape), mod.strides,
                   pads)
        else:
            key = (tuple(x.shape), tuple(mod.weight.shape))
        if key in seen:
            seen[key][1] += 1
        else:
            seen[key] = [mod, 1, x.detach().clone()]

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    x = torch.from_numpy(images[:BATCH]).to(dev).permute(0, 3, 1, 2)
    with torch.inference_mode():
        model(x)
    for hk in hooks:
        hk.remove()
    collector = Q.MinMaxCollector()
    cases = []
    # no_grad, not inference mode: the weights keep a version counter, so
    # the kernel's packed copy of each is cached as a served model's is
    with torch.no_grad():
        for i, (key, (mod, n, act)) in enumerate(seen.items()):
            tag = f"l{i}"
            collector.collect(tag, act)
            if isinstance(mod, Conv):
                w = mod.weight.permute(2, 3, 1, 0).contiguous()  # HWIO
                act = act.permute(0, 2, 3, 1)  # NHWC (channels_last)
                stride, pads, bias = mod.strides, key[3], None
            else:
                w = mod.weight.t().contiguous()
                act = act.reshape(act.shape[0], 1, 1, act.shape[-1])
                w = w.reshape(1, 1, *w.shape)
                stride, pads, bias = (1, 1), ((0, 0), (0, 0)), mod.bias
            xq, xs = Q.quantize(act.contiguous(), *collector.ranges[tag])
            qp = Q.quantize_params({"w": w})["w"]
            cases.append((tag, n, xq, qp["q"], xs, qp["scale"],
                          tuple(stride), pads, bias))
    del model, seen
    return cases


def _int_mm_ms(xq, wq, stride, pads):
    """``torch._int_mm`` (one PyTorch call, cuBLASLt's int8 GEMM; never
    called by the port) over the same GEMM: the im2col'ed A (not timed)
    and B padded with zeros to its shape rules (K and N multiples of 8).
    Returns (ms, error or None)."""
    import torch
    import torch.nn.functional as F
    from dt_tpu_torch.ops import kernels
    kh, kw, c, n = wq.shape
    (pt, pb), (pl, pr) = pads
    xh = F.pad(xq.permute(0, 3, 1, 2).half(), (pl, pr, pt, pb))
    cols = F.unfold(xh, (kh, kw), stride=tuple(stride))  # (B, C kh kw, L)
    a = cols.transpose(1, 2).reshape(-1, cols.shape[1])
    k, m = a.shape[1], a.shape[0]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    a8 = torch.zeros((max(m, 17), kp), dtype=torch.int8, device=xq.device)
    a8[:m, :k] = a.to(torch.int8)
    b8 = torch.zeros((kp, np_), dtype=torch.int8, device=xq.device)
    b8[:k, :n] = wq.permute(2, 0, 1, 3).reshape(k, n)
    del cols, a, xh
    for b in (b8, b8.t().contiguous().t()):
        try:
            got = torch._int_mm(a8, b)
            acc = kernels.qconv_acc_plain(xq, wq, stride, pads)
            if not torch.equal(got[:m, :n], acc.reshape(m, n)):
                return None, "its product differs from the accumulator"
            return cuda_ms(lambda t: torch._int_mm(t, b), [a8]), None
        except RuntimeError as e:
            err = str(e).splitlines()[0][:120]
    return None, err


def _qconv_case(case, dev, time_it=True) -> dict:
    """One shape: the kernel against its plain version in float32 and
    bfloat16 output (bit-equal, two launches bit-identical), then the
    kernel's, the plain version's and ``torch._int_mm``'s times and the
    bound."""
    import torch
    from dt_tpu_torch.ops import kernels
    tag, n_calls, xq, wq, xs, ws, stride, pads, bias = case
    d = (xs * ws).to(dev)
    b32 = None if bias is None else bias.detach().float().contiguous()
    err, equal = 0.0, True
    for dtype in (torch.float32, torch.bfloat16):
        y1 = kernels.qconv(xq, wq, stride, pads, d, b32, dtype)
        y2 = kernels.qconv(xq, wq, stride, pads, d, b32, dtype)
        ref = kernels.qconv_plain(xq, wq, stride, pads, d, b32, dtype)
        torch.cuda.synchronize()
        equal &= bool(torch.equal(y1, ref) and torch.equal(y1, y2))
        err = max(err, float((y1.float() - ref.float()).abs().max()))
    kh, kw, c, n = wq.shape
    m = y1.shape[0] * y1.shape[1] * y1.shape[2]
    k = kh * kw * c
    ops = 2.0 * m * n * k
    moved = xq.numel() + wq.numel() + 4 * m * n \
        + (0 if b32 is None else 4 * n)
    bound_ops, bound_bytes = ops / INT8_TOPS * 1e3, moved / HBM_BYTES_S * 1e3
    plan = kernels.qconv_plan(tuple(xq.shape), tuple(wq.shape), stride, pads,
                              torch.float32)
    out = {"tag": tag, "calls": n_calls, "m": m, "n": n, "k": k,
           "x": list(xq.shape), "stride": list(stride),
           "pads": [list(p) for p in pads], "bit_equal": equal,
           "max_abs_err": err, "bound_ms": max(bound_ops, bound_bytes),
           "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
           "route": plan.route, "bn": plan.bn, "grid": plan.grid,
           "mma_sync_ms": QCONV_MMA_SYNC_MS.get(
               _qconv_shape_key(xq, wq, stride))}
    if time_it:
        # inputs rotated past the 50 MB L2 where one is smaller
        copies = [xq] + [xq.clone() for _ in range(
            min(7, (60 << 20) // max(xq.numel(), 1)))]
        out["ms"] = cuda_ms(lambda a: kernels.qconv(
            a, wq, stride, pads, d, b32, torch.float32), copies)
        # the weight's pack, once a weight (an inference copy is never
        # cached, so each call launches it)
        with torch.inference_mode():
            frozen = wq.clone()
        packed = kernels.qconv_pack(frozen, plan.cp, plan.kwp)
        want = kernels.qconv_pack_plain(wq, plan.cp, plan.kwp)
        out["pack_err"] = int((packed.int() - want.int()).abs().max())
        out["bit_equal"] &= bool(torch.equal(packed, want))
        out["pack_ms"] = cuda_ms(
            lambda w: kernels.qconv_pack(w, plan.cp, plan.kwp), [frozen])
        out["pack_plain_ms"] = _events_ms(
            lambda: kernels.qconv_pack_plain(wq, plan.cp, plan.kwp), iters=3)
        # one PyTorch copy computes the pack where it pads nothing (every
        # 1x1 layer with C a multiple of 16, the MLP's weights)
        out["pack_library_ms"] = cuda_ms(
            lambda w: w.reshape(-1, n).t().contiguous(), [wq]) \
            if (plan.cp, plan.kwp) == (c, kw) else None
        if tag.startswith("mlp"):
            # a weight quantized under inference mode keeps no version
            # counter, so it is packed anew on every call: the call's cost
            out["inference_weight_ms"] = cuda_ms(lambda a: kernels.qconv(
                a, frozen, stride, pads, d, b32, torch.float32), copies)
        out["plain_ms"] = _events_ms(lambda: kernels.qconv_plain(
            xq, wq, stride, pads, d, b32, torch.float32), iters=3)
        out["library_ms"], out["library_note"] = _int_mm_ms(xq, wq, stride,
                                                            pads)
        out["tops"] = ops / out["ms"] / 1e9
    return out


#: the earlier int8 kernel (``mma.sync`` m16n8k32, 128 x 64 tiles, HWIO
#: read directly; ``csrc/qconv.cu`` at commit 0721b42) at each shape of
#: (a), float32 output, ms by ``cuda_ms`` as (a) times it:
#: ``tests/torch_qconv_ab.py`` (that source built beside this tree's, timed
#: in turns with it, the least of two), one run on an NVIDIA H100 80GB HBM3
#: at 700.00 W
QCONV_MMA_SYNC_MS = {
    "[32, 224, 224, 3]x[7, 7, 3, 64]s[2, 2]": 0.40689,
    "[32, 56, 56, 64]x[1, 1, 64, 64]s[1, 1]": 0.03289,
    "[32, 56, 56, 64]x[3, 3, 64, 64]s[1, 1]": 0.06178,
    "[32, 56, 56, 64]x[1, 1, 64, 256]s[1, 1]": 0.12928,
    "[32, 56, 56, 256]x[1, 1, 256, 64]s[1, 1]": 0.05168,
    "[32, 56, 56, 256]x[1, 1, 256, 128]s[1, 1]": 0.09749,
    "[32, 56, 56, 128]x[3, 3, 128, 128]s[2, 2]": 0.05848,
    "[32, 28, 28, 128]x[1, 1, 128, 512]s[1, 1]": 0.07875,
    "[32, 56, 56, 256]x[1, 1, 256, 512]s[2, 2]": 0.09328,
    "[32, 28, 28, 512]x[1, 1, 512, 128]s[1, 1]": 0.03726,
    "[32, 28, 28, 128]x[3, 3, 128, 128]s[1, 1]": 0.05502,
    "[32, 28, 28, 512]x[1, 1, 512, 256]s[1, 1]": 0.07241,
    "[32, 28, 28, 256]x[3, 3, 256, 256]s[2, 2]": 0.08066,
    "[32, 14, 14, 256]x[1, 1, 256, 1024]s[1, 1]": 0.04823,
    "[32, 28, 28, 512]x[1, 1, 512, 1024]s[2, 2]": 0.06886,
    "[32, 14, 14, 1024]x[1, 1, 1024, 256]s[1, 1]": 0.04559,
    "[32, 14, 14, 256]x[3, 3, 256, 256]s[1, 1]": 0.07196,
    "[32, 14, 14, 1024]x[1, 1, 1024, 512]s[1, 1]": 0.05623,
    "[32, 14, 14, 512]x[3, 3, 512, 512]s[2, 2]": 0.13782,
    "[32, 7, 7, 512]x[1, 1, 512, 2048]s[1, 1]": 0.04272,
    "[32, 14, 14, 1024]x[1, 1, 1024, 2048]s[2, 2]": 0.07204,
    "[32, 7, 7, 2048]x[1, 1, 2048, 512]s[1, 1]": 0.07032,
    "[32, 7, 7, 512]x[3, 3, 512, 512]s[1, 1]": 0.11285,
    "[32, 1, 1, 2048]x[1, 1, 2048, 1000]s[1, 1]": 0.05181,
    "[1024, 1, 1, 64]x[1, 1, 64, 128]s[1, 1]": 0.00632,
    "[1024, 1, 1, 128]x[1, 1, 128, 128]s[1, 1]": 0.00827,
    "[1024, 1, 1, 128]x[1, 1, 128, 4]s[1, 1]": 0.00692,
}


def _qconv_shape_key(xq, wq, stride) -> str:
    return f"{list(xq.shape)}x{list(wq.shape)}s{list(stride)}"


def _quant_kernel(dev, gpu, variables, images, mlp) -> dict:
    """Phase 26 (a): the kernel at every distinct ResNet-50 v1 shape (batch
    32) and the quantize example's three dense calls (the main path's
    shapes), held and timed; sums over one forward."""
    import torch
    from dt_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    cases = _resnet_qconv_cases(dev, variables, images)
    rows = []
    for case in cases:
        r = _qconv_case(case, dev)
        rows.append(r)
        print(f"quant (a) {QUANT_MODEL} {r['tag']} x{r['calls']} x={r['x']} "
              f"k={r['k']} n={r['n']} stride={r['stride']} pads={r['pads']}"
              f" route={r['route']} bn={r['bn']} grid={r['grid']}"
              f": bit_equal={r['bit_equal']} ms={r['ms']:.4f} (mma.sync: "
              f"{r['mma_sync_ms']}) plain_ms="
              f"{r['plain_ms']:.3f} int_mm_ms={r['library_ms']} bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']}) TOP/s={r['tops']:.1f}"
              f" pack_ms={r['pack_ms']:.4f}"
              + (f" int_mm: {r['library_note']}" if r["library_note"]
                 else ""), flush=True)
    mlp_rows = []
    for i, (args, kw) in enumerate(mlp["calls"]):
        xq, wq, xs, ws = args[:4]
        m, k = xq.shape
        case = (f"mlp{i}", 1, xq.reshape(m, 1, 1, k),
                wq.reshape(1, 1, *wq.shape), xs, ws, (1, 1),
                ((0, 0), (0, 0)), None)
        r = _qconv_case(case, dev)
        mlp_rows.append(r)
        print(f"quant (a) mlp dense {m}x{k}x{r['n']}: bit_equal="
              f"{r['bit_equal']} ms={r['ms']:.4f} (mma.sync: "
              f"{r['mma_sync_ms']}) "
              f"pack_ms={r['pack_ms']:.4f} plain_ms="
              f"{r['plain_ms']:.3f} int_mm_ms={r['library_ms']} bound_ms="
              f"{r['bound_ms']:.5f} ({r['bound_by']})"
              + (f" int_mm: {r['library_note']}" if r["library_note"]
                 else ""), flush=True)
    bad = [r["tag"] for r in rows + mlp_rows if not r["bit_equal"]]
    if bad:
        raise AssertionError(f"phase 26 (a): the kernel differs from its "
                             f"plain version at {bad}")

    def total(rs, key):
        if any(r[key] is None for r in rs):
            return None
        return sum(r[key] * r["calls"] for r in rs)

    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    forward = {key: total(rows, key) for key in keys}
    forward.update(shapes=len(rows), calls=sum(r["calls"] for r in rows),
                   pack_ms=sum(r["pack_ms"] for r in rows),
                   pack_plain_ms=sum(r["pack_plain_ms"] for r in rows),
                   routes={rt: sum(r["calls"] for r in rows
                                   if r["route"] == rt)
                           for rt in kernels.QCONV_ROUTES})
    main = {key: total(mlp_rows, key) for key in keys}
    main.update(pack_ms=sum(r["pack_ms"] for r in mlp_rows),
                pack_plain_ms=sum(r["pack_plain_ms"] for r in mlp_rows),
                pack_library_ms=total(mlp_rows, "pack_library_ms"),
                pack_bound_ms=sum(2 * r["k"] * r["n"] / HBM_BYTES_S * 1e3
                                  for r in mlp_rows),
                inference_weight_ms=total(mlp_rows, "inference_weight_ms"))
    # the earlier kernel's figures (a constant from an earlier run) are
    # printed beside this run's, never put in the kernels line
    slower = [r["tag"] for r in rows if r["mma_sync_ms"] is not None
              and r["ms"] > r["mma_sync_ms"]]
    secs = time.perf_counter() - t0
    print(f"quant (a) {QUANT_MODEL} int8 forward (batch {BATCH}, "
          f"{forward['calls']}"
          f" calls over {len(rows)} shapes): kernel {forward['ms']:.3f} ms "
          f"(the mma.sync kernel: {total(rows, 'mma_sync_ms')} ms; slower "
          f"than it at {slower}), "
          f"plain {forward['plain_ms']:.1f} ms, torch._int_mm "
          f"{forward['library_ms']} ms, bound {forward['bound_ms']:.4f} ms; "
          f"the weights' packs (once a weight) {forward['pack_ms']:.4f} ms; "
          f"the int8 MLP forward's 3 calls: kernel {main['ms']:.4f} ms "
          f"(the mma.sync kernel: {total(mlp_rows, 'mma_sync_ms')} ms; on "
          f"inference-mode weights, packed every call: "
          f"{main['inference_weight_ms']:.4f} ms), "
          f"bound {main['bound_ms']:.5f}; {secs:.1f} s gpu={gpu}",
          flush=True)
    torch.cuda.empty_cache()
    return {"rows": rows, "mlp_rows": mlp_rows, "forward": forward,
            "main": main, "max_abs_err": max(r["max_abs_err"]
                                             for r in rows + mlp_rows),
            "seconds": secs}


def _onnx_serve(dev, gpu, variables, images) -> dict:
    """Phase 26 (c): ResNet-50 v1 exported with ``export_onnx`` from the
    seeded weights at batch 32, served by ``Predictor.from_onnx`` on the
    card (bucket 32; requests of 1, 32 and 130 rows) against the native
    port ``Predictor`` on the same weights (its BN on ``bn_act``)."""
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch import onnx as tonnx
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.predictor import Predictor
    t0 = time.perf_counter()
    blob = tonnx.export_onnx(models.create(QUANT_MODEL, device="cpu"),
                             images[:ONNX_BUCKET], variables=variables)
    export_s = time.perf_counter() - t0
    m = tonnx.parse_model(blob)
    ops = sorted({nd["op_type"] for nd in m["nodes"]})
    print(f"onnx (c) export {QUANT_MODEL} batch {ONNX_BUCKET}: {len(blob)} "
          f"bytes "
          f"in {export_s:.1f} s, {len(m['nodes'])} nodes, "
          f"{len(m['initializers'])} initializers, ops {ops}, input "
          f"{m['inputs'][0][1]}", flush=True)
    onnx_pred = Predictor.from_onnx(blob, batch_buckets=[ONNX_BUCKET],
                                    device=dev)
    model = load_jax_variables(models.create(QUANT_MODEL, device=dev),
                               variables)
    native = Predictor.from_fn(lambda mm, _s, x: mm(x), model,
                               batch_buckets=[ONNX_BUCKET], device=dev)
    for p in (onnx_pred, native):
        p.warmup(images.shape[1:])
    torch.cuda.synchronize()
    worst = 0.0
    for n in ONNX_REQUESTS:
        reset_counts()
        got = onnx_pred.predict(images[:n])
        onnx_counts = read_counts()
        want = native.predict(images[:n])
        if got.shape != (n, 1000) or not np.isfinite(got).all():
            raise AssertionError(f"phase 26 (c): request of {n} gave "
                                 f"{got.shape}")
        err = float(np.abs(got - want).max())
        rel = err / float(np.abs(want).max())
        worst = max(worst, rel)
        print(f"onnx (c) request rows={n}: max_abs_err={err:.3e} "
              f"({rel:.3e} of the largest logit, tol {TOL_ONNX}) kernel "
              f"launches on the ONNX path {onnx_counts}", flush=True)
        if not rel <= TOL_ONNX:
            raise AssertionError(f"phase 26 (c): ONNX logits {rel:.3e} of "
                                 f"the largest from the native Predictor")
    reset_counts()
    native.predict(images[:ONNX_BUCKET])
    native_bn = read_counts()["bn_act"]
    times = {"onnx": [], "native": []}
    batch = images[:ONNX_BUCKET]
    for name in ("onnx", "native", "native", "onnx") * ONNX_REPS:
        pred = onnx_pred if name == "onnx" else native
        t = time.perf_counter()
        pred.predict(batch)
        times[name].append((time.perf_counter() - t) * 1e3)
    ms = {k: float(np.median(v)) for k, v in times.items()}
    secs = time.perf_counter() - t0
    print(f"onnx (c) bucket {ONNX_BUCKET} f32: from_onnx ms_per_request="
          f"{ms['onnx']:.3f} img_per_s={ONNX_BUCKET / ms['onnx'] * 1e3:.1f}; "
          f"native Predictor ms_per_request={ms['native']:.3f} img_per_s="
          f"{ONNX_BUCKET / ms['native'] * 1e3:.1f} ({native_bn} bn_act a "
          f"request); worst {worst:.3e} of the largest logit; {secs:.1f} s "
          f"gpu={gpu}", flush=True)
    del onnx_pred, native, model
    torch.cuda.empty_cache()
    return {"bytes": len(blob), "export_s": export_s,
            "nodes": len(m["nodes"]), "initializers": len(m["initializers"]),
            "ms": ms, "max_rel_err": worst, "native_bn_act": native_bn,
            "seconds": secs}


def quant_onnx_phase(gpu, dev, variables, images) -> dict:
    """Phase 26: (b) the quantize example on the card (the kernel's main
    path), (a) the int8 kernel at ResNet-50 v1's shapes and the example's,
    (c) ONNX export and serving at full width.  Each part's time."""
    t0 = time.perf_counter()
    mlp = _quant_mlp(dev, gpu)
    kernel = _quant_kernel(dev, gpu, variables, images, mlp)
    served = _onnx_serve(dev, gpu, variables, images)
    secs = time.perf_counter() - t0
    print(f"quant/onnx phase: (b) {mlp['seconds']:.1f} s, (a) "
          f"{kernel['seconds']:.1f} s, (c) {served['seconds']:.1f} s, total "
          f"{secs:.1f} s gpu={gpu}", flush=True)
    return {"mlp": mlp, "kernel": kernel, "onnx": served, "seconds": secs}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "dt_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no dt_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))  # the elastic job's helpers
    from dt_tpu_torch import models
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.ops import _build

    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {json.dumps(built)} total_s={time.perf_counter() - t0:.2f}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: off (cudnn and matmul) for every phase", flush=True)
    dev = torch.device("cuda")

    # --- kernels --------------------------------------------------------
    model = models.create("resnet50", device=dev)
    variables = seeded_variables(model, seed=0)
    load_jax_variables(model, variables)
    x32 = torch.zeros(32, 224, 224, 3, device=dev).permute(0, 3, 1, 2)
    shapes = bn_shapes(model, x32)
    # the elastic phase's three workers train at a per-worker batch of 21
    shapes21 = bn_shapes(model, torch.zeros(21, 224, 224, 3, device=dev)
                         .permute(0, 3, 1, 2))
    if sum(shapes.values()) != BN_PER_FORWARD or \
            sum(shapes21.values()) != BN_PER_FORWARD:
        raise AssertionError(f"{sum(shapes.values())}, "
                             f"{sum(shapes21.values())} BatchNorms in one "
                             f"forward, expected {BN_PER_FORWARD}")
    # the policy phase's other per-worker batches (22, 25, 26 and 13),
    # held against the plain versions, not timed
    from torch_elastic_job import policy_drill_log
    from dt_tpu_torch.policy import PolicyEngine, rescale
    _, drill = policy_drill_log(PolicyEngine(
        threshold_ms=POLICY_THRESHOLD_MS, evict_after=POLICY_EVICT_AFTER),
        rescale)
    held = [key for b in sorted({b for m in drill for b in m.values()}
                                - {BATCH, 21})
            for key in bn_shapes(model, torch.zeros(b, 224, 224, 3,
                                                    device=dev)
                                 .permute(0, 3, 1, 2))]
    summary = kernel_phase(shapes, dev, also=list(shapes21), held=held)
    print(f"phase kernels done at {time.perf_counter() - t0:.1f} s",
          flush=True)

    # --- training kernels -----------------------------------------------
    n_params = sum(p.numel() for p in model.parameters())
    del model, x32
    train_kernels = bn_train_phase(shapes, dev, also=list(shapes21),
                                   held=held)
    codec = codec_phase(n_params, dev)
    print(f"phase training kernels done at {time.perf_counter() - t0:.1f} s",
          flush=True)

    # --- serve ----------------------------------------------------------
    rng = np.random.RandomState(1)
    images = rng.uniform(-1, 1, (max(REQUESTS), 224, 224, 3)) \
        .astype(np.float32)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        launches, chunks, logits = serve("resnet50", dtype, variables, dev,
                                         images, gpu)
        print(f"serve {dtype} launches={launches} chunk_forwards={chunks} "
              f"expected={BN_PER_FORWARD * chunks}", flush=True)
        if launches != BN_PER_FORWARD * chunks:
            raise AssertionError(f"{dtype}: {launches} kernel launches for "
                                 f"{chunks} chunk forwards")
        results[dtype] = (launches, logits)

    cpu = load_jax_variables(models.create("resnet50", device="cpu"),
                             variables)
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(images[:4]).permute(0, 3, 1, 2)).numpy()
    f32 = results[torch.float32][1]
    err = float(np.abs(f32 - ref).max())
    print(f"check f32 card vs cpu: max_abs_err={err:.3e} "
          f"max_abs_logit={np.abs(ref).max():.3f} tol={TOL_F32}", flush=True)
    np.testing.assert_allclose(f32, ref, rtol=TOL_F32, atol=TOL_F32)
    bf16 = results[torch.bfloat16][1]
    tol = TOL_BF16 * float(np.abs(f32).max())
    err = float(np.abs(bf16 - f32).max())
    top = np.sort(f32, axis=1)
    margin = top[:, -1] - top[:, -2]
    clear = margin > 2 * tol
    agree = bf16.argmax(1) == f32.argmax(1)
    print(f"check bf16 vs f32: max_abs_err={err:.3e} tol={tol:.3e} "
          f"top1_agree={agree.tolist()} margin_over_2tol={clear.tolist()}",
          flush=True)
    if err > tol or not agree[clear].all():
        raise AssertionError("bf16 logits disagree with f32")
    print(f"phase serve done at {time.perf_counter() - t0:.1f} s", flush=True)

    # --- train ----------------------------------------------------------
    trained = train_phase(variables, dev, gpu)
    step_card_vs_cpu(variables, dev)
    print(f"phase train done at {time.perf_counter() - t0:.1f} s", flush=True)

    # --- Module.fit -----------------------------------------------------
    fitted = fit_phase(dev, gpu, trained["bf16"])
    fit_cmp = fit_card_vs_cpu()
    print(f"phase fit done at {time.perf_counter() - t0:.1f} s", flush=True)

    # --- the elastic host-sync job --------------------------------------
    torch.cuda.empty_cache()  # the workers are other processes on the card
    elastic = elastic_phase(gpu)
    print(f"phase elastic done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    sharded = sharded_phase(gpu, elastic)
    print(f"phase sharded done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    async_run = async_phase(gpu)
    print(f"phase async done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    failover = failover_phase(gpu, elastic)
    print(f"phase failover done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    outage = outage_phase(gpu)
    print(f"phase outage done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    sparse_phase(gpu)
    print(f"phase sparse done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    elastic_small_jobs(gpu)
    print(f"phase elastic small jobs done at "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    policy = policy_phase(gpu)
    print(f"phase policy done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    obs = obs_phase(gpu, elastic)
    print(f"phase obs done at {time.perf_counter() - t0:.1f} s", flush=True)
    gateway = gateway_phase(gpu)
    print(f"phase gateway done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()  # the mesh's ranks are processes on the card
    mesh = mesh_phase(gpu, variables)
    print(f"phase mesh done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    parallel = parallel_phase(gpu, dev, variables)
    print(f"phase parallel done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    optim_run = optim_phase(gpu, dev, variables)
    print(f"phase optim done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    data_run = data_phase(gpu, dev, fitted)
    print(f"phase data done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    zoo = zoo_phase(gpu, dev)
    print(f"phase zoo done at {time.perf_counter() - t0:.1f} s", flush=True)
    detection = detection_phase(gpu, dev)
    print(f"phase detection done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    quant = quant_onnx_phase(gpu, dev, variables, images)
    print(f"phase quantization and onnx done at "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # --- LM kernels -----------------------------------------------------
    flash = flash_phase(dev)
    lstm = lstm_phase(dev)
    layer = lstm_layer_phase(dev)
    layer_bf16 = lstm_layer_bf16_phase(dev)
    layer_bwd = lstm_layer_bwd_phase(dev)
    print(f"phase LM kernels done at {time.perf_counter() - t0:.1f} s",
          flush=True)

    # --- LM training ----------------------------------------------------
    lm_trained = lm_train_phase(dev, gpu)
    lstm_trained = lstm_train_phase(dev, gpu)
    lm_steps = lm_steps_card_vs_cpu()
    lstm_bf16 = lstm_bf16_forward(dev)
    lstm_wide = lstm_wide_forward(dev)
    print(f"phase LM train done at {time.perf_counter() - t0:.1f} s",
          flush=True)

    kernels = []
    fit_counts = fitted["launches"]
    for dtype, tot in summary.items():
        kernels.append({
            "name": f"fused_bn_inference[{str(dtype).split('.')[-1]}]",
            "route": "cuda",
            "source": "dt_tpu_torch/csrc/bn_act.cu",
            "replaces": "dt_tpu/ops/pallas/kernels.py:43",
            "launches": results[dtype][0],
            "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "bytes",
            "library_ms": tot["library_ms"]})
        if dtype == torch.float32:  # phase 26 (c): the native Predictor
            kernels[-1]["onnx_native_launches_a_request"] = \
                quant["onnx"]["native_bn_act"]
        if dtype == torch.bfloat16:  # fit's eval forwards (bn_act alone)
            kernels[-1]["fit_launches"] = (fit_counts["bn_act"]
                                           - fit_counts["bn_stats"])
            # the elastic job's scores (every live worker, every epoch)
            kernels[-1]["elastic_launches"] = \
                elastic["launches"]["score_bn_act"]
            kernels[-1]["async_launches"] = \
                async_run["launches"]["score_bn_act"]
            kernels[-1]["sharded_launches"] = \
                sharded["launches"]["score_bn_act"]
            kernels[-1]["ha_launches"] = \
                failover["launches"]["score_bn_act"]
            # the resumed job scores nothing: pass 2 alone past pass 1
            kernels[-1]["resume_launches"] = (outage["launches"]["bn_act"]
                                              - outage["launches"]["bn_stats"])
            kernels[-1]["policy_launches"] = \
                policy["launches"]["score_bn_act"]
            kernels[-1]["obs_launches"] = \
                obs["armed"]["launches"]["score_bn_act"]
            # phase 19: every bucket forward behind the two gateways
            kernels[-1]["gateway_launches"] = gateway["launches"]
            # phase 20: every rank's score over the mesh
            kernels[-1]["mesh_launches"] = mesh["launches"]["score_bn_act"]
            # phase 21: pass 2 alone past pass 1 (no eval forward there)
            kernels[-1]["parallel_launches"] = (
                parallel["launches"]["bn_act"]
                - parallel["launches"]["bn_stats"])
            # phase 22: (a)'s fit has no eval forward either
            kernels[-1]["optim_launches"] = (
                optim_run["launches"]["bn_act"]
                - optim_run["launches"]["bn_stats"])
        # phase 23: (a) bf16, (b) f32; the fits score nothing
        part = data_run["rec" if dtype == torch.bfloat16 else "sd"]
        kernels[-1]["data_launches"] = (part["counts"]["bn_act"]
                                        - part["counts"]["bn_stats"])
        if dtype == torch.bfloat16:  # phase 24 (c): every model's requests
            kernels[-1]["zoo_launches"] = {
                name: r["serve_counts"]["bn_act"]
                for name, r in zoo["runs"].items()}
        # phase 25 (c): each detector's eval forward (+ SSD's requests)
        dname = str(dtype).split(".")[-1]
        kernels[-1]["detection_launches"] = {
            name: sum(c["bn_act"] for part, c in per[dname].items()
                      if part in ("detect", "serve"))
            for name, per in detection["launches"].items()}
    train_launches = {
        torch.float32: trained["f32"]["launches"]["bn_stats"],
        torch.bfloat16: trained["bf16"]["launches"]["bn_stats"]
        + trained["bf16_2bit"]["launches"]["bn_stats"]}
    for dtype, tot in train_kernels.items():
        # one fused_bn_train call = pass 1 (bn_train.cu) + pass 2
        # (bn_act.cu); times, bound and plain are the two passes' sums
        name = str(dtype).split(".")[-1]
        kernels.append({
            "name": f"fused_bn_train[{name}]",
            "route": "cuda",
            "source": "dt_tpu_torch/csrc/bn_train.cu",
            "replaces": "dt_tpu/ops/pallas/kernels.py:101",
            "launches": train_launches[dtype],
            "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "bytes",
            "library_ms": tot["library_ms"],
            "redesigned_in": 4, "pass1_ms": tot["pass1_ms"],
            "pass1_bound_ms": tot["pass1_bound_ms"],
            "pass1_kernels_a_call": tot["kernels_a_call"],
            # the mesh's pass 1 (dt_bn_sums of the same source), held and
            # timed at the same shapes, summed over one forward's calls
            "bn_sums": {"ms": tot["sums_ms"],
                        "plain_ms": tot["sums_plain_ms"],
                        "bound_ms": tot["sums_bound_ms"],
                        "bound_by": "bytes",
                        "max_abs_err": tot["sums_max_abs_err"],
                        "library_ms": None,
                        "kernels_a_call": tot["sums_kernels_a_call"]}})
        if dtype == torch.bfloat16:  # every BN of every fit step
            kernels[-1]["fit_launches"] = fit_counts["bn_stats"]
            kernels[-1]["elastic_launches"] = \
                elastic["launches"]["bn_stats"]
            kernels[-1]["async_launches"] = async_run["launches"]["bn_stats"]
            kernels[-1]["sharded_launches"] = sharded["launches"]["bn_stats"]
            kernels[-1]["ha_launches"] = failover["launches"]["bn_stats"]
            kernels[-1]["resume_launches"] = outage["launches"]["bn_stats"]
            kernels[-1]["policy_launches"] = policy["launches"]["bn_stats"]
            kernels[-1]["obs_launches"] = obs["armed"]["launches"]["bn_stats"]
            # phase 20: pass 1 is bn_sums on the mesh, never bn_stats
            kernels[-1]["mesh_launches"] = {
                k: mesh["launches"][k] for k in ("bn_sums", "bn_stats",
                                                 "bn_act")}
            # phase 21 (c): ResNet-50 without and with remat (the
            # recompute launches pass 1 and pass 2 again)
            kernels[-1]["parallel_launches"] = \
                parallel["launches"]["bn_stats"]
            # phase 22 (a): the multi-precision fit
            kernels[-1]["optim_launches"] = optim_run["launches"]["bn_stats"]
            # phase 23 (a): the .rec-fed fit
            kernels[-1]["data_launches"] = \
                data_run["rec"]["counts"]["bn_stats"]
            # phase 24 (b): every model's fit, pass 1 + pass 2
            kernels[-1]["zoo_launches"] = {
                name: {k: r["fit_counts"][k] for k in ("bn_stats", "bn_act")}
                for name, r in zoo["runs"].items()}
        # phase 25 (b): each detector's training (+ SSD's .rec steps in
        # bf16), pass 1 and pass 2
        dname = str(dtype).split(".")[-1]
        kernels[-1]["detection_launches"] = {
            name: {k: sum(c[k] for part, c in per[dname].items()
                          if part in ("train", "rec"))
                   for k in ("bn_stats", "bn_act")}
            for name, per in detection["launches"].items()}
        if dtype != torch.bfloat16:  # phase 22 (d): the f32 ZeRO-1 ranks'
            kernels[-1]["optim_launches"] = {
                k: sum(c[k] for per in optim_run["zero"]["launches"].values()
                       for c in per) for k in ("bn_sums", "bn_stats",
                                               "bn_act")}
            # phase 23 (b): the stochastic-depth resnet20 fit
            kernels[-1]["data_launches"] = \
                data_run["sd"]["counts"]["bn_stats"]
    sums = train_kernels[torch.bfloat16]
    kernels.append({  # the mesh's pass 1 (phase 20), its own entry point
        "name": "fused_bn_train.bn_sums[bfloat16]", "route": "cuda",
        "source": "dt_tpu_torch/csrc/bn_train.cu",
        "replaces": "dt_tpu/ops/pallas/kernels.py:101",
        "launches": mesh["launches"]["bn_sums"],
        "max_abs_err": sums["sums_max_abs_err"], "ms": sums["sums_ms"],
        "plain_ms": sums["sums_plain_ms"], "bound_ms": sums["sums_bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "path": "mesh (phase 20)",
        "kernels_a_call": sums["sums_kernels_a_call"]})
    for name, line in (("quantize_2bit", 233), ("dequantize_2bit", 284)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dt_tpu_torch/csrc/quant2.cu",
            "replaces": f"dt_tpu/ops/pallas/kernels.py:{line}",
            "launches": trained["bf16_2bit"]["launches"][name],
            "max_abs_err": codec[name]["max_abs_err"],
            "ms": codec[name]["ms"], "plain_ms": codec[name]["plain_ms"],
            "bound_ms": codec[name]["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "elastic_launches": elastic["launches"][name],
            "sharded_launches": sharded["launches"][name],
            "async_launches": async_run["launches"][name],
            "ha_launches": failover["launches"][name],
            "resume_launches": outage["launches"][name]})
        if name == "quantize_2bit":  # the scheduler decodes in numpy
            kernels[-1]["policy_launches"] = policy["launches"][name]
            kernels[-1]["obs_launches"] = obs["armed"]["launches"][name]
    fb = flash["lm", "bfloat16"]
    kernels.append({
        "name": "flash_attention[bfloat16]", "route": "cuda",
        "source": "dt_tpu_torch/csrc/flash_attn.cu",
        "replaces": "dt_tpu/ops/pallas/attention.py:40",
        "launches": lm_trained["launches"]["flash_attention"],
        "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
        "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
        "bound_by": "operations", "library_ms": fb["library_ms"],
        "redesigned_in": 4, "path": "lm_train bf16",
        "more": {c: r for (c, n), r in flash.items()
                 if n == "bfloat16" and c != "lm"}})
    ff = flash["lm", "float32"]
    kernels.append({
        "name": "flash_attention[float32]", "route": "cuda",
        "source": "dt_tpu_torch/csrc/flash_attn.cu",
        "replaces": "dt_tpu/ops/pallas/attention.py:40",
        "launches": lm_steps["transformer_lm"]["flash_attention"],
        "max_abs_err": ff["max_abs_err"], "ms": ff["ms"],
        "plain_ms": ff["plain_ms"], "bound_ms": ff["bound_ms"],
        "bound_by": "operations", "library_ms": ff["library_ms"],
        "bound_3xtf32_ms": ff["bound_3xtf32_ms"], "redesigned_in": 5,
        "path": "lm step f32 transformer_lm",
        "more": {c: r for (c, n), r in flash.items()
                 if n == "float32" and c != "lm"}})
    for k in kernels[-2:]:  # both dtypes share one counter
        k["ha_launches"] = failover["launches"]["flash_attention"]
        k["resume_launches"] = outage["launches"]["flash_attention"]
        # phase 21: the MoE LM's fit (b) and the LM without and with
        # remat (c)
        k["parallel_launches"] = parallel["launches"]["flash_attention"]
        # phase 22: the LM under adam (b) and the checkpoint's steps (e)
        k["optim_launches"] = optim_run["launches"]["flash_attention"]
    lp = lstm[200]
    kernels.append({
        "name": "lstm_pointwise", "route": "cuda",
        "source": "dt_tpu_torch/csrc/lstm_point.cu",
        "replaces": "dt_tpu/ops/pallas/kernels.py:319",
        # a bf16 layer runs the layer kernels: the pointwise kernel runs
        # where a layer is too wide for them
        "launches": lstm_wide["launches"]["lstm_pointwise"],
        "max_abs_err": lp["max_abs_err"], "ms": lp["ms"],
        "plain_ms": lp["plain_ms"], "bound_ms": lp["bound_ms"],
        "bound_by": "bytes", "library_ms": lp["library_ms"],
        "path": "lstm_wide f32 (B 1, H 6656)",
        "lstm_forward_bf16_launches": lstm_bf16["launches"][
            "lstm_pointwise"],
        "main_path_launches": lstm_trained["launches"]["lstm_pointwise"],
        "shape": [PTB_BATCH, 200], "h650": lstm[650],
        "ha_launches": failover["launches"]["lstm_pointwise"],
        "resume_launches": outage["launches"]["lstm_pointwise"],
        # phase 23 (c): the bf16 bidirectional_lstm's forward + backward
        "data_launches": {
            "bilstm_bf16": data_run["bilstm"]["bfloat16"]["counts"][
                "lstm_pointwise"]}})
    ll = layer[200]
    kernels.append({
        "name": "lstm_layer", "route": "cuda",
        "source": "dt_tpu_torch/csrc/lstm_layer.cu",
        "replaces": "dt_tpu/ops/pallas/kernels.py:319",
        "launches": lstm_trained["launches"]["lstm_layer"],
        "max_abs_err": ll["max_abs_err"], "ms": ll["ms"],
        "plain_ms": ll["plain_ms"], "bound_ms": ll["bound_ms"],
        "bound_by": "operations", "library_ms": ll["library_ms"],
        "redesigned_in": 5, "path": "lstm_train f32",
        "layer_ms": ll["layer_ms"], "per_step_ms": ll["per_step_ms"],
        "serial_floor_ms": ll["serial_floor_ms"],
        "shape": ll["shape"], "h650": layer[650],
        "ha_launches": failover["launches"]["lstm_layer"],
        "resume_launches": outage["launches"]["lstm_layer"],
        # phase 23 (c): the f32 bidirectional_lstm and the NER model's steps
        "data_launches": {
            "bilstm_f32": data_run["bilstm"]["float32"]["counts"][
                "lstm_layer"],
            "ner": data_run["ner"]["counts"]["lstm_layer"]}})
    la = layer_bf16[200]
    kernels.append({  # kernel A: the bf16 layer window (tensor cores)
        "name": "lstm_layer[bfloat16]", "route": "cuda",
        "source": "dt_tpu_torch/csrc/lstm_layer.cu",
        "replaces": "dt_tpu/ops/pallas/kernels.py:319",
        "launches": lstm_bf16["launches"]["lstm_layer"],
        "max_abs_err": la["max_abs_err"], "max_rel_err": la["max_rel_err"],
        "ms": la["ms"], "plain_ms": la["plain_ms"],
        "bound_ms": la["bound_ms"], "bound_by": la["bound_by"],
        "library_ms": la["library_ms"], "redesigned_in": 20,
        "path": "lstm_forward bf16", "layer_ms": la["layer_ms"],
        "per_step_ms": la["per_step_ms"], "shape": la["shape"],
        "h650": layer_bf16[650],
        # phase 23 (c): the bf16 bidirectional_lstm's forward
        "data_launches": {
            "bilstm_bf16": data_run["bilstm"]["bfloat16"]["counts"][
                "lstm_layer"]}})
    for name in ("float32", "bfloat16"):  # kernel B: the BPTT window
        lb = layer_bwd[name, 200]
        kernels.append({
            "name": f"lstm_layer_bwd[{name}]", "route": "cuda",
            "source": "dt_tpu_torch/csrc/lstm_layer_bwd.cu",
            # the custom VJP of the pointwise kernel, chained by the scan
            "replaces": "dt_tpu/ops/pallas/kernels.py:381",
            "launches": (lstm_trained["launches"]["lstm_layer_bwd"]
                         if name == "float32" else
                         data_run["bilstm"]["bfloat16"]["counts"][
                             "lstm_layer_bwd"]),
            "max_abs_err": lb["max_abs_err"],
            "max_rel_err": lb["max_rel_err"], "ms": lb["ms"],
            "plain_ms": lb["plain_ms"], "bound_ms": lb["bound_ms"],
            "bound_by": lb["bound_by"], "library_ms": lb["library_ms"],
            "redesigned_in": 20,
            "path": ("lstm_train f32" if name == "float32" else
                     "data (c) bidirectional_lstm bf16 forward+backward"),
            "stepped_backward_ms": lb["stepped_backward_ms"],
            "shape": lb["shape"], "h650": layer_bwd[name, 650],
            "ha_launches": failover["launches"]["lstm_layer_bwd"],
            "resume_launches": outage["launches"]["lstm_layer_bwd"],
            "data_launches": {
                "bilstm": data_run["bilstm"][name]["counts"][
                    "lstm_layer_bwd"],
                "ner": (data_run["ner"]["counts"]["lstm_layer_bwd"]
                        if name == "float32" else 0)},
            "lm_step_launches": (lm_steps["lstm_lm"]["lstm_layer_bwd"]
                                 if name == "float32" else 0)})
    nk = detection["detect"]["ssd", torch.bfloat16]["nms"]
    kernels.append({  # phase 25: the detection stage's scan
        "name": "nms_keep", "route": "cuda",
        "source": "dt_tpu_torch/csrc/nms.cu",
        # the greedy scan of nms, a lax.fori_loop (no Pallas kernel)
        "replaces": "dt_tpu/ops/detection.py:141",
        "launches": sum(c.get("nms_keep", 0)
                        for per in detection["launches"].values()
                        for parts in per.values() for c in parts.values()),
        # unequal keep elements over every held call of phase 25
        "max_abs_err": max(r["nms_held"]["mismatches"]
                           for part in ("runs", "detect")
                           for r in detection[part].values()),
        "ms": nk["ms"],
        "plain_ms": nk["plain_ms"], "bound_ms": nk["bound_ms"],
        "bound_by": nk["bound_by"], "library_ms": nk["library_ms"],
        "path": "ssd_detect bf16 (phase 25 (c))", "shape": nk["shape"],
        "scanned": sum(nk["counts"]), "pairs": nk["pairs"],
        "kept": nk["kept"], "redesigned_in": 19,
        # the device kernels one call launches: the label reorder's
        # PyTorch ops, then csrc/nms.cu's mask and scan kernels
        "kernels_a_call": nk["kernels_a_call"],
        "device_kernels": nk["device_kernels"],
        "runs_an_image": [min(nk["runs_an_image"]),
                          max(nk["runs_an_image"])],
        "longest_run": nk["longest_run"],
        "longest_run_kept": nk["longest_run_kept"],
        # measured: the allocator's peak over one call, keep included
        "peak_bytes_a_call": nk["peak_bytes_a_call"],
        "detection_launches": {
            name: {dt: {part: c.get("nms_keep", 0)
                        for part, c in parts.items()}
                   for dt, parts in per.items()}
            for name, per in detection["launches"].items()}})
    qk = quant["kernel"]
    kernels.append({  # phase 26: the int8 implicit GEMM
        "name": "quantized_conv2d", "route": "cuda",
        "source": "dt_tpu_torch/csrc/qconv.cu",
        # XLA int8 convolution and product with an int32 accumulator (no
        # Pallas kernel): quantized_conv2d, and quantized_dense at :52
        "replaces": "dt_tpu/ops/quantization.py:65",
        "launches": quant["mlp"]["launches"],
        "redesigned_in": 22,
        "design": "wgmma m64nBNk32 s32.s8.s8 from a 3-4 stage shared-memory "
                  "ring (mbarriers full/empty, 2-4 producer warps): B packed "
                  "K-major once (qconv_pack, cached) by TMA, A by TMA (tma "
                  "route), 16-byte cp.async gather (gather route) or 4-byte "
                  "cp.async of Cp 4 pixels (narrow route, the stem); "
                  "epilogue staged in shared memory, 16-byte row stores",
        # the main path's launches by how A was loaded
        "route_launches": quant["mlp"]["routes"],
        "max_abs_err": qk["max_abs_err"],
        "ms": qk["main"]["ms"], "plain_ms": qk["main"]["plain_ms"],
        "bound_ms": qk["main"]["bound_ms"],
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in qk["mlp_rows"])
                     else "operations"),
        "library_ms": qk["main"]["library_ms"],
        "library": "torch._int_mm over the same GEMM (im2col not timed)",
        "path": "examples/quantize_model.py int8 forward (phase 26 (b)): "
                "3 quantized_dense calls, naive and entropy",
        "shapes": [[r["m"], r["k"], r["n"]] for r in qk["mlp_rows"]],
        "resnet50_int8_forward": qk["forward"],
        "resnet50_shapes": [{k: r[k] for k in (
            "tag", "calls", "x", "n", "k", "stride", "route", "bn", "ms",
            "library_ms", "bound_ms")} for r in qk["rows"]],
        # the main path's 3 calls on weights quantized under inference
        # mode (no version counter, so each call packs its weight anew)
        "inference_weight_ms": qk["main"]["inference_weight_ms"],
        "int8_top1": {k: v["top1"] for k, v in quant["mlp"]["int8"].items()},
        "fp32_top1": quant["mlp"]["fp32"],
        "onnx_resnet50": {k: quant["onnx"][k] for k in (
            "bytes", "export_s", "nodes", "initializers", "ms",
            "max_rel_err")}})
    kernels.append({  # phase 26: the int8 kernel's weight pack
        "name": "qconv_pack", "route": "cuda",
        "source": "dt_tpu_torch/csrc/qconv.cu",
        # no TPU kernel: HWIO -> K-major rows for the 8-bit wgmma's B
        # operand, once a weight; beside the kernel it feeds
        "replaces": "dt_tpu/ops/quantization.py:65",
        "launches": quant["mlp"]["pack_launches"],
        # the packed weights against qconv_pack_plain, every shape of (a)
        "max_abs_err": max(r["pack_err"] for r in qk["rows"]
                           + qk["mlp_rows"]),
        "ms": qk["main"]["pack_ms"],
        "plain_ms": qk["main"]["pack_plain_ms"],
        "bound_ms": qk["main"]["pack_bound_ms"], "bound_by": "bytes",
        "library_ms": qk["main"]["pack_library_ms"],
        "library": "wq.reshape(K, N).t().contiguous() (the same bytes where "
                   "the pack pads nothing, as for these 3 weights)",
        "path": "examples/quantize_model.py int8 forward (phase 26 (b)): "
                "one pack a weight, the 3 dense weights",
        "resnet50_packs_ms": qk["forward"]["pack_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"gpu: {gpu_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
