"""Smoke run of the PyTorch port on one NVIDIA H100.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printed as a JSON line; any failure raises and exits non-zero
before the result line:

1. device: the card's ``nvidia-smi`` name and power limit, torch and CUDA,
   and whether a ten-line C file that includes ``jpeglib.h`` compiles and
   links with ``-ljpeg`` (reported; it fails nothing); the host's cores
   and ``/dev/shm``'s free bytes;
2. build: ``nvcc`` compiles every kernel source of the port (the three
   depthwise and the three flash-attention kernels), one process per
   source, all started together (timed, with ptxas' register report); for
   every instantiation of the depthwise forward and dx kernels, ptxas'
   registers and spills, and the card's registers, local bytes, largest
   dynamic shared memory and resident blocks per SM;
2a. JPEG decode (``jpeg``): the port's own decoder
   (``native/jpeg_decode.cc``, one library with the image ops of 2b)
   built by the host C++ compiler (timed);
   every fixture of ``tests/data/jpeg`` decoded to its committed
   libjpeg-turbo digest (the CMYK one declined), the committed truncation
   and bit-flip sweeps over one baseline and one progressive fixture each
   equal to the CPU's digest or None as committed; ms a frame on one
   thread (640² and 640×480, 4:2:0) and the pool's frames/s at 1, 4 and 8
   threads;
2b. the host augment chain (``host_augment``): the port's image ops
   (``native/imaging.cc``, in the library phase 2 built) and its
   train chain on the card's host, which has no Pillow: every case of
   ``tests/data/host_augment/digests.json`` (Pillow 12's convert, enhance,
   hue, blur, rotate, flip and resize, the JAX native warp, the JAX
   ``transforms_deepfake_train_v3``) and the first host batches of the
   train loader under ``scripts/train.sh``'s flags, with and without
   ``--host-geom``, equal to their committed digests; the host ms a 640²
   clip by stage (warp to 600², blur, jitter, flicker, and the collate and
   mixup blend of a batch of 3);
2c. AugMix's ops and policies (``augmix``) on the card's host, no Pillow:
   every case of ``tests/data/augmix/digests.json`` (Pillow 12's tables
   over all 2²⁴ colours and every argument, histograms, Sharpness, blend,
   the BILINEAR/BICUBIC affine and rotate sweeps, the JAX AugMix,
   RandAugment and AutoAugment on seeded frames and generators) and the
   first host batches of the ``--aug-splits 3 --resplit`` loader equal to
   their committed digests; the host ms a 600² frame of each op and of
   one ``AugMixAugment`` call, and of the AugMix stage of a 4-frame clip
   (two views);
3. forward kernel vs plain: the depthwise kernel at every depthwise shape
   of the flagship ``efficientnet_deepfake_v4`` at a 600² input (batch 1,
   the inference path's, and batch 2; f32, TF32 off), bf16 on a few of them,
   and edge cases (C = 13, odd H/W, ``'same'`` and int padding, act
   none/relu, identity affine, an unaligned base pointer), each against its
   plain PyTorch version on the same inputs, two calls bitwise equal; the
   device time of the kernel,
   the plain version and the library call (a CUDA graph of 20 calls
   replayed between CUDA events), beside the bound (bytes over the memory
   rate or operations over the f32 rate);
4. dw-gradient kernel vs plain: the same shapes at the training batch (3),
   f32, bf16 x on a few, and edge cases; two calls must give bitwise-equal
   dw; kernel, plain, library (cuDNN's weight gradient) and bound times,
   and each stage's workspace bytes and the kernels one call launches
   (counted by torch.profiler);
5. dx kernel and backward vs plain: the dx kernel (``depthwise_dx``, a
   direct transposed kernel, no dilated copy) against
   ``depthwise_dx_reference`` at every flagship shape at batch 3 and at
   edge cases (padding k and k+1 a side, C = 13 with odd H/W at k5 s2, bf16
   dx, an unaligned base), two calls bitwise equal, with its device time
   beside the plain version's, cuDNN's input gradient and the bound; then,
   for the identity epilogue (the training call) and for affine + SiLU (the
   path that saves z), the forward the training path launches (y against
   the plain version, elementwise) and the full ``fused_depthwise`` backward
   on the card (dx and dw through their kernels) against
   ``torch.autograd`` through the plain version, also at a padding of k and
   k+1 a side;
6. flash kernels vs plain: forward, dQ and dK/dV at the TimeSformer's
   spatial attention (B·H 384 for a train step at batch 8, 768 for an eval
   forward at batch 16; L 576, D 64, f32) and at edge cases (L 197 and 200,
   D 32, 48 and 128 (at L 130 and 576), key padding, causal with offsets,
   rows that see no key, bf16): O, lse and the gradients against the plain
   versions, two forward and two backward calls bitwise equal; device
   times of kernel, plain, SDPA pinned to its memory-efficient backend
   (library; its backward timed alone on the device, as the port's autograd
   backward), and both bounds (f32 SIMT and three TF32 products on the
   tensor cores); the three kernels' registers, spills, shared memory,
   resident blocks per SM and SASS HMMA count (every instantiation must have
   HMMA); ``flash_attention`` forward and backward on the card against
   ``torch.autograd`` through the plain forward;
7. bf16 kernel rows (the ``--amp`` path's instantiations): the three
   depthwise kernels at every flagship shape (the forward at batch 3 and 1,
   dx and dw at batch 3) and the three flash kernels at (384, 576, 64), each
   against its plain version on the same inputs (bf16 outputs within one
   bf16 rounding; dw and the flash gradients at their f32 tolerances, which
   holds only if the f32 operands made inside the flash kernels, q·scale, P
   and dS, are split into TF32 terms), two calls bitwise equal, dw from bf16
   x bitwise the dw from x widened to f32; kernel, plain, library (cuDNN in
   bf16; SDPA in bf16 with its flash and its memory-efficient backends) and
   bound times;
8. inference path: the flagship at full width and depth (12×600², 55
   blocks) with seeded weights and BN calibrated on the card by one
   train-mode pass over the inputs at 600², scoring seeded frames of mixed
   aspect ratios through ``runners.test.test_img`` on the card, single and
   ``--clip``; 55 forward-kernel launches per forward, scores finite, not
   all 0.5, and matching the same weights run on the CPU (plain path); then
   clips/s at batch 1 and 8, and the device time by kernel kind at batch 8
   (torch.profiler);
9. serving path (``serve``): the calibrated checkpoint of phase 8 behind
   ``runners.serve.build_server`` on the card, uint8 and float32 wires,
   buckets 1, 4, 16: programs and captures equal models × buckets ×
   widths (55 depthwise launches captured in each), the peak memory of
   warmup; one bucket-4 replay under torch.profiler names ``dw_fwd_kernel``
   55 times; ``POST /score`` of phase 8's ``.npy`` frames and 4-frame
   multipart clips within 1e-6 of the card CLI's P(fake) on both wires
   (bitwise reported), padded rows bitwise, the graph within the score
   tolerance of an eager forward on the plain depthwise version; batch-1
   wall and device ms, graph replay against the eager forward; clips/s,
   p50 and p99 at 1 and 32 clients posting 4-frame ``.npy`` clips at
   600² for 2 s each (the 8-client level cut for time) (a child interpreter's threads; the batch histogram
   from ``/metrics``); the JPEG row: the four 640² fixtures as a multipart
   clip, its scores bitwise those of the same frames decoded and sent as
   ``.npy``, then 32 clients for 2 s with each body (clips/s, p50/p99,
   ``preprocess`` ms side by side), the host's ms a frame on one idle
   thread of the decode and of the 640² → 600² canvas, and the launches
   of the JPEG requests alone (``serve_jpeg``; the ``.npy`` twins' stay
   with ``serve``); a NaN batch (503, then 200), a hang (the watchdog
   fails it 503, replays every graph, no capture), a perturbed checkpoint
   hot-reloaded (the graph then equal to an eager forward of it), a torn
   one rejected (scores bitwise); a second model added live under load
   (``/readyz`` drops and returns, no request fails) and a cascade run
   whose books balance; then bucket 64 alone, captured and replayed, for
   its peak memory;
10. quantized serving (``quant``): the same checkpoint through
   ``runners.serve.build_engine`` on the uint8 wire, buckets 1, 4, 16, at
   ``--dtype`` f32, bf16 and int8 (weight-only PTQ, the weights realized
   inside each captured graph): captures = buckets × widths with 55
   depthwise launches in each, a profiled bucket-4 replay naming
   ``dw_fwd_kernel`` 55 times (a trace that lost records is taken again,
   up to three, every count reported), P(fake) within 1e-3 of the port's
   CPU run at the same dtype (the first ``QUANT_CPU_FRAMES`` frames: the
   CPU's bf16 and int8 forwards at 600² are the phase's longest part) and
   within 0.02 (bf16) / 0.06 (int8) of the card's f32, batch-1 replay wall and device ms, resident weight bytes (smaller
   than f32's) and the peak memory of warmup, a perturbed checkpoint
   reloaded through the canary (the graph equal to an eager forward of the
   candidate and to the CLI's fresh quantization of the file, within
   1e-6), a checkpoint with NaN in its kernels only rejected (scores
   bitwise); then ``runners.test --dtype int8`` on the card within 1e-6 of
   an int8 engine's float32 wire;
11. corpus backfill (``backfill``): a seeded tree of 192 four-frame clips
   of ``.npy`` frames at 600² (8 of them byte copies of earlier clips)
   packed by ``data/packed.write_pack`` under ``build/chip_smoke/``
   (~0.8 GB), a manifest of 32 clips a shard, and ``runners.backfill``
   with the same checkpoint at ``--batch-size 16 --dedup``: run 1 to the
   end (clips/s, the device's busy share of the scoring window from a
   profiled replay, one capture and none after warmup, 55 depthwise
   launches a replay, books exact with 8 ``skipped_dup``); run 2 stopped
   by ``backfill_kill`` (a real SIGTERM) at the third shard's first batch,
   exit 75 with two shards done, then relaunched to exit 0 with books exact
   and every verdict file bitwise run 1's; four clips against the card
   CLI's ``--clip`` within 1e-6; then the cold start (kernel build,
   model load, captures, seconds to ready per dtype and for the backfill
   pipeline);
11a. the warm start (``warmstart``): three fresh copies of the port's
   package with no ``build/`` start ``runners.serve`` (uint8) as children
   on one ``--warmstart-dir`` store: tree A (buckets 1, 4:
   ``WARM_A_BUCKETS``) every library a miss, six nvcc runs, libraries and
   four capture manifests saved; tree B (bucket 1 alone) six library hits
   and its two capture manifests', no nvcc, every capture's golden canary
   passing bitwise, 55
   depthwise launches captured a graph, ready sooner by at least half of
   A's nvcc seconds; tree C (bucket 1), on a copy of the store in which one
   byte of the stored ``flash_bwd_dq`` library is flipped, started beside
   B: one ``payload-hash`` fallback, nvcc for that source alone, the entry
   rewritten; P(fake) of every frame and clip bitwise the card CLI in all
   three; a one-shard ``runners.backfill`` worker in A (``warmstart_source:
   compile``, beside B and C) and in B (``store``, no nvcc); each tree's
   ready seconds and the nvcc seconds saved;
12. streaming (``stream``): the same checkpoint behind
   ``runners.stream.build_stream_server`` on localhost HTTP (buckets 1, 4,
   16, ``img_num`` 4, tiles of 4 frames, 4 windows in flight a stream, the
   full-frame localizer): captures = buckets × widths of both wires with
   55 depthwise launches in each, the peak memory of warmup; on the float32
   wire one stream of 8 raw 640×480 frames whose two windows are within
   1e-6 of the card CLI's ``--clip`` on the same frames, and a planted
   verdict vector (``0.05*4,0.95*8``, EMA 0.3) that must give exactly
   real→suspect at window 6 and suspect→fake at window 10; on the uint8
   wire 1 and 4 streams pushing ``application/x-dfd-raw`` 640×480
   chunks of 8 frames at 30 frames/s for 2 s each (a child interpreter):
   frames/s, windows scored/s, ack p50 and p99, the mean stage ms of the
   streaming histograms, ring overflow, elided copies, each stream's books
   exact (emitted = scored + dropped + shed + failed + cache hits +
   duplicates), no program and no capture after ready, and at 4 streams
   the device's busy share (each bucket's profiled batch × its batches,
   over the level's wall); the MJPEG row: a stream of MJPEG chunks of the
   two 640×480 fixtures and one of the raw chunks of their decodes, a
   window at a time, windows bitwise equal, then 4 MJPEG streams at 30
   frames/s for 2 s, every chunk 200, books exact (frames/s and the
   ``decode`` stage ms), the MJPEG chunks' launches counted alone
   (``stream_mjpeg``; the raw twin's stay with ``stream``); the depthwise
   launches 55 × replays; then
   ``runners.stream`` as a child with ``--state-dir``: seconds to
   ``/readyz`` 200, two streams pushed, SIGTERM → exit 0 and two
   snapshots, the relaunch restores both and their windows and verdicts
   continue from the snapshot;
13. the fleet router (``router``): ``runners.router`` as a child process
   spawning 2 serve replicas of the same checkpoint (each its own process,
   uint8 wire, buckets 1, 4, 16, ``--device cuda``): seconds to ready with
   2 cold starts at once and each replica's warmup stages, 6 captures a
   replica and none after ready; at N = 2 through it and at N = 1 through
   a second router in front of one of the two replicas (no third cold
   start): P(fake) through the router bitwise the card CLI, 32
   closed-loop clients for 2 s with clips/s, p50/p99, statuses, the
   replicas' stage ms, each replica's share of the forwards, device memory
   by process (``nvidia-smi --query-compute-apps``), nvidia-smi's sampled
   ``utilization.gpu`` and the router's CPU ms a relay, router books exact
   (routed = cache hits + forwarded + migrated + shed + failed); at N = 1
   a third router with the edge cache (repeated bodies answered as cache
   hits, the epoch moved by a hot reload); at N = 2 a replica SIGKILLed
   under load (marked down, every request failed over, the survivor's
   clips/s); two stream replicas
   with four raw 640×480 streams, the replica holding sessions drained
   mid-stream (every session moved, transitions at windows 6 and 10, books
   exact); ``--autoscale`` with the backfill tenant on the backfill phase's
   manifest (the tenant yields with exit 75, then a replica spawns; scale-in
   drains first; spawned = retired + killed + alive; the tenant's books
   exact; the decision trace replays alike); the depthwise launches as the
   replicas' replays × 55 plus the tenant's own counts;
14. training path: ``runners.train`` in-process on the flagship at full width
   and depth, 12×600², batch 3, f32 (``scripts/train.sh``'s config on
   synthetic data: 8 steps, validation of the model and its EMA,
   checkpoints); 55 forward, 55 dx and 55 dw-gradient launches per step;
   loss finite; params, BN stats and EMA moved; the inference path scores a
   frame with the checkpoint; ms per step, samples/s, peak memory, the
   loader's host wait, and the device time per step by kernel kind;
15. training from a clip tree (``train_data``, f32): a seeded tree of uint8
   ``.npy`` frames at 640² under ``build/chip_smoke/tree`` (more fakes than
   reals, some clips shorter than 4 frames), ``runners.train`` in-process
   on the flagship at 12×600², batch 3, with ``scripts/train.sh``'s data
   and augment flags, one epoch (≥ 8 steps): 55/55/55 depthwise launches a
   step, loss finite, no guarded step, params and BN stats moved, the
   checkpoint scores a frame; one prologue batch on the card against the
   same batch rendered on the CPU, stage by stage (draws made on the CPU);
   a pack of the tree (``data/packed.py``) whose first two training
   batches equal the tree's bitwise; ms per step, samples/s, peak memory,
   the loader's host wait, each prologue stage's device ms (torch.profiler)
   and the idle share of profiled steps, beside the synthetic phase's;
   the run observed (``obs``): ``telemetry.jsonl`` with one record a
   drain whose data, device and host shares sum to the window, the MFU
   gauge above 0, ``--metrics-port`` scraped mid-run, a ``PROFILE`` file's
   two-step trace naming the depthwise forward, dx and dw-gradient
   kernels 55 times a step each; then the same run with
   ``--no-telemetry``: the same launches a step, the same synchronizing
   calls a drain (``torch.cuda.set_sync_debug_mode`` warnings) and step
   ms within the runs' spread; then the same clips and lists as ``.jpg``
   frames only (the four 640² fixtures, no ``.npy``) and as the ``.npy``
   of their decodes: the first batches bitwise equal, and 4 steps of each
   on the flagship cut to 10 blocks (ms a step, host wait), 10/10/10
   launches a step, each tree's counted alone (``train_jpeg``; the
   ``.npy`` twin's go to ``train_data``);
16. ``train_amp``: the same tree with ``scripts/train.sh``'s whole argument
   list (``--amp``, ``--auto-resume``, ``--recovery-interval`` 3, one
   epoch): every depthwise launch of the bf16 instantiations (55/55/55 a
   step), loss finite, no guarded step, params and BN stats moved, recovery
   snapshots written, the checkpoint scores a frame; the numbers of
   ``train_data`` beside the f32 phase's; ``train_data``, ``train_jpeg``,
   ``train_amp`` and ``resume`` pass ``--augment-device on`` (the device
   chain they measured before the host chain became the default);
16e. ``train_tf_b7ns``: train.sh's whole argument list (``--amp``,
   batch 3, ``--augment-device on`` as 16) on the same tree, but
   ``--model tf_efficientnet_b7_ns --model-version ""`` at 12×600², full
   width and depth: TF SAME padding in every stage, asymmetric at the stem
   (600 → 300, pads (0, 1)) and at the strided dw stages (300 → 150 k3
   (0, 1), 150 → 75 k5 (1, 2), 38 → 19 k5 (1, 2)), checked on the model;
   1 warm, 3 timed and 1 profiled step, 55/55/55 bf16 launches of the
   depthwise forward, dx and dw-gradient kernels a step and 55 forwards an
   eval batch of one validation, each counted alone; ms a step, host wait,
   busy and idle share, peak memory beside ``train_amp``'s;
16f. ``efficientnet_family``: one constructor of each EfficientNet-family
   path (``FAMILY``: TF SAME, MixNet, CondConv, EdgeTPU, MnasNet, FBNet,
   SPNAS, MobileNetV2, MobileNetV3 and its minimal ``tf_`` variant) and
   ``tf_efficientnet_b0`` with ``--gp catavgmax``, ``mobilenetv3_large_100``
   with ``--gp max``, as the trainer builds them (12 channels, 2 classes),
   f32 at 12×224², batch 2, BN calibrated on the card: eval P(fake) and
   logits card against a CPU copy within ``SCORE_TOL``, and the depthwise
   forward launched once for each single-kernel dw stage of the arch
   (counted from its block configs), nothing else; then one train step of
   ``tf_efficientnet_b0`` card against CPU by phase 19's f32 gates (SAME
   through the forward, dx and dw-gradient kernels) and its NaN batch;
16g. ``train_resnet``: train.sh's whole argument list (``--amp``, batch 3,
   ``--augment-device on`` as 16) on the same tree, but ``--model
   resnet50d --model-version "" --drop-block 0.1`` at 12×600², full width
   and depth: the deep stem, avg-down shortcuts (75 → 38 an odd map),
   DropBlock on layers 3–4 at the maps and gamma scales of
   ``RESNET_DROP_BLOCK_MAPS`` (counted by hooks), ImageNet's mean and std
   resolved by the model's name; 1 warm, 3 timed and 1 profiled step, one
   validation, the checkpoint loaded back into a fresh model bitwise; no
   depthwise or flash launch; ms a step, busy and idle share, peak memory
   beside ``train_amp``'s;
16h. ``resnet_family``: one constructor of each path of the ResNet-derived
   families and SENet (``RESNET_FAMILY``) as the trainer builds them, f32
   at 12×224², batch 2, every BN's momentum set to 1.0 on the built model
   to calibrate on the card: eval P(fake) and logits card against a CPU
   copy within ``SCORE_TOL``, no depthwise or flash launch; then one train
   step of ``resnet26d`` card against CPU by phase 19's f32 gates and its
   NaN batch, at 64² (``RESNET_GATE_SIZE``);
16a. ``train_host``: ``scripts/train_torch.sh``'s command line as it stands
   (``--augment-device off``, the default: the host chain) on the same
   tree, the flagship cut to 10 blocks, ``HOST_TRAIN_STEPS`` steps and 3
   profiled, 10/10/10 bf16 depthwise launches a step, beside the same
   steps with ``--augment-device on`` (launches counted apart, the
   ``train_host_device`` path): ms a step, the host's wait a step and the
   loader's fetch ms a batch of each;
16b. ``train_augmix``: train_torch.sh's line with ``--mixup 0 --aug-splits
   3 --jsd --split-bn`` on the same tree (bf16, full width cut to 10
   blocks, split BN everywhere), ``AUGMIX_TRAIN_STEPS`` steps and
   ``AUGMIX_PROFILED`` profiled: 9 rows a step (3 clean, 3 + 3 AugMix views), 10/10/10 bf16 depthwise launches a
   step counted for this row alone, the loss finite, every BN's main and
   aux running stats moved and apart; one eval batch through the main BN
   alone (its logits bitwise unchanged when every aux BN is set to NaN, 10
   forward launches); ms a step, host wait, idle share, peak memory;
16c. ``train_shm``: ``--loader-backend shm`` (spawned workers into a
   shared-memory ring) on train_torch.sh's line (``host``) and on 16b's
   AugMix line (``augmix``): the first 4 batches of each bitwise the thread
   backend's, as host batches and as the uint8 images on the card after
   the copy; 1 + 3 timed + 1 profiled steps on the flagship cut to 10
   blocks, 10/10/10 bf16 depthwise launches a step counted for each row
   alone; ms a step, idle share, busy
   ms, host wait, the ring's collect wait, fetch and copy ms a batch, the
   dispatching thread's CPU ms a step, ring occupancy, each beside 16a's
   host-chain row or 16b; then ``robust`` on the host, small: a worker
   killed by ``DFD_CHAOS=kill_shm_worker@2`` is respawned and the epoch's
   digests equal the thread loader's, the segment is gone and every
   worker exited after ``close()``, a ring larger than ``/dev/shm``'s free
   space raises before any worker spawns, and no worker holds torch;
16d. ``train_accum``: train.sh's line with ``--grad-accum 2`` on the same
   tree (bf16, the flagship at full width and depth, a loader batch of 6
   in two strided microbatches of 3): one epoch through
   ``runners.train.main`` (its ``summary.csv`` with an ``auc`` column, the
   eval's AUC in [0, 1]), then 1 warm, 3 timed and 1 profiled step, 110
   forward, 110 dx and 110 dw-gradient bf16 launches an optimizer step
   counted for this row alone, the optimizer stepped once a step, loss
   finite, no guarded step, params moved; ms a step, peak memory and idle
   share beside ``train_amp``'s; then, on the flagship at full width cut
   to 10 blocks at 12×224² in f32: one ``--grad-accum 2`` step (batch 4)
   on the card against the CPU by phase 19's gates and its NaN batch;
   adam, adamw, nadam, radam, adadelta, novograd, nvnovograd, lamb and
   ``lookahead_rmsproptf`` from one seeded gradient, card against CPU,
   every parameter's update within 1e-5 of that leaf's max |update| (plus
   2 f32 ulps of the weight), and a NaN batch through each leaving every
   state tensor bitwise; and ``--initial-checkpoint`` loading
   ``train_amp``'s checkpoint into the AugMix line's split-BN model, every
   ``aux_bn.<i>`` bitwise its main BN and every other tensor bitwise the
   checkpoint's;
17. ``resume``: the same bf16 run in-process on the flagship at full width
   cut to 10 blocks (``DFD_CHAOS`` set and cleared around each call,
   ``SystemExit`` caught): an uninterrupted epoch twice;
   ``sigterm@5`` → exit 75 with the snapshot ``recovery-0-4``; the snapshot
   reloaded and saved again is itself, bitwise; ``--auto-resume`` to the
   end; a ``nanbatch`` burst → one rewind, then to the end; the resumed and
   rewound states bitwise the uninterrupted one where the two uninterrupted
   runs agree bitwise, else within twice their spread;
18. TimeSformer training path: ``runners.train`` in-process on
   ``timesformer_base_patch25_600`` (full width and depth) at 12×600²,
   batch 8, ``--attn-impl flash``, in f32 and then with ``--amp``: 8 steps,
   validation of the model and its EMA, a checkpoint; 12 forward, 12 dQ and
   12 dK/dV launches a step and 12 forward launches an eval forward, all of
   the dtype's instantiation; loss finite, params and EMA moved; the EMA
   reloaded from the checkpoint scores the eval set as the run did; ms per
   step, samples/s, peak memory, the device time per step by kernel kind
   and the eval forward's clips/s at batch 16; the f32 run observed as
   ``train_data``'s, its trace naming the three flash kernels 12 times a
   step each;
19. card against CPU: one guarded train step of the full flagship at
   12×224², batch 2, and of the full TimeSformer at 12×300², batch 1, from
   the same weights on the card and on the CPU (loss, every parameter's
   update, BN running stats); then a NaN batch through each card step must
   leave the whole state bitwise unchanged; then the bf16 steps: the full
   flagship's on the card beside its f32 steps, reported and not held
   (fresh and 55 blocks deep, its bf16 update is about as far from the f32
   update as the update is long), and its NaN guard; the bf16 gate (``_bf16_checks``) on
   the flagship at full width cut to 10 blocks and on the full TimeSformer:
   each parameter's update card bf16 against CPU bf16 against its own norm,
   the loss and the BN stats likewise, the whole update by the method of
   ``tests/test_torch_amp.py``, and a bound that the card computed in bf16;
   an unchanged state and the f32 step in the bf16 step's place must each
   fail it; and a NaN batch through each bf16 card step;
20. each phase's seconds (a ``seconds`` line as each ends, and all of
   them before the ``kernels`` line), the ``budget`` line (each phase's
   seconds against its ``PHASE_BUDGET_S``, 822 in all on a host whose
   ``build`` takes under 28 s; reported, it fails nothing), the
   ``kernels`` line (all six kernels, each with its bf16 status), the
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

Without CUDA, or in a directory that holds only this file, it exits
non-zero and prints no result.  Its files go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import copy
import ctypes
import gc
import hashlib
import http.client
import functools
import io
import itertools
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import ProfilerActivity, profile

from deepfake_detection_tpu_torch import losses
from deepfake_detection_tpu_torch.backfill import (LeaseDir,
                                                   build_manifest_from_pack,
                                                   collect_books,
                                                   load_manifest,
                                                   manifest_entries,
                                                   read_verdicts,
                                                   save_manifest)
from deepfake_detection_tpu_torch.backfill.source import PackSource
from deepfake_detection_tpu_torch.backfill.writer import verdict_path
from deepfake_detection_tpu_torch.chaos import ChaosInjector
from deepfake_detection_tpu_torch.convert import flax_leaf
from deepfake_detection_tpu_torch.csrc.build import _nvcc, build, kernel
from deepfake_detection_tpu_torch.data.device_augment import (
    DeviceAugmentSpec, derive_geometric_batch)
from deepfake_detection_tpu_torch.data.loader import Prologue
from deepfake_detection_tpu_torch.data.random_erasing import \
    draw_random_erasing
from deepfake_detection_tpu_torch.data import native as jpeg_native
from deepfake_detection_tpu_torch.data.dataset import read_rgb
from deepfake_detection_tpu_torch.data.packed import write_pack
from deepfake_detection_tpu_torch.data.shm_ring import shm_free_bytes
from deepfake_detection_tpu_torch.fleet.autoscaler import replay_trace
from deepfake_detection_tpu_torch.models import (create_deepfake_model_v4,
                                                 create_model,
                                                 is_model_in_modules)
from deepfake_detection_tpu_torch.models import efficientnet_blocks as blocks
from deepfake_detection_tpu_torch.models.efficientnet import fused_dw_stages
from deepfake_detection_tpu_torch.obs.profiler import TRIGGER_FILENAME as TRIGGER
from deepfake_detection_tpu_torch.models.helpers import (load_state_dict,
                                                        set_compute_dtype)
from deepfake_detection_tpu_torch.ops import depthwise as dw
from deepfake_detection_tpu_torch.ops import flash_attention as fa
from deepfake_detection_tpu_torch.ops.conv import explicit_padding
from deepfake_detection_tpu_torch.ops.drop import DropBlock2d
from deepfake_detection_tpu_torch.ops.norm import BatchNorm2d, SplitBatchNorm2d
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.params import (normalize_replicate,
                                                 prepare_canvas)
from deepfake_detection_tpu_torch.runners import backfill as backfill_runner
from deepfake_detection_tpu_torch.runners import serve as serve_runner
from deepfake_detection_tpu_torch.runners import stream as stream_runner
from deepfake_detection_tpu_torch.runners.backfill import (BackfillConfig,
                                                           _build_dup_map,
                                                           run_backfill)
from deepfake_detection_tpu_torch.runners import test as runner
from deepfake_detection_tpu_torch.runners import train as train_runner
from deepfake_detection_tpu_torch.serving.cascade import CascadeRouter
from deepfake_detection_tpu_torch.serving.config import (ServeConfig,
                                                         StreamConfig,
                                                         parse_model_spec)
from deepfake_detection_tpu_torch.serving.engine import InferenceEngine
from deepfake_detection_tpu_torch.serving.metrics import capture_count
from deepfake_detection_tpu_torch.serving.quant import quant_summary
from deepfake_detection_tpu_torch.serving.resilience import torn_copy
from deepfake_detection_tpu_torch.train import checkpoint as ckpt
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from deepfake_detection_tpu_torch.train.trainer import validate
from flash_bench import FLAGSHIP_DW, TRAIN_BATCH, device_ms

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

# H100 SXM data-sheet peaks
MEM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12          # dense tensor cores; f32 as 3 TF32 products
EPS32 = float(np.finfo(np.float32).eps)

MAIN_BATCH = 1                    # test_img: one image or clip a forward
KERNEL_BATCHES = (MAIN_BATCH, 2)  # batches of the kernel-vs-plain rows

F32_TOL = (1e-5, 1e-5)            # |kernel - plain| ≤ atol + rtol·|plain|
BF16_TOL = (1e-6, 2.0 ** -7)      # one bf16 rounding apart, 2^-8 relative
SCORE_TOL = 1e-3                  # P(fake), card vs CPU, f32 over 55 blocks
# gradients (dw, dx, dscale, dbias) are sums of up to 270k products taken in
# other orders than the plain version's: |kernel - plain| ≤ GRAD_TOL ·
# max|plain| per tensor (1.1e-6 measured); a bf16 dx is one bf16 rounding
GRAD_TOL = 1e-5
BF16_GRAD_TOL = 2.0 ** -7
LOSS_TOL = 1e-4                   # card vs CPU train step, relative
UPDATE_TOL = 1e-3                 # of each parameter update's own max |·|
# the bf16 gate, card bf16 against CPU bf16 (the same code, the same
# weights and inputs): each leaf's update within BF16_LEAF_TOL of its own
# norm, the loss within BF16_LOSS_TOL, BN statistics within BF16_BN_TOL of
# their layer's scale; each twice the largest value measured on an H100
# (the 10-block flagship 0.080, 0.0080, 0.0065; the TimeSformer 0.031,
# 0.0020, no BN)
BF16_LEAF_TOL = 0.16
BF16_LOSS_TOL = 0.016
BF16_BN_TOL = 0.013

# the f32 phases keep the compute of the earlier runs: the runner's default
# compute dtype is bf16 now, as the JAX runner's
F32 = ["--compute-dtype", "float32"]

# scripts/train.sh's flags that the port has, on synthetic data, one epoch
# (24 samples: 8 steps); --log-interval 1 reads each step's metrics back,
# so each step's host time is its device time
TRAIN_FLAGS = F32 + ["--dataset", "synthetic", "--model", "efficientnet_deepfake_v4",
               "--model-version", "v4", "--input-size-v2", "12,600,600",
               "-b", str(TRAIN_BATCH), "--opt", "rmsproptf", "--basic-lr",
               "5e-7", "--sched", "step", "--decay-epochs", "2",
               "--decay-rate", ".92", "--bn-momentum", "0.001", "--mixup",
               "0.1", "--model-ema", "--epochs", "1", "--log-interval", "1"]


# the TimeSformer's training path: timesformer_base_patch25_600 on the
# flagship's 12×600² clips (4 frames, 576 patches of 25² each), batch 8, the
# flash kernels for the spatial attention of its 12 blocks; 64 synthetic
# clips make 8 steps, 32 eval clips 2 eval batches of 16
TSF_MODEL = "timesformer_base_patch25_600"
TSF_BATCH = 8
TSF_BLOCKS = 12
# the TimeSformer's card-vs-CPU gates at batch 1 (2 before a cut for time:
# its three CPU steps at batch 2 took 28.6 s of that phase's 80.9)
TSF_GATE_BATCH = 1
TSF_FLAGS = ["--dataset", "synthetic", "--model", TSF_MODEL,
             "--model-version", "", "--input-size-v2", "12,600,600",
             "--attn-impl", "flash", "-b", str(TSF_BATCH), "--opt",
             "rmsproptf", "--model-ema", "--epochs", "1", "--log-interval",
             "1"]
# (B·frames·heads) of the spatial attention: a train step at batch 8 and an
# eval forward at batch 16; 576 tokens a frame, head dim 64
FLASH_BH = (TSF_BATCH * 4 * 12, 2 * TSF_BATCH * 4 * 12)
FLASH_L, FLASH_D = 576, 64
# kernel vs plain, f32: o and lse elementwise within atol + rtol·|plain|
# (sums of 576 products in another order, online rescaling against one
# softmax); gradients within FLASH_GRAD_TOL of each gradient's max |plain|
# (the backward kernels take every product as three TF32 products, the
# plain version as one f32 matmul)
FLASH_TOL = (2e-5, 2e-5)
FLASH_GRAD_TOL = 1e-5

# training from a clip tree: scripts/train.sh's data and augment flags in
# f32 with one epoch; --log-interval 1, as the synthetic phase, reads each
# step's metrics back
TREE_HW = 640                     # uniform source frames, larger than 600
TREE_REALS, TREE_FAKES = 14, 30   # label balance: 26 train samples, 8 steps
DATA_FLAGS = F32 + [
              "--model", "efficientnet_deepfake_v4", "--model-version", "v4",
              "--input-size-v2", "12,600,600", "-b", str(TRAIN_BATCH),
              "--opt", "rmsproptf", "--basic-lr", "5e-7", "--sched", "step",
              "--decay-epochs", "2", "--decay-rate", ".92", "--epochs", "1",
              "--reprob", "0.2", "--remax", "0.05", "--flicker", "0.05",
              "--rotate-range", "5", "--blur-prob", "0.05",
              "--bn-momentum", "0.001", "--mixup", "0.1", "--label-balance",
              "--eval-metric", "loss", "--workers", "8", "--experiment",
              "flagship", "--log-interval", "1", "--augment-device", "on"]
# the prologue, card against CPU on one batch: the warp and the blur may
# differ by one grey level where an FMA flips a rounding at .5, in at most
# WARP_FRAC of the values (tests/test_torch_device_augment.py); jitter within
# JITTER_ATOL on 0..255; integer warps, the mixup blend, normalize and
# erasing bitwise
WARP_FRAC, WARP_MAX = 1e-3, 1.0
JITTER_ATOL = 1e-3
DATA_DEVICE = "cuda"

JPEG_PROBE = r"""#include <stdio.h>
#include <jpeglib.h>
int main(void) {
  struct jpeg_decompress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  printf("%d\n", JPEG_LIB_VERSION);
  return 0;
}
"""


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def jpeg_probe() -> dict:
    """Whether a C file that includes ``jpeglib.h`` compiles and links with
    ``-ljpeg`` here (the host compiler, else ``nvcc``), and the library's
    ``JPEG_LIB_VERSION``."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "jpeg_probe.c", OUT / "jpeg_probe"
    src.write_text(JPEG_PROBE)
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        try:
            cc = _nvcc()
        except RuntimeError:
            return {"ok": False, "compiler": None}
    proc = subprocess.run([cc, str(src), "-o", str(exe), "-ljpeg"],
                          capture_output=True, text=True, timeout=120)
    out = {"ok": proc.returncode == 0, "compiler": cc,
           "stderr": proc.stderr.strip()[-300:]}
    if out["ok"]:
        run = subprocess.run([str(exe)], capture_output=True, text=True,
                             timeout=60)
        out["jpeg_lib_version"] = run.stdout.strip()
    return out


# the port's JPEG decoder (data/native.py): the committed fixtures, their
# libjpeg-turbo digests and the sweeps (tests/torch_jpeg_fixtures.py)
JPEG_DIR = ROOT / "tests" / "data" / "jpeg"
JPEG_FACES = tuple(f"face{i}" for i in range(4))      # 640², 4:2:0, q90
JPEG_STREAMS = ("stream0", "stream1")                 # 640×480, 4:2:0, q85
JPEG_POOL_THREADS = (1, 4, 8)
JPEG_POOL_FRAMES = 64                                 # frames a pool call
JPEG_TRAIN_STEPS = 4


def jpeg_bytes(name: str) -> bytes:
    return (JPEG_DIR / f"{name}.jpg").read_bytes()


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _sweep_case(data: bytes, case: list) -> bytes:
    """One committed sweep case: ``["trunc", n]`` or ``["flip", pos,
    bit]``."""
    if case[0] == "trunc":
        return data[:case[1]]
    b = bytearray(data)
    b[case[1]] ^= 1 << case[2]
    return bytes(b)


HOST_AUG_ITERS = 5                # timed calls a host stage (after one)
AUGMIX_TRAIN_STEPS = 6            # timed steps of train_augmix (the first
AUGMIX_PROFILED = 2               # left out of the means), then profiled:
                                  # the tree's 8 batches an epoch
AUGMIX_STAGE_ITERS = 8            # timed AugMix stages of a clip (after one)
AUGMIX_OVERRIDES = ["--mixup", "0", "--aug-splits", "3", "--jsd",
                    "--split-bn", "--epochs", "1", "--recovery-interval",
                    "0", "--no-telemetry"]
HOST_TRAIN_STEPS = 4              # timed steps a train_host row (the first
                                  # left out of the means), then 3 profiled
                                  # in the host-chain row: of the tree's 8
                                  # batches an epoch


def _host_fixtures():
    """``tests/torch_host_augment_fixtures.py``: the digest cases' inputs
    and the port's side of them (it imports neither Pillow nor JAX)."""
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import torch_host_augment_fixtures as fx
    finally:
        sys.path.pop(0)
    return fx


def _augmix_fixtures():
    """``tests/torch_augmix_fixtures.py``, as :func:`_host_fixtures`."""
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import torch_augmix_fixtures as fx
    finally:
        sys.path.pop(0)
    return fx


def _times_ms(fn, iters: int = HOST_AUG_ITERS) -> list:
    """ms of each of ``iters`` calls of ``fn``, after one untimed call."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _median_ms(fn, iters: int = HOST_AUG_ITERS) -> float:
    return float(np.median(_times_ms(fn, iters)))


def _spread(ms: list) -> dict:
    """min, median, max and standard deviation of a list of ms."""
    return dict(min=float(np.min(ms)), median=float(np.median(ms)),
                max=float(np.max(ms)), std=float(np.std(ms)))


def phase_host_augment() -> dict:
    """The host augment chain on the card's host (no Pillow): every
    committed digest case and the first
    host batches of the train loader under ``scripts/train.sh``'s flags
    (with and without ``--host-geom``) equal to their digests; the host ms
    a 640² clip by stage, one thread."""
    from deepfake_detection_tpu_torch.data import transforms as tf
    from deepfake_detection_tpu_torch.data.mixup import FastCollateMixup
    fx = _host_fixtures()
    info = jpeg_native.build_info()
    digests = fx.load_digests()
    t0 = time.perf_counter()
    bad = [n for n in fx.CASES
           if fx.sha(fx.port_case(n)) != digests["cases"][n]]
    cases_s = time.perf_counter() - t0
    root = OUT / "host_tree"
    shutil.rmtree(root, ignore_errors=True)
    fx.make_tree(root)
    loaders = {}
    for name, extra in fx.LOADERS.items():
        loaders[name] = fx.port_batches(str(root), extra) == \
            digests["loaders"][name]
        if not loaders[name]:
            bad.append(name)
    shutil.rmtree(root, ignore_errors=True)
    # the stages of one clip at the flagship's shape: 4 frames of 640² into
    # 600² (the chip tree's clips), the JAX runner's blur radius 1
    clip = fx.clip(7)
    rng = np.random.default_rng(0)
    warp = tf.MultiFusedGeometric(600, rotate_range=5)
    frames = list(warp(clip, rng))
    blur = tf.MultiBlur(1.0, 1.0)
    jitter = tf.MultiColorJitter(0.4, 0.4, 0.4)
    flicker = tf.MultiFlicker(0.05)
    concat = tf.MultiConcate()
    samples = [np.ascontiguousarray(concat(frames))] * TRAIN_BATCH
    mixup = FastCollateMixup(0.1, 0.1, 2)

    def collate_blend():
        mixup(np.stack(samples), np.array([0, 1, 0]),
              np.random.default_rng(1))
    ms = {"warp": _median_ms(lambda: warp(clip, rng)),
          "blur_4_frames": _median_ms(lambda: blur(frames, rng)),
          "jitter": _median_ms(lambda: jitter(frames, rng)),
          "flicker": _median_ms(lambda: flicker(frames, rng)),
          "concat": _median_ms(lambda: concat(frames)),
          "collate_and_blend_batch": _median_ms(collate_blend)}
    # a clip of train.sh's chain: the warp, 0.05 of 4 frames blurred, the
    # jitter, the flicker, the concatenation, and its share of a batch's
    # collate and blend
    ms["per_clip_train_sh"] = (ms["warp"] + 0.05 * ms["blur_4_frames"]
                               + ms["jitter"] + ms["flicker"] + ms["concat"]
                               + ms["collate_and_blend_batch"] / TRAIN_BATCH)
    emit(phase="host_augment", nvidia_smi=nvidia_smi_line(),
         cpu_count=os.cpu_count(), library=Path(info["library"]).name,
         pillow_of_digests=digests["pillow"], cases=len(fx.CASES),
         cases_s=cases_s,
         cases_bitwise=len(fx.CASES) - sum(b in fx.CASES for b in bad),
         loaders_bitwise=loaders, host_ms_a_clip=ms, bad=bad[:5])
    if bad:
        raise AssertionError(f"the host augment chain on this host: {bad}")
    return dict(ms=ms)


def phase_augmix() -> dict:
    """AugMix's ops and policies on the card's host (no Pillow): every
    committed digest case and the first host batches of the ``--aug-splits
    3 --resplit`` loader equal to their digests; the host ms a 600² frame
    of each op and of one ``AugMixAugment`` call, one thread, and of the
    AugMix stage of a 4-frame 600² clip (``AugMixDataset``, two views)."""
    from deepfake_detection_tpu_torch.data import auto_augment as aa
    from deepfake_detection_tpu_torch.data import imaging
    from deepfake_detection_tpu_torch.data.dataset import AugMixDataset
    fx = _augmix_fixtures()
    hx = fx.hx
    digests = fx.load_digests()
    t0 = time.perf_counter()
    bad = [n for n in fx.CASES
           if fx.sha(fx.port_case(n)) != digests["cases"][n]]
    cases_s = time.perf_counter() - t0
    root = OUT / "augmix_tree"
    shutil.rmtree(root, ignore_errors=True)
    hx.make_tree(root)
    loader = fx.port_batches(str(root)) == digests["loaders"]["augmix_resplit"]
    shutil.rmtree(root, ignore_errors=True)
    if not loader:
        bad.append("augmix_resplit")
    a, b = hx.photo(11, 600, 600), hx.photo(12, 600, 600)
    fill, bl, bc = fx.FILL, imaging.BILINEAR, imaging.BICUBIC
    ops = {"autocontrast": lambda: imaging.autocontrast(a),
           "equalize": lambda: imaging.equalize(a),
           "posterize": lambda: imaging.posterize(a, 3),
           "solarize": lambda: imaging.solarize(a, 200),
           "solarize_add": lambda: imaging.solarize_add(a, 50),
           "invert": lambda: imaging.invert(a),
           "color": lambda: imaging.color(a, 1.3),
           "contrast": lambda: imaging.contrast(a, 1.3),
           "brightness": lambda: imaging.brightness(a, 1.3),
           "sharpness": lambda: imaging.sharpness(a, 1.3),
           "blend": lambda: imaging.blend(a, b, 0.3),
           "rotate_bilinear": lambda: imaging.rotate_fill(a, 7.5, bl, fill),
           "rotate_bicubic": lambda: imaging.rotate_fill(a, 7.5, bc, fill),
           "shear_bilinear": lambda: imaging.affine(
               a, (1, 0.2, 0, 0, 1, 0), bl, fill),
           "shear_bicubic": lambda: imaging.affine(
               a, (1, 0.2, 0, 0, 1, 0), bc, fill),
           "translate_bilinear": lambda: imaging.affine(
               a, (1, 0, 90.5, 0, 1, 0), bl, fill),
           "translate_bicubic": lambda: imaging.affine(
               a, (1, 0, 90.5, 0, 1, 0), bc, fill)}
    ms = {k: _median_ms(fn) for k, fn in ops.items()}
    augmix = aa.augment_and_mix_transform("augmix-m3-w3")
    rng = np.random.default_rng(0)
    ms["augmix_call"] = _median_ms(lambda: augmix(a, rng))
    clip = np.concatenate([hx.photo(20 + i, 600, 600) for i in range(4)], -1)
    stage = AugMixDataset(None, num_splits=3)
    stage_ms = _times_ms(
        lambda: [stage._augment_clip(clip, rng) for _ in range(2)],
        AUGMIX_STAGE_ITERS)
    ms["augmix_stage_a_clip"] = float(np.median(stage_ms))
    emit(phase="augmix", nvidia_smi=nvidia_smi_line(),
         cpu_count=os.cpu_count(), pillow_of_digests=digests["pillow"],
         cases=len(fx.CASES), cases_s=cases_s,
         cases_bitwise=len(fx.CASES) - sum(n in fx.CASES for n in bad),
         loader_bitwise=loader, host_ms_a_600_frame=ms,
         augmix_stage_ms=stage_ms, augmix_stage_spread=_spread(stage_ms),
         bad=bad[:5])
    if bad:
        raise AssertionError(f"AugMix's ops on this host: {bad}")
    return dict(ms=ms, stage_spread=_spread(stage_ms))


def phase_jpeg() -> dict:
    """The port's JPEG decoder on the card's host: built by the host C++
    compiler (timed); every committed fixture decoded to its committed
    libjpeg-turbo digest, the declined one declined; the committed
    truncation and bit-flip sweeps over one baseline and one progressive
    fixture, each case its CPU digest or None as committed; ms a frame on
    one thread (640² and 640×480, 4:2:0) and the pool's frames/s at 1, 4
    and 8 threads."""
    t0 = time.perf_counter()
    info = jpeg_native.build_info()
    build_s = time.perf_counter() - t0
    digests = json.loads((JPEG_DIR / "digests.json").read_text())
    fixtures, bad = {}, []
    for name, entry in sorted(digests["fixtures"].items()):
        reasons = []
        arr = jpeg_native.decode_jpeg_bytes(jpeg_bytes(name),
                                            reasons=reasons)
        got = "declined" if arr is None else _sha(arr)
        fixtures[name] = got == entry["sha256"]
        if got != entry["sha256"]:
            bad.append((name, got, reasons))
    sweeps = {}
    for name, rows in sorted(digests["sweeps"].items()):
        data = jpeg_bytes(name)
        wrong = []
        for case, want in rows:
            arr = jpeg_native.decode_jpeg_bytes(_sweep_case(data, case))
            got = None if arr is None else _sha(arr)[:16]
            if got != want:
                wrong.append((case, got, want))
        sweeps[name] = dict(cases=len(rows), equal=len(rows) - len(wrong),
                            declined=sum(w is None for _, w in rows),
                            wrong=wrong[:5])
        bad += [(name, w) for w in wrong]
    single = {}
    for name in (JPEG_FACES[0], JPEG_STREAMS[0]):
        data = jpeg_bytes(name)
        times = []
        for _ in range(30):
            s = time.perf_counter()
            jpeg_native.decode_jpeg_bytes(data)
            times.append(time.perf_counter() - s)
        single[name] = dict(shape=list(jpeg_native.decode_jpeg_bytes(
            data).shape), ms_median=float(np.median(times[5:])) * 1e3,
            ms_min=float(np.min(times)) * 1e3)
    frames = [jpeg_bytes(JPEG_FACES[i % 4]) for i in range(JPEG_POOL_FRAMES)]
    pool = {}
    for n in JPEG_POOL_THREADS:
        p = jpeg_native.DecodePool(n)
        try:
            p.decode_buffers(frames)
            s = time.perf_counter()
            for _ in range(3):
                p.decode_buffers(frames)
            pool[str(n)] = 3 * JPEG_POOL_FRAMES / (time.perf_counter() - s)
        finally:
            p.close()
    emit(phase="jpeg", nvidia_smi=nvidia_smi_line(), cpu_count=os.cpu_count(),
         compiler=info["compiler"], build_s=info["build_s"],
         first_use_s=build_s, library=Path(info["library"]).name,
         fixtures_bitwise=fixtures, sweeps=sweeps,
         single_thread=single, pool_frames_per_s_640sq=pool, bad=bad[:5])
    if bad:
        raise AssertionError(f"the JPEG decoder on this host: {bad[:5]}")
    return dict(single=single, pool=pool, build_s=info["build_s"])


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call of ``fn()`` issued back to back, CUDA events around the
    run: where the host issues slower than the device runs, this is the
    host's rate."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flagship_dw_shapes(model, size: int) -> Counter:
    """(H in, C, k, stride) of every depthwise stage for a ``size``² input,
    walked from the model's own blocks (``dw_stage_pads``)."""
    return Counter(stage[:4] for stage in dw_stage_pads(model, size))


def _case(shape, k, dtype, seed, identity=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    w = torch.randn((k, k, c), generator=g, device="cuda") * 0.2
    if identity:
        return x, w, None, None
    scale = torch.rand(c, generator=g, device="cuda") + 0.5
    bias = (torch.rand(c, generator=g, device="cuda") - 0.5) * 0.4
    return x, w, scale, bias


def check(name, x, w, scale, bias, stride, padding, act, tol) -> float:
    """Kernel vs plain y elementwise within ``tol``; two kernel calls must
    agree bitwise.  Returns the max absolute error."""
    y = dw.fused_depthwise(x, w, scale, bias, stride, padding, act)
    again = dw.fused_depthwise(x, w, scale, bias, stride, padding, act)
    ref = dw.fused_depthwise_reference(x, w, scale, bias, stride, padding,
                                       act)
    torch.cuda.synchronize()
    if not torch.equal(y, again):
        raise AssertionError(f"{name}: two forward calls differ")
    if y.shape != ref.shape or y.dtype != ref.dtype:
        raise AssertionError(f"{name}: {y.shape} {y.dtype} vs plain "
                             f"{ref.shape} {ref.dtype}")
    diff = (y.float() - ref.float()).abs()
    bound = tol[0] + tol[1] * ref.float().abs()
    if not torch.isfinite(y).all() or bool((diff > bound).any()):
        raise AssertionError(f"{name}: max |kernel - plain| "
                             f"{diff.max().item():.3e} over atol {tol[0]} + "
                             f"rtol {tol[1]}")
    return diff.max().item()


def stage_cost(b, h, c, k, s, itemsize):
    """Bytes the stage must move (x read once, y written once, w, scale,
    bias) and its operations (k² multiply-adds + affine + SiLU per
    output)."""
    ho = (h + 2 * (((s - 1) + (k - 1)) // 2) - k) // s + 1
    nbytes = (b * h * h * c + b * ho * ho * c) * itemsize + (k * k + 2) * c * 4
    ops = b * ho * ho * c * (2 * k * k + 6)
    return nbytes, ops


def phase_kernels(shapes: Counter) -> dict:
    """Kernel vs plain at every flagship depthwise shape, at the main path's
    batch (``runners.test.test_img`` scores one image or clip per forward)
    and at batch 2; returns the totals per batch over the 55 stages."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err = 0.0
    totals = {}
    for batch in KERNEL_BATCHES:
        tot = totals[batch] = dict(ms=0.0, call_ms=0.0, plain_ms=0.0,
                                   library_ms=0.0, bound_ms=0.0,
                                   bytes_ms=0.0, ops_ms=0.0)
        for i, ((h, c, k, s), count) in enumerate(sorted(shapes.items())):
            x, w, scale, bias = _case((batch, h, h, c), k, torch.float32,
                                      100 * batch + i)
            err = check(f"f32 b{batch} {h}x{h}x{c} k{k} s{s}", x, w, scale,
                        bias, s, "", "silu", F32_TOL)
            max_err = max(max_err, err)
            xc = x.permute(0, 3, 1, 2)
            w_lib = (w * scale).permute(2, 0, 1).unsqueeze(1).contiguous()
            p = ((s - 1) + (k - 1)) // 2

            def kernel():
                return dw.fused_depthwise(x, w, scale, bias, s, "", "silu")
            ms = device_ms(kernel)
            per_call = call_ms(kernel)
            plain = device_ms(lambda: dw.fused_depthwise_reference(
                x, w, scale, bias, s, "", "silu"))
            lib = device_ms(lambda: F.silu(F.conv2d(xc, w_lib, bias, s, p, 1,
                                                    c)))
            nbytes, ops = stage_cost(batch, h, c, k, s, 4)
            b_ms = nbytes / MEM_BYTES_PER_S * 1e3
            o_ms = ops / F32_FLOP_PER_S * 1e3
            row = dict(h=h, c=c, k=k, stride=s, count=count, batch=batch,
                       max_abs_err=err, ms=ms, call_ms=per_call,
                       plain_ms=plain, library_ms=lib,
                       bound_ms=max(b_ms, o_ms),
                       bound_by="bytes" if b_ms >= o_ms else "operations",
                       bound_share=max(b_ms, o_ms) / ms,
                       gbytes_per_s=nbytes / ms / 1e6)
            emit(phase="kernel_row", **row)
            for key, v in (("ms", ms), ("call_ms", per_call),
                           ("plain_ms", plain), ("library_ms", lib),
                           ("bound_ms", row["bound_ms"]), ("bytes_ms", b_ms),
                           ("ops_ms", o_ms)):
                tot[key] += count * v
    # bf16 on a few flagship rows, then the edge cases
    bf16 = [(300, 256, 3, 1), (150, 288, 5, 2), (19, 3840, 3, 1)]
    for j, (h, c, k, s) in enumerate(bf16):
        x, w, scale, bias = _case((2, h, h, c), k, torch.bfloat16, 100 + j)
        check(f"bf16 {h}x{h}x{c} k{k} s{s}", x, w, scale, bias, s, "",
              "silu", BF16_TOL)
    edges = [("C=13 odd H/W k3 s1", (2, 37, 29, 13), 3, 1, "", "silu"),
             ("C=13 k5 s2 same", (2, 36, 36, 13), 5, 2, "same", "relu"),
             ("odd H/W k5 s2 int pad", (3, 31, 45, 24), 5, 2, 1, "none"),
             ("same pad k3 s2 even", (2, 40, 40, 64), 3, 2, "same", "silu"),
             ("relu k3 s1", (2, 17, 17, 96), 3, 1, "", "relu")]
    for j, (name, shape, k, s, pad, act) in enumerate(edges):
        x, w, scale, bias = _case(shape, k, torch.float32, 200 + j)
        max_err = max(max_err, check(name, x, w, scale, bias, s, pad, act,
                                     F32_TOL))
    x, w, _, _ = _case((2, 23, 23, 40), 3, torch.float32, 300, identity=True)
    max_err = max(max_err, check("identity affine", x, w, None, None, 1, "",
                                 "none", F32_TOL))
    # contiguous but only 4-byte aligned: the kernel's scalar path
    flat = torch.randn(1 + 19 * 19 * 48, device="cuda")
    x = flat[1:].view(1, 19, 19, 48)
    w = torch.randn(3, 3, 48, device="cuda") * 0.2
    max_err = max(max_err, check("unaligned base", x, w, None, None, 1, "",
                                 "silu", F32_TOL))
    xb, wb, _, _ = _case((2, 15, 15, 13), 3, torch.bfloat16, 400, True)
    check("bf16 C=13", xb, wb, None, None, 2, "same", "silu", BF16_TOL)
    for batch, tot in totals.items():
        emit(phase="kernels", batch=batch, rows=len(shapes),
             stages=sum(shapes.values()), max_abs_err=max_err, **tot)
    return dict(max_abs_err=max_err, **totals[MAIN_BATCH])


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|, in f32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _grad_case(shape, k, s, pad, dtype, seed):
    """x (NHWC, ``dtype``), its pads, and an f32 upstream gradient dz of
    the stage's output shape."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    pads = explicit_padding(pad, (k, k), 1, s, shape[1], shape[2])
    ho, wo = dw.output_size(shape[1], shape[2], k, s, pads)
    dz = torch.randn((shape[0], ho, wo, shape[3]), generator=g, device="cuda")
    return x, dz, pads


def check_dwgrad(name, x, dz, k, s, pads) -> float:
    """Kernel vs plain dw; two kernel calls must agree bitwise.  Returns
    the max absolute error."""
    a = dw.depthwise_dwgrad(x, dz, k, s, pads)
    b = dw.depthwise_dwgrad(x, dz, k, s, pads)
    ref = dw.depthwise_dwgrad_reference(x, dz, k, s, pads)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two dw-gradient calls differ")
    rel = _rel_err(a, ref)
    if not torch.isfinite(a).all() or rel > GRAD_TOL:
        raise AssertionError(f"{name}: dw |kernel - plain| / max|plain| "
                             f"{rel:.3e} > {GRAD_TOL}")
    return (a - ref).abs().max().item()


def _device_kernels(fn) -> Counter:
    """Launches of each kernel in one ``fn()`` on the card, by name
    (torch.profiler); empty where the profiler sees no device activity."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter({e.key: e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA})


def phase_dwgrad(shapes: Counter) -> dict:
    """The dw-gradient kernel against its plain version at every flagship
    depthwise shape at the training batch, bf16 x on a few, edge cases;
    each stage's row also gives its workspace bytes and kernel launches a
    call; returns the count-weighted sums over the 55 stages."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0, workspace_bytes=0)
    max_err = 0.0
    for i, ((h, c, k, s), count) in enumerate(sorted(shapes.items())):
        x, dz, pads = _grad_case((TRAIN_BATCH, h, h, c), k, s, "",
                                 torch.float32, 500 + i)
        err = check_dwgrad(f"f32 {h}x{h}x{c} k{k} s{s}", x, dz, k, s, pads)
        max_err = max(max_err, err)
        xc, dzc = x.permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2)
        ms = device_ms(lambda: dw.depthwise_dwgrad(x, dz, k, s, pads))
        plain = device_ms(lambda: dw.depthwise_dwgrad_reference(
            x, dz, k, s, pads))
        lib = device_ms(lambda: torch.nn.grad.conv2d_weight(
            xc, (c, 1, k, k), dzc, s, pads[0], 1, c))
        nbytes = (x.numel() + dz.numel() + k * k * c) * 4
        ops = 2 * k * k * dz.numel()
        b_ms = nbytes / MEM_BYTES_PER_S * 1e3
        o_ms = ops / F32_FLOP_PER_S * 1e3
        # the workspace of per-tile partials, and the kernels one call
        # launches as the profiler sees them
        ws = 4 * dw._fn("depthwise_dwgrad", "dfd_depthwise_dwgrad_workspace")(
            TRAIN_BATCH, dz.shape[1], dz.shape[2], c, k)
        launched = _device_kernels(
            lambda: dw.depthwise_dwgrad(x, dz, k, s, pads))
        emit(phase="dwgrad_row", h=h, c=c, k=k, stride=s, count=count,
             batch=TRAIN_BATCH, max_abs_err=err, ms=ms, plain_ms=plain,
             library_ms=lib, bound_ms=max(b_ms, o_ms),
             bound_by="bytes" if b_ms >= o_ms else "operations",
             gbytes_per_s=nbytes / ms / 1e6, workspace_bytes=ws,
             kernel_launches_per_call=sum(launched.values()) or
             "not measured", bound_share=max(b_ms, o_ms) / ms)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", max(b_ms, o_ms)), ("bytes_ms", b_ms),
                       ("ops_ms", o_ms), ("workspace_bytes", ws)):
            tot[key] += count * v
    for j, (h, c, k, s) in enumerate([(300, 256, 3, 1), (150, 288, 5, 2),
                                      (19, 3840, 3, 1)]):
        x, dz, pads = _grad_case((TRAIN_BATCH, h, h, c), k, s, "",
                                 torch.bfloat16, 550 + j)
        check_dwgrad(f"bf16 x {h}x{h}x{c} k{k} s{s}", x, dz, k, s, pads)
    edges = [("C=13 odd H/W k3 s1", (3, 37, 29, 13), 3, 1, ""),
             ("C=13 k5 s2 same", (3, 36, 36, 13), 5, 2, "same"),
             ("odd H/W k5 s2 int pad", (3, 31, 45, 24), 5, 2, 1),
             ("same pad k3 s2 even", (3, 40, 40, 64), 3, 2, "same"),
             ("C=13 bf16 k3 s2 same", (3, 15, 15, 13), 3, 2, "same"),
             ("one tile B=1 k5 s1", (1, 7, 9, 13), 5, 1, "")]
    for j, (name, shape, k, s, pad) in enumerate(edges):
        dtype = torch.bfloat16 if "bf16" in name else torch.float32
        x, dz, pads = _grad_case(shape, k, s, pad, dtype, 560 + j)
        max_err = max(max_err, check_dwgrad(name, x, dz, k, s, pads))
    emit(phase="dwgrad", batch=TRAIN_BATCH, rows=len(shapes),
         stages=sum(shapes.values()), max_abs_err=max_err, bitwise=True,
         **tot)
    return dict(max_abs_err=max_err, **tot)


def check_backward(name, shape, k, s, pad, affine, dtype, seed):
    """``fused_depthwise`` on the card with a gradient wanted (the autograd
    node's forward, which writes z for the affine + SiLU epilogue) vs the
    plain version: y elementwise at F32_TOL (BF16_TOL for bf16 x), then dx,
    dw and, with the affine epilogue, dscale and dbias against autograd.
    Returns (y's max absolute error, the gradients' largest relative
    error)."""
    x, w, scale, bias = _case(shape, k, dtype, seed, identity=not affine)
    act = "silu" if affine else "none"
    worst = 0.0
    ys, grads = [], []
    for fn in (dw.fused_depthwise, dw.fused_depthwise_reference):
        ins = [t.clone().requires_grad_() for t in (x, w, scale, bias)
               if t is not None]
        y = fn(*ins[:2], *(ins[2:] or [None, None]), s, pad, act)
        gy = torch.randn(y.shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(seed + 1)).to(y.dtype)
        grads.append(torch.autograd.grad(y, ins, gy))
        ys.append(y.detach())
    torch.cuda.synchronize()
    got, want = ys
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    diff = (got.float() - want.float()).abs()
    if (got.shape != want.shape or got.dtype != want.dtype
            or not torch.isfinite(got).all()
            or bool((diff > tol[0] + tol[1] * want.float().abs()).any())):
        raise AssertionError(f"{name}: y {got.shape} {got.dtype}, max "
                             f"|kernel - plain| {diff.max().item():.3e} over "
                             f"atol {tol[0]} + rtol {tol[1]}")
    y_err = diff.max().item()
    for label, got, want in zip(("dx", "dw", "dscale", "dbias"), *grads):
        rel = _rel_err(got, want)
        tol = BF16_GRAD_TOL if label == "dx" and dtype == torch.bfloat16 \
            else GRAD_TOL
        if not torch.isfinite(got).all() or rel > tol:
            raise AssertionError(f"{name}: {label} |card - autograd| / "
                                 f"max|autograd| {rel:.3e} > {tol}")
        worst = max(worst, rel)
    return y_err, worst


def check_dx(name, dz, w, x_shape, s, pads, dtype) -> float:
    """The dx kernel vs its plain version: within GRAD_TOL of dx's max
    |plain| (BF16_GRAD_TOL for a bf16 dx, one rounding apart); two calls
    must agree bitwise.  Returns the error relative to max |plain| and the
    max absolute error."""
    a = dw.depthwise_dx(dz, w, x_shape, s, pads, dtype)
    b = dw.depthwise_dx(dz, w, x_shape, s, pads, dtype)
    ref = dw.depthwise_dx_reference(dz, w, x_shape, s, pads, dtype)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two dx calls differ")
    if a.shape != ref.shape or a.dtype != ref.dtype:
        raise AssertionError(f"{name}: dx {a.shape} {a.dtype} vs plain "
                             f"{ref.shape} {ref.dtype}")
    rel = _rel_err(a, ref)
    tol = BF16_GRAD_TOL if dtype == torch.bfloat16 else GRAD_TOL
    if not torch.isfinite(a).all() or rel > tol:
        raise AssertionError(f"{name}: dx |kernel - plain| / max|plain| "
                             f"{rel:.3e} > {tol}")
    return rel, (a.float() - ref.float()).abs().max().item()


def phase_dx(shapes: Counter) -> dict:
    """The dx kernel against its plain version at every flagship depthwise
    shape at the training batch and at edge cases; its device time beside
    the plain version's, cuDNN's input gradient and the bound; returns the
    count-weighted sums over the 55 stages and the largest error."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    worst = worst_abs = 0.0
    for i, ((h, c, k, s), count) in enumerate(sorted(shapes.items())):
        x, dz, pads = _grad_case((TRAIN_BATCH, h, h, c), k, s, "",
                                 torch.float32, 750 + i)
        w = torch.randn((k, k, c), device="cuda") * 0.2
        shape = tuple(x.shape)
        err, abs_err = check_dx(f"f32 {h}x{h}x{c} k{k} s{s}", dz, w, shape,
                                s, pads, torch.float32)
        worst, worst_abs = max(worst, err), max(worst_abs, abs_err)
        ms = device_ms(lambda: dw.depthwise_dx(dz, w, shape, s, pads,
                                               torch.float32))
        plain = device_ms(lambda: dw.depthwise_dx_reference(
            dz, w, shape, s, pads, torch.float32))
        w_lib = w.permute(2, 0, 1).unsqueeze(1).contiguous()
        dzc = dz.permute(0, 3, 1, 2)
        lib = device_ms(lambda: torch.nn.grad.conv2d_input(
            (TRAIN_BATCH, c, h, h), w_lib, dzc, s, pads[0], 1, c))
        nbytes = (dz.numel() + x.numel() + k * k * c) * 4
        b_ms = nbytes / MEM_BYTES_PER_S * 1e3
        o_ms = 2 * k * k * dz.numel() / F32_FLOP_PER_S * 1e3
        emit(phase="dx_row", h=h, c=c, k=k, stride=s, count=count,
             batch=TRAIN_BATCH, max_rel_err=err, ms=ms, plain_ms=plain,
             library_ms=lib, bound_ms=max(b_ms, o_ms),
             bound_by="bytes" if b_ms >= o_ms else "operations",
             bound_share=max(b_ms, o_ms) / ms,
             gbytes_per_s=nbytes / ms / 1e6)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", max(b_ms, o_ms)), ("bytes_ms", b_ms),
                       ("ops_ms", o_ms)):
            tot[key] += count * v
    edges = [("padding k at k=3", (3, 17, 17, 24), 3, 1, 3, torch.float32),
             ("padding k+1 at k=5, stride 2", (3, 19, 21, 24), 5, 2, 6,
              torch.float32),
             ("C=13 odd H/W k5 s2", (3, 31, 45, 13), 5, 2, 1, torch.float32),
             ("C=13 odd H/W k3 s1 same", (3, 37, 29, 13), 3, 1, "same",
              torch.float32),
             ("bf16 dx k3 s2 same", (3, 40, 40, 64), 3, 2, "same",
              torch.bfloat16),
             ("bf16 dx C=13 k5 s1", (3, 15, 15, 13), 5, 1, "",
              torch.bfloat16)]
    for j, (name, shape, k, s, pad, dtype) in enumerate(edges):
        _, dz, pads = _grad_case(shape, k, s, pad, torch.float32, 770 + j)
        w = torch.randn((k, k, shape[3]), device="cuda") * 0.2
        err, abs_err = check_dx(name, dz, w, shape, s, pads, dtype)
        worst = max(worst, err)
        if dtype == torch.float32:
            worst_abs = max(worst_abs, abs_err)
    # contiguous but only 4-byte aligned: the kernel's scalar path
    flat = torch.randn(1 + 19 * 19 * 48, device="cuda")
    w = torch.randn(3, 3, 48, device="cuda") * 0.2
    err, abs_err = check_dx("unaligned base", flat[1:].view(1, 19, 19, 48),
                            w, (1, 19, 19, 48), 1, (1, 1, 1, 1),
                            torch.float32)
    worst, worst_abs = max(worst, err), max(worst_abs, abs_err)
    emit(phase="dx", batch=TRAIN_BATCH, rows=len(shapes),
         stages=sum(shapes.values()), max_rel_err=worst,
         max_abs_err=worst_abs, bitwise=True, **tot)
    return dict(max_rel_err=worst, max_abs_err=worst_abs, **tot)


def _bound(nbytes: float, ops: float, flop_per_s: float):
    """(bound ms, "bytes" or "operations")."""
    b_ms = nbytes / MEM_BYTES_PER_S * 1e3
    o_ms = ops / flop_per_s * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def phase_depthwise_bf16(shapes: Counter) -> dict:
    """The three depthwise kernels' bf16 instantiations (the ``--amp``
    path's) at every flagship shape: the forward at batch 3 (a train step)
    and 1 (inference), dx and dw at batch 3, each against its plain version
    on the same inputs (y and dx within one bf16 rounding, dw, an f32 sum,
    within GRAD_TOL of its max), two calls bitwise equal, and dw from bf16 x
    bitwise the dw from x widened to f32 (the JAX backward widens x first);
    device times of kernel, plain version and library (cuDNN in bf16: x,
    weights and, for dx and dw, dz in bf16) beside the bound (x, y and dx
    two bytes an element, dz and dw four).  Returns the count-weighted sums
    and the largest errors."""
    bf16 = torch.bfloat16
    tot = {key: Counter() for key in ("fwd_b3", "fwd_b1", "dx", "dwgrad")}
    errs = Counter()

    def add(key, count, **row):
        for name, v in row.items():
            if isinstance(v, float):
                tot[key][name] += count * v

    for i, ((h, c, k, s), count) in enumerate(sorted(shapes.items())):
        p = ((s - 1) + (k - 1)) // 2
        for batch in (TRAIN_BATCH, MAIN_BATCH):
            x, w, scale, bias = _case((batch, h, h, c), k, bf16,
                                      1100 + 10 * i + batch)
            err = check(f"bf16 b{batch} {h}x{h}x{c} k{k} s{s}", x, w, scale,
                        bias, s, "", "silu", BF16_TOL)
            errs["fwd"] = max(errs["fwd"], err)
            xc = x.permute(0, 3, 1, 2)
            w_lib = (w * scale).permute(2, 0, 1).unsqueeze(1).to(
                bf16).contiguous()
            b_lib = bias.to(bf16)
            bound, by = _bound(*stage_cost(batch, h, c, k, s, 2),
                               F32_FLOP_PER_S)
            row = dict(
                ms=device_ms(lambda: dw.fused_depthwise(
                    x, w, scale, bias, s, "", "silu")),
                plain_ms=device_ms(lambda: dw.fused_depthwise_reference(
                    x, w, scale, bias, s, "", "silu")),
                library_ms=device_ms(lambda: F.silu(F.conv2d(
                    xc, w_lib, b_lib, s, p, 1, c))),
                bound_ms=bound)
            emit(phase="kernel_row_bf16", kernel="depthwise_fwd", h=h, c=c,
                 k=k, stride=s, count=count, batch=batch, max_abs_err=err,
                 bound_by=by, bound_share=bound / row["ms"], **row)
            add(f"fwd_b{batch}", count, **row)
        x, dz, pads = _grad_case((TRAIN_BATCH, h, h, c), k, s, "", bf16,
                                 1200 + i)
        w = torch.randn((k, k, c), device="cuda") * 0.2
        shape = tuple(x.shape)
        rel, abs_err = check_dx(f"bf16 dx {h}x{h}x{c} k{k} s{s}", dz, w,
                                shape, s, pads, bf16)
        errs["dx"] = max(errs["dx"], abs_err)
        errs["dx_rel"] = max(errs["dx_rel"], rel)
        errs["dwgrad"] = max(errs["dwgrad"], check_dwgrad(
            f"bf16 x dw {h}x{h}x{c} k{k} s{s}", x, dz, k, s, pads))
        if not torch.equal(dw.depthwise_dwgrad(x, dz, k, s, pads),
                           dw.depthwise_dwgrad(x.float(), dz, k, s, pads)):
            raise AssertionError(f"{h}x{h}x{c} k{k} s{s}: dw of bf16 x is "
                                 f"not the dw of x widened to f32")
        w_lib = w.permute(2, 0, 1).unsqueeze(1).to(bf16).contiguous()
        xc, dzc = x.permute(0, 3, 1, 2), dz.to(bf16).permute(0, 3, 1, 2)
        for key, fn, plain, lib, nbytes in (
                ("dx", lambda: dw.depthwise_dx(dz, w, shape, s, pads, bf16),
                 lambda: dw.depthwise_dx_reference(dz, w, shape, s, pads,
                                                   bf16),
                 lambda: torch.nn.grad.conv2d_input(
                     (TRAIN_BATCH, c, h, h), w_lib, dzc, s, pads[0], 1, c),
                 dz.numel() * 4 + x.numel() * 2 + k * k * c * 4),
                ("dwgrad", lambda: dw.depthwise_dwgrad(x, dz, k, s, pads),
                 lambda: dw.depthwise_dwgrad_reference(x, dz, k, s, pads),
                 lambda: torch.nn.grad.conv2d_weight(
                     xc, (c, 1, k, k), dzc, s, pads[0], 1, c),
                 x.numel() * 2 + dz.numel() * 4 + k * k * c * 4)):
            bound, by = _bound(nbytes, 2 * k * k * dz.numel(),
                               F32_FLOP_PER_S)
            row = dict(ms=device_ms(fn), plain_ms=device_ms(plain),
                       library_ms=device_ms(lib), bound_ms=bound)
            emit(phase="kernel_row_bf16", kernel=f"depthwise_{key}", h=h,
                 c=c, k=k, stride=s, count=count, batch=TRAIN_BATCH,
                 bound_by=by, bound_share=bound / row["ms"], **row)
            add(key, count, **row)
    out = {key: dict(v) for key, v in tot.items()}
    emit(phase="depthwise_bf16", rows=len(shapes),
         stages=sum(shapes.values()), max_abs_err=dict(errs),
         bitwise=True, dw_of_bf16_x_is_dw_of_widened_x=True,
         tol=dict(y=BF16_TOL, dx=BF16_GRAD_TOL, dw=GRAD_TOL), **out)
    return dict(errs=dict(errs), **out)


def phase_backward(shapes: Counter) -> dict:
    """The forward with a gradient wanted and the full backward against the
    plain version at every flagship shape at the training batch, identity
    and affine + SiLU epilogues, and at paddings beyond k-1; returns the
    gradients' largest relative error and the forward's max absolute
    error."""
    worst = y_worst = 0.0
    for i, ((h, c, k, s), count) in enumerate(sorted(shapes.items())):
        shape = (TRAIN_BATCH, h, h, c)
        y_err = row_err = 0.0
        for affine in (False, True):
            ye, ge = check_backward(
                f"{h}x{h}x{c} k{k} s{s} {'affine+silu' if affine else 'id'}",
                shape, k, s, "", affine, torch.float32, 700 + 2 * i)
            y_err, row_err = max(y_err, ye), max(row_err, ge)
        worst, y_worst = max(worst, row_err), max(y_worst, y_err)
        emit(phase="backward_row", h=h, c=c, k=k, stride=s, count=count,
             batch=TRAIN_BATCH, max_rel_err=row_err, y_max_abs_err=y_err)
    worst = max(worst, check_backward("bf16 x k3 s2 same", (3, 40, 40, 64), 3,
                                      2, "same", True, torch.bfloat16,
                                      790)[1])
    ye, ge = check_backward("C=13 odd H/W k5 s2 int pad", (3, 31, 45, 13), 5,
                            2, 1, True, torch.float32, 792)
    worst, y_worst = max(worst, ge), max(y_worst, ye)
    # padding beyond k-1 (k and k+1 a side): dx at x's size with no crop
    for j, (name, shape, kk, s, pad, affine) in enumerate([
            ("padding k at k=3", (3, 17, 17, 24), 3, 1, 3, True),
            ("padding k+1 at k=5, stride 2", (3, 19, 21, 24), 5, 2, 6,
             False)]):
        ye, ge = check_backward(name, shape, kk, s, pad, affine,
                                torch.float32, 796 + 2 * j)
        worst, y_worst = max(worst, ge), max(y_worst, ye)
    emit(phase="backward", batch=TRAIN_BATCH, rows=len(shapes),
         max_rel_err=worst, y_max_abs_err=y_worst)
    return dict(max_rel_err=worst, y_max_abs_err=y_worst)


def _frames(rng):
    """Seeded uint8 frames of mixed aspect ratios: smooth content + noise."""
    out = []
    for i, (h, w) in enumerate([(720, 1280), (1080, 1920), (480, 360),
                                (600, 600), (1000, 750), (256, 320),
                                (900, 1600), (640, 480)]):
        yy, xx = np.mgrid[0:h, 0:w]
        base = 127 + 100 * np.sin(xx[..., None] / (40 + 7 * i)
                                  + yy[..., None] / 53 + np.arange(3) * i)
        out.append(np.clip(base + rng.normal(0, 20, (h, w, 3)), 0,
                           255).astype(np.uint8))
    return out


def phase_main_path(device: str = "cuda", size: int = 600):
    """The inference path; returns its forward-kernel launches, the frame
    files it scored and the card's P(fake) of them (``single``, ``clip``)."""
    OUT.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    files = []
    for i, img in enumerate(_frames(rng)):
        path = OUT / f"frame{i}.npy"
        np.save(path, img)
        files.append(str(path))
    # seeded flagship; BN calibrated by one train-mode pass over the inputs
    # it will score, single and clip (running := the batch's), on the card
    # (TF32 off): the pass only makes the checkpoint that every path below
    # then scores on the card and on the CPU alike.  At the scoring canvas:
    # stats from a small canvas do not fit 600² activations, and the logits
    # then saturate P(fake) at 0 or 1, where any two paths agree.
    t0 = time.perf_counter()
    model = create_deepfake_model_v4(bn_momentum=1.0, device="cpu", seed=0)
    calib = np.concatenate(
        [runner.preprocess(f, size) for f in files]
        + [runner.preprocess_clip(files[i:i + 4], size)
           for i in range(0, len(files), 4)])
    model.to(device).train()
    with torch.no_grad():
        model(torch.from_numpy(calib).to(device).permute(0, 3, 1, 2))
    ckpt = OUT / "flagship.pth"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    emit(phase="calibrate", s=time.perf_counter() - t0,
         calib_batch=list(calib.shape))
    del model, calib

    launches = 0
    results = {}
    for clip in (False, True):
        forwards = len(files) // (4 if clip else 1)
        dw.fused_depthwise.launches = 0
        t0 = time.perf_counter()
        gpu = np.asarray(runner.test_img(str(ckpt), files, size=size,
                                         clip=clip, device=device))
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        counted = dw.fused_depthwise.launches
        if counted != 55 * forwards:
            raise AssertionError(f"clip={clip}: {counted} depthwise launches "
                                 f"for {forwards} forwards, expected "
                                 f"{55 * forwards}")
        launches += counted
        t0 = time.perf_counter()
        cpu = np.asarray(runner.test_img(str(ckpt), files, size=size,
                                         clip=clip, device="cpu"))
        cpu_s = time.perf_counter() - t0
        diff = float(np.abs(gpu - cpu).max())
        if not np.all(np.isfinite(gpu)) or gpu.shape != (forwards,):
            raise AssertionError(f"clip={clip}: bad scores {gpu}")
        if np.abs(gpu - 0.5).max() <= 1e-3:
            raise AssertionError(f"clip={clip}: degenerate scores {gpu}")
        if diff > SCORE_TOL:
            raise AssertionError(f"clip={clip}: card vs CPU P(fake) differ "
                                 f"by {diff:.3e} > {SCORE_TOL}")
        results["clip" if clip else "single"] = gpu.tolist()
        results["cpu_clip" if clip else "cpu_single"] = cpu.tolist()
        emit(phase="main_path", clip=clip, forwards=forwards,
             launches=counted, p_fake_gpu=gpu.tolist(),
             p_fake_cpu=cpu.tolist(), max_abs_diff=diff, tol=SCORE_TOL,
             gpu_s=gpu_s, cpu_s=cpu_s)

    model = create_deepfake_model_v4(device=device, seed=0)
    model.load_state_dict(torch.load(ckpt, weights_only=True))
    for batch in (1, 8):
        x = torch.randn(batch, 12, size, size, device=device).contiguous(
            memory_format=torch.channels_last)
        with torch.inference_mode():
            for _ in range(2):
                model(x)
            torch.cuda.synchronize()
            iters = 10
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        emit(phase="throughput", batch=batch, clips_per_s=batch * iters / dt,
             ms_per_clip=dt / (batch * iters) * 1e3,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    phase_profile(model, x)
    return launches, files, results


# ---------------------------------------------------------------------------
# the serving replica (runners/serve.py): captured CUDA graphs per bucket
# ---------------------------------------------------------------------------

SERVE_BUCKETS = (1, 4, 16)        # the JAX default's first three
SERVE_BIG_BUCKET = 64             # the JAX default's largest, captured alone
SERVE_TOL = 1e-6                  # P(fake), server against the card CLI
SERVE_CLIENTS = (1, 32)           # the 8-client level cut for time
SERVE_LOAD_S = 1.5                # short: the script runs within 1,200 s
SERVE_WATCHDOG_S = 5.0
SERVE_ADD_LOAD_S = 3.0            # load while a model is added (8, then 4,
                                  # before the cuts for time; the add
                                  # takes ~2 s)
STUDENT = "student=efficientnet_deepfake_v4"    # at half the canvas
# the CLI's eager numbers these stand beside (PERF.md §5, NVIDIA H100 80GB
# HBM3, 700 W)
CLI_CLIPS_PER_S = {"batch_1": 17.40, "batch_8": 114.67}


def _npy_bytes(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _multipart(blobs) -> tuple:
    body = b"".join(b"--clip\r\nContent-Type: application/octet-stream"
                    b"\r\n\r\n" + b + b"\r\n" for b in blobs) + b"--clip--\r\n"
    return body, "multipart/form-data; boundary=clip"


def _http(port: int, method: str, path: str, body: bytes = b"",
          ctype: str = "application/octet-stream", timeout: float = 60.0,
          headers: dict = None):
    """(status, parsed JSON or text) of one request to the local server;
    ``headers``, where given, in place of the Content-Type alone."""
    if headers is None:
        headers = {"Content-Type": ctype} if body else {}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body or None, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    text = data.decode()
    try:
        return resp.status, json.loads(text)
    except ValueError:
        return resp.status, text


# the load generator: a child interpreter (stdlib only), so that its
# threads do not take the server's interpreter lock
_LOAD_CLIENTS = r"""
import http.client, json, sys, threading, time
port, clients, seconds = int(sys.argv[1]), int(sys.argv[2]), float(sys.argv[3])
body, ctype = open(sys.argv[4], "rb").read(), sys.argv[5]
lat, statuses, stages, lock = [], {}, {}, threading.Lock()
stop_at = time.perf_counter() + seconds

def client():
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    while time.perf_counter() < stop_at:
        t0 = time.perf_counter()
        conn.request("POST", "/score", body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        out = resp.read()
        dt = time.perf_counter() - t0
        with lock:
            statuses[resp.status] = statuses.get(resp.status, 0) + 1
            if resp.status == 200:
                lat.append(dt)
                for k, v in json.loads(out)["timings_ms"].items():
                    stages[k] = stages.get(k, 0.0) + v
        if resp.status != 200:
            time.sleep(min(1.0, float(resp.getheader("Retry-After") or 1)))
    conn.close()

t0 = time.perf_counter()
threads = [threading.Thread(target=client) for _ in range(clients)]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps(dict(lat=lat, statuses=statuses, stages=stages,
                      wall=time.perf_counter() - t0)))
"""


def _load(port: int, body: bytes, ctype: str, clients: int,
          seconds: float) -> dict:
    """``clients`` threads of a child interpreter posting ``body`` back to
    back on keep-alive connections for ``seconds`` (after a non-200 a
    client waits what its ``Retry-After`` says, at most 1 s): clips/s,
    latency percentiles and the server's mean stage ms (its ``timings_ms``:
    preprocess, queue, device, total) of the 200s, and the count of each
    status."""
    path = OUT / f"serve_body_{threading.get_ident()}.bin"
    path.write_bytes(body)
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD_CLIENTS, str(port), str(clients),
         str(seconds), str(path), ctype], capture_output=True, text=True,
        timeout=seconds + 300)
    if proc.returncode != 0:
        raise AssertionError(f"load clients failed: {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    ms = np.asarray(got["lat"]) * 1e3
    return dict(clients=clients, seconds=got["wall"],
                clips_per_s=len(ms) / got["wall"],
                p50_ms=float(np.percentile(ms, 50)) if len(ms) else None,
                p99_ms=float(np.percentile(ms, 99)) if len(ms) else None,
                stage_ms={k: v / max(1, len(ms))
                          for k, v in got["stages"].items()},
                statuses=dict(sorted(got["statuses"].items())))


def _bucket_rows(port: int) -> Counter:
    """``dfd_serving_bucket_rows_total`` from ``/metrics``: rows by
    (model, bucket, real|pad)."""
    _, text = _http(port, "GET", "/metrics")
    out = Counter()
    for m in re.finditer(r'^dfd_serving_bucket_rows_total\{model="([^"]+)",'
                         r'bucket="(\d+)",kind="(\w+)"\} (\d+)', text, re.M):
        out[(m[1], int(m[2]), m[3])] += int(m[4])
    return out


def _histogram(before: Counter, after: Counter) -> dict:
    """Batches and real rows per bucket between two ``_bucket_rows``
    readings (each batch of bucket b adds b rows, real plus pad)."""
    out = {}
    for b in sorted({k[1] for k in after}):
        real = sum(after[k] - before[k] for k in after
                   if k[1] == b and k[2] == "real")
        pad = sum(after[k] - before[k] for k in after
                  if k[1] == b and k[2] == "pad")
        if real + pad:
            out[str(b)] = dict(batches=(real + pad) // b, real_rows=real,
                               mean_real_rows=real * b / (real + pad))
    return out


def _serve_server(ckpt_path: Path, wire: str, size: int, device: str, **kw):
    cfg = ServeConfig(model_path=str(ckpt_path), port=0, wire=wire,
                      buckets=SERVE_BUCKETS, device=device, image_size=size,
                      watchdog_timeout_s=SERVE_WATCHDOG_S, **kw)
    srv = serve_runner.build_server(cfg)
    srv.engine.start(srv.batcher)
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.1},
                     daemon=True, name=f"serve-{wire}").start()
    return srv


def _close_server(srv) -> None:
    srv.shutdown()
    srv.engine.stop()
    srv.batcher.close()
    srv.server_close()


def _profile_kernels(fn, iters: int = 1):
    """(busy device ms per call, Counter of kernel names) of ``iters``
    calls of ``fn`` under torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = Counter()
    busy = 0.0
    for e in _device_events(prof):
        names[e.key] += e.count
        busy += e.self_device_time_total
    return busy / iters / 1e3, names


def _peak_gib(base: int) -> float:
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def _replay_kernels(eng, tries: int = 3) -> dict:
    """One bucket-4 replay of ``eng``'s single-frame program, profiled:
    its depthwise forward kernels, all its kernels, its busy ms.  A replay
    runs every node of its graph, so a trace that names fewer forward
    kernels than the graph holds has lost records: up to ``tries`` replays
    are traced until one names at least 55, and every count is kept
    (``traced_counts``)."""
    prog = eng.entry().compiled[(4, 3)]
    seen = []
    for _ in range(tries):
        with eng._device_lock, torch.cuda.stream(eng._stream):
            busy, names = _profile_kernels(prog.graph.replay)
        seen.append(sum(n for k, n in names.items() if "dw_fwd_kernel" in k))
        if seen[-1] >= 55:
            break
    return dict(depthwise_fwd_kernels=seen[-1], traced_counts=seen,
                kernels=sum(names.values()), busy_ms=busy,
                top=dict(names.most_common(6)))


def _batch1(fe) -> dict:
    """Wall and device (profiler busy) ms of one batch-1 forward of the
    float32 engine: its bucket-1 graph replayed against the same function
    run eagerly."""
    prog = fe.entry().compiled[(1, 12)]
    fn = fe._make_program(fe.entry(), 12)

    def replay():
        with torch.cuda.stream(fe._stream):
            prog.graph.replay()

    def eager():
        with torch.no_grad():
            fn(prog.x)

    with fe._device_lock:
        return dict(graph_wall_ms=_wall_ms(replay),
                    eager_wall_ms=_wall_ms(eager),
                    graph_device_ms=_profile_kernels(replay, 5)[0],
                    eager_device_ms=_profile_kernels(eager, 5)[0])


def _wall_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _perturbed_file(ckpt_path: Path, dst: Path, seed: int) -> None:
    """The checkpoint with every conv and linear weight scaled by 1 + 2 %
    noise, written to ``dst`` atomically (temporary name, rename)."""
    sd = torch.load(ckpt_path, weights_only=True)
    g = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        if k.endswith("weight") and v.dim() >= 2:
            sd[k] = v * (1 + 0.02 * torch.randn(v.shape, generator=g))
    tmp = dst.with_suffix(".tmp")
    torch.save(sd, tmp)
    os.replace(tmp, dst)


def _host_stage_ms(fn, iters: int = 10) -> dict:
    """Median and least wall ms of ``fn()`` on this thread, alone."""
    fn()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(ms_median=float(np.median(ms)), ms_min=float(min(ms)))


def _serve_jpeg(srv, size: int) -> dict:
    """The JPEG row of the uint8 server: the four 640² fixtures as one
    multipart clip, its scores bitwise those of the same frames decoded
    and sent as ``.npy``; then 32 clients for 2 s posting each body (the
    ``.npy`` one of the decoded frames beside it), and the host's ms a
    frame, on one idle thread, of the decode and of the 640² → ``size``
    canvas.  Returns the rows and the depthwise launches of the replays
    the JPEG requests alone caused."""
    port = srv.server_address[1]
    faces = [jpeg_bytes(n) for n in JPEG_FACES]
    decoded = [jpeg_native.decode_jpeg_bytes(b) for b in faces]
    bodies = {"jpeg": _multipart(faces),
              "npy": _multipart(_npy_bytes(d) for d in decoded)}
    host = dict(decode=_host_stage_ms(
        lambda: jpeg_native.decode_jpeg_bytes(faces[0])),
        canvas_640=_host_stage_ms(lambda: prepare_canvas(decoded[0], size)),
        canvas_600=_host_stage_ms(lambda: prepare_canvas(
            np.ascontiguousarray(decoded[0][:size, :size]), size)))

    launches = 0

    def counted(kind, fn):
        # the depthwise launches of the JPEG requests alone: the .npy
        # twins' replays stay with the serve path
        nonlocal launches
        before = srv.engine.launch_counts().get("depthwise_fwd", 0)
        out = fn()
        if kind == "jpeg":
            launches += srv.engine.launch_counts().get("depthwise_fwd", 0) \
                - before
        return out

    answers = {k: counted(k, lambda: _http(port, "POST", "/score", *b))
               for k, b in bodies.items()}
    bitwise = all(st == 200 for st, _ in answers.values()) and \
        answers["jpeg"][1]["scores"] == answers["npy"][1]["scores"]
    rows = {}
    for kind in ("npy", "jpeg"):
        before = _bucket_rows(port)
        row = counted(kind, lambda: _load(port, *bodies[kind],
                                          SERVE_CLIENTS[-1], SERVE_LOAD_S))
        row.update(wire="uint8", body_bytes=len(bodies[kind][0]),
                   buckets=_histogram(before, _bucket_rows(port)))
        rows[kind] = row
        if row["statuses"] != {"200": row["statuses"].get("200", 0)}:
            raise AssertionError(f"JPEG serve load: non-200 answers {row}")
    emit(phase="serve_jpeg", nvidia_smi=nvidia_smi_line(),
         fixtures=list(JPEG_FACES), scores_bitwise_npy_wire=bitwise,
         p_fake={k: a[1].get("fake_score") for k, a in answers.items()},
         jpeg=rows["jpeg"], npy=rows["npy"], launches=launches,
         host_ms_per_frame=host,
         body="4 frames at 640² (JPEG 4:2:0 q90, or their decodes as .npy),"
              " multipart")
    if not bitwise:
        raise AssertionError(f"JPEG clip scores {answers['jpeg']} are not "
                             f"the .npy wire's {answers['npy']}")
    return dict(rows=rows, launches=launches)


def phase_serve(ckpt_path: Path, files: list, cli: dict, size: int = 600,
                device: str = "cuda") -> dict:
    """The serving replica on the card: the calibrated flagship of
    ``phase_main_path`` behind ``runners.serve.build_server`` on the uint8
    and the float32 wire, buckets 1, 4, 16; captures, the kernel inside a
    replay, parity with the card CLI, speed under load, resilience and a
    model added live.  Returns the engines' replay launch counts."""
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(0.002)            # as runners/serve.py's main
    reload_dir = OUT / "serve_reload"
    shutil.rmtree(reload_dir, ignore_errors=True)
    reload_dir.mkdir(parents=True)
    caps0 = capture_count()

    # 1. captures, and the peak memory of warmup
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    u8 = _serve_server(ckpt_path, "uint8", size, device,
                       reload_dir=str(reload_dir), reload_interval_s=0.2)
    u8_s = time.perf_counter() - t0
    u8_peak = _peak_gib(base_mem)
    eng = u8.engine
    want = 1 * len(SERVE_BUCKETS) * 2                 # widths 3 and 12
    if eng.compile_count != want or capture_count() - caps0 != want:
        raise AssertionError(f"uint8 server: {eng.compile_count} programs, "
                             f"{capture_count() - caps0} captures, expected "
                             f"{want}")
    t0 = time.perf_counter()
    f32 = _serve_server(ckpt_path, "float32", size, device)
    f32_s = time.perf_counter() - t0
    if f32.engine.compile_count != len(SERVE_BUCKETS):
        raise AssertionError(f"float32 server: {f32.engine.compile_count} "
                             f"programs")
    caps_ready = capture_count()
    emit(phase="serve_captures", uint8=dict(
        programs=eng.compile_count, expected=want, build_s=u8_s,
        peak_mem_gib_over_base=u8_peak,
        capture_s={f"{b}x{c}": s for (b, c), s in
                   eng.warm_compile_walls.items()}),
        float32=dict(programs=f32.engine.compile_count, build_s=f32_s),
        launches_per_capture={f"{b}x{c}": p.launches for (b, c), p in
                              eng.entry().compiled.items()})
    for (b, c), p in eng.entry().compiled.items():
        if p.launches.get("depthwise_fwd") != 55:
            raise AssertionError(f"bucket {b} ({c}ch): {p.launches} "
                                 f"launches captured, expected 55")

    # 2. the kernel inside the replay: one bucket-4 replay, profiled
    traced = _replay_kernels(eng)
    emit(phase="serve_replay_profile", bucket=4, chans=3, **traced)
    if traced["depthwise_fwd_kernels"] != 55:
        raise AssertionError(f"a profiled bucket-4 replay ran the depthwise "
                             f"forward kernel {traced['depthwise_fwd_kernels']}"
                             f" times, not 55")

    # 3. parity: the card CLI's P(fake) on the same .npy frames
    diffs, bitwise = {}, True
    for srv in (u8, f32):
        worst = 0.0
        port = srv.server_address[1]
        for i, f in enumerate(files):
            st, out = _http(port, "POST", "/score", Path(f).read_bytes())
            if st != 200:
                raise AssertionError(f"/score {f}: {st} {out}")
            d = abs(out["fake_score"] - cli["single"][i])
            worst, bitwise = max(worst, d), bitwise and d == 0.0
        for j in range(len(cli["clip"])):
            body, ctype = _multipart(Path(f).read_bytes()
                                     for f in files[4 * j:4 * j + 4])
            st, out = _http(port, "POST", "/score", body, ctype)
            if st != 200 or out["frames"] != 4:
                raise AssertionError(f"/score clip {j}: {st} {out}")
            d = abs(out["fake_score"] - cli["clip"][j])
            worst, bitwise = max(worst, d), bitwise and d == 0.0
        diffs[srv.engine.wire] = worst
    canv = [prepare_canvas(read_rgb(f), size) for f in files[:4]]
    padded = eng.score_batch(canv[:3])
    full = eng.score_batch(canv)
    pad_bitwise = bool(np.array_equal(padded, full[:3]))
    x = torch.from_numpy(np.stack(canv)).to(eng.device)
    fn = eng._make_program(eng.entry(), 3)
    plain_fwd = blocks.fused_depthwise
    blocks.fused_depthwise = dw.fused_depthwise_reference
    try:
        with torch.no_grad():
            plain = fn(x).cpu().numpy()
    finally:
        blocks.fused_depthwise = plain_fwd
    plain_diff = float(np.abs(full - plain).max())
    emit(phase="serve_parity", max_abs_diff_vs_cli=diffs, tol=SERVE_TOL,
         bitwise_vs_cli=bitwise, padded_rows_bitwise=pad_bitwise,
         graph_vs_plain_depthwise=plain_diff, plain_tol=SCORE_TOL)
    if max(diffs.values()) > SERVE_TOL or not pad_bitwise \
            or plain_diff > SCORE_TOL:
        raise AssertionError(f"serve parity: {diffs}, padded bitwise "
                             f"{pad_bitwise}, plain {plain_diff}")

    # 4. speed: batch 1, graph replay against the eager forward, then load
    batch1 = _batch1(f32.engine)
    rng = np.random.default_rng(7)
    clip = [np.clip(127 + 60 * rng.standard_normal((size, size, 3)), 0,
                    255).astype(np.uint8) for _ in range(4)]
    body, ctype = _multipart(_npy_bytes(c) for c in clip)
    loads = []
    for srv, levels in ((u8, SERVE_CLIENTS), (f32, SERVE_CLIENTS[-1:])):
        port = srv.server_address[1]
        for clients in levels:
            before = _bucket_rows(port)
            row = _load(port, body, ctype, clients, SERVE_LOAD_S)
            row.update(wire=srv.engine.wire,
                       buckets=_histogram(before, _bucket_rows(port)))
            loads.append(row)
            if row["statuses"] != {"200": row["statuses"].get("200", 0)}:
                raise AssertionError(f"load: non-200 answers {row}")
    emit(phase="serve_speed", nvidia_smi=nvidia_smi_line(),
         batch_1=batch1, load=loads, cli_clips_per_s=CLI_CLIPS_PER_S,
         body="4 .npy frames at 600², multipart")
    jpeg = _serve_jpeg(u8, size)

    # 5. resilience: NaN batch, hang, reload, torn reload
    port = u8.server_address[1]
    one = _npy_bytes(read_rgb(files[3]))
    m = eng.metrics
    eng.chaos = ChaosInjector(f"serve_nan@{eng._batch_seq}")
    nan_status = _http(port, "POST", "/score", one)[0]
    after_nan = _http(port, "POST", "/score", one)[0]
    progs, rewarms = eng.compile_count, m.rewarms_total.value
    eng.chaos = ChaosInjector(f"serve_hang@{eng._batch_seq}:"
                              f"{SERVE_WATCHDOG_S + 3}")
    t0 = time.perf_counter()
    hang_status = _http(port, "POST", "/score", one)[0]
    deadline = time.monotonic() + 120
    while not eng.ready and time.monotonic() < deadline:
        time.sleep(0.05)
    recovered_s = time.perf_counter() - t0
    after_hang = _http(port, "POST", "/score", one)[0]
    eng.chaos = ChaosInjector("")
    if (nan_status, after_nan, hang_status, after_hang) != (503, 200, 503,
                                                            200) \
            or m.rewarms_total.value != rewarms + 1 \
            or eng.compile_count != progs or capture_count() != caps_ready:
        raise AssertionError(
            f"faults: nan {nan_status}/{after_nan}, hang {hang_status}/"
            f"{after_hang}, rewarms {m.rewarms_total.value - rewarms}, "
            f"programs {eng.compile_count - progs}, captures "
            f"{capture_count() - caps_ready}")
    canvas = prepare_canvas(read_rgb(files[3]), size)
    before = eng.score_batch([canvas])
    _perturbed_file(ckpt_path, reload_dir / "next.pth", seed=1)
    deadline = time.monotonic() + 120
    while eng.reload_count < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    if eng.reload_count != 1:
        raise AssertionError("the reload watcher never swapped the weights")
    reloaded = eng.score_batch([canvas])
    eager_new = eng._eager_scores(eng.entry(), eng.entry().candidate, 3,
                                  canvas[None])
    reload_diff = float(np.abs(reloaded - eager_new).max())
    errors = m.reload_errors_total.value
    good = OUT / "serve_next2.pth"
    _perturbed_file(ckpt_path, good, seed=2)
    torn = Path(torn_copy(str(good), str(OUT)))
    os.replace(torn, reload_dir / "torn.pth")
    while m.reload_errors_total.value == errors and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    torn_bitwise = bool(np.array_equal(eng.score_batch([canvas]), reloaded))
    emit(phase="serve_resilience", nan=[nan_status, after_nan],
         hang=[hang_status, after_hang], hang_recovered_s=recovered_s,
         rewarms=m.rewarms_total.value - rewarms,
         programs_added=eng.compile_count - progs,
         captures_added=capture_count() - caps_ready,
         reload_applied=eng.reload_count,
         reload_moved=float(np.abs(reloaded - before).max()),
         reload_vs_eager_new=reload_diff, torn_rejected=m.reload_errors_total
         .value - errors, torn_bitwise=torn_bitwise)
    if reload_diff > SERVE_TOL or not torn_bitwise or \
            m.reload_errors_total.value != errors + 1 or \
            float(np.abs(reloaded - before).max()) == 0.0:
        raise AssertionError("reload / torn reload contract broken")

    # 6. a second model added live, under load, then a cascade run
    spec = parse_model_spec(f"{STUDENT},size={size // 2}",
                            default_size=size, default_img_num=4)
    student = serve_runner.build_model(
        spec["family"], str(ckpt_path), num_classes=2, in_chans=12,
        image_size=spec["size"], use_ema=False, name=spec["id"],
        device=device)
    restarts, failed = m.worker_restarts_total.value, m.failed_total.value
    ready_seen, add_err = set(), []

    def add():
        try:
            eng.add_model(spec["id"], student, image_size=spec["size"])
            eng.warmup()
        except Exception as e:                     # noqa: BLE001
            add_err.append(repr(e))

    def load_during_add():
        try:
            loads.append(dict(_load(port, body, ctype, 8, SERVE_ADD_LOAD_S),
                              wire="uint8", during="add_model"))
        except Exception as e:                     # noqa: BLE001
            add_err.append(f"load: {e!r}")

    adder = threading.Thread(target=add, name="serve-add")
    loader = threading.Thread(target=load_during_add, name="serve-load")
    loader.start()
    time.sleep(1.0)
    adder.start()
    while adder.is_alive():
        ready_seen.add(_http(port, "GET", "/readyz")[0])
        time.sleep(0.05)
    adder.join()
    loader.join(timeout=200)
    ready_seen.add(_http(port, "GET", "/readyz")[0])
    u8.cascade = CascadeRouter(u8.batcher, m, student_id=spec["id"],
                               flagship_id=eng.default_model_id, low=0.2,
                               high=0.8, timeout_s=10.0)
    tiers = Counter()
    for f in files:
        st, out = _http(port, "POST", "/score", Path(f).read_bytes())
        tiers[out["cascade"]["tier"] if st == 200 else st] += 1
    books = (m.cascade_triaged_total.value, m.cascade_cleared_total.value,
             m.cascade_escalated_total.value,
             m.cascade_flagship_scored_total.value,
             m.cascade_escalation_failed_total.value)
    want = 2 * len(SERVE_BUCKETS) * 2
    emit(phase="serve_live_add", error=add_err, readyz_seen=sorted(
        ready_seen), programs=eng.compile_count, expected=want,
         load_during=loads[-1], worker_restarts=m.worker_restarts_total
         .value - restarts, failed=m.failed_total.value - failed,
         cascade_tiers=dict(tiers), cascade_books=books)
    if add_err or eng.compile_count != want or 503 not in ready_seen \
            or _http(port, "GET", "/readyz")[0] != 200 \
            or m.worker_restarts_total.value != restarts \
            or m.failed_total.value != failed \
            or books[0] != len(files) or books[0] != books[1] + books[2] \
            or books[2] != books[3] + books[4]:
        raise AssertionError("live add_model / cascade contract broken")
    if capture_count() != caps_ready + len(SERVE_BUCKETS) * 2:
        raise AssertionError("captures after ready beyond the added model's")

    launches = Counter()
    for srv in (u8, f32):
        launches.update(srv.engine.launch_counts())
        _close_server(srv)
    del u8, f32, eng, student
    gc.collect()
    torch.cuda.empty_cache()

    # bucket 64 alone: does the JAX default's largest bucket fit?
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    model = serve_runner.build_model(
        "efficientnet_deepfake_v4", str(ckpt_path), num_classes=2,
        in_chans=12, image_size=size, use_ema=False, name="b64",
        device=device)
    t0 = time.perf_counter()
    big = InferenceEngine(model, image_size=size,
                          buckets=(SERVE_BIG_BUCKET,),
                          watchdog_timeout_s=0.0, model_id="b64")
    big_s = time.perf_counter() - t0
    scores = big.score_batch([normalize_replicate(canvas, 4)]
                             * SERVE_BIG_BUCKET)
    big_peak = _peak_gib(base_mem)
    launches.update(big.launch_counts())
    emit(phase="serve_bucket_64", peak_mem_gib_over_base=big_peak,
         capture_s=big_s, finite=bool(np.isfinite(scores).all()),
         card_mem_gib=torch.cuda.get_device_properties(0).total_memory
         / 2 ** 30)
    big.stop()
    del big, model
    gc.collect()
    torch.cuda.empty_cache()
    sys.setswitchinterval(old_switch)
    emit(phase="serve", replay_launches=dict(launches),
         captures=capture_count() - caps0, jpeg_launches=jpeg["launches"])
    return dict(launches=launches["depthwise_fwd"] - jpeg["launches"],
                jpeg_launches=jpeg["launches"], peak_gib=u8_peak,
                big_peak_gib=big_peak)


# ---------------------------------------------------------------------------
# weight-only PTQ (serving/quant.py) in the server's captured graphs
# ---------------------------------------------------------------------------

QUANT_DTYPES = ("f32", "bf16", "int8")
# P(fake) drift from the card's f32 scores: the JAX package's bounds
# (tests/test_serving_quant.py, SERVE_BENCH.md)
QUANT_DRIFT = {"bf16": 0.02, "int8": 0.06}
QUANT_CPU_FRAMES = 1              # frames the bf16/int8 CPU runs score


def _nan_kernels_file(ckpt_path: Path, dst: Path) -> None:
    """The checkpoint with output channel 0 of every conv kernel NaN (the
    biases, BN and the classifier finite), written atomically."""
    sd = torch.load(ckpt_path, weights_only=True)
    for k, v in sd.items():
        if flax_leaf(k) == "kernel" and v.dim() == 4:
            v[0] = float("nan")
    tmp = dst.with_suffix(".tmp")
    torch.save(sd, tmp)
    os.replace(tmp, dst)


def _replay_ms(eng, bucket: int, chans: int) -> dict:
    """Wall (host clock around 20 replays) and device (profiler busy) ms of
    one replay of ``eng``'s (bucket, chans) graph."""
    prog = eng.entry().compiled[(bucket, chans)]

    def replay():
        with torch.cuda.stream(eng._stream):
            prog.graph.replay()

    with eng._device_lock:
        return dict(wall_ms=_wall_ms(replay),
                    device_ms=_profile_kernels(replay, 5)[0])


def phase_quant(ckpt_path: Path, files: list, cli: dict, size: int = 600,
                device: str = "cuda") -> dict:
    """The calibrated flagship of ``phase_main_path`` served through
    ``runners.serve.build_engine`` on the uint8 wire, buckets 1/4/16, at
    f32, bf16 and int8: captures, the depthwise kernel inside a replay,
    scores against the port's CPU run and the card's f32, batch-1 replay
    ms, resident weight bytes and peak memory, a quantized reload through
    the canary, a NaN-kernel checkpoint rejected; then ``runners.test
    --dtype int8`` on the card against an int8 engine's float32 wire.
    Returns the launches of the phase's replays and CLI forwards, and its
    rows."""
    canv = [prepare_canvas(read_rgb(f), size) for f in files]
    rows, launches, cold = {}, Counter(), {}
    card = {}
    for dtype in QUANT_DTYPES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        caps0 = capture_count()
        t0 = time.perf_counter()
        eng, batcher, _ = serve_runner.build_engine(ServeConfig(
            model_path=str(ckpt_path), wire="uint8", buckets=SERVE_BUCKETS,
            device=device, image_size=size, dtype=dtype,
            watchdog_timeout_s=0.0))
        ready_s = time.perf_counter() - t0
        peak = _peak_gib(base)
        entry = eng.entry()
        captures = capture_count() - caps0
        want = len(SERVE_BUCKETS) * 2                # widths 3 and 12
        bad = {f"{b}x{c}": p.launches for (b, c), p in entry.compiled.items()
               if p.launches.get("depthwise_fwd") != 55}
        if eng.compile_count != want or captures != want or bad:
            raise AssertionError(f"{dtype}: {eng.compile_count} programs, "
                                 f"{captures} captures (expected {want}), "
                                 f"launches {bad}")
        traced = _replay_kernels(eng)
        if traced["depthwise_fwd_kernels"] != 55:
            raise AssertionError(f"{dtype}: a profiled bucket-4 replay ran "
                                 f"{traced['depthwise_fwd_kernels']} "
                                 f"depthwise forward kernels, not 55")
        scores = np.concatenate([eng.score_batch(canv[i:i + 4])
                                 for i in range(0, len(canv), 4)])[:, 0]
        card[dtype] = scores
        if dtype == "f32":
            cpu = np.asarray(cli["cpu_single"])
        else:
            cpu = np.asarray(runner.test_img(
                str(ckpt_path), files[:QUANT_CPU_FRAMES], size=size,
                dtype=dtype, device="cpu"))
        vs_cpu = float(np.abs(scores[:len(cpu)] - cpu).max())
        drift = float(np.abs(scores - card["f32"]).max())
        b1 = _replay_ms(eng, 1, 3)
        # a perturbed checkpoint: quantized, through the canary, committed
        # into the resident store in place
        before = eng.score_batch(canv[3:4])
        nxt = OUT / f"quant_next_{dtype}.pth"
        _perturbed_file(ckpt_path, nxt, seed=3)
        eng.submit_reload(load_state_dict(str(nxt)), source=str(nxt))
        eng._maybe_apply_reload()
        reloaded = eng.score_batch(canv[3:4])
        eager = eng._eager_scores(entry, entry.candidate, 3, canv[3][None],
                                  entry.candidate_store)
        reload_diff = float(np.abs(reloaded - eager).max())
        # the reloaded graph against a fresh quantization of the same file
        # (the CLI at this dtype, batch 1 as the bucket-1 replay)
        n0 = dw.fused_depthwise.launches
        fresh = runner.test_img(str(nxt), files[3:4], size=size, dtype=dtype,
                                device=device)[0]
        launches["depthwise_fwd"] += dw.fused_depthwise.launches - n0
        fresh_diff = abs(float(reloaded[0, 0]) - fresh)
        nan_file = OUT / f"quant_nan_{dtype}.pth"
        _nan_kernels_file(ckpt_path, nan_file)
        errors = eng.metrics.reload_errors_total.value
        eng.submit_reload(load_state_dict(str(nan_file)), source="nan")
        eng._maybe_apply_reload()
        nan_rejected = eng.metrics.reload_errors_total.value - errors
        nan_bitwise = bool(np.array_equal(eng.score_batch(canv[3:4]),
                                          reloaded))
        rows[dtype] = dict(
            captures=captures, ready_s=ready_s,
            capture_s={f"{b}x{c}": s for (b, c), s in
                       eng.warm_compile_walls.items()},
            params_load_s=eng.metrics.warmup_seconds["params_load"],
            resident_weight_bytes=entry.resident_bytes(),
            peak_mem_gib_over_base=peak,
            replay_bucket4=dict(depthwise_fwd_kernels=traced[
                "depthwise_fwd_kernels"], kernels=traced["kernels"],
                busy_ms=traced["busy_ms"],
                traced_counts=traced["traced_counts"]),
            batch_1=b1, p_fake=scores.tolist(), max_abs_diff_vs_cpu=vs_cpu,
            cpu_tol=SCORE_TOL, drift_vs_f32=drift,
            drift_tol=QUANT_DRIFT.get(dtype, 0.0),
            reload_applied=eng.reload_count,
            reload_moved=float(np.abs(reloaded - before).max()),
            reload_vs_eager=reload_diff, reload_vs_fresh_cli=fresh_diff,
            nan_kernels_rejected=nan_rejected,
            nan_kernels_scores_bitwise=nan_bitwise,
            summary=quant_summary(entry.store) if entry.store else None)
        emit(phase="quant", dtype=dtype, nvidia_smi=nvidia_smi_line(),
             **rows[dtype])
        launches.update(eng.launch_counts())
        cold[dtype] = dict(ready_s=ready_s,
                           params_load_s=rows[dtype]["params_load_s"],
                           capture_s=rows[dtype]["capture_s"])
        if vs_cpu > SCORE_TOL or drift > QUANT_DRIFT.get(dtype, 0.0) \
                or (dtype != "f32" and drift == 0.0) \
                or eng.reload_count != 1 or reload_diff > SERVE_TOL \
                or fresh_diff > SERVE_TOL \
                or rows[dtype]["reload_moved"] == 0.0 \
                or nan_rejected != 1 or not nan_bitwise \
                or capture_count() != caps0 + captures:
            raise AssertionError(f"quant {dtype}: {rows[dtype]}")
        eng.stop()
        batcher.close()
        del eng, batcher, entry
    f32_resident = rows["f32"]["resident_weight_bytes"]
    for dtype in ("bf16", "int8"):
        if rows[dtype]["resident_weight_bytes"] >= f32_resident:
            raise AssertionError(f"{dtype} keeps {rows[dtype]} resident "
                                 f"bytes, f32 {f32_resident}")
    # the CLI at int8 on the card against an int8 engine's float32 wire
    gc.collect()
    torch.cuda.empty_cache()
    before = dw.fused_depthwise.launches
    cli_int8 = np.asarray(runner.test_img(str(ckpt_path), files, size=size,
                                          dtype="int8", device=device))
    launches["depthwise_fwd"] += dw.fused_depthwise.launches - before
    eng, batcher, _ = serve_runner.build_engine(ServeConfig(
        model_path=str(ckpt_path), wire="float32", buckets=(1,),
        device=device, image_size=size, dtype="int8",
        watchdog_timeout_s=0.0))
    wire = np.asarray([eng.score_batch([normalize_replicate(c, 4)])[0, 0]
                       for c in canv])
    launches.update(eng.launch_counts())
    eng.stop()
    batcher.close()
    del eng, batcher
    cli_diff = float(np.abs(cli_int8 - wire).max())
    emit(phase="quant_cli", dtype="int8", max_abs_diff_vs_engine=cli_diff,
         bitwise=bool(cli_diff == 0.0), tol=SERVE_TOL,
         p_fake_cli=cli_int8.tolist())
    if cli_diff > SERVE_TOL:
        raise AssertionError(f"runners.test --dtype int8 vs the engine's "
                             f"float32 wire: {cli_diff:.3e}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches["depthwise_fwd"], rows=rows, cold=cold)


# ---------------------------------------------------------------------------
# the corpus backfill runner (runners/backfill.py): one captured graph
# ---------------------------------------------------------------------------

BACKFILL_CLIPS = 192              # four-frame clips at 600²
BACKFILL_DUPS = 8                 # of them copies of earlier clips
BACKFILL_SHARD = 32               # clips a manifest shard
BACKFILL_BATCH = 16
BACKFILL_CLI_CLIPS = 4            # scored again by the card CLI
BACKFILL_TOL = 1e-6               # P(fake), backfill against the card CLI


def make_backfill_pack(root: Path, pack: Path, size: int = 600,
                       seed: int = 0) -> list:
    """A seeded tree of ``BACKFILL_CLIPS`` four-frame clips of ``.npy``
    frames at ``size``² (the last ``BACKFILL_DUPS`` copies of earlier clips,
    byte for byte), packed by the port's ``write_pack``; the tree is removed
    but for the frames of the first ``BACKFILL_CLI_CLIPS`` fakes, whose
    paths it returns (the manifest's first clips)."""
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(pack, ignore_errors=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    bases = [np.clip(127 + 100 * np.sin(
        xx[..., None] / (30 + 5 * i) + yy[..., None] / (41 + 3 * i)
        + np.arange(3) * i) + rng.normal(0, 20, (size, size, 3)), 0,
        255).astype(np.uint8) for i in range(12)]
    n_fake = BACKFILL_CLIPS // 2
    names = {"fake": [], "real": []}
    unique = BACKFILL_CLIPS - BACKFILL_DUPS
    for i in range(BACKFILL_CLIPS):
        kind = "fake" if i < n_fake else "real"
        name = f"c{i}"
        d = root / kind / name
        d.mkdir(parents=True)
        if i >= unique:                    # a duplicate of an earlier clip
            src = i - unique + 3
            src_dir = root / ("fake" if src < n_fake else "real") / f"c{src}"
            for f in src_dir.iterdir():
                shutil.copyfile(f, d / f.name)
        else:
            for t in range(4):
                b = bases[(i + t) % len(bases)]
                shift = (int(rng.integers(0, size)), int(rng.integers(0, size)))
                frame = np.roll(b, shift, axis=(0, 1))
                if (i + t) % 2:
                    frame = frame[:, ::-1]
                np.save(d / f"{t}.npy", np.ascontiguousarray(frame))
        names[kind].append(name)
    for kind, clips in names.items():
        (root / f"{kind}_list.txt").write_text(
            "".join(f"{c}:4\n" for c in clips))
    t0 = time.perf_counter()
    write_pack(str(root), str(pack), image_size=0, frames_per_clip=4,
               shard_size=64, workers=8)
    pack_s = time.perf_counter() - t0
    keep = OUT / "backfill_cli"
    shutil.rmtree(keep, ignore_errors=True)
    keep.mkdir(parents=True)
    cli_files = []
    for i in range(BACKFILL_CLI_CLIPS):
        for t in range(4):
            dst = keep / f"c{i}_{t}.npy"
            shutil.copyfile(root / "fake" / f"c{i}" / f"{t}.npy", dst)
            cli_files.append(str(dst))
    shutil.rmtree(root)
    return cli_files, pack_s


def phase_backfill(ckpt_path: Path, size: int = 600,
                   device: str = "cuda") -> dict:
    """The corpus backfill runner on the card: a seeded pack of
    ``BACKFILL_CLIPS`` four-frame clips at 600² with ``BACKFILL_DUPS``
    duplicates, the calibrated flagship at batch 16 with ``--dedup``: run 1
    to completion (clips/s, the device's busy share, one capture and none
    after warmup, 55 depthwise launches a replay, exact books); run 2
    stopped by SIGTERM after two shards (exit 75) and relaunched (exact
    books, verdicts bitwise run 1's); a few clips against the card CLI.
    Returns the launches of the replays and the numbers."""
    root, pack = OUT / "backfill_tree", OUT / "backfill_pack"
    cli_files, pack_s = make_backfill_pack(root, pack, size)
    manifest = build_manifest_from_pack(str(pack), BACKFILL_SHARD)
    mpath = OUT / "backfill_manifest.json"
    save_manifest(str(mpath), manifest)
    pack_bytes = sum(f.stat().st_size for f in pack.iterdir())
    emit(phase="backfill_corpus", clips=manifest["num_clips"],
         shards=len(manifest["shards"]), pack_bytes=pack_bytes,
         pack_s=pack_s)
    dups = _build_dup_map(PackSource(str(pack)), manifest)
    if len(dups) != BACKFILL_DUPS:
        raise AssertionError(f"{len(dups)} duplicates in the pack, "
                             f"expected {BACKFILL_DUPS}")

    def argv(out: Path) -> list:
        return ["--manifest", str(mpath), "--data-packed", str(pack),
                "--out", str(out), "--model-path", str(ckpt_path),
                "--batch-size", str(BACKFILL_BATCH), "--dedup",
                "--workers", "8", "--device", device, "--worker-name", "w"]

    # run 1, to completion
    run1 = OUT / "backfill_run1"
    shutil.rmtree(run1, ignore_errors=True)
    caps0 = capture_count()
    t0 = time.perf_counter()
    s1 = run_backfill(BackfillConfig.from_args(argv(run1)))
    run1_s = time.perf_counter() - t0
    books = s1["books"]
    fwd = s1["launches"].get("depthwise_fwd", 0)
    captured = capture_count() - caps0
    # the device's busy share over the scoring window: the device time of
    # one replay with its copies (profiled), times the replays
    pipe_ms = _backfill_replay_ms(ckpt_path, manifest, pack, device)
    busy_share = pipe_ms * s1["replays"] / (s1["elapsed_s"] * 1e3) \
        if s1["elapsed_s"] else None
    row1 = dict(wall_s=run1_s, clips_per_s=s1["clips_per_s"],
                elapsed_s=s1["elapsed_s"], replays=s1["replays"],
                replay_with_copies_device_ms=pipe_ms,
                device_busy_share=busy_share,
                captures=s1["captures"],
                captures_after_warmup=s1["steady_recompiles"],
                launches=s1["launches"], capture_s=s1["capture_s"],
                load_s=s1["load_s"], dedup_s=s1["dedup_s"],
                ready_s=s1["ready_s"], books={k: books[k] for k in (
                    "manifest_clips", "scored", "failed", "skipped_dup",
                    "balanced")})
    emit(phase="backfill_run", run=1, nvidia_smi=nvidia_smi_line(),
         eager_batch_8_clips_per_s=CLI_CLIPS_PER_S["batch_8"], **row1)
    if not books["balanced"] or books["skipped_dup"] != BACKFILL_DUPS \
            or books["failed"] or s1["captures"] != 1 \
            or s1["steady_recompiles"] or captured != 1 \
            or fwd != 55 * s1["replays"] or s1["replays"] == 0:
        raise AssertionError(f"backfill run 1: {row1}")

    # run 2: SIGTERM at the first batch of the third shard, then relaunch
    run2 = OUT / "backfill_run2"
    shutil.rmtree(run2, ignore_errors=True)
    batches = sum(-(-sum(1 for c in sh["clips"] if (c[0], c[1], c[2])
                         not in dups) // BACKFILL_BATCH)
                  for sh in manifest["shards"][:2])
    os.environ["DFD_CHAOS"] = f"backfill_kill@{batches}"
    try:
        rc = backfill_runner.main(argv(run2))
    finally:
        del os.environ["DFD_CHAOS"]
    mid = collect_books(str(run2), manifest)
    rc2 = backfill_runner.main(argv(run2))
    books2 = collect_books(str(run2), manifest)
    same = all(Path(verdict_path(str(run1), sh["id"])).read_bytes()
               == Path(verdict_path(str(run2), sh["id"])).read_bytes()
               for sh in manifest["shards"])
    row2 = dict(rc_stopped=rc, shards_done_at_stop=mid["shards_done"],
                rc_relaunch=rc2, books=books2["balanced"],
                verdicts_bitwise_run_1=same)
    emit(phase="backfill_run", run=2, **row2)
    if rc != 75 or mid["shards_done"] != 2 or rc2 != 0 \
            or not books2["balanced"] or not same:
        raise AssertionError(f"backfill stop/relaunch: {row2}")

    # a few clips against the card CLI (4 frames a clip, --clip)
    recs = {r["clip"]: r for sh in manifest["shards"][:1]
            for r in read_verdicts(verdict_path(str(run1), sh["id"]))}
    cli = np.asarray(runner.test_img(str(ckpt_path), cli_files, size=size,
                                     clip=True, device=device))
    got = np.asarray([recs[f"c{i}"]["score"]
                      for i in range(BACKFILL_CLI_CLIPS)])
    cli_diff = float(np.abs(got - cli).max())
    emit(phase="backfill_cli", clips=BACKFILL_CLI_CLIPS,
         max_abs_diff=cli_diff, tol=BACKFILL_TOL, p_fake=got.tolist())
    if cli_diff > BACKFILL_TOL or np.abs(got - 0.5).max() <= 1e-3:
        raise AssertionError(f"backfill vs card CLI: {cli_diff:.3e}, {got}")
    gc.collect()
    torch.cuda.empty_cache()
    # the pack and its manifest stay for the router phase's backfill tenant
    return dict(launches=fwd, run1=row1, run2=row2, cli_diff=cli_diff,
                manifest=mpath, pack=pack)


def _backfill_replay_ms(ckpt_path: Path, manifest: dict, pack: Path,
                        device: str) -> float:
    """Device ms (profiler busy: kernels and copies) of one dispatch of the
    backfill pipeline, its input copy, replay and output copy, on a full
    batch of the pack's clips."""
    cfg = BackfillConfig(manifest="m", out="o", data_packed=str(pack),
                         model_path=str(ckpt_path),
                         batch_size=BACKFILL_BATCH, device=device)
    src = PackSource(str(pack))
    pipe = backfill_runner._Pipeline(cfg, src.frames_per_clip, src.sample_hw)
    slot = pipe.free.get()
    for j, entry in enumerate(manifest_entries(manifest)):
        if j == BACKFILL_BATCH:
            break
        slot.x_np[j] = src.load(entry)

    def once():
        pipe.dispatch(slot)
        pipe.collect(slot)

    busy, _ = _profile_kernels(once, 3)
    del pipe
    return busy


# ---------------------------------------------------------------------------
# the streaming runner (runners/stream.py): live raw-frame streams
# ---------------------------------------------------------------------------

STREAM_HW = (480, 640)            # a webcam or video-call feed, RGB
STREAM_TOL = 1e-6                 # P(fake), a window against the card CLI
STREAM_VECTOR = "0.05*4,0.95*8"   # planted scores, EMA alpha 0.3
STREAM_TRANSITIONS = [("real", "suspect", 6), ("suspect", "fake", 10)]
STREAM_LEVELS = (1, 4)            # concurrent streams (16 cut for time)
STREAM_FPS = 30.0                 # frames/s a stream
STREAM_CHUNK = 8                  # frames a POST
STREAM_LOAD_S = 2.0               # short: the script runs within 1,200 s
STREAM_BOOKS = ("windows_scored", "windows_dropped", "windows_shed",
                "windows_failed", "windows_cache_hit", "windows_dup_elided")


def stream_frames(n: int, seed: int) -> list:
    """``n`` distinct seeded 480×640 uint8 RGB frames: smooth content that
    drifts frame to frame, plus noise."""
    rng = np.random.default_rng(seed)
    h, w = STREAM_HW
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.clip(127 + 100 * np.sin(
        (xx[..., None] + 9 * i) / (40 + seed % 7) + yy[..., None] / 53
        + np.arange(3) * (i + 1)) + rng.normal(0, 20, (h, w, 3)), 0,
        255).astype(np.uint8) for i in range(n)]


def _raw_headers() -> dict:
    return {"Content-Type": "application/x-dfd-raw",
            "X-Frame-Width": str(STREAM_HW[1]),
            "X-Frame-Height": str(STREAM_HW[0])}


# the stream pushers: a child interpreter, one thread a stream, each
# opening its stream and posting chunks paced at STREAM_FPS: raw chunks of
# seeded frames, or the one body of a file with its Content-Type
_STREAM_CLIENTS = r"""
import http.client, json, sys, threading, time
import numpy as np
port, streams, seconds, fps, chunk, prefix = (int(sys.argv[1]),
    int(sys.argv[2]), float(sys.argv[3]), float(sys.argv[4]),
    int(sys.argv[5]), sys.argv[6])
h, w = 480, 640
if len(sys.argv) > 7:
    bodies = [open(sys.argv[7], "rb").read()] * 4
    headers = {"Content-Type": sys.argv[8]}
else:
    rng = np.random.default_rng(5)
    bodies = [rng.integers(0, 256, (chunk, h, w, 3),
                           dtype=np.uint8).tobytes() for _ in range(4)]
    headers = {"Content-Type": "application/x-dfd-raw",
               "X-Frame-Width": str(w), "X-Frame-Height": str(h)}
acks, statuses, lock = [], {}, threading.Lock()
period = chunk / fps

def pusher(k):
    sid = f"{prefix}{k}"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/streams", body=json.dumps({"stream_id": sid}))
    resp = conn.getresponse(); resp.read()
    assert resp.status == 201, resp.status
    t0 = time.perf_counter()
    n = 0
    while True:
        due = t0 + n * period
        if due - t0 >= seconds or time.perf_counter() - t0 >= seconds:
            break
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        s = time.perf_counter()
        conn.request("POST", f"/streams/{sid}/frames",
                     body=bodies[(n + k) % 4], headers=headers)
        resp = conn.getresponse(); resp.read()
        dt = time.perf_counter() - s
        with lock:
            statuses[resp.status] = statuses.get(resp.status, 0) + 1
            if resp.status == 200:
                acks.append(dt)
        n += 1
    conn.close()

t0 = time.perf_counter()
threads = [threading.Thread(target=pusher, args=(k,)) for k in range(streams)]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps(dict(acks=acks, statuses=statuses,
                      wall=time.perf_counter() - t0)))
"""


def _stage_sums(metrics) -> dict:
    return {s: (h.sum, h.count) for s, h in metrics.latency.items()}


def _replays(eng) -> Counter:
    return Counter({k: p.replays for k, p in eng.entry().compiled.items()})


def _books_balanced(s) -> bool:
    return s.windows_emitted == sum(getattr(s, k) for k in STREAM_BOOKS)


def _stream_load(srv, streams: int, smi: str, body: bytes = None,
                 ctype: str = "", prefix: str = "") -> dict:
    """``streams`` pushers for ``STREAM_LOAD_S`` (a child interpreter),
    posting raw chunks, or ``body`` as ``ctype`` where given, then the
    in-flight windows drained: frames/s, windows/s, ack percentiles, the
    mean stage ms, ring overflow and elided copies, each stream's books
    (exact), and the batches by bucket."""
    port = srv.server_address[1]
    m, eng = srv.manager.metrics, srv.engine
    before = dict(frames=m.frames_ingested_total.value,
                  scored=m.windows_scored_total.value,
                  overflow=m.ring_overflow_total.value,
                  elided=m.canvas_copies_elided_total.value,
                  stages=_stage_sums(m), replays=_replays(eng))
    prefix = f"{prefix}s{streams}_"
    extra = []
    if body is not None:
        path = OUT / f"stream_body_{prefix}.bin"
        path.write_bytes(body)
        extra = [str(path), ctype]
    proc = subprocess.run(
        [sys.executable, "-c", _STREAM_CLIENTS, str(port), str(streams),
         str(STREAM_LOAD_S), str(STREAM_FPS), str(STREAM_CHUNK), prefix,
         *extra], capture_output=True, text=True,
        timeout=STREAM_LOAD_S + 300)
    if proc.returncode != 0:
        raise AssertionError(f"stream pushers failed: {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    ids = [f"{prefix}{k}" for k in range(streams)]
    deadline = time.monotonic() + 60
    while not all(_books_balanced(srv.manager.get(i)) for i in ids):
        if time.monotonic() > deadline:
            raise AssertionError(f"{streams} streams: windows never "
                                 f"drained")
        time.sleep(0.02)
    # the level's wall: the pushers' own, then the drain of the windows
    # still in flight when they stopped
    wall = got["wall"] + time.perf_counter() - t0
    books = {}
    for i in ids:
        c = srv.manager.close(i)["counters"]
        books[i] = {k: c[k] for k in ("windows_emitted",) + STREAM_BOOKS}
    stages = {}
    for s, (total, n) in _stage_sums(m).items():
        t_, n_ = before["stages"][s]
        stages[s] = (total - t_) / (n - n_) * 1e3 if n > n_ else None
    replays = _replays(eng) - before["replays"]
    ms = np.asarray(got["acks"]) * 1e3
    frames = m.frames_ingested_total.value - before["frames"]
    scored = m.windows_scored_total.value - before["scored"]
    return dict(
        streams=streams, nvidia_smi=smi,
        offered_frames_per_s=streams * STREAM_FPS,
        offered_windows_per_s=streams * STREAM_FPS / 4,
        push_s=got["wall"], drained_s=wall,
        frames_per_s=frames / got["wall"], frames=frames,
        windows_scored_per_s=scored / wall, windows_scored=scored,
        ack_p50_ms=float(np.percentile(ms, 50)) if len(ms) else None,
        ack_p99_ms=float(np.percentile(ms, 99)) if len(ms) else None,
        statuses=dict(sorted(got["statuses"].items())),
        stage_mean_ms=stages,
        ring_overflow=m.ring_overflow_total.value - before["overflow"],
        canvas_copies_elided=m.canvas_copies_elided_total.value
        - before["elided"],
        books=dict(Counter(sum((Counter(b) for b in books.values()),
                               Counter()))),
        books_exact=all(b["windows_emitted"] == sum(b[k] for k in
                                                    STREAM_BOOKS)
                        for b in books.values()),
        batches={f"{b}x{c}": n for (b, c), n in sorted(replays.items())
                 if n})


def _stream_busy_ms(eng) -> dict:
    """Device ms (profiler busy: kernels and copies) of one batch of each
    program of ``eng``: its input copy, replay and output copy."""
    out = {}
    entry = eng.entry()
    for (b, c), prog in sorted(entry.compiled.items()):
        x = np.zeros((b, entry.image_size, entry.image_size, c), np.uint8)
        out[(b, c)] = _profile_kernels(lambda: eng._run(entry, b, c, x),
                                       3)[0]
    return out


def _launch_stream_child(ckpt_path: Path, state_dir: Path, port: int,
                         log, size: int, device: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "deepfake_detection_tpu_torch.runners.stream",
         "--model-path", str(ckpt_path), "--image-size", str(size),
         "--device", device, "--buckets",
         ",".join(map(str, SERVE_BUCKETS)), "--port", str(port),
         "--state-dir", str(state_dir), "--stream-ttl-s", "0",
         "--verdict-vector", "0.05*1,0.95*8"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)


def _ready_s(proc, port: int, t0: float, log_path: Path) -> float:
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"stream runner exited {proc.returncode}: "
                                 f"{log_path.read_text()[-3000:]}")
        try:
            if _http(port, "GET", "/readyz", timeout=5)[0] == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.05)
    raise AssertionError("the stream runner never became ready")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stream_restart(ckpt_path: Path, smi: str, size: int,
                    device: str) -> dict:
    """``runners.stream`` as a child with ``--state-dir``: seconds to
    ``/readyz`` 200; two streams pushed; SIGTERM → exit 0 and a snapshot
    each; the relaunch restores both and their next windows continue the
    window count and the verdict machines (the planted vector's third
    window enters 'suspect'; a reset machine would go to 'fake' at its
    first)."""
    sdir = OUT / "stream_state"
    shutil.rmtree(sdir, ignore_errors=True)
    port = _free_port()
    frames = stream_frames(12, seed=3)
    body = [b"".join(f.tobytes() for f in frames[:6]),
            b"".join(f.tobytes() for f in frames[6:])]
    rows, procs = [], []
    try:
        for run in (1, 2):
            log_path = OUT / f"stream_child_{run}.log"
            log = open(log_path, "w")
            t0 = time.perf_counter()
            proc = _launch_stream_child(ckpt_path, sdir, port, log, size,
                                        device)
            procs.append((proc, log))
            ready = _ready_s(proc, port, t0, log_path)
            if run == 1:
                for sid in ("a", "b"):
                    _http(port, "POST", "/streams",
                          json.dumps({"stream_id": sid}).encode())
            restored = _http(port, "GET", "/streams")[1]["streams"]
            for sid in ("a", "b"):
                st, ack = _http(port, "POST", f"/streams/{sid}/frames",
                                body[run - 1], headers=_raw_headers())
                if st != 200:
                    raise AssertionError(f"push {sid}: {st} {ack}")
            want = 1 if run == 1 else 3
            deadline = time.monotonic() + 60
            while True:
                sts = [_http(port, "GET", f"/streams/{sid}")[1]
                       for sid in ("a", "b")]
                if all(s["counters"]["windows_scored"] >= want for s in sts):
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"restart run {run}: {sts}")
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            log.close()
            snaps = sorted(p.name for p in sdir.iterdir()) \
                if sdir.is_dir() else []
            rows.append(dict(
                run=run, ready_s=ready, streams=restored, rc=rc,
                snapshots=snaps,
                windows=[s["stream"]["windows"] for s in sts],
                transitions=[[(e["from"], e["to"], e["windows"])
                              for e in s["events"] if e["scope"] == "stream"]
                             for s in sts]))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    one, two = rows
    emit(phase="stream_restart", nvidia_smi=smi, runs=rows)
    if one["rc"] != 0 or two["rc"] != 0 \
            or one["snapshots"] != ["a.state.json", "b.state.json"] \
            or two["streams"] != ["a", "b"] or one["streams"] != ["a", "b"] \
            or one["windows"] != [1, 1] or two["windows"] != [3, 3] \
            or two["transitions"] != [[("real", "suspect", 3)]] * 2:
        raise AssertionError(f"stream SIGTERM/resume: {rows}")
    return dict(ready_s=[one["ready_s"], two["ready_s"]])


def _mjpeg_chunk(blobs) -> bytes:
    return b"".join(b"--f\r\nContent-Type: image/jpeg\r\n\r\n" + b
                    + b"\r\n" for b in blobs) + b"--f--\r\n"


MJPEG_CTYPE = "multipart/x-mixed-replace; boundary=f"


def _stream_mjpeg(srv, smi: str) -> dict:
    """The MJPEG row of the uint8 stream server, built from the two
    640×480 fixtures: one stream of MJPEG chunks and one of the raw chunks
    of the same frames decoded, a window at a time (each scored alone, at
    bucket 1), whose windows must be bitwise equal; then 4 streams of
    MJPEG chunks of 8 frames at 30 frames/s for 2 s, every chunk 200 and
    the books exact.  Returns the row and the depthwise launches of the
    replays the MJPEG streams alone caused (the raw twin's stay with the
    stream path)."""
    eng = srv.engine
    port = srv.server_address[1]
    launches = 0
    blobs = [jpeg_bytes(JPEG_STREAMS[i % 2]) for i in range(STREAM_CHUNK)]
    frames = [jpeg_native.decode_jpeg_bytes(b) for b in blobs]
    scores = {}
    forward = srv.dispatcher._on_result

    def record(job, sc, err):
        if sc is not None:
            scores[(job.stream_id, job.window_idx)] = float(sc[0])
        forward(job, sc, err)

    srv.dispatcher._on_result = record
    try:
        for sid in ("mjpeg_parity", "raw_parity"):
            _http(port, "POST", "/streams",
                  json.dumps({"stream_id": sid}).encode())
        for w in range(2):
            part = slice(4 * w, 4 * w + 4)
            for sid, body, headers in (
                    ("mjpeg_parity", _mjpeg_chunk(blobs[part]),
                     {"Content-Type": MJPEG_CTYPE}),
                    ("raw_parity", b"".join(f.tobytes()
                                            for f in frames[part]),
                     _raw_headers())):
                before = eng.launch_counts().get("depthwise_fwd", 0)
                st, ack = _http(port, "POST", f"/streams/{sid}/frames",
                                body, headers=headers)
                if st != 200 or ack["decode_errors"]:
                    raise AssertionError(f"push {sid}: {st} {ack}")
                deadline = time.monotonic() + 60
                while srv.manager.get(sid).windows_scored < w + 1:
                    if time.monotonic() > deadline:
                        raise AssertionError(f"{sid} never scored")
                    time.sleep(0.01)
                if sid == "mjpeg_parity":
                    launches += eng.launch_counts().get("depthwise_fwd", 0) \
                        - before
    finally:
        srv.dispatcher._on_result = forward
    got = [scores.get(("mjpeg_parity", w)) for w in range(2)]
    want = [scores.get(("raw_parity", w)) for w in range(2)]
    for sid in ("mjpeg_parity", "raw_parity"):
        srv.manager.close(sid)
    before = eng.launch_counts().get("depthwise_fwd", 0)
    row = _stream_load(srv, 4, smi, body=_mjpeg_chunk(blobs),
                       ctype=MJPEG_CTYPE, prefix="mjpeg_")
    launches += eng.launch_counts().get("depthwise_fwd", 0) - before
    row.update(fixtures=list(JPEG_STREAMS), windows_bitwise_raw=got == want,
               p_fake_mjpeg=got, p_fake_raw=want,
               decode_ms_per_chunk=row["stage_mean_ms"].get("decode"),
               chunk_bytes=len(_mjpeg_chunk(blobs)))
    emit(phase="stream_mjpeg", launches=launches, **row)
    if got != want or None in got or not row["books_exact"] \
            or row["statuses"] != {"200": row["statuses"].get("200", 0)}:
        raise AssertionError(f"MJPEG streams: {row}")
    return dict(row=row, launches=launches)


def phase_stream(ckpt_path: Path, size: int = 600,
                 device: str = "cuda") -> dict:
    """The streaming runner on the card: the calibrated flagship behind
    ``runners.stream.build_stream_server`` (buckets 1/4/16, img_num 4,
    tiles of 4 frames, 4 windows in flight a stream, the full-frame
    localizer), on localhost HTTP.  Float32 wire: one stream of 8 raw
    640×480 frames whose windows match the card CLI's ``--clip`` within
    1e-6, and a planted verdict vector's exact transitions.  Uint8 wire:
    1 and 4 streams pushing raw 640×480 chunks at 30 frames/s for 2 s
    each (frames/s, windows/s, ack percentiles, stage ms, exact books, no
    capture after ready; the device's busy share at 4).  Then the runner
    as a child: SIGTERM with ``--state-dir`` and resume.  Returns the
    launches of the engines' replays and the numbers."""
    smi = nvidia_smi_line()
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(0.002)            # as runners/stream.py's main
    caps0 = capture_count()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    servers = {}
    for wire in ("float32", "uint8"):
        cfg = StreamConfig(model_path=str(ckpt_path), port=0, wire=wire,
                           buckets=SERVE_BUCKETS, device=device,
                           image_size=size, img_num=4, window_hop=0,
                           max_inflight_windows=4, localizer="full_frame",
                           stream_ttl_s=0.0, verdict_vector=STREAM_VECTOR,
                           verdict_ema_alpha=0.3)
        t0 = time.perf_counter()
        srv = stream_runner.build_stream_server(cfg)
        srv.engine.start(srv.batcher)
        srv.dispatcher.start()
        threading.Thread(target=srv.serve_forever,
                         kwargs={"poll_interval": 0.1}, daemon=True,
                         name=f"stream-{wire}").start()
        servers[wire] = (srv, time.perf_counter() - t0)
    peak = _peak_gib(base_mem)
    want = len(SERVE_BUCKETS) * (1 + 2)      # float32: 12ch; uint8: 3, 12
    caps_ready = capture_count()
    progs = {w: s.engine.compile_count for w, (s, _) in servers.items()}
    emit(phase="stream_captures", nvidia_smi=smi, programs=progs,
         captures=caps_ready - caps0, expected=want,
         build_s={w: t for w, (_, t) in servers.items()},
         peak_mem_gib_over_base=peak)
    if caps_ready - caps0 != want or sum(progs.values()) != want:
        raise AssertionError(f"stream servers: {progs}, "
                             f"{caps_ready - caps0} captures")
    for srv, _ in servers.values():
        for (b, c), p in srv.engine.entry().compiled.items():
            if p.launches.get("depthwise_fwd") != 55:
                raise AssertionError(f"stream bucket {b} ({c}ch): "
                                     f"{p.launches} launches captured")

    # 1. parity: each window against the card CLI's --clip, float32 wire
    f32 = servers["float32"][0]
    port = f32.server_address[1]
    scores = {}
    forward = f32.dispatcher._on_result

    def record(job, sc, err):
        if sc is not None:
            scores[(job.stream_id, job.window_idx)] = float(sc[0])
        forward(job, sc, err)

    f32.dispatcher._on_result = record
    frames = stream_frames(8, seed=1)
    files = []
    for i, f in enumerate(frames):
        files.append(str(OUT / f"stream_frame{i}.npy"))
        np.save(files[-1], f)
    for sid, fr in (("parity", frames), ("planted", stream_frames(40, 2))):
        _http(port, "POST", "/streams",
              json.dumps({"stream_id": sid}).encode())
        for i in range(0, len(fr), STREAM_CHUNK):
            st, ack = _http(
                port, "POST", f"/streams/{sid}/frames",
                b"".join(f.tobytes() for f in fr[i:i + STREAM_CHUNK]),
                headers=_raw_headers())
            if st != 200:
                raise AssertionError(f"push {sid}: {st} {ack}")
    deadline = time.monotonic() + 120
    while not (f32.manager.get("parity").windows_scored == 2
               and f32.manager.get("planted").windows_scored == 10):
        if time.monotonic() > deadline:
            raise AssertionError("the float32 streams never scored")
        time.sleep(0.02)
    planted = f32.manager.get("planted").status(events=64)
    transitions = [(e["from"], e["to"], e["windows"])
                   for e in planted["events"] if e["scope"] == "stream"]
    got = [scores[("parity", w)] for w in range(2)]
    cli = runner.test_img(str(ckpt_path), files, size=size, clip=True,
                          device=device)
    diff = float(np.abs(np.asarray(got) - np.asarray(cli)).max())
    emit(phase="stream_parity", nvidia_smi=smi, p_fake_stream=got,
         p_fake_cli=cli, max_abs_diff=diff, tol=STREAM_TOL,
         bitwise=got == cli, transitions=transitions,
         expected_transitions=STREAM_TRANSITIONS,
         verdict=planted["verdict"])
    if diff > STREAM_TOL or np.abs(np.asarray(got) - 0.5).max() <= 1e-3 \
            or not np.all(np.isfinite(got)) \
            or transitions != STREAM_TRANSITIONS:
        raise AssertionError(f"stream parity: {got} vs {cli}, "
                             f"{transitions}")
    for sid in ("parity", "planted"):
        f32.manager.close(sid)

    # 2. load, uint8 wire: 1 and 4 streams
    u8 = servers["uint8"][0]
    compiles = u8.engine.compile_count
    loads = []
    for streams in STREAM_LEVELS:
        row = _stream_load(u8, streams, smi)
        if streams == STREAM_LEVELS[-1]:
            # the device's busy share of the level, as backfill measures
            # it: each program's profiled batch (copies and replay) times
            # its batches in the level, over the level's wall time
            busy = _stream_busy_ms(u8.engine)
            busy_ms = sum(busy[tuple(map(int, k.split("x")))] * n
                          for k, n in row["batches"].items())
            row.update(batch_busy_ms={f"{b}x{c}": v for (b, c), v in
                                      busy.items()},
                       device_busy_share=busy_ms / (row["drained_s"] * 1e3))
        loads.append(row)
        emit(phase="stream_load", **row)
        if not row["books_exact"] or row["statuses"] != {
                "200": row["statuses"].get("200", 0)} \
                or u8.engine.compile_count != compiles \
                or capture_count() != caps_ready:
            raise AssertionError(f"stream load at {streams}: {row}")

    mjpeg = _stream_mjpeg(u8, smi)
    if u8.engine.compile_count != compiles or capture_count() != caps_ready:
        raise AssertionError("the MJPEG streams added programs or captures")

    # launches: captures × replays of both engines (profiling included)
    launches = Counter()
    for srv, _ in servers.values():
        eng = srv.engine
        counted = eng.launch_counts()
        replays = sum(p.replays for p in eng.entry().compiled.values())
        if counted.get("depthwise_fwd", 0) != 55 * replays or replays == 0:
            raise AssertionError(f"stream {eng.wire}: {counted} launches "
                                 f"for {replays} replays")
        launches.update(counted)
        srv.shutdown()
        srv.dispatcher.stop()
        srv.manager.shutdown()
        eng.stop()
        srv.batcher.close()
        srv.server_close()
    del servers, f32, u8
    gc.collect()
    torch.cuda.empty_cache()
    sys.setswitchinterval(old_switch)

    # 3. cold start and durability: the runner as a child process
    restart = _stream_restart(ckpt_path, smi, size, device)
    emit(phase="stream", nvidia_smi=smi, replay_launches=dict(launches),
         captures=capture_count() - caps0, peak_mem_gib_over_base=peak,
         ready_s=restart["ready_s"], mjpeg_launches=mjpeg["launches"])
    return dict(launches=launches["depthwise_fwd"] - mjpeg["launches"],
                mjpeg_launches=mjpeg["launches"], loads=loads,
                mjpeg=mjpeg["row"], parity=diff, peak_gib=peak,
                ready_s=restart["ready_s"])


# ---------------------------------------------------------------------------
# the fleet router (runners/router.py): N port replicas on one card
# ---------------------------------------------------------------------------

# (N = 4 and its 64-client row cut for time)
ROUTER_CLIENTS = 32
ROUTER_LOAD_S = 2.0               # short: the script runs within 1,200 s
ROUTER_KILL_AT_S = 1.5            # into the failover load
ROUTER_SURVIVOR_S = 2.0           # short: the script runs within 1,200 s
ROUTER_SPIKE_S = 12.0             # the autoscaler's spike: it scales up
                                  # within ~3 s and holds while the new
                                  # replica warms (~16 s), load or not
ROUTER_UTIL_PERIOD_S = 0.2        # nvidia-smi utilization.gpu samples
ROUTER_STREAMS = 4
ROUTER_STREAM_FRAMES = 24         # a stream's frames before and after a drain
ROUTER_EDGE_REPEATS = 10
#: captures a replica: one model × buckets × the uint8 wire's widths 3, 12
ROUTER_CAPTURES = len(SERVE_BUCKETS) * 2
ROUTER_BOOKS = ("cache_hit", "forwarded", "migrated", "shed", "failed")
_CLK_TCK = os.sysconf("SC_CLK_TCK")


def _prom(text: str) -> list:
    """(name, labels, value) of every sample of a Prometheus exposition."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        lhs, _, value = line.rpartition(" ")
        name, _, inner = lhs.partition("{")
        labels = dict(re.findall(r'(\w+)="([^"]*)"', inner))
        out.append((name, labels, float(value)))
    return out


def _by_replica(samples: list, name: str) -> dict:
    """replica id → the sum of ``name``'s samples re-exported for it."""
    out = Counter()
    for n, labels, v in samples:
        if n == name and "replica" in labels:
            out[labels["replica"]] += v
    return dict(out)


def _replica_replays(samples: list) -> dict:
    """replica id → graph replays: each batch of bucket b adds b rows
    (real plus pad) to ``dfd_serving_bucket_rows_total``."""
    out = Counter()
    for n, labels, v in samples:
        if n == "dfd_serving_bucket_rows_total" and "replica" in labels:
            out[labels["replica"]] += v / int(labels["bucket"])
    return {k: int(round(v)) for k, v in out.items()}


def _gpu_apps() -> list:
    """``nvidia-smi --query-compute-apps=pid,used_memory`` as it prints it:
    one ``pid, MiB`` line a process holding a context, where the
    container's process namespace shows the process."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [ln.strip() for ln in out.strip().splitlines() if ln.strip()]


def _gpu_query(fields: str) -> list:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [float(v) for v in out.strip().splitlines()[0].split(",")]


class _UtilSampler:
    """nvidia-smi's sampled ``utilization.gpu`` every
    ``ROUTER_UTIL_PERIOD_S`` on a thread, for the length of a load."""

    def __init__(self):
        self.samples, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(ROUTER_UTIL_PERIOD_S):
            self.samples.append(_gpu_query("utilization.gpu")[0])

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()
        if not self.samples:
            raise AssertionError("nvidia-smi gave no utilization sample")
        return dict(mean_pct=float(np.mean(self.samples)),
                    samples=len(self.samples),
                    source="nvidia-smi utilization.gpu, sampled")


class _Fleet:
    """``python -m deepfake_detection_tpu_torch.runners.router`` as a child
    process, as it is deployed, with ``args``; everything is read off its
    ``/readyz``, ``/replicas``, ``/autoscaler`` and ``/metrics``."""

    def __init__(self, name: str, args: list):
        self.name, self.port = name, _free_port()
        self.log_path = OUT / f"router_{name}.log"
        self.log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        # -X faulthandler: a router that does not stop is sent SIGABRT,
        # which writes every thread's stack to its log
        self.proc = subprocess.Popen(
            [sys.executable, "-X", "faulthandler", "-m",
             "deepfake_detection_tpu_torch.runners.router",
             "--port", str(self.port), "--scrape-interval-s", "0.2"] + args,
            cwd=ROOT, stdout=self.log, stderr=subprocess.STDOUT)
        self.kids = {}

    def get(self, path: str):
        st, out = _http(self.port, "GET", path, timeout=30)
        if st not in (200, 503):
            raise AssertionError(f"router {self.name} {path}: {st} {out}")
        return out

    def samples(self) -> list:
        return _prom(self.get("/metrics"))

    def books(self) -> dict:
        got = {n[len("dfd_router_"):-len("_total")]: int(v)
               for n, labels, v in self.samples()
               if not labels and n in {f"dfd_router_{k}_total" for k in
                                       ("routed",) + ROUTER_BOOKS}}
        if got["routed"] != sum(got[k] for k in ROUTER_BOOKS):
            raise AssertionError(f"router {self.name} books: {got}")
        return got

    def counter(self, name: str) -> int:
        return int(sum(v for n, labels, v in self.samples()
                       if n == f"dfd_router_{name}" and not labels))

    def wait(self, cond, what: str, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"router {self.name} exited {self.proc.returncode}: "
                    f"{self.log_path.read_text()[-3000:]}")
            try:
                got = cond()
            except OSError:
                got = None
            if got:
                return got
            if time.monotonic() > deadline:
                try:
                    doc = _http(self.port, "GET", "/readyz", timeout=5)
                except OSError as e:
                    doc = repr(e)
                raise AssertionError(
                    f"router {self.name}: {what}; /readyz {doc}; its log "
                    f"(the replicas' too) ends: "
                    f"{self.log_path.read_text()[-6000:]}")
            time.sleep(0.1)

    def ready(self, n: int) -> float:
        """Seconds from the router's launch to ``n`` replicas ready."""
        def up():
            st, doc = _http(self.port, "GET", "/readyz", timeout=5)
            return st == 200 and doc["counts"]["ready"] == n \
                and doc["counts"]["warming"] == 0
        self.wait(up, f"{n} replica(s) never ready")
        return time.perf_counter() - self.t0

    def children(self) -> dict:
        """Replica id → (pid, command line) of the router's children."""
        out = {}
        for d in Path("/proc").iterdir():
            if not d.name.isdigit():
                continue
            try:
                stat = (d / "stat").read_text()
                cmd = [c.decode() for c in (d / "cmdline").read_bytes()
                       .split(b"\0") if c]
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == self.proc.pid \
                    and "--port" in cmd:
                out[f"127.0.0.1:{cmd[cmd.index('--port') + 1]}"] = \
                    (int(d.name), cmd)
        self.kids.update(out)
        return out

    def cpu_s(self) -> float:
        stat = Path(f"/proc/{self.proc.pid}/stat").read_text()
        fields = stat.rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / _CLK_TCK

    def stop(self) -> int:
        """SIGTERM: the router stops every child it spawned, exits 0."""
        self.children()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=180)
        except subprocess.TimeoutExpired:
            self.proc.send_signal(signal.SIGABRT)
            self.proc.wait(timeout=60)
            self.kill()
            raise AssertionError(f"router {self.name} did not stop on "
                                 f"SIGTERM: "
                                 f"{self.log_path.read_text()[-6000:]}")
        self.log.close()
        alive = [pid for pid, _ in self.kids.values() if not _gone(pid)]
        if rc != 0 or alive:
            raise AssertionError(f"router {self.name}: exit {rc}, children "
                                 f"left {alive}: "
                                 f"{self.log_path.read_text()[-3000:]}")
        return rc

    def kill(self) -> None:
        kids = self.children()
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for pid, _ in kids.values():
            if not _gone(pid):
                os.kill(pid, signal.SIGKILL)
        self.log.close()


def _gone(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
    except OSError:
        return True
    return state.split()[0] == "Z"


def _serve_args(ckpt_path: Path, size: int, device: str,
                extra: str = "") -> str:
    return (f"--model-path {ckpt_path} --device {device} --wire uint8 "
            f"--buckets {','.join(map(str, SERVE_BUCKETS))} "
            f"--image-size {size} {extra}").strip()


def _epoch(replicas: dict) -> str:
    """The edge cache's fleet weights-epoch, as ``fleet/router.py``'s
    ``EdgeCache.epoch`` computes it from the replicas' fingerprints."""
    pairs = sorted(f"{mid}={det['fingerprint']}" for r in replicas.values()
                   for mid, det in (r["models"] or {}).items())
    return hashlib.sha256("\n".join(pairs).encode()).hexdigest()


def _fleet_parity(fleet: _Fleet, files: list, cli: dict) -> dict:
    """P(fake) through the router against the card CLI, bitwise."""
    worst = 0.0
    for i, f in enumerate(files):
        st, out = _http(fleet.port, "POST", "/score", Path(f).read_bytes())
        if st != 200:
            raise AssertionError(f"router /score {f}: {st} {out}")
        worst = max(worst, abs(out["fake_score"] - cli["single"][i]))
    for j in range(len(cli["clip"])):
        body, ctype = _multipart(Path(f).read_bytes()
                                 for f in files[4 * j:4 * j + 4])
        st, out = _http(fleet.port, "POST", "/score", body, ctype)
        if st != 200 or out["frames"] != 4:
            raise AssertionError(f"router /score clip {j}: {st} {out}")
        worst = max(worst, abs(out["fake_score"] - cli["clip"][j]))
    if worst != 0.0:
        raise AssertionError(f"router /score differs from the card CLI by "
                             f"{worst}")
    return dict(files=len(files), clips=len(cli["clip"]), bitwise=True)


def _fleet_load(fleet: _Fleet, body: bytes, ctype: str, clients: int,
                seconds: float, captures: dict) -> dict:
    """A closed-loop load through the router: clips/s, latency, statuses
    and the replicas' stage ms (``_load``), each replica's share of the
    forwards, the router's CPU ms a relayed request, device memory by
    process and the sampled utilization; books exact, every answer 200 and
    no capture after ready."""
    before, cpu0 = fleet.samples(), fleet.cpu_s()
    util = _UtilSampler()
    row = _load(fleet.port, body, ctype, clients, seconds)
    row["utilization"] = util.stop()
    cpu = fleet.cpu_s() - cpu0
    after = fleet.samples()
    fwd0 = _by_replica(before, "dfd_router_replica_forwarded_total")
    fwd = {r: v - fwd0.get(r, 0) for r, v in
           _by_replica(after, "dfd_router_replica_forwarded_total").items()}
    routed = sum(v for n, lb, v in after if n == "dfd_router_routed_total"
                 and not lb) - sum(v for n, lb, v in before
                                   if n == "dfd_router_routed_total"
                                   and not lb)
    pids = {r: pid for r, (pid, _) in fleet.children().items()}
    used, total = _gpu_query("memory.used,memory.total")
    row.update(
        forward_share={r: v / max(1, sum(fwd.values()))
                       for r, v in sorted(fwd.items())},
        router_cpu_ms_per_relay=cpu * 1e3 / max(1, routed),
        router_cpu_share=cpu / row["seconds"],
        replica_pids=pids, chip_smoke_pid=os.getpid(),
        compute_apps=_gpu_apps(),
        device_memory_used_mib=used, device_memory_total_mib=total,
        books=fleet.books())
    compiles = _by_replica(after, "dfd_serving_backend_compiles_total")
    compiles = {r: compiles.get(r) for r in captures}
    if row["statuses"] != {"200": row["statuses"].get("200", 0)} \
            or compiles != captures:
        raise AssertionError(f"router load at {clients} clients: {row}, "
                             f"captures {compiles} against {captures}")
    return row


def _ready_fleet(fleet: _Fleet, n: int) -> dict:
    """Ready seconds, each replica's warmup stages and captures."""
    ready_s = fleet.ready(n)
    samples = fleet.samples()
    captures = _by_replica(samples, "dfd_serving_backend_compiles_total")
    warmup = {}
    for name, labels, v in samples:
        if name == "dfd_serving_warmup_seconds" and "replica" in labels:
            warmup.setdefault(labels["replica"], {})[labels["stage"]] = v
    if len(captures) != n or set(captures.values()) != {ROUTER_CAPTURES}:
        raise AssertionError(f"fleet of {n}: captures {captures}, expected "
                             f"{ROUTER_CAPTURES} each")
    return dict(ready_s=ready_s, warmup_s=warmup, captures=captures)


def _edge_cache_row(fleet: _Fleet, reload_dir: Path, ckpt_path: Path,
                    body: bytes, ctype: str) -> dict:
    """A second router attached to ``fleet``'s replica with the edge
    verdict cache on: repeated bodies answered as ``cache_hit``; a hot
    reload of the replica moves its fingerprint, so the epoch, and the
    same body is forwarded once more before it hits again."""
    (rid,) = fleet.get("/replicas")
    edge = _Fleet("edge", ["--replicas", rid, "--edge-cache-entries", "64",
                           "--edge-cache-ttl-s", "600"])
    try:
        edge.ready(1)
        reps = edge.wait(lambda: (lambda d: d if all(
            det.get("fingerprint") for r in d.values()
            for det in (r["models"] or {}).values()) else None)(
                edge.get("/replicas")), "no fingerprint scraped", 60)
        epoch0 = _epoch(reps)
        first = [_http(edge.port, "POST", "/score", body, ctype)[1]
                 ["fake_score"] for _ in range(ROUTER_EDGE_REPEATS)]
        books0 = edge.books()
        _perturbed_file(ckpt_path, reload_dir / "next.pth", seed=1)

        def moved():
            st, doc = _http(edge.port, "GET", "/readyz", timeout=5)
            return st == 200 and _epoch(doc["replicas"]) != epoch0 \
                and doc["replicas"]
        reps = edge.wait(moved, "the reload never moved the epoch", 120)
        epoch1 = _epoch(reps)
        second = [_http(edge.port, "POST", "/score", body, ctype)[1]
                  ["fake_score"] for _ in range(3)]
        books1 = edge.books()
        row = dict(epoch_before=epoch0, epoch_after=epoch1,
                   books_before_reload=books0, books_after_reload=books1,
                   score_before=first[0], score_after=second[0])
        if books0["cache_hit"] != ROUTER_EDGE_REPEATS - 1 \
                or books0["forwarded"] != 1 or len(set(first)) != 1 \
                or books1["forwarded"] != 2 \
                or books1["cache_hit"] != ROUTER_EDGE_REPEATS + 1 \
                or len(set(second)) != 1 or second[0] == first[0]:
            raise AssertionError(f"edge cache: {row}")
        edge.stop()
    except BaseException:
        edge.kill()
        raise
    return row


def _failover_row(fleet: _Fleet, body: bytes, ctype: str,
                  captures: dict) -> dict:
    """SIGKILL one of the fleet's replicas under the closed-loop load: the
    scraper marks it down, stateless requests fail over to the survivor,
    the books stay exact; then the survivor alone under the same load."""
    kids = fleet.children()
    victim = sorted(kids)[0]
    box = {}
    t = threading.Thread(target=lambda: box.update(row=_load(
        fleet.port, body, ctype, ROUTER_CLIENTS, ROUTER_LOAD_S)))
    t.start()
    time.sleep(ROUTER_KILL_AT_S)
    os.kill(kids[victim][0], signal.SIGKILL)
    t.join()
    row = box["row"]
    fleet.wait(lambda: fleet.counter("replicas_down_total") == 1,
               "the killed replica was never marked down", 60)
    books = fleet.books()
    survivor = {r: n for r, n in captures.items() if r != victim}
    surv = _fleet_load(fleet, body, ctype, ROUTER_CLIENTS,
                       ROUTER_SURVIVOR_S, survivor)
    out = dict(killed=victim, during=row, books=books,
               replicas_down=fleet.counter("replicas_down_total"),
               survivor_clips_per_s=surv["clips_per_s"], survivor=surv)
    if row["statuses"] != {"200": row["statuses"].get("200", 0)} \
            or books["failed"] or books["shed"]:
        raise AssertionError(f"failover: {out}")
    return out


def _router_streams(ckpt_path: Path, size: int, device: str,
                    replays: dict) -> dict:
    """Two stream replicas behind the router: four raw 640×480 streams,
    the replica holding sessions drained mid-stream (each session moves,
    frames keep flowing to the other replica), the planted transitions at
    windows 6 and 10 and every stream's books exact."""
    args = _serve_args(ckpt_path, size, device, (
        f"--img-num 4 --window-hop 0 --max-inflight-windows 4 "
        f"--localizer full_frame --stream-ttl-s 0 "
        f"--verdict-vector {STREAM_VECTOR} --verdict-ema-alpha 0.3"))
    fleet = _Fleet("streams", ["--spawn", "2", "--spawn-runner", "stream",
                               f"--replica-args={args}"])
    try:
        ready = _ready_fleet(fleet, 2)
        sids = [f"rs{k}" for k in range(ROUTER_STREAMS)]
        for sid in sids:
            st, out = _http(fleet.port, "POST", "/streams",
                            json.dumps({"stream_id": sid}).encode())
            if st != 201:
                raise AssertionError(f"open {sid}: {st} {out}")
        frames = stream_frames(2 * ROUTER_STREAM_FRAMES, seed=4)

        def push(lo: int, windows: int) -> None:
            for sid in sids:
                for i in range(lo, lo + ROUTER_STREAM_FRAMES, STREAM_CHUNK):
                    st, ack = _http(
                        fleet.port, "POST", f"/streams/{sid}/frames",
                        b"".join(f.tobytes() for f in
                                 frames[i:i + STREAM_CHUNK]),
                        headers=_raw_headers())
                    if st != 200:
                        raise AssertionError(f"push {sid}: {st} {ack}")
            fleet.wait(lambda: all(
                _http(fleet.port, "GET", f"/streams/{s}")[1]["counters"]
                ["windows_scored"] >= windows for s in sids),
                f"streams never scored {windows} windows", 120)

        push(0, ROUTER_STREAM_FRAMES // 4)
        homes = {rid: _http(int(rid.rsplit(":", 1)[1]), "GET",
                            "/streams")[1]["streams"]
                 for rid in fleet.children()}
        source = max(sorted(homes), key=lambda r: len(homes[r]))
        st, report = _http(fleet.port, "POST", f"/replicas/{source}/drain")
        moved = sorted(homes[source])
        if st != 200 or sorted(report["migrated"]) != moved \
                or report["failed"] or not moved:
            raise AssertionError(f"drain {source}: {st} {report}, "
                                 f"homes {homes}")
        migrated0 = fleet.books()["migrated"]
        push(ROUTER_STREAM_FRAMES, ROUTER_STREAM_FRAMES // 2)
        target = next(r for r in homes if r != source)
        on_target = _http(int(target.rsplit(":", 1)[1]), "GET",
                          "/streams")[1]["streams"]
        statuses = {s: _http(fleet.port, "GET", f"/streams/{s}")[1]
                    for s in sids}
        transitions = {s: [(e["from"], e["to"], e["windows"])
                           for e in d["events"] if e["scope"] == "stream"]
                       for s, d in statuses.items()}
        counters = {s: d["counters"] for s, d in statuses.items()}
        books = fleet.books()
        samples = fleet.samples()
        for r, n in _replica_replays(samples).items():
            replays[("streams", r)] = n
        row = dict(ready=ready, homes=homes, drained=source, moved=moved,
                   streams_migrated=fleet.counter(
                       "streams_migrated_total"),
                   migrated_requests=books["migrated"] - migrated0,
                   on_target=on_target, transitions=transitions,
                   counters=counters, books=books)
        exact = all(c["windows_emitted"] == sum(c[k] for k in STREAM_BOOKS)
                    and c["frames_ingested"] == 2 * ROUTER_STREAM_FRAMES
                    for c in counters.values())
        if row["streams_migrated"] != len(moved) \
                or row["migrated_requests"] < len(moved) \
                or sorted(on_target) != sids or not exact \
                or any(t != STREAM_TRANSITIONS
                       for t in transitions.values()):
            raise AssertionError(f"streams through the router: {row}")
        fleet.stop()
    except BaseException:
        fleet.kill()
        raise
    return row


def _router_autoscale(ckpt_path: Path, size: int, device: str,
                      body: bytes, ctype: str, manifest_path: Path,
                      pack: Path, replays: dict) -> dict:
    """``--autoscale`` from one serve replica, max two, with the backfill
    tenant on the backfill phase's manifest.  The phase holds the leases
    of half the shards, as a peer worker would, so the tenant's worker has
    scored the rest and is still alive when the 32-client spike comes: the
    tenant yields (exit 75) before the second replica spawns; when the
    load stops, scale-in drains first; the held leases are then released
    and the tenant runs the manifest dry.  The decision trace replays to
    the same decisions."""
    out = OUT / "router_tenant"
    trace = OUT / "router_autoscale_trace.jsonl"
    shutil.rmtree(out, ignore_errors=True)
    trace.unlink(missing_ok=True)
    manifest = load_manifest(str(manifest_path))
    shard_ids = [sh["id"] for sh in manifest["shards"]]
    peer = LeaseDir(str(out), owner="peer", ttl_s=3600.0)
    held = shard_ids[len(shard_ids) // 2:]
    if not all(peer.acquire(s) for s in held):
        raise AssertionError("the peer could not hold its leases")
    tenant_args = (f"--data-packed {pack} --model-path {ckpt_path} "
                   f"--batch-size {BACKFILL_BATCH} --dedup --workers 8 "
                   f"--device {device}")
    fleet = _Fleet("autoscale", [
        "--spawn", "1",
        f"--replica-args={_serve_args(ckpt_path, size, device)}",
        "--autoscale", "--min-replicas", "1", "--max-replicas", "2",
        "--autoscale-interval-s", "0.5", "--autoscale-up-samples", "2",
        "--autoscale-down-samples", "4", "--autoscale-up-cooldown-s", "1",
        "--autoscale-down-cooldown-s", "2", "--settle-timeout-s", "20",
        "--autoscale-trace", str(trace), "--backfill-tenant",
        str(manifest_path), "--backfill-out", str(out),
        f"--backfill-args={tenant_args}"])
    try:
        ready_s = fleet.ready(1)
        fleet.wait(lambda: all(peer.is_done(s) for s in shard_ids
                               if s not in held),
                   "the tenant's worker never scored its shards", 300)
        before = fleet.get("/autoscaler")
        box = {}
        t = threading.Thread(target=lambda: box.update(row=_load(
            fleet.port, body, ctype, ROUTER_CLIENTS, ROUTER_SPIKE_S)))
        t0 = time.perf_counter()
        t.start()
        fleet.wait(lambda: fleet.get("/autoscaler")["books"]["up"] >= 1,
                   "the spike never scaled up", ROUTER_SPIKE_S)
        up_s = time.perf_counter() - t0
        fleet.wait(lambda: fleet.get("/readyz")["counts"]["ready"] == 2,
                   "the spawned replica never became ready", 300)
        spawn_ready_s = time.perf_counter() - t0 - up_s
        at_peak = fleet.get("/autoscaler")
        t.join()
        t_idle = time.perf_counter()
        for r, n in _replica_replays(fleet.samples()).items():
            replays[("autoscale", r)] = n
        fleet.wait(lambda: fleet.get("/autoscaler")["books"]["retired"]
                   >= 1, "the idle fleet never scaled in", 120)
        scale_in_s = time.perf_counter() - t_idle
        after_in = fleet.get("/autoscaler")
        for s in held:
            peer.release(s)
        fleet.wait(lambda: fleet.get("/autoscaler")["tenant"]
                   ["corpus_done"], "the tenant never ran the manifest dry",
                   300)
        final = fleet.get("/autoscaler")
        alive = fleet.get("/readyz")["counts"]["replicas"]
        router_books = fleet.books()
        fleet.stop()
    except BaseException:
        fleet.kill()
        raise
    runs = sorted((rec for p in out.glob("telemetry-tenant-*.jsonl")
                   for rec in map(json.loads, p.read_text().splitlines())
                   if rec.get("event") == "run_end"), key=lambda r: r["t"])
    books = collect_books(str(out), manifest)
    rep = replay_trace(str(trace))
    lb = final["books"]
    row = dict(
        ready_s=ready_s, spike=box["row"], up_after_s=up_s,
        spawned_replica_ready_s=spawn_ready_s,
        retired_after_load_s=scale_in_s, before_spike=before,
        at_peak=at_peak, after_scale_in=after_in, final=final,
        alive=alive, router_books=router_books,
        tenant_runs=[dict(worker=r.get("worker"),
                          preempted=r.get("preempted"),
                          clips=r.get("clips_this_proc"),
                          launches=r.get("launches")) for r in runs],
        tenant_books={k: books[k] for k in (
            "manifest_clips", "scored", "failed", "skipped_dup",
            "balanced", "complete")},
        trace=dict(match=rep["match"], n=rep["n"],
                   actions=dict(Counter(rep["recorded"]))))
    yielded = [r for r in runs if r.get("preempted")]
    if box["row"]["statuses"] != {"200": box["row"]["statuses"].get("200",
                                                                     0)} \
            or at_peak["tenant"]["yields"] < 1 or lb["up"] < 1 \
            or lb["down"] < 1 or lb["retired"] < 1 or lb["killed"] \
            or lb["spawned"] != lb["retired"] + lb["killed"] + alive \
            or not yielded or runs[-1].get("preempted") \
            or not books["complete"] or not books["balanced"] \
            or books["manifest_clips"] != books["scored"] \
            + books["failed"] + books["skipped_dup"] \
            or not rep["match"] or not {"up", "down"} <= set(
                rep["recorded"]):
        raise AssertionError(f"autoscaler with its backfill tenant: {row}")
    row["tenant_launches"] = sum((r.get("launches") or {}).get(
        "depthwise_fwd", 0) for r in runs)
    return row


def phase_router(ckpt_path: Path, files: list, cli: dict,
                 manifest_path: Path, pack: Path, size: int = 600,
                 device: str = "cuda") -> dict:
    """The fleet router on the card, as a child process in front of N
    spawned replicas of the port (each its own process, CUDA context and
    graphs): at N = 1 and 2 serve replicas the seconds to ready with N
    cold starts at once and each replica's warmup stages, scores through
    the router bitwise the card CLI, 32 closed-loop clients for 2 s with
    clips/s, latency, the replicas' stage ms, each
    replica's share, device memory by process, nvidia-smi's sampled
    utilization and the router's CPU a relay, exact books and no capture
    after ready; the edge cache at N = 1, a SIGKILLed replica at N = 2;
    then streams drained across two stream replicas, and the autoscaler
    with its backfill tenant.  Kernel launches: each replica's graph
    replays (its re-exported bucket rows) × the 55 captured a graph, and
    the tenant's own counts."""
    smi = nvidia_smi_line()
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    clip = [np.clip(127 + 60 * rng.standard_normal((size, size, 3)), 0,
                    255).astype(np.uint8) for _ in range(4)]
    body, ctype = _multipart(_npy_bytes(c) for c in clip)
    replays, rows = {}, {}
    reload_dir = OUT / "router_reload"
    shutil.rmtree(reload_dir, ignore_errors=True)
    reload_dir.mkdir(parents=True)
    extra = f"--reload-dir {reload_dir} --reload-interval-s 0.2"
    fleet = _Fleet("serve2", [
        "--spawn", "2",
        f"--replica-args={_serve_args(ckpt_path, size, device, extra)}"])
    try:
        ready = _ready_fleet(fleet, 2)
        ready_s = {2: ready["ready_s"]}
        two = dict(replicas=2, nvidia_smi=smi, ready=ready,
                   parity=_fleet_parity(fleet, files, cli), load=[])
        two["load"].append(_fleet_load(fleet, body, ctype, ROUTER_CLIENTS,
                                       ROUTER_LOAD_S, ready["captures"]))
        emit(phase="router_load", replicas=2, nvidia_smi=smi,
             **two["load"][-1])
        # N = 1: a second router in front of one of the two replicas (no
        # third cold start), then the edge cache in front of it
        rid = sorted(ready["captures"])[0]
        one = _Fleet("serve1", ["--replicas", rid])
        try:
            one_ready = one.ready(1)
            row = dict(replicas=1, nvidia_smi=smi, attached_to=rid,
                       ready_s=one_ready,
                       parity=_fleet_parity(one, files, cli), load=[])
            row["load"].append(_fleet_load(one, body, ctype, ROUTER_CLIENTS,
                                           ROUTER_LOAD_S,
                                           {rid: ready["captures"][rid]}))
            emit(phase="router_load", replicas=1, nvidia_smi=smi,
                 **row["load"][-1])
            row["edge_cache"] = _edge_cache_row(
                one, reload_dir, ckpt_path, Path(files[0]).read_bytes(),
                "application/octet-stream")
            row["books"] = one.books()
            one.stop()
        except BaseException:
            one.kill()
            raise
        rows[1] = row
        emit(phase="router_fleet", **{k: v for k, v in row.items()
                                      if k != "load"})
        two["failover"] = _failover_row(fleet, body, ctype,
                                        ready["captures"])
        for r, k in _replica_replays(fleet.samples()).items():
            replays[("serve2", r)] = k
        two["books"] = fleet.books()
        fleet.stop()
    except BaseException:
        fleet.kill()
        raise
    rows[2] = two
    emit(phase="router_fleet", **{k: v for k, v in two.items()
                                  if k != "load"})
    streams = _router_streams(ckpt_path, size, device, replays)
    emit(phase="router_streams", nvidia_smi=smi, **streams)
    auto = _router_autoscale(ckpt_path, size, device, body, ctype,
                             manifest_path, pack, replays)
    emit(phase="router_autoscale", nvidia_smi=smi, **auto)
    shutil.rmtree(pack, ignore_errors=True)
    replica_replays = sum(replays.values())
    launches = 55 * replica_replays + auto["tenant_launches"]
    emit(phase="router", nvidia_smi=smi, fleet_ready_s=ready_s,
         replica_replays=replica_replays,
         tenant_launches=auto["tenant_launches"], launches=launches,
         launches_rule="55 depthwise forward launches captured a graph × "
                       "each replica's replays (its re-exported bucket "
                       "rows), plus the tenant workers' own counts")
    if replica_replays == 0:
        raise AssertionError("no replica replayed a graph behind the router")
    return dict(launches=launches, ready_s=ready_s,
                stream_ready_s=streams["ready"]["ready_s"],
                autoscale_spawn_ready_s=auto["spawned_replica_ready_s"])


WARM_FLIP = "flash_bwd_dq"        # the stored library tree C finds corrupt
# (one of the six quick to build; the server's own, depthwise_fwd, is held
# by its canary in tree B)
WARM_BOOKS = ("hits", "misses", "fallbacks", "canary_rejects", "serialized")
WARM_BUCKET = "1"                 # trees B and C capture one bucket
WARM_A_BUCKETS = "1,4"            # tree A: two of the server's buckets


def _warm_tree(dst: Path) -> Path:
    """A fresh checkout of the port's package with no ``build/``, as a new
    container or a fleet replica started from a fresh tree has it."""
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(ROOT / "deepfake_detection_tpu_torch",
                    dst / "deepfake_detection_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _tree_env(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    env.pop("DFD_CHAOS", None)
    return env


def _warm_serve(name: str, tree: Path, store: Path, ckpt_path: Path,
                files: list, cli: dict, buckets: str = "") -> dict:
    """``runners.serve`` as a child in ``tree`` on ``store`` (on
    ``buckets`` when given, else ``SERVE_BUCKETS``): seconds to
    ``/readyz`` 200, each library's store books and nvcc runs and the
    capture launches (the runner's logged ``warm start report``), the
    ``warmstart_*`` counters, and P(fake) of every frame and clip (bitwise
    the card CLI)."""
    port = _free_port()
    log_path = OUT / "warm" / f"serve_{name}.log"
    with open(log_path, "w") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "deepfake_detection_tpu_torch.runners.serve",
             *_serve_args(ckpt_path, 600, "cuda", f"--buckets {buckets}"
                          if buckets else "").split(), "--port",
             str(port), "--warmstart-dir", str(store)],
            cwd=tree, env=_tree_env(tree), stdout=log, stderr=subprocess.STDOUT)
        try:
            ready_s = _ready_s(proc, port, t0, log_path)
            report = json.loads(next(
                ln.split("warm start report: ", 1)[1]
                for ln in log_path.read_text().splitlines()
                if "warm start report: " in ln))
            books = {k: int(v) for n, labels, v in
                     _prom(_http(port, "GET", "/metrics")[1])
                     for k in WARM_BOOKS
                     if n == f"dfd_serving_warmstart_{k}_total"}
            single = []
            for f in files:
                st, out = _http(port, "POST", "/score", Path(f).read_bytes())
                if st != 200:
                    raise AssertionError(f"tree {name} /score: {st} {out}")
                single.append(out["fake_score"])
            clip = []
            for j in range(len(cli["clip"])):
                body, ctype = _multipart(Path(f).read_bytes()
                                         for f in files[4 * j:4 * j + 4])
                st, out = _http(port, "POST", "/score", body, ctype)
                if st != 200 or out["frames"] != 4:
                    raise AssertionError(f"tree {name} clip: {st} {out}")
                clip.append(out["fake_score"])
            replays = sum(v / int(labels["bucket"]) for n, labels, v in
                          _prom(_http(port, "GET", "/metrics")[1])
                          if n == "dfd_serving_bucket_rows_total")
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    if [single, clip] != [cli["single"], cli["clip"]]:
        raise AssertionError(f"tree {name}: scores {single} {clip} are not "
                             f"the card CLI's {cli['single']} {cli['clip']}")
    launches = next(iter(report["capture_launches"].values()))
    return dict(ready_s=ready_s, books=books,
                libraries=report["kernels"]["libraries"],
                nvcc_s=report["kernels"]["nvcc_s"],
                captures=len(launches), capture_launches=launches,
                replays=int(round(replays)),
                scores=dict(single=single, clip=clip))


def _warm_backfill(name: str, tree: Path, store: Path, ckpt_path: Path,
                   manifest_path: Path, pack: Path) -> dict:
    """One ``runners.backfill`` worker (one shard) as a child in ``tree``
    on ``store``: its run_end summary."""
    out = OUT / "warm" / f"backfill_{name}"
    shutil.rmtree(out, ignore_errors=True)
    log_path = OUT / "warm" / f"backfill_{name}.log"
    with open(log_path, "w") as log:
        rc = subprocess.run(
            [sys.executable, "-m",
             "deepfake_detection_tpu_torch.runners.backfill", "--manifest",
             str(manifest_path), "--data-packed", str(pack), "--out",
             str(out), "--model-path", str(ckpt_path), "--batch-size",
             str(BACKFILL_BATCH), "--max-shards", "1", "--warmstart-dir",
             str(store), "--device", "cuda"], cwd=tree, env=_tree_env(tree),
            stdout=log, stderr=subprocess.STDOUT, timeout=600).returncode
    if rc != 0:
        raise AssertionError(f"backfill {name} exited {rc}: "
                             f"{log_path.read_text()[-3000:]}")
    end = [r for p in out.glob("telemetry-*.jsonl") for r in
           (json.loads(ln) for ln in p.read_text().splitlines())
           if r.get("event") == "run_end"][-1]
    return {k: end[k] for k in ("warmstart_source", "warmstart_fallback",
                                "warmstart_kernels", "clips_this_proc",
                                "ready_s", "launches", "replays")}


def _flip_library(store: Path, name: str) -> str:
    """Flip one byte in the middle of the stored library ``name``; returns
    its key."""
    for mpath in store.glob("*.json"):
        m = json.loads(mpath.read_text())
        if m.get("kind") == "library" and \
                m["fields"]["geometry"].get("library") == name:
            lib = store / f"{m['key']}.so"
            blob = bytearray(lib.read_bytes())
            blob[len(blob) // 2] ^= 0xFF
            lib.write_bytes(bytes(blob))
            return m["key"]
    raise AssertionError(f"no stored library {name} in {store}")


def _warm_check(name: str, t: dict, sources: list) -> None:
    """Tree ``name``'s libraries, captures and store books: A every
    library a miss and an nvcc run, four captures saved; B every library
    and its two capture manifests hits; C the same but ``WARM_FLIP``, a
    fallback with one nvcc run; 55 forward launches captured a graph."""
    libs = t["libraries"]
    if sorted(libs) != sources:
        raise AssertionError(f"tree {name}: libraries {sorted(libs)}")
    caps = 2 * (len(WARM_A_BUCKETS.split(",")) if name == "A" else 1)
    if t["captures"] != caps or any(
            c.get("depthwise_fwd") != 55
            for c in t["capture_launches"].values()):
        raise AssertionError(f"tree {name}: {t['captures']} captures "
                             f"(expected {caps}), launches "
                             f"{t['capture_launches']}")
    # the books count libraries and capture manifests alike
    if name == "A":
        want = {n: dict(misses=1, nvcc=1, serialized=1) for n in libs}
        books = dict(misses=len(libs) + caps, serialized=len(libs) + caps)
    elif name == "B":
        want = {n: dict(hits=1) for n in libs}
        books = dict(hits=len(libs) + caps)
    else:
        want = {n: dict(hits=1) for n in libs}
        want[WARM_FLIP] = dict(fallbacks=1, nvcc=1, serialized=1)
        books = dict(hits=len(libs) - 1 + caps, fallbacks=1, serialized=1)
    got = {n: {k: v for k, v in c.items() if k in WARM_BOOKS + ("nvcc",)
               and v} for n, c in libs.items()}
    if got != want or {k: v for k, v in t["books"].items() if v} != books:
        raise AssertionError(f"tree {name}: library books {got}, counters "
                             f"{t['books']}; expected {want}, {books}")


def phase_warmstart(ckpt_path: Path, files: list, cli: dict,
                    manifest_path: Path, pack: Path) -> dict:
    """The warm start across fresh checkouts: three trees with no
    ``build/`` start ``runners.serve`` on one store.  A (cold, buckets 1
    and 4: ``WARM_A_BUCKETS``): every library a miss, six nvcc runs,
    libraries and four capture manifests saved.  B (warm, bucket 1 alone:
    ``WARM_BUCKET``): six library hits and its two capture manifests', no
    nvcc, every
    capture canary bitwise, 55 forward launches captured a graph, ready
    sooner by most of A's build seconds.  C (bucket 1): one stored library
    byte flipped, so one fallback (``payload-hash``) and one nvcc run for
    that source alone, the entry rewritten; it starts on a copy of the
    store beside B, which starts on the store beside the backfill workers.
    Scores of all three bitwise the card CLI.  A backfill worker in A then
    in B: ``compile``, then ``store``."""
    warm = OUT / "warm"
    shutil.rmtree(warm, ignore_errors=True)
    warm.mkdir(parents=True)
    store = warm / "store"
    sources = sorted(p.stem for p in
                     (ROOT / "deepfake_detection_tpu_torch" / "csrc").glob(
                         "*.cu"))
    paths = {name: _warm_tree(warm / f"tree{name}") for name in "ABC"}
    trees = {"A": _warm_serve("A", paths["A"], store, ckpt_path, files,
                              cli, WARM_A_BUCKETS)}
    _warm_check("A", trees["A"], sources)
    # tree C on a copy of the store with one library byte flipped, beside
    # tree B on the store and the backfill workers of trees A then B (their
    # ready seconds reported, not held); B's backfill waits for A's, since
    # it needs the manifest A's saves
    store_c = warm / "store_c"
    shutil.copytree(store, store_c)
    flipped = _flip_library(store_c, WARM_FLIP)
    box = {}

    def beside(key, fn, *args):
        try:
            box[key] = fn(*args)
        except BaseException as e:                    # noqa: BLE001
            box[key + "_error"] = repr(e)

    def backfill_a_then_b():
        return {k: _warm_backfill(k, paths[k], store, ckpt_path,
                                  manifest_path, pack) for k in "AB"}

    threads = [threading.Thread(target=beside, args=(
                   "C", _warm_serve, "C", paths["C"], store_c, ckpt_path,
                   files, cli, WARM_BUCKET)),
               threading.Thread(target=beside, args=(
                   "backfill", backfill_a_then_b))]
    for t in threads:
        t.start()
    try:
        trees["B"] = _warm_serve("B", paths["B"], store, ckpt_path, files,
                                 cli, WARM_BUCKET)
    finally:
        for t in threads:
            t.join(timeout=600)
    if "C" not in box or "backfill" not in box:
        raise AssertionError(f"tree C's server or the backfill workers: "
                             f"{box}")
    trees["C"] = box["C"]
    backfill = box["backfill"]
    _warm_check("B", trees["B"], sources)
    _warm_check("C", trees["C"], sources)
    m = json.loads((store_c / f"{flipped}.json").read_text())
    if hashlib.sha256((store_c / f"{flipped}.so").read_bytes()
                      ).hexdigest() != m["sha256"]:
        raise AssertionError("tree C did not rewrite the flipped library's "
                             "entry")
    for name, t in trees.items():
        emit(phase="warmstart_tree", tree=name,
             **{k: v for k, v in t.items() if k != "capture_launches"},
             backfill=backfill.get(name))
    if [backfill["A"]["warmstart_source"],
            backfill["B"]["warmstart_source"]] != ["compile", "store"]:
        raise AssertionError(f"backfill warm sources {backfill}")
    if any(c.get("nvcc") for c in
           backfill["B"]["warmstart_kernels"]["libraries"].values()):
        raise AssertionError(f"backfill in tree B ran nvcc: {backfill['B']}")
    saved = trees["A"]["ready_s"] - trees["B"]["ready_s"]
    if saved < 0.5 * trees["A"]["nvcc_s"]:
        raise AssertionError(f"tree B ready {trees['B']['ready_s']:.2f} s "
                             f"against A's {trees['A']['ready_s']:.2f} s: "
                             f"less than half of A's "
                             f"{trees['A']['nvcc_s']:.2f} s of nvcc saved")
    out = dict(ready_s={k: t["ready_s"] for k, t in trees.items()},
               nvcc_s={k: t["nvcc_s"] for k, t in trees.items()},
               ready_saved_s=saved, build_s_saved=trees["A"]["nvcc_s"]
               - trees["B"]["nvcc_s"],
               backfill_ready_s={k: b["ready_s"] for k, b in
                                 backfill.items()},
               backfill_source={k: b["warmstart_source"] for k, b in
                                backfill.items()},
               launches=sum(55 * t["replays"] for t in trees.values())
               + sum(b["launches"].get("depthwise_fwd", 0)
                     for b in backfill.values()))
    emit(phase="warmstart", **out)
    shutil.rmtree(warm, ignore_errors=True)
    return out


def _kernel_kind(name: str) -> str:
    n = name.lower()
    for kind in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if kind + "_kernel" in n:
            return kind
    if "layer_norm" in n or "gammabeta" in n:
        return "layer_norm"
    if "softmax" in n:
        return "softmax"
    if "dw_fwd_kernel" in n:
        return "depthwise_fwd"
    if "dw_dx_kernel" in n:
        return "depthwise_dx"
    if "dwgrad_partial" in n or "dwgrad_sum" in n:
        return "depthwise_dwgrad"
    if "multi_tensor_apply" in n:
        return "foreach (optimizer, EMA, guard copy)"
    if any(t in n for t in ("conv", "cudnn", "gemm", "xmma", "implicit",
                            "sm90", "cutlass", "dgrad", "wgrad", "nvjet")):
        return "conv_gemm"
    if "reduce" in n:
        return "reduce"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def _device_events(prof, averages=None):
    """The device's events of a torch.profiler run (or of its
    ``key_averages()``, read once by the caller): kernels, copies and
    memsets, without the device-side spans of user annotations (the
    optimizer's ``Optimizer.step#...`` range), which would count the time of
    the kernels they enclose a second time."""
    if averages is None:
        averages = prof.key_averages()
    return [e for e in averages if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _kineto_device(prof):
    """``(µs, launches, top)`` by kernel kind of the same device events as
    :func:`_device_events` (kernels, copies and memsets, no user
    annotations), summed from the profiler's raw kineto events without
    building ``key_averages()`` (which took ~14 s for two AugMix steps of
    ~31,500 launches each)."""
    kinds, launches, top = Counter(), Counter(), Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        kind = _kernel_kind(e.name())
        us = e.duration_ns() / 1e3
        kinds[kind] += us
        launches[kind] += 1
        top[f"{kind}: {e.name()[:70]}"] += us
    return kinds, launches, top


# the profiler's utility ops that its event table leaves out
_HIDDEN_OPS = frozenset({
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"})


def _kineto_host(prof):
    """``(self µs, calls, total µs)`` by op name of the host's ops, from the
    profiler's raw kineto events, as ``key_averages()`` counts them without
    its cost (~20 s a trace of three train steps with host ops): a child is
    an op nested in another's span on its thread; an op that is its
    parent's only child and has its parent's name is folded into the
    parent (the profiler's duplicate nodes); an op's self time is its span
    less its children's (asynchronous events count calls only)."""
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU
              and e.name() not in _HIDDEN_OPS and not e.is_hidden_event()]
    # a runtime call (cudaLaunchKernel, ...) belongs to the thread of the
    # op that made it, as the profiler's table files it
    op_thread = {e.correlation_id(): e.start_thread_id() for e in events
                 if e.linked_correlation_id() == 0}
    calls, async_calls, by_thread = Counter(), Counter(), {}
    for e in events:
        if e.is_async() or e.start_thread_id() != e.end_thread_id():
            async_calls[e.name()] += 1
            continue
        thread = op_thread.get(e.linked_correlation_id(),
                               e.start_thread_id()) \
            if e.linked_correlation_id() > 0 else e.start_thread_id()
        # [start ns, end ns, name, children, parent]
        by_thread.setdefault(thread, []).append(
            [e.start_ns(), e.end_ns(), e.name(), [], None])
    self_us, total = Counter(), Counter()
    for evs in by_thread.values():
        evs.sort(key=lambda v: (v[0], -v[1]))
        stack = []
        for ev in evs:
            while stack and (ev[0] >= stack[-1][1] or ev[1] > stack[-1][1]):
                stack.pop()
            if stack:
                stack[-1][3].append(ev)
                ev[4] = stack[-1]
            stack.append(ev)
        kept = evs
        while True:
            dup = [ev for ev in kept if ev[4] is not None
                   and ev[4][2] == ev[2] and len(ev[4][3]) == 1]
            if not dup:
                break
            for ev in dup:
                parent = ev[4]
                parent[3] = ev[3]
                for child in ev[3]:
                    child[4] = parent
            gone = {id(ev) for ev in dup}
            kept = [ev for ev in kept if id(ev) not in gone]
        for start, end, name, children, _ in kept:
            calls[name] += 1
            total[name] += (end - start) / 1e3
            self_us[name] += (end - start
                              - sum(c[1] - c[0] for c in children)) / 1e3
    return self_us, calls + async_calls, total


def _kineto_check(prof, kinds: Counter, host: Counter) -> dict:
    """The profiler's own ``key_averages()`` table against the kineto
    readings of the same trace: device busy µs and the host ops' self µs
    by each, and the largest difference of one op's self µs."""
    averages = prof.key_averages()
    busy = sum(e.self_device_time_total
               for e in _device_events(prof, averages))
    table = Counter()
    for e in averages:
        if e.device_type == DeviceType.CPU:
            table[e.key] += e.self_cpu_time_total
    return dict(busy_us=[busy, sum(kinds.values())],
                host_self_us=[sum(table.values()), sum(host.values())],
                max_op_self_diff_us=max((abs(table[k] - host[k])
                                         for k in set(table) | set(host)),
                                        default=0.0))


def _emit_kinds(phase: str, prof, n: int, wall_us: float,
                host_ops: bool = True, check: bool = False,
                **extra) -> None:
    """Device time and launches per iteration by kernel kind, the device's
    idle share of the wall time, and the host's CPU time by op (the dtype
    casts apart; "not measured" when the run traced no host ops,
    ``host_ops`` False), from a torch.profiler run of ``n`` iterations,
    read from its raw kineto events (:func:`_kineto_device`,
    :func:`_kineto_host`); with ``check``, the profiler's own table beside
    (``kineto_check``); returns what it printed."""
    kinds, launches, top = _kineto_device(prof)
    host, calls, total = _kineto_host(prof) if host_ops else \
        (Counter(), Counter(), Counter())
    if check:
        extra["kineto_check"] = _kineto_check(prof, kinds, host)
    busy_us = sum(kinds.values())
    if busy_us == 0:
        emit(phase=phase, device_time="not measured", **extra)
        return {}
    # the host side: each op's own CPU time (its children's apart) and
    # calls an iteration, and the dtype casts with their children and their
    # backward nodes
    casts = {k: dict(calls=calls[k] / n, ms=total[k] / n / 1e3)
             for k in ("aten::to", "ToCopyBackward0") if k in total}
    out = dict(phase=phase, iterations=n,
               ms_per_iteration={k: v / n / 1e3 for k, v in kinds.items()},
               launches_per_iteration={k: v / n for k, v in launches.items()},
               busy_ms_per_iteration=busy_us / n / 1e3,
               wall_ms_per_iteration=wall_us / n / 1e3,
               idle_share=max(0.0, 1.0 - busy_us / wall_us),
               top_kernels={k: v / n / 1e3 for k, v in top.most_common(8)},
               host_op_ms_per_iteration=sum(host.values()) / n / 1e3
               if host_ops else "not measured",
               top_host_ops={k: dict(ms=v / n / 1e3, calls=calls[k] / n)
                             for k, v in host.most_common(10)}
               if host_ops else "not measured",
               casts=casts, **extra)
    emit(**out)
    return out


def phase_profile(model, x, iters: int = 3) -> None:
    """Device time by kernel kind over ``iters`` forwards (torch.profiler)
    and the device's idle share of the wall time."""
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _emit_kinds("profile", prof, iters, wall_us, check=True,
                batch=x.shape[0])


_COUNTED = (dw.fused_depthwise, dw.depthwise_dx, dw.depthwise_dwgrad,
            fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)


def _reset_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
        fn.launches_by_dtype.clear()


def _launches(fns, dtype=None):
    return tuple(fn.launches if dtype is None
                 else fn.launches_by_dtype[dtype] for fn in fns)


def _counts(dtype=None):
    """Launches of (depthwise forward, dx, dw gradient) since the reset, of
    every instantiation or of ``dtype``'s ("float32", "bfloat16")."""
    return _launches(_COUNTED[:3], dtype)


def _flash_counts(dtype=None):
    """Launches of (flash forward, dQ, dK/dV) since the reset, of every
    instantiation or of ``dtype``'s."""
    return _launches(_COUNTED[3:], dtype)


def phase_train(frame: str) -> dict:
    """``runners.train`` in-process on the flagship at 12×600², batch 3:
    8 steps, validation of the model and its EMA, checkpoints; then the
    launch counts of one step and its device time by kernel kind."""
    out = OUT / "train"
    shutil.rmtree(out, ignore_errors=True)
    cfg = train_runner.parse_args(TRAIN_FLAGS + ["--output", str(out)])
    init = train_runner.build_model(cfg, "cpu").state_dict()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    result = train_runner.main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, dxl, dwg = _counts()
    peak = torch.cuda.max_memory_allocated()
    steps = len(result["train"]["step_s"])
    n_eval = max(max(TRAIN_BATCH * 8, 16) // 2, 8)    # runners.train.setup
    eval_batches = math.ceil(n_eval / (2 * TRAIN_BATCH))
    want_fwd = 55 * steps + 55 * eval_batches * 2      # model + EMA eval
    if steps != 8 or (fwd, dxl, dwg) != (want_fwd, 55 * steps, 55 * steps):
        raise AssertionError(
            f"train path: {steps} steps, {fwd} forward, {dxl} dx and {dwg} "
            f"dw-gradient launches; expected 8, {want_fwd}, {55 * steps} and "
            f"{55 * steps}")
    if not (np.isfinite(result["train"]["loss"])
            and np.isfinite(result["eval"]["loss"])):
        raise AssertionError(f"non-finite loss: {result}")
    if result["train"]["nonfinite"]:
        raise AssertionError(f"{result['train']['nonfinite']} guarded steps")
    last = Path(result["output_dir"]) / "last.pth.tar"
    ckpt = torch.load(last, map_location="cpu", weights_only=True)
    moved = {}
    for part, sd in (("params", ckpt["state_dict"]),
                     ("ema", ckpt["state_dict_ema"])):
        moved[part] = sum(not torch.equal(v, init[k]) for k, v in sd.items()
                          if not k.endswith(("running_mean", "running_var",
                                             "num_batches_tracked")))
        moved[part + "_bn"] = sum(
            not torch.equal(v, init[k]) for k, v in sd.items()
            if k.endswith(("running_mean", "running_var")))
    if not all(moved.values()):
        raise AssertionError(f"state did not move in training: {moved}")
    score = runner.test_img(str(last), [frame], size=600, device="cuda")
    if not (len(score) == 1 and 0.0 <= score[0] <= 1.0):
        raise AssertionError(f"checkpoint scored {score}")
    step_s = result["train"]["step_s"][1:]        # the first one warms up
    ms_step = float(np.mean(step_s)) * 1e3
    numbers = dict(ms_per_step=ms_step, samples_per_s=TRAIN_BATCH / (
        ms_step / 1e3), peak_mem_gib=peak / 2 ** 30,
        host_wait_ms_per_step=result["loader"]["host_wait_s"]
        / result["loader"]["batches"] * 1e3)
    emit(phase="train", steps=steps, forward_launches=fwd,
         dx_launches=dxl, dwgrad_launches=dwg, loss=result["train"]["loss"],
         eval_loss=result["eval"]["loss"], moved_leaves=moved,
         checkpoint=str(last.relative_to(ROOT)), score=score[0],
         step_ms=[v * 1e3 for v in step_s], wall_s=wall, **numbers)
    del result, ckpt, init
    gc.collect()
    torch.cuda.empty_cache()

    run = train_runner.setup(cfg)
    batches = list(itertools.islice(iter(run.train_loader), 4))
    run.train_step(run.state, *batches[0])
    torch.cuda.synchronize()
    _reset_counts()
    run.train_step(run.state, *batches[1])
    torch.cuda.synchronize()
    per_step = _counts()
    if per_step != (55, 55, 55):
        raise AssertionError(f"one train step launched {per_step} "
                             f"(forward, dx, dw-gradient); expected "
                             f"(55, 55, 55)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in batches[2:]:
            run.train_step(run.state, x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = _emit_kinds("train_profile", prof, len(batches) - 2, wall_us,
                        batch=TRAIN_BATCH)
    del run, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(forward_launches=fwd, dx_launches=dxl, dwgrad_launches=dwg,
                idle_share=kinds.get("idle_share"), **numbers)


def make_clip_tree(root: Path, seed: int = 0) -> Path:
    """A seeded clip tree of uint8 ``.npy`` frames at ``TREE_HW``² (4×4
    blocks of noise, so warps and blurs see structure), some clips shorter
    than 4 frames, more fakes than reals, and the ``name:num`` lists."""
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed)
    q = TREE_HW // 4
    for kind, n in (("real", TREE_REALS), ("fake", TREE_FAKES)):
        lines = []
        for c in range(n):
            nf = (2, 3, 4, 5, 6, 4)[c % 6]
            d = root / kind / f"clip{c:03d}"
            d.mkdir(parents=True)
            for i in range(nf):
                block = rng.integers(0, 256, (q, q, 3), dtype=np.uint8)
                np.save(d / f"{i}.npy", np.repeat(np.repeat(block, 4, 0), 4,
                                                  1))
            lines.append(f"clip{c:03d}:{nf}\n")
        (root / f"{kind}_list.txt").write_text("".join(lines))
    return root


def _stage_ms(fn, iters: int = 5) -> float:
    """Device ms of a call of ``fn``: its kernels and copies summed over
    ``iters`` calls by torch.profiler (after a warm-up), per call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in _device_events(prof)) / iters / 1e3


def _grey_diff(got: torch.Tensor, want: torch.Tensor):
    d = (got.double().cpu() - want.double().cpu()).abs()
    return float((d > 0).double().mean()), float(d.max())


def phase_prologue(run) -> dict:
    """One train batch through the prologue on the card and on the CPU,
    stage by stage from the same input (the draws made on the CPU, moved to
    the card), and each stage's device ms on the card."""
    dl = run.train_loader
    gen = iter(dl.loader)
    hb = next(gen)
    gen.close()
    card = dl.to_device(hb)
    pro = dl.prologue
    cpu = Prologue("cpu", img_num=pro.img_num, spec=pro.spec)
    p_cpu, p_card = hb.params, card.params
    out = {}
    w_cpu = cpu.warp(hb.images, p_cpu["coeffs"])
    w_card = pro.warp(card.images, p_card["coeffs"])
    out["warp_frac"], out["warp_max"] = _grey_diff(w_card, w_cpu)
    # integer coefficients (scale 1, no rotation) from the same samples
    spec1 = DeviceAugmentSpec(size=pro.spec.size, scale=(1.0, 1.0),
                              img_num=pro.img_num)
    k1 = torch.from_numpy(derive_geometric_batch(
        spec1, hb.indices, dl.loader.seed, 0, hb.images.shape[1:3])[0])
    int_equal = torch.equal(
        cpu.warp(hb.images, k1),
        pro.warp(card.images, k1.to(DATA_DEVICE)).cpu())
    # the later stages from the CPU's input on both sides; every frame
    # blurred when no coin fired in this batch
    frames = p_cpu["blur"] or [(b, f) for b in range(hb.images.shape[0])
                               for f in range(pro.img_num)]
    b_cpu = cpu.blur(w_cpu.clone(), frames)
    b_card = pro.blur(w_cpu.to(DATA_DEVICE), frames)
    out["blur_frac"], out["blur_max"] = _grey_diff(b_card, b_cpu)
    j_cpu = cpu.jitter(b_cpu.clone(), p_cpu["jitter"])
    j_card = pro.jitter(b_cpu.to(DATA_DEVICE), p_cpu["jitter"])
    out["jitter_max"] = _grey_diff(j_card, j_cpu)[1]
    m_cpu = cpu.blend(j_cpu, p_cpu["lam"])
    blend_equal = torch.equal(
        pro.blend(j_cpu.to(DATA_DEVICE), p_cpu["lam"]).cpu(), m_cpu)
    n_cpu = cpu.normalize(m_cpu)
    norm_equal = torch.equal(pro.normalize(m_cpu.to(DATA_DEVICE)).cpu(), n_cpu)
    # erasing: this batch's boxes, or, when it drew none, boxes drawn at
    # probability 1 with the run's other settings
    boxes = p_cpu["erase"] or draw_random_erasing(
        torch.Generator().manual_seed(0), *n_cpu.shape,
        img_num=pro.img_num, **{**dl.erasing, "probability": 1.0})
    e_cpu = cpu.erase(n_cpu.clone(), boxes)
    e_card = pro.erase(n_cpu.to(DATA_DEVICE), [
        bx._replace(fill=None if bx.fill is None
                    else bx.fill.to(DATA_DEVICE)) for bx in boxes])
    erase_equal = torch.equal(e_card.cpu(), e_cpu)
    whole_cpu = cpu(hb.images, p_cpu)
    whole_card = pro(card.images, p_card)
    std = (1.0 / pro.inv_std).cpu()
    d = ((whole_card.cpu() - whole_cpu).permute(0, 2, 3, 1) * std).abs()
    out.update(integer_warp_bitwise=int_equal, blend_bitwise=blend_equal,
               normalize_bitwise=norm_equal, erase_bitwise=erase_equal,
               erase_boxes=len(boxes), batch_erase_boxes=len(p_cpu["erase"]),
               blur_frames=len(frames),
               whole_frac=float((d > 1e-3).double().mean()),
               whole_max_grey=float(d.max()))
    if not (int_equal and blend_equal and norm_equal and erase_equal
            and out["warp_frac"] <= WARP_FRAC and out["warp_max"] <= WARP_MAX
            and out["blur_frac"] <= WARP_FRAC and out["blur_max"] <= WARP_MAX
            and out["jitter_max"] <= JITTER_ATOL):
        raise AssertionError(f"prologue, card against CPU: {out}")
    # device ms of each stage on the card's batch
    x = w_card
    ms = {"h2d": _stage_ms(lambda: dl.to_device(hb)),
          "warp": _stage_ms(lambda: pro.warp(card.images, p_card["coeffs"])),
          "blur": _stage_ms(lambda: pro.blur(x.clone(), p_card["blur"])),
          "jitter": _stage_ms(lambda: pro.jitter(x.clone(),
                                                 p_card["jitter"])),
          "blend": _stage_ms(lambda: pro.blend(x, p_card["lam"])),
          "normalize": _stage_ms(lambda: pro.normalize(x)),
          "erase": _stage_ms(lambda: pro.erase(x.clone(), p_card["erase"])),
          "whole": _stage_ms(lambda: pro(card.images, p_card))}
    out["device_ms"] = ms
    out["blur_frames_in_batch"] = len(p_card["blur"])
    return out


OBS_PROFILE_STEPS = 2             # --profile-capture of the observed runs
OBS_OFF_OUT = OUT / "train_data_off"
# each kernel's name in a trace, and the launch counter it must equal
OBS_KERNELS = {"depthwise_fwd": "dw_fwd_kernel", "depthwise_dx": "dw_dx_kernel",
               "depthwise_dwgrad": "dwgrad_partial",
               "flash_fwd": "flash_fwd_kernel",
               "flash_bwd_dq": "flash_bwd_dq_kernel",
               "flash_bwd_dkv": "flash_bwd_dkv_kernel"}


def _run_dir(cfg) -> Path:
    """The run directory ``runners.train`` makes for ``cfg`` (a fresh
    output directory, so without a ``-N`` suffix)."""
    return Path(cfg.output) / (cfg.experiment or "-".join([
        cfg.model_version or cfg.model,
        os.path.basename(cfg.data.split(":")[0]) or cfg.dataset]))


def _observed_main(cfg) -> tuple:
    """``train_runner.main(cfg)`` with the synchronizing calls of its train
    loops counted (``torch.cuda.set_sync_debug_mode`` warnings raised with
    ``train/trainer.py`` on the stack, by call site; those of
    ``obs/profiler.py``, the capture window's own, and any other, such as a
    finalizer run as the epoch returns, apart) and, when
    the run has telemetry, ``/metrics`` scraped while it trains and a
    ``PROFILE`` trigger dropped into its run directory once it writes
    telemetry.  Returns ``(result, observations)``."""
    import traceback
    import warnings

    run_dir = _run_dir(cfg)
    seen = dict(syncs=0, profiler_syncs=0, other_syncs=Counter(),
                sync_sites=Counter(), scrape=None, profile_touched=False)
    real = train_runner.train_one_epoch
    profiler_py = os.path.join("obs", "profiler.py")
    trainer_py = os.path.join("train", "trainer.py")

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message).lower():
            return
        stack = traceback.extract_stack()[:-1]
        site = next((fr for fr in reversed(stack)
                     if "deepfake_detection_tpu_torch" in fr.filename),
                    stack[-1])
        site = f"{os.path.basename(site.filename)}:{site.lineno}"
        if any(fr.filename.endswith(profiler_py) for fr in stack):
            seen["profiler_syncs"] += 1
        elif any(fr.filename.endswith(trainer_py) for fr in stack):
            seen["syncs"] += 1
            seen["sync_sites"][site] += 1
        else:
            seen["other_syncs"][" < ".join(
                f"{os.path.basename(fr.filename)}:{fr.lineno}"
                for fr in stack[-4:])] += 1

    def counted(*a, **k):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return real(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    done = threading.Event()

    def watch():
        while not done.is_set():
            if cfg.metrics_port and not seen["profile_touched"] and \
                    (run_dir / "telemetry.jsonl").exists():
                (run_dir / TRIGGER).touch()
                seen["profile_touched"] = True
            if cfg.metrics_port and seen["scrape"] is None:
                try:
                    st, text = _http(cfg.metrics_port, "GET", "/metrics",
                                     timeout=5)
                    hz = _http(cfg.metrics_port, "GET", "/healthz",
                               timeout=5)
                except OSError:
                    st = None
                if st == 200:
                    got = {n: v for n, labels, v in _prom(text)
                           if not labels}
                    if got.get("dfd_train_steps_total", 0) >= 1:
                        seen["scrape"] = dict(
                            steps_total=got["dfd_train_steps_total"],
                            families=len(got), healthz=hz,
                            mfu=got.get("dfd_train_mfu"),
                            fwd_gflops_per_sample=got.get(
                                "dfd_train_model_fwd_gflops_per_sample"))
            time.sleep(0.05)

    watcher = threading.Thread(target=watch, daemon=True)
    train_runner.train_one_epoch = counted
    if not cfg.no_telemetry:
        watcher.start()
    try:
        result = train_runner.main(cfg)
    finally:
        done.set()
        train_runner.train_one_epoch = real
        if watcher.is_alive():
            watcher.join(timeout=30)
    seen["run_dir"] = run_dir
    return result, seen


def _obs_checks(name: str, run_dir: Path, seen: dict, steps: int,
                per_step: dict) -> dict:
    """The run's telemetry: one record a drain (``--log-interval 1``: one a
    step), data + device + host = the window in each, an MFU gauge > 0,
    ``/metrics`` scraped mid-run, and the ``PROFILE`` trigger's trace
    naming the path's kernels with ``per_step`` launches a step each."""
    recs = [json.loads(ln) for ln in
            (run_dir / "telemetry.jsonl").read_text().splitlines()]
    metrics = [r for r in recs if r["type"] == "metrics"]
    events = [r["event"] for r in recs if r["type"] == "event"]
    sums = [m["data_wait_frac"] + m["device_wait_frac"] + m["host_frac"]
            for m in metrics]
    caps = sorted((run_dir / "profile").glob("ondemand-*/kernels.json"))
    if len(metrics) != steps or any(abs(v - 1.0) > 2e-4 for v in sums) \
            or not metrics[-1]["mfu"] > 0 or min(m["mfu"] for m in
                                                 metrics) < 0:
        raise AssertionError(f"{name}: {len(metrics)} telemetry records for "
                             f"{steps} steps, breakdown sums {sums}, mfu "
                             f"{[m['mfu'] for m in metrics]}")
    if seen["scrape"] is None:
        raise AssertionError(f"{name}: /metrics never answered mid-run")
    if len(caps) != 1 or "profile_capture" not in events or \
            (run_dir / TRIGGER).exists():
        raise AssertionError(f"{name}: profile captures {caps}, events "
                             f"{events}")
    trace = json.loads(caps[0].read_text())
    got = {k: sum(v["launches"] for n, v in trace["kernels"].items()
                  if OBS_KERNELS[k] in n) / trace["steps"] for k in per_step}
    if got != per_step or not (caps[0].parent / "trace.json").is_file():
        raise AssertionError(f"{name}: the trace's kernels a step {got}, "
                             f"expected {per_step}")
    window = int(caps[0].parent.name.split("-")[1])
    last = metrics[-1]
    return dict(records=len(metrics), breakdown_sum_max_err=max(
                    abs(v - 1.0) for v in sums),
                mfu=[m["mfu"] for m in metrics],
                mfu_last=last["mfu"], imgs_per_s_last=last["imgs_per_s"],
                data_wait_frac=last["data_wait_frac"],
                device_wait_frac=last["device_wait_frac"],
                host_frac=last["host_frac"], scrape=seen["scrape"],
                trace_kernels_per_step=got,
                # the batches the window spans: its warm-up step, then the
                # recorded ones
                profile_window=[window, window + trace["steps"] + 1],
                events=events, syncs_per_drain=seen["syncs"] / len(metrics))


def _tree_train(name: str, cfg, frame: str, dtype: str) -> dict:
    """``runners.train`` in-process on the flagship from a clip tree, one
    epoch: 55/55/55 depthwise launches a step and 55 forward launches an
    eval batch, every one of ``dtype``'s instantiation; loss finite, no
    guarded step, params and BN stats moved, the checkpoint scores a frame;
    then one step's launches and a profile of three steps fed by the
    loader.  Returns the numbers, the profile's, the launches and the
    profiled run (for more checks)."""
    train_ds, eval_ds = train_runner.build_datasets(cfg)
    want_steps = len(train_ds) // TRAIN_BATCH
    eval_batches = math.ceil(len(eval_ds) / (2 * TRAIN_BATCH))
    init = train_runner.build_model(cfg, "cpu").state_dict()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    result, seen = _observed_main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    flash = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = len(result["train"]["step_s"])
    want = (55 * (steps + eval_batches), 55 * steps, 55 * steps)
    seen["step_s"] = list(result["train"]["step_s"])
    if steps < 8 or steps != want_steps or flash != (0, 0, 0) or \
            launches != want or _counts(dtype) != want:
        raise AssertionError(
            f"{name}: {steps} steps, (forward, dx, dw-gradient) launches "
            f"{launches}, {_counts(dtype)} of them {dtype}, flash {flash}; "
            f"expected {want_steps} (≥ 8), {want}, all {dtype}, none")
    if not (np.isfinite(result["train"]["loss"])
            and np.isfinite(result["eval"]["loss"])):
        raise AssertionError(f"non-finite loss: {result}")
    if result["train"]["nonfinite"]:
        raise AssertionError(f"{result['train']['nonfinite']} guarded steps")
    out_dir = Path(result["output_dir"])
    last = out_dir / "last.pth.tar"
    sd = torch.load(last, map_location="cpu", weights_only=True)["state_dict"]
    stats = ("running_mean", "running_var")
    counters = stats + ("num_batches_tracked",)
    moved = {"params": sum(not torch.equal(v, init[k]) for k, v in sd.items()
                           if not k.endswith(counters)),
             "bn": sum(not torch.equal(v, init[k]) for k, v in sd.items()
                       if k.endswith(stats))}
    if not all(moved.values()):
        raise AssertionError(f"state did not move in training: {moved}")
    score = runner.test_img(str(last), [frame], size=600,
                            device=DATA_DEVICE)
    if not (len(score) == 1 and 0.0 <= score[0] <= 1.0):
        raise AssertionError(f"checkpoint scored {score}")
    step_s = result["train"]["step_s"][1:]
    ms_step = float(np.mean(step_s)) * 1e3
    loader = result["loader"]
    numbers = dict(loss=result["train"]["loss"],
                   eval_loss=result["eval"]["loss"], ms_per_step=ms_step,
                   samples_per_s=TRAIN_BATCH / (ms_step / 1e3),
                   peak_mem_gib=peak / 2 ** 30,
                   host_wait_ms_per_step=loader["host_wait_s"]
                   / loader["batches"] * 1e3,
                   fetch_ms_per_batch=loader["fetch_s"]
                   / loader["batches"] * 1e3)
    info = dict(steps=steps, eval_batches=eval_batches,
                train_samples=len(train_ds), eval_samples=len(eval_ds),
                moved_leaves=moved, checkpoint=str(last.relative_to(ROOT)),
                score=score[0], step_ms=[v * 1e3 for v in step_s],
                wall_s=wall, files=sorted(p.name for p in out_dir.iterdir()))
    del result, sd, init
    gc.collect()
    torch.cuda.empty_cache()

    # one step's launches and a profiled run of steps fed by the loader
    run = train_runner.setup(cfg)
    run.train_loader.set_epoch(0)
    it = iter(run.train_loader)
    run.train_step(run.state, *next(it))
    torch.cuda.synchronize()
    _reset_counts()
    run.train_step(run.state, *next(it))
    torch.cuda.synchronize()
    if _counts(dtype) != (55, 55, 55):
        raise AssertionError(f"one train step launched {_counts()}, "
                             f"{_counts(dtype)} of them {dtype}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            run.train_step(run.state, *next(it))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    it.close()
    kinds = _emit_kinds(name + "_profile", prof, 3, wall_us,
                        batch=TRAIN_BATCH, dtype=dtype)
    numbers.update(idle_share=kinds.get("idle_share"),
                   busy_ms_per_step=kinds.get("busy_ms_per_iteration"),
                   launches_per_step=sum(kinds.get(
                       "launches_per_iteration", {}).values()) or None,
                   device_ms_by_kind=kinds.get("ms_per_iteration"))
    return dict(numbers=numbers, info=info, run=run, seen=seen,
                launches=dict(zip(("forward_launches", "dx_launches",
                                   "dwgrad_launches"), launches)))


def _telemetry_off(root: Path, tr: dict, obs: dict) -> dict:
    """The same tree run with ``--no-telemetry``: the same launches a step,
    the same synchronizing calls a drain, and step ms within the
    telemetry run's spread (its profiled steps and the first left out)."""
    out = OBS_OFF_OUT
    shutil.rmtree(out, ignore_errors=True)
    cfg = train_runner.parse_args(DATA_FLAGS + [
        "--data", str(root), "--output", str(out), "--no-telemetry"])
    _reset_counts()
    result, seen = _observed_main(cfg)
    torch.cuda.synchronize()
    steps = len(result["train"]["step_s"])
    on_steps = tr["info"]["steps"]
    per = {k: v / (steps + (tr["info"]["eval_batches"] if k ==
                            "forward_launches" else 0))
           for k, v in zip(("forward_launches", "dx_launches",
                            "dwgrad_launches"), _counts())}
    per_on = {k: v / (on_steps + (tr["info"]["eval_batches"] if k ==
                                  "forward_launches" else 0))
              for k, v in tr["launches"].items()}
    syncs = seen["syncs"] / steps
    lo, hi = obs["profile_window"]
    on = [v for i, v in enumerate(tr["seen"]["step_s"])
          if i > 0 and not lo <= i < hi]
    off = result["train"]["step_s"][1:]
    gap = abs(float(np.median(on)) - float(np.median(off)))
    spread = max(max(on) - min(on), max(off) - min(off))
    shutil.rmtree(out, ignore_errors=True)
    row = dict(steps=steps, launches_per_step=per,
               launches_per_step_on=per_on, syncs_per_drain=syncs,
               syncs_per_drain_on=obs["syncs_per_drain"],
               sync_sites=dict(seen["sync_sites"]),
               sync_sites_on=dict(tr["seen"]["sync_sites"]),
               profiler_syncs_on=tr["seen"]["profiler_syncs"],
               other_syncs=dict(seen["other_syncs"]),
               other_syncs_on=dict(tr["seen"]["other_syncs"]),
               step_ms_median=float(np.median(off)) * 1e3,
               step_ms_median_on=float(np.median(on)) * 1e3,
               spread_ms=spread * 1e3, telemetry_file=(
                   seen["run_dir"] / "telemetry.jsonl").exists())
    if per != per_on or syncs != obs["syncs_per_drain"] or gap > spread \
            or row["telemetry_file"]:
        raise AssertionError(f"telemetry changed the step: {row}")
    return row


def fixture_tree(root: Path, ext: str) -> Path:
    """``make_clip_tree``'s clips and lists with frame ``i`` of every clip
    the 640² fixture ``face{i % 4}``: as that JPEG (``ext`` "jpg", no
    ``.npy`` beside it) or as its decode (``ext`` "npy")."""
    shutil.rmtree(root, ignore_errors=True)
    faces = [jpeg_bytes(n) for n in JPEG_FACES]
    decoded = [jpeg_native.decode_jpeg_bytes(b) for b in faces]
    for kind, n in (("real", TREE_REALS), ("fake", TREE_FAKES)):
        lines = []
        for c in range(n):
            nf = (2, 3, 4, 5, 6, 4)[c % 6]
            d = root / kind / f"clip{c:03d}"
            d.mkdir(parents=True)
            for i in range(nf):
                if ext == "jpg":
                    (d / f"{i}.jpg").write_bytes(faces[i % 4])
                else:
                    np.save(d / f"{i}.npy", decoded[i % 4])
            lines.append(f"clip{c:03d}:{nf}\n")
        (root / f"{kind}_list.txt").write_text("".join(lines))
    return root


def _train_steps(run, cfg, steps: int, profile_as: str = "",
                 profile_steps: int = 3, host_ops: bool = True) -> dict:
    """``steps`` train steps of ``run`` (``runners.train``'s setup, shared
    by the rows of a phase: a model is built once) fed by ``cfg``'s train
    loader, each synchronized: ms a step (from the loader's call to the
    step's end) and the host's wait in the loader, the first step left
    out of both means; the losses and each batch's rows; with
    ``profile_as``, a profile of ``profile_steps`` more steps fed by the
    loader (device time by kind, idle share; the host's ops by time unless
    ``host_ops`` is False, which leaves them out of the trace and its
    reading, a third of the events) and its seconds, the trace's reading
    included; this thread's CPU ms a step up to the step's return (the
    dispatching thread's); on the shm transport the ring's occupancy
    before each step, the collect wait and the copy out of the slab a
    batch.  Steps past an epoch's batches go on into the next epoch.  The
    loader is closed at the end."""
    run.train_loader, _ = train_runner.build_loaders(
        cfg, run.device, *train_runner.build_datasets(cfg))
    host = run.train_loader.loader

    def epochs():
        for epoch in itertools.count():
            run.train_loader.set_epoch(epoch)
            yield from run.train_loader

    it = epochs()
    step_ms, wait_ms, losses_, rows, cpu_ms, occupancy = [], [], [], [], \
        [], []
    for _ in range(steps):
        if hasattr(host, "ring_depth"):
            occupancy.append(host.inflight_batches / host.ring_depth)
        t0 = time.perf_counter()
        c0 = time.thread_time()
        x, y = next(it)
        t1 = time.perf_counter()
        m = run.train_step(run.state, x, y)
        # this thread's CPU from the loader's call to the step's return
        # (the synchronize, which may spin, left out)
        cpu_ms.append((time.thread_time() - c0) * 1e3)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        wait_ms.append((t1 - t0) * 1e3)
        losses_.append(float(m["loss"]))
        rows.append(int(x.shape[0]))
    kinds = {}
    t_prof = time.perf_counter()
    if profile_as:
        activities = [ProfilerActivity.CUDA]
        if host_ops:
            activities.append(ProfilerActivity.CPU)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(profile_steps):
                run.train_step(run.state, *next(it))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kinds = _emit_kinds(profile_as, prof, profile_steps, wall_us,
                            host_ops, batch=TRAIN_BATCH)
    it.close()
    stats = host.stats
    nb = max(1, stats.batches)
    fetch = stats.fetch_s / nb * 1e3
    shm = dict(ring_occupancy=occupancy,
               collect_wait_ms_per_batch=host.collect_wait_s / nb * 1e3,
               copy_ms_per_batch=host.copy_s / nb * 1e3,
               respawns=host.respawn_count, ring_depth=host.ring_depth,
               workers=host.num_workers) \
        if hasattr(host, "ring_depth") else {}
    run.train_loader.close()
    return dict(ms_per_step=float(np.mean(step_ms[1:])),
                host_wait_ms_per_step=float(np.mean(wait_ms[1:])),
                dispatch_cpu_ms_per_step=float(np.mean(cpu_ms[1:])),
                fetch_ms_per_batch=fetch, step_ms=step_ms, wait_ms=wait_ms,
                dispatch_cpu_ms=cpu_ms, loss=losses_, rows=rows,
                profile_s=time.perf_counter() - t_prof,
                idle_share=kinds.get("idle_share"),
                busy_ms_per_step=kinds.get("busy_ms_per_iteration"),
                host_op_ms_per_step=kinds.get("host_op_ms_per_iteration"),
                **shm)


def _train_jpeg(main_numbers: dict) -> dict:
    """The train tree as JPEG frames only (the four 640² fixtures) and as
    the ``.npy`` of their decodes: the first batch of each loader bitwise
    equal; ``JPEG_TRAIN_STEPS`` steps of each with ``scripts/train.sh``'s
    data and augment flags (f32) on the flagship cut to ``CUT_BLOCKS``
    blocks, ms a step and host wait side by side; ``CUT_BLOCKS`` launches
    of each depthwise kernel a step, counted for each tree's run alone
    (the ``.npy`` twin's are returned apart, for the train_data path)."""
    jroot = fixture_tree(OUT / "tree_jpeg", "jpg")
    nroot = fixture_tree(OUT / "tree_jpeg_npy", "npy")
    out = OUT / "train_jpeg"
    cfgs = {k: train_runner.parse_args(DATA_FLAGS + [
        "--data", str(r), "--output", str(out)])
        for k, r in (("jpeg", jroot), ("npy", nroot))}
    first = {}
    for k, c in cfgs.items():
        tl, _ = train_runner.build_loaders(c, torch.device(DATA_DEVICE),
                                           *train_runner.build_datasets(c))
        tl.set_epoch(0)
        it = iter(tl)
        first[k] = next(it)
        it.close()
    bitwise = torch.equal(first["jpeg"][0], first["npy"][0]) and \
        torch.equal(first["jpeg"][1], first["npy"][1])
    del first
    rows, counts = {}, {}
    run = _on_cut_flagship(train_runner.setup)(cfgs["jpeg"])
    for k, c in cfgs.items():
        _reset_counts()
        rows[k] = _train_steps(run, c, JPEG_TRAIN_STEPS)
        counts[k] = _counts()
    del run
    gc.collect()
    torch.cuda.empty_cache()
    launches = counts["jpeg"]
    want = (CUT_BLOCKS * JPEG_TRAIN_STEPS,) * 3
    shutil.rmtree(out, ignore_errors=True)
    emit(phase="train_jpeg", nvidia_smi=nvidia_smi_line(),
         first_batch_bitwise=bitwise, steps=JPEG_TRAIN_STEPS,
         jpeg=rows["jpeg"], npy=rows["npy"], train_data=dict(
             ms_per_step=main_numbers["ms_per_step"],
             host_wait_ms_per_step=main_numbers["host_wait_ms_per_step"]),
         launches=launches, npy_launches=counts["npy"],
         expected_launches=want, fixtures=list(JPEG_FACES))
    if not bitwise or launches != want or counts["npy"] != want or not all(
            np.isfinite(r["loss"]).all() for r in rows.values()):
        raise AssertionError(f"the JPEG tree: first batch bitwise "
                             f"{bitwise}, launches {counts} (expected "
                             f"{want} each), losses "
                             f"{[r['loss'] for r in rows.values()]}")
    keys = ("forward_launches", "dx_launches", "dwgrad_launches")
    return dict(zip(keys, launches), npy=dict(zip(keys, counts["npy"])),
                rows=rows)


def phase_train_data(frame: str, synthetic: dict) -> dict:
    """``runners.train`` from a clip tree with ``scripts/train.sh``'s data
    and augment flags on the flagship, f32; the prologue card against CPU;
    a pack of the tree against the tree."""
    root = make_clip_tree(OUT / "tree")
    out = OUT / "train_data"
    shutil.rmtree(out, ignore_errors=True)
    cfg = train_runner.parse_args(DATA_FLAGS + [
        "--data", str(root), "--output", str(out), "--metrics-port",
        str(_free_port()), "--profile-capture", str(OBS_PROFILE_STEPS)])
    tr = _tree_train("train_data", cfg, frame, "float32")
    prologue = phase_prologue(tr["run"])
    del tr["run"]
    gc.collect()
    torch.cuda.empty_cache()
    steps = tr["info"]["steps"]
    obs = _obs_checks("train_data", tr["seen"]["run_dir"], tr["seen"],
                      steps, {k: 55 for k in ("depthwise_fwd", "depthwise_dx",
                                              "depthwise_dwgrad")})
    obs["telemetry_off"] = _telemetry_off(root, tr, obs)
    emit(phase="obs", path="train_data", nvidia_smi=nvidia_smi_line(), **obs)

    # the packed cache of the same tree: the first two batches bitwise
    t0 = time.perf_counter()
    index = write_pack(str(root), str(OUT / "pack"), workers=8, force=True)
    pack_s = time.perf_counter() - t0
    cfg_p = train_runner.parse_args(DATA_FLAGS + [
        "--data", str(root), "--data-packed", str(OUT / "pack"),
        "--output", str(out)])
    pairs = []
    for c in (cfg, cfg_p):
        tl, _ = train_runner.build_loaders(c, torch.device(DATA_DEVICE),
                                           *train_runner.build_datasets(c))
        tl.set_epoch(0)
        pairs.append(list(itertools.islice(iter(tl), 2)))
    packed_equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                       for a, b in zip(*pairs))
    if not packed_equal or len(pairs[1]) != 2:
        raise AssertionError("packed batches differ from the tree's")
    info = tr["info"]
    emit(phase="train_data", dtype="float32", **tr["launches"], **info,
         prologue=prologue,
         pack={"write_s": pack_s, "clips": len(index["clips"]),
               "bytes": sum(int(s_["num_samples"]) for s_ in index["shards"])
               * TREE_HW * TREE_HW * 12, "first_two_batches_bitwise": True},
         synthetic=synthetic, **tr["numbers"])
    jpeg = _train_jpeg(tr["numbers"])
    # the .npy twin of the JPEG tree is this path's tree again
    return dict(root=root, numbers=tr["numbers"], jpeg=jpeg,
                **{k: n + jpeg["npy"][k] for k, n in tr["launches"].items()})


def train_sh_flags(root: Path) -> list:
    """``scripts/train.sh``'s argument list for the runner, as that script
    passes it (``--amp``, ``--auto-resume``, ``--recovery-interval 500``,
    ...), with ``root`` as its clip tree."""
    text = (ROOT / "scripts" / "train.sh").read_text()
    body = text.split(".runners.train \\\n", 1)[1].split('"${@:2}"')[0]
    words = [w.strip('"') for w in body.replace("\\\n", " ").split()]
    return [{"$1": str(root), "${DFD_EXPERIMENT:-flagship}": "flagship"}.get(
        w, w) for w in words]


# the bf16 runs from the tree: train.sh's whole argument list, then one
# epoch (8 steps), a recovery snapshot every 3 batches and each step's
# metrics read back
AMP_OVERRIDES = ["--epochs", "1", "--recovery-interval", "3",
                 "--log-interval", "1", "--augment-device", "on"]


AMP_CKPT = OUT / "train_amp_last.pth.tar"


def _amp_cfg(root: Path, out: Path):
    cfg = train_runner.parse_args(train_sh_flags(root) + AMP_OVERRIDES
                                  + ["--output", str(out)])
    if not (cfg.amp and cfg.auto_resume and cfg.recovery_interval == 3
            and train_runner.model_dtype(cfg) == torch.bfloat16):
        raise AssertionError(f"train.sh's flags parsed to {cfg}")
    return cfg


def phase_train_amp(frame: str, root: Path, f32: dict) -> dict:
    """The flagship at 12×600², batch 3, from the seeded tree with
    ``scripts/train.sh``'s whole argument list (``--amp``, ``--auto-resume``,
    ``--recovery-interval 3``), one epoch: every depthwise launch of the
    bf16 instantiations (55/55/55 a step), recovery snapshots written, and
    the numbers beside the f32 tree phase's of the same run."""
    out = OUT / "train_amp"
    shutil.rmtree(out, ignore_errors=True)
    tr = _tree_train("train_amp", _amp_cfg(root, out), frame, "bfloat16")
    snaps = [f for f in tr["info"]["files"] if f.startswith("recovery-")]
    if not snaps:
        raise AssertionError(f"no recovery snapshot in {tr['info']['files']}")
    del tr["run"]
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="train_amp", dtype="bfloat16", **tr["launches"],
         **tr["info"], recovery_snapshots=snaps, train_data_f32=f32,
         **tr["numbers"])
    # its checkpoint seeds train_accum's --initial-checkpoint row
    os.replace(ROOT / tr["info"]["checkpoint"], AMP_CKPT)
    shutil.rmtree(out, ignore_errors=True)
    return dict(numbers=tr["numbers"], **tr["launches"])


def _on_cut_flagship(phase):
    """``phase`` with ``runners.train`` building the flagship at full width
    cut to its first ``CUT_BLOCKS`` blocks (``_flagship_cut``'s depth), so
    an earlier path runs at a fraction of the full step's and checkpoint's
    cost: ``CUT_BLOCKS`` depthwise launches a forward, not 55."""
    @functools.wraps(phase)
    def run(*args, **kwargs):
        real = train_runner._MODEL_FACTORIES["v4"]
        train_runner._MODEL_FACTORIES["v4"] = functools.partial(
            real, depth_multiplier=CUT_DEPTH)
        try:
            return phase(*args, **kwargs)
        finally:
            train_runner._MODEL_FACTORIES["v4"] = real
    return run


@_on_cut_flagship
def phase_train_host(root: Path, host: dict) -> dict:
    """``scripts/train_torch.sh``'s command line as it stands (the host
    chain, ``--augment-device off`` by default) on the seeded tree, the
    flagship at full width cut to ``CUT_BLOCKS`` blocks:
    ``HOST_TRAIN_STEPS`` steps through the bf16 depthwise kernels, beside
    the same steps of the same model with ``--augment-device on``'s
    loader, and a profile of three more steps of the host-chain row (the
    device chain's profile is ``train_amp``'s): the host's wait a step, the
    loader's fetch a batch and the device's idle share say which side
    bounds the step.  Each row's launches are counted around its own
    steps: the host chain's are the ``train_host`` path's, the device
    chain's the ``train_host_device`` path's."""
    out = OUT / "train_host"
    shutil.rmtree(out, ignore_errors=True)
    cfgs = {name: train_runner.parse_args(train_sh_flags(root) + [
        "--epochs", "1", "--recovery-interval", "0", "--no-telemetry",
        "--output", str(out)] + extra) for name, extra in (
            ("augment_off", []), ("augment_on", ["--augment-device", "on"]))}
    cfg = cfgs["augment_off"]
    if not (cfg.augment_device == "off" and cfg.amp and cfg.mixup == 0.1
            and cfg.workers == 8):
        raise AssertionError(f"train_torch.sh's flags parsed to {cfg}")
    rows, counts = {}, {}
    run = train_runner.setup(cfg)
    for name, c in cfgs.items():
        _reset_counts()
        rows[name] = _train_steps(
            run, c, HOST_TRAIN_STEPS,
            "train_host_profile" if name == "augment_off" else "")
        counts[name] = (_counts(), _counts("bfloat16"))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    want = {"augment_off": ((CUT_BLOCKS * (HOST_TRAIN_STEPS + 3),) * 3,)
            * 2, "augment_on": ((CUT_BLOCKS * HOST_TRAIN_STEPS,) * 3,) * 2}
    off = rows["augment_off"]
    # the loader bounds the step when the consumer waits on it; else the
    # host thread's dispatch when the device idles most of the step
    bound = ("loader" if off["host_wait_ms_per_step"]
             > 0.1 * off["ms_per_step"] else
             "host dispatch" if (off["idle_share"] or 0) > 0.5
             else "device")
    emit(phase="train_host", nvidia_smi=nvidia_smi_line(),
         steps=HOST_TRAIN_STEPS, rows=rows, launches=counts,
         expected_launches=want, host_ms_a_clip=host["ms"],
         step_bound_by=bound)
    if counts != want or not all(
            np.isfinite(r["loss"]).all() for r in rows.values()):
        raise AssertionError(f"train_host: launches {counts} (expected "
                             f"{want}, all bf16), losses "
                             f"{[r['loss'] for r in rows.values()]}")
    keys = ("forward_launches", "dx_launches", "dwgrad_launches")
    return dict(zip(keys, counts["augment_off"][0]), rows=rows, bound=bound,
                device=dict(zip(keys, counts["augment_on"][0])))


def _split_bn_stats(model) -> dict:
    """``{name: [running_mean of the main BN, of aux 0, ...]}`` of every
    split BN of ``model``, on the host."""
    return {name: [m.running_mean.detach().float().cpu().clone()]
            + [a.running_mean.detach().float().cpu().clone()
               for a in m.aux_bn]
            for name, m in model.named_modules()
            if isinstance(m, SplitBatchNorm2d)}


@_on_cut_flagship
def phase_train_augmix(root: Path, aug: dict) -> dict:
    """train_torch.sh's line with ``--mixup 0 --aug-splits 3 --jsd
    --split-bn`` on the seeded tree: the flagship at full width cut to
    ``CUT_BLOCKS`` blocks, bf16, every BN split in three, the host chain
    then AugMix on the host.  ``AUGMIX_TRAIN_STEPS`` steps and
    ``AUGMIX_PROFILED`` profiled, counted for this row alone: 9 rows a
    step, ``CUT_BLOCKS`` bf16 launches of each depthwise kernel a step,
    the loss finite; every split BN's main and aux running means moved and
    apart; one eval batch through the main BN alone (its logits bitwise
    the same with every aux BN's tensors set to NaN; ``CUT_BLOCKS``
    forward launches, the second forward not counted); ms a step, host wait, idle share,
    peak memory, beside the AugMix stage's host ms a clip (``aug``)."""
    out = OUT / "train_augmix"
    shutil.rmtree(out, ignore_errors=True)
    cfg = train_runner.parse_args(train_sh_flags(root) + AUGMIX_OVERRIDES
                                  + ["--output", str(out)])
    if not (cfg.aug_splits == 3 and cfg.jsd and cfg.split_bn and cfg.amp
            and cfg.mixup == 0 and cfg.augment_device == "off"
            and train_runner.model_dtype(cfg) == torch.bfloat16):
        raise AssertionError(f"the AugMix line parsed to {cfg}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = train_runner.setup(cfg)
    model = run.state.model
    seconds = dict(setup=time.perf_counter() - t0)
    before = _split_bn_stats(model)
    if not before or any(len(v) != 3 for v in before.values()):
        raise AssertionError(f"split BN: {len(before)} modules")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    # no host ops in the trace: reading them for ~31,500 launches a step
    # took 25 s a profiled step on the card
    row = _train_steps(run, cfg, AUGMIX_TRAIN_STEPS, "train_augmix_profile",
                       AUGMIX_PROFILED, host_ops=False)
    torch.cuda.synchronize()
    seconds.update(steps=time.perf_counter() - t0 - row["profile_s"],
                   profile=row["profile_s"])
    counts = (_counts(), _counts("bfloat16"))
    peak = torch.cuda.max_memory_allocated()
    steps = AUGMIX_TRAIN_STEPS + AUGMIX_PROFILED
    after = _split_bn_stats(model)
    still = [n for n in before if any(torch.equal(b, a) for b, a in
                                      zip(before[n], after[n]))]
    alike = [n for n in after if any(torch.equal(after[n][0], x)
                                     for x in after[n][1:])]
    # eval: the main BN alone
    t0 = time.perf_counter()
    model.eval()
    it = iter(run.eval_loader)
    x = next(it)[0]
    it.close()
    _reset_counts()
    with torch.no_grad():
        logits = model(x).float()
    torch.cuda.synchronize()
    eval_counts = _counts()
    saved = {}
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, SplitBatchNorm2d):
                for i, a in enumerate(m.aux_bn):
                    for k in ("weight", "bias", "running_mean",
                              "running_var"):
                        t = getattr(a, k)
                        saved[(name, i, k)] = t.detach().clone()
                        t.fill_(float("nan"))
        again = model(x).float()
        for (name, i, k), v in saved.items():
            getattr(model.get_submodule(name).aux_bn[i], k).copy_(v)
    main_only = bool(torch.equal(logits, again))
    finite = bool(torch.isfinite(logits).all())
    seconds["eval"] = time.perf_counter() - t0
    del run, saved
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    want = ((CUT_BLOCKS * steps,) * 3,) * 2
    emit(phase="train_augmix", nvidia_smi=nvidia_smi_line(),
         blocks=CUT_BLOCKS,
         steps=AUGMIX_TRAIN_STEPS, profiled_steps=AUGMIX_PROFILED,
         rows=row["rows"], seconds=seconds,
         launches=counts, expected_launches=want, eval_launches=eval_counts,
         eval_rows=int(x.shape[0]), eval_main_bn_only=main_only,
         eval_logits_finite=finite, split_bn_modules=len(before),
         stats_not_moved=still[:5], aux_equal_main=alike[:5],
         peak_mem_gib=peak / 2 ** 30,
         step_ms_spread=_spread(row["step_ms"][1:]),
         augmix_host_ms_a_clip=aug["ms"]["augmix_stage_a_clip"],
         augmix_host_ms_a_clip_spread=aug["stage_spread"],
         **{k: row[k] for k in ("ms_per_step", "host_wait_ms_per_step",
                                "fetch_ms_per_batch", "step_ms", "wait_ms",
                                "loss", "idle_share", "busy_ms_per_step",
                                "host_op_ms_per_step")})
    if counts != want or eval_counts != (CUT_BLOCKS, 0, 0) or still \
            or alike or \
            not main_only or not finite or \
            row["rows"] != [3 * TRAIN_BATCH] * AUGMIX_TRAIN_STEPS or \
            not np.isfinite(row["loss"]).all():
        raise AssertionError(
            f"train_augmix: launches {counts} (expected {want}), eval "
            f"{eval_counts}, rows {row['rows']}, stats not moved {still[:3]},"
            f" aux equal to main {alike[:3]}, eval main BN only {main_only},"
            f" finite {finite}, losses {row['loss']}")
    keys = ("forward_launches", "dx_launches", "dwgrad_launches")
    return dict(zip(keys, (counts[0][0] + eval_counts[0], counts[0][1],
                           counts[0][2])),
                ms_per_step=row["ms_per_step"], peak_mem_gib=peak / 2 ** 30,
                idle_share=row["idle_share"], row=row)


# train_shm: the first batches of each row held against the thread
# backend's; then 1 warm-up step, 3 timed and 1 profiled (of the tree's
# 8 batches an epoch; 5 and 2 before the cut for time)
SHM_DIGEST_BATCHES = 4
SHM_TRAIN_STEPS = 4
SHM_PROFILED = 1
SHM_FLAGS = ["--loader-backend", "shm"]
SHM_ROBUST_CHAOS = "kill_shm_worker@2"    # the one worker, mid-epoch
SHM_ROBUST_HEARTBEAT_S = 8.0              # the lost-ack sweep after 5 s
_ROW_KEYS = ("ms_per_step", "step_ms", "idle_share", "busy_ms_per_step",
             "host_wait_ms_per_step", "fetch_ms_per_batch",
             "dispatch_cpu_ms_per_step", "dispatch_cpu_ms",
             "collect_wait_ms_per_batch", "copy_ms_per_batch",
             "ring_occupancy", "respawns", "workers", "ring_depth")


def _batch_digests(cfg, n: int) -> dict:
    """The first ``n`` batches of ``cfg``'s train loader on the card:
    digests of each host batch (images, targets) and of its uint8 images on
    the card, copied over with ``non_blocking`` as the DeviceLoader copies
    them, the host batch dropped at once, and read back after all ``n``."""
    tl, el = train_runner.build_loaders(cfg, torch.device(DATA_DEVICE),
                                        *train_runner.build_datasets(cfg))
    try:
        tl.set_epoch(0)
        it = iter(tl.loader)
        host, on_card = [], []
        for _ in range(n):
            b = next(it)
            host.append([_sha(b.images.numpy()), _sha(b.targets.numpy())])
            on_card.append(tl.to_device(b).images)
            del b
        it.close()
        torch.cuda.synchronize()
        card = [_sha(t.cpu().numpy()) for t in on_card]
    finally:
        tl.close()
        el.close()
    return dict(host=host, card=card)


def _shm_row(name: str, cfg_thread, cfg_shm, profile_host_ops: bool
             ) -> dict:
    """One train_shm row: the first ``SHM_DIGEST_BATCHES`` batches of the
    shm loader bitwise the thread loader's, on the host and on the card;
    then ``SHM_TRAIN_STEPS`` + ``SHM_PROFILED`` steps on the shm loader,
    this row's depthwise launches reset and read around them."""
    thread = _batch_digests(cfg_thread, SHM_DIGEST_BATCHES)
    shm = _batch_digests(cfg_shm, SHM_DIGEST_BATCHES)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = train_runner.setup(cfg_shm)
    setup_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    row = _train_steps(run, cfg_shm, SHM_TRAIN_STEPS, f"{name}_profile",
                       SHM_PROFILED, host_ops=profile_host_ops)
    steps_s = time.perf_counter() - t0
    counts = (_counts(), _counts("bfloat16"))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return dict(row=row, launches=counts, thread_digests=thread,
                shm_digests=shm, host_bitwise=thread["host"] == shm["host"],
                card_bitwise=thread["card"] == shm["card"],
                seconds=dict(setup=setup_s, steps=steps_s))


def _shm_robust() -> dict:
    """The shm transport's robustness on the card's host, small (seeded
    64² clips of 12 channels, batch 4, 8 batches): ``DFD_CHAOS=
    kill_shm_worker@2`` kills the one worker mid-epoch, and the epoch's
    digests equal the thread loader's with a respawn; after ``close()``
    the segment is gone and every worker has exited; a ring larger than
    ``/dev/shm``'s free space raises before any worker spawns; no spawned
    worker holds torch (this script, the main module, imports it)."""
    import errno
    from multiprocessing import shared_memory
    from deepfake_detection_tpu_torch.data.dataset import SyntheticDataset
    from deepfake_detection_tpu_torch.data.loader import HostLoader
    from deepfake_detection_tpu_torch.data.samplers import \
        ShardedTrainSampler
    from deepfake_detection_tpu_torch.data.shm_ring import (ShmRingLoader,
                                                            shm_free_bytes)
    shape, n, batch = (64, 64, 12), 32, 4

    def make(cls, dataset=None, **kw):
        return cls(dataset or SyntheticDataset(n, shape),
                   ShardedTrainSampler(n, batch_size=batch, seed=3), batch,
                   seed=3, **kw)

    def digests(loader):
        loader.set_epoch(0)
        return [[_sha(b.images.numpy()), _sha(b.targets.numpy())]
                for b in loader]

    out = {}
    want = digests(make(HostLoader, num_workers=2))
    os.environ["DFD_CHAOS"] = SHM_ROBUST_CHAOS
    hurt = make(ShmRingLoader, num_workers=1,
                heartbeat_timeout=SHM_ROBUST_HEARTBEAT_S)
    t0 = time.perf_counter()
    try:
        got = digests(hurt)
        name, workers = hurt._ring.name, list(hurt._workers)
    finally:
        os.environ.pop("DFD_CHAOS", None)
        hurt.close()
    out["kill"] = dict(chaos=SHM_ROBUST_CHAOS, batches=len(got),
                       bitwise=got == want, respawns=hurt.respawn_count,
                       stall_sweeps=hurt.stall_sweeps,
                       s=time.perf_counter() - t0)
    try:
        shared_memory.SharedMemory(name=name).close()
        gone = False
    except FileNotFoundError:
        gone = True
    out["close"] = dict(segment_gone=gone, workers=len(workers),
                        exited=[p.exitcode for p in workers])
    free = shm_free_bytes()
    big = make(ShmRingLoader, num_workers=2,
               ring_depth=free // (batch * int(np.prod(shape))) + 1)
    try:
        next(iter(big))
        raised = None
    except OSError as e:
        raised = dict(enospc=e.errno == errno.ENOSPC, message=str(e))
    finally:
        big.close()
    out["too_big"] = dict(free_bytes=free, ring_depth=big.ring_depth,
                          raised=raised, workers_spawned=len(big._workers))
    probe_dir = OUT / "shm_modules"
    shutil.rmtree(probe_dir, ignore_errors=True)
    probe_dir.mkdir(parents=True)
    sys.path.insert(0, str(ROOT / "tests"))   # the workers unpickle from it
    try:
        import torch_shm_datasets as probe
        ld = make(ShmRingLoader, probe.ModulesProbe(
            SyntheticDataset(n, shape), str(probe_dir), os.getpid()),
            num_workers=2)
        try:
            ld.set_epoch(0)
            batches = sum(1 for _ in ld)
        finally:
            ld.close()
    finally:
        sys.path.remove(str(ROOT / "tests"))
    mods = probe.worker_modules(str(probe_dir))
    out["worker_modules"] = dict(
        batches=batches, workers=len(mods),
        torch={pid: sorted(m for m in names if m.split(".")[0] == "torch"
                           )[:3] for pid, names in mods.items()},
        shm_ring=all("deepfake_detection_tpu_torch.data.shm_ring" in names
                     for names in mods.values()))
    return out


@_on_cut_flagship
def phase_train_shm(root: Path, host: dict, aug: dict) -> dict:
    """``--loader-backend shm``: train_torch.sh's line (``host``, beside
    ``train_host``'s host-chain row of this run) and the AugMix line
    (``augmix``, beside ``train_augmix``) on the seeded tree, each with
    its first batches bitwise the thread backend's on the host and on the
    card, 1 + 3 timed + 1 profiled steps (ms a step, idle share, busy ms,
    host wait, collect wait, fetch and copy ms a batch, the dispatching
    thread's CPU ms a step, ring occupancy) and its own ``CUT_BLOCKS`` bf16
    depthwise launches a step; then the transport's robustness on the
    host, small (``robust``)."""
    out = OUT / "train_shm"
    shutil.rmtree(out, ignore_errors=True)
    base = train_sh_flags(root) + ["--output", str(out)]
    host_flags = base + ["--epochs", "1", "--recovery-interval", "0",
                         "--no-telemetry"]
    aug_flags = base + AUGMIX_OVERRIDES
    cfgs = {k: (train_runner.parse_args(f), train_runner.parse_args(
        f + SHM_FLAGS)) for k, f in (("host", host_flags),
                                     ("augmix", aug_flags))}
    for k, (ct, cs) in cfgs.items():
        if not (ct.loader_backend == "thread" and cs.loader_backend == "shm"
                and cs.workers == 8 and cs.ring_depth == 4 and cs.amp
                and cs.augment_device == "off"
                and (cs.aug_splits == 3) == (k == "augmix")):
            raise AssertionError(f"the {k} shm line parsed to {cs}")
    smi = nvidia_smi_line()
    rows = {k: _shm_row(f"train_shm_{k}", *cfgs[k], False) for k in cfgs}
    shutil.rmtree(out, ignore_errors=True)
    robust = _shm_robust()
    steps = SHM_TRAIN_STEPS + SHM_PROFILED
    want = ((CUT_BLOCKS * steps,) * 3,) * 2
    beside = dict(host=("train_host", host["rows"]["augment_off"]),
                  augmix=("train_augmix", aug["row"]))
    for k, r in rows.items():
        other, ref = beside[k]
        emit(phase="train_shm", row=k, nvidia_smi=smi,
             cpu_count=os.cpu_count(), dev_shm_free_bytes=shm_free_bytes(),
             steps=SHM_TRAIN_STEPS, profiled_steps=SHM_PROFILED,
             launches=r["launches"], expected_launches=want,
             first_batches=SHM_DIGEST_BATCHES,
             host_bitwise=r["host_bitwise"], card_bitwise=r["card_bitwise"],
             digests=r["shm_digests"], seconds=r["seconds"],
             loss=r["row"]["loss"], rows=r["row"]["rows"],
             step_ms_spread=_spread(r["row"]["step_ms"][1:]),
             **{k2: r["row"].get(k2) for k2 in _ROW_KEYS},
             **{other: {k2: ref.get(k2) for k2 in _ROW_KEYS}})
    emit(phase="train_shm", row="robust", nvidia_smi=smi, **robust)
    bad = [k for k, r in rows.items()
           if not (r["host_bitwise"] and r["card_bitwise"])
           or r["launches"] != want
           or not np.isfinite(r["row"]["loss"]).all()
           or r["row"]["rows"] != [(3 if k == "augmix" else 1)
                                   * TRAIN_BATCH] * SHM_TRAIN_STEPS]
    rb = robust
    if bad or not (rb["kill"]["bitwise"] and rb["kill"]["respawns"] >= 1
                   and rb["kill"]["batches"] == 8
                   and rb["close"]["segment_gone"]
                   and all(c is not None for c in rb["close"]["exited"])
                   and rb["too_big"]["raised"]
                   and rb["too_big"]["raised"]["enospc"]
                   and rb["too_big"]["workers_spawned"] == 0
                   and rb["worker_modules"]["workers"] >= 1
                   and rb["worker_modules"]["shm_ring"]
                   and not any(rb["worker_modules"]["torch"].values())):
        raise AssertionError(
            f"train_shm: rows failing {bad} "
            f"({ {k: (r['host_bitwise'], r['card_bitwise'], r['launches'])
                  for k, r in rows.items()} }), robust {robust}")
    keys = ("forward_launches", "dx_launches", "dwgrad_launches")
    return dict(zip(keys, rows["host"]["launches"][0]),
                augmix=dict(zip(keys, rows["augmix"]["launches"][0])),
                ms_per_step={k: r["row"]["ms_per_step"]
                             for k, r in rows.items()})


ACCUM = 2                         # train_accum: --grad-accum, microbatch 3
ACCUM_TIMED = 3                   # timed steps after 1 warm, then 1 profiled
ACCUM_OPTS = ("adam", "adamw", "nadam", "radam", "adadelta", "novograd",
              "nvnovograd", "lamb", "lookahead_rmsproptf")
ACCUM_OPT_TOL = 1e-5              # of a leaf's max |update|, card vs CPU
ACCUM_OPT_STEPS = 2               # optimizer steps from one shared gradient


def _accum_cfg(root: Path, out: Path) -> "train_runner.TrainConfig":
    """``scripts/train.sh``'s line with ``--grad-accum 2``, one epoch."""
    cfg = train_runner.parse_args(train_sh_flags(root) + [
        "--grad-accum", str(ACCUM), "--epochs", "1", "--recovery-interval",
        "0", "--no-telemetry", "--output", str(out)])
    if not (cfg.grad_accum == ACCUM and cfg.amp
            and cfg.batch_size == TRAIN_BATCH
            and train_runner.model_dtype(cfg) == torch.bfloat16):
        raise AssertionError(f"train.sh's line with --grad-accum parsed to "
                             f"{cfg}")
    return cfg


def _optimizer_rows(size: int = 224, batch: int = 2) -> dict:
    """Each of ``ACCUM_OPTS`` on the cut flagship, on the card and on the
    CPU from the same weights and the same seeded gradients:
    ``ACCUM_OPT_STEPS`` steps, every parameter's update against the CPU's
    within ``ACCUM_OPT_TOL`` of that leaf's max |update| plus 2 f32 ulps of
    the weight; then, on the card, a NaN batch through the guarded step
    leaves every state tensor (moments, counters, lookahead's slow copy)
    bitwise as it was."""
    models = {d: _flagship_cut(d) for d in ("cuda", "cpu")}
    sd0 = {k: v.detach().clone()
           for k, v in models["cpu"].state_dict().items()}
    rng = np.random.default_rng(11)
    grads = {k: torch.from_numpy((rng.standard_normal(tuple(p.shape))
                                  * 1e-2).astype(np.float32))
             for k, p in models["cpu"].named_parameters()}
    x, y = _gate_inputs(size, batch)
    xd = torch.from_numpy(x).cuda().contiguous(
        memory_format=torch.channels_last)
    yd = torch.from_numpy(y).cuda()
    step = make_train_step(losses.soft_target_cross_entropy,
                           nonfinite_guard=True)
    rows = {}
    for name in ACCUM_OPTS:
        after, guard = {}, None
        for device, model in models.items():
            model.load_state_dict(sd0)
            opt = create_optimizer(train_runner.TrainConfig(opt=name),
                                   model, 1e-3)
            state = create_train_state(model, opt)
            for _ in range(ACCUM_OPT_STEPS):
                for k, p in model.named_parameters():
                    p.grad = grads[k].to(device)
                opt.step()
            after[device] = {k: p.detach().cpu().clone()
                             for k, p in model.named_parameters()}
            if device == "cuda":
                before = [t.clone() for t in state.tensors()]
                m = step(state, torch.full_like(xd, float("nan")), yd)
                torch.cuda.synchronize()
                guard = dict(
                    nonfinite=float(m["nonfinite"]), tensors=len(before),
                    unchanged=sum(torch.equal(a, b) for a, b in
                                  zip(state.tensors(), before)),
                    opt_tensors=sum(len(s) for s in opt.state.values()))
            del opt, state
        worst = 0.0
        for k, pc in after["cpu"].items():
            uc, ug = pc - sd0[k], after["cuda"][k] - sd0[k]
            bound = ACCUM_OPT_TOL * uc.abs().max().item() \
                + 2 * EPS32 * pc.abs().max().item()
            err = (ug - uc).abs().max().item()
            worst = max(worst, err / bound if bound else float(err > 0))
        rows[name] = dict(max_err_over_bound=worst, guard=guard)
    del models
    return rows


def phase_train_accum(root: Path, amp: dict, amp_ckpt: Path) -> dict:
    """``--grad-accum 2`` on train.sh's line (bf16, the flagship at full
    width and depth from the seeded tree, a loader batch of 6 in two
    microbatches of 3): one epoch through ``runners.train.main``
    (``summary.csv`` with its ``auc`` column), then 1 warm, ``ACCUM_TIMED``
    timed and 1 profiled step, 110 forward, dx and dw-gradient launches an
    optimizer step counted for this row alone, the optimizer stepped once
    a step, ms a step, peak memory and idle share beside ``train_amp``'s.
    Then on the flagship cut to 10 blocks at 12×224², f32: one
    ``--grad-accum 2`` step on the card against the CPU by
    ``phase_card_vs_cpu``'s gates (and its NaN batch), each optimizer of
    ``ACCUM_OPTS`` card against CPU (``_optimizer_rows``), and
    ``--initial-checkpoint`` loading ``train_amp``'s checkpoint into the
    AugMix line's split-BN model: every ``aux_bn.<i>`` bitwise its main
    BN, the main BNs bitwise the checkpoint's."""
    out = OUT / "train_accum"
    shutil.rmtree(out, ignore_errors=True)
    cfg = _accum_cfg(root, out)
    smi = nvidia_smi_line()
    train_ds, eval_ds = train_runner.build_datasets(cfg)
    want_steps = len(train_ds) // (TRAIN_BATCH * ACCUM)
    eval_batches = math.ceil(len(eval_ds) / (2 * TRAIN_BATCH))
    _reset_counts()
    result = train_runner.main(cfg)
    torch.cuda.synchronize()
    epoch = _counts("bfloat16")
    steps = len(result["train"]["step_s"])
    want = (55 * (ACCUM * steps + eval_batches), 55 * ACCUM * steps,
            55 * ACCUM * steps)
    summary = (Path(result["output_dir"]) / "summary.csv").read_text()
    header = summary.splitlines()[0].split(",")
    if steps != want_steps or epoch != want or _counts() != want \
            or "eval_auc" not in header or len(summary.splitlines()) != 2 \
            or result["train"]["nonfinite"] \
            or not np.isfinite(result["train"]["loss"]) \
            or not 0.0 <= result["eval"]["auc"] <= 1.0:
        raise AssertionError(
            f"train_accum epoch: {steps} steps (expected {want_steps}), "
            f"launches {_counts()}, {epoch} bf16 (expected {want}), "
            f"summary {summary!r}, result {result}")
    shutil.rmtree(out, ignore_errors=True)

    run = train_runner.setup(cfg)
    opt_steps = [0]
    real_step = run.state.optimizer.step

    def counted_step(*a, **k):
        opt_steps[0] += 1
        return real_step(*a, **k)

    run.state.optimizer.step = counted_step
    first = {k: v.detach().clone()
             for k, v in run.state.model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    row = _train_steps(run, cfg, 1 + ACCUM_TIMED, "train_accum_profile", 1)
    counts, bf = _counts(), _counts("bfloat16")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = 1 + ACCUM_TIMED + 1
    moved = sum(not torch.equal(p, first[k])
                for k, p in run.state.model.named_parameters())
    done = int(run.state.step)
    del run, first
    gc.collect()
    torch.cuda.empty_cache()
    per_step = (55 * ACCUM * n,) * 3
    if counts != per_step or bf != per_step or opt_steps[0] != n \
            or done != n or not moved \
            or not np.isfinite(row["loss"]).all() \
            or row["rows"] != [ACCUM * TRAIN_BATCH] * (1 + ACCUM_TIMED):
        raise AssertionError(
            f"train_accum steps: launches {counts}, {bf} bf16 (expected "
            f"{per_step}: 110 a step), optimizer steps {opt_steps[0]}, "
            f"step counter {done} (expected {n}), moved {moved}, losses "
            f"{row['loss']}, rows {row['rows']}")

    # the cut flagship, f32: the accumulated step card vs CPU, the
    # optimizers, then the initial checkpoint into the split-BN model
    threads = torch.get_num_threads()
    gate = phase_card_vs_cpu(FLAGSHIP_CUT + "_accum2", _flagship_cut,
                             size=224, batch=4, grad_accum=ACCUM)
    del gate
    torch.set_num_threads(threads)
    opts = _optimizer_rows()
    bad_opts = {k: r for k, r in opts.items()
                if r["max_err_over_bound"] > 1.0
                or r["guard"]["nonfinite"] != 1.0
                or r["guard"]["unchanged"] != r["guard"]["tensors"]}
    aug_cfg = train_runner.parse_args(train_sh_flags(root) + AUGMIX_OVERRIDES
                                      + ["--initial-checkpoint",
                                         str(amp_ckpt), "--output",
                                         str(out)])
    arun = train_runner.setup(aug_cfg)
    arun.train_loader.close()
    arun.eval_loader.close()
    src = torch.load(amp_ckpt, map_location="cpu",
                     weights_only=True)["state_dict"]
    got = {k: v.detach().cpu() for k, v in
           arun.state.model.state_dict().items()}
    aux = [k for k in got if ".aux_bn." in k]
    main_keys = {k.split(".aux_bn.")[0] + "." + k.rsplit(".", 1)[1]
                 for k in aux}
    aux_bad = [k for k in aux if not torch.equal(
        got[k], got[k.split(".aux_bn.")[0] + "." + k.rsplit(".", 1)[1]])]
    main_bad = [k for k in main_keys if not torch.equal(got[k], src[k])]
    other_bad = [k for k in got if ".aux_bn." not in k
                 and not torch.equal(got[k], src[k])]
    splits = sum(isinstance(m, SplitBatchNorm2d)
                 for m in arun.state.model.modules())
    del arun, src, got
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    init_ckpt = dict(checkpoint=str(amp_ckpt.relative_to(ROOT)),
                     split_bns=splits, aux_tensors=len(aux),
                     aux_not_main=len(aux_bad), main_not_ckpt=len(main_bad),
                     other_not_ckpt=len(other_bad))
    amp_n = amp["numbers"]
    emit(phase="train_accum", nvidia_smi=smi, grad_accum=ACCUM,
         loader_batch=ACCUM * TRAIN_BATCH, microbatch=TRAIN_BATCH,
         dtype="bfloat16", epoch=dict(
             steps=steps, launches=epoch, eval_batches=eval_batches,
             loss=result["train"]["loss"], eval=result["eval"],
             summary_header=header),
         steps=n, timed_steps=ACCUM_TIMED, launches=counts,
         launches_per_optimizer_step=[c // n for c in counts],
         optimizer_steps=opt_steps[0], moved_params=moved,
         ms_per_step=row["ms_per_step"], step_ms=row["step_ms"],
         peak_mem_gib=peak, idle_share=row["idle_share"],
         busy_ms_per_step=row["busy_ms_per_step"],
         host_wait_ms_per_step=row["host_wait_ms_per_step"],
         loss=row["loss"], train_amp=dict(
             ms_per_step=amp_n["ms_per_step"],
             peak_mem_gib=amp_n["peak_mem_gib"],
             idle_share=amp_n.get("idle_share"), batch=TRAIN_BATCH),
         optimizers=opts, optimizer_tol=ACCUM_OPT_TOL,
         initial_checkpoint=init_ckpt)
    if bad_opts or aux_bad or main_bad or other_bad or not aux:
        raise AssertionError(f"train_accum: optimizers {bad_opts}, "
                             f"initial checkpoint {init_ckpt}")
    keys = ("forward_launches", "dx_launches", "dwgrad_launches")
    return dict(zip(keys, (a + b for a, b in zip(epoch, counts))),
                ms_per_step=row["ms_per_step"])


def _final_state(run_dir: Path) -> dict:
    """Every tensor of a run's ``last.pth.tar``: params and BN stats, the
    optimizer's moments, the step."""
    ck = torch.load(run_dir / "last.pth.tar", map_location="cpu",
                    weights_only=True)
    out = {f"model/{k}": v for k, v in ck["state_dict"].items()}
    for i, st in ck["optimizer"]["state"].items():
        out.update({f"opt/{i}/{k}": v for k, v in st.items()})
    out["step"] = torch.tensor(ck["step"])
    return out


def _max_diff(a: dict, b: dict) -> float:
    return max((x.double() - b[k].double()).abs().max().item()
               for k, x in a.items() if x.is_floating_point())


@_on_cut_flagship
def phase_resume(root: Path) -> dict:
    """The bf16 flagship at full width cut to ``CUT_BLOCKS`` blocks from
    the tree with train.sh's flags, in-process (the recovery contract does
    not depend on depth; the cut's checkpoints are a few percent of the
    full model's): an uninterrupted epoch twice; ``sigterm@5`` → exit 75 and a snapshot,
    then ``--auto-resume`` to the end; a ``nanbatch`` burst → one rewind,
    then to the end.  If the two uninterrupted runs agree bitwise, the
    resumed and the rewound runs must agree with them bitwise; if not (the
    card is not deterministic), the state reloaded from the snapshot must
    be the state saved, bitwise, and the final params within twice the
    run-to-run spread."""
    base = OUT / "resume"
    shutil.rmtree(base, ignore_errors=True)

    def run(tag: str, chaos: str = "", fresh: bool = True):
        out = base / tag
        if fresh:
            shutil.rmtree(out, ignore_errors=True)
        cfg = _amp_cfg(root, out)
        os.environ.pop("DFD_CHAOS", None)
        if chaos:
            os.environ["DFD_CHAOS"] = chaos
        t0 = time.perf_counter()
        try:
            return 0, train_runner.main(cfg), out / "flagship", \
                time.perf_counter() - t0
        except SystemExit as e:
            return e.code, None, out / "flagship", time.perf_counter() - t0
        finally:
            os.environ.pop("DFD_CHAOS", None)
            gc.collect()
            torch.cuda.empty_cache()

    _reset_counts()
    walls, states = {}, {}
    for tag in ("uninterrupted", "again"):
        code, result, run_dir, walls[tag] = run(tag)
        if code or result["train"]["nonfinite"]:
            raise AssertionError(f"{tag}: exit {code}, {result}")
        states[tag] = _final_state(run_dir)
        shutil.rmtree(run_dir.parent)
    spread = _max_diff(states["again"], states["uninterrupted"])
    deterministic = all(torch.equal(v, states["uninterrupted"][k])
                        for k, v in states["again"].items())
    # preemption after update 5 (batch 4): exit 75, the synchronous
    # snapshot, and the relaunch continues from it
    code, _, run_dir, walls["preempted"] = run("preempt", "sigterm@5")
    snap = run_dir / "recovery-0-4.pth.tar"
    if code != 75 or not snap.is_file():
        raise AssertionError(f"sigterm@5: exit {code}, files "
                             f"{sorted(p.name for p in run_dir.iterdir())}")
    # the snapshot, loaded into a fresh state and saved again, is itself
    reload = train_runner.setup(_amp_cfg(root, base / "reload"))
    meta = ckpt.restore_train_state(str(snap), reload.state)
    again = ckpt.checkpoint_payload(reload.state, meta["epoch"], {})
    saved = ckpt.load_checkpoint_file(str(snap))
    reload_bitwise = all(
        torch.equal(again["state_dict"][k], v)
        for k, v in saved["state_dict"].items()) and all(
        torch.equal(again["optimizer"]["state"][i][k], v)
        for i, st in saved["optimizer"]["state"].items()
        for k, v in st.items())
    del reload, again, saved
    code, result, _, walls["resumed"] = run("preempt", fresh=False)
    if code or result["train"]["nonfinite"]:
        raise AssertionError(f"auto-resume: exit {code}, {result}")
    states["resumed"] = _final_state(run_dir)
    shutil.rmtree(run_dir.parent)
    # batches 3, 4, 5 poisoned: three bad steps in a row rewind to the
    # snapshot of batch 2, from where the span replays clean
    code, result, run_dir, walls["rewound"] = run("nanbatch", "nanbatch@3x3")
    if code or result["rewinds"] != 1:
        raise AssertionError(f"nanbatch: exit {code}, {result}")
    states["rewound"] = _final_state(run_dir)
    shutil.rmtree(base)
    launches = _counts()
    diffs = {tag: _max_diff(states[tag], states["uninterrupted"])
             for tag in ("resumed", "rewound")}
    bitwise = {tag: all(torch.equal(v, states["uninterrupted"][k])
                        for k, v in states[tag].items())
               for tag in ("resumed", "rewound")}
    if deterministic and not all(bitwise.values()):
        raise AssertionError(f"resume/rewind not bitwise the uninterrupted "
                             f"run: {bitwise}, max diff {diffs}")
    if not deterministic and not (reload_bitwise and all(
            d <= 2 * spread for d in diffs.values())):
        raise AssertionError(f"resume/rewind: snapshot reload bitwise "
                             f"{reload_bitwise}, max diff {diffs} against a "
                             f"run-to-run spread of {spread}")
    emit(phase="resume", dtype="bfloat16", blocks=CUT_BLOCKS,
         deterministic=deterministic,
         run_to_run_max_diff=spread, bitwise=bitwise, max_diff=diffs,
         snapshot_reload_bitwise=reload_bitwise, wall_s=walls,
         forward_launches=launches[0], dx_launches=launches[1],
         dwgrad_launches=launches[2], bf16_launches=_counts("bfloat16"))
    return dict(zip(("forward_launches", "dx_launches", "dwgrad_launches"),
                    launches))


def _flagship(device: str):
    return create_deepfake_model_v4(device=device, seed=1, bn_momentum=0.1)


# the bf16 gate's flagship: full width, its first 10 blocks (depth
# multiplier 0.34 for 3.1), where a fresh model's bf16 step is about 10% of
# its update off the f32 step (55 blocks: about 90%; ``bf16_noise``)
FLAGSHIP_CUT = "flagship_10_blocks"


CUT_DEPTH = 0.34
CUT_BLOCKS = 10


def _flagship_cut(device: str):
    return create_deepfake_model_v4(device=device, seed=1, bn_momentum=0.1,
                                    depth_multiplier=CUT_DEPTH)


@functools.lru_cache(maxsize=None)
def _timesformer(size: int):
    def build(device: str):
        return create_model(TSF_MODEL, num_classes=2, in_chans=12,
                            img_size=size, attn_impl="flash", device=device,
                            seed=1)
    return build


_PRISTINE = {}


def _fresh(build, device: str):
    """``build(device)``: built once, then a copy of that untouched model
    (the same seeded weights) for every later step of the gates."""
    if (build, device) not in _PRISTINE:
        _PRISTINE[(build, device)] = build(device)
    return copy.deepcopy(_PRISTINE[(build, device)])


def _train_one_step(build, device: str, x: np.ndarray, y: np.ndarray,
                    threads: int = 0, dtype=None, grad_accum: int = 1):
    """One guarded rmsproptf step of the seeded model ``build(device)``,
    computing in ``dtype`` (None: f32), over ``grad_accum`` microbatches;
    returns the loss, the state dict before and after (CPU), and the live
    state and step for more steps."""
    if threads:
        torch.set_num_threads(threads)
    torch.backends.cudnn.allow_tf32 = False     # f32 as f32, as the runners
    torch.backends.cuda.matmul.allow_tf32 = False
    model = set_compute_dtype(_fresh(build, device), dtype)
    state = create_train_state(model, create_optimizer(
        train_runner.TrainConfig(opt="rmsproptf"), model, 1e-3),
        with_ema=True)
    step = make_train_step(losses.soft_target_cross_entropy,
                           nonfinite_guard=True, grad_accum=grad_accum)
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    xd = torch.from_numpy(x).to(device).contiguous(
        memory_format=torch.channels_last)
    yd = torch.from_numpy(y).to(device)
    t0 = time.perf_counter()
    loss = float(step(state, xd, yd)["loss"])
    return dict(loss=loss, s=time.perf_counter() - t0, before=before,
                after={k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()},
                state=state, step=step, x=xd, y=yd)


def _gate_inputs(size: int, batch: int):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((batch, 12, size, size)).astype(np.float32)
    y = np.tile(np.array([[0.9, 0.1], [0.2, 0.8]], np.float32),
                ((batch + 1) // 2, 1))[:batch]
    return x, y


def _updates(run) -> dict:
    """Each floating parameter's update of a step (BN stats aside)."""
    return {k: run["after"][k] - v for k, v in run["before"].items()
            if v.is_floating_point()
            and not k.endswith(("running_mean", "running_var"))}


def phase_card_vs_cpu(name: str = "flagship", build=_flagship,
                      size: int = 224, batch: int = 2,
                      grad_accum: int = 1) -> dict:
    """One guarded rmsproptf step of a full-width model from the same
    weights on the card and on the CPU (all cores, and one core for the
    CPU's own f32 rounding noise), over ``grad_accum`` microbatches; then
    a NaN batch on the card.  Returns both steps' losses, updates and
    states, for the bf16 gate."""
    x, y = _gate_inputs(size, batch)
    gpu = _train_one_step(build, "cuda", x, y, grad_accum=grad_accum)
    cpu = _train_one_step(build, "cpu", x, y, threads=os.cpu_count() or 1,
                          grad_accum=grad_accum)
    cpu1 = _train_one_step(build, "cpu", x, y, threads=1,
                           grad_accum=grad_accum)
    del cpu["state"], cpu1["state"]
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    if not np.isfinite(gpu["loss"]) or loss_rel > LOSS_TOL:
        raise AssertionError(f"card vs CPU loss {gpu['loss']} vs "
                             f"{cpu['loss']}: {loss_rel:.3e} > {LOSS_TOL}")
    # Each parameter's update (after - before) against UPDATE_TOL of its own
    # max, plus: 2 f32 ulps of the weight (the update is a difference of two
    # rounded f32 weights); a floor of 1e-6 of the largest update (leaves
    # whose gradient cancels to rounding noise, as a BN bias feeding the
    # next BN); and twice the CPU's own disagreement on that leaf between
    # all cores and one core (f32 noise amplified through 55 blocks of
    # backprop reaches ~1e-3 of the update on the first blocks' weights).
    upd = {k: (cpu["after"][k] - cpu["before"][k],
               gpu["after"][k] - gpu["before"][k],
               cpu1["after"][k] - cpu1["before"][k])
           for k in cpu["before"] if cpu["before"][k].is_floating_point()
           and not k.endswith(("running_mean", "running_var"))}
    floor = 1e-6 * max(u[0].abs().max().item() for u in upd.values())
    worst_upd = worst_self = usage = 0.0
    for k, (uc, ug, u1) in upd.items():
        err = (ug - uc).abs().max().item()
        noise = (u1 - uc).abs().max().item()
        scale = uc.abs().max().item()
        ulps = 2 * EPS32 * cpu["after"][k].abs().max().item()
        bound = UPDATE_TOL * scale + ulps + floor + 2 * noise
        if err > bound:
            raise AssertionError(f"{k}: card vs CPU update differs by "
                                 f"{err:.3e} > {bound:.3e}")
        usage = max(usage, err / bound)
        # the relative figures over updates well above f32 resolution
        if scale > 1e3 * floor and scale > 500 * ulps:
            worst_upd = max(worst_upd, err / scale)
            worst_self = max(worst_self, noise / scale)
    worst_bn = 0.0
    for k, v in cpu["after"].items():
        if k.endswith("running_var"):
            base = k[:-len("running_var")]
            spread = float(v.max().sqrt())
            for leaf, scale in (("running_mean", spread),
                                ("running_var", spread ** 2)):
                diff = (gpu["after"][base + leaf]
                        - cpu["after"][base + leaf]).abs().max().item()
                if diff > 1e-4 * scale:
                    raise AssertionError(f"{base + leaf}: card vs CPU "
                                         f"{diff:.3e} > 1e-4 · {scale:.3e}")
                worst_bn = max(worst_bn, diff / scale)
    emit(phase="card_vs_cpu", model=name, size=size, batch=batch,
         grad_accum=grad_accum, loss_gpu=gpu["loss"],
         loss_cpu=cpu["loss"], loss_cpu_1_thread=cpu1["loss"],
         loss_rel_diff=loss_rel, max_update_rel_diff=worst_upd,
         cpu_self_max_update_rel_diff=worst_self, update_floor=floor,
         max_err_over_bound=usage,
         max_bn_stat_rel_diff=worst_bn, leaves=len(upd), gpu_s=gpu["s"],
         cpu_s=cpu["s"], cpu_1_thread_s=cpu1["s"],
         tol=dict(loss=LOSS_TOL, update=UPDATE_TOL, bn_stats=1e-4))
    _nan_guard(name, gpu, "float32")
    return dict(cpu=dict(loss=cpu["loss"], updates=_updates(cpu),
                         after=cpu["after"], s=cpu["s"]),
                gpu=dict(loss=gpu["loss"], updates=_updates(gpu),
                         after=gpu["after"]))


def _nan_guard(name: str, gpu: dict, dtype: str) -> None:
    """A NaN batch through the card's guarded step changes nothing."""
    state, step = gpu.pop("state"), gpu.pop("step")
    before = [t.clone() for t in state.tensors()]
    m = step(state, torch.full_like(gpu["x"], float("nan")), gpu["y"])
    torch.cuda.synchronize()
    after = state.tensors()
    same = sum(torch.equal(a, b) for a, b in zip(after, before))
    if float(m["nonfinite"]) != 1.0 or same != len(before) or \
            int(state.step) != 1:
        raise AssertionError(f"NaN batch: nonfinite {float(m['nonfinite'])},"
                             f" {same}/{len(before)} tensors unchanged, "
                             f"step {int(state.step)}")
    emit(phase="guard", model=name, dtype=dtype,
         nonfinite=float(m["nonfinite"]), tensors_unchanged=same,
         tensors=len(before), step=int(state.step))


def _vec(d: dict, keys) -> torch.Tensor:
    return torch.cat([d[k].double().flatten() for k in keys])


def _norm(t: torch.Tensor) -> float:
    return torch.linalg.vector_norm(t.double()).item()


def _bf16_ref(gpu_f32: dict, cpu_f32: dict, cpu: dict) -> dict:
    """What the bf16 gate holds a card bf16 step against: the CPU's bf16
    step (``cpu``), both f32 steps, the leaves whose f32 update is not
    zero, and each side's BN statistics."""
    fg, fc, uc = gpu_f32["updates"], cpu_f32["updates"], _updates(cpu)
    largest = max(_norm(u) for u in fc.values())
    live = sorted(k for k, u in fc.items() if _norm(u) > 1e-6 * largest)
    return dict(fg=fg, fc=fc, uc=uc, largest=largest, live=live,
                cancelled=sorted(set(fc) - set(live)), lc=cpu["loss"],
                lcf=cpu_f32["loss"], lgf=gpu_f32["loss"],
                after_c=cpu["after"], after_fc=cpu_f32["after"],
                after_fg=gpu_f32["after"])


def _bn_rel(a: dict, b: dict, scales: dict) -> float:
    """The largest BN-statistic difference of two state dicts, each against
    its layer's scale (a mean against the channel spread, a var against
    var)."""
    return max((a[k] - b[k]).abs().max().item() / sc
               for k, sc in scales.items())


def _bf16_checks(ug: dict, loss: float, after: dict, ref: dict):
    """The bf16 gate on one card step (its updates ``ug``, loss and
    state ``after``) against ``ref`` (``_bf16_ref``): returns the numbers
    and the names of the checks that failed.

    * ``whole``: the whole update (every leaf, one vector, its 2-norm)
      ``|card bf16 - card f32| <= 2 |CPU bf16 - CPU f32| + 2^-8 |CPU f32|
      + |card f32 - CPU f32|`` (the f32 noise), the method of
      ``tests/test_torch_amp.py``;
    * ``bf16``: ``|card bf16 - card f32| >= 1/4 |CPU bf16 - CPU f32|``:
      the card's step computed in bf16;
    * ``leaves``: each leaf whose f32 update is not zero, against its own
      CPU bf16 update: ``|card bf16 - CPU bf16| <= BF16_LEAF_TOL |CPU
      bf16|``, the same code on both sides from the same weights and
      inputs, apart by accumulation order only;
    * ``cancelled``: a leaf whose f32 update is zero (a BN bias in front of
      a training-mode BN: its gradient cancels) moves by at most 2^-8 of
      the largest update;
    * ``loss``: ``|card bf16 - CPU bf16| <= BF16_LOSS_TOL`` of the loss;
    * ``bn``: every BN statistic, card bf16 against CPU bf16, within
      ``BF16_BN_TOL`` of its layer's scale.
    """
    fg, fc, uc, live = ref["fg"], ref["fc"], ref["uc"], ref["live"]
    keys = sorted(fc)
    e_card = _norm(_vec(ug, keys) - _vec(fg, keys))
    e_cpu = _norm(_vec(uc, keys) - _vec(fc, keys))
    scale = _norm(_vec(fc, keys))
    f32_noise = _norm(_vec(fg, keys) - _vec(fc, keys))
    leaf = {k: _norm(ug[k] - uc[k]) / max(_norm(uc[k]), 1e-30)
            for k in live}
    noise = [_norm(uc[k] - fc[k]) / max(_norm(uc[k]), 1e-30) for k in live]
    worst = max(leaf, key=leaf.get)
    moved = max((_norm(ug[k]) for k in ref["cancelled"]), default=0.0)
    scales = {}
    for k, v in ref["after_fc"].items():
        if k.endswith("running_var"):
            spread = float(v.max().sqrt())
            base = k[:-len("running_var")]
            scales[base + "running_mean"] = spread
            scales[k] = spread ** 2
    loss_rel = abs(loss - ref["lc"]) / abs(ref["lc"])
    bn = _bn_rel(after, ref["after_c"], scales) if scales else 0.0
    numbers = dict(
        whole_card=e_card / scale, whole_cpu=e_cpu / scale,
        whole_bound=(2 * e_cpu + 2.0 ** -8 * scale + f32_noise) / scale,
        f32_noise=f32_noise / scale, leaves=len(live),
        leaf_rel_quantiles=[float(np.quantile(list(leaf.values()), q))
                            for q in (0.5, 0.9, 0.99, 1.0)],
        worst_leaf=worst, leaf_bf16_noise_quantiles=[
            float(np.quantile(noise, q)) for q in (0.5, 0.9, 0.99, 1.0)],
        cancelled=len(ref["cancelled"]),
        cancelled_moved=moved / ref["largest"], loss_rel=loss_rel, bn=bn)
    failed = []
    if not (np.isfinite(e_card) and np.isfinite(loss)):
        failed.append("finite")
    if e_card > 2 * e_cpu + 2.0 ** -8 * scale + f32_noise:
        failed.append("whole")
    if e_card < e_cpu / 4:
        failed.append("bf16")
    if leaf[worst] > BF16_LEAF_TOL:
        failed.append("leaves")
    if moved > 2.0 ** -8 * ref["largest"]:
        failed.append("cancelled")
    if loss_rel > BF16_LOSS_TOL:
        failed.append("loss")
    if bn > BF16_BN_TOL:
        failed.append("bn")
    return numbers, failed


def _bf16_steps(build, f32: dict, size: int, batch: int):
    """The bf16 step of ``build`` on the card and on the CPU from the same
    weights and inputs as the f32 gate's steps ``f32``; returns the card's
    step, ``_bf16_ref`` and ``_bf16_checks``' numbers and failed checks."""
    x, y = _gate_inputs(size, batch)
    gpu = _train_one_step(build, "cuda", x, y, dtype=torch.bfloat16)
    cpu = _train_one_step(build, "cpu", x, y, os.cpu_count() or 1,
                          dtype=torch.bfloat16)
    del cpu["state"]
    ref = _bf16_ref(f32["gpu"], f32["cpu"], cpu)
    numbers, failed = _bf16_checks(_updates(gpu), gpu["loss"], gpu["after"],
                                   ref)
    numbers.update(loss_gpu_bf16=gpu["loss"], loss_cpu_bf16=cpu["loss"],
                   loss_gpu_f32=ref["lgf"], loss_cpu_f32=ref["lcf"],
                   gpu_s=gpu["s"], cpu_s=cpu["s"])
    return gpu, ref, numbers, failed


def phase_bf16_noise(name: str, build, f32: dict, size: int = 224,
                     batch: int = 2) -> None:
    """The full flagship's bf16 step on the card beside its f32 steps
    (``f32``, the f32 gate's, card and CPU), reported and not held: at full
    depth and fresh weights a bf16 step's update is about as far from the
    f32 update as the update is long, so no bound on it could fail a wrong
    step (``card_vs_cpu_bf16`` holds a cut of it, against the CPU's bf16
    step).  Then a NaN batch through the card's bf16 step must change
    nothing."""
    x, y = _gate_inputs(size, batch)
    gpu = _train_one_step(build, "cuda", x, y, dtype=torch.bfloat16)
    ug, fg, fc = _updates(gpu), f32["gpu"]["updates"], f32["cpu"]["updates"]
    keys = sorted(fg)
    whole = _norm(_vec(fg, keys))
    emit(phase="bf16_noise", model=name, size=size, batch=batch,
         held=False, loss_gpu_bf16=gpu["loss"], loss_gpu_f32=f32["gpu"][
             "loss"], loss_cpu_f32=f32["cpu"]["loss"],
         bf16_vs_f32_card=_norm(_vec(ug, keys) - _vec(fg, keys)) / whole,
         f32_card_vs_cpu=_norm(_vec(fg, keys) - _vec(fc, keys)) / whole,
         gpu_s=gpu["s"])
    _nan_guard(name, gpu, "bfloat16")


def phase_card_vs_cpu_bf16(name: str, build, f32: dict, size: int,
                           batch: int = 2) -> None:
    """The bf16 gate: one guarded step of a model from the same weights and
    inputs in bf16 on the card and on the CPU, held by ``_bf16_checks``
    against the CPU's bf16 step and both f32 steps (``f32``, the f32 gate's
    of the same model); then two planted faults must each fail it: an
    unchanged state (the card's update zero) and the card's f32 step in the
    bf16 step's place.  Then a NaN batch through the card's bf16 step must
    leave the state bitwise unchanged."""
    gpu, ref, numbers, failed = _bf16_steps(build, f32, size, batch)
    controls = {
        "unchanged": _bf16_checks({k: torch.zeros_like(u) for k, u in
                                   ref["fc"].items()}, gpu["loss"],
                                  gpu["after"], ref),
        "f32_step": _bf16_checks(ref["fg"], ref["lgf"], ref["after_fg"],
                                 ref)}
    emit(phase="card_vs_cpu_bf16", model=name, size=size, batch=batch,
         **numbers, failed=failed,
         controls={c: dict(failed=f, whole_card=n["whole_card"],
                           worst_leaf_rel=n["leaf_rel_quantiles"][-1])
                   for c, (n, f) in controls.items()},
         tol=dict(leaf=BF16_LEAF_TOL, loss=BF16_LOSS_TOL, bn=BF16_BN_TOL))
    if failed:
        raise AssertionError(f"{name} bf16 card step failed {failed}: "
                             f"{numbers}")
    passed = [c for c, (_, f) in controls.items() if not f]
    if passed:
        raise AssertionError(f"{name} bf16 gate passed the planted faults "
                             f"{passed}")
    _nan_guard(name, gpu, "bfloat16")


# the EfficientNet-family generators: one constructor of each distinct
# path (TF SAME, MixNet, CondConv, EdgeTPU, MnasNet, FBNet, SPNAS,
# MobileNetV2, MobileNetV3 and its minimal tf_ variant), as the trainer
# builds them (12 channels, 2 classes), at 224², batch 2, f32; then one
# model each with --gp catavgmax and --gp max
FAMILY = ("tf_efficientnet_b0", "tf_mixnet_l", "tf_efficientnet_cc_b1_8e",
          "tf_efficientnet_el", "mnasnet_100", "fbnetc_100", "spnasnet_100",
          "mobilenetv2_100", "mobilenetv3_large_100",
          "tf_mobilenetv3_small_minimal_100")
FAMILY_POOLS = (("tf_efficientnet_b0", "catavgmax"),
                ("mobilenetv3_large_100", "max"))
FAMILY_SIZE = 224
FAMILY_BATCH = 2
FAMILY_CAL_BATCH = 8              # BN calibration: 392 samples a channel
                                  # at the deepest stage's 7×7


def _family_build(name: str, **kw):
    def build(device: str):
        return create_model(name, num_classes=2, in_chans=12, device=device,
                            seed=1, **kw)
    return build


def _family_row(name: str, x: torch.Tensor, x_cal: torch.Tensor,
                **kw) -> dict:
    """``name`` calibrated on the card (BN momentum 1.0, one train-mode
    pass: a fresh model scores 0.5 whatever the device), then its eval
    P(fake) on the card against a CPU copy's: SCORE_TOL, and its logits
    within SCORE_TOL of their scale (a calibrated random model's P(fake)
    often saturates, where the first gate says little); the card's eval
    forward launches the depthwise forward once for each single-kernel dw
    stage of the arch (``fused_dw_stages``), and nothing else."""
    card = _family_build(name, bn_momentum=1.0, **kw)("cuda").train()
    with torch.no_grad():
        card(x_cal)
    card.eval()
    cpu = copy.deepcopy(card).to("cpu")
    stages = fused_dw_stages(card.block_configs)
    _reset_counts()
    with torch.no_grad():
        l_card = card(x).cpu()
    torch.cuda.synchronize()
    launches = _counts()
    with torch.no_grad():
        l_cpu = cpu(x.cpu())
    p_card, p_cpu = (torch.softmax(v, -1)[:, 0] for v in (l_card, l_cpu))
    diff = (p_card - p_cpu).abs().max().item()
    logit_rel = ((l_card - l_cpu).abs().max()
                 / l_cpu.abs().max().clamp_min(1e-30)).item()
    row = dict(model=name, **kw, fused_dw_stages=stages,
               launches=list(launches), f32_launches=_counts("float32")[0],
               p_fake_card=p_card.tolist(), p_fake_cpu=p_cpu.tolist(),
               max_p_fake_diff=diff, logit_scale=l_cpu.abs().max().item(),
               max_logit_rel_diff=logit_rel, params=sum(
                   p.numel() for p in card.parameters()))
    if diff > SCORE_TOL or logit_rel > SCORE_TOL \
            or launches != (stages, 0, 0) \
            or row["f32_launches"] != stages or not stages:
        raise AssertionError(f"efficientnet_family {name} {kw}: {row}")
    return row


def phase_efficientnet_family() -> dict:
    """Each ``FAMILY`` constructor and each ``FAMILY_POOLS`` pool through
    :func:`_family_row`, then one f32 train step of tf_efficientnet_b0
    (SAME through the forward, dx and dw-gradient kernels) card against
    CPU by ``phase_card_vs_cpu``'s gates and its NaN batch."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(
        (FAMILY_BATCH, 12, FAMILY_SIZE, FAMILY_SIZE)).astype(np.float32))
    x_cal = torch.from_numpy(rng.standard_normal(
        (FAMILY_CAL_BATCH, 12, FAMILY_SIZE, FAMILY_SIZE)).astype(
            np.float32)).cuda().contiguous(memory_format=torch.channels_last)
    xd = x.cuda().contiguous(memory_format=torch.channels_last)
    rows = [_family_row(name, xd, x_cal) for name in FAMILY]
    rows += [_family_row(name, xd, x_cal, global_pool=gp)
             for name, gp in FAMILY_POOLS]
    fwd = sum(r["launches"][0] for r in rows)
    del x_cal, xd
    gc.collect()
    torch.cuda.empty_cache()
    _reset_counts()
    phase_card_vs_cpu("tf_efficientnet_b0", _family_build(
        "tf_efficientnet_b0", bn_momentum=0.1), size=FAMILY_SIZE,
        batch=FAMILY_BATCH)
    _PRISTINE.clear()
    step = _counts("float32")
    emit(phase="efficientnet_family", nvidia_smi=nvidia_smi_line(),
         size=FAMILY_SIZE, batch=FAMILY_BATCH, rows=rows,
         train_step_launches=list(step), tol=dict(p_fake=SCORE_TOL))
    return dict(forward_launches=fwd + step[0], dx_launches=step[1],
                dwgrad_launches=step[2])


TF_B7NS = "tf_efficientnet_b7_ns"
TF_B7NS_TIMED = 3                 # timed steps after 1 warm, then 1 profiled
# the asymmetric TF SAME pads the arch meets at 600²: (H in, k, stride) →
# (top, bottom); the stem's (k3 s2 at 600) too
TF_B7NS_PADS = {(300, 3, 2): (0, 1), (150, 5, 2): (1, 2), (38, 5, 2): (1, 2)}
TF_B7NS_STEM_PADS = (0, 1)


def dw_stage_pads(model, size: int) -> list:
    """(H in, C, k, stride, (top, bottom)) of every depthwise stage for a
    ``size``² input, walked from the model's own blocks."""
    stem = model.conv_stem
    t, b, _, _ = explicit_padding(stem.padding, stem.kernel_size, 1,
                                  stem.stride, size, size)
    h = (size + t + b - 3) // stem.stride[0] + 1
    out = []
    for stage in model.blocks:
        for block in stage:
            conv = block.conv_dw
            k, s = conv.kernel_size[0], conv.stride[0]
            pads = explicit_padding(block.pad_type, (k, k), 1, s, h, h)
            out.append((h, conv.weight.shape[0], k, s, pads[:2]))
            h = dw.output_size(h, h, k, s, pads)[0]
    return out


def phase_train_tf_b7ns(root: Path, amp: dict) -> dict:
    """``runners.train`` with train.sh's argument list (``--amp``, batch 3,
    ``--augment-device on`` as ``train_amp``) from the seeded tree, but
    ``--model tf_efficientnet_b7_ns --model-version ""`` at 12×600², full
    width and depth: TF SAME padding in every stage, asymmetric at the
    strided stages and the stem.  1 warm, ``TF_B7NS_TIMED`` timed and 1
    profiled step, then one validation; 55/55/55 bf16 launches of the
    depthwise forward, dx and dw-gradient kernels a step and 55 forwards an
    eval batch, each counted alone; ms a step, busy and idle share, peak
    memory beside ``train_amp``'s."""
    out = OUT / "train_tf_b7ns"
    shutil.rmtree(out, ignore_errors=True)
    cfg = train_runner.parse_args(
        train_sh_flags(root) + AMP_OVERRIDES + [
            "--model", TF_B7NS, "--model-version", "", "--input-size-v2",
            "12,600,600", "--recovery-interval", "0", "--no-telemetry",
            "--output", str(out)])
    if not (cfg.amp and cfg.model == TF_B7NS and cfg.model_version == ""
            and train_runner.model_dtype(cfg) == torch.bfloat16):
        raise AssertionError(f"train_tf_b7ns parsed to {cfg}")
    smi = nvidia_smi_line()
    torch.cuda.reset_peak_memory_stats()
    run = train_runner.setup(cfg)
    model = run.state.model
    stages = dw_stage_pads(model, 600)
    asym = {(h, k, s): p for h, _, k, s, p in stages if p[0] != p[1]}
    stem = explicit_padding(model.conv_stem.padding, (3, 3), 1, 2, 600,
                            600)[:2]
    if fused_dw_stages(model.block_configs) != 55 or len(stages) != 55 \
            or asym != TF_B7NS_PADS or stem != TF_B7NS_STEM_PADS:
        raise AssertionError(f"{TF_B7NS}: stages {stages}, stem {stem}")
    _reset_counts()
    row = _train_steps(run, cfg, 1 + TF_B7NS_TIMED, "train_tf_b7ns_profile",
                       1, host_ops=False)
    steps = 1 + TF_B7NS_TIMED + 1
    counts, bf = _counts(), _counts("bfloat16")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _reset_counts()
    metrics = validate(run.eval_step, run.state, run.eval_loader, cfg)
    torch.cuda.synchronize()
    eval_batches = len(run.eval_loader)
    eval_counts = _counts("bfloat16")
    del run, model
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    want = (55 * steps,) * 3
    base = amp["numbers"]
    numbers = dict(
        ms_per_step=row["ms_per_step"], step_ms=row["step_ms"],
        host_wait_ms_per_step=row["host_wait_ms_per_step"],
        idle_share=row["idle_share"], busy_ms_per_step=row["busy_ms_per_step"],
        peak_mem_gib=peak, loss=row["loss"], eval=dict(metrics),
        train_amp=dict(ms_per_step=base["ms_per_step"],
                       idle_share=base["idle_share"],
                       busy_ms_per_step=base["busy_ms_per_step"],
                       peak_mem_gib=base["peak_mem_gib"]))
    emit(phase="train_tf_b7ns", nvidia_smi=smi, model=TF_B7NS,
         dtype="bfloat16", steps=steps, launches=list(counts),
         bf16_launches=list(bf), launches_a_step=[c / steps for c in counts],
         eval_batches=eval_batches, eval_launches=list(eval_counts),
         asymmetric_pads={f"{h}_k{k}_s{s}": p for (h, k, s), p
                          in asym.items()}, stem_pads=stem, **numbers)
    if counts != want or bf != want \
            or eval_counts != (55 * eval_batches, 0, 0) \
            or not np.isfinite(row["loss"]).all() \
            or not np.isfinite(metrics["loss"]):
        raise AssertionError(f"train_tf_b7ns: launches {counts} ({bf} bf16; "
                             f"expected {want}), eval {eval_counts} over "
                             f"{eval_batches} batches, losses {row['loss']},"
                             f" eval {dict(metrics)}")
    return dict(forward_launches=counts[0] + eval_counts[0],
                dx_launches=counts[1], dwgrad_launches=counts[2],
                numbers=numbers)


RESNET = "resnet50d"
RESNET_TIMED = 3                  # timed steps after 1 warm, then 1 profiled
RESNET_DROP_BLOCK = 0.1
# the maps the DropBlocks of layers 3 and 4 see a forward at a 600² input:
# the deep stem and max pool give 150², layer 3's first block takes 75²
# (its first DropBlock, before the strided conv) to 38² (the avg-down
# shortcut's SAME pads (0, 1) at the odd 75), layer 4's 38² to 19²
RESNET_DROP_BLOCK_MAPS = {75: 1, 38: 18, 19: 8}


def phase_train_resnet(root: Path, amp: dict) -> dict:
    """``runners.train`` with train.sh's argument list (``--amp``, batch 3,
    ``--augment-device on`` as ``train_amp``) from the seeded tree on
    ``--model resnet50d --model-version "" --drop-block 0.1`` at 12×600²,
    full width and depth: the deep stem, avg-down shortcuts (75 → 38 an odd
    map), DropBlock on layers 3–4 (``RESNET_DROP_BLOCK_MAPS``; 18 calls at
    gamma scale 0.25, 9 at 1.0), ImageNet's normalization by the model's
    name.  1 warm, ``RESNET_TIMED`` timed and 1 profiled step,
    then one validation and the epoch's checkpoint loaded back into a
    fresh model (bitwise); no depthwise or flash launch; ms a step, busy
    and idle share, peak memory beside ``train_amp``'s."""
    out = OUT / "train_resnet"
    shutil.rmtree(out, ignore_errors=True)
    cfg = train_runner.parse_args(
        train_sh_flags(root) + AMP_OVERRIDES + [
            "--model", RESNET, "--model-version", "", "--input-size-v2",
            "12,600,600", "--drop-block", str(RESNET_DROP_BLOCK),
            "--recovery-interval", "0", "--no-telemetry", "--output",
            str(out)])
    mean, std = cfg.mean_std()
    if not (cfg.amp and cfg.model == RESNET and cfg.drop_block == 0.1
            and train_runner.model_dtype(cfg) == torch.bfloat16
            and (mean, std) == ((0.485, 0.456, 0.406),
                                (0.229, 0.224, 0.225))):
        raise AssertionError(f"train_resnet parsed to {cfg}, {mean}, {std}")
    smi = nvidia_smi_line()
    torch.cuda.reset_peak_memory_stats()
    run = train_runner.setup(cfg)
    model = run.state.model
    maps = Counter()
    gammas = Counter()

    def seen(mod, args):
        maps[args[0].shape[-1]] += 1
        gammas[mod.gamma_scale] += 1

    drop_blocks = [m for m in model.modules() if isinstance(m, DropBlock2d)]
    hooks = [m.register_forward_pre_hook(seen) for m in drop_blocks]
    _reset_counts()
    row = _train_steps(run, cfg, 1 + RESNET_TIMED, "train_resnet_profile", 1,
                       host_ops=False)
    for h in hooks:
        h.remove()
    steps = 1 + RESNET_TIMED + 1
    counts, flash = _counts(), _flash_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = validate(run.eval_step, run.state, run.eval_loader, cfg)
    torch.cuda.synchronize()
    eval_counts = _counts()
    out.mkdir(parents=True, exist_ok=True)
    path = out / "resnet50d.pth.tar"
    ckpt.save_checkpoint_file(str(path), ckpt.checkpoint_payload(
        run.state, 0, {"model": RESNET}))
    saved = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del run, model
    gc.collect()
    torch.cuda.empty_cache()
    fresh = create_model(RESNET, num_classes=2, in_chans=12, device="cuda",
                         seed=5, drop_block_rate=RESNET_DROP_BLOCK)
    fresh.load_state_dict(ckpt.load_checkpoint_file(str(path))["state_dict"])
    reload_bitwise = all(torch.equal(v.cpu(), saved[k])
                         for k, v in fresh.state_dict().items())
    del fresh, saved
    shutil.rmtree(out, ignore_errors=True)
    base = amp["numbers"]
    numbers = dict(
        ms_per_step=row["ms_per_step"], step_ms=row["step_ms"],
        host_wait_ms_per_step=row["host_wait_ms_per_step"],
        idle_share=row["idle_share"], busy_ms_per_step=row["busy_ms_per_step"],
        peak_mem_gib=peak, loss=row["loss"], eval=dict(metrics),
        train_amp=dict(ms_per_step=base["ms_per_step"],
                       idle_share=base["idle_share"],
                       busy_ms_per_step=base["busy_ms_per_step"],
                       peak_mem_gib=base["peak_mem_gib"]))
    emit(phase="train_resnet", nvidia_smi=smi, model=RESNET,
         dtype="bfloat16", steps=steps, drop_block=RESNET_DROP_BLOCK,
         drop_block_maps=dict(maps), drop_block_gammas=dict(gammas),
         launches=list(counts), flash_launches=list(flash),
         eval_launches=list(eval_counts), reload_bitwise=reload_bitwise,
         mean=mean, std=std, **numbers)
    if counts != (0, 0, 0) or flash != (0, 0, 0) \
            or eval_counts != (0, 0, 0) or len(drop_blocks) != 27 \
            or dict(maps) != {h: n * steps for h, n in
                              RESNET_DROP_BLOCK_MAPS.items()} \
            or dict(gammas) != {0.25: 18 * steps, 1.0: 9 * steps} \
            or not reload_bitwise \
            or not np.isfinite(row["loss"]).all() \
            or not np.isfinite(metrics["loss"]):
        raise AssertionError(f"train_resnet: launches {counts} {flash}, "
                             f"eval {eval_counts}, drop blocks "
                             f"{len(drop_blocks)} at {dict(maps)} "
                             f"{dict(gammas)}, reload {reload_bitwise}, "
                             f"losses {row['loss']}, eval {dict(metrics)}")
    return dict(forward_launches=0, dx_launches=0, dwgrad_launches=0,
                numbers=numbers)


# the ResNet-derived families and SENet: one constructor of each distinct
# path (basic and bottleneck blocks, the deep stem with avg-down, ResNeXt,
# the tiered stem with SE, ECA, the gluon v1s stem, Res2Net, both SK
# blocks, SENet's basic and SENet154 blocks), at FAMILY_SIZE², batch 2,
# f32, each block's last BN at unit scale (a zero-initialized one would
# leave its branch out of the check)
# resnet26d's card-vs-CPU train step at 64²: a ReLU net's max pools and
# ReLUs make its gradient jump where f32 rounding flips a near-tie, so at
# 224² a 1-ulp change of the input moves the CPU's own f32 gradient of a
# fresh resnet26d by up to 18% of a leaf's scale (and one leaf's card
# update missed the gate's bound by 1.4×); at 64² by 1.1e-5
RESNET_GATE_SIZE = 64
RESNET_FAMILY = ("resnet18", "resnet26d", "resnext50_32x4d",
                 "seresnext26t_32x4d", "ecaresnet50", "gluon_resnet50_v1s",
                 "res2net50_26w_4s", "skresnet18", "skresnext50_32x4d",
                 "seresnet18", "senet154")


def _resnet_family_row(name: str, x: torch.Tensor,
                       x_cal: torch.Tensor) -> dict:
    """``name`` calibrated on the card (every BN's momentum set to 1.0 on
    the built model: the factory drops ``bn_momentum`` for these
    families, as the JAX one), then its eval P(fake) and logits on the
    card against a CPU copy's, within SCORE_TOL; no depthwise or flash
    launch."""
    kw = {} if is_model_in_modules(name, ("senet",)) \
        else dict(zero_init_last_bn=False)
    card = create_model(name, num_classes=2, in_chans=12, device="cuda",
                        seed=1, drop_rate=0.0, **kw)
    for m in card.modules():
        if isinstance(m, BatchNorm2d):
            m.momentum = 1.0
    card.train()
    with torch.no_grad():
        card(x_cal)
    card.eval()
    cpu = copy.deepcopy(card).to("cpu")
    _reset_counts()
    with torch.no_grad():
        l_card = card(x).cpu()
    torch.cuda.synchronize()
    launches, flash = _counts(), _flash_counts()
    with torch.no_grad():
        l_cpu = cpu(x.cpu())
    p_card, p_cpu = (torch.softmax(v, -1)[:, 0] for v in (l_card, l_cpu))
    diff = (p_card - p_cpu).abs().max().item()
    logit_rel = ((l_card - l_cpu).abs().max()
                 / l_cpu.abs().max().clamp_min(1e-30)).item()
    row = dict(model=name, launches=list(launches), flash=list(flash),
               p_fake_card=p_card.tolist(), p_fake_cpu=p_cpu.tolist(),
               max_p_fake_diff=diff, logit_scale=l_cpu.abs().max().item(),
               max_logit_rel_diff=logit_rel, params=sum(
                   p.numel() for p in card.parameters()))
    if diff > SCORE_TOL or logit_rel > SCORE_TOL \
            or launches != (0, 0, 0) or flash != (0, 0, 0) \
            or not torch.isfinite(l_card).all():
        raise AssertionError(f"resnet_family {name}: {row}")
    return row


def phase_resnet_family() -> dict:
    """Each ``RESNET_FAMILY`` constructor through
    :func:`_resnet_family_row`, then one f32 train step of resnet26d card
    against CPU by ``phase_card_vs_cpu``'s gates and its NaN batch at
    ``RESNET_GATE_SIZE``²."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal(
        (FAMILY_BATCH, 12, FAMILY_SIZE, FAMILY_SIZE)).astype(np.float32))
    x_cal = torch.from_numpy(rng.standard_normal(
        (FAMILY_CAL_BATCH, 12, FAMILY_SIZE, FAMILY_SIZE)).astype(
            np.float32)).cuda().contiguous(memory_format=torch.channels_last)
    xd = x.cuda().contiguous(memory_format=torch.channels_last)
    rows = [_resnet_family_row(name, xd, x_cal) for name in RESNET_FAMILY]
    emit(phase="resnet_family", nvidia_smi=nvidia_smi_line(),
         size=FAMILY_SIZE, batch=FAMILY_BATCH, rows=rows,
         tol=dict(p_fake=SCORE_TOL))
    del x_cal, xd
    gc.collect()
    torch.cuda.empty_cache()
    _reset_counts()
    phase_card_vs_cpu("resnet26d", _family_build("resnet26d"),
                      size=RESNET_GATE_SIZE, batch=FAMILY_BATCH)
    _PRISTINE.clear()
    step = _counts()
    emit(phase="resnet_family_step", size=RESNET_GATE_SIZE,
         batch=FAMILY_BATCH, train_step_launches=list(step))
    if step != (0, 0, 0):
        raise AssertionError(f"resnet26d's train step launched the "
                             f"depthwise kernels {step}")
    return dict(forward_launches=0, dx_launches=0, dwgrad_launches=0)


def _flash_inputs(bh, l, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((bh, l, d), generator=g, device="cuda").to(dtype)
            for _ in range(4)]


def _close(name, got, want, tol) -> float:
    """Elementwise |got - want| ≤ atol + rtol·|want|; returns the max
    absolute error."""
    diff = (got.float() - want.float()).abs()
    if (got.shape != want.shape or not torch.isfinite(got).all()
            or bool((diff > tol[0] + tol[1] * want.float().abs()).any())):
        raise AssertionError(f"{name}: {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, max |kernel - plain| "
                             f"{diff.max().item():.3e} over atol {tol[0]} + "
                             f"rtol {tol[1]}")
    return diff.max().item()


def check_flash(name, bh, l, d, seq_len, causal=False, q_off=0, kv_off=0,
                dtype=torch.float32, seed=0) -> dict:
    """The three flash kernels against their plain versions on the same
    inputs: O elementwise (BF16_TOL for bf16), lse elementwise, dQ, dK and
    dV within FLASH_GRAD_TOL of their max; two forward and two backward
    calls must agree bitwise; rows that the causal offsets hide must give
    o = 0 and lse = log(1e-30).  Returns the max absolute error of each
    kernel and the largest gradient error relative to its max
    (grad_rel)."""
    q, k, v, do = _flash_inputs(bh, l, d, dtype, seed)
    args = (d ** -0.5, seq_len, causal, q_off, kv_off)
    o, lse = fa.flash_fwd(q, k, v, *args)
    o2, lse2 = fa.flash_fwd(q, k, v, *args)
    ro, rlse = fa.flash_fwd_reference(q, k, v, *args)
    delta = (do.float() * o.float()).sum(-1)
    dq = [fa.flash_bwd_dq(q, k, v, do, lse, delta, *args) for _ in range(2)]
    dkv = [fa.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
           for _ in range(2)]
    rdq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, *args)
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    if o.dtype != dtype or lse.dtype != torch.float32:
        raise AssertionError(f"{name}: o {o.dtype}, lse {lse.dtype}")
    err = dict(fwd=max(_close(f"{name} o", o, ro, BF16_TOL if dtype ==
                              torch.bfloat16 else FLASH_TOL),
                       _close(f"{name} lse", lse, rlse, FLASH_TOL)))
    if causal and kv_off > q_off:          # rows that see no key
        hidden = min(kv_off - q_off, l)
        if not (torch.equal(o[:, :hidden].float(),
                            torch.zeros_like(o[:, :hidden].float()))
                and torch.allclose(lse[:, :hidden], torch.full_like(
                    lse[:, :hidden], math.log(np.float32(1e-30))),
                    rtol=1e-6, atol=0)):
            raise AssertionError(f"{name}: hidden rows give o != 0 or lse "
                                 f"!= log(1e-30)")
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{name}: two forward calls differ")
    if not (torch.equal(dq[0], dq[1]) and torch.equal(dkv[0][0], dkv[1][0])
            and torch.equal(dkv[0][1], dkv[1][1])):
        raise AssertionError(f"{name}: two backward calls differ")
    err["grad_rel"] = 0.0
    for label, got, want in (("dq", dq[0], rdq), ("dk", dkv[0][0], rdk),
                             ("dv", dkv[0][1], rdv)):
        rel = _rel_err(got, want)
        if not torch.isfinite(got).all() or rel > FLASH_GRAD_TOL:
            raise AssertionError(f"{name}: {label} |kernel - plain| / "
                                 f"max|plain| {rel:.3e} > {FLASH_GRAD_TOL}")
        err["grad_rel"] = max(err["grad_rel"], rel)
    err["dq"] = (dq[0] - rdq).abs().max().item()
    err["dkv"] = max((dkv[0][0] - rdk).abs().max().item(),
                     (dkv[0][1] - rdv).abs().max().item())
    return err


def flash_costs(bh, l, d, itemsize=4):
    """(bytes, operations) each flash kernel must move and do at a
    non-causal (BH, L, D) call: every input read once and every output
    written once; the matrix products' multiply-adds as 2 operations each
    (S = QKᵀ, PV, dP = dO Vᵀ, dS K, Pᵀ dO, dSᵀ Q are 2·L²·D a row of BH;
    the L² exponentials are left out, under 2% of the count)."""
    x = bh * l * d * itemsize
    row = bh * l * 4                               # lse, delta (f32)
    mm = 2 * bh * l * l * d
    return dict(fwd=(4 * x + row, 2 * mm),         # q k v → o, lse
                dq=(4 * x + 2 * row + bh * l * d * 4, 3 * mm),
                dkv=(4 * x + 2 * row + 2 * bh * l * d * 4, 4 * mm))


def flash_bounds(nbytes, ops) -> dict:
    """The least time of an f32 flash kernel: the larger of its bytes over
    the memory rate and its operations over the faster f32-accurate rate,
    the f32 SIMT units (67 TFLOP/s) or the tensor cores taking each product
    as three TF32 products (3 × ops at 495 TFLOP/s)."""
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    simt_ms = ops / F32_FLOP_PER_S * 1e3
    tf32x3_ms = 3 * ops / TF32_FLOP_PER_S * 1e3
    ops_ms = min(simt_ms, tf32x3_ms)
    return dict(bytes_ms=bytes_ms, simt_bound_ms=simt_ms,
                tf32x3_bound_ms=tf32x3_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_rate="3xTF32 tensor cores" if tf32x3_ms <= simt_ms
                else "f32 SIMT")


def sdpa(q, k, v):
    """The library yardstick: SDPA pinned to its memory-efficient backend
    (PyTorch's f32 attention kernel, forward and backward) on (B·H, L, D)
    as (1, B·H, L, D): its fused kernels take 4-D inputs only, and a 3-D
    call falls back to the unfused math path."""
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q[None], k[None], v[None])[0]


def backward_device_ms(attend, q, k, v, do):
    """Device time of one backward of ``attend(q, k, v)`` alone, timed as
    the kernels are (:func:`device_ms`): the forward runs once on a side
    stream and is kept, and the graph captures ``torch.autograd.grad``
    over it on that stream (autograd runs a backward op on its forward's
    stream).  Returns (ms, the attention's autograd node, {backward
    kernel: device ms a call} from torch.profiler over 3 more calls)."""
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = attend(*ins)

    def grad():
        torch.autograd.grad(out, ins, do, retain_graph=True)
    ms = device_ms(grad, stream=side)
    with torch.cuda.stream(side), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            grad()
        torch.cuda.synchronize()
    kernels = {e.key[:100]: e.self_device_time_total / 3 / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    nodes, todo = [], [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None:
            nodes.append(fn.name())
            todo += [nxt for nxt, _ in fn.next_functions]
    node = next((n for n in nodes if "Attention" in n), nodes[0])
    return ms, node, kernels or "not measured"


def phase_flash() -> dict:
    """The flash kernels against their plain versions at the TimeSformer's
    shapes (a train step's spatial attention, BH 384, and an eval forward's
    at batch 16, BH 768; L 576, D 64, f32) and at edge cases; then device
    times at both path shapes: kernel, plain, SDPA (library, pinned to its
    memory-efficient backend; its backward alone, as the port's autograd
    backward) and both bounds; returns the BH-384 row and the max
    errors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = Counter()

    def fold(e):
        for key, v in e.items():
            errs[key] = max(errs[key], v)

    rows = {}
    for i, bh in enumerate(FLASH_BH):
        fold(check_flash(f"path BH {bh}", bh, FLASH_L, FLASH_D, FLASH_L,
                         seed=900 + i))
        q, k, v, do = _flash_inputs(bh, FLASH_L, FLASH_D, torch.float32,
                                    910 + i)
        scale, lq = FLASH_D ** -0.5, FLASH_L
        o, lse = fa.flash_fwd(q, k, v, scale, lq)
        delta = (do * o).sum(-1)
        bw = (q, k, v, do, lse, delta, scale, lq)
        row = dict(
            fwd_ms=device_ms(lambda: fa.flash_fwd(q, k, v, scale, lq)),
            fwd_plain_ms=device_ms(lambda: fa.flash_fwd_reference(
                q, k, v, scale, lq)),
            fwd_library_ms=device_ms(lambda: sdpa(q, k, v)),
            dq_ms=device_ms(lambda: fa.flash_bwd_dq(*bw)),
            dq_plain_ms=device_ms(lambda: fa.flash_bwd_dq_reference(*bw)),
            dkv_ms=device_ms(lambda: fa.flash_bwd_dkv(*bw)),
            dkv_plain_ms=device_ms(lambda: fa.flash_bwd_dkv_reference(*bw)))
        # the whole backward of one attention, the port's autograd node
        # (delta, dK/dV, dQ, casts) against SDPA's, each alone on the device
        row["bwd_ms"], _, row["bwd_kernels"] = backward_device_ms(
            lambda a, b, c: fa.FlashAttentionFunction.apply(a, b, c, scale,
                                                            False),
            q, k, v, do)
        (row["library_bwd_ms"], row["library_backend"],
         row["library_bwd_kernels"]) = backward_device_ms(sdpa, q, k, v, do)
        if "Efficient" not in row["library_backend"]:
            raise AssertionError(f"SDPA ran {row['library_backend']}, not "
                                 f"its memory-efficient backend")
        row["bwd_pair_ms"] = row["dq_ms"] + row["dkv_ms"]
        for kind, (nbytes, ops) in flash_costs(bh, FLASH_L, FLASH_D).items():
            for key, val in flash_bounds(nbytes, ops).items():
                row[f"{kind}_{key}"] = val
            row[f"{kind}_bound_share"] = row[f"{kind}_bound_ms"] \
                / row[f"{kind}_ms"]
            row[f"{kind}_tflop_per_s"] = ops / row[f"{kind}_ms"] / 1e9
        rows[bh] = row
        emit(phase="flash_row", bh=bh, l=FLASH_L, d=FLASH_D, dtype="float32",
             **row)
        del q, k, v, do, o, lse, delta, bw
    edges = [("L 197", 48, 197, 64, 197),
             ("L 200", 48, 200, 64, 200),
             ("D 32", 24, 200, 32, 200),
             ("D 48 L 197", 24, 197, 48, 197),
             ("D 128 L 130", 12, 130, 128, 130),
             ("D 128 L 576", 24, 576, 128, 576),
             ("key padding 150/200", 24, 200, 64, 150)]
    for j, (name, bh, l, d, seq_len) in enumerate(edges):
        fold(check_flash(name, bh, l, d, seq_len, seed=920 + j))
    causal = [("causal", 24, 200, 64, 200, 0, 0),
              ("causal kv_off 16: 16 rows see no key", 24, 200, 64, 200, 0,
               16),
              ("causal q_off 64 (a later ring shard)", 24, 192, 48, 192, 64,
               0),
              ("causal, padding, offsets 7/40", 24, 200, 64, 150, 7, 40),
              ("causal kv_off 300: every row hidden", 6, 130, 64, 130, 0,
               300)]
    for j, (name, bh, l, d, seq_len, q_off, kv_off) in enumerate(causal):
        fold(check_flash(name, bh, l, d, seq_len, True, q_off, kv_off,
                         seed=940 + j))
    bf16 = Counter()
    for j, (name, bh, l, d) in enumerate([("bf16 path", FLASH_BH[0], 576, 64),
                                          ("bf16 D 48 L 197", 24, 197, 48)]):
        for key, v in check_flash(name, bh, l, d, l, dtype=torch.bfloat16,
                                  seed=960 + j).items():
            bf16[key] = max(bf16[key], v)
    emit(phase="flash", cases=2 + len(edges) + len(causal) + 2,
         max_abs_err=dict(errs), bf16_max_abs_err=dict(bf16), bitwise=True,
         tol=dict(f32=FLASH_TOL, bf16_o=BF16_TOL, grad=FLASH_GRAD_TOL))
    return dict(row=rows[FLASH_BH[0]], eval_row=rows[FLASH_BH[1]],
                max_abs_err=dict(errs))


def sdpa_flash(q, k, v):
    """SDPA pinned to its flash backend (bf16 only; P·V in bf16), on (B·H,
    L, D) as (1, B·H, L, D)."""
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return F.scaled_dot_product_attention(q[None], k[None], v[None])[0]


def flash_bf16_costs(bh, l, d):
    """(bytes, operations) of each flash kernel's bf16 instantiation: q, k,
    v, o and dO two bytes an element, lse, delta and the f32 gradients
    four; the operations are the TF32 products it runs, each 2·BH·L²·D:
    an operand read from bf16 is exact in TF32 (one term with an exact
    partner), one made in f32 inside the kernel (q·scale, P, dS) is split
    (two): forward S 2 + PV 2, dQ S 1 + dP 1 + dS·K 2, dK/dV S 1 + dP 1 +
    Pᵀ·dO 2 + dSᵀ·q 2 (f32 inputs: three terms each, 6, 9 and 12)."""
    x, row, g = bh * l * d * 2, bh * l * 4, bh * l * d * 4
    mm = 2 * bh * l * l * d
    return dict(fwd=(4 * x + row, 4 * mm), dq=(4 * x + 2 * row + g, 4 * mm),
                dkv=(4 * x + 2 * row + 2 * g, 6 * mm))


def phase_flash_bf16() -> dict:
    """The three flash kernels' bf16 instantiations (the ``--amp`` path's)
    at the TimeSformer's train-step shape (B·H 384, L 576, D 64): against
    their plain versions (O within one bf16 rounding, lse and the f32
    gradients at the f32 tolerances: the operands built in f32 inside, q·
    scale, P and dS, are split into TF32 terms as for f32 inputs), two calls
    bitwise; device times of kernel, plain and SDPA in bf16 with its flash
    backend (P·V in bf16) and its memory-efficient one, forward and
    backward, beside the bound of the TF32 products the kernels run."""
    bf16, bh = torch.bfloat16, FLASH_BH[0]
    err = check_flash(f"bf16 path BH {bh}", bh, FLASH_L, FLASH_D, FLASH_L,
                      dtype=bf16, seed=1300)
    q, k, v, do = _flash_inputs(bh, FLASH_L, FLASH_D, bf16, 1310)
    scale, lq = FLASH_D ** -0.5, FLASH_L
    o, lse = fa.flash_fwd(q, k, v, scale, lq)
    delta = (do.float() * o.float()).sum(-1)
    bw = (q, k, v, do, lse, delta, scale, lq)
    row = dict(
        fwd_ms=device_ms(lambda: fa.flash_fwd(q, k, v, scale, lq)),
        fwd_plain_ms=device_ms(lambda: fa.flash_fwd_reference(
            q, k, v, scale, lq)),
        fwd_library_ms=device_ms(lambda: sdpa(q, k, v)),
        fwd_library_flash_ms=device_ms(lambda: sdpa_flash(q, k, v)),
        dq_ms=device_ms(lambda: fa.flash_bwd_dq(*bw)),
        dq_plain_ms=device_ms(lambda: fa.flash_bwd_dq_reference(*bw)),
        dkv_ms=device_ms(lambda: fa.flash_bwd_dkv(*bw)),
        dkv_plain_ms=device_ms(lambda: fa.flash_bwd_dkv_reference(*bw)))
    row["bwd_ms"], _, row["bwd_kernels"] = backward_device_ms(
        lambda a, b, c: fa.FlashAttentionFunction.apply(a, b, c, scale,
                                                        False), q, k, v, do)
    (row["library_bwd_ms"], row["library_backend"],
     row["library_bwd_kernels"]) = backward_device_ms(sdpa, q, k, v, do)
    (row["library_flash_bwd_ms"], row["library_flash_backend"],
     row["library_flash_bwd_kernels"]) = backward_device_ms(sdpa_flash, q,
                                                             k, v, do)
    if "Efficient" not in row["library_backend"] or \
            "Flash" not in row["library_flash_backend"]:
        raise AssertionError(f"SDPA ran {row['library_backend']} and "
                             f"{row['library_flash_backend']}")
    for kind, (nbytes, ops) in flash_bf16_costs(bh, FLASH_L,
                                                FLASH_D).items():
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = _bound(
            nbytes, ops, TF32_FLOP_PER_S)
        row[f"{kind}_bound_share"] = row[f"{kind}_bound_ms"] \
            / row[f"{kind}_ms"]
    emit(phase="flash_row_bf16", bh=bh, l=FLASH_L, d=FLASH_D,
         dtype="bfloat16", max_abs_err=err, **row)
    return dict(row=row, max_abs_err=err)


_FLASH_KERNEL = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv))_kernelI"
                           r"(f|13__nv_bfloat16)Li(\d+)E")


def _flash_kernel_key(mangled: str):
    m = _FLASH_KERNEL.search(mangled)
    return m and f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'},{m[3]}>"


def _ptxas_report(lib: Path, key_fn) -> dict:
    """ptxas' registers, stack and spills of each kernel in the build log
    beside ``lib`` whose mangled name ``key_fn`` maps to a key."""
    out, key = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            key = key_fn(line)
            if key:
                out[key] = {}
        elif key and "bytes stack frame" in line:
            n = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[key].update(stack_bytes=n[0], spill_store_bytes=n[1],
                            spill_load_bytes=n[2])
        elif key and "registers" in line:
            out[key]["ptxas_registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
    return out


_DW_KERNEL = re.compile(r"(dw_fwd|dw_dx)_kernelI(f|13__nv_bfloat16)Li(\d)E"
                        r"Li(\d)ELb(\d)E")


def _dw_kernel_key(mangled: str):
    m = _DW_KERNEL.search(mangled)
    return m and (f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'},k{m[3]},"
                  f"s{m[4]},{'vec' if m[5] == '1' else 'scalar'}>")


def phase_depthwise_kernels(libs: dict) -> dict:
    """For every instantiation of the depthwise forward and dx kernels:
    ptxas' registers, stack and spills (the build's ``-Xptxas -v``
    report), and what the card gives it (registers, local bytes, the
    largest dynamic shared memory its tiles take, resident blocks per SM
    at that size and 128 threads: cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = {}
    for name, short in (("depthwise_fwd", "dw_fwd"), ("depthwise_dx", "dw_dx")):
        out.update(_ptxas_report(libs[name], _dw_kernel_key))
        info = kernel(name, f"dfd_{name}_info", [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
        for dtype, k, s, vec in itertools.product((0, 1), (3, 5), (1, 2),
                                                  (1, 0)):
            got = (ctypes.c_int * 4)()
            err = info(k, s, dtype, vec, ctypes.addressof(got))
            key = (f"{short}<{('f32', 'bf16')[dtype]},k{k},s{s},"
                   f"{'vec' if vec else 'scalar'}>")
            if err != 0:
                raise RuntimeError(f"{key} info: cudaError_t {err}")
            out.setdefault(key, {}).update(
                registers=got[0], local_bytes=got[1], smem_bytes=got[2],
                blocks_per_sm=got[3])
    emit(phase="depthwise_kernels", kernels=out)
    return out


def phase_flash_kernels(libs: dict) -> dict:
    """For every instantiation of the three flash kernels (the forward and
    the two backward kernels): ptxas' registers, stack and spills (the
    build's ``-Xptxas -v`` report), what the card gives it (registers, local
    bytes, dynamic shared memory, resident blocks per SM:
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    and, where the toolkit has ``cuobjdump``, the HMMA (tensor-core)
    instructions in its SASS.  Fails unless dK/dV at f32, D = 64 keeps two
    blocks on an SM, and (with cuobjdump) every instantiation runs on the
    tensor cores."""
    out = {}
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        out.update(_ptxas_report(libs[name], _flash_kernel_key))
        info = kernel(name, f"dfd_{name}_info",
                      [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        for dtype, tname in ((0, "f32"), (1, "bf16")):
            for d in (32, 64, 128):
                got = (ctypes.c_int * 4)()
                err = info(d, dtype, ctypes.addressof(got))
                if err != 0:
                    raise RuntimeError(f"{name} info D {d} {tname}: "
                                       f"cudaError_t {err}")
                out.setdefault(f"{name}<{tname},{d}>", {}).update(
                    registers=got[0], local_bytes=got[1], smem_bytes=got[2],
                    blocks_per_sm=got[3])
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        if Path(cuobjdump).is_file():
            sass = subprocess.run([cuobjdump, "-sass", str(libs[name])],
                                  capture_output=True, text=True, timeout=300,
                                  check=True).stdout
            key = None
            for line in sass.splitlines():
                if "Function :" in line:
                    key = _flash_kernel_key(line)
                    if key:
                        out[key]["hmma"] = 0
                elif key and "HMMA" in line:
                    out[key]["hmma"] += 1
    emit(phase="flash_kernels", kernels=out)
    if out["flash_bwd_dkv<f32,64>"]["blocks_per_sm"] < 2:
        raise AssertionError(f"dK/dV at D 64 keeps "
                             f"{out['flash_bwd_dkv<f32,64>']['blocks_per_sm']}"
                             f" blocks on an SM, expected 2")
    no_tc = [k for k, v in out.items() if v.get("hmma") == 0]
    if no_tc:
        raise AssertionError(f"no HMMA in the SASS of {no_tc}")
    return out


def phase_flash_autograd() -> float:
    """``flash_attention`` on the card, forward and backward through the
    kernels, against ``torch.autograd`` through the plain forward, in the
    JAX layout (B, L, H, D): a path shape and a ragged one.  Returns the
    largest relative error of O and the three gradients."""
    worst = 0.0
    for j, (b, l, h, d, causal) in enumerate([(TSF_BATCH * 4, FLASH_L, 12,
                                               FLASH_D, False),
                                              (2, 197, 3, 64, True)]):
        g = torch.Generator(device="cuda").manual_seed(980 + j)
        q, k, v, gy = (torch.randn((b, l, h, d), generator=g, device="cuda")
                       for _ in range(4))
        outs, grads = [], []
        for attend in ("kernel", "plain"):
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            if attend == "kernel":
                y = fa.flash_attention(*ins, causal=causal)
            else:
                bh = [t.permute(0, 2, 1, 3).reshape(b * h, l, d) for t in ins]
                y = fa.flash_fwd_reference(*bh, d ** -0.5, l, causal)[0]
                y = y.view(b, h, l, d).permute(0, 2, 1, 3)
            grads.append(torch.autograd.grad(y, ins, gy))
            outs.append(y.detach())
        torch.cuda.synchronize()
        for label, got, want in zip(("o", "dq", "dk", "dv"),
                                    (outs[0], *grads[0]),
                                    (outs[1], *grads[1])):
            rel = _rel_err(got, want)
            if not torch.isfinite(got).all() or rel > FLASH_GRAD_TOL:
                raise AssertionError(f"flash_attention ({b}, {l}, {h}, {d}) "
                                     f"causal={causal}: {label} |card - "
                                     f"autograd| / max {rel:.3e} > "
                                     f"{FLASH_GRAD_TOL}")
            worst = max(worst, rel)
    emit(phase="flash_autograd", max_rel_err=worst, tol=FLASH_GRAD_TOL)
    return worst


def phase_tsf_train(amp: bool = False, beside: dict = None) -> dict:
    """``runners.train`` in-process on ``timesformer_base_patch25_600`` at
    12×600², batch 8, ``--attn-impl flash``, in f32 or (``amp``) bf16: 8
    steps, validation of the model and its EMA, a checkpoint; 12 forward, 12
    dQ and 12 dK/dV kernel launches a step and 12 forward launches an eval
    forward, every one of the dtype's instantiation; the EMA reloaded from
    the checkpoint scores the eval set as the run did; then one step's
    device time by kernel kind and the eval forward's clips/s at batch
    16.  ``beside``: the f32 phase's numbers, printed in the bf16 line."""
    name = "tsf_train_amp" if amp else "tsf_train"
    dtype = "bfloat16" if amp else "float32"
    out = OUT / name
    shutil.rmtree(out, ignore_errors=True)
    # the f32 run is observed: /metrics mid-run and a PROFILE trigger
    observe = [] if amp else ["--metrics-port", str(_free_port()),
                              "--profile-capture", str(OBS_PROFILE_STEPS)]
    cfg = train_runner.parse_args(TSF_FLAGS + (["--amp"] if amp else F32)
                                  + ["--output", str(out)] + observe)
    init = train_runner.build_model(cfg, "cpu").state_dict()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    result, seen = _observed_main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, dq, dkv = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = len(result["train"]["step_s"])
    n_eval = max(max(TSF_BATCH * 8, 16) // 2, 8)      # runners.train.setup
    eval_forwards = 2 * math.ceil(n_eval / (2 * TSF_BATCH))  # model + EMA
    want = (TSF_BLOCKS * (steps + eval_forwards), TSF_BLOCKS * steps,
            TSF_BLOCKS * steps)
    if steps != 8 or (fwd, dq, dkv) != want or _counts() != (0, 0, 0) \
            or _flash_counts(dtype) != want:
        raise AssertionError(
            f"TimeSformer train path: {steps} steps, (forward, dQ, dK/dV) "
            f"launches {(fwd, dq, dkv)}, {_flash_counts(dtype)} of them "
            f"{dtype}, depthwise {_counts()}; expected 8, {want}, all "
            f"{dtype}, (0, 0)")
    if not (np.isfinite(result["train"]["loss"])
            and np.isfinite(result["eval"]["loss"])):
        raise AssertionError(f"non-finite loss: {result}")
    if result["train"]["nonfinite"]:
        raise AssertionError(f"{result['train']['nonfinite']} guarded steps")
    last = Path(result["output_dir"]) / "last.pth.tar"
    ckpt = torch.load(last, map_location="cpu", weights_only=True)
    moved = {part: sum(not torch.equal(v, init[k]) for k, v in sd.items())
             for part, sd in (("params", ckpt["state_dict"]),
                              ("ema", ckpt["state_dict_ema"]))}
    if not all(moved.values()):
        raise AssertionError(f"state did not move in training: {moved}")
    step_s = result["train"]["step_s"][1:]        # the first one warms up
    ms_step = float(np.mean(step_s)) * 1e3
    del init
    gc.collect()
    torch.cuda.empty_cache()
    if observe:
        emit(phase="obs", path=name, nvidia_smi=nvidia_smi_line(),
             **_obs_checks(name, seen["run_dir"], seen, steps, {
                 k: TSF_BLOCKS for k in ("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv")}))

    # the checkpoint's EMA, loaded into a fresh run, scores the eval set as
    # the run's last validation (the EMA's) did
    run = train_runner.setup(cfg)
    run.state.model.load_state_dict(ckpt["state_dict_ema"])
    again = validate(run.eval_step, run.state, run.eval_loader, cfg)
    rel = abs(again["loss"] - result["eval"]["loss"]) / abs(
        result["eval"]["loss"])
    if rel > 1e-5:
        raise AssertionError(f"reloaded EMA eval loss {again['loss']} vs "
                             f"{result['eval']['loss']} in the run")
    numbers = dict(ms_per_step=ms_step,
                   samples_per_s=TSF_BATCH / (ms_step / 1e3),
                   peak_mem_gib=peak / 2 ** 30)
    emit(phase=name, dtype=dtype, steps=steps, forward_launches=fwd,
         dq_launches=dq, dkv_launches=dkv, loss=result["train"]["loss"],
         eval_loss=result["eval"]["loss"], reloaded_eval_loss=again["loss"],
         moved_leaves=moved, checkpoint=str(last.relative_to(ROOT)),
         step_ms=[v * 1e3 for v in step_s], wall_s=wall,
         f32=beside and {k: beside[k] for k in (
             "ms_per_step", "samples_per_s", "peak_mem_gib",
             "busy_ms_per_step", "device_ms_by_kind")}, **numbers)
    del result, ckpt

    batches = list(itertools.islice(iter(run.train_loader), 4))
    run.train_step(run.state, *batches[0])
    torch.cuda.synchronize()
    _reset_counts()
    run.train_step(run.state, *batches[1])
    torch.cuda.synchronize()
    if _flash_counts(dtype) != (TSF_BLOCKS,) * 3:
        raise AssertionError(f"one train step launched {_flash_counts()} "
                             f"(forward, dQ, dK/dV); expected 12 each of "
                             f"the {dtype} instantiation")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in batches[2:]:
            run.train_step(run.state, x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = _emit_kinds(name + "_profile", prof, len(batches) - 2, wall_us,
                        batch=TSF_BATCH, dtype=dtype)
    del batches

    model = run.state.model.eval()
    x = torch.randn(2 * TSF_BATCH, 12, 600, 600, device="cuda").contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        _reset_counts()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    if _flash_counts(dtype) != (TSF_BLOCKS * iters, 0, 0):
        raise AssertionError(f"{iters} eval forwards launched "
                             f"{_flash_counts()}")
    emit(phase="tsf_eval_throughput", dtype=dtype, batch=2 * TSF_BATCH,
         clips_per_s=2 * TSF_BATCH * iters / dt,
         ms_per_forward=dt / iters * 1e3)
    del run, model, x
    gc.collect()
    torch.cuda.empty_cache()
    return dict(forward_launches=fwd, dq_launches=dq, dkv_launches=dkv,
                busy_ms_per_step=kinds.get("busy_ms_per_iteration"),
                device_ms_by_kind=kinds.get("ms_per_iteration"), **numbers)


def flash_entries(fl: dict, autograd_err: float, tsf: dict, tsfa: dict,
                  flb: dict) -> list:
    """The ``kernels`` line's entries of the three flash kernels: launches
    from the TimeSformer's training paths (f32 and bf16), times per call at
    its train step's shape, f32 and (``bf16``) the bf16 instantiation."""
    row, ev, rb = fl["row"], fl["eval_row"], flb["row"]
    out = []
    for kind, line, key in (("fwd", 106, "forward_launches"),
                            ("dq", 272, "dq_launches"),
                            ("dkv", 216, "dkv_launches")):
        name = {"fwd": "flash_fwd", "dq": "flash_bwd_dq",
                "dkv": "flash_bwd_dkv"}[kind]
        out.append(dict(
            name=name, route="cuda",
            source=f"deepfake_detection_tpu_torch/csrc/{name}.cu",
            replaces=f"deepfake_detection_tpu/ops/flash_attention.py:{line}",
            launches=tsf[key] + tsfa[key],
            launches_by_path={"tsf_train": tsf[key],
                              "tsf_train_amp": tsfa[key]},
            max_abs_err=fl["max_abs_err"][kind], ms=row[f"{kind}_ms"],
            plain_ms=row[f"{kind}_plain_ms"],
            bound_ms=row[f"{kind}_bound_ms"],
            bound_by=row[f"{kind}_bound_by"],
            bound_rate=row[f"{kind}_bound_rate"],
            simt_bound_ms=row[f"{kind}_simt_bound_ms"],
            tf32x3_bound_ms=row[f"{kind}_tf32x3_bound_ms"],
            bound_share=row[f"{kind}_bound_share"],
            library_ms=row["fwd_library_ms"] if kind == "fwd" else None,
            eval_ms=ev[f"{kind}_ms"], eval_bound_ms=ev[f"{kind}_bound_ms"],
            bf16=dict(
                launches=tsfa[key], max_abs_err=flb["max_abs_err"][kind],
                ms=rb[f"{kind}_ms"], plain_ms=rb[f"{kind}_plain_ms"],
                bound_ms=rb[f"{kind}_bound_ms"],
                bound_by=rb[f"{kind}_bound_by"],
                bound_share=rb[f"{kind}_bound_share"],
                library_ms=rb["fwd_library_ms"] if kind == "fwd" else None,
                library_flash_ms=rb["fwd_library_flash_ms"]
                if kind == "fwd" else None),
            timing="device time per call (CUDA graph replay between CUDA "
                   f"events) at (B·H, L, D) = ({FLASH_BH[0]}, {FLASH_L}, "
                   f"{FLASH_D}) f32, a train step's spatial attention; "
                   f"eval_*: ({FLASH_BH[1]}, ...), an eval forward at batch "
                   f"{2 * TSF_BATCH}; library: SDPA, memory-efficient "
                   f"backend (bf16 also its flash backend); bf16 bound: the "
                   f"TF32 products the bf16 instantiation runs"))
    for entry in out[1:]:
        entry.update(library_bwd_ms=row["library_bwd_ms"],
                     library_backend=row["library_backend"],
                     bwd_pair_ms=row["bwd_pair_ms"], bwd_ms=row["bwd_ms"],
                     eval_library_bwd_ms=ev["library_bwd_ms"])
        entry["bf16"].update(
            bwd_ms=rb["bwd_ms"], library_bwd_ms=rb["library_bwd_ms"],
            library_flash_bwd_ms=rb["library_flash_bwd_ms"])
    out[0]["autograd_max_rel_err"] = autograd_err
    return out


PHASE_S = {}
# Each phase's seconds on a normal host (one whose ``build`` takes under
# 28 s): 822 in all, so that a host 45% slower still ends within the
# script's 1,200.  Set from the measured phases; serve, warmstart, stream
# and router are set under what they take, since they must give back the
# script's last ~40 s.  A slice pays for a phase it adds inside these
# (ROADMAP "Risks"): the ResNet phases (17 s) by quant's CPU parity on one
# frame and warm-start tree A on two buckets (about 16 s less on a normal
# host), and the budgets of the phases measured under theirs.  The
# ``budget`` line reports each phase's seconds against its budget; no phase
# fails on it.
PHASE_BUDGET_S = {
    "build": 24, "jpeg": 12, "host_augment": 15, "augmix": 8,
    "flash_kernels": 7, "depthwise_kernels": 1, "kernels": 6, "dwgrad": 14,
    "dx": 2, "backward": 2, "flash": 7, "flash_autograd": 1,
    "depthwise_bf16": 18, "flash_bf16": 3, "main_path": 30, "serve": 62,
    "quant": 40, "backfill": 21, "warmstart": 68, "stream": 61,
    "router": 95, "train": 25, "train_data": 48, "train_amp": 31,
    "train_host": 4, "train_augmix": 7, "train_shm": 28, "train_accum": 30,
    "resume": 10, "tsf_train": 28, "tsf_train_amp": 16, "card_vs_cpu": 63,
    "train_tf_b7ns": 6, "efficientnet_family": 10, "train_resnet": 5,
    "resnet_family": 12}


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds printed and kept."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_S[name] = time.perf_counter() - t0
    emit(phase="seconds", of=name, s=PHASE_S[name])
    return out


def main() -> int:
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), jpeglib=jpeg_probe(),
         cpu_count=os.cpu_count(), dev_shm_free_bytes=shm_free_bytes())

    t0 = time.perf_counter()
    libs = build()
    build_s = time.perf_counter() - t0
    emit(phase="build", s=build_s,
         ptxas={name: [ln.strip() for ln in path.with_suffix(".log")
                       .read_text().splitlines() if "registers" in ln]
                for name, path in libs.items()},
         libraries=[path.name for path in libs.values()])
    PHASE_S["build"] = build_s
    jpeg = timed("jpeg", phase_jpeg)
    host = timed("host_augment", phase_host_augment)
    aug = timed("augmix", phase_augmix)
    timed("flash_kernels", phase_flash_kernels, libs)
    timed("depthwise_kernels", phase_depthwise_kernels, libs)

    model = create_deepfake_model_v4(device="cpu")
    shapes = flagship_dw_shapes(model, 600)
    del model
    if dict(shapes) != FLAGSHIP_DW:
        raise AssertionError(f"flagship depthwise shapes {dict(shapes)}")
    k = timed("kernels", phase_kernels, shapes)
    g = timed("dwgrad", phase_dwgrad, shapes)
    d = timed("dx", phase_dx, shapes)
    b = timed("backward", phase_backward, shapes)
    fl = timed("flash", phase_flash)
    fl_autograd = timed("flash_autograd", phase_flash_autograd)
    kb = timed("depthwise_bf16", phase_depthwise_bf16, shapes)
    flb = timed("flash_bf16", phase_flash_bf16)

    # each path runs with the launch counts set to 0 just before it
    _reset_counts()
    infer_launches, files, cli_scores = timed("main_path", phase_main_path)
    frame = files[0]
    if _counts()[1:] != (0, 0) or _flash_counts() != (0, 0, 0):
        raise AssertionError(f"the inference path launched the dx, "
                             f"dw-gradient and flash kernels {_counts()[1:]}"
                             f", {_flash_counts()} times")
    _reset_counts()
    serve = timed("serve", phase_serve, OUT / "flagship.pth", files,
                  cli_scores)
    if _counts()[0] == 0 or _counts()[1:] != (0, 0) \
            or _flash_counts() != (0, 0, 0):
        raise AssertionError(f"the serving path launched the depthwise "
                             f"kernels {_counts()} and the flash kernels "
                             f"{_flash_counts()} times")
    # the quantized servers and the int8 CLI: the eager launches are
    # counted here, the replays through the engines' capture counts
    _reset_counts()
    quant = timed("quant", phase_quant, OUT / "flagship.pth", files,
                  cli_scores)
    if _counts()[0] == 0 or _counts()[1:] != (0, 0) \
            or _flash_counts() != (0, 0, 0):
        raise AssertionError(f"the quantized serving path launched the "
                             f"depthwise kernels {_counts()} and the flash "
                             f"kernels {_flash_counts()} times")
    _reset_counts()
    bf = timed("backfill", phase_backfill, OUT / "flagship.pth")
    if _counts()[0] == 0 or _counts()[1:] != (0, 0) \
            or _flash_counts() != (0, 0, 0):
        raise AssertionError(f"the backfill path launched the depthwise "
                             f"kernels {_counts()} and the flash kernels "
                             f"{_flash_counts()} times")
    # the warm start: every server and worker is a child in a fresh tree,
    # so the counts of this process stay 0
    _reset_counts()
    ws = timed("warmstart", phase_warmstart, OUT / "flagship.pth", files,
               cli_scores, bf["manifest"], bf["pack"])
    if ws["launches"] == 0 or _counts() != (0, 0, 0) \
            or _flash_counts() != (0, 0, 0):
        raise AssertionError(f"the warm start: {ws['launches']} depthwise "
                             f"launches in its children, {_counts()} and "
                             f"{_flash_counts()} in this process")
    # the stream servers: the captures' eager runs and the card CLI here,
    # the replays through the engines' capture counts (phase_stream holds
    # them at 55 × replays)
    _reset_counts()
    st = timed("stream", phase_stream, OUT / "flagship.pth")
    if st["launches"] == 0 or _counts()[0] == 0 \
            or _counts()[1:] != (0, 0) or _flash_counts() != (0, 0, 0):
        raise AssertionError(f"the stream path launched the depthwise "
                             f"kernels {st['launches']} times in replays, "
                             f"{_counts()} eagerly, and the flash kernels "
                             f"{_flash_counts()} times")
    # the fleet router: every replica is a child process, so the counts of
    # this process stay 0; the replicas' replays are read off /metrics
    _reset_counts()
    rt = timed("router", phase_router, OUT / "flagship.pth", files,
               cli_scores, bf["manifest"], bf["pack"])
    if rt["launches"] == 0 or _counts() != (0, 0, 0) \
            or _flash_counts() != (0, 0, 0):
        raise AssertionError(f"the router path: {rt['launches']} depthwise "
                             f"launches in its replicas, {_counts()} and "
                             f"{_flash_counts()} in this process")
    emit(phase="cold_start", nvidia_smi=smi, kernel_build_s=build_s,
         kernels_built="all six sources, one nvcc each, in parallel",
         native_library_build_s=jpeg["build_s"],
         serve=quant["cold"], backfill=dict(
             load_s=bf["run1"]["load_s"], capture_s=bf["run1"]["capture_s"],
             dedup_s=bf["run1"]["dedup_s"], ready_s=bf["run1"]["ready_s"]),
         stream_runner_ready_s=st["ready_s"],
         fleet_ready_s=rt["ready_s"],
         stream_fleet_ready_s=rt["stream_ready_s"],
         autoscaled_replica_ready_s=rt["autoscale_spawn_ready_s"],
         warm_start=dict(ready_s=ws["ready_s"], nvcc_s=ws["nvcc_s"],
                         ready_saved_s=ws["ready_saved_s"],
                         backfill_ready_s=ws["backfill_ready_s"]))
    t = timed("train", phase_train, frame)
    td = timed("train_data", phase_train_data, frame, {k: t[k] for k in (
        "ms_per_step", "samples_per_s", "peak_mem_gib",
        "host_wait_ms_per_step", "idle_share")})
    ta = timed("train_amp", phase_train_amp, frame, td["root"],
               td["numbers"])
    tb7 = timed("train_tf_b7ns", phase_train_tf_b7ns, td["root"], ta)
    fam = timed("efficientnet_family", phase_efficientnet_family)
    _reset_counts()
    trn = timed("train_resnet", phase_train_resnet, td["root"], ta)
    _reset_counts()
    rfam = timed("resnet_family", phase_resnet_family)
    th = timed("train_host", phase_train_host, td["root"], host)
    _reset_counts()
    tam = timed("train_augmix", phase_train_augmix, td["root"], aug)
    tsh = timed("train_shm", phase_train_shm, td["root"], th, tam)
    tac = timed("train_accum", phase_train_accum, td["root"], ta, AMP_CKPT)
    rs = timed("resume", phase_resume, td["root"])
    tsf = timed("tsf_train", phase_tsf_train)
    tsfa = timed("tsf_train_amp", phase_tsf_train, amp=True, beside=tsf)
    t0 = time.perf_counter()
    f32_gate = phase_card_vs_cpu()
    phase_bf16_noise("flagship", _flagship, f32_gate)
    f32_gate = phase_card_vs_cpu(FLAGSHIP_CUT, _flagship_cut)
    phase_card_vs_cpu_bf16(FLAGSHIP_CUT, _flagship_cut, f32_gate, 224)
    f32_gate = phase_card_vs_cpu(TSF_MODEL, _timesformer(300), size=300,
                                 batch=TSF_GATE_BATCH)
    phase_card_vs_cpu_bf16(TSF_MODEL, _timesformer(300), f32_gate, 300,
                           TSF_GATE_BATCH)
    del f32_gate
    _PRISTINE.clear()
    PHASE_S["card_vs_cpu"] = time.perf_counter() - t0
    emit(phase="seconds", of="card_vs_cpu", s=PHASE_S["card_vs_cpu"])

    dw_paths = {"train": t, "train_data": td, "train_jpeg": td["jpeg"],
                "train_amp": ta, "train_host": th,
                "train_host_device": th["device"], "train_augmix": tam,
                "train_shm": tsh, "train_shm_augmix": tsh["augmix"],
                "train_accum": tac, "resume": rs, "train_tf_b7ns": tb7,
                "efficientnet_family": fam, "train_resnet": trn,
                "resnet_family": rfam}

    def by_path(key, **extra):
        out = dict(extra, **{p: r[key] for p, r in dw_paths.items()})
        return sum(out.values()), out

    fwd_launches, fwd_paths = by_path("forward_launches",
                                      inference=infer_launches,
                                      serve=serve["launches"],
                                      serve_jpeg=serve["jpeg_launches"],
                                      serve_quant=quant["launches"],
                                      backfill=bf["launches"],
                                      warmstart=ws["launches"],
                                      stream=st["launches"],
                                      stream_mjpeg=st["mjpeg_launches"],
                                      router=rt["launches"])
    dx_launches, dx_paths = by_path("dx_launches")
    dwg_launches, dwg_paths = by_path("dwgrad_launches")
    amp_paths = ("train_amp", "train_host", "train_host_device",
                 "train_augmix", "train_shm", "train_shm_augmix",
                 "train_accum", "resume", "train_tf_b7ns", "train_resnet")

    def bf16(key, err, launch_key):
        return dict(
            launches=sum(dw_paths[p][launch_key] for p in amp_paths),
            max_abs_err=err, **{f: kb[key][f] for f in (
                "ms", "plain_ms", "library_ms", "bound_ms")},
            timing="bf16 instantiation, device time summed over the 55 "
                   "stages as the f32 row; library: cuDNN in bf16")

    total = time.perf_counter() - t_main
    emit(phase="seconds", of="all", s=total, by_phase=PHASE_S)
    emit(phase="budget", nvidia_smi=smi, total_s=total,
         total_budget_s=sum(PHASE_BUDGET_S.values()), build_s=build_s,
         normal_host=build_s < 28.0,
         phases={k: dict(s=PHASE_S.get(k), budget_s=b,
                         over=PHASE_S.get(k, 0.0) > b)
                 for k, b in PHASE_BUDGET_S.items()},
         over=[k for k, b in PHASE_BUDGET_S.items()
               if PHASE_S.get(k, 0.0) > b],
         unbudgeted=sorted(set(PHASE_S) - set(PHASE_BUDGET_S)))
    emit(kernels=[
        dict(name="depthwise_fwd", route="cuda",
             source="deepfake_detection_tpu_torch/csrc/depthwise_fwd.cu",
             replaces="deepfake_detection_tpu/ops/depthwise_pallas.py:138",
             launches=fwd_launches, launches_by_path=fwd_paths,
             max_abs_err=max(k["max_abs_err"], b["y_max_abs_err"]),
             ms=k["ms"], kernel_ms=k["ms"],
             plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
             bound_by="bytes" if k["bytes_ms"] >= k["ops_ms"]
             else "operations",
             library_ms=k["library_ms"],
             dx_source="deepfake_detection_tpu_torch/csrc/depthwise_dx.cu",
             dx_ms=d["ms"], dx_library_ms=d["library_ms"],
             dx_bound_ms=d["bound_ms"],
             bf16=dict(bf16("fwd_b1", kb["errs"]["fwd"], "forward_launches"),
                       train_batch=kb["fwd_b3"]),
             timing="device time (CUDA graph replay between CUDA events) "
                    "summed over the flagship's 55 depthwise stages at a "
                    f"600² input, f32: the forward at batch {MAIN_BATCH}, "
                    f"dx (its own kernel, no dilated copy) at batch "
                    f"{TRAIN_BATCH}; bf16: the bf16 instantiation, forward "
                    f"at batch {MAIN_BATCH} (train_batch: {TRAIN_BATCH})"),
        dict(name="depthwise_dx", route="cuda",
             source="deepfake_detection_tpu_torch/csrc/depthwise_dx.cu",
             replaces="deepfake_detection_tpu/ops/depthwise_pallas.py:138 "
                      "(reused for dx by _op_bwd, :387-403)",
             launches=dx_launches, launches_by_path=dx_paths,
             max_abs_err=d["max_abs_err"], max_rel_err=d["max_rel_err"],
             ms=d["ms"], kernel_ms=d["ms"], plain_ms=d["plain_ms"],
             bound_ms=d["bound_ms"],
             bound_by="bytes" if d["bytes_ms"] >= d["ops_ms"]
             else "operations",
             library_ms=d["library_ms"],
             bf16=bf16("dx", kb["errs"]["dx"], "dx_launches"),
             timing="device time (CUDA graph replay between CUDA events) "
                    "summed over the flagship's 55 depthwise stages at a "
                    f"600² input, batch {TRAIN_BATCH}, f32; max_abs_err "
                    "over the f32 cases, max_rel_err over all, relative to "
                    "dx's max |plain|; library: cuDNN's conv2d_input"),
        dict(name="depthwise_dwgrad", route="cuda",
             source="deepfake_detection_tpu_torch/csrc/depthwise_dwgrad.cu",
             replaces="deepfake_detection_tpu/ops/depthwise_pallas.py:214",
             launches=dwg_launches, launches_by_path=dwg_paths,
             max_abs_err=g["max_abs_err"], ms=g["ms"], kernel_ms=g["ms"],
             plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
             bound_by="bytes" if g["bytes_ms"] >= g["ops_ms"]
             else "operations",
             library_ms=g["library_ms"],
             bf16=bf16("dwgrad", kb["errs"]["dwgrad"], "dwgrad_launches"),
             timing="device time (CUDA graph replay between CUDA events) "
                    "summed over the flagship's 55 depthwise stages at a "
                    f"600² input, batch {TRAIN_BATCH}, f32"),
        *flash_entries(fl, fl_autograd, tsf, tsfa, flb)])
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
