#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``coarse_fine_networks_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build of the hand-written kernels from ``csrc/`` (one
   ``nvcc`` for each of the seven sources and g++ for the host entropy
   decoder ``jpeg_entropy.cpp``, started together, beside
   ``-Xptxas -v`` compiles of ``dw_plain_s1.cu``, ``dw_plain_s2.cu``,
   ``dw_mm_act.cu``, ``dw_dx_s1.cu``, ``dw_stencil.cu``,
   ``frame_decode.cu`` (linked with ``-lnvjpeg``; its
   ``crop_resize_kernel`` may not spill) and ``scaled_idct.cu`` (its
   ``idct_rgb_kernel`` may not spill) whose
   registers, spills and static shared memory for each row-strip kernel
   (K1/K6 plain and ``act``, K6 ``mm``; K4 plain, ``act`` and ``mm``, K8,
   K5, K9, K10 plain, ``act`` and ``mm``, the three stride-(2, 2, 2)
   kernels; K1 ``mm``; K3 and K2) and for
   K11 and its taps' gradient (every KT × KS × dtype instantiation) make
   five ``ptxas`` rows, no act or mm instantiation and neither of K11's
   kernels spilling; their dynamic shared memory and blocks per SM are in
   the kernel rows' ``plan``);
2. kernels: each eval bottleneck-entry kernel (``dw_mm_act_s1/s2``)
   against its plain PyTorch version on the card, at the 16 entry shapes
   the serve phase gives it (batch 3 at 224²; the fine tower at T_f=128,
   the coarse tower at T=64 in layer1 and T=17 after Grid Pool, which
   leaves a short last frame segment) and the 8 the fine eval step gives
   it (B8 T64 224²); then each train kernel (the forward ``dw_act_s1/s2``,
   dx ``dw_act_dx_s1/s2`` and weight gradient ``dw_act_wgrad_s1/s2``) at
   the 8 coarse entry shapes the train step gives it (batch 8; T=64 in
   layer1, T=17 after Grid Pool) and the 8 the fine stream's long-cycle
   phase D gives it (B8 T64 224²); all in f32 (TF32 off) and bf16, with
   timings of the kernel, the plain version, the unfused PyTorch sequence
   and the nearest single PyTorch call (each ``dw_mm_act_s1`` row with its
   work split, ``plan_mm_s1``, blocks per SM and waves; each
   ``dw_mm_act_s2`` row (K4 ``mm``) with ``plan_mm_s2_fwd``'s and its exact
   oracle: y equal with a difference of 0 to ``dw_conv_s2`` (K4 plain)
   launched with that plan on K1 ``mm``'s activation, centre tap 1,
   repeating bit for bit); the stride-1 dx
   ``dw_act_dx_s1`` (K3) also against the exact oracle, its dx equal with
   a difference of 0 to ``dw_conv_s1`` of g with the flipped taps in f32,
   masked and scaled as the plain version does, the stride-2 dx
   ``dw_act_dx_s2`` (K5) likewise to ``dw_conv_dx_s2`` (K8) run in f32,
   masked and scaled, both with dx and sums repeating bit for bit, and the
   weight gradients ``dw_act_wgrad_s1/s2`` (K6 and K10 ``act``) to
   ``dw_conv_wgrad_s1/s2`` (K6 and K10 plain) on the activated x, and the
   forwards ``dw_act_s1/s2`` (K1 and K4 ``act``) to ``dw_conv_s1/s2`` (K1
   and K4 plain) on the activated x, each repeating bit for bit; each of
   these rows with its work split (``plan_act_dx_s1``, ``plan_act_dx_s2``,
   ``plan_s1``, ``plan_s2``, ``plan_act_s2_fwd``), blocks per SM and
   waves, and each train kernel's line entry with its time and bound
   summed over one step of long-cycle phase D beside the coarse step's;
2b. relu_branch: the forward and the masked dx take one relu branch: with
   only the centre tap set to 1 the forward's ``y > 0`` must equal the
   mask ``dam != 0`` of ``g = 1`` element for element (K1 ``mm`` against
   K2, K4 ``mm`` against K9, all four conv1's product through
   ``mm_strip_product``) at every entry shape of the eval kernels and of
   the train composite, f32 and bf16; K1 ``mm``'s branch also against
   conv1's product in f64 outside ``mm_band`` and a torch model of the
   in-order f32 ``fmaf`` sum inside it, at every stride-1 shape;
2c. nan: with a NaN in x (inside the frame) and in one channel of sc,
   every relu kernel and masked dx of both train routes against its twin
   at every entry shape, f32 and bf16 (the same NaN positions, the finite
   elements within ``TOL``); then edges: with x's NaN on the first frame,
   the last frame, the last row of a ragged strip or the last column, the
   row-strip weight gradients (K6 and K10 plain, ``act`` and ``mm``, K10
   ``mm`` beside them) against their twins likewise, at the coarse step's
   layer3 and layer4 entries (fault 3.4);
2d. xl_kernels: the three serving kernels at X3D-XL's widths (C_in
   32/72/136/280, C_mid 72/162/306/630; the XL tables checked against the
   port's): K1 ``mm`` and K4 ``mm`` at the 16 entry shapes of a serve
   batch (B3 at 224²; the fine tower at T_f=128, the coarse at T=64, then
   17) and K11 at XL's stem (5×1×1, C=32), each against its plain version
   in f32 (TF32 off) and bf16, timed beside the plain version and the
   unfused sequence or ``F.conv3d(groups=C)``, with its plan and bound;
3. autograd: the train entry's four gradients (dx, dw, dsc, dbi) against
   autograd through the plain composition, f32, one shape per stride;
4. serve: the joint pipeline (X3D-M, 157 classes, bf16, seeded random
   weights) behind ``CachingVideoServer`` on the card, at full width:
   three cold requests (two at T=64/T_f=128, one at T=50/T_f=100 that pads
   into the same bucket) and their cache-hit repeats without fine pixels;
   the kernels' launch counters are read for this run (no train kernel);
5. profile: the device-time breakdown of one cold batch under
   ``torch.profiler`` (kernel time by name, the card's busy share);
6. card_vs_cpu: one small f32 request through the port on the card and on
   the CPU (probabilities, feature banks and the coarse logits);
7. train: the coarse train step at full width (X3D-M, 157 classes, B=8,
   T=64, 224², bf16 activations, f32 parameters, fine banks at T_f=128,
   label length 640, lr 0.02, fusion ×10, dropout 0.5), 2 warm-up steps
   and 10 timed ones, its launch counters read for the timed steps (22
   stride-1 and 4 stride-2 launches of each train kernel per step, no eval
   kernel), then a ``torch.profiler`` breakdown of one step;
7b. utils: ``utils/hw.py`` and ``utils/profiling.py`` on the card:
   ``chip_peaks`` (known, the H100 SXM's figures); ``program_costs`` of one
   step of phase 7's configuration (FLOPs, bytes, each hand-written
   kernel's calls against the launch counters) and ``utilization`` against
   phase 7's mean step time, beside the ``nvidia-smi`` line; the same
   count's FLOPs at the CPU tests' size (B2 T8 64², 7 classes, f32) equal
   on the card and on the CPU; three steps timed by ``StepTimer`` and by
   CUDA events, their sums within 5 %; one step under ``trace``, whose
   file names each hand-written kernel function as often as the counters
   say; then both examples, ``python -m
   coarse_fine_networks_torch.examples.demo_synthetic`` and
   ``demo_serving``, with ``--device cuda``;
8. train_card_vs_cpu: one small f32 train step on the card and on the CPU
   from the same weights (the loss; the gradients per stage and per
   tensor);
9. fine kernels: each kernel of the split-batch-norm route (the forward
   ``dw_conv_s1/s2``, which at stride 1 is also the dx, the stride-2 dx
   ``dw_conv_dx_s2`` and the weight gradient ``dw_conv_wgrad_s1/s2``)
   against its plain version at the fine tower's entry shapes in phases
   A-C of the multigrid long cycle, f32 (TF32 off) and bf16, timed beside
   the plain version and the one PyTorch call that computes the same
   function (``F.conv3d(groups=C)``, ``aten.convolution_backward``); the
   stride-1 forward also against K11 (``dw_stencil_s1``, equal to 0), the
   stride-2 forward against K7 (``dw_stencil_s2``: the same kernel,
   equal to 0), the
   stride-2 dx against K11 on g at the even positions of a zero tensor of
   x's shape with the flipped taps (equal to 0), both weight gradients
   against themselves run again (equal to 0), and each row with its work
   split (``plan_s1``, ``plan_s2_fwd``, ``plan_s2_dx``, ``plan_s2``),
   blocks per SM and waves;
10. fine_autograd: the split route's Function against autograd through
   ``F.conv3d(groups=C)``, f32, one shape per stride;
11. fine_train: fine-stream training under the X3D multigrid long cycle at
   full width (X3D-M, 157 classes, bf16 activations, f32 parameters, the
   fine driver's ``LongCycleSchedule(320, 224, 8)``: phases A-D at B64 T16
   112², B32 T32 144², B16 T32 224², B8 T64 224² with 8, 4, 2 and 1
   batch-norm splits), seeded uint8 clips and multi-hot labels through
   ``model_batch``, 2 warm-up and 5 timed steps per phase with exact
   launch counts (A-C: the split route's kernels only; D: the act-mode
   entry's only), a ``torch.profiler`` breakdown of one step of phases A
   and D (B and C's were cut for the script's time), then the split
   statistics aggregated and one eval step
   (the eval kernels only);
12. fine_card_vs_cpu: one small f32 fine train step at two splits on the
   card and on the CPU from the same weights, held as in phase 8;
13. mm_train_kernels: the four kernels of the matmul-fused train composite
   (the masked dx ``dw_mm_dx_mask_s1/s2`` and the weight gradient
   ``dw_mm_wgrad_s1/s2``) against their plain versions at the coarse train
   step's 8 entry shapes and long-cycle phase D's 8, f32 (TF32 off) and
   bf16, timed beside the plain version, the unfused PyTorch sequence and
   the cuDNN call inside it; the stride-1 masked dx (K2) also against the
   exact oracle: ``dw_conv_s1`` of g with the flipped taps in f32 where K1
   ``mm`` (``dw_mm_act_s1``, centre tap 1) takes the positive relu branch
   at the same x, W1, sc and bi, else 0, in g's dtype, with a difference
   of 0, the stride-2 masked dx (K9) likewise against ``dw_conv_dx_s2``
   (K8) of g in f32, repeating bit for bit, and the stride-1 weight
   gradient (K6 ``mm``) against K6 plain launched with its plan on K1
   ``mm``'s activation (centre tap 1) with a difference of 0, repeating
   bit for bit, and the stride-2 one (K10 ``mm``) likewise against K10
   plain launched with its plan on that activation, each row with its
   work split (``plan_mm_dx_s1``, ``plan_mm_dx_s2``, ``plan_mm_wgrad_s1``,
   ``plan_mm_wgrad_s2``), blocks per SM and waves;
   then the
   composite's Gram xᵀx of each coarse entry, f32 output from bf16 x,
   timed against reading x as f32;
14. mm_autograd: the composite's ``(y, mean, var)`` and five gradients, then
   the eval entry's five gradients, against autograd through the plain
   composition, f32, one shape per stride (the stride-2 one at 7×7);
15. train_mm: phase 7's full-width coarse train step with
   ``CFN_MM_BN_TRAIN=1`` set for this phase only (every bottleneck through
   the composite), 2 warm-up and 10 timed steps with exact launch counts
   (22 stride-1 and 4 stride-2 launches of each ``mm``-route kernel per
   step, no act-route launch) and a profile of one step, beside phase 7;
16. train_mm_card_vs_cpu: phase 8 with the composite;
17. stencil_kernels: the plain-layout depthwise conv's kernels against their
   plain versions, f32 (TF32 off) and bf16, timed beside the plain version
   and the one PyTorch call that computes the same function
   (``F.conv3d(groups=C)`` on channels-last, ``aten.convolution_backward``):
   K11 (``dw_stencil_s1``) and the taps' gradient (``dw_stencil_wgrad``) at
   the stem's ``conv1_t`` (5×1×1, C=24) on every path (serve, the coarse
   train step, long-cycle phases A-D; the taps' gradient also against
   itself run again, bit for bit, with its row count against the port's
   mirror of its split, ``plan_stencil_wgrad``), K11 at 3×3×3 on layer1's
   stride-1 entry (also against ``dw_conv_s1``) and every tap shape at
   ragged sizes, each K11 row with its work split (``plan_stencil_fwd``),
   blocks per SM and waves;
   K7 (``dw_stencil_s2``, K4 plain's kernel counted under K7's name) at
   the train step's four stride-2 entries (also against ``dw_conv_s2``,
   with ``plan_s2_fwd``'s row); each of these 3×3×3 stencils equals the
   other kernel of its function with a difference of 0;
18. stencil_autograd: ``depthwise_conv3d``'s y, dx and taps' gradient at
   both strides against autograd through ``F.conv3d(groups=C)``, f32, and
   the stem's gradients (reaching ``conv1_s``) against autograd through the
   grouped conv;
18b. t2_kernels: the three stride-(2, 2, 2) kernels of ``FineNet``'s
   ``t_downsample`` (``dw_conv_t2``, ``dw_conv_dx_t2``,
   ``dw_conv_wgrad_t2``, each a body of its own on K4 plain's, K8's and
   K10 plain's threads) against their plain versions at the four
   ``t_downsample`` entries at B32 T16 224² and at B64 T16 112² and at
   ragged sizes, f32 (TF32 off) and bf16, timed beside the plain version
   and ``F.conv3d(groups=C, stride=2)`` or its
   ``aten.convolution_backward``, with each kernel's device time
   (``queued_ms``) a line of its own, each row with its work split
   (``plan_t2_fwd``, ``plan_t2_dx``, ``plan_t2``), staging mode, blocks per
   SM, waves, registers and spills; each also equal with a difference of 0
   to its stride-(1, 2, 2) kernel (K4 plain's frames 0, 2, ...; K8 and K10
   plain on g at the even frames of a zero tensor of T frames) and the
   weight gradient to itself run again; then the forward and the dx with a
   NaN of x or g planted on the first and last frame, a ragged strip's last
   row, column 0, the last column and inside a neighbouring tile's 16-byte
   span, f32 and bf16, NaN exactly where the plain versions put it;
18c. variants: each ``CoarseNet`` option (``t_pool`` avg, max, stride and
   None; ``learned_mixing=False``; ``is_mixing=False``; ``task='class'``) at
   the train step's shapes (X3D-M, 157 classes, bf16, B8 T64 224², banks
   at T_f=128) by the act route: a warm-up and a counted train step
   against labels at the logits' length, an eval forward, the logits'
   shape, exact launches and peak memory; then ``FineNet(t_downsample=True,
   task='class')``, 400 classes, at B32 T16 224² (1 split) and B64 T16
   112² (8 splits): a class train step and an eval step with exact
   launches (4 of each t2 kernel a step, 4 ``dw_conv_t2`` an eval), peak
   memory, and one step profiled (no grouped conv left to PyTorch);
18d. remat: the coarse train step by the act route and by the composite,
   long-cycle phases A and D, each without ``remat``, with it and without
   again from the same weights, batch and dropout draws: the loss, every
   gradient and every batch-norm statistic of the remat run against the
   plain run within 4× the two plain runs' own spread (exactly where the
   step repeats bit for bit), the forward kernels launched twice and the
   backward kernels once a remat step, step ms and peak memory with and
   without;
19. driver: the port's three entry points in sequence at full width
   (X3D-M, 157 classes, bf16, 224²): ``generate_mini_charades`` (12
   videos, 8 of them training, of 640 frames at 256², so the train clips
   have the train step's T = 64), ``extract_driver.run`` over both splits
   with a seeded FineNet saved as a reference-named ``.pt``, and
   ``coarse_driver.run`` (B8, 4 loader workers, device prefetch 2, 3 steps,
   a checkpoint every 3, validation of 4 videos after every step's epoch
   with the localize CSV, the ``.pt`` as its Kinetics checkpoint), then a
   run resumed at step 3 (epoch 2, batch 1) to step 4; finite losses and
   ``val_map``, 157 probabilities in every CSV row, every kernel of the
   path launched and none off it; the extraction's seconds, the host-clock
   step ms, the share of each step spent waiting on the device prefetcher
   and the validation seconds; then one driver step profiled
   (``driver_profile``: its launches equal to the counters, 22 and 4 of
   each act kernel, K11 2 and its taps' gradient 1).  This phase decodes
   with Pillow (the datasets' native decoder turned off), the baseline of
   the packed phase; every later driver-level phase decodes natively
   (the host entropy decoder, ``idct_rgb_kernel`` and
   ``crop_resize_kernel``), as the drivers do by default;
19b. repro (fault 3.7): the f32 coarse step (B8 T64 224², TF32 off, act
   route) twice from one state, every aten op's and kernel launch's data
   fingerprinted (an order-free integer sum of the bits, weighted by
   position): whether the runs repeat bit for bit, the first op where they
   part, every aten op that gave other outputs from equal inputs, and each
   hand-written kernel's outputs run to run, which must be equal wherever
   its inputs were;
19c. decode: the exact mode on 640×480 synthetic JPEGs (noise, smooth
   and grey frames; centre and two random crops, out 224 and 112):
   baseline and progressive frames, frames cut short and the fixtures
   Pillow cannot write (``tests/torch_port_jpegs/``: arithmetic sequential
   and progressive, sequential in three scans) on the port's own path (the
   host entropy decoder, ``idct_rgb_kernel``, ``crop_resize_kernel``), the
   card equal to the CPU (a difference of 0) and no frame to nvJPEG; a
   progressive frame cut where libjpeg smooths raises naming it, and so
   does the RGB-transform fixture on the card (nvJPEG reads it as YCbCr);
   nvJPEG's route on two 640×480 4:1:1 fixtures (which the entropy decoder
   leaves to it by its header): ``crop_resize_kernel`` against
   ``crop_resize_plain`` on the same nvJPEG frames (equal bit for bit),
   nvJPEG + kernel against Pillow + plain (max and mean |difference| held
   to ``DECODE_BOUND``, twice the measured; R and B swapped on the smooth
   one and a crop shifted one pixel on the noisy one must read outside it);
   each route's frames counted (``DECODES``); grey frames giving three
   equal channels; a clip of mixed sizes, kinds and routes; the kernel
   timed on one clip's 64 frames beside its bound, its plain version and
   ``F.interpolate``, and nvJPEG's decode of the clip beside Pillow's; and
   ``CROP_THREADS`` threads, each on a stream of its own, launching the
   kernel at once with crops that need different shared memory, as a
   loader's workers do (no launch refused, each equal to the plain
   version); the phase pins the exact mode (``set_fast_decode(False)``)
   and restores the default after;
19d. fast_decode: ``idct_rgb_kernel`` on 640×480 synthetic JPEGs (noise
   and smooth frames in 4:2:0 and 4:2:2, noise in 4:4:4, grey frames) at
   out 224 (num 4), 112 (num 2) and 56 (num 1) centre crops, two train
   crops at num 4, a train crop at 8/8 (the fancy filters) and the raw
   frame, and on seeded 4:4:0 coefficients: against its plain version on
   the card (a difference of 0), and on seeded 4:2:0 coefficients past the
   8-bit range at every size (libjpeg-turbo's SIMD IDCT's 16-bit lanes),
   and the card's decode (``decode_crop_resize``) against the CPU's
   (equal); progressive frames
   of three layouts, frames cut short and the arithmetic and multi-scan
   fixtures at num 4 and 8/8, card against CPU and none to nvJPEG; the
   4:1:1 fixture raises below 8/8 and takes nvJPEG at 8/8, the
   RGB-transform fixture raises on the card;
   ``FAST_THREADS`` threads decode at once, each on its own stream (no
   launch refused, each equal to the CPU); at two full-size shapes (64
   frames: 640×480 centre crops at num 4, 480² train crops at 8/8) the
   kernel alone (``queued_ms``) and as a call beside its bound and plain
   version, the entropy decoder's ms a frame (1, 4 and 8 threads) of
   baseline and progressive noise beside nvJPEG's full decode, and a
   clip's decode call (at num 4 also in the exact mode, and Pillow's
   ``draft`` decode);
19e. packed: the native data plane end to end on a Multi-THUMOS tree
   (``generate_mini_charades``' frames at 480², videos renamed
   ``video_validation_*`` and ``video_test_*``, annotations converted by
   ``convert_annotations`` to 65 classes): ``cli.pack_dataset`` as a
   process, the dataset's clips a second from the packs against Pillow,
   then ``extract_driver.run`` and ``coarse_driver.run`` with ``pack_dir``
   (X3D-M, 65 classes, B8 T64 224², bf16, 3 steps and a validation); no
   frame decoded by Pillow or read from its file; in the fast mode (the
   default), every clip through the port's decode (the host entropy
   decoder and ``idct_rgb_kernel``: the extraction's centre crops at num
   4, the train crops at 8/8), then ``crop_resize_kernel`` (once per group
   of frames), nvJPEG decoding none, the extraction's and every step's
   launches held exactly; step ms and the wait share beside the driver
   phase's, which decodes with Pillow, and beside the same extraction and
   coarse run in the exact mode (counted the same way);
20. kinetics: Kinetics-style pretraining as a user runs it:
   ``generate_mini_kinetics`` (44 videos of 96 frames at 256², 400
   classes: 33 training, 11 validation), then
   ``cli.pretrain_kinetics.main`` at its defaults (X3D-M, B32, T16, 224²,
   bf16, lr 0.1) with ``--max-steps 2 --max-epochs 2 --num-workers 4``:
   finite losses and top-1, the final checkpoint written, every step's
   and validation batch's launches recorded (the act route's 22/4 of
   each act kernel, K11 2, its dk 1 a step; the eval entry's 22/4 and K11
   1 a batch) and summing to the counters; then one class step at B32 T16
   224² profiled (``kinetics_profile``);
21. fine_driver: ``fine_driver.run`` under the long cycle at full width
   (``LongCycleSchedule(320, 224, 2)``, the base batch cut from 8 to 2:
   B16 T16 112², B8 T32 144², B4 T32 224², B2 T64 224² with 8, 4, 2, 1
   splits), 157 classes, bf16, lr 0.01, from the kinetics phase's
   checkpoint, on 20 synthetic videos (16 training) of 640 frames at
   256²: one epoch a phase, 15 steps and a validation, a checkpoint every
   5; then a run resumed from step 5 (inside phase C: epoch 2, batch 2)
   to the cycle's end; every call's launches held against its route
   (split-bn in A-C, act in D, the eval entry in validation) and the
   counters, step ms and the wait share by phase;
22. cli: a user's pipeline through the command lines' ``main(argv)`` at
   their defaults on the driver phase's tree, given only paths,
   ``--max-steps``, ``--max-epochs`` and ``--num-workers``:
   ``train_fine`` from the kinetics checkpoint (B8 T64: 4 steps, a
   validation, 1 step), ``extract_fineFEAT`` with the fine_driver phase's
   last checkpoint, ``train_coarse_fineFEAT`` at B6 with the localize CSV
   (157 probabilities a row); each run's launches held as above; one
   coarse step at B6 T64 224² profiled (``cli_coarse_profile``);
   ``train_coarse_fineFEAT --remat`` on the same features (2 steps, a
   validation; the bottlenecks' forward kernels twice a step); and
   ``--help`` of each command line as ``python -m``;
23. serve_http: (a) ``python -m coarse_fine_networks_torch.cli.serve`` at
   its defaults as a process on the fine_driver phase's last checkpoint,
   the driver phase's last coarse checkpoint and the cli phase's
   extraction bank
   (``--prewarm-dir``, ``--port 0``): three prewarmed hits, one cold video
   (T=64/T_f=128 224²) and its repeat over loopback, each within 1e-3 of a
   direct bf16 call of the same assembled weights in this process;
   ``/v1/models``, ``/v1/stats`` (4 hits, 1 miss), ``/healthz``; SIGTERM
   and exit code 0; (b) ``cli.serve.build_server`` with X3D-M (seeded) and
   X3D-XL (``cfn-xl``, seeded) on one router, cold and hit batches of the
   serve phase's three videos to each in turn over HTTP with exact launch
   counts (M 44/8/2 cold, 22/4/1 hit of K1 ``mm``/K4 ``mm``/K11; XL 102/8/2
   and 51/4/1; nothing else), an alias and a canary of 0.5 (200 ids against
   ``_split_key``, three routed hits against their variant's), and 404,
   400, 429, 504 and 503 each from one request; per-request latency, the
   server's extract/fuse ms per variant, body bytes and peak memory;
24. dp_train: data-parallel training through ``parallel.mesh.spawn``,
   two ranks sharing the one card over gloo (NCCL refuses two ranks on
   one card): the coarse train step (X3D-M, 157 classes, B8 T64 224²) by
   the act route and with ``CFN_MM_BN_TRAIN=1``, then long-cycle phase B
   (T32 144², 4 splits), each in bf16 (phase B at B32) and in f32 with
   TF32 off (phase B at B16), each rank on half the rows against one
   process on the whole batch from the same weights, batch and dropout
   draws: the loss and, per stage, the running statistics and (in f32)
   the gradients within twice the one-process step's largest movement
   under a one-ulp change of its clips (three draws); in bf16 that
   movement of the gradients is O(1), so there they are printed only.  In
   f32 two planted faults must fall outside the gradients' bound (the
   statistics' all-reduce passing its gradient on unreduced; each rank's
   loss its local mean).  Both ranks equal, each rank's launches one
   step's of its route, its peak GB and step ms; then the coarse act step
   through the same spawn path at world size 1 over NCCL, equal to the
   one-process step within 4× its run-to-run spread;
25. dp_serve: ``CachingVideoServer`` over ``[cuda:0, cuda:0]`` (two X3D-M
   replicas) against the one-device server on the serve phase's videos,
   cold and hit, with exact launches, in bf16 and in f32 (where a server
   answering one video with another's rows must fall outside the bound);
   then the tensor-parallel extract (``parallel.tensor.make_tp_tower``,
   two shards on ``cuda:0``, widths padded to 16·k) against the unpadded
   tower, bf16 and f32, with exact launches (K1 ``mm`` and K4 ``mm`` on
   each shard, K11 once);
26. dp_cli: ``cli.train_coarse_fineFEAT --mesh-devices 2`` at its defaults
   on the driver phase's tree and the cli phase's bank (B6 T64 224²: 3
   rows a rank; a checkpoint every step, validation with the CSV on rank
   0), then the command line again resumed from rank 0's step-2
   checkpoint; the val mAP against the one-process validation of that
   checkpoint in this process, each rank's launches (``_rank_launches``)
   against its steps and rank 0's validation;
27. a ``{"kernels": [...]}`` line (24 entries, each with its launches on
   the driver, kinetics, fine_driver, cli and serve_http paths beside the
   earlier phases', a rank's on the dp_train path and both ranks' on the
   dp_cli path, and for K1 ``mm``, K4 ``mm`` and K11 an ``xl`` entry:
   XL's times and launches), after a ``script`` line with the whole run's
   seconds, then the card's ``nvidia-smi`` line, then ``{"ok": true,
   "device": {...}}`` last.  Every phase line carries ``t_s``, the seconds
   since the script started.

The stem's ``conv1_t`` runs through ``dw_stencil_s1`` on every path: the
serve, train, train_mm and fine_train phases hold its launches exactly (a
cold serve batch 2, a hit 1; per train step on either coarse route and per
long-cycle step 2 ``dw_stencil_s1`` and 1 ``dw_stencil_wgrad``; the fine
eval step 1; ``dw_stencil_s2`` never), and every profile fails on a grouped
depthwise convolution left to PyTorch.  Every profile (serve, train,
train_mm, fine_train) also holds each port kernel's profiled launches, by
kernel function, against the wrappers' counters for the profiled call
itself, in the timed run and in the shape-recording run.

``CFN_MM_BN_TRAIN`` is cleared at the start, so every other phase runs the
route it names.

Any failed check raises and the script exits non-zero before the last line.
It needs no network and writes nothing outside the checkout (the kernel
build goes to ``coarse_fine_networks_torch/_build/``, the driver-level
phases' data, checkpoints and features to ``_scratch/chip_smoke_drivers/``,
removed at the end; the parallel phases' ranks hand their results back
through a temporary directory under ``TMPDIR``, removed when they end).
The driver-level phases' four synthetic trees are written by four
worker processes (spawned, seeded) while the kernel phases run, the packed
phase starts the pack command line as a process, the serve_http phase
starts the serving CLI as a process, and the parallel
phases spawn their ranks; each is joined or stopped before the script
ends.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
# the driver-level phases' data, checkpoints and features (removed at exit)
SCRATCH = REPO / "_scratch" / "chip_smoke_drivers"
# kernel vs plain, as a fraction of max|plain|: f32 sums in another order;
# bf16 output rounding (and the odd flip of a bf16-rounded activation)
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# a small f32 train step, card against CPU: a relu input within a rounding
# of 0 can take the other branch, and batch norm over a few dozen elements
# carries that into every gradient upstream.  The JAX package's own two
# trunk layouts, the same math in another order, differ on these
# configurations by up to 4.85e-2 (fine) and 4.3e-2 (coarse) relative L2
# per stage, and by up to 0.44 and 0.42 per tensor (largest difference over
# the tensor's largest magnitude; tests/_torch_port_layout_spread.py).  A
# fault of wiring or of a kernel moves a tensor by O(1)
GRAD_STAGE_TOL = 5e-2
GRAD_TENSOR_TOL = 0.5
# gradients that are zero up to rounding (a bias taken out again by a
# training-mode batch norm), as a fraction of the largest gradient: at most
# 2.5e-8 on the card and on the CPU; held on both devices instead of the per-tensor bound
ZERO_GRAD = 1e-6
COARSE_ZERO_GRADS = (
    "pool_1.conv1.bias", "pool_1.conv2.bias",  # before Grid Pool's bn1, bn2
    # the fusion's additive maps, added before a stage's first conv and bn
    *(f"rw{i}.fc2.bias" for i in range(2, 6)),
    *(f"mix{i}.conv_at.bias" for i in range(2, 6)))
# bottleneck entries per stage at 224²: (stage, H_in and C_in of block 0
# (stride 2), H_in and C_in after it, C_mid, bottlenecks in the stage)
ENTRY_SHAPES = [
    ("layer1", 112, 24, 56, 24, 54, 3),
    ("layer2", 56, 24, 28, 48, 108, 5),
    ("layer3", 28, 48, 14, 96, 216, 11),
    ("layer4", 14, 96, 7, 192, 432, 7),
]
# X3D-XL's entries, as ENTRY_SHAPES (the port's ``get_inplanes("XL")``:
# (72, 32), (162, 72), (306, 136), (630, 280); ``get_blocks``: 5, 10, 25,
# 15), and its stem's channels
XL_ENTRY_SHAPES = [
    ("layer1", 112, 32, 56, 32, 72, 5),
    ("layer2", 56, 32, 28, 72, 162, 10),
    ("layer3", 28, 72, 14, 136, 306, 25),
    ("layer4", 14, 136, 7, 280, 630, 15),
]
XL_STEM_C = 32
# the serve phase's batches: B videos, each tower's frames per stage (the
# coarse tower runs layers 2-4 on the T/4+1 frames Grid Pool keeps), and the
# tower's calls in that phase's counted run (fine: one cold extract; coarse:
# the cold fuse and the hit fuse)
SERVE_B = 3
TOWERS = {
    "fine": ({"layer1": 128, "layer2": 128, "layer3": 128, "layer4": 128}, 1),
    "coarse": ({"layer1": 64, "layer2": 17, "layer3": 17, "layer4": 17}, 2),
}
_DW_FOLD = "coarse_fine_networks_tpu/ops/pallas/dw_fold.py"
_DW_CONV = "coarse_fine_networks_tpu/ops/pallas/dw_conv.py"
REPLACES = {
    "dw_mm_act_s1": f"{_DW_FOLD}:532",     # _dw_fold4_pcall, mm mode
    "dw_mm_act_s2": f"{_DW_FOLD}:1078",    # _fwd_s2_direct_pcall, mm mode
    "dw_act_s1": f"{_DW_FOLD}:532",        # _dw_fold4_pcall, act mode
    "dw_act_s2": f"{_DW_FOLD}:1078",       # _fwd_s2_direct_pcall, act mode
    "dw_act_dx_s1": f"{_DW_FOLD}:615",     # _dx_act_pcall
    "dw_act_dx_s2": f"{_DW_FOLD}:660",     # _dx_s2_act_pcall
    "dw_act_wgrad_s1": f"{_DW_FOLD}:705",  # _dw_fold4_wgrad_pcall, act mode
    "dw_act_wgrad_s2": f"{_DW_FOLD}:1279",  # _wgrad_s2_pcall, act mode
    "dw_conv_s1": f"{_DW_FOLD}:532",       # _dw_fold4_pcall, plain mode
    "dw_conv_s2": f"{_DW_FOLD}:1078",      # _fwd_s2_direct_pcall, plain mode
    "dw_conv_dx_s2": f"{_DW_FOLD}:1208",   # _dx_s2_pcall (K8)
    "dw_conv_wgrad_s1": f"{_DW_FOLD}:705",  # _dw_fold4_wgrad_pcall, plain
    "dw_conv_wgrad_s2": f"{_DW_FOLD}:1279",  # _wgrad_s2_pcall, plain mode
    "dw_mm_dx_mask_s1": f"{_DW_FOLD}:576",  # _dx_mask_pcall (K2)
    "dw_mm_dx_mask_s2": f"{_DW_FOLD}:1239",  # _dx_s2_mask_pcall (K9)
    "dw_mm_wgrad_s1": f"{_DW_FOLD}:705",   # _dw_fold4_wgrad_pcall, mm mode
    "dw_mm_wgrad_s2": f"{_DW_FOLD}:1279",  # _wgrad_s2_pcall, mm mode
    "dw_stencil_s1": f"{_DW_CONV}:158",    # _dw_pallas_raw (K11)
    "dw_stencil_s2": f"{_DW_FOLD}:786",    # _dw_fold4_s2_raw (K7)
    "dw_stencil_wgrad": f"{_DW_CONV}:262",  # _dw_bwd's per-tap reduce
    # stride (2, 2, 2), FineNet's t_downsample: no TPU kernel (the JAX
    # package runs it in XLA, _lax_conv, on its plain layout)
    "dw_conv_t2": f"none: XLA {_DW_CONV}:287 (_lax_conv)",
    "dw_conv_dx_t2": f"none: XLA's transpose of {_DW_CONV}:287 (_lax_conv)",
    "dw_conv_wgrad_t2": f"none: XLA's transpose of {_DW_CONV}:287 "
                        "(_lax_conv)",
    # the clip frames' crop and resize: no TPU kernel (the JAX package runs
    # it in host C++, its native data plane's exact path)
    "crop_resize_kernel": "none: host C++ native/cfn_data.cpp:132 "
                          "(crop_resize; center_crop_scale :262)",
    # the decode's pixel work: no TPU kernel (the JAX package runs
    # libjpeg-turbo's full and scaled decodes in host C++)
    "idct_rgb_kernel": "none: host C++ native/cfn_data.cpp:68 (decode_rgb) "
                       "and :171 (decode_crop_scaled): libjpeg-turbo's "
                       "jpeg_idct_islow/4x4/2x2/1x1, jdsample.c's "
                       "upsampling, ycc_rgb_convert",
}
_CSRC = "coarse_fine_networks_torch/csrc/"
FAST_KERNELS = ("idct_rgb_kernel",)
SOURCES = {k: _CSRC + ("dw_stencil.cu" if k in ("dw_stencil_s1",
                                                 "dw_stencil_wgrad")
                       else "dw_plain_s1.cu" if k in ("dw_conv_s1",
                                                      "dw_conv_wgrad_s1",
                                                      "dw_act_s1",
                                                      "dw_act_wgrad_s1",
                                                      "dw_mm_wgrad_s1")
                       else "dw_plain_s2.cu" if (k.startswith("dw_conv_")
                                                 or k in ("dw_stencil_s2",
                                                          "dw_act_s2",
                                                          "dw_act_dx_s2",
                                                          "dw_act_wgrad_s2",
                                                          "dw_mm_act_s2",
                                                          "dw_mm_dx_mask_s2",
                                                          "dw_mm_wgrad_s2"))
                       else "dw_dx_s1.cu" if k in ("dw_act_dx_s1",
                                                    "dw_mm_dx_mask_s1")
                       else "frame_decode.cu" if k == "crop_resize_kernel"
                       else "scaled_idct.cu" if k in FAST_KERNELS
                       else "dw_mm_act.cu") for k in REPLACES}
# the kernel function (as the profiler names it) behind each counted
# wrapper entry
KERNEL_FUNCS = {
    "mm_s2_fwd_kernel": ("dw_mm_act_s2",),
    "mm_fwd_s1_kernel": ("dw_mm_act_s1",),
    "act_fwd_s1_kernel": ("dw_act_s1",),
    "act_s2_fwd_kernel": ("dw_act_s2",),
    "act_dx_s1_kernel": ("dw_act_dx_s1",),
    "mm_dx_s1_kernel": ("dw_mm_dx_mask_s1",),
    "act_s2_dx_kernel": ("dw_act_dx_s2",),
    "mm_s2_dx_kernel": ("dw_mm_dx_mask_s2",),
    "act_wgrad_s1_kernel": ("dw_act_wgrad_s1",),
    "act_s2_wgrad_kernel": ("dw_act_wgrad_s2",),
    "mm_wgrad_s1_kernel": ("dw_mm_wgrad_s1",),
    "mm_s2_wgrad_kernel": ("dw_mm_wgrad_s2",),
    "plain_fwd_kernel": ("dw_conv_s1",),
    "plain_wgrad_kernel": ("dw_conv_wgrad_s1",),
    "plain_s2_fwd_kernel": ("dw_conv_s2", "dw_stencil_s2"),  # K4 plain, K7
    "plain_s2_dx_kernel": ("dw_conv_dx_s2",),
    "plain_s2_wgrad_kernel": ("dw_conv_wgrad_s2",),
    "stencil_fwd_kernel": ("dw_stencil_s1",),
    "stencil_dk_kernel": ("dw_stencil_wgrad",),
    "plain_t2_fwd_kernel": ("dw_conv_t2",),
    "plain_t2_dx_kernel": ("dw_conv_dx_t2",),
    "plain_t2_wgrad_kernel": ("dw_conv_wgrad_t2",),
}
# the act route's kernel functions, as the train and phase-D profiles sum
# them
ACT_FUNCS = ("act_fwd_s1_kernel", "act_s2_fwd_kernel", "act_dx_s1_kernel",
             "act_s2_dx_kernel", "act_wgrad_s1_kernel", "act_s2_wgrad_kernel")
MM_KERNELS = ("dw_mm_act_s1", "dw_mm_act_s2")
# the train step: batch, frames per stage (layers 2-4 run on the T/4+1
# frames Grid Pool keeps), fine banks, label length
TRAIN = dict(b=8, t=64, hw=224, tf=128, tl=640, n_classes=157, lr=0.02,
             fusion_lr_mult=10.0, warmup=2, steps=10)
TRAIN_FRAMES = {"layer1": 64, "layer2": 17, "layer3": 17, "layer4": 17}
BANKS = (("layer1", 24), ("layer2", 48), ("layer3", 96), ("layer4", 192),
         ("conv5", 432))
# fine-stream training: the fine driver's long cycle (frames, crop, batch of
# phase D; the schedule scales them per phase), clip length 2·frames/10,
# label window 2·frames
FINE = dict(base=(320, 224, 8), n_classes=157, lr=0.01, dropout=0.5,
            warmup=2, steps=5)
# the long-cycle phases whose step fine_train profiles
FINE_PROFILED = ("A", "D")
FINE_KERNELS = ("dw_conv_s1", "dw_conv_s2", "dw_conv_dx_s2",
                "dw_conv_wgrad_s1", "dw_conv_wgrad_s2")
ACT_KERNELS = tuple(f"dw_act{p}_s{s}" for p in ("", "_dx", "_wgrad")
                    for s in (1, 2))
# the backward kernels of the matmul-fused train composite (its forward is
# MM_KERNELS)
MM_TRAIN_KERNELS = ("dw_mm_dx_mask_s1", "dw_mm_dx_mask_s2", "dw_mm_wgrad_s1",
                    "dw_mm_wgrad_s2")
# (stage, C_mid, bottlenecks in the stage)
STAGES = (("layer1", 54, 3), ("layer2", 108, 5), ("layer3", 216, 11),
          ("layer4", 432, 7))
# the stem's conv1_t: channels and taps; the kernels of the plain-layout
# depthwise conv, and their launches per train step on every route and
# long-cycle phase (the forward and the dx, the taps' gradient)
STEM_C, STEM_K = 24, (5, 1, 1)
STENCIL_KERNELS = ("dw_stencil_s1", "dw_stencil_s2", "dw_stencil_wgrad")
STEM_TRAIN = {"dw_stencil_s1": 2, "dw_stencil_s2": 0, "dw_stencil_wgrad": 1}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


# the script's start, for each phase line's "t_s"
T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """Print ``obj`` as a JSON line; a phase's line carries the seconds
    since the script started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 50) -> dict:
    """The device's time a call of ``fn`` (``ms``): CUDA events around
    ``iters`` calls queued behind a device sleep (``torch.cuda._sleep``)
    that outlasts their enqueue on the host, so the device runs them back
    to back and never waits on the host; ``host_ms`` is the enqueue a call,
    ``slept_ms`` the sleep (checked: the enqueue ended inside it; a longer
    sleep is tried where host jitter made it outlast one)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sleep = 4 * (time.perf_counter() - t0) * 1e3 + 2  # ms
    torch.cuda.synchronize()
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(int(sleep * 2e6))  # >= sleep ms at up to 2 GHz
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enq = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        slept = ev[0].elapsed_time(ev[1])
        if enq < 0.8 * slept:
            return {"ms": ev[1].elapsed_time(ev[2]) / iters,
                    "host_ms": enq / iters, "slept_ms": slept}
        sleep *= 4
    raise CheckFailed(f"queued_ms: the enqueue ({enq} ms) outlasted the "
                      f"sleep ({slept} ms)")


def entry_cases(shapes=None, eval_step: bool = True):
    """(kernel, label, B, T, H, W, C_in, C_mid, stride, launches, counted) of
    the entry shapes the eval kernels get: the 16 of the serve phase (8 per
    tower, at its batch; ``launches`` is how often the counted serve run
    launches each, and these rows make up the kernel's line) and, with
    ``eval_step``, the 8 of the fine eval step (long-cycle phase D's B8 T64
    224², every stage at T=64; ``launches`` per eval step).  ``shapes``:
    the model's entries per stage (``ENTRY_SHAPES``, X3D-M's, by
    default)."""
    shapes = ENTRY_SHAPES if shapes is None else shapes
    towers = [(tower, SERVE_B, frames, calls, True)
              for tower, (frames, calls) in TOWERS.items()]
    if eval_step:
        _, b_d, t_d, crop_d, _, _ = fine_phase("D")
        check(crop_d == 224, f"phase D crop {crop_d}: ENTRY_SHAPES are at "
                             "224²")
        towers.append(("fine_eval.D", b_d, dict.fromkeys(TRAIN_FRAMES, t_d),
                       1, False))
    for tower, b, frames, calls, counted in towers:
        for layer, h_s2, cin_s2, h_s1, cin_s1, c_mid, n in shapes:
            t = frames[layer]
            yield ("dw_mm_act_s2", f"{tower}.{layer}.0", b, t, h_s2, h_s2,
                   cin_s2, c_mid, 2, calls, counted)
            yield ("dw_mm_act_s1", f"{tower}.{layer}.1-{n - 1}", b, t, h_s1,
                   h_s1, cin_s1, c_mid, 1, (n - 1) * calls, counted)


def _ptxas(source: Path) -> dict:
    """``nvcc -Xptxas -v`` of one source compiled to a cubin (into the
    build directory): registers, spill bytes and static shared memory of
    each kernel, by mangled name."""
    from coarse_fine_networks_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
         str(_build.BUILD_DIR / f"{source.stem}.cubin"), str(source)],
        capture_output=True, text=True, check=True)
    out, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            stack = re.search(r"(\d+) bytes stack frame", line)
            out[name].update(spill_stores=int(st), spill_loads=int(ld),
                             stack_frame=int(stack.group(1)) if stack else 0)
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return out


# the ptxas rows: each source's kernel functions of the row-strip layout
# (three row counts: 2-4) in f32 and bf16, and K11 and its taps' gradient
# (four KT and two KS, in f32 and bf16)
PTXAS = {"dw_conv_s1": ("plain_fwd_kernel", "act_fwd_s1_kernel",
                        "plain_wgrad_kernel", "act_wgrad_s1_kernel",
                        "mm_wgrad_s1_kernel"),
         "dw_conv_s2": ("plain_s2_fwd_kernel", "act_s2_fwd_kernel",
                        "mm_s2_fwd_kernel", "plain_s2_dx_kernel",
                        "act_s2_dx_kernel", "mm_s2_dx_kernel",
                        "plain_s2_wgrad_kernel", "act_s2_wgrad_kernel",
                        "mm_s2_wgrad_kernel", "plain_t2_fwd_kernel",
                        "plain_t2_dx_kernel", "plain_t2_wgrad_kernel"),
         "dw_mm_act_s1": ("mm_fwd_s1_kernel",),
         "dw_act_dx_s1": ("act_dx_s1_kernel", "mm_dx_s1_kernel"),
         "dw_stencil_wgrad": ("stencil_fwd_kernel", "stencil_dk_kernel"),
         "crop_resize_kernel": ("crop_resize_kernel",),
         "idct_rgb_kernel": FAST_KERNELS}
# instantiations of each function of a ptxas row (by row, or by function:
# the t2 forward and dx have a whole-pixel and a pairs mode each)
PTXAS_EACH = {"dw_stencil_wgrad": 16, "crop_resize_kernel": 1,
              "idct_rgb_kernel": 1,
              "plain_t2_fwd_kernel": 12, "plain_t2_dx_kernel": 12}
# the act and mm modes of the row-strip bodies, K11 and its taps' gradient,
# the crop kernel and the stride-(2, 2, 2) weight gradient: no instantiation
# may spill
NO_SPILL = ("act_fwd_s1_kernel", "act_wgrad_s1_kernel", "mm_wgrad_s1_kernel",
            "act_s2_fwd_kernel", "act_s2_wgrad_kernel", "mm_s2_fwd_kernel",
            "mm_s2_dx_kernel", "mm_s2_wgrad_kernel", "stencil_fwd_kernel",
            "stencil_dk_kernel", "crop_resize_kernel", *FAST_KERNELS,
            "plain_t2_fwd_kernel", "plain_t2_dx_kernel",
            "plain_t2_wgrad_kernel")
# each ptxas row's kernels by mangled name (phase_device), for the rows of
# the phases that print a kernel's registers and spills beside its times
PTXAS_ROWS: dict = {}


def phase_device() -> str:
    from concurrent.futures import ThreadPoolExecutor

    from coarse_fine_networks_torch.ops import (_build, dw_conv, dw_stencil,
                                                frame_decode, scaled_decode)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    # the seven CUDA sources (one nvcc each), the host entropy decoder
    # (g++) and the ptxas reports of the seven rows, all started together
    libs = dw_conv.LIBRARIES + (dw_stencil.LIBRARY, frame_decode.LIBRARY,
                                scaled_decode.LIBRARY, scaled_decode.ENTROPY)
    with ThreadPoolExecutor(max_workers=len(PTXAS)) as pool:
        ptxas = {k: pool.submit(_ptxas, REPO / SOURCES[k]) for k in PTXAS}
        _build.build_all(libs)
        ptxas = {k: f.result() for k, f in ptxas.items()}
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "sources": [lib.source.name for lib in libs],
          "build_s": round(time.perf_counter() - t0, 3)})
    for key, funcs in PTXAS.items():
        rows = {n: v for n, v in ptxas[key].items()
                if any(f in n for f in funcs)}  # mangled names
        emit({"phase": "ptxas", "source": SOURCES[key], "kernels": rows})
        PTXAS_ROWS[key] = rows
        check(len(rows) == sum(PTXAS_EACH.get(f, PTXAS_EACH.get(key, 6))
                               for f in funcs)
              and all("registers" in v for v in rows.values()),
              f"ptxas report of {SOURCES[key]}: {ptxas[key]}")
        spilled = {n: v for n, v in rows.items()
                   if any(f in n for f in NO_SPILL)
                   and (v.get("spill_stores") or v.get("spill_loads"))}
        check(not spilled, f"kernels spill: {spilled}")
    return smi


def _plan_row_mm_s2(dw_conv, name, shape, c_mid, dtype) -> dict:
    """The work split of K4 mm (``dw_mm_act_s2``, ``plan_mm_s2_fwd``) or
    K9 (``dw_mm_dx_mask_s2``, ``plan_mm_dx_s2``) at x ``shape`` (C_in
    last) and ``c_mid``, and what the card makes of it: threads, blocks,
    shared memory, blocks per SM (the occupancy API: at least the two each
    plan is cut for) and waves."""
    b, t, h, w, c_in = shape
    esz, bf16 = torch.finfo(dtype).bits // 8, int(dtype == torch.bfloat16)
    lib = dw_conv.LIBRARY_S2.build()
    if name == "dw_mm_act_s2":
        p = dw_conv.plan_mm_s2_fwd(b, t, h, w, c_in, c_mid, esz)
        occ = lib.dw_mm_act_s2_occupancy(p.r, p.wb, p.pg, c_in, w, bf16)
        smem = dw_conv.smem_mm_s2_fwd(p, c_in, esz, w)
    else:
        p = dw_conv.plan_mm_dx_s2(b, t, h, w, c_in, c_mid, esz)
        occ = lib.dw_mm_dx_mask_s2_occupancy(p.r, p.wb, p.pg, p.tt, c_in, w,
                                             bf16)
        smem = dw_conv.smem_mm_dx_s2(p, c_in, esz, w)
    check(occ >= 2, f"{name} plan {p} {dtype}: {occ} blocks per SM, not "
                    f"the plan's 2")
    blocks = p.items * p.n_pg
    return {"r": p.r, "wb": p.wb, "pg": p.pg, "tt": p.tt,
            "threads": p.threads, "blocks": blocks, "smem": smem,
            "blocks_per_sm": occ, "waves": _waves(blocks, occ)}


def _mm_activation(dw_mm_act, x, w1, sc, bi):
    """K1 mm's activation of x (``dw_mm_act_s1`` with only the centre tap,
    1: y is the activation itself, the 26 other taps add fmaf(0, a, acc) =
    acc), in x's dtype: the one ``mm_strip_product`` gives every mm
    kernel.  The activation is pointwise, so where K1 mm has no plan that
    fits at x's width (X3D-XL's layer1.0 input, 112² of 32 f32 channels,
    which no path gives K1 mm) x is read as ``(B, T, H·k, W/k, C)`` for the
    least k that fits, and the result put back."""
    from coarse_fine_networks_torch.ops import dw_conv

    taps = torch.zeros((3, 3, 3, w1.shape[1]), dtype=x.dtype,
                       device=x.device)
    taps[1, 1, 1] = 1
    b, t, h, w, c_in = x.shape
    k = next(k for k in range(1, w + 1) if w % k == 0 and dw_conv.smem_mm_s1(
        dw_conv.plan_mm_s1(b, t, h * k, w // k, c_in, w1.shape[1],
                           x.element_size()), c_in, x.element_size())
        <= dw_conv.SMEM_MAX)
    a = dw_mm_act.dw_mm_bnrelu_conv3d(x.view(b, t, h * k, w // k, c_in), w1,
                                      taps, sc, bi, 1)
    return a.view(b, t, h, w, -1)


def _mm_fwd_s2_exact(dw_mm_act, dw_conv, x, w1, w, sc, bi, dtype) -> dict:
    """K4 mm (``dw_mm_act_s2``) against its exact oracle: y equals K4 plain
    (``dw_conv_s2``) launched with K4 mm's plan on K1 mm's activation, with
    a difference of 0 (both add each output's taps in K7's order); it
    repeats bit for bit.  Returns the row's fields: the difference and the
    plan."""
    b, t, h, wd, c_in = x.shape
    c = w1.shape[1]
    a = _mm_activation(dw_mm_act, x, w1, sc, bi)
    p = dw_conv.plan_mm_s2_fwd(b, t, h, wd, c_in, c, x.element_size())
    ref = torch.empty((b, t, (h - 1) // 2 + 1, (wd - 1) // 2 + 1, c),
                      dtype=x.dtype, device=x.device)
    dw_mm_act._launch(dw_conv.LAUNCHES, dw_conv.LIBRARY_S2, "dw_conv_s2", a,
                      a.data_ptr(), w.data_ptr(), ref.data_ptr(), *a.shape,
                      p.r, p.wb, p.pg, p.tt)
    del a
    y1 = dw_mm_act.dw_mm_bnrelu_conv3d(x, w1, w, sc, bi, 2)
    y2 = dw_mm_act.dw_mm_bnrelu_conv3d(x, w1, w, sc, bi, 2)
    torch.cuda.synchronize()
    diff = (y1.float() - ref.float()).abs().max().item()
    repeats = torch.equal(y1, y2)
    what = f"dw_mm_act_s2 {tuple(x.shape)} C_mid {c} {dtype}"
    check(diff == 0, f"{what}: y differs from K4 plain on K1 mm's "
                     f"activation by {diff}")
    check(repeats, f"{what}: two runs differ")
    return {"exact_max_abs_diff": diff, "repeats_bitwise": repeats,
            "plan": _plan_row_mm_s2(dw_conv, "dw_mm_act_s2", tuple(x.shape),
                                    c, dtype)}


def phase_kernels(dw_mm_act, dw_conv, shapes=None, phase="kernels",
                  eval_step=True) -> dict:
    """K1 ``mm`` and K4 ``mm`` against their plain versions at
    :func:`entry_cases`' shapes (X3D-M's by default; ``shapes`` and
    ``phase`` name another model's), f32 and bf16, timed beside the plain
    version and the unfused sequence; returns each kernel's bf16 sums over
    the counted serve shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {k: _agg() for k in MM_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for (name, label, b, t, h, w, c_in, c_mid, s, n,
             counted) in entry_cases(shapes, eval_step):
            def rnd(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda") * scale
            x = rnd(b, t, h, w, c_in).to(dtype)
            w1 = rnd(c_in, c_mid, scale=c_in ** -0.5).to(dtype)
            w_dw = rnd(3, 3, 3, c_mid, scale=27 ** -0.5).to(dtype)
            sc = torch.rand(c_mid, generator=gen, device="cuda") + 0.5
            bi = rnd(c_mid)  # about half negative: the zero frame matters
            args = (x, w1, w_dw, sc, bi, s)

            got = dw_mm_act.dw_mm_bnrelu_conv3d(*args)
            ref = dw_mm_act.dw_mm_bnrelu_conv3d_plain(*args)
            torch.cuda.synchronize()
            check(got.shape == ref.shape and got.dtype == dtype,
                  f"{name} {label} {dtype}: shape/dtype {got.shape}")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = TOL[dtype] * max(scale, 1.0)

            w_conv = w_dw.permute(3, 0, 1, 2).unsqueeze(1).contiguous()

            def unfused():
                z = torch.matmul(x, w1)
                a = torch.relu(z.float() * sc + bi).to(dtype)
                return F.conv3d(a.permute(0, 4, 1, 2, 3), w_conv,
                                stride=(1, s, s), padding=1,
                                groups=c_mid).permute(0, 2, 3, 4, 1)

            ms = cuda_ms(lambda: dw_mm_act.dw_mm_bnrelu_conv3d(*args), 20)
            plain_ms = cuda_ms(
                lambda: dw_mm_act.dw_mm_bnrelu_conv3d_plain(*args), 3, 1)
            unfused_ms = cuda_ms(unfused, 10)
            bound = _bound(dw_mm_act.fwd_work(got, *args), dtype)
            row = {"phase": phase, "kernel": name, "entry": label,
                   "dtype": str(dtype).replace("torch.", ""),
                   "x": [b, t, h, w, c_in], "c_mid": c_mid, "stride": s,
                   **({"plan": _plan_row_mm(dw_conv, dw_mm_act,
                                            (b, t, h, w, c_in), c_mid, dtype)}
                      if s == 1 else _mm_fwd_s2_exact(dw_mm_act, dw_conv,
                                                      *args[:5], dtype)),
                   "path_launches": n, "in_kernel_line": counted,
                   "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
                   "tol_abs": tol, "ms": ms, "plain_ms": plain_ms,
                   "unfused_ms": unfused_ms, **bound,
                   "library_ms": None,
                   "library_note": "no single PyTorch call computes "
                                   "dwconv(relu(x@W1*sc+bi))"}
            emit(row)
            check(err <= tol, f"{name} {label} {dtype}: max abs err {err} "
                              f"> {tol}")
            agg = per_kernel[name]
            if dtype == torch.bfloat16:
                # the served dtype: each serve shape weighted by its
                # launches in the counted serve run, so the sums are that
                # run's work
                for key, v in (("ms", ms), ("plain_ms", plain_ms),
                               ("unfused_ms", unfused_ms),
                               ("bytes_ms", bound["bytes_ms"]),
                               ("ops_ms", bound["ops_ms"]),
                               ("bound_ms", row["bound_ms"])):
                    agg[key] += n * v * counted
                agg["launches"] += n * counted
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
            else:
                agg["max_abs_err_f32"] = max(agg["max_abs_err_f32"], err)
            del x, got, ref
        torch.cuda.empty_cache()
    return per_kernel


def _fmaf_f32(a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` of f32 (or bf16) operands, rounded once to f32,
    modelled in f64: a·b is exact there, a·b + c is taken to odd (the f64
    sum, moved one unit toward the exact one where TwoSum leaves an error
    and the sum's last bit is even) and then rounded to f32, which is the
    single rounding of the exact value."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    nudge = torch.nextafter(s, torch.where(e > 0, torch.inf, -torch.inf))
    return torch.where((e != 0) & even, nudge, s).float()


def _relu_witness(y, x, w1, sc, bi) -> dict:
    """K1 mm's relu branch (``y > 0`` of ``dw_mm_act_s1`` at centre tap 1)
    against one computed outside the kernels: conv1's product ``x @ W1``
    and ``s = |x| @ |W1|`` in f64 on the card, bn1's apply in f64.  Where
    ``|v|`` is at least ``mm_band(nk, C_in) |sc| s`` (``csrc/common.cuh``,
    nk = ⌈C_in / 16⌉) the branch must be v's sign; inside that band it must
    be the sign of a torch model of ``mm_z_fmaf``'s sum (``fmaf`` over k in
    order from 0 in f32, :func:`_fmaf_f32`) through bn1's apply rounded
    as ``bn_apply`` (``z·sc`` and ``+ bi`` each to f32), the arithmetic of
    ``mm_z_fmaf``'s in-order sum.  Returns the mismatches and the number
    of elements in the band."""
    c_in, c_mid = w1.shape
    xd, wd = x.reshape(-1, c_in).double(), w1.double()
    v = torch.matmul(xd, wd) * sc.double() + bi.double()
    band = ((2.0 ** -18 * -(-c_in // 16) + 2.0 ** -23 * c_in)
            * sc.double().abs())
    inside = v.abs() < torch.matmul(xd.abs(), wd.abs()) * band
    want = v > 0
    del v, xd
    pos, ch = inside.nonzero(as_tuple=True)
    xs, ws = x.reshape(-1, c_in)[pos], w1.t()[ch]
    z = torch.zeros(pos.numel(), device=x.device)
    for k in range(c_in):
        z = _fmaf_f32(xs[:, k], ws[:, k], z)
    want[pos, ch] = (z * sc[ch]) + bi[ch] > 0
    got = (y > 0).reshape(-1, c_mid)
    return {"mismatches": int((got != want).sum().item()),
            "in_band": int(pos.numel())}


def phase_relu_branch(dw_mm_act, dw_mm_bn_train) -> None:
    """The forward and the masked dx take one relu branch, element for
    element.  With only the centre tap set to 1 the forward's y is the
    activation itself (the other 26 taps add fmaf(0, a, acc) = acc), so
    ``y > 0`` is its relu branch; with ``g = 1`` the masked dx ``dam`` is
    the mask itself wherever g reaches (every position at stride 1, the
    even rows and columns at stride 2).  K1 mm (``dw_mm_act_s1``) against
    K2 (``dw_mm_dx_mask_s1``) and K4 mm against K9, all four conv1's
    product through ``mm_strip_product``, at every entry shape of the eval
    kernels and of the train composite, f32 and bf16: they must agree
    exactly.  Since K1 mm
    and K2 share their product, K1 mm's branch is also held against
    :func:`_relu_witness` at every stride-1 shape: no mismatch."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    shapes = [(label, b, t, h, c_in, c_mid, s) for
              (_, label, b, t, h, _, c_in, c_mid, s, _, _) in entry_cases()]
    shapes += [(f"train.{label}", b, t, h, c_in, c_mid, s) for
               (label, b, t, h, c_in, c_mid, s, _, _) in mm_entry_cases()]
    for dtype in (torch.float32, torch.bfloat16):
        flips, witness = {}, {}
        for label, b, t, h, c_in, c_mid, s in shapes:
            x = torch.randn((b, t, h, h, c_in), generator=gen,
                            device="cuda").to(dtype)
            w1 = (torch.randn((c_in, c_mid), generator=gen, device="cuda")
                  * c_in ** -0.5).to(dtype)
            sc = torch.rand(c_mid, generator=gen, device="cuda") + 0.5
            bi = torch.randn(c_mid, generator=gen, device="cuda")
            taps = torch.zeros((3, 3, 3, c_mid), dtype=dtype, device="cuda")
            taps[1, 1, 1] = 1
            y = dw_mm_act.dw_mm_bnrelu_conv3d(x, w1, taps, sc, bi, s)
            dam = dw_mm_bn_train.dw_mm_dx_mask(torch.ones_like(y), x, w1,
                                               taps, sc, bi, s)
            keep = dam[:, :, ::s, ::s] != 0
            pos = y > 0
            torch.cuda.synchronize()
            flips[label] = int((keep != pos).sum().item())
            del dam, keep, pos
            if s == 1:
                witness[label] = _relu_witness(y, x, w1, sc, bi)
            del x, y
            torch.cuda.empty_cache()
        emit({"phase": "relu_branch", "dtype": str(dtype)[6:],
              "pairs": "dw_mm_act_s1 vs dw_mm_dx_mask_s1, dw_mm_act_s2 vs "
                       "dw_mm_dx_mask_s2", "shapes": len(shapes),
              "mismatches": flips,
              "witness": "dw_mm_act_s1 vs f64 x @ W1 outside mm_band, "
                         "an in-order fmaf model inside",
              "witness_shapes": len(witness), "witness_by_shape": witness})
        check(not any(flips.values()),
              f"relu branch {dtype}: forward and mask differ: {flips}")
        bad = {k: v for k, v in witness.items() if v["mismatches"]}
        check(not bad, f"relu branch {dtype}: dw_mm_act_s1 differs from "
                       f"the f64 witness: {bad}")


def _agg() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "unfused_ms": 0.0, "nearest_ms": 0.0,
            "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
            "max_abs_err": 0.0, "max_abs_err_f32": 0.0, "launches": 0,
            "phase_d_ms": 0.0, "phase_d_bound_ms": 0.0}


def _bound(work, dtype) -> dict:
    """The least time the card could take for a kernel's ``work`` (its
    wrapper's ``utils.hw.Work`` formula): bytes over the card's HBM rate,
    or its operations over the card's peak for the dtype (bf16 on the tensor
    cores, f32 outside them; ``utils.hw.chip_peaks``), whichever is
    larger."""
    from coarse_fine_networks_torch.utils.hw import chip_peaks

    peaks = chip_peaks()
    bytes_ms = work.bytes / peaks.hbm_bw * 1e3
    ops_ms = work.ops / (peaks.flops_bf16 if dtype == torch.bfloat16
                         else peaks.flops_f32) * 1e3
    return {"bytes": work.bytes, "ops": work.ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def train_entry_cases():
    """(label, B, T, H, C, stride, launches per step, counted) of the entry
    shapes the act-mode kernels get (x is conv1's output, C = C_mid): the 8
    of the coarse train step (T=64 in layer1, T=17 after Grid Pool; these
    rows make up the kernel's line) and the 8 of the fine stream in
    long-cycle phase D (B8 T64 224², every stage at T=64)."""
    for layer, h_s2, _, h_s1, _, c_mid, n in ENTRY_SHAPES:
        t = TRAIN_FRAMES[layer]
        yield f"coarse.{layer}.0", TRAIN["b"], t, h_s2, c_mid, 2, 1, True
        yield (f"coarse.{layer}.1-{n - 1}", TRAIN["b"], t, h_s1, c_mid, 1,
               n - 1, True)
    _, b, t, crop, _, _ = fine_phase("D")
    for label, h, c, s, blocks in fine_entry_cases(crop):
        yield f"fine.D.{label}", b, t, h, c, s, blocks, False


def _rel_err(got, ref) -> tuple[float, float]:
    err = (got.float() - ref.float()).abs().max().item()
    return err, ref.float().abs().max().item()


def _hold_and_time(phase, cases, meta, dtype, n, counted, per_kernel,
                   extra=None):
    """Each of ``cases`` (name -> kernel, plain version, unfused PyTorch
    sequence, the nearest single PyTorch call, what that call is, its
    ``utils.hw.Work``) held against its plain version and timed beside the
    other
    three; one row per case, ``meta`` naming the entry, with ``extra[name]``
    (fields of that case's row) where given.  A bf16 case at a ``counted``
    shape adds its times, weighted by ``n`` launches per train step, to
    ``per_kernel``, so the sums are one step's work; a bf16 case at another
    shape (long-cycle phase D's) adds its time and bound, weighted by its
    launches in one phase-D step, to ``phase_d_ms`` and
    ``phase_d_bound_ms``."""
    for name, (kern, plain, unfused, nearest, near_what,
               work) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        errs = [_rel_err(a_, b_) for a_, b_ in zip(got, ref)]
        check(all(a_.shape == b_.shape for a_, b_ in zip(got, ref)),
              f"{name} {meta['entry']} {dtype}: shapes differ")
        err = max(e for e, _ in errs)
        tol_ok = all(e <= TOL[dtype] * max(m, 1.0) for e, m in errs)
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 3, 1)
        unfused_ms = cuda_ms(unfused, 10)
        nearest_ms = cuda_ms(nearest, 10)
        row = {"phase": phase, "kernel": name, **meta,
               "dtype": str(dtype)[6:], "launches_per_step": n,
               "in_kernel_line": counted, "max_abs_err": err,
               "max_abs_err_by_output": [e for e, _ in errs],
               "ref_absmax_by_output": [m for _, m in errs],
               "ms": ms, "plain_ms": plain_ms,
               "unfused_ms": unfused_ms, "nearest_ms": nearest_ms,
               "nearest_call": near_what, "library_ms": None,
               **_bound(work, dtype), **(extra or {}).get(name, {})}
        emit(row)
        check(tol_ok, f"{name} {meta['entry']} {dtype}: errors {errs}")
        agg = per_kernel[name]
        if dtype == torch.bfloat16:
            # the trained dtype
            for key in ("ms", "plain_ms", "unfused_ms", "nearest_ms",
                        "bytes_ms", "ops_ms", "bound_ms"):
                agg[key] += n * row[key] * counted
            agg["launches"] += n * counted
            agg["phase_d_ms"] += n * row["ms"] * (not counted)
            agg["phase_d_bound_ms"] += n * row["bound_ms"] * (not counted)
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
        else:
            agg["max_abs_err_f32"] = max(agg["max_abs_err_f32"], err)


def _dx_s1_oracle(dw_conv, g, w):
    """K3's and K2's da: ``dw_conv_s1`` of g with the flipped taps, run in
    f32 (the new kernels sum each output's taps in its order)."""
    w_flip = torch.flip(w, (0, 1, 2)).float().contiguous()
    return dw_conv.dw_conv3d(g.float(), w_flip, 1)


def _plan_row_dx(dw_conv, dw_mm_act, p, mm, c_in, dtype) -> dict:
    """The stride-1 dx's work split ``p`` (act: ``mm`` false, C_in = C) and
    what the card makes of it: blocks, shared memory, blocks per SM (the
    occupancy API) and waves."""
    esz, bf16 = torch.finfo(dtype).bits // 8, int(dtype == torch.bfloat16)
    occ = dw_mm_act.DX_S1_LIBRARY.build().dw_dx_s1_occupancy(
        int(mm), p.r, p.wb, p.pg, p.tt, c_in, p.w, bf16)
    check(occ > 0, f"dx plan {p} {dtype}: does not fit ({occ})")
    blocks = p.items * p.n_pg
    return {"r": p.r, "wb": p.wb, "pg": p.pg, "tt": p.tt,
            "threads": p.threads, "blocks": blocks,
            "smem": dw_conv.smem_dx_s1(p, c_in, esz, mm),
            "blocks_per_sm": occ, "waves": _waves(blocks, occ)}


def _act_dx_exact(dw_act, dw_conv, dw_mm_act, g, x, w, sc, bi,
                  dtype) -> dict:
    """K3 (``dw_act_dx_s1``) against its exact oracle: dx equals
    ``where(x·sc + bi > 0, da, 0)·sc`` in x's dtype, da from
    :func:`_dx_s1_oracle`, with a difference of 0; its dx and its sums
    repeat bit for bit in a second run.  Returns the row's fields: the
    difference and the plan."""
    da = _dx_s1_oracle(dw_conv, g, w)
    ref = (torch.where(x.float() * sc + bi > 0, da, 0) * sc).to(x.dtype)
    del da
    dx1, red1 = dw_act.dw_act_dx(g, x, w, sc, bi, 1)
    dx2, red2 = dw_act.dw_act_dx(g, x, w, sc, bi, 1)
    torch.cuda.synchronize()
    diff = (dx1.float() - ref.float()).abs().max().item()
    repeats = torch.equal(dx1, dx2) and torch.equal(red1, red2)
    what = f"dw_act_dx_s1 {tuple(x.shape)} {dtype}"
    check(diff == 0, f"{what}: dx differs from the exact oracle by {diff}")
    check(repeats, f"{what}: two runs differ")
    return {"exact_max_abs_diff": diff, "repeats_bitwise": repeats,
            "plan": _plan_row_dx(dw_conv, dw_mm_act,
                                 dw_conv.plan_act_dx_s1(*x.shape), False,
                                 x.shape[-1], dtype)}


def _act_dx_s2_exact(dw_act, dw_conv, g, x, w, sc, bi, dtype) -> dict:
    """K5 (``dw_act_dx_s2``) against its exact oracle: dx equals
    ``where(x·sc + bi > 0, da, 0)·sc`` in x's dtype, da K8
    (``dw_conv_dx_s2``) run in f32 on g and the taps, with a difference of
    0; its dx and its sums repeat bit for bit in a second run.  Returns the
    row's fields: the difference and the plan (``plan_act_dx_s2``)."""
    da = dw_conv.dw_conv_dx_s2(g.float(), w.float(), x.shape[2:4])
    ref = (torch.where(x.float() * sc + bi > 0, da, 0) * sc).to(x.dtype)
    del da
    dx1, red1 = dw_act.dw_act_dx(g, x, w, sc, bi, 2)
    dx2, red2 = dw_act.dw_act_dx(g, x, w, sc, bi, 2)
    torch.cuda.synchronize()
    diff = (dx1.float() - ref.float()).abs().max().item()
    repeats = torch.equal(dx1, dx2) and torch.equal(red1, red2)
    what = f"dw_act_dx_s2 {tuple(x.shape)} {dtype}"
    check(diff == 0, f"{what}: dx differs from the exact oracle by {diff}")
    check(repeats, f"{what}: two runs differ")
    return {"exact_max_abs_diff": diff, "repeats_bitwise": repeats,
            "plan": _plan_row_s2(dw_conv, "dw_act_dx_s2", tuple(x.shape),
                                 dtype)}


def _act_wgrad_exact(dw_act, dw_conv, x, g, sc, bi, dtype) -> dict:
    """K6 act (``dw_act_wgrad_s1``) against its exact oracle: dk equals K6
    plain (``dw_conv_wgrad_s1``: the same plan, ``plan_s1``, and the same
    ``torch.sum`` of the rows) on the activated x, ``relu(x·sc + bi)``
    rounded to x's dtype, with a difference of 0; it repeats bit for bit.
    Returns the row's fields: the difference and the plan."""
    ref = dw_conv.dw_conv_wgrad(dw_act._activate(x, sc, bi), g, 1)
    dk1 = dw_act.dw_act_wgrad(x, g, sc, bi, 1)
    dk2 = dw_act.dw_act_wgrad(x, g, sc, bi, 1)
    torch.cuda.synchronize()
    diff = (dk1 - ref).abs().max().item()
    repeats = torch.equal(dk1, dk2)
    what = f"dw_act_wgrad_s1 {tuple(x.shape)} {dtype}"
    check(diff == 0, f"{what}: dk differs from K6 plain on the activated x "
                     f"by {diff}")
    check(repeats, f"{what}: two runs differ")
    return {"exact_max_abs_diff": diff, "repeats_bitwise": repeats,
            "plan": _plan_row(dw_conv, tuple(x.shape), dtype,
                              ("act_wgrad",))}


def _act_fwd_exact(dw_act, dw_conv, x, w, sc, bi, dtype, s=1) -> dict:
    """K1 act (``dw_act_s1``) or K4 act (``dw_act_s2``, ``s`` 2) against
    its exact oracle: y equals K1 plain (``dw_conv_s1``) or K4 plain
    (``dw_conv_s2``), each output's taps in the same order, on the
    activated x, ``relu(x·sc + bi)`` rounded to x's dtype, with a
    difference of 0; it repeats bit for bit.  Returns the row's fields: the
    difference and the plan (``plan_s1``; ``plan_act_s2_fwd``)."""
    ref = dw_conv.dw_conv3d(dw_act._activate(x, sc, bi), w, s)
    y1 = dw_act.dw_bnrelu_conv3d(x, w, sc, bi, s)
    y2 = dw_act.dw_bnrelu_conv3d(x, w, sc, bi, s)
    torch.cuda.synchronize()
    diff = (y1.float() - ref.float()).abs().max().item()
    repeats = torch.equal(y1, y2)
    what = f"dw_act_s{s} {tuple(x.shape)} {dtype}"
    check(diff == 0, f"{what}: y differs from K{1 if s == 1 else 4} plain "
                     f"on the activated x by {diff}")
    check(repeats, f"{what}: two runs differ")
    return {"exact_max_abs_diff": diff, "repeats_bitwise": repeats,
            "plan": (_plan_row(dw_conv, tuple(x.shape), dtype, ("act_fwd",))
                     if s == 1 else
                     _plan_row_s2(dw_conv, "dw_act_s2", tuple(x.shape),
                                  dtype))}


def _act_wgrad_s2_exact(dw_act, dw_conv, x, g, sc, bi, dtype) -> dict:
    """K10 act (``dw_act_wgrad_s2``) against its exact oracle: dk equals
    K10 plain (``dw_conv_wgrad_s2``: the same plan, ``plan_s2``, and the
    same ``torch.sum`` of the rows) on the activated x, with a difference of
    0; it repeats bit for bit.  Returns the row's fields: the difference and
    the plan."""
    ref = dw_conv.dw_conv_wgrad(dw_act._activate(x, sc, bi), g, 2)
    dk1 = dw_act.dw_act_wgrad(x, g, sc, bi, 2)
    dk2 = dw_act.dw_act_wgrad(x, g, sc, bi, 2)
    torch.cuda.synchronize()
    diff = (dk1 - ref).abs().max().item()
    repeats = torch.equal(dk1, dk2)
    what = f"dw_act_wgrad_s2 {tuple(x.shape)} {dtype}"
    check(diff == 0, f"{what}: dk differs from K10 plain on the activated "
                     f"x by {diff}")
    check(repeats, f"{what}: two runs differ")
    return {"exact_max_abs_diff": diff, "repeats_bitwise": repeats,
            "plan": _plan_row_s2(dw_conv, "dw_act_wgrad_s2", tuple(x.shape),
                                 dtype)}


def phase_train_kernels(dw_act, dw_conv, dw_mm_act) -> dict:
    """The six train kernels against their plain versions, and timed, at
    the coarse train step's entry shapes and at the fine stream's in
    long-cycle phase D; K1 act, K3, K5, K6 act and K10 act also against
    their exact oracles (:func:`_act_fwd_exact`, :func:`_act_dx_exact`,
    :func:`_act_dx_s2_exact`, :func:`_act_wgrad_exact`,
    :func:`_act_wgrad_s2_exact`)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    per_kernel = {f"dw_act{p}_s{s}": _agg() for p in ("", "_dx", "_wgrad")
                  for s in (1, 2)}
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, t, h, c, s, n, counted in train_entry_cases():
            def rnd(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda") * scale
            ho = (h - 1) // s + 1
            x = rnd(b, t, h, h, c).to(dtype)
            w = rnd(3, 3, 3, c, scale=27 ** -0.5).to(dtype)
            g = rnd(b, t, ho, ho, c).to(dtype)
            sc = torch.rand(c, generator=gen, device="cuda") + 0.5
            bi = rnd(c)  # about half negative: the zero frame matters
            w_conv = w.permute(3, 0, 1, 2).unsqueeze(1).contiguous()
            ncdhw = (0, 4, 1, 2, 3)
            a = torch.relu(x.float() * sc + bi).to(dtype)
            conv = dict(stride=(1, s, s), padding=1, groups=c)
            bw = ([1, s, s], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], c)

            def conv_bwd(mask, a=a):
                return torch.ops.aten.convolution_backward(
                    g.permute(ncdhw), a.permute(ncdhw), w_conv, None, *bw,
                    mask)

            def unfused_fwd():
                act = torch.relu(x.float() * sc + bi).to(dtype)
                return F.conv3d(act.permute(ncdhw), w_conv, **conv)

            def unfused_dx():
                da = conv_bwd([True, False, False])[0]
                da = da.permute(0, 2, 3, 4, 1).float()
                xf = x.float()
                dam = torch.where(xf * sc + bi > 0, da, 0.0)
                return ((dam * sc).to(dtype), torch.sum(dam * xf, (0, 1, 2, 3)),
                        torch.sum(dam, (0, 1, 2, 3)))

            def unfused_wgrad():
                act = torch.relu(x.float() * sc + bi).to(dtype)
                return conv_bwd([False, True, False], act)[1]

            cases = {
                f"dw_act_s{s}": (
                    lambda: dw_act.dw_bnrelu_conv3d(x, w, sc, bi, s),
                    lambda: dw_act.dw_bnrelu_conv3d_plain(x, w, sc, bi, s),
                    unfused_fwd, lambda: F.conv3d(a.permute(ncdhw), w_conv,
                                                  **conv),
                    "F.conv3d(groups=C) on the activated input",
                    dw_act.fwd_work(g, x, w, sc, bi, s)),
                f"dw_act_dx_s{s}": (
                    lambda: dw_act.dw_act_dx(g, x, w, sc, bi, s),
                    lambda: dw_act.dw_act_dx_plain(g, x, w, sc, bi, s),
                    unfused_dx, lambda: conv_bwd([True, False, False]),
                    "aten.convolution_backward, input gradient only",
                    dw_act.dx_work(None, g, x, w, sc, bi, s)),
                f"dw_act_wgrad_s{s}": (
                    lambda: dw_act.dw_act_wgrad(x, g, sc, bi, s),
                    lambda: dw_act.dw_act_wgrad_plain(x, g, sc, bi, s),
                    unfused_wgrad, lambda: conv_bwd([False, True, False]),
                    "aten.convolution_backward, weight gradient only",
                    dw_act.wgrad_work(None, x, g, sc, bi, s)),
            }
            if s == 1:
                extra = {"dw_act_s1": _act_fwd_exact(
                    dw_act, dw_conv, x, w, sc, bi, dtype),
                    "dw_act_dx_s1": _act_dx_exact(
                    dw_act, dw_conv, dw_mm_act, g, x, w, sc, bi, dtype),
                    "dw_act_wgrad_s1": _act_wgrad_exact(
                        dw_act, dw_conv, x, g, sc, bi, dtype)}
            else:
                extra = {"dw_act_s2": _act_fwd_exact(
                    dw_act, dw_conv, x, w, sc, bi, dtype, 2),
                    "dw_act_dx_s2": _act_dx_s2_exact(
                    dw_act, dw_conv, g, x, w, sc, bi, dtype),
                    "dw_act_wgrad_s2": _act_wgrad_s2_exact(
                        dw_act, dw_conv, x, g, sc, bi, dtype)}
            _hold_and_time("kernels", cases, {"entry": label,
                                              "x": [b, t, h, h, c],
                                              "stride": s},
                           dtype, n, counted, per_kernel, extra)
            del x, g, a
        torch.cuda.empty_cache()
    return per_kernel


def _nan_compare(got, ref, dtype, exact=False) -> dict:
    """``got`` against ``ref`` where either may hold NaN: the positions
    whose NaN-ness differs, and the largest difference of the elements
    finite in both (0 where ``exact``, else within ``TOL`` of ``ref``'s
    largest finite magnitude)."""
    gn, rn = torch.isnan(got), torch.isnan(ref)
    fin = ~(gn | rn)
    a, b = got.float()[fin], ref.float()[fin]
    err = (a - b).abs().max().item() if a.numel() else 0.0
    scale = b.abs().max().item() if b.numel() else 0.0
    bound = 0.0 if exact else TOL[dtype] * max(scale, 1.0)
    out = {"nan_mismatches": int((gn != rn).sum().item()),
           "nans": int(rn.sum().item()), "max_abs_err": err}
    out["ok"] = out["nan_mismatches"] == 0 and err <= bound
    return out


def _with_nans(x, sc, c_x):
    """Copies of x with one NaN at channel ``c_x`` of sample 0's middle
    frame, row and column (inside the frame and away from its edges), and
    of sc with channel ``c_x + 1`` NaN."""
    x, sc = x.clone(), sc.clone()
    _, t, h, w, _ = x.shape
    x[0, t // 2, h // 2, w // 2, c_x] = float("nan")
    sc[c_x + 1] = float("nan")
    return x, sc


def phase_nan(dw_act, dw_conv, dw_mm_act, dw_mm_bn_train) -> None:
    """A NaN relu input stays NaN (fault 3.3): at every act-route entry
    shape (:func:`train_entry_cases`) and every entry shape of the
    composite (:func:`mm_entry_cases`), f32 and bf16, x holds one NaN and
    sc one NaN channel (:func:`_with_nans`; in the composite x is conv1's
    input, so the NaN reaches every channel of its position).  Each relu
    kernel (K1/K4 act, K6/K10 act, K1/K4 mm, K6/K10 mm) must put NaN
    exactly where its eager twin does, and each masked dx (K3, K5, K2, K9:
    the mask is false at NaN) likewise in dx and the sums; the elements
    finite in both keep the twin's tolerance, and K1, K6 and K10 act equal
    their plain kernels on the activated x exactly, NaN for NaN.  The NaN
    lies away from the frame's edges; :func:`phase_edges` puts it on
    them."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        bad, rows = {}, 0
        for label, b, t, h, c, s, _, _ in train_entry_cases():
            def rnd(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda") * scale
            ho = (h - 1) // s + 1
            x, sc = _with_nans(rnd(b, t, h, h, c).to(dtype),
                               torch.rand(c, generator=gen, device="cuda")
                               + 0.5, 0)
            w = rnd(3, 3, 3, c, scale=27 ** -0.5).to(dtype)
            g = rnd(b, t, ho, ho, c).to(dtype)
            bi = rnd(c)
            a = dw_act._activate(x, sc, bi)
            cmp = {
                f"dw_act_s{s}": _nan_compare(
                    dw_act.dw_bnrelu_conv3d(x, w, sc, bi, s),
                    dw_act.dw_bnrelu_conv3d_plain(x, w, sc, bi, s), dtype),
                f"dw_act_wgrad_s{s}": _nan_compare(
                    dw_act.dw_act_wgrad(x, g, sc, bi, s),
                    dw_act.dw_act_wgrad_plain(x, g, sc, bi, s), dtype),
                f"dw_act_wgrad_s{s} exact": _nan_compare(
                    dw_act.dw_act_wgrad(x, g, sc, bi, s),
                    dw_conv.dw_conv_wgrad(a, g, s), dtype, exact=True)}
            if s == 1:
                cmp["dw_act_s1 exact"] = _nan_compare(
                    dw_act.dw_bnrelu_conv3d(x, w, sc, bi, 1),
                    dw_conv.dw_conv3d(a, w, 1), dtype, exact=True)
            for part, got, ref in zip(
                    ("dx", "sums"), dw_act.dw_act_dx(g, x, w, sc, bi, s),
                    dw_act.dw_act_dx_plain(g, x, w, sc, bi, s)):
                cmp[f"dw_act_dx_s{s} {part}"] = _nan_compare(got, ref, dtype)
            torch.cuda.synchronize()
            for k, v in cmp.items():
                rows += 1
                if not v["ok"]:
                    bad[f"{label} {k}"] = v
            emit({"phase": "nan", "entry": label, "dtype": str(dtype)[6:],
                  "x": [b, t, h, h, c], "stride": s, "by_kernel": cmp})
            del x, g, a
        for label, b, t, h, c_in, c, s, _, _ in mm_entry_cases():
            def rnd(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda") * scale
            ho = (h - 1) // s + 1
            x, sc = _with_nans(rnd(b, t, h, h, c_in).to(dtype),
                               torch.rand(c, generator=gen, device="cuda")
                               + 0.5, 0)
            w1 = rnd(c_in, c, scale=c_in ** -0.5).to(dtype)
            w = rnd(3, 3, 3, c, scale=27 ** -0.5).to(dtype)
            g = rnd(b, t, ho, ho, c).to(dtype)
            bi = rnd(c)
            cmp = {
                f"dw_mm_act_s{s}": _nan_compare(
                    dw_mm_act.dw_mm_bnrelu_conv3d(x, w1, w, sc, bi, s),
                    dw_mm_act.dw_mm_bnrelu_conv3d_plain(x, w1, w, sc, bi, s),
                    dtype),
                f"dw_mm_wgrad_s{s}": _nan_compare(
                    dw_mm_act.dw_mm_wgrad(x, w1, g, sc, bi, s),
                    dw_mm_act.dw_mm_wgrad_plain(x, w1, g, sc, bi, s), dtype),
                f"dw_mm_dx_mask_s{s}": _nan_compare(
                    dw_mm_bn_train.dw_mm_dx_mask(g, x, w1, w, sc, bi, s),
                    dw_mm_bn_train.dw_mm_dx_mask_plain(g, x, w1, w, sc, bi,
                                                       s), dtype)}
            torch.cuda.synchronize()
            for k, v in cmp.items():
                rows += 1
                if not v["ok"]:
                    bad[f"mm.{label} {k}"] = v
            emit({"phase": "nan", "entry": f"mm.{label}",
                  "dtype": str(dtype)[6:], "x": [b, t, h, h, c_in],
                  "c_mid": c, "stride": s, "by_kernel": cmp})
            del x, g
        torch.cuda.empty_cache()
        emit({"phase": "nan_summary", "dtype": str(dtype)[6:],
              "comparisons": rows, "failed": len(bad)})
        check(not bad, f"nan {dtype}: {bad}")
    phase_edges(dw_act, dw_conv, dw_mm_act, gen)


# where phase_edges puts x's NaN in a (B, T, H, W, C) clip: (t, h, w) of
# sample 0
EDGES = {"first_frame": lambda t, h, w: (0, h // 2, w // 2),
         "last_frame": lambda t, h, w: (t - 1, h // 2, w // 2),
         "last_row": lambda t, h, w: (t // 2, h - 1, w // 2),
         "last_column": lambda t, h, w: (t // 2, h // 2, w - 1)}


def phase_edges(dw_act, dw_conv, dw_mm_act, gen) -> None:
    """Fault 3.4, held: with x's NaN (channel 0) on the clip's first frame,
    its last frame, the last row of a ragged strip or the last column
    (``EDGES``), the row-strip weight gradients put NaN exactly where their
    twins do, which sum only the output's positions: K6 and K10 plain on x,
    K6 and K10 act (also against K6 and K10 plain on the activated x,
    exactly) and K6 and K10 mm on conv1's input x (the NaN reaches every
    channel of its position), at the coarse step's layer3 and layer4
    entries, whose strips are ragged (H or Ho = 7 and 14 at R = 4) and
    whose T = 17 frames split into segments, f32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        bad, rows = {}, 0
        for label, b, t, h, c, s, _, _ in train_entry_cases():
            if not label.startswith(("coarse.layer3", "coarse.layer4")):
                continue
            ho = (h - 1) // s + 1
            x0 = torch.randn((b, t, h, h, c), generator=gen, device="cuda")
            g = torch.randn((b, t, ho, ho, c), generator=gen,
                            device="cuda").to(dtype)
            sc = torch.rand(c, generator=gen, device="cuda") + 0.5
            bi = torch.randn(c, generator=gen, device="cuda")
            cmp = {}
            for where, at in EDGES.items():
                x = x0.clone()
                x[(0,) + at(t, h, h) + (0,)] = float("nan")
                x = x.to(dtype)
                a = dw_act._activate(x, sc, bi)
                cmp[where] = {
                    f"dw_conv_wgrad_s{s}": _nan_compare(
                        dw_conv.dw_conv_wgrad(x, g, s),
                        dw_conv.dw_conv_wgrad_plain(x, g, s), dtype),
                    f"dw_act_wgrad_s{s}": _nan_compare(
                        dw_act.dw_act_wgrad(x, g, sc, bi, s),
                        dw_act.dw_act_wgrad_plain(x, g, sc, bi, s), dtype),
                    f"dw_act_wgrad_s{s} exact": _nan_compare(
                        dw_act.dw_act_wgrad(x, g, sc, bi, s),
                        dw_conv.dw_conv_wgrad(a, g, s), dtype, exact=True)}
            torch.cuda.synchronize()
            for where, v in cmp.items():
                for k, r in v.items():
                    rows += 1
                    if not r["ok"]:
                        bad[f"{label} {where} {k}"] = r
            emit({"phase": "edges", "entry": label, "dtype": str(dtype)[6:],
                  "x": [b, t, h, h, c], "stride": s, "by_position": cmp})
            del x0, g
        for label, b, t, h, c_in, c, s, _, _ in mm_entry_cases():
            if not label.startswith(("coarse.layer3", "coarse.layer4")):
                continue
            ho = (h - 1) // s + 1
            x0 = torch.randn((b, t, h, h, c_in), generator=gen,
                             device="cuda")
            w1 = (torch.randn((c_in, c), generator=gen, device="cuda")
                  * c_in ** -0.5).to(dtype)
            g = torch.randn((b, t, ho, ho, c), generator=gen,
                            device="cuda").to(dtype)
            sc = torch.rand(c, generator=gen, device="cuda") + 0.5
            bi = torch.randn(c, generator=gen, device="cuda")
            cmp = {}
            for where, at in EDGES.items():
                x = x0.clone()
                x[(0,) + at(t, h, h) + (0,)] = float("nan")
                x = x.to(dtype)
                cmp[where] = {f"dw_mm_wgrad_s{s}": _nan_compare(
                    dw_mm_act.dw_mm_wgrad(x, w1, g, sc, bi, s),
                    dw_mm_act.dw_mm_wgrad_plain(x, w1, g, sc, bi, s), dtype)}
            torch.cuda.synchronize()
            for where, v in cmp.items():
                for k, r in v.items():
                    rows += 1
                    if not r["ok"]:
                        bad[f"mm.{label} {where} {k}"] = r
            emit({"phase": "edges", "entry": f"mm.{label}",
                  "dtype": str(dtype)[6:], "x": [b, t, h, h, c_in],
                  "c_mid": c, "stride": s, "by_position": cmp})
            del x0, g
        torch.cuda.empty_cache()
        emit({"phase": "edges_summary", "dtype": str(dtype)[6:],
              "comparisons": rows, "failed": len(bad)})
        check(not bad, f"edges {dtype}: {bad}")


def phase_autograd(dw_act) -> None:
    """The train entry's autograd Function against autograd through the
    plain composition relu(x·sc + bi) → grouped F.conv3d, f32 (TF32 off), at
    layer2's train shapes (stride 2 and stride 1)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    for s, h in ((2, 56), (1, 28)):
        b, t, c = TRAIN["b"], TRAIN_FRAMES["layer2"], 108
        ho = (h - 1) // s + 1
        x = torch.randn((b, t, h, h, c), generator=gen, device="cuda")
        w = torch.randn((3, 3, 3, c), generator=gen, device="cuda") / 5
        sc = torch.rand(c, generator=gen, device="cuda") + 0.5
        bi = torch.randn(c, generator=gen, device="cuda")
        g = torch.randn((b, t, ho, ho, c), generator=gen, device="cuda")
        leaves = [v.clone().requires_grad_() for v in (x, w, sc, bi)]
        y = dw_act.dw_bnrelu_conv3d_train(*leaves, s)
        y.backward(g)
        ref_leaves = [v.clone().requires_grad_() for v in (x, w, sc, bi)]
        xr, wr, scr, bir = ref_leaves
        a = torch.relu(xr * scr + bir)
        yr = F.conv3d(a.permute(0, 4, 1, 2, 3),
                      wr.permute(3, 0, 1, 2).unsqueeze(1), stride=(1, s, s),
                      padding=1, groups=c).permute(0, 2, 3, 4, 1)
        yr.backward(g)
        torch.cuda.synchronize()
        errs = {"y": _rel_err(y, yr)}
        for name, got, ref in zip(("dx", "dw", "dsc", "dbi"), leaves,
                                  ref_leaves):
            errs[name] = _rel_err(got.grad, ref.grad)
        rel = {k: e / max(m, 1e-30) for k, (e, m) in errs.items()}
        emit({"phase": "autograd", "stride": s, "x": [b, t, h, h, c],
              "dtype": "float32", "max_rel_err": rel, "rel_tol": 1e-4})
        # f32 both sides; dw, dsc and dbi are sums over 8·17·28²..56²
        # positions taken in other orders
        check(max(rel.values()) <= 1e-4, f"autograd stride {s}: {rel}")


def mm_entry_cases():
    """(label, B, T, H, C_in, C_mid, stride, launches per step, counted) of
    the entry shapes the composite's kernels get (x is conv1's input): the 8
    of the coarse train step (T=64 in layer1, T=17 after Grid Pool; these
    rows make up the kernels' line) and the 8 of the fine stream in
    long-cycle phase D (B8 T64 224², every stage at T=64)."""
    _, b_d, t_d, crop_d, _, _ = fine_phase("D")
    check(crop_d == 224, f"phase D crop {crop_d}: ENTRY_SHAPES are at 224²")
    for tag, b, frames, counted in (
            ("coarse", TRAIN["b"], TRAIN_FRAMES, True),
            ("fine.D", b_d, dict.fromkeys(TRAIN_FRAMES, t_d), False)):
        for layer, h_s2, cin_s2, h_s1, cin_s1, c_mid, n in ENTRY_SHAPES:
            t = frames[layer]
            yield (f"{tag}.{layer}.0", b, t, h_s2, cin_s2, c_mid, 2, 1,
                   counted)
            yield (f"{tag}.{layer}.1-{n - 1}", b, t, h_s1, cin_s1, c_mid, 1,
                   n - 1, counted)


def _mm_dx_exact(dw_mm_act, dw_mm_bn_train, dw_conv, g, x, w1, w, sc, bi,
                 dtype, s=1) -> dict:
    """K2 (``dw_mm_dx_mask_s1``) or K9 (``dw_mm_dx_mask_s2``, ``s`` 2)
    against its exact oracle: dam equals ``where(keep, da, 0)`` in g's
    dtype, da from :func:`_dx_s1_oracle` (K9: K8, ``dw_conv_dx_s2``, run in
    f32 on g and the taps) and keep K1 mm's relu branch at the same x, W1,
    sc and bi (:func:`_mm_activation` > 0), with a difference of 0; K9
    repeats bit for bit.  Returns the row's fields: the difference and the
    plan."""
    keep = _mm_activation(dw_mm_act, x, w1, sc, bi) > 0
    da = (_dx_s1_oracle(dw_conv, g, w) if s == 1 else
          dw_conv.dw_conv_dx_s2(g.float(), w.float(), x.shape[2:4]))
    ref = torch.where(keep, da, 0.0).to(g.dtype)
    del keep, da
    dam = dw_mm_bn_train.dw_mm_dx_mask(g, x, w1, w, sc, bi, s)
    again = dw_mm_bn_train.dw_mm_dx_mask(g, x, w1, w, sc, bi, s) if s == 2 \
        else dam
    torch.cuda.synchronize()
    diff = (dam.float() - ref.float()).abs().max().item()
    repeats = torch.equal(dam, again)
    what = f"dw_mm_dx_mask_s{s} {tuple(x.shape)} {dtype}"
    check(diff == 0, f"{what}: dam differs from the exact oracle by {diff}")
    check(repeats, f"{what}: two runs differ")
    b, t, h, wd, c_in = x.shape
    c, esz = w1.shape[1], x.element_size()
    if s == 2:
        return {"exact_max_abs_diff": diff, "repeats_bitwise": repeats,
                "plan": _plan_row_mm_s2(dw_conv, "dw_mm_dx_mask_s2",
                                        tuple(x.shape), c, dtype)}
    return {"exact_max_abs_diff": diff,
            "plan": _plan_row_dx(dw_conv, dw_mm_act, dw_conv.plan_mm_dx_s1(
                b, t, h, wd, c_in, c, esz), True, c_in, dtype)}


def _plan_row_mm_wgrad(dw_conv, p, c_in, w, dtype, s=1) -> dict:
    """K6 mm's (``plan_mm_wgrad_s1``) or, ``s`` 2, K10 mm's
    (``plan_mm_wgrad_s2``) work split ``p`` for x of width ``w`` and what
    the card makes of it: blocks of its persistent grid, shared memory,
    blocks per SM (K10 mm's at least the two its plan is cut for) and
    waves."""
    esz, bf16 = torch.finfo(dtype).bits // 8, int(dtype == torch.bfloat16)
    if s == 1:
        occ = dw_conv.LIBRARY.build().dw_mm_wgrad_s1_occupancy(
            p.r, p.wb, p.pg, c_in, w, bf16)
        smem = dw_conv.smem_mm_wgrad_s1(p, c_in, esz)
    else:
        occ = dw_conv.LIBRARY_S2.build().dw_mm_wgrad_s2_occupancy(
            p.r, p.wb, p.pg, c_in, w, bf16)
        smem = dw_conv.smem_mm_wgrad_s2(p, c_in, esz, w)
    need = 2 if s == 2 else 1  # K10 mm's plan is cut for two an SM
    check(occ >= need, f"plan_mm_wgrad_s{s} {p} {dtype}: {occ} blocks per "
                       f"SM")
    blocks = p.rows * p.n_pg
    return {"r": p.r, "wb": p.wb, "pg": p.pg, "tt": p.tt, "ipb": p.ipb,
            "rows": p.rows, "threads": p.threads, "blocks": blocks,
            "smem": smem, "blocks_per_sm": occ, "waves": _waves(blocks, occ)}


def _mm_wgrad_exact(dw_mm_act, dw_conv, x, w1, g, sc, bi, dtype,
                    s=1) -> dict:
    """K6 mm (``dw_mm_wgrad_s1``) or, ``s`` 2, K10 mm (``dw_mm_wgrad_s2``)
    against its exact oracle: dk equals K6 plain (``dw_conv_wgrad_s1``) or
    K10 plain (``dw_conv_wgrad_s2``) launched with the mm kernel's plan on
    the activation K1 mm computes (``dw_mm_act_s1`` with only the centre
    tap, 1: y is the activation, the one ``mm_strip_product`` gives every
    mm kernel), with a difference of 0 (the two walk each channel's items
    in one order); it repeats bit for bit.  Returns the row's fields: the
    difference, whether the plan is ``plan_s1``'s or ``plan_s2``'s (the mm
    kernels' have at most ``NT_DX`` threads, so their tiles are
    narrower), the plan."""
    b, t, h, w, c_in = x.shape
    c = w1.shape[1]
    a = _mm_activation(dw_mm_act, x, w1, sc, bi)
    plan, lib = ((dw_conv.plan_mm_wgrad_s1, dw_conv.LIBRARY) if s == 1 else
                 (dw_conv.plan_mm_wgrad_s2, dw_conv.LIBRARY_S2))
    p = plan(b, t, h, w, c_in, c, x.element_size())
    part = torch.empty((p.rows, 27, c), dtype=torch.float32, device=x.device)
    dw_mm_act._launch(dw_conv.LAUNCHES, lib, f"dw_conv_wgrad_s{s}", a,
                      a.data_ptr(), g.data_ptr(), part.data_ptr(), *a.shape,
                      p.r, p.wb, p.pg, p.tt, p.ipb, p.rows)
    del a
    ref = torch.sum(part, dim=0)
    dk1 = dw_mm_act.dw_mm_wgrad(x, w1, g, sc, bi, s)
    dk2 = dw_mm_act.dw_mm_wgrad(x, w1, g, sc, bi, s)
    torch.cuda.synchronize()
    diff = (dk1 - ref).abs().max().item()
    repeats = torch.equal(dk1, dk2)
    what = f"dw_mm_wgrad_s{s} {tuple(x.shape)} C_mid {c} {dtype}"
    check(diff == 0, f"{what}: dk differs from K{6 if s == 1 else 10} plain "
                     f"on K1 mm's activation by {diff}")
    check(repeats, f"{what}: two runs differ")
    base = (dw_conv.plan_s1 if s == 1 else dw_conv.plan_s2)(b, t, h, w, c)
    return {"exact_max_abs_diff": diff, "repeats_bitwise": repeats,
            f"plan_is_plan_s{s}": p == base,
            "plan": _plan_row_mm_wgrad(dw_conv, p, c_in, w, dtype, s)}


def phase_mm_train_kernels(dw_mm_act, dw_mm_bn_train, dw_conv) -> dict:
    """The composite's four backward kernels against their plain versions,
    and timed, at the coarse train step's entry shapes and at the fine
    stream's in long-cycle phase D; about half the ``bi`` are negative.  K2,
    K9, K6 mm and K10 mm also against their exact oracles
    (:func:`_mm_dx_exact`, :func:`_mm_wgrad_exact`)."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    per_kernel = {k: _agg() for k in MM_TRAIN_KERNELS}
    gram = {"ms": 0.0, "f32_cast_ms": 0.0, "max_rel_err": 0.0,
            "f32_cast_max_rel_err": 0.0}
    ncdhw = (0, 4, 1, 2, 3)
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, t, h, c_in, c, s, n, counted in mm_entry_cases():
            def rnd(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda") * scale
            ho = (h - 1) // s + 1
            x = rnd(b, t, h, h, c_in).to(dtype)
            w1 = rnd(c_in, c, scale=c_in ** -0.5).to(dtype)
            w = rnd(3, 3, 3, c, scale=27 ** -0.5).to(dtype)
            g = rnd(b, t, ho, ho, c).to(dtype)
            sc = torch.rand(c, generator=gen, device="cuda") + 0.5
            bi = rnd(c)
            w_conv = w.permute(3, 0, 1, 2).unsqueeze(1).contiguous()
            bw = ([1, s, s], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], c)
            a = torch.relu(torch.matmul(x, w1).float() * sc + bi).to(dtype)

            def conv_bwd(inp, mask):
                return torch.ops.aten.convolution_backward(
                    g.permute(ncdhw), inp.permute(ncdhw), w_conv, None, *bw,
                    mask)

            def unfused_dx():
                z = torch.matmul(x, w1)
                keep = z.float() * sc + bi > 0
                da = conv_bwd(z, [True, False, False])[0]
                return torch.where(keep, da.permute(0, 2, 3, 4, 1), 0.0)

            def unfused_wgrad():
                act = torch.relu(torch.matmul(x, w1).float() * sc
                                 + bi).to(dtype)
                return conv_bwd(act, [False, True, False])[1]

            d_args = (g, x, w1, w, sc, bi, s)
            w_args = (x, w1, g, sc, bi, s)
            cases = {
                f"dw_mm_dx_mask_s{s}": (
                    lambda: dw_mm_bn_train.dw_mm_dx_mask(*d_args),
                    lambda: dw_mm_bn_train.dw_mm_dx_mask_plain(*d_args),
                    unfused_dx, lambda: conv_bwd(a, [True, False, False]),
                    "aten.convolution_backward, input gradient only",
                    dw_mm_bn_train.dx_mask_work(None, *d_args)),
                f"dw_mm_wgrad_s{s}": (
                    lambda: dw_mm_act.dw_mm_wgrad(*w_args),
                    lambda: dw_mm_act.dw_mm_wgrad_plain(*w_args),
                    unfused_wgrad, lambda: conv_bwd(a, [False, True, False]),
                    "aten.convolution_backward, weight gradient only",
                    dw_mm_act.wgrad_work(None, *w_args)),
            }
            extra = {f"dw_mm_dx_mask_s{s}": _mm_dx_exact(
                dw_mm_act, dw_mm_bn_train, dw_conv, g, x, w1, w, sc, bi,
                dtype, s),
                     f"dw_mm_wgrad_s{s}": _mm_wgrad_exact(
                dw_mm_act, dw_conv, x, w1, g, sc, bi, dtype, s)}
            _hold_and_time("mm_train_kernels", cases,
                           {"entry": label, "x": [b, t, h, h, c_in],
                            "c_mid": c, "stride": s},
                           dtype, n, counted, per_kernel, extra)
            if dtype == torch.bfloat16 and counted:
                # the composite's Gram xᵀx with f32 output from bf16 x
                # (mm_f32), against reading x as f32 (a copy of x), both
                # held against the Gram in f64
                x2 = x.reshape(-1, c_in)
                exact = torch.mm(x2.t().double(), x2.double())
                for key, got in (
                        ("max_rel_err", dw_mm_act.mm_f32(x2.t(), x2)),
                        ("f32_cast_max_rel_err",
                         torch.mm(x2.t().float(), x2.float()))):
                    err, top = _rel_err(got, exact)
                    gram[key] = max(gram[key], err / top)
                del exact
                gram["ms"] += n * cuda_ms(
                    lambda: dw_mm_act.mm_f32(x2.t(), x2), 10)
                gram["f32_cast_ms"] += n * cuda_ms(
                    lambda: torch.mm(x2.t().float(), x2.float()), 10)
            del x, g, a
        torch.cuda.empty_cache()
    emit({"phase": "mm_train_gram", "what": "the Gram of every coarse entry "
          "of one train step, bf16 x, f32 output, summed", **gram})
    # f32 sums of bf16 products (each exact in f32) over up to 6.4e6
    # positions, whose rounding grows with the length of the sum (the two
    # f32 ways differed by 2.3e-4 of the largest entry on this card): 1e-3
    # stays 4x under one bf16 rounding of x itself (2^-8)
    check(gram["max_rel_err"] <= 1e-3, f"Gram: {gram}")
    return per_kernel


def phase_mm_autograd(dw_mm_act, dw_mm_bn_train) -> None:
    """The composite ``DwMmBnTrain`` (``(y, mean, var)`` and the gradients
    of x, w1, the taps, gamma and beta) and the eval entry's
    ``DwMmBnReluConv3d`` (y and the gradients of x, w1, the taps, sc and
    bi) against autograd through the plain composition: product → batch
    statistics → apply → relu → grouped F.conv3d, f32 (TF32 off), at
    layer4.0's stride-2 entry (14² → 7², C_in 96, C_mid 432), layer2's
    stride-1 one (28², C_in 48, C_mid 108) and layer4's 7² at stride 2
    (7² → 4², where K9 takes the ragged edge of an odd size), B2 T4.  The
    composite's relu input differs from the composition's by a rounding
    (statistics from the Gram, the product summed in another order), so an
    input within that of 0 takes the other branch, an O(1) local error in
    dx: these sizes (at most 0.68M activations each) keep the expected count
    of such inputs well below one, and the seed fixes it."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    eps = 1e-5
    for s, h, c_in, c in ((2, 14, 96, 432), (1, 28, 48, 108),
                          (2, 7, 96, 432)):
        b, t = 2, 4
        ho = (h - 1) // s + 1

        def rnd(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale
        x, w1 = rnd(b, t, h, h, c_in), rnd(c_in, c, scale=c_in ** -0.5)
        w = rnd(3, 3, 3, c, scale=0.2)
        gamma = torch.rand(c, generator=gen, device="cuda") + 0.5
        beta, bi = rnd(c, scale=0.3), rnd(c)
        sc = torch.rand(c, generator=gen, device="cuda") + 0.5
        g = rnd(b, t, ho, ho, c)

        def conv(a, w):
            return F.conv3d(a.permute(0, 4, 1, 2, 3),
                            w.permute(3, 0, 1, 2).unsqueeze(1),
                            stride=(1, s, s), padding=1,
                            groups=c).permute(0, 2, 3, 4, 1)

        def composite(x, w1, w, gamma, beta):
            return dw_mm_bn_train.mm_bn_train(x, w1, w, gamma, beta, s, eps)

        def composite_ref(x, w1, w, gamma, beta):
            z = x @ w1
            mean = z.mean((0, 1, 2, 3))
            var = (z * z).mean((0, 1, 2, 3)) - mean * mean
            a = torch.relu((z - mean) * torch.rsqrt(var + eps) * gamma
                           + beta)
            return conv(a, w), mean, var

        def entry(x, w1, w, sc, bi):
            return (dw_mm_act.dw_mm_bnrelu_conv3d_train(x, w1, w, sc, bi, s),)

        def entry_ref(x, w1, w, sc, bi):
            return (conv(torch.relu(x @ w1 * sc + bi), w),)

        for fn_name, fn, ref_fn, inputs, names in (
                ("DwMmBnTrain", composite, composite_ref,
                 (x, w1, w, gamma, beta),
                 ("y", "mean", "var", "dx", "dw1", "dw", "dgamma",
                  "dbeta")),
                ("DwMmBnReluConv3d", entry, entry_ref, (x, w1, w, sc, bi),
                 ("y", "dx", "dw1", "dw", "dsc", "dbi"))):
            leaves = [v.clone().requires_grad_() for v in inputs]
            out = fn(*leaves)
            out[0].backward(g)
            ref_leaves = [v.clone().requires_grad_() for v in inputs]
            ref = ref_fn(*ref_leaves)
            ref[0].backward(g)
            torch.cuda.synchronize()
            pairs = list(zip(out, ref)) + [(a_.grad, b_.grad) for a_, b_ in
                                           zip(leaves, ref_leaves)]
            rel = {}
            for name, (got, want) in zip(names, pairs):
                check(got.shape == want.shape, f"mm_autograd {name} shape")
                e, m = _rel_err(got.detach(), want.detach())
                rel[name] = e / max(m, 1e-30)
            emit({"phase": "mm_autograd", "function": fn_name,
                  "stride": s, "x": [b, t, h, h, c_in], "c_mid": c,
                  "dtype": "float32", "max_rel_err": rel, "rel_tol": 1e-4})
            # f32 both sides: sums over 2·4·7²..28² positions in other
            # orders, the statistics from the Gram
            check(max(rel.values()) <= 1e-4,
                  f"mm_autograd {fn_name} stride {s}: {rel}")


def _train_batch(device, gen, b, t, hw, tf, tl, n_classes, dtype):
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)
    return {
        "clips": rand(b, t, hw, hw, 3).to(dtype),
        "feats": {k: rand(b, tf, 7, 7, c) for k, c in BANKS},
        "feat_mask": torch.ones((b, tf), device=device),
        "meta": torch.tensor([[0, t, 2 * t, 1]] * b, dtype=torch.int32,
                             device=device),
        "labels": (rand(b, tl, n_classes) > 0.9).float(),
        "masks": torch.ones((b, tl), device=device),
    }


@contextlib.contextmanager
def composite_route(on: bool):
    """``CFN_MM_BN_TRAIN=1`` inside when ``on`` (every training bottleneck
    takes the matmul-fused composite), cleared after."""
    if on:
        os.environ["CFN_MM_BN_TRAIN"] = "1"
    try:
        yield
    finally:
        os.environ.pop("CFN_MM_BN_TRAIN", None)


def phase_train(mods, route: str = "act", ref: dict | None = None):
    """The coarse train step at full width on the card by ``route``: "act"
    (the default dispatch) or "mm" (the composite, ``CFN_MM_BN_TRAIN=1``).
    ``mods`` are the kernel modules whose counters are read; ``ref`` is the
    act route's row, printed beside the mm route's.  Returns the route's
    backward (act: every) kernel launches in the timed steps, and the
    row."""
    from coarse_fine_networks_torch.models import CoarseNet, init_parameters
    from coarse_fine_networks_torch.train import TrainState, make_train_step

    c = TRAIN
    ours = ACT_KERNELS if route == "act" else MM_KERNELS + MM_TRAIN_KERNELS
    t0 = time.perf_counter()
    model = init_parameters(CoarseNet("M", c["n_classes"], dropout_rate=0.5),
                            torch.Generator().manual_seed(0)).cuda()
    batch = _train_batch("cuda", torch.Generator(device="cuda").manual_seed(1),
                         c["b"], c["t"], c["hw"], c["tf"], c["tl"],
                         c["n_classes"], torch.bfloat16)
    step = make_train_step(model, align_corners=False,
                           fusion_lr_mult=c["fusion_lr_mult"])
    state = TrainState.create(model)
    drop = torch.Generator(device="cuda").manual_seed(2)
    build_s = time.perf_counter() - t0

    with composite_route(route == "mm"):
        losses = []
        for _ in range(c["warmup"]):
            state, m = step(state, batch, c["lr"], drop)
            losses.append(m["loss"].item())
        before = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in mods:
            mod.reset_launches()
        step_ms = []
        for _ in range(c["steps"]):
            t1 = time.perf_counter()
            state, m = step(state, batch, c["lr"], drop)
            loss = m["loss"].item()  # waits for the step
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(loss)
        launches = _launches(*mods)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        after = model.state_dict()

        def one_step():
            step(state, batch, c["lr"], drop)[1]["loss"].item()
        profiled = _profile_step(one_step, ACT_FUNCS + (
            "mm_fwd_s1_kernel", "mm_s2_fwd_kernel", "mm_dx_s1_kernel",
            "mm_s2_dx_kernel", "mm_wgrad_s1_kernel", "mm_s2_wgrad_kernel",
            "stencil_fwd_kernel", "stencil_dk_kernel"), mods)

    params = dict(model.named_parameters())
    moved = [k for k in params if not torch.equal(after[k], before[k])]
    nonfinite = [k for k, v in after.items()
                 if v.is_floating_point() and not torch.isfinite(v).all()]
    split = [k for k in after if "split_bn" in k]
    stuck = [k for k in split if torch.equal(after[k], before[k])]
    n = c["steps"]
    want = {k: n * (22 if k.endswith("_s1") else 4) * (k in ours)
            for k in launches}
    want.update({k: n * v for k, v in STEM_TRAIN.items()})
    mean_ms = sum(step_ms) / len(step_ms)
    phase = "train" if route == "act" else "train_mm"
    row = {"phase": phase, "route": route, "model": "X3D-M",
           "n_classes": c["n_classes"],
           "dtype": "bfloat16 activations, float32 parameters",
           "B": c["b"], "T": c["t"], "input_hw": c["hw"], "T_f": c["tf"],
           "label_len": c["tl"], "lr": c["lr"],
           "fusion_lr_mult": c["fusion_lr_mult"], "dropout": 0.5,
           "losses": losses, "step_ms": step_ms, "mean_step_ms": mean_ms,
           "clips_per_s": c["b"] / mean_ms * 1e3, "peak_mem_gb": peak_gb,
           "launches": {k: v for k, v in launches.items() if v},
           "params_moved": f"{len(moved)}/{len(params)}",
           "split_stats_unchanged": stuck, "model_build_s": build_s}
    if ref is not None:
        row["act_route"] = {k: ref[k] for k in ("mean_step_ms",
                                                "clips_per_s",
                                                "peak_mem_gb")}
    emit(row)
    emit({"phase": f"{phase}_profile",
          "what": f"one train step, B8 T64 224² bf16, {route} route",
          **profiled})
    check(all(np.isfinite(losses)), f"{phase} losses not finite: {losses}")
    check(not nonfinite, f"{phase}: non-finite parameters or stats: "
                         f"{nonfinite[:5]}")
    check(len(moved) == len(params),
          f"{phase}: parameters that did not move: "
          f"{[k for k in params if k not in moved][:5]}")
    check(split and not stuck, f"{phase}: split statistics unchanged: "
                               f"{stuck[:5]}")
    check(launches == want, f"{phase} launches {launches} != {want}")
    counted = (ACT_KERNELS + STENCIL_KERNELS if route == "act" else
               MM_TRAIN_KERNELS)
    return {k: launches[k] for k in counted}, row


# the CPU tests' coarse step (tests/_torch_port_util.py's COARSE)
UTILS_SMALL = dict(TRAIN, b=2, t=8, hw=64, tf=16, tl=32, n_classes=7)
UTILS_TIMED = 3  # steps timed by StepTimer and by CUDA events
STEP_TIMER_TOL = 0.05


def _step_runner(device: str, c: dict, dtype):
    """One coarse train step by the act route at configuration ``c`` (as
    :func:`phase_train` builds it) on ``device``: a function that runs a
    step on the state the last one left and returns its loss tensor."""
    from coarse_fine_networks_torch.models import CoarseNet, init_parameters
    from coarse_fine_networks_torch.train import TrainState, make_train_step

    model = init_parameters(CoarseNet("M", c["n_classes"], dropout_rate=0.5),
                            torch.Generator().manual_seed(0)).to(device)
    batch = _train_batch(device, torch.Generator(device=device).manual_seed(1),
                         c["b"], c["t"], c["hw"], c["tf"], c["tl"],
                         c["n_classes"], dtype)
    step = make_train_step(model, align_corners=False,
                           fusion_lr_mult=c["fusion_lr_mult"])
    box = [TrainState.create(model)]
    drop = torch.Generator(device=device).manual_seed(2)

    def run():
        box[0], m = step(box[0], batch, c["lr"], drop)
        return m["loss"]
    return run


def _traced_counts(log_dir: Path, counters: dict) -> tuple[dict, dict]:
    """Each port kernel function's launches in the one trace file under
    ``log_dir`` (its ``kernel`` records) and the counters' for the same
    work."""
    files = sorted(log_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"utils: trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    got = collections.Counter(_kernel_func(e["name"]) for e in events
                              if e.get("cat") == "kernel")
    want = {f: sum(counters.get(n, 0) for n in names)
            for f, names in KERNEL_FUNCS.items()}
    return {f: got.get(f, 0) for f in KERNEL_FUNCS}, want


def phase_utils(mods, smi: str, train_row: dict) -> None:
    """``utils/hw.py`` and ``utils/profiling.py`` on the card (phase 7b of
    the module docstring); ``train_row`` is phase 7's row, whose mean step
    time the full-width step's count is divided by."""
    from coarse_fine_networks_torch.utils import hw, profiling

    t0 = time.perf_counter()
    peaks = hw.chip_peaks()
    check(peaks.known and peaks == hw.H100_SXM,
          f"utils: chip_peaks of {torch.cuda.get_device_name(0)}: {peaks}")

    run = _step_runner("cuda", TRAIN, torch.bfloat16)
    run().item()  # a warm-up step: the first call's plans and allocations
    for m in mods:
        m.reset_launches()
    costs = hw.program_costs(run)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _launches(*mods).items() if v}
    calls = {k: v[0] for k, v in costs["kernels"].items()}
    check(sum(calls.values()) == sum(launches.values()),
          f"utils: kernel calls counted {calls} against launches {launches}")
    step_s = train_row["mean_step_ms"] / 1e3
    util = hw.utilization(costs["flops"], costs["bytes"], step_s)

    small = {dev: hw.program_costs(_step_runner(dev, UTILS_SMALL,
                                                torch.float32))
             for dev in ("cpu", "cuda")}
    check(small["cpu"]["flops"] == small["cuda"]["flops"],
          f"utils: the small step's FLOPs on the CPU "
          f"{small['cpu']['flops']} and on the card "
          f"{small['cuda']['flops']}")

    timer, events_ms = profiling.StepTimer(), []
    for _ in range(UTILS_TIMED):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = []
        with timer.measure(out):
            out.append(run())
        end.record()
        end.synchronize()
        events_ms.append(start.elapsed_time(end))
    timer_ms = [t * 1e3 for t in timer.times]
    apart = abs(sum(timer_ms) - sum(events_ms)) / sum(events_ms)

    log_dir = SCRATCH / "utils_trace"
    with profiling.trace(str(log_dir)):
        for m in mods:
            m.reset_launches()
        run().item()
    traced, want = _traced_counts(log_dir, _launches(*mods))

    emit({"phase": "utils", "nvidia_smi": smi, "chip_peaks": peaks._asdict(),
          "step": "phase train's: X3D-M, 157 classes, B8 T64 224² bf16, "
                  "fusion ×10, act route",
          "flops": costs["flops"], "bytes": costs["bytes"],
          "kernels": costs["kernels"], "launches": launches,
          "mean_step_ms": train_row["mean_step_ms"], **util,
          "small_step": {dev: {"flops": v["flops"], "bytes": v["bytes"]}
                         for dev, v in small.items()},
          "step_timer_ms": timer_ms, "cuda_events_ms": events_ms,
          "step_timer_apart": apart,
          "traced": {f: n for f, n in traced.items() if n},
          "counters": {f: n for f, n in want.items() if n},
          "seconds": time.perf_counter() - t0})
    check(apart <= STEP_TIMER_TOL,
          f"utils: StepTimer {timer_ms} against CUDA events {events_ms}")
    check(traced == want and any(traced.values()),
          f"utils: traced kernel launches {traced} against the counters "
          f"{want}")

    # the examples as a user runs them, both at once (a process each)
    t1 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"coarse_fine_networks_torch.examples.{name}",
         *args, "--device", "cuda"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, args in (("demo_synthetic",
                            [str(SCRATCH / "demo_synthetic")]),
                           ("demo_serving", []))}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            emit({"phase": "utils", "example": name, "rc": proc.returncode,
                  "seconds": time.perf_counter() - t1,
                  "stdout_tail": out[-800:], "stderr_tail": err[-1500:]})
            check(proc.returncode == 0, f"utils: the example {name} failed")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _stage(name: str) -> str:
    top = name.split(".")[0]
    if top.startswith(("rw", "mix")):
        return "fusion"
    if top.startswith(("layer", "pool_")):
        return top
    return "stem" if top in ("conv1_s", "conv1_t", "bn1") else "head"


def _compare_grads(row: dict, g_ref: dict, g: dict, zero: tuple) -> None:
    """Every parameter's gradient on the card ``g`` against the CPU's
    ``g_ref`` (f32 both): the relative L2 distance per stage, and per tensor
    the largest difference over the tensor's largest magnitude.  ``zero``
    names the tensors whose gradient is zero up to rounding (a bias that a
    training-mode batch norm takes out again): each is held below
    ``ZERO_GRAD`` of the largest gradient on both devices instead.  Emits
    ``row`` with the readings, then raises past ``GRAD_STAGE_TOL`` or
    ``GRAD_TENSOR_TOL``."""
    phase = row["phase"]
    top = max(v.abs().max().item() for v in g_ref.values())
    check(set(zero) <= set(g_ref), f"{phase}: unknown tensors "
                                   f"{set(zero) - set(g_ref)}")
    zeros = {k: [g_ref[k].abs().max().item() / top,
                 g[k].abs().max().item() / top] for k in zero}
    acc, rel = {}, {}
    for k, v in g_ref.items():
        d = (g[k] - v).double()
        e = acc.setdefault(_stage(k), [0.0, 0.0])
        e[0] += float((d ** 2).sum())
        e[1] += float((v.double() ** 2).sum())
        if k not in zeros:
            rel[k] = (d.abs().max() / v.abs().max().clamp(min=1e-30)).item()
    stage = {s: (x / n) ** 0.5 for s, (x, n) in sorted(acc.items())}
    row.update({
        "grad_stage_rel_l2": stage,
        "grad_median_rel_max_err": float(np.median(list(rel.values()))),
        "grad_worst_rel_max_err": sorted(rel.items(),
                                         key=lambda kv: -kv[1])[:6],
        "zero_grads_over_largest_cpu_card": zeros,
        "stage_tol": GRAD_STAGE_TOL, "tensor_tol": GRAD_TENSOR_TOL,
        "zero_tol": ZERO_GRAD})
    emit(row)
    bad = {k: v for k, v in zeros.items() if max(v) > ZERO_GRAD}
    check(not bad, f"{phase}: gradients that should vanish do not: {bad}")
    check(max(stage.values()) <= GRAD_STAGE_TOL,
          f"{phase}: gradients card vs CPU per stage {stage}")
    over = {k: e for k, e in rel.items() if e > GRAD_TENSOR_TOL}
    check(not over, f"{phase}: gradients card vs CPU per tensor {over}")


def phase_train_card_vs_cpu(route: str = "act") -> None:
    """One small f32 train step (X3D-M, 157 classes, B=2, T=8, 64²,
    T_f=16, label length 32, dropout 0) on the card and on the CPU from the
    same weights, by ``route`` (as :func:`phase_train`): the loss, and
    every parameter's gradient."""
    from coarse_fine_networks_torch.models import CoarseNet, init_parameters
    from coarse_fine_networks_torch.train import TrainState, make_train_step

    cpu = init_parameters(CoarseNet("M", 157, dropout_rate=0.0),
                          torch.Generator().manual_seed(7))
    gpu = CoarseNet("M", 157, dropout_rate=0.0).cuda()
    gpu.load_state_dict(cpu.state_dict())
    batch = _train_batch("cpu", torch.Generator().manual_seed(8), 2, 8, 64,
                         16, 32, 157, torch.float32)
    out = {}
    with composite_route(route == "mm"):
        for name, model in (("cpu", cpu), ("card", gpu)):
            step = make_train_step(model, align_corners=False,
                                   fusion_lr_mult=10.0)
            _, m = step(TrainState.create(model), batch, 0.02)
            out[name] = (m["loss"].item(),
                         {k: p.grad.detach().cpu() for k, p in
                          model.named_parameters()})
    (loss_ref, g_ref), (loss, g) = out["cpu"], out["card"]
    phase = "train_card_vs_cpu" if route == "act" else "train_mm_card_vs_cpu"
    row = {"phase": phase, "route": route, "dtype": "float32",
           "input_hw": 64, "B": 2, "T": 8, "loss_cpu": loss_ref,
           "loss_card": loss, "loss_rel_err": abs(loss - loss_ref) /
           abs(loss_ref)}
    _compare_grads(row, g_ref, g, COARSE_ZERO_GRADS)
    # the forward loss: f32 sums in other orders
    check(abs(loss - loss_ref) <= 1e-4 * abs(loss_ref),
          f"{phase}: loss card {loss} vs CPU {loss_ref}")


def fine_phases():
    """(name, B, T, crop, label window, splits) of the four long-cycle
    phases of the fine driver's schedule."""
    from coarse_fine_networks_torch.train import LongCycleSchedule

    sched = LongCycleSchedule(*FINE["base"])
    for epoch, name in enumerate("ABCD"):
        frames, crop, b = sched.shapes(epoch)
        yield (name, b, 2 * frames // 10, crop, 2 * frames,
               sched.phase(epoch).bn_split_scale)


def fine_phase(name):
    return next(p for p in fine_phases() if p[0] == name)


def fine_entry_cases(crop):
    """(label, H, C, stride, blocks) of the 8 fine-tower bottleneck entries
    at one phase's crop: the stem halves the crop, each stage's block 0
    halves it again (odd sizes round up); ``blocks`` run at that shape."""
    h = (crop - 1) // 2 + 1
    for layer, c_mid, n in STAGES:
        yield f"{layer}.0", h, c_mid, 2, 1
        h = (h - 1) // 2 + 1
        yield f"{layer}.1-{n - 1}", h, c_mid, 1, n - 1


def _hold_time_library(phase, name, meta, dtype, kern, plain, library,
                       lib_what, work, n, counted, agg,
                       also=(), also_exact=False) -> dict:
    """Kernel ``kern`` held against its plain version, and against each of
    ``also`` (``(name, fn)``: another kernel of the same function, or the
    same kernel again; with ``also_exact`` the difference must be 0), then
    timed beside the plain version and ``library``, the one PyTorch call
    that computes the same function, ``work`` its ``utils.hw.Work``; one
    row, ``meta`` naming the shape,
    which it returns.  A bf16 row at a ``counted`` shape adds its times,
    weighted by ``n`` (its launches on the path), to ``agg``."""
    got, ref = kern(), plain()
    more = {k: fn() for k, fn in also}
    torch.cuda.synchronize()
    what = f"{name} {meta['entry']} {dtype}"
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{what}: shape/dtype {got.shape} {got.dtype}")
    err, scale = _rel_err(got, ref)
    also_err = {k: _rel_err(got, v)[0] for k, v in more.items()}
    del got, ref, more
    row = {"phase": phase, "kernel": name, **meta, "dtype": str(dtype)[6:],
           "path_launches": n, "max_abs_err": err, "ref_absmax": scale,
           **({"max_abs_err_vs": also_err} if also else {}),
           "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 2, 1),
           "library_ms": cuda_ms(library, 10), "library_call": lib_what,
           **_bound(work, dtype)}
    emit(row)
    tol = TOL[dtype] * max(scale, 1.0)
    check(err <= tol, f"{what}: max abs err {err} (max |plain| {scale})")
    also_tol = 0.0 if also_exact else tol
    check(all(e <= also_tol for e in also_err.values()),
          f"{what}: against the other kernels {also_err} > {also_tol}")
    if dtype == torch.bfloat16:
        # the trained and served dtype
        if counted:
            for key in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms",
                        "bound_ms"):
                agg[key] = agg.get(key, 0.0) + n * row[key]
            agg["launches"] += n
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
    else:
        agg["max_abs_err_f32"] = max(agg["max_abs_err_f32"], err)
    return row


def _plan_row(dw_conv, shape, dtype, keys=("fwd", "wgrad")) -> dict:
    """The stride-1 kernels' work split (``plan_s1``) at x ``shape`` and
    what the card makes of it for each of ``keys``: blocks per SM (the
    occupancy API) and waves of the forward (K1 plain), the weight gradient
    (K6 plain), the act weight gradient (K6 act, ``act_wgrad``) or the act
    forward (K1 act, ``act_fwd``)."""
    p = dw_conv.plan_s1(*shape)
    lib = dw_conv.LIBRARY.build()
    esz, bf16 = torch.finfo(dtype).bits // 8, int(dtype == torch.bfloat16)
    row = {"r": p.r, "wb": p.wb, "pg": p.pg, "tt": p.tt, "ipb": p.ipb,
           "rows": p.rows, "threads": p.threads}
    for key in keys:
        kind = ("fwd", "wgrad", "act_wgrad", "act_fwd").index(key)
        wgrad, act = kind in (1, 2), kind >= 2
        blocks = (p.rows if wgrad else p.items) * p.n_pg
        occ = lib.dw_plain_s1_occupancy(kind, p.r, p.wb, p.pg, bf16)
        check(occ > 0, f"plan {shape} {dtype}: {key} does not fit ({occ})")
        row[key] = {"blocks": blocks, "smem": p.smem(esz, wgrad, act),
                    "blocks_per_sm": occ, "waves": _waves(blocks, occ)}
    return row


def _waves(blocks: int, per_sm: int) -> float:
    return blocks / (per_sm * torch.cuda.get_device_properties(
        0).multi_processor_count)


def _plan_row_s2(dw_conv, name, shape, dtype) -> dict:
    """The work split of stride-2 kernel ``name`` at x ``shape`` (over the
    output's rows and columns; the dx's over g's): its blocks (K4 plain and
    act, K8 and K5: one per tile; K10 plain and act: their persistent
    grid), shared memory, blocks per SM and waves."""
    kind, plan, smem = {
        "dw_conv_s2": (0, dw_conv.plan_s2_fwd, dw_conv.smem_s2_fwd),
        "dw_act_s2": (5, dw_conv.plan_act_s2_fwd,
                      lambda p, esz: dw_conv.smem_s2_fwd(p, esz, True)),
        "dw_conv_dx_s2": (1, dw_conv.plan_s2_dx, dw_conv.smem_s2_dx),
        "dw_conv_wgrad_s2": (2, dw_conv.plan_s2, dw_conv.smem_s2),
        "dw_act_dx_s2": (3, dw_conv.plan_act_dx_s2,
                         dw_conv.smem_act_dx_s2),
        "dw_act_wgrad_s2": (4, dw_conv.plan_s2,
                            lambda p, esz: dw_conv.smem_s2(p, esz, True)),
    }[name]
    p = plan(*shape)
    esz, bf16 = torch.finfo(dtype).bits // 8, int(dtype == torch.bfloat16)
    occ = dw_conv.LIBRARY_S2.build().dw_plain_s2_occupancy(kind, p.r, p.wb,
                                                           p.pg, bf16)
    check(occ > 0, f"{name} plan {shape} {dtype}: does not fit ({occ})")
    wgrad = kind in (2, 4)
    blocks = (p.rows if wgrad else p.items) * p.n_pg
    return {"r": p.r, "wb": p.wb, "pg": p.pg, "tt": p.tt,
            **({"ipb": p.ipb, "rows": p.rows} if wgrad else {}),
            "threads": p.threads, "blocks": blocks, "smem": smem(p, esz),
            "blocks_per_sm": occ, "waves": _waves(blocks, occ)}


def _plan_row_mm(dw_conv, dw_mm_act, shape, c_mid, dtype) -> dict:
    """K1 mm's work split at x ``shape`` (C_in last) and ``c_mid``: its
    blocks, shared memory, blocks per SM and waves."""
    b, t, h, w, c_in = shape
    esz, bf16 = torch.finfo(dtype).bits // 8, int(dtype == torch.bfloat16)
    p = dw_conv.plan_mm_s1(b, t, h, w, c_in, c_mid, esz)
    occ = dw_mm_act.LIBRARY.build().dw_mm_act_s1_occupancy(p.r, p.wb, p.pg,
                                                           c_in, w, bf16)
    check(occ > 0, f"plan_mm_s1 {shape} {dtype}: does not fit ({occ})")
    blocks = p.items * p.n_pg
    return {"r": p.r, "wb": p.wb, "pg": p.pg, "tt": p.tt,
            "threads": p.threads, "blocks": blocks,
            "smem": dw_conv.smem_mm_s1(p, c_in, esz), "blocks_per_sm": occ,
            "waves": _waves(blocks, occ)}


def phase_fine_kernels(dw_conv, dw_stencil) -> dict:
    """The five kernels of the split-batch-norm route against their plain
    versions, and timed beside the PyTorch call that computes the same
    function, at the fine entry shapes of long-cycle phases A-C.  The
    stride-1 forward is also held against K11 (``dw_stencil_s1``, the same
    function at 3×3×3, summed in the same order), the stride-2 forward
    against K7 (``dw_stencil_s2``, likewise) and the stride-2 dx against
    K11 on g at the even positions of a zero tensor of x's shape with the
    flipped taps (its nonzero terms in the same order): each difference
    must be 0; the weight gradients (stride 1 and 2) are launched twice and
    must repeat bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    per_kernel = {k: _agg() for k in FINE_KERNELS}
    ncdhw = (0, 4, 1, 2, 3)
    for dtype in (torch.float32, torch.bfloat16):
        for phase, b, t, crop, _, splits in fine_phases():
            if splits == 1:
                continue  # phase D takes the act-mode entry
            for label, h, c, s, blocks in fine_entry_cases(crop):
                ho = (h - 1) // s + 1
                x = torch.randn((b, t, h, h, c), generator=gen,
                                device="cuda").relu().to(dtype)
                w = (torch.randn((3, 3, 3, c), generator=gen, device="cuda")
                     / 27 ** 0.5).to(dtype)
                g = torch.randn((b, t, ho, ho, c), generator=gen,
                                device="cuda").to(dtype)
                w_conv = w.permute(3, 0, 1, 2).unsqueeze(1).contiguous()
                # channels-last tensors seen as NCDHW: channels_last_3d
                xc, gc = x.permute(ncdhw), g.permute(ncdhw)
                bw = ([1, s, s], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], c)

                def conv_bwd(mask):
                    return torch.ops.aten.convolution_backward(
                        gc, xc, w_conv, None, *bw, mask)

                # launches per step: the stride-1 forward kernel is also
                # each block's dx
                cases = {f"dw_conv_s{s}": (
                    lambda: dw_conv.dw_conv3d(x, w, s),
                    lambda: dw_conv.dw_conv3d_plain(x, w, s),
                    lambda: F.conv3d(xc, w_conv, stride=(1, s, s),
                                     padding=1, groups=c),
                    "F.conv3d(groups=C), channels_last_3d",
                    dw_conv.fwd_work(g, x, w, s),
                    blocks * (2 if s == 1 else 1))}
                if s == 2:
                    cases["dw_conv_dx_s2"] = (
                        lambda: dw_conv.dw_conv_dx_s2(g, w, (h, h)),
                        lambda: dw_conv.dw_conv_dx_s2_plain(g, w, (h, h)),
                        lambda: conv_bwd([True, False, False])[0],
                        "aten.convolution_backward, input gradient only",
                        dw_conv.dx_work(x, g, w, (h, h)), blocks)
                cases[f"dw_conv_wgrad_s{s}"] = (
                    lambda: dw_conv.dw_conv_wgrad(x, g, s),
                    lambda: dw_conv.dw_conv_wgrad_plain(x, g, s),
                    lambda: conv_bwd([False, True, False])[1],
                    "aten.convolution_backward, weight gradient only",
                    dw_conv.wgrad_work(None, x, g, s), blocks)
                also = {
                    "dw_conv_s1": (("dw_stencil_s1",
                                    lambda: dw_stencil.dw_stencil3d(x, w)),),
                    f"dw_conv_wgrad_s{s}": ((f"dw_conv_wgrad_s{s} again",
                                             lambda: dw_conv.dw_conv_wgrad(
                                                 x, g, s)),)}
                if s == 2:
                    # g at the even positions of a zero tensor of x's shape
                    up = torch.zeros_like(x)
                    up[:, :, ::2, ::2] = g
                    w_flip = torch.flip(w, (0, 1, 2)).contiguous()
                    also["dw_conv_s2"] = (("dw_stencil_s2",
                                           lambda: dw_stencil.dw_stencil3d(
                                               x, w, (1, 2, 2))),)
                    also["dw_conv_dx_s2"] = ((
                        "dw_stencil_s1 on up(g), flip(w)",
                        lambda: dw_stencil.dw_stencil3d(up, w_flip)),)
                meta = {"entry": f"fine.{phase}.{label}",
                        "x": [b, t, h, h, c], "stride": s}
                plans = (dict.fromkeys(cases, _plan_row(
                    dw_conv, (b, t, h, h, c), dtype)) if s == 1 else
                         {name: _plan_row_s2(dw_conv, name, (b, t, h, h, c),
                                             dtype) for name in cases})
                # each shape weighted by its launches in one step of each
                # of phases A-C
                for name, case in cases.items():
                    _hold_time_library(
                        "fine_kernels", name, {**meta, "plan": plans[name]},
                        dtype, *case, True, per_kernel[name],
                        also.get(name, ()), also_exact=name in also)
                del x, g, xc, gc
                if s == 2:
                    del up
            torch.cuda.empty_cache()
    return per_kernel


def _depthwise_vs_autograd(phase, fn, x, w, strides, gen) -> None:
    """``fn(x, w)`` (y, dx and the taps' gradient, against a cotangent drawn
    from ``gen``) against autograd through ``F.conv3d(groups=C)``, f32
    (TF32 off); one row, each tensor held at 1e-4 of its largest value: f32
    both sides, the taps' gradient a sum over up to 8·16·56² positions in
    another order."""
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = fn(xa, wa)
    g = torch.randn(y.shape, generator=gen, device="cuda")
    y.backward(g)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    yr = F.conv3d(xr.permute(0, 4, 1, 2, 3),
                  wr.permute(3, 0, 1, 2).unsqueeze(1), stride=strides,
                  padding=[k // 2 for k in w.shape[:3]],
                  groups=x.shape[-1]).permute(0, 2, 3, 4, 1)
    yr.backward(g)
    torch.cuda.synchronize()
    errs = {"y": _rel_err(y, yr), "dx": _rel_err(xa.grad, xr.grad),
            "dw": _rel_err(wa.grad, wr.grad)}
    rel = {k: e / max(m, 1e-30) for k, (e, m) in errs.items()}
    emit({"phase": phase, "taps": list(w.shape[:3]), "strides": list(strides),
          "x": list(x.shape), "dtype": "float32", "max_rel_err": rel,
          "rel_tol": 1e-4})
    check(max(rel.values()) <= 1e-4,
          f"{phase} {tuple(w.shape[:3])} {strides}: {rel}")


def phase_fine_autograd(dw_conv) -> None:
    """The split route's Function (forward, dx, dw) against autograd through
    ``F.conv3d(groups=C)``, f32 (TF32 off), at phase B's odd stride-2 entry
    (layer4.0, 9×9 → 5×5) and its layer2 stride-1 entry (18×18)."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    for s, h, c in ((2, 9, 432), (1, 18, 108)):
        x = torch.randn((32, 32, h, h, c), generator=gen, device="cuda").relu()
        w = torch.randn((3, 3, 3, c), generator=gen, device="cuda") / 5
        _depthwise_vs_autograd(
            "fine_autograd", lambda a, k: dw_conv.dw_conv3d_train(a, k, s), x,
            w, (1, s, s), gen)


def stem_cases():
    """(label, B, T, H, launches of ``dw_stencil_s1``, of
    ``dw_stencil_wgrad``, counted) of the stem's ``conv1_t`` input
    (``conv1_s``'s output: C=24, half the crop) on every path: the serve
    phase's two towers (launches in its counted run: the fine tower's cold
    extract; the coarse tower's cold and hit fuse), the coarse train step
    (per step: the forward and the dx, the taps' gradient; these rows make
    up the two kernels' line) and the four long-cycle phases (per step)."""
    h = (TRAIN["hw"] - 1) // 2 + 1
    yield "serve.fine", SERVE_B, TOWERS["fine"][0]["layer1"], h, 1, 0, False
    yield ("serve.coarse", SERVE_B, TOWERS["coarse"][0]["layer1"], h, 2, 0,
           False)
    yield "train.coarse", TRAIN["b"], TRAIN["t"], h, 2, 1, True
    for name, b, t, crop, _, _ in fine_phases():
        yield f"fine.{name}", b, t, (crop - 1) // 2 + 1, 2, 1, False


def stencil_cases():
    """(label, x shape, taps, strides, launches of the forward, of the
    taps' gradient, counted, the other kernel of the same function) of
    :func:`phase_stencil_kernels`.  K7 has no caller: each of its four
    entry shapes counts once in its line."""
    for label, b, t, h, n_fwd, n_wg, counted in stem_cases():
        yield (label, (b, t, h, h, STEM_C), STEM_K, (1, 1, 1), n_fwd, n_wg,
               counted, None)
    _, _, _, h1, _, c1, _ = ENTRY_SHAPES[0]
    yield ("train.coarse.layer1.1-2", (TRAIN["b"], TRAIN_FRAMES["layer1"], h1,
                                       h1, c1), (3, 3, 3), (1, 1, 1), 0, 0,
           False, "dw_conv_s1")
    for ks in (STEM_K, (3, 1, 1), (3, 3, 3), (1, 3, 3)):
        for hw in ((7, 7), (5, 9)):
            yield (f"ragged.{hw[0]}x{hw[1]}", (2, 17) + hw + (STEM_C,), ks,
                   (1, 1, 1), 0, 0, False, None)
    for layer, h_s2, _, _, _, c_mid, _ in ENTRY_SHAPES:
        yield (f"train.coarse.{layer}.0", (TRAIN["b"], TRAIN_FRAMES[layer],
                                           h_s2, h_s2, c_mid), (3, 3, 3),
               (1, 2, 2), 1, 0, True, "dw_conv_s2")
    for hw in ((7, 7), (5, 9)):
        yield (f"ragged.{hw[0]}x{hw[1]}", (2, 17) + hw + (STEM_C,), (3, 3, 3),
               (1, 2, 2), 0, 0, False, "dw_conv_s2")


def _plan_row_stencil(dw_stencil, shape, ks, dtype) -> dict:
    """K11's work split (``plan_stencil_fwd``) at x ``shape`` and taps
    ``ks``: one block per (item, channel group), its ring's shared memory,
    blocks per SM (the occupancy API) and waves."""
    p = dw_stencil.plan_stencil_fwd(*shape, ks[0], ks[1])
    esz, bf16 = torch.finfo(dtype).bits // 8, int(dtype == torch.bfloat16)
    occ = dw_stencil.LIBRARY.build().dw_stencil_s1_occupancy(
        shape[-1], ks[0], ks[1], bf16)
    check(occ > 0, f"plan_stencil_fwd {shape} {ks} {dtype}: does not fit "
                   f"({occ})")
    blocks = p.items * p.n_cg
    return {**p._asdict(), "threads": p.threads, "blocks": blocks,
            "smem": dw_stencil.FWD_DEPTH * ks[1] * ks[2] * p.threads * p.v
            * esz, "blocks_per_sm": occ, "waves": _waves(blocks, occ)}


def phase_stencil_kernels(dw_stencil, dw_conv) -> dict:
    """K11 (``dw_stencil_s1``), K7 (``dw_stencil_s2``) and the taps'
    gradient (``dw_stencil_wgrad``) against their plain versions at the
    shapes of :func:`stencil_cases`, f32 (TF32 off) and bf16, timed beside
    the plain version and the one PyTorch call that computes the same
    function; the 3×3×3 stencils also against ``dw_conv_s1``/``dw_conv_s2``
    (the same functions, summed in the same order: the difference must be
    0), the taps' gradient against itself run again (bit for bit) and its
    partial buffer's rows (``dw_stencil_partial_rows``) against
    ``plan_stencil_wgrad``'s.  Each stem kernel's bf16 time at each path's
    stem shape, weighted by its launches per step there, is kept by path
    (``by_path``)."""
    gen = torch.Generator(device="cuda").manual_seed(40)
    per_kernel = {k: _agg() for k in STENCIL_KERNELS}
    ncdhw = (0, 4, 1, 2, 3)
    lib = dw_stencil.LIBRARY.build()
    stem = {label for label, *_ in stem_cases()}

    def by_path(name, label, row, n):
        if dtype == torch.bfloat16 and label in stem and n:
            per_kernel[name].setdefault("by_path", {})[label] = {
                "launches_per_step": n, "ms": n * row["ms"],
                "bound_ms": n * row["bound_ms"]}

    for dtype in (torch.float32, torch.bfloat16):
        for (label, shape, ks, strides, n_fwd, n_wg, counted,
             other) in stencil_cases():
            c, taps = shape[-1], ks[0] * ks[1] * ks[2]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(ks + (c,), generator=gen, device="cuda")
                 / taps ** 0.5).to(dtype)
            w_conv = w.permute(3, 0, 1, 2).unsqueeze(1).contiguous()
            pad = [k // 2 for k in ks]
            y_meta = torch.empty(dw_stencil._out_shape(x, strides),
                                 dtype=dtype, device="meta")
            meta = {"entry": label, "x": list(shape), "taps": list(ks),
                    "strides": list(strides)}
            s = strides[2]
            name = f"dw_stencil_s{s}"
            if s == 1:
                meta["plan"] = _plan_row_stencil(dw_stencil, shape, ks, dtype)
            else:  # K7 runs K4 plain's kernel and plan
                meta["plan"] = _plan_row_s2(dw_conv, "dw_conv_s2", shape,
                                            dtype)
            also = (() if other is None else
                    ((other, lambda: dw_conv.dw_conv3d(x, w, s)),))
            row = _hold_time_library(
                "stencil_kernels", name, meta, dtype,
                lambda: dw_stencil.dw_stencil3d(x, w, strides),
                lambda: dw_stencil.dw_stencil3d_plain(x, w, strides),
                lambda: F.conv3d(x.permute(ncdhw), w_conv, stride=strides,
                                 padding=pad, groups=c),
                "F.conv3d(groups=C), channels_last_3d",
                dw_stencil.fwd_work(y_meta, x, w, strides), n_fwd, counted,
                per_kernel[name], also, also_exact=True)
            by_path(name, label, row, n_fwd)
            if s == 1:
                g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                bw = ([1, 1, 1], pad, [1, 1, 1], False, [0, 0, 0], c)
                plan = dw_stencil.plan_stencil_wgrad(*shape, ks[0], ks[1])
                rows = lib.dw_stencil_partial_rows(*shape, ks[0], ks[1])
                check(rows == plan.rows, f"dw_stencil_wgrad {label} {ks}: "
                                         f"{rows} partial rows, the mirror "
                                         f"{plan}")
                row = _hold_time_library(
                    "stencil_kernels", "dw_stencil_wgrad",
                    {**meta, "plan": {**plan._asdict(),
                                      "threads": plan.threads}}, dtype,
                    lambda: dw_stencil.dw_stencil_wgrad(x, g, ks),
                    lambda: dw_stencil.dw_stencil_wgrad_plain(x, g, ks),
                    lambda: torch.ops.aten.convolution_backward(
                        g.permute(ncdhw), x.permute(ncdhw), w_conv, None,
                        *bw, [False, True, False])[1],
                    "aten.convolution_backward, weight gradient only",
                    dw_stencil.wgrad_work(None, x, g, ks), n_wg,
                    counted, per_kernel["dw_stencil_wgrad"],
                    (("dw_stencil_wgrad again",
                      lambda: dw_stencil.dw_stencil_wgrad(x, g, ks)),),
                    also_exact=True)
                by_path("dw_stencil_wgrad", label, row, n_wg)
                del g
            del x
        torch.cuda.empty_cache()
    return per_kernel


def phase_stencil_autograd(dw_stencil) -> None:
    """``depthwise_conv3d`` (y, dx and the taps' gradient) against autograd
    through ``F.conv3d(groups=C)``, f32 (TF32 off): 5×1×1 at long-cycle
    phase A's stem shape cut to B8, 3×3×3 at stride 1 on a layer1 shape,
    and at stride (1, 2, 2) at layer4.0 (14² → 7²) and at the ragged 7² →
    4²; then the stem's gradients (the input, ``conv1_s``, ``conv1_t``,
    ``bn1``) against autograd through the grouped conv, the route
    ``conv1_t`` took before."""
    from coarse_fine_networks_torch.models import X3DStem, init_parameters
    from coarse_fine_networks_torch.models.layers import conv3d

    gen = torch.Generator(device="cuda").manual_seed(41)
    for ks, strides, shape in (
            (STEM_K, (1, 1, 1), (8, 16, 56, 56, STEM_C)),
            ((3, 3, 3), (1, 1, 1), (2, 8, 28, 28, 54)),
            ((3, 3, 3), (1, 2, 2), (2, 8, 14, 14, 432)),
            ((3, 3, 3), (1, 2, 2), (2, 8, 7, 7, 432))):
        x = torch.randn(shape, generator=gen, device="cuda")
        w = torch.randn(ks + shape[-1:], generator=gen, device="cuda") / 5
        _depthwise_vs_autograd(
            "stencil_autograd",
            lambda a, k: dw_stencil.depthwise_conv3d(a, k, strides), x, w,
            strides, gen)

    stem = init_parameters(X3DStem(STEM_C),
                           torch.Generator().manual_seed(42)).cuda().train()
    x = torch.rand((2, 16, 64, 64, 3), generator=gen, device="cuda")
    g = torch.randn((2, 16, 32, 32, STEM_C), generator=gen, device="cuda")

    def grads(fn):
        stem.zero_grad(set_to_none=True)
        xa = x.clone().requires_grad_()
        y = fn(xa)
        y.backward(g)
        return {"y": y.detach(), "x": xa.grad,
                **{k: p.grad for k, p in stem.named_parameters()}}

    dw_stencil.reset_launches()
    got = grads(stem)
    launches = dict(dw_stencil.LAUNCHES)
    ref = grads(lambda a: torch.relu(stem.bn1(conv3d(conv3d(a, stem.conv1_s),
                                                     stem.conv1_t))))
    torch.cuda.synchronize()
    missing = [k for k, v in got.items() if v is None or not v.abs().max()]
    rel = {k: _rel_err(got[k], v)[0] / max(v.abs().max().item(), 1e-30)
           for k, v in ref.items() if k not in missing}
    emit({"phase": "stencil_autograd", "what": "X3DStem(24) in training, "
          "B2 T16 64² f32, against the grouped F.conv3d route",
          "launches": launches, "max_rel_err": rel, "rel_tol": 1e-4})
    check(not missing, f"stem gradients missing or zero: {missing}")
    check(launches == {"dw_stencil_s1": 2, "dw_stencil_s2": 0,
                       "dw_stencil_wgrad": 1}, f"stem launches {launches}")
    check(max(rel.values()) <= 1e-4, f"stem gradients: {rel}")


def _fine_host_batch(gen, b, t, hw, tl, n_classes):
    """A seeded host-format batch, made on the card: uint8 clips
    ``(B, 1, T, H, W, 3)``, per-clip flips, a clip mask whose last sample
    pads its last quarter, multi-hot labels and their mask."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")
    clip_mask = torch.ones((b, t), device="cuda")
    clip_mask[-1, 3 * t // 4:] = 0
    masks = torch.ones((b, tl), device="cuda")
    masks[-1, 3 * tl // 4:] = 0
    return {"clips": torch.randint(0, 256, (b, 1, t, hw, hw, 3),
                                   generator=gen, device="cuda",
                                   dtype=torch.uint8),
            "flip": rand(b) > 0.5, "clip_mask": clip_mask,
            "labels": (rand(b, tl, n_classes) > 0.9).float(),
            "masks": masks}


def _launches(*mods) -> dict:
    """Every kernel's launches in ``mods``' counters in this process."""
    out = {}
    for m in mods:
        out.update(m.LAUNCHES)
    return out


def _depthwise_conv(e) -> bool:
    """Whether profiler event ``e`` is a PyTorch convolution (forward or
    backward) with a depthwise weight ``(C, 1, kt, kh, kw)``, C > 1."""
    i = {"aten::convolution": 1, "aten::convolution_backward": 2}.get(e.name)
    if i is None or len(e.input_shapes) <= i:
        return False
    w = e.input_shapes[i]
    return len(w) == 5 and w[1] == 1 and w[0] > 1


def _kernel_func(key: str) -> str:
    """The kernel function a profiler key names: ``void (anonymous
    namespace)::wgrad_kernel<float, 1, 0>(...)`` → ``wgrad_kernel``."""
    m = re.search(r"(\w+)<", key)
    return m.group(1) if m else key


def _profiled_counts(kernels, counters) -> tuple[dict, dict]:
    """Each port kernel function's launches in a profile (``e.count`` of
    its instantiations) and the wrappers' counters for the same call."""
    got = {}
    for e in kernels:
        f = _kernel_func(e.key)
        if f in KERNEL_FUNCS:
            got[f] = got.get(f, 0) + e.count
    want = {f: sum(counters.get(n, 0) for n in names)
            for f, names in KERNEL_FUNCS.items()}
    return {f: got.get(f, 0) for f in KERNEL_FUNCS}, want


def _device_kernels(events) -> list:
    """The device records of profiler ``events``, without the
    ``ProfilerStep#`` span the profiler's schedule adds on the device."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


def _trace_note(prof) -> dict:
    """Where a profile's port kernels sit among its device records, in
    time order: the record count, the first few kernels, and the indices of
    each port kernel function's records."""
    names = [_kernel_func(e.name) for e in sorted(
        _device_kernels(prof.events()), key=lambda e: e.time_range.start)]
    return {"records": len(names), "first": names[:6],
            "at": {f: [i for i, n in enumerate(names) if n == f]
                   for f in ("stencil_fwd_kernel", "stencil_dk_kernel")}}


def _profile_step(fn, ours, mods, warm: bool = True) -> dict:
    """``fn`` under ``torch.profiler``: kernel time by name, the port's
    kernels' share (``ours``: kernel functions), the card's busy share.
    Then ``fn`` once more with the host ops' input shapes recorded (kept out
    of the timed run, whose host time they would inflate): raises if a
    grouped depthwise convolution ran in PyTorch (every depthwise conv of
    the port's paths runs through its kernels, the stem's ``conv1_t``
    included).  In both runs each port kernel's profiled launches are read
    beside the counters of ``mods``, reset just before the run, and the
    copies between host and device are summed by kind (``memcpy``: ms and
    count).  The timed
    run records any launch its trace lacks (``profiler_dropped``); the
    shape-recording run must match the counters exactly, in one of up to
    three profiled steps.  A trace that starts with the step loses the
    step's first kernel records: traces of the composite step held
    7,894-7,895 records against 7,902, began at the stem's batch norm and
    lacked the stem's forward K11, which the counters (they count only
    launches that returned success) held.  So each profiled step follows a
    warm-up step that the profiler traces and discards (its ``schedule``),
    and ``profiler_notes`` locates the records of any short trace.  With
    ``warm`` False there is no warm-up step: for an ``fn`` that is a whole
    driver run, whose first kernel comes after its set-up."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def counted(record_shapes):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=record_shapes,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                     if warm else None) as prof:
            if warm:
                fn()  # the warm-up step
                torch.cuda.synchronize()
                prof.step()
            for m in mods:
                m.reset_launches()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
            if warm:
                prof.step()
        return prof, wall_ms, _launches(*mods)

    prof, wall_ms, counters = counted(False)
    kernels = _device_kernels(prof.key_averages())
    profiled, want = _profiled_counts(kernels, counters)
    dropped = {f: want[f] - n for f, n in profiled.items() if n != want[f]}
    notes = {"timed": _trace_note(prof)} if dropped else {}
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_ours = {o: sum(e.self_device_time_total for e in kernels
                      if _kernel_func(e.key) == o) / 1e3 for o in ours}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    for attempt in range(3):
        shapes, _, counters = counted(True)
        got, want = _profiled_counts(_device_kernels(shapes.key_averages()),
                                     counters)
        if got == want:
            break
        notes[f"shapes_{attempt}"] = {"got": got, **_trace_note(shapes)}
    check(got == want, f"shape-recording runs: profiled port-kernel "
                       f"launches {got} != the counters' {want} three times "
                       f"(timed run short {dropped}; {notes})")
    depthwise = [[e.name, e.input_shapes] for e in shapes.events()
                 if _depthwise_conv(e)]
    check(not depthwise, f"profile: grouped depthwise convolutions in "
                         f"PyTorch: {depthwise[:3]}")
    return {"wall_ms_profiled": wall_ms, "device_kernel_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "port_kernels_ms": by_ours,
            "port_kernels_share": (sum(by_ours.values()) / device_ms
                                   if device_ms else None),
            "kernel_launches": sum(e.count for e in kernels),
            "port_kernel_launches": {f: n for f, n in got.items() if n},
            "profiler_dropped": dropped, "profiler_notes": notes,
            "depthwise_conv_ops": len(depthwise),
            "memcpy": {e.key: [e.self_device_time_total / 1e3, e.count]
                       for e in kernels if e.key.startswith("Memcpy")},
            "top": [[e.key[:90], e.self_device_time_total / 1e3, e.count]
                    for e in top]}


def phase_fine_train(mods) -> dict:
    """Fine-stream training through the four long-cycle phases at full
    width on the card, then the eval step; ``mods`` are the kernel modules
    whose counters are read.  Returns the split route's kernel launches in
    the timed steps of phases A-C."""
    from coarse_fine_networks_torch.models import (FineNet, SubBatchNorm,
                                                   init_parameters)
    from coarse_fine_networks_torch.train import (LongCycleSchedule,
                                                  TrainState, bn_aggregated,
                                                  make_eval_step,
                                                  make_train_step,
                                                  model_batch)

    c = FINE
    t0 = time.perf_counter()
    model = init_parameters(
        FineNet("M", c["n_classes"], dropout_rate=c["dropout"],
                global_tower=False),
        torch.Generator().manual_seed(10)).cuda()
    sched = LongCycleSchedule(*c["base"])
    step = make_train_step(model, align_corners=True)
    state = TrainState.create(model)
    drop = torch.Generator(device="cuda").manual_seed(11)
    data = torch.Generator(device="cuda").manual_seed(12)
    bns = [m for m in model.modules() if isinstance(m, SubBatchNorm)]
    split_launches = {k: 0 for k in FINE_KERNELS}
    emit({"phase": "fine_train_setup", "model": "X3D-M",
          "n_classes": c["n_classes"], "params": sum(
              p.numel() for p in model.parameters()),
          "model_build_s": time.perf_counter() - t0})
    for epoch, (name, b, t, crop, tl, _) in enumerate(fine_phases()):
        splits = sched.transition(epoch, model)
        check(all(m.num_splits == splits and m.split_bn.running_mean.numel()
                  == splits * m.num_features for m in bns),
              f"phase {name}: split buffers not rebuilt to {splits}")
        batch = model_batch(_fine_host_batch(data, b, t, crop, tl,
                                             c["n_classes"]),
                            dtype=torch.bfloat16, device="cuda")
        losses = []
        for _ in range(c["warmup"]):
            state, m = step(state, batch, c["lr"], drop)
            losses.append(m["loss"].item())
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in mods:
            mod.reset_launches()
        step_ms = []
        for _ in range(c["steps"]):
            t1 = time.perf_counter()
            state, m = step(state, batch, c["lr"], drop)
            loss = m["loss"].item()  # waits for the step
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(loss)
        launches = _launches(*mods)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        after = model.state_dict()
        params = dict(model.named_parameters())
        moved = [k for k in params if not torch.equal(after[k], before[k])]
        nonfinite = [k for k, v in after.items()
                     if v.is_floating_point() and not torch.isfinite(v).all()]
        stuck = [k for k in after if "split_bn" in k
                 and torch.equal(after[k], before[k])]
        n = c["steps"]
        if splits > 1:
            per_step = {"dw_conv_s1": 44, "dw_conv_s2": 4, "dw_conv_dx_s2": 4,
                        "dw_conv_wgrad_s1": 22, "dw_conv_wgrad_s2": 4}
        else:
            per_step = {k: 22 if k.endswith("_s1") else 4
                        for k in ACT_KERNELS}
        per_step.update(STEM_TRAIN)
        want = {k: n * per_step.get(k, 0) for k in launches}
        mean_ms = sum(step_ms) / len(step_ms)
        emit({"phase": "fine_train", "long_cycle_phase": name, "B": b,
              "T": t, "input_hw": crop, "label_len": tl, "bn_splits": splits,
              "dtype": "bfloat16 activations, float32 parameters",
              "lr": c["lr"], "dropout": c["dropout"], "losses": losses,
              "step_ms": step_ms, "mean_step_ms": mean_ms,
              "clips_per_s": b / mean_ms * 1e3, "peak_mem_gb": peak_gb,
              "launches": {k: v for k, v in launches.items() if v},
              "params_moved": f"{len(moved)}/{len(params)}"})
        check(all(np.isfinite(losses)),
              f"phase {name}: losses not finite: {losses}")
        check(not nonfinite, f"phase {name}: non-finite parameters or "
                             f"statistics: {nonfinite[:5]}")
        check(len(moved) == len(params), f"phase {name}: parameters that "
              f"did not move: {[k for k in params if k not in moved][:5]}")
        check(not stuck, f"phase {name}: split statistics unchanged: "
                         f"{stuck[:5]}")
        check(launches == want, f"phase {name}: launches {launches} != "
                                f"{want}")
        if splits > 1:
            for k in FINE_KERNELS:
                split_launches[k] += launches[k]
        # phases A and D (the split route and the act route): the device
        # kernel time per step (B and C run A's kernels at other splits;
        # their profiles were cut for the script's time)
        ours = (("plain_fwd_kernel", "plain_wgrad_kernel",
                 "plain_s2_fwd_kernel", "plain_s2_dx_kernel",
                 "plain_s2_wgrad_kernel")
                if splits > 1 else ACT_FUNCS) + ("stencil_fwd_kernel",
                                                 "stencil_dk_kernel")

        def one_step():
            step(state, batch, c["lr"], drop)[1]["loss"].item()
        if name in FINE_PROFILED:
            emit({"phase": "fine_train_profile",
                  "what": f"one phase-{name} train step, B{b} T{t} "
                          f"{crop}² bf16, {splits} splits",
                  **_profile_step(one_step, ours, mods)})
        del batch
        torch.cuda.empty_cache()

    # the eval step on a phase-D batch with the aggregated statistics
    bn_aggregated(state)
    batch = model_batch(_fine_host_batch(data, b, t, crop, tl,
                                         c["n_classes"]),
                        dtype=torch.bfloat16, device="cuda")
    for mod in mods:
        mod.reset_launches()
    t1 = time.perf_counter()
    ev = make_eval_step(model, align_corners=True)(state, batch)
    loss = ev["loss"].item()
    eval_ms = (time.perf_counter() - t1) * 1e3
    launches = _launches(*mods)
    want = {k: (22 if k == "dw_mm_act_s1" else 4 if k == "dw_mm_act_s2"
                else 1 if k == "dw_stencil_s1" else 0) for k in launches}
    probs = ev["probs"]
    emit({"phase": "fine_eval", "B": b, "T": t, "input_hw": crop,
          "label_len": tl, "loss": loss, "eval_ms": eval_ms,
          "probs_shape": list(probs.shape),
          "launches": {k: v for k, v in launches.items() if v}})
    check(tuple(probs.shape) == (b, tl, c["n_classes"]),
          f"eval probs shape {tuple(probs.shape)}")
    check(bool(torch.isfinite(probs).all()) and np.isfinite(loss),
          "eval probabilities or loss not finite")
    check(launches == want, f"eval launches {launches} != {want}")
    return split_launches


def phase_fine_card_vs_cpu() -> None:
    """One small f32 fine train step with two batch-norm splits (X3D-M, 157
    classes, B=4, T=8, 64², label length 32, dropout 0) on the card and on
    the CPU from the same weights: the loss and every parameter's
    gradient."""
    from coarse_fine_networks_torch.models import (FineNet, init_parameters,
                                                   set_bn_splits)
    from coarse_fine_networks_torch.train import TrainState, make_train_step

    def build():
        return set_bn_splits(FineNet("M", 157, dropout_rate=0.0,
                                     global_tower=False), 2)
    cpu = init_parameters(build(), torch.Generator().manual_seed(13))
    gpu = build().cuda()
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(14)
    batch = {"clips": torch.rand((4, 8, 64, 64, 3), generator=gen),
             "labels": (torch.rand((4, 32, 157), generator=gen) > 0.9)
             .float(),
             "masks": torch.ones((4, 32))}
    out = {}
    for name, model in (("cpu", cpu), ("card", gpu)):
        step = make_train_step(model, align_corners=True)
        _, m = step(TrainState.create(model), batch, 0.01)
        out[name] = (m["loss"].item(),
                     {k: p.grad.detach().cpu() for k, p in
                      model.named_parameters()})
    (loss_ref, g_ref), (loss, g) = out["cpu"], out["card"]
    row = {"phase": "fine_card_vs_cpu", "dtype": "float32", "input_hw": 64,
           "B": 4, "T": 8, "bn_splits": 2, "loss_cpu": loss_ref,
           "loss_card": loss, "loss_rel_err": abs(loss - loss_ref) /
           abs(loss_ref)}
    _compare_grads(row, g_ref, g, ())
    # the loss: f32 sums in other orders
    check(abs(loss - loss_ref) <= 1e-4 * abs(loss_ref),
          f"fine train loss card {loss} vs CPU {loss_ref}")


def _timed(times: list, fn):
    """``fn`` with each call's ms (synchronised on the card) appended to
    ``times``."""
    def run(*args):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        return out
    return run


def _clip(rng: torch.Generator, t: int, hw: int):
    return torch.rand((t, hw, hw, 3), generator=rng).numpy()


def phase_serve(dw_mm_act, dw_act, dw_stencil, want: dict) -> dict:
    """``want``: the launches of each eval kernel the counted run must make;
    the train kernels must make none, and the stem's ``dw_stencil_s1`` two
    in the cold batch (the fine and the coarse tower) and one in the hit
    batch (the coarse tower)."""
    from coarse_fine_networks_torch.models import CoarseFinePipeline
    from coarse_fine_networks_torch.serve import (CachingVideoServer,
                                                  FeatureCache)

    t0 = time.perf_counter()
    pipe = CoarseFinePipeline(n_classes=157, version="M",
                              compute_dtype=torch.bfloat16, device="cuda",
                              generator=torch.Generator().manual_seed(0))
    build_s = time.perf_counter() - t0
    times = {"extract": [], "fuse": []}
    server = CachingVideoServer(
        _timed(times["extract"], pipe.extract), _timed(times["fuse"],
                                                       pipe.fuse),
        cache=FeatureCache(capacity_bytes=2 << 30), max_batch=3,
        max_wait_ms=2000, bucket_multiple=16, request_timeout_s=600,
        devices="cuda").start()
    rng = torch.Generator().manual_seed(1)
    videos = {"A": (64, 128), "B": (64, 128), "C": (50, 100)}
    clips = {v: _clip(rng, t, 224) for v, (t, _) in videos.items()}
    fine = {v: _clip(rng, tf, 224) for v, (_, tf) in videos.items()}
    try:
        # warm-up on other video ids: library handles, allocator, autotune
        for f in [server.submit(clips[v], fine[v], video_id="warm" + v)
                  for v in videos]:
            f.result(timeout=600)
        times["extract"].clear()
        times["fuse"].clear()
        torch.cuda.reset_peak_memory_stats()

        dw_mm_act.reset_launches()
        dw_act.reset_launches()
        dw_stencil.reset_launches()
        lat, cold, hit = {}, {}, {}
        t1 = time.perf_counter()
        futs = {v: server.submit(clips[v], fine[v], video_id=v)
                for v in videos}
        for v, f in futs.items():
            cold[v] = f.result(timeout=600)
            lat["cold_" + v] = (time.perf_counter() - t1) * 1e3
        stem = {"cold_batch": dict(dw_stencil.LAUNCHES)}
        t1 = time.perf_counter()
        futs = {v: server.submit(clips[v], video_id=v) for v in videos}
        for v, f in futs.items():
            hit[v] = f.result(timeout=600)
            lat["hit_" + v] = (time.perf_counter() - t1) * 1e3
        launches = dict(dw_mm_act.LAUNCHES)
        train_launches = dict(dw_act.LAUNCHES)
        stem["hit_batch"] = {k: v - stem["cold_batch"][k]
                             for k, v in dw_stencil.LAUNCHES.items()}
    finally:
        server.stop()

    for v, (t, _) in videos.items():
        for kind, out in (("cold", cold[v]), ("hit", hit[v])):
            check(out.shape == (4 * t, 157),
                  f"{kind} {v}: shape {out.shape} != {(4 * t, 157)}")
            check(bool(np.isfinite(out).all() and (out >= 0).all()
                       and (out <= 1).all()),
                  f"{kind} {v}: probabilities not finite or outside [0, 1]")
    hit_err = max(float(abs(hit[v] - cold[v]).max()) for v in videos)
    check(hit_err <= 1e-3, f"cache hit differs from cold result: {hit_err}")
    check(server.cache.hits == 3, f"cache hits {server.cache.hits} != 3")
    check(server.batch_sizes[-2:] == [3, 3],
          f"batches {server.batch_sizes}: cold and hit requests must each "
          "form one batch")
    # per extract or fuse call: 26 bottlenecks, 4 of them stride 2; the cold
    # batch runs extract + fuse, the hit batch fuse only
    check(launches == want, f"launches {launches} != {want}")
    check(not any(train_launches.values()),
          f"serving launched train kernels: {train_launches}")
    check(stem == {"cold_batch": {"dw_stencil_s1": 2, "dw_stencil_s2": 0,
                                  "dw_stencil_wgrad": 0},
                   "hit_batch": {"dw_stencil_s1": 1, "dw_stencil_s2": 0,
                                 "dw_stencil_wgrad": 0}},
          f"stem launches {stem}")
    emit({"phase": "serve", "model": "X3D-M", "n_classes": 157,
          "dtype": "bfloat16", "input_hw": 224,
          "videos": {v: {"T": t, "T_f": tf} for v, (t, tf) in videos.items()},
          "batch_sizes": server.batch_sizes, "latency_ms": lat,
          "extract_ms": times["extract"], "fuse_ms": times["fuse"],
          "launches": launches, "train_kernel_launches": train_launches,
          "stem_launches": stem,
          "hit_max_abs_diff": hit_err,
          "prob_range": [float(min(c.min() for c in cold.values())),
                         float(max(c.max() for c in cold.values()))],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "pipeline_build_s": build_s})
    return launches, pipe


def phase_profile(pipe, mods) -> None:
    """Device-time breakdown of one cold batch (extract + fuse, 3 videos at
    T=64/T_f=128, 224²) called directly, under ``torch.profiler``."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    fine = torch.rand((3, 128, 224, 224, 3), generator=gen, device="cuda")
    clips = torch.rand((3, 64, 224, 224, 3), generator=gen, device="cuda")
    mask = torch.ones((3, 128), device="cuda")
    meta = torch.tensor([[0, 64, 128, 1]] * 3, dtype=torch.int32,
                        device="cuda")

    def batch():
        with torch.inference_mode():
            feats = pipe.extract(fine)
            return pipe.fuse(clips, feats, mask, meta, 256)

    batch()
    torch.cuda.synchronize()
    emit({"phase": "profile", "what": "one cold batch, extract + fuse, "
                                      "3 videos T=64/T_f=128 224² bf16",
          **_profile_step(batch, ("mm_s2_fwd_kernel", "mm_fwd_s1_kernel",
                                  "stencil_fwd_kernel"),
                          mods)})


# the coarse-stream driver end to end: synthetic mini-Charades (8 training
# and 4 testing videos of 640 frames at 256², so the train clips are the
# train step's T = 64 at gamma_tau 5), extraction, 3 steps with a
# checkpoint every 3 and validation after each (one batch an epoch), then
# a resumed run to step 4
# the driver phase's last coarse checkpoint, kept for serve_http
DRIVER_COARSE_CKPT = SCRATCH / "driver_coarse.ckpt"
# the driver phase's row, which the packed phase prints beside its own
DRIVER_ROW: dict = {}
DRIVER = dict(videos=12, train=8, video_frames=640, hw=256, n_classes=157,
              frames=320, batch=8, workers=4, device_prefetch=2, steps=3,
              ckpt_every=3, resume_steps=4, val_batches=4)
# per driver train step on the act route: each act kernel 22 stride-1 and
# 4 stride-2 launches, the stem's K11 2 and its taps' gradient 1
DRIVER_STEP = {"act_fwd_s1_kernel": 22, "act_s2_fwd_kernel": 4,
               "act_dx_s1_kernel": 22, "act_s2_dx_kernel": 4,
               "act_wgrad_s1_kernel": 22, "act_s2_wgrad_kernel": 4,
               "stencil_fwd_kernel": 2, "stencil_dk_kernel": 1}


def phase_driver(mods, tree) -> dict:
    """The port's three entry points in sequence at full width on the card
    (X3D-M, 157 classes, bf16, a crop of 224): ``generate_mini_charades``,
    ``extract_driver.run`` over both splits with a seeded FineNet whose
    weights go through a reference-named ``.pt``, ``coarse_driver.run``
    (B8, T = 64, 4 loader workers, device prefetch 2, 3 steps, a checkpoint
    every 3, validation after each step's epoch with the localize CSV, the
    ``.pt`` as its Kinetics checkpoint), and a second run resumed at step 3
    to step 4.  The kernels' counters are reset before the extraction and
    before the coarse runs and read after each.  Then one driver step (a
    resumed run to step 4 without validation) under ``_profile_step``: its
    profiled launches must equal the counters, no grouped depthwise conv
    may run in PyTorch, and each act kernel must launch 22 (stride 1) or 4
    (stride 2) times, K11 twice and its taps' gradient once.  ``tree``: the
    future of the phase's synthetic tree (:func:`start_trees`).  Returns
    each kernel's launches over the extraction and the two runs."""
    import csv
    import dataclasses
    import statistics

    from coarse_fine_networks_torch.ckpt import (latest_checkpoint,
                                                 load_checkpoint)
    from coarse_fine_networks_torch.models import FineNet, init_parameters
    from coarse_fine_networks_torch.models.fine import FEAT_KEYS
    from coarse_fine_networks_torch.train import (DriverConfig,
                                                  coarse_driver,
                                                  extract_driver)

    c = DRIVER
    root = SCRATCH / "driver"
    pillow = _decode_with_pillow()
    pillow.__enter__()  # the baseline the packed phase is read against
    try:
        anno, gen_s = tree.result()
        fine_pt = str(root / "fine_seeded.pt")
        fine = init_parameters(FineNet("M", c["n_classes"], global_tower=True),
                               torch.Generator().manual_seed(3))
        torch.save({"model_state_dict": fine.state_dict()}, fine_pt)
        feats = str(root / "feats")
        cfg = DriverConfig(
            anno=anno, root=str(root / "frames"),
            save_dir=str(root / "models"), num_classes=c["n_classes"],
            frames=c["frames"], batch_size=c["batch"],
            compute_dtype="bfloat16", num_workers=c["workers"],
            device_prefetch=c["device_prefetch"], max_steps=c["steps"],
            ckpt_every=c["ckpt_every"], train_phases_per_val=1,
            max_val_batches=c["val_batches"],
            localize_csv=str(root / "localize.csv"), kinetics_ckpt=fine_pt,
            fine_feat_dir=feats, resume=False, record_trajectory=True,
            device="cuda")

        for m in mods:
            m.reset_launches()
        t1 = time.perf_counter()
        n_extracted = extract_driver.run(cfg, feats, fine_pt)
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t1
        extract_launches = _launches(*mods)
        nonfinite = [f"{k}/{v}" for k in FEAT_KEYS
                     for v in sorted(os.listdir(os.path.join(feats, k)))
                     if not np.isfinite(np.load(os.path.join(feats, k,
                                                             v))).all()]

        for m in mods:
            m.reset_launches()
        t2 = time.perf_counter()
        first = coarse_driver.run(cfg)
        saved = load_checkpoint(latest_checkpoint(cfg.save_dir,
                                                  coarse_driver.PREFIX))
        resumed = coarse_driver.run(dataclasses.replace(
            cfg, resume=True, max_steps=c["resume_steps"]))
        torch.cuda.synchronize()
        runs_s = time.perf_counter() - t2
        # the coarse checkpoint serve_http serves: the cli phase's two
        # coarse steps write none (ckpt_every is 1000, with no flag)
        shutil.copy(latest_checkpoint(cfg.save_dir, coarse_driver.PREFIX),
                    DRIVER_COARSE_CKPT)
        run_launches = _launches(*mods)
        with open(cfg.localize_csv) as f:
            rows = list(csv.reader(f))
        widths = sorted({len(r[2].split()) for r in rows})
        scores = np.array([[float(x) for x in r[2].split()] for r in rows])

        def one_step():
            # resumed in the saved epoch 2 (its batch taken): epoch 3 is
            # empty and epoch 4 runs step 4; four train phases a
            # validation put none in between
            coarse_driver.run(dataclasses.replace(
                cfg, resume=True, max_steps=saved["step"] + 1,
                train_phases_per_val=4, ckpt_every=10 ** 9,
                localize_csv=None))
        profiled = _profile_step(one_step, tuple(DRIVER_STEP) + (
            "mm_fwd_s1_kernel", "mm_s2_fwd_kernel"), mods, warm=False)
    finally:  # the tree stays for the cli phase; main removes SCRATCH
        pillow.__exit__(None, None, None)
        shutil.rmtree(root / "models", ignore_errors=True)
        shutil.rmtree(root / "feats", ignore_errors=True)

    traj = first["trajectory"] + resumed["trajectory"]
    losses = [x for *_, x in traj]
    step_ms = first["step_ms"] + resumed["step_ms"]
    wait_ms = first["prefetch_wait_ms"] + resumed["prefetch_wait_ms"]
    share = [w / s for w, s in zip(wait_ms, step_ms)]
    launches = {k: extract_launches[k] + run_launches[k]
                for k in run_launches}
    on_path = ACT_KERNELS + MM_KERNELS + ("dw_stencil_s1",
                                          "dw_stencil_wgrad")
    row = {"phase": "driver", "model": "X3D-M", "n_classes": c["n_classes"],
           "dtype": "bfloat16 activations, float32 parameters",
           "data": f"{c['videos']} synthetic videos ({c['train']} training)"
                   f" of {c['video_frames']} frames at {c['hw']}², JPEG, "
                   f"decoded by Pillow",
           "B": c["batch"], "crop": 224, "frames": c["frames"],
           "num_workers": c["workers"],
           "device_prefetch": c["device_prefetch"],
           "generate_s": gen_s, "extract_s": extract_s,
           "videos_extracted": n_extracted, "coarse_runs_s": runs_s,
           "steps": [s for s, _, _ in traj], "losses": losses,
           "step_ms": step_ms,
           "median_step_ms_after_2": statistics.median(step_ms[2:]),
           "prefetch_wait_ms": wait_ms, "prefetch_wait_share": share,
           "median_wait_share_after_2": statistics.median(share[2:]),
           "val_s": first["val_s"] + resumed["val_s"],
           "val_map": [first["val_map"], resumed["val_map"]],
           "resumed_from": resumed["resumed_from"],
           "saved": {"step": saved["step"], "epoch": saved["loader"]["epoch"],
                     "pos": saved["loader"]["pos"]},
           "csv_rows": len(rows), "csv_scores_per_row": widths,
           "extract_launches": {k: v for k, v in extract_launches.items()
                                if v},
           "run_launches": {k: v for k, v in run_launches.items() if v}}
    emit(row)
    DRIVER_ROW.update(row)
    emit({"phase": "driver_profile",
          "what": "one coarse_driver.run step (resumed at step 3, no "
                  "validation), B8 T64 224² bf16, act route", **profiled})
    check(n_extracted == c["videos"], f"driver: extracted {n_extracted}")
    check(not nonfinite, f"driver: non-finite features {nonfinite[:5]}")
    check(traj and all(np.isfinite(losses)),
          f"driver: losses not finite {losses}")
    check([s for s, _, _ in traj] == list(range(1, c["resume_steps"] + 1)),
          f"driver: steps {[s for s, _, _ in traj]}")
    check(all(np.isfinite(v) for v in row["val_map"]),
          f"driver: val_map {row['val_map']}")
    check(widths == [c["n_classes"]] and len(rows) == 25 * c["val_batches"]
          and np.isfinite(scores).all() and scores.min() >= 0
          and scores.max() <= 1,
          f"driver: csv rows {len(rows)}, widths {widths}")
    want_pos = {"step": c["steps"], "epoch": c["steps"] - 1, "pos": 1}
    check(row["saved"] == want_pos and row["resumed_from"] == want_pos,
          f"driver: saved {row['saved']}, resumed {row['resumed_from']}, "
          f"want {want_pos}")
    idle = [k for k in on_path if not launches[k]]
    check(not idle, f"driver: kernels of the path launched no time: {idle}")
    stray = {k: v for k, v in launches.items() if v and k not in on_path}
    check(not stray, f"driver: kernels off the path launched: {stray}")
    step_counts = {f: n for f, n in profiled["port_kernel_launches"].items()}
    check(step_counts == DRIVER_STEP,
          f"driver step launches {step_counts} != {DRIVER_STEP}")
    return launches


# launches a call, by the route the call takes (the wrappers' names): a
# train step by the act route or the split-bn route, and an eval call
ACT_STEP = {"dw_act_s1": 22, "dw_act_s2": 4, "dw_act_dx_s1": 22,
            "dw_act_dx_s2": 4, "dw_act_wgrad_s1": 22, "dw_act_wgrad_s2": 4,
            "dw_stencil_s1": 2, "dw_stencil_wgrad": 1}
SPLIT_STEP = {"dw_conv_s1": 44, "dw_conv_s2": 4, "dw_conv_dx_s2": 4,
              "dw_conv_wgrad_s1": 22, "dw_conv_wgrad_s2": 4,
              "dw_stencil_s1": 2, "dw_stencil_wgrad": 1}
EVAL_CALL = {"dw_mm_act_s1": 22, "dw_mm_act_s2": 4, "dw_stencil_s1": 1}
KINETICS = dict(videos=44, train=33, video_frames=96, hw=256,
                n_classes=400, workers=4, steps=2, epochs=2, b=32, t=16)
FINE_DRIVER = dict(videos=20, train=16, video_frames=640, hw=256,
                   n_classes=157, batch=2, workers=4, ckpt_every=5,
                   resume_at=5, epochs=4)
# the long cycle at base batch 2: (epoch, frames, crop, batch, splits)
FINE_DRIVER_PHASES = [(0, 80, 112, 16, 8), (1, 160, 144, 8, 4),
                      (2, 160, 224, 4, 2), (3, 320, 224, 2, 1)]
CLI = dict(workers=4, fine_steps=5, coarse_epochs=2, coarse_b=6)


def _generate(kind: str, root: str, kw: dict) -> tuple[str, float]:
    """One synthetic tree, in a worker process: its annotation path and the
    seconds the generation took."""
    from coarse_fine_networks_torch.data.kinetics import \
        generate_mini_kinetics
    from coarse_fine_networks_torch.data.synthetic import \
        generate_mini_charades

    t0 = time.perf_counter()
    if kind == "multithumos":
        return _multithumos_tree(root, kw), time.perf_counter() - t0
    fn = (generate_mini_kinetics if kind == "kinetics"
          else generate_mini_charades)
    return fn(root, **kw), time.perf_counter() - t0


def start_trees(pool) -> dict:
    """The driver, kinetics, fine_driver and packed phases' synthetic trees
    (seeded: the trees those phases would write themselves), each submitted
    to ``pool`` at once so that their JPEG encoding overlaps the kernel
    phases; name -> future of (annotation path, generation seconds)."""
    charades = {name: dict(num_videos=c["videos"],
                           num_frames=c["video_frames"], hw=c["hw"],
                           num_classes=c["n_classes"],
                           train_fraction=c["train"] / c["videos"])
                for name, c in (("driver", DRIVER),
                                ("fine_driver", FINE_DRIVER))}
    jobs = {"driver": ("charades", charades["driver"]),
            "kinetics": ("kinetics", dict(
                num_videos=KINETICS["videos"],
                num_frames=KINETICS["video_frames"], hw=KINETICS["hw"],
                num_classes=KINETICS["n_classes"])),
            "fine_driver": ("charades", charades["fine_driver"]),
            "packed": ("multithumos", dict(
                num_videos=PACKED["videos"],
                num_frames=PACKED["video_frames"], hw=PACKED["hw"],
                train_fraction=PACKED["train"] / PACKED["videos"]))}
    out = {}
    for name, (kind, kw) in jobs.items():
        shutil.rmtree(SCRATCH / name, ignore_errors=True)
        out[name] = pool.submit(_generate, kind, str(SCRATCH / name), kw)
    return out


def _splits(model) -> int:
    from coarse_fine_networks_torch.models import SubBatchNorm

    return next(m.num_splits for m in model.modules()
                if isinstance(m, SubBatchNorm))


@contextlib.contextmanager
def _per_call(module, factories: dict, mods, calls: list):
    """Wrap ``module``'s step factories (``{name: "train" | "eval"}``) so
    that every step they build appends to ``calls`` its kind, the model's
    batch-norm splits, the clips' shape, the kernels' launches (the
    counters' difference over the call) and, for a train step, its loss.
    The drivers' device prefetchers launch no port kernel, so the
    differences are the step's own."""
    saved = {n: getattr(module, n) for n in factories}

    def wrap(name, build):
        def built(*args, **kwargs):
            step = build(*args, **kwargs)

            def counted(state, batch, *rest, **kw):
                before = _launches(*mods)
                out = step(state, batch, *rest, **kw)
                after = _launches(*mods)
                rec = {"kind": factories[name],
                       "splits": _splits(state.model),
                       "shape": list(batch["clips"].shape),
                       "launches": {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}}
                if factories[name] == "train":
                    rec["loss"] = float(out[1]["loss"])
                calls.append(rec)
                return out
            return counted
        return built

    for n in factories:
        setattr(module, n, wrap(n, saved[n]))
    try:
        yield calls
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


def _want(call) -> dict:
    """The launches a recorded call must make: a train step by the split
    route when its model has more than one split, else by the act route;
    an eval call the eval entry's."""
    if call["kind"] == "eval":
        return EVAL_CALL
    return SPLIT_STEP if call["splits"] > 1 else ACT_STEP


def _check_calls(phase, calls, counters) -> dict:
    """Every call launched its route's kernels exactly, and the calls
    together what the counters read over the run (so nothing launched
    outside a step); returns the launches by kernel."""
    bad = [(i, c["kind"], c["splits"], c["shape"], c["launches"])
           for i, c in enumerate(calls) if c["launches"] != _want(c)]
    check(not bad, f"{phase}: calls off their route's launches: {bad[:3]}")
    total = {k: 0 for k in counters}
    for c in calls:
        for k, v in c["launches"].items():
            total[k] += v
    check(total == counters, f"{phase}: the calls' launches {total} != "
                             f"the counters' {counters}")
    return total


def _median_after(xs, n=2):
    import statistics

    return statistics.median(xs[n:]) if len(xs) > n else None


def _class_step_profile(mods) -> dict:
    """One Kinetics class train step at the CLI's shape (X3D-M, 400
    classes, B32 T16 224², bf16, dropout 0.5) under ``_profile_step``: the
    act kernels' times at this new entry shape."""
    from coarse_fine_networks_torch.models import FineNet, init_parameters
    from coarse_fine_networks_torch.train import TrainState
    from coarse_fine_networks_torch.train.kinetics_driver import \
        make_class_train_step

    c = KINETICS
    model = init_parameters(FineNet("M", c["n_classes"], task="class",
                                    global_tower=False),
                            torch.Generator().manual_seed(20)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(21)
    batch = {"clips": torch.rand((c["b"], c["t"], 224, 224, 3), generator=gen,
                                 device="cuda").to(torch.bfloat16),
             "labels": torch.randint(0, c["n_classes"], (c["b"],),
                                     generator=gen, device="cuda")}
    step = make_class_train_step(model, weight_decay=1e-5)
    state = TrainState.create(model)
    drop = torch.Generator(device="cuda").manual_seed(22)

    def one_step():
        step(state, batch, 0.1, drop)[1]["loss"].item()
    return _profile_step(one_step, ACT_FUNCS + ("stencil_fwd_kernel",
                                                "stencil_dk_kernel"), mods)


def phase_kinetics(mods, tree) -> tuple[dict, str]:
    """Kinetics-style pretraining as a user runs it:
    ``generate_mini_kinetics`` (44 videos of 96 frames at 256², 400
    classes: 33 training, 11 validation), then
    ``cli.pretrain_kinetics.main`` at the CLI's defaults (X3D-M, B32, T16,
    224², bf16, lr 0.1, 4 workers) for 2 steps in 2 epochs, each epoch
    validated (one B11 batch).  Every call's launches are recorded (the act
    route's 22/4 a step, K11 2, its dk 1; the eval entry's 22/4 and K11 1
    a validation batch) and held against the counters; then one class
    step at B32 T16 224² is profiled.  ``tree``: the future of the
    phase's synthetic tree (:func:`start_trees`).  Returns the run's
    launches and the final checkpoint, the fine phases' Kinetics
    checkpoint."""
    from coarse_fine_networks_torch.cli import pretrain_kinetics
    from coarse_fine_networks_torch.train import kinetics_driver

    c = KINETICS
    root = SCRATCH / "kinetics"
    anno, gen_s = tree.result()
    models = root / "models"
    for m in mods:
        m.reset_launches()
    t1 = time.perf_counter()
    with _per_call(kinetics_driver, {"make_class_train_step": "train",
                                     "make_class_eval_step": "eval"},
                   mods, []) as calls:
        res = pretrain_kinetics.main([
            "--root", str(root / "frames"), "--anno", anno, "--save-dir",
            str(models), "--max-steps", str(c["steps"]), "--max-epochs",
            str(c["epochs"]), "--num-workers", str(c["workers"])])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    counters = _launches(*mods)
    ckpt = models / f"kinetics_x3d_{c['steps']:06d}.ckpt"
    profiled = _class_step_profile(mods)
    train = [x for x in calls if x["kind"] == "train"]
    evals = [x for x in calls if x["kind"] == "eval"]
    share = [w / s for w, s in zip(res["prefetch_wait_ms"], res["step_ms"])]
    emit({"phase": "kinetics", "model": "X3D-M", "n_classes": c["n_classes"],
          "dtype": "bfloat16 activations, float32 parameters",
          "data": f"{c['videos']} synthetic videos ({c['train']} training) "
                  f"of {c['video_frames']} frames at {c['hw']}², JPEG, "
                  f"decoded natively (the host entropy decoder, "
                  f"idct_rgb_kernel, crop_resize_kernel)",
          "argv": "--max-steps 2 --max-epochs 2 --num-workers 4 (CLI "
                  "defaults: B32, frames 16, lr 0.1, bf16)",
          "generate_s": gen_s, "run_s": run_s,
          "losses": [x["loss"] for x in train],
          "train_shapes": [x["shape"] for x in train],
          "eval_shapes": [x["shape"] for x in evals],
          "train_loss": res.get("train_loss"),
          "val_top1": res.get("val_top1"), "step_ms": res["step_ms"],
          "prefetch_wait_ms": res["prefetch_wait_ms"],
          "prefetch_wait_share": share, "val_s": res["val_s"],
          "checkpoint": ckpt.name, "checkpoint_written": ckpt.is_file(),
          "launches": {k: v for k, v in counters.items() if v}})
    emit({"phase": "kinetics_profile",
          "what": "one class train step, B32 T16 224² bf16, 400 classes, "
                  "act route", **profiled})
    losses = [x["loss"] for x in train]
    check(len(train) == c["steps"] and all(np.isfinite(losses)),
          f"kinetics: train losses {losses}")
    check(all(x["shape"] == [c["b"], c["t"], 224, 224, 3] for x in train),
          f"kinetics: train shapes {[x['shape'] for x in train]}")
    check(len(evals) == c["epochs"] and np.isfinite(res["val_top1"]),
          f"kinetics: {len(evals)} eval calls, val_top1 "
          f"{res.get('val_top1')}")
    check(ckpt.is_file(), f"kinetics: no final checkpoint {ckpt}")
    launches = _check_calls("kinetics", calls, counters)
    step_counts = dict(profiled["port_kernel_launches"])
    check(step_counts == DRIVER_STEP,
          f"kinetics step launches {step_counts} != {DRIVER_STEP}")
    return launches, str(ckpt)


def phase_fine_driver(mods, kinetics_ckpt: str, tree) -> tuple[dict, str]:
    """``fine_driver.run`` under the long cycle at full width
    (``LongCycleSchedule(320, 224, 2)``: the recipe's widths and clip
    shapes, the base batch cut from 8 to 2, so phases A-D run B16 T16 112²,
    B8 T32 144², B4 T32 224² and B2 T64 224² with 8, 4, 2 and 1 splits),
    157 classes, bf16, lr 0.01, dropout 0.5, from the Kinetics checkpoint,
    4 workers, on ``generate_mini_charades`` (20 videos of 640 frames at
    256²: 16 training, 4 testing): one epoch a phase, 1 + 2 + 4 + 8 = 15
    steps and a validation (four B1 T64 calls), a checkpoint every 5 steps.
    Then a run resumed from the checkpoint at step 5 (inside phase C) to
    the cycle's end.  Every call's launches are recorded and held against
    its route (split-bn in A-C, act in D, the eval entry in validation) and
    the counters; the resumed run must start in the saved phase at the
    saved position.  ``tree``: the future of the phase's synthetic tree
    (:func:`start_trees`).  Returns the launches of both runs and the
    resumed run's last checkpoint."""
    import dataclasses

    from coarse_fine_networks_torch.ckpt import load_checkpoint
    from coarse_fine_networks_torch.train import DriverConfig, fine_driver

    c = FINE_DRIVER
    root = SCRATCH / "fine_driver"
    anno, gen_s = tree.result()
    cfg = DriverConfig(
        anno=anno, root=str(root / "frames"), save_dir=str(root / "models"),
        num_classes=c["n_classes"], batch_size=c["batch"],
        compute_dtype="bfloat16", num_workers=c["workers"], multigrid=True,
        max_epochs=c["epochs"], train_phases_per_val=4,
        ckpt_every=c["ckpt_every"], kinetics_ckpt=kinetics_ckpt,
        resume=False, record_trajectory=True, device="cuda")
    factories = {"make_train_step": "train", "make_eval_step": "eval"}
    runs, launches = {}, {}
    for name in ("first", "resumed"):
        if name == "resumed":
            saved_path = (root / "models" /
                          f"fine_charades_{c['resume_at']:06d}.ckpt")
            (root / "resumed").mkdir()
            shutil.copy(saved_path, root / "resumed")
            saved = load_checkpoint(str(saved_path))
            cfg = dataclasses.replace(cfg, save_dir=str(root / "resumed"),
                                      resume=True)
        for m in mods:
            m.reset_launches()
        t1 = time.perf_counter()
        with _per_call(fine_driver, factories, mods, []) as calls:
            res = fine_driver.run(cfg)
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t1
        res["calls"] = calls
        runs[name] = res
        got = _check_calls(f"fine_driver {name}", calls, _launches(*mods))
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    first, resumed = runs["first"], runs["resumed"]
    last_ckpt = root / "resumed" / f"fine_charades_{15:06d}.ckpt"

    def by_phase(res):
        """step ms and wait share of each long-cycle phase's steps."""
        out = {}
        train = [x for x in res["calls"] if x["kind"] == "train"]
        for x, ms, w in zip(train, res["step_ms"], res["prefetch_wait_ms"]):
            key = "BTHW " + "x".join(map(str, x["shape"][:3])) + \
                f" splits {x['splits']}"
            o = out.setdefault(key, {"step_ms": [], "wait_share": []})
            o["step_ms"].append(ms)
            o["wait_share"].append(w / ms)
        return out

    rows = {}
    for name, res in runs.items():
        train = [x for x in res["calls"] if x["kind"] == "train"]
        rows[name] = {
            "steps": [s for s, _, _ in res["trajectory"]],
            "losses": [x for *_, x in res["trajectory"]],
            "multigrid_phases": res["multigrid_phases"],
            "train_calls": [[x["shape"][:3], x["splits"]] for x in train],
            "eval_calls": sum(x["kind"] == "eval" for x in res["calls"]),
            "val_map": res.get("val_map"), "val_s": res["val_s"],
            "run_s": res["run_s"], "by_phase": by_phase(res),
            "median_step_ms_after_2": _median_after(res["step_ms"]),
            "median_wait_share_after_2": _median_after(
                [w / s for w, s in zip(res["prefetch_wait_ms"],
                                       res["step_ms"])])}
    saved_pos = {"step": saved["step"], "epoch": saved["loader"]["epoch"],
                 "pos": saved["loader"]["pos"]}
    emit({"phase": "fine_driver", "model": "X3D-M",
          "n_classes": c["n_classes"],
          "dtype": "bfloat16 activations, float32 parameters",
          "data": f"{c['videos']} synthetic videos ({c['train']} training) "
                  f"of {c['video_frames']} frames at {c['hw']}², JPEG, "
                  f"decoded natively (the host entropy decoder, "
                  f"idct_rgb_kernel, crop_resize_kernel)",
          "cut": "base batch 2 (the recipe's 8): phases at B16/B8/B4/B2",
          "generate_s": gen_s, "saved": saved_pos,
          "resumed_from": resumed.get("resumed_from"), **rows,
          "launches": {k: v for k, v in launches.items() if v}})
    check(first["multigrid_phases"] == FINE_DRIVER_PHASES,
          f"fine_driver: phases {first['multigrid_phases']}")
    check(rows["first"]["steps"] == list(range(1, 16)),
          f"fine_driver: steps {rows['first']['steps']}")
    want_pos = {"step": c["resume_at"], "epoch": 2, "pos": 2}
    check(saved_pos == want_pos and resumed.get("resumed_from") == want_pos,
          f"fine_driver: saved {saved_pos}, resumed "
          f"{resumed.get('resumed_from')}, want {want_pos}")
    check(resumed["multigrid_phases"] == FINE_DRIVER_PHASES[2:],
          f"fine_driver: resumed phases {resumed['multigrid_phases']}")
    check(rows["resumed"]["steps"] == list(range(c["resume_at"] + 1, 16)),
          f"fine_driver: resumed steps {rows['resumed']['steps']}")
    for name, row in rows.items():
        check(all(np.isfinite(row["losses"])) and row["eval_calls"] == 4
              and np.isfinite(row["val_map"]),
              f"fine_driver {name}: losses {row['losses']}, "
              f"{row['eval_calls']} eval calls, val_map {row['val_map']}")
    check(last_ckpt.is_file(), f"fine_driver: no checkpoint {last_ckpt}")
    return launches, str(last_ckpt)


def _coarse_step_profile(mods) -> dict:
    """One coarse train step at the coarse CLI's batch (X3D-M, 157 classes,
    B6 T64 224², bf16, banks at T_f 128, fusion ×10) under
    ``_profile_step``: the act kernels' times at this new entry shape."""
    from coarse_fine_networks_torch.models import CoarseNet, init_parameters
    from coarse_fine_networks_torch.train import TrainState, make_train_step

    c = TRAIN
    model = init_parameters(CoarseNet("M", c["n_classes"], dropout_rate=0.5),
                            torch.Generator().manual_seed(30)).cuda()
    batch = _train_batch("cuda", torch.Generator(device="cuda").manual_seed(
        31), CLI["coarse_b"], c["t"], c["hw"], c["tf"], c["tl"],
        c["n_classes"], torch.bfloat16)
    step = make_train_step(model, align_corners=False,
                           fusion_lr_mult=c["fusion_lr_mult"])
    state = TrainState.create(model)
    drop = torch.Generator(device="cuda").manual_seed(32)

    def one_step():
        step(state, batch, 0.02, drop)[1]["loss"].item()
    return _profile_step(one_step, ACT_FUNCS + ("stencil_fwd_kernel",
                                                "stencil_dk_kernel"), mods)


def _help_all() -> dict:
    """``python -m coarse_fine_networks_torch.cli.<name> --help`` for each
    command line, the processes started together; each one's exit code
    and whether it printed ``--device``."""
    names = ("pretrain_kinetics", "train_fine", "extract_fineFEAT",
             "train_coarse_fineFEAT")
    procs = {n: subprocess.Popen(
        [sys.executable, "-m", f"coarse_fine_networks_torch.cli.{n}",
         "--help"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for n in names}
    out = {}
    try:
        for n, p in procs.items():
            stdout, _ = p.communicate(timeout=120)
            out[n] = {"rc": p.returncode, "device_flag": "--device" in stdout}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def phase_cli(mods, kinetics_ckpt: str, fine_ckpt: str) -> dict:
    """A user's pipeline through the command lines' ``main(argv)`` at their
    defaults (X3D-M, 157 classes, bf16, 224²) on the driver phase's tree
    (12 videos, 8 training, 640 frames at 256²), giving only paths,
    ``--max-steps``, ``--max-epochs`` and ``--num-workers``:
    ``train_fine`` from the Kinetics phase's checkpoint (B8 T64: 4 steps, a
    validation, 1 step), ``extract_fineFEAT`` with the fine_driver phase's
    last checkpoint (12 videos), ``train_coarse_fineFEAT`` on those
    features (B6 T64: 2 steps, a validation of 4 videos with the localize
    CSV).  Each run's calls are held against their routes and the counters;
    then one coarse step at B6 is profiled, and each command line's
    ``--help`` runs as ``python -m``.  Returns the three runs' launches."""
    import csv

    from coarse_fine_networks_torch.cli import (extract_fineFEAT,
                                                train_coarse_fineFEAT,
                                                train_fine)
    from coarse_fine_networks_torch.models.fine import FEAT_KEYS
    from coarse_fine_networks_torch.train import coarse_driver, fine_driver

    c = CLI
    tree = SCRATCH / "driver"
    root = SCRATCH / "cli"
    shutil.rmtree(root, ignore_errors=True)
    common = ["--root", str(tree / "frames"), "--anno",
              str(tree / "annotations.json"), "--num-workers",
              str(c["workers"])]
    steps = {"train_fine": (fine_driver, {"make_train_step": "train",
                                          "make_eval_step": "eval"}),
             "train_coarse_fineFEAT": (coarse_driver, {
                 "make_train_step": "train", "make_eval_step": "eval"})}
    argv = {
        "train_fine": ["--save-dir", str(root / "fine"), "--kinetics-ckpt",
                       kinetics_ckpt, "--max-steps", str(c["fine_steps"])],
        "extract_fineFEAT": ["--save-feat-dir", str(root / "feats"),
                             "--fine-ckpt", fine_ckpt],
        "train_coarse_fineFEAT": [
            "--save-dir", str(root / "coarse"), "--fine-feat-dir",
            str(root / "feats"), "--localize-csv", str(root / "loc.csv"),
            "--max-epochs", str(c["coarse_epochs"])]}
    mains = {"train_fine": train_fine, "extract_fineFEAT": extract_fineFEAT,
             "train_coarse_fineFEAT": train_coarse_fineFEAT}
    rows, launches = {}, {}
    for name, argv_ in argv.items():
        for m in mods:
            m.reset_launches()
        t1 = time.perf_counter()
        calls: list = []
        if name in steps:
            with _per_call(*steps[name], mods, calls):
                res = mains[name].main(common + argv_)
        else:
            res = mains[name].main(common + argv_)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        counters = _launches(*mods)
        if name == "extract_fineFEAT":  # one tower call a video
            want = {k: res * EVAL_CALL.get(k, 0) for k in counters}
            check(counters == want, f"cli {name}: launches {counters} != "
                                    f"{want}")
            got = counters
            rows[name] = {"videos": res, "run_s": run_s}
        else:
            got = _check_calls(f"cli {name}", calls, counters)
            train = [x for x in calls if x["kind"] == "train"]
            rows[name] = {
                "losses": [x["loss"] for x in train],
                "train_shapes": [x["shape"] for x in train],
                "eval_shapes": [x["shape"] for x in calls
                                if x["kind"] == "eval"],
                "val_map": res.get("val_map"), "step_ms": res["step_ms"],
                "prefetch_wait_ms": res["prefetch_wait_ms"],
                "prefetch_wait_share": [w / s for w, s in zip(
                    res["prefetch_wait_ms"], res["step_ms"])],
                "val_s": res["val_s"], "run_s": run_s}
        rows[name]["launches"] = {k: v for k, v in got.items() if v}
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
    # the coarse command line again with --remat, on the same features:
    # every train step launches the bottlenecks' forward kernels twice
    for m in mods:
        m.reset_launches()
    calls = []
    t1 = time.perf_counter()
    with _per_call(*steps["train_coarse_fineFEAT"], mods, calls):
        res = train_coarse_fineFEAT.main(common + [
            "--save-dir", str(root / "coarse_remat"), "--fine-feat-dir",
            str(root / "feats"), "--localize-csv", str(root / "remat.csv"),
            "--max-epochs", str(c["coarse_epochs"]), "--remat"])
    torch.cuda.synchronize()
    counters = _launches(*mods)
    remat_step = _remat_step("act", True)
    bad = [(x["kind"], x["launches"]) for x in calls if x["launches"] != (
        remat_step if x["kind"] == "train" else EVAL_CALL)]
    total = {k: sum(x["launches"].get(k, 0) for x in calls) for k in counters}
    remat = [x for x in calls if x["kind"] == "train"]
    rows["train_coarse_fineFEAT --remat"] = {
        "losses": [x["loss"] for x in remat], "val_map": res.get("val_map"),
        "step_ms": res["step_ms"], "run_s": time.perf_counter() - t1,
        "launches": {k: v for k, v in total.items() if v}}
    check(not bad and total == counters,
          f"cli train_coarse_fineFEAT --remat: calls {bad[:3]}, the calls' "
          f"launches {total} against the counters' {counters}")
    check(len(remat) == c["coarse_epochs"]
          and all(np.isfinite([x["loss"] for x in remat])),
          f"cli train_coarse_fineFEAT --remat: losses "
          f"{[x['loss'] for x in remat]}")
    launches = {k: launches.get(k, 0) + v for k, v in total.items()}
    feats = root / "feats"
    nonfinite = [f"{k}/{v}" for k in FEAT_KEYS
                 for v in sorted(os.listdir(feats / k))
                 if not np.isfinite(np.load(feats / k / v)).all()]
    with open(root / "loc.csv") as f:
        csv_rows = list(csv.reader(f))
    widths = sorted({len(r[2].split()) for r in csv_rows})
    scores = np.array([[float(x) for x in r[2].split()] for r in csv_rows])
    profiled = _coarse_step_profile(mods)
    helps = _help_all()
    emit({"phase": "cli", "tree": "the driver phase's (12 videos, 8 "
                                  "training, 640 frames at 256²)",
          **rows, "csv_rows": len(csv_rows), "csv_scores_per_row": widths,
          "help": helps})
    emit({"phase": "cli_coarse_profile",
          "what": "one coarse train step, B6 T64 224² bf16, act route",
          **profiled})
    tf, co = rows["train_fine"], rows["train_coarse_fineFEAT"]
    check(len(tf["losses"]) == c["fine_steps"] and all(np.isfinite(
        tf["losses"])) and len(tf["eval_shapes"]) == 1
        and np.isfinite(tf["val_map"]),
        f"cli train_fine: losses {tf['losses']}, val_map {tf['val_map']}")
    check(all(s[:2] == [8, 64] for s in tf["train_shapes"]),
          f"cli train_fine: shapes {tf['train_shapes']}")
    check(rows["extract_fineFEAT"]["videos"] == 12 and not nonfinite,
          f"cli extract: {rows['extract_fineFEAT']['videos']} videos, "
          f"non-finite {nonfinite[:5]}")
    check(len(co["losses"]) == c["coarse_epochs"]
          and all(np.isfinite(co["losses"])) and np.isfinite(co["val_map"])
          and all(s[:2] == [c["coarse_b"], 64] for s in co["train_shapes"]),
          f"cli train_coarse_fineFEAT: losses {co['losses']}, shapes "
          f"{co['train_shapes']}, val_map {co['val_map']}")
    check(widths == [157] and len(csv_rows) == 4 * 25
          and np.isfinite(scores).all() and scores.min() >= 0
          and scores.max() <= 1,
          f"cli: csv rows {len(csv_rows)}, widths {widths}")
    check(all(h["rc"] == 0 and h["device_flag"] for h in helps.values()),
          f"cli --help: {helps}")
    step_counts = dict(profiled["port_kernel_launches"])
    check(step_counts == DRIVER_STEP,
          f"cli coarse B6 step launches {step_counts} != {DRIVER_STEP}")
    return launches


def serve_counts(shapes) -> dict:
    """The serving kernels' launches in one batch of a model with
    ``shapes``' entries: a cold batch runs extract and fuse (each tower's
    stride-1 and stride-2 entries, and its stem's K11 once), a hit fuse
    only; every other kernel of the port none."""
    s1, s2 = sum(n - 1 for *_, n in shapes), len(shapes)
    return {"cold": {"dw_mm_act_s1": 2 * s1, "dw_mm_act_s2": 2 * s2,
                     "dw_stencil_s1": 2},
            "hit": {"dw_mm_act_s1": s1, "dw_mm_act_s2": s2,
                    "dw_stencil_s1": 1}}


def phase_xl_stem(dw_stencil) -> dict:
    """K11 (``dw_stencil_s1``) at X3D-XL's stem (``conv1_t``, 5×1×1, C=32)
    on the serve towers' shapes (B3 at 112²: the fine tower's T_f=128, the
    coarse tower's T=64) against its plain version, f32 (TF32 off) and
    bf16, timed beside ``F.conv3d(groups=C)``; each bf16 time weighted by
    the tower's calls in a cold and a hit batch (fine 1, coarse 2)."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    agg = _agg()
    h = (TRAIN["hw"] - 1) // 2 + 1
    c = XL_STEM_C
    pad = [k // 2 for k in STEM_K]
    for dtype in (torch.float32, torch.bfloat16):
        for tower, (frames, calls) in TOWERS.items():
            shape = (SERVE_B, frames["layer1"], h, h, c)
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(STEM_K + (c,), generator=gen, device="cuda")
                 / math.prod(STEM_K) ** 0.5).to(dtype)
            w_conv = w.permute(3, 0, 1, 2).unsqueeze(1).contiguous()
            meta = {"entry": f"xl.serve.{tower}", "x": list(shape),
                    "taps": list(STEM_K), "strides": [1, 1, 1],
                    "plan": _plan_row_stencil(dw_stencil, shape, STEM_K,
                                              dtype)}
            _hold_time_library(
                "xl_kernels", "dw_stencil_s1", meta, dtype,
                lambda: dw_stencil.dw_stencil3d(x, w, (1, 1, 1)),
                lambda: dw_stencil.dw_stencil3d_plain(x, w, (1, 1, 1)),
                lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), w_conv,
                                 padding=pad, groups=c),
                "F.conv3d(groups=C), channels_last_3d",
                dw_stencil.fwd_work(x, x, w), calls, True, agg)
            del x
        torch.cuda.empty_cache()
    return agg


def phase_xl_kernels(dw_mm_act, dw_conv, dw_stencil) -> dict:
    """The three serving kernels at X3D-XL's entry shapes (``xl_kernels``):
    K1 ``mm`` and K4 ``mm`` at the 16 of a serve batch (B3 at 224²; 8 a
    tower: the fine tower at T_f=128, the coarse at T=64, then 17), K11
    at XL's stem, each against its plain version in f32 and bf16 and timed
    beside the plain version and the unfused sequence or the PyTorch call,
    with its bound.  The XL tables are checked against the port's."""
    from coarse_fine_networks_torch.models import x3d

    planes, blocks = x3d.get_inplanes("XL"), x3d.get_blocks("XL")
    want = [(layer, h, cin_s2, h // 2, out, mid, n) for layer, h, cin_s2,
            (mid, out), n in zip(("layer1", "layer2", "layer3", "layer4"),
                                 (112, 56, 28, 14),
                                 (planes[0][1],) + tuple(p[1] for p in
                                                         planes[:3]),
                                 planes, blocks)]
    check(XL_ENTRY_SHAPES == want and XL_STEM_C == planes[0][1],
          f"XL_ENTRY_SHAPES {XL_ENTRY_SHAPES} != the port's tables {want}")
    t0 = time.perf_counter()
    per_kernel = phase_kernels(dw_mm_act, dw_conv, XL_ENTRY_SHAPES,
                               "xl_kernels", eval_step=False)
    per_kernel["dw_stencil_s1"] = phase_xl_stem(dw_stencil)
    emit({"phase": "xl_kernels_done", "s": time.perf_counter() - t0})
    return per_kernel


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _http(port: int, path: str, body: bytes | None = None,
          timeout: float = 600) -> tuple[int, bytes, float]:
    """One request over loopback: status, body and ms from send to the
    last byte read (an HTTP error's status and body too)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body)
    t1 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, out = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, out = e.code, e.read()
    return code, out, (time.perf_counter() - t1) * 1e3


def _probs(code: int, body: bytes, what: str) -> np.ndarray:
    check(code == 200, f"{what}: HTTP {code} {body[:200]!r}")
    with np.load(io.BytesIO(body)) as z:
        return z["probs"]


def _json_get(port: int, path: str):
    code, body, _ = _http(port, path, timeout=30)
    return code, json.loads(body)


# the serve_http phase: the three videos of the serve phase (T, T_f) at
# 224², the prewarmed hits' coarse frames, the ladder's batching (all
# three requests of a batch in one), the front end's short timeout for the
# 504 check, and the tolerance of a served result against a direct call
# (bf16 on both: the serve phase's hit-against-cold bound)
SERVE_HTTP = dict(videos={"A": (64, 128), "B": (64, 128), "C": (50, 100)},
                  hw=224, hit_t=64, max_batch=3, max_wait_ms=2000.0,
                  result_timeout_s=2.0, tol=1e-3, canary_ids=200)


def _serve_cli(fine_ckpt: str) -> dict:
    """(a) ``python -m coarse_fine_networks_torch.cli.serve`` at its
    defaults (X3D-M, 157 classes, ``--max-batch 4``, a 1 GB cache) on the
    fine_driver phase's last checkpoint, the driver phase's last coarse
    checkpoint (``coarse_driver.run`` at B8 T64 224²; the cli phase's
    two coarse steps write none) and the cli phase's extraction bank
    (``--prewarm-dir``), ``--port 0``: three
    prewarmed hits (clips only), one cold video at T=64/T_f=128 224² and
    its repeat, each held against a direct call of the same assembled
    weights in this process (bf16); ``/v1/models``, ``/v1/stats`` (hits
    and misses as sent), ``/healthz``; SIGTERM, exit code 0."""
    import queue
    import signal
    import threading

    from coarse_fine_networks_torch.ckpt import load_checkpoint, load_strict
    from coarse_fine_networks_torch.cli.serve import \
        assemble_pipeline_variables
    from coarse_fine_networks_torch.models import CoarseFinePipeline
    from coarse_fine_networks_torch.serve import FeatureCache
    from coarse_fine_networks_torch.serve.scheduler import _bucket_up

    c = SERVE_HTTP
    coarse_ckpt = str(DRIVER_COARSE_CKPT)
    bank = SCRATCH / "cli" / "feats"
    check(DRIVER_COARSE_CKPT.is_file() and bank.is_dir(),
          f"serve_http: no driver artifacts ({coarse_ckpt}, {bank})")
    steps = {k: load_checkpoint(p)["step"] for k, p in
             (("fine", fine_ckpt), ("coarse", coarse_ckpt))}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "coarse_fine_networks_torch.cli.serve",
         "--fine-ckpt", fine_ckpt, "--coarse-ckpt", coarse_ckpt,
         "--prewarm-dir", str(bank), "--port", "0"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list = []
    q: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.append(line.rstrip())
            q.put(line)
        q.put(None)

    threading.Thread(target=pump, daemon=True).start()
    try:
        port = None
        while port is None:
            line = q.get(timeout=300)
            check(line is not None, f"serve CLI exited {proc.poll()}: "
                                    f"{lines[-20:]}")
            m = re.search(r"serving on :(\d+)", line)
            port = int(m.group(1)) if m else None
        ready_s = time.perf_counter() - t0

        # the direct calls' weights: the same assembly, in this process
        sd = assemble_pipeline_variables(None, fine_ckpt, coarse_ckpt)
        pipe = load_strict(CoarseFinePipeline(
            157, "M", compute_dtype=torch.bfloat16, device="cuda"), sd)
        rng = torch.Generator().manual_seed(7)
        t, hw = c["hit_t"], c["hw"]
        vids = sorted(f[:-4] for f in os.listdir(bank / "layer1"))
        lat, body_bytes, errs = {}, {}, {}
        for vid in vids[-3:]:  # the last admitted survive a full cache
            clips = _clip(rng, t, hw)
            body = _npz(clips=clips)
            code, out, ms = _http(port, f"/v1/score?video_id={vid}", body)
            got = _probs(code, out, f"serve CLI prewarmed {vid}")
            feats = {k: np.load(bank / k / f"{vid}.npy")
                     for k in FeatureCache.FEATURE_KEYS}
            tf = feats["layer1"].shape[0]
            tp, tfp = _bucket_up(t, 16), _bucket_up(tf, 16)
            fk = {k: torch.zeros((1, tfp) + v.shape[1:]) for k, v in
                  feats.items()}
            for k, v in feats.items():
                fk[k][0, :tf] = torch.from_numpy(v)
            cp = torch.zeros((1, tp, hw, hw, 3))
            cp[0, :t] = torch.from_numpy(clips)
            mask = torch.zeros((1, tfp))
            mask[0, :tf] = 1
            meta = torch.tensor([[0, t, tf, 1]], dtype=torch.int32)
            with torch.inference_mode():
                ref = pipe.fuse(cp.cuda(), fk, mask.cuda(), meta.cuda(),
                                4 * tp)[0, :4 * t].float().cpu().numpy()
            errs[f"prewarmed_{vid}"] = float(np.abs(got - ref).max())
            lat[f"prewarmed_{vid}"] = ms
            body_bytes["prewarmed"] = len(body)
        t_c, tf_c = c["videos"]["A"]
        clips, fine = _clip(rng, t_c, hw), _clip(rng, tf_c, hw)
        body = _npz(clips=clips, fine_clips=fine)
        code, out, lat["cold"] = _http(port, "/v1/score?video_id=new", body)
        cold = _probs(code, out, "serve CLI cold")
        body_bytes["cold"] = len(body)
        body = _npz(clips=clips)
        code, out, lat["hit"] = _http(port, "/v1/score?video_id=new", body)
        hit = _probs(code, out, "serve CLI repeat")
        body_bytes["hit"] = len(body)
        body_bytes["response"] = len(out)
        with torch.inference_mode():
            ref = pipe(torch.from_numpy(clips)[None].cuda(),
                       torch.from_numpy(fine)[None].cuda(),
                       torch.tensor([[0, t_c, tf_c, 1]], dtype=torch.int32,
                                    device="cuda"), 4 * t_c,
                       fine_mask=torch.ones((1, tf_c), device="cuda"))
        ref = ref[0].float().cpu().numpy()
        errs["cold"] = float(np.abs(cold - ref).max())
        errs["hit"] = float(np.abs(hit - ref).max())
        models = _json_get(port, "/v1/models")
        stats = _json_get(port, "/v1/stats")
        health = _json_get(port, "/healthz")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    del pipe
    torch.cuda.empty_cache()
    st = stats[1].get("coarse_fine", {})
    row = {"phase": "serve_http_cli", "fine_ckpt": fine_ckpt,
           "coarse_ckpt": coarse_ckpt, "ckpt_steps": steps,
           "bank_videos": len(vids),
           "ready_s": ready_s, "latency_ms": lat, "body_bytes": body_bytes,
           "max_abs_err_vs_direct": errs, "tol": c["tol"],
           "models": models, "stats": stats[1], "healthz": health,
           "exit_code": rc, "output": [x for x in lines
                                       if x.startswith(("prewarmed",
                                                        "serving"))]}
    emit(row)
    check(all(e <= c["tol"] for e in errs.values()),
          f"serve CLI: results differ from direct calls: {errs}")
    check(cold.shape == (4 * t_c, 157) and np.isfinite(cold).all(),
          f"serve CLI cold: {cold.shape}")
    check(models == (200, {"models": ["coarse_fine"]}),
          f"serve CLI /v1/models: {models}")
    check(stats[0] == 200 and st.get("cache_hits") == 4
          and st.get("cache_misses") == 1,
          f"serve CLI /v1/stats: {stats}: 4 hits and 1 miss were sent")
    check(health == (200, {"status": "ok"}), f"serve CLI /healthz {health}")
    check(rc == 0, f"serve CLI exit code {rc} on SIGTERM: {lines[-20:]}")
    return row


def _ladder(mods) -> dict:
    """(b) The S/M/XL ladder in this process: ``cli.serve.build_server``
    with X3D-M (157 classes, seeded) as ``coarse_fine`` and X3D-XL (seeded)
    registered beside it as ``cfn-xl``, bf16 at 224², batches of three;
    cold and hit batches of the three videos to each variant over HTTP in
    turn, each batch's launches held to :func:`serve_counts`; an alias, and
    a canary of 0.5 keyed on ``video_id`` (its assignment of 200 ids
    against ``_split_key``'s, and three routed hits against the variant's
    earlier result); one request of each error: 404, 400, 429, 504, and
    503 on ``/healthz`` while draining.  Returns the counted launches by
    variant."""
    from concurrent.futures import ThreadPoolExecutor

    from coarse_fine_networks_torch.cli.serve import (build_server,
                                                      caching_server)
    from coarse_fine_networks_torch.models import CoarseFinePipeline
    from coarse_fine_networks_torch.serve import InferenceHTTPServer
    from coarse_fine_networks_torch.serve.router import _split_key

    c = SERVE_HTTP
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = CoarseFinePipeline(157, "M", device="cpu", generator=torch.Generator(
        ).manual_seed(0)).state_dict()
    srv = build_server(sd, "M", 157, 0, 2 << 30, c["max_batch"],
                       c["max_wait_ms"], 16, 600.0)
    router = srv.router
    xl = CoarseFinePipeline(157, "XL", compute_dtype=torch.bfloat16,
                            device="cuda",
                            generator=torch.Generator().manual_seed(1))
    router.register("cfn-xl", caching_server(
        xl, 2 << 30, c["max_batch"], c["max_wait_ms"], 16, 600.0))
    names = {"X3D-M": "coarse_fine", "X3D-XL": "cfn-xl"}
    times = {}
    for model, name in names.items():
        s = router._servers[name]
        times[model] = {"extract": [], "fuse": []}
        s._extract = [_timed(times[model]["extract"], f) for f in s._extract]
        s._fuse = [_timed(times[model]["fuse"], f) for f in s._fuse]
    build_s = time.perf_counter() - t0
    srv.start()
    port = srv.port
    rng = torch.Generator().manual_seed(8)
    vids = c["videos"]
    clips = {v: _clip(rng, t, c["hw"]) for v, (t, _) in vids.items()}
    fine = {v: _clip(rng, tf, c["hw"]) for v, (_, tf) in vids.items()}
    cold_body = {v: _npz(clips=clips[v], fine_clips=fine[v]) for v in vids}
    hit_body = {v: _npz(clips=clips[v]) for v in vids}
    pool = ThreadPoolExecutor(max_workers=len(vids))

    def batch(name, bodies, prefix=""):
        futs = {v: pool.submit(_http, port, f"/v1/score?model={name}&"
                                            f"video_id={prefix}{v}", b)
                for v, b in bodies.items()}
        out = {}
        for v, f in futs.items():
            code, body, ms = f.result()
            out[v] = (_probs(code, body, f"{name} {prefix}{v}"), ms)
        return out

    shapes = {"X3D-M": ENTRY_SHAPES, "X3D-XL": XL_ENTRY_SHAPES}
    counted, results, lat, rows = {}, {}, {}, {}
    try:
        for model, name in names.items():
            batch(name, cold_body, "warm")  # handles, allocator, autotune
            for k in ("extract", "fuse"):
                times[model][k].clear()
            want = serve_counts(shapes[model])
            got = {}
            for kind, bodies in (("cold", cold_body), ("hit", hit_body)):
                for m in mods:
                    m.reset_launches()
                res = batch(name, bodies)
                got[kind] = {k: v for k, v in _launches(*mods).items() if v}
                results[(model, kind)] = {v: r[0] for v, r in res.items()}
                lat[f"{model}.{kind}"] = {v: r[1] for v, r in res.items()}
            counted[model] = got
            sizes = router._servers[name].batch_sizes
            rows[model] = {"batch_sizes": sizes,
                           "extract_ms": list(times[model]["extract"]),
                           "fuse_ms": list(times[model]["fuse"])}
            check(got == want, f"serve_http {model} launches {got} != "
                               f"{want}")
            check(sizes[-2:] == [3, 3], f"serve_http {model}: batches "
                                        f"{sizes}, not one of three each")
            for v, (t, _) in vids.items():
                for kind in ("cold", "hit"):
                    out = results[(model, kind)][v]
                    check(out.shape == (4 * t, 157) and bool(
                        np.isfinite(out).all() and (out >= 0).all()
                        and (out <= 1).all()),
                          f"serve_http {model} {kind} {v}: {out.shape}")
            hit_err = max(float(np.abs(results[(model, "hit")][v]
                                       - results[(model, "cold")][v]).max())
                          for v in vids)
            rows[model]["hit_max_abs_diff"] = hit_err
            check(hit_err <= c["tol"], f"serve_http {model}: hit differs "
                                       f"from cold by {hit_err}")
        stats = _json_get(port, "/v1/stats")[1]

        # alias and canary: the assignment, then hits routed through both
        router.alias("prod", "coarse_fine")
        router.canary("coarse_fine", "cfn-xl", 0.5)
        ids = [f"vid{i:03d}" for i in range(c["canary_ids"])]
        lands = [router.resolve("prod", video_id=v) for v in ids]
        split = ["cfn-xl" if _split_key(v, 0) < 0.5 else "coarse_fine"
                 for v in ids]
        routed = {}
        for v in vids:
            name = router.resolve("prod", video_id=v)
            model = next(m for m, n in names.items() if n == name)
            code, body, _ = _http(port, f"/v1/score?model=prod&video_id={v}",
                                  hit_body[v])
            got = _probs(code, body, f"prod {v}")
            routed[v] = {"variant": name, "max_abs_diff": float(np.abs(
                got - results[(model, "hit")][v]).max())}

        # errors: unknown model, malformed body, then a variant that holds
        # its batch open behind a front end with a short timeout
        codes = {"404": _http(port, "/v1/score?model=ghost",
                              hit_body["A"])[0],
                 "400": _http(port, "/v1/score", b"not-an-npz")[0]}
        held = caching_server(xl, 1 << 20, 4, 600_000.0, 1, None)
        router.register("held", held)
        short = InferenceHTTPServer(router, port=0, result_timeout_s=c[
            "result_timeout_s"]).start()
        small = _npz(clips=_clip(rng, 8, 64), fine_clips=_clip(rng, 16, 64))
        try:
            first = pool.submit(_http, short.port,
                                "/v1/score?model=held&video_id=h1", small)
            deadline = time.monotonic() + 60
            while (router.stats()["held"]["pending"] == 0
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            codes["429"] = _http(short.port,
                                 "/v1/score?model=held&video_id=h2",
                                 small)[0]
            codes["504"] = first.result(timeout=120)[0]
            router.stop()
            codes["503"] = _http(port, "/healthz", timeout=30)[0]
        finally:
            short.stop()
    finally:
        srv.stop()
        pool.shutdown()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del xl
    torch.cuda.empty_cache()
    row = {"phase": "serve_http_ladder", "dtype": "bfloat16",
           "input_hw": c["hw"],
           "videos": {v: {"T": t, "T_f": tf} for v, (t, tf) in vids.items()},
           "build_s": build_s, "variants": rows, "latency_ms": lat,
           "launches": counted,
           "body_bytes": {v: [len(cold_body[v]), len(hit_body[v])]
                          for v in vids},
           "stats": stats, "canary_to_xl": lands.count("cfn-xl"),
           "routed": routed, "error_codes": codes, "peak_mem_gb": peak}
    emit(row)
    check(lands == split, "serve_http: the canary's assignment differs "
                          "from _split_key's")
    check(all(r["max_abs_diff"] <= c["tol"] for r in routed.values()),
          f"serve_http: routed hits differ from their variant's: {routed}")
    check(codes == {"404": 404, "400": 400, "429": 429, "504": 504,
                    "503": 503}, f"serve_http error codes {codes}")
    for model, name in names.items():
        check(stats[name]["cache_hits"] == 3
              and stats[name]["cache_misses"] == 6,
              f"serve_http {model} stats {stats[name]}: 3 hits, 6 misses "
              "(warm-up and cold) were sent")
    return counted


def _xl_entry(agg: dict, launches: int) -> dict:
    """A serving kernel's X3D-XL numbers for the kernels line: bf16 sums
    over XL's serve shapes, each weighted by its launches in a cold and a
    hit batch (``xl_kernels``), and its launches in the ladder."""
    return {"launches": launches, "timed_launches": agg["launches"],
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"],
            "bound_by": ("bytes" if agg["bytes_ms"] >= agg["ops_ms"]
                         else "operations"),
            **({"unfused_ms": agg["unfused_ms"]} if agg["unfused_ms"]
               else {"library_ms": agg.get("library_ms")}),
            "max_abs_err": agg["max_abs_err"],
            "max_abs_err_f32": agg["max_abs_err_f32"],
            "timed_at": "bf16 at X3D-XL's serve shapes (B=3, 224²; fine "
                        "T_f=128; coarse T=64, then T=17 after Grid Pool; "
                        "the stem's conv1_t at C=32), weighted by launches "
                        "in one cold and one hit batch"}


def phase_serve_http(mods, fine_ckpt: str) -> tuple[dict, dict]:
    """(a) the serving CLI as users run it, then (b) the ladder in this
    process (:func:`_serve_cli`, :func:`_ladder`).  Returns the launches of
    the ladder's counted batches: summed, and X3D-XL's."""
    t0 = time.perf_counter()
    _serve_cli(fine_ckpt)
    counted = _ladder(mods)
    total = {}
    for got in counted.values():
        for kind in got.values():
            for k, v in kind.items():
                total[k] = total.get(k, 0) + v
    xl = {}
    for kind in counted["X3D-XL"].values():
        for k, v in kind.items():
            xl[k] = xl.get(k, 0) + v
    emit({"phase": "serve_http_done", "s": time.perf_counter() - t0})
    return total, xl


def phase_card_vs_cpu() -> None:
    from coarse_fine_networks_torch.models import CoarseFinePipeline

    cpu = CoarseFinePipeline(n_classes=157, device="cpu",
                             generator=torch.Generator().manual_seed(2))
    gpu = CoarseFinePipeline(n_classes=157, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = torch.Generator().manual_seed(3)
    t, tf, hw = 16, 32, 64
    clips = torch.rand((1, t, hw, hw, 3), generator=rng)
    fine = torch.rand((1, tf, hw, hw, 3), generator=rng)
    meta = torch.tensor([[0, t, tf - 4, 1]], dtype=torch.int32)
    mask = torch.ones((1, tf))
    mask[:, tf - 4:] = 0
    with torch.inference_mode():
        ref = cpu(clips, fine, meta, 4 * t, fine_mask=mask)
        got = gpu(clips.cuda(), fine.cuda(), meta.cuda(), 4 * t,
                  fine_mask=mask.cuda()).cpu()
        banks_ref = cpu.extract(fine)
        banks_gpu = gpu.extract(fine.cuda())
        banks = {k: v.cpu() for k, v in banks_gpu.items()}
        # the coarse stream's logits before the sigmoid: with random
        # weights the probabilities sit near 0.5 and carry little signal
        logits_ref = cpu.coarse(clips, banks_ref, mask, meta)
        logits = gpu.coarse(clips.cuda(), banks_gpu, mask.cuda(),
                            meta.cuda()).cpu()
    # f32 on both, TF32 off: summation order only.  Probabilities to 1e-4;
    # the feature banks and the coarse logits to 1e-4 of their largest
    # magnitude
    err = (got - ref).abs().max().item()
    tol = rel_tol = 1e-4

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    bank_err = {k: rel(banks[k], v) for k, v in banks_ref.items()}
    logit_err = rel(logits, logits_ref)
    emit({"phase": "card_vs_cpu", "dtype": "float32", "input_hw": hw,
          "T": t, "T_f": tf, "max_abs_err": err, "tol": tol,
          "bank_max_rel_err": bank_err, "logit_max_rel_err": logit_err,
          "rel_tol": rel_tol, "logit_absmax": logits_ref.abs().max().item(),
          "prob_std": ref.std().item()})
    check(max(bank_err.values()) <= rel_tol,
          f"card vs CPU feature banks differ: {bank_err}")
    check(logit_err <= rel_tol,
          f"card vs CPU coarse logits differ: {logit_err} > {rel_tol}")
    check(err <= tol, f"card vs CPU max abs err {err} > {tol}")


# ---- stride (2, 2, 2): FineNet's t_downsample ---------------------------------

T2_KERNELS = ("dw_conv_t2", "dw_conv_dx_t2", "dw_conv_wgrad_t2")
# x at conv2 of each stage's block 0 under t_downsample (C_mid wide): FineNet
# at B32 T16 224² (the Kinetics class step's shape; counted) and B64 T16
# 112² (long-cycle phase A's), and ragged sizes (odd T, H, W and C; the
# last two in the forward's whole-pixel and the dx's tile mode, with ragged
# strips and columns and runs that start off a 16-byte boundary)
T2_SHAPES = {
    "B32.224": [(32, 16, 112, 112, 54), (32, 8, 56, 56, 108),
                (32, 4, 28, 28, 216), (32, 2, 14, 14, 432)],
    "B64.112": [(64, 16, 56, 56, 54), (64, 8, 28, 28, 108),
                (64, 4, 14, 14, 216), (64, 2, 7, 7, 432)],
    "ragged": [(3, 9, 13, 11, 30), (2, 5, 9, 7, 7), (4, 7, 15, 9, 54),
               (3, 9, 30, 28, 54), (2, 7, 27, 23, 56)],
}
# the t_downsample step's launches: the four strided blocks take the t2
# kernels (the eval step too), the rest their route's
T2_STEP = {"dw_conv_t2": 4, "dw_conv_dx_t2": 4, "dw_conv_wgrad_t2": 4,
           "dw_stencil_s1": 2, "dw_stencil_wgrad": 1}
T2_ACT_STEP = {"dw_act_s1": 22, "dw_act_dx_s1": 22, "dw_act_wgrad_s1": 22,
               **T2_STEP}
T2_SPLIT_STEP = {"dw_conv_s1": 44, "dw_conv_wgrad_s1": 22, **T2_STEP}
T2_EVAL_CALL = {"dw_mm_act_s1": 22, "dw_conv_t2": 4, "dw_stencil_s1": 1}


def _ptxas_of(func: str, dtype, r: int, mode=None) -> dict:
    """Registers and spills of ``func``'s instantiation for ``dtype``, ``r``
    rows and, for the t2 forward and dx, ``mode`` (whole pixels, tile), from
    the ptxas rows (mangled ``<float, R>`` as ``IfLiRE``, ``<__nv_bfloat16,
    R>`` as ``I13__nv_bfloat16LiRE``, a bool as ``Lb0E`` or ``Lb1E``)."""
    t = "If" if dtype == torch.float32 else "I13__nv_bfloat16"
    b = "" if mode is None else f"Lb{int(mode)}E"
    rows = [v for n, v in PTXAS_ROWS.get("dw_conv_s2", {}).items()
            if func in n and f"{t}Li{r}E{b}" in n]
    check(len(rows) == 1, f"ptxas row of {func} {dtype} R={r}: {len(rows)}")
    return {k: rows[0].get(k) for k in ("registers", "spill_stores",
                                        "spill_loads")}


# how each t2 kernel stages x or writes dx in its whole-pixel mode and
# else, by the mode its wrapper launches it in (dw_conv.t2_whole)
T2_STAGING = {"dw_conv_t2": ("whole_bulk", "pairs"),
              "dw_conv_dx_t2": ("tile_bulk", "direct"),
              "dw_conv_wgrad_t2": ("whole_cp16", "pairs")}


def _plan_row_t2(dw_conv, name, shape, dtype, rows_of) -> dict:
    """The work split of t2 kernel ``name`` at x ``shape`` (dx: dx's shape)
    over the output's (g's) frames, rows and columns: its blocks (one per
    tile; the weight gradient's persistent grid and its g frames a block),
    shared memory, blocks per SM, waves, how it stages x or writes dx
    (``staging``, :data:`T2_STAGING`: the mode its wrapper chooses for
    ``rows_of``, the x it reads or a dx it wrote) and the instantiation's
    ptxas row."""
    kind, plan, smem, func = {
        "dw_conv_t2": (6, dw_conv.plan_t2_fwd, dw_conv.smem_t2_fwd,
                       "plain_t2_fwd_kernel"),
        "dw_conv_dx_t2": (7, dw_conv.plan_t2_dx, dw_conv.smem_t2_dx,
                          "plain_t2_dx_kernel"),
        "dw_conv_wgrad_t2": (8, dw_conv.plan_t2, dw_conv.smem_t2,
                             "plain_t2_wgrad_kernel"),
    }[name]
    p = plan(*shape)
    esz, bf16 = torch.finfo(dtype).bits // 8, int(dtype == torch.bfloat16)
    occ = dw_conv.LIBRARY_S2.build().dw_plain_s2_occupancy(kind, p.r, p.wb,
                                                           p.pg, bf16)
    check(occ > 0, f"{name} plan {shape} {dtype}: does not fit ({occ})")
    wgrad = kind == 8
    blocks = (p.rows if wgrad else p.items) * p.n_pg
    whole = dw_conv.t2_whole(p, rows_of)
    staging = T2_STAGING[name][0 if whole else 1]
    return {"r": p.r, "wb": p.wb, "pg": p.pg, "tt": p.tt,
            **({"ipb": p.ipb, "rows": p.rows,
                "steps_per_block": p.ipb * p.tt} if wgrad else {}),
            "threads": p.threads, "blocks": blocks, "smem": smem(p, esz),
            "blocks_per_sm": occ, "waves": _waves(blocks, occ),
            "staging": staging, "ptxas": _ptxas_of(
                func, dtype, p.r, None if wgrad else whole)}


def _k10_on_t2_plan(dw_conv, x, up):
    """K10 plain (``dw_conv_wgrad_s2``'s kernel) on ``up`` (g at the even
    frames of a zero tensor of x's T frames) launched with ``plan_t2``'s
    split and one segment of all T frames: ``dw_conv_wgrad_t2``'s items and
    blocks, so the two sum each tap in one order."""
    b, t, h, w, c = x.shape
    p = dw_conv.plan_t2(b, t, h, w, c)
    part = torch.empty((p.rows, 27, c), dtype=torch.float32, device="cuda")
    dw_conv.LIBRARY_S2.call(
        "dw_conv_wgrad_s2", x.data_ptr(), up.data_ptr(), part.data_ptr(), b,
        t, h, w, c, p.r, p.wb, p.pg, t, p.ipb, p.rows,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    return torch.sum(part, dim=0)


def phase_t2_kernels(dw_conv) -> dict:
    """The three stride-(2, 2, 2) kernels against their plain versions at
    the four ``t_downsample`` entries of ``FineNet`` at B32 T16 224² and at
    B64 T16 112² and at ragged sizes, f32 (TF32 off) and bf16, timed beside
    the plain version and the one PyTorch call that computes the same
    function (``F.conv3d(groups=C, stride=2)``, ``aten.convolution_backward``
    for dx and the weight gradient), each row with its work split, blocks
    per SM, waves, registers and spills.  Each also equals its stride-(1, 2,
    2) kernel with a difference of 0: ``dw_conv_t2`` K4 plain's output frames
    0, 2, 4, ..., ``dw_conv_dx_t2`` K8 on g at the even frames of a zero
    tensor of T frames, ``dw_conv_wgrad_t2`` K10 plain on that g launched
    with ``plan_t2``'s items (``_k10_on_t2_plan``) and itself run again.
    Each kernel's device time a call (``queued_ms``: no host time in it) is
    a line of its own beside each row.  The B32 rows, one launch each a
    step, make each kernel's line entry (its bf16 device sum beside the
    call sum).  Then NaN and the edges (:func:`_t2_nan_edges`)."""
    from coarse_fine_networks_torch.ops.dw_conv import T2

    gen = torch.Generator(device="cuda").manual_seed(23)
    per_kernel = {k: {**_agg(), "device_ms": 0.0} for k in T2_KERNELS}
    ncdhw = (0, 4, 1, 2, 3)
    for dtype in (torch.float32, torch.bfloat16):
        for group, shapes in T2_SHAPES.items():
            for b, t, h, w, c in shapes:
                to, ho, wo = (t - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1
                x = torch.randn((b, t, h, w, c), generator=gen,
                                device="cuda").relu().to(dtype)
                k = (torch.randn((3, 3, 3, c), generator=gen, device="cuda")
                     / 27 ** 0.5).to(dtype)
                g = torch.randn((b, to, ho, wo, c), generator=gen,
                                device="cuda").to(dtype)
                # g at the even frames of a zero tensor of t frames
                up = torch.zeros((b, t, ho, wo, c), dtype=dtype,
                                 device="cuda")
                up[:, ::2] = g
                w_conv = k.permute(3, 0, 1, 2).unsqueeze(1).contiguous()
                xc, gc = x.permute(ncdhw), g.permute(ncdhw)
                bw = ([2, 2, 2], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], c)

                def conv_bwd(mask):
                    return torch.ops.aten.convolution_backward(
                        gc, xc, w_conv, None, *bw, mask)

                cases = {
                    "dw_conv_t2": (
                        lambda: dw_conv.dw_conv3d(x, k, T2),
                        lambda: dw_conv.dw_conv3d_plain(x, k, T2),
                        lambda: F.conv3d(xc, w_conv, stride=2, padding=1,
                                         groups=c),
                        "F.conv3d(groups=C, stride=2), channels_last_3d",
                        dw_conv.fwd_work(g, x, k, T2), 1),
                    "dw_conv_dx_t2": (
                        lambda: dw_conv.dw_conv_dx_t2(g, k, (t, h, w)),
                        lambda: dw_conv.dw_conv_dx_t2_plain(g, k, (t, h, w)),
                        lambda: conv_bwd([True, False, False])[0],
                        "aten.convolution_backward, input gradient only",
                        dw_conv.dx_work(x, g, k, (t, h, w)), 1),
                    "dw_conv_wgrad_t2": (
                        lambda: dw_conv.dw_conv_wgrad(x, g, T2),
                        lambda: dw_conv.dw_conv_wgrad_plain(x, g, T2),
                        lambda: conv_bwd([False, True, False])[1],
                        "aten.convolution_backward, weight gradient only",
                        dw_conv.wgrad_work(None, x, g, T2), 1)}
                also = {
                    "dw_conv_t2": (("dw_conv_s2, frames ::2",
                                    lambda: dw_conv.dw_conv3d(x, k, 2)[:, ::2]
                                    ),),
                    "dw_conv_dx_t2": (("dw_conv_dx_s2 on g at even frames",
                                       lambda: dw_conv.dw_conv_dx_s2(
                                           up, k, (h, w))),),
                    "dw_conv_wgrad_t2": (
                        ("dw_conv_wgrad_t2 again",
                         lambda: dw_conv.dw_conv_wgrad(x, g, T2)),
                        ("dw_conv_wgrad_s2 on g at even frames, plan_t2's "
                         "items", lambda: _k10_on_t2_plan(dw_conv, x, up)))}
                meta = {"entry": f"t2.{group}", "x": [b, t, h, w, c],
                        "stride": [2, 2, 2]}
                counted = group == "B32.224"
                # the tensor whose rows each wrapper's mode reads: x, or
                # the dx the dx's wrapper writes
                dx_made = dw_conv.dw_conv_dx_t2(g, k, (t, h, w))
                plans = {name: _plan_row_t2(
                    dw_conv, name, (b, t, h, w, c), dtype,
                    dx_made if name == "dw_conv_dx_t2" else x)
                    for name in cases}
                del dx_made
                for name, case in cases.items():
                    _hold_time_library(
                        "t2_kernels", name, {**meta, "plan": plans[name]},
                        dtype, *case, counted, per_kernel[name],
                        also[name], also_exact=True)
                for name in T2_KERNELS:
                    q = queued_ms(cases[name][0], 20)
                    emit({"phase": "t2_kernels", "kernel": name, **meta,
                          "dtype": str(dtype)[6:], "device_ms": q["ms"],
                          "host_ms": q["host_ms"], "slept_ms": q["slept_ms"]})
                    if counted and dtype == torch.bfloat16:
                        per_kernel[name]["device_ms"] += q["ms"]
                del x, g, up, xc, gc
            torch.cuda.empty_cache()
    _t2_nan_edges(dw_conv, gen)
    return per_kernel


# NaN and the edges of the t2 forward and dx: a ragged shape in the whole-
# pixel and tile modes (x (2, 9, 30, 28, 54): y and g 5 x 15 x 14, strips
# of 4, 4, 4 and 3 rows, two column tiles of 7, which _t2_nan_edges checks;
# tile 1 stages input pixels 13 .. 27 from the 16-byte boundary in pixel
# 12, which tile 0 reads), and
# the planted position of each case as (frame, row, column, channel) of x
# (the forward) or of g (the dx), from the shape (T, H, W)
T2_NAN_SHAPE = (2, 9, 30, 28, 54)
T2_NANS = {
    "first_frame": lambda t, h, w: (0, h // 2, w // 2, 5),
    "last_frame": lambda t, h, w: (t - 1, h // 2, w // 2, 5),
    "ragged_strip_last_row": lambda t, h, w: (t // 2, h - 1, w // 2, 7),
    "column_0": lambda t, h, w: (t // 2, h // 2, 0, 9),
    "last_column": lambda t, h, w: (t // 2, h // 2, w - 1, 11),
    # x: the last channels of pixel 12, inside tile 1's aligned span (bf16
    # and f32), and pixel 14's first, inside tile 0's; g: columns 6 and 7,
    # the two tiles' last and first (each the other's halo)
    "span_left": lambda t, h, w: (t // 2, h // 2, 3 * w // 7, 53),
    "span_right": lambda t, h, w: (t // 2, h // 2, w // 2, 0),
}


def _t2_nan_edges(dw_conv, gen) -> None:
    """``dw_conv_t2`` with a NaN of x, and ``dw_conv_dx_t2`` with a NaN of
    g, at each of ``T2_NANS``' positions (g's scaled to g's frames, rows
    and columns), f32 and bf16: NaN exactly where the plain versions put it
    and every other element within the tolerance."""
    from coarse_fine_networks_torch.ops.dw_conv import T2

    b, t, h, w, c = T2_NAN_SHAPE
    to, ho, wo = (t - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1
    # the span cases sit at the two column tiles' border
    plans = (dw_conv.plan_t2_fwd(*T2_NAN_SHAPE),
             dw_conv.plan_t2_dx(*T2_NAN_SHAPE))
    check(all(q.wb == 7 and q.n_wt == 2 for q in plans),
          f"t2 NaN shape {T2_NAN_SHAPE}: column tiles "
          f"{[(q.wb, q.n_wt) for q in plans]}, not two of 7")
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        k = (torch.randn((3, 3, 3, c), generator=gen, device="cuda")
             / 27 ** 0.5).to(dtype)
        for case, at in T2_NANS.items():
            x = torch.randn((b, t, h, w, c), generator=gen,
                            device="cuda").to(dtype)
            g = torch.randn((b, to, ho, wo, c), generator=gen,
                            device="cuda").to(dtype)
            x[(1,) + at(t, h, w)] = float("nan")
            g[(1,) + at(to, ho, wo)] = float("nan")
            dx = dw_conv.dw_conv_dx_t2(g, k, (t, h, w))
            check(dw_conv.t2_whole(plans[0], x)
                  and dw_conv.t2_whole(plans[1], dx),
                  f"t2 NaN shape {T2_NAN_SHAPE}: not in the whole-pixel "
                  f"modes")
            for name, got, ref in (
                    ("dw_conv_t2", dw_conv.dw_conv3d(x, k, T2),
                     dw_conv.dw_conv3d_plain(x, k, T2)),
                    ("dw_conv_dx_t2", dx,
                     dw_conv.dw_conv_dx_t2_plain(g, k, (t, h, w)))):
                nan = torch.isnan(ref)
                same = bool(torch.equal(torch.isnan(got), nan))
                err, scale = _rel_err(got[~nan], ref[~nan])
                rows.append({"kernel": name, "case": case,
                             "dtype": str(dtype)[6:], "nans": int(nan.sum()),
                             "nan_positions_equal": same,
                             "max_abs_err": err})
                check(nan.any() and same,
                      f"t2 NaN {name} {case} {dtype}: NaN positions differ "
                      f"({int(torch.isnan(got).sum())} against "
                      f"{int(nan.sum())})")
                check(err <= TOL[dtype] * max(scale, 1.0),
                      f"t2 NaN {name} {case} {dtype}: max abs err {err}")
    emit({"phase": "t2_kernels", "what": "NaN and edges", "x": list(
        T2_NAN_SHAPE), "cases": rows})


# the coarse stream's other options at the train step's shapes (TRAIN: B8
# T64 224², bf16, banks at T_f 128, 157 classes), by the act route: the
# options and the logits' frames they give
COARSE_VARIANTS = {
    "t_pool=avg": (dict(t_pool="avg"), 16),
    "t_pool=max": (dict(t_pool="max"), 16),
    "t_pool=stride": (dict(t_pool="stride"), 16),
    "t_pool=None": (dict(t_pool=None), 64),
    "learned_mixing=False": (dict(learned_mixing=False), 64),
    "is_mixing=False": (dict(is_mixing=False), 64),
    "task=class": (dict(task="class"), 64),
}
# FineNet(t_downsample=True, task='class'), 400 classes: (B, T, crop, splits)
FINE_T2 = {"B32 T16 224²": (32, 16, 224, 1), "B64 T16 112²": (64, 16, 112, 8)}


def _variant_coarse(mods, name, kw, frames) -> dict:
    """One CoarseNet variant: a warm-up and a counted train step (the
    detection loss against labels at the logits' length), then a counted
    eval forward."""
    from coarse_fine_networks_torch.models import CoarseNet, init_parameters
    from coarse_fine_networks_torch.train import TrainState, make_train_step

    c = TRAIN
    model = init_parameters(CoarseNet("M", c["n_classes"], dropout_rate=0.5,
                                      **kw),
                            torch.Generator().manual_seed(40)).cuda()
    batch = _train_batch("cuda", torch.Generator(device="cuda").manual_seed(
        41), c["b"], c["t"], c["hw"], c["tf"], frames, c["n_classes"],
        torch.bfloat16)
    step = make_train_step(model, align_corners=False,
                           fusion_lr_mult=c["fusion_lr_mult"])
    state = TrainState.create(model)
    drop = torch.Generator(device="cuda").manual_seed(42)
    warm = step(state, batch, c["lr"], drop)[1]["loss"].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in mods:
        m.reset_launches()
    t1 = time.perf_counter()
    loss = step(state, batch, c["lr"], drop)[1]["loss"].item()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3
    launches = _launches(*mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in mods:
        m.reset_launches()
    model.eval()
    with torch.no_grad():
        logits = model(batch["clips"], batch["feats"], batch["feat_mask"],
                       batch["meta"])
    torch.cuda.synchronize()
    eval_launches = _launches(*mods)
    top = sorted({k.split(".")[0] for k in model.state_dict()})
    row = {"phase": "variants", "model": "CoarseNet", "option": name,
           "B": c["b"], "T": c["t"], "input_hw": c["hw"], "T_f": c["tf"],
           "label_len": frames, "losses": [warm, loss], "step_ms": step_ms,
           "peak_mem_gb": peak_gb, "logits": list(logits.shape),
           "modules": [m for m in top if m.startswith(("pool_", "mix"))],
           "launches": {k: v for k, v in launches.items() if v},
           "eval_launches": {k: v for k, v in eval_launches.items() if v}}
    emit(row)
    check(np.isfinite([warm, loss]).all(), f"variants {name}: losses "
                                           f"{[warm, loss]}")
    check(tuple(logits.shape) == (c["b"], frames, c["n_classes"])
          and bool(torch.isfinite(logits).all()),
          f"variants {name}: logits {tuple(logits.shape)}")
    check({k: v for k, v in launches.items() if v} == ACT_STEP,
          f"variants {name}: step launches {launches} != {ACT_STEP}")
    check({k: v for k, v in eval_launches.items() if v} == EVAL_CALL,
          f"variants {name}: eval launches {eval_launches} != {EVAL_CALL}")
    return row


def _variant_fine_t2(mods, name, b, t, crop, splits) -> tuple[dict, dict]:
    """FineNet(t_downsample=True, task='class'), 400 classes, bf16: a
    warm-up and a counted class train step (the Kinetics step), a counted
    eval step, then one train step profiled.  Returns the row and the t2
    kernels' launches of the counted step and eval."""
    from coarse_fine_networks_torch.models import (FineNet, init_parameters,
                                                   set_bn_splits)
    from coarse_fine_networks_torch.train import TrainState
    from coarse_fine_networks_torch.train.kinetics_driver import (
        make_class_eval_step, make_class_train_step)

    n_classes = KINETICS["n_classes"]
    model = set_bn_splits(init_parameters(
        FineNet("M", n_classes, task="class", global_tower=False,
                t_downsample=True),
        torch.Generator().manual_seed(43)), splits).cuda()
    gen = torch.Generator(device="cuda").manual_seed(44)
    batch = {"clips": torch.rand((b, t, crop, crop, 3), generator=gen,
                                 device="cuda").to(torch.bfloat16),
             "labels": torch.randint(0, n_classes, (b,), generator=gen,
                                     device="cuda")}
    step = make_class_train_step(model, weight_decay=1e-5)
    state = TrainState.create(model)
    drop = torch.Generator(device="cuda").manual_seed(45)
    warm = step(state, batch, 0.1, drop)[1]["loss"].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in mods:
        m.reset_launches()
    t1 = time.perf_counter()
    loss = step(state, batch, 0.1, drop)[1]["loss"].item()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3
    launches = _launches(*mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in mods:
        m.reset_launches()
    t1 = time.perf_counter()
    ev = make_class_eval_step(model)(state, batch)
    eval_loss = ev["loss"].item()
    eval_ms = (time.perf_counter() - t1) * 1e3
    eval_launches = _launches(*mods)
    with torch.no_grad():
        model.eval()
        logits = model(batch["clips"])
        model.train()
    want = T2_SPLIT_STEP if splits > 1 else T2_ACT_STEP
    ours = (("plain_fwd_kernel", "plain_wgrad_kernel") if splits > 1
            else ("act_fwd_s1_kernel", "act_dx_s1_kernel",
                  "act_wgrad_s1_kernel")) + (
        "plain_t2_fwd_kernel", "plain_t2_dx_kernel", "plain_t2_wgrad_kernel",
        "stencil_fwd_kernel", "stencil_dk_kernel")

    def one_step():
        step(state, batch, 0.1, drop)[1]["loss"].item()
    profiled = _profile_step(one_step, ours, mods)
    row = {"phase": "variants", "model": "FineNet",
           "option": "t_downsample=True, task=class", "shape": name,
           "n_classes": n_classes, "bn_splits": splits,
           "losses": [warm, loss], "eval_loss": eval_loss,
           "step_ms": step_ms, "eval_ms": eval_ms, "peak_mem_gb": peak_gb,
           "logits": list(logits.shape),
           "launches": {k: v for k, v in launches.items() if v},
           "eval_launches": {k: v for k, v in eval_launches.items() if v}}
    emit(row)
    emit({"phase": "variants_profile",
          "what": f"one FineNet(t_downsample) class train step, {name} bf16, "
                  f"{splits} splits", **profiled})
    check(np.isfinite([warm, loss, eval_loss]).all(),
          f"variants t_downsample {name}: losses {[warm, loss, eval_loss]}")
    check(tuple(logits.shape) == (b, 1, n_classes)
          and bool(torch.isfinite(logits).all()),
          f"variants t_downsample {name}: logits {tuple(logits.shape)}")
    check({k: v for k, v in launches.items() if v} == want,
          f"variants t_downsample {name}: step launches {launches} != {want}")
    check({k: v for k, v in eval_launches.items() if v} == T2_EVAL_CALL,
          f"variants t_downsample {name}: eval launches {eval_launches} != "
          f"{T2_EVAL_CALL}")
    check(dict(profiled["port_kernel_launches"]) == {
        f: want[names[0]] for f, names in KERNEL_FUNCS.items()
        if names[0] in want}, f"variants t_downsample {name}: profiled "
                              f"{profiled['port_kernel_launches']}")
    return row, {k: launches[k] + eval_launches[k] for k in T2_KERNELS}


def phase_variants(mods) -> dict:
    """The models' other options at full width on the card: each
    CoarseNet option (``t_pool`` avg, max, stride, None; unlearned mixing;
    no mixing; ``task='class'``) at the coarse train step's shapes by the
    act route, then FineNet(t_downsample=True, task='class') at B32 T16
    224² (1 split) and B64 T16 112² (8 splits); each with its peak memory.
    Returns the t2 kernels' launches in the counted fine steps and evals."""
    t2 = {k: 0 for k in T2_KERNELS}
    for name, (kw, frames) in COARSE_VARIANTS.items():
        _variant_coarse(mods, name, kw, frames)
        torch.cuda.empty_cache()
    for name, (b, t, crop, splits) in FINE_T2.items():
        _, got = _variant_fine_t2(mods, name, b, t, crop, splits)
        t2 = {k: t2[k] + got[k] for k in t2}
        torch.cuda.empty_cache()
    return t2


# ---- remat: every bottleneck recomputed in the backward -----------------------

def _remat_step(route, remat):
    """The remat phase's step launches of one route: the bottlenecks'
    forward kernels twice with ``remat`` (the recomputation), their backward
    kernels and the stem's once."""
    base = {"act": ACT_STEP, "split": SPLIT_STEP,
            "mm": {"dw_mm_act_s1": 22, "dw_mm_act_s2": 4,
                   "dw_mm_dx_mask_s1": 22, "dw_mm_dx_mask_s2": 4,
                   "dw_mm_wgrad_s1": 22, "dw_mm_wgrad_s2": 4,
                   "dw_stencil_s1": 2, "dw_stencil_wgrad": 1}}[route]
    fwd = {"act": ("dw_act_s1", "dw_act_s2"), "split": ("dw_conv_s1",
                                                        "dw_conv_s2"),
           "mm": ("dw_mm_act_s1", "dw_mm_act_s2")}[route]
    # the split route's dw_conv_s1 is also its stride-1 dx: 22 of its 44
    extra = {"dw_conv_s1": 22}
    return {k: v + (extra.get(k, v) if remat and k in fwd else 0)
            for k, v in base.items()}


def _remat_config(mods, label, dtype=torch.bfloat16, b=None):
    """(model, step, batch, lr, route) of one remat configuration, its
    clips in ``dtype``; ``b`` cuts a fine phase's batch."""
    from coarse_fine_networks_torch.models import (CoarseNet, FineNet,
                                                   init_parameters,
                                                   set_bn_splits)
    from coarse_fine_networks_torch.train import make_train_step, model_batch

    if label.startswith("coarse"):
        c = TRAIN
        model = init_parameters(CoarseNet("M", c["n_classes"],
                                          dropout_rate=0.5),
                                torch.Generator().manual_seed(50)).cuda()
        batch = _train_batch("cuda", torch.Generator(device="cuda")
                             .manual_seed(51), c["b"], c["t"], c["hw"],
                             c["tf"], c["tl"], c["n_classes"], dtype)
        step = make_train_step(model, align_corners=False,
                               fusion_lr_mult=c["fusion_lr_mult"])
        return model, step, batch, c["lr"], ("mm" if label.endswith("mm")
                                             else "act")
    _, b_phase, t, crop, tl, splits = fine_phase(label[-1])
    b = b or b_phase
    model = set_bn_splits(init_parameters(
        FineNet("M", FINE["n_classes"], dropout_rate=FINE["dropout"],
                global_tower=False), torch.Generator().manual_seed(52)),
        splits).cuda()
    batch = model_batch(_fine_host_batch(torch.Generator(device="cuda")
                                         .manual_seed(53), b, t, crop, tl,
                                         FINE["n_classes"]),
                        dtype=dtype, device="cuda")
    step = make_train_step(model, align_corners=True)
    return model, step, batch, FINE["lr"], "split" if splits > 1 else "act"


REMAT_CONFIGS = ("coarse act", "coarse mm", "fine phase A", "fine phase D")


def phase_remat(mods) -> None:
    """``remat`` on the card: the coarse train step by the act route and by
    the composite (``CFN_MM_BN_TRAIN=1``), and long-cycle phases A (8
    splits, the split route) and D (1 split, the act route), each run from
    the same weights, batch and dropout draws without ``remat``, again
    without, and with: the loss, every parameter's gradient and every batch
    norm statistic.  The two plain runs' difference is the card's own
    run-to-run spread (PyTorch's atomics: the logits' resize backward,
    cuDNN's weight gradients); each tensor of the remat run must lie
    within 4× the step's largest spread (relative to the tensor's largest
    magnitude) of the plain run, and exactly on it where the step repeats
    bit for bit.  Launches: the bottlenecks' forward kernels twice and
    their backward kernels once a remat step; step ms and peak GB with and
    without."""
    from coarse_fine_networks_torch.models import X3DStage
    from coarse_fine_networks_torch.train import TrainState

    for label in REMAT_CONFIGS:
        with composite_route(label == "coarse mm"):
            model, step, batch, lr, route = _remat_config(mods, label)
            sd0 = {k: v.detach().clone() for k, v in
                   model.state_dict().items()}
            stages = [m for m in model.modules() if isinstance(m, X3DStage)]

            def run(remat):
                model.load_state_dict(sd0)
                for s in stages:
                    s.remat = remat
                state = TrainState.create(model)
                drop = torch.Generator(device="cuda").manual_seed(54)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for m in mods:
                    m.reset_launches()
                t1 = time.perf_counter()
                loss = step(state, batch, lr, drop)[1]["loss"].item()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3
                return {"loss": loss, "ms": ms,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches": {k: v for k, v in
                                     _launches(*mods).items() if v},
                        "grads": {k: p.grad.detach().clone() for k, p in
                                  model.named_parameters()},
                        "stats": {k: v.detach().clone() for k, v in
                                  model.state_dict().items()
                                  if "running" in k}}

            run(False)  # warm-up (first calls, allocator)
            plain = run(False)
            remat = run(True)
            again = run(False)
            del model, step, batch

        def rel(a, b):
            return {k: ((a[k] - b[k]).abs().max()
                        / a[k].abs().max().clamp(min=1e-30)).item()
                    for k in a}
        spread = {**rel(plain["grads"], again["grads"]),
                  **rel(plain["stats"], again["stats"])}
        diff = {**rel(plain["grads"], remat["grads"]),
                **rel(plain["stats"], remat["stats"])}
        tol = 4 * max(spread.values())
        worst = sorted(diff.items(), key=lambda kv: -kv[1])[:5]
        row = {"phase": "remat", "config": label, "route": route,
               "loss": [plain["loss"], again["loss"], remat["loss"]],
               "step_ms": {"plain": plain["ms"], "remat": remat["ms"]},
               "peak_mem_gb": {"plain": plain["peak_gb"],
                               "remat": remat["peak_gb"]},
               "spread_max": max(spread.values()),
               "spread_zero_share": sum(v == 0 for v in spread.values())
               / len(spread),
               "remat_max": max(diff.values()), "remat_worst": worst,
               "tol": tol, "launches": {"plain": plain["launches"],
                                        "remat": remat["launches"]}}
        emit(row)
        check(np.isfinite(row["loss"]).all(), f"remat {label}: losses "
                                              f"{row['loss']}")
        check(abs(remat["loss"] - plain["loss"]) <= tol * abs(plain["loss"]),
              f"remat {label}: loss {remat['loss']} vs {plain['loss']}")
        check(all(v <= tol for v in diff.values()),
              f"remat {label}: tensors off the plain run {worst} > {tol}")
        for which, want in (("plain", _remat_step(route, False)),
                            ("remat", _remat_step(route, True))):
            got = row["launches"][which]
            check(got == want, f"remat {label} {which}: launches {got} != "
                               f"{want}")
        del plain, again, remat
        torch.cuda.empty_cache()


# ---- parallelism: dp_train, dp_serve, dp_cli ---------------------------------

# dp_train's runs: (configuration of the remat phase, built from the same
# seeds in every rank; the clips' dtype; the global batch, None for the
# configuration's own).  bf16 is the step users train, and there a change
# of the clips by one ulp moves every stage's gradient by O(1), so only the
# loss and the running statistics can tell a fault from rounding; f32
# (TF32 off) is where the gradients are held, with phase B at B16 (its B32
# in f32 would not fit beside the two ranks)
DP_RUNS = tuple((label, dtype, b)
                for dtype in (torch.bfloat16, torch.float32)
                for label, b in (("coarse act", None), ("coarse mm", None),
                                 ("fine phase B", None if dtype ==
                                  torch.bfloat16 else 16)))
DP_WORLD = 2
# the quantities dp_train holds the ranks to (:func:`_dp_apart`), by dtype
DP_HELD = {torch.bfloat16: ("loss_rel", "stat_stage_max"),
           torch.float32: ("loss_rel", "stat_stage_max", "grad_stage_max")}
# dp_serve: the data-parallel server's probabilities against the one-device
# server's (rows in batches of another size: cuBLAS picks other algorithms;
# read 2.9e-5 in bf16), by dtype; the tensor-parallel banks against the
# unpadded tower's, of
# each bank's largest magnitude (the shards' partial sums add in another
# order, in f32)
DP_SERVE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
TP_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# dp_cli: the validation batches of the driver phase's tree (4 test videos,
# one a batch)
DP_CLI_VAL = 4
# the least bound on a relative distance: one f32 ulp (the loss and the
# statistics are f32 values; in f32 one ulp of the clips may move neither)
DP_FLOOR = 2.0 ** -23
# a gradient below this share of the step's largest gradient is a sum that
# cancels (a bias a training batch norm takes out again): rounding noise in
# every run, left out of the comparisons
DP_NEGLIGIBLE = 1e-4


def _dp_key(label: str, dtype) -> str:
    return f"{label} {'bf16' if dtype == torch.bfloat16 else 'f32'}"


def _dp_measure(model, step, batch, lr, mods, sd0,
                warm: bool = True) -> dict:
    """A train step of ``model`` from the weights ``sd0`` with the same
    dropout draws, after a warm-up step of the same (allocator, library
    handles) with ``warm``: its loss, ms (host clock to the loss on the
    host), peak GB, kernel launches, gradients and running statistics (on
    the host)."""
    from coarse_fine_networks_torch.train import TrainState

    def run():
        model.load_state_dict(sd0)
        state = TrainState.create(model)
        drop = torch.Generator(device="cuda").manual_seed(54)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m in mods:
            m.reset_launches()
        t1 = time.perf_counter()
        loss = step(state, batch, lr, drop)[1]["loss"].item()
        torch.cuda.synchronize()
        return {"loss": loss, "ms": (time.perf_counter() - t1) * 1e3,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": {k: v for k, v in _launches(*mods).items() if v},
                "grads": {k: p.grad.detach().float().cpu() for k, p in
                          model.named_parameters()},
                "stats": {k: v.detach().float().cpu() for k, v in
                          model.state_dict().items() if "running" in k}}

    if warm:
        run()
    return run()


def _state0(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _ulp_up(batch: dict, part: int) -> dict:
    """``batch`` with clip values moved one ulp of their dtype away from
    0: all of them (``part`` 0), or one half of them (1) or the other (2),
    the halves drawn from a seeded generator."""
    clips = batch["clips"]
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    step = torch.ones_like(clips.view(bits[clips.dtype]))
    if part:
        half = torch.rand(clips.shape, device=clips.device,
                          generator=torch.Generator(device=clips.device)
                          .manual_seed(55)) < 0.5
        step = step * (half if part == 1 else ~half)
    up = (clips.view(bits[clips.dtype]) + step).view(clips.dtype)
    return {**batch, "clips": up}


def _unreduced_backward(ctx, g):
    """A planted fault for dp_train: the statistics' all-reduce passing its
    gradient on without summing it over the ranks."""
    return g.clone()


def _dp_rank(runs) -> dict:
    """A data-parallel rank (spawned by ``mesh.spawn``): each run of
    ``runs`` (:data:`DP_RUNS`) built from its seeds (:func:`_remat_config`),
    this rank's rows of its global batch, :func:`_dp_measure`; in f32 in a
    group of more than one also a step with the planted fault of
    :func:`_unreduced_backward` (``fault``: its loss, gradients and
    statistics)."""
    from unittest import mock

    from coarse_fine_networks_torch.data import native
    from coarse_fine_networks_torch.ops import (dw_act, dw_conv, dw_mm_act,
                                                dw_mm_bn_train, dw_stencil,
                                                frame_decode, scaled_decode)
    from coarse_fine_networks_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = (dw_act, dw_conv, dw_mm_act, dw_mm_bn_train, dw_stencil)
    out = {"backend": mesh.backend(), "world": mesh.world(),
           "rank": mesh.rank(),
           "device": str(torch.cuda.current_device())}
    for label, dtype, b in runs:
        with composite_route(label == "coarse mm"):
            model, step, batch, lr, route = _remat_config(mods, label, dtype,
                                                          b)
            sd0, local = _state0(model), mesh.shard_batch(batch)
            got = dict(_dp_measure(model, step, local, lr, mods, sd0),
                       rows=int(local["clips"].shape[0]), route=route)
            if dtype == torch.float32 and mesh.world() > 1:
                with mock.patch.object(mesh._AllReduceSum, "backward",
                                       staticmethod(_unreduced_backward)):
                    fault = _dp_measure(model, step, local, lr, mods, sd0,
                                        warm=False)
                got["fault"] = {k: fault[k]
                                for k in ("loss", "grads", "stats")}
            out[_dp_key(label, dtype)] = got
            del model, step, batch, local
            torch.cuda.empty_cache()
    return out


def _dp_apart(plain: dict, other: dict, noise=()) -> dict:
    """How far ``other``'s step lies from ``plain``'s (both
    :func:`_dp_measure`): per stage the relative L2 distance of the
    gradients (those in ``noise`` left out) and of the running
    statistics, the largest of each (``grad_stage_max``,
    ``stat_stage_max``), the loss's relative distance (``loss_rel``) and
    the three tensors furthest apart (over their largest magnitude)."""
    out = {}
    for kind in ("grads", "stats"):
        acc: dict = {}
        for k, v in plain[kind].items():
            if k in noise:
                continue
            e = acc.setdefault(_stage(k), [0.0, 0.0])
            e[0] += float(((other[kind][k] - v).double() ** 2).sum())
            e[1] += float((v.double() ** 2).sum())
        stage = {st: (x / max(n, 1e-300)) ** 0.5
                 for st, (x, n) in acc.items()}
        worst = max(stage.items(), key=lambda kv: kv[1])
        out[f"{kind[:-1]}_stage_max"] = worst[1]
        out[f"{kind[:-1]}_worst_stage"] = worst[0]
    per = {**_rel(plain["grads"], other["grads"], noise),
           **_rel(plain["stats"], other["stats"])}
    out["loss_rel"] = abs(other["loss"] - plain["loss"]) / abs(plain["loss"])
    out["worst_tensors"] = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    return out


def _rel(a: dict, b: dict, skip=()) -> dict:
    """Per tensor: the largest difference over the tensor's largest
    magnitude (``a`` the reference)."""
    return {k: ((b[k] - a[k]).abs().max()
                / a[k].abs().max().clamp(min=1e-30)).item()
            for k in a if k not in skip}


def phase_dp_train(mods) -> dict:
    """Data-parallel training on the card: the coarse train step (X3D-M,
    157 classes, B8 T64 224²) by the act route and by the composite, then
    long-cycle phase B (T32 144², 4 splits; B32 in bf16, B16 in f32), each
    in bf16 and in f32 (TF32 off) and each run by ``DP_WORLD`` ranks
    spawned by ``parallel.mesh.spawn`` that share the card over gloo (each
    rank half the batch), against one process on the whole batch from the
    same weights, batch and dropout draws.  The one process runs the step
    twice (its run-to-run spread) and three times with clip values one ulp
    up (all of them, then each half of them: the step's own sensitivity to
    rounding, since a relu input within a rounding of 0 takes the other
    branch, as it does when the ranks reduce in another order).  Each
    rank's loss and per stage its running statistics and, in f32, its
    gradients (relative L2, :func:`_dp_apart`; gradients below
    ``DP_NEGLIGIBLE`` of the largest left out) must lie within the larger
    of 4× the run-to-run spread, 2× the largest one-ulp movement and one
    f32 ulp (``DP_FLOOR``), and
    both ranks must hold the same gradients and statistics.  In f32 two
    planted faults must fall outside the gradients' bound: the statistics'
    all-reduce passing its gradient on unreduced (a step of each rank) and
    each rank's loss its local mean instead of its share (rank 0's
    gradients doubled).  Each rank's launches must be one step's of its
    route.  Then the coarse act step in bf16 through the same spawn path
    at world size 1 over NCCL, within 4× the run-to-run spread.  Prints
    the backend, each rank's peak GB, step ms and launches, and each
    tensor furthest apart.  Returns rank 0's launches summed over the
    runs."""
    from coarse_fine_networks_torch.parallel import mesh

    ref = {}
    for label, dtype, b in DP_RUNS:
        with composite_route(label == "coarse mm"):
            model, step, batch, lr, route = _remat_config(mods, label, dtype,
                                                          b)
            sd0 = _state0(model)
            plain = _dp_measure(model, step, batch, lr, mods, sd0)
            again = _dp_measure(model, step, batch, lr, mods, sd0, False)
            ulp = [_dp_measure(model, step, _ulp_up(batch, part), lr, mods,
                               sd0, False) for part in range(3)]
            rows_ = int(batch["clips"].shape[0])
            del model, step, batch, sd0
        torch.cuda.empty_cache()
        ref[_dp_key(label, dtype)] = (route, dtype, rows_, plain, again, ulp)
    t1 = time.perf_counter()
    ranks = mesh.spawn(_dp_rank, DP_WORLD, DP_RUNS, device="cuda")
    spawn_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    nccl = mesh.spawn(_dp_rank, 1, DP_RUNS[:1], device="cuda",
                      backend_="nccl")
    nccl_s = time.perf_counter() - t1
    per_kernel: dict = {}
    for key, (route, dtype, b, plain, again, ulp) in ref.items():
        top = max(g.abs().max().item() for g in plain["grads"].values())
        noise = {k for k, g in plain["grads"].items()
                 if g.abs().max().item() <= DP_NEGLIGIBLE * top}
        spread = _dp_apart(plain, again, noise)
        sens = [_dp_apart(plain, u, noise) for u in ulp]
        held = DP_HELD[dtype]
        tol = {k: max(4 * spread[k], 2 * max(u[k] for u in sens),
                      DP_FLOOR) for k in held}
        want = _remat_step(route, False)
        row = {"phase": "dp_train", "config": key, "route": route, "B": b,
               "world": DP_WORLD, "backend": ranks[0]["backend"],
               "devices": [r["device"] for r in ranks],
               "one_process": {"loss": plain["loss"], "ms": plain["ms"],
                               "peak_gb": plain["peak_gb"]},
               "run_to_run": spread, "one_ulp": sens, "held": held,
               "tol": tol, "negligible_grads": len(noise), "ranks": []}
        for r in ranks:
            got = r[key]
            row["ranks"].append({
                "rank": r["rank"], "rows": got["rows"], "loss": got["loss"],
                **_dp_apart(plain, got, noise), "ms": got["ms"],
                "peak_gb": got["peak_gb"],
                "launches": got["launches"]})
        faults = {}
        if dtype == torch.float32:
            got = ranks[0][key]
            faults = {
                "statistics' gradient unreduced":
                    _dp_apart(plain, got["fault"], noise),
                "loss a local mean (gradients 2x)": _dp_apart(plain, {
                    **got, "grads": {k: 2 * v for k, v in
                                     got["grads"].items()}}, noise)}
            row["planted_faults"] = faults
        emit(row)
        for rr in row["ranks"]:
            over = {k: rr[k] for k in held if rr[k] > tol[k]}
            check(np.isfinite(rr["loss"]) and not over,
                  f"dp_train {key} rank {rr['rank']}: {over} over {tol} "
                  f"(loss {rr['loss']} vs {plain['loss']})")
            check(rr["launches"] == want,
                  f"dp_train {key} rank {rr['rank']}: launches "
                  f"{rr['launches']} != {want}")
        caught = {k: f["grad_stage_max"] for k, f in faults.items()}
        check(all(v > tol.get("grad_stage_max", 0) for v in caught.values()),
              f"dp_train {key}: a planted fault within the bound: {caught} "
              f"against {tol}")
        same = [k for k, v in ranks[0][key]["grads"].items()
                if not torch.equal(v, ranks[1][key]["grads"][k])]
        same += [k for k, v in ranks[0][key]["stats"].items()
                 if not torch.equal(v, ranks[1][key]["stats"][k])]
        check(not same, f"dp_train {key}: the ranks differ in {same[:5]}")
        check(ranks[0]["backend"] == "gloo" and all(
            r["device"] == "0" for r in ranks), f"dp_train: ranks on "
            f"{[r['device'] for r in ranks]} over {ranks[0]['backend']}")
        for k, v in ranks[0][key]["launches"].items():
            per_kernel[k] = per_kernel.get(k, 0) + v
    key = _dp_key(*DP_RUNS[0][:2])
    route, _, _, plain, again, _ = ref[key]
    got = nccl[0][key]
    spread, apart = _dp_apart(plain, again), _dp_apart(plain, got)
    held = ("loss_rel", "stat_stage_max", "grad_stage_max")
    row = {"phase": "dp_train_nccl_world1", "config": key,
           "backend": nccl[0]["backend"], "world": nccl[0]["world"],
           "loss": got["loss"], "one_process_loss": plain["loss"],
           **apart, "run_to_run": spread, "ms": got["ms"],
           "peak_gb": got["peak_gb"], "launches": got["launches"],
           "spawn_s": nccl_s}
    emit(row)
    emit({"phase": "dp_train_spawn", "world": DP_WORLD, "seconds": spawn_s})
    check(row["backend"] == "nccl" and row["world"] == 1,
          f"dp_train nccl: {row['backend']} world {row['world']}")
    check(all(apart[k] <= 4 * spread[k] for k in held),
          f"dp_train nccl world 1: {apart} against the run-to-run {spread}")
    check(got["launches"] == _remat_step("act", False),
          f"dp_train nccl: launches {got['launches']}")
    return per_kernel


def phase_dp_serve(mods) -> None:
    """Data-parallel and tensor-parallel serving on the card.  (a)
    ``CachingVideoServer`` over ``[cuda:0, cuda:0]`` with two replicas of
    the X3D-M pipeline (seeded) against the one-device server: the serve
    phase's three videos cold (one batch of 3, padded to 4 rows, two a
    replica) and as hits, with exact launches (cold: each replica's
    extract and fuse; hit: each replica's fuse), in bf16 and in f32 (TF32
    off).  Each result must lie within ``DP_SERVE_TOL`` of the
    one-device server's.  The seeded model's probabilities of two videos
    differ by little more than bf16 rounding, so in bf16 the bound only
    guards against a gross fault; in f32 a server answering A with B's
    rows must exceed it.  (b) The tensor-parallel fine tower
    (``make_tp_tower`` over two shards on ``cuda:0``: mid and head widths
    padded to 16·k, each shard's slice through K1 ``mm`` and K4 ``mm``,
    the stem's K11 once) against the unpadded tower on the cold batch's
    fine clips (B3, T_f=128, 224²): every bank within ``TP_TOL`` of its
    largest magnitude, bf16 and f32 (TF32 off), with exact launches (44 K1
    ``mm``, 8 K4 ``mm``, 1 K11 a call), and the two extracts' ms."""
    import copy

    from coarse_fine_networks_torch.models import CoarseFinePipeline
    from coarse_fine_networks_torch.parallel.tensor import (make_tp_tower,
                                                            tp_param_bytes)
    from coarse_fine_networks_torch.serve import (CachingVideoServer,
                                                  FeatureCache)

    pipes = {dtype: CoarseFinePipeline(
        n_classes=157, version="M", compute_dtype=dtype, device="cuda",
        generator=torch.Generator().manual_seed(0))
        for dtype in (torch.bfloat16, torch.float32)}
    rng = torch.Generator().manual_seed(1)
    videos = {"A": (64, 128), "B": (64, 128), "C": (50, 100)}
    clips = {v: _clip(rng, t, 224) for v, (t, _) in videos.items()}
    fine = {v: _clip(rng, tf, 224) for v, (_, tf) in videos.items()}
    devs = [torch.device("cuda", 0)] * 2
    n = len(devs)
    want = {kind: {k: n * v for k, v in counts.items()}
            for kind, counts in serve_counts(STAGES).items()}
    for dtype, pipe in pipes.items():
        out, rows = {}, {}
        for name in ("dp", "one"):
            reps = [pipe, copy.deepcopy(pipe)] if name == "dp" else [pipe]
            server = CachingVideoServer(
                [p.extract for p in reps], [p.fuse for p in reps],
                cache=FeatureCache(capacity_bytes=2 << 30), max_batch=3,
                max_wait_ms=2000, bucket_multiple=16, request_timeout_s=600,
                devices=devs[:len(reps)]).start()
            try:
                for f in [server.submit(clips[v], fine[v],
                                        video_id="warm" + v)
                          for v in videos]:
                    f.result(timeout=600)
                res, counts, lat = {}, {}, {}
                for kind in ("cold", "hit"):
                    for m in mods:
                        m.reset_launches()
                    t1 = time.perf_counter()
                    futs = {v: server.submit(clips[v], fine[v]
                                             if kind == "cold" else None,
                                             video_id=v)
                            for v in videos}
                    res[kind] = {v: f.result(timeout=600)
                                 for v, f in futs.items()}
                    torch.cuda.synchronize()
                    lat[kind] = (time.perf_counter() - t1) * 1e3
                    counts[kind] = {k: v for k, v in _launches(*mods).items()
                                    if v}
            finally:
                server.stop()
            out[name] = res
            rows[name] = {"latency_ms": lat, "launches": counts,
                          "batch_sizes": server.batch_sizes[-2:]}
        diff = max(float(np.abs(out["dp"][k][v] - out["one"][k][v]).max())
                   for k in ("cold", "hit") for v in videos)
        # what a server that answered A with B's rows would read
        swapped = min(float(np.abs(out["one"][k]["A"] - out["one"][k]["B"])
                            .max()) for k in ("cold", "hit"))
        tol = DP_SERVE_TOL[dtype]
        emit({"phase": "dp_serve", "devices": [str(d) for d in devs],
              "model": "X3D-M", "dtype": str(dtype)[6:], **rows,
              "max_abs_diff": diff, "tol": tol,
              "rows_swapped_max_abs_diff": swapped, "want": want})
        check(diff <= tol, f"dp_serve {dtype}: {diff} > {tol}")
        check(dtype != torch.float32 or swapped > tol,
              f"dp_serve f32: rows swapped {swapped} within {tol}")
        check(rows["dp"]["launches"] == want,
              f"dp_serve {dtype} launches {rows['dp']['launches']} != "
              f"{want}")
        check(rows["dp"]["batch_sizes"] == [3, 3],
              f"dp_serve {dtype} batches {rows['dp']['batch_sizes']}")
    # (b) the tensor-parallel extract
    tf_pad = 128
    x = np.zeros((3, tf_pad, 224, 224, 3), np.float32)
    for i, v in enumerate(videos):
        x[i, :fine[v].shape[0]] = fine[v]
    x = torch.from_numpy(x).cuda()
    tp_rows = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        p = pipes[dtype]
        tp = make_tp_tower(p.fine, devs, dtype)
        ms = {}
        with torch.inference_mode():
            for which, fn in (("tower", p.extract), ("tp", tp)):
                fn(x)  # warm-up
                for m in mods:
                    m.reset_launches()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = fn(x)
                torch.cuda.synchronize()
                ms[which] = (time.perf_counter() - t1) * 1e3
                counts = {k: v for k, v in _launches(*mods).items() if v}
                if which == "tower":
                    ref = got
                else:
                    tp_counts = counts
        errs = {k: float((got[k] - ref[k]).abs().max()
                         / ref[k].abs().max()) for k in ref}
        total, per = tp_param_bytes(tp.model.state_dict(), len(devs))
        tp_rows[name] = {"ms": ms, "max_rel_err": errs,
                         "tol": TP_TOL[dtype], "launches": tp_counts,
                         "channel_pad": tp.model.channel_pad,
                         "param_bytes_total_per_shard": [total, per]}
        del tp, p, got, ref
        torch.cuda.empty_cache()
    emit({"phase": "dp_serve_tp", "shards": [str(d) for d in devs],
          "batch": [3, tf_pad, 224, 224], **tp_rows})
    want_tp = {"dw_mm_act_s1": 2 * 22, "dw_mm_act_s2": 2 * 4,
               "dw_stencil_s1": 1}
    for name, r in tp_rows.items():
        check(max(r["max_rel_err"].values()) <= r["tol"],
              f"dp_serve_tp {name}: {r['max_rel_err']} > {r['tol']}")
        check(r["launches"] == want_tp,
              f"dp_serve_tp {name}: launches {r['launches']} != {want_tp}")


def _counted(fn, *args):
    """``fn(*args)`` in a spawned rank, with the rank's kernel launches
    when it returned."""
    from coarse_fine_networks_torch.data import native
    from coarse_fine_networks_torch.ops import (dw_act, dw_conv, dw_mm_act,
                                                dw_mm_bn_train, dw_stencil,
                                                frame_decode, scaled_decode)

    out = fn(*args)
    return out, _launches(dw_act, dw_conv, dw_mm_act, dw_mm_bn_train,
                          dw_stencil)


@contextlib.contextmanager
def _rank_launches():
    """Within: every ``parallel.mesh.spawn`` runs its function under
    :func:`_counted`; yields a list that holds each rank's launches of the
    last spawn, by rank."""
    from unittest import mock

    from coarse_fine_networks_torch.parallel import mesh

    real, got = mesh.spawn, []

    def spawn(fn, world_, *args, **kw):
        outs = real(_counted, world_, fn, *args, **kw)
        got[:] = [launches for _, launches in outs]
        return [out for out, _ in outs]

    with mock.patch.object(mesh, "spawn", spawn):
        yield got


def phase_dp_cli(mods) -> dict:
    """``train_coarse_fineFEAT --mesh-devices 2`` at its defaults (X3D-M,
    157 classes, bf16, B6 T64 224², 3 rows a rank) on the driver phase's
    tree and the cli phase's extraction bank: the command line spawns two
    ranks sharing the card over gloo, which train an epoch of one step
    each for two epochs, checkpoint every step (``ckpt_every`` set to 1 on
    the configuration the command line builds) and validate on rank 0 with
    the localize CSV; then the command line again to step 3, resumed from
    rank 0's step-2 checkpoint.  The validation mAP must equal the
    one-process validation of that checkpoint in this process (1e-6
    relative), each rank's launches must be its steps' (and rank 0's its
    validation's), and the checkpoints one a step.  Returns each kernel's
    launches over both runs, per rank, summed."""
    import dataclasses
    from unittest import mock

    from coarse_fine_networks_torch.ckpt import load_checkpoint
    from coarse_fine_networks_torch.cli import train_coarse_fineFEAT
    from coarse_fine_networks_torch.metrics import APMeter
    from coarse_fine_networks_torch.models import CoarseNet
    from coarse_fine_networks_torch.train import (TrainState, coarse_driver,
                                                  make_eval_step)

    tree, root = SCRATCH / "driver", SCRATCH / "dp_cli"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--root", str(tree / "frames"), "--anno",
            str(tree / "annotations.json"), "--num-workers", "4",
            "--fine-feat-dir", str(SCRATCH / "cli" / "feats"),
            "--save-dir", str(root / "models"), "--localize-csv",
            str(root / "loc.csv"), "--mesh-devices", str(DP_WORLD),
            "--max-steps", "3"]
    real, cfgs = train_coarse_fineFEAT.to_config, []

    def to_config(args, **kw):
        cfg = real(args, **kw)
        cfg.ckpt_every = 1
        cfgs.append(cfg)
        return cfg

    runs = {}
    with mock.patch.object(train_coarse_fineFEAT, "to_config", to_config), \
            _rank_launches() as ranks:
        for name, epochs in (("first", 2), ("resumed", 3)):
            t1 = time.perf_counter()
            res = train_coarse_fineFEAT.main(argv + ["--max-epochs",
                                                     str(epochs)])
            runs[name] = {"res": res, "s": time.perf_counter() - t1,
                          "ranks": list(ranks)}
    cfg = cfgs[0]
    files = sorted(os.listdir(root / "models"))
    model = CoarseNet("M", 157)
    raw = load_checkpoint(str(root / "models" /
                              f"{coarse_driver.PREFIX}_000002.ckpt"))
    model.load_state_dict(raw["variables"], strict=True)
    model.cuda()
    _, val_loader = coarse_driver.build_coarse_loaders(cfg)
    t1 = time.perf_counter()
    one = coarse_driver._validate(
        dataclasses.replace(cfg, localize_csv=None, mesh_devices=None),
        TrainState.create(model), model, val_loader,
        make_eval_step(model, align_corners=False), APMeter(),
        torch.device("cuda"), torch.bfloat16)
    one_s = time.perf_counter() - t1
    first, resumed = runs["first"]["res"], runs["resumed"]["res"]
    steps = {"first": 2, "resumed": 1}
    row = {"phase": "dp_cli", "argv": argv, "world": DP_WORLD,
           "checkpoints": files, "rank_loaders": len(raw.get(
               "rank_loaders", [])),
           "val_map": first.get("val_map"), "one_process_val_map": one,
           "one_process_val_s": one_s,
           "resumed_from": resumed.get("resumed_from"),
           **{name: {"run_s": r["s"], "step_ms": r["res"]["step_ms"],
                     "prefetch_wait_ms": r["res"]["prefetch_wait_ms"],
                     "val_s": r["res"]["val_s"],
                     "rank_launches": r["ranks"]}
              for name, r in runs.items()}}
    emit(row)
    want = [f"{coarse_driver.PREFIX}_{s:06d}.ckpt" for s in (1, 2, 3)]
    check(files == want, f"dp_cli: checkpoints {files} != {want}")
    check(row["rank_loaders"] == DP_WORLD,
          f"dp_cli: {row['rank_loaders']} rank loader positions")
    check(np.isfinite(first["val_map"]) and abs(first["val_map"] - one)
          <= 1e-6 * abs(one), f"dp_cli: val_map {first['val_map']} vs "
                              f"one process {one}")
    check(resumed["resumed_from"]["step"] == 2
          and len(resumed["step_ms"]) == 1,
          f"dp_cli: resumed {resumed.get('resumed_from')}, "
          f"{len(resumed['step_ms'])} steps")
    total: dict = {}
    for name, r in runs.items():
        n_val = len(r["res"]["val_s"])
        for rank, got in enumerate(r["ranks"]):
            want_l = {k: steps[name] * v for k, v in ACT_STEP.items()}
            if rank == 0:
                for k, v in EVAL_CALL.items():
                    want_l[k] = want_l.get(k, 0) + v * DP_CLI_VAL * n_val
            got_l = {k: v for k, v in got.items() if v}
            check(got_l == {k: v for k, v in want_l.items() if v},
                  f"dp_cli {name} rank {rank}: launches {got_l} != {want_l}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
    return total


# ---- the native data plane: frames decoded on the card, packs -----------------

# Synthetic JPEG frames at the 480-pixel side the C++ names ("480p source →
# 224² crop", native/cfn_data.cpp:52), 640×480: noise (the worst case for a
# decoder's rounding) and smooth frames, RGB, quality 90, and grey ones;
# the crops of the path (the centre crop of extraction and validation, two
# train crops) at the path's output size and half of it; baseline frames
# (port_frames a kind) and progressive ones (at the path's output size) on
# the port's own path, card against CPU; nvJPEG's route on the two 640×480
# 4:1:1 fixtures (frames of each a call); the kernel timed on one clip's 64
# frames
DECODE = dict(h=480, w=640, frames=16, port_frames=4, quality=90,
              outs=(224, 112),
              crops=(None, (0.7, 0.3, 0.6), (0.875, 0.9, 0.05)),
              timed_frames=64)
# the committed frames Pillow cannot write (tests/torch_port_jpegs/, made by
# libjpeg through its make_fixtures.py): 160×120 but for the two 640×480
# 4:1:1 ones, quality 90
FIXTURES = REPO / "tests" / "torch_port_jpegs"
PORT_FIXTURES = ("arith_sequential_420.jpg", "arith_progressive_420.jpg",
                 "multiscan_sequential_422.jpg")
# nvJPEG's route: the frames the port's entropy decoder leaves to another
# decoder by their header, sampling factors 3 or 4 on the card (nvJPEG
# reads an RGB transform as YCbCr, so the card refuses those frames): the
# small fixture in fast_decode, and in decode two at the path's 640×480,
# smooth bands and the same with noise over the middle half of each side
NVJPEG_FIXTURE = "sampling_411.jpg"
NVJPEG_KINDS = {"sampling_411_smooth": "sampling_411_smooth_640x480.jpg",
                "sampling_411_noise": "sampling_411_noise_640x480.jpg"}
RGB_FIXTURE = "rgb_transform_444.jpg"
# nvJPEG + crop_resize_kernel against Pillow + crop_resize_plain on the same
# JPEGs, (max, mean) |difference| in uint8 levels over the crops: twice
# what a chip run measured (NVIDIA H100 80GB HBM3, 700 W: smooth (3,
# 0.5090), noisy (4, 0.5047); libjpeg has no fancy filter for 4:1:1, so
# only the IDCTs differ, noise or not; the inputs are fixed and both
# decoders deterministic, so the measure repeats).  The planted fault held
# outside each kind's bound: R and B swapped on the smooth frame (it read
# (244-247, 64.53-67.53) in that run), the crop shifted one pixel on the
# noisy one ((165-243, 13.12-34.96))
DECODE_BOUND = {"sampling_411_smooth": (6, 1.02),
                "sampling_411_noise": (8, 1.01)}
DECODE_FAULT = {"sampling_411_smooth": "swap_rb",
                "sampling_411_noise": "shift_1px"}


def _fixture(name: str) -> bytes:
    with open(FIXTURES / name, "rb") as f:
        return f.read()


def _scans(blob: bytes) -> list:
    """``(first, end)`` byte offsets of each scan's entropy-coded data."""
    out, i, sos = [], 2, None
    while i + 1 < len(blob):
        if blob[i] != 0xFF or blob[i + 1] in (0, 0xFF) or (
                0xD0 <= blob[i + 1] <= 0xD7):
            i += 1
            continue
        if sos is not None:
            out.append((sos, i))
            sos = None
        if blob[i + 1] == 0xD9 or i + 3 >= len(blob):
            break
        end = i + 2 + (blob[i + 2] << 8 | blob[i + 3])
        if blob[i + 1] == 0xDA:
            sos = end
        i = end
    return out


def _cut_frames(blobs: list, progressive: list) -> dict:
    """Frames cut short, as the port decodes them (libjpeg's fill): a
    baseline frame at half its bytes, a progressive one inside its last
    scan; and one the port refuses (a progressive frame cut inside its
    fourth scan, which libjpeg smooths)."""
    last = _scans(progressive[0])[-1]
    fourth = _scans(progressive[0])[3]
    return {"cut_baseline": [b[:len(b) // 2] for b in blobs],
            "cut_progressive_last_scan": [
                progressive[0][:(last[0] + last[1]) // 2]],
            "cut_progressive_smoothed": [
                progressive[0][:(fourth[0] + fourth[1]) // 2]]}


def _jpegs(kind: str, n: int, h: int, w: int, seed: int,
           quality: int = 90, **save) -> list:
    """``n`` seeded JPEG frames of ``kind``: "noise" (uniform RGB),
    "smooth" (three sinusoids of other phases and periods, so R and B
    differ everywhere) or "grey" (a smooth grey pattern); ``save``:
    Pillow's other JPEG options (``subsampling``, ``progressive``)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        if kind == "noise":
            a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        else:
            ph = rng.uniform(0, 2 * np.pi, 3)
            a = np.stack([127.5 + 120 * np.sin(xx / (23 + 9 * c)
                                               + yy / (31 + 7 * c) + ph[c])
                          for c in range(3)], -1).astype(np.uint8)
            if kind == "grey":
                a = a[..., 1]
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "JPEG", quality=quality, **save)
        out.append(buf.getvalue())
    return out


def _pil_frames(blobs) -> torch.Tensor:
    from PIL import Image

    return torch.from_numpy(np.stack([np.asarray(
        Image.open(io.BytesIO(b)).convert("RGB"), np.uint8) for b in blobs]))


def _diff(a: torch.Tensor, b: torch.Tensor) -> tuple:
    d = (a.cpu().to(torch.int32) - b.cpu().to(torch.int32)).abs()
    return int(d.max()), float(d.float().mean())


# threads launching crop_resize_kernel at once, and the calls each makes:
# crops of 16 to 479 pixels need 5,376 to 33,664 bytes of shared memory a
# block (crop_plan), so one thread's limit for the kernel is set while
# another's launch of it is in flight
CROP_THREADS, CROP_THREAD_CALLS = 8, 60


def _crop_threads(fd) -> dict:
    """``crop_resize`` called from ``CROP_THREADS`` threads at once, each
    on a stream of its own with its own random crops, against
    ``crop_resize_plain``: the calls made, those refused (the first
    error), and the largest difference."""
    import threading

    h, w = 480, 1280
    frames = torch.randint(0, 256, (8, h, w, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(37)
                           ).cuda()
    made, refused, diff, lock = [0], [], [0], threading.Lock()

    def worker(seed):
        r = np.random.default_rng(seed)
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            for _ in range(CROP_THREAD_CALLS):
                cw = int(r.integers(16, h))
                box = (int(r.integers(0, w - cw)), int(r.integers(0, h - cw)),
                       cw, cw)
                out = int(r.choice([112, 224, 256]))
                try:
                    y = fd.crop_resize(frames, [box] * len(frames), out)
                except RuntimeError as e:
                    with lock:
                        refused.append(str(e))
                    continue
                d = _diff(y, fd.crop_resize_plain(frames, [box] * len(frames),
                                                  out))[0]
                with lock:
                    made[0] += 1
                    diff[0] = max(diff[0], d)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(CROP_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    return {"threads": CROP_THREADS, "calls": made[0],
            "refused": len(refused), "first_refusal": refused[:1],
            "max_diff": diff[0]}


def _outside(stat: tuple, bound: tuple) -> bool:
    return stat[0] > bound[0] or stat[1] > bound[1]


def phase_decode(fd, native, bounds=DECODE_BOUND) -> dict:
    """The card's decode against the CPU's on synthetic 640×480 JPEGs, in
    the exact mode.  The port's own path (the host entropy decoder,
    ``idct_rgb_kernel`` or its plain version, the crop), card and CPU equal
    (a difference of 0) and no frame to nvJPEG: baseline frames (noise,
    smooth, grey; centre and two random crops, out 224 and 112), progressive
    ones (out 224), frames cut short (a baseline frame, a progressive one
    inside its last scan) and the fixtures Pillow cannot write (arithmetic
    sequential and progressive, sequential in three scans); a progressive
    frame cut earlier, which libjpeg smooths, raises naming it; the
    RGB-transform fixture raises on the card (nvJPEG's raw decode of it
    against Pillow's is reported).  nvJPEG's route, shown on the two
    640×480 4:1:1 fixtures (which the entropy decoder leaves to it by its
    header):
    ``crop_resize_kernel`` against
    ``crop_resize_plain`` on the same frames decoded by nvJPEG (equal bit
    for bit, and the API path equal to the kernel), nvJPEG + kernel against
    Pillow + plain (max and mean |difference|, held to ``bounds``; the
    planted fault, ``DECODE_FAULT``, must read outside them); grey frames
    (three equal channels); ``DECODES`` counting each route's frames.  A
    clip of mixed sizes, kinds and routes (one crop launch a group, the
    frames in order, the port's frames equal to the CPU's, the 4:1:1 ones
    within their bound).  Then the kernel timed at one clip's 64
    frames (the centre crop of extraction, 480² → 224², and a train crop)
    two ways, alone (bare launches, ``queued_ms``: the device's time) and as
    the path calls it (``crop_resize`` back to back), beside its bound, its
    plain version on the card and ``F.interpolate`` (bilinear, no
    antialias) on the f32 crop; frames at an odd pitch (the byte-by-byte
    copies) and a call past ``CROP_BOXES`` (two launches) against the plain
    version; and nvJPEG's decode of the clip beside Pillow's.  Returns the
    kernel line's numbers."""
    prev = fd.set_fast_decode(False)  # the exact mode, which it holds
    try:
        return _decode_exact_path(fd, native, bounds)
    finally:
        fd.set_fast_decode(prev)


def _decode_exact_path(fd, native, bounds) -> dict:
    from coarse_fine_networks_torch.ops import scaled_decode as sd

    c = DECODE
    dev = torch.device("cuda")
    lib = fd.LIBRARY.build()
    h, w = c["h"], c["w"]
    kinds, port = {}, {}
    bits, exact = [], []

    def on_port(label, blobs, out, box_of):
        """The card's decode against the CPU's, and the routes taken."""
        names = [f"{label}{i}" for i in range(len(blobs))]
        fd.reset_launches()
        sd.reset_launches()
        card = fd.decode_crop_resize(blobs, names, out, box_of, dev)
        torch.cuda.synchronize()
        routes = {**fd.DECODES, **sd.LAUNCHES}
        cpu = fd.decode_crop_resize(blobs, names, out, box_of, "cpu")
        exact.append(_diff(card, cpu)[0])
        case = {"out": out, "card_vs_cpu": exact[-1], "routes": routes}
        if label.startswith("grey"):
            case["channels_equal"] = bool(
                (card[..., 0] == card[..., 1]).all()
                and (card[..., 0] == card[..., 2]).all())
        port.setdefault(label, []).append(case)

    # the port's own path: baseline frames of each kind at every crop,
    # progressive ones at the path's output size, frames cut short and the
    # fixtures Pillow cannot write
    progressive = {}
    for kind, seed in (("noise", 1), ("smooth", 2), ("grey", 3)):
        base = _jpegs(kind, c["port_frames"], h, w, seed + 10, c["quality"])
        progressive[kind] = _jpegs(kind, c["port_frames"], h, w, seed,
                                   c["quality"], progressive=True)
        for out in c["outs"]:
            for crop in c["crops"]:
                box_of = (native.center_box if crop is None
                          else native.random_box(*crop))
                on_port(kind, base, out, box_of)
                if out == c["outs"][0]:
                    on_port(f"{kind}_progressive", progressive[kind], out,
                            box_of)
    cut = _cut_frames(_jpegs("noise", 2, h, w, 12, c["quality"]),
                      progressive["noise"])
    for label in ("cut_baseline", "cut_progressive_last_scan"):
        on_port(label, cut[label], c["outs"][0], native.center_box)
    for name in PORT_FIXTURES:
        on_port(name, [_fixture(name)] * 4, 112, native.center_box)
    try:
        fd.decode_crop_resize(cut["cut_progressive_smoothed"], ["smoothed"],
                              224, native.center_box, dev)
        smoothed = ""
    except IOError as e:
        smoothed = str(e)

    # the RGB-transform fixture: refused on the card (nvJPEG would read it
    # as YCbCr), and nvJPEG's raw decode of it against Pillow's
    rgb = [_fixture(RGB_FIXTURE)]
    try:
        fd.decode_crop_resize(rgb, ["rgb_transform0"], 224,
                              native.center_box, dev)
        rgb_refused = ""
    except IOError as e:
        rgb_refused = str(e)
    ctx = fd._DECODERS.acquire()
    try:
        raw = fd._decode_group_cuda(ctx, lib, rgb, ["rgb_transform0"], 3, 120,
                                    160, dev)
        torch.cuda.synchronize()
    finally:
        fd._DECODERS.release(ctx)
    rgb_vs_pillow = _diff(raw, _pil_frames(rgb))

    # nvJPEG's route, on the 640×480 4:1:1 fixtures
    from PIL import Image

    for kind, fixture in NVJPEG_KINDS.items():
        s411 = [_fixture(fixture)] * c["frames"]
        with Image.open(io.BytesIO(s411[0])) as img:
            fw, fh = img.size
        names = [f"{kind}_{i}" for i in range(len(s411))]
        ctx = fd._DECODERS.acquire()
        try:
            raw = fd._decode_group_cuda(ctx, lib, s411, names, 3, fh, fw, dev)
            torch.cuda.synchronize()
        finally:
            fd._DECODERS.release(ctx)
        pil = _pil_frames(s411)
        st = {"size": [fw, fh], "decoded_vs_pillow": _diff(raw, pil),
              "cases": []}
        for out in c["outs"]:
            for crop in c["crops"]:
                box_of = (native.center_box if crop is None
                          else native.random_box(*crop))
                b = box_of(fw, fh)
                boxes = [b] * len(s411)
                k = fd.crop_resize(raw, boxes, out)
                p = fd.crop_resize_plain(raw, boxes, out)
                fd.reset_launches()
                sd.reset_launches()
                api = fd.decode_crop_resize(s411, names, out, box_of, dev)
                torch.cuda.synchronize()
                routes = {**fd.DECODES, **sd.LAUNCHES}
                ref = fd.crop_resize_plain(pil, boxes, out)
                shifted = fd.crop_resize(
                    raw, [(b[0] + 1, b[1], b[2], b[3])] * len(s411), out)
                torch.cuda.synchronize()
                bits.append(max(_diff(k, p)[0], _diff(k, api)[0]))
                st["cases"].append({"out": out, "box": list(b),
                                    "vs_pillow": _diff(k, ref),
                                    "shift_1px": _diff(shifted, ref),
                                    "swap_rb": _diff(k[..., [2, 1, 0]], ref),
                                    "routes": routes})
        st["measured"] = (max(x["vs_pillow"][0] for x in st["cases"]),
                          max(x["vs_pillow"][1] for x in st["cases"]))
        kinds[kind] = st

    # a clip of mixed frames (landscape RGB, baseline and progressive,
    # portrait RGB, grey, and 4:1:1 frames on nvJPEG's route): one crop
    # launch a group, the parts put back in order; the port's frames
    # against the CPU's, the 4:1:1 ones against Pillow + plain within their
    # bound
    parts = [("noise", _jpegs("noise", 2, h, w, 5, c["quality"])),
             ("grey", _jpegs("grey", 2, h, w, 6, c["quality"])),
             ("noise", _jpegs("noise", 2, w, h, 7, c["quality"])),
             ("progressive", _jpegs("noise", 2, h, w, 8, c["quality"],
                                    progressive=True)),
             *((kind, [_fixture(f)]) for kind, f in NVJPEG_KINDS.items())]
    order = [1, 0, 3, 2, 7, 5, 9, 4, 6, 8]  # interleaved: parts scattered
    blobs = [b for _, bs in parts for b in bs]
    kind_of = [k for k, bs in parts for _ in bs]
    blobs, kind_of = [blobs[i] for i in order], [kind_of[i] for i in order]
    mnames = [f"m{i}" for i in range(len(blobs))]
    fd.reset_launches()
    sd.reset_launches()
    got = fd.decode_crop_resize(blobs, mnames, 224, native.center_box, dev)
    torch.cuda.synchronize()
    mixed_launches = {**fd.LAUNCHES, **sd.LAUNCHES, **fd.DECODES}
    cpu = fd.decode_crop_resize(blobs, mnames, 224, native.center_box, "cpu")
    fd.reset_launches()
    sd.reset_launches()
    mixed = []
    for i, b in enumerate(blobs):
        if kind_of[i] in NVJPEG_KINDS:
            pil = _pil_frames([b])
            ref = fd.crop_resize_plain(pil, [native.center_box(
                pil.shape[2], pil.shape[1])], 224)
            mixed.append((kind_of[i], _diff(got[i:i + 1], ref)))
        else:
            exact.append(_diff(got[i:i + 1], cpu[i:i + 1])[0])
            mixed.append(("port", exact[-1]))

    # one clip's 64 frames (noise, the costliest to decode) at the path's
    # crops: the kernel, its plain version, F.interpolate, the decoder
    blobs = _jpegs("noise", 16, h, w, 4, c["quality"]) * (
        c["timed_frames"] // 16)
    n = len(blobs)
    names = [f"t{i}" for i in range(n)]
    ctx = fd._DECODERS.acquire()
    try:
        def decode():
            return fd._decode_group_cuda(ctx, lib, blobs, names, 3, h, w, dev)
        raw = decode()
        torch.cuda.synchronize()
        dec_ms = []
        for _ in range(5):
            t1 = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t1) * 1e3)
    finally:
        fd._DECODERS.release(ctx)
    t1 = time.perf_counter()
    _pil_frames(blobs)
    pil_ms = (time.perf_counter() - t1) * 1e3
    timed = {}
    stream = torch.cuda.current_stream().cuda_stream
    for label, crop in (("centre", None), ("train", (224 / 320, 0.3, 0.6))):
        box_of = (native.center_box if crop is None
                  else native.random_box(*crop))
        x1, y1, cw, ch_ = box_of(w, h)
        # the boxes as decode_crop_resize passes them
        boxes = np.broadcast_to(np.asarray((x1, y1, cw, ch_), np.int64),
                                (n, 4))
        out = 224
        crop_f32 = raw[:, y1:y1 + ch_, x1:x1 + cw].permute(
            0, 3, 1, 2).float().contiguous()
        # the kernel alone: its launch with the wrapper's arguments, no
        # Python around it
        (la,) = fd.crop_launches(boxes, 3, out)
        bare_y = torch.empty((n, out, out, 3), dtype=torch.uint8,
                             device=dev)
        args = (raw.data_ptr(), n, h, raw.stride(1), 3, la.boxes.ctypes.data,
                bare_y.data_ptr(), out, la.plan.rows, la.plan.span, stream)
        bare = queued_ms(lambda: lib.cfn_crop_resize(*args), 50)
        check(lib.cfn_crop_resize(*args) == 0, "decode: a bare launch failed")
        bits.append(_diff(bare_y, fd.crop_resize(raw, boxes, out))[0])
        row = {"crop": label, "frames": n, "box": [x1, y1, cw, ch_],
               "out": out, "plan": la.plan._asdict(),
               "ms": bare["ms"], "launch_host_ms": bare["host_ms"],
               "slept_ms": bare["slept_ms"],
               "call_ms": cuda_ms(lambda: fd.crop_resize(raw, boxes, out),
                                  20),
               "plain_ms": cuda_ms(
                   lambda: fd.crop_resize_plain(raw, boxes, out), 3, 1),
               "library_ms": cuda_ms(lambda: F.interpolate(
                   crop_f32, size=(out, out), mode="bilinear",
                   align_corners=False, antialias=False), 20),
               "library_device_ms": queued_ms(lambda: F.interpolate(
                   crop_f32, size=(out, out), mode="bilinear",
                   align_corners=False, antialias=False), 20)["ms"],
               "library_call": "F.interpolate(bilinear, align_corners=False, "
                               "antialias=False) on the f32 crop (N, 3, ch, "
                               "cw)",
               **_bound(fd.crop_work(bare_y, raw, boxes, out),
                        torch.float32)}
        timed[label] = row
        del crop_f32, bare_y

    # frames the fast copies do not take (an odd pitch: byte by byte), and a
    # call past the boxes' cap (two launches), against the plain version
    rng = torch.Generator(device="cuda").manual_seed(31)
    odd = torch.randint(0, 256, (3, 45, 61 * 3 + 5), generator=rng,
                        device="cuda", dtype=torch.uint8)[
                            :, :, 1:1 + 61 * 3].view(3, 45, 61, 3)
    odd_boxes = [(0, 0, 45, 45), (7, 3, 33, 41), (16, 0, 45, 45)]
    many = torch.randint(0, 256, (fd.CROP_BOXES + 3, 24, 40, 3),
                         generator=rng, device="cuda", dtype=torch.uint8)
    many_boxes = [(i % 9, i % 5, 31 - i % 9, 19) for i in range(len(many))]
    fd.reset_launches()
    extra = {"odd_pitch": _diff(fd.crop_resize(odd, odd_boxes, 37),
                                fd.crop_resize_plain(odd, odd_boxes, 37))[0],
             "past_the_cap": _diff(fd.crop_resize(many, many_boxes, 32),
                                   fd.crop_resize_plain(many, many_boxes,
                                                        32))[0]}
    extra["past_the_cap_launches"] = fd.LAUNCHES["crop_resize_kernel"] - 1
    bits += [extra["odd_pitch"], extra["past_the_cap"]]
    del many
    threaded = _crop_threads(fd)
    fd.reset_launches()
    row = {"phase": "decode", "source": f"{w}x{h} synthetic JPEG, quality "
                                       f"{c['quality']}, "
                                       f"{c['port_frames']} baseline and "
                                       f"progressive frames a kind; "
                                       f"{FIXTURES.name}/ fixtures",
           "kernel_vs_plain_max": max(bits), "card_vs_cpu_max": max(exact),
           "port": port, "smoothed": smoothed[:300],
           "rgb_transform_refused": rgb_refused[:300],
           "rgb_transform_nvjpeg_vs_pillow": rgb_vs_pillow,
           "mixed_clip": {"frames": mixed, "launches": mixed_launches},
           "odd_and_past_the_cap": extra, "threads": threaded,
           "kinds": kinds, "timed": timed,
           "nvjpeg_decode_ms_per_clip": dec_ms,
           "nvjpeg_decode_ms_per_frame": min(dec_ms) / n,
           "pillow_decode_ms_per_clip": pil_ms, "clip_frames": n,
           "bounds": bounds}
    emit(row)
    check(max(bits) == 0, f"decode: crop_resize_kernel differs from its "
                          f"plain version or the API path by {max(bits)}")
    check(max(exact) == 0, f"decode: the card's decode of the port's frames "
                           f"differs from the CPU's by {max(exact)}")
    wrong = [(label, x["routes"]) for label, xs in port.items() for x in xs
             if x["routes"] != {"port": x["routes"]["port"], "nvjpeg": 0,
                                "pillow": 0, "nvjpeg_calls": 0,
                                "idct_rgb_kernel": 1}
             or x["routes"]["port"] < 1]
    check(not wrong, f"decode: the port's frames took routes {wrong[:2]}")
    routed = [x["routes"] for k in NVJPEG_KINDS for x in kinds[k]["cases"]]
    check(all(r == {"port": 0, "nvjpeg": c["frames"], "pillow": 0,
                    "nvjpeg_calls": 1, "idct_rgb_kernel": 0}
              for r in routed), f"decode: nvJPEG's routes {routed[:2]}")
    check("smooths" in smoothed and "smoothed" in smoothed,
          f"decode: a cut progressive frame libjpeg smooths gave "
          f"{smoothed!r}")
    check("YCbCr" in rgb_refused and "rgb_transform0" in rgb_refused,
          f"decode: an RGB-transform frame on the card gave {rgb_refused!r}")
    check(all(x.get("channels_equal", True) for label in ("grey",
                                                          "grey_progressive")
              for x in port[label]),
          "decode: a grey frame's channels differ")
    check(extra["past_the_cap_launches"] == 2,
          f"decode: {fd.CROP_BOXES + 3} frames took "
          f"{extra['past_the_cap_launches']} launches, not 2")
    check(threaded["refused"] == 0
          and threaded["calls"] == CROP_THREADS * CROP_THREAD_CALLS
          and threaded["max_diff"] == 0,
          f"decode: crop_resize from {CROP_THREADS} threads at once: "
          f"{threaded}")
    check(mixed_launches == {"crop_resize_kernel": 4, "idct_rgb_kernel": 3,
                             "port": 8, "nvjpeg": 2, "pillow": 0,
                             "nvjpeg_calls": 1}
          and tuple(got.shape) == (10, 224, 224, 3),
          f"decode: a mixed clip took {mixed_launches} launches, "
          f"shape {tuple(got.shape)}")
    if bounds is not None:
        for kind, st in kinds.items():
            bound = tuple(bounds[kind])
            check(not _outside(st["measured"], bound),
                  f"decode {kind}: nvJPEG + kernel against Pillow + plain "
                  f"{st['measured']} outside {bound}")
            f = DECODE_FAULT[kind]
            missed = [(f, x["out"], x["box"], x[f]) for x in st["cases"]
                      if not _outside(x[f], bound)]
            off = [d for k, d in mixed if k == kind and _outside(d, bound)]
            check(not off, f"decode {kind}: mixed-clip frames outside "
                           f"{bound}: {off}")
            check(not missed, f"decode {kind}: planted faults inside the "
                              f"bound {bound}: {missed[:4]}")
    t = timed["centre"]
    return {"max_abs_err": float(max(bits)), "ms": t["ms"],
            "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"],
            "bound_ms": t["bound_ms"], "bytes_ms": t["bytes_ms"],
            "ops_ms": t["ops_ms"], "train_crop": timed["train"],
            "nvjpeg_ms_per_frame": row["nvjpeg_decode_ms_per_frame"]}


# the decode's pixel kernel: 640×480 synthetic JPEGs of each layout
# (Pillow's subsampling 2 is 4:2:0, 1 is 4:2:2, 0 is 4:4:4; grey frames
# have one component), FAST["frames"] a layout, at the centre crops to 224,
# 112 and 56 (num 4, 2 and 1), two train crops at num 4 (456 → 224 and 336
# → 112), a train crop at 8/8 (420 → 224: the fancy route on subsampled
# chroma) and the raw frame (8/8, the whole frame); 4:4:0 (which Pillow
# cannot write) on seeded coefficients at 8/8 and 4/8; and FAST["clip"]
# frames timed at the two shapes of TIMED
FAST = dict(h=480, w=640, frames=4, quality=90, clip=64,
            layouts=(("noise", 2), ("noise", 1), ("noise", 0),
                     ("smooth", 2), ("smooth", 1), ("grey", None)),
            crops=((224, None, 4), (112, None, 2), (56, None, 1),
                   (224, (0.95, 0.3, 0.6), 4), (112, (0.7, 0.9, 0.05), 4),
                   (224, (0.875, 0.3, 0.6), 8), (0, None, 8)))
# the timed shapes: (label, w, h, crop, out) of one clip of 4:2:0 frames:
# the centre crop of extraction and validation at num 4 and
# a train crop of a 480² pack at 8/8
TIMED = (("centre_num4", 640, 480, None, 224),
         ("train_8of8", 480, 480, (0.875, 0.3, 0.6), 224))
# threads decoding at once (each on its own stream) and the calls each makes
FAST_THREADS, FAST_THREAD_CALLS = 8, 6
_LAYOUT_NAMES = {2: "4:2:0", 1: "4:2:2", 0: "4:4:4", None: "grey"}


def phase_fast_decode(fd, sd, native) -> dict:
    """``idct_rgb_kernel`` on the card (``FAST``'s frames and crops):
    against ``idct_rgb_plain`` on the card on the host entropy decoder's
    coefficients, on both routes (repetition; the fancy filters at 8/8) and
    every layout, and ``decode_crop_resize`` on the card against the CPU's,
    each equal (a difference of 0), one launch of the kernel a call; 4:4:0
    on seeded coefficients, and 4:2:0 on seeded coefficients past the 8-bit
    range at every size (the SIMD IDCT's 16-bit lanes); frames beyond one
    baseline scan (progressive
    ones of three layouts, frames cut short, the arithmetic and multi-scan
    fixtures) at num 4 and 8/8, card against CPU and none to nvJPEG; the
    4:1:1 fixture raises below 8/8 and takes nvJPEG's route at 8/8, the
    RGB-transform fixture raises on the card at 8/8 too;
    ``FAST_THREADS`` threads at once on streams of their own (no launch
    refused, each equal to the CPU).  Then one clip of 64 frames at each of
    ``TIMED``'s shapes: the kernel against its plain version, alone (bare
    launches, ``queued_ms``) beside its bound, its call and its plain
    version on the card; the entropy decoder's ms a frame (1, 4 and 8
    threads) of baseline and progressive noise beside nvJPEG's full decode
    of baseline frames, the pinned copy of the coefficients, the decode
    call; at num 4 also Pillow's ``draft`` decode and the call in the exact
    mode.  Runs in the fast mode and restores the mode after.  Returns the
    kernel line's numbers."""
    prev = fd.set_fast_decode(True)
    try:
        return _fast_decode(fd, sd, native)
    finally:
        fd.set_fast_decode(prev)


def _fast_decode(fd, sd, native) -> dict:
    import threading

    from PIL import Image

    c = FAST
    dev = torch.device("cuda")
    h, w = c["h"], c["w"]
    cases, bits, refs = [], [], []
    for li, (kind, sub) in enumerate(c["layouts"]):
        save = {} if sub is None else {"subsampling": sub}
        blobs = _jpegs(kind, c["frames"], h, w, 40 + li, c["quality"],
                       **save)
        names = [f"{kind}_{li}_{i}" for i in range(len(blobs))]
        p = sd.probe(blobs[0])
        check(p.status == 0, f"fast_decode: {kind} frames refused: {p}")
        for out, crop, num in c["crops"]:
            box_of = (native.center_box if crop is None
                      else native.random_box(*crop))
            box = (0, 0, w, h) if out < 1 else box_of(w, h)
            g = sd.geometry(w, h, p.samp, box, out, 8 if out < 1 else None)
            coefs, qt = sd.entropy_decode(blobs, names, p, g)
            cc, qc = coefs.to(dev), qt.to(dev)
            d_kernel = _diff(sd.idct_rgb(cc, qc, g),
                             sd.idct_rgb_plain(cc, qc, g))[0]
            sd.reset_launches()
            fd.reset_launches()
            card = fd.decode_crop_resize(blobs, names, out, box_of, dev)
            torch.cuda.synchronize()
            launched = {**sd.LAUNCHES, **fd.LAUNCHES}
            cpu = fd.decode_crop_resize(blobs, names, out, box_of, "cpu")
            d_api = _diff(card, cpu)[0]
            refs.append((blobs, names, out, box_of, cpu))
            bits += [d_kernel, d_api]
            shape = (h, w) if out < 1 else (out, out)
            cases.append({"frames": f"{kind} {_LAYOUT_NAMES[sub]}",
                          "out": out, "crop": crop, "num": g.num,
                          "window": [g.height, g.width],
                          "sizes": [x.s for x in g.comps],
                          "fancy": [x.fancy for x in g.comps],
                          "kernel_vs_plain": d_kernel,
                          "card_vs_cpu": d_api, "launches": launched})
            check(g.num == num and tuple(card.shape) == (len(blobs), *shape,
                                                         3),
                  f"fast_decode: {cases[-1]}")
            check(launched == {"idct_rgb_kernel": 1,
                               "crop_resize_kernel": int(out > 0)},
                  f"fast_decode: launches {launched}")
    # 4:4:0 (h 1, v 2 luma) on seeded coefficients: the fancy h1v2 filter
    # at 8/8, repetition at 4/8
    rng = np.random.RandomState(41)
    s440 = ((1, 2), (1, 1), (1, 1))
    for num in (8, 4):
        g = sd.geometry(w, h, s440, (60, 20, 420, 420), 224, num)
        coefs = torch.from_numpy(rng.randint(
            -90, 91, (c["frames"], g.frame_blocks, 64)).astype(np.int16))
        qt = torch.from_numpy(rng.randint(1, 24, (c["frames"], 3, 64)
                                          ).astype(np.int32))
        cc, qc = coefs.to(dev), qt.to(dev)
        d = max(_diff(sd.idct_rgb(cc, qc, g), sd.idct_rgb_plain(cc, qc, g))[0],
                _diff(sd.idct_rgb(cc, qc, g), sd.idct_rgb_plain(coefs, qt,
                                                                g))[0])
        bits.append(d)
        cases.append({"frames": "seeded coefficients 4:4:0", "num": num,
                      "fancy": [x.fancy for x in g.comps],
                      "kernel_vs_plain": d})
    # seeded 4:2:0 coefficients past what 8-bit blocks give (corrupt data,
    # blocks decoded on the zero bits of data cut short): the SIMD code's
    # 16-bit lanes and saturations, and its shortcut (blocks whose rows
    # beside row 0 are zero, or all but row 4 for the 4x4), at every size
    s420 = ((2, 2), (1, 1), (1, 1))
    for num in (8, 4, 2, 1):
        g = sd.geometry(w, h, s420, (60, 20, 420, 420), 224, num)
        shape = (c["frames"], g.frame_blocks)
        coefs = rng.randint(-32768, 32768, (*shape, 64))
        mild = rng.rand(*shape) < 0.5
        coefs[mild] = rng.randint(-300, 301, (int(mild.sum()), 64))
        coefs[rng.rand(*shape) < 0.15, 8:] = 0
        row4 = rng.rand(*shape) < 0.1
        coefs[row4, 8:32] = 0
        coefs[row4, 40:] = 0
        coefs = torch.from_numpy(coefs.astype(np.int16))
        qt = torch.from_numpy(rng.randint(1, 256, (c["frames"], 3, 64)
                                          ).astype(np.int32))
        cc, qc = coefs.to(dev), qt.to(dev)
        d = max(_diff(sd.idct_rgb(cc, qc, g), sd.idct_rgb_plain(cc, qc, g))[0],
                _diff(sd.idct_rgb(cc, qc, g), sd.idct_rgb_plain(coefs, qt,
                                                                g))[0])
        bits.append(d)
        cases.append({"frames": "seeded coefficients past the 8-bit range "
                                "4:2:0", "num": num,
                      "fancy": [x.fancy for x in g.comps],
                      "kernel_vs_plain": d})

    # frames beyond one baseline scan, on the port's path at num 4 and 8/8:
    # card against CPU (equal) and no frame to nvJPEG
    prog = {kind: _jpegs(kind, 2, h, w, 49, c["quality"], progressive=True,
                         **({} if kind == "grey" else {"subsampling": sub}))
            for kind, sub in (("noise", 2), ("smooth", 1), ("grey", None))}
    cut = _cut_frames(_jpegs("noise", 2, h, w, 51, c["quality"]),
                      prog["noise"])
    beyond = {**{f"progressive_{k}": v for k, v in prog.items()},
              "cut_baseline": cut["cut_baseline"],
              "cut_progressive_last_scan": cut["cut_progressive_last_scan"],
              **{name: [_fixture(name)] * 2 for name in PORT_FIXTURES}}
    new_kinds = []
    for label, blobs in beyond.items():
        names = [f"{label}{i}" for i in range(len(blobs))]
        small = label in PORT_FIXTURES  # 160×120: num 4 at 56, 8/8 at 112
        for out, crop in (((56, None), (112, None)) if small else
                          ((224, None), (224, (0.875, 0.3, 0.6)))):
            box_of = (native.center_box if crop is None
                      else native.random_box(*crop))
            sd.reset_launches()
            fd.reset_launches()
            card = fd.decode_crop_resize(blobs, names, out, box_of, dev)
            torch.cuda.synchronize()
            routes = {**sd.LAUNCHES, **fd.LAUNCHES, **fd.DECODES}
            cpu = fd.decode_crop_resize(blobs, names, out, box_of, "cpu")
            bits.append(_diff(card, cpu)[0])
            new_kinds.append({"frames": label, "out": out, "crop": crop,
                              "card_vs_cpu": bits[-1], "routes": routes})
            refs.append((blobs, names, out, box_of, cpu))

    # the 4:1:1 fixture, which the port leaves to the exact mode's decoder:
    # refused and named below 8/8, nvJPEG's at 8/8; the RGB-transform
    # fixture refused on the card at 8/8 too
    s411 = [_fixture(NVJPEG_FIXTURE)]
    try:
        fd.decode_crop_resize(s411, ["sampling_411_0"], 56,
                              native.center_box, dev)
        raised = ""
    except IOError as e:
        raised = str(e)
    fd.reset_launches()
    fd.decode_crop_resize(s411, ["sampling_411_0"], 112, native.center_box,
                          dev)
    s411_routes = dict(fd.DECODES)
    try:
        fd.decode_crop_resize([_fixture(RGB_FIXTURE)], ["rgb_transform0"],
                              112, native.center_box, dev)
        rgb_raised = ""
    except IOError as e:
        rgb_raised = str(e)

    # threads at once, each on its own stream (a loader's workers)
    made, refused, worst, lock = [0], [], [0], threading.Lock()

    def worker(seed):
        r = np.random.default_rng(seed)
        with native.on_device("cuda") as d:
            for _ in range(FAST_THREAD_CALLS):
                blobs, names, out, box_of, cpu = refs[int(r.integers(
                    len(refs)))]
                try:
                    y = fd.decode_crop_resize(blobs, names, out, box_of, d,
                                              num_threads=2)
                except RuntimeError as e:
                    with lock:
                        refused.append(str(e))
                    continue
                dd = _diff(y, cpu)[0]
                with lock:
                    made[0] += 1
                    worst[0] = max(worst[0], dd)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(FAST_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    threaded = {"threads": FAST_THREADS, "calls": made[0],
                "refused": len(refused), "first_refusal": refused[:1],
                "max_diff": worst[0]}

    n = c["clip"]
    names = [f"t{i}" for i in range(n)]
    timed, kern, costs = {}, {}, {}
    for label, tw, th_, crop, out in TIMED:
        box_of = (native.center_box if crop is None
                  else native.random_box(*crop))
        row = {}
        for kind in ("noise", "smooth", "noise_progressive"):
            clip = _jpegs(kind.split("_")[0], 16, th_, tw, 50, c["quality"],
                          progressive=kind.endswith("progressive")) * (
                              n // 16)
            p = sd.probe(clip[0])
            g = sd.geometry(tw, th_, p.samp, box_of(tw, th_), out)
            r = {"frames": n, "jpeg_bytes_per_frame": sum(map(len, clip)) / n,
                 "num": g.num, "window": [g.height, g.width]}
            for nt in (1, 4, 8):
                ts = []
                for _ in range(2):
                    t1 = time.perf_counter()
                    sd.entropy_decode(clip, names, p, g, nt)
                    ts.append((time.perf_counter() - t1) * 1e3)
                r[f"entropy_ms_per_frame_{nt}_threads"] = min(ts) / n
            if g.num < 8:
                sw, sh = sd.scaled_size(tw, g.num), sd.scaled_size(th_, g.num)
                t1 = time.perf_counter()
                for b in clip:
                    with Image.open(io.BytesIO(b)) as img:
                        img.draft("RGB", (sw, sh))
                        img.load()
                r["pillow_draft_ms_per_frame"] = (
                    time.perf_counter() - t1) * 1e3 / n
            if kind != "noise_progressive":
                ctx = fd._DECODERS.acquire()
                try:
                    ts = []
                    for _ in range(3):
                        t1 = time.perf_counter()
                        fd._decode_group_cuda(ctx, fd.LIBRARY.build(), clip,
                                              names, 3, th_, tw, dev)
                        torch.cuda.synchronize()
                        ts.append((time.perf_counter() - t1) * 1e3)
                finally:
                    fd._DECODERS.release(ctx)
                r["nvjpeg_ms_per_frame"] = min(ts[1:]) / n
            for mode in ((True, False) if g.num < 8 else (True,)):
                fd.set_fast_decode(mode)
                ts = []
                for _ in range(3):
                    t1 = time.perf_counter()
                    fd.decode_crop_resize(clip, names, out, box_of, dev,
                                          num_threads=4)
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t1) * 1e3)
                r[f"{'fast' if mode else 'exact'}_call_ms_per_clip"] = min(
                    ts[1:])
            fd.set_fast_decode(True)
            row[kind] = r
        timed[label] = row

        # the kernel alone on the noise clip: bare launches with the
        # wrapper's arguments
        clip = _jpegs("noise", 16, th_, tw, 50, c["quality"]) * (n // 16)
        p = sd.probe(clip[0])
        g = sd.geometry(tw, th_, p.samp, box_of(tw, th_), out)
        coefs, qt = sd.entropy_decode(clip, names, p, g, 8, pin=True)
        cc, qc = coefs.to(dev), qt.to(dev)
        rgb = sd.idct_rgb(cc, qc, g)
        bits.append(_diff(rgb, sd.idct_rgb_plain(cc, qc, g))[0])
        geom = sd.geom_array(g)
        pitch = sd.window_pitch(g)
        buf = torch.empty((n, g.height, pitch), dtype=torch.uint8, device=dev)
        args = (cc.data_ptr(), qc.data_ptr(), n, geom.ctypes.data,
                buf.data_ptr(), g.height * pitch, pitch,
                torch.cuda.current_stream().cuda_stream)
        lib = sd.LIBRARY.build()
        q = queued_ms(lambda: lib.cfn_idct_rgb(*args), 50)
        check(lib.cfn_idct_rgb(*args) == 0, "fast_decode: a bare launch "
                                            "failed")
        bits.append(_diff(buf[:, :, :3 * g.width].view(n, g.height, g.width,
                                                        3), rgb)[0])
        kern[label] = {
            "ms": q["ms"], "launch_host_ms": q["host_ms"],
            "call_ms": cuda_ms(lambda: sd.idct_rgb(cc, qc, g), 20),
            "plain_ms": cuda_ms(lambda: sd.idct_rgb_plain(cc, qc, g), 3, 1),
            "library_ms": None,
            "coefs_copy_ms": cuda_ms(lambda: coefs.to(dev, non_blocking=True),
                                     10),
            "coef_bytes": coefs.numel() * 2, "num": g.num,
            "window": [g.height, g.width],
            **_bound(sd.idct_rgb_work(rgb, cc, qc, g), torch.float32)}
        # the wrapper's Work formula: the same count on the card as on the
        # CPU
        from coarse_fine_networks_torch.utils.hw import program_costs

        for d in ("cuda", "cpu"):
            cd, qd = cc.to(d), qc.to(d)
            costs[label, d] = program_costs(lambda: sd.idct_rgb(cd, qd, g))
        del cc, qc, rgb, buf
    k = dict(kern["centre_num4"])
    k["train_8of8"] = kern["train_8of8"]
    k["max_abs_err"] = float(max(bits))
    sd.reset_launches()
    fd.reset_launches()
    row = {"phase": "fast_decode",
           "source": f"{w}x{h} synthetic JPEG, quality {c['quality']}, "
                     f"{c['frames']} frames a layout",
           "kernel_vs_plain_max": max(bits), "cases": cases,
           "beyond_one_scan": new_kinds, "sampling_411": raised[:300],
           "sampling_411_8of8": s411_routes,
           "rgb_transform_8of8": rgb_raised[:300],
           "threads": threaded, "timed": timed, "kernel": kern,
           "program_costs": costs["centre_num4", "cuda"],
           "timed_at": f"uint8: one clip's {n} frames of 4:2:0 noise: "
                       f"640×480, centre crop 480² → 224² (num 4: a 240² "
                       f"window of 4×4 luma and 8×8 chroma blocks); 480², "
                       f"train crop 420² → 224² at 8/8 (fancy h2v2 chroma)"}
    emit(row)
    check(max(bits) == 0, f"fast_decode: the kernel or the card's path "
                          f"differs by {max(bits)}")
    wrong = [x for x in new_kinds
             if x["routes"] != {"idct_rgb_kernel": 1, "crop_resize_kernel": 1,
                                "port": len(beyond[x["frames"]]),
                                "nvjpeg": 0, "pillow": 0, "nvjpeg_calls": 0}]
    check(not wrong, f"fast_decode: frames beyond one baseline scan took "
                     f"{wrong[:2]}")
    check("sampling factor" in raised and "sampling_411_0" in raised
          and "CFN_EXACT_DECODE=1" in raised,
          f"fast_decode: a 4:1:1 frame gave {raised!r}")
    check(s411_routes["nvjpeg"] == 1 and s411_routes["port"] == 0,
          f"fast_decode: a 4:1:1 frame at 8/8 took {s411_routes}")
    check("YCbCr" in rgb_raised and "rgb_transform0" in rgb_raised,
          f"fast_decode: an RGB-transform frame at 8/8 gave {rgb_raised!r}")
    check(threaded["refused"] == 0 and threaded["max_diff"] == 0
          and threaded["calls"] == FAST_THREADS * FAST_THREAD_CALLS,
          f"fast_decode: {FAST_THREADS} threads at once: {threaded}")
    for label, _, _, _, _ in TIMED:
        check(costs[label, "cuda"] == costs[label, "cpu"]
              and set(costs[label, "cuda"]["kernels"]) == {"idct_rgb"},
              f"fast_decode: program_costs on the card "
              f"{costs[label, 'cuda']} against the CPU "
              f"{costs[label, 'cpu']}")
    return {"idct_rgb_kernel": k}


# the packed path: a Multi-THUMOS tree (generate_mini_charades' frames at a
# 480-pixel side, videos renamed video_validation_* / video_test_*, the
# annotations converted by the port's convert_annotations at 65 classes),
# packed by the port's command line, then extraction and the coarse driver
# from the packs at the train step's shape (B8 T64 224², bf16), 3 steps and
# a validation of 2 videos
PACKED = dict(videos=10, train=8, video_frames=640, hw=480, n_classes=65,
              frames=320, batch=8, workers=4, device_prefetch=2, steps=3,
              val_batches=2)


def _multithumos_tree(root: str, kw: dict) -> str:
    """``generate_mini_charades``' tree as Multi-THUMOS ships it: per-class
    text files and a class list, the videos (directories and frame files)
    renamed ``video_validation_*`` (training) and ``video_test_*``; then the
    port's ``convert_annotations``.  Returns the annotation json."""
    from coarse_fine_networks_torch.data.multithumos import (
        NUM_CLASSES, convert_annotations)
    from coarse_fine_networks_torch.data.synthetic import \
        generate_mini_charades

    anno = generate_mini_charades(root, num_classes=NUM_CLASSES, **kw)
    with open(anno) as f:
        charades = json.load(f)
    frames = os.path.join(root, "frames")
    lines: dict = {}
    count = {"training": 0, "testing": 0}
    for vid, info in sorted(charades.items()):
        count[info["subset"]] += 1
        new = (f"video_validation_{count['training']:07d}"
               if info["subset"] == "training"
               else f"video_test_{count['testing']:07d}")
        src = os.path.join(frames, vid)
        for name in os.listdir(src):
            os.rename(os.path.join(src, name),
                      os.path.join(src, name.replace(vid, new, 1)))
        os.rename(src, os.path.join(frames, new))
        for cls, start, end in info["actions"]:
            lines.setdefault(cls, []).append(f"{new} {start} {end}\n")
    annos = os.path.join(root, "annotations")
    os.makedirs(annos)
    with open(os.path.join(root, "class_list.txt"), "w") as f:
        f.writelines(f"{i + 1} Class{i}\n" for i in range(NUM_CLASSES))
    for cls, rows in lines.items():
        with open(os.path.join(annos, f"Class{cls}.txt"), "w") as f:
            f.writelines(rows)
    return convert_annotations(annos, os.path.join(root, "class_list.txt"),
                               frames, os.path.join(root, "multithumos.json"),
                               fps=24.0)


@contextlib.contextmanager
def _decode_with_pillow():
    """The port's datasets decode with Pillow inside (the baseline the
    driver phase measures), natively again after."""
    from coarse_fine_networks_torch.data import native

    saved = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = saved


def _dataset_clips(root: str, anno: str, packs: str, n: int) -> dict:
    """``CharadesDataset.__getitem__`` on the packed tree's training split
    at the train step's shape (T64 224²), natively from the packs on the
    card against Pillow: clips a second over ``n`` clips (one batch)."""
    from coarse_fine_networks_torch.data import CharadesDataset
    from coarse_fine_networks_torch.train.fine_driver import build_transforms
    from coarse_fine_networks_torch.train import DriverConfig

    c = PACKED
    cfg = DriverConfig(anno=anno, root=root, num_classes=c["n_classes"],
                       frames=c["frames"])
    import random

    out = {}
    for backend in ("native", "pil"):
        random.seed(0)
        ds = CharadesDataset(anno, "training", root,
                             spatial_transform=build_transforms(cfg)[0],
                             frames=c["frames"], gamma_tau=cfg.gamma_tau,
                             num_classes=c["n_classes"], crop_size=224,
                             decode_backend=backend, pack_dir=packs,
                             seed=0, device="cuda")
        ds[0]  # warm: the decoder's context, the library
        t1 = time.perf_counter()
        shapes = [tuple(ds[i % len(ds)]["clips"].shape) for i in range(n)]
        torch.cuda.synchronize()
        s = time.perf_counter() - t1
        out[backend] = {"clips_per_s": n / s, "ms_per_clip": s / n * 1e3,
                        "shapes": sorted(set(shapes))}
    t = c["frames"] // cfg.gamma_tau
    check(out["native"]["shapes"] == out["pil"]["shapes"] == [
        (1, t, 224, 224, 3)], f"decode dataset shapes {out}")
    return out


def phase_packed(mods, fd, sd, tree, driver_row: dict
                 ) -> tuple[dict, int, dict]:
    """The native data plane end to end at full width: the packed
    Multi-THUMOS tree (``tree``: the future of its annotation json), the
    port's pack command line as a process, the dataset's clips a second
    natively from the packs against Pillow, then ``extract_driver.run`` and
    ``coarse_driver.run`` with ``pack_dir`` (X3D-M, 65 classes, B8 T64
    224², bf16, 4 loader workers, device prefetch 2, 3 steps and a
    validation of 2 videos), in the fast mode (the JAX library's default).
    No frame may be decoded by Pillow or read from its JPEG file (both
    raise inside): every clip goes through the port's own decode (the host
    entropy decoder and ``idct_rgb_kernel``) at the JAX library's scale
    (4/8 for the centre crops, 8/8 for the train crops), then
    ``crop_resize_kernel``, on the card; nvJPEG decodes none
    (``DECODES``).  The counters are reset before the extraction and
    before the coarse run and read after each: the extraction launches the
    eval entry's kernels once a video, each train and eval call its route's
    exactly, the crop kernel once per decode call, which launches
    ``idct_rgb_kernel`` once.  Then the same extraction and coarse run in
    the exact mode (8/8 everywhere), for their seconds, step ms and wait
    share, its decodes counted too.  Returns the model kernels' launches,
    the crop-resize kernel's and the decode kernel's."""
    import dataclasses
    import statistics

    from coarse_fine_networks_torch.data import dataset as dataset_mod
    from coarse_fine_networks_torch.data import native
    from coarse_fine_networks_torch.models import FineNet, init_parameters
    from coarse_fine_networks_torch.train import (DriverConfig,
                                                  coarse_driver,
                                                  extract_driver)

    c = PACKED
    root = SCRATCH / "packed"
    frames = str(root / "frames")
    packs = str(root / "packs")
    anno, gen_s = tree.result()
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "coarse_fine_networks_torch.cli.pack_dataset",
         "--root", frames, "--out", packs], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    pack_s = time.perf_counter() - t1
    check(proc.returncode == 0 and f"packed {c['videos']} videos"
          in proc.stdout, f"packed: pack_dataset rc {proc.returncode}: "
                          f"{proc.stdout[-500:]} {proc.stderr[-2000:]}")
    pack_bytes = sum(os.path.getsize(os.path.join(packs, f))
                     for f in os.listdir(packs))
    clips = _dataset_clips(frames, anno, packs, c["batch"])

    fine_pt = str(root / "fine_seeded.pt")
    fine = init_parameters(FineNet("M", c["n_classes"], global_tower=True),
                           torch.Generator().manual_seed(5))
    torch.save({"model_state_dict": fine.state_dict()}, fine_pt)
    feats = str(root / "feats")
    cfg = DriverConfig(
        anno=anno, root=frames, save_dir=str(root / "models"),
        num_classes=c["n_classes"], frames=c["frames"],
        batch_size=c["batch"], compute_dtype="bfloat16",
        num_workers=c["workers"], device_prefetch=c["device_prefetch"],
        max_steps=c["steps"], train_phases_per_val=1,
        max_val_batches=c["val_batches"], kinetics_ckpt=fine_pt,
        fine_feat_dir=feats, pack_dir=packs, resume=False, device="cuda")
    reads = {"files": 0, "packs": 0}

    def no_pillow(*a, **k):
        raise AssertionError("packed: a frame went to Pillow")
    saved_read, saved_pack = native._read_files, native.read_pack_frames

    def read_files(paths):
        reads["files"] += len(paths)
        return saved_read(paths)

    def read_pack(path, indices):
        reads["packs"] += len(indices)
        return saved_pack(path, indices)
    saved_load = dataset_mod.load_clip_frames
    dataset_mod.load_clip_frames = no_pillow
    native._read_files, native.read_pack_frames = read_files, read_pack
    default_fast = fd.fast_decode()
    prev = fd.set_fast_decode(True)
    try:
        for m in mods + (fd, sd):
            m.reset_launches()
        t1 = time.perf_counter()
        n_extracted = extract_driver.run(cfg, feats, fine_pt)
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t1
        extract_launches = _launches(*mods)
        extract_decodes = dict(fd.DECODES)
        extract_crops = fd.LAUNCHES["crop_resize_kernel"]
        extract_fast = {**sd.LAUNCHES, **sd.DECODES}
        for m in mods + (fd, sd):
            m.reset_launches()
        calls: list = []
        t1 = time.perf_counter()
        with _per_call(coarse_driver, {"make_train_step": "train",
                                       "make_eval_step": "eval"}, mods,
                       calls):
            res = coarse_driver.run(dataclasses.replace(cfg))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        run_launches = _launches(*mods)
        run_decodes = dict(fd.DECODES)
        run_crops = fd.LAUNCHES["crop_resize_kernel"]
        run_fast = {**sd.LAUNCHES, **sd.DECODES}
        read_fast = dict(reads)
        # the same extraction and run in the exact mode (every frame at
        # 8/8 on the same path)
        fd.set_fast_decode(False)
        fd.reset_launches()
        sd.reset_launches()
        t1 = time.perf_counter()
        extract_driver.run(cfg, str(root / "feats_exact"), fine_pt)
        torch.cuda.synchronize()
        exact_extract_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        res_exact = coarse_driver.run(dataclasses.replace(
            cfg, save_dir=str(root / "models_exact")))
        torch.cuda.synchronize()
        exact_s = time.perf_counter() - t1
        exact_decodes = dict(fd.DECODES)
        exact_crops = fd.LAUNCHES["crop_resize_kernel"]
        exact_fast = {**sd.LAUNCHES, **sd.DECODES}
    finally:
        fd.set_fast_decode(prev)
        dataset_mod.load_clip_frames = saved_load
        native._read_files, native.read_pack_frames = saved_read, saved_pack
        shutil.rmtree(root / "models", ignore_errors=True)
        shutil.rmtree(root / "models_exact", ignore_errors=True)
        shutil.rmtree(root / "feats_exact", ignore_errors=True)
    want = {k: n_extracted * EVAL_CALL.get(k, 0) for k in extract_launches}
    check(extract_launches == want, f"packed extraction: launches "
                                    f"{extract_launches} != {want}")
    got = _check_calls("packed coarse", calls, run_launches)
    losses = [x["loss"] for x in calls if x["kind"] == "train"]
    share = [wt / st for wt, st in zip(res["prefetch_wait_ms"],
                                       res["step_ms"])]
    crops = extract_crops + run_crops
    exact_share = [wt / st for wt, st in zip(res_exact["prefetch_wait_ms"],
                                             res_exact["step_ms"])]
    row = {"phase": "packed", "model": "X3D-M", "n_classes": c["n_classes"],
           "dtype": "bfloat16 activations, float32 parameters",
           "data": f"Multi-THUMOS layout: {c['videos']} synthetic videos "
                   f"({c['train']} video_validation_*) of "
                   f"{c['video_frames']} frames at {c['hw']}², JPEG, packed "
                   f"by cli.pack_dataset, decoded in the fast mode (the "
                   f"host entropy decoder and idct_rgb_kernel at 4/8 for "
                   f"the centre crops, 8/8 for the train crops) and "
                   f"crop_resize_kernel",
           "fast_mode_by_default": default_fast,
           "B": c["batch"], "crop": 224, "frames": c["frames"],
           "num_workers": c["workers"], "generate_s": gen_s,
           "pack_s": pack_s, "pack_bytes": pack_bytes,
           "dataset_clips": clips, "extract_s": extract_s,
           "videos_extracted": n_extracted, "coarse_run_s": run_s,
           "losses": losses, "step_ms": res["step_ms"],
           "median_step_ms": statistics.median(res["step_ms"]),
           "prefetch_wait_ms": res["prefetch_wait_ms"],
           "prefetch_wait_share": share,
           "median_wait_share": statistics.median(share),
           "driver_on_pillow": {k: driver_row.get(k) for k in (
               "median_step_ms_after_2", "median_wait_share_after_2")},
           "val_s": res["val_s"], "val_map": res.get("val_map"),
           "exact_mode": {"extract_s": exact_extract_s,
                          "coarse_run_s": exact_s,
                          "val_map": res_exact.get("val_map"),
                          "step_ms": res_exact["step_ms"],
                          "median_step_ms": statistics.median(
                              res_exact["step_ms"]),
                          "prefetch_wait_share": exact_share,
                          "median_wait_share": statistics.median(
                              exact_share),
                          "decodes": exact_decodes,
                          "port_decode": exact_fast,
                          "crop_resize_launches": exact_crops},
           "frames_read": read_fast,
           "decodes": {"extract": extract_decodes, "run": run_decodes},
           "port_decode": {"extract": extract_fast, "run": run_fast},
           "crop_resize_launches": {"extract": extract_crops,
                                    "run": run_crops},
           "extract_launches": {k: v for k, v in extract_launches.items()
                                if v},
           "run_launches": {k: v for k, v in got.items() if v}}
    emit(row)
    check(n_extracted == c["videos"], f"packed: extracted {n_extracted}")
    check(len(losses) == c["steps"] and all(np.isfinite(losses)),
          f"packed: losses {losses}")
    check(res.get("val_map") is not None and np.isfinite(res["val_map"]),
          f"packed: val_map {res.get('val_map')}")
    check(reads["files"] == 0 and read_fast["packs"] > 0,
          f"packed: frames read {reads}")
    for part, crop_n, dec, fast in (
            ("extraction", extract_crops, extract_decodes, extract_fast),
            ("coarse run", run_crops, run_decodes, run_fast),
            ("exact mode", exact_crops, exact_decodes, exact_fast)):
        check(fast["idct_rgb_kernel"] == fast["calls"] > 0
              and crop_n == fast["calls"]
              and dec == {"port": fast["frames"], "nvjpeg": 0, "pillow": 0,
                          "nvjpeg_calls": 0},
              f"packed {part}: crop_resize launches {crop_n}, the routes' "
              f"frames {dec} and the port's decode {fast}")
    check(extract_fast["frames"] + run_fast["frames"] == read_fast["packs"],
          f"packed: the port decoded {extract_fast} + {run_fast} frames of "
          f"{read_fast['packs']} read")
    check(len(res_exact["step_ms"]) == c["steps"],
          f"packed: the exact-mode run took {res_exact['step_ms']}")
    launches = {k: extract_launches[k] + got[k] for k in got}
    fast_launches = {k: extract_fast[k] + run_fast[k] for k in FAST_KERNELS}
    return launches, crops, fast_launches


# ---- fault 3.7: which op of the f32 coarse step reorders its sums -------------

_WEIGHTS: dict = {}


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """A fingerprint of a tensor's bits that no summation order changes:
    the int64 sum (wrapping) of its elements' bit patterns (f32 as int32,
    16-bit types as int16), each times a weight of its position, so a
    permutation changes it too."""
    t = t.detach()
    if t.dtype == torch.float32:
        t = t.view(torch.int32)
    elif t.dtype in (torch.bfloat16, torch.float16):
        t = t.view(torch.int16)
    v = t.reshape(-1).to(torch.int64)
    n = v.numel()
    w = _WEIGHTS.get(t.device)
    if w is None or w.numel() < n:
        w = _WEIGHTS[t.device] = torch.arange(
            max(n, 1 << 20), device=t.device) % 65521 + 1
    return (v * w[:n]).sum()


class _OpLog:
    """Every aten op of a run with its inputs' and outputs' fingerprints,
    data pointers and shapes, and every hand-written kernel launch with its
    pointer arguments, in order (a ``TorchDispatchMode`` and a wrapper of
    ``CudaLibrary.call``).  An argument the op writes is an input only
    where the op also reads it (in place, not ``out=``, not a fill)."""

    _ALLOC = ("empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided")
    # in-place ops that overwrite their first argument without reading it
    _OVERWRITE = ("copy_", "fill_", "zero_", "normal_", "uniform_",
                  "bernoulli_", "random_", "exponential_", "set_")

    def __init__(self, device_type: str = "cuda"):
        from torch.utils._python_dispatch import TorchDispatchMode

        log = self.entries = []
        dev = device_type

        def prints(xs):
            return [(_checksum(x), x.data_ptr(), tuple(x.shape)) for x in xs
                    if isinstance(x, torch.Tensor) and x.device.type == dev
                    and x.numel()]

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = func.__name__.split(".")[0]
                schema = func._schema.arguments
                written = {a.name for a in schema if a.alias_info is not None
                           and a.alias_info.is_write}
                read = [a for i, a in enumerate(args)
                        if i >= len(schema) or schema[i].name not in written
                        or name not in _OpLog._OVERWRITE]
                read += [v for k, v in kwargs.items() if k not in written]
                fin = prints(torch.utils._pytree.tree_leaves(read))
                out = func(*args, **kwargs)
                fout = ([] if name in _OpLog._ALLOC else
                        prints(torch.utils._pytree.tree_leaves(out)))
                log.append(("op", str(func), fin, fout))
                return out

        self.mode = Mode()

    @contextlib.contextmanager
    def recording(self):
        from coarse_fine_networks_torch.ops import _build

        saved = _build.CudaLibrary.call
        log = self.entries

        def call(lib, name, *args):
            log.append(("kernel", name, [a for a in args
                                         if isinstance(a, int) and a > 4096],
                        None))
            return saved(lib, name, *args)
        _build.CudaLibrary.call = call
        try:
            with self.mode:
                yield self
        finally:
            _build.CudaLibrary.call = saved


def _same(u, v) -> bool:
    return int(u[0]) == int(v[0])


def _repro_report(a: list, b: list) -> dict:
    """Where two runs' logs part (the first aten op whose inputs or outputs
    differ, and for an input the hand-written kernel that last wrote it),
    which aten ops gave other outputs from equal inputs (by op and input
    shapes), and for each hand-written kernel its launches and those whose
    output differed at its next read although every input it read was
    equal at its last appearance."""
    check(len(a) == len(b) and all(x[:2] == y[:2] for x, y in zip(a, b)),
          f"repro: the two runs' op sequences differ ({len(a)}, {len(b)})")
    first, ops = {}, {}
    last_seen: dict = {}  # pointer -> (entry index, same in both runs)
    per_kernel: dict = {}
    pending: dict = {}  # kernel entry index -> (name, inputs equal)
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] == "kernel":
            ins_equal = all(last_seen[p] for p in x[2] if p in last_seen)
            rec = per_kernel.setdefault(x[1], {"launches": 0, "differ": 0,
                                               "differ_inputs_equal": 0})
            rec["launches"] += 1
            pending[i] = (x[1], ins_equal, set(x[2]))
            continue
        ins = [_same(u, v) for u, v in zip(x[2], y[2])]
        outs = [_same(u, v) for u, v in zip(x[3], y[3])]
        # the first read of a kernel's pointer after its launch
        for k in list(pending):
            name, ins_equal, ptrs = pending[k]
            hit = [j for j, u in enumerate(x[2]) if u[1] in ptrs]
            if hit:
                differ = not all(ins[j] for j in hit)
                per_kernel[name]["differ"] += differ
                per_kernel[name]["differ_inputs_equal"] += (differ
                                                            and ins_equal)
                del pending[k]
        if all(ins) and not all(outs):
            key = (x[1], tuple(u[2] for u in x[2]))
            ops[key] = ops.get(key, 0) + 1
        if not first and not (all(ins) and all(outs)):
            if not all(ins):
                j = ins.index(False)
                ptr = x[2][j][1]
                writer = next((k for k in range(i - 1, -1, -1)
                               if a[k][0] == "kernel" and ptr in a[k][2]),
                              None)
                first = {"index": i, "op": x[1], "what": f"input {j}",
                         "shapes": [u[2] for u in x[2]],
                         "kernel": a[writer][1] if writer is not None
                         else None}
            else:
                first = {"index": i, "op": x[1], "what": "output",
                         "shapes": [u[2] for u in x[2]], "kernel": None}
        for u, ok in zip(x[2], ins):
            last_seen[u[1]] = ok
        for u, ok in zip(x[3], outs):
            last_seen[u[1]] = ok
    return {"first_difference": first,
            "ops_equal_inputs_other_outputs": [
                {"op": k[0], "input_shapes": list(k[1]), "calls": n}
                for k, n in ops.items()],
            "kernels_run_to_run": per_kernel}


def phase_repro(mods) -> dict:
    """Fault 3.7: the f32 coarse step at full width (X3D-M, 157 classes, B8
    T64 224², TF32 off, the act route) run twice from the same weights,
    batch and dropout draws, every aten op and kernel launch logged with
    fingerprints of its data (:class:`_OpLog`): whether the runs repeat bit
    for bit and, if not, the first op whose inputs or outputs part, and the
    kernel or PyTorch op behind it; every aten op that gave other outputs
    from equal inputs; and each hand-written kernel's outputs run to run
    (every launch's output fingerprint at its next read), which must be
    equal wherever the inputs it read were."""
    from coarse_fine_networks_torch.models import CoarseNet, init_parameters
    from coarse_fine_networks_torch.train import TrainState, make_train_step

    c = TRAIN
    model = init_parameters(CoarseNet("M", c["n_classes"], dropout_rate=0.5),
                            torch.Generator().manual_seed(0)).cuda()
    sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = _train_batch("cuda", torch.Generator(device="cuda").manual_seed(1),
                         c["b"], c["t"], c["hw"], c["tf"], c["tl"],
                         c["n_classes"], torch.float32)
    step = make_train_step(model, align_corners=False,
                           fusion_lr_mult=c["fusion_lr_mult"])
    logs, losses, after = [], [], []
    for _ in range(2):
        model.load_state_dict(sd0)
        state = TrainState.create(model)
        drop = torch.Generator(device="cuda").manual_seed(2)
        log = _OpLog()
        with log.recording():
            state, m = step(state, batch, c["lr"], drop)
        torch.cuda.synchronize()
        losses.append(m["loss"].item())
        after.append({k: v.detach().clone()
                      for k, v in model.state_dict().items()})
        logs.append(log.entries)
    a, b = logs
    report = _repro_report(a, b)
    moved = [k for k in after[0] if not torch.equal(after[0][k],
                                                    after[1][k])]
    row = {"phase": "repro", "what": "the f32 coarse act step twice from one "
                                     "state, B8 T64 224², TF32 off",
           "losses": losses, "bit_for_bit": not report["first_difference"],
           "state_tensors_differing": len(moved), **report,
           "log_entries": len(a)}
    emit(row)
    kernels = report["kernels_run_to_run"]
    check(kernels and all(r["differ_inputs_equal"] == 0
                          for r in kernels.values()),
          f"repro: a hand-written kernel's output differs run to run from "
          f"equal inputs: {kernels}")
    return row


def main() -> int:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "coarse_fine_networks_torch").is_dir():
        print("chip_smoke: coarse_fine_networks_torch not found beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from coarse_fine_networks_torch.data import native
    from coarse_fine_networks_torch.ops import (dw_act, dw_conv, dw_mm_act,
                                                dw_mm_bn_train, dw_stencil,
                                                frame_decode, scaled_decode)

    os.environ.pop("CFN_MM_BN_TRAIN", None)  # train_mm sets it for itself
    mods = (dw_act, dw_conv, dw_mm_act, dw_mm_bn_train, dw_stencil)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    try:
        # the driver-level phases' trees are written by worker processes
        # while the kernel phases run
        with ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing
                                 .get_context("spawn")) as pool:
            trees = start_trees(pool)
            per_kernel = phase_kernels(dw_mm_act, dw_conv)
            xl_kernels = phase_xl_kernels(dw_mm_act, dw_conv, dw_stencil)
            phase_relu_branch(dw_mm_act, dw_mm_bn_train)
            per_kernel.update(phase_train_kernels(dw_act, dw_conv,
                                                  dw_mm_act))
            phase_nan(dw_act, dw_conv, dw_mm_act, dw_mm_bn_train)
            per_kernel.update(phase_fine_kernels(dw_conv, dw_stencil))
            per_kernel.update(phase_stencil_kernels(dw_stencil, dw_conv))
            phase_autograd(dw_act)
            phase_fine_autograd(dw_conv)
            phase_stencil_autograd(dw_stencil)
            launches, pipe = phase_serve(
                dw_mm_act, dw_act, dw_stencil,
                {k: per_kernel[k]["launches"] if k in MM_KERNELS else 0
                 for k in dw_mm_act.LAUNCHES})
            phase_profile(pipe, mods)
            del pipe
            phase_card_vs_cpu()
            act_launches, train_row = phase_train(mods)
            launches.update(act_launches)
            torch.cuda.empty_cache()
            phase_utils(mods, smi, train_row)
            torch.cuda.empty_cache()
            phase_train_card_vs_cpu()
            launches.update(phase_fine_train(mods))
            torch.cuda.empty_cache()
            phase_fine_card_vs_cpu()
            per_kernel.update(phase_mm_train_kernels(
                dw_mm_act, dw_mm_bn_train, dw_conv))
            phase_mm_autograd(dw_mm_act, dw_mm_bn_train)
            mm_launches, _ = phase_train(mods, "mm", train_row)
            launches.update(mm_launches)
            torch.cuda.empty_cache()
            phase_train_card_vs_cpu("mm")
            torch.cuda.empty_cache()
            per_kernel.update(phase_t2_kernels(dw_conv))
            torch.cuda.empty_cache()
            launches.update(phase_variants(mods))
            phase_remat(mods)
            torch.cuda.empty_cache()
            phase_repro(mods)
            torch.cuda.empty_cache()
            driver_launches = phase_driver(mods, trees["driver"])
            torch.cuda.empty_cache()
            crop = phase_decode(frame_decode, native)
            torch.cuda.empty_cache()
            fast = phase_fast_decode(frame_decode, scaled_decode, native)
            torch.cuda.empty_cache()
            packed_launches, crop["launches"], fast_launches = phase_packed(
                mods, frame_decode, scaled_decode, trees["packed"],
                DRIVER_ROW)
            torch.cuda.empty_cache()
            # the decode kernels' launches on each later path
            crop_on, fast_on = {}, {k: {} for k in FAST_KERNELS}

            def decoded(path):
                crop_on[path] = frame_decode.LAUNCHES["crop_resize_kernel"]
                for k in FAST_KERNELS:
                    fast_on[k][path] = scaled_decode.LAUNCHES[k]
                frame_decode.reset_launches()
                scaled_decode.reset_launches()
            frame_decode.reset_launches()
            scaled_decode.reset_launches()
            kinetics_launches, kinetics_ckpt = phase_kinetics(
                mods, trees["kinetics"])
            decoded("kinetics")
            torch.cuda.empty_cache()
            fine_driver_launches, fine_ckpt = phase_fine_driver(
                mods, kinetics_ckpt, trees["fine_driver"])
            decoded("fine_driver")
            torch.cuda.empty_cache()
            cli_launches = phase_cli(mods, kinetics_ckpt, fine_ckpt)
            decoded("cli")
            torch.cuda.empty_cache()
            serve_http_launches, xl_launches = phase_serve_http(mods,
                                                                fine_ckpt)
            torch.cuda.empty_cache()
            dp_train_launches = phase_dp_train(mods)
            torch.cuda.empty_cache()
            phase_dp_serve(mods)
            torch.cuda.empty_cache()
            dp_cli_launches = phase_dp_cli(mods)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)

    timed_at = {
        "serve": "bf16 at the serve phase's entry shapes (B=3, 224²; fine "
                 "T_f=128; coarse T=64, then T=17 after Grid Pool), each "
                 "time weighted by its launches in the counted serve run "
                 "and summed",
        "train": "bf16 at the train step's 8 coarse entry shapes (B=8, "
                 "224²; T=64 in layer1, then T=17 after Grid Pool), each "
                 "time weighted by its launches in one train step and "
                 "summed; launches: the 10 timed train steps",
        "mm_train": "bf16 at the train step's 8 coarse entry shapes, as "
                    "train; launches: the 10 timed steps of train_mm",
        "fine": "bf16 at the fine tower's 8 entry shapes in each of "
                "long-cycle phases A-C (B64 T16 112², B32 T32 144², B16 T32 "
                "224²), each time weighted by its launches in one step of "
                "each phase and summed over the three; launches: the 5 "
                "timed steps of each of phases A-C",
        "stem": "bf16 at conv1_t's shape in the coarse train step (B8 T64 "
                "112², C=24, 5×1×1), weighted by its launches per step "
                "(dw_stencil_s1 2: the forward and the dx; dw_stencil_wgrad "
                "1); launches: the 10 timed steps of train (the serve, "
                "train_mm and fine_train phases hold theirs exactly too); "
                "by_path: bf16 at each path's stem shape, weighted by its "
                "launches per step (serve: in its counted run)",
        "t2": "bf16 at FineNet(t_downsample)'s four stride-(2, 2, 2) entry "
              "shapes at B32 T16 224² (conv2's x: T16 112² C54, T8 56² "
              "C108, T4 28² C216, T2 14² C432), one launch each a step, "
              "summed (ms: the wrapper called back to back; device_ms: "
              "the kernel's device time, queued_ms); launches: "
              "the variants phase's two counted t_downsample train steps "
              "and two eval steps",
        "decode": "uint8: one clip's 64 frames of 640×480 decoded by "
                  "nvJPEG, the centre crop 480² → 224² of extraction and "
                  "validation, one launch (the train crop in train_crop); "
                  "ms: the kernel alone (bare launches, queued_ms), "
                  "call_ms: crop_resize as the path calls it, back to "
                  "back, library_ms likewise; launches: the packed phase's "
                  "extraction and coarse run, one a clip",
        "fast_decode": "uint8: one clip's 64 frames of 640×480 4:2:0 "
                       "noise, the centre crop 480² → 224² of extraction "
                       "and validation at num 4 (a 240² window: 4×4 luma "
                       "and 8×8 chroma blocks), one launch (the 480² train "
                       "crop at 8/8 in train_8of8); ms: the kernel alone "
                       "(bare launches, queued_ms), call_ms: the wrapper "
                       "back to back; launches: the packed phase's "
                       "extraction and coarse run in the fast mode, one a "
                       "decode call's group of frames",
        "k7": "bf16 at the train step's four stride-2 entry shapes (B=8; "
              "layer1.0 T64 112² C54, then T=17: 56² C108, 28² C216, 14² "
              "C432), one call each, summed; K7 runs K4 plain's kernel "
              "(plain_s2_fwd_kernel, plan_s2_fwd); launches: 0 in the 10 "
              "timed steps of train, as on every path (the JAX package has "
              "no caller of K7)",
    }
    kernels = []
    for name, agg in per_kernel.items():
        path = ("serve" if name in MM_KERNELS else
                "fine" if name in FINE_KERNELS else
                "mm_train" if name in MM_TRAIN_KERNELS else
                "k7" if name == "dw_stencil_s2" else
                "t2" if name in T2_KERNELS else
                "stem" if name in STENCIL_KERNELS else "train")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": agg["max_abs_err"],
            "max_abs_err_f32": agg["max_abs_err_f32"],
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"],
            "bound_by": ("bytes" if agg["bytes_ms"] >= agg["ops_ms"]
                         else "operations"),
            "library_ms": agg.get("library_ms"),
            **({"unfused_ms": agg["unfused_ms"]}
               if path in ("serve", "train", "mm_train") else {}),
            **({"nearest_call_ms": agg["nearest_ms"],
                "phase_d_ms": agg["phase_d_ms"],
                "phase_d_bound_ms": agg["phase_d_bound_ms"]}
               if path in ("train", "mm_train") else {}),
            **({"by_path": agg["by_path"]} if "by_path" in agg else {}),
            **({"device_ms": agg["device_ms"]} if "device_ms" in agg else {}),
            "driver_launches": driver_launches[name],
            "kinetics_launches": kinetics_launches[name],
            "fine_driver_launches": fine_driver_launches[name],
            "cli_launches": cli_launches[name],
            "serve_http_launches": serve_http_launches.get(name, 0),
            "dp_train_launches_per_rank": dp_train_launches.get(name, 0),
            "dp_cli_launches": dp_cli_launches.get(name, 0),
            "packed_launches": packed_launches[name],
            **({"xl": _xl_entry(xl_kernels[name], xl_launches[name])}
               if name in xl_kernels else {}),
            "timed_at": timed_at[path]})
    kernels.append({
        "name": "crop_resize_kernel", "route": "cuda",
        "source": SOURCES["crop_resize_kernel"],
        "replaces": REPLACES["crop_resize_kernel"],
        "launches": crop["launches"], "max_abs_err": crop["max_abs_err"],
        "ms": crop["ms"], "call_ms": crop["call_ms"],
        "plain_ms": crop["plain_ms"],
        "bound_ms": crop["bound_ms"],
        "bound_by": ("bytes" if crop["bytes_ms"] >= crop["ops_ms"]
                     else "operations"),
        "library_ms": crop["library_ms"],
        "train_crop": {k: crop["train_crop"][k] for k in (
            "box", "ms", "call_ms", "plain_ms", "library_ms", "bound_ms")},
        "nvjpeg_ms_per_frame": crop["nvjpeg_ms_per_frame"],
        "driver_launches": 0, "packed_launches": crop["launches"],
        **{f"{k}_launches": v for k, v in crop_on.items()},
        "timed_at": timed_at["decode"]})
    for name in FAST_KERNELS:
        k = fast[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": fast_launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "call_ms": k["call_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None,
            "train_8of8": {x: k["train_8of8"][x] for x in (
                "window", "ms", "call_ms", "plain_ms", "bound_ms")},
            "driver_launches": 0, "packed_launches": fast_launches[name],
            **{f"{p}_launches": v for p, v in fast_on[name].items()},
            "timed_at": timed_at["fast_decode"]})
    check(len(kernels) == 25, f"{len(kernels)} kernel entries, not 25")
    xl_counts = {k["name"]: (k["xl"]["launches"], k["xl"]["timed_launches"])
                 for k in kernels if "xl" in k}
    check(len(xl_counts) == 3 and all(a == b for a, b in xl_counts.values()),
          f"X3D-XL's launches in the ladder against its timed shapes': "
          f"{xl_counts}")
    idle = [k["name"] for k in kernels
            if not k["launches"] and k["name"] != "dw_stencil_s2"]
    check(not idle, f"kernels of a path launched no time: {idle}")
    emit({"phase": "script", "seconds": time.perf_counter() - t_script})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
