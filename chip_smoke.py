#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jspsr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. environment: the card's name and power limit (nvidia-smi), CUDA
   version; TF32 off for cuDNN and matmul (fp32 means fp32);
2. build: compile every kernel of the served and trained paths from the
   sources in the checkout, one ``nvcc`` per source, all at once (sm_90a),
   printing each one's ``-Xptxas -v`` report (registers, spills); the
   atomic instructions of each kernel of ``deform_bwd.cu``, read from its
   SASS (``cuda_build.sass_atomics``), asserting that none holds a
   compare-and-swap loop (``ATOMS.CAST.SPIN*``: K3's window adds 32-bit
   words, which sm_90a adds natively);
3. kernel check, forward (K1): against its plain PyTorch version on the
   card at the main paths' shapes (336^2 and 1024^2 JSPSR scenes, the
   50, 70 (EDSR, LRRU) and 16 x 128^2 train batches, a 352^2
   CompletionFormer scene, the
   tiled server's chunks of 72, 81 and 28 x 128^2), untimed at the eval
   loop's (each config's valid batch of 128^2 samples, phase 10), at the
   whole scenes of phases 11-12 as their models pad them (EDSR+SPN's 334^2,
   unpadded, and LRRU's 244 x 346 scene at 256 x 352) and at
   two shapes that its tile does not divide (2 x 13 x 20, and 1 x 333 x
   335, whose W % 4 != 0 takes the copy path in place of TMA), offsets at
   0, 1.5 and 20 px (rtol = atol = 1e-5: the same fp32
   arithmetic, only the order of the 9-term sum differs); at each, the
   share of corners read from the tile's shared-memory window and from
   global memory (``deform_cuda.fwd_window``); the main shapes timed with
   CUDA events (``bench_deform_fwd.time_ms``: median of 25 runs, L2
   flushed before each) beside its plain version, a PyTorch library call
   that computes the same function, and its bound on this card; then the
   wrapper's host µs per call (1,000 calls, no synchronise);
   K1's bf16-sampling mode (``spn_sample_dtype``, ``deform_fwd_bf16``)
   the same way (``check_deform_kernel(..., sample_dtype)``) at 336^2,
   1024^2, 50 and 16 x 128^2, 1 x 333 x 335 (the copy path) and the eval
   loops' shapes (phase 13's 1 x 128^2), offsets at 0, 1.5 and 20 px,
   rtol = atol = 1e-5 (the same roundings), its distance from the fp32
   mode at 1.5 px
   above that tolerance (the mode really rounds), the four main shapes
   timed beside the fp32 mode on the same inputs, the plain version, the
   fp32 ``grid_sample`` form and K1's bound (the same bytes move);
3b. kernel check, backward (K2): against its plain backward at the train
   batches (50 and 70 x 128^2), 16 x 128^2 and one 334^2 scene, offsets
   at 0, 1.5
   and 20 px; d_offset and d_mask at rtol = atol = 1e-5 (the same fp32
   arithmetic per element); the batch-summed d_weight within 1e-5 of the
   sum of its terms' magnitudes (it sums B*H*W terms in another order);
   timed as K1, the library yardstick being autograd's backward through
   the ``grid_sample`` form; then its bf16-sampling mode
   (``deform_bwd_bf16``) the same way at 50 and 16 x 128^2 and one 334^2
   scene, beside the fp32 mode on the same inputs, from which its
   d_offset must differ by more than the tolerance; in both modes every
   output bit-identical over three calls on the same inputs, and, after
   every phase (the profiler slows the process it traces), exactly one
   device kernel per call, counted in a process of its own
   (``bench_deform_bwd.kernels_per_call``: no memset, no reduction;
   d_weight and d_bias are finished in K2's launch);
3c. kernel check, backward with the input gradient (K3): against its
   plain backward at the CompletionFormer train batch (16 x 128^2),
   2 x 128^2 and one 334^2 scene padded to 352^2, offsets at 0, 1.5 and
   20 px; d_offset and d_mask at rtol = atol = 1e-5; d_weight and d_x
   within 1e-5 of the sums of their terms' magnitudes (``DX_ERR_LIMIT``:
   d_weight sums in another order, d_x in fixed point), each shape's d_x
   error printed beside that limit; and against itself: two launches on
   the same inputs must give bit-equal d_x, d_offset, d_mask, d_weight
   and d_bias; then, at 20 px, a heavy-tailed g (``HEAVY_TAILS``: a few
   entries 10^4 and 10^6 times the rest, which set the fixed point's
   scale), d_x and d_weight within the same limit and bit-equal across
   two launches; timed as K2, the library yardstick being autograd's
   backward through the ``grid_sample`` form with ``x`` requiring grad,
   and, after every phase, the device time of its one kernel (the zero
   fill and bounds, the scatter and the pass back to fp32 are phases of
   one cooperative launch) read by name from ``torch.profiler``
   (``bench_deform_bwd_dx.kernels_per_call`` in a process of its own, with
   K2's count), and exactly one device kernel per call in each mode,
   whole and on a slab, on the TMA and the copy path, counted there too
   (no memset, no reduction);
   its bounds come from ``bench_deform_bwd_dx``; where this run's d_x
   contributions go
   (``deform_cuda.dx_atomics``: into the block's shared-memory window, or
   global, and the window's flush) is counted at every offset scale and
   printed per shape beside the one global atomic per in-bounds corner
   that a scatter without the window sends;
3d. K3's bf16-sampling mode (``deform_bwd_dx_bf16``) at K3's shapes and
   offset scales against its two halves on the same inputs: d_x bit-equal
   to fp32 K3's, d_offset and d_mask bit-equal to K2-bf16's, d_weight
   within 1e-5 of K2-bf16's magnitude sum; against its plain version as
   K3 is held; timed beside fp32 K3, the plain version and the library
   form, with K3's bound; then once through the op's autograd
   (``deform_conv2d(x requiring grad, ..., sample_dtype="bfloat16")
   .sum().backward()``: one K1-bf16 and one K3-bf16 launch, the path
   ``k3_bf16_autograd``; and on a row slab with ``y0``, one K1-bf16 and
   one K3-bf16 on a slab, the path ``k3_bf16_slab_autograd``: no shipped
   model samples in bf16 with the input's gradient);
3e. K1 and K2 on row slabs (``y0``, counted as ``deform_fwd_slab`` and
   ``deform_bwd_slab``) at phase 17's slabs (K1 at 1 x 256 x 512 of a
   512^2 image and 2 x 64 x 128 of a 128^2 one, K2 at the latter), each
   slab of the mesh, offsets at 0, 1.5 and 20 px: against their plain
   versions with the same row origin (as 3 and 3b), and bit for bit
   against the whole-image kernel (the slab's output, d_offset and d_mask
   are those rows of it; ``y0=0`` on the whole image is it; the slabs'
   d_weight and d_bias sum to its within 1e-6 of the terms' magnitude
   sums), timed beside
   the plain version, the ``grid_sample`` form on the slab and the slab's
   bound; then the same in the bf16-sampling mode (``deform_fwd_bf16_slab``,
   ``deform_bwd_bf16_slab``, against the whole-image bf16 kernel), with
   one slab more: 25 x 64 x 128, the shipped bf16 batch of 50 on the mesh;
   K2's slab outputs bit-identical over three calls, one device kernel per
   call, as in 3b; then K3 and K3-bf16 on row slabs (``deform_bwd_dx_slab``,
   ``deform_bwd_dx_bf16_slab``, ``check_k3_slabs``) at 2 x 64 x 128 of
   128^2 (phase 17's gradient slab) and 8 x 64 x 128 (the shipped
   CompletionFormer batch of 16 on the mesh), each y0, offsets at 0, 1.5
   and 20 px: d_offset and d_mask bit-equal to those rows of the
   whole-image K3's, each slab against its plain version (d_x, the whole
   image's, and d_weight within 1e-5 of their magnitude sums), bit-equal
   across two launches, and the slabs' d_x and d_weight summed within
   1e-6 of the whole image's magnitude sums; timed beside the plain
   version, the library form and the slab's bound; then K3 on an empty
   batch and on empty slabs (no rows, at y0 = 0 and at y0 = H), each
   mode, after a NaN tensor of d_x's size was freed (``k3_empty_slabs``):
   zero d_x, d_weight and d_bias, no launch counted;
4. serving: the flagship JSPSR (configs/jspsr_r8_img_msk.yml: lr_dem +
   RGB + 15-channel mask, num_feature 32, num_block 2) at full width with
   seeded random weights and non-trivial BatchNorm statistics, serving a
   directory of five scenes (4 x 334^2, 1 x 1024^2) through the port's
   CLI (``--infer``), with the kernel launch counts read around that run;
   then one 334^2 scene on the card against the port on the CPU
   (rtol 1e-4 / atol 2e-5, the JAX suite's whole-model tolerance);
5. training: the same config, read from configs/jspsr_r8_img_msk.yml, on
   a synthetic DFC30 tree with its 13 train cities (12 samples of 128^2
   each, the 8 m DFC30 sample size, which the config's tile crop keeps
   whole: 3 steps of batch 50 per epoch, flip/rot90 augmentation) and its
   3 valid cities, through
   ``Trainer(p, device="cuda").train_one_epoch`` for epochs 0 and 1, with
   the launch counts read around that run (exactly one K1 and one K2 per
   step); then one full-width train step on 4 x 128^2 on the card against
   the port on the CPU, and both against the CPU in float64, from the same
   weights and batch: the loss within rtol 1e-4 of the CPU's; every
   gradient and BatchNorm running statistic no further (relative L2) from
   float64 than three times the CPU fp32 run's distance plus 5e-3 (the
   step is ill-conditioned in fp32 at init, see ``CARD_FP64_FLOOR``); the
   largest errors are printed; then one step at the train batch run twice
   from the same weights and batch: with cuDNN held to deterministic
   algorithms (the Trainer's ``set_deterministic_cudnn``) and K1 and K2
   free of atomics, every parameter and BatchNorm buffer must come out
   bit-equal; the warm step median is printed beside the one of a further
   epoch through the same Trainer with cuDNN free to choose
   non-deterministic algorithms (in every training phase);
6. CompletionFormer training: configs/completionformer_r8_img_msk.yml as
   it is (PVT backbone + NLSPN, 83,689,176 parameters, batch 16, drop
   path on) on the same synthetic tree (9 steps of 16 per epoch) through
   ``Trainer(p, device="cuda").train_one_epoch`` for epochs 0 and 1, with
   exactly 6 K1 and 6 K3 launches and no K2 per step (NLSPN's 6
   propagation steps on a feature that needs its gradient); then one train
   step at 2 x 128^2 held against the CPU and float64 by the same rule
   (the CBAM SpatialAttention convs' weight gradients at a wider floor,
   ``SA_CONV_FLOOR``), from the seeded weights with NLSPN's
   offset/affinity conv perturbed away from its zero init (which makes the
   propagation the identity); then one step run twice from one state, as
   in phase 5, which must come out bit-equal in all 783 parameters and
   buffers (K3 sums d_x in fixed point, the resizes' backward is two
   matrix products, NLSPN's confidence sampling differentiates through
   sorted indexing);
7. CompletionFormer serving: one 334^2 scene (padded to 352^2, the
   backbone's /32) through the CLI's ``--infer`` with a seeded checkpoint
   whose BatchNorm statistics and offset/affinity conv are perturbed:
   exactly 6 K1 launches, and the card against the CPU at rtol 1e-3 /
   atol 1e-4 (the JAX suite's CompletionFormer tolerance, for outputs in
   the scaled DEM's [0, 1]), atol times the output's largest magnitude
   (random weights put it above 1);
8. K4 kernel check: ``conv_same`` against ``conv_same_plain`` on the card
   at the TPU probe's four cases (16 x 128^2 at 64->64 in bf16 and fp32,
   32->64 and 64->32 in bf16), at the probe's tolerances (max |err| <=
   0.03 in bf16, 1e-4 in fp32, times max(1, max |plain|)), timed as K1
   beside the plain version, cuDNN's ``F.conv2d`` on the channels-last view
   of the same bytes and the bound, with the kernel's time over cuDNN's
   and both achieved TFLOP/s; then the probe's port
   (``jspsr_torch/scripts/bench_conv_same.py``) once, its launches counted
   on the path ``conv_probe``;
9. tiled serving: the flagship with phase 4's checkpoint through the CLI's
   ``--infer --tile``: (a) a directory of 8 x 334^2 scenes, (b) one of 2 x
   1024^2 scenes, each run twice through the pipelined server, (c) one
   500 x 700 scene (an exact grid down, a padded generalized grid across)
   on its own; K1 launches exactly the rule's count per run (the sum over
   scene groups of ceil(S * n / infer_tile_batch): 1, 2 and 1 with the
   defaults); every served raster against the same scene through
   ``tile_inference_device`` on the card at rtol 2e-4 / atol 5e-3 m (the
   JAX suite's tolerance between tile batch sizes, which change cuDNN's
   reduction order); one 334^2 scene and scene (c) on the card against the
   port on the CPU at rtol 1e-3 / atol 1e-2 m (test_torch_infer.py's
   rtol for metres); warm scenes/s, one 1024^2 scene's warm end-to-end ms
   through ``--tile`` against whole-scene (best of 5) and the peaks;
10. fit: the flagship config as it is but its epochs (300 -> 2, printed
   as a cut) on phase 5's tree (its 3 valid cities at 4 samples each)
   through ``Trainer(p, device="cuda").fit(initial_eval=True)``: the best
   checkpoint named with its RMSE, one raster per valid sample under
   ``predictions/``, ``summary.json`` and ``summary.csv``, one
   ``metrics.jsonl`` line per epoch, and exactly one K1 and one K2 per
   step plus one K1 per sample of each of the 4 eval passes; then --val
   through the port's CLI on that checkpoint (its scores equal to the
   final eval's at rtol 1e-5), the checkpoint evaluated by the port on
   the CPU (rtol 1e-4, the JAX package's reload tolerance); then the
   resume gate for the flagship and for CompletionFormer (on its first
   GATE_CF_CITIES train cities): a fit of 2
   epochs against a fit of 1 whose checkpoint a new Trainer resumes to
   epoch 2, their last parameters and buffers, best result and epoch
   losses bit-equal; each epoch's and each eval pass's seconds; then the
   preemption gate (``save_every_steps: 2``) for the flagship on the host
   feed with the asynchronous checkpoint backend (``checkpoint_backend:
   orbax``: the fit above is its uninterrupted run) and the bf16 flagship
   from its device cache with the .npz one: an uninterrupted fit against
   a fit preempted right after epoch 0's mid-epoch save (the flagship) or
   a step past epoch 1's (the bf16 flagship, ``PREEMPT_CASES``),
   relaunched in its result dir (resumed at step 2, no initial eval),
   every parameter and buffer, the losses of the epochs it ran, the best
   result and the final eval bit-equal, the ms each save held the step
   loop printed; (phase 15 runs the ``profile_steps`` leg);
11. EDSR: configs/edsr_r8_img.yml (16 blocks x 64, batch 70) as shipped
   and with ``spn: true``, each trained one epoch (``CUT_EPOCHS``) on
   phase 5's tree
   through the Trainer (no K1/K2 launch as shipped; one K1 and one K2 per
   step with the head), its step against the CPU and float64 and twice
   from one state (bit-equal), as in phase 5; then a seeded checkpoint of
   each served through the CLI's ``--infer`` over phase 4's directory
   (K1 once per scene with the head) and ``--infer --tile`` over phase
   9's 8 x 334^2 (K1 once per chunk with the head), the card against the
   CPU in float64 (``hold_to_float64``: the tolerance plus three times the
   CPU fp32 run's distance from float64) at rtol 1e-4 / atol 2e-5 (the
   first whole scene, the scaled output, atol times its largest
   magnitude, at least 1) and, with the head, phase 9's rtol 1e-3 / atol
   1e-2 m (the last served raster, ``SERVED_FP64``), and every served
   raster against its scene alone as in phase 9;
12. LRRU: configs/lrru_r8_img.yml as shipped (20,843,342 parameters,
   batch 70) trained the same way, with exactly 4 K1 + 1 K2 per step and
   no K3; its step against the CPU and float64 and twice from one state
   on DEMs with 3 % of their pixels at no data (``LRRU_HOLES``: where the
   DEM is > 0, ``preserve`` puts the input back before each round, and
   rounds 1-3 could not show); after one step, every parameter of the
   heads of rounds 1-3 with a zero gradient and AdamW's step taken on
   every parameter; then a seeded checkpoint served, on scenes with 3 %
   of their DEM in contiguous voids at -80 m (0 on the serving config's
   linear scale), by
   ``--infer`` over 4 x 334^2 and 1 x 1024^2, then one 244 x 346 scene
   (padded to 256 x 352, LRRU's /16), 4 K1 per scene, and ``--infer
   --tile`` over 8 x 334^2 (4 K1 per chunk), held as in phase 11 at the
   LRRU tolerance, rtol 1e-4 / atol 3e-5 (scaled, times the output's
   largest magnitude; in metres atol x 1009 m, the served rasters being
   clipped to [0, 1]), on two whole scenes and the last served raster,
   and every served raster against its scene alone at twice the atol
   that one was held to float64 at (both are card runs held that
   close to float64; a batch of 72 tiles and one of 9 take other cuDNN
   algorithms, ``LRRU_ATOL``);
13. the mixed-precision flagship: configs/jspsr_r8_img_msk_bf16.yml as
   shipped (43,869,763 parameters, bf16 body, ``device_normalize``,
   ``pack_mask``, ``device_cache``), on phase 5's tree: (a) ``fit`` for
   2 epochs (a cut of 300) with the initial eval, the train split
   resident in the device cache (no fallback line), exactly one K1 and
   one K2 per step and one K1 per eval sample in the fp32 sampling mode;
   the warm step, tiles/s, the peak memory and the cache's resident
   bytes printed; (b) one step at batch 50 twice from one state with
   deterministic cuDNN, bit-equal in every tensor (the phase names any
   that differ); (c) the first batch of epoch 0 from the device cache
   against the raw host feed's (``device_cache: false``): raw crops and
   bases bit-equal, normalised within 2e-6; then one epoch of each, the
   losses at rtol 2e-4; (d) (a) and (b) with ``spn_sample_dtype:
   bfloat16`` at one epoch: K1 and K2 launch only in their bf16 modes;
   (e) a seeded checkpoint of the bf16 model through ``--infer`` over
   phase 4's directory and ``--infer --tile`` over phase 9's 8 x 334^2,
   held in the scaled domain to the float64 forward of the same weights
   with the fp32 body by ``hold_to_float64`` (``BF16_TOL_SCALED``), and
   every served raster to its scene alone on the card
   (``BF16_SERVED_ATOL``);
14. export: phase 4's seeded flagship checkpoint through the CLI's
   ``--export`` (traced on the card), loaded in a fresh process that
   imports ``torch`` and the op library alone, run at 1, 50 and 72 x
   128^2 against the eager model of the same weights (rtol = atol =
   1e-5, TF32 off, cuDNN's deterministic algorithms), exactly one K1 per
   call; a CPU-traced artifact moved to the card bit-equal to the
   card-traced one; the artifact and the eager model at batch 50 timed
   in turns; export seconds and artifact MB; then the same, but for the
   CPU trace, for a seeded bf16 flagship with ``spn_sample_dtype:
   bfloat16`` (K1-bf16 only);
15. JSPSR's execution options and the keys ported last: (a) phase 4's
   checkpoint with ``fuse_stems``, ``eval_grouped`` and both against the
   separate path on the card (cuDNN's defaults), at 1 and 72 x 128^2 and
   phase 4's first 334^2 scene, rtol 1e-4 / atol 2e-5 (the convs
   regrouped, the precision fp32), one K1 per forward, each timed (median
   of ``TIME_REPEATS``); (b) one step from one state at the train batch with ``remat``
   and with ``remat_stages`` against the step without (the flagship at
   50, deterministic cuDNN: 2 K1 + 1 K2 and 1 K1 + 1 K2), and
   CompletionFormer's at 16 with ``remat`` (12 K1 + 6 K3, drop path from
   the step's generator): every parameter, buffer and AdamW moment
   bit-equal, the warm step's ms and the peak memory printed; (c) one
   flagship epoch with ``prefetch_split: false`` bit-equal to the split
   one, both epochs' seconds; (d) a seeded ``lr_dem + image + coord``
   JSPSR serving phase 4's 4 x 334^2 scenes through ``--infer``, whole (a
   K1 per scene) and ``--tile`` (a K1 per chunk), one scene against the
   port on the CPU at rtol 1e-4 / atol 2e-5; (e) one epoch of
   configs/jspsr_r3_img_msk.yml on one 334^2 sample per train city (its
   tile crop: 9 x 128^2 each), one K1 and one K2 per step, its first 2
   steps under ``profile_steps``, whose trace must name K1's and K2's
   kernels (last: the profiler slows the process it traces);
16. data parallelism (``jspsr_torch/parallel/``): (a) the flagship at
   full width from one seeded state on the first 9 train cities of phase
   5's tree (108 samples): two ``Trainer`` steps of 50 in this process,
   then two ranks of 25 on the same rows, two processes sharing this card
   in a gloo group (``parallel.spawn.run_ranks``; NCCL refuses two ranks
   on one GPU) through the gradient all-reduce and the cross-process
   BatchNorm: step losses within rtol 1e-4, the sum of every |parameter|
   within rtol 1e-5 (``tests/test_multihost.py:148-155``), the ranks'
   losses and parameters bit-equal, one K1 and one K2 per step on each
   rank; (b) one flagship epoch through the CLI with ``distributed:
   true`` and ``distributed_kwargs`` (a group of one on ``nccl``, its
   first step profiled: the trace names ProcessGroupNCCL's
   ``nccl:all_reduce``) against the same CLI run without it, at the same
   bounds, bit-equality printed; then warm steps at 50 in turns without,
   with and again without an NCCL group of one in this process (the
   data-parallel path's cost per step); (c) inference over the mesh
   ``[cuda:0, cuda:0]``: ``eval_model`` on phase 5's 12 valid samples in
   batches of 4 against ``mesh=None`` (3e-4, as ``dryrun_multichip``;
   twice the K1 launches), and ``serve_scenes`` over phase 9's 8 x 334^2
   against ``mesh=None`` at rtol 1e-3 / atol 1e-2 m (one 72-tile chunk in
   two launches of 36); (d) ``parallel.dryrun.dryrun_multichip(2,
   "cuda")`` (its ranks share the card through gloo), 4 K1 and 1 K2 on
   each rank, and its 2-D leg (the two ranks as a 1 x 2 mesh, the tiny
   flagship's eval forward spatially sharded against the same forward in
   each rank alone, rtol 1e-4 / atol 1e-5). Phase 3 holds K1 and K2 at
   phase 16's shapes too (``dp_shapes``);
17. spatial sharding (``parallel.mesh.make_2d_mesh``,
   ``spatial_sharding``, ``parallel/spatial.py``): phase 4's full-width
   flagship checkpoint, fp32, TF32 off, on a 2 x 2 (data x space) mesh of
   four gloo ranks sharing the card: (a) the eval forward at 2 x 512^2,
   each rank a 1 x 256 x 512 slab, gathered, against one process on the
   whole batch at rtol 1e-4 / atol 1e-5; (b) the gradients of the
   config's loss in train mode at 4 x 128^2, summed over the mesh,
   against one process (losses rtol 1e-5, every gradient within 5e-2
   relative L2, ``SPATIAL_GRAD_REL_L2``), every rank's bit-equal; each
   twice, with each run's launches (one K1 on a slab per forward, one K1
   and one K2 on a slab per gradient, on every rank) and seconds through
   gloo (a correctness run, not a scaling figure); then, once each, the
   other cases (``SPATIAL_CASES``), each against one process on the card
   that rank 0 runs after it: the shipped bf16 flagship
   (configs/jspsr_r8_img_msk_bf16.yml, phase 4's weights) and the same
   with ``spn_sample_dtype: bfloat16`` (within twice the one-process bf16
   model's distance from its fp32 one), the fp32 flagship with
   ``fuse_stems`` and ``eval_grouped`` (forward) and ``remat_stages``
   (gradients), EDSR (configs/edsr_r8_img.yml) with and without ``spn``,
   LRRU (configs/lrru_r8_img.yml, LRRU_HOLES of voids; its forward at 2 x
   256², held to float64 on the CPU), the flagship's gradients under
   L1 + BerHu + SSIM + TV, and CompletionFormer as shipped
   (configs/completionformer_r8_img_msk.yml, seeded and perturbed: PVT
   attending over the gathered keys, NLSPN's 6 steps on the gathered
   feature, 6 K1 on a slab per forward, 6 K1 and 6 K3 on a slab per
   gradient); each case's launches exact on every rank.
18. summary and trace (``utils/summary.py``), in a process of its own
   (in this one, after a process group and other profiler runs, the
   profiler's events came back without their device): phase 4's
   full-width flagship checkpoint under configs/jspsr_r8_img_msk.yml at
   its train batch, 50 x 128^2. (a) ``model_summary`` on the card: TOTAL
   the JAX model's count (``FLAGSHIP_PARAMS``), the output line ``(50, 1,
   128, 128) torch.float32``, the forward FLOPs equal, as an integer, to
   the same model's on the CPU, no device memory allocated (the
   allocator's peak over the call is what it held before it; the
   process's first fake tensor on the card, in an earlier call, probes
   the CUDA context with a 512-byte ``torch.empty(1)`` that is freed at
   once) and no kernel launched; (b) ``trace_step`` around one warm fp32 train step
   and around one eval forward: the step's trace holds exactly one
   ``deform_fwd_kernel`` and one ``deform_bwd_kernel``, the forward's one
   ``deform_fwd_kernel`` and no K2, the traced step's losses and every
   parameter and buffer bit-equal to an untraced step's from the same
   state, the traced forward's output to an untraced one's; (c) the
   step's FLOPs counted (``count_flops``, one more step from the same
   state: the convolutions' forward and backward and the deform forward;
   the deform backward has no formula and is left out); (d) ``entry()``
   on its default device, the card: its forward at 1 x 128^2 launches
   exactly one K1 (counts set to 0 just before) and matches
   ``entry("cpu")`` on the same seeded weights at rtol 1e-4, atol 2e-5.
   It prints the top 5 device kernels of the step by summed time, the
   device's busy share over the traced step's window (the union of its
   kernels' intervals over the ``trace_step`` span), the FLOPs per second
   of the eval forward and of the step (the counted FLOPs over the
   untraced warm step's time), each with the card's name and power limit,
   and its own time.

It prints ``{"serving": ...}``, ``{"training": ...}``,
``{"cf_training": ...}``, ``{"cf_serving": ...}``, ``{"tiled_serving":
...}``, ``{"fit": ...}``, ``{"edsr": ...}``, ``{"lrru": ...}``,
``{"bf16": ...}``, ``{"export": ...}``, ``{"options": ...}``,
``{"data_parallel": ...}``, ``{"spatial": ...}``, ``{"summary_trace":
...}`` (each with the card's
name and power limit) and ``{"kernels": [...]}`` lines, its wall
time, and ends with ``{"ok": true, "device":
{...}}``. Without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from jspsr_torch.cli.main import main as cli_main
from jspsr_torch.config.loader import create_config
from jspsr_torch.data.loader import build_batch_inputs, input_kinds, \
    pack_mask_np
from jspsr_torch.data.normalize import scale_data
from jspsr_torch.data.raster_io import read_raster, write_raster
from jspsr_torch.data.synthetic import generate_city, generate_mini_dfc30
from jspsr_torch.entry import entry
from jspsr_torch.eval.export import load_exported
from jspsr_torch.eval.inference import (
    load_scene,
    make_forward,
    model_stride_multiple,
    pads_for_multiple,
    run_scene_inference,
    upscale_dem,
)
from jspsr_torch.eval.scene import (
    prepare_scene,
    tile_grid,
    tile_inference_device,
)
from jspsr_torch.eval.serve import auto_scene_batch
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.factory import build_model
from jspsr_torch.ops import conv_same as conv_same_mod
from jspsr_torch.ops import cuda_build, deform_cuda
from jspsr_torch.ops.conv_same import conv_same, conv_same_plain
from jspsr_torch.parallel import dryrun
from jspsr_torch.ops.deform_conv import (
    deform_conv2d,
    deform_conv2d_backward_plain,
    deform_conv2d_plain,
)
from jspsr_torch.scripts import bench_conv_same
from jspsr_torch.scripts.bench_deform_fwd import (
    HOST_SHAPE,
    KERNEL_SHAPES,
    TIMED_SCALE,
    card_peaks,
    deform_inputs,
    deform_library,
    host_us,
    k1_bound,
    time_ms,
)
from jspsr_torch.scripts.bench_deform_bwd import k2_bound
from jspsr_torch.scripts.bench_deform_bwd_dx import k3_bound, k3_slab_bound
from jspsr_torch.train.checkpoint import load_model_params
from jspsr_torch.train.optim import build_optimizer
from jspsr_torch.train.orbax_ckpt import wait_for_checkpoint
from jspsr_torch.train.profile_step import random_batch
from jspsr_torch.train.step import make_train_step, seed_step_generator
from jspsr_torch.train.trainer import Trainer
from jspsr_torch.utils.device import set_deterministic_cudnn, set_strict_fp32
from jspsr_torch.utils.perturb import perturb_weights
from jspsr_torch.utils.summary import count_flops, forward_cost, \
    model_summary, trace_kernels, trace_step

REPO = Path(__file__).resolve().parent
FLAGSHIP = REPO / "configs" / "jspsr_r8_img_msk.yml"
CF_CONFIG = REPO / "configs" / "completionformer_r8_img_msk.yml"
EDSR_CONFIG = REPO / "configs" / "edsr_r8_img.yml"
LRRU_CONFIG = REPO / "configs" / "lrru_r8_img.yml"
BF16_CONFIG = REPO / "configs" / "jspsr_r8_img_msk_bf16.yml"
R3_CONFIG = REPO / "configs" / "jspsr_r3_img_msk.yml"

# K1's correctness-only shapes: sides that are not multiples of its 4 x 64
# tile, the first smaller than one tile (TMA), the second with W % 4 != 0
# (a row pitch a tensor map cannot take: the copy path)
CHECK_SHAPES = [(2, 13, 20), (1, 333, 335)]
BWD_SHAPES = [(50, 128, 128), (70, 128, 128), (16, 128, 128),
              (1, 336, 336)]
DX_SHAPES = [(16, 128, 128), (2, 128, 128), (1, 352, 352)]
# The bf16-sampling modes (``spn_sample_dtype``): K1's at whole scenes of
# 336^2 and 1024^2, the train batches of 50 and 16 x 128^2 and the copy
# path's 333 x 335, and at the eval loops' shapes (``eval_shapes``, where
# phase 13 (d) launches it most); K2's at the train batches and one 334^2
# scene
BF16 = "bfloat16"
BF16_SHAPES = [(1, 336, 336), (1, 1024, 1024), (50, 128, 128),
               (16, 128, 128), (1, 333, 335)]
BF16_BWD_SHAPES = [(50, 128, 128), (16, 128, 128), (1, 334, 334)]
# K3's d_weight and d_x against the plain backward: the largest error
# relative to the sum of the terms' magnitudes (the sums run in another
# order; d_x's fixed point resolves about 2^-61 of its image's L1 norm of
# contributions)
DX_ERR_LIMIT = 1e-5
# K3 with a heavy-tailed g: HEAVY_COUNT entries of g, anywhere in the
# batch, scaled by each factor (they set their images' fixed-point scale),
# at this offset scale
HEAVY_TAILS, HEAVY_COUNT, HEAVY_SCALE = (1e4, 1e6), 4, 20.0
# K3's one kernel (its three phases in one launch), by the name the
# profiler gives it
DX_PASSES = {"kernel": "deform_bwd_dx_kernel"}
# K3's device work per call, counted in a process of its own: each mode,
# whole and on a slab, on the TMA path (128^2) and on the copy path (333^2:
# W % 4 != 0)
K3_COUNT_SPECS = [[b, side, hs, y0, mode] for mode in (None, "bfloat16")
                  for b, side, hs, y0 in ((16, 128, 128, 0), (2, 128, 64, 64),
                                          (1, 333, 333, 0),
                                          (1, 333, 111, 111))]
OFFSET_SCALES = (0.0, 1.5, 20.0)
SCENES = [("scene_0", 334), ("scene_1", 334), ("scene_2", 334),
          ("scene_3", 334), ("scene_4", 1024)]
CF_SCENE = ("scene_cf", 334)
# Tiled serving: 8 x 334^2 (auto batch 8: one 72-tile run), 2 x 1024^2
# (auto batch 1: two 81-tile runs), and one 500 x 700 scene
TILED_SMALL = [(f"tile_{i}", 334) for i in range(8)]
TILED_LARGE = [(f"big_{i}", 1024) for i in range(2)]
TILED_RECT = ("rect", (500, 700))
# LRRU's whole rectangle (phase 12): both sides off its /16 (padded to 256
# x 352); a cut from TILED_RECT's 500 x 700 (512 x 704), whose float64
# forward on the host took about 30 s (until phase 16 pushed the script
# past 1,000 s on an NVIDIA H100 80GB HBM3 host, 700 W)
LRRU_RECT = ("rect", (244, 346))
# Between tile batch sizes cuDNN may change its reduction order: the JAX
# suite's tolerance for that (tests/test_scene_device.py), in metres.
BATCH_RTOL, BATCH_ATOL = 2e-4, 5e-3
TRAIN_SCENES_PER_CITY = 12  # x 13 cities = 156 samples: 3 steps of 50
VALID_SCENES_PER_CITY = 4  # x 3 cities = 12 samples per eval pass
TRAIN_SIDE = 128  # an 8 m DFC30 sample
# fit on the card: the configs' 300 epochs cut to 2
FIT_EPOCHS = 2
# Phase 14: the artifact's batches (one tile, the train batch, a tiled
# server's chunk of 72) and its tolerance against the eager model
EXPORT_BATCHES = (1, 50, 72)
EXPORT_TOL = 1e-5
# the artifact and the eager model at batch 50, each turn a median of this
# many runs (a cut: 25 until the script passed 720 s, NVIDIA H100 80GB
# HBM3, 700 W; a turn at batch 50 took about 6 s of it; 10 until phase 16
# pushed it past 1,000 s on a slower host; 5 until phase 17's
# CompletionFormer case took the script to 1,028 s)
EXPORT_TIME_REPS = 3
# phase 10's CompletionFormer resume gate trains on the first this many
# cities of the tree (a cut: every city until phase 17's CompletionFormer
# case took the script to 1,028 s): 48 samples, 3 steps of 16 per epoch
GATE_CF_CITIES = 4
# run in a fresh process: the artifact loaded with torch and the op library
# alone, on the card, TF32 off and cuDNN's deterministic algorithms (as the
# eager model runs in the parent: with cuDNN's defaults the fp32 forward
# differs from run to run, ``export_leg`` measures by how much), at each
# batch; its outputs and each call's launches back in a .npz and a JSON
# line
EXPORT_LOADER = r"""
import json, sys
import numpy as np
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
from jspsr_torch.eval.export import load_exported
from jspsr_torch.ops import deform_cuda
fn = load_exported(sys.argv[1])
with np.load(sys.argv[2]) as z:
    xs = [torch.from_numpy(z[k]).cuda() for k in sorted(z.files)]
outs, launches = {}, {}
for b in json.loads(sys.argv[4]):
    deform_cuda.reset_launches()
    y = fn(*[x[:b] for x in xs])
    torch.cuda.synchronize()
    launches[b] = dict(deform_cuda.LAUNCHES)
    outs[str(b)] = y.cpu().numpy()
np.savez(sys.argv[3], **outs)
print(json.dumps({"launches": launches, "modules": sorted(
    m for m in sys.modules if m.startswith(("jspsr", "jax")))}))
"""
# the preemption gate's save_every_steps (3 steps of 50 per epoch: one
# mid-epoch save) and the profiled epoch's profile_steps
PREEMPT_EVERY, PROFILE_STEPS = 2, 2
# where the gate preempts a fit: [epoch, step] of the save it resumes from
PREEMPT_AT = {"after_save": [0, PREEMPT_EVERY],
              "between_saves": [1, PREEMPT_EVERY]}
# The crash each config's gate runs: the flagship's fit (the asynchronous
# backend, ``checkpoint_backend: orbax``) right after a save, the bf16
# flagship's (the synchronous .npz) between saves. A cut: both ran both
# until the script passed 800 s (NVIDIA H100 80GB HBM3, 700 W).
PREEMPT_CASES = {"JSPSR": ("after_save",), "JSPSR_bf16": ("between_saves",)}
# Phase 15: the execution options' eval forward (phase 4's checkpoint) at
# one tile, a tiled server's chunk of 72 and one 334^2 scene, each timed as
# the median of TIME_REPEATS (a cut: 25 until phase 16 pushed the script
# past 720 s; at 72 tiles the four sets took about 47 s of it, NVIDIA H100
# 80GB HBM3, 700 W); the remat steps' warm steps after the compared one;
# the r3 config's epoch on one 334^2 sample per train city
OPTION_SETS = {"separate": {}, "fuse_stems": {"fuse_stems": True},
               "eval_grouped": {"eval_grouped": True},
               "both": {"fuse_stems": True, "eval_grouped": True}}
OPTION_BATCHES = (1, 72)
TIME_REPEATS, TIMED_STEPS = 10, 5
R3_SCENES_PER_CITY, R3_SIDE = 1, 334
# K1 launches per eval sample (valid batch 1): the flagship's SPN head once,
# NLSPN's 6 propagation steps
PER_EVAL_SAMPLE = {"JSPSR": 1, "CompletionFormer": 6}
# One train step, per tensor (relative L2): the card's distance from
# float64 may be three times the CPU fp32 run's, plus a floor. At init the
# step is ill-conditioned in fp32 (the CPU's own fp32 gradients are up to
# 2 % from float64); cuDNN picks other conv algorithms than the CPU (FFT
# among them); and the SPN kernel's 9 weight gradients are sums of B*H*W
# signed terms that cancel.
CARD_FP64_FLOOR = 5e-3
# The one wider floor: the weight gradients of CompletionFormer's CBAM
# SpatialAttention convs (``*.sa.conv1.weight``, a 7x7 conv from 2
# channels to 1) are small sums of cancelling terms, and cuDNN's
# algorithms leave them up to 2.8 % from float64 where the CPU's are 0.4 %
# (an excess over 3x the CPU's of up to 1.6e-2 on an H100). With cuDNN off
# they hold CARD_FP64_FLOOR, as every other tensor does with it on.
SA_CONV_SUFFIX, SA_CONV_FLOOR = ".sa.conv1.weight", 2.5e-2


def deform_counts(**counts) -> dict:
    """Every deform kernel's launch count (each mode under its own name),
    0 but for ``counts``."""
    return {**dict.fromkeys(deform_cuda.KERNELS, 0), **counts}


# Launches per train step: JSPSR's SPN head runs one deform forward and,
# as it detaches the DEM, the backward without the input gradient (K2);
# NLSPN propagates 6 times a feature that needs its gradient (K3).
PER_STEP = {"JSPSR": deform_counts(deform_fwd=1, deform_bwd=1),
            "CompletionFormer": deform_counts(deform_fwd=6, deform_bwd_dx=6),
            # EDSR as shipped runs no SPN head; with it, JSPSR's head on
            # the detached DEM. LRRU runs its post-process in each of 4
            # rounds on a detached depth; only round 4's output reaches
            # the loss undetached.
            "EDSR": deform_counts(),
            "EDSR+SPN": deform_counts(deform_fwd=1, deform_bwd=1),
            "LRRU": deform_counts(deform_fwd=4, deform_bwd=1)}
# Phases 11-12 train one epoch each (2 steps of 70), a cut: with two, as
# phases 5-6 train, the whole script ran 359.5 s (NVIDIA H100 80GB HBM3,
# 700 W), where phases 1-10 alone had taken 227.9 s
CUT_EPOCHS = (0,)
# K1 launches per forward (a served scene, a tile chunk, an eval sample)
PER_FORWARD = {"EDSR": 0, "EDSR+SPN": 1, "LRRU": 4}
# LRRU's heads of rounds 1-3: their outputs enter the loss only detached
UNREACHED = ("upproj0.", "upproj1.", "upproj2.", "weight_offset0.",
             "weight_offset1.", "weight_offset2.")
# The share of LRRU's input DEM pixels set to no data (0 once scaled)
# wherever its output is compared: ``preserve`` puts the input back at
# every pixel where the DEM is > 0 before each round, so elsewhere rounds
# 1-3 would not reach the output and a fault there could not show.
LRRU_HOLES = 0.03
# LRRU's tolerance, the JAX suite's (tests/test_parity_lrru.py:45), in
# its scaled output (atol times the output's largest magnitude, at least
# 1), and carried into metres by the linear descale of the serving config
# below (x 1009 m; a served raster is clipped to [0, 1] before it, so its
# magnitude is at most 1). The full-width LRRU with random weights is
# ill-conditioned in fp32: on these scenes the CPU's own fp32 output is
# 0.3-0.75 of this tolerance from float64 and the card's up to 1.1 of it,
# so two fp32 runs may differ by more than it. The card is held to float64
# on the CPU, with three times the CPU fp32 run's distance added
# (``hold_to_float64``), as phase 5 holds a train step.
LRRU_RTOL, LRRU_ATOL = 1e-4, 3e-5
# Phase 13 holds the bf16 flagship's served outputs to the float64 forward
# of the same weights with the fp32 body, in the model's scaled domain (the
# whole scene's output; the served rasters mapped back by
# ``scaled_raster``), at phase 4's serving tolerance (atol times the
# output's largest magnitude, at least 1) plus three times the CPU bf16
# port's own distance from float64 (``hold_to_float64``): a bf16 body is
# that far from float64 by design, and the card's bf16 convs round in
# other places than the CPU's.
BF16_TOL_SCALED = (1e-4, 2e-5)
# The served rasters held to float64 on the CPU in phases 11-13: the last
# of each directory (the last chunk's last tiles). Every served raster is
# also held to its scene served alone on the card. A cut: phases 11-13
# held the first as well until the script passed 700 s (NVIDIA H100 80GB
# HBM3, 700 W), where each CPU float64 forward of a served scene cost
# seconds of host time.
SERVED_FP64 = (-1,)
# Every served raster against its scene served alone on the card, scaled:
# the two differ only where cuDNN's bf16 convs at a batch of 72 tiles
# round otherwise than at 9 (up to 0.0133 on an NVIDIA H100 80GB HBM3; the
# card against the CPU's bf16 run 0.0098): three times that, as
# ``hold_to_float64`` allows three times a run's own distance. The phase
# asserts that a raster swapped with another scene's, or shifted by one
# tile stride, would exceed it.
BF16_SERVED_ATOL = 4e-2
# The serving inputs of the image-only configs (configs/edsr_r8_img.yml,
# configs/lrru_r8_img.yml)
IMG_ONLY = {"COP30": 1, "image": 3}
# LRRU serves with the linear elevation scale and no relative base, so a
# no-data pixel at the range's minimum (-80 m) scales to 0 and
# ``preserve`` leaves it to rounds 1-3 (configs/lrru_r8_img.yml's log scale
# maps every elevation above 0.63, so no pixel would be left to them)
LRRU_SCALING = {"relative": False,
                "tensor_kwargs": {"log": False, "min": -80, "max": 929}}


def eval_shapes() -> list:
    """K1's shapes in the eval loops of phases 10 and 13: each config's
    valid batch of TRAIN_SIDE^2 samples (a remainder batch is padded to
    it)."""
    return sorted({(create_config(c).valid_batch_size, TRAIN_SIDE,
                    TRAIN_SIDE) for c in (FLAGSHIP, CF_CONFIG, BF16_CONFIG)})


def serving_shapes() -> list:
    """K1's shapes on the whole-scene serving paths of phases 11-12: each
    scene served whole, padded to its model's stride multiple (EDSR's 1,
    LRRU's 16); the tiled paths' chunks are in KERNEL_SHAPES."""
    shapes = set()
    for config, scenes in ((EDSR_CONFIG, SCENES),
                           (LRRU_CONFIG, SCENES + [LRRU_RECT])):
        mult = model_stride_multiple(create_config(config))
        for _, side in scenes:
            h, w = (side, side) if isinstance(side, int) else side
            t, b, l, r = pads_for_multiple(h, w, mult)
            shapes.add((1, h + t + b, w + l + r))
    return sorted(shapes)


def dp_shapes() -> tuple[list, list]:
    """K1's and K2's shapes on phase 16's paths, from its constants: (a)
    each rank's batch; (c) the valid batch and the tiled server's chunk
    (TILED_SMALL's tiles), each split over the mesh; (d) the dry run's
    (``parallel.dryrun``): one row per rank and the one-process
    reference's DRYRUN_RANKS rows, in training and in its mesh eval. The
    group of one in (b) steps at the config's batch of 50 and evaluates
    at its valid batch (KERNEL_SHAPES, ``eval_shapes``)."""
    side = TRAIN_SIDE
    chunk = len(TILED_SMALL) * tile_grid(TILED_SMALL[0][1], DP_TILE)[1] ** 2
    dry = [(1, dryrun.SIDE, dryrun.SIDE),
           (DRYRUN_RANKS, dryrun.SIDE, dryrun.SIDE)]
    fwd = [(DP_RANK_BATCH, side, side),
           (DP_VALID_BATCH // DP_MESH, side, side),
           (chunk // DP_MESH, DP_TILE, DP_TILE)] + dry
    return fwd, [(DP_RANK_BATCH, side, side)] + dry


def check_deform_kernel(dev, bandwidth, fp32_peak, sample_dtype=None,
                        seed: int = 0):
    """K1 against its plain version, in the mode ``sample_dtype`` asks for,
    with offsets at each of OFFSET_SCALES, at rtol = atol = 1e-5: in the
    fp32 mode at the main path's shapes (timed), the whole-scene serving
    paths' of phases 11-12, phase 16's (``dp_shapes``) and the
    correctness-only shapes; in the bf16
    mode at BF16_SHAPES (both compute the same roundings; only the order of
    the 9-term sum differs), where at TIMED_SCALE its distance from the
    fp32 mode must exceed that tolerance (the mode really rounds) and the
    timed rows also give the fp32 mode's time on the same inputs; in both
    at the eval loop's shapes. The bound is the fp32 mode's (the same
    bytes move) and the library yardstick the fp32 ``grid_sample`` form.
    Returns one row per shape and, in the fp32 mode, the wrapper's host µs
    per call."""
    name = "deform_fwd_bf16" if sample_dtype else "deform_fwd"
    shapes = ((BF16_SHAPES + eval_shapes()) if sample_dtype else
              (KERNEL_SHAPES + eval_shapes() + serving_shapes()
               + dp_shapes()[0] + CHECK_SHAPES))
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(64 * 2**20, device=dev)  # 256 MB > the 50 MB L2
    rows = []
    for b, h, w in dict.fromkeys(shapes):
        row = {"shape": [b, 1, h, w], "max_abs_err": 0.0}
        for scale in OFFSET_SCALES:
            args = deform_inputs(b, h, w, scale, gen, dev)
            row["path"] = deform_cuda.fwd_path(args[0], args[1], args[4])
            with torch.inference_mode():
                got = deform_cuda.deform_fwd(*args, sample_dtype=sample_dtype)
                ref = deform_conv2d_plain(*args, sample_dtype=sample_dtype)
                other = (deform_cuda.deform_fwd(*args) if sample_dtype
                         else deform_library(*args))
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not torch.allclose(got, ref, rtol=1e-5, atol=1e-5):
                raise AssertionError(
                    f"{name} disagrees with its plain version at "
                    f"{(b, h, w)} offset scale {scale}: max |err| {err}")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if sample_dtype:
                row.setdefault("vs_fp32_mode_max_abs", {})[str(scale)] = (
                    got - other).abs().max().item()
                if (scale == TIMED_SCALE
                        and row["vs_fp32_mode_max_abs"][str(scale)] <= 1e-5):
                    raise AssertionError(f"{name} at {(b, h, w)} equals the "
                                         f"fp32 mode: {row}")
            else:
                row["library_max_abs_err"] = max(
                    row.get("library_max_abs_err", 0.0),
                    (other - ref).abs().max().item())
                # where this data's corners are read: per pixel, from the
                # tile's shared-memory window or from global memory
                counts = deform_cuda.fwd_window(args[1], h, w)
                window = row.setdefault("window", {})[str(scale)] = {
                    k: counts[k] / (b * h * w)
                    for k in ("window", "global", "corners")}
                print(f"deform_fwd window at {b} x {h} x {w}, {scale} px: "
                      f"{counts['window_taps'] / counts['taps']:.4f} of taps "
                      f"in the window; corners per pixel: window "
                      f"{window['window']:.3f}, global {window['global']:.3f}"
                      f" (a direct gather {window['corners']:.3f})",
                      flush=True)
            if scale == TIMED_SCALE and (b, h, w) in KERNEL_SHAPES:
                with torch.inference_mode():
                    row["kernel_ms"] = time_ms(lambda: deform_cuda.deform_fwd(
                        *args, sample_dtype=sample_dtype), flush)
                    if sample_dtype:
                        row["fp32_mode_ms"] = time_ms(
                            lambda: deform_cuda.deform_fwd(*args), flush)
                    row["plain_ms"] = time_ms(lambda: deform_conv2d_plain(
                        *args, sample_dtype=sample_dtype), flush)
                    row["library_ms"] = time_ms(
                        lambda: deform_library(*args), flush)
        row["bound_ms"], row["bound_by"] = k1_bound(b, h, w, bandwidth,
                                                    fp32_peak)
        if "kernel_ms" in row:
            row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        rows.append(row)
        print(f"{name} {row}", flush=True)
    if sample_dtype:
        return rows, None
    args = deform_inputs(*HOST_SHAPE, TIMED_SCALE, gen, dev)
    with torch.inference_mode():
        host = host_us(lambda: deform_cuda.deform_fwd(*args))
    print(f"deform_fwd host {host:.2f} us per call (1,000 calls at "
          f"{HOST_SHAPE}, no synchronise)", flush=True)
    return rows, host


def check_deform_backward(dev, bandwidth, fp32_peak, shapes=BWD_SHAPES,
                          sample_dtype=None, seed: int = 1):
    """K2 against its plain backward at ``shapes`` (the train path's), in
    the mode ``sample_dtype`` asks for, and against itself (every output
    bit-identical over three calls); in the bf16 mode also the fp32
    mode's time on the same inputs, and its distance from it, which must
    exceed the tolerance (the mode really rounds); returns one row per
    shape (``k2_kernels_per_call`` adds each one's device kernels after
    every phase)."""
    name = "deform_bwd_bf16" if sample_dtype else "deform_bwd"
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(64 * 2**20, device=dev)
    rows = []
    for b, h, w in shapes:
        row = {"shape": [b, 1, h, w], "max_abs_err": 0.0,
               "d_weight_err_over_abs_sum": 0.0}
        for scale in OFFSET_SCALES:
            x, offset, weight, bias, mask = deform_inputs(b, h, w, scale, gen,
                                                          dev)
            g = torch.randn(b, 1, h, w, generator=gen, device=dev)
            got = deform_cuda.deform_bwd(x, offset, weight, mask, g,
                                         sample_dtype=sample_dtype)
            k2_three_calls(got, lambda: deform_cuda.deform_bwd(
                x, offset, weight, mask, g, sample_dtype=sample_dtype),
                f"{name} at {(b, h, w)} offset scale {scale}")
            ref = deform_conv2d_backward_plain(x, offset, weight, mask, g,
                                               sample_dtype=sample_dtype)
            # |d_weight| <= this bound on the sum of the terms' magnitudes
            abs_sum = deform_conv2d_backward_plain(
                x.abs(), offset, weight, mask.abs(), g.abs(),
                sample_dtype=sample_dtype)[2]
            torch.cuda.synchronize()
            for part, a, r in zip(("d_offset", "d_mask", "d_bias"),
                                  got[:2] + got[3:], ref[:2] + ref[3:]):
                if not torch.allclose(a, r, rtol=1e-5, atol=1e-5):
                    raise AssertionError(
                        f"{name} {part} disagrees with the plain backward"
                        f" at {(b, h, w)} offset scale {scale}: max |err| "
                        f"{(a - r).abs().max().item()}")
            w_err = ((got[2] - ref[2]).abs() / abs_sum).max().item()
            if w_err > 1e-5:
                raise AssertionError(
                    f"{name} d_weight at {(b, h, w)} offset scale "
                    f"{scale}: error {w_err} of the terms' magnitude sum")
            row["max_abs_err"] = max(
                row["max_abs_err"], (got[0] - ref[0]).abs().max().item(),
                (got[1] - ref[1]).abs().max().item())
            row["d_weight_err_over_abs_sum"] = max(
                row["d_weight_err_over_abs_sum"], w_err)
            if sample_dtype and scale == TIMED_SCALE:
                fp32 = deform_cuda.deform_bwd(x, offset, weight, mask, g)
                row["d_offset_vs_fp32_mode_max_abs"] = (
                    got[0] - fp32[0]).abs().max().item()
                if row["d_offset_vs_fp32_mode_max_abs"] <= 1e-5:
                    raise AssertionError(f"{name} at {(b, h, w)} equals the "
                                         f"fp32 mode: {row}")
                row["fp32_mode_ms"] = time_ms(lambda: deform_cuda.deform_bwd(
                    x, offset, weight, mask, g), flush)
            if scale == TIMED_SCALE:
                row["kernel_ms"] = time_ms(lambda: deform_cuda.deform_bwd(
                    x, offset, weight, mask, g, sample_dtype=sample_dtype),
                    flush)
                row["plain_ms"] = time_ms(
                    lambda: deform_conv2d_backward_plain(
                        x, offset, weight, mask, g,
                        sample_dtype=sample_dtype), flush)
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in (offset, weight, bias, mask)]
                out = deform_library(x, *leaves)
                row["library_ms"] = time_ms(lambda: torch.autograd.grad(
                    out, leaves, g, retain_graph=True), flush)
                del out, leaves
        row["bound_ms"], row["bound_by"] = k2_bound(b, h, w, bandwidth,
                                                    fp32_peak)
        rows.append(row)
        print(f"{name} {row}", flush=True)
    return rows


def k2_three_calls(got, call, where: str) -> None:
    """K2's outputs ``got`` and those of two more ``call``s on the same
    inputs, bit for bit: d_weight and d_bias are finished in the kernel in
    a fixed order."""
    for _ in range(2):
        again = call()
        torch.cuda.synchronize()
        diffs = [(a - c).abs().max().item() for a, c in zip(got, again)]
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"{where}: three calls differ by {diffs}")


# run in a fresh process: K2's and K3's device work per call at each of
# their specs, read by torch.profiler (in this process, after a process
# group and other profiler runs, its events came back without their
# device)
BWD_KERNELS = r"""
import json, sys
from jspsr_torch.scripts import bench_deform_bwd, bench_deform_bwd_dx
k2, k3 = json.loads(sys.argv[1])
print(json.dumps([bench_deform_bwd.kernels_per_call(k2),
                  bench_deform_bwd_dx.kernels_per_call(k3)]))
"""


def child_json(code: str, *args: str, what: str):
    """The last line of the standard output, as JSON, of ``code`` run in a
    fresh Python process from the repo's root (``-c``, with ``args``);
    raises with its error output if it fails."""
    run = subprocess.run([sys.executable, "-c", code, *args],
                         capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    if run.returncode:
        raise AssertionError(f"{what} failed: {run.stderr[-6000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def bwd_kernels_per_call(k2_by_mode, dx_rows) -> dict:
    """K2's and K3's device work per call, counted by ``torch.profiler`` in
    one process of its own (``BWD_KERNELS``): K2 at each of its rows
    (``k2_kernels_per_call``), K3 at K3_COUNT_SPECS
    (``k3_kernels_per_call``) and at ``dx_rows``' shapes, whose device
    time it gives (``dx_pass_times``). It runs after every other phase:
    the profiler slows the process it traces. Returns K3's counts."""
    rows = [(row, mode) for rows, mode in k2_by_mode for row in rows]
    k2_specs = [[row["shape"][0], row.get("image", row["shape"])[2],
                 row["shape"][2], row.get("y0", [0])[-1], mode]
                for row, mode in rows]
    k3_specs = K3_COUNT_SPECS + [[r["shape"][0], r["shape"][2],
                                  r["shape"][2], 0, None] for r in dx_rows]
    k2_work, k3_work = child_json(BWD_KERNELS,
                                  json.dumps([k2_specs, k3_specs]),
                                  what="K2's and K3's kernel counts")
    k2_kernels_per_call(rows, k2_specs, k2_work)
    counts = k3_kernels_per_call(k3_specs, k3_work)
    dx_pass_times(dx_rows, k3_work[len(K3_COUNT_SPECS):])
    return counts


def k2_kernels_per_call(rows, specs, counts) -> None:
    """Each K2 row's device kernels per call (``rows``: (row, sample
    dtype) pairs; ``specs`` their shapes, a slab row at its last y0;
    ``counts`` the child's), offsets of TIMED_SCALE, into the row's
    ``kernels_per_call``: exactly one kernel, K2's, and no memset or
    copy."""
    for (row, mode), (b, side, hs, y0, _), kinds in zip(rows, specs, counts):
        row["kernels_per_call"] = kinds
        name = "deform_bwd" + ("_bf16" if mode else "") + (
            "_slab" if hs != side else "")
        print(f"{name} at {b} x {hs} x {side} (y0 {y0}): device kernels per "
              f"call {kinds}", flush=True)
        if (list(kinds.values()) != [1.0]
                or "deform_bwd_kernel" not in next(iter(kinds))):
            raise AssertionError(f"{name} at {row['shape']}: device work "
                                 f"per call {kinds}, not one K2 kernel")


def k3_kernels_per_call(specs, work) -> dict:
    """K3's device kernels per call at each of ``specs`` (``work`` the
    child's ``bench_deform_bwd_dx.kernels_per_call``): exactly one kernel,
    K3's, and no memset, copy or reduction (the zero fill, the bounds, the
    conversion and the d_weight and d_bias sums are phases of its launch).
    Returns the counts of K3_COUNT_SPECS' cases by kernel name
    (``deform_bwd_dx[_bf16][_slab]``) and path."""
    out: dict = {}
    for i, ((b, side, hs, y0, mode), kinds) in enumerate(zip(specs, work)):
        counts = {k: n for k, (n, _) in kinds.items()}
        name = "deform_bwd_dx" + ("_bf16" if mode else "") + (
            "_slab" if hs != side else "")
        path = "tma" if side % 4 == 0 else "copy"
        print(f"{name} at {b} x {hs} x {side} (y0 {y0}, {path} path): "
              f"device kernels per call {counts}", flush=True)
        if (list(counts.values()) != [1.0]
                or DX_PASSES["kernel"] not in next(iter(counts))):
            raise AssertionError(f"{name} at {b} x {hs} x {side} ({path}):"
                                 f" device work per call {counts}, not one "
                                 f"K3 kernel")
        if i < len(K3_COUNT_SPECS):
            out.setdefault(name, {})[path] = counts
    return out


def k3_empty_slabs(dev) -> dict:
    """K3 on an empty batch and on empty slabs (no rows, at y0 = 0 and at
    y0 = H) in each mode: d_offset and d_mask empty, d_x, d_weight and
    d_bias zero and of their shapes, no launch counted. Before each call a
    NaN tensor of d_x's size is made and freed, so that the caching
    allocator hands its block back: a d_x the call left unwritten shows as
    NaN. Returns the cases, each True."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x, off, wt, _, mask = deform_inputs(2, 128, 128, TIMED_SCALE, gen, dev)
    g = torch.randn(2, 1, 128, 128, generator=gen, device=dev)
    before = dict(deform_cuda.LAUNCHES)
    cases = {}
    for mode in (None, BF16):
        for b, hs, y0 in ((0, 128, 0), (2, 0, 0), (2, 0, 128)):
            xs = x[:b]
            o, m, gs = (t[:b, :, y0:y0 + hs].contiguous()
                        for t in (off, mask, g))
            torch.full_like(xs, float("nan"))  # made and freed at once
            got = deform_cuda.deform_bwd_dx(xs, o, wt, m, gs,
                                            sample_dtype=mode, y0=y0)
            torch.cuda.synchronize()
            shapes = [tuple(t.shape) for t in got]
            ok = (shapes == [tuple(o.shape), tuple(m.shape),
                             tuple(wt.shape), (1,), tuple(xs.shape)]
                  and not any(t.any() for t in got[2:]))
            label = f"{mode or 'fp32'} b {b} hs {hs} y0 {y0}"
            print(f"deform_bwd_dx on an empty batch or slab, {label}: "
                  f"shapes {shapes}, zero d_x, d_weight, d_bias: {ok}",
                  flush=True)
            if not ok:
                raise AssertionError(f"deform_bwd_dx, {label}: {shapes}, "
                                     f"d_x NaN {got[4].isnan().sum().item()}"
                                     f", d_weight {got[2].flatten()}, d_bias "
                                     f"{got[3]}")
            cases[label] = ok
    if deform_cuda.LAUNCHES != before:
        raise AssertionError(f"deform_bwd_dx on empty inputs counted "
                             f"launches: {deform_cuda.LAUNCHES} against "
                             f"{before}")
    return cases


def spatial_slabs(sample_dtype=None) -> list:
    """K1's and K2's row slabs on phase 17's paths, from its constants:
    each rank's (batch rows, image side), its slab's rows, the y0 of each
    space index, and whether K2 runs there: (a)'s forward (K1 only) and
    (b)'s gradients (K1 and K2). The fp32 mode adds the forward of the
    cases at SPATIAL_FP64_FWD (K1 only: LRRU's four rounds), the
    bf16-sampling mode the shipped bf16 batch of 50 x 128^2 on the mesh
    (SPATIAL_BF16_BATCH, both)."""
    n_data, n_space = SPATIAL_MESH
    shapes = [(SPATIAL_FWD, False), (SPATIAL_GRAD, True)]
    shapes.append((SPATIAL_FP64_FWD, False) if sample_dtype is None
                  else (SPATIAL_BF16_BATCH, True))
    return [(b // n_data, side, side // n_space,
             [s * (side // n_space) for s in range(n_space)], with_bwd)
            for (b, side), with_bwd in shapes]


def check_deform_slabs(dev, bandwidth, fp32_peak, seed: int = 7,
                       sample_dtype=None):
    """K1 and K2 on row slabs (``y0``; ``deform_fwd_slab``,
    ``deform_bwd_slab``, or with ``sample_dtype`` bf16 their bf16-sampling
    modes, ``deform_fwd_bf16_slab``, ``deform_bwd_bf16_slab``) at phase
    17's slabs (``spatial_slabs``: K1 at each, K2 where it runs), each
    y0 of the mesh on one image, offsets at each of OFFSET_SCALES: against
    their plain versions in the same mode with the same row origin (rtol
    = atol = 1e-5, K2's d_weight within 1e-5 of its terms' magnitude sum,
    as ``check_deform_kernel`` and ``check_deform_backward``), and bit for
    bit against the whole-image kernel in the same mode: the slab's output,
    d_offset and d_mask are those rows of the whole image's, a call with
    ``y0=0`` and the whole image is the whole-image kernel's, and the
    slabs' d_weight and d_bias summed are the whole image's within 1e-6
    of the terms' magnitude sums; timed at TIMED_SCALE and the last y0
    beside the plain version, the fp32 ``grid_sample`` form on the slab
    (for K2 autograd's backward through it) and the bound of the slab's
    own pixels (the fp32 mode's bytes). Returns K1's rows and K2's."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(64 * 2**20, device=dev)
    mode = "_bf16" if sample_dtype is not None else ""
    kw = {"sample_dtype": sample_dtype}
    fwd_rows, bwd_rows = [], []
    for b, side, hs, y0s, with_bwd in spatial_slabs(sample_dtype):
        fwd = {"shape": [b, 1, hs, side], "image": [b, 1, side, side],
               "y0": y0s, "max_abs_err": 0.0}
        bwd = dict(fwd, d_weight_err_over_abs_sum=0.0,
                   d_weight_sum_rel_err=0.0)
        for scale in OFFSET_SCALES:
            x, off, wt, bias, mask = deform_inputs(b, side, side, scale,
                                                   gen, dev)
            g = torch.randn(b, 1, side, side, generator=gen, device=dev)
            with torch.inference_mode():
                whole = deform_cuda.deform_fwd(x, off, wt, bias, mask, **kw)
                zero = deform_cuda.deform_fwd(x, off, wt, bias, mask, y0=0,
                                              **kw)
            whole_b = (deform_cuda.deform_bwd(x, off, wt, mask, g, **kw)
                       if with_bwd else None)
            sums = [0.0, 0.0]
            for y0 in y0s:
                rows = slice(y0, y0 + hs)
                o, m = off[:, :, rows].contiguous(), mask[:, :, rows] \
                    .contiguous()
                with torch.inference_mode():
                    got = deform_cuda.deform_fwd(x, o, wt, bias, m, y0=y0,
                                                 **kw)
                    ref = deform_conv2d_plain(x, o, wt, bias, m, y0=y0,
                                              **kw)
                torch.cuda.synchronize()
                if not (torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
                        and torch.equal(got, whole[:, :, rows])
                        and torch.equal(zero, whole)):
                    raise AssertionError(
                        f"deform_fwd{mode}_slab at {fwd['shape']} y0 {y0} "
                        f"offset scale {scale}: max |err| from the plain "
                        f"version {(got - ref).abs().max().item()}, from "
                        f"the whole image's rows "
                        f"{(got - whole[:, :, rows]).abs().max().item()}")
                fwd["max_abs_err"] = max(fwd["max_abs_err"],
                                         (got - ref).abs().max().item())
                timed = scale == TIMED_SCALE and y0 == y0s[-1]
                if timed:
                    with torch.inference_mode():
                        fwd["kernel_ms"] = time_ms(
                            lambda: deform_cuda.deform_fwd(
                                x, o, wt, bias, m, y0=y0, **kw), flush)
                        fwd["plain_ms"] = time_ms(
                            lambda: deform_conv2d_plain(x, o, wt, bias, m,
                                                        y0=y0, **kw), flush)
                        fwd["library_ms"] = time_ms(
                            lambda: deform_library(x, o, wt, bias, m, y0),
                            flush)
                if not with_bwd:
                    continue
                gs = g[:, :, rows].contiguous()
                got_b = deform_cuda.deform_bwd(x, o, wt, m, gs, y0=y0, **kw)
                k2_three_calls(got_b, lambda: deform_cuda.deform_bwd(
                    x, o, wt, m, gs, y0=y0, **kw),
                    f"deform_bwd{mode}_slab at {bwd['shape']} y0 {y0} "
                    f"offset scale {scale}")
                ref_b = deform_conv2d_backward_plain(x, o, wt, m, gs, y0=y0,
                                                     **kw)
                abs_sum = deform_conv2d_backward_plain(
                    x.abs(), o, wt, m.abs(), gs.abs(), y0=y0, **kw)[2]
                torch.cuda.synchronize()
                sums = [sums[0] + got_b[2], sums[1] + got_b[3]]
                w_err = ((got_b[2] - ref_b[2]).abs() / abs_sum).max().item()
                for part, a, r, full in zip(("d_offset", "d_mask"), got_b,
                                            ref_b, whole_b):
                    if not (torch.allclose(a, r, rtol=1e-5, atol=1e-5)
                            and torch.equal(a, full[:, :, rows])):
                        raise AssertionError(
                            f"deform_bwd{mode}_slab {part} at "
                            f"{bwd['shape']} y0 {y0} offset scale {scale}: "
                            f"max |err| {(a - r).abs().max().item()}, from "
                            f"the whole image's rows "
                            f"{(a - full[:, :, rows]).abs().max().item()}")
                    bwd["max_abs_err"] = max(bwd["max_abs_err"],
                                             (a - r).abs().max().item())
                if w_err > 1e-5 or not torch.allclose(got_b[3], ref_b[3],
                                                      rtol=1e-5, atol=1e-5):
                    raise AssertionError(
                        f"deform_bwd{mode}_slab d_weight / d_bias at "
                        f"{bwd['shape']} y0 {y0}: d_weight error {w_err} of "
                        f"the terms' magnitude sum")
                bwd["d_weight_err_over_abs_sum"] = max(
                    bwd["d_weight_err_over_abs_sum"], w_err)
                if timed:
                    bwd["kernel_ms"] = time_ms(lambda: deform_cuda.deform_bwd(
                        x, o, wt, m, gs, y0=y0, **kw), flush)
                    bwd["plain_ms"] = time_ms(
                        lambda: deform_conv2d_backward_plain(
                            x, o, wt, m, gs, y0=y0, **kw), flush)
                    leaves = [t.detach().clone().requires_grad_(True)
                              for t in (o, wt, bias, m)]
                    out = deform_library(x, *leaves, y0)
                    bwd["library_ms"] = time_ms(lambda: torch.autograd.grad(
                        out, leaves, gs, retain_graph=True), flush)
                    del out, leaves
            if with_bwd:
                # the slabs' shares of d_weight and d_bias sum to the whole
                # image's (the gradient all-reduce's sum), within 1e-6 of
                # the terms' magnitude sums: each is a sum of b x H x W
                # signed terms, which cancel (at 20 px, 2.6e-6 of the
                # largest d_weight itself on an H100)
                abs_w = deform_conv2d_backward_plain(
                    x.abs(), off, wt, mask.abs(), g.abs(), **kw)[2]
                sum_err = max(
                    _err_over_abs_sum(sums[0], whole_b[2], abs_w),
                    ((sums[1] - whole_b[3]).abs().max()
                     / g.abs().sum()).item())
                if sum_err > 1e-6:
                    raise AssertionError(
                        f"deform_bwd{mode}_slab at {bwd['shape']} offset "
                        f"scale {scale}: the slabs' d_weight / d_bias sum "
                        f"{sum_err} of the terms' magnitude sum from the "
                        f"whole image's")
                bwd["d_weight_sum_rel_err"] = max(
                    bwd["d_weight_sum_rel_err"], sum_err)
        fwd["bound_ms"], fwd["bound_by"] = k1_bound(b, hs, side, bandwidth,
                                                    fp32_peak)
        fwd_rows.append(fwd)
        print(f"deform_fwd{mode}_slab {fwd}", flush=True)
        if with_bwd:
            bwd["bound_ms"], bwd["bound_by"] = k2_bound(b, hs, side,
                                                        bandwidth, fp32_peak)
            bwd_rows.append(bwd)
            print(f"deform_bwd{mode}_slab {bwd}", flush=True)
    return fwd_rows, bwd_rows


def k3_slabs() -> list:
    """K3's row slabs on the card, from phase 17's constants: each rank's
    (batch rows, image side), its slab's rows and the y0 of each space
    index, at (b)'s gradient batch (SPATIAL_GRAD: phase 17's CompletionFormer
    case runs K3 there) and at the shipped CompletionFormer's train batch
    on the mesh (CF_SPATIAL_BATCH)."""
    n_data, n_space = SPATIAL_MESH
    return [(b // n_data, side, side // n_space,
             [s * (side // n_space) for s in range(n_space)])
            for b, side in (SPATIAL_GRAD, CF_SPATIAL_BATCH)]


def check_k3_slabs(dev, bandwidth, fp32_peak, seed: int = 9,
                   sample_dtype=None) -> list:
    """K3 (``deform_bwd_dx_slab``, or with ``sample_dtype`` bf16
    ``deform_bwd_dx_bf16_slab``) on row slabs (``k3_slabs``), each y0 of
    the mesh on one batch, offsets at each of OFFSET_SCALES: d_offset and
    d_mask bit-equal to those rows of the whole-image K3's in the same
    mode, and within rtol = atol = 1e-5 of the plain version with the same
    row origin; each slab's d_x (the whole image's) and d_weight within
    DX_ERR_LIMIT of their terms' magnitude sums from the plain version's;
    bit-equal across two launches; the slabs' d_x and d_weight summed (the
    row gather's and the gradient all-reduce's sums) within 1e-6 of the
    whole image's terms' magnitude sums from the whole-image K3's. Timed at
    TIMED_SCALE and the last y0 beside the plain version and the library
    form (autograd of the fp32 ``grid_sample`` form on the slab, ``x``
    included), with the bound of the slab's own bytes
    (``k3_slab_bound``). Returns one row per slab shape."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(64 * 2**20, device=dev)
    name = ("deform_bwd_dx_bf16_slab" if sample_dtype is not None
            else "deform_bwd_dx_slab")
    kw = {"sample_dtype": sample_dtype}
    rows_out = []
    for b, side, hs, y0s in k3_slabs():
        row = {"shape": [b, 1, hs, side], "image": [b, 1, side, side],
               "y0": y0s, "max_abs_err": 0.0, "d_x_err_over_abs_sum": 0.0,
               "d_weight_err_over_abs_sum": 0.0,
               "d_x_sum_err_over_abs_sum": 0.0,
               "d_weight_sum_err_over_abs_sum": 0.0}
        for scale in OFFSET_SCALES:
            x, off, wt, bias, mask = deform_inputs(b, side, side, scale, gen,
                                                   dev)
            g = torch.randn(b, 1, side, side, generator=gen, device=dev)
            whole = deform_cuda.deform_bwd_dx(x, off, wt, mask, g, **kw)
            sums = [torch.zeros_like(whole[4]), torch.zeros_like(whole[2])]
            for y0 in y0s:
                rows = slice(y0, y0 + hs)
                o, m, gs = (t[:, :, rows].contiguous() for t in (off, mask,
                                                                  g))
                got = deform_cuda.deform_bwd_dx(x, o, wt, m, gs, y0=y0, **kw)
                again = deform_cuda.deform_bwd_dx(x, o, wt, m, gs, y0=y0,
                                                  **kw)
                ref = deform_conv2d_backward_plain(x, o, wt, m, gs,
                                                   need_dx=True, y0=y0, **kw)
                abs_sum = deform_conv2d_backward_plain(
                    x.abs(), o, wt.abs(), m.abs(), gs.abs(), need_dx=True,
                    y0=y0, **kw)
                torch.cuda.synchronize()
                where = (f"{name} at {row['shape']} of {row['image']} y0 "
                         f"{y0} offset scale {scale}")
                if not all(torch.equal(a, c) for a, c in zip(got, again)):
                    raise AssertionError(f"{where}: two launches differ")
                for part, a, r, full in zip(("d_offset", "d_mask"), got,
                                            ref, whole):
                    if not (torch.equal(a, full[:, :, rows])
                            and torch.allclose(a, r, rtol=1e-5, atol=1e-5)):
                        raise AssertionError(
                            f"{where}: {part} max |err| from the plain "
                            f"version {(a - r).abs().max().item()}, from "
                            f"the whole image's rows "
                            f"{(a - full[:, :, rows]).abs().max().item()}")
                x_err = _err_over_abs_sum(got[4], ref[4], abs_sum[4])
                w_err = _err_over_abs_sum(got[2], ref[2], abs_sum[2])
                if x_err > DX_ERR_LIMIT or w_err > DX_ERR_LIMIT:
                    raise AssertionError(
                        f"{where}: d_x error {x_err}, d_weight error "
                        f"{w_err} of the terms' magnitude sums")
                row["max_abs_err"] = max(
                    row["max_abs_err"], (got[0] - ref[0]).abs().max().item(),
                    (got[1] - ref[1]).abs().max().item(),
                    (got[4] - ref[4]).abs().max().item())
                row["d_x_err_over_abs_sum"] = max(
                    row["d_x_err_over_abs_sum"], x_err)
                row["d_weight_err_over_abs_sum"] = max(
                    row["d_weight_err_over_abs_sum"], w_err)
                sums = [sums[0] + got[4], sums[1] + got[2]]
                if scale == TIMED_SCALE and y0 == y0s[-1]:
                    row["atomics"] = deform_cuda.dx_atomics(
                        o, side, side, y0=y0)["corners"]
                    row["kernel_ms"] = time_ms(
                        lambda: deform_cuda.deform_bwd_dx(
                            x, o, wt, m, gs, y0=y0, **kw), flush)
                    row["plain_ms"] = time_ms(
                        lambda: deform_conv2d_backward_plain(
                            x, o, wt, m, gs, need_dx=True, y0=y0, **kw),
                        flush)
                    leaves = [t.detach().clone().requires_grad_(True)
                              for t in (x, o, wt, bias, m)]
                    out = deform_library(*leaves, y0)
                    row["library_ms"] = time_ms(lambda: torch.autograd.grad(
                        out, leaves, gs, retain_graph=True), flush)
                    del out, leaves
            abs_whole = deform_conv2d_backward_plain(
                x.abs(), off, wt.abs(), mask.abs(), g.abs(), need_dx=True,
                **kw)
            sum_errs = (_err_over_abs_sum(sums[0], whole[4], abs_whole[4]),
                        _err_over_abs_sum(sums[1], whole[2], abs_whole[2]))
            if max(sum_errs) > 1e-6:
                raise AssertionError(
                    f"{name} at {row['shape']} offset scale {scale}: the "
                    f"slabs' d_x / d_weight sums {sum_errs} of the terms' "
                    f"magnitude sums from the whole image's")
            row["d_x_sum_err_over_abs_sum"] = max(
                row["d_x_sum_err_over_abs_sum"], sum_errs[0])
            row["d_weight_sum_err_over_abs_sum"] = max(
                row["d_weight_sum_err_over_abs_sum"], sum_errs[1])
            print(f"{name} at {b} x {hs} x {side} of {side}^2, {scale} px: "
                  f"d_offset and d_mask bit-equal to the whole image's "
                  f"rows; slabs' d_x sum {sum_errs[0]:.3e}, d_weight sum "
                  f"{sum_errs[1]:.3e} of the terms' magnitude sums (limit "
                  f"1e-06)", flush=True)
        row["bound_ms"], row["bound_by"] = k3_slab_bound(
            b, side, side, hs, row["atomics"], bandwidth, fp32_peak)
        row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        rows_out.append(row)
        print(f"{name} {row}", flush=True)
    return rows_out


def _err_over_abs_sum(got, ref, abs_sum) -> float:
    """The largest |got - ref| relative to the sum of the terms' magnitudes
    (0 where there are no terms and both are 0)."""
    return ((got - ref).abs() / abs_sum.clamp_min(1e-30)).max().item()


def dx_pass_times(rows, work) -> None:
    """The device time of K3's one kernel at each of its rows' shapes
    (offsets of TIMED_SCALE; ``work`` the child's ``device_profile`` of
    each, by kernel name: [count, device µs] per call), into the row's
    ``pass_device_ms``."""
    for row, kinds in zip(rows, work):
        b, _, h, w = row["shape"]
        row["pass_device_ms"] = {
            part: sum(us for k, (_, us) in kinds.items() if kernel in k)
            / 1e3 for part, kernel in DX_PASSES.items()}
        print(f"deform_bwd_dx at {b} x {h} x {w}: device ms by kernel "
              f"{row['pass_device_ms']}", flush=True)


def heavy_tails(b, h, w, gen) -> dict:
    """K3 with HEAVY_COUNT entries of g scaled by each of HEAVY_TAILS:
    bit-equal across two launches, and d_x and d_weight within
    DX_ERR_LIMIT of the terms' magnitude sums against the plain backward,
    as at the other scales (a reference in float64 would differ by the
    fp32 rounding of the sample positions, which both versions share);
    returns each factor's two errors."""
    dev = gen.device
    x, offset, weight, _, mask = deform_inputs(b, h, w, HEAVY_SCALE, gen, dev)
    out = {}
    for factor in HEAVY_TAILS:
        g = torch.randn(b, 1, h, w, generator=gen, device=dev)
        idx = torch.randint(0, g.numel(), (HEAVY_COUNT,), generator=gen,
                            device=dev)
        g.view(-1)[idx] *= factor
        got = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
        again = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
        ref = deform_conv2d_backward_plain(x, offset, weight, mask, g,
                                           need_dx=True)
        abs_sum = deform_conv2d_backward_plain(
            x.abs(), offset, weight.abs(), mask.abs(), g.abs(), need_dx=True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"deform_bwd_dx at {(b, h, w)}, g with "
                                 f"{factor:g} tails: two launches differ")
        w_err = _err_over_abs_sum(got[2], ref[2], abs_sum[2])
        x_err = _err_over_abs_sum(got[4], ref[4], abs_sum[4])
        print(f"deform_bwd_dx at {b} x {h} x {w}, {HEAVY_SCALE:g} px, g with "
              f"{HEAVY_COUNT} entries x {factor:g}: bit-equal across two "
              f"launches; d_x error {x_err:.3e}, d_weight error "
              f"{w_err:.3e} of the terms' magnitude sums (limit "
              f"{DX_ERR_LIMIT:g})", flush=True)
        if w_err > DX_ERR_LIMIT or x_err > DX_ERR_LIMIT:
            raise AssertionError(f"deform_bwd_dx at {(b, h, w)}, g with "
                                 f"{factor:g} tails: d_weight error {w_err}, "
                                 f"d_x error {x_err}")
        out[f"{factor:g}"] = {"d_x_err_over_abs_sum": x_err,
                              "d_weight_err_over_abs_sum": w_err}
    return out


def check_deform_backward_dx(dev, bandwidth, fp32_peak):
    """K3 against its plain backward at NLSPN's shapes, and against itself:
    two launches on the same inputs must agree bit for bit; returns one
    row per shape."""
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(64 * 2**20, device=dev)
    rows = []
    for b, h, w in DX_SHAPES:
        row = {"shape": [b, 1, h, w], "max_abs_err": 0.0,
               "d_weight_err_over_abs_sum": 0.0,
               "d_x_err_over_abs_sum": 0.0, "bit_equal_twice": True}
        for scale in OFFSET_SCALES:
            x, offset, weight, bias, mask = deform_inputs(b, h, w, scale, gen,
                                                          dev)
            g = torch.randn(b, 1, h, w, generator=gen, device=dev)
            got = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
            again = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
            ref = deform_conv2d_backward_plain(x, offset, weight, mask, g,
                                               need_dx=True)
            # d_weight and d_x bounded by the sums of their terms' magnitudes
            abs_sum = deform_conv2d_backward_plain(
                x.abs(), offset, weight.abs(), mask.abs(), g.abs(),
                need_dx=True)
            torch.cuda.synchronize()
            unequal = [name for name, a, c in zip(
                ("d_offset", "d_mask", "d_weight", "d_bias", "d_x"), got,
                again) if not torch.equal(a, c)]
            if unequal:
                raise AssertionError(
                    f"deform_bwd_dx at {(b, h, w)} offset scale {scale}: "
                    f"{unequal} differ between two launches on the same "
                    f"inputs")
            for name, a, r in zip(("d_offset", "d_mask", "d_bias"),
                                  got[:2] + got[3:4], ref[:2] + ref[3:4]):
                if not torch.allclose(a, r, rtol=1e-5, atol=1e-5):
                    raise AssertionError(
                        f"deform_bwd_dx {name} disagrees with the plain "
                        f"backward at {(b, h, w)} offset scale {scale}: max "
                        f"|err| {(a - r).abs().max().item()}")
            w_err = _err_over_abs_sum(got[2], ref[2], abs_sum[2])
            x_err = _err_over_abs_sum(got[4], ref[4], abs_sum[4])
            if w_err > DX_ERR_LIMIT or x_err > DX_ERR_LIMIT:
                raise AssertionError(
                    f"deform_bwd_dx at {(b, h, w)} offset scale {scale}: "
                    f"d_weight error {w_err}, d_x error {x_err} of the "
                    f"terms' magnitude sums")
            print(f"deform_bwd_dx at {b} x {h} x {w}, {scale} px: bit-equal "
                  f"across two launches; d_x error {x_err:.3e} of its "
                  f"terms' magnitude sum (limit {DX_ERR_LIMIT:g})",
                  flush=True)
            row["max_abs_err"] = max(
                row["max_abs_err"], (got[0] - ref[0]).abs().max().item(),
                (got[1] - ref[1]).abs().max().item(),
                (got[4] - ref[4]).abs().max().item())
            row["d_weight_err_over_abs_sum"] = max(
                row["d_weight_err_over_abs_sum"], w_err)
            row["d_x_err_over_abs_sum"] = max(row["d_x_err_over_abs_sum"],
                                              x_err)
            # where this data's d_x contributions go: those inside the
            # block's window to shared memory, plus one flush per cell, the
            # rest global (without the window, every in-bounds corner)
            counts = deform_cuda.dx_atomics(offset, h, w)
            row.setdefault("dx_atomics_per_pixel", {})[str(scale)] = {
                k: v / (b * h * w) for k, v in counts.items()}
            if scale == TIMED_SCALE:
                atomics = counts["corners"]
                row["dx_atomics"] = counts
                row["kernel_ms"] = time_ms(lambda: deform_cuda.deform_bwd_dx(
                    x, offset, weight, mask, g), flush)
                row["plain_ms"] = time_ms(
                    lambda: deform_conv2d_backward_plain(
                        x, offset, weight, mask, g, need_dx=True), flush)
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in (x, offset, weight, bias, mask)]
                out = deform_library(*leaves)
                row["library_ms"] = time_ms(lambda: torch.autograd.grad(
                    out, leaves, g, retain_graph=True), flush)
                del out, leaves
        pixels = b * h * w
        row["bound_ms"], row["bound_by"] = k3_bound(b, h, w, atomics,
                                                    bandwidth, fp32_peak)
        row["atomics"] = atomics
        row["atomics_per_pixel"] = atomics / pixels
        row["global_atomics_per_pixel"] = row["dx_atomics"]["global"] / pixels
        row["shared_atomics_per_pixel"] = row["dx_atomics"]["shared"] / pixels
        row["atomics_per_us"] = atomics / (row["kernel_ms"] * 1e3)
        row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        print(f"deform_bwd_dx atomics at {b} x {h} x {w}, {TIMED_SCALE} px: "
              f"global {row['global_atomics_per_pixel']:.3f} per pixel "
              f"(without the window {row['atomics_per_pixel']:.3f}), shared "
              f"{row['shared_atomics_per_pixel']:.3f}", flush=True)
        row["heavy_tails"] = heavy_tails(b, h, w, gen)
        rows.append(row)
        print(f"deform_bwd_dx {row}", flush=True)
    return rows


def check_deform_backward_dx_bf16(dev, bandwidth, fp32_peak):
    """K3's bf16-sampling mode at DX_SHAPES, offsets at each of
    OFFSET_SCALES, against its two halves on the same inputs: d_x bit-equal
    to fp32 K3's, d_offset and d_mask bit-equal to K2-bf16's, d_weight
    within DX_ERR_LIMIT of the terms' magnitude sum of K2-bf16's (the two
    kernels sum it over other blocks); and against its plain version as
    K3 is held (d_offset, d_mask at rtol = atol = 1e-5, d_x and d_weight
    within DX_ERR_LIMIT of their magnitude sums). Timed beside fp32 K3 on
    the same inputs, the plain version and the library form (autograd of
    the fp32 ``grid_sample`` form, ``x`` included); K3's bound. Returns one
    row per shape."""
    name = "deform_bwd_dx_bf16"
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(64 * 2**20, device=dev)
    rows = []
    for b, h, w in DX_SHAPES:
        row = {"shape": [b, 1, h, w], "max_abs_err": 0.0,
               "d_weight_err_over_abs_sum": 0.0,
               "d_x_err_over_abs_sum": 0.0,
               "d_weight_vs_k2_bf16_err_over_abs_sum": 0.0}
        for scale in OFFSET_SCALES:
            x, offset, weight, bias, mask = deform_inputs(b, h, w, scale, gen,
                                                          dev)
            g = torch.randn(b, 1, h, w, generator=gen, device=dev)
            got = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g,
                                            sample_dtype=BF16)
            fp32 = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
            k2 = deform_cuda.deform_bwd(x, offset, weight, mask, g,
                                        sample_dtype=BF16)
            ref = deform_conv2d_backward_plain(x, offset, weight, mask, g,
                                               need_dx=True,
                                               sample_dtype=BF16)
            abs_sum = deform_conv2d_backward_plain(
                x.abs(), offset, weight.abs(), mask.abs(), g.abs(),
                need_dx=True, sample_dtype=BF16)
            torch.cuda.synchronize()
            halves = {"d_x == fp32 K3's": torch.equal(got[4], fp32[4]),
                      "d_offset == K2-bf16's": torch.equal(got[0], k2[0]),
                      "d_mask == K2-bf16's": torch.equal(got[1], k2[1])}
            if not all(halves.values()):
                raise AssertionError(f"{name} at {(b, h, w)} offset scale "
                                     f"{scale}: {halves}")
            k2_err = _err_over_abs_sum(got[2], k2[2], abs_sum[2])
            for part, a, r in zip(("d_offset", "d_mask", "d_bias"),
                                  got[:2] + got[3:4], ref[:2] + ref[3:4]):
                if not torch.allclose(a, r, rtol=1e-5, atol=1e-5):
                    raise AssertionError(
                        f"{name} {part} disagrees with the plain backward at "
                        f"{(b, h, w)} offset scale {scale}: max |err| "
                        f"{(a - r).abs().max().item()}")
            w_err = _err_over_abs_sum(got[2], ref[2], abs_sum[2])
            x_err = _err_over_abs_sum(got[4], ref[4], abs_sum[4])
            if max(w_err, x_err, k2_err) > DX_ERR_LIMIT:
                raise AssertionError(
                    f"{name} at {(b, h, w)} offset scale {scale}: d_weight "
                    f"error {w_err} (against K2-bf16 {k2_err}), d_x error "
                    f"{x_err} of the terms' magnitude sums")
            print(f"{name} at {b} x {h} x {w}, {scale} px: d_x bit-equal to "
                  f"fp32 K3's, d_offset and d_mask to K2-bf16's; d_weight "
                  f"{k2_err:.3e} from K2-bf16's, d_x error {x_err:.3e} of its "
                  f"magnitude sum (limit {DX_ERR_LIMIT:g})", flush=True)
            row["max_abs_err"] = max(
                row["max_abs_err"], (got[0] - ref[0]).abs().max().item(),
                (got[1] - ref[1]).abs().max().item(),
                (got[4] - ref[4]).abs().max().item())
            for key, err in (("d_weight_err_over_abs_sum", w_err),
                             ("d_x_err_over_abs_sum", x_err),
                             ("d_weight_vs_k2_bf16_err_over_abs_sum",
                              k2_err)):
                row[key] = max(row[key], err)
            if scale == TIMED_SCALE:
                atomics = deform_cuda.dx_atomics(offset, h, w)["corners"]
                row["kernel_ms"] = time_ms(lambda: deform_cuda.deform_bwd_dx(
                    x, offset, weight, mask, g, sample_dtype=BF16), flush)
                row["fp32_mode_ms"] = time_ms(
                    lambda: deform_cuda.deform_bwd_dx(x, offset, weight,
                                                      mask, g), flush)
                row["plain_ms"] = time_ms(
                    lambda: deform_conv2d_backward_plain(
                        x, offset, weight, mask, g, need_dx=True,
                        sample_dtype=BF16), flush)
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in (x, offset, weight, bias, mask)]
                out = deform_library(*leaves)
                row["library_ms"] = time_ms(lambda: torch.autograd.grad(
                    out, leaves, g, retain_graph=True), flush)
                del out, leaves
        # K3's bound: the same bytes and operations (its d_x is K3's)
        row["bound_ms"], row["bound_by"] = k3_bound(b, h, w, atomics,
                                                    bandwidth, fp32_peak)
        row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        row["kernel_over_fp32_mode"] = row["kernel_ms"] / row["fp32_mode_ms"]
        rows.append(row)
        print(f"{name} {row}", flush=True)
    return rows


def k3_bf16_autograd(dev) -> tuple:
    """K3's bf16 mode as the op's autograd reaches it: ``deform_conv2d(x
    requiring its gradient, ..., sample_dtype="bfloat16").sum()
    .backward()`` at 2 x 128^2 launches K1-bf16 once and K3-bf16 once,
    and gives the plain backward's gradients (d_x and d_mask at rtol =
    atol = 1e-5 of K3-bf16's); then the same on the row slab of image rows
    [64, 128) (``y0``: K1-bf16 and K3-bf16 on a slab once each, d_x the
    whole image's from the slab's rows). Returns the launch counts of
    each."""
    gen = torch.Generator(device=dev).manual_seed(8)
    x, offset, weight, bias, mask = deform_inputs(2, 128, 128, TIMED_SCALE,
                                                  gen, dev)
    counts = []
    for y0, want in ((0, deform_counts(deform_fwd_bf16=1,
                                       deform_bwd_dx_bf16=1)),
                     (64, deform_counts(deform_fwd_bf16_slab=1,
                                        deform_bwd_dx_bf16_slab=1))):
        off = offset[:, :, y0:].contiguous()
        leaves = [x.detach().clone().requires_grad_(True),
                  mask[:, :, y0:].contiguous().requires_grad_(True)]
        reset_launches()
        deform_conv2d(leaves[0], off, weight, bias, leaves[1],
                      sample_dtype=BF16, y0=y0).sum().backward()
        torch.cuda.synchronize()
        launches = dict(deform_cuda.LAUNCHES)
        print(f"K3-bf16 through the op's autograd, y0 {y0}: launches "
              f"{launches}", flush=True)
        if launches != want:
            raise AssertionError(f"deform_conv2d(..., sample_dtype=bfloat16,"
                                 f" y0={y0}) with x's gradient launched "
                                 f"{launches}")
        ref = deform_conv2d_backward_plain(
            x, off, weight, leaves[1].detach(),
            torch.ones_like(leaves[1][:, :1]), need_dx=True,
            sample_dtype=BF16, y0=y0)
        for leaf, r in zip(leaves, (ref[4], ref[1])):
            if not torch.allclose(leaf.grad, r, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"K3-bf16 through autograd, y0 {y0}, "
                                     f"disagrees with the plain backward")
        counts.append(launches)
    return tuple(counts)


def write_scenes(root: Path, scenes, seed: int = 0, holes: float = 0.0):
    """Smooth synthetic terrain in metres, a 0-255 RGB orthophoto and a
    15-channel one-hot land-use mask per scene, as .npy rasters in the
    DFC30 subdirectory layout; the share ``holes`` of the DEM's pixels at
    -80 m (no data, the configs' minimum elevation), in contiguous voids
    (DEM voids are regions: radar shadow, water)."""
    rng = np.random.default_rng(seed)
    for name, side in scenes:
        h, w = (side, side) if isinstance(side, int) else side
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        yy, xx = yy / h, xx / w
        fx, fy, ph = rng.uniform(2, 6, 3)
        dem = (150 + 120 * np.sin(fx * np.pi * xx + ph)
               * np.cos(fy * np.pi * yy) + 60 * xx
               + rng.normal(0, 0.5, (h, w)))
        if holes:
            fv = rng.uniform(3, 9, 2)
            voids = (np.sin(fv[0] * np.pi * xx + ph)
                     * np.sin(fv[1] * np.pi * yy))
            dem[voids > np.quantile(voids, 1.0 - holes)] = -80.0
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = np.eye(15, dtype=np.uint8)[rng.integers(0, 15, (h, w))]
        scene = root / name
        write_raster(scene / "COP30" / "dem.npy", dem.astype(np.float32)[..., None])
        write_raster(scene / "BDORTHO" / "ortho.npy", img)
        write_raster(scene / "UA2012" / "ua.npy", mask)


def serving_config(name: str, model_name: str, model_kwargs: dict,
                   ckpt: Path, **keys) -> dict:
    """The serving keys of the r8 configs (configs/*_r8_img_msk.yml), with
    ``keys`` in place of theirs."""
    return {
        "name": f"chip_smoke_{name}", "dataset": "DFC30",
        "resolution": 8, "input_data": {"COP30": 1, "image": 3, "mask": 15},
        "relative": True, "patch_size": 128,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "model_name": model_name,
        "model_kwargs": {**model_kwargs, "checkpoint": str(ckpt)},
        "optimizer_kwargs": {"lr": 0.001}, "metric": {}, **keys,
    }


def seeded_checkpoint(work: Path, name: str, model_name: str,
                      model_kwargs: dict, **keys):
    """A serving config (``serving_config``'s, ``keys`` in place of its
    own) and a checkpoint of its model's seeded weights, perturbed;
    returns (config, config path, checkpoint path)."""
    work.mkdir(parents=True, exist_ok=True)
    ckpt = work / f"{name}.pt"
    cfg_path = work / f"{name}.json"
    cfg_path.write_text(json.dumps(serving_config(name, model_name,
                                                  model_kwargs, ckpt,
                                                  **keys)))
    p = create_config(cfg_path)
    model = perturb_weights(
        build_model(p, generator=torch.Generator().manual_seed(0)), seed=1)
    torch.save(model.state_dict(), ckpt)
    n_params = sum(t.numel() for t in model.parameters())
    print(f"{model_name}: {n_params} parameters", flush=True)
    return p, cfg_path, ckpt


def run_cli(argv):
    """The port's CLI, its stdout logger closed afterwards."""
    real_stdout = sys.stdout
    try:
        return cli_main(argv)
    finally:
        logger, sys.stdout = sys.stdout, real_stdout
        if logger is not real_stdout:
            logger.close()


def check_outputs(paths, scenes, scene_root: Path, near_input: bool,
                  relative: bool = True):
    """One finite raster of each scene's shape in metres: with
    ``near_input`` its mean within the input's elevation range (JSPSR's
    SPN head refines the input even at random weights), else every value
    within the range the configs' descaling gives the clipped [0, 1]
    prediction above the scene's base (random weights need not refine);
    without ``relative`` (LRRU's serving scale) the base is 0 m and the
    descaling linear."""
    if len(paths) != len(scenes):
        raise AssertionError(f"{len(paths)} rasters for {len(scenes)} scenes")
    for path, (name, side) in zip(paths, scenes):
        arr = read_raster(path)
        dem = read_raster(scene_root / name / "COP30" / "dem.npy")
        if arr.shape != dem.shape or not np.isfinite(arr).all():
            raise AssertionError(f"{path}: shape {arr.shape}, finite "
                                 f"{np.isfinite(arr).all()}")
        lo, hi = float(dem.min()), float(dem.max())
        if near_input and not (lo - 50 < float(arr.mean()) < hi + 50):
            raise AssertionError(f"{path}: mean {arr.mean()} outside the "
                                 f"input's range [{lo}, {hi}] m")
        # log-minmax over [-80, 929] m: descale(0) = -79, descale(1) = 929;
        # linear: -80 and 929
        base, bottom = (lo, 79.5) if relative else (0.0, 80.5)
        if not (base - bottom <= float(arr.min()) and
                float(arr.max()) <= base + 929.5):
            raise AssertionError(f"{path}: values [{arr.min()}, {arr.max()}]"
                                 f" outside the descaled range above {lo} m")


def card_vs_cpu_scene(p, ckpt, scene_dir, dev, rtol, atol,
                      scale_atol=False):
    """One scene through ``upscale_dem`` on the card and on the CPU from the
    same checkpoint, at ``rtol`` and ``atol`` (times the output's largest
    magnitude, at least 1, with ``scale_atol``): (max |card - CPU|, warm
    card ms (best of 3), the output's largest magnitude)."""
    sample, _ = load_scene(scene_dir, p)
    fwd_gpu = make_forward(checkpoint_model(p, ckpt).to(dev))
    got = upscale_dem(fwd_gpu, sample, p, dev)[0]
    warm_ms = min(upscale_dem(fwd_gpu, sample, p, dev)[1] for _ in range(3))
    fwd_cpu = make_forward(checkpoint_model(p, ckpt))
    ref = upscale_dem(fwd_cpu, sample, p, "cpu")[0]
    scale = float(np.abs(ref).max())
    if scale_atol:
        atol *= max(1.0, scale)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                               err_msg=f"card vs CPU, {scene_dir.name}")
    return float(np.abs(got - ref).max()), warm_ms, scale


class Float64(torch.nn.Module):
    """``model`` in float64 behind its fp32 interface: the inputs cast up,
    the output cast back (a rounding of 6e-8, far below the checks)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model.double()

    def forward(self, inputs, generator=None):
        return self.model([x.double() for x in inputs]).float()


def hold_to_float64(got, fp32, ref, rtol, atol, what: str,
                    cpu: str = "fp32") -> dict:
    """``got`` (the card's output) against ``ref`` (the CPU's float64) at
    rtol ``rtol`` and an atol of ``atol`` plus three times the largest
    distance of ``fp32`` (the CPU's run of the same model on the same
    input, named ``cpu``: fp32, or bf16 for phase 13) from ``ref``: the
    elementwise form of phase 5's rule. A random-weight LRRU is
    ill-conditioned in fp32 (``LRRU_ATOL``); the distances are returned
    and printed."""
    dist = float(np.abs(fp32 - ref).max())
    out = {"card_vs_fp64_max_abs": float(np.abs(got - ref).max()),
           f"cpu_{cpu}_vs_fp64_max_abs": dist,
           "card_vs_cpu_max_abs": float(np.abs(got - fp32).max()),
           "atol": atol + 3 * dist}
    print(f"{what} against float64: {out}", flush=True)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol + 3 * dist,
                               err_msg=f"card vs float64, {what}")
    return out


def scaled_raster(raster: np.ndarray, sample: dict, p) -> np.ndarray:
    """A served raster (metres) back in the model's scaled domain, the
    inverse of the server's descale above the scene's base (float64; the
    served values were clipped to [0, 1] first): the log descale
    multiplies a scaled error by up to 7 x 1009 m, so a comparison in
    metres resolves little."""
    tk = p.get("tensor_kwargs")
    base = prepare_scene(sample, p, tile=p.patch_size).base
    return scale_data(raster.astype(np.float64), tk["min"], tk["max"],
                      tk["log"], base_elev=base)


def card_vs_float64_scene(p, ckpt, scene_dir, dev, rtol, atol) -> dict:
    """One scene through ``upscale_dem`` on the card, and on the CPU in
    float64 and in fp32, from the same checkpoint, held by
    ``hold_to_float64`` with ``atol`` times the output's largest magnitude
    (at least 1); with the warm card ms (best of 3) and that
    magnitude."""
    sample, _ = load_scene(scene_dir, p)
    fwd_gpu = make_forward(checkpoint_model(p, ckpt).to(dev))
    got = upscale_dem(fwd_gpu, sample, p, dev)[0]
    warm_ms = min(upscale_dem(fwd_gpu, sample, p, dev)[1] for _ in range(3))
    cpu = checkpoint_model(p, ckpt)
    fp32 = upscale_dem(make_forward(cpu), sample, p, "cpu")[0]
    ref = upscale_dem(make_forward(Float64(cpu)), sample, p, "cpu")[0]
    scale = max(1.0, float(np.abs(ref).max()))
    out = hold_to_float64(got, fp32, ref, rtol, atol * scale,
                          f"{p.model_name} {scene_dir.name}")
    return {**out, "warm_ms": warm_ms, "output_max_abs": scale}


def reset_launches() -> None:
    deform_cuda.reset_launches()
    conv_same_mod.reset_launches()


def launch_counts() -> dict:
    return {**deform_cuda.LAUNCHES, **conv_same_mod.LAUNCHES}


def serve(work: Path, dev: torch.device, flagship):
    """The serving path: the flagship JSPSR through the port's CLI over a
    directory of scenes; ``flagship`` is ``seeded_checkpoint``'s triple."""
    p, cfg_path, ckpt = flagship
    write_scenes(work / "scenes", SCENES)

    out_dir, res_dir = work / "out", work / "result"
    reset_launches()
    paths = run_cli(["--config", str(cfg_path), "--infer",
                     str(work / "scenes"), "--out", str(out_dir),
                     "--result-dir", str(res_dir)])
    launches = dict(deform_cuda.LAUNCHES)
    print(f"serving-path launches: {launches}", flush=True)
    if launches != deform_counts(deform_fwd=len(SCENES)):
        raise AssertionError(f"launches {launches} for {len(SCENES)} scenes")
    check_outputs(paths, SCENES, work / "scenes", near_input=True)

    log = (res_dir / "train.log").read_text()
    per_scene = {m[1]: {"ms": float(m[2]), "peak_mb": float(m[3])}
                 for m in re.finditer(r"Scene (\S+): ([\d.]+) ms, peak ([\d.]+) MB",
                                      log)}
    total = re.search(r"Inference: \d+ scenes -> .* \(([\d.]+) ms, ([\d.]+) "
                      r"scenes/s\)", log)

    # warm re-runs of each scene size (not counted): steady latency; the
    # 334^2 scene on the card against the port on the CPU (a cut: the
    # 1024^2 one too, about 40 s of host time, until phase 16 pushed the
    # script past 1,000 s on an NVIDIA H100 80GB HBM3 host, 700 W)
    (big, big_side), (name, side) = SCENES[-1], SCENES[0]
    sample, _ = load_scene(work / "scenes" / big, p)
    fwd = make_forward(checkpoint_model(p, ckpt).to(dev))
    upscale_dem(fwd, sample, p, dev)
    warm = {f"{big_side}x{big_side}": min(
        upscale_dem(fwd, sample, p, dev)[1] for _ in range(3))}
    del fwd
    err, warm[f"{side}x{side}"], _ = card_vs_cpu_scene(
        p, ckpt, work / "scenes" / name, dev, rtol=1e-4, atol=2e-5)
    return {
        "scenes": [f"{s}x{s}" for _, s in SCENES],
        "per_scene": per_scene,
        "total_ms": float(total[1]), "scenes_per_s": float(total[2]),
        "warm_ms": warm, "cpu_max_abs_err": err,
    }, launches


def serve_cf(work: Path, dev: torch.device):
    """CompletionFormer serving: one 334^2 scene through the port's CLI."""
    mk = dict(create_config(CF_CONFIG).model_kwargs)
    mk = {k: v for k, v in mk.items() if k not in ("checkpoint", "pretrained")}
    p, cfg_path, ckpt = seeded_checkpoint(work, "completionformer_r8_img_msk",
                                          "CompletionFormer", mk)
    write_scenes(work / "scenes", [CF_SCENE], seed=1)
    scene = work / "scenes" / CF_SCENE[0]
    out, res_dir = work / "out" / f"{CF_SCENE[0]}_sr.npy", work / "result"
    reset_launches()
    path = run_cli(["--config", str(cfg_path), "--infer", str(scene),
                    "--out", str(out), "--result-dir", str(res_dir)])
    launches = dict(deform_cuda.LAUNCHES)
    print(f"cf-serving-path launches: {launches}", flush=True)
    if launches != deform_counts(deform_fwd=6):
        raise AssertionError(f"launches {launches} for one scene")
    check_outputs([path], [CF_SCENE], work / "scenes", near_input=False)
    m = re.search(r"Inference: .* \(([\d.]+) ms, peak ([\d.]+) MB\)",
                  (res_dir / "train.log").read_text())
    # the JAX suite's CompletionFormer tolerance, rtol 1e-3 / atol 1e-4, set
    # for outputs in the [0, 1] range of a scaled DEM; atol scales with the
    # output's range, which random weights widen
    err, warm_ms, scale = card_vs_cpu_scene(p, ckpt, scene, dev, rtol=1e-3,
                                            atol=1e-4, scale_atol=True)
    return {"scene": f"{CF_SCENE[1]}x{CF_SCENE[1]}", "cold_ms": float(m[1]),
            "peak_mb": float(m[2]), "warm_ms": warm_ms,
            "cpu_max_abs_err": err, "output_max_abs": scale,
            "launches": launches}, launches


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative L2 error of one tensor (absolute where ``ref`` is 0)."""
    diff = (got.double().cpu() - ref.double().cpu()).norm()
    return float(diff / max(float(ref.double().norm()), 1e-12))


def checkpoint_model(p, ckpt) -> torch.nn.Module:
    """``build_model(p)`` holding the weights of the checkpoint ``ckpt``,
    built on the meta device and then allocated on the CPU: the random
    init that the checkpoint replaces is skipped (seconds of host time per
    build; every parameter and buffer of the shipped families is in the
    checkpoint, so the model is bit for bit the one a built and loaded
    model is)."""
    with torch.device("meta"):
        model = build_model(p)
    return load_model_params(model.to_empty(device="cpu"), ckpt)


def model_from_state(p, state) -> torch.nn.Module:
    """``build_model(p)`` holding copies of the tensors of ``state``, built
    on the meta device: the random init that ``state`` replaces is skipped
    (CompletionFormer's takes seconds of host time per build)."""
    with torch.device("meta"):
        model = build_model(p)
    model.load_state_dict({k: v.clone() for k, v in state.items()},
                          assign=True)
    return model


def step_state(p, state, device, dtype, inputs, gt):
    """One full-width train step of the port from the weights ``state``:
    (loss, {param: grad}, {BatchNorm buffer: value})."""
    model = model_from_state(p, state).to(device=device, dtype=dtype)
    step = make_train_step(model, build_criterion(dict(p.loss)),
                           build_optimizer(p, model))
    losses = step([x.to(device, dtype) for x in inputs], gt.to(device, dtype))
    return (float(losses["Total"]),
            {n: q.grad.cpu() for n, q in model.named_parameters()
             if q.grad is not None},
            {n: b.cpu() for n, b in model.named_buffers() if "running" in n})


def fp64_floor(name: str) -> float:
    """The floor of the train-step rule for the tensor ``name``."""
    return SA_CONV_FLOOR if name.endswith(SA_CONV_SUFFIX) else CARD_FP64_FLOOR


def train_batch(p, batch: int, seed: int, holes: float = 0.0):
    """``random_batch``'s batch of ``batch`` x 128^2 on the CPU, with the
    share ``holes`` of the DEM's pixels set to 0 (no data)."""
    inputs, gt = random_batch(p, batch, 128, "cpu", seed=seed)
    if holes:
        gen = torch.Generator().manual_seed(seed)
        inputs[0] = inputs[0].masked_fill(
            torch.rand(inputs[0].shape, generator=gen) < holes, 0.0)
    return inputs, gt


def compare_train_step(p, dev, state, batch: int, holes: float = 0.0):
    """One train step on ``batch`` x 128^2 on the card against the port on
    the CPU, both against float64 on the CPU, from the weights ``state``:
    the loss, and every gradient and BatchNorm running statistic no
    further (relative L2) from float64 than three times the CPU fp32
    run's distance plus its floor (``fp64_floor``). Returns the errors,
    the tensors furthest beyond three times the CPU's distance first."""
    inputs, gt = train_batch(p, batch, 3, holes)
    card = step_state(p, state, dev, torch.float32, inputs, gt)
    cpu = step_state(p, state, "cpu", torch.float32, inputs, gt)
    f64 = step_state(p, state, "cpu", torch.float64, inputs, gt)
    loss_err = abs(card[0] - cpu[0]) / abs(cpu[0])
    if loss_err > 1e-4:
        raise AssertionError(f"train-step loss: card {card[0]} vs CPU "
                             f"{cpu[0]}")
    out = {"batch": [batch, 128, 128], "loss_rel_err": loss_err}
    for i, what in ((1, "grad"), (2, "bn")):
        if set(card[i]) != set(f64[i]):
            raise AssertionError(f"train-step {what}: card and float64 "
                                 "differ in which tensors they have")
        rows = []
        for name, ref in f64[i].items():
            e_card = _rel_err(card[i][name], ref)
            e_fp32 = _rel_err(cpu[i][name], ref)
            rows.append((e_card - 3 * e_fp32, e_card, e_fp32,
                         _rel_err(card[i][name], cpu[i][name]), name))
        rows.sort(reverse=True)  # the furthest beyond the rule first
        if not rows:  # EDSR as shipped holds no BatchNorm
            out[what] = {"tensors": 0}
            continue
        out[what] = {
            "tensors": len(rows),
            "card_vs_fp64_max": max(r[1] for r in rows),
            "card_vs_fp64_median": statistics.median(r[1] for r in rows),
            "cpu_fp32_vs_fp64_max": max(r[2] for r in rows),
            "card_vs_cpu_max": max(r[3] for r in rows),
            "largest_excess": [
                {"name": n, "card_vs_fp64": a, "cpu_fp32_vs_fp64": b,
                 "card_vs_cpu": c} for _, a, b, c, n in rows[:4]],
        }
        bad = [r[4] for r in rows if r[0] > fp64_floor(r[4])]
        if bad:
            raise AssertionError(
                f"train-step {what}: {bad} beyond 3 x the CPU fp32 distance "
                f"from fp64 + their floor: {out[what]}")
    return out


def step_twice(p, dev, state, batch: int, holes: float = 0.0) -> dict:
    """The same train step twice on the card, each time from a fresh model
    holding the weights ``state`` and a fresh optimizer, on one batch of
    ``batch`` x 128^2, the model's generator seeded for global step 0 both
    times: how many parameters and BatchNorm buffers differ after the two
    steps, and by how much at most."""
    inputs, gt = train_batch(p, batch, 4, holes)
    after = []
    for _ in range(2):
        model = model_from_state(p, state).to(dev)
        gen = torch.Generator(dev)
        seed_step_generator(gen, p.get("seed", 0), 0)
        step = make_train_step(model, build_criterion(dict(p.loss)),
                               build_optimizer(p, model), generator=gen)
        step([x.to(dev) for x in inputs], gt.to(dev))
        torch.cuda.synchronize()
        after.append({n: t.detach().clone() for n, t in
                      [*model.named_parameters(), *model.named_buffers()]})
        del model, step
    first, second = after
    unequal = [n for n in first if not torch.equal(first[n], second[n])]
    diff = max(((first[n].double() - second[n].double()).abs().max().item()
                for n in unequal), default=0.0)
    return {"batch": [batch, 128, 128], "tensors": len(first),
            "unequal": len(unequal), "max_abs_diff": diff,
            "unequal_names": unequal[:8]}


def make_train_tree(root: Path) -> float:
    """The synthetic DFC30 tree of the r8 configs' 13 train cities (12
    samples of 128^2 each) and 3 valid cities (4 samples each); returns the
    seconds taken."""
    p = create_config(FLAGSHIP)
    t0 = time.perf_counter()
    generate_mini_dfc30(root, train_cities=p.train_set, valid_cities=(),
                        n_per_city=TRAIN_SCENES_PER_CITY, size=TRAIN_SIDE)
    for city in p.valid_set:
        generate_city(root, city, VALID_SCENES_PER_CITY, size=TRAIN_SIDE)
    return time.perf_counter() - t0


def unreached_heads(p, dev, state) -> dict:
    """One LRRU train step on the card from the weights ``state``: every
    parameter of the heads of rounds 1-3 (``UNREACHED``) must hold a zero
    gradient, and AdamW must have taken its step on every parameter (the
    step count of each is 1), as optax's does on the JAX package's exact
    zero gradients."""
    model = model_from_state(p, state).to(dev)
    opt = build_optimizer(p, model)
    step = make_train_step(model, build_criterion(dict(p.loss)), opt)
    inputs, gt = train_batch(p, 4, 5, LRRU_HOLES)
    step([x.to(dev) for x in inputs], gt.to(dev))
    heads = [(n, q) for n, q in model.named_parameters()
             if n.startswith(UNREACHED)]
    nonzero = [n for n, q in heads if bool(q.grad.any())]
    steps = sorted({int(opt.state[q]["step"]) for q in model.parameters()
                    if q in opt.state})
    out = {"head_tensors": len(heads), "nonzero_grads": nonzero,
           "adam_state_tensors": len(opt.state),
           "parameters": len(list(model.parameters())), "adam_steps": steps}
    print(f"LRRU unreached heads after one step: {out}", flush=True)
    if (nonzero or not heads or steps != [1]
            or out["adam_state_tensors"] != out["parameters"]):
        raise AssertionError(f"LRRU's unreached heads: {out}")
    return out


def train(config: Path, root: Path, work: Path, dev: torch.device,
          compare_batch: int, perturbed: bool, label: str | None = None,
          model_kwargs: dict | None = None, holes: float = 0.0,
          epochs: tuple = (0, 1)):
    """A training path: ``config`` as it is (``model_kwargs`` over its
    own), on the synthetic tree at ``root``, through the port's Trainer
    for ``epochs``, with exactly ``PER_STEP[label]`` launches per step
    (``label`` defaults to the model's name); then one more epoch through
    the same Trainer with cuDNN free to choose non-deterministic
    algorithms (PyTorch's defaults), whose warm steps are printed beside
    the deterministic ones; then one train step on the
    card held against the CPU and float64 (from the seeded weights,
    ``perturbed`` or not); then one step at the train batch run twice from
    the same state (``step_twice``): every parameter and buffer must come
    out bit-equal. The two checks' DEMs have the share ``holes`` of their
    pixels set to 0."""
    p = create_config(config)
    p.dataset_path = str(root)
    p.model_kwargs.update(model_kwargs or {})
    label = label or p.model_name
    trainer = Trainer(p, result_dir=work, device=dev)
    inner, steps = trainer.train_step, []
    timed = steps

    def timed_step(inputs, gt):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = inner(inputs, gt)
        end.record()
        timed.append((start, end, losses["Total"]))
        return losses

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    ran = []
    for epoch in epochs:
        loss, lr = trainer.train_one_epoch(epoch)
        ran.append({"epoch": epoch, "loss": loss, "lr": lr,
                    "tiles_per_s": trainer.last_throughput})
    torch.cuda.synchronize()
    launches = dict(deform_cuda.LAUNCHES)
    n_steps = len(steps)
    print(f"{label} training-path launches: {launches} in {n_steps} "
          f"steps", flush=True)
    n_samples = len(p.train_set) * TRAIN_SCENES_PER_CITY
    want = {k: v * n_steps for k, v in PER_STEP[label].items()}
    if (n_steps != len(epochs) * (n_samples // p.train_batch_size)
            or launches != want):
        raise AssertionError(f"launches {launches} for {n_steps} steps")
    step_losses = [float(t) for _, _, t in steps]
    if not all(np.isfinite(step_losses + [e["loss"] for e in ran])):
        raise AssertionError(f"non-finite loss: {step_losses} {ran}")
    step_ms = [s.elapsed_time(e) for s, e, _ in steps]
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    n_params = sum(q.numel() for q in trainer.model.parameters())
    batch = p.train_batch_size
    # the same Trainer's next epoch with cuDNN free (its first step carries
    # the new algorithms' set-up: the warm steps follow)
    timed = []
    torch.backends.cudnn.deterministic = False
    trainer.train_one_epoch(max(epochs) + 1)
    torch.cuda.synchronize()
    set_deterministic_cudnn()
    free = statistics.median(s.elapsed_time(e) for s, e, _ in timed[1:])
    del trainer
    mark(f"{label} epochs")

    model = build_model(p)
    state = (perturb_weights(model, seed=2) if perturbed
             else model).state_dict()
    errs = compare_train_step(p, dev, state, compare_batch, holes)
    mark(f"{label} step on the card against the CPU and float64")
    # epoch 0's first step carries cuDNN's set-up: the warm steps follow
    warm = statistics.median(step_ms[1:])
    twice = step_twice(p, dev, state, batch, holes)
    print(f"{label} step twice from one state at batch {batch}: "
          f"{twice['unequal']} of {twice['tensors']} tensors differ, max "
          f"|diff| {twice['max_abs_diff']}; warm step median {warm:.1f} ms, "
          f"{batch / warm * 1e3:.1f} tiles/s, peak {peak_mb:.0f} MB (cuDNN "
          f"free to choose its algorithms, the next epoch: {free:.1f} ms)",
          flush=True)
    if twice["unequal"]:
        raise AssertionError(f"{label}: the same step from the same "
                             f"state is not bit-equal: {twice}")
    out = {
        "config": str(config.relative_to(REPO)), "model": label,
        "model_kwargs_over_config": model_kwargs or {},
        "parameters": n_params, "batch": batch, "patch": p.patch_size,
        "train_samples": n_samples, "steps": n_steps,
        "step_losses": step_losses, "step_ms": step_ms,
        "step_ms_warm_median": warm, "tiles_per_s_warm": batch / warm * 1e3,
        "step_ms_warm_median_cudnn_free": free,
        "epochs": ran, "peak_mb": peak_mb,
        "peak_source": "torch.cuda.max_memory_allocated over the epochs",
        "launches": launches, "card_vs_cpu_step": errs,
        "step_twice": twice,
    }
    if label == "LRRU":
        out["unreached_heads"] = unreached_heads(p, dev, state)
    return out, launches


def check_conv_same(dev, bandwidth, fp32_peak, bf16_peak):
    """K4 against its plain version at the TPU probe's four cases; returns
    one row per case."""
    flush = torch.empty(64 * 2**20, device=dev)
    rows = []
    for tag, b, h, w, cin, cout, kk, dt in bench_conv_same.CASES:
        x, w1, _ = bench_conv_same.case_inputs(b, h, w, cin, cout, kk, dt, dev)
        got = conv_same(x, w1)
        ref = conv_same_plain(x, w1)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = bench_conv_same.TOL[dt]
        if not err <= tol * max(scale, 1.0):
            raise AssertionError(f"conv_same {tag}: max |err| {err} against "
                                 f"its plain version > {tol} x max(1, "
                                 f"{scale})")
        w_oihw = bench_conv_same.oihw(w1)
        lib_err = (bench_conv_same.cudnn_conv(x, w_oihw).float()
                   - ref.float()).abs().max().item()
        row = {"case": tag, "shape": [b, h, w, cin, cout, kk],
               "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
               "plain_max_abs": scale, "tol": tol,
               "library_max_abs_err": lib_err,
               "kernel_ms": time_ms(lambda: conv_same(x, w1), flush),
               "plain_ms": time_ms(lambda: conv_same_plain(x, w1), flush),
               "library_ms": time_ms(
                   lambda: bench_conv_same.cudnn_conv(x, w_oihw), flush)}
        # x and w read once, y written once, in the working type; the
        # products on the tensor cores (bf16) or the FFMA units (fp32)
        nbytes = (b * h * w * (cin + cout) + kk * kk * cin * cout) \
            * x.element_size()
        flops = 2 * b * h * w * kk * kk * cin * cout
        peak = bf16_peak if dt == torch.bfloat16 else fp32_peak
        bytes_ms, ops_ms = nbytes / bandwidth * 1e3, flops / peak * 1e3
        row["bound_ms"] = max(bytes_ms, ops_ms)
        row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        row["tflops"] = flops / row["kernel_ms"] / 1e9
        row["library_tflops"] = flops / row["library_ms"] / 1e9
        row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
        row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        rows.append(row)
        print(f"conv_same {row}", flush=True)
    return rows


def conv_probe():
    """The TPU probe's port, once: its rows and the K4 launches it made."""
    reset_launches()
    rows = bench_conv_same.main()
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"conv-probe launches: {launches}", flush=True)
    if launches["conv_same"] == 0 or launches["deform_fwd"] != 0:
        raise AssertionError(f"the probe ran with launches {launches}")
    return rows, launches


def expected_tiled_launches(p, shapes) -> int:
    """K1 launches of one ``--infer <dir> --tile`` run over scenes of
    ``shapes`` (one JSPSR forward per chunk): the sum over scene groups of
    ceil(S * n / infer_tile_batch), S the padded group size and n the
    tiles per scene."""
    tile, cap = p.patch_size, int(p.get("infer_tile_batch") or 96)
    sb = auto_scene_batch(shapes[0], tile=tile, n_scenes=len(shapes))
    n = tile_grid(shapes[0][0], tile)[1] * tile_grid(shapes[0][1], tile)[1]
    groups = -(-len(shapes) // sb)
    return groups * -(-sb * n // cap)


def _scenes_per_s(log: str) -> float:
    m = re.findall(r"Inference: \d+ scenes -> .* \(([\d.]+) ms, ([\d.]+) "
                   r"scenes/s\)", log)
    return float(m[-1][1])


def serve_tiled(work: Path, dev: torch.device, flagship):
    """Phase 9: the flagship through ``--infer --tile`` (the pipelined
    server over two directories, then one rectangular scene)."""
    p, cfg_path, ckpt = flagship
    dirs = {"334": TILED_SMALL, "1024": TILED_LARGE}
    for seed, (name, scenes) in enumerate(dirs.items()):
        write_scenes(work / name, scenes, seed=2 + seed)
    write_scenes(work / "rect", [TILED_RECT], seed=4)
    model = checkpoint_model(p, ckpt).to(dev)
    out, launches, expected = {}, {}, {}

    def served_vs_single(paths, scenes, root):
        err = 0.0
        for path, (name, _) in zip(paths, scenes):
            sample, _ = load_scene(root / name, p)
            single = tile_inference_device(model, sample, p, tile=p.patch_size,
                                           device=dev)[0]
            served = read_raster(path)
            np.testing.assert_allclose(served, single, rtol=BATCH_RTOL,
                                       atol=BATCH_ATOL,
                                       err_msg=f"served vs single, {name}")
            err = max(err, float(np.abs(served - single).max()))
        return err

    for name, scenes in dirs.items():
        shapes = [(s, s) for _, s in scenes]
        expected[name] = expected_tiled_launches(p, shapes)
        rates = []
        for run in range(2):
            res_dir = work / f"result_{name}_{run}"
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            paths = run_cli(["--config", str(cfg_path), "--infer",
                             str(work / name), "--tile", "--out",
                             str(work / f"out_{name}_{run}"),
                             "--result-dir", str(res_dir)])
            torch.cuda.synchronize()
            got = launch_counts()
            if run == 0:
                launches[f"tiled_{name}"] = got
            want = {**deform_counts(deform_fwd=expected[name]),
                    "conv_same": 0}
            if got != want:
                raise AssertionError(f"tiled {name}: launches {got}, "
                                     f"expected {want}")
            rates.append(_scenes_per_s((res_dir / "train.log").read_text()))
            peak = torch.cuda.max_memory_allocated(dev) / 2**20
        check_outputs(paths, scenes, work / name, near_input=True)
        out[name] = {"scenes": len(scenes), "scene_batch": auto_scene_batch(
                         shapes[0], tile=p.patch_size, n_scenes=len(scenes)),
                     "scenes_per_s": rates, "warm_scenes_per_s": rates[1],
                     "peak_mb": peak,
                     "served_vs_single_max_abs_err": served_vs_single(
                         paths, scenes, work / name)}

    # (c) one rectangular scene on its own
    rect = work / "rect" / TILED_RECT[0]
    reset_launches()
    path = run_cli(["--config", str(cfg_path), "--infer", str(rect), "--tile",
                    "--out", str(work / "out_rect.npy"), "--result-dir",
                    str(work / "result_rect")])
    torch.cuda.synchronize()
    launches["tiled_rect"] = launch_counts()
    expected["rect"] = expected_tiled_launches(p, [TILED_RECT[1]])
    if launches["tiled_rect"]["deform_fwd"] != expected["rect"]:
        raise AssertionError(f"rect: launches {launches['tiled_rect']}")
    check_outputs([path], [TILED_RECT], work / "rect", near_input=True)
    out["rect"] = {"shape": list(TILED_RECT[1]),
                   "served_vs_single_max_abs_err": served_vs_single(
                       [path], [TILED_RECT], work / "rect")}
    print(f"tiled-serving launches: {launches}, expected K1 {expected}",
          flush=True)

    # the card against the port on the CPU, in metres
    cpu_model = checkpoint_model(p, ckpt)
    cpu_err = {}
    for key, scene in (("334", work / "334" / TILED_SMALL[0][0]),
                       ("rect", rect)):
        sample, _ = load_scene(scene, p)
        got = tile_inference_device(model, sample, p, tile=p.patch_size,
                                    device=dev)[0]
        ref = tile_inference_device(cpu_model, sample, p, tile=p.patch_size,
                                    device="cpu")[0]
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-2,
                                   err_msg=f"tiled card vs CPU, {key}")
        cpu_err[key] = float(np.abs(got - ref).max())
    out["cpu_max_abs_err_m"] = cpu_err

    # one 1024^2 scene end to end (read, run, write), tiled and whole
    big = work / "1024" / TILED_LARGE[0][0]
    e2e = {}
    for tile in (True, False):
        times, peaks = [], []
        for i in range(5):
            t0 = time.perf_counter()
            _, _, peak = run_scene_inference(
                model, p, big, work / f"e2e_{tile}_{i}.npy", tile=tile,
                device=dev)
            times.append((time.perf_counter() - t0) * 1e3)
            peaks.append(peak)
        e2e["tiled" if tile else "whole"] = {"best_ms": min(times),
                                             "ms": times,
                                             "peak_mb": max(peaks)}
    out["e2e_1024"] = e2e
    out["launches"] = launches
    out["expected_k1"] = expected
    return out, launches


def serve_family(work: Path, dev: torch.device, label: str,
                 model_name: str, model_kwargs: dict, whole, tiled,
                 rect=None, tol_scaled=(1e-4, 2e-5), tol_tiled=(1e-3, 1e-2),
                 tol_batch=(BATCH_RTOL, BATCH_ATOL), served_fp64=SERVED_FP64,
                 **keys):
    """A seeded checkpoint of ``model_name`` (``label`` a key of
    PER_FORWARD) through the port's CLI: ``--infer`` over ``whole`` (a
    scene directory and its scenes), then over ``rect`` (one scene, a
    directory and its scene) alone, then ``--infer --tile`` over ``tiled``
    twice; exactly ``PER_FORWARD[label]`` K1 launches per whole scene and
    per tile chunk. Every comparison holds the card to the port on the CPU
    in float64 by ``hold_to_float64``: the first scene of ``whole`` and
    ``rect`` (scaled outputs, ``tol_scaled``, atol times the output's
    largest magnitude, at least 1) and the served rasters ``served_fp64``
    (default ``SERVED_FP64``, the last; metres, ``tol_tiled``: the rasters
    are clipped to [0, 1] before the descale, so their magnitude is at
    most 1). Every
    served raster is also held to its scene through
    ``tile_inference_device`` on the card alone at ``tol_batch`` (rtol,
    atol in metres; ``None``: rtol ``tol_tiled[0]`` and twice the largest
    atol the served rasters were held to float64 at, as the two are card
    runs each held that close to float64). ``keys`` go into the serving
    config."""
    p, cfg_path, ckpt = seeded_checkpoint(
        work, label.lower().replace("+", "_"), model_name, model_kwargs,
        input_data=dict(IMG_ONLY), **keys)
    relative = bool(p.get("relative"))
    k1 = PER_FORWARD[label]
    none = {**deform_counts(), "conv_same": 0}
    launches, out = {}, {"config": dict(model_kwargs)}

    runs = [("whole", whole)] + ([("rect", rect)] if rect else [])
    for tag, (root, scenes) in runs:
        res_dir = work / f"result_{tag}"
        target = root / scenes[0][0] if tag == "rect" else root
        reset_launches()
        got_paths = run_cli(["--config", str(cfg_path), "--infer",
                             str(target), "--out",
                             str(work / (f"out_{tag}.npy" if tag == "rect"
                                         else f"out_{tag}")),
                             "--result-dir", str(res_dir)])
        torch.cuda.synchronize()
        got = launch_counts()
        launches[f"{label}_{tag}"] = got
        if got != dict(none, deform_fwd=k1 * len(scenes)):
            raise AssertionError(f"{label} {tag}: launches {got} for "
                                 f"{len(scenes)} scenes")
        got_paths = got_paths if isinstance(got_paths, list) else [got_paths]
        check_outputs(got_paths, scenes, root, near_input=False,
                      relative=relative)
        log = (res_dir / "train.log").read_text()
        out[tag] = {
            "scenes": [list(s) if isinstance(s, tuple) else [s, s]
                       for _, s in scenes],
            "per_scene": {m[1]: {"ms": float(m[2]), "peak_mb": float(m[3])}
                          for m in re.finditer(
                              r"Scene (\S+): ([\d.]+) ms, peak ([\d.]+) MB",
                              log)}}
        total = re.search(r"Inference: \d+ scenes -> .* \(([\d.]+) ms, "
                          r"([\d.]+) scenes/s\)", log)
        if total:
            out[tag]["scenes_per_s"] = float(total[2])
        else:  # one scene: its cold ms and peak
            one = re.search(r"Inference: .* \(([\d.]+) ms, peak "
                            r"([\d.]+|nan) MB\)", log)
            out[tag].update(cold_ms=float(one[1]), peak_mb=float(one[2]))
        out[tag].update(card_vs_float64_scene(
            p, ckpt, root / scenes[0][0], dev, *tol_scaled))
        mark(f"{label} {tag}: served, held to float64")

    root, scenes = tiled
    shapes = [(s, s) for _, s in scenes]
    want = dict(none, deform_fwd=k1 * expected_tiled_launches(p, shapes))
    rates = []
    for run in range(2):
        res_dir = work / f"result_tiled_{run}"
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        paths = run_cli(["--config", str(cfg_path), "--infer", str(root),
                         "--tile", "--out", str(work / f"out_tiled_{run}"),
                         "--result-dir", str(res_dir)])
        torch.cuda.synchronize()
        got = launch_counts()
        if run == 0:
            launches[f"{label}_tiled"] = got
        if got != want:
            raise AssertionError(f"{label} tiled: launches {got}, expected "
                                 f"{want}")
        rates.append(_scenes_per_s((res_dir / "train.log").read_text()))
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    check_outputs(paths, scenes, root, near_input=False, relative=relative)
    model = checkpoint_model(p, ckpt).to(dev)
    cpu_model = checkpoint_model(p, ckpt)
    f64_model = Float64(checkpoint_model(p, ckpt))
    tiled = {"scenes": len(scenes), "scenes_per_s": rates,
             "warm_scenes_per_s": rates[1], "peak_mb": peak,
             "against_float64": {}}
    samples = [load_scene(root / name, p)[0] for name, _ in scenes]
    for i in served_fp64:
        fp32, ref = (tile_inference_device(m, samples[i], p,
                                           tile=p.patch_size,
                                           device="cpu")[0]
                     for m in (cpu_model, f64_model))
        tiled["against_float64"][scenes[i][0]] = hold_to_float64(
            read_raster(paths[i]), fp32, ref, *tol_tiled,
            f"{label} served {scenes[i][0]}")
    mark(f"{label} tiled: served, held to float64")
    if tol_batch is None:
        tol_batch = (tol_tiled[0], 2 * max(
            h["atol"] for h in tiled["against_float64"].values()))
    served_err = 0.0
    for path, (name, _), sample in zip(paths, scenes, samples):
        served = read_raster(path)
        single = tile_inference_device(model, sample, p, tile=p.patch_size,
                                       device=dev)[0]
        np.testing.assert_allclose(
            served, single, rtol=tol_batch[0], atol=tol_batch[1],
            err_msg=f"{label} served vs single {name}")
        served_err = max(served_err, float(np.abs(served - single).max()))
    tiled.update(served_vs_single_max_abs_err_m=served_err,
                 served_vs_single_tol=list(tol_batch),
                 expected_k1=want["deform_fwd"])
    out["tiled"] = tiled
    out["launches"] = launches
    print(f"{label} serving: launches {launches}; "
          + ", ".join(f"{tag} {out[tag]['scenes_per_s']} scenes/s"
                      if "scenes_per_s" in out[tag]
                      else f"{tag} {out[tag]['cold_ms']} ms cold"
                      for tag, _ in runs)
          + f", tiled {rates[1]:.2f} scenes/s (peak {peak:.0f} MB); "
          f"served vs single {served_err:.4g} m (tolerance {tol_batch})",
          flush=True)
    return out, launches


def phase_edsr(work: Path, root: Path, dev: torch.device, scenes_dir: Path,
               tiled_dir: Path):
    """Phase 11: configs/edsr_r8_img.yml as shipped and with its SPN head,
    trained (one epoch each, ``CUT_EPOCHS``) and served whole and
    tiled."""
    out, paths = {}, {}
    shipped = {k: v for k, v in create_config(EDSR_CONFIG).model_kwargs.items()
               if k not in ("checkpoint", "pretrained")}
    for label, over in (("EDSR", {}), ("EDSR+SPN", {"spn": True})):
        key = label.lower().replace("+", "_")
        mk = {**shipped, **over}
        out[f"{key}_training"], paths[f"{key}_training"] = train(
            EDSR_CONFIG, root, work / f"train_{key}", dev, compare_batch=2,
            perturbed=False, label=label, model_kwargs=over,
            epochs=CUT_EPOCHS)
        mark(f"{label} training")
        torch.backends.cudnn.deterministic = False  # serving, as phase 7
        # EDSR as shipped launches no kernel: its whole scene is held to
        # float64, its served raster only to the scene served alone (a cut:
        # both were held to float64, about 15 s of host time, until phase
        # 16 pushed the script past 1,000 s on an NVIDIA H100 80GB HBM3
        # host, 700 W)
        out[f"{key}_serving"], launches = serve_family(
            work / f"serve_{key}", dev, label, "EDSR", mk,
            (scenes_dir, SCENES), (tiled_dir, TILED_SMALL),
            served_fp64=SERVED_FP64 if over else ())
        paths.update(launches)
        mark(f"{label} serving")
    return out, paths


def phase_lrru(work: Path, root: Path, dev: torch.device):
    """Phase 12: configs/lrru_r8_img.yml as shipped, trained (one epoch),
    then served whole (4 x 334^2 and 1 x 1024^2, then one 244 x 346 scene
    padded to 256 x 352) and tiled (8 x 334^2) on DEMs with LRRU_HOLES of
    their pixels at no data."""
    paths = {}
    training, paths["lrru_training"] = train(
        LRRU_CONFIG, root, work / "train", dev, compare_batch=2,
        perturbed=True, holes=LRRU_HOLES, epochs=CUT_EPOCHS)
    mark("LRRU training")
    torch.backends.cudnn.deterministic = False  # serving, as phase 7
    write_scenes(work / "scenes", SCENES, seed=5, holes=LRRU_HOLES)
    write_scenes(work / "rect", [LRRU_RECT], seed=6, holes=LRRU_HOLES)
    write_scenes(work / "tiled", TILED_SMALL, seed=7, holes=LRRU_HOLES)
    mk = {k: v for k, v in create_config(LRRU_CONFIG).model_kwargs.items()
          if k not in ("checkpoint", "pretrained")}
    serving, launches = serve_family(
        work / "serve", dev, "LRRU", "LRRU", mk, (work / "scenes", SCENES),
        (work / "tiled", TILED_SMALL), rect=(work / "rect", [LRRU_RECT]),
        tol_scaled=(LRRU_RTOL, LRRU_ATOL),
        tol_tiled=(LRRU_RTOL, LRRU_ATOL * 1009.0), tol_batch=None,
        **LRRU_SCALING)
    paths.update(launches)
    return {"lrru_training": training, "lrru_serving": serving}, paths


def fit_config(config: Path, root: Path, epochs: int = FIT_EPOCHS,
               cities: int | None = None):
    """``config`` as it is on the synthetic tree at ``root``, but for its
    epochs (the one cut) and, with ``cities``, its first ``cities`` train
    cities."""
    p = create_config(config)
    p.dataset_path = str(root)
    p.epochs = epochs
    if cities is not None:
        p.train_set = list(p.train_set)[:cities]
    return p


class FitRecorder:
    """Wraps a Trainer's ``train_one_epoch``, ``evaluate``, ``finish`` and
    preemption save: each epoch's seconds, losses and tiles/s, each eval
    pass's seconds and arguments, each save's ms (after the device is
    done), and every parameter and buffer as ``finish`` starts (the state
    the last epoch left, before the best checkpoint is reloaded)."""

    def __init__(self, trainer):
        self.epoch_s, self.eval_s, self.losses, self.rates = [], [], [], []
        self.eval_kwargs, self.save_ms = [], []
        self.final_state = None
        train_one_epoch, evaluate = trainer.train_one_epoch, trainer.evaluate
        finish, save = trainer.finish, trainer._save_preempt

        def timed_epoch(epoch):
            t0 = time.perf_counter()
            out = train_one_epoch(epoch)
            torch.cuda.synchronize()
            self.epoch_s.append(time.perf_counter() - t0)
            self.losses.append(dict(trainer.last_epoch_losses))
            self.rates.append(trainer.last_throughput)
            return out

        def timed_eval(*args, **kwargs):
            t0 = time.perf_counter()
            out = evaluate(*args, **kwargs)
            self.eval_s.append(time.perf_counter() - t0)
            self.eval_kwargs.append(kwargs)
            return out

        def snapshot_finish():
            self.final_state = {
                n: t.detach().clone() for n, t in
                [*trainer.model.named_parameters(),
                 *trainer.model.named_buffers()]}
            return finish()

        def timed_save(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(*args)
            self.save_ms.append((time.perf_counter() - t0) * 1e3)

        trainer.train_one_epoch = timed_epoch
        trainer.evaluate = timed_eval
        trainer.finish = snapshot_finish
        trainer._save_preempt = timed_save


def fit_run(config: Path, root: Path, work: Path, dev: torch.device,
            epochs: int = FIT_EPOCHS, initial_eval: bool = False,
            resume_from=None, save_every: int = 0, backend: str = "npz",
            cities: int | None = None):
    """``Trainer(p, device=dev).fit(initial_eval)`` for ``epochs`` (after
    ``load(resume_from, resume=True)`` when given), with
    ``save_every_steps: save_every`` and ``checkpoint_backend: backend``,
    on ``cities`` train cities (``fit_config``): (fit's result, its
    recorder, the trainer)."""
    p = fit_config(config, root, epochs, cities)
    p.save_every_steps, p.checkpoint_backend = save_every, backend
    trainer = Trainer(p, result_dir=work, device=dev)
    if resume_from is not None:
        trainer.load(resume_from, resume=True)
    rec = FitRecorder(trainer)
    return trainer.fit(initial_eval=initial_eval), rec, trainer


def resume_gate(config: Path, root: Path, work: Path, dev: torch.device,
                uninterrupted=None, cities: int | None = None):
    """Run A fits FIT_EPOCHS epochs (or is ``uninterrupted``, ``fit_run``'s
    triple of such a fit); run B fits 1 (its checkpoint, saved at the end
    of epoch 0 as the first best, is renamed by ``finish``), then a new
    Trainer loads it with ``resume=True`` and fits to FIT_EPOCHS, each on
    ``cities`` train cities. A's and B's last parameters and buffers, best
    result and epoch losses must be bit-equal: no tolerance."""
    _, rec_a, a = uninterrupted or fit_run(config, root, work / "A", dev,
                                           cities=cities)
    out_b1, rec_b1, _ = fit_run(config, root, work / "B1", dev, epochs=1,
                                cities=cities)
    _, rec_b2, b2 = fit_run(config, root, work / "B2", dev,
                            resume_from=out_b1["checkpoint"], cities=cities)
    unequal = [n for n in rec_a.final_state
               if not torch.equal(rec_a.final_state[n], rec_b2.final_state[n])]
    b_losses = rec_b1.losses + rec_b2.losses
    gate = {"tensors": len(rec_a.final_state), "unequal": len(unequal),
            "unequal_names": unequal[:8],
            "best_result_equal": a.best_result == b2.best_result,
            "epoch_losses_equal": rec_a.losses == b_losses,
            "start_epoch_after_load": b2.start_epoch,
            "global_step": [a.global_step, b2.global_step]}
    print(f"resume gate {a.p.model_name}: {gate}", flush=True)
    if (unequal or not gate["best_result_equal"]
            or not gate["epoch_losses_equal"]
            or a.global_step != b2.global_step):
        raise AssertionError(f"{a.p.model_name}: a resumed fit is not "
                             f"bit-equal to an uninterrupted one: {gate}, "
                             f"A {a.best_result} {rec_a.losses}, B "
                             f"{b2.best_result} {b_losses}")
    return gate


class Preempted(Exception):
    """A simulated preemption of a fit (the gate's, not a failure)."""


def preempted_fit(config: Path, root: Path, work: Path, dev: torch.device,
                  crash: str, backend: str = "npz"):
    """A fit of FIT_EPOCHS epochs with ``save_every_steps: PREEMPT_EVERY``
    in ``work``, preempted (``PREEMPT_AT``: ``"after_save"`` right after
    epoch 0's save at step PREEMPT_EVERY, before epoch 0's eval and best
    checkpoint; ``"between_saves"`` in epoch 1 after the train step one past
    its save, whose update is lost and replayed), saving through the
    checkpoint ``backend``; it must leave the preemption checkpoint
    behind."""
    p = fit_config(config, root)
    p.save_every_steps, p.checkpoint_backend = PREEMPT_EVERY, backend
    trainer = Trainer(p, result_dir=work, device=dev, verbose=False)
    if p.get("device_cache") and trainer.scene_cache is None:
        raise AssertionError(f"{config.name}: the device cache fell back")
    at_epoch, at_step = PREEMPT_AT[crash]
    if crash == "after_save":
        save = trainer._save_preempt

        def crash_after_save(epoch, steps_done, *args):
            save(epoch, steps_done, *args)
            if [epoch, steps_done] == [at_epoch, at_step]:
                raise Preempted

        trainer._save_preempt = crash_after_save
    else:
        step, calls = trainer.train_step, [0]
        steps = len(trainer.train_loader)

        def crash_between(inputs, gt):
            losses = step(inputs, gt)
            calls[0] += 1
            if calls[0] == at_epoch * steps + at_step + 1:
                raise Preempted
            return losses

        trainer.train_step = crash_between
    try:
        trainer.fit(initial_eval=False)
    except Preempted:
        pass
    else:
        raise AssertionError(f"{config.name}: the fit ran to its end past "
                             f"the preemption ({crash})")
    wait_for_checkpoint()  # an asynchronous save lands, as on a relaunch
    if not trainer._preempt_path().exists():
        raise AssertionError(f"{config.name}: no preemption checkpoint "
                             f"left by the preempted fit ({crash})")


def preempt_gate(config: Path, root: Path, work: Path, dev: torch.device,
                 label: str, uninterrupted=None, backend: str = "npz") -> dict:
    """``save_every_steps`` on the card, through the checkpoint
    ``backend``: an uninterrupted fit with ``save_every_steps:
    PREEMPT_EVERY`` (or ``uninterrupted``, ``fit_run``'s triple of one)
    against a fit preempted as ``PREEMPT_CASES[label]`` says (right after
    a save in epoch 0, or between saves in epoch 1), relaunched in its
    result dir (a new Trainer finds the preemption checkpoint, resumes the
    epoch at its step and skips the initial eval). The relaunched fit's
    last parameters and buffers, the losses of the epochs it ran, best
    result and final eval must be bit-equal to the uninterrupted one's: no
    tolerance."""
    out_a, rec_a, a = uninterrupted or fit_run(
        config, root, work / "A", dev, save_every=PREEMPT_EVERY,
        backend=backend)
    if (a._preempt_path().exists() or not rec_a.save_ms
            or a.ckpt_backend != backend):
        raise AssertionError(f"{label}: {len(rec_a.save_ms)} preemption "
                             f"saves ({a.ckpt_backend}), the file left "
                             f"after the run")
    gate = {"save_every_steps": PREEMPT_EVERY, "checkpoint_backend": backend,
            "tensors": len(rec_a.final_state), "save_ms": rec_a.save_ms,
            "cases": {}}
    for crash in PREEMPT_CASES[label]:
        preempted_fit(config, root, work / crash, dev, crash, backend)
        p = fit_config(config, root)
        p.save_every_steps, p.checkpoint_backend = PREEMPT_EVERY, backend
        c = Trainer(p, result_dir=work / crash, device=dev, verbose=False)
        resumed_at = list(c._mid_resume[:2]) if c._mid_resume else None
        rec_c = FitRecorder(c)
        out_c = c.fit(initial_eval=True)
        unequal = [n for n in rec_a.final_state
                   if not torch.equal(rec_a.final_state[n],
                                      rec_c.final_state[n])]
        case = {"resumed_at": resumed_at, "unequal": len(unequal),
                "unequal_names": unequal[:8],
                "initial_eval_skipped": not any(
                    kw.get("compare_input") for kw in rec_c.eval_kwargs),
                "epoch_losses_equal": rec_c.losses
                == rec_a.losses[-len(rec_c.losses):],
                "best_result_equal": c.best_result == a.best_result,
                "final_eval_equal": out_c["result"] == out_a["result"],
                "global_step": [a.global_step, c.global_step],
                "file_removed": not c._preempt_path().exists()}
        gate["cases"][crash] = case
        if (resumed_at != PREEMPT_AT[crash] or unequal
                or not all(case[k] for k in (
                    "initial_eval_skipped", "epoch_losses_equal",
                    "best_result_equal", "final_eval_equal",
                    "file_removed"))
                or a.global_step != c.global_step):
            raise AssertionError(f"{label}: a fit preempted {crash} and "
                                 f"relaunched is not the uninterrupted "
                                 f"one: {case}")
        del c
    print(f"preemption gate {label}: {gate}", flush=True)
    mark(f"preemption gate {label}")
    return gate


def fit(root: Path, work: Path, dev: torch.device, smi: str):
    """Phase 10: the flagship's ``fit`` on the card on phase 5's tree (its
    config as it is but for the epochs), with the exact launches of its
    steps and eval samples; the best checkpoint validated through the CLI's
    --val, and on the CPU; then the resume gate for both families and the
    preemption gate for the flagship and the bf16 flagship, the fit above
    (with ``save_every_steps``) the flagship's uninterrupted run in both."""
    p = fit_config(FLAGSHIP, root)
    print(f"fit: {FLAGSHIP.relative_to(REPO)} as it is but epochs "
          f"{create_config(FLAGSHIP).epochs} -> {FIT_EPOCHS} (a cut)",
          flush=True)
    reset_launches()
    # with save_every_steps, so that this fit is also the uninterrupted run
    # of the resume and preemption gates (the saves launch nothing), and
    # the asynchronous checkpoint backend, whose saves the gate times
    out, rec, trainer = fit_run(FLAGSHIP, root, work / "run", dev,
                                initial_eval=True, save_every=PREEMPT_EVERY,
                                backend="orbax")
    torch.cuda.synchronize()
    launches = dict(deform_cuda.LAUNCHES)
    n_valid = len(p.valid_set) * VALID_SCENES_PER_CITY
    steps = FIT_EPOCHS * (len(p.train_set) * TRAIN_SCENES_PER_CITY
                          // p.train_batch_size)
    evals = len(rec.eval_s)  # initial, one per epoch, final
    want = {k: v * steps for k, v in PER_STEP["JSPSR"].items()}
    want["deform_fwd"] += PER_EVAL_SAMPLE["JSPSR"] * n_valid * evals
    print(f"fit-path launches: {launches} for {steps} steps and {evals} eval "
          f"passes of {n_valid} samples", flush=True)
    if launches != want or evals != FIT_EPOCHS + 2:
        raise AssertionError(f"fit launches {launches}, expected {want}")
    run = work / "run"
    ckpt = Path(out["checkpoint"])
    preds = [f for f in (run / "predictions").iterdir()
             if f.suffix in (".tif", ".npy")]
    lines = (run / "metrics.jsonl").read_text().splitlines()
    if ("RMSE" not in ckpt.name or not ckpt.exists()
            or len(preds) != n_valid or len(lines) != FIT_EPOCHS
            or not (run / "summary.json").exists()
            or not (run / "summary.csv").exists()):
        raise AssertionError(f"fit products: {ckpt.name}, {len(preds)} "
                             f"predictions, {len(lines)} metrics lines, "
                             f"{sorted(f.name for f in run.iterdir())}")
    scores = {k: v for k, v in out["result"].items() if k != "input"}
    if not all(np.isfinite(list(scores.values()))):
        raise AssertionError(f"fit final eval {scores}")
    mark("fit")

    # --val through the CLI on the best checkpoint
    cfg = dict(fit_config(FLAGSHIP, root))
    # the loader derives dataset_path from data_root (root is its DFC30_8m)
    cfg["data_root"] = str(root.parent)
    cfg["model_kwargs"] = dict(cfg["model_kwargs"], checkpoint=str(ckpt))
    cfg_path = work / "val.json"
    cfg_path.write_text(json.dumps(cfg, default=str))
    val = run_cli(["--config", str(cfg_path), "--val", "--result-dir",
                   str(work / "val")])
    for k, v in scores.items():
        np.testing.assert_allclose(val[k], v, rtol=1e-5,
                                   err_msg=f"--val {k} vs fit's final eval")

    # the same checkpoint evaluated by the port on the CPU
    cpu = Trainer(fit_config(FLAGSHIP, root), result_dir=work / "cpu",
                  device="cpu", verbose=False)
    cpu.load(ckpt)
    cpu_scores = cpu.evaluate()
    for k, v in scores.items():
        np.testing.assert_allclose(cpu_scores[k], v, rtol=1e-4,
                                   err_msg=f"CPU {k} vs the card's")
    del cpu
    mark("--val and the CPU eval")

    gates = {"JSPSR": resume_gate(FLAGSHIP, root, work / "gate_JSPSR", dev,
                                  (out, rec, trainer)),
             "CompletionFormer": resume_gate(CF_CONFIG, root,
                                             work / "gate_CompletionFormer",
                                             dev, cities=GATE_CF_CITIES)}
    mark("resume gates")
    # save_every_steps: the flagship on the host feed, the bf16 flagship
    # from its device cache
    preempt = {"JSPSR": preempt_gate(FLAGSHIP, root, work / "preempt_JSPSR",
                                     dev, "JSPSR", (out, rec, trainer),
                                     backend="orbax"),
               "JSPSR_bf16": preempt_gate(BF16_CONFIG, root,
                                          work / "preempt_JSPSR_bf16", dev,
                                          "JSPSR_bf16")}
    del trainer
    return {
        "config": str(FLAGSHIP.relative_to(REPO)),
        "cut": {"epochs": [create_config(FLAGSHIP).epochs, FIT_EPOCHS]},
        "train_samples": len(p.train_set) * TRAIN_SCENES_PER_CITY,
        "valid_samples": n_valid, "steps": steps,
        "epoch_s": rec.epoch_s, "eval_pass_s": rec.eval_s,
        "eval_ms_per_sample": [t / n_valid * 1e3 for t in rec.eval_s],
        "checkpoint": ckpt.name, "final_eval": scores,
        "best_result": out["best_result"],
        "offline_summary": out["summary"]["offline"] if out["summary"]
        else None,
        "val_cli": {k: val[k] for k in scores},
        "cpu_eval": {k: cpu_scores[k] for k in scores},
        "launches": launches, "resume_gate": gates,
        "preemption_gate": preempt, "card": smi,
    }, launches


def bf16_fit(root: Path, work: Path, dev: torch.device, sample=None,
             epochs: int = FIT_EPOCHS) -> tuple:
    """Phase 13 (a) or, with ``sample``, (d): the shipped bf16 config
    (with ``model_kwargs.spn_sample_dtype: sample``) as it is but for its
    epochs, through ``Trainer.fit`` with the initial eval: the split must
    be resident in the device cache (no fallback line printed), and the
    launches exactly one K1 and one K2 per step and one K1 per eval
    sample, each in the mode asked for; then one step at the train batch
    twice from one state, bit-equal in every tensor."""
    p = fit_config(BF16_CONFIG, root, epochs)
    if sample:
        p.model_kwargs["spn_sample_dtype"] = sample
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trainer = Trainer(p, result_dir=work, device=dev)
    print(printed.getvalue(), end="", flush=True)
    if (trainer.scene_cache is None
            or "falling back" in printed.getvalue()):
        raise AssertionError(f"bf16 fit: the device cache fell back: "
                             f"{printed.getvalue()}")
    rec = FitRecorder(trainer)
    inner, steps = trainer.train_step, []

    def timed_step(inputs, gt):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = inner(inputs, gt)
        end.record()
        steps.append((start, end))
        return losses

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = trainer.fit(initial_eval=True)
    torch.cuda.synchronize()
    launches = dict(deform_cuda.LAUNCHES)
    n_valid = len(p.valid_set) * VALID_SCENES_PER_CITY
    n_steps = epochs * (len(p.train_set) * TRAIN_SCENES_PER_CITY
                        // p.train_batch_size)
    evals = len(rec.eval_s)  # initial, one per epoch, final
    fwd, bwd = (("deform_fwd_bf16", "deform_bwd_bf16") if sample
                else ("deform_fwd", "deform_bwd"))
    want = deform_counts(**{fwd: n_steps + n_valid * evals, bwd: n_steps})
    label = f"bf16 fit (spn_sample_dtype {sample})"
    print(f"{label} launches: {launches} for {n_steps} steps and {evals} "
          f"eval passes of {n_valid} samples", flush=True)
    if launches != want or len(steps) != n_steps:
        raise AssertionError(f"{label}: launches {launches} in {len(steps)} "
                             f"steps, expected {want}")
    scores = {k: v for k, v in out["result"].items() if k != "input"}
    step_ms = [a.elapsed_time(b) for a, b in steps]
    losses = [e.get("Total") for e in rec.losses]
    if not np.isfinite(list(scores.values()) + losses).all():
        raise AssertionError(f"{label}: scores {scores}, losses {losses}")
    warm = statistics.median(step_ms[1:])
    batch = p.train_batch_size
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    resident = trainer.scene_cache.nbytes
    n_params = sum(q.numel() for q in trainer.model.parameters())
    print(f"{label}: warm step {warm:.1f} ms, {batch / warm * 1e3:.1f} "
          f"tiles/s, peak {peak_mb:.0f} MB, device cache {resident} bytes "
          f"resident, no fallback", flush=True)
    del trainer
    set_deterministic_cudnn()
    twice = step_twice(p, dev, build_model(p).state_dict(), batch)
    print(f"{label} step twice from one state at batch {batch}: "
          f"{twice['unequal']} of {twice['tensors']} tensors differ "
          f"{twice['unequal_names']}", flush=True)
    if twice["unequal"]:
        raise AssertionError(f"{label}: the same step from the same state "
                             f"is not bit-equal: {twice}")
    return {
        "config": str(BF16_CONFIG.relative_to(REPO)),
        "spn_sample_dtype": sample, "parameters": n_params,
        "cut": {"epochs": [create_config(BF16_CONFIG).epochs, epochs]},
        "batch": batch, "steps": n_steps, "step_ms": step_ms,
        "step_ms_warm_median": warm, "tiles_per_s_warm": batch / warm * 1e3,
        "epoch_tiles_per_s": rec.rates, "epoch_s": rec.epoch_s,
        "eval_pass_s": rec.eval_s, "epoch_losses": rec.losses,
        "peak_mb": peak_mb,
        "peak_source": "torch.cuda.max_memory_allocated over fit",
        "device_cache_bytes": resident, "final_eval": scores,
        "launches": launches, "step_twice": twice,
    }, launches


def bf16_cache_vs_host(root: Path, work: Path, dev: torch.device) -> dict:
    """Phase 13 (c): the first batch of epoch 0 from the device cache
    against the raw host feed's (``device_cache: false``): the raw crops
    (uint8 image and mask, fp32 DEMs) and the bases bit-equal, the
    normalised batch within 2e-6; then one epoch from each, the epoch
    losses at rtol 2e-4 (tests/test_device_cache.py's)."""
    trainers = {}
    for key, cache in (("cache", True), ("host", False)):
        p = fit_config(BF16_CONFIG, root, 1)
        p.device_cache = cache
        trainers[key] = Trainer(p, result_dir=work / key, device=dev,
                                verbose=False)
    cached, host = trainers["cache"], trainers["host"]
    if cached.scene_cache is None or host.scene_cache is not None:
        raise AssertionError("bf16 cache vs host: the feeds are not the "
                             "ones asked for")
    p = cached.p
    cached.train_loader.set_epoch(0)
    host.train_loader.set_epoch(0)
    idx = next(cached.train_loader._batches())
    crops, base = cached.scene_cache.raw_batch(idx, 0)
    # the host feed's first batch: the same indices (one seed, one
    # shuffle), read and transformed by its dataset
    batch = host.train_set.collate([host.train_set[int(i)] for i in idx])
    inputs_np, gt_np, base_np, _ = build_batch_inputs(batch, p.model_name,
                                                      p.input_data)
    kinds = input_kinds(p.input_data)
    raw_equal = {k: bool(np.array_equal(crops[k].cpu().numpy(), x))
                 for k, x in zip(kinds + ["hr_dem"],
                                 list(inputs_np) + [gt_np])}
    raw_equal["base"] = bool(np.array_equal(base.cpu().numpy(), base_np))
    dtypes = {k: str(crops[k].dtype) for k in crops}
    got_in, got_gt = cached.scene_cache.sample_batch(idx, 0)
    # what the host feed ships: the mask bit-packed (pack_mask)
    shipped = [pack_mask_np(x) if k == "mask" else x
               for k, x in zip(kinds, inputs_np)]
    ref_in, ref_gt = host.normalize_batch(
        [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
         for x in shipped], torch.from_numpy(gt_np).to(dev),
        torch.from_numpy(base_np).to(dev))
    norm_err = max((a - b).abs().max().item() for a, b in
                   zip([*got_in, got_gt], [*ref_in, ref_gt]))
    cached.train_one_epoch(0)
    host.train_one_epoch(0)
    out = {"raw_bit_equal": raw_equal, "raw_dtypes": dtypes,
           "normalised_max_abs_diff": norm_err,
           "epoch_losses": {"cache": cached.last_epoch_losses,
                            "host": host.last_epoch_losses}}
    print(f"bf16 cache vs host feed: {out}", flush=True)
    if not all(raw_equal.values()) or norm_err > 2e-6:
        raise AssertionError(f"bf16 cache vs host: first batch {out}")
    for k, v in host.last_epoch_losses.items():
        np.testing.assert_allclose(cached.last_epoch_losses[k], v, rtol=2e-4,
                                   err_msg=f"bf16 cache vs host epoch {k}")
    return out


def bf16_float64(cfg_path: Path, ckpt: Path):
    """The float64 reference of a bf16 serving config's weights: the same
    model with the fp32 body and sampling, in float64 (``Float64``)."""
    p64 = create_config(cfg_path)
    p64.model_kwargs.pop("compute_dtype", None)
    p64.model_kwargs.pop("spn_sample_dtype", None)
    return Float64(checkpoint_model(p64, ckpt))


def serve_bf16(work: Path, dev: torch.device, scenes_dir: Path,
               tiled_dir: Path):
    """Phase 13 (e): a seeded checkpoint of the bf16 flagship through the
    CLI's ``--infer`` over phase 4's directory and ``--infer --tile`` over
    phase 9's 8 x 334^2, one fp32-mode K1 per scene and per chunk; the
    first whole scene and the last served raster held, in the
    scaled domain, to the float64 forward of the same weights with the
    fp32 body (``hold_to_float64``: BF16_TOL_SCALED plus three times the
    CPU bf16 port's distance to float64); every served raster to its
    scene alone on the card (BF16_SERVED_ATOL, scaled), a limit that a
    swapped or shifted raster must exceed."""
    mk = {k: v for k, v in create_config(BF16_CONFIG).model_kwargs.items()
          if k not in ("checkpoint", "pretrained")}
    p, cfg_path, ckpt = seeded_checkpoint(work, "jspsr_r8_img_msk_bf16",
                                          "JSPSR", mk)
    launches, out = {}, {"model_kwargs": mk}
    reset_launches()
    paths = run_cli(["--config", str(cfg_path), "--infer", str(scenes_dir),
                     "--out", str(work / "out"), "--result-dir",
                     str(work / "result")])
    torch.cuda.synchronize()
    launches["bf16_serving"] = dict(deform_cuda.LAUNCHES)
    if launches["bf16_serving"] != deform_counts(deform_fwd=len(SCENES)):
        raise AssertionError(f"bf16 serving: launches {launches}")
    check_outputs(paths, SCENES, scenes_dir, near_input=True)
    sample, _ = load_scene(scenes_dir / SCENES[0][0], p)
    got = upscale_dem(make_forward(checkpoint_model(p, ckpt)
                                   .to(dev)), sample, p, dev)[0]
    bf16_cpu = upscale_dem(make_forward(checkpoint_model(p, ckpt)),
                           sample, p, "cpu")[0]
    f64 = bf16_float64(cfg_path, ckpt)
    ref = upscale_dem(make_forward(f64), sample, p, "cpu")[0]
    scale = max(1.0, float(np.abs(ref).max()))
    out["whole"] = hold_to_float64(
        got, bf16_cpu, ref, BF16_TOL_SCALED[0], BF16_TOL_SCALED[1] * scale,
        f"bf16 JSPSR {SCENES[0][0]}", cpu="bf16")
    shapes = [(s, s) for _, s in TILED_SMALL]
    want = deform_counts(deform_fwd=expected_tiled_launches(p, shapes))
    reset_launches()
    served = run_cli(["--config", str(cfg_path), "--infer", str(tiled_dir),
                      "--tile", "--out", str(work / "out_tiled"),
                      "--result-dir", str(work / "result_tiled")])
    torch.cuda.synchronize()
    launches["bf16_tiled"] = dict(deform_cuda.LAUNCHES)
    if launches["bf16_tiled"] != want:
        raise AssertionError(f"bf16 tiled: launches {launches}, expected "
                             f"{want}")
    check_outputs(served, TILED_SMALL, tiled_dir, near_input=True)
    samples = [load_scene(tiled_dir / name, p)[0] for name, _ in TILED_SMALL]
    scaled = [scaled_raster(read_raster(path), sample, p)
              for path, sample in zip(served, samples)]
    cpu = checkpoint_model(p, ckpt)
    out["tiled"] = {}
    for i in SERVED_FP64:
        name = TILED_SMALL[i][0]
        bf, r64 = (scaled_raster(tile_inference_device(
            m, samples[i], p, tile=p.patch_size, device="cpu")[0],
            samples[i], p) for m in (cpu, f64))
        out["tiled"][name] = hold_to_float64(
            scaled[i], bf, r64, *BF16_TOL_SCALED,
            f"bf16 JSPSR served {name} (scaled)", cpu="bf16")
    # every served raster against its scene alone on the card
    model = checkpoint_model(p, ckpt).to(dev)
    served_err = {}
    for (name, _), got, sample in zip(TILED_SMALL, scaled, samples):
        single = scaled_raster(tile_inference_device(
            model, sample, p, tile=p.patch_size, device=dev)[0], sample, p)
        served_err[name] = float(np.abs(got - single).max())
    # what a misplaced raster would be off by: another scene's raster, or
    # its own shifted by one tile stride (a tile in its neighbour's slot)
    d = tile_grid(TILED_SMALL[0][1], p.patch_size)[0]
    faults = {
        "swapped": min(float(np.abs(a - b).max())
                       for a, b in zip(scaled, scaled[1:])),
        f"shifted_{d}px": min(min(float(np.abs(a[d:] - a[:-d]).max()),
                                  float(np.abs(a[:, d:] - a[:, :-d]).max()))
                              for a in scaled)}
    out.update(served_vs_single_scaled=served_err,
               fault_distances_scaled=faults)
    print(f"bf16 JSPSR served vs single (scaled): {served_err}, limit "
          f"{BF16_SERVED_ATOL}; a misplaced raster would be off by {faults}",
          flush=True)
    if max(served_err.values()) > BF16_SERVED_ATOL:
        raise AssertionError(f"bf16 served vs single, scaled: {served_err} "
                             f"over {BF16_SERVED_ATOL}")
    if min(faults.values()) <= BF16_SERVED_ATOL:
        raise AssertionError(f"bf16 served vs single: the limit "
                             f"{BF16_SERVED_ATOL} would pass a misplaced "
                             f"raster: {faults}")
    out["tolerances"] = {"scaled": list(BF16_TOL_SCALED),
                         "served_vs_single_scaled": BF16_SERVED_ATOL}
    out["launches"] = launches
    return out, launches


def bf16_phase(root: Path, work: Path, dev: torch.device, scenes_dir: Path,
               tiled_dir: Path, smi: str):
    """Phase 13: the mixed-precision flagship (configs/
    jspsr_r8_img_msk_bf16.yml) fits, steps reproducibly, feeds from its
    device cache as from the host, samples in bf16 with
    ``spn_sample_dtype``, and serves."""
    paths = {}
    print(f"bf16: {BF16_CONFIG.relative_to(REPO)} as it is but epochs "
          f"{create_config(BF16_CONFIG).epochs} -> {FIT_EPOCHS} (a cut), "
          f"and {1} with spn_sample_dtype", flush=True)
    fit_a, paths["bf16_fit"] = bf16_fit(root, work / "fit", dev)
    mark("bf16 fit")
    cache = bf16_cache_vs_host(root, work / "feeds", dev)
    mark("bf16 cache vs host")
    fit_d, paths["bf16_fit_sampling"] = bf16_fit(
        root, work / "fit_sampling", dev, sample=BF16, epochs=1)
    mark("bf16 fit with spn_sample_dtype")
    torch.backends.cudnn.deterministic = False  # serving, as phase 7
    serving, launches = serve_bf16(work / "serve", dev, scenes_dir,
                                   tiled_dir)
    paths.update(launches)
    return {"fit": fit_a, "cache_vs_host": cache, "fit_sampling": fit_d,
            "serving": serving, "card": smi}, paths


def export_leg(label: str, flagship, work: Path, dev: torch.device,
               kernel: str, cpu_trace: bool) -> tuple:
    """One artifact through the CLI's ``--export`` from ``flagship``
    (``seeded_checkpoint``'s triple), traced on the card: loaded in a fresh
    process (``EXPORT_LOADER``: ``torch`` and the op library alone) and
    run at each of EXPORT_BATCHES x 128^2 against the eager model of the
    same weights (rtol = atol = EXPORT_TOL; TF32 off, cuDNN's deterministic
    algorithms in both), exactly one ``kernel`` launch per call; with
    ``cpu_trace`` a CPU-traced artifact of the same checkpoint, moved to
    the card, must give the card-traced one's outputs bit for bit; the
    artifact and the
    eager model timed in turns at batch 50 (``time_ms``). Returns (the
    leg's numbers, the loader's launches)."""
    p, cfg_path, ckpt = flagship
    art = {}
    t0 = time.perf_counter()
    art["card"] = run_cli(["--config", str(cfg_path), "--export",
                           str(work / label), "--result-dir",
                           str(work / f"{label}_result")])
    export_s = time.perf_counter() - t0
    if cpu_trace:
        art["cpu"] = run_cli(["--config", str(cfg_path), "--export",
                              str(work / f"{label}_cpu"), "--device", "cpu",
                              "--result-dir",
                              str(work / f"{label}_result_cpu")])
    side = p.patch_size
    rng = np.random.default_rng(14)
    xs = [rng.uniform(0, 1, (max(EXPORT_BATCHES), int(p.input_data[k]), side,
                             side)).astype(np.float32)
          for k in input_kinds(p.input_data)]
    np.savez(work / f"{label}_in.npz",
             **{f"{i:02d}": x for i, x in enumerate(xs)})
    run = subprocess.run(
        [sys.executable, "-c", EXPORT_LOADER, str(art["card"]),
         str(work / f"{label}_in.npz"), str(work / f"{label}_out.npz"),
         json.dumps(EXPORT_BATCHES)], capture_output=True, text=True,
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)})
    if run.returncode:
        raise AssertionError(f"{label}: the artifact's loader failed: "
                             f"{run.stderr[-4000:]}")
    report = json.loads(run.stdout.strip().splitlines()[-1])
    foreign = [m for m in report["modules"] if m.startswith(
        ("jax", "jspsr_tpu", "jspsr_torch.models", "jspsr_torch.config",
         "jspsr_torch.train"))]
    per_call = report["launches"]
    if foreign or any(c != deform_counts(**{kernel: 1})
                      for c in per_call.values()):
        raise AssertionError(f"{label}: the loader imported {foreign}, "
                             f"launched {per_call}")
    model = checkpoint_model(p, ckpt).to(dev).eval()
    diffs = {}
    with np.load(work / f"{label}_out.npz") as z, torch.inference_mode():
        for b in EXPORT_BATCHES:
            want = model([torch.from_numpy(x[:b]).to(dev) for x in xs])
            got = torch.from_numpy(z[str(b)]).to(dev)
            diffs[b] = (got - want).abs().max().item()
            if got.shape != (b, 1, side, side) or not torch.allclose(
                    got, want, rtol=EXPORT_TOL, atol=EXPORT_TOL):
                raise AssertionError(f"{label} artifact at batch {b}: "
                                     f"{tuple(got.shape)}, max |artifact - "
                                     f"eager| {diffs[b]}")
    fns = {k: load_exported(a) for k, a in art.items()}
    x50 = [torch.from_numpy(x[:50]).to(dev) for x in xs]
    outs = {k: fn(*x50) for k, fn in fns.items()}
    cpu_traced_equal = torch.equal(outs["card"], outs["cpu"]) if cpu_trace \
        else None
    if cpu_traced_equal is False:
        raise AssertionError(f"{label}: the CPU-traced artifact on the card "
                             f"differs from the card-traced one by "
                             f"{(outs['card'] - outs['cpu']).abs().max()}")
    flush = torch.empty(64 * 2**20, device=dev)

    def eager():
        with torch.inference_mode():
            model(x50)

    ms = {"artifact": [], "eager": []}
    for which in ("artifact", "eager", "eager", "artifact"):
        ms[which].append(time_ms((lambda: fns["card"](*x50))
                                 if which == "artifact" else eager, flush,
                                 reps=EXPORT_TIME_REPS))
    # why the phase asks cuDNN for its deterministic algorithms: with its
    # defaults the eager model differs from itself run to run
    torch.backends.cudnn.deterministic = False
    with torch.inference_mode():
        runs = [model(x50) for _ in range(2)]
    set_deterministic_cudnn()
    run_to_run = (runs[0] - runs[1]).abs().max().item()
    out = {"config": str(cfg_path.name), "export_s": export_s,
           "artifact_mb": art["card"].stat().st_size / 1e6,
           "max_abs_vs_eager": diffs, "tolerance": EXPORT_TOL,
           "launches_per_call": per_call,
           "cpu_traced_bit_equal": cpu_traced_equal,
           "eager_run_to_run_max_abs_cudnn_defaults": run_to_run,
           "ms_batch_50": ms,
           "artifact_over_eager": statistics.mean(ms["artifact"])
           / statistics.mean(ms["eager"])}
    print(f"export {label}: {out}", flush=True)
    launches = deform_counts()
    for c in per_call.values():
        for k, v in c.items():
            launches[k] += v
    del model, fns, outs, runs
    return out, launches


def export_phase(work: Path, dev: torch.device, flagship, smi: str):
    """Phase 14: phase 4's seeded flagship checkpoint and a seeded bf16
    flagship with ``spn_sample_dtype: bfloat16`` through ``--export``
    (``export_leg``): K1 in its fp32 mode, then only in its bf16 mode."""
    set_deterministic_cudnn()
    paths, legs = {}, {}
    legs["flagship"], paths["export_flagship"] = export_leg(
        "flagship", flagship, work, dev, "deform_fwd", cpu_trace=True)
    mark("export flagship")
    mk = {k: v for k, v in create_config(BF16_CONFIG).model_kwargs.items()
          if k not in ("checkpoint", "pretrained")}
    mk["spn_sample_dtype"] = BF16
    bf16 = seeded_checkpoint(work / "bf16", "jspsr_r8_img_msk_bf16", "JSPSR",
                             mk)
    legs["bf16_flagship"], paths["export_bf16"] = export_leg(
        "bf16_flagship", bf16, work, dev, "deform_fwd_bf16", cpu_trace=False)
    legs["card"] = smi
    return legs, paths


def options_forward(scenes_dir: Path, dev: torch.device, flagship) -> tuple:
    """Phase 15 (a): phase 4's checkpoint (BatchNorm perturbed) with each
    of JSPSR's execution options (``OPTION_SETS``) against the separate
    path on the card, cuDNN's defaults, TF32 off: batches of 1 and 72 x
    128^2 and phase 4's first 334^2 scene (``upscale_dem``) at rtol 1e-4 /
    atol 2e-5 (the convs regrouped, the precision fp32), one K1 per
    forward; each forward's median of TIME_REPEATS (the scene's through
    ``upscale_dem``'s own CUDA-synchronised ms)."""
    p, _, ckpt = flagship
    torch.backends.cudnn.deterministic = False
    rng = np.random.default_rng(15)
    batches = {b: [torch.from_numpy(rng.uniform(0.05, 0.95, (
        b, int(p.input_data[k]), TRAIN_SIDE, TRAIN_SIDE)).astype(
            np.float32)).to(dev) for k in input_kinds(p.input_data)]
        for b in OPTION_BATCHES}
    sample, _ = load_scene(scenes_dir / SCENES[0][0], p)
    flush = torch.empty(64 * 2**20, device=dev)
    out, launches, ref = {}, {}, {}
    for label, options in OPTION_SETS.items():
        q = create_config_over(p, model_kwargs=options)
        model = checkpoint_model(q, ckpt).to(dev).eval()
        fwd = make_forward(model)
        row = {}
        with torch.inference_mode():
            for b, xs in batches.items():
                reset_launches()
                y = model(xs)
                torch.cuda.synchronize()
                got = launch_counts()
                if got != {**deform_counts(deform_fwd=1), "conv_same": 0}:
                    raise AssertionError(f"{label} at {b}: launches {got}")
                launches[f"{label}_{b}"] = got
                if label == "separate":
                    ref[b] = y
                err = float((y - ref[b]).abs().max())
                torch.testing.assert_close(y, ref[b], rtol=1e-4, atol=2e-5)
                # warm: the forward above ran first
                row[f"{b}x128"] = {"ms": time_ms(lambda: model(xs), flush,
                                                 reps=TIME_REPEATS, warmup=1),
                                   "max_abs_vs_separate": err}
        scene = upscale_dem(fwd, sample, p, dev)[0]
        if label == "separate":
            ref["scene"] = scene
        np.testing.assert_allclose(scene, ref["scene"], rtol=1e-4, atol=2e-5,
                                   err_msg=f"{label}: the 334^2 scene")
        row["334x334"] = {
            "ms": statistics.median(upscale_dem(fwd, sample, p, dev)[1]
                                    for _ in range(TIME_REPEATS)),
            "max_abs_vs_separate": float(np.abs(scene - ref["scene"]).max())}
        out[label] = row
        print(f"options forward {label}: {row}", flush=True)
        del model, fwd
    torch.backends.cudnn.deterministic = True
    return out, launches


def create_config_over(p, model_kwargs=None, **keys):
    """A copy of config ``p`` with ``keys`` and ``model_kwargs`` over its
    own."""
    q = copy.deepcopy(p)
    q.update(keys)
    q.model_kwargs.update(model_kwargs or {})
    return q


def remat_steps(p, dev, batch: int, label: str, variants: dict,
                per_step: dict) -> tuple:
    """Phase 15 (b): one train step at ``batch`` x 128^2 from one state
    with each of ``variants`` ({name: (model_kwargs, remat)}; the first is
    the step without), under deterministic cuDNN: every parameter, buffer
    and AdamW moment bit-equal to the first's, the launches of the step
    exactly ``per_step[name]``; then TIMED_STEPS more steps on the same
    batch: the warm step's median ms and the peak memory from the first
    step on."""
    set_deterministic_cudnn()
    inputs, gt = train_batch(p, batch, 6)
    inputs, gt = [x.to(dev) for x in inputs], gt.to(dev)
    state = perturb_weights(build_model(p), seed=2).state_dict()
    out, launches, first = {}, {}, None
    for name, (model_kwargs, remat) in variants.items():
        q = create_config_over(p, model_kwargs=model_kwargs)
        model = model_from_state(q, state).to(dev)
        opt = build_optimizer(q, model)
        gen = torch.Generator(dev)
        step = make_train_step(model, build_criterion(dict(q.loss)), opt,
                               remat=remat, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        seed_step_generator(gen, q.get("seed", 0), 0)
        reset_launches()
        step(inputs, gt)
        torch.cuda.synchronize()
        got = dict(deform_cuda.LAUNCHES)
        launches[f"{label}_{name}"] = got
        if got != per_step[name]:
            raise AssertionError(f"{label} {name}: launches {got}, expected "
                                 f"{per_step[name]}")
        after = {**{n: t.detach().clone() for n, t in
                    [*model.named_parameters(), *model.named_buffers()]},
                 **{f"opt.{i}.{k}": v.clone()
                    for i, t in enumerate(model.parameters())
                    for k, v in opt.state.get(t, {}).items()}}
        first = first or after
        unequal = [n for n in first if not torch.equal(first[n], after[n])]
        ms = []
        for i in range(TIMED_STEPS):
            seed_step_generator(gen, q.get("seed", 0), i + 1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(inputs, gt)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        out[name] = {"batch": [batch, 128, 128], "tensors": len(after),
                     "unequal": len(unequal), "unequal_names": unequal[:8],
                     "launches": got, "step_ms": ms,
                     "step_ms_warm_median": statistics.median(ms),
                     "peak_mb": torch.cuda.max_memory_allocated(dev) / 2**20}
        print(f"{label} step {name} at batch {batch}: {len(unequal)} of "
              f"{len(after)} tensors differ from the step without; launches "
              f"{got}; warm step {out[name]['step_ms_warm_median']:.1f} ms, "
              f"peak {out[name]['peak_mb']:.0f} MB", flush=True)
        if unequal:
            raise AssertionError(f"{label} {name}: the step is not the step "
                                 f"without: {unequal[:8]}")
        del model, opt, step, after
    return out, launches


def prefetch_split_epochs(root: Path, work: Path, dev: torch.device) -> dict:
    """Phase 15 (c): one flagship epoch with ``prefetch_split: false`` (the
    numpy assembly and the copy on one thread) against one with the
    default two: the epoch loss and every parameter and buffer bit-equal;
    each epoch's seconds."""
    out, states = {}, {}
    for split in (True, False):
        p = fit_config(FLAGSHIP, root, epochs=1)
        p.prefetch_split = split
        trainer = Trainer(p, result_dir=work / f"split_{split}", device=dev,
                          verbose=False)
        t0 = time.perf_counter()
        loss, _ = trainer.train_one_epoch(0)
        torch.cuda.synchronize()
        out[f"prefetch_split_{str(split).lower()}"] = {
            "epoch_s": time.perf_counter() - t0, "loss": loss}
        states[split] = {n: t.detach().clone() for n, t in
                         trainer.model.state_dict().items()}
        del trainer
    unequal = [n for n in states[True]
               if not torch.equal(states[True][n], states[False][n])]
    out["unequal"] = len(unequal)
    print(f"prefetch_split false vs true: {out}", flush=True)
    if unequal or out["prefetch_split_false"]["loss"] != \
            out["prefetch_split_true"]["loss"]:
        raise AssertionError(f"prefetch_split: false is not the split epoch: "
                             f"{unequal[:8]} {out}")
    return out


def serve_coord(work: Path, dev: torch.device) -> tuple:
    """Phase 15 (d): a seeded ``lr_dem + image + coord`` JSPSR (the
    flagship's widths; ``coord_mode`` local, from each DEM's grid) serving
    phase 4's 4 x 334^2 scenes through the CLI's ``--infer``, whole (one
    K1 per scene) and ``--tile`` (one K1 per chunk); one scene on the card
    against the port on the CPU at rtol 1e-4 / atol 2e-5."""
    scenes = SCENES[:4]
    write_scenes(work / "scenes", scenes)  # phase 4's first four
    p, cfg_path, ckpt = seeded_checkpoint(
        work, "coord", "JSPSR", {"num_block": 2, "num_feature": 32},
        input_data={"COP30": 1, "image": 3, "coord": 2}, coord_mode="local")
    out, launches = {}, {}
    for tile in (False, True):
        key = "coord_tiled" if tile else "coord_whole"
        reset_launches()
        paths = run_cli(["--config", str(cfg_path), "--infer",
                         str(work / "scenes"), *(["--tile"] if tile else []),
                         "--out", str(work / f"out_{key}"), "--result-dir",
                         str(work / f"result_{key}")])
        torch.cuda.synchronize()
        launches[key] = launch_counts()
        want = (expected_tiled_launches(p, [(s, s) for _, s in scenes])
                if tile else len(scenes))
        if launches[key] != {**deform_counts(deform_fwd=want),
                             "conv_same": 0}:
            raise AssertionError(f"{key}: launches {launches[key]}, K1 "
                                 f"expected {want}")
        check_outputs(paths, scenes, work / "scenes", near_input=True)
        out[key] = {"scenes": len(paths), "k1": want}
    err, warm_ms, _ = card_vs_cpu_scene(p, ckpt, work / "scenes" /
                                        scenes[0][0], dev, rtol=1e-4,
                                        atol=2e-5)
    out["card_vs_cpu_max_abs"], out["warm_ms_334"] = err, warm_ms
    print(f"coord serving: {out}", flush=True)
    return out, launches


def r3_epoch(work: Path, dev: torch.device) -> tuple:
    """Phase 15 (e): configs/jspsr_r3_img_msk.yml as shipped but one epoch,
    on 334^2 synthetic samples of its 13 train cities (one each), which
    its tile crop cuts into 9 x 128^2: exactly one K1 and one K2 per step;
    the first PROFILE_STEPS steps under ``profile_steps``, whose trace must
    name K1's and K2's kernels (it runs last: a process the profiler has
    traced launches more slowly)."""
    p = create_config(R3_CONFIG)
    root = work / "DFC30_3m"
    generate_mini_dfc30(root, train_cities=p.train_set,
                        valid_cities=p.valid_set,
                        n_per_city=R3_SCENES_PER_CITY, size=R3_SIDE)
    p.dataset_path, p.profile_steps = str(root), PROFILE_STEPS
    trainer = Trainer(p, result_dir=work / "run", device=dev, verbose=False)
    steps = len(trainer.train_loader)
    reset_launches()
    t0 = time.perf_counter()
    loss, _ = trainer.train_one_epoch(0)
    torch.cuda.synchronize()
    launches = dict(deform_cuda.LAUNCHES)
    out = {"config": str(R3_CONFIG.relative_to(REPO)),
           "crop": [p.crop_mode, p.patches_per_image],
           "samples": len(trainer.train_set), "steps": steps,
           "epoch_s": time.perf_counter() - t0, "loss": loss,
           "launches": launches}
    traces = sorted((work / "run" / "profile").glob("*.json"))
    text = traces[0].read_text() if len(traces) == 1 else ""
    names = {k: text.count(k) for k in ("deform_fwd_kernel",
                                        "deform_bwd_kernel")}
    profile = {"trace": traces[0].name if traces else None,
               "bytes": len(text), "kernel_name_counts": names}
    print(f"r3 epoch: {out}", flush=True)
    print(f"profile_steps {PROFILE_STEPS}: {profile}", flush=True)
    want = {k: v * steps for k, v in PER_STEP["JSPSR"].items()}
    if (launches != want or p.patches_per_image != 9 or not steps
            or not np.isfinite(loss)):
        raise AssertionError(f"r3 epoch: {out}, expected launches {want}")
    if not all(names.values()):
        raise AssertionError(f"profile_steps: the trace misses K1 or K2: "
                             f"{profile}")
    return out, profile, launches


def options_phase(root: Path, work: Path, dev: torch.device, flagship,
                  scenes_dir: Path, smi: str) -> tuple:
    """Phase 15: JSPSR's execution options, recomputation,
    ``prefetch_split: false``, coordinate guidance and the r3 config; the
    async checkpoint backend runs in phase 10."""
    out, paths = {"card": smi}, {}
    t0 = time.perf_counter()
    out["forward"], fwd_paths = options_forward(scenes_dir, dev, flagship)
    paths["options_forward"] = sum_launches(fwd_paths)
    out["forward_s"] = time.perf_counter() - t0
    mark("options forward")
    jspsr = create_config(FLAGSHIP)
    out["remat_jspsr"], remat_paths = remat_steps(
        jspsr, dev, jspsr.train_batch_size, "JSPSR", {
            "none": ({}, False), "remat": ({}, True),
            "remat_stages": ({"remat_stages": True}, False)},
        {"none": PER_STEP["JSPSR"],
         "remat": deform_counts(deform_fwd=2, deform_bwd=1),
         "remat_stages": PER_STEP["JSPSR"]})
    cf = create_config(CF_CONFIG)
    out["remat_cf"], cf_paths = remat_steps(
        cf, dev, cf.train_batch_size, "CompletionFormer",
        {"none": ({}, False), "remat": ({}, True)},
        {"none": PER_STEP["CompletionFormer"],
         "remat": deform_counts(deform_fwd=12, deform_bwd_dx=6)})
    paths["remat"] = sum_launches({**remat_paths, **cf_paths})
    out["remat_s"] = time.perf_counter() - t0
    mark("remat steps")
    out["prefetch_split"] = prefetch_split_epochs(root, work / "prefetch",
                                                  dev)
    mark("prefetch_split")
    out["coord"], coord_paths = serve_coord(work / "coord", dev)
    paths["coord_serving"] = sum_launches(coord_paths)
    mark("coord serving")
    out["r3"], profile, paths["r3_epoch"] = r3_epoch(work / "r3", dev)
    out["wall_s"] = time.perf_counter() - t0
    return out, profile, paths


# Phase 16: the flagship's first DP_TRAIN_CITIES train cities (108 samples:
# 2 steps of 50 in one process, 2 of 25 on each of two ranks, over the
# same rows), the two ranks' gloo group and its time limits
DP_TRAIN_CITIES, DP_RANK_BATCH, DP_WORLD = 9, 25, 2
DP_TIMEOUT_S, DP_INIT_TIMEOUT_S = 600, 120
# (b): warm steps timed per turn, with and without the NCCL group of one
DP_WARM_STEPS = 5
# (c) the mesh [cuda:0] * DP_MESH: phase 5's 12 valid samples in batches
# of 4, each split in two; phase 9's 8 x 334^2 served in DP_TILE^2 tiles
DP_VALID_BATCH, DP_MESH, DP_TILE = 4, 2, 128
# (d) the dry run's world
DRYRUN_RANKS = 2


def dp_steps(over: dict, work: Path, dev) -> dict:
    """One epoch of the flagship config (``over`` on top of it) through
    the Trainer on ``dev``: each step's loss and ms (CUDA events), the
    launches, the float64 sum of every |parameter| after it, a hash of the
    parameters' bytes and the peak memory. Under a process group (a rank
    of ``data_parallel``'s leg (a)) the step all-reduces."""
    import hashlib

    p = create_config(FLAGSHIP)
    p.update(over)
    trainer = Trainer(p, result_dir=work, device=dev, verbose=False)
    inner, steps = trainer.train_step, []

    def timed_step(inputs, gt):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = inner(inputs, gt)
        end.record()
        steps.append((start, end, losses["Total"]))
        return losses

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats(trainer.device)
    reset_launches()
    trainer.train_one_epoch(0)
    torch.cuda.synchronize()
    launches = dict(deform_cuda.LAUNCHES)
    params = [q.detach() for q in trainer.model.parameters()]
    digest = hashlib.sha256()
    for q in params:
        digest.update(q.cpu().numpy().tobytes())
    out = {"device": str(trainer.device), "rank": trainer.rank,
           "world": trainer.world, "batch": p.train_batch_size,
           "losses": [float(t) for _, _, t in steps],
           "step_ms": [a.elapsed_time(b) for a, b, _ in steps],
           "launches": launches,
           "checksum": float(sum(q.double().abs().sum().item()
                                 for q in params)),
           "sha256": digest.hexdigest(),
           "peak_mb": torch.cuda.max_memory_allocated(trainer.device) / 2**20}
    del trainer, inner, params
    return out


def dp_rank(rank: int, world: int, over: dict, work: str) -> dict:
    """Leg (a) on one rank (``parallel.spawn.run_ranks``): ``dp_steps`` at
    the per-rank batch on the card the ranks share."""
    set_strict_fp32()
    return dp_steps(over, Path(work), torch.device("cuda", 0))


def ranks_leg(root: Path, work: Path, dev: torch.device, smi: str) -> tuple:
    """(a) the flagship at full width, one seeded state: two steps of 50
    in this process, then two ranks of 25 on the same rows through
    ``all_reduce_grads`` and the cross-process BatchNorm, two processes
    sharing this card in a gloo group (NCCL refuses two ranks on one GPU):
    the step losses within rtol 1e-4 and the sum of every |parameter|
    within rtol 1e-5 (``tests/test_multihost.py:148-155``), the ranks'
    losses and parameters bit-equal, one K1 and one K2 per step on each
    rank."""
    import gc

    from jspsr_torch.parallel.spawn import run_ranks

    cities = list(create_config(FLAGSHIP).train_set)[:DP_TRAIN_CITIES]
    over = {"dataset_path": str(root), "train_set": cities}
    one = dp_steps(over, work / "one", dev)
    gc.collect()
    torch.cuda.empty_cache()  # the ranks need the card's memory
    t0 = time.perf_counter()
    ranks = run_ranks(dp_rank, DP_WORLD,
                      dict(over, train_batch_size=DP_RANK_BATCH,
                           distributed=True), str(work / "ranks"),
                      device="cuda:0", backend="gloo",
                      init_timeout_s=DP_INIT_TIMEOUT_S,
                      timeout_s=DP_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    per_step = deform_counts(deform_fwd=1, deform_bwd=1)
    n_steps = len(one["losses"])
    want = {k: v * n_steps for k, v in per_step.items()}
    r0 = ranks[0]
    out = {
        "config": str(FLAGSHIP.relative_to(REPO)),
        "train_cities": len(cities), "steps": n_steps,
        "one_process": one, "ranks": ranks,
        "ranks_wall_s": ranks_s,
        "loss_rel_err": [abs(a - b) / abs(b) for a, b in
                         zip(r0["losses"], one["losses"])],
        "checksum_rel_err": abs(r0["checksum"] - one["checksum"])
        / abs(one["checksum"]),
        "ranks_bit_equal": all((r["losses"], r["sha256"]) ==
                               (r0["losses"], r0["sha256"]) for r in ranks),
        "card": smi,
        "note": "two ranks sharing one card through gloo: no scaling figure",
    }
    print(f"data parallel: one process {one['losses']} ({one['step_ms']} "
          f"ms at {one['batch']}), ranks {[r['losses'] for r in ranks]} "
          f"({[r['step_ms'] for r in ranks]} ms at {r0['batch']} each, two "
          f"ranks sharing {smi}); loss rel err {out['loss_rel_err']}, "
          f"checksum rel err {out['checksum_rel_err']:.3g}, ranks "
          f"bit-equal {out['ranks_bit_equal']}, launches per rank "
          f"{[r['launches'] for r in ranks]}", flush=True)
    if (r0["world"] != DP_WORLD or n_steps != 2
            or len(r0["losses"]) != n_steps
            or max(out["loss_rel_err"]) > 1e-4
            or out["checksum_rel_err"] > 1e-5
            or not out["ranks_bit_equal"] or one["launches"] != want
            or any(r["launches"] != want for r in ranks)):
        raise AssertionError(f"data parallel over two ranks: {out}")
    paths = {"dp_one_process": one["launches"],
             **{f"dp_rank{r['rank']}": r["launches"] for r in ranks}}
    return out, paths


def checkpoint_arrays_of(run: Path) -> dict:
    """The params of the one best checkpoint a fit left in ``run``."""
    (ckpt,) = run.glob("JSPSR_r8_*.npz")
    with np.load(ckpt) as z:
        return {k: z[k] for k in z.files if k.startswith("params")}


def nccl_leg(root: Path, work: Path, dev: torch.device) -> tuple:
    """(b) the NCCL path in a group of one: one epoch of the flagship
    (a cut of 300) on phase 5's tree through the CLI with ``distributed:
    true`` and ``distributed_kwargs`` (a free local port, one process,
    rank 0), its first step profiled, against the same CLI run without
    ``distributed``: the group's backend nccl, the trace naming NCCL's
    all-reduce (the ``nccl:all_reduce`` op that ProcessGroupNCCL records;
    the kernels NCCL launched for it are printed: none for an in-place
    sum over one rank), the epoch losses within rtol 1e-4 and the sums of
    the checkpoints' |parameters| within rtol 1e-5; whether the two are
    bit-equal is printed."""
    import torch.distributed as dist
    import yaml

    from jspsr_torch.parallel.spawn import free_port

    base = yaml.safe_load(FLAGSHIP.read_text())
    base.update(data_root=str(root.parent), epochs=1, profile_steps=1)
    runs, paths = {}, {}
    for label in ("plain", "nccl"):
        cfg = dict(base)
        if label == "nccl":
            cfg.update(distributed=True, distributed_kwargs={
                "coordinator_address": f"127.0.0.1:{free_port()}",
                "num_processes": 1, "process_id": 0})
        cfg_path = work / f"{label}.json"
        cfg_path.parent.mkdir(parents=True, exist_ok=True)
        cfg_path.write_text(json.dumps(cfg))
        run = work / label
        reset_launches()
        t0 = time.perf_counter()
        try:
            out = run_cli(["--config", str(cfg_path), "--result-dir",
                           str(run)])
            torch.cuda.synchronize()
            backend = dist.get_backend() if dist.is_initialized() else None
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        paths[f"dp_cli_{label}"] = dict(deform_cuda.LAUNCHES)
        (line,) = [json.loads(x) for x in
                   (run / "metrics.jsonl").read_text().splitlines()]
        trace = (run / "profile" / "trace_e000.json").read_text()
        runs[label] = {
            "wall_s": time.perf_counter() - t0, "backend": backend,
            "train_loss": line["train_loss"],
            "tiles_per_s": line["train_tiles_per_sec"],
            "step_ms_epoch_mean": base["train_batch_size"] * 1e3
            / line["train_tiles_per_sec"],
            # the op ProcessGroupNCCL records around each all-reduce
            # (gloo's is gloo:all_reduce; both run c10d::allreduce_), and
            # the device kernels NCCL launched for it (a group of one
            # launches none for an in-place sum)
            "nccl_allreduce_ops": len(re.findall(
                r'"name": "nccl:all_reduce"', trace)),
            "c10d_allreduce_ops": len(re.findall(
                r'"name": "c10d::allreduce_"', trace)),
            "nccl_allreduce_kernels": sorted(set(re.findall(
                r'"name": "(nccl[A-Za-z]*Kernel_AllReduce[^"]*)"', trace))),
            "rmse": out["result"]["RMSE"],
            "params": checkpoint_arrays_of(run)}
    plain, nccl = runs["plain"], runs["nccl"]
    a, b = plain.pop("params"), nccl.pop("params")
    out = {
        "plain": plain, "nccl": nccl,
        "loss_rel_err": abs(nccl["train_loss"] - plain["train_loss"])
        / abs(plain["train_loss"]),
        "checksum_rel_err": abs(_abs_sum(b) - _abs_sum(a)) / _abs_sum(a),
        "bit_equal": set(a) == set(b) and all(
            np.array_equal(a[k], b[k]) for k in a),
    }
    print(f"NCCL group of one through the CLI: {out}", flush=True)
    if (nccl["backend"] != "nccl" or plain["backend"] is not None
            or not nccl["nccl_allreduce_ops"]
            or plain["nccl_allreduce_ops"] or plain["nccl_allreduce_kernels"]
            or out["loss_rel_err"] > 1e-4 or out["checksum_rel_err"] > 1e-5):
        raise AssertionError(f"the NCCL group of one: {out}")
    return out, paths


def nccl_warm_steps(dev: torch.device, smi: str) -> dict:
    """(b) the per-step cost of the data-parallel path on one card: the
    flagship's train step at its batch of 50 (one batch from a seed)
    warm, in three turns: without a group, in an NCCL group of one joined
    in this process (``init_distributed`` with ``distributed_kwargs``:
    the step all-reduces its gradients and loss dict, and BatchNorm takes
    its statistics through two all-reduces per layer), and without again.
    Each turn: one untimed step, then DP_WARM_STEPS timed by CUDA events;
    the overhead is the group's median over the two plain turns' mean
    median. One profiled group step counts its ``nccl:all_reduce`` ops."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from jspsr_torch.config.loader import AttrDict
    from jspsr_torch.parallel.mesh import init_distributed
    from jspsr_torch.parallel.spawn import free_port

    p = create_config(FLAGSHIP)
    torch.manual_seed(0)
    model = build_model(p).to(dev)
    step = make_train_step(model, build_criterion(dict(p.loss)),
                           build_optimizer(p, model))
    inputs, gt = train_batch(p, p.train_batch_size, 5)
    inputs, gt = [x.to(dev) for x in inputs], gt.to(dev)

    def turn() -> dict:
        step(inputs, gt)
        ms = []
        for _ in range(DP_WARM_STEPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step(inputs, gt)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return {"median_ms": statistics.median(ms), "ms": ms}

    out = {"batch": p.train_batch_size, "card": smi,
           "plain_before": turn()}
    init_distributed(AttrDict({"distributed": True, "distributed_kwargs": {
        "coordinator_address": f"127.0.0.1:{free_port()}",
        "num_processes": 1, "process_id": 0}}), dev)
    try:
        out["backend"] = dist.get_backend()
        out["nccl"] = turn()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(inputs, gt)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
    finally:
        dist.destroy_process_group()
    out["plain_after"] = turn()
    plain = (out["plain_before"]["median_ms"]
             + out["plain_after"]["median_ms"]) / 2
    out["overhead"] = out["nccl"]["median_ms"] / plain - 1
    out["nccl_allreduce_per_step"] = names.count("nccl:all_reduce")
    out["nccl_kernels"] = sorted({n for n in names
                                  if n.startswith("ncclDevKernel")
                                  or n.startswith("ncclKernel")})
    del model, step, inputs, gt
    print(f"NCCL group of one, warm steps at {out['batch']} on {smi}: "
          f"{out}", flush=True)
    if out["backend"] != "nccl" or not out["nccl_allreduce_per_step"]:
        raise AssertionError(f"the NCCL group of one's warm steps: {out}")
    return out


def dryrun_leg() -> tuple:
    """(d) ``parallel.dryrun.dryrun_multichip(DRYRUN_RANKS, "cuda")``, the
    JAX driver's multi-chip leg: on this one card its ranks share
    ``cuda:0`` in a gloo group (the tiny flagship's step against one
    process, mesh eval at 3e-4, the device cache over the group, and the
    2-D leg: the ranks as a 1 x 2 mesh, the spatially sharded eval forward
    against each rank's own at rtol 1e-4 / atol 1e-5). Each rank must have
    launched K1 and K2: one of each in its step, then its mesh eval
    (DRYRUN_RANKS launches of one row) and the same eval on one device
    (one launch); in the 2-D leg one K1 on its slab."""
    reset_launches()
    res = dryrun.dryrun_multichip(DRYRUN_RANKS, "cuda")
    torch.cuda.synchronize()
    want = deform_counts(deform_fwd=2 + DRYRUN_RANKS, deform_bwd=1)
    paths = {"dryrun_one_process": dict(deform_cuda.LAUNCHES),
             **{f"dryrun_rank{r}": rank["launches"]
                for r, rank in enumerate(res["ranks"])},
             **{f"dryrun_spatial_rank{r}": rank["spatial"]["launches"]
                for r, rank in enumerate(res["ranks"])}}
    out = {"backend": res["backend"], "one_process": res["one_process"],
           "ranks": [{k: v for k, v in r.items() if k != "params_sha256"}
                     for r in res["ranks"]]}
    if (paths["dryrun_one_process"] != deform_counts(deform_fwd=1,
                                                     deform_bwd=1)
            or any(r["launches"] != want for r in res["ranks"])
            or any(r["spatial"]["launches"] != deform_counts(
                deform_fwd_slab=1) for r in res["ranks"])):
        raise AssertionError(f"dryrun_multichip's launches: {paths}")
    return out, paths


def _abs_sum(arrays: dict) -> float:
    return float(sum(np.abs(v.astype(np.float64)).sum()
                     for v in arrays.values()))


def mesh_leg(root: Path, dev: torch.device, flagship, tiled_334: Path,
             work: Path) -> tuple:
    """(c) inference over the mesh [cuda:0, cuda:0]: phase 4's checkpoint
    through ``eval_model`` on phase 5's 12 valid samples in batches of 4
    against ``mesh=None`` (every score within 3e-4 relative, as
    ``dryrun_multichip``, Median and LE95 1e-4 m more), twice the K1
    launches (each batch split in two); then ``serve_scenes`` (the path of ``--infer --tile``) over
    phase 9's 8 x 334^2 against ``mesh=None`` at phase 9's rtol 1e-3 /
    atol 1e-2 m (another tile batch may take other cuDNN algorithms), its
    one 72-tile chunk in two launches of 36."""
    from jspsr_torch.data.dfc30 import DFC30
    from jspsr_torch.data.loader import DataLoader
    from jspsr_torch.data.transforms import build_transforms
    from jspsr_torch.eval.loop import eval_model
    from jspsr_torch.eval.serve import discover_scenes, serve_scenes
    from jspsr_torch.parallel.mesh import make_mesh
    from jspsr_torch.train.step import make_eval_step

    mesh = make_mesh([dev] * DP_MESH)
    p_serve, _, ckpt = flagship
    p = fit_config(FLAGSHIP, root, epochs=1)
    p.valid_batch_size = DP_VALID_BATCH
    model = checkpoint_model(p, ckpt).to(dev)
    step = make_eval_step(model, build_criterion(dict(p.loss)))
    ds = DFC30(split="valid", transform=build_transforms(p)[1],
               seed=p.get("seed", 0),
               **{k: v for k, v in p.items() if k != "seed"})
    scores, paths = {}, {}
    for label, m in (("one", None), ("mesh", mesh)):
        loader = DataLoader(ds, DP_VALID_BATCH, shuffle=False,
                            num_workers=1)
        reset_launches()
        scores[label] = eval_model(p, loader, step, dev, mesh=m)
        torch.cuda.synchronize()
        paths[f"mesh_eval_{label}"] = dict(deform_cuda.LAUNCHES)
    n_batches = len(ds) // DP_VALID_BATCH
    eval_err = {k: abs(scores["mesh"][k] - v) / max(abs(v), 1.0)
                for k, v in scores["one"].items()}
    # the order statistics may move by one quantum (another batch size,
    # other cuDNN algorithms): tests/test_eval_batched.py's 1e-4 m
    eval_bad = [k for k, e in eval_err.items() if e > 3e-4 + (
        1e-4 if k in ("Median", "LE95") else 0.0)]
    scenes = discover_scenes(tiled_334)
    served = {}
    for label, m in (("one", None), ("mesh", mesh)):
        reset_launches()
        out_paths, t_ms, sps = serve_scenes(
            model, p_serve, scenes, work / f"served_{label}", tile=DP_TILE,
            scene_batch=len(scenes), mesh=m, device=dev)
        torch.cuda.synchronize()
        paths[f"mesh_serving_{label}"] = dict(deform_cuda.LAUNCHES)
        served[label] = ([read_raster(q) for q in out_paths], t_ms)
    serve_err = max(float(np.abs(a - b).max()) for a, b in
                    zip(served["mesh"][0], served["one"][0]))
    for a, b in zip(served["mesh"][0], served["one"][0]):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-2)
    out = {"mesh": [str(d) for d in mesh.devices],
           "eval": {"batches": n_batches, "scores": scores,
                    "rel_err": eval_err},
           "serving": {"scenes": len(scenes), "max_abs_m": serve_err,
                       "ms": {k: v[1] for k, v in served.items()}},
           "launches": paths}
    print(f"mesh inference over {out['mesh']}: {out}", flush=True)
    if (eval_bad
            or paths["mesh_eval_mesh"] != deform_counts(
                deform_fwd=DP_MESH * n_batches)
            or paths["mesh_eval_one"] != deform_counts(deform_fwd=n_batches)
            or paths["mesh_serving_mesh"] != deform_counts(
                deform_fwd=DP_MESH)
            or paths["mesh_serving_one"] != deform_counts(deform_fwd=1)):
        raise AssertionError(f"mesh inference: {out}")
    return out, paths


def data_parallel(root: Path, work: Path, dev: torch.device, flagship,
                  tiled_334: Path, smi: str) -> tuple:
    """Phase 16: (a) two ranks on this card, (b) the NCCL group of one
    through the CLI and its warm steps, (c) inference over a mesh naming
    this card twice, (d) ``dryrun_multichip``."""
    out, paths = {"card": smi}, {}
    set_deterministic_cudnn()
    out["ranks"], p = ranks_leg(root, work / "ranks", dev, smi)
    paths.update(p)
    mark("data parallel: two ranks")
    out["nccl"], p = nccl_leg(root, work / "nccl", dev)
    paths.update(p)
    out["nccl"]["warm_steps"] = nccl_warm_steps(dev, smi)
    mark("data parallel: NCCL group of one")
    torch.backends.cudnn.deterministic = False  # serving: cuDNN's defaults
    out["mesh"], p = mesh_leg(root, dev, flagship, tiled_334, work / "mesh")
    paths.update(p)
    mark("data parallel: mesh inference")
    out["dryrun"], p = dryrun_leg()
    paths.update(p)
    mark("data parallel: dryrun_multichip")
    return out, paths


# Phase 17: the 2-D (data x space) spatially sharded flagship on a 2 x 2
# mesh of four gloo ranks sharing the card: (a) the eval forward at 2 x
# 512^2 (each rank a 1 x 256 x 512 slab), (b) train-mode gradients of the
# config's loss at 4 x 128^2 (each rank 2 x 64 x 128); each run twice
# (the second's seconds are the warm ones)
SPATIAL_MESH = (2, 2)
SPATIAL_FWD = (2, 512)
SPATIAL_GRAD = (4, 128)
# phase 3e's third slab in the bf16-sampling mode: the shipped bf16
# flagship's batch (configs/jspsr_r8_img_msk_bf16.yml) on the mesh
SPATIAL_BF16_BATCH = (50, 128)
# phase 3e's second K3 slab: the shipped CompletionFormer's train batch
# (configs/completionformer_r8_img_msk.yml, 16 x 128^2) on the mesh
CF_SPATIAL_BATCH = (16, 128)
SPATIAL_RUNS = 2
SPATIAL_TIMEOUT_S, SPATIAL_INIT_TIMEOUT_S = 600, 120
# (b)'s bound against one process, tests/test_torch_spatial.py's for fp32:
# each gradient within 5e-2 relative L2 (a ReLU or a deform floor near its
# kink may fall on the other side in the sharded forward's summation
# order), the losses within rtol 1e-5
SPATIAL_GRAD_REL_L2 = 5e-2


# Phase 17's other cases on the same mesh, each once, at published widths
# with seeded weights (phase 4's checkpoint for the flagship's): the eval
# forward at SPATIAL_FWD and the gradients at SPATIAL_GRAD, each against
# one process on the card (rank 0 computes it after the sharded run).
# name -> (config, model_kwargs over its own, loss over its own, weights,
# forward, gradients, each deform kernel's launches per sharded forward /
# gradient on every rank)
SLAB, SLAB_B = "deform_fwd_slab", "deform_bwd_slab"
SLAB_BF, SLAB_BF_B = "deform_fwd_bf16_slab", "deform_bwd_bf16_slab"
SLAB_DX = "deform_bwd_dx_slab"
SPATIAL_CASES = {
    # the shipped bf16 flagship, then with bf16 sampling
    "bf16": (BF16_CONFIG, {}, None, "flagship", {SLAB: 1},
             {SLAB: 1, SLAB_B: 1}),
    "bf16_sampling": (BF16_CONFIG, {"spn_sample_dtype": BF16}, None,
                      "flagship", {SLAB_BF: 1}, {SLAB_BF: 1, SLAB_BF_B: 1}),
    # the fp32 flagship's execution options
    "options": (FLAGSHIP, {"fuse_stems": True, "eval_grouped": True}, None,
                "flagship", {SLAB: 1}, None),
    "remat_stages": (FLAGSHIP, {"remat_stages": True}, None, "flagship",
                     None, {SLAB: 1, SLAB_B: 1}),
    # EDSR as shipped (16 blocks, 64 features) and with its SPN head
    "edsr": (EDSR_CONFIG, {}, None, "seeded", {}, {}),
    "edsr_spn": (EDSR_CONFIG, {"spn": True}, None, "seeded", {SLAB: 1},
                 {SLAB: 1, SLAB_B: 1}),
    # LRRU as shipped (bc 16), its DEM with LRRU_HOLES of voids: four
    # rounds, the last one's gradient
    "lrru": (LRRU_CONFIG, {}, None, "seeded", {SLAB: 4},
             {SLAB: 4, SLAB_B: 1}),
    # the flagship under the losses no shipped config names
    "losses": (FLAGSHIP, {}, {"L1": 1, "BerHu": 1, "SSIM": 1, "TV": 0.1},
               "flagship", None, {SLAB: 1, SLAB_B: 1}),
    # CompletionFormer as shipped (83.7 M parameters, NLSPN's 6 steps with
    # its confidence): each step samples the gathered feature on the slab
    # (K1), and its gradient runs K3 on the slab
    "completionformer": (CF_CONFIG, {}, None, "seeded", {SLAB: 6},
                         {SLAB: 6, SLAB_DX: 6}),
}
# a bf16 result against one process: within twice the one-process bf16
# model's distance from its fp32 one (tests/test_torch_bf16.py's FACTOR);
# so are the witnesses, the sharded bf16 model's distances from the fp32
# model and (gradients) from the sharded fp32 model
SPATIAL_BF16_FACTOR = 2.0
# The cases whose sharded forward is held to the one-process forward in
# float64 (on the CPU: the kernels take fp32 only), at LRRU_RTOL /
# LRRU_ATOL plus three times the card's one-process fp32 forward's own
# distance from it (``hold_to_float64``'s rule): the full-width
# random-weight LRRU is ill-conditioned in fp32, and a rehearsal of this
# phase on the CPU put its sharded forward 5.6e-5 from its one-process one
# (2.45 times rtol 1e-4 / atol 1e-5), the distance two fp32 orders of
# summation give it (phase 12's note at LRRU_RTOL).
SPATIAL_FP64_FORWARD = ("lrru",)
# The cases whose forward is held to one process at the JAX suite's
# CompletionFormer tolerance (tests/test_parity_completionformer.py), its
# atol times the output's largest magnitude (at least 1), as phase 7 holds
# the card's CompletionFormer to the CPU: the full-width fp32 model's
# summation order moves its outputs (up to 14.6 here) by about 3e-4,
# beyond the flagship's rtol 1e-4 / atol 1e-5 (NVIDIA H100 80GB HBM3,
# 700.00 W: the sharded forward sat 18 times that bound from one
# process, 0.16 of this one)
SPATIAL_FWD_TOL = {"completionformer": (1e-3, 1e-4)}
# The cases whose sharded gradients are held, each tensor within
# SPATIAL_GRAD_REL_L2, to one process in float64 on the CPU (the same
# weights and batch), not to the card's one-process fp32 gradients:
# CompletionFormer's are ill-conditioned in fp32 at 4 x 128² (NVIDIA H100
# 80GB HBM3, 700.00 W: the card's one-process gradient of
# ``backbone.former.block1.1.resblock.ca.fc.0.weight`` sits 0.113 relative
# L2 from float64, the sharded one 0.022, every sharded tensor within
# 0.022 of float64). The distance from the card's one process is printed
# beside it.
SPATIAL_FP64_GRADS = ("completionformer",)
# ... and their forward at 2 x 256²: the float64 forward of the full-width
# LRRU on the host's CPU took most of phase 17's 85 s outside the ranks at
# 2 x 512² (NVIDIA H100 80GB HBM3, 700.00 W host)
SPATIAL_FP64_FWD = (2, 256)


def spatial_batches(p):
    """Phase 17's batches on the CPU: (a)'s inputs, (b)'s inputs and
    target (``random_batch``, seeded)."""
    fwd_inputs, _ = random_batch(p, SPATIAL_FWD[0], SPATIAL_FWD[1], "cpu",
                                 seed=17)
    grad_inputs, gt = random_batch(p, SPATIAL_GRAD[0], SPATIAL_GRAD[1],
                                   "cpu", seed=18)
    return fwd_inputs, grad_inputs, gt


def spatial_model(ckpt, dev) -> torch.nn.Module:
    """Phase 4's seeded flagship checkpoint in the fp32 flagship config's
    model, on ``dev``."""
    return checkpoint_model(create_config(FLAGSHIP), ckpt).to(dev)


def spatial_case_model(case: str, ckpt, dev, fp32: bool = False):
    """Case ``case``'s model on ``dev`` (with ``fp32``, the bf16 cases'
    model with the fp32 body and sampling, the same weights), its config
    and its loss."""
    config, kwargs, loss, weights = SPATIAL_CASES[case][:4]
    p = create_config(config)
    if fp32:
        kwargs = {"compute_dtype": None, "spn_sample_dtype": None}
    q = create_config_over(p, kwargs)
    if weights == "flagship":
        model = checkpoint_model(q, ckpt)
    else:
        model = perturb_weights(build_model(
            q, generator=torch.Generator().manual_seed(0)), seed=1)
    return model.to(dev), q, dict(loss or p.loss)


def spatial_case_batches(case: str, q):
    """Case ``case``'s batches on the CPU: the forward's inputs, the
    gradients' inputs and target (``random_batch``, seeded; LRRU's DEM
    with LRRU_HOLES of its pixels set to 0, as phase 12's)."""
    holes = LRRU_HOLES if q.model_name.lower() == "lrru" else 0.0
    b, side = (SPATIAL_FP64_FWD if case in SPATIAL_FP64_FORWARD
               else SPATIAL_FWD)
    fwd_inputs, _ = random_batch(q, b, side, "cpu", seed=19)
    grad_inputs, gt = random_batch(q, SPATIAL_GRAD[0], SPATIAL_GRAD[1],
                                   "cpu", seed=20)
    if holes:
        for inputs, seed in ((fwd_inputs, 19), (grad_inputs, 20)):
            gen = torch.Generator().manual_seed(seed)
            inputs[0] = inputs[0].masked_fill(
                torch.rand(inputs[0].shape, generator=gen) < holes, 0.0)
    return fwd_inputs, grad_inputs, gt


def _one_process(model, criterion, fwd_inputs, grad_inputs, gt, dev):
    """``model``'s eval forward and train-mode losses and gradients on the
    whole batches in this process (None where the batch is None)."""
    y = losses = grads = None
    if fwd_inputs is not None:
        model.eval()
        with torch.no_grad():
            y = model([x.to(dev) for x in fwd_inputs]).double().cpu()
    if grad_inputs is not None:
        model.train()
        model.zero_grad(set_to_none=True)
        out = criterion(model([x.to(dev) for x in grad_inputs]), gt.to(dev))
        out["Total"].backward()
        losses = {k: float(v.detach()) for k, v in out.items()}
        grads = {k: q.grad.detach().double().cpu()
                 for k, q in model.named_parameters() if q.grad is not None}
    return y, losses, grads


def _grad_rel_l2(got: dict, ref: dict) -> dict:
    return {k: float((got[k].double() - v).norm()
                     / max(float(v.norm()), 1e-30)) for k, v in ref.items()}


def spatial_case(case: str, rank: int, sharding, ckpt, dev) -> dict:
    """Case ``case`` of phase 17 on this rank: the sharded forward and
    gradients (the launches of each counted from 0), a hash of the summed
    gradients' bytes, the rank's peak device memory through them; on rank
    0 their distance from one process on the card (and, for a bf16 case,
    that one process's distance from the same weights' fp32 model, and
    the witnesses: the sharded model's distance from that fp32 model and
    from the sharded fp32 model, which every rank then runs on the same
    batch, uncounted)."""
    import hashlib

    from jspsr_torch.parallel.spatial import sharded_forward, sharded_grads

    model, q, loss = spatial_case_model(case, ckpt, dev)
    criterion = build_criterion(loss)
    fwd_inputs, grad_inputs, gt = spatial_case_batches(case, q)
    want_fwd, want_grads = SPATIAL_CASES[case][4:]
    if want_fwd is None:
        fwd_inputs = None
    if want_grads is None:
        grad_inputs = None
    out = {"launches": {}, "sharded_s": 0.0}
    y_one = None
    torch.cuda.reset_peak_memory_stats(dev)
    if fwd_inputs is not None:
        model.eval()
        reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            y = sharded_forward(model, [x.to(dev) for x in fwd_inputs],
                                sharding).double().cpu()
        torch.cuda.synchronize(dev)
        out["sharded_s"] += time.perf_counter() - t0
        out["launches"]["forward"] = dict(deform_cuda.LAUNCHES)
        if rank == 0:  # before the train step moves BatchNorm's statistics
            y_one = _one_process(model, criterion, fwd_inputs, None, gt,
                                 dev)[0]
            if case in SPATIAL_FP64_FORWARD:  # held by the caller
                out["y"], out["y_one"] = y.numpy(), y_one.numpy()
    if grad_inputs is not None:
        t0 = time.perf_counter()
        model.train()
        reset_launches()
        losses, grads = sharded_grads(model, criterion,
                                      [x.to(dev) for x in grad_inputs],
                                      gt.to(dev), sharding)
        torch.cuda.synchronize(dev)
        out["launches"]["gradients"] = dict(deform_cuda.LAUNCHES)
        digest = hashlib.sha256()
        for k in sorted(grads):
            digest.update(grads[k].cpu().numpy().tobytes())
        out["sharded_s"] += time.perf_counter() - t0
        out["grads_sha256"] = digest.hexdigest()
        out["losses"] = losses
    # the rank's own allocations (its process): rank 0's one-process
    # forward is in it, its one-process gradients are not
    out["peak_mb"] = torch.cuda.max_memory_allocated(dev) / 2**20
    if case.startswith("bf16") and grad_inputs is not None:
        sharded32 = spatial_case_model(case, ckpt, dev, fp32=True)[0]
        grads_sh32 = {k: v.detach().double().cpu() for k, v in sharded_grads(
            sharded32.train(), criterion, [x.to(dev) for x in grad_inputs],
            gt.to(dev), sharding)[1].items()}
        del sharded32
    if rank != 0:
        return out
    if grad_inputs is not None:
        grads = {k: v.detach().double().cpu() for k, v in grads.items()}
    _, losses_one, grads_one = _one_process(model, criterion, None,
                                            grad_inputs, gt, dev)
    if case in SPATIAL_FP64_GRADS:  # held by the caller
        out["grads"], out["grads_one"] = (
            {k: v.float().numpy() for k, v in g.items()}
            for g in (grads, grads_one))
    if fwd_inputs is not None:
        out["forward_max_abs"] = float((y - y_one).abs().max())
        out["forward_mean_abs"] = float((y - y_one).abs().mean())
        out["forward_max_abs_output"] = float(y_one.abs().max())
        rtol, atol = SPATIAL_FWD_TOL.get(case, (1e-4, 1e-5))
        if case in SPATIAL_FWD_TOL:
            atol *= max(1.0, out["forward_max_abs_output"])
        out["forward_rel_to_tol"] = float(
            ((y - y_one).abs() / (atol + rtol * y_one.abs())).max())
    if grad_inputs is not None:
        out["grad_rel_l2"] = _grad_rel_l2(grads, grads_one)
        out["same_grad_keys"] = sorted(grads) == sorted(grads_one)
        out["loss_rel_err"] = {k: abs(losses[k] - v) / max(abs(v), 1e-30)
                               for k, v in losses_one.items()}
    if case.startswith("bf16"):
        del model
        fp32, *_ = spatial_case_model(case, ckpt, dev, fp32=True)
        y32, losses32, grads32 = _one_process(fp32, criterion, fwd_inputs,
                                              grad_inputs, gt, dev)
        out["bf16_own_fwd_max_abs"] = float((y_one - y32).abs().max())
        out["bf16_own_fwd_mean_abs"] = float((y_one - y32).abs().mean())
        out["bf16_own_grad_rel_l2"] = _grad_rel_l2(grads_one, grads32)
        out["bf16_own_loss_rel_err"] = {
            k: abs(v - losses32[k]) / max(abs(v), 1e-30)
            for k, v in losses_one.items()}
        # the witness: a sound sharded bf16 model sits about as far from
        # the fp32 model as one process's bf16 model does
        if fwd_inputs is not None:
            out["bf16_sharded_fwd_max_abs"] = float((y - y32).abs().max())
        if grad_inputs is not None:
            out["bf16_sharded_grad_rel_l2"] = _grad_rel_l2(grads, grads32)
            out["bf16_vs_sharded_fp32_grad_rel_l2"] = _grad_rel_l2(
                grads, grads_sh32)
            out["sharded_fp32_grad_rel_l2"] = _grad_rel_l2(grads_sh32,
                                                           grads32)
    out["peak_mb_with_reference"] = (torch.cuda.max_memory_allocated(dev)
                                     / 2**20)
    return out


def spatial_fp64_references(ckpt) -> dict:
    """The one-process float64 references on the CPU (the same weights and
    batches as the cases'): each SPATIAL_FP64_FORWARD case's eval forward
    (``"forward"``) and each SPATIAL_FP64_GRADS case's gradients
    (``"grads"``), numpy. Four intra-op threads: it runs beside the
    ranks (``spatial_phase``), which share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    refs = {}
    try:
        for case in (*SPATIAL_FP64_FORWARD, *SPATIAL_FP64_GRADS):
            model, q, loss = spatial_case_model(case, ckpt,
                                                torch.device("cpu"))
            fwd_inputs, grad_inputs, gt = spatial_case_batches(case, q)
            model, ref = model.double(), refs.setdefault(case, {})
            if case in SPATIAL_FP64_FORWARD:
                with torch.no_grad():
                    ref["forward"] = model.eval()(
                        [x.double() for x in fwd_inputs]).numpy()
            if case in SPATIAL_FP64_GRADS:
                model.train()
                build_criterion(loss)(
                    model([x.double() for x in grad_inputs]),
                    gt.double())["Total"].backward()
                ref["grads"] = {k: w.grad.numpy() for k, w in
                                model.named_parameters()
                                if w.grad is not None}
    finally:
        torch.set_num_threads(threads)
    return refs


def spatial_fp64_forward(y, y_one, y64) -> dict:
    """A case's sharded forward ``y`` held to its one-process forward in
    float64 on the CPU ``y64`` (the same weights and batch), with the
    card's one-process fp32 forward ``y_one``'s own distance from it
    (SPATIAL_FP64_FORWARD's rule)."""
    own = float(np.abs(y_one - y64).max())
    return {"sharded_vs_fp64_max_abs": float(np.abs(y - y64).max()),
            "one_vs_fp64_max_abs": own,
            "rel_to_tol": float((np.abs(y - y64) / (
                LRRU_ATOL + 3 * own + LRRU_RTOL * np.abs(y64))).max())}


def spatial_fp64_grads(grads: dict, grads_one: dict, g64: dict) -> dict:
    """A case's sharded gradients ``grads`` and the card's one-process ones
    ``grads_one`` (fp32 numpy) against one process's in float64 on the
    CPU ``g64`` (SPATIAL_FP64_GRADS's rule): each tensor's relative L2,
    and the worst of each."""
    out = {}
    for key, g in (("sharded", grads), ("one_process", grads_one)):
        rel = {k: float(np.linalg.norm(g[k].astype(np.float64) - v)
                        / max(float(np.linalg.norm(v)), 1e-30))
               for k, v in g64.items()}
        out[f"{key}_rel_l2"] = rel
        out[f"{key}_worst"] = max(rel, key=rel.get)
        out[f"{key}_max_rel_l2"] = rel[out[f"{key}_worst"]]
    out["same_keys"] = sorted(grads) == sorted(g64)
    return out


def spatial_case_failures(case: str, r0: dict, ranks: list) -> list:
    """What fails in case ``case`` of phase 17 (rank 0's ``spatial_case``
    result ``r0``, every rank's ``ranks``): the bounds of its docstring."""
    want_fwd, want_grads = SPATIAL_CASES[case][4:]
    want = {k: deform_counts(**v) for k, v in
            (("forward", want_fwd), ("gradients", want_grads))
            if v is not None}
    fails = [f"rank {i} launches {r['launches']} != {want}"
             for i, r in enumerate(ranks) if r["launches"] != want]
    bf16 = case.startswith("bf16")
    factor = SPATIAL_BF16_FACTOR
    if want_fwd is not None:
        if bf16:
            if (r0["forward_max_abs"] > factor * r0["bf16_own_fwd_max_abs"]
                    or r0["forward_mean_abs"]
                    > factor * r0["bf16_own_fwd_mean_abs"]):
                fails.append("forward beyond the bf16 rule")
            if (r0["bf16_sharded_fwd_max_abs"]
                    > factor * r0["bf16_own_fwd_max_abs"]):
                fails.append("sharded bf16 forward beyond the bf16 rule "
                             "from the fp32 model")
        elif case in SPATIAL_FP64_FORWARD:
            if r0["forward_fp64"]["rel_to_tol"] > 1:
                fails.append("forward beyond its float64 rule")
        elif r0["forward_rel_to_tol"] > 1:
            fails.append("forward beyond its tolerance (rtol 1e-4 / atol "
                         "1e-5, or SPATIAL_FWD_TOL's)")
    if want_grads is not None:
        if not r0["same_grad_keys"]:
            fails.append("gradient keys differ")
        if any(r["grads_sha256"] != r0["grads_sha256"] for r in ranks):
            fails.append("summed gradients differ between ranks")
        for k, e in r0["loss_rel_err"].items():
            bound = (factor * r0["bf16_own_loss_rel_err"][k] if bf16
                     else 1e-5)
            if e > bound:
                fails.append(f"loss {k}: rel err {e} > {bound}")
        held = r0["grad_rel_l2"]
        if case in SPATIAL_FP64_GRADS:
            held = r0["grads_fp64"]["sharded_rel_l2"]
            if not r0["grads_fp64"]["same_keys"]:
                fails.append("gradient keys differ from float64's")
        for k, e in held.items():
            bound = (factor * r0["bf16_own_grad_rel_l2"][k] + 1e-6 if bf16
                     else SPATIAL_GRAD_REL_L2)
            if e > bound:
                fails.append(f"gradient {k}: rel L2 {e} > {bound}")
            for witness in (("bf16_sharded_grad_rel_l2",
                             "bf16_vs_sharded_fp32_grad_rel_l2") if bf16
                            else ()):
                if r0[witness][k] > bound:
                    fails.append(f"gradient {k}: {witness} "
                                 f"{r0[witness][k]} > {bound}")
    return fails


def spatial_rank(rank: int, world: int, ckpt: str, device: str) -> dict:
    """Phase 17 on one rank of the 2 x 2 mesh (``parallel.spawn.
    run_ranks``, gloo, on ``device``): (a) and (b) SPATIAL_RUNS times each,
    the launches of each run counted from 0, its seconds (synchronised);
    rank 0 returns the gathered output and the summed gradients of the
    first runs, every rank a hash of its gradients' bytes."""
    import hashlib

    from jspsr_torch.parallel.mesh import make_2d_mesh, spatial_sharding
    from jspsr_torch.parallel.spatial import sharded_forward, sharded_grads

    set_strict_fp32()
    set_deterministic_cudnn()
    dev = torch.device(device)
    sharding = spatial_sharding(make_2d_mesh(*SPATIAL_MESH))
    p = create_config(FLAGSHIP)
    model = spatial_model(Path(ckpt), dev)
    fwd_inputs, grad_inputs, gt = spatial_batches(p)
    criterion = build_criterion(dict(p.loss))
    out = {"rank": rank, "forward_s": [], "grad_s": [], "launches": []}
    for i in range(SPATIAL_RUNS):
        model.eval()
        reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            y = sharded_forward(model, [x.to(dev) for x in fwd_inputs],
                                sharding)
        torch.cuda.synchronize(dev)
        out["forward_s"].append(time.perf_counter() - t0)
        fwd_launches = dict(deform_cuda.LAUNCHES)
        model.train()
        reset_launches()
        t0 = time.perf_counter()
        losses, grads = sharded_grads(model, criterion,
                                      [x.to(dev) for x in grad_inputs],
                                      gt.to(dev), sharding)
        torch.cuda.synchronize(dev)
        out["grad_s"].append(time.perf_counter() - t0)
        out["launches"].append({"forward": fwd_launches,
                                "gradients": dict(deform_cuda.LAUNCHES)})
        if i == 0:
            out["losses"] = losses
            digest = hashlib.sha256()
            for k in sorted(grads):
                digest.update(grads[k].cpu().numpy().tobytes())
            out["grads_sha256"] = digest.hexdigest()
            if rank == 0:
                out["y"] = y.cpu().numpy()
                out["grads"] = {k: v.cpu().numpy() for k, v in grads.items()}
    del model, y, grads
    torch.cuda.empty_cache()
    # a bf16 tensor through gloo on the card as it is (``all_gather_list``
    # sends bf16 as bytes whatever the backend takes)
    x = torch.ones(4, device=dev, dtype=torch.bfloat16)
    try:
        torch.distributed.all_gather([torch.empty_like(x)
                                      for _ in range(world)], x)
        out["gloo_bf16_on_cuda"] = "taken"
    except RuntimeError as err:
        out["gloo_bf16_on_cuda"] = f"refused: {err}"
    out["cases"] = {}
    for case in SPATIAL_CASES:
        out["cases"][case] = spatial_case(case, rank, sharding, Path(ckpt),
                                          dev)
        torch.cuda.empty_cache()
    return out


def spatial_phase(dev: torch.device, flagship, smi: str) -> tuple:
    """Phase 17: the 2-D (data x space) spatially sharded flagship
    (``parallel.mesh.make_2d_mesh``, ``spatial_sharding``), phase 4's
    seeded full-width checkpoint, fp32, TF32 off, cuDNN's deterministic
    algorithms, on four gloo ranks sharing this card (NCCL refuses two
    ranks on one GPU): (a) the eval forward at 2 x 512^2, gathered, within
    rtol 1e-4 / atol 1e-5 of one process on the whole batch; (b) the
    gradients of the config's loss (L1 + L2 + 0.1 Grad) in train mode at
    4 x 128^2, summed over the mesh, against one process: the losses
    within rtol 1e-5, every gradient within SPATIAL_GRAD_REL_L2 relative
    L2, every rank's gradient bit-equal to rank 0's; one K1 on a slab per
    forward and one K1 and one K2 on a slab per gradient on every rank, no
    other deform launch. The seconds are a correctness run's through gloo,
    not a scaling figure."""
    import gc

    from jspsr_torch.parallel.spawn import run_ranks

    _, _, ckpt = flagship
    set_deterministic_cudnn()
    model = spatial_model(ckpt, dev)
    fwd_inputs, grad_inputs, gt = spatial_batches(create_config(FLAGSHIP))
    model.eval()
    reset_launches()
    with torch.no_grad():
        y_one = model([x.to(dev) for x in fwd_inputs]).cpu().numpy()
    one_launches = {"forward": dict(deform_cuda.LAUNCHES)}
    model.train()
    model.zero_grad(set_to_none=True)
    reset_launches()
    losses_one = build_criterion(dict(create_config(FLAGSHIP).loss))(
        model([x.to(dev) for x in grad_inputs]), gt.to(dev))
    losses_one["Total"].backward()
    torch.cuda.synchronize(dev)
    one_launches["gradients"] = dict(deform_cuda.LAUNCHES)
    grads_one = {k: q.grad.cpu().numpy() for k, q in model.named_parameters()
                 if q.grad is not None}
    losses_one = {k: float(v.detach()) for k, v in losses_one.items()}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the float64 references on the host's CPU while the ranks run
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(spatial_fp64_references, ckpt)
        ranks = run_ranks(spatial_rank, SPATIAL_MESH[0] * SPATIAL_MESH[1],
                          str(ckpt), str(dev), device=str(dev),
                          backend="gloo",
                          init_timeout_s=SPATIAL_INIT_TIMEOUT_S,
                          timeout_s=SPATIAL_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        mark("spatial sharding: the ranks")
        fp64 = running.result()
    mark("spatial sharding: the float64 references on the CPU")
    r0 = ranks[0]
    y, grads = r0.pop("y"), r0.pop("grads")
    fwd_err = float(np.abs(y - y_one).max())
    grad_err = {k: float(np.linalg.norm(grads[k].astype(np.float64) - v)
                         / max(np.linalg.norm(v), 1e-12))
                for k, v in grads_one.items()}
    loss_err = {k: abs(r0["losses"][k] - v) / abs(v)
                for k, v in losses_one.items()}
    want = {"forward": deform_counts(deform_fwd_slab=1),
            "gradients": deform_counts(deform_fwd_slab=1, deform_bwd_slab=1)}
    out = {
        "config": str(FLAGSHIP.relative_to(REPO)), "mesh": SPATIAL_MESH,
        "forward_batch": SPATIAL_FWD, "grad_batch": SPATIAL_GRAD,
        "forward_max_abs": fwd_err,
        "forward_max_abs_output": float(np.abs(y_one).max()),
        "grad_max_rel_l2": max(grad_err.values()),
        "grad_worst": max(grad_err, key=grad_err.get),
        "loss_rel_err": loss_err, "losses": r0["losses"],
        "one_process_losses": losses_one,
        "grads_bit_equal_over_ranks": all(
            r["grads_sha256"] == r0["grads_sha256"] for r in ranks),
        "launches_per_rank": [r["launches"] for r in ranks],
        "one_process_launches": one_launches,
        "forward_s": [r["forward_s"] for r in ranks],
        "grad_s": [r["grad_s"] for r in ranks], "ranks_wall_s": ranks_s,
        "card": smi,
        "note": "four ranks sharing one card through gloo: a correctness "
                "run, no scaling figure",
    }
    print(f"spatial sharding: forward max |diff| {fwd_err:.3g} (output up "
          f"to {out['forward_max_abs_output']:.3g}), gradients max rel L2 "
          f"{out['grad_max_rel_l2']:.3g} ({out['grad_worst']}), losses "
          f"{r0['losses']} vs one process {losses_one}; seconds per "
          f"forward {out['forward_s']}, per gradient {out['grad_s']}",
          flush=True)
    np.testing.assert_allclose(y, y_one, rtol=1e-4, atol=1e-5)
    if (max(grad_err.values()) > SPATIAL_GRAD_REL_L2
            or sorted(grads) != sorted(grads_one)
            or max(loss_err.values()) > 1e-5
            or not out["grads_bit_equal_over_ranks"]
            or any(run != want for r in ranks for run in r["launches"])
            or one_launches != {"forward": deform_counts(deform_fwd=1),
                                "gradients": deform_counts(deform_fwd=1,
                                                           deform_bwd=1)}):
        raise AssertionError(f"spatial sharding: {out}")
    out["gloo_bf16_on_cuda"] = r0["gloo_bf16_on_cuda"]
    cases, fails = {}, {}
    for case in SPATIAL_CASES:
        rows = [r["cases"][case] for r in ranks]
        if case in SPATIAL_FP64_FORWARD:
            rows[0]["forward_fp64"] = spatial_fp64_forward(
                rows[0].pop("y"), rows[0].pop("y_one"),
                fp64[case]["forward"])
        if case in SPATIAL_FP64_GRADS:
            rows[0]["grads_fp64"] = spatial_fp64_grads(
                rows[0].pop("grads"), rows[0].pop("grads_one"),
                fp64[case]["grads"])
        cases[case] = dict(rows[0], launches_per_rank=[
            r["launches"] for r in rows], sharded_s=[
            r["sharded_s"] for r in rows], peak_mb_per_rank=[
            r["peak_mb"] for r in rows])
        for k in ("launches", "peak_mb"):
            cases[case].pop(k)
        c = cases[case]
        if "grads_fp64" in c:
            c["grads_fp64"] = {k: v for k, v in c["grads_fp64"].items()
                               if not k.endswith("_rel_l2")
                               or "_max_" in k}
        if "grad_rel_l2" in c:
            c["grad_worst"] = max(c["grad_rel_l2"], key=c["grad_rel_l2"].get)
            c["grad_max_rel_l2"] = c["grad_rel_l2"][c["grad_worst"]]
            if "bf16_own_grad_rel_l2" in c:
                ratio = {k: v / max(c["bf16_own_grad_rel_l2"][k], 1e-30)
                         for k, v in c["grad_rel_l2"].items()}
                c["bf16_worst_ratio"] = max(ratio.values())
                c["bf16_worst_ratio_tensor"] = max(ratio, key=ratio.get)
                c["bf16_median_ratio"] = float(np.median(list(
                    ratio.values())))
                # the witness's ratios: the sharded bf16 model's distance
                # from the fp32 one over one process's
                worst = c["bf16_worst_ratio_tensor"]
                for key, name in (
                        ("bf16_sharded_grad_rel_l2", "bf16_witness"),
                        ("bf16_vs_sharded_fp32_grad_rel_l2",
                         "bf16_witness_sharded_fp32")):
                    witness = {k: v / max(c["bf16_own_grad_rel_l2"][k],
                                          1e-30) for k, v in c[key].items()}
                    c[f"{name}_worst_ratio"] = max(witness.values())
                    c[f"{name}_worst_tensor"] = max(witness,
                                                    key=witness.get)
                    c[f"{name}_median_ratio"] = float(
                        np.median(list(witness.values())))
                    c[f"{name}_at_worst_ratio_tensor"] = witness[worst]
                # sharding's own effect in fp32 there, over the same
                c["sharded_fp32_at_worst_ratio_tensor"] = (
                    c["sharded_fp32_grad_rel_l2"][worst]
                    / max(c["bf16_own_grad_rel_l2"][worst], 1e-30))
                c["sharded_fp32_max_rel_l2"] = max(
                    c["sharded_fp32_grad_rel_l2"].values())
                for k in ("bf16_own_grad_rel_l2", "bf16_sharded_grad_rel_l2",
                          "bf16_vs_sharded_fp32_grad_rel_l2",
                          "sharded_fp32_grad_rel_l2"):
                    c.pop(k)
            c.pop("grad_rel_l2")
        print(f"spatial sharding, {case}: {c}", flush=True)
        fails[case] = spatial_case_failures(case, rows[0], rows)
    out["cases"] = cases
    paths = {f"spatial_rank{r['rank']}": sum_launches(
        {**{f"{i}_{k}": v for i, run in enumerate(r["launches"])
            for k, v in run.items()},
         **{f"{case}_{k}": v for case, c in r["cases"].items()
            for k, v in c["launches"].items()}}) for r in ranks}
    if any(fails.values()):
        raise AssertionError(f"spatial sharding cases: {fails}")
    return out, paths


# Phase 18: the shipped flagship's parameter count, the JAX model's
# (tests/test_torch_configs.py, tests/test_torch_summary.py)
FLAGSHIP_PARAMS = 43_869_763
# the device kernels printed, by summed time in the traced step
TOP_KERNELS = 5
# the phase's launches in its process: two runs of a warm step and one
# more, and the counted step (one K1 and one K2 each), two untraced eval
# forwards, a traced one and entry()'s (one K1 each); the summary
# launches nothing
SUMMARY_TRACE_LAUNCHES = {"deform_fwd": 9, "deform_bwd": 5}
# entry()'s forward on the card against entry("cpu"): the JAX suite's
# tolerance (tests/test_parity_jspsr.py)
ENTRY_RTOL, ENTRY_ATOL = 1e-4, 2e-5

# run in a process of its own: phase 18 (``summary_trace_child``)
SUMMARY_TRACE = r"""
import json, sys
import chip_smoke
print(json.dumps(chip_smoke.summary_trace_child(sys.argv[1], sys.argv[2])))
"""


def trace_window(path) -> tuple:
    """The ``trace_step`` span of a Chrome trace: (start, end) in us."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "trace_step"
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise AssertionError(f"{path}: {len(spans)} trace_step spans")
    return spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]


def kernel_table(path) -> dict:
    """A Chrome trace's device kernels: by name, their count and summed
    time (ms); and the device's busy share over the ``trace_step`` span
    (the union of the kernels' intervals within it over its length)."""
    kernels = trace_kernels(path)
    by_name = {}
    for e in kernels:
        n, ms = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    start, end = trace_window(path)
    busy, reach = 0.0, start
    for ts, te in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        ts, te = max(ts, reach), min(te, end)
        if te > ts:
            busy += te - ts
            reach = te
    return {"by_name": by_name, "busy_share": busy / (end - start),
            "window_ms": (end - start) / 1e3}


def named(by_name: dict, key: str) -> int:
    """How many kernels of the table ``by_name`` have ``key`` in their
    name."""
    return sum(n for name, (n, _) in by_name.items() if key in name)


def summary_trace_child(ckpt: str, log_dir: str) -> dict:
    """Phase 18, in a process of its own (``SUMMARY_TRACE``): the
    summary of the flagship checkpoint ``ckpt`` at its train batch on the
    card, then traces of a warm train step and of an eval forward into
    ``log_dir`` (the module's docstring)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    set_strict_fp32()
    set_deterministic_cudnn()
    reset_launches()
    p = create_config(FLAGSHIP)
    batch = int(p.train_batch_size)
    model = checkpoint_model(p, ckpt)
    inputs, gt = train_batch(p, batch, 5)
    cpu_shape, cpu_dtype, cpu_flops = forward_cost(model, inputs)
    model.to(dev)
    inputs, gt = [x.to(dev) for x in inputs], gt.to(dev)
    # (a) the summary allocates nothing on the card and launches nothing.
    # The process's first fake tensor on the card probes the CUDA context
    # once (torch's ``init_gpu_context``: ``torch.empty(1)``, freed at
    # once): the first call's peak is kept apart
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    shape, dtype, flops = forward_cost(model, inputs)
    first = torch.cuda.max_memory_allocated(dev) - held
    torch.cuda.reset_peak_memory_stats(dev)
    text = model_summary(model, inputs)
    peak = torch.cuda.max_memory_allocated(dev)
    lines = text.splitlines()
    summary = {"batch": [batch, 128, 128], "lines": lines[-3:],
               "groups": len(lines) - 3, "forward_flops": flops,
               "cpu_forward_flops": cpu_flops, "bytes_held": held,
               "peak_bytes_over_call": peak,
               "first_call_probe_bytes": first,
               "held_after": torch.cuda.memory_allocated(dev),
               "launches": dict(deform_cuda.LAUNCHES)}
    want = [f"{'TOTAL':<{len(lines[-3]) - 14}}  {FLAGSHIP_PARAMS:>12,}",
            f"output: {(batch, 1, 128, 128)} torch.float32",
            f"forward flops: {flops:.3e}"]
    if (lines[-3:] != want or flops != cpu_flops or peak != held
            or summary["held_after"] != held or first > 512
            or (shape, dtype) != (cpu_shape, cpu_dtype)
            or any(deform_cuda.LAUNCHES.values())):
        raise AssertionError(f"summary at {batch} x 128^2: {summary}, "
                             f"expected {want}")
    # (b) a warm train step twice from one state, the second traced
    state = {k: v.clone() for k, v in model.state_dict().items()}
    warm_inputs, warm_gt = train_batch(p, batch, 6)
    warm_inputs, warm_gt = [x.to(dev) for x in warm_inputs], warm_gt.to(dev)
    runs = {}
    for traced in (False, True):
        m = model_from_state(p, state).to(dev)
        gen = torch.Generator(dev)
        seed_step_generator(gen, p.get("seed", 0), 0)
        step = make_train_step(m, build_criterion(dict(p.loss)),
                               build_optimizer(p, m), generator=gen)
        step(warm_inputs, warm_gt)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        if traced:
            losses, _ = trace_step(step, inputs, gt,
                                   log_dir=Path(log_dir) / "step")
        else:
            losses = step(inputs, gt)
            torch.cuda.synchronize()
        runs[traced] = ((time.perf_counter() - s0) * 1e3,
                        {k: v.detach().clone() for k, v in losses.items()},
                        {n: t.detach().clone() for n, t in
                         [*m.named_parameters(), *m.named_buffers()]})
        del m, step
    (step_ms, loss_u, after_u), (traced_ms, loss_t, after_t) = \
        runs[False], runs[True]
    # (c) the step's FLOPs, from one more step from the same state
    m = model_from_state(p, state).to(dev)
    step = make_train_step(m, build_criterion(dict(p.loss)),
                           build_optimizer(p, m))
    _, step_flops = count_flops(step, inputs, gt)
    torch.cuda.synchronize()
    del m, step
    unequal = [n for n in after_u if not torch.equal(after_u[n], after_t[n])]
    unequal += [k for k in loss_u if not torch.equal(loss_u[k], loss_t[k])]
    # ... and the eval forward, untraced and traced
    forward = make_forward(model)
    ref = forward(inputs)
    torch.cuda.synchronize()
    f0 = time.perf_counter()
    forward(inputs)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - f0) * 1e3
    out, _ = trace_step(forward, inputs, log_dir=Path(log_dir) / "forward")
    step_table = kernel_table(Path(log_dir) / "step" / "trace_000.json")
    fwd_table = kernel_table(Path(log_dir) / "forward" / "trace_000.json")
    # (d) entry() on its default device, the card, with the counts set to
    # 0 just before its forward and added back to the phase's after it
    launches = dict(deform_cuda.LAUNCHES)
    fn, args = entry()
    reset_launches()
    y = fn(*args)
    torch.cuda.synchronize()
    entry_launches = {k: n for k, n in deform_cuda.LAUNCHES.items() if n}
    for k, n in launches.items():
        deform_cuda.LAUNCHES[k] += n
    cpu_fn, cpu_args = entry(device="cpu")
    y_cpu = cpu_fn(*cpu_args)
    entry_err = float((y.cpu() - y_cpu).abs().max())
    entry_ok = (y.shape == y_cpu.shape == (1, 1, 128, 128)
                and bool(torch.allclose(y.cpu(), y_cpu, rtol=ENTRY_RTOL,
                                        atol=ENTRY_ATOL)))
    del fn, cpu_fn
    launches = dict(deform_cuda.LAUNCHES)
    top = sorted(step_table["by_name"].items(), key=lambda kv: -kv[1][1])
    result = {
        "summary": summary, "launches": launches,
        "step": {"untraced_ms": step_ms, "traced_ms": traced_ms,
                 "loss": float(loss_u["Total"]), "tensors": len(after_u),
                 "unequal": unequal, "kernels": sum(
                     n for n, _ in step_table["by_name"].values()),
                 "busy_share": step_table["busy_share"],
                 "window_ms": step_table["window_ms"],
                 "k1": named(step_table["by_name"], "deform_fwd_kernel"),
                 "k2": named(step_table["by_name"], "deform_bwd_kernel"),
                 "top": [{"name": n, "count": c, "ms": ms}
                         for n, (c, ms) in top[:TOP_KERNELS]]},
        "forward": {"untraced_ms": fwd_ms,
                    "bit_equal": bool(torch.equal(out, ref)),
                    "busy_share": fwd_table["busy_share"],
                    "k1": named(fwd_table["by_name"], "deform_fwd_kernel"),
                    "k2": named(fwd_table["by_name"], "deform_bwd_kernel")},
        "entry": {"launches": entry_launches, "max_abs_err": entry_err,
                  "allclose": entry_ok},
        "step_flops": step_flops,
        "forward_tflops_per_s": flops / fwd_ms / 1e9,
        "step_tflops_per_s": step_flops / step_ms / 1e9,
        "seconds": time.perf_counter() - t0,
    }
    if ((result["step"]["k1"], result["step"]["k2"]) != (1, 1)
            or (result["forward"]["k1"], result["forward"]["k2"]) != (1, 0)
            or unequal or not result["forward"]["bit_equal"]
            or entry_launches != {"deform_fwd": 1} or not entry_ok
            or not 2 * flops <= step_flops < 3 * flops
            or {k: n for k, n in launches.items() if n}
            != SUMMARY_TRACE_LAUNCHES
            or not np.isfinite(result["step"]["loss"])):
        raise AssertionError(f"summary and trace: {result}")
    return result


def summary_trace(flagship, smi: str) -> tuple:
    """Phase 18 (``summary_trace_child``) in a process of its own; prints
    its figures beside the card's name and power limit, and returns
    (result, launches)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the child's step at batch 50 needs room
    with tempfile.TemporaryDirectory(prefix="jspsr_trace_") as log_dir:
        result = child_json(SUMMARY_TRACE, str(flagship[2]), log_dir,
                            what="phase 18")
    result["card"] = smi
    step, summ = result["step"], result["summary"]
    print(f"summary at {summ['batch']}: {summ['lines']}, CPU flops "
          f"{summ['cpu_forward_flops']}, peak over the call "
          f"{summ['peak_bytes_over_call']} of {summ['bytes_held']} bytes "
          f"held (the first call's context probe "
          f"{summ['first_call_probe_bytes']} bytes) [{smi}]", flush=True)
    for k in step["top"]:
        print(f"traced step top kernel: {k['ms']:.3f} ms in {k['count']} "
              f"x {k['name'][:120]} [{smi}]", flush=True)
    print(f"traced step at 50 x 128^2: {step['kernels']} kernels, K1 "
          f"{step['k1']}, K2 {step['k2']}, device busy "
          f"{step['busy_share']:.4f} of {step['window_ms']:.2f} ms; "
          f"untraced {step['untraced_ms']:.2f} ms, traced "
          f"{step['traced_ms']:.2f} ms; 0 of {step['tensors']} tensors and "
          f"losses differ [{smi}]", flush=True)
    print(f"forward flops {summ['forward_flops']}: eval forward "
          f"{result['forward']['untraced_ms']:.2f} ms, "
          f"{result['forward_tflops_per_s']:.2f} TFLOP/s; step flops "
          f"{result['step_flops']} (counted; the deform backward left "
          f"out) {result['step_tflops_per_s']:.2f} TFLOP/s [{smi}]",
          flush=True)
    ent = result["entry"]
    print(f"entry() on the card at 1 x 128^2: launches {ent['launches']}, "
          f"max |card - CPU| {ent['max_abs_err']:.3e} (rtol {ENTRY_RTOL}, "
          f"atol {ENTRY_ATOL}) [{smi}]", flush=True)
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s", flush=True)
    return result, result["launches"]


def sum_launches(by_run: dict) -> dict:
    """The launch counts of several runs of one path, summed by kernel."""
    total = {}
    for counts in by_run.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def phase(n: int, t_start: float) -> None:
    print(f"phase {n} starts at {time.perf_counter() - t_start:.1f} s",
          flush=True)


_T_START = time.perf_counter()


def mark(label: str) -> None:
    """Print the seconds since the script started beside ``label``: where
    a phase's time goes."""
    print(f"[{label} done at {time.perf_counter() - _T_START:.1f} s]",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}",
          flush=True)
    set_strict_fp32()
    card, (bandwidth, fp32_peak, bf16_peak) = card_peaks(kind)

    # 2. build every kernel of the paths, one nvcc per source, together
    t0 = time.perf_counter()
    built = cuda_build.build(verbose=True)
    for name, (lib, nvcc_s) in built.items():
        print(f"built {lib.name}: nvcc {nvcc_s:.2f} s", flush=True)
    print(f"build total {time.perf_counter() - t0:.2f} s", flush=True)
    sass = cuda_build.sass_atomics(cuda_build.library_path("deform_bwd"))
    for kernel, ops in sass.items():
        print(f"SASS atomics of {kernel}: {ops}", flush=True)
    spins = {k: o for k, o in sass.items()
             if any(op.startswith("ATOMS.CAST.SPIN") for op in o)}
    if spins:
        raise AssertionError(f"deform_bwd.cu compiles a shared-memory "
                             f"atomic to a compare-and-swap loop: {spins}")

    phase(3, t_start)
    # 3. each kernel against its plain version
    fwd_rows, fwd_host_us = check_deform_kernel(dev, bandwidth, fp32_peak)
    fwd_bf16_rows, _ = check_deform_kernel(dev, bandwidth, fp32_peak, BF16,
                                           seed=5)
    bwd_rows = check_deform_backward(dev, bandwidth, fp32_peak,
                                     BWD_SHAPES + dp_shapes()[1])
    bwd_bf16_rows = check_deform_backward(dev, bandwidth, fp32_peak,
                                          BF16_BWD_SHAPES, BF16, seed=6)
    dx_rows = check_deform_backward_dx(dev, bandwidth, fp32_peak)
    # 3e. K1 and K2 on phase 17's row slabs, in each sampling mode
    slab_fwd_rows, slab_bwd_rows = check_deform_slabs(dev, bandwidth,
                                                      fp32_peak)
    slab_fwd_bf16_rows, slab_bwd_bf16_rows = check_deform_slabs(
        dev, bandwidth, fp32_peak, seed=8, sample_dtype=BF16)
    # ... and K3 on phase 17's gradient slab and the shipped
    # CompletionFormer batch's, in each sampling mode
    slab_dx_rows = check_k3_slabs(dev, bandwidth, fp32_peak)
    slab_dx_bf16_rows = check_k3_slabs(dev, bandwidth, fp32_peak, seed=10,
                                       sample_dtype=BF16)
    # ... and K3 on an empty batch and on empty slabs
    k3_empty = k3_empty_slabs(dev)
    # 3d. K3's bf16-sampling mode, then through the op's autograd
    dx_bf16_rows = check_deform_backward_dx_bf16(dev, bandwidth, fp32_peak)
    paths = dict(zip(("k3_bf16_autograd", "k3_bf16_slab_autograd"),
                     k3_bf16_autograd(dev)))
    with tempfile.TemporaryDirectory(prefix="jspsr_chip_smoke_") as tmp:
        tmp = Path(tmp)
        phase(4, t_start)
        # 4. serving the flagship through the CLI
        flagship = seeded_checkpoint(tmp / "flagship", "jspsr_r8_img_msk",
                                     "JSPSR", {"num_block": 2,
                                               "num_feature": 32})
        serving, paths["serving"] = serve(tmp / "serve", dev, flagship)
        serving["peak_source"] = "torch.cuda.max_memory_allocated per scene"
        phase(5, t_start)
        # 5. training the flagship through the Trainer
        root = tmp / "DFC30_8m"
        data_s = make_train_tree(root)
        training, paths["training"] = train(
            FLAGSHIP, root, tmp / "train", dev, compare_batch=4,
            perturbed=False)
        training["data_gen_s"] = data_s
        phase(6, t_start)
        # 6. training CompletionFormer through the Trainer
        cf_training, paths["cf_training"] = train(
            CF_CONFIG, root, tmp / "train_cf", dev, compare_batch=2,
            perturbed=True)
        # the Trainer asked cuDNN for deterministic algorithms, a
        # process-wide setting; serving runs as a process of its own, with
        # cuDNN's defaults, as in phase 4
        torch.backends.cudnn.deterministic = False
        phase(7, t_start)
        # 7. serving CompletionFormer through the CLI
        cf_serving, paths["cf_serving"] = serve_cf(tmp / "serve_cf", dev)
        phase(8, t_start)
        # 8. K4 against its plain version, then the TPU probe's port
        conv_rows = check_conv_same(dev, bandwidth, fp32_peak, bf16_peak)
        probe_rows, paths["conv_probe"] = conv_probe()
        phase(9, t_start)
        # 9. tiled serving of the flagship through the CLI
        tiled, tiled_paths = serve_tiled(tmp / "tiled", dev, flagship)
        paths.update(tiled_paths)
        phase(10, t_start)
        # 10. fit, --val, the CPU's scores and the resume gate
        fitted, paths["fit"] = fit(root, tmp / "fit", dev, smi_line)
        phase(11, t_start)
        # 11. EDSR, as shipped and with its SPN head: train and serve
        edsr, edsr_paths = phase_edsr(tmp / "edsr", root, dev,
                                      tmp / "serve" / "scenes",
                                      tmp / "tiled" / "334")
        paths.update(edsr_paths)
        phase(12, t_start)
        # 12. LRRU: train and serve
        lrru, lrru_paths = phase_lrru(tmp / "lrru", root, dev)
        paths.update(lrru_paths)
        phase(13, t_start)
        # 13. the mixed-precision flagship: fit, feeds, sampling, serving
        set_deterministic_cudnn()
        bf16, bf16_paths = bf16_phase(root, tmp / "bf16", dev,
                                      tmp / "serve" / "scenes",
                                      tmp / "tiled" / "334", smi_line)
        paths.update(bf16_paths)
        phase(14, t_start)
        # 14. export: the flagship and the bf16 flagship as artifacts
        exported, export_paths = export_phase(tmp / "export", dev, flagship,
                                              smi_line)
        paths.update(export_paths)
        phase(15, t_start)
        # 15. JSPSR's execution options, recomputation, prefetch_split:
        # false, coordinate guidance, the r3 config's epoch (profiled:
        # phase 10's profile_steps leg), after every other phase
        options, fitted["profile_steps"], option_paths = options_phase(
            root, tmp / "options", dev, flagship, tmp / "serve" / "scenes",
            smi_line)
        paths.update(option_paths)
        phase(16, t_start)
        # 16. data parallelism: two ranks on this card, the NCCL group of
        # one through the CLI, inference over a mesh naming the card twice
        data_par, dp_paths = data_parallel(root, tmp / "dp", dev, flagship,
                                           tmp / "tiled" / "334", smi_line)
        paths.update(dp_paths)
        phase(17, t_start)
        # 17. the 2-D (data x space) spatially sharded flagship on four
        # ranks sharing the card
        spatial, spatial_paths = spatial_phase(dev, flagship, smi_line)
        paths.update(spatial_paths)
        phase(18, t_start)
        # 18. the flagship's summary and its traced train step and eval
        # forward, in a process of its own
        summary_traced, paths["summary_trace"] = summary_trace(flagship,
                                                               smi_line)
    # K2's and K3's kernels per call and K3's kernel time, under the
    # profiler, after every phase
    k3_counts = bwd_kernels_per_call(
        ((bwd_rows, None), (bwd_bf16_rows, BF16), (slab_bwd_rows, None),
         (slab_bwd_bf16_rows, BF16)), dx_rows)
    tiled["conv_probe"] = probe_rows
    for result in (serving, training, cf_training, cf_serving, tiled,
                   *edsr.values(), *lrru.values()):
        result["card"] = card

    def kernel_line(name, source, replaces, tpu_kernel, rows, main_shape,
                    sources=None):
        """One kernel's entry; with ``sources`` ({dtype: path}) the main
        shape has a row per dtype: the first gives the line's numbers and
        every one its own under ``main_by_dtype``."""
        mains = [r for r in rows if r["shape"] == main_shape]
        main = mains[0]
        by_path = {path: launches.get(name, 0)
                   for path, launches in paths.items()}
        line = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_kernel": tpu_kernel,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "shape": main["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shapes": rows,
        }
        if sources:
            line["main_by_dtype"] = {r["dtype"]: {
                "source": sources[r["dtype"]],
                **{k: r[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "tflops",
                                     "kernel_over_library")}}
                for r in mains}
        return line

    kernels = [
        kernel_line("deform_fwd", "jspsr_torch/ops/csrc/deform_fwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:108",
                    "jspsr_tpu/ops/pallas_deform.py::_fwd_kernel", fwd_rows,
                    [1, 1, 1024, 1024]),
        kernel_line("deform_bwd", "jspsr_torch/ops/csrc/deform_bwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:175",
                    "jspsr_tpu/ops/pallas_deform.py::_bwd_kernel "
                    "(need_dx=False)", bwd_rows, [50, 1, 128, 128]),
        kernel_line("deform_fwd_bf16", "jspsr_torch/ops/csrc/deform_fwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:108",
                    "jspsr_tpu/ops/pallas_deform.py::_fwd_kernel "
                    "(sample_dtype='bfloat16')", fwd_bf16_rows,
                    [50, 1, 128, 128]),
        kernel_line("deform_bwd_bf16", "jspsr_torch/ops/csrc/deform_bwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:175",
                    "jspsr_tpu/ops/pallas_deform.py::_bwd_kernel "
                    "(need_dx=False, sample_dtype='bfloat16')", bwd_bf16_rows,
                    [50, 1, 128, 128]),
        kernel_line("deform_bwd_dx", "jspsr_torch/ops/csrc/deform_bwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:175",
                    "jspsr_tpu/ops/pallas_deform.py::_bwd_kernel "
                    "(need_dx=True, d_x at :227-242)", dx_rows,
                    [16, 1, 128, 128]),
        kernel_line("deform_bwd_dx_bf16",
                    "jspsr_torch/ops/csrc/deform_bwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:175",
                    "jspsr_tpu/ops/pallas_deform.py::_bwd_kernel "
                    "(need_dx=True, sample_dtype='bfloat16')", dx_bf16_rows,
                    [16, 1, 128, 128]),
        kernel_line("deform_fwd_slab", "jspsr_torch/ops/csrc/deform_fwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:108",
                    "jspsr_tpu/ops/pallas_deform.py::_fwd_kernel (a row "
                    "slab of a spatially sharded batch)", slab_fwd_rows,
                    [SPATIAL_FWD[0] // SPATIAL_MESH[0], 1,
                     SPATIAL_FWD[1] // SPATIAL_MESH[1], SPATIAL_FWD[1]]),
        kernel_line("deform_bwd_slab", "jspsr_torch/ops/csrc/deform_bwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:175",
                    "jspsr_tpu/ops/pallas_deform.py::_bwd_kernel "
                    "(need_dx=False, a row slab)", slab_bwd_rows,
                    [SPATIAL_GRAD[0] // SPATIAL_MESH[0], 1,
                     SPATIAL_GRAD[1] // SPATIAL_MESH[1], SPATIAL_GRAD[1]]),
        kernel_line("deform_fwd_bf16_slab",
                    "jspsr_torch/ops/csrc/deform_fwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:108",
                    "jspsr_tpu/ops/pallas_deform.py::_fwd_kernel "
                    "(sample_dtype='bfloat16', a row slab)",
                    slab_fwd_bf16_rows,
                    [SPATIAL_FWD[0] // SPATIAL_MESH[0], 1,
                     SPATIAL_FWD[1] // SPATIAL_MESH[1], SPATIAL_FWD[1]]),
        kernel_line("deform_bwd_bf16_slab",
                    "jspsr_torch/ops/csrc/deform_bwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:175",
                    "jspsr_tpu/ops/pallas_deform.py::_bwd_kernel "
                    "(need_dx=False, sample_dtype='bfloat16', a row slab)",
                    slab_bwd_bf16_rows,
                    [SPATIAL_GRAD[0] // SPATIAL_MESH[0], 1,
                     SPATIAL_GRAD[1] // SPATIAL_MESH[1], SPATIAL_GRAD[1]]),
        kernel_line("deform_bwd_dx_slab",
                    "jspsr_torch/ops/csrc/deform_bwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:175",
                    "jspsr_tpu/ops/pallas_deform.py::_bwd_kernel "
                    "(need_dx=True, d_x at :227-242, a row slab)",
                    slab_dx_rows,
                    [SPATIAL_GRAD[0] // SPATIAL_MESH[0], 1,
                     SPATIAL_GRAD[1] // SPATIAL_MESH[1], SPATIAL_GRAD[1]]),
        kernel_line("deform_bwd_dx_bf16_slab",
                    "jspsr_torch/ops/csrc/deform_bwd.cu",
                    "jspsr_tpu/ops/pallas_deform.py:175",
                    "jspsr_tpu/ops/pallas_deform.py::_bwd_kernel "
                    "(need_dx=True, sample_dtype='bfloat16', a row slab)",
                    slab_dx_bf16_rows,
                    [SPATIAL_GRAD[0] // SPATIAL_MESH[0], 1,
                     SPATIAL_GRAD[1] // SPATIAL_MESH[1], SPATIAL_GRAD[1]]),
        kernel_line("conv_same", "jspsr_torch/ops/csrc/conv_same_bf16.cu",
                    "scripts/bench_pallas_conv.py:38",
                    "scripts/bench_pallas_conv.py::pallas_conv_same",
                    conv_rows, [16, 128, 128, 64, 64, 3], sources={
                        "bfloat16": "jspsr_torch/ops/csrc/conv_same_bf16.cu",
                        "float32": "jspsr_torch/ops/csrc/conv_same_f32.cu"}),
    ]
    kernels[0]["host_us_per_call"] = fwd_host_us
    for line in kernels:
        if line["name"] in k3_counts:
            line["kernels_per_call"] = k3_counts[line["name"]]
    next(k for k in kernels if k["name"] == "deform_bwd_dx_slab")[
        "empty_cases"] = k3_empty
    unlaunched = [k["name"] for k in kernels if not k["launches"]]
    if unlaunched:
        raise AssertionError(f"kernels no main path launched: {unlaunched}")
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"cf_training": cf_training}), flush=True)
    print(json.dumps({"cf_serving": cf_serving}), flush=True)
    print(json.dumps({"tiled_serving": tiled}), flush=True)
    print(json.dumps({"fit": fitted}, default=float), flush=True)
    print(json.dumps({"edsr": edsr}, default=float), flush=True)
    print(json.dumps({"lrru": lrru}, default=float), flush=True)
    print(json.dumps({"bf16": bf16}, default=float), flush=True)
    print(json.dumps({"export": exported}, default=float), flush=True)
    print(json.dumps({"options": options}, default=float), flush=True)
    print(json.dumps({"data_parallel": data_par}, default=float), flush=True)
    print(json.dumps({"spatial": spatial}, default=float), flush=True)
    print(json.dumps({"summary_trace": summary_traced}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
