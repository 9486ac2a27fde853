#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: kernels, main paths, timings.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. device report (``nvidia-smi`` name and power limit, torch / CUDA versions);
2. build: the twelve CUDA C++ sources of ``pti_ldm_vae_tpu_torch/csrc`` with
   nvcc (one process per source, started together, and beside them the
   native TIFF library ``native/ptidata.cpp`` with g++; ``ptxas`` registers and
   spills reported, and none allowed in the two GroupNorm+SiLU libraries,
   the two wide-head flash libraries and the tensor-core convolution's (36
   tile instantiations); for
   the six tensor-core sources also the shared memory per block and the
   resident blocks per SM of every instantiation the path takes, and whether
   their SASS holds ``HGMMA`` (``wgmma``) and ``LDGSTS`` (``cp.async``), read
   with ``cuobjdump`` where the toolkit has it; for the GroupNorm+SiLU cluster
   kernels the cut ``gn_plan`` gives each path shape and the clusters the card
   holds at once);
3. kernel checks at the shapes the main paths give them (GroupNorm+SiLU: the
   8 shapes of a flagship pass at 256², batch 8, ragged (1,7,9,24) and
   (3,17,9,48) with 4 groups, and 32x256²x64, the b32 shape of the widest
   clusters, in bf16; flash attention:
   [8,1,1024,128], a ragged [2,2,1000,64] and [2,1,S,D] for D in 16, 32, 64,
   128 and S in 1024, 200, the backward from the logsumexp the forward wrote;
   the 17 distinct shapes of the 45 calls of a diffusion UNet pass of
   ``config/ldm_dente.json`` at b8 (32 groups, 1 to 16 channels per group,
   32² down to 4²), with the cut ``gn_plan`` gives each in phase 2; the 7
   shapes of a ``config/ar_vae_dente_kl1e3.json`` pass (64-128-256, 32
   groups) at b8 and the flagship's 8 at b1 (PTI's fine-tune);
   flash attention also at the UNet's [8,2,256,32], [8,4,64,32], [8,8,16,32]
   and at head dim 256, [8,1,4096,256] and [1,1,4096,256] (the kl1e3 mid
   blocks; the wide tensor-core kernels in bf16, the f32-FMA kernels in f32,
   whose backward's and forward's tile rows and shared memory are read from
   the libraries, as are the wide kernels' shared memory and blocks per SM);
   then, phase ``flash_head_dims``, at [8,1,1024,96] (zero-padded to 128 by
   the wrapper: the tensor-core kernels in bf16, 12 padded launches),
   [8,1,1024,512] (a [128,256,512,512] VAE's mid block at 256²: the wide
   tensor-core kernels in bf16, the f32-FMA kernels with 32-row forward and
   16-row backward tiles in f32), [2,1,1024,640] and [1,1,512,1024] (above
   512: the wide kernels in bf16, the FMA split kernels in f32), forward and
   backward in both types, with the launches of the wide kernels counted;
   the 3x3 convolution: the 14 distinct shapes of the 47 convolutions of a
   flagship pass, as forward, input gradient and filter gradient, a ragged
   [1,20,12,3->5] (which bf16 must send to the tensor-core kernel through
   zero channels, f32 to the f32-FMA kernel) and a ragged [2,37,70,24->40],
   the AR models' new shapes (Cin 10 of the 10-channel latent and Cin 256 of
   the kl1e3 model, on the tensor-core kernel in bf16 since the 256-channel
   blocks narrowed to 32 output columns and thin channel counts are padded)
   and the flagship's at b1; every bf16 forward and input gradient must take
   the tensor-core kernel; its filter
   gradient ``dW`` is held like ``dscale``; bf16 inputs take the tensor-core
   kernels wherever the wrappers' rules send them there, f32 inputs the FMA
   kernels, forward and backward, and the routes are asserted against the
   rules), every hand-written kernel
   against its plain PyTorch version on the card:
   forward kernels f32 (atol 1e-5, rtol 1e-4) and bf16 (against the plain f32
   version on the same bf16-rounded inputs, atol 2e-2; flash attention also
   the rms of its error within 1e-2 of the reference's rms, ``FLASH_REL_BAR``,
   since its values shrink with S); backward kernels the
   same bars for ``dx``, ``dq``, ``dk``, ``dv``; ``dscale`` / ``dbias`` are
   f32 sums over B*H*W terms of size ~1 (up to 524 288 here), held to rtol
   1e-4 with atol 1e-5 * sqrt(B*H*W) (the rounding of a sum grows with the
   root of its length); every backward, and the flash and convolution
   forward, runs twice and must give the same bits (no float atomics);
4. inference main path: ``pti_ldm_vae_tpu_torch.cli.inference_vae`` on 16
   synthetic 300x300 TIFs at the flagship config
   ``config/vae_dente_no_adv.json`` (256², batch 8) with random weights from a
   seeded ``torch.Generator``, in bf16 (the default) and with ``--f32``; launch
   counts are set to 0 just before a run and read just after (42
   GroupNorm+SiLU forward and 2 flash-attention launches per batch); outputs must be
   16 TIFs and 16 PNGs of finite values, and the f32 reconstructions of two
   images must match the CPU plain-version reconstruction to 1e-3;
5. training main path: ``pti_ldm_vae_tpu_torch.cli.train_vae`` on 72 synthetic
   TIFs at the same config (256², batch 8: 8 train steps and 1 validation
   step per epoch, 2 epochs), in bf16 and with ``--f32``; launch counts per
   train step 42 / 42 / 2 / 2 (GroupNorm+SiLU forward, GroupNorm+SiLU
   backward, flash forward, flash backward), per eval step and per train
   triplet panel 42 / 0 / 2 / 0; finite losses, every parameter tensor
   moved from its seeded init, best/last checkpoints written, the best one
   reloaded through the inference CLI;
6. training reference: one f32 generator step on the card (launch counts of
   exactly one step asserted) against the same step on the CPU plain path
   from the same weights, batch (2 images at 256², full width) and ``eps``:
   loss terms within 1e-4 relative, every gradient tensor within 2e-3 of its
   largest entry;
6a. adversarial training main path: ``cli.train_vae --conv-kernel`` on
   ``config/vae_dente_2.json`` (same architecture, PatchGAN + LSGAN at
   ``adv_weight`` 3.0) with ``adv_warmup_epochs: 0`` for 3 epochs of 8 steps,
   so that epoch 0 runs the warm-up step and epochs 1-2 the adversarial one;
   all six launch counts as computed from the step counts (per adversarial
   or warm-up train step 47 + 46 convolution-kernel launches, forward and
   input gradient, and 47 filter-gradient launches), ``train/adv_disc_loss``
   0 in epoch 0 and > 0 afterwards, finite losses, the discriminator and both
   optimizers in the checkpoints, and a resumed run that continues;
6b. adversarial training reference: one f32 adversarial step (generator
   pass, then the discriminator pass on the detached reconstruction) with
   ``conv_kernel=True`` on the card against the CPU plain path, batch 2 at
   256², full width: loss terms incl. both adversarial ones within 1e-4
   relative; of its largest entry, every gradient tensor of the generator
   without the adversarial term (the convolution kernels' dgrad and wgrad)
   and of the discriminator on one shared reconstruction within 2e-3, and
   every gradient tensor that passes through the discriminator from the two
   sides' own reconstructions within 2e-2 (LeakyReLU kinks: see
   ``adv_train_reference_check``);
6c. latent-diffusion training path: ``cli.train_diffusion`` on a temporary
   config whose ``diffusion_def`` is ``config/ldm_dente.json``'s, with the
   seeded flagship VAE of phase 4 (256² images, 32²x4 latents), 3 epochs of
   2 steps at b8, in bf16 and with ``--f32``; launch counts per step 21 + 45
   GroupNorm+SiLU forward (VAE encode, UNet), 45 backward, 1 + 16 flash
   forward, 16 backward; finite epsilon-MSE; every UNet and projector tensor
   finite and moved (but the 17 whose gradient is 0 in exact arithmetic, see
   ``zero_gradient_tensors``); ``diffusion_last.pth`` written;
6d. sampling path: ``cli.sample_diffusion`` from the bf16 run's checkpoint,
   8 images conditioned on 8 of phase 4's TIFs, 50 DDIM steps, in bf16 and
   ``--f32``: 8 finite TIFs and PNGs, launches 21 + 50*45 + 21
   GroupNorm+SiLU and 1 + 50*16 + 1 flash per batch;
6e. diffusion reference: one UNet forward, one diffusion loss and its
   gradients and a 5-step DDIM run in f32 on the card against the CPU plain
   path, same weights and noise (bars in ``ldm_reference_check``);
6f. AR-VAE training path: ``cli.train_vae`` on ``config/ar_vae_dente.json``
   (the flagship architecture, 10-channel latent, six attributes, divisor
   256) at 256², b8, bf16, on phase 5's 72 TIFs with an attributes JSON the
   script writes, 2 epochs of 8 steps: launch counts, finite
   ``train/ar_loss_*`` on every step and ``val/ar_loss_*`` on every
   validation; ``cli.evaluate_vae`` on its best checkpoint (16 images);
   one f32 AR step (4 images, all 12 ordered pairs) against the CPU plain
   path (terms 1e-4 relative, gradients 2e-3 of each tensor's largest);
6g. kl1e3 path: ``cli.train_vae --conv-kernel`` on
   ``config/ar_vae_dente_kl1e3.json`` at its width (64-128-256, 32 groups,
   flash at head dim 256) with ``adv_warmup_epochs: 0``, bf16, 36 of the
   TIFs (2 epochs of 4 steps at b8); the same checks and the discriminator
   on from epoch 1; one f32 AR step with the convolution kernels at b2
   against the CPU plain path;
6h. PTI path: ``cli.run_pti`` on phase 4's seeded flagship checkpoint at
   256², steps cut from 200 / 100 to 30 / 20: ``--batch-size 8`` (8
   images) in bf16, ``--f32`` and ``--conv-kernel``, ``--batch-size 1`` (2
   images) with ``--save-tuned``, whose autoencoder serves through
   ``inference_vae``; launch counts (encode, stage 1 per batch, stage 2 per
   tuned row, one decode per written image), every output, latent and tune
   losses that fall; then 3 steps of both stages batched over 2 images in
   f32 against the CPU plain path (bars in ``pti_reference_check``);
6i. latent-regression path: seeded mask pairs for phase 5's 72 TIFs,
   ``cli.compute_mask_metrics`` on them, then ``cli.train_regression`` (2
   epochs of 8 steps and 1 validation step, cut from 100),
   ``cli.evaluate_regression`` and ``cli.inference_regression`` (phase 4's
   16 TIFs) on ``config/reg_edente_from_dente.json`` and
   ``config/nreg_edente_from_both.json`` at their width (the frozen flagship
   encoder at 256², f32, the 4096 -> 256 -> 32 -> 6 head, b8; the seeded
   flagship ``.pth`` serves both VAE configs), and a third pass of the first
   with ``--conv-kernel``: launch counts of the encoder passes alone
   (``expected_encoder_launches``; no backward kernel), the VAE's weights
   bit for bit unchanged, ``head_last.pth`` loads, ``target_norm_stats.json``
   for the ``nreg`` config alone, one finite prediction per image;
6j. regression reference: one f32 head train step (b8, one padded row,
   dropout off, every kernel on) and one eval step against the CPU plain
   path (bars in ``regression_reference_check``);
6k. latent-space analysis path: 128 seeded 300² TIFs in each of ``edente/``
   and ``dente/`` (``ID_HA_YEAR_MONTH_PATIENT.tif``, 16 patients shared),
   ``cli.analyze_static --method tsne --color-by-patient`` on both with phase
   4's seeded flagship checkpoint (f32, 256², b8) and a cache under the work
   directory: 21 GroupNorm+SiLU and 1 flash launch per encode batch (32
   batches), no backward, a finite [256, 2] projection, the plot a PNG of the
   stated size, the three text files written; the same with ``--conv-kernel``
   on a fresh cache (22 convolution-kernel launches per batch more); the
   first command again (every latent a cache hit, 0 launches, the same bytes
   and projection); ``cli.analyze_interactive --export --method tsne`` on that
   cache (256 points, ids and paths in input order, 0 launches);
   ``cli.analyze_ar_channels --export`` on phase 6f's AR config and checkpoint
   (42 GroupNorm+SiLU and 2 flash launches, a 10-channel grid PNG); ``--method
   umap`` raising the JAX package's ImportError;
6l. analysis reference: the card's f32 stages against the CPU plain path on
   the same inputs (bars in ``analysis_reference_check``), the card's t-SNE
   run twice to the same bits;
6m. chained configs (``chain_path``): verbatim copies of
   ``config/vae_dente_no_adv.json``, ``config/reg_edente_from_dente.json``
   and ``config/ldm_dente.json`` in a working directory whose ``data/`` holds
   18 seeded TIFs and their attributes at the configs' relative paths;
   ``train_vae`` (flagship, 256², b8, 1 epoch of 2 steps, ``--trace-at-step
   2``), ``train_regression`` (1 epoch) and ``train_diffusion`` (1 epoch of 2
   steps) on ``cuda`` with that directory as the working directory, the
   shipped ``vae.checkpoint`` finding ``autoencoder_last.pth``: wall s and
   launches per CLI, and the step-2 trace naming the port's GroupNorm+SiLU
   and flash kernels, forward and backward;
6n. ``loader_b8``: the data loader on 64 seeded 300² TIFs -> 256², b8, 4
   workers, imgs/s with the native default (64 native decodes required) and
   with the numpy path, in turns; two native runs the same bits; the largest
   native-vs-numpy difference; ``preprocess_batch_device`` card vs CPU on
   [8,300,300,1] f32 (1e-5);
6o. ``s2d_path``: the flagship with ``s2d_stem`` true (the encoder's level 0
   and the decoder's full-resolution tail at 128² with 4x the channels, the
   weights transformed at apply time): its GroupNorm+SiLU shapes (7; new:
   8x128²x256 with 16 groups) and 3x3 convolution shapes (13; new: 4 -> 128
   and 128 -> 4 at 128²) with their ``gn_plan`` cuts and tensor-core tiles,
   checked against the plain versions in both types as in phase 3; the f32
   reconstruct of each form (``"encoder"``, ``"decoder"``, true), cuDNN and
   convolution kernels, against the f32 standard one on the card and the CPU
   plain path's (1e-3); ``inference_vae`` on a copy of the config with
   ``"s2d_stem": true`` in bf16 and bf16 ``--conv-kernel`` (launches as the
   standard pass's, no FMA convolution, the thin calls padded); one f32
   generator step in each form against the standard step on the card (terms
   1e-4 relative, gradients 2e-3 of each tensor's largest entry);
6p. ``remat_path``: the same f32 step with ``remat`` (standard and s2d) against
   the standard step; bf16 steps at b8 with the convolution kernels whose
   gradients with ``remat`` must be the bits of the step without it (cuDNN
   asked for deterministic sums); ``train_vae --remat --s2d-stem encoder
   --conv-kernel`` (18 TIFs: 2 steps and a validation step; its checkpoint
   loads ``strict=True`` into a standard model), ``train_diffusion --remat``
   (1 epoch of 2 steps) and ``run_pti`` b8 ``--conv-kernel`` on a config with
   ``"remat": true``; every launch count computed from the models
   (``remat_extra``: each checkpointed block's forward runs once more in the
   backward) and no FMA convolution;
6q. ``two_pass``: the f32 step with ``norm_stats`` ``"two_pass"`` (plain tensor
   code on the card, counted in ``group_norm_silu.two_pass_calls``: 42 a
   pass, no GroupNorm+SiLU launch) against the one-pass step, the same bars;
6r. ``dims_path``: the flagship's ``autoencoder_def`` at ``spatial_dims`` 3
   (b2 x 64³ seeded volumes) and 1 (b2 x 4096): kernel checks at the rank-4
   views its GroupNorm+SiLU calls hand the kernels and flash at
   [2, 1, 512, 128], both types; the 5-D / 3-D calls the kernels' bits on
   those views; bf16 and f32 reconstructs (42 GroupNorm+SiLU and 2 flash
   launches each); f32 reconstructs against the CPU (1e-3; 3-D at 32³); the
   3-D f32 generator step (L1 + KL + fake-3D LPIPS) and adversarial step (3-D
   PatchGAN) at b2 x 32³ against the CPU (``dims_step_check``);
6s. ``vmap_rules``: each kernel Function's ``torch.func.vmap`` rule (shared
   weights folded into one launch, per-image weights one launch per image),
   forward and ``vmap(grad)``, against a loop over the images; ``pti_vmap``:
   ``cli.run_pti --tune-formulation vmap`` b8, 5 / 3 steps, bf16 / ``--f32`` /
   ``--conv-kernel`` and the ``scan`` form beside it (launch counts, pivots),
   both programs and both stage-2 forms in f32 against each other; timings
   ``dims_b2`` and ``pti_vmap_b8`` in a child (``--dims-timings``);
6t. ``image_comparison_path``: the GT-vs-synthesis suite
   (``analysis.metrics.ImageComparison``) on 16 seeded ``edente`` /
   ``edente_synth`` TIF pairs at 256² (filled ellipses with noise, 12 at
   random angles within +-20 degrees, 4 axis-aligned): kernel checks of the
   convolution at VGG16's 9 distinct shapes (224² x 3 -> 64 down to
   14² x 512 -> 512, both types, forward and backward) and, per shape, how
   many f32 outputs of the kernel differ from cuDNN's (TF32 off); then, with
   TF32 allowed as PyTorch allows it by default (VGG16 turns it off for its
   own convolutions), one image's f32 features on the card (cuDNN), on the
   card with ``conv_kernel=True`` and on the CPU, within 1e-4 of their
   largest magnitude; ``process_all_images`` with ``save_csv`` on the card,
   on the card with the kernel (13 launches a feature vector, 416 in all)
   and on the CPU, each processing 16 of 16 pairs, the metrics of the card
   runs equal to the CPU's (the host's geometry and pixel metrics exactly,
   cosine and Euclidean distance rtol 1e-4) and ``_dimensions.csv`` byte for
   byte; device and event ms of the VGG16 b1 forward (cuDNN, kernel), wall
   seconds a pair and the host's share (each convolution shape's f32
   forward is timed in the timings child of phase 7, path ``vgg16``);
6u. ``profile_port_path``: the flagship trainer at b128 behind the live
   profiler endpoint (``profile_port_path``): the seven rows' kernels against
   their plain versions at the b128 step's largest shapes in bf16
   (GroupNorm+SiLU 128x256²x32, flash [128, 1, 1024, 128], the convolution
   128x256²x32 -> 32, forward and backward); ``train_vae --batch-size 128
   --conv-kernel --profile-port P --max-epochs 2`` as a child process on a
   copy of ``config/vae_dente_no_adv.json`` (data and run directories
   redirected) over 430 seeded 300² TIFs (4 steps an epoch, the last padded
   and masked); two captures through ``utils/profiling.py:capture`` (one
   step, then about two), each trace holding the port's kernels by name in
   whole-step counts and no 3x3 convolution on cuDNN; the run's launch
   counts, finite losses and checkpoint; then, in that child after the run
   (``chip_smoke.py --profile-port-child OUT ARGS``), the b128 bf16 step's
   event / device ms, idle share, imgs/s and peak GB;
7. timing after warm-up, L2 flushed before each call: device time
   (torch.profiler, the sum of the call's kernels) and CUDA-event time (which
   also holds waits for the host) of each kernel, its plain version and the
   one PyTorch library call that computes the same function, at every path
   shape; reconstruct and train-step imgs/s at b8 (event time), device idle
   share and device time by kind of kernel, also with ``conv_kernel=True``
   (and the train step with the adversarial branch active). GroupNorm+SiLU
   bounds count the bytes of the fused kernels: forward x read and y
   written, backward x and g read and dx written. The convolution
   kernels' library call is ``F.conv2d`` on channels-last tensors with TF32
   off, and its backward for one operand. To stay inside the time limit the
   per-kernel timings take 10 iterations and the reconstruct 6. Then the
   GroupNorm+SiLU and flash kernels at the UNet's shapes (bound, plain,
   ``F.group_norm`` + ``F.silu``, SDPA), and at b8 with the trained weights
   the UNet forward, a ``LDM_TIMED_STEPS``-step DDIM loop (steps/s and
   device ms per step) and one diffusion train
   step as the CLI runs it, in bf16 and f32; the AR step of both AR configs
   at b8 bf16 (kl1e3 as its config trains it: adversarial, convolution
   kernels), flash at [8,1,4096,256], [8,1,1024,96], [8,1,1024,512],
   [2,1,1024,640] and [1,1,512,1024] against SDPA (and, where the wide
   tensor-core kernels serve bf16, against the f32-FMA kernels they replaced,
   called through their libraries, in turns), PTI's two stages (latent
   steps/s at b8, tune steps/s at b1) in bf16 and f32; the regression head's
   train step and predict at b8 in f32 and bf16, cuDNN and convolution
   kernels (phase ``regression_b8``); the convolution kernels at the kl1e3
   model's shapes in bf16 (5 timed calls each) and at the AR model's
   10-channel latent, each forward or input gradient that took the f32-FMA
   kernel in bf16 before (``Cin`` above 128 or no multiple of 8) beside that
   kernel, called through its library before and after it, on the same
   inputs; the flagship encode at b8 in
   f32 and bf16, cuDNN and kernels, on a device-resident batch and as
   ``analyze_static`` runs it (host TIFF read and resize included), and the
   projection's PCA-50, kNN + P and 1000 t-SNE iterations on seeded
   [N, 4096] latents at N = 2000 and 6000 with peak memory (``analysis_b8``);
   then, in a process of their own (``chip_smoke.py --knob-timings SPEC
   OUT``, started and waited for by the script: ``timings_child``), the
   apply-time knobs (no claim): the GroupNorm+SiLU and convolution kernels at
   the shapes only a pass with ``s2d_stem`` true has; phase
   ``s2d_b8``: the reconstruct (bf16 cuDNN, bf16 kernels, f32 cuDNN) and the
   generator step (bf16 cuDNN, bf16 kernels) in each s2d form (false,
   ``"encoder"``, ``"decoder"``, true); ``remat_b8``: the generator step with
   and without ``remat`` (bf16, f32), one diffusion step with and without it
   (bf16), event ms, device ms and ``torch.cuda.max_memory_allocated`` GB;
   ``two_pass_b8``: the generator step with two-pass against one-pass
   statistics (bf16, f32);
7b. data parallelism (phase ``ddp_path``, in two processes of their own,
   ``chip_smoke.py --ddp-child SPEC RANK``, started together and waited for:
   ``ddp_child``): (a) rank 0 runs ``train_vae`` bf16 ``--conv-kernel`` on
   the flagship at 256², b8, one epoch of 2 steps, with no group and then
   with the torchrun environment of one rank (``RANK=0 WORLD_SIZE=1
   LOCAL_RANK=0``), from which the CLI starts a one-rank NCCL group: the
   parameters, the logged losses and every kernel's launch count must be
   the same bits; the step's CUDA-event ms with no group, in the group and
   with no group again, and the flagship's gradient all-reduce (4.56 M
   parameters, one flat f32 buffer) under NCCL;
   (b) then both processes start a gloo group of two on the one card and
   call the CLIs' ``main`` with ``--device cuda:0``: ``train_vae`` f32 at
   ``--batch-size 4`` on 10 TIFs (one global step of 8, 2 validation
   images) against one process at b8 with twice the LR (losses within 1e-4
   relative; parameter changes within 2 lr, and within 2e-3 of their
   tensor's largest change on 99% of all entries: an Adam step is about
   ``lr x sign(g)``, and an entry whose gradient is rounding takes either
   sign), one f32 flagship step
   (``make_train_step``) at b4 a rank against b8 in one process (loss terms
   within 1e-4 relative, every gradient tensor within 2e-3 of its largest
   entry), ``sample_diffusion`` (8 images, 5 DDIM steps, f32) and ``run_pti``
   (4 images at b2, f32), whose files together must be the one-process files
   within 1e-4 of their largest entry; rank 0's launches those of the one
   process; a gloo step's ms (correctness only: gloo stages CUDA tensors
   through the host);
7c. spatial and tensor parallelism (phase ``model_parallel_path``, two
   processes of their own, ``chip_smoke.py --mp-child SPEC RANK``:
   ``mp_child``): rank 0 holds the four split GroupNorm+SiLU entries
   (statistics, apply, backward reduce, backward dx) to their plain versions
   at the flagship's per-shard shapes under spatial 2 at 256² b8 ([8, 128,
   256, 32] ... [8, 16, 32, 128]) in both types and times them in bf16
   beside the fused kernels at the unsharded shapes; then one process, and
   two gloo ranks on the one card under ``{"spatial": 2}`` and under
   ``{"tensor": 2}`` (``data`` 1: the same rows on both ranks), run
   ``train_vae`` bf16 ``--conv-kernel`` on copies of
   ``config/vae_dente_no_adv.json`` (2 steps at b8) and
   ``config/vae_dente_2.json`` (one adversarial step), one f32 generator
   and one f32 adversarial step from the same weights, batch and noise, and
   bf16 generator steps at 256² and 512² b8 (the latter under spatial only).
   Checks: the f32 steps' loss terms and parameters at the ``ddp_path``
   bars, the bf16 runs' logged losses within 1e-2 relative, every run's
   launch counts (under spatial the split entries run, as many as the fused
   kernels in one process, and the fused ones not; under tensor the one
   process's counts); it reports each rank's peak GB beside the one process's
   and the steps' CUDA-event ms (correctness only under gloo);
8. the ``kernels`` line (six kernels, covering the seven ``pallas_call``
   sites, and the wide-head flash kernels as two more entries, launched on
   the kl1e3 path; launches by path, the diffusion CLIs' included, and the four
   GroupNorm+SiLU and flash kernels' sums over one UNet pass or diffusion
   step under ``ldm_unet``; the AR, evaluate, kl1e3, PTI, regression and
   analysis runs' launches, the chained CLIs' under ``chain_*``; flash per
   call at head dim 256 under ``kl1e3_d256``, at [8,1,1024,96], 512, 640 and
   1024 under ``d96`` / ``d512`` / ``d640`` / ``d1024``; the
   convolution kernels' sums over one kl1e3 train step under ``kl1e3``, with
   ``fma_ms`` the same step's forward and input-gradient calls as they ran
   before this route, and the FMA and zero-padded launches of the
   convolution-kernel paths, the kl1e3 step's FMA ones 0; the sums over one
   pass or train step with ``s2d_stem`` true under ``s2d``; the launches of
   the knobs' CLI runs and of the data-parallel runs, each rank's), the card
   line, and
   the result line
   ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import copy
import json
import math
import re
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "config" / "vae_dente_no_adv.json"
ADV_CONFIG = ROOT / "config" / "vae_dente_2.json"
WORK = ROOT / "build" / "chip_smoke"

# NVIDIA H100 SXM data sheet (dense): HBM3 bandwidth and peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=0.0, atol=2e-2)
# flash attention in bf16, beside BF16_TOL: rms of the error over rms of the plain f32
# version. Its outputs and gradients shrink with S (rms ~0.026 at S = 4096), so 2e-2 alone
# sits near their size; one bf16 rounding reads ~2.3e-3, a kernel that leaves out one of 64
# tiles ~0.12, the padded head dim's scale at 1000 -> 1024 ~0.016
# (tests/test_torch_flash_wide.py::test_bf16_bar_catches_a_dropped_tile_and_the_padded_scale)
FLASH_REL_BAR = 1e-2
BATCH = 8
N_IMAGES = 16
# GroupNorm+SiLU launches per flagship pass (21 encoder + 21 decoder) and
# flash-attention launches (encoder and decoder mid blocks)
GN_PER_RECONSTRUCT = 42
FLASH_PER_RECONSTRUCT = 2
# training run: 72 images, 0.9 split -> 64 train (8 steps of 8) + 8 val (1 step)
TRAIN_IMAGES = 72
TRAIN_EPOCHS = 2
TRAIN_STEPS_PER_EPOCH = 8
EVAL_STEPS_PER_EPOCH = 1
TRAIN_SEED = 42
GRAD_BAR = 2e-3  # of each gradient tensor's largest entry, card f32 vs CPU f32
ADV_GRAD_BAR = 2e-2  # the same through the discriminator's LeakyReLU kinks (adv_train_reference_check)

# 3x3 stride-1 convolutions per flagship pass (22 encoder + 25 decoder); in a
# train step each also runs its filter gradient, and all but the encoder's
# stem (whose input needs no gradient) the forward kernel once more as dgrad
CONV_PER_RECONSTRUCT = 47
CONV_DGRAD_PER_STEP = 46
ADV_EPOCHS = 3
ADV_RESUME_EPOCHS = 4
RAGGED_CONV = (1, 20, 12, 3, 5)  # Cin 3: zero-padded onto the tensor-core kernel in bf16
RAGGED_CONV_WGMMA = (2, 37, 70, 24, 40)  # Cin 24: the tensor-core kernel in bf16
FLASH_CHECK_SHAPES = ((BATCH, 1, 1024, 128), (2, 2, 1000, 64),
                      *((2, 1, s, d) for d in (16, 32, 64, 128) for s in (1024, 200)))
WGMMA_SOURCES = ("conv3x3_wgmma.cu", "flash_attention_wgmma.cu", "conv3x3_wgrad_wgmma.cu",
                 "flash_attention_bwd_wgmma.cu", "flash_attention_wide_wgmma.cu",
                 "flash_attention_bwd_wide_wgmma.cu")
# the wide-head flash kernels' sources (bf16, head dims above 128)
WIDE_SOURCES = ("flash_attention_wide_wgmma.cu", "flash_attention_bwd_wide_wgmma.cu")
# head dims whose wide kernels' shared memory is read from the libraries
WIDE_HEAD_DIMS = (192, 256, 320, 512, 640, 1024)

KERNEL_NAMES = ("groupnorm_silu", "groupnorm_silu_bwd", "flash_attention", "flash_attention_bwd",
                "conv3x3", "conv3x3_wgrad")
# GroupNorm+SiLU shapes checked beside the path's: (shape, groups)
GN_EXTRA_SHAPES = (((1, 7, 9, 24), 4), ((3, 17, 9, 48), 4))
GN_B32_SHAPE = (32, 256, 256, 64)  # checked in bf16 only

# latent diffusion: config/ldm_dente.json (UNet on the 32²x4 latents of the
# flagship VAE's 256² images, 32 groups, head dim 32, cross-attention dim 512)
LDM_CONFIG = ROOT / "config" / "ldm_dente.json"
LDM_GROUPS = 32
# GroupNorm+SiLU launches per UNet pass (16 down, 4 middle, 24 up, the head's
# norm) and flash-attention launches (6 down, 1 middle, 9 up); a VAE encode or
# decode is half a flagship pass (21 and 1)
GN_PER_UNET = 45
FLASH_PER_UNET = 16
GN_PER_CODER = GN_PER_RECONSTRUCT // 2
FLASH_PER_CODER = FLASH_PER_RECONSTRUCT // 2
LDM_TRAIN_IMAGES = 16  # 2 steps of 8 per epoch
LDM_TRAIN_EPOCHS = 3
LDM_SAMPLE_IMAGES = 8
LDM_SAMPLE_STEPS = 50
LDM_REFERENCE_STEPS = 5  # DDIM steps of the card-vs-CPU check
LDM_EPS_BAR = 1e-3  # UNet output, card f32 vs CPU f32, of its largest entry
LDM_DDIM_BAR = 1e-3  # final DDIM latents, of their largest entry (ldm_reference_check)
LDM_ZERO_GRAD_BAR = 1e-6  # gradients 0 in exact arithmetic, of the largest gradient entry

# kernel launches per pass (encode + decode) of a model: GroupNorm+SiLU, flash
# attention, 3x3 convolutions and their input gradients in a train step (all but
# the encoder's stem)
# "thin" / "thin_dgrad": the forwards / input gradients among them whose Cin is no multiple
# of 8 (the 1-channel stem, the latent's conv_in; the output conv's and conv_out's input
# gradients), which bf16 runs on the tensor-core kernel through zero channels
FLAGSHIP_PASS = {"gn": GN_PER_RECONSTRUCT, "flash": FLASH_PER_RECONSTRUCT,
                 "conv": CONV_PER_RECONSTRUCT, "dgrad": CONV_DGRAD_PER_STEP,
                 "thin": 2, "thin_dgrad": 2}
# AR-VAE: config/ar_vae_dente.json is the flagship architecture with a 10-channel
# latent (six attributes on channels 0-5); config/ar_vae_dente_kl1e3.json the
# 64-128-256 KL-sweep point with 32 groups, whose mid blocks attend over 64²
# tokens with one head of 256 channels (flash at head dim 256)
AR_CONFIG = ROOT / "config" / "ar_vae_dente.json"
KL1E3_CONFIG = ROOT / "config" / "ar_vae_dente_kl1e3.json"
AR_ATTRIBUTES = ("height_0", "width_0", "width_1", "width_2", "width_3", "width_4")
KL1E3_PASS = {"gn": 34, "flash": 2, "conv": 38, "dgrad": 37, "thin": 2, "thin_dgrad": 2}
KL1E3_GROUPS = 32
KL1E3_SUBSET = 36  # images: 32 train (4 steps of 8) and 4 validation (1 step)
KL1E3_STEPS_PER_EPOCH = 4
AR_REFERENCE_IMAGES = 4  # the f32 AR step against the CPU: 12 ordered pairs
KL1E3_REFERENCE_IMAGES = 2  # the same for the kl1e3 model, at 256², full width
FLASH_D256_SHAPES = ((BATCH, 1, 4096, 256), (1, 1, 4096, 256))
# PTI on the seeded flagship checkpoint: steps cut from the CLI's 200 / 100
PTI_LATENT_STEPS = 30
PTI_TUNE_STEPS = 20
PTI_B1_IMAGES = 2
PTI_REFERENCE_STEPS = 3  # of both stages, card f32 against the CPU
PTI_TIMED_STEPS = 10
PTI_PIVOT_BAR = 1e-3  # of the pivots' largest entry
PTI_TUNED_BAR = 2e-3  # of each tuned tensor's largest change
IMAGE = 256  # the configs' patch size, the side of every image of the AR and PTI phases
# one encoder and one decoder half of a flagship pass (conv: with conv_kernel)
ENCODER_PASS = {"gn": GN_PER_CODER, "flash": FLASH_PER_CODER, "conv": 22}
DECODER_PASS = {"gn": GN_PER_CODER, "flash": FLASH_PER_CODER, "conv": 25}
# latent regression: config/reg_edente_from_dente.json (raw targets) and
# config/nreg_edente_from_both.json (standard-normalized), the frozen flagship
# encoder at 256² (the seeded checkpoint serves both VAE configs, which share
# its architecture) and the configs' head, 4096 -> 256 -> 32 -> 6, at b8; the
# CLIs encode in f32. Training on phase 5's 72 TIFs: 64 train (8 steps) and 8
# validation images (1 step) an epoch; evaluation and inference on phase 4's 16
REG_CONFIGS = ("reg_edente_from_dente", "nreg_edente_from_both")
REG_TARGETS = AR_ATTRIBUTES
REG_EPOCHS = 2  # cut from the configs' 100
REG_FLAT = 4096
REG_LR = 1e-4
REG_PRED_BAR = 1e-3  # eval predictions, card f32 vs CPU f32, of their largest entry
# latent-space analysis: two groups (edente, dente) of seeded 300² TIFs named
# ID_HA_YEAR_MONTH_PATIENT.tif, 16 patients shared by both; the analysis CLIs
# encode with the frozen flagship encoder at 256² in f32, b8 (32 batches a run)
ANALYSIS_IMAGES = 128  # per group
ANALYSIS_PATIENTS = 16
ANALYSIS_PERPLEXITY = 30  # the CLIs' default
ANALYSIS_LATENT_BAR = 1e-4  # card f32 vs CPU f32, of the largest entry
ANALYSIS_PCA_BAR = 1e-4
ANALYSIS_P_BAR = 1e-5
ANALYSIS_KL_BAR = 0.01  # KL(P || Q) of the card's embedding, relative to the CPU's
ANALYSIS_TRUST_BAR = 0.01  # trustworthiness (5 neighbours), absolute
PROJECTION_SIZES = (2000, 6000)  # analyze_static's and analyze_interactive's 2 x --max-images
# flash attention at head dims the kernels pad (96 -> 128, the tensor-core kernels in bf16),
# 512 (a [128, 256, 512, 512] VAE's mid block at 256²) and above 512 (640, 1024: the wide
# tensor-core kernels in bf16, the FMA split kernels in f32)
FLASH_HEAD_DIM_SHAPES = ((BATCH, 1, 1024, 96), (BATCH, 1, 1024, 512), (2, 1, 1024, 640),
                         (1, 1, 512, 1024))
# the shipped configs chained as they are: 16 train images (2 steps of b8) and 2 validation
CHAIN_CONFIGS = ("vae_dente_no_adv", "reg_edente_from_dente", "ldm_dente")
CHAIN_IMAGES = 18
CHAIN_TRACE_KERNELS = ("groupnorm_silu_fwd_kernel", "groupnorm_silu_bwd_kernel",
                       "flash_fwd_wgmma_kernel", "flash_bwd_wgmma_kernel")
LOADER_IMAGES = 64
LOADER_WORKERS = 4  # the CLIs' default --num-workers
PREPROCESS_BAR = 1e-5  # preprocess_batch_device, card f32 vs CPU f32
# time_ldm's DDIM loop (the sampling CLI keeps LDM_SAMPLE_STEPS): at 50 steps this
# host-bound phase alone took 144-180 s of the script
LDM_TIMED_STEPS = 5
# the apply-time knobs (ops/space_to_depth.py, remat, two-pass statistics)
S2D_FORMS = (False, "encoder", "decoder", True)
KNOB_TRAIN_SUBSET = 18  # 16 train images (2 steps of 8) and 2 validation images (1 step)
KNOB_LDM_EPOCHS = 1
KNOB_ITERS = 4  # calls of each knob A/B timed by CUDA events
# data parallelism (ddp_path): the flagship config at 256², 16 train images (2 steps of a
# global batch of 8) and 2 validation images; sampling 8 images over 5 DDIM steps, PTI on 4
# images at b2 (steps cut from 200 / 100); the config's LR
DDP_IMAGES = 18
DDP_STEPS = 2
# (b)'s train_vae: 8 train images (one step of a global batch of 8: after one Adam step an entry
# has moved by about lr x sign(g), which a rounding difference does not amplify) and 2 validation
DDP_B_IMAGES = 10
DDP_B_SPLIT = 0.8
DDP_LR = 2.5e-5
DDP_DDIM_STEPS = 5
DDP_PTI_IMAGES = 4
DDP_PTI_STEPS = (5, 3)
DDP_ITERS = 10  # train steps timed by CUDA events
DDP_LOSS_BAR = 1e-4  # relative: 2 gloo ranks at b4 against one process at b8, f32
DDP_PARAM_BAR = 2e-3  # of each parameter tensor's largest change (the train-step bar)
DDP_PARAM_SHARE = 0.99  # of all parameter entries (see ddp_compare)
DDP_FILE_BAR = 1e-4  # sampled images and PTI outputs, of their largest entry, f32
DDP_TIMEOUT_S = 480
# phase model_parallel_path: two gloo ranks on the one card, spatial 2 and tensor 2
MP_MODEL = 2
MP_GROUPS = 16  # the flagship's norm_num_groups
MP_IMAGES = 18  # 16 train images (2 steps of 8) and 2 validation images
MP_ADV_IMAGES = 10  # with DDP_B_SPLIT: 8 train images, one adversarial step
MP_LR = 2.5e-5
# train_vae runs (bf16, the convolution kernels): config, extra flags, steps
MP_RUNS = {"no_adv": (CONFIG, ["--conv-kernel"], 2), "adv": (ADV_CONFIG, ["--conv-kernel"], 1)}
MP_SPLIT_ENTRIES = ("groupnorm_silu_split_stats", "groupnorm_silu_split_apply",
                    "groupnorm_silu_split_bwd_reduce", "groupnorm_silu_split_bwd_dx")
MP_STEP_SIDES = (256, 512)  # bf16 train steps: peak GB per rank against one process
MP_STEP_ITERS = 2
MP_TIMED_ITERS = 5
# a bf16 run's logged losses against one process's, relative: one bf16 rounding is 2^-8
MP_BF16_LOSS_BAR = 1e-2
MP_TIMEOUT_S = 600
# phase dims_path: the flagship's widths at spatial_dims 3 and 1
DIMS_BATCH = 2
DIMS_SIDE = 64  # b2 x 64³ volumes (latent 8³: the mid blocks' 512 tokens)
DIMS_REF_SIDE = 32  # card f32 against the CPU at 32³ (the 3-layer PatchGAN's floor)
DIMS_SIGNAL = 4096  # the 1-D model's b2 x 4096 signal (latent 512)
DIMS_FLASH_SHAPE = (DIMS_BATCH, 1, 512, 128)
# phase pti_vmap: run_pti --tune-formulation vmap, (latent, tune) steps
PTI_VMAP_STEPS = (5, 3)


def expected_launches(train_steps: int, forward_only: int, conv_kernel: bool,
                      per_pass: dict[str, int] = FLAGSHIP_PASS) -> dict[str, int]:
    """Launch counts of a run of ``train_steps`` train steps and
    ``forward_only`` forward passes (eval steps, triplet panels, reconstructs)
    of a model with ``per_pass`` launches a pass (the flagship's by default)."""
    passes = train_steps + forward_only
    conv = per_pass["conv"] * passes + per_pass["dgrad"] * train_steps if conv_kernel else 0
    return {
        "groupnorm_silu": per_pass["gn"] * passes,
        "groupnorm_silu_bwd": per_pass["gn"] * train_steps,
        "flash_attention": per_pass["flash"] * passes,
        "flash_attention_bwd": per_pass["flash"] * train_steps,
        "conv3x3": conv,
        "conv3x3_wgrad": per_pass["conv"] * train_steps if conv_kernel else 0,
    }


def expected_conv_shares(train_steps: int, forward_only: int,
                         per_pass: dict[str, int] = FLAGSHIP_PASS) -> dict[str, int]:
    """The shares of the convolution's forward-kernel launches in a bf16 run
    with the convolution kernels (``expected_launches``' steps and passes):
    none on the FMA kernel, the thin channel counts' on zero-padded ones."""
    return {"fma": 0,
            "padded": per_pass["thin"] * (train_steps + forward_only)
            + per_pass["thin_dgrad"] * train_steps}


def conv_shares(kernels_mod) -> dict[str, int]:
    """Launches of the convolution's forward kernel since the last reset that
    went to the FMA kernel and to the tensor-core kernel on zero-padded
    channels (shares of ``conv3x3``'s count)."""
    conv = kernels_mod.conv3x3
    return {"fma": conv.fma_launches, "padded": conv.padded_launches}


def expected_pti_launches(encodes: int, latent_steps: int, tune_steps: int, written: int,
                          conv_kernel: bool, flash_tune_steps: int | None = None) -> dict[str, int]:
    """Launch counts of PTI on the flagship: ``encodes`` encoder passes (the
    initial latents of each batch), ``latent_steps`` decoder passes with the
    input gradient (stage 1, summed over batches), ``tune_steps`` decoder
    passes with both gradients (stage 2, summed over the tuned rows), and one
    decoder pass per ``written`` image. Every decoder convolution needs its
    input gradient in both stages (z, then ``post_quant_conv``'s output,
    require it); only stage 2 takes filter gradients. ``flash_tune_steps``:
    stage 2's flash launches where they are not one per tuned row and step
    (the ``vmap`` form folds the images of a step into one launch, while its
    GroupNorm+SiLU and convolutions, with a weight per image, launch once per
    image as the ``scan`` form's do)."""
    backward = latent_steps + tune_steps
    decodes = backward + written
    flash_tune = tune_steps if flash_tune_steps is None else flash_tune_steps
    flash_backward = latent_steps + flash_tune
    conv = (ENCODER_PASS["conv"] * encodes + DECODER_PASS["conv"] * (decodes + backward)
            if conv_kernel else 0)
    return {
        "groupnorm_silu": ENCODER_PASS["gn"] * encodes + DECODER_PASS["gn"] * decodes,
        "groupnorm_silu_bwd": DECODER_PASS["gn"] * backward,
        "flash_attention": ENCODER_PASS["flash"] * encodes
        + DECODER_PASS["flash"] * (flash_backward + written),
        "flash_attention_bwd": DECODER_PASS["flash"] * flash_backward,
        "conv3x3": conv,
        "conv3x3_wgrad": DECODER_PASS["conv"] * tune_steps if conv_kernel else 0,
    }


def expected_ldm_launches(train_steps: int, sample_batches: int) -> dict[str, int]:
    """Launch counts of ``train_steps`` diffusion train steps (a VAE encode,
    then the UNet forward and backward) and ``sample_batches`` sampled
    batches (a VAE encode of the conditions, ``LDM_SAMPLE_STEPS`` UNet passes,
    a VAE decode)."""
    sample_steps = LDM_SAMPLE_STEPS
    return {
        "groupnorm_silu": (GN_PER_CODER + GN_PER_UNET) * train_steps
        + (2 * GN_PER_CODER + sample_steps * GN_PER_UNET) * sample_batches,
        "groupnorm_silu_bwd": GN_PER_UNET * train_steps,
        "flash_attention": (FLASH_PER_CODER + FLASH_PER_UNET) * train_steps
        + (2 * FLASH_PER_CODER + sample_steps * FLASH_PER_UNET) * sample_batches,
        "flash_attention_bwd": FLASH_PER_UNET * train_steps,
        "conv3x3": 0,
        "conv3x3_wgrad": 0,
    }


def expected_encoder_launches(encodes: int, conv_kernel: bool) -> dict[str, int]:
    """Launch counts of ``encodes`` frozen encoder passes (the regression
    CLIs' train, validation, evaluation and inference batches, the analysis
    CLIs' encode batches): forward kernels only, since the head's gradient
    stops at the latent and the analysis encodes under inference mode."""
    return {
        "groupnorm_silu": ENCODER_PASS["gn"] * encodes,
        "groupnorm_silu_bwd": 0,
        "flash_attention": ENCODER_PASS["flash"] * encodes,
        "flash_attention_bwd": 0,
        "conv3x3": ENCODER_PASS["conv"] * encodes if conv_kernel else 0,
        "conv3x3_wgrad": 0,
    }


def remat_extra(model, conv_kernel: bool = False) -> dict[str, int]:
    """Forward launches that ``remat`` adds to one backward through ``model``:
    every checkpointed block (the VAE's ResBlocks and attention blocks, the
    UNet's TimeResBlocks and SpatialTransformers) runs its forward once more,
    whole (no early stop): two GroupNorm+SiLU (and, with the convolution
    kernels, two 3x3 convolutions) a ResBlock, one flash attention an
    attention block (whose own GroupNorm has no SiLU: plain tensor code)."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import ResBlock, SpatialAttentionBlock
    from pti_ldm_vae_tpu_torch.models.unet import SpatialTransformer, TimeResBlock

    mods = list(model.modules())
    n_res = sum(isinstance(m, ResBlock) for m in mods)
    n_time_res = sum(isinstance(m, TimeResBlock) for m in mods)
    n_attn = sum(isinstance(m, (SpatialAttentionBlock, SpatialTransformer)) for m in mods)
    return {"groupnorm_silu": 2 * (n_res + n_time_res), "flash_attention": n_attn,
            "conv3x3": 2 * n_res if conv_kernel else 0}


def plus(launches: dict[str, int], extra: dict[str, int], times: int) -> dict[str, int]:
    """``launches`` with ``times`` x ``extra`` added."""
    return {k: v + times * extra.get(k, 0) for k, v in launches.items()}


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One compact JSON line per phase; ``t``: seconds since the script started."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0, 1), **fields},
                     separators=(",", ":")), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def dtype_key(dtype) -> str:
    return str(dtype).split(".")[1]


def _kernel_times_us(prof) -> dict[str, float]:
    """Device time (us) by kernel name in a profile, the L2 flush's fill kernel left out."""
    from torch.autograd import DeviceType

    out: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and "FillFunctor" not in evt.name:
            out[evt.name] = out.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    return out


def time_ms(fn, flush, iters: int = 10, warmup: int = 3, trace_iters: int | None = None) -> dict:
    """Per call of ``fn()``, each after an L2 flush (a 128 MB write):
    ``device_ms``, the summed device time of its kernels (torch.profiler,
    device activity only, over ``trace_iters`` calls, ``iters`` by default),
    ``event_ms``, CUDA-event time from
    before its first launch to after its last over ``iters`` calls, which also
    holds any wait for the host to launch, and ``by_name``, the device ms of
    each kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    traced = trace_iters or iters
    for _ in range(5):  # a trace now and then comes back without its device events: take it again
        # the device's activity alone: host op events would go unread, and building them
        # takes most of a traced train step's seconds
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(traced):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        by_name = {name: us / 1e3 / traced for name, us in _kernel_times_us(prof).items()}
        if by_name:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device kernel in five traces")
    return {"device_ms": sum(by_name.values()), "event_ms": total / iters, "by_name": by_name}


def named_ms(by_name: dict[str, float], *words: str) -> float:
    return sum(ms for name, ms in by_name.items() if any(w in name for w in words))


def check_close(name: str, got, want, tol: dict) -> float:
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), **tol, msg=lambda m: f"{name}: {m}")
    return err


def check_flash(name: str, got, want, dtype) -> tuple[float, float]:
    """A flash kernel's output or gradient against the plain f32 version: f32
    at ``F32_TOL``; bf16 at ``BF16_TOL`` and ``FLASH_REL_BAR``. Returns (max
    abs error, rms error over the reference's rms)."""
    import torch

    err = check_close(name, got, want, F32_TOL if dtype == torch.float32 else BF16_TOL)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    if dtype == torch.bfloat16 and not rel <= FLASH_REL_BAR:
        raise RuntimeError(f"{name}: rms error {rel:.3e} of the reference's, bar {FLASH_REL_BAR}")
    return err, rel


def gn_path_shapes(model, torch) -> list[tuple[tuple[int, ...], int]]:
    """[(NHWC shape at batch 8, launches per pass)] of every GroupNorm+SiLU of
    a flagship pass, recorded with forward hooks during one CPU reconstruct of
    a single 256² image (plain versions, no launch)."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import GroupNormOp

    counts: dict[tuple[int, ...], int] = {}

    def hook(module, args):
        if module.silu:
            shape = (BATCH, *args[0].shape[1:])
            counts[shape] = counts.get(shape, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, GroupNormOp)]
    try:
        with torch.inference_mode():
            model.reconstruct_deterministic(torch.zeros(1, 256, 256, 1))
    finally:
        for h in handles:
            h.remove()
    return sorted(counts.items(), key=lambda kv: -kv[0][1] * kv[0][2] * kv[0][3])


def conv_path_shapes(model, torch) -> list[tuple[tuple[int, ...], int]]:
    """[((B, H, W, Cin, Cout) at batch 8, launches per pass)] of every 3x3
    convolution a ``conv_kernel=True`` flagship pass sends to the convolution
    kernel, recorded like ``gn_path_shapes``."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import Convolution

    counts: dict[tuple[int, ...], int] = {}

    def hook(module, args):
        if module.conv_kernel:
            # in the space-to-depth domain the input has 4x the channels and so has the output
            phases = args[0].shape[-1] // module.conv.in_channels
            shape = (BATCH, *args[0].shape[1:], module.conv.out_channels * phases)
            counts[shape] = counts.get(shape, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, Convolution)]
    try:
        with torch.inference_mode():
            model.reconstruct_deterministic(torch.zeros(1, 256, 256, 1))
    finally:
        for h in handles:
            h.remove()
    return sorted(counts.items(), key=lambda kv: -kv[0][1] * kv[0][2] * kv[0][3] * kv[0][4])


# kinds of device kernels, first match wins (lower-cased kernel names)
KINDS = (
    ("conv3x3_wgrad", ("conv3x3_wgrad_kernel", "conv3x3_wgrad_wgmma_kernel")),
    ("conv3x3", ("conv3x3_kernel", "conv3x3_wgmma_kernel", "conv3x3_stream_wgmma_kernel")),
    ("groupnorm_silu_fwd", ("groupnorm_silu_fwd_kernel",)),
    ("groupnorm_silu_bwd", ("groupnorm_silu_bwd_kernel",)),
    ("flash_attention_fwd", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel", "flash_fwd_wide_kernel",
                             "flash_fwd_split_kernel")),
    ("flash_attention_bwd", ("flash_bwd_",)),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("pool", ("max_pool",)),  # LPIPS trunk
    ("conv_wgrad", ("wgrad",)),
    ("conv_dgrad", ("dgrad",)),
    # cuDNN's implicit-GEMM, FFT and layout kernels of the convolutions
    ("conv_fwd", ("conv", "fprop", "implicit", "cudnn", "nhwc", "nchw", "fft",
                  "pointwise_mult_and_sum_complex")),
    ("gemm", ("gemm", "cutlass", "nvjet")),  # the attention block's projections
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel", "catarray", "fill")),
)


def device_ms_by_kind(by_name: dict[str, float]) -> dict:
    out: dict = {}
    other: dict[str, float] = {}
    for name, ms in by_name.items():
        kind = next((k for k, keys in KINDS if any(w in name.lower() for w in keys)), "other")
        out[kind] = out.get(kind, 0.0) + ms
        if kind == "other":
            other[name[:90]] = ms
    out["top_other"] = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    return out


def bound(flops: float, dtype: str, nbytes: float) -> tuple[float, str]:
    """Least time in ms: the larger of the operations over the card's peak for
    their type and the bytes over its memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOP_PER_S[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ptxas_report(log: Path) -> dict:
    """Registers and spills of every kernel in an nvcc ``-Xptxas -v`` log (per
    kernel: the entry-function line, the spill line, then the register line)."""
    kernels, name, spill = [], None, 0
    for line in log.read_text().splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            kernels.append({"kernel": name, "registers": int(m.group(1)), "spill_bytes": spill})
            name = None
    def short(name: str) -> str:
        # kernel name and template arguments (element type, integers) out of the mangled name
        if m := re.search(r"\d((?:flash|conv3x3|groupnorm)\w*?_kernel)I(13__nv_bfloat16|f)?((?:L[ib]\d+E)*)E",
                          name):
            kind = {"13__nv_bfloat16": ["bf16"], "f": ["f32"], None: []}[m.group(2)]
            return f"{m.group(1)}<{','.join(kind + re.findall(r'L[ib](\d+)E', m.group(3)))}>"
        return re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f_]+", "", name)[:60]

    return {"kernels": len(kernels),
            "each": {short(k["kernel"]): [k["registers"], k["spill_bytes"]] for k in kernels},
            "max_registers": max((k["registers"] for k in kernels), default=0),
            "spill_bytes": sum(k["spill_bytes"] for k in kernels),
            # the instantiations the main paths run in bf16: head dim 128
            "d128_bf16": [{"kernel": short(k["kernel"]),
                           "registers": k["registers"], "spill_bytes": k["spill_bytes"]}
                          for k in kernels if "Li128E" in k["kernel"] and "bfloat16" in k["kernel"]],
            # head dim 256 (the kl1e3 mid blocks) on the f32-FMA flash kernels (f32, and the
            # bf16 yardstick of the timings)
            "d256": [{"kernel": short(k["kernel"]),
                      "registers": k["registers"], "spill_bytes": k["spill_bytes"]}
                     for k in kernels if "Li256E" in k["kernel"]],
            # the wide-head flash kernels (bf16 above head dim 128; <1>: A operands whole)
            # and the f32-FMA split kernels (above 512)
            "wide": [{"kernel": short(k["kernel"]),
                      "registers": k["registers"], "spill_bytes": k["spill_bytes"]}
                     for k in kernels if "_wide_kernel" in k["kernel"] or "_split_kernel" in k["kernel"]]}


def wgmma_occupancy(torch, shapes) -> dict:
    """Shared memory per block (bytes) and resident blocks per SM, as the CUDA
    runtime reports them for this card, of the tensor-core convolution kernel
    at the tile each of ``shapes`` (forward and, with the channels swapped,
    input gradient) takes, with the tiles, the persistent blocks and the tiles
    per block that follow (the streamed-weight kernel's one tile where the
    shape takes it); of the tensor-core filter gradient at the tile and
    slab count each shape takes; and of every flash-attention instantiation,
    forward and backward, the wide-head kernels at ``WIDE_HEAD_DIMS`` held to
    the wrapper's formulas and to a block's 232,448 bytes."""
    import ctypes

    from pti_ldm_vae_tpu_torch.ops.kernels import _build
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import forward_kernel as conv_forward_kernel
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import (
        stream_smem_bytes,
        wgmma_smem_bytes,
        wgmma_tile,
        wgrad_kernel,
        wgrad_warpgroups,
        wgrad_wgmma_slabs,
        wgrad_wgmma_smem_bytes,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
        bwd_wgmma_smem_bytes,
        wide_bwd_smem_bytes,
        wide_fwd_smem_bytes,
        wide_smem_of_library,
    )

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    out: dict = {}
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    conv = _build.load("conv3x3_wgmma.cu")
    # the tiles the paths' shapes take (Cin sizes the weight slab, kc the halo ring; a thin Cin
    # is padded with zero channels to a multiple of 8 first)
    for shape in shapes:
        b, h, w, cin, cout = shape
        route = conv_forward_kernel(torch.bfloat16, cin, cout)
        if route == "fma":
            raise RuntimeError(f"conv3x3 {shape}: bf16 does not take the tensor-core kernel")
        if route == "wgmma_stream":  # one fixed tile, one block per SM
            err = _build.load("conv3x3_stream_wgmma.cu").conv3x3_stream_wgmma_occupancy(
                ctypes.byref(smem), ctypes.byref(blocks))
            if err != 0 or smem.value != stream_smem_bytes() or blocks.value < 1:
                raise RuntimeError(f"conv3x3_stream_wgmma_occupancy: CUDA error {err}, "
                                   f"{smem.value} bytes against {stream_smem_bytes()}")
            out[f"conv3x3_stream_wgmma {list(shape)}"] = {
                "smem_bytes": smem.value, "blocks_per_sm": blocks.value}
            continue
        cin = -(-cin // 8) * 8
        mt, tn, kc = wgmma_tile(b, h, w, cin, cout, n_sm)
        err = conv.conv3x3_wgmma_occupancy(mt, tn, kc, cin, ctypes.byref(smem), ctypes.byref(blocks))
        if err != 0 or smem.value != wgmma_smem_bytes(cin, mt, tn, kc):
            raise RuntimeError(f"conv3x3_wgmma_occupancy({mt}, {tn}, {kc}, {cin}): CUDA error {err}, "
                               f"{smem.value} bytes against {wgmma_smem_bytes(cin, mt, tn, kc)}")
        tiles = b * -(-h // 8) * -(-w // (8 * mt))
        groups = -(-cout // tn)
        # the launch's persistent grid: the resident blocks shared out over the N-groups
        resident = min(tiles, max(1, blocks.value * n_sm // groups)) * groups
        out[f"conv3x3_wgmma {list(shape)}"] = {
            "cin": cin, "mt": mt, "tn": tn, "kc": kc, "smem_bytes": smem.value,
            "blocks_per_sm": blocks.value,
            "tiles": tiles * groups, "blocks": resident,
            "tiles_per_block": round(tiles * groups / resident, 2)}
    wgrad = _build.load("conv3x3_wgrad_wgmma.cu")
    for shape in shapes:
        b, h, w, cin, cout = shape
        if wgrad_kernel(torch.bfloat16, cin, cout) != "wgmma":
            continue
        wg = wgrad_warpgroups(cout)
        err = wgrad.conv3x3_wgrad_wgmma_occupancy(wg, ctypes.byref(smem), ctypes.byref(blocks))
        if err != 0 or smem.value != wgrad_wgmma_smem_bytes(wg):
            raise RuntimeError(f"conv3x3_wgrad_wgmma_occupancy({wg}): CUDA error {err}, {smem.value} "
                               f"bytes against {wgrad_wgmma_smem_bytes(wg)}")
        n_slab = wgrad_wgmma_slabs(shape, wg, n_sm)
        groups = -(-cin // 64) * -(-cout // (32 * wg))
        out[f"conv3x3_wgrad_wgmma {list(shape)}"] = {
            "warpgroups": wg, "smem_bytes": smem.value, "blocks_per_sm": blocks.value,
            "slabs": n_slab, "blocks": n_slab * groups,
            "partial_bytes_per_input_byte": round(
                n_slab * 9 * cin * cout * 4 / (b * h * w * (cin + cout) * 2), 3)}
    for source, fn in (("flash_attention_wgmma.cu", "flash_attention_wgmma_occupancy"),
                       ("flash_attention_bwd_wgmma.cu", "flash_attention_bwd_wgmma_occupancy")):
        lib = _build.load(source)
        for d in (16, 32, 64, 128):
            err = getattr(lib, fn)(d, ctypes.byref(smem), ctypes.byref(blocks))
            if err != 0 or ("bwd" in fn and smem.value != bwd_wgmma_smem_bytes(d)):
                raise RuntimeError(f"{fn}({d}): CUDA error {err}, {smem.value} bytes")
            out[f"{source.removesuffix('.cu')} d{d}"] = {"smem_bytes": smem.value,
                                                         "blocks_per_sm": blocks.value}
    for d in WIDE_HEAD_DIMS:  # the wide kernels, held to the wrapper's formulas
        got = wide_smem_of_library(d)
        want = {"forward": wide_fwd_smem_bytes(d), "backward": wide_bwd_smem_bytes(d)}
        for kind, (nbytes, per_sm) in got.items():
            if nbytes != want[kind] or nbytes > 232_448 or per_sm < 1:
                raise RuntimeError(f"wide flash {kind} at d{d}: {nbytes} bytes, {per_sm} blocks per SM, "
                                   f"formula {want[kind]}")
            source = WIDE_SOURCES[kind == "backward"]
            out[f"{source.removesuffix('.cu')} d{d}"] = {"smem_bytes": nbytes, "blocks_per_sm": per_sm}
    return out


def flash_fma_bwd_smem() -> dict:
    """Tile rows and shared memory (bytes) of the f32-FMA flash backward's dk/dv
    and dq kernels and of the f32-FMA forward at every head dim (and at 640
    and 1024, the split kernels), as the libraries report them, held to the
    wrapper's formulas (``bwd_fma_smem_bytes``, ``fwd_fma_smem_bytes``) and to
    a block's 232,448 bytes."""
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
        SUPPORTED_HEAD_DIMS,
        bwd_fma_smem_bytes,
        bwd_fma_smem_of_library,
        bwd_fma_tile,
        fwd_fma_smem_bytes,
        fwd_fma_smem_of_library,
        fwd_fma_tile,
    )

    out = {}
    for d in (*SUPPORTED_HEAD_DIMS, 640, 1024):
        got = bwd_fma_smem_of_library(d)
        if got != (bwd_fma_tile(d), *bwd_fma_smem_bytes(d)) or max(got[1:]) > 232_448:
            raise RuntimeError(f"flash_attention_bwd_smem({d}): {got}")
        fwd = fwd_fma_smem_of_library(d)
        if fwd != (fwd_fma_tile(d), fwd_fma_smem_bytes(d)) or fwd[1] > 232_448:
            raise RuntimeError(f"flash_attention_fwd_smem({d}): {fwd}")
        out[f"d{d}"] = {"tile_rows": got[0], "dkdv_smem_bytes": got[1], "dq_smem_bytes": got[2],
                        "fwd_tile_rows": fwd[0], "fwd_smem_bytes": fwd[1]}
    return out


def gn_plans(torch, cases) -> dict:
    """The cut ``gn_plan`` gives each GroupNorm+SiLU (shape, groups), forward
    and backward, in both types, with the clusters of that cut the card holds
    at once (``cudaOccupancyMaxActiveClusters``) and the blocks of one call."""
    from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import (
        _BWD_SOURCE,
        _DTYPE_CODES,
        _FWD_SOURCE,
        gn_plan,
        max_active_clusters,
    )

    out = {}
    for shape, groups in cases:
        b, h, w, c = shape
        for dtype in (torch.bfloat16, torch.float32):
            for kind, source in (("fwd", _FWD_SOURCE), ("bwd", _BWD_SOURCE)):
                plan = gn_plan(b, h, w, c, groups, dtype, kind == "bwd")
                out[f"{kind} {list(shape)} g{groups} {dtype_key(dtype)}"] = {
                    **plan._asdict(), "blocks": b * (c // plan.slice_channels) * plan.cluster_size,
                    "clusters_resident": max_active_clusters(
                        source, _DTYPE_CODES[dtype], plan.vec, plan.cluster_size, plan.threads,
                        plan.smem_bytes)}
    return out


def sass_report(libs: list[Path]) -> dict:
    """Whether each tensor-core library's SASS holds ``HGMMA`` (wgmma) and
    ``LDGSTS`` (cp.async) instructions, counted with ``cuobjdump -sass``; says
    so where the toolkit has no ``cuobjdump``."""
    import os

    tool = shutil.which("cuobjdump")
    if tool is None:
        candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
        tool = str(candidate) if candidate.exists() else None
    if tool is None:
        return {"cuobjdump": None, "note": "no cuobjdump on this machine: SASS not read"}
    out: dict = {"cuobjdump": tool}
    for lib in libs:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        counts = {word: sass.count(word) for word in ("HGMMA", "LDGSTS", "UTMALDG")}
        if not counts["HGMMA"] or not counts["LDGSTS"]:
            raise RuntimeError(f"{lib.name}: SASS holds no HGMMA or no LDGSTS: {counts}")
        out[lib.name] = counts
    return out


def conv_inputs(torch, shape, gen, balanced: bool = False):
    """f32 ``x``, weight matrix and upstream gradient of a convolution shape,
    scaled so that outputs and input gradients are of size ~1: the matrix by
    (9*Cin)^-0.5 as an initializer would, the gradient by (Cin/Cout)^0.5.

    That holds on average over channels. An input-gradient channel sums only
    9*Cout weights, so with Cout 1 one channel's variance can reach ~3 and
    its largest values ~9, where one bf16 rounding of the output (2^-5) is
    above the bf16 bar. ``balanced`` (the AR and PTI paths' shapes) rescales
    the squared matrix alternately by rows and columns (Sinkhorn) until every
    output channel of the forward and of the input gradient has variance 1;
    ``check_kernels`` then also checks the filter gradient from the upstream
    gradient scaled back to variance 1, since dW's bar counts terms of size
    ~1 (with Cin > Cout the input gradient's scaling makes them larger)."""
    b, h, w, cin, cout = shape
    x = torch.randn(b, h, w, cin, device="cuda", generator=gen)
    wmat = torch.randn(9 * cin, cout, device="cuda", generator=gen) * (9 * cin) ** -0.5
    g = torch.randn(b, h, w, cout, device="cuda", generator=gen) * (cin / cout) ** 0.5
    if balanced:
        w3 = wmat.reshape(9, cin, cout)
        for _ in range(50):  # forward channel o: sum of w^2 is 1; dgrad channel c: cout / cin
            w3 = w3 * w3.square().sum(dim=(0, 1), keepdim=True).rsqrt()
            w3 = w3 * (w3.square().sum(dim=(0, 2), keepdim=True) * cin / cout).rsqrt()
        wmat = w3.reshape(9 * cin, cout).contiguous()
    return x, wmat, g


def check_kernels(torch, gn_cases, flash_shapes, conv_shapes, kernels_mod, *, seed: int = 0,
                  ragged: bool = True, balanced: bool = False, dtypes: tuple = (),
                  phase: str = "kernel_checks") -> dict[str, dict]:
    """Every kernel against its plain version (phase 3): GroupNorm+SiLU at
    ``gn_cases`` [(shape, groups, dtypes)], flash attention at
    ``flash_shapes``, the convolution at ``conv_shapes`` and, with
    ``ragged``, the two ragged ones, flash and convolution in ``dtypes``
    (f32 and bf16 when empty); inputs drawn in that order from a
    generator seeded with ``seed`` (``balanced``: see ``conv_inputs``);
    returns the largest error per kernel and type (and, under
    ``"bfloat16_rel"``, flash attention's largest rms error over the
    reference's rms in bf16)."""
    from pti_ldm_vae_tpu_torch.ops.kernels import (
        conv3x3_bwd_plain,
        conv3x3_plain,
        flash_attention_bwd_plain,
        flash_attention_plain,
        groupnorm_silu_bwd_plain,
        groupnorm_silu_plain,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import forward_kernel as conv_forward_kernel
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import wgrad_kernel
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
        backward_kernel as flash_backward_kernel,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
        forward_kernel as flash_forward_kernel,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import padded_head_dim
    from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _plain_forward, gn_plan

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtypes = dtypes or (torch.float32, torch.bfloat16)
    errs = {name: {"float32": 0.0, "bfloat16": 0.0, "bfloat16_rel": 0.0} for name in KERNEL_NAMES}
    routes: dict[str, dict] = {"groupnorm_silu": {}, "flash_attention": {},
                               "flash_attention_bwd": {}, "conv3x3": {}, "conv3x3_wgrad": {}}

    def note(name, key, err):
        errs[name][key] = max(errs[name][key], err)

    for shape, groups, dtypes in gn_cases:
        b, h, w, c = shape
        x = torch.randn(shape, device="cuda", generator=gen)
        scale = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
        g = torch.randn(shape, device="cuda", generator=gen)
        sum_tol = dict(rtol=1e-4, atol=1e-5 * (b * h * w) ** 0.5)
        for dtype in dtypes:
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            key, tag = dtype_key(dtype), f"{shape} {dtype_key(dtype)}"
            xd, gd = x.to(dtype), g.to(dtype)
            fwd, bwd = (gn_plan(b, h, w, c, groups, dtype, backward) for backward in (False, True))
            if fwd.vec * xd.element_size() != 16 or bwd.vec != fwd.vec:  # the 16-byte route
                raise RuntimeError(f"groupnorm_silu {tag}: plans {fwd}, {bwd}")
            routes["groupnorm_silu"][tag] = [list(fwd), list(bwd)]
            kernels_mod.reset_launch_counts()
            got = kernels_mod.groupnorm_silu(xd, scale, bias, groups, 1e-6)
            if not torch.equal(got, kernels_mod.groupnorm_silu(xd, scale, bias, groups, 1e-6)):
                raise RuntimeError(f"groupnorm_silu forward {tag}: two runs differ")
            want, mean_g, inv_g = _plain_forward(xd.float(), scale, bias, groups, 1e-6)
            note("groupnorm_silu", key, check_close(f"groupnorm_silu {tag}", got, want, tol))
            del got, want

            leaves = (xd.clone().requires_grad_(), scale.clone().requires_grad_(),
                      bias.clone().requires_grad_())
            grads = [torch.autograd.grad(kernels_mod.groupnorm_silu(*leaves, groups, 1e-6), leaves, gd)
                     for _ in range(2)]
            counts = kernels_mod.launch_counts()
            if (counts["groupnorm_silu"], counts["groupnorm_silu_bwd"]) != (4, 2):
                raise RuntimeError(f"groupnorm_silu {tag}: launches {counts}, one per call expected")
            for first, second in zip(*grads):
                if not torch.equal(first, second):
                    raise RuntimeError(f"groupnorm_silu backward {tag}: two runs differ")
            dx, dscale, dbias = grads[0]
            want_dx, want_dscale, want_dbias = groupnorm_silu_bwd_plain(
                xd.float(), scale, bias, mean_g, inv_g, gd.float(), groups)
            note("groupnorm_silu_bwd", key, max(
                check_close(f"groupnorm_silu dx {tag}", dx, want_dx, tol),
                check_close(f"groupnorm_silu dscale {tag}", dscale, want_dscale, sum_tol),
                check_close(f"groupnorm_silu dbias {tag}", dbias, want_dbias, sum_tol)))
            del grads, dx, want_dx, leaves, xd, gd
        del x, g
    torch.cuda.empty_cache()

    def note_flash(name, key, errors):
        note(name, key, max(e for e, _ in errors))
        if key == "bfloat16":
            note(name, "bfloat16_rel", max(r for _, r in errors))

    for shape in flash_shapes:
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen) for _ in range(4))
        for dtype in dtypes:
            key, tag = dtype_key(dtype), f"{shape} {dtype_key(dtype)}"
            qd, kd, vd, gd = q.to(dtype), k.to(dtype), v.to(dtype), g.to(dtype)
            # a head dim the route is not built for runs padded to the next one it takes
            d_pad = padded_head_dim(shape[-1], dtype)
            routes["flash_attention"][tag] = flash_forward_kernel(dtype, d_pad)
            routes["flash_attention_bwd"][tag] = flash_backward_kernel(dtype, d_pad)
            got = kernels_mod.flash_attention(qd, kd, vd)
            if not torch.equal(got, kernels_mod.flash_attention(qd, kd, vd)):
                raise RuntimeError(f"flash_attention forward {tag}: two runs differ")
            want = flash_attention_plain(qd.float(), kd.float(), vd.float())
            note_flash("flash_attention", key, [check_flash(f"flash_attention {tag}", got, want,
                                                            dtype)])

            leaves = tuple(t.clone().requires_grad_() for t in (qd, kd, vd))
            grads = [torch.autograd.grad(kernels_mod.flash_attention(*leaves), leaves, gd)
                     for _ in range(2)]
            for first, second in zip(*grads):
                if not torch.equal(first, second):
                    raise RuntimeError(f"flash_attention backward {tag}: two runs differ")
            want = flash_attention_bwd_plain(qd.float(), kd.float(), vd.float(), gd.float())
            note_flash("flash_attention_bwd", key, [
                check_flash(f"flash_attention {name} {tag}", ours, theirs, dtype)
                for name, ours, theirs in zip(("dq", "dk", "dv"), grads[0], want)])
    ragged_conv = [RAGGED_CONV, RAGGED_CONV_WGMMA] if ragged else []
    for shape in [s for s, _ in conv_shapes] + ragged_conv:
        x, wmat, g = conv_inputs(torch, shape, gen, balanced)
        sum_tol = dict(rtol=1e-4, atol=1e-5 * (shape[0] * shape[1] * shape[2]) ** 0.5)
        for dtype in dtypes:
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            key, tag = dtype_key(dtype), f"{shape} {dtype_key(dtype)}"
            xd, gd = x.to(dtype), g.to(dtype)
            wd = wmat.to(dtype).float()  # the matrix as the kernels see it
            # which kernel the forward and the input gradient (Cout in Cin's place) take
            routes["conv3x3"][tag] = [conv_forward_kernel(dtype, shape[3], shape[4]),
                                      conv_forward_kernel(dtype, shape[4], shape[3])]
            # every bf16 shape on the tensor cores (a thin or ragged Cin, RAGGED_CONV's 3 and 5
            # too, through zero channels up to 8), streaming the weights where the padded Cin is
            # above 176 and Cout at least 64; every f32 one on the FMA kernel
            want_route = (["fma", "fma"] if dtype == torch.float32 else
                          ["wgmma_stream" if -(-c_in // 8) * 8 > 176 and c_out >= 64 else "wgmma"
                           for c_in, c_out in ((shape[3], shape[4]), (shape[4], shape[3]))])
            if routes["conv3x3"][tag] != want_route:
                raise RuntimeError(f"conv3x3 {tag} went to {routes['conv3x3'][tag]}")
            routes["conv3x3_wgrad"][tag] = wgrad_kernel(dtype, shape[3], shape[4])
            got = kernels_mod.conv3x3(xd, wmat)
            if not torch.equal(got, kernels_mod.conv3x3(xd, wmat)):
                raise RuntimeError(f"conv3x3 forward {tag}: two runs differ")
            want = conv3x3_plain(xd.float(), wd)
            err_fwd = check_close(f"conv3x3 {tag}", got, want, tol)
            del got, want

            leaves = (xd.clone().requires_grad_(), wmat.clone().requires_grad_())
            grads = [torch.autograd.grad(kernels_mod.conv3x3(*leaves), leaves, gd) for _ in range(2)]
            for first, second in zip(*grads):
                if not torch.equal(first, second):
                    raise RuntimeError(f"conv3x3 backward {tag}: two runs differ")
            dx, dw = grads[0]
            want_dx, want_dw = conv3x3_bwd_plain(xd.float(), wd, gd.float())
            note("conv3x3", key, max(err_fwd, check_close(f"conv3x3 dgrad {tag}", dx, want_dx, tol)))
            if balanced:  # dW's bar counts terms x*g of size ~1: a unit-size upstream gradient
                gd = (g * (shape[4] / shape[3]) ** 0.5).to(dtype)
                dw = torch.autograd.grad(kernels_mod.conv3x3(*leaves), leaves[1], gd)[0]
                want_dw = conv3x3_bwd_plain(xd.float(), wd, gd.float())[1]
            note("conv3x3_wgrad", key, check_close(f"conv3x3 wgrad {tag}", dw, want_dw, sum_tol))
            del grads, dx, dw, want_dx, want_dw, leaves
        del x, wmat, g
    torch.cuda.empty_cache()
    if ragged and routes["conv3x3"][f"{RAGGED_CONV} bfloat16"] != ["wgmma", "wgmma"]:
        raise RuntimeError("the ragged 3 -> 5 convolution did not take the tensor-core kernel")
    # any S: bf16 on wgmma up to head dim 128 and on the wide wgmma kernels above; f32 on the
    # FMA kernels
    def flash_rule(tag: str) -> str:
        if "bfloat16" not in tag:
            return "fma"
        return "wgmma" if int(tag.split(")")[0].split(",")[-1]) <= 128 else "wgmma_wide"

    for name in ("flash_attention", "flash_attention_bwd"):
        want_route = {tag: flash_rule(tag) for tag in routes[name]}
        if routes[name] != want_route:
            raise RuntimeError(f"{name} routes: {routes[name]}")
    if ragged and routes["flash_attention_bwd"][f"{(2, 2, 1000, 64)} bfloat16"] != "wgmma":
        raise RuntimeError("the ragged flash backward did not take the tensor-core kernel")
    # filter gradient: every bf16 shape on wgmma (the thin ones, the four of the path and
    # RAGGED_CONV, through zero channels up to 8), every f32 one on the FMA kernel
    for tag, route in routes["conv3x3_wgrad"].items():
        if route != ("wgmma" if "bfloat16" in tag else "fma"):
            raise RuntimeError(f"conv3x3_wgrad {tag} went to {route}")
    emit(phase, ok=True, max_abs_err=errs, backward_bit_identical=True,
         forward_bit_identical=True, kernel_routes=routes, seed=seed,
         gn_shapes=[[list(s), n] for s, n, _ in gn_cases],
         flash_shapes=[list(s) for s in flash_shapes],
         conv_shapes=[[list(s), n] for s, n in conv_shapes] + [[list(s), 0] for s in ragged_conv],
         tolerance={"float32": F32_TOL, "bfloat16": BF16_TOL,
                    "flash_bfloat16_rms_of_reference": FLASH_REL_BAR,
                    "dscale_dbias_dW": "rtol 1e-4, atol 1e-5*sqrt(B*H*W)"})
    return errs


def make_weights(torch, ae_def: dict, path: Path) -> None:
    """Random flagship weights from a seeded generator, saved as a MONAI-keyed
    .pth: LeCun-normal conv/dense weights, small random biases and norm
    affines (so every parameter matters to the output)."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

    gen = torch.Generator().manual_seed(1234)
    sd = autoencoder_from_config(ae_def).state_dict()
    for key, p in sd.items():
        noise = torch.randn(p.shape, generator=gen)
        if p.dim() > 1:  # conv and dense weights
            sd[key] = noise * p[0].numel() ** -0.5
        elif key.endswith("weight"):  # GroupNorm scales, the only 1-D weights
            sd[key] = 1.0 + 0.1 * noise
        else:
            sd[key] = 0.1 * noise
    torch.save(sd, path)


def write_inputs(np, data_dir: Path, n: int) -> None:
    from pti_ldm_vae_tpu_torch.data.io import write_tif

    data_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:300, 0:300]
    for i in range(n):
        img = (np.sin(xx / (9.0 + i)) * np.cos(yy / (13.0 + i)) + 1.5
               + 0.2 * rng.normal(size=(300, 300))).astype(np.float32)
        img[: 20 + i % 40] = 0.0  # background, as the mask-aware normalization expects
        write_tif(str(data_dir / f"dente_{i:03d}.tif"), img)


def run_cli(torch, np, kernels_mod, args: list[str], out: Path, n_images: int = N_IMAGES) -> dict:
    from pti_ldm_vae_tpu_torch.cli.inference_vae import main as inference_main
    from pti_ldm_vae_tpu_torch.data.io import read_image

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    n = inference_main(args + ["--output-dir", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels_mod.launch_counts()
    want = expected_launches(0, -(-n_images // BATCH), "--conv-kernel" in args)
    if n != n_images or launches != want:
        raise RuntimeError(f"inference path: {n} images, launches {launches}, expected {want}")
    tifs = sorted((out / "results_tif").glob("*.tif"))
    pngs = sorted((out / "results_png").glob("*.png"))
    if len(tifs) != n_images or len(pngs) != n_images:
        raise RuntimeError(f"expected {n_images} TIFs and PNGs, got {len(tifs)} and {len(pngs)}")
    recon = [read_image(str(p))[:, 256:] for p in tifs]
    for p, r in zip(tifs, recon):
        if r.shape != (256, 256) or not np.isfinite(r).all():
            raise RuntimeError(f"{p.name}: bad reconstruction {r.shape}")
    return {"wall_s": wall, "launches": launches, "recon": recon}


def run_train_cli(torch, np, kernels_mod, ae_def: dict, data_dir: Path, run_dir: Path,
                  extra: list[str]) -> dict:
    """The training entry point for 2 epochs at the flagship config, with the
    launch counts, the losses, the parameters and the checkpoints checked."""
    from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_main
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

    cfg = json.loads(CONFIG.read_text())
    cfg["data_base_dir"], cfg["run_dir"] = str(data_dir), str(run_dir)
    cfg_path = run_dir.parent / f"{run_dir.name}.json"
    cfg_path.write_text(json.dumps(cfg))

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_main(["-c", str(cfg_path), "--max-epochs", str(TRAIN_EPOCHS), "--no-wandb",
                         "--num-workers", "4", "--seed", str(TRAIN_SEED), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels_mod.launch_counts()
    train_steps = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
    # forward-only passes: the eval steps and one train triplet panel per epoch
    forward_only = TRAIN_EPOCHS * (EVAL_STEPS_PER_EPOCH + 1)
    want = expected_launches(train_steps, forward_only, conv_kernel=False)
    if result["total_step"] != train_steps or launches != want:
        raise RuntimeError(f"training path: {result}, launches {launches}, expected {want}")

    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss_total" in r]
    val_rows = [r for r in rows if "val/loss_total" in r]
    if len(train_rows) != train_steps or len(val_rows) != TRAIN_EPOCHS:
        raise RuntimeError(f"metrics.jsonl: {len(train_rows)} train rows, {len(val_rows)} val rows")
    for r in train_rows + val_rows:
        bad = [k for k, v in r.items() if k.startswith(("train/", "val/")) and not np.isfinite(v)]
        if bad:
            raise RuntimeError(f"non-finite losses {bad} in {r}")
    split = json.loads((run_dir / "splits" / "vae_split.json").read_text())
    if len(split["train_files"]) != TRAIN_STEPS_PER_EPOCH * BATCH or len(split["val_files"]) != BATCH:
        raise RuntimeError("unexpected train/val split")

    weights = run_dir / "trained_weights"
    full = sorted(weights.glob("checkpoint_epoch*.pth"))
    best = sorted(weights.glob("autoencoder_epoch*.pth"))
    if len(full) != 1 or len(best) != 1 or not (weights / "autoencoder_last.pth").exists():
        raise RuntimeError(f"checkpoints: {sorted(p.name for p in weights.iterdir())}")
    last = torch.load(weights / "autoencoder_last.pth", map_location="cpu", weights_only=True)
    torch.manual_seed(TRAIN_SEED)  # the trainer's own seeding of the parameter init
    init = autoencoder_from_config(ae_def).state_dict()
    stuck = [k for k, v in last.items() if not torch.isfinite(v).all() or torch.equal(v, init[k])]
    if set(last) != set(init) or stuck:
        raise RuntimeError(f"parameters not finite or not moved from their init: {stuck[:5]}")
    run_config = json.loads((run_dir / "run_config.json").read_text())
    return {
        "wall_s": wall, "launches": launches, "total_step": result["total_step"],
        "best_val_loss": result["best_val_loss"],
        "first_train": {k: v for k, v in train_rows[0].items() if k.startswith("train/")},
        "last_train": {k: v for k, v in train_rows[-1].items() if k.startswith("train/")},
        "val": [{k: v for k, v in r.items() if k.startswith("val/")} for r in val_rows],
        "perceptual_pretrained": run_config["perceptual_pretrained"],
        "checkpoints": sorted(p.name for p in weights.iterdir()),
        "best_checkpoint": str(best[0]),
    }


def train_reference_check(torch, np, kernels_mod, ae_def: dict, data_dir: Path) -> None:
    """One f32 generator step (losses and gradients) on the card against the
    CPU plain path, same weights, batch and eps; also the launch counts of
    exactly one train step and one eval step."""
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, _generator_losses, make_eval_step

    torch.manual_seed(7)
    cpu_model = autoencoder_from_config(ae_def)
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", memory_format=torch.channels_last)
    lcfg = LossConfig(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0)
    images = torch.from_numpy(np.stack([
        preprocess_image_np(read_image(str(p)), (256, 256))
        for p in sorted(data_dir.glob("*.tif"))[:2]]))
    mask = torch.ones(2)
    eps = torch.randn(2, 32, 32, ae_def["latent_channels"], generator=torch.Generator().manual_seed(8))

    def one(model, device):
        lp = init_lpips_params(0, device)
        total, aux = _generator_losses(model, lcfg, lp, images.to(device), mask.to(device),
                                       eps.to(device), None)
        total.backward()
        terms = {k: float(aux[k].detach()) for k in ("recon_loss", "kl_loss", "perceptual_loss")}
        terms["loss_total"] = float(total.detach())
        return terms, {k: p.grad.detach().cpu() for k, p in model.named_parameters()}

    kernels_mod.reset_launch_counts()
    got_terms, got_grads = one(gpu_model, "cuda")
    torch.cuda.synchronize()
    per_train_step = kernels_mod.launch_counts()
    want = expected_launches(1, 0, conv_kernel=False)
    if per_train_step != want:
        raise RuntimeError(f"one train step launched {per_train_step}, expected {want}")
    kernels_mod.reset_launch_counts()
    make_eval_step(gpu_model, None, lcfg, adv_active=False)(
        None, images.cuda(), mask.cuda(), None, init_lpips_params(0, "cuda"), eps=eps.cuda())
    per_eval_step = kernels_mod.launch_counts()
    want_eval = expected_launches(0, 1, conv_kernel=False)
    if per_eval_step != want_eval:
        raise RuntimeError(f"one eval step launched {per_eval_step}, expected {want_eval}")

    want_terms, want_grads = one(cpu_model, "cpu")
    term_err = {k: abs(got_terms[k] - v) / abs(v) for k, v in want_terms.items()}
    grad_err = {}
    for key, ref in want_grads.items():
        scale = float(ref.abs().max())
        err = float((got_grads[key] - ref).abs().max())
        # a key projection's bias has gradient 0 in exact arithmetic (softmax is
        # invariant to a constant along the keys): both sides hold rounding noise
        grad_err[key] = err if key.endswith("to_k.bias") else err / scale
    worst = max(grad_err, key=grad_err.get)
    emit("train_reference", batch=2, terms_card=got_terms, terms_cpu=want_terms,
         max_term_rel_err=max(term_err.values()), term_bar=1e-4,
         max_grad_err_of_tensor_max=grad_err[worst], worst_tensor=worst, grad_bar=GRAD_BAR,
         launches_per_train_step=per_train_step, launches_per_eval_step=per_eval_step)
    if not max(term_err.values()) <= 1e-4:
        raise RuntimeError(f"f32 CUDA loss terms differ from the CPU plain path: {term_err}")
    if not grad_err[worst] <= GRAD_BAR:
        raise RuntimeError(f"f32 CUDA gradient {worst} differs from the CPU plain path by "
                           f"{grad_err[worst]} of its largest entry")


def run_adv_train_cli(torch, np, kernels_mod, data_dir: Path, run_dir: Path) -> dict:
    """The training entry point on the adversarial flagship config with the
    convolution kernels: 3 epochs with ``adv_warmup_epochs: 0``, so epoch 0
    runs the warm-up step and epochs 1-2 the adversarial one; then a resumed
    run to epoch 4. Launch counts, losses and checkpoints are checked."""
    from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_main

    cfg = json.loads(ADV_CONFIG.read_text())
    cfg["data_base_dir"], cfg["run_dir"] = str(data_dir), str(run_dir)
    cfg["autoencoder_train"]["adv_warmup_epochs"] = 0
    cfg_path = run_dir.parent / f"{run_dir.name}.json"
    cfg_path.write_text(json.dumps(cfg))
    cli = ["--no-wandb", "--num-workers", "4", "--seed", str(TRAIN_SEED), "--conv-kernel"]

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_main(["-c", str(cfg_path), "--max-epochs", str(ADV_EPOCHS), *cli])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shares = kernels_mod.launch_counts(), conv_shares(kernels_mod)
    train_steps = ADV_EPOCHS * TRAIN_STEPS_PER_EPOCH
    want = expected_launches(train_steps, ADV_EPOCHS * (EVAL_STEPS_PER_EPOCH + 1), conv_kernel=True)
    want_shares = expected_conv_shares(train_steps, ADV_EPOCHS * (EVAL_STEPS_PER_EPOCH + 1))
    if (result["total_step"] != train_steps or launches != want or not all(launches.values())
            or shares != want_shares):
        raise RuntimeError(f"adversarial path: {result}, launches {launches}, expected {want}; "
                           f"convolution FMA / padded launches {shares}, expected {want_shares}")

    def rows_of(kind: str) -> list[dict]:
        lines = (run_dir / "metrics.jsonl").read_text().splitlines()
        return [r for r in map(json.loads, lines) if f"{kind}/loss_total" in r]

    train_rows, val_rows = rows_of("train"), rows_of("val")
    if len(train_rows) != train_steps or len(val_rows) != ADV_EPOCHS:
        raise RuntimeError(f"metrics.jsonl: {len(train_rows)} train rows, {len(val_rows)} val rows")
    for r in train_rows + val_rows:
        bad = [k for k, v in r.items() if k.startswith(("train/", "val/")) and not np.isfinite(v)]
        if bad:
            raise RuntimeError(f"non-finite losses {bad} in {r}")
    warm, active = train_rows[:TRAIN_STEPS_PER_EPOCH], train_rows[TRAIN_STEPS_PER_EPOCH:]
    if any(r["train/adv_disc_loss"] != 0.0 or r["train/adv_gen_loss"] != 0.0 for r in warm):
        raise RuntimeError("the adversarial terms are not 0 during the warm-up epoch")
    if not all(r["train/adv_disc_loss"] > 0.0 and r["train/adv_gen_loss"] > 0.0 for r in active):
        raise RuntimeError("the adversarial terms are not > 0 once the branch is active")
    if val_rows[0]["val/adv_disc_loss"] != 0.0 or not val_rows[-1]["val/adv_disc_loss"] > 0.0:
        raise RuntimeError(f"val/adv_disc_loss: {[r['val/adv_disc_loss'] for r in val_rows]}")

    weights = run_dir / "trained_weights"
    full = sorted(weights.glob("checkpoint_epoch*.pth"))
    names = sorted(p.name for p in weights.iterdir())
    if len(full) != 1 or not {"autoencoder_last.pth", "discriminator_last.pth"} <= set(names):
        raise RuntimeError(f"checkpoints: {names}")
    raw = torch.load(full[0], map_location="cpu", weights_only=True)
    need = {"autoencoder_state_dict", "discriminator_state_dict", "optimizer_g_state_dict",
            "optimizer_d_state_dict", "epoch", "best_val_loss", "total_step"}
    if not need <= set(raw) or f"discriminator_epoch{raw['epoch']}.pth" not in names:
        raise RuntimeError(f"full checkpoint holds {sorted(raw)}; files {names}")
    last_d = torch.load(weights / "discriminator_last.pth", map_location="cpu", weights_only=True)
    if not all(torch.isfinite(v).all() for v in last_d.values()):
        raise RuntimeError("discriminator_last.pth holds non-finite values")

    # resume: continues at the best epoch + 1 from both models and both optimizers
    cfg["resume_ckpt"] = True
    cfg_path.write_text(json.dumps(cfg))
    resumed = train_main(["-c", str(cfg_path), "--max-epochs", str(ADV_RESUME_EPOCHS), *cli])
    torch.cuda.synchronize()
    new_rows = rows_of("train")[train_steps:]
    first_step = TRAIN_STEPS_PER_EPOCH * (raw["epoch"] + 1) + 1
    if (resumed["total_step"] != ADV_RESUME_EPOCHS * TRAIN_STEPS_PER_EPOCH
            or not new_rows or new_rows[0]["train/step"] != first_step
            or not all(np.isfinite(r["train/loss_total"]) for r in new_rows)):
        raise RuntimeError(f"resume: {resumed}, first new step "
                           f"{new_rows[0]['train/step'] if new_rows else None}, expected {first_step}")
    adv_terms = ("train/adv_gen_loss", "train/adv_disc_loss", "train/loss_total")
    return {
        "wall_s": wall, "launches": launches, "conv_shares": shares,
        "total_step": result["total_step"],
        "best_val_loss": result["best_val_loss"],
        "first_warmup": {k: warm[0][k] for k in adv_terms},
        "first_adversarial": {k: active[0][k] for k in adv_terms},
        "last_adversarial": {k: active[-1][k] for k in adv_terms},
        "val_adv_disc_loss": [r["val/adv_disc_loss"] for r in val_rows],
        "checkpoints": names, "resumed_from_epoch": raw["epoch"],
        "resumed_total_step": resumed["total_step"],
    }


def adv_train_reference_check(torch, np, kernels_mod, ae_def: dict, data_dir: Path,
                              weights: Path) -> None:
    """One f32 adversarial step (generator pass, discriminator pass; losses
    and gradients of both models) with the convolution kernels on the card
    against the CPU plain path, same weights, batch and eps; also the launch
    counts of its one forward and two backward passes through the generator
    (the adversarial term's share is taken apart by a backward of its own).
    The generator starts from the seeded
    variance-preserving weights of ``make_weights`` (a default-initialized
    decoder draws nearly flat images, whose spatial variance after the
    discriminator's first layers falls below the instance norm's eps).

    Bars. Loss terms: 1e-4 relative. Gradients, each tensor against its
    largest entry: the generator's gradient of everything but the adversarial
    term, which runs through the convolution kernels' dgrad and wgrad, and
    the discriminator's gradients on one and the same reconstruction: 2e-3.
    Whatever passes through the discriminator from a reconstruction that
    differs in f32 rounding (2e-5 here) is held to 2e-2: a LeakyReLU unit
    whose pre-activation lies within that difference takes the other slope
    on one side, and a share p of such units moves a gradient by about
    sqrt(p) of its size (5e-3 to 8e-3 measured, with cuDNN convolutions in
    the generator as with the kernels)."""
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, _discriminator_loss, _generator_losses

    cpu_model = autoencoder_from_config(ae_def, conv_kernel=True)
    cpu_model.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True), strict=True)
    # the trainer's own init: instance norm keeps the logits of size ~1
    cpu_disc = PatchDiscriminator(generator=torch.Generator().manual_seed(10))
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", memory_format=torch.channels_last)
    gpu_disc = copy.deepcopy(cpu_disc).to(device="cuda", memory_format=torch.channels_last)
    lcfg = LossConfig(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0, adv_weight=3.0)
    images = torch.from_numpy(np.stack([
        preprocess_image_np(read_image(str(p)), (256, 256))
        for p in sorted(data_dir.glob("*.tif"))[:2]]))
    mask = torch.ones(2)
    eps = torch.randn(2, 32, 32, ae_def["latent_channels"], generator=torch.Generator().manual_seed(11))

    def disc_grads(disc, recon, x, m):
        d_loss = _discriminator_loss(disc, recon, x, m)
        grads = torch.autograd.grad(lcfg.adv_weight * d_loss, list(disc.parameters()))
        return d_loss.detach(), {k: g.cpu() for (k, _), g in zip(disc.named_parameters(), grads)}

    def one(model, disc, device, shared_recon):
        lp = init_lpips_params(0, device)
        x, m = images.to(device), mask.to(device)
        params = list(model.parameters())
        total, aux = _generator_losses(model, lcfg, lp, x, m, eps.to(device), None, disc)
        # the adversarial term's share apart, then the whole objective
        adv_part = torch.autograd.grad(aux["adv_gen_loss"], params, retain_graph=True)
        whole = torch.autograd.grad(total, params)
        d_loss, d_grads = disc_grads(disc, aux["recon"], x, m)
        terms = {k: float(aux[k].detach()) for k in
                 ("recon_loss", "kl_loss", "perceptual_loss", "adv_gen_loss")}
        terms.update(loss_total=float(total.detach()), adv_disc_loss=float(d_loss))
        names = [k for k, _ in model.named_parameters()]
        grads = {
            "generator": {k: g.cpu() for k, g in zip(names, whole)},
            "generator_without_adversary": {k: (g - lcfg.adv_weight * a).cpu()
                                            for k, g, a in zip(names, whole, adv_part)},
            "discriminator": d_grads,
            "discriminator_on_shared_reconstruction": disc_grads(
                disc, (aux["recon"].detach() if shared_recon is None else shared_recon).to(device),
                x, m)[1],
        }
        return terms, grads, aux["recon"].detach().cpu()

    want_terms, want_grads, cpu_recon = one(cpu_model, cpu_disc, "cpu", None)
    kernels_mod.reset_launch_counts()
    got_terms, got_grads, gpu_recon = one(gpu_model, gpu_disc, "cuda", cpu_recon)
    torch.cuda.synchronize()
    per_step = kernels_mod.launch_counts()
    # the second backward of the generator repeats the 46 + 47 backward launches of the
    # convolutions (and the backward launches of the other kernels)
    want = expected_launches(1, 0, conv_kernel=True)
    for name in ("groupnorm_silu_bwd", "flash_attention_bwd", "conv3x3_wgrad"):
        want[name] *= 2
    want["conv3x3"] += CONV_DGRAD_PER_STEP
    if per_step != want:
        raise RuntimeError(f"one adversarial step launched {per_step}, expected {want}")

    term_err = {k: abs(got_terms[k] - v) / abs(v) for k, v in want_terms.items()}
    bars = {"generator": ADV_GRAD_BAR, "discriminator": ADV_GRAD_BAR,
            "generator_without_adversary": GRAD_BAR,
            "discriminator_on_shared_reconstruction": GRAD_BAR}
    worst = {}
    for group, refs in want_grads.items():
        errs = {}
        for key, ref in refs.items():
            err = float((got_grads[group][key] - ref).abs().max())
            # a key projection's bias has gradient 0 in exact arithmetic: rounding noise on both sides
            errs[key] = err if key.endswith("to_k.bias") else err / float(ref.abs().max())
        key = max(errs, key=errs.get)
        worst[group] = {"tensor": key, "err_of_tensor_max": errs[key], "bar": bars[group]}
    emit("adv_train_reference", batch=2, conv_kernel=True, terms_card=got_terms,
         terms_cpu=want_terms, max_term_rel_err=max(term_err.values()), term_bar=1e-4,
         reconstruction_max_abs_diff=float((gpu_recon - cpu_recon).abs().max()),
         worst_gradient=worst, launches=per_step)
    if not max(term_err.values()) <= 1e-4:
        raise RuntimeError(f"f32 CUDA adversarial loss terms differ from the CPU plain path: {term_err}")
    for group, w in worst.items():
        if not w["err_of_tensor_max"] <= w["bar"]:
            raise RuntimeError(f"f32 CUDA {group} gradient {w['tensor']} differs from the CPU plain "
                               f"path by {w['err_of_tensor_max']} of its largest entry (bar {w['bar']})")


def ldm_path_shapes(torch) -> tuple[list, list]:
    """[(NHWC shape at batch 8, launches per pass)] of every GroupNorm+SiLU and
    [([B, heads, S, head_dim] at batch 8, launches per pass)] of every
    self-attention of one UNet pass of ``config/ldm_dente.json`` on the 32²
    latents of 256² images, recorded with forward hooks during one CPU pass of
    a single latent (plain versions, no launch)."""
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import GroupNormOp
    from pti_ldm_vae_tpu_torch.models.unet import TransformerBlock, diffusion_unet_from_config

    dd = load_config(LDM_CONFIG)["diffusion_def"]
    unet = diffusion_unet_from_config(dd)
    gn: dict[tuple[int, ...], int] = {}
    flash: dict[tuple[int, ...], int] = {}

    def gn_hook(module, args):
        if module.silu:
            shape = (BATCH, *args[0].shape[1:])
            gn[shape] = gn.get(shape, 0) + 1

    def attn_hook(module, args):
        _, seq, c = args[0].shape
        shape = (BATCH, module.num_heads, seq, c // module.num_heads)
        flash[shape] = flash.get(shape, 0) + 1

    handles = [m.register_forward_pre_hook(gn_hook) for m in unet.modules()
               if isinstance(m, GroupNormOp)]
    handles += [m.register_forward_pre_hook(attn_hook) for m in unet.modules()
                if isinstance(m, TransformerBlock)]
    try:
        with torch.inference_mode():
            unet(torch.zeros(1, 32, 32, dd["in_channels"]), torch.zeros(1, dtype=torch.long),
                 torch.zeros(1, 32 * 32, dd["cross_attention_dim"]))
    finally:
        for h in handles:
            h.remove()
    if sum(gn.values()) != GN_PER_UNET or sum(flash.values()) != FLASH_PER_UNET:
        raise RuntimeError(f"UNet pass: GroupNorm+SiLU {gn}, flash {flash}, expected "
                           f"{GN_PER_UNET} and {FLASH_PER_UNET} launches")
    by_size = sorted(gn.items(), key=lambda kv: -kv[0][1] * kv[0][2] * kv[0][3])
    return by_size, sorted(flash.items(), key=lambda kv: -kv[0][2])


def write_ldm_config(vae_ckpt: Path, run_dir: Path) -> Path:
    """``config/ldm_dente.json`` with its ``diffusion_def`` as it is, the
    flagship VAE config with the seeded weights ``vae_ckpt``, and ``run_dir``."""
    cfg = json.loads(LDM_CONFIG.read_text())
    cfg["vae"] = {"config_file": str(CONFIG), "checkpoint": str(vae_ckpt)}
    cfg["run_dir"], cfg["wandb"] = str(run_dir), {"enabled": False}
    path = run_dir.parent / f"{run_dir.name}.json"
    path.write_text(json.dumps(cfg))
    return path


def run_ldm_train_cli(torch, np, kernels_mod, cfg_path: Path, data_dir: Path,
                      extra: list[str], epochs: int = LDM_TRAIN_EPOCHS,
                      extra_per_step: dict[str, int] | None = None) -> dict:
    """``cli.train_diffusion`` for ``epochs`` epochs of 2 steps at b8 (256²
    images, frozen VAE, full-width UNet): launch counts (``extra_per_step``:
    the forward launches ``remat`` adds to a step), finite epsilon-MSE, every
    UNet and projector tensor finite and moved from its seeded init (but those
    of ``zero_gradient_tensors``), the checkpoint written."""
    from pti_ldm_vae_tpu_torch.cli.train_diffusion import main as train_main
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.utils.cli_common import load_ldm_models

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_main(["-c", str(cfg_path), "--input-dir", str(data_dir), "--num-samples",
                         str(LDM_TRAIN_IMAGES), "--max-epochs", str(epochs),
                         "--num-workers", "4", "--seed", str(TRAIN_SEED), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels_mod.launch_counts()
    steps = epochs * LDM_TRAIN_IMAGES // BATCH
    want = plus(expected_ldm_launches(steps, 0), extra_per_step or {}, steps)
    if result["total_step"] != steps or launches != want:
        raise RuntimeError(f"diffusion training path: {result}, launches {launches}, expected {want}")
    cfg = load_config(cfg_path)
    lines = (Path(cfg["run_dir"]) / "metrics.jsonl").read_text().splitlines()
    losses = [json.loads(line)["train/eps_mse"] for line in lines]
    if len(losses) != epochs or not np.isfinite(losses).all():
        raise RuntimeError(f"diffusion training: epsilon-MSE per epoch {losses}")
    saved = torch.load(result["checkpoint"], map_location="cpu", weights_only=True)
    torch.manual_seed(TRAIN_SEED)  # the CLI's seeding before it builds the models
    init = load_ldm_models(cfg, device=torch.device("cpu"))
    # a tensor whose gradient is 0 in exact arithmetic moves by rounding noise, or not at all
    zero = zero_gradient_tensors(init.unet)
    stuck = []
    for name, module in (("unet", init.unet), ("projector", init.projector)):
        ref = module.state_dict()
        if set(saved[name]) != set(ref):
            raise RuntimeError(f"{name} checkpoint keys differ from the model's")
        stuck += [f"{name}.{k}" for k, v in saved[name].items() if not torch.isfinite(v).all()
                  or (torch.equal(v, ref[k]) and f"{name}.{k}" not in zero)]
    if stuck:
        raise RuntimeError(f"parameters not finite or not moved from their init: {stuck[:5]}")
    return {"wall_s": wall, "launches": launches, "total_step": result["total_step"],
            "eps_mse_per_epoch": losses, "checkpoint": result["checkpoint"],
            "tensors_checked": sum(len(v) for v in saved.values() if v is not None),
            "zero_gradient_tensors": len(zero)}


def run_ldm_sample_cli(torch, np, kernels_mod, cfg_path: Path, checkpoint: str, cond_dir: Path,
                       out: Path, extra: list[str]) -> dict:
    """``cli.sample_diffusion`` from ``checkpoint``: 8 images conditioned on the
    first 8 of ``cond_dir``, 50 DDIM steps; launch counts and 8 finite TIFs
    and PNGs."""
    from pti_ldm_vae_tpu_torch.cli.sample_diffusion import main as sample_main
    from pti_ldm_vae_tpu_torch.data.io import read_image

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    sample_main(["-c", str(cfg_path), "--checkpoint", checkpoint, "--output-dir", str(out),
                 "--num-images", str(LDM_SAMPLE_IMAGES), "--condition-dir", str(cond_dir),
                 "--num-inference-steps", str(LDM_SAMPLE_STEPS), "--num-workers", "4",
                 "--seed", str(TRAIN_SEED), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels_mod.launch_counts()
    want = expected_ldm_launches(0, 1)
    if launches != want:
        raise RuntimeError(f"sampling path: launches {launches}, expected {want}")
    tifs, pngs = sorted(out.glob("sample_*.tif")), sorted(out.glob("sample_*.png"))
    if len(tifs) != LDM_SAMPLE_IMAGES or len(pngs) != LDM_SAMPLE_IMAGES:
        raise RuntimeError(f"expected {LDM_SAMPLE_IMAGES} TIFs and PNGs, got {len(tifs)}, {len(pngs)}")
    images = [read_image(str(p)) for p in tifs]
    for p, img in zip(tifs, images):
        if img.shape != (256, 256) or not np.isfinite(img).all():
            raise RuntimeError(f"{p.name}: bad sample {img.shape}")
    return {"wall_s": wall, "launches": launches, "images": len(tifs),
            "sample_std": [float(img.std()) for img in images]}


def ldm_reference_check(torch, np, kernels_mod, cfg_path: Path) -> None:
    """The UNet of ``config/ldm_dente.json`` in f32 on the card against the
    CPU plain path, same seeded weights (every 1-D parameter perturbed, so
    that the norms' affines matter), inputs, timesteps and noise, batch 2 at
    the 32²x4 latent with a 1024-token context: one forward (launches of one
    UNet pass asserted), one diffusion loss with its gradients (the launches
    of one forward and backward asserted) and a DDIM run of
    ``LDM_REFERENCE_STEPS`` steps.

    Bars. The UNet output: 1e-3 of its largest entry. Loss: 1e-4 relative;
    every gradient tensor: 2e-3 of its largest entry (``GRAD_BAR``), except
    the tensors of ``zero_gradient_tensors``, whose gradient is 0 in exact
    arithmetic, so that both sides hold rounding noise (1e-10 to 4e-9 on the
    CPU, against 8e-2 for the model's largest entry): their error is held to
    1e-6 of the model's largest gradient entry. DDIM: the
    final latents within 1e-3 of their largest entry: each step maps the
    UNet's error into ``x`` with a coefficient of at most 1
    (``sqrt(1 - a_prev) - sqrt(a_prev (1 - a_t) / a_t)``) and scales ``x`` and
    its error alike (by ``sqrt(a_prev / a_t)``), so the error relative to
    ``x`` stays of the order of the UNet's relative error, 1e-6 to 1e-5 in f32."""
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.models.unet import (
        ConditionProjector,
        diffusion_unet_from_config,
        project_latent_condition,
    )
    from pti_ldm_vae_tpu_torch.train.diffusion import NoiseSchedule, ddim_sample, diffusion_loss

    cfg = load_config(cfg_path)  # f32 with TF32 off: main() turned TF32 off
    dd = cfg["diffusion_def"]
    torch.manual_seed(21)
    cpu_unet = diffusion_unet_from_config(dd)
    cpu_proj = ConditionProjector(dd["in_channels"], dd["cross_attention_dim"])
    gen = torch.Generator().manual_seed(22)
    with torch.no_grad():
        for p in cpu_unet.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    gpu_unet = copy.deepcopy(cpu_unet).to(device="cuda", memory_format=torch.channels_last)
    gpu_proj = copy.deepcopy(cpu_proj).cuda()
    c = dd["in_channels"]
    x, cond, noise, x_t = (torch.randn(2, 32, 32, c, generator=gen) for _ in range(4))
    t = torch.tensor([17, 941])
    schedule = NoiseSchedule.linear_beta(int(cfg["diffusion_train"]["num_train_timesteps"]))

    def forward(unet, proj, device):
        with torch.no_grad():
            ctx = project_latent_condition(proj, cond.to(device))
            return unet(x.to(device), t.to(device), ctx).cpu()

    def loss_and_grads(unet, proj, device):
        params = [(f"unet.{k}", p) for k, p in unet.named_parameters()]
        params += [(f"projector.{k}", p) for k, p in proj.named_parameters()]
        ctx = project_latent_condition(proj, cond.to(device))
        loss = diffusion_loss(unet, schedule.to(device), x.to(device), t.to(device),
                              noise.to(device), ctx)
        grads = torch.autograd.grad(loss, [p for _, p in params])
        return float(loss.detach()), {k: g.cpu() for (k, _), g in zip(params, grads)}

    def ddim(unet, proj, device):
        with torch.no_grad():
            ctx = project_latent_condition(proj, cond.to(device))
            return ddim_sample(unet, schedule.to(device), x_t.to(device),
                               num_inference_steps=LDM_REFERENCE_STEPS, context=ctx).cpu()

    kernels_mod.reset_launch_counts()
    eps_card = forward(gpu_unet, gpu_proj, "cuda")
    per_pass = kernels_mod.launch_counts()
    kernels_mod.reset_launch_counts()
    loss_card, grads_card = loss_and_grads(gpu_unet, gpu_proj, "cuda")
    torch.cuda.synchronize()
    per_step = kernels_mod.launch_counts()
    lat_card = ddim(gpu_unet, gpu_proj, "cuda")
    want_pass = {**expected_ldm_launches(0, 0), "groupnorm_silu": GN_PER_UNET,
                 "flash_attention": FLASH_PER_UNET}
    want_step = {**want_pass, "groupnorm_silu_bwd": GN_PER_UNET, "flash_attention_bwd": FLASH_PER_UNET}
    if per_pass != want_pass or per_step != want_step:
        raise RuntimeError(f"one UNet pass launched {per_pass} (expected {want_pass}), one "
                           f"forward and backward {per_step} (expected {want_step})")
    eps_cpu = forward(cpu_unet, cpu_proj, "cpu")
    loss_cpu, grads_cpu = loss_and_grads(cpu_unet, cpu_proj, "cpu")
    lat_cpu = ddim(cpu_unet, cpu_proj, "cpu")

    def rel(got, want) -> float:
        return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)

    zero = zero_gradient_tensors(cpu_unet)
    grad_max = max(float(g.abs().max()) for g in grads_cpu.values())
    grad_err = {k: rel(grads_card[k], ref) for k, ref in grads_cpu.items() if k not in zero}
    worst = max(grad_err, key=grad_err.get)
    zero_err = max(float((grads_card[k] - grads_cpu[k]).abs().max()) for k in zero) / grad_max
    result = {"eps_err_of_max": rel(eps_card, eps_cpu), "eps_bar": LDM_EPS_BAR,
              "eps_max": float(eps_cpu.abs().max()),
              "loss_card": loss_card, "loss_cpu": loss_cpu,
              "loss_rel_err": abs(loss_card - loss_cpu) / abs(loss_cpu), "loss_bar": 1e-4,
              "max_grad_err_of_tensor_max": grad_err[worst], "worst_tensor": worst,
              "grad_bar": GRAD_BAR, "gradient_tensors": len(grad_err),
              "zero_gradient_tensors": len(zero), "zero_gradient_err_of_model_max": zero_err,
              "zero_gradient_bar": LDM_ZERO_GRAD_BAR,
              "ddim_steps": LDM_REFERENCE_STEPS, "ddim_err_of_max": rel(lat_card, lat_cpu),
              "ddim_max": float(lat_cpu.abs().max()), "ddim_bar": LDM_DDIM_BAR,
              "launches_per_unet_pass": per_pass, "launches_per_train_step": per_step}
    emit("ldm_reference", batch=2, **result)
    if not (result["eps_err_of_max"] <= LDM_EPS_BAR and result["loss_rel_err"] <= 1e-4
            and grad_err[worst] <= GRAD_BAR and zero_err <= LDM_ZERO_GRAD_BAR
            and result["ddim_err_of_max"] <= LDM_DDIM_BAR):
        raise RuntimeError(f"f32 CUDA UNet differs from the CPU plain path: {result}")


def zero_gradient_tensors(unet) -> set[str]:
    """Parameter names (``unet.`` prefix) whose gradient is 0 in exact
    arithmetic: a per-channel constant that reaches nothing but a GroupNorm of
    one channel per group, which subtracts it again. In a ResBlock whose
    second norm has one channel per group (the 32-channel level of
    ``config/ldm_dente.json``, 32 groups) those are the time projection and
    the first convolution's bias; before a head norm of one channel per group,
    the last ResBlock's second convolution's and skip's biases."""
    from pti_ldm_vae_tpu_torch.models.unet import TimeResBlock

    out = set()
    for name, module in unet.named_modules():
        if isinstance(module, TimeResBlock) and module.norm2.weight.numel() == module.norm2.num_groups:
            out |= {f"unet.{name}.{p}" for p in ("time_emb_proj.weight", "time_emb_proj.bias",
                                                  "conv1.conv.bias")}
    head, last = unet.out[0], unet.up_blocks[-1]
    if head.weight.numel() == head.num_groups and last.attentions is None:
        index = len(last.resnets) - 1
        prefix = f"unet.up_blocks.{len(unet.up_blocks) - 1}.resnets.{index}"
        out |= {f"{prefix}.conv2.conv.bias", f"{prefix}.skip_connection.conv.bias"}
    return out


def time_ldm(torch, cfg_path: Path, checkpoint: str, flush, exact: bool, remat: bool = False,
             parts: tuple[str, ...] = ("unet_forward", "ddim", "train_step"),
             step_iters: int = 6, trace_iters: int = 2) -> dict:
    """b8 on the card, with the trained weights: the UNet forward, the
    ``LDM_TIMED_STEPS``-step DDIM loop (steps/s, device ms per step) and one
    diffusion train step as ``train_diffusion`` runs it (VAE encode, UNet
    forward and backward, Adam; ``remat``: the UNet checkpointed), those of
    ``parts``: event ms, device ms, idle share and device ms by kind of kernel
    of each, the peak memory."""
    from pti_ldm_vae_tpu_torch.checkpoint.unet_convert import load_diffusion_checkpoint
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.models.unet import project_latent_condition
    from pti_ldm_vae_tpu_torch.train.diffusion import ddim_sample, make_diffusion_train_step
    from pti_ldm_vae_tpu_torch.train.state import create_train_state
    from pti_ldm_vae_tpu_torch.utils.cli_common import load_ldm_models

    torch.cuda.reset_peak_memory_stats()
    m = load_ldm_models(load_config(cfg_path), device=torch.device("cuda"), exact=exact,
                        remat=remat)
    unet_sd, projector_sd = load_diffusion_checkpoint(checkpoint)
    m.unet.load_state_dict(unet_sd, strict=True)
    m.projector.load_state_dict(projector_sd, strict=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    h, w, c = m.latent_shape
    x = torch.randn(BATCH, h, w, c, device="cuda", generator=gen)
    cond = torch.randn(BATCH, h, w, c, device="cuda", generator=gen)
    t = torch.randint(0, m.schedule.num_train_timesteps, (BATCH,), device="cuda", generator=gen)
    images = torch.randn(BATCH, 256, 256, 1, device="cuda", generator=gen)
    mask = torch.ones(BATCH, device="cuda")

    def unet_forward():
        with torch.no_grad():
            return m.unet(x, t, project_latent_condition(m.projector, cond))

    def sample():
        with torch.no_grad():
            return ddim_sample(m.unet, m.schedule, x, num_inference_steps=LDM_TIMED_STEPS,
                               context=project_latent_condition(m.projector, cond))

    trainable = torch.nn.ModuleDict({"unet": m.unet, "projector": m.projector})
    step = make_diffusion_train_step(m.unet, m.schedule, create_train_state(trainable, lr=1e-5),
                                     projector=m.projector)

    def train_step():  # as train_diffusion runs one batch
        with torch.no_grad():
            z_mu, z_sigma = m.vae.encode(images)
            latents = m.vae.sampling(z_mu, z_sigma, generator=gen)
        return step(latents, z_mu, mask, generator=gen)

    out = {"dtype": "float32" if exact else "bfloat16", "remat": remat}
    # one timed and one traced loop of LDM_TIMED_STEPS steps: the trace of a 50-step loop
    # holds ~35,000 kernels, whose reading took most of this phase; the UNet pass and the
    # train step traced over trace_iters calls
    for name, fn, iters, warmup, traced in (
            ("unet_forward", unet_forward, 10, 3, trace_iters), ("ddim", sample, 1, 1, 1),
            ("train_step", train_step, step_iters, 3, trace_iters)):
        if name not in parts:
            continue
        r = time_ms(fn, flush, iters=iters, warmup=warmup, trace_iters=traced)
        out[name] = {"event_ms": r["event_ms"], "device_ms": r["device_ms"],
                     "device_idle_share": 1.0 - r["device_ms"] / r["event_ms"],
                     "device_ms_by_kind": device_ms_by_kind(r["by_name"])}
    if "ddim" in out:
        out["ddim"]["steps"] = LDM_TIMED_STEPS
        out["ddim"]["steps_per_s"] = LDM_TIMED_STEPS * 1e3 / out["ddim"]["event_ms"]
        out["ddim"]["device_ms_per_step"] = out["ddim"]["device_ms"] / LDM_TIMED_STEPS
    if "train_step" in out:
        out["train_step"]["imgs_per_s"] = BATCH * 1e3 / out["train_step"]["event_ms"]
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def write_attributes(np, data_dir: Path, path: Path) -> Path:
    """A seeded attributes JSON for every TIF of ``data_dir``: the six
    attributes of the AR configs, values of a few hundred pixels (the
    flagship AR config divides them by 256)."""
    rng = np.random.default_rng(5)
    attrs = {p.name: {name: float(rng.uniform(50.0, 400.0)) for name in AR_ATTRIBUTES}
             for p in sorted(data_dir.glob("*.tif"))}
    path.write_text(json.dumps(attrs))
    return path


def ar_config_file(base: Path, data_dir: Path, run_dir: Path, attributes: Path, **train) -> Path:
    """``base`` (an AR config of ``config/``) as it is, pointed at ``data_dir``,
    ``run_dir`` and the attributes file, with ``train`` overrides."""
    cfg = json.loads(base.read_text())
    cfg["data_base_dir"], cfg["run_dir"] = str(data_dir), str(run_dir)
    cfg["regularized_attributes"]["attribute_file"] = str(attributes)
    cfg["autoencoder_train"].update(train)
    path = run_dir.parent / f"{run_dir.name}.json"
    path.write_text(json.dumps(cfg))
    return path


def run_ar_train_cli(torch, np, kernels_mod, cfg_path: Path, run_dir: Path, extra: list[str], *,
                     epochs: int, steps_per_epoch: int, per_pass: dict[str, int],
                     conv_kernel: bool, adversarial: bool) -> dict:
    """``train_vae`` on an AR config: launch counts of ``epochs`` x
    ``steps_per_epoch`` train steps and one eval step and one triplet panel
    per epoch; finite ``train/ar_loss_*`` on every step and ``val/ar_loss_*``
    on every validation; with ``adversarial`` (``adv_warmup_epochs: 0``) the
    discriminator's loss 0 in epoch 0 and > 0 afterwards; checkpoints."""
    from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_main

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_main(["-c", str(cfg_path), "--max-epochs", str(epochs), "--no-wandb",
                         "--num-workers", "4", "--seed", str(TRAIN_SEED), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shares = kernels_mod.launch_counts(), conv_shares(kernels_mod)
    wide = wide_launches(kernels_mod)
    train_steps = epochs * steps_per_epoch
    forward_only = epochs * (EVAL_STEPS_PER_EPOCH + 1)
    want = expected_launches(train_steps, forward_only, conv_kernel, per_pass)
    # bf16 with the convolution kernels: every forward and input gradient on the tensor cores
    want_shares = (expected_conv_shares(train_steps, forward_only, per_pass) if conv_kernel
                   else {"fma": 0, "padded": 0})
    if result["total_step"] != train_steps or launches != want or shares != want_shares:
        raise RuntimeError(f"AR training path {cfg_path.name}: {result}, launches {launches}, "
                           f"expected {want}; convolution FMA / padded launches {shares}, "
                           f"expected {want_shares}")
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss_total" in r]
    val_rows = [r for r in rows if "val/loss_total" in r]
    if len(train_rows) != train_steps or len(val_rows) != epochs:
        raise RuntimeError(f"metrics.jsonl: {len(train_rows)} train rows, {len(val_rows)} val rows")
    for prefix, group in (("train", train_rows), ("val", val_rows)):
        keys = [f"{prefix}/ar_loss_total"] + [f"{prefix}/ar_loss_{a}" for a in AR_ATTRIBUTES]
        for r in group:
            missing = [k for k in keys if k not in r]
            bad = [k for k, v in r.items() if k.startswith(prefix + "/") and not np.isfinite(v)]
            if missing or bad or not r[keys[0]] > 0:
                raise RuntimeError(f"AR metrics missing {missing} or not finite {bad} in {r}")
    if adversarial:
        warm, active = train_rows[:steps_per_epoch], train_rows[steps_per_epoch:]
        if any(r["train/adv_disc_loss"] != 0.0 for r in warm) or not all(
                r["train/adv_disc_loss"] > 0.0 for r in active):
            raise RuntimeError("the adversarial branch did not switch on after the warm-up epoch")
    weights = run_dir / "trained_weights"
    best = sorted(weights.glob("autoencoder_epoch*.pth"))
    if len(best) != 1 or not (weights / "autoencoder_last.pth").exists():
        raise RuntimeError(f"checkpoints: {sorted(p.name for p in weights.iterdir())}")
    ar_keys = ("train/ar_loss_total", "train/loss_total", "train/adv_disc_loss")
    return {"wall_s": wall, "launches": launches, "wide_launches": wide, "conv_shares": shares,
            "total_step": result["total_step"],
            "best_val_loss": result["best_val_loss"],
            "first_train": {k: train_rows[0][k] for k in ar_keys},
            "last_train": {k: train_rows[-1][k] for k in ar_keys},
            "val_ar_loss_total": [r["val/ar_loss_total"] for r in val_rows],
            "best_checkpoint": str(best[0])}


def wide_launches(kernels_mod) -> dict[str, int]:
    """Launches of the wide-head flash kernels since the last reset (a share of
    the flash counts: bf16 above head dim 128)."""
    fa = kernels_mod.flash_attention
    return {"flash_attention_wide": fa.wide_launches, "flash_attention_bwd_wide": fa.wide_bwd_launches}


def run_evaluate_cli(torch, np, kernels_mod, cfg_path: Path, checkpoint: str, input_dir: Path,
                     out: Path, n_images: int) -> dict:
    """``evaluate_vae`` on a checkpoint: one stochastic pass per batch, a
    finite ``metrics.json``."""
    from pti_ldm_vae_tpu_torch.cli.evaluate_vae import main as evaluate_main

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    summary = evaluate_main(["-c", str(cfg_path), "--checkpoint", checkpoint, "--input-dir",
                             str(input_dir), "--output-dir", str(out), "--batch-size", str(BATCH),
                             "--num-workers", "4", "--num-samples", str(n_images)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels_mod.launch_counts()
    want = expected_launches(0, -(-n_images // BATCH), False)
    written = json.loads((out / "metrics.json").read_text())
    if launches != want or len(written["files"]) != n_images or not all(
            np.isfinite(v) for v in summary.values()):
        raise RuntimeError(f"evaluate_vae: launches {launches} (expected {want}), {summary}")
    return {"wall_s": wall, "launches": launches,
            "metrics": {k: summary[k] for k in ("psnr_mean", "ssim_mean", "loss_total_mean")}}


def ar_step_reference_check(torch, np, kernels_mod, ae_def: dict, spec, data_dir: Path,
                            attributes: Path, normalize: dict, n_images: int, *, conv_kernel: bool,
                            per_pass: dict[str, int], phase: str) -> None:
    """One f32 generator step with the AR term (all ordered pairs of
    ``n_images``) on the card against the CPU plain path, same weights, batch,
    attributes and eps: loss terms (the AR total and each attribute's term
    too) within 1e-4 relative, every gradient tensor within 2e-3 of its largest
    entry; the launch counts of exactly one train step."""
    from pti_ldm_vae_tpu_torch.data.datasets import normalize_attributes
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, _generator_losses

    torch.manual_seed(7)
    cpu_model = autoencoder_from_config(ae_def, conv_kernel=conv_kernel)
    gpu_model = copy.deepcopy(cpu_model).to(device="cuda", memory_format=torch.channels_last)
    lcfg = LossConfig(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0, ar_gamma=0.5,
                      ar_vae_enabled=True, ar_spec=spec)
    paths = sorted(data_dir.glob("*.tif"))[:n_images]
    images = torch.from_numpy(np.stack([preprocess_image_np(read_image(str(p)), (IMAGE, IMAGE))
                                        for p in paths]))
    table = json.loads(attributes.read_text())
    rows = [normalize_attributes(table[p.name], normalize) for p in paths]
    attrs = {name: torch.tensor([r[name] for r in rows]) for name in AR_ATTRIBUTES}
    mask = torch.ones(n_images)
    side = IMAGE // 2 ** (len(ae_def["channels"]) - 1)
    eps = torch.randn(n_images, side, side, ae_def["latent_channels"],
                      generator=torch.Generator().manual_seed(8))

    def one(model, device):
        lp = init_lpips_params(0, device)
        total, aux = _generator_losses(model, lcfg, lp, images.to(device), mask.to(device),
                                       eps.to(device), None, None,
                                       {k: v.to(device) for k, v in attrs.items()})
        total.backward()
        terms = {k: float(aux[k].detach()) for k in ("recon_loss", "kl_loss", "perceptual_loss",
                                                     "ar_loss")}
        terms.update({f"ar_loss_{k}": float(v.detach()) for k, v in aux["ar_per_attr"].items()})
        terms["loss_total"] = float(total.detach())
        return terms, {k: p.grad.detach().cpu() for k, p in model.named_parameters()}

    kernels_mod.reset_launch_counts()
    got_terms, got_grads = one(gpu_model, "cuda")
    torch.cuda.synchronize()
    per_step = kernels_mod.launch_counts()
    want = expected_launches(1, 0, conv_kernel, per_pass)
    if per_step != want:
        raise RuntimeError(f"{phase}: one train step launched {per_step}, expected {want}")
    want_terms, want_grads = one(cpu_model, "cpu")
    term_err = {k: abs(got_terms[k] - v) / abs(v) for k, v in want_terms.items()}
    grad_err = {}
    for key, ref in want_grads.items():
        err = float((got_grads[key] - ref).abs().max())
        # a key projection's bias has gradient 0 in exact arithmetic: rounding noise on both sides
        grad_err[key] = err if key.endswith("to_k.bias") else err / float(ref.abs().max())
    worst = max(grad_err, key=grad_err.get)
    emit(phase, batch=n_images, conv_kernel=conv_kernel, terms_card=got_terms,
         terms_cpu=want_terms, max_term_rel_err=max(term_err.values()), term_bar=1e-4,
         max_grad_err_of_tensor_max=grad_err[worst], worst_tensor=worst, grad_bar=GRAD_BAR,
         launches_per_train_step=per_step)
    if not max(term_err.values()) <= 1e-4:
        raise RuntimeError(f"{phase}: f32 CUDA loss terms differ from the CPU plain path: {term_err}")
    if not grad_err[worst] <= GRAD_BAR:
        raise RuntimeError(f"{phase}: f32 CUDA gradient {worst} differs from the CPU plain path by "
                           f"{grad_err[worst]} of its largest entry")


def run_pti_cli(torch, np, kernels_mod, args: list[str], out: Path, n_images: int, batch: int,
                conv_kernel: bool, extra_per_backward: dict[str, int] | None = None,
                steps: tuple[int, int] = (PTI_LATENT_STEPS, PTI_TUNE_STEPS)) -> dict:
    """``run_pti`` on ``n_images`` at ``batch``, ``steps`` (latent, tune) steps:
    launch counts (every padded row of a batch is tuned too, none is written;
    ``extra_per_backward``: the forward launches ``remat`` adds to each
    decoder backward; ``--tune-formulation vmap`` in ``args``: stage 2's flash
    launches once per step for the batch), the outputs of every image, latent
    and tune losses that fall."""
    from pti_ldm_vae_tpu_torch.cli.run_pti import main as pti_main
    from pti_ldm_vae_tpu_torch.data.io import read_image

    latent_steps, tune_steps = steps
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    pti_main(args + ["--output-dir", str(out), "--batch-size", str(batch), "--num-samples",
                     str(n_images), "--latent-steps", str(latent_steps), "--tune-steps",
                     str(tune_steps)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shares = kernels_mod.launch_counts(), conv_shares(kernels_mod)
    batches = -(-n_images // batch)
    tuned_rows = batches * batch if batch > 1 else n_images
    vmap = "vmap" in args and batch > 1
    want = plus(expected_pti_launches(batches, batches * latent_steps, tuned_rows * tune_steps,
                                      n_images, conv_kernel,
                                      batches * tune_steps if vmap else None),
                extra_per_backward or {}, batches * latent_steps + tuned_rows * tune_steps)
    # bf16 with the convolution kernels: no call on the FMA kernel, the thin ones padded
    if launches != want or shares["fma"] or (shares["padded"] > 0) != conv_kernel:
        raise RuntimeError(f"run_pti: launches {launches}, expected {want}; convolution FMA / "
                           f"padded launches {shares}")
    pivots = sorted(out.glob("*_pivot.npz"))
    if len(pivots) != n_images or len(list(out.glob("*_pti.tif"))) != n_images or len(
            list(out.glob("*_pti.png"))) != n_images:
        raise RuntimeError(f"run_pti outputs: {sorted(p.name for p in out.iterdir())}")
    falls = {"latent": [], "tune": []}
    for path in pivots:
        npz = np.load(path)
        recon = read_image(str(path).replace("_pivot.npz", "_pti.tif"))
        if (npz["latent"].shape != (1, IMAGE // 8, IMAGE // 8, 4) or npz["latent_loss"].shape != (latent_steps,)
                or npz["tune_loss"].shape != (tune_steps,) or recon.shape != (IMAGE, IMAGE)
                or not all(np.isfinite(a).all() for a in (*npz.values(), recon))):
            raise RuntimeError(f"{path.name}: bad outputs")
        for key in falls:
            loss = npz[f"{key}_loss"]
            falls[key].append([float(loss[0]), float(loss[-1])])
            if not loss[-1] < loss[0]:
                raise RuntimeError(f"{path.name}: {key} loss does not fall: {loss[0]} -> {loss[-1]}")
    return {"wall_s": wall, "launches": launches, "conv_shares": shares, "images": n_images,
            "batch": batch, "latent_loss_first_last": falls["latent"],
            "tune_loss_first_last": falls["tune"]}


def pti_reference_check(torch, np, kernels_mod, ckpt: Path, data_dir: Path) -> None:
    """``PTI_REFERENCE_STEPS`` steps of both PTI stages, batched over two
    images at 256², f32 on the card against the CPU plain path from the same
    weights and initial latents.

    Bars. Per-step losses: 1e-4 relative. Adam's first update of an entry is
    ``lr * sign(g)``, so where an entry's first gradient is within the
    rounding the gradient bar allows (2e-3 of its tensor's largest entry) the
    two sides may step opposite ways: such entries are held to Adam's own
    bound, 2 lr per step; every other entry to ``PTI_PIVOT_BAR`` of the
    pivots' largest entry (stage 1, the gradient with respect to z) and to
    ``PTI_TUNED_BAR`` of each tuned tensor's largest change (stage 2, the
    first tune step's gradient of each image). The key projection's bias has
    gradient 0 in exact arithmetic and is held to the Adam bound alone."""
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np
    from pti_ldm_vae_tpu_torch.train.diffusion import (
        decoder_parameters,
        make_pivotal_tuning_inversion_batched,
    )
    from pti_ldm_vae_tpu_torch.utils.cli_common import load_config_and_model
    from pti_ldm_vae_tpu_torch.utils.vae_loader import load_vae_config, load_vae_model

    steps, latent_lr, tune_lr = PTI_REFERENCE_STEPS, 1e-1, 1e-4
    cpu_model = load_vae_model(load_vae_config(str(CONFIG)), str(ckpt), device="cpu", s2d_stem=False)
    _, gpu_model = load_config_and_model(str(CONFIG), str(ckpt), device=torch.device("cuda"),
                                         exact=True)
    images = torch.from_numpy(np.stack([preprocess_image_np(read_image(str(p)), (IMAGE, IMAGE))
                                        for p in sorted(data_dir.glob("*.tif"))[:2]]))
    with torch.no_grad():
        z0 = cpu_model.encode_deterministic(images)
    start = {k: v.detach().clone() for k, v in decoder_parameters(cpu_model).items()}

    def run(model, device):
        program = make_pivotal_tuning_inversion_batched(
            model, latent_steps=steps, latent_lr=latent_lr, tune_steps=steps, tune_lr=tune_lr)
        pivots, tuned, losses = program(images.to(device), z0.to(device))
        return (pivots.cpu(), {k: v.cpu() for k, v in tuned.items()},
                {k: v.cpu() for k, v in losses.items()})

    kernels_mod.reset_launch_counts()
    got = run(gpu_model, "cuda")
    torch.cuda.synchronize()
    launches = kernels_mod.launch_counts()
    want_launches = expected_pti_launches(0, steps, 2 * steps, 0, False)
    if launches != want_launches:
        raise RuntimeError(f"PTI program launched {launches}, expected {want_launches}")
    want = run(cpu_model, "cpu")

    # the first gradients on the CPU side: of z (stage 1), of each image's decoder (stage 2)
    z = z0.clone().requires_grad_()
    err = (cpu_model.decode(z) - images).square()
    g_z = torch.autograd.grad(err.mean(dim=(1, 2, 3)).sum(), z)[0]
    params = decoder_parameters(cpu_model)
    for p in params.values():  # the loader freezes an inference model
        p.requires_grad_(True)
    g_tune = []
    for i in range(2):
        loss = (cpu_model.decode(want[0][i:i + 1]) - images[i:i + 1]).square().mean()
        g_tune.append(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))

    def firm(g: torch.Tensor) -> torch.Tensor:
        return g.abs() > GRAD_BAR * g.abs().max()

    loss_err = max(float(((got[2][k] - want[2][k]).abs() / want[2][k].abs()).max()) for k in want[2])
    pivot_diff = (got[0] - want[0]).abs()
    pivot_firm = firm(g_z)
    pivot_err = float(pivot_diff[pivot_firm].max()) / float(want[0].abs().max())
    adam_err = {"pivot": float(pivot_diff.max()) / (2 * latent_lr * steps)}
    tuned_err, n_firm, n_all = {}, 0, 0
    for i in range(2):
        for key, ref in want[1].items():
            diff = (got[1][key][i] - ref[i]).abs()
            adam_err[key] = max(adam_err.get(key, 0.0), float(diff.max()) / (2 * tune_lr * steps))
            if key.endswith("to_k.bias"):
                continue
            mask = firm(g_tune[i][key])
            n_firm, n_all = n_firm + int(mask.sum()), n_all + mask.numel()
            change = float((ref[i] - start[key]).abs().max())
            if mask.any():
                tuned_err[key] = max(tuned_err.get(key, 0.0), float(diff[mask].max()) / change)
    worst = max(tuned_err, key=tuned_err.get)
    worst_adam = max(adam_err, key=adam_err.get)
    emit("pti_reference", images=2, steps=steps, max_loss_rel_err=loss_err, loss_bar=1e-4,
         pivot_err_of_max=pivot_err, pivot_bar=PTI_PIVOT_BAR,
         pivot_firm_share=float(pivot_firm.float().mean()),
         pivot_err_of_max_all_entries=float(pivot_diff.max()) / float(want[0].abs().max()),
         tuned_err_of_change=tuned_err[worst], worst_tensor=worst, tuned_bar=PTI_TUNED_BAR,
         tuned_firm_share=n_firm / n_all, worst_of_adam_bound=adam_err[worst_adam],
         worst_of_adam_bound_tensor=worst_adam, launches=launches)
    if not loss_err <= 1e-4:
        raise RuntimeError(f"PTI losses: card f32 differs from the CPU by {loss_err} relative")
    if not (pivot_err <= PTI_PIVOT_BAR and tuned_err[worst] <= PTI_TUNED_BAR
            and adam_err[worst_adam] <= 1.0):
        raise RuntimeError(f"PTI pivots {pivot_err} of their max, tuned {worst} {tuned_err[worst]} "
                           f"of its change, {worst_adam} {adam_err[worst_adam]} of the Adam bound")


def time_pti(torch, ckpt: Path, flush, exact: bool) -> dict:
    """PTI's two stages at 256² on the flagship checkpoint: stage 1
    (``PTI_TIMED_STEPS`` steps batched over 8 images) and stage 2 (the same
    steps at batch 1): event ms, device ms, idle share and device ms by kind
    per step, latent steps/s at b8 and tune steps/s at b1."""
    from pti_ldm_vae_tpu_torch.train.diffusion import _invert, _tune, decoder_parameters
    from pti_ldm_vae_tpu_torch.utils.cli_common import load_config_and_model

    torch.cuda.reset_peak_memory_stats()
    _, model = load_config_and_model(str(CONFIG), str(ckpt), device=torch.device("cuda"),
                                     exact=exact)
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.rand(BATCH, IMAGE, IMAGE, 1, device="cuda", generator=gen)
    with torch.no_grad():
        z0 = model.encode_deterministic(x)
    start = {k: v.detach().clone() for k, v in decoder_parameters(model).items()}
    n = PTI_TIMED_STEPS
    out = {"dtype": "float32" if exact else "bfloat16", "steps_per_call": n}
    for name, fn, batch in (
            ("latent", lambda: _invert(model, x, z0, n, 1e-1, per_image=True), BATCH),
            ("tune", lambda: _tune(model, x[:1], z0[:1], start, n, 1e-4), 1)):
        r = time_ms(fn, flush, iters=3, warmup=1)
        out[name] = {"batch": batch, "event_ms_per_step": r["event_ms"] / n,
                     "device_ms_per_step": r["device_ms"] / n,
                     "steps_per_s": n * 1e3 / r["event_ms"],
                     "device_idle_share": 1.0 - r["device_ms"] / r["event_ms"],
                     "device_ms_by_kind": device_ms_by_kind(
                         {k: v / n for k, v in r["by_name"].items()})}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def write_masks(np, stems: list[str], mask_dir: Path) -> None:
    """A seeded binary mask pair (``edente/``, ``dente/``) of 300x300 per
    stem: rows of foreground between a random top and bottom, each one run
    centred on the middle column with a random half-width."""
    from pti_ldm_vae_tpu_torch.data.io import write_tif

    rng = np.random.default_rng(6)
    cols = np.abs(np.arange(300) - 150)
    for sub in ("edente", "dente"):
        (mask_dir / sub).mkdir(parents=True)
    for stem in stems:
        for sub in ("edente", "dente"):
            top, bottom = int(rng.integers(20, 100)), int(rng.integers(270, 300))
            half = rng.integers(20, 120, size=(bottom - top, 1))
            mask = np.zeros((300, 300), np.float32)
            mask[top:bottom] = (cols < half).astype(np.float32)
            write_tif(str(mask_dir / sub / f"{stem}.tif"), mask)


def run_mask_metrics(np, mask_dir: Path, out_dir: Path, n: int) -> Path:
    """``compute_mask_metrics`` on the mask pairs: an entry with the six
    targets, whole pixel counts, for each of the ``n`` stems in both files."""
    from pti_ldm_vae_tpu_torch.cli.compute_mask_metrics import main as mask_main

    t0 = time.perf_counter()
    summary = mask_main(["--edente-dir", str(mask_dir / "edente"), "--dente-dir",
                         str(mask_dir / "dente"), "--output-edente",
                         str(out_dir / "attributes_edente.json"), "--output-dente",
                         str(out_dir / "attributes_dente.json")])
    wall = time.perf_counter() - t0
    for name in ("attributes_edente.json", "attributes_dente.json"):
        attrs = json.loads((out_dir / name).read_text())
        if len(attrs) != n or any(list(v) != list(REG_TARGETS) or not all(
                isinstance(x, int) and 0 <= x <= 300 for x in v.values()) for v in attrs.values()):
            raise RuntimeError(f"compute_mask_metrics: {name} has {len(attrs)} entries, "
                               f"e.g. {next(iter(attrs.values()), None)}")
    emit("mask_metrics", wall_s=wall, entries=summary["edente_entries"],
         first=json.loads((out_dir / "attributes_edente.json").read_text())["dente_000.tif"])
    return out_dir / "attributes_edente.json"


def regression_config_file(name: str, data_dir: Path, eval_dir: Path, attributes: Path,
                           ckpt: Path, run_dir: Path) -> Path:
    """``config/<name>.json`` as it is but for its paths: training and
    evaluation data, the attributes file, the run directory, the VAE's config
    (made absolute) and checkpoint (the seeded flagship ``.pth``)."""
    cfg = json.loads((ROOT / "config" / f"{name}.json").read_text())
    cfg["run_dir"] = str(run_dir)
    cfg["data"].update(data_base_dir=str(data_dir), attributes_path=str(attributes))
    cfg["evaluation"].update(data_base_dir=str(eval_dir), attributes_path=str(attributes))
    cfg["vae"].update(config_file=str(ROOT / cfg["vae"]["config_file"]), checkpoint=str(ckpt))
    path = run_dir.parent / f"{run_dir.name}.json"
    path.write_text(json.dumps(cfg))
    return path


def run_regression_pipeline(torch, np, kernels_mod, cfg_path: Path, ckpt: Path, input_dir: Path,
                            conv_kernel: bool) -> dict:
    """``train_regression`` (``REG_EPOCHS`` epochs), ``evaluate_regression``
    and ``inference_regression`` on one config, each with its launch counts
    (encoder forwards only, no backward kernel); finite metrics every epoch;
    the VAE's weights bit for bit those of its ``.pth`` after training and
    the file unchanged; ``head_last.pth`` loads into the head;
    ``target_norm_stats.json`` exactly for a ``"standard"`` config; one finite
    prediction row per image."""
    import hashlib

    from pti_ldm_vae_tpu_torch.cli.evaluate_regression import main as evaluate_main
    from pti_ldm_vae_tpu_torch.cli.inference_regression import main as inference_main
    from pti_ldm_vae_tpu_torch.cli.train_regression import main as train_main
    from pti_ldm_vae_tpu_torch.utils.regression_utils import load_regression_checkpoint
    from pti_ldm_vae_tpu_torch.utils.vae_loader import load_autoencoder_state_dict

    cfg = json.loads(cfg_path.read_text())
    run_dir, weights = Path(cfg["run_dir"]), Path(cfg["run_dir"]) / "trained_weights"
    extra = ["--conv-kernel"] if conv_kernel else []
    digest = hashlib.sha256(ckpt.read_bytes()).hexdigest()
    out: dict = {"wall_s": {}, "launches": {}}

    def counted(key: str, fn, encodes: int):
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out["wall_s"][key] = time.perf_counter() - t0
        out["launches"][key] = kernels_mod.launch_counts()
        want = expected_encoder_launches(encodes, conv_kernel)
        if out["launches"][key] != want:
            raise RuntimeError(f"{key} on {cfg_path.name}: launches {out['launches'][key]}, "
                               f"expected {want}")
        return result

    result = counted("train", lambda: train_main(
        ["-c", str(cfg_path), "--max-epochs", str(REG_EPOCHS), "--num-workers", "4", *extra]),
        REG_EPOCHS * (TRAIN_STEPS_PER_EPOCH + EVAL_STEPS_PER_EPOCH))
    model = result["model"]
    on_file = load_autoencoder_state_dict(str(ckpt))
    changed = [k for k, v in model.vae.state_dict().items() if not torch.equal(v.cpu(), on_file[k])]
    if changed or hashlib.sha256(ckpt.read_bytes()).hexdigest() != digest:
        raise RuntimeError(f"the VAE's weights changed in training: {changed[:5]}")
    state, meta = load_regression_checkpoint(weights / "head_last.pth", list(REG_TARGETS))
    model.regressor.load_state_dict(state, strict=True)
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    bad = [r for r in rows if not all(np.isfinite(v) for k, v in r.items() if "/" in k)]
    if len(rows) != REG_EPOCHS or bad or meta["epoch"] != REG_EPOCHS:
        raise RuntimeError(f"metrics.jsonl {rows}, head_last epoch {meta['epoch']}")
    standard = cfg["regression_train"]["target_norm"] == "standard"
    if (weights / "target_norm_stats.json").exists() != standard:
        raise RuntimeError(f"target_norm_stats.json written: {not standard}, config {cfg_path.name}")

    head = str(weights / "head_best.pth")
    metrics = counted("evaluate", lambda: evaluate_main(
        ["-c", str(cfg_path), "--checkpoint", head, "--num-workers", "4", *extra]),
        -(-N_IMAGES // BATCH))
    written = json.loads((run_dir / "eval" / "metrics.json").read_text())
    if len(written["files"]) != N_IMAGES or not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"evaluate_regression: {written}")
    payload = counted("inference", lambda: inference_main(
        ["-c", str(cfg_path), "--checkpoint", head, "--input-dir", str(input_dir),
         "--num-workers", "4", *extra]), -(-N_IMAGES // BATCH))
    preds = np.array([[row[t] for t in REG_TARGETS] for row in payload["predictions"]])
    written = json.loads((run_dir / "inference" / "predictions.json").read_text())
    if preds.shape != (N_IMAGES, len(REG_TARGETS)) or not np.isfinite(preds).all() or len(
            written["predictions"]) != N_IMAGES:
        raise RuntimeError(f"inference_regression: predictions of shape {preds.shape}")
    return {**out, "target_norm": cfg["regression_train"]["target_norm"],
            "val_loss_mse": [r["val/loss_mse"] for r in rows],
            "train_loss_mse": [r["train/loss_mse"] for r in rows],
            "eval": {k: metrics[k] for k in ("val_loss", "mae", "mse")},
            "first_prediction": payload["predictions"][0]}


def regression_reference_check(torch, np, kernels_mod, ckpt: Path, data_dir: Path,
                               attributes: Path) -> None:
    """One eval step and one f32 train step of the regression head (b8, the
    last row padding, dropout off) on the card with every kernel on (the
    convolution kernels too) against the CPU plain path, same VAE and head
    weights and batch. Bars: losses 1e-4 relative; eval predictions of the
    real rows within ``REG_PRED_BAR`` of their largest entry (the padded
    row, an all-zero image, is reported: its masked loss and gradient are 0
    and every caller drops its prediction); head gradients within
    ``GRAD_BAR`` of each tensor's largest entry; updated parameters within
    ``GRAD_BAR`` of each tensor's largest entry where the gradient is above
    the gradient bar's rounding, and within Adam's 2 lr elsewhere. Adam's
    first step is ``lr * sign(g)``: such an entry may step the other way,
    and where a hidden unit's whole backward signal is that small its row of
    4096 weights steps together, so the predictions after the step are
    reported (with the entries, and rows, that stepped the other way) and
    not held. Launch counts: three encoder passes, no backward kernel."""
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np
    from pti_ldm_vae_tpu_torch.models.regressor import LatentRegressor, VAELatentRegressor
    from pti_ldm_vae_tpu_torch.utils.regression_utils import build_optimizer, make_regression_steps
    from pti_ldm_vae_tpu_torch.utils.vae_loader import load_vae_config, load_vae_model

    config = load_vae_config(str(CONFIG))
    head = LatentRegressor(REG_FLAT, (256, 32), len(REG_TARGETS),
                           generator=torch.Generator().manual_seed(11))
    paths = sorted(data_dir.glob("*.tif"))[:BATCH - 1]
    images = np.zeros((BATCH, IMAGE, IMAGE, 1), np.float32)
    images[:len(paths)] = [preprocess_image_np(read_image(str(p)), (IMAGE, IMAGE)) for p in paths]
    table = json.loads(attributes.read_text())
    targets = np.zeros((BATCH, len(REG_TARGETS)), np.float32)
    targets[:len(paths)] = [[table[p.name][t] for t in REG_TARGETS] for p in paths]
    mask = (np.arange(BATCH) < len(paths)).astype(np.float32)

    def run(device, conv_kernel):
        vae = load_vae_model(config, str(ckpt), device=device, conv_kernel=conv_kernel)
        model = VAELatentRegressor(vae, copy.deepcopy(head).to(device), latent_dim=REG_FLAT)
        opt = build_optimizer(model.regressor.parameters(), REG_LR)
        train_step, eval_step = make_regression_steps(model, "mse", opt, None)
        batch = [torch.from_numpy(a).to(device) for a in (images, targets, mask)]
        eval_loss, preds = eval_step(*batch)
        loss = float(train_step(*batch, None))
        grads = {k: p.grad.detach().cpu() for k, p in model.regressor.named_parameters()}
        params = {k: p.detach().cpu() for k, p in model.regressor.named_parameters()}
        after = eval_step(*batch)[1]
        return ({"loss": loss, "eval_loss": float(eval_loss)}, grads, params, preds.cpu(),
                after.cpu())

    kernels_mod.reset_launch_counts()
    got = run(torch.device("cuda"), True)
    torch.cuda.synchronize()
    launches = kernels_mod.launch_counts()
    want_launches = expected_encoder_launches(3, True)
    if launches != want_launches:
        raise RuntimeError(f"regression eval + train + eval steps launched {launches}, "
                           f"expected {want_launches}")
    want = run("cpu", False)
    loss_err = {k: abs(got[0][k] - v) / abs(v) for k, v in want[0].items()}
    grad_err, param_err, adam_err, firm_share, flipped = {}, {}, {}, {}, {}
    start = head.state_dict()
    for key, g in want[1].items():
        grad_err[key] = float((got[1][key] - g).abs().max()) / float(g.abs().max())
        diff = (got[2][key] - want[2][key]).abs()
        firm = g.abs() > GRAD_BAR * g.abs().max()
        firm_share[key] = float(firm.float().mean())
        param_err[key] = float(diff[firm].max()) / float(want[2][key].abs().max())
        adam_err[key] = float(diff.max()) / (2 * REG_LR)
        steps = [torch.sign(side[2][key] - start[key]) for side in (got, want)]
        flips = steps[0] != steps[1]
        flipped[key] = [int(flips.sum())] + ([int(flips.any(dim=1).sum())] if flips.ndim == 2 else [])
    real = len(paths)  # the padded row's prediction is cut off by every caller
    after_err = float((got[4] - want[4])[:real].abs().max()) / float(want[4][:real].abs().max())
    pred_err = float((got[3] - want[3])[:real].abs().max()) / float(want[3][:real].abs().max())
    padded_err = float((got[3] - want[3])[real:].abs().max()) / float(want[3][:real].abs().max())
    worst_g, worst_p = max(grad_err, key=grad_err.get), max(param_err, key=param_err.get)
    emit("regression_reference", batch=BATCH, real_rows=len(paths), conv_kernel=True,
         losses_card=got[0], losses_cpu=want[0], max_loss_rel_err=max(loss_err.values()),
         loss_bar=1e-4, grad_err_of_tensor_max=grad_err[worst_g], worst_grad_tensor=worst_g,
         param_err_of_tensor_max=param_err[worst_p], worst_param_tensor=worst_p,
         grad_bar=GRAD_BAR, firm_share=firm_share, worst_of_adam_bound=max(adam_err.values()),
         pred_err_of_max=pred_err, pred_bar=REG_PRED_BAR,
         padded_row_pred_err_of_max_not_held=padded_err,
         entries_stepped_the_other_way_and_rows=flipped,
         pred_after_step_err_of_max_not_held=after_err, launches=launches)
    if not max(loss_err.values()) <= 1e-4:
        raise RuntimeError(f"regression losses: card f32 differs from the CPU: {loss_err}")
    if not (grad_err[worst_g] <= GRAD_BAR and param_err[worst_p] <= GRAD_BAR
            and max(adam_err.values()) <= 1.0 and pred_err <= REG_PRED_BAR):
        raise RuntimeError(f"regression step: gradient {worst_g} {grad_err[worst_g]}, parameter "
                           f"{worst_p} {param_err[worst_p]}, Adam bound {max(adam_err.values())}, "
                           f"predictions {pred_err}")


def time_regression(torch, ckpt: Path, flush, exact: bool, conv_kernel: bool) -> dict:
    """One regression train step (frozen encode, the configs' head with
    dropout 0.1, MSE, Adam) and one predict (encode + head, eval mode) at b8,
    256², in f32 (the CLIs' type) or bf16 (``compute_dtype``): event ms,
    device ms, idle share, imgs/s and device ms by kind."""
    from pti_ldm_vae_tpu_torch.models.regressor import LatentRegressor, VAELatentRegressor
    from pti_ldm_vae_tpu_torch.utils.regression_utils import build_optimizer, make_regression_steps
    from pti_ldm_vae_tpu_torch.utils.vae_loader import load_vae_config, load_vae_model

    dtype = torch.float32 if exact else torch.bfloat16
    vae = load_vae_model(load_vae_config(str(CONFIG)), str(ckpt), device="cuda",
                         compute_dtype=dtype, conv_kernel=conv_kernel)
    head = LatentRegressor(REG_FLAT, (256, 32), len(REG_TARGETS), dropout=0.1,
                           generator=torch.Generator().manual_seed(12))
    model = VAELatentRegressor(vae, head.cuda(), latent_dim=REG_FLAT)
    train_step, eval_step = make_regression_steps(
        model, "mse", build_optimizer(model.regressor.parameters(), REG_LR), None)
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.rand(BATCH, IMAGE, IMAGE, 1, device="cuda", generator=gen)
    t = 300.0 * torch.rand(BATCH, len(REG_TARGETS), device="cuda", generator=gen)
    m = torch.ones(BATCH, device="cuda")

    def predict():
        with torch.no_grad():
            return model(x)

    out = {"dtype": dtype_key(dtype), "conv_kernel": conv_kernel}
    for name, fn in (("train_step", lambda: train_step(x, t, m, gen)), ("predict", predict)):
        model.train(name == "train_step")
        r = time_ms(fn, flush, iters=6)
        out[name] = {"event_ms": r["event_ms"], "device_ms": r["device_ms"],
                     "imgs_per_s": BATCH * 1e3 / r["event_ms"],
                     "device_idle_share": 1.0 - r["device_ms"] / r["event_ms"],
                     "device_ms_by_kind": device_ms_by_kind(r["by_name"])}
    return out


def write_analysis_inputs(np, root: Path) -> tuple[Path, Path]:
    """``edente/`` and ``dente/``, ``ANALYSIS_IMAGES`` seeded 300² TIFs each,
    named ``ID_HA_YEAR_MONTH_PATIENT.tif`` with ``ANALYSIS_PATIENTS`` patients
    shared by both groups: a patient's images share their pattern, a dente
    image adds bright blobs."""
    from pti_ldm_vae_tpu_torch.data.io import write_tif

    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:300, 0:300]
    folders = []
    for g, group in enumerate(("edente", "dente")):
        folder = root / group
        folder.mkdir(parents=True)
        for i in range(ANALYSIS_IMAGES):
            patient = i % ANALYSIS_PATIENTS
            img = (np.sin(xx / (7.0 + patient)) * np.cos(yy / (11.0 + 0.5 * patient)) + 1.5
                   + 0.2 * rng.normal(size=(300, 300)))
            if group == "dente":
                for cx in range(40, 300, 50):
                    img += 1.5 * np.exp(-((xx - cx) ** 2 + (yy - 200) ** 2) / 300.0)
            img[: 20 + (i * 7) % 30] = 0.0  # background
            name = f"{1000 + 200 * g + i}_HA_{2019 + i % 3}_{1 + i % 12:02d}_P{patient:02d}.tif"
            write_tif(str(folder / name), img.astype(np.float32))
        folders.append(folder)
    return folders[0], folders[1]


def run_analysis_cli(torch, kernels_mod, main, args: list[str], want: dict) -> tuple:
    """One analysis CLI run with its launch counts (set to 0 just before,
    read just after, held to ``want``): (result, stdout, launches, wall s)."""
    import contextlib
    import io

    buf = io.StringIO()
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels_mod.launch_counts()
    if launches != want:
        raise RuntimeError(f"{main.__module__} {args[-6:]}: launches {launches}, expected {want}")
    return result, buf.getvalue(), launches, wall


def analysis_path(torch, np, kernels_mod, ckpt: Path, folders: tuple[Path, Path],
                  ar_cfg: Path, ar_ckpt: str) -> dict:
    """Phase 6k: ``analyze_static --method tsne`` on both folders (the
    flagship encoder in f32 at 256², b8, phase 4's seeded checkpoint, a cache
    under ``WORK``), with ``--conv-kernel`` on a fresh cache, the first command
    again on its filled cache (every latent a hit, no launch, the three text
    files the same bytes), ``analyze_interactive --export`` on that cache,
    ``analyze_ar_channels --export`` on the AR config and checkpoint of phase
    6f, and ``--method umap``, which must raise the JAX package's ImportError."""
    import re

    from pti_ldm_vae_tpu_torch.cli.analyze_ar_channels import main as ar_main
    from pti_ldm_vae_tpu_torch.cli.analyze_interactive import main as interactive_main
    from pti_ldm_vae_tpu_torch.cli.analyze_static import main as static_main
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.utils.visualization import SCATTER_SHAPE, channel_grid_shape

    edente, dente = folders
    texts = ("color_legend.txt", "distance_metrics.txt", "exams_sorted_by_distance.txt")
    batches = 2 * -(-ANALYSIS_IMAGES // BATCH)

    def static_args(out: str, cache: str, *extra: str) -> list[str]:
        return ["--vae-weights", str(ckpt), "--config-file", str(CONFIG), "--folder-edente",
                str(edente), "--folder-dente", str(dente), "--output-dir", str(WORK / out),
                "--method", "tsne", "--color-by-patient", "--cache-dir", str(WORK / cache),
                *extra]

    out: dict = {"wall_s": {}, "launches": {}}
    runs = {}
    for key, cache, extra, encodes in (
            ("analyze_static", "analysis_cache", [], batches),
            ("analyze_static_conv_kernel", "analysis_cache_conv", ["--conv-kernel"], batches),
            ("analyze_static_cached", "analysis_cache", [], 0)):
        conv = bool(extra)
        result, stdout, launches, wall = run_analysis_cli(
            torch, kernels_mod, static_main, static_args(f"analysis_{key}", cache, *extra),
            expected_encoder_launches(encodes, conv))
        new = [int(n) for n in re.findall(r"(\d+) newly encoded", stdout)]
        if new != [ANALYSIS_IMAGES if encodes else 0] * 2:
            raise RuntimeError(f"{key}: newly encoded {new}")
        proj = np.concatenate([result["projections"]["edente"], result["projections"]["dente"]])
        if proj.shape != (2 * ANALYSIS_IMAGES, 2) or not np.isfinite(proj).all():
            raise RuntimeError(f"{key}: projection of shape {proj.shape}, finite "
                               f"{np.isfinite(proj).all()}")
        png = read_image(str(result["plot"]))
        if png.shape != (*SCATTER_SHAPE, 3):
            raise RuntimeError(f"{key}: plot {png.shape}, stated {SCATTER_SHAPE}")
        files = {name: (WORK / f"analysis_{key}" / name).read_bytes() for name in texts}
        runs[key] = (proj, files)
        out["wall_s"][key], out["launches"][key] = wall, launches
    first, again = runs["analyze_static"], runs["analyze_static_cached"]
    if first[1] != again[1] or not np.array_equal(first[0], again[0]):
        raise RuntimeError("analyze_static on its own cache: other statistics or projection")

    result, stdout, launches, wall = run_analysis_cli(
        torch, kernels_mod, interactive_main,
        ["--vae-weights", str(ckpt), "--config-file", str(CONFIG), "--folder-edente", str(edente),
         "--folder-dente", str(dente), "--method", "tsne", "--output-dir",
         str(WORK / "analysis_interactive"), "--export", "--cache-dir",
         str(WORK / "analysis_cache")], expected_encoder_launches(0, False))
    payload = json.loads(Path(result).read_text())
    paths = [sorted(str(p) for p in f.glob("*.tif")) for f in folders]
    ids = [[p.rsplit("_", 1)[1][:-4] for p in group] for group in paths]
    if ([g["paths"] for g in payload["groups"]] != paths
            or [g["ids"] for g in payload["groups"]] != ids
            or sum(len(g["projection"]) for g in payload["groups"]) != 2 * ANALYSIS_IMAGES
            or not np.isfinite(np.concatenate([g["projection"] for g in payload["groups"]])).all()):
        raise RuntimeError("analyze_interactive: projection_data.json out of input order")
    out["wall_s"]["analyze_interactive"], out["launches"]["analyze_interactive"] = wall, launches

    grid = WORK / "analysis_ar_channels.png"
    want = {**expected_encoder_launches(0, False), "groupnorm_silu": 2 * GN_PER_CODER,
            "flash_attention": 2 * FLASH_PER_CODER}
    _, stdout, launches, wall = run_analysis_cli(
        torch, kernels_mod, ar_main,
        ["-c", str(ar_cfg), "--checkpoint", ar_ckpt, "--image-path", paths[1][0], "--export",
         "--output", str(grid)], want)
    if read_image(str(grid)).shape != (*channel_grid_shape(10), 3) or stdout.count("(AR)") != 6:
        raise RuntimeError(f"analyze_ar_channels: grid {read_image(str(grid)).shape}, "
                           f"{stdout.count('(AR)')} AR channels named")
    out["wall_s"]["analyze_ar_channels"], out["launches"]["analyze_ar_channels"] = wall, launches

    # no umap-learn on the card's machine: the JAX package's ImportError, after validation
    umap_args = static_args("analysis_umap", "analysis_cache")
    umap_args[umap_args.index("tsne")] = "umap"
    try:
        run_analysis_cli(torch, kernels_mod, static_main, umap_args,
                         expected_encoder_launches(0, False))
    except ImportError as exc:
        if str(exc) != "Please install umap-learn: pip install umap-learn":
            raise
        out["umap_error"] = str(exc)
    else:
        raise RuntimeError("analyze_static --method umap ran: umap-learn is installed")
    out["projection_extent"] = float(np.abs(first[0]).max())
    return out


def analysis_reference_check(torch, np, ckpt: Path, folders: tuple[Path, Path]) -> None:
    """Phase 6l: the analysis path in f32 on the card against the CPU plain
    path on the same inputs, stage by stage: the latents of 8 images (within
    ``ANALYSIS_LATENT_BAR`` of their largest entry), PCA-50 of the 256
    latents of phase 6k's cache (``ANALYSIS_PCA_BAR``, the same signs), the
    affinities P of the CPU's PCA-50 (``ANALYSIS_P_BAR``), the t-SNE embedding
    from the CPU's P and PCA-50 (KL(P || Q) within ``ANALYSIS_KL_BAR``
    relative, trustworthiness within ``ANALYSIS_TRUST_BAR``, both computed on
    the CPU by ``analysis.projection``), and two card runs of the t-SNE
    giving the same bits."""
    from pti_ldm_vae_tpu_torch.analysis import LatentCache, LatentSpaceAnalyzer
    from pti_ldm_vae_tpu_torch.analysis.common import create_transforms, load_vae_model
    from pti_ldm_vae_tpu_torch.analysis.projection import (
        PCA,
        TSNE,
        joint_probabilities,
        kl_divergence,
        trustworthiness,
    )

    paths = sorted(str(p) for p in folders[0].glob("*.tif"))
    transform = create_transforms((IMAGE, IMAGE))
    lat = {}
    for dev in ("cuda", "cpu"):
        model = load_vae_model(str(CONFIG), str(ckpt), device=torch.device(dev))
        lat[dev] = LatentSpaceAnalyzer(model, transform, device=dev).encode_images(paths[:BATCH])[0]
        del model
    latent_err = float(np.abs(lat["cuda"] - lat["cpu"]).max() / np.abs(lat["cpu"]).max())

    def refuse(p):
        raise RuntimeError(f"phase 6k's cache misses {len(p)} images")

    cache = LatentCache(WORK / "analysis_cache")
    x = np.concatenate([cache.get_or_encode_batch(
        sorted(str(p) for p in f.glob("*.tif")), refuse, str(ckpt), (IMAGE, IMAGE), f.name)[0]
        for f in folders])
    pcas = {dev: PCA(50, device=dev).fit(x) for dev in ("cuda", "cpu")}
    xp = {dev: pca.transform(x).cpu().numpy() for dev, pca in pcas.items()}
    pca_err = float(np.abs(xp["cuda"] - xp["cpu"]).max() / np.abs(xp["cpu"]).max())
    same_signs = bool((np.einsum("ij,ij->j", xp["cuda"], xp["cpu"]) > 0).all())
    p = {dev: joint_probabilities(xp["cpu"], ANALYSIS_PERPLEXITY, device=dev) for dev in
         ("cuda", "cpu")}
    p_err = float((p["cuda"].cpu() - p["cpu"]).abs().max() / p["cpu"].abs().max())
    emb = {}
    for dev, run in (("cuda", 0), ("cuda", 1), ("cpu", 0)):
        tsne = TSNE(perplexity=ANALYSIS_PERPLEXITY, device=dev)
        emb[dev, run] = tsne.embed(p[dev], xp["cpu"]).cpu().numpy()
    bit_identical = bool(np.array_equal(emb["cuda", 0], emb["cuda", 1]))
    kl = {dev: kl_divergence(p["cpu"], emb[dev, 0], device="cpu") for dev in ("cuda", "cpu")}
    trust = {dev: trustworthiness(x, emb[dev, 0], n_neighbors=5, device="cpu")
             for dev in ("cuda", "cpu")}
    kl_rel = abs(kl["cuda"] - kl["cpu"]) / kl["cpu"]
    emit("analysis_reference", images=BATCH, points=len(x), latent_err_of_max=latent_err,
         latent_bar=ANALYSIS_LATENT_BAR, pca50_err_of_max=pca_err, pca_bar=ANALYSIS_PCA_BAR,
         pca_same_signs=same_signs, p_err_of_max=p_err, p_bar=ANALYSIS_P_BAR, kl=kl,
         kl_rel_diff=kl_rel, kl_bar=ANALYSIS_KL_BAR, trustworthiness=trust,
         trust_bar=ANALYSIS_TRUST_BAR, tsne_bit_identical=bit_identical)
    if not (latent_err <= ANALYSIS_LATENT_BAR and pca_err <= ANALYSIS_PCA_BAR and same_signs
            and p_err <= ANALYSIS_P_BAR and kl_rel <= ANALYSIS_KL_BAR
            and abs(trust["cuda"] - trust["cpu"]) <= ANALYSIS_TRUST_BAR and bit_identical):
        raise RuntimeError(f"analysis: card f32 differs from the CPU: latents {latent_err}, "
                           f"PCA {pca_err} (signs {same_signs}), P {p_err}, KL {kl}, "
                           f"trustworthiness {trust}, t-SNE bit-identical {bit_identical}")


def time_analysis(torch, np, ckpt: Path, flush, folders: tuple[Path, Path]) -> None:
    """Phase 7's ``analysis_b8`` rows: the flagship encode at b8 (encode and
    channel-major flatten) on a device-resident batch in f32 and bf16, cuDNN
    and convolution kernels; the encode as ``analyze_static`` runs it (8 TIFs
    read, resized and normalized on the host, the latents back on the host);
    the projection at the CLIs' default sizes on seeded clustered ``[N, 4096]``
    latents, N = 2000 and 6000: PCA-50, kNN + P and the 1000 iterations of
    the t-SNE, each in seconds with its peak device memory."""
    from pti_ldm_vae_tpu_torch.analysis import LatentSpaceAnalyzer
    from pti_ldm_vae_tpu_torch.analysis.common import create_transforms
    from pti_ldm_vae_tpu_torch.analysis.projection import PCA, TSNE, joint_probabilities
    from pti_ldm_vae_tpu_torch.models.regressor import flatten_latent
    from pti_ldm_vae_tpu_torch.utils.cli_common import load_config_and_model

    def row(r: dict, **extra) -> dict:
        return {**extra, "event_ms": r["event_ms"], "device_ms": r["device_ms"],
                "device_idle_share": 1.0 - r["device_ms"] / r["event_ms"],
                "device_ms_by_kind": device_ms_by_kind(r["by_name"])}

    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(BATCH, IMAGE, IMAGE, 1, device="cuda", generator=gen)
    for exact, conv_kernel in ((True, False), (False, False), (True, True), (False, True)):
        _, model = load_config_and_model(str(CONFIG), str(ckpt), device=torch.device("cuda"),
                                         exact=exact, conv_kernel=conv_kernel)

        def encode():
            with torch.inference_mode():
                return flatten_latent(model.encode_deterministic(x))

        r = time_ms(encode, flush, iters=6)
        emit("analysis_b8", path="encode_device_resident",
             **row(r, dtype="float32" if exact else "bfloat16", conv_kernel=conv_kernel,
                   imgs_per_s=BATCH * 1e3 / r["event_ms"]))
        del model
    _, model = load_config_and_model(str(CONFIG), str(ckpt), device=torch.device("cuda"),
                                     exact=True)
    analyzer = LatentSpaceAnalyzer(model, create_transforms((IMAGE, IMAGE)), device="cuda")
    paths = sorted(str(p) for p in folders[0].glob("*.tif"))[:BATCH]
    r = time_ms(lambda: analyzer.encode_images(paths), flush, iters=4)
    emit("analysis_b8", path="encode_as_analyze_static",
         **row(r, dtype="float32", conv_kernel=False, imgs_per_s=BATCH * 1e3 / r["event_ms"]))
    del model, analyzer
    torch.cuda.empty_cache()

    for n in PROJECTION_SIZES:
        centres = 3.0 * torch.randn(ANALYSIS_PATIENTS, 4096, device="cuda", generator=gen)
        pick = torch.randint(0, ANALYSIS_PATIENTS, (n,), device="cuda", generator=gen)
        latents = centres[pick] + torch.randn(n, 4096, device="cuda", generator=gen)
        xp = PCA(50).fit_transform(latents)
        p = joint_probabilities(xp, ANALYSIS_PERPLEXITY)
        stages = {"pca50": lambda: PCA(50).fit_transform(latents),
                  "knn_and_p": lambda: joint_probabilities(xp, ANALYSIS_PERPLEXITY),
                  "tsne_1000_iterations": lambda: TSNE(perplexity=ANALYSIS_PERPLEXITY).embed(p, xp)}
        for stage, fn in stages.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            r = time_ms(fn, flush, iters=1, warmup=1)
            peak = torch.cuda.max_memory_allocated()
            emit("analysis_b8", path="projection", points=n, dims=4096, stage=stage,
                 seconds=r["event_ms"] / 1e3, peak_gb=peak / 1e9,
                 peak_gb_above_inputs=(peak - base) / 1e9,
                 **row(r, dtype="float64" if stage != "tsne_1000_iterations" else "float32"))
        del latents, xp, p
        torch.cuda.empty_cache()


def time_train_step(torch, ae_def: dict, flush, exact: bool, conv_kernel: bool = False,
                    adv_active: bool = False, ar_spec=None, adv_weight: float = 3.0,
                    knobs: dict | None = None, lpips_split: bool = True,
                    iters: int = 6, warmup: int = 3, trace_iters: int = 3,
                    batch: int = BATCH) -> dict:
    """Event ms, device ms, peak GB and the device ms by kind of one train
    step at 256², b8 unless ``batch`` says otherwise; the LPIPS share is the
    device ms a step without the perceptual term saves (``lpips_split``). ``conv_kernel``: the 3x3
    convolutions through the convolution kernels; ``adv_active``: the
    adversarial step (PatchGAN at ``adv_weight``); ``ar_spec``: with the
    AR-VAE term (gamma 0.5) on random attributes; ``knobs``: the model's
    ``s2d_stem`` / ``remat`` / ``norm_stats``. ``iters`` calls timed by CUDA
    events, ``trace_iters`` traced."""
    from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.state import create_train_state
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_train_step
    from pti_ldm_vae_tpu_torch.utils.cli_common import enable_parity_numerics

    if exact:
        enable_parity_numerics()
    torch.manual_seed(3)
    torch.cuda.reset_peak_memory_stats()
    dtype = torch.float32 if exact else torch.bfloat16
    model = autoencoder_from_config(ae_def, compute_dtype=dtype, conv_kernel=conv_kernel,
                                    **(knobs or {})).to(device="cuda",
                                                        memory_format=torch.channels_last)
    disc = None
    if adv_active:
        disc = PatchDiscriminator(compute_dtype=dtype, generator=torch.Generator().manual_seed(5)).to(
            device="cuda", memory_format=torch.channels_last)
    state = create_train_state(model, lr=2.5e-5, model_d=disc)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(batch, 256, 256, 1, device="cuda", generator=gen)
    mask = torch.ones(batch, device="cuda")
    attrs = None if ar_spec is None else {
        name: torch.rand(batch, device="cuda", generator=gen) for name in ar_spec.names}
    lp = init_lpips_params(0, "cuda")
    ar = dict(ar_vae_enabled=ar_spec is not None, ar_spec=ar_spec, ar_gamma=0.5)
    out, peak = {}, 0.0
    losses = [("full", LossConfig(adv_weight=adv_weight, **ar))]
    if lpips_split:
        losses.append(("no_lpips", LossConfig(adv_weight=adv_weight, use_perceptual=False, **ar)))
    for name, lcfg in losses:
        step = make_train_step(model, disc, lcfg, adv_active=adv_active)
        out[name] = time_ms(lambda: step(state, x, mask, attrs, lp, generator=gen), flush,
                            iters=iters, warmup=warmup, trace_iters=trace_iters)
        if name == "full":  # the full step's peak, before a lighter variant runs
            peak = torch.cuda.max_memory_allocated() / 1e9
    full = out["full"]
    kinds = device_ms_by_kind(full["by_name"])
    extra = {}
    if lpips_split:
        kinds["lpips_by_difference"] = full["device_ms"] - out["no_lpips"]["device_ms"]
        extra["event_ms_no_lpips"] = out["no_lpips"]["event_ms"]
    return {"dtype": dtype_key(dtype), "conv_kernel": conv_kernel, "adv_active": adv_active,
            "ar_vae": ar_spec is not None, "channels": list(ae_def["channels"]),
            **({"knobs": knobs} if knobs else {}),
            **({"batch": batch} if batch != BATCH else {}),
            "event_ms": full["event_ms"], "device_ms": full["device_ms"],
            "imgs_per_s": batch * 1e3 / full["event_ms"],
            "device_idle_share": 1.0 - full["device_ms"] / full["event_ms"],
            **extra, "peak_memory_gb": peak, "device_ms_by_kind": kinds}


def time_conv3x3(torch, conv_shapes, flush, gen, rows: dict[str, list], path: str = "vae",
                 dtypes=None, iters: int = 10, stem_cin: int = 1, forward_only: bool = False) -> None:
    """Per distinct convolution shape of a pass of the model ``path`` names
    (the flagship's by default) and dtype: the
    forward kernel as forward and as input gradient, and the filter-gradient
    kernel, each beside its bound, its plain version and the library call
    (``F.conv2d`` on channels-last tensors with TF32 off; its backward for the
    one operand). ``kernel`` names the kernel the wrapper's rule picks for the
    call (``wgmma``: the resident-slab tensor-core kernel, ``wgmma_stream``:
    the streamed-weight one, ``fma``: an f32-FMA one); ``tile`` the
    tensor-core kernel's ``(cin, mt, tn, kc)``, its ``cin`` padded to a
    multiple of 8. A bf16 forward or input gradient that took the f32-FMA
    kernel before the tensor-core kernel took every ``Cin`` (``Cin`` above
    128 or no multiple of 8) is also timed on that kernel, on the same
    inputs, called through its library before and after the tensor-core
    kernel (``fma_ms``: the mean of the two turns), and its last turn's
    output held to the plain version at the bf16 bar. The filter gradient's
    time (``ms``) includes the fold of its partial sums (one ``torch.sum``);
    ``kernel_only_ms`` leaves it out. ``iters``: timed calls per
    measurement; ``stem_cin``: the ``Cin`` of the encoder's stem, whose
    input gradient no path computes; ``forward_only``: the forward row alone
    (a path that computes no gradient)."""
    import torch.nn.functional as F

    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import (
        _DTYPE_CODES,
        _forward_library,
        _launch_forward,
        _launch_wgrad,
        STREAM_TILE,
        _sm_count,
        conv3x3_bwd_plain,
        conv3x3_plain,
        flip_transpose,
        forward_kernel,
        wgmma_tile,
        wgrad_kernel,
    )

    def timed(prefix, fn):
        return _timed(flush, prefix, fn, iters)

    def forward_row(head, role, n, x, wmat, library):
        """One forward-kernel row: ``x`` [B, H, W, Cin] with the matrix
        [9*Cin, Cout], beside the FMA kernel where it served bf16 before."""
        b, h, w, cin = x.shape
        cout = wmat.shape[1]
        kernel = forward_kernel(x.dtype, cin, cout)
        cin_k = -(-cin // 8) * 8
        yardstick = x.dtype == torch.bfloat16 and kernel != "fma" and (cin % 8 or cin > 128)
        y_fma = torch.empty(b, h, w, cout, device="cuda", dtype=x.dtype)

        def fma():  # the route bf16 took here before the tensor-core kernel took every Cin
            err = _forward_library().conv3x3_fwd(x.data_ptr(), wmat.data_ptr(), y_fma.data_ptr(), b,
                                                 h, w, cin, cout, _DTYPE_CODES[x.dtype],
                                                 torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"FMA forward {head['shape']} {role}: CUDA error {err}")

        fma_turns = [timed("", fma)["ms"]] if yardstick else []
        row = {**head, "role": role, "per_pass": n, "kernel": kernel,
               **({"tile": [cin_k, *wgmma_tile(b, h, w, cin_k, cout, _sm_count(x.device))]}
                  if kernel == "wgmma" else {"tile": [cin_k, *STREAM_TILE]}
                  if kernel == "wgmma_stream" else {}),
               **timed("", lambda: _launch_forward(x, wmat)),
               **timed("plain_", lambda: conv3x3_plain(x, wmat)),
               **timed("library_", library)}
        if yardstick:
            fma_turns.append(timed("", fma)["ms"])
            err = check_close(f"FMA {role} {head['shape']}", y_fma, conv3x3_plain(x, wmat), BF16_TOL)
            row.update(fma_ms=sum(fma_turns) / 2, fma_ms_turns=fma_turns, fma_max_abs_err=err)
        return row

    for dtype in dtypes or (torch.bfloat16, torch.float32):
        key = dtype_key(dtype)
        for shape, n in conv_shapes:
            b, h, w, cin, cout = shape
            x, wmat, g = (t.to(dtype).contiguous() for t in conv_inputs(torch, shape, gen))
            wflip = flip_transpose(wmat, cin, cout).contiguous()
            flops = 2.0 * 9 * cin * cout * b * h * w
            size = x.element_size()
            # only the encoder's stem reads the 1-channel image (4 channels in the
            # space-to-depth domain), whose gradient nobody wants: its dgrad is not on the path
            n_dgrad = 0 if cin == stem_cin else n
            head = {"path": path, "shape": list(shape), "dtype": key}

            # the library call: NCHW views of the channels-last memory, OIHW channels-last weight
            x_lib = x.permute(0, 3, 1, 2).detach().requires_grad_()
            w_lib = (wmat.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
                     .contiguous(memory_format=torch.channels_last).requires_grad_())
            g_lib = g.permute(0, 3, 1, 2)
            y_lib = F.conv2d(x_lib, w_lib, padding=1)

            bound_ms, bound_by = bound(flops, key, (x.numel() + wmat.numel() + g.numel()) * size)
            row = {**forward_row(head, "forward", n, x, wmat,
                                 lambda: F.conv2d(x_lib.detach(), w_lib.detach(), padding=1)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            rows["conv3x3"].append(row)
            emit("time_conv3x3", **row)
            if forward_only:
                del x, wmat, g, wflip, x_lib, w_lib, g_lib, y_lib
                continue

            row = {**forward_row(head, "dgrad", n_dgrad, g, wflip,
                                 lambda: torch.autograd.grad(y_lib, x_lib, g_lib, retain_graph=True)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            rows["conv3x3"].append(row)
            emit("time_conv3x3", **row)

            bound_ms, bound_by = bound(flops, key,
                                       (x.numel() + g.numel()) * size + wmat.numel() * 4)
            ours = time_ms(lambda: _launch_wgrad(x, g), flush, iters)
            row = {**head, "role": "wgrad", "per_pass": n, "kernel": wgrad_kernel(dtype, cin, cout),
                   "ms": ours["device_ms"], "event_ms": ours["event_ms"],
                   "kernel_only_ms": named_ms(ours["by_name"], "conv3x3_wgrad_kernel",
                                              "conv3x3_wgrad_wgmma_kernel"),
                   # the plain backward computes dx too; its dW part is nine products
                   **timed("plain_", lambda: conv3x3_bwd_plain(x, wmat, g)[1]),
                   **timed("library_", lambda: torch.autograd.grad(y_lib, w_lib, g_lib,
                                                                   retain_graph=True)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            rows["conv3x3_wgrad"].append(row)
            emit("time_conv3x3_wgrad", **row)
            del x, wmat, g, wflip, x_lib, w_lib, g_lib, y_lib
        torch.cuda.empty_cache()


def _timed(flush, prefix: str, fn, iters: int = 10) -> dict[str, float]:
    t = time_ms(fn, flush, iters)
    return {f"{prefix}ms": t["device_ms"], f"{prefix}event_ms": t["event_ms"]}


def time_groupnorm_silu(torch, cases, flush, gen, rows: dict[str, list], path: str) -> None:
    """Per GroupNorm+SiLU (shape, calls per pass, groups) and dtype: the forward
    kernel and the fused backward, each beside its bound, its plain version
    and ``F.group_norm`` + ``F.silu`` (and its autograd backward). ``path``
    names the model whose pass the shapes come from."""
    import torch.nn.functional as F

    from pti_ldm_vae_tpu_torch.ops.kernels import (
        groupnorm_silu,
        groupnorm_silu_bwd_plain,
        groupnorm_silu_plain,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _launch_backward as gn_backward
    from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _launch_forward as gn_forward

    def timed(prefix, fn):
        return _timed(flush, prefix, fn)

    for dtype in (torch.bfloat16, torch.float32):
        key = dtype_key(dtype)
        for shape, n, groups in cases:
            c = shape[-1]
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            scale = torch.ones(c, device="cuda")
            bias = torch.zeros(c, device="cuda")
            nbytes = x.numel() * x.element_size()
            head = {"path": path, "shape": list(shape), "groups": groups, "dtype": key, "per_pass": n}
            # forward: ~8 f32 operations per element (two for the sums, one
            # multiply-add, the SiLU's exp, add and divide); x read, y written
            x_nchw = x.permute(0, 3, 1, 2)
            bound_ms, bound_by = bound(8 * x.numel(), "float32", 2 * nbytes)
            row = {
                **head,
                **timed("", lambda: groupnorm_silu(x, scale, bias, groups, 1e-6)),
                **timed("plain_", lambda: groupnorm_silu_plain(x, scale, bias, groups, 1e-6)),
                **timed("library_", lambda: F.silu(F.group_norm(
                    x_nchw, groups, scale.to(dtype), bias.to(dtype), 1e-6))),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            rows["groupnorm_silu"].append(row)
            emit("time_groupnorm_silu", **row)

            # backward: one launch of the fused kernel plus one small torch.sum
            # over the images (both in ms; kernel_only_ms leaves the sum out)
            _, mean_g, inv_g = gn_forward(x, scale, bias, groups, 1e-6, save_stats=True)
            ours = time_ms(lambda: gn_backward(x, scale, bias, mean_g, inv_g, g, groups), flush)
            plain = timed("plain_", lambda: groupnorm_silu_bwd_plain(
                x, scale, bias, mean_g, inv_g, g, groups))
            leaves = (x_nchw.detach().requires_grad_(), scale.to(dtype).requires_grad_(),
                      bias.to(dtype).requires_grad_())
            y_lib = F.silu(F.group_norm(leaves[0], groups, leaves[1], leaves[2], 1e-6))
            g_nchw = g.permute(0, 3, 1, 2)
            library = timed("library_", lambda: torch.autograd.grad(
                y_lib, leaves, g_nchw, retain_graph=True))
            del y_lib, leaves
            # ~20 f32 operations per element (xhat, n, the sigmoid's exp and
            # divide, dn, the products and sums); x and g read, dx written
            bound_ms, bound_by = bound(20 * x.numel(), "float32", 3 * nbytes)
            row = {**head, "ms": ours["device_ms"], "event_ms": ours["event_ms"],
                   "kernel_only_ms": named_ms(ours["by_name"], "groupnorm_silu_bwd_kernel"),
                   **plain, **library, "bound_ms": bound_ms, "bound_by": bound_by}
            rows["groupnorm_silu_bwd"].append(row)
            emit("time_groupnorm_silu_bwd", **row)


def time_flash_attention(torch, cases, flush, gen, rows: dict[str, list], path: str) -> None:
    """Per flash-attention (shape [B, H, S, D], calls per pass) and dtype: the
    forward and the backward kernels, each beside its bound, its plain version
    and ``F.scaled_dot_product_attention`` (and its autograd backward). Where
    the wide tensor-core kernels serve bf16, also the f32-FMA kernels they
    replaced on the same inputs, called through their libraries before and
    after them (``fma_ms``: the mean of the two turns), and their last turn's
    output and gradients held to the plain f32 version at the bf16 bars
    (``check_flash``)."""
    import torch.nn.functional as F

    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import _backward_library, _forward_library

    from pti_ldm_vae_tpu_torch.ops.kernels import (
        flash_attention,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import _launch_backward as flash_backward
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import _launch_forward as flash_forward
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
        backward_kernel as flash_backward_kernel,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
        forward_kernel as flash_forward_kernel,
    )
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import pad_head_dim, padded_head_dim

    def timed(prefix, fn):
        return _timed(flush, prefix, fn)

    for dtype in (torch.bfloat16, torch.float32):
        key = dtype_key(dtype)
        for shape, n in cases:
            q, k, v, g = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4))
            nbytes = q.numel() * q.element_size()
            d, d_pad = shape[-1], padded_head_dim(shape[-1], dtype)
            head = {"path": path, "shape": list(shape), "dtype": key, "per_pass": n,
                    **({"padded_head_dim": d_pad} if d_pad != d else {})}
            products = 2 * shape[0] * shape[1] * shape[2] ** 2 * shape[3]  # one [S,S]x[S,D] product
            bound_ms, bound_by = bound(2 * products, key, 4 * nbytes)
            route = flash_forward_kernel(dtype, d_pad)
            bh, stream = shape[0] * shape[1], torch.cuda.current_stream().cuda_stream
            fma_out = torch.empty_like(q)

            def fma_forward():  # the route bf16 took above head dim 128 before the wide kernels
                err = _forward_library().flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), fma_out.data_ptr(), None, bh,
                    shape[2], d, 1, d**-0.5, stream)
                if err:
                    raise RuntimeError(f"FMA forward {shape}: CUDA error {err}")

            yardstick = route == "wgmma_wide" and d == d_pad
            fma_turns = [timed("", fma_forward)["ms"]] if yardstick else []
            row = {
                **head, "kernel": route,
                **timed("", lambda: flash_attention(q, k, v)),
                **timed("plain_", lambda: flash_attention_plain(q, k, v)),
                **timed("library_", lambda: F.scaled_dot_product_attention(q, k, v)),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            if yardstick:
                fma_turns.append(timed("", fma_forward)["ms"])
                want = flash_attention_plain(q.float(), k.float(), v.float())
                fma_err = check_flash(f"FMA forward {shape} {key}", fma_out, want, dtype)
                row.update(fma_ms=sum(fma_turns) / 2, fma_ms_turns=fma_turns,
                           fma_max_abs_err=fma_err[0], fma_rel_rms_err=fma_err[1])
                del want
            del fma_out
            rows["flash_attention"].append(row)
            emit("time_flash_attention", **row)

            # the backward launches as the wrapper's autograd makes them: on the
            # padded tensors (a head dim the kernels are not built for) at D^-0.5
            padded = [pad_head_dim(t, d_pad) if d_pad != d else t for t in (q, k, v, g)]
            out, lse = flash_forward(*padded[:3], True, d**-0.5, d_pad != d)
            leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
            out_lib = F.scaled_dot_product_attention(*leaves)
            # five products; reads q, k, v, out, dO, writes dq, dk, dv
            bound_ms, bound_by = bound(5 * products, key, 8 * nbytes)
            grads = [torch.empty_like(q) for _ in range(3)]
            delta = torch.empty(bh, shape[2], device="cuda")

            def fma_backward():
                err = _backward_library().flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in grads), bh,
                    shape[2], d, 1, d**-0.5, stream)
                if err:
                    raise RuntimeError(f"FMA backward {shape}: CUDA error {err}")

            fma_turns = [timed("", fma_backward)["ms"]] if yardstick else []
            ours = time_ms(lambda: flash_backward(*padded[:3], out, lse, padded[3], d**-0.5,
                                                   d_pad != d), flush)
            row = {
                **head, "kernel": flash_backward_kernel(dtype, d_pad),
                "ms": ours["device_ms"], "event_ms": ours["event_ms"],
                "ms_by_kernel": {w: named_ms(ours["by_name"], w) for w in
                                 ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
                                  "flash_bwd_dq_kernel", "flash_bwd_wgmma_kernel",
                                  "flash_bwd_wide_kernel", "flash_bwd_dkdv_split_kernel",
                                  "flash_bwd_dq_split_kernel")},
                **timed("plain_", lambda: flash_attention_bwd_plain(q, k, v, g)),
                **timed("library_", lambda: torch.autograd.grad(out_lib, leaves, g,
                                                                retain_graph=True)),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            if yardstick:
                fma_turns.append(timed("", fma_backward)["ms"])
                want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), g.float())
                fma_errs = [check_flash(f"FMA backward {name} {shape} {key}", ours, theirs, dtype)
                            for name, ours, theirs in zip(("dq", "dk", "dv"), grads, want)]
                row.update(fma_ms=sum(fma_turns) / 2, fma_ms_turns=fma_turns,
                           fma_max_abs_err=max(e for e, _ in fma_errs),
                           fma_rel_rms_err=max(r for _, r in fma_errs))
                del want
            del out_lib, leaves, padded, out, lse, grads, delta
            rows["flash_attention_bwd"].append(row)
            emit("time_flash_attention_bwd", **row)


def knob_config(path: Path, **keys) -> Path:
    """A copy of the flagship config with the top-level knobs ``keys``."""
    cfg = json.loads(CONFIG.read_text())
    cfg.update(keys)
    path.write_text(json.dumps(cfg))
    return path


def s2d_path_shapes(torch, ae_def: dict) -> tuple[list, list]:
    """The GroupNorm+SiLU and 3x3 convolution shapes (at b8, launches per
    pass) of a flagship pass with ``s2d_stem=True``: the same launches as the
    standard pass, thin channel counts included, at other shapes."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

    probe = autoencoder_from_config(ae_def, conv_kernel=True, s2d_stem=True)
    gn, conv = gn_path_shapes(probe, torch), conv_path_shapes(probe, torch)
    got = (sum(n for _, n in gn), sum(n for _, n in conv), sum(n for s, n in conv if s[3] % 8),
           sum(n for s, n in conv if s[4] % 8))
    want = (GN_PER_RECONSTRUCT, CONV_PER_RECONSTRUCT, FLAGSHIP_PASS["thin"],
            FLAGSHIP_PASS["thin_dgrad"])
    if got != want:
        raise RuntimeError(f"s2d pass shapes {gn}, {conv}: counts {got}, expected {want}")
    return gn, conv


def knob_step_check(torch, np, kernels_mod, ae_def: dict, data_dir: Path, phase: str,
                    variants: list[tuple[str, dict]]) -> dict:
    """One f32 generator step (the batch, weights and eps of
    ``train_reference_check``: 2 images at 256², full width) on the card in
    each form of ``variants`` [(name, model knobs)] against the standard
    form's step on the card: loss terms within 1e-4 relative, every gradient
    tensor within ``GRAD_BAR`` of its largest entry (``to_k.bias``, 0 in exact
    arithmetic, absolutely), the bars of the f32 train step. Launches of each
    step as computed: the standard step's, plus ``remat_extra`` under
    ``remat``; no GroupNorm+SiLU kernel and 42 counted plain calls under
    ``norm_stats: two_pass``."""
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.ops.norm import group_norm_silu
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, _generator_losses

    torch.manual_seed(7)
    state = autoencoder_from_config(ae_def).state_dict()
    lcfg = LossConfig(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0)
    images = torch.from_numpy(np.stack([
        preprocess_image_np(read_image(str(p)), (256, 256))
        for p in sorted(data_dir.glob("*.tif"))[:2]])).cuda()
    mask = torch.ones(2, device="cuda")
    eps = torch.randn(2, 32, 32, ae_def["latent_channels"],
                      generator=torch.Generator().manual_seed(8)).cuda()
    lp = init_lpips_params(0, "cuda")

    def step(knobs):
        model = autoencoder_from_config(ae_def, **knobs).to(device="cuda",
                                                            memory_format=torch.channels_last)
        model.load_state_dict(state, strict=True)
        kernels_mod.reset_launch_counts()
        two_pass = group_norm_silu.two_pass_calls
        total, aux = _generator_losses(model, lcfg, lp, images, mask, eps, None)
        total.backward()
        torch.cuda.synchronize()
        launches = kernels_mod.launch_counts()
        launches["two_pass_calls"] = group_norm_silu.two_pass_calls - two_pass
        terms = {k: float(aux[k].detach()) for k in ("recon_loss", "kl_loss", "perceptual_loss")}
        terms["loss_total"] = float(total.detach())
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        want = {**expected_launches(1, 0, conv_kernel=False), "two_pass_calls": 0}
        if knobs.get("remat"):
            want = plus(want, remat_extra(model), 1)
        if knobs.get("norm_stats") == "two_pass":
            want["two_pass_calls"] = want.pop("groupnorm_silu")
            want.update(groupnorm_silu=0, groupnorm_silu_bwd=0)
        if launches != want:
            raise RuntimeError(f"{phase} {knobs}: one step launched {launches}, expected {want}")
        return terms, grads, launches

    want_terms, want_grads, _ = step({})
    out = {}
    for name, knobs in variants:
        terms, grads, launches = step(knobs)
        term_err = max(abs(terms[k] - v) / abs(v) for k, v in want_terms.items())
        grad_err = {}
        for key, ref in want_grads.items():
            err = float((grads[key] - ref).abs().max())
            grad_err[key] = err if key.endswith("to_k.bias") else err / float(ref.abs().max())
        worst = max(grad_err, key=grad_err.get)
        out[name] = {"knobs": knobs, "max_term_rel_err": term_err,
                     "max_grad_err_of_tensor_max": grad_err[worst], "worst_tensor": worst,
                     "launches_per_step": launches}
        if not (term_err <= 1e-4 and grad_err[worst] <= GRAD_BAR):
            raise RuntimeError(f"{phase} {name}: terms {term_err}, gradient {worst} "
                               f"{grad_err[worst]} from the standard step's")
    emit(phase, batch=2, dtype="float32", against="the standard form's step on the card",
         term_bar=1e-4, grad_bar=GRAD_BAR, terms_standard=want_terms, **out)
    return out


def s2d_path(torch, np, kernels_mod, ae_def: dict, ckpt: Path, inputs, ref, bf16_recon,
             data_dir: Path) -> dict:
    """Phase ``s2d_path``: the kernels at the s2d pass's shapes against their
    plain versions; the f32 reconstruct of every s2d form, cuDNN and kernels,
    against the f32 standard one on the card and the CPU plain path's (1e-3);
    ``inference_vae`` with ``"s2d_stem": true`` in bf16 and bf16
    ``--conv-kernel`` (launch counts, no FMA convolution); the s2d forms' f32
    train steps against the standard one."""
    from pti_ldm_vae_tpu_torch.utils.vae_loader import load_vae_config, load_vae_model

    gn, conv = s2d_path_shapes(torch, ae_def)
    both = (torch.float32, torch.bfloat16)
    both_ways = sorted({s for s, _ in conv} | {(*s[:3], s[4], s[3]) for s, _ in conv})
    emit("s2d_shapes", groupnorm_silu=[[list(s), n] for s, n in gn],
         conv3x3=[[list(s), n] for s, n in conv],
         gn_plans=gn_plans(torch, [(s, 16) for s, _ in gn]),
         wgmma_occupancy={k: v for k, v in wgmma_occupancy(torch, both_ways).items()
                          if k.startswith("conv3x3")})
    errs = check_kernels(torch, [(s, 16, both) for s, _ in gn], (), conv, kernels_mod, seed=3,
                         ragged=False, balanced=True, phase="kernel_checks_s2d")

    config = load_vae_config(str(CONFIG))
    x = torch.from_numpy(inputs).cuda()
    recon = {}
    with torch.inference_mode():
        for conv_kernel in (False, True):
            for form in S2D_FORMS:
                model = load_vae_model(config, str(ckpt), device="cuda", s2d_stem=form,
                                       conv_kernel=conv_kernel)
                recon[(form, conv_kernel)] = model.reconstruct_deterministic(x).cpu().numpy()[..., 0]
                del model
    errors = {}
    for (form, conv_kernel), got in recon.items():
        tag = f"{form}{'_conv_kernel' if conv_kernel else ''}"
        errors[tag] = {"vs_card_standard": float(np.abs(got - recon[(False, conv_kernel)]).max()),
                       "vs_cpu": float(np.abs(got - ref).max())}
    worst = max(max(e.values()) for e in errors.values())

    cfg = knob_config(WORK / "vae_s2d_true.json", s2d_stem=True)
    cli = ["-c", str(cfg), "--checkpoint", str(ckpt), "--input-dir", str(WORK / "data"),
           "--batch-size", str(BATCH), "--num-workers", "4"]
    runs = {}
    for key, extra in (("bf16", []), ("bf16_conv_kernel", ["--conv-kernel"])):
        r = run_cli(torch, np, kernels_mod, cli + extra, WORK / f"out_s2d_{key}")
        shares = conv_shares(kernels_mod)
        want = expected_conv_shares(0, -(-N_IMAGES // BATCH)) if extra else {"fma": 0, "padded": 0}
        if shares != want:
            raise RuntimeError(f"inference_vae s2d {key}: convolution shares {shares}, want {want}")
        runs[key] = {"wall_s": r["wall_s"], "launches": r["launches"], "conv_shares": shares,
                     "max_abs_diff_vs_standard_bf16": float(np.abs(
                         np.stack(r["recon"]) - np.stack(bf16_recon)).max())}
    emit("s2d_path", reconstruct_f32_max_abs_err=errors, bar=1e-3, images=2,
         inference_vae=runs, config_keys={"s2d_stem": True})
    if not worst <= 1e-3:
        raise RuntimeError(f"f32 s2d reconstructs differ by {worst}: {errors}")
    steps = knob_step_check(torch, np, kernels_mod, ae_def, data_dir, "s2d_train_reference",
                            [(f"s2d_{form}", {"s2d_stem": form}) for form in S2D_FORMS[1:]])
    return {"errs": errs, "gn_shapes": gn, "conv_shapes": conv, "runs": runs, "steps": steps}


def remat_bits_check(torch, np, kernels_mod, ae_def: dict) -> dict:
    """bf16 generator steps (b8, 256², L1 + KL, no LPIPS) with the convolution
    kernels, standard and s2d: the gradients with ``remat`` the same bits as
    without (cuDNN, which keeps the 1x1 shortcuts, the downsamples and the
    quant convolutions, asked for deterministic sums), launches as computed,
    no convolution on the FMA kernel."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, _generator_losses

    torch.manual_seed(11)
    state = autoencoder_from_config(ae_def).state_dict()
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(BATCH, 256, 256, 1, device="cuda", generator=gen)
    eps = torch.randn(BATCH, 32, 32, ae_def["latent_channels"], device="cuda", generator=gen)
    mask = torch.ones(BATCH, device="cuda")
    lcfg = LossConfig(recon_loss="l1", kl_weight=1e-3, use_perceptual=False)
    lp = init_lpips_params(0, "cuda")

    def grads(knobs):
        model = autoencoder_from_config(ae_def, compute_dtype=torch.bfloat16, conv_kernel=True,
                                        **knobs).to(device="cuda", memory_format=torch.channels_last)
        model.load_state_dict(state, strict=True)
        kernels_mod.reset_launch_counts()
        total, _ = _generator_losses(model, lcfg, lp, x, mask, eps, None)
        total.backward()
        torch.cuda.synchronize()
        launches, shares = kernels_mod.launch_counts(), conv_shares(kernels_mod)
        want = expected_launches(1, 0, conv_kernel=True)
        if knobs.get("remat"):
            want = plus(want, remat_extra(model, conv_kernel=True), 1)
        if launches != want or shares["fma"]:
            raise RuntimeError(f"remat bits {knobs}: launches {launches}, expected {want}; "
                               f"convolution shares {shares}")
        return {k: p.grad.detach().clone() for k, p in model.named_parameters()}, launches

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for name, knobs in (("standard", {}), ("s2d_true", {"s2d_stem": True})):
            plain, plain_launches = grads(knobs)
            remat, remat_launches = grads({**knobs, "remat": True})
            differ = [k for k, v in plain.items() if not torch.equal(v, remat[k])]
            out[name] = {"bit_identical": not differ, "tensors": len(plain),
                         "launches": plain_launches, "launches_remat": remat_launches}
            if differ:
                raise RuntimeError(f"remat bits {name}: {len(differ)} gradients differ: {differ[:4]}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def remat_path(torch, np, kernels_mod, ae_def: dict, ckpt: Path, data_dir: Path) -> dict:
    """Phase ``remat_path``: the f32 remat steps (standard and s2d) against the
    standard step; the bf16 ``--conv-kernel`` remat gradients bit for bit;
    ``train_vae --remat --s2d-stem encoder --conv-kernel`` for 2 steps (its
    checkpoint loads ``strict=True`` into a standard model),
    ``train_diffusion --remat`` for 2 steps and ``run_pti`` b8 ``--conv-kernel``
    on a ``"remat": true`` config, their launches as computed."""
    from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_main
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.unet import diffusion_unet_from_config

    steps = knob_step_check(torch, np, kernels_mod, ae_def, data_dir, "remat_train_reference",
                            [("remat", {"remat": True}),
                             ("remat_s2d_true", {"remat": True, "s2d_stem": True})])
    bits = remat_bits_check(torch, np, kernels_mod, ae_def)
    torch.cuda.empty_cache()

    # train_vae: 16 train images (2 steps), 2 validation images (1 step, padded)
    run_dir = WORK / "run_remat_s2d"
    cfg = knob_config(WORK / "run_remat_s2d.json", data_base_dir=str(data_dir.parent),
                      run_dir=str(run_dir))
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_main(["-c", str(cfg), "--max-epochs", "1", "--no-wandb", "--num-workers", "4",
                         "--seed", str(TRAIN_SEED), "--subset-size", str(KNOB_TRAIN_SUBSET),
                         "--remat", "--s2d-stem", "encoder", "--conv-kernel"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shares = kernels_mod.launch_counts(), conv_shares(kernels_mod)
    model = autoencoder_from_config(ae_def, conv_kernel=True, remat=True, s2d_stem="encoder")
    n_steps = KNOB_TRAIN_SUBSET * 9 // 10 // BATCH
    want = plus(expected_launches(n_steps, 2, conv_kernel=True), remat_extra(model, True), n_steps)
    want_shares = expected_conv_shares(n_steps, 2)
    if result["total_step"] != n_steps or launches != want or shares != want_shares:
        raise RuntimeError(f"train_vae --remat --s2d-stem encoder: {result}, launches {launches}, "
                           f"expected {want}; convolution shares {shares}, expected {want_shares}")
    sd = torch.load(run_dir / "trained_weights" / "autoencoder_last.pth", map_location="cpu",
                    weights_only=True)
    autoencoder_from_config(ae_def).load_state_dict(sd, strict=True)
    if not all(torch.isfinite(v).all() for v in sd.values()):
        raise RuntimeError("train_vae --remat --s2d-stem encoder wrote non-finite weights")
    train_run = {"wall_s": wall, "launches": launches, "conv_shares": shares,
                 "total_step": result["total_step"], "best_val_loss": result["best_val_loss"]}

    ldm_cfg = write_ldm_config(ckpt, WORK / "run_ldm_remat")
    unet = diffusion_unet_from_config(load_config(ldm_cfg)["diffusion_def"])
    ldm = run_ldm_train_cli(torch, np, kernels_mod, ldm_cfg, data_dir.parent, ["--remat"],
                            epochs=KNOB_LDM_EPOCHS, extra_per_step=remat_extra(unet))

    pti_cfg = knob_config(WORK / "vae_remat.json", remat=True)
    decoder = autoencoder_from_config(ae_def, conv_kernel=True).decoder
    pti = run_pti_cli(torch, np, kernels_mod,
                      ["-c", str(pti_cfg), "--checkpoint", str(ckpt), "--input-dir",
                       str(WORK / "data"), "--num-workers", "4", "--conv-kernel"],
                      WORK / "pti_remat", BATCH, BATCH, True,
                      extra_per_backward=remat_extra(decoder, conv_kernel=True))
    emit("remat_path", bits=bits, train_vae=train_run,
         train_diffusion={k: v for k, v in ldm.items() if k != "checkpoint"}, run_pti=pti,
         train_vae_flags=["--remat", "--s2d-stem", "encoder", "--conv-kernel"],
         remat_extra_per_backward={"vae": remat_extra(model, True), "unet": remat_extra(unet),
                                   "pti_decoder": remat_extra(decoder, True)})
    return {"steps": steps, "bits": bits, "train_vae": train_run, "train_diffusion": ldm,
            "run_pti": pti}


def knob_timings(torch, ae_def: dict, ckpt: Path, ldm_cfg: Path, ldm_ckpt: str, flush) -> None:
    """Phases ``s2d_b8``, ``remat_b8``, ``two_pass_b8`` (timings, no claim):
    at 256², b8, the reconstruct (bf16 cuDNN, bf16 kernels, f32 cuDNN) and the
    generator step (bf16 cuDNN, bf16 kernels) in each s2d form; the generator
    step with and without ``remat`` (bf16, f32; peak GB) and one diffusion
    step with and without it (bf16); the generator step with two-pass against
    one-pass statistics (bf16). ``KNOB_ITERS`` calls timed by CUDA events
    each, two traced (one diffusion step)."""
    from pti_ldm_vae_tpu_torch.train.steps import make_inference_fn
    from pti_ldm_vae_tpu_torch.utils.vae_loader import load_vae_config, load_vae_model

    config = load_vae_config(str(CONFIG))
    x = torch.randn(BATCH, 256, 256, 1, device="cuda", generator=torch.Generator(device="cuda")
                    .manual_seed(13))
    for dtype, conv_kernel in ((torch.bfloat16, False), (torch.bfloat16, True),
                               (torch.float32, False)):
        for form in S2D_FORMS:
            model = load_vae_model(config, str(ckpt), device="cuda", compute_dtype=dtype,
                                   s2d_stem=form, conv_kernel=conv_kernel)
            reconstruct = make_inference_fn(model)
            t = time_ms(lambda: reconstruct(x), flush, iters=KNOB_ITERS, warmup=2, trace_iters=2)
            emit("s2d_b8", path="reconstruct", dtype=dtype_key(dtype), conv_kernel=conv_kernel,
                 s2d_stem=form, imgs_per_s=BATCH * 1e3 / t["event_ms"], event_ms=t["event_ms"],
                 device_ms=t["device_ms"], device_idle_share=1.0 - t["device_ms"] / t["event_ms"],
                 device_ms_by_kind=device_ms_by_kind(t["by_name"]))
            del model, reconstruct
    torch.cuda.empty_cache()
    few = dict(lpips_split=False, iters=KNOB_ITERS, warmup=2, trace_iters=2)
    for conv_kernel in (False, True):
        for form in S2D_FORMS:
            emit("s2d_b8", path="train_step", **time_train_step(
                torch, ae_def, flush, False, conv_kernel, knobs={"s2d_stem": form}, **few))
            torch.cuda.empty_cache()
    for exact in (False, True):
        for remat in (False, True):
            emit("remat_b8", path="train_step", **time_train_step(
                torch, ae_def, flush, exact, knobs={"remat": remat}, **few))
            torch.cuda.empty_cache()
    for remat in (False, True):
        emit("remat_b8", path="diffusion_step",
             **time_ldm(torch, ldm_cfg, ldm_ckpt, flush, False, remat=remat, parts=("train_step",),
                        step_iters=KNOB_ITERS, trace_iters=1))
        torch.cuda.empty_cache()
    for stats in ("one_pass", "two_pass"):
        emit("two_pass_b8", path="train_step", **time_train_step(
            torch, ae_def, flush, False, knobs={"norm_stats": stats}, **few))
        torch.cuda.empty_cache()


def timings_child(spec_path: str, out_path: str) -> int:
    """``chip_smoke.py --knob-timings SPEC OUT``: VGG16's f32 convolutions
    (the comparison suite with ``conv_kernel=True``, forward only), the
    kernels at the shapes only the s2d pass has (bf16 and f32
    GroupNorm+SiLU, bf16 convolution) and ``knob_timings``, in a process of
    their own, started by ``main`` after its last timing: ``torch.profiler``
    came back without device events from five traces running in one process
    past the load of the other timings (twice, at different phases), and
    there it kept about half of the VGG16 convolutions' events (device ms
    0.47 of their event ms, 0.91 in a fresh process). The rows go to ``OUT``
    (JSON), the phases' lines to stdout."""
    import torch

    sys.path.insert(0, str(ROOT))
    from pti_ldm_vae_tpu_torch.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    global T0
    T0 -= spec["t"]  # the lines' t: seconds since the parent script started
    flush = torch.empty(32 * 2**20, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows: dict[str, list] = {name: [] for name in KERNEL_NAMES}
    time_conv3x3(torch, [(tuple(sh), n) for sh, n in spec["vgg16_shapes"]], flush, gen, rows,
                 path="vgg16", dtypes=(torch.float32,), forward_only=True)
    time_groupnorm_silu(torch, [(tuple(sh), n, 16) for sh, n in spec["gn_shapes"]], flush, gen,
                        rows, "s2d")
    time_conv3x3(torch, [(tuple(sh), n) for sh, n in spec["conv_shapes"]], flush, gen, rows,
                 path="s2d", dtypes=(torch.bfloat16,), iters=5, stem_cin=4)
    torch.cuda.empty_cache()
    knob_timings(torch, load_config(CONFIG)["autoencoder_def"], Path(spec["ckpt"]),
                 Path(spec["ldm_cfg"]), spec["ldm_ckpt"], flush)
    Path(out_path).write_text(json.dumps(rows))
    return 0


def chain_path(torch, np, kernels_mod, work: Path) -> dict:
    """The shipped configs chained as a user runs them: ``config/`` holds
    verbatim copies of ``vae_dente_no_adv.json``, ``reg_edente_from_dente.json``
    and ``ldm_dente.json``, ``data/train_val/`` 18 seeded 300² TIFs under
    ``dente/`` and their attributes under ``metrics/``, all at the configs'
    own relative paths, and the CLIs run with ``work`` as the working
    directory; only the epochs are cut (``--max-epochs 1``) and the diffusion
    run takes 16 images. ``train_vae`` (flagship, 256², b8: 2 steps and one
    validation step, ``--trace-at-step 2``), then ``train_regression`` and
    ``train_diffusion``, whose ``vae.checkpoint``
    (``./runs/vae_dente_no_adv/trained_weights/autoencoder_last``) finds the
    ``autoencoder_last.pth`` the first run wrote. Launch counts per CLI, and
    the port's GroupNorm+SiLU and flash kernels, forward and backward, named
    in the trace of step 2."""
    import os

    from pti_ldm_vae_tpu_torch.cli.train_diffusion import main as diffusion_main
    from pti_ldm_vae_tpu_torch.cli.train_regression import main as regression_main
    from pti_ldm_vae_tpu_torch.cli.train_vae import main as vae_main
    from pti_ldm_vae_tpu_torch.utils.vae_loader import load_autoencoder_state_dict

    (work / "config").mkdir(parents=True)
    for name in CHAIN_CONFIGS:
        shutil.copy(ROOT / "config" / f"{name}.json", work / "config" / f"{name}.json")
    data = work / "data" / "train_val"
    write_inputs(np, data / "dente", CHAIN_IMAGES)
    (data / "metrics").mkdir()
    write_attributes(np, data / "dente", data / "metrics" / "attributes_edente.json")
    vae_ckpt = {name: json.loads((work / "config" / f"{name}.json").read_text())["vae"]["checkpoint"]
                for name in CHAIN_CONFIGS[1:]}
    out: dict = {"wall_s": {}, "launches": {}, "vae_checkpoint": vae_ckpt}

    def counted(key: str, fn, want: dict):
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out["wall_s"][key] = time.perf_counter() - t0
        out["launches"][key] = kernels_mod.launch_counts()
        if out["launches"][key] != want:
            raise RuntimeError(f"chain {key}: launches {out['launches'][key]}, expected {want}")
        return result

    cwd = os.getcwd()
    os.chdir(work)  # the configs' ./config, ./data and ./runs resolve from here
    try:
        vae = counted("train_vae", lambda: vae_main(
            ["-c", "config/vae_dente_no_adv.json", "--max-epochs", "1", "--no-wandb",
             "--num-workers", str(LOADER_WORKERS), "--trace-at-step", "2"]),
            expected_launches(2, 2, conv_kernel=False))  # 2 steps; 1 eval step, 1 triplet
        reg = counted("train_regression", lambda: regression_main(
            ["-c", "config/reg_edente_from_dente.json", "--max-epochs", "1", "--num-workers",
             str(LOADER_WORKERS)]), expected_encoder_launches(3, conv_kernel=False))
        ldm = counted("train_diffusion", lambda: diffusion_main(
            ["-c", "config/ldm_dente.json", "--input-dir", "data/train_val/dente",
             "--num-samples", str(LDM_TRAIN_IMAGES), "--max-epochs", "1", "--num-workers",
             str(LOADER_WORKERS)]), expected_ldm_launches(2, 0))
    finally:
        os.chdir(cwd)
    written = work / (vae_ckpt["reg_edente_from_dente"] + ".pth")
    if vae["total_step"] != 2 or not written.is_file() or len(set(vae_ckpt.values())) != 1:
        raise RuntimeError(f"chain train_vae: {vae}, {written} exists: {written.is_file()}")
    on_file = load_autoencoder_state_dict(str(written))
    if any(not torch.equal(v.cpu(), on_file[k]) for k, v in reg["model"].vae.state_dict().items()):
        raise RuntimeError("chain train_regression did not load the VAE train_vae wrote")
    if not np.isfinite(reg["best_val"]) or ldm["total_step"] != 2 or not np.isfinite(
            ldm["final_loss"]):
        raise RuntimeError(f"chain: regression best_val {reg['best_val']}, diffusion {ldm}")

    traces = sorted((work / "runs" / "vae_dente_no_adv" / "traces").glob("*.pt.trace.json*"))
    if len(traces) != 1:
        raise RuntimeError(f"--trace-at-step 2 wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {name: sum(name in k for k in kernels) for name in CHAIN_TRACE_KERNELS}
    if not all(named.values()):
        raise RuntimeError(f"the step-2 trace names {named} of the port's kernels "
                           f"({len(kernels)} kernel events)")
    return {**out, "trace": {"file": traces[0].name, "bytes": traces[0].stat().st_size,
                             "kernel_events": len(kernels), "named": named},
            "best_val_loss_vae": vae["best_val_loss"], "best_val_regression": reg["best_val"],
            "eps_mse_diffusion": ldm["final_loss"]}


def loader_b8(torch, np, work: Path) -> dict:
    """The data loader at b8 on 64 seeded 300² TIFs -> 256², ``LOADER_WORKERS``
    threads: imgs/s with its default transform (the native fused decode;
    ``native.decoded`` must count all 64, so a library that did not build
    fails here) and with ``transform=`` the numpy path, in turns (native,
    numpy, numpy, native); two native runs give the same bits; the largest
    native-vs-numpy difference; then ``preprocess_batch_device`` on the card
    against the CPU on the first 8 raw images [8, 300, 300, 1], f32."""
    from pti_ldm_vae_tpu_torch import native
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.loader import ShardedDataLoader
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_batch_device, preprocess_image_np

    write_inputs(np, work / "dente", LOADER_IMAGES)
    paths = sorted(str(p) for p in (work / "dente").glob("*.tif"))

    def numpy_path(path: str):
        return preprocess_image_np(read_image(path), (IMAGE, IMAGE))

    def run(transform):
        native.reset_counts()
        loader = ShardedDataLoader(paths, (IMAGE, IMAGE), BATCH, num_workers=LOADER_WORKERS,
                                   transform=transform)
        t0 = time.perf_counter()
        images = np.concatenate([b["image"] for b in loader])
        wall = time.perf_counter() - t0
        loader.close()
        return images, LOADER_IMAGES / wall, (native.decoded, native.python_path)

    runs = [run(t) for t in (None, numpy_path, numpy_path, None)]
    counts = [r[2] for r in runs]
    if counts != [(LOADER_IMAGES, 0), (0, 0), (0, 0), (LOADER_IMAGES, 0)]:
        raise RuntimeError(f"loader: (native, numpy) files per run {counts}")
    if not (np.array_equal(runs[0][0], runs[3][0]) and np.array_equal(runs[1][0], runs[2][0])):
        raise RuntimeError("loader: two runs of one transform gave other bits")
    raw = np.stack([read_image(p) for p in paths[:BATCH]])[..., None]
    cpu = preprocess_batch_device(torch.from_numpy(raw), (IMAGE, IMAGE)).numpy()
    card = preprocess_batch_device(torch.from_numpy(raw).cuda(), (IMAGE, IMAGE))
    flush = torch.empty(32 * 2**20, device="cuda", dtype=torch.float32)
    raw_card = torch.from_numpy(raw).cuda()
    timing = time_ms(lambda: preprocess_batch_device(raw_card, (IMAGE, IMAGE)), flush)
    err = float(np.abs(card.cpu().numpy() - cpu).max())
    if not err <= PREPROCESS_BAR:
        raise RuntimeError(f"preprocess_batch_device: card vs CPU {err} > {PREPROCESS_BAR}")
    return {"images": LOADER_IMAGES, "batch": BATCH, "workers": LOADER_WORKERS,
            "native_imgs_per_s": [runs[0][1], runs[3][1]],
            "numpy_imgs_per_s": [runs[1][1], runs[2][1]],
            "native_decoded": counts[0][0], "native_bit_identical": True,
            "native_vs_numpy_max_abs": float(np.abs(runs[0][0] - runs[1][0]).max()),
            "preprocess_batch_device": {"shape": list(raw.shape), "max_abs_err_vs_cpu": err,
                                        "bar": PREPROCESS_BAR, "device_ms": timing["device_ms"],
                                        "event_ms": timing["event_ms"]}}


def ddp_train(torch, kernels_mod, cfg_path: Path, extra: list[str], steps: int) -> dict:
    """``cli.train_vae`` for one epoch (``steps`` global steps of 8) through its own
    ``main``, which joins whatever process group is active or the torchrun
    environment describes; launch counts, the logged losses and (rank 0) the
    last checkpoint's parameters on the host."""
    from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_main
    from pti_ldm_vae_tpu_torch.parallel import process_rank

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_main(["-c", str(cfg_path), "--max-epochs", "1", "--no-wandb",
                         "--num-workers", "4", "--seed", str(TRAIN_SEED), *extra])
    torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0, "launches": kernels_mod.launch_counts(),
           "total_step": result["total_step"]}
    if result["total_step"] != steps:
        raise RuntimeError(f"ddp train_vae: {result['total_step']} steps, expected {steps}")
    if process_rank() == 0:
        run_dir = Path(json.loads(cfg_path.read_text())["run_dir"])
        rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        out["losses"] = [{k: v for k, v in r.items() if k.startswith(("train/", "val/"))
                          and k != "train/step"} for r in rows
                         if "train/loss_total" in r or "val/loss_total" in r]
        out["params"] = torch.load(run_dir / "trained_weights" / "autoencoder_last.pth",
                                   map_location="cpu", weights_only=True)
    return out


def ddp_step_ms(torch, ae_def: dict, batch: int, dtype, conv_kernel: bool,
                iters: int = DDP_ITERS) -> float:
    """CUDA-event ms of one generator train step of the flagship at 256²
    (``make_train_step``, so under a group with its all-reduces), ``iters``
    calls after 2; every rank makes the same calls."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.state import create_train_state
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_train_step

    torch.manual_seed(3)
    model = autoencoder_from_config(ae_def, compute_dtype=dtype, conv_kernel=conv_kernel).to(
        device="cuda", memory_format=torch.channels_last)
    state = create_train_state(model, lr=2.5e-5)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(batch, IMAGE, IMAGE, 1, device="cuda", generator=gen)
    mask = torch.ones(batch, device="cuda")
    step = make_train_step(model, None, LossConfig(), adv_active=False)
    lp = init_lpips_params(0, "cuda")
    for _ in range(2):
        step(state, x, mask, None, lp, generator=gen)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        step(state, x, mask, None, lp, generator=gen)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ddp_allreduce_ms(torch, ae_def: dict, iters: int = 20) -> dict:
    """The flagship generator's gradient all-reduce under the active group:
    ``allreduce_gradients`` (flatten, one all-reduce, copy back) and the bare
    ``all_reduce`` of its flat buffer, CUDA-event ms each."""
    import torch.distributed as dist

    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.parallel import allreduce_gradients

    params = list(autoencoder_from_config(ae_def).to(
        device="cuda", memory_format=torch.channels_last).parameters())
    for p in params:
        p.grad = torch.randn_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])

    def timed(fn) -> float:
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    return {"parameters": flat.numel(), "mbytes": flat.numel() * 4 / 1e6,
            "allreduce_gradients_ms": timed(lambda: allreduce_gradients(params)),
            "all_reduce_ms": timed(lambda: dist.all_reduce(flat)),
            "bound_ms": 2 * flat.numel() * 4 / HBM_BYTES_PER_S * 1e3}


def ddp_files(np, read_image, out: Path, pattern: str) -> dict:
    """The images (``*.tif``) or PTI npz arrays of ``out``, by file name."""
    files = {}
    for path in sorted(out.glob(pattern)):
        if path.suffix == ".npz":
            files.update({f"{path.name}:{k}": v for k, v in np.load(path).items()})
        else:
            files[path.name] = read_image(str(path))
    return files


def ddp_generate(torch, kernels_mod, spec: dict, tag: str) -> dict:
    """``sample_diffusion`` (8 images, ``DDP_DDIM_STEPS`` DDIM steps, f32) and
    ``run_pti`` (``DDP_PTI_IMAGES`` at b2, f32) into ``spec["work"]/<tag>_*``;
    each rank writes its rows. Launch counts and seconds of each."""
    from pti_ldm_vae_tpu_torch.cli.run_pti import main as pti_main
    from pti_ldm_vae_tpu_torch.cli.sample_diffusion import main as sample_main

    work, out = Path(spec["work"]), {}
    for name, run in (
            ("sample_diffusion", lambda: sample_main([
                "-c", spec["ldm_cfg"], "--checkpoint", spec["ldm_ckpt"],
                "--output-dir", str(work / f"{tag}_samples"), "--num-images", str(BATCH),
                "--condition-dir", spec["cond_dir"], "--num-inference-steps",
                str(DDP_DDIM_STEPS), "--num-workers", "4", "--seed", str(TRAIN_SEED), "--f32",
                "--device", "cuda:0"])),
            ("run_pti", lambda: pti_main([
                "-c", str(CONFIG), "--checkpoint", spec["ckpt"], "--input-dir", spec["cond_dir"],
                "--output-dir", str(work / f"{tag}_pti"), "--batch-size", "2", "--num-samples",
                str(DDP_PTI_IMAGES), "--latent-steps", str(DDP_PTI_STEPS[0]), "--tune-steps",
                str(DDP_PTI_STEPS[1]), "--num-workers", "4", "--f32", "--device", "cuda:0"]))):
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out[name] = {"wall_s": time.perf_counter() - t0, "launches": kernels_mod.launch_counts()}
    return out


def ddp_step_grads(torch, ae_def: dict) -> dict:
    """One f32 generator step of the flagship at 256² through
    ``make_train_step``: 8 seeded images and their posterior noise, this
    rank's rows of them (all 8 with no group); the loss terms, and the
    gradients the optimizer steps on (after the ranks' all-reduce), on the
    host."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.parallel import process_rank, world_size
    from pti_ldm_vae_tpu_torch.train.state import create_train_state
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_train_step

    torch.manual_seed(7)
    model = autoencoder_from_config(ae_def).to(device="cuda", memory_format=torch.channels_last)
    state = create_train_state(model, lr=DDP_LR)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(BATCH, IMAGE, IMAGE, 1, generator=gen)
    eps = torch.randn(BATCH, IMAGE // 8, IMAGE // 8, ae_def["latent_channels"], generator=gen)
    rows = slice(process_rank(), None, world_size())
    grads = {}
    real = state.optimizer_g.step

    def capture(*a, **kw):
        grads.update({k: p.grad.detach().cpu() for k, p in model.named_parameters()})
        return real(*a, **kw)

    state.optimizer_g.step = capture
    _, metrics = make_train_step(model, None, LossConfig(), adv_active=False)(
        state, x[rows].cuda(), torch.ones(BATCH // world_size(), device="cuda"), None,
        init_lpips_params(0, "cuda"), eps=eps[rows].cuda())
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads}


def ddp_grads_compare(single: dict, two: dict) -> dict:
    """The step of two ranks at b4 against one process at b8: loss terms
    within ``DDP_LOSS_BAR`` relative, every gradient tensor within
    ``GRAD_BAR`` of its largest entry (a key projection's bias, 0 in exact
    arithmetic, in absolute terms), as ``train_reference_check`` holds the
    card to the CPU."""
    term_err = max(abs(two["metrics"][k] - v) / max(abs(v), 1e-12)
                   for k, v in single["metrics"].items() if v)
    grad_err = {}
    for key, ref in single["grads"].items():
        err = float((two["grads"][key] - ref).abs().max())
        grad_err[key] = err if key.endswith("to_k.bias") else err / float(ref.abs().max())
    worst = max(grad_err, key=grad_err.get)
    if term_err > DDP_LOSS_BAR or grad_err[worst] > GRAD_BAR:
        raise RuntimeError(f"(b) f32 step: terms {term_err} relative; gradient {worst} "
                           f"{grad_err[worst]} of its largest entry")
    return {"step_term_max_rel_err": term_err, "step_grad_max_err_of_tensor_max": grad_err[worst],
            "step_worst_tensor": worst}


def ddp_child(spec_path: str, rank_arg: str) -> int:
    """``chip_smoke.py --ddp-child SPEC RANK``: one of the two processes of
    phase ``ddp_path``. Rank 0 first runs (a): ``train_vae`` bf16
    ``--conv-kernel`` on the flagship at b8 with no group, then as rank 0 of a
    one-rank NCCL group that the CLI starts from a torchrun environment
    (``RANK=0 WORLD_SIZE=1 LOCAL_RANK=0``), with the step's CUDA-event ms
    with no group, in the group and with no group again, and the gradient
    all-reduce's in the group; then the one-process runs that (b) is held
    to (``train_vae`` f32 at b8 with twice the LR, ``sample_diffusion``,
    ``run_pti``). Both ranks then start a gloo group of two on the one card
    and run (b): ``train_vae`` f32 at ``--batch-size 4``, ``sample_diffusion``
    and ``run_pti`` with ``--device cuda:0``, one f32 step whose gradients
    are held to the one-process step's, and a timed gloo step
    (correctness only: gloo stages CUDA tensors through the host). Each rank
    writes its results to ``SPEC``'s directory; rank 0 compares."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.ops import kernels as kernels_mod
    from pti_ldm_vae_tpu_torch.parallel import world_size

    spec = json.loads(Path(spec_path).read_text())
    global T0
    T0 -= spec["t"]  # the lines' t: seconds since the parent script started
    rank = int(rank_arg)
    work = Path(spec["work"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the 1x1 convolutions and the downsample stay on cuDNN, whose filter gradients may
    # sum in another order run to run unless asked not to: (a) compares bits
    torch.backends.cudnn.deterministic = True
    ae_def = load_config(CONFIG)["autoencoder_def"]
    out: dict = {}
    if rank == 0:
        # (a) no group, then one NCCL rank started by the CLI from a torchrun environment
        plain = ddp_train(torch, kernels_mod, Path(spec["cfg"]["plain"]),
                          ["--conv-kernel", "--device", "cuda"], DDP_STEPS)
        step_plain = ddp_step_ms(torch, ae_def, BATCH, torch.bfloat16, True)
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(spec["nccl_port"])}
        os.environ.update(env)
        try:
            nccl = ddp_train(torch, kernels_mod, Path(spec["cfg"]["nccl"]),
                             ["--conv-kernel", "--device", "cuda"], DDP_STEPS)
            if dist.get_backend() != "nccl" or world_size() != 1:
                raise RuntimeError(f"train_vae under torchrun's environment: backend "
                                   f"{dist.get_backend()}, world {world_size()}")
            step_nccl = ddp_step_ms(torch, ae_def, BATCH, torch.bfloat16, True)
            allreduce = ddp_allreduce_ms(torch, ae_def)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for key in env:
                os.environ.pop(key)
        # the ungrouped step once more: the step is host-bound, and its spread shows here
        step_plain_again = ddp_step_ms(torch, ae_def, BATCH, torch.bfloat16, True)
        same = [k for k in plain["params"] if torch.equal(plain["params"][k], nccl["params"][k])]
        if len(same) != len(plain["params"]) or plain["launches"] != nccl["launches"]:
            raise RuntimeError(f"(a) NCCL world 1: {len(same)} of {len(plain['params'])} "
                               f"tensors bit-identical, launches {nccl['launches']} vs "
                               f"{plain['launches']}")
        if plain["losses"] != nccl["losses"]:
            raise RuntimeError(f"(a) NCCL world 1 losses {nccl['losses']} vs {plain['losses']}")
        out["nccl_world1"] = {"launches": nccl["launches"], "bit_identical_tensors": len(same),
                              "wall_s": {"plain": plain["wall_s"], "nccl": nccl["wall_s"]},
                              "step_ms": {"plain": step_plain, "nccl": step_nccl,
                                          "plain_again": step_plain_again},
                              "allreduce": allreduce}
        emit("ddp_path", part="nccl_world1", **out["nccl_world1"])
        # the one-process runs (b) is held to
        single = ddp_train(torch, kernels_mod, Path(spec["cfg"]["single"]),
                           ["--f32", "--batch-size", str(BATCH), "--lr", str(2 * DDP_LR),
                            "--device", "cuda:0"], 1)
        single_gen = ddp_generate(torch, kernels_mod, spec, "single")
        single_grads = ddp_step_grads(torch, ae_def)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{spec['gloo_port']}",
                            rank=rank, world_size=2)
    try:
        two = ddp_train(torch, kernels_mod, Path(spec["cfg"]["gloo"]),
                        ["--f32", "--batch-size", str(BATCH // 2), "--device", "cuda:0"], 1)
        two_gen = ddp_generate(torch, kernels_mod, spec, "gloo")
        two_grads = ddp_step_grads(torch, ae_def)
        gloo_step = ddp_step_ms(torch, ae_def, BATCH // 2, torch.float32, False, iters=3)
    finally:
        dist.destroy_process_group()
    gloo = {"launches": {"train_vae": two["launches"],
                         **{k: v["launches"] for k, v in two_gen.items()}},
            "wall_s": {"train_vae": two["wall_s"], **{k: v["wall_s"] for k, v in two_gen.items()}},
            "step_ms_correctness_only": gloo_step}
    if rank == 0:
        gloo.update(ddp_compare(torch, np, read_image, spec, ae_def, single, single_gen, two,
                                two_gen))
        gloo.update(ddp_grads_compare(single_grads, two_grads))
    out["gloo"] = gloo
    emit("ddp_path", part=f"gloo_rank{rank}", **gloo)
    (work / f"ddp_rank{rank}.json").write_text(json.dumps(out))
    return 0


def ddp_compare(torch, np, read_image, spec: dict, ae_def: dict, single: dict,
                single_gen: dict, two: dict, two_gen: dict) -> dict:
    """(b) against the one-process runs: the logged losses (the step's, and
    the validation's after the update) within ``DDP_LOSS_BAR`` relative;
    the parameters' changes from their init within 2 lr everywhere, and
    within ``DDP_PARAM_BAR`` of their tensor's largest change on at least
    ``DDP_PARAM_SHARE`` of all entries (an Adam step from a fresh state moves
    an entry by about ``lr x sign(g)``: an entry whose gradient is at the
    rounding of its sums takes either sign, and a few of them do in any
    tensor; the gradients themselves are held in ``ddp_grads_compare``); the
    files of both ranks together are the one-process files, each within
    ``DDP_FILE_BAR`` of its largest entry; rank 0's launches those of the
    one process (per step and per batch a rank launches what one process
    does at twice the batch)."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

    if len(two["losses"]) != len(single["losses"]):
        raise RuntimeError(f"(b) {len(two['losses'])} logged rows, one process "
                           f"{len(single['losses'])}")
    loss_err = 0.0
    for got, want in zip(two["losses"], single["losses"]):
        if got.keys() != want.keys():
            raise RuntimeError(f"(b) logged keys {sorted(got)} vs {sorted(want)}")
        for k, v in want.items():
            loss_err = max(loss_err, abs(got[k] - v) / max(abs(v), 1e-12))
    torch.manual_seed(TRAIN_SEED)  # the trainer's own seeding of the parameter init
    init = autoencoder_from_config(ae_def).state_dict()
    near = total = 0
    worst_step = 0.0
    for k, w in single["params"].items():
        moved, got = w - init[k], two["params"][k] - init[k]
        worst_step = max(worst_step, float((got - moved).abs().max()) / (2 * (2 * DDP_LR)))
        near += int(((got - moved).abs() <= DDP_PARAM_BAR * float(moved.abs().max())).sum())
        total += moved.numel()
    share = near / total
    if loss_err > DDP_LOSS_BAR or share < DDP_PARAM_SHARE or worst_step > 1.0:
        raise RuntimeError(f"(b) train_vae: loss rel err {loss_err}; parameters: {share} of the "
                           f"entries within the bar, worst change / (2 lr) {worst_step}")
    work, file_err = Path(spec["work"]), {}
    for name, pattern in (("sample_diffusion", "samples/sample_*.tif"),
                          ("run_pti", "pti/*_pivot.npz"), ("run_pti_tif", "pti/*_pti.tif")):
        sub, glob = pattern.split("/")
        want = ddp_files(np, read_image, work / f"single_{sub}", glob)
        got = ddp_files(np, read_image, work / f"gloo_{sub}", glob)
        if sorted(got) != sorted(want) or not want:
            raise RuntimeError(f"(b) {name}: files {sorted(got)} vs {sorted(want)}")
        file_err[name] = max(float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), 1e-12)
                             for k, w in want.items())
        if file_err[name] > DDP_FILE_BAR:
            raise RuntimeError(f"(b) {name}: files differ by {file_err[name]} of their largest")
    for name, want in (("train_vae", single["launches"]),
                       ("sample_diffusion", single_gen["sample_diffusion"]["launches"])):
        got = two["launches"] if name == "train_vae" else two_gen[name]["launches"]
        if got != want:
            raise RuntimeError(f"(b) {name}: rank 0 launches {got}, one process {want}")
    return {"loss_max_rel_err": loss_err, "param_share_within_bar": share,
            "param_worst_change_over_2lr": worst_step, "file_max_rel_err": file_err,
            "one_process_wall_s": {"train_vae": single["wall_s"],
                                   **{k: v["wall_s"] for k, v in single_gen.items()}}}


def ddp_path(torch, np, ae_def: dict, ckpt: Path, ldm_cfg: Path, ldm_ckpt: str,
             cond_dir: Path) -> dict:
    """Phase ``ddp_path``: the two processes of ``ddp_child`` (rank 0 and 1),
    started together and waited for; either failing fails the phase. Returns
    rank 0's results."""
    write_inputs(np, WORK / "ddp_data" / "dente", DDP_IMAGES)
    write_inputs(np, WORK / "ddp_data_b" / "dente", DDP_B_IMAGES)
    cfgs = {}
    for key in ("plain", "nccl", "single", "gloo"):
        cfg = json.loads(CONFIG.read_text())
        b = key in ("single", "gloo")
        cfg["data_base_dir"] = str(WORK / ("ddp_data_b" if b else "ddp_data"))
        cfg["run_dir"] = str(WORK / f"ddp_run_{key}")
        cfg["autoencoder_train"]["lr"] = DDP_LR
        if b:
            cfg["train_split"] = DDP_B_SPLIT
        if key == "gloo":
            cfg["parallelism"] = {"data": 2}
        cfgs[key] = str(WORK / f"ddp_{key}.json")
        Path(cfgs[key]).write_text(json.dumps(cfg))
    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            ports.append(sock.getsockname()[1])
    spec = {"work": str(WORK), "cfg": cfgs, "ckpt": str(ckpt), "ldm_cfg": str(ldm_cfg),
            "ldm_ckpt": ldm_ckpt, "cond_dir": str(cond_dir), "nccl_port": ports[0],
            "gloo_port": ports[1], "t": time.perf_counter() - T0}
    (WORK / "ddp_spec.json").write_text(json.dumps(spec))
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--ddp-child",
                               str(WORK / "ddp_spec.json"), str(rank)]) for rank in (0, 1)]
    try:
        codes = [p.wait(timeout=DDP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0, 0]:
        raise RuntimeError(f"ddp_path: the ranks exited with {codes}")
    return {rank: json.loads((WORK / f"ddp_rank{rank}.json").read_text()) for rank in (0, 1)}


# ---- spatial and tensor parallelism (phase model_parallel_path) ------------------------------

def mp_shard_shapes(gn_shapes) -> list[tuple[tuple[int, ...], int]]:
    """The flagship pass's GroupNorm+SiLU shapes as one rank of spatial 2 sees
    them (half the height), with their calls per pass."""
    return [((b, h // MP_MODEL, w, c), n) for (b, h, w, c), n in gn_shapes]


def mp_split_inputs(torch, shape, dtype, gen):
    c = shape[-1]
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
    return x, g, scale, bias


def mp_split_checks(torch, shapes) -> dict:
    """The four split GroupNorm+SiLU entries against their plain versions on the
    card at the per-shard shapes, in both types (statistics as if the other
    shard held the same rows): y and dx at the kernel bars, the sums at rtol
    1e-4 with atol 1e-4 * sqrt(terms); the reductions run twice and must give
    the same bits. Returns each entry's largest error by type."""
    import importlib

    gn = importlib.import_module("pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu")
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {name: {} for name in MP_SPLIT_ENTRIES}
    for dtype in (torch.bfloat16, torch.float32):
        key, tol = dtype_key(dtype), F32_TOL if dtype == torch.float32 else BF16_TOL
        worst = dict.fromkeys(MP_SPLIT_ENTRIES, 0.0)
        for shape, _ in shapes:
            b, h, w, c = shape
            groups = MP_GROUPS
            x, g, scale, bias = mp_split_inputs(torch, shape, dtype, gen)
            xf, gf = x.float(), g.float()
            count = MP_MODEL * h * w * (c // groups)
            n = h * w * c // groups
            stats = gn.split_stats(x, groups)
            want = gn.groupnorm_silu_split_stats_plain(xf, groups)
            sums = dict(rtol=1e-4, atol=1e-4 * n ** 0.5)
            e = check_close(f"split_stats {shape} {key}", stats, want, sums)
            if not torch.equal(stats, gn.split_stats(x, groups)):
                raise RuntimeError(f"split_stats {shape} {key}: two runs differ")
            worst["groupnorm_silu_split_stats"] = max(worst["groupnorm_silu_split_stats"], e)
            mean, inv = gn.split_moments(MP_MODEL * want, count, 1e-6)
            e = check_close(f"split_apply {shape} {key}",
                            gn.split_apply(x, scale, bias, mean, inv, groups),
                            gn.groupnorm_silu_split_apply_plain(xf, scale, bias, mean, inv, groups),
                            tol)
            worst["groupnorm_silu_split_apply"] = max(worst["groupnorm_silu_split_apply"], e)
            r = gn.split_bwd_reduce(x, g, scale, bias, mean, inv, groups)
            r_want = gn.groupnorm_silu_split_bwd_reduce_plain(xf, gf, scale, bias, mean, inv,
                                                              groups)
            e = check_close(f"split_bwd_reduce {shape} {key}", r, r_want,
                            dict(rtol=1e-4, atol=1e-4 * (h * w) ** 0.5))
            if not torch.equal(r, gn.split_bwd_reduce(x, g, scale, bias, mean, inv, groups)):
                raise RuntimeError(f"split_bwd_reduce {shape} {key}: two runs differ")
            worst["groupnorm_silu_split_bwd_reduce"] = max(
                worst["groupnorm_silu_split_bwd_reduce"], e)
            r_all = MP_MODEL * r_want
            e = check_close(f"split_bwd_dx {shape} {key}",
                            gn.split_bwd_dx(x, g, scale, bias, mean, inv, r_all, groups, count),
                            gn.groupnorm_silu_split_bwd_dx_plain(xf, gf, scale, bias, mean, inv,
                                                                 r_all, groups, count), tol)
            worst["groupnorm_silu_split_bwd_dx"] = max(worst["groupnorm_silu_split_bwd_dx"], e)
        for name in MP_SPLIT_ENTRIES:
            errs[name][key] = worst[name]
    return errs


def mp_split_timings(torch, shapes, flush) -> dict:
    """Per split entry and per-shard shape, in bf16 (the path's type): device ms per call
    after an L2 flush, its plain version's, ``torch.var_mean`` for the
    statistics (the one library call that computes them; none computes the
    others), the bound, and the fused kernel's ms on the same unsharded shape
    (twice the height: forward for the two forward entries, backward for the
    two backward ones). Rows, and the bf16 sums over one pass's calls."""
    import importlib

    gn = importlib.import_module("pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu")
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for dtype in (torch.bfloat16,):
        for shape, n in shapes:
            b, h, w, c = shape
            groups = MP_GROUPS
            x, g, scale, bias = mp_split_inputs(torch, shape, dtype, gen)
            whole = torch.cat([x, x], dim=1)
            g_whole = torch.cat([g, g], dim=1)
            stats = gn.split_stats(x, groups)
            mean, inv = gn.split_moments(MP_MODEL * stats, MP_MODEL * h * w * (c // groups), 1e-6)
            r = MP_MODEL * gn.split_bwd_reduce(x, g, scale, bias, mean, inv, groups)
            count = MP_MODEL * h * w * (c // groups)
            _, mean_w, inv_w = gn._launch_forward(whole, scale, bias, groups, 1e-6, True)
            nbytes = x.numel() * x.element_size()
            xg = x.view(b, -1, groups, c // groups)
            cases = {
                "groupnorm_silu_split_stats": (
                    lambda: gn.split_stats(x, groups),
                    lambda: gn.groupnorm_silu_split_stats_plain(x, groups),
                    lambda: torch.var_mean(xg.float(), dim=(1, 3)), bound(3 * x.numel(), "float32", nbytes),
                    lambda: gn._launch_forward(whole, scale, bias, groups, 1e-6, False)),
                "groupnorm_silu_split_apply": (
                    lambda: gn.split_apply(x, scale, bias, mean, inv, groups),
                    lambda: gn.groupnorm_silu_split_apply_plain(x, scale, bias, mean, inv, groups),
                    None, bound(6 * x.numel(), "float32", 2 * nbytes),
                    lambda: gn._launch_forward(whole, scale, bias, groups, 1e-6, False)),
                "groupnorm_silu_split_bwd_reduce": (
                    lambda: gn.split_bwd_reduce(x, g, scale, bias, mean, inv, groups),
                    lambda: gn.groupnorm_silu_split_bwd_reduce_plain(x, g, scale, bias, mean, inv,
                                                                     groups),
                    None, bound(16 * x.numel(), "float32", 2 * nbytes),
                    lambda: gn._launch_backward(whole, scale, bias, mean_w, inv_w, g_whole, groups)),
                "groupnorm_silu_split_bwd_dx": (
                    lambda: gn.split_bwd_dx(x, g, scale, bias, mean, inv, r, groups, count),
                    lambda: gn.groupnorm_silu_split_bwd_dx_plain(x, g, scale, bias, mean, inv, r,
                                                                 groups, count),
                    None, bound(20 * x.numel(), "float32", 3 * nbytes),
                    lambda: gn._launch_backward(whole, scale, bias, mean_w, inv_w, g_whole, groups)),
            }
            for name, (ours, plain, library, (bound_ms, bound_by), fused) in cases.items():
                row = {"name": name, "shape": list(shape), "dtype": dtype_key(dtype),
                       "per_pass": n, **_timed(flush, "", ours, MP_TIMED_ITERS),
                       **_timed(flush, "plain_", plain, MP_TIMED_ITERS),
                       "library_ms": (_timed(flush, "", library, MP_TIMED_ITERS)["ms"]
                                      if library is not None else None),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "fused_unsharded_ms": _timed(flush, "", fused, MP_TIMED_ITERS)["ms"]}
                rows.append(row)
                emit("model_parallel_path", part="split_timing", **row)
    totals = {}
    for name in MP_SPLIT_ENTRIES:
        bf = [r for r in rows if r["name"] == name and r["dtype"] == "bfloat16"]
        totals[name] = {k: (None if any(r[k] is None for r in bf)
                            else sum(r[k] * r["per_pass"] for r in bf))
                        for k in ("ms", "event_ms", "plain_ms", "library_ms", "bound_ms",
                                  "fused_unsharded_ms")}
        totals[name]["bound_by"] = bf[0]["bound_by"]
    return {"rows": rows, "totals": totals}


def mp_train(torch, kernels_mod, cfg_path: Path, extra: list[str], steps: int) -> dict:
    """``cli.train_vae`` for one epoch through its own ``main`` (under the
    active group, if any): launch counts (the split entries' too), peak GB of
    this process, wall seconds, and on rank 0 the logged losses."""
    from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_main
    from pti_ldm_vae_tpu_torch.parallel import process_rank

    kernels_mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train_main(["-c", str(cfg_path), "--max-epochs", "1", "--no-wandb",
                         "--num-workers", "4", "--seed", str(TRAIN_SEED), "--device", "cuda:0",
                         *extra])
    torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0, "launches": kernels_mod.launch_counts(),
           "split_launches": kernels_mod.split_launch_counts(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if result["total_step"] != steps:
        raise RuntimeError(f"{cfg_path.name}: {result['total_step']} steps, expected {steps}")
    if process_rank() == 0:
        run_dir = Path(json.loads(cfg_path.read_text())["run_dir"])
        rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        out["losses"] = [{k: v for k, v in r.items() if k.startswith(("train/", "val/"))
                          and k != "train/step"} for r in rows
                         if "train/loss_total" in r or "val/loss_total" in r]
    return out


def mp_f32_step(torch, kind: str | None, adv: bool) -> dict:
    """One f32 ``conv_kernel`` train step of the flagship at 256² b8 from the
    seeded init (the generator step, or with ``adv`` the adversarial one with
    ``config/vae_dente_2.json``'s PatchGAN), the batch and the posterior noise
    drawn alike on every rank: under a ``kind`` mesh of the active group this
    rank's tile or blocks. The loss terms, and the whole parameters after."""
    from pti_ldm_vae_tpu_torch.checkpoint.manager import whole_state
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from pti_ldm_vae_tpu_torch.parallel.spatial import spatial_split
    from pti_ldm_vae_tpu_torch.parallel.tensor import tensor_parallel_params
    from pti_ldm_vae_tpu_torch.train.state import create_train_state
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_train_step

    train = load_config(ADV_CONFIG if adv else CONFIG)["autoencoder_train"]
    ae_def = load_config(CONFIG)["autoencoder_def"]
    if kind is not None:
        make_mesh(kind, MP_MODEL)
    try:
        torch.manual_seed(TRAIN_SEED)
        model = autoencoder_from_config(ae_def, conv_kernel=True).to(
            device="cuda", memory_format=torch.channels_last)
        disc = PatchDiscriminator(num_layers_d=3, channels=32, generator=torch.Generator()
                                  .manual_seed(TRAIN_SEED + 1)).to(
            device="cuda", memory_format=torch.channels_last) if adv else None
        if kind == "tensor":
            for module in (model, disc):
                if module is not None:
                    tensor_parallel_params(module)
        state = create_train_state(model, lr=MP_LR, model_d=disc)
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.rand(BATCH, IMAGE, IMAGE, 1, device="cuda", generator=gen)
        if kind == "spatial":
            x = spatial_split(x).contiguous()
        lcfg = LossConfig(recon_loss=train.get("recon_loss", "l1"),
                          kl_weight=float(train["kl_weight"]),
                          perceptual_weight=float(train["perceptual_weight"]),
                          adv_weight=float(train.get("adv_weight", 0.5)))
        _, metrics = make_train_step(model, disc, lcfg, adv_active=adv)(
            state, x, torch.ones(BATCH, device="cuda"), None, init_lpips_params(0, "cuda"),
            generator=gen)
        whole = whole_state(state)
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "params": whole["model_g"], "params_d": whole.get("model_d")}
    finally:
        set_mesh(None)


def mp_compare(torch, ae_def: dict, single: dict, sharded: dict) -> dict:
    """An f32 step under a mesh against the one-process step from the same
    weights, batch and noise: the loss terms within ``DDP_LOSS_BAR``
    relative; the parameters' changes from their init within 2 lr everywhere
    and within ``DDP_PARAM_BAR`` of their tensor's largest change on at least
    ``DDP_PARAM_SHARE`` of all entries (the ``ddp_path`` bars: an Adam step
    from a fresh state moves an entry by about lr x sign(g), see
    ``ddp_compare``; an entry that takes the other sign differs by 2 lr, plus
    the rounding of its own update); the discriminator's too."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator

    loss_err = max(abs(sharded["metrics"][k] - v) / max(abs(v), 1e-12)
                   for k, v in single["metrics"].items() if v)
    torch.manual_seed(TRAIN_SEED)
    inits = {"params": autoencoder_from_config(ae_def).state_dict()}
    if single["params_d"] is not None:
        inits["params_d"] = PatchDiscriminator(num_layers_d=3, channels=32, generator=torch.Generator()
                                               .manual_seed(TRAIN_SEED + 1)).state_dict()
    near = total = 0
    worst_step = 0.0
    for tag, init in inits.items():
        if sharded[tag].keys() != single[tag].keys():
            raise RuntimeError(f"{tag}: the whole parameters' keys differ from one process's")
        for k, w in single[tag].items():
            moved, got = w - init[k], sharded[tag][k] - init[k]
            worst_step = max(worst_step, float((got - moved).abs().max()) / (2 * MP_LR))
            near += int(((got - moved).abs() <= DDP_PARAM_BAR * float(moved.abs().max())).sum())
            total += moved.numel()
    share = near / total
    # 2 lr with 0.1% for the rounding of the parameters' own f32 update (as the CPU tests)
    if loss_err > DDP_LOSS_BAR or share < DDP_PARAM_SHARE or worst_step > 1.001:
        raise RuntimeError(f"loss rel err {loss_err}; parameters: {share} of the entries within "
                           f"the bar, worst change / (2 lr) {worst_step}")
    return {"loss_max_rel_err": loss_err, "param_share_within_bar": share,
            "param_worst_change_over_2lr": worst_step}


def mp_step(torch, side: int, kind: str | None, iters: int) -> dict:
    """One bf16 ``--conv-kernel`` generator step of the flagship at ``side``²
    b8 (``make_train_step``; under a ``kind`` mesh of the active group, this
    rank's tile or blocks): this process's peak GB over the step, and the
    CUDA-event ms of a step over ``iters`` steps after one."""
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from pti_ldm_vae_tpu_torch.parallel.spatial import spatial_split
    from pti_ldm_vae_tpu_torch.parallel.tensor import tensor_parallel_params
    from pti_ldm_vae_tpu_torch.train.state import create_train_state
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_train_step

    ae_def = load_config(CONFIG)["autoencoder_def"]
    if kind is not None:
        make_mesh(kind, MP_MODEL)
    try:
        torch.manual_seed(3)
        model = autoencoder_from_config(ae_def, compute_dtype=torch.bfloat16, conv_kernel=True).to(
            device="cuda", memory_format=torch.channels_last)
        if kind == "tensor":
            tensor_parallel_params(model)
        state = create_train_state(model, lr=2.5e-5)
        gen = torch.Generator(device="cuda").manual_seed(4)
        x = torch.randn(BATCH, side, side, 1, device="cuda", generator=gen)
        if kind == "spatial":
            x = spatial_split(x).contiguous()
        mask = torch.ones(BATCH, device="cuda")
        step = make_train_step(model, None, LossConfig(), adv_active=False)
        lp = init_lpips_params(0, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, x, mask, None, lp, generator=gen)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            step(state, x, mask, None, lp, generator=gen)
        end.record()
        end.synchronize()
        return {"peak_gb": peak, "step_event_ms": start.elapsed_time(end) / iters}
    finally:
        set_mesh(None)
        del state
        torch.cuda.empty_cache()


def mp_launches_check(name: str, kind: str, one: dict, run: dict) -> None:
    """Under spatial sharding every GroupNorm+SiLU takes the split entries
    (each forward call one statistics and one apply launch, each backward one
    reduce and one dx) and no fused launch; under tensor sharding a channel
    block holds whole groups, so the fused kernels launch as in one process.
    The other kernels launch as in one process."""
    want = dict(one["launches"])
    if kind == "spatial":
        want_split = {"groupnorm_silu_split_stats": want["groupnorm_silu"],
                      "groupnorm_silu_split_apply": want["groupnorm_silu"],
                      "groupnorm_silu_split_bwd_reduce": want["groupnorm_silu_bwd"],
                      "groupnorm_silu_split_bwd_dx": want["groupnorm_silu_bwd"]}
        want["groupnorm_silu"] = want["groupnorm_silu_bwd"] = 0
    else:
        want_split = dict.fromkeys(MP_SPLIT_ENTRIES, 0)
    got, split = run["launches"], dict(run["split_launches"])
    streamed = split.pop("conv3x3_stream")  # a share of conv3x3's launches, as in one process
    if (got != want or split != want_split or streamed != one["split_launches"]["conv3x3_stream"]
            or (kind == "spatial" and not all(split.values()))):
        raise RuntimeError(f"{name}: launches {got} {split}, expected {want} {want_split}")


def mp_child(spec_path: str, rank_arg: str) -> int:
    """``chip_smoke.py --mp-child SPEC RANK``: one of the two processes of
    phase ``model_parallel_path``. Rank 0 first checks and times the four
    split GroupNorm+SiLU entries at the flagship's per-shard shapes, then runs
    the one-process runs the sharded ones are held to: ``train_vae`` bf16
    ``--conv-kernel`` on the flagship (2 steps at b8, ``vae_dente_no_adv``)
    and on ``vae_dente_2`` (one adversarial step), the f32 generator and
    adversarial steps, and bf16 steps at 256² and 512² b8 (peak GB, event
    ms). Both ranks then start a gloo group of two on the one card and run
    each of those under ``{"spatial": 2}`` and ``{"tensor": 2}`` (the 512²
    step under spatial only). Rank 0 holds the f32 steps to the one-process
    ones at the ``ddp_path`` bars, the bf16 runs' logged losses within
    ``MP_BF16_LOSS_BAR`` of the one-process run's, and every run's launch
    counts (``mp_launches_check``), and writes the results beside ``SPEC``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.ops import kernels as kernels_mod

    spec = json.loads(Path(spec_path).read_text())
    global T0
    T0 -= spec["t"]
    rank = int(rank_arg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    ae_def = load_config(CONFIG)["autoencoder_def"]
    cfgs = {k: Path(v) for k, v in spec["cfg"].items()}

    def runs(kind: str | None) -> dict:
        """The CLI runs, the f32 steps and the timed bf16 steps of one form."""
        tag = kind or "single"
        return {
            "train_vae": {run: mp_train(torch, kernels_mod, cfgs[f"{run}_{tag}"], extra, steps)
                          for run, (_, extra, steps) in MP_RUNS.items()},
            "f32_step": {name: mp_f32_step(torch, kind, adv)
                         for name, adv in (("generator", False), ("adversarial", True))},
            "bf16_step": {str(side): mp_step(torch, side, kind, MP_STEP_ITERS)
                          for side in MP_STEP_SIDES if kind != "tensor" or side == IMAGE},
        }

    out: dict = {}
    if rank == 0:
        shapes = mp_shard_shapes(gn_path_shapes(autoencoder_from_config(ae_def), torch))
        out["split_errs"] = mp_split_checks(torch, shapes)
        emit("model_parallel_path", part="split_checks", shapes=[list(s) for s, _ in shapes],
             max_abs_err=out["split_errs"])
        flush = torch.empty(128 * 2**20 // 4, device="cuda")
        out["split_timings"] = mp_split_timings(torch, shapes, flush)["totals"]
        del flush
        single = runs(None)
        emit("model_parallel_path", part="one_process",
             train_vae={run: {k: r[k] for k in ("wall_s", "launches", "peak_gb")}
                        for run, r in single["train_vae"].items()},
             bf16_step=single["bf16_step"])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{spec['port']}", rank=rank,
                            world_size=MP_MODEL)
    try:
        sharded = {kind: runs(kind) for kind in ("spatial", "tensor")}
    finally:
        dist.destroy_process_group()
    keep = ("wall_s", "launches", "split_launches", "peak_gb")
    out["sharded"] = {kind: {"train_vae": {run: {k: r[k] for k in keep}
                                           for run, r in res["train_vae"].items()},
                             "bf16_step": res["bf16_step"]} for kind, res in sharded.items()}
    if rank == 0:
        out["single"] = {"train_vae": {run: {k: r[k] for k in keep}
                                       for run, r in single["train_vae"].items()},
                         "bf16_step": single["bf16_step"]}
        compare = {}
        for kind, res in sharded.items():
            for run, r in res["train_vae"].items():
                one = single["train_vae"][run]
                mp_launches_check(f"train_vae {run} {kind}", kind, one, r)
                rows = list(zip(r["losses"], one["losses"]))
                if len(rows) != len(one["losses"]) or any(g.keys() != w.keys() for g, w in rows):
                    raise RuntimeError(f"train_vae {run} {kind}: logged rows differ")
                err = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for g, w in rows for k in w)
                if not err <= MP_BF16_LOSS_BAR:
                    raise RuntimeError(f"train_vae {run} {kind}: losses {err} relative from one "
                                       f"process's (bar {MP_BF16_LOSS_BAR})")
                compare[f"train_vae_{run}_{kind}"] = {"loss_max_rel_err": err}
            for name, step in res["f32_step"].items():
                compare[f"f32_{name}_{kind}"] = mp_compare(torch, ae_def,
                                                           single["f32_step"][name], step)
        out["compare"] = compare
        emit("model_parallel_path", part="sharded", compare=compare, runs=out["sharded"])
    (Path(spec["work"]) / f"mp_rank{rank}.json").write_text(json.dumps(out))
    return 0


def model_parallel_path(torch, np) -> dict:
    """Phase ``model_parallel_path``: the two processes of ``mp_child`` (rank 0
    and 1), started together and waited for; either failing fails the phase.
    Returns both ranks' results."""
    write_inputs(np, WORK / "mp_data" / "dente", MP_IMAGES)
    write_inputs(np, WORK / "mp_data_adv" / "dente", MP_ADV_IMAGES)
    cfgs = {}
    for run, (base, _, _) in MP_RUNS.items():
        for kind in ("single", "spatial", "tensor"):
            cfg = json.loads(base.read_text())
            adv = base == ADV_CONFIG
            cfg["data_base_dir"] = str(WORK / ("mp_data_adv" if adv else "mp_data"))
            cfg["run_dir"] = str(WORK / f"mp_run_{run}_{kind}")
            cfg["autoencoder_train"]["lr"] = MP_LR
            if adv:
                cfg["train_split"] = DDP_B_SPLIT
                cfg["autoencoder_train"]["adv_warmup_epochs"] = -1  # epoch 0 is adversarial
            if kind != "single":
                cfg["parallelism"] = {kind: MP_MODEL}
            cfgs[f"{run}_{kind}"] = str(WORK / f"mp_{run}_{kind}.json")
            Path(cfgs[f"{run}_{kind}"]).write_text(json.dumps(cfg))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    spec = {"work": str(WORK), "cfg": cfgs, "port": port, "t": time.perf_counter() - T0}
    (WORK / "mp_spec.json").write_text(json.dumps(spec))
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mp-child",
                               str(WORK / "mp_spec.json"), str(rank)]) for rank in (0, 1)]
    deadline = time.perf_counter() + MP_TIMEOUT_S
    try:
        # a rank that fails leaves the other waiting for it: stop at the first failure
        while (codes := [p.poll() for p in procs]) != [0, 0] and time.perf_counter() < deadline:
            if any(code not in (None, 0) for code in codes):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0, 0]:
        raise RuntimeError(f"model_parallel_path: the ranks exited with {codes}")
    return {rank: json.loads((WORK / f"mp_rank{rank}.json").read_text()) for rank in (0, 1)}


# ---- 1-D and 3-D models, PTI's vmap form (phases dims_path, pti_vmap) ------------------------

def dims_def(ae_def: dict, spatial_dims: int) -> dict:
    """The flagship's ``autoencoder_def`` at another spatial rank (widths,
    depth, groups, eps and both mid-block attentions as they are)."""
    return {**ae_def, "spatial_dims": spatial_dims}


def dims_gn_shapes(torch, ae_def: dict, side: int, batch: int) -> list[tuple[tuple[int, ...], int]]:
    """[(channel-last shape at ``batch`` and ``side``, launches per pass)] of
    every GroupNorm+SiLU of a reconstruct of ``ae_def`` (1-D or 3-D), recorded
    with forward hooks during a CPU reconstruct at side 8 (no launch) and
    scaled to ``side`` (every level's side is the input's over a power of 2)."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import GroupNormOp, autoencoder_from_config

    model = autoencoder_from_config(ae_def)
    sd, probe = ae_def["spatial_dims"], 8
    counts: dict[tuple[int, ...], int] = {}

    def hook(module, args):
        if module.silu:
            spatial = tuple(s * side // probe for s in args[0].shape[1:-1])
            shape = (batch, *spatial, args[0].shape[-1])
            counts[shape] = counts.get(shape, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, GroupNormOp)]
    try:
        with torch.inference_mode():
            model.reconstruct_deterministic(torch.zeros(1, *(probe,) * sd, 1))
    finally:
        for h in handles:
            h.remove()
    return sorted(counts.items(), key=lambda kv: -math.prod(kv[0]))


def rank4(shape: tuple[int, ...]) -> tuple[int, ...]:
    """The rank-4 view the GroupNorm+SiLU kernels get of a channel-last shape
    (``ops/norm.py:rank4_view``): [B, D*H, W, C] or [B, 1, L, C]."""
    if len(shape) == 5:
        return (shape[0], shape[1] * shape[2], shape[3], shape[4])
    return (shape[0], 1, shape[1], shape[2]) if len(shape) == 3 else tuple(shape)


def dims_view_checks(torch, kernels_mod, shapes) -> dict:
    """``ops.norm.group_norm_silu`` on the 1-D / 3-D tensors of ``shapes``
    [(shape, groups)], forward and backward in both types, gives the bits of
    the kernels' own call on the rank-4 view (the reshape is all the port
    adds), one launch each way a call."""
    from pti_ldm_vae_tpu_torch.ops.norm import group_norm_silu, rank4_view

    gen = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    for shape, groups in shapes:
        c = shape[-1]
        x = torch.randn(shape, device="cuda", generator=gen)
        scale = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
        g = torch.randn(shape, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            xd, gd = x.to(dtype), g.to(dtype)
            leaves = [t.clone().requires_grad_() for t in (xd, scale, bias)]
            kernels_mod.reset_launch_counts()
            y = group_norm_silu(*leaves, num_groups=groups, eps=1e-6)
            grads = torch.autograd.grad(y, leaves, gd)
            counts = kernels_mod.launch_counts()
            view = [t.clone().requires_grad_() for t in (rank4_view(xd), scale, bias)]
            y4 = kernels_mod.groupnorm_silu(*view, groups, 1e-6)
            grads4 = torch.autograd.grad(y4, view, rank4_view(gd))
            same = (torch.equal(y, y4.reshape(shape)) and torch.equal(grads[0], grads4[0].reshape(shape))
                    and torch.equal(grads[1], grads4[1]) and torch.equal(grads[2], grads4[2]))
            if (counts["groupnorm_silu"], counts["groupnorm_silu_bwd"]) != (1, 1) or not same:
                raise RuntimeError(f"group_norm_silu on {shape} {dtype_key(dtype)}: launches "
                                   f"{counts}, bit-equal to the rank-4 call: {same}")
            out[f"{list(shape)} {dtype_key(dtype)}"] = list(rank4(shape))
        del x, g
    torch.cuda.empty_cache()
    return out


def vmap_rule_checks(torch, kernels_mod) -> dict:
    """Each kernel Function's ``torch.func.vmap`` rule on the card: ``vmap(f)``
    and ``vmap(grad)`` against a loop over the images through the same
    wrappers. GroupNorm+SiLU with shared scale / bias (fold: one launch each
    way a call) and per-image ones (one per image), flash attention (fold),
    the convolution with a shared matrix (fold: forward and input gradient one
    launch each) and a matrix per image (one per image); the filter gradient,
    a sum over each image's own batch, launches once per image in both.
    Outputs and input gradients at ``F32_TOL`` / ``BF16_TOL`` (a fold is a
    bigger batch, which may cut the work another way), parameter gradients
    (f32 sums) at rtol 1e-4 with atol 1e-4 of their largest entry; the
    per-image branch gives the loop's bits."""
    from torch.func import grad, vmap

    v = 4
    gen = torch.Generator(device="cuda").manual_seed(22)

    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    def gn(a, s, b):
        return kernels_mod.groupnorm_silu(a, s, b, 16, 1e-6)

    x = rnd(v, 1, 64, 64, 64)
    cases = {  # name: (fn, args, in_dims, launches of one vmap(fn) and one vmap(grad))
        "groupnorm_silu_fold": (gn, (x, 1 + 0.1 * rnd(64), 0.1 * rnd(64)), (0, None, None),
                                {"groupnorm_silu": 2, "groupnorm_silu_bwd": 1}),
        "groupnorm_silu_per_image": (gn, (x, 1 + 0.1 * rnd(v, 64), 0.1 * rnd(v, 64)), (0, 0, 0),
                                     {"groupnorm_silu": 2 * v, "groupnorm_silu_bwd": v}),
        "flash_attention_fold": (kernels_mod.flash_attention,
                                 tuple(rnd(v, 1, 1, 1024, 128) for _ in range(3)), (0, 0, 0),
                                 {"flash_attention": 2, "flash_attention_bwd": 1}),
        "conv3x3_fold": (kernels_mod.conv3x3, (x, 0.05 * rnd(576, 64)), (0, None),
                         {"conv3x3": 3, "conv3x3_wgrad": v}),
        "conv3x3_per_image": (kernels_mod.conv3x3, (x, 0.05 * rnd(v, 576, 64)), (0, 0),
                              {"conv3x3": 3 * v, "conv3x3_wgrad": v}),
    }
    out = {}
    for name, (fn, args, dims, want_launches) in cases.items():
        params = () if name.startswith("flash") else tuple(range(1, len(args)))
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            # activations in dtype; GroupNorm's affine and the convolution's matrix stay f32
            targs = [a if i in params else a.to(dtype) for i, a in enumerate(args)]
            one = fn(*(a if d is None else a[0] for a, d in zip(targs, dims)))
            g = rnd(v, *one.shape).to(dtype)

            def loss(*a, _fn=fn):
                return (_fn(*a[:-1]).float() * a[-1].float()).sum()

            argnums = tuple(range(len(targs)))
            kernels_mod.reset_launch_counts()
            got = vmap(fn, in_dims=dims)(*targs)
            got_grads = vmap(grad(loss, argnums=argnums), in_dims=(*dims, 0))(*targs, g)
            torch.cuda.synchronize()
            launches = {k: n for k, n in kernels_mod.launch_counts().items() if n}
            want = torch.stack([fn(*(a if d is None else a[i] for a, d in zip(targs, dims)))
                                for i in range(v)])
            loop = []
            for i in range(v):
                leaves = [(a if d is None else a[i]).clone().requires_grad_()
                          for a, d in zip(targs, dims)]
                loop.append(torch.autograd.grad(loss(*leaves, g[i]), leaves))
            errs = [check_close(f"{name} vmap {dtype_key(dtype)}", got, want, tol)]
            for j, got_g in enumerate(got_grads):
                want_g = torch.stack([lg[j] for lg in loop])
                bar = (dict(rtol=1e-4, atol=1e-4 * float(want_g.abs().max())) if j in params
                       else tol)
                errs.append(check_close(f"{name} vmap grad {j} {dtype_key(dtype)}", got_g, want_g,
                                        bar))
            if launches != want_launches:
                raise RuntimeError(f"{name} {dtype_key(dtype)} under vmap launched {launches}, "
                                   f"expected {want_launches}")
            if "per_image" in name and not torch.equal(got, want):
                raise RuntimeError(f"{name} {dtype_key(dtype)}: the per-image branch is not the "
                                   "loop's bits")
            out[f"{name} {dtype_key(dtype)}"] = {"max_abs_err": max(errs), "launches": launches}
    torch.cuda.empty_cache()
    return out


def dims_model(torch, ae_def: dict, weights: Path, dtype, device: str):
    """The 1-D / 3-D flagship from its seeded weights (``make_weights``), in
    ``dtype`` compute on ``device`` (channel-last memory)."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import (
        autoencoder_from_config,
        channels_last_format,
    )

    model = autoencoder_from_config(ae_def, compute_dtype=dtype)
    model.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True), strict=True)
    return model.to(device=device, memory_format=channels_last_format(ae_def["spatial_dims"]))


def dims_reconstruct(torch, kernels_mod, model, x) -> tuple[object, dict]:
    """One reconstruct on the card: (output, launches), the launches held to
    a flagship pass's (42 GroupNorm+SiLU on rank-4 views, 2 flash)."""
    kernels_mod.reset_launch_counts()
    with torch.inference_mode():
        y = model.reconstruct_deterministic(x)
    torch.cuda.synchronize()
    launches = kernels_mod.launch_counts()
    want = expected_launches(0, 1, conv_kernel=False)
    if launches != want or y.shape != x.shape or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"{model.spatial_dims}-D reconstruct: launches {launches} (expected "
                           f"{want}), shape {tuple(y.shape)}")
    return y, launches


def dims_step_check(torch, kernels_mod, ae_def: dict, weights: Path, side: int) -> dict:
    """The 3-D flagship's f32 generator step (L1 + KL + fake-3D LPIPS) and its
    adversarial step (the 3-D PatchGAN the trainer builds) at b2 x ``side``³,
    card against the CPU plain path, same weights, volumes and eps, with the
    bars of ``adv_train_reference_check``: loss terms 1e-4 relative; the
    generator's gradient without the adversarial term and the
    discriminator's on one shared reconstruction within 2e-3 of each
    tensor's largest entry; the whole generator's and the discriminator's on
    its own reconstruction within 2e-2 (the LeakyReLU kinks, ROADMAP C).
    Launches of the generator pass: one flagship forward and backward."""
    from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, _discriminator_loss, _generator_losses

    cpu_model = dims_model(torch, ae_def, weights, torch.float32, "cpu")
    gpu_model = dims_model(torch, ae_def, weights, torch.float32, "cuda")
    cpu_disc = PatchDiscriminator(spatial_dims=3, generator=torch.Generator().manual_seed(10))
    gpu_disc = copy.deepcopy(cpu_disc).to(device="cuda", memory_format=torch.channels_last_3d)
    lcfg = LossConfig(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0, adv_weight=3.0)
    gen = torch.Generator().manual_seed(23)
    images = torch.rand(DIMS_BATCH, side, side, side, 1, generator=gen)
    mask = torch.ones(DIMS_BATCH)
    lat = side // 2 ** (len(ae_def["channels"]) - 1)
    eps = torch.randn(DIMS_BATCH, lat, lat, lat, ae_def["latent_channels"], generator=gen)

    def disc_grads(disc, recon, x, m):
        d_loss = _discriminator_loss(disc, recon, x, m)
        grads = torch.autograd.grad(lcfg.adv_weight * d_loss, list(disc.parameters()))
        return d_loss.detach(), {k: g.cpu() for (k, _), g in zip(disc.named_parameters(), grads)}

    def one(model, disc, device, shared_recon, counts: dict):
        lp = init_lpips_params(0, device)
        x, m = images.to(device), mask.to(device)
        params = list(model.parameters())
        names = [k for k, _ in model.named_parameters()]
        kernels_mod.reset_launch_counts()
        total_g, aux_g = _generator_losses(model, lcfg, lp, x, m, eps.to(device), None)
        plain = torch.autograd.grad(total_g, params)
        if device == "cuda":
            torch.cuda.synchronize()
            counts.update(kernels_mod.launch_counts())
        total, aux = _generator_losses(model, lcfg, lp, x, m, eps.to(device), None, disc)
        whole = torch.autograd.grad(total, params)
        d_loss, d_grads = disc_grads(disc, aux["recon"], x, m)
        terms = {k: float(aux[k].detach()) for k in
                 ("recon_loss", "kl_loss", "perceptual_loss", "adv_gen_loss")}
        terms.update(loss_total=float(total.detach()), adv_disc_loss=float(d_loss),
                     generator_loss_total=float(total_g.detach()))
        grads = {
            "generator_step": {k: g.cpu() for k, g in zip(names, plain)},
            "adversarial_generator": {k: g.cpu() for k, g in zip(names, whole)},
            "discriminator": d_grads,
            "discriminator_on_shared_reconstruction": disc_grads(
                disc, (aux["recon"].detach() if shared_recon is None else shared_recon).to(device),
                x, m)[1],
        }
        return terms, grads, aux["recon"].detach().cpu()

    want_terms, want_grads, cpu_recon = one(cpu_model, cpu_disc, "cpu", None, {})
    per_step: dict[str, int] = {}
    got_terms, got_grads, _ = one(gpu_model, gpu_disc, "cuda", cpu_recon, per_step)
    want = expected_launches(1, 0, conv_kernel=False)
    if per_step != want:
        raise RuntimeError(f"3-D generator step launched {per_step}, expected {want}")
    term_err = {k: abs(got_terms[k] - v) / abs(v) for k, v in want_terms.items()}
    bars = {"generator_step": GRAD_BAR, "adversarial_generator": ADV_GRAD_BAR,
            "discriminator": ADV_GRAD_BAR, "discriminator_on_shared_reconstruction": GRAD_BAR}
    worst = {}
    for group, refs in want_grads.items():
        errs = {}
        for key, ref in refs.items():
            err = float((got_grads[group][key] - ref).abs().max())
            errs[key] = err if key.endswith("to_k.bias") else err / float(ref.abs().max())
        key = max(errs, key=errs.get)
        worst[group] = {"tensor": key, "err_of_tensor_max": errs[key], "bar": bars[group]}
    result = {"batch": DIMS_BATCH, "side": side, "terms_card": got_terms, "terms_cpu": want_terms,
              "max_term_rel_err": max(term_err.values()), "term_bar": 1e-4,
              "worst_gradient": worst, "launches_per_generator_step": per_step}
    if not max(term_err.values()) <= 1e-4:
        raise RuntimeError(f"3-D f32 CUDA loss terms differ from the CPU plain path: {term_err}")
    for group, w in worst.items():
        if not w["err_of_tensor_max"] <= w["bar"]:
            raise RuntimeError(f"3-D f32 CUDA {group} gradient {w['tensor']} differs from the CPU "
                               f"by {w['err_of_tensor_max']} of its largest entry (bar {w['bar']})")
    return result


def dims_path(torch, np, kernels_mod, ae_def: dict) -> dict:
    """Phase ``dims_path``: the flagship's widths at ``spatial_dims`` 3 and 1.

    3-D: kernel checks at the GroupNorm+SiLU shapes of a b2 x 64³ pass, as the
    rank-4 views the kernels get, and flash at [2, 1, 512, 128] (the mid
    blocks' 8³ tokens), both types; the 5-D calls bit-equal to the kernels'
    rank-4 ones; reconstructs in bf16 and f32 at b2 x 64³ (launch counts); an
    f32 reconstruct at b2 x 32³ against the CPU (1e-3); the f32 generator and
    adversarial steps at b2 x 32³ against the CPU (``dims_step_check``).
    1-D: the same kernel checks at a b2 x 4096 signal's shapes and flash
    [2, 1, 512, 128], a bf16 and an f32 reconstruct, the f32 one against the
    CPU (1e-3). Returns the launches by run and the kernel errors."""
    both = (torch.float32, torch.bfloat16)
    out: dict = {"launches": {}}
    errs = None
    for sd, side in ((3, DIMS_SIDE), (1, DIMS_SIGNAL)):
        d_def = dims_def(ae_def, sd)
        shapes = dims_gn_shapes(torch, d_def, side, DIMS_BATCH)
        if sum(n for _, n in shapes) != GN_PER_RECONSTRUCT:
            raise RuntimeError(f"{sd}-D GroupNorm+SiLU shapes {shapes}")
        views = [(rank4(s), n) for s, n in shapes]
        e = check_kernels(torch, [(s, 16, both) for s, _ in views], (DIMS_FLASH_SHAPE,), [],
                          kernels_mod, seed=20 + sd, ragged=False, phase=f"dims_kernel_checks_{sd}d")
        errs = e if errs is None else {k: {t: max(x, e[k][t]) for t, x in by_t.items()}
                                       for k, by_t in errs.items()}
        emit("dims_view_checks", spatial_dims=sd,
             views=dims_view_checks(torch, kernels_mod, [(s, 16) for s, _ in shapes]))
        weights = WORK / f"vae_{sd}d_random.pth"
        make_weights(torch, d_def, weights)
        gen = torch.Generator(device="cuda").manual_seed(24)
        x = torch.rand(DIMS_BATCH, *(side,) * sd, 1, device="cuda", generator=gen)
        for dtype in both:
            model = dims_model(torch, d_def, weights, dtype, "cuda")
            _, launches = dims_reconstruct(torch, kernels_mod, model, x)
            out["launches"][f"dims_{sd}d_reconstruct_{dtype_key(dtype)}"] = launches
            del model
        ref_side = DIMS_REF_SIDE if sd == 3 else side
        xr = x[(slice(None), *(slice(0, ref_side),) * sd)].contiguous()
        gpu = dims_model(torch, d_def, weights, torch.float32, "cuda")
        got, _ = dims_reconstruct(torch, kernels_mod, gpu, xr)
        with torch.inference_mode():
            want = dims_model(torch, d_def, weights, torch.float32, "cpu").reconstruct_deterministic(
                xr.cpu())
        err = float((got.cpu() - want).abs().max())
        emit("dims_path", spatial_dims=sd, batch=DIMS_BATCH, side=side, reference_side=ref_side,
             gn_shapes=[[list(s), n] for s, n in shapes], gn_views=[[list(s), n] for s, n in views],
             flash_shape=list(DIMS_FLASH_SHAPE), max_abs_err_f32_vs_cpu=err, bar=1e-3,
             launches={k: v for k, v in out["launches"].items() if k.startswith(f"dims_{sd}d")})
        if not err <= 1e-3:
            raise RuntimeError(f"{sd}-D f32 reconstruct differs from the CPU by {err}")
        del gpu
        torch.cuda.empty_cache()
        if sd == 3:
            step = dims_step_check(torch, kernels_mod, d_def, weights, DIMS_REF_SIDE)
            out["launches"]["dims_3d_generator_step_f32"] = step["launches_per_generator_step"]
            emit("dims_train_reference", spatial_dims=3, **step)
            out["weights_3d"] = str(weights)
            torch.cuda.empty_cache()
    out["errs"] = errs
    return out


def pti_vmap_path(torch, np, kernels_mod, ckpt: Path) -> dict:
    """Phase ``pti_vmap``: ``run_pti --tune-formulation vmap`` on the seeded
    flagship checkpoint at 256², b8, ``PTI_VMAP_STEPS`` (latent, tune) steps,
    in bf16, f32 and bf16 with ``--conv-kernel`` (launch counts with stage 2's
    flash folded, GroupNorm+SiLU and convolutions once per image), beside
    ``--tune-formulation scan`` on the same inputs in bf16: the written
    pivots must be the scan run's (one stage-1 program). Then both forms'
    programs on two images in f32 on the card (launches; pivots within
    ``PTI_PIVOT_BAR``, losses 1e-4 relative), and stage 2 of both forms from
    one set of pivots, held to each other with ``pti_reference_check``'s
    bars: losses 1e-4 relative, tuned tensors ``PTI_TUNED_BAR`` of their
    change where the first gradient is outside its rounding, Adam's 2 lr a
    step everywhere (from each program's own pivots the pivots' spread under
    cuDNN's f32 algorithms would be compared, not the form)."""
    from pti_ldm_vae_tpu_torch.train.diffusion import (
        _tune,
        _tune_vmap,
        decoder_parameters,
        make_pivotal_tuning_inversion_batched,
    )
    from pti_ldm_vae_tpu_torch.utils.cli_common import load_config_and_model

    cli = ["-c", str(CONFIG), "--checkpoint", str(ckpt), "--input-dir", str(WORK / "data"),
           "--num-workers", "4"]
    runs = {}
    for key, extra, conv in (("vmap_b8", ["--tune-formulation", "vmap"], False),
                             ("vmap_b8_f32", ["--tune-formulation", "vmap", "--f32"], False),
                             ("vmap_b8_conv_kernel", ["--tune-formulation", "vmap", "--conv-kernel"],
                              True),
                             ("scan_b8", [], False)):
        runs[key] = run_pti_cli(torch, np, kernels_mod, cli + extra, WORK / f"pti_{key}", BATCH,
                                BATCH, conv, steps=PTI_VMAP_STEPS)
        emit("pti_vmap", run=key, latent_steps=PTI_VMAP_STEPS[0], tune_steps=PTI_VMAP_STEPS[1],
             **runs[key])
        torch.cuda.empty_cache()
    pivot_err = 0.0
    for path in sorted((WORK / "pti_scan_b8").glob("*_pivot.npz")):
        want = np.load(path)
        got = np.load(WORK / "pti_vmap_b8" / path.name)
        pivot_err = max(pivot_err, float(np.abs(got["latent"] - want["latent"]).max()
                                         / np.abs(want["latent"]).max()))

    # both programs in f32 on two images (cuDNN's deterministic algorithms: the two stage-1
    # runs then give the same pivots), then stage 2 of both forms from one set of pivots
    steps, latent_lr, tune_lr = PTI_REFERENCE_STEPS, 1e-1, 1e-4
    _, model = load_config_and_model(str(CONFIG), str(ckpt), device=torch.device("cuda"), exact=True)
    gen = torch.Generator(device="cuda").manual_seed(25)
    images = torch.rand(2, IMAGE, IMAGE, 1, device="cuda", generator=gen)
    with torch.no_grad():
        z0 = model.encode_deterministic(images)
    start = {k: v.detach().clone() for k, v in decoder_parameters(model).items()}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        forms = {}
        for form in ("scan", "vmap"):
            program = make_pivotal_tuning_inversion_batched(
                model, latent_steps=steps, latent_lr=latent_lr, tune_steps=steps, tune_lr=tune_lr,
                tune_formulation=form)
            kernels_mod.reset_launch_counts()
            pivots, _, losses = program(images, z0)
            torch.cuda.synchronize()
            forms[form] = (pivots, losses, kernels_mod.launch_counts())
        pivots = forms["scan"][0]
        scan = [_tune(model, images[i:i + 1], pivots[i:i + 1], start, steps, tune_lr)
                for i in range(2)]
        with torch.no_grad():
            for name, p in decoder_parameters(model).items():
                p.copy_(start[name])
        s_tuned = {k: torch.stack([t[0][k] for t in scan]) for k in start}
        s_loss = torch.stack([t[1] for t in scan])
        v_tuned, v_loss = _tune_vmap(model, images, pivots, steps, tune_lr)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want_launches = expected_pti_launches(0, steps, 2 * steps, 0, False, steps)
    if forms["vmap"][2] != want_launches:
        raise RuntimeError(f"vmap program launched {forms['vmap'][2]}, expected {want_launches}")
    params = decoder_parameters(model)
    for p in params.values():  # the loader freezes an inference model
        p.requires_grad_(True)
    g_tune = []
    for i in range(2):
        loss = (model.decode(pivots[i:i + 1]) - images[i:i + 1]).square().mean()
        g_tune.append(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
    for p in params.values():
        p.requires_grad_(False)
    loss_err = max(float(((forms["vmap"][1][k] - forms["scan"][1][k]).abs()
                          / forms["scan"][1][k].abs()).max()) for k in ("latent", "tune"))
    loss_err = max(loss_err, float(((v_loss - s_loss).abs() / s_loss.abs()).max()))
    prog_pivot_err = float((forms["vmap"][0] - pivots).abs().max()) / float(pivots.abs().max())
    tuned_err, adam_err, n_firm, n_all = {}, {}, 0, 0
    for key, ref in s_tuned.items():
        for i in range(2):
            diff = (v_tuned[key][i] - ref[i]).abs()
            adam_err[key] = max(adam_err.get(key, 0.0), float(diff.max()) / (2 * tune_lr * steps))
            if key.endswith("to_k.bias"):
                continue
            g = g_tune[i][key].abs()
            mask = g > GRAD_BAR * g.max()
            n_firm, n_all = n_firm + int(mask.sum()), n_all + mask.numel()
            change = float((ref[i] - start[key]).abs().max())
            if mask.any():
                tuned_err[key] = max(tuned_err.get(key, 0.0), float(diff[mask].max()) / change)
    worst = max(tuned_err, key=tuned_err.get)
    worst_adam = max(adam_err, key=adam_err.get)
    emit("pti_vmap_reference", images=2, steps=steps, cli_pivot_err_of_max=pivot_err,
         pivot_err_of_max=prog_pivot_err, pivot_bar=PTI_PIVOT_BAR, max_loss_rel_err=loss_err,
         loss_bar=1e-4, tuned_err_of_change=tuned_err[worst], worst_tensor=worst,
         tuned_bar=PTI_TUNED_BAR, tuned_firm_share=n_firm / n_all,
         worst_of_adam_bound=adam_err[worst_adam], worst_of_adam_bound_tensor=worst_adam,
         launches={form: f[2] for form, f in forms.items()})
    if not (max(pivot_err, prog_pivot_err) <= PTI_PIVOT_BAR and loss_err <= 1e-4
            and tuned_err[worst] <= PTI_TUNED_BAR and adam_err[worst_adam] <= 1.0):
        raise RuntimeError(f"PTI vmap against scan: pivots {pivot_err} / {prog_pivot_err}, losses "
                           f"{loss_err}, tuned {worst} {tuned_err[worst]}, {worst_adam} "
                           f"{adam_err[worst_adam]} of the Adam bound")
    del model
    torch.cuda.empty_cache()
    return {f"run_pti_{key}": r["launches"] for key, r in runs.items()}


def dims_timings(torch, ae_def: dict, weights_3d: Path, ckpt: Path, flush) -> None:
    """Phases ``dims_b2`` and ``pti_vmap_b8`` (timings, no claim): the 3-D
    flagship's bf16 generator step (L1 + KL + fake-3D LPIPS, Adam) at
    b2 x 64³; one PTI stage-2 step of eight 256² images in bf16 in each form
    (``scan``: eight batch-1 steps; ``vmap``: one step on eight decoder
    copies). Event ms, device ms, idle share and peak GB each."""
    from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
    from pti_ldm_vae_tpu_torch.train.diffusion import _tune, _tune_vmap, decoder_parameters
    from pti_ldm_vae_tpu_torch.train.state import create_train_state
    from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_train_step
    from pti_ldm_vae_tpu_torch.utils.cli_common import load_config_and_model

    torch.cuda.reset_peak_memory_stats()
    model = dims_model(torch, dims_def(ae_def, 3), weights_3d, torch.bfloat16, "cuda")
    state = create_train_state(model, lr=2.5e-5)
    gen = torch.Generator(device="cuda").manual_seed(26)
    x = torch.rand(DIMS_BATCH, DIMS_SIDE, DIMS_SIDE, DIMS_SIDE, 1, device="cuda", generator=gen)
    mask = torch.ones(DIMS_BATCH, device="cuda")
    lp = init_lpips_params(0, "cuda")
    step = make_train_step(model, None, LossConfig(), adv_active=False)
    t = time_ms(lambda: step(state, x, mask, None, lp, generator=gen), flush, iters=4, warmup=2,
                trace_iters=2)
    emit("dims_b2", path="train_step", spatial_dims=3, dtype="bfloat16", batch=DIMS_BATCH,
         side=DIMS_SIDE, event_ms=t["event_ms"], device_ms=t["device_ms"],
         device_idle_share=1.0 - t["device_ms"] / t["event_ms"],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         device_ms_by_kind=device_ms_by_kind(t["by_name"]))
    del model, state, step
    torch.cuda.empty_cache()
    _, model = load_config_and_model(str(CONFIG), str(ckpt), device=torch.device("cuda"))
    xs = torch.rand(BATCH, IMAGE, IMAGE, 1, device="cuda", generator=gen)
    with torch.no_grad():
        z0 = model.encode_deterministic(xs)
    start = {k: v.detach().clone() for k, v in decoder_parameters(model).items()}
    n = 2
    forms = {
        "scan": lambda: [_tune(model, xs[i:i + 1], z0[i:i + 1], start, n, 1e-4)
                         for i in range(BATCH)],
        "vmap": lambda: _tune_vmap(model, xs, z0, n, 1e-4),
    }
    for form, fn in forms.items():
        torch.cuda.reset_peak_memory_stats()
        r = time_ms(fn, flush, iters=2, warmup=1, trace_iters=1)
        emit("pti_vmap_b8", form=form, dtype="bfloat16", images=BATCH,
             event_ms_per_step=r["event_ms"] / n, device_ms_per_step=r["device_ms"] / n,
             device_idle_share=1.0 - r["device_ms"] / r["event_ms"],
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             device_ms_by_kind=device_ms_by_kind({k: v / n for k, v in r["by_name"].items()}))
        torch.cuda.empty_cache()
    with torch.no_grad():  # _tune leaves the last image's values in the model
        for name, p in decoder_parameters(model).items():
            p.copy_(start[name])


def dims_timings_child(spec_path: str) -> int:
    """``chip_smoke.py --dims-timings SPEC``: ``dims_timings`` in a process of
    its own (see ``timings_child``), started by ``main`` after the
    ``dims_path`` and ``pti_vmap`` phases; the phases' lines to stdout."""
    import torch

    sys.path.insert(0, str(ROOT))
    from pti_ldm_vae_tpu_torch.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    global T0
    T0 -= spec["t"]
    flush = torch.empty(32 * 2**20, device="cuda", dtype=torch.float32)
    dims_timings(torch, load_config(CONFIG)["autoencoder_def"], Path(spec["weights_3d"]),
                 Path(spec["ckpt"]), flush)
    return 0


COMPARISON_PAIRS = 16
COMPARISON_AXIS_ALIGNED = (0, 5, 10, 15)  # the pairs drawn at 0 degrees


def write_comparison_inputs(np, root: Path) -> Path:
    """16 seeded ``edente`` / ``edente_synth`` TIF pairs at 256², the flagship's
    patch size: a filled ellipse (GT: 1 with 2% noise, background exactly 0;
    synthesis: a slightly different ellipse at 0.9 with noise, faint noise
    below the 0.2 threshold everywhere and a bright 5x5 speck that the
    largest-contour cleaning removes), at a random angle within +-20 degrees
    but for the axis-aligned pairs. Returns the ``edente`` folder."""
    from pti_ldm_vae_tpu_torch.data.io import write_tif

    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:IMAGE, 0:IMAGE].astype(np.float64)

    def ellipse(cx, cy, a, b, deg):
        t = np.deg2rad(deg)
        u = (xx - cx) * np.cos(t) + (yy - cy) * np.sin(t)
        v = -(xx - cx) * np.sin(t) + (yy - cy) * np.cos(t)
        return ((u / a) ** 2 + (v / b) ** 2 <= 1.0).astype(np.float32)

    for sub in ("edente", "edente_synth"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(COMPARISON_PAIRS):
        deg = 0.0 if i in COMPARISON_AXIS_ALIGNED else float(rng.uniform(-20, 20))
        a, b = rng.uniform(40, 55), rng.uniform(82, 96)
        cx, cy = 128 + rng.uniform(-6, 6), 134 + rng.uniform(-4, 4)
        gt = ellipse(cx, cy, a, b, deg)
        gt *= (1 + 0.02 * rng.standard_normal(gt.shape)).astype(np.float32)
        shifted = deg if i in COMPARISON_AXIS_ALIGNED else deg + rng.uniform(-4, 4)
        pred = 0.9 * ellipse(cx + rng.uniform(-4, 4), cy + rng.uniform(-3, 3),
                             a * rng.uniform(0.9, 1.1), b * rng.uniform(0.92, 1.05), shifted)
        pred += 0.03 * rng.standard_normal(pred.shape) * (pred > 0)
        pred += rng.uniform(-0.1, 0.1, pred.shape)
        pred[10:15, 10:15] = 0.5
        write_tif(str(root / "edente" / f"pair_{i:02d}.tif"), gt.astype(np.float32))
        write_tif(str(root / "edente_synth" / f"pair_{i:02d}.tif"), pred.astype(np.float32))
    return root / "edente"


def image_comparison_path(torch, np, kernels_mod, work: Path) -> dict:
    """Phase 6t: the comparison suite on the card and the CPU (see the module
    docstring). The features and the three runs see TF32 allowed, PyTorch's
    default and so a user's process: VGG16 turns it off for its own
    convolutions. Returns the kernel checks' errors, the convolution launches
    of the ``conv_kernel`` run, VGG16's distinct convolution shapes with their
    calls a feature vector, the VGG16 forward times and each run's seconds a
    pair and host share."""
    import torch.nn.functional as F

    from pti_ldm_vae_tpu_torch.analysis.metrics import (
        VGG_SIZE,
        ImageComparison,
        vgg16_conv_shapes,
        vgg16_features_fn,
        vgg16_input,
    )
    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import _launch_forward

    os.environ["PTI_VGG16_WEIGHTS"] = "none"  # no VGG16 weights ship: the seeded init
    shutil.rmtree(work, ignore_errors=True)
    folder = write_comparison_inputs(np, work)
    shapes = vgg16_conv_shapes()
    distinct = sorted(set(shapes), key=shapes.index)
    errs = check_kernels(torch, [], (), [(s, shapes.count(s)) for s in distinct], kernels_mod,
                         seed=3, ragged=False, phase="kernel_checks_vgg16")
    # each layer's f32 output, the kernel's against cuDNN's (TF32 off) on the same random
    # inputs: how many entries differ, and by how much
    gen = torch.Generator(device="cuda").manual_seed(5)
    layers = []
    for b, h, w, cin, cout in distinct:
        x, wmat, _ = conv_inputs(torch, (b, h, w, cin, cout), gen)
        w_lib = (wmat.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
                 .contiguous(memory_format=torch.channels_last))
        got = _launch_forward(x, wmat)
        want = F.conv2d(x.permute(0, 3, 1, 2), w_lib, padding=1).permute(0, 2, 3, 1)
        layers.append({"shape": [b, h, w, cin, cout], "entries": got.numel(),
                       "differ": int((got != want).sum()),
                       "max_abs_diff": float((got - want).abs().max())})
    emit("vgg16_kernel_vs_cudnn", layers=layers, card=card_line())

    # one image's features: cuDNN and the kernel on the card, and the CPU
    torch.backends.cudnn.allow_tf32 = True
    x = vgg16_input(read_image(str(folder / "pair_00.tif")))
    if x.shape != (1, VGG_SIZE, VGG_SIZE, 3):
        raise RuntimeError(f"vgg16_input gave {x.shape}")
    forms = {"cuda": vgg16_features_fn("cuda"),
             "cuda_conv_kernel": vgg16_features_fn("cuda", conv_kernel=True),
             "cpu": vgg16_features_fn("cpu")}
    kernels_mod.reset_launch_counts()
    feats = {k: f(x) for k, f in forms.items()}
    if kernels_mod.launch_counts()["conv3x3"] != len(shapes):
        raise RuntimeError(f"VGG16 with conv_kernel: {kernels_mod.launch_counts()} launches")
    if not torch.backends.cudnn.allow_tf32:
        raise RuntimeError("VGG16 left TF32 off behind it")
    feature_bar = 1e-4 * float(np.abs(feats["cpu"]).max())
    feature_errs = {k: float(np.abs(feats[k] - feats["cpu"]).max())
                    for k in ("cuda", "cuda_conv_kernel")}
    feature_errs["kernel_vs_cudnn"] = float(np.abs(feats["cuda_conv_kernel"] - feats["cuda"]).max())
    if not max(feature_errs.values()) <= feature_bar or feats["cpu"].shape != (25088,):
        raise RuntimeError(f"VGG16 features: errors {feature_errs} over the bar {feature_bar}")
    x_dev = torch.from_numpy(x).cuda()
    flush = torch.empty(32 * 2**20, device="cuda", dtype=torch.float32)
    forward_ms = {}
    for key in ("cuda", "cuda_conv_kernel"):
        model = forms[key].model

        def forward():
            with torch.inference_mode():
                model(x_dev)

        t = time_ms(forward, flush)
        forward_ms[key] = {"device_ms": t["device_ms"], "event_ms": t["event_ms"]}
    emit("vgg16_features", shape=list(x.shape), max_abs_err=feature_errs, bar=feature_bar,
         kernel_vs_cudnn_entries_differ=int((feats["cuda_conv_kernel"] != feats["cuda"]).sum()),
         forward_b1_ms=forward_ms, card=card_line())
    del forms, x_dev, flush

    # process_all_images on the card, on the card with the kernel, on the CPU: one folder,
    # the outputs moved aside after each run (the listing order is the folder's)
    outputs = ("_metrics.csv", "_dimensions.csv", "_metrics_distribution.png")
    runs, launches = {}, 0
    for key, device, conv_kernel in (("cuda", "cuda", False), ("cuda_conv_kernel", "cuda", True),
                                     ("cpu", "cpu", False)):
        comparison = ImageComparison(device=device, conv_kernel=conv_kernel)
        pairs, feature_s = [0], [0.0]
        compare, extract = comparison.compare_images_and_display_metrics, comparison.extract_features

        def counted(*args, **kwargs):
            pairs[0] += 1
            return compare(*args, **kwargs)

        def timed_features(image):
            t = time.perf_counter()
            out = extract(image)
            feature_s[0] += time.perf_counter() - t
            return out

        comparison.compare_images_and_display_metrics = counted
        comparison.extract_features = timed_features
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        avg, ci = comparison.process_all_images([str(folder)], save_csv=True)
        wall = time.perf_counter() - t0
        counts = kernels_mod.launch_counts()
        dims = (folder / "_dimensions.csv").read_text().splitlines()
        processed = {line.split(";")[0]: line.split(";")[5] for line in
                     (folder / "_metrics.csv").read_text().splitlines()[1:]}
        if pairs[0] != COMPARISON_PAIRS or len(dims) != 1 + COMPARISON_PAIRS or \
                processed["MSE"] != f"{float(COMPARISON_PAIRS)}":
            raise RuntimeError(f"process_all_images ({key}) processed {pairs[0]} pairs, "
                               f"{len(dims) - 1} rows of dimensions, {processed['MSE']} in its CSV; "
                               f"{COMPARISON_PAIRS} expected")
        want_launches = 2 * COMPARISON_PAIRS * len(shapes) if conv_kernel else 0
        if counts["conv3x3"] != want_launches or counts["conv3x3_wgrad"]:
            raise RuntimeError(f"process_all_images ({key}): launches {counts}, "
                               f"{want_launches} convolution launches expected")
        if conv_kernel:
            launches = counts["conv3x3"]
        files = {}
        for name in outputs:
            files[name] = (folder / name).read_bytes()
            (folder / name).replace(work / f"{key}{name}")
        runs[key] = {"avg": avg, "ci": ci, "files": files, "wall_s": wall,
                     "features_s": feature_s[0]}
        emit("image_comparison_run", run=key, pairs=pairs[0], wall_s=wall,
             wall_s_per_pair=wall / COMPARISON_PAIRS, features_s=feature_s[0],
             host_share=1.0 - feature_s[0] / wall, launches=counts["conv3x3"],
             angles_axis_aligned=len(COMPARISON_AXIS_ALIGNED), card=card_line())
        del comparison
        torch.cuda.empty_cache()

    # the card's runs against the CPU's: the host computes everything but the features
    device_keys = ("Cosine Similarity", "Euclidean Distance")
    ref = runs["cpu"]
    worst = {}
    for key in ("cuda", "cuda_conv_kernel"):
        run = runs[key]
        if list(run["avg"]) != list(ref["avg"]):
            raise RuntimeError(f"{key}: metric names {list(run['avg'])}")
        if run["files"]["_dimensions.csv"] != ref["files"]["_dimensions.csv"]:
            raise RuntimeError(f"{key}: _dimensions.csv differs from the CPU run's")
        for name, value in run["avg"].items():
            want, ci, want_ci = ref["avg"][name], run["ci"][name], ref["ci"][name]
            if name in device_keys:
                rel = max(abs(value - want) / abs(want),
                          *(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(ci, want_ci)))
                worst[f"{key} {name}"] = rel
                if not rel <= 1e-4:
                    raise RuntimeError(f"{key} {name}: {value} against the CPU's {want}")
            elif value != want or tuple(ci) != tuple(want_ci):
                raise RuntimeError(f"{key} {name}: {value} {ci} against the CPU's {want} {want_ci}")
    torch.backends.cudnn.allow_tf32 = False
    emit("image_comparison_path", ok=True, pairs=COMPARISON_PAIRS, runs=list(runs),
         metrics_cpu=ref["avg"], feature_rel_err=worst, dimensions_csv_identical=True,
         conv_kernel_launches=launches, launches_per_feature_vector=len(shapes))
    return {"errs": errs, "launches": launches,
            "vgg16_shapes": [(s, shapes.count(s)) for s in distinct], "forward_b1_ms": forward_ms,
            "wall_s_per_pair": {k: r["wall_s"] / COMPARISON_PAIRS for k, r in runs.items()},
            "host_share": {k: 1.0 - r["features_s"] / r["wall_s"] for k, r in runs.items()}}


PROFILE_BATCH = 128  # the trainer's throughput batch (JAX tools/smoke_trainer_b128.py)
PROFILE_IMAGES = 430  # 387 train (4 steps of b128, the last with 3 real rows), 43 validation
PROFILE_EPOCHS = 2
PROFILE_STEPS_PER_EPOCH = 4
PROFILE_TIMEOUT_S = 300  # the child run, first line to exit
PROFILE_CAPTURE_TIMEOUT_S = 120  # one capture: window start, length and export
# the kernels line's names -> the CUDA kernels' names in a trace (bf16, --conv-kernel)
PROFILE_TRACE_KERNELS = {"groupnorm_silu": "groupnorm_silu_fwd_kernel",
                         "groupnorm_silu_bwd": "groupnorm_silu_bwd_kernel",
                         "flash_attention": "flash_fwd_wgmma_kernel",
                         "flash_attention_bwd": "flash_bwd_wgmma_kernel",
                         "conv3x3": "conv3x3_wgmma_kernel",
                         "conv3x3_wgrad": "conv3x3_wgrad_wgmma_kernel"}


def profile_port_child(out_path: str, args: list[str]) -> int:
    """``chip_smoke.py --profile-port-child OUT ARGS...``: the training entry
    point as ``python -m pti_ldm_vae_tpu_torch.cli.train_vae ARGS`` runs it
    (``runpy`` as ``-m`` does), with every launch count set to 0 just
    before, and written to ``OUT`` just after with the run's peak GB; then,
    in this process (traces in the script's own would add to the load past
    which torch.profiler loses device events), the flagship's bf16 generator
    step with the convolution kernels at b128 (``time_train_step``: CUDA
    events over 3 calls, a device-only trace of 2, peak GB) into ``OUT`` too."""
    import runpy

    import torch

    sys.path.insert(0, str(ROOT))
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.ops import kernels as kernels_mod

    kernels_mod.reset_launch_counts()
    sys.argv = ["train_vae", *args]
    runpy.run_module("pti_ldm_vae_tpu_torch.cli.train_vae", run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    out = {"launches": kernels_mod.launch_counts(), "conv_shares": conv_shares(kernels_mod),
           "wide_launches": wide_launches(kernels_mod),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    Path(out_path).write_text(json.dumps(out))
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(32 * 2**20, device="cuda", dtype=torch.float32)
    out["train_step_b128"] = time_train_step(
        torch, load_config(CONFIG)["autoencoder_def"], flush, False, conv_kernel=True,
        lpips_split=False, iters=3, warmup=1, trace_iters=2, batch=PROFILE_BATCH)
    Path(out_path).write_text(json.dumps(out))
    return 0


def profile_window(path: Path) -> dict:
    """What one captured Chrome trace holds: its steps (``ProfilerStep#``
    spans), the device's kernel events, each path kernel's count and device ms by its CUDA
    name, device ms (the kernels' summed durations), the window's span from
    the first step's start to the last device event's end, and the idle
    share of that span (1 - the union of kernel intervals over it). Fails
    when the trace holds no device event, when a path kernel is missing, or
    when the counts are not those of whole train steps and forward passes
    with every 3x3 convolution on the kernels (a 3x3 convolution on cuDNN
    would leave the convolution kernels' count short)."""
    events = json.loads(path.read_text())["traceEvents"]
    # the host's step spans (Kineto also draws each on the device's timeline)
    steps = sorted((e for e in events if str(e.get("name", "")).startswith("ProfilerStep#")
                    and e.get("cat") == "user_annotation"), key=lambda e: e["ts"])
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    if not steps or not kernels:
        raise RuntimeError(f"{path.name}: {len(steps)} steps and {len(kernels)} device kernel "
                           "events: a window without device events")
    named = {name: sum(cuda in k["name"] for k in kernels)
             for name, cuda in PROFILE_TRACE_KERNELS.items()}
    n = len(steps)
    passes = named["groupnorm_silu"] // GN_PER_RECONSTRUCT  # train steps and forward passes
    want = {"groupnorm_silu": GN_PER_RECONSTRUCT * passes,
            "groupnorm_silu_bwd": GN_PER_RECONSTRUCT * n,
            "flash_attention": FLASH_PER_RECONSTRUCT * passes,
            "flash_attention_bwd": FLASH_PER_RECONSTRUCT * n,
            "conv3x3": CONV_PER_RECONSTRUCT * passes + CONV_DGRAD_PER_STEP * n,
            "conv3x3_wgrad": CONV_PER_RECONSTRUCT * n}
    if named != want or passes < n:
        raise RuntimeError(f"{path.name}: {n} steps, kernels {named}, "
                           f"expected {want} (cuDNN 3x3 convolutions or a missing kernel)")
    start = steps[0]["ts"]
    intervals = sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    end = max(max(e for _, e in intervals), steps[-1]["ts"] + steps[-1]["dur"])
    busy, cursor = 0.0, start
    for a, b in intervals:  # the union of the kernels' intervals inside the span
        a, b = max(a, cursor), min(b, end)
        if b > a:
            busy += b - a
            cursor = b
    span_ms, device_ms = (end - start) / 1e3, sum(k["dur"] for k in kernels) / 1e3
    named_ms = {name: sum(k["dur"] for k in kernels if cuda in k["name"]) / 1e3
                for name, cuda in PROFILE_TRACE_KERNELS.items()}
    return {"file": path.name, "bytes": path.stat().st_size, "steps": n,
            "forward_only_passes": passes - n, "kernel_events": len(kernels), "named": named,
            "named_device_ms": named_ms,
            "span_ms": span_ms, "device_ms": device_ms, "device_ms_per_pass": device_ms / passes,
            "step_span_ms": [e["dur"] / 1e3 for e in steps],
            "device_idle_share": 1.0 - busy / 1e3 / span_ms,
            "imgs_per_s": PROFILE_BATCH * n * 1e3 / span_ms}


def profile_port_path(torch, np, kernels_mod, work: Path) -> dict:
    """Phase ``profile_port_path``: the flagship trainer at b128 with the live
    profiler endpoint. (a) The seven rows' kernels against their plain
    versions at the largest b128 shapes the step gives them, in bf16, the
    step's type: GroupNorm+SiLU at 128x256²x32 (16 groups) forward and
    backward, flash at [128, 1, 1024, 128] forward and backward, the 3x3
    convolution 128x256²x32 -> 32 forward, input and filter gradient (the b8
    bars). (b) ``train_vae`` as a child process (``profile_port_child``) on a
    copy of ``config/vae_dente_no_adv.json`` with only ``data_base_dir`` and
    ``run_dir`` redirected, ``--batch-size 128 --conv-kernel --profile-port
    P --max-epochs 2`` in bf16 on 430 seeded 300² TIFs (4 steps of b128 an
    epoch, the last padded and masked, and one validation step); once its
    server is up, two captures through ``utils/profiling.py:capture``: one
    of 1 ms (one step: the first one served, step 1), then, once epoch 0 has
    ended, one of 2.5x that step's device ms (about two steps of epoch 1).
    Each trace must hold device events of every path kernel by its CUDA name
    and counts of whole steps with no 3x3 convolution on cuDNN
    (``profile_window``); the run's launch counts, its
    losses and its checkpoint as the training path's. (c) The b128 bf16
    generator step with the convolution kernels, timed in that child after
    the run, CUDA events and a device-only trace: event / device ms, idle
    share, imgs/s, peak GB."""
    from pti_ldm_vae_tpu_torch.utils.profiling import capture

    t_phase = time.perf_counter()
    gn_shape = (PROFILE_BATCH, IMAGE, IMAGE, 32)
    errs = check_kernels(torch, [(gn_shape, 16, (torch.bfloat16,))],
                         ((PROFILE_BATCH, 1, 1024, 128),), [((*gn_shape, 32), 0)], kernels_mod,
                         seed=3, ragged=False, dtypes=(torch.bfloat16,),
                         phase="kernel_checks_b128")
    torch.cuda.empty_cache()

    data = work / "data"
    write_inputs(np, data / "dente", PROFILE_IMAGES)
    cfg = json.loads(CONFIG.read_text())
    cfg["data_base_dir"], cfg["run_dir"] = str(data), str(work / "run")
    (work / "cfg.json").write_text(json.dumps(cfg))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    args = ["-c", str(work / "cfg.json"), "--batch-size", str(PROFILE_BATCH), "--conv-kernel",
            "--profile-port", str(port), "--max-epochs", str(PROFILE_EPOCHS), "--no-wandb",
            "--num-workers", str(LOADER_WORKERS), "--seed", str(TRAIN_SEED)]
    log_lines: list[str] = []
    t_child = time.perf_counter()
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--profile-port-child",
                              str(work / "child.json"), *args], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             env={**os.environ, "PYTHONUNBUFFERED": "1"})  # lines as printed
    reader = threading.Thread(target=lambda: log_lines.extend(child.stdout), daemon=True)
    reader.start()
    windows = []
    try:
        deadline = time.perf_counter() + PROFILE_TIMEOUT_S
        while not any(line.startswith(f"[INFO] profiler server on 127.0.0.1:{port}")
                      for line in log_lines):
            if child.poll() is not None or time.perf_counter() > deadline:
                raise RuntimeError(f"train_vae's profiler server did not come up (rc "
                                   f"{child.poll()}): {''.join(log_lines[-20:])}")
            time.sleep(0.05)
        t_up = time.perf_counter() - t_child
        duration_ms = 1.0
        for i in range(2):
            if i:  # the second in epoch 1's steps, clear of epoch 0's validation and checkpoint
                while not any(line.startswith("Epoch 0 val_loss") for line in log_lines):
                    if child.poll() is not None or time.perf_counter() > deadline:
                        raise RuntimeError(f"train_vae b128 did not end epoch 0 (rc "
                                           f"{child.poll()}): {''.join(log_lines[-20:])}")
                    time.sleep(0.01)
            t0 = time.perf_counter()
            path = capture(port, duration_ms, work / "traces", timeout_s=PROFILE_CAPTURE_TIMEOUT_S)
            window = profile_window(path)
            windows.append({"duration_ms": duration_ms, "wall_s": time.perf_counter() - t0,
                            **window})
            # about two steps: the first step's span holds its one-time costs, its device ms
            # not; a step recorded with its host ops takes up to ~1.8x its device ms
            duration_ms = 2.5 * window["device_ms_per_pass"]
        if windows[0]["steps"] != 1 or windows[1]["steps"] < 2:
            raise RuntimeError(f"windows of {[w['steps'] for w in windows]} steps")
        rc = child.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
        reader.join(timeout=30)
        (work / "child.log").write_text("".join(log_lines))
    wall = time.perf_counter() - t_child
    if rc != 0:
        raise RuntimeError(f"train_vae b128 exited {rc}: {''.join(log_lines[-30:])}")
    child_out = json.loads((work / "child.json").read_text())
    train_steps = PROFILE_EPOCHS * PROFILE_STEPS_PER_EPOCH
    forward_only = PROFILE_EPOCHS * (EVAL_STEPS_PER_EPOCH + 1)  # eval steps, triplet panels
    want = expected_launches(train_steps, forward_only, conv_kernel=True)
    want_shares = expected_conv_shares(train_steps, forward_only)
    if child_out["launches"] != want or child_out["conv_shares"] != want_shares or any(
            child_out["wide_launches"].values()):
        raise RuntimeError(f"train_vae b128 launches {child_out}, expected {want}, {want_shares}")
    rows = [json.loads(line) for line in (work / "run" / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss_total" in r]
    val_rows = [r for r in rows if "val/loss_total" in r]
    bad = [r for r in train_rows + val_rows
           if not all(np.isfinite(v) for k, v in r.items() if k.startswith(("train/", "val/")))]
    split = json.loads((work / "run" / "splits" / "vae_split.json").read_text())
    weights = work / "run" / "trained_weights"
    if (len(train_rows), len(val_rows)) != (train_steps, PROFILE_EPOCHS) or bad or (
            len(split["train_files"]), len(split["val_files"])) != (387, 43) or not (
            weights / "autoencoder_last.pth").is_file():
        raise RuntimeError(f"train_vae b128: {len(train_rows)} train rows, {len(val_rows)} val "
                           f"rows, non-finite {bad[:2]}, split {len(split['train_files'])} / "
                           f"{len(split['val_files'])}, "
                           f"{sorted(p.name for p in weights.iterdir())}")
    step = child_out["train_step_b128"]
    return {"errs": errs, "launches": child_out["launches"],
            "conv_shares": child_out["conv_shares"], "card": card_line(),
            "batch": PROFILE_BATCH, "images": PROFILE_IMAGES,
            "epochs": PROFILE_EPOCHS, "steps_per_epoch": PROFILE_STEPS_PER_EPOCH, "port": port,
            "server_up_s": t_up, "child_wall_s": wall, "child_peak_gb": child_out["peak_gb"],
            "windows": windows, "train_step_b128": step,
            "first_train": {k: v for k, v in train_rows[0].items() if k.startswith("train/")},
            "last_train": {k: v for k, v in train_rows[-1].items() if k.startswith("train/")},
            "val_loss_total": [r["val/loss_total"] for r in val_rows],
            "seconds": time.perf_counter() - t_phase}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "pti_ldm_vae_tpu_torch").is_dir() or not CONFIG.exists():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    # 1. device report
    card = card_line()
    print(card, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from pti_ldm_vae_tpu_torch.ops import kernels as kernels_mod
    from pti_ldm_vae_tpu_torch.ops.kernels import _build
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import SOURCES as CONV_SOURCES
    from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import SOURCES as FLASH_SOURCES
    from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import SOURCES as GN_SOURCES

    from pti_ldm_vae_tpu_torch import native

    t0 = time.perf_counter()
    # one nvcc each, started together, and g++ for the native TIFF library beside them
    with ThreadPoolExecutor(max_workers=1) as pool:
        native_lib = pool.submit(native.build)
        libs = _build.build_all((*FLASH_SOURCES, *CONV_SOURCES, *GN_SOURCES))
        native_path = native_lib.result()
    if native_path is None or not native.available():
        raise RuntimeError("the native TIFF library did not build (g++ failed: see stderr)")
    ptxas = {p.name: ptxas_report(p.with_suffix(".log")) for p in libs}
    emit("build", seconds=round(time.perf_counter() - t0, 3), libraries=[p.name for p in libs],
         native=Path(native_path).name, ptxas=ptxas)
    for src in (*GN_SOURCES, *WIDE_SOURCES, "conv3x3_wgmma.cu"):
        if ptxas[_build.library_path(src).name]["spill_bytes"]:
            raise RuntimeError(f"{src} spills registers: {ptxas[_build.library_path(src).name]}")

    # 3. kernel checks at the paths' shapes
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

    ae_def = load_config(CONFIG)["autoencoder_def"]
    probe = autoencoder_from_config(ae_def, conv_kernel=True)
    gn_shapes = gn_path_shapes(probe, torch)
    if sum(n for _, n in gn_shapes) != GN_PER_RECONSTRUCT:
        raise RuntimeError(f"GroupNorm+SiLU shapes {gn_shapes} do not add up to {GN_PER_RECONSTRUCT}")
    conv_shapes = conv_path_shapes(probe, torch)
    if sum(n for _, n in conv_shapes) != CONV_PER_RECONSTRUCT:
        raise RuntimeError(f"3x3 convolution shapes {conv_shapes} do not add up to "
                           f"{CONV_PER_RECONSTRUCT}")
    del probe
    # AR-VAE: the 10-channel latent's convolutions, the kl1e3 model's shapes (32
    # groups; Cin 256 and 10 take the tensor-core forward in bf16 too), and the
    # flagship's at batch 1 (PTI's decoder fine-tune)
    from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import forward_kernel as conv_forward_kernel

    ar_def = load_config(AR_CONFIG)["autoencoder_def"]
    kl_def = load_config(KL1E3_CONFIG)["autoencoder_def"]
    kl_probe = autoencoder_from_config(kl_def, conv_kernel=True)
    kl_gn_shapes, kl_conv_shapes = gn_path_shapes(kl_probe, torch), conv_path_shapes(kl_probe, torch)
    ar_conv_shapes = conv_path_shapes(autoencoder_from_config(ar_def, conv_kernel=True), torch)
    del kl_probe
    if (sum(n for _, n in kl_gn_shapes), sum(n for _, n in kl_conv_shapes)) != (
            KL1E3_PASS["gn"], KL1E3_PASS["conv"]):
        raise RuntimeError(f"kl1e3 shapes {kl_gn_shapes}, {kl_conv_shapes} do not add up to "
                           f"{KL1E3_PASS}")
    if any(conv_forward_kernel(torch.bfloat16, cin, cout) == "fma"
           for cin, cout in ((1, 64), (4, 128), (10, 256), (256, 10), (256, 256))):
        raise RuntimeError("Cin 1, 4, 10 and 256 must take the tensor-core convolution in bf16")
    for per_pass, shapes in ((FLAGSHIP_PASS, conv_shapes), (KL1E3_PASS, kl_conv_shapes)):
        thin = (sum(n for s, n in shapes if s[3] % 8), sum(n for s, n in shapes if s[4] % 8))
        if thin != (per_pass["thin"], per_pass["thin_dgrad"]):
            raise RuntimeError(f"thin convolutions {thin} of {shapes}, expected {per_pass}")
    flagship_conv = {s for s, _ in conv_shapes}
    new_conv = sorted({s for s, _ in ar_conv_shapes + kl_conv_shapes} - flagship_conv
                      | {(1, *s[1:]) for s in flagship_conv})
    emit("ar_shapes", kl1e3_groupnorm_silu=[[list(s), n] for s, n in kl_gn_shapes],
         kl1e3_conv3x3=[[list(s), n] for s, n in kl_conv_shapes],
         ar_conv3x3=[[list(s), n] for s, n in ar_conv_shapes],
         flash_d256=[list(s) for s in FLASH_D256_SHAPES])
    all_conv = [s for s, _ in conv_shapes] + new_conv
    both_ways = sorted({s for s in all_conv} | {(*s[:3], s[4], s[3]) for s in all_conv})
    emit("wgmma_kernels", occupancy=wgmma_occupancy(torch, both_ways),
         sass=sass_report([_build.library_path(src) for src in WGMMA_SOURCES]))
    ldm_gn_shapes, ldm_flash_shapes = ldm_path_shapes(torch)
    emit("ldm_shapes", groupnorm_silu=[[list(s), n] for s, n in ldm_gn_shapes],
         flash_attention=[[list(s), n] for s, n in ldm_flash_shapes])
    gn_b1 = [((1, *s[1:]), 16) for s, _ in gn_shapes]
    emit("gn_kernels", plans=gn_plans(
        torch, [(s, 16) for s, _ in gn_shapes] + [(GN_B32_SHAPE, 16)]
        + [(s, LDM_GROUPS) for s, _ in ldm_gn_shapes]
        + [(s, KL1E3_GROUPS) for s, _ in kl_gn_shapes] + gn_b1))
    emit("flash_fma_bwd", smem=flash_fma_bwd_smem())
    both = (torch.float32, torch.bfloat16)
    gn_cases = ([(s, 16, both) for s, _ in gn_shapes] + [(s, n, both) for s, n in GN_EXTRA_SHAPES]
                + [(GN_B32_SHAPE, 16, (torch.bfloat16,))]
                + [(s, LDM_GROUPS, both) for s, _ in ldm_gn_shapes])
    errs = check_kernels(torch, gn_cases, FLASH_CHECK_SHAPES + tuple(s for s, _ in ldm_flash_shapes),
                         conv_shapes, kernels_mod)
    # the AR and PTI paths' new shapes, on inputs of their own (the cases above
    # keep the inputs they had before these were added)
    new_errs = check_kernels(
        torch, [(s, KL1E3_GROUPS, both) for s, _ in kl_gn_shapes] + [(s, g, both) for s, g in gn_b1],
        FLASH_D256_SHAPES, [(s, 0) for s in new_conv], kernels_mod, seed=1, ragged=False,
        balanced=True, phase="kernel_checks_ar_pti")
    errs = {name: {k: max(v, new_errs[name][k]) for k, v in by_type.items()}
            for name, by_type in errs.items()}
    # head dims 96 (padded to 128), 512, 640 and 1024, one shape at a time for the kernels line
    head_dim_errs = {}
    fa = kernels_mod.flash_attention
    for shape in FLASH_HEAD_DIM_SHAPES:
        kernels_mod.reset_launch_counts()
        head_dim_errs[shape[-1]] = check_kernels(torch, [], (shape,), [], kernels_mod, seed=2,
                                                 ragged=False, phase="flash_head_dims")
        counts, padded = kernels_mod.launch_counts(), fa.padded_launches
        wide = (fa.wide_launches, fa.wide_bwd_launches)
        # per type: 2 plain forwards and 2 forwards + 2 backwards through autograd; bf16
        # above head dim 128 on the wide kernels
        want_padded = 12 if shape[-1] == 96 else 0
        want_wide = (4, 2) if shape[-1] > 128 else (0, 0)
        if (counts["flash_attention"], counts["flash_attention_bwd"], padded, wide) != (
                8, 4, want_padded, want_wide):
            raise RuntimeError(f"flash {shape}: launches {counts}, padded {padded}, wide {wide}")
        emit("flash_head_dims", shape=list(shape), launches=counts["flash_attention"],
             bwd_launches=counts["flash_attention_bwd"], padded_launches=padded,
             wide_launches=wide[0], wide_bwd_launches=wide[1],
             max_abs_err={k: head_dim_errs[shape[-1]][k] for k in ("flash_attention",
                                                                   "flash_attention_bwd")})
        errs = {name: {k: max(v, head_dim_errs[shape[-1]][name][k]) for k, v in by_type.items()}
                for name, by_type in errs.items()}
    torch.cuda.empty_cache()

    # 4. inference main path through the CLI
    shutil.rmtree(WORK, ignore_errors=True)
    write_inputs(np, WORK / "data" / "dente", N_IMAGES)
    ckpt = WORK / "vae_flagship_random.pth"
    make_weights(torch, ae_def, ckpt)
    cli = ["-c", str(CONFIG), "--checkpoint", str(ckpt), "--input-dir", str(WORK / "data"),
           "--batch-size", str(BATCH), "--num-workers", "4"]
    bf16 = run_cli(torch, np, kernels_mod, cli, WORK / "out_bf16")
    emit("main_path", dtype="bfloat16", **{k: v for k, v in bf16.items() if k != "recon"})
    f32 = run_cli(torch, np, kernels_mod, cli + ["--f32"], WORK / "out_f32")
    emit("main_path", dtype="float32", **{k: v for k, v in f32.items() if k != "recon"})

    conv_f32 = run_cli(torch, np, kernels_mod, cli + ["--f32", "--conv-kernel"],
                       WORK / "out_f32_conv_kernel")
    emit("main_path", dtype="float32", conv_kernel=True,
         **{k: v for k, v in conv_f32.items() if k != "recon"})

    from pti_ldm_vae_tpu_torch.data.io import read_image
    from pti_ldm_vae_tpu_torch.data.transforms import preprocess_image_np
    from pti_ldm_vae_tpu_torch.utils.vae_loader import load_vae_config, load_vae_model

    config = load_vae_config(str(CONFIG))
    cpu_model = load_vae_model(config, str(ckpt), device="cpu", s2d_stem=False)
    inputs = np.stack([preprocess_image_np(read_image(str(p)), (256, 256))
                       for p in sorted((WORK / "data" / "dente").glob("*.tif"))[:2]])
    with torch.inference_mode():
        ref = cpu_model.reconstruct_deterministic(torch.from_numpy(inputs)).numpy()[..., 0]
    err_f32 = float(np.abs(np.stack(f32["recon"][:2]) - ref).max())
    err_bf16 = float(np.abs(np.stack(bf16["recon"][:2]) - ref).max())
    err_conv = float(np.abs(np.stack(conv_f32["recon"][:2]) - ref).max())
    emit("reference", images=2, max_abs_err_f32=err_f32, max_abs_err_bf16=err_bf16,
         max_abs_err_f32_conv_kernel=err_conv, bar_f32=1e-3)
    if not max(err_f32, err_conv) <= 1e-3:
        raise RuntimeError(f"f32 CUDA reconstruction differs from the CPU plain path by {err_f32} "
                           f"(cuDNN convolutions), {err_conv} (convolution kernels)")

    # 5. training main path through the CLI
    train_data = WORK / "train_data"
    write_inputs(np, train_data / "dente", TRAIN_IMAGES)
    train = {}
    for key, extra in (("bfloat16", []), ("float32", ["--f32"])):
        train[key] = run_train_cli(torch, np, kernels_mod, ae_def, train_data,
                                   WORK / f"run_{key}", extra)
        emit("train_path", dtype=key, steps_per_epoch=TRAIN_STEPS_PER_EPOCH, epochs=TRAIN_EPOCHS,
             **train[key])
    reloaded = run_cli(
        torch, np, kernels_mod,
        ["-c", str(CONFIG), "--checkpoint", train["bfloat16"]["best_checkpoint"], "--input-dir",
         str(WORK / "data"), "--batch-size", str(BATCH), "--num-workers", "4", "--num-samples", "8"],
        WORK / "out_trained", n_images=8)
    emit("train_reload", checkpoint=Path(train["bfloat16"]["best_checkpoint"]).name,
         images=8, launches=reloaded["launches"])

    # 6. one f32 train step on the card against the CPU plain path
    train_reference_check(torch, np, kernels_mod, ae_def, train_data / "dente")
    torch.cuda.empty_cache()

    # 6a. adversarial training main path through the CLI, convolution kernels on
    adv = run_adv_train_cli(torch, np, kernels_mod, train_data, WORK / "run_adv")
    emit("adv_train_path", dtype="bfloat16", conv_kernel=True, steps_per_epoch=TRAIN_STEPS_PER_EPOCH,
         epochs=ADV_EPOCHS, adv_warmup_epochs=0, **adv)
    # 6b. one f32 adversarial step on the card against the CPU plain path
    adv_train_reference_check(torch, np, kernels_mod, ae_def, train_data / "dente", ckpt)
    torch.cuda.empty_cache()

    # 6c. latent diffusion: training, then sampling from its checkpoint, through the CLIs
    ldm_train, ldm_sample = {}, {}
    for key, extra in (("bfloat16", []), ("float32", ["--f32"])):
        cfg_path = write_ldm_config(ckpt, WORK / f"run_ldm_{key}")
        ldm_train[key] = run_ldm_train_cli(torch, np, kernels_mod, cfg_path, train_data, extra)
        emit("ldm_train_path", dtype=key, batch=BATCH, epochs=LDM_TRAIN_EPOCHS,
             steps_per_epoch=LDM_TRAIN_IMAGES // BATCH, **ldm_train[key])
        # 6d. 50 DDIM steps from the checkpoint the bf16 run wrote
        ldm_sample[key] = run_ldm_sample_cli(
            torch, np, kernels_mod, cfg_path, ldm_train["bfloat16"]["checkpoint"], WORK / "data",
            WORK / f"samples_{key}", extra)
        emit("ldm_sample_path", dtype=key, batch=LDM_SAMPLE_IMAGES, steps=LDM_SAMPLE_STEPS,
             **ldm_sample[key])
        torch.cuda.empty_cache()
    # 6e. the UNet, a diffusion step and a short DDIM run in f32 against the CPU plain path
    ldm_reference_check(torch, np, kernels_mod, cfg_path)
    torch.cuda.empty_cache()

    # 6f. AR-VAE training on config/ar_vae_dente.json, evaluate_vae on its best
    # checkpoint, one f32 AR step against the CPU plain path
    from pti_ldm_vae_tpu_torch.train.loop import build_ar_spec, resolve_ar_settings

    attributes = write_attributes(np, train_data / "dente", WORK / "attributes_dente.json")
    ar_cfg = ar_config_file(AR_CONFIG, train_data, WORK / "run_ar", attributes)
    ar = run_ar_train_cli(torch, np, kernels_mod, ar_cfg, WORK / "run_ar", [], epochs=TRAIN_EPOCHS,
                          steps_per_epoch=TRAIN_STEPS_PER_EPOCH, per_pass=FLAGSHIP_PASS,
                          conv_kernel=False, adversarial=False)
    emit("ar_train_path", config=AR_CONFIG.name, dtype="bfloat16", batch=BATCH,
         epochs=TRAIN_EPOCHS, steps_per_epoch=TRAIN_STEPS_PER_EPOCH, **ar)
    ar_eval = run_evaluate_cli(torch, np, kernels_mod, ar_cfg, ar["best_checkpoint"], WORK / "data",
                               WORK / "eval_ar", N_IMAGES)
    emit("ar_evaluate_path", config=AR_CONFIG.name, dtype="bfloat16", images=N_IMAGES, **ar_eval)
    ar_full = load_config(ar_cfg)
    ar_spec = build_ar_spec(ar_full, resolve_ar_settings(ar_full))
    ar_step_reference_check(torch, np, kernels_mod, ar_def, ar_spec, train_data / "dente",
                            attributes, ar_full["regularized_attributes"]["normalize_attributes"],
                            AR_REFERENCE_IMAGES, conv_kernel=False, per_pass=FLAGSHIP_PASS,
                            phase="ar_train_reference")
    torch.cuda.empty_cache()

    # 6g. the kl1e3 model (64-128-256, 32 groups, flash at head dim 256) with its
    # adversarial branch from epoch 1 and the convolution kernels, then one f32
    # AR step with the convolution kernels against the CPU plain path
    kl_cfg = ar_config_file(KL1E3_CONFIG, train_data, WORK / "run_kl1e3", attributes,
                            adv_warmup_epochs=0)
    kl = run_ar_train_cli(torch, np, kernels_mod, kl_cfg, WORK / "run_kl1e3",
                          ["--conv-kernel", "--subset-size", str(KL1E3_SUBSET)], epochs=TRAIN_EPOCHS,
                          steps_per_epoch=KL1E3_STEPS_PER_EPOCH, per_pass=KL1E3_PASS,
                          conv_kernel=True, adversarial=True)
    emit("kl1e3_train_path", config=KL1E3_CONFIG.name, dtype="bfloat16", batch=BATCH,
         conv_kernel=True, epochs=TRAIN_EPOCHS, steps_per_epoch=KL1E3_STEPS_PER_EPOCH,
         adv_warmup_epochs=0, **kl)
    # its head dim 256 in bf16: the wide tensor-core kernels, each launched
    if not all(kl["wide_launches"].values()) or any(
            kl["wide_launches"][f"{name}_wide"] > kl["launches"][name]
            for name in ("flash_attention", "flash_attention_bwd")):
        raise RuntimeError(f"kl1e3 path: wide flash launches {kl['wide_launches']} of {kl['launches']}")
    kl_full = load_config(kl_cfg)
    kl_spec = build_ar_spec(kl_full, resolve_ar_settings(kl_full))
    ar_step_reference_check(torch, np, kernels_mod, kl_def, kl_spec, train_data / "dente",
                            attributes, kl_full["regularized_attributes"]["normalize_attributes"],
                            KL1E3_REFERENCE_IMAGES, conv_kernel=True, per_pass=KL1E3_PASS,
                            phase="kl1e3_train_reference")
    torch.cuda.empty_cache()

    # 6h. PTI on the seeded flagship checkpoint: batched (b8) in bf16, f32 and with
    # the convolution kernels, sequential (b1) with --save-tuned, whose
    # autoencoder then serves through inference_vae; f32 against the CPU
    pti_cli = ["-c", str(CONFIG), "--checkpoint", str(ckpt), "--input-dir", str(WORK / "data"),
               "--num-workers", "4"]
    pti = {}
    for key, extra, batch, n, conv in (("b8", [], BATCH, BATCH, False),
                                       ("b8_f32", ["--f32"], BATCH, BATCH, False),
                                       ("b8_conv_kernel", ["--conv-kernel"], BATCH, BATCH, True),
                                       ("b1", ["--save-tuned"], 1, PTI_B1_IMAGES, False)):
        pti[key] = run_pti_cli(torch, np, kernels_mod, pti_cli + extra, WORK / f"pti_{key}", n,
                               batch, conv)
        emit("pti_path", run=key, latent_steps=PTI_LATENT_STEPS, tune_steps=PTI_TUNE_STEPS,
             **pti[key])
        torch.cuda.empty_cache()
    tuned_ckpt = sorted((WORK / "pti_b1").glob("*_decoder.pth"))
    if len(tuned_ckpt) != PTI_B1_IMAGES:
        raise RuntimeError(f"--save-tuned wrote {[p.name for p in tuned_ckpt]}")
    reload = run_cli(torch, np, kernels_mod,
                     ["-c", str(CONFIG), "--checkpoint", str(tuned_ckpt[0]), "--input-dir",
                      str(WORK / "data"), "--batch-size", str(BATCH), "--num-workers", "4",
                      "--num-samples", "8"], WORK / "out_pti_tuned", n_images=8)
    emit("pti_tuned_reload", checkpoint=tuned_ckpt[0].name, images=8, launches=reload["launches"])
    pti_reference_check(torch, np, kernels_mod, ckpt, WORK / "data" / "dente")
    torch.cuda.empty_cache()

    # 6i. latent regression: mask attributes for phase 5's TIFs, then
    # train_regression -> evaluate_regression -> inference_regression on both
    # regression configs with the seeded flagship checkpoint (f32 encode), and a
    # third pass with the convolution kernels
    stems = [p.stem for p in sorted((train_data / "dente").glob("*.tif"))]
    write_masks(np, stems, WORK / "masks")
    reg_attributes = run_mask_metrics(np, WORK / "masks", WORK / "metrics", len(stems))
    reg = {}
    for key, name, conv in (("reg", REG_CONFIGS[0], False), ("nreg", REG_CONFIGS[1], False),
                            ("reg_conv_kernel", REG_CONFIGS[0], True)):
        reg_cfg = regression_config_file(name, train_data, WORK / "data", reg_attributes, ckpt,
                                         WORK / f"run_{key}")
        reg[key] = run_regression_pipeline(torch, np, kernels_mod, reg_cfg, ckpt,
                                           WORK / "data" / "dente", conv)
        emit("regression_path", run=key, config=f"{name}.json", conv_kernel=conv, batch=BATCH,
             epochs=REG_EPOCHS, **reg[key])
        torch.cuda.empty_cache()
    # 6j. one f32 head train step and eval step, every kernel on, against the CPU
    regression_reference_check(torch, np, kernels_mod, ckpt, train_data / "dente", reg_attributes)
    torch.cuda.empty_cache()

    # 6k. latent-space analysis through the three CLIs (seeded flagship checkpoint,
    # f32 encode, t-SNE on the card; the AR model of phase 6f for the channel grid)
    analysis_folders = write_analysis_inputs(np, WORK / "analysis_data")
    analysis = analysis_path(torch, np, kernels_mod, ckpt, analysis_folders, ar_cfg,
                             ar["best_checkpoint"])
    emit("analysis_path", images_per_group=ANALYSIS_IMAGES, patients=ANALYSIS_PATIENTS,
         batch=BATCH, dtype="float32", perplexity=ANALYSIS_PERPLEXITY, **analysis)
    # 6l. the same stages in f32 against the CPU plain path
    analysis_reference_check(torch, np, ckpt, analysis_folders)
    torch.cuda.empty_cache()

    # 6m. the shipped configs chained: train_vae -> train_regression / train_diffusion,
    # vae.checkpoint as shipped, step 2 of train_vae traced
    chain = chain_path(torch, np, kernels_mod, WORK / "chain")
    emit("chain_path", configs=list(CHAIN_CONFIGS), images=CHAIN_IMAGES, batch=BATCH, epochs=1,
         **chain)
    torch.cuda.empty_cache()
    # 6n. the loader's rate, native and numpy, and the device preprocessing on the card
    emit("loader_b8", **loader_b8(torch, np, WORK / "loader"))
    torch.cuda.empty_cache()

    # 6o. the space-to-depth forms: kernel checks at their shapes, the f32 reconstructs against
    # the standard one and the CPU, inference_vae with "s2d_stem": true, the f32 steps
    s2d = s2d_path(torch, np, kernels_mod, ae_def, ckpt, inputs, ref, bf16["recon"],
                   train_data / "dente")
    errs = {name: {k: max(v, s2d["errs"][name][k]) for k, v in by_type.items()}
            for name, by_type in errs.items()}
    torch.cuda.empty_cache()
    # 6p. remat: the f32 steps, the bf16 gradients bit for bit, train_vae, train_diffusion, run_pti
    remat = remat_path(torch, np, kernels_mod, ae_def, ckpt, train_data / "dente")
    torch.cuda.empty_cache()
    # 6q. two-pass statistics: the f32 step on the counted plain route against the one-pass step
    knob_step_check(torch, np, kernels_mod, ae_def, train_data / "dente", "two_pass",
                    [("two_pass", {"norm_stats": "two_pass"})])
    torch.cuda.empty_cache()
    # 6r. the flagship's widths at spatial_dims 3 and 1: kernel checks at their rank-4 views,
    # reconstructs, the f32 reconstructs and 3-D steps against the CPU
    dims = dims_path(torch, np, kernels_mod, ae_def)
    errs = {name: {k: max(v, dims["errs"][name][k]) for k, v in by_type.items()}
            for name, by_type in errs.items()}
    # 6s. the kernels' vmap rules on the card, then PTI's vmap form through run_pti
    emit("vmap_rules", checks=vmap_rule_checks(torch, kernels_mod))
    pti_vmap = pti_vmap_path(torch, np, kernels_mod, ckpt)
    # their timings, in a process of their own (timings_child)
    (WORK / "dims_timings.json").write_text(json.dumps(
        {"weights_3d": dims["weights_3d"], "ckpt": str(ckpt), "t": time.perf_counter() - T0}))
    torch.cuda.empty_cache()
    subprocess.run([sys.executable, str(Path(__file__).resolve()), "--dims-timings",
                    str(WORK / "dims_timings.json")], check=True, timeout=600)
    # 6t. the GT-vs-synthesis comparison suite: VGG16 on the card (cuDNN and the convolution
    # kernel) and on the CPU, the geometry on the host
    comparison = image_comparison_path(torch, np, kernels_mod, WORK / "image_comparison")
    errs = {name: {k: max(v, comparison["errs"][name][k]) for k, v in by_type.items()}
            for name, by_type in errs.items()}
    torch.cuda.empty_cache()
    # 6u. the flagship trainer at b128 behind --profile-port: the kernels at its b128 shapes,
    # two captures through the endpoint, the b128 step's numbers
    profile_port = profile_port_path(torch, np, kernels_mod, WORK / "profile_port")
    emit("profile_port_path", **{k: v for k, v in profile_port.items() if k != "errs"})
    errs = {name: {k: max(v, profile_port["errs"][name][k]) for k, v in by_type.items()}
            for name, by_type in errs.items()}

    # 7. timing
    from pti_ldm_vae_tpu_torch.utils.cli_common import load_config_and_model

    flush = torch.empty(32 * 2**20, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows: dict[str, list] = {name: [] for name in KERNEL_NAMES}

    time_groupnorm_silu(torch, [(s, n, 16) for s, n in gn_shapes], flush, gen, rows, "vae")
    time_flash_attention(torch, [((BATCH, 1, 1024, 128), FLASH_PER_RECONSTRUCT)], flush, gen,
                         rows, "vae")
    # head dim 256 (the kl1e3 mid blocks: the wide tensor-core kernels in bf16, the FMA ones in f32)
    time_flash_attention(torch, [(FLASH_D256_SHAPES[0], KL1E3_PASS["flash"])], flush, gen, rows,
                         "kl1e3")
    # head dims 96 (padded to 128), 512, 640 and 1024, two calls a pass as in a VAE's mid blocks
    for shape in FLASH_HEAD_DIM_SHAPES:
        time_flash_attention(torch, [(shape, FLASH_PER_RECONSTRUCT)], flush, gen, rows,
                             f"d{shape[-1]}")
    torch.cuda.empty_cache()
    time_conv3x3(torch, conv_shapes, flush, gen, rows)
    # the kl1e3 model's convolutions, in bf16 as its config trains (Cin 256 and the padded Cin
    # 10 and 1 beside the FMA kernel they took before), and the AR model's 10-channel latent's
    time_conv3x3(torch, kl_conv_shapes, flush, gen, rows, path="kl1e3", dtypes=(torch.bfloat16,),
                 iters=5)
    ar_latent = [(s, n) for s, n in ar_conv_shapes if 10 in s[3:]]
    time_conv3x3(torch, ar_latent, flush, gen, rows, path="ar", dtypes=(torch.bfloat16,), iters=5)
    torch.cuda.empty_cache()

    from pti_ldm_vae_tpu_torch.train.steps import make_inference_fn

    x = torch.randn(BATCH, 256, 256, 1, device="cuda", generator=gen)
    for exact, conv_kernel in ((False, False), (True, False), (False, True), (True, True)):
        _, model = load_config_and_model(str(CONFIG), str(ckpt), device=torch.device("cuda"),
                                         exact=exact, conv_kernel=conv_kernel)
        reconstruct = make_inference_fn(model)
        t = time_ms(lambda: reconstruct(x), flush, iters=6)
        emit("reconstruct_b8", dtype="float32" if exact else "bfloat16", conv_kernel=conv_kernel,
             imgs_per_s=BATCH * 1e3 / t["event_ms"], device_ms=t["device_ms"],
             event_ms=t["event_ms"], device_idle_share=1.0 - t["device_ms"] / t["event_ms"],
             device_ms_by_kind=device_ms_by_kind(t["by_name"]))
        del model, reconstruct
    torch.cuda.empty_cache()
    # the generator-only step on cuDNN convolutions (both types), the adversarial
    # step on cuDNN convolutions, the adversarial step on the convolution kernels
    for exact, conv_kernel, adv_active in ((False, False, False), (True, False, False),
                                           (False, False, True), (False, True, True),
                                           (True, True, True)):
        emit("train_step_b8", **time_train_step(torch, ae_def, flush, exact, conv_kernel, adv_active))
        torch.cuda.empty_cache()
    # the AR steps (flagship AR on cuDNN; kl1e3 as its config trains: adversarial,
    # adv_weight 0.5, with the convolution kernels) and PTI's stages
    emit("ar_step_b8", config=AR_CONFIG.name,
         **time_train_step(torch, ar_def, flush, False, ar_spec=ar_spec))
    torch.cuda.empty_cache()
    emit("ar_step_b8", config=KL1E3_CONFIG.name,
         **time_train_step(torch, kl_def, flush, False, conv_kernel=True, adv_active=True,
                           ar_spec=kl_spec, adv_weight=0.5))
    torch.cuda.empty_cache()
    for exact in (False, True):
        emit("pti_b8", **time_pti(torch, ckpt, flush, exact))
        torch.cuda.empty_cache()
    # the regression head's train step and predict: f32 (the CLIs') and bf16, cuDNN and kernels
    for exact, conv_kernel in ((True, False), (False, False), (True, True), (False, True)):
        emit("regression_b8", **time_regression(torch, ckpt, flush, exact, conv_kernel))
        torch.cuda.empty_cache()
    # the analysis encode (device-resident and as analyze_static reads it) and the
    # projection at the CLIs' default sizes
    time_analysis(torch, np, ckpt, flush, analysis_folders)
    # the kernels at the UNet's shapes, then the UNet pass, the DDIM loop and the diffusion step
    time_groupnorm_silu(torch, [(s, n, LDM_GROUPS) for s, n in ldm_gn_shapes], flush, gen, rows,
                        "ldm")
    time_flash_attention(torch, ldm_flash_shapes, flush, gen, rows, "ldm")
    for exact in (False, True):
        emit("ldm_b8", **time_ldm(torch, cfg_path, ldm_train["bfloat16"]["checkpoint"], flush, exact))
        torch.cuda.empty_cache()
    # the s2d pass's own kernel shapes and the knobs' A/B, in a process of their own
    # (timings_child), then their rows beside this process's
    timed_gn = {tuple(r["shape"]) for r in rows["groupnorm_silu"] if r["path"] == "vae"}
    timed_conv = {tuple(r["shape"]) for r in rows["conv3x3"]}
    spec = {"gn_shapes": [[list(sh), n] for sh, n in s2d["gn_shapes"] if sh not in timed_gn],
            "conv_shapes": [[list(sh), n] for sh, n in s2d["conv_shapes"] if sh not in timed_conv],
            "vgg16_shapes": [[list(sh), n] for sh, n in comparison["vgg16_shapes"]],
            "ckpt": str(ckpt), "ldm_cfg": str(cfg_path),
            "ldm_ckpt": ldm_train["bfloat16"]["checkpoint"], "t": time.perf_counter() - T0}
    (WORK / "knob_timings.json").write_text(json.dumps(spec))
    del flush
    torch.cuda.empty_cache()
    subprocess.run([sys.executable, str(Path(__file__).resolve()), "--knob-timings",
                    str(WORK / "knob_timings.json"), str(WORK / "knob_rows.json")],
                   check=True, timeout=600)
    for name, extra in json.loads((WORK / "knob_rows.json").read_text()).items():
        rows[name] += extra
    # 7b. data parallelism: one NCCL rank started by train_vae from a torchrun environment,
    # then two gloo ranks on the one card (ddp_child), in two processes of their own
    ddp = ddp_path(torch, np, ae_def, ckpt, cfg_path, ldm_train["bfloat16"]["checkpoint"],
                   WORK / "data")
    # 7c. spatial and tensor parallelism: two gloo ranks on the one card (mp_child)
    mp = model_parallel_path(torch, np)

    # 8. kernels line, card line, result line
    def totals(name: str, path: str = "vae") -> dict:
        bf = [r for r in rows[name] if r["dtype"] == "bfloat16" and r.get("path", "vae") == path]
        out = {k: sum(r[k] * r["per_pass"] for r in bf)
               for k in ("ms", "event_ms", "plain_ms", "library_ms", "bound_ms")}
        if any("fma_ms" in r for r in bf):  # the same calls as they ran before this route
            out["fma_ms"] = sum(r.get("fma_ms", r["ms"]) * r["per_pass"] for r in bf)
        return out

    def s2d_totals(name: str) -> dict:
        """The bf16 sums over one b8 pass or train step with ``s2d_stem`` true:
        per distinct shape of its pass, the row of whichever path timed it
        (the flagship's, kl1e3's, or the s2d pass's own), times its calls."""
        conv = name.startswith("conv3x3")
        shapes = s2d["conv_shapes"] if conv else s2d["gn_shapes"]
        roles = {"conv3x3": ("forward", "dgrad"), "conv3x3_wgrad": ("wgrad",)}.get(name, (None,))
        stem = (BATCH, IMAGE // 2, IMAGE // 2, 4, 4 * ae_def["channels"][0])
        out = dict.fromkeys(("ms", "event_ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
        for shape, n in shapes:
            for role in roles:
                row = next(r for r in rows[name] if r["dtype"] == "bfloat16"
                           and tuple(r["shape"]) == shape and r.get("role") == role
                           and (conv or (r["path"] in ("vae", "s2d") and r["groups"] == 16)))
                calls = 0 if role == "dgrad" and shape == stem else n  # the image's gradient
                for k in out:
                    out[k] += row[k] * calls
        return out

    def per_call(name: str, path: str) -> dict:
        """Per call at one shape timed under ``path``, both types: [8, 1, 4096, 256]
        (kl1e3), [8, 1, 1024, 96] (padded to 128), 512, and 640 and 1024 (smaller
        batches); ``fma_ms`` and the FMA kernels' errors where the wide kernels serve bf16."""
        keys = ("ms", "event_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel",
                "fma_ms", "fma_max_abs_err", "fma_rel_rms_err")
        return {r["dtype"]: {k: r[k] for k in keys if k in r} for r in rows[name]
                if r["path"] == path}

    def head_dims(name: str) -> dict:
        """The d96 / d512 / d640 / d1024 entries of rows 4-5: times, the check's error."""
        out = {}
        for shape in FLASH_HEAD_DIM_SHAPES:
            d = shape[-1]
            out[f"d{d}"] = {"shape": list(shape), **per_call(name, f"d{d}"),
                            "max_abs_err": head_dim_errs[d][name]}
        return out

    gn_pallas = "pti_ldm_vae_tpu/ops/pallas/groupnorm_silu.py"
    fa_pallas = "pti_ldm_vae_tpu/ops/pallas/flash_attention.py"
    described = {
        "groupnorm_silu": ("cuda", "pti_ldm_vae_tpu_torch/csrc/groupnorm_silu_fwd.cu",
                           f"{gn_pallas}:121",
                           "bf16 and f32 (one kernel), device ms summed over the 42 launches of "
                           "one b8 pass; bound: x read and y written"),
        "groupnorm_silu_bwd": ("cuda", "pti_ldm_vae_tpu_torch/csrc/groupnorm_silu_bwd.cu",
                               f"{gn_pallas}:221,248",
                               "bf16 and f32 (one kernel, in place of the TPU's reduce and dx "
                               "kernels), device ms summed over the 42 calls of one b8 train "
                               "step (each: one launch and the torch.sum over images); bound: "
                               "x and g read and dx written"),
        "flash_attention": ("cuda", "pti_ldm_vae_tpu_torch/csrc/flash_attention_wgmma.cu",
                            f"{fa_pallas}:65",
                            "bf16 (the tensor-core kernel; f32 inputs: source_f32), device ms "
                            "summed over the 2 launches of one b8 pass"),
        "flash_attention_bwd": ("cuda", "pti_ldm_vae_tpu_torch/csrc/flash_attention_bwd_wgmma.cu",
                                f"{fa_pallas}:121",
                                "bf16 (the tensor-core kernel; f32 inputs: source_f32), device ms "
                                "summed over the 2 calls of one b8 train step (each call: the delta "
                                "pre-pass and one launch of dk/dv and dq blocks)"),
        "conv3x3": ("cuda", "pti_ldm_vae_tpu_torch/csrc/conv3x3_wgmma.cu",
                    "pti_ldm_vae_tpu/ops/pallas/conv2d.py:120",
                    "bf16 (the tensor-core kernel at every Cin up to 1520, a thin Cin padded with "
                    "zero channels, csrc/conv3x3_stream_wgmma.cu where Cin > 176 and Cout >= 64; "
                    "the kernel of source_f32 takes f32 inputs), device ms summed "
                    "over the 47 forward and 46 input-gradient launches of one b8 train step with "
                    "conv_kernel=True; fma_ms: the same calls with the thin ones on the kernel of "
                    "source_f32, as before; library_ms: F.conv2d and its "
                    "input gradient, channels-last, TF32 off"),
        "conv3x3_wgrad": ("cuda", "pti_ldm_vae_tpu_torch/csrc/conv3x3_wgrad_wgmma.cu",
                          "pti_ldm_vae_tpu/ops/pallas/conv2d.py:137",
                          "bf16 (the tensor-core kernel where Cin and Cout are multiples of 8, "
                          "else the kernel of source_f32, which also takes f32 inputs), device ms "
                          "summed over the 47 launches of one b8 train step with "
                          "conv_kernel=True, the torch.sum of the partial sums included; "
                          "library_ms: F.conv2d's filter gradient"),
    }
    # the same sums (bf16) over one UNet pass of config/ldm_dente.json at b8
    ldm_scope = {"groupnorm_silu": "device ms summed over the 45 launches of one UNet pass",
                 "groupnorm_silu_bwd": "device ms summed over the 45 calls of one diffusion step",
                 "flash_attention": "device ms summed over the 16 launches of one UNet pass",
                 "flash_attention_bwd": "device ms summed over the 16 calls of one diffusion step"}
    # the same sums (bf16) over one b8 pass or train step of the flagship with s2d_stem true
    s2d_scope = {"groupnorm_silu": "device ms summed over the 42 launches of one b8 pass with "
                                   "s2d_stem true",
                 "groupnorm_silu_bwd": "device ms summed over the 42 calls of one b8 train step "
                                       "with s2d_stem true",
                 "conv3x3": "device ms summed over the 47 forward and 46 input-gradient launches "
                            "of one b8 train step with s2d_stem true and conv_kernel=True",
                 "conv3x3_wgrad": "device ms summed over the 47 launches of one b8 train step "
                                  "with s2d_stem true and conv_kernel=True"}
    # the same sums (bf16) over one b8 train step of config/ar_vae_dente_kl1e3.json
    kl_scope = {"conv3x3": f"device ms summed over the {KL1E3_PASS['conv']} forward and "
                           f"{KL1E3_PASS['dgrad']} input-gradient launches of one b8 kl1e3 "
                           "train step; fma_ms: the same calls with Cin 256, 10 and 1 on the "
                           "kernel of source_f32, as before",
                "conv3x3_wgrad": f"device ms summed over the {KL1E3_PASS['conv']} launches of "
                                 "one b8 kl1e3 train step"}
    f32_sources = {"flash_attention": "pti_ldm_vae_tpu_torch/csrc/flash_attention.cu",
                   "flash_attention_bwd": "pti_ldm_vae_tpu_torch/csrc/flash_attention_bwd.cu",
                   "conv3x3": "pti_ldm_vae_tpu_torch/csrc/conv3x3.cu",
                   "conv3x3_wgrad": "pti_ldm_vae_tpu_torch/csrc/conv3x3_wgrad.cu"}
    # the wide-head flash kernels (bf16 above head dim 128), as their own entries: launched
    # on the kl1e3 path (head dim 256), timed at its shape, errors of the bf16 checks at
    # head dims 256, 512, 640 and 1024
    wide_scope = ("bf16, device ms summed over the 2 {what} of one b8 kl1e3 {unit} at [8, 1, 4096, "
                  "256]; fma_ms: the f32-FMA kernel bf16 took there before, on the same inputs, "
                  "in turns; d512: per call at [8, 1, 1024, 512]")
    wide_described = {
        "flash_attention_wide": ("flash_attention", WIDE_SOURCES[0], f"{fa_pallas}:65",
                                 wide_scope.format(what="launches", unit="pass")),
        "flash_attention_bwd_wide": ("flash_attention_bwd", WIDE_SOURCES[1], f"{fa_pallas}:121",
                                     wide_scope.format(what="calls", unit="train step")
                                     + " (each call: the delta pre-pass and one launch)"),
    }

    def wide_totals(name: str) -> dict:
        bf = [r for r in rows[name] if r["dtype"] == "bfloat16" and r["path"] == "kl1e3"]
        if [r["kernel"] for r in bf] != ["wgmma_wide"]:
            raise RuntimeError(f"{name} at kl1e3's shape did not take the wide kernel: {bf}")
        return {**{k: bf[0][k] * bf[0]["per_pass"]
                   for k in ("ms", "event_ms", "plain_ms", "library_ms", "bound_ms", "fma_ms")},
                "bound_by": bf[0]["bound_by"]}

    kernels = []
    for name, (route, source, replaces, scope) in described.items():
        kernels.append({
            "name": name, "route": route, "source": source,
            **({"source_f32": f32_sources[name]} if name in f32_sources else {}),
            "replaces": replaces,
            "launches": adv["launches"][name],
            "launches_by_path": {"inference_vae": bf16["launches"][name],
                                 "inference_vae_conv_kernel": conv_f32["launches"][name],
                                 "train_vae": train["bfloat16"]["launches"][name],
                                 "train_vae_adversarial_conv_kernel": adv["launches"][name],
                                 "train_diffusion": ldm_train["bfloat16"]["launches"][name],
                                 "sample_diffusion": ldm_sample["bfloat16"]["launches"][name],
                                 "train_vae_ar": ar["launches"][name],
                                 "evaluate_vae_ar": ar_eval["launches"][name],
                                 "train_vae_ar_kl1e3_conv_kernel": kl["launches"][name],
                                 **{f"run_pti_{key}": r["launches"][name] for key, r in pti.items()},
                                 **{f"{cli}_regression_{key}": r["launches"][cli][name]
                                    for key, r in reg.items()
                                    for cli in ("train", "evaluate", "inference")},
                                 **{key: n[name] for key, n in analysis["launches"].items()},
                                 **{f"chain_{cli}": n[name]
                                    for cli, n in chain["launches"].items()},
                                 **{f"inference_vae_s2d_{key}": r["launches"][name]
                                    for key, r in s2d["runs"].items()},
                                 "train_vae_remat_s2d_encoder_conv_kernel":
                                     remat["train_vae"]["launches"][name],
                                 "train_diffusion_remat": remat["train_diffusion"]["launches"][name],
                                 "run_pti_remat_b8_conv_kernel": remat["run_pti"]["launches"][name],
                                 "train_vae_ddp_nccl_world1_conv_kernel":
                                     ddp[0]["nccl_world1"]["launches"][name],
                                 **{f"{cli}_ddp_gloo_rank{r}": ddp[r]["gloo"]["launches"][cli][name]
                                    for r in (0, 1)
                                    for cli in ("train_vae", "sample_diffusion", "run_pti")},
                                 **{key: n[name] for key, n in dims["launches"].items()},
                                 **{key: n[name] for key, n in pti_vmap.items()},
                                 "image_comparison_conv_kernel":
                                     comparison["launches"] if name == "conv3x3" else 0,
                                 "train_vae_b128_profile_port_conv_kernel":
                                     profile_port["launches"][name]},
            "max_abs_err": errs[name]["bfloat16"], "max_abs_err_f32": errs[name]["float32"],
            **({"rel_rms_err": errs[name]["bfloat16_rel"]}
               if name in ("flash_attention", "flash_attention_bwd") else {}),
            **totals(name), "bound_by": rows[name][0]["bound_by"], "scope": scope,
            **({"ldm_unet": {**totals(name, "ldm"), "scope": ldm_scope[name]}}
               if name in ldm_scope else {}),
            **({"kl1e3_d256": per_call(name, "kl1e3"), **head_dims(name)}
               if name in ("flash_attention", "flash_attention_bwd") else {}),
            **({"kl1e3": {**totals(name, "kl1e3"), "scope": kl_scope[name]}}
               if name in kl_scope else {}),
            **({"s2d": {**s2d_totals(name), "scope": s2d_scope[name]}}
               if name in s2d_scope else {}),
            # of the forward kernel's launches on the bf16 convolution-kernel paths: on the FMA
            # kernel (none) and on zero-padded channels
            **({"shares_by_path": {"train_vae_adversarial_conv_kernel": adv["conv_shares"],
                                   "train_vae_ar_kl1e3_conv_kernel": kl["conv_shares"],
                                   "run_pti_b8_conv_kernel": pti["b8_conv_kernel"]["conv_shares"],
                                   "inference_vae_s2d_bf16_conv_kernel":
                                       s2d["runs"]["bf16_conv_kernel"]["conv_shares"],
                                   "train_vae_remat_s2d_encoder_conv_kernel":
                                       remat["train_vae"]["conv_shares"],
                                   "run_pti_remat_b8_conv_kernel":
                                       remat["run_pti"]["conv_shares"]},
                "ar_latent": [{k: r[k] for k in ("shape", "role", "kernel", "tile", "ms", "fma_ms",
                                                 "library_ms", "bound_ms") if k in r}
                              for r in rows[name] if r["path"] == "ar"]}
               if name == "conv3x3" else {}),
            # VGG16's f32 convolutions in the comparison suite (conv_kernel=True), per call
            **({"vgg16": {"shapes": [{k: v for k, v in r.items() if k not in ("path", "dtype", "role")}
                                     for r in rows[name] if r["path"] == "vgg16"],
                          "forward_b1_ms": comparison["forward_b1_ms"],
                          "scope": "f32 forward per call after an L2 flush, device ms (ms, "
                                   "plain_ms, library_ms) and event ms; library: F.conv2d "
                                   "channels-last, TF32 off; forward_b1_ms: VGG16 features of "
                                   "one image, cuDNN and the kernel"}}
               if name == "conv3x3" else {}),
        })
    for wide_name, (name, source, replaces, scope) in wide_described.items():
        kernels.append({
            "name": wide_name, "route": "cuda", "source": f"pti_ldm_vae_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": kl["wide_launches"][wide_name],
            "launches_by_path": {"train_vae_ar_kl1e3_conv_kernel": kl["wide_launches"][wide_name],
                                 "train_vae_ar": ar["wide_launches"][wide_name]},
            "max_abs_err": max([new_errs[name]["bfloat16"]]
                               + [head_dim_errs[d][name]["bfloat16"] for d in (512, 640, 1024)]),
            "rel_rms_err": max([new_errs[name]["bfloat16_rel"]]
                               + [head_dim_errs[d][name]["bfloat16_rel"] for d in (512, 640, 1024)]),
            **wide_totals(name), "scope": scope,
            "d512": per_call(name, "d512").get("bfloat16", {}),
        })
    split_replaces = {"groupnorm_silu_split_stats": f"{gn_pallas}:121",
                      "groupnorm_silu_split_apply": f"{gn_pallas}:121",
                      "groupnorm_silu_split_bwd_reduce": f"{gn_pallas}:221",
                      "groupnorm_silu_split_bwd_dx": f"{gn_pallas}:248"}
    mp_spatial = mp[0]["sharded"]["spatial"]["train_vae"]
    for name, replaces in split_replaces.items():
        forward = name in ("groupnorm_silu_split_stats", "groupnorm_silu_split_apply")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pti_ldm_vae_tpu_torch/csrc/groupnorm_silu_"
                      f"{'fwd' if forward else 'bwd'}.cu",
            "replaces": replaces,
            "launches": mp_spatial["no_adv"]["split_launches"][name],
            "launches_by_path": {f"train_vae_{run}_spatial2_rank{r}":
                                 mp[r]["sharded"]["spatial"]["train_vae"][run]["split_launches"][name]
                                 for run in MP_RUNS for r in (0, 1)},
            "max_abs_err": mp[0]["split_errs"][name]["bfloat16"],
            "max_abs_err_f32": mp[0]["split_errs"][name]["float32"],
            **mp[0]["split_timings"][name],
            "scope": "bf16, device ms summed over the 42 calls of one b8 pass at spatial 2's "
                     "per-shard shapes ([8, 128, 256, 32] ... [8, 16, 32, 128]); "
                     "launches: entry calls, of which a statistics or backward-reduce call is "
                     "two device launches (per-tile partial sums, then their fold); "
                     "fused_unsharded_ms: the fused kernel at the same calls' unsharded shapes; "
                     "library: torch.var_mean for the statistics, none for the others",
        })
    print(json.dumps({"kernels": kernels}, separators=(",", ":")), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--knob-timings"]:
        sys.exit(timings_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--ddp-child"]:
        sys.exit(ddp_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--mp-child"]:
        sys.exit(mp_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--dims-timings"]:
        sys.exit(dims_timings_child(sys.argv[2]))
    if sys.argv[1:2] == ["--profile-port-child"]:
        sys.exit(profile_port_child(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
