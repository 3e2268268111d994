#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's main paths: base-soft,
depth-soft and NIC greedy captioning, base-soft beam-5 captioning,
base-soft stochastic (nucleus) captioning, the scored evaluation of
base-soft checkpoint sets, the hard-attention and MLP-depth kinds
(base-hard, mdepth-soft, depth-hard, mdepth-hard) greedy, by beam search
and sampled, scored too, the serving surface: the HTTP caption server
(greedy and sampled) and the caption CLI over PNG files with the DPT at
224x224, training (depth-soft, base-soft, nic, base-hard, mdepth-soft),
reference-layout weight files (torchvision, Omnidata, the reference's own
``.pth`` sets) through every loader, resumable training, and the
frozen-stage caches and the rest of training: the train-time feature
cache, gradient accumulation, the bf16 decoder, the profiler window and
the eval set cache with its disk store, sample mode with its attention
overlays and the AOT export, data parallelism (training and scoring
over two ranks, a pipeline over two replicas), and tensor, sequence and
pipeline parallelism (four ranks sharing the card).

Run from the root of a checkout, on a machine with one CUDA card (written
for an NVIDIA H100):

    python3 chip_smoke.py

It imports nothing of JAX. Phases, one line each; any failure raises and
the script exits non-zero:

1. environment: torch, the card, ``nvidia-smi`` name and power limit; TF32
   off for matmuls and convolutions;
2. build: the CUDA kernels from ``depth_image_captioning_pub_torch/csrc``
   with nvcc for sm_90a (ptxas register/spill report printed);
3. decode_step kernel (K1: one cooperative launch, one CTA per SM, on the
   shared decode phases) vs its plain version at full width (K=196,
   D=2048, A=E=H=128) at B = 1, 16 and 64 with bf16 and f32 features: max
   abs error <= 1e-4 on h', c', alpha (f32 sums in another order), two
   calls bit-identical; times (bf16: the kernel's own, from launches
   queued behind a spin kernel, and the rate of calls through the
   wrapper, which the host sets) and the bound at each B, and in the log
   line the launch's plan (``decode_step.LAST_PLAN``) and ptxas'
   registers/spills; then at B=64 on mdepth's f32 features at D=2080 and
   at an odd width (D=2044, A=50, E=H=100, zero-padded for the launch),
   with the same tolerance, in ``ms_by_shape``;
4. greedy decode kernel (K2: one cooperative launch, one CTA per SM,
   weights resident in shared memory) vs its plain version at B = 1, 16
   and 64 (V=9956, 30 steps, <end> set): token agreement >= 0.99 at each
   (random weights make near-ties possible and a flip cascades along its
   row), exact equality with the <end> bias raised so every row ends at
   step 0 (K2's ``max_abs_err`` is the largest token difference of these
   runs); times, the bound, and in the log line the per-step floor of
   re-reading the features, the CTA count and shared memory of the launch
   that ran (``decode_seq.LAST_PLAN``) and ptxas' registers/spills; the
   same at B=64 on mdepth's f32 features at D=2080 and at the odd width;
5. main path: ``CaptionPipeline`` over a seeded random-weight base-soft
   captioner at full width (ResNet-152 bf16, 224x224, V=9956, buckets
   1/16/64) answers requests of 1, 16 and 100 images; the decode kernel's
   launch counter must grow by one per chunk and the plain greedy version
   must not run; tokens are checked against the plain version on one
   request; per-request latency and captions/s are printed, and the time
   split of one chunk at each bucket (encoder, decoder set-up, K2, the
   whole caption program; CUDA events, each stage timed alone).
6. ViT attention kernel (K5, bf16 on the tensor cores) vs its plain version
   at full width (Z=64*12=768, N=577, d=64 bf16), unpadded and padded to
   N=584 with n_valid=577: max and mean abs error <= one bf16 ulp of max|v|
   (p and the output are rounded to bf16, and the f32 sums run in another
   order); the same check and times at the 1- and 16-image requests' Z=12
   and Z=192, at d=32 and d=128 (Z=96) and at tensor parallelism's Z=24 (4
   images x 6 heads), and in f32 at phases 39-40's shapes (Z=24 at N=577,
   Z=12 at N=578 with n_valid=577; max abs err <= 1e-5); ptxas' register
   and spill lines of the kernel's bf16 instances;
7. depth-soft path: ``CaptionPipeline`` over a seeded random-weight
   depth-soft captioner at full width (ResNet-152 bf16 at 224x224, the
   DPT-hybrid bf16 at 384x384, ``DepthCNNEncoder`` bf16, V=9956, buckets
   1/16/64) answers requests of 1, 16 and 64 images; the ViT attention
   counter must grow by 12 per chunk (one per ViT block) and the greedy
   counter by 1, and no plain version may run; the depth maps must be
   finite and in [0, 1]; on the 16-image request the tokens are compared
   with a run whose attention and decode take the plain versions (with the
   errors of each stage between the two runs); the time split of one
   64-image chunk is printed, with K5's share of it.

   Phase 6 also times ``F.scaled_dot_product_attention`` on the same q and
   k/v sliced to n_valid, laid out [B, 12, N, 64]: a yardstick for K5's
   table row, not a path of the port.
8. NIC greedy kernel (K3: one cooperative launch, one CTA per SM, on the
   greedy kernel's phases) vs its plain version at full width (B = 1, 16
   and 64, E=300, H=128, 2 layers, V=9956, 30 steps): token agreement >=
   0.99, exact equality with one token's bias raised by 100, two calls
   bit-identical, at each B; times, the bound, and in the log line the
   launch's plan (``nic_seq.LAST_PLAN``) and ptxas' registers/spills;
9. NIC path: ``CaptionPipeline`` over a seeded random-weight ``nic``
   captioner at full width (ResNet-152 bf16 at 224x224, V=9956, buckets
   1/16/64) answers requests of 1, 16 and 100 images; K3's counter grows by
   one per chunk, K2's does not, no plain version runs; one request's
   tokens are checked against the plain version on the same features;
10. beam kernel (K4: one cooperative launch, one CTA per SM, on the
   greedy kernel's phases) vs its plain version at full width (B = 1, 16
   and 64 images, W=5, V=9956, 30 steps, <end> set): best-token agreement
   and token and parent record agreement >= 0.99, scores' max abs error <=
   1e-3 at each B, and exact tokens and parents (scores within 1e-3) with
   <end> forced and with every token tied (zeroed vocab head) at B=64;
   times, the bound, and in the log line the per-step feature floor, the
   launch's plan (``beam_seq.LAST_PLAN``) and ptxas' registers/spills; the
   kernel is also timed at W=2..8 at B=64, and at W=6..8, on mdepth's f32
   features at D=2080 and at an odd width (D=2044, A=50, E=H=100,
   zero-padded for the launch; exact with <end> forced) held to its plain
   version as at W=5;
11. beam path: ``CaptionPipeline(beam_size=5)`` over the base-soft
   captioner at full width answers requests of 1, 16 and 64 images; K4's
   counter grows by one per chunk, K2's does not, no plain version runs;
   the 16-image request is compared with a run through the plain version.
12. sampling path: ``CaptionPipeline(sample=True, temperature=1.0,
   top_p=0.9, seed=0)`` over the base-soft captioner at full width answers
   requests of 1, 16 and 64 images; K1's counter grows by ``max_length``
   per chunk, K2's and K4's do not, no plain version runs; on the
   16-image request's features the tokens through K1 are compared with a
   run through the plain step on the same noise (agreement >= 0.99,
   alphas' max abs error), and the top_k=1 draws with K2's greedy tokens
   without <end> (>= 0.99); the time split of one chunk at each bucket
   (encoder, set-up, K1 x 30, head + filter + draw x 30, the program).
13. score path: the base-soft captioner's weights (set 1) and two other
   seeds' decoders (sets 2, 3) are written with ``params_to_jax`` and
   ``save_component`` as three checkpoint sets in the JAX trainer's files
   (``ConfigEval.base_soft_parameter_files``, in a temporary directory
   under ``build/``); ``evaluate`` scores them through
   ``load_eval_components`` over an in-memory set of 256 seeded 224x224
   uint8 images with five placeholder-vocabulary references each (batch
   64), then set 1 again with ``beam_size=5``. Each loaded captioner must
   equal the written weights bit for bit; K2's counter must grow by 4 per
   set and K4's by 4 on the beam run, with no plain version; set 1's
   hypotheses must equal ``CaptionPipeline``'s captions of the same arrays
   and differ from set 2's; the seven metrics must hold 3 finite values
   each and the pickle must be written. Per set it prints the load,
   caption and host scoring times and the scored images/s.
14. base-hard path: ``CaptionPipeline(seed=0)`` over a seeded base-hard
   captioner at full width (ResNet-152 bf16, 224x224, V=9956, buckets
   1/16/64; the attention vector and the LSTM's context rows rescaled to a
   trained model's scales, so that the region noise moves tokens) answers
   requests of 1, 16 and 64 images; no kernel launches (hard attention
   runs on PyTorch ops; the JAX package has no TPU kernel for it); the
   same seed repeats the 16-image request's tokens and seed 1 changes
   them; on that request's features and noise the card's decoder agrees
   with the same decoder on the CPU on >= 0.99 of tokens; sampled alphas
   are exactly one-hot; one 16-image request with ``beam_size=5`` and one
   with ``sample=True``; the time split of one 64-image chunk (encoder,
   set-up, the hard loop; the loop on the host clock too).
15. mdepth-soft path: the mdepth-soft captioner at full width (ResNet-152,
   phase 7's DPT, ``DepthMLPEncoder`` on 16x16 depth patches, concat to
   D=2080 f32) answers requests of 1, 16 and 64 images: K5 12 and K2 1
   launches a chunk, no plain version; the 16-image request agrees with a
   run through the plain attention and decode on >= 0.99 of tokens; one
   16-image request with ``beam_size=5`` (K4 1 a chunk) and one with
   ``sample=True`` (K1 30 a chunk); the time split of one 64-image chunk
   (RGB encoder, DPT, MLP encoder, set-up, K2).
16. depth-hard and mdepth-hard at full width: one 16-image request each,
   greedy and with ``beam_size=5``: K5 12 launches, no decode kernel.
    Then one base-hard set (phase 14's captioner, scored twice: identical
   hypotheses) and one mdepth-soft set (phase 15's: K2 4 and K5 48
   launches), written with ``params_to_jax`` and ``save_component`` in the
   JAX trainer's files and scored by ``evaluate`` on phase 13's 256
   images: reloaded weights bit-equal, the load, caption and scoring
   seconds printed.

17. serve: phase 5's base-soft weights written as checkpoint set 1 in the
   JAX trainer's files (``params_to_jax`` + ``save_component``, with a
   vocabulary, in a working directory under ``build/``) and read back by
   ``CaptionPipeline.from_experiment`` (buckets 1/2/4/8/16); ``serve(...)``
   on 127.0.0.1:0 in a thread answers the JAX bench's traffic: 480x640 PNG
   bodies made from ``SEED`` and encoded here with zlib (every scanline
   filter), 50 sequential POSTs, then 16 concurrent clients x 10 POSTs.
   Every reply must be 200; a sequential one must equal the pipeline's
   direct caption of the same decoded array alone (computed before the
   server starts: only the worker thread may use the card while it is
   up). The worker's device calls are recorded (arrays and tokens) and,
   once the server has stopped, each is run again: the encoder at the
   bucket the call was padded to, K2 over the bucket (the served tokens,
   bit for bit), K2 over each row alone at those features (the same
   tokens: no row depends on another) and K2's plain version over the
   bucket (token agreement over all calls at least ``MIN_AGREEMENT``). A
   concurrent reply must be its row's caption in the call that served it;
   for each one that differs from its image's caption alone, the largest
   difference between its features at bucket 1 and at the served bucket
   and the two captions' logit margin at the first token where they part
   are printed. /metrics must show a batch above 1, /healthz every
   image; a POST declaring more than ``MAX_REQUEST_BYTES`` gets 413 and a
   closed connection; after set 1's decoder file is rewritten, /reload
   must give exactly a fresh pipeline's captions over the new files. K2
   launches once a device call, no plain version runs. Prints the
   latency percentiles, captions/s, effective batch, the batch histogram
   and the host decode's share of a request; where Pillow is importable
   the decoder is also held to Pillow's bytes.
18. serve-sample: two servers over that captioner with ``sample=True,
   top_p=0.9`` and one seed answer 16 sequential requests with the same
   captions; K1 launches 30 a device call.
19. caption-depth224-beam3: ``caption.main`` over a directory of 16
   480x640 PNG files at ``--kind depth-soft --beam 3 --dpt-size 224
   --gelu tanh --dpt-head lowres`` in a working directory holding a
   depth-soft set: its output must equal ``CaptionPipeline.
   from_experiment``'s captions of the same paths; K5 12 and K4 1
   launches; K5 at the DPT-at-224 shape (Z = 16 * 12, N = 197, d = 64)
   against its plain version, its time in ``ms_by_shape``. No JPEG: the
   card's machine has no libjpeg headers, so the native library is built
   without its JPEG part there.

20. train-depth-soft, the main training path: ``engine/train.train`` at
   full width (ResNet-152 bf16 at 224x224, ``DepthCNNEncoder`` bf16 with
   f32 parameters and trained BN, K=196, D=2048, A=E=H=128, V=9956,
   ``ConfigTrain``'s B=30 and 32 tokens: 31 teacher-forced steps, lr
   1e-3, dropout 0.5) on an in-memory synthetic set (``data/synthetic.
   SyntheticCaptions``: 90 train and 30 val 224x224 uint8 images, five
   captions each), 2 epochs. First the depth cache of the train images is
   built through phase 7's DPT-hybrid at 384x384 (``engine/depth_cache``,
   batches of 32), validation depth is computed per batch, and the
   best-val files are read back by ``cli.load_eval_components`` and
   scored by ``evaluate`` over the val images: K5 12 launches a DPT chunk
   (3 cache + 2 validation + 1 scoring), K2 1, no plain version; the CSV
   losses finite. Then, on a seeded captioner of the same configuration:
   one train forward + backward on the card against the same on the CPU
   (same features, their regions rescaled by seeded factors, depth maps,
   weights and dropout masks; the depth CNN in f32 on both): loss within
   1e-4 relative, each gradient within 1e-3 of its own max |g| (the
   attention scorer's 1e-2, the depth CNN's 5e-2; the zero-by-symmetry
   gradients below 1e-2 of their module's), BN statistics 1e-4; the
   step's device time by stage (RGB encoder, depth encoder + decoder
   forward, backward, AdamW; CUDA events); 50 steps at lr 1e-2 on one
   batch must halve CE. Printed: train images/s (last epoch and run),
   cache-build images/s and K5's share of it, peak memory.
21-24. train-base-soft, train-nic, train-base-hard (two seeds; and one
   batch's train-mode loss at two generator seeds and two temperatures,
   which must differ, beside the temperature schedule) and
   train-mdepth-soft (per-batch DPT depth: K5 12 a chunk): one epoch of 2
   steps (60 images) and validation each, finite losses, the best-val set
   read back and scored (K2, K3 or none).
25. reference-weights: files in the reference's own layouts, written
   from seeded port modules at full width with the script's inverses of
   ``utils/torch_bridge``'s maps, under ``build/``: set 1 of base-soft
   (phase 5's weights), depth-soft (the depth CNN's ``.pth`` with its BN
   statistics) and nic (the encoder ``.pth`` bundling the projection) as
   ``.pth`` state dicts only, torchvision's ResNet-152 state dict and the
   Omnidata DPT-hybrid ``.ckpt`` of phase 7's DPT (``model.``-prefixed,
   beside a pickled object). Read through ``cli.eval_depth_fn``
   (``dpt_weights``), ``cli.load_eval_components`` + ``params_from_jax``,
   ``cli.load_resnet_variables`` and ``utils.convert`` then
   ``load_component`` / ``DPTDepthEstimator.load_weights``: loaded weights
   bit-equal to the writers', 64 images' tokens (base-soft through K2,
   depth-soft through K5 and K2, nic through K3) and depth maps
   bit-identical to the writers', and the DPT's maps at ``--dpt-size 224
   --gelu tanh --dpt-head lowres`` equal to the written weights' at those
   knobs; K5 36, K2 2, K3 1 launches, no plain version; each file's MB and
   read seconds, each load's seconds.
26. train-resume: base-soft training at phase 20's settings (B=30, full
   width) on 240 + 30 synthetic 224x224 JPEGs read through the config's
   paths, 2 epochs: straight, with ``checkpoint_every=1`` (twice), straight
   again, after a first straight run that is the reference and warms up;
   preempted through ``preempt_event`` after batch 3 of epoch 1
   and resumed; the training CLI (``--checkpoint-every 1``) in a child
   process SIGTERM'd once its epoch-0 checkpoint is on disk, then run with
   ``--resume``. Each run's CSV rows must equal the straight run's within
   1e-5 relative (the largest difference printed, and whether the final
   parameters and AdamW state are bit-equal); the checkpoint's MB, the
   loop's blocking time in ``save`` and the writer thread's seconds, and
   train images/s with and without checkpoints. No kernel launches.

27. train-feature-cache: base-soft at phase 20's settings (B=30, full
   width) on 240 + 30 in-memory synthetic images, 2 epochs, online and
   with ``feature_cache=True``: the cache built first and timed alone
   (images/s; 802,816 bytes an image, the bf16 [196, 2048] grid), which
   ``train`` then opens without a rebuild; the CSV losses of the two runs
   (bit-equal, or their largest relative difference printed; more than
   1e-2 fails); the step online and on cached features (device ms, in
   turns) and each run's last-epoch train images/s. No kernel launches.
28. train-accum: depth-soft at B=30 on one batch (depth maps from phase
   7's DPT), 5 steps with k=1 and with k=3 microbatches: the losses and
   the peak memory of each; then ``train`` with ``grad_accum=3`` for one
   epoch of 60 images with per-batch depth. K5 12 a DPT chunk (1 + 2 + 1).
29. train-bf16: base-soft's bf16 decoder against f32 on one batch's
   cached features: 50 steps, the bf16 loss within 3% of f32's at every
   step (the JAX test's bound) and falling; step ms and peak memory of
   each; parameters stay f32; then ``train`` with
   ``decoder_dtype="bfloat16"`` for one epoch, its best-val files (f32)
   scored through K2 by an f32 captioner.
30. train-profile: the training CLI in a child process (``--profile DIR
   --profile-start 2 --profile-stop 4``, one epoch of 8 steps on phase
   26's JPEGs): exit 0 and one Chrome trace naming aten ops, the AdamW
   step and CUDA kernels. A child, since a process that ran
   ``torch.profiler`` times later work slower.
31. score-cached: three depth-soft sets (one encoder and depth CNN,
   seeded decoders) over phase 13's 256 images kept in ``.npy`` files,
   scored by ``evaluate`` with the eval cache off, on, and twice through
   a disk store (``eval_cache_dir``: filled, then replayed); then three
   NIC sets off and on. Hypotheses and the seven scores ``==`` in every
   mode; per set K5 48 (12 a chunk) on set 1 and 0 after with the cache
   (0 on every set of the disk replay), the frozen encoder's chunks 4 and
   0; K2 (K3 for NIC) 4 a set; per set the caption and copy seconds and
   whether the frozen encoder was copied (sets 2-3 keep it: equal
   trees), beside the time of that copy.
32. sample: ``evaluation base soft sample`` and ``depth soft sample`` on
   a copy of ``sample_pic/dog`` in a working directory under ``build/``
   (phase 5's weights; a seeded depth-soft captioner and a random
   DPT-hybrid at 384), then ``--stochastic`` twice: K1 30 launches an
   image (K5 12 more for depth), no plain version; one readable overlay
   per word, one caption line per image; greedy tokens against
   ``CaptionPipeline``'s K2 on the same array (>= 0.99 up to K2's first
   <end>); the stochastic rerun repeats; per run the caption and overlay
   seconds of an image.
33. export: ``export.py`` on the card: phase 5's weights at buckets 1 and
   16 and sampled at 16, a seeded depth-soft captioner with phase 7's DPT
   at 224 at 16; each artifact loaded and run on 16 seeded images
   (launches: K2 1 a chunk, K1 30 sampled, K5 12 + K2 1 depth-soft, no
   plain version; tokens against the live pipeline's, equal or >= 0.99
   with the flags named); a tiny base-soft artifact exported on the CPU
   and moved to the card against a CUDA export (equal tokens); export
   seconds per bucket, load seconds, MB, the 16-image request's ms
   exported and live, and each ``dcap::`` operator's host microseconds a
   launch against its CUDA implementation called directly (equal
   outputs).

34. train-ddp: depth-soft training at full width (B=30, dropout 0.5, 2
   epochs of 60 in-memory images, train and validation depth from phase
   7's DPT per batch) three ways: the plain trainer; in a NCCL group of
   world size 1, which must be bit-equal to it (losses and every
   trainable tensor, cuDNN deterministic); and over two gloo ranks on
   this card (child processes of this script, ``--ddp-rank``), whose two
   runs must be equal. The bf16 stages round apart at 15 rows a rank and
   at 30 (printed: the ResNet-152 features and the DPT's maps of one
   batch both ways), so the bf16 two-rank run is held to limits set
   between its own readings and those of two planted faults run in the
   same ranks (each rank's gradient left unsummed; the depth CNN's
   BatchNorm statistics left local), each of which must break a limit:
   step 1's loss within 4e-5, any step's within 3e-3 of the largest loss,
   the BN statistics after step 1 within 2e-3, the step-1 gradients
   within 0.25 of their norm. The same training with f32 encoders on
   depth maps cached once (``engine/depth_cache``) is held to the CPU
   tests' bounds (``tests/test_torch_parallel_train.py``): step 1's loss
   within 1e-5, the BN statistics after step 1 within 1e-6 and at the end
   within 5e-2 of their largest value, every trained element after step 1
   within 2 * lr where the two runs' gradients differ in sign or either is
   below 1e-6, else 1e-5, and at the end within 2 * lr for each step at
   which its gradient was below 1e-6, else 1e-5 (the tensors of
   ``DDP_SPREAD``, to which the depth CNN's rounding spreads on the CPU,
   within 2 * lr a step; at full width it reaches the other decoder
   tensors by up to 2.53e-4, held within the rule plus 1e-3); the later
   steps' losses within 1e-4 relative. K5 12 a DPT
   chunk in each bf16 run and rank and in the caches; the median device
   ms of a step at world 1 and 2.
35. score-ddp: two depth-soft sets over 128 seeded images at batch 64,
   scored by ``evaluate`` over those two ranks (32 rows each): rank 0's
   hypotheses and seven scores must equal one rank's at the ranks'
   per-card batch of 32 (and are compared with one rank at 64); K5 24 and
   K2 4 launches a rank.
36. serve-devices: ``CaptionPipeline(devices=["cuda:0", "cuda:0"])`` over
   phase 5's weights answers requests of 16, 64 and 7 images: K2 2 a
   chunk (one a replica), tokens equal to one device's pipeline on each
   replica's half of the rows, and >= 0.99 of them equal to one device's
   over the whole request.

Phases 37-40 run in four gloo ranks on this card (child processes of this
script, ``--mp-rank``), on a (data 2, model 2) mesh (``parallel/tp``) and
a mesh of 4 stages (``parallel/pp``), each path with the counters set to 0
just before it and read just after in every rank, K5 a DPT block (no
decode kernel: a split decoder refuses them), and each held to one
process on the same inputs:

37. train-tp: depth-soft at full width (phase 7's DPT, bf16, its ViT
   blocks split by heads and MLP; the captioner's decoder split over V,
   the LSTM gates and the embedding), 5 AdamW steps on one batch of 8
   (4 rows a data row), the depth maps made by the split DPT: the loss
   falls, every rank's losses are equal, and every step's is within
   ``MP_LOSS_RTOL`` of one process's on the same batch, depth maps and
   dropout draws; the same run under a planted fault (``MpFault``:
   copy-to-region's backward without its all-reduce) must part from one
   process by more.
38. tp-greedy: ``make_caption_fn`` over a split depth-soft captioner and
   DPT on 32 images (f32 decoder, V=9956): tokens >= 0.99 equal to one
   process's step loop (``AttentionDecoder.loop_greedy``) on the ranks'
   own features and depth maps, and their agreement with K2 there.
39. sp-dpt: the DPT with its 577 tokens split over the model axis (padded
   to 578) and its blocks split, f32 and bf16, 4 images: the f32 maps
   within ``MP_SP_F32_ATOL`` of the unsplit DPT's; bf16's gap printed as a
   share of the map's max.
40. pp-vit: the f32 DPT's 12 ViT blocks as 4 stages of 3, B=8, M=4:
   taps 8 and 11 within ``MP_PP_RTOL`` of their max of the sequential
   fold; every rank returns the same taps.

The ranks' waits are bounded (``wait_ranks``: one deadline for a group,
the others killed as soon as one rank fails; each rank's collectives give
up after ``RANK_TIMEOUT_S`` without their peers).

Each path (phases 5, 7, 9, 11-40: ``PATHS``) runs with every launch counter
set to 0 just before it and read just after. The line before the last is a JSON
object with the five ported kernels (K1 step, K2 greedy, K3 NIC greedy, K4
beam, K5 ViT attention): launches per path, error, time beside the plain
version's, the least time the card could take for the same work
(``bound_ms``: the larger of the bytes moved over 3.35 TB/s and the
operations over 67 TFLOP/s f32, or 989 TFLOP/s bf16 for K5, from this
run's inputs) and the time of one PyTorch call computing the same function
where there is one (``library_ms``: SDPA for K5; no single PyTorch call
computes a whole decode loop or step, so K1-K4 have none); every kernel
also carries ``ms_by_shape``. The last line is
``{"ok": true, "device": {...}}``.
"""

import datetime
import json
import subprocess
import sys
import time

import numpy as np

B, K, D, A, E, H = 64, 196, 2048, 128, 128, 128
VOCAB = 9956
MAX_LEN = 30
SEQ_BATCHES = (1, 16, 64)   # K1-K4 at the main path's chunk sizes
STEP_ATOL = 1e-4
MIN_AGREEMENT = 0.99
SCORE_ATOL = 1e-3   # beam scores: 30 f32 log-softmax terms summed
STEP_SRC = "depth_image_captioning_pub_torch/csrc/decode_step.cu"
SEQ_SRC = "depth_image_captioning_pub_torch/csrc/decode_seq.cu"
STEP_TPU = "depth_image_captioning_pub_tpu/ops/pallas/decode_step.py:175"
SEQ_TPU = "depth_image_captioning_pub_tpu/ops/pallas/decode_seq.py:287"
VIT_SRC = "depth_image_captioning_pub_torch/csrc/vit_attention.cu"
VIT_TPU = "depth_image_captioning_pub_tpu/ops/pallas/vit_attention.py:77"
VIT_Z, VIT_N, VIT_D = 64 * 12, 577, 64
# K5 also at the 1- and 16-image requests' Z, at the other head dims and
# at tensor parallelism's 4 images x 6 of the 12 heads (phases 37-38)
VIT_MORE = ((12, 64), (192, 64), (96, 32), (96, 128), (24, 64))  # Z, d
# f32 K5 as phases 39-40 launch it: pp-vit's microbatch of 2 images x 12
# heads at N=577, sp-dpt's 2 images x 6 heads over the 578 gathered tokens
VIT_F32 = ((24, VIT_N), (12, VIT_N + 1))       # Z, N at n_valid=577, d=64
VIT_F32_ATOL = 1e-5
NIC_SRC = "depth_image_captioning_pub_torch/csrc/nic_seq.cu"
NIC_TPU = "depth_image_captioning_pub_tpu/ops/pallas/nic_seq.py:178"
BEAM_SRC = "depth_image_captioning_pub_torch/csrc/beam_seq.cu"
BEAM_TPU = "depth_image_captioning_pub_tpu/ops/pallas/beam_seq.py:475"
NIC_E, NIC_LAYERS = 300, 2
BEAM = 5
D_CONCAT = 2080          # mdepth-*: 2048 RGB + 32 depth channels, f32
# an odd width, zero-padded for K1, K2 and K4: D, and A, E, H in the
# AttentionDecoder's argument order (dim_attention, dim_embedding,
# dim_encoder, dim_decoder)
ODD_D, ODD_A, ODD_E, ODD_H = 2044, 50, 100, 100
ODD_AEDH = (ODD_A, ODD_E, ODD_D, ODD_H)
ODD_LABEL = f"odd D={ODD_D} A={ODD_A} E={ODD_E} H={ODD_H}"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS = 67e12              # H100 SXM f32, CUDA cores (TF32 off)
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
PATHS = ("base-soft", "depth-soft", "nic", "base-soft-beam5",
         "base-soft-sample", "score", "base-hard", "base-hard-beam5",
         "base-hard-sample", "mdepth-soft", "mdepth-soft-beam5",
         "mdepth-soft-sample", "depth-hard", "depth-hard-beam5",
         "mdepth-hard", "mdepth-hard-beam5", "score-base-hard",
         "score-mdepth-soft", "serve", "serve-sample",
         "caption-depth224-beam3", "train-depth-soft", "train-base-soft",
         "train-nic", "train-base-hard", "train-mdepth-soft",
         "reference-weights", "train-resume", "train-feature-cache",
         "train-accum", "train-bf16", "train-profile", "score-cached",
         "sample", "export", "train-ddp", "score-ddp", "serve-devices",
         "train-tp", "tp-greedy", "sp-dpt", "pp-vit")
DDP_PATHS = PATHS[-7:-4]
TOP_P = 0.9          # the sampling path's nucleus
SCORE_IMAGES, SCORE_SETS, SCORE_BATCH = 256, 3, 64
SEED = 0             # the serving phases' request images


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters):
    """Mean device time of fn() over iters calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def queued_ms(fn, iters, spin_cycles=20_000_000, tries=4):
    """Mean device time of fn() over iters calls queued behind a spin
    kernel, so that the card runs them back to back whatever the host's
    launch rate: a short kernel's own time, where ``cuda_ms`` gives the
    rate at which the host can call it. The spin starts at spin_cycles
    (~10 ms); where the host took longer than that to queue the calls, it
    grows to three times the host's time and the calls are queued again,
    up to tries times in all."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for _ in range(tries):
        torch.cuda._sleep(spin_cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = spin_cycles / 2.0e6        # the spin at 2 GHz, the most
        if host_ms <= 0.8 * spin_ms:
            return start.elapsed_time(stop) / iters
        spin_cycles = int(3 * host_ms * 2.0e6)
    raise RuntimeError(f"the host took {host_ms:.2f} ms to queue {iters} "
                       f"calls: longer than the spin of {spin_ms:.2f} ms, "
                       f"{tries} times")


def bound(nbytes, flops, peak):
    """(ms, "bytes" or "operations"): the least time for the work, the
    larger of the bytes over the memory rate and the operations over the
    peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def step_flops(k, d, a, e, h):
    """Multiply-adds x 2 of one attention-LSTM step for one row."""
    return 2 * (h * a + k * a + k * d + h * d + (e + d + h) * 4 * h)


def kernel_modules():
    from depth_image_captioning_pub_torch.ops.kernels import (
        beam_seq, decode_seq, decode_step, nic_seq, vit_attention)
    return {"decode_step": decode_step, "decode_seq": decode_seq,
            "nic_seq": nic_seq, "beam_seq": beam_seq,
            "vit_attention": vit_attention}


def reset_counts():
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0


def read_counts():
    return {name: mod.LAUNCHES for name, mod in kernel_modules().items()}


class PlainCalls:
    """Within the block, every plain version of the kernels counts its
    calls in ``calls`` (the wrappers look them up by module name)."""

    NAMES = {"decode_step": "fused_decode_core_plain",
             "decode_seq": "fused_greedy_decode_plain",
             "nic_seq": "fused_nic_greedy_decode_plain",
             "beam_seq": "fused_beam_decode_plain",
             "vit_attention": "fused_attention_plain"}

    def __enter__(self):
        self.calls = []
        self.saved = []
        for key, name in self.NAMES.items():
            mod = kernel_modules()[key]
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._counting(fn))
        return self

    def _counting(self, fn):
        def wrapped(*args, **kwargs):
            self.calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def run_requests(pipe, requests, smi, tag):
    """Time each request (host clock, tokens on the host); counters reset
    just before and read just after."""
    import torch
    outputs, lines = [], []
    torch.cuda.synchronize()
    reset_counts()
    with PlainCalls() as plain:
        for req in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = pipe.caption_tokens(req)
            dt = time.perf_counter() - t0
            outputs.append(toks)
            lines.append(f"{len(req)} images: {dt * 1e3:.1f} ms, "
                         f"{len(req) / dt:.1f} caps/s")
    launches = read_counts()
    if plain.calls:
        raise RuntimeError(f"plain versions ran on the {tag} path: "
                           f"{sorted(set(plain.calls))}")
    for req, toks in zip(requests, outputs):
        if (toks.shape != (len(req), MAX_LEN) or toks.dtype != np.int32
                or toks.min() < 0 or toks.max() >= VOCAB):
            raise RuntimeError(f"bad tokens {toks.dtype} {toks.shape}")
    for line in lines:
        log(tag, f"{line} [{smi}]")
    return outputs, launches


def phase_env():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}")
    log("env", f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from depth_image_captioning_pub_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    log("build", f"{_build.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.BUILD_SECONDS:.1f} s)")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build", "ptxas " + line.strip())


def phase_step(smi):
    """K1 at B = 1, 16 and 64 (the sampling path's chunk sizes) against
    its plain version, bf16 and f32 features: error, bit-identical
    repeats, times, the bound and the launch's plan."""
    import torch
    from depth_image_captioning_pub_torch.models.initializers import (
        torch_linear_kernel)
    from depth_image_captioning_pub_torch.ops.kernels import decode_step
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)

    def u(*shape):
        return torch_linear_kernel(shape, gen).to(dev)

    w = decode_step.pack_weights(u(H, A), u(A), u(A), u(1), u(H, D), u(D),
                                 u(E + D, 4 * H), u(H, 4 * H), u(4 * H),
                                 u(4 * H), dim_embedding=E)
    feats64 = torch.from_numpy(np.abs(rng.standard_normal((B, K, D)))
                               .astype(np.float32)).to(dev)
    proj64 = torch.from_numpy(rng.standard_normal((B, K, A)).astype(
        np.float32) * 0.5).to(dev)
    emb64, h64, c64 = (torch.from_numpy(rng.standard_normal((B, n)).astype(
        np.float32) * 0.5).to(dev) for n in (E, H, H))
    for args, line in ptxas_report("step_kernel").items():
        log("decode_step", f"ptxas, "
            f"{'bf16' if 'bfloat16' in args else 'f32'} features: {line}")
    by_shape, worst = {}, 0.0
    for bsz in SEQ_BATCHES:
        rows = [t[:bsz].contiguous() for t in (proj64, emb64, h64, c64)]
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            feats = feats64[:bsz].to(dtype).contiguous()
            args = (feats, *rows, w)
            got = decode_step.fused_decode_core(*args)
            torch.cuda.synchronize()
            plan = decode_step.LAST_PLAN      # the plan of that launch
            again = decode_step.fused_decode_core(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise RuntimeError(f"two decode_step calls differ at "
                                   f"B={bsz}")
            want = decode_step.fused_decode_core_plain(*args)
            if not all(torch.isfinite(g).all() for g in got):
                raise RuntimeError("decode_step kernel produced non-finite "
                                   "values")
            err = max((g - x).abs().max().item() for g, x in zip(got, want))
            if err > STEP_ATOL:
                raise RuntimeError(f"decode_step max abs err {err} > "
                                   f"{STEP_ATOL} at B={bsz}, {dtype}")
            errs[dtype] = err
            worst = max(worst, err)
        # times on the path's bf16 features: the kernel's own (queued
        # launches) and the wrapper's call rate
        ms = queued_ms(lambda: decode_step.fused_decode_core(*args), 50)
        call_ms = cuda_ms(lambda: decode_step.fused_decode_core(*args), 50)
        plain_ms = cuda_ms(
            lambda: decode_step.fused_decode_core_plain(*args), 50)
        bound_ms, bound_by = bound(nbytes(*args[:5], *w, *got),
                                   bsz * step_flops(K, D, A, E, H),
                                   F32_FLOPS)
        by_shape[f"B={bsz}"] = {
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": max(errs.values())}
        log("decode_step", f"B={bsz} K={K} D={D} A=E=H={H}: max abs err "
            f"bf16 {errs[torch.bfloat16]:.3e}, f32 "
            f"{errs[torch.float32]:.3e} (tol {STEP_ATOL}); two calls "
            f"bit-identical; kernel {ms:.4f} ms (launches queued; "
            f"{call_ms:.4f} ms a call through the wrapper), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
            f"(bf16); one cooperative "
            f"launch of {plan.ctas} CTAs x {decode_step.THREADS} threads, "
            f"{plan.smem_bytes} B shared memory each ({plan.h_cols} "
            f"h-product columns, {plan.units} hidden unit(s), h tile "
            f"{plan.h_rows} rows, attention chunk {plan.a_chunk}) [{smi}]")
    # mdepth's f32 features at D=2080, and an odd width (zero-padded for
    # the launch), at B=64
    for label, (d, a, e, h), dtype in (
            (f"B={B} D={D_CONCAT} f32", (D_CONCAT, A, E, H), torch.float32),
            (f"B={B} {ODD_LABEL}", (ODD_D, ODD_A, ODD_E, ODD_H),
             torch.bfloat16)):
        wx = decode_step.pack_weights(
            u(h, a), u(a), u(a), u(1), u(h, d), u(d), u(e + d, 4 * h),
            u(h, 4 * h), u(4 * h), u(4 * h), dim_embedding=e)
        feats = torch.from_numpy(np.abs(rng.standard_normal((B, K, d)))
                                 .astype(np.float32)).to(dev, dtype)
        rows = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.5).to(dev)
            for shape in ((B, K, a), (B, e), (B, h), (B, h))]
        args = (feats, *rows, wx)
        got = decode_step.fused_decode_core(*args)
        torch.cuda.synchronize()
        again = decode_step.fused_decode_core(*args)
        want = decode_step.fused_decode_core_plain(*args)
        if not all(torch.equal(g, x) for g, x in zip(got, again)):
            raise RuntimeError(f"two decode_step calls differ at {label}")
        err = max((g - x).abs().max().item() for g, x in zip(got, want))
        if not err <= STEP_ATOL:
            raise RuntimeError(f"decode_step max abs err {err} > "
                               f"{STEP_ATOL} at {label}")
        worst = max(worst, err)
        # at the odd width each call also pads its inputs (~20 small
        # launches): fewer calls, so that they fit the launch queue behind
        # a longer spin
        ms = queued_ms(lambda: decode_step.fused_decode_core(*args), 10,
                       spin_cycles=100_000_000)
        call_ms = cuda_ms(lambda: decode_step.fused_decode_core(*args), 50)
        plain_ms = cuda_ms(
            lambda: decode_step.fused_decode_core_plain(*args), 50)
        bound_ms, bound_by = bound(nbytes(*args[:5], *wx, *got),
                                   B * step_flops(K, d, a, e, h), F32_FLOPS)
        by_shape[label] = {
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
        log("decode_step", f"{label} {dtype}: max abs err {err:.3e} (tol "
            f"{STEP_ATOL}); two calls bit-identical; kernel {ms:.4f} ms "
            f"(launches queued; {call_ms:.4f} ms a call through the "
            f"wrapper), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}) [{smi}]")
    main = by_shape[f"B={B}"]
    log("decode_step", f"source {STEP_SRC}, replaces {STEP_TPU}")
    return {"name": "decode_step", "route": "cuda", "source": STEP_SRC,
            "replaces": STEP_TPU, "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "ms_by_shape": by_shape}


def phase_seq(smi):
    """K2 at B = 1, 16 and 64 (the main path's chunk sizes) against its
    plain version: token agreement, exact with <end> forced, times, the
    bound, the per-step feature floor and the launch's plan; then at B=64
    on mdepth's f32 features at D=2080 and at an odd width (zero-padded
    for the launch)."""
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.models.decoder import (
        AttentionDecoder)
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    from depth_image_captioning_pub_torch.ops.kernels import decode_seq
    dev = torch.device("cuda")
    w2i, _ = placeholder_vocab(VOCAB)
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    dec = AttentionDecoder(VOCAB, A, E, D, H, device=dev)
    dec.reset_parameters(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(2)
    feats64 = torch.from_numpy(np.abs(rng.standard_normal((B, K, D)))
                               .astype(np.float32)).to(dev, torch.bfloat16)
    for args, line in ptxas_report("greedy_tiled_kernel").items():
        log("decode_seq", f"ptxas, "
            f"{'bf16' if 'bfloat16' in args else 'f32'} features: {line}")
    by_shape, end_err = {}, 0.0

    def greedy_case(dec, feats, label):
        bsz, k, d = feats.shape
        h, a = dec.att_w_dec.shape
        e = dec.dim_embedding
        with torch.inference_mode():
            proj = project_features(dec.att_params(), feats,
                                    compute_dtype=torch.float32)
            state = dec.init_state(feats)
            w = dec.seq_weights()

            def run(fn, weights):
                return fn(feats, proj, state.h, state.c, weights,
                          max_length=MAX_LEN, start_id=start_id,
                          end_id=end_id)

            got = run(decode_seq.fused_greedy_decode, w)
            torch.cuda.synchronize()
            plan = decode_seq.LAST_PLAN      # the plan of that launch
            want = run(decode_seq.fused_greedy_decode_plain, w)
            agree = (got == want).float().mean().item()
            distinct = len({tuple(r) for r in got.tolist()})
            if agree < MIN_AGREEMENT:
                raise RuntimeError(f"greedy token agreement {agree} < "
                                   f"{MIN_AGREEMENT} at {label}")
            ms = cuda_ms(lambda: run(decode_seq.fused_greedy_decode, w), 10)
            plain_ms = cuda_ms(
                lambda: run(decode_seq.fused_greedy_decode_plain, w), 10)
            b_out = w.b_out.clone()
            b_out[0, end_id] += 100.0
            w_end = w._replace(b_out=b_out)
            got_end = run(decode_seq.fused_greedy_decode, w_end)
            torch.cuda.synchronize()
            want_end = run(decode_seq.fused_greedy_decode_plain, w_end)
            err = (got_end - want_end).abs().max().item()
            if err != 0 or not bool((got_end == end_id).all()):
                raise RuntimeError(f"greedy kernel with <end> forced differs "
                                   f"from the plain version at {label}")
        # the steps this run's rows took: up to and including their <end>
        ended = (got == end_id).cpu().numpy()
        steps = int(np.where(ended.any(1), ended.argmax(1) + 1,
                             MAX_LEN).sum())
        bound_ms, bound_by = bound(
            nbytes(feats, proj, state.h, state.c, *w.step, w.w_out, w.b_out,
                   got) + steps * e * 4,
            steps * (step_flops(k, d, a, e, h) + 2 * h * VOCAB), F32_FLOPS)
        # the kernel reads the features again every step (they exceed the
        # L2 at B=64): that stream alone, per step and over the steps run
        loop_steps = int(np.where(ended.any(1), ended.argmax(1) + 1,
                                  MAX_LEN).max())
        floor_step = nbytes(feats) / HBM_BYTES_PER_S * 1e3
        by_shape[label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "token_agreement": agree}
        log("decode_seq", f"{label} K={k} D={d} A={a} E={e} H={h} "
            f"{feats.dtype} V={VOCAB} L={MAX_LEN} end_id={end_id}: "
            f"token agreement {agree:.4f} (min {MIN_AGREEMENT}), {distinct} "
            f"distinct rows, {steps} row-steps; <end>-forced run exact; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), feature floor "
            f"{floor_step * 1e3:.2f} us/step x {loop_steps} steps = "
            f"{floor_step * loop_steps:.4f} ms; one cooperative launch of "
            f"{plan.ctas} CTAs x {decode_seq.THREADS} threads, "
            f"{plan.smem_bytes} B "
            f"shared memory each ({plan.h_cols} h-product columns, "
            f"{plan.units} hidden unit(s), h tile {plan.h_rows} rows) "
            f"[{smi}]")
        return err

    for bsz in SEQ_BATCHES:
        end_err = max(end_err, greedy_case(dec, feats64[:bsz].contiguous(),
                                           f"B={bsz}"))
    # mdepth-soft's features: f32 at D=2080, twice bf16's bytes at D=2048
    dec_c = AttentionDecoder(VOCAB, A, E, D_CONCAT, H, device=dev)
    dec_c.reset_parameters(torch.Generator().manual_seed(3))
    feats_c = torch.from_numpy(np.abs(rng.standard_normal((B, K, D_CONCAT)))
                               .astype(np.float32)).to(dev)
    end_err = max(end_err, greedy_case(dec_c, feats_c,
                                       f"B={B} D={D_CONCAT} f32"))
    del feats_c
    dec_o = AttentionDecoder(VOCAB, *ODD_AEDH, device=dev)
    dec_o.reset_parameters(torch.Generator().manual_seed(4))
    feats_o = torch.from_numpy(np.abs(rng.standard_normal((B, K, ODD_D)))
                               .astype(np.float32)).to(dev, torch.bfloat16)
    end_err = max(end_err, greedy_case(dec_o, feats_o,
                                       f"B={B} {ODD_LABEL}"))
    main = by_shape[f"B={B}"]
    return {"name": "decode_seq", "route": "cuda", "source": SEQ_SRC,
            "replaces": SEQ_TPU, "max_abs_err": end_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "token_agreement": main["token_agreement"],
            "ms_by_shape": by_shape}


def phase_main_path(smi):
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.engine.evaluate import (
        make_caption_fn)
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import decode_seq
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    t0 = time.perf_counter()
    cap = build_captioner("base-soft", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(0))
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(1, 16, 64))
    log("main", f"base-soft ResNet-152 bf16 + decoder, V={VOCAB}, "
        f"{sum(p.numel() for p in cap.parameters()) / 1e6:.1f}M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    images = np.random.default_rng(0).integers(
        0, 256, (117, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:117]]
    for size in (1, 16, 64):          # warm-up: one call per bucket
        pipe.caption_tokens(images[:size])

    outputs, launches = run_requests(pipe, requests, smi, "main")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    want = dict.fromkeys(launches, 0)
    want["decode_seq"] = chunks
    if launches != want:
        raise RuntimeError(f"base-soft launches {launches}, expected {want} "
                           f"for {chunks} chunks")

    # reference on one request: the plain decode on the same features
    with torch.inference_mode():
        x = torch.from_numpy(requests[1]).to(dev)
        feats = cap.encoder(imagenet_normalize(to_unit_float(x)))
        if not bool(torch.isfinite(feats).all()):
            raise RuntimeError("encoder features are not finite")
        dec = cap.decoder
        proj = project_features(dec.att_params(), feats,
                                compute_dtype=torch.float32)
        state = dec.init_state(feats)
        ref = decode_seq.fused_greedy_decode_plain(
            feats, proj, state.h, state.c, dec.seq_weights(),
            max_length=MAX_LEN, start_id=w2i[SPECIAL.start],
            end_id=w2i[SPECIAL.end]).cpu().numpy()
    agree = float((ref == outputs[1]).mean())
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"main path vs plain decode agreement {agree}")
    caps = pipe(list(requests[0])) + pipe(list(requests[1][:2]))
    log("main", f"16-image request vs plain decode on the same features: "
        f"token agreement {agree:.4f}; features {tuple(feats.shape)} "
        f"{feats.dtype}, |feat| max {feats.abs().max().item():.3e}")
    for c in caps:
        log("main", f"caption: {c!r}")
    log("main", f"launches {launches} for {chunks} chunks; plain calls 0")

    # time split of one chunk at each bucket, each stage timed alone
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    program = make_caption_fn(cap, start_id, MAX_LEN, end_id=end_id)
    with torch.inference_mode():
        for bsz in (1, 16, 64):
            ev = Events()
            x = torch.from_numpy(images[:bsz]).to(dev)
            f = ev.ms("encoder", lambda: cap.encoder(
                imagenet_normalize(to_unit_float(x))))

            def setup():
                proj = project_features(dec.att_params(), f,
                                        compute_dtype=torch.float32)
                return proj, dec.init_state(f), dec.seq_weights()

            proj, state, w = ev.ms("decoder set-up", setup)
            ev.ms("greedy decode (K2)", lambda: decode_seq.fused_greedy_decode(
                f, proj, state.h, state.c, w, max_length=MAX_LEN,
                start_id=start_id, end_id=end_id))
            ev.ms("caption program", lambda: program(x))
            log("main", f"{bsz}-image chunk split (device ms, each stage "
                "timed alone): " + ", ".join(
                    f"{k} {v:.2f}" for k, v in ev.times.items())
                + f" [{smi}]")
    return launches, cap


def bf16_ulp(x):
    """One bf16 ulp at max|x| (8 significant bits)."""
    import math
    m = float(x.abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def ptxas_report(kernel, typed=False):
    """{template arguments: "registers, spills"} of the build's instances of
    ``kernel``, from ptxas' -v lines in the build log; ``typed`` puts the
    feature type (bf16 or f32) before the integer arguments."""
    import re
    from depth_image_captioning_pub_torch.ops.kernels import _build
    report, name = {}, None
    for line in _build.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and ("registers" in line or "spill" in line):
            args = ",".join(re.findall(r"Li(\d+)E", name)) or name
            if typed:
                args = ("bf16 " if "bfloat16" in name else "f32 ") + args
            report.setdefault(args, []).append(line.split(":")[-1].strip())
    return {args: "; ".join(lines) for args, lines in report.items()}


def attention_case(q, k, v, n_valid, iters=10, tol=None):
    """K5 vs its plain version on q/k/v: (max abs err, mean abs err, tol,
    kernel ms, plain ms); raises on non-finite output or err > tol (by
    default one bf16 ulp of max|v|)."""
    import torch
    from depth_image_captioning_pub_torch.ops.kernels import vit_attention
    scale = q.shape[-1] ** -0.5

    def run(fn):
        return fn(q, k, v, scale=scale, n_valid=n_valid)

    got = run(vit_attention.fused_attention)
    torch.cuda.synchronize()
    want = run(vit_attention.fused_attention_plain)
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("vit_attention kernel produced non-finite values")
    diff = (got.float() - want.float()).abs()
    tol = bf16_ulp(v) if tol is None else tol
    err, mean = diff.max().item(), diff.mean().item()
    if err > tol:
        raise RuntimeError(f"vit_attention {tuple(q.shape)} n_valid="
                           f"{n_valid}: max abs err {err} > {tol}")
    ms = cuda_ms(lambda: run(vit_attention.fused_attention), iters)
    plain_ms = cuda_ms(lambda: run(vit_attention.fused_attention_plain),
                       iters)
    return err, mean, tol, ms, plain_ms


def phase_vit(smi):
    import torch
    import torch.nn.functional as F
    from depth_image_captioning_pub_torch.ops.kernels import vit_attention
    dev = torch.device("cuda")
    for args, line in ptxas_report("attention_bf16_kernel").items():
        log("vit_attention", f"ptxas bf16 route, d={args}: {line}")
    rng = np.random.default_rng(6)

    def qkv(z, n, d):
        return [torch.from_numpy(rng.standard_normal((z, n, d)).astype(
            np.float32)).to(dev, torch.bfloat16) for _ in range(3)]

    q, k, v = qkv(VIT_Z, VIT_N + 7, VIT_D)
    scale = VIT_D ** -0.5
    worst = 0.0
    timed = {}
    for n, n_valid in ((VIT_N, VIT_N), (VIT_N + 7, VIT_N)):
        args = [t[:, :n].contiguous() for t in (q, k, v)]
        err, mean, tol, ms, plain_ms = attention_case(*args, n_valid)
        timed[n] = (ms, plain_ms)
        worst = max(worst, err)
        log("vit_attention", f"Z={VIT_Z} N={n} n_valid={n_valid} d={VIT_D} "
            f"bf16: max abs err {err:.3e}, mean {mean:.3e} (tol {tol:.3e}, "
            f"one bf16 ulp of max|v|); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms [{smi}]")
    ms, plain_ms = timed[VIT_N]
    by_shape = {}
    for z, d in VIT_MORE:
        err, mean, tol, k_ms, p_ms = attention_case(*qkv(z, VIT_N, d), VIT_N)
        worst = max(worst, err)
        by_shape[f"Z={z} N={VIT_N} d={d}"] = {
            "ms": k_ms, "plain_ms": p_ms, "max_abs_err": err}
        log("vit_attention", f"Z={z} N={VIT_N} d={d} bf16: max abs err "
            f"{err:.3e}, mean {mean:.3e} (tol {tol:.3e}); kernel {k_ms:.4f} "
            f"ms, plain {p_ms:.3f} ms [{smi}]")
    for z, n in VIT_F32:
        args = [t.float() for t in qkv(z, n, VIT_D)]
        err, mean, tol, k_ms, p_ms = attention_case(*args, VIT_N,
                                                    tol=VIT_F32_ATOL)
        by_shape[f"Z={z} N={n} n_valid={VIT_N} d={VIT_D} f32"] = {
            "ms": k_ms, "plain_ms": p_ms, "max_abs_err": err}
        log("vit_attention", f"Z={z} N={n} n_valid={VIT_N} d={VIT_D} f32: "
            f"max abs err {err:.3e}, mean {mean:.3e} (tol {tol:.0e}); "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms [{smi}]")

    # yardstick: one PyTorch call for the same function, keys < n_valid
    n, n_valid = VIT_N + 7, VIT_N
    bsz, heads = VIT_Z // 12, 12

    q4, k4, v4 = (t[:, :rows].reshape(bsz, heads, rows, VIT_D).contiguous()
                  for t, rows in ((q, n), (k, n_valid), (v, n_valid)))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)

    args = [t[:, :n].contiguous() for t in (q, k, v)]
    want = vit_attention.fused_attention_plain(*args, scale=scale,
                                               n_valid=n_valid)
    sdpa_err = (sdpa().reshape(VIT_Z, n, VIT_D).float()
                - want.float()).abs().max().item()
    sdpa_ms = cuda_ms(sdpa, 10)
    z_rows = VIT_Z * VIT_N
    bound_ms, bound_by = bound(4 * z_rows * VIT_D * 2,
                               4 * z_rows * VIT_N * VIT_D, BF16_FLOPS)
    log("vit_attention", f"F.scaled_dot_product_attention on q [B={bsz}, 12, "
        f"{n}, {VIT_D}] and k/v sliced to n_valid={n_valid}: {sdpa_ms:.4f} "
        f"ms, max abs err {sdpa_err:.3e} against the plain version; K5 at "
        f"N={VIT_N} {ms:.4f} ms, {ms / sdpa_ms:.2f}x SDPA, bound "
        f"{bound_ms:.4f} ms ({bound_by}) [{smi}]")
    return {"name": "vit_attention", "route": "cuda", "source": VIT_SRC,
            "replaces": VIT_TPU, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": sdpa_ms, "sdpa_ms": sdpa_ms,
            "sdpa_max_abs_err": sdpa_err, "ms_by_shape": by_shape}


class Events:
    """Device time of named stages, each timed on its own after a
    warm-up: ``ms(name, fn)`` returns fn's result and records its mean
    time over ``iters`` runs."""

    def __init__(self, iters=3):
        self.iters, self.times = iters, {}

    def ms(self, name, fn):
        import torch
        out = fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(self.iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        self.times[name] = start.elapsed_time(stop) / self.iters
        return out


def phase_depth_path(smi):
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.models import decoder as dec_mod
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.models.dpt import DPTDepthEstimator
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        dpt_normalize, imagenet_normalize, resize_bilinear, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import (
        decode_seq, vit_attention)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    t0 = time.perf_counter()
    cap = build_captioner("depth-soft", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(0))
    est = DPTDepthEstimator(device=dev)
    est.init(torch.Generator().manual_seed(1))
    depth_fn = est.depth_fn()
    pipe = CaptionPipeline(cap, w2i, i2w, depth_fn=depth_fn,
                           max_length=MAX_LEN, batch_buckets=(1, 16, 64))
    n_params = sum(p.numel() for p in cap.parameters())
    n_dpt = sum(p.numel() for p in est.model.parameters())
    log("depth", f"depth-soft: ResNet-152 bf16 + DepthCNNEncoder bf16 + "
        f"decoder {n_params / 1e6:.1f}M params, DPT-hybrid bf16 at 384x384 "
        f"{n_dpt / 1e6:.1f}M params, V={VOCAB}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    images = np.random.default_rng(1).integers(
        0, 256, (81, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:81]]
    for size in (1, 16, 64):          # warm-up: one call per bucket
        pipe.caption_tokens(images[:size])

    plains = {mod: mod.__dict__[name] for mod, name in (
        (vit_attention, "fused_attention_plain"),
        (decode_seq, "fused_greedy_decode_plain"))}
    outputs, launches = run_requests(pipe, requests, smi, "depth")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    want = dict.fromkeys(launches, 0)
    want.update(decode_seq=chunks,
                vit_attention=len(est.model.blocks) * chunks)
    if launches != want:
        raise RuntimeError(f"depth-soft launches {launches}, expected "
                           f"{want} for {chunks} chunks")
    log("depth", f"launches {launches} for {chunks} chunks; plain calls 0")

    # the 16-image request again, stage by stage, with the kernels and
    # then with the plain versions of the attention and the decode
    def stages(x):
        x = to_unit_float(x)
        feats = cap.encoder(imagenet_normalize(x))
        depth = depth_fn(x)
        dfeats = cap.depth_module(depth)
        toks = cap.decoder.greedy_sample(feats, start_id, dfeats,
                                         max_length=MAX_LEN, end_id=end_id)
        return depth, dfeats, cap.decoder.fuse(feats, dfeats), toks

    def attention_plain(q, k, v, *, scale, n_valid):
        return plains[vit_attention](q, k, v, scale=scale, n_valid=n_valid)

    x16 = torch.from_numpy(requests[1]).to(dev)
    with torch.inference_mode():
        got = stages(x16)
        kernel_attention = vit_attention.fused_attention
        vit_attention.fused_attention = attention_plain
        dec_mod.fused_greedy_decode = plains[decode_seq]
        try:
            ref = stages(x16)
        finally:
            vit_attention.fused_attention = kernel_attention
            dec_mod.fused_greedy_decode = decode_seq.fused_greedy_decode
    depth = got[0]
    if not bool(torch.isfinite(depth).all()):
        raise RuntimeError("depth maps are not finite")
    lo, hi = depth.min().item(), depth.max().item()
    if lo < 0.0 or hi > 1.0:
        raise RuntimeError(f"depth maps outside [0, 1]: [{lo}, {hi}]")
    repeat = float((got[3].cpu().numpy() == outputs[1]).mean())
    errs = {name: (a.float() - b.float()).abs().max().item()
            for name, a, b in zip(("depth map", "depth features",
                                   "fused features"), got[:3], ref[:3])}
    agree = float((ref[3].cpu().numpy() == outputs[1]).mean())
    log("depth", f"depth maps {tuple(depth.shape)} {depth.dtype} in "
        f"[{lo:.4f}, {hi:.4f}], std {depth.float().std().item():.4f}")
    log("depth", "kernels vs plain attention+decode on the 16-image "
        "request: max abs err " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
        + f"; token agreement {agree:.4f} (min {MIN_AGREEMENT}); the "
        f"stage-by-stage kernel run repeats the pipeline's tokens on "
        f"{repeat:.4f}")
    for c in pipe(list(requests[1][:3])):
        log("depth", f"caption: {c!r}")
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"depth-soft kernels vs plain agreement {agree}")

    # time split of one 64-image chunk
    ev = Events()
    with torch.inference_mode():
        x = to_unit_float(torch.from_numpy(requests[2]).to(dev))
        feats = ev.ms("rgb encoder", lambda: cap.encoder(
            imagenet_normalize(x)))
        depth = ev.ms("dpt", lambda: depth_fn(x))
        x_dpt = dpt_normalize(resize_bilinear(x, (est.image_size,) * 2))
        ev.ms("dpt: resnet stages", lambda: est.model.resnet(
            x_dpt.to(est.model.dtype)))
        # the ViT blocks and their attention alone, on tokens of the DPT's
        # shape: [64, 577, 768], Z = 64 * 12 heads of width 64
        blocks = [getattr(est.model, name) for name in est.model.blocks]
        dim, heads = blocks[0].qkv.in_features, blocks[0].heads
        n_tok = 1 + (est.image_size // est.model.patch) ** 2
        tokens = torch.zeros(x.shape[0], n_tok, dim, device=dev,
                             dtype=torch.bfloat16).normal_()

        def vit():
            t = tokens
            for blk in blocks:
                t = blk(t)
            return t

        ev.ms("dpt: vit blocks", vit)
        qkv = torch.zeros(3, x.shape[0] * heads, n_tok, dim // heads,
                          device=dev, dtype=torch.bfloat16).normal_()
        ev.ms("dpt: vit attention (K5)", lambda: [
            vit_attention.fused_attention(
                *qkv, scale=(dim // heads) ** -0.5, n_valid=n_tok)
            for _ in blocks])
        dfeats = ev.ms("depth encoder", lambda: cap.depth_module(depth))
        dec = cap.decoder

        def setup():
            f = dec.fuse(feats, dfeats)
            proj = project_features(dec.att_params(), f,
                                    compute_dtype=torch.float32)
            return f, proj, dec.init_state(f), dec.seq_weights()

        f, proj, state, w = ev.ms("decoder set-up", setup)
        ev.ms("greedy decode (K2)", lambda: decode_seq.fused_greedy_decode(
            f.contiguous(), proj, state.h, state.c, w, max_length=MAX_LEN,
            start_id=start_id, end_id=end_id))
    total = sum(v for k, v in ev.times.items() if ":" not in k)
    k5 = ev.times["dpt: vit attention (K5)"]
    log("depth", "64-image chunk split (device ms, each stage timed alone): "
        + ", ".join(f"{k} {v:.2f}" for k, v in ev.times.items())
        + f"; sum of stages {total:.2f}; K5 {k5:.2f} ms = "
        f"{100 * k5 / total:.1f}% of the stages, "
        f"{100 * k5 / ev.times['dpt']:.1f}% of the DPT [{smi}]")
    return launches, est


def phase_nic_kernel(smi):
    """K3 at B = 1, 16 and 64 (the main path's chunk sizes) against its
    plain version: token agreement, exact with one token forced,
    bit-identical repeats, times, the bound and the launch's plan."""
    import torch
    from depth_image_captioning_pub_torch.models.nic import NICDecoder
    from depth_image_captioning_pub_torch.ops.kernels import nic_seq
    dev = torch.device("cuda")
    dec = NICDecoder(VOCAB, dim_embedding=NIC_E, dim_hidden=H,
                     num_layers=NIC_LAYERS, device=dev)
    dec.reset_parameters(torch.Generator().manual_seed(8))
    x64 = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, NIC_E)).astype(np.float32)).to(dev)
    for line in ptxas_report("nic_greedy_kernel").values():
        log("nic_seq", f"ptxas: {line}")
    layer_macs = sum((NIC_E if li == 0 else H) * 4 * H + H * 4 * H
                     for li in range(NIC_LAYERS))
    by_shape, tok_err = {}, 0.0
    for bsz in SEQ_BATCHES:
        x0 = x64[:bsz].contiguous()
        with torch.inference_mode():
            w = dec.seq_weights()

            def run(fn, weights):
                return fn(x0, weights, max_length=MAX_LEN)

            got = run(nic_seq.fused_nic_greedy_decode, w)
            torch.cuda.synchronize()
            plan = nic_seq.LAST_PLAN      # the plan of that launch
            again = run(nic_seq.fused_nic_greedy_decode, w)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise RuntimeError(f"two NIC kernel calls differ at B={bsz}")
            want = run(nic_seq.fused_nic_greedy_decode_plain, w)
            agree = (got == want).float().mean().item()
            distinct = len({tuple(r) for r in got.tolist()})
            if agree < MIN_AGREEMENT:
                raise RuntimeError(f"NIC token agreement {agree} < "
                                   f"{MIN_AGREEMENT} at B={bsz}")
            ms = cuda_ms(lambda: run(nic_seq.fused_nic_greedy_decode, w), 10)
            plain_ms = cuda_ms(
                lambda: run(nic_seq.fused_nic_greedy_decode_plain, w), 10)
            b_out = w.b_out.clone()
            b_out[0, 7] += 100.0
            w_tok = w._replace(b_out=b_out)
            got_tok = run(nic_seq.fused_nic_greedy_decode, w_tok)
            torch.cuda.synchronize()
            want_tok = run(nic_seq.fused_nic_greedy_decode_plain, w_tok)
            err = (got_tok - want_tok).abs().max().item()
            tok_err = max(tok_err, err)
            if err != 0 or not bool((got_tok == 7).all()):
                raise RuntimeError(f"NIC kernel with one token forced "
                                   f"differs from the plain version at "
                                   f"B={bsz}")
        rows = bsz * MAX_LEN
        bound_ms, bound_by = bound(
            nbytes(x0, *w.layer_mats, w.w_out, w.b_out, got)
            + rows * NIC_E * 4, rows * 2 * (layer_macs + H * VOCAB),
            F32_FLOPS)
        by_shape[f"B={bsz}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "token_agreement": agree}
        log("nic_seq", f"B={bsz} E={NIC_E} H={H} layers={NIC_LAYERS} "
            f"V={VOCAB} L={MAX_LEN}: token agreement {agree:.4f} (min "
            f"{MIN_AGREEMENT}), {distinct} distinct rows; one-token-forced "
            f"run exact; two calls bit-identical; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); one "
            f"cooperative launch of {plan.ctas} CTAs x {nic_seq.THREADS} "
            f"threads, {plan.smem_bytes} B shared memory each "
            f"({plan.h_cols} head columns, {plan.units} hidden unit(s) per "
            f"layer, h tile {plan.h_rows} rows) [{smi}]")
    main = by_shape[f"B={B}"]
    log("nic_seq", f"source {NIC_SRC}, replaces {NIC_TPU}")
    return {"name": "nic_seq", "route": "cuda", "source": NIC_SRC,
            "replaces": NIC_TPU, "max_abs_err": tok_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "token_agreement": main["token_agreement"],
            "ms_by_shape": by_shape}


def phase_nic_path(smi):
    import torch
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import nic_seq
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    t0 = time.perf_counter()
    cap = build_captioner("nic", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(9))
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(1, 16, 64))
    log("nic", f"nic: ResNet-152 bf16 + Linear 2048->{NIC_E} + "
        f"{NIC_LAYERS}-layer LSTM, V={VOCAB}, "
        f"{sum(p.numel() for p in cap.parameters()) / 1e6:.1f}M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    images = np.random.default_rng(9).integers(
        0, 256, (117, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:117]]
    for size in (1, 16, 64):          # warm-up: one call per bucket
        pipe.caption_tokens(images[:size])
    outputs, launches = run_requests(pipe, requests, smi, "nic")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    want = dict.fromkeys(launches, 0)
    want["nic_seq"] = chunks
    if launches != want:
        raise RuntimeError(f"nic launches {launches}, expected {want} for "
                           f"{chunks} chunks")
    with torch.inference_mode():
        x = torch.from_numpy(requests[1]).to(dev)
        feats = cap.encoder_apply()(imagenet_normalize(to_unit_float(x)))
        if not bool(torch.isfinite(feats).all()):
            raise RuntimeError("NIC image embeddings are not finite")
        ref = nic_seq.fused_nic_greedy_decode_plain(
            feats.float(), cap.decoder.seq_weights(),
            max_length=MAX_LEN).cpu().numpy()
    agree = float((ref == outputs[1]).mean())
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"nic path vs plain decode agreement {agree}")
    log("nic", f"16-image request vs plain decode on the same embeddings: "
        f"token agreement {agree:.4f}; embeddings {tuple(feats.shape)} "
        f"{feats.dtype}, |x| max {feats.abs().max().item():.3e}")
    for c in pipe(list(requests[1][:2])):
        log("nic", f"caption: {c!r}")
    log("nic", f"launches {launches} for {chunks} chunks; plain calls 0")
    return launches


def beam_steps(out, end_id):
    """Steps each image's search ran: up to the one after which all its
    beams had finished (the kernel's exit), replayed from the records."""
    tok = out.tokens.cpu().numpy()
    par = out.parents.cpu().numpy().astype(np.int64)
    bsz, _, length = tok.shape
    fin = np.zeros(tok.shape[:2], bool)
    steps = np.full(bsz, length)
    done = np.zeros(bsz, bool)
    for t in range(length):
        fin = np.take_along_axis(fin, par[:, :, t], 1) | (tok[:, :, t]
                                                          == end_id)
        newly = fin.all(1) & ~done
        steps[newly] = t + 1
        done |= newly
    return steps


def phase_beam_kernel(smi):
    """K4 at B = 1, 16 and 64 images (W=5) against its plain version:
    best-token and record agreement, scores, exact with <end> forced and
    with every token tied (at B=64), times, the bound, the per-step feature
    floor and the launch's plan; and K4 at W=2..5 at B=64."""
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.models.decoder import (
        AttentionDecoder)
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    from depth_image_captioning_pub_torch.ops.kernels import beam_seq
    dev = torch.device("cuda")
    w2i, _ = placeholder_vocab(VOCAB)
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    dec = AttentionDecoder(VOCAB, A, E, D, H, device=dev)
    dec.reset_parameters(torch.Generator().manual_seed(10))
    rng = np.random.default_rng(10)
    feats64 = torch.from_numpy(np.abs(rng.standard_normal((B, K, D)))
                               .astype(np.float32)).to(dev, torch.bfloat16)
    for args, line in ptxas_report("beam_kernel", typed=True).items():
        kind, beam = args.split()
        log("beam_seq", f"ptxas, {kind} features, W={beam}: {line}")
    by_shape, exact = {}, {}
    for bsz in SEQ_BATCHES:
        feats = feats64[:bsz].contiguous()
        with torch.inference_mode():
            proj = project_features(dec.att_params(), feats,
                                    compute_dtype=torch.float32)
            state = dec.init_state(feats)
            w = dec.seq_weights()

            def run(fn, weights, beam=BEAM):
                return fn(feats, proj, state.h, state.c, weights,
                          beam_size=beam, max_length=MAX_LEN,
                          start_id=start_id, end_id=end_id)

            got = run(beam_seq.fused_beam_decode, w)
            torch.cuda.synchronize()
            plan = beam_seq.LAST_PLAN      # the plan of that launch
            want = run(beam_seq.fused_beam_decode_plain, w)
            best_got = beam_seq.select_best(got, end_id)[0]
            best_want = beam_seq.select_best(want, end_id)[0]
            agree = (best_got == best_want).float().mean().item()
            rec_agree = min(
                (got.tokens == want.tokens).float().mean().item(),
                (got.parents == want.parents).float().mean().item())
            err = (got.scores - want.scores).abs().max().item()
            if min(agree, rec_agree) < MIN_AGREEMENT:
                raise RuntimeError(f"beam best-token agreement {agree}, "
                                   f"record agreement {rec_agree} < "
                                   f"{MIN_AGREEMENT} at B={bsz}")
            if not err <= SCORE_ATOL:
                raise RuntimeError(f"beam scores max abs err {err} > "
                                   f"{SCORE_ATOL} at B={bsz}")
            ms = cuda_ms(lambda: run(beam_seq.fused_beam_decode, w), 10)
            plain_ms = cuda_ms(
                lambda: run(beam_seq.fused_beam_decode_plain, w), 3)
            if bsz == B:
                # every beam width the kernel has an instance for
                ms_by_beam = {
                    bw: cuda_ms(lambda bw=bw: run(
                        beam_seq.fused_beam_decode, w, bw), 10)
                    for bw in range(2, BEAM + 1)}
                for case in ("<end> forced", "all ties"):
                    if case == "<end> forced":
                        b_out = w.b_out.clone()
                        b_out[0, end_id] += 100.0
                        w_case = w._replace(b_out=b_out)
                    else:
                        w_case = w._replace(
                            w_out=torch.zeros_like(w.w_out),
                            b_out=torch.zeros_like(w.b_out))
                    g = run(beam_seq.fused_beam_decode, w_case)
                    torch.cuda.synchronize()
                    x = run(beam_seq.fused_beam_decode_plain, w_case)
                    if not (torch.equal(g.tokens, x.tokens)
                            and torch.equal(g.parents, x.parents)):
                        raise RuntimeError(f"beam kernel differs from the "
                                           f"plain version with {case}")
                    exact[case] = (g.scores - x.scores).abs().max().item()
                    if not exact[case] <= SCORE_ATOL:
                        raise RuntimeError(
                            f"beam scores with {case}: max abs err "
                            f"{exact[case]} > {SCORE_ATOL}")
        steps = beam_steps(got, end_id)
        beam_rows = int(steps.sum()) * BEAM
        bound_ms, bound_by = bound(
            nbytes(feats, proj, state.h, state.c, *w.step, w.w_out, w.b_out,
                   *got) + beam_rows * E * 4,
            beam_rows * (step_flops(K, D, A, E, H) + 2 * H * VOCAB),
            F32_FLOPS)
        # the kernel reads the features again every step (once for the W
        # beams of an image): that stream alone, per step and over the
        # steps run
        floor_step = nbytes(feats) / HBM_BYTES_PER_S * 1e3
        by_shape[f"B={bsz}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "token_agreement": agree,
            "record_agreement": rec_agree, "max_abs_err": err}
        log("beam_seq", f"B={bsz} W={BEAM} V={VOCAB} L={MAX_LEN} end_id="
            f"{end_id}: best-token agreement {agree:.4f}, record (token and "
            f"parent) agreement {rec_agree:.4f} (min {MIN_AGREEMENT}), "
            f"scores max abs err {err:.3e} (max {SCORE_ATOL}); steps per "
            f"image {steps.min()}-{steps.max()}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"feature floor {floor_step * 1e3:.2f} us/step x {steps.max()} "
            f"steps = {floor_step * steps.max():.4f} ms; one cooperative "
            f"launch of {plan.ctas} CTAs x {beam_seq.THREADS} threads, "
            f"{plan.smem_bytes} B shared memory each ({plan.h_cols} "
            f"h-product columns, {plan.units} hidden unit(s), h tile "
            f"{plan.h_rows} rows, {plan.rows} beam rows) [{smi}]")

    def beam_case(dec, feats, beam, label, forced=False):
        """K4 against its plain version on one decoder and feature set:
        exact records with <end> forced, else agreement; times and the
        bound."""
        bsz, k, d = feats.shape
        h, a = dec.att_w_dec.shape
        e = dec.dim_embedding
        with torch.inference_mode():
            proj = project_features(dec.att_params(), feats,
                                    compute_dtype=torch.float32)
            state = dec.init_state(feats)
            w = dec.seq_weights()
            if forced:
                b_out = w.b_out.clone()
                b_out[0, end_id] += 100.0
                w = w._replace(b_out=b_out)

            def run(fn):
                return fn(feats, proj, state.h, state.c, w, beam_size=beam,
                          max_length=MAX_LEN, start_id=start_id,
                          end_id=end_id)

            got = run(beam_seq.fused_beam_decode)
            torch.cuda.synchronize()
            plan = beam_seq.LAST_PLAN
            want = run(beam_seq.fused_beam_decode_plain)
            err = (got.scores - want.scores).abs().max().item()
            if forced:
                agree = rec_agree = float(
                    torch.equal(got.tokens, want.tokens)
                    and torch.equal(got.parents, want.parents))
                if agree != 1.0:
                    raise RuntimeError(f"beam kernel with <end> forced "
                                       f"differs from the plain version at "
                                       f"{label}")
            else:
                agree = (beam_seq.select_best(got, end_id)[0]
                         == beam_seq.select_best(want, end_id)[0]
                         ).float().mean().item()
                rec_agree = min(
                    (got.tokens == want.tokens).float().mean().item(),
                    (got.parents == want.parents).float().mean().item())
            if min(agree, rec_agree) < MIN_AGREEMENT or not err <= SCORE_ATOL:
                raise RuntimeError(f"beam kernel at {label}: best-token "
                                   f"agreement {agree}, record agreement "
                                   f"{rec_agree}, scores err {err}")
            ms = cuda_ms(lambda: run(beam_seq.fused_beam_decode), 10)
            plain_ms = cuda_ms(lambda: run(beam_seq.fused_beam_decode_plain),
                               3)
        beam_rows = int(beam_steps(got, end_id).sum()) * beam
        bound_ms, bound_by = bound(
            nbytes(feats, proj, state.h, state.c, *w.step, w.w_out, w.b_out,
                   *got) + beam_rows * e * 4,
            beam_rows * (step_flops(k, d, a, e, h) + 2 * h * VOCAB),
            F32_FLOPS)
        by_shape[label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "token_agreement": agree,
            "record_agreement": rec_agree, "max_abs_err": err}
        log("beam_seq", f"{label} W={beam} K={k} D={d} A={a} E={e} H={h} "
            f"{feats.dtype}{' <end> forced' if forced else ''}: best-token "
            f"agreement {agree:.4f}, record agreement {rec_agree:.4f}, "
            f"scores max abs err {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"{plan.ctas} CTAs, {plan.smem_bytes} B shared memory, h tile "
            f"{plan.h_rows} rows, {plan.rows} beam rows [{smi}]")
        return ms

    # the wider instances at the main shape, mdepth's f32 features at
    # D=2080 and an odd width (zero-padded for the launch), at B=64
    for bw in beam_seq.BEAM_SIZES[BEAM - 1:]:
        ms_by_beam[bw] = beam_case(dec, feats64, bw, f"B={B} W={bw}")
    dec_c = AttentionDecoder(VOCAB, A, E, D_CONCAT, H, device=dev)
    dec_c.reset_parameters(torch.Generator().manual_seed(11))
    feats_c = torch.from_numpy(np.abs(rng.standard_normal((B, K, D_CONCAT)))
                               .astype(np.float32)).to(dev)
    beam_case(dec_c, feats_c, BEAM, f"B={B} D={D_CONCAT} f32")
    del feats_c
    dec_o = AttentionDecoder(VOCAB, *ODD_AEDH, device=dev)
    dec_o.reset_parameters(torch.Generator().manual_seed(12))
    feats_o = torch.from_numpy(np.abs(rng.standard_normal((B, K, ODD_D)))
                               .astype(np.float32)).to(dev, torch.bfloat16)
    beam_case(dec_o, feats_o, BEAM, f"B={B} {ODD_LABEL}")
    beam_case(dec_o, feats_o, BEAM, f"B={B} {ODD_LABEL} <end> forced",
              forced=True)
    main = by_shape[f"B={B}"]
    log("beam_seq", f"B={B}: exact tokens and parents with "
        + ", ".join(f"{k} (scores err {v:.1e})" for k, v in exact.items())
        + "; kernel by beam width " + ", ".join(
            f"W={bw} {t:.3f} ms" for bw, t in ms_by_beam.items())
        + f" [{smi}]; source {BEAM_SRC}, replaces {BEAM_TPU}")
    return {"name": "beam_seq", "route": "cuda", "source": BEAM_SRC,
            "replaces": BEAM_TPU, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "token_agreement": main["token_agreement"],
            "record_agreement": main["record_agreement"],
            "ms_by_beam": ms_by_beam, "ms_by_shape": by_shape}


def phase_beam_path(smi, cap):
    import torch
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.models import decoder as dec_mod
    from depth_image_captioning_pub_torch.ops.kernels import beam_seq
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    w2i, i2w = placeholder_vocab(VOCAB)
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(1, 16, 64), beam_size=BEAM)
    images = np.random.default_rng(11).integers(
        0, 256, (81, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:81]]
    for size in (1, 16, 64):          # warm-up: one call per bucket
        pipe.caption_tokens(images[:size])
    outputs, launches = run_requests(pipe, requests, smi, "beam")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    want = dict.fromkeys(launches, 0)
    want["beam_seq"] = chunks
    if launches != want:
        raise RuntimeError(f"beam launches {launches}, expected {want} for "
                           f"{chunks} chunks")
    # the 16-image request again, with the search's plain version
    dec_mod.fused_beam_decode = beam_seq.fused_beam_decode_plain
    try:
        ref = pipe.caption_tokens(requests[1])
    finally:
        dec_mod.fused_beam_decode = beam_seq.fused_beam_decode
    agree = float((ref == outputs[1]).mean())
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"beam path vs plain search agreement {agree}")
    log("beam", f"16-image request vs the plain search: token agreement "
        f"{agree:.4f}")
    for c in pipe(list(requests[1][:2])):
        log("beam", f"caption: {c!r}")
    log("beam", f"launches {launches} for {chunks} chunks; plain calls 0")
    return launches


def phase_sample_path(smi, cap):
    """The base-soft captioner with nucleus sampling: requests of 1, 16
    and 64 images through the pipeline, K1's launches, the kernel loop
    against the plain step on the same noise, top_k=1 against K2, and one
    chunk's time split at each bucket."""
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.engine.evaluate import (
        make_caption_fn)
    from depth_image_captioning_pub_torch.models import decoder as dec_mod
    from depth_image_captioning_pub_torch.ops.attention import (
        project_features)
    from depth_image_captioning_pub_torch.ops.decode import (
        filtered_logits, gumbel_argmax, gumbel_noise)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import decode_step
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    start_id = w2i[SPECIAL.start]
    sampling = {"temperature": 1.0, "top_k": 0, "top_p": TOP_P}
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(1, 16, 64), sample=True, seed=0,
                           temperature=1.0, top_p=TOP_P)
    images = np.random.default_rng(12).integers(
        0, 256, (81, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:81]]
    for size in (1, 16, 64):          # warm-up: one call per bucket
        pipe.caption_tokens(images[:size])
    outputs, launches = run_requests(pipe, requests, smi, "sample")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    want = dict.fromkeys(launches, 0)
    want["decode_step"] = MAX_LEN * chunks
    if launches != want:
        raise RuntimeError(f"sampling launches {launches}, expected {want} "
                           f"for {chunks} chunks")
    distinct = len({tuple(r) for r in outputs[2].tolist()})

    # the 16-image request's features: K1's loop against the plain step's
    # on the same noise; top_k=1 against K2's greedy tokens
    dec = cap.decoder
    with torch.inference_mode():
        x = torch.from_numpy(requests[1]).to(dev)
        feats = cap.encoder(imagenet_normalize(to_unit_float(x)))
        gen = torch.Generator(device=dev).manual_seed(12)
        noise = [gumbel_noise((len(x), VOCAB), gen) for _ in range(MAX_LEN)]
        kw = dict(sampling, max_length=MAX_LEN, noise=lambda t: noise[t])
        got, alphas = dec.stochastic_sample(feats, start_id, None, **kw)
        dec_mod.fused_decode_core = decode_step.fused_decode_core_plain
        try:
            ref, ref_alphas = dec.stochastic_sample(feats, start_id, None,
                                                    **kw)
        finally:
            dec_mod.fused_decode_core = decode_step.fused_decode_core
        top1, _ = dec.stochastic_sample(feats, start_id, gen,
                                        max_length=MAX_LEN, top_k=1)
        greedy = dec.greedy_sample(feats, start_id, max_length=MAX_LEN)
    agree = (got == ref).float().mean().item()
    # alphas agree while the rows' tokens do: compare up to a row's first
    # differing token
    same = (got == ref).int().cumprod(dim=1).bool()
    alpha_err = ((alphas - ref_alphas).abs().amax(-1) * same).max().item()
    agree1 = (top1 == greedy).float().mean().item()
    if not (bool(torch.isfinite(alphas).all())
            and (alphas.sum(-1) - 1).abs().max().item() < 1e-4):
        raise RuntimeError("sampled alphas are not softmax rows")
    log("sample", f"16-image request's features: K1 loop vs plain step on "
        f"the same noise: token agreement {agree:.4f} (min "
        f"{MIN_AGREEMENT}), alphas max abs err {alpha_err:.3e} over the "
        f"steps before a row's first differing token; top_k=1 vs K2 greedy "
        f"without <end>: {agree1:.4f}; {distinct} distinct captions of 64")
    if min(agree, agree1) < MIN_AGREEMENT:
        raise RuntimeError(f"sampling agreement {agree} / top_k=1 vs "
                           f"greedy {agree1} < {MIN_AGREEMENT}")
    for c in pipe(list(requests[1][:2])):
        log("sample", f"caption: {c!r}")
    log("sample", f"launches {launches} for {chunks} chunks; plain calls 0")

    # time split of one chunk at each bucket, each stage timed alone
    program = make_caption_fn(cap, start_id, MAX_LEN, sampling=sampling,
                              generator=gen)
    with torch.inference_mode():
        for bsz in (1, 16, 64):
            ev = Events()
            x = torch.from_numpy(images[:bsz]).to(dev)
            f = ev.ms("encoder", lambda: cap.encoder(
                imagenet_normalize(to_unit_float(x))))

            def setup():
                proj = project_features(dec.att_params(), f,
                                        compute_dtype=torch.float32)
                return proj, dec.init_state(f), dec.seq_weights()

            proj, state, w = ev.ms("decoder set-up", setup)
            emb = w.embed[torch.full((bsz,), start_id, device=dev)]
            ev.ms(f"K1 x{MAX_LEN}", lambda: [decode_step.fused_decode_core(
                f, proj, emb, state.h, state.c, w.step)
                for _ in range(MAX_LEN)])

            def head():
                tok = gumbel_argmax(filtered_logits(
                    state.h @ w.w_out + w.b_out, **sampling),
                    gumbel_noise((bsz, VOCAB), gen))
                return w.embed[tok.long()]

            ev.ms(f"head + filter + draw + embedding x{MAX_LEN}",
                  lambda: [head() for _ in range(MAX_LEN)])
            ev.ms("caption program", lambda: program(x))
            log("sample", f"{bsz}-image chunk split (device ms, each stage "
                "timed alone): " + ", ".join(
                    f"{k} {v:.2f}" for k, v in ev.times.items())
                + f" [{smi}]")
    return launches


class ScoreImages:
    """An in-memory evaluation set: seeded uint8 images and five
    references each, drawn from the placeholder vocabulary's words (the
    card's machine has no Pillow to read JPEGs)."""

    def __init__(self, n, words, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
        self.refs = [[" ".join(rng.choice(words, rng.integers(5, 15)))
                      for _ in range(5)] for _ in range(n)]

    def __len__(self):
        return len(self.images)

    def load_image(self, i):
        return self.images[i]

    def captions(self, i):
        return self.refs[i]


class SetTimes:
    """Wraps the stages that ``engine/evaluate.evaluate`` calls per set to
    time them (host clock; captioning ends with the tokens on the host)
    and to check each loaded captioner against the written weights."""

    def __init__(self, ev, cap, expected):
        self.ev, self.cap, self.expected = ev, cap, expected
        self.rows, self.hypos, self.saved = [], [], {}

    def __enter__(self):
        import torch
        ev = self.ev
        for name in ("params_from_jax", "generate_captions", "score",
                     "load_textfiles"):
            self.saved[name] = getattr(ev, name)

        def loaded(cap, trainable, frozen, stats, load_encoder=True):
            t0 = time.perf_counter()
            self.saved["params_from_jax"](cap, trainable, frozen, stats,
                                          load_encoder=load_encoder)
            torch.cuda.synchronize()
            self.rows[-1]["copy"] = time.perf_counter() - t0
            want = self.expected[len(self.rows)]
            for name, t in cap.state_dict().items():
                if not torch.equal(t, want[name]):
                    raise RuntimeError(f"set {len(self.rows)}: {name} "
                                       f"differs from the written weights")

        def timed(key, fn):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.rows[-1][key] = time.perf_counter() - t0
                return out
            return run

        def texts(refs, hypos):
            self.hypos.append(list(hypos))
            return self.saved["load_textfiles"](refs, hypos)

        ev.params_from_jax = loaded
        ev.generate_captions = timed("caption", self.saved[
            "generate_captions"])
        ev.score = timed("score", self.saved["score"])
        ev.load_textfiles = texts
        return self

    def loader(self, fn):
        """The checkpoint loader, timed: each call starts a set's row."""
        def load(set_idx):
            self.rows.append({})
            t0 = time.perf_counter()
            out = fn(set_idx)
            self.rows[-1]["read"] = time.perf_counter() - t0
            return out
        return load

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ev, name, fn)


def phase_score_path(smi, cap):
    """Scored evaluation of three base-soft checkpoint sets written in the
    JAX trainer's files, then set 1 with beam search."""
    import pickle
    import tempfile
    from pathlib import Path

    import torch
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.config import ConfigEval
    from depth_image_captioning_pub_torch.engine import evaluate as ev
    from depth_image_captioning_pub_torch.models.decoder import (
        AttentionDecoder)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        save_component)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        params_to_jax)
    w2i, i2w = cli.placeholder_vocab(VOCAB)
    data = ScoreImages(SCORE_IMAGES, [w for w in w2i if w.startswith("w")],
                       seed=13)
    # set 1 is phase 5's captioner: its captions through the pipeline
    pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                           batch_buckets=(SCORE_BATCH,))
    want1 = pipe(data.images)

    trainable, frozen, _ = params_to_jax(cap)
    decoders = {1: trainable["decoder"]}
    for i in range(2, SCORE_SETS + 1):
        dec = AttentionDecoder(VOCAB, device="cpu")
        dec.reset_parameters(torch.Generator().manual_seed(100 + i))
        decoders[i] = {k: v.numpy() for k, v in dec.state_dict().items()}
    state = {k: v.clone() for k, v in cap.state_dict().items()}
    expected = {}
    for i, dec in decoders.items():
        expected[i] = dict(state)
        expected[i].update({f"decoder.{k}": torch.from_numpy(v).to(
            state[f"decoder.{k}"].device) for k, v in dec.items()})
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="score_sets_") as tmp:
        cfg = ConfigEval()
        cfg.batch_size, cfg.max_length = SCORE_BATCH, MAX_LEN
        cfg.save_directory_soft = tmp
        save_dir, files = cli.eval_tables(cfg, "soft", False, False)
        t0 = time.perf_counter()
        nbytes_written = 0
        for i, dec in decoders.items():
            for name, tree in zip(files[i], (frozen["encoder"], dec)):
                path = save_component(f"{save_dir}/{name}", tree)
                nbytes_written += Path(path).stat().st_size
        log("score", f"wrote {SCORE_SETS} checkpoint sets "
            f"({nbytes_written / 1e6:.1f} MB) in "
            f"{time.perf_counter() - t0:.2f} s")

        def loader(i):
            return cli.load_eval_components(save_dir, files[i], cap)

        pkl = f"{tmp}/coco_scores.pkl"
        torch.cuda.synchronize()
        reset_counts()
        with PlainCalls() as plain, SetTimes(ev, cap, expected) as sets:
            t0 = time.perf_counter()
            scores = ev.evaluate("base-soft", "coco", cap,
                                 sets.loader(loader), data, w2i, i2w, cfg,
                                 num_sets=SCORE_SETS, scores_pickle=pkl,
                                 quiet=True)
            total = time.perf_counter() - t0
        launches = read_counts()
        with open(pkl, "rb") as f:
            pickled = pickle.load(f)
        reset_counts()
        with PlainCalls() as beam_plain, SetTimes(ev, cap, expected) as beam:
            t0 = time.perf_counter()
            beam_scores = ev.evaluate("base-soft", "coco", cap,
                                      beam.loader(loader), data, w2i, i2w,
                                      cfg, num_sets=1, beam_size=BEAM,
                                      quiet=True)
            beam_total = time.perf_counter() - t0
        beam_launches = read_counts()

    chunks = -(-SCORE_IMAGES // SCORE_BATCH)
    want = dict.fromkeys(launches, 0)
    want["decode_seq"] = chunks * SCORE_SETS
    if launches != want:
        raise RuntimeError(f"score launches {launches}, expected {want}")
    want = dict.fromkeys(beam_launches, 0)
    want["beam_seq"] = chunks
    if beam_launches != want:
        raise RuntimeError(f"score beam launches {beam_launches}, expected "
                           f"{want}")
    if plain.calls or beam_plain.calls:
        raise RuntimeError(f"plain versions ran on the score path: "
                           f"{sorted(set(plain.calls + beam_plain.calls))}")
    if sets.hypos[0] != want1:
        bad = sum(a != b for a, b in zip(sets.hypos[0], want1))
        raise RuntimeError(f"set 1's hypotheses differ from the pipeline's "
                           f"captions on {bad} of {len(want1)} images")
    if sets.hypos[0] == sets.hypos[1]:
        raise RuntimeError("sets 1 and 2 gave the same hypotheses")
    for result, n in ((scores, SCORE_SETS), (beam_scores, 1)):
        if list(result) != list(ev.METRIC_KEYS) or not all(
                len(v) == n and np.all(np.isfinite(v))
                for v in result.values()):
            raise RuntimeError(f"bad scores {result}")
    if pickled != scores:
        raise RuntimeError("the scores pickle differs from the scores")
    for i, row in enumerate(sets.rows + beam.rows, 1):
        tag = f"set {i}" if i <= SCORE_SETS else "set 1, beam 5"
        t = row["read"] + row["copy"] + row["caption"] + row["score"]
        log("score", f"{tag}: load {row['read'] + row['copy']:.3f} s (read "
            f"{row['read']:.3f}, copy to the card {row['copy']:.3f}), "
            f"caption {row['caption']:.3f} s, host scoring "
            f"{row['score']:.3f} s; {SCORE_IMAGES / t:.1f} scored images/s "
            f"[{smi}]")
    log("score", f"{SCORE_SETS} sets of {SCORE_IMAGES} images in "
        f"{total:.2f} s: {SCORE_SETS * SCORE_IMAGES / total:.1f} scored "
        f"images/s end to end; beam 5, one set: {beam_total:.2f} s, "
        f"{SCORE_IMAGES / beam_total:.1f} images/s [{smi}]")
    log("score", "means over the sets: " + ", ".join(
        f"{k} {np.mean(v):.4g}" for k, v in scores.items())
        + f"; beam 5: CIDEr {beam_scores['CIDEr'][0]:.4g}")
    log("score", f"launches {launches} and, beam, {beam_launches} for "
        f"{chunks} chunks a set; loaded weights bit-equal to the written "
        f"ones; set 1 = the pipeline's {len(want1)} captions; plain calls 0")
    return {k: launches[k] + beam_launches[k] for k in launches}


def trained_scales(dec, feats):
    """Rescale a random hard decoder to a trained model's scales on
    ``feats``: the attention vector so that the scores spread by about 1
    over the regions, and the LSTM's context rows so that the context
    weighs as much as the embedding in the gates. A random ResNet's
    features are far from unit size, and at random scales either no
    Gumbel draw moves a region or no region moves a token. Returns the two
    factors."""
    import torch
    from depth_image_captioning_pub_torch.ops.attention import (
        attention_logits, project_features)
    e = dec.dim_embedding
    with torch.inference_mode():
        proj = project_features(dec.att_params(), feats,
                                compute_dtype=torch.float32)
        h, _ = dec.init_state(feats)
        spread = attention_logits(dec.att_params(), proj, h).std(1).mean()
        att = 1.0 / spread.item()
        dec.att_w_full.mul_(att)
        dec.att_b_full.mul_(att)
        ctx = (feats.float().std() / dec.embed.std()).item()
        dec.lstm_w_ih[e:].div_(ctx)
    return att, 1.0 / ctx


def phase_hard_path(smi):
    """base-hard: requests of 1, 16 and 64 images through the pipeline (no
    kernel: hard attention runs on PyTorch ops), the seed's repeatability,
    the card against the CPU on the same noise, one-hot alphas, a beam-5
    and a sampled request, and one chunk's time split."""
    import copy

    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.engine.evaluate import (
        make_caption_fn)
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.ops.decode import gumbel_noise
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    t0 = time.perf_counter()
    cap = build_captioner("base-hard", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(14))
    dec = cap.decoder
    images = np.random.default_rng(14).integers(
        0, 256, (81, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:81]]
    x16 = torch.from_numpy(requests[1]).to(dev)
    with torch.inference_mode():
        feats16 = cap.encoder(imagenet_normalize(to_unit_float(x16)))
    att, ctx = trained_scales(dec, feats16)
    log("hard", f"base-hard: ResNet-152 bf16 + hard-attention decoder, "
        f"V={VOCAB}, built in {time.perf_counter() - t0:.1f} s; attention "
        f"vector scaled by {att:.3e} (scores of unit spread), the LSTM's "
        f"context rows by {ctx:.3e} (context as large as the embedding); "
        f"|feat| max {feats16.abs().max().item():.3e}")

    def pipeline(**kw):
        pipe = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                               batch_buckets=(1, 16, 64), **kw)
        for size in (1, 16, 64):          # warm-up: one call per bucket
            pipe.caption_tokens(images[:size])
        return pipe

    pipe = pipeline(seed=0)
    outputs, launches = run_requests(pipe, requests, smi, "hard")
    if any(launches.values()):
        raise RuntimeError(f"base-hard launched kernels: {launches}")
    again = [pipe.caption_tokens(r) for r in requests[1:]]
    seed1 = CaptionPipeline(cap, w2i, i2w, max_length=MAX_LEN,
                            batch_buckets=(1, 16, 64), seed=1)
    other = np.concatenate([seed1.caption_tokens(r) for r in requests[1:]])
    first = np.concatenate(outputs[1:])
    if not np.array_equal(np.concatenate(again), first):
        raise RuntimeError("base-hard: the same seed gave other tokens")
    if np.array_equal(other, first):
        raise RuntimeError("base-hard: another seed gave the same tokens")

    # the card against the CPU on the 16-image request's features and noise
    gen = torch.Generator(device=dev).manual_seed(14)
    noise = [gumbel_noise((16, K), gen) for _ in range(MAX_LEN)]
    kw = dict(max_length=MAX_LEN, end_id=end_id)
    with torch.inference_mode():
        got = dec.greedy_sample(feats16, start_id, **kw,
                                att_noise=lambda t, shape: noise[t])
        ref = copy.deepcopy(dec).cpu().greedy_sample(
            feats16.cpu(), start_id, **kw,
            att_noise=lambda t, shape: noise[t].cpu())
        _, alphas = dec.stochastic_sample(feats16, start_id, gen,
                                          max_length=MAX_LEN, top_p=TOP_P)
    agree = (got.cpu() == ref).float().mean().item()
    one_hot = bool(((alphas == 0) | (alphas == 1)).all()
                   and (alphas.sum(-1) == 1).all())
    if agree < MIN_AGREEMENT or not one_hot:
        raise RuntimeError(f"base-hard card vs CPU agreement {agree}, "
                           f"one-hot alphas {one_hot}")
    log("hard", f"16- and 64-image requests: the same seed repeats their "
        f"tokens, seed 1 changes {float((other != first).mean()):.4f} of "
        f"them; 16-image request's features and noise: card vs "
        f"CPU decoder on the same features and noise: token agreement "
        f"{agree:.4f} (min {MIN_AGREEMENT}); sampled alphas exactly "
        f"one-hot")
    by_path = {"base-hard": launches}
    for name, options in (("base-hard-beam5", dict(beam_size=BEAM, seed=0)),
                          ("base-hard-sample", dict(sample=True, top_p=TOP_P,
                                                    seed=0))):
        _, got = run_requests(pipeline(**options), [requests[1]], smi, name)
        if any(got.values()):
            raise RuntimeError(f"{name} launched kernels: {got}")
        by_path[name] = got
    for c in pipe(list(requests[1][:2])):
        log("hard", f"caption: {c!r}")

    # time split of one 64-image chunk: device time of each stage alone,
    # and the host's time for the loop, which sets its pace
    program = make_caption_fn(cap, start_id, MAX_LEN, end_id=end_id,
                              generator=gen)
    ev = Events()
    with torch.inference_mode():
        x = torch.from_numpy(requests[2]).to(dev)
        f = ev.ms("encoder", lambda: cap.encoder(
            imagenet_normalize(to_unit_float(x))))
        ev.ms("decoder set-up", lambda: dec._prepare(f, None))
        loop = f"hard greedy loop x{MAX_LEN} (set-up included)"
        ev.ms(loop, lambda: dec.greedy_sample(f, start_id, generator=gen,
                                               **kw))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.greedy_sample(f, start_id, generator=gen, **kw)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev.ms("caption program", lambda: program(x))
    log("hard", "64-image chunk split (device ms, each stage timed alone): "
        + ", ".join(f"{k} {v:.2f}" for k, v in ev.times.items())
        + f"; the loop on the host clock {host_ms:.2f} ms [{smi}]")
    return by_path, cap


def phase_mdepth_path(smi, est):
    """mdepth-soft: requests of 1, 16 and 64 images through the pipeline
    (K5 in the DPT, K2 at D=2080 on f32 features), the 16-image request
    against the plain versions, a beam-5 (K4) and a sampled (K1) request,
    and one chunk's time split."""
    import torch
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.models import decoder as dec_mod
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import (
        decode_seq, vit_attention)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    blocks = len(est.model.blocks)
    t0 = time.perf_counter()
    cap = build_captioner("mdepth-soft", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(15))
    depth_fn = est.depth_fn()
    mlp = cap.depth_encoder_apply()
    log("mdepth", f"mdepth-soft: ResNet-152 bf16 + DPT-hybrid bf16 at "
        f"384x384 + DepthMLPEncoder f32 (256-128-64-32) + decoder at "
        f"D={cap.decoder.dim_enc_eff}, V={VOCAB}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    images = np.random.default_rng(15).integers(
        0, 256, (81, 224, 224, 3), dtype=np.uint8)
    requests = [images[:1], images[1:17], images[17:81]]

    def pipeline(**kw):
        pipe = CaptionPipeline(cap, w2i, i2w, depth_fn=depth_fn,
                               max_length=MAX_LEN, batch_buckets=(1, 16, 64),
                               **kw)
        for size in (1, 16, 64):          # warm-up: one call per bucket
            pipe.caption_tokens(images[:size])
        return pipe

    def expect(launches, chunks, **per_chunk):
        want = dict.fromkeys(launches, 0)
        want.update({k: v * chunks for k, v in per_chunk.items()})
        if launches != want:
            raise RuntimeError(f"mdepth-soft launches {launches}, expected "
                               f"{want}")

    pipe = pipeline()
    outputs, launches = run_requests(pipe, requests, smi, "mdepth")
    chunks = sum(-(-len(r) // pipe.batch_size) for r in requests)
    expect(launches, chunks, decode_seq=1, vit_attention=blocks)

    # the 16-image request again, with the attention and the decode plain
    plains = {vit_attention: vit_attention.fused_attention_plain,
              decode_seq: decode_seq.fused_greedy_decode_plain}

    def stages(x):
        x = to_unit_float(x)
        feats = cap.encoder(imagenet_normalize(x))
        dfeats = mlp(depth_fn(x))
        fused = cap.decoder.fuse(feats, dfeats)
        toks = cap.decoder.greedy_sample(feats, start_id, dfeats,
                                         max_length=MAX_LEN, end_id=end_id)
        return fused, toks

    def attention_plain(q, k, v, *, scale, n_valid):
        return plains[vit_attention](q, k, v, scale=scale, n_valid=n_valid)

    x16 = torch.from_numpy(requests[1]).to(dev)
    with torch.inference_mode():
        fused, _ = stages(x16)
        kernel_attention = vit_attention.fused_attention
        vit_attention.fused_attention = attention_plain
        dec_mod.fused_greedy_decode = plains[decode_seq]
        try:
            ref_fused, ref = stages(x16)
        finally:
            vit_attention.fused_attention = kernel_attention
            dec_mod.fused_greedy_decode = decode_seq.fused_greedy_decode
    if fused.dtype != torch.float32 or fused.shape != (16, K, D_CONCAT):
        raise RuntimeError(f"mdepth features {fused.dtype} "
                           f"{tuple(fused.shape)}")
    agree = float((ref.cpu().numpy() == outputs[1]).mean())
    err = (fused - ref_fused).abs().max().item()
    log("mdepth", f"16-image request vs plain attention+decode: token "
        f"agreement {agree:.4f} (min {MIN_AGREEMENT}), fused features "
        f"{tuple(fused.shape)} {fused.dtype} max abs err {err:.3e}")
    if agree < MIN_AGREEMENT:
        raise RuntimeError(f"mdepth-soft kernels vs plain agreement {agree}")
    by_path = {"mdepth-soft": launches}
    for name, kw, per_chunk in (
            ("mdepth-soft-beam5", dict(beam_size=BEAM), {"beam_seq": 1}),
            ("mdepth-soft-sample", dict(sample=True, top_p=TOP_P, seed=0),
             {"decode_step": MAX_LEN})):
        _, got = run_requests(pipeline(**kw), [requests[1]], smi, name)
        expect(got, 1, vit_attention=blocks, **per_chunk)
        by_path[name] = got
    for c in pipe(list(requests[1][:2])):
        log("mdepth", f"caption: {c!r}")

    # time split of one 64-image chunk
    ev = Events()
    dec = cap.decoder
    with torch.inference_mode():
        x = to_unit_float(torch.from_numpy(requests[2]).to(dev))
        feats = ev.ms("rgb encoder", lambda: cap.encoder(
            imagenet_normalize(x)))
        depth = ev.ms("dpt", lambda: depth_fn(x))
        dfeats = ev.ms("mlp encoder (patches + MLP)", lambda: mlp(depth))

        def setup():
            f, proj, h, c = dec._prepare(feats, dfeats)
            return f.contiguous(), proj, h, c, dec.seq_weights()

        f, proj, h, c, w = ev.ms("decoder set-up (concat, projection, "
                                 "h0/c0, packing)", setup)
        ev.ms("greedy decode (K2)", lambda: decode_seq.fused_greedy_decode(
            f, proj, h, c, w, max_length=MAX_LEN, start_id=start_id,
            end_id=end_id))
    total = sum(ev.times.values())
    log("mdepth", "64-image chunk split (device ms, each stage timed "
        "alone): " + ", ".join(f"{k} {v:.2f}" for k, v in ev.times.items())
        + f"; sum {total:.2f} [{smi}]")
    return by_path, cap


def phase_other_kinds(smi, est):
    """depth-hard and mdepth-hard at full width: one 16-image request
    each, greedy and beam 5; K5 runs in the DPT, no decode kernel."""
    import torch
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    blocks = len(est.model.blocks)
    images = np.random.default_rng(16).integers(
        0, 256, (16, 224, 224, 3), dtype=np.uint8)
    by_path = {}
    for seed, kind in enumerate(("depth-hard", "mdepth-hard"), 16):
        cap = build_captioner(kind, VOCAB, device=dev)
        cap.init(torch.Generator().manual_seed(seed))
        for beam in (1, BEAM):
            name = kind + (f"-beam{beam}" if beam > 1 else "")
            pipe = CaptionPipeline(cap, w2i, i2w, depth_fn=est.depth_fn(),
                                   max_length=MAX_LEN, batch_buckets=(16,),
                                   beam_size=beam, seed=0)
            pipe.caption_tokens(images)               # warm-up
            _, launches = run_requests(pipe, [images], smi, name)
            want = dict.fromkeys(launches, 0)
            want["vit_attention"] = blocks
            if launches != want:
                raise RuntimeError(f"{name} launches {launches}, expected "
                                   f"{want}")
            by_path[name] = launches
        log(kind, f"caption: {pipe(images[0])!r}")
        del cap, pipe
        torch.cuda.empty_cache()
    return by_path


def phase_score_new_kinds(smi, hard_cap, mdepth_cap, est):
    """One base-hard set (scored twice: the same hypotheses) and one
    mdepth-soft set, each written with ``params_to_jax`` and
    ``save_component`` in the JAX trainer's files, scored by ``evaluate``
    through ``load_eval_components`` on phase 13's 256 images."""
    import tempfile
    from pathlib import Path

    import torch
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.config import ConfigEval
    from depth_image_captioning_pub_torch.engine import evaluate as ev
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        save_component)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        params_to_jax)
    w2i, i2w = cli.placeholder_vocab(VOCAB)
    data = ScoreImages(SCORE_IMAGES, [w for w in w2i if w.startswith("w")],
                       seed=13)
    chunks = -(-SCORE_IMAGES // SCORE_BATCH)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    by_path = {}
    for kind, cap, dfn, runs in (("base-hard", hard_cap, None, 2),
                                 ("mdepth-soft", mdepth_cap, est.depth_fn(),
                                  1)):
        base, atten = kind.split("-")
        mlp = base == "mdepth"
        trainable, frozen, stats = params_to_jax(cap)
        expected = {1: {k: v.clone() for k, v in cap.state_dict().items()}}
        with tempfile.TemporaryDirectory(dir=build,
                                         prefix=f"score_{kind}_") as tmp:
            cfg = ConfigEval()
            cfg.batch_size, cfg.max_length = SCORE_BATCH, MAX_LEN
            cfg.save_directory_hard = cfg.save_directory_Cdep_soft = tmp
            save_dir, files = cli.eval_tables(cfg, atten, False, mlp,
                                              "mlp" if mlp else "cnn")
            trees = [frozen["encoder"], trainable["decoder"]]
            if mlp:
                trees.append({"params": trainable["depth_encoder"],
                              "batch_stats": stats})
            for name, tree in zip(files[1], trees):
                save_component(f"{save_dir}/{name}", tree)
            hypos, total = [], {}
            for _ in range(runs):
                torch.cuda.synchronize()
                reset_counts()
                with PlainCalls() as plain, SetTimes(ev, cap,
                                                     expected) as sets:
                    scores = ev.evaluate(
                        kind, "coco", cap, sets.loader(
                            lambda i: cli.load_eval_components(
                                save_dir, files[i], cap)),
                        data, w2i, i2w, cfg, depth_fn=dfn, num_sets=1,
                        quiet=True)
                launches = read_counts()
                if plain.calls:
                    raise RuntimeError(f"plain versions ran on the {kind} "
                                       f"score path: {set(plain.calls)}")
                total = {k: total.get(k, 0) + v for k, v in launches.items()}
                hypos.append(sets.hypos[0])
                row = sets.rows[0]
                if list(scores) != list(ev.METRIC_KEYS) or not all(
                        np.all(np.isfinite(v)) for v in scores.values()):
                    raise RuntimeError(f"bad {kind} scores {scores}")
                load = row["read"] + row["copy"]
                log("score", f"{kind} set: load {load:.3f} s (read "
                    f"{row['read']:.3f}, copy to the card {row['copy']:.3f}), "
                    f"caption {row['caption']:.3f} s, host scoring "
                    f"{row['score']:.3f} s; CIDEr "
                    f"{scores['CIDEr'][0]:.4g} [{smi}]")
        want = dict.fromkeys(total, 0)
        if mlp:
            want.update(decode_seq=chunks,
                        vit_attention=chunks * len(est.model.blocks))
        if total != want:
            raise RuntimeError(f"{kind} score launches {total}, expected "
                               f"{want}")
        if runs > 1 and hypos[0] != hypos[1]:
            raise RuntimeError(f"{kind}: scoring the set twice gave other "
                               f"hypotheses")
        by_path[f"score-{kind}"] = total
        log("score", f"{kind}: launches {total} for {chunks} chunks a set; "
            f"loaded weights bit-equal to the written ones"
            + ("; the two runs' hypotheses identical" if runs > 1 else ""))
    return by_path


SERVE_BUCKETS = (1, 2, 4, 8, 16)   # the JAX bench's serving buckets
SERVE_SEQUENTIAL, SERVE_CLIENTS, SERVE_PER_CLIENT = 50, 16, 10
SERVE_DISTINCT = 64                # distinct request bodies, reused
SERVE_HW = (480, 640)              # the request images (a camera's size)
SAMPLE_REQUESTS = 16
DPT224_IMAGES = 16                 # one chunk: K5 at Z = 16 * 12, N = 197
DPT_BLOCKS = 12                    # the DPT-hybrid's ViT blocks


def png_bytes(arr):
    """Encode [H, W, 3] uint8 as a PNG with zlib, row y filtered with
    filter type y % 5 (every scanline filter is exercised)."""
    import struct
    import zlib
    h, w, _ = arr.shape
    x = arr.reshape(h, w * 3).astype(np.int16)
    up = np.vstack([np.zeros((1, w * 3), np.int16), x[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int16), x[:, :-3]])
    upleft = np.hstack([np.zeros((h, 3), np.int16), up[:, :-3]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    kind = np.arange(h) % 5
    rows = ((x - preds[kind, np.arange(h)]) % 256).astype(np.uint8)
    raw = np.hstack([kind.astype(np.uint8)[:, None], rows]).tobytes()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def photo_like(rng, n, hw):
    """n seeded [H, W, 3] uint8 images: a smooth field (a bilinear
    upsample of 12x16 noise) plus pixel noise, so a PNG compresses as a
    photograph's would, not as pure noise."""
    import torch
    import torch.nn.functional as F
    small = torch.from_numpy(rng.random((n, 3, 12, 16), np.float32) * 255)
    big = F.interpolate(small, size=hw, mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    noise = rng.normal(0.0, 6.0, big.shape)
    return np.clip(big + noise, 0, 255).astype(np.uint8)


def http_post(port, body, path="/caption", timeout=120):
    """(status, JSON reply, seconds) of one POST on its own connection."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        data = r.read()
        dt = time.perf_counter() - t0
    finally:
        conn.close()
    return r.status, json.loads(data), dt


def http_get(port, path):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def refused_and_closed(port, declared):
    """POST /caption declaring ``declared`` body bytes and sending none:
    the status line, and whether the server closed the connection (an
    open one times out)."""
    import socket
    with socket.create_connection(("127.0.0.1", port), timeout=20) as s:
        s.sendall((f"POST /caption HTTP/1.1\r\nHost: x\r\nConnection: "
                   f"keep-alive\r\nContent-Length: {declared}\r\n\r\n")
                  .encode())
        data = b""
        try:
            while True:
                part = s.recv(65536)
                if not part:
                    return data.split(b"\r\n")[0].decode(), True
                data += part
        except socket.timeout:
            return data.split(b"\r\n")[0].decode(), False


def decode_split(bodies):
    """Host ms a body of the PNG decode's parts (zlib inflate, the rest of
    ``decode_png``: chunks, CRCs, the C unfilter, the RGB conversion; then
    ``resize_u8``), and of the whole decode when 16 threads share the
    bodies (the server's handler threads and the interpreter lock)."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    from depth_image_captioning_pub_torch.data import image_io
    t = {"inflate": 0.0, "png rest": 0.0, "resize": 0.0}
    for b in bodies:
        idat = b"".join(body for tag, body in image_io._png_chunks(b)
                        if tag == b"IDAT")
        t0 = time.perf_counter()
        zlib.decompress(idat)
        t1 = time.perf_counter()
        rgb = image_io.decode_png(b)
        t2 = time.perf_counter()
        image_io.resize_u8(rgb, (224, 224))
        t3 = time.perf_counter()
        t["inflate"] += t1 - t0
        t["png rest"] += (t2 - t1) - (t1 - t0)
        t["resize"] += t3 - t2
    out = {k: v * 1e3 / len(bodies) for k, v in t.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_CLIENTS) as ex:
        list(ex.map(lambda b: image_io.decode_image_bytes(b, (224, 224)),
                    bodies))
    out[f"{SERVE_CLIENTS} threads (wall)"] = ((time.perf_counter() - t0)
                                             * 1e3 / len(bodies))
    return out


def percentiles(ms):
    q = np.percentile(np.asarray(ms), [50, 90, 99])
    return f"p50 {q[0]:.2f} / p90 {q[1]:.2f} / p99 {q[2]:.2f} ms"


class Server:
    """``serve(...)`` on 127.0.0.1:0 in a thread; stopped on exit."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __enter__(self):
        import threading
        from depth_image_captioning_pub_torch.serve import serve
        self.httpd = serve(self.pipe, host="127.0.0.1", port=0,
                           batch_window_ms=2.0)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        return self.httpd.server_address[1]

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.service.stop()
        self.thread.join(timeout=60)


def eval_cfg(root):
    """``ConfigEval`` defaults with every path under ``root``."""
    import os
    from depth_image_captioning_pub_torch.config import ConfigEval
    cwd = os.getcwd()
    os.chdir(root)
    try:
        cfg = ConfigEval()
    finally:
        os.chdir(cwd)
    cfg.max_length = MAX_LEN
    return cfg


def write_experiment(root, kind, cap, w2i):
    """``cap``'s weights as checkpoint set 1 of ``kind`` in the JAX
    trainer's files under ``root`` (the reference's working-directory
    layout, the vocabulary included); returns (ConfigEval, save_dir,
    files)."""
    import os
    import pickle
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        save_component)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        params_to_jax)
    cfg = eval_cfg(root)
    os.makedirs(os.path.dirname(cfg.word_to_id_file), exist_ok=True)
    with open(cfg.word_to_id_file, "wb") as f:
        pickle.dump(w2i, f)
    base, atten = kind.split("-")
    save_dir, files = cli.eval_tables(cfg, atten, False, base == "depth")
    trainable, frozen, stats = params_to_jax(cap)
    trees = [frozen["encoder"], trainable["decoder"]]
    if base == "depth":
        trees.append({"params": trainable["depth_encoder"],
                      "batch_stats": stats})
    for name, tree in zip(files[1], trees):
        save_component(f"{save_dir}/{name}", tree)
    return cfg, save_dir, files


def served_rows(pipe, calls, decoded, alone, w2i, i2w):
    """The server's device calls run again after it stopped (on the
    weights it served with): the encoder's features at the bucket each
    call was padded to; K2 over the bucket (``repeats``: calls whose
    tokens are the served ones bit for bit); K2 over each row alone at
    those features (``dependent_rows``: rows whose tokens differ, which
    would mean a row depends on the others in the batch); K2's plain
    version over each bucket (``plain_agreement``, over all calls). For
    each served row whose caption differs from its image's caption alone
    (``parted``): the largest difference between its features at the
    served bucket and at bucket 1, the first token where the two captions
    part, and there the logit margin between the two tokens in plain f32
    steps on each set of features."""
    import torch
    from depth_image_captioning_pub_torch.cli import SPECIAL
    from depth_image_captioning_pub_torch.data.tokenizer import (
        ids_to_caption)
    from depth_image_captioning_pub_torch.ops.image_ops import (
        imagenet_normalize, to_unit_float)
    from depth_image_captioning_pub_torch.ops.kernels import decode_seq
    from depth_image_captioning_pub_torch.ops.kernels.decode_step import (
        attention_lstm_step, plain_step_params)
    from depth_image_captioning_pub_torch.ops.precision import full_f32
    start_id, end_id = w2i[SPECIAL.start], w2i[SPECIAL.end]
    dec, enc = pipe.cap.decoder, pipe.cap.encoder_apply()

    def features(arrays):
        bucket = next(b for b in pipe.batch_buckets if b >= len(arrays))
        pad = np.concatenate([arrays, arrays[np.zeros(
            bucket - len(arrays), np.int64)]])
        with torch.inference_mode():
            return enc(imagenet_normalize(to_unit_float(
                torch.from_numpy(pad).to(pipe.device))))

    def greedy(f):
        return dec.greedy_sample(f.contiguous(), start_id,
                                 max_length=MAX_LEN,
                                 end_id=end_id).cpu().numpy()

    @torch.inference_mode()
    @full_f32()
    def logits_at(f, row, step):
        """The logits of ``step`` with the tokens of ``row`` before it."""
        feats, proj, h, c = dec._prepare(f, None)
        w = dec.seq_weights()
        p = plain_step_params(w.step)
        emb = w.embed[start_id][None]
        for t in range(step + 1):
            h, c, _ = attention_lstm_step(feats, proj, emb, h, c, p)
            emb = w.embed[int(row[t])][None]
        return (h @ w.w_out + w.b_out)[0]

    @torch.inference_mode()
    @full_f32()
    def plain(f):
        feats, proj, h, c = dec._prepare(f, None)
        return decode_seq.fused_greedy_decode_plain(
            feats, proj, h, c, dec.seq_weights(), max_length=MAX_LEN,
            start_id=start_id, end_id=end_id).cpu().numpy()

    out = {"repeats": 0, "dependent_rows": 0, "parted": [],
           "buckets": sorted({next(b for b in pipe.batch_buckets
                                   if b >= len(a)) for a, _ in calls})}
    agree, total, seen = 0, 0, set()
    for arrays, toks in calls:
        f = features(arrays)
        v = len(arrays)
        out["repeats"] += np.array_equal(greedy(f)[:v], toks)
        want = plain(f)[:v]
        agree += int((want == toks).sum())
        total += want.size
        for r in range(v):
            out["dependent_rows"] += not np.array_equal(
                greedy(f[r:r + 1])[0], toks[r])
            j = next(k for k in range(len(decoded))
                     if np.array_equal(decoded[k], arrays[r]))
            if (ids_to_caption(toks[r], i2w) == alone[j]
                    or (j, f.shape[0]) in seen):
                continue
            seen.add((j, f.shape[0]))
            f1 = features(arrays[r:r + 1])
            solo = greedy(f1)[0]
            step = int(np.argmax(solo != toks[r]))
            a, b = int(toks[r][step]), int(solo[step])
            lg_s = logits_at(f[r:r + 1], toks[r], step)
            lg_1 = logits_at(f1, solo, step)
            top = torch.topk(lg_s, 2).values
            out["parted"].append({
                "image": j, "bucket": f.shape[0], "step": step,
                "feature_diff": (f[r].float() - f1[0].float()).abs()
                .max().item(),
                "feature_max": f1.float().abs().max().item(),
                "margin_served": (lg_s[a] - lg_s[b]).item(),
                "margin_alone": (lg_1[b] - lg_1[a]).item(),
                "top2_gap": (top[0] - top[1]).item(),
                "logit_std": lg_s.std().item()})
    out["plain_agreement"] = agree / max(total, 1)
    return out


def phase_serve(smi, base_cap):
    """The HTTP caption server over phase 5's base-soft weights, read back
    from checkpoint files by ``CaptionPipeline.from_experiment``: the JAX
    bench's traffic (sequential, then concurrent clients) of 480x640 PNG
    bodies, replies against the pipeline's direct captions, /metrics,
    /healthz, a refused oversized POST, /reload; then ``--sample``."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import torch
    from depth_image_captioning_pub_torch import serve as serve_mod
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.data.image_io import (
        decode_image_bytes)
    from depth_image_captioning_pub_torch.data.tokenizer import (
        ids_to_caption)
    from depth_image_captioning_pub_torch.models.decoder import (
        AttentionDecoder)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        params_to_jax)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        save_component)
    w2i, i2w = placeholder_vocab(VOCAB)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    pixels = photo_like(rng, SERVE_DISTINCT, SERVE_HW)
    bodies = [png_bytes(a) for a in pixels]
    log("serve", f"{SERVE_DISTINCT} request bodies: {SERVE_HW[0]}x"
        f"{SERVE_HW[1]} PNGs from seed {SEED}, "
        f"{np.mean([len(b) for b in bodies]) / 1e3:.0f} kB each, encoded "
        f"in {time.perf_counter() - t0:.1f} s")
    from depth_image_captioning_pub_torch.data import native_loader
    if not native_loader.available():     # built here at first use
        raise RuntimeError("the native image library did not build")
    log("serve", f"native image library {native_loader.library_path()}: "
        f"built; JPEG part {'yes' if native_loader.has_jpeg() else 'no'}")
    t0 = time.perf_counter()
    decoded = np.stack([decode_image_bytes(b, (224, 224)) for b in bodies])
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(bodies)
    try:
        import io

        from PIL import Image
        pil = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB").resize(
            (224, 224), Image.BILINEAR)) for b in bodies[:8]]
        same = all(np.array_equal(a, b) for a, b in zip(pil, decoded[:8]))
        if not same:
            raise RuntimeError("decode_image_bytes differs from Pillow's "
                               "decode and resize on the card's machine")
        pil_note = "equal to Pillow's decode + resize on 8 bodies"
    except ImportError:
        pil_note = "Pillow not importable: not cross-checked"
    log("serve", f"host decode (PNG inflate + unfilter + Pillow-exact "
        f"resize to 224x224): {decode_ms:.2f} ms a body; {pil_note}")
    log("serve", "host decode split, ms a body: " + ", ".join(
        f"{k} {v:.2f}" for k, v in decode_split(bodies).items()))

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    launches_by_path = {}
    with tempfile.TemporaryDirectory(dir=build, prefix="serve_") as root:
        cfg, save_dir, files = write_experiment(root, "base-soft", base_cap,
                                                w2i)
        cfg.max_length = MAX_LEN
        t0 = time.perf_counter()
        pipe = CaptionPipeline.from_experiment(
            "base-soft", cfg=cfg, device="cuda", batch_buckets=SERVE_BUCKETS)
        log("serve", f"from_experiment (ResNet-152 bf16 + decoder, "
            f"V={VOCAB}, buckets {SERVE_BUCKETS}) in "
            f"{time.perf_counter() - t0:.1f} s")
        for bsz in SERVE_BUCKETS:                  # warm-up
            pipe.caption_tokens(decoded[:bsz])
        # the direct captions, before the server starts: each image alone
        # (the sequential requests' batches)
        alone = [pipe(decoded[i]) for i in range(len(decoded))]
        # the worker's device calls, recorded (arrays and tokens) to be
        # repeated once the server has stopped
        calls, direct_tokens = [], pipe.caption_tokens

        def recorded(arrays):
            toks = direct_tokens(arrays)
            calls.append((arrays.copy(), toks.copy()))
            return toks

        pipe.caption_tokens = recorded
        torch.cuda.synchronize()
        reset_counts()
        with PlainCalls() as plain, Server(pipe) as port:
            seq = [http_post(port, bodies[i % SERVE_DISTINCT])
                   for i in range(SERVE_SEQUENTIAL)]
            _, m_seq = http_get(port, "/metrics")

            def client(c):
                return [http_post(port, bodies[(c * SERVE_PER_CLIENT + i)
                                               % SERVE_DISTINCT])
                        for i in range(SERVE_PER_CLIENT)]

            t0 = time.perf_counter()
            with ThreadPoolExecutor(SERVE_CLIENTS) as ex:
                conc = list(ex.map(client, range(SERVE_CLIENTS)))
            conc_s = time.perf_counter() - t0
            _, m_all = http_get(port, "/metrics")
            _, health = http_get(port, "/healthz")
            status, closed = refused_and_closed(
                port, serve_mod.MAX_REQUEST_BYTES + 1)

            pipe.caption_tokens = direct_tokens
            # /reload after set 1's decoder file is rewritten
            dec = AttentionDecoder(VOCAB, device="cpu")
            dec.reset_parameters(torch.Generator().manual_seed(200))
            save_component(f"{save_dir}/{files[1][1]}",
                           {k: v.numpy() for k, v in
                            dec.state_dict().items()})
            reload_status, reload_reply, reload_s = http_post(port, b"",
                                                              "/reload")
            after = [http_post(port, bodies[i]) for i in range(8)]
        launches = read_counts()
        svc_hist = m_all["batch_size_hist"]
        served, batches = m_all["images_served"], m_all["batches_run"]
        # a fresh pipeline over the rewritten files, after the server
        fresh = CaptionPipeline.from_experiment(
            "base-soft", cfg=cfg, device="cuda", batch_buckets=(1,))
        want_after = [fresh(decoded[i]) for i in range(8)]
        del fresh
        # each device call of the traffic again on set 1's weights
        trainable, frozen, _ = params_to_jax(base_cap)
        pipe.reload_weights(trainable, frozen["encoder"])
        rerun = served_rows(pipe, calls, decoded, alone, w2i, i2w)

    # checks
    replies = seq + [r for c in conc for r in c] + after
    bad = [r for r in replies if r[0] != 200]
    if bad or reload_status != 200:
        raise RuntimeError(f"serve: {len(bad)} replies not 200 (first "
                           f"{bad[:1]}), /reload {reload_status} "
                           f"{reload_reply}")
    seq_caps = [r[1]["caption"] for r in seq]
    if seq_caps != [alone[i % SERVE_DISTINCT]
                    for i in range(SERVE_SEQUENTIAL)]:
        raise RuntimeError("serve: a sequential reply differs from the "
                           "pipeline's direct caption of its image")
    if rerun["repeats"] != len(calls):
        raise RuntimeError(f"serve: {len(calls) - rerun['repeats']} of "
                           f"{len(calls)} device calls gave other tokens "
                           f"when repeated")
    if rerun["dependent_rows"]:
        raise RuntimeError(f"serve: {rerun['dependent_rows']} rows gave "
                           f"other tokens decoded alone at their call's "
                           f"features than in the call's bucket")
    if rerun["plain_agreement"] < MIN_AGREEMENT:
        raise RuntimeError(f"serve: K2's token agreement with its plain "
                           f"version at the served buckets "
                           f"{rerun['plain_agreement']:.4f} < "
                           f"{MIN_AGREEMENT}")
    # a concurrent reply is a row's caption in a device call that held its
    # image; the rows are the requests, one each
    served_caps = {}
    for arrays, toks in calls:
        for a, row in zip(arrays, toks):
            j = next(k for k in range(SERVE_DISTINCT)
                     if np.array_equal(decoded[k], a))
            served_caps.setdefault(j, []).append(ids_to_caption(row, i2w))
    wrong, near_ties = 0, 0
    for c, rows in enumerate(conc):
        for i, r in enumerate(rows):
            j = (c * SERVE_PER_CLIENT + i) % SERVE_DISTINCT
            wrong += r[1]["caption"] not in served_caps.get(j, [])
            near_ties += r[1]["caption"] != alone[j]
    rows_run = sum(len(a) for a, _ in calls)
    if wrong or rows_run != SERVE_SEQUENTIAL + SERVE_CLIENTS * \
            SERVE_PER_CLIENT:
        raise RuntimeError(f"serve: {wrong} concurrent replies are not the "
                           f"pipeline's captions of their batches; "
                           f"{rows_run} rows in {len(calls)} device calls")
    if [r[1]["caption"] for r in after] != want_after:
        raise RuntimeError("serve: captions after /reload differ from a "
                           "fresh pipeline's over the rewritten files")
    if want_after == alone[:8]:
        raise RuntimeError("serve: the rewritten decoder left the captions "
                           "unchanged")
    total = SERVE_SEQUENTIAL + SERVE_CLIENTS * SERVE_PER_CLIENT + 8
    if health["images_served"] != total - 8 or served != total - 8:
        raise RuntimeError(f"serve: /healthz counts {health} and /metrics "
                           f"{served}, expected {total - 8}")
    if not any(int(k) > 1 for k in svc_hist):
        raise RuntimeError(f"serve: no batch above 1 under concurrency: "
                           f"{svc_hist}")
    if not (status.startswith("HTTP/1.1 413") and closed):
        raise RuntimeError(f"serve: oversized POST got {status!r}, "
                           f"connection closed {closed}")
    if plain.calls:
        raise RuntimeError(f"plain versions ran on the serve path: "
                           f"{sorted(set(plain.calls))}")
    want = dict.fromkeys(launches, 0)
    want["decode_seq"] = batches + len(after)
    if launches != want:
        raise RuntimeError(f"serve launches {launches}, expected {want}")
    launches_by_path["serve"] = launches

    seq_ms = [r[2] * 1e3 for r in seq]
    conc_ms = [r[2] * 1e3 for c in conc for r in c]
    n_conc = SERVE_CLIENTS * SERVE_PER_CLIENT
    conc_batches = batches - m_seq["batches_run"]
    log("serve", f"{SERVE_SEQUENTIAL} sequential requests: "
        f"{percentiles(seq_ms)}"
        f", {SERVE_SEQUENTIAL / (sum(seq_ms) / 1e3):.1f} captions/s; the "
        f"host decode {decode_ms:.2f} ms = "
        f"{100 * decode_ms / np.median(seq_ms):.1f}% of the median request "
        f"[{smi}]")
    log("serve", f"{SERVE_CLIENTS} concurrent clients x {SERVE_PER_CLIENT}: "
        f"{percentiles(conc_ms)}, {n_conc / conc_s:.1f} captions/s, "
        f"effective batch {n_conc / conc_batches:.2f} ({conc_batches} "
        f"device calls) [{smi}]")
    log("serve", f"server: batch histogram {svc_hist}; request latency "
        f"{m_all['request_latency']}; device calls {m_all['device_batch']}")
    log("serve", f"all {len(replies)} replies 200; the sequential ones "
        f"equal the pipeline's direct captions alone, the concurrent ones "
        f"the pipeline's captions of the batches the worker formed (its "
        f"{len(calls)} device calls repeated after the server: "
        f"bit-identical tokens; each of their {rows_run} rows decoded alone "
        f"at its call's features by K2: the same tokens; K2's plain version "
        f"over the served buckets {rerun['buckets']}: token agreement "
        f"{rerun['plain_agreement']:.4f}); /healthz "
        f"{health['images_served']} images; oversized POST: {status!r}, "
        f"connection closed; /reload in {reload_s * 1e3:.0f} ms: 8 "
        f"captions equal a fresh pipeline's over the rewritten files")
    log("serve", f"{near_ties} of {n_conc} concurrent replies differ from "
        f"their image's caption alone; {len(rerun['parted'])} distinct "
        f"(image, bucket) rows: " + ("; ".join(
            f"image {d['image']} at bucket {d['bucket']}: features differ "
            f"by at most {d['feature_diff']:.4g} from bucket 1's "
            f"(largest feature {d['feature_max']:.4g}), the captions part "
            f"at token {d['step']}, where the served token leads by "
            f"{d['margin_served']:.4g} in the served features' logits "
            f"(top-2 gap {d['top2_gap']:.4g}) and trails by "
            f"{d['margin_alone']:.4g} in bucket 1's (plain f32 steps; the "
            f"logits' standard deviation there {d['logit_std']:.4g})"
            for d in rerun["parted"]) or "none"))
    log("serve", f"launches {launches} for {batches} device calls; plain "
        f"calls 0")
    launches_by_path["serve-sample"] = phase_serve_sample(
        smi, pipe, bodies[:SAMPLE_REQUESTS], w2i, i2w)
    del pipe
    torch.cuda.empty_cache()
    return launches_by_path


def phase_serve_sample(smi, pipe, bodies, w2i, i2w):
    """Two servers over the same captioner with ``sample=True, top_p=0.9``
    and one seed answer the same captions to the same sequential
    requests; K1 launches 30 a device call."""
    import torch
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    runs, calls = [], 0
    torch.cuda.synchronize()
    reset_counts()
    with PlainCalls() as plain:
        for _ in range(2):
            spipe = CaptionPipeline(pipe.cap, w2i, i2w, max_length=MAX_LEN,
                                    batch_buckets=SERVE_BUCKETS, sample=True,
                                    top_p=TOP_P, seed=SEED)
            with Server(spipe) as port:
                replies = [http_post(port, b) for b in bodies]
                _, m = http_get(port, "/metrics")
            calls += m["batches_run"]
            if any(r[0] != 200 for r in replies):
                raise RuntimeError("serve-sample: a reply is not 200")
            runs.append(replies)
    launches = read_counts()
    caps = [[r[1]["caption"] for r in run] for run in runs]
    if caps[0] != caps[1]:
        raise RuntimeError("serve-sample: two servers with one seed "
                           "answered other captions")
    want = dict.fromkeys(launches, 0)
    want["decode_step"] = MAX_LEN * calls
    if launches != want or plain.calls:
        raise RuntimeError(f"serve-sample launches {launches}, expected "
                           f"{want}; plain calls {plain.calls}")
    ms = [r[2] * 1e3 for run in runs for r in run]
    log("serve-sample", f"{len(bodies)} sequential requests x 2 servers "
        f"(top_p {TOP_P}, seed {SEED}): the same captions, "
        f"{len(set(caps[0]))} distinct; {percentiles(ms)} [{smi}]")
    log("serve-sample", f"launches {launches} for {calls} device calls; "
        f"plain calls 0")
    return launches


def phase_caption_depth224(smi, vit):
    """``caption.main`` over a directory of 480x640 PNG files at
    ``--kind depth-soft --beam 3 --dpt-size 224 --gelu tanh --dpt-head
    lowres``: its output equals the pipeline's direct captions of the same
    paths; K5 at Z = 16 * 12, N = 197 against its plain version."""
    import os
    import tempfile
    from pathlib import Path

    import torch
    from depth_image_captioning_pub_torch import caption as caption_cli
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    dev = torch.device("cuda")
    z, n, d = DPT224_IMAGES * 12, 197, 64
    rng = np.random.default_rng(SEED + 1)
    qkv = [torch.from_numpy(rng.standard_normal((z, n, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3)]
    err, mean, tol, k_ms, p_ms = attention_case(*qkv, n)
    bound_ms, bound_by = bound(4 * z * n * d * 2, 4 * z * n * n * d,
                               BF16_FLOPS)
    vit["max_abs_err"] = max(vit["max_abs_err"], err)
    vit["ms_by_shape"][f"Z={z} N={n} d={d}"] = {
        "ms": k_ms, "plain_ms": p_ms, "max_abs_err": err,
        "bound_ms": bound_ms, "bound_by": bound_by}
    log("vit_attention", f"Z={z} N={n} d={d} bf16 (the DPT at 224x224): max "
        f"abs err {err:.3e}, mean {mean:.3e} (tol {tol:.3e}); kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}) [{smi}]")

    w2i, _ = placeholder_vocab(VOCAB)
    cap = build_captioner("depth-soft", VOCAB, device=dev)
    cap.init(torch.Generator().manual_seed(21))
    pixels = photo_like(rng, DPT224_IMAGES, SERVE_HW)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    argv = ["--kind", "depth-soft", "--beam", "3", "--dpt-size", "224",
            "--gelu", "tanh", "--dpt-head", "lowres", "--json"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=build, prefix="caption_") as root:
        cfg, _, _ = write_experiment(root, "depth-soft", cap, w2i)
        del cap
        pngs = Path(root) / "images"
        pngs.mkdir()
        for i, a in enumerate(pixels):
            (pngs / f"img{i:02d}.png").write_bytes(png_bytes(a))
        out = Path(root) / "captions.json"
        os.chdir(root)
        try:
            torch.cuda.synchronize()
            reset_counts()
            with PlainCalls() as plain:
                t0 = time.perf_counter()
                rc = caption_cli.main([str(pngs), "--output", str(out)]
                                      + argv)
                torch.cuda.synchronize()
                cli_s = time.perf_counter() - t0
            launches = read_counts()
            rows = json.loads(out.read_text())
            cfg.dpt_image_size, cfg.dpt_gelu, cfg.dpt_head = (224, "tanh",
                                                             "lowres")
            pipe = CaptionPipeline.from_experiment(
                "depth-soft", cfg=cfg, device="cuda", beam_size=3,
                batch_size=16)
            paths = [r["path"] for r in rows]
            direct = pipe(paths)
        finally:
            os.chdir(cwd)
    if rc != 0 or len(rows) != DPT224_IMAGES:
        raise RuntimeError(f"caption.main exit {rc}, {len(rows)} rows")
    if [r["caption"] for r in rows] != direct:
        raise RuntimeError("caption.main's captions differ from the "
                           "pipeline's direct captions of the same paths")
    if plain.calls:
        raise RuntimeError(f"plain versions ran on the caption path: "
                           f"{sorted(set(plain.calls))}")
    want = dict.fromkeys(launches, 0)
    want.update(beam_seq=1, vit_attention=DPT_BLOCKS)
    if launches != want:
        raise RuntimeError(f"caption-depth224-beam3 launches {launches}, "
                           f"expected {want}")
    log("caption", f"caption.main {' '.join(argv)} over {DPT224_IMAGES} "
        f"480x640 PNGs: exit 0 in {cli_s:.1f} s (the experiment's load and "
        f"the random DPT's build included), captions equal to "
        f"CaptionPipeline's on the same paths; {len(set(direct))} distinct "
        f"[{smi}]")
    log("caption", f"caption: {direct[0]!r}; no JPEG files: the card's "
        f"machine has no jpeglib.h")
    log("caption", f"launches {launches}; plain calls 0")
    del pipe
    torch.cuda.empty_cache()
    return {"caption-depth224-beam3": launches}


TRAIN_IMAGES, TRAIN_VAL, TRAIN_EPOCHS = 90, 30, 2
SHORT_IMAGES = 60          # the other train paths: one epoch of 2 steps
OVERFIT_STEPS, OVERFIT_LR = 50, 1e-2
CACHE_BATCH = 32           # DepthMapCache.build's batch (the JAX default)
CARD_CPU_LOSS_RTOL, CARD_CPU_STATS_ATOL = 1e-4, 1e-4
CARD_CPU_GRAD = 1e-3       # of each gradient's own max |g|
CARD_CPU_ATT_GRAD = 1e-2   # the attention's, through the softmax Jacobian
CARD_CPU_DEPTH_GRAD = 5e-2  # the depth CNN's, after its BNs' cancellation
ATT_GRADS = ("decoder.att_w_enc", "decoder.att_b_enc", "decoder.att_w_dec",
             "decoder.att_b_dec")


def train_vocab():
    """V words: the synthetic captions' words, placeholder words, then the
    four special tokens (``cli.placeholder_vocab``'s order)."""
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.data.synthetic import (
        synthetic_words)
    words = synthetic_words()
    w2i, _ = placeholder_vocab(VOCAB - len(words))
    names = words + list(w2i)
    return ({w: i for i, w in enumerate(names)},
            {i: w for i, w in enumerate(names)})


def train_cfg(root):
    """``ConfigTrain`` defaults (B=30, 32 tokens, lr 1e-3, dropout 0.5),
    every path under ``root``."""
    import os
    from depth_image_captioning_pub_torch.config import ConfigTrain
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return ConfigTrain()
    finally:
        os.chdir(cwd)


def counted(tag, fn):
    """fn() with every launch counter set to 0 just before and read just
    after, and no plain version allowed to run."""
    import torch
    torch.cuda.synchronize()
    reset_counts()
    with PlainCalls() as plain:
        out = fn()
    torch.cuda.synchronize()
    launches = read_counts()
    if plain.calls:
        raise RuntimeError(f"plain versions ran on the {tag} path: "
                           f"{sorted(set(plain.calls))}")
    return out, launches


def read_losses(save_dir, prefix, suffix="_coco0"):
    """The CSV losses of run 0 (NIC's files have no "_" before it)."""
    import os
    out = {}
    for split in ("train", "val"):
        path = os.path.join(save_dir, f"{prefix}_{split}_loss{suffix}.csv")
        with open(path) as f:
            out[split] = [float(line.split(", ")[1])
                          for line in f.read().splitlines()]
    if not all(np.isfinite(v).all() and v for v in out.values()):
        raise RuntimeError(f"{prefix} losses not finite: {out}")
    return out


def read_back(kind, cfg, root, w2i, i2w, depth_fn, smi, tag):
    """The best-val files through ``cli.load_eval_components`` and
    ``evaluate`` over the val images: (scores, captioner)."""
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.config import ConfigEval
    from depth_image_captioning_pub_torch.engine.evaluate import evaluate
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    import torch
    ecfg = ConfigEval()
    ecfg.max_length = MAX_LEN
    for field in ("save_directory_soft", "save_directory_hard",
                  "save_directory_Cdep_soft", "save_directory_Cdep_hard",
                  "save_directory_nic"):
        setattr(ecfg, field, getattr(cfg, field))
    if kind == "nic":
        save_dir, files = cfg.save_directory_nic, ecfg.nic_parameter_files
    else:
        base, atten = kind.split("-")
        save_dir, files = cli.eval_tables(
            ecfg, atten, False, base != "base",
            encoder="mlp" if base == "mdepth" else "cnn")
    cap = build_captioner(kind, VOCAB, device=torch.device("cuda"))
    t0 = time.perf_counter()
    scores = evaluate(kind, "coco", cap,
                      lambda i: cli.load_eval_components(save_dir, files[i],
                                                         cap),
                      root["val"], w2i, i2w, ecfg, depth_fn=depth_fn,
                      num_sets=1, quiet=True)
    if not all(len(v) == 1 and np.isfinite(v[0]) for v in scores.values()):
        raise RuntimeError(f"{tag}: scores of the trained set {scores}")
    log(tag, f"best-val set read back and scored over {len(root['val'])} "
        f"val images in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v[0]:.4f}" for k, v in scores.items())
        + f" [{smi}]")
    return scores, cap


def step_split(cap, batch, smi, tag):
    """The train step's device time by stage (CUDA events, each timed
    alone): RGB encoder, depth encoder + decoder forward, backward, AdamW."""
    import torch
    from depth_image_captioning_pub_torch.engine import steps
    from depth_image_captioning_pub_torch.ops.precision import full_f32
    opt = steps.make_optimizer(cap, 1e-3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ev = Events()
    with full_f32():
        feats = ev.ms("rgb encoder", lambda: steps.frozen_features(
            cap, batch["images"]))

        def forward():
            return steps.attention_loss(cap, feats, batch, train=True,
                                        alpha_reg=0.7, generator=gen)[0]

        def forward_backward():
            opt.zero_grad(set_to_none=True)
            forward().backward()

        ev.ms("depth encoder + decoder forward", forward)
        ev.ms("forward + backward", forward_backward)
        ev.ms("AdamW", opt.step)
    t = ev.times
    backward = t["forward + backward"] - t["depth encoder + decoder forward"]
    total = (t["rgb encoder"] + t["forward + backward"] + t["AdamW"])
    log(tag, f"train step at B={batch['images'].shape[0]}, "
        f"{batch['captions'].shape[1] - 1} teacher-forced steps (device ms, "
        f"each stage timed alone): RGB encoder {t['rgb encoder']:.2f}, "
        f"depth encoder + decoder forward "
        f"{t['depth encoder + decoder forward']:.2f}, backward "
        f"{backward:.2f}, AdamW {t['AdamW']:.2f}; step {total:.2f} ms "
        f"[{smi}]")
    return total


def overfit(cap, batch, smi, tag):
    """OVERFIT_STEPS steps at lr 1e-2 on one fixed batch, the same dropout
    masks each step, no alpha penalty: CE must fall below half its first
    value."""
    import torch
    from depth_image_captioning_pub_torch.engine import steps
    opt = steps.make_optimizer(cap, OVERFIT_LR)
    gen = torch.Generator(device="cuda")
    ces = []
    t0 = time.perf_counter()
    for _ in range(OVERFIT_STEPS):
        gen.manual_seed(0)
        ces.append(steps.attention_train_step(cap, opt, batch,
                                              generator=gen)["ce"])
    ces = torch.stack(ces).cpu().numpy()
    dt = time.perf_counter() - t0
    log(tag, f"overfit {OVERFIT_STEPS} steps at lr {OVERFIT_LR} on one "
        f"batch: CE {ces[0]:.4f} -> {ces[-1]:.4f} (min {ces.min():.4f}); "
        f"{dt * 1e3 / OVERFIT_STEPS:.1f} ms a step [{smi}]")
    if not np.isfinite(ces).all() or ces[-1] >= 0.5 * ces[0]:
        raise RuntimeError(f"{tag}: CE {ces[0]} -> {ces[-1]} in "
                           f"{OVERFIT_STEPS} steps, not below half")


ZERO_GRADS = ("decoder.att_b_full", "depth_module.conv1.bias",
              "depth_module.conv2.bias", "depth_module.conv3.bias")


def card_vs_cpu(cap, cfg, batch, smi, tag):
    """One depth-soft train forward and backward on the card and on the
    CPU from the same weights, frozen features, depth maps and dropout
    masks, the depth CNN in f32 on both: loss, each gradient and the BN
    running statistics. The attention scorer's gradients (``ATT_GRADS``)
    pass through the softmax Jacobian, alpha_k (g_k - sum alpha g), a
    difference of nearly equal terms, and the depth CNN's through its
    BNs' mean subtraction: each has a bound of its own.

    The encoder's features are rescaled region by region by seeded
    factors in [0.5, 1.5): a random-weight ResNet-152's regions are nearly
    alike, which leaves the attention parameters' gradients a
    cancellation at rounding level. ``ZERO_GRADS`` are zero but for
    rounding (the softmax is shift-invariant; each BN subtracts its batch
    mean, so a conv bias's gradient is a sum over up to 160k positions
    that cancels): they are held below 1e-2 of the largest gradient of
    their module on both devices (a BN that did not subtract its mean
    would leave them at its scale)."""
    import torch
    from depth_image_captioning_pub_torch.engine import steps
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.ops.precision import full_f32
    feats = steps.frozen_features(cap, batch["images"])
    gen = torch.Generator().manual_seed(5)
    factors = 0.5 + torch.rand(feats.shape[:2] + (1,), generator=gen)
    feats = (feats.float() * factors.to(feats.device)).to(feats.dtype)
    b, h = feats.shape[0], cfg.dim_hidden
    masks = [torch.rand((b, h), generator=gen) < 1.0 - cfg.dropout
             for _ in range(batch["captions"].shape[1] - 1)]
    state = {k: v.detach().float().cpu() for k, v in cap.state_dict().items()
             if k.startswith(("decoder.", "depth_module."))}
    out = {}
    for dev in ("cuda", "cpu"):
        twin = build_captioner("depth-soft", VOCAB, cfg,
                               encoder_dtype=torch.float32,
                               resnet_layers=(1, 1, 1, 1), device=dev)
        missing = twin.load_state_dict(state, strict=False)
        if missing.unexpected_keys:
            raise RuntimeError(f"{tag}: {missing.unexpected_keys}")
        b_dev = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        with full_f32():
            loss, _ = steps.attention_loss(
                twin, feats.to(dev), b_dev, train=True, alpha_reg=0.7,
                dropout_keep=lambda t, shape: masks[t].to(dev))
            loss.backward()
        grads = {n: p.grad.float().cpu()
                 for n, p in twin.named_parameters() if p.grad is not None}
        stats = {n: v.cpu() for n, v in twin.depth_module.state_dict().items()
                 if "running" in n}
        out[dev] = (loss.item(), grads, stats, time.perf_counter() - t0)
    (lc, gc, sc, tc), (lp, gp, sp, tp) = out["cuda"], out["cpu"]
    rel = abs(lc - lp) / abs(lp)
    worst, zeros = {}, {}
    for name, g in gp.items():
        if name in ZERO_GRADS:
            module = name.split(".")[0]
            top = max(v.abs().max().item() for n, v in gp.items()
                      if n.startswith(module) and n not in ZERO_GRADS)
            zeros[name] = max(g.abs().max().item(),
                              gc[name].abs().max().item()) / top
            continue
        err = (gc[name] - g).abs().max().item() / max(g.abs().max().item(),
                                                        1e-30)
        worst[name] = err
    stat_err = max((sc[n] - sp[n]).abs().max().item() for n in sp)
    dec = max(v for n, v in worst.items()
              if n.startswith("decoder.") and n not in ATT_GRADS)
    att = max(worst[n] for n in ATT_GRADS)
    dep = max(v for n, v in worst.items() if n.startswith("depth_module."))
    log(tag, f"card vs CPU, one train forward + backward (B={b}, depth CNN "
        f"f32): loss {lc:.6f} vs {lp:.6f} (rel {rel:.2e}, max "
        f"{CARD_CPU_LOSS_RTOL}); gradient error / own max |g|: decoder "
        f"{dec:.2e} (max {CARD_CPU_GRAD}), its attention scorer {att:.2e} "
        f"(max {CARD_CPU_ATT_GRAD}), depth CNN {dep:.2e} (max "
        f"{CARD_CPU_DEPTH_GRAD}; worst "
        f"{max((v, n) for n, v in worst.items())[1]}); BN statistics "
        f"{stat_err:.2e} (max {CARD_CPU_STATS_ATOL}); zero gradients / "
        f"their module's max: {max(zeros.values()):.2e} (max 1e-2); card "
        f"{tc:.2f} s, CPU {tp:.2f} s (host clock) [{smi}]")
    log(tag, "per gradient: " + ", ".join(
        f"{n.split('.', 1)[1]} {v:.1e}" for n, v in sorted(worst.items())))
    bad = [n for n, v in worst.items()
           if v > (CARD_CPU_DEPTH_GRAD if n.startswith("depth_module.")
                   else CARD_CPU_ATT_GRAD if n in ATT_GRADS
                   else CARD_CPU_GRAD)]
    bad += [n for n, v in zeros.items() if v > 1e-2]
    if rel > CARD_CPU_LOSS_RTOL or bad or stat_err > CARD_CPU_STATS_ATOL:
        raise RuntimeError(f"{tag}: card vs CPU step: loss rel {rel}, "
                           f"gradients {bad}, statistics {stat_err}")


def phase_train_depth_soft(smi, est, root, w2i, i2w):
    """The main training path: depth-soft, its depth cache built by the
    DPT, 2 epochs, the best-val set scored; then the step checks."""
    import os
    import torch
    from depth_image_captioning_pub_torch.data.pipeline import train_batches
    from depth_image_captioning_pub_torch.engine import depth_cache, steps
    from depth_image_captioning_pub_torch.engine import train as tr
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.ops.kernels import vit_attention
    tag = "train-depth-soft"
    dev = torch.device("cuda")
    cfg = train_cfg(root["dir"])
    depth_fn = est.depth_fn()
    cache = depth_cache.DepthMapCache(
        os.path.join(cfg.save_dir("depth_soft", False),
                     "depth_cache_coco.npy"), TRAIN_IMAGES)
    online = depth_cache.online_depth_provider(depth_fn, dev)
    times = {}

    # the DPT's first call at the cache's batch shape, outside the count
    depth_fn(torch.from_numpy(np.stack([root["train"].load_image(i)
                                        for i in range(CACHE_BATCH)])).to(dev))

    def run():
        times["cache"] = cache.build(root["train"], depth_fn, dev,
                                     batch_size=CACHE_BATCH, quiet=True)
        torch.cuda.reset_peak_memory_stats()
        summary = tr.train("depth-soft", 0, cfg=cfg,
                           depth_provider=depth_cache.cached_depth_provider(
                               cache),
                           val_depth_provider=online,
                           datasets=(root["train"], root["val"]),
                           word_to_id=w2i, num_epochs=TRAIN_EPOCHS,
                           quiet=True, device=dev)
        times["peak"] = torch.cuda.max_memory_allocated()
        scores, cap = read_back("depth-soft", cfg, root, w2i, i2w, depth_fn,
                                smi, tag)
        return summary, cap

    (summary, ecap), launches = counted(tag, run)
    cache_chunks = -(-TRAIN_IMAGES // CACHE_BATCH)
    val_chunks = TRAIN_EPOCHS * -(-TRAIN_VAL // cfg.batch_size)
    eval_chunks = -(-TRAIN_VAL // 50)
    want = dict.fromkeys(launches, 0)
    want.update(vit_attention=DPT_BLOCKS * (cache_chunks + val_chunks
                                            + eval_chunks),
                decode_seq=eval_chunks)
    if launches != want:
        raise RuntimeError(f"{tag} launches {launches}, expected {want}")
    losses = read_losses(cfg.save_dir("depth_soft", False), "depth_soft")
    rate = summary["train_rows"] / summary["train_seconds"]
    last = TRAIN_IMAGES / summary["epoch_train_seconds"][-1]
    log(tag, f"launches {launches}: K5 {DPT_BLOCKS} x ({cache_chunks} cache "
        f"+ {val_chunks} validation + {eval_chunks} scoring DPT chunks), K2 "
        f"{eval_chunks} on the trained weights; plain calls 0")
    log(tag, f"{TRAIN_EPOCHS} epochs of {TRAIN_IMAGES} images (B="
        f"{cfg.batch_size}, {cfg.max_caption_len - 1} teacher-forced steps): "
        f"train losses {losses['train']}, val losses {losses['val']}; "
        f"{last:.1f} train images/s in the last epoch, {rate:.1f} over the "
        f"run ({summary['train_seconds']:.2f} s for {summary['train_rows']} "
        f"rows, host clock, first steps included); peak memory "
        f"{times['peak'] / 2**30:.2f} GiB [{smi}]")

    # K5's share of the cache build: its 12 launches a chunk, alone
    n_tok = 1 + (est.image_size // est.model.patch) ** 2
    blk = getattr(est.model, est.model.blocks[0])
    dim, heads = blk.qkv.in_features, blk.heads
    qkv = torch.zeros(3, CACHE_BATCH * heads, n_tok, dim // heads,
                      device=dev, dtype=torch.bfloat16).normal_()
    ev = Events()
    ev.ms("K5", lambda: [vit_attention.fused_attention(
        *qkv, scale=(dim // heads) ** -0.5, n_valid=n_tok)
        for _ in range(DPT_BLOCKS)])
    k5_s = ev.times["K5"] * cache_chunks / 1e3
    log(tag, f"depth cache: {TRAIN_IMAGES} images in {times['cache']:.2f} s "
        f"= {TRAIN_IMAGES / times['cache']:.1f} images/s (host clock, "
        f"loader and f16 write included); K5 {k5_s * 1e3:.2f} ms of it "
        f"({100 * k5_s / times['cache']:.1f}%) [{smi}]")

    # the step's checks on a captioner of the path's configuration
    cap = build_captioner("depth-soft", VOCAB, cfg, device=dev)
    cap.init(torch.Generator().manual_seed(3))
    batch = next(train_batches(root["train"], w2i, cfg.batch_size,
                               cfg.max_caption_len, shuffle=False, seed=0))
    dmaps = depth_cache.cached_depth_provider(cache)(batch.images,
                                                     batch.indices)
    dbatch = steps.batch_to_device(batch, dev, dmaps)
    card_vs_cpu(cap, cfg, dbatch, smi, tag)
    step_ms = step_split(cap, dbatch, smi, tag)
    overfit(cap, dbatch, smi, tag)
    del ecap, cap
    return launches, step_ms


def short_train(kind, smi, root, w2i, i2w, depth_fn=None, seed=None):
    """One epoch of 2 steps + validation of ``kind`` (counters reset and
    read around it), its best-val set scored; returns (launches,
    losses)."""
    import torch
    from depth_image_captioning_pub_torch.engine import depth_cache
    from depth_image_captioning_pub_torch.engine import train as tr
    tag = f"train-{kind}"
    cfg = train_cfg(root["dir"])
    if seed is not None:
        cfg.seed = seed
    dev = torch.device("cuda")
    provider = (None if depth_fn is None
                else depth_cache.online_depth_provider(depth_fn, dev))

    def run():
        t0 = time.perf_counter()
        summary = tr.train(kind, 0, cfg=cfg, depth_provider=provider,
                           datasets=(root["short"], root["val"]),
                           word_to_id=w2i, num_epochs=1, quiet=True,
                           device=dev)
        dt = time.perf_counter() - t0
        read_back(kind, cfg, root, w2i, i2w, depth_fn, smi, tag)
        return summary, dt

    (summary, dt), launches = counted(tag, run)
    prefix = kind.replace("-", "_")
    losses = read_losses(cfg.save_dir(tr._save_dir_kind(kind), False),
                         prefix, "0" if kind == "nic" else "_coco0")
    log(tag, f"1 epoch of {SHORT_IMAGES} images + {TRAIN_VAL} val (seed "
        f"{cfg.seed}): train loss {losses['train'][0]:.5f}, val loss "
        f"{losses['val'][0]:.5f}; {dt:.1f} s with build, files and "
        f"scoring; {summary['train_rows'] / summary['train_seconds']:.1f} "
        f"train images/s; launches {launches} [{smi}]")
    return launches, losses


def hard_noise(smi, root, w2i):
    """base-hard's training noise moves its loss: one train forward on one
    batch and weights at two generator seeds, and at temperature 1.0 and
    0.5 on one seed."""
    import torch
    from depth_image_captioning_pub_torch.data.pipeline import train_batches
    from depth_image_captioning_pub_torch.engine import steps
    from depth_image_captioning_pub_torch.engine.train import (
        gumbel_temperature)
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    cfg = train_cfg(root["dir"])
    cap = build_captioner("base-hard", VOCAB, cfg, device="cuda")
    cap.init(torch.Generator().manual_seed(4))
    batch = steps.batch_to_device(next(train_batches(
        root["short"], w2i, cfg.batch_size, cfg.max_caption_len,
        shuffle=False, seed=0)), "cuda")
    feats = steps.frozen_features(cap, batch["images"])
    # regions rescaled by seeded factors, as in ``card_vs_cpu``: a random
    # ResNet-152's regions are nearly alike, so which one a draw picks
    # would hardly move the loss
    factors = 0.5 + torch.rand(feats.shape[:2] + (1,),
                               generator=torch.Generator().manual_seed(5))
    feats = (feats.float() * factors.to(feats.device)).to(feats.dtype)

    def loss(seed, temp):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        with torch.no_grad():
            return steps.attention_loss(cap, feats, batch, train=True,
                                        temp=temp, generator=gen)[0].item()
    got = {(s, t): loss(s, t) for s, t in ((0, 1.0), (0, 1.0), (1, 1.0),
                                           (0, 0.5))}
    sched = [round(gumbel_temperature(e, cfg.temp_sch), 4)
             for e in (0, 10, 60, 120, 150)]
    log("train-base-hard", f"train-mode loss on one batch: seed 0 "
        f"{got[(0, 1.0)]:.6f}, seed 1 {got[(1, 1.0)]:.6f}, seed 0 at "
        f"temperature 0.5 {got[(0, 0.5)]:.6f}; the schedule at epochs 0, 10, "
        f"60, 120, 150: {sched} [{smi}]")
    if not (got[(0, 1.0)] != got[(1, 1.0)] and got[(0, 1.0)] != got[(0, 0.5)]
            and len({got[(0, 1.0)], loss(0, 1.0)}) == 1):
        raise RuntimeError(f"base-hard noise did not move the loss: {got}")


def phase_train(smi, est):
    """Phases 20-24: training on the card (``PATHS``' train-*)."""
    import shutil
    import tempfile
    from pathlib import Path
    from depth_image_captioning_pub_torch.data.synthetic import (
        SyntheticCaptions)
    import torch
    w2i, i2w = train_vocab()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build, prefix="train_")
    data = SyntheticCaptions(TRAIN_IMAGES + TRAIN_VAL, seed=21)
    root = {"dir": tmp, "train": _Rows(data, range(TRAIN_IMAGES)),
            "short": _Rows(data, range(SHORT_IMAGES)),
            "val": _Rows(data, range(TRAIN_IMAGES, TRAIN_IMAGES + TRAIN_VAL))}
    try:
        out = {}
        out["train-depth-soft"], step_ms = phase_train_depth_soft(
            smi, est, root, w2i, i2w)
        out["train-base-soft"], _ = short_train("base-soft", smi, root, w2i,
                                                i2w)
        out["train-nic"], _ = short_train("nic", smi, root, w2i, i2w)
        out["train-base-hard"], a = short_train("base-hard", smi, root, w2i,
                                                i2w)
        _, b = short_train("base-hard", smi, root, w2i, i2w, seed=124)
        if a == b:
            raise RuntimeError(f"base-hard: seeds 123 and 124 gave the same "
                               f"losses {a}")
        hard_noise(smi, root, w2i)
        depth_fn = est.depth_fn()
        out["train-mdepth-soft"], _ = short_train(
            "mdepth-soft", smi, root, w2i, i2w, depth_fn=depth_fn)
        k5 = out["train-mdepth-soft"]["vit_attention"]
        b = train_cfg(tmp).batch_size           # train, val, scoring chunks
        chunks = (-(-SHORT_IMAGES // b) + -(-TRAIN_VAL // b)
                  + -(-TRAIN_VAL // 50))
        if k5 != DPT_BLOCKS * chunks:
            raise RuntimeError(f"mdepth-soft training: K5 {k5} launches, "
                               f"expected {DPT_BLOCKS * chunks}")
        for tag in ("train-base-soft", "train-nic", "train-base-hard"):
            if out[tag]["vit_attention"]:
                raise RuntimeError(f"{tag} launched K5")
        torch.cuda.synchronize()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 25: reference weights ------------------------------------------

REF_SEQ = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
           "layer3": "6", "layer4": "7"}


def _ref_t(a):
    return np.ascontiguousarray(np.asarray(a, np.float32).T)


def _ref_conv(a):
    return np.ascontiguousarray(np.asarray(a, np.float32).transpose(3, 2, 0, 1))


def _ref_bn(sd, dst, p, s):
    sd[dst + ".weight"], sd[dst + ".bias"] = p["scale"], p["bias"]
    sd[dst + ".running_mean"], sd[dst + ".running_var"] = s["mean"], s["var"]
    sd[dst + ".num_batches_tracked"] = np.array(0, np.int64)


def ref_resnet(variables, fc_classes=1000):
    """The inverse of ``torch_bridge.resnet_to_flax``: a backbone's flax
    ``{"params", "batch_stats"}`` -> torchvision's ResNet state dict
    (``layerS.B.``, ``downsample.0/1``, with ``num_batches_tracked`` and a
    zero ``fc`` head that the bridge skips)."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {"conv1.weight": _ref_conv(p["conv1"]["kernel"])}
    _ref_bn(sd, "bn1", p["bn1"], s["bn1"])
    for name, blk in p.items():
        if not name.startswith("layer"):
            continue
        stage, b = name[len("layer"):].split("_")
        src = f"layer{stage}.{b}"
        for ci in (1, 2, 3):
            sd[f"{src}.conv{ci}.weight"] = _ref_conv(blk[f"conv{ci}"]["kernel"])
            _ref_bn(sd, f"{src}.bn{ci}", blk[f"bn{ci}"], s[name][f"bn{ci}"])
        if "ds_conv" in blk:
            sd[f"{src}.downsample.0.weight"] = _ref_conv(
                blk["ds_conv"]["kernel"])
            _ref_bn(sd, f"{src}.downsample.1", blk["ds_bn"],
                    s[name]["ds_bn"])
    if fc_classes:
        sd["fc.weight"] = np.zeros((fc_classes, 2048), np.float32)
        sd["fc.bias"] = np.zeros((fc_classes,), np.float32)
    return sd


def ref_encoder(enc_variables):
    """The inverse of ``torch_bridge.encoder_to_flax``: the grid encoder's
    flax variables -> the reference's encoder ``.pth`` (the backbone as an
    ``nn.Sequential``: ``backbone.0.``, ``backbone.4.0.``, ...)."""
    sd = ref_resnet({"params": enc_variables["params"]["backbone"],
                     "batch_stats": enc_variables["batch_stats"]["backbone"]},
                    fc_classes=0)
    out = {}
    for k, v in sd.items():
        head, rest = k.split(".", 1)
        out[f"backbone.{REF_SEQ[head]}.{rest}"] = v
    return out


def ref_nic_encoder(backbone_variables, enc_linear):
    """The reference NIC encoder ``.pth``: the Sequential backbone and its
    ``linear`` projection in one file."""
    sd = ref_encoder({"params": {"backbone": backbone_variables["params"]},
                      "batch_stats": {
                          "backbone": backbone_variables["batch_stats"]}})
    sd["linear.weight"] = _ref_t(enc_linear["linear"]["kernel"])
    sd["linear.bias"] = enc_linear["linear"]["bias"]
    return sd


REF_DECODER = (("embed", "embed.weight", False),
               ("att_w_enc", "attention.encoder_att.weight", True),
               ("att_b_enc", "attention.encoder_att.bias", False),
               ("att_w_dec", "attention.decoder_att.weight", True),
               ("att_b_dec", "attention.decoder_att.bias", False),
               ("att_w_full", "attention.full_att.weight", True),
               ("att_b_full", "attention.full_att.bias", False),
               ("lstm_w_ih", "decode_step.weight_ih", True),
               ("lstm_w_hh", "decode_step.weight_hh", True),
               ("lstm_b_ih", "decode_step.bias_ih", False),
               ("lstm_b_hh", "decode_step.bias_hh", False),
               ("init_w", "init_linear.weight", True),
               ("init_b", "init_linear.bias", False),
               ("f_beta_w", "f_beta.weight", True),
               ("f_beta_b", "f_beta.bias", False),
               ("out_w", "linear.weight", True),
               ("out_b", "linear.bias", False))


def ref_decoder(params):
    """The inverse of ``torch_bridge.attention_decoder_to_flax``."""
    return {ref: (_ref_t(params[name]) if t else np.asarray(params[name]))
            for name, ref, t in REF_DECODER}


def ref_nic_decoder(params, num_layers=2):
    """The inverse of ``torch_bridge.nic_decoder_to_flax``."""
    sd = {"embed.weight": np.asarray(params["embed"]),
          "linear.weight": _ref_t(params["out_w"]),
          "linear.bias": np.asarray(params["out_b"])}
    for li in range(num_layers):
        for w in ("ih", "hh"):
            sd[f"lstm.weight_{w}_l{li}"] = _ref_t(params[f"lstm{li}_w_{w}"])
            sd[f"lstm.bias_{w}_l{li}"] = np.asarray(params[f"lstm{li}_b_{w}"])
    return sd


def ref_depth_cnn(params, stats):
    """The inverse of ``torch_bridge.depth_cnn_to_flax``."""
    sd = {}
    for ci in (1, 2, 3):
        sd[f"conv{ci}.weight"] = _ref_conv(params[f"conv{ci}"]["kernel"])
        sd[f"conv{ci}.bias"] = params[f"conv{ci}"]["bias"]
        _ref_bn(sd, f"bn{ci}", params[f"bn{ci}"], stats[f"bn{ci}"])
    return sd


def ref_depth_mlp(params):
    """The inverse of ``torch_bridge.depth_mlp_to_flax``."""
    sd = {}
    for li in ("l1", "l2", "l3"):
        sd[f"{li}.weight"] = _ref_t(params[li]["kernel"])
        sd[f"{li}.bias"] = params[li]["bias"]
    return sd


def ref_dpt(params):
    """The inverse of ``torch_bridge.dpt_to_flax``: the DPT's flax params ->
    the Omnidata DPT-hybrid state dict (the ``model.`` prefix not added).
    A model without ``refinenet4``'s first residual unit (the forward
    never runs it) gets zeros of its second unit's shapes there, as a
    checkpoint holds that unit."""
    sd = {}

    def lin(dst, t):
        sd[dst + ".weight"], sd[dst + ".bias"] = _ref_t(t["kernel"]), t["bias"]

    def conv(dst, t):
        sd[dst + ".weight"] = _ref_conv(t["kernel"])
        if "bias" in t:
            sd[dst + ".bias"] = t["bias"]

    def norm(dst, t):
        t = t.get("gn", t)
        sd[dst + ".weight"], sd[dst + ".bias"] = t["scale"], t["bias"]

    pre = "pretrained.model."
    rb = pre + "patch_embed.backbone."
    res = params["resnet"]
    conv(rb + "stem.conv", res["stem_conv"])
    norm(rb + "stem.norm", res["stem_norm"])
    for name, blk in res.items():
        if not name.startswith("stage"):
            continue
        si, bi = name[len("stage"):].split("_")
        src = f"{rb}stages.{si}.blocks.{bi}."
        for ci in (1, 2, 3):
            conv(src + f"conv{ci}", blk[f"conv{ci}"])
            norm(src + f"norm{ci}", blk[f"norm{ci}"])
        if "ds_conv" in blk:
            conv(src + "downsample.conv", blk["ds_conv"])
            norm(src + "downsample.norm", blk["ds_norm"])
    conv(pre + "patch_embed.proj", params["patch_proj"])
    sd[pre + "cls_token"] = params["cls_token"]
    sd[pre + "pos_embed"] = params["pos_embed"]
    for name, blk in params.items():
        if not (name.startswith("block") and name[5:].isdigit()):
            continue
        src = f"{pre}blocks.{name[5:]}."
        norm(src + "norm1", blk["norm1"])
        lin(src + "attn.qkv", blk["qkv"])
        lin(src + "attn.proj", blk["proj"])
        norm(src + "norm2", blk["norm2"])
        lin(src + "mlp.fc1", blk["fc1"])
        lin(src + "mlp.fc2", blk["fc2"])
    for i in (3, 4):
        lin(f"pretrained.act_postprocess{i}.0.project.0",
            params[f"pp{i}_readout"]["project"])
        conv(f"pretrained.act_postprocess{i}.3", params[f"pp{i}_conv"])
    conv("pretrained.act_postprocess4.4", params["pp4_down"])
    for i in range(1, 5):
        conv(f"scratch.layer{i}_rn", params[f"layer{i}_rn"])
        blk = params[f"refinenet{i}"]
        src = f"scratch.refinenet{i}."
        conv(src + "out_conv", blk["out_conv"])
        for unit in (1, 2):
            res_unit = blk.get(f"res{unit}") or {
                c: {k: np.zeros_like(v) for k, v in t.items()}
                for c, t in blk["res2"].items()}
            for c in ("conv1", "conv2"):
                conv(f"{src}resConfUnit{unit}.{c}", res_unit[c])
    for i, name in enumerate(("head_conv1", "head_conv2", "head_conv3")):
        conv(f"scratch.output_conv.{2 * i}", params[name])
    return sd


# ---- phases 25 and 26 ------------------------------------------------------

REF_IMAGES = 64            # phase 25's captioned images: one chunk


def _flat_equal(got, want):
    """Two flax trees hold the same leaves, bit for bit."""
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        flatten_tree)
    fg, fw = flatten_tree(got), flatten_tree(want)
    return set(fg) == set(fw) and all(
        np.asarray(fg[k]).dtype == np.asarray(fw[k]).dtype
        and np.array_equal(fg[k], fw[k]) for k in fw)


def write_reference_files(root, writers, est):
    """Phase 25's files from seeded port modules: a reference set per
    captioner of ``writers`` (set 1 of ``eval_tables``' layout, ``.pth``
    state dicts only), torchvision's ResNet-152 (base-soft's backbone) and
    the Omnidata DPT-hybrid ``.ckpt`` (``est``'s DPT, with a pickled object
    beside its state dict, as a Lightning checkpoint has). Returns
    (ConfigEval, {kind: (save_dir, files)}, torchvision path, DPT path,
    {file: bytes})."""
    import argparse
    import os
    import torch
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        flax_trees, params_to_jax)
    cfg = eval_cfg(root)
    sizes = {}

    def save(path, sd, wrap=lambda sd: sd):
        torch.save(wrap({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()}), path)
        sizes[path] = os.path.getsize(path)

    tables = {}
    for kind, cap in writers.items():
        trainable, frozen, stats = params_to_jax(cap)
        if kind == "nic":
            save_dir, files = cfg.save_directory_nic, \
                cfg.nic_parameter_files[1]
            sds = [ref_nic_encoder(frozen["encoder"], trainable["enc_linear"]),
                   ref_nic_decoder(trainable["decoder"])]
        else:
            save_dir, table = cli.eval_tables(cfg, "soft", False,
                                              kind == "depth-soft")
            files = table[1]
            sds = [ref_encoder(frozen["encoder"]),
                   ref_decoder(trainable["decoder"])]
            if kind == "depth-soft":
                sds.append(ref_depth_cnn(trainable["depth_encoder"], stats))
        os.makedirs(save_dir, exist_ok=True)
        for name, sd in zip(files, sds):
            save(os.path.join(save_dir, name), sd)
        tables[kind] = (save_dir, files)
    enc = params_to_jax(writers["base-soft"])[1]["encoder"]
    tv = os.path.join(root, "resnet152-torchvision.pth")
    save(tv, ref_resnet({"params": enc["params"]["backbone"],
                         "batch_stats": enc["batch_stats"]["backbone"]}))
    ckpt = os.path.join(root, "omnidata_dpt_hybrid.ckpt")
    save(ckpt, ref_dpt(flax_trees(est.model)[0]), wrap=lambda sd: {
        "state_dict": {"model." + k: v for k, v in sd.items()},
        "epoch": 0,
        "hyper_parameters": argparse.Namespace(backbone="vitb_rn50_384")})
    return cfg, tables, tv, ckpt, sizes


def phase_reference_weights(smi, base_cap, est):
    """Phase 25: reference-layout files at full width through the port's
    entry points, to bit-identical captions and depth maps."""
    import os
    import shutil
    import tempfile
    from pathlib import Path
    import torch
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.models.dpt import DPTDepthEstimator
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    from depth_image_captioning_pub_torch.utils import convert
    from depth_image_captioning_pub_torch.utils import torch_bridge as tb
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        load_component)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        dpt_params_from_jax, flax_trees, params_from_jax, params_to_jax)
    tag = "reference-weights"
    dev = torch.device("cuda")
    w2i, i2w = placeholder_vocab(VOCAB)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build, prefix="reference_")
    try:
        writers = {"base-soft": base_cap}
        for kind, seed in (("depth-soft", 2), ("nic", 3)):
            writers[kind] = build_captioner(kind, VOCAB, device=dev)
            writers[kind].init(torch.Generator().manual_seed(seed))
        t0 = time.perf_counter()
        cfg, tables, tv, ckpt, sizes = write_reference_files(
            tmp, writers, est)
        log(tag, f"wrote {len(sizes)} reference-layout files "
            f"({sum(sizes.values()) / 1e6:.1f} MB) in "
            f"{time.perf_counter() - t0:.1f} s")
        for path, size in sizes.items():
            t0 = time.perf_counter()
            tb.load_state_dict(path)
            log(tag, f"{os.path.relpath(path, tmp)}: {size / 1e6:.1f} MB, "
                f"read by torch_bridge.load_state_dict in "
                f"{time.perf_counter() - t0:.2f} s (host clock)")

        images = np.random.default_rng(25).integers(
            0, 256, (REF_IMAGES, 224, 224, 3), dtype=np.uint8)
        x = torch.from_numpy(images).to(dev)

        def pipeline(cap, depth_fn=None):
            return CaptionPipeline(
                cap, w2i, i2w, depth_fn=depth_fn if cap.spec.uses_depth
                else None, max_length=MAX_LEN, batch_buckets=(REF_IMAGES,))

        want = {k: pipeline(c, est.depth_fn()).caption_tokens(images)
                for k, c in writers.items()}
        # the same weights at the DPT's knobs: 224x224 input (position
        # embeddings resized 24 -> 14), tanh GELU, the low-resolution head
        knobs = eval_cfg(tmp)
        knobs.dpt_image_size, knobs.dpt_gelu, knobs.dpt_head = (
            224, "tanh", "lowres")
        writer224 = DPTDepthEstimator(device=dev, image_size=224,
                                      gelu="tanh", head="lowres")
        dpt_params_from_jax(writer224, {"params": flax_trees(est.model)[0]})
        with torch.inference_mode():
            want_depth = est.depth_fn()(x).cpu()
            want_knobs = writer224.depth_fn()(x).cpu()
        del writer224

        def run():
            got, secs = {}, {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cfg.dpt_weights = knobs.dpt_weights = ckpt
            depth_fn = cli.eval_depth_fn(cfg, dev)
            torch.cuda.synchronize()
            secs["DPT .ckpt (eval_depth_fn)"] = time.perf_counter() - t0
            with torch.inference_mode():
                got["depth"] = depth_fn(x).cpu()
                got["knobs"] = cli.eval_depth_fn(knobs, dev)(x).cpu()
            for kind in writers:
                cap = build_captioner(kind, VOCAB, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                enc, params, stats = cli.load_eval_components(*tables[kind],
                                                              cap)
                params_from_jax(cap, params, {"encoder": enc}, stats)
                torch.cuda.synchronize()
                secs[f"{kind} set (load_eval_components + "
                     f"params_from_jax)"] = time.perf_counter() - t0
                got[f"{kind} weights"] = cap
                got[kind] = pipeline(cap, depth_fn).caption_tokens(images)
            return got, secs

        (got, secs), launches = counted(tag, run)
        want_launches = dict.fromkeys(launches, 0)
        want_launches.update(vit_attention=3 * DPT_BLOCKS, decode_seq=2,
                             nic_seq=1)
        if launches != want_launches:
            raise RuntimeError(f"{tag} launches {launches}, expected "
                               f"{want_launches}")
        for kind, cap in writers.items():
            sd_w, sd_g = cap.state_dict(), got[f"{kind} weights"].state_dict()
            if list(sd_w) != list(sd_g) or not all(
                    torch.equal(sd_w[k], sd_g[k]) for k in sd_w):
                raise RuntimeError(f"{tag}: {kind}'s loaded weights differ "
                                   f"from the writer's")
            same = np.array_equal(got[kind], want[kind])
            log(tag, f"{kind}: {REF_IMAGES} images from the .pth set: "
                f"tokens {'bit-identical' if same else 'DIFFER'} to the "
                f"writer's ({len(set(map(tuple, want[kind])))} distinct "
                f"captions); weights bit-equal")
            if not same:
                raise RuntimeError(f"{tag}: {kind} tokens differ")
        if not torch.equal(got["depth"], want_depth):
            raise RuntimeError(f"{tag}: depth maps of the .ckpt differ, max "
                               f"{(got['depth'] - want_depth).abs().max()}")
        if not torch.equal(got["knobs"], want_knobs):
            raise RuntimeError(f"{tag}: depth maps of the .ckpt at 224x224, "
                               f"tanh, lowres differ, max "
                               f"{(got['knobs'] - want_knobs).abs().max()}")
        log(tag, f"depth maps from the Omnidata .ckpt: bit-identical to the "
            f"writer's DPT ({tuple(want_depth.shape)}), and at --dpt-size "
            f"224 --gelu tanh --dpt-head lowres to the writer's weights at "
            f"those knobs; launches {launches} (K5 {DPT_BLOCKS} for each "
            f"map set + {DPT_BLOCKS} for depth-soft, K2 base-soft + "
            f"depth-soft, K3 nic); plain calls 0")
        for name, s in secs.items():
            log(tag, f"load {name}: {s:.2f} s to weights on the card "
                f"(host clock) [{smi}]")

        # torchvision ResNet-152 for training, and utils.convert's files
        enc = params_to_jax(base_cap)[1]["encoder"]
        t0 = time.perf_counter()
        tree = cli.load_resnet_variables(tv)
        dt = time.perf_counter() - t0
        nic_tree = cli.load_resnet_variables(tv, nic=True)
        if not (_flat_equal(tree, enc) and _flat_equal(nic_tree, {
                "params": enc["params"]["backbone"],
                "batch_stats": enc["batch_stats"]["backbone"]})):
            raise RuntimeError(f"{tag}: load_resnet_variables differs from "
                               f"the backbone that wrote the file")
        log(tag, f"torchvision ResNet-152 .pth ({sizes[tv] / 1e6:.1f} MB) "
            f"through load_resnet_variables: {dt:.2f} s, bit-equal to "
            f"base-soft's encoder (and NIC's backbone tree) [{smi}]")
        sets = {k: [os.path.join(d, f) for f in files]
                for k, (d, files) in tables.items()}
        for kind, src, bridge in (
                ("resnet152", tv, lambda sd: tb.encoder_to_flax(sd)),
                ("dpt", ckpt, lambda sd: tb.dpt_to_flax(sd)),
                ("decoder", sets["base-soft"][1],
                 tb.attention_decoder_to_flax),
                ("nic-decoder", sets["nic"][1], tb.nic_decoder_to_flax),
                ("depth-cnn", sets["depth-soft"][2], tb.depth_cnn_to_flax)):
            out = os.path.join(tmp, f"{kind}.msgpack")
            t0 = time.perf_counter()
            convert.main(["--kind", kind, "--src", src, "--out", out])
            t_convert = time.perf_counter() - t0
            t0 = time.perf_counter()
            tree = load_component(out)
            t_load = time.perf_counter() - t0
            if not _flat_equal(tree, bridge(tb.load_state_dict(src))):
                raise RuntimeError(f"{tag}: utils.convert --kind {kind}'s "
                                   f"file reads back different leaves")
            log(tag, f"utils.convert --kind {kind}: {t_convert:.2f} s; "
                f"{os.path.getsize(out) / 1e6:.1f} MB msgpack read back in "
                f"{t_load:.2f} s, leaves equal to the bridge's [{smi}]")
            if kind == "dpt":
                t0 = time.perf_counter()
                est2 = DPTDepthEstimator(device=dev)
                est2.load_weights(out)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                with torch.inference_mode():
                    maps = est2.depth_fn()(x).cpu()
                if not torch.equal(maps, want_depth):
                    raise RuntimeError(f"{tag}: the DPT msgpack's depth "
                                       f"maps differ")
                log(tag, f"DPT from the converted msgpack: {dt:.2f} s to "
                    f"the card, depth maps bit-identical")
                del est2
        del got
        torch.cuda.empty_cache()
        return {tag: launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


RESUME_IMAGES, RESUME_VAL = 240, 30   # 8 steps an epoch at B=30
RESUME_PREEMPT = 3                    # the event's step in epoch 1
RESUME_RTOL = 1e-5


def _csv_rows(save_dir):
    rows = {}
    for split in ("train", "val"):
        path = f"{save_dir}/base_soft_{split}_loss_coco0.csv"
        with open(path) as f:
            rows[split] = [line.split(", ") for line in f.read().splitlines()]
    return rows


def _rows_rel(got, want):
    """Largest relative difference of two runs' CSV losses; raises when
    the epochs differ."""
    worst = 0.0
    for split in want:
        if [r[0] for r in got[split]] != [r[0] for r in want[split]]:
            raise RuntimeError(f"CSV epochs {got[split]} vs {want[split]}")
        for (_, g), (_, w) in zip(got[split], want[split]):
            worst = max(worst, abs(float(g) - float(w)) / abs(float(w)))
    return worst


def _state_diff(got, want):
    """(largest difference of the trainable modules' tensors relative to
    each tensor's max |w|, whether the AdamW states are bit-equal) of two
    train checkpoints. AdamW's moments of gradients that are rounding
    noise (zero by symmetry) are not compared relatively."""
    import torch
    worst = 0.0
    for name, sd in want["modules"].items():
        for k, w in sd.items():
            g = got["modules"][name][k]
            if w.is_floating_point():
                scale = max(w.abs().max().item(), 1e-30)
                worst = max(worst, (g - w).abs().max().item() / scale)
    same_opt = all(
        torch.equal(got["optimizer"]["state"][i][k], v)
        for i, s in want["optimizer"]["state"].items() for k, v in s.items())
    return worst, same_opt


def write_resume_data(root):
    """A synthetic COCO of 224x224 JPEGs under ``root/dataset/coco2014``
    (``RESUME_IMAGES`` train, ``RESUME_VAL`` val) with phase 20's
    vocabulary."""
    import os
    import pickle
    from depth_image_captioning_pub_torch.data.synthetic import (
        make_synthetic_coco)
    base = os.path.join(root, "dataset", "coco2014")
    make_synthetic_coco(base, RESUME_IMAGES, (224, 224), seed=31)
    make_synthetic_coco(base, RESUME_VAL, (224, 224), seed=32,
                        split="val2014")
    w2i, i2w = train_vocab()
    for name, table in (("word_to_id.pkl", w2i), ("id_to_word.pkl", i2w)):
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(table, f)


def phase_resume(smi):
    """Phase 26: base-soft training at phase 20's settings, straight, with
    checkpoints, preempted and resumed in process and through a SIGTERM
    to the training CLI."""
    import os
    import shutil
    import signal
    import subprocess
    import tempfile
    import threading
    from pathlib import Path
    import torch
    from depth_image_captioning_pub_torch.engine import train as tr
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        TrainCheckpointer)
    tag = "train-resume"
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build, prefix="resume_")
    children = []
    times = {"save": [], "write": []}
    real = {"save": TrainCheckpointer.save, "write": TrainCheckpointer._write}

    def timed(name):
        def fn(self, step, state):
            t0 = time.perf_counter()
            real[name](self, step, state)
            times[name].append(time.perf_counter() - t0)
        return fn
    try:
        t0 = time.perf_counter()
        write_resume_data(os.path.join(tmp, "data"))
        log(tag, f"{RESUME_IMAGES} + {RESUME_VAL} synthetic 224x224 JPEGs "
            f"written in {time.perf_counter() - t0:.1f} s")

        def rundir(name):
            d = os.path.join(tmp, name)
            os.makedirs(d)
            os.symlink(os.path.join(tmp, "data", "dataset"),
                       os.path.join(d, "dataset"))
            return d

        def save_dir(d):
            return os.path.join(d, "exp_result", "base_soft")

        def ckpt_file(d, step):
            return os.path.join(save_dir(d), "full_state_base_soft_coco0",
                                f"state_{step}.pt")

        def run(name, **kw):
            d = rundir(name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tr.train("base-soft", 0, cfg=train_cfg(d), num_epochs=2,
                           quiet=True, device=torch.device("cuda"), **kw)
            torch.cuda.synchronize()
            out["wall"] = time.perf_counter() - t0
            return d, out

        def execute():
            # the reference run (it also warms up), then checkpointing off
            # and on in turns: off, on, on, off
            runs = {"straight": run("straight"), "off": run("off")}
            TrainCheckpointer.save = timed("save")
            TrainCheckpointer._write = timed("write")
            try:
                runs["ckpt"] = run("ckpt", checkpoint_every=1)
                runs["ckpt2"] = run("ckpt2", checkpoint_every=1)
            finally:
                TrainCheckpointer.save = real["save"]
                TrainCheckpointer._write = real["write"]
            runs["off2"] = run("off2")

            event, steps = threading.Event(), []
            real_step = tr.attention_train_step

            def step(*args, **kwargs):
                out = real_step(*args, **kwargs)
                steps.append(1)
                if len(steps) == RESUME_IMAGES // 30 + RESUME_PREEMPT:
                    event.set()
                return out
            tr.attention_train_step = step
            try:
                d, out = run("event", checkpoint_every=1,
                             preempt_event=event)
            finally:
                tr.attention_train_step = real_step
            state = torch.load(ckpt_file(d, 1), weights_only=True)
            if out.get("preempted") != 1.0 or not state["mid_epoch"] or \
                    state["batches_done"] != RESUME_PREEMPT:
                raise RuntimeError(f"{tag}: the event did not preempt at "
                                   f"batch {RESUME_PREEMPT}: {out}")
            del state
            t0 = time.perf_counter()
            out = tr.train("base-soft", 0, cfg=train_cfg(d), num_epochs=2,
                           quiet=True, device=torch.device("cuda"),
                           checkpoint_every=1, resume=True)
            out["wall"] = time.perf_counter() - t0
            runs["event"] = (d, out)
            return runs

        runs, launches = counted(tag, execute)
        if any(launches.values()):
            raise RuntimeError(f"{tag} launched kernels {launches}")

        # the training CLI, SIGTERM'd once its epoch-0 checkpoint is written
        child_dir = rundir("sigterm")
        cmd = [sys.executable, "-m", "depth_image_captioning_pub_torch."
               "training", "base", "soft", "coco", "--epochs", "2",
               "--exp-time", "1", "--checkpoint-every", "1"]
        repo = str(Path(__file__).resolve().parent)
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        child = subprocess.Popen(cmd, cwd=child_dir, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
        children.append(child)
        first = ckpt_file(child_dir, 0)
        while not os.path.exists(first) and child.poll() is None:
            if time.perf_counter() - t0 > 600:
                raise RuntimeError(f"{tag}: no epoch-0 checkpoint in 600 s")
            time.sleep(0.005)
        child.send_signal(signal.SIGTERM)
        out, err = child.communicate(timeout=600)
        t_child = time.perf_counter() - t0
        if child.returncode != 0 or "preempted: checkpoint saved" not in out:
            raise RuntimeError(f"{tag}: SIGTERM'd child exit "
                               f"{child.returncode}: {out[-2000:]} "
                               f"{err[-2000:]}")
        where = out.split("preempted: checkpoint saved at ")[1].split("\n")[0]
        t0 = time.perf_counter()
        child = subprocess.Popen(cmd + ["--resume"], cwd=child_dir, env=env,
                                 text=True, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
        children.append(child)
        out, err = child.communicate(timeout=600)
        t_resume = time.perf_counter() - t0
        if child.returncode != 0 or "resumed" not in out:
            raise RuntimeError(f"{tag}: resumed child exit "
                               f"{child.returncode}: {out[-2000:]} "
                               f"{err[-2000:]}")
        log(tag, f"training CLI (--checkpoint-every 1) SIGTERM'd after its "
            f"epoch-0 checkpoint: exit 0 in {t_child:.1f} s, saved at "
            f"{where}; --resume exit 0 in {t_resume:.1f} s (processes "
            f"included)")

        want_rows = _csv_rows(save_dir(runs["straight"][0]))
        want_state = torch.load(ckpt_file(runs["ckpt"][0], 1),
                                weights_only=True)
        for name, d in (("straight run repeated", runs["off2"][0]),
                        ("checkpointed run", runs["ckpt"][0]),
                        ("preempt_event mid-epoch + resume",
                         runs["event"][0]),
                        ("SIGTERM'd CLI + --resume", child_dir)):
            rel = _rows_rel(_csv_rows(save_dir(d)), want_rows)
            line = (f"{name}: CSV rows "
                    f"{'bit-equal' if rel == 0 else f'max rel {rel:.3e}'} "
                    f"to the straight run's")
            if os.path.exists(ckpt_file(d, 1)) and d != runs["ckpt"][0]:
                srel, same_opt = _state_diff(torch.load(
                    ckpt_file(d, 1), weights_only=True), want_state)
                line += (f"; final parameters and BN statistics "
                         f"{'bit-equal' if srel == 0 else f'max rel {srel:.3e}'}"
                         f", AdamW state "
                         f"{'bit-equal' if same_opt else 'not bit-equal'}, "
                         f"to the checkpointed run's")
            log(tag, line)
            if rel > RESUME_RTOL:
                raise RuntimeError(f"{tag}: {name} CSV rows differ by "
                                   f"{rel} (> {RESUME_RTOL})")
        ckpt_bytes = os.path.getsize(ckpt_file(runs["ckpt"][0], 1))
        log(tag, f"one checkpoint: {ckpt_bytes / 1e6:.1f} MB; the loop "
            f"blocked in save (host copy) "
            f"{', '.join(f'{t:.3f}' for t in times['save'])} s; the "
            f"writer thread's torch.save + rename "
            f"{', '.join(f'{t:.3f}' for t in times['write'])} s (host "
            f"clock) [{smi}]")
        for name in ("straight", "off", "ckpt", "ckpt2", "off2"):
            out = runs[name][1]
            last = RESUME_IMAGES / out["epoch_train_seconds"][-1]
            log(tag, f"{name} (checkpoints "
                f"{'every epoch' if name.startswith('ckpt') else 'off'}): "
                f"{last:.1f} train images/s in epoch 1 "
                f"({out['train_rows'] / out['train_seconds']:.1f} over both "
                f"epochs), train() {out['wall']:.2f} s (host clock) [{smi}]")
        return {tag: launches}
    finally:
        TrainCheckpointer.save = real["save"]
        TrainCheckpointer._write = real["write"]
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phases 27-31: the frozen-stage caches and the rest of training -------

FC_IMAGES, FC_VAL, FC_EPOCHS = 240, 30, 2   # 8 steps an epoch at B=30
FEATURE_BYTES = 196 * 2048 * 2              # a bf16 grid on disk
STEP_ITERS = 10
ACCUM_K, ACCUM_STEPS = 3, 5
BF16_STEPS, BF16_RTOL = 50, 3e-2            # the JAX test's bound
PROFILE_START, PROFILE_STOP = 2, 4
LOOSE_LOSS_RTOL = 1e-2      # cached vs online losses: a broken cache's bound


def call_counter(module):
    """[calls]: a forward pre-hook on ``module`` adds one a call."""
    n = [0]
    module.register_forward_pre_hook(lambda *a: n.__setitem__(0, n[0] + 1))
    return n


def peak_bytes(fn):
    """(fn(), the peak device bytes allocated during it)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def phase_train_feature_cache(smi, root, w2i):
    """Phase 27: base-soft at B=30 for 2 epochs of 8 steps, online and from
    the feature cache, with the cache's build timed alone first."""
    import os
    import torch
    from depth_image_captioning_pub_torch.data.pipeline import train_batches
    from depth_image_captioning_pub_torch.engine import feature_cache as fc
    from depth_image_captioning_pub_torch.engine import steps
    from depth_image_captioning_pub_torch.engine import train as tr
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    tag = "train-feature-cache"
    dev = torch.device("cuda")
    cfgs = {}
    for mode in ("online", "cached"):
        os.makedirs(os.path.join(root["dir"], mode))
        cfgs[mode] = train_cfg(os.path.join(root["dir"], mode))
    datasets = (root["fc_train"], root["fc_val"])
    save_dir = cfgs["cached"].save_dir("soft", False)
    fdir = os.path.join(save_dir, "feat_cache")
    # the build alone, on the weights train() draws from the same seed:
    # train() then finds both splits complete and only opens them
    cap = build_captioner("base-soft", VOCAB, cfgs["cached"], device=dev)
    cap.init(torch.Generator().manual_seed(cfgs["cached"].seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fc.frozen_digest(cap.encoder, torch.bfloat16, (196, 2048))
    digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    provider, _ = tr.feature_providers(cap, *datasets, fdir,
                                       cfgs["cached"].batch_size, quiet=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    files = {f.split("_")[1]: os.path.join(fdir, f)
             for f in os.listdir(fdir) if f.endswith(".bin")}
    per_image = os.path.getsize(files["train"]) / FC_IMAGES
    if sorted(files) != ["train", "val"] or per_image != FEATURE_BYTES:
        raise RuntimeError(f"{tag}: cache files {files}, {per_image} bytes "
                           f"an image, expected {FEATURE_BYTES}")
    stamps = {k: os.stat(p).st_mtime_ns for k, p in files.items()}

    def run():
        return {mode: tr.train("base-soft", 0, cfg=cfgs[mode],
                               datasets=datasets, word_to_id=w2i,
                               num_epochs=FC_EPOCHS, quiet=True, device=dev,
                               feature_cache=mode == "cached")
                for mode in ("online", "cached")}
    runs, launches = counted(tag, run)
    if any(launches.values()):
        raise RuntimeError(f"{tag} launched kernels {launches}")
    if {k: os.stat(p).st_mtime_ns for k, p in files.items()} != stamps:
        raise RuntimeError(f"{tag}: train() rebuilt a complete cache")
    losses = {m: read_losses(cfgs[m].save_dir("soft", False), "base_soft")
              for m in runs}
    flat = {m: np.array(v["train"] + v["val"]) for m, v in losses.items()}
    rel = np.abs(flat["cached"] - flat["online"]) / np.abs(flat["online"])
    equal = bool((flat["cached"] == flat["online"]).all())
    if not rel.max() <= LOOSE_LOSS_RTOL:
        raise RuntimeError(f"{tag}: cached losses {losses['cached']} vs "
                           f"online {losses['online']}")
    batch = next(train_batches(root["fc_train"], w2i, cfgs["cached"]
                               .batch_size, cfgs["cached"].max_caption_len,
                               shuffle=False, seed=0))
    # the cache's rows against the encoder on the same images, at the
    # batch size of the build and of the step
    images = torch.from_numpy(batch.images).to(dev)
    with torch.inference_mode():
        fresh = steps.frozen_features(cap, images)
    served = provider(batch.indices).to(dev)
    rows_equal = bool(torch.equal(served, fresh))
    if not rows_equal:
        diff = (served.float() - fresh.float()).abs().max().item()
        raise RuntimeError(f"{tag}: the cache's rows of images "
                           f"{batch.indices.tolist()} differ from the "
                           f"encoder's by up to {diff:.3e}")
    # the step, online and on cached features, timed in turns, each with
    # its batch's copy to the card as train() makes it (tr.device_batch:
    # the images online, the memmap's features cached)
    opt = steps.make_optimizer(cap, 1e-3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ev = Events(iters=STEP_ITERS)

    def step(cached):
        db, feats = tr.device_batch(cap, batch,
                                    feature_provider=provider if cached
                                    else None)
        return steps.attention_train_step(cap, opt, db, alpha_reg=0.7,
                                          generator=gen, features=feats)
    for mode in ("online", "cached", "online ", "cached "):
        ev.ms(mode, lambda cached=mode.startswith("cached"): step(cached))
    t = {m: min(ev.times[m], ev.times[m + " "]) for m in ("online", "cached")}
    rates = {m: FC_IMAGES / runs[m]["epoch_train_seconds"][-1] for m in runs}
    n_built = FC_IMAGES + FC_VAL
    log(tag, f"feature cache built: {n_built} images in {build_s:.2f} s = "
        f"{n_built / build_s:.1f} images/s (host clock: the weights' digest "
        f"{digest_s:.2f} s, loader, ResNet-152 bf16, copy to the host, "
        f"memmap write), {n_built / (build_s - digest_s):.1f} images/s "
        f"without the digest; {per_image:.0f} bytes an image; train() "
        f"opened it without a rebuild [{smi}]")
    log(tag, f"B={cfgs['cached'].batch_size} step (device ms, the better "
        f"of two turns of {STEP_ITERS}): online {t['online']:.2f}, cached "
        f"{t['cached']:.2f} (the batch's copy to the card included: the "
        f"uint8 images online, the memmap's features cached); last-epoch "
        f"train images/s online "
        f"{rates['online']:.1f}, cached {rates['cached']:.1f} [{smi}]")
    log(tag, f"the cache's rows of batch 0 bit-equal to the encoder's "
        f"output on its images: {rows_equal}; {FC_EPOCHS} epochs of "
        f"{FC_IMAGES} images: cached CSV losses "
        f"{'bit-equal to' if equal else 'differ from'} the online ones "
        f"(largest relative difference {rel.max():.3e}); train "
        f"{losses['cached']['train']}, val {losses['cached']['val']}; "
        f"launches {launches}")
    return launches


def phase_train_accum(smi, est, root, w2i):
    """Phase 28: depth-soft steps at B=30 with k=1 and k=ACCUM_K
    microbatches on one batch (losses, peak memory), and train() with
    ``grad_accum`` = ACCUM_K for one epoch of 2 steps."""
    import torch
    from depth_image_captioning_pub_torch.data.pipeline import train_batches
    from depth_image_captioning_pub_torch.engine import depth_cache, steps
    from depth_image_captioning_pub_torch.engine import train as tr
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    tag = "train-accum"
    dev = torch.device("cuda")
    cfg = train_cfg(root["dir"])
    online = depth_cache.online_depth_provider(est.depth_fn(), dev)
    batch = next(train_batches(root["fc_train"], w2i, cfg.batch_size,
                               cfg.max_caption_len, shuffle=False, seed=0))

    def run():
        db = steps.batch_to_device(batch, dev, online(batch.images,
                                                      batch.indices))
        res = {}
        for k in (1, ACCUM_K):
            cap = build_captioner("depth-soft", VOCAB, cfg, device=dev)
            cap.init(torch.Generator().manual_seed(3))
            opt = steps.make_optimizer(cap, cfg.lr)
            gen = torch.Generator(device="cuda").manual_seed(0)
            resident = torch.cuda.memory_allocated()
            losses, peak = peak_bytes(lambda: torch.stack([
                steps.attention_train_step(cap, opt, db, alpha_reg=0.7,
                                           generator=gen,
                                           accum_steps=k)["loss"]
                for _ in range(ACCUM_STEPS)]).cpu().numpy())
            res[k] = (losses, peak, peak - resident)
            del cap, opt
        cfg.grad_accum = ACCUM_K
        summary = tr.train("depth-soft", 0, cfg=cfg, depth_provider=online,
                           datasets=(root["short"], root["val"]),
                           word_to_id=w2i, num_epochs=1, quiet=True,
                           device=dev)
        return res, summary
    (res, summary), launches = counted(tag, run)
    b = cfg.batch_size
    chunks = 1 + -(-SHORT_IMAGES // b) + -(-TRAIN_VAL // b)
    want = dict.fromkeys(launches, 0)
    want["vit_attention"] = DPT_BLOCKS * chunks
    if launches != want:
        raise RuntimeError(f"{tag} launches {launches}, expected {want}")
    losses = read_losses(cfg.save_dir("depth_soft", False), "depth_soft")
    if not all(np.isfinite(r[0]).all() for r in res.values()):
        raise RuntimeError(f"{tag}: losses {res}")
    one, acc = res[1], res[ACCUM_K]
    log(tag, f"depth-soft B={b}, {ACCUM_STEPS} steps on one batch: k=1 "
        f"losses {np.round(one[0], 5).tolist()}, k={ACCUM_K} "
        f"{np.round(acc[0], 5).tolist()}; step-1 difference "
        f"{acc[0][0] - one[0][0]:.3e} (dropout draws and each microbatch's "
        f"BN statistics differ); peak memory k=1 {one[1] / 2**30:.3f} GiB "
        f"({one[2] / 2**30:.3f} above the resident weights), k={ACCUM_K} "
        f"{acc[1] / 2**30:.3f} GiB ({acc[2] / 2**30:.3f}) [{smi}]")
    log(tag, f"train(grad_accum={ACCUM_K}) 1 epoch of {SHORT_IMAGES}: train "
        f"loss {losses['train'][0]:.5f}, val {losses['val'][0]:.5f}, "
        f"{summary['train_rows'] / summary['train_seconds']:.1f} images/s; "
        f"launches {launches} (K5 {DPT_BLOCKS} x {chunks} DPT chunks)")
    return launches


def phase_train_bf16(smi, root, w2i, i2w):
    """Phase 29: base-soft's bf16 decoder against f32 on one batch: step ms,
    peak memory, a BF16_STEPS-step trajectory within BF16_RTOL; then
    train() with ``decoder_dtype="bfloat16"`` for one epoch and its f32
    best-val set scored."""
    import torch
    from depth_image_captioning_pub_torch.data.pipeline import train_batches
    from depth_image_captioning_pub_torch.engine import steps
    from depth_image_captioning_pub_torch.engine import train as tr
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    tag = "train-bf16"
    dev = torch.device("cuda")
    cfg = train_cfg(root["dir"])
    batch = next(train_batches(root["fc_train"], w2i, cfg.batch_size,
                               cfg.max_caption_len, shuffle=False, seed=0))
    db = steps.batch_to_device(batch, dev)
    res = {}
    feats = None
    for dtype in (torch.float32, torch.bfloat16):
        cap = build_captioner("base-soft", VOCAB, cfg, device=dev,
                              decoder_dtype=dtype)
        cap.init(torch.Generator().manual_seed(3))
        if feats is None:
            feats = steps.frozen_features(cap, db["images"])
        opt = steps.make_optimizer(cap, cfg.lr)
        gen = torch.Generator(device="cuda").manual_seed(0)
        resident = torch.cuda.memory_allocated()
        losses, peak = peak_bytes(lambda: torch.stack([
            steps.attention_train_step(cap, opt, db, alpha_reg=0.7,
                                       generator=gen, features=feats)["loss"]
            for _ in range(BF16_STEPS)]).cpu().numpy())
        ev = Events(iters=STEP_ITERS)
        ev.ms("step", lambda: steps.attention_train_step(
            cap, opt, db, alpha_reg=0.7, generator=gen, features=feats))
        res[dtype] = (losses, peak - resident, ev.times["step"])
        if not all(p.dtype == torch.float32
                   for p in cap.trainable_parameters()):
            raise RuntimeError(f"{tag}: a {dtype} decoder's parameters left "
                               f"f32")
        del cap, opt
    l32, l16 = res[torch.float32][0], res[torch.bfloat16][0]
    rel = np.abs(l16 - l32) / np.abs(l32)
    if not (np.isfinite(l16).all() and rel.max() <= BF16_RTOL
            and l16[-1] < l16[0]):
        raise RuntimeError(f"{tag}: bf16 losses {l16} vs f32 {l32}")

    def run():
        ecfg = train_cfg(root["dir"])
        ecfg.decoder_dtype = "bfloat16"
        ecfg.save_directory_soft += "_bf16"
        tr.train("base-soft", 0, cfg=ecfg,
                 datasets=(root["short"], root["val"]), word_to_id=w2i,
                 num_epochs=1, quiet=True, device=dev)
        scores, _ = read_back("base-soft", ecfg, root, w2i, i2w, None, smi,
                              tag)
        return read_losses(ecfg.save_dir("soft", False), "base_soft")
    losses, launches = counted(tag, run)
    want = dict.fromkeys(launches, 0)
    want["decode_seq"] = -(-TRAIN_VAL // 50)
    if launches != want:
        raise RuntimeError(f"{tag} launches {launches}, expected {want}")
    s32, s16 = res[torch.float32], res[torch.bfloat16]
    log(tag, f"base-soft B={cfg.batch_size} step on cached features "
        f"(device ms, {STEP_ITERS} steps): f32 decoder {s32[2]:.2f}, bf16 "
        f"{s16[2]:.2f}; peak memory above the resident weights f32 "
        f"{s32[1] / 2**30:.3f} GiB, bf16 {s16[1] / 2**30:.3f} GiB [{smi}]")
    log(tag, f"{BF16_STEPS} steps on one batch: loss f32 {l32[0]:.5f} -> "
        f"{l32[-1]:.5f}, bf16 {l16[0]:.5f} -> {l16[-1]:.5f}; largest "
        f"relative difference {rel.max():.3e} (step {int(rel.argmax())}; "
        f"bound {BF16_RTOL}) [{smi}]")
    log(tag, f"train(decoder_dtype=bfloat16) 1 epoch: train loss "
        f"{losses['train'][0]:.5f}, val {losses['val'][0]:.5f}; its f32 "
        f"best-val set scored on K2; launches {launches}")
    return launches


def phase_train_profile(smi, root):
    """Phase 30: the training CLI in a child process with ``--profile DIR
    --profile-start 2 --profile-stop 4``: the Chrome trace names the
    step's ops and CUDA kernels."""
    import json as js
    import os
    import subprocess
    from pathlib import Path
    import torch
    tag = "train-profile"
    d = os.path.join(root["dir"], "profile")
    os.makedirs(d)
    write_resume_data(d)
    prof = os.path.join(d, "prof")
    cmd = [sys.executable, "-m", "depth_image_captioning_pub_torch.training",
           "base", "soft", "coco", "--epochs", "1", "--exp-time", "1",
           "--profile", prof, "--profile-start", str(PROFILE_START),
           "--profile-stop", str(PROFILE_STOP)]
    repo = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def run():
        t0 = time.perf_counter()
        child = subprocess.run(cmd, cwd=d, env=env, text=True,
                               capture_output=True, timeout=600)
        return child, time.perf_counter() - t0
    (child, dt), launches = counted(tag, run)
    if child.returncode != 0:
        raise RuntimeError(f"{tag}: child exit {child.returncode}: "
                           f"{child.stdout[-2000:]} {child.stderr[-2000:]}")
    traces = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
    if len(traces) != 1:
        raise RuntimeError(f"{tag}: traces {traces} in {prof}")
    path = os.path.join(prof, traces[0])
    with open(path) as f:
        events = js.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ops = {n for n in names if n.startswith("aten::")}
    need = ("aten::convolution", "aten::mm", "aten::lstm_cell")
    found = [n for n in need if n in ops]
    if not kernels or "aten::convolution" not in ops or not any(
            "AdamW" in n or "Optimizer.step" in n for n in names):
        raise RuntimeError(f"{tag}: the trace lacks the step's ops: "
                           f"{len(kernels)} kernels, ops {sorted(ops)[:30]}")
    log(tag, f"training CLI child (--profile, steps [{PROFILE_START}, "
        f"{PROFILE_STOP})) exit 0 in {dt:.1f} s; {traces[0]}: "
        f"{os.path.getsize(path) / 1e6:.1f} MB, {len(events)} events, "
        f"{len(kernels)} CUDA kernels, {len(ops)} aten ops ({found} among "
        f"them, and the AdamW step); torch.profiler ran in the child only "
        f"[{smi}]")
    torch.cuda.synchronize()
    return launches


class FileImages(ScoreImages):
    """``ScoreImages`` kept in files, one ``.npy`` an image: the eval
    cache's disk store fingerprints a dataset by its files' paths, sizes
    and mtimes."""

    def __init__(self, root, n, words, seed):
        import os
        super().__init__(n, words, seed)
        self.paths = []
        for i, img in enumerate(self.images):
            self.paths.append(os.path.join(root, f"img_{i:04d}.npy"))
            np.save(self.paths[-1], img)
        self.image_size = self.images.shape[1:3]
        self.images = None

    def __len__(self):
        return len(self.paths)

    def image_path(self, i):
        return self.paths[i]

    def load_image(self, i):
        return np.load(self.paths[i])


def write_sets(kind, cap, cfg, seeds):
    """Checkpoint sets of ``kind`` in the JAX trainer's files: ``cap``'s
    frozen encoder (and depth CNN) in every set, the decoder of set i
    drawn from ``seeds[i - 1]``. Returns (save dir, file table)."""
    import torch
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.utils.checkpoint import (
        save_component)
    from depth_image_captioning_pub_torch.utils.jax_bridge import (
        params_to_jax)
    if kind == "nic":
        save_dir, files = cfg.save_directory_nic, cfg.nic_parameter_files
    else:
        save_dir, files = cli.eval_tables(cfg, "soft", False,
                                          kind == "depth-soft")
    state = {k: v.clone() for k, v in cap.decoder.state_dict().items()}
    for i, seed in enumerate(seeds, 1):
        cap.decoder.reset_parameters(torch.Generator().manual_seed(seed))
        trainable, frozen, stats = params_to_jax(cap)
        names = files[i]
        save_component(f"{save_dir}/{names[0]}", frozen["encoder"])
        save_component(f"{save_dir}/{names[1]}", trainable["decoder"])
        if kind == "nic":
            save_component(f"{save_dir}/" + names[0].replace(
                "encoder", "enc_linear"), trainable["enc_linear"])
        if kind == "depth-soft":
            save_component(f"{save_dir}/{names[2]}",
                           {"params": trainable["depth_encoder"],
                            "batch_stats": stats})
    cap.decoder.load_state_dict(state)
    return save_dir, files


class PerSet:
    """Per set of ``engine/evaluate.evaluate`` (host clock): ``prep``, the
    seconds from the checkpoint loader's return to the start of
    captioning (the frozen encoder's equality guards and the weights'
    copy to the card), ``copy`` (that copy alone), whether the frozen
    encoder was copied, ``caption`` (tokens on the host), and the K5
    launches and frozen encoder calls of the set."""

    def __init__(self, ev, enc_calls):
        self.ev, self.enc_calls, self.rows = ev, enc_calls, []

    def loader(self, fn):
        """The checkpoint loader: each call starts a set's row."""
        def load(set_idx):
            out = fn(set_idx)
            self.rows.append({"loaded": time.perf_counter()})
            return out
        return load

    def __enter__(self):
        import torch
        from depth_image_captioning_pub_torch.ops.kernels import (
            vit_attention)
        self.saved = (self.ev.params_from_jax, self.ev.generate_captions)
        copy, gen = self.saved

        def loaded(*a, **k):
            t0 = time.perf_counter()
            copy(*a, **k)
            torch.cuda.synchronize()
            self.rows[-1].update(copy=time.perf_counter() - t0,
                                 copied=k.get("load_encoder", True))

        def caption(*a, **k):
            k5, enc = vit_attention.LAUNCHES, self.enc_calls[0]
            t0 = time.perf_counter()
            row = self.rows[-1]
            row["prep"] = t0 - row.pop("loaded")
            out = gen(*a, **k)
            row.update(caption=time.perf_counter() - t0,
                       k5=vit_attention.LAUNCHES - k5,
                       encoder=self.enc_calls[0] - enc)
            return out
        self.ev.params_from_jax, self.ev.generate_captions = loaded, caption
        return self

    def __exit__(self, *exc):
        self.ev.params_from_jax, self.ev.generate_captions = self.saved


def phase_score_cached(smi, est):
    """Phase 31: three depth-soft sets over phase 13's 256 images with the
    eval cache off and on, then twice through a disk store; three NIC sets
    off and on."""
    import os
    import shutil
    import tempfile
    from pathlib import Path
    import torch
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.config import ConfigEval
    from depth_image_captioning_pub_torch.engine import evaluate as ev
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    tag = "score-cached"
    dev = torch.device("cuda")
    w2i, i2w = cli.placeholder_vocab(VOCAB)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build, prefix="score_cached_")
    try:
        os.makedirs(f"{tmp}/images")
        data = FileImages(f"{tmp}/images", SCORE_IMAGES,
                          [w for w in w2i if w.startswith("w")], seed=13)
        cfg = ConfigEval()
        cfg.batch_size, cfg.max_length = SCORE_BATCH, MAX_LEN
        cfg.save_directory_Cdep_soft = f"{tmp}/depth_soft"
        cfg.save_directory_nic = f"{tmp}/nic"
        for d in (cfg.save_directory_Cdep_soft, cfg.save_directory_nic):
            os.makedirs(d)
        depth_fn = est.depth_fn()
        out = {}
        for kind in ("depth-soft", "nic"):
            cap = build_captioner(kind, VOCAB, device=dev)
            cap.init(torch.Generator().manual_seed(7))
            save_dir, files = write_sets(kind, cap, cfg,
                                         [200 + i for i in range(3)])
            frozen = cap.backbone if kind == "nic" else cap.encoder
            calls = call_counter(frozen)
            kw = {"depth_fn": depth_fn} if kind == "depth-soft" else {}

            def loader(i, save_dir=save_dir, files=files, cap=cap):
                return cli.load_eval_components(save_dir, files[i], cap)

            def score(mode, **extra):
                rec = []
                real = ev.load_textfiles

                def texts(refs, hypos):
                    rec.append(list(hypos))
                    return real(refs, hypos)
                ev.load_textfiles = texts
                try:
                    with PerSet(ev, calls) as per:
                        t0 = time.perf_counter()
                        scores = ev.evaluate(kind, "coco", cap,
                                             per.loader(loader), data,
                                             w2i, i2w, cfg, num_sets=3,
                                             quiet=True, **kw, **extra)
                        total = time.perf_counter() - t0
                finally:
                    ev.load_textfiles = real
                return {"scores": scores, "hypos": rec, "sets": per.rows,
                        "total": total, "mode": mode}

            modes = [("off", {"depth_eval_cache": False}), ("on", {})]
            if kind == "depth-soft":
                store = f"{tmp}/store"
                modes += [("disk fill", {"eval_cache_dir": store}),
                          ("disk replay", {"eval_cache_dir": store})]
            runs, launches = counted(tag, lambda: [score(m, **extra)
                                                   for m, extra in modes])
            out[kind] = launches
            base = runs[0]
            for r in runs[1:]:
                if r["hypos"] != base["hypos"] or r["scores"] != base[
                        "scores"]:
                    raise RuntimeError(f"{tag} {kind}: cache {r['mode']} "
                                       f"differs from cache off")
            if base["hypos"][0] == base["hypos"][1]:
                raise RuntimeError(f"{tag} {kind}: sets 1 and 2 agree")
            chunks = -(-SCORE_IMAGES // SCORE_BATCH)
            k5 = DPT_BLOCKS * chunks if kind == "depth-soft" else 0
            want = {"off": ([k5] * 3, [chunks] * 3),
                    "on": ([k5, 0, 0], [chunks, 0, 0]),
                    "disk fill": ([k5, 0, 0], [chunks, 0, 0]),
                    "disk replay": ([0, 0, 0], [0, 0, 0])}
            for r in runs:
                got = ([s["k5"] for s in r["sets"]],
                       [s["encoder"] for s in r["sets"]])
                if got != want[r["mode"]]:
                    raise RuntimeError(f"{tag} {kind} cache {r['mode']}: "
                                       f"(K5, encoder) per set {got}, "
                                       f"expected {want[r['mode']]}")
            decode = "decode_seq" if kind == "depth-soft" else "nic_seq"
            if launches[decode] != chunks * 3 * len(runs):
                raise RuntimeError(f"{tag} {kind}: launches {launches}")
            for r in runs:
                log(tag, f"{kind} cache {r['mode']}: " + "; ".join(
                    f"set {i}: caption {s['caption']:.3f} s, set-up "
                    f"{s['prep']:.3f} s (guards and copy; the copy "
                    f"{s['copy']:.3f} s, encoder "
                    f"{'copied' if s['copied'] else 'kept'}), K5 "
                    f"{s['k5']}, encoder chunks {s['encoder']}"
                    for i, s in enumerate(r["sets"], 1))
                    + f"; {r['total']:.2f} s for 3 sets [{smi}]")
            # the set-up each later set had before the guard: every tree
            # copied to the card, the frozen encoder included
            trees = loader(2)
            t0 = time.perf_counter()
            ev.params_from_jax(cap, trees[1], {"encoder": trees[0]},
                               trees[2])
            torch.cuda.synchronize()
            full = time.perf_counter() - t0
            later = [s["prep"] for r in runs for s in r["sets"][1:]]
            log(tag, f"{kind}: a later set's set-up with the whole copy "
                f"(the encoder included, as before the guard) "
                f"{full:.3f} s; with the guard (equal trees: the encoder "
                f"kept) {min(later):.3f}-{max(later):.3f} s over sets 2-3 "
                f"of every mode; hypotheses and 7 scores == across "
                f"{[r['mode'] for r in runs]}; launches {launches}")
            del cap
            torch.cuda.empty_cache()
        entries = os.listdir(f"{tmp}/store")
        mb = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                 os.walk(f"{tmp}/store") for f in fs) / 1e6
        log(tag, f"disk store: {entries} ({mb:.1f} MB: features and depth "
            f"maps of {SCORE_IMAGES} images)")
        return {k: sum(v[k] for v in out.values())
                for k in out["depth-soft"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_caches_and_training(smi, est):
    """Phases 27-31 (``PATHS``' last five)."""
    import shutil
    import tempfile
    from pathlib import Path
    from depth_image_captioning_pub_torch.data.synthetic import (
        SyntheticCaptions)
    w2i, i2w = train_vocab()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build, prefix="caches_")
    data = SyntheticCaptions(FC_IMAGES + FC_VAL, seed=41)
    root = {"dir": tmp, "fc_train": _Rows(data, range(FC_IMAGES)),
            "fc_val": _Rows(data, range(FC_IMAGES, FC_IMAGES + FC_VAL)),
            "short": _Rows(data, range(SHORT_IMAGES)),
            "val": _Rows(data, range(FC_IMAGES, FC_IMAGES + TRAIN_VAL))}
    try:
        return {"train-feature-cache": phase_train_feature_cache(smi, root,
                                                                  w2i),
                "train-accum": phase_train_accum(smi, est, root, w2i),
                "train-bf16": phase_train_bf16(smi, root, w2i, i2w),
                "train-profile": phase_train_profile(smi, root),
                "score-cached": phase_score_cached(smi, est)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class _Rows:
    """Rows ``rows`` of an in-memory captions set, as a dataset."""

    def __init__(self, data, rows):
        self.data, self.rows = data, list(rows)

    def __len__(self):
        return len(self.rows)

    def load_image(self, i):
        return self.data.load_image(self.rows[i])

    def captions(self, i):
        return self.data.captions(self.rows[i])


SAMPLE_PIC = "dog"         # phase 32's sample_pic set (one JPEG)
EXPORT_IMAGES = 16         # phase 33's request: one chunk of bucket 16
EXPORT_REPEATS = 3         # timed requests of each pipeline


def sample_run(argv, n_images, times, tokens):
    """``evaluation.main(argv)`` in the working directory, with the counts
    set to 0 just before and read just after, every plain version counted,
    and the caption (encoder + decode) and overlay seconds of the run added
    to ``times``; each image's (array, tokens) appended to ``tokens``.
    Returns the counts."""
    import torch
    from depth_image_captioning_pub_torch import evaluation
    from depth_image_captioning_pub_torch.engine import visualize
    orig_dir, orig_render = (visualize.sample_directory,
                             visualize.render_attention_overlays)

    def render(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig_render(*args, **kwargs)
        times["render"] += time.perf_counter() - t0
        return out

    def directory(sample_dir, out_dir, caption_one, id_to_word, **kwargs):
        def timed(arr):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, alphas = caption_one(arr)        # numpy: synchronized
            times["decode"] += time.perf_counter() - t0
            if not (np.isfinite(alphas).all()
                    and np.abs(alphas.sum(-1) - 1).max() < 1e-4):
                raise RuntimeError("sample mode's alphas are not softmax "
                                   "rows")
            tokens.append((arr, toks))
            return toks, alphas
        return orig_dir(sample_dir, out_dir, timed, id_to_word, **kwargs)

    visualize.sample_directory = directory
    visualize.render_attention_overlays = render
    torch.cuda.synchronize()
    reset_counts()
    try:
        with PlainCalls() as plain:
            rc = evaluation.main(argv)
        counts = read_counts()
    finally:
        visualize.sample_directory = orig_dir
        visualize.render_attention_overlays = orig_render
    if rc != 0 or plain.calls:
        raise RuntimeError(f"evaluation {' '.join(argv)}: exit {rc}, plain "
                           f"versions {sorted(set(plain.calls))}")
    want = dict.fromkeys(counts, 0)
    want["decode_step"] = n_images * MAX_LEN
    if argv[0] == "depth":
        want["vit_attention"] = n_images * DPT_BLOCKS
    if counts != want:
        raise RuntimeError(f"evaluation {' '.join(argv)}: launches {counts}, "
                           f"expected {want} for {n_images} images")
    return counts


def check_overlays(out_dir, n_images):
    """The JAX module's layout: one ``caption.txt`` line per image, and per
    image ``input.png`` and one readable ``NN_<word>.png`` per word."""
    from PIL import Image
    lines = (out_dir / "caption.txt").read_text().splitlines()
    if len(lines) != n_images:
        raise RuntimeError(f"{out_dir}/caption.txt has {len(lines)} lines "
                           f"for {n_images} images")
    pngs = 0
    for line in lines:
        name, caption = line.split(": ", 1)
        stem = out_dir / name.rsplit(".", 1)[0]
        want = sorted(["input.png"] + [f"{t:02d}_{w}.png" for t, w in
                                       enumerate(caption.split())])
        if sorted(p.name for p in stem.iterdir()) != want:
            raise RuntimeError(f"{stem}: {sorted(stem.iterdir())}, expected "
                               f"{want}")
        for name in want:
            with Image.open(stem / name) as im:
                im.load()
            pngs += 1
    return lines, pngs


def phase_sample_mode(smi, base_cap):
    """32. Sample mode: ``evaluation base soft sample`` and ``evaluation
    depth soft sample`` over a copy of one ``sample_pic`` set in a working
    directory under ``build/`` (its ``sample_dirs`` point there; nothing is
    written into the repository), on checkpoint files of phase 5's
    base-soft weights and of a seeded depth-soft captioner (the DPT-hybrid
    at 384, drawn at random: no weights in the repository). Each run's K1
    launches equal images x 30 (K5 12 an image for depth), no plain version;
    one overlay per word, every PNG readable, one caption line per image;
    base-soft's greedy tokens against ``CaptionPipeline``'s K2 on the same
    resized array (>= 0.99 of the tokens up to K2's first <end>); a
    ``--stochastic`` rerun with one seed repeats its captions. Prints each
    run's seconds per image, caption (encoder + K1 loop) and overlays."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.data.tokenizer import SPECIAL
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    import scipy
    log("sample", f"scipy {scipy.__version__} (expand_alpha's zoom and "
        f"Gaussian)")
    t_phase = time.perf_counter()
    w2i, i2w = placeholder_vocab(VOCAB)
    here = Path(__file__).resolve().parent
    (here / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=here / "build", prefix="sample_"))
    cwd = os.getcwd()
    launches = dict.fromkeys(kernel_modules(), 0)
    try:
        shutil.copytree(here / "sample_pic" / SAMPLE_PIC,
                        root / "sample_pic" / SAMPLE_PIC)
        n_images = len([p for p in (root / "sample_pic" / SAMPLE_PIC)
                        .iterdir() if p.suffix in (".jpg", ".png")])
        cfg = write_experiment(root, "base-soft", base_cap, w2i)[0]
        depth_cap = build_captioner("depth-soft", VOCAB, device="cuda")
        depth_cap.init(torch.Generator().manual_seed(32))
        write_experiment(root, "depth-soft", depth_cap, w2i)
        del depth_cap
        os.chdir(root)
        greedy = {}
        for base in ("base", "depth"):
            times = {"decode": 0.0, "render": 0.0}
            tokens = []
            counts = sample_run([base, "soft", "sample", SAMPLE_PIC, "coco"],
                                n_images, times, tokens)
            launches = {k: launches[k] + v for k, v in counts.items()}
            out_dir = root / "sample_pic" / SAMPLE_PIC / f"{base}_soft"
            lines, pngs = check_overlays(out_dir, n_images)
            greedy[base] = tokens
            log("sample", f"{base}-soft greedy: {n_images} image(s), "
                f"{pngs} PNGs; per image caption {times['decode']:.3f} s "
                f"(encoder{' + DPT' if base == 'depth' else ''} + K1 x"
                f"{MAX_LEN}), overlays {times['render']:.3f} s; launches "
                f"{counts}; {lines[0]!r} [{smi}]")
        # the greedy tokens against K2 on the same resized array
        pipe = CaptionPipeline.from_experiment("base-soft", cfg=cfg,
                                               device="cuda",
                                               batch_buckets=(1,))
        end = w2i[SPECIAL.end]
        agree, n = 0, 0
        for arr, toks in greedy["base"]:
            u8 = np.rint(arr * 255.0).astype(np.uint8)
            k2 = pipe.caption_tokens(u8[None])[0]
            stop = int(np.argmax(k2 == end)) + 1 if (k2 == end).any() \
                else MAX_LEN
            agree += int((toks[:stop] == k2[:stop]).sum())
            n += stop
        del pipe
        if agree / n < MIN_AGREEMENT:
            raise RuntimeError(f"sample mode's greedy tokens agree with K2 "
                               f"on {agree}/{n} < {MIN_AGREEMENT}")
        log("sample", f"greedy (K1 loop) vs CaptionPipeline's K2 on the "
            f"same arrays: {agree}/{n} tokens up to K2's first <end>")
        captions = []
        for _ in range(2):
            # a run adds its files to what the directory holds
            shutil.rmtree(root / "sample_pic" / SAMPLE_PIC / "base_soft")
            times = {"decode": 0.0, "render": 0.0}
            counts = sample_run(["base", "soft", "sample", SAMPLE_PIC, "coco",
                                 "--stochastic", "--top-p", str(TOP_P),
                                 "--seed", "3"], n_images, times, [])
            launches = {k: launches[k] + v for k, v in counts.items()}
            captions.append(check_overlays(
                root / "sample_pic" / SAMPLE_PIC / "base_soft", n_images)[0])
            log("sample", f"base-soft --stochastic --seed 3: per image "
                f"caption {times['decode']:.3f} s, overlays "
                f"{times['render']:.3f} s [{smi}]")
        if captions[0] != captions[1]:
            raise RuntimeError(f"a --stochastic rerun with one seed changed "
                               f"its captions: {captions}")
        log("sample", f"--stochastic rerun repeats: {captions[0][0]!r}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    log("sample", f"launches {launches}; plain calls 0; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"sample": launches}


def export_timed(pipe, out_dir):
    """``export_pipeline`` with each bucket's ``torch.export.export`` timed:
    (meta, [seconds per bucket], total seconds, artifact MB)."""
    import os
    import torch
    from depth_image_captioning_pub_torch.export import export_pipeline
    orig = torch.export.export
    seconds = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        return out

    torch.export.export = timed
    t0 = time.perf_counter()
    try:
        meta = export_pipeline(pipe, str(out_dir))
    finally:
        torch.export.export = orig
    total = time.perf_counter() - t0
    mb = sum(os.path.getsize(os.path.join(out_dir, f))
             for f in os.listdir(out_dir)) / 1e6
    return meta, seconds, total, mb


def load_timed(out_dir, **kwargs):
    from depth_image_captioning_pub_torch.export import ExportedPipeline
    t0 = time.perf_counter()
    pipe = ExportedPipeline.load(str(out_dir), **kwargs)
    return pipe, time.perf_counter() - t0


def token_agreement(got, want):
    return float((np.asarray(got) == np.asarray(want)).mean())


def request_ms(pipe, images):
    """Host ms of each of ``EXPORT_REPEATS`` requests (tokens on the
    host), after one warm-up."""
    import torch
    pipe.caption_tokens(images)
    out = []
    for _ in range(EXPORT_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.caption_tokens(images)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def dispatch_case(base_cap):
    """name -> (operator, its CUDA implementation, arguments) at the
    sample path's shapes: B=1 bf16 features at full width (K1, K2, K4
    beam 5), NIC at B=1 (E=300, H=128, 2 layers), K5 at one image's
    Z=12, N=577, d=64 bf16."""
    import torch
    from depth_image_captioning_pub_torch.models.nic import NICDecoder
    from depth_image_captioning_pub_torch.ops.kernels import (
        beam_seq, decode_seq, decode_step, nic_seq, vit_attention)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(34)
    dec = base_cap.decoder
    with torch.inference_mode():
        feats = torch.rand((1, K, D), generator=gen, device=dev).to(
            torch.bfloat16)
        feats, proj, h, c = dec._prepare(feats, None)
        w = dec.seq_weights()
        ws = decode_seq.seq_list(w)
        nic = NICDecoder(VOCAB, dim_embedding=300, dim_hidden=128,
                         num_layers=2, device=dev)
        nic.reset_parameters(torch.Generator().manual_seed(34))
        nw = nic.seq_weights()
        x0 = torch.randn((1, 300), generator=gen, device=dev)
        q, k, v = (torch.randn((12, 577, 64), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        emb = w.embed[torch.full((1,), 2, device=dev)]
    return {
        "decode_step": (torch.ops.dcap.decode_step,
                        decode_step._decode_step_cuda,
                        (feats, proj, emb, h, c, list(w.step))),
        "greedy_decode": (torch.ops.dcap.greedy_decode,
                          decode_seq._greedy_cuda,
                          (feats, proj, h, c, ws, MAX_LEN, 2, 3)),
        "nic_greedy_decode": (torch.ops.dcap.nic_greedy_decode,
                              nic_seq._nic_cuda,
                              (x0, [*nw.layer_mats, nw.w_out, nw.b_out,
                                    nw.embed], MAX_LEN)),
        "beam_decode": (torch.ops.dcap.beam_decode, beam_seq._beam_cuda,
                        (feats, proj, h, c, ws, BEAM, MAX_LEN, 2, 3)),
        "vit_attention": (torch.ops.dcap.vit_attention,
                          vit_attention._vit_cuda, (q, k, v, 0.125, 577)),
    }


def dispatch_us(base_cap, calls=100, rounds=5):
    """Host microseconds to queue one launch through each ``dcap::``
    operator and through its CUDA implementation called directly (the
    dispatcher's cost is the difference), the least of ``rounds`` rounds
    of ``calls`` calls each, taken in turns; the outputs of the two must
    be equal."""
    import torch
    out = {}
    with torch.inference_mode():
        for name, (op, direct, args) in dispatch_case(base_cap).items():
            a, b = op(*args), direct(*args)
            for x, y in zip(a if isinstance(a, tuple) else [a],
                            b if isinstance(b, tuple) else [b]):
                if not torch.equal(x, y):
                    raise RuntimeError(f"dcap::{name} differs from its CUDA "
                                       f"implementation called directly")
            best = {"op": float("inf"), "direct": float("inf")}
            for _ in range(rounds):
                for key, fn in (("op", op), ("direct", direct)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn(*args)
                    best[key] = min(best[key], (time.perf_counter() - t0)
                                    / calls * 1e6)
                    torch.cuda.synchronize()
            out[name] = best
    return out


def phase_export(smi, base_cap, est):
    """33. The AOT export on the card (``export.py``): phase 5's base-soft
    weights exported at buckets 1 and 16, and with nucleus sampling
    (``top_p`` 0.9, seed 0) at 16; depth-soft (a seeded captioner, phase
    7's DPT at ``--dpt-size 224``) at 16; each loaded and run on 16 seeded
    images (one chunk; the 1-bucket artifact also on one image). Each
    loaded program launches K2 once a chunk (K1 x30 sampling, K5 12 +
    K2 1 depth) through the ``dcap::`` operators, no plain version; its
    tokens against the live pipeline's (equal, or >= 0.99 with the
    difference put down to the flags: a program runs under ``full_f32``,
    the live bf16 products under ``matmul_f32``'s TF32); then a tiny
    base-soft artifact exported on the CPU, loaded on the card
    (``move_to_device_pass``), against a CUDA export of the same weights
    (equal tokens). Prints each export's seconds per bucket, load seconds
    and MB, the 16-image request's ms exported and live, and each
    operator's host microseconds to queue a launch against a direct call
    of its CUDA implementation."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    from depth_image_captioning_pub_torch.cli import placeholder_vocab
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.models.dpt import (
        DPTDepthEstimator)
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    t_phase = time.perf_counter()
    w2i, i2w = placeholder_vocab(VOCAB)
    images = np.random.default_rng(33).integers(
        0, 256, (EXPORT_IMAGES, 224, 224, 3), dtype=np.uint8)
    here = Path(__file__).resolve().parent
    (here / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=here / "build", prefix="export_"))
    launches = dict.fromkeys(kernel_modules(), 0)

    def loaded_run(pipe, requests, tag, want):
        outputs, counts = run_requests(pipe, requests, smi, tag)
        nonlocal launches
        launches = {k: launches[k] + v for k, v in counts.items()}
        if counts != dict(dict.fromkeys(counts, 0), **want):
            raise RuntimeError(f"export {tag}: launches {counts}, expected "
                               f"{want}")
        return outputs

    def report(tag, live, loaded, seconds, total, mb, load_s, got, want):
        agree = token_agreement(got, want)
        if agree < MIN_AGREEMENT:
            raise RuntimeError(f"export {tag}: exported tokens agree with "
                               f"the live pipeline's on {agree:.4f}")
        note = ("equal" if agree == 1.0 else
                f"agreement {agree:.4f} (the program runs under full_f32, "
                f"the live bf16 products under matmul_f32's TF32)")
        ms_exp, ms_live = request_ms(loaded, images), request_ms(live, images)
        log("export", f"{tag}: export {total:.1f} s (per bucket "
            f"{', '.join(f'{s:.1f}' for s in seconds)} s), {mb:.1f} MB, load "
            f"{load_s:.2f} s; tokens vs live {note}; {EXPORT_IMAGES}-image "
            f"request exported {', '.join(f'{m:.1f}' for m in ms_exp)} ms, "
            f"live {', '.join(f'{m:.1f}' for m in ms_live)} ms [{smi}]")

    try:
        # greedy base-soft at buckets 1 and 16
        live = CaptionPipeline(base_cap, w2i, i2w, max_length=MAX_LEN,
                               batch_buckets=(1, EXPORT_IMAGES))
        want = live.caption_tokens(images)
        meta, seconds, total, mb = export_timed(live, root / "greedy")
        loaded, load_s = load_timed(root / "greedy")
        got, one = loaded_run(loaded, [images, images[:1]], "greedy",
                              {"decode_seq": 2})
        if token_agreement(one, live.caption_tokens(images[:1])) < \
                MIN_AGREEMENT:
            raise RuntimeError("export greedy: the 1-image bucket differs")
        report(f"base-soft greedy b1,{EXPORT_IMAGES}",
               live, loaded, seconds, total, mb, load_s, got, want)
        del loaded

        # nucleus sampling at bucket 16: both generators fresh at seed 0
        live = CaptionPipeline(base_cap, w2i, i2w, max_length=MAX_LEN,
                               batch_buckets=(EXPORT_IMAGES,), sample=True,
                               top_p=TOP_P, seed=0)
        meta, seconds, total, mb = export_timed(live, root / "sample")
        loaded, load_s = load_timed(root / "sample", seed=0)
        want = live.caption_tokens(images)
        got, = loaded_run(loaded, [images], "sample",
                          {"decode_step": MAX_LEN})
        report(f"base-soft sample b{EXPORT_IMAGES}",
               live, loaded, seconds, total, mb, load_s, got, want)
        del loaded

        # depth-soft with the DPT at 224 inside the program
        est224 = DPTDepthEstimator(image_size=224, device="cuda")
        est224.model = est.model
        depth_cap = build_captioner("depth-soft", VOCAB, device="cuda")
        depth_cap.init(torch.Generator().manual_seed(33))
        live = CaptionPipeline(depth_cap, w2i, i2w, max_length=MAX_LEN,
                               batch_buckets=(EXPORT_IMAGES,),
                               depth_fn=est224.depth_fn())
        want = live.caption_tokens(images)
        meta, seconds, total, mb = export_timed(live, root / "depth")
        loaded, load_s = load_timed(root / "depth")
        got, = loaded_run(loaded, [images], "depth224",
                          {"vit_attention": DPT_BLOCKS, "decode_seq": 1})
        report(f"depth-soft (DPT 224) b{EXPORT_IMAGES}",
               live, loaded, seconds, total, mb, load_s, got, want)
        del loaded, live, depth_cap

        # a tiny artifact exported on the CPU, moved to the card
        tiny = build_captioner("base-soft", VOCAB, resnet_layers=(1, 1, 1, 1),
                               device="cpu")
        tiny.init(torch.Generator().manual_seed(35))
        cpu_pipe = CaptionPipeline(tiny, w2i, i2w, max_length=MAX_LEN,
                                   batch_buckets=(4,))
        export_timed(cpu_pipe, root / "tiny_cpu")
        tiny_cuda = build_captioner("base-soft", VOCAB,
                                    resnet_layers=(1, 1, 1, 1), device="cuda")
        tiny_cuda.load_state_dict(tiny.state_dict())
        export_timed(CaptionPipeline(tiny_cuda, w2i, i2w, max_length=MAX_LEN,
                                     batch_buckets=(4,)), root / "tiny_cuda")
        moved, load_s = load_timed(root / "tiny_cpu", device="cuda")
        native, _ = load_timed(root / "tiny_cuda")
        a, = loaded_run(moved, [images[:4]], "tiny-moved", {"decode_seq": 1})
        b = native.caption_tokens(images[:4])
        if not np.array_equal(a, b):
            raise RuntimeError(f"a CPU export moved to the card differs from "
                               f"a CUDA export: {token_agreement(a, b):.4f}")
        log("export", f"tiny base-soft exported on the CPU, loaded on the "
            f"card in {load_s:.2f} s: tokens equal to a CUDA export's")
        del moved, native, tiny, tiny_cuda
    finally:
        shutil.rmtree(root, ignore_errors=True)

    for name, us in dispatch_us(base_cap).items():
        log("export", f"dcap::{name}: {us['op']:.1f} us to queue a launch "
            f"through the operator, {us['direct']:.1f} us calling its CUDA "
            f"implementation directly ({us['op'] - us['direct']:+.1f} us) "
            f"[{smi}]")
    log("export", f"launches {launches}; plain calls 0; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"export": launches}


# ---- phases 34-36: data parallelism ---------------------------------------

DDP_TRAIN, DDP_VAL, DDP_EPOCHS = 60, 30, 2  # B=30: 2 steps an epoch, 4 in all
DDP_SCORE, DDP_SCORE_BATCH, DDP_SETS = 128, 64, 2
DDP_LOSS_ATOL, DDP_BN_ATOL = 1e-5, 1e-6      # the CPU tests' bounds
DDP_BN_LATER = 5e-2      # of each statistic's largest value, after step 1
# steps 2-4 of the f32 run: AdamW moves the elements whose gradient
# rounding decides by up to lr either way, and at full width they move the
# loss by more than the CPU tests' tiny model does (phase 20's bound)
DDP_LATER_LOSS_RTOL = CARD_CPU_LOSS_RTOL
# the step rule of tests/test_torch_parallel_train.py: 2 * lr where an
# element's gradient was below DDP_SMALL_GRAD (or, at step 1, the two runs'
# gradients differ in sign), else DDP_PARAM_ATOL; at the end the tensors
# that the depth CNN's rounding spreads to on the CPU (DDP_SPREAD) within
# 2 * lr a step. At full width it spreads to every other decoder tensor
# but out_b as well (f32 run, over the rule at the end: f_beta_w 2.53e-4,
# out_w 1.09e-4, f_beta_b 7.26e-5, lstm_w_hh 6.54e-5, att_w_full 3.97e-5,
# init_b 3.12e-6, embed 2.9e-6, lstm_b_ih and lstm_b_hh 1.43e-6): those
# are held within the rule plus DDP_WIDTH_ATOL, 4x the largest of these.
DDP_SMALL_GRAD, DDP_PARAM_ATOL, DDP_LR = 1e-6, 1e-5, 1e-3
DDP_SPREAD = ("depth_module.", "decoder.att_w_enc", "decoder.att_b_enc",
              "decoder.att_w_dec", "decoder.att_b_dec", "decoder.lstm_w_ih",
              "decoder.init_w")
DDP_WIDTH_ATOL = 1e-3
# the bf16 run (online DPT depth), held between its sound readings and two
# planted faults (each rank's gradient left unsummed; the depth CNN's
# BatchNorm statistics left local), which must each break a limit.
# Readings (sound / gradients unsummed / BN local): step-1 loss 1.34e-5 /
# 1.34e-5 / 9.63e-5; any step's loss 8.5e-3 / 0.10 / 8.35e-3; BN after
# step 1 9.81e-4 / 9.81e-4 / 3.45e-3; step-1 gradients 0.071 / 0.869 /
# 0.079 of |g|. Each limit lies near the geometric mean of the sound
# reading and the fault's that it separates.
DDP_BF16_LOSS1 = 4e-5    # step 1's loss
DDP_BF16_LOSS = 3e-3     # any step's loss, of the largest loss
DDP_BF16_BN1 = 2e-3      # the BN statistics after step 1
DDP_BF16_GRAD1 = 0.25    # |g2 - g1| / |g1| over the step-1 gradients
DDP_FAULTS = ("grads", "bn")
DDP_REQUESTS = (16, 64, 7)                   # serve-devices' request sizes
DDP_TIMEOUT = 600        # seconds for the two gloo ranks
RANK_TIMEOUT_S = 120     # a gloo rank's collective waits this for a peer


def ddp_train(root, est, caches=None):
    """depth-soft at full width (``ConfigTrain``'s B=30, 32 tokens, lr
    1e-3, dropout 0.5) for ``DDP_EPOCHS`` epochs of ``DDP_TRAIN`` in-memory
    images, train and validation depth from the DPT per batch, in this
    process's group (or none): per step the global loss and the step's
    device ms (CUDA events around it), the BN running statistics after
    step 1, and the trainable state at the end (on the host).
    ``caches``: (train, val) depth-map cache files read instead of the
    DPT, and f32 encoders (ResNet-152 and the depth CNN): the variant
    whose every stage rounds alike at 15 rows a rank and at 30."""
    import functools
    import os
    import torch
    from depth_image_captioning_pub_torch.engine import depth_cache
    from depth_image_captioning_pub_torch.engine import train as tr
    os.makedirs(root, exist_ok=True)
    cfg = train_cfg(root)
    w2i, _ = train_vocab()
    dev = torch.device("cuda")
    providers = (depth_cache.online_depth_provider(est.depth_fn(), dev),) * 2
    if caches is not None:
        providers = tuple(
            depth_cache.cached_depth_provider(depth_cache.DepthMapCache(
                path, n)) for path, n in zip(caches, (DDP_TRAIN, DDP_VAL)))
    rec = {"losses": [], "ms": [], "bn": None, "small": None}
    real, build = tr.attention_train_step, tr.build_captioner

    def state(cap):
        return {f"{name}.{k}": v.detach().cpu().clone()
                for name, m in tr.trainable_modules(cap).items()
                for k, v in m.state_dict().items()}

    def step(cap, opt, batch, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(cap, opt, batch, **kw)
        stop.record()
        rec["losses"].append(float(out["loss"]))
        stop.synchronize()
        rec["ms"].append(start.elapsed_time(stop))
        params = cap.trainable_parameters()
        if rec["bn"] is None:
            rec["bn"] = {k: v.detach().cpu().clone()
                         for k, v in cap.named_buffers() if "running" in k}
            rec["grad1"] = [p.grad.detach().float().cpu() for p in params]
            rec["state1"] = state(cap)
            rec["small"] = [torch.zeros_like(p, dtype=torch.uint8)
                            for p in params]
        for c, p in zip(rec["small"], params):
            c += p.grad.abs() < DDP_SMALL_GRAD
        rec["cap"] = cap
        return out
    tr.attention_train_step = step
    if caches is not None:
        tr.build_captioner = functools.partial(build,
                                               encoder_dtype=torch.float32)
    try:
        rec["summary"] = tr.train(
            "depth-soft", 0, cfg=cfg, depth_provider=providers[0],
            val_depth_provider=providers[1], datasets=ddp_sets(),
            word_to_id=w2i, num_epochs=DDP_EPOCHS, quiet=True, device=dev)
    finally:
        tr.attention_train_step, tr.build_captioner = real, build
    cap = rec.pop("cap")
    rec["state"] = state(cap)
    rec["small"] = [c.cpu() for c in rec["small"]]
    return rec


class DdpFault:
    """A planted fault of a gloo rank's training (a control for the bf16
    bound): ``"grads"`` leaves each rank's gradient unsummed (the step's
    metrics still summed), ``"bn"`` leaves the depth CNN's BatchNorm
    statistics local to the rank's rows."""

    def __init__(self, kind):
        self.kind = kind

    def __enter__(self):
        from depth_image_captioning_pub_torch.engine import steps
        from depth_image_captioning_pub_torch.models import depth_encoders
        from depth_image_captioning_pub_torch.parallel.mesh import Mesh
        if self.kind == "grads":
            real = steps.all_reduce_grads
            self.saved = steps, "all_reduce_grads", real
            steps.all_reduce_grads = lambda params, extra=None: real(
                [], extra)
        else:
            self.saved = (depth_encoders, "make_mesh",
                          depth_encoders.make_mesh)
            depth_encoders.make_mesh = lambda *a, **k: Mesh(0, 1)
        return self

    def __exit__(self, *exc):
        setattr(*self.saved)


def ddp_sets():
    """(train, val) of train-ddp: in-memory synthetic 224x224 images."""
    from depth_image_captioning_pub_torch.data.synthetic import (
        SyntheticCaptions)
    data = SyntheticCaptions(DDP_TRAIN + DDP_VAL, seed=31)
    return (_Rows(data, range(DDP_TRAIN)),
            _Rows(data, range(DDP_TRAIN, DDP_TRAIN + DDP_VAL)))


def ddp_caches(root):
    return (f"{root}/depth_train.npy", f"{root}/depth_val.npy")


def ddp_score_cfg(root):
    from depth_image_captioning_pub_torch.config import ConfigEval
    cfg = ConfigEval()
    cfg.batch_size, cfg.max_length = DDP_SCORE_BATCH, MAX_LEN
    cfg.save_directory_Cdep_soft = f"{root}/depth_soft"
    return cfg


def ddp_score(root, est, batch):
    """``evaluate`` of the ``DDP_SETS`` depth-soft sets under ``root`` over
    ``DDP_SCORE`` seeded images at ``batch`` (the eval cache on: set 1 runs
    the DPT, set 2 replays its maps): (scores, each set's hypotheses on
    rank 0)."""
    import torch
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.engine import evaluate as ev
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    w2i, i2w = cli.placeholder_vocab(VOCAB)
    cfg = ddp_score_cfg(root)
    cfg.batch_size = batch
    save_dir, files = cli.eval_tables(cfg, "soft", False, True)
    data = ScoreImages(DDP_SCORE, [w for w in w2i if w.startswith("w")],
                       seed=34)
    cap = build_captioner("depth-soft", VOCAB, device=torch.device("cuda"))
    hypos, real = [], ev.load_textfiles

    def recorder(refs, hyps):
        hypos.append(list(hyps))
        return real(refs, hyps)
    ev.load_textfiles = recorder
    try:
        scores = ev.evaluate(
            "depth-soft", "coco", cap,
            lambda i: cli.load_eval_components(save_dir, files[i], cap),
            data, w2i, i2w, cfg, depth_fn=est.depth_fn(),
            num_sets=DDP_SETS, quiet=True)
    finally:
        ev.load_textfiles = real
    return scores, hypos


def ddp_dpt():
    """Phase 7's DPT-hybrid (bf16 at 384x384, drawn from seed 1)."""
    import torch
    from depth_image_captioning_pub_torch.models.dpt import (
        DPTDepthEstimator)
    est = DPTDepthEstimator(device=torch.device("cuda"))
    est.init(torch.Generator().manual_seed(1))
    return est


def ddp_child(rank, world, store, root, out):
    """One gloo rank on ``cuda:0`` (``chip_smoke.py --ddp-rank``): the
    train-ddp runs, score-ddp, then the bf16 run under each planted fault
    (``DdpFault``), each with the launch counters set to 0 just before and
    read just after; results to ``out``."""
    import functools
    import torch
    from depth_image_captioning_pub_torch.ops.kernels import _build
    from depth_image_captioning_pub_torch.parallel import multihost
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    multihost.initialize(f"file://{store}", world, rank, backend="gloo",
                         device="cuda:0",
                         timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        _build.load()
        est = ddp_dpt()
        result = {}
        def fault_run(kind):
            with DdpFault(kind):
                return ddp_train(f"{root}/train_{kind}_w{world}", est)
        for name, fn in (("train", lambda: ddp_train(
                f"{root}/train_w{world}", est)),
                         ("train_f32", lambda: ddp_train(
                             f"{root}/train_f32_w{world}", est,
                             ddp_caches(root))),
                         ("score", lambda: ddp_score(root, est,
                                                     DDP_SCORE_BATCH)),
                         *((f"fault_{k}", functools.partial(fault_run, k))
                           for k in DDP_FAULTS)):
            torch.cuda.synchronize()
            reset_counts()
            with PlainCalls() as plain:
                t0 = time.perf_counter()
                result[name] = fn()
                torch.cuda.synchronize()
                result[name + "_seconds"] = time.perf_counter() - t0
            result[name + "_launches"] = read_counts()
            result[name + "_plain"] = sorted(set(plain.calls))
        torch.save(result, out)
    except BaseException:
        rank_failed()
    multihost.shutdown()


def rank_failed():
    """End a failed rank at once, its traceback in its log first: its
    peers then fail in their next collective, and no teardown waits on
    them."""
    import os
    import traceback
    traceback.print_exc()
    sys.stderr.flush()
    os._exit(1)


def start_ranks(flag, world, store, root):
    """Start ``world`` gloo ranks of this script on ``cuda:0`` (``flag``:
    ``--ddp-rank`` or ``--mp-rank``); rank r writes its output to
    ``root/<flag>r.log`` and its result to ``root/<flag>r.pt``. Returns
    (processes, name of the files)."""
    import os
    env = dict(os.environ, OMP_NUM_THREADS="4")
    env.pop("WORLD_SIZE", None)
    name = f"{root}/{flag.strip('-')}"
    procs = []
    for rank in range(world):
        with open(f"{name}{rank}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, flag, str(rank), str(world),
                 store, root, f"{name}{rank}.pt"], env=env, stdout=out,
                stderr=subprocess.STDOUT))
    return procs, name


def wait_ranks(group, timeout):
    """Every rank's result, in rank order. One deadline for the group:
    each rank is polled, and as soon as one exits non-zero the others are
    killed and a RuntimeError gives the output of every rank that did not
    finish (a rank whose peer failed may exit before that peer does); at
    the deadline every rank is killed. (A rank's collectives give up after
    ``RANK_TIMEOUT_S`` when a peer is gone.)"""
    import torch
    procs, name = group
    deadline = time.monotonic() + timeout
    late = False
    try:
        while True:
            codes = [proc.poll() for proc in procs]
            if any(codes) or all(code == 0 for code in codes):
                break
            late = time.monotonic() > deadline
            if late:
                break
            time.sleep(0.1)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    failed = [r for r, code in enumerate(codes) if code]
    failed += [r for r, code in enumerate(codes) if code is None]
    if failed:
        raise RuntimeError("\n".join(
            f"gloo rank {r} "
            + (f"exited {codes[r]}" if codes[r] else
               f"still running after {timeout} s" if late else "stopped")
            + ":\n" + open(f"{name}{r}.log").read()[-4000:]
            for r in failed))
    return [torch.load(f"{name}{r}.pt", weights_only=False)
            for r in range(len(procs))]


def ddp_batch_variance(est):
    """How far the bf16 stages round apart at 15 rows a rank and at 30:
    (ResNet-152 features, DPT depth maps) of train-ddp's first 30 images
    in one call and in two, max |diff| over max |x|."""
    import torch
    from depth_image_captioning_pub_torch.engine.steps import (
        frozen_features)
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    cap = build_captioner("depth-soft", VOCAB, device="cuda")
    cap.init(torch.Generator().manual_seed(37))
    train = ddp_sets()[0]
    images = torch.from_numpy(np.stack(
        [train.load_image(i) for i in range(30)])).cuda()
    depth_fn = est.depth_fn()
    out = []
    for fn in (lambda x: frozen_features(cap, x), depth_fn):
        whole = fn(images).float()
        halves = torch.cat([fn(images[:15]), fn(images[15:])]).float()
        out.append(((whole - halves).abs().max()
                    / whole.abs().max()).item())
    return tuple(out)


def ddp_train_gap(got, want):
    """How far a two-rank run ``got`` lies from one rank's ``want``:
    {"loss1": step 1's loss difference, "loss": the largest loss
    difference, "bn1": the largest BN difference after step 1, "bn_end":
    the largest BN difference at the end over its statistic's largest
    value, "grad1": |g2 - g1| / |g1| over every step-1 gradient,
    "step1_over" and "end_over": the largest excess of a trained element
    over the step rule after step 1 and at the end (<= 0 holds; the rule
    of ``tests/test_torch_parallel_train.py``; at the end ``DDP_SPREAD``
    at 2 * lr a step and every other tensor at the rule plus
    ``DDP_WIDTH_ATOL``), "end_over_by": every tensor outside
    ``DDP_SPREAD`` over the rule itself at the end, largest first, "param": the largest parameter difference over 2 * lr *
    steps}."""
    import torch
    steps = len(want["losses"])
    out = {"loss1": abs(got["losses"][0] - want["losses"][0]),
           "loss": max(abs(a - b) for a, b in zip(got["losses"],
                                                   want["losses"]))}
    out["bn1"] = max((got["bn"][k] - w).abs().max().item()
                     for k, w in want["bn"].items())
    out["bn_end"] = max(((got["state"][k] - w).abs().max()
                         / w.abs().max()).item()
                        for k, w in want["state"].items() if "running" in k)
    flat = [torch.cat([g.reshape(-1) for g in run["grad1"]])
            for run in (got, want)]
    out["grad1"] = ((flat[0] - flat[1]).norm() / flat[1].norm()).item()
    trained = [k for k in want["state"] if "running" not in k]
    step1, over, end, param = [], [], {}, 0.0
    for name, small, g1, w1 in zip(trained, want["small"], got["grad1"],
                                   want["grad1"]):
        flip = ((g1.abs() < DDP_SMALL_GRAD) | (w1.abs() < DDP_SMALL_GRAD)
                | (torch.sign(g1) != torch.sign(w1)))
        room = torch.where(flip, 2 * DDP_LR, DDP_PARAM_ATOL)
        step1.append(((got["state1"][name] - want["state1"][name]).abs()
                      - room).max().item())
        diff = (got["state"][name] - want["state"][name]).abs()
        room = torch.where(small > 0, 2 * DDP_LR * small.float(),
                           DDP_PARAM_ATOL)
        if name.startswith(DDP_SPREAD):
            room = torch.full_like(diff, 2 * DDP_LR * steps)
        else:
            end[name] = (diff - room).max().item()
            room = room + DDP_WIDTH_ATOL
        over.append((diff - room).max().item())
        param = max(param, diff.max().item() / (2 * DDP_LR * steps))
    out["step1_over"], out["end_over"] = max(step1), max(over)
    out["end_over_by"] = sorted(((k, v) for k, v in end.items() if v > 0),
                                key=lambda kv: -kv[1])
    out["param"] = param
    return out


def ddp_f32_holds(gap, scale):
    """The CPU tests' bounds on the f32 two-rank run (``gap`` of
    ``ddp_train_gap``; ``scale``: the largest loss)."""
    return (gap["loss1"] <= DDP_LOSS_ATOL
            and gap["loss"] <= DDP_LATER_LOSS_RTOL * scale
            and gap["bn1"] <= DDP_BN_ATOL and gap["bn_end"] <= DDP_BN_LATER
            and gap["step1_over"] <= 0 and gap["end_over"] <= 0)


def ddp_bf16_holds(gap, scale):
    """The bf16 two-rank run's limits (``DDP_BF16_*``)."""
    return (gap["loss1"] <= DDP_BF16_LOSS1
            and gap["loss"] <= DDP_BF16_LOSS * scale
            and gap["bn1"] <= DDP_BF16_BN1 and gap["grad1"] <= DDP_BF16_GRAD1
            and all(np.isfinite([gap[k] for k in (
                "loss1", "loss", "bn1", "bn_end", "grad1", "param")])))


def ddp_gap_text(gap):
    return (f"loss at step 1 {gap['loss1']:.3g}, at any step "
            f"{gap['loss']:.3g}, BN after step 1 {gap['bn1']:.3g}, BN at "
            f"the end {gap['bn_end']:.3g} of max, step-1 gradients "
            f"{gap['grad1']:.3g} of |g|, over the step rule after step 1 "
            f"{gap['step1_over']:.3g}, at the end {gap['end_over']:.3g} "
            f"(the tensors outside DDP_SPREAD over the rule itself: "
            + ", ".join(f"{k} {v:.3g}" for k, v in gap["end_over_by"])
            + f"), parameters {gap['param']:.3g} of 2 * lr * steps")


def phase_data_parallel(smi, base_cap):
    """Phases 34-36 (``PATHS``' train-ddp, score-ddp, serve-devices):
    data parallelism over ``torch.distributed``."""
    import os
    import shutil
    import tempfile
    from pathlib import Path
    import torch
    from depth_image_captioning_pub_torch import cli
    from depth_image_captioning_pub_torch.engine import depth_cache
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    from depth_image_captioning_pub_torch.parallel import multihost
    from depth_image_captioning_pub_torch.pipeline import CaptionPipeline
    here = Path(__file__).resolve().parent
    (here / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(dir=here / "build", prefix="ddp_")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        est = ddp_dpt()
        # the sets that score-ddp reads, written before the ranks start
        cfg = ddp_score_cfg(root)
        os.makedirs(cfg.save_directory_Cdep_soft)
        cap = build_captioner("depth-soft", VOCAB, device="cuda")
        cap.init(torch.Generator().manual_seed(35))
        write_sets("depth-soft", cap, cfg, [300 + i for i in range(DDP_SETS)])
        del cap

        # train-ddp: the plain trainer, NCCL at world size 1, two gloo
        # ranks on this card; then the f32 variant on cached depth maps
        tag = "train-ddp"
        t_phase = time.perf_counter()
        variance = ddp_batch_variance(est)
        torch.cuda.synchronize()
        reset_counts()
        with PlainCalls() as plain:
            for ds, path in zip(ddp_sets(), ddp_caches(root)):
                depth_cache.DepthMapCache(path, len(ds)).build(
                    ds, est.depth_fn(), "cuda", batch_size=30, quiet=True)
            plain_run = ddp_train(f"{root}/train_plain", est)
            multihost.initialize(f"file://{root}/nccl_store", 1, 0,
                                 device="cuda:0")
            try:
                if torch.distributed.get_backend() != "nccl":
                    raise RuntimeError("world size 1 did not run NCCL")
                nccl_run = ddp_train(f"{root}/train_nccl", est)
            finally:
                multihost.shutdown()
            f32_run = ddp_train(f"{root}/train_f32", est, ddp_caches(root))
        torch.cuda.synchronize()
        launches = read_counts()
        if plain.calls:
            raise RuntimeError(f"plain versions ran on the {tag} path: "
                               f"{sorted(set(plain.calls))}")
        if nccl_run["losses"] != plain_run["losses"] or any(
                not torch.equal(nccl_run["state"][k], v)
                for k, v in plain_run["state"].items()):
            raise RuntimeError(
                f"{tag}: NCCL at world size 1 is not bit-equal to the plain "
                f"trainer: losses {nccl_run['losses']} vs "
                f"{plain_run['losses']}")
        ranks = wait_ranks(start_ranks("--ddp-rank", 2,
                                       f"{root}/gloo_store", root),
                           DDP_TIMEOUT)
        for r in ranks:
            if any(r[f"{name}_plain"] for name in (
                    "train", "train_f32", "score",
                    *(f"fault_{k}" for k in DDP_FAULTS))):
                raise RuntimeError("plain versions ran in a gloo rank")
        for name in ("train", "train_f32"):
            a, b = ranks[0][name], ranks[1][name]
            if a["losses"] != b["losses"] or any(
                    not torch.equal(t, b["state"][k])
                    for k, t in a["state"].items()):
                raise RuntimeError(f"{tag}: the two ranks' {name} runs "
                                   f"differ")
        gap = ddp_train_gap(ranks[0]["train"], plain_run)
        gap32 = ddp_train_gap(ranks[0]["train_f32"], f32_run)
        faults = {k: ddp_train_gap(ranks[0][f"fault_{k}"], plain_run)
                  for k in DDP_FAULTS}
        steps = len(plain_run["losses"])
        scale = max(abs(x) for x in f32_run["losses"])
        for name, g in (("bf16, online depth", gap),
                        ("f32 encoders, cached depth", gap32),
                        *((f"bf16, planted fault: {k}", faults[k])
                          for k in DDP_FAULTS)):
            log(tag, f"2 ranks vs 1, {name}: {ddp_gap_text(g)}")
        log(tag, f"limits: f32 the CPU tests' (loss at step 1 "
            f"{DDP_LOSS_ATOL}, any step {DDP_LATER_LOSS_RTOL} of "
            f"{scale:.3f}, BN {DDP_BN_ATOL} after step 1 and "
            f"{DDP_BN_LATER} of max at the end, the step rule, "
            f"+{DDP_WIDTH_ATOL} at the end outside DDP_SPREAD); bf16 "
            f"loss at step 1 {DDP_BF16_LOSS1}, any step {DDP_BF16_LOSS} of "
            f"{scale:.3f}, BN after step 1 {DDP_BF16_BN1}, step-1 "
            f"gradients {DDP_BF16_GRAD1}")
        passed = [k for k in DDP_FAULTS
                  if ddp_bf16_holds(faults[k], scale)]
        if not (ddp_f32_holds(gap32, scale)
                and ddp_bf16_holds(gap, scale)) or passed:
            raise RuntimeError(
                f"{tag}: two ranks part from one (f32 held "
                f"{ddp_f32_holds(gap32, scale)}, bf16 held "
                f"{ddp_bf16_holds(gap, scale)}), or a planted fault "
                f"passes the bf16 limits: {passed}")
        per_run = DPT_BLOCKS * (steps + DDP_EPOCHS * -(-DDP_VAL // 30))
        cache_k5 = DPT_BLOCKS * (-(-DDP_TRAIN // 30) + -(-DDP_VAL // 30))
        rank_k5 = [(r["train_launches"]["vit_attention"],
                    r["train_f32_launches"]["vit_attention"]) for r in ranks]
        launches = {k: v + sum(r["train_launches"][k]
                               + r["train_f32_launches"][k] for r in ranks)
                    for k, v in launches.items()}
        if (launches["vit_attention"] != cache_k5 + 4 * per_run
                or rank_k5 != [(per_run, 0)] * 2):
            raise RuntimeError(f"{tag} launches {launches} (ranks {rank_k5}), "
                               f"expected K5 {per_run} a bf16 run, "
                               f"{cache_k5} for the caches")
        ms = {name: float(np.median(run["ms"][1:])) for name, run in (
            ("world 1 plain", plain_run), ("world 1 NCCL", nccl_run),
            ("world 2 gloo rank 0", ranks[0]["train"]),
            ("world 2 gloo rank 1", ranks[1]["train"]),
            ("f32 world 1", f32_run),
            ("f32 world 2 rank 0", ranks[0]["train_f32"]))}
        log(tag, f"depth-soft B=30 full width, {steps} steps + validation "
            f"per run: losses plain {plain_run['losses']}, NCCL world 1 "
            f"bit-equal (losses and {len(plain_run['state'])} state "
            f"tensors); 2 gloo ranks on cuda:0 {ranks[0]['train']['losses']}"
            f"; f32 encoders on cached depth: world 1 {f32_run['losses']}, "
            f"world 2 {ranks[0]['train_f32']['losses']}")
        log(tag, f"bf16 at 15 rows vs 30 (max |diff| over max |x|): "
            f"ResNet-152 features {variance[0]:.3g}, DPT depth maps "
            f"{variance[1]:.3g}")
        log(tag, "median step ms (device, CUDA events, steps 2-4): "
            + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
            + f"; launches {launches} (K5 {per_run} a bf16 run: 4 runs, "
            f"{cache_k5} for the f32 runs' caches) [{smi}]")
        out[tag] = launches
        out["train-ddp-gap"] = {"bf16": gap, "f32": gap32,
                                "faults": faults, "variance": variance}
        out["train-ddp-ms"] = ms

        # score-ddp: one rank at the ranks' per-card batch and at the
        # whole batch, against the two ranks' run
        tag = "score-ddp"
        torch.cuda.synchronize()
        reset_counts()
        with PlainCalls() as plain:
            one = {b: ddp_score(root, est, b)
                   for b in (DDP_SCORE_BATCH // 2, DDP_SCORE_BATCH)}
        torch.cuda.synchronize()
        launches = read_counts()
        if plain.calls:
            raise RuntimeError(f"plain versions ran on the {tag} path: "
                               f"{sorted(set(plain.calls))}")
        scores, hypos = ranks[0]["score"]
        rows = sum(len(h) for h in hypos)
        agree = {b: sum(a == c for x, y in zip(hypos, h)
                        for a, c in zip(x, y)) / rows
                 for b, (_, h) in one.items()}
        same = {b: (s == scores, h == hypos) for b, (s, h) in one.items()}
        if ranks[1]["score"][0] != scores or ranks[1]["score"][1] != []:
            raise RuntimeError(f"{tag}: rank 1 returned other scores")
        if len(hypos) != DDP_SETS or hypos[0] == hypos[1]:
            raise RuntimeError(f"{tag}: hypotheses per set {len(hypos)}")
        rank_counts = [r["score_launches"] for r in ranks]
        launches = {k: v + sum(c[k] for c in rank_counts)
                    for k, v in launches.items()}
        per_rank = DDP_SCORE // 2 // (DDP_SCORE_BATCH // 2)
        for c in rank_counts:
            if (c["vit_attention"] != DPT_BLOCKS * per_rank
                    or c["decode_seq"] != DDP_SETS * per_rank):
                raise RuntimeError(f"{tag}: rank launches {c}, expected K5 "
                                   f"{DPT_BLOCKS * per_rank} and K2 "
                                   f"{DDP_SETS * per_rank}")
        log(tag, f"{DDP_SETS} depth-soft sets over {DDP_SCORE} images, "
            f"batch {DDP_SCORE_BATCH} over 2 gloo ranks on cuda:0 (32 rows "
            f"each): rank launches {rank_counts}; against one rank "
            f"at batch {DDP_SCORE_BATCH // 2} (the ranks' per-card rows) and "
            f"{DDP_SCORE_BATCH}: (scores ==, hypotheses ==) {same}, "
            f"hypothesis agreement {agree}; 2-rank seconds "
            f"{ranks[0]['score_seconds']:.2f}; scores "
            + ", ".join(f"{k} {v}" for k, v in scores.items())
            + f" [{smi}]")
        if not all(same[DDP_SCORE_BATCH // 2]):
            raise RuntimeError(f"{tag}: two ranks differ from one rank at "
                               f"the per-card batch: {same}")
        out[tag] = launches
        out["score-ddp-agree"] = agree

        # serve-devices: one pipeline over two replicas on cuda:0
        tag = "serve-devices"
        w2i, i2w = cli.placeholder_vocab(VOCAB)
        rng = np.random.default_rng(36)
        requests = [rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
                    for n in DDP_REQUESTS]
        single = CaptionPipeline(base_cap, w2i, i2w, max_length=MAX_LEN,
                                 batch_buckets=(2, 16, 64))
        double = CaptionPipeline(base_cap, w2i, i2w, max_length=MAX_LEN,
                                 batch_buckets=(1, 16, 64),
                                 devices=["cuda:0", "cuda:0"])
        if double.batch_buckets != (2, 16, 64):
            raise RuntimeError(f"{tag}: buckets {double.batch_buckets}")
        want, once = run_requests(single, requests, smi, f"{tag} one")
        got, launches = run_requests(double, requests, smi, tag)
        chunks = [-(-n // 64) for n in DDP_REQUESTS]
        if launches != dict(dict.fromkeys(launches, 0),
                            decode_seq=2 * sum(chunks)):
            raise RuntimeError(f"{tag}: launches {launches}, expected K2 2 "
                               f"a chunk")
        equal = [bool(np.array_equal(g, w)) for g, w in zip(got, want)]
        agree = token_agreement(np.concatenate(got), np.concatenate(want))
        # the same per-replica shapes: each half alone on one device
        by_half = CaptionPipeline(base_cap, w2i, i2w, max_length=MAX_LEN,
                                  batch_buckets=(8, 32))
        halves = []
        for req in requests[:2]:
            h = len(req) // 2
            halves.append(np.concatenate([by_half.caption_tokens(req[:h]),
                                          by_half.caption_tokens(req[h:])]))
        half_equal = [bool(np.array_equal(g, h))
                      for g, h in zip(got, halves)]
        log(tag, f"CaptionPipeline over [cuda:0, cuda:0] (buckets "
            f"{double.batch_buckets}): requests {list(DDP_REQUESTS)}, tokens "
            f"== one device {equal} (agreement {agree:.4f}), == one device "
            f"on each replica's half {half_equal}; launches {launches}, one "
            f"device {once} [{smi}]")
        if not all(half_equal) or agree < MIN_AGREEMENT:
            raise RuntimeError(f"{tag}: tokens differ from one device")
        out[tag] = launches
        log("ddp", f"phases 34-36 in {time.perf_counter() - t_phase:.1f} s")
        del double
        return out
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# ---- 37-40: tensor, sequence and pipeline parallelism ---------------------

MP_PATHS = ("train-tp", "tp-greedy", "sp-dpt", "pp-vit")
MP_DATA, MP_MODEL, MP_STAGES = 2, 2, 4
MP_WORLD = MP_DATA * MP_MODEL
MP_TRAIN_BATCH, MP_TRAIN_STEPS = 8, 5
# train-tp's losses against one process's, each step: between the sound
# run's largest gap on an H100 (1.39e-4) and the planted fault's (1.42e-2)
MP_LOSS_RTOL = 1e-3
MP_GREEDY_BATCH = 32
MP_SP_BATCH = 4
MP_SP_F32_ATOL = 1e-3    # sp-dpt's f32 depth maps against unsharded ones
MP_PP_BATCH, MP_PP_MB = 8, 4
MP_PP_RTOL = 1e-4        # pp-vit's taps, of their largest |value|
MP_TIMEOUT = 420         # seconds for the four gloo ranks
# K5 launches a rank: a DPT forward 12 (one a block), sp-dpt's two DPTs
# (f32, bf16), pp-vit's 3 blocks a stage at each of M + S - 1 steps
MP_K5 = {"train-tp": 12, "tp-greedy": 12, "sp-dpt": 24,
         "pp-vit": 12 // MP_STAGES * (MP_PP_MB + MP_STAGES - 1)}


class MpFault:
    """A planted fault of train-tp (a control for its loss bound):
    copy-to-region's backward without its all-reduce over ``model``, so
    that the gradient reaching a replicated input of a split matmul is
    this rank's part of it."""

    def __enter__(self):
        from depth_image_captioning_pub_torch.parallel import tp
        self.saved = tp._CopyToRegion.backward
        tp._CopyToRegion.backward = staticmethod(
            lambda ctx, grad: (grad, None))
        return self

    def __exit__(self, *exc):
        from depth_image_captioning_pub_torch.parallel import tp
        tp._CopyToRegion.backward = self.saved


def mp_images(n, seed, hw=224):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3),
                                                dtype=np.uint8)


def mp_dpt(dtype, mesh=None, token_sharding=False):
    """Phase 7's DPT-hybrid at 384x384 (seed 1) in ``dtype``, its ViT
    blocks split over ``mesh``'s model axis (and its tokens with
    ``token_sharding``)."""
    import torch
    from depth_image_captioning_pub_torch.models.dpt import (
        DPTDepthEstimator)
    from depth_image_captioning_pub_torch.parallel import tp
    est = DPTDepthEstimator(dtype=dtype, device=torch.device("cuda"),
                            token_sharding=mesh if token_sharding else None)
    est.init(torch.Generator().manual_seed(1))
    if mesh is not None:
        tp.shard_tree(mesh, est.model)
    return est


def mp_captioner(seed):
    """A depth-soft captioner at full width (bf16 encoders, f32 decoder,
    V=9956) drawn from ``seed``."""
    import torch
    from depth_image_captioning_pub_torch.models.captioner import (
        build_captioner)
    cap = build_captioner("depth-soft", VOCAB, device=torch.device("cuda"))
    cap.init(torch.Generator().manual_seed(seed))
    return cap


def mp_train_batch():
    """train-tp's global batch: 224x224 images, 32-token captions."""
    rng = np.random.default_rng(37)
    n, length = MP_TRAIN_BATCH, 32
    caps = rng.integers(4, VOCAB, (n, length)).astype(np.int32)
    return {"images": mp_images(n, 38), "captions": caps,
            "lengths": rng.integers(10, length + 1, (n,)).astype(np.int32),
            "pad_mask": np.ones((n,), bool)}


def mp_train_steps(cap, batch, steps_n):
    """``steps_n`` AdamW steps of ``cap`` on ``batch`` (its depth maps
    given), dropout from a card generator seeded 39: the global losses."""
    import torch
    from depth_image_captioning_pub_torch.engine import steps
    opt = steps.make_optimizer(cap, 1e-3)
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(39)
    return [float(steps.attention_train_step(cap, opt, batch,
                                             generator=gen)["loss"])
            for _ in range(steps_n)]


def mp_to_card(batch):
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in batch.items()}


def mp_train(mesh, est, depth=None):
    """train-tp in a rank: the depth maps of its data row's rows by the
    TP-split DPT (or ``depth``), then MP_TRAIN_STEPS steps of the TP-split
    depth-soft captioner."""
    from depth_image_captioning_pub_torch.parallel import tp
    cap = mp_captioner(36)
    tp.shard_tree(mesh, cap)
    batch = mp_to_card(tp.shard_batch_2d(mesh, mp_train_batch()))
    batch["depth"] = (est.depth_fn()(batch["images"]).clone()
                      if depth is None else depth.cuda())
    losses = mp_train_steps(cap, batch, MP_TRAIN_STEPS)
    return {"losses": losses, "depth": batch["depth"].cpu()}


def mp_caption_fn(cap, est):
    from depth_image_captioning_pub_torch.cli import (
        SPECIAL, placeholder_vocab)
    from depth_image_captioning_pub_torch.engine.evaluate import (
        make_caption_fn)
    w2i, _ = placeholder_vocab(VOCAB)
    return make_caption_fn(cap, w2i[SPECIAL.start], MAX_LEN,
                           depth_fn=est.depth_fn(), end_id=w2i[SPECIAL.end])


def mp_greedy(mesh, est):
    """tp-greedy in a rank: ``make_caption_fn`` over the TP-split
    depth-soft captioner and DPT on its data row's images; the tokens and
    the frozen stages' entry."""
    import torch
    from depth_image_captioning_pub_torch.parallel import tp
    cap = mp_captioner(40)
    tp.shard_tree(mesh, cap)
    fn = mp_caption_fn(cap, est)
    images = torch.from_numpy(tp.shard_batch_2d(
        mesh, mp_images(MP_GREEDY_BATCH, 41))).cuda()
    entry = fn.frozen(images)
    tokens = fn.decode(entry)
    return {"tokens": tokens.cpu(), "feats": entry["feats"].cpu(),
            "depth_maps": entry["depth_maps"].cpu()}


def mp_sp(mesh):
    """sp-dpt in a rank: the token-sharded, TP-split DPT in f32 and bf16
    on its data row's images."""
    import torch
    from depth_image_captioning_pub_torch.parallel import tp
    images = torch.from_numpy(tp.shard_batch_2d(
        mesh, mp_images(MP_SP_BATCH, 42))).cuda()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        est = mp_dpt(dtype, mesh, token_sharding=True)
        out[str(dtype)] = est.depth_fn()(images).cpu()
        del est
    return out


def mp_pp_tokens():
    return np.random.default_rng(43).standard_normal(
        (MP_PP_BATCH, VIT_N, 768)).astype(np.float32)


def mp_pp(stages):
    """pp-vit in a rank: the f32 DPT's 12 ViT blocks as MP_STAGES stages
    (this rank keeps its 3), MP_PP_MB microbatches; rank 0 returns the
    taps after blocks 8 and 11, the others their sums."""
    import torch
    from depth_image_captioning_pub_torch.parallel import pp
    est = mp_dpt(torch.float32)
    blocks = [getattr(est.model, n) for n in est.model.blocks]
    tokens = torch.from_numpy(mp_pp_tokens()).cuda()
    with torch.no_grad():
        taps = pp.vit_taps_pipelined(blocks, tokens, stages, MP_PP_MB)
    del est, blocks
    if stages.stage.rank == 0:
        return {"taps": [t.cpu() for t in taps]}
    return {"sums": [float(t.double().sum()) for t in taps]}


def mp_child(rank, world, store, root, out):
    """One gloo rank on ``cuda:0`` (``chip_smoke.py --mp-rank``) of phases
    37-40: the (data 2, model 2) mesh and the 4-stage mesh, then each path
    with the launch counters set to 0 just before and read just after,
    then train-tp under ``MpFault`` (on the same depth maps); results to
    ``out``."""
    import torch
    from depth_image_captioning_pub_torch.ops.kernels import _build
    from depth_image_captioning_pub_torch.parallel import multihost, pp, tp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    multihost.initialize(f"file://{store}", world, rank, backend="gloo",
                         device="cuda:0",
                         timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        _build.load()
        with tp.make_mesh_2d(MP_DATA, MP_MODEL) as mesh:
            stages = pp.make_stage_mesh(MP_STAGES)
            est = mp_dpt(torch.bfloat16, mesh)
            result = {"mesh": (mesh.data.rank, mesh.model.rank,
                               stages.stage.rank)}
            for name, fn in zip(MP_PATHS, (
                    lambda: mp_train(mesh, est),
                    lambda: mp_greedy(mesh, est),
                    lambda: mp_sp(mesh), lambda: mp_pp(stages))):
                torch.cuda.synchronize()
                reset_counts()
                with PlainCalls() as plain:
                    t0 = time.perf_counter()
                    result[name] = fn()
                    torch.cuda.synchronize()
                    result[name + "_seconds"] = time.perf_counter() - t0
                result[name + "_launches"] = read_counts()
                result[name + "_plain"] = sorted(set(plain.calls))
            with MpFault():
                result["train-tp-fault"] = mp_train(
                    mesh, est, result["train-tp"]["depth"])
        torch.save(result, out)
    except BaseException:
        rank_failed()
    multihost.shutdown()


def mp_rows(ranks, path, key):
    """``key`` of ``path`` from the model-rank-0 ranks, joined in data-row
    order (the model ranks of a row hold the same rows)."""
    import torch
    return torch.cat([ranks[d * MP_MODEL][path][key]
                      for d in range(MP_DATA)])


def phase_model_parallel(smi):
    """Phases 37-40 (``PATHS``' train-tp, tp-greedy, sp-dpt, pp-vit):
    tensor, sequence and pipeline parallelism over four gloo ranks sharing
    this card, each held to one process on the same inputs."""
    import shutil
    import tempfile
    from pathlib import Path
    import torch
    here = Path(__file__).resolve().parent
    (here / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(dir=here / "build", prefix="mp_")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        t_phase = time.perf_counter()
        ranks = wait_ranks(start_ranks("--mp-rank", MP_WORLD,
                                       f"{root}/gloo_store", root),
                           MP_TIMEOUT)
        t_ranks = time.perf_counter() - t_phase
        for path in MP_PATHS:
            counts = [r[path + "_launches"] for r in ranks]
            if any(r[path + "_plain"] for r in ranks):
                raise RuntimeError(f"plain versions ran on the {path} path")
            want = dict(dict.fromkeys(counts[0], 0),
                        vit_attention=MP_K5[path])
            if any(c != want for c in counts):
                raise RuntimeError(f"{path}: launches a rank {counts}, "
                                   f"expected {want}")
            out[path] = {k: sum(c[k] for c in counts) for k in counts[0]}
        seconds = {p: max(r[p + "_seconds"] for r in ranks)
                   for p in MP_PATHS}
        with torch.no_grad():
            est16 = mp_dpt(torch.bfloat16)

            # train-tp: falling losses, equal on every rank; every step
            # against one process on the same batch, the ranks' depth maps
            # and the same dropout draws; the planted fault seen
            tag = "train-tp"
            losses = [r[tag]["losses"] for r in ranks]
            if any(lo != losses[0] for lo in losses) or not all(
                    np.isfinite(losses[0])):
                raise RuntimeError(f"{tag}: rank losses {losses}")
            if not losses[0][-1] < losses[0][0]:
                raise RuntimeError(f"{tag}: loss did not fall: {losses[0]}")
        batch = mp_to_card(mp_train_batch())
        batch["depth"] = mp_rows(ranks, tag, "depth").cuda()
        one = mp_train_steps(mp_captioner(36), batch, MP_TRAIN_STEPS)
        with torch.no_grad():
            plain_depth = est16.depth_fn()(batch["images"])
            dgap = float((plain_depth - batch["depth"]).abs().max())

            def loss_gap(got):
                return max(abs(g - w) / abs(w) for g, w in zip(got, one))
            rel = loss_gap(losses[0])
            fault = [r[tag + "-fault"]["losses"] for r in ranks]
            fault_rel = max(loss_gap(f) for f in fault)
            log(tag, f"depth-soft (data {MP_DATA}, model {MP_MODEL}) over "
                f"{MP_WORLD} gloo ranks on cuda:0, B={MP_TRAIN_BATCH}: "
                f"losses {losses[0]}; one process {one}: max relative gap "
                f"{rel:.3e} (limit {MP_LOSS_RTOL}), step 1 "
                f"{abs(losses[0][0] - one[0]) / abs(one[0]):.3e}; planted "
                f"fault (copy-to-region's backward without its all-reduce) "
                f"{fault_rel:.3e}, rank 0 {fault[0]}; TP depth maps vs "
                f"unsplit bf16 max {dgap:.3e}; launches {out[tag]}; "
                f"{seconds[tag]:.2f} s [{smi}]")
            if rel > MP_LOSS_RTOL:
                raise RuntimeError(f"{tag}: losses {losses[0]} vs one "
                                   f"process {one}")
            if not fault_rel > MP_LOSS_RTOL:
                raise RuntimeError(f"{tag}: the planted fault's losses "
                                   f"{fault} pass the bound")

            # tp-greedy: against one process's step loop and K2 on the
            # ranks' own frozen-stage entries
            tag = "tp-greedy"
            for d in range(MP_DATA):
                row = ranks[d * MP_MODEL:(d + 1) * MP_MODEL]
                if any(not torch.equal(r[tag]["tokens"],
                                       row[0][tag]["tokens"])
                       for r in row):
                    raise RuntimeError(f"{tag}: model ranks disagree")
            got = mp_rows(ranks, tag, "tokens").numpy()
            cap = mp_captioner(40)
            fn = mp_caption_fn(cap, est16)
            entry = {"feats": mp_rows(ranks, tag, "feats").cuda(),
                     "depth_maps": mp_rows(ranks, tag, "depth_maps").cuda()}
            k2 = fn.decode(entry).cpu().numpy()
            from depth_image_captioning_pub_torch.cli import (
                SPECIAL, placeholder_vocab)
            w2i, _ = placeholder_vocab(VOCAB)
            loop = cap.decoder.loop_greedy(
                entry["feats"], w2i[SPECIAL.start],
                cap.depth_encoder_apply()(entry["depth_maps"]),
                max_length=MAX_LEN, end_id=w2i[SPECIAL.end]).cpu().numpy()
            agree = token_agreement(got, loop)
            agree_k2 = token_agreement(got, k2)
            log(tag, f"depth-soft greedy, f32 decoder split over model "
                f"{MP_MODEL} (V={VOCAB}), {MP_GREEDY_BATCH} images over "
                f"data {MP_DATA}: tokens vs one process's step loop "
                f"{agree:.4f} (>= {MIN_AGREEMENT}), vs one process's K2 "
                f"{agree_k2:.4f}; launches {out[tag]}; {seconds[tag]:.2f} "
                f"s [{smi}]")
            if agree < MIN_AGREEMENT:
                raise RuntimeError(f"{tag}: agreement {agree}")
            del cap, fn, entry

            # sp-dpt: the token-sharded, TP-split DPT against one process
            tag = "sp-dpt"
            images = torch.from_numpy(mp_images(MP_SP_BATCH, 42)).cuda()
            gaps = {}
            for dtype, est in ((torch.float32, mp_dpt(torch.float32)),
                               (torch.bfloat16, est16)):
                want = est.depth_fn()(images).cpu()
                got = mp_rows(ranks, tag, str(dtype))
                if not bool(torch.isfinite(got).all()):
                    raise RuntimeError(f"{tag}: {dtype} maps not finite")
                gaps[str(dtype)] = (float((got - want).abs().max()),
                                    float(want.abs().max()))
                del est
            f32_gap = gaps["torch.float32"][0]
            b16_gap, b16_max = gaps["torch.bfloat16"]
            log(tag, f"DPT-hybrid at 384x384 (N={VIT_N} tokens padded to "
                f"{VIT_N + VIT_N % MP_MODEL}, split over model {MP_MODEL}, "
                f"heads and MLP split too), {MP_SP_BATCH} images over data "
                f"{MP_DATA}: f32 max |diff| {f32_gap:.3e} (limit "
                f"{MP_SP_F32_ATOL}); bf16 {b16_gap:.3e}, "
                f"{b16_gap / b16_max:.3e} of the map's max; launches "
                f"{out[tag]}; {seconds[tag]:.2f} s [{smi}]")
            if f32_gap > MP_SP_F32_ATOL:
                raise RuntimeError(f"{tag}: f32 gap {f32_gap}")

            # pp-vit: the taps against the sequential fold
            tag = "pp-vit"
            est = mp_dpt(torch.float32)
            t = torch.from_numpy(mp_pp_tokens()).cuda()
            fold = {}
            for i, name in enumerate(est.model.blocks):
                t = getattr(est.model, name)(t)
                if i in (8, 11):
                    fold[i] = t.cpu()
            del est
            taps = ranks[0][tag]["taps"]
            for r in ranks[1:]:
                if r[tag]["sums"] != [float(x.double().sum()) for x in taps]:
                    raise RuntimeError(f"{tag}: ranks' taps differ")
            rel_gap = max(float((g - fold[i]).abs().max()
                                / fold[i].abs().max())
                          for g, i in zip(taps, (8, 11)))
            log(tag, f"the f32 DPT's 12 ViT blocks as {MP_STAGES} stages "
                f"of 3 (one a rank), B={MP_PP_BATCH}, M={MP_PP_MB}, "
                f"N={VIT_N}: taps 8, 11 vs the sequential fold max |diff| "
                f"{rel_gap:.3e} of max |tap| (limit {MP_PP_RTOL}); "
                f"launches {out[tag]}; {seconds[tag]:.2f} s [{smi}]")
            if rel_gap > MP_PP_RTOL:
                raise RuntimeError(f"{tag}: taps gap {rel_gap}")
        del est16
        log("mp", f"phases 37-40 in {time.perf_counter() - t_phase:.1f} s "
            f"({t_ranks:.1f} s of ranks)")
        return out
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def main():
    smi = phase_env()
    import torch
    phase_build()
    step = phase_step(smi)
    seq = phase_seq(smi)
    base, base_cap = phase_main_path(smi)
    vit = phase_vit(smi)
    depth, est = phase_depth_path(smi)
    nic_k = phase_nic_kernel(smi)
    nic = phase_nic_path(smi)
    beam_k = phase_beam_kernel(smi)
    beam = phase_beam_path(smi, base_cap)
    sample = phase_sample_path(smi, base_cap)
    score = phase_score_path(smi, base_cap)
    by_path = dict(zip(PATHS, (base, depth, nic, beam, sample, score)))
    hard, hard_cap = phase_hard_path(smi)
    mdepth, mdepth_cap = phase_mdepth_path(smi, est)
    by_path.update(hard)
    by_path.update(mdepth)
    by_path.update(phase_other_kinds(smi, est))
    by_path.update(phase_score_new_kinds(smi, hard_cap, mdepth_cap, est))
    by_path.update(phase_serve(smi, base_cap))
    by_path.update(phase_caption_depth224(smi, vit))
    by_path.update(phase_train(smi, est))
    by_path.update(phase_reference_weights(smi, base_cap, est))
    by_path.update(phase_resume(smi))
    by_path.update(phase_caches_and_training(smi, est))
    by_path.update(phase_sample_mode(smi, base_cap))
    by_path.update(phase_export(smi, base_cap, est))
    ddp = phase_data_parallel(smi, base_cap)
    by_path.update((path, ddp[path]) for path in DDP_PATHS)
    by_path.update(phase_model_parallel(smi))
    if tuple(by_path) != PATHS:
        raise RuntimeError(f"paths run {tuple(by_path)}, expected {PATHS}")
    kernels = [step, seq, nic_k, beam_k, vit]
    for entry in kernels:
        counts = {path: c[entry["name"]] for path, c in by_path.items()}
        entry["launches"] = sum(counts.values())
        entry["launches_by_path"] = counts
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:     # a gloo rank of phases 34-35
        ddp_child(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    elif sys.argv[1:2] == ["--mp-rank"]:    # a gloo rank of phases 37-40
        mp_child(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    else:
        main()
