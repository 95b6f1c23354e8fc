#!/usr/bin/env python3
"""Drive stylemc_torch's serving, training (single prompt, prompt sweeps,
the landmarks loss, the latent mapper, the e4e encoder), real-image
editing, DeepLab feature-blending, GAN evaluation (calc_metrics, LEC),
NADA-loss and warp paths, their data-parallel forms, TF1 pickles and the
StyleGAN2 discriminator, the verify harness and the small CLIs, and its
fused-layer A/B on one CUDA card and check them.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON object per line; any failure raises and the
script exits non-zero:

  env     card name, nvidia-smi power limit, torch/CUDA versions, TF32 flags
          (both turned off: the fp32 policy compares against fp32 references)
  build   nvcc builds of the five kernel libraries (B1 upsample2x, B2
          downsample2x, B3 modconv_fwd, B4 modconv_bwd_data, B5
          modconv_bwd_weight) from the checkout's sources, started together
  kernel  the launch floor (an empty kernel, stylemc_torch.bench.launch_floor,
          timed as the kernels are); B1 (upsample2x) against its plain torch
          version at every ToRGB chain shape of FFHQ-256 at batch 16, the
          two larger planes of FFHQ-1024's chain at batch 16 ([16,3,256²],
          [16,3,512²]; the e4e decoder's), the 1024 px plane, two odd
          shapes, a mapper step's chain [2,3,h,h], h = 4..256, and the
          batch-4 chains of LEC's FFHQ-1024 decodes [4,3,h,h], h = 4..512,
          whose first six are the NADA step's FFHQ-256 chain (all eight
          the e4e coach step's decode chain); B2 (downsample2x) at the
          training step's backward shapes [4,3,2h,2h], the 1024 px plane,
          two odd shapes, a mapper step's backward shapes [2,3,2h,2h] up to
          512², and an e4e coach step's last two, [4,3,512²] and
          [4,3,1024²]; both on an input 4 bytes off alignment; max |err| <=
          1e-5;
          kernel, plain, library-call and bound times (device time: CUDA
          events around calls queued behind a sleep kernel), each row with
          its launch plan, the floor and the aim (floor + 1.5 x bound), and
          the wrapper's time over back-to-back calls, which includes its
          host cost
  grad    first- and second-order gradients through upsample2d_kernel and
          downsample2d_kernel on the card against the same computation
          through the plain versions (relative L2 <= 1e-5)
  modconv B3, B4 and B5 against their plain versions at the seven
          full-width FFHQ-256 conv1 shapes (C 512..128, 4²..256²) at batch
          4, B3 at batch 16 too, an odd shape [3,16→8,24x20] and a
          clamp-binding case (x·600; there the B3 gate scales with the
          pre-clamp values, and float64 shows each side's error): B3 max
          |err| <= 2e-5·max(1, max|y|), each B4/B5 output relative L2 <=
          1e-5; B3, B4 and B5 also at ragged tilings (MODCONV_FWD_RAGGED,
          MODCONV_DX_RAGGED, MODCONV_DW_RAGGED), one counted call each,
          with their split plans; a bf16-x fused_modulated_layer call (y
          in bf16, one B3 launch, within one bf16 step of the plain version
          beside B3's fp32 gate); kernel, plain, library-call (unfused
          forward, its backward to x and s,
          torch.nn.grad.conv2d_weight) and bound times (3xTF32 on the
          tensor cores, and in fp32 FMAs beside it)
  modconv_grad  gradients of fused_modulated_layer (x, w, s, bias) on the
          card against autograd through the plain forward in float64
          (relative L2 <= 1e-5; the fp32 plain forward's own errors are
          recorded beside them), the cotangent zeroed where the forwards
          take other branches of lrelu/clamp; B3/B4/B5 launched once each
  mma_rate  the tensor cores' TF32 rate through mma.sync (the ceiling of
          B3's, B4's and B5's instruction; stylemc_torch.bench.mma_rate);
          then each one's TFLOP/s and plan per timed shape beside it
          (modconv_fwd_rate, modconv_bwd_data_rate, modconv_bwd_weight_rate)
  ab      stylemc_torch.bench.fused_layer_ab: fused against unfused at each
          conv1, forward at batch 4 and 16, fwd+bwd(x, s) and fwd+bwd(+w) at
          batch 4; per layer and summed per mode; each mode's launches held
          to 1/0/0, 1/0/0, 1/1/0 and 1/1/1 B3/B4/B5 per fused call
  train   find_direction at full width: the FFHQ-256 generator below
          (random weights from a seed, polyphase up-convs), CLIP ViT-B/32
          and ViT-B/16 and ArcFace IR-SE-50 with random weights from seeds,
          129 seeds, batch 4, clip_type double, fp32, one epoch (33 steps);
          precompute and step times, images/s, peak memory, one step's
          device time by kernel name and the idle share, each model's
          fwd+bwd time, and the per-layer rates of the generator's
          polyphase up-convs; it runs before any other phase traces the
          card with the profiler
  train_parity  one full-width step (batch 2, seeds 1-2) from the same
          direction on the card and on the CPU: losses within rtol 1e-4,
          Δs gradients within relative L2 1e-3; beside it, not gated, the
          card's Δs gradient with B1's and B2's plain versions in place of
          the kernels
  sweep   DirectionEngine on the train phase's models and 129 seeds:
          the precompute once, optimize_batch over 4 prompts (the prompt
          axis folded into the image batch: 16 images, one synthesis call
          a step), then the serial optimize of each prompt, all from the
          seeded direction d0; ms/step and directions an hour both ways,
          precompute seconds, peak memory; each prompt's batched update
          (direction − d0) against its serial one, after one step on a
          4-seed engine at a held learning rate (cosine > 0.99999, norms
          within 1e-3) and after the run (cosine > 0.9999, norms within
          3e-3), beside the serial run repeated (not gated)
  landmarks  find_direction with landmarks_in_graph on the same models
          and the first 33 seeds (9 steps), the landmark weights (seeded MTCNN P/R/O nets, their
          face logit biased so the cascade finds faces, and a seeded
          full-width MobileNet-GDConv, its last layer scaled around 0.5)
          written in the reference's formats ({p,r,o}net.npy, a
          'state_dict' .pth.tar) and read by default_landmarker:
          prepare_landmarks_refs seconds, MTCNN candidates per stage and
          faces found, ms/step, one profiled step's idle share, the
          landmarks term (finite, non-zero), NMS and crop extraction
          through the native host library (built with g++, asserted)
  landmarks_parity  one full-width landmarks step (batch 2, seeds 1-2) on
          the card and on the CPU from the seeded direction, both
          landmarks terms reading the card's renders and the boxes MTCNN
          found on the card: loss rtol 1e-4; Δs gradient relative L2
          3e-2; the landmarks term's fp32 image gradient on each side
          against float64 at the card's render, pushed into Δs, 3e-2; the
          card's boxes against the CPU's on their own renders (the same
          faces, within 0.05 px); each gate beside a TF32 control of the
          card's side, which must fail it
  landmarks_metric  the logging-only metric on 4 seeds, card against
          CPU on the card's detections (rtol 1.5e-4; TF32 must fail it)
  sweep_clis  find_direction --text_prompts (3 prompts) --batch_prompts,
          again with --resume <that run's directory>, and --landmarks_grad
          with the landmark files, as subprocesses on 8 seeds
  serve   full-width FFHQ-256 generator (random weights from a seed) saved
          as a native .npz, BatchEditor.from_files + warmup, an HTTP server
          answering /edit and /stats; images/s at batch 16 and 64; where
          one batch-16 call's device time goes, by kernel name and by
          layer (profiler)
  parity  two seeds rendered on the card and on the CPU agree within ±1
  clis    generate_w → w_s_converter → find_direction → generate_fromS as
          subprocesses, each consuming the one before
  e4e     real-image editing at the full width of e4e_ffhq_encode, random
          weights from seeds, written by the port's own export
          (e4e_fabricate): the IR-SE-50 Encoder4Editing (18 style heads,
          256² input) and the rosinality FFHQ-1024 decoder (channel
          multiplier 2, 8 mapping layers, no conv clamp; its ToRGB weights
          scaled by 1/8 so renders stay mostly inside [-1, 1]); 8 seeded
          256² PNG photos.
          e4e_clis: infer_e4e --batch 4 --save_images → w_s_converter
          --network decoder.pt → generate_fromS with a seeded direction, as
          subprocesses.
          e4e_serve: BatchEditor.from_files(decoder.pt, e4e_ckpt=...,
          max_batch 16) + warmup, an HTTP server answering 4 POST
          /edit_image and /stats; request seconds and p50. e4e_styles: the
          editor's styles of the 8 photos against the CLI chain's, relative
          L2 <= 1e-4. e4e_throughput: invert_images and edit_images (1024)
          images/s at batch 4 and 16, peak memory. e4e_breakdown: one
          batch-16 edit_images call's device time by kernel name, and its
          encoder half (invert_images) and synthesis half (edit_styles)
          profiled apart.
          e4e_parity: 2 photos on the card and on the CPU: W+ codes
          (PSP.encode) within relative L2 1e-4, edited renders (power 2)
          within ±1 per uint8.
          e4e_align: align_faces on the 8 photos (256² FFHQ crops from the
          landmark files), then infer_e4e --align, as subprocesses
  mapper  train_latent_mapper at full width: a seeded FFHQ-1024 generator
          (channel_base 32768, channel_max 512, 8 mapping layers, saved as
          a native .npz) rendered to 512 px (until_k 7), the train phase's
          CLIP and ArcFace, MapperTrainConfig's defaults (batch 2, Adam lr
          5e-4, clip_type double), fp32, 129 seeds, one epoch (65 steps):
          precompute seconds, ms/step over steps 2-65, images/s, peak
          memory; one profiled Adam step's device time by kernel name and
          its idle share (mapper_breakdown)
  mapper_parity  one full-width mapper step (batch 2, seeds 1-2) from the
          same seeded mapper on the card and on the CPU: loss rtol 1e-6,
          the 20 gradients relative L2 1e-3; Adam's step from the card's
          gradient on both sides, the mapper's outputs after it relative
          L2 1e-4 (each side's outputs after its own step, the gradient
          sign flips and the identity term's image gradient against float64
          recorded beside them)
  deeplab the full-width face parser (ResNet-101 (3, 4, 23, 3), width 64,
          19 classes, seeded, written in the reference's 'module.'
          state_dict layout, read by default_segmenter via STYLEMC_DEEPLAB)
          on a seeded image: ms per network and per segment call at 513²,
          the device split by kernel name (deeplab_breakdown); each stage
          (stem, 33 bottlenecks, ASPP, upsample) on the card fed the CPU's
          input to it, within relative L2 1e-4 of the CPU's output; the
          end-to-end logits card against CPU and each side against float64
          recorded; class maps equal where the top-two gap exceeds 1e-3 of
          the logits' largest magnitude, the other pixels counted
  mapper_clis  on 8 seeds, as subprocesses: train_latent_mapper (one
          epoch, --network2 a second seeded FFHQ-1024 generator),
          generate_fromS --use_mapper 1 --use_whitelist 1, generate_fromS
          --use_mapper 1 --use_blending 1 --batch 4 (BatchEditor with the
          parser attached, two buckets of 4), run_deeplab on the blended
          JPEGs; one bucket of 4 blended in this process through
          BatchEditor.attach_segmenter (two Segmenter network calls of 4
          rows, three synthesis calls; its JPEGs beside the CLI's); one
          item blended on the card and on the CPU, both fed the card's
          masks: renders within ±1
  mapper_serve  BatchEditor.from_files(ffhq256, mapper=) with a seeded
          mapper: an HTTP /edit answer, images/s at batch 16 and 64 beside
          a plain direction, the mapper's directions on the card against
          the CPU's (max |err| 1e-5), two seeds' renders within ±1
  nada    after train_parity: nada_loss (direction, global, manifold and
          the RN50 texture term) on 4 full-width FFHQ-256 renders (seeds
          1-4) and their edit by a seeded Δs, with the train phase's seeded
          ViT-B/32 and a seeded full-width RN50, forward and backward to Δs
          on the card and on the CPU: loss rtol 1e-6, Δs gradient relative
          L2 1e-3; the step's time and RN50's encode_image at batch 4
  warp    after clis: warp_images over 4 of the [orig|edited] pairs that
          generate_fromS wrote, with the landmark files, as a subprocess:
          one strip per pair, both halves and the warped original
  metrics calc_metrics (fid50k_full, kid50k_full, pr50k3_full, is50k,
          ppl2_wend) as a subprocess on the FFHQ-256 generator with seeded
          Inception v3 and LPIPS-VGG16 (--allow_random_init), 128 generated
          images against a directory of 128 PNGs the generator rendered at
          other latents, batch 16; launches counted per metric; every result
          finite and in range (FID >= 0, precision and recall in [0, 1],
          IS >= 1); card against CPU on 16 of the images: Inception's
          features in both variants (relative L2 1e-4) and LPIPS-VGG
          distances (rtol 1e-5); the metric loop's images/s, the generator's
          and Inception's alone (batch 16 and 64), PPL pairs/s, one batch's
          device split and idle share, peak memory
  lec     after the e4e phases: calculate_lec on the seeded e4e_ffhq_encode
          over its 8 photos (2 batches of 4), a seeded W+ direction added
          as the edit and subtracted as its inverse: finite
  e4e_train  before any phase traces the card: the e4e coach (Ranger,
          the latent discriminator with lazy R1, progressive stages, ID,
          L2 and LPIPS) at full width: the FFHQ-1024 generator of the
          mapper phases as the decoder, a seeded IR-SE-50 Encoder4Editing,
          the seeded ArcFace and LPIPS-alex, batch 4, fp32, TF32 off,
          Ranger at 1e-4, w_discriminator_lambda 0.1, d_reg_every 16, r1
          10, progressive stages from step 4 every 2 steps (the recipe's
          20 000 / 2 000 compressed), 36 steps over 64 seeded photos
          through train_e4e's data pipeline: steady ms/step over steps
          3-36, images/s, peak memory, the stage reached (17), R1 at steps
          0, 16 and 32, B1 and B2 8 each a step; then 4 steps with
          train_decoder and 4 with use_w_pool, losses finite.
          e4e_train_breakdown (after train): one profiled coach step's
          device time by kernel name and its idle share.
          e4e_train_parity: one R1 step at stage 7 (batch 2) on the card
          and on the CPU from the same weights, batch and z: every loss
          rtol 1e-4, the encoder's gradient relative L2 1e-3, the
          discriminator after its step and R1 relative L2 1e-5, each beside
          a TF32 control that must fail it.
          e4e_train_clis (after lec), as subprocesses: train_e4e on the 8
          e4e photos from the FFHQ-1024 .npz (--allow_random_init, 4 steps,
          saving and validating every 2): iteration_2/4, best_model and
          last .pkl, finite losses; again with --resume_training_from_ckpt
          iteration_2.pkl to step 4; calc_losses_on_images in both modes,
          the photos against infer_e4e's reconstructions, card against
          --device cpu (rtol 1e-5)
  dp_*    data parallelism (stylemc_torch.parallel) on the one card, each
          gate a fixed constant beside a TF32 control of the sharded side
          that must fail it (a gate of several bounds: at least one):
          dp_coach (after e4e_train_parity): one R1 coach step at batch 4
          over DataMesh([cuda:0, cuda:0]) against the unsharded step:
          losses rtol 1e-4, the gradient at the codes 1e-3, the
          discriminator 1e-5 (relative L2); B1 and B2 8 a shard.
          dp_train (after sweep): find_direction on the first 32 training
          seeds (8 steps) over two shards against unsharded, from d0: loss
          history rtol 1e-4, the Δs update relative L2 3e-3; B1 and B2 12
          a step; ms/step both ways (two shards of one card: not a scaling
          figure). dp_sweep: optimize_batch, 4 prompts on zoo_mesh(2) over
          [cuda:0] x 4, one step against the unsharded call at JAX's sweep
          gate (cosine > 0.99999, norms 1e-3), then 4 steps recorded.
          dp_ranks: two gloo ranks (stylemc_torch.bench.dp_ranks, each
          under a timeout) run one full-width DP step (2 rows each) against
          the full-batch step (rtol 1e-4, update 3e-3; bit-equal across the
          ranks), append_multihost and Collector(cross_process=True); two
          NCCL ranks on the card (what NCCL says is recorded); a world-size
          1 NCCL group: the all-reduce bit-exact, the step at dp_train's
          gates against no group beside a repeat, the all-reduce's time.
          dp_serve (after clis): BatchEditor(mesh=) at batch 16 against
          the unsharded editor (±1, at most 1e-3 of values off by one),
          batch 1 on the plain path, images/s both ways. dp_metrics
          (after metrics): FID, KID (rtol 1e-5) and PPL (1e-3) with mesh=
          on 64 images against the same calls without it
  verify_files  (after mapper_clis) writes verify's weight files
  tf_legacy  a TF1 (G, D, Gs) pickle of a seeded
          stylegan2-ffhq-config-f (resolution 1024, fmap_base 16384,
          fmap_max 512, 8 mapping layers, no fp16, no clamp; ToRGB weights
          scaled as the e4e decoder's) and its resnet discriminator at
          1024, written by stylemc_torch.bench.tf_pickle: load_generator
          onto the card (params bit-equal to the written ones), a batch-8
          render (B1 8) timed as images/s, 2 seeds card against CPU (±1,
          the share off by one gated at 1e-3), the discriminator's ms per
          batch of 8 and its logits card against CPU on the card's renders
          (max |Δ| / max |logit| 1e-4), each gate beside a TF32 control;
          the legacy CLI's .npz bit-equal to the loaded params
  verify  (after clis_misc) first the CPU's references, with nothing on
          the card: a CPU run of verify --write_golden_renders and the
          port's CPU find_direction on the same files and seeds 0-1 (4
          steps of 2 items); then python -m stylemc_torch verify on the
          card with every check:
          the FFHQ-256 network, the TF pickle, an e4e checkpoint at 256,
          a CLIP dir (the train phase's seeded ViT-B/32 and B/16 in the
          OpenAI names, a stand-in BPE vocabulary), its seeded IR-SE-50, a
          seeded Inception v3 (FID split of 16 a side), the deeplab
          phase's checkpoint and the landmark files' MobileNet, and the
          two references: exit 0, all_ok, PSNR >= 30 dB, cosine >= 0.99,
          each check's seconds; B1 6 a FFHQ-256 call and 8 for the TF
          network's, B2 6 a step. Its golden renders against the CPU's
          (±1, the share off by one gated at 1e-3) and its direction's
          1 - cosine to the CPU's, each beside a TF32 verify run (in
          process, TF32 in cuDNN and cuBLAS) that must fail the gate
  clis_misc  clip_filter over 16 rendered PNGs (full-width ViT-B/32 from
          the verify CLIP dir) on the card and on the CPU: kept indices
          and styles equal; python -m stylemc_torch listing the CLIs and
          dispatching compare_directions
  Every card-against-CPU gate of the mapper, DeepLab, metrics and NADA
  phases is a fixed constant, read beside a TF32 control of the card's side
  (TF32 in cuDNN and cuBLAS) that must fail it. Each phase's seconds print
  as {"phase_seconds": ...}, and all of them before the kernels line.

Each path that renders or trains (the HTTP requests, the throughput calls,
the parity render on the card, the precompute, the training steps, the
one-step parity, each CLI, and each e4e path) is driven with every
kernel's launch count set to 0 just before it and read just after; each
must show B1 launched once per upper block of each synthesis call (6 at
FFHQ-256, 8 at FFHQ-1024, 7 for a mapper step's 512 px render of
FFHQ-1024), B2 once per upper block of each backward pass (6, 7 for a
mapper step, 8 for an e4e coach step; on a mesh, once per shard), and
B3/B4/B5 never (the generator
runs the unfused layer, as the JAX generator does, with --train_decoder
too); the e4e encoder and its discriminator, the mapper network, DeepLab,
Inception, LPIPS, CLIP and the landmark nets launch none of them. Each
metric's renders are counted apart (PPL renders both ends of each pair:
two synthesis calls a batch), and so are LEC's decodes (FFHQ-1024).

Then the card's nvidia-smi line, a {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 without tensor
# cores, dense TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# TF32 products per fp32-accurate product (3xTF32: small·big, big·small,
# big·big)
TF32_PASSES = 3
KERNEL_TOL = 1e-5
CHAIN_SHAPES = [(16, 3, h, h) for h in (4, 8, 16, 32, 64, 128)]
# the 1024 px plane, and two odd shapes, the second an odd width (B1's
# 4-byte path)
EXTRA_SHAPES = [(1, 3, 512, 512), (2, 5, 6, 10), (2, 5, 7, 9)]
# with CHAIN_SHAPES, the ToRGB chain of one batch-16 FFHQ-1024 synthesis
# call (the e4e decoder's, served at max_batch 16)
E4E_CHAIN_EXTRA = [(16, 3, 256, 256), (16, 3, 512, 512)]
# B2's inputs in one training step's backward (batch 4): the cotangent of
# each upsample of the ToRGB chain
TRAIN_DOWN_SHAPES = [(4, 3, 2 * h, 2 * h) for h in (4, 8, 16, 32, 64, 128)]
# beside them the 1024 px plane and two odd output planes, 3x5 and 5x7 (B2's
# 4-byte path)
DOWN_SHAPES = TRAIN_DOWN_SHAPES + [(1, 3, 1024, 1024), (2, 5, 6, 10),
                                   (2, 5, 10, 14)]
# one mapper training step (FFHQ-1024 at 512 px, until_k 7, batch 2): B1's
# inputs in its synthesis call, B2's in its backward pass
MAPPER_UP_SHAPES = [(2, 3, h, h) for h in (4, 8, 16, 32, 64, 128, 256)]
MAPPER_DOWN_SHAPES = [(2, 3, 2 * h, 2 * h) for h in (4, 8, 16, 32, 64, 128,
                                                     256)]
# B2's inputs in one e4e coach step's backward (FFHQ-1024, batch 4): the
# training step's six, then [4,3,512²] and [4,3,1024²]
E4E_DOWN_SHAPES = [(4, 3, 2 * h, 2 * h) for h in (4, 8, 16, 32, 64, 128,
                                                  256, 512)]
# B1's inputs in one LEC decode (FFHQ-1024, batch 4), which are the e4e
# coach step's decode chain too, and, the first six,
# in the NADA step's synthesis call (FFHQ-256, batch 4); B2's in the NADA
# step's backward are TRAIN_DOWN_SHAPES
LEC_UP_SHAPES = [(4, 3, h, h) for h in (4, 8, 16, 32, 64, 128, 256, 512)]
NADA_UP_SHAPES = LEC_UP_SHAPES[:6]
# B1 and B2 on an input that starts 4 bytes past an aligned allocation (the
# wrapper takes the 4-byte path for it)
OFFSET_SHAPE = (2, 5, 6, 10)
# B1's and B2's aim per launch: the launch floor plus this many times the
# bound (recorded beside each row, not a gate)
AIM_BOUND_FACTOR = 1.5
GRAD_SHAPES = [(4, 3, 16, 16), (4, 3, 128, 128)]
GRAD_TOL = 1e-5
TRAIN_SEEDS = 129
PARITY_LOSS_RTOL = 1e-4
PARITY_GRAD_REL_L2 = 1e-3
# random-weight seeds of the perception models (utils/model_zoo.py's, so
# find_direction's --allow_random_init builds the same networks)
CLIP_SEEDS = {"ViT-B/32": 0, "ViT-B/16": 1}
ARCFACE_SEED = 42


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def upsample_bound(shape):
    """(ms, 'bytes' | 'operations'): the least time an H100 takes for the
    2x upsample of `shape` — each input read once (4 B/elem), each output
    written once (16 B per input elem), 18 flops per input element (two
    2-tap passes at 3 flops per produced value)."""
    n, c, h, w = shape
    elems = n * c * h * w
    t_bytes = 20 * elems / HBM_BYTES_PER_S
    t_ops = 18 * elems / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def downsample_bound(shape):
    """(ms, 'bytes' | 'operations'): the least time an H100 takes for the
    2x downsample of an input of `shape` — each input read once (4 B/elem),
    each output written once (1 B per input elem), 24 flops per output
    (6 per input element) in the separable form."""
    n, c, h, w = shape
    elems = n * c * h * w
    t_bytes = 5 * elems / HBM_BYTES_PER_S
    t_ops = 6 * elems / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def synthesis_flop(cfg, useful: bool = False) -> int:
    """Flops (2 per multiply-add) of one image's synthesis call, in the
    up-conv form `cfg` runs. conv1 is 3x3, torgb 1x1. Each conv0 is the 3x3
    kernel composed with the 4x4 FIR (6x6): pad_dilate runs it over the
    zero-stuffed input at full resolution, 36 taps per output pixel;
    polyphase (the default), and any form with `useful`, only the taps
    that meet a non-zero input, 9 per output pixel."""
    conv0_taps = 36 if cfg.up_conv_impl == "pad_dilate" and not useful else 9
    total = 0
    for res in cfg.block_resolutions:
        c_out = cfg.channels(res)
        c_in = cfg.channels(res // 2) if res > 4 else c_out
        if res > 4:
            total += 2 * conv0_taps * c_in * c_out * res * res
        total += 2 * 9 * c_out * c_out * res * res
        total += 2 * c_out * cfg.img_channels * res * res
    return total


def library_weight(taps, channels, device):
    """The depthwise [C, 1, 4, 4] weight of `library_upsample`: the outer
    product of the reversed taps."""
    import torch

    t = torch.tensor(taps[::-1], dtype=torch.float32, device=device)
    return torch.outer(t, t)[None, None].repeat(channels, 1, 1, 1)


def library_upsample(x, weight):
    """One PyTorch call computing the same function: a depthwise transposed
    convolution. A yardstick only; the port never calls it."""
    import torch.nn.functional as F

    return F.conv_transpose2d(x, weight, stride=2, padding=1,
                              groups=x.shape[1])


def library_downsample(x, weight):
    """One PyTorch call computing the 2x downsample: a depthwise strided
    convolution; `weight` is `library_weight` of the reversed taps. A
    yardstick only; the port never calls it."""
    import torch.nn.functional as F

    return F.conv2d(x, weight, stride=2, padding=1, groups=x.shape[1])


def event_ms(fn, iters=50, warmup=5) -> float:
    """Mean time per call between CUDA events over `iters` back-to-back
    calls: includes the host's cost where it exceeds the device's."""
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
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phases


def phase_env(torch):
    from stylemc_torch.bench.timing import nvidia_smi_line

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "env", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "note": "TF32 off for the fp32 policy"})
    return smi


UPFIRDN_KERNELS = ("upsample2x", "downsample2x")
MODCONV_KERNELS = ("modconv_fwd", "modconv_bwd_data", "modconv_bwd_weight")
KERNEL_NAMES = UPFIRDN_KERNELS + MODCONV_KERNELS


def _kernel_module(name):
    from stylemc_torch.ops.kernels import modconv, upfirdn2d

    return modconv if name in MODCONV_KERNELS else upfirdn2d


def phase_build():
    """Build every kernel library, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from stylemc_torch.ops.kernels.build import library_dir

    def build(name):
        t0 = time.perf_counter()
        _kernel_module(name)._library(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_NAMES)) as pool:
        seconds = dict(zip(KERNEL_NAMES, pool.map(build, KERNEL_NAMES)))
    ptxas = {}
    for name in KERNEL_NAMES:
        sources = _kernel_module(name).SOURCES[name]
        log = (library_dir(sources) / "build.log").read_text()
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "seconds_by_kernel": seconds, "ptxas": ptxas})


def _kernel_rows(torch, name, shapes, kernel, launch, plain, taps, bound,
                 library, weight_taps, plan, floor_ms):
    """Hold one kernel against its plain version at `shapes` and time the
    kernel, the plain version and the library call (device time), and the
    wrapper (host cost included). Each row carries the kernel's launch plan
    (`plan(shape)`), the launch floor and the aim, floor + 1.5 x bound."""
    from stylemc_torch.bench.timing import device_ms
    from stylemc_torch.ops import setup_filter_np

    f = setup_filter_np([1, 3, 3, 1])
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in shapes:
        x = torch.randn(shape, generator=gen, device="cuda")
        weight = library_weight(weight_taps, shape[1], "cuda")
        got = kernel(x, f)
        want = plain(x, taps)
        lib = library(x, weight)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        lib_err = float((lib - want).abs().max())
        bound_ms, bound_by = bound(shape)
        fns = {"kernel": lambda: launch(x, taps),
               "plain": lambda: plain(x, taps),
               "library": lambda: library(x, weight)}
        p = plan(shape)
        row = {"shape": list(shape), "max_abs_err": err,
               "library_max_abs_err": lib_err,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "launch_floor_ms": floor_ms,
               "aim_ms": floor_ms + AIM_BOUND_FACTOR * bound_ms,
               "plan": {"block": p.block, "grid": p.grid,
                        "rows": p.rows, "vector": p.vector}}
        for key, fn in fns.items():
            row[f"{key}_ms"] = device_ms(fn)
        row["within_aim"] = row["kernel_ms"] <= row["aim_ms"]
        row["wrapper_event_ms"] = event_ms(lambda: kernel(x, f))
        emit({"phase": "kernel", "kernel": name, **row})
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {shape}: {err} > {KERNEL_TOL}")
        if not lib_err <= KERNEL_TOL:
            raise AssertionError(f"{name}'s library yardstick computes "
                                 f"another function at {shape}: {lib_err}")
        rows.append(row)
    return rows


def _offset_rows(torch, f, ops):
    """B1 and B2 on an input that starts 4 bytes past an aligned allocation
    (`OFFSET_SHAPE`), each against its plain version: one launch each."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = _offset_view(torch, torch.randn(OFFSET_SHAPE, generator=gen,
                                        device="cuda"))
    for name, (kernel, plain) in ops.items():
        err = float((kernel(x, f) - plain(x)).abs().max())
        emit({"phase": "kernel", "kernel": name, "case": "x_offset",
              "shape": list(OFFSET_SHAPE), "max_abs_err": err})
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on an offset input: {err}")


def phase_kernel(torch):
    """The launch floor (an empty kernel, `stylemc_torch.bench.launch_floor`),
    then B1 and B2 at their shapes, and on an offset input."""
    from stylemc_torch.bench.launch_floor import launch_floor_ms
    from stylemc_torch.ops import setup_filter_np
    from stylemc_torch.ops.kernels.upfirdn2d import (
        _canonical_taps, downsample2d_kernel, downsample2d_plain,
        downsample_plan, launch_downsample, launch_upsample,
        upsample2d_kernel, upsample2d_plain, upsample_plan)

    floor_ms = launch_floor_ms("cuda")
    emit({"phase": "kernel", "launch_floor_ms": floor_ms})
    f = setup_filter_np([1, 3, 3, 1])
    up_taps = _canonical_taps(f, 4.0, False)
    down_taps = _canonical_taps(f, 1.0, False)
    _offset_rows(torch, f, {
        "upsample2x": (upsample2d_kernel,
                       lambda x: upsample2d_plain(x, up_taps)),
        "downsample2x": (downsample2d_kernel,
                         lambda x: downsample2d_plain(x, down_taps))})
    return floor_ms, {
        "upsample2x": _kernel_rows(
            torch, "upsample2x",
            CHAIN_SHAPES + E4E_CHAIN_EXTRA + EXTRA_SHAPES + MAPPER_UP_SHAPES
            + LEC_UP_SHAPES,
            upsample2d_kernel, launch_upsample, upsample2d_plain, up_taps,
            upsample_bound, library_upsample, up_taps,
            lambda s: upsample_plan(s[0] * s[1], s[2], s[3]), floor_ms),
        "downsample2x": _kernel_rows(
            torch, "downsample2x",
            DOWN_SHAPES + MAPPER_DOWN_SHAPES + E4E_DOWN_SHAPES[6:],
            downsample2d_kernel,
            launch_downsample, downsample2d_plain, down_taps,
            downsample_bound, library_downsample, down_taps[::-1],
            lambda s: downsample_plan(s[0] * s[1], s[2], s[3]),
            floor_ms),
    }


def phase_grad(torch):
    """First- and second-order gradients through both kernels on the card
    against the same computation through the plain versions (plain torch
    ops, differentiated by autograd)."""
    from stylemc_torch.ops import setup_filter_np
    from stylemc_torch.ops.kernels.upfirdn2d import (
        _canonical_taps, downsample2d_kernel, downsample2d_plain,
        upsample2d_kernel, upsample2d_plain)

    f = setup_filter_np([1, 3, 3, 1])
    ops = {"upsample2x": (lambda x: upsample2d_kernel(x, f),
                          lambda x: upsample2d_plain(
                              x, _canonical_taps(f, 4.0, False))),
           "downsample2x": (lambda x: downsample2d_kernel(x, f),
                            lambda x: downsample2d_plain(
                                x, _canonical_taps(f, 1.0, False)))}
    gen = torch.Generator(device="cuda").manual_seed(1)

    def grads(fn, x0):
        x = x0.clone().requires_grad_(True)
        g, = torch.autograd.grad(torch.sum(fn(x) ** 2), x, create_graph=True)
        h, = torch.autograd.grad(torch.sum(g ** 2), x)
        return g.detach(), h

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    rows = []
    for name, (kernel, plain) in ops.items():
        for shape in GRAD_SHAPES:
            x = torch.randn(shape, generator=gen, device="cuda")
            (g_k, h_k), counts = count_launches(lambda: grads(kernel, x))
            g_p, h_p = grads(plain, x)
            row = {"op": name, "shape": list(shape),
                   "first_order_rel_l2": rel(g_k, g_p),
                   "second_order_rel_l2": rel(h_k, h_p), "launches": counts}
            emit({"phase": "grad", **row})
            # forward, backward, and the double backward through both
            if counts != {"upsample2x": 2, "downsample2x": 2,
                          **{k: 0 for k in MODCONV_KERNELS}}:
                raise AssertionError(f"grad {name} {shape}: launches {counts}")
            if not max(row["first_order_rel_l2"],
                       row["second_order_rel_l2"]) <= GRAD_TOL:
                raise AssertionError(f"grad {name} {shape}: {row}")
            rows.append(row)
    return rows


# B3: max |Δ| over max(1, max |y_plain|); B4/B5 outputs and the fused
# Function's gradients: relative L2
MODCONV_FWD_TOL = 2e-5
MODCONV_REL_L2 = 1e-5
# (name, batch, C_in, C_out, H, W, x scale): the odd shape, and one where
# the clamp binds (x·600), beside the full-width conv1 shapes
MODCONV_EXTRA = [("odd", 3, 16, 8, 24, 20, 1.0),
                 ("clamp", 4, 512, 512, 16, 16, 600.0)]
# B5 alone at the edges of its tiling, beside the odd shape (CO 8 < one
# fragment's 16 rows, W 20): (name, batch, C_in, C_out, H, W, x not 16-byte
# aligned). CI and CO not multiples of the 32 x 64 block tile; a 4x4 plane;
# W % 4 != 0 and a misaligned x, both on the kernel's 4-byte copies.
MODCONV_DW_RAGGED = [("ci40_co72", 2, 40, 72, 12, 12, False),
                     ("plane4_c96", 3, 96, 80, 4, 4, False),
                     ("w13", 2, 24, 16, 9, 13, False),
                     ("x_offset", 2, 32, 64, 8, 16, True)]
# B3 alone at the edges of its tiling, the same kinds: CI and CO not
# multiples of its 8-channel chunk and 64-channel tile, a 4x4 plane with C
# 96 (CI split), W % 4 != 0 and a misaligned x (its 4-byte copies)
MODCONV_FWD_RAGGED = [("ci40_co72", 2, 40, 72, 12, 12, False),
                      ("plane4_c96", 3, 96, 96, 4, 4, False),
                      ("w13", 2, 24, 16, 9, 13, False),
                      ("x_offset", 2, 32, 64, 8, 16, True)]
# B4 alone at the edges of its tiling (its M tiles are 64 input channels,
# its K chunks 8 output channels): CI not a multiple of 64 and CO not one of
# 8 (split over CO); CO below one chunk; a 4x4 plane with C 96 (CO split);
# W = 13 (4-byte copies of dz); and, unsplit, dy, y and x as views at a
# 4-byte offset (the last field)
MODCONV_DX_RAGGED = [("ci72_co36", 2, 72, 36, 12, 12, False),
                     ("co5", 2, 16, 5, 6, 10, False),
                     ("plane4_c96", 3, 96, 96, 4, 4, False),
                     ("w13", 2, 24, 16, 9, 13, False),
                     ("views_offset", 4, 72, 24, 36, 36, True)]


def modconv_bound(name, n, ci, co, h, w):
    """The least time an H100 takes for kernel `name` at these shapes:
    `bound_ms`, the larger of its bytes (each input read once and each
    output written once, 4 B an element, at the HBM rate) and its 3x3
    contraction's flops (2 per multiply-add, `flop`) done in 3xTF32 on the
    tensor cores (three TF32 products per product at the TF32 rate, which
    keeps fp32's accuracy); `bound_by` says which. Beside it
    `fp32_fma_bound_ms`, the same work in fp32 FMAs (the CUDA cores), and
    the two sides of the bound, `bytes_ms` and `ops_ms`."""
    hw = h * w
    flop = 2 * n * ci * co * 9 * hw
    elems = {
        # x, w, s, d, noise, bias in; y out
        "modconv_fwd": n * ci * hw + 9 * ci * co + n * ci + n * co + hw + co
        + n * co * hw,
        # dy, y, x, w, s, d, noise, bias in; dx, ds, dd, db out
        "modconv_bwd_data": 2 * n * co * hw + n * ci * hw + 9 * ci * co
        + n * ci + n * co + hw + co + n * ci * hw + n * ci + 2 * n * co,
        # dy, y, x, s, d in; dW out
        "modconv_bwd_weight": 2 * n * co * hw + n * ci * hw + n * ci + n * co
        + 9 * ci * co,
    }[name]
    t_bytes = 4 * elems / HBM_BYTES_PER_S * 1e3
    t_ops = TF32_PASSES * flop / TF32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flop": flop,
            "fp32_fma_bound_ms": max(t_bytes, flop / FP32_FLOP_PER_S * 1e3),
            "bytes_ms": t_bytes, "ops_ms": t_ops}


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def phase_modconv(torch):
    """B3, B4 and B5 against their plain versions at every full-width
    FFHQ-256 conv1 shape (batch 4; B3 at batch 16 too), an odd shape and a
    clamp-binding case; device times of each kernel, its plain version and
    a library yardstick at the conv1 shapes; then the fused Function's
    gradients on the card against autograd through the plain forward."""
    from stylemc_torch.bench.fused_layer_ab import (
        CLAMP, GAIN, layer_shapes, make_inputs, unfused_layer)
    from stylemc_torch.bench.timing import device_ms_for
    from stylemc_torch.ops.kernels import modconv as mc

    cases = [(f"b{res}", 4, c, c, res, res, 1.0) for c, res in layer_shapes()]
    cases += [(f"b{res}_n16", 16, c, c, res, res, 1.0)
              for c, res in layer_shapes()]
    cases += MODCONV_EXTRA
    rows = {name: [] for name in MODCONV_KERNELS}
    for case, n, ci, co, h, w, scale in cases:
        inp = make_inputs(n, ci, co, h, w, "cuda", seed=7)
        x, wt, s, noise, b = (inp[k] for k in ("x", "w", "s", "noise", "b"))
        x = x * scale
        d, _ = mc.dcoefs(wt, s)
        timed = case.startswith("b")
        shape = {"case": case, "n": n, "ci": ci, "co": co, "h": h, "w": w,
                 "x_scale": scale}

        def fwd_k():
            return mc.launch_fwd(x, wt, s, d, noise, b, GAIN, CLAMP)

        def fwd_p():
            return mc.fused_layer_fwd_plain(x, wt, s, d, noise, b, GAIN, CLAMP)

        y_k, y_p = fwd_k(), fwd_p()
        ymax = float(y_p.abs().max())
        err = float((y_k - y_p).abs().max())
        row = {**shape, "max_abs_err": err, "max_abs_y": ymax,
               "gate_max_abs_y": MODCONV_FWD_TOL * max(1.0, ymax),
               "plan": _fwd_plan(mc, n, ci, co, h, w)}
        row["gate"] = row["gate_max_abs_y"]
        if scale != 1.0:
            # where the clamp binds, the sums run far past ±256: the error
            # of an fp32 sum scales with its terms, which the clamp hides
            # from max|y|; float64 shows which side is off
            z_p = mc.fused_layer_fwd_plain(x, wt, s, d, noise, b, GAIN, None)
            y64 = mc.fused_layer_fwd_plain(
                x.double(), wt.double(), s.double(), mc.dcoefs(
                    wt.double(), s.double())[0], noise.double(), b.double(),
                GAIN, CLAMP)
            row.update({
                "max_abs_preclamp": float(z_p.abs().max()),
                "kernel_err_vs_fp64": float((y_k.double() - y64).abs().max()),
                "plain_err_vs_fp64": float((y_p.double() - y64).abs().max()),
                "elements_over_gate_max_abs_y": int(
                    ((y_k - y_p).abs() > row["gate_max_abs_y"]).sum()),
                "gate_unclamped_scale": MODCONV_FWD_TOL * max(
                    1.0, float(z_p.abs().max()))})
            row["gate"] = row["gate_unclamped_scale"]
        if timed:
            row.update({
                "kernel_ms": device_ms_for(fwd_k),
                "plain_ms": device_ms_for(fwd_p),
                "library_ms": device_ms_for(lambda: unfused_layer(
                    x, wt, s, noise, b)),
                **modconv_bound("modconv_fwd", n, ci, co, h, w)})
            row["kernel_tflop_per_s"] = row["flop"] / row["kernel_ms"] / 1e9
        emit({"phase": "modconv", "kernel": "modconv_fwd", **row})
        if not err <= row["gate"]:
            raise AssertionError(f"modconv_fwd disagrees with its plain "
                                 f"version: {row}")
        rows["modconv_fwd"].append(row)
        if n == 16:
            continue

        dy = torch.randn(y_p.shape, generator=torch.Generator(
            device="cuda").manual_seed(11), device="cuda")

        def bwd_k():
            return mc.launch_bwd_data(dy, y_p, x, wt, s, d, noise, b, GAIN,
                                      CLAMP)

        def bwd_p():
            return mc.fused_layer_bwd_data_plain(dy, y_p, x, wt, s, d, noise,
                                                 b, GAIN, CLAMP)

        def dw_k():
            return mc.launch_bwd_weight(dy, y_p, x, s, d, GAIN, CLAMP)

        def dw_p():
            return mc.fused_layer_bwd_weight_plain(dy, y_p, x, s, d, GAIN,
                                                   CLAMP)

        got, want = bwd_k(), bwd_p()
        errs = {k: _rel_l2(a, p) for k, a, p in zip(
            ("dx", "ds_direct", "dd", "db"), got, want)}
        row = {**shape, "rel_l2": errs, "max_rel_l2": max(errs.values()),
               "max_abs_err": max(float((a - p).abs().max())
                                  for a, p in zip(got, want)),
               "plan": _dx_plan(mc, n, ci, co, h, w)}
        dz_d = dy * mc._act_grad(y_p, GAIN, CLAMP) * d[:, :, None, None]
        x_s = x * s[:, :, None, None]
        got, want = dw_k(), dw_p()
        dw_row = {**shape, "max_rel_l2": _rel_l2(got, want),
                  "max_abs_err": float((got - want).abs().max()),
                  "max_abs_dw": float(want.abs().max()),
                  "plan": _dw_plan(mc, n, ci, co, h, w)}
        del got, want
        if timed:
            xr = x.detach().requires_grad_(True)
            sr = s.detach().requires_grad_(True)
            y_u = unfused_layer(xr, wt, sr, noise, b)
            for r, name, k_fn, p_fn, lib in (
                    (row, "modconv_bwd_data", bwd_k, bwd_p,
                     lambda: torch.autograd.grad(y_u, (xr, sr), dy,
                                                 retain_graph=True)),
                    (dw_row, "modconv_bwd_weight", dw_k, dw_p,
                     lambda: torch.nn.grad.conv2d_weight(
                         x_s, wt.shape, dz_d, padding=1))):
                r.update({"kernel_ms": device_ms_for(k_fn),
                          "plain_ms": device_ms_for(p_fn),
                          "library_ms": device_ms_for(lib),
                          **modconv_bound(name, n, ci, co, h, w)})
                r["kernel_tflop_per_s"] = r["flop"] / r["kernel_ms"] / 1e9
            del y_u, xr, sr
        dw_row["library_rel_l2"] = _rel_l2(torch.nn.grad.conv2d_weight(
            x_s, wt.shape, dz_d, padding=1), dw_p())
        for name, r in (("modconv_bwd_data", row),
                        ("modconv_bwd_weight", dw_row)):
            emit({"phase": "modconv", "kernel": name, **r})
            if not r["max_rel_l2"] <= MODCONV_REL_L2:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {r}")
            rows[name].append(r)
        del dz_d, x_s
    rows["modconv_fwd"] += modconv_fwd_ragged(torch)
    rows["modconv_bwd_weight"] += modconv_dw_ragged(torch)
    rows["modconv_bwd_data"] += modconv_dx_ragged(torch)
    modconv_bf16(torch)
    torch.cuda.empty_cache()
    return rows, phase_modconv_grad(torch)


def _dw_plan(mc, n, ci, co, h, w):
    plan = mc.bwd_weight_plan(n, ci, co, h, w, mc._sm_count(0))
    return {"splits": plan.splits, "chunk_cols": plan.chunk_cols,
            "blocks": plan.tiles_co * plan.tiles_ci * plan.splits,
            "units": plan.units}


def _fwd_plan(mc, n, ci, co, h, w):
    plan = mc.fwd_plan(n, ci, co, h, w, mc._sm_count(0))
    return {"splits": plan.splits, "chunk_cols": plan.chunk_cols,
            "blocks": plan.blocks, "units": plan.units}


def _dx_plan(mc, n, ci, co, h, w):
    """B4's plan: B3's with CI and CO swapped (splits cut CO)."""
    return _fwd_plan(mc, n, co, ci, h, w)


def _offset_view(torch, t):
    """A copy of `t` whose data starts 4 bytes past an aligned allocation,
    so the kernels take their 4-byte copy paths."""
    return torch.empty(t.numel() + 1, device=t.device)[1:].view_as(
        t).copy_(t)


def _fwd_gate(mc, x, wt, s, d, noise, b, y_p):
    """B3's gate: 2e-5·max(1, max|y|), max|y| taken before the clamp."""
    from stylemc_torch.bench.fused_layer_ab import GAIN

    z = mc.fused_layer_fwd_plain(x, wt, s, d, noise, b, GAIN, None)
    return MODCONV_FWD_TOL * max(1.0, float(y_p.abs().max()),
                                 float(z.abs().max()))


def modconv_fwd_ragged(torch):
    """B3 against its plain version at `MODCONV_FWD_RAGGED` under its gate,
    one counted call each."""
    from stylemc_torch.bench.fused_layer_ab import CLAMP, GAIN, make_inputs
    from stylemc_torch.ops.kernels import modconv as mc

    rows = []
    for case, n, ci, co, h, w, misaligned in MODCONV_FWD_RAGGED:
        inp = make_inputs(n, ci, co, h, w, "cuda", seed=8)
        x, wt, s, noise, b = (inp[k] for k in ("x", "w", "s", "noise", "b"))
        if misaligned:
            x = _offset_view(torch, x)
        d, _ = mc.dcoefs(wt, s)
        before = mc.launch_fwd.launches
        got = mc.launch_fwd(x, wt, s, d, noise, b, GAIN, CLAMP)
        launched = mc.launch_fwd.launches - before
        want = mc.fused_layer_fwd_plain(x, wt, s, d, noise, b, GAIN, CLAMP)
        row = {"case": case, "n": n, "ci": ci, "co": co, "h": h, "w": w,
               "x_data_ptr_mod_16": x.data_ptr() % 16,
               "max_abs_err": float((got - want).abs().max()),
               "gate": _fwd_gate(mc, x, wt, s, d, noise, b, want),
               "launches": launched, "plan": _fwd_plan(mc, n, ci, co, h, w)}
        emit({"phase": "modconv", "kernel": "modconv_fwd", **row})
        if launched != 1:
            raise AssertionError(f"modconv_fwd {case}: {launched} launches")
        if not row["max_abs_err"] <= row["gate"]:
            raise AssertionError(f"modconv_fwd disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


def modconv_bf16(torch):
    """`fused_modulated_layer` with a bf16 x on the card: y in bf16, B3
    launched once, y within one bf16 step of the plain version (in fp32)
    elementwise, beside B3's fp32 gate: near 0 a bf16 step is far below
    the fp32 sums' own error."""
    from stylemc_torch.bench.fused_layer_ab import CLAMP, GAIN, make_inputs
    from stylemc_torch.ops.kernels import modconv as mc

    n, c, res = 4, 512, 16
    inp = make_inputs(n, c, c, res, res, "cuda", seed=9)
    x, wt, s, noise, b = (inp[k] for k in ("x", "w", "s", "noise", "b"))
    xb = x.bfloat16()
    y, launches = count_launches(lambda: mc.fused_modulated_layer(
        xb, wt, s, noise, b, gain=GAIN, clamp=CLAMP))
    d, _ = mc.dcoefs(wt, s)
    want = mc.fused_layer_fwd_plain(xb.float(), wt, s, d, noise, b, GAIN,
                                    CLAMP)
    step = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -126))) - 7)
    gate = _fwd_gate(mc, xb.float(), wt, s, d, noise, b, want)
    # bf16 steps past the fp32 gate
    steps = ((y.float() - want).abs() - gate).clamp_min(0.0) / step
    row = {"case": f"bf16_x_b{res}", "n": n, "ci": c, "co": c, "h": res,
           "w": res, "dtype": str(y.dtype).replace("torch.", ""),
           "max_abs_err": float((y.float() - want).abs().max()),
           "fp32_gate": gate, "max_bf16_steps_past_gate": float(steps.max()),
           "elements_off_by_one_step": int((steps > 0.5).sum()),
           "launches": launches}
    emit({"phase": "modconv", "kernel": "modconv_fwd", **row})
    if y.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 x gave y in {y.dtype}")
    if launches["modconv_fwd"] != 1 or any(
            v for k, v in launches.items() if k != "modconv_fwd"):
        raise AssertionError(f"bf16 fused layer: launches {launches}")
    if not row["max_bf16_steps_past_gate"] <= 1.0:
        raise AssertionError(f"bf16 fused layer off the plain version: {row}")


def modconv_dw_ragged(torch):
    """B5 against its plain version at `MODCONV_DW_RAGGED` (relative L2 <=
    1e-5), one launch each."""
    from stylemc_torch.bench.fused_layer_ab import CLAMP, GAIN, make_inputs
    from stylemc_torch.ops.kernels import modconv as mc

    rows = []
    for case, n, ci, co, h, w, misaligned in MODCONV_DW_RAGGED:
        inp = make_inputs(n, ci, co, h, w, "cuda", seed=5)
        x, wt, s, noise, b = (inp[k] for k in ("x", "w", "s", "noise", "b"))
        if misaligned:
            x = _offset_view(torch, x)
        d, _ = mc.dcoefs(wt, s)
        y = mc.fused_layer_fwd_plain(x, wt, s, d, noise, b, GAIN, CLAMP)
        dy = torch.randn(y.shape, generator=torch.Generator(
            device="cuda").manual_seed(6), device="cuda")
        before = mc.launch_bwd_weight.launches
        got = mc.launch_bwd_weight(dy, y, x, s, d, GAIN, CLAMP)
        want = mc.fused_layer_bwd_weight_plain(dy, y, x, s, d, GAIN, CLAMP)
        row = {"case": case, "n": n, "ci": ci, "co": co, "h": h, "w": w,
               "x_data_ptr_mod_16": x.data_ptr() % 16,
               "max_rel_l2": _rel_l2(got, want),
               "max_abs_err": float((got - want).abs().max()),
               "plan": _dw_plan(mc, n, ci, co, h, w)}
        emit({"phase": "modconv", "kernel": "modconv_bwd_weight", **row})
        if mc.launch_bwd_weight.launches != before + 1:
            raise AssertionError(f"modconv_bwd_weight {case}: not launched")
        if not row["max_rel_l2"] <= MODCONV_REL_L2:
            raise AssertionError(f"modconv_bwd_weight disagrees with its "
                                 f"plain version: {row}")
        rows.append(row)
    return rows


def modconv_dx_ragged(torch):
    """B4 against its plain version at `MODCONV_DX_RAGGED` (relative L2 <=
    1e-5 on every output), one counted call each."""
    from stylemc_torch.bench.fused_layer_ab import CLAMP, GAIN, make_inputs
    from stylemc_torch.ops.kernels import modconv as mc

    rows = []
    for case, n, ci, co, h, w, misaligned in MODCONV_DX_RAGGED:
        inp = make_inputs(n, ci, co, h, w, "cuda", seed=10)
        x, wt, s, noise, b = (inp[k] for k in ("x", "w", "s", "noise", "b"))
        d, _ = mc.dcoefs(wt, s)
        y = mc.fused_layer_fwd_plain(x, wt, s, d, noise, b, GAIN, CLAMP)
        dy = torch.randn(y.shape, generator=torch.Generator(
            device="cuda").manual_seed(14), device="cuda")
        if misaligned:
            dy, y, x = (_offset_view(torch, t) for t in (dy, y, x))
        before = mc.launch_bwd_data.launches
        got = mc.launch_bwd_data(dy, y, x, wt, s, d, noise, b, GAIN, CLAMP)
        launched = mc.launch_bwd_data.launches - before
        want = mc.fused_layer_bwd_data_plain(dy, y, x, wt, s, d, noise, b,
                                             GAIN, CLAMP)
        errs = {k: _rel_l2(a, p) for k, a, p in zip(
            ("dx", "ds_direct", "dd", "db"), got, want)}
        row = {"case": case, "n": n, "ci": ci, "co": co, "h": h, "w": w,
               "data_ptr_mod_16": {k: t.data_ptr() % 16 for k, t in (
                   ("dy", dy), ("y", y), ("x", x))},
               "rel_l2": errs, "max_rel_l2": max(errs.values()),
               "max_abs_err": max(float((a - p).abs().max())
                                  for a, p in zip(got, want)),
               "launches": launched, "plan": _dx_plan(mc, n, ci, co, h, w)}
        emit({"phase": "modconv", "kernel": "modconv_bwd_data", **row})
        if launched != 1:
            raise AssertionError(f"modconv_bwd_data {case}: {launched} "
                                 f"launches")
        if not row["max_rel_l2"] <= MODCONV_REL_L2:
            raise AssertionError(f"modconv_bwd_data disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


def phase_modconv_grad(torch):
    """Gradients of the fused layer (x, w, styles, bias) on the card, through
    B3/B4/B5, against autograd through the plain forward, at the odd shape,
    the clamp case and the smallest and largest conv1 planes.

    The gate holds them against the plain forward run in float64: in fp32,
    that reference's own weight and style gradients are 1.2e-5 off float64
    at the 256² layer, where the fused layer's are 1.6e-6 (ROADMAP §C). The
    cotangent is zeroed where the forwards take other branches of the
    piecewise activation (`activation_flips`). The errors against the fp32
    plain forward, with the full cotangent too, and the number of such
    elements are recorded beside it."""
    from stylemc_torch.bench.fused_layer_ab import (
        CLAMP, GAIN, activation_flips, make_inputs)
    from stylemc_torch.ops.kernels import modconv as mc

    rows = []
    for case, n, ci, co, h, w, scale in MODCONV_EXTRA + [
            ("b4", 4, 512, 512, 4, 4, 1.0),
            ("b256", 4, 128, 128, 256, 256, 1.0)]:
        inp = make_inputs(n, ci, co, h, w, "cuda", seed=12)
        x, wt, s, noise, b = (inp[k] for k in ("x", "w", "s", "noise", "b"))
        x = x * scale
        cot = torch.randn((n, co, h, w), generator=torch.Generator(
            device="cuda").manual_seed(13), device="cuda")

        def grads(kind, cot):
            dtype = torch.float64 if kind == "fp64" else torch.float32
            leaves = [t.detach().to(dtype).requires_grad_(True)
                      for t in (x, wt, s, b)]
            if kind == "fused":
                y = mc.fused_modulated_layer(leaves[0], leaves[1], leaves[2],
                                             noise, leaves[3], gain=GAIN,
                                             clamp=CLAMP)
            else:
                d, _ = mc.dcoefs(leaves[1], leaves[2])
                y = mc.fused_layer_fwd_plain(
                    leaves[0], leaves[1], leaves[2], d, noise.to(dtype),
                    leaves[3], GAIN, CLAMP)
            return (y.detach(),
                    *torch.autograd.grad(y, leaves, cot.to(dtype)))

        names = ("dx", "dw", "ds", "db")
        (y_k, *got), launches = count_launches(lambda: grads("fused", cot))
        y_p, *want = grads("plain", cot)
        full = {k: _rel_l2(g, p) for k, g, p in zip(names, got, want)}
        # decisions compared in float64: a float64 output within an fp32
        # ulp of ±clamp rounds onto the boundary
        y64 = grads("fp64", cot)[0]
        flips = (activation_flips(y_k.double(), y64)
                 | activation_flips(y_p.double(), y64))
        masked = cot.masked_fill(flips, 0.0)
        _, *got = grads("fused", masked)
        _, *want = grads("plain", masked)
        _, *exact = grads("fp64", masked)
        errs = {k: _rel_l2(g.double(), e) for k, g, e in zip(names, got,
                                                             exact)}
        row = {"case": case, "n": n, "ci": ci, "co": co, "h": h, "w": w,
               "x_scale": scale, "rel_l2_to_fp64": errs,
               "plain_rel_l2_to_fp64": {
                   k: _rel_l2(p.double(), e)
                   for k, p, e in zip(names, want, exact)},
               "rel_l2_to_plain": {k: _rel_l2(g, p) for k, g, p in zip(
                   names, got, want)},
               "activation_flips": int(flips.sum()),
               "rel_l2_to_plain_full_cotangent": full, "launches": launches}
        emit({"phase": "modconv_grad", **row})
        if launches != {"upsample2x": 0, "downsample2x": 0, "modconv_fwd": 1,
                        "modconv_bwd_data": 1, "modconv_bwd_weight": 1}:
            raise AssertionError(f"modconv_grad {case}: launches {launches}")
        if not max(errs.values()) <= MODCONV_REL_L2:
            raise AssertionError(f"modconv_grad {case}: {row}")
        rows.append(row)
    return rows


def phase_ab(torch, smi, paths):
    """The fused-layer A/B (`stylemc_torch.bench.fused_layer_ab`) at every
    full-width conv1, each mode's B3/B4/B5 launches counted from 0 and held
    to its per-call counts."""
    from stylemc_torch.bench import fused_layer_ab as ab

    totals = {}
    for mode in ab.MODES:
        (rows, total, calls), launches = count_launches(
            lambda: ab.run_mode(mode, "cuda"))
        for row in rows:
            emit({"phase": "ab", **row})
        emit({"phase": "ab_total", "card": smi, "fused_calls": calls,
              "launches": launches, **total})
        want = {"upsample2x": 0, "downsample2x": 0,
                **{k: calls * per for k, per in zip(MODCONV_KERNELS,
                                                    mode.launches)}}
        if launches != want:
            raise AssertionError(f"ab {mode.name}: launches {launches} over "
                                 f"{calls} fused calls, not {want}")
        paths[f"ab_{mode.name}"] = {"launches": launches,
                                    "fused_calls": calls}
        totals[mode.name] = total
    torch.cuda.empty_cache()
    return totals


def _get(url):
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _decode(body):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def make_network(torch, tmp):
    """Full-width FFHQ-256 generator with random weights from seed 0, saved
    as a native .npz, and a seeded direction npz."""
    import numpy as np

    from stylemc_torch.io import save_native
    from stylemc_torch.models.stylegan2.generator import (
        S_TRAINABLE_SPACE_CHANNELS, GeneratorConfig, init_generator_params)

    cfg = GeneratorConfig(img_resolution=256)
    params = init_generator_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    net = os.path.join(tmp, "ffhq256_seed0.npz")
    save_native(net, cfg, params)
    d = np.zeros((1, 26, 512), np.float32)
    rng = np.random.RandomState(1)
    for row in S_TRAINABLE_SPACE_CHANNELS:
        d[:, row] = rng.randn(512).astype(np.float32) * 0.5
    direction = os.path.join(tmp, "direction_d0.npz")
    np.savez(direction, s=d)
    return cfg, net, direction


def launch_counters():
    """{kernel name: the object whose `launches` counts its calls}."""
    from stylemc_torch.ops.kernels import modconv
    from stylemc_torch.ops.kernels.upfirdn2d import (
        downsample2d_kernel, upsample2d_kernel)

    return {"upsample2x": upsample2d_kernel,
            "downsample2x": downsample2d_kernel,
            "modconv_fwd": modconv.launch_fwd,
            "modconv_bwd_data": modconv.launch_bwd_data,
            "modconv_bwd_weight": modconv.launch_bwd_weight}


def count_launches(fn):
    """(fn(), {kernel: launches during it}), every count set to 0 just
    before the call."""
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, {name: c.launches for name, c in counters.items()}


def record_launches(paths, cfg, path, launches, synthesis_calls,
                    backward_calls=0, upper_blocks=None) -> None:
    """Keep a path's launch counts and hold them to one B1 launch per upper
    block of each synthesis call, one B2 launch per upper block of each
    backward pass through it, and no B3/B4/B5 launch: the generator runs
    the unfused layer, as the JAX generator does. `upper_blocks` is the
    upper blocks a call renders (until_k of a partial-resolution call, e.g.
    7 for a 512 px mapper step of FFHQ-1024); by default all of cfg's."""
    per_call = len(cfg.block_resolutions) - 1 if upper_blocks is None \
        else upper_blocks
    paths[path] = {"launches": launches, "synthesis_calls": synthesis_calls,
                   "backward_calls": backward_calls,
                   "upper_blocks": per_call}
    want = {"upsample2x": per_call * synthesis_calls,
            "downsample2x": per_call * backward_calls,
            **{name: 0 for name in MODCONV_KERNELS}}
    if launches != want:
        raise AssertionError(
            f"{path}: launches {launches} over {synthesis_calls} synthesis "
            f"calls and {backward_calls} backward passes, not {want}")


def phase_serve(torch, net, direction, smi, paths):
    import numpy as np

    from stylemc_torch.bench.timing import card_state
    from stylemc_torch.cli.serve import build_server
    from stylemc_torch.serve import BatchEditor

    t0 = time.perf_counter()
    editor = BatchEditor.from_files(net, direction=direction,
                                    directions={"d0": direction},
                                    max_batch=64, device="cuda")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    editor.warmup()
    warmup_s = time.perf_counter() - t0
    res = editor.cfg.img_resolution
    chunk = min(editor.pipeline_chunk or 64, 64)

    server, service = build_server(editor, host="127.0.0.1", port=0,
                                   coalesce_ms=3.0, max_batch=64)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def requests():
        t0 = time.perf_counter()
        r1 = _get(f"{base}/edit?seeds=1-4&pairs=1")
        t1 = time.perf_counter()
        r2 = _get(f"{base}/edit?seeds=1-16&power=2.0&direction=d0")
        return r1, r2, [t1 - t0, time.perf_counter() - t1]

    try:
        (r1, r2, request_s), launches = count_launches(requests)
        st3, _, body3 = _get(f"{base}/stats")
        stats = json.loads(body3)
        st4, _, body4 = _get(f"{base}/healthz")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("HTTP server thread did not stop")

    (st1, ct1, body1), (st2, ct2, body2) = r1, r2
    img1, img2 = _decode(body1), _decode(body2)
    checks = {
        "status_200": (st1, st2, st3, st4) == (200, 200, 200, 200),
        "jpeg": ct1 == ct2 == "image/jpeg",
        "pairs_shape": img1.shape == (4 * res, 2 * res, 3),
        "d0_shape": img2.shape == (16 * res, res, 3),
        "left_ne_right": bool(np.abs(img1[:, :res].astype(int)
                                     - img1[:, res:].astype(int)).max() > 0),
        "stats": stats.get("requests") == 2 and stats.get("errors") == 0,
        "healthz": body4 == b"ok",
    }
    emit({"phase": "serve", "launches": launches, "load_s": load_s,
          "warmup_s": warmup_s, "request_s": request_s, "stats": stats,
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"serve checks failed: {checks}")
    # pairs=1 renders original and edit: two synthesis calls per chunk
    record_launches(paths, editor.cfg, "http", launches,
                    2 * -(-4 // chunk) + -(-16 // chunk))

    # throughput of edit_styles, fp32, in pipeline chunks
    styles = editor.styles_from_seeds(list(range(64)))
    rates = {}
    torch.cuda.reset_peak_memory_stats()

    def throughput():
        for b in (16, 64):
            editor.edit_styles(styles[:b])
            times = []
            before = card_state()
            for _ in range(3):
                t0 = time.perf_counter()
                out = editor.edit_styles(styles[:b], change_power=2.0)
                times.append(time.perf_counter() - t0)
                assert out.shape == (b, res, res, 3)
            rates[str(b)] = {
                "images_per_s": [b / t for t in times],
                "median_images_per_s": b / statistics.median(times),
                "card_state": [before, card_state()]}

    _, launches = count_launches(throughput)
    record_launches(paths, editor.cfg, "throughput", launches,
                    4 * (-(-16 // chunk) + -(-64 // chunk)))
    flop = synthesis_flop(editor.cfg)
    useful = synthesis_flop(editor.cfg, useful=True)
    for r in rates.values():
        r["achieved_tflop_per_s"] = r["median_images_per_s"] * flop / 1e12
        r["useful_tflop_per_s"] = r["median_images_per_s"] * useful / 1e12
    emit({"phase": "serve_throughput", "precision": "fp32",
          "card": smi, "pipeline_chunk": editor.pipeline_chunk,
          "up_conv_impl": editor.cfg.up_conv_impl or "polyphase",
          "synthesis_flop_per_image": flop,
          "useful_flop_per_image": useful, "launches": launches,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), **rates})

    def one_call():
        return editor.edit_styles(styles[:16], change_power=2.0)

    emit({"phase": "breakdown", "card": smi,
          **device_breakdown(torch, one_call)})
    emit({"phase": "layers", "card": smi,
          **layer_breakdown(torch, one_call, batch=16)})
    return editor


# traces of one call before a missed-events trace fails its phase (a
# host-bound DeepLab call once missed events in three traces running)
PROFILE_TRIES = 6


def profiled(torch, fn, record_shapes: bool = False):
    """Profile one call of `fn` (after an untraced one): (profile, host
    wall ms, CUDA-event span ms, device busy ms). With `record_shapes` the
    host's ops are traced too, with their input shapes. The profiler can
    miss device events, so a trace whose busy time is under half the span
    is taken again, up to PROFILE_TRIES times; a host-bound call's span
    varies from trace to trace, so a trace whose busy time repeats the
    previous one's within 2 % is kept too (missed events would not
    repeat)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if record_shapes:
        activities.append(ProfilerActivity.CPU)
    fn()
    torch.cuda.synchronize()
    busy_before = None
    for _ in range(PROFILE_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=activities,
                     record_shapes=record_shapes) as prof:
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(evt.time_range.elapsed_us() / 1e3
                      for evt in prof.events()
                      if evt.device_type == DeviceType.CUDA)
        span_ms = start.elapsed_time(end)
        if busy_ms >= 0.5 * span_ms or (
                busy_before is not None
                and abs(busy_ms - busy_before) <= 0.02 * busy_before):
            return prof, wall_ms, span_ms, busy_ms
        busy_before = busy_ms
    raise RuntimeError(f"the profiler recorded {busy_ms} ms of device "
                       f"time in a {span_ms} ms span, {PROFILE_TRIES} "
                       f"times")


def device_breakdown(torch, fn, top=10):
    """Where the device time of one call of `fn` goes: CUDA kernel and copy
    time by name, their sum (device busy) against the host wall time of
    the call, and so the device's idle share. The profiler's own host cost
    is inside the wall time."""
    from torch.autograd import DeviceType

    prof, wall_ms, span_ms, busy_ms = profiled(torch, fn)
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms, calls = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3,
                                 calls + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"wall_ms": wall_ms, "span_ms": span_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            **{f"{k}_ms": sum(ms for name, (ms, _) in rows if k in name)
               for k in KERNEL_NAMES},
            "top": [{"name": name[:100], "ms": ms, "calls": calls,
                     "share": ms / busy_ms}
                    for name, (ms, calls) in rows[:top]]}


def _kernels(evt):
    """The device kernels that a host op and its children launched."""
    out = list(evt.kernels)
    for child in evt.cpu_children:
        out += _kernels(child)
    return out


def conv_layer(x_shape, w_shape):
    """(layer, output resolution) of a synthesis convolution from its
    input and weight shapes: a 6x6 weight is a conv0 (3x3 composed with
    the 4x4 FIR, run over the zero-stuffed input: pad_dilate), a 3x3
    weight with more output than input channels a polyphase conv0 (its
    four 3x3 phases as 4·O output channels over the low-resolution input),
    another 3x3 a conv1, 1x1 a torgb; a 4x4 FIR over [O*I, 1, 3, 3] weight
    planes composes a conv0's kernel."""
    kh = w_shape[2]
    res = x_shape[2] - kh + 1
    if x_shape[1] == 1 and w_shape[:3] == [1, 1, 4]:
        return "conv0_kernel_compose", None
    if kh == 3 and w_shape[0] > w_shape[1]:
        return "conv0_polyphase", 2 * res
    return {6: "conv0", 3: "conv1", 1: "torgb"}.get(kh, f"conv{kh}x{kh}"), res


def layer_breakdown(torch, fn, batch):
    """Device time of one call of `fn` by synthesis layer, measured: the
    profiler records each aten::convolution with its input shapes and the
    device time of the kernels it launched; `conv_layer` names the layer.
    Rates are flops over that device time, in the form the port runs and,
    for conv0, in useful flops (the 9 of its 36 taps per output pixel
    that meet a non-zero input)."""
    prof, wall_ms, span_ms, busy_ms = profiled(torch, fn, record_shapes=True)
    rows = {}
    for evt in prof.events():
        if evt.name == "aten::convolution" and evt.input_shapes:
            x_shape, w_shape = evt.input_shapes[0], evt.input_shapes[1]
            suffix = ""
        elif evt.name == "aten::convolution_backward" and evt.input_shapes:
            # (grad_output, input, weight, ...); with the weights frozen it
            # computes the input gradient only: the forward's flops
            x_shape, w_shape = evt.input_shapes[1], evt.input_shapes[2]
            suffix = "_bwd"
        else:
            continue
        x_shape, w_shape = list(x_shape), list(w_shape)
        layer, res = conv_layer(x_shape, w_shape)
        layer += suffix
        kernels = _kernels(evt)
        row = rows.setdefault((layer, res), {
            "layer": layer, "res": res, "x": x_shape, "w": w_shape,
            "calls": 0, "device_ms": 0.0, "flop": 0, "kernels": {}})
        row["calls"] += 1
        row["device_ms"] += sum(k.duration for k in kernels) / 1e3
        if res is not None:
            o, i, kh, kw = w_shape
            out = x_shape[2] - kh + 1
            row["flop"] += 2 * x_shape[0] * o * i * kh * kw * out * out
        for k in kernels:
            row["kernels"][k.name[:80]] = row["kernels"].get(k.name[:80], 0) + 1
    by_layer = {}
    for row in rows.values():
        row["share"] = row["device_ms"] / busy_ms
        if row["flop"] and row["device_ms"]:
            row["tflop_per_s"] = row["flop"] / row["device_ms"] / 1e9
            if row["layer"] == "conv0":
                row["useful_tflop_per_s"] = row["tflop_per_s"] / 4
        total = by_layer.setdefault(row["layer"], {"device_ms": 0.0,
                                                   "calls": 0})
        total["device_ms"] += row["device_ms"]
        total["calls"] += row["calls"]
    conv_ms = sum(t["device_ms"] for t in by_layer.values())
    for total in by_layer.values():
        total["share"] = total["device_ms"] / busy_ms
    return {"batch": batch, "device_busy_ms": busy_ms, "span_ms": span_ms,
            "by_layer": by_layer,
            "outside_convolutions_ms": busy_ms - conv_ms,
            "rows": sorted(rows.values(), key=lambda r: -r["device_ms"])}


def phase_parity(editor, net, direction, paths):
    import numpy as np

    from stylemc_torch.serve import BatchEditor

    cpu = BatchEditor.from_files(net, direction=direction, max_batch=2,
                                 device="cpu")
    t0 = time.perf_counter()
    want, cpu_launches = count_launches(
        lambda: cpu.edit_seeds([1, 2], change_power=2.0, pairs=True))
    cpu_s = time.perf_counter() - t0
    got, launches = count_launches(
        lambda: editor.edit_seeds([1, 2], change_power=2.0, pairs=True))
    diff = int(np.abs(got.astype(int) - want.astype(int)).max())
    emit({"phase": "parity", "max_abs_u8_diff": diff, "cpu_s": cpu_s,
          "shape": list(got.shape), "launches": launches,
          "cpu_launches": cpu_launches})
    if diff > 1:
        raise AssertionError(f"cuda vs cpu uint8 renders differ by {diff}")
    if any(cpu_launches.values()):
        raise AssertionError("the CPU render launched a CUDA kernel")
    record_launches(paths, editor.cfg, "parity", launches, 2)


# Runs a CLI module as `python -m` does, then prints every kernel's launch
# count in that process as its last line.
CLI_RUNNER = """\
import json, runpy, sys
from chip_smoke import launch_counters
counters = launch_counters()
sys.argv = sys.argv[1:]
for c in counters.values():
    c.launches = 0
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as e:
    if e.code not in (None, 0):
        raise
print(json.dumps({k: c.launches for k, c in counters.items()}))
"""


def run_cli(paths, cfg, path, name, synthesis_calls, backward_calls, *args,
            env=None, upper_blocks=None):
    """Run `stylemc_torch.cli.<name>` in a subprocess (with `env` added to
    its environment) and hold the launch counts it reports to
    `record_launches` under `path`; (seconds, stdout)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_RUNNER,
                           f"stylemc_torch.cli.{name}", *args], cwd=ROOT,
                          timeout=600, capture_output=True, text=True,
                          env={**os.environ, **(env or {})})
    if proc.returncode != 0:
        raise RuntimeError(f"{name} exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    launches = json.loads(proc.stdout.strip().splitlines()[-1])
    record_launches(paths, cfg, path, launches, synthesis_calls,
                    backward_calls, upper_blocks)
    return time.perf_counter() - t0, proc.stdout


def phase_clis(editor, net, direction, tmp, paths):
    import numpy as np

    from stylemc_torch.models.stylegan2.generator import (
        S_TRAINABLE_SPACE_CHANNELS)

    def run(name, synthesis_calls, backward_calls, *args):
        return run_cli(paths, editor.cfg, f"cli_{name}", name,
                       synthesis_calls, backward_calls, *args)

    w_file = os.path.join(tmp, "projected_w.npz")
    s_file = os.path.join(tmp, "input.npz")
    outdir = os.path.join(tmp, "out")
    os.makedirs(outdir)
    prompt = "smiling face"
    # generate_w and w_s_converter render nothing. find_direction renders
    # the 8 items once (one precompute chunk), then takes 2 steps of batch
    # 4, each a synthesis and a backward pass; it starts from the seeded
    # direction, so the edit it writes is visible. generate_fromS renders
    # its 8 items in one batch, original and edit: two synthesis calls.
    secs, outs = zip(*[
        run("generate_w", 0, 0, "--network", net, "--seeds", "1-8",
            "--trunc", "0.7", "--out_file", w_file),
        run("w_s_converter", 0, 0, "--network", net, "--projected-w", w_file,
            "--out_file", s_file),
        run("find_direction", 3, 2, "--network", net, "--s_input", s_file,
            "--outdir", outdir, "--text_prompt", prompt,
            "--allow_random_init", "--n_epochs", "1", "--batch_size", "4",
            "--resume", direction),
        run("generate_fromS", 2, 0, "--network", net, "--s_input", s_file,
            "--outdir", outdir, "--text_prompt", prompt)])
    w, s = np.load(w_file)["w"], np.load(s_file)["s"]
    found = np.load(os.path.join(outdir, "direction_smiling_face.npz"))["s"]
    frozen = [i for i in range(found.shape[1])
              if i not in S_TRAINABLE_SPACE_CHANNELS]
    ref = editor.styles_from_seeds(list(range(1, 9))).cpu().numpy()
    jpegs = sorted(f for f in os.listdir(outdir) if f.endswith(".jpeg"))
    imgs = []
    for name in jpegs:
        with open(os.path.join(outdir, name), "rb") as fh:
            imgs.append(_decode(fh.read()))
    res = editor.cfg.img_resolution
    checks = {
        "w_shape": w.shape == (8, 14, 512),
        "s_shape": s.shape == (8, 26, 512),
        "s_matches_editor": bool(np.allclose(s, ref, rtol=1e-4, atol=1e-4)),
        "direction_shape": found.shape == (1, 26, 512),
        "direction_finite": bool(np.isfinite(found).all()),
        "direction_moved": bool(np.abs(found - np.load(direction)["s"]).max()
                                > 0),
        "frozen_rows_zero": bool(np.abs(found[:, frozen]).max() == 0),
        "iteration_logged": "Iteration 2, gradient norm:" in outs[2],
        "jpeg_names": jpegs == [f"smiling_face_{i:03d}.jpeg"
                                for i in range(8)],
        "jpeg_shapes": all(a.shape == (res, 2 * res, 3) for a in imgs),
        "left_ne_right": all(np.abs(a[:, :res].astype(int)
                                    - a[:, res:].astype(int)).max() > 0
                             for a in imgs),
    }
    emit({"phase": "clis", "seconds": list(secs),
          "launches": {k: v["launches"] for k, v in paths.items()
                       if k.startswith("cli_")},
          "find_direction_tail": outs[2].strip().splitlines()[-4:],
          "max_abs_s_diff": float(np.abs(s - ref).max()), "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"CLI checks failed: {checks}")


# ----------------------------------------------------------------- e4e

E4E_SIZE = 1024
E4E_SEEDS = {"encoder": 3, "decoder": 4, "latent_avg": 5, "photos": 6,
             "direction": 7}
# the ToRGB weights of the seeded decoder are scaled by this, so that its
# renders lie mostly inside [-1, 1] and the uint8 comparison reads values,
# not the clip at 0 and 255
E4E_TORGB_SCALE = 0.125
E4E_PHOTOS = 8
E4E_MAX_BATCH = 16
E4E_CODE_REL_L2 = 1e-4
E4E_PROMPT = "smiling face"


def write_photos(directory, n, seed):
    """`n` seeded 256² PNG photos photo<i>.png in `directory`: each a
    smooth random field, bicubic from 8x8, plus pixel noise."""
    import numpy as np
    from PIL import Image

    os.makedirs(directory)
    rs = np.random.RandomState(seed)
    for i in range(n):
        low = Image.fromarray((rs.rand(8, 8, 3) * 255).astype(np.uint8))
        img = np.asarray(low.resize((256, 256), Image.BICUBIC), np.float32)
        img = np.clip(img + rs.randn(256, 256, 3) * 8, 0, 255)
        Image.fromarray(img.astype(np.uint8), "RGB").save(
            os.path.join(directory, f"photo{i}.png"))
    return directory


def make_e4e(torch, tmp):
    """e4e_ffhq_encode at full width, with random weights from seeds,
    written by the port's own export: the IR-SE-50 Encoder4Editing (24
    bottlenecks, 18 style heads) and the rosinality FFHQ-1024 decoder
    (channel multiplier 2, 8 mapping layers, no conv clamp) in one
    checkpoint (`save_e4e_pt`), the decoder also alone (`save_rosinality_pt`);
    latent_avg is the mean w of 4096 seeded z. Eight seeded 256² PNG
    photos and a seeded direction npz beside them."""
    import numpy as np

    from stylemc_torch.io.export import save_e4e_pt, save_rosinality_pt
    from stylemc_torch.io.rosinality import config_for_rosinality
    from stylemc_torch.models.e4e.encoders import init_encoder_params
    from stylemc_torch.models.stylegan2.generator import (
        S_TRAINABLE_SPACE_CHANNELS, init_generator_params, mapping)

    def gen(key):
        return torch.Generator().manual_seed(E4E_SEEDS[key])

    t0 = time.perf_counter()
    enc = init_encoder_params(gen("encoder"), E4E_SIZE, device="cpu")
    dcfg = config_for_rosinality(E4E_SIZE)
    dec = init_generator_params(gen("decoder"), dcfg, device="cpu")
    for bp in dec["synthesis"].values():
        bp["torgb"]["weight"] *= E4E_TORGB_SCALE
    with torch.inference_mode():
        z = torch.randn((4096, dcfg.z_dim), generator=gen("latent_avg"))
        dec["mapping"]["w_avg"] = mapping(dec, dcfg, z)[:, 0].mean(dim=0)
    ckpt = save_e4e_pt(os.path.join(tmp, "e4e_ffhq_encode.pt"), enc, dcfg,
                       dec, dec["mapping"]["w_avg"])
    decoder = save_rosinality_pt(os.path.join(tmp, "ffhq1024.pt"), dcfg, dec)
    photos = write_photos(os.path.join(tmp, "photos"), E4E_PHOTOS,
                          E4E_SEEDS["photos"])
    d = np.zeros((1, 26, 512), np.float32)
    rs = np.random.RandomState(E4E_SEEDS["direction"])
    for row in S_TRAINABLE_SPACE_CHANNELS:
        d[:, row] = rs.randn(512).astype(np.float32) * 0.5
    outdir = os.path.join(tmp, "e4e_edits")
    os.makedirs(outdir)
    direction = os.path.join(
        outdir, f"direction_{E4E_PROMPT.replace(' ', '_')}.npz")
    np.savez(direction, s=d)
    emit({"phase": "e4e_fabricate", "seconds": time.perf_counter() - t0,
          "checkpoint_bytes": os.path.getsize(ckpt),
          "decoder_bytes": os.path.getsize(decoder),
          "decoder": {"img_resolution": dcfg.img_resolution,
                      "channel_base": dcfg.channel_base,
                      "channel_max": dcfg.channel_max,
                      "mapping_layers": dcfg.mapping_layers,
                      "conv_clamp": dcfg.conv_clamp}})
    return ckpt, decoder, photos, direction, outdir


def _read_photos(photos):
    import numpy as np
    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(photos, f)), np.uint8)
                     for f in sorted(os.listdir(photos))])


def phase_e4e_clis(ckpt, decoder, photos, outdir, tmp, paths):
    """infer_e4e → w_s_converter → generate_fromS as subprocesses, each
    reading the one before: 8 photos inverted at batch 4 with their
    reconstructions (two 1024 synthesis calls), their codes turned into
    styles by the decoder, the seeded direction rendered on them (8 items
    in one batch, original and edit: two synthesis calls)."""
    import numpy as np

    from stylemc_torch.io.rosinality import config_for_rosinality

    cfg = config_for_rosinality(E4E_SIZE)
    inv = os.path.join(tmp, "e4e_inversion")
    s_file = os.path.join(tmp, "e4e_input.npz")
    calls = -(-E4E_PHOTOS // 4)
    def run(name, synthesis_calls, *args):
        return run_cli(paths, cfg, f"e4e_cli_{name}", name, synthesis_calls,
                       0, *args)

    secs, outs = zip(*[
        run("infer_e4e", calls, "--images_dir", photos, "--ckpt", ckpt,
            "--save_dir", inv, "--stylegan_size", str(E4E_SIZE), "--batch",
            "4", "--save_images"),
        run("w_s_converter", 0, "--network", decoder, "--projected-w",
            os.path.join(inv, "projected_w.npz"), "--out_file", s_file),
        run("generate_fromS", 2, "--network", decoder, "--s_input", s_file,
            "--outdir", outdir, "--text_prompt", E4E_PROMPT)])
    w, s = np.load(os.path.join(inv, "projected_w.npz"))["w"], \
        np.load(s_file)["s"]
    recon = sorted(os.listdir(os.path.join(inv, "inversions")))
    tag = E4E_PROMPT.replace(" ", "_")
    jpegs = sorted(f for f in os.listdir(outdir) if f.endswith(".jpeg"))
    imgs = []
    for name in jpegs:
        with open(os.path.join(outdir, name), "rb") as fh:
            imgs.append(_decode(fh.read()))
    res = E4E_SIZE
    checks = {
        "w_shape": w.shape == (E4E_PHOTOS, cfg.num_ws, 512),
        "w_finite": bool(np.isfinite(w).all()),
        "s_shape": s.shape == (E4E_PHOTOS, 26, 512),
        "reconstructions": recon == sorted(os.listdir(photos)),
        "jpeg_names": jpegs == [f"{tag}_{i:03d}.jpeg"
                                for i in range(E4E_PHOTOS)],
        "jpeg_shapes": all(a.shape == (res, 2 * res, 3) for a in imgs),
        "left_ne_right": all(np.abs(a[:, :res].astype(int)
                                    - a[:, res:].astype(int)).max() > 0
                             for a in imgs),
    }
    emit({"phase": "e4e_clis", "seconds": list(secs),
          "launches": {k: v["launches"] for k, v in paths.items()
                       if k.startswith("e4e_cli_")},
          "infer_e4e_tail": outs[0].strip().splitlines()[-3:],
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"e4e CLI checks failed: {checks}")
    return s


def phase_e4e_serve(torch, ckpt, decoder, photos, direction, cli_styles,
                    smi, paths):
    """BatchEditor.from_files(the rosinality decoder, e4e_ckpt=...), warmup,
    then an HTTP server that answers four POST /edit_image requests and
    /stats; the editor's styles of the 8 photos against the CLI chain's
    (relative L2 1e-4: the two map uint8 to [-1, 1] with other roundings);
    invert_images and edit_images images/s; one batch-16 edit_images
    call's device time, its encoder half (invert_images) and its synthesis
    half (edit_styles of those styles) profiled apart, by kernel name."""
    import numpy as np

    from stylemc_torch.bench.timing import card_state
    from stylemc_torch.cli.serve import build_server
    from stylemc_torch.serve import BatchEditor

    t0 = time.perf_counter()
    editor = BatchEditor.from_files(decoder, direction=direction,
                                    e4e_ckpt=ckpt, max_batch=E4E_MAX_BATCH,
                                    device="cuda")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    editor.warmup()
    warmup_s = time.perf_counter() - t0
    res = editor.cfg.img_resolution
    server, service = build_server(editor, host="127.0.0.1", port=0,
                                   coalesce_ms=3.0, max_batch=E4E_MAX_BATCH)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    names = sorted(os.listdir(photos))

    def post(i, query):
        with open(os.path.join(photos, names[i]), "rb") as fh:
            req = urllib.request.Request(
                f"{base}/edit_image?{query}", data=fh.read(), method="POST",
                headers={"Content-Type": "image/png"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            out = r.status, r.headers.get("Content-Type"), r.read()
        return out, time.perf_counter() - t0

    queries = ["power=2.0&pairs=1", "power=2.0", "power=1.0&pairs=1",
               "power=-1.0"]

    def requests():
        return [post(i, q) for i, q in enumerate(queries)]

    try:
        replies, launches = count_launches(requests)
        st, _, body = _get(f"{base}/stats")
        stats = json.loads(body)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("HTTP server thread did not stop")
    imgs = [_decode(r[0][2]) for r in replies]
    pairs = ["pairs=1" in q for q in queries]
    checks = {
        "status_200": all(r[0][0] == 200 for r in replies) and st == 200,
        "jpeg": all(r[0][1] == "image/jpeg" for r in replies),
        "shapes": all(a.shape == (res, (2 if p else 1) * res, 3)
                      for a, p in zip(imgs, pairs)),
        "left_ne_right": all(np.abs(a[:, :res].astype(int)
                                    - a[:, res:].astype(int)).max() > 0
                             for a, p in zip(imgs, pairs) if p),
        "stats": stats.get("requests") == 4 and stats.get("errors") == 0,
    }
    request_s = [r[1] for r in replies]
    emit({"phase": "e4e_serve", "card": smi, "launches": launches,
          "load_s": load_s, "warmup_s": warmup_s, "request_s": request_s,
          "request_p50_s": statistics.median(request_s), "stats": stats,
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"e4e serve checks failed: {checks}")
    record_launches(paths, editor.cfg, "e4e_http", launches,
                    sum(2 if p else 1 for p in pairs))

    batch = _read_photos(photos)
    served, launches = count_launches(
        lambda: editor.invert_images(batch).cpu())
    record_launches(paths, editor.cfg, "e4e_styles", launches, 0)
    styles_rel = float((served - torch.from_numpy(cli_styles)).norm()
                       / served.norm())
    emit({"phase": "e4e_styles", "rel_l2_against_cli": styles_rel})
    if not styles_rel <= E4E_CODE_REL_L2:
        raise AssertionError(f"served styles vs the CLI chain's: relative "
                             f"L2 {styles_rel}")
    batch = np.concatenate([batch] * -(-E4E_MAX_BATCH // len(batch)))
    torch.cuda.reset_peak_memory_stats()
    rates = {"invert_images": {}, "edit_images": {}}

    def timed(fn, b):
        fn()
        times = []
        before = card_state()
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            if isinstance(out, torch.Tensor):
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return {"images_per_s": [b / t for t in times],
                "median_images_per_s": b / statistics.median(times),
                "card_state": [before, card_state()]}

    def invert():
        for b in (4, E4E_MAX_BATCH):
            rates["invert_images"][str(b)] = timed(
                lambda: editor.invert_images(batch[:b]), b)

    def edit():
        for b in (4, E4E_MAX_BATCH):
            rates["edit_images"][str(b)] = timed(
                lambda: editor.edit_images(batch[:b]), b)

    _, inv_launches = count_launches(invert)
    record_launches(paths, editor.cfg, "e4e_invert", inv_launches, 0)
    _, edit_launches = count_launches(edit)
    # 4 calls a batch, each one pipeline chunk: one synthesis call
    record_launches(paths, editor.cfg, "e4e_edit_images", edit_launches, 8)
    emit({"phase": "e4e_throughput", "card": smi, "precision": "fp32",
          "max_batch": E4E_MAX_BATCH,
          "up_conv_impl": editor.cfg.up_conv_impl or "polyphase",
          "synthesis_flop_per_image": synthesis_flop(editor.cfg),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": {"invert": inv_launches, "edit": edit_launches},
          **rates})

    b16 = batch[:E4E_MAX_BATCH]
    styles = editor.invert_images(b16)
    whole = device_breakdown(torch, lambda: editor.edit_images(b16))
    encoder = device_breakdown(torch, lambda: editor.invert_images(b16))
    synth = device_breakdown(torch, lambda: editor.edit_styles(styles))
    split = encoder["device_busy_ms"] + synth["device_busy_ms"]
    emit({"phase": "e4e_breakdown", "card": smi, "batch": E4E_MAX_BATCH,
          "edit_images": whole, "encoder": encoder, "synthesis": synth,
          "encoder_share": encoder["device_busy_ms"] / split,
          "split_over_whole": split / whole["device_busy_ms"]})
    return editor


def phase_e4e_parity(torch, editor, ckpt, decoder, photos, direction,
                     paths):
    """Two photos on the card and on the CPU: W+ codes (PSP.encode) within
    relative L2 1e-4, edited renders (edit_images, power 2) within ±1."""
    import numpy as np

    from stylemc_torch.models.e4e.psp import load_psp_from_checkpoint
    from stylemc_torch.serve import BatchEditor

    two = _read_photos(photos)[:2]
    x = torch.from_numpy(two).permute(0, 3, 1, 2).float() / 127.5 - 1.0
    codes = {}
    for dev in ("cuda", "cpu"):
        model = load_psp_from_checkpoint(ckpt, E4E_SIZE, device=dev)
        with torch.inference_mode():
            codes[dev] = model.encode(x.to(dev)).cpu()
        del model
    code_rel = float((codes["cuda"] - codes["cpu"]).norm()
                     / codes["cpu"].norm())
    cpu = BatchEditor.from_files(decoder, direction=direction, e4e_ckpt=ckpt,
                                 max_batch=2, device="cpu")
    t0 = time.perf_counter()
    want, cpu_launches = count_launches(
        lambda: cpu.edit_images(two, change_power=2.0))
    cpu_s = time.perf_counter() - t0
    got, launches = count_launches(
        lambda: editor.edit_images(two, change_power=2.0))
    diff = int(np.abs(got.astype(int) - want.astype(int)).max())
    emit({"phase": "e4e_parity", "code_rel_l2": code_rel,
          "code_max_abs": float(codes["cpu"].abs().max()),
          "max_abs_u8_diff": diff, "cpu_s": cpu_s,
          "shape": list(got.shape),
          "saturated_share": float(np.mean((want == 0) | (want == 255))),
          "launches": launches, "cpu_launches": cpu_launches})
    if any(cpu_launches.values()):
        raise AssertionError("the CPU render launched a CUDA kernel")
    if not code_rel <= E4E_CODE_REL_L2:
        raise AssertionError(f"card vs CPU codes: relative L2 {code_rel}")
    if diff > 1:
        raise AssertionError(f"card vs CPU e4e renders differ by {diff}")
    record_launches(paths, editor.cfg, "e4e_parity", launches, 1)


def phase_e4e(torch, tmp, smi, paths, landmark_files):
    import numpy as np

    ckpt, decoder, photos, direction, outdir = make_e4e(torch, tmp)
    cli_styles = phase_e4e_clis(ckpt, decoder, photos, outdir, tmp, paths)
    phase_e4e_align(ckpt, photos, np.load(os.path.join(
        tmp, "e4e_inversion", "projected_w.npz"))["w"], tmp, landmark_files,
        paths)
    editor = phase_e4e_serve(torch, ckpt, decoder, photos, direction,
                             cli_styles, smi, paths)
    phase_e4e_parity(torch, editor, ckpt, decoder, photos, direction, paths)
    return ckpt, photos


def perception_models(torch):
    """CLIP ViT-B/32 and ViT-B/16 and ArcFace IR-SE-50 at full width, with
    random weights drawn on the CPU from the seeds `utils/model_zoo.py`
    uses, so every device gets the same networks."""
    from stylemc_torch.models.arcface import init_backbone_params
    from stylemc_torch.models.clip import CLIP_CONFIGS, init_clip_params

    clip = {name: (CLIP_CONFIGS[name], init_clip_params(
        torch.Generator().manual_seed(seed), CLIP_CONFIGS[name],
        device="cpu")) for name, seed in CLIP_SEEDS.items()}
    arcface = init_backbone_params(torch.Generator().manual_seed(ARCFACE_SEED),
                                   device="cpu")
    return clip, arcface


def models_on(clip, arcface, device):
    from stylemc_torch.convert import params_from_numpy

    return ({name: (cfg, params_from_numpy(p, device))
             for name, (cfg, p) in clip.items()},
            params_from_numpy(arcface, device))


def train_flop(cfg, batch):
    """Flops of one training step's forward and backward (input gradients
    only: every weight is frozen, so each layer's backward costs its
    forward): the generator in the polyphase form (the useful count), the
    two CLIP image towers and IR-SE-50 at 112 px, from their shapes."""
    gen = synthesis_flop(cfg, useful=True)

    def vit(width, layers, patch, res=224, embed=512):
        tokens = (res // patch) ** 2 + 1
        per_layer = 2 * tokens * (12 * width * width) \
            + 2 * 2 * tokens * tokens * width
        return layers * per_layer + 2 * (tokens - 1) * 3 * patch * patch \
            * width + 2 * width * embed

    def irse50():
        from stylemc_torch.models.arcface import ir_se_50_layout

        total, s = 2 * 9 * 3 * 64 * 112 * 112, 112
        for in_c, depth, stride in ir_se_50_layout():
            out = s // stride
            total += 2 * 9 * in_c * depth * s * s           # conv1
            total += 2 * 9 * depth * depth * out * out      # conv2
            if in_c != depth:
                total += 2 * in_c * depth * out * out       # shortcut
            s = out
        return total + 2 * 512 * 7 * 7 * 512

    per_image = gen + vit(768, 12, 32) + vit(768, 12, 16) + irse50()
    return 2 * batch * per_image, {
        "generator": 2 * batch * gen, "clip_b32": 2 * batch * vit(768, 12, 32),
        "clip_b16": 2 * batch * vit(768, 12, 16), "arcface": 2 * batch * irse50()}


def phase_train(torch, net, smi, paths):
    import numpy as np

    from stylemc_torch.bench.timing import card_state
    from stylemc_torch.io import load_generator
    from stylemc_torch.serve import BatchEditor
    from stylemc_torch.losses.id_loss import extract_feats
    from stylemc_torch.models.clip import (FallbackTokenizer, encode_image,
                                           unprocess)
    from stylemc_torch.models.stylegan2.generator import synthesis
    from stylemc_torch.train.find_direction import (
        TRAINABLE, FindDirectionConfig, assemble_direction, find_direction,
        make_clip_bundles, make_loss_fn, precompute_original_features)

    cfg, gp = load_generator(net, device="cuda")   # polyphase up-convs
    clip_cpu, arc_cpu = perception_models(torch)
    clip, arc = models_on(clip_cpu, arc_cpu, "cuda")
    # the seeds' styles as the serving editor makes them
    editor = BatchEditor.from_files(net, max_batch=64, device="cuda")
    styles = editor.styles_from_seeds(list(range(TRAIN_SEEDS)))
    fdc = FindDirectionConfig(n_epochs=1)
    tok = FallbackTokenizer()
    bundles = make_clip_bundles(fdc, clip, tok)

    def precompute():
        out = precompute_original_features(gp, cfg, styles, bundles, arc, fdc)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    (id_all, clip_all), pre = count_launches(precompute)
    precompute_s = time.perf_counter() - t0
    chunks = -(-TRAIN_SEEDS // 8)
    record_launches(paths, cfg, "train_precompute", pre, chunks)

    torch.cuda.reset_peak_memory_stats()
    state_before = card_state()
    (direction, info), total = count_launches(
        lambda: find_direction(gp, cfg, styles, clip, arc, fdc,
                               tokenizer=tok))
    peak = torch.cuda.max_memory_allocated()
    states = [state_before, card_state()]
    steps = info["iterations"]
    record_launches(paths, cfg, "train", total, chunks + steps, steps)
    step_launches = {k: total[k] - pre[k] for k in total}

    d = direction.cpu().numpy()
    frozen = [i for i in range(d.shape[1]) if i not in TRAINABLE]
    hist = np.asarray(info["history"])
    steady = info["steady_ms_per_step"]
    flop, flop_by_model = train_flop(cfg, fdc.batch_size)
    checks = {"steps": steps == -(-TRAIN_SEEDS // fdc.batch_size),
              "history_finite": bool(np.isfinite(hist).all()),
              "history_len": len(hist) == steps,
              "trainable_rows_moved": bool((np.abs(d[0, TRAINABLE]).max(1)
                                            > 0).all()),
              "frozen_rows_zero": bool(np.abs(d[:, frozen]).max() == 0),
              "step_launches": step_launches == {
                  "upsample2x": 6 * steps, "downsample2x": 6 * steps,
                  **{k: 0 for k in MODCONV_KERNELS}}}
    emit({"phase": "train", "card": smi, "seeds": TRAIN_SEEDS,
          "batch": fdc.batch_size, "clip_type": fdc.clip_type,
          "clip_loss_type": fdc.clip_loss_type, "precision": "fp32",
          "up_conv_impl": cfg.up_conv_impl or "polyphase",
          "precompute_s": precompute_s,
          "first_step_s": info["first_step_time"],
          "steady_ms_per_step": steady, "steps_per_s": 1e3 / steady,
          "images_per_s": fdc.batch_size * 1e3 / steady,
          "time_s": info["time"], "peak_mem_bytes": peak,
          "step_flop": flop, "step_flop_by_model": flop_by_model,
          "achieved_tflop_per_s": flop / steady / 1e9,
          "loss_first_last": [hist[0], hist[-1]], "card_state": states,
          "launches": {"precompute": pre, "steps": step_launches},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"train checks failed: {checks}")

    # one step, profiled, and each model's forward + backward alone
    loss_fn = make_loss_fn(gp, cfg, bundles, arc, fdc)
    s4, id4 = styles[:4], id_all[:4]
    c4 = tuple(c[:4] for c in clip_all)
    delta0 = direction[:, TRAINABLE].clone()

    def one_step():
        dl = delta0.clone().requires_grad_(True)
        loss, _ = loss_fn(dl, s4, id4, c4)
        g, = torch.autograd.grad(loss, dl)
        return dl.detach() - fdc.learning_rate * g

    emit({"phase": "train_breakdown", "card": smi,
          **device_breakdown(torch, one_step, top=15)})

    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        img4 = synthesis(gp, cfg, s4 + assemble_direction(delta0), until_k=6)
    cot_img = torch.randn(img4.shape, generator=gen, device="cuda")

    def gen_fb():
        dl = delta0.clone().requires_grad_(True)
        img = synthesis(gp, cfg, s4 + assemble_direction(dl), until_k=6)
        return torch.autograd.grad(img, dl, cot_img)

    def image_fb(feats):
        with torch.no_grad():
            cot = torch.randn(feats(img4).shape, generator=gen, device="cuda")

        def fb():
            x = img4.clone().requires_grad_(True)
            return torch.autograd.grad(feats(x), x, cot)
        return fb

    fns = {"generator": gen_fb}
    for b, key in zip(bundles, ("clip_b32", "clip_b16")):
        fns[key] = image_fb(lambda x, b=b: encode_image(
            b.params, b.cfg, unprocess(x, b.cfg.image_resolution)))
    fns["arcface"] = image_fb(
        lambda x: extract_feats(arc, x, fdc.arcface_layout))
    models = {}
    for key, fn in fns.items():
        ms = event_ms(fn, iters=10, warmup=2)
        models[key] = {"event_ms": ms, "flop": flop_by_model[key],
                       "tflop_per_s": flop_by_model[key] / ms / 1e9}
    emit({"phase": "train_models", "card": smi, "batch": 4,
          "times_are": "CUDA events over 10 back-to-back forward+backward "
                       "calls of each model alone (host cost included)",
          "models": models,
          "sum_ms": sum(m["event_ms"] for m in models.values()),
          "steady_ms_per_step": steady})
    emit({"phase": "train_layers", "card": smi,
          **layer_breakdown(torch, gen_fb, batch=4)})
    return editor, (cfg, gp, clip_cpu, arc_cpu, clip, arc)


@contextlib.contextmanager
def _plain_resample_on_card():
    """B1's and B2's plain versions (torch ops) in place of the kernels for
    CUDA tensors, for a diagnostic; nothing counts a launch meanwhile."""
    from stylemc_torch.ops.kernels import upfirdn2d as up

    saved = up.launch_upsample, up.launch_downsample
    up.launch_upsample = up.upsample2d_plain
    up.launch_downsample = up.downsample2d_plain
    try:
        yield
    finally:
        up.launch_upsample, up.launch_downsample = saved


def phase_train_parity(torch, net, editor, direction_file, models, paths):
    """One full-width step (batch 2, seeds 1-2) from the seeded direction,
    on the card and on the CPU: the losses and the Δs gradients agree.
    Where they part is read off two pieces of the step, each alone: the
    generator's backward (Δs gradient of sum(img · a fixed cotangent)) and
    each loss term's gradient with respect to a fixed image."""
    import numpy as np

    from stylemc_torch.io import load_generator
    from stylemc_torch.losses.id_loss import extract_feats
    from stylemc_torch.models.clip import FallbackTokenizer
    from stylemc_torch.models.stylegan2.generator import synthesis
    from stylemc_torch.train.find_direction import (
        TRAINABLE, FindDirectionConfig, _clip_image_features, _clip_term,
        _id_features, assemble_direction, make_clip_bundles, make_loss_fn,
        precompute_original_features)

    cfg, gp, clip_cpu, arc_cpu, clip, arc = models
    _, gp_cpu = load_generator(net, device="cpu")
    resume = np.load(direction_file)["s"].astype(np.float32)
    styles = editor.styles_from_seeds([1, 2])
    fdc = FindDirectionConfig(batch_size=2, n_epochs=1)
    tok = FallbackTokenizer()
    gen = torch.Generator().manual_seed(3)
    res = cfg.img_resolution
    cot = torch.randn((2, 3, res, res), generator=gen)
    img_fixed = torch.rand((2, 3, res, res), generator=gen) * 2 - 1

    def step(gparams, clip_models, arcface, s, device):
        bundles = make_clip_bundles(fdc, clip_models, tok)
        id_f, clip_f = precompute_original_features(
            gparams, cfg, s, bundles, arcface, fdc, chunk=2)
        dl = torch.from_numpy(resume[:, TRAINABLE]).to(device)
        dl.requires_grad_(True)
        loss, aux = make_loss_fn(gparams, cfg, bundles, arcface, fdc)(
            dl, s, id_f, clip_f)
        g, = torch.autograd.grad(loss, dl)
        img = synthesis(gparams, cfg, s + assemble_direction(dl),
                        until_k=6, noise_mode=fdc.noise_mode)
        g_gen, = torch.autograd.grad(img, dl, cot.to(device))
        x = img_fixed.to(device).requires_grad_(True)
        terms = {"identity": fdc.identity_loss_coef * torch.mean(
            1.0 - torch.sum(_id_features(arcface, x, fdc) * id_f, dim=1))}
        for b, cf, name in zip(bundles, clip_f, ("clip_b32", "clip_b16")):
            terms[name] = fdc.clip_loss_coef * b.weight * _clip_term(
                b, fdc.clip_loss_type,
                _clip_image_features(b, x, fdc.clip_loss_type), cf)
        g_img = {k: torch.autograd.grad(v, x)[0].cpu()
                 for k, v in terms.items()}
        return (float(loss.detach()),
                {k: float(v.detach()) for k, v in aux.items()},
                g.cpu(), g_gen.cpu(), g_img, id_f)

    def identity_grad_fp64(id_f):
        """The identity term's image gradient with ArcFace in float64 on
        the card: the reference both fp32 results are held against."""
        def f64(tree):
            return {k: f64(v) if isinstance(v, dict) else v.double()
                    for k, v in tree.items()}

        x = img_fixed.double().cuda().requires_grad_(True)
        feats = extract_feats(f64(arc), x, fdc.arcface_layout)
        term = fdc.identity_loss_coef * torch.mean(
            1.0 - torch.sum(feats * id_f.double(), dim=1))
        return torch.autograd.grad(term, x)[0].cpu().float()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    (loss, aux, g, g_gen, g_img, id_f), launches = count_launches(
        lambda: step(gp, clip, arc, styles, "cuda"))
    # precompute, the loss and the generator-alone piece: three synthesis
    # calls, two of them differentiated
    record_launches(paths, cfg, "train_parity", launches, 3, 2)
    # the same card step with B1 and B2's plain versions (not gated): how
    # far the gate reads the last bits of B1's rounding
    with _plain_resample_on_card():
        g_plain = step(gp, clip, arc, styles, "cuda")[2]
    t0 = time.perf_counter()
    (loss_c, aux_c, g_c, g_gen_c, g_img_c, _), cpu_launches = count_launches(
        lambda: step(gp_cpu, clip_cpu, arc_cpu, styles.cpu(), "cpu"))
    cpu_s = time.perf_counter() - t0
    id64 = identity_grad_fp64(id_f)
    loss_rel = abs(loss - loss_c) / abs(loss_c)
    grad_rel = rel(g, g_c)
    emit({"phase": "train_parity", "loss": loss, "cpu_loss": loss_c,
          "loss_rel": loss_rel, "aux": aux, "cpu_aux": aux_c,
          "aux_rel": {k: abs(aux[k] - aux_c[k]) / max(abs(aux_c[k]), 1e-30)
                      for k in aux},
          "grad_rel_l2": grad_rel, "grad_norm": float(g_c.norm()),
          "grad_rel_l2_plain_resample_on_card": rel(g_plain, g_c),
          "generator_grad_rel_l2": rel(g_gen, g_gen_c),
          "generator_grad_rel_l2_by_row": {
              row: rel(g_gen[0, i], g_gen_c[0, i])
              for i, row in enumerate(TRAINABLE)},
          "image_grad_rel_l2": {k: rel(g_img[k], g_img_c[k]) for k in g_img},
          "identity_image_grad_rel_l2_to_fp64": {
              "card_fp32": rel(g_img["identity"], id64),
              "cpu_fp32": rel(g_img_c["identity"], id64)},
          "cpu_s": cpu_s, "launches": launches, "cpu_launches": cpu_launches})
    if any(cpu_launches.values()):
        raise AssertionError("the CPU step launched a CUDA kernel")
    if not (loss_rel <= PARITY_LOSS_RTOL and grad_rel <= PARITY_GRAD_REL_L2):
        raise AssertionError(f"card vs CPU step: loss rel {loss_rel}, "
                             f"gradient rel L2 {grad_rel}")


# ------------------------------------------- prompt sweeps and landmarks

SWEEP_PROMPTS = ["a smiling face", "an old face", "a face with glasses",
                 "a surprised face"]
# optimize_batch against the serial optimize, per prompt, on the update
# each made to the seeded direction; readings on an H100 80GB HBM3 at
# 700 W. One step: JAX's one-step test's gate (read: cosine >= 0.9999995,
# norms within 2.4e-4). The 33-step run: JAX's
# run-test cosine; its norms within 3e-3, not 1e-3, because rounding
# grows over the steps: the card's own repeat of a serial run moves the
# update's norm by up to 8.2e-4, the batched run by up to 1.6e-3
# (PERF.md §6)
SWEEP_STEP_COS = 0.99999
SWEEP_STEP_NORM_RTOL = 1e-3
SWEEP_COS = 0.9999
SWEEP_NORM_RTOL = 3e-3
SWEEP_CLI_SEEDS = 8
# seeded landmark weights, written in the reference's formats: the MTCNN
# nets' face logit biased by FACE_BIAS so the cascade passes candidates and
# finds faces (random nets as drawn pass almost none); MobileNet's last
# layer scaled by MOBILENET_HEAD_SCALE around 0.5, so its crop-normalised
# landmarks lie in the crop as real ones do
LANDMARK_WEIGHT_SEEDS = {"pnet": 11, "rnet": 12, "onet": 13, "mobilenet": 14}
MTCNN_CLASSIFIER = {"pnet": "conv4_1", "rnet": "conv5_1", "onet": "conv6_1"}
FACE_BIAS = 2.0
MOBILENET_HEAD_SCALE = 0.01
# the landmarks phase's seeds: 33 of the training seeds (9 steps); all 129
# until the data-parallel phases took the script's time (MTCNN's host pass
# takes ~0.37 s a frame)
LANDMARK_SEEDS = 33
# Card-against-CPU gates of the landmarks phases, fixed (PERF.md §6),
# each between the fp32 readings and its TF32 control's, which must fail
# it (tf32_control); readings on an H100 80GB HBM3 at 700 W. The seeded
# MobileNet's input gradient is ill-conditioned: against float64 its fp32
# result is 0.5-0.9 % off in relative L2, on the CPU and on the card
# alike, so the gradient gates allow about twice the two sides' errors
# summed (the step read 1.04e-2); TF32 reads 0.40 (term) and 0.84 (step).
LANDMARKS_LOSS_RTOL = 1e-4
LANDMARKS_GRAD_REL_L2 = 3e-2
LANDMARKS_TERM_REL_L2 = 3e-2
# MTCNN boxes on the parity renders, in pixels (fp32 3.7e-3, TF32 196)
LANDMARKS_BOX_ATOL = 0.05
# the metric (fp32 3.72e-5, TF32 5.65e-4)
LANDMARKS_METRIC_RTOL = 1.5e-4


def make_landmark_weights(torch, tmp):
    """Seeded full-width MTCNN P/R/O nets ({p,r,o}net.npy) and
    MobileNet-GDConv (a 'state_dict' .pth.tar), written in the reference's
    formats by the port's own code; (MTCNN dir, MobileNet path)."""
    from stylemc_torch.models import mobilenet
    from stylemc_torch.models.mtcnn import nets

    def gen(key):
        return torch.Generator().manual_seed(LANDMARK_WEIGHT_SEEDS[key])

    mtcnn_dir = os.path.join(tmp, "mtcnn")
    os.makedirs(mtcnn_dir)
    for which, cls in MTCNN_CLASSIFIER.items():
        p = nets.init_net_params(gen(which), which, device="cpu")
        p[f"{cls}.bias"][1] += FACE_BIAS
        nets.save_net_weights(os.path.join(mtcnn_dir, f"{which}.npy"), p)
    mb = mobilenet.init_mobilenet_gdconv_params(gen("mobilenet"),
                                                device="cpu")
    mb["linear1"]["conv"] *= MOBILENET_HEAD_SCALE
    mb["linear1"]["bn"]["bias"].fill_(0.5)
    path = os.path.join(tmp, "mobilenet_224_model_best_gdconv_external"
                             ".pth.tar")
    torch.save({"state_dict": mobilenet.params_to_torch_state(mb)}, path)
    return mtcnn_dir, path


def _cosine(a, b):
    import numpy as np

    a, b = np.ravel(a), np.ravel(b)
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def _update_agreement(batched, serial, d0):
    """Each prompt's batched update (direction − d0) against its serial
    one: cosine, norm ratio, and the norms beside |d0|."""
    import numpy as np

    out = []
    for b, d in zip(batched, serial):
        ub, us = b - d0, d - d0
        out.append({"cosine_of_update": _cosine(ub, us),
                    "update_norm_ratio": float(np.linalg.norm(ub)
                                               / np.linalg.norm(us)),
                    "update_norm": float(np.linalg.norm(us)),
                    "d0_norm": float(np.linalg.norm(d0)),
                    "cosine": _cosine(b, d)})
    return out


def _agree(rows, cos, rtol):
    return all(r["cosine_of_update"] > cos
               and abs(r["update_norm_ratio"] - 1) <= rtol for r in rows)


def phase_sweep(torch, models, styles, direction_file, smi, paths):
    """DirectionEngine at full width over SWEEP_PROMPTS: the precompute
    once, optimize_batch (the four prompts folded into one batch of 16
    images a step), then the serial optimize of each prompt; all from the
    seeded direction d0. Each prompt's batched update (direction − d0)
    against its serial one, after one step on a 4-seed engine (cosine >
    SWEEP_STEP_COS, norms within SWEEP_STEP_NORM_RTOL) and after the run
    (SWEEP_COS, SWEEP_NORM_RTOL); d0 (|d0| ≈ 32) would swamp whole
    directions."""
    import numpy as np

    from stylemc_torch.models.clip import FallbackTokenizer
    from stylemc_torch.train.find_direction import (DirectionEngine,
                                                    FindDirectionConfig)

    cfg, gp, _, _, clip, arc = models
    d0 = np.load(direction_file)["s"].astype(np.float32)
    fdc = FindDirectionConfig(n_epochs=1)
    n_prompts = len(SWEEP_PROMPTS)
    resume = [d0] * n_prompts

    def engine_on(rows, fdc=fdc):
        engine = DirectionEngine(gp, cfg, rows, clip, arc, fdc,
                                 tokenizer=FallbackTokenizer())
        torch.cuda.synchronize()
        return engine

    def numpy(d):
        return d.cpu().numpy()

    # one step: a 4-seed engine at batch 4, the learning rate held (the
    # cosine schedule of a one-step run ends at 0)
    one = engine_on(styles[:fdc.batch_size],
                    dataclasses.replace(fdc, lr_schedule="constant"))
    one_step = _update_agreement(
        numpy(one.optimize_batch(SWEEP_PROMPTS, resume_directions=resume)[0]),
        [numpy(one.optimize(p, resume_direction=d0)[0])
         for p in SWEEP_PROMPTS], d0)
    del one

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, pre = count_launches(lambda: engine_on(styles))
    precompute_s = time.perf_counter() - t0
    chunks = -(-styles.shape[0] // 8)
    record_launches(paths, cfg, "sweep_precompute", pre, chunks)
    (batched, info_b), launches_b = count_launches(
        lambda: engine.optimize_batch(SWEEP_PROMPTS,
                                      resume_directions=resume))
    peak = torch.cuda.max_memory_allocated()
    steps = info_b["iterations"]
    record_launches(paths, cfg, "sweep_batch", launches_b, steps, steps)
    serial, launches_s = count_launches(
        lambda: [engine.optimize(p, resume_direction=d0)
                 for p in SWEEP_PROMPTS])
    record_launches(paths, cfg, "sweep_serial", launches_s,
                    n_prompts * steps, n_prompts * steps)
    # the serial run again (not gated): how far the card's own run-to-run
    # rounding moves a run's update
    repeat = [numpy(engine.optimize(p, resume_direction=d0)[0])
              for p in SWEEP_PROMPTS]

    batched = numpy(batched)
    serial_d = [numpy(d) for d, _ in serial]
    per_prompt = _update_agreement(batched, serial_d, d0)
    for p, (row, (d, info)) in enumerate(zip(per_prompt, serial)):
        row.update(prompt=SWEEP_PROMPTS[p],
                   moved=float(np.abs(serial_d[p] - d0).max()),
                   serial_steady_ms_per_step=info["steady_ms_per_step"])
    serial_s = sum(info["time"] for _, info in serial)
    serial_ms = statistics.mean(info["steady_ms_per_step"]
                                for _, info in serial)
    hist = np.asarray(info_b["history"])
    checks = {
        "steps": steps == -(-styles.shape[0] // fdc.batch_size),
        "history_shape": hist.shape == (n_prompts, steps),
        "history_finite": bool(np.isfinite(hist).all()),
        "moved": all(r["moved"] > 0 for r in per_prompt),
        "one_step": _agree(one_step, SWEEP_STEP_COS, SWEEP_STEP_NORM_RTOL),
        "run": _agree(per_prompt, SWEEP_COS, SWEEP_NORM_RTOL),
        "prompts_differ": _cosine(batched[0] - d0, batched[1] - d0) < 0.99}
    emit({"phase": "sweep", "card": smi, "prompts": n_prompts,
          "seeds": styles.shape[0], "batch": fdc.batch_size,
          "images_per_batched_step": n_prompts * fdc.batch_size,
          "precompute_s": precompute_s, "peak_mem_bytes": peak,
          "batched_steady_ms_per_step": info_b["steady_ms_per_step"],
          "batched_first_step_s": info_b["first_step_time"],
          "batched_time_s": info_b["time"],
          "serial_steady_ms_per_step": serial_ms,
          "serial_time_s": serial_s,
          "directions_per_hour_batched": n_prompts * 3600 / info_b["time"],
          "directions_per_hour_serial": n_prompts * 3600 / serial_s,
          "batched_over_serial_time": info_b["time"] / serial_s,
          "one_step": one_step, "per_prompt": per_prompt,
          "serial_repeat": _update_agreement(repeat, serial_d, d0),
          "gates": {"one_step": [SWEEP_STEP_COS, SWEEP_STEP_NORM_RTOL],
                    "run": [SWEEP_COS, SWEEP_NORM_RTOL]},
          "launches": {"precompute": pre, "batched": launches_b,
                       "serial": launches_s},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"sweep checks failed: {checks}")


@contextlib.contextmanager
def mtcnn_counters(mtcnn):
    """Count what each MTCNN stage passes while the block runs: stage-1
    boxes (after each scale's NMS), R-Net's and O-Net's inputs, the faces
    found, the frames and the seconds in detect_faces."""
    from stylemc_torch.models.mtcnn import detect

    counts = {"frames": 0, "stage1_boxes": 0, "rnet_inputs": 0,
              "onet_inputs": 0, "faces": 0, "frames_with_face": 0,
              "detect_s": 0.0}
    saved = detect.run_first_stage, detect.detect_faces, mtcnn.rnet, \
        mtcnn.onet
    first_stage, detect_faces, rnet, onet = saved

    def run_first_stage(*a, **kw):
        boxes = first_stage(*a, **kw)
        counts["stage1_boxes"] += 0 if boxes is None else len(boxes)
        return boxes

    def counted_detect(image, net, *a, **kw):
        t0 = time.perf_counter()
        faces, lms = detect_faces(image, net, *a, **kw)
        counts["detect_s"] += time.perf_counter() - t0
        counts["frames"] += 1
        counts["faces"] += len(faces)
        counts["frames_with_face"] += int(len(faces) > 0)
        return faces, lms

    def stage(fn, key):
        def run(x):
            counts[key] += len(x)
            return fn(x)
        return run

    detect.run_first_stage, detect.detect_faces = run_first_stage, \
        counted_detect
    mtcnn.rnet, mtcnn.onet = stage(rnet, "rnet_inputs"), \
        stage(onet, "onet_inputs")
    try:
        yield counts
    finally:
        detect.run_first_stage, detect.detect_faces, mtcnn.rnet, \
            mtcnn.onet = saved


def phase_landmarks(torch, models, styles, files, smi, paths):
    """find_direction with landmarks_in_graph at full width (the train
    phase's models and workload) and the landmark weights loaded through
    default_landmarker: prepare_landmarks_refs' seconds and MTCNN counts
    over the renders, steady ms/step, one profiled step's idle share, the
    landmarks term (finite, non-zero), and the native host library's
    calls (NMS and crop extraction must have gone through it)."""
    import numpy as np

    from stylemc_torch import native
    from stylemc_torch.cv.landmarks import default_landmarker
    from stylemc_torch.models.clip import FallbackTokenizer
    from stylemc_torch.train import find_direction as fd

    cfg, gp, _, _, clip, arc = models
    landmarker = default_landmarker(*files, device="cuda")
    fdc = fd.FindDirectionConfig(n_epochs=1, landmarks_in_graph=True)
    styles = styles[:LANDMARK_SEEDS]
    refs = {}
    prepare = fd.prepare_landmarks_refs

    def timed_prepare(*a, **kw):
        t0 = time.perf_counter()
        out = prepare(*a, **kw)
        torch.cuda.synchronize()
        refs.update(seconds=time.perf_counter() - t0, boxes=out[0],
                    landmarks=out[1])
        return out

    terms = []

    def callback(it, loss, aux, lr, grad_norm, direction):
        terms.append(aux["landmarks_loss"])

    for k in native.calls:
        native.calls[k] = 0
    fd.prepare_landmarks_refs = timed_prepare
    try:
        with mtcnn_counters(landmarker.mtcnn) as counts:
            (direction, info), launches = count_launches(
                lambda: fd.find_direction(
                    gp, cfg, styles, clip, arc, fdc,
                    tokenizer=FallbackTokenizer(), landmarker=landmarker,
                    callback=callback))
    finally:
        fd.prepare_landmarks_refs = prepare
    native_calls = dict(native.calls)
    steps = info["iterations"]
    chunks = -(-styles.shape[0] // 8)
    # the precompute and prepare_landmarks_refs each render every item once
    record_launches(paths, cfg, "landmarks", launches, 2 * chunks + steps,
                    steps)
    full = np.asarray([0, 0, fdc.resolution, fdc.resolution], np.float32)
    boxes = refs["boxes"].cpu().numpy()
    hist = np.asarray(info["history"])

    # one step, profiled, on the first four items
    bundles = fd.make_clip_bundles(fdc, clip, FallbackTokenizer())
    loss_fn = fd.make_loss_fn(gp, cfg, bundles, arc, fdc,
                              mobilenet_params=landmarker.params)
    idx = torch.arange(4, device="cuda")
    bank = (styles, *fd.precompute_original_features(
        gp, cfg, styles[:8], bundles, arc, fdc),
        (refs["boxes"], refs["landmarks"]))
    delta0 = direction[:, fd.TRAINABLE].clone()

    def one_step():
        return fd._sgd_step(loss_fn, bank, delta0, idx, fdc.learning_rate)

    breakdown = device_breakdown(torch, one_step, top=10)
    checks = {
        "steps": steps == -(-styles.shape[0] // fdc.batch_size),
        "history_finite": bool(np.isfinite(hist).all()),
        "landmarks_term_finite": bool(np.isfinite(terms).all()),
        "landmarks_term_nonzero": bool(all(t != 0 for t in terms)),
        "native_built": native.native_available(),
        "native_nms_used": native_calls["nms"] > 0,
        "native_crops_used": native_calls["extract_image_boxes"] > 0,
        "frames_detected": counts["frames"] == styles.shape[0]}
    emit({"phase": "landmarks", "card": smi, "seeds": styles.shape[0],
          "batch": fdc.batch_size,
          "landmarks_loss_coef": fdc.landmarks_loss_coef,
          "prepare_landmarks_refs_s": refs["seconds"],
          "prepare_s_per_frame": refs["seconds"] / styles.shape[0],
          "mtcnn": counts,
          "full_frame_boxes": int((np.abs(boxes - full).max(1) == 0).sum()),
          "first_step_s": info["first_step_time"],
          "steady_ms_per_step": info["steady_ms_per_step"],
          "time_s": info["time"], "loss_first_last": [hist[0], hist[-1]],
          "landmarks_term_by_callback": terms,
          "native_library": str(native.build_host_ops()),
          "native_calls": native_calls,
          "profiled_step": breakdown, "launches": launches,
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"landmarks checks failed: {checks}")
    return landmarker


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@contextlib.contextmanager
def tf32_control(torch):
    """The lower-precision control: TF32 (a 10-bit mantissa) in cuDNN's
    convolutions and cuBLAS's matmuls while the block runs. Each landmarks
    gate must tell it from the card's fp32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@contextlib.contextmanager
def landmarks_render(fd, seen, render=None):
    """While the block runs, the landmarks term of make_loss_fn's loss
    appends the image it is given to `seen`; given `render`, it reads
    render's values instead, its gradient still flowing to the step's own
    image."""
    crop = fd.crop_landmarks

    def crop_landmarks(mb, img, boxes):
        seen.append(img.detach().cpu())
        if render is not None:
            img = img + (render.to(img.device) - img).detach()
        return crop(mb, img, boxes)

    fd.crop_landmarks = crop_landmarks
    try:
        yield
    finally:
        fd.crop_landmarks = crop


def phase_landmarks_parity(torch, net, models, styles, direction_file,
                           landmarker, files, paths):
    """One full-width landmarks step (batch 2, seeds 1-2) from the seeded
    direction on the card and on the CPU. Both landmarks terms read the
    card's renders (the originals for the reference landmarks, the edit
    through landmarks_render) and crop the boxes MTCNN found on the card;
    the CLIP and ArcFace terms read each side's own render, as in
    train_parity. Gates, all fixed (PERF.md §6): losses within
    LANDMARKS_LOSS_RTOL; the Δs gradients within LANDMARKS_GRAD_REL_L2;
    the landmarks term's fp32 image gradient on the card and on the CPU
    against float64 at the card's render, each pushed back into Δs, within
    LANDMARKS_TERM_REL_L2; the card's MTCNN boxes against the CPU's on
    their own renders (same faces, within LANDMARKS_BOX_ATOL px). Each gate
    beside its TF32 control, which must fail it."""
    import numpy as np

    from stylemc_torch.cv.landmarks import default_landmarker
    from stylemc_torch.edit import to_uint8_hwc
    from stylemc_torch.io import load_generator
    from stylemc_torch.losses.landmarks_loss import landmarks_loss
    from stylemc_torch.models.clip import FallbackTokenizer
    from stylemc_torch.models.stylegan2.generator import synthesis
    from stylemc_torch.train import find_direction as fd

    cfg, gp, clip_cpu, arc_cpu, clip, arc = models
    _, gp_cpu = load_generator(net, device="cpu")
    cpu_landmarker = default_landmarker(*files, device="cpu")
    resume = np.load(direction_file)["s"].astype(np.float32)
    s = styles[1:3]
    fdc = fd.FindDirectionConfig(batch_size=2, n_epochs=1,
                                 landmarks_in_graph=True)
    until_k = fd.until_k_for_resolution(fdc.resolution)
    tok = FallbackTokenizer()

    with torch.no_grad():
        img_card = synthesis(gp, cfg, s, until_k=until_k)
        img_cpu = synthesis(gp_cpu, cfg, s.cpu(), until_k=until_k)
    full = np.asarray([0, 0, fdc.resolution, fdc.resolution], np.float32)

    def card_boxes():
        return fd.detect_crop_boxes(to_uint8_hwc(img_card), landmarker.mtcnn,
                                    fdc.resolution)

    def box_diff(a, b):
        """(faces found per frame, max |Δ| px; inf where the faces found
        differ from b's)."""
        fa = [bool(np.abs(x - full).max() > 0) for x in a]
        fb = [bool(np.abs(x - full).max() > 0) for x in b]
        return fa, (float(np.abs(a - b).max()) if fa == fb else
                    float("inf"))

    boxes = card_boxes()
    boxes_cpu = fd.detect_crop_boxes(to_uint8_hwc(img_cpu),
                                     cpu_landmarker.mtcnn, fdc.resolution)
    with tf32_control(torch):
        boxes_tf32 = card_boxes()
    found, boxes_diff = box_diff(boxes, boxes_cpu)
    found_cpu, _ = box_diff(boxes_cpu, boxes_cpu)
    _, boxes_diff_tf32 = box_diff(boxes_tf32, boxes_cpu)
    originals = img_card.cpu()

    def step(gparams, clip_models, arcface, mb, device, seen, render=None):
        bundles = fd.make_clip_bundles(fdc, clip_models, tok)
        st = s.to(device)
        id_f, clip_f = fd.precompute_original_features(
            gparams, cfg, st, bundles, arcface, fdc, chunk=2)
        b = torch.from_numpy(boxes).to(device)
        with torch.no_grad():
            lm0 = fd.crop_landmarks(mb, originals.to(device), b)
        dl = torch.from_numpy(resume[:, fd.TRAINABLE]).to(device)
        dl.requires_grad_(True)
        loss_fn = fd.make_loss_fn(gparams, cfg, bundles, arcface, fdc,
                                  mobilenet_params=mb)
        with landmarks_render(fd, seen, render):
            loss, aux = loss_fn(dl, st, id_f, clip_f, (b, lm0))
        g, = torch.autograd.grad(loss, dl)
        return (float(loss.detach()),
                {k: float(v.detach()) for k, v in aux.items()}, g.cpu(),
                lm0.cpu())

    seen = []
    (loss, aux, g, lm0), launches = count_launches(
        lambda: step(gp, clip, arc, landmarker.params, "cuda", seen))
    # the precompute and the loss: two synthesis calls, one differentiated
    record_launches(paths, cfg, "landmarks_parity", launches, 2, 1)
    edit_card = seen[0]
    with tf32_control(torch):
        g_tf32 = step(gp, clip, arc, landmarker.params, "cuda", [])[2]
    t0 = time.perf_counter()
    (loss_c, aux_c, g_c, lm0_c), cpu_launches = count_launches(
        lambda: step(gp_cpu, clip_cpu, arc_cpu, cpu_landmarker.params,
                     "cpu", [], edit_card))
    cpu_s = time.perf_counter() - t0

    # float64: the landmarks term's image gradient (crop, MobileNet, loss)
    # at the card's edited render, in float64 on the CPU, and in fp32 on
    # the CPU, on the card and on the card under TF32; each difference from
    # float64 pushed back through the CPU's generator into Δs and measured
    # against the CPU's Δs gradient with its landmarks term in float64
    def f64(tree):
        return {k: f64(v) if isinstance(v, dict) else v.double()
                for k, v in tree.items()}

    b = torch.from_numpy(boxes)
    side = (b[:, 2] - b[:, 0]).reshape(-1, 1, 1)

    def term_grad(mb, device="cpu", dtype=torch.float32):
        x = edit_card.to(device, dtype).requires_grad_(True)
        sd = side.to(device, dtype)
        term = fdc.landmarks_loss_coef * landmarks_loss(
            fd.crop_landmarks(mb, x, b.to(device, dtype)) * sd,
            lm0_c.to(device, dtype) * sd)
        return torch.autograd.grad(term, x)[0].cpu().double()

    dl = torch.from_numpy(resume[:, fd.TRAINABLE]).requires_grad_(True)
    img = synthesis(gp_cpu, cfg, s.cpu() + fd.assemble_direction(dl),
                    until_k=until_k)

    def back(v):
        return torch.autograd.grad(img, dl, v.float(), retain_graph=True)[0]

    g64 = term_grad(f64(cpu_landmarker.params), dtype=torch.float64)
    g32 = term_grad(cpu_landmarker.params)
    g_card = term_grad(landmarker.params, "cuda")
    with tf32_control(torch):
        g_card_tf32 = term_grad(landmarker.params, "cuda")
    g_ref = g_c + back(g64 - g32)
    term = {name: float(back(v - g64).norm() / g_ref.norm()) for name, v in (
        ("cpu_fp32", g32), ("card_fp32", g_card),
        ("card_tf32_control", g_card_tf32))}
    loss_rel = abs(loss - loss_c) / abs(loss_c)
    grad_rel = _rel(g, g_c)
    grad_rel_tf32 = _rel(g_tf32, g_c)
    checks = {
        "cpu_no_launch": not any(cpu_launches.values()),
        "faces": found == found_cpu, "boxes": boxes_diff <= LANDMARKS_BOX_ATOL,
        "loss": loss_rel <= LANDMARKS_LOSS_RTOL,
        "grad": grad_rel <= LANDMARKS_GRAD_REL_L2,
        "term_card": term["card_fp32"] <= LANDMARKS_TERM_REL_L2,
        "term_cpu": term["cpu_fp32"] <= LANDMARKS_TERM_REL_L2,
        "boxes_tf32_caught": boxes_diff_tf32 > LANDMARKS_BOX_ATOL,
        "grad_tf32_caught": grad_rel_tf32 > LANDMARKS_GRAD_REL_L2,
        "term_tf32_caught": term["card_tf32_control"] > LANDMARKS_TERM_REL_L2}
    emit({"phase": "landmarks_parity", "loss": loss, "cpu_loss": loss_c,
          "loss_rel": loss_rel, "aux": aux, "cpu_aux": aux_c,
          "grad_rel_l2": grad_rel, "grad_gate": LANDMARKS_GRAD_REL_L2,
          "grad_rel_l2_tf32_control": grad_rel_tf32,
          "grad_norm": float(g_c.norm()),
          "grad_rel_l2_to_fp64_reference": {"card": _rel(g, g_ref),
                                            "cpu": _rel(g_c, g_ref)},
          "landmarks_term_rel_l2_to_fp64": term,
          "landmarks_term_gate": LANDMARKS_TERM_REL_L2,
          "landmarks_term_image_grad_rel_l2_to_fp64": {
              "cpu_fp32": _rel(g32, g64), "card_fp32": _rel(g_card, g64)},
          "reference_landmarks_max_abs_diff": float((lm0 - lm0_c).abs()
                                                    .max()),
          "boxes": boxes.tolist(), "cpu_boxes": boxes_cpu.tolist(),
          "faces_found": found, "cpu_faces_found": found_cpu,
          "box_max_abs_diff": boxes_diff,
          "box_max_abs_diff_tf32_control": boxes_diff_tf32,
          "box_gate_px": LANDMARKS_BOX_ATOL, "cpu_s": cpu_s,
          "launches": launches, "cpu_launches": cpu_launches,
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"landmarks_parity checks failed: {checks}")


def phase_landmarks_metric(torch, net, models, styles, direction_file,
                           landmarker, files, paths):
    """The logging-only metric (make_landmarks_metric_fn) on 4 seeds with
    the seeded direction, on the card and on the CPU, within
    LANDMARKS_METRIC_RTOL; the CPU run and the card's TF32 control (which
    must fail the gate) replay the card's MTCNN detections, so all three
    crop the same faces."""
    import numpy as np

    from stylemc_torch.cv.landmarks import default_landmarker
    from stylemc_torch.io import load_generator
    from stylemc_torch.models.mtcnn import detect
    from stylemc_torch.train.find_direction import (FindDirectionConfig,
                                                    make_landmarks_metric_fn)

    cfg, gp = models[:2]
    _, gp_cpu = load_generator(net, device="cpu")
    fdc = FindDirectionConfig()
    direction = torch.from_numpy(np.load(direction_file)["s"]
                                 .astype(np.float32))
    s = styles[:4]
    detect_faces = detect.detect_faces
    found = []

    def record(*a, **kw):
        found.append(detect_faces(*a, **kw))
        return found[-1]

    detect.detect_faces = record
    try:
        t0 = time.perf_counter()
        value, launches = count_launches(lambda: make_landmarks_metric_fn(
            gp, cfg, fdc, landmarker)(direction.cuda(), s))
        card_s = time.perf_counter() - t0
        replay = iter(found)
        detect.detect_faces = lambda *a, **kw: next(replay)
        t0 = time.perf_counter()
        cpu_value = make_landmarks_metric_fn(
            gp_cpu, cfg, fdc, default_landmarker(*files, device="cpu"))(
            direction, s.cpu())
        cpu_s = time.perf_counter() - t0
        replay = iter(found)
        with tf32_control(torch):
            tf32_value = make_landmarks_metric_fn(gp, cfg, fdc, landmarker)(
                direction.cuda(), s)
    finally:
        detect.detect_faces = detect_faces
    # the originals and the edits: two synthesis calls
    record_launches(paths, cfg, "landmarks_metric", launches, 2)

    def rel(v):
        return abs(v - cpu_value) / max(abs(cpu_value), 1e-30)

    checks = {"positive": value > 0,
              "metric": rel(value) <= LANDMARKS_METRIC_RTOL,
              "tf32_caught": rel(tf32_value) > LANDMARKS_METRIC_RTOL}
    emit({"phase": "landmarks_metric", "metric": value,
          "cpu_metric": cpu_value, "rel": rel(value),
          "tf32_control_metric": tf32_value,
          "tf32_control_rel": rel(tf32_value),
          "gate": LANDMARKS_METRIC_RTOL,
          "frames_with_face": sum(len(f[0]) > 0 for f in found),
          "frames": len(found), "card_s": card_s, "cpu_s": cpu_s,
          "launches": launches, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"landmarks_metric checks failed: {checks}")


def phase_sweep_clis(cfg, net, styles, tmp, files, paths):
    """find_direction's sweep and landmarks CLIs as subprocesses on
    SWEEP_CLI_SEEDS seeds (batch 4, one epoch: one precompute chunk and
    two steps): --text_prompts --batch_prompts, again with --resume <the
    first run's directory>, and --landmarks_grad with the landmark files
    (STYLEMC_MTCNN_DIR, STYLEMC_MOBILENET)."""
    import numpy as np

    s_file = os.path.join(tmp, "sweep_input.npz")
    np.savez(s_file, s=styles[1:1 + SWEEP_CLI_SEEDS].cpu().numpy())
    prompts = SWEEP_PROMPTS[:3]
    tags = [p.replace(" ", "_") for p in prompts]
    first, second, lm_out = (os.path.join(tmp, d) for d in
                             ("sweep1", "sweep2", "landmarks_grad"))
    common = ["--network", net, "--s_input", s_file, "--allow_random_init",
              "--n_epochs", "1", "--batch_size", "4"]
    env = {"STYLEMC_MTCNN_DIR": files[0], "STYLEMC_MOBILENET": files[1]}

    def run(path, synthesis_calls, *args, **kw):
        return run_cli(paths, cfg, f"cli_{path}", "find_direction",
                       synthesis_calls, 2, *common, *args, **kw)

    sweep = ["--text_prompts", "|".join(prompts), "--batch_prompts"]
    secs, outs = zip(*[
        run("sweep", 3, "--outdir", first, *sweep),
        run("sweep_resume", 3, "--outdir", second, *sweep, "--resume",
            first),
        # the precompute, the renders for the MTCNN boxes, two steps
        run("landmarks_grad", 4, "--outdir", lm_out, "--text_prompt",
            prompts[0], "--landmarks_grad", env=env)])
    d1 = [np.load(os.path.join(first, f"direction_{t}.npz"))["s"]
          for t in tags]
    d2 = [np.load(os.path.join(second, f"direction_{t}.npz"))["s"]
          for t in tags]
    d_lm = np.load(os.path.join(lm_out, f"direction_{tags[0]}.npz"))["s"]
    lm_line = [x for x in outs[2].splitlines() if "landmarks loss:" in x]
    checks = {
        "files": all(d.shape == (1, 26, 512) for d in d1 + d2 + [d_lm]),
        "finite": bool(all(np.isfinite(d).all() for d in d1 + d2 + [d_lm])),
        "resumed": all(f"Resuming {p!r} from {first}" in outs[1]
                       for p in prompts),
        "resume_moved": all(np.abs(a - b).max() > 0
                            for a, b in zip(d1, d2)),
        "landmarks_logged": bool(lm_line) and float(
            lm_line[-1].split("landmarks loss:")[1].split(",")[0]) > 0}
    emit({"phase": "sweep_clis", "seconds": list(secs),
          "launches": {k: paths[f"cli_{k}"]["launches"] for k in
                       ("sweep", "sweep_resume", "landmarks_grad")},
          "sweep_tail": outs[0].strip().splitlines()[-2:],
          "landmarks_grad_tail": outs[2].strip().splitlines()[-4:],
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"sweep CLI checks failed: {checks}")


def phase_e4e_align(ckpt, photos, inv_codes, tmp, files, paths):
    """align_faces on the e4e photos (FFHQ alignment at 256 from the
    landmark files), then infer_e4e --align on the same photos, as
    subprocesses; neither renders."""
    import numpy as np

    from stylemc_torch.io.rosinality import config_for_rosinality

    cfg = config_for_rosinality(E4E_SIZE)
    aligned = os.path.join(tmp, "e4e_aligned")
    inv = os.path.join(tmp, "e4e_inversion_aligned")
    env = {"STYLEMC_MTCNN_DIR": files[0], "STYLEMC_MOBILENET": files[1]}
    secs, outs = zip(*[
        run_cli(paths, cfg, "e4e_cli_align_faces", "align_faces", 0, 0,
                "--images_dir", photos, "--out_dir", aligned,
                "--output_size", "256", env=env),
        run_cli(paths, cfg, "e4e_cli_infer_e4e_align", "infer_e4e", 0, 0,
                "--images_dir", photos, "--ckpt", ckpt, "--save_dir", inv,
                "--stylegan_size", str(E4E_SIZE), "--batch", "4", "--align",
                env=env)])
    w = np.load(os.path.join(inv, "projected_w.npz"))["w"]
    imgs = [_decode(open(os.path.join(aligned, f), "rb").read())
            for f in sorted(os.listdir(aligned))]
    checks = {
        "aligned_all": f"aligned {E4E_PHOTOS}/{E4E_PHOTOS}" in outs[0],
        "aligned_shapes": len(imgs) == E4E_PHOTOS and all(
            a.shape == (256, 256, 3) for a in imgs),
        "w_shape": w.shape == (E4E_PHOTOS, cfg.num_ws, 512),
        "w_finite": bool(np.isfinite(w).all()),
        "alignment_changes_codes": bool(np.abs(w - inv_codes).max() > 0)}
    emit({"phase": "e4e_align", "seconds": list(secs),
          "max_abs_code_change": float(np.abs(w - inv_codes).max()),
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"e4e align checks failed: {checks}")


# --------------------------------------- the latent mapper and DeepLab

MAPPER_SEEDS = 129
# FFHQ-1024 generators' weight seeds: --network and --network2
MAPPER_NET_SEEDS = (10, 11)
MAPPER_SEED = 12          # the seeded mapper of the parity and serving phases
MAPPER_UNTIL_K = 7        # a mapper step renders FFHQ-1024 to 512 px
MAPPER_PROMPT = "smiling face"
# the mapper step's loss, card against CPU: fp32 reads ~7e-8, and TF32
# ~9e-6, which 1e-4 would not tell from fp32
MAPPER_LOSS_RTOL = 1e-6
MAPPER_OUT_REL_L2 = 1e-4
MAPPER_DIRECTION_ATOL = 1e-5
MAPPER_CLI_SEEDS = 8
# generate_fromS --use_blending's --batch: two buckets of the 8 seeds
MAPPER_CLI_BATCH = 4
DEEPLAB_SEED = 13
# the blended renders, card against CPU on the card's masks: the share of
# uint8 values that differ (by one at most)
BLEND_OFF_SHARE = 1e-3
# each stage's output, card against CPU on the same input
DEEPLAB_STAGE_REL_L2 = 1e-4
# class maps are held where the top-two logit gap exceeds this share of the
# logits' largest magnitude
DEEPLAB_TIE_GAP = 1e-3


def make_ffhq1024(torch, tmp, seed):
    """Full-width FFHQ-1024 generator (channel_base 32768, channel_max 512,
    8 mapping layers) with random weights from `seed`, saved as a native
    .npz the way `make_network` saves FFHQ-256. Its ToRGB weights are
    scaled by E4E_TORGB_SCALE, as the e4e decoder's are, so that renders
    lie mostly inside [-1, 1] and the uint8 comparisons read values, not
    the clip at 0 and 255."""
    from stylemc_torch.io import save_native
    from stylemc_torch.models.stylegan2.generator import (
        GeneratorConfig, init_generator_params)

    cfg = GeneratorConfig(img_resolution=1024)
    params = init_generator_params(torch.Generator().manual_seed(seed), cfg,
                                   device="cpu")
    for bp in params["synthesis"].values():
        bp["torgb"]["weight"] *= E4E_TORGB_SCALE
    path = os.path.join(tmp, f"ffhq1024_seed{seed}.npz")
    save_native(path, cfg, params)
    return cfg, path


def seed_styles(torch, gp, cfg, seeds, device):
    """S-space styles of `seeds` as `BatchEditor.styles_from_seeds` makes
    them: z from np.random.RandomState(seed), truncation 0.7."""
    import numpy as np

    from stylemc_torch.models.stylegan2.generator import mapping, w_to_s

    zs = np.concatenate([np.random.RandomState(s).randn(1, cfg.z_dim)
                         for s in seeds]).astype(np.float32)
    with torch.no_grad():
        ws = mapping(gp, cfg, torch.from_numpy(zs).to(device),
                     truncation_psi=0.7)
        return w_to_s(gp, cfg, ws)


def seeded_mapper(torch, seed, device):
    from stylemc_torch.models.mapper import init_mapper_params

    return init_mapper_params(torch.Generator().manual_seed(seed),
                              device=device)


def _gate(name, value, control, gate, record):
    """Keep a gate's reading and its TF32 control's beside the fixed gate;
    the reading must pass it and the control must fail it."""
    record[name] = {"value": value, "tf32_control": control, "gate": gate}
    if not value <= gate:
        raise AssertionError(f"{name}: {value} > {gate}")
    if not control > gate:
        raise AssertionError(f"{name}: the TF32 control {control} passes "
                             f"the gate {gate}")


def phase_mapper(torch, models, net, smi, paths):
    """train_latent_mapper at full width: the FFHQ-1024 generator at 512 px
    (until_k 7), the train phase's CLIP ViT-B/32 + B/16 and IR-SE-50,
    MapperTrainConfig's defaults (batch 2, Adam lr 5e-4), fp32, TF32 off,
    MAPPER_SEEDS seeds, one epoch; then one Adam step profiled."""
    import copy

    import numpy as np

    from stylemc_torch.bench.timing import card_state
    from stylemc_torch.io import load_generator
    from stylemc_torch.models.clip import FallbackTokenizer
    from stylemc_torch.models.mapper import mapper_apply
    from stylemc_torch.train.find_direction import (
        TRAINABLE, make_clip_bundles, make_loss_fn,
        precompute_original_features)
    from stylemc_torch.train.latent_mapper import (
        MapperTrainConfig, _adam_step, make_mapper_edit, train_latent_mapper)

    clip, arc = models[4], models[5]
    cfg, gp = load_generator(net, device="cuda")   # polyphase up-convs
    styles = seed_styles(torch, gp, cfg, range(MAPPER_SEEDS), "cuda")
    mtc = MapperTrainConfig(n_epochs=1, text_prompt=MAPPER_PROMPT)
    tok = FallbackTokenizer()
    logged = []

    def callback(it, loss, aux, lr, grad_norm, mapper):
        logged.append({"it": it, "loss": loss, "lr": lr,
                       "grad_norm": grad_norm})

    torch.cuda.reset_peak_memory_stats()
    before = card_state()
    t0 = time.perf_counter()
    (mapper, info), launches = count_launches(lambda: train_latent_mapper(
        gp, cfg, styles, clip, arc, mtc, tokenizer=tok, callback=callback))
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    states = [before, card_state()]
    steps = info["iterations"]
    record_launches(paths, cfg, "mapper", launches,
                    -(-MAPPER_SEEDS // 8) + steps, steps,
                    upper_blocks=MAPPER_UNTIL_K)
    hist = np.asarray(info["history"])
    steady = info["steady_ms_per_step"]
    x = styles[:4, TRAINABLE]
    with torch.no_grad():
        moved = float((mapper_apply(mapper, x, mtc.mapper_neg_slope)
                       - mapper_apply(seeded_mapper(torch, mtc.seed, "cuda"),
                                      x, mtc.mapper_neg_slope)).abs().max())
    checks = {"steps": steps == -(-MAPPER_SEEDS // mtc.batch_size),
              "history_finite": bool(np.isfinite(hist).all()),
              "history_len": len(hist) == steps,
              "callback_every_10": [r["it"] for r in logged]
              == list(range(10, steps + 1, 10)),
              "mapper_moved": moved > 0}
    emit({"phase": "mapper", "card": smi, "seeds": MAPPER_SEEDS,
          "generator": "FFHQ-1024 (channel_base 32768, channel_max 512, "
                       "8 mapping layers), random weights",
          "resolution": mtc.resolution, "until_k": MAPPER_UNTIL_K,
          "batch": mtc.batch_size, "clip_type": mtc.clip_type,
          "precision": "fp32", "learning_rate": mtc.learning_rate,
          "precompute_s": wall_s - info["time"],
          "first_step_s": info["first_step_time"],
          "steady_ms_per_step": steady, "steps_per_s": 1e3 / steady,
          "images_per_s": mtc.batch_size * 1e3 / steady,
          "time_s": info["time"], "peak_mem_bytes": peak,
          "loss_first_last": [hist[0], hist[-1]], "logged": logged,
          "mapper_output_moved": moved, "card_state": states,
          "launches": launches, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"mapper checks failed: {checks}")

    # one Adam step on a copy of the trained mapper, profiled
    bundles = make_clip_bundles(mtc, clip, tok)
    s2 = styles[:2]
    id2, clip2 = precompute_original_features(gp, cfg, s2, bundles, arc, mtc,
                                              chunk=2)
    m = copy.deepcopy(mapper)
    opt = torch.optim.Adam(m.parameters(), lr=mtc.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    loss_fn = make_loss_fn(gp, cfg, bundles, arc, mtc,
                           edit_fn=make_mapper_edit(mtc.mapper_neg_slope))
    idx = torch.arange(2, device="cuda")
    emit({"phase": "mapper_breakdown", "card": smi,
          **device_breakdown(torch, lambda: _adam_step(
              loss_fn, (s2, id2, clip2, None), opt, m, idx,
              mtc.learning_rate), top=15)})
    return cfg, styles


def phase_mapper_parity(torch, models, net, smi, paths):
    """One full-width mapper step (batch 2, seeds 1-2) from the seeded
    mapper, on the card and on the CPU: the loss (rtol 1e-6) and the 20
    gradients concatenated (relative L2 1e-3, PARITY_GRAD_REL_L2); then
    Adam's step from the card's gradient on both sides, the mapper's
    outputs on the two items after it within relative L2 1e-4 (fed the
    same gradient, as the blending parity is fed the same masks: Adam's
    first step is lr·sign(g) elementwise, so gradients 1e-3 apart flip the
    sign of their near-zero elements). Each gate beside a TF32 control of
    the card's side that must fail it. Recorded beside them, not gated:
    each side's outputs after its own Adam step, the elements whose
    gradient signs differ, and the identity term's image gradient at the
    card's render on each side against float64 ArcFace on the CPU. The
    step's learning rate is the first of a default run (10 epochs over
    MAPPER_SEEDS seeds)."""
    from stylemc_torch.io import load_generator
    from stylemc_torch.losses.id_loss import extract_feats
    from stylemc_torch.models.clip import FallbackTokenizer
    from stylemc_torch.models.mapper import (
        mapper_apply, params_from_torch_state, params_to_torch_state)
    from stylemc_torch.models.stylegan2.generator import synthesis
    from stylemc_torch.train.find_direction import (
        TRAINABLE, cosine_lr, make_clip_bundles, make_loss_fn,
        precompute_original_features)
    from stylemc_torch.train.latent_mapper import (
        MapperTrainConfig, _adam_step, make_mapper_edit)

    clip_cpu, arc_cpu, clip, arc = models[2:]
    cfg, gp = load_generator(net, device="cuda")
    _, gp_cpu = load_generator(net, device="cpu")
    styles = seed_styles(torch, gp, cfg, [1, 2], "cuda")
    mtc = MapperTrainConfig(batch_size=2, text_prompt=MAPPER_PROMPT)
    lr = cosine_lr(mtc.learning_rate, 1,
                   -(-MAPPER_SEEDS // mtc.batch_size) * mtc.n_epochs)
    state = params_to_torch_state(seeded_mapper(torch, MAPPER_SEED, "cpu"))
    edit = make_mapper_edit(mtc.mapper_neg_slope)
    tok = FallbackTokenizer()

    def adam(m):
        return torch.optim.Adam(m.parameters(), lr=lr, betas=(0.9, 0.999),
                                eps=1e-8)

    def outputs(m, s):
        with torch.no_grad():
            return mapper_apply(m, s[:, TRAINABLE],
                                mtc.mapper_neg_slope).cpu()

    def step(gparams, clips, arcface, s, device):
        bundles = make_clip_bundles(mtc, clips, tok)
        id_f, clip_f = precompute_original_features(
            gparams, cfg, s, bundles, arcface, mtc, chunk=2)
        m = params_from_torch_state(state, device)
        with torch.no_grad():
            img = synthesis(gparams, cfg, edit(m, s), until_k=MAPPER_UNTIL_K)
        loss_fn = make_loss_fn(gparams, cfg, bundles, arcface, mtc,
                               edit_fn=edit)
        _, loss, aux, grad_norm = _adam_step(
            loss_fn, (s, id_f, clip_f, None), adam(m), m,
            torch.arange(2, device=device), lr)
        grads = torch.cat([p.grad.reshape(-1) for p in m.parameters()])
        return (float(loss), {k: float(v) for k, v in aux.items()},
                float(grad_norm), grads.cpu(), outputs(m, s), img.cpu(),
                id_f.cpu())

    def step_from(grads, s, device):
        """Adam's step from `grads` (flat), on a fresh seeded mapper."""
        m = params_from_torch_state(state, device)
        lo = 0
        for p in m.parameters():
            p.grad = grads[lo:lo + p.numel()].reshape(p.shape).to(device)
            lo += p.numel()
        adam(m).step()
        return outputs(m, s)

    (loss, aux, gn, g, out, img, id_f), launches = count_launches(
        lambda: step(gp, clip, arc, styles, "cuda"))
    # the precompute, the render and the step: three synthesis calls, one
    # backward pass
    record_launches(paths, cfg, "mapper_parity", launches, 3, 1,
                    upper_blocks=MAPPER_UNTIL_K)
    fed = step_from(g, styles, "cuda")
    with tf32_control(torch):
        loss_t, _, _, g_t, _, _, _ = step(gp, clip, arc, styles, "cuda")
        fed_t = step_from(g, styles, "cuda")
    t0 = time.perf_counter()
    (loss_c, aux_c, gn_c, g_c, out_c, _, _), cpu_launches = count_launches(
        lambda: step(gp_cpu, clip_cpu, arc_cpu, styles.cpu(), "cpu"))
    fed_c = step_from(g, styles.cpu(), "cpu")
    cpu_s = time.perf_counter() - t0

    def identity_grad(arcface, x, feats):
        x = x.requires_grad_(True)
        term = mtc.identity_loss_coef * torch.mean(1.0 - torch.sum(
            extract_feats(arcface, x, mtc.arcface_layout) * feats, dim=1))
        return torch.autograd.grad(term, x)[0].cpu().double()

    def f64(tree):
        return {k: f64(v) if isinstance(v, dict) else v.double()
                for k, v in tree.items()}

    id64 = identity_grad(f64(arc_cpu), img.double(), id_f.double())
    flips = torch.sign(g) != torch.sign(g_c)
    readings = {
        "loss_rel": (abs(loss - loss_c) / abs(loss_c),
                     abs(loss_t - loss_c) / abs(loss_c), MAPPER_LOSS_RTOL),
        "grad_rel_l2": (_rel(g, g_c), _rel(g_t, g_c), PARITY_GRAD_REL_L2),
        "output_rel_l2_same_gradient": (_rel(fed, fed_c), _rel(fed_t, fed_c),
                                        MAPPER_OUT_REL_L2)}
    emit({"phase": "mapper_parity", "card": smi, "loss": loss,
          "cpu_loss": loss_c, "aux": aux, "cpu_aux": aux_c,
          "grad_norm": gn, "cpu_grad_norm": gn_c, "learning_rate": lr,
          "gates": {k: {"value": v, "tf32_control": t, "gate": gate}
                    for k, (v, t, gate) in readings.items()},
          "output_rel_l2_own_gradients": _rel(out, out_c),
          "gradient_sign_flips": int(flips.sum()),
          "gradient_elements": int(g.numel()),
          "flipped_max_abs_over_rms": float(
              g_c[flips].abs().max() / g_c.square().mean().sqrt())
          if flips.any() else 0.0,
          "identity_image_grad_rel_l2_to_fp64": {
              "card_fp32": _rel(identity_grad(arc, img.cuda(), id_f.cuda())
                                .cpu(), id64),
              "cpu_fp32": _rel(identity_grad(arc_cpu, img.clone(), id_f),
                               id64)},
          "cpu_s": cpu_s, "launches": launches,
          "cpu_launches": cpu_launches})
    if any(cpu_launches.values()):
        raise AssertionError("the CPU step launched a CUDA kernel")
    for name, reading in readings.items():
        _gate(name, *reading, {})


def deeplab_image(size=512, seed=DEEPLAB_SEED):
    """A seeded uint8 image: a smooth random field plus pixel noise."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    low = Image.fromarray((rs.rand(8, 8, 3) * 255).astype(np.uint8))
    img = np.asarray(low.resize((size, size), Image.BICUBIC), np.float32)
    return np.clip(img + rs.randn(size, size, 3) * 8, 0,
                   255).astype(np.uint8)


def phase_deeplab(torch, cfg, tmp, smi, paths):
    """The full-width face parser (ResNet-101 layers (3, 4, 23, 3), width
    64, 19 classes) from seeded weights, written in the reference's
    checkpoint layout and read by default_segmenter through
    STYLEMC_DEEPLAB: ms per network and per `segment` call at 513² and the
    device split by kernel name. Card against CPU, each stage (the stem,
    the 33 bottlenecks, ASPP, the upsample) fed the CPU's input to it,
    every stage's output within relative L2 1e-4 beside the TF32 control
    (fp32 error grows through the 33 bottlenecks: the end-to-end logits,
    each side against float64 on the CPU, are recorded, not gated); the
    class maps equal wherever the top-two gap clears DEEPLAB_TIE_GAP."""
    from stylemc_torch.convert import params_from_numpy
    from stylemc_torch.models.deeplab import (
        INPUT_SIZE, _bilinear_ac, deeplab_apply, deeplab_stages,
        default_segmenter, init_deeplab_params, preprocess,
        save_deeplab_checkpoint)

    params = init_deeplab_params(torch.Generator().manual_seed(DEEPLAB_SEED))
    ckpt = os.path.join(tmp, "deeplab_model.pth")
    save_deeplab_checkpoint(ckpt, params)
    saved = os.environ.get("STYLEMC_DEEPLAB")
    os.environ["STYLEMC_DEEPLAB"] = ckpt
    try:
        seg = default_segmenter(resolution=512, device="cuda")
    finally:
        if saved is None:
            del os.environ["STYLEMC_DEEPLAB"]
        else:
            os.environ["STYLEMC_DEEPLAB"] = saved
    img = deeplab_image()
    logits, launches = count_launches(lambda: seg.logits(img).cpu())
    record_launches(paths, cfg, "deeplab", launches, 0)

    def f64(tree):
        return {k: f64(v) if isinstance(v, dict) else v.double()
                for k, v in tree.items()}

    x = torch.from_numpy(preprocess(img))
    cpu_params = params_from_numpy(params, "cpu")
    t0 = time.perf_counter()
    stages = []
    with torch.inference_mode():
        h = x
        for (name, cpu_fn), (_, card_fn) in zip(
                deeplab_stages(cpu_params), deeplab_stages(seg.params)):
            out = cpu_fn(h)
            stages.append((name, card_fn(h.cuda()).cpu(), out))
            with tf32_control(torch):
                stages[-1] += (card_fn(h.cuda()).cpu(),)
            h = out
        up = _bilinear_ac(h, INPUT_SIZE, INPUT_SIZE)
        stages.append(("upsample", _bilinear_ac(
            h.cuda(), INPUT_SIZE, INPUT_SIZE).cpu(), up))
        with tf32_control(torch):
            stages[-1] += (_bilinear_ac(h.cuda(), INPUT_SIZE,
                                        INPUT_SIZE).cpu(),)
        logits_c = up
        cpu_s = time.perf_counter() - t0
        logits_64 = deeplab_apply(f64(cpu_params), x.double())
        with tf32_control(torch):
            logits_t = seg.logits(img).cpu()
    by_stage = {name: (_rel(card, cpu), _rel(t32, cpu))
                for name, card, cpu, t32 in stages}
    worst = max(v for v, _ in by_stage.values())
    # TF32 moves the matmul/conv stages; the upsample and max pool read
    # alike under it, so the control is held on the stages' maximum
    worst_t = max(t for _, t in by_stage.values())
    top2 = torch.topk(logits_c[0], 2, dim=0).values
    clear = (top2[0] - top2[1]) > DEEPLAB_TIE_GAP * logits_c.abs().max()
    agree = logits[0].argmax(0) == logits_c[0].argmax(0)
    xc = x.cuda()
    with torch.inference_mode():
        net_ms = event_ms(lambda: deeplab_apply(seg.params, xc), iters=10,
                          warmup=2)
    segment_ms = event_ms(lambda: seg.segment(img), iters=10, warmup=2)
    emit({"phase": "deeplab", "card": smi,
          "network": "ResNet-101 (3, 4, 23, 3), width 64, 19 classes, "
                     "random weights", "input": [1, 3, INPUT_SIZE,
                                                 INPUT_SIZE],
          # one call queues ~1.5k launches, more than the launch queue
          # holds behind a sleep kernel: back-to-back CUDA events instead
          "segment_event_ms": segment_ms, "network_event_ms": net_ms,
          "times_are": "CUDA events over 10 back-to-back calls (host cost "
                       "included; segment adds the host resizes and the "
                       "class map's copy)",
          "stage_rel_l2": {k: v for k, (v, _) in by_stage.items()},
          "stage_rel_l2_tf32_control": {k: t for k, (_, t) in
                                        by_stage.items()},
          "stage_gate": DEEPLAB_STAGE_REL_L2,
          "logit_rel_l2": _rel(logits, logits_c),
          "logit_rel_l2_tf32_control": _rel(logits_t, logits_c),
          "logit_rel_l2_to_fp64": {"card_fp32": _rel(logits, logits_64),
                                   "cpu_fp32": _rel(logits_c, logits_64)},
          "pixels": int(clear.numel()),
          "pixels_near_tie": int((~clear).sum()),
          "pixels_clear_disagreeing": int((clear & ~agree).sum()),
          "pixels_near_tie_disagreeing": int((~clear & ~agree).sum()),
          "classes_present": int(logits_c[0].argmax(0).unique().numel()),
          "cpu_s": cpu_s, "launches": launches})
    emit({"phase": "deeplab_breakdown", "card": smi,
          **device_breakdown(torch, lambda: seg.logits(img), top=10)})
    _gate("deeplab_stage_rel_l2", worst, worst_t, DEEPLAB_STAGE_REL_L2, {})
    if int((clear & ~agree).sum()):
        raise AssertionError("the card's class map differs from the CPU's "
                             "where the top-two gap is clear")
    return ckpt, seg


class _RecordingSegmenter:
    """Passes the card's segmenter through and keeps the masks it gave,
    so the CPU side can be fed the same ones."""

    def __init__(self, seg):
        self.seg, self.masks = seg, []

    def get_bg_mask(self, img_u8):
        self.masks.append(self.seg.get_bg_mask(img_u8))
        return self.masks[-1]

    def get_earring_mouth_teeth_masks(self, img_u8, need_earring_mask=True):
        self.masks.append(self.seg.get_earring_mouth_teeth_masks(
            img_u8, need_earring_mask))
        return self.masks[-1]


class _ReplayingSegmenter:
    def __init__(self, masks):
        self.masks = list(masks)

    def get_bg_mask(self, img_u8):
        return self.masks.pop(0)

    def get_earring_mouth_teeth_masks(self, img_u8, need_earring_mask=True):
        return self.masks.pop(0)


def phase_mapper_clis(torch, cfg, net, net2, styles, ckpt, seg, tmp, smi,
                      paths):
    """On MAPPER_CLI_SEEDS seeds, as subprocesses, each counting its
    launches from 0: train_latent_mapper (one epoch, --network2 a second
    seeded FFHQ-1024 generator), generate_fromS --use_mapper 1
    --use_whitelist 1, generate_fromS --use_mapper 1 --use_blending 1
    --batch MAPPER_CLI_BATCH (STYLEMC_DEEPLAB the seeded parser),
    run_deeplab on the blended JPEGs. Then the first bucket blended in
    this process through BatchEditor with `seg` attached, and one item
    blended on the card and on the CPU, both fed the card's masks:
    renders within ±1 per uint8, beside the TF32 control."""
    import shutil

    import numpy as np
    from PIL import Image

    from stylemc_torch.edit import apply_edit_item_with_blending, \
        mapper_direction
    from stylemc_torch.io import load_generator
    from stylemc_torch.models.mapper import load_mapper
    from stylemc_torch.serve import BatchEditor

    s_file = os.path.join(tmp, "mapper_input.npz")
    np.savez(s_file, s=styles[1:1 + MAPPER_CLI_SEEDS].cpu().numpy())
    tag = MAPPER_PROMPT.replace(" ", "_")
    out, blend = (os.path.join(tmp, d) for d in ("mapper_out",
                                                  "mapper_blend"))
    env = {"STYLEMC_DEEPLAB": ckpt}

    def run(path, name, synthesis_calls, backward_calls, *args, **kw):
        return run_cli(paths, cfg, f"cli_{path}", name, synthesis_calls,
                       backward_calls, *args, **kw)

    steps = MAPPER_CLI_SEEDS // 2
    common = ["--network", net, "--s_input", s_file, "--text_prompt",
              MAPPER_PROMPT]
    # one precompute chunk, then each step's synthesis (by --network2) and
    # backward pass, all to 512 px
    train = run("train_latent_mapper", "train_latent_mapper", 1 + steps,
                steps, *common, "--network2", net2, "--outdir", out,
                "--allow_random_init", "--n_epochs", "1",
                upper_blocks=MAPPER_UNTIL_K)
    mapper_file = os.path.join(out, f"mapper_{tag}.pth")
    os.makedirs(blend)
    shutil.copy(mapper_file, blend)
    # the batched path: originals and edits, one call each
    white = run("generate_fromS_mapper", "generate_fromS", 2, 0, *common,
                "--outdir", out, "--use_mapper", "1", "--use_whitelist", "1")
    # blending: BatchEditor, three synthesis calls a bucket of --batch
    buckets = -(-MAPPER_CLI_SEEDS // MAPPER_CLI_BATCH)
    blended = run("generate_fromS_blending", "generate_fromS", 3 * buckets,
                  0, *common, "--outdir", blend, "--use_mapper", "1",
                  "--use_blending", "1", "--batch", str(MAPPER_CLI_BATCH),
                  env=env)
    parse = run("run_deeplab", "run_deeplab", 0, 0, "--dataset_root", blend,
                "--ckpt", ckpt)

    def jpegs(d):
        names = [f"{tag}_{i:03d}.jpeg" for i in range(MAPPER_CLI_SEEDS)]
        imgs = []
        for name in names:
            with open(os.path.join(d, name), "rb") as fh:
                imgs.append(_decode(fh.read()))
        return imgs

    res = cfg.img_resolution
    white_imgs, blend_imgs = jpegs(out), jpegs(blend)
    parsings = sorted(os.listdir(os.path.join(blend, "parsings")))
    mapper = load_mapper(mapper_file, device="cuda")
    checks = {
        "mapper_file": len(torch.load(mapper_file, weights_only=True)) == 20,
        "jpeg_shapes": all(a.shape == (res, 2 * res, 3)
                           for a in white_imgs + blend_imgs),
        "left_ne_right": all(np.abs(a[:, :res].astype(int)
                                    - a[:, res:].astype(int)).max() > 0
                             for a in white_imgs + blend_imgs),
        "blending_differs": any(np.abs(a.astype(int) - b.astype(int)).max()
                                > 0 for a, b in zip(white_imgs,
                                                    blend_imgs)),
        "parsings": parsings == [f"{tag}_{i:03d}.png"
                                 for i in range(MAPPER_CLI_SEEDS)],
        "two_generators": "using 2 generators" in train[1]}

    # the CLI's first bucket, blended in this process: one network call
    # for its originals and one for its edits
    _, gp = load_generator(net, device="cuda")
    editor = BatchEditor(cfg, gp, mapper_params=mapper,
                         max_batch=MAPPER_CLI_BATCH, device="cuda")
    editor.attach_segmenter(seg)
    calls, rows = seg.deeplab_calls, seg.deeplab_rows
    bucket, bucket_launches = count_launches(lambda: editor.edit_styles(
        styles[1:1 + MAPPER_CLI_BATCH], 2.0, pairs=True,
        prompt=MAPPER_PROMPT))
    record_launches(paths, cfg, "mapper_blend_bucket", bucket_launches, 3)
    checks["bucket_deeplab_calls"] = (seg.deeplab_calls - calls,
                                      seg.deeplab_rows - rows) == (
                                          2, 2 * MAPPER_CLI_BATCH)
    checks["bucket_shape"] = bucket.shape == (MAPPER_CLI_BATCH, res,
                                              2 * res, 3)

    def jpeg(a):
        buf = io.BytesIO()
        Image.fromarray(a, "RGB").save(buf, format="jpeg", quality=95)
        return _decode(buf.getvalue())

    # not gated: the subprocess may pick other cuDNN algorithms
    bucket_vs_cli = max(int(np.abs(jpeg(a).astype(int) - b.astype(int))
                            .max()) for a, b in zip(bucket, blend_imgs))

    # one item blended on both sides from the card's masks
    _, gp_cpu = load_generator(net, device="cpu")
    item = styles[1]
    d = mapper_direction(mapper, item)
    rec = _RecordingSegmenter(seg)
    card, launches = count_launches(lambda: apply_edit_item_with_blending(
        gp, cfg, item, d, 2.0, rec, text_prompt=MAPPER_PROMPT))
    record_launches(paths, cfg, "mapper_blend_parity", launches, 3)
    with tf32_control(torch):
        card_t = apply_edit_item_with_blending(
            gp, cfg, item, d, 2.0, _ReplayingSegmenter(rec.masks),
            text_prompt=MAPPER_PROMPT)
    t0 = time.perf_counter()
    cpu, cpu_launches = count_launches(lambda: apply_edit_item_with_blending(
        gp_cpu, cfg, item.cpu(), d.cpu(), 2.0,
        _ReplayingSegmenter(rec.masks), text_prompt=MAPPER_PROMPT))
    cpu_s = time.perf_counter() - t0

    def u8_diff(a, b):
        return max(int(np.abs(x.astype(int) - y.astype(int)).max())
                   for x, y in zip(a, b))

    def off_share(a, b):
        return float(np.mean([np.mean(x != y) for x, y in zip(a, b)]))

    diff, diff_t = u8_diff(card, cpu), u8_diff(card_t, cpu)
    off, off_t = off_share(card, cpu), off_share(card_t, cpu)
    saturated = float(np.mean([np.mean((a == 0) | (a == 255))
                               for a in card]))
    emit({"phase": "mapper_clis", "card": smi,
          "seconds": {"train_latent_mapper": train[0],
                      "generate_fromS_mapper": white[0],
                      "generate_fromS_blending": blended[0],
                      "run_deeplab": parse[0]},
          "launches": {k: paths[f"cli_{k}"]["launches"] for k in
                       ("train_latent_mapper", "generate_fromS_mapper",
                        "generate_fromS_blending", "run_deeplab")},
          "blend_bucket": {"rows": MAPPER_CLI_BATCH,
                           "launches": bucket_launches,
                           "max_abs_u8_diff_to_cli_jpeg": bucket_vs_cli,
                           "masks_nonempty": dict(seg.masks_nonempty)},
          "blend_parity": {"max_abs_u8_diff": diff,
                           "max_abs_u8_diff_tf32_control": diff_t,
                           "gate": 1, "off_by_one_share": off,
                           "off_by_one_share_tf32_control": off_t,
                           "off_by_one_share_gate": BLEND_OFF_SHARE,
                           "saturated_share": saturated,
                           "cpu_s": cpu_s,
                           "mask_pixels": {
                               "bg": int(np.sum(rec.masks[0])),
                               "earring_mouth_teeth": [
                                   None if m is None else int(np.sum(m))
                                   for m in rec.masks[1]]},
                           "launches": launches,
                           "cpu_launches": cpu_launches},
          "train_tail": train[1].strip().splitlines()[-3:],
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"mapper CLI checks failed: {checks}")
    if any(cpu_launches.values()):
        raise AssertionError("the CPU blending launched a CUDA kernel")
    # ±1 per uint8 cannot tell TF32 here (the ToRGB-scaled renders sit
    # away from the clip, and TF32's error stays under one step): the share
    # of values off by one is gated beside it, and TF32 must fail that
    if diff > 1:
        raise AssertionError(f"blended renders differ by {diff} > 1")
    _gate("blend_off_by_one_share", off, off_t, BLEND_OFF_SHARE, {})


def phase_mapper_serve(torch, net, direction, tmp, smi, paths):
    """BatchEditor.from_files(ffhq256, mapper=) with a seeded mapper written
    by torch.save: an HTTP /edit answer; images/s at batch 16 and 64 beside
    the same editor with a plain direction; the mapper's directions on the
    card against the CPU's (max |err| 1e-5) and two seeds' renders (±1),
    each beside the TF32 control."""
    import numpy as np

    from stylemc_torch.cli.serve import build_server
    from stylemc_torch.edit import mapper_directions_batched
    from stylemc_torch.models.mapper import save_mapper
    from stylemc_torch.serve import BatchEditor

    mapper_file = os.path.join(tmp, "mapper_serve.pth")
    save_mapper(seeded_mapper(torch, MAPPER_SEED, "cpu"), mapper_file)
    editor = BatchEditor.from_files(net, mapper=mapper_file,
                                    directions={"d0": direction},
                                    max_batch=64, device="cuda")
    editor.warmup()
    res = editor.cfg.img_resolution
    chunk = min(editor.pipeline_chunk or 64, 64)
    server, service = build_server(editor, host="127.0.0.1", port=0,
                                   coalesce_ms=3.0, max_batch=64)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        (status, ctype, body), launches = count_launches(lambda: _get(
            f"http://127.0.0.1:{server.server_address[1]}"
            "/edit?seeds=1-4&pairs=1"))
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("HTTP server thread did not stop")
    img = _decode(body)
    record_launches(paths, editor.cfg, "mapper_http", launches,
                    2 * -(-4 // chunk))

    styles = editor.styles_from_seeds(list(range(64)))
    rates = {}

    def throughput():
        for b in (16, 64):
            for mode, name in (("mapper", None), ("direction", "d0")):
                editor.edit_styles(styles[:b], direction_name=name)
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    editor.edit_styles(styles[:b], change_power=2.0,
                                       direction_name=name)
                    times.append(time.perf_counter() - t0)
                rates[f"{mode}_{b}"] = {
                    "images_per_s": [b / t for t in times],
                    "median_images_per_s": b / statistics.median(times)}

    _, tlaunches = count_launches(throughput)
    record_launches(paths, editor.cfg, "mapper_throughput", tlaunches,
                    2 * 4 * (-(-16 // chunk) + -(-64 // chunk)))

    cpu = BatchEditor.from_files(net, mapper=mapper_file, max_batch=2,
                                 device="cpu")
    s2 = editor.styles_from_seeds([1, 2])
    d = mapper_directions_batched(editor.mapper_params, s2).cpu()
    with tf32_control(torch):
        d_t = mapper_directions_batched(editor.mapper_params, s2).cpu()
        got_t = editor.edit_seeds([1, 2], change_power=2.0, pairs=True)
    d_c = mapper_directions_batched(cpu.mapper_params, s2.cpu())
    got, rlaunches = count_launches(
        lambda: editor.edit_seeds([1, 2], change_power=2.0, pairs=True))
    record_launches(paths, editor.cfg, "mapper_parity_render", rlaunches, 2)
    want = cpu.edit_seeds([1, 2], change_power=2.0, pairs=True)
    diff = int(np.abs(got.astype(int) - want.astype(int)).max())
    diff_t = int(np.abs(got_t.astype(int) - want.astype(int)).max())
    checks = {"status_200": status == 200, "jpeg": ctype == "image/jpeg",
              "pairs_shape": img.shape == (4 * res, 2 * res, 3),
              "left_ne_right": bool(np.abs(img[:, :res].astype(int)
                                           - img[:, res:].astype(int)).max()
                                    > 0)}
    emit({"phase": "mapper_serve", "card": smi, "checks": checks,
          "launches": launches, "throughput": rates,
          "throughput_launches": tlaunches,
          "direction_max_abs_err": float((d - d_c).abs().max()),
          "direction_max_abs_err_tf32_control": float(
              (d_t - d_c).abs().max()),
          "direction_gate": MAPPER_DIRECTION_ATOL,
          "render_max_abs_u8_diff": diff,
          "render_max_abs_u8_diff_tf32_control": diff_t, "render_gate": 1})
    if not all(checks.values()):
        raise AssertionError(f"mapper serving checks failed: {checks}")
    _gate("direction_max_abs_err", float((d - d_c).abs().max()),
          float((d_t - d_c).abs().max()), MAPPER_DIRECTION_ATOL, {})
    _gate("render_max_abs_u8_diff", diff, diff_t, 1, {})


# ------------------------------- GAN evaluation, LEC, NADA and the warp tools

METRICS = "fid50k_full,kid50k_full,pr50k3_full,is50k,ppl2_wend"
# 128 generated images against 128 stand-in PNGs (512 each until the e4e
# training phases, 256 until the data-parallel ones took the script's time)
METRICS_NUM_GEN = 128
METRICS_BATCH = 16
METRICS_DATA_SEED = 1000   # the stand-in dataset's z: seeds 1000..1127
METRICS_DATA = 128
METRICS_PARITY_IMAGES = 16
# card against CPU, fixed, each beside a TF32 control that must fail it
INCEPTION_REL_L2 = 1e-4
LPIPS_RTOL = 1e-5
NADA_LOSS_RTOL = 1e-6
NADA_GRAD_REL_L2 = 1e-3
NADA_PROMPTS = ("face", "smiling face")
RN50_SEED = 20
LEC_DIRECTION_SCALE = 0.5
WARP_PAIRS = 4

METRICS_RUNNER = """\
import json, runpy, sys
import stylemc_torch.metrics as metrics
from chip_smoke import launch_counters
counters = launch_counters()
per_metric = {}
calc = metrics.calc_metric


def counted(name, **kw):
    for c in counters.values():
        c.launches = 0
    out = calc(name, **kw)
    per_metric[name] = {k: c.launches for k, c in counters.items()}
    return out


metrics.calc_metric = counted
sys.argv = sys.argv[1:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as e:
    if e.code not in (None, 0):
        raise
print(json.dumps(per_metric))
"""


def metric_detectors(torch, device):
    """The seeded Inception v3 and LPIPS-VGG16 of calc_metrics
    --allow_random_init, on `device`."""
    from stylemc_torch.cli.calc_metrics import INCEPTION_SEED, LPIPS_SEED
    from stylemc_torch.losses.lpips import init_lpips_params
    from stylemc_torch.metrics.inception import init_inception_params

    return (init_inception_params(
        torch.Generator().manual_seed(INCEPTION_SEED), device=device),
        init_lpips_params(torch.Generator().manual_seed(LPIPS_SEED), "vgg",
                          device=device))


def make_metrics_data(torch, cfg, params, outdir):
    """METRICS_DATA PNGs rendered by the generator at other latents (a
    torch.Generator seeded METRICS_DATA_SEED): the stand-in dataset. One
    synthesis call per 64 images; their uint8 images."""
    import numpy as np
    from PIL import Image

    from stylemc_torch.edit import to_u8_nhwc
    from stylemc_torch.models.stylegan2.generator import (
        mapping, synthesis, w_to_s)

    os.makedirs(outdir)
    gen = torch.Generator().manual_seed(METRICS_DATA_SEED)
    imgs = []
    with torch.no_grad():
        for _ in range(0, METRICS_DATA, 64):
            z = torch.randn((64, cfg.z_dim), generator=gen).cuda()
            s = w_to_s(params, cfg, mapping(params, cfg, z))
            imgs.append(to_u8_nhwc(synthesis(params, cfg, s)).cpu().numpy())
    imgs = np.concatenate(imgs)
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(os.path.join(outdir, f"img{i:04d}.png"))
    return imgs


def phase_metrics(torch, net, tmp, smi, paths):
    """calc_metrics at full width: the FFHQ-256 generator, seeded Inception
    v3 (both variants at 299) and LPIPS-VGG16, 128 generated images against
    a directory of 128 PNGs that the generator rendered at other latents.
    The CLI runs as a subprocess with the launches counted per metric; the
    results are finite and in range. Card against CPU on 16 of the images:
    Inception's features (both variants) and LPIPS-VGG distances, each
    gate fixed beside a TF32 control that must fail it. Throughput of the
    metric loop, of Inception alone and of PPL's pairs; one profiled batch's
    device split and idle share; peak memory."""
    import numpy as np

    from stylemc_torch.convert import params_from_numpy
    from stylemc_torch.edit import to_u8_nhwc
    from stylemc_torch.io import load_generator
    from stylemc_torch.losses.lpips import lpips_distances
    from stylemc_torch.metrics import MetricOptions
    from stylemc_torch.metrics.inception import inception_features
    from stylemc_torch.metrics.metric_main import (
        _gen_images, compute_generator_features)
    from stylemc_torch.metrics.ppl import compute_ppl
    from stylemc_torch.models.stylegan2.generator import (
        mapping, synthesis, w_to_s)

    t0 = time.perf_counter()
    cfg, params = load_generator(net, device="cuda")
    data = os.path.join(tmp, "metrics_data")
    imgs, launches = count_launches(
        lambda: make_metrics_data(torch, cfg, params, data))
    record_launches(paths, cfg, "metrics_data", launches, METRICS_DATA // 64)
    data_s = time.perf_counter() - t0

    # the CLI, every metric in one process, launches counted per metric
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", METRICS_RUNNER, "stylemc_torch.cli.calc_metrics",
         "--network", net, "--metrics", METRICS, "--num_gen",
         str(METRICS_NUM_GEN), "--batch", str(METRICS_BATCH),
         "--allow_random_init", "--data", data], cwd=ROOT, timeout=900,
        capture_output=True, text=True)
    cli_s = time.perf_counter() - t1
    if proc.returncode != 0:
        raise RuntimeError(f"calc_metrics exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
    per_metric = json.loads(lines[-1])
    results = {r["metric"]: r for r in map(json.loads, lines[:-1])}
    calls = METRICS_NUM_GEN // METRICS_BATCH
    for name, launched in per_metric.items():
        # PPL renders both ends of each pair: two synthesis calls a batch
        record_launches(paths, cfg, f"metrics_{name}", launched,
                        2 * calls if name == "ppl2_wend" else calls)

    def finite(*keys):
        return all(np.isfinite(results[m][k]) for m, k in keys)

    r = {m: results[m] for m in METRICS.split(",")}
    checks = {
        "all_metrics": sorted(r) == sorted(METRICS.split(",")),
        "finite": finite(("fid50k_full", "fid50k_full"),
                         ("kid50k_full", "kid50k_full"),
                         ("pr50k3_full", "pr50k3_full_precision"),
                         ("pr50k3_full", "pr50k3_full_recall"),
                         ("is50k", "is50k_mean"), ("is50k", "is50k_std"),
                         ("ppl2_wend", "ppl2_wend")),
        "fid_nonnegative": r["fid50k_full"]["fid50k_full"] >= 0,
        "precision_in_0_1": 0 <= r["pr50k3_full"]["pr50k3_full_precision"] <= 1,
        "recall_in_0_1": 0 <= r["pr50k3_full"]["pr50k3_full_recall"] <= 1,
        "is_at_least_1": r["is50k"]["is50k_mean"] >= 1,
        "ppl_nonnegative": r["ppl2_wend"]["ppl2_wend"] >= 0,
        "detector_fid2015": all(v["detector"] == "fid2015"
                                for v in r.values()),
    }

    # card against CPU on 16 of the images, TF32 off, and the TF32 control
    inc, lp = metric_detectors(torch, "cuda")
    inc_c = params_from_numpy(inc, "cpu")
    lp_c = params_from_numpy(lp, "cpu")
    u8 = torch.from_numpy(imgs[:METRICS_PARITY_IMAGES])
    x = u8.permute(0, 3, 1, 2).float() / 127.5 - 1
    readings = {}
    with torch.no_grad():
        for variant in ("fid2015", "tv"):
            cpu = inception_features(inc_c, u8, variant=variant)
            card = inception_features(inc, u8.cuda(), variant=variant).cpu()
            with tf32_control(torch):
                t32 = inception_features(inc, u8.cuda(),
                                         variant=variant).cpu()
            readings[f"inception_{variant}_rel_l2"] = (
                _rel(card, cpu), _rel(t32, cpu), INCEPTION_REL_L2)
        cpu = lpips_distances(lp_c, x[0::2], x[1::2], "vgg")
        card = lpips_distances(lp, x[0::2].cuda(), x[1::2].cuda(),
                               "vgg").cpu()
        with tf32_control(torch):
            t32 = lpips_distances(lp, x[0::2].cuda(), x[1::2].cuda(),
                                  "vgg").cpu()
        readings["lpips_vgg_rtol"] = (
            float(((card - cpu).abs() / cpu.abs()).max()),
            float(((t32 - cpu).abs() / cpu.abs()).max()), LPIPS_RTOL)

    # throughput: the metric loop (generator + detector), each alone, PPL
    torch.cuda.reset_peak_memory_stats()
    opts = MetricOptions(gen_params=params, gen_cfg=cfg, device="cuda",
                         batch_size=METRICS_BATCH, num_gen=128)

    def features_fn(u):
        return inception_features(inc, u)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    timed(lambda: compute_generator_features(opts, features_fn, 32))
    _, loop_s = timed(lambda: compute_generator_features(opts, features_fn,
                                                         128))
    _, gen_s = timed(lambda: [None for _ in _gen_images(opts, 128)])
    u16 = next(_gen_images(opts, METRICS_BATCH))
    u64 = torch.cat([u16] * 4)
    with torch.no_grad():
        inc16_ms = event_ms(lambda: features_fn(u16), iters=20)
        inc64_ms = event_ms(lambda: features_fn(u64), iters=10)
    ppl_kw = dict(num_samples=64, batch_size=METRICS_BATCH,
                  gen_params=params, device="cuda")

    def ppl():
        return compute_ppl(
            lambda g, z: mapping(g, cfg, z),
            lambda g, w: synthesis(g, cfg, w_to_s(g, cfg, w)), lp,
            cfg.z_dim, **ppl_kw)

    ppl()
    _, ppl_s = timed(ppl)
    z = torch.randn((METRICS_BATCH, cfg.z_dim),
                    generator=torch.Generator().manual_seed(5)).cuda()

    def render():
        with torch.no_grad():
            return to_u8_nhwc(synthesis(params, cfg, w_to_s(
                params, cfg, mapping(params, cfg, z))))

    def one_batch():
        with torch.no_grad():
            return features_fn(render())

    gen_busy = profiled(torch, render)[3]
    det_busy = profiled(torch, lambda: features_fn(u16))[3]
    breakdown = device_breakdown(torch, one_batch, top=8)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "metrics", "card": smi,
          "seconds": time.perf_counter() - t0, "data_seconds": data_s,
          "cli_seconds": cli_s, "results": r,
          "launches_by_metric": per_metric,
          "metric_loop_images_per_s": 128 / loop_s,
          "generator_images_per_s": 128 / gen_s,
          "detector_images_per_s": {"16": 16e3 / inc16_ms,
                                    "64": 64e3 / inc64_ms},
          "inception_ms": {"16": inc16_ms, "64": inc64_ms},
          "ppl_pairs_per_s": 64 / ppl_s,
          "device_ms_per_batch16": {"generator": gen_busy,
                                    "detector": det_busy},
          "generator_device_share": gen_busy / (gen_busy + det_busy),
          "one_batch": breakdown, "peak_gb": peak_gb,
          "parity": {k: {"value": v, "tf32_control": t, "gate": g}
                     for k, (v, t, g) in readings.items()},
          "times_are": "metric loop, generator and PPL: host clock over 128 "
                       "images / 64 pairs after a warm run; Inception: CUDA "
                       "events over back-to-back batches",
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"metrics checks failed: {checks}")
    for name, (v, t, g) in readings.items():
        _gate(name, v, t, g, {})


def phase_lec(torch, ckpt, photos, paths):
    """calculate_lec on the seeded e4e_ffhq_encode (its full-width IR-SE-50
    encoder and FFHQ-1024 decoder) over the e4e phase's 8 photos in two
    batches of 4, a seeded W+ direction added as the edit and subtracted
    as its inverse: finite, one 1024 synthesis call per batch."""
    import numpy as np

    from stylemc_torch.metrics.lec import calculate_lec
    from stylemc_torch.models.e4e.psp import load_psp_from_checkpoint

    t0 = time.perf_counter()
    psp = load_psp_from_checkpoint(ckpt, E4E_SIZE, device="cuda")
    x = _read_photos(photos).astype(np.float32).transpose(0, 3, 1, 2)
    batches = [x[lo:lo + 4] / 127.5 - 1 for lo in range(0, len(x), 4)]
    n_codes = psp.latent_avg.shape[0]
    d = torch.from_numpy(np.random.RandomState(E4E_SEEDS["direction"]).randn(
        1, n_codes, 512).astype(np.float32) * LEC_DIRECTION_SCALE).cuda()
    lec, launches = count_launches(lambda: calculate_lec(
        psp, iter(batches), lambda w: w + d, lambda w: w - d,
        n_batches=len(batches)))
    record_launches(paths, psp.decoder_cfg, "lec", launches, len(batches))
    emit({"phase": "lec", "lec": lec, "batches": len(batches),
          "seconds": time.perf_counter() - t0, "launches": launches})
    if not np.isfinite(lec):
        raise AssertionError(f"LEC is not finite: {lec}")


def phase_nada(torch, net, editor, models, smi, paths):
    """nada_loss on 4 full-width FFHQ-256 renders (seeds 1-4) and their
    edit by the seeded Δs, with the train phase's seeded ViT-B/32 and a
    seeded RN50 (direction, global, manifold and the RN50 texture term all
    on), forward and backward to Δs, on the card and on the CPU: the loss
    and the Δs gradient at fixed gates, each beside a TF32 control that
    must fail it; the step's time and RN50's encode_image at batch 4; B1
    twice and B2 once per step."""
    from stylemc_torch.convert import params_from_numpy
    from stylemc_torch.io import load_generator
    from stylemc_torch.losses.clip_loss_nada import (
        NADATextAnchors, nada_loss, preprocess_nada)
    from stylemc_torch.models.clip import (
        CLIP_CONFIGS, FallbackTokenizer, encode_image, init_clip_params)
    from stylemc_torch.models.stylegan2.generator import synthesis
    from stylemc_torch.train.find_direction import (
        TRAINABLE, assemble_direction)

    t0 = time.perf_counter()
    cfg, gp, clip_cpu, _, clip, _ = models
    _, gp_cpu = load_generator(net, device="cpu")
    vit_cfg, vit_cpu = clip_cpu["ViT-B/32"]
    vit = clip["ViT-B/32"][1]
    rn_cfg = CLIP_CONFIGS["RN50"]
    rn_cpu = init_clip_params(torch.Generator().manual_seed(RN50_SEED),
                              rn_cfg, device="cpu")
    rn = params_from_numpy(rn_cpu, "cuda")
    styles = editor.styles_from_seeds([1, 2, 3, 4]).cpu()
    delta = torch.randn((1, len(TRAINABLE), 512),
                        generator=torch.Generator().manual_seed(21)) * 0.5
    tok = FallbackTokenizer()

    def step(g, vp, rp, device):
        anchors = NADATextAnchors.create(vp, vit_cfg, *NADA_PROMPTS,
                                         tokenizer=tok)
        s = styles.to(device)
        with torch.no_grad():
            src = synthesis(g, cfg, s)
        dl = delta.to(device).requires_grad_(True)
        tgt = synthesis(g, cfg, s + assemble_direction(dl))
        loss = nada_loss(vp, vit_cfg, src, tgt, anchors,
                         lambda_direction=1.0, lambda_global=0.5,
                         lambda_manifold=0.5, rn_params=rp, rn_cfg=rn_cfg,
                         texture_image=src, lambda_texture=1.0)
        grad, = torch.autograd.grad(loss, dl)
        return float(loss.detach()), grad.cpu()

    (loss, grad), launches = count_launches(lambda: step(gp, vit, rn,
                                                         "cuda"))
    record_launches(paths, cfg, "nada", launches, 2, 1)
    with tf32_control(torch):
        loss_t, grad_t = step(gp, vit, rn, "cuda")
    t1 = time.perf_counter()
    loss_c, grad_c = step(gp_cpu, vit_cpu, rn_cpu, "cpu")
    cpu_s = time.perf_counter() - t1
    step_ms = event_ms(lambda: step(gp, vit, rn, "cuda"), iters=5,
                       warmup=1)
    x = preprocess_nada(synthesis(gp, cfg, styles.cuda()).detach(),
                        rn_cfg.image_resolution)
    with torch.no_grad():
        rn50_ms = event_ms(lambda: encode_image(rn, rn_cfg, x), iters=20)
    readings = {"nada_loss_rtol": (abs(loss - loss_c) / abs(loss_c),
                                   abs(loss_t - loss_c) / abs(loss_c),
                                   NADA_LOSS_RTOL),
                "nada_grad_rel_l2": (_rel(grad, grad_c), _rel(grad_t, grad_c),
                                     NADA_GRAD_REL_L2)}
    emit({"phase": "nada", "card": smi, "loss": loss, "cpu_loss": loss_c,
          "grad_norm": float(grad_c.norm()),
          "parity": {k: {"value": v, "tf32_control": t, "gate": g}
                     for k, (v, t, g) in readings.items()},
          "step_ms": step_ms, "rn50_encode_image_b4_ms": rn50_ms,
          "times_are": "CUDA events over back-to-back calls (host cost "
                       "included); the step builds its text anchors, renders "
                       "the source and the edit and backpropagates to Δs",
          "cpu_s": cpu_s, "seconds": time.perf_counter() - t0,
          "launches": launches})
    for name, (v, t, g) in readings.items():
        _gate(name, v, t, g, {})


def phase_warp(tmp, files, paths):
    """warp_images over 4 [orig|edited] pairs that the clis phase's
    generate_fromS wrote, with the seeded MTCNN and MobileNet-GDConv files,
    as a subprocess: a strip per pair, both halves with their landmarks
    and the original warped onto the edit's."""
    import shutil

    import numpy as np
    from PIL import Image

    from stylemc_torch.models.stylegan2.generator import GeneratorConfig

    src = os.path.join(tmp, "out")
    pairs = os.path.join(tmp, "warp_pairs")
    outdir = os.path.join(tmp, "warped")
    os.makedirs(pairs)
    names = sorted(f for f in os.listdir(src) if f.endswith(".jpeg"))
    for name in names[:WARP_PAIRS]:
        shutil.copy(os.path.join(src, name), pairs)
    mtcnn_dir, mobilenet = files
    secs, out = run_cli(paths, GeneratorConfig(img_resolution=256), "warp",
                        "warp_images", 0, 0, "--indir", pairs, "--outdir",
                        outdir, env={"STYLEMC_MTCNN_DIR": mtcnn_dir,
                                     "STYLEMC_MOBILENET": mobilenet})
    shapes = [np.asarray(Image.open(os.path.join(outdir, f))).shape
              for f in sorted(os.listdir(outdir))]
    pair_shape = np.asarray(Image.open(os.path.join(pairs, names[0]))).shape
    want = (pair_shape[0], 3 * (pair_shape[1] // 2), 3)
    checks = {"processed_all": f"processed {WARP_PAIRS}/{WARP_PAIRS}" in out,
              "outputs": len(shapes) == WARP_PAIRS,
              "shapes": all(s == want for s in shapes)}
    emit({"phase": "warp", "seconds": secs, "outputs": shapes,
          "tail": out.strip().splitlines()[-2:], "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"warp checks failed: {checks}")


# ---------------------------------------------------------- e4e training

# the coach at full width: the FFHQ-1024 decoder (make_ffhq1024), a seeded
# IR-SE-50 Encoder4Editing, the seeded ArcFace and LPIPS-alex; the e4e
# recipe's options with its progressive schedule compressed (20 000 / 2 000
# steps in the recipe) so that the stages advance inside the run, and R1
# at steps 0, 16 and 32
E4E_TRAIN_PHOTOS = 64
E4E_TRAIN_STEPS = 36
E4E_TRAIN_STEADY_FROM = 2       # steady ms/step over steps 3-36
E4E_TRAIN_SIDE_STEPS = 4        # the train_decoder and use_w_pool runs
E4E_TRAIN_OPTS = dict(batch_size=4, stylegan_size=E4E_SIZE,
                      w_discriminator_lambda=0.1, d_reg_every=16, r1=10.0,
                      progressive_start=4, progressive_step_every=2)
E4E_TRAIN_SEEDS = {"photos": 21, "lpips": 1, "encoder": 0}
# one R1 step at progressive stage 7 (global step 16), batch 2
E4E_PARITY_STEP = 16
E4E_PARITY_BATCH = 2
E4E_PARITY_LOSS_RTOL = 1e-4
E4E_PARITY_GRAD_REL_L2 = 1e-3
E4E_PARITY_D_REL_L2 = 1e-5
# the card's fp32 encoder backward against the CPU's float64: twice the
# CPU's own fp32 reading (1.45e-3 on the delta-norm term's VJP)
E4E_PARITY_VJP_FP64_REL_L2 = 3e-3
E4E_CLI_STEPS = 4
E4E_LOSSES_RTOL = 1e-5


def e4e_train_models(torch, net1024):
    """The coach's networks on the CPU, from seeds: the FFHQ-1024 decoder
    from its .npz, the IR-SE-50 Encoder4Editing as train_e4e draws it, the
    ArcFace of `perception_models`, LPIPS-alex as train_e4e draws it."""
    from stylemc_torch.io import load_generator
    from stylemc_torch.losses.lpips import init_lpips_params
    from stylemc_torch.models.arcface import init_backbone_params
    from stylemc_torch.models.e4e.encoders import (init_encoder_params,
                                                   style_count)
    from stylemc_torch.models.e4e.psp import PSP, PSPConfig

    cfg, dec = load_generator(net1024, device="cpu")
    enc = init_encoder_params(torch.Generator().manual_seed(
        E4E_TRAIN_SEEDS["encoder"]), E4E_SIZE, device="cpu")
    psp = PSP(cfg=PSPConfig(stylegan_size=E4E_SIZE), encoder_params=enc,
              decoder_cfg=cfg, decoder_params=dec,
              latent_avg=dec["mapping"]["w_avg"][None].repeat(
                  style_count(E4E_SIZE), 1))
    perception = {
        "lpips": init_lpips_params(torch.Generator().manual_seed(
            E4E_TRAIN_SEEDS["lpips"]), "alex", device="cpu"),
        "arcface": init_backbone_params(torch.Generator().manual_seed(
            ARCFACE_SEED), device="cpu")}
    return cfg, psp, perception


def _finite(d):
    import math

    return all(math.isfinite(v) for v in d.values())


def phase_e4e_train(torch, net1024, tmp, smi, paths):
    """The e4e coach at full width for E4E_TRAIN_STEPS steps over 64
    seeded photos through train_e4e's data pipeline (batch_iterator with
    the flip, the background prefetcher): steady ms/step, images/s, peak
    memory, the stage reached, B1 and B2 per step; then 4 steps with train_decoder and 4 with use_w_pool (the JAX
    package's unfused path). It runs before any phase traces the card
    with the profiler (its profiled step is e4e_train_breakdown's)."""
    from stylemc_torch.bench.timing import card_state
    from stylemc_torch.data.images import ImagesDataset, batch_iterator
    from stylemc_torch.train.coach import Coach, CoachOptions

    photos = write_photos(os.path.join(tmp, "e4e_train_photos"),
                          E4E_TRAIN_PHOTOS, E4E_TRAIN_SEEDS["photos"])
    t0 = time.perf_counter()
    cfg, psp, perception = e4e_train_models(torch, net1024)
    build_s = time.perf_counter() - t0

    def coach(steps, **kw):
        opts = CoachOptions(**{**E4E_TRAIN_OPTS, "max_steps": steps, **kw})
        data = batch_iterator(ImagesDataset(photos, size=256),
                              opts.batch_size, shuffle=True, flip=True)
        return Coach(opts, psp, perception, data, device="cuda")

    c = coach(E4E_TRAIN_STEPS)
    losses, stamps = [], []

    def callback(step, loss_dict):
        stamps.append(time.perf_counter())
        losses.append(loss_dict)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    states = [card_state()]
    t0 = time.perf_counter()
    _, launches = count_launches(lambda: c.train(callback=callback))
    wall = time.perf_counter() - t0
    states.append(card_state())
    peak = torch.cuda.max_memory_allocated()
    record_launches(paths, cfg, "e4e_train", launches, E4E_TRAIN_STEPS,
                    E4E_TRAIN_STEPS)
    steady = (stamps[-1] - stamps[E4E_TRAIN_STEADY_FROM - 1]) \
        / (E4E_TRAIN_STEPS - E4E_TRAIN_STEADY_FROM) * 1e3
    stage = c.progressive_stage()
    r1_steps = [i for i, d in enumerate(losses)
                if "discriminator_r1_loss" in d]
    checks = {"steps": len(losses) == E4E_TRAIN_STEPS,
              "losses_finite": all(_finite(d) for d in losses),
              "r1_steps": r1_steps == [0, 16, 32],
              # the last stage (17 at FFHQ-1024) by step 36
              "stage_advanced": stage == len(c.opts.progressive_steps) - 1,
              "per_step": {k: launches[k] / E4E_TRAIN_STEPS for k in
                           UPFIRDN_KERNELS} == {"upsample2x": 8,
                                                "downsample2x": 8}}
    emit({"phase": "e4e_train", "card": smi, "steps": E4E_TRAIN_STEPS,
          "batch": c.opts.batch_size, "photos": E4E_TRAIN_PHOTOS,
          "precision": "fp32", "tf32": False,
          "options": E4E_TRAIN_OPTS, "build_s": build_s, "wall_s": wall,
          "first_step_s": stamps[0] - t0,
          "steady_ms_per_step": steady,
          "images_per_s": c.opts.batch_size * 1e3 / steady,
          "peak_mem_bytes": peak, "stage_reached": stage,
          "progressive_steps": c.opts.progressive_steps,
          "r1_steps": r1_steps, "launches": launches,
          "launches_per_step": {k: launches[k] / E4E_TRAIN_STEPS
                                for k in UPFIRDN_KERNELS},
          "loss_first_last": [losses[0], losses[-1]],
          "card_state": states, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"e4e_train checks failed: {checks}")

    del c
    torch.cuda.empty_cache()

    for tag, kw in (("train_decoder", {"train_decoder": True}),
                    ("w_pool", {"use_w_pool": True})):
        side = coach(E4E_TRAIN_SIDE_STEPS, **kw)
        stamps, losses = [], []
        torch.cuda.reset_peak_memory_stats()
        _, launches = count_launches(lambda: side.train(callback=callback))
        record_launches(paths, cfg, f"e4e_train_{tag}", launches,
                        E4E_TRAIN_SIDE_STEPS, E4E_TRAIN_SIDE_STEPS)
        ok = len(losses) == E4E_TRAIN_SIDE_STEPS and \
            all(_finite(d) for d in losses)
        emit({"phase": f"e4e_train_{tag}", "card": smi,
              "steps": E4E_TRAIN_SIDE_STEPS,
              "ms_per_step_after_first": (stamps[-1] - stamps[0])
              / (len(stamps) - 1) * 1e3,
              "peak_mem_bytes": torch.cuda.max_memory_allocated(),
              "loss_last": losses[-1], "losses_finite": ok,
              "launches": launches})
        if not ok:
            raise AssertionError(f"e4e_train_{tag}: {losses}")
        del side
        torch.cuda.empty_cache()
    return (cfg, psp, perception), photos


def phase_e4e_train_breakdown(torch, models, photos, smi):
    """Where one full-width coach step's device time goes: a fresh coach
    at global step 5 (stage 2, no R1), one untraced step, then one step
    profiled by kernel name, and its idle share."""
    from stylemc_torch.data.images import ImagesDataset, batch_iterator
    from stylemc_torch.train.coach import Coach, CoachOptions

    _, psp, perception = models
    opts = CoachOptions(**E4E_TRAIN_OPTS)
    data = batch_iterator(ImagesDataset(photos, size=256), opts.batch_size,
                          shuffle=True, flip=True)
    c = Coach(opts, psp, perception, data, device="cuda")
    c.global_step = 5
    x, y = data()
    emit({"phase": "e4e_train_breakdown", "card": smi,
          "stage": c.progressive_stage(),
          **device_breakdown(torch, lambda: c.train_step(x, y), top=15)})


def phase_e4e_train_parity(torch, models, photos, smi, paths):
    """One full-width coach step on the card and on the CPU from the same
    weights, batch and z: an R1 step (global step 16) at progressive stage
    7, batch 2: the discriminator's step and R1 (train_discriminator), then
    the encoder's loss against the updated discriminator and its gradients
    (train_step before its Ranger update). Gates, each beside a TF32
    control of the card's side that must fail it: every loss rtol 1e-4;
    the discriminator after its step and R1 relative L2 1e-5; the loss's
    gradient at the codes (the decoder's, the perception models' and the
    discriminator's half of the step, as train_parity's Δs) relative L2
    1e-3; the encoder's backward, the card's fp32 VJP of the CPU's codes
    gradient against the CPU's float64 one, relative L2 3e-3. Recorded
    beside them, not gated: the step's encoder gradient card against CPU,
    and the CPU's fp32 VJP against float64 (the seeded encoder's weight
    gradient sits ~1.5e-3 from float64 in fp32 on either device: a 1e-7
    change of its input moves it 1.6e-5, so fp32's ~3e-6 forward noise
    moves it ~1e-3)."""
    import numpy as np

    from stylemc_torch.data.images import ImagesDataset
    from stylemc_torch.train.coach import Coach, CoachOptions
    from stylemc_torch.train.ranger import tree_leaves, tree_map

    cfg, psp, perception = models
    ds = ImagesDataset(photos, size=256)
    x = np.stack([ds[i][0] for i in range(E4E_PARITY_BATCH)])
    opts = CoachOptions(**{**E4E_TRAIN_OPTS, "batch_size": E4E_PARITY_BATCH})

    def flat(ts):
        return torch.cat([t.detach().reshape(-1) for t in ts]).cpu()

    def step(device, tf32=False):
        # the coach turns TF32 off as it is built: the control turns it on
        # after
        c = Coach(opts, psp, perception, lambda: None, device=device)
        c.global_step = E4E_PARITY_STEP
        stage = c.progressive_stage()
        xt = c._to_device(x)
        with tf32_control(torch) if tf32 else contextlib.nullcontext():
            d_dict = c.train_discriminator(xt)
            leaves = tree_leaves(c._trainable())
            loss, (enc_dict, _, codes) = c._calc_loss(
                c._trainable(), xt, xt, stage, c.discriminator_params)
            g_codes, *g = torch.autograd.grad(
                loss, [codes] + leaves, allow_unused=True,
                materialize_grads=True)
        out = {k: float(v.detach()) for k, v in {**d_dict,
                                                  **enc_dict}.items()}
        return (out, g_codes.detach().cpu(), flat(g),
                flat(tree_leaves(c.discriminator_params)), stage)

    def encoder_vjp(device, dtype, cot, tf32=False):
        """The encoder's backward alone: the VJP of its raw codes (stage 7)
        with the cotangent `cot`, in `dtype`."""
        c = Coach(opts, psp, perception, lambda: None, device=device)
        tree = tree_map(lambda v: v.detach().to(dtype).requires_grad_(True),
                        c.psp.encoder_params)
        with tf32_control(torch) if tf32 else contextlib.nullcontext():
            codes = c._encoder_forward(
                tree, torch.from_numpy(x).to(device, dtype), stage)
            g = torch.autograd.grad(codes, tree_leaves(tree),
                                    cot.to(device, dtype),
                                    allow_unused=True, materialize_grads=True)
        return flat(g).double()

    (card, gc_card, g, d, stage), launches = count_launches(
        lambda: step("cuda"))
    record_launches(paths, cfg, "e4e_train_parity", launches, 1, 1)
    card_t, gc_t, g_t, d_t, _ = step("cuda", tf32=True)
    t0 = time.perf_counter()
    (cpu, gc_cpu, g_c, d_c, _), cpu_launches = count_launches(
        lambda: step("cpu"))
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vjp64 = encoder_vjp("cpu", torch.float64, gc_cpu)
    vjp_cpu = encoder_vjp("cpu", torch.float32, gc_cpu)
    fp64_s = time.perf_counter() - t0
    vjp_card = encoder_vjp("cuda", torch.float32, gc_cpu)
    vjp_t = encoder_vjp("cuda", torch.float32, gc_cpu, tf32=True)

    def loss_rel(a):
        return max(abs(a[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu)

    readings = {
        "loss_rel": (loss_rel(card), loss_rel(card_t),
                     E4E_PARITY_LOSS_RTOL),
        "discriminator_rel_l2": (_rel(d, d_c), _rel(d_t, d_c),
                                 E4E_PARITY_D_REL_L2),
        "codes_grad_rel_l2": (_rel(gc_card, gc_cpu), _rel(gc_t, gc_cpu),
                              E4E_PARITY_GRAD_REL_L2),
        "encoder_vjp_rel_l2_to_fp64": (_rel(vjp_card, vjp64),
                                       _rel(vjp_t, vjp64),
                                       E4E_PARITY_VJP_FP64_REL_L2)}
    emit({"phase": "e4e_train_parity", "card": smi, "stage": stage,
          "global_step": E4E_PARITY_STEP, "batch": E4E_PARITY_BATCH,
          "losses": card, "cpu_losses": cpu, "tf32_losses": card_t,
          "loss_rel_by_key": {k: abs(card[k] - cpu[k])
                              / max(abs(cpu[k]), 1e-30) for k in cpu},
          "r1_step": "discriminator_r1_loss" in card,
          "gates": {k: {"value": v, "tf32_control": t, "gate": gate}
                    for k, (v, t, gate) in readings.items()},
          "encoder_grad_rel_l2_card_vs_cpu": _rel(g, g_c),
          "encoder_grad_rel_l2_tf32_vs_cpu": _rel(g_t, g_c),
          "encoder_vjp_rel_l2_to_fp64_cpu_fp32": _rel(vjp_cpu, vjp64),
          "encoder_grad_norm": float(g_c.norm()),
          "codes_grad_norm": float(gc_cpu.norm()), "cpu_s": cpu_s,
          "vjp_cpu_s": fp64_s, "launches": launches,
          "cpu_launches": cpu_launches})
    if any(cpu_launches.values()):
        raise AssertionError("the CPU step launched a CUDA kernel")
    if "discriminator_r1_loss" not in card or not 1 <= stage <= 17:
        raise AssertionError(f"not an R1 step at stage 1-17: {stage}")
    for name, reading in readings.items():
        _gate(name, *reading, {})


def _printed_losses(out):
    """{step: {key: value}} of train_e4e's 'step N: k=v, ...' lines."""
    steps = {}
    for line in out.splitlines():
        if line.startswith("step ") and ": " in line:
            head, rest = line.split(": ", 1)
            steps[int(head.split()[1])] = {
                kv.split("=")[0]: float(kv.split("=")[1])
                for kv in rest.split(", ")}
    return steps


def phase_e4e_train_clis(cfg, net1024, e4e_photos, inversions, tmp, paths):
    """As subprocesses: train_e4e on the e4e phase's 8 photos (train and
    test) from the FFHQ-1024 .npz, --allow_random_init, 4 steps, saving
    and validating every 2 (4 batches of 2 a validation); then
    --resume_training_from_ckpt iteration_2.pkl to step 4. Then
    calc_losses_on_images in both modes, the photos against infer_e4e's
    reconstructions, on the card and with --device cpu: rtol 1e-5."""
    import json

    import numpy as np

    from stylemc_torch.io.numpy_pickle import load_numpy_pickle

    args = ["--source_root", e4e_photos, "--test_root", e4e_photos,
            "--stylegan_weights", net1024, "--stylegan_size", str(E4E_SIZE),
            "--allow_random_init", "--max_steps", str(E4E_CLI_STEPS),
            "--save_interval", "2", "--val_interval", "2",
            "--board_interval", "1"]
    first = os.path.join(tmp, "e4e_train_cli")
    # 4 steps and two validations of 4 batches
    secs, out = run_cli(paths, cfg, "e4e_cli_train_e4e", "train_e4e", 12, 4,
                        "--exp_dir", first, *args)
    ckpts = os.path.join(first, "checkpoints")
    resumed = os.path.join(tmp, "e4e_train_cli_resumed")
    secs_r, out_r = run_cli(
        paths, cfg, "e4e_cli_train_e4e_resume", "train_e4e", 6, 2,
        "--exp_dir", resumed, "--resume_training_from_ckpt",
        os.path.join(ckpts, "iteration_2.pkl"), *args)
    printed, printed_r = _printed_losses(out), _printed_losses(out_r)
    last = load_numpy_pickle(os.path.join(resumed, "checkpoints",
                                          "last.pkl"))
    files = sorted(os.listdir(ckpts))
    checks = {
        "checkpoints": files == ["best_model.pkl", "iteration_2.pkl",
                                 "iteration_4.pkl", "last.pkl"],
        "printed_steps": sorted(printed) == [1, 2, 3, 4],
        "losses_finite": all(_finite(d) for d in printed.values())
        and all(_finite(d) for d in printed_r.values()),
        "resumed_steps": sorted(printed_r) == [3, 4],
        "resumed_to_4": last["global_step"] == 4,
        "finished": "OMG, finished training!" in out}

    losses = {}
    for mode in ("lpips", "l2"):
        largs = ["--mode", mode, "--data_path", inversions, "--gt_path",
                 e4e_photos, "--batch", "4", "--allow_random_init"]
        _, card_out = run_cli(paths, cfg, f"e4e_cli_losses_{mode}",
                              "calc_losses_on_images", 0, 0, *largs)
        _, cpu_out = run_cli(paths, cfg, f"e4e_cli_losses_{mode}_cpu",
                             "calc_losses_on_images", 0, 0, *largs,
                             "--device", "cpu")
        card = json.loads(card_out.strip().splitlines()[-2])
        cpu = json.loads(cpu_out.strip().splitlines()[-2])
        losses[mode] = {"card": card, "cpu": cpu,
                        "mean_rel": abs(card["mean"] - cpu["mean"])
                        / abs(cpu["mean"])}
        checks[f"{mode}_n"] = card["n"] == cpu["n"] == \
            (2 if mode == "lpips" else E4E_PHOTOS)
        checks[f"{mode}_agree"] = bool(
            np.isclose(card["mean"], cpu["mean"], rtol=E4E_LOSSES_RTOL, atol=0)
            and np.isclose(card["std"], cpu["std"], rtol=0,
                           atol=E4E_LOSSES_RTOL * cpu["mean"]))
    emit({"phase": "e4e_train_clis", "seconds": [secs, secs_r],
          "checkpoints": files, "printed": printed, "printed_resumed":
          printed_r, "losses": losses,
          "launches": {k: v["launches"] for k, v in paths.items()
                       if k.startswith("e4e_cli_train_e4e")
                       or k.startswith("e4e_cli_losses")},
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"e4e_train_clis checks failed: {checks}")


# ---------------------------------------------------- data parallelism

DP_SEEDS = 32              # dp_train: the first 32 training seeds, 8 steps
# the Δs update (direction − d0), sharded against unsharded: the card's
# step is not bit-reproducible, and its own repeat of a serial run moves a
# run's update by up to 8.2e-4 (the sweep phase's serial_repeat)
DP_DELTA_REL_L2 = 3e-3
DP_SWEEP_SEEDS = 16        # dp_sweep's run: 4 steps of batch 4
DP_SERVE_OFF_SHARE = 1e-3  # uint8 values off by one, sharded against plain
DP_SERVE_BATCH = 16
DP_COACH_BATCH = 4
DP_METRICS_NUM = 64
# each metric sharded against unsharded; PPL at its ε = 1e-4 reads fp32's
# noise in each pair (ROADMAP §C.3)
DP_METRICS_RTOL = {"fid50k_full": 1e-5, "kid50k_full": 1e-5,
                   "ppl2_wend": 1e-3}
DP_RANKS_ITEMS = 4         # one step of batch 4, 2 rows a process
DP_RANKS_TIMEOUT_S = 240
DP_PROBE_TIMEOUT_S = 60


def card_mesh(n, axes=("data",), shape=None):
    """n shards on the one card: a DataMesh over [cuda:0] * n."""
    from stylemc_torch.parallel import DataMesh

    return DataMesh(["cuda:0"] * n, axes, shape)


def _gate_all(name, readings, control, gates, record):
    """A gate of several bounds: every reading within its bound, and the
    TF32 control beyond at least one of them."""
    ok = {k: readings[k] <= g for k, g in gates.items()}
    ctl = {k: control[k] <= g for k, g in gates.items()}
    record[name] = {"value": readings, "tf32_control": control,
                    "gate": gates, "control_fails": [k for k, v in
                                                     ctl.items() if not v]}
    if not all(ok.values()):
        raise AssertionError(f"{name}: {readings} beyond {gates}")
    if all(ctl.values()):
        raise AssertionError(f"{name}: the TF32 control {control} passes "
                             f"{gates}")


def _run_readings(hist, d, ref_hist, ref_d, d0):
    """The loss history's largest relative error and the Δs update's
    (direction − d0) relative L2 against a reference run."""
    import numpy as np

    h, rh = np.asarray(hist, np.float64), np.asarray(ref_hist, np.float64)
    d, rd = np.asarray(d, np.float64), np.asarray(ref_d, np.float64)
    return {"history_rel": float(np.max(np.abs(h - rh) / np.abs(rh))),
            "update_rel_l2": float(np.linalg.norm(d - rd)
                                   / np.linalg.norm(rd - d0))}


DP_TRAIN_GATES = {"history_rel": PARITY_LOSS_RTOL,
                  "update_rel_l2": DP_DELTA_REL_L2}


def phase_dp_train(torch, models, styles, direction_file, smi, paths):
    """find_direction at full width (the train phase's models) on the
    first DP_SEEDS seeds, batch 4, one epoch (8 steps) from the seeded
    direction d0, on DataMesh([cuda:0, cuda:0]) (two shards of 2 a step)
    and unsharded. Gate: loss history rtol 1e-4 and the Δs update's
    relative L2 3e-3, beside a TF32 control of the sharded side; B1 and
    B2 12 a step (6 a shard), B3-B5 none. ms/step both ways: two shards
    on one card, not a scaling figure."""
    import numpy as np

    from stylemc_torch.models.clip import FallbackTokenizer
    from stylemc_torch.train.find_direction import (FindDirectionConfig,
                                                    find_direction)

    t0 = time.perf_counter()
    cfg, gp, _, _, clip, arc = models
    d0 = np.load(direction_file)["s"].astype(np.float32)
    rows = styles[:DP_SEEDS]
    fdc = FindDirectionConfig(n_epochs=1)
    chunks = -(-DP_SEEDS // 8)

    def run(mesh):
        (d, info), launches = count_launches(lambda: find_direction(
            gp, cfg, rows, clip, arc, fdc, tokenizer=FallbackTokenizer(),
            mesh=mesh, resume_direction=d0))
        return d.cpu().numpy(), info, launches

    sd, sinfo, sl = run(card_mesh(2))
    steps = sinfo["iterations"]
    record_launches(paths, cfg, "dp_train", sl, chunks + 2 * steps,
                    2 * steps)
    pd, pinfo, pl = run(None)
    record_launches(paths, cfg, "dp_train_unsharded", pl, chunks + steps,
                    steps)
    with tf32_control(torch):
        td, tinfo, _ = run(card_mesh(2))
    readings = _run_readings(sinfo["history"], sd, pinfo["history"], pd, d0)
    control = _run_readings(tinfo["history"], td, pinfo["history"], pd, d0)
    gates = {}
    checks = {"steps": steps == DP_SEEDS // fdc.batch_size,
              "finite": bool(np.isfinite(sinfo["history"]).all()),
              "moved": float(np.abs(sd - d0).max()) > 0,
              "step_launches": {k: sl[k] - pl[k] for k in sl} == {
                  "upsample2x": 6 * steps, "downsample2x": 6 * steps,
                  **{k: 0 for k in MODCONV_KERNELS}}}
    emit({"phase": "dp_train", "card": smi, "seeds": DP_SEEDS,
          "batch": fdc.batch_size, "shards": 2, "steps": steps,
          "sharded_ms_per_step": sinfo["steady_ms_per_step"],
          "unsharded_ms_per_step": pinfo["steady_ms_per_step"],
          "sharded_over_unsharded": sinfo["steady_ms_per_step"]
          / pinfo["steady_ms_per_step"],
          "readings": readings, "tf32_control": control,
          "gates": DP_TRAIN_GATES,
          "launches": {"sharded": sl, "unsharded": pl},
          "note": "two shards of one card: not a scaling figure",
          "seconds": time.perf_counter() - t0, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"dp_train checks failed: {checks}")
    _gate_all("dp_train", readings, control, DP_TRAIN_GATES, gates)


def phase_dp_sweep(torch, models, styles, direction_file, smi, paths):
    """optimize_batch with the 4 sweep prompts on zoo_mesh(2) over
    [cuda:0] x 4 ('prompt' 2 x 'data' 2) against the unsharded call, from
    d0: one step on a 4-seed engine at a held learning rate, held to JAX's
    one-step sweep gate (each prompt's update at cosine > 0.99999, norms
    within 1e-3) beside a TF32 control of the sharded side; then a 4-step
    run on 16 seeds, its agreement recorded. B1 and B2 24 a step (4
    shards of 2 images), B3-B5 none."""
    import numpy as np

    from stylemc_torch.models.clip import FallbackTokenizer
    from stylemc_torch.parallel import zoo_mesh
    from stylemc_torch.train.find_direction import (DirectionEngine,
                                                    FindDirectionConfig)

    t0 = time.perf_counter()
    cfg, gp, _, _, clip, arc = models
    d0 = np.load(direction_file)["s"].astype(np.float32)
    resume = [d0] * len(SWEEP_PROMPTS)
    mesh = zoo_mesh(2, devices=["cuda:0"] * 4)
    fdc = FindDirectionConfig(n_epochs=1)

    def engine(rows, fdc):
        return DirectionEngine(gp, cfg, rows, clip, arc, fdc,
                               tokenizer=FallbackTokenizer())

    def batched(eng, mesh):
        d, info = eng.optimize_batch(SWEEP_PROMPTS, mesh=mesh,
                                     resume_directions=resume)
        return d.cpu().numpy(), info

    def gate_of(rows):
        return {"one_minus_cosine": max(1 - r["cosine_of_update"]
                                        for r in rows),
                "norm_ratio_error": max(abs(r["update_norm_ratio"] - 1)
                                        for r in rows)}

    one = engine(styles[:fdc.batch_size],
                 dataclasses.replace(fdc, lr_schedule="constant"))
    (s1, _), l1 = count_launches(lambda: batched(one, mesh))
    record_launches(paths, cfg, "dp_sweep_one_step", l1, 4, 4)
    p1, _ = batched(one, None)
    with tf32_control(torch):
        t1, _ = batched(one, mesh)
    readings = gate_of(_update_agreement(s1, p1, d0))
    control = gate_of(_update_agreement(t1, p1, d0))
    del one
    run = engine(styles[:DP_SWEEP_SEEDS], fdc)
    (sd, sinfo), lr = count_launches(lambda: batched(run, mesh))
    steps = sinfo["iterations"]
    record_launches(paths, cfg, "dp_sweep", lr, 4 * steps, 4 * steps)
    pd, pinfo = batched(run, None)
    gates = {"one_minus_cosine": 1 - SWEEP_STEP_COS,
             "norm_ratio_error": SWEEP_STEP_NORM_RTOL}
    checks = {"steps": steps == DP_SWEEP_SEEDS // fdc.batch_size,
              "history_finite": bool(np.isfinite(sinfo["history"]).all()),
              "run_moved": float(np.abs(sd - d0).max()) > 0}
    emit({"phase": "dp_sweep", "card": smi, "mesh": mesh.shape,
          "prompts": len(SWEEP_PROMPTS), "batch": fdc.batch_size,
          "one_step": readings, "tf32_control": control, "gates": gates,
          "run_agreement": _update_agreement(sd, pd, d0),
          "run_history_max_rel": float(np.max(np.abs(
              sinfo["history"] - pinfo["history"])
              / np.abs(pinfo["history"]))),
          "sharded_ms_per_step": sinfo["steady_ms_per_step"],
          "unsharded_ms_per_step": pinfo["steady_ms_per_step"],
          "launches": {"one_step": l1, "run": lr},
          "seconds": time.perf_counter() - t0, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"dp_sweep checks failed: {checks}")
    _gate_all("dp_sweep", readings, control, gates, {})


def _off_by_one(a, b):
    """(max |a − b|, share of values that differ) of two uint8 arrays."""
    import numpy as np

    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def phase_dp_serve(torch, net, direction, smi, paths):
    """BatchEditor(mesh=[cuda:0, cuda:0]) against the unsharded editor on
    the serving cell: a batch-16 request within ±1 per uint8 and at most
    DP_SERVE_OFF_SHARE of its values off by one (beside a TF32 control of
    the sharded editor that must exceed it); its launches, 2 synthesis
    calls (B1 12); a batch-1 request takes the plain path (1 call, B1 6).
    images/s at batch 16 both ways."""
    from stylemc_torch.serve import BatchEditor

    t0 = time.perf_counter()
    sharded = BatchEditor.from_files(net, direction=direction, max_batch=64,
                                     mesh=card_mesh(2), device="cuda")
    plain = BatchEditor.from_files(net, direction=direction, max_batch=64,
                                   device="cuda")
    styles = plain.styles_from_seeds(list(range(DP_SERVE_BATCH)))
    want = plain.edit_styles(styles, change_power=2.0)
    got, launches = count_launches(
        lambda: sharded.edit_styles(styles, change_power=2.0))
    record_launches(paths, sharded.cfg, "dp_serve_b16", launches, 2)
    small, l1 = count_launches(
        lambda: sharded.edit_styles(styles[:1], change_power=2.0))
    record_launches(paths, sharded.cfg, "dp_serve_b1", l1, 1)
    with tf32_control(torch):
        t32 = sharded.edit_styles(styles, change_power=2.0)
    rate = {}
    for name, ed in (("sharded", sharded), ("unsharded", plain)):
        ed.edit_styles(styles, change_power=2.0)
        ms = event_ms(lambda ed=ed: ed.edit_styles(styles, change_power=2.0),
                      iters=10, warmup=2)
        rate[name] = DP_SERVE_BATCH * 1e3 / ms
    worst, share = _off_by_one(got, want)
    worst_t, share_t = _off_by_one(t32, want)
    worst1, _ = _off_by_one(small, want[:1])
    checks = {"within_one": worst <= 1, "b1_within_one": worst1 <= 1,
              "shape": got.shape == want.shape}
    emit({"phase": "dp_serve", "card": smi, "batch": DP_SERVE_BATCH,
          "shards": 2, "max_abs": worst, "off_by_one_share": share,
          "tf32_control": {"max_abs": worst_t, "off_by_one_share": share_t},
          "gate_off_by_one_share": DP_SERVE_OFF_SHARE,
          "images_per_s": rate,
          "times_are": "CUDA events over 10 back-to-back edit_styles calls "
                       "(host cost and the uint8 copy included)",
          "launches": {"b16": launches, "b1": l1},
          "seconds": time.perf_counter() - t0, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"dp_serve checks failed: {checks}")
    _gate("dp_serve_off_by_one_share", share, share_t, DP_SERVE_OFF_SHARE,
          {})


def phase_dp_coach(torch, models, photos, smi, paths):
    """One full-width coach step (e4e_train's models, the R1 step at
    global step 16, stage 7, batch 4) over DataMesh([cuda:0, cuda:0])
    against the unsharded step on the card: the discriminator's step and
    R1, then the encoder's loss and gradients against the updated
    discriminator. Gates (e4e_train_parity's): every loss rtol 1e-4, the
    loss's gradient at the codes relative L2 1e-3, the discriminator after
    its step and R1 relative L2 1e-5, each beside a TF32 control of the
    sharded side. B1 and B2 8 a shard."""
    import numpy as np

    from stylemc_torch.data.images import ImagesDataset
    from stylemc_torch.train.coach import Coach, CoachOptions
    from stylemc_torch.train.ranger import tree_leaves

    t0 = time.perf_counter()
    cfg, psp, perception = models
    ds = ImagesDataset(photos, size=256)
    x = np.stack([ds[i][0] for i in range(DP_COACH_BATCH)])
    opts = CoachOptions(**{**E4E_TRAIN_OPTS, "batch_size": DP_COACH_BATCH})

    def step(mesh, tf32=False):
        c = Coach(opts, psp, perception, lambda: None, mesh=mesh,
                  device="cuda")
        c.global_step = E4E_PARITY_STEP
        stage = c.progressive_stage()
        at_codes = []
        calc = c._calc_loss

        def hooked(*a, **kw):
            loss, (d, y_hat, latent) = calc(*a, **kw)
            latent.register_hook(lambda g: at_codes.append(g.detach()))
            return loss, (d, y_hat, latent)

        c._calc_loss = hooked
        xt = c._to_device(x)
        with tf32_control(torch) if tf32 else contextlib.nullcontext():
            d_dict = c.train_discriminator(xt)
            enc_dict, _ = c.encoder_gradients(xt, xt, stage)
        # the full batch's gradient at the codes: each shard's, weighted by
        # its share of the rows
        n = len(at_codes)
        g = torch.cat([a / n for a in at_codes]).cpu()
        losses = {k: float(v) for k, v in {**d_dict, **enc_dict}.items()}
        disc = torch.cat([t.detach().reshape(-1) for t in
                          tree_leaves(c.discriminator_params)]).cpu()
        del c
        torch.cuda.empty_cache()
        return losses, g, disc, stage

    (sharded, sg, sdisc, stage), launches = count_launches(
        lambda: step(card_mesh(2)))
    record_launches(paths, cfg, "dp_coach", launches, 2, 2)
    plain, pg, pdisc, _ = step(None)
    t32, tg, tdisc, _ = step(card_mesh(2), tf32=True)

    def reading(losses, g, disc):
        return {"loss_rel": max(abs(losses[k] - plain[k])
                                / max(abs(plain[k]), 1e-12) for k in plain),
                "codes_grad_rel_l2": _rel(g, pg),
                "discriminator_rel_l2": _rel(disc, pdisc)}

    gates = {"loss_rel": E4E_PARITY_LOSS_RTOL,
             "codes_grad_rel_l2": E4E_PARITY_GRAD_REL_L2,
             "discriminator_rel_l2": E4E_PARITY_D_REL_L2}
    readings, control = reading(sharded, sg, sdisc), reading(t32, tg, tdisc)
    checks = {"keys": list(sharded) == list(plain),
              "finite": _finite(sharded), "r1": "discriminator_r1_loss"
              in sharded, "stage": stage == 7}
    emit({"phase": "dp_coach", "card": smi, "batch": DP_COACH_BATCH,
          "shards": 2, "stage": stage, "losses": sharded,
          "readings": readings, "tf32_control": control, "gates": gates,
          "launches": launches, "seconds": time.perf_counter() - t0,
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"dp_coach checks failed: {checks}")
    record = {}
    for k, g in gates.items():
        _gate(f"dp_coach_{k}", readings[k], control[k], g, record)


def phase_dp_metrics(torch, net, smi, paths):
    """FID, KID and PPL (calc_metric) at full width with mesh=[cuda:0,
    cuda:0] on DP_METRICS_NUM generated images against the same calls
    without it; the seeded Inception v3 and LPIPS-VGG16, and a stand-in
    dataset of 64 images the generator renders at other latents, its
    features computed once. Every metric value within rtol
    DP_METRICS_RTOL, beside a TF32 control of the sharded side; the
    features of each run go through one FeatureStats. Launches per
    metric: 2 synthesis calls a batch of 16 (PPL: 4)."""
    import numpy as np

    from stylemc_torch.edit import to_u8_nhwc
    from stylemc_torch.io import load_generator
    from stylemc_torch.metrics import FeatureStats, MetricOptions, calc_metric
    from stylemc_torch.metrics.inception import inception_features
    from stylemc_torch.models.stylegan2.generator import (
        mapping, synthesis, w_to_s)

    t0 = time.perf_counter()
    cfg, params = load_generator(net, device="cuda")
    inc, lp = metric_detectors(torch, "cuda")
    gen = torch.Generator().manual_seed(METRICS_DATA_SEED)
    with torch.no_grad():
        z = torch.randn((DP_METRICS_NUM, cfg.z_dim), generator=gen).cuda()
        real = to_u8_nhwc(synthesis(params, cfg, w_to_s(params, cfg, mapping(
            params, cfg, z))))
        real_f = inception_features(inc, real).cpu().numpy()

    def dataset(opts, max_items):
        stats = FeatureStats(capture_all=True, capture_mean_cov=True,
                             max_items=max_items)
        stats.append(real_f)
        return stats

    def opts(mesh):
        return MetricOptions(
            gen_params=params, gen_cfg=cfg, lpips_params=lp,
            inception_features_fn=lambda u: inception_features(inc, u),
            dataset_features_fn=dataset, num_gen=DP_METRICS_NUM,
            batch_size=METRICS_BATCH, device="cuda", mesh=mesh)

    calls = DP_METRICS_NUM // METRICS_BATCH
    values = {}
    for name in DP_METRICS_RTOL:
        per = 4 * calls if name == "ppl2_wend" else 2 * calls
        r, launched = count_launches(
            lambda: calc_metric(name, opts=opts(card_mesh(2))))
        record_launches(paths, cfg, f"dp_{name}", launched, per)
        sharded = next(iter(r.results.values()))
        plain = next(iter(calc_metric(name, opts=opts(None))
                          .results.values()))
        with tf32_control(torch):
            t32 = next(iter(calc_metric(name, opts=opts(card_mesh(2)))
                            .results.values()))
        values[name] = {"sharded": sharded, "unsharded": plain,
                        "tf32_sharded": t32,
                        "rel": abs(sharded - plain) / abs(plain),
                        "tf32_rel": abs(t32 - plain) / abs(plain),
                        "seconds_sharded": r.total_time}
    checks = {"finite": all(np.isfinite(v["sharded"])
                            for v in values.values())}
    emit({"phase": "dp_metrics", "card": smi, "images": DP_METRICS_NUM,
          "batch": METRICS_BATCH, "shards": 2, "values": values,
          "gates_rtol": DP_METRICS_RTOL, "seconds": time.perf_counter() - t0,
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"dp_metrics checks failed: {checks}")
    record = {}
    for name, v in values.items():
        _gate(f"dp_{name}", v["rel"], v["tf32_rel"], DP_METRICS_RTOL[name],
              record)


def phase_dp_ranks(torch, models, styles, net, direction_file, tmp, smi,
                   paths):
    """Data parallelism across processes on the one card. (1) Two
    subprocesses (`stylemc_torch.bench.dp_ranks`) form a gloo group and
    run its three checks: one full-width find_direction step of batch 4
    (2 rows a process) against the single-process full-batch step on the
    card (loss rtol 1e-4, the Δs update relative L2 3e-3; the TF32
    control of the full-batch step must fail it), the two ranks bit-equal;
    append_multihost's process-major rows; Collector(cross_process=True)
    over the union. (2) Two NCCL ranks on the one card, each under a
    timeout: what NCCL does with them is recorded. (3) A world-size-1
    NCCL group in this process: the same DP step through a real NCCL
    all-reduce, whose output must equal its input bit for bit, and the
    step held to the run with no group at dp_train's gates beside a
    repeat of that run (the card's step is not bit-reproducible run to
    run: cuDNN's and the resizes' backward kernels sum in no fixed
    order); the all-reduce's time for Δs's gradient."""
    import numpy as np

    from stylemc_torch.bench import dp_ranks
    from stylemc_torch.models.clip import CLIP_CONFIGS
    from stylemc_torch.parallel.mesh import all_reduce_sum

    t0 = time.perf_counter()
    cfg, gp, _, _, clip, arc = models
    d0 = np.load(direction_file)["s"].astype(np.float32)
    items = styles[:DP_RANKS_ITEMS].cpu().numpy()
    fdc = {"n_epochs": 1, "lr_schedule": "constant"}
    spec = {"network": net, "clip": {k: ({}, s) for k, s in
                                      CLIP_SEEDS.items()},
            "arcface": ARCFACE_SEED, "styles": items, "fdc": fdc,
            "resume": d0, "device": "cuda:0", "shards": 1,
            "backend": "gloo", "threads": 4}
    assert set(CLIP_CONFIGS) >= set(CLIP_SEEDS)
    models_t = (cfg, gp, clip, arc)
    ref_d, ref = dp_ranks.dp_step(spec, models_t, None)
    with tf32_control(torch):
        t_d, t_info = dp_ranks.dp_step(spec, models_t, None)
    control = _run_readings(t_info["history"], t_d, ref["history"], ref_d,
                            d0)
    tol = {"history_rtol": PARITY_LOSS_RTOL, "direction_key":
           "update_rel_l2", "direction_tol": DP_DELTA_REL_L2}
    spec["refs"] = {"full_batch": dict(tol, history=ref["history"],
                                       direction=ref_d)}
    path = dp_ranks.write_spec(os.path.join(tmp, "dp_spec.pkl"), **spec)
    port = dp_ranks.free_port()
    outs = [os.path.join(tmp, f"dp_rank{r}.json") for r in range(2)]
    t1 = time.perf_counter()
    procs = dp_ranks.spawn_group(lambda r: [path, r, 2, port, outs[r]], 2,
                                 DP_RANKS_TIMEOUT_S)
    group_s = time.perf_counter() - t1
    for r, p in enumerate(procs):
        if p["rc"] != 0 or p["timed_out"]:
            raise RuntimeError(f"dp_ranks rank {r}: rc {p['rc']}, timed out "
                               f"{p['timed_out']}\n{p['output'][-4000:]}")
    res = []
    for r, out in enumerate(outs):
        with open(out) as f:
            res.append(json.load(f))
        # each rank renders its items once (one precompute chunk), then
        # its shard of the step: a synthesis call and a backward pass
        record_launches(paths, cfg, f"dp_ranks_gloo_rank{r}",
                        res[r]["launches"], 2, 1)

    # two NCCL ranks on one card
    port = dp_ranks.free_port()
    probe = dp_ranks.spawn_group(lambda r: ["--probe", "nccl", r, 2, port],
                                 2, DP_PROBE_TIMEOUT_S)
    nccl_pair = [{"rc": p["rc"], "timed_out": p["timed_out"],
                  "said": [x for x in p["output"].splitlines()
                           if "uplicate" in x or "rank" in x.lower()][-4:]}
                 for p in probe]

    # a world-size-1 NCCL group in this process; the step's all-reduce
    # recorded: what went in and what came out
    from stylemc_torch.parallel import DataMesh
    from stylemc_torch.parallel import mesh as pmesh

    mesh1 = DataMesh(["cuda:0"])
    nogroup_d, nogroup = dp_ranks.dp_step(spec, models_t, mesh1)
    repeat_d, repeat = dp_ranks.dp_step(spec, models_t, mesh1)
    reduced = []

    def recording(tensors):
        ins = [t.detach().clone() for t in tensors]
        outs = all_reduce_sum(tensors)
        reduced.append((ins, [t.detach().clone() for t in outs]))
        return outs

    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{dp_ranks.free_port()}",
        world_size=1, rank=0)
    pmesh.all_reduce_sum = recording
    try:
        (group_d, group), launches = count_launches(
            lambda: dp_ranks.dp_step(spec, models_t, mesh1))
        pmesh.all_reduce_sum = all_reduce_sum
        g = torch.randn((1, 8, 512), device="cuda")
        vals = [torch.randn((), device="cuda") for _ in range(4)]
        reduce_ms = event_ms(lambda: all_reduce_sum([g] + vals), iters=50,
                             warmup=5)
        backend = torch.distributed.get_backend()
    finally:
        pmesh.all_reduce_sum = all_reduce_sum
        torch.distributed.destroy_process_group()
    record_launches(paths, cfg, "dp_ranks_nccl1", launches,
                    1 + group["iterations"], group["iterations"])
    nccl1 = {"group_vs_nogroup": _run_readings(
        group["history"], group_d, nogroup["history"], nogroup_d, d0),
        "repeat_vs_nogroup": _run_readings(
            repeat["history"], repeat_d, nogroup["history"], nogroup_d, d0),
        "repeat_bit_equal": bool(np.array_equal(repeat_d, nogroup_d)),
        "all_reduces": len(reduced),
        "all_reduce_bit_equal": all(
            torch.equal(a, b) for ins, outs in reduced
            for a, b in zip(ins, outs))}
    readings = res[0]["refs"]["full_batch"]
    checks = {
        "ranks_ok": all(x["ok"] for x in res),
        "append_multihost": all(x["append_multihost"] for x in res),
        "collector": all(x["collector_cross_process"] for x in res),
        "ranks_bit_equal": res[0]["history"] == res[1]["history"]
        and res[0]["direction_sum"] == res[1]["direction_sum"]
        and res[0]["direction_norm"] == res[1]["direction_norm"],
        "nccl1_all_reduce_bit_equal": nccl1["all_reduce_bit_equal"]
        and nccl1["all_reduces"] == group["iterations"],
        "nccl1_step": all(nccl1["group_vs_nogroup"][k] <= g
                          for k, g in DP_TRAIN_GATES.items()),
        "nccl1_backend": backend == "nccl"}
    emit({"phase": "dp_ranks", "card": smi, "world": 2, "backend": "gloo",
          "items": DP_RANKS_ITEMS, "readings": readings,
          "tf32_control": control,
          "gates": {"history_rel": PARITY_LOSS_RTOL,
                    "update_rel_l2": DP_DELTA_REL_L2},
          "rank_step_s": [x["dp_step_s"] for x in res],
          "group_seconds": group_s, "nccl_two_ranks_one_card": nccl_pair,
          "nccl1": nccl1,
          "nccl1_all_reduce_ms": reduce_ms,
          "all_reduce_is": "one NCCL all-reduce of Δs's gradient [1,8,512] "
                           "and 4 scalars, world size 1; CUDA events over "
                           "50 back-to-back calls",
          "launches_nccl1": launches, "seconds": time.perf_counter() - t0,
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"dp_ranks checks failed: {checks}")
    _gate_all("dp_ranks", {k: readings[k] for k in DP_TRAIN_GATES}, control,
              DP_TRAIN_GATES, {})


MODCONV_REPLACES = {
    "modconv_fwd": ("modconv_pallas.py:88", "_fwd_kernel/_fwd_call"),
    "modconv_bwd_data": ("modconv_pallas.py:170",
                         "_bwd_data_kernel/_bwd_data_call"),
    "modconv_bwd_weight": ("modconv_pallas.py:310",
                           "_bwd_weight_kernel/_bwd_weight_call"),
}


def phase_mma_rate():
    """The tensor cores' TF32 rate through mma.sync, the instruction B3, B4
    and B5 are built on (`stylemc_torch.bench.mma_rate`): the ceiling their
    TFLOP/s are read against."""
    from stylemc_torch.bench.mma_rate import mma_sync_tf32_tflop_per_s

    rate = mma_sync_tf32_tflop_per_s("cuda")
    emit({"phase": "mma_rate", "mma_sync_tf32_tflop_per_s": rate,
          "three_pass_tflop_per_s": rate / TF32_PASSES})
    return rate


def kernel_rates(rows, mma_rate):
    """B3's, B4's and B5's TFLOP/s and split plan per timed shape beside
    `mma.sync`'s 3xTF32 ceiling (one `<kernel>_rate` line each, after the
    mma_rate phase)."""
    ceiling = mma_rate / TF32_PASSES
    for name in MODCONV_KERNELS:
        for r in rows[name]:
            if "kernel_tflop_per_s" in r:
                emit({"phase": f"{name}_rate", "case": r["case"],
                      "n": r["n"], "h": r["h"], "w": r["w"],
                      "plan": r["plan"],
                      "kernel_tflop_per_s": r["kernel_tflop_per_s"],
                      "mma_sync_3xtf32_ceiling_tflop_per_s": ceiling,
                      "share_of_ceiling": r["kernel_tflop_per_s"] / ceiling})


def modconv_entries(rows, paths, smi, mma_rate):
    """The `kernels` line's B3/B4/B5 entries: times summed over the seven
    full-width conv1 shapes at batch 4 (one training step's conv1s, were
    the generator wired to the kernels); B3's batch-16 sum beside it; each
    one's rate beside mma.sync's 3xTF32 ceiling."""
    entries = []
    for name in MODCONV_KERNELS:
        main_rows = [r for r in rows[name] if r["case"].startswith("b")
                     and r["n"] == 4]
        line, function = MODCONV_REPLACES[name]

        def total(key, rs=main_rows):
            return sum(r[key] for r in rs)

        entry = {
            "name": name, "route": "cuda",
            "source": f"stylemc_torch/ops/kernels/csrc/{name}.cu",
            "replaces": f"stylemc_tpu/ops/pallas/{line}",
            "replaces_function": function,
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {k: v["launches"][name]
                                 for k, v in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": total("kernel_ms"), "kernel_ms": total("kernel_ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            # the side that bounds most of the summed time
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] for r in main_rows if r["bound_by"] == by)),
            "fp32_fma_bound_ms": total("fp32_fma_bound_ms"),
            "library_ms": total("library_ms"),
            "tflop_per_s": total("flop") / total("kernel_ms") / 1e9,
            "times_are": "sum over the seven FFHQ-256 conv1 shapes at batch "
                         "4; device time (CUDA events around calls queued "
                         "behind a sleep kernel); launches from the A/B "
                         "paths (ab_*), 0 on every other path",
            "card": smi}
        if name == "modconv_fwd":
            b16 = [r for r in rows[name] if r["n"] == 16]
            entry.update({f"batch16_{k}": total(k, b16) for k in (
                "kernel_ms", "plain_ms", "bound_ms", "fp32_fma_bound_ms",
                "library_ms")})
        else:
            entry["max_rel_l2"] = max(r["max_rel_l2"] for r in rows[name])
        entry["mma_sync_3xtf32_ceiling_tflop_per_s"] = mma_rate / TF32_PASSES
        entries.append(entry)
    return entries


# ------------------------------------------------ TF pickles, verify, CLIs

# stylegan2-ffhq-config-f: fmap_base 16384 (channel_base 32768), fmap_max
# 512, 8 mapping layers; no fp16, no clamp
TF_CFG_KW = dict(img_resolution=1024, num_fp16_res=0, conv_clamp=None)
TF_SEEDS = {"G": 20, "D": 21}
TF_RENDER_SEEDS = list(range(8))
TF_PARITY_ITEMS = 2          # renders and logits held card against CPU
TF_RENDER_OFF_SHARE = 1e-3   # uint8 values off by one, card against CPU
TF_D_RTOL = 1e-4             # max |Δ logit| / max |logit|, card against CPU
TF_TIMED_ITERS = 5
VERIFY_SEEDS = "0-1"         # 2 items: 4 find_direction steps (4 epochs)
VERIFY_RENDER_OFF_SHARE = 1e-3  # golden uint8 values off by one, card/CPU
VERIFY_DIRECTION_GATE = 1e-3    # 1 - cosine_mean of the direction, card/CPU
VERIFY_FID_SAMPLES = 16      # one batch of 16 a side
VERIFY_E4E_SEEDS = {"encoder": 30, "decoder": 31, "latent_avg": 32}
VERIFY_INCEPTION_SEED = 33
CLIP_FILTER_IMAGES = 16
CLIP_FILTER_PROMPTS = "a photo of a man|a photo of a woman"
# a stand-in BPE vocabulary (the real one is not in the repository): the
# byte-level tokens and ten merges
CLIP_BPE_MERGES = [("t", "h"), ("a", "n"), ("i", "n"), ("o", "f"),
                   ("r", "e"), ("f", "a"), ("c", "e"), ("m", "a"),
                   ("w", "o"), ("e", "d")]


def _same(a, b) -> bool:
    """Two numpy params trees hold the same names and bit-equal values
    (a scalar's shape () or (1,) alike)."""
    import numpy as np

    if isinstance(b, dict):
        return isinstance(a, dict) and sorted(a) == sorted(b) and all(
            _same(a[k], b[k]) for k in b)
    return np.array_equal(np.asarray(a).reshape(np.shape(b)), b)


def run_cli_here(paths, cfg, path, module, *args):
    """`module`'s click command run in this process, its launches counted
    and held to none (a CLI that renders nothing); its seconds."""
    t0 = time.perf_counter()

    def call():
        try:
            module.main(args=list(args), standalone_mode=False)
        except SystemExit as e:
            if e.code not in (None, 0):
                raise RuntimeError(f"{module.__name__} exited {e.code}")

    _, launches = count_launches(call)
    record_launches(paths, cfg, path, launches, 0)
    return time.perf_counter() - t0


def _u8_parity(a, b):
    """(max |Δ|, share of values off by one) of two uint8 arrays."""
    import numpy as np

    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d == 1).mean())


def phase_tf_legacy(torch, tmp, smi, paths):
    """A TF1 (G, D, Gs) pickle of a seeded full-width
    stylegan2-ffhq-config-f network (resolution 1024, fmap_base 16384,
    fmap_max 512, 8 mapping layers, no fp16, no clamp) and its resnet
    discriminator at 1024, written by stylemc_torch.bench.tf_pickle (no
    TensorFlow, no JAX): load_generator onto the card, renders card
    against CPU, the discriminator card against CPU, the legacy CLI's .npz
    bit-equal to the loaded params."""
    import numpy as np

    from stylemc_torch.bench.tf_pickle import write_tf_pickle
    from stylemc_torch.cli import legacy as legacy_cli
    from stylemc_torch.convert import params_from_numpy, params_to_numpy
    from stylemc_torch.edit import to_u8_nhwc
    from stylemc_torch.io import (discriminator_from_stub, load_generator,
                                  load_native, load_network_pkl)
    from stylemc_torch.models.stylegan2.discriminator import (
        discriminator_apply, init_discriminator_params)
    from stylemc_torch.models.stylegan2.generator import (
        GeneratorConfig, init_generator_params, synthesis)

    t0 = time.perf_counter()
    cfg = GeneratorConfig(**TF_CFG_KW)
    res = cfg.img_resolution
    g = init_generator_params(torch.Generator().manual_seed(TF_SEEDS["G"]),
                              cfg, device="cpu")
    for bp in g["synthesis"].values():
        bp["torgb"]["weight"] *= E4E_TORGB_SCALE
    d = init_discriminator_params(
        torch.Generator().manual_seed(TF_SEEDS["D"]), size=res,
        device="cpu")
    path = write_tf_pickle(os.path.join(tmp, "stylegan2-ffhq-config-f.pkl"),
                           cfg, g, d, res)
    write_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    tcfg, params = load_generator(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    gp = params_to_numpy(params)
    params_equal = _same(gp, params_to_numpy(g))
    cpu_params = params_from_numpy(gp, "cpu")
    s8 = seed_styles(torch, params, tcfg, TF_RENDER_SEEDS, "cuda")

    def render():
        with torch.inference_mode():
            return synthesis(params, tcfg, s8, noise_mode="const")

    img, launches = count_launches(render)
    record_launches(paths, tcfg, "tf_legacy_render", launches, 1)
    render()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TF_TIMED_ITERS):
        render()
    torch.cuda.synchronize()
    render_s = (time.perf_counter() - t0) / TF_TIMED_ITERS
    finite = bool(torch.isfinite(img).all())

    # card against CPU on the first seeds, each side rendering them alone
    seeds = TF_RENDER_SEEDS[:TF_PARITY_ITEMS]
    with torch.inference_mode():
        s2 = seed_styles(torch, params, tcfg, seeds, "cuda")
        card_u8 = to_u8_nhwc(synthesis(params, tcfg, s2)).cpu().numpy()
        with tf32_control(torch):
            tf32_u8 = to_u8_nhwc(synthesis(params, tcfg, s2)).cpu().numpy()
        cpu_u8 = to_u8_nhwc(synthesis(cpu_params, tcfg, seed_styles(
            torch, cpu_params, tcfg, seeds, "cpu"))).numpy()
    card_max, card_share = _u8_parity(card_u8, cpu_u8)
    tf32_max, tf32_share = _u8_parity(tf32_u8, cpu_u8)
    gates = {}
    _gate("tf_render_off_by_one_share", card_share, tf32_share,
          TF_RENDER_OFF_SHARE, gates)
    if card_max > 1:
        raise AssertionError(f"TF generator renders card against CPU: "
                             f"max |Δ| {card_max} > 1")

    # the discriminator, on the card's renders (timed) and on the parity
    # renders card against CPU, both sides fed the card's images
    t0 = time.perf_counter()
    size, dparams = discriminator_from_stub(load_network_pkl(path)["D"],
                                            device="cuda")
    dload_s = time.perf_counter() - t0
    d_equal = size == res and _same(params_to_numpy(dparams),
                                    params_to_numpy(d))
    cpu_d = params_from_numpy(params_to_numpy(dparams), "cpu")
    x8 = img.clamp(-1, 1)

    def disc():
        with torch.inference_mode():
            return discriminator_apply(dparams, x8)

    logits8, dl = count_launches(disc)
    record_launches(paths, tcfg, "tf_legacy_discriminator", dl, 0)
    d_ms = event_ms(disc, iters=10, warmup=2)
    x2 = torch.from_numpy(card_u8).permute(0, 3, 1, 2).float() / 127.5 - 1
    with torch.inference_mode():
        card_logits = discriminator_apply(dparams, x2.to("cuda")).cpu()
        with tf32_control(torch):
            tf32_logits = discriminator_apply(dparams, x2.to("cuda")).cpu()
        cpu_logits = discriminator_apply(cpu_d, x2)
    scale = float(cpu_logits.abs().max())
    _gate("tf_discriminator_rel",
          float((card_logits - cpu_logits).abs().max()) / scale,
          float((tf32_logits - cpu_logits).abs().max()) / scale, TF_D_RTOL,
          gates)

    # the legacy CLI reads the TF pickle; its .npz holds the same params
    npz = os.path.join(tmp, "stylegan2-ffhq-config-f.npz")
    cli_s = run_cli_here(paths, tcfg, "tf_legacy_cli", legacy_cli,
                         "--source", path, "--dest", npz)
    ncfg, nparams = load_native(npz, device="cpu")
    npz_equal = ncfg == tcfg and _same(params_to_numpy(nparams), gp)
    checks = {"config": tcfg == cfg, "generator_params_bit_equal":
              params_equal, "discriminator_params_bit_equal": d_equal,
              "renders_finite": finite,
              "logits_finite": bool(torch.isfinite(logits8).all()),
              "legacy_npz_bit_equal": npz_equal}
    emit({"phase": "tf_legacy", "card": smi,
          "config": {"resolution": res,
                     "fmap_base": cfg.channel_base // 2,
                     "fmap_max": cfg.channel_max,
                     "mapping_layers": cfg.mapping_layers,
                     "num_fp16_res": 0, "conv_clamp": None},
          "pickle_bytes": os.path.getsize(path), "write_s": write_s,
          "load_generator_s": load_s, "load_discriminator_s": dload_s,
          "render_batch": len(TF_RENDER_SEEDS), "render_s": render_s,
          "images_per_s": len(TF_RENDER_SEEDS) / render_s,
          "discriminator_ms_per_batch8": d_ms,
          "launches": {"render": launches, "discriminator": dl},
          "render_parity": {"max_abs": card_max, "off_by_one": card_share,
                            "tf32_max_abs": tf32_max,
                            "tf32_off_by_one": tf32_share},
          "gates": gates, "legacy_cli_s": cli_s, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"tf_legacy checks failed: {checks}")
    return path


def write_verify_files(torch, clip_models, arc, size, tmp):
    """The weight files `verify` reads, from seeded networks in the
    reference's state-dict names: an e4e checkpoint at the network's size
    (the IR-SE-50 Encoder4Editing, 14 style heads at 256, and the
    rosinality decoder),
    a CLIP dir (full-width ViT-B/32 and ViT-B/16, the train phase's seeded
    weights, and a stand-in BPE vocabulary), the train phase's IR-SE-50
    and a seeded Inception v3."""
    import gzip

    from stylemc_torch.io.export import save_e4e_pt
    from stylemc_torch.io.rosinality import config_for_rosinality
    from stylemc_torch.io.torch_state import state_from_params
    from stylemc_torch.metrics import inception
    from stylemc_torch.models import arcface
    from stylemc_torch.models.clip import model as clip
    from stylemc_torch.models.e4e.encoders import init_encoder_params
    from stylemc_torch.models.stylegan2.generator import (
        init_generator_params, mapping)

    def gen(key):
        return torch.Generator().manual_seed(VERIFY_E4E_SEEDS[key])

    def save(path, state):
        torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
        return path

    d = os.path.join(tmp, "verify")
    os.makedirs(os.path.join(d, "clip"))
    enc = init_encoder_params(gen("encoder"), size, device="cpu")
    dcfg = config_for_rosinality(size)
    dec = init_generator_params(gen("decoder"), dcfg, device="cpu")
    with torch.inference_mode():
        z = torch.randn((4096, dcfg.z_dim), generator=gen("latent_avg"))
        w_avg = mapping(dec, dcfg, z)[:, 0].mean(dim=0)
    files = {"e4e": save_e4e_pt(os.path.join(d, f"e4e_{size}.pt"), enc, dcfg,
                                dec, w_avg),
             "clip_dir": os.path.join(d, "clip"),
             "arcface": save(os.path.join(d, "model_ir_se50.pth"),
                             state_from_params(arcface.params_from_torch_state,
                                               arc)),
             "inception": save(os.path.join(d, "inception.pth"),
                               state_from_params(
                                   inception.params_from_torch_state,
                                   inception.init_inception_params(
                                       torch.Generator().manual_seed(
                                           VERIFY_INCEPTION_SEED),
                                       device="cpu")))}
    for name, (ccfg, cparams) in clip_models.items():
        save(os.path.join(files["clip_dir"], name.replace("/", "-") + ".pt"),
             state_from_params(clip.params_from_torch_state, cparams, ccfg))
    files["bpe"] = os.path.join(files["clip_dir"],
                                "bpe_simple_vocab_16e6.txt.gz")
    with gzip.open(files["bpe"], "wt") as f:
        f.write("\n".join(["#version: stand-in"] + [
            f"{a} {b}</w>" for a, b in CLIP_BPE_MERGES]) + "\n")
    return files


def _verify_cpu_refs(torch, net, files):
    """The CPU's golden renders (verify --write_golden_renders) and the
    direction of the port's CPU find_direction on the verify files and
    seeds; (golden path, direction path, seconds of each). Nothing here
    launches a kernel."""
    import numpy as np

    from stylemc_torch.cli import verify_weights as verify_cli
    from stylemc_torch.io import load_generator
    from stylemc_torch.models.clip.load import load_clip
    from stylemc_torch.models.clip.tokenizer import SimpleTokenizer
    from stylemc_torch.train.find_direction import (FindDirectionConfig,
                                                    find_direction)
    from stylemc_torch.utils.misc import num_range
    from stylemc_torch.utils.model_zoo import load_arcface

    d = os.path.dirname(files["e4e"])
    golden = os.path.join(d, "golden_cpu.npz")
    t0 = time.perf_counter()
    try:
        verify_cli.main(args=[
            "--network", net, "--seeds", VERIFY_SEEDS,
            "--write_golden_renders", golden, "--report",
            os.path.join(d, "golden_report.json"), "--device", "cpu"],
            standalone_mode=False)
    except SystemExit as e:
        if e.code not in (None, 0):
            raise RuntimeError(f"verify --write_golden_renders exited "
                               f"{e.code}")
    golden_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, params = load_generator(net, device="cpu")
    clips = {name: load_clip(name, files["clip_dir"], device="cpu")
             for name in ("ViT-B/32", "ViT-B/16")}
    styles = seed_styles(torch, params, cfg, num_range(VERIFY_SEEDS), "cpu")
    direction, info = find_direction(
        params, cfg, styles.numpy(), clips,
        load_arcface(files["arcface"], device="cpu"),
        FindDirectionConfig(resolution=min(256, cfg.img_resolution)),
        tokenizer=SimpleTokenizer(files["bpe"]))
    recorded = os.path.join(d, "direction_cpu.npz")
    np.savez(recorded, s=direction.numpy())
    return {"golden": golden, "direction": recorded, "golden_s": golden_s,
            "direction_s": time.perf_counter() - t0,
            "direction_steps": info["iterations"]}


def phase_verify_files(torch, models, net, tmp):
    """verify's weight files, from the train phase's perception models."""
    from stylemc_torch.io import load_generator

    cfg, _ = load_generator(net, device="cpu")
    t0 = time.perf_counter()
    # the train phase's seeded CLIP and ArcFace, their CPU copies
    files = write_verify_files(torch, models[2], models[3],
                               cfg.img_resolution, tmp)
    emit({"phase": "verify_files", "write_files_s": time.perf_counter() - t0})
    return files


def _verify_tf32_control(torch, args):
    """A verify run in this process with TF32 on in cuDNN and cuBLAS (its
    own disable_tf32 held off); its report. Its launches are not counted
    to a path, and its checks may fail."""
    import stylemc_torch.device as device
    from stylemc_torch.cli import verify_weights as verify_cli

    saved = device.disable_tf32
    device.disable_tf32 = lambda dev: None
    try:
        with tf32_control(torch):
            verify_cli.main(args=list(args), standalone_mode=False)
    except SystemExit:
        pass
    finally:
        device.disable_tf32 = saved
    with open(args[args.index("--report") + 1]) as f:
        return json.load(f)


def phase_verify(torch, net, tf_pkl, deeplab_ckpt, landmark_files, files,
                 smi, paths):
    """`python -m stylemc_torch verify` on the card with every check: the
    FFHQ-256 network, the TF pickle, e4e, CLIP, ArcFace, Inception (and the
    FID split), DeepLab and MobileNet from seeded files, golden renders from
    a CPU run of the port's own verify --write_golden_renders, and the
    direction of the port's CPU find_direction on the same files and seeds,
    both computed first with nothing on the card. The card's golden renders
    and its direction's cosine are gated against the CPU's beside a TF32
    verify run."""
    import numpy as np

    cpu = _verify_cpu_refs(torch, net, files)
    golden, recorded = cpu["golden"], cpu["direction"]
    env = {"STYLEMC_CLIP_BPE": files["bpe"]}
    d = os.path.dirname(files["e4e"])

    report = os.path.join(d, "verify_report.json")
    card_golden = os.path.join(d, "golden_card.npz")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RUNNER, "stylemc_torch", "verify",
         "--network", net, "--tf_network", tf_pkl, "--e4e", files["e4e"],
         "--clip_dir", files["clip_dir"], "--arcface", files["arcface"],
         "--inception", files["inception"], "--deeplab", deeplab_ckpt,
         "--mobilenet", landmark_files[1], "--seeds", VERIFY_SEEDS,
         "--fid_samples", str(VERIFY_FID_SAMPLES),
         "--golden_renders", golden, "--write_golden_renders", card_golden,
         "--torch_direction", recorded, "--report", report,
         "--device", "cuda"], cwd=ROOT, timeout=600, capture_output=True,
        text=True, env={**os.environ, **env})
    verify_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"verify exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    launches = json.loads(lines[-1])
    with open(report) as f:
        rep = json.load(f)
    checks = rep["checks"]
    steps = checks["direction_vs_torch"]["details"]["steps"]
    # FFHQ-256 synthesis calls (6 upper blocks): the generator check, the
    # FID split's two batches, find_direction's precompute and its steps;
    # the TF network's one call at 1024 (8); one backward pass a step
    calls256 = 1 + 2 * -(-VERIFY_FID_SAMPLES // 16) + 1 + steps
    want = {"upsample2x": 6 * calls256 + 8, "downsample2x": 6 * steps,
            **{k: 0 for k in MODCONV_KERNELS}}
    paths["verify"] = {"launches": launches,
                       "synthesis_calls": calls256 + 1,
                       "backward_calls": steps, "upper_blocks": "6 and 8"}

    # the TF32 control: the golden renders and the direction check again
    tf32_golden = os.path.join(d, "golden_tf32.npz")
    t0 = time.perf_counter()
    os.environ.update(env)
    try:
        ctl = _verify_tf32_control(torch, [
            "--network", net, "--clip_dir", files["clip_dir"],
            "--arcface", files["arcface"], "--seeds", VERIFY_SEEDS,
            "--golden_renders", golden, "--write_golden_renders",
            tf32_golden, "--torch_direction", recorded, "--report",
            os.path.join(d, "verify_tf32_report.json"), "--device", "cuda"])
    finally:
        for k in env:
            os.environ.pop(k)
    tf32_s = time.perf_counter() - t0
    cpu_u8 = np.load(golden)["images"]
    card_max, card_share = _u8_parity(np.load(card_golden)["images"], cpu_u8)
    tf32_max, tf32_share = _u8_parity(np.load(tf32_golden)["images"], cpu_u8)
    gates = {}
    _gate("verify_golden_off_by_one_share", card_share, tf32_share,
          VERIFY_RENDER_OFF_SHARE, gates)
    direction = checks["direction_vs_torch"]["details"]
    tf32_direction = ctl["checks"]["direction_vs_torch"]["details"]
    _gate("verify_direction_one_minus_cosine",
          1 - direction["cosine_mean"], 1 - tf32_direction["cosine_mean"],
          VERIFY_DIRECTION_GATE, gates)
    gate = {"exit_code": proc.returncode == 0, "all_ok": rep["all_ok"],
            "every_check": sorted(checks) == sorted([
                "generator", "tf_generator", "golden_renders", "clip",
                "arcface", "e4e", "inception", "fid_sanity", "deeplab",
                "mobilenet_landmarks", "direction_vs_torch"]),
            "psnr": checks["golden_renders"]["details"]["psnr_db"] >= 30.0,
            "cosine": direction["cosine_mean"] >= 0.99,
            "golden_max_abs": card_max <= 1,
            "launches": launches == want}
    emit({"phase": "verify", "card": smi, "seeds": VERIFY_SEEDS,
          "fid_samples": VERIFY_FID_SAMPLES, "cpu_golden_s": cpu["golden_s"],
          "cpu_direction_s": cpu["direction_s"],
          "cpu_direction_steps": cpu["direction_steps"],
          "verify_s": verify_s, "tf32_control_s": tf32_s,
          "check_seconds": {k: v["seconds"] for k, v in checks.items()},
          "details": {k: v.get("details", v.get("error"))
                      for k, v in checks.items()},
          "golden_parity": {"max_abs": card_max, "off_by_one": card_share,
                            "tf32_max_abs": tf32_max,
                            "tf32_off_by_one": tf32_share,
                            "tf32_psnr_db": ctl["checks"]["golden_renders"][
                                "details"]["psnr_db"]},
          "tf32_direction": tf32_direction, "gates": gates,
          "launches": launches, "launches_want": want, "checks": gate})
    if not all(gate.values()):
        raise AssertionError(f"verify checks failed: {gate}\n"
                             f"{proc.stdout[-3000:]}")


def phase_clis_misc(torch, net, verify_files, direction, tmp, smi, paths):
    """clip_filter on the card over 16 rendered PNGs (full-width ViT-B/32
    from the verify phase's CLIP dir) against the same CLI on the CPU;
    compare_directions and the CLI listing through python -m
    stylemc_torch."""
    import numpy as np
    from PIL import Image

    from stylemc_torch.__main__ import CLIS
    from stylemc_torch.__main__ import main as stylemc_main
    from stylemc_torch.cli import clip_filter as clip_filter_cli
    from stylemc_torch.edit import to_u8_nhwc
    from stylemc_torch.io import load_generator
    from stylemc_torch.models.stylegan2.generator import synthesis

    cfg, params = load_generator(net, device="cuda")
    styles = seed_styles(torch, params, cfg, range(CLIP_FILTER_IMAGES),
                         "cuda")

    def render():
        with torch.inference_mode():
            return to_u8_nhwc(synthesis(params, cfg, styles)).cpu().numpy()

    imgs, launches = count_launches(render)
    record_launches(paths, cfg, "clip_filter_renders", launches, 1)
    d = os.path.join(tmp, "clip_filter")
    os.makedirs(os.path.join(d, "images"))
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(os.path.join(d, "images", f"{i:03d}.png"))
    s_input = os.path.join(d, "styles.npz")
    np.savez(s_input, s=styles.cpu().numpy())
    env = {"STYLEMC_CLIP_DIR": verify_files["clip_dir"],
           "STYLEMC_CLIP_BPE": verify_files["bpe"]}
    outs = {device: os.path.join(d, f"kept_{device}.npz")
            for device in ("cuda", "cpu")}

    def args(device):
        return ("--images_dir", os.path.join(d, "images"), "--s_input",
                s_input, "--prompts", CLIP_FILTER_PROMPTS, "--keep_class",
                "1", "--out_file", outs[device], "--batch",
                str(CLIP_FILTER_IMAGES), "--device", device)

    os.environ.update(env)
    try:
        seconds = {device: run_cli_here(paths, cfg, f"clip_filter_{device}",
                                        clip_filter_cli, *args(device))
                   for device in ("cuda", "cpu")}
    finally:
        for k in env:
            os.environ.pop(k)
    got, want = np.load(outs["cuda"]), np.load(outs["cpu"])
    listing = io.StringIO()
    with contextlib.redirect_stdout(listing):
        stylemc_main(["stylemc_torch"])
    listing = listing.getvalue()
    other = os.path.join(d, "direction_other.npz")
    rs = np.random.RandomState(2)
    s0 = np.load(direction)["s"]
    np.savez(other, s=s0 + rs.randn(*s0.shape).astype(np.float32) * 0.01
             * (s0 != 0))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            stylemc_main(["stylemc_torch", "compare_directions", direction,
                          other])
        except SystemExit as e:
            if e.code not in (None, 0):
                raise
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    checks = {"kept_indices_equal": np.array_equal(got["indices"],
                                                   want["indices"]),
              "styles_equal": np.array_equal(got["s"], want["s"]),
              "listing": all(f"  {name} " in listing for name, _ in CLIS),
              "compare_directions": result.get("pass") is True}
    emit({"phase": "clis_misc", "card": smi,
          "clip_filter": {"images": CLIP_FILTER_IMAGES,
                          "kept": got["indices"].tolist(),
                          "card_s": seconds["cuda"],
                          "cpu_s": seconds["cpu"]},
          "compare_directions": {k: result.get(k) for k in
                                 ("min_active_cosine", "mean_active_cosine",
                                  "pass")},
          "clis_listed": len(CLIS), "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"clis_misc checks failed: {checks}\n"
                             f"{listing}{out.getvalue()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "stylemc_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(stylemc_torch/ not found)", file=sys.stderr)
        return 1

    seconds = {}

    def run(name, fn, *args):
        """fn(*args), its seconds kept and printed."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        emit({"phase_seconds": name, "seconds": seconds[name]})
        return out

    smi = run("env", phase_env, torch)
    run("build", phase_build)
    floor_ms, kernel_rows = run("kernel", phase_kernel, torch)
    run("grad", phase_grad, torch)
    # before any profiler trace, like the training phases
    modconv_rows, _ = run("modconv", phase_modconv, torch)
    mma_rate = run("mma_rate", phase_mma_rate)
    kernel_rates(modconv_rows, mma_rate)
    paths = {}  # path → its launches, synthesis calls and backward passes
    run("ab", phase_ab, torch, smi, paths)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        _, net, direction = make_network(torch, tmp)
        cfg1024, net1024 = make_ffhq1024(torch, tmp, MAPPER_NET_SEEDS[0])
        # the training paths first: their timed runs come before any
        # profiler trace
        e4e_models, e4e_train_photos = run(
            "e4e_train", phase_e4e_train, torch, net1024, tmp, smi, paths)
        editor, models = run("train", phase_train, torch, net, smi, paths)
        run("e4e_train_breakdown", phase_e4e_train_breakdown, torch,
            e4e_models, e4e_train_photos, smi)
        run("e4e_train_parity", phase_e4e_train_parity, torch, e4e_models,
            e4e_train_photos, smi, paths)
        run("dp_coach", phase_dp_coach, torch, e4e_models, e4e_train_photos,
            smi, paths)
        del e4e_models
        torch.cuda.empty_cache()
        run("train_parity", phase_train_parity, torch, net, editor,
            direction, models, paths)
        run("nada", phase_nada, torch, net, editor, models, smi, paths)
        # prompt sweeps and the landmarks stack, on the train phase's
        # models and seeds
        styles = editor.styles_from_seeds(list(range(TRAIN_SEEDS)))
        run("sweep", phase_sweep, torch, models, styles, direction, smi,
            paths)
        # data parallelism on the same models and seeds
        run("dp_train", phase_dp_train, torch, models, styles, direction,
            smi, paths)
        run("dp_sweep", phase_dp_sweep, torch, models, styles, direction,
            smi, paths)
        run("dp_ranks", phase_dp_ranks, torch, models, styles, net,
            direction, tmp, smi, paths)
        landmark_files = make_landmark_weights(torch, tmp)
        landmarker = run("landmarks", phase_landmarks, torch, models, styles,
                         landmark_files, smi, paths)
        run("landmarks_parity", phase_landmarks_parity, torch, net, models,
            styles, direction, landmarker, landmark_files, paths)
        run("landmarks_metric", phase_landmarks_metric, torch, net, models,
            styles, direction, landmarker, landmark_files, paths)
        run("sweep_clis", phase_sweep_clis, models[0], net, styles, tmp,
            landmark_files, paths)
        # the latent mapper and the DeepLab face parser, on the train
        # phase's perception models
        _, net1024b = make_ffhq1024(torch, tmp, MAPPER_NET_SEEDS[1])
        _, mapper_styles = run("mapper", phase_mapper, torch, models,
                               net1024, smi, paths)
        run("mapper_parity", phase_mapper_parity, torch, models, net1024, smi,
            paths)
        ckpt, seg = run("deeplab", phase_deeplab, torch, cfg1024, tmp, smi,
                        paths)
        run("mapper_clis", phase_mapper_clis, torch, cfg1024, net1024,
            net1024b, mapper_styles, ckpt, seg, tmp, smi, paths)
        # the TF pickle, the small CLIs and the verify harness, on verify's
        # seeded weight files, DeepLab's checkpoint and the landmark files
        verify_files = run("verify_files", phase_verify_files, torch, models,
                           net, tmp)
        tf_pkl = run("tf_legacy", phase_tf_legacy, torch, tmp, smi, paths)
        run("clis_misc", phase_clis_misc, torch, net, verify_files,
            direction, tmp, smi, paths)
        run("verify", phase_verify, torch, net, tf_pkl, ckpt,
            landmark_files, verify_files, smi, paths)
        del editor, models, landmarker, styles, mapper_styles, seg
        torch.cuda.empty_cache()
        editor = run("serve", phase_serve, torch, net, direction, smi, paths)
        run("parity", phase_parity, editor, net, direction, paths)
        run("clis", phase_clis, editor, net, direction, tmp, paths)
        del editor
        torch.cuda.empty_cache()
        run("dp_serve", phase_dp_serve, torch, net, direction, smi, paths)
        torch.cuda.empty_cache()
        run("warp", phase_warp, tmp, landmark_files, paths)
        run("metrics", phase_metrics, torch, net, tmp, smi, paths)
        run("dp_metrics", phase_dp_metrics, torch, net, smi, paths)
        torch.cuda.empty_cache()
        run("mapper_serve", phase_mapper_serve, torch, net, direction, tmp,
            smi, paths)
        torch.cuda.empty_cache()
        ckpt, photos = run("e4e", phase_e4e, torch, tmp, smi, paths,
                           landmark_files)
        run("lec", phase_lec, torch, ckpt, photos, paths)
        run("e4e_train_clis", phase_e4e_train_clis, cfg1024, net1024, photos,
            os.path.join(tmp, "e4e_inversion", "inversions"), tmp, paths)
    dp = [k for k in seconds if k.startswith("dp_")]
    emit({"phase_seconds_all": seconds, "total_s": sum(seconds.values()),
          "dp_phases_s": sum(seconds[k] for k in dp)})

    timed = {"upsample2x": CHAIN_SHAPES, "downsample2x": TRAIN_DOWN_SHAPES}
    sources = {"upsample2x": ("upfirdn2d_pallas.py:132", "_upsample2x_core"),
               "downsample2x": ("upfirdn2d_pallas.py:229",
                                "_downsample2x_core")}
    times_are = {
        "upsample2x": "sum over the six ToRGB chain shapes at batch 16 (one "
                      "batch-16 FFHQ-256 synthesis call)",
        "downsample2x": "sum over the six backward shapes [4,3,2h,2h] of "
                        "one batch-4 training step"}
    kernels = []
    for name in UPFIRDN_KERNELS:
        rows = kernel_rows[name]
        main_rows = [r for r in rows if tuple(r["shape"]) in timed[name]]

        def total(key):
            return sum(r[key] for r in main_rows)

        line, function = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"stylemc_torch/ops/kernels/csrc/{name}.cu",
            "replaces": f"stylemc_tpu/ops/pallas/{line}",
            "replaces_function": function,
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {k: v["launches"][name]
                                 for k, v in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("kernel_ms"), "kernel_ms": total("kernel_ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_us": total("bound_ms") * 1e3,
            "bound_by": main_rows[0]["bound_by"],
            "launch_floor_ms": floor_ms,
            # the floor times the launches one call makes (one per shape)
            "launch_floor_per_call_ms": floor_ms * len(main_rows),
            "launches_within_aim": sum(r["within_aim"] for r in main_rows),
            "library_ms": total("library_ms"),
            "wrapper_event_ms": total("wrapper_event_ms"),
            "times_are": times_are[name] + "; *_ms device time (CUDA events "
                         "around calls queued behind a sleep kernel); "
                         "wrapper_event_ms CUDA events over back-to-back "
                         "wrapper calls (host cost included)",
            "card": smi})
        if name == "upsample2x":
            # one batch-16 FFHQ-1024 synthesis call: the e4e decoder's
            e4e = [r for r in rows if tuple(r["shape"]) in
                   CHAIN_SHAPES + E4E_CHAIN_EXTRA]
            kernels[-1].update({f"ffhq1024_b16_{k}": sum(r[k] for r in e4e)
                                for k in ("kernel_ms", "plain_ms",
                                          "bound_ms", "library_ms")})
        # one mapper step (batch 2, 512 px): its synthesis call for B1, its
        # backward pass for B2
        step = MAPPER_UP_SHAPES if name == "upsample2x" else \
            MAPPER_DOWN_SHAPES
        step_rows = [r for r in rows if tuple(r["shape"]) in step]
        kernels[-1].update({f"mapper_b2_{k}": sum(r[k] for r in step_rows)
                            for k in ("kernel_ms", "plain_ms", "bound_ms",
                                      "library_ms")})
        # one e4e coach step (batch 4, FFHQ-1024): its decode for B1, its
        # backward to the codes for B2
        step = LEC_UP_SHAPES if name == "upsample2x" else E4E_DOWN_SHAPES
        step_rows = [r for r in rows if tuple(r["shape"]) in step]
        kernels[-1].update({f"e4e_train_b4_{k}": sum(r[k] for r in step_rows)
                            for k in ("kernel_ms", "plain_ms", "bound_ms",
                                      "library_ms")})
        if name == "upsample2x":
            # one LEC decode (batch 4, FFHQ-1024) and the NADA step's
            # synthesis call (batch 4, FFHQ-256)
            for tag, shapes in (("lec_b4", LEC_UP_SHAPES),
                                ("nada_b4", NADA_UP_SHAPES)):
                sub = [r for r in rows if tuple(r["shape"]) in shapes]
                kernels[-1].update({f"{tag}_{k}": sum(r[k] for r in sub)
                                    for k in ("kernel_ms", "plain_ms",
                                              "bound_ms", "library_ms")})
    kernels += modconv_entries(modconv_rows, paths, smi, mma_rate)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
