#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of HM-ViT.

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases:

1. require CUDA; print the card's name and power limit; build the CUDA
   kernels from ``hmvit_tpu_torch/csrc`` (nvcc, sm_90a, one process per
   source) and time it;
2. check every kernel against its plain PyTorch twin on the card at the
   production shapes, in float32 (tight) and bfloat16 (stated
   tolerance); the tile pair warp must also equal its previous body, the
   resident pair warp the tile pair warp, and the fused warp + attention
   kernel the pair warp followed by the stripe attention kernel, bit for
   bit, in both types (also with 5 senders), on the serving poses, the
   ego launch, spread poses (agents within +-120 m, a quarter of the
   tiles out of view: the ROI tile skip; the count is printed) and the
   draw on which the Pallas kernels' skip is not conservative
   (``draw_222``); the pair warp, stripe and plain attention also at the
   shapes of phase 8's run-both training step (a fleet of 5 slots: every
   pair, the ego launch, and the camera self-attention over 5 slots), so
   that their tensor-core bodies are held at the shapes the bfloat16 train
   step launches them with.  The four attention kernels (stripe, plain, typed,
   fused warp + attention) must run their tensor-core body in bfloat16
   and their fp32 CUDA-core body in float32 (counted inside the
   library).  In bfloat16 it times
   the kernel launch alone, the whole wrapper and the twin (CUDA events,
   median of 20 after warm-up), for the four attention kernels also
   their previous fp32 body on the same operands through its
   timing-only entry, in turns (previous, new, new, previous:
   ``previous_ms``; for both pair warps the tile kernel's previous body,
   with its ``device_ms`` beside theirs), and, for the attention
   kernels, the one
   library call that computes the same attention
   (``scaled_dot_product_attention`` over window-split heads with the
   additive bias + mask, keys concatenated over senders) — a yardstick
   only, the port never calls it — and works out each kernel's bound:
   the larger of its bytes over the card's memory rate and its
   operations over the card's peak rate.  The three lidar kernels
   (one-pass segmented max-scan, dense expansion v1 and v2) are held to
   their plain versions bit for bit, in float32 and bfloat16, on the
   pillar ids and PFN rows of the production batch (also at C = 12), on
   a synthetic 40 000-row case and on repeated ids; the scan also on
   dense clouds and on long runs (65 536 rows, runs up to 4096, steps
   12: the kernel's second launch), and against its previous body, with
   which it is timed in turns (``previous_ms``, ``previous_device_ms``;
   the dense and long-run cases' times under ``dense_`` and
   ``long_run_``); the expansions' library call is ``torch.zeros`` +
   ``index_copy_`` (the scan has none), and each
   expansion kernel's time is printed over it as a ratio.  These
   kernels run for less time than their host launch takes, so for them
   and their library call the script also reads the device time alone
   (``device_ms``: 20 calls captured in a CUDA graph and replayed) as
   extra keys; ``ms`` and ``library_ms`` stay one call each;
3. build the production forward: ``hmvit_tpu_torch.serving.PROD_CFG``
   (4-agent mixed fleet, 4 x 512^2 cameras per camera agent, 512^2
   pillar grid, 128^2 x 256 BEV, 2 H3GAT iterations) and its request
   batch, with the serving hints, weights drawn from a seeded
   ``torch.Generator``, in four variants: the split server (pair warp,
   then stripe attention), the ``use_fused_wa`` server (local phases in
   the fused kernel), and the ``expand_v1`` / ``expand_v2`` servers
   (split, with the lidar encoder's dense grid built by an expansion
   kernel);
4. run each in float32 with the kernels and with ``plain_ops()``, and
   compare sigmoid(psm) and rm; every variant's kernel forward must
   equal the split server's bit for bit;
5. answer 3 bfloat16 requests (batch seeds 0-2) through each server:
   forward, anchor decode and rotated NMS; every output must be finite,
   the split server's sigmoid(psm) and rm must agree with the same
   server under ``plain_ops()`` (``BF16_FORWARD_ATOL``) and with the
   fp32 split forward of phase 4 on the same weights and request
   (``BF16_VS_FP32_ATOL``, on sigmoid(psm), its logits and rm: the
   comparison the north star's bar makes, at a tolerance taken from the
   card's reading), the
   ``use_fused_wa`` server's psm and rm must equal the split server's
   bit for bit, every attention launch must have run on the tensor
   cores, and the launch counts must show each server's kernels and none
   of another's (the fused server: 2 fused launches per request and no
   stripe launch; an expand server: 1 launch of its expansion kernel);
   then time 20 more requests per server in blocks of 10, the servers
   taking turns in mirrored order, and print the median and spread of
   ms/frame of each;
6. capture each server's forward and decode + NMS in CUDA graphs
   (``hmvit_tpu_torch.graph_server.CompiledServer``), replay requests
   0-2 and hold psm, rm and the decoded boxes bit for bit to phase 5's
   eager outputs; the launches counted at capture and, under
   ``torch.profiler``, the hand-written kernels of one replay (by their
   ``csrc`` names) must be each server's per-request counts; time 20
   graph frames per server in turns with 20 eager ones (eager, graph,
   graph, eager, in blocks of 10) and print median, min and max
   ms/frame beside phase 5's; then run ``python -m
   hmvit_tpu_torch.bench`` (split, ``--fused_wa``, ``--expand v1``,
   ``--expand v2``), print its JSON line, and roll the split and
   ``--fused_wa`` runs' traces up by class
   (``hmvit_tpu_torch.tools.profile``);
7. run the typed-attention (float32 and bfloat16), resident-warp,
   segmented-scan, expansion and lidar stages of
   ``hmvit_tpu_torch.perf_lab`` — the entry point that reaches the typed,
   resident and scan kernels — and count their launches, those of the
   typed kernel's tensor-core body apart;
8. train on the card: the training configuration of ``bench.py
   --train`` (``dict(PROD_CFG, remat=True)``: the same fleet and widths,
   the run-both trace, ``drop_out`` 0) on request 0 with its anchor
   labels, through ``hmvit_tpu_torch.train.trainer.make_train_step``, each
   run from one cloned state: (a) one float32 step (``half=False``, the
   fusion's ``compute_dtype`` float32 too, as phase 4's float32 forward
   has it) with the kernels and one under ``plain_ops()`` (TF32 off):
   loss within ``TRAIN_TOL`` relative, each parameter's gradient within
   ``TRAIN_TOL`` of its largest |value|; then the production step in
   bfloat16 (``half=True``, the fusion in bfloat16): its loss within
   ``TRAIN_BF16_LOSS_TOL`` of the plain bf16 step's, and its loss and
   every gradient against the float32 plain step within
   ``BF16_GRAD_SPREAD`` times the plain bf16 step's own distance from it
   plus ``BF16_GRAD_FLOOR`` of scale; every attention launch on the
   CUDA-core body in float32 and on the tensor-core body in bfloat16;
   (b) the pair warp, stripe and plain attention launches of one step
   equal to ``train_launches`` (forward launches times one plus the
   remat recompute), each > 0; (c) remat off vs on (float32):
   within (a)'s tolerance, ``max_memory_allocated`` of both printed; (d)
   five bfloat16 AdamW steps on the one batch: the loss finite and
   falling; (e) ``python -m hmvit_tpu_torch.bench --train``, ``--train
   --no_remat`` and ``--train --bucketed``, each JSON line printed with
   the card's name and power limit, the first traced and rolled up by
   ``hmvit_tpu_torch.tools.profile`` (by class, and the plain twins'
   backward by kernel: ``--ranges twin_backward:``);
9. the accuracy gate's path (``hmvit_tpu_torch.prod_overfit``) at
   production shapes: (a) write the mini-OPV2V fixture (1 scenario, 4
   CAVs, 2 frames, 512^2 images, 16 384 points, vehicles 8 m apart in
   +-30 m), load it through the port's dataset (seed 0, no PyYAML /
   OpenCV), collate and label each frame, and print the loader's host ms
   a frame (median); (b) the oracle decode: each frame's labels as its
   outputs (a high logit on the positive anchors, the regression targets
   as ``rm``) through ``post_process`` and the VOC evaluation must score
   AP 1.0 at 0.3, 0.5 and 0.7; (c) 20 bfloat16 AdamW steps with remat of
   the gate's configuration (``gate_config(512)``: ``PROD_CFG`` with remat
   on every stage) on the two frames: the loss finite, the mean of its
   last 5 under that of its first 5, and the pair warp, stripe and plain
   launches of every step equal to ``train_launches``; (d) the gate's
   eval forward (eval mode, no serving hints, the configuration's bf16
   fusion) on both frames, then ``post_process`` and AP: the AP (not
   held: 20 steps do not train the model), the ms a frame and the
   launches (those of a forward without remat, a frame) printed;
10. the run-directory path, through the tools a user calls: (a) ``python
   -m hmvit_tpu_torch.tools.train`` on
   ``hmvit_tpu_torch/config/hypes/hmvit_prod_serving.yaml`` (production
   width, nothing cut) with ``--synthetic --half --remat --epoches 1
   --steps_per_epoch 10`` into a temporary run directory: every loss
   finite, ``config.yaml`` and the epoch's checkpoint written, and the
   pair warp, stripe and plain launches of every step equal to
   ``train_launches``; the steps/s after the first printed; (b) ``python
   -m hmvit_tpu_torch.tools.inference`` on that run directory with
   ``--synthetic --synthetic_frames 8 --bf16 --serving_buckets
   --max_frames 8`` (a captured CUDA graph per fleet bucket): AP@0.3 /
   0.5 / 0.7 (not held: 10 steps do not train), the end-to-end fps, p50
   and p95, each bucket's capture seconds and the launches its graph
   holds (held to a serving frame's: ``serving_launches``) printed; then
   one frame served by a captured graph and by the eager bf16 forward of
   the same model: psm, rm and the decoded boxes equal bit for bit; (c)
   ``tools.train`` on ``smoke_hetero_tiny.yaml`` for 2 steps, float32,
   so that the cross-view transformer camera encoder runs on the card:
   the losses finite and the launches of each step ``train_launches``;
11. every camera encoder of the zoo under HM-ViT: (a) ``tools.train`` on
   ``hmvit_fax_point_pillar_hetero.yaml`` (FAX) and
   ``bevformer_point_pillar_hetero.yaml`` (the planar BEVFormer on the
   plain conv trunk, with the upsampling decoder), published widths,
   ``--half``, 10 steps each: losses finite, every step's launches
   ``train_launches`` (the BEVFormer's camera layers one plain launch
   each, FAX none); (b) ``tools.inference --bf16 --serving_buckets`` on
   each run directory, as phase 10 (b): fps, p50 / p95, each bucket's
   launches, one frame graph == eager bit for bit; (c) HMViT of
   ``smoke_hetero_tiny.yaml`` with each camera configuration of
   ``ZOO_CAMERAS`` (FAX, VPN, VPN-MS, BEVSwap, the planar BEVFormer on
   the plain trunk, the deformable lift, the CVT on ResNet-18 / 34 and
   VoVNet-19 / 39, ``compression: 2``, and the reference twins
   ``fax_ref``, ``cvt_ref`` and ``bevformer_ref``), float32: the kernels'
   forward against ``plain_ops()`` (which launches nothing) within
   ``FORWARD_ATOL``, the launches a served frame's, and the forward
   captured in a CUDA graph (``CompiledServer``) equal to the eager one
   bit for bit; the twins' plain forward also against the same model's
   CPU forward within ``SEG_LIDAR_ATOL`` of scale; (d) the deformable
   lift at the BEVFormer configuration's widths (``lift: deformable``):
   2 ``tools.train`` steps, ``--half``, losses finite, peak device
   memory printed; (e) the space-to-depth
   stem against the plain stem on the same weights, float32, within
   ``S2D_TOL`` where the JAX package sets that bar (ResNet-18 stage 1,
   2 x 64^2) and on the stem's own output at 4 x 512^2, the ResNet-50
   stage-1 output at 512^2 printed beside a float64 forward (not held);
   then ``python -m hmvit_tpu_torch.bench`` and ``--stem_s2d``, both
   frames/s printed.  The phase prints its length;
12. the fusion zoo: (a) HMViT of ``smoke_hetero_tiny.yaml`` with each
   fusion of ``ZOO_FUSIONS`` as its ``fusion_override`` (F-Cooper,
   attention, DiscoNet, V2VNet, SwapFusion, V2X-ViT with the batch's
   prior encoding), float32, held as phase 11 (c) holds each camera
   encoder: kernels vs ``plain_ops()`` within ``FORWARD_ATOL``, the
   launches a served frame's (``fusion_launches``: V2X-ViT one plain
   launch a pyramid window, the others none), graph == eager bit for
   bit; (b) K3 at V2X-ViT's shapes (``V2XVIT_MAP``: the
   ``point_pillar_v2xt`` map, 5 agents of 128^2 x 256, 8 heads of 32,
   one sender) at windows 4, 8 and 16 (T = 16, 64, 256), float32 and
   bfloat16 against its twin at phase 2's tolerances, each launch's
   body, ``ms``, plain twin, bound and ``library_ms`` printed; (c)
   ``tools.train --half`` at published widths (``FUSION_ZOO_TRAIN``: 10
   steps on ``point_pillar_v2xt.yaml`` and
   ``opcl/fax_point_pillar_v2xt.yaml``, 2 on the F-Cooper, attention,
   V2VNet and SwapFusion FAX configurations, the BEVFormer DiscoNet one
   and ``v2xt/point_pillar_intermediate.yaml``): losses finite, every
   step's launches ``model_launches``, steps/s and peak device memory
   printed; ``tools.inference --bf16 --serving_buckets`` on the two
   V2X-ViT run directories (HMViT through captured graphs as phase 10
   (b), graph == eager bit for bit; the ``CooperativeDetector`` through
   its plain forward: no graph, 3 plain launches a frame); and
   ``tools.inference --fusion_method late`` on
   ``opcl/lidar_point_pillar_late_fusion.yaml`` (single-agent
   PointPillars, 2 frames, no kernel launch).  Every plain launch of the
   phase is counted by (tokens T, operand type) and by body; the kernels
   line gains ``fusion_zoo_launches`` and one record per V2X-ViT window
   (its launches at that T over the phase, the bfloat16 timing, and the
   float32 one under ``float32``).  The phase prints its length;
13. the segmentation assemblies and the lidar zoo, on which no kernel
   runs: (a) each assembly of ``SEG_LIDAR_ASSEMBLIES`` at smoke widths
   (``CameraSegmentor`` with CVT, FAX, VPN and BEVSwap; ``task: seg``
   under F-Cooper and SwapFusion; ``VoxelNetDetector``,
   ``SecondDetector``, ``PIXORDetector``, ``VoxelNetIntermediate``,
   ``PixorIntermediate``, ``second_intermediate``), weights from seed
   0, float32 with TF32 off on the card against the same model's CPU
   forward: every output within ``SEG_LIDAR_ATOL`` over max(1, max
   |x|), no launch of any of the nine kernels; (b) ``tools.train
   --synthetic --half`` at published widths (``SEG_LIDAR_TRAIN``, 3 steps
   each: ``opcamera/cvt.yaml`` with the map ground truth of
   ``add_data_extension``, ``opcamera/corpbevt.yaml``,
   ``opcamera/view_parse_network_v2vnet.yaml``, ``opcamera/bev_swap.yaml``,
   ``opv2v/pixor_intermediate_fusion.yaml`` at batch 1,
   ``opv2v/voxelnet_intermediate_fusion.yaml`` with its anchors at the
   stride of its outputs, ``SEG_LIDAR_ANCHOR_STRIDE``, and
   ``opv2v/second_intermediate_fusion.yaml``): losses finite, no launch,
   steps/s after the first and peak device memory printed; (c)
   ``tools.inference --bf16`` on the three lidar-zoo run directories
   (their plain forward) and ``--fusion_method late`` on
   ``opv2v/pixor_late_fusion.yaml`` (random weights): AP (not held), fps,
   p50 / p95, no launch; (d) the cvt run directory's mIoU on two fixture
   frames, ``seg_iou(seg_post_process(...))`` against the map labels
   (printed, not held).  The kernels line gains ``seg_lidar_zoo_launches``
   (all 0); the phase prints its length;
14. a reference checkpoint converted and served at full width
   (``opcl/bevformer_point_pillar_hetero.yaml`` with ``camera.encoder:
   bevformer_ref``: the BEVFormer twin at 128^2 x 256, 3 layers, on
   ResNet-50 C5 over 4 x 512^2 images a camera agent; the 512^2 pillar
   grid; H3GAT on the split route; 5 agent slots): (a) the port's
   ``export_flagship`` of a seeded model as a reference run's
   ``net_epoch3.pth`` -> ``python -m
   hmvit_tpu_torch.tools.convert_checkpoint --from_reference ...
   --core_method bevformer_point_pillar_hetero --hypes ... --output
   <run>/ckpt``: the restored state_dict equal to the exported model's
   bit for bit, and convert -> export -> convert bit for bit (decoder
   conv biases non-zero); (b) ``tools.inference --bf16
   --serving_buckets`` on the run directory, as phase 10 (b): fps, p50 /
   p95, each bucket's launches a frame held (K1 4, K2 2, K3 2 and every
   other kernel 0), each stage's output type on one frame and the peak
   device memory printed (the run's few frames hold the buckets'
   captures), then one bucket served ``TWIN_STEADY_FRAMES`` more times
   after its capture: the steady p50 / p95; (c) one frame graph == eager
   bit for bit, and the converted weights cut to ``TWIN_CPU_LAYERS``
   camera layers, float32 with TF32 off, card against CPU within
   ``SEG_LIDAR_ATOL`` of scale (a lidar ego and a camera agent), the
   card's pillar projections held to the CPU's (``TWIN_UV_ATOL``: the
   image coordinates, and visibilities differing only on image edges);
   (d) ``bevformer_wrapper``
   with ``bevformer_ref`` (the standalone ``RefBEVFormerDetector``) at
   the smoke widths: written in the reference's names by the port's
   exporters, converted by the CLI (bit for bit), served by
   ``tools.inference --bf16`` (AP not held, fps, no launch).  The
   kernels line gains ``reference_twin_launches`` (the rows of K3 at
   V2X-ViT's windows: the phase's launches at that T); the phase prints
   its length.

The pair warp in float32 is held to its twin at ``FP32_ATOL`` on the
serving and ego poses; on spread poses (the phase 2 case and
``SPREAD_DRAWS`` further draws, each from its own generator) to a
per-element bound derived from the float32 rounding of the sample
coordinates (``WARP_COORD_ULPS``, ``warp_fp32_bound``).

The script imports torch, numpy, the standard library and
``hmvit_tpu_torch``: nothing of jax, of the JAX package ``hmvit_tpu`` or
of ``bench.py`` (the port keeps its own copies of the batch generator,
the anchor grid and the production configuration).

The lines before the last are the per-kernel JSON record and the card's
name and power limit; the last line is ``{"ok": true, "device": ...}``.
Any failure raises (non-zero exit, no result line).
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

# kernel vs plain twin on unit-normal inputs at the production shapes.
# float32: the same arithmetic in another summation order.
FP32_ATOL = 1e-4
# The pair warp in float32 on spread poses (agents up to +-120 m apart)
# is held per element to a bound derived from the sample coordinates'
# rounding, FP32_ATOL plus it (``warp_fp32_bound``), not to FP32_ATOL
# alone.  Each output element is a linear interpolation, per pass, of
# neighbouring taps at a float32 coordinate: pass 1 (rows) at
# v1 y' + v0 c + ty_adj on each column tap c, pass 2 (columns) at
# m00 x' + m01 y' + tx.  The kernel reads the twin's coefficient rows
# (bit-equal on the card), but copies an identity pair (flag 1: a row
# within 1e-4 of the identity), while the twin interpolates it at the
# coordinates its row gives: the pose chain inv(M_i) M_i rounds in
# float32 at the agent's translation (about 1.5e-5 pixels at 120 m, 2e-5
# of a tap there), so the twin samples a hair off the pixel centre.  Each
# side evaluates a coordinate in float32 within an ulp of its terms'
# magnitude.  Moving a coordinate by d moves a linear interpolation by d
# times the difference of the two taps it weights, and pass 1's error
# passes through pass 2's weights (which sum to at most 1); so per
# element
#   |kernel - twin| <= FP32_ATOL + (dC + dR
#                      + WARP_COORD_ULPS * ulp(M)) * (D1 + D2),
# with dC, dR the distances between the kernel's and the twin's column
# and row coordinates (the pixel's own for a copied pair; the row one at
# both column taps), M the largest sum of the terms' magnitudes (|m00 x'|
# + |m01 y'| + |tx|, |v1 y'| + |v0 c| + |ty_adj| + 2 |v0 tx|), D1 the
# largest difference of row-neighbouring source taps on the column taps
# the element reads and D2 that of the column-neighbouring pass-1 values,
# each one tap wider on both sides (a coordinate near an integer may
# floor to either side).  So a reading near 1e-4 on a diagonal pair is
# this rounding, not a fault (one draw read 1.054e-4 against FP32_ATOL
# alone, another 1.373e-4 where a copied pixel's taps differ by 7); a
# wrong tap moves an element by a whole tap difference (order 1) and
# fails.  The serving and ego poses (within 20 m) keep FP32_ATOL alone.
WARP_COORD_ULPS = 2.0
# spread-pose draws, each from its own generator, held to that bound
SPREAD_DRAWS = 20
# bfloat16: both sides compute in float32 from the same bf16 inputs and
# round the output once; the warp's hat weights are rounded to bf16 at
# slightly different points (fp32 hat vs bf16 1 - frac), so a few
# output ulps (bf16 ulp = 1/64 at |x| in [2, 4)) may differ.  The fused
# kernel attends over K/V that carry those ulps: V's pass through the
# weighted sum and K's shift the scores and so the weights, hence twice
# the warp's bound (its tight checks are float32 and the bit-for-bit
# equality with the split kernels).
BF16_ATOL = {"pair_warp": 0.0625, "pair_warp_resident": 0.0625,
             "stripe_window_attention": 0.0313,
             "plain_window_attention": 0.0313,
             "typed_window_attention": 0.0313,
             "warp_window_attention": 0.125}
# full float32 forward, kernels vs plain twins: kernel rounding noise
# (~1e-6 relative) carried through the decoder
FORWARD_ATOL = 2e-3
# full bfloat16 forward of the split server, kernels vs plain twins, on
# sigmoid(psm) and on rm over max(1, max|rm|): the kernels differ from
# their twins by output ulps (the bounds above), and two H3GAT iterations
# and the decoder carry those through bf16 layers (measured 3e-4 and
# 1e-3 on an H100)
BF16_FORWARD_ATOL = 0.01
# the bf16 split server against the fp32 split forward of the same
# weights and request (the north star's bar compares bf16 with fp32): on
# sigmoid(psm), on the psm logits themselves, and on rm over
# max(1, max|rm|).  Every layer rounds to bf16 here, so the spread is
# bf16's own (unit roundoff 2^-8 = 3.9e-3) carried through the model.
# The reading on an H100 80GB HBM3 (the same in every run) is 1.794e-4 on
# sigmoid(psm), 1.770e-2 on the logits and 1.274e-3 on rm.  Random weights
# put every score near the focal prior 0.01, where the sigmoid's slope is
# 0.0099, so sigmoid(psm) shrinks the logits' spread a hundredfold and
# alone would let a 4e-2 logit spread pass: the logits are held too.  The
# tolerances are 1.4x the reading on psm and its logits (above the north
# star's 1.8e-4, which the reading meets by a hair and the check does not
# hold) and 2.4x on rm.
BF16_VS_FP32_ATOL = {"psm": 2.5e-4, "logit": 2.5e-2, "rm": 3e-3}

# phase 8, a float32 train step with the kernels vs under plain_ops():
# the loss (relative) and each parameter's gradient (over its largest
# |value|), the scale of the forward check above (the kernels round
# differently from their twins; the camera trunk's forward is the same
# library code in both runs, so nothing upstream of the fusion differs)
TRAIN_TOL = 2e-3
# the production step in bfloat16 (half=True), with the kernels against
# the float32 plain step of the same weights, per parameter:
#   max|g_kern16 - g_plain32| <= BF16_GRAD_SPREAD * max|g_plain16 -
#   g_plain32| + BF16_GRAD_FLOOR * max|g_plain32|,
# and the same for the loss.  A kernel differs from its twin by at most
# an output ulp (both compute in float32 from the same bf16 operands and
# round once, BF16_ATOL above); the bf16 plain step rounds every
# activation, those outputs included, so the kernels' deviation is a part
# of bf16's own and the triangle inequality gives the factor 2.  The floor
# covers a parameter whose bf16 spread happens to be near zero.  A wrong
# kernel moves the gradients by their own scale and fails.  The kernels'
# loss is held to the bf16 plain step's too, relative (reading on an H100
# 80GB HBM3: 3.501e-4).  At this width the bar is loose: the train-mode
# trunk is ill-conditioned (ROADMAP Queue 3), and the plain bf16 step's
# gradients lie a median 1.35 of their scale from the float32 step's (the
# same reading); so the tensor-core bodies the bf16 step launches are
# also held to their twins directly at its shapes in phase 2.
TRAIN_BF16_LOSS_TOL = 1e-3
BF16_GRAD_SPREAD = 2.0
BF16_GRAD_FLOOR = 1e-2
TRAIN_STEPS = 5
# phase 9: bf16 train steps of the accuracy gate on its fixture
GATE_STEPS = 20
# phase 10: the run-directory tools on the shipped configurations
RUN_DIR_STEPS = 10
RUN_DIR_FRAMES = 8
HYPES = "hmvit_tpu_torch/config/hypes"
# phase 11: every camera encoder of the zoo under HM-ViT
ZOO_HYPES = ("hmvit_fax_point_pillar_hetero.yaml",
             "bevformer_point_pillar_hetero.yaml")
ZOO_TRAIN_STEPS = 10
DEFORMABLE_STEPS = 2
# the space-to-depth stem against the plain stem: the JAX package's own
# bar (tests/test_resnet.py), atol = rtol
S2D_TOL = 2e-5
# camera-block keys (and model keys) over smoke_hetero_tiny.yaml's HMViT
# (its camera: dim 32, a 4^2 BEV upsampled twice to the 16^2 lidar map,
# 4 cameras of 64^2)
ZOO_CAMERAS = {
    "fax": ({"encoder": "fax", "bev_window": 4, "heads": 2,
             "dim_head": 16}, {}),
    "vpn": ({"encoder": "vpn", "img_size": 64}, {}),
    "vpn_ms": ({"encoder": "vpn_ms", "img_size": 64}, {}),
    "bev_swap": ({"encoder": "bev_swap", "window": 4, "num_cams": 4}, {}),
    "bevformer_planar_plain_trunk": ({"encoder": "bevformer", "heads": 2,
                                      "window": 4, "num_layers": 2,
                                      "num_cams": 4}, {}),
    "bevformer_deformable": ({"encoder": "bevformer", "lift": "deformable",
                              "heads": 2, "num_layers": 2}, {}),
    "cvt_resnet18": ({"backbone": "resnet18", "id_pick": [3]}, {}),
    "cvt_resnet34": ({"backbone": "resnet34", "id_pick": [3]}, {}),
    "cvt_vovnet19": ({"backbone": "vovnet-19", "id_pick": [3]}, {}),
    "cvt_vovnet39": ({"backbone": "vovnet-39", "id_pick": [3]}, {}),
    "cvt_compression_2": ({}, {"compression": 2}),
    # the reference twins (the camera blocks a converted reference
    # checkpoint fills); each also against its own CPU forward
    "fax_ref": ({"encoder": "fax_ref", "heads": 2, "dim_head": 16,
                 "middle": [1, 1]}, {}),
    "cvt_ref": ({"encoder": "cvt_ref", "heads": 2, "dim_head": 16,
                 "middle": [1, 1]}, {}),
    "bevformer_ref": ({"encoder": "bevformer_ref", "backbone": "resnet18",
                       "dim": 64, "bev_h": 16, "num_layers": 2,
                       "ffn_dim": 128, "fpn_channels": 64,
                       "pc_range": [-20.48, -20.48, -3.0, 20.48, 20.48, 1.0],
                       "num_cams": 4}, {}),
}
# the camera configurations of ZOO_CAMERAS held card vs CPU as well
# (float32, TF32 off, within SEG_LIDAR_ATOL of scale)
ZOO_TWINS = ("fax_ref", "cvt_ref", "bevformer_ref")

# phase 12: the fusion zoo.  Every fusion of models/fusion under the
# smoke HMViT (fusion_override), float32
ZOO_FUSIONS = ("fcooper", "att", "disconet", "v2vnet", "swap", "v2xvit")
# V2X-ViT's pyramid windows (make_fusion's), one plain launch each a
# forward: T = 16, 64 and 256 tokens
V2XVIT_WINDOWS = (4, 8, 16)
# K3 at the point_pillar_v2xt map: agents, map side, channels, heads,
# head dim
V2XVIT_MAP = (5, 128, 256, 8, 32)
# the published-width runs of tools.train --half: (hypes, steps)
FUSION_ZOO_TRAIN = (("point_pillar_v2xt.yaml", 10),
                    ("opcl/fax_point_pillar_v2xt.yaml", 10),
                    ("opcl/fax_point_pillar_fcooper.yaml", 2),
                    ("opcl/fax_point_pillar_att_fuse.yaml", 2),
                    ("opcl/fax_point_pillar_v2vnet.yaml", 2),
                    ("opcl/fax_point_pillar_fax.yaml", 2),
                    ("opcl/bevformer_point_pillar_disconet.yaml", 2),
                    ("v2xt/point_pillar_intermediate.yaml", 2))
# single-agent PointPillars, served by late fusion
LATE_FUSION_HYPES = "opcl/lidar_point_pillar_late_fusion.yaml"
LATE_FUSION_FRAMES = 2
# phase 13: each new assembly on the card (float32, TF32 off) against the
# port's own CPU float32 forward of the same weights, over max(1, max|x|)
SEG_LIDAR_ATOL = 1e-4
# the published-width runs of tools.train --half: (hypes, steps, flags)
SEG_LIDAR_TRAIN = (("opcamera/cvt.yaml", 3, ()),
                   ("opcamera/corpbevt.yaml", 3, ()),
                   ("opcamera/view_parse_network_v2vnet.yaml", 3, ()),
                   ("opcamera/bev_swap.yaml", 3, ()),
                   # the hypes' batch of 8 (x 5 slots of a 1600 x 400
                   # raster, float32 by promotion) runs out of the card's
                   # 80 GB in the first trunk stage
                   ("opv2v/pixor_intermediate_fusion.yaml", 3,
                    ("--batch_size", "1")),
                   ("opv2v/voxelnet_intermediate_fusion.yaml", 3, ()),
                   ("opv2v/second_intermediate_fusion.yaml", 3, ()))
# VoxelNet's RPN answers at half its grid (256^2 of 512^2), but its
# corpus hypes asks for anchors at feature stride 4 (128^2): the labels
# cannot meet the outputs, in the JAX tools as in the port's.  Phase 13
# trains and serves a copy with the stride of the outputs (the model's
# widths unchanged)
SEG_LIDAR_ANCHOR_STRIDE = {"opv2v/voxelnet_intermediate_fusion.yaml": 2}
# the lidar zoo's run directories served, and PIXOR by late fusion
SEG_LIDAR_SERVED = ("opv2v/pixor_intermediate_fusion.yaml",
                    "opv2v/voxelnet_intermediate_fusion.yaml",
                    "opv2v/second_intermediate_fusion.yaml")
PIXOR_LATE_HYPES = "opv2v/pixor_late_fusion.yaml"
SEG_LIDAR_FRAMES = 4

KERNEL_META = {
    "pair_warp": ("hmvit_tpu_torch/csrc/pair_warp.cu",
                  "hmvit_tpu/ops/fused_warp.py:215"),
    "stripe_window_attention": (
        "hmvit_tpu_torch/csrc/window_attention_mma.cu",
        "hmvit_tpu/ops/window_attention.py:342"),
    "plain_window_attention": (
        "hmvit_tpu_torch/csrc/window_attention_mma.cu",
        "hmvit_tpu/ops/window_attention.py:157"),
    "warp_window_attention": ("hmvit_tpu_torch/csrc/fused_warp_attention.cu",
                              "hmvit_tpu/ops/fused_warp_attention.py:47"),
    "pair_warp_resident": ("hmvit_tpu_torch/csrc/pair_warp.cu",
                           "hmvit_tpu/ops/fused_warp.py:334"),
    "typed_window_attention": (
        "hmvit_tpu_torch/csrc/window_attention_mma.cu",
        "hmvit_tpu/ops/window_attention.py:26"),
    "segmented_max_scan": ("hmvit_tpu_torch/csrc/segscan.cu",
                           "hmvit_tpu/ops/segscan.py:28"),
    "expand_rows": ("hmvit_tpu_torch/csrc/expand.cu",
                    "hmvit_tpu/ops/expand.py:30"),
    "expand_rows_v2": ("hmvit_tpu_torch/csrc/expand.cu",
                       "hmvit_tpu/ops/expand.py:122"),
}

# kernels whose bfloat16 launches run on the tensor cores (their float32
# launches, and the shapes the tensor-core body does not take, run the
# fp32 body of hmvit_tpu_torch/csrc/attention_body.cuh)
TENSOR_CORE_KERNELS = ("stripe_window_attention", "plain_window_attention",
                       "typed_window_attention", "warp_window_attention")

# the path whose launch count each kernel's record carries
KERNEL_PATH = {"pair_warp": "split", "stripe_window_attention": "split",
               "plain_window_attention": "split",
               "warp_window_attention": "fused_wa",
               "pair_warp_resident": "perf_lab",
               "typed_window_attention": "perf_lab",
               "segmented_max_scan": "perf_lab",
               "expand_rows": "expand_v1", "expand_rows_v2": "expand_v2"}

# published peaks of one H100 SXM (dense): device memory bytes/s, and
# operations/s by input type (bf16 on the tensor cores, float32 outside)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

NUM_AGENTS = 4
# rows of the segmented scan's long-run case (runs up to 4096, steps 12)
LONG_RUN_P = 65536
TIMED_REQUESTS = 20
TIMED_BLOCK = 10


def prod_batch(seed: int):
    """The production request: 4 agents in 5 slots, alternating lidar /
    camera, 30 000 points per lidar agent, 4 x 512^2 images per camera
    agent."""
    from hmvit_tpu_torch.serving import request_batch

    return request_batch(seed, num_agents=NUM_AGENTS)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, launches: int = 20) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured back
    to back in a CUDA graph, the graph replayed between CUDA events
    (``time_ms``: median of 20 replays) and divided by ``launches``.  No
    host work lies between the events, so a call that the host takes
    longer to launch than the card takes to run reads its device time;
    ``time_ms`` of one call includes that launch."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = time_ms(graph.replay) / launches
    del graph
    return ms


def bound_ms(tensors, out, ops: float, dtype_name: str):
    """(ms, "bytes" | "operations"): the least time the card could take
    — every tensor argument read once and the output written once at the
    memory rate, or ``ops`` at the peak rate of the input type."""
    nbytes = sum(t.numel() * t.element_size() for t in (*tensors, out))
    return bound_of(nbytes, ops, dtype_name)


def bound_of(nbytes: float, ops: float, dtype_name: str):
    """The same bound from a count of bytes (where the bytes a function
    must move depend on the data)."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def draw_222():
    """(src (1, 1, 2, 64, 64, 8), pairwise (1, 2, 2, 4, 4)), float32: the
    222nd draw of a loop over np.random.default_rng(0) that draws two
    agents' angles (uniform +-pi), then their positions (uniform +-90
    px), then a unit-normal source.  On it the Pallas tile kernel's ROI
    skip zeroes a tile (receiver 1, sender 0, xt 0, yt 1) that the oracle
    fills; the port's kernels must not."""
    rng = np.random.default_rng(0)
    for _ in range(222):
        ang = rng.uniform(-np.pi, np.pi, (1, 2))
        pos = rng.uniform(-90.0, 90.0, (1, 2, 2))
        src = rng.normal(size=(1, 1, 2, 64, 64, 8))
    m = np.tile(np.eye(4), (1, 2, 1, 1))
    m[:, :, 0, 0], m[:, :, 0, 1] = np.cos(ang), -np.sin(ang)
    m[:, :, 1, 0], m[:, :, 1, 1] = np.sin(ang), np.cos(ang)
    m[:, :, :2, 3] = pos
    pair = np.einsum("bixy,bjyz->bjixz", np.linalg.inv(m), m)
    return src.astype(np.float32), pair.astype(np.float32)


def warp_fp32_bound(src_typed, pairwise, mode, discrete_ratio,
                    downsample_rate, receivers=None):
    """The per-element float32 bound of the pair warp against its twin
    (see ``WARP_COORD_ULPS``): (B, I, J, H, W, C) float32, from the
    twin's own geometry (type gather, discretized and centred affines,
    post-swap coefficients) on these inputs."""
    import torch
    import torch.nn.functional as F

    from hmvit_tpu_torch.ops.fused_warp import pair_warp_coefficients
    from hmvit_tpu_torch.ops.shear_warp import _affine_coefficients, \
        _pixel_affine
    from hmvit_tpu_torch.ops.warp import centered_affine, \
        discretize_transform

    bsz, _, l, h, w, c = src_typed.shape
    r = l if receivers is None else receivers
    dev = src_typed.device
    bidx = torch.arange(bsz, device=dev)[:, None]
    typed = src_typed[bidx, mode[:, :r].long()].reshape(-1, h, w, c).float()
    t_ij = pairwise.transpose(1, 2)[:, :r].reshape(-1, 4, 4)
    t = centered_affine(discretize_transform(
        t_ij, discrete_ratio, downsample_rate).to(torch.float32), (h, w))
    coefs = _affine_coefficients(_pixel_affine(t, (h, w), (h, w)))
    # the kernel's coefficient rows (flag 1: copied), in the twin's order
    kcoef = pair_warp_coefficients(pairwise, (h, w), discrete_ratio,
                                   downsample_rate)[:, :r].reshape(-1, 8)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    cols = torch.arange(w, device=dev)[None, :]
    yi = torch.arange(h, device=dev)[:, None]
    bound = torch.empty_like(typed)
    for n in range(typed.shape[0]):
        m00, m01, tx, v0, v1, tya, swap = (q[n] for q in coefs)
        s = typed[n].transpose(0, 1) if bool(swap) else typed[n]
        s_pad = F.pad(s, (0, 0, 0, 0, 2, 2))  # rows -2 .. h + 1
        rcoord = v1 * ys + v0 * xs + tya  # (Y, column tap)
        r0 = torch.floor(rcoord).long()

        def row(k):
            return s_pad[(r0 + k).clamp(-2, h + 1) + 2, cols]

        taps = [row(k) for k in (-1, 0, 1, 2)]
        frac = (rcoord - torch.floor(rcoord))[..., None]
        tmp = (1.0 - frac) * taps[1] + frac * taps[2]
        g1 = torch.stack([(taps[k + 1] - taps[k]).abs() for k in range(3)]
                         ).amax(0)  # (Y, column tap, C)
        g1 = F.pad(g1, (0, 0, 2, 2))
        tmp = F.pad(tmp, (0, 0, 2, 2))
        g2 = (tmp[:, 1:] - tmp[:, :-1]).abs()  # column taps -2 .. w
        ccoord = m00 * xs + m01 * ys + tx  # (Y, X)
        x0 = torch.floor(ccoord).long()
        xf = torch.floor(ccoord)
        rows = [v1 * ys + v0 * (xf + k) + tya for k in (0.0, 1.0)]
        if bool(kcoef[n, 7] == 1.0):  # the kernel copies the pixel
            d_col = (xs - ccoord).abs()
            d_row = torch.stack([(ys - r_).abs() for r_ in rows]).amax(0)
        else:
            km00, km01, ktx, kv0, kv1, ktya = kcoef[n, :6]
            if bool(kcoef[n, 6] > 0.5) != bool(swap):
                raise AssertionError(f"pair {n}: the kernel's coefficient "
                                     f"row swaps the passes, the twin's not")
            d_col = (km00 * xs + km01 * ys + ktx - ccoord).abs()
            d_row = torch.stack([
                ((kv1 * ys + kv0 * (xf + k) + ktya) - r_).abs()
                for k, r_ in zip((0.0, 1.0), rows)]).amax(0)
        d1 = torch.stack([g1[yi, (x0 + k).clamp(-2, w + 1) + 2]
                          for k in (-1, 0, 1, 2)]).amax(0)
        d2 = torch.stack([g2[yi, (x0 + k).clamp(-2, w) + 2]
                          for k in (-1, 0, 1)]).amax(0)
        # a float32 sum rounds at the magnitude of its terms, not of its
        # value (a coordinate near 0 carries its translation's rounding)
        mag = torch.maximum(
            m00.abs() * xs + m01.abs() * ys + tx.abs(),
            v1.abs() * ys + v0.abs() * (xf.abs() + 1.0) + tya.abs()
            + 2.0 * (v0 * tx).abs()).clamp(min=1.0)
        ulp = torch.ldexp(torch.ones_like(mag),
                          torch.frexp(mag).exponent - 24)
        shift = d_col + d_row + WARP_COORD_ULPS * ulp
        bound[n] = FP32_ATOL + shift[..., None] * (d1 + d2)
    return bound.reshape(bsz, r, l, h, w, c)


def check_spread_draws(dev):
    """Phase 2, P2: the tile and resident pair warps in float32 on
    ``SPREAD_DRAWS`` spread-pose draws (agents within +-120 m, unit-normal
    maps at the production shapes), each draw from its own generator,
    held to their twin per element within ``warp_fp32_bound``.  Returns
    {kernel: {"draws", "max_abs_err", "max_err_over_bound"}}."""
    import torch

    from hmvit_tpu_torch import perf_lab
    from hmvit_tpu_torch.ops import plain_ops
    from hmvit_tpu_torch.ops.fused_warp import fused_pair_warp
    from hmvit_tpu_torch.utils.precision import strict_fp32

    from hmvit_tpu_torch.ops.fused_warp import pair_warp_coefficients
    from hmvit_tpu_torch.ops.shear_warp import _affine_coefficients, \
        _pixel_affine
    from hmvit_tpu_torch.ops.warp import centered_affine, \
        discretize_transform

    lab = perf_lab.Lab(dev, perf_lab.PROD, iters=1)
    mode = torch.tensor([[1, 0, 1, 0]], device=dev)
    worst = {v: [0.0, 0.0] for v in ("tile", "resident")}
    at_copy = 0
    for k in range(SPREAD_DRAWS):
        lab.gen.manual_seed(1000 + k)
        pair = lab.rand_pairwise(4, spread=120.0)
        src = lab.randn(1, 2, 4, 128, 128, 512)
        args = (src, pair, mode, 0.4, 4, None)
        with strict_fp32():
            with plain_ops():
                want = fused_pair_warp(*args)
            bound = warp_fp32_bound(*args)
            line = []
            # the kernel's coefficient rows against the twin's own chain
            kcoef = pair_warp_coefficients(pair, (128, 128), 0.4, 4)[0] \
                .reshape(16, 8)
            t = centered_affine(discretize_transform(
                pair.transpose(1, 2).reshape(4, 4, 4, 4), 0.4, 4)
                .reshape(-1, 2, 3).float(), (128, 128))
            tcoef = torch.stack(_affine_coefficients(
                _pixel_affine(t, (128, 128), (128, 128))), -1).float()
            rows_diff = float((kcoef[:, :7] - tcoef).abs().max())
            for variant in worst:
                got = fused_pair_warp(*args, variant=variant)
                diff = (got - want).abs()
                if variant == "tile":
                    i, j = (int(q) for q in torch.unravel_index(
                        diff.argmax(), diff.shape)[1:3])
                    copied = bool(kcoef[i * 4 + j, 7] == 1.0)
                    at_copy += copied
                err = float(diff.max())
                ratio = float((diff / bound).max())
                line.append(f"{variant} {err:.3e} ({ratio:.3f} of bound)")
                worst[variant] = [max(worst[variant][0], err),
                                  max(worst[variant][1], ratio)]
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"pair warp ({variant}) float32, spread draw {k}: "
                        f"max_abs_err {err}, {ratio} of the derived bound")
        print(f"  pair warp float32, spread draw {k}: " + ", ".join(line)
              + f"; bound {float(bound.min()):.3e} .. "
              f"{float(bound.max()):.3e}; worst element on pair ({i}, {j})"
              f"{', copied (identity)' if copied else ''}; coefficient rows "
              f"kernel vs twin max|diff| {rows_diff:.1e}")
        del src, pair, want, bound, got, diff
    print(f"  pair warp float32, spread draws: the worst element lies on a "
          f"copied identity pair in {at_copy} of {SPREAD_DRAWS}")
    torch.cuda.empty_cache()
    return {("pair_warp" if v == "tile" else "pair_warp_resident"):
            {"draws": SPREAD_DRAWS, "max_abs_err": e,
             "max_err_over_bound": q} for v, (e, q) in worst.items()}


def check_kernels(dev, pairwise, agent_mask):
    """Phase 2: each kernel vs its plain twin at the production shapes."""
    import torch
    import torch.nn.functional as F

    from hmvit_tpu_torch import perf_lab
    from hmvit_tpu_torch.models.hetero_fusion import (
        _window_split,
        pairwise_roi_mask,
    )
    from hmvit_tpu_torch.ops import cuda, opcount, plain_ops
    from hmvit_tpu_torch.ops.fused_warp import (
        fused_pair_warp,
        pair_warp_coefficients,
        pair_warp_launch,
        roi_tile_valid,
    )
    from hmvit_tpu_torch.ops.fused_warp_attention import (
        fused_warp_window_attention,
        warp_window_attention_launch,
    )
    from hmvit_tpu_torch.ops.window_attention import (
        _split_local,
        fused_plain_window_attention,
        fused_stripe_window_attention,
        fused_window_attention,
        plain_window_attention_launch,
        stripe_window_attention_launch,
        typed_window_attention_launch,
    )
    from hmvit_tpu_torch.utils.precision import strict_fp32

    # the cases at phase 8's training shapes draw from a generator of
    # their own: the other cases keep the inputs they had without them
    gens = [torch.Generator(device=dev).manual_seed(0)]
    train_gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gens[-1], device=dev)

    def train(make):
        def case(dt):
            gens.append(train_gen)
            try:
                return make(dt)
            finally:
                gens.pop()
        return case

    l, hw, c, heads, d, win = 4, 128, 256, 8, 32, 8
    t = win * win
    nwin = (hw // win) ** 2
    mode = torch.tensor([[1, 0, 1, 0]], device=dev)
    pair_mask = pairwise_roi_mask(pairwise, agent_mask, (hw, hw), 0.4, 4)
    mask_ij = pair_mask[0].movedim(-1, 1).contiguous()  # (I, J, H, W)
    mask_ij[0, :, :16, :16] = 0  # a fully masked patch: rows emit zeros
    mask_ij[:, 0, 32:48] = 0  # the first sender masked in two window rows
    bias = randn(heads, t, t) * 0.5

    def attention_ops(n, j, typed=False):
        """Multiply-adds counted as 2 (``opcount.attention_ops``, the
        FLOP count of ``hmvit_tpu_torch.bench`` too)."""
        return opcount.attention_ops(n, nwin, t, j, heads, d, typed)

    def sdpa(qw, kw, vw, bias_, mw):
        """The library call on pre-split windows: qw (N, Wn, T, C); kw,
        vw (N, J, Wn, T, C); mw (N, J, Wn, T).  Operands are laid out
        once; the returned function is the one timed call."""
        n, wn = qw.shape[:2]
        j = kw.shape[1]

        def heads_first(z, keys):
            z = z.reshape(n * wn, keys, heads, d)
            return z.transpose(1, 2).contiguous()

        q4 = heads_first(qw, t)
        k4 = heads_first(kw.movedim(1, 2).reshape(n, wn, j * t, c), j * t)
        v4 = heads_first(vw.movedim(1, 2).reshape(n, wn, j * t, c), j * t)
        neg = torch.where(mw.movedim(1, 2) > 0, 0.0, -1e9).to(qw.dtype)
        add = (bias_[None, :, :, None, :]
               + neg.reshape(n * wn, 1, 1, j, t)).reshape(
                   n * wn, heads, t, j * t).contiguous()
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=add, scale=1.0)

    def warp(dt, ty, mode_, receivers, variant, pair=pairwise, src=None,
             geo=(0.4, 4)):
        """A pair-warp case: new K1 held to its previous body, K5 to new
        K1, bit for bit; both timed in turns with the previous body."""
        j = pair.shape[1]
        r = j if receivers is None else receivers
        if src is None:
            src = randn(1, ty, j, hw, hw, 2 * c)
        args = (src.to(dt), pair, mode_, *geo, receivers)
        size, ck = src.shape[3], src.shape[-1]
        if dt == torch.float32 and variant == "tile":
            coef = pair_warp_coefficients(pair, (size, size), *geo)[:, :r]
            seen = roi_tile_valid(coef, size)
            print(f"  pair warp poses [{r} x {j} pairs, {size}^2]: "
                  f"{int((~seen).sum())} of {seen.numel()} (pair, 32 x 32 "
                  f"tile)s out of view (roi_tile_valid)")
        if variant == "resident":
            exact = lambda: fused_pair_warp(*args, variant="tile")  # noqa: E731
            what = "the tile kernel"
        else:
            def exact():
                launch, out = pair_warp_launch(*args, previous=True)
                launch()
                return out
            what = "the previous body"
        # spread poses in float32: the derived per-element bound
        bound = (None if pair is not pair_far or dt != torch.float32
                 else lambda: warp_fp32_bound(*args))
        return dict(
            args=args, tensors=args[:1], bound=bound,
            fn=lambda *a: fused_pair_warp(*a, variant=variant),
            prep=lambda *a, **kw: pair_warp_launch(*a, variant=variant, **kw),
            exact=exact, exact_what=what, library=None, previous=True,
            previous_kw={"previous": True}, device=True,
            ops=opcount.pair_warp_ops(r, j, size, size, ck))

    def stripe(dt, n, j=l, mask=mask_ij):
        args = (randn(n, hw, hw, c).to(dt), randn(n, j, hw, hw, 2 * c).to(dt),
                bias.to(dt), mask[:n].to(dt), win, heads, d)
        q_, kv_, b_, m_ = args[:4]
        kvw = _split_local(kv_, win)
        return dict(
            args=args, tensors=args[:4], fn=fused_stripe_window_attention,
            prep=stripe_window_attention_launch, exact=None, previous=True,
            library=lambda: sdpa(_split_local(q_, win), kvw[..., :c],
                                 kvw[..., c:], b_,
                                 _split_local(m_[..., None], win)[..., 0]),
            ops=attention_ops(n, j))

    def plain(dt, n, j, mask):
        args = (randn(n, nwin, t, c).to(dt),
                randn(n, j, nwin, t, 2 * c).to(dt), bias.to(dt), mask.to(dt),
                heads, d)
        q_, kv_, b_, m_ = args[:4]
        return dict(
            args=args, tensors=args[:4], fn=fused_plain_window_attention,
            prep=plain_window_attention_launch, exact=None, previous=True,
            library=lambda: sdpa(q_, kv_[..., :c], kv_[..., c:], b_, m_),
            ops=attention_ops(n, j))

    def typed(dt):
        mask = grid_mask.clone()
        mask[0, :, 0] = 0  # receiver 0, window 0: fully masked rows
        args = (randn(l, nwin, t, c).to(dt), randn(l, l, nwin, t, c).to(dt),
                randn(l, l, nwin, t, c).to(dt),
                (randn(l, l, heads, d, d) * d ** -0.5).to(dt),
                (randn(l, l, heads, d, d) * d ** -0.5).to(dt),
                bias.to(dt), mask.to(dt), heads, d)
        q_, k_, v_, wa_, wm_, b_, m_ = args[:7]

        def library():
            # the relation matrices move onto K and V outside the timed
            # call: (q W) k^T = q (k W^T)^T
            kh = k_.reshape(l, l, nwin, t, heads, d).float()
            vh = v_.reshape(l, l, nwin, t, heads, d).float()
            k2 = torch.einsum("njwshe,njhde->njwshd", kh, wa_.float())
            v2 = torch.einsum("njwshe,njhde->njwshd", vh, wm_.float())
            return sdpa(q_, k2.reshape(k_.shape).to(dt),
                        v2.reshape(v_.shape).to(dt), b_, m_)

        return dict(
            args=args, tensors=args[:7], fn=fused_window_attention,
            prep=typed_window_attention_launch, exact=None, previous=True,
            library=library, ops=attention_ops(l, l, typed=True))

    def fused(dt, ty, mode_, receivers, pair=pairwise, mask=mask_ij,
              size=hw, geo=(0.4, 4)):
        j = pair.shape[1]
        r = j if receivers is None else receivers
        # q scaled as the module scales it: the scores keep unit variance
        args = ((randn(r, size, size, c) * d ** -0.5).to(dt),
                randn(1, ty, j, size, size, 2 * c).to(dt), pair, mode_,
                mask[:r].to(dt), bias.to(dt), win, heads, d, *geo,
                receivers)
        q_, src_, _, _, m_, b_ = args[:6]

        def exact():
            kv_pair = fused_pair_warp(src_, pair, mode_, *geo, receivers)
            return fused_stripe_window_attention(
                q_, kv_pair.reshape(r, j, size, size, 2 * c), b_, m_, win,
                heads, d)

        return dict(
            args=args, tensors=(q_, src_, m_, b_),
            fn=fused_warp_window_attention,
            prep=warp_window_attention_launch, exact=exact, library=None,
            previous=True, exact_what="the split kernels",
            ops=(opcount.attention_ops(r, (size // win) ** 2, t, j, heads, d)
                 + opcount.pair_warp_ops(r, j, size, size, 2 * c)))

    grid_mask = _window_split(mask_ij[..., None], win, "grid")[..., 0] \
        .reshape(l, l, nwin, t)
    ego_mode = torch.zeros_like(mode)
    # a fleet of 5 (320 keys a window): seeded rigid poses within 20 m,
    # every pair in view; sender 0 masked in two window rows, receiver 0's
    # first patch for every sender
    pair5 = perf_lab.Lab(dev, perf_lab.PROD, iters=1).rand_pairwise(5)
    mode5 = torch.tensor([[1, 0, 1, 0, 1]], device=dev)
    mask5 = pairwise_roi_mask(pair5, torch.ones(1, 5, device=dev), (hw, hw),
                              0.4, 4)[0].movedim(-1, 1).contiguous()
    mask5[0, :, :16, :16] = 0
    mask5[:, 0, 32:48] = 0
    grid_mask5 = _window_split(mask5[..., None], win, "grid")[..., 0] \
        .reshape(5, 5, nwin, t)
    # spread poses: 4 agents within +-120 m on the 204.8 m map, so much of
    # each pair lies out of view (the ROI tile skip)
    pair_far = perf_lab.Lab(dev, perf_lab.PROD, iters=1).rand_pairwise(
        4, spread=120.0)
    mask_far = pairwise_roi_mask(pair_far, agent_mask, (hw, hw), 0.4, 4)[0] \
        .movedim(-1, 1).contiguous()
    # the draw on which the Pallas kernels' tile skip is not conservative
    src222, pair222 = draw_222()
    src222 = torch.as_tensor(src222, device=dev)
    pair222 = torch.as_tensor(pair222, device=dev)
    mode222 = torch.zeros(1, 2, dtype=torch.long, device=dev)
    mask222 = torch.ones(2, 2, 64, 64, device=dev)
    # the first variant of each kernel is the one its record carries
    cases = {
        "pair_warp": [
            ("local I=4 TY=2", lambda dt: warp(dt, 2, mode, None, "tile")),
            ("ego I=1 TY=1", lambda dt: warp(dt, 1, ego_mode, 1, "tile")),
            ("spread I=4 TY=2",
             lambda dt: warp(dt, 2, mode, None, "tile", pair_far)),
            ("draw 222, 64^2 C=8",
             lambda dt: warp(dt, 1, mode222, None, "tile", pair222, src222,
                             (1.0, 1.0))),
            ("train: fleet of 5, I=J=5 TY=2",
             train(lambda dt: warp(dt, 2, mode5, None, "tile", pair5))),
            ("train: fleet of 5, ego I=1 TY=2",
             train(lambda dt: warp(dt, 2, mode5, 1, "tile", pair5))),
        ],
        "stripe_window_attention": [
            ("local N=4 J=4", lambda dt: stripe(dt, l)),
            ("local ego N=1 J=4", lambda dt: stripe(dt, 1)),
            ("train: fleet of 5, N=J=5",
             train(lambda dt: stripe(dt, 5, 5, mask5))),
        ],
        "plain_window_attention": [
            ("grid J=4", lambda dt: plain(dt, l, l, grid_mask)),
            ("grid ego N=1 J=4", lambda dt: plain(dt, 1, l, grid_mask[:1])),
            ("camera J=1", lambda dt: plain(
                dt, 2, 1, torch.ones(2, 1, nwin, t, device=dev))),
            ("train: grid fleet of 5, N=J=5",
             train(lambda dt: plain(dt, 5, 5, grid_mask5))),
            ("train: grid ego, fleet of 5, N=1 J=5",
             train(lambda dt: plain(dt, 1, 5, grid_mask5[:1]))),
            ("train: camera J=1 over 5 slots", train(lambda dt: plain(
                dt, 5, 1, torch.ones(5, 1, nwin, t, device=dev)))),
        ],
        "warp_window_attention": [
            ("local I=4 TY=2", lambda dt: fused(dt, 2, mode, None)),
            ("ego I=1 TY=1", lambda dt: fused(dt, 1, ego_mode, 1)),
            ("fleet of 5, I=J=5 TY=2",
             lambda dt: fused(dt, 2, mode5, None, pair5, mask5)),
            ("spread I=4 TY=2",
             lambda dt: fused(dt, 2, mode, None, pair_far, mask_far)),
            ("draw 222, 64^2 I=J=2",
             lambda dt: fused(dt, 1, mode222, None, pair222, mask222, 64,
                              (1.0, 1.0))),
        ],
        "pair_warp_resident": [
            ("local I=4 TY=2",
             lambda dt: warp(dt, 2, mode, None, "resident")),
            ("ego I=1 TY=1",
             lambda dt: warp(dt, 1, ego_mode, 1, "resident")),
            ("spread I=4 TY=2",
             lambda dt: warp(dt, 2, mode, None, "resident", pair_far)),
            ("draw 222, 64^2 C=8",
             lambda dt: warp(dt, 1, mode222, None, "resident", pair222,
                             src222, (1.0, 1.0))),
        ],
        "typed_window_attention": [("N=J=4", typed)],
    }
    record = {}
    for name, variants in cases.items():
        rec = None
        bf16_err = 0.0
        for label, make in variants:
            for dt, tol in ((torch.float32, FP32_ATOL),
                            (torch.bfloat16, BF16_ATOL[name])):
                case = make(dt)
                args, fn = case["args"], case["fn"]
                key = str(dt).split(".")[-1]
                bodies = cuda.attention_body_launches().get(name)
                with strict_fp32():
                    got = fn(*args)
                    ran = cuda.attention_body_launches().get(name)
                    with plain_ops():
                        want = fn(*args)
                    same = case["exact"]() if case["exact"] else None
                torch.cuda.synchronize()
                if name in TENSOR_CORE_KERNELS:
                    # bfloat16 on the tensor cores, float32 on the fp32 body
                    body = "mma" if dt == torch.bfloat16 else "simt"
                    ran = {b: ran[b] - bodies[b] for b in ran}
                    if ran != {b: int(b == body) for b in ran}:
                        raise AssertionError(
                            f"{name} {label} {key}: ran {ran}, expected one "
                            f"launch of the {body} body")
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"{name} {label}: {got.shape} "
                                         f"{got.dtype} vs {want.shape}")
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                if case.get("bound") is not None:
                    ratio = float((diff / case["bound"]()).max())
                    print(f"  {name} [{label}, {key}]: max_abs_err "
                          f"{err:.3e}, {ratio:.3f} of the derived "
                          f"per-element bound (warp_fp32_bound)")
                    if not ratio <= 1.0:
                        raise AssertionError(
                            f"{name} {label} {key}: kernel vs plain twin "
                            f"exceeds the derived bound ({ratio})")
                else:
                    print(f"  {name} [{label}, {key}]: max_abs_err "
                          f"{err:.3e} (tol {tol})")
                    if not np.isfinite(err) or err > tol:
                        raise AssertionError(
                            f"{name} {label} {key}: kernel vs plain twin "
                            f"max_abs_err {err} > {tol}")
                del diff
                if same is not None:
                    diff = float((got.float() - same.float()).abs().max())
                    print(f"  {name} [{label}, {key}]: max|diff| against "
                          f"{case['exact_what']} {diff:.1e}")
                    if not torch.equal(got, same):
                        raise AssertionError(
                            f"{name} {label} {key}: differs from the kernels "
                            f"it must equal bit for bit (max|diff| {diff})")
                if dt == torch.bfloat16:
                    bf16_err = max(bf16_err, err)
                    # the kernel alone (inputs laid out once), the whole
                    # wrapper (geometry prep, layout, launch), the twin,
                    # and the library call where there is one
                    launch, out = case["prep"](*args)
                    prev_ms = None
                    extra = {}
                    if case.get("previous"):
                        # the previous body on the same operands, in turns
                        # with the new one: the attention kernels' fp32
                        # CUDA-core body, the pair warp's one thread per 8
                        # channels of a pixel
                        old, old_out = case["prep"](
                            *args, **case.get("previous_kw", {"simt": True}))
                        turns = [time_ms(f) for f in (old, launch, launch,
                                                      old)]
                        prev_ms = (turns[0] + turns[3]) / 2
                        k_ms = (turns[1] + turns[2]) / 2
                        diff = float((old_out.float() - want.float())
                                     .abs().max())
                        print(f"  {name} [{label}, bfloat16]: previous body "
                              f"{turns[0]:.4f} / {turns[3]:.4f} ms "
                              f"(max_abs_err {diff:.3e}), new body "
                              f"{turns[1]:.4f} / {turns[2]:.4f} ms")
                        if not diff <= tol:
                            raise AssertionError(
                                f"{name} {label}: the previous body "
                                f"disagrees with the twin: {diff}")
                        if case.get("device"):
                            # the device time alone, as for the lidar
                            # kernels: 20 calls in a CUDA graph
                            extra["device_ms"] = device_ms(launch)
                            extra["previous_device_ms"] = device_ms(old)
                            print(f"  {name} [{label}, bfloat16]: device "
                                  f"time {extra['device_ms']:.4f} ms, "
                                  f"previous body "
                                  f"{extra['previous_device_ms']:.4f} ms")
                        del old, old_out
                    else:
                        k_ms = time_ms(launch)
                    w_ms = time_ms(lambda: fn(*args))
                    with plain_ops():
                        p_ms = time_ms(lambda: fn(*args))
                    lib_ms = None
                    if case["library"] is not None:
                        call = case["library"]()
                        lib_ms = time_ms(call)
                        del call
                    b_ms, b_by = bound_ms(case["tensors"], out, case["ops"],
                                          key)
                    lib_txt = ("none" if lib_ms is None
                               else f"{lib_ms:.4f} ms")
                    print(f"  {name} [{label}, bfloat16]: kernel {k_ms:.4f} "
                          f"ms, wrapper {w_ms:.4f} ms, plain twin "
                          f"{p_ms:.4f} ms, library call {lib_txt}, bound "
                          f"{b_ms:.4f} ms ({b_by})")
                    timed = {"ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "library_ms": lib_ms}
                    if prev_ms is not None:
                        timed["previous_ms"] = prev_ms
                    timed.update(extra)
                    if rec is None:
                        rec = dict(timed, cases={})
                    rec["cases"][label] = dict(timed, max_abs_err=err)
                    del launch, out
                del case, args, got, want, same
                torch.cuda.empty_cache()
        record[name] = dict(rec, max_abs_err=bf16_err)
    return record


def check_lidar_kernels(dev, points, points_mask):
    """Phase 2, the lidar encoder's three kernels: bit for bit against
    their plain versions on the production batch's pillar ids and PFN
    rows (points (N, P, 4) of the lidar agents), on dense clouds of as
    many points (every row valid, runs up to the point cap), on 40 000
    synthetic rows, and on shapes outside the Pallas kernels' gates (a
    704 x 200 grid, C = 12); the scan also on long runs and against its
    previous body; bfloat16 times on the production case (the one the
    record carries), the dense clouds, the long runs and the synthetic
    rows."""
    import torch

    from hmvit_tpu_torch import perf_lab
    from hmvit_tpu_torch.models.pillar_encoder import PillarFeatureNet
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.ops import plain_ops
    from hmvit_tpu_torch.ops.expand import (
        expand_rows_launch,
        expand_rows_to_dense,
        expand_rows_to_dense_plain,
        expand_rows_to_dense_v2,
    )
    from hmvit_tpu_torch.ops.segscan import (
        fused_segmented_max_scan,
        scan_plan,
        segmented_max_scan_launch,
    )
    from hmvit_tpu_torch.ops.voxelize import compact_pillar_rows, scan_steps
    from hmvit_tpu_torch.serving import PROD_CFG

    lidar = PROD_CFG["lidar"]
    grid = lidar["point_pillar_scatter"]["grid_size"][:2]
    n_clouds = points.shape[0]
    num_cells = n_clouds * grid[0] * grid[1]
    record = {}

    def must_equal(name, label, key, got, want, what):
        err = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        print(f"  {name} [{label}, {key}]: max_abs_err {err:.1e} against "
              f"{what} (must be equal bit for bit)")
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{name} {label} {key}: differs from "
                                 f"{what} (max|diff| {err})")
        return err

    def times(name, label, launch, wrapper, library, nbytes, ops, extra="",
              previous=None):
        """Kernel and library call as one call each (``time_ms``, as
        every kernel is timed), and on the device alone (``device_ms``):
        these kernels run for less time than their host launch takes.
        ``previous``: the kernel's previous body, timed in turns with it
        (previous, new, new, previous), one call and on the device."""
        prev = {}
        if previous is None:
            k_ms, k_dev = time_ms(launch), device_ms(launch)
        else:
            order = (previous, launch, launch, previous)
            one = [time_ms(f) for f in order]
            dev_t = [device_ms(f) for f in order]
            k_ms, k_dev = (one[1] + one[2]) / 2, (dev_t[1] + dev_t[2]) / 2
            prev = {"previous_ms": (one[0] + one[3]) / 2,
                    "previous_device_ms": (dev_t[0] + dev_t[3]) / 2}
            print(f"  {name} [{label}, bfloat16]: previous body "
                  f"{one[0]:.4f} / {one[3]:.4f} ms (device {dev_t[0]:.4f} / "
                  f"{dev_t[3]:.4f}), new body {one[1]:.4f} / {one[2]:.4f} ms "
                  f"(device {dev_t[1]:.4f} / {dev_t[2]:.4f}), in turns")
        w_ms = time_ms(wrapper)
        with plain_ops():
            p_ms = time_ms(wrapper)
        lib_ms = lib_dev = None
        if library is not None:
            lib_ms, lib_dev = time_ms(library), device_ms(library)
        b_ms, b_by = bound_of(nbytes, ops, "bfloat16")
        lib_txt = ("none" if lib_ms is None else
                   f"{lib_ms:.4f} ms (device {lib_dev:.4f}; kernel / library "
                   f"call {k_ms / lib_ms:.2f} one call each, "
                   f"{k_dev / lib_dev:.2f} on the device)")
        print(f"  {name} [{label}, bfloat16]: kernel {k_ms:.4f} ms (device "
              f"{k_dev:.4f}), wrapper {w_ms:.4f} ms, plain version "
              f"{p_ms:.4f} ms, library call {lib_txt}, bound {b_ms:.4f} ms "
              f"({b_by}){extra}")
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms, "device_ms": k_dev,
                "library_device_ms": lib_dev, **prev}

    def scan_case(label, key, feats, ids, steps, timed, record_as=None):
        """The one-pass scan against the log-shift scan and against its
        previous body on rows whose id is >= 0; returns the log-shift
        scan's output.  A timed case's numbers go into the record, the
        production case's as the record's own keys, the others' under
        ``record_as``."""
        valid = ids >= 0
        got = fused_segmented_max_scan(feats, ids, steps)
        with plain_ops():
            want = fused_segmented_max_scan(feats, ids, steps)
        old, old_out = segmented_max_scan_launch(feats, ids, steps,
                                                 previous=True)
        old()
        torch.cuda.synchronize()
        err = must_equal("segmented_max_scan", label, key, got[valid],
                         want[valid], "the log-shift scan")
        must_equal("segmented_max_scan", label, key, got[valid],
                   old_out[valid], "its previous body")
        if not timed:
            return want
        p, c = feats.shape
        launch, out = segmented_max_scan_launch(feats, ids, steps)
        rows, two_pass = scan_plan(c, steps)
        # the function's work: one maximum per channel for each row that
        # continues a run, whatever computes it
        cont = int(((ids[1:] == ids[:-1]) & valid[1:]).sum())
        nbytes = 2 * feats.numel() * feats.element_size() + p * 4
        rec = dict(
            times("segmented_max_scan", label, launch,
                  lambda: fused_segmented_max_scan(feats, ids, steps), None,
                  nbytes, float(cont * c),
                  f"; {int(valid.sum())} rows with id >= 0, {cont} of them "
                  f"continue a run; tiles of {rows} rows, "
                  f"{'two launches' if two_pass else 'one launch'}",
                  previous=old),
            max_abs_err=err)
        if record_as is None:
            record["segmented_max_scan"] = rec
        else:
            record["segmented_max_scan"].update(
                {f"{record_as}_{k}": rec[k] for k in (
                    "ms", "device_ms", "previous_ms", "previous_device_ms",
                    "plain_ms", "bound_ms")})
        return want

    def expand_case(label, key, comp, ids, timed, num_cells=num_cells):
        """v1 and v2 against the plain version and against each other."""
        want = expand_rows_to_dense_plain(comp, ids, num_cells)
        outs = {"expand_rows": expand_rows_to_dense(comp, ids, num_cells),
                "expand_rows_v2": expand_rows_to_dense_v2(comp, ids,
                                                          num_cells)}
        torch.cuda.synchronize()
        errs = {name: must_equal(name, label, key, out, want,
                                 "the plain version")
                for name, out in outs.items()}
        must_equal("expand_rows_v2", label, key, outs["expand_rows_v2"],
                   outs["expand_rows"], "the v1 kernel")
        if not timed:
            return errs
        real = ids < num_cells
        rows = comp[real].contiguous()
        where = ids[real].long()

        def library():
            out = torch.zeros((num_cells, comp.shape[1]), dtype=comp.dtype,
                              device=dev)
            return out.index_copy_(0, where, rows)

        must_equal("library call", label, key, library(), want,
                   "the plain version")
        for name, fn, v2 in (("expand_rows", expand_rows_to_dense, False),
                             ("expand_rows_v2", expand_rows_to_dense_v2,
                              True)):
            launch, out = expand_rows_launch(comp, ids, num_cells, v2)
            tables = (-(-num_cells // (128 if v2 else 4096)) + 1) * 4
            # the rows this run places, every id, the table, the output
            nbytes = (rows.numel() * rows.element_size() + ids.numel() * 4
                      + tables + out.numel() * out.element_size())
            # the first timed case (production) is the one the record carries
            rec = dict(
                times(name, label, launch,
                      lambda fn=fn: fn(comp, ids, num_cells), library,
                      nbytes, 0.0,
                      f"; {int(real.sum())} of {len(ids)} rows placed"),
                max_abs_err=errs[name])
            record.setdefault(name, rec)
            del launch, out
        return errs

    for dt in (torch.float32, torch.bfloat16):
        key = str(dt).split(".")[-1]
        bf16 = dt == torch.bfloat16
        net = init_parameters(PillarFeatureNet(
            lidar["pillar_vfe"]["num_filters"], lidar["voxel_size"],
            lidar["lidar_range"], grid,
            compute_dtype=key), seed=0).to(dev, dt).eval()
        with torch.no_grad():
            feats, info = net.point_features(points, points_mask)
        if feats.dtype != dt:
            raise AssertionError(f"PFN rows are {feats.dtype}, not {dt}")
        keep, pillar_id = info["keep"], info["pillar_id"]
        p = feats.shape[0]
        steps = scan_steps(net.max_points_per_pillar, p)
        ids = torch.where(keep, pillar_id, -1)
        label = f"production P={p} C={feats.shape[1]}"

        # -- the one-pass scan; the production case is timed first
        want = scan_case(label, key, feats, ids, steps, timed=bf16)

        # -- the two expansions, on the compacted rows of this scan
        scanned = want * keep[:, None].to(want.dtype)
        comp, comp_ids = compact_pillar_rows(scanned, pillar_id, ids, keep,
                                             num_cells)
        expand_case(label, key, comp, comp_ids, timed=bf16)
        if bf16:
            c_ms = time_ms(lambda: compact_pillar_rows(
                scanned, pillar_id, ids, keep, num_cells))
            print(f"  compaction around the expansion kernels (stable "
                  f"argsort, static shape) [{label}, bfloat16]: "
                  f"{c_ms:.4f} ms")

        # -- 40 000 synthetic rows with fill rows behind them
        rng = np.random.RandomState(0)
        syn_ids = np.sort(rng.choice(num_cells, size=40000, replace=False))
        syn_ids = np.concatenate([syn_ids, np.full(1000, num_cells)])
        syn_ids = torch.as_tensor(syn_ids.astype(np.int32), device=dev)
        syn = torch.randn(len(syn_ids), feats.shape[1], device=dev).to(dt)
        expand_case("synthetic 40000 rows", key, syn, syn_ids, timed=bf16)

        # -- repeated ids (1-4 rows an id): each id's first row is placed
        rep_cells = np.sort(rng.choice(num_cells, size=12000, replace=False))
        rep_ids = np.repeat(rep_cells, rng.randint(1, 5, len(rep_cells)))
        rep_ids = np.concatenate([rep_ids, np.full(100, num_cells)])
        rep_ids = torch.as_tensor(rep_ids.astype(np.int32), device=dev)
        expand_case(f"repeated ids, {len(rep_ids)} rows", key,
                    torch.randn(len(rep_ids), feats.shape[1],
                                device=dev).to(dt), rep_ids, timed=False)

        # -- dense clouds: every row valid, about 24 points to a pillar
        gen = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            d_feats, d_info = net.point_features(*perf_lab.dense_clouds(
                gen, dev, n_clouds, points.shape[1], lidar["voxel_size"],
                lidar["lidar_range"]))
        d_ids = torch.where(d_info["keep"], d_info["pillar_id"], -1)
        d_want = scan_case(f"dense clouds P={p} C={feats.shape[1]}", key,
                           d_feats, d_ids, steps, timed=bf16,
                           record_as="dense")
        d_comp = compact_pillar_rows(
            d_want * d_info["keep"][:, None].to(d_want.dtype),
            d_info["pillar_id"], d_ids, d_info["keep"], num_cells)
        expand_case("dense clouds", key, *d_comp, timed=False)

        # -- long runs (the cap-free contract): runs of 1..4096 rows, a
        # fifth of them -1, steps 12, so that the carry takes the second
        # launch
        l_rng, seg, cur = np.random.RandomState(1), [], 0
        while len(seg) < LONG_RUN_P:
            run = int(l_rng.randint(1, 4097))
            seg.extend([-1 if l_rng.rand() < 0.2 else cur] * run)
            cur += 1
        l_ids = torch.as_tensor(np.asarray(seg[:LONG_RUN_P], np.int32),
                                device=dev)
        scan_case(f"long runs P={LONG_RUN_P} C={feats.shape[1]} steps 12",
                  key, torch.randn(LONG_RUN_P, feats.shape[1],
                                   device=dev).to(dt), l_ids, 12,
                  timed=bf16, record_as="long_run")

        # -- outside the Pallas kernels' gates: C % 8 != 0, cells % 4096 != 0
        scan_case(f"production P={p} C=12", key,
                  feats[:, :12].contiguous(), ids, steps, timed=False)
        expand_case("production rows C=12", key, comp[:, :12].contiguous(),
                    comp_ids, timed=False)
        other = 704 * 200
        o_ids = np.sort(rng.choice(other, size=9000, replace=False))
        o_ids[-1] = other - 1  # the short last block's last cell
        o_ids = np.concatenate([o_ids, np.full(100, other)])
        o_ids = torch.as_tensor(o_ids.astype(np.int32), device=dev)
        expand_case(f"704 x 200 = {other} cells", key,
                    syn[:len(o_ids)].contiguous(), o_ids, timed=False,
                    num_cells=other)
        del net, feats, info, want, scanned, comp, comp_ids, syn
        del d_feats, d_info, d_want, d_comp
        torch.cuda.empty_cache()
    return record


def frame_line(rows) -> str:
    """Median, min and max ms/frame of (forward ms, decode + NMS ms)
    rows, and the medians of the two parts."""
    rows = np.asarray(rows)
    frame_ms = rows.sum(axis=1)
    fwd_ms, dec_ms = np.median(rows, axis=0)
    return (f"{len(rows)} requests: median {float(np.median(frame_ms)):.2f} "
            f"ms/frame (min {float(frame_ms.min()):.2f}, max "
            f"{float(frame_ms.max()):.2f}; forward + decode + NMS, batch 1; "
            f"medians forward {fwd_ms:.2f} ms, decode + NMS {dec_ms:.2f} ms)")


def graph_phase(servers, requests, eager, eager_ms, hints, anchors, eye,
                per_request, card):
    """Phase 6: each server captured (forward, then decode + NMS) by
    ``CompiledServer``; requests 0-2 replayed and held bit for bit to
    phase 5's eager outputs; one replay under ``torch.profiler`` must
    launch each hand-written kernel as often as ``per_request`` says;
    then TIMED_REQUESTS graph frames per server timed in turns with as
    many eager ones (eager, graph, graph, eager, in blocks)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hmvit_tpu_torch.graph_server import CompiledServer
    from hmvit_tpu_torch.tools.profile import hand_written_kernel

    for name, model in servers.items():
        t0 = time.perf_counter()
        server = CompiledServer(model, hints, requests[0], anchors, eye)
        (bucket,) = server.buckets.values()
        capture_s = time.perf_counter() - t0
        print(f"graph ({name}): warm-up + capture {capture_s:.2f} s; "
              f"hand-written launches captured: {bucket.launches}; "
              f"attention launches by body: {bucket.bodies}")
        if bucket.launches != per_request[name]:
            raise AssertionError(f"graph ({name}): captured "
                                 f"{bucket.launches}, expected "
                                 f"{per_request[name]}")
        for kernel, ran in bucket.bodies.items():
            if ran != {"simt": 0, "mma": per_request[name][kernel]}:
                raise AssertionError(f"graph ({name}): {kernel} captured "
                                     f"{ran}, expected every launch on the "
                                     "tensor cores")
        for i, b in enumerate(requests):
            out, (det,) = server(b)
            torch.cuda.synchronize()
            want_out, want_det = eager[name][i]
            for key, got, want in (
                    ("psm", out["psm"], want_out["psm"]),
                    ("rm", out["rm"], want_out["rm"]),
                    *((f"det[{j}]", g, w)
                      for j, (g, w) in enumerate(zip(det, want_det)))):
                if not torch.equal(got, want):
                    diff = float((got.float() - want.float()).abs().max())
                    raise AssertionError(
                        f"graph ({name}) request {i} {key}: the replay "
                        f"differs from the eager forward (max|diff| {diff})")
            print(f"graph ({name}) request {i}: psm, rm and the decoded "
                  f"boxes ({int(det[2].sum())} kept) equal to the eager "
                  "outputs bit for bit")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            server(requests[0])
            torch.cuda.synchronize()
        seen = dict.fromkeys(per_request[name], 0)
        device_ops = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                device_ops += 1
                kernel = hand_written_kernel(e.name)
                if kernel is not None:
                    seen[kernel] = seen.get(kernel, 0) + 1
        print(f"graph ({name}): one replay under the profiler, "
              f"{device_ops} device operations; hand-written kernels by "
              f"name: {seen}")
        if seen != per_request[name]:
            raise AssertionError(f"graph ({name}): the replay launched "
                                 f"{seen}, expected {per_request[name]}")

        def graph_frame(b):
            t0 = time.perf_counter()
            bucket = server.load(b)
            server.replay_forward(bucket)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            bucket.detect_graph.replay()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            return (t1 - t0) * 1e3, (t2 - t1) * 1e3

        rows = {"eager": [], "graph": []}
        for kind in ("eager", "graph", "graph", "eager"):
            for i in range(TIMED_REQUESTS // 2):
                b = requests[i % len(requests)]
                if kind == "graph":
                    rows[kind].append(graph_frame(b))
                else:
                    rows[kind].append(eager_frame(model, b, hints, anchors,
                                                  eye))
        print(f"bf16 serving ({name}), CUDA graph: {frame_line(rows['graph'])}"
              f"; {server.replays} forward replays")
        print(f"bf16 serving ({name}), eager in turns with it: "
              f"{frame_line(rows['eager'])}; phase 5: "
              f"{frame_line(eager_ms[name])} on {card}")
        del server
        torch.cuda.empty_cache()


def eager_frame(model, b, hints, anchors, eye):
    """One eager request: host-clock ms of the forward and of decode +
    NMS, the card synchronised after each."""
    import torch

    from hmvit_tpu_torch.postprocess import decode_detections_device

    t0 = time.perf_counter()
    with torch.no_grad():
        out = model(b, **hints)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode_detections_device(out["psm"], out["rm"], anchors, eye)
        torch.cuda.synchronize()
    return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


# the benchmark entry's runs: flags, and whether to trace (BENCH_TRACE_DIR)
BENCH_RUNS = ((), ("--fused_wa",), ("--expand", "v1"), ("--expand", "v2"))
TRACED_BENCH_RUNS = ((), ("--fused_wa",))


def run_bench(card):
    """``python -m hmvit_tpu_torch.bench`` on each of BENCH_RUNS; its JSON
    line printed; the split and ``--fused_wa`` runs traced and their
    traces rolled up by ``hmvit_tpu_torch.tools.profile``."""
    import os
    import tempfile

    for flags in BENCH_RUNS:
        with tempfile.TemporaryDirectory() as trace_dir:
            env = dict(os.environ)
            if flags in TRACED_BENCH_RUNS:
                env["BENCH_TRACE_DIR"] = trace_dir
            res = subprocess.run(
                [sys.executable, "-m", "hmvit_tpu_torch.bench", *flags],
                capture_output=True, text=True, env=env, timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"bench {' '.join(flags)} failed "
                                     f"({res.returncode}):\n{res.stderr}")
            record = json.loads(res.stdout.strip().splitlines()[-1])
            print(f"bench {' '.join(flags) or '(split)'}: "
                  f"{json.dumps(record)}")
            if record.get("mfu") is None or not record["value"] > 0:
                raise AssertionError(f"bench {' '.join(flags)}: no mfu or "
                                     f"no rate on {card}: {record}")
            if flags in TRACED_BENCH_RUNS:
                from hmvit_tpu_torch.bench import TRACED_REPLAYS
                from hmvit_tpu_torch.tools.profile import summarize

                print(f"bench {' '.join(flags) or '(split)'}: device time "
                      f"of {TRACED_REPLAYS} traced replays by class "
                      f"(hmvit_tpu_torch.tools.profile):")
                summarize(trace_dir, top=15, frames=TRACED_REPLAYS)


TRAIN_BENCH_RUNS = (("--train",), ("--train", "--no_remat"),
                    ("--train", "--bucketed"))
TRAIN_KERNELS = ("pair_warp", "stripe_window_attention",
                 "plain_window_attention")


def train_launches(cfg: dict) -> dict:
    """The kernels one run-both train step of ``cfg`` launches on the
    split route: each fusion iteration warps twice (the local phase and
    the ego grid phase) and attends once locally (stripe) and once on the
    grid (plain), each camera layer's BEV self-attention is one plain
    launch; a stage under remat launches its kernels again in the
    recompute, and the backward is the plain twins' (no launch)."""
    from hmvit_tpu_torch.models.hmvit import remat_stages

    stages = remat_stages(cfg.get("remat"))
    camera = 2 if "camera" in stages else 1
    if cfg.get("fusion_override"):
        # a fusion of the zoo, never under remat
        want = fusion_launches(cfg["fusion_override"])
    else:
        iters = cfg["hetero_fusion"]["num_iters"]
        fusion = 2 if "fusion" in stages else 1
        want = {"pair_warp": 2 * iters * fusion,
                "stripe_window_attention": iters * fusion,
                "plain_window_attention": iters * fusion}
    want["plain_window_attention"] += camera * camera_attention_layers(cfg)
    return want


def fusion_launches(fusion) -> dict:
    """The kernels a fusion of the zoo launches a forward: no warp or
    stripe launch; V2X-ViT one plain launch a window of its pyramid (the
    single-sender case of K3), every other fusion none."""
    plain = len(V2XVIT_WINDOWS) if fusion in ("v2xvit", "v2xt") else 0
    return {"pair_warp": 0, "stripe_window_attention": 0,
            "plain_window_attention": plain}


def model_launches(model_cfg: dict) -> dict:
    """The kernels one train step (no remat) of a hypes ``model`` block
    launches, by its registry name: HMViT with its fusion (H3GAT or
    ``fusion_override``), a cooperative detector's fusion and camera
    encoder, none for a single-agent lidar detector."""
    from hmvit_tpu_torch.models import zoo

    name = model_cfg["core_method"].lower()
    args = model_cfg["args"]
    if name in zoo.HETERO_NAMES:
        return train_launches(args)
    if name in zoo._MIXED_FUSIONS:
        return train_launches(dict(args,
                                   fusion_override=zoo._MIXED_FUSIONS[name]))
    fusions = {**zoo._LIDAR_FUSIONS, **zoo._CAMERA_FUSIONS,
               **zoo._VPN_FUSIONS}
    want = fusion_launches(fusions.get(name))
    if "camera" in args and name not in zoo._LIDAR_FUSIONS:
        want["plain_window_attention"] += camera_attention_layers(args)
    return want


def camera_attention_layers(cfg: dict) -> int:
    """The camera encoder's BEV self-attentions (plain launches) a
    forward: one a layer of the BEVFormer encoder's planar lift (on
    either trunk), none in the deformable lift nor in any other camera
    encoder (cvt, fax, vpn, vpn_ms, bev_swap)."""
    cam = cfg["camera"]
    if cam.get("encoder", "cvt") != "bevformer" or \
            cam.get("lift", "planar") != "planar":
        return 0
    return cam.get("num_layers", 3)


def serving_launches(cfg: dict, cameras: int) -> dict:
    """The kernels one served frame launches (eval mode, serving hints):
    a forward's, without the camera encoder's when the fleet has no
    camera."""
    want = train_launches(dict(cfg, remat=False))
    if cameras == 0:
        want["plain_window_attention"] -= camera_attention_layers(cfg)
    return want


def train_phase(dev, card) -> dict:
    """Phase 8 (see the module's docstring); returns the launches of one
    bfloat16 train step, every kernel's."""
    import copy
    import os
    import tempfile

    import torch

    from hmvit_tpu_torch import bench
    from hmvit_tpu_torch.data.anchors import generate_anchor_grid
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.ops import cuda, plain_ops
    from hmvit_tpu_torch.postprocess import AnchorPostprocessor
    from hmvit_tpu_torch.serving import PROD_CFG, anchor_args, \
        batch_to_device
    from hmvit_tpu_torch.train.trainer import (
        create_train_state,
        labels_for_batch,
        make_train_step,
    )
    from hmvit_tpu_torch.utils.precision import strict_fp32

    cfg = dict(copy.deepcopy(PROD_CFG), remat=True)
    cfg32 = copy.deepcopy(cfg)
    cfg32["hetero_fusion"]["hetero_fusion_block"]["compute_dtype"] = \
        "float32"
    batch = prod_batch(0)
    pp = AnchorPostprocessor({"anchor_args": anchor_args(cfg),
                              "target_args": bench.TARGET_ARGS,
                              "order": "hwl"})
    labels = labels_for_batch(pp, generate_anchor_grid(anchor_args(cfg)),
                              batch, dev)
    print(f"train: {int(labels['pos_equal_one'].sum())} positive anchors "
          f"in request 0")
    tb = batch_to_device(batch, dev, bf16=False)
    # the same weights (one seed) in the bf16-fusion production model and
    # its float32 twin
    base = {True: init_parameters(HMViT(cfg), seed=0),
            False: init_parameters(HMViT(cfg32), seed=0)}

    def grads_of(half: bool, plain: bool, remat=True):
        """One step from a clone of the weights: (loss, grads on the card,
        launches, peak GB, seconds, attention launches by body)."""
        model = copy.deepcopy(base[half]).to(dev)
        model.config = dict(model.config, remat=remat)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        step = make_train_step(model, opt, half=half)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        t0 = time.perf_counter()
        with (plain_ops() if plain else contextlib.nullcontext()), \
                (contextlib.nullcontext() if half else strict_fp32()):
            _, parts = step(create_train_state(model, opt), tb, labels,
                            bench.TRAIN_SEED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        out = (float(parts["total_loss"]),
               {n: p.grad for n, p in model.named_parameters()},
               cuda.launch_counts(),
               torch.cuda.max_memory_allocated() / 2 ** 30, seconds,
               cuda.attention_body_launches())
        del model, opt, step
        torch.cuda.empty_cache()
        return out

    def compare(what, a, b, tol_loss, tol_grad=None):
        """a against b: the loss relative, each gradient over its largest
        |value| (held where ``tol_grad`` is given)."""
        loss_err = abs(a[0] - b[0]) / abs(b[0])
        errs = sorted((float((a[1][n] - g).abs().max())
                       / max(float(g.abs().max()), 1e-30), n)
                      for n, g in b[1].items())
        worst, median = errs[-1], errs[len(errs) // 2][0]
        held = "printed only" if tol_grad is None else f"tol {tol_grad}"
        print(f"train {what}: loss {a[0]:.6f} vs {b[0]:.6f} (rel "
              f"{loss_err:.3e}, tol {tol_loss}); worst gradient error / "
              f"scale {worst[0]:.3e} at {worst[1]} ({held}), median "
              f"over the {len(errs)} parameters {median:.3e}")
        if not (np.isfinite(a[0]) and loss_err <= tol_loss
                and (tol_grad is None or worst[0] <= tol_grad)):
            raise AssertionError(f"train {what} disagrees: loss {loss_err}, "
                                 f"gradient {worst}")

    def against_fp32(kern16, plain16, plain32):
        """The bf16 step with the kernels against the float32 plain step,
        within BF16_GRAD_SPREAD x the bf16 plain step's own distance from
        it + BF16_GRAD_FLOOR of scale: the loss and every gradient."""
        loss_bar = (BF16_GRAD_SPREAD * abs(plain16[0] - plain32[0])
                    + BF16_GRAD_FLOOR * abs(plain32[0]))
        loss_err = abs(kern16[0] - plain32[0])
        rows = []
        for n, g32 in plain32[1].items():
            scale = max(float(g32.abs().max()), 1e-30)
            e_k = float((kern16[1][n] - g32).abs().max()) / scale
            e_p = float((plain16[1][n] - g32).abs().max()) / scale
            bar = BF16_GRAD_SPREAD * e_p + BF16_GRAD_FLOOR
            rows.append((e_k / bar, e_k, e_p, bar, n))
        rows.sort()
        worst = rows[-1]

        def median(values):
            return sorted(values)[len(rows) // 2]

        tight = sum(r[3] <= 0.1 for r in rows)
        print(f"train bf16 vs fp32 plain: loss |kernels - fp32| "
              f"{loss_err:.4e}, |plain bf16 - fp32| "
              f"{abs(plain16[0] - plain32[0]):.4e} (bar {loss_bar:.4e}); "
              f"gradient error / scale, median over the {len(rows)} "
              f"parameters: kernels bf16 {median(r[1] for r in rows):.3e}, "
              f"plain bf16 {median(r[2] for r in rows):.3e}, bar "
              f"{median(r[3] for r in rows):.3e}; {tight} bars at 0.1 or "
              f"under; ratio kernels / plain bf16 median "
              f"{median(r[1] / max(r[2], 1e-30) for r in rows):.3f}; most "
              f"of its bar used: {worst[4]} {worst[1]:.3e} of bar "
              f"{worst[3]:.3e} ({worst[0]:.3f})")
        if not (np.isfinite(kern16[0]) and loss_err <= loss_bar
                and worst[0] <= 1):
            raise AssertionError(f"train bf16 kernels vs fp32 plain: loss "
                                 f"{loss_err} (bar {loss_bar}), gradient "
                                 f"{worst}")

    # (a) kernels vs plain twins, float32 then bfloat16; (b) launches
    want = train_launches(cfg)
    runs = {}
    for half in (False, True):
        kern = grads_of(half, plain=False)
        plain = grads_of(half, plain=True)
        name = "bf16" if half else "fp32"
        print(f"train step {name} (remat on): kernels {kern[4]:.2f} s, "
              f"peak {kern[3]:.2f} GB; plain twins {plain[4]:.2f} s; "
              f"launches {kern[2]}, attention launches by body {kern[5]} "
              f"on {card}")
        if half:
            compare("bf16 kernels vs plain", kern, plain,
                    TRAIN_BF16_LOSS_TOL)
            against_fp32(kern, plain, runs["fp32_plain"])
        else:
            compare("fp32 kernels vs plain", kern, plain, TRAIN_TOL,
                    TRAIN_TOL)
            runs["fp32_plain"] = plain
        got = {k: kern[2][k] for k in want}
        if got != want or not all(n > 0 for n in got.values()):
            raise AssertionError(f"train step {name}: launches {got}, "
                                 f"expected {want}")
        body = "mma" if half else "simt"
        for kernel, ran in kern[5].items():
            expect = dict.fromkeys(ran, 0)
            expect[body] = kern[2][kernel]
            if ran != expect:
                raise AssertionError(f"train step {name}: {kernel} ran "
                                     f"{ran}, expected every launch on the "
                                     f"{body} body: {expect}")
        if any(plain[2].values()):
            raise AssertionError(f"train step {name} under plain_ops "
                                 f"launched {plain[2]}")
        runs[name] = kern
        del plain
    counts = runs["bf16"][2]
    # (c) remat off vs on, float32
    off = grads_of(False, plain=False, remat=False)
    print(f"train step fp32: max_memory_allocated remat on "
          f"{runs['fp32'][3]:.2f} GB, off {off[3]:.2f} GB; "
          f"{runs['fp32'][4]:.2f} vs {off[4]:.2f} s on {card}")
    compare("fp32 remat off vs on", off, runs["fp32"], TRAIN_TOL, TRAIN_TOL)
    if any(off[2][k] * 2 != runs["fp32"][2][k] for k in TRAIN_KERNELS):
        raise AssertionError(f"remat off launched {off[2]}")
    del runs, off
    torch.cuda.empty_cache()
    # (d) five bf16 AdamW steps on the one batch
    model = copy.deepcopy(base[True]).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=bench.TRAIN_LR,
                            weight_decay=bench.TRAIN_WEIGHT_DECAY,
                            eps=bench.TRAIN_EPS)
    step = make_train_step(model, opt, half=True)
    state = create_train_state(model, opt)
    losses = []
    for _ in range(TRAIN_STEPS):
        state, parts = step(state, tb, labels, bench.TRAIN_SEED)
        losses.append(float(parts["total_loss"]))
    print(f"train: {TRAIN_STEPS} bf16 AdamW steps on request 0: loss "
          f"{[round(v, 5) for v in losses]}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train: the loss does not fall: {losses}")
    del model, opt, step, state, base
    torch.cuda.empty_cache()
    # (e) the training bench
    for flags in TRAIN_BENCH_RUNS:
        with tempfile.TemporaryDirectory() as trace_dir:
            env = dict(os.environ)
            traced = flags == TRAIN_BENCH_RUNS[0]
            if traced:
                env["BENCH_TRACE_DIR"] = trace_dir
            res = subprocess.run(
                [sys.executable, "-m", "hmvit_tpu_torch.bench", *flags],
                capture_output=True, text=True, env=env, timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"bench {' '.join(flags)} failed "
                                     f"({res.returncode}):\n{res.stderr}")
            record = json.loads(res.stdout.strip().splitlines()[-1])
            print(f"bench {' '.join(flags)}: {json.dumps(record)} on {card}")
            if record.get("train_mfu") is None or not record["value"] > 0 \
                    or not record.get("hbm_peak_gb"):
                raise AssertionError(f"bench {' '.join(flags)}: no rate, "
                                     f"MFU or peak memory: {record}")
            if traced:
                from hmvit_tpu_torch.ops import TWIN_BACKWARD
                from hmvit_tpu_torch.tools.profile import summarize

                print("bench --train: device time of one traced step by "
                      "class (hmvit_tpu_torch.tools.profile, ms/step):")
                summarize(trace_dir, top=15, frames=1, ranges=TWIN_BACKWARD)
    return counts


def gate_phase(dev, card) -> dict:
    """Phase 9 (see the module's docstring): the accuracy gate's path at
    production shapes.  Returns each kernel's launches over the train
    steps and the eval forward."""
    import torch

    from hmvit_tpu_torch import prod_overfit as gate
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.ops import cuda
    from hmvit_tpu_torch.postprocess import AnchorPostprocessor
    from hmvit_tpu_torch.train.trainer import (
        create_train_state,
        make_forward,
        make_train_step,
    )

    args = gate.parse_args([])
    cfg, lidar_range = gate.gate_config(args.grid)
    pp_cfg = gate.postprocess_config(args.grid, lidar_range)
    pp_train = AnchorPostprocessor(pp_cfg, train=True)
    pp_eval = AnchorPostprocessor(pp_cfg, train=False)
    anchors = pp_train.generate_anchor_box()
    # (a) the fixture on disk, loaded, collated, labelled
    t0 = time.perf_counter()
    batches, labels, gt, load_ms = gate.load_gate_data(
        args, lidar_range, pp_train, anchors, dev)
    print(f"gate: fixture written and {len(batches)} frames loaded in "
          f"{time.perf_counter() - t0:.2f} s; loading {load_ms:.1f} ms a "
          f"frame (host, median); ground-truth boxes "
          f"{[len(g) for g in gt]}, positive anchors "
          f"{[int(lab['pos_equal_one'].sum()) for lab in labels]} on {card}")
    # (b) the oracle decode: the labels as outputs
    aps = gate.average_precision([gate.oracle_outputs(lab) for lab in labels],
                                 gt, pp_eval, anchors)
    print(f"gate: oracle decode AP@0.3 / 0.5 / 0.7 = {aps}")
    if aps != (1.0, 1.0, 1.0):
        raise AssertionError(f"gate: the oracle decode scores {aps}, not 1.0 "
                             f"at every threshold")
    # (c) bf16 train steps with remat, launches per step
    model = init_parameters(HMViT(cfg), seed=args.seed).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr, **gate.ADAMW)
    step = make_train_step(model, opt, half=True)
    state = create_train_state(model, opt)
    want = train_launches(cfg)
    total = dict.fromkeys(KERNEL_META, 0)
    losses = []
    t0 = time.perf_counter()
    for k in range(GATE_STEPS):
        cuda.reset_launches()
        state, parts = step(state, batches[k % len(batches)],
                            labels[k % len(batches)], 1)
        losses.append(float(parts["total_loss"]))
        counts = cuda.launch_counts()
        for name in total:
            total[name] += counts[name]
        got = {name: counts[name] for name in want}
        if got != want:
            raise AssertionError(f"gate step {k}: launches {got}, expected "
                                 f"{want}")
    seconds = time.perf_counter() - t0
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"gate: {GATE_STEPS} bf16 remat AdamW steps in {seconds:.2f} s "
          f"(first one included), loss {[round(v, 4) for v in losses]}; "
          f"mean of the first 5 {first:.4f}, of the last 5 {last:.4f}; "
          f"launches a step {want} on {card}")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"gate: the loss is not finite or does not "
                             f"fall: {losses}")
    # (d) the eval forward (the configuration's bf16 fusion), decode, AP
    fwd = make_forward(model)
    cuda.reset_launches()
    outs, eval_ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fwd(state, b))
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    counts = cuda.launch_counts()
    for name in total:
        total[name] += counts[name]
    aps = gate.average_precision(outs, gt, pp_eval, anchors)
    forward = {name: counts[name] for name in want}
    print(f"gate: eval forward {[round(v, 2) for v in eval_ms]} ms a frame "
          f"on {card}; launches over {len(batches)} frames {forward}; "
          f"AP@0.3 / 0.5 / 0.7 after {GATE_STEPS} steps = {aps} (not held)")
    expect = {name: n * len(batches) for name, n in
              train_launches(dict(cfg, remat=False)).items()}
    if forward != expect:
        raise AssertionError(f"gate eval forward: launches {forward}, "
                             f"expected {expect}")
    for out in outs:
        if not all(torch.isfinite(out[k].float()).all() for k in ("psm",
                                                                   "rm")):
            raise AssertionError("gate eval forward: non-finite outputs")
    del model, opt, step, state, batches, labels, outs
    torch.cuda.empty_cache()
    return total


def add_keyed(keyed) -> None:
    """Add the plain kernel's launches since the last reset, by (tokens T,
    operand type) and by body (keys ("body", "simt" | "mma")), to
    ``keyed`` when it is given."""
    from hmvit_tpu_torch.ops import cuda

    if keyed is None:
        return
    for key, n in cuda.PLAIN_WINDOW_ATTENTION.launches_by_key.items():
        keyed[key] = keyed.get(key, 0) + n
    for body, n in cuda.attention_body_launches()[
            "plain_window_attention"].items():
        keyed["body", body] = keyed.get(("body", body), 0) + n


def tools_train(hypes, flags, steps, want, tmp, total, keyed=None):
    """``tools.train`` of ``hypes`` into a new run directory under ``tmp``:
    every step's launches held to ``want``, every launch (the validation
    forwards' too) added to ``total`` (and to ``keyed``: ``add_keyed``);
    returns (run dir, losses, seconds a step after the first)."""
    import os
    import tempfile

    from hmvit_tpu_torch.ops import cuda
    from hmvit_tpu_torch.tools import train

    losses, stamps = [], []

    def add(counts):
        for name in total:
            total[name] += counts[name]

    def on_step(epoch, step, metrics):
        losses.append(float(metrics["total_loss"]))  # synchronises
        stamps.append(time.perf_counter())
        counts = cuda.launch_counts()
        add_keyed(keyed)
        cuda.reset_launches()
        add(counts)
        got = {name: counts[name] for name in want}
        if got != want:
            raise AssertionError(f"tools.train {os.path.basename(hypes)}"
                                 f" step {len(losses) - 1}: launches "
                                 f"{got}, expected {want}")

    run = tempfile.mkdtemp(prefix="chip_smoke_run_", dir=tmp)
    cuda.reset_launches()
    train.main(["--hypes_yaml", hypes, "--model_dir", run, "--synthetic",
                "--epoches", "1", "--steps_per_epoch", str(steps),
                *flags], on_step=on_step)
    add(cuda.launch_counts())  # the validation forwards
    add_keyed(keyed)
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"tools.train {hypes}: losses {losses}")
    for path in ("config.yaml", os.path.join("ckpt", "1", "state.pt")):
        if not os.path.exists(os.path.join(run, path)):
            raise AssertionError(f"tools.train {hypes}: no {path}")
    per_step = ((stamps[-1] - stamps[0]) / (steps - 1) if steps > 1
                else None)
    return run, losses, per_step


def serve_run_dir(run, cfg, dev, card, total, what, keyed=None):
    """``tools.inference --bf16 --serving_buckets`` on a run directory
    (a captured CUDA graph per fleet bucket): AP (not held), end-to-end
    fps, p50 and p95 printed, each bucket's launches held to
    ``serving_launches`` of the model configuration ``cfg``, every launch
    added to ``total``; then one frame served by a captured graph and by
    the eager bf16 forward of the same model: psm, rm and the decoded
    boxes equal bit for bit."""
    import torch

    from hmvit_tpu_torch.data.opv2v import HeteroCooperativeDataset
    from hmvit_tpu_torch.ops import cuda
    from hmvit_tpu_torch.postprocess import build_postprocessor
    from hmvit_tpu_torch.serving import GEOMETRY_KEYS
    from hmvit_tpu_torch.tools import common, inference

    cuda.reset_launches()
    res = inference.main(["--model_dir", run, "--synthetic",
                          "--synthetic_frames", str(RUN_DIR_FRAMES),
                          "--bf16", "--serving_buckets", "--max_frames",
                          str(RUN_DIR_FRAMES), "--ap_mode", "iou"])
    for name, n in cuda.launch_counts().items():
        total[name] += n
    add_keyed(keyed)
    iou, e2e = res["iou"], res["e2e"]
    print(f"tools.inference {what} --bf16 --serving_buckets: AP@0.3 / 0.5 / "
          f"0.7 {iou['ap_30']:.4f} / {iou['ap_50']:.4f} / "
          f"{iou['ap_70']:.4f} (not held); e2e {e2e['fps']} fps over "
          f"{e2e['frames']} frames, p50 {e2e['p50_ms']} ms, p95 "
          f"{e2e['p95_ms']} ms on {card}")
    want = train_launches(dict(cfg, remat=False))
    for b in res["serving"]["buckets"]:
        cams = b["hints"]["camera_bucket"]
        got = {name: b["launches"][name] for name in want}
        expect = serving_launches(cfg, cams)
        print(f"  bucket {b['hints']}: capture {b['capture_s']} s, "
              f"launches a frame {got}")
        if got != expect:
            raise AssertionError(f"tools.inference {what} bucket "
                                 f"{b['hints']}: launches {got}, expected "
                                 f"{expect}")
    # one frame: the captured graph against the eager bf16 forward
    model, params = common.load_runnable(run, dev)
    model = model.to(torch.bfloat16)
    common.write_synthetic(params, "chip_smoke_frame_", 60000,
                           num_scenarios=1, num_cavs=2, num_frames=1)
    ds = HeteroCooperativeDataset(params, train=False)
    pp = build_postprocessor(params["postprocess"], train=False)
    anchors = pp.generate_anchor_box()
    frame = ds[0]
    req = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32
               and k not in GEOMETRY_KEYS else v)
           for k, v in common.to_device(ds.collate_batch([frame]),
                                        dev).items()}
    hints = inference.fleet_hints(frame)
    graph = inference.GraphServing(model, anchors)(req, hints)
    graph = {k: v.clone() for k, v in graph.items()}
    with torch.no_grad():
        eager = model(req, **hints)
    boxes = []
    for out in (graph, eager):
        boxes.append(pp.post_process(
            {0: {"transformation_matrix": np.eye(4),
                 "anchor_box": anchors, "no_post_projection": True}},
            {0: {k: out[k] for k in ("psm", "rm")}}))
    same = all(torch.equal(graph[k], eager[k]) for k in ("psm", "rm"))
    (gc, gs), (ec, es) = boxes
    same_boxes = ((gc is None and ec is None)
                  or (gc is not None and ec is not None
                      and np.array_equal(gc, ec)
                      and np.array_equal(gs, es)))
    print(f"tools.inference {what} graph vs eager bf16, one frame of fleet "
          f"{hints['static_modes']}: psm / rm bit for bit {same}, boxes "
          f"({0 if gc is None else len(gc)}) bit for bit {same_boxes}")
    if not (same and same_boxes):
        raise AssertionError(f"tools.inference {what}: the captured graph's "
                             f"outputs differ from the eager forward's")
    del model, graph, eager
    torch.cuda.empty_cache()
    return res


def run_dir_phase(dev, card) -> dict:
    """Phase 10 (see the module's docstring): the run-directory tools.
    Returns each kernel's launches over the phase."""
    import os
    import tempfile

    import torch

    from hmvit_tpu_torch.config import load_config

    repo = os.path.dirname(os.path.abspath(__file__))
    total = dict.fromkeys(KERNEL_META, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase10_") as tmp:
        # (a) production width, bf16 with remat
        hypes = os.path.join(repo, HYPES, "hmvit_prod_serving.yaml")
        cfg = dict(load_config(hypes)["model"]["args"], remat=True)
        want = train_launches(cfg)
        t0 = time.perf_counter()
        run, losses, per_step = tools_train(
            hypes, ["--half", "--remat"], RUN_DIR_STEPS, want, tmp, total)
        print(f"tools.train hmvit_prod_serving --half --remat: "
              f"{RUN_DIR_STEPS} steps, {time.perf_counter() - t0:.2f} s with "
              f"the fixture, validation and checkpoint; "
              f"{1.0 / per_step:.3f} steps/s after the first; loss "
              f"{[round(v, 4) for v in losses]}; launches a step {want} on "
              f"{card}")
        # (b) the run directory served: captured graphs per fleet bucket
        serve_run_dir(run, cfg, dev, card, total, "hmvit_prod_serving")
        # (c) the cross-view transformer camera encoder on the card
        hypes = os.path.join(repo, HYPES, "smoke_hetero_tiny.yaml")
        want = train_launches(load_config(hypes)["model"]["args"])
        _, losses, _ = tools_train(hypes, [], 2, want, tmp, total)
        print(f"tools.train smoke_hetero_tiny (cvt camera encoder): loss "
              f"{[round(v, 4) for v in losses]}, launches a step {want}")
    torch.cuda.empty_cache()
    return total


def zoo_forwards(dev, card, total, names=tuple(ZOO_CAMERAS)) -> None:
    """Phase 11 (c): HMViT of ``smoke_hetero_tiny.yaml`` with each camera
    configuration of ZOO_CAMERAS (those of ``names``), float32, one
    forward with the kernels and one under ``plain_ops()``: sigmoid(psm)
    and rm within FORWARD_ATOL over max(1, max |x|), every output
    finite, and the kernels' launches those of a served frame
    (``serving_launches``); then the forward captured by
    ``CompiledServer`` and replayed: equal to the eager forward bit for
    bit."""
    import copy
    import os

    import torch

    from hmvit_tpu_torch.config import load_config
    from hmvit_tpu_torch.data.synthetic import make_hetero_batch
    from hmvit_tpu_torch.graph_server import CompiledServer
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.ops import cuda, plain_ops
    from hmvit_tpu_torch.serving import batch_to_device, serving_hints
    from hmvit_tpu_torch.utils.precision import strict_fp32

    repo = os.path.dirname(os.path.abspath(__file__))
    params = load_config(os.path.join(repo, HYPES, "smoke_hetero_tiny.yaml"))
    base = params["model"]["args"]
    batch, _ = make_hetero_batch(
        seed=3, max_cav=2, num_agents=2, max_points=512, image_size=64,
        num_cams=4, camera_ratio=0.5, ego_mode="lidar",
        lidar_range=params["preprocess"]["cav_lidar_range"])
    batch["mode"][:, :2] = (1, 0)  # a lidar ego and a camera agent
    tb = batch_to_device(batch, dev, bf16=False)
    hints = serving_hints(batch["mode"][0], 2)
    # decode's operands (the boxes are not read here)
    anchors = torch.zeros((16, 16, 2, 7), device=dev)
    eye = torch.eye(4, device=dev)
    for name in names:
        camera, model_keys = ZOO_CAMERAS[name]
        cfg = dict(copy.deepcopy(base), **model_keys)
        cfg["camera"] = dict(cfg["camera"], **camera)
        model = init_parameters(HMViT(cfg), seed=0).to(dev)
        cuda.reset_launches()
        with torch.no_grad(), strict_fp32():
            out_k = model(tb, **hints)
            counts = cuda.launch_counts()
            with plain_ops():
                out_p = model(tb, **hints)
        torch.cuda.synchronize()
        if cuda.launch_counts() != counts:
            raise AssertionError(f"phase 11 {name}: the plain forward "
                                 f"launched kernels")
        for kernel, n in counts.items():
            total[kernel] += n
        want = serving_launches(cfg, hints["camera_bucket"])
        got = {kernel: counts[kernel] for kernel in want}
        logit = float((out_k["psm"] - out_p["psm"]).abs().max())
        errs = {}
        for key, fn in (("psm", torch.sigmoid), ("rm", lambda z: z)):
            a, b = fn(out_k[key].float()), fn(out_p[key].float())
            scale = max(1.0, float(b.abs().max()))
            errs[key] = float((a - b).abs().max()) / scale
            if not (torch.isfinite(a).all() and errs[key] <= FORWARD_ATOL):
                raise AssertionError(f"phase 11 {name}: fp32 {key} kernels "
                                     f"vs plain {errs[key]} (tol "
                                     f"{FORWARD_ATOL})")
        # the same forward captured in a CUDA graph (the serving path)
        with strict_fp32():
            server = CompiledServer(model, hints, tb, anchors, eye)
            graph, _ = server(tb)
        same = all(torch.equal(graph[k], out_k[k]) for k in ("psm", "rm"))
        cpu = ""
        if name in ZOO_TWINS:
            # the card's plain forward: the same arithmetic as the CPU's
            cpu_errs = card_vs_cpu(model, tb, hints, out_p)
            cpu = (f"; card (plain_ops) vs CPU max_abs_err/scale psm "
                   f"{cpu_errs['psm']:.3e}, rm {cpu_errs['rm']:.3e} (tol "
                   f"{SEG_LIDAR_ATOL})")
            if max(cpu_errs.values()) > SEG_LIDAR_ATOL:
                raise AssertionError(f"phase 11 {name}: card vs CPU "
                                     f"{cpu_errs} (tol {SEG_LIDAR_ATOL})")
        print(f"phase 11 {name}: fp32 forward kernels vs plain "
              f"max_abs_err/scale psm {errs['psm']:.3e}, rm "
              f"{errs['rm']:.3e} (tol {FORWARD_ATOL}; logits {logit:.3e}, "
              f"not held); launches {got}, none under plain_ops; graph == "
              f"eager bit for bit {same}{cpu}")
        if got != want:
            raise AssertionError(f"phase 11 {name}: launches {got}, "
                                 f"expected {want}")
        if not same:
            raise AssertionError(f"phase 11 {name}: the captured graph's "
                                 f"outputs differ from the eager forward's")
        del model, out_k, out_p, server, graph
    torch.cuda.empty_cache()


def card_vs_cpu(model, batch, hints, out) -> dict:
    """The same model's float32 forward on the CPU (a copy, plain twins)
    against ``out``, the card's: sigmoid(psm) and rm, max |error| over
    max(1, max |x|) each."""
    import copy

    import torch

    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        ref = cpu({k: v.cpu() for k, v in batch.items()}, **hints)
    return scaled_errors(out, ref)


def scaled_errors(out, ref) -> dict:
    """sigmoid(psm) and rm of ``out`` against ``ref``'s: max |error| over
    max(1, max |ref|) each (inf where ``out`` is not finite)."""
    import torch

    errs = {}
    for key, fn in (("psm", torch.sigmoid), ("rm", lambda z: z)):
        a, b = fn(out[key].float().cpu()), fn(ref[key].float().cpu())
        scale = max(1.0, float(b.abs().max()))
        errs[key] = (float((a - b).abs().max()) / scale
                     if torch.isfinite(a).all() else float("inf"))
    return errs


def s2d_check(dev, card) -> None:
    """Phase 11 (e): the space-to-depth stem against the plain stem on the
    same weights, float32 (TF32 off), held within S2D_TOL (atol = rtol)
    where the JAX package sets that bar (ResNet-18 stage 1, 2 x 64^2,
    ``tests/test_resnet.py``) and on the stem's own output at the
    production shape (4 x 512^2); the ResNet-50 stage-1 output at 512^2
    printed beside a float64 forward of both (not held: three bottleneck
    blocks amplify the stems' float32 rounding); then ``python -m
    hmvit_tpu_torch.bench`` and ``--stem_s2d``, both frames/s printed."""
    import torch

    from hmvit_tpu_torch.models.resnet import ResNetEncoder, s2d_stem
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.utils.precision import strict_fp32

    gen = torch.Generator(device=dev).manual_seed(0)

    def hold(what, got, want):
        err = float((got - want).abs().max())
        worst = float(((got - want).abs() - S2D_TOL * want.abs()).max())
        print(f"phase 11 s2d stem vs plain stem, {what}: max_abs_err "
              f"{err:.3e} (atol = rtol = {S2D_TOL}) on {card}")
        if not (torch.isfinite(got).all() and worst <= S2D_TOL):
            raise AssertionError(f"phase 11: the s2d stem differs from the "
                                 f"plain stem ({what}): {err}")

    with torch.no_grad(), strict_fp32():
        enc = init_parameters(ResNetEncoder("resnet18", (1,)), seed=0)
        enc = enc.to(dev)
        x = torch.randn((2, 64, 64, 3), generator=gen, device=dev)
        plain = enc(x)
        enc.stem_s2d = True
        hold("ResNet-18 stage 1, 2 x 64^2", enc(x), plain)
        enc = init_parameters(ResNetEncoder("resnet50", (1,)), seed=0)
        enc = enc.to(dev)
        x = torch.randn((4, 512, 512, 3), generator=gen, device=dev)
        hold("the stem's 7x7 / 2 output, 4 x 512^2",
             s2d_stem(x, enc.Conv_0.weight), enc.Conv_0(x))
        outs = {}
        for s2d in (False, True):
            enc.stem_s2d = s2d
            outs[s2d] = enc(x)
            outs[s2d, "f64"] = enc.double()(x.double())
            enc.float()
        ref = outs[False, "f64"]
        print(f"phase 11 ResNet-50 stage 1, 4 x 512^2 (not held): s2d vs "
              f"plain {float((outs[True] - outs[False]).abs().max()):.3e}; "
              f"against the plain stem in float64: plain "
              f"{float((outs[False] - ref).abs().max()):.3e}, s2d "
              f"{float((outs[True] - ref).abs().max()):.3e}; float64 s2d vs "
              f"plain {float((outs[True, 'f64'] - ref).abs().max()):.3e}; "
              f"max |x| {float(ref.abs().max()):.3f}")
    del enc, x, plain, outs, ref
    torch.cuda.empty_cache()
    fps = {}
    for flags in ((), ("--stem_s2d",)):
        res = subprocess.run(
            [sys.executable, "-m", "hmvit_tpu_torch.bench", *flags],
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"bench {' '.join(flags)} failed "
                                 f"({res.returncode}):\n{res.stderr}")
        record = json.loads(res.stdout.strip().splitlines()[-1])
        fps[" ".join(flags) or "plain stem"] = record["value"]
        if not record["value"] > 0:
            raise AssertionError(f"bench {' '.join(flags)}: {record}")
    print(f"phase 11 bench frames/s: {fps} on {card}")


def zoo_phase(dev, card) -> dict:
    """Phase 11 (see the module's docstring): every camera encoder of the
    zoo under HM-ViT.  Returns each kernel's launches over the phase."""
    import copy
    import os
    import tempfile

    import torch

    from hmvit_tpu_torch.config import load_config, save_config

    t_start = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    total = dict.fromkeys(KERNEL_META, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase11_") as tmp:
        # (a), (b) the corpus's FAX and BEVFormer hetero configurations
        for name in ZOO_HYPES:
            hypes = os.path.join(repo, HYPES, name)
            cfg = load_config(hypes)["model"]["args"]
            want = train_launches(cfg)
            t0 = time.perf_counter()
            run, losses, per_step = tools_train(
                hypes, ["--half"], ZOO_TRAIN_STEPS, want, tmp, total)
            print(f"tools.train {name} --half: {ZOO_TRAIN_STEPS} steps, "
                  f"{time.perf_counter() - t0:.2f} s with the fixture, "
                  f"validation and checkpoint; {1.0 / per_step:.3f} steps/s "
                  f"after the first; loss {[round(v, 4) for v in losses]}; "
                  f"launches a step {want} on {card}")
            serve_run_dir(run, cfg, dev, card, total, name)
        # (c) every camera encoder, kernels vs twins
        zoo_forwards(dev, card, total)
        # (d) the deformable lift at the BEVFormer configuration's widths
        params = load_config(os.path.join(repo, HYPES, ZOO_HYPES[1]))
        params = copy.deepcopy(params)
        params["model"]["args"]["camera"]["lift"] = "deformable"
        hypes = os.path.join(tmp, "bevformer_deformable.yaml")
        save_config(params, hypes)
        want = train_launches(params["model"]["args"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, losses, _ = tools_train(hypes, ["--half"], DEFORMABLE_STEPS, want,
                                   tmp, total)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"tools.train {ZOO_HYPES[1]} with lift: deformable --half: "
              f"loss {[round(v, 4) for v in losses]}, launches a step "
              f"{want}, peak device memory {peak:.3f} GiB on {card}")
        torch.cuda.empty_cache()
    # (e) the space-to-depth stem
    s2d_check(dev, card)
    print(f"phase 11: {time.perf_counter() - t_start:.1f} s on {card}")
    return total


def fusion_forwards(dev, card, total, keyed) -> None:
    """Phase 12 (a): HMViT of ``smoke_hetero_tiny.yaml`` with each fusion
    of ZOO_FUSIONS as its ``fusion_override`` (V2X-ViT with the batch's
    prior encoding), float32, as phase 11 (c) holds each camera encoder:
    the kernels' forward against ``plain_ops()`` (which launches nothing)
    within FORWARD_ATOL over max(1, max |x|), the launches those of a
    served frame, each plain launch's tokens and type printed, and the
    forward captured by ``CompiledServer`` equal to the eager one bit for
    bit."""
    import copy
    import os

    import torch

    from hmvit_tpu_torch.config import load_config
    from hmvit_tpu_torch.data.synthetic import make_hetero_batch
    from hmvit_tpu_torch.graph_server import CompiledServer
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.ops import cuda, plain_ops
    from hmvit_tpu_torch.serving import batch_to_device, serving_hints
    from hmvit_tpu_torch.utils.precision import strict_fp32

    repo = os.path.dirname(os.path.abspath(__file__))
    params = load_config(os.path.join(repo, HYPES, "smoke_hetero_tiny.yaml"))
    base = params["model"]["args"]
    batch, _ = make_hetero_batch(
        seed=3, max_cav=2, num_agents=2, max_points=512, image_size=64,
        num_cams=4, camera_ratio=0.5, ego_mode="lidar",
        lidar_range=params["preprocess"]["cav_lidar_range"])
    batch["mode"][:, :2] = (1, 0)  # a lidar ego and a camera agent
    batch["prior_encoding"][0, :2] = ((0.3, 0.0, 0.0), (0.1, 12.0, 1.0))
    tb = batch_to_device(batch, dev, bf16=False)
    hints = serving_hints(batch["mode"][0], 2)
    anchors = torch.zeros((16, 16, 2, 7), device=dev)
    eye = torch.eye(4, device=dev)
    for fusion in ZOO_FUSIONS:
        cfg = dict(copy.deepcopy(base), fusion_override=fusion)
        model = init_parameters(HMViT(cfg), seed=0).to(dev)
        cuda.reset_launches()
        with torch.no_grad(), strict_fp32():
            out_k = model(tb, **hints)
            counts = cuda.launch_counts()
            by_key = dict(cuda.PLAIN_WINDOW_ATTENTION.launches_by_key)
            bodies = cuda.attention_body_launches()["plain_window_attention"]
            add_keyed(keyed)
            with plain_ops():
                out_p = model(tb, **hints)
        torch.cuda.synchronize()
        if cuda.launch_counts() != counts:
            raise AssertionError(f"phase 12 {fusion}: the plain forward "
                                 f"launched kernels")
        for kernel, n in counts.items():
            total[kernel] += n
        want = serving_launches(cfg, hints["camera_bucket"])
        got = {kernel: counts[kernel] for kernel in want}
        errs = {}
        for key, fn in (("psm", torch.sigmoid), ("rm", lambda z: z)):
            a, b = fn(out_k[key].float()), fn(out_p[key].float())
            scale = max(1.0, float(b.abs().max()))
            errs[key] = float((a - b).abs().max()) / scale
            if not (torch.isfinite(a).all() and errs[key] <= FORWARD_ATOL):
                raise AssertionError(f"phase 12 {fusion}: fp32 {key} kernels "
                                     f"vs plain {errs[key]} (tol "
                                     f"{FORWARD_ATOL})")
        with strict_fp32():
            server = CompiledServer(model, hints, tb, anchors, eye)
            graph, _ = server(tb)
        same = all(torch.equal(graph[k], out_k[k]) for k in ("psm", "rm"))
        print(f"phase 12 fusion_override {fusion}: fp32 forward kernels vs "
              f"plain max_abs_err/scale psm {errs['psm']:.3e}, rm "
              f"{errs['rm']:.3e} (tol {FORWARD_ATOL}); launches {got}, plain "
              f"launches by (T, type) {by_key}, by body {bodies}, none under "
              f"plain_ops; graph == eager bit for bit {same}")
        if got != want:
            raise AssertionError(f"phase 12 {fusion}: launches {got}, "
                                 f"expected {want}")
        if not same:
            raise AssertionError(f"phase 12 {fusion}: the captured graph's "
                                 f"outputs differ from the eager forward's")
        del model, out_k, out_p, server, graph
    torch.cuda.empty_cache()


def v2xvit_attention(dev, card) -> dict:
    """Phase 12 (b): K3 at V2X-ViT's shapes (the point_pillar_v2xt map,
    V2XVIT_MAP; windows V2XVIT_WINDOWS, one sender, every key live), in
    float32 and bfloat16 against its plain twin at phase 2's tolerances;
    the body each launch ran, ``ms`` (the kernel alone, one call between
    CUDA events, median of 20), the plain twin's, the bound (bytes once at
    PEAK_BYTES_PER_S or the operations at the type's peak) and
    ``library_ms`` (``scaled_dot_product_attention`` with the bias as its
    ``attn_mask``, timed only).  Returns {window: record}."""
    import torch
    import torch.nn.functional as F

    from hmvit_tpu_torch.ops import cuda, opcount, plain_ops
    from hmvit_tpu_torch.ops.window_attention import (
        attention_body,
        fused_plain_window_attention,
        plain_window_attention_launch,
    )
    from hmvit_tpu_torch.utils.precision import strict_fp32

    n, hw, c, heads, d = V2XVIT_MAP
    gen = torch.Generator(device=dev).manual_seed(12)
    records = {}
    for win in V2XVIT_WINDOWS:
        t, nwin = win * win, (hw // win) ** 2
        q32 = torch.randn(n, nwin, t, c, generator=gen, device=dev) * \
            d ** -0.5
        kv32 = torch.randn(n, 1, nwin, t, 2 * c, generator=gen, device=dev)
        bias = torch.randn(heads, t, t, generator=gen, device=dev) * 0.5
        rec = {}
        for dt, tol in ((torch.float32, FP32_ATOL),
                        (torch.bfloat16, BF16_ATOL["plain_window_attention"])):
            key = str(dt).split(".")[-1]
            q, kv = q32.to(dt), kv32.to(dt)
            mask = torch.ones(n, 1, nwin, t, dtype=dt, device=dev)
            args = (q, kv, bias, mask)
            before = cuda.attention_body_launches()["plain_window_attention"]
            with strict_fp32():
                got = fused_plain_window_attention(*args, heads, d)
                ran = cuda.attention_body_launches()["plain_window_attention"]
                with plain_ops():
                    want = fused_plain_window_attention(*args, heads, d)
            torch.cuda.synchronize()
            body = attention_body(dt, 1, t, d)
            ran = {b: ran[b] - before[b] for b in ran}
            if ran != {b: int(b == body) for b in ran}:
                raise AssertionError(f"K3 V2X-ViT window {win} {key}: ran "
                                     f"{ran}, expected one {body} launch")
            err = float((got.float() - want.float()).abs().max())
            if not np.isfinite(err) or err > tol:
                raise AssertionError(f"K3 V2X-ViT window {win} {key}: kernel "
                                     f"vs plain twin {err} > {tol}")
            launch, out = plain_window_attention_launch(*args, heads, d)
            k_ms = time_ms(launch)
            with plain_ops():
                p_ms = time_ms(lambda: fused_plain_window_attention(
                    *args, heads, d))
            # the library call: heads first, the bias as the additive mask
            # (every key live, so the mask adds nothing more)
            q4 = q.reshape(n * nwin, t, heads, d).transpose(1, 2).contiguous()
            k4 = kv[:, 0, ..., :c].reshape(n * nwin, t, heads, d).transpose(
                1, 2).contiguous()
            v4 = kv[:, 0, ..., c:].reshape(n * nwin, t, heads, d).transpose(
                1, 2).contiguous()
            add = bias.to(dt)[None].contiguous()
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=add, scale=1.0))
            b_ms, b_by = bound_ms(args, out, opcount.attention_ops(
                n, nwin, t, 1, heads, d), key)
            print(f"  K3 V2X-ViT window {win} (T={t}, N={n}, {nwin} windows "
                  f"a map) [{key}]: body {body}, max_abs_err {err:.3e} (tol "
                  f"{tol}); kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms, "
                  f"library call {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}) on {card}")
            rec[key] = {"body": body, "max_abs_err": err, "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms}
            del args, got, want, launch, out, q, kv, mask, q4, k4, v4, add
        records[win] = rec
        del q32, kv32, bias
        torch.cuda.empty_cache()
    return records


def fusion_zoo_phase(dev, card):
    """Phase 12 (see the module's docstring): the fusion zoo and the
    cooperative detection assemblies.  Returns each kernel's launches
    over the phase, the plain kernel's by (tokens, type) and by body, and
    the K3 records of V2X-ViT's windows."""
    import os
    import tempfile

    import torch

    from hmvit_tpu_torch.config import load_config, save_config
    from hmvit_tpu_torch.ops import cuda
    from hmvit_tpu_torch.tools import inference

    t_start = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    total = dict.fromkeys(KERNEL_META, 0)
    keyed = {}
    # (a) every fusion under the smoke HMViT
    fusion_forwards(dev, card, total, keyed)
    # (b) K3 at V2X-ViT's shapes
    k3 = v2xvit_attention(dev, card)
    # (c) published widths, through the tools
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase12_") as tmp:
        runs = {}
        for name, steps in FUSION_ZOO_TRAIN:
            hypes = os.path.join(repo, HYPES, name)
            model_cfg = load_config(hypes)["model"]
            want = model_launches(model_cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            runs[name], losses, per_step = tools_train(
                hypes, ["--half"], steps, want, tmp, total, keyed)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            rate = "" if per_step is None else \
                f"{1.0 / per_step:.3f} steps/s after the first; "
            print(f"tools.train {name} ({model_cfg['core_method']}) --half: "
                  f"{steps} steps, {time.perf_counter() - t0:.2f} s with the "
                  f"fixture, validation and checkpoint; {rate}loss "
                  f"{[round(v, 4) for v in losses]}; K3 launches a step "
                  f"{want['plain_window_attention']} (held); peak device "
                  f"memory {peak:.3f} GiB on {card}")
            torch.cuda.empty_cache()
        # the two V2X-ViT run directories served: HMViT by captured graphs
        # (graph == eager), the cooperative detector by its plain forward
        name = "opcl/fax_point_pillar_v2xt.yaml"
        cfg = dict(load_config(os.path.join(repo, HYPES, name))["model"][
            "args"], fusion_override="v2xvit")
        serve_run_dir(runs[name], cfg, dev, card, total, name, keyed)
        name = "point_pillar_v2xt.yaml"
        cuda.reset_launches()
        res = inference.main(["--model_dir", runs[name], "--synthetic",
                              "--synthetic_frames", str(RUN_DIR_FRAMES),
                              "--bf16", "--serving_buckets", "--max_frames",
                              str(RUN_DIR_FRAMES), "--ap_mode", "iou"])
        counts = cuda.launch_counts()
        bodies = cuda.attention_body_launches()["plain_window_attention"]
        by_key = dict(cuda.PLAIN_WINDOW_ATTENTION.launches_by_key)
        add_keyed(keyed)
        for kernel, n in counts.items():
            total[kernel] += n
        frames = res["e2e"]["frames"] + 1
        want = len(V2XVIT_WINDOWS) * frames
        iou, e2e = res["iou"], res["e2e"]
        print(f"tools.inference {name} --bf16 --serving_buckets (a "
              f"CooperativeDetector: its plain forward, no graphs): AP@0.3 / "
              f"0.5 / 0.7 {iou['ap_30']:.4f} / {iou['ap_50']:.4f} / "
              f"{iou['ap_70']:.4f} (not held); e2e {e2e['fps']} fps, p50 "
              f"{e2e['p50_ms']} ms, p95 {e2e['p95_ms']} ms; K3 launches "
              f"{counts['plain_window_attention']} over {frames} frames "
              f"(expected {want}), by (T, type) {by_key}, by body {bodies} "
              f"on {card}")
        if "serving" in res or counts["plain_window_attention"] != want:
            raise AssertionError(f"tools.inference {name}: served by graphs "
                                 f"or launches {counts} (expected {want} "
                                 f"plain)")
        # single-agent PointPillars through late fusion
        run = os.path.join(tmp, "late_fusion")
        os.makedirs(run)
        save_config(load_config(os.path.join(repo, HYPES, LATE_FUSION_HYPES)),
                    os.path.join(run, "config.yaml"))
        cuda.reset_launches()
        res = inference.main(["--model_dir", run, "--synthetic",
                              "--fusion_method", "late", "--max_frames",
                              str(LATE_FUSION_FRAMES), "--ap_mode", "iou"])
        counts = cuda.launch_counts()
        iou = res["iou"]
        print(f"tools.inference {LATE_FUSION_HYPES} --fusion_method late "
              f"(PointPillarDetector, random weights), {LATE_FUSION_FRAMES} "
              f"frames: AP@0.3 / 0.5 / 0.7 {iou['ap_30']:.4f} / "
              f"{iou['ap_50']:.4f} / {iou['ap_70']:.4f} (not held), "
              f"{res['e2e']['fps']} fps; launches {counts} on {card}")
        if any(counts.values()):
            raise AssertionError(f"late fusion: launches {counts}, expected "
                                 f"none (single-agent PointPillars)")
    torch.cuda.empty_cache()
    print(f"phase 12 plain launches by (T, type) and body: {keyed}")
    print(f"phase 12: {time.perf_counter() - t_start:.1f} s on {card}")
    return total, keyed, k3


# phase 13 (a): the smoke-width assemblies.  Camera: 4 x 64^2 cameras;
# lidar: +-20.48 m, the grids of tests/test_torch_lidar_zoo.py
SEG_LIDAR_RANGE = [-20.48, -20.48, -3.0, 20.48, 20.48, 1.0]
_CAMERA_TRUNK = {"dim": 32, "out_dim": 48,
                 "encoder_channels": [16, 16, 32, 32]}
_CVT = dict(_CAMERA_TRUNK, encoder="cvt", bev_size=4, num_blocks=1,
            decoder_layers=2)
_FAX = dict(_CAMERA_TRUNK, encoder="fax", bev_size=8, bev_window=4, depth=1,
            decoder_layers=1, heads=2, dim_head=16)
_SPATIAL = {"downsample_rate": 4, "voxel_size": [0.64, 0.64, 4.0]}
_VOXELNET = {"voxel_size": [0.64, 0.64, 0.5], "lidar_range": SEG_LIDAR_RANGE,
             "grid_size": [64, 64, 8], "anchor_number": 2, "vfe_filters": 16}
_SECOND = dict(_VOXELNET, voxel_size=[0.64, 0.64, 4.0 / 24],
               grid_size=[64, 64, 24], base_bev_backbone={
                   "layer_nums": [1, 1], "layer_strides": [1, 2],
                   "num_filters": [32, 32], "upsample_strides": [1, 2],
                   "num_upsample_filter": [32, 32]})
_PIXOR = {"res": 0.64, "downsample_rate": 4, "lidar_range": SEG_LIDAR_RANGE,
          "use_bn": True}
# (name, modality of the batch, model block)
SEG_LIDAR_ASSEMBLIES = (
    ("CameraSegmentor cvt", "camera",
     {"core_method": "cvt_seg", "args": {"camera": _CVT, "target": "both"}}),
    ("CameraSegmentor fax", "camera",
     {"core_method": "fax_fused_transformer",
      "args": {"camera": dict(_FAX, encoder="fax"), "target": "static"}}),
    ("CameraSegmentor vpn", "camera",
     {"core_method": "view_parse_network",
      "args": {"camera": dict(_CAMERA_TRUNK, bev_size=8, decoder_layers=1,
                              img_size=64)}}),
    ("CameraSegmentor bev_swap", "camera",
     {"core_method": "bev_swap",
      "args": {"camera": dict(_CAMERA_TRUNK, bev_size=8, window=4,
                              num_blocks=1, upsample=1, dim_head=16,
                              num_cams=4)}}),
    ("task: seg, F-Cooper", "camera",
     {"core_method": "cvt_fcooper",
      "args": {"camera": _CVT, "spatial_transform": _SPATIAL, "task": "seg",
               "anchor_number": 2}}),
    ("task: seg, SwapFusion", "camera",
     {"core_method": "corpbevt",
      "args": {"camera": _FAX, "spatial_transform": _SPATIAL, "task": "seg",
               "anchor_number": 2}}),
    ("VoxelNetDetector", "lidar",
     {"core_method": "voxel_net", "args": {"lidar": _VOXELNET}}),
    ("SecondDetector", "lidar",
     {"core_method": "second", "args": {"lidar": _SECOND}}),
    ("PIXORDetector", "lidar",
     {"core_method": "pixor", "args": {"lidar": _PIXOR}}),
    ("VoxelNetIntermediate", "lidar",
     {"core_method": "voxel_net_intermediate", "args": {"lidar": _VOXELNET}}),
    ("PixorIntermediate", "lidar",
     {"core_method": "pixor_intermediate", "args": {"lidar": _PIXOR}}),
    ("second_intermediate", "lidar",
     {"core_method": "second_intermediate",
      "args": {"lidar": _SECOND, "anchor_number": 2,
               "spatial_transform": dict(_SPATIAL, downsample_rate=8)}}),
)


def seg_lidar_forwards(dev, card, total) -> None:
    """Phase 13 (a): each assembly of SEG_LIDAR_ASSEMBLIES (weights from
    seed 0) on the card in float32 with TF32 off, against the same
    model's float32 forward on the CPU: every output within
    SEG_LIDAR_ATOL over max(1, max |x|), finite, and no kernel launched."""
    import torch

    from hmvit_tpu_torch.data.synthetic import make_hetero_batch
    from hmvit_tpu_torch.models.zoo import build_model
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.ops import cuda
    from hmvit_tpu_torch.utils.precision import strict_fp32

    batches = {}
    for modality, kw in (("camera", dict(max_points=64, image_size=64,
                                          num_cams=4, camera_ratio=1.0,
                                          ego_mode="camera")),
                         ("lidar", dict(max_points=2048, image_size=8,
                                        num_cams=1, camera_ratio=0.0,
                                        ego_mode="lidar"))):
        batch, _ = make_hetero_batch(seed=3, max_cav=3, num_agents=2,
                                     lidar_range=SEG_LIDAR_RANGE, **kw)
        if modality == "camera":
            batch["mode"][:] = 0
        batches[modality] = {k: torch.from_numpy(np.asarray(v))
                             for k, v in batch.items()}
    for name, modality, model_cfg in SEG_LIDAR_ASSEMBLIES:
        model = init_parameters(build_model(model_cfg), seed=0)
        with torch.no_grad():
            want = model(batches[modality])
        model = model.to(dev)
        on_card = {k: v.to(dev) for k, v in batches[modality].items()}
        cuda.reset_launches()
        with torch.no_grad(), strict_fp32():
            got = model(on_card)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        for kernel, n in counts.items():
            total[kernel] += n
        errs = {}
        for key, ref in want.items():
            out = got[key].float().cpu()
            scale = max(1.0, float(ref.abs().max()))
            errs[key] = float((out - ref).abs().max()) / scale
            if not (torch.isfinite(out).all() and errs[key] <= SEG_LIDAR_ATOL
                    and out.shape == ref.shape):
                raise AssertionError(f"phase 13 {name} {key}: card vs CPU "
                                     f"{errs[key]} (tol {SEG_LIDAR_ATOL})")
        if any(counts.values()):
            raise AssertionError(f"phase 13 {name}: launches {counts}")
        print(f"{name} ({model_cfg['core_method']}) fp32 on the card vs the "
              f"CPU: max_abs_err/scale "
              + ", ".join(f"{k} {tuple(got[k].shape)} {e:.3e}"
                          for k, e in errs.items())
              + f" (tol {SEG_LIDAR_ATOL}); no kernel launched")
        del model, got
    torch.cuda.empty_cache()


def seg_miou(run, dev, card) -> None:
    """Phase 13 (d): the cvt run directory's dynamic map on a fixture
    (2 frames), mIoU by ``seg_iou(seg_post_process(...))`` against the
    frames' map labels, printed (not held: 3 steps do not train)."""
    import torch

    from hmvit_tpu_torch.data.opv2v import HeteroCooperativeDataset
    from hmvit_tpu_torch.models.seg_head import seg_iou, seg_post_process
    from hmvit_tpu_torch.tools import common

    model, params = common.load_runnable(run, dev)
    common.write_synthetic(params, "chip_smoke_seg_", 60000,
                           num_scenarios=1, num_cavs=2, num_frames=2)
    ds = HeteroCooperativeDataset(params, train=False)
    mious = []
    for i in range(len(ds)):
        frame = ds[i]
        with torch.no_grad():
            out = seg_post_process(model(common.to_device(
                ds.collate_batch([frame]), dev)))
        pred = out["dynamic_map"][0].cpu().numpy()
        label = ds.seg_labels(frame, pred.shape)["dynamic_seg"]
        mious.append(seg_iou(pred, label)["miou"])
    print(f"seg mIoU of the cvt run directory on {len(ds)} fixture frames "
          f"(map ground truth, random-start weights after 3 steps; not "
          f"held): {[round(m, 4) for m in mious]} on {card}")
    del model
    torch.cuda.empty_cache()


def seg_lidar_zoo_phase(dev, card) -> dict:
    """Phase 13 (see the module's docstring): the segmentation
    assemblies and the lidar zoo.  Returns each kernel's launches over
    the phase (every one 0: no kernel runs on these paths)."""
    import os
    import tempfile

    import torch

    from hmvit_tpu_torch.config import load_config, save_config
    from hmvit_tpu_torch.ops import cuda
    from hmvit_tpu_torch.tools import inference

    t_start = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    total = dict.fromkeys(KERNEL_META, 0)
    none = dict.fromkeys(KERNEL_META, 0)
    # (a) each new assembly, card vs CPU
    seg_lidar_forwards(dev, card, total)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase13_") as tmp:
        # (b) published widths, through the tools
        runs = {}
        for name, steps, flags in SEG_LIDAR_TRAIN:
            hypes = os.path.join(repo, HYPES, name)
            params = load_config(hypes)
            model_cfg = params["model"]
            if name in SEG_LIDAR_ANCHOR_STRIDE:
                stride = SEG_LIDAR_ANCHOR_STRIDE[name]
                params["postprocess"]["anchor_args"]["feature_stride"] = stride
                hypes = os.path.join(tmp, f"anchor_stride_{stride}.yaml")
                save_config(params, hypes)
                print(f"{name}: anchors at feature stride {stride}, the "
                      f"stride of its outputs (the hypes says 4)")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            runs[name], losses, per_step = tools_train(
                hypes, ["--half", *flags], steps, none, tmp, total)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"tools.train {name} ({model_cfg['core_method']}) --half"
                  f"{''.join(' ' + f for f in flags)}: {steps} steps, "
                  f"{time.perf_counter() - t0:.2f} s with the fixture, "
                  f"validation and checkpoint; {1.0 / per_step:.3f} steps/s "
                  f"after the first; loss {[round(v, 4) for v in losses]}; "
                  f"no kernel launched; peak device memory {peak:.3f} GiB "
                  f"on {card}")
            torch.cuda.empty_cache()
        # (c) the lidar zoo's run directories served (their plain forward)
        late = os.path.join(tmp, "pixor_late_fusion")
        os.makedirs(late)
        save_config(load_config(os.path.join(repo, HYPES, PIXOR_LATE_HYPES)),
                    os.path.join(late, "config.yaml"))
        served = [(name, runs[name], []) for name in SEG_LIDAR_SERVED]
        served.append((f"{PIXOR_LATE_HYPES} (pixor, random weights)", late,
                       ["--fusion_method", "late"]))
        for name, run, flags in served:
            cuda.reset_launches()
            res = inference.main(["--model_dir", run, "--synthetic",
                                  "--synthetic_frames", str(SEG_LIDAR_FRAMES),
                                  "--bf16", "--max_frames",
                                  str(SEG_LIDAR_FRAMES), "--ap_mode", "iou",
                                  *flags])
            counts = cuda.launch_counts()
            for kernel, n in counts.items():
                total[kernel] += n
            iou, e2e = res["iou"], res["e2e"]
            print(f"tools.inference {name} --bf16 {' '.join(flags)}: AP@0.3 "
                  f"/ 0.5 / 0.7 {iou['ap_30']:.4f} / {iou['ap_50']:.4f} / "
                  f"{iou['ap_70']:.4f} (not held); e2e {e2e['fps']} fps over "
                  f"{e2e['frames']} frames, p50 {e2e['p50_ms']} ms, p95 "
                  f"{e2e['p95_ms']} ms; launches {counts} on {card}")
            if any(counts.values()):
                raise AssertionError(f"tools.inference {name}: launches "
                                     f"{counts}, expected none")
        # (d) the seg run's mIoU on the fixture
        seg_miou(runs["opcamera/cvt.yaml"], dev, card)
    if any(total.values()):
        raise AssertionError(f"phase 13: launches {total}, expected none")
    torch.cuda.empty_cache()
    print(f"phase 13: {time.perf_counter() - t_start:.1f} s on {card}")
    return total


# phase 14: a reference flagship checkpoint converted and served at full
# width: opcl/bevformer_point_pillar_hetero.yaml with the BEVFormer twin
TWIN_FLAGSHIP_HYPES = "opcl/bevformer_point_pillar_hetero.yaml"
TWIN_CORE = "bevformer_point_pillar_hetero"
# (c): the camera depth of the card-vs-CPU forward (the converted
# weights' first layers), its tolerance over max(1, max |x|)
TWIN_CPU_LAYERS = 1
# (c): the card's pillar projections against the CPU's, in normalised
# image coordinates: |uv| on the points both devices see, and how near
# an image edge a point must lie for the two devices' roundings to
# decide its visibility differently (the fixture's 90-degree cameras
# put BEV grid points exactly on their edges: 160 of 262 144 at full
# width, 320 of 4096 within 1e-6 of an edge at the smoke width)
TWIN_UV_ATOL = 1e-5
# (b): the frames of one bucket served after its capture for the steady
# p50 / p95 (the tools.inference run's few frames hold the captures)
TWIN_STEADY_WARMUP = 3
TWIN_STEADY_FRAMES = 40
# (d): the standalone BEVFormer twin detector on the smoke widths
TWIN_WRAPPER_CAMERA = {"encoder": "bevformer_ref", "backbone": "resnet18",
                       "dim": 64, "bev_h": 16, "num_layers": 1,
                       "ffn_dim": 128, "fpn_channels": 64,
                       "pc_range": [-20.48, -20.48, -3.0, 20.48, 20.48, 1.0],
                       "num_cams": 4}
TWIN_WRAPPER_FRAMES = 4


def twin_flagship_params(repo: str) -> dict:
    """The flagship's hypes with ``camera.encoder: bevformer_ref`` (the
    run directory's config a user writes for a converted checkpoint)."""
    import os

    from hmvit_tpu_torch.config import load_config

    params = load_config(os.path.join(repo, HYPES, TWIN_FLAGSHIP_HYPES))
    params["model"]["args"]["camera"]["encoder"] = "bevformer_ref"
    return params


def convert_cli(ref_dir, hypes, output, core_method) -> tuple[dict, float]:
    """``python -m hmvit_tpu_torch.tools.convert_checkpoint`` as a user
    runs it; returns its report and seconds."""
    import os

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "hmvit_tpu_torch.tools.convert_checkpoint",
         "--from_reference", ref_dir, "--core_method", core_method,
         "--hypes", hypes, "--output", output],
        capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"convert_checkpoint {core_method} failed "
                             f"({res.returncode}):\n{res.stderr}")
    with open(os.path.join(output, "conversion_report.json")) as f:
        report = json.load(f)
    if report["unconsumed_keys"]:
        raise AssertionError(f"convert_checkpoint {core_method}: unconsumed "
                             f"{report['unconsumed_keys'][:8]}")
    return report, time.perf_counter() - t0


def same_state(got: dict, want: dict) -> bool:
    """Two state_dicts with the same keys, dtypes and bits."""
    import torch

    return sorted(got) == sorted(want) and all(
        got[k].dtype == want[k].dtype and torch.equal(got[k].cpu(),
                                                      want[k].cpu())
        for k in want)


def convert_seeded_flagship(params, tmp):
    """The port's ``export_flagship`` of the model of ``params`` (weights
    from seed 0) as a reference run's ``net_epoch3.pth`` under ``tmp`` ->
    ``convert_cli`` into a run directory with ``params`` as its
    config.yaml; the restored state_dict must equal the model's bit for
    bit.  Returns (model, run directory, report, the CLI's seconds)."""
    import os

    import torch

    from hmvit_tpu_torch.bridge import state_dict_to_flax
    from hmvit_tpu_torch.config import save_config
    from hmvit_tpu_torch.models.zoo import build_model
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.tools import convert_checkpoint as cc
    from hmvit_tpu_torch.train.checkpointing import saved_model_state

    model = init_parameters(build_model(params["model"]), 0)
    ref_dir = os.path.join(tmp, "reference_run")
    os.makedirs(ref_dir)
    sd_ref = cc.export_flagship(state_dict_to_flax(model, model.state_dict()),
                                params["model"]["args"])
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd_ref.items()},
               os.path.join(ref_dir, "net_epoch3.pth"))
    run = os.path.join(tmp, "run")
    os.makedirs(run)
    hypes = os.path.join(run, "config.yaml")
    save_config(params, hypes)
    report, secs = convert_cli(ref_dir, hypes, os.path.join(run, "ckpt"),
                               TWIN_CORE)
    if not same_state(saved_model_state(os.path.join(run, "ckpt")),
                      model.state_dict()):
        raise AssertionError("phase 14 (a): the restored state_dict differs "
                             "from the exported model's")
    return model, run, report, secs


def twin_export_round_trip(model, margs, tmp) -> None:
    """(a) part 2: convert -> export -> convert bit for bit, on a reference
    file whose decoder convs carry non-zero biases (the import folds them
    into the BatchNorm means, the export writes them back as zeros)."""
    import os

    import torch

    from hmvit_tpu_torch.bridge import state_dict_to_flax
    from hmvit_tpu_torch.tools import convert_checkpoint as cc

    ref = cc.export_flagship(state_dict_to_flax(model, model.state_dict()),
                             margs)
    rng = np.random.default_rng(0)
    biases = [k for k in ref if "_decoder.decoder." in k
              and k.endswith(".bias") and ref[k[:-4] + "weight"].ndim == 4]
    for k in biases:
        ref[k] = rng.standard_normal(ref[k].shape).astype(np.float32)
    trees = []
    for i in range(2):
        path = os.path.join(tmp, f"round_trip_{i}.pth")
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in ref.items()},
                   path)
        r = cc.convert_flagship(cc.load_torch_state_dict(path), margs)
        trees.append(r)
        ref = cc.export_flagship(r, margs)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            else:
                yield prefix + k, np.asarray(v)

    a = dict(leaves({k: trees[0][k] for k in ("params", "batch_stats")}))
    b = dict(leaves({k: trees[1][k] for k in ("params", "batch_stats")}))
    same = sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    print(f"phase 14 (a) convert -> export -> convert ({len(biases)} decoder "
          f"conv biases non-zero): {len(a)} leaves bit for bit {same}")
    if not same:
        raise AssertionError("phase 14: convert -> export -> convert is not "
                             "bit for bit")


def stage_types(model, batch, hints) -> dict:
    """The output dtype of each stage of one eager forward of ``model``:
    camera encoder, lidar encoder, fusion, decoder."""
    import torch

    seen, hooks = {}, []
    for name in ("camera_encoder", "lidar_encoder", "fusion",
                 "HeteroDecoder_0"):
        def hook(m, a, out, name=name):
            first = out[0] if isinstance(out, (tuple, list)) else out
            seen[name] = str(first.dtype).replace("torch.", "")
        hooks.append(getattr(model, name).register_forward_hook(hook))
    try:
        with torch.no_grad():
            model(batch, **hints)
    finally:
        for h in hooks:
            h.remove()
    return seen


def twin_frame(params):
    """One fixture frame of the config's mixed fleet: a lidar ego and a
    camera agent (ego_mode lidar, every other agent a camera).  Returns
    the collated batch on the CPU and its hints."""
    from hmvit_tpu_torch.data.opv2v import HeteroCooperativeDataset
    from hmvit_tpu_torch.tools import common, inference

    params = dict(params, ego_mode="lidar", camera_to_lidar_ratio=1.0)
    common.write_synthetic(params, "chip_smoke_twin_", 60000,
                           num_scenarios=1, num_cavs=2, num_frames=1)
    ds = HeteroCooperativeDataset(params, train=False)
    frame = ds[0]
    if list(np.asarray(frame["mode"])[:2]) != [1, 0]:
        raise AssertionError(f"phase 14: fleet {frame['mode']}, expected a "
                             f"lidar ego and a camera agent")
    return (common.to_device(ds.collate_batch([frame]), "cpu"),
            inference.fleet_hints(frame))


def twin_steady(model, batch, hints, params, dev, card) -> None:
    """(b) steady serving of one bucket: the fixture frame's (a lidar
    ego and a camera agent) captured as ``tools.inference
    --serving_buckets`` captures it, TWIN_STEADY_WARMUP replays, then
    TWIN_STEADY_FRAMES frames each timed on the host clock as the tool
    serves them: the copy to the card with the bf16 casts and the
    graph's replay (the card synchronised), then host decode + NMS.
    Prints p50 / p95 of the frame and the medians of the two parts."""
    import torch

    from hmvit_tpu_torch.postprocess import build_postprocessor
    from hmvit_tpu_torch.serving import GEOMETRY_KEYS
    from hmvit_tpu_torch.tools import common, inference

    pp = build_postprocessor(params["postprocess"], train=False)
    anchors = pp.generate_anchor_box()
    graphs = inference.GraphServing(model, anchors)
    ego = {"ego": {"transformation_matrix": np.eye(4), "anchor_box": anchors,
                   "no_post_projection": True}}

    def frame():
        t0 = time.perf_counter()
        req = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32
                   and k not in GEOMETRY_KEYS else v)
               for k, v in common.to_device(batch, dev).items()}
        out = graphs(req, hints)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pp.post_process(ego, {"ego": inference.detection_view(out)})
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    frame()
    for _ in range(TWIN_STEADY_WARMUP):
        frame()
    rows = np.asarray([frame() for _ in range(TWIN_STEADY_FRAMES)])
    total = rows.sum(axis=1)
    fwd, dec = np.median(rows, axis=0)
    print(f"phase 14 (b) steady serving, bucket {hints['static_modes']} "
          f"after its capture ({graphs.captures[0]['capture_s']} s) and "
          f"{TWIN_STEADY_WARMUP} replays: {TWIN_STEADY_FRAMES} frames, p50 "
          f"{float(np.percentile(total, 50)):.2f} ms, p95 "
          f"{float(np.percentile(total, 95)):.2f} ms, min "
          f"{float(total.min()):.2f}, max {float(total.max()):.2f}; medians "
          f"copy + graph forward {fwd:.2f} ms, host decode + NMS "
          f"{dec:.2f} ms (host clock, card synchronised) on {card}")
    if len(graphs.captures) != 1 or not np.isfinite(total).all():
        raise AssertionError(f"phase 14 (b) steady serving: captures "
                             f"{graphs.captures}, frames {rows}")


def twin_card_vs_cpu(run, params, dev, card) -> None:
    """(c) part 2: the converted flagship cut to TWIN_CPU_LAYERS camera
    layers (its first layers' converted weights), float32 (the fusion's
    ``compute_dtype`` too) with TF32 off on the card against the CPU, one
    fixture frame with a camera agent: sigmoid(psm) and rm within
    SEG_LIDAR_ATOL of scale.  The CPU forward takes the card's pillar
    projections (``point_sampling``): the fixture's cameras see 90
    degrees along the axes, so BEV grid points lie exactly on their
    image edges, and the two devices' last-bit roundings decide those
    visibilities differently (a discontinuity of the model, not of its
    arithmetic).  The two devices' projections are held to each other:
    a visibility may differ only at a point within TWIN_UV_ATOL of an
    image edge, and the image coordinates of the points both see agree
    within TWIN_UV_ATOL."""
    import copy
    import os

    import torch

    from hmvit_tpu_torch.models import bevformer_ref
    from hmvit_tpu_torch.models.zoo import build_model
    from hmvit_tpu_torch.train.checkpointing import saved_model_state
    from hmvit_tpu_torch.utils.precision import strict_fp32

    cut = copy.deepcopy(params)
    cut["model"]["args"]["camera"]["num_layers"] = TWIN_CPU_LAYERS
    # float32 throughout: the fusion's bf16 compute_dtype rounds its
    # contractions on the card as a bf16 GEMM with a float32 result, on
    # the CPU as a float32 einsum
    cut["model"]["args"]["hetero_fusion"]["hetero_fusion_block"][
        "compute_dtype"] = "float32"
    model = build_model(cut["model"])
    saved = saved_model_state(os.path.join(run, "ckpt"))
    model.load_state_dict({k: v for k, v in saved.items()
                           if k in model.state_dict()})
    batch, hints = twin_frame(copy.deepcopy(params))
    sampling = bevformer_ref.point_sampling
    seen = {}

    def on_card(*args):
        seen["card"] = [t.cpu() for t in sampling(*args)]
        return [t.to(dev) for t in seen["card"]]

    def on_cpu(*args):
        seen["cpu"] = sampling(*args)
        return seen["card"]

    cpu_model = copy.deepcopy(model)
    model = model.to(dev)
    try:
        bevformer_ref.point_sampling = on_card
        with torch.no_grad(), strict_fp32():
            got = model({k: v.to(dev) for k, v in batch.items()}, **hints)
        torch.cuda.synchronize()
        bevformer_ref.point_sampling = on_cpu
        t0 = time.perf_counter()
        with torch.no_grad():
            want = cpu_model(batch, **hints)
        cpu_s = time.perf_counter() - t0
    finally:
        bevformer_ref.point_sampling = sampling
    (uv_card, vis_card), (uv_cpu, vis_cpu) = seen["card"], seen["cpu"]
    flipped = vis_cpu != vis_card
    on_edge = torch.zeros_like(flipped)
    for uv in (uv_card, uv_cpu):
        on_edge |= ((uv.abs() < TWIN_UV_ATOL)
                    | ((uv - 1).abs() < TWIN_UV_ATOL)).any(-1)
    off_edge = int((flipped & ~on_edge).sum())
    both = vis_cpu & vis_card
    uv_err = float((uv_cpu - uv_card).abs()[both].max()) if both.any() \
        else float("nan")
    print(f"phase 14 (c) pillar projections, card vs CPU: "
          f"{int(flipped.sum())} of {vis_card.numel()} visibilities differ, "
          f"{off_edge} of them off the image edges ({int(on_edge.sum())} "
          f"points within {TWIN_UV_ATOL:g} of one); max |uv| diff "
          f"{uv_err:.3e} on the {int(both.sum())} points both see (tol "
          f"{TWIN_UV_ATOL:g})")
    if not (off_edge == 0 and uv_err <= TWIN_UV_ATOL):
        raise AssertionError(f"phase 14 (c): the card's pillar projections "
                             f"differ from the CPU's: {off_edge} "
                             f"visibilities off the image edges, uv {uv_err}")
    errs = scaled_errors(got, want)
    if max(errs.values()) > SEG_LIDAR_ATOL:
        raise AssertionError(f"phase 14 (c): card vs CPU {errs} (tol "
                             f"{SEG_LIDAR_ATOL})")
    print(f"phase 14 (c) converted flagship, {TWIN_CPU_LAYERS} camera layer, "
          f"fleet {hints['static_modes']}: fp32 card (TF32 off) vs CPU on "
          f"the card's projections max_abs_err/scale psm {errs['psm']:.3e}, "
          f"rm {errs['rm']:.3e} (tol {SEG_LIDAR_ATOL}); CPU forward "
          f"{cpu_s:.1f} s on {card}")
    del model
    torch.cuda.empty_cache()


def twin_wrapper(dev, card, tmp, total) -> None:
    """(d) ``bevformer_wrapper`` with ``bevformer_ref`` (the standalone
    RefBEVFormerDetector) at the smoke widths: a reference-named file
    written by the port's exporters -> the convert CLI -> bit for bit ->
    ``tools.inference --bf16`` serves it (its plain forward)."""
    import os

    import torch

    from hmvit_tpu_torch.bridge import state_dict_to_flax
    from hmvit_tpu_torch.config import load_config, save_config
    from hmvit_tpu_torch.models.zoo import build_model
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.ops import cuda
    from hmvit_tpu_torch.tools import convert_checkpoint as cc
    from hmvit_tpu_torch.tools import inference
    from hmvit_tpu_torch.train.checkpointing import saved_model_state

    repo = os.path.dirname(os.path.abspath(__file__))
    params = load_config(os.path.join(repo, HYPES, "smoke_hetero_tiny.yaml"))
    params["model"] = {"core_method": "bevformer_wrapper", "args": {
        "anchor_number": 2, "camera": dict(TWIN_WRAPPER_CAMERA),
        "decoder": {"num_layer": 1, "num_ch_dec": [64]}}}
    run = os.path.join(tmp, "wrapper_run")
    os.makedirs(run)
    hypes = os.path.join(run, "config.yaml")
    save_config(params, hypes)
    model = init_parameters(build_model(params["model"]), 1)
    tree = state_dict_to_flax(model, model.state_dict())
    p, s = tree["params"], tree["batch_stats"]
    w = cc._Writer()
    cc.export_bevformer_camera(w, "bevformer.", p["bevformer"],
                               s["bevformer"], "resnet18")
    cc.export_naive_decoder(w, "decoder", p["decoder"], s["decoder"], 1)
    w.conv("cls_head", p["head"]["Conv_0"])
    w.conv("reg_head", p["head"]["Conv_1"])
    ref_dir = os.path.join(tmp, "wrapper_reference")
    os.makedirs(ref_dir)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in w.out.items()},
               os.path.join(ref_dir, "net_epoch2.pth"))
    report, secs = convert_cli(ref_dir, hypes, os.path.join(run, "ckpt"),
                               "bevformer_wrapper")
    same = same_state(saved_model_state(os.path.join(run, "ckpt")),
                      model.state_dict())
    cuda.reset_launches()
    res = inference.main(["--model_dir", run, "--synthetic",
                          "--synthetic_frames", str(TWIN_WRAPPER_FRAMES),
                          "--bf16", "--max_frames", str(TWIN_WRAPPER_FRAMES),
                          "--ap_mode", "iou"])
    counts = cuda.launch_counts()
    for kernel, n in counts.items():
        total[kernel] += n
    iou, e2e = res["iou"], res["e2e"]
    print(f"phase 14 (d) bevformer_wrapper (RefBEVFormerDetector, smoke "
          f"widths): {report['converted_params']} params converted in "
          f"{secs:.1f} s, restored == exported bit for bit {same}; "
          f"tools.inference --bf16: AP@0.3 / 0.5 / 0.7 {iou['ap_30']:.4f} / "
          f"{iou['ap_50']:.4f} / {iou['ap_70']:.4f} (not held); e2e "
          f"{e2e['fps']} fps over {e2e['frames']} frames, p50 "
          f"{e2e['p50_ms']} ms, p95 {e2e['p95_ms']} ms; launches "
          f"{sum(counts.values())} on {card}")
    if not same:
        raise AssertionError("phase 14 (d): the restored state_dict differs "
                             "from the exported model's")
    if any(counts.values()) or not all(
            np.isfinite(iou[k]) for k in ("ap_30", "ap_50", "ap_70")):
        raise AssertionError(f"phase 14 (d): launches {counts}, AP {iou}")


def twin_phase(dev, card):
    """Phase 14 (see the module's docstring): a reference flagship
    checkpoint converted and served at full width.  Returns each kernel's
    launches over the phase, and the plain kernel's by (T, type) and body
    (``add_keyed``)."""
    import copy
    import os
    import tempfile

    import torch

    from hmvit_tpu_torch.serving import GEOMETRY_KEYS
    from hmvit_tpu_torch.tools import common

    t_start = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    total = dict.fromkeys(KERNEL_META, 0)
    keyed = {}
    params = twin_flagship_params(repo)
    margs = params["model"]["args"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase14_") as tmp:
        # (a) the port's export of a seeded model as a reference run's
        # net_epoch3.pth -> the convert CLI -> the run directory
        model, run, report, secs = convert_seeded_flagship(params, tmp)
        print(f"phase 14 (a) {TWIN_FLAGSHIP_HYPES} with bevformer_ref: "
              f"seeded model exported in the reference's keys; "
              f"convert_checkpoint CLI {report['converted_params']} params, "
              f"{len(report.get('dead_reference_keys', []))} dead keys, "
              f"camera layers {report['camera_num_layers']}, {secs:.1f} s; "
              f"restored == exported bit for bit True")
        twin_export_round_trip(model, margs, tmp)
        del model
        # (b) tools.inference --bf16 --serving_buckets on the run
        # directory: captured graphs, launches a frame held (K1 4, K2 2,
        # K3 2, every other kernel 0), one frame graph == eager (c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = serve_run_dir(run, margs, dev, card, total,
                            f"{TWIN_FLAGSHIP_HYPES} (bevformer_ref)", keyed)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for b in res["serving"]["buckets"]:
            other = {k: n for k, n in b["launches"].items()
                     if k not in TRAIN_KERNELS and n}
            if other:
                raise AssertionError(f"phase 14 bucket {b['hints']}: "
                                     f"launches {other}, expected none")
        # each stage's type on the served (bf16) model, one frame
        model, _ = common.load_runnable(run, dev)
        model = model.to(torch.bfloat16)
        batch, hints = twin_frame(copy.deepcopy(params))
        req = {k: (v.to(dev, torch.bfloat16) if v.dtype == torch.float32
                   and k not in GEOMETRY_KEYS else v.to(dev))
               for k, v in batch.items()}
        types = stage_types(model, req, hints)
        fusion_cdt = margs["hetero_fusion"]["hetero_fusion_block"].get(
            "compute_dtype", "float32")
        print(f"phase 14 (b) stage output types under --bf16 (fleet "
              f"{hints['static_modes']}): {types}, the fusion computing in "
              f"{fusion_cdt}; peak device memory {peak:.3f} GiB on {card}")
        del req
        twin_steady(model, batch, hints, params, dev, card)
        del model
        torch.cuda.empty_cache()
        # (c) the card against the CPU, float32, one camera layer
        twin_card_vs_cpu(run, params, dev, card)
        # (d) the standalone detector, converted and served
        twin_wrapper(dev, card, tmp, total)
    for kernel, n in total.items():
        if kernel not in TRAIN_KERNELS and n:
            raise AssertionError(f"phase 14: {kernel} launched {n} times, "
                                 f"expected none")
    torch.cuda.empty_cache()
    print(f"phase 14 launches: {total}; plain launches by (T, type) and "
          f"body: {keyed}")
    print(f"phase 14: {time.perf_counter() - t_start:.1f} s on {card}")
    return total, keyed


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from hmvit_tpu_torch import perf_lab
    from hmvit_tpu_torch.data.anchors import generate_anchor_grid
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.ops import cuda, plain_ops
    from hmvit_tpu_torch.postprocess import decode_detections_device
    from hmvit_tpu_torch.serving import (
        PROD_CFG,
        anchor_args,
        batch_to_device,
        serving_config,
        serving_hints,
    )
    from hmvit_tpu_torch.utils.precision import strict_fp32

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    cuda.load_library(verbose=True)
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s")

    # -- 2. kernels vs plain twins ----------------------------------------
    batch0 = prod_batch(0)
    geo = batch_to_device(batch0, dev, bf16=False)
    record = check_kernels(dev, geo["pairwise_t_matrix"][:, :4, :4],
                           geo["agent_mask"][:, :4])
    is_lidar = torch.as_tensor(batch0["mode"][0, :NUM_AGENTS] == 1,
                               device=dev)
    record.update(check_lidar_kernels(
        dev, geo["points"][0, :NUM_AGENTS][is_lidar],
        geo["points_mask"][0, :NUM_AGENTS][is_lidar]))
    for name, spread in check_spread_draws(dev).items():
        record[name]["spread_draws"] = spread
    torch.cuda.empty_cache()

    # -- 3. the production model in its four serving variants ----------------
    hints = serving_hints(batch0["mode"][0], NUM_AGENTS)
    variants = {"split": {}, "fused_wa": {"fused_wa": True},
                "expand_v1": {"expand": "v1"}, "expand_v2": {"expand": "v2"}}

    def build(bf16: bool, knobs: dict):
        model = init_parameters(
            HMViT(serving_config(PROD_CFG, bf16=bf16, **knobs)), seed=0)
        model = model.to(dev, torch.bfloat16) if bf16 else model.to(dev)
        return model.eval()

    # the anchors of the 512^2 pillar grid at feature stride 4 (128^2)
    anchors = torch.as_tensor(
        generate_anchor_grid(anchor_args(PROD_CFG), "hwl"),
        dtype=torch.float32, device=dev)
    eye = torch.eye(4, device=dev)
    # launches per request each server must show (0: must not launch)
    split_counts = {"pair_warp": 4, "stripe_window_attention": 2,
                    "plain_window_attention": 5, "warp_window_attention": 0,
                    "pair_warp_resident": 0, "typed_window_attention": 0,
                    "segmented_max_scan": 0, "expand_rows": 0,
                    "expand_rows_v2": 0}
    per_request = {
        "split": split_counts,
        "fused_wa": dict(split_counts, pair_warp=2, stripe_window_attention=0,
                         warp_window_attention=2),
        "expand_v1": dict(split_counts, expand_rows=1),
        "expand_v2": dict(split_counts, expand_rows_v2=1),
    }

    def check_counts(what, name, counts, requests, body):
        """Every kernel's launches, and every attention launch on
        ``body`` (counted inside the library where the choice is made)."""
        for kernel, n in per_request[name].items():
            if counts[kernel] != n * requests:
                raise AssertionError(
                    f"{what} ({name}): {kernel} launched {counts[kernel]} "
                    f"times, expected {n * requests}")
        bodies = cuda.attention_body_launches()
        for kernel, ran in bodies.items():
            want = dict.fromkeys(ran, 0)
            want[body] = per_request[name][kernel] * requests
            if ran != want:
                raise AssertionError(
                    f"{what} ({name}): {kernel} ran {ran}, expected every "
                    f"launch on the {body} body: {want}")
        return bodies

    # -- 4. float32 forward: kernels vs plain twins, variants vs split --------
    outs32 = {}
    for name, knobs in variants.items():
        model32 = build(False, knobs)
        cuda.reset_launches()
        with torch.no_grad(), strict_fp32():
            out_k = model32(geo, **hints)
            counts = cuda.launch_counts()
            print(f"fp32 forward ({name}) with kernels: launches {counts}")
            check_counts("fp32 forward", name, counts, 1, "simt")
            with plain_ops():
                out_p = model32(geo, **hints)
        torch.cuda.synchronize()
        for key, fn in (("psm", torch.sigmoid), ("rm", lambda z: z)):
            a, b = fn(out_k[key].float()), fn(out_p[key].float())
            scale = max(1.0, float(b.abs().max()))
            err = float((a - b).abs().max()) / scale
            print(f"forward fp32 ({name}) {key} {tuple(a.shape)}: kernels vs "
                  f"plain max_abs_err/scale {err:.3e} (tol {FORWARD_ATOL})")
            if not (torch.isfinite(a).all() and err <= FORWARD_ATOL):
                raise AssertionError(f"fp32 forward ({name}) {key} "
                                     f"disagrees: {err}")
        # decode + NMS over every anchor (threshold 0: random weights put
        # all scores near the focal prior 0.01, under the serving threshold)
        kept = []
        for out in (out_k, out_p):
            corners, _, valid = decode_detections_device(
                out["psm"], out["rm"], anchors, eye, score_threshold=0.0)
            kept.append(corners[valid])
        print(f"fp32 decode+NMS ({name}) at threshold 0: kept {len(kept[0])} "
              f"(kernels) vs {len(kept[1])} (plain) of 512 candidates")
        if kept[0].shape != kept[1].shape or \
                float((kept[0] - kept[1]).abs().max()) > 1e-3:
            raise AssertionError(f"fp32 decode+NMS ({name}): kernels and "
                                 f"plain twins keep different boxes")
        outs32[name] = out_k
        del model32, out_p
        torch.cuda.empty_cache()
    for name in list(variants)[1:]:
        for key in ("psm", "rm"):
            diff = float((outs32["split"][key] - outs32[name][key])
                         .abs().max())
            print(f"forward fp32 {key}: {name} vs split max|diff| "
                  f"{diff:.1e}")
            if not torch.equal(outs32["split"][key], outs32[name][key]):
                raise AssertionError(f"fp32 forward {key}: the {name} "
                                     f"forward differs from the split "
                                     f"forward")
    fp32_split = outs32["split"]
    del outs32

    # -- 5. bfloat16 requests through forward, decode, NMS -------------------
    servers = {name: build(True, knobs) for name, knobs in variants.items()}
    requests = [batch_to_device(prod_batch(s), dev, bf16=True)
                for s in range(3)]

    def serve(model, b):
        """One request; returns the outputs and the host-clock ms of the
        forward and of decode + NMS (the card synchronised after each)."""
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(b, **hints)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            det = decode_detections_device(out["psm"], out["rm"], anchors,
                                           eye)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        return out, det, ((t1 - t0) * 1e3, (t2 - t1) * 1e3)

    path_counts, path_bodies, eager = {}, {}, {}
    for name, model in servers.items():
        serve(model, requests[0])  # warm-up (cuDNN autotune, allocator)
        cuda.reset_launches()
        for i, b in enumerate(requests):
            out, det, stages = serve(model, b)
            corners, scores, valid = det
            for key, shape in (("psm", (1, 2, 128, 128)),
                               ("rm", (1, 14, 128, 128))):
                if tuple(out[key].shape) != shape or \
                        not torch.isfinite(out[key].float()).all():
                    raise AssertionError(f"{name} request {i}: bad {key} "
                                         f"{tuple(out[key].shape)}")
            if not torch.isfinite(corners).all():
                raise AssertionError(f"{name} request {i}: non-finite boxes")
            eager.setdefault(name, []).append((out, det))
            print(f"{name} request {i}: {sum(stages):.2f} ms (forward "
                  f"{stages[0]:.2f}, decode + NMS {stages[1]:.2f}), "
                  f"{int(valid.sum())} boxes kept")
        path_counts[name] = cuda.launch_counts()
        path_bodies[name] = check_counts("bf16 serving", name,
                                         path_counts[name], len(requests),
                                         "mma")
        print(f"launches during the 3 {name} requests: {path_counts[name]}; "
              f"attention launches by body: {path_bodies[name]}")
    # the fused kernel computes the rows the pair warp would have written
    # and attends with the stripe kernel's code: the same bits end to end
    for i, ((a, _), (b, _)) in enumerate(zip(eager["split"],
                                             eager["fused_wa"])):
        for key in ("psm", "rm"):
            diff = float((a[key].float() - b[key].float()).abs().max())
            print(f"forward bf16 request {i} {key}: fused_wa vs split "
                  f"max|diff| {diff:.1e}")
            if not torch.equal(a[key], b[key]):
                raise AssertionError(
                    f"bf16 forward request {i} {key}: the fused_wa server "
                    f"differs from the split server (max|diff| {diff})")
    # the split server against itself on the plain twins, one request
    with torch.no_grad():
        out_k = servers["split"](requests[0], **hints)
        with plain_ops():
            out_p = servers["split"](requests[0], **hints)
    torch.cuda.synchronize()
    for key, fn in (("psm", torch.sigmoid), ("rm", lambda z: z)):
        a, b = fn(out_k[key].float()), fn(out_p[key].float())
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max()) / scale
        print(f"forward bf16 (split) {key} {tuple(a.shape)}: kernels vs "
              f"plain max_abs_err/scale {err:.3e} (tol {BF16_FORWARD_ATOL})")
        if not (torch.isfinite(a).all() and err <= BF16_FORWARD_ATOL):
            raise AssertionError(f"bf16 forward (split) {key} disagrees: "
                                 f"{err}")
    # the bf16 server against the fp32 forward of phase 4: the same
    # weights (init_parameters seed 0) and request (prod_batch(0))
    logit = float((out_k["psm"].float() - fp32_split["psm"]).abs().max())
    for key, fn in (("psm", torch.sigmoid), ("rm", lambda z: z)):
        a, b = fn(out_k[key].float()), fn(fp32_split[key].float())
        scale = max(1.0, float(b.abs().max())) if key == "rm" else 1.0
        diff = (a - b).abs() / scale
        err, mean = float(diff.max()), float(diff.mean())
        what = "sigmoid(psm)" if key == "psm" else "rm / scale"
        print(f"bf16 server vs fp32 forward (split) {what}: max "
              f"{err:.3e}, mean {mean:.3e} (tol {BF16_VS_FP32_ATOL[key]})"
              + (f"; max |psm| logit diff {logit:.3e} (tol "
                 f"{BF16_VS_FP32_ATOL['logit']}), max sigmoid(psm) "
                 f"{float(b.max()):.4f}" if key == "psm" else
                 f"; scale {scale:.3f}"))
        if not (np.isfinite(err) and err <= BF16_VS_FP32_ATOL[key]):
            raise AssertionError(f"bf16 server vs fp32 forward {key}: "
                                 f"{err} > {BF16_VS_FP32_ATOL[key]}")
    if not logit <= BF16_VS_FP32_ATOL["logit"]:
        raise AssertionError(f"bf16 server vs fp32 forward psm logits: "
                             f"{logit} > {BF16_VS_FP32_ATOL['logit']}")
    del out_k, out_p, fp32_split
    # every server in turn, then in the mirrored order: all see the card
    # in the same states, TIMED_REQUESTS requests each
    stage_ms = {name: [] for name in servers}
    blocks = TIMED_REQUESTS // TIMED_BLOCK
    order = [n for i in range(blocks)
             for n in (list(servers) if i % 2 == 0
                       else list(servers)[::-1])]
    for name in order:
        done = len(stage_ms[name])
        stage_ms[name] += [
            serve(servers[name], requests[(done + i) % len(requests)])[2]
            for i in range(TIMED_BLOCK)]
    for name, rows in stage_ms.items():
        print(f"bf16 serving ({name}), eager: {frame_line(rows)} on {card}")

    # -- 6. the same servers as captured CUDA graphs --------------------------
    graph_phase(servers, requests, eager, stage_ms, hints, anchors, eye,
                per_request, card)
    del servers, requests, eager
    torch.cuda.empty_cache()
    run_bench(card)

    # -- 7. the lab stages: typed, resident and scan kernels, lidar paths ----
    cuda.reset_launches()
    perf_lab.run_stages(["attn", "pairwarp_res"], dev, iters=5)
    perf_lab.run_stages(["segscan", "expand", "lidar"], dev, iters=20)
    path_counts["perf_lab"] = cuda.launch_counts()
    path_bodies["perf_lab"] = cuda.attention_body_launches()
    print(f"launches during the perf_lab stages: {path_counts['perf_lab']}; "
          f"attention launches by body: {path_bodies['perf_lab']}")
    torch.cuda.empty_cache()

    # -- 8. training on the card ----------------------------------------------
    train_counts = train_phase(dev, card)

    # -- 9. the accuracy gate's path ------------------------------------------
    gate_counts = gate_phase(dev, card)

    # -- 10. the run-directory tools -----------------------------------------
    run_dir_counts = run_dir_phase(dev, card)

    # -- 11. every camera encoder of the zoo under HM-ViT ---------------------
    zoo_counts = zoo_phase(dev, card)

    # -- 12. the fusion zoo ---------------------------------------------------
    fusion_counts, keyed, k3 = fusion_zoo_phase(dev, card)

    # -- 13. the segmentation assemblies and the lidar zoo --------------------
    seg_lidar_counts = seg_lidar_zoo_phase(dev, card)

    # -- 14. a reference checkpoint converted and served ---------------------
    twin_counts, twin_keyed = twin_phase(dev, card)

    kernels = []
    for name, rec in record.items():
        launches = path_counts[KERNEL_PATH[name]][name]
        if launches <= 0:
            raise AssertionError(f"{name} never launched on its path "
                                 f"({KERNEL_PATH[name]})")
        if name in TENSOR_CORE_KERNELS:
            # of those launches, the ones the tensor-core body ran
            rec["mma_launches"] = path_bodies[KERNEL_PATH[name]][name]["mma"]
            if rec["mma_launches"] <= 0:
                raise AssertionError(f"{name}: the tensor-core body never "
                                     f"ran on its path ({KERNEL_PATH[name]})")
        kernels.append({"name": name, "route": "cuda",
                        "source": KERNEL_META[name][0],
                        "replaces": KERNEL_META[name][1],
                        "launches": launches,
                        "train_launches": train_counts[name],
                        "gate_launches": gate_counts[name],
                        "run_dir_launches": run_dir_counts[name],
                        "zoo_launches": zoo_counts[name],
                        "fusion_zoo_launches": fusion_counts[name],
                        "seg_lidar_zoo_launches": seg_lidar_counts[name],
                        "reference_twin_launches": twin_counts[name],
                        **rec})
    # K3 at V2X-ViT's windows: its launches at each T over phase 12
    name = "plain_window_attention"
    for win, rec in k3.items():
        t = win * win
        launches = sum(n for key, n in keyed.items() if key[0] == t)
        if launches <= 0:
            raise AssertionError(f"{name}: no launch at T = {t} in phase 12")
        # the bf16 timing's body: T > 128 runs the fp32 CUDA-core body
        source = (KERNEL_META[name][0] if rec["bfloat16"]["body"] == "mma"
                  else "hmvit_tpu_torch/csrc/window_attention.cu")
        kernels.append({"name": f"{name} (V2X-ViT window {win}, T={t})",
                        "route": "cuda", "source": source,
                        "replaces": KERNEL_META[name][1],
                        "launches": launches,
                        "launches_by_type": {key[1]: n for key, n in
                                             keyed.items() if key[0] == t},
                        "seg_lidar_zoo_launches": seg_lidar_counts[name],
                        "reference_twin_launches": sum(
                            n for key, n in twin_keyed.items()
                            if key[0] == t),
                        **rec["bfloat16"], "float32": rec["float32"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
