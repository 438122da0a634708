#!/usr/bin/env python3
"""On-card smoke run of liftreg_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and nvcc;
imports nothing of JAX or of liftreg_tpu. Phases, each printing one JSON
line with its elapsed seconds:

1. build: compile the port's CUDA kernels (one nvcc per source, started
   together, and one link, into build/);
2. device: the card's name and power limit from nvidia-smi;
3. pca_check / warp_check / drr_check / grad_check: each kernel against
   its plain PyTorch version on the card, at the shapes of the serving
   path (plus ragged shapes, both tap types, both paddings, coordinates
   far outside, on integers and on the edges of the DRR's zero padding;
   the projector's adjoint with 3, 4 and 9 views, B = 1, 4, 5 and 9, sorted
   edge and integer coordinates, a detector narrower than the volume's
   shadow and a view group in no order, twice, which must give the same
   bits, with its plan equal to the plain plan and no tile of the serving
   geometry on its general path;
   a batch of 9 for the PCA expansion, volumes with a spatial dim of 1 for
   the warp and its gradient, a point count that the gradient's points per
   thread do not divide, the PCA backward twice, which must give the same
   bits, and the encoder's bf16 input buffer (liftreg::encoder_input),
   whose lift must be the f32 lift rounded once and whose channel 0 must
   be the moving CT); the warp and its gradient
   also with phi in its (B, 3, D, W, H) layout, as warp_image passes it
   (B = 1, 4 and 9 at the serving shape, M = 6001 points, phi and the
   cotangent off a 16-byte boundary, unit dims; both tap types, both
   paddings, scale_intensity on and off); the PCA backward, kernel and
   plain version each, against the f64 product (half a bf16 step);
   image_grad_check: the warp's image gradient (f32 taps) at C = 1 and 3,
   160^3, B = 1 and 2, in both layouts, both paddings, scale_intensity on
   and off, far outside, on integers and on the edges, unit dims, M = 6001,
   phi off a 16-byte boundary, and at 64^3 a rough field, a slab far
   outside along y and a field clamped onto the faces, each called twice,
   with the share of points that took the kernel's overflow path (which
   the rough field, and the slab under border padding, must take);
   gather_probe: the gather probes' tools as a user runs them
   (tools/torch_bench_mosaic_gather.py: the JAX tool's 17 rows at inner 8
   and one pass an SM, and its decision line beside the port's warp
   forward; tools/torch_repro_mosaic_gather_500.py: 10 OK rows, exit 0),
   each with the counts zeroed just before and read just after and checked
   exactly; then the four probe kernels (row gather, lane gather, roll,
   warp step) at every shape of both tools against their plain versions,
   bit for bit (f32 and bf16, inner 1, 8 and 64, grid 1 and one pass an
   SM, indices of the axis's range, of the whole int32 range and where
   the kernels' index walk turns), and their times, with the slope
   between inner 8 and 64 at 160 x 128 and 1280 x 128 f32;
4. main_path: RegistrationPipeline.register at 160^3, B=4, 4 views on a
   240^2 detector, latent 56, bf16 encoder, basis and taps, with random
   seeded weights; the kernels' launch counts are zeroed just before and
   read just after, and must be exactly one each of the projector, the
   lift, the PCA expansion and the warp; then register_projections the
   same way (no projector);
5. refine: register with refine_steps=30 (image domain) at the same
   config on smooth seeded volumes and a smooth basis, counts zeroed just
   before and read just after; the refined objective of each case must not
   exceed its unrefined objective;
   refine_projection: the same with refine_domain="projection" (each step
   differentiates the projector through its adjoint kernel), through
   register and then register_projections, each with its counts zeroed
   just before and read just after and checked exactly (the adjoint's
   plan once, at the refiner's first call, and kept), and each case no
   worse than unrefined;
6. glue_check: one register call without refinement and one with each
   domain's refinement under a dispatch mode that sees every aten op: no
   op may make a (B, D, W, H, 3) coordinate buffer or the warp's
   `out * 2 - 1`, the moving image's tap tensor is cast once per
   warp_image call outside the refinement's steps, and no op copies
   between host and card (each such copy stalls the stream);
   serving: one-file artifacts (liftreg_tpu_torch/serving.py, the
   kernels called as liftreg:: torch.library operators) of main_path's
   pipeline and weights, both entries, exported into build/ and removed at
   the end: the file sizes, the program's bytes (under 1% of the
   weights'), the load, first-call and steady-state ms (live and served in
   turns, the served mean within 2% of the live mean); each served call
   bit-equal to the live pipeline with its launch counts zeroed just
   before and checked exactly just after; batches of 1 and 3 padded to the
   exported 4 against the full batch's rows; a refine_steps=30 artifact of
   each domain (the refiner rebuilt from the artifact's meta) against the
   live refined pipeline, timed beside it; an f32 artifact at 32^3 with
   TF32 on for the process, bit-equal to the live f32 pipeline (and
   exported on the CPU, its program moved to the card at load, within
   REF_F32_TOL of it); and
   tools/torch_serve_batch.py as a subprocess on 5 cases (a full batch and
   one of 1), its outputs equal to ServingModel's;
7. reference / refine_reference: the pipeline on the card against the same
   pipeline on the CPU (the kernels' plain versions) at 32^3, without and
   with 5 refinement steps (image domain with NCC and with LNCC, projection
   domain with NCC and with NGF): with refinement, the card's phi, warped
   CT and objective history against the CPU run's; for NGF, whose Adam
   iterates are ill-conditioned there (see REFINE_REF_TOL), its phi and
   warped CT against the CPU's outputs at the card's refined coefficients,
   and its history again with the card's coordinate gradient wrong in one
   axis's sign, which the history must catch;
8. train: training at the reference config (configs/cur_task_setting.json:
   160^3, B = 30, 4 views on a 240^2 detector, latent 56, f32, NCC, the
   subspace loss, Adam at lr 1e-3, StepLR) through the port's CLI
   (liftreg_tpu_torch.main) on a dataset the phase writes in
   Registration2D3DDataset's layout (3 distinct smooth seeded cases, the 30
   training cases hard links to them, 3 validation cases so that the eval
   batch is padded; DRRs from the port's projector; a smooth seeded f32
   basis): 3 epochs with validation and a checkpoint each, counts zeroed
   just before and read just after (lift and warp once a step and once a
   validation batch, the coordinate gradient once a step, nothing else),
   every loss finite; then RegistrationTrainer resumes the last checkpoint
   (epoch, steps, parameters and moments as saved) for one more epoch; then
   one step alone must launch the lift, the warp and the coordinate
   gradient once each, and 5 more are timed;
   train_check: the step's kernels against their plain versions at the
   step's own shapes and values (B = 30): the batch's projections lifted
   into an f32 and a bf16 (B, 5, 160^3) encoder input, phi of the model's
   forward warping the batch's masked source with f32 and bf16 taps, and
   the coordinate gradient of both;
   train_bf16: 3 steps with configs/fast_train's dtypes (bf16 encoder,
   basis and taps, s2d_encoder: each step runs the encoder's first two
   stages as space-to-depth convolutions, counted) at the same batch: each
   step also launches the PCA expansion and its backward once per 8 rows,
   which are held against their plain versions on the bf16 model's
   coefficients and basis at B = 30; then 3 steps of the same trainer with
   those stages plain, timed beside them;
   s2d: the encoder's first two stages as space-to-depth convolutions
   (liftreg_tpu_torch/models/s2d.py) against the plain ConvBlock pair on
   the same seeded parameters (tools/torch_s2d_stages.py): 160^3, 5 -> 16
   -> 32 channels, f32 and bf16, B = 30 and 4, cudnn.benchmark off and
   on: the forward's and each parameter gradient's difference within
   S2D_REL_TOL and S2D_GRAD_REL_TOL, and ms of each form's forward and
   forward + backward beside its bound; one reference train step (f32,
   B = 30) with s2d_encoder on against the train phase's plain step from
   the same parameters on the same batch: the losses within
   S2D_STEP_LOSS_REL, each leaf's gradient within S2D_STEP_GRAD_RTOL, the
   s2d stages run once, the step's launches exact, 3 steps timed and the
   peak memory; register at main_path's config with s2d_encoder on
   against the plain pipeline: phi and warped within S2D_REGISTER_TOL,
   launches exact, the s2d stages run once, both timed in turns;
   profile_train_s2d: one reference step with s2d_encoder on under
   torch.profiler (as profile_train);
   profile_train: one reference step under torch.profiler (as in 10);
   then the training run's trainer and batch are freed;
   train_host_loader / train_device_loader: one epoch of 3 reference steps
   on the same files listed 3 times, its batches read by the host
   DataLoader (cache_on_device false) and then from the card-resident
   cache, each under torch.profiler: ms a step and the device's idle share;
   data_parallel: the trainer on a data mesh (liftreg_tpu_torch.parallel,
   one process a rank) at the reference config on the train dataset's
   first 6 and 5 cases (B = 6 and 5; 2 epochs of one step after a
   validation of 3 cases, then a resume for a third), against the
   one-process trainer at the same global batch: (a) one NCCL rank, its 2
   steps bit-equal to one card's (losses, parameters, Adam's moments)
   under deterministic algorithms; (b) 2 gloo ranks sharing the card
   (one pad row at B = 5): each logged loss within DP_LOSS_REL, the
   parameters and moments within DP_PARAM_TOL and DP_MOMENT_RTOL, the
   ranks' parameters bit-equal after the resume, each rank's launches
   exact, one step's collectives 2 calls of between the parameters' f32
   bytes and 1.1 times them plus 4096, and at B = 6 the step ms of each
   rank beside one process's (3 after a step alone); (c) a refined
   register (image domain, 30 steps, early stop) of B = 4 on the 2 ranks
   against one process: the same steps on both ranks and in one process,
   phi and warped within REFINE_REF_TOL; (d) negative controls: the
   gradients averaged over the ranks must break the moments' limit, and
   the refiner with no collective (each rank's early stop its own) must
   stop the ranks at different steps; with 2 or more cards, (b) at B = 6
   again over NCCL, one card a rank (else the line says it did not run);
   evaluate: a test split of 3 cases added to the train dataset (300
   landmark pairs each in DIR-Lab's layout, lung segmentations, a
   _prop.npy), and the port's eval CLI as a subprocess on the train
   phase's experiment: one CSV row per case, every TRE finite, every Dice
   in [0, 1], the one line about matplotlib where it is absent, the
   identity map's TRE equal to the landmarks' initial distance, and the
   Dice's nearest warp equal on the card and on the CPU;
   train_reference: 2 train steps at 32^3 on the card against the same
   steps on the CPU from the same parameters (losses, parameters and each
   step's Adam moments, which carry the gradients), then again with the
   card's warp coordinate gradient doubled, which the moments must catch;
   regnet_reference: the same for RegNet2D3D, with the card's image
   gradient doubled;
   subspace_train: LiftRegSubspace at the reference config (B = 30)
   through the CLI, one epoch of 2 steps (launch counts exact: no lift, no
   image gradient), one step alone, 2 timed; its forward on the card
   against the CPU at 32^3;
   regnet_train: RegNet2D3D at the learned-basis workflow's stage-1
   config (160^3, B = 1, 4 views on 240^2, full widths, 7 inverse steps,
   f32, its projection loss, Adam at 5e-4) through the CLI, one epoch of
   3 steps with validation and a checkpoint, then one step alone (lift 1,
   projector 3, adjoint 2 and its plan 1, warp 9, coordinate gradient 8,
   image gradient 8) and 5 timed after a warm-up;
   regnet_check: the image and coordinate gradients at that step's own
   shapes and values (disp and warped at idm + disp_inv, the attenuation
   at phi), kernel against plain, and the image gradient's overflow share
   there;
   profile_regnet: one RegNet2D3D step under torch.profiler, with the
   image gradient's device ms and launches;
9. times: each kernel, its plain version and one PyTorch library call of
   the same function, with CUDA events (the warp and its gradient in both
   layouts and with both tap types; the lift also as the serving path
   runs it, the encoder's bf16 input buffer (liftreg::encoder_input: the
   moving CT and the lift), with the bound of the bytes it moves and the
   f32 matmul chain after the moving CT, cast once to bf16, as its
   library call); the steady-state register time, with and without
   refinement (image domain with NCC and with LNCC, projection domain), and
   peak
   memory; the train step's median time and peak memory at the reference
   config, and the bf16 step's (measured in train and train_bf16); the
   image gradient, its plain version and grid_sampler_3d_backward's input
   gradient at C = 3, 160^3, B = 1 (and the kernel and the library call
   on the identity and on a 0.9-voxel field, as RegNet2D3D's inverse
   iteration warps; the kernel and its plain version with bf16 taps, beside
   their bound); the RegNet2D3D and LiftRegSubspace
   step times and peaks (measured in their phases);
   image_grad_overflow: the share of the image gradient's points that
   took its overflow path, at the timed shape and fields and at
   regnet_check's;
10. profile / profile_refine / profile_refine_projection: one register
   call, without refinement, with image-domain and with projection-domain
   refinement, under torch.profiler: device time by layer (from kernel
   names) and the device's idle share;
11. image_grad_bf16_check: the warp's image gradient of bf16 taps (the f32
   kernel's sums cast to bf16 once) against its plain version at 160^3
   and on a rough 64^3 field, both paddings;
12. learned_basis (the learned-basis workflow at 160^3, as its tools run
   it; the dataset is removed at the end): learned_basis_dataset writes a
   synthetic dataset (tools/torch_make_synthetic_dataset.py: anatomical
   texture, rank-4 deformations, 4 train / 1 val / 1 test cases, 4 views);
   learned_basis_optreg registers the 4 train pairs
   (tools/torch_build_pca.py disp_from_optreg: DenseRegisterer at its
   default levels, B = 2, bf16 taps), counts zeroed just before and read
   just after and checked exactly (per call 206 warps and 203 coordinate
   gradients, nothing else), each call's similarity and objective no worse
   at the end than at the start; profile_optreg_level profiles one level
   (20^3 grid, 60 steps); learned_basis_pca fits the PCA (EVR at each K);
   learned_basis_train trains the subspace model on that basis for 2 steps
   (bf16 basis and taps: finite losses, a checkpoint);
   learned_basis_eval runs it in test mode and prints the test case's
   learned and identity TRE; learned_basis_codec says whether the native
   codec or the numpy/zlib path ran and round-trips a case through
   compress_in_memory; optreg_oracle runs tools/torch_optreg_oracle.py on
   the 4 train pairs (default levels, B = 1, bf16 taps: 206 warps and 203
   coordinate gradients a pair, each pair's counts zeroed just before and
   read just after; finite errors, no pair's similarity worse at the end)
   and optreg_objective_ab tools/torch_optreg_objective_ab.py on them
   (NCC and LNCC, unmasked and lung-masked, each one call at B = 4: 164
   and 162 a variant; the masked variants read the 8 segmentation files,
   just before the first of them), with each pair's and variant's errors
   and seconds;
13. optreg_reference: one DenseRegisterer call at 32^3 (B = 2, two levels
   of 5 steps, bf16 taps) on the card against the CPU (the best grid, phi,
   disp, the warped volume and both histories), and with the card's
   coordinate gradient negated along one axis, which the histories must
   catch;
14. dirlab_chain: two synthetic raw int16 cases at DIR-Lab's tabulated
   COPD shapes and spacings (copd1 121 x 512 x 512, copd2 102 x 512 x 512)
   in DIR-Lab's folder layout, 300 landmark pairs each (1-indexed xyz of
   the raw grid, eBH = iBH + a seeded offset) and an expectations file
   with their closed-form initial distances, through
   tools/torch_dirlab_parity.py --raw --identity --enforce_landmark_count
   --epochs 2 as a subprocess (160^3, latent 56, 4 views, B = 2):
   PARITY OK, one CSV row a case with a finite TRE and a Dice in [0, 1],
   each stage's launches exact (the chain's summary line: the projector 10
   times, a train step lift + warp + coordinate gradient, a validation or
   test batch lift + warp, nothing else), each stage's seconds, the host's
   peak RSS and the bytes written;
15. dirlab_parity: the harness in process on the chain's output, against
   an experiment TRE 1 mm off (tol 0.5 mm) and an initial distance 1 mm
   off: each must exit 1 with that case's FAIL row; the chain's files are
   removed at the end.

Then the nvidia-smi line, one JSON line of per-kernel numbers for the
thirteen kernels (``launches``: for the image gradient one RegNet2D3D
step's, for the four gather probes the bench tool's run in gather_probe
(``repro_launches`` the repro tool's; their times at 160 x 128 f32, at
the bench's inner 8 and grid, and ``inner1`` at inner 1 and grid 1 with
the library call; ``bound_ms`` the largest of their device bytes, f32
operations and gathered elements read from shared memory at 128 bytes a
clock an SM, ``bound_of`` which; ``slope`` their times at inner 8 and 64
at 160 x 128 and 1280 x 128 f32 and the marginal gathered elements a
clock an SM between the two), for the others refine_projection's
register, which runs all eight;
``projection_launches`` from that register, ``serving_launches`` from
main_path's, ``image_refine_launches`` from refine's,
``train_launches``, ``train_bf16_launches``, ``regnet_launches`` and
``subspace_launches`` from one train step of each,
``data_parallel_rank_launches`` each rank's of one 2-rank step of
data_parallel; ``optreg_call_launches``
from one DenseRegisterer call of learned_basis and
``optreg_step_launches`` from one of its level steps;
``oracle_pair_launches`` and ``objective_ab_variant_launches`` from one
pair of optreg_oracle and one variant of optreg_objective_ab,
``dirlab_launches`` from the whole of dirlab_chain; the image gradient's
``bf16_taps_*`` times), and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero; so does a
missing card, and a watchdog after 18 minutes.
"""
import contextlib
import csv
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import weakref

WATCHDOG_S = 1080
# H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core and f32 peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# f32 operations per output of the warp: 3 axes x (clip, floor, t, two
# weights) and 8 corners x (2 weight products, 1 tap product, 1 sum)
WARP_OPS_PER_OUTPUT = 50
# the warp's coordinate gradient per output: the forward's weights plus
# their derivatives (3 axes x ~8), and 8 corners x 3 axes x (2 weight
# products, 1 multiply-add) per channel
WARP_GRAD_OPS_PER_OUTPUT = 24 + 8 * 3 * 4
# with phi: the pixel coordinates (an add and a multiply per axis) and the
# rescale's multiply and subtract; in the gradient the doubled cotangent and
# dphi's multiply per axis
WARP_PHI_OPS = 3 * 2 + 2
WARP_GRAD_PHI_OPS = 3 * 2 + 1 + 3
# f32 operations of one 2-tap interpolation: 2 x (1 multiply, 1 add). The
# DRR sums are separable, so their least work interpolates one axis per
# pass: per (b, p, plane) the projector needs res_d*H such values along x
# and res_d*res_h along z (accumulated over planes), the lift D*ph along u
# and D*H along v
DRR_OPS_PER_TWO_TAPS = 4
# one step of the adjoint plan's binary search: a subtraction, the sign's
# multiply and a comparison
PLAN_OPS_PER_STEP = 3
# the warp's image gradient: per point the three axes' taps and weights
# and the four (y, x) weight products, and per channel and tap two
# products and the atomic add
IMG_GRAD_OPS_PER_POINT = 30
IMG_GRAD_OPS_PER_TERM = 3
# image_grad_check's rough, slab and faces fields: ROUGH_SZ^3 volumes
ROUGH_SZ = 64

SZ = 160
B = 4
LATENT = 56
REFINE_STEPS = 30
PCA_TOL = 1e-5
WARP_TOL = 1e-6
# the projector sums the planes in another order than the plain dense
# products (relative to the largest line integral); the lift adds <= 4 taps
PROJ_REL_TOL = 1e-5
LIFT_TOL = 1e-6
# the coordinate gradient fuses multiply-adds that the plain version rounds
# twice (relative to the largest component)
WARP_GRAD_REL_TOL = 1e-5
# the warp's image gradient (f32 taps) adds each tap's terms with f32
# atomics in an order that changes from call to call: against the plain
# version, and a second call against the first, within 1e-5 of the largest
# value plus 1e-6 of the sum of the tap's terms' magnitudes (a border tap
# that takes a plane of points far outside sums ~25,600 terms)
IMG_GRAD_REL_TOL, IMG_GRAD_MAG_TOL = 1e-5, 1e-6
# the adjoint sums each view's tap pairs in another order than the plain
# dense products (relative to the largest value)
ADJ_REL_TOL = 1e-5
# refinement on the card against the CPU at 32^3 over 5 steps, f32 encoder
# and taps, bf16 basis: (phi, warped) of the card's run against the CPU's,
# and the objective history. With NGF (eps 1e-10 as in JAX, which weighs
# near-flat projection gradients fully) Adam's iterates are ill-conditioned
# there: a coefficient that reaches its optimum steps by the sign of a
# gradient that the two devices' f32 differences decide, and the CPU alone
# moves its (phi, warped) past REFINE_REF_TOL when its identity map moves by
# one ulp (tools/torch_refine_conditioning.py). So for NGF the card's (phi,
# warped) are held to the CPU's outputs at the card's own refined
# coefficients, its history to the CPU run's, and a run with a wrong
# coordinate gradient must break the history's limit
REFINE_REF_TOL = (1e-4, 1e-3)
REFINE_HISTORY_TOL = 1e-5
REFINE_AT_CARD_COEFS = ("projection_ngf",)
# the LNCC refinement's options in times (configs/lncc_v5e8)
LNCC_OPTS = {"smooth": 3}
# card against CPU at 32^3, (phi, warped): the two round the f32 HU
# normalisation differently by an ulp (CUDA divides by a scalar through its
# reciprocal), and the encoder's f32 convolutions sum in another order. With
# f32 taps that stays ~1e-6; with bf16 taps it can flip the rounding of one
# tap in [0.5, 1): 2^-8, doubled by the [0,1] -> [-1,1] rescale.
REF_F32_TOL = (1e-4, 1e-4)
REF_BF16_TOL = (1e-4, 2.0 ** -7)
# training at the reference config (configs/cur_task_setting.json): B = 30
# at 160^3, 4 views, latent 56, f32; the dataset's distinct volumes (the 30
# training cases are hard links to them) and its validation cases (fewer
# than a batch, so the eval batch is padded)
TRAIN_CONFIG = "configs/cur_task_setting.json"
FAST_TRAIN_CONFIG = "configs/fast_train/cur_task_setting.json"
TRAIN_B = 30
TRAIN_DISTINCT = 3
TRAIN_VAL = 3
TRAIN_EPOCHS = 2               # epochs 0, 1 and 2; the resume runs epoch 3
TRAIN_TIMED_STEPS = 5          # timed steps after one warm-up
BF16_STEPS = 3
# train_reference: 2 steps at 32^3 on the card against the CPU from the
# same parameters, f32: the losses and the parameters after the steps
# within atol 1e-5 (the f32 convolutions and the kernels sum in another
# order; Adam moves each weight by about lr = 1e-3 a step, so the
# gradients' differences reach the weights only where they are near 0)
TRAIN_REF_TOL = 1e-5
# and each step's Adam moments, which carry the gradients, within 1e-2 of
# each leaf's largest value: the card builds the lift's geometry with its
# own rounding, so the encoder's input differs slightly from the CPU's,
# and the first convolution's weight and bias gradients, whose sums
# cancel, carry that further than the other leaves; the same steps with
# the card's coordinate gradient doubled must exceed it
TRAIN_MOMENT_RTOL = 1e-2
# train_check: the plain versions at B = 30 run this many rows at a time
TRAIN_CHECK_ROWS = 10
# the PCA backward, kernel and plain version each, against the f64 product:
# within half a bf16 step of the exact sum, plus 1e-5 of the largest value
# for the f32 sums' order. Held against each other, the two can be a full
# bf16 step apart (up to 2^-7 of the value) where the exact sum lies at a
# rounding midpoint and their f32 sums round to opposite neighbours
PCA_GRAD_F64_REL_ATOL = 1e-5
# train_host_loader / train_device_loader: steps of the one epoch timed
TRAIN_LOADER_STEPS = 3
# evaluate: the test split the phase adds to the train phase's dataset,
# and the landmark pairs of each case (DIR-Lab's count)
EVAL_CASES = 3
EVAL_LANDMARKS = 300
# subspace_train: LiftRegSubspace at the reference config, one epoch of 2
# steps (the training files listed twice), then 2 timed steps
SUBSPACE_STEPS = 2
# RegNet2D3D at the stage-1 config of the learned-basis workflow
# (tools/paper_workflow_160.py:160-174): B = 1, 4 views, 7 inverse steps,
# lr 5e-4, the projection-loss dataset without the HU clip; one epoch of 3
# steps, then one step alone and 5 timed after a warm-up
REGNET_STEPS = 3
REGNET_TIMED_STEPS = 5
# one RegNet2D3D train step: the lift; the 7 inverse warps of disp, the warp
# of the attenuation by phi and of the result by the inverse; their
# coordinate gradients (not the first inverse warp's, at the identity) and
# image gradients (the 7 of disp and the inverse warp's of warped); the
# three re-projections, two of them differentiated through the adjoint and
# its plan, built once
REGNET_STEP_LAUNCHES = {"drr_backproject": 1, "warp_trilinear": 9,
                        "warp_coord_grad": 8, "warp_image_grad": 8,
                        "drr_project": 3, "drr_project_adjoint": 2,
                        "drr_adjoint_plan": 1}
# and each validation batch (no gradient): the lift, the warps, the
# projections
REGNET_VAL_LAUNCHES = {"drr_backproject": 1, "warp_trilinear": 9,
                       "drr_project": 3}

# learned_basis: a synthetic dataset from tools/torch_make_synthetic_dataset
# .py at 160^3 (anatomical texture, deformations of rank 4 at the DIR-Lab
# magnitude 0.12 and a respiratory wavelength of SZ / 4 voxels; 4 train,
# 1 val and 1 test cases; 4 views); per-pair registration of the 4 train
# pairs at DenseRegisterer's default levels, B = 2, bf16 taps, each call's
# launches checked exactly; the PCA (K = 4); 2 steps of the subspace model
# on that basis (B = 2, bf16 basis and taps); test mode and the TRE
LEARNED_SPLITS = (4, 1, 1)
LEARNED_RANK = 4
LEARNED_MAGNITUDE = 0.12
LEARNED_SEED = 0
OPTREG_B = 2
# the level profiled in learned_basis: DenseRegisterer's second (20^3 grid,
# 60 steps) at 160^3, B = 2
OPTREG_PROFILE_LEVEL = (20, 60, 0.02)
# optreg_reference: one DenseRegisterer call on the card against the same
# call on the CPU (the kernels' plain versions) at 32^3, B = 2, bf16 taps,
# two levels of 5 steps. The best grid, phi and disp within 1e-4 and the
# warped volume within 1e-3 (a coordinate moved by 1e-4 moves a bf16 tap's
# sample by up to ~1e-3 where the image is steep), the total and similarity
# histories within 1e-6 (measured on an H100: 1.8e-6, 1.6e-6, 1.4e-5 and
# 8.9e-8); the same call with the card's coordinate gradient negated along
# one axis must break the histories' limit (measured: 0.23). A grid node
# whose gradient is near 0 takes Adam's first step of a level by the sign
# of last-bit differences (2 lr apart): none does on these volumes
OPTREG_REF_SZ = 32
OPTREG_REF_LEVELS = ((5, 5, 0.04), (10, 5, 0.02))
OPTREG_REF_TOL = {"z": 1e-4, "phi": 1e-4, "disp": 1e-4, "warped": 1e-3,
                  "total_history": 1e-6, "sim_history": 1e-6}
# optreg_oracle / optreg_objective_ab: tools/torch_optreg_oracle.py on the
# 4 train pairs of learned_basis's dataset (DenseRegisterer's default
# levels, B = 1, bf16 taps) and tools/torch_optreg_objective_ab.py on the
# same 4 pairs at its default levels (four variants, each one call at
# B = 4); each DenseRegisterer call's counts zeroed just before it and read
# just after, and exact
OBJECTIVE_AB_LEVELS = "10:80:0.04,20:80:0.02"
OBJECTIVE_AB_VARIANTS = ("ncc", "lncc", "ncc_masked", "lncc_masked")

# dirlab_chain: two synthetic raw int16 cases at DIR-Lab's tabulated COPD
# shapes and spacings (copd1 121 x 512 x 512, copd2 102 x 512 x 512), in
# DIR-Lab's folder layout, each with 300 landmark pairs (1-indexed integer
# xyz in the raw voxel grid, inside the lungs; eBH = iBH + a seeded integer
# offset), through tools/torch_dirlab_parity.py --raw as a user runs it:
# preprocessing, DRRs, a placeholder basis, 2 epochs of training, test mode
# and TRE at its defaults (160^3, latent 56, 4 views, B = 2). The identity
# map's TRE must equal the closed-form initial distance within
# DIRLAB_INITIAL_TOL mm (f32 landmark coordinates of ~350 mm carry ~3e-5 mm
# a coordinate). dirlab_parity: the experiment against a TRE 1 mm off
# (tol 0.5 mm) and the identity against a distance 1 mm off must fail
DIRLAB_CASES = ("copd1", "copd2")
DIRLAB_LANDMARKS = 300
DIRLAB_EPOCHS = 2
DIRLAB_INITIAL_TOL = 0.01
DIRLAB_SEED = 5

# s2d: the encoder's first two stages in their space-to-depth form
# (liftreg_tpu_torch/models/s2d.py) against the plain ConvBlock pair on
# the same seeded parameters (tools/torch_s2d_stages.py: 160^3, f32 and
# bf16, B = 30 and 4, cudnn.benchmark off and on): the forward within
# S2D_REL_TOL of the plain forward's largest value, each parameter's
# gradient within S2D_GRAD_REL_TOL of the plain gradient's largest (the
# same sums in another order; in bf16 each form rounds its stage-0 output
# and the gradients into it once). The weight gradients of a random
# cotangent cancel over the B x 80^3 or 160^3 voxels they sum, so their
# order's rounding shows at ~1e-3 of the result in f32 and ~4e-2 in bf16
# (measured on an H100: at most 1.3e-6 and 1.25e-3 in f32, 5.5e-3 and
# 3.6e-2 in bf16)
S2D_REL_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
S2D_GRAD_REL_TOL = {"float32": 5e-3, "bfloat16": 2.0 ** -3}
# and one reference train step (f32, B = 30) with s2d_encoder on against
# the plain step from the same parameters on the same batch: the loss
# within S2D_STEP_LOSS_REL relative, each leaf's gradient within
# S2D_STEP_GRAD_RTOL of its largest value; then S2D_STEP_TIMED steps
# timed after a warm-up. register with s2d_encoder on (main_path's bf16
# config and weights) against the plain pipeline: phi within
# S2D_REGISTER_TOL[0] and warped within [1] (a bf16 encoder's coefficients
# round differently in the two forms); S2D_REGISTER_TIMED calls of each in
# turns (plain, s2d, s2d, plain) after 2 warm-ups. Measured on an H100:
# the losses equal, the gradients at most 1.1e-4 of their leaf's largest
# value; phi 2.1e-5 and warped 2.9e-3 apart (random-noise volumes)
S2D_STEP_LOSS_REL = 1e-5
S2D_STEP_GRAD_RTOL = 1e-3
S2D_STEP_TIMED = 3
S2D_REGISTER_TOL = (1e-4, 1e-2)
S2D_REGISTER_TIMED = 5

# image_grad_bf16_check: the image gradient of bf16 taps (the f32 kernel's
# sums, cast to bf16 once) against its plain version, within the f32
# tolerance and one bf16 step (2^-7 of the value)
IMG_GRAD_BF16_STEP = 2.0 ** -7

# serving: one-file artifacts (liftreg_tpu_torch/serving.py) of main_path's
# pipeline and weights, both entries; the steady state 5 calls after 2
# warm-ups, live and served in turns (live, served, served, live), and the
# served mean within 2% of the live mean; the program's bytes under 1% of
# the weights'; partial batches of 1 and 3 against the full batch's rows
# within 1e-6 (the same kernels on the same rows; reported whether equal);
# refined artifacts (30 steps, each domain) against the live refined
# pipeline within REFINE_REF_TOL (the regulariser's backward adds with
# atomics, so two refined calls differ in their last bits, which 30 Adam
# steps carry on), each timed 3 calls after a warm-up; an f32 artifact at
# 32^3 with TF32 on for the process, bit-equal to the live f32 pipeline,
# and the same exported on the CPU and moved to the card at load, within
# REF_F32_TOL of it;
# tools/torch_serve_batch.py on 5 cases (a full batch and one of 1)
SERVING_TIMED = 5
SERVING_TIME_TOL = 0.02
SERVING_PROGRAM_SHARE = 0.01
SERVING_PARTIAL_TOL = 1e-6
SERVING_REFINE_TIMED = 3
SERVING_F32_SZ = 32
SERVING_TOOL_CASES = 5

# data_parallel: the reference config (160^3, 4 views on 240^2, latent 56,
# f32, NCC) on the train phase's dataset, through the trainer of a data
# mesh (liftreg_tpu_torch.parallel) at global batches of 6 and 5 rows (on 2
# ranks one pad row): 2 epochs of one step, each after a validation of 3
# cases (padded to 6 rows), then a resume of the last checkpoint for a
# third; held against the one-process trainer at the same global batch
DP_BATCHES = (6, 5)
DP_EPOCHS = 1                  # epochs 0 and 1; the resume runs epoch 2
DP_TIMED_STEPS = 3
# each logged loss within 1e-4 relative of the one-process run's; the
# parameters after the 3 Adam steps within TRAIN_REF_TOL (the ranks sum
# the weight gradients of their halves of the batch, in another order than
# one process); Adam's moments, which carry the gradients (a gradient
# averaged over the ranks instead of summed halves mu, while Adam's steps
# would hardly see it), within 1e-3 of each leaf's largest value
DP_LOSS_REL = 1e-4
DP_PARAM_TOL = TRAIN_REF_TOL
DP_MOMENT_RTOL = 1e-3
# the sharded refined register: 160^3, B = 4 (rows 2 and 3, rank 1's,
# aligned and masked out entirely, so that their objective is flat and a
# rank alone would stop at another step), f32 encoder and taps, bf16
# basis, image domain, 30 steps, early stop after 3 steps without an
# improvement of 1e-4; phi and warped within REFINE_REF_TOL of the
# one-process call
DP_REFINE_PATIENCE = 3
DP_REFINE_TOL = 1e-4

# gather_probe: the gather probes' two tools as a user runs them
# (tools/torch_bench_mosaic_gather.py with --reps PROBE_REPS, its default
# grid of one pass an SM; tools/torch_repro_mosaic_gather_500.py), each with
# the counts zeroed just before and read just after; then every probe at
# every shape of both tools against its plain version, bit for bit: f32 and
# bf16, inner 1, 8 and 64, grid 1 and one pass an SM, indices of the axis's
# range (0 and its last among them), of the whole int32 range, and where
# the kernels' index walk turns (INT32_MAX - 63 .. INT32_MAX, where idx + k
# wraps, INT32_MIN, INT32_MIN + 1, -1, -n, n - 1); then each kernel's times
# at PROBE_SHAPE f32 (the bench's inner 8 and grid, and inner 1 at grid 1
# beside one library call), and at inner 8 and 64 at each of PROBE_SLOPE's
# f32 shapes, one pass an SM: the slope between the two gives the marginal
# gathered elements a clock an SM. The kernels' names in the kernels line,
# their wrappers and the TPU kernels they replace:
PROBE_KERNELS = {
    "gather_probe_rows": ("gather_rows", "tools/bench_mosaic_gather.py:94"),
    "gather_probe_lanes": ("gather_lanes",
                           "tools/bench_mosaic_gather.py:103"),
    "gather_probe_roll": ("roll_sum", "tools/bench_mosaic_gather.py:112"),
    "gather_probe_warp_step": ("warp_step",
                               "tools/bench_mosaic_gather.py:120")}
PROBE_REPS = 20
PROBE_INNER = (1, 8, 64)
PROBE_SHAPE = (160, 128)
PROBE_SLOPE = ((160, 128), (1280, 128))
PROBE_SLOPE_INNER = (8, 64)
# f32 operations per gathered element: the add (the warp step: the product
# and the add); the index arithmetic is integer work and not counted
PROBE_OPS_PER_ELEM = {"gather_rows": 1, "gather_lanes": 1, "roll_sum": 1,
                      "warp_step": 2}
# shared memory serves 128 bytes a clock on each SM: each gathered element
# is one read of it, which bounds the probes below the device bytes and
# the f32 operations
SMEM_BYTES_PER_CLOCK = 128

_state = {"phase": "start", "t0": time.perf_counter()}


def _expire():
    _stop_children()
    print(json.dumps({"watchdog_s": WATCHDOG_S, "phase": _state["phase"]}),
          flush=True)
    print(f"chip_smoke: watchdog expired in phase {_state['phase']}",
          file=sys.stderr, flush=True)
    os._exit(1)


def _stop_children():
    """End the processes this script started that are still running."""
    for proc in _state.get("children", ()):
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _begin(name):
    _state["phase"] = name
    _state["t0"] = time.perf_counter()


def _emit(**fields):
    import torch
    torch.cuda.synchronize()
    line = {"phase": _state["phase"],
            "seconds": round(time.perf_counter() - _state["t0"], 3)}
    line.update(fields)
    print(json.dumps(line), flush=True)


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke [{_state['phase']}]: {msg}")


def _cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _max_err(a, b):
    return float((a - b).abs().max())


def _f64_excess(torch, got, exact):
    """The largest excess of ``|got - exact|`` over half a bf16 step at
    each exact value plus PCA_GRAD_F64_REL_ATOL of the largest; <= 0 where
    ``got`` (a bf16-valued result) is the exact f64 sum rounded, up to the
    f32 sums' order."""
    # half a bf16 step at each exact value: |x| = m 2^e, m in [0.5, 1)
    half_step = torch.ldexp(torch.ones_like(exact),
                            torch.frexp(exact).exponent - 9)
    slack = PCA_GRAD_F64_REL_ATOL * float(exact.abs().max())
    return float(((got.double() - exact).abs() - half_step - slack).max())


def _layer(kernel_name):
    """Layer of a device kernel, from its name."""
    name = kernel_name.lower()
    for layer, keys in (("copy", ("memcpy",)),
                        ("drr_adjoint_plan", ("adjoint_plan",)),
                        ("drr_project_adjoint", ("adjoint_tiles",)),
                        ("pca_grad", ("pca_grad",)),
                        ("pca_expand", ("pca_expand",)),
                        ("warp_coord_grad", ("warp_coord_grad",)),
                        ("warp_image_grad", ("warp_image_grad",)),
                        ("warp_trilinear", ("warp_trilinear",)),
                        ("drr_project", ("drr_project",)),
                        ("drr_backproject", ("drr_backproject",)),
                        ("conv", ("conv", "cudnn", "winograd", "implicit",
                                  "fprop", "dgrad", "wgrad")),
                        ("matmul", ("gemm", "cublas", "cutlass")),
                        ("gather", ("gather", "index")),):
        if any(k in name for k in keys):
            return layer
    return "elementwise/other"


def _smooth_coords(torch, F, g, batch, sz, amp, device):
    """Pixel coords (batch, sz^3, 3): identity plus a smooth displacement of
    up to ~amp voxels; a slab of batch element 0 lies far outside."""
    low = torch.randn((batch, 3, 5, 5, 5), generator=g, device=device)
    disp = F.interpolate(low, size=(sz,) * 3, mode="trilinear",
                         align_corners=True) * amp
    ax = torch.arange(sz, dtype=torch.float32, device=device)
    ident = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"))
    coords = (ident[None] + disp).movedim(1, -1).contiguous()
    coords[0, :2] = 3.0 * sz            # far past the high end
    coords[0, -2:] = -2.0 * sz          # far below zero
    return coords.reshape(batch, -1, 3)


def _near_identity_phi(torch, F, g, batch, sz, amp, device):
    """phi (batch, 3, sz, sz, sz) of the identity plus a smooth displacement
    of up to ``amp`` voxels (amp 0: the identity, every point on its
    voxel), the kind of field RegNet2D3D's inverse iteration warps its
    displacement with."""
    ax = torch.arange(sz, dtype=torch.float32, device=device)
    ident = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"))[None]
    disp = _smooth_field(torch, F, g, (batch, 3) + (sz,) * 3, 5, device)
    coords = (ident + disp * amp).movedim(1, -1).reshape(batch, -1, 3)
    return _phi_of(coords.contiguous(), sz)


def _phi_of(coords, sz):
    """The normalized map (batch, 3, sz, sz, sz) whose pixel coordinates
    are ``coords`` (batch, sz^3, 3)."""
    half = (sz - 1) * 0.5
    return (coords / half - 1.0).reshape(
        coords.shape[0], sz, sz, sz, 3).movedim(-1, 1).contiguous()


def _unaligned(torch, t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary (the warp kernels' scalar paths)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def warp_phi_cases(torch, F, g, device):
    """The phi-layout cases of warp_check and grad_check: {name: (volume in
    [0, 1] (B, C, D, W, H) f32, phi (B, 3, *out_shape), cotangent
    (B, C, *out_shape))} at the serving shape with B = 1, 4 and 9 (smooth
    fields with slabs far outside, a quarter of batch element 0's points
    converted from integer pixel coordinates), M = 6001 points, phi and the
    cotangent one float off a 16-byte boundary, and volumes with a spatial
    dim of 1."""
    cases = {}
    for batch in (1, B, 9):
        coords = _smooth_coords(torch, F, g, batch, SZ, 4.0, device)
        coords[0, ::4] = torch.floor(coords[0, ::4])
        cases[f"serving_b{batch}"] = (
            torch.rand((batch, 1) + (SZ,) * 3, generator=g, device=device),
            _phi_of(coords, SZ),
            torch.randn((batch, 1) + (SZ,) * 3, generator=g, device=device))
    vol, phi, cot = cases[f"serving_b{B}"]
    cases["unaligned"] = (vol, _unaligned(torch, phi), _unaligned(torch, cot))
    shapes = {"ragged_m": ((37, 29, 41), (6001,)),
              "unit_d": ((1, SZ, SZ),) * 2, "unit_w": ((SZ, 1, SZ),) * 2,
              "unit_h": ((SZ, SZ, 1),) * 2}
    for name, (spatial, out_shape) in shapes.items():
        phi = torch.rand((2, 3) + out_shape, generator=g,
                         device=device) * 2.6 - 1.3
        cases[name] = (
            torch.rand((2, 2) + spatial, generator=g, device=device), phi,
            torch.randn((2, 2) + out_shape, generator=g, device=device))
    return cases


def image_grad_cases(torch, F, g, device):
    """The image gradient's cases of image_grad_check: {name: (f32 taps
    (B, C, D, W, H) (read for their shape), points, cotangent, phi
    layout?)}: C = 1 and 3 at the serving shape with B = 1 and 2 in both
    layouts (smooth fields with slabs far outside, a quarter of the points
    on integers, planes on and just past the edges), phi and the cotangent
    off a 16-byte boundary, M = 6001 points, and unit dims; at ROUGH_SZ^3
    with B = 2, C = 1 and 3, both layouts: a rough field, a slab far
    outside along y and a field clamped onto the faces."""
    cases = {}
    for C in (1, 3):
        for batch in (1, 2):
            coords = _smooth_coords(torch, F, g, batch, SZ, 4.0, device)
            coords[:, ::4] = torch.floor(coords[:, ::4])
            planes = coords.view(batch, SZ, SZ, SZ, 3)
            for k, v in enumerate((0.0, SZ - 1.0, -0.5, SZ - 0.5)):
                planes[-1, 2 + k] = v
            vol = torch.zeros((batch, C) + (SZ,) * 3, device=device)
            cot = torch.randn((batch, C) + (SZ,) * 3, generator=g,
                              device=device)
            cases[f"phi/c{C}_b{batch}"] = (vol, _phi_of(coords, SZ), cot,
                                           True)
            cases[f"pixel/c{C}_b{batch}"] = (vol, coords,
                                             cot.reshape(batch, C, -1), False)
    # fields whose tiles' boxes overflow the kernel's shared memory (a rough
    # field; under border padding a slab of 3 y rows far outside, which
    # clips onto the far face while its tiles' other points do not) or end
    # exactly at the volume's faces (a field clamped onto them)
    ax = torch.arange(ROUGH_SZ, dtype=torch.float32, device=device)
    ident = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"))[None]
    for C in (1, 3):
        smooth = ident + _smooth_field(torch, F, g, (2, 3) + (ROUGH_SZ,) * 3,
                                       5, device) * 4.0
        fields = {
            "rough": ident + torch.rand((2, 3) + (ROUGH_SZ,) * 3,
                                        generator=g, device=device)
            * 24.0 - 12.0,
            "slab": smooth.clone(),
            "faces": smooth.clamp(0.0, ROUGH_SZ - 1.0)}
        fields["slab"][:, 1, :, 5:8] = 4.0 * ROUGH_SZ
        for name, pix in fields.items():
            coords = pix.movedim(1, -1).reshape(2, -1, 3).contiguous()
            vol = torch.zeros((2, C) + (ROUGH_SZ,) * 3, device=device)
            cot = torch.randn((2, C) + (ROUGH_SZ,) * 3, generator=g,
                              device=device)
            cases[f"phi/{name}_c{C}"] = (vol, _phi_of(coords, ROUGH_SZ), cot,
                                         True)
            cases[f"pixel/{name}_c{C}"] = (vol, coords, cot.reshape(2, C, -1),
                                           False)
    vol, phi, cot, _ = cases["phi/c3_b1"]
    cases["phi/unaligned"] = (vol, _unaligned(torch, phi),
                              _unaligned(torch, cot), True)
    shapes = {"ragged_m": ((37, 29, 41), (6001,)),
              "unit_d": ((1, SZ, SZ),) * 2, "unit_w": ((SZ, 1, SZ),) * 2,
              "unit_h": ((SZ, SZ, 1),) * 2}
    for name, (spatial, out_shape) in shapes.items():
        phi = torch.rand((2, 3) + out_shape, generator=g,
                         device=device) * 2.6 - 1.3
        cases[f"phi/{name}"] = (
            torch.zeros((2, 2) + spatial, device=device), phi,
            torch.randn((2, 2) + out_shape, generator=g, device=device), True)
    return cases


def image_grad_errs(fn, plain, vol, pts, cot, border, **flags):
    """The image-gradient kernel ``fn`` against ``plain``, called twice:
    {max abs error, that over the largest value, the largest excess over
    the tolerance of the kernel and of its second call (<= 0 passes)}."""
    got = fn(vol, pts, cot, border, **flags)
    again = fn(vol, pts, cot, border, **flags)
    want = plain(vol, pts, cot, border, **flags)
    tol = IMG_GRAD_REL_TOL * float(want.abs().max()) + IMG_GRAD_MAG_TOL \
        * plain(vol, pts, cot.abs(), border, **flags)
    err = _max_err(got, want)
    return {"max_abs_err": err, "rel_err": err / float(want.abs().max()),
            "excess": float(((got - want).abs() - tol).max()),
            "repeat_excess": float(((again - got).abs() - tol).max())}


def split_root(root, src, splits):
    """A dataset root over the files of the dataset at ``src`` whose
    splits list the given case names ({phase: names})."""
    import numpy as np
    for phase, names in splits.items():
        os.makedirs(os.path.join(root, phase))
        np.save(os.path.join(root, phase, "data_id.npy"), np.array(names))
    for d in ("preprocessed", "drr", "pca"):
        os.symlink(os.path.join(src, d), os.path.join(root, d))
    return root


def write_eval_split(root, sz, n_cases, n_distinct, n_points, seed):
    """A test split of ``n_cases`` cases in the train dataset at ``root``
    (volumes of ``sz``^3)
    (hard links to its ``n_distinct`` distinct cases' volumes,
    segmentations and projections), each with a ``_prop.npy`` and
    ``n_points`` landmark pairs in DIR-Lab's layout
    (``landmarks/<case>_300_{iBH,eBH}_xyz_r1.txt``: 1-indexed x y z, tab
    separated), the target points a seeded shift of the source points.
    Returns the case names."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pre = os.path.join(root, "preprocessed")
    drr_dir = os.path.join(root, "drr", "drr", "drr")
    lm_dir = os.path.join(root, "landmarks")
    os.makedirs(lm_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    names = [f"te{i:02d}" for i in range(n_cases)]
    for i, name in enumerate(names):
        for f in ("source", "target", "source_seg", "target_seg"):
            os.link(os.path.join(pre, f"d{i % n_distinct}_{f}.npy"),
                    os.path.join(pre, f"{name}_{f}.npy"))
        for f in ("source_proj", "target_proj"):
            os.link(os.path.join(drr_dir, f"d{i % n_distinct}_{f}.npy"),
                    os.path.join(drr_dir, f"{name}_{f}.npy"))
        np.save(os.path.join(pre, f"{name}_prop.npy"),
                {"origin": np.zeros(3), "spacing": np.full(3, 2.2)})
        src = rng.uniform(sz / 8, sz * 7 / 8, (n_points, 3))
        tgt = src + rng.normal(scale=1.5, size=src.shape)
        for suffix, pts in (("iBH", src), ("eBH", tgt)):
            with open(os.path.join(lm_dir, f"{name}_300_{suffix}_xyz_r1.txt"),
                      "w") as f:
                f.writelines(f"{p[0]:.4f}\t{p[1]:.4f}\t{p[2]:.4f}\n"
                             for p in pts)
    np.save(os.path.join(root, "test", "data_id.npy"), np.array(names))
    return names


def regnet_setting(root, out, **train):
    """The setting of RegNet2D3D at the stage-1 config of the learned-basis
    workflow (``tools/paper_workflow_160.py:160-174``) on the dataset under
    ``root``: the reference config with the projection-loss dataset
    without the HU clip, RegNet2D3D with 4 views and 7 inverse steps, its
    loss, Adam at lr 5e-4, B = 1."""
    cfg = train_setting(TRAIN_CONFIG, root, out, debug_on=False, **train)
    cfg["dataset"].update(dataset_class="registration2d3d_projloss",
                          apply_hu_clip=False)
    cfg["train"].update(model_class="regnet2d3d", loss_class="regnet2d3d")
    cfg["train"]["model"] = {"drr_feature_num": 4, "inverse_iters": 7}
    cfg["train"]["optim"]["lr"] = 5e-4
    cfg["train"]["dataloader"]["batch_size"] = 1
    return cfg


def _smooth_field(torch, F, g, shape, low, device):
    """(shape[0], shape[1], *shape[2:]) smooth random field in [-1, 1]:
    normal noise on a low^3 grid, trilinear up to the full size."""
    coarse = torch.randn(tuple(shape[:2]) + (low,) * 3, generator=g,
                         device=device)
    field = F.interpolate(coarse, size=tuple(shape[2:]), mode="trilinear",
                          align_corners=True)
    return field / field.abs().amax(dim=(2, 3, 4), keepdim=True)


def _smooth_basis(torch, F, g, latent, sz, amp, device):
    """(latent, 3*sz^3) bf16 basis of smooth displacement fields of up to
    ``amp`` in normalized units, built a few rows at a time."""
    rows = []
    for start in range(0, latent, 8):
        n = min(8, latent - start)
        rows.append((_smooth_field(torch, F, g, (n, 3) + (sz,) * 3, 6, device)
                     * amp).reshape(n, -1).to(torch.bfloat16))
    return torch.cat(rows)


def _edge_pix(torch, g, shape, n, device):
    """Uniform coordinates with a third replaced by the edges of the DRR's
    per-tap zero padding: (-1, 0), 0, n-1, (n-1, n) and beyond."""
    pix = torch.rand(shape, generator=g, device=device) * (n + 3.0) - 2.0
    special = torch.tensor([-1.5, -1.0, -0.25, 0.0, 0.5, n - 1.0, n - 0.75,
                            n - 1.5, float(n), n + 2.0], device=device)
    pick = torch.randint(0, len(special), shape, generator=g, device=device)
    mask = torch.rand(shape, generator=g, device=device) < 0.33
    return torch.where(mask, special[pick], pix).contiguous()


def serving_drr_inputs(torch, drr, g, device):
    """The DRR kernels' inputs at the serving shape (SZ^3, B volumes, 4
    views on the default detector): poses, detector resolution, the
    projector's and the lift's geometry, seeded attenuation volumes and
    projections. ``drr`` is the port's ``ops.drr`` module."""
    poses = torch.from_numpy(drr.synthesize_poses(30.0, 4, SZ)).to(device)
    res = drr.default_resolution((SZ,) * 3)
    fwd_geom = drr.forward_geometry(poses, (SZ,) * 3, res, (2.2, 2.2, 2.2))
    bwd_geom = drr.backward_geometry(poses, (SZ,) * 3, res)
    att = torch.rand((B, SZ, SZ, SZ), generator=g, device=device) * 0.2
    proj = torch.rand((B, 4) + res, generator=g, device=device) * 2.0 - 1.0
    return poses, res, fwd_geom, bwd_geom, att, proj


def refine_inputs(torch, F, g, device):
    """The refine phase's seeded inputs at the serving shape: smooth HU
    fields, the target a smooth shift of the source (so that NCC has
    something to align), a lung mask and a smooth bf16 basis. Returns
    (source HU, target HU, segmentation, pca)."""
    shape = (B, 1, SZ, SZ, SZ)
    base_hu = _smooth_field(torch, F, g, shape, 12, device)
    src = (base_hu * 400.0 - 500.0).contiguous()
    tgt = (torch.roll(base_hu, shifts=(2, -3, 1), dims=(2, 3, 4)) * 400.0
           - 500.0 + _smooth_field(torch, F, g, shape, 8, device) * 50.0)
    seg = (_smooth_field(torch, F, g, shape, 4, device) > -0.6).float()
    pca = {"vectors": _smooth_basis(torch, F, g, LATENT, SZ, 0.05, device),
           "mean": torch.zeros((3 * SZ ** 3,), device=device)}
    return src, tgt, seg, pca


def write_train_dataset(torch, F, drr, project_taps, root, sz, n_train,
                        n_val, n_distinct, latent, views, g, device):
    """A dataset in Registration2D3DDataset's layout under ``root``:
    ``{phase}/data_id.npy``, ``preprocessed/<case>_source|target(_seg).npy``
    (smooth seeded HU volumes, the target a smooth shift of the source),
    ``drr/drr/drr/<case>_source|target_proj.npy`` made by the port's
    projector from the volumes as the dataset orients them, ``poses.npy``
    and a smooth seeded f32 basis ``pca/pca_vectors.npy``/``pca_mean.npy``.
    The cases are hard links to ``n_distinct`` distinct ones."""
    import numpy as np
    pre = os.path.join(root, "preprocessed")
    drr_dir = os.path.join(root, "drr", "drr", "drr")
    pca_dir = os.path.join(root, "pca")
    for d in (pre, drr_dir, pca_dir):
        os.makedirs(d, exist_ok=True)
    poses = drr.synthesize_poses(30.0, views, sz)
    np.save(os.path.join(drr_dir, "poses.npy"), poses)
    res = drr.default_resolution((sz,) * 3)
    geom = drr.forward_geometry(torch.from_numpy(poses).to(device), (sz,) * 3,
                                res, (2.2, 2.2, 2.2))
    shape = (1, 1) + (sz,) * 3
    files = ("source", "target", "source_seg", "target_seg",
             "source_proj", "target_proj")
    for k in range(n_distinct):
        base = _smooth_field(torch, F, g, shape, 8, device)
        vols = {"source": base * 450.0 - 500.0,
                "target": torch.roll(base, shifts=(2, -3, 1), dims=(2, 3, 4))
                * 450.0 - 500.0
                + _smooth_field(torch, F, g, shape, 6, device) * 40.0}
        for side in ("source", "target"):
            hu = vols[side][0, 0]
            np.save(os.path.join(pre, f"d{k}_{side}.npy"), hu.cpu().numpy())
            np.save(os.path.join(pre, f"d{k}_{side}_seg.npy"),
                    (hu > -700.0).float().cpu().numpy())
            # the dataset flips axis 1 (SAR -> SPR) when it reads a volume
            att = drr.calc_relative_atten_coef(torch.flip(hu, dims=(1,)))
            proj = project_taps(att[None].contiguous(), *geom)[0]
            np.save(os.path.join(drr_dir, f"d{k}_{side}_proj.npy"),
                    proj.cpu().numpy())
    for phase, n, prefix in (("train", n_train, "tr"), ("val", n_val, "va")):
        os.makedirs(os.path.join(root, phase), exist_ok=True)
        names = [f"{prefix}{i:02d}" for i in range(n)]
        np.save(os.path.join(root, phase, "data_id.npy"), np.array(names))
        for i, name in enumerate(names):
            for f in files:
                folder = drr_dir if f.endswith("proj") else pre
                os.link(os.path.join(folder, f"d{i % n_distinct}_{f}.npy"),
                        os.path.join(folder, f"{name}_{f}.npy"))
    rows = []
    for start in range(0, latent, 8):
        n = min(8, latent - start)
        rows.append((_smooth_field(torch, F, g, (n, 3) + (sz,) * 3, 6, device)
                     * 0.05).reshape(n, -1).cpu().numpy())
    np.save(os.path.join(pca_dir, "pca_vectors.npy"), np.concatenate(rows))
    np.save(os.path.join(pca_dir, "pca_mean.npy"),
            np.zeros(3 * sz ** 3, np.float32))
    return root


def train_setting(path, root, out, **train):
    """The setting of ``path`` (a cur_task_setting.json) on the dataset
    under ``root``: its data and basis paths, its output folder, and the
    given train keys. Figures are off (the card's machine has no
    matplotlib); validation and a checkpoint come every epoch."""
    with open(path) as f:
        cfg = json.load(f)
    cfg["dataset"]["data_path"] = root
    cfg["train"]["model"]["pca_path"] = os.path.join(root, "pca")
    cfg["train"]["output_path"] = out
    cfg["train"].update(save_fig=False, val_frequency=1,
                        save_model_frequency=1)
    cfg["train"].update(train)
    return cfg


def read_metrics(exp):
    """{tag: {step: value}} of a training run's logs/metrics.jsonl."""
    out = {}
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


def glue_ops(torch, fn, batch, sz):
    """Run ``fn`` under a dispatch mode that sees every aten op, backward
    included and inside the ``liftreg::`` kernel operators, and count: all
    ops; ops whose result is a coordinate buffer
    (last dim 3 and batch * 3 * sz^3 elements); the warp's rescale, 1
    subtracted from a volume of batch * sz^3 elements that was multiplied
    by 2; casts of a (batch, 1, sz, sz, sz) volume to bf16, the moving
    image's taps; and the transfers that stall the stream: tensors copied
    from the host to the card (a device tensor made from host data, or a
    copy from a CPU tensor) and values read back from the card."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    aten = torch.ops.aten
    counts = {"ops": 0, "coordinate_buffers": 0, "rescales": 0,
              "tap_casts": 0, "host_to_device": 0, "device_to_host": 0}
    doubled = set()
    n_coords = batch * 3 * sz ** 3

    def scalar_of(args, value):
        """``args`` are a tensor and the Python number ``value``."""
        return len(args) > 1 and isinstance(args[0], torch.Tensor) \
            and isinstance(args[1], (int, float)) and args[1] == value

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "liftreg":
                # a kernel's operator: count the ops of its implementation
                # too (the plain version's glue on the CPU, the output's
                # allocation on the card), with this mode on again below it
                cuda = any(t.device.type == "cuda" for t in tree_leaves(
                    (args, kwargs)) if isinstance(t, torch.Tensor))
                key = torch._C.DispatchKey.CUDA if cuda \
                    else torch._C.DispatchKey.CPU
                with self:
                    return func.redispatch(torch._C.DispatchKeySet(key),
                                           *args, **(kwargs or {}))
            out = func(*args, **(kwargs or {}))
            counts["ops"] += 1
            for o in tree_leaves(out):
                if isinstance(o, torch.Tensor) and o.dim() >= 2 \
                        and o.shape[-1] == 3 and o.numel() == n_coords:
                    counts["coordinate_buffers"] += 1
            op = func.overloadpacket
            if op is aten.mul and scalar_of(args, 2.0) \
                    and args[0].numel() == batch * sz ** 3:
                doubled.add(id(out))
                weakref.finalize(out, doubled.discard, id(out))
            if op is aten.sub and scalar_of(args, 1.0) \
                    and id(args[0]) in doubled:
                counts["rescales"] += 1
            if op is aten._to_copy and out.dtype == torch.bfloat16 \
                    and tuple(out.shape) == (batch, 1) + (sz,) * 3:
                counts["tap_casts"] += 1
            # (source, destination) of a copy between devices
            src_dst = {aten._to_copy: (0, None), aten.copy_: (1, 0),
                       aten.lift_fresh: (None, None)}
            if op in src_dst:
                s_i, d_i = src_dst[op]
                src = "cpu" if s_i is None else args[s_i].device.type
                dst = (out if d_i is None else args[d_i]).device.type
                if src == "cpu" and dst == "cuda":
                    counts["host_to_device"] += 1
                if src == "cuda" and dst == "cpu":
                    counts["device_to_host"] += 1
            if op is aten._local_scalar_dense \
                    and args[0].device.type == "cuda":
                counts["device_to_host"] += 1
            return out

    with Count():
        fn()
    return counts


def _warp_flags(torch):
    """(taps type, border, scale_intensity) of each phi-layout case."""
    return [(tdt, border, rescale)
            for tdt in (torch.bfloat16, torch.float32)
            for border in (False, True) for rescale in (False, True)]


def _flag_key(tdt, border, rescale):
    return (f"{str(tdt).split('.')[-1]}/{'border' if border else 'zeros'}"
            f"{'/scaled' if rescale else ''}")


def _counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def _zero(kernels):
    for fn in kernels.values():
        fn.launches = 0


@contextlib.contextmanager
def negated_coord_grad(warp_kernel):
    """Within the block, the warp's coordinate gradient comes back negated
    along its first axis: a wrong gradient (not a scaled one, which Adam's
    steps would not see), for the negative controls."""
    kernel = warp_kernel.warp_coord_grad

    def negated(*args, **kwargs):
        out = kernel(*args, **kwargs).clone()
        phi_layout = kwargs.get("normalized",
                                len(args) > 4 and bool(args[4]))
        out.select(1 if phi_layout else -1, 0).neg_()
        return out

    negated.launches = 0
    warp_kernel.warp_coord_grad = negated
    try:
        yield
    finally:
        warp_kernel.warp_coord_grad = kernel


def image_grad_bf16_check(torch, F, warp_kernel, device):
    """The image gradient of bf16 taps, kernel against plain, at 160^3
    (C = 1, B = 2, phi layout with scale_intensity, both paddings) and on a
    rough 64^3 field; returns the largest excess over the tolerance."""
    g = torch.Generator(device=device).manual_seed(11)
    excess = {}
    for name, sz, amp in (("serving", SZ, 4.0), ("rough", ROUGH_SZ, 0.0)):
        phi = _near_identity_phi(torch, F, g, 2, sz, amp, device)
        if name == "rough":
            phi = (phi + torch.rand(phi.shape, generator=g, device=device)
                   * 0.4 - 0.2).contiguous()
        vol = torch.zeros((2, 1) + (sz,) * 3, device=device,
                          dtype=torch.bfloat16)
        cot = torch.randn((2, 1) + (sz,) * 3, generator=g, device=device)
        for border in (False, True):
            got = warp_kernel.warp_image_grad(vol, phi, cot, border,
                                              normalized=True,
                                              scale_intensity=True).float()
            want = warp_kernel.warp_image_grad_plain(
                vol, phi, cot, border, normalized=True,
                scale_intensity=True).float()
            mag = warp_kernel.warp_image_grad_plain(
                vol.float(), phi, cot.abs(), border, normalized=True,
                scale_intensity=True)
            tol = (IMG_GRAD_REL_TOL * float(want.abs().max())
                   + IMG_GRAD_MAG_TOL * mag + IMG_GRAD_BF16_STEP * want.abs())
            key = f"{name}/{'border' if border else 'zeros'}"
            excess[key] = float(((got - want).abs() - tol).max())
    return excess


def start_learned_dataset(root):
    """Start tools/torch_make_synthetic_dataset.py writing learned_basis's
    dataset under ``root`` in a process of its own, on the CPU (its
    phantoms are host work: ~105 s at 160^3 beside the card, ~215 s on the
    CPU beside the earlier phases, which it leaves the card to), with 2
    threads; returns the process."""
    n_train, n_val, n_test = LEARNED_SPLITS
    cmd = [sys.executable, "tools/torch_make_synthetic_dataset.py", "-o",
           root, "--size", str(SZ), "--n_train", str(n_train), "--n_val",
           str(n_val), "--n_test", str(n_test), "--n_proj", "4", "--latent",
           str(LEARNED_RANK), "--seed", str(LEARNED_SEED),
           "--deformation_rank", str(LEARNED_RANK), "--texture",
           "anatomical", "--deformation_smooth", str(SZ // 4),
           "--deformation_magnitude", str(LEARNED_MAGNITUDE), "--device",
           "cpu"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, OMP_NUM_THREADS="2"))
    proc.started = time.perf_counter()
    _state.setdefault("children", []).append(proc)
    return proc


def learned_basis(torch, kernels, root, dataset_proc, profile_call=None):
    """The learned-basis workflow on the card at 160^3 (see the constants
    above), as its tools run it, on the dataset that ``dataset_proc``
    (:func:`start_learned_dataset`) writes. Emits one line per step;
    returns the launches of one DenseRegisterer call and of one of its
    level steps, and the TRE."""
    import numpy as np

    from liftreg_tpu_torch import native, optreg
    from liftreg_tpu_torch import pca as pca_lib
    from liftreg_tpu_torch.data.dataset import Registration2D3DDataset
    from liftreg_tpu_torch.train import RegistrationTrainer
    from liftreg_tpu_torch.utils.settings import default_task_setting
    from liftreg_tpu_torch.utils.tre import eval_copd_highres
    from tools.torch_build_pca import disp_from_optreg
    from tools.torch_paper_workflow import identity_tre
    from tools.torch_profile_optreg import pairs

    _begin("learned_basis_dataset")
    n_train, n_val, n_test = LEARNED_SPLITS
    out, _ = dataset_proc.communicate(timeout=600)
    _emit(size=SZ, splits=LEARNED_SPLITS, rank=LEARNED_RANK,
          magnitude=LEARNED_MAGNITUDE, smooth=SZ // 4,
          seconds_since_start=time.perf_counter() - dataset_proc.started,
          returncode=dataset_proc.returncode, output_tail=out[-400:])
    _require(dataset_proc.returncode == 0,
             f"the dataset tool exited {dataset_proc.returncode}")

    _begin("learned_basis_optreg")
    reg = optreg.DenseRegisterer((SZ,) * 3)
    warps, grads = reg.launches()
    n_calls = -(-n_train // OPTREG_B)
    calls = []
    _zero(kernels)
    t0 = time.perf_counter()
    fields = disp_from_optreg(root, batch=OPTREG_B, verbose=False,
                              record=calls, device="cuda")
    seconds = time.perf_counter() - t0
    got = _counts(kernels)
    want = dict({k: 0 for k in kernels}, warp_trilinear=n_calls * warps,
                warp_coord_grad=n_calls * grads)
    steps = sum(n + 1 for _, n, _ in reg.levels)
    call_launches = {k: v // n_calls for k, v in got.items()}
    # a level step: one gradient evaluation (its warp and coordinate
    # gradient); each level adds one forward at its selected iterate
    step_launches = {k: (v - (len(reg.levels) if k == "warp_trilinear"
                              else 0)) / steps
                     for k, v in call_launches.items()}
    sims = [[float(c["sim_history"][0]), float(c["sim_history"][-1])]
            for c in calls]
    totals = [[float(c["total_history"][0]), float(c["total_history"][-1])]
              for c in calls]
    _emit(launches=got, expected=want, calls=n_calls, batch=OPTREG_B,
          levels=reg.levels, seconds_total=seconds,
          seconds_per_call=seconds / n_calls,
          seconds_per_pair=seconds / n_train, call_launches=call_launches,
          step_launches=step_launches, sim_first_last=sims,
          total_first_last=totals, fields=list(fields.shape))
    _require(got == want, f"optreg launches {got}, expected {want}")
    _require(all(last <= first for first, last in sims + totals),
             f"a call ended worse than it started: sim {sims}, "
             f"total {totals}")
    _require(bool(np.isfinite(fields).all()), "non-finite optreg fields")

    if profile_call is not None:
        _begin("profile_optreg_level")
        g_lvl, n_lvl, lr_lvl = OPTREG_PROFILE_LEVEL
        level = optreg.make_level((SZ,) * 3, g_lvl, n_steps=n_lvl,
                                  lr=lr_lvl, warp_taps_dtype=torch.bfloat16)
        moving, target = (t.to("cuda") for t in pairs(root, OPTREG_B))
        z0 = torch.zeros((OPTREG_B, 3) + (g_lvl,) * 3, device="cuda")
        level(z0, moving, target)                       # warm-up
        profile_call(lambda: level(z0, moving, target), steps=n_lvl + 1,
                     level=OPTREG_PROFILE_LEVEL, batch=OPTREG_B)
        del moving, target, z0, level

    _begin("learned_basis_pca")
    t0 = time.perf_counter()
    vectors, mean = pca_lib.fit_pca(fields, n_train)
    pca_dir = os.path.join(root, "pca_from_optreg")
    pca_lib.save_pca(pca_dir, vectors, mean)
    evr = {k: pca_lib.explained_variance_ratio(fields, vectors[:k], mean)
           for k in (1, 2, n_train)}
    _emit(seconds_fit=time.perf_counter() - t0, evr=evr,
          vectors=list(vectors.shape))
    _require(all(math.isfinite(v) and 0.0 <= v <= 1.0 + 1e-6
                 for v in evr.values()) and evr[n_train] > 0.999,
             f"EVR {evr}")
    del fields

    _begin("learned_basis_train")
    exp = os.path.join(root, "exp_subspace")
    # "epoch" is the last epoch's index: one epoch of n_train / 2 steps
    setting = default_task_setting(root, exp, SZ, overrides={"train": {
        "epoch": 0, "save_fig": False,
        "model": {"latent_dim": n_train, "pca_path": pca_dir,
                  "pca_dtype": "bfloat16", "warp_taps_dtype": "bfloat16"}}})
    t0 = time.perf_counter()
    RegistrationTrainer(setting, device="cuda").run()
    train_s = time.perf_counter() - t0
    losses = read_metrics(exp).get("Train/total_loss", {})
    ckpt = os.path.join(exp, "checkpoints", "model_best.ckpt")
    _emit(seconds=train_s, steps=len(losses),
          total_loss=[losses[k] for k in sorted(losses)],
          checkpoint=os.path.isfile(ckpt))
    _require(len(losses) == n_train // 2 and all(
        math.isfinite(v) for v in losses.values()),
        f"stage-3 losses {losses}")
    _require(os.path.isfile(ckpt), "no stage-3 checkpoint")

    _begin("learned_basis_eval")
    setting["train"].update(mode="test", test_from=ckpt, save_3d_img=True)
    RegistrationTrainer(setting, device="cuda").run()
    results = eval_copd_highres(root, exp, dim=(SZ,) * 3, device="cuda")
    learned = float(np.mean([r["dist"] for r in results]))
    identity = identity_tre(root, root, SZ, "cuda")
    _emit(tre_learned_mm=learned, tre_identity_mm=identity,
          cases=[r["id"] for r in results])
    _require(len(results) == n_test and math.isfinite(learned)
             and math.isfinite(identity), f"TRE {results}, {identity}")

    _begin("learned_basis_codec")
    opt = {"drr_folder_name": "drr", "use_segmentation_map": True,
           "spacing_to_refer": [2.2] * 3, "load_projection_interval": 1,
           "apply_hu_clip": True}
    packed = Registration2D3DDataset(root, "test", option=dict(
        opt, compress_in_memory=True))
    plain = Registration2D3DDataset(root, "test", option=opt)
    (ps, _), (qs, _) = packed[0], plain[0]
    raw = sum(v.nbytes for v in qs.values())
    stored = sum(len(v[1]) for v in packed.cases[0].values())
    same = all(np.array_equal(ps[k], qs[k]) for k in qs)
    _emit(native=native.native_available(),
          path="native" if native.native_available() else "numpy_zlib",
          library=os.path.relpath(native.library_path()),
          round_trip_equal=same, raw_bytes=raw, packed_bytes=stored)
    _require(same, "compress_in_memory changed a sample")
    tools = optreg_tools(torch, kernels, root)
    return {"call": call_launches, "step": step_launches,
            "tre_learned_mm": learned, "tre_identity_mm": identity,
            "oracle_pair": tools["oracle_pair"],
            "ab_variant": tools["ab_variant"]}


def serving_phase(torch, kernels, pipe, pca, args, proj, refined, root,
                  serving_launches, time_tol=SERVING_TIME_TOL,
                  f32_sz=SERVING_F32_SZ, device="cuda"):
    """The serving phase (see the constants above): ``pipe`` and ``pca`` are
    main_path's, ``args`` its (source, target, seg, seg), ``proj`` the
    target projections of register_projections, ``refined`` ``{domain:
    (pipeline, pca, args)}`` of the refine phases, ``root`` a directory for
    the artifacts (removed at the end), ``serving_launches`` main_path's
    launch counts. ``time_tol`` None, a small ``f32_sz`` and ``device``
    rehearse it on the CPU. Returns the phase's numbers."""
    import numpy as np

    from liftreg_tpu_torch import RegistrationPipeline
    from liftreg_tpu_torch.device import f32_precision
    from liftreg_tpu_torch.serving import (ServingModel, export_serving,
                                           flat, read_artifact)

    _begin("serving")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {}
    src, tgt, seg, _ = args
    batch = src.shape[0]
    try:
        paths, export_s = {}, {}
        for entry in ("register", "register_projections"):
            paths[entry] = os.path.join(root, f"{entry}.liftreg")
            t0 = time.perf_counter()
            export_serving(pipe, pca, batch, paths[entry], entry=entry)
            export_s[entry] = time.perf_counter() - t0
        payload = read_artifact(paths["register"])
        weight_bytes = sum(t.numel() * t.element_size() for t in
                           list(flat(payload["params"]).values())
                           + list(payload["pca"].values()))
        program_bytes = len(payload["exported"])
        del payload
        out.update(export_s=export_s, file_bytes={
            k: os.path.getsize(v) for k, v in paths.items()},
            program_bytes=program_bytes, weight_bytes=weight_bytes,
            program_share=program_bytes / weight_bytes)

        t0 = time.perf_counter()
        srv = ServingModel.load(paths["register"], device=device)
        out["load_ms"] = (time.perf_counter() - t0) * 1e3
        _zero(kernels)
        t0 = time.perf_counter()
        served = srv.register(*args)
        sync()
        out["first_call_ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"] = _counts(kernels)
        live = pipe.register(pca, *args)
        out["bit_equal"] = all(bool(torch.equal(a, b))
                               for a, b in zip(served, live))

        def steady(fn):
            for _ in range(2):
                fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(SERVING_TIMED):
                fn()
            sync()
            return (time.perf_counter() - t0) * 1e3 / SERVING_TIMED

        def live_call():
            return pipe.register(pca, *args)

        def served_call():
            return srv.register(*args)

        turns = [("live", live_call), ("served", served_call),
                 ("served", served_call), ("live", live_call)]
        times = {"live": [], "served": []}
        for name, fn in turns:
            times[name].append(steady(fn))
        out["steady_ms"] = times
        out["live_ms"] = statistics.mean(times["live"])
        out["served_ms"] = statistics.mean(times["served"])
        out["served_over_live"] = out["served_ms"] / out["live_ms"]

        # partial batches: padded with their last row
        out["partial_max_abs_diff"] = {}
        out["partial_bit_equal"] = {}
        for b_in in (1, 3):
            part = srv.register(*(a[:b_in] for a in args))
            out["partial_max_abs_diff"][b_in] = max(
                _max_err(p, s_[:b_in]) for p, s_ in zip(part, served))
            out["partial_bit_equal"][b_in] = all(
                bool(torch.equal(p, s_[:b_in]))
                for p, s_ in zip(part, served))
        del srv, served, live

        srv_p = ServingModel.load(paths["register_projections"],
                                  device=device)
        p_args = (src, proj, seg)
        _zero(kernels)
        served_p = srv_p.register_projections(*p_args)
        sync()
        out["projections_launches"] = _counts(kernels)
        live_p = pipe.register_projections(pca, *p_args)
        out["projections_bit_equal"] = all(
            bool(torch.equal(a, b)) for a, b in zip(served_p, live_p))
        del srv_p, served_p, live_p

        # refined artifacts: the refiner rebuilt from meta
        out["refined"] = {}
        for domain, (pipe_r, pca_r, args_r) in refined.items():
            path = os.path.join(root, f"refine_{domain}.liftreg")
            export_serving(pipe_r, pca_r, batch, path)
            srv_r = ServingModel.load(path, device=device)
            _zero(kernels)
            got = srv_r.register(*args_r)
            sync()
            served_launches = _counts(kernels)
            _zero(kernels)
            want = pipe_r.register(pca_r, *args_r)
            sync()
            live_launches = _counts(kernels)
            # the served refiner, rebuilt at load, builds the adjoint's
            # plan at its first call; the live one kept its own
            first_plan = int(domain == "projection" and device == "cuda")
            row = {"phi_max_abs_diff": _max_err(got[1], want[1]),
                   "warped_max_abs_diff": _max_err(got[0], want[0]),
                   "bit_equal": all(bool(torch.equal(a, b))
                                    for a, b in zip(got, want)),
                   "launches_equal_live": served_launches == dict(
                       live_launches, drr_adjoint_plan=live_launches[
                           "drr_adjoint_plan"] + first_plan),
                   "launches": served_launches,
                   "history_first_last": [
                       float(srv_r.last_refine["total_history"][0]),
                       float(srv_r.last_refine["total_history"][-1])]}
            calls = {"live": [], "served": []}
            for name, fn in (("live", lambda: pipe_r.register(pca_r,
                                                              *args_r)),
                             ("served", lambda: srv_r.register(*args_r))):
                fn()
                sync()
                for _ in range(SERVING_REFINE_TIMED):
                    t0 = time.perf_counter()
                    fn()
                    sync()
                    calls[name].append((time.perf_counter() - t0) * 1e3)
            row["calls_ms"] = calls
            row["live_ms"] = statistics.median(calls["live"])
            row["served_ms"] = statistics.median(calls["served"])
            out["refined"][domain] = row
            del srv_r, got, want

        # an f32 artifact with TF32 on for the process
        sz = (f32_sz,) * 3
        torch.manual_seed(12)
        pipe32 = RegistrationPipeline(sz, latent_dim=8, device=device)
        g = torch.Generator(device=device).manual_seed(12)
        n32 = 3 * f32_sz ** 3
        pca32 = {"vectors": torch.randn((8, n32), generator=g,
                                        device=device) * 0.01,
                 "mean": torch.randn((n32,), generator=g,
                                     device=device) * 0.01}
        args32 = [torch.rand((2, 1) + sz, generator=g, device=device)
                  * -1000.0 for _ in "st"]
        args32 += [(torch.rand((2, 1) + sz, generator=g, device=device)
                    > 0.4).float()] * 2
        path32 = os.path.join(root, "f32.liftreg")
        export_serving(pipe32, pca32, 2, path32)
        srv32 = ServingModel.load(path32, device=device)
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            got32 = srv32.register(*args32)
            want32 = pipe32.register(pca32, *args32)
            # the program alone, without the f32 scope: what TF32 does
            srv32._commit_weights()
            bare = srv32._program(srv32._params, srv32._pca, srv32._consts,
                                  *args32)
            sync()
            tf32_after = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flags[0]
            torch.backends.cudnn.allow_tf32 = flags[1]
        with f32_precision():
            scoped = srv32._program(srv32._params, srv32._pca,
                                    srv32._consts, *args32)
        # the same pipeline exported on the CPU, its program moved to the
        # card at load (move_to_device_pass)
        pipe_cpu = RegistrationPipeline(sz, latent_dim=8, device="cpu")
        pipe_cpu.model.load_state_dict(pipe32.model.state_dict())
        path_cpu = os.path.join(root, "f32_cpu.liftreg")
        export_serving(pipe_cpu, {k: v.cpu() for k, v in pca32.items()}, 2,
                       path_cpu)
        moved = ServingModel.load(path_cpu, device=device).register(*args32)
        out["f32"] = {
            "bit_equal": all(bool(torch.equal(a, b))
                             for a, b in zip(got32, want32)),
            "caller_flags_kept": tf32_after == (True, True),
            "unscoped_tf32_phi_max_abs_diff": _max_err(bare[1], want32[1]),
            "scoped_bit_equal": all(bool(torch.equal(a, b))
                                    for a, b in zip(scoped, want32)),
            "exported_on_cpu_max_abs_diff": [_max_err(moved[1], want32[1]),
                                             _max_err(moved[0], want32[0])]}
        del srv32, pipe32, pipe_cpu

        # tools/torch_serve_batch.py on 5 cases: a full batch and one of 1
        cases, outs = os.path.join(root, "cases"), os.path.join(root, "out")
        os.makedirs(cases)
        rows = [k % batch for k in range(SERVING_TOOL_CASES)]
        host = [a.cpu().numpy() for a in args]
        ids = [f"case{k}" for k in range(SERVING_TOOL_CASES)]
        for cid, r in zip(ids, rows):
            np.save(os.path.join(cases, f"{cid}_source.npy"), host[0][r, 0])
            np.save(os.path.join(cases, f"{cid}_target.npy"), host[1][r, 0])
            np.save(os.path.join(cases, f"{cid}_source_seg.npy"),
                    host[2][r, 0])
            np.save(os.path.join(cases, f"{cid}_target_seg.npy"),
                    host[3][r, 0])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "tools/torch_serve_batch.py", "-a",
             paths["register"], "-i", cases, "-o", outs]
            + ([] if device == "cuda" else ["--device", device]),
            capture_output=True, text=True, timeout=300)
        out["tool_s"] = time.perf_counter() - t0
        out["tool_rc"] = proc.returncode
        _require(proc.returncode == 0, f"torch_serve_batch.py failed: "
                 f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        srv = ServingModel.load(paths["register"], device=device)
        tool_equal = True
        for start in range(0, SERVING_TOOL_CASES, batch):
            chunk = rows[start:start + batch]
            warped, phi = srv.register(*(a[chunk] for a in args))
            phi01 = ((phi + 1.0) / 2.0).cpu().numpy()
            warped = warped.cpu().numpy()
            for k, cid in enumerate(ids[start:start + batch]):
                tool_equal &= bool(np.array_equal(
                    np.load(os.path.join(outs, f"{cid}_warped.npy")),
                    warped[k]))
                tool_equal &= bool(np.array_equal(np.load(
                    os.path.join(outs, f"{cid}_phi.npy")), phi01[k]))
        out["tool_equal"] = tool_equal
        del srv
    finally:
        shutil.rmtree(root, ignore_errors=True)

    _emit(**out, time_tol=time_tol,
          program_share_limit=SERVING_PROGRAM_SHARE,
          partial_tol=SERVING_PARTIAL_TOL, refine_tol=REFINE_REF_TOL)
    _require(out["program_share"] < SERVING_PROGRAM_SHARE,
             f"the program holds {out['program_bytes']} bytes")
    _require(out["bit_equal"] and out["projections_bit_equal"],
             "a served call differs from the live pipeline")
    _require(out["launches"] == serving_launches,
             f"served register launches {out['launches']}, expected "
             f"{serving_launches}")
    _require(out["projections_launches"]
             == dict(serving_launches, drr_project=0),
             f"served register_projections launches "
             f"{out['projections_launches']}")
    _require(max(out["partial_max_abs_diff"].values())
             <= SERVING_PARTIAL_TOL,
             f"padded batches differ: {out['partial_max_abs_diff']}")
    for domain, row in out["refined"].items():
        _require(row["phi_max_abs_diff"] <= REFINE_REF_TOL[0]
                 and row["warped_max_abs_diff"] <= REFINE_REF_TOL[1]
                 and row["launches_equal_live"]
                 and row["history_first_last"][1]
                 <= row["history_first_last"][0],
                 f"the refined artifact ({domain}) disagrees: {row}")
    _require(out["f32"]["bit_equal"] and out["f32"]["caller_flags_kept"]
             and out["f32"]["exported_on_cpu_max_abs_diff"][0]
             <= REF_F32_TOL[0]
             and out["f32"]["exported_on_cpu_max_abs_diff"][1]
             <= REF_F32_TOL[1],
             f"the f32 artifact under TF32: {out['f32']}")
    _require(out["tool_equal"], "torch_serve_batch.py's outputs differ")
    if time_tol is not None:
        _require(out["served_over_live"] <= 1.0 + time_tol,
                 f"served register {out['served_ms']} ms against live "
                 f"{out['live_ms']} ms")
    return out


def optreg_reference(torch, F, warp_kernel, card="cuda"):
    """One DenseRegisterer call on the card against the CPU (see the
    constants above), then with the card's coordinate gradient negated
    along its first axis, which the histories must catch."""
    from liftreg_tpu_torch import optreg

    _begin("optreg_reference")
    g = torch.Generator().manual_seed(3)
    sz = (OPTREG_REF_SZ,) * 3
    mov = F.interpolate(torch.randn((2, 1, 6, 6, 6), generator=g), size=sz,
                        mode="trilinear", align_corners=True).clamp(-1, 1)
    tgt = torch.roll(mov, shifts=(1, -2, 1), dims=(2, 3, 4))

    def run(where):
        reg = optreg.DenseRegisterer(sz, levels=OPTREG_REF_LEVELS,
                                     warp_taps_dtype=torch.bfloat16)
        out = reg(mov.to(where), tgt.to(where))
        return {k: out[k].float().cpu() for k in OPTREG_REF_TOL}

    cpu, on_card = run("cpu"), run(card)
    with negated_coord_grad(warp_kernel):
        control = run(card)
    errs = {k: _max_err(on_card[k], cpu[k]) for k in OPTREG_REF_TOL}
    control_errs = {k: _max_err(control[k], cpu[k])
                    for k in ("total_history", "sim_history")}
    _emit(max_abs_err=errs, tol=OPTREG_REF_TOL,
          flipped_coord_grad_history_err=control_errs,
          history_cpu=[float(x) for x in cpu["total_history"]])
    _require(all(errs[k] <= tol for k, tol in OPTREG_REF_TOL.items()),
             f"optreg on the card disagrees with the CPU: {errs}")
    _require(all(control_errs[k] > OPTREG_REF_TOL[k] for k in control_errs),
             f"the histories' check does not see a wrong coordinate "
             f"gradient: {control_errs}")
    return errs


@contextlib.contextmanager
def counted_optreg_calls(torch, kernels, calls):
    """Within the block, each DenseRegisterer call zeroes the kernels'
    counts just before it and reads them just after: ``calls`` receives
    one dict per call (its launches, seconds and batch)."""
    from liftreg_tpu_torch import optreg
    call = optreg.DenseRegisterer.__call__

    def counted(self, moving, target):
        torch.cuda.synchronize()
        _zero(kernels)
        t0 = time.perf_counter()
        out = call(self, moving, target)
        torch.cuda.synchronize()
        calls.append({"launches": _counts(kernels),
                      "seconds": time.perf_counter() - t0,
                      "batch": int(moving.shape[0])})
        return out

    optreg.DenseRegisterer.__call__ = counted
    try:
        yield
    finally:
        optreg.DenseRegisterer.__call__ = call


def optreg_tools(torch, kernels, root):
    """The per-pair oracle and the objective A/B on learned_basis's
    dataset, as their tools run; returns the launches of one oracle pair
    and of one A/B variant."""
    import numpy as np

    from liftreg_tpu_torch import optreg
    from tools import torch_optreg_objective_ab, torch_optreg_oracle
    from tools.torch_build_pca import parse_levels

    n_train = LEARNED_SPLITS[0]
    zero = {k: 0 for k in kernels}

    _begin("optreg_oracle")
    warps, grads = optreg.DenseRegisterer((SZ,) * 3).launches()
    want = dict(zero, warp_trilinear=warps, warp_coord_grad=grads)
    calls, record = [], []
    oracle_calls = calls
    with counted_optreg_calls(torch, kernels, calls):
        mean = torch_optreg_oracle.main(
            ["--data", root, "--phase", "train", "--n", str(n_train)],
            record=record)
    pairs = [{"id": r["id"], "rel_err": r["rel_err"], "gt_mm": r["gt_mm"],
              "pred_mm": r["pred_mm"], "err_mm": r["err_mm"],
              "sim_first_last": [float(r["sim_history"][0]),
                                 float(r["sim_history"][-1])],
              "seconds": c["seconds"], "launches": c["launches"]}
             for r, c in zip(record, calls)]
    _emit(pairs=pairs, mean_rel_err=mean, expected_launches=want,
          seconds_per_pair=[c["seconds"] for c in calls],
          batch=[c["batch"] for c in calls])
    _require(len(calls) == len(record) == n_train
             and all(c["batch"] == 1 for c in calls),
             f"{len(calls)} oracle calls for {n_train} pairs")
    _require(all(c["launches"] == want for c in calls),
             f"oracle launches {[c['launches'] for c in calls]}, "
             f"expected {want} a pair")
    _require(all(math.isfinite(p["rel_err"]) for p in pairs)
             and math.isfinite(mean), f"oracle errors {pairs}")
    _require(all(last <= first for first, last in
                 (p["sim_first_last"] for p in pairs)),
             f"an oracle pair ended worse than it started: {pairs}")

    _begin("optreg_objective_ab")
    ab_levels = parse_levels(OBJECTIVE_AB_LEVELS)
    warps, grads = optreg.DenseRegisterer((SZ,) * 3,
                                          levels=ab_levels).launches()
    want_ab = dict(zero, warp_trilinear=warps, warp_coord_grad=grads)
    calls = []
    with counted_optreg_calls(torch, kernels, calls):
        results = torch_optreg_objective_ab.main(
            ["--data", root, "--n", str(n_train), "--levels",
             OBJECTIVE_AB_LEVELS])
    # a masked variant that did not apply its lung masks would register
    # the unmasked volumes and repeat its unmasked variant's errors
    masks_applied = {v: bool((results[v] != results[v[:-len("_masked")]])
                             .all())
                     for v in results if v.endswith("_masked")}
    variants = {v: {"rel_err_per_pair": [float(x) for x in results[v]],
                    "mean": float(results[v].mean()),
                    "seconds": c["seconds"], "launches": c["launches"]}
                for v, c in zip(results, calls)}
    _emit(variants=variants, levels=OBJECTIVE_AB_LEVELS,
          batch=[c["batch"] for c in calls], expected_launches=want_ab,
          best=min(results, key=lambda k: results[k].mean()),
          masks_applied=masks_applied)
    _require(tuple(results) == OBJECTIVE_AB_VARIANTS
             and len(calls) == len(OBJECTIVE_AB_VARIANTS)
             and all(c["batch"] == n_train for c in calls),
             f"A/B variants {list(results)} in calls "
             f"{[c['batch'] for c in calls]}")
    _require(all(c["launches"] == want_ab for c in calls),
             f"A/B launches {[c['launches'] for c in calls]}, expected "
             f"{want_ab} a variant")
    _require(all(bool(np.isfinite(r).all()) for r in results.values()),
             f"A/B errors {variants}")
    _require(len(masks_applied) == 2 and all(masks_applied.values()),
             f"a masked variant repeats its unmasked errors: {variants}")
    return {"oracle_pair": oracle_calls[0]["launches"],
            "ab_variant": calls[0]["launches"]}


def write_raw_dirlab_case(raw, case, shape, seed):
    """One raw DIR-Lab case, ``{raw}/{case}/{case}/{case}_{iBH,eBH}CT.img``
    (<i2, z-major), as tests/test_preprocessing_cli.py's make_raw_case
    draws it (noise everywhere, a body ellipsoid at 1054 and two lung
    ellipsoids at 174 before the -1024 shift, seeded noise on each), both
    phases the same volume. Returns the lung ellipsoids' (centre, radii)
    in voxels, (z, y, x)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d, w, h = shape
    zz, yy, xx = (a.astype(np.float32) for a in np.ogrid[0:d, 0:w, 0:h])
    vol = np.abs(rng.normal(scale=5, size=shape)).astype(np.float32)
    body = (((zz - d / 2) / (d * 0.45)) ** 2 + ((yy - w / 2) / (w * 0.38)) ** 2
            + ((xx - h / 2) / (h * 0.38)) ** 2) < 1
    vol[body] = 1054.0 + rng.normal(scale=15, size=int(body.sum()))
    lungs = [((d / 2, w / 2, h * fx), (d * 0.3, w * 0.22, h * 0.12))
             for fx in (0.35, 0.65)]
    lung = np.zeros(shape, bool)
    for (cz, cy, cx), (rz, ry, rx) in lungs:
        lung |= (((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2
                 + ((xx - cx) / rx) ** 2) < 1
    vol[lung] = 174.0 + rng.normal(scale=20, size=int(lung.sum()))
    case_dir = os.path.join(raw, case, case)
    os.makedirs(case_dir)
    for tag in ("iBHCT", "eBHCT"):
        vol.astype("<i2").tofile(os.path.join(case_dir,
                                              f"{case}_{tag}.img"))
    return lungs


def write_dirlab_landmarks(lm_dir, case, shape, lungs, n, seed):
    """``n`` landmark pairs in DIR-Lab's format (tab-separated 1-indexed
    integer x y z of the raw voxel grid): iBH uniform in the lung
    ellipsoids, eBH = iBH + a seeded integer offset (up to 6 voxels in z,
    16 in y and x), inside the volume. Returns (iBH, eBH), (n, 3) xyz."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n:
        (cz, cy, cx), (rz, ry, rx) = lungs[len(pts) % len(lungs)]
        u = rng.uniform(-1.0, 1.0, 3)
        if (u ** 2).sum() < 1.0:
            pts.append(np.rint([cx + u[2] * rx, cy + u[1] * ry,
                                cz + u[0] * rz]) + 1.0)
    ibh = np.asarray(pts)
    offset = np.stack([rng.integers(-16, 17, n), rng.integers(-16, 17, n),
                       rng.integers(-6, 7, n)], axis=1)
    d, w, h = shape
    ebh = np.clip(ibh + offset, 1, [h, w, d])
    os.makedirs(lm_dir, exist_ok=True)
    for tag, p in (("iBH", ibh), ("eBH", ebh)):
        np.savetxt(os.path.join(lm_dir, f"{case}_300_{tag}_xyz_r1.txt"), p,
                   fmt="%d", delimiter="\t")
    return ibh, ebh


def dirlab_chain(torch, kernels, root):
    """Raw DIR-Lab bytes to evaluate_result.csv through
    tools/torch_dirlab_parity.py --raw, as a subprocess (see the constants
    above); returns the chain's summary, the closed-form initial distances
    and the CSV's rows."""
    import numpy as np

    from liftreg_tpu_torch.utils.tre import COPD_SPACING
    from tools.torch_preprocessing import COPD_SHAPE

    _begin("dirlab_chain")
    raw, lm = os.path.join(root, "raw"), os.path.join(root, "landmarks")
    out = os.path.join(root, "out")
    t0 = time.perf_counter()
    initial = {}
    for i, case in enumerate(DIRLAB_CASES):
        shape = tuple(COPD_SHAPE[case])
        lungs = write_raw_dirlab_case(raw, case, shape, DIRLAB_SEED + i)
        ibh, ebh = write_dirlab_landmarks(lm, case, shape, lungs,
                                          DIRLAB_LANDMARKS, DIRLAB_SEED + i)
        initial[case] = float(np.mean(np.linalg.norm(
            (ibh - ebh) * np.asarray(COPD_SPACING[case]), axis=1)))
    initial["mean"] = float(np.mean([initial[c] for c in DIRLAB_CASES]))
    raw_s = time.perf_counter() - t0
    raw_bytes = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, files in os.walk(raw) for f in files)
    expect = os.path.join(root, "expectations.json")
    with open(expect, "w") as f:
        json.dump({"initial_tre_mm": initial,
                   "initial_tol_mm": DIRLAB_INITIAL_TOL,
                   "published": {"per_case_tre_mm": dict.fromkeys(
                       DIRLAB_CASES), "mean_tre_mm": None, "tol_mm": 0.5},
                   "landmarks_per_case": DIRLAB_LANDMARKS}, f)
    cmd = [sys.executable, "tools/torch_dirlab_parity.py", "--raw", raw,
           "--landmarks", lm, "--out", out, "--identity",
           "--enforce_landmark_count", "--epochs", str(DIRLAB_EPOCHS),
           "--expected", expect]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, LIFTREG_NO_TB="1"))
    _state.setdefault("children", []).append(proc)
    stdout, stderr = proc.communicate(timeout=WATCHDOG_S)
    chain_s = time.perf_counter() - t0
    _require(proc.returncode == 0,
             f"the chain exited {proc.returncode}: {stdout[-3000:]}"
             f"{stderr[-3000:]}")
    summary = next(json.loads(line)["dirlab_e2e"]
                   for line in stdout.splitlines()
                   if line.startswith('{"dirlab_e2e"'))
    report = stdout[stdout.rindex("-- identity-map TRE"):]
    with open(os.path.join(out, "exp", "evaluate_result.csv")) as f:
        rows = list(csv.DictReader(f))
    # exact launches: the DRRs of every case of every split, side by side;
    # a train step lifts, warps and takes the coordinate gradient once, a
    # validation or test batch lifts and warps once
    ds = os.path.join(out, "dataset")
    n_drr = 2 * sum(len(np.load(os.path.join(ds, p, "data_id.npy")))
                    for p in ("train", "debug", "val", "test"))
    steps, vals = summary["train_steps"], summary["val_batches"]
    tests = summary["test_batches"]
    zero = {k: 0 for k in kernels}
    want = {stage: dict(zero) for stage in summary["launches"]}
    want["drr"].update(drr_project=n_drr)
    want["train"].update(drr_backproject=steps + vals,
                         warp_trilinear=steps + vals, warp_coord_grad=steps)
    want["test"].update(drr_backproject=tests, warp_trilinear=tests)
    sec = summary["seconds"]
    _emit(cases=list(DIRLAB_CASES),
          shapes={c: COPD_SHAPE[c] for c in DIRLAB_CASES},
          spacings={c: COPD_SPACING[c] for c in DIRLAB_CASES},
          write_raw_s=raw_s, raw_bytes=raw_bytes, chain_s=chain_s,
          stage_seconds=sec,
          preprocess_seconds_per_case=summary["preprocess_seconds"],
          train_step_ms=summary["train_step_ms"], train_steps=steps,
          val_batches=vals, test_batches=tests, drr_projections=n_drr,
          launches=summary["launches"], expected_launches=want,
          peak_rss_bytes=summary["peak_rss_bytes"],
          host_peak_rss_gib=max((v / 2 ** 30 for v in
                                 summary["peak_rss_bytes"].values()
                                 if v is not None), default=None),
          bytes_written=summary["bytes_written"], size=summary["size"],
          latent=summary["latent"], views=summary["views"],
          batch=summary["batch"], initial_tre_mm=initial,
          csv=rows, report=report.splitlines())
    _require("PARITY OK" in stdout, f"the chain's parity: {report}")
    _require(summary["launches"] == want,
             f"chain launches {summary['launches']}, expected {want}")
    _require(steps == vals == DIRLAB_EPOCHS + 1 and tests == 1,
             f"{steps} train steps, {vals} validation and {tests} test "
             f"batches")
    _require(sorted(r["id"] for r in rows) == list(DIRLAB_CASES)
             and all(math.isfinite(float(r["dist"])) for r in rows)
             and all(0.0 <= float(r["dice"]) <= 1.0 for r in rows),
             f"evaluate_result.csv: {rows}")
    return {"summary": summary, "initial": initial, "rows": rows,
            "launches": {k: sum(s[k] for s in summary["launches"].values())
                         for k in kernels}}


def dirlab_parity(root, chain):
    """The parity harness on the chain's dataset and experiment, in
    process: the experiment against a table where one case's TRE is its
    CSV TRE + 1 mm (tol 0.5 mm), and the identity against a table where
    one case's initial distance is 1 mm off, must each exit 1 with that
    case's FAIL row."""
    import io

    from tools.torch_dirlab_parity import main as parity_main

    _begin("dirlab_parity")
    out = os.path.join(root, "out")
    base = ["--data", os.path.join(out, "dataset")]
    tre = {r["id"]: float(r["dist"]) for r in chain["rows"]}
    first, second = DIRLAB_CASES
    runs = {}
    for name, table, args in (
            ("exp_tre_plus_1mm", {"published": {
                "per_case_tre_mm": {first: tre[first] + 1.0, second: None},
                "mean_tre_mm": None, "tol_mm": 0.5}},
             ["--exp", os.path.join(out, "exp")]),
            ("identity_minus_1mm", {
                "initial_tre_mm": dict(chain["initial"],
                                       **{second: chain["initial"][second]
                                          - 1.0}, mean=None),
                "initial_tol_mm": DIRLAB_INITIAL_TOL},
             ["--identity"])):
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(table, f)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = parity_main(base + args + ["--expected", path])
        lines = text.getvalue().splitlines()
        bad = first if name.startswith("exp") else second
        fail_rows = [ln for ln in lines if ln.endswith("FAIL")]
        runs[name] = {"rc": rc, "fail_rows": fail_rows,
                      "last": lines[-1] if lines else ""}
        _require(rc == 1 and len(fail_rows) == 1
                 and fail_rows[0].startswith(bad),
                 f"{name}: exit {rc}, report {lines[-8:]}")
    _emit(runs=runs)
    return runs



@contextlib.contextmanager
def counted(module, name):
    """Within the block, ``module.name`` counts its calls: yields a list
    that holds one entry per call."""
    fn, calls = getattr(module, name), []

    def wrapper(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def s2d_phase(torch, kernels, s2d, tr, batch, names, train_root,
              expected_step, main_path, serving_launches):
    """The s2d phase (see the constants above): ``tr`` is the train phase's
    trainer (the reference config, plain encoder) and ``batch``/``names``
    its step's batch; ``main_path`` (pipeline, basis, register's inputs)
    and ``serving_launches`` main_path's. Returns the phase's numbers and
    the s2d trainer; raises where a check fails."""
    from liftreg_tpu_torch.pipeline import RegistrationPipeline
    from liftreg_tpu_torch.train import RegistrationTrainer
    from liftreg_tpu_torch.train.trainer import loss_and_grads
    from tools import torch_s2d_stages

    out = {"stages": []}
    # (a) stages 0+1 alone, both forms
    for dtype_name in torch_s2d_stages.DTYPES:
        for b in torch_s2d_stages.BATCHES:
            out["stages"] += torch_s2d_stages.measure(torch, b, dtype_name,
                                                      batch["source"].device)
    for line in out["stages"]:
        err = line["rel_err"]
        _require(err["forward"] <= S2D_REL_TOL[line["dtype"]]
                 and all(err[k] <= S2D_GRAD_REL_TOL[line["dtype"]]
                         for k in ("w0", "b0", "w1", "b1")),
                 f"the s2d stages disagree with the plain pair: {line}")

    # (b) one reference step with s2d_encoder on, from the same parameters
    # on the same batch
    cfg = train_setting(TRAIN_CONFIG, os.path.join(train_root, "data"),
                        os.path.join(train_root, "out_s2d"), epoch=0,
                        debug_on=False)
    cfg["train"]["model"]["s2d_encoder"] = True
    tr_s = RegistrationTrainer(cfg)
    tr_s.model.load_state_dict(tr.model.state_dict())
    reg = tr.loss.factor(tr.cur_epoch)
    step = {}
    with counted(s2d, "conv_pair_s2d") as calls:
        got = loss_and_grads(tr_s.model, tr_s.loss, tr_s.params, batch,
                             tr_s.pca, reg, tr_s._weights(len(names)),
                             tr_s.mesh)
    want = loss_and_grads(tr.model, tr.loss, tr.params, batch, tr.pca, reg,
                          tr._weights(len(names)), tr.mesh)
    step["s2d_calls"] = len(calls)
    step["loss_rel_diff"] = {
        k: abs(float(got[0][k]) - float(v)) / abs(float(v))
        for k, v in want[0].items() if float(v) != 0.0}
    step["grad_rel_diff"] = {
        k: float((got[1][k] - g).abs().max() / g.abs().max())
        for k, g in want[1].items()}
    del got, want
    torch.cuda.synchronize()
    _zero(kernels)
    tr_s.step(batch, names)
    torch.cuda.synchronize()
    step["launches"] = _counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    step["step_ms"] = []
    for _ in range(S2D_STEP_TIMED):
        t0 = time.perf_counter()
        tr_s.step(batch, names)
        torch.cuda.synchronize()
        step["step_ms"].append((time.perf_counter() - t0) * 1e3)
    step["step_ms_median"] = statistics.median(step["step_ms"])
    step["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    _require(all(bool(l["finite"]) for _, l in tr_s._pending_losses),
             "a non-finite loss in the s2d train steps")
    tr_s._pending_losses.clear()
    out["train_step"] = step
    _require(step["s2d_calls"] == 1,
             f"the s2d step ran the s2d stages {step['s2d_calls']} times")
    _require(step["launches"] == expected_step,
             f"the s2d train step launched {step['launches']}")
    _require(max(step["loss_rel_diff"].values()) <= S2D_STEP_LOSS_REL
             and max(step["grad_rel_diff"].values()) <= S2D_STEP_GRAD_RTOL,
             f"the s2d train step disagrees with the plain step: {step}")

    # (c) register at main_path's config with s2d_encoder on, against the
    # plain pipeline on the same weights and inputs
    pipe, pca, args = main_path
    pipe_s = RegistrationPipeline(pipe.img_sz, latent_dim=LATENT,
                                  compute_dtype=torch.bfloat16,
                                  s2d_encoder=True)
    pipe_s.model.load_state_dict(pipe.model.state_dict())
    reg_line = {}
    with counted(s2d, "conv_pair_s2d") as calls:
        _zero(kernels)
        got = pipe_s.register(pca, *args)
        torch.cuda.synchronize()
        reg_line["launches"] = _counts(kernels)
    want = pipe.register(pca, *args)
    reg_line["s2d_calls"] = len(calls)
    reg_line["phi_max_abs_diff"] = _max_err(got[1], want[1])
    reg_line["warped_max_abs_diff"] = _max_err(got[0], want[0])
    del got, want
    calls_ms = {"plain": [], "s2d": []}
    for p in (pipe, pipe_s):
        for _ in range(2):
            p.register(pca, *args)
    torch.cuda.synchronize()
    for name, p in (("plain", pipe), ("s2d", pipe_s), ("s2d", pipe_s),
                    ("plain", pipe)):
        for _ in range(S2D_REGISTER_TIMED):
            t0 = time.perf_counter()
            p.register(pca, *args)
            torch.cuda.synchronize()
            calls_ms[name].append((time.perf_counter() - t0) * 1e3)
    reg_line["calls_ms"] = calls_ms
    reg_line["plain_ms"] = statistics.mean(calls_ms["plain"])
    reg_line["s2d_ms"] = statistics.mean(calls_ms["s2d"])
    out["register"] = reg_line
    del pipe_s
    torch.cuda.empty_cache()
    _require(reg_line["s2d_calls"] == 1
             and reg_line["launches"] == serving_launches,
             f"the s2d register: {reg_line}")
    _require(reg_line["phi_max_abs_diff"] <= S2D_REGISTER_TOL[0]
             and reg_line["warped_max_abs_diff"] <= S2D_REGISTER_TOL[1],
             f"the s2d register disagrees with the plain one: {reg_line}")
    out["tol"] = {"stages_forward_rel": S2D_REL_TOL,
                  "stages_grad_rel": S2D_GRAD_REL_TOL,
                  "step_loss_rel": S2D_STEP_LOSS_REL,
                  "step_grad_rel": S2D_STEP_GRAD_RTOL,
                  "register": S2D_REGISTER_TOL}
    return out, tr_s


def _bit_equal(torch, a, b):
    return a.dtype == b.dtype and bool(torch.equal(
        a.float().view(torch.int32), b.float().view(torch.int32)))


def gather_probe_phase(torch, kernels):
    """The gather_probe phase (see the constants above): returns the
    kernels line's rows of the four probe kernels; raises where a check
    fails."""
    from liftreg_tpu_torch.ops import gather_probe as gp
    from tools import torch_bench_mosaic_gather as bench
    from tools import torch_repro_mosaic_gather_500 as repro

    _begin("gather_probe")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    name_of = {wrapper: name for name, (wrapper, _) in PROBE_KERNELS.items()}

    # (a) the two tools, each as a user runs it
    record = {}
    _zero(kernels)
    rows = bench.main(["--reps", str(PROBE_REPS)], record=record)
    torch.cuda.synchronize()
    bench_launches = _counts(kernels)
    # each timed call: the warm-up, the call that sizes the timer's spin
    # kernel, and the reps
    want = dict({k: 0 for k in kernels}, warp_trilinear=PROBE_REPS + 2)
    for _, probe, *_ in bench.ROWS:
        want[name_of[probe]] += PROBE_REPS + 2
    _require(bench_launches == want,
             f"the bench tool launched {bench_launches}, expected {want}")
    _require(len(rows) == 17 and all(r["grid"] == sms for r in rows),
             f"the bench tool's rows: {rows}")
    _zero(kernels)
    repro_rc = repro.main([])
    torch.cuda.synchronize()
    repro_launches = _counts(kernels)
    want_r = {k: 0 for k in kernels}
    for _, _, _, axis, _ in repro.SHAPES:
        want_r["gather_probe_rows" if axis == 0 else "gather_probe_lanes"] \
            += 2
    _require(repro_rc == 0, "the repro tool found a FAIL row")
    _require(repro_launches == want_r,
             f"the repro tool launched {repro_launches}, expected {want_r}")

    # (b) every shape of both tools, kernel against plain, bit for bit
    shapes = sorted({(probe, M, L) for _, probe, M, L, _ in bench.ROWS}
                    | {("gather_rows" if axis == 0 else "gather_lanes", r, c)
                       for _, r, c, axis, _ in repro.SHAPES})
    g = torch.Generator(device=dev).manual_seed(7)
    errs = dict.fromkeys(PROBE_KERNELS, 0.0)
    cases, bad = 0, []
    for probe, M, L in shapes:
        high = L if probe == "gather_lanes" else M
        turns = torch.tensor(
            [2 ** 31 - 1 - t for t in range(max(PROBE_INNER))]
            + [-2 ** 31, -2 ** 31 + 1, -1, -high, high - 1],
            dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((M, L), generator=g, device=dev).to(dtype)
            in_range = torch.randint(0, high, (M, L), generator=g,
                                     device=dev, dtype=torch.int32)
            in_range.view(-1)[:2] = torch.tensor([0, high - 1])
            full = torch.randint(-2 ** 31, 2 ** 31 - 1, (M, L), generator=g,
                                 device=dev, dtype=torch.int32)
            walk = turns[torch.randint(0, len(turns), (M, L), generator=g,
                                       device=dev)]
            for iname, idx in (("range", in_range), ("int32", full),
                               ("walk", walk)):
                if probe == "roll_sum" and iname != "range":
                    continue
                for inner in PROBE_INNER:
                    want_out = gp.plain_version(probe, x, idx, inner)
                    for grid in (1, sms):
                        got = bench.probe_call(probe, x, idx, inner, grid)()
                        cases += 1
                        err = _max_err(got.float(), want_out.float())
                        errs[name_of[probe]] = max(errs[name_of[probe]], err)
                        if not _bit_equal(torch, got, want_out):
                            bad.append([probe, M, L, str(dtype), iname,
                                        inner, grid, err])
    torch.cuda.synchronize()

    # (c) times at PROBE_SHAPE f32: the bench's inner and grid, and inner 1
    # at grid 1 (the repro tool's call) beside one library call; then inner
    # 8 and 64 at PROBE_SLOPE's shapes, one pass an SM; each with the
    # bench's device timer (a kernel of a few microseconds takes less
    # device time than its call takes on the host)
    M, L = PROBE_SHAPE

    def timed(fn, reps):
        return bench.timed_ms(fn, dev, reps, warmup=2)
    inner = record["inner"]
    smem_rate = SMEM_BYTES_PER_CLOCK * sms * clock_mhz * 1e6
    out = {}
    for kname, (probe, replaces) in PROBE_KERNELS.items():
        x, idx = bench.probe_inputs(probe, M, L, "float32", dev)

        def plain(n, t):
            return gp.plain_version(probe, x, idx, n, t)
        nbytes = M * L * (2 * x.element_size() + (0 if idx is None else 4))

        def bound(n, t):
            # the device bytes (x, idx and out once), the f32 operations,
            # and the shared-memory reads (one a gathered element, which
            # the card serves at smem_rate): the largest
            gathered = t * n * M * L
            times = {"device memory bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "f32 operations": gathered * PROBE_OPS_PER_ELEM[probe]
                     / PEAK_F32_FLOPS * 1e3,
                     "shared memory bytes": gathered * x.element_size()
                     / smem_rate * 1e3}
            of = max(times, key=times.get)
            return {"bound_ms": times[of],
                    "bound_by": "operations" if of == "f32 operations"
                    else "bytes", "bound_of": of}

        library = None
        if probe in ("gather_rows", "gather_lanes"):
            axis, idx64 = int(probe == "gather_lanes"), idx.long()
            library = timed(lambda: torch.gather(x, axis, idx64), 20)
        elif probe == "roll_sum":
            library = timed(lambda: torch.roll(x, 1, 1), 20)
        row = {"name": kname, "route": "cuda",
               "source": "liftreg_tpu_torch/csrc/gather_probe.cu",
               "replaces": replaces, "launches": bench_launches[kname],
               "max_abs_err": errs[kname],
               "ms": timed(bench.probe_call(probe, x, idx, inner, sms), 20),
               "plain_ms": timed(lambda: plain(inner, sms), 3),
               **bound(inner, sms), "library_ms": None,
               "shape": [M, L, "float32"], "inner": inner, "grid": sms}
        row["inner1"] = {
            "ms": timed(bench.probe_call(probe, x, idx, 1, 1), 20),
            "plain_ms": timed(lambda: plain(1, 1), 20),
            **bound(1, 1), "library_ms": library, "grid": 1}
        if probe in ("gather_rows", "gather_lanes"):
            row["repro_replaces"] = "tools/repro_mosaic_gather_500.py:41"
            row["repro_launches"] = repro_launches[kname]
        row["bench_rows"] = [
            {k: r[k] for k in ("label", "dtype", "ms", "ns_per_elem")}
            for r in rows if r["probe"] == probe]
        row["slope"] = {}
        for sM, sL in PROBE_SLOPE:
            sx, sidx = bench.probe_inputs(probe, sM, sL, "float32", dev)
            lo, hi = PROBE_SLOPE_INNER
            t_lo, t_hi = (timed(bench.probe_call(probe, sx, sidx, n, sms), 20)
                          for n in (lo, hi))
            # gathered elements a clock an SM between inner lo and hi,
            # each of the sms passes on an SM of its own; and over the
            # whole call at hi, which counts the staging and the device
            # memory traffic too (the slope can pass the 32 f32 reads a
            # clock that the banks serve where the call at hi hides more
            # of that traffic under its gathers than the call at lo)
            row["slope"][f"{sM}x{sL}"] = {
                f"inner{lo}_ms": t_lo, f"inner{hi}_ms": t_hi,
                "elems_per_clock_sm": (hi - lo) * sM * sL
                / ((t_hi - t_lo) * 1e-3 * clock_mhz * 1e6),
                f"elems_per_clock_sm_inner{hi}": hi * sM * sL
                / (t_hi * 1e-3 * clock_mhz * 1e6)}
        out[kname] = row
    _emit(rows=rows, decision=record, bench_launches=bench_launches,
          repro_launches=repro_launches, cases=cases, mismatches=bad,
          max_abs_err=errs, sm_clock_max_mhz=clock_mhz, sms=sms,
          times={k: {f: v for f, v in r.items() if f != "bench_rows"}
                 for k, r in out.items()})
    _require(not bad, f"probe kernels differ from their plain versions: "
             f"{bad[:10]}")
    return out


def _kernel_table():
    """The kernels' wrappers by name; each counts its launches."""
    from liftreg_tpu_torch.ops.drr_kernel import (backproject_taps,
                                                  project_adjoint_plan,
                                                  project_adjoint_taps,
                                                  project_taps)
    from liftreg_tpu_torch.ops.pca_kernel import pca_expand, pca_grad
    from liftreg_tpu_torch.ops.warp_kernel import (warp_coord_grad,
                                                   warp_image_grad,
                                                   warp_trilinear)
    from liftreg_tpu_torch.ops import gather_probe
    return {"pca_expand": pca_expand, "pca_grad": pca_grad,
            "warp_trilinear": warp_trilinear,
            "warp_coord_grad": warp_coord_grad,
            "warp_image_grad": warp_image_grad,
            "drr_project": project_taps,
            "drr_project_adjoint": project_adjoint_taps,
            "drr_adjoint_plan": project_adjoint_plan,
            "drr_backproject": backproject_taps,
            **{name: getattr(gather_probe, wrapper)
               for name, (wrapper, _) in PROBE_KERNELS.items()}}


def _trainer_state(tr):
    """A trainer's parameters and Adam moments, on the host."""
    host = lambda d: {k: v.detach().cpu().numpy().copy()  # noqa: E731
                      for k, v in d.items()}
    return {"params": host(tr.params), "mu": host(tr.opt_state["mu"]),
            "nu": host(tr.opt_state["nu"])}


def dp_train(mesh, job):
    """One rank's (or, with a mesh of one process, the one-process)
    training run of data_parallel: ``job["cfg"]``'s epochs, then a new
    trainer resuming ``job["resume_cfg"]`` for one more, each with its
    kernels' launches counted; with ``job["timed"]`` one step alone (its
    launches, collective bytes and calls) and that many timed. The runs
    (not the timed steps) use torch's deterministic algorithms where
    ``job["deterministic"]``."""
    import torch
    from liftreg_tpu_torch.train import RegistrationTrainer
    kernels = _kernel_table()
    os.environ["LIFTREG_NO_TB"] = "1"
    torch.use_deterministic_algorithms(bool(job.get("deterministic")),
                                       warn_only=True)
    try:
        _zero(kernels)
        tr = RegistrationTrainer(job["cfg"], mesh=mesh)
        tr.run()
        torch.cuda.synchronize()
        out = {"steps": tr.global_step["train"],
               "vals": tr.global_step["val"], "launches": _counts(kernels),
               "state_run": _trainer_state(tr),
               "param_bytes": 4 * sum(p.numel()
                                      for p in tr.params.values())}
        if job.get("resume_cfg") is None:
            return out
        del tr
        tr = RegistrationTrainer(job["resume_cfg"], mesh=mesh)
        out["resumed"] = {"start_epoch": tr.start_epoch,
                          "global_step": dict(tr.global_step)}
        tr.run()
        out["state"] = _trainer_state(tr)
        torch.use_deterministic_algorithms(False)
        if job.get("timed"):
            batch, names = next(iter(tr._iter_device("train",
                                                     tr.cur_epoch)))
            mesh.barrier()
            torch.cuda.synchronize()
            _zero(kernels)
            bytes0, calls0 = mesh.collective_bytes, mesh.collective_calls
            tr.step(batch, names)
            torch.cuda.synchronize()
            out.update(step_launches=_counts(kernels),
                       step_bytes=mesh.collective_bytes - bytes0,
                       step_calls=mesh.collective_calls - calls0)
            step_ms = []
            for _ in range(job["timed"]):
                mesh.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.step(batch, names)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            out["step_ms"] = step_ms
            out["finite"] = all(bool(l["finite"])
                                for _, l in tr._pending_losses)
            tr._pending_losses.clear()
        return out
    finally:
        torch.use_deterministic_algorithms(False)


def dp_train_averaged(mesh, job):
    """:func:`dp_train` with the ranks' gradients averaged instead of
    summed (a negative control)."""
    from liftreg_tpu_torch.train import trainer as trainer_mod
    summed = trainer_mod.loss_and_grads

    def averaged(*args):
        losses, grads = summed(*args)
        return losses, {k: g / mesh.size for k, g in grads.items()}

    trainer_mod.loss_and_grads = averaged
    try:
        return dp_train(mesh, job)
    finally:
        trainer_mod.loss_and_grads = summed


def dp_refine_inputs(torch, F, device):
    """data_parallel's refined register: refine_inputs of seed 7 with rows
    2 and 3 aligned (target = source) and their lung masks empty."""
    g = torch.Generator(device=device).manual_seed(7)
    src, tgt, seg, pca = refine_inputs(torch, F, g, device)
    tgt[2:] = src[2:]
    seg[2:] = 0.0
    return src, tgt, seg, pca


def dp_register(mesh, job):
    """A refined register (:func:`dp_refine_inputs`, seeded weights) of this
    rank's rows with the mesh's refiner, and with a mesh of no collective
    (each rank's early stop its own: a negative control). With
    ``job["reference"]`` the path of the one-process call's phi and warped,
    their largest differences on these rows; without, this call's output is
    saved there (the one-process call, in the script's own process)."""
    import torch
    import torch.nn.functional as F
    from liftreg_tpu_torch import RegistrationPipeline
    from liftreg_tpu_torch.parallel import Mesh
    src, tgt, seg, pca = dp_refine_inputs(torch, F, mesh.device)
    rows = mesh.rows(src.shape[0])

    def register(m):
        torch.manual_seed(0)
        pipe = RegistrationPipeline(
            (SZ,) * 3, latent_dim=LATENT, refine_steps=REFINE_STEPS,
            refine_early_stop_patience=DP_REFINE_PATIENCE,
            refine_early_stop_tol=DP_REFINE_TOL, mesh=m)
        warped, phi = pipe.register(pca, src[rows], tgt[rows], seg[rows],
                                    seg[rows])
        torch.cuda.synchronize()
        return warped, phi, pipe.last_refine

    warped, phi, res = register(mesh)
    out = {"steps_run": res["steps_run"],
           "total_history": res["total_history"].tolist(),
           "inputs_sum": [float(t.double().sum()) for t in
                          (src, tgt, seg, pca["vectors"])]}
    if mesh.group is None:
        torch.save({"phi": phi, "warped": warped}, job["reference"])
        return out
    ref = torch.load(job["reference"], map_location=mesh.device)
    out["max_abs_err"] = {"phi": _max_err(phi, ref["phi"][rows]),
                          "warped": _max_err(warped, ref["warped"][rows])}
    del ref, warped, phi
    out["rank_local_steps_run"] = register(Mesh(
        rank=mesh.rank, size=mesh.size, device=mesh.device))[2]["steps_run"]
    return out


#: data_parallel's jobs by name, for dp_rank
DP_JOBS = {"train": dp_train, "train_averaged": dp_train_averaged,
           "register": dp_register}


def dp_rank(mesh, jobs):
    """One rank of data_parallel: its results of ``jobs``, each a dict with
    the name of its function in DP_JOBS under ``"fn"``."""
    return [DP_JOBS[job["fn"]](mesh, job) for job in jobs]


def _dp_job(data_root, train_ids, val_ids, root, b, name, **kw):
    """A dp_train job: the reference config at a global batch of ``b`` on
    the first ``b`` training cases and the validation cases, its epochs
    and then the resume of its last checkpoint, written under
    ``root/out_<name>``."""
    droot = os.path.join(root, f"data_b{b}")
    if not os.path.isdir(droot):
        split_root(droot, data_root, {"train": list(train_ids[:b]),
                                      "val": list(val_ids)})
    out = os.path.join(root, f"out_{name}")
    cfg = train_setting(TRAIN_CONFIG, droot, out, epoch=DP_EPOCHS)
    cfg["train"]["dataloader"]["batch_size"] = b
    prefix = f"epoch_{DP_EPOCHS}" if cfg["train"].get("debug_on") \
        else "latest"
    resume = json.loads(json.dumps(cfg))
    resume["train"].update(epoch=DP_EPOCHS + 1, continue_train=True,
                           continue_from=os.path.join(
                               out, "checkpoints",
                               f"{prefix}_checkpoint.ckpt"))
    return dict(fn="train", cfg=cfg, resume_cfg=resume, out=out, **kw)


def _dp_errors(ref_job, ref, job, got, state="state"):
    """A run against the one-process run: each logged loss's and validation
    score's largest relative difference (over the steps and epochs ``job``
    logged; ``state="state"``: all of the one-process run's), the
    parameters' largest absolute difference and the moments' largest
    difference relative to each leaf's largest value (after the resume, or
    with ``"state_run"`` before it), and whether all are bit-equal."""
    import numpy as np
    out = {}
    if job is not None:
        mr, mg = read_metrics(ref_job["out"]), read_metrics(job["out"])
        rel, equal = 0.0, True
        for tag in ("Train/total_loss", "Train/sim_loss", "Train/reg_loss",
                    "Val_metrics/score"):
            _require(mg[tag] and set(mg[tag]) <= set(mr[tag])
                     and (state != "state" or set(mg[tag]) == set(mr[tag])),
                     f"{tag} logged at {sorted(mg[tag])}, the one-process "
                     f"run at {sorted(mr[tag])}")
            for k, v in mg[tag].items():
                rel = max(rel, abs(v - mr[tag][k]) / max(abs(mr[tag][k]),
                                                         1e-12))
                equal = equal and v == mr[tag][k]
        out.update(loss_rel_err=rel, losses_bit_equal=equal)
    a, b = ref[state], got[state]
    out["param_max_abs_err"] = max(float(np.abs(a["params"][k]
                                                - b["params"][k]).max())
                                   for k in a["params"])
    out["moment_rel_err"] = max(
        float(np.abs(a[m][k] - b[m][k]).max()
              / max(float(np.abs(a[m][k]).max()), 1e-30))
        for m in ("mu", "nu") for k in a[m])
    out["state_bit_equal"] = all(np.array_equal(a[m][k], b[m][k])
                                 for m in ("params", "mu", "nu")
                                 for k in a[m])
    return out


def _dp_check_ranks(name, job, ranks, ref_job, ref, kernels):
    """The checks of one distributed training run's ranks against the
    one-process run at the same global batch; returns its line."""
    import numpy as np
    r0 = ranks[0]
    line = _dp_errors(ref_job, ref, job, r0)
    line["ranks_params_bit_equal"] = all(
        np.array_equal(r["state"]["params"][k], r0["state"]["params"][k])
        for r in ranks for k in r0["state"]["params"])
    _require(line["loss_rel_err"] <= DP_LOSS_REL,
             f"{name}: a logged loss {line['loss_rel_err']} from the "
             "one-process run's")
    _require(line["param_max_abs_err"] <= DP_PARAM_TOL
             and line["moment_rel_err"] <= DP_MOMENT_RTOL,
             f"{name}: parameters {line['param_max_abs_err']} or moments "
             f"{line['moment_rel_err']} from the one-process run's")
    _require(line["ranks_params_bit_equal"],
             f"{name}: the ranks' parameters differ after the resume")
    for rank, r in enumerate(ranks):
        expected = dict({k: 0 for k in kernels},
                        drr_backproject=r["steps"] + r["vals"],
                        warp_trilinear=r["steps"] + r["vals"],
                        warp_coord_grad=r["steps"])
        _require(r["launches"] == expected and r["steps"] == DP_EPOCHS + 1,
                 f"{name}: rank {rank} launched {r['launches']} in "
                 f"{r['steps']} steps, expected {expected}")
        _require(r["resumed"] == ref["resumed"],
                 f"{name}: rank {rank} resumed at {r['resumed']}, the "
                 f"one-process run at {ref['resumed']}")
        if "step_launches" in r:
            one_step = dict({k: 0 for k in kernels}, drr_backproject=1,
                            warp_trilinear=1, warp_coord_grad=1)
            _require(r["step_launches"] == one_step and r["finite"],
                     f"{name}: rank {rank}'s step launched "
                     f"{r['step_launches']}")
            bound = 1.1 * r["param_bytes"] + 4096
            _require(r["step_calls"] == 2 and r["param_bytes"]
                     <= r["step_bytes"] <= bound,
                     f"{name}: rank {rank}'s step put {r['step_bytes']} "
                     f"bytes into {r['step_calls']} collectives (parameters"
                     f" {r['param_bytes']} bytes, bound {bound})")
    return line


def data_parallel(torch, F, dev, data_root, train_ids, val_ids, root):
    """The data_parallel phase (see the module's docstring): returns
    ``{"line": the phase's JSON fields, "rank_launches": each kernel's
    launches on each rank of one 2-rank step}``."""
    import statistics as stats
    from liftreg_tpu_torch.parallel import launch, make_mesh
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    kernels = _kernel_table()
    job = lambda b, name, **kw: _dp_job(  # noqa: E731
        data_root, train_ids, val_ids, root, b, name, **kw)
    seconds = {}

    # the one-process runs: the trainer of one card, and one register call
    t0 = time.perf_counter()
    one = make_mesh(1, dev)
    ref_jobs = {b: job(b, f"one_b{b}", deterministic=b == DP_BATCHES[0],
                       timed=DP_TIMED_STEPS if b == DP_BATCHES[0] else 0)
                for b in DP_BATCHES}
    ref = {b: dp_train(one, ref_jobs[b]) for b in DP_BATCHES}
    b6 = DP_BATCHES[0]
    _require(ref[b6]["finite"], "a non-finite one-process step")
    reg_path = os.path.join(root, "register_reference.pt")
    reg_ref = dp_register(one, {"reference": reg_path})
    torch.cuda.empty_cache()
    seconds["one_process"] = time.perf_counter() - t0

    # (a) the distributed trainer on one NCCL rank: its 2 steps bit-equal to
    # one card's
    t0 = time.perf_counter()
    ja = dict(job(b6, "nccl1", deterministic=True), resume_cfg=None)
    a = launch(dp_rank, 1, device=dev, backend="nccl", args=([ja],))[0][0]
    nccl1 = _dp_errors(ref_jobs[b6], ref[b6], ja, a, state="state_run")
    _require(nccl1["losses_bit_equal"] and nccl1["state_bit_equal"],
             f"one NCCL rank is not bit-equal to one card: {nccl1}")
    seconds["nccl_1_rank"] = time.perf_counter() - t0

    # (b)-(d) two gloo ranks sharing the card: each batch's run and resume,
    # a run with averaged gradients, and the sharded refined register
    t0 = time.perf_counter()
    jobs = [job(b, f"gloo2_b{b}", timed=DP_TIMED_STEPS if b == b6 else 0)
            for b in DP_BATCHES]
    jobs.append(dict(job(b6, "gloo2_averaged"), fn="train_averaged",
                     resume_cfg=None))
    jobs.append({"fn": "register", "reference": reg_path})
    res = launch(dp_rank, 2, device=dev, backend="gloo", args=(jobs,))
    seconds["gloo_2_ranks"] = time.perf_counter() - t0
    gloo = {}
    for k, b in enumerate(DP_BATCHES):
        gloo[b] = _dp_check_ranks(f"2 gloo ranks, B={b}", jobs[k],
                                  [r[k] for r in res], ref_jobs[b], ref[b],
                                  kernels)
    ranks6 = [r[0] for r in res]
    # (d) the averaged gradients must break the moments' limit
    averaged = _dp_errors(None, ref[b6], None, res[0][len(DP_BATCHES)],
                          state="state_run")
    _require(averaged["moment_rel_err"] > DP_MOMENT_RTOL,
             f"gradients averaged over the ranks passed: {averaged}")
    # (c) the sharded refined register, and (d) its rank-local early stop
    regs = [r[-1] for r in res]
    register = {"steps_run": [r["steps_run"] for r in regs],
                "one_process_steps_run": reg_ref["steps_run"],
                "rank_local_steps_run": [r["rank_local_steps_run"]
                                         for r in regs],
                "max_abs_err": [r["max_abs_err"] for r in regs],
                "tol": REFINE_REF_TOL}
    _require(all(r["inputs_sum"] == reg_ref["inputs_sum"] for r in regs),
             "the ranks drew other register inputs than this process")
    _require(register["steps_run"] == [reg_ref["steps_run"]] * 2,
             f"the refinement's steps: {register}")
    _require(all(e["phi"] <= REFINE_REF_TOL[0]
                 and e["warped"] <= REFINE_REF_TOL[1]
                 for e in register["max_abs_err"]),
             f"the sharded register is off the one-process call: {register}")
    _require(len(set(register["rank_local_steps_run"])) > 1,
             "a rank-local early stop passed: "
             f"{register['rank_local_steps_run']}")

    line = {"seconds_by_run": seconds, "nccl_1_rank": nccl1,
            "gloo_2_ranks": {str(b): v for b, v in gloo.items()},
            "averaged_gradients_control": averaged,
            "register": register,
            "step_ms": {"one_process_b6": ref[b6]["step_ms"],
                        "gloo_2_ranks_b6": [r["step_ms"] for r in ranks6]},
            "step_ms_median": {
                "one_process_b6": stats.median(ref[b6]["step_ms"]),
                "gloo_2_ranks_b6": [stats.median(r["step_ms"])
                                    for r in ranks6]},
            "collective_bytes_per_step": [r["step_bytes"] for r in ranks6],
            "collective_calls_per_step": [r["step_calls"] for r in ranks6],
            "param_bytes": ranks6[0]["param_bytes"]}
    cards = torch.cuda.device_count()
    if cards >= 2:
        t0 = time.perf_counter()
        jn = job(b6, "nccl2", timed=DP_TIMED_STEPS)
        rn = [r[0] for r in launch(dp_rank, 2, args=([jn],))]
        line["nccl_2_cards"] = _dp_check_ranks(
            "2 NCCL ranks", jn, rn, ref_jobs[b6], ref[b6], kernels)
        line["nccl_2_cards"]["step_ms"] = [r["step_ms"] for r in rn]
        seconds["nccl_2_cards"] = time.perf_counter() - t0
    else:
        line["nccl_2_cards"] = f"not run: {cards} card visible"
    shutil.rmtree(root, ignore_errors=True)
    return {"line": line, "rank_launches": {
        k: [r["step_launches"][k] for r in ranks6] for k in kernels}}


def main():
    timer = threading.Timer(WATCHDOG_S, _expire)
    timer.daemon = True
    timer.start()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from liftreg_tpu_torch import RegistrationPipeline
    from liftreg_tpu_torch.models import s2d
    from liftreg_tpu_torch.models.subspace_backproj import mask_lung
    from liftreg_tpu_torch.ops import resample
    from liftreg_tpu_torch.ops import _build, drr, warp_kernel
    from liftreg_tpu_torch.ops.drr_kernel import (
        backproject_taps, backproject_taps_plain, lift_encoder_input, project,
        project_adjoint_plan, project_adjoint_plan_plain, project_adjoint_taps,
        project_adjoint_taps_plain, project_taps, project_taps_plain)
    from liftreg_tpu_torch.ops.pca_kernel import (MAX_CHUNK, pca_expand,
                                                  pca_expand_plain, pca_grad,
                                                  pca_grad_plain)
    from liftreg_tpu_torch.ops.warp_kernel import (image_grad_overflow,
                                                   warp_coord_grad,
                                                   warp_coord_grad_plain,
                                                   warp_image_grad,
                                                   warp_image_grad_plain,
                                                   warp_trilinear,
                                                   warp_trilinear_plain)
    from liftreg_tpu_torch.pipeline import normalize_hu
    from liftreg_tpu_torch.refine import make_projection_refiner, make_refiner

    KERNELS = _kernel_table()

    dev = torch.device("cuda")

    # learned_basis's dataset is host work: written meanwhile
    learned_root = os.path.abspath(os.path.join("build",
                                                "chip_smoke_learned"))
    shutil.rmtree(learned_root, ignore_errors=True)
    learned_proc = start_learned_dataset(learned_root)
    dirlab_root = os.path.abspath(os.path.join("build", "chip_smoke_dirlab"))
    shutil.rmtree(dirlab_root, ignore_errors=True)

    _begin("build")
    fresh = not _build.library_path().is_file()
    lib_path = _build.build()
    _build.library()
    _emit(nvcc_processes=(len(_build.SOURCES) + 1) * int(fresh),
          library=os.path.relpath(lib_path))

    _begin("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    device_name = torch.cuda.get_device_name(0)
    _emit(name=device_name, nvidia_smi=smi, count=torch.cuda.device_count())

    g = torch.Generator(device=dev).manual_seed(0)
    n = 3 * SZ ** 3
    errs = {}

    # -- each kernel against its plain version -----------------------------
    _begin("pca_check")
    coefs = torch.randn((B, LATENT), generator=g, device=dev)
    V = (torch.randn((LATENT, n), generator=g, device=dev) * 0.01).bfloat16()
    mean = torch.randn((n,), generator=g, device=dev) * 0.01
    pca_err = _max_err(pca_expand(coefs, V, mean),
                       pca_expand_plain(coefs, V, mean))
    ragged = {}
    for m in (3 * 50 ** 3, 3 * 49 ** 3):    # partial last block; scalar path
        c2 = torch.randn((3, 13), generator=g, device=dev)
        v2 = (torch.randn((13, m), generator=g, device=dev) * 0.01).bfloat16()
        m2 = torch.randn((m,), generator=g, device=dev) * 0.01
        ragged[m] = _max_err(pca_expand(c2, v2, m2),
                             pca_expand_plain(c2, v2, m2))
    # more rows than one launch holds: one launch per chunk of MAX_CHUNK
    coefs9 = torch.randn((9, LATENT), generator=g, device=dev)
    before = pca_expand.launches
    got9 = pca_expand(coefs9, V, mean)
    chunks9 = pca_expand.launches - before
    batch9_err = _max_err(got9, pca_expand_plain(coefs9, V, mean))
    del got9
    errs["pca_expand"] = max(pca_err, batch9_err, *ragged.values())
    _emit(max_abs_err=pca_err, ragged_max_abs_err=ragged,
          batch9_max_abs_err=batch9_err, batch9_launches=chunks9, tol=PCA_TOL)
    _require(chunks9 == -(-9 // MAX_CHUNK),
             f"B=9 took {chunks9} PCA launches")
    _require(errs["pca_expand"] <= PCA_TOL,
             f"PCA kernel error {errs['pca_expand']} > {PCA_TOL}")

    _begin("warp_check")
    vol01 = torch.rand((B, 1, SZ, SZ, SZ), generator=g, device=dev)
    coords = _smooth_coords(torch, F, g, B, SZ, 4.0, dev)
    warp_errs = {}
    taps = {}
    for tdt in (torch.bfloat16, torch.float32):
        taps[tdt] = vol01.to(tdt)
        for border in (False, True):
            key = f"{str(tdt).split('.')[-1]}/{'border' if border else 'zeros'}"
            warp_errs[key] = _max_err(
                warp_trilinear(taps[tdt], coords, border),
                warp_trilinear_plain(taps[tdt], coords, border))
    # volumes with a spatial dim of 1 (the quad and generic axis modes)
    unit_grad_rel = {}
    for ushape in ((1, SZ, SZ), (SZ, 1, SZ), (SZ, SZ, 1)):
        uvol = torch.rand((2, 1) + ushape, generator=g, device=dev)
        uscale = torch.tensor(ushape, dtype=torch.float32, device=dev)
        ucoords = torch.rand((2, SZ * SZ, 3), generator=g, device=dev) \
            * (uscale + 2.0) - 1.5
        ucoords[:, ::4] = torch.floor(ucoords[:, ::4])
        ucot = torch.randn((2, 1, SZ * SZ), generator=g, device=dev)
        for tdt in (torch.bfloat16, torch.float32):
            for border in (False, True):
                key = (f"{'x'.join(map(str, ushape))}/"
                       f"{str(tdt).split('.')[-1]}/"
                       f"{'border' if border else 'zeros'}")
                ut = uvol.to(tdt)
                warp_errs[key] = _max_err(
                    warp_trilinear(ut, ucoords, border),
                    warp_trilinear_plain(ut, ucoords, border))
                want = warp_coord_grad_plain(ut, ucoords, ucot, border)
                unit_grad_rel[key] = _max_err(
                    warp_coord_grad(ut, ucoords, ucot, border), want) \
                    / float(want.abs().max())
    # phi in its (B, 3, D, W, H) layout, as warp_image passes it
    phi_cases = warp_phi_cases(torch, F, g, dev)
    phi_errs = {}
    for name, (pvol, phi, _) in phi_cases.items():
        for tdt, border, rescale in _warp_flags(torch):
            pt = pvol.to(tdt)
            key = f"phi/{name}/{_flag_key(tdt, border, rescale)}"
            phi_errs[key] = _max_err(
                warp_trilinear(pt, phi, border, normalized=True,
                               scale_intensity=rescale),
                warp_trilinear_plain(pt, phi, border, normalized=True,
                                     scale_intensity=rescale))
    warp_errs.update(phi_errs)
    errs["warp_trilinear"] = max(warp_errs.values())
    _emit(max_abs_err=warp_errs, tol=WARP_TOL,
          unit_dim_grad_rel_err=unit_grad_rel,
          grad_rel_tol=WARP_GRAD_REL_TOL)
    _require(max(unit_grad_rel.values()) <= WARP_GRAD_REL_TOL,
             f"warp gradient kernel on unit dims: {unit_grad_rel}")
    _require(errs["warp_trilinear"] <= WARP_TOL,
             f"warp kernel error {errs['warp_trilinear']} > {WARP_TOL}")

    _begin("drr_check")
    pipe_poses, res, fwd_geom, bwd_geom, att, proj_in = serving_drr_inputs(
        torch, drr, g, dev)
    drr_errs = {}

    def proj_err(vol, geom):
        """(max abs error, that error over the largest line integral)"""
        want = project_taps_plain(vol, *geom)
        err = _max_err(project_taps(vol, *geom), want)
        return err, err / float(want.abs().max())

    def lift_err(p, geom):
        return _max_err(backproject_taps(p, *geom),
                        backproject_taps_plain(p, *geom))

    drr_errs["project_serving"], drr_errs["project_serving_rel"] = \
        proj_err(att, fwd_geom)
    drr_errs["lift_serving"] = lift_err(proj_in, bwd_geom)
    # a ragged shape with coordinates on the edges of the zero padding
    D2, W2, H2, rd, rh = 37, 29, 41, 53, 47
    vol2 = torch.rand((3, D2, W2, H2), generator=g, device=dev)
    geom2 = (_edge_pix(torch, g, (3, W2, rd), D2, dev),
             _edge_pix(torch, g, (3, W2, rh), H2, dev),
             torch.rand((3, rd, rh), generator=g, device=dev) + 1.0)
    drr_errs["project_ragged"], drr_errs["project_ragged_rel"] = \
        proj_err(vol2, geom2)
    p2 = torch.rand((2, 3, rd, rh), generator=g, device=dev)
    geom2b = (_edge_pix(torch, g, (3, W2, D2), rd, dev),
              _edge_pix(torch, g, (3, W2, H2), rh, dev))
    drr_errs["lift_ragged"] = lift_err(p2, geom2b)
    # the lift into the encoder's bf16 input buffer (liftreg::encoder_input,
    # as the serving path runs it): its f32 values rounded once, bit for
    # bit, and the moving CT in channel 0
    lift_moving = att[:, None]
    lift_buf = lift_encoder_input(lift_moving, proj_in, *bwd_geom,
                                  dtype=torch.bfloat16)
    lift_bf16_equal = bool(torch.equal(
        lift_buf[:, 1:], backproject_taps(proj_in, *bwd_geom).bfloat16())
        and torch.equal(lift_buf[:, :1], lift_moving.bfloat16()))
    drr_errs["lift_bf16_buffer_bit_equal"] = lift_bf16_equal

    def adjoint_err(cot, geom, vol_shape):
        """[max abs error, that error over the largest value, whether a
        second call gives the same bits, the tiles that took the kernel's
        general path, whether the plan equals the plain plan] of the adjoint
        kernel, with its plan built once"""
        plan = project_adjoint_plan(geom[0], geom[1], vol_shape)
        general = torch.zeros(1, dtype=torch.int32, device=dev)
        want = project_adjoint_taps_plain(cot, *geom, vol_shape)
        got = project_adjoint_taps(cot, *geom, vol_shape, plan=plan,
                                   general_tiles=general)
        again = project_adjoint_taps(cot, *geom, vol_shape, plan=plan)
        err = _max_err(got, want)
        return [err, err / float(want.abs().max()),
                bool(torch.equal(got, again)), int(general.item()),
                bool(torch.equal(plan, project_adjoint_plan_plain(
                    geom[0], geom[1], vol_shape)))]

    def pose_geom(views, vol_shape, det):
        poses_v = torch.from_numpy(drr.synthesize_poses(
            30.0, views, vol_shape[1])).to(dev)
        return drr.forward_geometry(poses_v, vol_shape, det, (2.2, 2.2, 2.2))

    # the projector's adjoint: the serving shape with B = 1, 4, 5 and 9
    # (three batch groups) and with 3 and 9 views (three view groups of the
    # stage); the ragged shape with sorted edge and integer coordinates
    # (rising rows, as poses make them) and edge coordinates falling; a
    # detector narrower than the volume's shadow; and rows in no order in
    # the middle view group of 9 at a small shape (the general path, then
    # the staged path adding onto its sums). The serving geometry must take
    # no general path.
    adj = {}
    for batch in (1, B, 5, 9):
        adj[f"serving_b{batch}"] = adjoint_err(
            torch.randn((batch, 4) + res, generator=g, device=dev), fwd_geom,
            (SZ,) * 3)
    for views in (3, 9):
        adj[f"serving_{views}views"] = adjoint_err(
            torch.randn((B, views) + res, generator=g, device=dev),
            pose_geom(views, (SZ,) * 3, res), (SZ,) * 3)

    def sorted_pix(shape, n, values):
        if values == "integer":
            pix = torch.randint(-2, n + 2, shape, generator=g,
                                device=dev).float()
        else:
            pix = _edge_pix(torch, g, shape, n, dev)
        pix = pix.sort(dim=-1).values
        return (pix.flip(-1) if values == "falling" else pix).contiguous()

    for values in ("edges", "integer", "falling"):
        adj[f"ragged_{values}"] = adjoint_err(
            torch.randn((5, 3, rd, rh), generator=g, device=dev),
            (sorted_pix((3, W2, rd), D2, values),
             sorted_pix((3, W2, rh), H2, values), geom2[2]), (D2, W2, H2))
    adj["narrow_detector"] = adjoint_err(
        torch.randn((B, 4, 30, 40), generator=g, device=dev),
        pose_geom(4, (48, 20, 64), (30, 40)), (48, 20, 64))
    geom9 = pose_geom(9, (20, 17, 22), (30, 27))
    geom9[0][4:8] = _edge_pix(torch, g, (4, 17, 30), 20, dev)
    geom9[1][4:8] = _edge_pix(torch, g, (4, 17, 27), 22, dev)
    adj["views9_middle_unordered"] = adjoint_err(
        torch.randn((5, 9, 30, 27), generator=g, device=dev), geom9,
        (20, 17, 22))
    drr_errs["adjoint"] = adj
    errs["drr_project_adjoint"] = max(e[0] for e in adj.values())
    # the plan's entries are integers: 0 where it equals the plain plan
    errs["drr_adjoint_plan"] = 0.0 if all(e[4] for e in adj.values()) \
        else float("inf")
    errs["drr_project"] = max(drr_errs["project_serving"],
                              drr_errs["project_ragged"])
    errs["drr_backproject"] = max(drr_errs["lift_serving"],
                                  drr_errs["lift_ragged"])
    _emit(max_err=drr_errs, tol={"project_rel": PROJ_REL_TOL,
                                 "lift": LIFT_TOL,
                                 "adjoint_rel": ADJ_REL_TOL})
    proj_rel = max(drr_errs["project_serving_rel"],
                   drr_errs["project_ragged_rel"])
    _require(proj_rel <= PROJ_REL_TOL,
             f"projector kernel relative error {proj_rel}")
    _require(errs["drr_backproject"] <= LIFT_TOL,
             f"lift kernel error {errs['drr_backproject']}")
    _require(lift_bf16_equal, "the lift's bf16 buffer is not its f32 output "
             "rounded once")
    _require(all(e[1] <= ADJ_REL_TOL and e[2] for e in adj.values()),
             f"the adjoint kernel disagrees or changes its bits: {adj}")
    _require(all(e[4] for e in adj.values()),
             f"the adjoint's plan differs from the plain plan: {adj}")
    _require(all(e[3] == 0 for k, e in adj.items()
                 if k.startswith("serving")),
             f"the serving geometry took the adjoint's general path: {adj}")
    _require(adj["views9_middle_unordered"][3] > 0,
             "rows in no order did not take the adjoint's general path")

    _begin("grad_check")
    cot = torch.randn((B, 1, SZ ** 3), generator=g, device=dev)
    grad_errs = {}
    int_coords = torch.floor(coords)
    for tdt in (torch.bfloat16, torch.float32):
        for border in (False, True):
            for name, c in (("smooth", coords), ("integer", int_coords)):
                key = (f"{str(tdt).split('.')[-1]}/"
                       f"{'border' if border else 'zeros'}/{name}")
                want = warp_coord_grad_plain(taps[tdt], c, cot, border)
                err = _max_err(warp_coord_grad(taps[tdt], c, cot, border),
                               want)
                grad_errs[key] = [err, err / float(want.abs().max())]
                del want
    # M not a multiple of the kernel's points per thread (its masked path)
    ragged_m = SZ ** 3 - 1
    c_r = coords[:, :ragged_m].contiguous()
    cot_r = cot[..., :ragged_m].contiguous()
    want = warp_coord_grad_plain(taps[torch.bfloat16], c_r, cot_r, False)
    err = _max_err(warp_coord_grad(taps[torch.bfloat16], c_r, cot_r, False),
                   want)
    grad_errs["bfloat16/zeros/ragged_m"] = [err,
                                            err / float(want.abs().max())]
    del c_r, cot_r, want
    for name, (pvol, phi, pcot) in phi_cases.items():
        for tdt, border, rescale in _warp_flags(torch):
            pt = pvol.to(tdt)
            want = warp_coord_grad_plain(pt, phi, pcot, border,
                                         normalized=True,
                                         scale_intensity=rescale)
            err = _max_err(warp_coord_grad(pt, phi, pcot, border,
                                           normalized=True,
                                           scale_intensity=rescale), want)
            grad_errs[f"phi/{name}/{_flag_key(tdt, border, rescale)}"] = [
                err, err / float(want.abs().max())]
            del want
    del phi_cases
    errs["warp_coord_grad"] = max(e[0] for e in grad_errs.values())
    grad_rel = max(e[1] for e in grad_errs.values())
    cot_pca = torch.randn((B, n), generator=g, device=dev)
    pca_grad_errs = {}
    for key, (cg, vg) in {
            "serving": (cot_pca, V),
            "ragged": (torch.randn((3, 3 * 49 ** 3), generator=g, device=dev),
                       (torch.randn((13, 3 * 49 ** 3), generator=g,
                                    device=dev) * 0.01).bfloat16())}.items():
        want = pca_grad_plain(cg, vg)
        got = pca_grad(cg, vg)
        exact = cg.double() @ vg.double().T
        pca_grad_errs[key] = {"max_abs_err": _max_err(got, want),
                              "f64_excess": _f64_excess(torch, got, exact),
                              "plain_f64_excess": _f64_excess(torch, want,
                                                              exact),
                              "bf16_values": bool(torch.equal(
                                  got, got.bfloat16().float())),
                              # no float atomics: a second call, same bits
                              "repeat_bit_equal": bool(torch.equal(
                                  got, pca_grad(cg, vg)))}
    errs["pca_grad"] = max(e["max_abs_err"] for e in pca_grad_errs.values())
    _emit(warp_grad_abs_rel_err=grad_errs,
          warp_grad_rel_tol=WARP_GRAD_REL_TOL,
          pca_grad=pca_grad_errs,
          pca_grad_f64_tol={"half_bf16_step": True,
                            "rel_atol": PCA_GRAD_F64_REL_ATOL})
    _require(grad_rel <= WARP_GRAD_REL_TOL,
             f"warp gradient kernel relative error {grad_rel}")
    _require(all(e["f64_excess"] <= 0 and e["plain_f64_excess"] <= 0
                 and e["bf16_values"]
                 and e["repeat_bit_equal"] for e in pca_grad_errs.values()),
             f"PCA backward kernel disagrees: {pca_grad_errs}")

    _begin("image_grad_check")
    # the warp's image gradient (f32 taps) against its plain version, both
    # paddings, scale_intensity on and off in the phi layout, two calls;
    # the share of each call's points that took the overflow path
    overflow = image_grad_overflow(dev)
    img_errs, img_overflow = {}, {}
    for name, (ivol, pts, icot, phi_layout) in image_grad_cases(
            torch, F, g, dev).items():
        for border in (False, True):
            for rescale in ((False, True) if phi_layout else (False,)):
                flags = ({"normalized": True, "scale_intensity": rescale}
                         if phi_layout else {})
                key = (f"{name}/{'border' if border else 'zeros'}"
                       f"{'/scaled' if rescale else ''}")
                overflow.zero_()
                img_errs[key] = image_grad_errs(
                    warp_image_grad, warp_image_grad_plain, ivol, pts, icot,
                    border, **flags)
                img_overflow[key] = int(overflow) / (2 * icot.numel()
                                                     / icot.shape[1])
    errs["warp_image_grad"] = max(e["max_abs_err"] for e in img_errs.values())
    _emit(max_err=img_errs, overflow_share=img_overflow,
          tol={"rel": IMG_GRAD_REL_TOL,
               "of_terms_magnitude": IMG_GRAD_MAG_TOL})
    _require(all(e["excess"] <= 0 and e["repeat_excess"] <= 0
                 for e in img_errs.values()),
             f"the image-gradient kernel disagrees: {img_errs}")
    # both sides of the choice ran: the rough field, and the slab under
    # border padding, drove the overflow path; the smooth fields at SZ^3
    # in 3-D tiles the box (flat tiles of the pixel layout mostly overflow
    # there)
    _require(all(share > 0 for key, share in img_overflow.items()
                 if "/rough" in key or ("/slab" in key and "/border" in key)),
             f"no overflow where the boxes cannot fit: {img_overflow}")
    _require(all(share < 0.5 for key, share in img_overflow.items()
                 if re.match(r"phi/c\d_b\d/", key)),
             f"the smooth fields did not take the box: {img_overflow}")

    # -- the gather probes' tools and kernels ------------------------------
    probe_rows = gather_probe_phase(torch, KERNELS)

    # -- the main path -----------------------------------------------------
    _begin("main_path")
    torch.manual_seed(0)
    pipe = RegistrationPipeline((SZ,) * 3, latent_dim=LATENT,
                                compute_dtype=torch.bfloat16)
    pca = {"vectors": V, "mean": mean}
    shape = (B, 1, SZ, SZ, SZ)
    src_hu = torch.rand(shape, generator=g, device=dev) * -1000.0
    tgt_hu = torch.rand(shape, generator=g, device=dev) * -1000.0
    seg = (torch.rand(shape, generator=g, device=dev) > 0.4).float()

    _zero(KERNELS)
    warped, phi = pipe.register(pca, src_hu, tgt_hu, seg, seg)
    torch.cuda.synchronize()
    launches = _counts(KERNELS)
    _require(warped.shape == shape and phi.shape == (B, 3, SZ, SZ, SZ),
             f"shapes {tuple(warped.shape)}, {tuple(phi.shape)}")
    _require(bool(torch.isfinite(warped).all() and torch.isfinite(phi).all()),
             "non-finite output")
    # each wrapper counts one launch per call (per chunk of 8 rows for the
    # PCA kernels); the projector, whose plane loop the wrapper splits at
    # this shape, runs as two passes (chunks, then their ordered sum) and
    # counts them as one launch, as the PCA backward does
    serving = dict({k: 0 for k in KERNELS}, pca_expand=1,
                   warp_trilinear=1, drr_project=1, drr_backproject=1)
    _require(launches == serving,
             f"main path launch counts {launches}, expected {serving}")

    proj = drr.normalize_drr(project(
        drr.calc_relative_atten_coef(tgt_hu[:, 0]), pipe.poses,
        pipe.resolution, pipe.spacing))
    _zero(KERNELS)
    warped_p, phi_p = pipe.register_projections(pca, src_hu, proj, seg)
    torch.cuda.synchronize()
    launches_p = _counts(KERNELS)
    _require(bool(torch.isfinite(warped_p).all()
                  and torch.isfinite(phi_p).all()),
             "non-finite output of register_projections")
    _require(launches_p == dict(serving, drr_project=0),
             f"register_projections launch counts {launches_p}")
    _emit(launches=launches, launches_projections=launches_p,
          warped=list(warped.shape), phi=list(phi.shape),
          phi_range=[float(phi.min()), float(phi.max())])

    # -- per-case refinement at the serving config -------------------------
    _begin("refine")
    r_src, r_tgt, r_seg, r_pca = refine_inputs(torch, F, g, dev)
    pipe_r = RegistrationPipeline((SZ,) * 3, latent_dim=LATENT,
                                  compute_dtype=torch.bfloat16,
                                  refine_steps=REFINE_STEPS)
    pipe_r.model.load_state_dict(pipe.model.state_dict())
    torch.cuda.reset_peak_memory_stats()
    _zero(KERNELS)
    t0 = time.perf_counter()
    warped_r, phi_r = pipe_r.register(r_pca, r_src, r_tgt, r_seg, r_seg)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    refine_launches = _counts(KERNELS)
    refine_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = dict({k: 0 for k in KERNELS}, drr_project=1,
                    drr_backproject=1, pca_expand=REFINE_STEPS + 3,
                    pca_grad=REFINE_STEPS + 1,
                    warp_trilinear=REFINE_STEPS + 3,
                    warp_coord_grad=REFINE_STEPS + 1)
    res_r = pipe_r.last_refine
    _require(bool(torch.isfinite(warped_r).all()
                  and torch.isfinite(phi_r).all()),
             "non-finite refined output")
    _require(refine_launches == expected,
             f"launch counts {refine_launches}, expected {expected}")
    # the unrefined objective of each case: the same objective at the
    # encoder's coefficients (a refiner of 0 steps), from the same inputs
    inputs = {"source": normalize_hu(r_src), "target": normalize_hu(r_tgt),
              "target_proj": drr.normalize_drr(project(
                  drr.calc_relative_atten_coef(r_tgt[:, 0]), pipe_r.poses,
                  pipe_r.resolution, pipe_r.spacing)),
              "target_poses": pipe_r.poses[None],
              "source_label": r_seg, "target_label": r_seg}
    with torch.no_grad():
        out0 = pipe_r.model(inputs, r_pca)
    res0 = make_refiner((SZ,) * 3, n_steps=0,
                        warp_taps_dtype=torch.bfloat16)(
        out0["pca_coefs"], r_pca, mask_lung(inputs["source"], r_seg),
        out0["target"])
    unrefined = res0["total_per_sample"]
    refined = res_r["total_per_sample"]
    hist = res_r["total_history"]
    _require(bool(torch.equal(res0["total_history"][0], hist[0])),
             f"unrefined objective {float(res0['total_history'][0])} is not "
             f"the refinement's step 0 {float(hist[0])}")
    _require(bool((refined <= unrefined).all()),
             f"refinement made a case worse: {refined.tolist()} > "
             f"{unrefined.tolist()}")
    _emit(launches=refine_launches, steps=REFINE_STEPS,
          unrefined_total_per_sample=unrefined.tolist(),
          refined_total_per_sample=refined.tolist(),
          total_history=[round(float(x), 6) for x in hist],
          sim_history_first_last=[float(res_r["sim_history"][0]),
                                  float(res_r["sim_history"][-1])],
          first_call_ms=first_ms, peak_memory_gib=refine_peak_gib)
    del out0, res0, inputs

    # -- projection-domain refinement at the serving config ----------------
    _begin("refine_projection")
    pipe_p = RegistrationPipeline((SZ,) * 3, latent_dim=LATENT,
                                  compute_dtype=torch.bfloat16,
                                  refine_steps=REFINE_STEPS,
                                  refine_domain="projection")
    pipe_p.model.load_state_dict(pipe.model.state_dict())
    torch.cuda.reset_peak_memory_stats()
    _zero(KERNELS)
    t0 = time.perf_counter()
    warped_p, phi_p = pipe_p.register(r_pca, r_src, r_tgt, r_seg, r_seg)
    torch.cuda.synchronize()
    first_p_ms = (time.perf_counter() - t0) * 1e3
    projection_launches = _counts(KERNELS)
    proj_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    res_p = pipe_p.last_refine
    # the target DRR, N+1 steps and the final evaluation; the encoder's
    # warp, N+2 in the refiner and the rewarp of the masked CT; one plan of
    # the adjoint, built at the refiner's first call and kept
    expected_p = dict({k: 0 for k in KERNELS},
                      drr_project=REFINE_STEPS + 3,
                      drr_project_adjoint=REFINE_STEPS + 1,
                      drr_adjoint_plan=1, drr_backproject=1,
                      pca_expand=REFINE_STEPS + 3,
                      pca_grad=REFINE_STEPS + 1,
                      warp_trilinear=REFINE_STEPS + 4,
                      warp_coord_grad=REFINE_STEPS + 1)
    _require(bool(torch.isfinite(warped_p).all()
                  and torch.isfinite(phi_p).all()),
             "non-finite projection-refined output")
    _require(projection_launches == expected_p,
             f"launch counts {projection_launches}, expected {expected_p}")
    # the unrefined objective: a refiner of 0 steps at the encoder's
    # coefficients, from the same inputs
    target_proj = drr.normalize_drr(project(
        drr.calc_relative_atten_coef(r_tgt[:, 0]), pipe_p.poses,
        pipe_p.resolution, pipe_p.spacing))
    inputs = {"source": normalize_hu(r_src), "target": normalize_hu(r_tgt),
              "target_proj": target_proj, "target_poses": pipe_p.poses[None],
              "source_label": r_seg, "target_label": r_seg}
    with torch.no_grad():
        out0 = pipe_p.model(inputs, r_pca)
    r_atten = drr.calc_relative_atten_coef(r_src)
    res0 = make_projection_refiner(
        (SZ,) * 3, pipe_p.poses, pipe_p.resolution, pipe_p.spacing,
        n_steps=0, warp_taps_dtype=torch.bfloat16)(
        out0["pca_coefs"], r_pca, r_atten, target_proj)
    unrefined_p = res0["total_per_sample"]
    refined_p = res_p["total_per_sample"]
    hist_p = res_p["total_history"]
    _require(bool(torch.equal(res0["total_history"][0], hist_p[0])),
             f"unrefined objective {float(res0['total_history'][0])} is not "
             f"the refinement's step 0 {float(hist_p[0])}")
    _require(bool((refined_p <= unrefined_p).all()),
             f"projection refinement made a case worse: "
             f"{refined_p.tolist()} > {unrefined_p.tolist()}")
    # the output is the masked CT rewarped by the refined phi
    _require(bool(torch.equal(warped_p, resample.warp_image(
        mask_lung(inputs["source"], r_seg), phi_p,
        taps_dtype=torch.bfloat16))), "the output is not the rewarped CT")
    del out0, res0, inputs

    # register_projections: the same refinement without the target DRR
    _zero(KERNELS)
    warped_pp, phi_pp = pipe_p.register_projections(r_pca, r_src,
                                                    target_proj, r_seg)
    torch.cuda.synchronize()
    projections_launches = _counts(KERNELS)
    refined_pp = pipe_p.last_refine["total_per_sample"]
    _require(bool(torch.isfinite(warped_pp).all()
                  and torch.isfinite(phi_pp).all()),
             "non-finite output of register_projections")
    # the refiner's second call: its plan is kept from the first
    _require(projections_launches == dict(expected_p,
                                          drr_project=REFINE_STEPS + 2,
                                          drr_adjoint_plan=0),
             f"register_projections launch counts {projections_launches}")
    _require(bool((refined_pp <= unrefined_p).all()),
             f"register_projections' refinement made a case worse: "
             f"{refined_pp.tolist()} > {unrefined_p.tolist()}")
    _emit(launches=projection_launches,
          launches_projections=projections_launches, steps=REFINE_STEPS,
          unrefined_total_per_sample=unrefined_p.tolist(),
          refined_total_per_sample=refined_p.tolist(),
          register_projections_refined_total_per_sample=refined_pp.tolist(),
          register_projections_phi_max_abs_diff=_max_err(phi_pp, phi_p),
          total_history=[round(float(x), 6) for x in hist_p],
          sim_history_first_last=[float(res_p["sim_history"][0]),
                                  float(res_p["sim_history"][-1])],
          first_call_ms=first_p_ms, peak_memory_gib=proj_peak_gib)
    del warped_pp, phi_pp, r_atten

    # -- no glue around the warp on the card --------------------------------
    _begin("glue_check")
    glue = {"register": glue_ops(
                torch, lambda: pipe.register(pca, src_hu, tgt_hu, seg, seg),
                B, SZ),
            "register_refine": glue_ops(
                torch, lambda: pipe_r.register(r_pca, r_src, r_tgt, r_seg,
                                               r_seg), B, SZ),
            "register_refine_projection": glue_ops(
                torch, lambda: pipe_p.register(r_pca, r_src, r_tgt, r_seg,
                                               r_seg), B, SZ)}
    _emit(**glue)
    _require(all(c["coordinate_buffers"] == 0 and c["rescales"] == 0
                 for c in glue.values()),
             f"glue around the warp on the card: {glue}")
    # a copy between host and card waits for the stream: none in a call
    _require(all(c["host_to_device"] == 0 and c["device_to_host"] == 0
                 for c in glue.values()),
             f"a call copies between host and card: {glue}")
    # one cast for the encoder's prediction, one for the refinement's steps
    _require(glue["register"]["tap_casts"] == 1
             and glue["register_refine"]["tap_casts"] == 2
             and glue["register_refine_projection"]["tap_casts"] == 3,
             f"the tap tensor is built more than once per call: {glue}")

    # -- serving: one-file artifacts of the main path ----------------------
    r_args = (r_src, r_tgt, r_seg, r_seg)
    serving_phase(
        torch, KERNELS, pipe, pca, (src_hu, tgt_hu, seg, seg), proj,
        {"image": (pipe_r, r_pca, r_args),
         "projection": (pipe_p, r_pca, r_args)},
        os.path.abspath(os.path.join("build", "chip_smoke_serving")),
        launches)
    torch.cuda.empty_cache()

    # -- the card against the CPU at a small size --------------------------
    _begin("reference")
    small, L_small = (32, 32, 32), 8
    n_small = 3 * 32 ** 3
    gc = torch.Generator().manual_seed(1)
    cpu_pca = {"vectors": (torch.randn((L_small, n_small), generator=gc)
                           * 0.01).bfloat16(),
               "mean": torch.randn((n_small,), generator=gc) * 0.01}
    args = [torch.rand((2, 1) + small, generator=gc) * -1000.0,
            torch.rand((2, 1) + small, generator=gc) * -1000.0]
    args += [(torch.rand((2, 1) + small, generator=gc) > 0.4).float()] * 2
    torch.manual_seed(1)
    state = RegistrationPipeline(small, latent_dim=L_small,
                                 device="cpu").model.state_dict()
    ref_errs = {}
    for taps_dtype, tol in ((torch.float32, REF_F32_TOL),
                            (torch.bfloat16, REF_BF16_TOL)):
        outs = {}
        for where in ("cpu", "cuda"):
            p = RegistrationPipeline(small, latent_dim=L_small,
                                     warp_taps_dtype=taps_dtype, device=where)
            p.model.load_state_dict(state)
            pc = {k: v.to(where) for k, v in cpu_pca.items()}
            outs[where] = [t.cpu() for t in
                           p.register(pc, *(a.to(where) for a in args))]
        key = str(taps_dtype).split(".")[-1]
        ref_errs[key] = {"phi": _max_err(outs["cuda"][1], outs["cpu"][1]),
                         "warped": _max_err(outs["cuda"][0], outs["cpu"][0]),
                         "tol": tol}
    _emit(max_abs_err=ref_errs)
    for key, e in ref_errs.items():
        _require(e["phi"] <= e["tol"][0] and e["warped"] <= e["tol"][1],
                 f"pipeline on the card disagrees with the CPU ({key} taps)")

    _begin("refine_reference")
    gs = torch.Generator(device=dev).manual_seed(2)
    small_pca = {k: v.cpu() for k, v in {
        "vectors": _smooth_basis(torch, F, gs, L_small, 32, 0.05, dev),
        "mean": torch.zeros((n_small,), device=dev)}.items()}
    field = _smooth_field(torch, F, gs, (2, 1) + small, 6, dev).cpu()
    s_args = [field * 400.0 - 500.0,
              torch.roll(field, shifts=(1, -2, 1), dims=(2, 3, 4)) * 400.0
              - 500.0] + [torch.ones((2, 1) + small)] * 2
    # image domain with NCC and with LNCC (pre-smoothed, two scales);
    # projection domain with NCC and with NGF
    configs = {"image_ncc": {},
               "image_lncc": {"refine_sim": "lncc", "refine_sim_opts": {
                   "smooth": 3, "scales": [1, 2]}},
               "projection_ncc": {"refine_domain": "projection"},
               "projection_ngf": {"refine_domain": "projection",
                                  "refine_sim": "ngf"}}
    def refined(where, opts, steps=5, lr=0.02, coefs=None):
        """register with refinement on ``where``: (warped, phi, objective
        history, refined coefficients); with ``coefs`` the encoder's output
        is replaced by them (lr 0 then keeps them: the outputs at those
        coefficients)."""
        p = RegistrationPipeline(small, latent_dim=L_small,
                                 warp_taps_dtype=torch.float32,
                                 refine_steps=steps, refine_lr=lr,
                                 device=where, **opts)
        p.model.load_state_dict(state)
        if coefs is not None:
            p.model.encoder.register_forward_hook(
                lambda m, i, o: coefs.to(device=o.device, dtype=o.dtype))
        pc = {k: v.to(where) for k, v in small_pca.items()}
        out = [t.cpu() for t in p.register(pc, *(a.to(where)
                                                 for a in s_args))]
        return out + [p.last_refine["total_history"].cpu(),
                      p.last_refine["coefs"].cpu()]

    def flipped_coord_grad():
        """refined on the card with the warp's coordinate gradient negated
        along its first axis, for that run only: a wrong refinement
        gradient (not a scaled one, which Adam's steps would not see)."""
        with negated_coord_grad(warp_kernel):
            return refined("cuda", configs["projection_ngf"])

    refine_ref, cpu_runs = {}, {}
    for cfg, opts in configs.items():
        cpu, card = refined("cpu", opts), refined("cuda", opts)
        cpu_runs[cfg] = cpu
        # the outputs held: the CPU run's, or for the ill-conditioned case
        # the CPU's at the card's refined coefficients
        held = (refined("cpu", opts, steps=1, lr=0.0, coefs=card[3])
                if cfg in REFINE_AT_CARD_COEFS else cpu)
        refine_ref[cfg] = {
            "held_to": ("cpu_at_card_coefs" if cfg in REFINE_AT_CARD_COEFS
                        else "cpu_run"),
            "phi": _max_err(card[1], held[1]),
            "warped": _max_err(card[0], held[0]),
            "total_history": _max_err(card[2], cpu[2]),
            "coefs_vs_cpu_run": _max_err(card[3], cpu[3]),
            "phi_vs_cpu_run": _max_err(card[1], cpu[1]),
            "warped_vs_cpu_run": _max_err(card[0], cpu[0]),
            "history_cpu": [float(x) for x in cpu[2]]}
    # the negative control: the history must see a wrong coordinate
    # gradient in the ill-conditioned case
    control = _max_err(flipped_coord_grad()[2],
                       cpu_runs["projection_ngf"][2])
    _emit(max_abs_err=refine_ref, tol=REFINE_REF_TOL,
          history_tol=REFINE_HISTORY_TOL,
          flipped_coord_grad_history_err=control)
    for cfg, e in refine_ref.items():
        _require(e["phi"] <= REFINE_REF_TOL[0]
                 and e["warped"] <= REFINE_REF_TOL[1]
                 and e["total_history"] <= REFINE_HISTORY_TOL,
                 f"refinement ({cfg}) on the card disagrees with the CPU")
    _require(control > REFINE_HISTORY_TOL,
             f"the history's check does not see a wrong coordinate "
             f"gradient: {control}")

    def profile_call(fn, totals=(), **fields):
        """Run ``fn`` once under torch.profiler and emit its wall time,
        device time by layer and the device's idle share, with ``fields``
        (and the wall time a step where they give ``steps``), and for each
        layer in ``totals`` its device ms and kernel launches. Returns
        (wall ms, device busy ms)."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernel_ms, kernel_calls = {}, {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernel_ms[e.key] = e.self_device_time_total / 1e3
                kernel_calls[e.key] = e.count
        for layer in totals:
            names = [k for k in kernel_ms if _layer(k) == layer]
            fields[f"{layer}_total"] = {
                "ms": sum(kernel_ms[k] for k in names),
                "launches": sum(kernel_calls[k] for k in names)}
        by_layer = {}
        for name, t in kernel_ms.items():
            by_layer[_layer(name)] = by_layer.get(_layer(name), 0.0) + t
        busy_ms = sum(kernel_ms.values())
        top = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:8]
        # a concatenation's copy kernel (the encoder input is built in place)
        cat_ms = sum(t for name, t in kernel_ms.items() if "CatArray" in name)
        if "steps" in fields:
            fields["ms_per_step"] = wall_ms / fields["steps"]
        # copies between host and card count as busy; without them
        compute_ms = busy_ms - by_layer.get("copy", 0.0)
        _emit(wall_ms=wall_ms, device_busy_ms=busy_ms,
              device_idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
              device_compute_idle_share=1.0 - compute_ms / wall_ms,
              device_ms_by_layer={k: round(v, 4) for k, v in
                                  sorted(by_layer.items(),
                                         key=lambda kv: -kv[1])},
              top_kernels=[[name[:60], round(t, 4)] for name, t in top],
              cat_kernel_ms=cat_ms, **fields)
        return wall_ms, busy_ms

    # -- training at the reference config ----------------------------------
    _begin("train")
    from liftreg_tpu_torch.main import main as train_main
    from liftreg_tpu_torch.train import RegistrationTrainer
    from liftreg_tpu_torch.utils.checkpoint import load_checkpoint
    os.environ["LIFTREG_NO_TB"] = "1"
    train_root = os.path.abspath(os.path.join("build", "chip_smoke_train"))
    shutil.rmtree(train_root, ignore_errors=True)
    gt = torch.Generator(device=dev).manual_seed(3)
    t0 = time.perf_counter()
    write_train_dataset(torch, F, drr, project_taps,
                        os.path.join(train_root, "data"), SZ, TRAIN_B,
                        TRAIN_VAL, TRAIN_DISTINCT, LATENT, 4, gt, dev)
    write_s = time.perf_counter() - t0
    setting_dir = os.path.join(train_root, "setting")
    os.makedirs(setting_dir)
    with open(os.path.join(setting_dir, "cur_task_setting.json"), "w") as f:
        # main.py sets the data and output paths; the basis path is ours
        json.dump(train_setting(TRAIN_CONFIG, os.path.join(train_root,
                                                           "data"),
                                "[SET_BY_MAIN]", epoch=TRAIN_EPOCHS), f)
    torch.cuda.reset_peak_memory_stats()
    _zero(KERNELS)
    t0 = time.perf_counter()
    tr = train_main(["-o", os.path.join(train_root, "out"), "-d",
                     os.path.join(train_root, "data"), "-e", "reference",
                     "-s", setting_dir])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_launches = _counts(KERNELS)
    run_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    exp = os.path.dirname(tr.check_point_path)
    metrics = read_metrics(exp)
    steps = tr.global_step["train"]
    vals = tr.global_step["val"]
    totals = [metrics["Train/total_loss"][k]
              for k in sorted(metrics["Train/total_loss"])]
    _require(tr.batch_size == TRAIN_B and tr.img_sz == (SZ,) * 3
             and steps == TRAIN_EPOCHS + 1 and len(totals) == steps,
             f"the run took {steps} steps of B={tr.batch_size}")
    _require(all(math.isfinite(v) for tag, vs in metrics.items()
                 if tag.startswith(("Train/", "Val_")) for v in vs.values())
             and all(v == 1.0 for v in metrics["Train/finite"].values()),
             "a non-finite loss or metric in the training run")
    # each step lifts, warps and takes the warp's coordinate gradient once;
    # each validation batch lifts and warps once (its label warp is the
    # plain nearest gather)
    expected_run = dict({k: 0 for k in KERNELS}, drr_backproject=steps + vals,
                        warp_trilinear=steps + vals, warp_coord_grad=steps)
    _require(run_launches == expected_run,
             f"training run launches {run_launches}, expected {expected_run}")
    # resume from the last checkpoint for one more epoch
    last = os.path.join(tr.check_point_path,
                        f"epoch_{TRAIN_EPOCHS}_checkpoint.ckpt")
    saved = load_checkpoint(last)
    with open(os.path.join(exp, "cur_task_setting.json")) as f:
        resume_cfg = json.load(f)
    resume_cfg["train"].update(epoch=TRAIN_EPOCHS + 1, continue_train=True,
                               continue_from=last)
    del tr
    torch.cuda.empty_cache()
    tr = RegistrationTrainer(resume_cfg)
    resumed = {
        "start_epoch": tr.start_epoch, "saved_epoch": int(saved["epoch"]),
        "global_step": dict(tr.global_step),
        "saved_global_step": dict(saved["global_step"]),
        "params_bit_equal": all(torch.equal(p.detach().cpu(),
                                            saved["params"][k])
                                for k, p in tr.params.items()),
        "moments_bit_equal": all(torch.equal(tr.opt_state[m][k].cpu(),
                                             saved["opt_state"][m][k])
                                 for m in ("mu", "nu") for k in tr.params)}
    _require(resumed["start_epoch"] == resumed["saved_epoch"] + 1
             and resumed["global_step"] == resumed["saved_global_step"]
             and resumed["params_bit_equal"]
             and resumed["moments_bit_equal"],
             f"the resumed state is not the saved one: {resumed}")
    tr.run()
    metrics = read_metrics(exp)
    _require(tr.global_step["train"] == steps + 1
             and math.isfinite(metrics["Train/total_loss"][steps + 1]),
             "the resumed epoch did not take one finite step")
    # one train step alone: its launches, then its time (median of
    # TRAIN_TIMED_STEPS after a warm-up) and peak memory
    batch_t, names_t = next(iter(tr._iter_device("train", tr.cur_epoch)))
    torch.cuda.synchronize()
    _zero(KERNELS)
    tr.step(batch_t, names_t)
    torch.cuda.synchronize()
    train_launches = _counts(KERNELS)
    expected_step = dict({k: 0 for k in KERNELS}, drr_backproject=1,
                         warp_trilinear=1, warp_coord_grad=1)
    _require(train_launches == expected_step,
             f"one train step launched {train_launches}")
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        tr.step(batch_t, names_t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_step_ms = statistics.median(step_ms)
    train_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # the run closed its log: read these steps' losses here
    _require(all(bool(l["finite"]) for _, l in tr._pending_losses),
             "a non-finite loss in the timed train steps")
    tr._pending_losses.clear()
    _emit(write_dataset_s=write_s, run_s=run_s, steps=steps,
          val_batches=vals, batch=TRAIN_B, config=TRAIN_CONFIG,
          total_loss_per_step=totals, launches=run_launches,
          step_launches=train_launches, resumed=resumed,
          best_val_score=max(metrics["Val_metrics/score"].values()),
          step_ms=step_ms, step_ms_median=train_step_ms,
          peak_memory_gib=max(run_peak_gib, train_peak_gib),
          run_peak_memory_gib=run_peak_gib)

    def by_rows(fn, batched, *rest, **kw):
        """``fn`` of the ``batched`` tensors taken TRAIN_CHECK_ROWS rows at
        a time, concatenated: the plain versions' temporaries at B = 30
        stay a third of their size beside the trainer"""
        return torch.cat([
            fn(*(t[i:i + TRAIN_CHECK_ROWS] for t in batched), *rest, **kw)
            for i in range(0, batched[0].shape[0], TRAIN_CHECK_ROWS)])

    _begin("train_check")
    # the step's lift, warp and coordinate gradient against their plain
    # versions at its own shapes and values (B = 30, 160^3): the batch's
    # projections, phi of the model's forward, the batch's masked source,
    # a seeded cotangent
    model_t = tr.model
    poses_t = batch_t["target_poses"]
    poses_t = poses_t[0] if poses_t.dim() == 3 else poses_t
    proj_t = batch_t["target_proj"].contiguous()
    geom_t = drr.backward_geometry(poses_t, tr.img_sz, proj_t.shape[2:])
    lift_want = by_rows(backproject_taps_plain, (proj_t,), *geom_t,
                        plane_chunk=model_t.backproject_chunk)
    train_errs, lift_bufs = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        # the encoder's input: the moving CT in channel 0, the lift after it
        lift_bufs[dt] = lift_encoder_input(
            batch_t["source"], proj_t, *geom_t, dtype=dt,
            plane_chunk=model_t.backproject_chunk)
    train_errs["lift_f32_buffer"] = _max_err(lift_bufs[torch.float32][:, 1:],
                                             lift_want)
    # the bf16 buffer holds the f32 lift rounded once
    train_errs["lift_bf16_buffer_bit_equal"] = bool(torch.equal(
        lift_bufs[torch.bfloat16][:, 1:],
        lift_bufs[torch.float32][:, 1:].bfloat16()))
    train_errs["lift_channel0_moving"] = all(
        torch.equal(b[:, :1], batch_t["source"].to(dt))
        for dt, b in lift_bufs.items())
    del lift_bufs, lift_want
    with torch.no_grad():
        phi_t = model_t(batch_t, tr.pca)["phi"]
    moving_t = batch_t["source"]
    if model_t.mask_ct and "source_label" in batch_t:
        moving_t = mask_lung(moving_t, batch_t["source_label"])
    cot_t = torch.randn((TRAIN_B, 1) + tr.img_sz, generator=gt, device=dev)
    flags_t = {"normalized": True, "scale_intensity": True}
    for tdt in (torch.float32, torch.bfloat16):
        key = str(tdt).split(".")[-1]
        tt = resample.warp_taps(moving_t, True, tdt)
        train_errs[f"warp_{key}"] = _max_err(
            warp_trilinear(tt, phi_t, False, **flags_t),
            by_rows(warp_trilinear_plain, (tt, phi_t), False, **flags_t))
        want = by_rows(warp_coord_grad_plain, (tt, phi_t, cot_t), False,
                       **flags_t)
        err = _max_err(warp_coord_grad(tt, phi_t, cot_t, False, **flags_t),
                       want)
        train_errs[f"coord_grad_{key}"] = [err, err / float(want.abs().max())]
        del tt, want
    del phi_t, moving_t, cot_t
    warp_keys = ("warp_float32", "warp_bfloat16")
    grad_keys = ("coord_grad_float32", "coord_grad_bfloat16")
    errs["drr_backproject"] = max(errs["drr_backproject"],
                                  train_errs["lift_f32_buffer"])
    errs["warp_trilinear"] = max(errs["warp_trilinear"],
                                 *(train_errs[k] for k in warp_keys))
    errs["warp_coord_grad"] = max(errs["warp_coord_grad"],
                                  *(train_errs[k][0] for k in grad_keys))
    _emit(max_err=train_errs, batch=TRAIN_B,
          tol={"lift": LIFT_TOL, "warp": WARP_TOL,
               "coord_grad_rel": WARP_GRAD_REL_TOL})
    _require(train_errs["lift_f32_buffer"] <= LIFT_TOL
             and train_errs["lift_bf16_buffer_bit_equal"]
             and train_errs["lift_channel0_moving"],
             f"the lift at the train step's shapes disagrees: {train_errs}")
    _require(all(train_errs[k] <= WARP_TOL for k in warp_keys),
             f"the warp at the train step's shapes disagrees: {train_errs}")
    _require(all(train_errs[k][1] <= WARP_GRAD_REL_TOL for k in grad_keys),
             "the coordinate gradient at the train step's shapes disagrees: "
             f"{train_errs}")

    _begin("train_bf16")
    # configs/fast_train's dtypes (bf16 encoder, basis and taps, the s2d
    # option) at the reference config's batch, latent and shapes
    with open(FAST_TRAIN_CONFIG) as f:
        fast_model = json.load(f)["train"]["model"]
    bf16_keys = ("compute_dtype", "pca_dtype", "warp_taps_dtype",
                 "s2d_encoder")
    bf16_cfg = train_setting(TRAIN_CONFIG, os.path.join(train_root, "data"),
                             os.path.join(train_root, "out_bf16"),
                             epoch=0, debug_on=False)
    bf16_cfg["train"]["model"].update({k: fast_model[k] for k in bf16_keys})
    tr_bf16 = RegistrationTrainer(bf16_cfg)
    _require(tr_bf16.pca["vectors"].dtype == torch.bfloat16,
             "the fast_train basis is not bf16")
    _require(tr_bf16.model.encoder.s2d_stage01,
             "the fast_train model does not run the s2d encoder stages")
    bf16_launches, bf16_ms = [], []
    with counted(s2d, "conv_pair_s2d") as s2d_calls:
        for _ in range(BF16_STEPS):
            _zero(KERNELS)
            t0 = time.perf_counter()
            tr_bf16.step(batch_t, names_t)
            torch.cuda.synchronize()
            bf16_ms.append((time.perf_counter() - t0) * 1e3)
            bf16_launches.append(_counts(KERNELS))
    _require(len(s2d_calls) == BF16_STEPS,
             f"{BF16_STEPS} bf16 steps ran the s2d stages {len(s2d_calls)} "
             "times")
    tr_bf16._flush_losses()
    bf16_totals = read_metrics(os.path.dirname(
        tr_bf16.check_point_path))["Train/total_loss"]
    # the same trainer with its encoder's first two stages plain, timed
    # the same way in this call
    tr_bf16.model.encoder.s2d_stage01 = False
    plain_enc_ms = []
    for _ in range(BF16_STEPS):
        t0 = time.perf_counter()
        tr_bf16.step(batch_t, names_t)
        torch.cuda.synchronize()
        plain_enc_ms.append((time.perf_counter() - t0) * 1e3)
    _require(all(bool(l["finite"]) for _, l in tr_bf16._pending_losses),
             "a non-finite loss in the plain-encoder bf16 steps")
    tr_bf16._pending_losses.clear()
    tr_bf16.model.encoder.s2d_stage01 = True
    chunks = -(-TRAIN_B // MAX_CHUNK)
    expected_bf16 = dict(expected_step, pca_expand=chunks, pca_grad=chunks)
    # the PCA kernels at the step's shapes (B = 30: three launches of 8
    # rows and one of 6): the bf16 model's coefficients on the batch, the
    # bf16 basis, a seeded cotangent
    with torch.no_grad():
        coefs_t = tr_bf16.model(batch_t, tr_bf16.pca)["pca_coefs"]
    coefs_t = coefs_t.float().contiguous()
    V_t, mean_t = tr_bf16.pca["vectors"], tr_bf16.pca["mean"]
    pca_t = {"expand": _max_err(pca_expand(coefs_t, V_t, mean_t),
                                by_rows(pca_expand_plain, (coefs_t,), V_t,
                                        mean_t))}
    cot_pca_t = torch.randn((TRAIN_B, V_t.shape[1]), generator=gt,
                            device=dev)
    want = by_rows(pca_grad_plain, (cot_pca_t,), V_t)
    got = pca_grad(cot_pca_t, V_t)
    V64 = V_t.double()
    exact = by_rows(lambda c: c.double() @ V64.T, (cot_pca_t,))
    del V64
    pca_t["grad"] = _max_err(got, want)
    pca_t["grad_values_unequal_to_plain"] = int((got != want).sum())
    pca_t["grad_f64_excess"] = _f64_excess(torch, got, exact)
    pca_t["plain_f64_excess"] = _f64_excess(torch, want, exact)
    pca_t["grad_bf16_values"] = bool(torch.equal(got, got.bfloat16().float()))
    del coefs_t, cot_pca_t, want, got, exact
    errs["pca_expand"] = max(errs["pca_expand"], pca_t["expand"])
    errs["pca_grad"] = max(errs["pca_grad"], pca_t["grad"])
    _emit(launches_per_step=bf16_launches, step_ms=bf16_ms,
          step_ms_median=statistics.median(bf16_ms[1:]),
          plain_encoder_step_ms=plain_enc_ms,
          plain_encoder_step_ms_median=statistics.median(plain_enc_ms[1:]),
          total_loss_per_step=list(bf16_totals.values()),
          dtypes={k: fast_model[k] for k in bf16_keys},
          pca_max_err=pca_t, pca_tol=PCA_TOL,
          pca_grad_f64_tol={"half_bf16_step": True,
                            "rel_atol": PCA_GRAD_F64_REL_ATOL})
    _require(all(c == expected_bf16 for c in bf16_launches),
             f"bf16 train steps launched {bf16_launches}, expected "
             f"{expected_bf16} each")
    _require(all(math.isfinite(v) for v in bf16_totals.values()),
             "a non-finite bf16 training loss")
    _require(pca_t["expand"] <= PCA_TOL and pca_t["grad_f64_excess"] <= 0
             and pca_t["plain_f64_excess"] <= 0 and pca_t["grad_bf16_values"],
             f"the PCA kernels at the train step's shapes disagree: {pca_t}")
    del tr_bf16, V_t, mean_t
    torch.cuda.empty_cache()

    # -- the encoder's space-to-depth stages --------------------------------
    _begin("s2d")
    s2d_line, tr_s2d = s2d_phase(torch, KERNELS, s2d, tr, batch_t, names_t,
                                 train_root, expected_step,
                                 (pipe, pca, (src_hu, tgt_hu, seg, seg)),
                                 serving)
    _emit(**s2d_line)
    _begin("profile_train_s2d")
    profile_call(lambda: tr_s2d.step(batch_t, names_t), steps=1)
    tr_s2d._pending_losses.clear()
    del tr_s2d
    torch.cuda.empty_cache()

    _begin("profile_train")
    profile_call(lambda: tr.step(batch_t, names_t), steps=1)
    tr._pending_losses.clear()
    # nothing of the training run stays on the card for what follows
    del tr, model_t, batch_t, names_t, proj_t, geom_t, poses_t
    torch.cuda.empty_cache()

    # one epoch of TRAIN_LOADER_STEPS reference steps on the training files
    # listed TRAIN_LOADER_STEPS times, its batches read by the host
    # DataLoader (a thread stacks each batch, the step's thread copies it
    # to the card) and then from the card-resident cache
    import numpy as np
    data_root = os.path.join(train_root, "data")
    train_ids = list(np.load(os.path.join(data_root, "train",
                                          "data_id.npy")))
    val_ids = list(np.load(os.path.join(data_root, "val", "data_id.npy")))
    loader_root = split_root(os.path.join(train_root, "data_loader"),
                             data_root,
                             {"train": train_ids * TRAIN_LOADER_STEPS,
                              "val": val_ids})
    loader_ms = {}
    for cache in (False, True):
        kind = "device" if cache else "host"
        _begin(f"train_{kind}_loader")
        t0 = time.perf_counter()
        tl = RegistrationTrainer(train_setting(
            TRAIN_CONFIG, loader_root,
            os.path.join(train_root, f"out_{kind}_loader"), epoch=0,
            debug_on=False, cache_on_device=cache))
        build_s = time.perf_counter() - t0
        loader = type(tl.loaders["train"]).__name__
        _require(loader == ("DeviceDataLoader" if cache else "DataLoader"),
                 f"cache_on_device={cache} built a {loader}")

        def epoch():
            for batch, names in tl._iter_device("train", 0):
                tl.global_step["train"] += 1
                tl.step(batch, names)

        wall_ms, _ = profile_call(epoch, steps=TRAIN_LOADER_STEPS,
                                  loader=loader, trainer_build_s=build_s)
        loader_ms[kind] = wall_ms / TRAIN_LOADER_STEPS
        tl._flush_losses()
        losses_l = read_metrics(os.path.dirname(
            tl.check_point_path))["Train/total_loss"]
        _require(tl.global_step["train"] == TRAIN_LOADER_STEPS
                 and len(losses_l) == TRAIN_LOADER_STEPS
                 and all(math.isfinite(v) for v in losses_l.values()),
                 f"the {kind} loader's epoch took {tl.global_step['train']} "
                 f"steps with losses {losses_l}")
        del tl, epoch
        torch.cuda.empty_cache()

    # -- the trainer and refinement on a data mesh ---------------------------
    _begin("data_parallel")
    dp = data_parallel(torch, F, dev, data_root, train_ids, val_ids,
                       os.path.join(train_root, "dp"))
    _emit(**dp["line"])

    # -- evaluation of the train phase's experiment ------------------------
    _begin("evaluate")
    from liftreg_tpu_torch.utils import tre
    eval_names = write_eval_split(data_root, SZ, EVAL_CASES, TRAIN_DISTINCT,
                                  EVAL_LANDMARKS, 5)
    # the port's eval CLI, as a user runs it, on the train phase's
    # experiment: test mode from its best checkpoint, then the TRE
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "liftreg_tpu_torch.eval_cli", "-s",
         os.path.join(exp, "cur_task_setting.json")], capture_output=True,
        text=True, timeout=600, env=dict(os.environ, LIFTREG_NO_TB="1"))
    cli_s = time.perf_counter() - t0
    _require(proc.returncode == 0, f"the eval CLI exited {proc.returncode}: "
             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    with open(os.path.join(exp, "evaluate_result.csv")) as f:
        rows = list(csv.DictReader(f))
    tres = [float(r["dist"]) for r in rows]
    dices = [float(r["dice"]) for r in rows]
    no_mpl = importlib.util.find_spec("matplotlib") is None
    mpl_lines = [ln for ln in proc.stdout.splitlines() if "matplotlib" in ln]
    # the identity map's TRE is the landmarks' initial mean distance
    src_pts, tgt_pts = (tre.read_points(
        os.path.join(data_root, "landmarks",
                     f"{eval_names[0]}_300_{k}_xyz_r1.txt"),
        expect_count=EVAL_LANDMARKS) for k in ("iBH", "eBH"))
    spacing = np.full(3, 2.2)
    identity_tre = tre.eval_with_data(
        src_pts, tgt_pts, tre.create_identity((SZ,) * 3)[None],
        np.full(3, float(SZ)), spacing, np.zeros(3), spacing)[0]
    initial = float(np.mean(np.linalg.norm((tgt_pts - src_pts) * spacing,
                                           axis=1)))
    # the Dice's nearest warp on the card and on the CPU
    phi01 = np.load(os.path.join(exp, "tests", f"{eval_names[0]}_phi.npy"))
    segs = [np.load(os.path.join(data_root, "preprocessed",
                                 f"{eval_names[0]}_{side}_seg.npy"))
            for side in ("source", "target")]
    dice_dev = {where: tre.warped_seg_dice(*segs, phi01, device=where)
                for where in ("cuda", "cpu")}
    _emit(cli_s=cli_s, cases=len(rows), tre_mm=tres, dice=dices,
          matplotlib_absent=no_mpl, matplotlib_lines=mpl_lines,
          identity_tre=identity_tre, initial_distance=initial,
          dice_card_cpu=dice_dev, cli_stdout_tail=proc.stdout[-600:])
    _require(sorted(r["id"] for r in rows) == eval_names,
             f"evaluate_result.csv rows {[r['id'] for r in rows]}")
    _require(all(math.isfinite(t) for t in tres)
             and all(0.0 <= d <= 1.0 for d in dices),
             f"TRE {tres} or Dice {dices} out of range")
    _require(len(mpl_lines) == int(no_mpl),
             f"the matplotlib line: {mpl_lines} (absent: {no_mpl})")
    _require(abs(identity_tre - initial) <= 1e-5 * initial,
             f"the identity's TRE {identity_tre} is not the initial "
             f"distance {initial}")
    _require(dice_dev["cuda"] == dice_dev["cpu"],
             f"the Dice's warp differs between card and CPU: {dice_dev}")

    # -- training against the CPU at 32^3 ----------------------------------
    _begin("train_reference")
    ref_root = os.path.join(train_root, "small")
    write_train_dataset(torch, F, drr, project_taps,
                        os.path.join(ref_root, "data"), 32, 4, 1, 2, 8, 4,
                        torch.Generator(device=dev).manual_seed(4), dev)

    def ref_trainer(where, out, init=None, regnet=False):
        data = os.path.join(ref_root, "data")
        if regnet:
            cfg = regnet_setting(data, os.path.join(ref_root, out), epoch=0)
        else:
            cfg = train_setting(TRAIN_CONFIG, data,
                                os.path.join(ref_root, out), epoch=0,
                                debug_on=False)
            cfg["train"]["dataloader"]["batch_size"] = 2
            cfg["train"]["model"]["latent_dim"] = 8
        cfg["dataset"]["img_after_resize"] = [32, 32, 32]
        if init is not None:
            cfg["train"]["init_params_from"] = init
        return RegistrationTrainer(cfg, device=where)

    def two_steps(rt):
        """The losses of 2 train steps, each step's Adam moments (the
        first step's mu is 0.1 g, its nu 0.001 g^2) and the parameters
        after them, on the CPU."""
        losses, moments = [], []
        for b, names in list(rt._iter_device("train", 0))[:2]:
            step = rt._train_step(b, rt.loss.factor(0), len(names))
            losses.append({k: float(v) for k, v in step.items()})
            moments.append({m: {k: v.to("cpu", copy=True) for k, v in
                                rt.opt_state[m].items()}
                            for m in ("mu", "nu")})
        return (losses, moments,
                {k: p.detach().cpu() for k, p in rt.params.items()})

    def moments_rel(got, want):
        """{leaf: the largest, over steps and moments, of its max abs error
        over its largest value}"""
        worst = {}
        for g_step, w_step in zip(got, want):
            for m, leaves in w_step.items():
                for k, w in leaves.items():
                    err = _max_err(g_step[m][k], w)
                    scale = float(w.abs().max())
                    worst[k] = max(worst.get(k, 0.0),
                                   err / scale if scale > 0 else err)
        return worst

    def card_against_cpu(regnet, doubled_kernel):
        """2 train steps on the card against the same steps on the CPU from
        the same parameters, then again with the card's ``doubled_kernel``
        (a wrapper of warp_kernel that the warp's backward calls, replaced
        for that run only) doubled: the check's power. Returns the errors
        of each run: losses, parameters, moments by leaf."""
        tag = "regnet_" if regnet else ""
        cpu_tr = ref_trainer("cpu", tag + "cpu", regnet=regnet)
        init_ckpt = cpu_tr.save_model("init", is_best=False)
        ref_out = {"cpu": two_steps(cpu_tr)}
        del cpu_tr
        ref_out["cuda"] = two_steps(ref_trainer("cuda", tag + "cuda",
                                                init_ckpt, regnet))
        kernel = getattr(warp_kernel, doubled_kernel)

        def doubled(*args, **kwargs):
            return kernel(*args, **kwargs) * 2.0

        # the wrapper counts its launches on the module's name: here
        # doubled's
        doubled.launches = 0
        setattr(warp_kernel, doubled_kernel, doubled)
        try:
            ref_out["cuda_doubled"] = two_steps(
                ref_trainer("cuda", tag + "cuda_doubled", init_ckpt, regnet))
        finally:
            setattr(warp_kernel, doubled_kernel, kernel)
        init_params = load_checkpoint(init_ckpt)["params"]
        ref_errs = {}
        for run in ("cuda", "cuda_doubled"):
            losses_r, moments_r, params_r = ref_out[run]
            ref_errs[run] = {
                "losses": max(abs(a[k] - b[k])
                              for a, b in zip(losses_r, ref_out["cpu"][0])
                              for k in ("total_loss", "sim_loss",
                                        "reg_loss")),
                "params": max(_max_err(params_r[k], p)
                              for k, p in ref_out["cpu"][2].items()),
                "moments_rel_by_leaf": moments_rel(moments_r,
                                                   ref_out["cpu"][1])}
            ref_errs[run]["moments_rel"] = max(
                ref_errs[run]["moments_rel_by_leaf"].values())
        ref_errs["params_moved"] = max(_max_err(ref_out["cpu"][2][k], v)
                                       for k, v in init_params.items())
        _emit(max_err=ref_errs, tol=TRAIN_REF_TOL,
              moments_rtol=TRAIN_MOMENT_RTOL, doubled=doubled_kernel,
              losses_cpu=ref_out["cpu"][0])
        ok = ref_errs["cuda"]
        _require(ok["losses"] <= TRAIN_REF_TOL
                 and ok["params"] <= TRAIN_REF_TOL
                 and ok["moments_rel"] <= TRAIN_MOMENT_RTOL
                 and ref_errs["params_moved"] > 10 * TRAIN_REF_TOL,
                 f"training on the card disagrees with the CPU: {ref_errs}")
        _require(ref_errs["cuda_doubled"]["moments_rel"] > TRAIN_MOMENT_RTOL,
                 f"the moments' check does not see a doubled "
                 f"{doubled_kernel}: {ref_errs}")

    card_against_cpu(False, "warp_coord_grad")
    _begin("regnet_reference")
    card_against_cpu(True, "warp_image_grad")

    # -- LiftRegSubspace at the reference config ---------------------------
    _begin("subspace_train")
    from liftreg_tpu_torch.models import LiftRegSubspace
    sub_root = split_root(os.path.join(train_root, "data_subspace"),
                          data_root, {"train": train_ids * SUBSPACE_STEPS,
                                      "val": val_ids})
    sub_dir = os.path.join(train_root, "setting_subspace")
    os.makedirs(sub_dir)
    with open(os.path.join(sub_dir, "cur_task_setting.json"), "w") as f:
        json.dump(train_setting(TRAIN_CONFIG, sub_root, "[SET_BY_MAIN]",
                                epoch=0, debug_on=False,
                                model_class="subspace"), f)
    torch.cuda.reset_peak_memory_stats()
    _zero(KERNELS)
    tr_sub = train_main(["-o", os.path.join(train_root, "out"), "-d",
                         sub_root, "-e", "subspace", "-s", sub_dir])
    torch.cuda.synchronize()
    sub_run_launches = _counts(KERNELS)
    sub_steps, sub_vals = tr_sub.global_step["train"], tr_sub.global_step["val"]
    sub_totals = read_metrics(os.path.dirname(tr_sub.check_point_path))[
        "Train/total_loss"]
    _require(type(tr_sub.model).__name__ == "LiftRegSubspace"
             and tr_sub.batch_size == TRAIN_B and sub_steps == SUBSPACE_STEPS
             and len(sub_totals) == sub_steps
             and all(math.isfinite(v) for v in sub_totals.values()),
             f"LiftRegSubspace took {sub_steps} steps, losses {sub_totals}")
    # each step warps and takes the coordinate gradient once, each
    # validation batch warps once; no lift, no image gradient
    expected_sub = dict({k: 0 for k in KERNELS},
                        warp_trilinear=sub_steps + sub_vals,
                        warp_coord_grad=sub_steps)
    _require(sub_run_launches == expected_sub,
             f"LiftRegSubspace's run launched {sub_run_launches}, expected "
             f"{expected_sub}")
    batch_s, names_s = next(iter(tr_sub._iter_device("train", 0)))
    torch.cuda.synchronize()
    _zero(KERNELS)
    tr_sub.step(batch_s, names_s)
    torch.cuda.synchronize()
    subspace_launches = _counts(KERNELS)
    _require(subspace_launches == dict({k: 0 for k in KERNELS},
                                       warp_trilinear=1, warp_coord_grad=1),
             f"one LiftRegSubspace step launched {subspace_launches}")
    sub_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        tr_sub.step(batch_s, names_s)
        torch.cuda.synchronize()
        sub_ms.append((time.perf_counter() - t0) * 1e3)
    subspace_step_ms = statistics.median(sub_ms)
    subspace_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    _require(all(bool(l["finite"]) for _, l in tr_sub._pending_losses),
             "a non-finite loss in the timed LiftRegSubspace steps")
    tr_sub._pending_losses.clear()
    del tr_sub, batch_s, names_s
    torch.cuda.empty_cache()
    # its forward on the card against the CPU at 32^3
    gs = torch.Generator().manual_seed(6)
    small_in = {"source": torch.rand((2, 1) + (32,) * 3, generator=gs) * 2 - 1,
                "target": torch.rand((2, 1) + (32,) * 3, generator=gs) * 2 - 1,
                "target_proj": torch.rand((2, 4, 48, 48), generator=gs) * 2
                - 1}
    small_in["source_label"] = (torch.rand(small_in["source"].shape,
                                           generator=gs) > 0.3).float()
    small_in["target_label"] = small_in["source_label"].flip(2)
    small_pca = {"vectors": torch.randn((8, 3 * 32 ** 3), generator=gs)
                 * 0.01, "mean": torch.zeros(3 * 32 ** 3)}
    torch.manual_seed(6)
    sub_cpu = LiftRegSubspace((32,) * 3, latent_dim=8)
    sub_card = LiftRegSubspace((32,) * 3, latent_dim=8).to(dev)
    sub_card.load_state_dict(sub_cpu.state_dict())
    with torch.no_grad():
        want_s = sub_cpu(small_in, small_pca)
        got_s = sub_card({k: v.to(dev) for k, v in small_in.items()},
                         {k: v.to(dev) for k, v in small_pca.items()})
    sub_ref = {k: _max_err(got_s[k].cpu(), want_s[k])
               for k in ("phi", "warped")}
    _emit(run_launches=sub_run_launches, step_launches=subspace_launches,
          total_loss_per_step=list(sub_totals.values()), step_ms=sub_ms,
          step_ms_median=subspace_step_ms, peak_memory_gib=subspace_peak_gib,
          batch=TRAIN_B, card_vs_cpu_32=sub_ref, tol=REF_F32_TOL)
    _require(sub_ref["phi"] <= REF_F32_TOL[0]
             and sub_ref["warped"] <= REF_F32_TOL[1],
             f"LiftRegSubspace on the card disagrees with the CPU: {sub_ref}")
    del sub_cpu, sub_card, got_s, want_s

    # -- RegNet2D3D at the learned-basis workflow's stage-1 config ---------
    _begin("regnet_train")
    rn_root = split_root(os.path.join(train_root, "data_regnet"), data_root,
                         {"train": train_ids[:REGNET_STEPS],
                          "val": val_ids[:1]})
    rn_dir = os.path.join(train_root, "setting_regnet")
    os.makedirs(rn_dir)
    with open(os.path.join(rn_dir, "cur_task_setting.json"), "w") as f:
        json.dump(regnet_setting(rn_root, "[SET_BY_MAIN]", epoch=0), f)
    torch.cuda.reset_peak_memory_stats()
    _zero(KERNELS)
    t0 = time.perf_counter()
    tr_rn = train_main(["-o", os.path.join(train_root, "out"), "-d", rn_root,
                        "-e", "regnet", "-s", rn_dir])
    torch.cuda.synchronize()
    rn_run_s = time.perf_counter() - t0
    rn_run_launches = _counts(KERNELS)
    rn_steps, rn_vals = tr_rn.global_step["train"], tr_rn.global_step["val"]
    rn_exp = os.path.dirname(tr_rn.check_point_path)
    rn_metrics = read_metrics(rn_exp)
    rn_totals = [rn_metrics["Train/total_loss"][k]
                 for k in sorted(rn_metrics["Train/total_loss"])]
    _require(type(tr_rn.model).__name__ == "RegNet2D3D"
             and tr_rn.img_sz == (SZ,) * 3 and tr_rn.batch_size == 1
             and rn_steps == REGNET_STEPS and len(rn_totals) == rn_steps
             and rn_vals == 1,
             f"RegNet2D3D took {rn_steps} steps and {rn_vals} validations")
    _require(all(math.isfinite(v) for tag, vs in rn_metrics.items()
                 if tag.startswith(("Train/", "Val_")) for v in vs.values()),
             "a non-finite loss or metric in RegNet2D3D's run")
    _require(all(os.path.isfile(os.path.join(tr_rn.check_point_path, c))
                 for c in ("model_best.ckpt", "latest_checkpoint.ckpt")),
             "RegNet2D3D's run wrote no checkpoint")
    expected_rn = {k: rn_steps * REGNET_STEP_LAUNCHES.get(k, 0)
                   + rn_vals * REGNET_VAL_LAUNCHES.get(k, 0) for k in KERNELS}
    _require(rn_run_launches == expected_rn,
             f"RegNet2D3D's run launched {rn_run_launches}, expected "
             f"{expected_rn}")
    batch_rn, names_rn = next(iter(tr_rn._iter_device("train",
                                                      tr_rn.cur_epoch)))
    torch.cuda.synchronize()
    _zero(KERNELS)
    tr_rn.step(batch_rn, names_rn)
    torch.cuda.synchronize()
    regnet_launches = _counts(KERNELS)
    _require(regnet_launches == dict({k: 0 for k in KERNELS},
                                     **REGNET_STEP_LAUNCHES),
             f"one RegNet2D3D step launched {regnet_launches}, expected "
             f"{REGNET_STEP_LAUNCHES}")
    tr_rn.step(batch_rn, names_rn)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rn_ms = []
    for _ in range(REGNET_TIMED_STEPS):
        t0 = time.perf_counter()
        tr_rn.step(batch_rn, names_rn)
        torch.cuda.synchronize()
        rn_ms.append((time.perf_counter() - t0) * 1e3)
    regnet_step_ms = statistics.median(rn_ms)
    regnet_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    _require(all(bool(l["finite"]) for _, l in tr_rn._pending_losses),
             "a non-finite loss in the timed RegNet2D3D steps")
    tr_rn._pending_losses.clear()
    _emit(run_s=rn_run_s, steps=rn_steps, val_batches=rn_vals,
          total_loss_per_step=rn_totals, launches=rn_run_launches,
          step_launches=regnet_launches, step_ms=rn_ms,
          step_ms_median=regnet_step_ms, peak_memory_gib=regnet_peak_gib)

    _begin("regnet_check")
    # the image and coordinate gradients at the step's own shapes and
    # values: the model's disp and warped at idm + disp_inv, and the
    # attenuation at phi
    from liftreg_tpu_torch.coords import identity_map
    with torch.no_grad():
        out_rn = tr_rn.model(batch_rn)
    disp_rn, disp_inv_rn = out_rn["params"]
    inv_pts = (identity_map((SZ,) * 3, device=dev)[None]
               + disp_inv_rn).contiguous()
    flags_rn = {"normalized": True, "scale_intensity": False}
    rn_errs, overflow_shares = {}, {}
    for name, taps_rn, pts_rn in (
            ("disp", disp_rn, inv_pts), ("warped", out_rn["warped"], inv_pts),
            ("attenuation", batch_rn["original_source"], out_rn["phi"])):
        taps_rn, pts_rn = taps_rn.contiguous(), pts_rn.contiguous()
        cot_rn = torch.randn(taps_rn.shape, generator=g, device=dev)
        if name != "attenuation":
            rn_errs[f"image_grad/{name}"] = image_grad_errs(
                warp_image_grad, warp_image_grad_plain, taps_rn, pts_rn,
                cot_rn, False, **flags_rn)
            overflow.zero_()
            warp_image_grad(taps_rn, pts_rn, cot_rn, False, **flags_rn)
            overflow_shares[f"regnet_{name}"] = int(overflow) / (
                taps_rn.shape[0] * pts_rn[0, 0].numel())
        want = warp_coord_grad_plain(taps_rn, pts_rn, cot_rn, False,
                                     **flags_rn)
        err = _max_err(warp_coord_grad(taps_rn, pts_rn, cot_rn, False,
                                       **flags_rn), want)
        rn_errs[f"coord_grad/{name}"] = [err, err / float(want.abs().max())]
        del want
    img_keys = [k for k in rn_errs if k.startswith("image_grad")]
    crd_keys = [k for k in rn_errs if k.startswith("coord_grad")]
    errs["warp_image_grad"] = max(errs["warp_image_grad"],
                                  *(rn_errs[k]["max_abs_err"]
                                    for k in img_keys))
    errs["warp_coord_grad"] = max(errs["warp_coord_grad"],
                                  *(rn_errs[k][0] for k in crd_keys))
    _emit(max_err=rn_errs, tol={"image_grad_rel": IMG_GRAD_REL_TOL,
                                "image_grad_of_terms": IMG_GRAD_MAG_TOL,
                                "coord_grad_rel": WARP_GRAD_REL_TOL},
          disp_max=float(disp_rn.abs().max()),
          disp_inv_max=float(disp_inv_rn.abs().max()))
    _require(all(rn_errs[k]["excess"] <= 0 and rn_errs[k]["repeat_excess"]
                 <= 0 for k in img_keys)
             and all(rn_errs[k][1] <= WARP_GRAD_REL_TOL for k in crd_keys),
             f"the warp's gradients at RegNet2D3D's step disagree: {rn_errs}")
    del out_rn, disp_rn, disp_inv_rn, inv_pts

    _begin("profile_regnet")
    profile_call(lambda: tr_rn.step(batch_rn, names_rn), steps=1,
                 totals=("warp_image_grad",))
    tr_rn._pending_losses.clear()
    del tr_rn, batch_rn, names_rn
    torch.cuda.empty_cache()
    shutil.rmtree(train_root, ignore_errors=True)

    # -- times -------------------------------------------------------------
    _begin("times")
    ms, plain_ms, lib_ms, image_grad_fields = {}, {}, {}, {}
    coefs_bf16 = coefs.to(torch.bfloat16)
    ms["pca_expand"] = _cuda_ms(lambda: pca_expand(coefs, V, mean), 20)
    plain_ms["pca_expand"] = _cuda_ms(
        lambda: pca_expand_plain(coefs, V, mean), 5)
    lib_ms["pca_expand"] = _cuda_ms(lambda: torch.addmm(
        mean, coefs_bf16, V, out_dtype=torch.float32), 20)

    ms["pca_grad"] = _cuda_ms(lambda: pca_grad(cot_pca, V), 20)
    plain_ms["pca_grad"] = _cuda_ms(lambda: pca_grad_plain(cot_pca, V), 5)
    # one cuBLAS call of the same product; it rounds g to bf16 first
    cot_bf16 = cot_pca.bfloat16()
    lib_ms["pca_grad"] = _cuda_ms(lambda: torch.mm(
        cot_bf16, V.T, out_dtype=torch.float32), 20)

    t16 = taps[torch.bfloat16]
    t32 = taps[torch.float32]
    # the same points in phi's layout, and the cotangent of warp_image's
    # (B, 1, D, W, H) output
    phi = _phi_of(coords, SZ)
    cot5 = cot.reshape(B, 1, SZ, SZ, SZ)
    # both warp kernels in both layouts with both tap types; the main path
    # runs phi with bf16 taps and scale_intensity
    layout_ms = {"warp_trilinear": {}, "warp_coord_grad": {}}
    for tname, tt in (("bf16", t16), ("f32", t32)):
        layout_ms["warp_trilinear"][f"phi_{tname}"] = _cuda_ms(
            lambda: warp_trilinear(tt, phi, False, normalized=True,
                                   scale_intensity=True), 20)
        layout_ms["warp_trilinear"][f"pixel_{tname}"] = _cuda_ms(
            lambda: warp_trilinear(tt, coords, False), 20)
        layout_ms["warp_coord_grad"][f"phi_{tname}"] = _cuda_ms(
            lambda: warp_coord_grad(tt, phi, cot5, False, normalized=True,
                                    scale_intensity=True), 20)
        layout_ms["warp_coord_grad"][f"pixel_{tname}"] = _cuda_ms(
            lambda: warp_coord_grad(tt, coords, cot, False), 20)
    ms["warp_trilinear"] = layout_ms["warp_trilinear"]["phi_bf16"]
    plain_ms["warp_trilinear"] = _cuda_ms(
        lambda: warp_trilinear_plain(t16, phi, False, normalized=True,
                                     scale_intensity=True), 3)
    # torch's grid_sample on f32 taps, its (B, D, W, H, 3) grid in its own
    # (x, y, z) order and [-1, 1] units built outside the timed calls: the
    # yardstick of the f32-tap times
    scale = torch.tensor([2.0 / (SZ - 1)] * 3, device=dev)
    grid = (coords * scale - 1.0).flip(-1).reshape(B, SZ, SZ, SZ, 3)
    lib_ms["warp_trilinear"] = _cuda_ms(lambda: F.grid_sample(
        t32, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), 10)

    ms["warp_coord_grad"] = layout_ms["warp_coord_grad"]["phi_bf16"]
    plain_ms["warp_coord_grad"] = _cuda_ms(
        lambda: warp_coord_grad_plain(t16, phi, cot5, False, normalized=True,
                                      scale_intensity=True), 3)
    lib_ms["warp_coord_grad"] = _cuda_ms(
        lambda: torch.ops.aten.grid_sampler_3d_backward(
            cot5, t32, grid, 0, 0, True, [False, True]), 10)

    # the image gradient at RegNet2D3D's shape (C = 3, 160^3, B = 1; phi
    # layout, zeros padding, no rescale); its library call is the input
    # gradient of grid_sampler_3d_backward on f32 taps, its grid in torch's
    # (x, y, z) order built outside the timed calls
    ig_vol = torch.zeros((1, 3) + (SZ,) * 3, device=dev)
    ig_phi = _phi_of(_smooth_coords(torch, F, g, 1, SZ, 4.0, dev), SZ)
    ig_cot = torch.randn((1, 3) + (SZ,) * 3, generator=g, device=dev)
    ig_flags = {"normalized": True, "scale_intensity": False}
    overflow.zero_()
    warp_image_grad(ig_vol, ig_phi, ig_cot, False, **ig_flags)
    overflow_shares["timed"] = int(overflow) / ig_cot[0, 0].numel()
    ms["warp_image_grad"] = _cuda_ms(lambda: warp_image_grad(
        ig_vol, ig_phi, ig_cot, False, **ig_flags), 20)
    plain_ms["warp_image_grad"] = _cuda_ms(lambda: warp_image_grad_plain(
        ig_vol, ig_phi, ig_cot, False, **ig_flags), 3)
    ig_grid = ig_phi.movedim(1, -1).flip(-1).contiguous()
    lib_ms["warp_image_grad"] = _cuda_ms(
        lambda: torch.ops.aten.grid_sampler_3d_backward(
            ig_cot, ig_vol, ig_grid, 0, 0, True, [True, False]), 10)
    # and at fields like RegNet2D3D's inverse iteration: the identity (its
    # first step) and a smooth field of up to 0.9 voxels
    for name, amp in (("identity", 0.0), ("near_identity", 0.9)):
        near = _near_identity_phi(torch, F, g, 1, SZ, amp, dev)
        overflow.zero_()
        warp_image_grad(ig_vol, near, ig_cot, False, **ig_flags)
        overflow_shares[name] = int(overflow) / ig_cot[0, 0].numel()
        image_grad_fields[name] = {
            "ms": _cuda_ms(lambda: warp_image_grad(
                ig_vol, near, ig_cot, False, **ig_flags), 20),
            "library_ms": _cuda_ms(
                lambda: torch.ops.aten.grid_sampler_3d_backward(
                    ig_cot, ig_vol, near.movedim(1, -1).flip(-1).contiguous(),
                    0, 0, True, [True, False]), 10)}
        del near
    ig_points = ig_phi.numel() // 3
    ig_bytes = (ig_phi.numel() + ig_cot.numel() + ig_vol.numel()) * 4
    ig_ops = (IMG_GRAD_OPS_PER_POINT + WARP_PHI_OPS
              + IMG_GRAD_OPS_PER_TERM * 8 * 3) * ig_points
    # the same with bf16 taps (the kernel's f32 sums, cast to bf16 once),
    # beside the library call on f32 taps above; its output is bf16
    ig_vol16 = ig_vol.to(torch.bfloat16)
    ig16_bytes = ig_bytes - ig_vol.numel() * 2
    image_grad_bf16 = {
        "ms": _cuda_ms(lambda: warp_image_grad(
            ig_vol16, ig_phi, ig_cot, False, **ig_flags), 20),
        "plain_ms": _cuda_ms(lambda: warp_image_grad_plain(
            ig_vol16, ig_phi, ig_cot, False, **ig_flags), 3),
        "bound_ms": max(ig16_bytes / HBM_BYTES_PER_S,
                        ig_ops / PEAK_F32_FLOPS) * 1e3,
        "bound_by": ("bytes" if ig16_bytes / HBM_BYTES_PER_S
                     >= ig_ops / PEAK_F32_FLOPS else "operations"),
        "library_f32_ms": lib_ms["warp_image_grad"]}
    del ig_vol, ig_vol16, ig_phi, ig_cot, ig_grid

    ms["drr_project"] = _cuda_ms(lambda: project_taps(att, *fwd_geom), 20)
    plain_ms["drr_project"] = _cuda_ms(
        lambda: project_taps_plain(att, *fwd_geom), 5)
    Rx, Rz, dx = drr.forward_matrices(pipe_poses, (SZ,) * 3, res,
                                      (2.2, 2.2, 2.2))
    lib_ms["drr_project"] = _cuda_ms(
        lambda: drr.project_with_mats(att, Rx, Rz, dx), 5)
    # the adjoint of the projector on the cotangent of its output; its
    # library call is the f32 torch.matmul chain of the transposed products
    # on the dense matrices, built outside the timed calls
    # with the plan built once, as the projection refiner passes it
    cot_proj = torch.randn((B, 4) + res, generator=g, device=dev)
    adj_plan = project_adjoint_plan(fwd_geom[0], fwd_geom[1], (SZ,) * 3)
    ms["drr_project_adjoint"] = _cuda_ms(
        lambda: project_adjoint_taps(cot_proj, *fwd_geom, (SZ,) * 3,
                                     plan=adj_plan), 20)
    plain_ms["drr_project_adjoint"] = _cuda_ms(
        lambda: project_adjoint_taps_plain(cot_proj, *fwd_geom, (SZ,) * 3),
        5)
    lib_ms["drr_project_adjoint"] = _cuda_ms(
        lambda: drr.project_adjoint_with_mats(cot_proj, Rx, Rz, dx), 5)
    del Rx, Rz
    # the plan: no single PyTorch call computes it
    ms["drr_adjoint_plan"] = _cuda_ms(
        lambda: project_adjoint_plan(fwd_geom[0], fwd_geom[1], (SZ,) * 3), 20)
    plain_ms["drr_adjoint_plan"] = _cuda_ms(
        lambda: project_adjoint_plan_plain(fwd_geom[0], fwd_geom[1],
                                           (SZ,) * 3), 5)
    lib_ms["drr_adjoint_plan"] = None
    ms["drr_backproject"] = _cuda_ms(
        lambda: backproject_taps(proj_in, *bwd_geom), 20)
    # the serving path's variant: the encoder's bf16 input buffer, the
    # moving CT in channel 0 and the lift after it
    lift_bf16_ms = _cuda_ms(lambda: lift_encoder_input(
        lift_moving, proj_in, *bwd_geom, dtype=torch.bfloat16), 20)
    plain_ms["drr_backproject"] = _cuda_ms(
        lambda: backproject_taps_plain(proj_in, *bwd_geom), 5)
    Bu, Bv = drr.backward_matrices(pipe_poses, (SZ,) * 3, res)
    lib_ms["drr_backproject"] = _cuda_ms(
        lambda: drr.backproject_with_mats(proj_in, Bu, Bv), 5)
    # the serving path's variant as library calls: the same f32 chain
    # after the moving CT, cast once to bf16
    lift_bf16_lib_ms = _cuda_ms(lambda: torch.cat(
        [lift_moving, drr.backproject_with_mats(proj_in, Bu, Bv)],
        dim=1).bfloat16(), 5)
    del Bu, Bv

    M = coords.shape[1]
    nbytes = {
        "pca_expand": coefs.numel() * 4 + V.numel() * 2 + mean.numel() * 4
        + B * n * 4,
        "pca_grad": cot_pca.numel() * 4 + V.numel() * 2 + B * LATENT * 4,
        "warp_trilinear": t16.numel() * 2 + phi.numel() * 4 + B * M * 4,
        "warp_coord_grad": t16.numel() * 2 + phi.numel() * 4
        + cot.numel() * 4 + phi.numel() * 4,
        "drr_project": att.numel() * 4 + sum(t.numel() * 4 for t in fwd_geom)
        + B * 4 * res[0] * res[1] * 4,
        "drr_project_adjoint": cot_proj.numel() * 4
        + sum(t.numel() * 4 for t in fwd_geom) + B * SZ ** 3 * 4,
        "drr_adjoint_plan": (fwd_geom[0].numel() + fwd_geom[1].numel()) * 4
        + adj_plan.numel() * 4,
        "drr_backproject": proj_in.numel() * 4
        + sum(t.numel() * 4 for t in bwd_geom) + B * 4 * SZ ** 3 * 4,
        # phi, the cotangent and dtaps (the wrapper's zero fill is beyond)
        "warp_image_grad": ig_bytes,
    }
    ops = {
        "pca_expand": (2 * B * LATENT * n, PEAK_BF16_FLOPS),
        "pca_grad": (2 * B * LATENT * n, PEAK_F32_FLOPS),
        "warp_trilinear": ((WARP_OPS_PER_OUTPUT + WARP_PHI_OPS) * B * M,
                           PEAK_F32_FLOPS),
        "warp_coord_grad": ((WARP_GRAD_OPS_PER_OUTPUT + WARP_GRAD_PHI_OPS)
                            * B * M, PEAK_F32_FLOPS),
        "drr_project": (DRR_OPS_PER_TWO_TAPS * B * 4 * SZ * res[0]
                        * (SZ + res[1]), PEAK_F32_FLOPS),
        # the transposed passes: each pixel's two z taps, then each
        # (row, column) value's two x taps
        "drr_project_adjoint": (DRR_OPS_PER_TWO_TAPS * B * 4 * SZ * res[0]
                                * (res[1] + SZ), PEAK_F32_FLOPS),
        "drr_backproject": (DRR_OPS_PER_TWO_TAPS * B * 4 * SZ * SZ
                            * (res[1] + SZ), PEAK_F32_FLOPS),
        # each geometry row's order (two comparisons a pixel), and per
        # voxel index two binary searches over its row
        "drr_adjoint_plan": (
            2 * (fwd_geom[0].numel() + fwd_geom[1].numel())
            + PLAN_OPS_PER_STEP * 2 * 4 * SZ
            * (SZ * math.ceil(math.log2(res[0] + 1))
               + SZ * math.ceil(math.log2(res[1] + 1))), PEAK_F32_FLOPS),
        "warp_image_grad": (ig_ops, PEAK_F32_FLOPS),
    }
    # the bound of each layout and tap type: the f32 taps move 33 MB more
    layout_times = {
        name: {key: {"ms": t_ms, "bound_ms": (
            nbytes[name] + (t16.numel() * 2 if key.endswith("f32") else 0))
            / HBM_BYTES_PER_S * 1e3} for key, t_ms in times.items()}
        for name, times in layout_ms.items()}
    del vol01, taps, t16, t32, coords, int_coords, grid, cot, cot5, cot_pca
    del phi
    # the lift's output in bf16, and the moving CT read (f32) and written
    # (bf16) into channel 0
    lift_bf16_bytes = nbytes["drr_backproject"] - B * 4 * SZ ** 3 * 2 \
        + B * SZ ** 3 * 6
    lift_bf16 = {"ms": lift_bf16_ms,
                 "bound_ms": lift_bf16_bytes / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "library_ms": lift_bf16_lib_ms}
    del cot_bf16, att, proj_in, lift_buf, lift_moving, cot_proj, adj_plan
    torch.cuda.empty_cache()

    def steady(p, pca_, args_, iters):
        for _ in range(2):
            p.register(pca_, *args_)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            p.register(pca_, *args_)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / iters,
                torch.cuda.max_memory_allocated() / 2 ** 30)

    register_ms, peak_gib = steady(pipe, pca, (src_hu, tgt_hu, seg, seg), 5)
    r_args = (r_src, r_tgt, r_seg, r_seg)
    refine_ms, refine_peak = steady(pipe_r, r_pca, r_args, 3)
    proj_ms, proj_peak = steady(pipe_p, r_pca, r_args, 3)
    pipe_l = RegistrationPipeline((SZ,) * 3, latent_dim=LATENT,
                                  compute_dtype=torch.bfloat16,
                                  refine_steps=REFINE_STEPS,
                                  refine_sim="lncc",
                                  refine_sim_opts=LNCC_OPTS)
    pipe_l.model.load_state_dict(pipe.model.state_dict())
    lncc_ms, lncc_peak = steady(pipe_l, r_pca, r_args, 3)
    lncc_hist = pipe_l.last_refine["total_history"]
    del pipe_l

    def per_step(t_ms):
        return (t_ms - register_ms) / (REFINE_STEPS + 1)

    _emit(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          image_grad_fields=image_grad_fields,
          image_grad_bf16_taps=image_grad_bf16,
          warp_layouts=layout_times, lift_bf16_buffer=lift_bf16,
          register_ms=register_ms, register_per_s=B * 1e3 / register_ms,
          peak_memory_gib=peak_gib, register_refine_ms=refine_ms,
          register_refine_per_s=B * 1e3 / refine_ms,
          refine_ms_per_step=per_step(refine_ms),
          refine_peak_memory_gib=refine_peak,
          register_refine_projection_ms=proj_ms,
          register_refine_projection_per_s=B * 1e3 / proj_ms,
          refine_projection_ms_per_step=per_step(proj_ms),
          refine_projection_peak_memory_gib=proj_peak,
          register_refine_lncc_ms=lncc_ms,
          register_refine_lncc_per_s=B * 1e3 / lncc_ms,
          refine_lncc_ms_per_step=per_step(lncc_ms),
          refine_lncc_peak_memory_gib=lncc_peak, lncc_opts=LNCC_OPTS,
          lncc_total_history_first_last=[float(lncc_hist[0]),
                                         float(lncc_hist[-1])],
          batch=B, refine_steps=REFINE_STEPS,
          train_step_ms=train_step_ms, train_batch=TRAIN_B,
          train_cases_per_s=TRAIN_B * 1e3 / train_step_ms,
          train_peak_memory_gib=train_peak_gib,
          train_bf16_step_ms=statistics.median(bf16_ms[1:]),
          regnet_step_ms=regnet_step_ms, regnet_batch=1,
          regnet_peak_memory_gib=regnet_peak_gib,
          subspace_step_ms=subspace_step_ms, subspace_batch=TRAIN_B,
          subspace_peak_memory_gib=subspace_peak_gib)
    # the share of the image gradient's points that took its overflow path:
    # at the timed shape (C = 3, 160^3, B = 1) and fields, and at
    # RegNet2D3D's step
    _begin("image_grad_overflow")
    _emit(overflow_share=overflow_shares)

    _begin("profile")
    profile_call(lambda: pipe.register(pca, src_hu, tgt_hu, seg, seg))
    _begin("profile_refine")
    profile_call(lambda: pipe_r.register(r_pca, *r_args))
    _begin("profile_refine_projection")
    profile_call(lambda: pipe_p.register(r_pca, *r_args))

    # -- the image gradient of bf16 taps; the learned-basis workflow -------
    _begin("image_grad_bf16_check")
    bf16_excess = image_grad_bf16_check(torch, F, warp_kernel, dev)
    _emit(excess_over_tol=bf16_excess, step=IMG_GRAD_BF16_STEP)
    _require(max(bf16_excess.values()) <= 0.0,
             f"the bf16 image gradient disagrees: {bf16_excess}")
    del pipe, pipe_r, pipe_p
    torch.cuda.empty_cache()
    try:
        learned = learned_basis(torch, KERNELS, learned_root, learned_proc,
                                profile_call)
    finally:
        shutil.rmtree(learned_root, ignore_errors=True)
    optreg_reference(torch, F, warp_kernel)
    try:
        chain = dirlab_chain(torch, KERNELS, dirlab_root)
        dirlab_parity(dirlab_root, chain)
    finally:
        shutil.rmtree(dirlab_root, ignore_errors=True)
    replaces = {
        "pca_expand": "liftreg_tpu/ops/pallas_pca.py:30",
        "pca_grad": "liftreg_tpu/ops/pallas_pca.py:78",
        "warp_trilinear": "liftreg_tpu/ops/pallas_warp.py:61",
        "warp_coord_grad": "liftreg_tpu/ops/pallas_warp.py:61",
        # no TPU kernel (the Pallas warp returns NaN for the image): XLA's
        # scatter-add in the autodiff of resample._quad_plain
        "warp_image_grad": "liftreg_tpu/ops/resample.py:91",
        "drr_project": "liftreg_tpu/ops/pallas_drr.py:27",
        # no TPU kernel: XLA's autodiff of project_with_mats (:184-218)
        "drr_project_adjoint": "liftreg_tpu/ops/drr.py:184",
        # its plan indexes the nonzeros of the dense matrices that
        # _two_tap_matrix builds for that autodiff
        "drr_adjoint_plan": "liftreg_tpu/ops/drr.py:105",
        "drr_backproject": "liftreg_tpu/ops/pallas_drr.py:59",
    }
    sources = {
        "pca_expand": "liftreg_tpu_torch/csrc/pca_expand.cu",
        "pca_grad": "liftreg_tpu_torch/csrc/pca_expand.cu",
        "warp_trilinear": "liftreg_tpu_torch/csrc/warp_trilinear.cu",
        "warp_coord_grad": "liftreg_tpu_torch/csrc/warp_trilinear.cu",
        "warp_image_grad": "liftreg_tpu_torch/csrc/warp_trilinear.cu",
        "drr_project": "liftreg_tpu_torch/csrc/drr_project.cu",
        "drr_project_adjoint": "liftreg_tpu_torch/csrc/drr_project_adjoint.cu",
        "drr_adjoint_plan": "liftreg_tpu_torch/csrc/drr_project_adjoint.cu",
        "drr_backproject": "liftreg_tpu_torch/csrc/drr_backproject.cu",
    }
    kernels = []
    for name in KERNELS:
        if name in probe_rows:
            # launches from the bench tool's run (gather_probe)
            kernels.append(probe_rows[name])
        else:
            t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
            t_ops = ops[name][0] / ops[name][1] * 1e3
            # launches on the main path that runs the kernel: RegNet2D3D's
            # train step for the image gradient, projection-refined
            # register (which runs the other eight) for the rest
            main_launches = (regnet_launches if name == "warp_image_grad"
                             else projection_launches)
            kernels.append({
                "name": name, "route": "cuda", "source": sources[name],
                "replaces": replaces[name],
                "launches": main_launches[name],
                "max_abs_err": errs[name],
                "ms": ms[name], "plain_ms": plain_ms[name],
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms[name]})
        kernels[-1].update(optreg_call_launches=learned["call"][name],
                           optreg_step_launches=learned["step"][name],
                           oracle_pair_launches=learned["oracle_pair"][name],
                           objective_ab_variant_launches=learned[
                               "ab_variant"][name],
                           dirlab_launches=chain["launches"][name],
                           projection_launches=projection_launches[name],
                           image_refine_launches=refine_launches[name],
                           serving_launches=launches[name],
                           train_launches=train_launches[name],
                           train_bf16_launches=bf16_launches[0][name],
                           regnet_launches=regnet_launches[name],
                           subspace_launches=subspace_launches[name],
                           data_parallel_rank_launches=dp[
                               "rank_launches"][name])
    next(k for k in kernels if k["name"] == "drr_backproject").update(
        bf16_buffer_ms=lift_bf16["ms"],
        bf16_buffer_bound_ms=lift_bf16["bound_ms"],
        bf16_buffer_library_ms=lift_bf16["library_ms"])
    for name, times in layout_times.items():
        next(k for k in kernels if k["name"] == name)["layouts"] = times
    next(k for k in kernels if k["name"] == "warp_image_grad").update(
        bf16_taps_ms=image_grad_bf16["ms"],
        bf16_taps_plain_ms=image_grad_bf16["plain_ms"],
        bf16_taps_bound_ms=image_grad_bf16["bound_ms"],
        bf16_taps_library_f32_ms=image_grad_bf16["library_f32_ms"])
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    timer.cancel()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        _stop_children()
