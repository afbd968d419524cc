#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cv_diffusion_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, one JSON line each on stdout (warnings and build logs go to stderr):

1. device  -- the card's name and power limit (``nvidia-smi``).
2. build   -- the hand-written kernels, each built with its own ``nvcc`` from
   ``csrc/``, all started together; for the fused IRB, every kernel's
   registers and spill bytes from the ptxas report (its output and pool
   passes must not spill).
3. kernel  -- each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and the JAX tests' edge shapes, with CUDA-event
   times per call (``*_ms``, host launch cost included; ``*_graph_ms``, one
   call replayed from a CUDA graph, device time alone) and the least time
   the card could take (``bound``; for the fused IRB also ``tc_bound_ms``,
   its products on the tensor cores: 3×TF32 or bf16). Linear attention,
   forward and backward, at ``mid_attn``'s shapes (batch 1 and 8), edge
   shapes (N = 1, 5, 100, 4096) and clusters of 16 at D = 64 and 128, each
   with its plan (cluster size C, shared memory) and its device kernels per
   call from ``torch.profiler`` (one each); the
   fused IRB, v2 and v1 (both GroupNorms' statistics in the kernel) side by
   side on the same inputs, at every distinct IRB shape of the small UNet at
   256², batch 1 and 8, and at the widest blocks of the base and large
   UNets (Cout 384 and 512); v1 also at the JAX tests' shapes (``tile_h=8``)
   and in bf16 at the widest block of each UNet level.
4. serve   -- the main path at full width, through the CUDA graphs: the
   committed 1-step student on its own weights
   (``ServingPipeline.from_artifact("vreg1b_gt03_ema")``:
   ``artifacts_torch/vreg1b_gt03_ema.npz``, grid [739]; the file's size and
   load time), the same student with ``use_pallas_irb=True`` (every IRB
   through the fused kernel), and ``vreg2b_gt03_ema``'s grid [739, 259] on
   the 1-step student's weights (the 2-step student's own are not in the
   tree; its line says ``"weights": "vreg1b_gt03_ema"``), at 256². Single
   requests of several sizes (the batch-1 graph is captured at the first),
   batches of 8 one chunk a call and ``REPS`` chunks pipelined in one call
   (the batch-8 graph), latency, images/s, peak memory and the memory the
   graphs hold, and the ``benchmark()`` dict (a ``benchmark`` line). Each
   configuration's kernel launches, with the counts set to 0 just before
   it: the wrappers' (each graph's warm-up and capture, one eager call) and
   those inside replays (replays times each graph's launches a replay).
5. graph   -- each configuration's graphs, batch 1 and 8, against its eager
   sampler on the same seed (uint8, equal or at most 1 LSB, the values off
   counted), capture seconds, eager and graph latency in paired runs, and
   from ``torch.profiler`` the host's CUDA launch calls and the device's
   kernels per sampler call and per request (a replay must run one
   attention kernel a UNet call, and the fused IRB's kernels when on).
6. package -- the student's serving packages, fp32, bf16 and int8, written
   into ``cv_diffusion_tpu_torch/_build/packages/``: bytes, the
   quantization report and error, write and load seconds; the loaded
   weights equal the codec's; the card's sampler on each package's weights
   against the CPU's on the same noise, unfused and fused (5e-3); each
   package served through ``from_package``, unfused and fused, at batch 1
   and 8 (latency, images/s, peak memory, launches).
7. check   -- each kernel against its plain version on the main path's own
   inputs (``mid_attn``'s q/k/v, ``decoder_blocks.3.0``'s x, taken from
   eager requests); on that x, the Gram fold's GN2⊕FiLM affine against the
   statistics of h1 itself (and the same fold in TF32, which that check
   must reject); ``fused_irb_v1`` on the x and FiLM of each of the 22 IRBs
   of one unfused request (its launch count set to 0 just before), against
   each block's own output and against v2, and its device-side GN affines
   at ``decoder_blocks.3.0`` against float64 statistics of x and h1; the
   card's sampler output against the CPU's on the same (trained) weights
   and noise, and the fused configuration's sampler against the unfused
   one's on the card.
8. eval    -- the student's quality on the card: the 15 pairs of the
   synthetic validation split at 256² and their noise, made anew
   (``cv_diffusion_tpu_torch.evaluate``) and held by SHA-256 to the JAX
   reference (``artifacts_torch/vreg1b_gt03_ema.eval_ref.json``); served
   unfused and fused (the counts set to 0 just before each), PSNR, SSIM,
   MAE, MS-SSIM and GMSD per image against the JAX package's values, images
   0 and 1 against JAX's uint8 outputs (``….eval_ref_u8.npz``), and the
   card's metrics against the CPU port's on the same outputs; then the bf16
   and int8 packages, unfused, per image against the JAX package's own
   packages of those codecs (``….eval_ref_bf16.json``, ``…_int8.json``).
9. profile -- only with ``--profile``: where the card's time goes when the
   1-step student serves through its graphs, unfused and fused, from
   ``torch.profiler`` over five single requests (480×720) and five batches
   of 8 (and, in the train phase, over three train steps). Wall and device
   time per request, the device's busy share, kernels per request, device
   time by kind and the top kernels; and, per configuration, the UNet
   blocks inside which an eager batch of 8 reaches its highest memory
   peaks.
10. train  -- the training path at full width: ``Trainer`` on the small
   UNet at 256² (v-prediction, float32, batch 8), random weights from seed
   0 and synthetic batches from a numpy seed. Two warm-up steps, then ten
   timed ones (``train_epoch``); ms per step, images/s, peak memory, and
   the attention kernels' forward and backward launches (one each a step),
   with the counts set to 0 just before; finite loss, gradient norm and
   gradients, and a non-zero gradient of ``mid_attn.to_qkv``. Then one
   step through the kernels against the same step with the attention on
   its plain autograd path, one step on the card against the CPU (small at
   64², batch 2), a validation pass, and a checkpoint save and restore.
11. conv_workspace -- each ``Upsample`` conv of the small UNet at 256², float32
   and bf16, batch 1, 4, 5 and 8: cuDNN's own choice (``F.conv2d``) against
   the port's ``Upsample`` (cuDNN off where ``blocks.CUDNN_FFT_FROM_BATCH``
   says cuDNN takes an FFT): the memory each holds beyond its output,
   CUDA-event times, whether an FFT ran, and their difference.
12. bf16_serve -- the student with ``unet.dtype = "bfloat16"`` on its float32
   weights (``models.diffusion.with_dtype``), unfused, with
   ``use_pallas_irb`` and on the grid [739, 259], through the CUDA graphs:
   latency, pipelined images/s, peak and graph memory, launches (counts set
   to 0 before each configuration), each graph against the eager sampler at
   batch 1 and 8 (≤ 1 LSB), the profiler's kernels in a replay (bf16
   instances of attention, one a UNet call, and of the fused IRB's output
   pass), the bf16 attention kernel on ``mid_attn``'s and the fused IRB on
   ``decoder_blocks.3.0``'s own bf16 inputs against their plain versions,
   and the fused IRB's bf16 entry timed at each IRB shape of a UNet call.
13. bf16_eval -- the 15 pairs of phase 8 in bf16 compute, unfused and fused,
   per image against the JAX package's bf16 compute at phase 8's bounds
   (``….eval_ref_bf16compute.json``, ``…_fused.json``; inputs held by
   SHA-256), with the port's bf16-vs-float32 mean PSNR gap beside JAX's.
14. train_amp -- ``use_amp=True`` training of small@256 at batch 8 (warm-up
   and ten timed steps as phase 10): ms per step, images/s, peak memory, the
   attention kernels' launches, one bf16 backward kernel a step in the
   profiler; the first step on the student's weights in bf16 against
   float32 (loss and gradients relative to their norms), and the bf16
   backward kernel on that step's own inputs against its plain version.
15. remat -- at batch 8, float32 and bf16, the plain step (twice) and
   ``remat`` with ``full`` and ``conv`` × ``all`` and ``decoder``: peak
   memory, ms per step, the first step's gradients equal to the plain
   step's bit for bit (deterministic algorithms on); and the bytes the
   plain backward keeps, by UNet block.
16. warm_start -- ``init_params_from`` the committed ``.npz`` (bit for bit
   before the first step, a fresh state), three ``use_amp`` steps, and
   ``init_params_ema`` from a checkpoint written in the run.
17. data   -- training from image directories. A LOL-shaped set (485 + 15
   pairs of 400×600 PNGs, rows cycling through the five filters) written
   under ``cv_diffusion_tpu_torch/_build/lol_data`` from ``DATA_SEED``;
   decode rates (``data/png.py`` one file a call and sixteen together; the
   native decoder, or why it is unavailable); the train split's device
   cache (its bytes, build and upload seconds, ms per assembled batch of
   8); holds: a batch's pairs are its draws' host crops and flips exactly
   and their rotation within 1 LSB of ``augment.rotate`` in the interior,
   the eval split's centre crops equal ``LowLightDataset``'s, synthetic
   values on the 1/255 grid; ``train_model`` on 96 pairs (12 steps of
   small@256, batch 8, ``use_amp``) with the Python loader and prefetch, the
   native loader where built, and ``data_on_device`` (ms a step, ms a step
   waiting for the loader, attention launches, validation, the sample grid
   decoded back against its arrays); the main thread's blocked ms of an
   async and a sync checkpoint save (the async file restored equals the
   state at save time though a step ran in place after it); and ``python
   -m cv_diffusion_tpu_torch.train`` as a subprocess (exit 0, its
   checkpoint and grid).
18. distill -- distillation (``models/distillation.py``,
   ``DistillationTrainer``, ``python -m cv_diffusion_tpu_torch.distill``)
   with the committed student's weights standing in for its teacher (the
   teacher's are not in the tree; same architecture). Against the JAX
   package: four settings of ``….distill_ref.json`` (regression [739] from
   an 8-step teacher with ``gt_weight`` 0.3, [739, 259] with the stop-grad
   prefix, canonical consistency with ``pair_stride`` 1, sampler-matched),
   on its inputs and numpy draws (held by SHA-256), loss and gradient norms
   within ``DISTILL_TOL``, and the same in bf16 compute, a control, outside
   at least one of them; one recipe step at batch 8 through the kernels
   against the same step with the attention plain, and at 64² on the card
   against the CPU; ``DistillationTrainer`` on the recipe (regression [739],
   8-step teacher, ``gt_weight`` 0.3) at small@256, batch 8, float32 and
   bf16, and canonical consistency, 2 steps from memory + 10 timed through
   ``create_dataloaders``' device cache each: ms a step, ms a step waiting
   on the loader, peak memory and the attention kernels' forward
   and backward launches a step (9 and 1 in regression, 3 and 1 in
   consistency; the bf16 run's attention inputs all bf16); and the CLI on a
   small LOL-style directory (exit 0, ``best_student`` and
   ``student_final`` with ``params.npz``, ``model_config.json`` and
   ``student_timesteps.json``), its student then serving one request
   through ``ServingPipeline.from_config``.
19. int8   -- the int8 convolution kernels (``csrc/qconv.cu``, built with the
   others in phase 2; its ``build`` line: each instance's registers, static
   shared memory and spills, which must be 0 for the dense, depthwise and
   both quantize kernels, each dense tile's dynamic shared memory, and from
   ``cuobjdump -sass`` the dense kernels' ``IMMA`` count, which must be
   above 0, and ``IDP4A`` count, which must be 0): the weight pass
   (``quantize_weight``: s_w and the layout in one launch) against
   ``quantize_weight`` and the layout bit for bit at every shape class, edge
   and adversarial weight, and on an all-zero output channel (s_w = 1e-12)
   and a channel that lands on exact halves (``INT8_HALVES``); each entry
   (quantize, dense, depthwise) against its plain version bit for bit at
   every ``QConv``
   shape class of the small UNet at 256² and at ``INT8_EDGES`` (ragged M,
   O = 3, Cin = 6, stride 2 on odd H and W, outputs 300 and 301 wide),
   batch 1 and 8, float32 and bf16 compute, on random inputs (some past
   their amax), each launch's plan (``plan_dense``, ``plan_depthwise``)
   held to the library's shared memory, the quantize's loads by vector or
   element by element (``quantize_launch``); and the adversarial accumulations
   (K = 2,048 1×1 and 2,304 3×3 in a few output tiles, K = 1,152 1×1 in
   many; every input at its amax: an odd sum past 2²⁴), where a float32
   ``F.conv2d`` of the same int8 values must differ (the control).
20. int8_act -- the student calibrated on the card (4 batches of 8
   synthetic pairs, numpy draws held by SHA-256) against JAX's scales
   (``….int8act_ref.json``, ``INT8_SCALE_TOL``); every entry on the inputs
   of the 83 QConvs of one eager int8 UNet call (batch 1, a request's; batch
   8, a batch's) and the weight pass on their 83 weights, bit for bit, and
   timed there (host and graph ms summed over the call and by shape class,
   quantize and the weight pass beside each class's convolution, the plain
   version's ms, the bound, the
   library yardstick checked exact on the same inputs: ``torch._int_mm`` on
   the im2col'd operands for the dense entry, a float32 cuDNN depthwise
   ``F.conv2d`` for the depthwise one); the ``int8_act``
   package written and loaded (bf16 weights, the scales); the 15 pairs
   against JAX's int8_act package (``INT8_EVAL_TOL``), the fp32 model the
   control that must fail; served beside the fp32 student in the same call
   (480×720 latency, batch-8 pipelined images/s, peak, graph vs eager 0
   LSB, launches a replay: 83 weight passes, 83 quantize, 61 dense, 22
   depthwise, 1 attention); the ``int8_trace`` line: torch.profiler over 5
   replays of the int8_act graphs at batch 1 and 8, the device kernels and
   ms a replay by group (quantize, the weight pass, dense, depthwise,
   attention, the rest by name) and the device's idle share;
   ``use_pallas_irb`` launching no fused IRB; ``python -m
   cv_diffusion_tpu_torch.export --quantize int8_act --calib_dir`` on
   ``write_lol``'s first 8 pairs, its package serving a request.
21. qat    -- a ``qat`` and a ``qat_act`` loss and gradient at batch 2 on the
   student against JAX's (``….qat_ref.json``, ``QAT_TOL``), the plain float
   step the control that must fail; ``train_model`` with ``qat_act``
   (small@256, batch 8, ``use_amp``, ``QAT_STEPS`` steps from
   ``create_dataloaders(device_cache=True)``: ms a step, ms waiting on the
   loader, peak, attention launches); the train CLI with ``--qat_act`` (2
   steps, exit 0).

22. flash  -- the three flash-attention kernels (``csrc/flash_attention.cu``,
   built with the others in phase 2; the ``build`` line has each instance's
   registers and spills, 0 spills required in all eighteen instances, and
   ``HMMA`` by kernel from ``cuobjdump -sass``, required in each forward
   instance): forward, dK/dV and dQ against their plain
   versions (f32 forward 2e-5, backward 5e-4; bf16 4 bf16 ulps of each
   reference's largest magnitude, at most 2e-2, ``flash_limit``; reruns
   bit for bit; each kernel's plan from the library's
   ``flash_attention_plan``) at ``mid_attn``'s
   shape (batch 1 and 8), 512²'s mid (N = 4096), N = 1, 5, 100, 127, 128,
   200, 1000 and D = 64 and 128, f32 and bf16; at the timed shapes host and
   graph ms of each kernel, the plain versions and
   ``scaled_dot_product_attention`` (forward; forward + autograd.grad less
   the forward, both captured in CUDA graphs as the kernels are), each
   kernel's bound (``FLASH_WORK``; in f32 also its 3xTF32 tensor-core
   bound); and the
   forward's peak memory against the plain version's at [8, 4096, 4, 32]
   (``flash_memory``).
23. softmax_serve -- a seeded small@256 with ``use_linear_attention=False``
   (the student's config otherwise) served through the CUDA graphs at batch
   1 and 8, f32 and bf16 compute: latency, images/s, peak memory, graph vs
   eager (≤ 1 LSB), one forward flash launch a UNet call in a replay and no
   linear-attention launch (counts set to 0 before each dtype), the kernel
   on ``mid_attn``'s own q, k, v; the card's f32 sampler against the CPU
   port's at 256² (``softmax_serve_check``).
24. softmax_train -- that model trained at batch 8, f32 and ``use_amp`` (2
   warm-up and 3 timed steps): ms a step, peak, one launch of each flash
   kernel a step; ``mid_attn``'s gradients through the kernels against the
   plain autograd attention, the backward kernels on the step's own inputs,
   two identical steps bit for bit with deterministic algorithms on
   (``softmax_train_check``).
25. split_skip -- the student with ``split_skip`` on its own weights against
   itself concatenating: the sampler on the same noise (5e-3), the served
   uint8 outputs (≤ 1 LSB), latency, batch-8 images/s, peak memory and an
   eager batch-8 sampler's peak beside the concat path's, and one train
   step's loss and gradients against the concat model's (the train phase's
   step bounds).
26. cli    -- the CLIs a user runs, each through its ``main(argv)`` in this
   process, with the kernels' launch counts set to 0 just before each:
   ``make_synthetic_dataset`` (8 + 15 pairs at 256², its val split equal to
   the eval phase's pairs), ``inference`` on a directory of PNG and BMP
   crops of two sizes with the student (``--dtype float32``, batch 1 and 4,
   each within 1 LSB of ``from_artifact``'s pipeline), ``evaluate
   --data_dir`` on the written val split (per image within 1e-4 of the eval
   phase's in-memory run, expected bit for bit, and within its bounds
   against JAX), ``benchmark`` random-init (bf16, batch 1 and 8,
   ``--profile``: the trace's kernels) and ``--model`` (the student, bf16),
   ``train --config`` on a YAML that names the written splits (one epoch,
   the YAML's ``use_amp``), and ``migrate`` of the student's state dict
   saved with ``torch.save`` (the package's weights equal the student's,
   one request served from it, and on the student's config within 1 LSB of
   ``from_artifact``'s): wall seconds and linear-attention launches of each,
   which must be above 0 for every CLI that serves (the ``cli`` line).

27. dp     -- data parallelism (``cv_diffusion_tpu_torch/parallel``), each
   process a subprocess of this script (``--dp-rank``) that joins its group
   through ``parallel.distributed_init`` with a localhost coordinator; a
   process's non-zero exit fails the phase. World size 1 over NCCL: three
   ``Trainer`` steps of the student's small@256 at batch 8 over a one-rank
   mesh, float32 and ``use_amp``, bit for bit the plain ``Trainer``'s
   (deterministic algorithms on); the DP sampler
   (``make_sharded_sample_fn``) at batch 8, float32, bf16 and
   ``use_pallas_irb``, 0 LSB from ``ServingPipeline`` on the same seed, and
   their paired ms (plain, DP, DP, plain); the collectives in a profiler
   trace of two DP sampler calls (0), beside an NCCL ``all_reduce``'s trace
   (the control that must show one). World size 2 over gloo with CUDA
   tensors, both processes on the card (global batch 8, 4 rows each): one
   train step against one process's at the global batch (``within``),
   the same step with process 1 seeded 1 (the control that must fail);
   ``linear_attention_sharded`` at [8, 1024, 4, 32] over a spatial axis of
   2 against the whole sequence's kernel (2e-5), each process's tokens
   without the reduction (the control that must fail); DP serving gathered
   against one process's ``ServingPipeline`` (≤ 1 LSB). The ``dp`` line
   counts the linear-attention launches, forward and backward, of each
   process (and the fused IRB's).

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that last line. It needs one CUDA device and the
repository beside it; only ``model_config.json`` and
``student_timesteps.json`` are read from ``artifacts/``, and the weights and
the JAX reference from ``artifacts_torch/``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
# (label, artifact, grid, use_pallas_irb); every row serves the weights of
# STUDENT, the one artifact whose weights are in the tree
STUDENT = "vreg1b_gt03_ema"
SERVED = (("vreg1b_gt03_ema", "vreg1b_gt03_ema", (739,), False),
          ("vreg2b_gt03_ema", "vreg2b_gt03_ema", (739, 259), False),
          ("vreg1b_gt03_ema+use_pallas_irb", "vreg1b_gt03_ema", (739,), True))
# the eval phase's bounds per image against the JAX package's values: PSNR
# 0.1 dB (scripts/parity_eval.py's gate), the others in their units; uint8
# outputs within 1 LSB (the sampler's 5e-3 is 0.64 LSB before the cast);
# the card's metrics against the CPU port's on the same outputs
EVAL_TOL = {"psnr": 0.1, "ssim": 2e-3, "mae": 1e-3, "ms_ssim": 2e-3, "gmsd": 2e-3}
EVAL_U8_TOL = 1
EVAL_CPU_REL_TOL = 1e-5
IRBS_PER_UNET_CALL = 22       # small UNet: 8 encoder, 2 middle, 12 decoder
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 on the tensor cores ...
BF16_FLOPS_PER_S = 989e12     # ... and bf16
# the fused IRB's output and pool passes must not spill (ptxas report)
NO_SPILL_KERNELS = ("irb_out", "irb_pool")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_pallas_kernels.py:43,60
# linear attention's backward: 5e-4 in float32 (tests/test_pallas_kernels.py:
# 81); in bfloat16 the outputs are rounded to bf16 (8 bits) at |d| up to ~0.3,
# a few ulps of which is ~5e-3
BWD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
IRB_TOL = {"float32": 2e-4, "bfloat16": 5e-2}   # tests/test_pallas_kernels.py:172,252
SAMPLER_TOL = 5e-3            # README "Testing": full sampler vs reference
# a graph's uint8 output against eager's on the same seed: equal, unless
# cuDNN takes another algorithm under capture, then at most 1 LSB
GRAPH_LSB_TOL = 1
REPS = 10                     # chunks of 8 in the serve phase's batch timings
# the serving packages' codecs: (label, create_serving_package's quantize)
CODECS = (("fp32", "none"), ("bf16", "bf16"), ("int8", "int8"))
# one train step against another (kernels vs plain attention, card vs CPU):
# loss relative, the gradients' difference relative to their norm, each
# gradient's largest difference relative to its largest entry, and the share
# of parameter entries the update moved differently
# why: at the train phase
STEP_LOSS_TOL = 1e-5
STEP_GRAD_NORM_TOL = 1e-3      # ‖Δg‖ / ‖g‖ over all parameters
STEP_GRAD_TOL = 1e-2           # each tensor's max |Δg| / its max |g|
STEP_PARAM_TOL = 1e-6          # a parameter entry "differs" above this ...
STEP_PARAM_SHARE = 1e-2        # ... and at most this share of them may
# GN2⊕FiLM from the Gram fold against the same statistics taken two-pass from
# h1 itself, as max |Δ(h1·a2 + b2)| (values up to ~8): a float32 Gram is
# ~2e-6 off at the widest block's shape, one with TF32-rounded inputs ~4e-4
# (a CPU stand-in of that shape), so a TF32 fold fails this bound. fused_irb
# v1's own affines (GN1's on x, GN2⊕FiLM's on h1, from the kernel's one-pass
# float32 partials) are held to it against float64 statistics
FOLD_TOL = 5e-5
# bf16 compute (phases 12-16): the student served with unet.dtype = "bfloat16"
BF16_SERVED = (("vreg1b_gt03_ema+bfloat16", "vreg1b_gt03_ema", (739,), False),
               ("vreg1b_gt03_ema+use_pallas_irb+bfloat16", "vreg1b_gt03_ema", (739,), True),
               ("vreg2b_gt03_ema+bfloat16", "vreg2b_gt03_ema", (739, 259), False))
# bf16 eval: per image at EVAL_TOL against JAX's bf16 compute (artifacts_torch/
# …eval_ref_bf16compute[_fused].json, compiled with XLA's excess precision off
# so that every cast of the model's code rounds; with it on, XLA's CPU
# compiler skips some and moves JAX's own per-image PSNR by up to 0.145 dB),
# and the mean |ΔPSNR| over the 15 images at BF16_EVAL_MEAN_PSNR_TOL (the CPU
# port: 0.003 dB either route; a float32 computation of the same model is
# 0.16 / 0.11 dB away unfused / fused, and up to 0.40 / 0.30 on one image)
BF16_EVAL_MEAN_PSNR_TOL = 0.02
# a use_amp step against the float32 step on the same batch, t and ε (the
# trained student): the loss, and the gradients' norm and difference,
# relative (on the CPU at 48² JAX's own bf16 step is 4.4e-4 and 2.7e-2 from
# its float32 one)
AMP_LOSS_TOL = 1e-2
AMP_GRAD_TOL = 0.1
# remat: (remat, policy, scope); the first two are the plain step, twice.
# Steps timed a case. Each remat step's first gradients against the plain
# step's, which must be equal bit for bit: the recompute runs the same
# operations, and the phase runs with cuDNN's deterministic algorithms and
# torch.use_deterministic_algorithms, without which the bilinear resize's
# backward adds with atomics in an order that varies (two plain float32
# steps then differ by ~4.4e-7 of the gradients' norm; in bf16 that noise
# is mostly rounded away, and flipped one run's gradients by 4.9e-4:
# scripts/torch_port_grad_determinism.py)
REMAT_CASES = ((False, "full", "all"), (False, "full", "all"), (True, "full", "all"),
               (True, "full", "decoder"), (True, "conv", "all"), (True, "conv", "decoder"))
REMAT_STEPS = 3
WARM_START_STEPS = 3
# the data phase's LOL-shaped set (LOL's our485 / eval15 splits: 400×600
# pairs), written under _build/ from DATA_SEED; DATA_SCENES distinct 600²
# scenes, each cut, flipped and degraded anew for several pairs
LOL_SPLITS = (("our485", 485), ("eval15", 15))
LOL_HW = (400, 600)
DATA_SEED = 13
DATA_SCENES = 40
DATA_VARIANT, DATA_SIZE = "small", 256
DATA_STEPS = 12                # train steps a loader: 96 pairs at batch 8
CLI_PAIRS = 24                 # the CLI's run: 3 steps

# the distill phase (18). Against the JAX package: the four settings of
# artifacts_torch/<STUDENT>.distill_ref.json (scripts/torch_port_distill_
# reference.py: JAX's own losses on the CPU in float32, the student as
# teacher, student and EMA, batch 2 at 256², numpy draws made again here),
# each loss relative, the gradient's global norm relative and each named
# gradient tensor's norm relative. Both sides compute in float32, in other
# orders, through up to 8 UNet calls and a backward. An NVIDIA H100 80GB
# HBM3 at 700 W read at most 3.7e-6 (loss), 9.5e-6 (global norm) and
# 4.9e-5 (a named tensor's norm); the same settings with the student in
# bf16 compute, the control that must fail a bound, read at least 1.4e-3,
# 2.9e-3 and 6.0e-3. Each bound lies between the two, 10-30x from each
# (the control failed all three in every setting)
DISTILL_TOL = {"loss": 1e-4, "grad_global_norm": 2e-4, "grad_norm": 5e-4}
# the recipe of the committed 1-step student (BENCHMARKS.md, round 5), run
# at batch 8 on the stand-in teacher (the student's own weights: the
# teacher's are not in the tree); the consistency run: canonical pairs,
# pair_stride 1
DISTILL_RECIPE = dict(student_timesteps=(739,), teacher_steps=8, gt_weight=0.3)
DISTILL_CONSISTENCY = dict(canonical=True, pair_stride=1)
DISTILL_LR = 2e-5
DISTILL_WARM, DISTILL_TIMED = 2, 10     # steps of each timed run
DISTILL_PAIRS = 8 * DISTILL_TIMED       # make_split pairs: one epoch of the timed steps
DISTILL_CLI_PAIRS = (4, 2)              # the CLI's train and val pairs, 288²


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bf16_ulp(magnitude: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at ``magnitude``."""
    return 2.0 ** (math.floor(math.log2(magnitude)) - 7) if magnitude > 0 else 0.0


# kernel name fragments → kind, first match wins (profile phase)
KINDS = (
    ("linear_attention", ("linear_attention_fwd", "linear_attention_bwd")),
    ("fused_irb", ("irb_out", "irb_pool", "irb_se_fc", "irb_combine",
                   "irb_gn1_stats", "irb_gn_finalize")),
    ("conv", ("conv", "cudnn", "implicit", "winograd", "fft",
              "depthwise", "dgrad", "wgrad", "fprop")),
    ("gemm", ("gemm", "sgemm", "cutlass", "ampere", "sm90", "magma")),
    ("reduction", ("reduce", "mean", "sum")),
    ("interpolate", ("upsample", "interp")),
    ("copy/cat", ("copy", "cat", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas=-v``
    log, by a short name: ``irb_out<float,false,32>`` for the mangled
    ``..irb_outIfLb0ELi32EEE..``."""
    kernels, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            t = re.search(r"\d+((?:irb|linear|dense|depthwise|quantize|flash)_\w+?)(?:I(.*?E)E|E)",
                          mangled)
            args = re.findall(r"13__nv_bfloat16|f|L[bi]\d+E", (t and t.group(2)) or "")
            names = {"f": "float", "13__nv_bfloat16": "bf16", "Lb0E": "false", "Lb1E": "true"}
            name = mangled if not t else t.group(1) + (
                "<" + ",".join(names.get(a, a[2:-1]) for a in args) + ">" if args else "")
            cur = kernels.setdefault(name, {"registers": None, "spill_bytes": 0,
                                            "static_smem_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and cur is not None:
            cur["static_smem_bytes"] = int(m.group(1))
    return kernels


def sass_counts(library: str, opcodes=("IMMA", "IGMMA", "IDP4A")):
    """Per kernel of a built library (short names as :func:`ptxas_report`),
    how many of its SASS instructions are each of ``opcodes``, from the
    ``cuobjdump -sass`` beside the ``nvcc`` that built it; None where the
    toolkit has no cuobjdump."""
    from cv_diffusion_tpu_torch.ops import cuda_build

    exe = os.path.join(os.path.dirname(cuda_build._nvcc(library)), "cuobjdump")
    if not os.path.exists(exe):
        return None
    text = subprocess.run([exe, "-sass", library], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = next(iter(ptxas_report(f"Compiling entry function '{m.group(1)}'")))
            cur = counts.setdefault(name, dict.fromkeys(opcodes, 0))
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and cur is not None and m.group(1) in cur:
            cur[m.group(1)] += 1
    return counts


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def profile(label: str, fn, requests_per_run: int, runs: int = 5) -> None:
    """Trace ``runs`` calls of ``fn`` with ``torch.profiler`` and emit where
    the card's time went, per request."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: not the GPU-side ranges of annotations such as
    # the optimizer's step
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    require(bool(kernels), "the profiler traced no device kernels")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, active = busy_us(spans)
    by_kind, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_kind[kernel_kind(e.name)] += dur
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
    n = runs * requests_per_run
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit("profile", run=label,
         wall_ms_per_request=wall * 1e3 / n,
         device_ms_per_request=sum(by_kind.values()) / 1e3 / n,
         device_busy_share_of_active_span=busy / active,
         device_busy_share_of_wall=busy / (wall * 1e6),
         kernels_per_request=len(kernels) / n,
         ms_per_request_by_kind={k: v / 1e3 / n for k, v in
                                 sorted(by_kind.items(), key=lambda kv: -kv[1])},
         top_kernels=[{"name": name[:90], "ms_per_request": t / 1e3 / n,
                       "calls_per_request": c / n} for name, (t, c) in top])


def busy_us(spans) -> tuple:
    """(µs the device was busy, µs from the first start to the last end) of
    (start, end) intervals sorted by start: the length of their union."""
    busy, end = 0.0, spans[0][0]
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, max(e for _, e in spans) - spans[0][0]


def device_kernels(fn, calls: int = 2, traces: int = 8) -> dict:
    """The device kernels (and copies) one call of ``fn`` runs, by name,
    from torch.profiler over ``calls`` calls after one untraced. The
    profiler now and then drops events (a trace of 10 one-kernel calls has
    read 9 on the card, three traces in a row have, and one has read none),
    never adds one: a trace that reads nothing or a fraction of a kernel a
    call is taken again, after a pause, up to ``traces`` times, and the one
    that read the most counts."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(traces):
        with trace(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts = defaultdict(int)
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                counts[e.name] += 1
        if sum(counts.values()) > sum(best.values()):
            best = counts
        if counts and all(v % calls == 0 for v in counts.values()):
            break
        time.sleep(0.2)
    return {n: v / calls for n, v in best.items()}


def step_diffs(a, b):
    """Loss, gradient-norm and worst-tensor differences of two steps,
    the parameters' largest difference, and the share of parameter
    entries that differ by more than STEP_PARAM_TOL."""
    loss_rel = abs(a[0] - b[0]) / abs(b[0])
    diff_sq = sum(float((a[1][k] - b[1][k]).double().square().sum()) for k in b[1])
    norm_sq = sum(float(b[1][k].double().square().sum()) for k in b[1])
    worst = max((float((a[1][k] - b[1][k]).abs().max())
                 / (float(b[1][k].abs().max()) + 1e-12), k) for k in b[1])
    moved = sum(int(((a[2][k] - b[2][k]).abs() > STEP_PARAM_TOL).sum()) for k in b[2])
    total = sum(t.numel() for t in b[2].values())
    return dict(loss_rel=loss_rel, grad_norm_rel=(diff_sq / norm_sq) ** 0.5,
                grad_tensor_rel=worst[0], worst_tensor=worst[1],
                param_max_abs=max(float((a[2][k] - b[2][k]).abs().max())
                                  for k in b[2]),
                param_differ_share=moved / total)

def within(d):
    return (d["loss_rel"] <= STEP_LOSS_TOL and d["grad_norm_rel"] <= STEP_GRAD_NORM_TOL
            and d["grad_tensor_rel"] <= STEP_GRAD_TOL
            and d["param_differ_share"] <= STEP_PARAM_SHARE)


def write_lol(root: str, splits=LOL_SPLITS) -> dict:
    """LOL's two splits (or the first pairs of ``splits``), 400×600 PNG
    pairs under ``root/{split}/{low,high}``:
    the high side a crop of one of ``DATA_SCENES`` 600² scenes of the
    synthetic split's generator, flipped at random; the low side its
    synthetic degradation; rows filtered None, Sub, Up, Average, Paeth in
    turn. Returns the seconds of its parts."""
    import numpy as np
    from cv_diffusion_tpu_torch.data.augment import synthetic_low_light
    from cv_diffusion_tpu_torch.data.png import write_png
    from cv_diffusion_tpu_torch.data.synthetic import generate_scene

    h, w = LOL_HW
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        scenes = list(pool.map(lambda i: generate_scene(
            np.random.default_rng(DATA_SEED * 1000 + i), w), range(DATA_SCENES)))
        t1 = time.perf_counter()

        def pair(job):
            split, j = job
            rng = np.random.default_rng((DATA_SEED, len(split), j))
            high = scenes[int(rng.integers(DATA_SCENES))]
            top = int(rng.integers(0, w - h + 1))
            high = high[top:top + h, ::-1 if rng.random() < 0.5 else 1]
            low = synthetic_low_light(rng, np.ascontiguousarray(high))
            for side, img in (("low", low), ("high", high)):
                write_png(os.path.join(root, split, side, f"{j:03d}.png"),
                          np.ascontiguousarray(img), (0, 1, 2, 3, 4))

        list(pool.map(pair, [(split, j) for split, n in splits
                             for j in range(n)]))
    return {"scenes_s": t1 - t0, "pairs_s": time.perf_counter() - t1}


def data_phase(dev, n_attn: int, lak, cuda_build) -> dict:
    """Phase 17: the training input path from image directories on the
    card. Returns the ``data`` line's fields."""
    import numpy as np
    import torch
    from cv_diffusion_tpu_torch.config import TrainConfig
    from cv_diffusion_tpu_torch.data import augment as taug
    from cv_diffusion_tpu_torch.data import device_augment as tdaug
    from cv_diffusion_tpu_torch.data import native as tnative
    from cv_diffusion_tpu_torch.data import png
    from cv_diffusion_tpu_torch.data.dataset import LowLightDataset
    from cv_diffusion_tpu_torch.data.device_cache import DeviceCacheLoader
    from cv_diffusion_tpu_torch.training import checkpoint as ckpt
    from cv_diffusion_tpu_torch.training.trainer import train_model

    t0 = time.perf_counter()
    root = os.path.join(cuda_build.BUILD_DIR, "lol_data")
    work = tempfile.mkdtemp(prefix="chip_smoke_data_")
    shutil.rmtree(root, ignore_errors=True)
    written = write_lol(root)

    def files(split, side, n=None):
        d = os.path.join(root, split, side)
        return [os.path.join(d, f) for f in sorted(os.listdir(d))][:n]

    train_low, train_high = files("our485", "low"), files("our485", "high")
    eval_dir = os.path.join(root, "eval15")
    subsets = {}
    for name, pairs in (("train96", DATA_STEPS * 8), ("train24", CLI_PAIRS)):
        subsets[name] = os.path.join(work, name)
        for side, paths in (("low", train_low), ("high", train_high)):
            os.makedirs(os.path.join(subsets[name], side))
            for p in paths[:pairs]:
                os.symlink(p, os.path.join(subsets[name], side, os.path.basename(p)))

    # decode rates: one file a call, and sixteen unfiltered together
    probe = train_low[:16]
    a = time.perf_counter()
    singles = [png.read_image(p) for p in probe]
    single_rate = len(probe) / (time.perf_counter() - a)
    a = time.perf_counter()
    together = png.read_images(train_high[:32])
    batched_rate = 32 / (time.perf_counter() - a)
    require(all(img.shape == LOL_HW + (3,) and img.dtype == np.uint8
                for img in singles + together), "data: decoded shapes")
    native_reason = tnative.native_unavailable_reason()
    if native_reason is None:
        a = time.perf_counter()
        nat = [tnative.decode_image(p) for p in probe]
        native_rate = len(probe) / (time.perf_counter() - a)
        require(all(np.array_equal(x, y) for x, y in zip(nat, singles)),
                "data: the native decoder differs from png.py")
        native = "available"
    else:
        native, native_rate = f"unavailable: {native_reason}", None

    # the device cache of the train split: bytes, upload, a batch's assembly
    torch.cuda.synchronize()
    a = time.perf_counter()
    size = DATA_SIZE
    cache = DeviceCacheLoader(train_low, train_high, size, 8, shuffle=True,
                              drop_last=True, seed=0, device=dev)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - a
    cache_bytes = LOL_SPLITS[0][1] * 2 * LOL_HW[0] * LOL_HW[1] * 3   # 698,400,000
    require(cache.nbytes() == cache_bytes, f"data: cache holds {cache.nbytes()} bytes")
    cache_device = cache._low.device.type
    require(cache_device == dev.type == cache._high.device.type
            and cache._low.dtype == torch.uint8, "data: the cache is not uint8 on the card")
    host_low, host_high = cache._low.cpu(), cache._high.cpu()
    torch.cuda.synchronize()
    a = time.perf_counter()
    up = [host_low.to(dev), host_high.to(dev)]
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - a
    del up
    idxs = cache._indices(np.arange(8))
    for _ in range(3):
        cache.assemble(idxs, 0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(50):
        cache.assemble(idxs, i)
    end.record()
    torch.cuda.synchronize()
    assemble_ms = start.elapsed_time(end) / 50

    # holds: pairs share one transform, which is the host's crop and flips
    # exactly and its rotation within 1 LSB in the interior
    h, w = LOL_HW
    seed = 77
    low, high = cache.assemble(idxs, seed)
    draws = tdaug.draw_paired(torch.Generator(device=dev).manual_seed(seed), 8, h, w, size)
    dc = {k: v.cpu().numpy() for k, v in draws.items()}
    forced = dict(draws, rotate=torch.ones(8, dtype=torch.bool, device=dev))
    rot_err, rotated = 0.0, int(dc["rotate"].sum())
    for frames_host, frames_dev, got in ((host_low, cache._low, low),
                                         (host_high, cache._high, high)):
        crops = cache.normalize(tdaug.crop_windows(frames_dev, idxs, forced, size))
        all_rot = tdaug.rotate_selected(crops, forced)
        for i in range(8):
            t_, l_ = int(dc["tops"][i]), int(dc["lefts"][i])
            win = frames_host[i, t_:t_ + size, l_:l_ + size].numpy()
            win = win[::-1 if dc["vflip"][i] else 1, ::-1 if dc["hflip"][i] else 1]
            want_rot = taug.rotate(np.ascontiguousarray(win), float(dc["angles"][i]))
            dev_rot = (all_rot[i].cpu().numpy() + 1.0) * 127.5
            err = float(np.abs(dev_rot - want_rot)[2:-2, 2:-2].max())
            rot_err = max(rot_err, err)
            require(err <= 1.0, f"data: rotated crop {i} {err} LSB from numpy rotate")
            want = (taug.normalize(win) if not dc["rotate"][i]
                    else all_rot[i].cpu().numpy())
            require(np.array_equal(got[i].cpu().numpy(), want),
                    f"data: pair {i} is not its transform's crop")
    # the centre crop is the host eval transform exactly
    ev = DeviceCacheLoader(files("eval15", "low"), files("eval15", "high"), size, 8,
                           augment=False, device=dev)
    host_ev = LowLightDataset(eval_dir, image_size=size, augment_data=False)
    n_ev = 0
    for batch in ev:
        for j, name in enumerate(batch["filenames"]):
            item = host_ev[n_ev]
            require(name == item["filename"]
                    and np.array_equal(batch["low_light"][j].cpu().numpy(), item["low_light"])
                    and np.array_equal(batch["normal_light"][j].cpu().numpy(),
                                       item["normal_light"]),
                    f"data: centre crop {name} differs from the host eval transform")
            n_ev += 1
    # synthetic degradation on the card: values on the 1/255 grid
    syn = DeviceCacheLoader(files("eval15", "high"), None, size, 8, device=dev, seed=1)
    sb = next(iter(syn))
    grid = (sb["low_light"] + 1.0) * 127.5
    grid_err = float((grid - grid.round()).abs().max())
    require(sb["low_light"].device.type == dev.type and grid_err <= 1e-3,
            f"data: synthetic values {grid_err} off the 1/255 grid")
    del cache, ev, syn, host_low, host_high, low, high, crops, all_rot
    torch.cuda.empty_cache()

    # train_model on the directory, once a loader
    runs = {}
    trainer = None
    for loader in ("python", "native", "device_cache"):
        if loader == "native" and native_reason is not None:
            runs[loader] = {"unavailable": native_reason}
            continue
        cfg = TrainConfig(unet_variant=DATA_VARIANT, image_size=DATA_SIZE, batch_size=8,
                          epochs=1, warmup_epochs=0, log_interval=1000, seed=0,
                          native_loader=loader == "native",
                          data_on_device=loader == "device_cache",
                          checkpoint_dir=os.path.join(work, loader, "ckpt"),
                          output_dir=os.path.join(work, loader, "samples"))
        del trainer
        torch.cuda.empty_cache()
        lak.linear_attention_kernel.launches = 0
        lak.linear_attention_backward_kernel.launches = 0
        a = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            trainer = train_model(subsets["train96"], eval_dir, cfg, device=dev)
        total_s = time.perf_counter() - a
        st = trainer.epoch_stats
        launches = {"linear_attention": lak.linear_attention_kernel.launches,
                    "linear_attention_backward":
                        lak.linear_attention_backward_kernel.launches}
        # a step each way; validation's two batches; the grid's four steps
        want = {"linear_attention": (DATA_STEPS + 2 + cfg.num_inference_steps) * n_attn,
                "linear_attention_backward": DATA_STEPS * n_attn}
        require(st["steps"] == DATA_STEPS and trainer.state.step == DATA_STEPS
                and launches == want, f"data {loader}: {st}, launches {launches}")
        require(np.isfinite(trainer.best_val_loss), f"data {loader}: val loss")
        require(sorted(os.listdir(cfg.checkpoint_dir)) == ["best_model.pt",
                                                           "final_model.pt"],
                f"data {loader}: checkpoints {os.listdir(cfg.checkpoint_dir)}")
        grid_img = png.read_image(os.path.join(cfg.output_dir, "samples_epoch_0.png"))
        first = next(iter(trainer.val_loader))
        u8 = lambda x: np.clip((np.asarray(x) + 1) / 2 * 255, 0, 255).astype(np.uint8)  # noqa: E731
        n = min(cfg.num_samples, len(first["low_light"]))
        require(grid_img.shape == (3 * size, n * size, 3)
                and np.array_equal(grid_img[:size],
                                   np.concatenate(list(u8(first["low_light"][:n])), 1))
                and np.array_equal(grid_img[2 * size:],
                                   np.concatenate(list(u8(first["normal_light"][:n])), 1)),
                f"data {loader}: the sample grid is not its arrays")
        runs[loader] = {"ms_per_step": st["seconds"] * 1e3 / st["steps"],
                        "loader_wait_ms_per_step": st["loader_wait_s"] * 1e3 / st["steps"],
                        "epoch_s": st["seconds"], "train_model_s": total_s,
                        "val_loss": trainer.best_val_loss, "launches": launches}

    # checkpoints: the main thread's blocked time, async and sync; the async
    # file restored equals the state at save time though a step ran after
    batch = trainer._device_batch(next(iter(trainer.train_loader)))
    params = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    ema = {k: v.cpu().clone() for k, v in trainer.state.ema_params.items()}
    opt = {i: {k: v.cpu().clone() for k, v in st_.items()}
           for i, st_ in trainer.state.optimizer.state_dict()["state"].items()}
    step_at_save = trainer.state.step
    torch.cuda.synchronize()
    a = time.perf_counter()
    async_path = trainer.save_checkpoint("async_probe")
    async_ms = (time.perf_counter() - a) * 1e3
    trainer.state, _ = trainer.train_step(trainer.state, batch)      # in place
    a = time.perf_counter()
    trainer.wait_for_checkpoints()
    drain_ms = (time.perf_counter() - a) * 1e3
    raw = ckpt.load_raw(async_path)
    require(raw["step"] == step_at_save
            and all(torch.equal(raw["params"][k], v) for k, v in params.items())
            and all(torch.equal(raw["ema_params"][k], v) for k, v in ema.items())
            and all(torch.equal(raw["opt_state"]["state"][i][k], v)
                    for i, s_ in opt.items() for k, v in s_.items()),
            "data: the async checkpoint is not the state at save time")
    moved = any(not torch.equal(p.detach().cpu(), params[k])
                for k, p in trainer.model.named_parameters())
    require(moved, "data: the step after the save changed nothing")
    torch.cuda.synchronize()
    a = time.perf_counter()
    ckpt.save_checkpoint(os.path.join(work, "sync_probe.pt"), trainer.state, epoch=0,
                         best_val_loss=0.0, config_json="{}")
    sync_ms = (time.perf_counter() - a) * 1e3
    ckpt_bytes = os.path.getsize(async_path)
    del trainer, batch, raw
    torch.cuda.empty_cache()

    # the CLI, as a user runs it
    cli_ck, cli_out = os.path.join(work, "cli_ckpt"), os.path.join(work, "cli_samples")
    a = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cv_diffusion_tpu_torch.train",
         "--data_dir", subsets["train24"], "--val_dir", eval_dir, "--variant", DATA_VARIANT,
         "--image_size", str(DATA_SIZE), "--epochs", "1", "--batch_size", "8",
         "--checkpoint_dir", cli_ck, "--output_dir", cli_out, "--device", dev.type],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - a
    require(proc.returncode == 0 and os.path.isfile(os.path.join(cli_ck, "final_model.pt"))
            and os.path.isfile(os.path.join(cli_out, "samples_epoch_0.png")),
            f"data: the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    fields = dict(
        pairs={s_: n for s_, n in LOL_SPLITS}, hw=list(LOL_HW), scenes=DATA_SCENES,
        write_s=written, decode_images_per_s={"png_py_one_a_call": single_rate,
                                              "png_py_16_together": batched_rate,
                                              "native": native_rate},
        native=native, cache_bytes=cache_bytes, cache_device=cache_device,
        cache_build_s=cache_s, upload_s=upload_s, assemble_ms_batch8=assemble_ms,
        holds={"rotated_in_batch": rotated, "rotation_max_lsb_interior": rot_err,
               "eval_center_crops_equal": n_ev, "synthetic_grid_max_err": grid_err},
        train={"config": f"{DATA_VARIANT}@{DATA_SIZE} batch 8 use_amp", "steps": DATA_STEPS},
        runs=runs, checkpoint={"async_blocked_ms": async_ms, "async_drain_ms": drain_ms,
                               "sync_blocked_ms": sync_ms, "bytes": ckpt_bytes,
                               "async_restore_bit_equal": True},
        cli={"exit": proc.returncode, "seconds": cli_s, "pairs": CLI_PAIRS},
        seconds=time.perf_counter() - t0)
    emit("data", **fields)
    return fields


def reference_draws(seed: int, index: int, spec) -> list:
    """The numpy draws of a distill_ref.json setting, in its order."""
    import numpy as np
    rng = np.random.default_rng([seed, index])
    return [rng.standard_normal(tuple(d[1]), dtype=np.float32) if d[0] == "normal"
            else rng.integers(d[2], d[3], tuple(d[1])).astype(np.int32) for d in spec]


def distill_phase(dev, n_attn: int, lak, cuda_build) -> dict:
    """Phase 18: distillation on the card. Returns the ``distill`` line's
    fields (the launches of each timed run among them)."""
    import numpy as np
    import torch
    from cv_diffusion_tpu_torch.config import (TrainConfig, diffusion_config,
                                               load_model_config, load_timesteps)
    from cv_diffusion_tpu_torch.data import png
    from cv_diffusion_tpu_torch.data.augment import normalize
    from cv_diffusion_tpu_torch.data.dataset import create_dataloaders
    from cv_diffusion_tpu_torch.data.synthetic import make_split
    from cv_diffusion_tpu_torch.evaluate import eval_split, sha256
    from cv_diffusion_tpu_torch.export.serving import ServingPipeline
    from cv_diffusion_tpu_torch.models import distillation as tdist
    from cv_diffusion_tpu_torch.models.blocks import LinearAttention
    from cv_diffusion_tpu_torch.models.diffusion import create_model, with_dtype
    from cv_diffusion_tpu_torch.models.scheduler import lcm_timesteps
    from cv_diffusion_tpu_torch.ops.attention import linear_attention_plain
    from cv_diffusion_tpu_torch.training import checkpoint as ckpt
    from cv_diffusion_tpu_torch.training.trainer import DistillationTrainer
    from cv_diffusion_tpu_torch.weights import init_weights, load_state_dict_npz

    t0 = time.perf_counter()
    art = os.path.join(ROOT, "artifacts", STUDENT)
    cfg = load_model_config(os.path.join(art, "model_config.json"))
    weights = load_state_dict_npz(os.path.join(ROOT, "artifacts_torch", f"{STUDENT}.npz"), dev)
    with open(os.path.join(ROOT, "artifacts_torch", f"{STUDENT}.distill_ref.json")) as f:
        ref = json.load(f)

    def counts():
        return {"linear_attention": lak.linear_attention_kernel.launches,
                "linear_attention_backward": lak.linear_attention_backward_kernel.launches}

    def zero_counts():
        lak.linear_attention_kernel.launches = 0
        lak.linear_attention_backward_kernel.launches = 0

    def student_model(model_cfg=cfg, w=weights, device=dev):
        model, schedule = create_model(model_cfg, device=device)
        model.load_state_dict(w, strict=True)
        return model, schedule

    # (a) against the JAX package: its four settings, its inputs and draws
    b = ref["batch"]
    low_u8, high_u8 = (a[:b] for a in eval_split(15, ref["size"], 0))
    require([sha256(a) for a in low_u8] == ref["inputs"]["low_sha256"]
            and [sha256(a) for a in high_u8] == ref["inputs"]["high_sha256"],
            "distill: the reference's inputs differ")
    low, high = (torch.from_numpy(normalize(a)).to(dev) for a in (low_u8, high_u8))
    model, schedule = student_model()
    frozen = {k: v.detach().clone() for k, v in model.named_parameters()}
    control = with_dtype(model, "bfloat16")
    against_jax = {}
    for i, s in enumerate(ref["settings"]):
        draws = reference_draws(ref["seed"], i, s["draws"])
        require([sha256(d) for d in draws] == s["draws_sha256"],
                f"distill {s['name']}: numpy's draws differ from the reference's")
        d = [torch.from_numpy(x).to(dev) for x in draws]

        def reading(m):
            """Setting s on draws d with the student module m: its loss,
            gradient norms and their errors relative to JAX's."""
            kw = dict(s["args"])
            m.zero_grad(set_to_none=True)
            if s["kind"] == "regression":
                k = kw.pop("teacher_steps")
                kw["student_timesteps"] = tuple(kw["student_timesteps"])
                loss = tdist.sampler_regression_loss(
                    m, schedule, frozen, None, low, high, teacher_steps=k,
                    teacher_noise=(d[0], torch.stack(d[1:k + 1])),
                    student_noise=(d[k + 1], torch.stack(d[k + 2:])), **kw)
            else:
                if kw.get("sampler_matched"):
                    grid = lcm_timesteps(4, 1000, 50)
                    pairs = tdist.sample_sampler_pairs(b, grid, idx=d[1].long())
                else:
                    pairs = tdist.sample_canonical_pairs(b, 1000, 50, 4,
                                                         stride=kw["pair_stride"],
                                                         idx=d[1].long())
                loss = tdist.consistency_distillation_loss(
                    m, schedule, frozen, None, frozen, low, high, noise=d[0],
                    timesteps=pairs, renoise=d[2] if len(d) > 2 else None, **kw)
            loss.backward()
            torch.cuda.synchronize()
            grads = {n: p.grad.double() for n, p in m.named_parameters() if p.grad is not None}
            gnorm = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
            named = {n: float(grads[n].norm()) for n in s["grad_norms"]}
            errs = {"loss": abs(loss.item() - s["loss"]) / abs(s["loss"]),
                    "grad_global_norm": abs(gnorm - s["grad_global_norm"]) / s["grad_global_norm"],
                    "grad_norm": max(abs(named[n] - v) / v for n, v in s["grad_norms"].items())}
            return loss.item(), gnorm, errs

        zero_counts()
        loss, gnorm, errs = reading(model)
        launches = counts()
        # the control: the same setting in bf16 compute must fail a bound
        _, _, control_errs = reading(control)
        against_jax[s["name"]] = dict(loss=loss, jax_loss=s["loss"],
                                      grad_global_norm=gnorm,
                                      jax_grad_global_norm=s["grad_global_norm"],
                                      rel_err=errs, bf16_control_rel_err=control_errs,
                                      launches=launches)
        require(all(errs[k] <= DISTILL_TOL[k] for k in errs),
                f"distill {s['name']} against JAX: {errs} (bounds {DISTILL_TOL})")
        require(any(control_errs[k] > DISTILL_TOL[k] for k in control_errs),
                f"distill {s['name']}: the bf16 control {control_errs} passes the bounds "
                f"{DISTILL_TOL}")
    del model, control, frozen, low, high
    torch.cuda.empty_cache()

    # batches of 8 (set-up): synthetic pairs made in bulk; the warm-up's
    # from memory, the timed runs' through create_dataloaders' device cache
    # of the same pairs written as PNG files
    lo, hi = make_split(DISTILL_PAIRS, DATA_SIZE, DATA_SEED)
    warm = [{"low_light": normalize(lo[j:j + 8]), "normal_light": normalize(hi[j:j + 8])}
            for j in range(0, 8 * DISTILL_WARM, 8)]
    timed_root = os.path.join(cuda_build.BUILD_DIR, "distill_timed")
    shutil.rmtree(timed_root, ignore_errors=True)
    for j in range(DISTILL_PAIRS):
        for side, img in (("low", lo[j]), ("high", hi[j])):
            png.write_png(os.path.join(timed_root, side, f"{j:03d}.png"), img)
    timed_loader, _ = create_dataloaders(timed_root, None, batch_size=8,
                                         image_size=DATA_SIZE, native=False,
                                         device_cache=True, device=dev, seed=0)
    require(len(timed_loader) == DISTILL_TIMED,
            f"distill: {len(timed_loader)} timed batches")
    work = tempfile.mkdtemp(prefix="chip_smoke_distill_")

    def train_cfg(name):
        return TrainConfig(unet_variant="small", image_size=DATA_SIZE, batch_size=8,
                           epochs=1, warmup_epochs=0, learning_rate=DISTILL_LR,
                           log_interval=1000, seed=0,
                           checkpoint_dir=os.path.join(work, name, "ckpt"),
                           output_dir=os.path.join(work, name, "samples"))

    # (b) one regression step through the kernels against the same step with
    # the attention on its plain path (teacher and student), from one state
    def one_step(plain_attention: bool, model_cfg=cfg, w=weights, batch=warm[0],
                 device=dev, draws=None):
        model, schedule = student_model(model_cfg, w, device)
        state = tdist.create_distillation_state(model, dict(w), train_cfg("step"))
        step = tdist.make_regression_distillation_step(model, schedule, **DISTILL_RECIPE)
        original = lak.linear_attention_trainable
        if plain_attention:
            lak.linear_attention_trainable = linear_attention_plain
        try:
            zero_counts()
            state, m = step(state, batch, draws)
        finally:
            lak.linear_attention_trainable = original
        return (float(m["loss"]), {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                {n: p.detach().clone() for n, p in model.named_parameters()}), counts()

    with_kernels, kernel_launches = one_step(False)
    with_plain, plain_launches = one_step(True)
    steps_per = DISTILL_RECIPE["teacher_steps"] + 1
    require(kernel_launches == {"linear_attention": steps_per * n_attn,
                                "linear_attention_backward": n_attn},
            f"distill: the kernel step launched {kernel_launches}")
    require(plain_launches == {"linear_attention": 0, "linear_attention_backward": 0},
            f"distill: the plain-attention step launched {plain_launches}")
    kernel_vs_plain = step_diffs(with_kernels, with_plain)
    del with_kernels, with_plain
    torch.cuda.empty_cache()

    # (c) one regression step on the card against the CPU: small at 64²,
    # batch 2, random weights, explicit numpy draws
    small_cfg = diffusion_config("small", 64, prediction_type="v_prediction")
    small_w = init_weights(small_cfg, seed=1, device="cpu")
    rng = np.random.default_rng(DATA_SEED)
    shape = (2, 64, 64, 3)
    k = DISTILL_RECIPE["teacher_steps"]
    explicit = [rng.standard_normal(shape, dtype=np.float32) for _ in range(k + 3)]
    small_batch = {key: v[:2, :64, :64] for key, v in warm[0].items()}

    def explicit_step(device):
        d = [torch.from_numpy(x).to(device) for x in explicit]
        draws = dict(teacher_noise=(d[0], torch.stack(d[1:k + 1])),
                     student_noise=(d[k + 1], torch.stack(d[k + 2:])))
        w = {n: v.to(device) for n, v in small_w.items()}
        out, _ = one_step(False, small_cfg, w, small_batch, device, draws)
        return tuple(out[0:1]) + tuple({n: v.cpu() for n, v in t.items()} for t in out[1:])

    card_vs_cpu = step_diffs(explicit_step(dev), explicit_step(torch.device("cpu")))
    emit("distill_check", against_jax=against_jax, tol=DISTILL_TOL,
         kernel_vs_plain_step=kernel_vs_plain, card_vs_cpu_step_small64=card_vs_cpu,
         step_tol=dict(loss_rel=STEP_LOSS_TOL, grad_norm_rel=STEP_GRAD_NORM_TOL,
                       grad_tensor_rel=STEP_GRAD_TOL, param_differ_by=STEP_PARAM_TOL,
                       param_differ_share=STEP_PARAM_SHARE),
         seconds=time.perf_counter() - t0)
    require(within(kernel_vs_plain), f"distill: kernel vs plain-attention step: {kernel_vs_plain}")
    require(within(card_vs_cpu), f"distill: card vs CPU step: {card_vs_cpu}")

    # (d) DistillationTrainer: the recipe in float32 and bf16, and canonical
    # consistency, each 2 warm-up steps from memory and 10 timed steps from
    # the device cache at batch 8
    runs = {}
    for name, dtype, kw in (("regression_f32", "float32", dict(regression=True, **DISTILL_RECIPE)),
                            ("regression_bf16", "bfloat16", dict(regression=True, **DISTILL_RECIPE)),
                            ("consistency_f32", "float32", DISTILL_CONSISTENCY)):
        torch.cuda.empty_cache()
        model, schedule = student_model()
        if dtype == "bfloat16":
            model = with_dtype(model, dtype)
        seen = set()
        hooks = [m.register_forward_pre_hook(lambda mod, a: seen.add(a[0].dtype))
                 for m in model.modules() if isinstance(m, LinearAttention)]
        trainer = DistillationTrainer(model, schedule, dict(weights), warm,
                                      None, train_cfg(name), **kw)
        zero_counts()
        trainer.train_epoch()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer.train_loader = timed_loader
        with contextlib.redirect_stdout(sys.stderr):
            loss = trainer.train_epoch()
        torch.cuda.synchronize()
        st = trainer.epoch_stats
        launches = counts()
        for h in hooks:
            h.remove()
        steps = DISTILL_WARM + DISTILL_TIMED
        per_step = (DISTILL_RECIPE["teacher_steps"] + 1) if kw.get("regression") else 3
        require(trainer.state.step == steps and np.isfinite(loss),
                f"distill {name}: {trainer.state.step} steps, loss {loss}")
        require(launches == {"linear_attention": steps * per_step * n_attn,
                             "linear_attention_backward": steps * n_attn},
                f"distill {name}: launches {launches} in {steps} steps")
        want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        require(seen == {want_dtype}, f"distill {name}: attention inputs in {seen}")
        runs[name] = dict(dtype=dtype, steps=steps, timed_steps=st["steps"],
                          ms_per_step=st["seconds"] * 1e3 / st["steps"],
                          loader_wait_ms_per_step=st["loader_wait_s"] * 1e3 / st["steps"],
                          images_per_s=8 * st["steps"] / st["seconds"],
                          peak_mem_bytes=torch.cuda.max_memory_allocated(),
                          loss=loss, launches=launches,
                          launches_per_step={k_: v / steps for k_, v in launches.items()})
        del trainer, model
    del timed_loader
    shutil.rmtree(timed_root, ignore_errors=True)
    torch.cuda.empty_cache()

    # (e) the CLI on a small LOL-style directory, then its student served
    root = os.path.join(cuda_build.BUILD_DIR, "distill_lol")
    shutil.rmtree(root, ignore_errors=True)
    n_train, n_val = DISTILL_CLI_PAIRS
    lo, hi = make_split(n_train + n_val, 288, DATA_SEED + 1)
    for j in range(n_train + n_val):
        split = "train" if j < n_train else "val"
        for side, img in (("low", lo[j]), ("high", hi[j])):
            png.write_png(os.path.join(root, split, side, f"{j:03d}.png"), img)
    cli_ck, cli_out = os.path.join(work, "cli_ckpt"), os.path.join(work, "cli_samples")
    a = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cv_diffusion_tpu_torch.distill",
         "--teacher", os.path.join("artifacts", STUDENT),
         "--data_dir", os.path.join(root, "train"), "--val_dir", os.path.join(root, "val"),
         "--regression",
         "--student_timesteps", ",".join(map(str, DISTILL_RECIPE["student_timesteps"])),
         "--teacher_steps", str(DISTILL_RECIPE["teacher_steps"]),
         "--gt_weight", str(DISTILL_RECIPE["gt_weight"]), "--epochs", "1", "--batch_size", "2",
         "--lr", str(DISTILL_LR), "--checkpoint_dir", cli_ck, "--output_dir", cli_out,
         "--device", dev.type],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - a
    require(proc.returncode == 0, f"distill: the CLI exited {proc.returncode}: "
                                  f"{proc.stderr[-2000:]}")
    files = {n: sorted(os.listdir(os.path.join(cli_ck, n)))
             for n in ("best_student", "student_final")}
    require(all(f == ["model_config.json", "params.npz", "student_timesteps.json"]
                for f in files.values()), f"distill: the CLI wrote {files}")
    final = os.path.join(cli_ck, "student_final")
    require(load_timesteps(os.path.join(final, "student_timesteps.json"))
            == DISTILL_RECIPE["student_timesteps"]
            and ckpt.load_prediction_type(final) == "v_prediction"
            and ckpt.detect_variant(final) == "small",
            "distill: the CLI's student does not record its grid, target and variant")
    pipe = ServingPipeline.from_config(os.path.join(final, "model_config.json"),
                                       os.path.join(final, "student_timesteps.json"),
                                       ckpt.load_inference_params(final, use_ema=False),
                                       device=dev)
    request = np.ascontiguousarray(lo[n_train])
    served = pipe(request, seed=0)
    require(served.shape == request.shape and served.dtype == np.uint8,
            f"distill: the student served {served.shape} {served.dtype}")
    del pipe
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    fields = dict(config=f"small@{DATA_SIZE} v-prediction, teacher: the {STUDENT} weights",
                  recipe={k_: list(v) if isinstance(v, tuple) else v
                          for k_, v in DISTILL_RECIPE.items()},
                  consistency=DISTILL_CONSISTENCY, batch=8, lr=DISTILL_LR,
                  timed_loader="create_dataloaders(device_cache=True)", runs=runs,
                  cli={"exit": proc.returncode, "seconds": cli_s, "pairs": list(DISTILL_CLI_PAIRS),
                       "files": files["student_final"], "served": list(served.shape)},
                  seconds=time.perf_counter() - t0)
    emit("distill", **fields)
    return fields


# the int8 phases (19-21): the int8 convolution kernels, int8_act serving, QAT
INT8_OPS_PER_S = 1.979e15     # H100 SXM dense int8 on the tensor cores
QCONVS_PER_UNET_CALL = 83     # small UNet: 22 depthwise, 61 dense
DEPTHWISE_PER_UNET_CALL = 22
# (Cin, kernel, H = W, batch, Cout) of the adversarial accumulations: every
# input at its amax, one output channel's weights at 127 but its last at
# 126, so an interior sum 127·(127·(K − 1) + 126) is odd and past 2**24;
# the first two in a few output tiles, the third in many
INT8_ADVERSARIAL = ((2048, 1, 8, 1, 8), (256, 3, 8, 1, 8), (1152, 1, 32, 8, 128))
# an output channel's first 9 weights for the weight pass: absmax 127, so
# s_w = 127 · float(1/127) = 1 and the other eight land on exact halves,
# which round half to even
INT8_HALVES = (127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 126.5, -125.5)
# edge shapes of the int8 kernels beside the UNet's (depthwise, Cin, Cout,
# kernel, stride, H, W, bias): ragged M, O = 3, Cin = 6, stride 2 on odd H
# and W, channels that are not a multiple of 32, outputs wider than a
# depthwise band (DW_MAX_COLS: column tiles that take their halo from the
# next tile's columns); each at batch 1 and 8
INT8_EDGES = ((False, 6, 3, 3, 1, 37, 29, True), (False, 6, 32, 3, 2, 33, 19, True),
              (False, 100, 70, 3, 2, 17, 9, False), (False, 40, 3, 1, 1, 13, 7, True),
              (False, 2048, 256, 1, 1, 5, 3, False), (False, 300, 136, 3, 1, 11, 11, True),
              (True, 12, 12, 3, 1, 9, 7, False), (True, 40, 40, 3, 2, 17, 9, False),
              (True, 100, 100, 3, 2, 33, 31, True), (True, 2048, 2048, 3, 1, 5, 3, False),
              (True, 32, 32, 3, 1, 5, 300, False), (True, 40, 40, 3, 2, 7, 601, True),
              (False, 32, 48, 3, 1, 5, 300, True))
# each calibrated amax of the student against JAX's (relative): 45 of the
# 83 equal (the 44 bound, init_conv), the deepest up to 5.4e-3 off (on an
# H100): float32 rounding of the float work between int8 convolutions puts
# some values on the other side of a quantization boundary, and the
# maxima of the layers after move (the CPU tests pin it in float64)
INT8_SCALE_TOL = 1e-2
# the int8_act package's per-image metrics against JAX's int8_act package:
# set from readings on an H100: the port's int8_act at most 0.063
# dB, 2.2e-3, 3.7e-4, 1.5e-3, 4.7e-3 from JAX's, the fp32 model (the
# control) 5.57 dB, 0.40, 0.023, 0.11, 0.051: each bound ~2-3x above the
# first and 5-30x below the second
INT8_EVAL_TOL = {"psnr": 0.2, "ssim": 1e-2, "mae": 2e-3, "ms_ssim": 1e-2, "gmsd": 1e-2}
# QAT at batch 2 against JAX's losses and gradient norms (relative), per
# setting (read on an H100): qat 1.2e-5, 1.8e-5, 2.0e-5; qat_act 1.7e-3,
# 6.3e-3, 1.7e-2, its fake-quantized activations putting some values on
# the other side of a rounding boundary of their grid; the plain float
# step, the control, 0.14-0.49 off in both
QAT_TOL = {"qat": {"loss": 1e-4, "grad_global_norm": 2e-4, "grad_norm": 5e-4},
           "qat_act": {"loss": 5e-3, "grad_global_norm": 2e-2, "grad_norm": 5e-2}}
QAT_STEPS = 12                # train_model with qat_act: 96 pairs at batch 8
QAT_CLI_PAIRS = 16            # the CLI's 2 steps


def build_dir() -> str:
    from cv_diffusion_tpu_torch.ops import cuda_build
    return cuda_build.BUILD_DIR


def qconv_work(kind, x, out, cin=None, k=1):
    """(bytes, int8 operations or float32 operations, rate) of one entry's
    call: each input read once, each output written once, of the real
    channels only (the zeros that pad them to ``CHANNEL_MULTIPLE`` are the
    port's layout, not the function's). ``x``: quantize's float NCHW input,
    or the dense and depthwise entries' padded int8 ``xq``."""
    if kind == "quantize":       # the float input, its int8 values (N·H·W·C)
        return x.numel() * (x.element_size() + 1), 4 * x.numel(), F32_FLOPS_PER_S
    if kind == "quantize_weight":   # the float32 weight, its int8 values and s_w
        return x.numel() * (x.element_size() + 1) + 4 * x.shape[0], 4 * x.numel(), F32_FLOPS_PER_S
    n, o, oh, ow = out.shape
    if kind == "depthwise":      # C = O channels in, 9·C weights
        moved = x.numel() // x.shape[-1] * o + 9 * o + out.numel() * out.element_size()
        return moved, 2 * n * oh * ow * o * 9, INT8_OPS_PER_S
    moved = x.numel() // x.shape[-1] * cin + o * k * k * cin + out.numel() * out.element_size()
    return moved, 2 * n * oh * ow * o * cin * k * k, INT8_OPS_PER_S


def qconv_bound(moved, ops, rate):
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def int_mm_call(xq, wq, stride, padding, cin, k):
    """The library yardstick of a dense entry: ``torch._int_mm`` on the
    input im2col'd with ``F.unfold`` (int8 → float for the unfold, back to
    int8: exact), padded to its shape rule (rows > 16, K and N multiples of
    8; B column-major). Returns (the call, its int32 result [M, O])."""
    import torch
    import torch.nn.functional as F
    n, h, w, cp = xq.shape
    o = wq.shape[0]
    cols = F.unfold(xq[..., :cin].permute(0, 3, 1, 2).float(), k, padding=padding,
                    stride=stride)                              # [N, cin·k·k, L]
    a = cols.permute(0, 2, 1).reshape(-1, cin * k * k)
    kk = -(-a.shape[1] // 8) * 8
    m = max(a.shape[0], 17)
    a_pad = torch.zeros((m, kk), dtype=torch.int8, device=xq.device)
    a_pad[:a.shape[0], :a.shape[1]] = a.to(torch.int8)
    # wq [O, k, k, Cp] → [cin·k·k, O] in unfold's order (channel, then tap)
    b = wq[..., :cin].permute(0, 3, 1, 2).reshape(o, -1)
    nn_ = -(-o // 8) * 8
    b_pad = torch.zeros((nn_, kk), dtype=torch.int8, device=xq.device)
    b_pad[:o, :b.shape[1]] = b
    bt = b_pad.t()                                              # column-major [K, N]
    return (lambda: torch._int_mm(a_pad, bt)), a.shape[0]


def qconv_build_report(built, qk) -> dict:
    """The int8 library's ``build`` fields: registers, static shared memory
    and spills of each instance (0 spills required in the dense, depthwise
    and quantize kernels), the dynamic shared memory of each dense tile,
    and the dense kernels on the tensor cores (``IMMA`` in their SASS, no
    ``IDP4A``)."""
    from cv_diffusion_tpu_torch.ops import cuda_build

    report = ptxas_report(built.log)
    new = {k: v for k, v in report.items() if k.startswith(("dense_", "depthwise_"))}
    require(len(new) == 2 * len(qk.DENSE_TILES) + 4,     # depthwise: f32, bf16 × stride
            f"int8: ptxas reports {sorted(new)}")
    quant = {k: v for k, v in report.items() if k.startswith("quantize_")}
    require(sorted(quant) == ["quantize_kernel<bf16>", "quantize_kernel<float>",
                              "quantize_weight_kernel<false>",
                              "quantize_weight_kernel<true>"],
            f"int8: ptxas reports {sorted(quant)}")
    new.update(quant)
    spilled = {k: v for k, v in new.items() if v["spill_bytes"]}
    require(not spilled, f"int8 kernels spill: {spilled}")
    qlib = cuda_build.load(qk.SOURCE, qk._declare)
    fields = {"kernels": report}
    fields["dense_dynamic_smem_bytes"] = {
        f"{t}:{bm}x{bn}": [qlib.qconv_dense_smem_bytes(t, bf) for bf in (0, 1)]
        for t, (bm, bn, _, _) in enumerate(qk.DENSE_TILES)}
    sass = sass_counts(built.path)
    fields["sass"] = sass if sass is None else {
        k: v for k, v in sass.items() if k.startswith(("dense_", "depthwise_"))}
    if sass is not None:
        dense = {k: v for k, v in sass.items() if k.startswith("dense_")}
        require(len(dense) == 2 * len(qk.DENSE_TILES)
                and all(v["IMMA"] + v["IGMMA"] > 0 and v["IDP4A"] == 0
                        for v in dense.values()),
                f"int8 dense kernels not on the tensor cores: {dense}")
    return fields


def int8_kernel_phase(dev, qk, cuda_ms, graph_ms, cfg, weights) -> dict:
    """Phase 19: each int8 entry against its plain version, bit for bit, at
    every QConv shape class of the small UNet at 256² and at the edge shapes
    (``INT8_EDGES``; B = 1 and 8, float32 and bf16 compute) on random
    inputs, each launch's plan held to the library's shared memory; and on
    the adversarial accumulations, where float32 must differ. Returns the
    ``int8`` line."""
    import torch
    import torch.nn.functional as F
    from cv_diffusion_tpu_torch.export.quantization import act_quant_model, qconv_modules
    from cv_diffusion_tpu_torch.ops import cuda_build
    from cv_diffusion_tpu_torch.ops import qconv as tq

    t0 = time.perf_counter()
    model, _ = act_quant_model(cfg, dev)
    model.load_state_dict(weights, strict=True)
    classes, calls = {}, []   # (depthwise, cin, cout, k, stride, H, W, bias) → a module

    def shape_class(mod, args):
        calls.append(mod)
        classes.setdefault((mod.depthwise, mod.in_channels, mod.out_channels,
                            mod.kernel_size[0], mod.stride[0], args[0].shape[2],
                            args[0].shape[3], mod.bias is not None), mod)

    hooks = [m.register_forward_pre_hook(shape_class) for m in qconv_modules(model).values()]
    size = cfg.unet.image_size
    with torch.inference_mode():
        model.unet(torch.zeros(1, cfg.unet.in_channels, size, size, device=dev),
                   torch.tensor([739], dtype=torch.int32, device=dev))
    for h in hooks:
        h.remove()
    require(len(calls) == QCONVS_PER_UNET_CALL,
            f"int8: {len(calls)} QConvs a UNet call, not {QCONVS_PER_UNET_CALL}")
    gen = torch.Generator(device=dev).manual_seed(19)
    checked = {"quantize": 0, "quantize_weight": 0, "dense": 0, "depthwise": 0}

    def weight_pass(w, dw):
        """The weight kernel against its plain version (quantize_weight, then
        the layout), bit for bit; returns the plain (wq, s_w)."""
        wq, s_w = tq.quantize_weight(w)
        want = (tq.depthwise_weight_layout if dw else tq.dense_weight_layout)(wq)
        got, got_s = qk.quantize_weight(w, dw)
        torch.cuda.synchronize()
        require(torch.equal(got, want) and torch.equal(got_s, s_w),
                f"int8 weight pass {tuple(w.shape)} depthwise {dw}: kernel != plain "
                f"({int((got != want).sum())} values, {int((got_s != s_w).sum())} scales)")
        checked["quantize_weight"] += 1
        return wq, s_w

    cases = list(classes.items())
    for dw, cin, cout, k, stride, h, w, bias in INT8_EDGES:
        edge = SimpleNamespace(
            weight=torch.randn((cout, 1 if dw else cin, k, k), generator=gen, device=dev),
            bias=torch.randn((cout,), generator=gen, device=dev) if bias else None)
        cases.append(((dw, cin, cout, k, stride, h, w, bias), edge))
    qlib = cuda_build.load(qk.SOURCE, qk._declare)
    plans = {"dense": set(), "depthwise": set(), "quantize": set()}
    for (dw, cin, cout, k, stride, h, w, bias), mod in cases:
        wq, s_w = weight_pass(mod.weight.detach(), dw)
        for b in (1, 8):
            cp = tq.padded_channels(cin)
            for dt in (torch.float32, torch.bfloat16):
                bf = int(dt == torch.bfloat16)
                if dw:
                    p = qk.plan_depthwise(b, h, w, cp, stride)
                    lib_smem = qlib.qconv_depthwise_smem_bytes(p.rows, p.cols, stride)
                    plans["depthwise"].add((p.rows, p.cols))
                else:
                    p = qk.plan_dense(b, h, w, cp, cout, k, stride, k // 2, dt)
                    lib_smem = qlib.qconv_dense_smem_bytes(p.tile, bf)
                    plans["dense"].add(p.tile)
                require(lib_smem == p.smem_bytes <= qk.SMEM_MAX,
                        f"int8 plan {p} against the library's {lib_smem} bytes")
                x = (torch.randn((b, cin, h, w), generator=gen, device=dev) * 2).to(dt)
                amax = x.float().abs().amax() * 0.75          # some inputs clip
                pq = qk.quantize_launch(b, cin, h * w, dt)
                plans["quantize"].add(("vector" if pq.vectorized else "element", pq.vec))
                xq = qk.quantize(x, amax)
                require(torch.equal(xq, tq.quantize_plain(x, amax)),
                        f"int8 quantize {b, cin, h, w} {dt}: kernel != plain")
                bvec = None if mod.bias is None else mod.bias.detach().to(dt)
                if dw:
                    wl = tq.depthwise_weight_layout(wq)
                    got = qk.int8_depthwise(xq, wl, cout, amax, s_w, bvec, stride, dt)
                    want = tq.int8_depthwise_plain(xq, wl, cout, amax, s_w, bvec, stride, dt)
                else:
                    wl = tq.dense_weight_layout(wq)
                    got = qk.int8_conv(xq, wl, amax, s_w, bvec, stride, k // 2, dt)
                    want = tq.int8_conv_plain(xq, wl, amax, s_w, bvec, stride, k // 2, dt)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"int8 {'depthwise' if dw else 'dense'} {b, cin, cout, k, stride, h, w} "
                        f"{dt}: max |kernel − plain| {float((got.float() - want.float()).abs().max())}")
                checked["quantize"] += 1
                checked["depthwise" if dw else "dense"] += 1
    del model
    adversarial = []
    for cin, k, hw, b, cout in INT8_ADVERSARIAL:
        x = torch.full((b, cin, hw, hw), 3.0, device=dev)
        amax = torch.tensor(3.0, device=dev)
        w = torch.randn((cout, cin, k, k), generator=gen, device=dev) * 0.05
        w[0] = 1.0
        w[0, -1, -1, -1] = 126.0 / 127.0
        wq, s_w = weight_pass(w, False)
        require(int(wq[0, -1, -1, -1]) == 126 and int((wq[0] == 127).sum()) == cin * k * k - 1,
                f"int8 adversarial {cin}x{k}: weights {wq[0].flatten()[-3:].tolist()}")
        xq = qk.quantize(x, amax)
        wl = tq.dense_weight_layout(wq)
        exact = 127 * (127 * (cin * k * k - 1) + 126)
        for dt in (torch.float32, torch.bfloat16):
            got = qk.int8_conv(xq, wl, amax, s_w, None, 1, k // 2, dt)
            want = tq.int8_conv_plain(xq, wl, amax, s_w, None, 1, k // 2, dt)
            require(torch.equal(got, want), f"int8 adversarial {cin}x{k} {dt}: kernel != plain")
        acc = tq.int8_acc_plain(xq, wl, 1, k // 2)
        f32 = F.conv2d(xq.permute(0, 3, 1, 2).float(), wq.float(), padding=k // 2)
        torch.cuda.synchronize()
        require(float(acc[0, 0, 4, 4]) == exact and exact % 2 == 1 and exact > 2 ** 24,
                f"int8 adversarial {cin}x{k}: exact sum {float(acc[0, 0, 4, 4])} != {exact}")
        control = float(f32[0, 0, 4, 4])
        require(control != exact, f"int8 adversarial {cin}x{k}: float32 conv gave the exact "
                                  f"{exact}: the control does not fail")
        plan = qk.plan_dense(b, hw, hw, cin, cout, k, 1, k // 2, torch.float32)
        adversarial.append(dict(cin=cin, kernel=k, k=cin * k * k, hw=hw, batch=b, cout=cout,
                                tile=plan.tile, exact_sum=exact,
                                float32_conv=control, kernel_equals_plain=True))
    # the weight pass on an all-zero output channel (s_w = 1e-12, every
    # value 0) and on a channel whose w / s_w lands on exact halves (its
    # absmax 127, so s_w = 1: round half to even), dense and depthwise
    special = {}
    for dw, (o, i) in ((False, (4, 6)), (True, (40, 1))):
        w = torch.randn((o, i, 3, 3), generator=gen, device=dev) * 0.01
        w[0] = 0.0
        w[1].view(-1)[:9] = torch.tensor(INT8_HALVES, device=dev)
        wq, s_w = weight_pass(w, dw)
        quot = w[1] / s_w[1]
        halves = int((quot - quot.floor() == 0.5).sum())
        torch.cuda.synchronize()
        require(float(s_w[0]) == float(torch.tensor(tq.WEIGHT_SCALE_FLOOR)) and not bool(wq[0].any())
                and halves == len(INT8_HALVES) - 1,
                f"int8 weight pass special channels: s_w {s_w[:2].tolist()}, {halves} halves")
        special["depthwise" if dw else "dense"] = dict(
            shape=[o, i, 3, 3], zero_channel_s_w=float(s_w[0]), exact_halves=halves,
            rounded=wq[1].flatten()[:9].tolist())
    fields = dict(classes=len(classes), edges=len(INT8_EDGES), checked=checked,
                  weight_special=special,
                  plans={k: sorted(v) for k, v in plans.items()}, batches=[1, 8],
                  dtypes=["float32", "bfloat16"], bit_for_bit=True, adversarial=adversarial,
                  seconds=time.perf_counter() - t0)
    emit("int8", **fields)
    return fields


def depthwise_library_call(xq, wq, channels, stride):
    """The library yardstick of a depthwise entry: one float32 cuDNN
    depthwise ``F.conv2d`` of the int8 values (TF32 off), exact as every
    sum is at most 9·127² < 2**24. Returns (the call, its int32 result)."""
    import torch
    import torch.nn.functional as F
    x = xq[..., :channels].permute(0, 3, 1, 2).float()
    w = wq[:, :channels].t().reshape(channels, 1, 3, 3).float()

    def call():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv2d(x, w, stride=stride, padding=1, groups=channels)
    return call, call().to(torch.int32)


def int8_timings(dev, qk, cuda_ms, graph_ms, captured) -> dict:
    """Each entry's time summed over one UNet call's QConvs (``captured``:
    (module, input) of each, in call order), beside its plain version's,
    its bound and its library yardstick (dense: ``torch._int_mm``;
    depthwise: a float32 cuDNN depthwise convolution; both checked exact on
    these inputs); every kernel output checked against the plain version on
    these inputs first. ``per_shape``: the dense and depthwise rows by
    shape class (depthwise, Cin, Cout, kernel, stride, H, W)."""
    import torch
    from cv_diffusion_tpu_torch.ops import qconv as tq

    sums = {e: defaultdict(float) for e in ("quantize", "quantize_weight", "dense", "depthwise")}
    shapes = defaultdict(lambda: defaultdict(float))
    for mod, x in captured:
        x = x.contiguous()       # as QConv hands it to the kernel
        amax = mod.amax_eff(x)
        dt = mod.out_dtype()
        wt, dw = mod.weight.detach(), mod.depthwise
        wq, s_w = tq.quantize_weight(wt)
        layout = tq.depthwise_weight_layout if dw else tq.dense_weight_layout
        got_l, got_s = qk.quantize_weight(wt, dw)
        require(torch.equal(got_l, layout(wq)) and torch.equal(got_s, s_w),
                "request weight pass != plain")
        bvec = None if mod.bias is None else mod.bias.detach().to(dt)
        xq = qk.quantize(x, amax)
        require(torch.equal(xq, tq.quantize_plain(x, amax)), "request quantize != plain")
        entries = [("quantize", lambda: qk.quantize(x, amax), lambda: tq.quantize_plain(x, amax),
                    qconv_work("quantize", x, xq)),
                   ("quantize_weight", lambda: qk.quantize_weight(wt, dw),
                    lambda: layout(tq.quantize_weight(wt)[0]),
                    qconv_work("quantize_weight", wt, got_l))]
        k, s, p = mod.kernel_size[0], mod.stride[0], mod.padding[0]
        c = mod.out_channels
        if mod.depthwise:
            wl = tq.depthwise_weight_layout(wq)
            got = qk.int8_depthwise(xq, wl, c, amax, s_w, bvec, s, dt)
            want = tq.int8_depthwise_plain(xq, wl, c, amax, s_w, bvec, s, dt)
            entries.append(("depthwise", lambda: qk.int8_depthwise(xq, wl, c, amax, s_w, bvec, s, dt),
                            lambda: tq.int8_depthwise_plain(xq, wl, c, amax, s_w, bvec, s, dt),
                            qconv_work("depthwise", xq, got)))
            lib, acc = depthwise_library_call(xq, wl, c, s)
            require(torch.equal(acc, tq.int8_depthwise_acc_plain(xq, wl, c, s)),
                    "the float32 cuDNN depthwise convolution is not the exact sum")
        else:
            wl = tq.dense_weight_layout(wq)
            got = qk.int8_conv(xq, wl, amax, s_w, bvec, s, p, dt)
            want = tq.int8_conv_plain(xq, wl, amax, s_w, bvec, s, p, dt)
            entries.append(("dense", lambda: qk.int8_conv(xq, wl, amax, s_w, bvec, s, p, dt),
                            lambda: tq.int8_conv_plain(xq, wl, amax, s_w, bvec, s, p, dt),
                            qconv_work("dense", xq, got, mod.in_channels, k)))
            lib, rows = int_mm_call(xq, wl, s, p, mod.in_channels, k)
            acc = lib()[:rows, :c]
            exact = tq.int8_acc_plain(xq, wl, s, p)
            require(torch.equal(acc, exact.permute(0, 2, 3, 1).reshape(rows, -1)),
                    "torch._int_mm on the im2col'd operands is not the exact sum")
        require(torch.equal(got, want), "request conv: kernel != plain")
        name = entries[-1][0]
        library_ms = cuda_ms(lib, iters=50, warmup=5)
        sums[name]["library_ms"] += library_ms
        shape = shapes[(mod.depthwise, mod.in_channels, c, k, s, x.shape[2], x.shape[3])]
        shape["library_ms"] += library_ms
        for entry, kernel, plain, (moved, ops, rate) in entries:
            bnd, _ = qconv_bound(moved, ops, rate)
            row = sums[entry]
            row["ms"] += cuda_ms(kernel, iters=50, warmup=5)
            g_ms = graph_ms(kernel, iters=50, warmup=5)
            row["graph_ms"] += g_ms
            row["plain_ms"] += cuda_ms(plain, iters=2, warmup=1)
            row["bound_ms"] += bnd
            row["bytes"] += moved
            row["ops"] += ops
            row["calls"] += 1
            if entry == name:
                shape["graph_ms"] += g_ms
                shape["bound_ms"] += bnd
                shape["calls"] += 1
            else:
                shape[f"{entry}_graph_ms"] += g_ms
                shape[f"{entry}_bound_ms"] += bnd
    for name, row in sums.items():
        t_bytes = row["bytes"] / HBM_BYTES_PER_S
        t_ops = row["ops"] / (F32_FLOPS_PER_S if name.startswith("quantize") else INT8_OPS_PER_S)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    out = {k: dict(v) for k, v in sums.items()}
    out["per_shape"] = sorted(
        ({"depthwise": key[0], "cin": key[1], "cout": key[2], "kernel": key[3],
          "stride": key[4], "hw": [key[5], key[6]], **v} for key, v in shapes.items()),
        key=lambda r: -r["graph_ms"])
    return out


def traced_kernels(fn, calls: int, traces: int = 4) -> list:
    """(name, start µs, end µs) of each device activity (kernels, copies,
    fills) of ``calls`` calls of ``fn`` under torch.profiler, in start
    order. The profiler now and then drops events, never adds one
    (:func:`device_kernels`): the trace that read the most counts, and one
    that reads a whole multiple of ``calls`` ends the search."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(traces):
        with trace(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)),
                        key=lambda e: e[1])
        if len(events) > len(best):
            best = events
        if events and len(events) % calls == 0:
            break
        time.sleep(0.2)
    return best


def replayed_name(name: str) -> str:
    """A device activity's name with copies and fills by kind: an eager
    ``Memcpy DtoD`` replays in a CUDA graph as a ``memcpy32_post`` kernel."""
    low = name.lower()
    return "memcpy" if "memcpy" in low else "memset" if "memset" in low else name


def weight_pass_kernels(weight_pass, mods) -> list:
    """The kernels (sorted :func:`replayed_name`s) that
    ``weight_pass(module)`` runs for one of ``mods`` of each kind, each kind
    once: traced eagerly over 20 calls, as :func:`device_kernels` does."""
    import torch

    kinds = {}        # the weight pass's kernels depend on these
    for m in mods:
        kinds.setdefault((m.depthwise, m.kernel_size[0], m.in_channels % 32, m.out_channels % 32), m)
    sigs = []
    for mod in kinds.values():
        with torch.inference_mode():
            names = device_kernels(lambda: weight_pass(mod), calls=20)
        sig = sorted(replayed_name(n) for n, c in names.items() for _ in range(round(c)))
        if sig and sig not in sigs:
            sigs.append(sig)
    return sigs


def int8_trace(graphs, weight_pass, mods, replays: int = 5) -> dict:
    """Where an int8 replay's device time goes: torch.profiler over
    ``replays`` back-to-back replays of each of the int8_act pipeline's CUDA
    graphs (``graphs``: batch size → SamplerGraph), per replay the device
    kernels and device ms in groups, and the device's idle share between
    the first kernel's start and the last one's end. Groups: ``quantize``
    (the activations'), ``weight_pass`` (what quantizes and lays out a
    QConv's weight: the ``quantize_weight`` kernel, or, on a tree whose
    QConvs run the plain chain, the kernels that ``weight_pass(module)``
    runs alone for one of ``mods`` (the pipeline's QConvs) of each kind,
    found in the replay around each activation quantize, their names
    checked), ``dense``, ``depthwise``, ``attention`` and the rest, the
    weight pass and the rest also by kernel name."""
    sigs = []

    def group(name):
        if "quantize_weight" in name:
            return "weight_pass"
        if "quantize_kernel" in name:
            return "quantize"
        if "dense_kernel" in name:
            return "dense"
        if "depthwise_kernel" in name:
            return "depthwise"
        if "linear_attention" in name:
            return "attention"
        return "rest"

    out = {}
    for b, g in sorted(graphs.items()):
        events = traced_kernels(g.graph.replay, replays)
        require(bool(events), f"int8_trace: no device kernels in the batch-{b} replays")
        groups = [group(n) for n, _, _ in events]
        matched = groups.count("weight_pass")
        if not matched:
            # the plain chain: a QConv's weight pass runs around its
            # activation quantize and before its convolution: every other
            # kernel between the quantize and the convolution, then as many
            # as the pass has left just before the quantize (or before the
            # copy that makes x contiguous, where there is one); their names
            # must be the pass's
            if not sigs:
                sigs = weight_pass_kernels(weight_pass, mods)
            for i, gr in enumerate(groups):
                if gr != "quantize":
                    continue
                j = next((j for j in range(i + 1, len(groups))
                          if groups[j] in ("dense", "depthwise")), None)
                if j is None:
                    continue
                after = [x for x in range(i + 1, j) if groups[x] == "rest"]
                for sig, gap in ((sig, gap) for gap in (0, 1) for sig in sigs):
                    end = i - gap
                    before = list(range(max(end - (len(sig) - len(after)), 0), end))
                    window = before + after
                    if (len(window) == len(sig) and all(groups[x] == "rest" for x in window)
                            and sorted(replayed_name(events[x][0]) for x in window) == sig):
                        for x in window:
                            groups[x] = "weight_pass"
                        matched += 1
                        break
        sums = defaultdict(lambda: [0, 0.0])
        by_name = {"weight_pass": defaultdict(lambda: [0, 0.0]), "rest": defaultdict(lambda: [0, 0.0])}
        for (name, s, e), gr in zip(events, groups):
            sums[gr][0] += 1
            sums[gr][1] += e - s
            if gr in by_name:
                by_name[gr][name][0] += 1
                by_name[gr][name][1] += e - s
        busy, active = busy_us([(s, e) for _, s, e in events])

        def named(d, top=None):
            rows = sorted(d.items(), key=lambda kv: -kv[1][1])[:top]
            return [{"name": n[:100], "kernels": c / replays, "ms": t / 1e3 / replays}
                    for n, (c, t) in rows]

        out[b] = dict(replays=replays, kernels=len(events) / replays,
                      device_ms=sum(v[1] for v in sums.values()) / 1e3 / replays,
                      span_ms=active / 1e3 / replays, idle_share=1 - busy / active,
                      groups={k: {"kernels": v[0] / replays, "ms": v[1] / 1e3 / replays}
                              for k, v in sorted(sums.items(), key=lambda kv: -kv[1][1])},
                      weight_pass_kernels_a_qconv=sorted({len(v) for v in sigs}) or [1],
                      weight_pass_found=matched / replays,
                      weight_pass_by_name=named(by_name["weight_pass"]),
                      rest_by_name=named(by_name["rest"], 10))
    return out


def int8_act_phase(dev, qk, cuda_ms, graph_ms, cfg, weights, images, batch_images,
                   reset_launches, all_launches) -> dict:
    """Phase 20: PTQ calibration of the student on the card against JAX's
    scales, the inputs of a request's 83 QConvs through every entry against
    the plain versions (and the entries timed over a UNet call at B = 1 and
    8), the int8_act package written, loaded and evaluated against JAX's
    int8_act package (the fp32 package the control), served beside fp32
    (graph 0 LSB from eager; no fused IRB under act_quant), and the export
    CLI. Returns the fields of the kernels line's int8 entries."""
    import numpy as np
    import torch
    from cv_diffusion_tpu_torch import evaluate as ev
    from cv_diffusion_tpu_torch.data.augment import normalize
    from cv_diffusion_tpu_torch.data.synthetic import make_split
    from cv_diffusion_tpu_torch.evaluate import sha256
    from cv_diffusion_tpu_torch.export.quantization import (
        act_quant_model, act_scales, calibrate_act_scales, qconv_modules)
    from cv_diffusion_tpu_torch.export.serving import (ServingPipeline,
                                                       create_serving_package,
                                                       load_serving_package)
    from cv_diffusion_tpu_torch.models.diffusion import enhance
    from cv_diffusion_tpu_torch.ops.qconv import QConv

    t0 = time.perf_counter()
    with open(os.path.join(ROOT, "artifacts_torch", f"{STUDENT}.int8act_ref.json")) as f:
        ref = json.load(f)
    cal = ref["calibration"]
    n_pairs = cal["batches"] * 8
    n_split, size_split, seed_split = map(int, re.search(
        r"make_split\((\d+), (\d+), (\d+)\)", cal["split"]).groups())
    require(n_split == n_pairs and size_split == ref["size"], f"int8_act: {cal['split']}")
    low_u8, high_u8 = make_split(n_pairs, ref["size"], seed_split)
    require(sha256(low_u8) == cal["split_low_sha256"] and sha256(high_u8) == cal["split_high_sha256"],
            "int8_act: the calibration split differs from the reference's")
    batches, draws = [], []
    for i in range(cal["batches"]):
        d = reference_draws(cal["draw_seed"], i, cal["draws"])
        require([sha256(a) for a in d] == cal["draws_sha256"][i],
                f"int8_act: calibration batch {i}'s numpy draws differ from the reference's")
        sl = slice(8 * i, 8 * i + 8)
        batches.append({"low_light": normalize(low_u8[sl]), "normal_light": normalize(high_u8[sl])})
        draws.append((d[0], d[1]))
    qmodel, schedule = act_quant_model(cfg, dev)
    qmodel.load_state_dict(weights, strict=True)
    a = time.perf_counter()
    scales = calibrate_act_scales(qmodel, schedule, batches, draws=draws)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - a
    want = {r["module"]: r["amax"] for r in ref["act_scales"]}
    require(set(scales) == set(want) and len(want) == QCONVS_PER_UNET_CALL,
            f"int8_act: {len(scales)} scales against the reference's {len(want)}")
    rel = {n: abs(float(scales[n]) / want[n] - 1) for n in want}
    bound = [n for n, m in qconv_modules(qmodel).items() if m.act_bound is not None]
    require(all(float(scales[n]) == 6.0 for n in bound) and len(bound) == 44,
            f"int8_act: {len(bound)} statically bound QConvs")
    worst = max(rel, key=rel.get)
    emit("int8_act_calibration", batches=cal["batches"], batch=8, scales=len(scales),
         calibrated=len(scales) - len(bound), static_bound=len(bound),
         max_rel_err=rel[worst], worst=worst, equal_to_jax=sum(v == 0 for v in rel.values()),
         median_rel_err=float(np.median(list(rel.values()))),
         over_1e3=sum(v > 1e-3 for v in rel.values()),
         tol=INT8_SCALE_TOL, seconds=calib_s)
    require(rel[worst] <= INT8_SCALE_TOL,
            f"int8_act: {worst}'s amax {float(scales[worst])} is {rel[worst]} from JAX's {want[worst]}")

    # the package: bf16 weights and the scales, loaded back
    pkg = os.path.join(build_dir(), "packages", "int8_act")
    shutil.rmtree(pkg, ignore_errors=True)
    fp32 = ServingPipeline.from_artifact(STUDENT, dev, batch_size=8)
    a = time.perf_counter()
    files = create_serving_package(pkg, fp32.model, fp32.schedule, quantize="int8_act",
                                   act_scales=scales, timesteps=fp32.grid)
    write_s = time.perf_counter() - a
    a = time.perf_counter()
    pmodel, pschedule, state, meta = load_serving_package(pkg, dev)
    load_s = time.perf_counter() - a
    require(meta["quantization"] == "int8_act" and pmodel.config.unet.act_quant is True
            and all(torch.equal(state[k], v.to(torch.bfloat16).float())
                    for k, v in fp32.model.state_dict().items())
            and all(torch.equal(v, scales[k]) for k, v in act_scales(pmodel).items()),
            "int8_act: the loaded package is not the bf16 weights and the scales")

    # a request's own QConv inputs (B = 1) and a batch's (B = 8), eager
    captured = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: captured.append((mod, args[0])))
             for m in pmodel.modules() if isinstance(m, QConv)]
    grid = fp32.grid
    timings = {}
    for b, imgs in ((1, images[:1]), (8, batch_images)):
        captured.clear()
        canvas = torch.cat([fp32.pre(im)[0] for im in imgs])
        out = enhance(pmodel, pschedule, canvas.float() / 127.5 - 1.0, timesteps=grid,
                      generator=torch.Generator(device=dev).manual_seed(b), device=dev)
        require(len(captured) == QCONVS_PER_UNET_CALL * len(grid) and bool(torch.isfinite(out).all()),
                f"int8_act: {len(captured)} QConv inputs caught at batch {b}")
        timings[b] = int8_timings(dev, qk, cuda_ms, graph_ms, captured)
    for h in hooks:
        h.remove()
    captured.clear()
    emit("int8_request", qconvs=QCONVS_PER_UNET_CALL, bit_for_bit=True,
         per_unet_call={b: t for b, t in timings.items()})

    # quality: the 15 pairs against JAX's int8_act package; the fp32 model,
    # the control, must fail the same bounds
    eval_low, eval_high = ev.eval_split(15, ref["size"], 0)
    eval_init, eval_step = ev.eval_noise(15, ref["size"], 0, len(grid))
    hashes = ev.input_hashes(eval_low, eval_high, eval_init)
    require([h["low"] for h in hashes] == [im["low_sha256"] for im in ref["eval"]["images"]]
            and [h["noise"] for h in hashes] == [im["noise_sha256"] for im in ref["eval"]["images"]],
            "int8_act eval: the inputs differ from the reference's")
    target = ev.target_unit(eval_high, dev)
    quality = {}
    for label, model, sch in (("int8_act", pmodel, pschedule), ("fp32_control", fp32.model, fp32.schedule)):
        reset_launches()
        pred = ev.enhance_split(model, sch, eval_low, eval_init, eval_step, grid, device=dev)
        per = ev.per_image_metrics(pred, target)
        counts = all_launches()
        deltas = {k: [abs(v - im[k]) for v, im in zip(per[k], ref["eval"]["images"])]
                  for k in INT8_EVAL_TOL}
        quality[label] = dict(mean={k: float(np.mean(per[k])) for k in INT8_EVAL_TOL},
                              max_abs_delta={k: max(v) for k, v in deltas.items()},
                              worst_image={k: int(np.argmax(v)) for k, v in deltas.items()},
                              launches=counts, per_image=per)
    emit("int8_act_eval", images=15, tol=INT8_EVAL_TOL, jax_psnr_mean=ref["eval"]["psnr_mean"],
         **{k: {f: v[f] for f in ("mean", "max_abs_delta", "worst_image", "launches")}
            for k, v in quality.items()})
    sound = quality["int8_act"]["max_abs_delta"]
    control = quality["fp32_control"]["max_abs_delta"]
    require(all(sound[k] <= t for k, t in INT8_EVAL_TOL.items()),
            f"int8_act eval against JAX's int8_act package: {sound} (bounds {INT8_EVAL_TOL})")
    require(any(control[k] > t for k, t in INT8_EVAL_TOL.items()),
            f"int8_act eval: the fp32 control {control} passes the bounds {INT8_EVAL_TOL}")
    calls = -(-15 // ev.BATCH_SIZE) * len(grid)
    require(quality["int8_act"]["launches"] == {
        "linear_attention": calls, "fused_irb_v2": 0, "fused_irb_v1": 0,
        "qconv_quantize": QCONVS_PER_UNET_CALL * calls,
        "qconv_quantize_weight": QCONVS_PER_UNET_CALL * calls,
        "qconv_dense": (QCONVS_PER_UNET_CALL - DEPTHWISE_PER_UNET_CALL) * calls,
        "qconv_depthwise": DEPTHWISE_PER_UNET_CALL * calls},
        f"int8_act eval launches {quality['int8_act']['launches']}")

    # serving: the int8_act package beside fp32 in the same call
    served = {}
    for label, make in (("int8_act", lambda: ServingPipeline.from_package(pkg, device=dev, batch_size=8)),
                        ("fp32", lambda: fp32)):
        pipe = make()
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for i, img in enumerate(images):           # captures batch 1
            pipe(img, seed=i)
        pipe.batch(batch_images, seed=1)            # captures batch 8
        lat = []
        for i in range(10):
            torch.cuda.synchronize()
            a = time.perf_counter()
            out = pipe(images[2], seed=i)
            lat.append((time.perf_counter() - a) * 1e3)
        require(out.shape == images[2].shape and out.dtype == np.uint8, f"{label}: output")
        a = time.perf_counter()
        outs = pipe.batch(batch_images * REPS, seed=400)
        pipelined = time.perf_counter() - a
        require(len(outs) == 8 * REPS, f"{label}: batch outputs")
        lsb = {}
        for b in (1, 8):
            canvas = torch.cat([pipe.pre(im)[0] for im in (images[:1] if b == 1 else batch_images)])
            graph_out = pipe._run(canvas, pipe._generator(7))
            eager_out = pipe.run_eager(canvas, pipe._generator(7))
            lsb[b] = int((graph_out.int() - eager_out.int()).abs().max())
        require(label != "int8_act" or all(v == 0 for v in lsb.values()),
                f"{label}: graph vs eager {lsb} LSB")
        torch.cuda.synchronize()
        served[label] = dict(latency_ms_mean=float(np.mean(lat)), latency_ms_p50=float(np.median(lat)),
                             image=list(images[2].shape), images_per_s=REPS * 8 / pipelined,
                             batch=8, peak_mem_bytes=torch.cuda.max_memory_allocated(),
                             graph_vs_eager_lsb=lsb, launches=all_launches(),
                             launches_a_replay={b: g.launches for b, g in sorted(pipe.graphs.items())},
                             replays={b: g.replays for b, g in sorted(pipe.graphs.items())})
        if label == "int8_act":
            want_replay = {"linear_attention": 1, "fused_irb_v2": 0, "fused_irb_v1": 0,
                           **dict.fromkeys(FLASH_KERNELS, 0),
                           "qconv_quantize": QCONVS_PER_UNET_CALL,
                           "qconv_quantize_weight": QCONVS_PER_UNET_CALL,
                           "qconv_dense": QCONVS_PER_UNET_CALL - DEPTHWISE_PER_UNET_CALL,
                           "qconv_depthwise": DEPTHWISE_PER_UNET_CALL}
            require(all(g.launches == want_replay for g in pipe.graphs.values()),
                    f"int8_act: launches a replay {served[label]['launches_a_replay']}")
            a = time.perf_counter()
            trace = int8_trace(pipe.graphs, lambda m: qk.quantize_weight(m.weight, m.depthwise),
                               [m for m in pipe.model.modules() if isinstance(m, QConv)])
            emit("int8_trace", **{f"batch_{b}": v for b, v in trace.items()},
                 seconds=time.perf_counter() - a)
        del pipe
    # use_pallas_irb is ignored under act_quant: no fused IRB launches
    fused = ServingPipeline.from_package(pkg, device=dev, use_pallas_irb=True)
    reset_launches()
    fused(images[0], seed=0)
    fused_counts = all_launches()
    require(fused_counts["fused_irb_v2"] == 0 and fused_counts["qconv_dense"] > 0,
            f"int8_act with use_pallas_irb: launches {fused_counts}")
    del fused
    served["int8_act_use_pallas_irb"] = dict(launches=fused_counts)
    emit("int8_act_serve", package_bytes={k: os.path.getsize(v) for k, v in files.items()
                                          if os.path.isfile(v)},
         write_s=write_s, load_s=load_s, **served)

    # the export CLI on write_lol's directory (its first 8 pairs)
    root = os.path.join(build_dir(), "export_lol")
    shutil.rmtree(root, ignore_errors=True)
    write_lol(root, splits=(("our485", 8),))
    out_pkg = os.path.join(build_dir(), "packages", "cli_int8_act")
    shutil.rmtree(out_pkg, ignore_errors=True)
    a = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cv_diffusion_tpu_torch.export",
         "--checkpoint", os.path.join("artifacts", STUDENT), "--output", out_pkg,
         "--quantize", "int8_act", "--calib_dir", os.path.join(root, "our485"),
         "--calib_batches", "1", "--device", dev.type],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - a
    require(proc.returncode == 0, f"int8_act: the export CLI exited {proc.returncode}: "
                                  f"{proc.stderr[-2000:]}")
    cli_pipe = ServingPipeline.from_package(out_pkg, device=dev)
    got = cli_pipe(images[0], seed=0)
    require(got.shape == images[0].shape and cli_pipe.model.config.unet.act_quant is True
            and cli_pipe.grid == grid, "int8_act: the CLI's package does not serve")
    del cli_pipe
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(out_pkg, ignore_errors=True)
    emit("int8_act_cli", exit=proc.returncode, seconds=cli_s, calib_pairs=8,
         served=list(got.shape))
    del pmodel, qmodel, fp32
    torch.cuda.empty_cache()
    emit("int8_act_done", seconds=time.perf_counter() - t0)
    return dict(timings=timings, served=served, eval_launches=quality["int8_act"]["launches"])


def qat_phase(dev, lak, cfg, weights, n_attn) -> dict:
    """Phase 21: a ``qat`` and a ``qat_act`` loss and gradient at batch 2 on
    the student against JAX's (the plain float step the control); then
    ``train_model`` with ``qat_act`` (small@256, batch 8, QAT_STEPS steps
    from the device cache) and the train CLI with ``--qat_act``."""
    import numpy as np
    import torch
    from cv_diffusion_tpu_torch.config import TrainConfig
    from cv_diffusion_tpu_torch.data import png
    from cv_diffusion_tpu_torch.data.augment import normalize
    from cv_diffusion_tpu_torch.data.synthetic import make_split
    from cv_diffusion_tpu_torch.evaluate import eval_split, sha256
    from cv_diffusion_tpu_torch.export.qat import fake_quant_params
    from cv_diffusion_tpu_torch.models.diffusion import (create_model, diffusion_loss,
                                                        train_forward)
    from cv_diffusion_tpu_torch.training.trainer import train_model

    t0 = time.perf_counter()
    with open(os.path.join(ROOT, "artifacts_torch", f"{STUDENT}.qat_ref.json")) as f:
        ref = json.load(f)
    b = ref["batch"]
    low_u8, high_u8 = (x[:b] for x in eval_split(15, ref["size"], 0))
    require([sha256(x) for x in low_u8] == ref["inputs"]["low_sha256"]
            and [sha256(x) for x in high_u8] == ref["inputs"]["high_sha256"],
            "qat: the reference's inputs differ")
    low, high = (torch.from_numpy(normalize(x)).to(dev) for x in (low_u8, high_u8))

    def reading(setting, act_quant, fake_weights):
        t, eps = reference_draws(ref["seed"], 0, setting["draws"])
        require([sha256(t), sha256(eps)] == setting["draws_sha256"],
                f"qat {setting['name']}: numpy's draws differ from the reference's")
        model, schedule = create_model(dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, act_quant=act_quant)), device=dev)
        model.load_state_dict(weights, strict=True)
        params = dict(model.named_parameters())
        out = train_forward(model, schedule, low, high, timesteps=torch.from_numpy(t).to(dev),
                            noise=torch.from_numpy(eps).to(dev), train=True,
                            params=fake_quant_params(params, model.config) if fake_weights else None)
        loss = diffusion_loss(out["noise_pred"], out["target"], "mse")
        loss.backward()
        grads = {n: p.grad.double() for n, p in model.named_parameters() if p.grad is not None}
        gnorm = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
        named = {n: float(grads[n].norm()) for n in setting["grad_norms"]}
        return loss.item(), gnorm, {
            "loss": abs(loss.item() - setting["loss"]) / abs(setting["loss"]),
            "grad_global_norm": abs(gnorm - setting["grad_global_norm"]) / setting["grad_global_norm"],
            "grad_norm": max(abs(named[n] - v) / v for n, v in setting["grad_norms"].items())}

    against = {}
    for setting in ref["settings"]:
        if setting["name"] == "float":
            continue
        loss, gnorm, errs = reading(setting, setting["act_quant"], True)
        _, _, control = reading(setting, False, False)      # the plain float step
        against[setting["name"]] = dict(loss=loss, jax_loss=setting["loss"], grad_global_norm=gnorm,
                                        jax_grad_global_norm=setting["grad_global_norm"],
                                        rel_err=errs, float_step_control_rel_err=control)
    emit("qat_check", against_jax=against, tol=QAT_TOL, batch=b)
    for name, r in against.items():
        tol = QAT_TOL[name]
        require(all(r["rel_err"][k] <= tol[k] for k in tol),
                f"qat {name} against JAX: {r['rel_err']} (bounds {tol})")
        require(any(r["float_step_control_rel_err"][k] > tol[k] for k in tol),
                f"qat {name}: the float-step control {r['float_step_control_rel_err']} "
                f"passes {tol}")
    torch.cuda.empty_cache()

    # train_model with qat_act from PNG directories through the device cache
    work = tempfile.mkdtemp(prefix="chip_smoke_qat_")
    root = os.path.join(build_dir(), "qat_data")
    shutil.rmtree(root, ignore_errors=True)
    lo, hi = make_split(8 * QAT_STEPS, DATA_SIZE, DATA_SEED + 2)
    for j in range(8 * QAT_STEPS):
        for side, img in (("low", lo[j]), ("high", hi[j])):
            png.write_png(os.path.join(root, "train", side, f"{j:03d}.png"), img)
            if j < QAT_CLI_PAIRS:
                png.write_png(os.path.join(root, "cli", side, f"{j:03d}.png"), img)
    tc = TrainConfig(unet_variant="small", image_size=DATA_SIZE, batch_size=8, epochs=1,
                     qat_act=True, data_on_device=True, log_interval=1000, seed=0,
                     prediction_type="v_prediction",
                     checkpoint_dir=os.path.join(work, "ckpt"),
                     output_dir=os.path.join(work, "samples"))
    lak.linear_attention_kernel.launches = 0
    lak.linear_attention_backward_kernel.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(sys.stderr):
        trainer = train_model(os.path.join(root, "train"), None, tc, device=dev)
    torch.cuda.synchronize()
    st = trainer.epoch_stats
    fwd, bwd = (lak.linear_attention_kernel.launches,
                lak.linear_attention_backward_kernel.launches)
    require(trainer.state.step == QAT_STEPS and trainer.model.config.unet.act_quant == "fake",
            f"qat: train_model took {trainer.state.step} steps")
    # the steps' forwards and backwards, and one 4-step sample grid at the end
    require(bwd == QAT_STEPS * n_attn and fwd == (QAT_STEPS + 4) * n_attn,
            f"qat: attention launches {fwd} forward, {bwd} backward")
    run = dict(steps=st["steps"], ms_per_step=st["seconds"] * 1e3 / st["steps"],
               loader_wait_ms_per_step=st["loader_wait_s"] * 1e3 / st["steps"],
               images_per_s=8 * st["steps"] / st["seconds"],
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               attention_launches_per_step={"forward": (fwd - 4 * n_attn) / st["steps"],
                                            "backward": bwd / st["steps"]},
               attention_launches={"forward": fwd, "backward": bwd}, use_amp=tc.use_amp)
    del trainer
    torch.cuda.empty_cache()

    # the train CLI with --qat_act, 2 steps
    a = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cv_diffusion_tpu_torch.train",
         "--data_dir", os.path.join(root, "cli"), "--val_dir", "none", "--variant", "small",
         "--image_size", str(DATA_SIZE), "--epochs", "1", "--batch_size", "8", "--qat_act",
         "--prediction", "v_prediction",
         "--checkpoint_dir", os.path.join(work, "cli_ckpt"),
         "--output_dir", os.path.join(work, "cli_out"), "--device", dev.type],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - a
    require(proc.returncode == 0 and os.path.isfile(os.path.join(work, "cli_ckpt", "final_model.pt")),
            f"qat: the train CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    fields = dict(train_model=run, config=f"small@{DATA_SIZE} batch 8 qat_act use_amp, "
                                         "create_dataloaders(device_cache=True)",
                  cli={"exit": proc.returncode, "seconds": cli_s,
                       "steps": QAT_CLI_PAIRS // 8},
                  seconds=time.perf_counter() - t0)
    emit("qat", **fields)
    return fields


# Softmax attention (phases 22-25): the flash-attention kernels, a seeded
# small@256 with use_linear_attention=False served and trained, and the
# student with split_skip.
FLASH_TOL = (2e-5, 5e-4)      # float32 forward, backward: absolute
FLASH_BF16_ULPS = 4           # bf16: bf16 ulps of the reference's largest magnitude,
FLASH_BF16_MAX = 2e-2         # and never above the linear-attention kernels' bf16 gate
FLASH_TIMED = ((1, 1024, 4, 32), (8, 1024, 4, 32), (1, 4096, 4, 32))
FLASH_EDGES = tuple((2, n, 2, 32) for n in (1, 5, 100, 127, 128, 200, 1000)) + (
    (1, 256, 2, 64), (2, 300, 3, 64), (1, 256, 2, 128), (1, 1000, 1, 128))
FLASH_MEM_SHAPE = (8, 4096, 4, 32)      # 512²'s mid at batch 8
# (products of 2·B·H·N²·D FLOP, [B, N, H, D] tensors moved, [B, H, N] float32
# rows moved): the forward q·kᵀ and P·v over q, k, v, o; dK/dV also dO·vᵀ,
# Pᵀ·dO and dSᵀ·q over q, k, v, dO, dk, dv and lse, di; dQ q·kᵀ, dO·vᵀ and
# dS·k over q, k, v, dO, o, dq and lse, di (it forms di from o and dO)
FLASH_WORK = {"forward": (2, 4, 0), "dkv": (4, 6, 2), "dq": (3, 6, 2)}
SOFTMAX_STEPS = (2, 3)                  # warm-up and timed train steps a run
SOFTMAX_SIZE = 256                      # the image side of phases 23-25


def flash_limit(ref, dtype_name: str, backward: bool = False) -> float:
    """The gate of one flash output against its plain version ``ref``:
    float32's absolute limit; in bf16, ``FLASH_BF16_ULPS`` bf16 ulps of
    max |ref| (an ulp of x is 2^(⌊log2 |x|⌋ − 7)), between float32's limit
    and ``FLASH_BF16_MAX``. A typical |out| or |grad| at N = 1024 is
    0.03-0.05, so an absolute bf16 gate of 2e-2 alone would pass a kernel
    that dropped a key tile."""
    absolute = FLASH_TOL[int(backward)]
    if dtype_name == "float32":
        return absolute
    peak = float(ref.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(peak)) - 7) if peak > 0 else 0.0
    return min(FLASH_BF16_MAX, max(absolute, FLASH_BF16_ULPS * ulp))


def flash_bound(shape, dtype_name, kernel) -> dict:
    """The bound of one call (``ms``, ``by``, ``bytes``, ``flops``): its
    products at the card's rate for the inputs' type (float32 on the CUDA
    cores, bf16 on the tensor cores) against its bytes at 3.35 TB/s; for the
    f32 kernels, which run their products as 3xTF32 on the tensor cores,
    also ``tensor_ms``: the same FLOP three times over at the TF32 rate."""
    b, n, h, d = shape
    products, tensors, rows = FLASH_WORK[kernel]
    flops = products * 2 * b * h * n * n * d
    moved = tensors * b * n * h * d * (4 if dtype_name == "float32" else 2) + rows * 4 * b * h * n
    rate = F32_FLOPS_PER_S if dtype_name == "float32" else BF16_FLOPS_PER_S
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / rate
    out = dict(ms=max(t_bytes, t_ops) * 1e3, by="bytes" if t_bytes >= t_ops else "operations",
               bytes=moved, flops=flops)
    if dtype_name == "float32":
        out["tensor_ms"] = max(t_bytes, 3 * flops / TF32_FLOPS_PER_S) * 1e3
    return out


def flash_build_report(built) -> dict:
    """The flash library's ``build`` fields: registers and spills of each
    instance (0 spills required in all eighteen: six forward, twelve
    backward) and ``HMMA`` instructions by kernel from its SASS (required
    in each forward instance and in the library: every product runs on the
    tensor cores)."""
    report = ptxas_report(built.log)
    flash = {k: v for k, v in report.items() if k.startswith("flash_")}
    forward = [k for k in flash if k.startswith("flash_fwd_")]
    require(len(forward) == 2 * 3 and len(flash) == 3 * 2 * 3,
            f"flash: ptxas reports {sorted(flash)}")
    spilled = {k: v for k, v in flash.items() if v["spill_bytes"]}
    require(not spilled, f"flash kernels spill: {spilled}")
    fields = {"kernels": report}
    sass = sass_counts(built.path, ("HMMA",))
    fields["sass"] = sass
    if sass is not None:
        require(sum(v["HMMA"] for v in sass.values()) > 0,
                f"no HMMA in the flash library's SASS: {sass}")
        require(all(sass.get(k, {}).get("HMMA", 0) > 0 for k in forward),
                f"a forward flash instance without HMMA: {sass}")
    return fields


def flash_kernel_phase(dev, fk, cuda_build, cuda_ms, graph_ms) -> dict:
    """Phase 22: the three flash-attention kernels against their plain
    versions, forward and backward, f32 and bf16, at mid_attn's shapes,
    512²'s mid, the edge shapes and D = 64 and 128; times, bounds and
    ``scaled_dot_product_attention``'s time at the timed shapes; the peak
    memory of the forward against the plain version at 512²'s mid, batch 8."""
    import torch
    import torch.nn.functional as F
    from cv_diffusion_tpu_torch.ops.attention import (
        row_dot, softmax_attention_backward_rows, softmax_attention_plain)

    t0 = time.perf_counter()
    lib = cuda_build.load(fk.SOURCE, fk._declare)
    gen = torch.Generator(device=dev).manual_seed(5)
    err = lambda a, b: float((a.float() - b.float()).abs().max())   # noqa: E731
    rows = {}
    for shape in FLASH_TIMED + FLASH_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            scale = shape[-1] ** -0.5
            out, lse = fk.flash_attention_forward(q, k, v, scale, with_lse=True)
            again = fk.flash_attention_forward(q, k, v, scale, with_lse=True)
            ref, ref_lse = softmax_attention_plain(q, k, v, scale, return_lse=True)
            dq, di_k = fk.flash_attention_backward_dq(q, k, v, do, lse, out, scale)
            grads = (dq, *fk.flash_attention_backward_dkv(q, k, v, do, lse, di_k, scale))
            dq2, di_k2 = fk.flash_attention_backward_dq(q, k, v, do, lse, out, scale)
            grads2 = (dq2, *fk.flash_attention_backward_dkv(q, k, v, do, lse, di_k2, scale))
            di = row_dot(out, do)
            ref_grads = softmax_attention_backward_rows(q, k, v, do, lse, di, scale)
            torch.cuda.synchronize()
            require(out.dtype == dtype and out.shape == q.shape and lse.shape == ref_lse.shape,
                    f"flash {shape} {name}: output {out.dtype} {tuple(out.shape)}")
            require(all(bool(torch.isfinite(t).all()) for t in (out, lse) + grads),
                    f"flash {shape} {name}: a non-finite output")
            require(all(torch.equal(a, b) for a, b in zip((out,) + grads, (again[0],) + grads2))
                    and torch.equal(lse, again[1]) and torch.equal(di_k, di_k2),
                    f"flash {shape} {name}: reruns differ")
            fwd_err, lse_err, di_err = err(out, ref), err(lse, ref_lse), err(di_k, di)
            require(di_err <= FLASH_TOL[0] * 10,
                    f"flash dQ kernel's di {shape} {name}: {di_err} from row_dot's")
            bwd = {g: err(a, r) for g, a, r in zip(("dq", "dk", "dv"), grads, ref_grads)}
            tol_f = flash_limit(ref, name)
            tol_b = {g: flash_limit(r, name, backward=True) for g, r in zip(("dq", "dk", "dv"), ref_grads)}
            require(fwd_err <= tol_f and lse_err <= FLASH_TOL[0] * 10,
                    f"flash forward {shape} {name}: {fwd_err} (limit {tol_f}), lse {lse_err}")
            require(all(bwd[g] <= tol_b[g] for g in bwd),
                    f"flash backward {shape} {name}: {bwd}, limits {tol_b}")
            row = dict(kernel="flash_attention", shape=list(shape), dtype=name,
                       max_err=fwd_err, lse_max_err=lse_err, di_max_err=di_err, bwd_max_err=bwd,
                       tol=tol_f, bwd_tol=tol_b, ref_max=float(ref.float().abs().max()),
                       ref_grad_max={g: float(r.float().abs().max())
                                     for g, r in zip(("dq", "dk", "dv"), ref_grads)},
                       plans={kk: dict(fk.plan(lib, kk, shape, dtype)._asdict())
                              for kk in fk.KERNELS})
            if shape in FLASH_TIMED:
                iters = 30 if shape[1] >= 4096 else 200
                qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
                lib_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
                qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))

                def lib_fwd_bwd():
                    o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
                    return torch.autograd.grad(o, (qg, kg, vg), dot)

                lib_grads = lib_fwd_bwd()
                fns = {
                    "fwd": lambda: fk.flash_attention_forward(q, k, v, scale),
                    "fwd_lse": lambda: fk.flash_attention_forward(q, k, v, scale, with_lse=True),
                    "dkv": lambda: fk.flash_attention_backward_dkv(q, k, v, do, lse, di, scale),
                    "dq": lambda: fk.flash_attention_backward_dq(q, k, v, do, lse, out, scale),
                    "bwd": lambda: fk.flash_attention_backward_dkv(
                        q, k, v, do, lse, fk.flash_attention_backward_dq(q, k, v, do, lse, out, scale)[1],
                        scale),
                    "plain_fwd": lambda: softmax_attention_plain(q, k, v, scale),
                    "plain_bwd": lambda: softmax_attention_backward_rows(q, k, v, do, lse, di, scale),
                    "library_fwd": lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale),
                    "library_fwd_bwd": lib_fwd_bwd}
                ms = {key: cuda_ms(fn, iters, 5) for key, fn in fns.items()}
                graph = {key: graph_ms(fns[key], iters, 5)
                         for key in ("fwd", "dkv", "dq", "bwd", "plain_fwd", "plain_bwd",
                                     "library_fwd", "library_fwd_bwd")}
                row.update(
                    ms=ms, graph_ms=graph,
                    library_ms=dict(fwd=graph["library_fwd"],
                                    bwd=graph["library_fwd_bwd"] - graph["library_fwd"]),
                    library_eager_ms=dict(fwd=ms["library_fwd"],
                                          bwd=ms["library_fwd_bwd"] - ms["library_fwd"]),
                    library="torch.nn.functional.scaled_dot_product_attention on [B, H, N, D] "
                            "views, captured in a CUDA graph as the kernels' graph_ms; its "
                            "backward: forward + autograd.grad, less its forward (TF32 off)",
                    library_max_err=err(lib_out.transpose(1, 2), ref),
                    library_bwd_max_err=max(err(a.transpose(1, 2), r)
                                            for a, r in zip(lib_grads, ref_grads)),
                    bound={kk: flash_bound(shape, name, kk) for kk in fk.KERNELS})
            rows[(shape, name)] = row
            emit("kernel", **row)
            del q, k, v, do, out, lse, again, ref, ref_lse, di, di_k, di_k2, dq, dq2, grads, grads2, ref_grads

    # the forward's memory against the plain version's at 512²'s mid, batch 8
    q, k, v = (torch.randn(FLASH_MEM_SHAPE, generator=gen, device=dev) for _ in range(3))
    scale = FLASH_MEM_SHAPE[-1] ** -0.5
    mem = {}
    for label, fn in (("kernel", lambda: fk.flash_attention_forward(q, k, v, scale)[0]),
                      ("kernel_with_lse", lambda: fk.flash_attention_forward(q, k, v, scale, True)),
                      ("plain", lambda: softmax_attention_plain(q, k, v, scale)),
                      ("library", lambda: F.scaled_dot_product_attention(
                          q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        mem[label] = torch.cuda.max_memory_allocated() - base
        del res
    scores = FLASH_MEM_SHAPE[0] * FLASH_MEM_SHAPE[2] * FLASH_MEM_SHAPE[1] ** 2 * 4
    require(mem["kernel"] < scores / 8 < mem["plain"],
            f"flash memory at {FLASH_MEM_SHAPE}: {mem}, scores {scores} bytes")
    emit("flash_memory", shape=list(FLASH_MEM_SHAPE), dtype="float32",
         peak_bytes_beyond_inputs=mem, scores_bytes=scores)
    del q, k, v
    torch.cuda.empty_cache()
    emit("flash_kernel_done", cases=len(rows), seconds=time.perf_counter() - t0)
    return rows


def softmax_config(dtype="float32", **unet):
    """The student's model config (small@256, concat, v-prediction, ReLU6)
    with softmax attention, in ``dtype`` compute."""
    from cv_diffusion_tpu_torch.config import load_model_config
    cfg = load_model_config(os.path.join(ROOT, "artifacts", STUDENT, "model_config.json"))
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, use_linear_attention=False, dtype=dtype, **unet))


def flash_counts(fk) -> dict:
    return {"flash_attention_fwd": fk.flash_attention_forward.launches,
            "flash_attention_bwd_dkv": fk.flash_attention_backward_dkv.launches,
            "flash_attention_bwd_dq": fk.flash_attention_backward_dq.launches}


def softmax_serve_phase(dev, fk, images, batch_images, reset_launches, all_launches) -> dict:
    """Phase 23: a seeded small@256 with softmax attention served through
    the CUDA graphs at batch 1 and 8, float32 and bf16 compute: latency,
    images/s, peak memory, graph against eager (≤ 1 LSB), one forward flash
    launch a UNet call in a replay and no linear-attention launch, the
    kernel on mid_attn's own q, k, v; the card's float32 sampler against the
    CPU port's on the same weights and noise."""
    import numpy as np
    import torch
    from cv_diffusion_tpu_torch.export.serving import (GRAPH_WARMUP, ServingConfig,
                                                       ServingPipeline)
    from cv_diffusion_tpu_torch.models.blocks import SoftmaxAttention
    from cv_diffusion_tpu_torch.models.diffusion import create_model, enhance, with_dtype
    from cv_diffusion_tpu_torch.config import load_timesteps
    from cv_diffusion_tpu_torch.ops.attention import softmax_attention_plain
    from cv_diffusion_tpu_torch.weights import init_weights

    t0 = time.perf_counter()
    cfg = softmax_config()
    grid = load_timesteps(os.path.join(ROOT, "artifacts", STUDENT, "student_timesteps.json"))
    weights = init_weights(cfg, seed=0, device=dev)
    model, schedule = create_model(cfg, device=dev)
    model.load_state_dict(weights, strict=True)
    n_attn = sum(isinstance(m, SoftmaxAttention) for m in model.modules())
    require(n_attn == 1, f"{n_attn} softmax attention blocks in small@256, not 1 (mid_attn)")
    serving = ServingConfig(image_size=SOFTMAX_SIZE, num_inference_steps=len(grid), timesteps=grid,
                            batch_size=8)
    out = {"launches": dict.fromkeys(FLASH_KERNELS, 0), "launches_in_replays": 0}
    for dtype in ("float32", "bfloat16"):
        m = model if dtype == "float32" else with_dtype(model, "bfloat16")
        pipe = ServingPipeline(m, schedule, serving, device=dev)
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for i, img in enumerate(images):                  # captures batch 1
            pipe(img, seed=i)
        pipe.batch(batch_images, seed=1)                   # captures batch 8
        lat = []
        for i in range(10):
            torch.cuda.synchronize()
            a = time.perf_counter()
            res = pipe(images[2], seed=i)
            lat.append((time.perf_counter() - a) * 1e3)
        require(res.shape == images[2].shape and res.dtype == np.uint8, "softmax serve output")
        a = time.perf_counter()
        outs = pipe.batch(batch_images * REPS, seed=400)
        pipelined = time.perf_counter() - a
        require(len(outs) == 8 * REPS and all(o.shape == i.shape for o, i in
                                              zip(outs, batch_images * REPS)), "softmax batch")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        lsb = {}
        for b in (1, 8):
            canvas = torch.cat([pipe.pre(im)[0] for im in (images[:1] if b == 1 else batch_images)])
            graph_out = pipe._run(canvas, pipe._generator(7))
            eager_out = pipe.run_eager(canvas, pipe._generator(7))
            lsb[b] = int((graph_out.int() - eager_out.int()).abs().max())
        require(all(v <= GRAPH_LSB_TOL for v in lsb.values()),
                f"softmax {dtype}: graph vs eager {lsb} LSB")
        counts = all_launches()
        per_replay = {b: g.launches for b, g in sorted(pipe.graphs.items())}
        want = dict.fromkeys(counts, 0)
        want["flash_attention_fwd"] = len(grid) * n_attn
        require(all(r == want for r in per_replay.values()),
                f"softmax {dtype}: launches a replay {per_replay}, not {want}")
        replays = {b: g.replays for b, g in sorted(pipe.graphs.items())}
        eager_calls = 2         # the two eager samplers above
        direct = ((GRAPH_WARMUP + 1) * len(pipe.graphs) + eager_calls) * len(grid) * n_attn
        require(counts["flash_attention_fwd"] == direct and counts["linear_attention"] == 0
                and counts["flash_attention_bwd_dkv"] == counts["flash_attention_bwd_dq"] == 0,
                f"softmax {dtype}: wrapper launches {counts}, forward {direct} expected")
        for key in FLASH_KERNELS:
            out["launches"][key] += counts[key]
        out["launches_in_replays"] += sum(replays.values()) * len(grid) * n_attn
        # the kernel on mid_attn's own q, k, v of an eager request
        captured = {}
        hook = m.unet.mid_attn.attn.register_forward_pre_hook(
            lambda mod, args: captured.__setitem__("qkv", [x.detach().clone() for x in args]))
        pipe.run_eager(pipe.pre(images[0])[0], pipe._generator(3))
        hook.remove()
        q, k, v = captured["qkv"]
        scale = m.unet.mid_attn.attn.scale
        mid_err = float((fk.flash_attention_forward(q, k, v, scale)[0].float()
                         - softmax_attention_plain(q, k, v, scale).float()).abs().max())
        require(tuple(q.shape) == (1, (SOFTMAX_SIZE // 8) ** 2, 4, 32) and q.dtype == getattr(torch, dtype),
                f"softmax {dtype}: mid_attn q {q.dtype} {tuple(q.shape)}")
        mid_tol = flash_limit(softmax_attention_plain(q, k, v, scale), dtype)
        require(mid_err <= mid_tol, f"softmax {dtype}: mid_attn kernel vs plain {mid_err} (limit {mid_tol})")
        row = dict(config=f"small@{SOFTMAX_SIZE} softmax attention, {STUDENT}'s config, seed 0",
                   dtype=dtype,
                   grid=list(grid), image=list(images[2].shape),
                   latency_ms_mean=float(np.mean(lat)), latency_ms_p50=float(np.median(lat)),
                   batch=8, images_per_s=REPS * 8 / pipelined, peak_mem_bytes=peak,
                   graph_vs_eager_lsb=lsb, launches=counts, launches_a_replay=per_replay,
                   replays=replays, mid_attn_max_err=mid_err, mid_attn_tol=mid_tol,
                   mid_attn_shape=list(q.shape))
        out[dtype] = row
        emit("softmax_serve", **row)
        del pipe, m
        torch.cuda.empty_cache()

    # the card's sampler against the CPU port's: same weights and noise
    rng = np.random.default_rng(11)
    side = (1, SOFTMAX_SIZE, SOFTMAX_SIZE, 3)
    low = torch.from_numpy(rng.uniform(-1, 1, side).astype(np.float32))
    init = torch.from_numpy(rng.standard_normal(side).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((len(grid),) + side).astype(np.float32))
    cpu_model, cpu_sched = create_model(cfg, device="cpu")
    cpu_model.load_state_dict({k: t.cpu() for k, t in weights.items()}, strict=True)
    got = enhance(model, schedule, low, timesteps=grid, init_noise=init, step_noise=noise,
                  device=dev).cpu()
    want = enhance(cpu_model, cpu_sched, low, timesteps=grid, init_noise=init,
                   step_noise=noise, device="cpu")
    require(bool(torch.isfinite(got).all()), "softmax: non-finite sampler output")
    vs_cpu = float((got - want).abs().max())
    require(vs_cpu <= SAMPLER_TOL, f"softmax: card vs CPU sampler {vs_cpu}")
    emit("softmax_serve_check", sampler_vs_cpu_max_abs_err=vs_cpu, sampler_tol=SAMPLER_TOL,
         size=SOFTMAX_SIZE, launches=out["launches"], launches_in_replays=out["launches_in_replays"],
         seconds=time.perf_counter() - t0)
    out["sampler_vs_cpu"] = vs_cpu
    del model, cpu_model
    torch.cuda.empty_cache()
    return out


def softmax_batches(n: int, seed: int = 0) -> list:
    """``n`` synthetic batches of 8 at ``SOFTMAX_SIZE``², made in bulk (set-up)."""
    import numpy as np
    from cv_diffusion_tpu_torch.data.dataset import DataLoader, SyntheticLowLightDataset
    side = SOFTMAX_SIZE + 32
    images = np.random.default_rng(seed).integers(0, 256, (8, side, side, 3), dtype=np.uint8)
    loader = DataLoader(SyntheticLowLightDataset(images, image_size=SOFTMAX_SIZE, seed=seed), 8,
                        shuffle=True, drop_last=True, seed=seed)
    return [b for _ in range(n) for b in loader]


def softmax_train_phase(dev, fk, reset_launches) -> dict:
    """Phase 24: the softmax model trained at batch 8, float32 and
    ``use_amp``: ms a step, peak memory, one launch of each backward kernel
    (and two forward: the step's and none else) a step; the attention
    block's gradients through the kernels against the plain autograd
    attention; the backward kernels on the step's own inputs against their
    plain versions; two identical steps bit for bit (deterministic
    algorithms on)."""
    import torch
    from cv_diffusion_tpu_torch.config import TrainConfig
    from cv_diffusion_tpu_torch.models.diffusion import create_model
    from cv_diffusion_tpu_torch.ops.attention import (row_dot, softmax_attention_backward_rows,
                                                      softmax_attention_plain)
    from cv_diffusion_tpu_torch.training.train_state import create_train_state, make_train_step
    from cv_diffusion_tpu_torch.weights import init_weights

    t0 = time.perf_counter()
    warm_n, timed_n = SOFTMAX_STEPS
    batches = softmax_batches(warm_n + timed_n)
    out = {"launches": dict.fromkeys(FLASH_KERNELS, 0)}
    weights = init_weights(softmax_config(), seed=0, device=dev)

    def fresh(dtype, use_amp):
        cfg = softmax_config(dtype)
        model, schedule = create_model(cfg, device=dev)
        model.load_state_dict(weights, strict=True)
        tc = TrainConfig(unet_variant="small", image_size=SOFTMAX_SIZE, batch_size=8, use_amp=use_amp,
                         epochs=1, warmup_epochs=0, prediction_type="v_prediction", seed=0)
        return model, create_train_state(model, tc), make_train_step(model, schedule, tc)

    for dtype, use_amp in (("float32", False), ("bfloat16", True)):
        model, state, step = fresh(dtype, use_amp)
        reset_launches()
        for batch in batches[:warm_n]:
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = time.perf_counter()
        for batch in batches[warm_n:]:
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - a) * 1e3 / timed_n
        peak = torch.cuda.max_memory_allocated()
        counts = flash_counts(fk)
        steps = warm_n + timed_n
        require(counts == dict.fromkeys(FLASH_KERNELS, steps),
                f"softmax train {dtype}: launches {counts} in {steps} steps")
        require(bool(torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"])),
                f"softmax train {dtype}: loss {metrics['loss']}")
        qkv_grad = float(model.unet.mid_attn.to_qkv.weight.grad.abs().max())
        require(qkv_grad > 0, f"softmax train {dtype}: mid_attn.to_qkv has a zero gradient")
        for key in FLASH_KERNELS:
            out["launches"][key] += counts[key]
        row = dict(config=f"small@{SOFTMAX_SIZE} softmax attention v-prediction, {dtype} compute",
                   use_amp=use_amp, batch=8, warmup_steps=warm_n, timed_steps=timed_n,
                   ms_per_step=ms, images_per_s=8 * 1e3 / ms, peak_mem_bytes=peak,
                   launches=counts, launches_per_step={k: v / steps for k, v in counts.items()},
                   loss=float(metrics["loss"]), mid_attn_to_qkv_grad_max_abs=qkv_grad)
        out[dtype] = row
        emit("softmax_train", **row)
        del model, state, step
        torch.cuda.empty_cache()

    # one float32 step through the kernels against the same step with the
    # attention plain: the attention block's gradients; the backward
    # kernels on the step's own q, k, v and upstream gradient
    seen = {}

    def keep_qkv(module, args):      # the backward's q, k, v ...
        seen["qkv"] = [x.detach() for x in args]

    def keep_do(module, args, o):    # ... and its upstream gradient
        o.register_hook(lambda g: seen.__setitem__("do", g.detach().contiguous()))

    def one_step(plain: bool):
        model, state, step = fresh("float32", False)
        attn = model.unet.mid_attn.attn
        hooks = [attn.register_forward_pre_hook(keep_qkv), attn.register_forward_hook(keep_do)]
        original = fk.softmax_attention_trainable
        if plain:
            fk.softmax_attention_trainable = softmax_attention_plain
        try:
            state, m = step(state, batches[0])
        finally:
            fk.softmax_attention_trainable = original
            for h in hooks:
                h.remove()
        return {n: p.grad.detach().clone() for n, p in model.unet.mid_attn.named_parameters()}

    with_kernels = one_step(False)
    q, k, v = seen["qkv"]
    do = seen["do"]
    with_plain = one_step(True)
    block_rel = {n: float((with_kernels[n] - g).abs().max()) / (float(g.abs().max()) + 1e-30)
                 for n, g in with_plain.items()}
    norm_rel = (sum(float((with_kernels[n] - g).double().square().sum()) for n, g in with_plain.items())
                / sum(float(g.double().square().sum()) for g in with_plain.values())) ** 0.5
    require(max(block_rel.values()) <= STEP_GRAD_TOL and norm_rel <= STEP_GRAD_NORM_TOL,
            f"softmax train: mid_attn gradients kernel vs plain {block_rel}, norm {norm_rel}")
    scale = 32 ** -0.5
    o, lse = fk.flash_attention_forward(q, k, v, scale, with_lse=True)
    dq, di = fk.flash_attention_backward_dq(q, k, v, do, lse, o, scale)
    got = (dq, *fk.flash_attention_backward_dkv(q, k, v, do, lse, di, scale))
    step_bwd_err = max(float((a - r).abs().max()) for a, r in zip(
        got, softmax_attention_backward_rows(q, k, v, do, lse, row_dot(o, do), scale)))
    require(tuple(q.shape) == (8, (SOFTMAX_SIZE // 8) ** 2, 4, 32) and step_bwd_err <= FLASH_TOL[1],
            f"softmax train: backward kernels on the step's {tuple(q.shape)} inputs: {step_bwd_err}")
    del q, k, v, do, o, lse, dq, di, got

    # two identical steps, bit for bit, with deterministic algorithms
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        twice = []
        for _ in range(2):
            model, state, step = fresh("float32", False)
            state, m = step(state, batches[1])
            twice.append((float(m["loss"]), {n: p.grad.detach().clone()
                                             for n, p in model.named_parameters()}))
            del model, state, step
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    same = twice[0][0] == twice[1][0] and all(torch.equal(g, twice[1][1][n])
                                              for n, g in twice[0][1].items())
    require(same, "softmax train: two identical steps differ")
    emit("softmax_train_check", mid_attn_grad_kernel_vs_plain_rel=block_rel,
         mid_attn_grad_norm_rel=norm_rel,
         grad_tol=dict(tensor_rel=STEP_GRAD_TOL, norm_rel=STEP_GRAD_NORM_TOL),
         backward_on_step_inputs_max_abs_err=step_bwd_err, identical_steps_bit_for_bit=same,
         launches=out["launches"], seconds=time.perf_counter() - t0)
    out.update(step_bwd_err=step_bwd_err, block_rel=block_rel)
    del twice
    torch.cuda.empty_cache()
    return out


def split_skip_phase(dev, images, batch_images) -> dict:
    """Phase 25: the student with ``split_skip`` on its own weights against
    itself concatenating: the sampler on the same noise (≤ 5e-3) and the
    uint8 outputs through the graphs (≤ 1 LSB); batch-8 latency, images/s
    and peak memory beside the concat path's; one train step's gradients
    against the concat model's."""
    import numpy as np
    import torch
    from cv_diffusion_tpu_torch.config import TrainConfig
    from cv_diffusion_tpu_torch.export.serving import ServingPipeline
    from cv_diffusion_tpu_torch.models.diffusion import create_model, enhance
    from cv_diffusion_tpu_torch.training.train_state import create_train_state, make_train_step

    t0 = time.perf_counter()
    concat = ServingPipeline.from_artifact(STUDENT, dev, batch_size=8)
    cfg = concat.model.config
    split_cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, split_skip=True))
    model, schedule = create_model(split_cfg, device=dev)
    model.load_state_dict(concat.model.state_dict(), strict=True)
    split = ServingPipeline(model, schedule, concat.config, device=dev)
    grid = concat.grid
    rng = np.random.default_rng(21)
    side = (8, SOFTMAX_SIZE, SOFTMAX_SIZE, 3)
    low = torch.from_numpy(rng.uniform(-1, 1, side).astype(np.float32))
    init = torch.from_numpy(rng.standard_normal(side).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((len(grid),) + side).astype(np.float32))
    outs = {label: enhance(p.model, p.schedule, low, timesteps=grid, init_noise=init,
                           step_noise=noise, device=dev).cpu()
            for label, p in (("concat", concat), ("split", split))}
    sampler_err = float((outs["split"] - outs["concat"]).abs().max())
    require(sampler_err <= SAMPLER_TOL, f"split_skip vs concat sampler: {sampler_err}")
    rows = {}
    for label, pipe in (("concat", concat), ("split", split)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        u8 = [pipe(img, seed=i) for i, img in enumerate(images)]
        pipe.batch(batch_images, seed=1)
        lat = []
        for i in range(10):
            torch.cuda.synchronize()
            a = time.perf_counter()
            pipe(images[2], seed=i)
            lat.append((time.perf_counter() - a) * 1e3)
        a = time.perf_counter()
        batched = pipe.batch(batch_images * REPS, seed=400)
        pipelined = time.perf_counter() - a
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        # one eager batch of 8 alone: what the sampler holds at its peak
        canvas = torch.cat([pipe.pre(im)[0] for im in batch_images])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pipe.run_eager(canvas, pipe._generator(5))
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated() - base
        rows[label] = dict(latency_ms_mean=float(np.mean(lat)), latency_ms_p50=float(np.median(lat)),
                           image=list(images[2].shape), batch=8,
                           images_per_s=REPS * 8 / pipelined, peak_mem_bytes=peak,
                           eager_batch8_peak_bytes_beyond_inputs=eager_peak,
                           u8=u8, batched=batched)
    lsb = max(int(np.abs(a.astype(int) - b.astype(int)).max())
              for a, b in zip(rows["split"]["u8"] + rows["split"]["batched"],
                              rows["concat"]["u8"] + rows["concat"]["batched"]))
    require(lsb <= GRAPH_LSB_TOL, f"split_skip vs concat served: {lsb} LSB")
    for r in rows.values():
        del r["u8"], r["batched"]
    del split, concat
    torch.cuda.empty_cache()

    # one float32 train step, split against concat: same weights and batch
    batch = softmax_batches(1, seed=3)[0]
    weights = {k: t.clone() for k, t in model.state_dict().items()}
    steps = {}
    for label, c in (("concat", cfg), ("split", split_cfg)):
        m, sch = create_model(c, device=dev)
        m.load_state_dict(weights, strict=True)
        tc = TrainConfig(unet_variant="small", image_size=SOFTMAX_SIZE, batch_size=8, use_amp=False,
                         epochs=1, warmup_epochs=0, prediction_type="v_prediction", seed=0)
        state = create_train_state(m, tc)
        state, metrics = make_train_step(m, sch, tc)(state, batch)
        steps[label] = (float(metrics["loss"]),
                        {n: p.grad.detach().clone() for n, p in m.named_parameters()},
                        {n: p.detach().clone() for n, p in m.named_parameters()})
        del m, state
    step_vs_concat = step_diffs(steps["split"], steps["concat"])
    require(within(step_vs_concat), f"split_skip vs concat train step: {step_vs_concat}")
    del steps, model
    torch.cuda.empty_cache()
    emit("split_skip", student=STUDENT, grid=list(grid), sampler_vs_concat_max_abs_err=sampler_err,
         sampler_tol=SAMPLER_TOL, served_vs_concat_lsb=lsb, **rows,
         train_step_vs_concat=step_vs_concat, seconds=time.perf_counter() - t0)
    return dict(rows, sampler_err=sampler_err, lsb=lsb, step=step_vs_concat)


# The cli phase (26): the CLIs a user runs, in this process (their main(argv)).
# The dataset CLI's splits (--train, --val, --size, --seed): its val split is
# the eval phase's 15 pairs; the inference CLI's inputs are crops of their low
# images at two sizes, PNG and BMP; the benchmark CLI's batch sizes and runs
CLI_SPLIT = dict(train=8, val=15, size=256, seed=0)
CLI_IMAGE_SIZES = ((192, 256), (256, 256), (192, 256), (256, 256), (192, 256))
CLI_BENCH = dict(batch_sizes=(1, 8), num_runs=5)
# the directory evaluation per image against the eval phase's in-memory run
# of the same weights, inputs and noise in the same batches of 8: expected
# bit for bit; PSNR in dB, the others in their units
CLI_EVAL_TOL = 1e-4


def write_bmp(path: str, img) -> None:
    """A 24-bit bottom-up BMP of uint8 RGB ``img`` [H, W, 3]."""
    import struct

    import numpy as np

    h, w, _ = img.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    body = rows.tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", 54 + len(body), 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body), 0, 0, 0, 0))
        f.write(body)


def zero_launches() -> None:
    """Every hand-written kernel wrapper's launch count set to 0."""
    from cv_diffusion_tpu_torch.ops import flash_attention_kernel as fk
    from cv_diffusion_tpu_torch.ops import fused_irb_kernel as fik
    from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak
    from cv_diffusion_tpu_torch.ops import qconv_kernel as qk

    for wrapper in (lak.linear_attention_kernel, lak.linear_attention_backward_kernel,
                    fk.flash_attention_forward, fk.flash_attention_backward_dkv,
                    fk.flash_attention_backward_dq, fik.fused_irb_v2, fik.fused_irb_v1,
                    qk.quantize, qk.quantize_weight, qk.int8_conv, qk.int8_depthwise,
                    lak.linear_attention_kv_kernel, lak.linear_attention_apply_kernel,
                    lak.linear_attention_bwd_partial_kernel,
                    lak.linear_attention_bwd_finish_kernel):
        wrapper.launches = 0


def cli_phase(dev, eval_per_image: dict) -> dict:
    """Phase 26: ``make_synthetic_dataset``, ``inference`` (batch 1 and 4),
    ``evaluate --data_dir``, ``benchmark`` (random-init with ``--profile``,
    and ``--model``), ``train --config`` and ``migrate``, each through its
    ``main(argv)`` on the card at full width, with the wrappers' launch
    counts set to 0 just before each and read just after; each held to the
    library path it stands for."""
    import numpy as np
    import torch
    from cv_diffusion_tpu_torch import (benchmark, inference, make_synthetic_dataset,
                                        migrate, train)
    from cv_diffusion_tpu_torch import evaluate as ev
    from cv_diffusion_tpu_torch.config import load_yaml, save_yaml
    from cv_diffusion_tpu_torch.data import png
    from cv_diffusion_tpu_torch.export.serving import ServingPipeline, kernel_launches
    from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak
    from cv_diffusion_tpu_torch.weights import load_state_dict_npz

    t_phase = time.perf_counter()
    with open(os.path.join(ROOT, "artifacts_torch", f"{STUDENT}.eval_ref.json")) as f:
        eval_ref = json.load(f)
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    art = os.path.join(ROOT, "artifacts", STUDENT)
    rows = {}

    def run(name, dtype, main, argv):
        """``main(argv)`` timed, its launches counted from 0."""
        zero_launches()
        torch.cuda.synchronize()
        a = time.perf_counter()
        out = main(argv)
        torch.cuda.synchronize()
        counts = kernel_launches()
        counts["linear_attention_backward"] = lak.linear_attention_backward_kernel.launches
        rows[name] = dict(dtype=dtype, seconds=time.perf_counter() - a,
                          launches={k: v for k, v in counts.items() if v})
        require(not any(v for k, v in counts.items() if not k.startswith("linear_attention")),
                f"cli {name}: kernels of another path launched: {counts}")
        if dtype is not None:
            require(counts["linear_attention"] > 0,
                    f"cli {name}: served without launching the linear-attention kernel")
        return out

    # the dataset CLI: its val split is the eval phase's pairs
    data = os.path.join(root, "data")
    run("make_synthetic_dataset", None, make_synthetic_dataset.main,
        ["--out", data] + [f"--{k}={v}" for k, v in CLI_SPLIT.items()])
    low, high = ev.eval_split(CLI_SPLIT["val"], CLI_SPLIT["size"], CLI_SPLIT["seed"])
    for sub, want in (("low", low), ("high", high)):
        got = png.read_images([os.path.join(data, "val", sub, f"{i:05d}.png")
                               for i in range(CLI_SPLIT["val"])])
        require(all(np.array_equal(g, w) for g, w in zip(got, want)),
                f"cli: the dataset CLI's val/{sub} is not the eval split")
    require(len(os.listdir(os.path.join(data, "train", "high"))) == CLI_SPLIT["train"],
            "cli: the dataset CLI's train split")

    # the inference CLI at batch 1 and 4, against from_artifact's pipelines
    src = os.path.join(root, "images")
    os.makedirs(src)
    images = []
    for i, (h, w) in enumerate(CLI_IMAGE_SIZES):
        img = np.ascontiguousarray(low[i][:h, :w])
        (write_bmp if i % 2 else png.write_png)(
            os.path.join(src, f"img{i}.{'bmp' if i % 2 else 'png'}"), img)
        images.append(img)
    inference_lsb = {}
    for batch in (1, 4):
        out_dir = os.path.join(root, f"enhanced_b{batch}")
        res = run(f"inference_b{batch}", "float32", inference.main,
                  ["--input", src, "--output", out_dir, "--model", art, "--dtype", "float32",
                   "--batch_size", str(batch), "--image_size", str(CLI_SPLIT["size"]),
                   "--device", dev.type])
        ref = ServingPipeline.from_artifact(STUDENT, dev, batch_size=batch)
        want = ref.batch(images) if batch > 1 else [ref(img) for img in images]
        got = [png.read_image(p) for p in res["outputs"]]
        require([g.shape for g in got] == [im.shape for im in images],
                f"cli inference b{batch}: output shapes")
        inference_lsb[batch] = max(int(np.abs(g.astype(int) - r.astype(int)).max())
                                   for g, r in zip(got, want))
        require(inference_lsb[batch] <= GRAPH_LSB_TOL,
                f"cli inference b{batch}: {inference_lsb[batch]} LSB from from_artifact's")
        rows[f"inference_b{batch}"]["max_lsb_vs_from_artifact"] = inference_lsb[batch]
        del ref

    # directory evaluation of the written val split
    payload = run("evaluate", "float32", ev.main,
                  ["--data_dir", os.path.join(data, "val"), "--model", art,
                   "--dtype", "float32", "--batch_size", str(ev.BATCH_SIZE),
                   "--image_size", str(CLI_SPLIT["size"]), "--device", dev.type,
                   "--json", os.path.join(root, "eval.json")])
    per = payload["seeds"][str(CLI_SPLIT["seed"])]
    calls = -(-CLI_SPLIT["val"] // ev.BATCH_SIZE) * len(payload["timesteps"])
    require(rows["evaluate"]["launches"].get("linear_attention") == calls,
            f"cli evaluate: {rows['evaluate']['launches']} for {calls} UNet calls")
    measured = [k for k in EVAL_TOL if per[k][0] is not None]    # MS-SSIM from 176²
    vs_eval = {k: max(abs(a - b) for a, b in zip(per[k], eval_per_image[k]))
               for k in measured}
    bitwise = sum(all(per[k][i] == eval_per_image[k][i] for k in EVAL_TOL)
                  for i in range(CLI_SPLIT["val"]))
    require(max(vs_eval.values()) <= CLI_EVAL_TOL,
            f"cli evaluate vs the eval phase per image: {vs_eval}")
    vs_jax = {k: max(abs(a - im[k]) for a, im in zip(per[k], eval_ref["images"]))
              for k in measured}
    require(all(vs_jax[k] <= EVAL_TOL[k] for k in measured),
            f"cli evaluate vs JAX per image: {vs_jax}")
    require(set(payload) == {"model", "variant", "image_size", "num_steps", "deterministic",
                             "timesteps", "seeds", "summary"}, "cli evaluate: JSON keys")
    rows["evaluate"].update(vs_eval_phase=vs_eval, images_bit_for_bit=bitwise,
                            vs_jax=vs_jax, psnr_mean=payload["summary"]["psnr_mean"])

    # the benchmark CLI, random-init (bf16, --profile) and the student (bf16)
    trace_dir = os.path.join(root, "trace")
    bench = run("benchmark", "bfloat16", benchmark.main,
                ["--batch_sizes", *map(str, CLI_BENCH["batch_sizes"]),
                 "--num_runs", str(CLI_BENCH["num_runs"]), "--profile", trace_dir,
                 "--image_size", str(CLI_SPLIT["size"]), "--device", dev.type])
    require([tuple(r) for r in bench["rows"]] == [benchmark.ROW_KEYS] * 2,
            "cli benchmark: row keys")
    with open(bench["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    rows["benchmark"].update(
        rows=bench["rows"], warmup_s=bench["warmup_s"],
        trace_bytes=os.path.getsize(bench["trace"]), trace_kernels=len(kernels),
        trace_linear_attention_kernels=sum("linear_attention" in e.get("name", "")
                                           for e in kernels))
    stats = run("benchmark_model", "bfloat16", benchmark.main,
                ["--model", art, "--num_runs", str(CLI_BENCH["num_runs"]),
                 "--image_size", str(CLI_SPLIT["size"]), "--device", dev.type])
    rows["benchmark_model"]["stats"] = stats["stats"]

    # train --config: the YAML's own use_amp; the data roots of the written splits
    exp = load_yaml(os.path.join(ROOT, "configs", "default.yaml"))
    exp = dataclasses.replace(exp, data=dataclasses.replace(
        exp.data, train_root=os.path.join(data, "train"), val_root=os.path.join(data, "val")))
    yaml_path = os.path.join(root, "experiment.yaml")
    save_yaml(exp, yaml_path)
    ck, out = os.path.join(root, "ckpt"), os.path.join(root, "out")
    run("train_config", "bfloat16" if exp.train.use_amp else "float32", train.main,
        ["--config", yaml_path, "--epochs", "1", "--checkpoint_dir", ck, "--output_dir", out,
         "--device", dev.type])
    steps = CLI_SPLIT["train"] // exp.train.batch_size
    require(rows["train_config"]["launches"].get("linear_attention_backward") == steps,
            f"cli train --config: {rows['train_config']['launches']} for {steps} steps")
    require(os.path.isfile(os.path.join(ck, "final_model.pt"))
            and os.path.isfile(os.path.join(out, "samples_epoch_0.png")),
            "cli train --config: no final checkpoint or sample grid")
    rows["train_config"].update(use_amp=exp.train.use_amp, steps=steps,
                                batch_size=exp.train.batch_size)

    # migrate the student's state dict, saved as the reference trainer does
    ref_pt = os.path.join(root, "student.pt")
    state = load_state_dict_npz(os.path.join(ROOT, "artifacts_torch", f"{STUDENT}.npz"), "cpu")
    torch.save({"model_state_dict": state}, ref_pt)
    pkg = os.path.join(root, "migrated")

    def migrate_and_serve(argv):
        files = migrate.main(argv)
        served = ServingPipeline.from_package(pkg, device=dev)(images[0], seed=0)
        require(served.shape == images[0].shape and served.dtype == np.uint8,
                "cli migrate: the package's own request")
        return files

    files = run("migrate", "float32", migrate_and_serve, [ref_pt, pkg, "--device", dev.type])
    migrated = load_state_dict_npz(files["params"], dev)
    require(sorted(migrated) == sorted(state)
            and all(torch.equal(migrated[k].cpu(), state[k]) for k in state),
            "cli migrate: the package's weights are not the student's")
    # the package's weights on the student's model config and grid (the
    # reference checkpoint records neither: migrate writes the JAX script's
    # epsilon model) serve the request from_artifact serves
    as_student = ServingPipeline.from_config(
        os.path.join(art, "model_config.json"), os.path.join(art, "student_timesteps.json"),
        migrated, dev)
    want = ServingPipeline.from_artifact(STUDENT, dev)(images[0], seed=0)
    got = as_student(images[0], seed=0)
    migrate_lsb = int(np.abs(got.astype(int) - want.astype(int)).max())
    require(migrate_lsb <= GRAPH_LSB_TOL, f"cli migrate: {migrate_lsb} LSB from from_artifact's")
    rows["migrate"].update(params=len(migrated), weights_equal=True,
                           served_lsb_vs_from_artifact=migrate_lsb)
    del as_student, migrated, state
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    launches = {"float32": 0, "bfloat16": 0, "backward_bfloat16": 0, "backward_float32": 0}
    for r in rows.values():
        if r["dtype"]:
            launches[r["dtype"]] += r["launches"].get("linear_attention", 0)
            launches["backward_" + r["dtype"]] += r["launches"].get(
                "linear_attention_backward", 0)
    emit("cli", **rows, linear_attention_launches=launches,
         seconds=time.perf_counter() - t_phase)
    return dict(rows=rows, launches=launches)


# the dp phase (27): data parallelism over torch.distributed, each process
# a subprocess of this script (``--dp-rank``) on the one card
DP_BATCH = 8                  # the global batch of its train steps and serves
DP_SIZE = 256
DP_STEPS = 3                  # world size 1: DP steps against the plain Trainer's
DP_PAIRS = 5                  # paired timings (plain, DP, DP, plain) of a served batch
DP_TIMEOUT = 300              # seconds a process may take
DP_ATTN_SHAPE = (8, 1024, 4, 32)
# a collective in a profiler trace, by its host op or device kernel's name
DP_COLLECTIVE = re.compile(r"nccl|gloo|c10d|record_param_comms|all_?reduce|"
                           r"all_?gather|reduce_?scatter|all_?to_?all", re.I)
DP_SERVED = (("float32", False, "float32"), ("bfloat16", False, "bfloat16"),
             ("float32+use_pallas_irb", True, "float32"))
# the spatial axis (world 2 on a (1, 2) mesh): the served batch, the 512²
# forward, and the token-sharded linear-attention entries' shape a rank (the
# 256² train batch's mid_attn, half its tokens)
SP_SERVE_BATCH = 2
SP_FORWARD_SIZE = 512
SP_FORWARD_TOL = dict(atol=2e-4, rtol=2e-3)     # tests/test_parallel.py:326-327
# bf16 serving's mean uint8 distance from the float32 image, spatial over one
# process's (a CPU run of the small UNet read 1.04)
SP_BF16_RATIO = 1.5
SP_ATTN_SHAPE = (8, 512, 4, 32)
SP_ENTRIES = ("kv", "apply", "bwd_partial", "bwd_finish")
# an output's error relative to the reference's largest magnitude, by the
# output's dtype: float32 (the sums are float32 for either input dtype), and
# 4 bf16 ulps (flash_limit's bf16 rule)
SP_REL_TOL = {"float32": 2e-5, "bfloat16": 4 * 2.0 ** -8}
# the entries' float operations an element of [B, N, H, D], D = 32: φ, the D×D
# products (2·D each), the vector sums and the divisions
SP_FLOPS = {"kv": lambda d: 2 * d + 2, "apply": lambda d: 2 * d + 4,
            "bwd_partial": lambda d: 6 * d + 11, "bwd_finish": lambda d: 4 * d + 4}


def dp_launches() -> dict:
    from cv_diffusion_tpu_torch.export.serving import kernel_launches as counts

    c = counts()
    from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak

    return {"linear_attention": c["linear_attention"],
            "linear_attention_backward": lak.linear_attention_backward_kernel.launches,
            "fused_irb_v2": c["fused_irb_v2"], **lak.sharded_launches()}


def dp_step_record(model, loss, norm, clip):
    """(loss, the averaged gradients before the clip, the parameters) of a
    step just taken, for ``step_diffs``."""
    unclip = max(1.0, float(norm) / clip)
    return (float(loss), {n: p.grad.detach() * unclip for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()})


def dp_student(dev, dtype="float32"):
    import torch
    from cv_diffusion_tpu_torch.config import load_model_config
    from cv_diffusion_tpu_torch.models.diffusion import create_model
    from cv_diffusion_tpu_torch.weights import load_state_dict_npz

    cfg = load_model_config(os.path.join(ROOT, "artifacts", STUDENT, "model_config.json"))
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dtype=dtype))
    model, schedule = create_model(cfg, device=dev)
    model.load_state_dict(load_state_dict_npz(
        os.path.join(ROOT, "artifacts_torch", f"{STUDENT}.npz"), dev), strict=True)
    return model, schedule


def dp_to_u8(x):
    import torch
    return (x.float() * 127.5 + 127.5).clamp(0, 255).to(torch.uint8)


def dp_single(dev) -> dict:
    """World size 1 over NCCL: the DP Trainer against the plain one, DP
    serving against ServingPipeline, the sampler's collectives, paired ms."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from cv_diffusion_tpu_torch.config import TrainConfig
    from cv_diffusion_tpu_torch.export.serving import ServingPipeline
    from cv_diffusion_tpu_torch.models.diffusion import with_dtype
    from cv_diffusion_tpu_torch.parallel import make_mesh, make_sharded_sample_fn
    from cv_diffusion_tpu_torch.training.trainer import Trainer

    mesh = make_mesh()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "mesh": dict(mesh.shape), "train": {}, "serve": {}}
    batches = softmax_batches(DP_STEPS, seed=5)
    tmp = tempfile.mkdtemp(prefix="dp_", dir=build_dir())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for dtype, amp in (("float32", False), ("bfloat16", True)):
            runs = {}
            for label, m in (("plain", False), ("dp", mesh)):
                model, schedule = dp_student(dev, dtype)
                tc = TrainConfig(unet_variant="small", image_size=DP_SIZE, batch_size=DP_BATCH,
                                 use_amp=amp, epochs=1, warmup_epochs=0,
                                 async_checkpoints=False, output_dir=tmp, checkpoint_dir=tmp)
                zero_launches()
                trainer = Trainer(model, schedule, batches, None, tc, mesh=m)
                loss = trainer.train_epoch()
                torch.cuda.synchronize()
                runs[label] = dict(
                    loss=loss, launches=dp_launches(), mesh=trainer.mesh is not None,
                    params={n: p.detach().clone() for n, p in model.named_parameters()},
                    ema={n: e.clone() for n, e in trainer.state.ema_params.items()})
                del trainer, model
            same = (runs["dp"]["loss"] == runs["plain"]["loss"]
                    and all(torch.equal(p, runs["plain"]["params"][n])
                            for n, p in runs["dp"]["params"].items())
                    and all(torch.equal(e, runs["plain"]["ema"][n])
                            for n, e in runs["dp"]["ema"].items()))
            require(runs["dp"]["mesh"] and not runs["plain"]["mesh"],
                    "dp: the DP Trainer has no mesh, or the plain one has")
            require(same, f"dp: {dtype} DP Trainer steps differ from the plain Trainer's")
            require(runs["dp"]["launches"]["linear_attention"] >= DP_STEPS
                    and runs["dp"]["launches"]["linear_attention_backward"] >= DP_STEPS,
                    f"dp: {dtype} DP steps launched {runs['dp']['launches']}")
            out["train"][dtype] = dict(steps=DP_STEPS, loss=runs["dp"]["loss"],
                                       bit_for_bit=same, launches=runs["dp"]["launches"],
                                       plain_launches=runs["plain"]["launches"])
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

    canvas = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (DP_BATCH, DP_SIZE, DP_SIZE, 3), dtype=np.uint8)).to(dev)
    low = canvas.float() / 127.5 - 1.0
    for label, irb, dtype in DP_SERVED:
        pipe = ServingPipeline.from_artifact(STUDENT, device=dev, use_pallas_irb=irb)
        if dtype == "bfloat16":
            pipe = ServingPipeline(with_dtype(pipe.model, "bfloat16"), pipe.schedule,
                                   pipe.config, device=dev)
        sampler = make_sharded_sample_fn(pipe.model, pipe.schedule, mesh=mesh,
                                         timesteps=pipe.grid)
        params = pipe.model.state_dict()

        def plain(seed=0):
            return pipe._run(canvas, torch.Generator(device=dev).manual_seed(seed))

        def dp(seed=0):
            return dp_to_u8(sampler(params, torch.Generator(device=dev).manual_seed(seed), low))

        zero_launches()
        a, b = plain(), dp()
        launches = dp_launches()
        lsb = int((a.int() - b.int()).abs().max())
        require(lsb == 0, f"dp: {label} DP serving {lsb} LSB from ServingPipeline")
        require(launches["linear_attention"] > 0 and (launches["fused_irb_v2"] > 0) == irb,
                f"dp: {label} serving launched {launches}")
        times = {"plain": [], "dp": []}
        for i in range(DP_PAIRS):
            for which in ("plain", "dp", "dp", "plain"):
                torch.cuda.synchronize()
                start = time.perf_counter()
                (plain if which == "plain" else dp)(i)
                torch.cuda.synchronize()
                times[which].append((time.perf_counter() - start) * 1e3)
        row = dict(max_lsb=lsb, launches=launches,
                   graphs=sorted(sampler.graphs), launches_a_replay={
                       b: {k: v for k, v in g.launches.items() if v}
                       for b, g in sampler.graphs.items()},
                   plain_ms=float(np.median(times["plain"])),
                   dp_ms=float(np.median(times["dp"])),
                   plain_ms_all=times["plain"], dp_ms_all=times["dp"])
        row["dp_over_plain"] = row["dp_ms"] / row["plain_ms"]
        if label == "float32":
            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            with profile(activities=acts) as prof:
                dp(1)
                dp(2)
                torch.cuda.synchronize()
            events = [e.name for e in prof.events()]
            kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
            row["trace_events"] = len(events)
            row["trace_device_events"] = len(kernels)
            row["sampler_collectives"] = sorted({n for n in events if DP_COLLECTIVE.search(n)})
            with profile(activities=acts) as prof:
                t = torch.ones(1 << 20, device=dev)
                dist.all_reduce(t)
                torch.cuda.synchronize()
            row["control_collectives"] = sorted({e.name for e in prof.events()
                                                 if DP_COLLECTIVE.search(e.name)})
            require(row["trace_device_events"] > 0 and not row["sampler_collectives"],
                    f"dp: the DP sampler's trace: {row['trace_device_events']} device "
                    f"events, collectives {row['sampler_collectives']}")
            require(row["control_collectives"] and float(t[0]) == 1.0,
                    "dp: an NCCL all_reduce left no collective in its trace")
        out["serve"][label] = row
        del pipe, sampler, params
        torch.cuda.empty_cache()
    return out


def cuda_ms(fn, iters=200, warmup=20) -> float:
    """Device ms of one call of ``fn`` (CUDA events around ``iters`` calls)."""
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


def graph_ms(fn, iters=200, warmup=20) -> float:
    """Device time of one call, without the host's launch cost: the
    call captured once in a CUDA graph and replayed."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters, warmup)


def sharded_attention_rows(dev) -> dict:
    """The token-sharded linear-attention entries at SP_ATTN_SHAPE, f32 and
    bf16: each against its plain version on the same inputs, every output
    within SP_REL_TOL of its dtype times the reference's largest magnitude
    (float32 outputs 2e-5; bf16 ones 4 bf16 ulps, as ``flash_limit``); a
    control, the plain version with one input doubled (v; kv, not Σφ(K);
    g; the reduced d_kv and d_ksum), that must fail the same gate; and
    times: ms and graph ms of the kernel and of the plain version, and the
    bound from the bytes each moves and the operations it does."""
    import torch
    from cv_diffusion_tpu_torch.ops import attention as att
    from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak

    rows = {}
    b, n, h, d = SP_ATTN_SHAPE
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        gen = torch.Generator(device=dev).manual_seed(5)
        q, k, v, g = (torch.randn(SP_ATTN_SHAPE, generator=gen, device=dev).to(dtype)
                      for _ in range(4))
        kvs = att.linear_attention_kv_plain(k, v)
        dkvs = att.linear_attention_bwd_partial_plain(q, g, kvs)[1]
        kv2 = kvs.clone()
        kv2[..., :d * d] *= 2
        calls = {   # kernel, plain version, inputs, the control's inputs
            "kv": (lak.linear_attention_kv_kernel, att.linear_attention_kv_plain,
                   (k, v), (k, 2 * v)),
            "apply": (lak.linear_attention_apply_kernel, att.linear_attention_apply_plain,
                      (q, kvs), (q, kv2)),
            "bwd_partial": (lak.linear_attention_bwd_partial_kernel,
                            att.linear_attention_bwd_partial_plain, (q, g, kvs),
                            (q, 2 * g, kvs)),
            "bwd_finish": (lak.linear_attention_bwd_finish_kernel,
                           att.linear_attention_bwd_finish_plain, (k, v, dkvs),
                           (k, v, 2 * dkvs))}
        elems, es = b * n * h * d, torch.tensor([], dtype=dtype).element_size()
        sums = 4 * b * h * d * (d + 1)
        moved = {"kv": 2 * elems * es + sums, "apply": 2 * elems * es + sums,
                 "bwd_partial": 3 * elems * es + 2 * sums,
                 "bwd_finish": 4 * elems * es + sums}
        for entry in SP_ENTRIES:
            kernel, plain, args, moved_args = calls[entry]
            got, want, control = kernel(*args), plain(*args), plain(*moved_args)
            torch.cuda.synchronize()
            got, want, control = ((x,) if torch.is_tensor(x) else x
                                  for x in (got, want, control))

            def excess(outs):   # the worst error over its limit, each output
                return max(float((o.float() - r.float()).abs().max())
                           - SP_REL_TOL[str(r.dtype).split(".")[-1]]
                           * float(r.float().abs().max()) for o, r in zip(outs, want))

            err = max(float((o.float() - r.float()).abs().max() / r.float().abs().max())
                      for o, r in zip(got, want))
            control_err = max(float((o.float() - r.float()).abs().max() / r.float().abs().max())
                              for o, r in zip(control, want))
            require(excess(got) <= 0 < excess(control),
                    f"dp: sharded linear attention {entry} {dtype_name}: relative error "
                    f"{err}, control {control_err}")
            t_bytes = moved[entry] / HBM_BYTES_PER_S
            t_ops = elems * SP_FLOPS[entry](d) / F32_FLOPS_PER_S
            rows[(entry, dtype_name)] = dict(
                shape=list(SP_ATTN_SHAPE), dtype=dtype_name,
                max_abs_err=max(float((o.float() - r.float()).abs().max())
                                for o, r in zip(got, want)),
                max_rel_err=err, control_rel_err=control_err,
                ms=cuda_ms(lambda: kernel(*args)), graph_ms=graph_ms(lambda: kernel(*args)),
                plain_ms=cuda_ms(lambda: plain(*args), iters=20),
                plain_graph_ms=graph_ms(lambda: plain(*args), iters=20),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=moved[entry], flops=elems * SP_FLOPS[entry](d))
    return rows


def dp_spatial(dev, rank: int, batch, one_step, step) -> dict:
    """World 2 on a (1, 2) mesh, each process 128 of the 256 image rows
    (256 of 512 at the 512² forward): the student served at batch 2 in
    float32, with ``use_pallas_irb`` and in bf16 against ``pipe._run``
    (float32 within GRAPH_LSB_TOL, every strip alone the control); one
    forward of its weights at 512² against one process's (SP_FORWARD_TOL,
    the strips alone the control); a train step on the train batch against
    one process's (``one_step``, rank 0; the STEP_* gates, rank 1 seeded 1
    the control); the launches of each kernel in each run, per rank; and on
    rank 0 the token-sharded entries against their plain versions, timed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cv_diffusion_tpu_torch.export.serving import ServingPipeline
    from cv_diffusion_tpu_torch.models.diffusion import (run_sampler, sampler_noise,
                                                        with_dtype)
    from cv_diffusion_tpu_torch.parallel import (gather, make_mesh, make_sharded_sample_fn,
                                                 shard_batch)
    from cv_diffusion_tpu_torch.parallel.mesh import all_gather_rows, data_shard, spatial_scope

    sp = make_mesh((1, 2))
    shard = data_shard(sp).spatial
    out = {"mesh": dict(sp.shape), "serve": {}, "launches": {}}

    def whole_rows(x):      # NCHW strips → the whole image, every process
        return all_gather_rows(x.movedim(2, 0).contiguous(), shard.group).movedim(0, 2)

    def excess(a, ref):     # > 0 where a is outside SP_FORWARD_TOL of ref
        return float(((a - ref).abs() - SP_FORWARD_TOL["atol"]
                      - SP_FORWARD_TOL["rtol"] * ref.abs()).max())

    canvas = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (SP_SERVE_BATCH, DP_SIZE, DP_SIZE, 3), dtype=np.uint8)).to(dev)
    low = canvas.float() / 127.5 - 1.0
    strip = slice(rank * DP_SIZE // 2, (rank + 1) * DP_SIZE // 2)
    f32_one = None      # rank 0: the float32 pipeline's image
    for label, irb, dtype in DP_SERVED:
        pipe = ServingPipeline.from_artifact(STUDENT, device=dev, use_pallas_irb=irb)
        if dtype == "bfloat16":
            pipe = ServingPipeline(with_dtype(pipe.model, "bfloat16"), pipe.schedule,
                                   pipe.config, device=dev)
        sampler = make_sharded_sample_fn(pipe.model, pipe.schedule, mesh=sp, timesteps=pipe.grid)
        zero_launches()
        local = sampler(pipe.model.state_dict(), torch.Generator(device=dev).manual_seed(4), low)
        torch.cuda.synchronize()
        launches = dp_launches()
        whole = dp_to_u8(gather(sp, local))
        init, noise = sampler_noise(torch.Generator(device=dev).manual_seed(4),
                                    (SP_SERVE_BATCH, DP_SIZE, DP_SIZE, 3), len(pipe.grid), dev)
        with torch.inference_mode():
            alone = run_sampler(pipe.model, pipe.schedule, low[:, strip], init[:, strip],
                                noise[:, :, strip], pipe.grid).float()
        alone = dp_to_u8(gather(sp, alone))
        require(launches["linear_attention_kv"] > 0 and launches["linear_attention_apply"] > 0
                and launches["linear_attention"] == 0
                and (launches["fused_irb_v2"] > 0) == irb,
                f"dp: process {rank}'s spatial {label} serve launched {launches}")
        row = dict(launches=launches, graphs=sorted(sampler.graphs),
                   local_shape=list(local.shape))
        if rank == 0:
            one = pipe._run(canvas, torch.Generator(device=dev).manual_seed(4))
            lsb = int((one.int() - whole.int()).abs().max())
            control = int((one.int() - alone.int()).abs().max())
            row.update(max_lsb=lsb, values_off=int((one != whole).sum()),
                       control_alone_lsb=control)
            if dtype == "float32":
                require(lsb <= GRAPH_LSB_TOL < control,
                        f"dp: spatial {label} serving {lsb} LSB from one process "
                        f"(the strips alone: {control})")
                if not irb:
                    f32_one = one
            else:
                # bf16 rounds the strips' sums apart from the whole image's:
                # held as close to the float32 image as one process's bf16
                dist_f32 = {k: float((x.float() - f32_one.float()).abs().mean())
                            for k, x in (("one_process", one), ("spatial", whole),
                                         ("alone", alone))}
                row.update(mean_lsb_from_float32=dist_f32,
                           bf16_ratio_tol=SP_BF16_RATIO)
                require(dist_f32["spatial"] <= SP_BF16_RATIO * dist_f32["one_process"]
                        < dist_f32["alone"],
                        f"dp: spatial bf16 serving's mean LSB from float32: {dist_f32}")
        require(not sampler.graphs, "dp: the spatial sampler captured a CUDA graph")
        out["serve"][label] = row
        del pipe, sampler
        torch.cuda.empty_cache()

    model, _ = dp_student(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    size = SP_FORWARD_SIZE
    x = torch.randn(1, 3, size, size, generator=gen, device=dev)
    cond = -torch.rand(1, 3, size, size, generator=gen, device=dev)
    t = torch.tensor([500], device=dev)
    rows512 = slice(rank * size // 2, (rank + 1) * size // 2)
    zero_launches()
    with torch.no_grad():
        with spatial_scope(shard):
            got = model(x[:, :, rows512], cond[:, :, rows512], t)
        torch.cuda.synchronize()
        out["launches"]["forward_512"] = dp_launches()
        got = whole_rows(got)
        alone = whole_rows(model(x[:, :, rows512], cond[:, :, rows512], t))
        if rank == 0:
            ref = model(x, cond, t)
            out["forward_512"] = dict(excess=excess(got, ref), control_excess=excess(alone, ref),
                                      max_abs_err=float((got - ref).abs().max()),
                                      tol=SP_FORWARD_TOL)
            require(out["forward_512"]["excess"] <= 0 < out["forward_512"]["control_excess"],
                    f"dp: the spatial 512² forward: {out['forward_512']}")
    del model, x, cond, got, alone
    torch.cuda.empty_cache()
    require(out["launches"]["forward_512"]["linear_attention_kv"] > 0,
            f"dp: process {rank}'s 512² forward launched {out['launches']['forward_512']}")

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        zero_launches()
        got = step(sp, shard_batch(sp, batch), 0)
        out["launches"]["train"] = dp_launches()
        control = step(sp, shard_batch(sp, batch), rank)     # rank 1 seeded 1
        if rank == 0:
            d, c = step_diffs(got, one_step), step_diffs(control, one_step)
            require(within(d), f"dp: the spatial step against one process: {d}")
            require(not within(c), f"dp: the spatial step's control passed: {c}")
            out["train"] = dict(vs_one_process=d, control_other_seed=c, loss=got[0])
        del got, control
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    trained = out["launches"]["train"]
    require(all(trained[f"linear_attention_{e}"] > 0 for e in SP_ENTRIES)
            and trained["linear_attention"] == trained["linear_attention_backward"] == 0,
            f"dp: process {rank}'s spatial step launched {trained}")
    torch.cuda.empty_cache()
    if rank == 0:
        out["entries"] = {f"{e} {dt}": r for (e, dt), r in sharded_attention_rows(dev).items()}
    dist.barrier()
    return out


def dp_pair(dev, rank: int) -> dict:
    """World size 2 over gloo, both processes on the card: a DP train step
    against one process's at the global batch (rank 0), with a control;
    token-sharded linear attention against the whole sequence's kernel, with
    a control; DP serving gathered against one process's; then the spatial
    axis on a (1, 2) mesh (:func:`dp_spatial`)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cv_diffusion_tpu_torch.config import TrainConfig
    from cv_diffusion_tpu_torch.export.serving import ServingPipeline
    from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak
    from cv_diffusion_tpu_torch.ops.attention import (linear_attention_plain,
                                                      linear_attention_sharded)
    from cv_diffusion_tpu_torch.parallel import (gather, make_mesh, make_sharded_sample_fn,
                                                 shard_batch)
    from cv_diffusion_tpu_torch.training.train_state import (create_train_state,
                                                             make_train_step)

    mesh = make_mesh()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "mesh": dict(mesh.shape), "rank": rank}
    batch = softmax_batches(1, seed=6)[0]
    tc = TrainConfig(use_amp=False, epochs=1, warmup_epochs=0)

    def step(m, rows, seed):
        model, schedule = dp_student(dev)
        state = create_train_state(model, dataclasses.replace(tc, seed=seed),
                                   steps_per_epoch=1)
        state, met = make_train_step(model, schedule, tc, mesh=m)(state, rows)
        torch.cuda.synchronize()
        return dp_step_record(model, met["loss"], met["grad_norm"], tc.gradient_clip)

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        zero_launches()
        got = step(mesh, shard_batch(mesh, batch), 0)
        out["train_launches"] = dp_launches()
        control = step(mesh, shard_batch(mesh, batch), rank)   # rank 1 seeded 1
        want = None
        if rank == 0:
            want = step(None, batch, 0)
            d, c = step_diffs(got, want), step_diffs(control, want)
            require(within(d), f"dp: the world-2 step against one process: {d}")
            require(not within(c), f"dp: the control (rank 1 seeded 1) passed: {c}")
            out["train"] = dict(vs_one_process=d, control_other_seed=c, loss=got[0],
                                tol=dict(loss_rel=STEP_LOSS_TOL,
                                         grad_norm_rel=STEP_GRAD_NORM_TOL,
                                         grad_tensor_rel=STEP_GRAD_TOL,
                                         param_differ_share=STEP_PARAM_SHARE))
        del got, control
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    require(out["train_launches"]["linear_attention"] > 0
            and out["train_launches"]["linear_attention_backward"] > 0,
            f"dp: process {rank}'s step launched {out['train_launches']}")

    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(DP_ATTN_SHAPE, generator=gen, device=dev) for _ in range(3))
    sp = make_mesh((1, 2))
    n = DP_ATTN_SHAPE[1] // 2
    toks = slice(rank * n, (rank + 1) * n)
    local = linear_attention_sharded(q[:, toks], k[:, toks], v[:, toks], sp)
    whole = lak.linear_attention_kernel(q, k, v)[:, toks]
    alone = linear_attention_plain(q[:, toks], k[:, toks], v[:, toks])
    err, control_err = (float((x - whole).abs().max()) for x in (local, alone))
    require(err <= TOL["float32"] < control_err,
            f"dp: sharded linear attention {err}, its control {control_err}")
    out["attention"] = dict(shape=list(DP_ATTN_SHAPE), spatial=2, max_abs_err=err,
                            control_unreduced_err=control_err, tol=TOL["float32"])

    pipe = ServingPipeline.from_artifact(STUDENT, device=dev)
    sampler = make_sharded_sample_fn(pipe.model, pipe.schedule, mesh=mesh, timesteps=pipe.grid)
    canvas = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (DP_BATCH, DP_SIZE, DP_SIZE, 3), dtype=np.uint8)).to(dev)
    zero_launches()
    local = sampler(pipe.model.state_dict(), torch.Generator(device=dev).manual_seed(4),
                    canvas.float() / 127.5 - 1.0)
    out["serve_launches"] = dp_launches()
    whole = dp_to_u8(gather(mesh, local))
    require(out["serve_launches"]["linear_attention"] > 0,
            f"dp: process {rank}'s serve launched {out['serve_launches']}")
    if rank == 0:
        one = pipe._run(canvas, torch.Generator(device=dev).manual_seed(4))
        lsb = int((one.int() - whole.int()).abs().max())
        require(lsb <= GRAPH_LSB_TOL, f"dp: world-2 serving {lsb} LSB from one process")
        out["serve"] = dict(max_lsb=lsb, values_off=int((one != whole).sum()),
                            local_rows=int(local.shape[0]), graphs=sorted(sampler.graphs))
    del pipe, sampler
    torch.cuda.empty_cache()
    out["spatial"] = dp_spatial(dev, rank, batch, want, step)
    return out


def dp_rank_main(world: int, rank: int, port: int, backend: str, path: str) -> int:
    """One process of the dp phase: join the group, run its part, write it."""
    import torch

    from cv_diffusion_tpu_torch.device import pin_fp32
    from cv_diffusion_tpu_torch.parallel import distributed_init, local_device

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    require(distributed_init(f"localhost:{port}", world, rank, device="cuda",
                             backend=backend), "dp: no process group")
    dev = local_device("cuda")
    pin_fp32()
    result = dp_single(dev) if world == 1 else dp_pair(dev, rank)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(path, "w") as f:
        json.dump(result, f)
    return 0


def dp_phase() -> dict:
    """Phase 27: world size 1 over NCCL, then 2 over gloo on the one card,
    each process a ``--dp-rank`` subprocess; any process's failure fails
    the phase. Returns the ``dp`` line's fields."""
    import socket

    t0 = time.perf_counter()
    runs = {}
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", PYTHONPATH=ROOT)
    for world, backend in ((1, "nccl"), (2, "gloo")):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        directory = tempfile.mkdtemp(prefix="dp_ranks_", dir=build_dir())
        paths = [os.path.join(directory, f"rank{r}.json") for r in range(world)]
        logs = [open(os.path.join(directory, f"rank{r}.log"), "w+") for r in range(world)]
        start = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", str(world), str(r),
             str(port), backend, paths[r]], env=env, stdout=logs[r],
            stderr=subprocess.STDOUT, cwd=ROOT) for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=DP_TIMEOUT)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        for r, _ in failed:
            logs[r].seek(0)
            print(logs[r].read()[-6000:], file=sys.stderr)
        for f in logs:
            f.close()
        require(not failed, f"dp: world {world} over {backend}: processes exited {failed}")
        runs[world] = dict(backend=backend, seconds=time.perf_counter() - start,
                           ranks=[json.load(open(p)) for p in paths])
        shutil.rmtree(directory, ignore_errors=True)
    single, pair = runs[1]["ranks"][0], runs[2]["ranks"]
    per_rank = [dict(rank=r["rank"], train=r["train_launches"], serve=r["serve_launches"],
                     spatial=dict({k: v["launches"] for k, v in r["spatial"]["serve"].items()},
                                  **r["spatial"]["launches"]))
                for r in pair]
    spatial = pair[0]["spatial"]
    emit("dp", world1=dict(single, seconds=runs[1]["seconds"]),
         world2=dict(backend="gloo", seconds=runs[2]["seconds"], launches=per_rank,
                     train=pair[0]["train"], attention=[r["attention"] for r in pair],
                     serve=pair[0]["serve"],
                     spatial={k: v for k, v in spatial.items() if k != "launches"}),
         seconds=time.perf_counter() - t0)
    launches = {k: single["train"]["float32"]["launches"][k]
                + sum(r["train_launches"][k] + r["serve_launches"][k] for r in pair)
                + single["serve"]["float32"]["launches"][k]
                + single["serve"]["float32+use_pallas_irb"]["launches"][k]
                for k in ("linear_attention", "linear_attention_backward", "fused_irb_v2")}
    bf16 = {k: single["train"]["bfloat16"]["launches"][k]
            + single["serve"]["bfloat16"]["launches"][k]
            for k in ("linear_attention", "linear_attention_backward")}
    # the spatial runs' launches over both processes: float32 (the served
    # student, with use_pallas_irb, the 512² forward, the train step) and bf16
    f32_runs = ("float32", "float32+use_pallas_irb", "forward_512", "train")
    sharded = {dt: {k: sum(r["spatial"][run][k] for r in per_rank for run in runs)
                    for k in ("fused_irb_v2",) + tuple(f"linear_attention_{e}"
                                                       for e in SP_ENTRIES)}
               for dt, runs in (("float32", f32_runs), ("bfloat16", ("bfloat16",)))}
    launches["fused_irb_v2"] += sharded["float32"]["fused_irb_v2"]
    return {"float32": launches, "bfloat16": bf16, "spatial": sharded,
            "entries": spatial["entries"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace the 1-step student's serving and "
                             "three train steps with torch.profiler")
    parser.add_argument("--dp-rank", nargs=5, default=None,
                        metavar=("WORLD", "RANK", "PORT", "BACKEND", "OUT"),
                        help="(the dp phase starts these) run one process of it")
    args = parser.parse_args()
    if args.dp_rank is not None:
        world, rank, port, backend, path = args.dp_rank
        return dp_rank_main(int(world), int(rank), int(port), backend, path)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1

    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from cv_diffusion_tpu_torch.config import (TrainConfig, diffusion_config,
                                               load_model_config)
    from cv_diffusion_tpu_torch.data.dataset import (DataLoader,
                                                     SyntheticLowLightDataset)
    from cv_diffusion_tpu_torch.models.diffusion import (diffusion_loss,
                                                        train_forward)
    from cv_diffusion_tpu_torch.models.unet import count_params
    from cv_diffusion_tpu_torch.training.train_state import (
        apply_update, create_train_state, make_train_step)
    from cv_diffusion_tpu_torch.training.trainer import Trainer
    from cv_diffusion_tpu_torch.device import pin_fp32
    from cv_diffusion_tpu_torch.export.quantization import (
        dequantize_int8, quantization_error, quantization_report, quantize_model)
    from cv_diffusion_tpu_torch.export.serving import (
        GRAPH_WARMUP, ServingPipeline, create_serving_package, load_serving_package)
    from cv_diffusion_tpu_torch.export.serving import kernel_launches as all_launches
    from cv_diffusion_tpu_torch.models.blocks import (InvertedResidualBlock,
                                                      LinearAttention)
    from cv_diffusion_tpu_torch.models.diffusion import create_model, enhance, with_dtype
    from cv_diffusion_tpu_torch.models import blocks as tblocks
    from cv_diffusion_tpu_torch.ops import fused_irb_kernel as fik
    from cv_diffusion_tpu_torch.ops import flash_attention_kernel as fk
    from cv_diffusion_tpu_torch.ops import linear_attention_kernel as lak
    from cv_diffusion_tpu_torch.ops import qconv_kernel as qk
    from cv_diffusion_tpu_torch.ops.attention import (
        linear_attention_backward_plain, linear_attention_plain)
    from cv_diffusion_tpu_torch.ops import cuda_build
    from cv_diffusion_tpu_torch.ops.fused_irb import (folded_gn_scales,
                                                     fused_irb_v1_plain,
                                                     fused_irb_v2_plain, irb_args)
    from cv_diffusion_tpu_torch import evaluate as ev
    from cv_diffusion_tpu_torch.weights import init_weights, load_state_dict_npz

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    pin_fp32()   # the plain versions' convolutions in full f32, as served
    qconv_kernels = ("qconv_quantize", "qconv_quantize_weight", "qconv_dense",
                     "qconv_depthwise")

    def linear_path_launches():
        """The wrappers' launch counts on a linear-attention path, where the
        flash-attention kernels must not have launched."""
        counts = all_launches()
        require(not any(counts[k] for k in FLASH_KERNELS),
                f"flash-attention kernels launched on a linear-attention path: {counts}")
        return {k: v for k, v in counts.items() if k not in FLASH_KERNELS}

    def kernel_launches():
        """The float paths' kernels' launch counts; on a float path the int8
        kernels must not have launched."""
        counts = linear_path_launches()
        require(not any(counts[k] for k in qconv_kernels),
                f"int8 kernels launched on a float path: {counts}")
        return {k: v for k, v in counts.items() if k not in qconv_kernels}

    # 1. device -----------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi_line = smi.splitlines()[0].strip()
    emit("device", nvidia_smi=smi_line, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, seconds=time.perf_counter() - t0)

    # 2. build: one nvcc per source, all started together -----------------
    def timed_build(module):
        start = time.perf_counter()
        return module.build(), time.perf_counter() - start

    t0 = time.perf_counter()
    wrappers = (("linear_attention", lak), ("fused_irb (v2, v1)", fik), ("qconv (int8)", qk),
                ("flash_attention", fk))
    with ThreadPoolExecutor(len(wrappers)) as pool:
        builds = list(pool.map(timed_build, (m for _, m in wrappers)))
    for (name, module), (built, seconds) in zip(wrappers, builds):
        print(built.log, file=sys.stderr)
        fields = {}
        if module is lak:      # registers and spills of each instance
            fields["kernels"] = ptxas_report(built.log)
        if module is fk:
            fields = flash_build_report(built)
        if module is qk:
            fields = qconv_build_report(built, qk)
        if module is fik:      # registers and spills of each fused-IRB kernel
            report = ptxas_report(built.log)
            require(any(k.startswith(NO_SPILL_KERNELS) for k in report),
                    f"no ptxas report of {NO_SPILL_KERNELS} in the build log")
            spilled = {k: v for k, v in report.items()
                       if k.startswith(NO_SPILL_KERNELS) and v["spill_bytes"]}
            require(not spilled, f"fused-IRB passes spill: {spilled}")
            fields["kernels"] = report
        emit("build", kernel=name, library=os.path.relpath(built.path, ROOT),
             compiled=built.compiled, seconds=seconds, **fields)
    emit("build_done", seconds=time.perf_counter() - t0)

    # 3. kernel vs plain --------------------------------------------------
    def bound(moved, flops):
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    def attention_bound(shape, dtype):
        b, n, h, d = shape
        elems = b * n * h * d
        moved = 4 * elems * torch.tensor([], dtype=dtype).element_size()
        flops = elems * (4 * d + 6)   # kv, num: 2·D each; ksum, den, φ, divide
        return bound(moved, flops) + (moved, flops)

    def device_ops_per_call(fn, calls=10) -> float:
        """Device kernels (and copies) per call of ``fn`` (:func:`device_kernels`)."""
        return sum(device_kernels(fn, calls).values())

    la_lib = cuda_build.load(lak.SOURCE, lak._declare)

    def attention_plan(shape, dtype, backward):
        """The wrapper's plan, held to the library's own shared-memory
        size; with the profiler's count of device kernels a call."""
        p = lak.plan(*shape, dtype, backward=backward)
        lib_smem = la_lib.linear_attention_smem_bytes(shape[-1], int(backward), p.rows)
        require(lib_smem == p.smem_bytes,
                f"plan {p} vs the library's {lib_smem} bytes of shared memory")
        return dict(p._asdict())

    def compare(q, k, v):
        out = lak.linear_attention_kernel(q, k, v)
        again = lak.linear_attention_kernel(q, k, v)
        ref = linear_attention_plain(q, k, v)
        torch.cuda.synchronize()
        require(out.dtype == q.dtype and out.shape == q.shape,
                f"kernel output {out.dtype} {tuple(out.shape)}")
        require(torch.equal(out, again), "kernel reruns differ")
        return float((out.float() - ref.float()).abs().max())

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = ([((b, 1024, 4, 32), dt, True) for b in (1, 8)
              for dt in (torch.float32, torch.bfloat16)]
             + [(s, torch.float32, False)
                for s in ((2, 256, 4, 32), (1, 1000, 4, 32), (2, 64, 2, 32),
                          (1, 128, 1, 128), (1, 128, 6, 32), (1, 192, 8, 32),
                          (2, 300, 3, 64), (1, 1, 1, 32), (1, 5, 2, 32),
                          (1, 100, 2, 32), (1, 4096, 4, 32), (1, 1024, 1, 128),
                          (1, 1024, 2, 64))]
             + [((1, 128, 1, 128), torch.bfloat16, False)])
    timings = {}
    for shape, dtype, timed in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        name = str(dtype).replace("torch.", "")
        err = compare(q, k, v)
        require(err <= TOL[name], f"kernel vs plain {shape} {name}: {err}")
        row = dict(kernel="linear_attention", shape=list(shape), dtype=name,
                   max_err=err, tol=TOL[name],
                   plan=attention_plan(shape, dtype, False),
                   kernels_per_call=device_ops_per_call(
                       lambda: lak.linear_attention_kernel(q, k, v)))
        require(row["kernels_per_call"] == 1,
                f"forward {shape} {name}: {row['kernels_per_call']} device "
                "kernels a call, not 1")
        if timed:
            bound_ms, bound_by, moved, flops = attention_bound(shape, dtype)
            kernel = lambda: lak.linear_attention_kernel(q, k, v)  # noqa: E731
            plain = lambda: linear_attention_plain(q, k, v)  # noqa: E731
            row.update(
                kernel_ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                kernel_graph_ms=graph_ms(kernel), plain_graph_ms=graph_ms(plain),
                bound_us=bound_ms * 1e3, bound_by=bound_by,
                bytes=moved, flops=flops, library_ms=None,
                library="none: no single PyTorch call computes linear attention")
            timings[(shape, name)] = row
        emit("kernel", **row)

    # linear attention's backward against its plain version: mid_attn's
    # shape in training (batch 8) and serving (1), and the JAX tests' shapes
    def attention_bwd_work(shape, dtype):
        """(bytes, FLOP): q, k, v, g read and dq, dk, dv written once; the
        two contractions each of kv, num, dφq, d_kv, dφk and dv (12·D² a
        token and head) and the per-token vector work (~16·D)."""
        b, n, h, d = shape
        elems = b * n * h * d
        moved = 7 * elems * torch.tensor([], dtype=dtype).element_size()
        return moved, b * n * h * (12 * d * d + 16 * d)

    def compare_bwd(q, k, v, g):
        got = lak.linear_attention_backward_kernel(q, k, v, g)
        again = lak.linear_attention_backward_kernel(q, k, v, g)
        ref = linear_attention_backward_plain(q, k, v, g)
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            require(a.dtype == q.dtype and a.shape == q.shape,
                    f"backward output {a.dtype} {tuple(a.shape)}")
            require(bool(torch.isfinite(a).all()), "backward: non-finite output")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                "backward kernel reruns differ")
        return max(float((a.float() - r.float()).abs().max())
                   for a, r in zip(got, ref))

    bwd_cases = ([((b, 1024, 4, 32), dt, True) for b in (1, 8)
                  for dt in (torch.float32, torch.bfloat16)]
                 + [(s, torch.float32, False)
                    for s in ((2, 256, 4, 32), (1, 100, 2, 32), (1, 128, 6, 32),
                              (1, 128, 1, 128), (2, 300, 3, 64), (1, 1, 1, 32),
                              (1, 5, 2, 32), (1, 4096, 4, 32), (1, 1024, 1, 128),
                              (1, 1024, 2, 64))])
    bwd_rows = {}
    for shape, dtype, timed in bwd_cases:
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                      for _ in range(4))
        name = str(dtype).replace("torch.", "")
        err = compare_bwd(q, k, v, g)
        require(err <= BWD_TOL[name], f"backward kernel vs plain {shape} {name}: {err}")
        row = dict(kernel="linear_attention_backward", shape=list(shape),
                   dtype=name, max_err=err, tol=BWD_TOL[name],
                   plan=attention_plan(shape, dtype, True),
                   kernels_per_call=device_ops_per_call(
                       lambda: lak.linear_attention_backward_kernel(q, k, v, g)))
        require(row["kernels_per_call"] == 1,
                f"backward {shape} {name}: {row['kernels_per_call']} device "
                "kernels a call, not 1")
        if timed:
            moved, flops = attention_bwd_work(shape, dtype)
            bound_ms, bound_by = bound(moved, flops)
            kernel = lambda: lak.linear_attention_backward_kernel(q, k, v, g)  # noqa: E731
            plain = lambda: linear_attention_backward_plain(q, k, v, g)  # noqa: E731
            row.update(
                kernel_ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                kernel_graph_ms=graph_ms(kernel), plain_graph_ms=graph_ms(plain),
                bound_ms=bound_ms, bound_by=bound_by, bytes=moved, flops=flops,
                library_ms=None,
                library="none: no single PyTorch call computes this backward")
        bwd_rows[(shape, name)] = row
        emit("kernel", **row)

    # the fused IRB at the shapes one small-UNet call at 256² gives it
    art = {a: os.path.join(ROOT, "artifacts", a) for _, a, _, _ in SERVED}
    cfg = load_model_config(os.path.join(art["vreg1b_gt03_ema"], "model_config.json"))
    fused_cfg = dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, use_pallas_irb=True))
    weights = init_weights(cfg, seed=0, device=dev)
    probe, _ = create_model(fused_cfg, device=dev)
    probe.load_state_dict(weights, strict=True)
    irb_calls = []   # (name, Cin, H, W) of each IRB call, in order
    hooks = [m.register_forward_pre_hook(
        lambda mod, a, name=name: irb_calls.append((name,) + tuple(a[0].shape[1:]))
    ) for name, m in probe.unet.named_modules()
        if isinstance(m, InvertedResidualBlock)]
    size = cfg.unet.image_size
    with torch.inference_mode():
        probe.unet(torch.zeros(1, cfg.unet.in_channels, size, size, device=dev),
                   torch.tensor([739], dtype=torch.int32, device=dev))
    for h in hooks:
        h.remove()
    require(len(irb_calls) == IRBS_PER_UNET_CALL,
            f"{len(irb_calls)} IRBs in a UNet call, not {IRBS_PER_UNET_CALL}")
    blocks = dict(probe.unet.named_modules())
    per_call = {}   # (Cin, Chid, Cout, H) → [first block's name, IRBs of that shape a call]
    for name, cin, height, _ in irb_calls:
        blk = blocks[name]
        key = (cin, blk.expand.weight.shape[0], blk.project.weight.shape[0], height)
        per_call.setdefault(key, [name, 0])[1] += 1

    def irb_inputs(block, b, height, width, dtype, use_se=True, silu=False,
                   tdim=cfg.unet.time_embed_dim):
        cin = block.expand.weight.shape[1]
        x = torch.randn((b, cin, height, width), generator=gen, device=dev).to(dtype)
        temb = torch.randn((b, tdim), generator=gen, device=dev)
        with torch.inference_mode():
            fs, fb = block.time_mlp(temb).chunk(2, dim=-1)
        kw = irb_args(block)
        if not use_se:
            kw.update(use_se=False, se_w1=None, se_b1=None, se_w2=None, se_b2=None)
        kw["silu"] = silu
        return x, dict(film_scale=fs, film_shift=fb, **kw)

    def irb_compare(x, kw):
        with torch.inference_mode():
            out = fik.fused_irb_v2(x, **kw)
            again = fik.fused_irb_v2(x, **kw)
            ref = fused_irb_v2_plain(x, **kw)
        torch.cuda.synchronize()
        require(out.dtype == x.dtype and out.shape == ref.shape,
                f"fused kernel output {out.dtype} {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), "fused kernel: non-finite output")
        require(torch.equal(out, again), "fused kernel reruns differ")
        return float((out.float() - ref.float()).abs().max())

    def irb_work(x, kw):
        """(bytes, FLOP) of one call, each counted once: x read, out written,
        weights read; expand, depthwise, project and skip. The Gram of the
        GN2 fold is not counted: the function needs GN2's statistics, not
        the Gram, and they can come from h1 itself, whose write and re-read
        take less time than these operations at every serving shape."""
        b, cin, height, width = x.shape
        chid, cout = kw["wexp"].shape[0], kw["wproj"].shape[0]
        n = b * height * width
        weights_n = sum(t.numel() for k, t in kw.items()
                        if isinstance(t, torch.Tensor) and k.startswith(("w", "se_", "gn")))
        moved = (cin + cout) * n * x.element_size() + 4 * weights_n
        flops = 2 * n * (cin * chid + 9 * chid + chid * cout
                         + (cin * cout if kw.get("wskip") is not None else 0))
        return moved, flops

    def irb_tc_bound(x, kw, bf16_products):
        """The least time of one call on the tensor cores (ms): the bytes of
        irb_work; the products' FLOP three times at the TF32 rate (3×TF32:
        float32 operands, v2's f32 entry and both of v1's) or once at the
        bf16 rate (v2's bf16 entry); the depthwise at the float32 rate."""
        b, cin, height, width = x.shape
        chid, cout = kw["wexp"].shape[0], kw["wproj"].shape[0]
        n = b * height * width
        moved, _ = irb_work(x, kw)
        products = 2 * n * (cin * chid + chid * cout
                            + (cin * cout if kw.get("wskip") is not None else 0))
        t_products = (products / BF16_FLOPS_PER_S if bf16_products
                      else 3 * products / TF32_FLOPS_PER_S)
        return max(moved / HBM_BYTES_PER_S, t_products,
                   2 * n * 9 * chid / F32_FLOPS_PER_S) * 1e3

    def irb_v1_compare(x, kw):
        """v1 against its plain version: (max abs error, its bound)."""
        fik.fused_irb_v1.launches = 0
        with torch.inference_mode():
            out = fik.fused_irb_v1(x, **kw)
            again = fik.fused_irb_v1(x, **kw)
            ref = fused_irb_v1_plain(x, **kw)
        torch.cuda.synchronize()
        require(fik.fused_irb_v1.launches == 2,
                f"fused_irb_v1: {fik.fused_irb_v1.launches} launches for 2 calls")
        require(out.dtype == x.dtype and out.shape == ref.shape,
                f"fused_irb_v1 output {out.dtype} {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), "fused_irb_v1: non-finite output")
        require(torch.equal(out, again), "fused_irb_v1 reruns differ")
        err = float((out.float() - ref.float()).abs().max())
        # in bf16 both compute in float32 (2e-4 apart at most) and round only
        # the output, to the same bf16 value or to neighbours: one bf16 ulp
        # of the output's largest magnitude apart at most
        tol = (IRB_TOL["float32"] if x.dtype == torch.float32
               else bf16_ulp(float(ref.float().abs().max())))
        require(err <= tol, f"fused_irb_v1 vs plain {tuple(x.shape)} {x.dtype}: {err} > {tol}")
        return err, tol

    def irb_v1_row(x, kw, v2_row=None, **fields):
        """v1 against its plain version at one shape, timed, with v2's times
        on the same inputs beside it; emitted and returned."""
        err, tol = irb_v1_compare(x, kw)
        moved, flops = irb_work(x, kw)
        bound_ms, bound_by = bound(moved, flops)

        def kernel():
            with torch.inference_mode():
                fik.fused_irb_v1(x, **kw)

        def plain():
            with torch.inference_mode():
                fused_irb_v1_plain(x, **kw)

        row = dict(kernel="fused_irb_v1", **fields, shape=list(x.shape),
                   chid=kw["wexp"].shape[0], cout=kw["wproj"].shape[0],
                   dtype=str(x.dtype).replace("torch.", ""), max_err=err, tol=tol,
                   kernel_ms=cuda_ms(kernel, 20, 3), plain_ms=cuda_ms(plain, 20, 3),
                   kernel_graph_ms=graph_ms(kernel, 20, 3),
                   plain_graph_ms=graph_ms(plain, 20, 3),
                   bound_ms=bound_ms, bound_by=bound_by,
                   tc_bound_ms=irb_tc_bound(x, kw, False), bytes=moved, flops=flops,
                   library_ms=None,
                   library="none: no single PyTorch call computes the fused IRB")
        if v2_row is not None:
            row.update(v2_kernel_ms=v2_row["kernel_ms"],
                       v2_kernel_graph_ms=v2_row["kernel_graph_ms"],
                       v1_over_v2_graph=row["kernel_graph_ms"] / v2_row["kernel_graph_ms"])
        emit("kernel", **row)
        return row

    # v1 in bf16 at the widest block of each UNet level
    widest_of_level = {}     # height → (Cin, Chid, Cout, H) of the most input channels
    for key in sorted(per_call):
        widest_of_level[key[3]] = key
    irb_rows, v1_rows = {}, {}
    for (cin, chid, cout, height), (name, count) in sorted(per_call.items()):
        for b in (1, 8):
            for dtype in (torch.float32, torch.bfloat16):
                bf16_v2 = (cin, height) == (96, size)    # v2: bf16 at the widest block only
                bf16_v1 = widest_of_level[height] == (cin, chid, cout, height)
                if dtype == torch.bfloat16 and not (bf16_v1 or bf16_v2):
                    continue
                x, kw = irb_inputs(blocks[name], b, height, height, dtype)
                dname = str(dtype).replace("torch.", "")
                if dtype == torch.bfloat16 and not bf16_v2:
                    v1_rows[(cin, chid, cout, height, b, dname)] = irb_v1_row(
                        x, kw, block=name, per_unet_call=count)
                    continue
                err = irb_compare(x, kw)
                require(err <= IRB_TOL[dname],
                        f"fused kernel vs plain {name} {tuple(x.shape)} {dname}: {err}")
                moved, flops = irb_work(x, kw)
                bound_ms, bound_by = bound(moved, flops)

                def kernel(x=x, kw=kw):
                    with torch.inference_mode():
                        fik.fused_irb_v2(x, **kw)

                def plain(x=x, kw=kw):
                    with torch.inference_mode():
                        fused_irb_v2_plain(x, **kw)

                row = dict(kernel="fused_irb_v2", block=name, shape=[b, cin, height, height],
                           chid=chid, cout=cout, dtype=dname, per_unet_call=count,
                           max_err=err, tol=IRB_TOL[dname],
                           kernel_ms=cuda_ms(kernel, 20, 3), plain_ms=cuda_ms(plain, 20, 3),
                           kernel_graph_ms=graph_ms(kernel, 20, 3),
                           plain_graph_ms=graph_ms(plain, 20, 3),
                           bound_ms=bound_ms, bound_by=bound_by,
                           tc_bound_ms=irb_tc_bound(x, kw, dtype == torch.bfloat16),
                           bytes=moved, flops=flops,
                           plan=list(fik.plan(b, chid, cout, height, height)),
                           library_ms=None,
                           library="none: no single PyTorch call computes the fused IRB")
                irb_rows[(cin, chid, cout, height, b, dname)] = row
                emit("kernel", **row)
                if dtype == torch.float32 or bf16_v1:
                    v1_rows[(cin, chid, cout, height, b, dname)] = irb_v1_row(
                        x, kw, row, block=name, per_unet_call=count)
    # the widest blocks of the base (384 output channels) and large (512)
    # UNets at 256²: the middle blocks and the decoder's first concat blocks,
    # at 32²; more than 256 output channels take several output blocks
    wide_err = 0.0
    for variant, cin, cout, tdim in (("base", 384, 384, 192), ("base", 768, 384, 192),
                                     ("large", 512, 512, 256), ("large", 1024, 512, 256)):
        blk = InvertedResidualBlock(cin, cout, tdim, expansion_ratio=4).to(dev).eval()
        for b in (1, 8):
            x, kw = irb_inputs(blk, b, 32, 32, torch.float32, tdim=tdim)
            err = irb_compare(x, kw)
            require(err <= IRB_TOL["float32"],
                    f"fused kernel vs plain {variant} {cin}->{cout} b{b}: {err}")
            wide_err = max(wide_err, err)
            moved, flops = irb_work(x, kw)
            bound_ms, bound_by = bound(moved, flops)

            def kernel(x=x, kw=kw):
                with torch.inference_mode():
                    fik.fused_irb_v2(x, **kw)

            def plain(x=x, kw=kw):
                with torch.inference_mode():
                    fused_irb_v2_plain(x, **kw)

            row = dict(kernel="fused_irb_v2", variant=variant,
                       shape=[b, cin, 32, 32], chid=4 * cin, cout=cout, dtype="float32",
                       max_err=err, tol=IRB_TOL["float32"],
                       kernel_ms=cuda_ms(kernel, 20, 3), plain_ms=cuda_ms(plain, 20, 3),
                       kernel_graph_ms=graph_ms(kernel, 20, 3),
                       plain_graph_ms=graph_ms(plain, 20, 3), bound_ms=bound_ms,
                       bound_by=bound_by, tc_bound_ms=irb_tc_bound(x, kw, False),
                       bytes=moved, flops=flops,
                       plan=list(fik.plan(b, 4 * cin, cout, 32, 32)), library_ms=None)
            emit("kernel", **row)
            v1_rows[(variant, cin, b)] = irb_v1_row(x, kw, row, variant=variant)
    # the JAX tests' edge cases: no SE with SiLU, 48 channels in 16 groups,
    # 24 rows (an uneven last tile)
    edge = probe.unet.encoder_blocks[0][0]
    for label, blk, b, height, kwargs in (
            ("no_se_silu", edge, 2, 32, dict(use_se=False, silu=True)),
            ("cin48_16_groups", InvertedResidualBlock(
                48, 48, cfg.unet.time_embed_dim, expansion_ratio=2).to(dev).eval(),
             2, 16, {}),
            ("size24_uneven_tile", edge, 2, 24, {})):
        for dtype in (torch.float32, torch.bfloat16):
            x, kw = irb_inputs(blk, b, height, height, dtype, **kwargs)
            dname = str(dtype).replace("torch.", "")
            err = irb_compare(x, kw)
            require(err <= IRB_TOL[dname], f"fused kernel vs plain {label} {dname}: {err}")
            emit("kernel", kernel="fused_irb_v2", case=label, shape=list(x.shape),
                 dtype=dname, max_err=err, tol=IRB_TOL[dname])
    # v1 at the four TestFusedIRB shapes (tests/test_pallas_kernels.py:167-201),
    # with their tile_h=8: batch 2; 32→128→32, 32→128→64 and no SE with SiLU
    # at 32², 48→96→48 at 16²
    tdim = cfg.unet.time_embed_dim
    for label, cin, cout, exp, height, use_se, silu in (
            ("identity", 32, 32, 4, 32, True, False),
            ("channel_change_skip", 32, 64, 4, 32, True, False),
            ("no_se_silu", 32, 32, 4, 32, False, True),
            ("uneven_group_counts", 48, 48, 2, 16, True, False)):
        blk = InvertedResidualBlock(cin, cout, tdim, expansion_ratio=exp, use_se=use_se,
                                    quantization_friendly=not silu).to(dev).eval()
        x, kw = irb_inputs(blk, 2, height, height, torch.float32, use_se=use_se, silu=silu)
        err, tol = irb_v1_compare(x, dict(kw, tile_h=8))
        v1_rows[label] = dict(kernel="fused_irb_v1", case=label, shape=list(x.shape),
                              chid=cin * exp, cout=cout, dtype="float32", tile_h=8,
                              max_err=err, tol=tol)
        emit("kernel", **v1_rows[label])
    del probe
    torch.cuda.empty_cache()
    emit("kernel_done", seconds=time.perf_counter() - t0)

    # 4. serve: the main path at full width --------------------------------
    t0 = time.perf_counter()
    npz = os.path.join(ROOT, "artifacts_torch", f"{STUDENT}.npz")
    torch.cuda.synchronize()
    a = time.perf_counter()
    trained = load_state_dict_npz(npz, dev)     # bytes put together, SHA-256 checked
    torch.cuda.synchronize()
    emit("weights", artifact=STUDENT, file=os.path.relpath(npz, ROOT),
         bytes=os.path.getsize(npz), load_s=time.perf_counter() - a,
         tensors=len(trained), params=sum(t.numel() for t in trained.values()))
    pipes = []
    for label, name, grid, fused in SERVED:
        path = art[name]
        if name == STUDENT:
            a = time.perf_counter()
            pipe = ServingPipeline.from_artifact(name, dev, use_pallas_irb=fused,
                                                 batch_size=8)
            emit("from_artifact", student=label, seconds=time.perf_counter() - a)
        else:       # another grid, on the student's weights
            pipe = ServingPipeline.from_config(
                os.path.join(path, "model_config.json"),
                os.path.join(path, "student_timesteps.json"), trained,
                device=dev, batch_size=8)
        require(pipe.config.timesteps == grid,
                f"{label}: grid {pipe.config.timesteps} != {grid}")
        require(pipe.model.config.unet.use_pallas_irb == fused,
                f"{label}: use_pallas_irb is {pipe.model.config.unet.use_pallas_irb}")
        require(all(torch.equal(t, trained[k]) for k, t in pipe.model.state_dict().items()),
                f"{label}: the served weights are not {STUDENT}'s")
        pipes.append(pipe)

    rng = np.random.default_rng(0)
    sizes = ((400, 600), (256, 256), (480, 720), (720, 480), (97, 301))
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    batch_images = [images[i % len(images)] for i in range(8)]

    def check_outputs(inputs, outputs):
        require(len(outputs) == len(inputs), f"{len(outputs)} outputs for {len(inputs)} inputs")
        for img, out in zip(inputs, outputs):
            require(out.dtype == np.uint8 and out.shape == img.shape,
                    f"output {out.dtype} {out.shape} for input {img.shape}")
            require(int(out.max()) > int(out.min()), "constant output image")

    def eager_request(pipe, img, seed=0):
        """One request's sampler op by op (forward hooks see it; a graph's
        replay runs no Python)."""
        canvas, _ = pipe.pre(img)
        return pipe.run_eager(canvas, pipe._generator(seed))

    def peak_where(pipe):
        """Peak device memory of one eager batch of 8, and the three blocks
        of the UNet inside which the highest peaks are reached."""
        unet, blocks_, hooks_ = pipe.model.unet, [], []

        def walk(module, prefix):
            for n, child in module.named_children():
                if isinstance(child, torch.nn.ModuleList):
                    walk(child, f"{prefix}{n}.")
                else:
                    blocks_.append((f"{prefix}{n}", child))

        def enter(module, args):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        def leave(module, args, out, name):
            torch.cuda.synchronize()
            peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated())

        walk(unet, "")
        peaks = {}
        for name, m in blocks_:
            hooks_.append(m.register_forward_pre_hook(enter))
            hooks_.append(m.register_forward_hook(
                lambda mod, a, o, name=name: leave(mod, a, o, name)))
        canvas = torch.cat([pipe.pre(img)[0] for img in batch_images])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pipe.run_eager(canvas, pipe._generator(300))
        torch.cuda.synchronize()
        for h in hooks_:
            h.remove()
        top = sorted(peaks.items(), key=lambda kv: -kv[1])[:3]
        return base, [{"block": n, "peak_mem_bytes": v} for n, v in top]

    def per_replay(steps, fused):
        """The hand-written kernels' launches inside one replay of a graph
        of a sampler of ``steps`` UNet calls."""
        return {"linear_attention": steps,
                "fused_irb_v2": IRBS_PER_UNET_CALL * steps if fused else 0,
                "fused_irb_v1": 0}      # no model path runs v1, as in JAX

    reset_launches = zero_launches

    def graph_accounting(pipe, label, want, eager_calls):
        """Hold the launches of a configuration's run to its graphs: each
        graph's replay launches ``want``; the wrappers launched (GRAPH_WARMUP
        + 1)·``want`` for each graph (warm-up and capture) and ``want`` for
        each of ``eager_calls`` eager sampler calls. Returns (wrapper
        launches, launches inside replays, replays by batch size)."""
        counts = kernel_launches()
        for b, g in pipe.graphs.items():
            require(g.launches == dict(want, **dict.fromkeys(qconv_kernels + FLASH_KERNELS, 0)),
                    f"{label}: the batch-{b} graph launches {g.launches} a replay, not {want}")
        direct = {k: ((GRAPH_WARMUP + 1) * len(pipe.graphs) + eager_calls) * v
                  for k, v in want.items()}
        require(counts == direct, f"{label}: wrapper launches {counts} != {direct}")
        replays = {b: g.replays for b, g in sorted(pipe.graphs.items())}
        return counts, {k: sum(replays.values()) * v for k, v in want.items()}, replays

    launches = {"linear_attention": 0, "fused_irb_v2": 0, "fused_irb_v1": 0}
    replayed = dict(launches)
    for pipe, (label, _, grid, fused) in zip(pipes, SERVED):
        steps = len(grid)
        require(not pipe.graphs, f"{label}: graphs before the run")
        # the counts go to 0 just before this configuration runs
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved_before = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        outs = [pipe(img, seed=i) for i, img in enumerate(images)]   # captures batch 1
        check_outputs(images, outs)
        outs = pipe.batch(batch_images, seed=100)                     # captures batch 8
        check_outputs(batch_images, outs)

        # steady state: single requests (host clock, the output is on the host)
        lat, stages = [], []
        for i in range(10):
            img = images[2]
            torch.cuda.synchronize()
            a = time.perf_counter()
            canvas, meta = pipe.pre(img)
            torch.cuda.synchronize()
            b = time.perf_counter()
            out = pipe._run(canvas, pipe._generator(i))
            torch.cuda.synchronize()
            c = time.perf_counter()
            res = pipe.post(out[0], meta)
            d = time.perf_counter()
            require(res.shape == img.shape, "steady-state output shape")
            lat.append((d - a) * 1e3)
            stages.append(((b - a) * 1e3, (c - b) * 1e3, (d - c) * 1e3))
        # batches of 8: one chunk a call, then REPS chunks pipelined in one call
        torch.cuda.synchronize()
        a = time.perf_counter()
        for r in range(REPS):
            outs = pipe.batch(batch_images, seed=200 + r)
        one_chunk_s = time.perf_counter() - a
        check_outputs(batch_images, outs)
        a = time.perf_counter()
        outs = pipe.batch(batch_images * REPS, seed=400)
        pipelined = time.perf_counter() - a
        check_outputs(batch_images * REPS, outs)
        st = np.asarray(stages)
        with FlopCounterMode(display=False) as flop_counter:   # one eager call
            eager_request(pipe, images[2])
        bench = pipe.benchmark()
        torch.cuda.synchronize()
        peak_mem = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        # what the graphs hold: their pool, and the pipeline's own tensors
        graph_mem = torch.cuda.memory_reserved() - reserved_before
        counts, in_replays, replays = graph_accounting(pipe, label, per_replay(steps, fused), 1)
        bench_runs = 20 + 3
        want_replays = {1: len(images) + 10 + bench_runs, 8: 1 + 2 * REPS}
        require(replays == want_replays, f"{label}: replays {replays} != {want_replays}")
        for k in launches:
            launches[k] += counts[k]
            replayed[k] += in_replays[k]
        row = dict(student=label, grid=list(grid), use_pallas_irb=fused,
                   weights=STUDENT, image=list(images[2].shape),
                   latency_ms_mean=float(np.mean(lat)),
                   latency_ms_p50=float(np.median(lat)),
                   latency_ms_min=float(np.min(lat)),
                   pre_ms=float(st[:, 0].mean()), sampler_ms=float(st[:, 1].mean()),
                   post_ms=float(st[:, 2].mean()),
                   batch=8, images_per_s=REPS * 8 / pipelined,
                   images_per_s_one_chunk_a_call=REPS * 8 / one_chunk_s,
                   conv_matmul_gflop_per_request=flop_counter.get_total_flops() / 1e9,
                   peak_mem_bytes=peak_mem, graph_mem_bytes=graph_mem,
                   capture_s={b: g.seconds for b, g in sorted(pipe.graphs.items())},
                   replays=replays, launches=counts, launches_in_replays=in_replays)
        emit("serve", **row)
        emit("benchmark", student=label, **bench)
    emit("serve_done", kernel_launches=launches, kernel_launches_in_replays=replayed,
         seconds=time.perf_counter() - t0)

    # 5. graph: each configuration's CUDA graphs against its eager sampler --
    t0 = time.perf_counter()
    launch_api = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                            r"GraphLaunch|Memcpy|Memset)")

    def launch_calls(fn, calls=3, label="", tries=1):
        """Per call of ``fn``, from torch.profiler over ``calls`` calls after
        one untraced: the host's CUDA launch and copy calls by API name,
        and the device's kernels (and copies) in all and by kind.

        A trace can lose device records (an H100 trace of three 2-step
        replays once held 5,568 of their 6,174 kernels, all kinds short) or,
        rarely, hold a few more, so with ``tries`` > 1 the calls are traced
        again until two traces hold the same kernels, name by name, up to
        ``tries`` traces; each trace that disagrees with the ones before is
        reported as a ``graph_trace_disagrees`` line. Without agreement the
        trace with the most device records is returned, for the caller's
        checks."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace

        fn()
        torch.cuda.synchronize()
        seen = []
        for attempt in range(1, tries + 1):
            with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            api, names = defaultdict(int), defaultdict(int)
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    if not getattr(e, "is_user_annotation", False):
                        names[e.name] += 1
                elif launch_api.match(e.name):
                    api[e.name] += 1
            if any(names == n for _, n in seen):
                break
            if seen:
                emit("graph_trace_disagrees", run=label, attempt=attempt, calls=calls,
                     device_ops=sum(names.values()),
                     earlier_device_ops=[sum(n.values()) for _, n in seen])
            seen.append((api, names))
        else:
            api, names = max(seen, key=lambda t: sum(t[1].values()))
        kinds = defaultdict(int)
        for n, c in names.items():
            kinds[kernel_kind(n)] += c
        return ({k: v / calls for k, v in sorted(api.items())},
                sum(names.values()) / calls,
                {k: v / calls for k, v in sorted(kinds.items())})

    for pipe, (label, _, grid, fused) in zip(pipes, SERVED):
        for b in (1, 8):
            canvas = torch.cat([pipe.pre(img)[0] for img in (batch_images[:b])])
            graph_out = pipe._run(canvas, pipe._generator(7))
            eager_out = pipe.run_eager(canvas, pipe._generator(7))
            diff = (graph_out.int() - eager_out.int()).abs()
            lsb, off = int(diff.max()), int((diff > 0).sum())
            require(lsb <= GRAPH_LSB_TOL,
                    f"{label} batch {b}: graph vs eager {lsb} LSB ({off} values)")
            # paired runs, eager and graph in turn
            eager_lat, graph_lat = [], []
            for i in range(10 if b == 1 else 4):
                for fn, into in ((pipe.run_eager, eager_lat), (pipe._run, graph_lat)):
                    torch.cuda.synchronize()
                    a = time.perf_counter()
                    fn(canvas, pipe._generator(i))
                    torch.cuda.synchronize()
                    into.append((time.perf_counter() - a) * 1e3)
            eager_api, eager_dev, _ = launch_calls(
                lambda: pipe.run_eager(canvas, pipe._generator(1)),
                label=f"{label} batch {b} eager")
            graph_api, graph_dev, graph_kinds = launch_calls(
                lambda: pipe._run(canvas, pipe._generator(1)),
                label=f"{label} batch {b} graph", tries=3)
            # the replay runs the hand-written kernels: one attention kernel
            # a UNet call, and the fused IRB's kernels when it is on
            require(graph_kinds.get("linear_attention") == len(grid),
                    f"{label} batch {b}: {graph_kinds} in a replay")
            require(bool(graph_kinds.get("fused_irb")) == fused,
                    f"{label} batch {b}: {graph_kinds} in a replay")
            row = dict(
                student=label, batch=b, grid=list(grid), use_pallas_irb=fused,
                graph_vs_eager_max_lsb=lsb, graph_vs_eager_values_off=off,
                lsb_tol=GRAPH_LSB_TOL, capture_s=pipe.graphs[b].seconds,
                eager_ms_mean=float(np.mean(eager_lat)),
                eager_ms_p50=float(np.median(eager_lat)),
                graph_ms_mean=float(np.mean(graph_lat)),
                graph_ms_p50=float(np.median(graph_lat)),
                host_launch_calls_eager=sum(eager_api.values()),
                host_launch_calls_graph=sum(graph_api.values()),
                host_calls_eager_by_api=eager_api, host_calls_graph_by_api=graph_api,
                device_ops_eager=eager_dev, device_ops_graph=graph_dev,
                device_ops_graph_by_kind=graph_kinds)
            emit("graph", **row)
        # a whole request of 480×720 through the pipeline: pre, graph, post
        api, dev_ops, _ = launch_calls(lambda: pipe(images[2], seed=1),
                                       label=f"{label} request")
        emit("graph_request", student=label, image=list(images[2].shape),
             host_launch_calls=sum(api.values()), host_calls_by_api=api,
             device_ops=dev_ops)
    emit("graph_done", seconds=time.perf_counter() - t0)

    # 6. package: the student's serving packages, fp32 / bf16 / int8 -------
    t0 = time.perf_counter()
    pkg_root = os.path.join(cuda_build.BUILD_DIR, "packages")
    student = pipes[0].model
    original = {k: t.detach().cpu() for k, t in student.state_dict().items()}
    small = 64
    pkg_rng = np.random.default_rng(5)
    pkg_low = torch.from_numpy(pkg_rng.uniform(-1, 1, (2, small, small, 3)).astype(np.float32))
    pkg_init = torch.from_numpy(pkg_rng.standard_normal((2, small, small, 3)).astype(np.float32))
    pkg_noise = torch.from_numpy(pkg_rng.standard_normal((1, 2, small, small, 3)).astype(np.float32))
    packages = {}
    pkg_launches = {"linear_attention": 0, "fused_irb_v2": 0, "fused_irb_v1": 0}
    pkg_replayed = dict(pkg_launches)
    for codec, quantize in CODECS:
        path = packages[codec] = os.path.join(pkg_root, codec)
        shutil.rmtree(path, ignore_errors=True)
        a = time.perf_counter()
        files = create_serving_package(path, student, pipes[0].schedule,
                                       quantize=quantize, timesteps=SERVED[0][2])
        write_s = time.perf_counter() - a
        qparams, tag = quantize_model(original, student.config, quantize)
        require(tag == codec, f"codec {tag} for {quantize}")
        deq = (dequantize_int8(qparams) if tag == "int8"
               else {k: t.float() for k, t in qparams.items()})
        torch.cuda.synchronize()
        a = time.perf_counter()
        _, _, state, meta = load_serving_package(path, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - a
        require(meta["quantization"] == codec and tuple(meta["timesteps"]) == SERVED[0][2],
                f"{codec}: package config {meta['quantization']} {meta['timesteps']}")
        require(all(torch.equal(state[k].cpu(), deq[k]) for k in original),
                f"{codec}: the loaded weights are not the codec's")
        del state
        # the card's sampler on the package's weights against the CPU's,
        # unfused and fused: same weights, same numpy noise
        cpu_model, cpu_sched, _, _ = load_serving_package(path, "cpu")
        want = enhance(cpu_model, cpu_sched, pkg_low, timesteps=SERVED[0][2],
                       init_noise=pkg_init, step_noise=pkg_noise, device="cpu")
        vs_cpu = {}
        for fused in (False, True):
            card_model, card_sched, _, _ = load_serving_package(path, dev,
                                                                use_pallas_irb=fused)
            got = enhance(card_model, card_sched, pkg_low, timesteps=SERVED[0][2],
                          init_noise=pkg_init, step_noise=pkg_noise, device=dev).cpu()
            require(bool(torch.isfinite(got).all()), f"{codec}: non-finite sampler output")
            vs_cpu["fused" if fused else "unfused"] = err = float((got - want).abs().max())
            require(err <= SAMPLER_TOL, f"{codec} fused={fused}: card vs CPU sampler {err}")
            del card_model
        del cpu_model
        serve_rows = {}
        for fused in (False, True):
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved_before = torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            a = time.perf_counter()
            pipe = ServingPipeline.from_package(path, device=dev, use_pallas_irb=fused,
                                                batch_size=8)
            from_package_s = time.perf_counter() - a
            require(pipe.grid == list(SERVED[0][2]), f"{codec}: grid {pipe.grid}")
            outs = [pipe(img, seed=i) for i, img in enumerate(images)]
            check_outputs(images, outs)
            lat = []
            for i in range(5):
                torch.cuda.synchronize()
                a = time.perf_counter()
                pipe(images[2], seed=i)
                lat.append((time.perf_counter() - a) * 1e3)
            pkg_reps = 4
            pipe.batch(batch_images, seed=0)          # captures batch 8
            a = time.perf_counter()
            outs = pipe.batch(batch_images * pkg_reps, seed=500)
            pipelined = time.perf_counter() - a
            check_outputs(batch_images * pkg_reps, outs)
            torch.cuda.synchronize()
            peak_mem = torch.cuda.max_memory_allocated()
            counts, in_replays, replays = graph_accounting(
                pipe, f"{codec} package", per_replay(1, fused), 0)
            require(replays == {1: len(images) + 5, 8: 1 + pkg_reps},
                    f"{codec} package: replays {replays}")
            for k in pkg_launches:
                pkg_launches[k] += counts[k]
                pkg_replayed[k] += in_replays[k]
            capture_s = {b: g.seconds for b, g in sorted(pipe.graphs.items())}
            del pipe, outs
            torch.cuda.empty_cache()
            serve_rows["fused" if fused else "unfused"] = dict(
                from_package_s=from_package_s, latency_ms_mean=float(np.mean(lat)),
                latency_ms_p50=float(np.median(lat)), batch=8,
                images_per_s=pkg_reps * 8 / pipelined, peak_mem_bytes=peak_mem,
                capture_s=capture_s, replays=replays, launches=counts,
                launches_in_replays=in_replays)
        row = dict(
            codec=codec, quantize=quantize,
            file_bytes={role: os.path.getsize(f) for role, f in files.items()},
            bytes=sum(os.path.getsize(f) for f in files.values()),
            report=quantization_report(original, qparams),
            error=quantization_error(original, deq), write_s=write_s, load_s=load_s,
            sampler_vs_cpu_max_abs_err=vs_cpu, sampler_tol=SAMPLER_TOL,
            serve=serve_rows)
        emit("package", **row)
        del qparams, deq
    emit("package_done", kernel_launches=pkg_launches,
         kernel_launches_in_replays=pkg_replayed, seconds=time.perf_counter() - t0)

    # 7. checks on the main path's own tensors ------------------------------
    t0 = time.perf_counter()
    captured = {}

    def capture(module, args):
        captured["qkv"] = [a.detach().clone() for a in args]

    h = pipes[0].model.unet.mid_attn.attn.register_forward_pre_hook(capture)
    eager_request(pipes[0], images[0])
    h.remove()
    q, k, v = captured["qkv"]
    require(tuple(q.shape) == (1, 1024, 4, 32) and q.dtype == torch.float32,
            f"mid_attn q {q.dtype} {tuple(q.shape)}")
    mid_err = compare(q, k, v)
    require(mid_err <= TOL["float32"], f"mid_attn kernel vs plain: {mid_err}")

    # the widest IRB's own input, captured during a fused request
    widest = "decoder_blocks.3.0"
    fused_pipe = pipes[-1]
    blk = dict(fused_pipe.model.unet.named_modules())[widest]

    def capture_irb(module, args):
        captured["irb"] = [a.detach().clone() for a in args[:2]]   # x, time_emb

    h = blk.register_forward_pre_hook(capture_irb)
    eager_request(fused_pipe, images[0])
    h.remove()
    xb, temb = captured["irb"]
    require(tuple(xb.shape) == (1, 96, size, size), f"{widest} x {tuple(xb.shape)}")
    with torch.inference_mode():
        fs, fb = blk.time_mlp(temb).chunk(2, dim=-1)
    irb_kw = dict(film_scale=fs, film_shift=fb, **irb_args(blk))
    irb_err = irb_compare(xb, irb_kw)
    require(irb_err <= IRB_TOL["float32"], f"{widest} kernel vs plain: {irb_err}")

    # the Gram fold on that x: GN2⊕FiLM's (a2, b2) against GN2's statistics
    # taken two-pass from h1 = expand(x̂) itself, in float32 on the card
    def fold_err():
        with torch.inference_mode():
            _, (a2, b2), xhat = folded_gn_scales(
                xb, irb_kw["wexp"], irb_kw["gn1_scale"], irb_kw["gn1_bias"],
                irb_kw["gn2_scale"], irb_kw["gn2_bias"], fs, fb,
                irb_kw["eps"], irb_kw["silu"])
            h1 = torch.einsum("bkhw,ck->bchw", xhat, irb_kw["wexp"])
            groups = blk.norm2.num_groups
            hg = h1.reshape(1, groups, -1)
            mean = hg.mean(dim=-1)
            var = (hg - mean[..., None]).square().mean(dim=-1)
            per = h1.shape[1] // groups
            rstd = torch.rsqrt(var + irb_kw["eps"]).repeat_interleave(per, dim=1)
            mean = mean.repeat_interleave(per, dim=1)
            gamma = irb_kw["gn2_scale"][None] * (1 + fs)
            a_ref = rstd * gamma
            b_ref = (irb_kw["gn2_bias"][None] - mean * rstd * irb_kw["gn2_scale"][None]) \
                * (1 + fs) + fb
            per_c = lambda v: v[:, :, None, None]  # noqa: E731
            got = h1 * per_c(a2) + per_c(b2)
            want = h1 * per_c(a_ref) + per_c(b_ref)
        return float((got - want).abs().max()), float(want.abs().max())

    fold_f32, fold_scale = fold_err()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fold_tf32, _ = fold_err()
    finally:
        pin_fp32()
    require(fold_f32 <= FOLD_TOL, f"{widest} Gram fold vs two-pass GN2: {fold_f32}")
    require(fold_tf32 > FOLD_TOL,
            f"{widest}: a TF32 Gram fold ({fold_tf32}) passes the fold check")

    # fused_irb_v1 on the 22 IRBs of one unfused served request: each block's
    # own x and FiLM, captured by hooks, through v1 (its count set to 0 just
    # before), against the block's own output and against v2 on that input
    named = [(n, m) for n, m in pipes[0].model.unet.named_modules()
             if isinstance(m, InvertedResidualBlock) and m.stride == 1]
    require(len(named) == IRBS_PER_UNET_CALL, f"{len(named)} stride-1 IRBs")
    irb_io = {}

    def keep_in(module, args, name):
        irb_io.setdefault(name, [a.detach().clone() for a in args[:2]])

    def keep_out(module, args, out, name):
        if len(irb_io[name]) == 2:
            irb_io[name].append(out.detach().clone())

    hooks = [m.register_forward_pre_hook(lambda mod, a, n=n: keep_in(mod, a, n))
             for n, m in named]
    hooks += [m.register_forward_hook(lambda mod, a, o, n=n: keep_out(mod, a, o, n))
              for n, m in named]
    eager_request(pipes[0], images[0])
    for h in hooks:
        h.remove()
    require(all(len(irb_io.get(n, ())) == 3 for n, _ in named), "an IRB was not captured")
    v1_film = {}
    with torch.inference_mode():
        for n, m in named:
            v1_film[n] = m.time_mlp(irb_io[n][1]).chunk(2, dim=-1)
        fik.fused_irb_v1.launches = 0
        v1_out = {n: fik.fused_irb_v1(irb_io[n][0], film_scale=v1_film[n][0],
                                      film_shift=v1_film[n][1], **irb_args(m))
                  for n, m in named}
        torch.cuda.synchronize()
        v1_path_launches = fik.fused_irb_v1.launches
        require(v1_path_launches == IRBS_PER_UNET_CALL,
                f"fused_irb_v1: {v1_path_launches} launches for {IRBS_PER_UNET_CALL} IRBs")
        v1_vs_block, v1_vs_v2 = {}, {}
        for n, m in named:
            x_, _, out_ = irb_io[n]
            v2_ = fik.fused_irb_v2(x_, film_scale=v1_film[n][0], film_shift=v1_film[n][1],
                                   **irb_args(m))
            v1_vs_block[n] = float((v1_out[n] - out_).abs().max())
            v1_vs_v2[n] = float((v1_out[n] - v2_).abs().max())
    worst_block = max(v1_vs_block, key=v1_vs_block.get)
    require(v1_vs_block[worst_block] <= IRB_TOL["float32"],
            f"fused_irb_v1 vs the block's own output at {worst_block}: "
            f"{v1_vs_block[worst_block]}")
    require(max(v1_vs_v2.values()) <= IRB_TOL["float32"],
            f"fused_irb_v1 vs fused_irb_v2 on a request's IRB inputs: {v1_vs_v2}")
    del irb_io, v1_out

    # v1's device-side affines at decoder_blocks.3.0 (the kernel's one-pass
    # float32 partials) and the Gram fold's, against GN1 and GN2⊕FiLM with
    # float64 statistics taken two-pass from x and h1, as max |Δ(x·a1 + b1)|
    # and max |Δ(h1·a2 + b2)| over the float64 x and h1
    def gn_affine(v, scale, bias, groups, film=None):
        vg = v.reshape(v.shape[0], groups, -1)
        mean = vg.mean(dim=-1)
        var = (vg - mean[..., None]).square().mean(dim=-1)
        per = v.shape[1] // groups
        rstd = torch.rsqrt(var + irb_kw["eps"]).repeat_interleave(per, dim=1)
        mean = mean.repeat_interleave(per, dim=1)
        a = rstd * scale.double()[None]
        b = bias.double()[None] - mean * a
        if film is not None:
            m = 1 + film[0].double()
            a, b = a * m, b * m + film[1].double()
        return a, b

    def per_c(v):
        return v[:, :, None, None]

    with torch.inference_mode():
        x64 = xb.double()
        a1_ref, b1_ref = gn_affine(x64, irb_kw["gn1_scale"], irb_kw["gn1_bias"],
                                   blk.norm1.num_groups)
        pre = x64 * per_c(a1_ref) + per_c(b1_ref)
        xhat64 = torch.nn.functional.silu(pre) if irb_kw["silu"] else pre.clamp(0, 6)
        h1_64 = torch.einsum("bkhw,ck->bchw", xhat64, irb_kw["wexp"].double())
        a2_ref, b2_ref = gn_affine(h1_64, irb_kw["gn2_scale"], irb_kw["gn2_bias"],
                                   blk.norm2.num_groups, (fs, fb))

        def affine_errs(a1, b1, a2, b2):
            return (float((x64 * per_c(a1.double() - a1_ref)
                           + per_c(b1.double() - b1_ref)).abs().max()),
                    float((h1_64 * per_c(a2.double() - a2_ref)
                           + per_c(b2.double() - b2_ref)).abs().max()))

        v1_t = fik._launch_v1(cuda_build.load(fik.SOURCE, fik._declare),
                              torch.cuda.current_stream().cuda_stream, xb,
                              film_scale=fs, film_shift=fb, **irb_args(blk))
        v1_gn1_err, v1_gn2_err = affine_errs(*(v1_t[k] for k in ("a1", "b1", "a2", "b2")))
        (fa1, fb1), (fa2, fb2), _ = folded_gn_scales(
            xb, irb_kw["wexp"], irb_kw["gn1_scale"], irb_kw["gn1_bias"],
            irb_kw["gn2_scale"], irb_kw["gn2_bias"], fs, fb, irb_kw["eps"], irb_kw["silu"])
        fold_gn1_err, fold_gn2_err = affine_errs(fa1, fb1, fa2, fb2)
        del x64, pre, xhat64, h1_64, v1_t
    require(max(v1_gn1_err, v1_gn2_err) <= FOLD_TOL,
            f"{widest}: fused_irb_v1's GN affines vs float64 statistics: "
            f"{v1_gn1_err}, {v1_gn2_err}")

    # the card's samplers against the CPU's, and fused against unfused on
    # the card: same weights, same numpy noise
    small = 64
    cpu_sd = {k: t.cpu() for k, t in trained.items()}
    ref_rng = np.random.default_rng(1)
    low = ref_rng.uniform(-1, 1, (2, small, small, 3)).astype(np.float32)
    sampler_err, card_out = {}, {}
    for pipe, (label, _, grid, fused) in zip(pipes, SERVED):
        cpu_model, cpu_sched = create_model(pipe.model.config, device="cpu")
        cpu_model.load_state_dict(cpu_sd)
        init = ref_rng.standard_normal((2, small, small, 3)).astype(np.float32)
        noise = ref_rng.standard_normal((len(grid), 2, small, small, 3)).astype(np.float32)
        if fused:     # the unfused 1-step student's noise, for the comparison
            init, noise = card_out["noise"]
        card_out.setdefault("noise", (init, noise))
        got = enhance(pipe.model, pipe.schedule, torch.from_numpy(low),
                      timesteps=grid, init_noise=torch.from_numpy(init),
                      step_noise=torch.from_numpy(noise), device=dev).cpu()
        want = enhance(cpu_model, cpu_sched, torch.from_numpy(low),
                       timesteps=grid, init_noise=torch.from_numpy(init),
                       step_noise=torch.from_numpy(noise), device="cpu")
        require(bool(torch.isfinite(got).all()), "non-finite sampler output")
        err = float((got - want).abs().max())
        require(err <= SAMPLER_TOL, f"{label}: card vs CPU sampler {err}")
        sampler_err[label] = err
        card_out[label] = got
    fused_vs_unfused = float((card_out[SERVED[2][0]] - card_out[SERVED[0][0]]).abs().max())
    require(fused_vs_unfused <= SAMPLER_TOL,
            f"fused vs unfused sampler on the card: {fused_vs_unfused}")
    emit("check", mid_attn_max_err=mid_err, mid_attn_shape=list(q.shape),
         irb_block=widest, irb_shape=list(xb.shape), irb_max_err=irb_err,
         irb_tol=IRB_TOL["float32"], fold_max_abs_err=fold_f32,
         fold_tf32_max_abs_err=fold_tf32, fold_tol=FOLD_TOL,
         fold_output_max_abs=fold_scale,
         v1_blocks=len(named), v1_launches=v1_path_launches,
         v1_vs_block_max_abs_err=v1_vs_block[worst_block], v1_worst_block=worst_block,
         v1_vs_v2_max_abs_err=max(v1_vs_v2.values()),
         v1_vs_block_max_abs_err_by_block=v1_vs_block,
         v1_gn1_affine_vs_float64=v1_gn1_err, v1_gn2_affine_vs_float64=v1_gn2_err,
         fold_gn1_affine_vs_float64=fold_gn1_err, fold_gn2_affine_vs_float64=fold_gn2_err,
         affine_tol=FOLD_TOL,
         sampler_vs_cpu_max_abs_err=sampler_err,
         fused_vs_unfused_sampler_max_abs_err=fused_vs_unfused,
         sampler_tol=SAMPLER_TOL, seconds=time.perf_counter() - t0)

    # 8. eval: the student's quality on the card against the JAX package ----
    t0 = time.perf_counter()
    ref_base = os.path.join(ROOT, "artifacts_torch", STUDENT)
    with open(ref_base + ".eval_ref.json") as f:
        ref = json.load(f)
    with np.load(ref_base + ".eval_ref_u8.npz", allow_pickle=False) as z:
        ref_u8 = z["pred_u8"]
    grid = list(pipes[0].config.timesteps)
    eval_n = ref["n"]
    require(ref["timesteps"] == grid and ref["size"] == size and eval_n == 15,
            f"eval reference is for {ref['timesteps']} n={eval_n} size={ref['size']}")
    eval_low, eval_high = ev.eval_split(eval_n, size, ref["seed"])
    eval_init, eval_step = ev.eval_noise(eval_n, size, ref["seed"], len(grid))
    hashes = ev.input_hashes(eval_low, eval_high, eval_init)
    for i, (h, im) in enumerate(zip(hashes, ref["images"])):
        for what in ("low", "high", "noise"):
            require(h[what] == im[f"{what}_sha256"],
                    f"eval image {i}: its {what} array's SHA-256 {h[what]} is not "
                    f"the reference's {im[f'{what}_sha256']}: the inputs differ")
    require(len(hashes) == len(ref["images"]) == eval_n, "eval: image count")
    eval_target = ev.target_unit(eval_high, dev)
    eval_rows = {}
    for pipe, (label, _, _, fused) in ((pipes[0], SERVED[0]), (pipes[-1], SERVED[-1])):
        pin_fp32()
        lak.linear_attention_kernel.launches = 0
        fik.fused_irb_v2.launches = 0
        fik.fused_irb_v1.launches = 0
        for _ in range(2):      # the first pass sets up cuDNN; the second is timed
            torch.cuda.synchronize()
            a = time.perf_counter()
            pred = ev.enhance_split(pipe.model, pipe.schedule, eval_low, eval_init,
                                    eval_step, grid, device=dev)
            per = ev.per_image_metrics(pred, eval_target)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - a
        batches = 2 * -(-eval_n // ev.BATCH_SIZE) * len(grid)
        counts = {"linear_attention": lak.linear_attention_kernel.launches,
                  "fused_irb_v2": fik.fused_irb_v2.launches,
                  "fused_irb_v1": fik.fused_irb_v1.launches}
        require(counts == {"linear_attention": batches,
                           "fused_irb_v2": IRBS_PER_UNET_CALL * batches if fused else 0,
                           "fused_irb_v1": 0},
                f"{label}: eval launches {counts} for {batches} UNet calls")
        deltas = {k: [abs(v - im[k]) for v, im in zip(per[k], ref["images"])]
                  for k in EVAL_TOL}
        for k, tol in EVAL_TOL.items():
            worst = int(np.argmax(deltas[k]))
            require(deltas[k][worst] <= tol,
                    f"{label}: image {worst}: |Δ{k}| {deltas[k][worst]} against JAX > {tol}")
        u8 = ev.to_u8(pred[list(ref["u8_images"])])
        u8_err = int(np.abs(u8.astype(np.int16) - ref_u8.astype(np.int16)).max())
        u8_off = int((u8 != ref_u8).sum())
        require(u8_err <= EVAL_U8_TOL,
                f"{label}: images {ref['u8_images']} {u8_err} LSB from JAX's uint8")
        cpu_per = ev.per_image_metrics(pred.cpu(), eval_target.cpu())
        cpu_rel = max(abs(a_ - b_) / max(abs(b_), 1e-12)
                      for k in EVAL_TOL for a_, b_ in zip(per[k], cpu_per[k]))
        require(cpu_rel <= EVAL_CPU_REL_TOL,
                f"{label}: card metrics vs the CPU port's on the same outputs: {cpu_rel}")
        eval_rows[label] = row = dict(
            student=label, weights=STUDENT, grid=grid, images=eval_n, size=size,
            batch=ev.BATCH_SIZE, launches=counts,
            mean={k: float(np.mean(per[k])) for k in EVAL_TOL},
            jax_mean={k: ref["summary"][f"{k}_mean"] for k in EVAL_TOL},
            max_abs_delta={k: max(v) for k, v in deltas.items()},
            worst_image={k: int(np.argmax(v)) for k, v in deltas.items()},
            tol=EVAL_TOL, u8_max_lsb=u8_err, u8_pixels_off=u8_off,
            u8_tol=EVAL_U8_TOL, card_vs_cpu_metrics_max_rel=cpu_rel,
            cpu_rel_tol=EVAL_CPU_REL_TOL, seconds=seconds,
            images_per_s=eval_n / seconds, per_image=per)
        emit("eval", **row)
        del pred
    # the bf16 and int8 packages, unfused, against the JAX package's own
    # package of that codec (eval_ref_<codec>.json) on the same inputs
    for codec in ("bf16", "int8"):
        with open(f"{ref_base}.eval_ref_{codec}.json") as f:
            cref = json.load(f)
        require(cref["quantization"] == codec and cref["timesteps"] == grid
                and cref["n"] == eval_n and cref["size"] == size
                and [im[f"{w}_sha256"] for im in cref["images"] for w in ("low", "high", "noise")]
                == [im[f"{w}_sha256"] for im in ref["images"] for w in ("low", "high", "noise")],
                f"{codec} eval reference is not for the fp32 reference's inputs")
        model, schedule, _, _ = load_serving_package(packages[codec], dev)
        reset_launches()
        torch.cuda.synchronize()
        a = time.perf_counter()
        pred = ev.enhance_split(model, schedule, eval_low, eval_init, eval_step, grid,
                                device=dev)
        per = ev.per_image_metrics(pred, eval_target)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - a
        batches = -(-eval_n // ev.BATCH_SIZE) * len(grid)
        counts = kernel_launches()
        require(counts == {"linear_attention": batches, "fused_irb_v2": 0, "fused_irb_v1": 0},
                f"{codec}: eval launches {counts} for {batches} UNet calls")
        deltas = {k: [abs(v - im[k]) for v, im in zip(per[k], cref["images"])]
                  for k in EVAL_TOL}
        for k, tol in EVAL_TOL.items():
            worst = int(np.argmax(deltas[k]))
            require(deltas[k][worst] <= tol,
                    f"{codec} package: image {worst}: |Δ{k}| {deltas[k][worst]} "
                    f"against JAX's {codec} package > {tol}")
        eval_rows[f"{STUDENT}:{codec}"] = row = dict(
            student=STUDENT, package=codec, weights=STUDENT, grid=grid, images=eval_n,
            size=size, batch=ev.BATCH_SIZE, launches=counts,
            mean={k: float(np.mean(per[k])) for k in EVAL_TOL},
            jax_mean={k: cref["summary"][f"{k}_mean"] for k in EVAL_TOL},
            max_abs_delta={k: max(v) for k, v in deltas.items()},
            worst_image={k: int(np.argmax(v)) for k, v in deltas.items()},
            tol=EVAL_TOL, seconds=seconds, images_per_s=eval_n / seconds, per_image=per)
        emit("eval", **row)
        del model, pred
    emit("eval_summary", inputs_sha256_match=eval_n,
         psnr_mean={k: r["mean"]["psnr"] for k, r in eval_rows.items()},
         jax_psnr_mean=ref["summary"]["psnr_mean"],
         jax_psnr_mean_by_run={k: r["jax_mean"]["psnr"] for k, r in eval_rows.items()},
         max_abs_delta={k: r["max_abs_delta"] for k, r in eval_rows.items()},
         images_per_s={k: r["images_per_s"] for k, r in eval_rows.items()},
         seconds=time.perf_counter() - t0)

    # 9. profile (optional) -------------------------------------------------
    if args.profile:
        for pipe, (label, *_) in ((pipes[0], SERVED[0]), (pipes[-1], SERVED[-1])):
            resident, peak_blocks = peak_where(pipe)
            emit("profile", run=label, resident_mem_bytes=resident,
                 peak_mem_blocks_batch8=peak_blocks)
        for pipe, label in ((pipes[0], ""), (pipes[-1], "fused_")):
            for _ in range(3):              # warm-up: cuDNN plans, allocator
                pipe(images[2], seed=0)
                pipe.batch(batch_images, seed=0)
            profile(f"{label}request_480x720_batch1",
                    lambda pipe=pipe: pipe(images[2], seed=1), 1)
            profile(f"{label}batch8_mixed_sizes",
                    lambda pipe=pipe: pipe.batch(batch_images, seed=1), 8)

    # 10. train: the training path at full width ---------------------------
    t0 = time.perf_counter()
    del pipes, fused_pipe, blk, pipe, student
    torch.cuda.empty_cache()
    train_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    train_cfg = TrainConfig(unet_variant="small", image_size=size, batch_size=8,
                            use_amp=False, epochs=1, warmup_epochs=0,
                            prediction_type="v_prediction", log_interval=1000,
                            seed=0, checkpoint_dir=os.path.join(train_dir, "ckpt"),
                            output_dir=os.path.join(train_dir, "samples"))
    model_cfg = diffusion_config("small", size, prediction_type="v_prediction")
    train_weights = init_weights(model_cfg, seed=0, device=dev)

    def train_model_on_card(cfg=model_cfg, weights_=train_weights, device=dev):
        model, schedule = create_model(cfg, device=device)
        model.load_state_dict(weights_, strict=True)
        return model, schedule

    # synthetic batches made in bulk before the timed steps (set-up)
    data_rng = np.random.default_rng(0)
    normal_images = data_rng.integers(0, 256, (16, size + 32, size + 32, 3),
                                      dtype=np.uint8)
    loader = DataLoader(SyntheticLowLightDataset(normal_images, image_size=size, seed=0),
                        8, shuffle=True, drop_last=True, seed=0)
    batches = [b for _ in range(6) for b in loader]       # 12 batches of 8
    warm, timed, val = batches[:2], batches[2:], batches[:2]
    model, schedule = train_model_on_card()
    train_params = count_params(model.unet)
    require(train_params == 18_008_035 or size != 256,
            f"small UNet at 256²: {train_params} params, not 18,008,035")
    trainer = Trainer(model, schedule, timed, val, train_cfg)
    mid_qkv = model.unet.mid_attn.to_qkv.weight
    n_attn = sum(isinstance(m, LinearAttention) for m in model.modules())
    require(n_attn == (1 if size == 256 else n_attn),
            f"{n_attn} attention blocks in the small UNet at {size}², not 1")

    lak.linear_attention_kernel.launches = 0
    lak.linear_attention_backward_kernel.launches = 0
    fik.fused_irb_v2.launches = 0
    metrics_seen = []
    for batch in warm:
        trainer.state, m = trainer.train_step(trainer.state, batch)
        metrics_seen.append(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):    # its log line
        train_loss = trainer.train_epoch()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - a
    peak_train = torch.cuda.max_memory_allocated()
    steps = len(warm) + len(timed)
    train_launches = {"linear_attention": lak.linear_attention_kernel.launches,
                      "linear_attention_backward":
                          lak.linear_attention_backward_kernel.launches,
                      "fused_irb_v2": fik.fused_irb_v2.launches}
    require(train_launches["linear_attention"] == steps * n_attn,
            f"train: forward attention launches {train_launches}, {steps} steps")
    require(train_launches["linear_attention_backward"] == steps * n_attn,
            f"train: backward attention launches {train_launches}, {steps} steps")
    require(trainer.state.step == steps, f"train: {trainer.state.step} steps taken")
    require(np.isfinite(train_loss), f"train loss {train_loss}")
    for m in metrics_seen:
        require(bool(torch.isfinite(m["loss"]) & torch.isfinite(m["grad_norm"])),
                f"train: loss {m['loss']} grad norm {m['grad_norm']}")
    grads = {n: p.grad for n, p in model.named_parameters()}
    require(all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values()),
            "train: a parameter without a finite gradient")
    qkv_grad = float(mid_qkv.grad.abs().max())
    require(qkv_grad > 0, "train: mid_attn.to_qkv has a zero gradient")

    if args.profile:        # where a train step's time goes, per image
        profile("train_step_small256_batch8",
                lambda: trainer.train_step(trainer.state, timed[0]), 8, runs=3)

    before_val = lak.linear_attention_kernel.launches
    val_loss = trainer.validate()
    val_launches = lak.linear_attention_kernel.launches - before_val
    require(np.isfinite(val_loss) and val_launches == len(val) * n_attn,
            f"validation: loss {val_loss}, {val_launches} attention launches")

    # checkpoint save and restore on the card
    ckpt_path = trainer.save_checkpoint("smoke")
    trainer.wait_for_checkpoints()
    fresh, _ = train_model_on_card()
    resumed = Trainer(fresh, schedule, timed, val,
                      dataclasses.replace(train_cfg, resume_from=ckpt_path))
    require(resumed.state.step == trainer.state.step
            and resumed.epoch == trainer.epoch + 1,
            f"restore: step {resumed.state.step}, epoch {resumed.epoch}")
    require(all(torch.equal(p, q) for p, q in zip(fresh.parameters(), model.parameters())),
            "restore: parameters differ")
    require(all(torch.equal(resumed.state.ema_params[k], e)
                for k, e in trainer.state.ema_params.items()), "restore: EMA differs")
    sa, sb = (t.state.optimizer.state_dict()["state"] for t in (trainer, resumed))
    require(all(torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) for i in sa),
            "restore: optimizer state differs")
    require(torch.equal(trainer.state.generator.get_state(),
                        resumed.state.generator.get_state()), "restore: generator differs")
    ckpt_bytes = os.path.getsize(ckpt_path)
    del resumed, fresh, trainer, model
    shutil.rmtree(os.path.dirname(train_cfg.checkpoint_dir), ignore_errors=True)
    torch.cuda.empty_cache()
    emit("train", config=f"small@{size} v-prediction float32", batch=8,
         params=train_params, warmup_steps=len(warm), timed_steps=len(timed),
         ms_per_step=elapsed * 1e3 / len(timed),
         images_per_s=len(timed) * 8 / elapsed, peak_mem_bytes=peak_train,
         train_loss=train_loss, val_loss=val_loss, launches=train_launches,
         launches_per_step={k: v / steps for k, v in train_launches.items()},
         mid_attn_to_qkv_grad_max_abs=qkv_grad, checkpoint_bytes=ckpt_bytes,
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()

    # one step through the kernels against the same step with the attention
    # on its plain autograd path: same weights, batch, t and ε (the same
    # generator seed), f32. Bounds: the two attention passes differ by ~1e-7,
    # which GroupNorm's one-pass variance amplifies in the float32 gradients
    # (on the CPU tests' tiny UNet a float32 gradient is up to 2.5e-3 of its
    # tensor's largest entry from float64), so the gradients are held to
    # 1e-3 of their norm and each tensor to 1e-2 of its largest entry;
    # AdamW's first update is ±lr where a gradient is far above eps, so an
    # entry near 0 whose sign differs moves the parameter by up to 2·lr
    # (a bound any first step meets); such entries must stay rare: at most
    # 1% of the parameters may differ by more than 1e-6.
    # The backward kernel itself is held to its plain version on the step's
    # own q, k, v and upstream gradient.
    step_inputs = {}

    def one_step(plain_attention: bool, cfg=model_cfg, weights_=train_weights,
                 device=dev, batch=warm[0]):
        model, schedule = train_model_on_card(cfg, weights_, device)
        state = create_train_state(model, train_cfg)
        step = make_train_step(model, schedule, train_cfg)
        original = lak.linear_attention_trainable
        attn = model.unet.mid_attn.attn

        def keep_qkv(module, args):      # the backward's q, k, v ...
            step_inputs["qkv"] = [a.detach().clone() for a in args]

        def keep_g(module, args, out):   # ... and its upstream gradient
            out.register_hook(lambda g: step_inputs.__setitem__("g", g.detach().clone()))

        hooks_ = [attn.register_forward_pre_hook(keep_qkv),
                  attn.register_forward_hook(keep_g)]
        if plain_attention:
            lak.linear_attention_trainable = linear_attention_plain
        try:
            state, m = step(state, batch)
        finally:
            lak.linear_attention_trainable = original
            for h_ in hooks_:
                h_.remove()
        return (float(m["loss"]), {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                {n: p.detach().clone() for n, p in model.named_parameters()})

    before = lak.linear_attention_backward_kernel.launches
    with_kernels = one_step(False)
    kernel_step_inputs = dict(step_inputs)
    require(lak.linear_attention_backward_kernel.launches == before + n_attn,
            "the kernel step did not launch the backward kernel")
    with_plain = one_step(True)
    require(lak.linear_attention_backward_kernel.launches == before + n_attn,
            "the plain-attention step launched the backward kernel")
    kernel_vs_plain = step_diffs(with_kernels, with_plain)
    q, k, v = kernel_step_inputs["qkv"]
    g = kernel_step_inputs["g"].contiguous()
    require(tuple(q.shape) == (8, 1024, 4, 32) or size != 256,
            f"train: mid_attn backward shape {tuple(q.shape)}")
    step_bwd_err = compare_bwd(q, k, v, g)
    require(step_bwd_err <= BWD_TOL["float32"],
            f"backward kernel vs plain on the step's own inputs: {step_bwd_err}")
    del with_kernels, with_plain, q, k, v, g
    torch.cuda.empty_cache()

    # one step on the card against the CPU: small at 64², batch 2, explicit
    # t and ε (the two devices' generators draw different numbers)
    small_cfg = diffusion_config("small", 64, prediction_type="v_prediction")
    small_w = init_weights(small_cfg, seed=1, device="cpu")
    small_batch = {k: warm[0][k][:2, :64, :64] for k in ("low_light", "normal_light")}
    t_fix = torch.tensor([37, 801])
    eps_fix = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))

    def explicit_step(device):
        model, schedule = train_model_on_card(small_cfg, small_w, device)
        state = create_train_state(model, train_cfg)
        out = train_forward(model, schedule,
                            torch.from_numpy(small_batch["low_light"]).to(device),
                            torch.from_numpy(small_batch["normal_light"]).to(device),
                            timesteps=t_fix.to(device), noise=eps_fix.to(device))
        loss = diffusion_loss(out["noise_pred"], out["target"])
        loss.backward()
        apply_update(state, train_cfg)
        return (loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                {n: p.detach().cpu() for n, p in model.named_parameters()})

    on_card = explicit_step(dev)
    on_cpu = explicit_step(torch.device("cpu"))
    card_vs_cpu = step_diffs(on_card, on_cpu)
    emit("train_check", kernel_vs_plain_step=kernel_vs_plain,
         card_vs_cpu_step_small64=card_vs_cpu,
         backward_on_step_inputs_max_abs_err=step_bwd_err,
         step_tol=dict(loss_rel=STEP_LOSS_TOL, grad_norm_rel=STEP_GRAD_NORM_TOL,
                       grad_tensor_rel=STEP_GRAD_TOL,
                       param_differ_by=STEP_PARAM_TOL,
                       param_differ_share=STEP_PARAM_SHARE),
         seconds=time.perf_counter() - t0)
    require(within(kernel_vs_plain), f"kernel vs plain-attention step: {kernel_vs_plain}")
    require(within(card_vs_cpu), f"card vs CPU step: {card_vs_cpu}")

    # 11. conv_workspace: the upsample convolutions, cuDNN against the port's --
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ups = create_model(model_cfg, device=dev)[0].unet.upsamplers
    ws_rows = []
    for i, up in enumerate(ups):
        c = up.conv.in_channels
        res = size // 2 ** (len(ups) - i)          # the resolution it upsamples from
        for dtype in (torch.float32, torch.bfloat16):
            for b in (1, 4, 5, 8):
                x = torch.randn((b, c, res, res), generator=gen, device=dev).to(dtype)
                w, bias = up.conv.weight.to(dtype), up.conv.bias.to(dtype)
                tblocks.set_compute_dtype(up, None if dtype == torch.float32 else dtype)
                xu = torch.nn.functional.interpolate(x.float(), scale_factor=2, mode="bilinear",
                                                     align_corners=False).to(dtype)

                def cudnn(xu=xu, w=w, bias=bias):
                    return torch.nn.functional.conv2d(xu, w, bias, padding=1)

                def port(x=x, up=up):
                    return up(x)

                def interp(x=x):
                    return torch.nn.functional.interpolate(
                        x.float(), scale_factor=2, mode="bilinear", align_corners=False).to(x.dtype)

                row = dict(block=f"upsamplers.{i}", channels=c, out_hw=2 * res, batch=b,
                           dtype=str(dtype).replace("torch.", ""))
                with torch.no_grad():
                    for how, fn in (("cudnn", cudnn), ("port", port)):
                        fn()
                        torch.cuda.synchronize()
                        torch.cuda.empty_cache()
                        torch.cuda.reset_peak_memory_stats()
                        base = torch.cuda.memory_allocated()
                        out = fn()
                        torch.cuda.synchronize()
                        row[f"{how}_held_bytes"] = (torch.cuda.max_memory_allocated() - base
                                                    - out.numel() * out.element_size())
                        row[f"{how}_ms"] = cuda_ms(fn, 10, 2)
                        row[f"{how}_fft"] = any("fft" in n.lower()
                                                for n in device_kernels(fn))
                        del out
                    row["interpolate_ms"] = cuda_ms(interp, 10, 2)
                    row["port_conv_ms"] = row["port_ms"] - row["interpolate_ms"]
                    conv_ref = cudnn().float()
                    row["port_vs_cudnn_max_abs"] = float((up(x).float() - conv_ref).abs().max())
                tol = IRB_TOL["float32"] if dtype == torch.float32 else bf16_ulp(
                    float(conv_ref.abs().max()))
                require(row["port_vs_cudnn_max_abs"] <= tol,
                        f"upsamplers.{i} {row['dtype']} b{b}: port vs cuDNN "
                        f"{row['port_vs_cudnn_max_abs']} > {tol}")
                require(not row["port_fft"], f"upsamplers.{i}: the port's conv ran an FFT")
                ws_rows.append(row)
                emit("conv_workspace", **row)
    del ups
    torch.cuda.empty_cache()
    emit("conv_workspace_done", seconds=time.perf_counter() - t0)

    # 12. bf16_serve: the student in bf16 compute, through the CUDA graphs ----
    t0 = time.perf_counter()

    def bf16_pipeline(name, fused):
        """The artifact's pipeline with its model in bf16 compute: the same
        float32 weights under ``unet.dtype = "bfloat16"``."""
        if name == STUDENT:
            base = ServingPipeline.from_artifact(name, dev, use_pallas_irb=fused, batch_size=8)
        else:
            base = ServingPipeline.from_config(
                os.path.join(art[name], "model_config.json"),
                os.path.join(art[name], "student_timesteps.json"), trained,
                device=dev, batch_size=8)
        return ServingPipeline(with_dtype(base.model, "bfloat16"), base.schedule,
                               base.config, device=dev)

    def irb16_tol(x, kw):
        """The bf16 entry against its plain version, which rounds the same
        product operands to bf16 (``fused_irb_v2_plain``): the float32
        accumulations differ in order only, so an output lands at most on the
        neighbouring bf16 value: one bf16 ulp of the output's largest
        magnitude (trained activations reach ~40, where it is 0.25), and at
        least the random-input bound IRB_TOL["bfloat16"]."""
        with torch.inference_mode():
            top = float(fused_irb_v2_plain(x, **kw).float().abs().max())
        return max(IRB_TOL["bfloat16"], bf16_ulp(top))

    bf16_launches = {"linear_attention": 0, "fused_irb_v2": 0, "fused_irb_v1": 0}
    bf16_replayed = dict(bf16_launches)
    bf16_rows, bf16_checks = {}, {}
    for label, name, grid16, fused in BF16_SERVED:
        pipe = bf16_pipeline(name, fused)
        require(pipe.model.compute_dtype == torch.bfloat16
                and pipe.model.config.unet.dtype == "bfloat16"
                and all(p.dtype == torch.float32 for p in pipe.model.parameters()),
                f"{label}: not a bf16-compute model on float32 weights")
        require(pipe.grid == list(grid16) and pipe.model.config.unet.use_pallas_irb == fused,
                f"{label}: grid {pipe.grid}, fused {pipe.model.config.unet.use_pallas_irb}")
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved_before = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        outs = [pipe(img, seed=i) for i, img in enumerate(images)]   # captures batch 1
        check_outputs(images, outs)
        outs = pipe.batch(batch_images, seed=100)                     # captures batch 8
        check_outputs(batch_images, outs)
        lat = []
        for i in range(10):
            torch.cuda.synchronize()
            a = time.perf_counter()
            pipe(images[2], seed=i)
            lat.append((time.perf_counter() - a) * 1e3)
        a = time.perf_counter()
        outs = pipe.batch(batch_images * REPS, seed=400)
        pipelined = time.perf_counter() - a
        check_outputs(batch_images * REPS, outs)
        torch.cuda.synchronize()
        peak_mem = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        graph_mem = torch.cuda.memory_reserved() - reserved_before
        counts, in_replays, replays = graph_accounting(pipe, label, per_replay(len(grid16), fused), 0)
        require(replays == {1: len(images) + 10, 8: 1 + REPS},
                f"{label}: replays {replays}")
        for k in bf16_launches:
            bf16_launches[k] += counts[k]
            bf16_replayed[k] += in_replays[k]
        # each graph against the eager sampler on the same seed, and what a
        # replay runs: bf16 instances of the hand-written kernels only
        lsb = {}
        for b in (1, 8):
            canvas = torch.cat([pipe.pre(img)[0] for img in batch_images[:b]])
            diff = (pipe._run(canvas, pipe._generator(7)).int()
                    - pipe.run_eager(canvas, pipe._generator(7)).int()).abs()
            lsb[b] = {"max_lsb": int(diff.max()), "values_off": int((diff > 0).sum())}
            require(lsb[b]["max_lsb"] <= GRAPH_LSB_TOL,
                    f"{label} batch {b}: graph vs eager {lsb[b]}")
            names = device_kernels(lambda: pipe._run(canvas, pipe._generator(1)))
            attn = {n: v for n, v in names.items() if "linear_attention_fwd" in n}
            irb = {n: v for n, v in names.items() if "irb_out" in n}
            require(sum(attn.values()) == len(grid16) and all("bfloat16" in n for n in attn),
                    f"{label} batch {b}: attention kernels in a replay {attn}")
            require(bool(irb) == fused and all("bfloat16" in n for n in irb),
                    f"{label} batch {b}: fused-IRB output kernels in a replay {irb}")
            lsb[b].update(attention_kernels_per_replay=sum(attn.values()),
                          irb_out_kernels_per_replay=sum(irb.values()),
                          device_kernels_per_replay=sum(names.values()))
        bf16_rows[label] = row = dict(
            student=label, grid=list(grid16), use_pallas_irb=fused, dtype="bfloat16",
            weights=STUDENT, image=list(images[2].shape),
            latency_ms_mean=float(np.mean(lat)), latency_ms_p50=float(np.median(lat)),
            latency_ms_min=float(np.min(lat)), batch=8,
            images_per_s=REPS * 8 / pipelined, peak_mem_bytes=peak_mem,
            graph_mem_bytes=graph_mem,
            capture_s={b: g.seconds for b, g in sorted(pipe.graphs.items())},
            replays=replays, launches=counts, launches_in_replays=in_replays,
            graph_vs_eager=lsb, lsb_tol=GRAPH_LSB_TOL)
        # the bf16 kernels against their plain versions on this request's
        # own bf16 inputs: mid_attn's q, k, v; decoder_blocks.3.0's x
        if not fused and len(grid16) == 1:
            h = pipe.model.unet.mid_attn.attn.register_forward_pre_hook(capture)
            eager_request(pipe, images[0])
            h.remove()
            q, k, v = captured["qkv"]
            require(q.dtype == torch.bfloat16 and tuple(q.shape) == (1, 1024, 4, 32),
                    f"bf16 mid_attn q {q.dtype} {tuple(q.shape)}")
            bf16_checks["mid_attn_max_err"] = compare(q, k, v)
            require(bf16_checks["mid_attn_max_err"] <= TOL["bfloat16"],
                    f"bf16 mid_attn kernel vs plain: {bf16_checks['mid_attn_max_err']}")
        if fused:
            blk16 = dict(pipe.model.unet.named_modules())[widest]
            h = blk16.register_forward_pre_hook(capture_irb)
            eager_request(pipe, images[0])
            h.remove()
            xb16, temb16 = captured["irb"]
            require(xb16.dtype == torch.bfloat16 and tuple(xb16.shape) == (1, 96, size, size),
                    f"bf16 {widest} x {xb16.dtype} {tuple(xb16.shape)}")
            with torch.inference_mode():
                fs16, fb16 = blk16.time_mlp(temb16).chunk(2, dim=-1)
            kw16 = dict(film_scale=fs16, film_shift=fb16, **irb_args(blk16))
            bf16_checks["irb_max_err"] = irb_compare(xb16, kw16)
            bf16_checks["irb_tol"] = irb16_tol(xb16, kw16)
            require(bf16_checks["irb_max_err"] <= bf16_checks["irb_tol"],
                    f"bf16 {widest} kernel vs plain: {bf16_checks['irb_max_err']} > "
                    f"{bf16_checks['irb_tol']}")
            bf16_checks["irb_block"] = widest
        emit("bf16_serve", **row)
        del pipe, outs
        torch.cuda.empty_cache()

    # the fused IRB's bf16 entry at every IRB shape of one UNet call, batch 1
    # and 8
    irb16_rows = {}
    for (cin, chid, cout, height), (name, count), b in (
            (key, val, b) for b in (1, 8) for key, val in sorted(per_call.items())):
        x, kw = irb_inputs(blocks[name], b, height, height, torch.bfloat16)
        err, tol = irb_compare(x, kw), irb16_tol(x, kw)
        require(err <= tol, f"bf16 fused kernel vs plain {name}: {err} > {tol}")
        moved, flops = irb_work(x, kw)
        bound_ms, bound_by = bound(moved, flops)

        def kernel(x=x, kw=kw):
            with torch.inference_mode():
                fik.fused_irb_v2(x, **kw)

        def plain(x=x, kw=kw):
            with torch.inference_mode():
                fused_irb_v2_plain(x, **kw)

        irb16_rows[name, b] = row = dict(
            kernel="fused_irb_v2", block=name, shape=[b, cin, height, height], chid=chid,
            cout=cout, dtype="bfloat16", per_unet_call=count, max_err=err,
            tol=tol, kernel_ms=cuda_ms(kernel, 20, 3),
            plain_ms=cuda_ms(plain, 20, 3), kernel_graph_ms=graph_ms(kernel, 20, 3),
            plain_graph_ms=graph_ms(plain, 20, 3), bound_ms=bound_ms, bound_by=bound_by,
            tc_bound_ms=irb_tc_bound(x, kw, True),
            tc_bound_by="bytes" if moved / HBM_BYTES_PER_S * 1e3
            >= irb_tc_bound(x, kw, True) else "operations", bytes=moved, flops=flops)
        emit("kernel", **row)
    emit("bf16_serve_done", kernel_launches=bf16_launches,
         kernel_launches_in_replays=bf16_replayed, checks=bf16_checks,
         seconds=time.perf_counter() - t0)

    # 13. bf16_eval: the student's quality in bf16 compute against JAX's ----
    t0 = time.perf_counter()
    bf16_eval_rows = {}
    for fused in (False, True):
        suffix = "_fused" if fused else ""
        with open(f"{ref_base}.eval_ref_bf16compute{suffix}.json") as f:
            bref = json.load(f)
        require(bref["dtype"] == "bfloat16" and bref.get("use_pallas_irb", False) == fused
                and bref.get("xla_allow_excess_precision") is False
                and bref["timesteps"] == grid and bref["n"] == eval_n and bref["size"] == size
                and [im[f"{w}_sha256"] for im in bref["images"] for w in ("low", "high", "noise")]
                == [im[f"{w}_sha256"] for im in ref["images"] for w in ("low", "high", "noise")],
                f"bf16{suffix} eval reference is not for the fp32 reference's inputs")
        base = ServingPipeline.from_artifact(STUDENT, dev, use_pallas_irb=fused)
        model, pipes_schedule = with_dtype(base.model, "bfloat16"), base.schedule
        del base
        reset_launches()
        for _ in range(2):      # the first pass sets up cuDNN; the second is timed
            torch.cuda.synchronize()
            a = time.perf_counter()
            pred = ev.enhance_split(model, pipes_schedule, eval_low, eval_init, eval_step,
                                    grid, device=dev)
            per = ev.per_image_metrics(pred, eval_target)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - a
        calls = 2 * -(-eval_n // ev.BATCH_SIZE) * len(grid)
        counts = kernel_launches()
        require(counts == {"linear_attention": calls,
                           "fused_irb_v2": IRBS_PER_UNET_CALL * calls if fused else 0,
                           "fused_irb_v1": 0},
                f"bf16{suffix} eval: launches {counts} for {calls} UNet calls")
        tol = EVAL_TOL
        deltas = {k: [abs(v - im[k]) for v, im in zip(per[k], bref["images"])] for k in tol}
        for k, t in tol.items():
            worst = int(np.argmax(deltas[k]))
            require(deltas[k][worst] <= t,
                    f"bf16{suffix}: image {worst}: |Δ{k}| {deltas[k][worst]} against "
                    f"JAX's bf16 compute > {t}")
        mean_gap = float(np.mean(deltas["psnr"]))
        require(mean_gap <= BF16_EVAL_MEAN_PSNR_TOL,
                f"bf16{suffix}: mean |ΔPSNR| {mean_gap} dB from JAX's bf16 compute")
        f32_label = SERVED[-1][0] if fused else SERVED[0][0]
        bf16_eval_rows[f"bfloat16{suffix}"] = row = dict(
            student=STUDENT, use_pallas_irb=fused, dtype="bfloat16", grid=grid,
            images=eval_n, size=size, batch=ev.BATCH_SIZE, launches=counts,
            mean={k: float(np.mean(per[k])) for k in tol},
            jax_mean={k: bref["summary"][f"{k}_mean"] for k in tol},
            max_abs_delta={k: max(v) for k, v in deltas.items()},
            worst_image={k: int(np.argmax(v)) for k, v in deltas.items()},
            tol=tol, mean_abs_delta_psnr=mean_gap, mean_abs_delta_psnr_tol=BF16_EVAL_MEAN_PSNR_TOL,
            port_bf16_minus_f32_mean_psnr=float(np.mean(per["psnr"]))
            - eval_rows[f32_label]["mean"]["psnr"],
            jax_bf16_minus_f32_mean_psnr=bref["summary"]["psnr_mean"]
            - ref["summary"]["psnr_mean"],
            seconds=seconds, images_per_s=eval_n / seconds, per_image=per)
        emit("bf16_eval", **row)
        del model, pred
        torch.cuda.empty_cache()
    emit("bf16_eval_done", seconds=time.perf_counter() - t0)

    # 14. train_amp: small@256 with use_amp (bf16 compute, float32 state) ---
    t0 = time.perf_counter()
    amp_cfg = dataclasses.replace(train_cfg, use_amp=True)
    amp_model_cfg = diffusion_config("small", size, prediction_type="v_prediction",
                                     dtype="bfloat16")
    model, schedule = train_model_on_card(amp_model_cfg)
    trainer = Trainer(model, schedule, timed, val, amp_cfg)
    require(model.compute_dtype == torch.bfloat16
            and all(p.dtype == torch.float32 for p in model.parameters()),
            "train_amp: not bf16 compute on float32 parameters")
    lak.linear_attention_kernel.launches = 0
    lak.linear_attention_backward_kernel.launches = 0
    fik.fused_irb_v2.launches = 0
    amp_metrics = []
    for batch in warm:
        trainer.state, m = trainer.train_step(trainer.state, batch)
        amp_metrics.append(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        amp_loss = trainer.train_epoch()
    torch.cuda.synchronize()
    amp_elapsed = time.perf_counter() - a
    amp_peak = torch.cuda.max_memory_allocated()
    amp_launches = {"linear_attention": lak.linear_attention_kernel.launches,
                    "linear_attention_backward": lak.linear_attention_backward_kernel.launches,
                    "fused_irb_v2": fik.fused_irb_v2.launches}
    amp_steps = len(warm) + len(timed)
    require(amp_launches == {"linear_attention": amp_steps * n_attn,
                             "linear_attention_backward": amp_steps * n_attn,
                             "fused_irb_v2": 0},
            f"train_amp: launches {amp_launches} for {amp_steps} steps")
    require(np.isfinite(amp_loss) and all(
        bool(torch.isfinite(m["loss"]) & torch.isfinite(m["grad_norm"])) for m in amp_metrics),
        f"train_amp: loss {amp_loss}")
    require(all(p.grad is not None and p.grad.dtype == torch.float32
                and bool(torch.isfinite(p.grad).all()) for p in model.parameters())
            and all(e.dtype == torch.float32 for e in trainer.state.ema_params.values()),
            "train_amp: gradients or EMA not finite float32")
    # one step under the profiler: its attention backward is one bf16 kernel
    names = device_kernels(lambda: trainer.train_step(trainer.state, timed[0]), calls=1)
    amp_bwd = {n: v for n, v in names.items() if "linear_attention_bwd" in n}
    require(sum(amp_bwd.values()) == n_attn and all("bfloat16" in n for n in amp_bwd),
            f"train_amp: attention backward kernels in a step {amp_bwd}")
    del trainer, model
    shutil.rmtree(os.path.dirname(train_cfg.checkpoint_dir), ignore_errors=True)
    torch.cuda.empty_cache()

    # the first step in bf16 against the float32 step on the same batch, t
    # and ε, on the trained student's weights (random weights leave the
    # attention block's GroupNorm ill-conditioned, and bf16 gradients there
    # differ by factors between any two implementations)
    student_cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dtype="float32"))
    amp_inputs = {}

    def first_step(dtype):
        mcfg = dataclasses.replace(student_cfg, unet=dataclasses.replace(
            student_cfg.unet, dtype=dtype))
        model, schedule = train_model_on_card(mcfg, trained)
        model.train()
        attn = model.unet.mid_attn.attn

        def keep_qkv(module, args):      # the backward's q, k, v ...
            amp_inputs["qkv"] = [x.detach().clone() for x in args]

        def keep_g(module, args, out):   # ... and its upstream gradient
            out.register_hook(lambda g: amp_inputs.__setitem__("g", g.detach().clone()))

        hooks_ = [attn.register_forward_pre_hook(keep_qkv),
                  attn.register_forward_hook(keep_g)]
        out = train_forward(model, schedule, torch.from_numpy(warm[0]["low_light"]).to(dev),
                            torch.from_numpy(warm[0]["normal_light"]).to(dev),
                            timesteps=torch.tensor([739, 259, 37, 801, 500, 100, 900, 5],
                                                   device=dev),
                            noise=torch.from_numpy(np.random.default_rng(3).standard_normal(
                                (8, size, size, 3)).astype(np.float32)).to(dev))
        loss = diffusion_loss(out["noise_pred"], out["target"])
        loss.backward()
        for h_ in hooks_:
            h_.remove()
        return float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    loss16, grads16 = first_step("bfloat16")
    q, k, v = amp_inputs["qkv"]
    g = amp_inputs["g"].contiguous()
    require(q.dtype == torch.bfloat16 and g.dtype == torch.bfloat16,
            f"train_amp: attention backward inputs {q.dtype} {g.dtype}")
    amp_bwd_err = compare_bwd(q, k, v, g)
    require(amp_bwd_err <= BWD_TOL["bfloat16"],
            f"bf16 backward kernel vs plain on the step's own inputs: {amp_bwd_err}")
    loss32, grads32 = first_step("float32")
    norm16 = math.sqrt(sum(float(t.double().square().sum()) for t in grads16.values()))
    norm32 = math.sqrt(sum(float(t.double().square().sum()) for t in grads32.values()))
    gdiff = math.sqrt(sum(float((grads16[n] - grads32[n]).double().square().sum())
                          for n in grads32))
    amp_check = dict(loss_bf16=loss16, loss_f32=loss32,
                     loss_rel=abs(loss16 - loss32) / abs(loss32),
                     grad_norm_bf16=norm16, grad_norm_f32=norm32,
                     grad_norm_rel=abs(norm16 - norm32) / norm32, grad_diff_rel=gdiff / norm32)
    require(amp_check["loss_rel"] <= AMP_LOSS_TOL and amp_check["grad_norm_rel"] <= AMP_GRAD_TOL
            and amp_check["grad_diff_rel"] <= AMP_GRAD_TOL,
            f"train_amp: bf16 step vs float32 step {amp_check}")
    del grads16, grads32, q, k, v, g
    torch.cuda.empty_cache()
    emit("train_amp", config=f"small@{size} v-prediction use_amp (bfloat16 compute)",
         batch=8, warmup_steps=len(warm), timed_steps=len(timed),
         ms_per_step=amp_elapsed * 1e3 / len(timed),
         images_per_s=len(timed) * 8 / amp_elapsed, peak_mem_bytes=amp_peak,
         f32_ms_per_step=elapsed * 1e3 / len(timed), f32_peak_mem_bytes=peak_train,
         train_loss=amp_loss, launches=amp_launches,
         attention_backward_kernels_per_step=sum(amp_bwd.values()),
         backward_on_step_inputs_max_abs_err=amp_bwd_err, bwd_tol=BWD_TOL["bfloat16"],
         first_step_vs_float32=amp_check,
         first_step_tol=dict(loss_rel=AMP_LOSS_TOL, grad_rel=AMP_GRAD_TOL),
         seconds=time.perf_counter() - t0)

    # 15. remat: memory and time of each policy and scope, f32 and bf16 ------
    t0 = time.perf_counter()

    def saved_by_block(model, schedule, batch):
        """Bytes the backward keeps from one forward (each storage once), by
        the UNet block that saved them, largest first."""
        current, sizes, seen = ["other"], defaultdict(int), set()

        def pack(t):
            key = t.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                sizes[current[0]] += t.untyped_storage().nbytes()
            return t

        hooks_ = []
        for name, mod in model.unet.named_modules():
            if name.count(".") == (0 if not name.startswith(("encoder", "decoder", "down", "up"))
                                   else 1 if name.startswith(("down", "up")) else 2) and name:
                hooks_.append(mod.register_forward_pre_hook(
                    lambda m, a, n=name: current.__setitem__(0, n)))
                hooks_.append(mod.register_forward_hook(
                    lambda m, a, o: current.__setitem__(0, "other")))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = train_forward(model, schedule, torch.from_numpy(batch["low_light"]).to(dev),
                                torch.from_numpy(batch["normal_light"]).to(dev),
                                generator=torch.Generator(device=dev).manual_seed(0))
            loss = diffusion_loss(out["noise_pred"], out["target"])
        loss.backward()
        for h_ in hooks_:
            h_.remove()
        return sorted(sizes.items(), key=lambda kv: -kv[1])

    remat_rows = []
    remat_launches = {"linear_attention": 0, "linear_attention_backward": 0}
    # gradients comparable bit for bit; PyTorch's warnings name any operation
    # that has no deterministic implementation
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as nondeterministic:
        warnings.simplefilter("always")
        try:
            for dtype in ("float32", "bfloat16"):
                base_grads = None
                for remat, policy, scope in REMAT_CASES:
                    rcfg = diffusion_config("small", size, prediction_type="v_prediction",
                                            dtype=dtype, remat=remat, remat_policy=policy,
                                            remat_scope=scope)
                    model, schedule = train_model_on_card(rcfg)
                    tc = dataclasses.replace(train_cfg, use_amp=dtype == "bfloat16", remat=remat)
                    state = create_train_state(model, tc)
                    step = make_train_step(model, schedule, tc)
                    before = (lak.linear_attention_kernel.launches,
                              lak.linear_attention_backward_kernel.launches)
                    state, _ = step(state, warm[0])
                    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    a = time.perf_counter()
                    for batch in timed[:REMAT_STEPS]:
                        state, _ = step(state, batch)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - a) * 1e3 / REMAT_STEPS
                    peak = torch.cuda.max_memory_allocated()
                    remat_launches["linear_attention"] += (
                        lak.linear_attention_kernel.launches - before[0])
                    remat_launches["linear_attention_backward"] += (
                        lak.linear_attention_backward_kernel.launches - before[1])
                    diff_rel, tol = 0.0, None
                    if base_grads is None:
                        base_grads = grads
                    else:
                        num = sum(float((grads[n] - base_grads[n]).double().square().sum())
                                  for n in grads)
                        den = sum(float(t.double().square().sum()) for t in base_grads.values())
                        diff_rel, tol = math.sqrt(num / den), 0.0
                        require(diff_rel == 0, f"remat {dtype} {remat} {policy} {scope}: "
                                               f"gradients {diff_rel} from the plain step's")
                    worst = sorted(((float((grads[n] - base_grads[n]).abs().max()
                                           / (base_grads[n].abs().max() + 1e-30)), n)
                                    for n in grads), reverse=True)[:3]
                    row = dict(dtype=dtype, remat=remat, policy=policy if remat else None,
                               scope=scope if remat else None, batch=8, ms_per_step=ms,
                               peak_mem_bytes=peak, grad_vs_no_remat_rel=diff_rel, grad_tol=tol,
                               grad_tensors_differ=sum(not torch.equal(grads[n], base_grads[n])
                                                       for n in grads),
                               grad_worst_tensors=[{"name": n, "max_rel": r} for r, n in worst])
                    if grads is base_grads:
                        del state, step, grads
                        model.zero_grad(set_to_none=True)
                        torch.cuda.empty_cache()
                        top = saved_by_block(model, schedule, warm[0])
                        row["saved_for_backward_bytes"] = sum(v for _, v in top)
                        row["saved_by_block"] = [{"block": n, "bytes": v} for n, v in top[:8]]
                    remat_rows.append(row)
                    emit("remat", **row)
                    del model
                    torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.deterministic = False
            torch.use_deterministic_algorithms(False)
    emit("remat_done", launches=remat_launches,
         nondeterministic_ops_reported=sorted({str(w.message)[:160] for w in nondeterministic
                                               if "determinis" in str(w.message)}),
         seconds=time.perf_counter() - t0)

    # 16. warm_start: init_params_from the committed student, then use_amp --
    t0 = time.perf_counter()
    ws_dir = tempfile.mkdtemp(prefix="chip_smoke_ws_")
    ws_cfg = dataclasses.replace(amp_cfg, init_params_from=npz, init_params_ema=False,
                                 checkpoint_dir=os.path.join(ws_dir, "ckpt"))
    amp_student = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dtype="bfloat16"))
    model, schedule = create_model(amp_student, device=dev)     # PyTorch's random init
    trainer = Trainer(model, schedule, timed[:WARM_START_STEPS], None, ws_cfg)
    file_weights = load_state_dict_npz(npz, dev)
    require(all(torch.equal(t, file_weights[k]) for k, t in model.state_dict().items()),
            "warm start: the loaded parameters are not the file's")
    require(trainer.state.step == 0 and trainer.epoch == 0
            and not trainer.state.optimizer.state_dict()["state"]
            and all(torch.equal(trainer.state.ema_params[k], file_weights[k])
                    for k in trainer.state.ema_params),
            "warm start: not a fresh state on the file's weights")
    ws_losses = []
    for batch in timed[:WARM_START_STEPS]:
        trainer.state, m = trainer.train_step(trainer.state, batch)
        ws_losses.append(float(m["loss"]))
    require(all(np.isfinite(ws_losses)) and trainer.state.step == WARM_START_STEPS,
            f"warm start: losses {ws_losses}")
    moved = max(float((p.detach() - file_weights[n]).abs().max())
                for n, p in model.named_parameters())
    require(0 < moved <= WARM_START_STEPS * 2 * amp_cfg.learning_rate,
            f"warm start: parameters moved {moved} in {WARM_START_STEPS} steps")
    ws_ckpt = trainer.save_checkpoint("warm")
    trainer.wait_for_checkpoints()
    ema_saved = {k: e.detach().clone() for k, e in trainer.state.ema_params.items()}
    fresh, _ = create_model(amp_student, device=dev)
    from_ema = Trainer(fresh, schedule, timed[:1], None,
                       dataclasses.replace(ws_cfg, init_params_from=ws_ckpt, init_params_ema=True))
    require(all(torch.equal(t, ema_saved[k]) for k, t in fresh.state_dict().items())
            and from_ema.state.step == 0
            and all(torch.equal(from_ema.state.ema_params[k], ema_saved[k]) for k in ema_saved),
            "warm start from the checkpoint's EMA: not its EMA")
    emit("warm_start", file=os.path.relpath(npz, ROOT), params=len(file_weights),
         loaded_equal_file=True, steps=WARM_START_STEPS, use_amp=True, losses=ws_losses,
         max_param_move=moved, checkpoint_bytes=os.path.getsize(ws_ckpt),
         ema_checkpoint_loaded_equal=True, seconds=time.perf_counter() - t0)
    del trainer, from_ema, model, fresh, file_weights
    shutil.rmtree(ws_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # 17. data: training from image directories --------------------------
    data = data_phase(dev, n_attn, lak, cuda_build)

    # 18. distill: the distillation losses, steps, trainer and CLI ----------
    distill = distill_phase(dev, n_attn, lak, cuda_build)
    distill_f32 = {k: sum(distill["runs"][r]["launches"][k]
                          for r in ("regression_f32", "consistency_f32"))
                   for k in ("linear_attention", "linear_attention_backward")}
    distill_bf16 = distill["runs"]["regression_bf16"]["launches"]

    # 19-21. int8: the kernels, int8_act serving, QAT ------------------------
    student_w = load_state_dict_npz(os.path.join(ROOT, "artifacts_torch", f"{STUDENT}.npz"), dev)
    int8 = int8_kernel_phase(dev, qk, cuda_ms, graph_ms, cfg, student_w)
    int8_act = int8_act_phase(dev, qk, cuda_ms, graph_ms, cfg, student_w, images,
                              batch_images, reset_launches, linear_path_launches)
    qat_phase(dev, lak, cfg, student_w, n_attn)
    del student_w

    # 22-25. softmax attention and split_skip --------------------------------
    flash_rows = flash_kernel_phase(dev, fk, cuda_build, cuda_ms, graph_ms)
    softmax_serve = softmax_serve_phase(dev, fk, images, batch_images, reset_launches,
                                        all_launches)
    softmax_train = softmax_train_phase(dev, fk, reset_launches)
    split_skip_phase(dev, images, batch_images)

    # 26. cli: the CLIs a user runs, through their main(argv) ----------------
    cli = cli_phase(dev, eval_rows[SERVED[0][0]]["per_image"])["launches"]

    # 27. dp: data parallelism, world size 1 over NCCL and 2 over gloo -------
    torch.cuda.empty_cache()
    dp = dp_phase()

    # kernels line, nvidia-smi line, last line -----------------------------
    main_row = timings[((1, 1024, 4, 32), "float32")]
    bwd_main = bwd_rows[((8, 1024, 4, 32), "float32")]    # the train batch
    # the fused IRB per UNet call at batch 1: each shape's time times the
    # IRBs of that shape in a call
    call_rows = [irb_rows[key + (1, "float32")] for key in per_call]
    per_unet = {f: sum(r[f] * r["per_unet_call"] for r in call_rows)
                for f in ("kernel_ms", "plain_ms", "kernel_graph_ms",
                          "plain_graph_ms", "bound_ms", "tc_bound_ms", "flops")}
    irb_err_all = max([irb_err] + [r["max_err"] for r in irb_rows.values()
                                   if r["dtype"] == "float32"])
    v1_call_rows = [v1_rows[key + (1, "float32")] for key in per_call]
    v1_per_unet = {f: sum(r[f] * r["per_unet_call"] for r in v1_call_rows)
                   for f in ("kernel_ms", "plain_ms", "kernel_graph_ms",
                             "plain_graph_ms", "bound_ms", "tc_bound_ms",
                             "v2_kernel_graph_ms")}
    v1_err_all = max([max(v1_vs_block.values())]
                     + [r["max_err"] for r in v1_rows.values() if r["dtype"] == "float32"])
    kernels = [{
        "name": "linear_attention",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/linear_attention.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_attention.py:82",
        "launches": launches["linear_attention"],
        "launches_in_replays": replayed["linear_attention"],
        "launches_package": pkg_launches["linear_attention"],
        "launches_package_in_replays": pkg_replayed["linear_attention"],
        "launches_train": train_launches["linear_attention"],
        "launches_eval": sum(r["launches"]["linear_attention"] for r in eval_rows.values()),
        "launches_distill": distill_f32["linear_attention"],
        "launches_cli": cli["float32"],
        "launches_dp": dp["float32"]["linear_attention"],
        "max_abs_err": mid_err,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "graph_ms": main_row["kernel_graph_ms"],
        "plain_graph_ms": main_row["plain_graph_ms"],
        "bound_ms": main_row["bound_us"] / 1e3,
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": main_row["shape"],
        "dtype": main_row["dtype"],
        "kernels_per_call": main_row["kernels_per_call"],
    }, {
        "name": "fused_irb_v2",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/fused_irb.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_irb.py:607",
        "launches": launches["fused_irb_v2"],
        "launches_in_replays": replayed["fused_irb_v2"],
        "launches_package": pkg_launches["fused_irb_v2"],
        "launches_package_in_replays": pkg_replayed["fused_irb_v2"],
        "launches_eval": sum(r["launches"]["fused_irb_v2"] for r in eval_rows.values()),
        "launches_dp": dp["float32"]["fused_irb_v2"],
        "max_abs_err": irb_err_all,
        "ms": per_unet["kernel_ms"],
        "plain_ms": per_unet["plain_ms"],
        "graph_ms": per_unet["kernel_graph_ms"],
        "plain_graph_ms": per_unet["plain_graph_ms"],
        "bound_ms": per_unet["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in call_rows) else "bytes",
        "tc_bound_ms": per_unet["tc_bound_ms"],
        "library_ms": None,
        "shape": f"the {IRBS_PER_UNET_CALL} IRBs of one small-UNet call at "
                 f"{size}², batch 1 ({per_unet['flops'] / 1e9:.2f} GFLOP)",
        "dtype": "float32",
    }, {
        "name": "fused_irb_v1",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/fused_irb.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_irb.py:241",
        "launches": v1_path_launches,
        "max_abs_err": v1_err_all,
        "ms": v1_per_unet["kernel_ms"],
        "plain_ms": v1_per_unet["plain_ms"],
        "graph_ms": v1_per_unet["kernel_graph_ms"],
        "plain_graph_ms": v1_per_unet["plain_graph_ms"],
        "v2_graph_ms": v1_per_unet["v2_kernel_graph_ms"],
        "bound_ms": v1_per_unet["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in v1_call_rows) else "bytes",
        "tc_bound_ms": v1_per_unet["tc_bound_ms"],
        "library_ms": None,
        "shape": f"the {IRBS_PER_UNET_CALL} IRBs of one small-UNet call at "
                 f"{size}², batch 1; launched on the {IRBS_PER_UNET_CALL} IRB inputs "
                 "of a served request (no model path runs it)",
        "dtype": "float32",
    }, {
        "name": "linear_attention_backward",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/linear_attention.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_attention.py:202",
        "launches": train_launches["linear_attention_backward"],
        "launches_distill": distill_f32["linear_attention_backward"],
        "launches_dp": dp["float32"]["linear_attention_backward"],
        "max_abs_err": max(r["max_err"] for r in bwd_rows.values()
                           if r["dtype"] == "float32"),
        "ms": bwd_main["kernel_ms"],
        "plain_ms": bwd_main["plain_ms"],
        "graph_ms": bwd_main["kernel_graph_ms"],
        "plain_graph_ms": bwd_main["plain_graph_ms"],
        "bound_ms": bwd_main["bound_ms"],
        "bound_by": bwd_main["bound_by"],
        "library_ms": None,
        "shape": bwd_main["shape"],
        "dtype": bwd_main["dtype"],
        "kernels_per_call": bwd_main["kernels_per_call"],
    }]
    # the bf16 entries of the same kernels, on the bf16 model paths: their
    # launches per phase (the wrappers' counts, set to 0 before each)
    main16 = timings[((1, 1024, 4, 32), "bfloat16")]
    bwd16 = bwd_rows[((8, 1024, 4, 32), "bfloat16")]
    irb16, irb16_b8 = ({f: sum(r[f] * r["per_unet_call"]
                               for (_, b), r in irb16_rows.items() if b == batch)
                        for f in ("kernel_ms", "plain_ms", "kernel_graph_ms",
                                  "plain_graph_ms", "bound_ms", "tc_bound_ms", "flops")}
                       for batch in (1, 8))
    bf16_eval_launches = {k: sum(r["launches"][k] for r in bf16_eval_rows.values())
                          for k in ("linear_attention", "fused_irb_v2")}
    kernels += [{
        "name": "linear_attention_bf16",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/linear_attention.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_attention.py:82",
        "launches": bf16_launches["linear_attention"],
        "launches_in_replays": bf16_replayed["linear_attention"],
        "launches_bf16_eval": bf16_eval_launches["linear_attention"],
        "launches_train_amp": amp_launches["linear_attention"],
        "launches_data_train": sum(r["launches"]["linear_attention"]
                                   for r in data["runs"].values() if "launches" in r),
        "launches_distill": distill_bf16["linear_attention"],
        "launches_cli": cli["bfloat16"],
        "launches_dp": dp["bfloat16"]["linear_attention"],
        "max_abs_err": bf16_checks["mid_attn_max_err"],
        "ms": main16["kernel_ms"],
        "plain_ms": main16["plain_ms"],
        "graph_ms": main16["kernel_graph_ms"],
        "plain_graph_ms": main16["plain_graph_ms"],
        "bound_ms": main16["bound_us"] / 1e3,
        "bound_by": main16["bound_by"],
        "library_ms": None,
        "shape": main16["shape"],
        "dtype": "bfloat16",
    }, {
        "name": "linear_attention_backward_bf16",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/linear_attention.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_attention.py:202",
        "launches": amp_launches["linear_attention_backward"],
        "launches_data_train": sum(r["launches"]["linear_attention_backward"]
                                   for r in data["runs"].values() if "launches" in r),
        "launches_distill": distill_bf16["linear_attention_backward"],
        "launches_cli": cli["backward_bfloat16"],
        "launches_dp": dp["bfloat16"]["linear_attention_backward"],
        "max_abs_err": amp_bwd_err,
        "ms": bwd16["kernel_ms"],
        "plain_ms": bwd16["plain_ms"],
        "graph_ms": bwd16["kernel_graph_ms"],
        "plain_graph_ms": bwd16["plain_graph_ms"],
        "bound_ms": bwd16["bound_ms"],
        "bound_by": bwd16["bound_by"],
        "library_ms": None,
        "shape": bwd16["shape"],
        "dtype": "bfloat16",
    }, {
        "name": "fused_irb_v2_bf16",
        "route": "cuda",
        "source": "cv_diffusion_tpu_torch/csrc/fused_irb.cu",
        "replaces": "cv_diffusion_tpu/ops/pallas_irb.py:607",
        "launches": bf16_launches["fused_irb_v2"],
        "launches_in_replays": bf16_replayed["fused_irb_v2"],
        "launches_bf16_eval": bf16_eval_launches["fused_irb_v2"],
        "max_abs_err": max([bf16_checks["irb_max_err"]]
                           + [r["max_err"] for r in irb16_rows.values()]),
        "ms": irb16["kernel_ms"],
        "plain_ms": irb16["plain_ms"],
        "graph_ms": irb16["kernel_graph_ms"],
        "plain_graph_ms": irb16["plain_graph_ms"],
        # its products at the bf16 rate, the depthwise at the float32 one
        "bound_ms": irb16["tc_bound_ms"],
        "bound_by": "operations" if all(r["tc_bound_by"] == "operations"
                                        for (_, b), r in irb16_rows.items()
                                        if b == 1) else "bytes",
        "f32_rate_bound_ms": irb16["bound_ms"],
        "library_ms": None,
        "shape": f"the {IRBS_PER_UNET_CALL} IRBs of one small-UNet call at "
                 f"{size}², batch 1 ({irb16['flops'] / 1e9:.2f} GFLOP)",
        "dtype": "bfloat16",
        # the same 22 IRBs at batch 8
        "ms_b8": irb16_b8["kernel_ms"],
        "plain_ms_b8": irb16_b8["plain_ms"],
        "graph_ms_b8": irb16_b8["kernel_graph_ms"],
        "plain_graph_ms_b8": irb16_b8["plain_graph_ms"],
        "bound_ms_b8": irb16_b8["tc_bound_ms"],
        "bound_by_b8": "operations" if all(r["tc_bound_by"] == "operations"
                                           for (_, b), r in irb16_rows.items()
                                           if b == 8) else "bytes",
    }]
    # the int8 entries, on the int8_act path: a UNet call's 83 QConvs summed
    # (B = 1: a request's own inputs; B = 8: a batch's)
    t1, t8 = int8_act["timings"][1], int8_act["timings"][8]
    srv = int8_act["served"]["int8_act"]
    for name, key, entry, where in (
            ("qconv_quantize", "qconv_quantize", "quantize", ":163-168, the input quantize"),
            ("qconv_quantize_weight", "qconv_quantize_weight", "quantize_weight",
             ":169-172, the weight quantize (and the port's padded layout)"),
            ("qconv_int8_conv", "qconv_dense", "dense", ":174, conv_general_dilated int8 → int32"),
            ("qconv_int8_depthwise", "qconv_depthwise", "depthwise",
             ":174, conv_general_dilated int8 → int32, feature_group_count=C")):
        r1, r8 = t1[entry], t8[entry]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "cv_diffusion_tpu_torch/csrc/qconv.cu",
            "replaces": f"cv_diffusion_tpu/ops/qconv.py{where} (XLA; no Pallas kernel)",
            "launches": srv["launches"][key],
            "launches_in_replays": sum(r * srv["launches_a_replay"][b][key]
                                       for b, r in srv["replays"].items()),
            "launches_int8_act_eval": int8_act["eval_launches"][key],
            "launches_per_unet_call": r1["calls"],
            "checked_bit_for_bit": int8["checked"][entry] + r1["calls"] + r8["calls"],
            "max_abs_err": 0.0,
            "ms": r1["ms"],
            "plain_ms": r1["plain_ms"],
            "graph_ms": r1["graph_ms"],
            "bound_ms": r1["bound_ms"],
            "bound_by": r1["bound_by"],
            "library_ms": r1.get("library_ms"),
            "library": {
                "quantize": "none: torch.quantize_per_tensor clips at -128, not -127, "
                            "and writes NCHW",
                "quantize_weight": "none: torch.quantize_per_channel takes the scales as "
                                   "given (their absmax is another call), clips at -128 and "
                                   "writes [O, I, kh, kw], not the padded layout",
                "dense": "torch._int_mm on the F.unfold im2col'd operands, padded",
                "depthwise": "F.conv2d float32 depthwise of the int8 values (cuDNN, TF32 "
                             "off): exact, every sum below 2**24"}[entry],
            "shape": f"the {r1['calls']} calls of one small-UNet call at {size}², batch 1 "
                     "(the int8_act package, a request's own inputs)",
            "dtype": "float32",
            "ms_b8": r8["ms"], "graph_ms_b8": r8["graph_ms"], "plain_ms_b8": r8["plain_ms"],
            "bound_ms_b8": r8["bound_ms"], "bound_by_b8": r8["bound_by"],
            "library_ms_b8": r8.get("library_ms"),
        })
    # the flash-attention entries: launches on the softmax path (serving,
    # both dtypes, and training, the counts set to 0 before each run); times
    # at mid_attn's shape, batch 1 (the forward, served) and 8 (the
    # backward, trained)
    stock = "jax/experimental/pallas/ops/tpu/flash_attention.py (JAX 0.9.0)"
    for name, kernel, where, shape in (
            ("flash_attention_fwd", "forward", ":589 (_flash_attention_impl, pallas_call :758)",
             (1, 1024, 4, 32)),
            ("flash_attention_bwd_dkv", "dkv", ":941 (_flash_attention_bwd_dkv, pallas_call :1121)",
             (8, 1024, 4, 32)),
            ("flash_attention_bwd_dq", "dq", ":1287 (_flash_attention_bwd_dq, pallas_call :1456)",
             (8, 1024, 4, 32))):
        fwd = kernel == "forward"
        key = "fwd" if fwd else kernel
        f32rows = [r for (_, dt), r in flash_rows.items() if dt == "float32"]
        errs = [r["max_err"] if fwd else (r["bwd_max_err"]["dq"] if kernel == "dq" else
                                          max(r["bwd_max_err"]["dk"], r["bwd_max_err"]["dv"]))
                for r in f32rows]
        errs.append(softmax_serve["float32"]["mid_attn_max_err"] if fwd
                    else softmax_train["step_bwd_err"])

        def timing(r):
            return dict(ms=r["ms"][key], graph_ms=r["graph_ms"][key],
                        plain_ms=r["ms"]["plain_fwd" if fwd else "plain_bwd"],
                        plain_graph_ms=r["graph_ms"]["plain_fwd" if fwd else "plain_bwd"],
                        library_ms=r["library_ms"]["fwd" if fwd else "bwd"],
                        library_eager_ms=r["library_eager_ms"]["fwd" if fwd else "bwd"],
                        **({} if fwd else {"backward_pair_graph_ms": r["graph_ms"]["bwd"]}),
                        bound_ms=r["bound"][kernel]["ms"], bound_by=r["bound"][kernel]["by"],
                        **({"tensor_bound_ms": r["bound"][kernel]["tensor_ms"]}
                           if "tensor_ms" in r["bound"][kernel] else {}))

        main_row = flash_rows[(shape, "float32")]
        launches_train = softmax_train["launches"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "cv_diffusion_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"{stock}{where}, reached from cv_diffusion_tpu/ops/attention.py:139",
            "launches": (softmax_serve["launches"][name] if fwd else 0) + launches_train,
            "launches_softmax_serve": softmax_serve["launches"][name],
            "launches_softmax_serve_in_replays": softmax_serve["launches_in_replays"] if fwd else 0,
            "launches_softmax_train": launches_train,
            "max_abs_err": max(errs),
            **timing(main_row),
            "library": "torch.nn.functional.scaled_dot_product_attention, graph-timed" + (
                "" if fwd else "; its backward (forward + autograd.grad, less its forward) "
                               "computes dQ, dK and dV together: compare backward_pair_graph_ms "
                               "(dQ, which forms di, then dK/dV)"),
            "shape": list(shape),
            "dtype": "float32",
            "bfloat16": timing(flash_rows[(shape, "bfloat16")]),
            "by_shape": {f"{list(sh)} {dt}": timing(flash_rows[(sh, dt)])
                         for sh in FLASH_TIMED for dt in ("float32", "bfloat16")},
        })
    # the token-sharded linear-attention entries (a spatial axis): launches
    # on the dp phase's spatial runs (both processes), times at a rank's
    # share of the 256² train batch's mid_attn
    for entry in SP_ENTRIES:
        name = f"linear_attention_{entry}"
        row, row16 = dp["entries"][f"{entry} float32"], dp["entries"][f"{entry} bfloat16"]

        def fields(r):
            return dict(max_abs_err=r["max_abs_err"], max_rel_err=r["max_rel_err"],
                        control_rel_err=r["control_rel_err"],
                        rel_tol=SP_REL_TOL[r["dtype"]], ms=r["ms"],
                        plain_ms=r["plain_ms"], graph_ms=r["graph_ms"],
                        plain_graph_ms=r["plain_graph_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=None, shape=r["shape"],
                        dtype=r["dtype"])

        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "cv_diffusion_tpu_torch/csrc/linear_attention.cu",
            "replaces": ("cv_diffusion_tpu/ops/attention.py:51-78, 100-136 (the partitioner's "
                         "psum form of linear_attention_xla / linear_attention_sharded; "
                         "the Pallas kernel cv_diffusion_tpu/ops/pallas_attention.py:82 "
                         "holds no psum)"),
            "launches": dp["spatial"]["float32"][name],
            "launches_bf16": dp["spatial"]["bfloat16"][name],
            **fields(row),
            "library": "none: no PyTorch call reduces half of a token-sharded attention",
            "bfloat16": fields(row16),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
