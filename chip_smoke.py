#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--generations G] [--final-steps F]
                          [--sg2-generations G] [--sg2-final-steps F]
                          [--ffhq-generations G] [--ffhq-final-steps F]
                          [--biggan-generations G] [--biggan-final-steps F]

Phases, one JSON line each; any failure raises and exits non-zero:

1. ``env``: torch and CUDA versions, the card's name and power limit.
2. ``build``: every CUDA source under ``pix2latent_tpu_torch/csrc`` built
   with one ``nvcc`` each, all started together.
3. ``kernels``: every hand-written kernel against its plain PyTorch version
   on the card, in float32 and bfloat16, at the largest shape its path gives
   it and at a small ragged shape:
   - the SA-GAN attention (K1), forward and backward, at the
     BigGAN-deep-256 and BigGAN-deep-128 shapes (in float32 also at the
     transform search's population 7, [7, 4096, 1024, 64, 256], and at
     the editor's one sample, [1, 4096, 1024, 64, 256]), with the
     tolerances of
     ``tests/test_attention.py``, in both routes (bfloat16: ``design``
     ``tensor-core``; float32: ``3xtf32``, each f32 product as three TF32
     products on the tensor cores); two forward + backward calls must also
     give bitwise equal results;
   - the separable FIR blur (K2), forward and backward, at [22, 64, 513, 513]
     with pad (1, 1), with the float32 tolerances of
     ``tests/test_pallas_fir.py`` (atol 1e-5 output, 1e-4 gradient) and, in
     bfloat16, one bf16 rounding step (rtol 2^-7, atol 1e-5): kernel and
     plain version both round one f32 sum once, and the sums differ only in
     the order of the f32 operations;
     in bfloat16 two forward + adjoint calls must also give bitwise equal
     results; ``fir_levels`` holds K2 against its plain version at each of
     the seven blurs of ``sg2_path`` ([22, ch(r), r+1, r+1], r = 8 .. 512,
     from ``models/stylegan2.py:channels_for``), both directions, and times
     each launch with the L2 flushed before it (outside the events), beside
     the depthwise conv, the bound and the bytes the kernel's plan moves
     (``*_design_bytes``, from ``fir_blur_work``), with sums over the levels;
   - the fused modulation backward (K3) at [22, 64, 512, 512], with the
     tolerances of ``tests/test_mod_backward.py``, g_x bitwise equal to the
     plain version and two calls bitwise equal (``deterministic``); each
     timed K3 case prints the kernel's plan (``splits`` blocks a plane in
     one cluster, ``blocks``) and ``composite_ms``, the time of the unfused
     backward that ``modulate(fused=False)`` leaves to autograd (``g * s``
     and the f32 ``(g * x).sum((2, 3))``): no single PyTorch call computes
     both outputs, so ``library_ms`` stays null;
   - K2 and K3 at the largest shapes of ``ffhq_path`` (one 2-sample chunk):
     K2 forward and adjoint at [2, 32, 1025, 1025] with pad (1, 1) (in
     float32 the adjoint's 1025-wide rows are 257 sixteen-byte runs, which
     the kernel cuts into column segments), K3 at [2, 32, 1024, 1024], both
     types, timed as the cars shapes are; ``ffhq_fir_levels`` is
     ``fir_levels`` for the eight blurs of ``ffhq_path`` ([2, ch(r), r+1,
     r+1], r = 8 .. 1024); ``ffhq_mod_levels`` holds K3 against its plain
     version at each of the 26 modulated-conv inputs of one FFHQ chunk
     (``models/stylegan2.py:modulated_conv_inputs``) and times each launch
     cold, beside its bound,
     with sums over the chunk;
   - the block convolution kernel (``ops/block_conv.py``) at four GenBlock
     convolutions of BigGAN-deep-256 at population 18, one for each of its
     pieces: the two heaviest 3x3s (block 7 at 64x64 with 256 channels,
     block 11 at 256x256 with 64; the 4-byte gather, K whole), block 0's
     3x3 at 4x4 with 512 (K split 16 ways, ``splitk_reduce_kernel``) and
     block 11's 1x1 from 64 to 128 channels (the 16-byte route), forward
     and input gradient against float64 ``F.conv2d`` with K1's float32
     tolerances on outputs of unit scale, two calls bitwise equal; timed
     beside cuDNN's heuristic choice (``plain_*_ms``) and cuDNN under
     ``cudnn.benchmark`` (``library_*_ms``), timings only, and the least
     time of its work (``p2l_bench/flops/roofline.least_ms``);
   - the same kernel at five StyleGAN2 modulated convolutions at population
     22 (``SG2_CONV_TIMED``): cars-512's 64 px 3x3 with 512 channels and
     512 px 3x3 with 64 (the stride-1 route), its 128 px up-convolution
     (the up route's four phases, then the stride-2 gather of its input
     gradient), and FFHQ-1024's 1024 px 3x3 and up-convolution (32 output
     channels: the 32-row tile), forward and input gradient against float64
     ``F.conv2d`` and ``F.conv_transpose2d`` (in row chunks), two calls
     bitwise equal, timed as above.
   Times (CUDA events, median of 25 runs; a device-side wait before each
   timed launch keeps the host's time to launch it outside the events) of
   the kernel, the plain version
   and, where one PyTorch call computes the same function, that call
   (``scaled_dot_product_attention`` with ``scale=1.0`` for K1, one
   depthwise ``F.conv2d`` with the 4x4 outer-product kernel for K2; none
   for K3), timed here only and never called by the port, beside the least
   time the card could take: bytes over 3.35 TB/s against operations over
   the peak rate of the units that do them (K1 runs on the tensor cores:
   989 TFLOP/s for bfloat16, the 495 TFLOP/s TF32 rate for float32, as if
   each f32 product cost one TF32 product; K2 and K3 use none: 67 TFLOP/s
   for float32). K1's case also gives the FLOPs its kernels do, tile
   padding included, as the kernel source counts them (``fwd_design_ops``,
   ``bwd_design_ops``; in float32 three tensor-core products each), and
   the max error of ``scaled_dot_product_attention`` against the plain
   version beside the kernel's (``library_*_max_abs_err``), and the
   backward's device time by kernel (``bwd_kernels_ms``, from
   ``torch.profiler``; in float32 with the bytes of the dS scratch that
   its dkv kernel writes and its dq kernel reads, ``ds_scratch_bytes``).
4. ``main_path``: BasinCMA inversion of the ``bench.py`` ramp target through
   BigGAN-deep-256 at full width (channel width 128) in bfloat16, under
   ProjectionLoss (masked L1 + 10 x LPIPS-alex), population 18, 30 inner
   Adam steps per generation, random weights from a seed; by default 20 of
   the flagship's 30 generations and 100 of its 300 final steps (printed as
   ``shortened``, as any schedule from the flags; ``sg2_path``: 10 + 100), so
   that the script stays within about half its time limit. The launch
   counters are set to 0 just before and read just after; they must equal
   one forward per inner step and per tell, one backward per inner step;
   in bfloat16 every GenBlock convolution goes to ``F.conv2d`` (48 calls a
   forward, none through the block convolution kernel).
5. ``whole_step``: one float32 forward and backward of generator + loss at
   population 2 and full width, on the card against the CPU.
6. ``sg2_path``: BasinCMA inversion of the 512x512 ramp through StyleGAN2
   LSUN-Cars (config-f, channel multiplier 2, full width) in bfloat16 under
   ProjectionLoss with the cars border mask, population 22, 30 inner Adam
   steps per generation, z searched with the Normalize + NormalPerturb(0.05)
   hook, random weights from a seed, both StyleGAN2 kernels on. The launch
   counters are set to 0 just before and read just after: 7 blurs per
   forward (inner steps, tells and final steps) and per backward, 23
   modulation backwards per backward.
7. ``sg2_whole_step``: as ``whole_step``, for the StyleGAN2 problem.
8. ``ffhq_path``: BasinCMA inversion of the 1024x1024 ramp through StyleGAN2
   FFHQ (config-f, channel multiplier 2, full width: 18 w layers, 17 noise
   maps) in bfloat16 under ProjectionLoss without a mask, population 22, 30
   inner Adam steps per generation, the Normalize + NormalPerturb(0.05) hook,
   both StyleGAN2 kernels on, under the one-card recipe of
   ``examples/invert_stylegan2_ffhq_basincma.py``: blocks from 256 px
   recomputed in the backward (``remat_from_res`` 256) and microbatches of 2
   (``max_batch_size`` 2, 11 chunks a step). Driven through
   ``BasinCMAOptimizer.optimize_fused`` with a checkpoint in a temporary
   directory, the host syncs of the call recorded by
   ``torch.cuda.set_sync_debug_mode`` and told apart by whether they fall
   inside a fused generation (there only the CMA tell's ``eigh`` may sync,
   once a generation) or outside (the driver's loss reads and checkpoint
   saves, printed). The launch counters are set to 0 just before and read just after:
   see :func:`ffhq_expected_launches`. Then ``optimize_fused`` again on the
   same checkpoint must resume at the end of the meta loop and of the final
   run, running one evaluation and no step.
9. ``ffhq_whole_step``: as ``whole_step``, for the FFHQ problem with remat
   on.
10. ``biggan_f32_path``: the problem of the BigGAN BasinCMA entry point
   (``pix2latent_tpu_torch/examples/invert_biggan_basincma.py``), built by
   its own functions: BigGAN-deep-256 at full width in float32 (so K1 runs
   its float32 route), random weights from seed 0, the synthetic target,
   ``register_biggan_vars``, ProjectionLoss, population 18, 30 inner Adam
   steps, driven by ``BasinCMAOptimizer.optimize`` for 3 of the example's
   30 generations and 30 of its 300 final steps (printed as
   ``shortened``). K1's counters are set to 0 just before and read just
   after: one forward per inner step and per tell, one backward per inner
   step; so are the block convolution kernel's: 48 forward calls (4 a
   GenBlock) per forward, 48 input-gradient calls per backward, none on
   ``F.conv2d``. Prints images/s, seconds per generation, peak memory, the tell
   losses and K1's share of a step (from the ``kernels`` times). Then the
   entry point's ``finish`` writes the results (``vars.npy``,
   ``result.npz``) to a directory of the run, beside the weights
   (``save_params_npz``) and the best sample rendered with its population,
   for ``edit_path``.
11. ``transform_path``: the two phases of the BigGAN transform entry point
   (``pix2latent_tpu_torch/examples/invert_biggan_with_transform.py``),
   built by its own functions, BigGAN-deep-256 at full width in float32:
   the synthetic self-target warped by a known ``T_STAR`` = [1.1, 0.25,
   -0.15] (``SpatialTransform().transform``, which takes ``t`` itself), a
   weight of ones. The search: ``TransformBasinCMAOptimizer.optimize_fused``
   over the spatial ``t``, population 7 (CMA's default at d = 3), z
   propagated, 5 generations of 10 inner Adam steps (the example: 50),
   with a checkpoint, its host syncs recorded as in ``ffhq_path`` (inside a
   generation only the CMA tell's ``eigh``); then the same call on the
   same checkpoint, which must run no step. The latent search:
   ``BasinCMAOptimizer.optimize`` with ``t`` frozen at the candidate and
   both transforms registered, population 18, 2 generations of 10 steps
   and 30 final steps (the example: 30 x 30 + 300), its tells in the
   un-warped frame. K1's counters are set to 0 before each phase and read
   after it (:func:`transform_expected_launches`). Checks: a finite best
   tell loss every generation, the last search generation's below the
   first's, the un-warped tell apart from the warped-frame loss, exact K1
   counts, the sync rule, the resume, and the entry point's mask
   pre-alignment on the card against the box's arithmetic. Prints
   images/s (pop x 10 / mean seconds per generation, the first
   excluded), peak memory and the candidate beside ``T_STAR`` (for
   information only).
12. ``transform_whole_step``: one generation of the composed search
   (spatial + hue + brightness) with injected Δt, z and c at population 2,
   full width, float32, on the card against the CPU: the warped targets
   and weights, one inner step's losses and gradients, and the un-warped
   tell after the Adam update, each within rel 1e-3.
13. ``real_input_path``: the BigGAN entry point on files, float32, full
   width. A ``pytorch_pretrained_biggan`` state dict of the seed-0 model's
   weights is made here with numpy (HF's names, every generator conv and
   linear under spectral norm as ``weight_orig`` / ``weight_u``, sigma a
   known factor in [0.9, 1.1]), saved with ``torch.save``, converted by
   ``python -m pix2latent_tpu_torch.scripts.convert``'s ``main``, and
   ``BigGAN`` loaded from both files: the two must be bitwise equal and
   the baked weights the known ones within rel 1e-5. A rendered target and
   a box mask are written as PNG by ``utils/image.save`` and read back
   bitwise. Then ``examples/invert_biggan_basincma.main`` with ``--fp
   --mask_fp --checkpoint <.npz> --fused`` at ``biggan_f32_path``'s 3 + 30
   schedule: finite tell losses, the final below the first, exact K1 f32
   counts, one ``eigh`` sync in each generation, ``out.jpg``, ``best.jpg``
   and ``result.npz`` written; the best sample re-rendered and
   ``poisson_blend``-ed into the target: uint8 of the target's shape, equal
   to the native solver's output (so the native solver ran), equal to the
   target outside the mask. ``--make_video`` is left out (it needs cv2 or
   imageio; tier-1 runs it).
14. ``batched_path``: ``examples/invert_biggan_batched.main``, bfloat16,
   full width, on 4 PNG self-targets of 4 classes (``--fps``), population
   18 each (72 rows) in chunks of 36 (``--max_batch_size``, so K1 bf16 at
   n = 36), 3 generations of 30 inner steps and 30 final steps: each
   image's loss curve finite and its final loss below its generation-0
   minimum, exact K1 bf16 counts, one ``eigh`` sync a generation for the
   four images; images/s (M x pop x 30 / mean seconds a generation, the
   first excluded) beside ``main_path``'s, seconds a generation, peak.
15. ``transform_batched_path``: ``examples/invert_biggan_transform_batched
   .main --smoke`` on 2 shifted PNG self-targets, bfloat16, full width: the
   batched search 3 x 3 at population 7 (14 rows), then the batched
   inversion with un-warped tells 2 x 3 + 5 at population 18 (36 rows):
   exact K1 counts for each phase, finite losses, each search's last best
   tell below its first.
16. ``ng_hybrid_path``: ``examples/invert_biggan_hybrid_nevergrad.main``
   with ``--ng_method CMA --num_samples 18 --fused --resume``, float32, full
   width, on the synthetic self-target, its 30 x 50 + 300 cut to
   ``NG_HYBRID_SCHEDULE`` (3 x 50 + 100: a final run shorter than a
   generation's 50 steps need not end below generation 0's best); then the
   same command again, which must run no generation and no step (K1: the
   target's forward and one evaluation). Checks: finite tell losses, the
   final loss below generation 0's minimum, exact K1 f32 counts (3 x (50 +
   1) + 100 forwards, one more for the target that ``load_target``
   renders, and 3 x 50 + 100 backwards), one ``eigh`` sync inside each
   fused generation.
17. ``ng_evalonly_path``: ``examples/invert_biggan_nevergrad.main`` with
   ``--ng_method TBPSA --num_samples 18 --fused``, float32, its 1000 + 300
   cut to ``NG_EVAL_SCHEDULE`` (50 + 30). Checks: finite losses, a later
   generation's minimum below generation 0's, exact K1 f32 counts (50 + 30
   + 1 forwards, 30 backwards), and no host sync inside a generation
   (TBPSA has no ``eigh``). Prints evaluations/s.
18. ``cars_ng_path``: StyleGAN2-cars-512 in float32 at population 22: the
   ``init="equalized"`` weights of seed 0 (as ``sg2_path``'s) saved by
   ``save_params_npz`` and given as ``--checkpoint``, so the model comes from
   the cars entry points' ``load_stylegan2``, which turns both StyleGAN2
   kernels on for a CUDA device; the problem built by their functions
   (``stylegan2_problem``: ``load_target``, ``register_stylegan2_vars``,
   ``cars_loss_mask``; ``make_loss``), driven
   by ``HybridNevergradOptimizer("DiagonalCMA").optimize`` at
   ``CARS_NG_SCHEDULE`` (2 x 10 + 30; the example: 30 x 50 + 300). Checks:
   finite losses, the final below generation 0's minimum, both kernel
   flags on in every layer, exact K2 f32 (forward and adjoint, 7 levels)
   and K3 f32 (23 modulated convs) counts, and no ``eigh``. Prints images/s
   and peak memory.
19. ``ffhq_entry_path``: ``examples/invert_stylegan2_ffhq_basincma.main``
   under its recipe (bfloat16, remat from 256, microbatches of 2) on the
   equalized FFHQ-1024 weights of seed 0 as ``--checkpoint``, full width,
   population 22, its 30 x 30 + 300 cut to ``FFHQ_ENTRY_SCHEDULE`` (1 x 10
   + 50: with 10 final steps the final loss stayed above generation 0's
   best). Checks: K2 and K3 on in every layer (``load_stylegan2`` on the
   card), finite losses, the final below generation 0's minimum, exact K2
   bf16 forward and adjoint and K3 bf16 counts from
   :func:`ffhq_expected_launches` (plus the target's forward).
20. ``edit_path``: ``examples/edit_biggan.main`` on ``biggan_f32_path``'s
   ``vars.npy`` with its weights as ``--checkpoint``, BigGAN-deep-256 in
   float32 at the reference's GANSpace defaults (12,800 PCA samples, 32
   components). Checks: ``default()`` (n = 1) within rel 1e-3 of the best
   sample rendered with its population (n = 18); the components finite and
   unit-norm, and, sign-aligned, each within ``EDIT_COMPONENT_ATOL`` of the
   same draws through the same function on the CPU, a bound that grows as
   the inverse of the component's relative gap to its nearest singular
   value below ``EDIT_GAP``; the class and z edits apart
   from the default; K1 f32 launches exactly 3 forwards, one per image.
   Prints the PCA's seconds and the card's peak memory.
21. ``pack_pairs_step``: one StyleGAN2-cars-512 step (generator forward at
   population 22, ``sum(out ** 2)``, the z gradient) with K2 on and
   ``fused_mod_bwd`` off, once with ``pack_pairs_max_ch=64`` (the 512
   level packed) and once without, in bfloat16 (timed, median of CUDA
   events) and in float32. Checks: float32 outputs and z gradients within
   ``tests/test_stylegan2.py``'s packing tolerances (rtol 2e-4, atol 2e-4;
   1e-4 of the largest gradient), bfloat16 within rel 2e-2 (each layer's
   bf16 rounding meets a different summation order), equal K2 counts and
   no K3 launch.
22. ``sharded_path``: ``examples/invert_biggan_basincma_sharded.main
   --smoke`` (2 x 4 + 8), BigGAN-deep-256 at full width in float32,
   population 18, in this process with ``RANK=0 WORLD_SIZE=1 LOCAL_RANK=0
   MASTER_ADDR=127.0.0.1 MASTER_PORT=<a free port>``, as ``torchrun
   --nproc_per_node=1`` sets them, so ``initialize_multihost`` makes an
   NCCL group through ``env://`` and every gather of the population mesh
   runs over NCCL. Checks: the backend is NCCL at world size 1, 18 samples,
   exact K1 f32 counts (one forward a step and a tell and the target's, one
   backward a step), exact gathers (one a generation, then the final z, c,
   images and losses and the tracked z and c), finite tell losses and the
   final loss below generation 0's. Then one generation (4 inner steps and
   the tell) of the same problem from one seed twice, on the mesh and
   without one, under PyTorch's deterministic algorithms: the tell losses
   within rel 1e-6.
   Prints images/s and peak memory; the process group is destroyed
   whatever happens.

Then a ``done`` line with the script's seconds, the ``{"kernels": [...]}``
line (each K2 and K3 entry three times: at the cars path's shapes with
``sg2_path``'s launches, and, ``_ffhq``, at the FFHQ path's with
``ffhq_path``'s; K1 four times: bfloat16 with ``main_path``'s launches,
``_f32``, float32 with ``biggan_f32_path``'s, ``_f32_transform_search`` at
population 7 with the transform search's, ``_f32_transform_latent`` with
the latent search's and ``_f32_real_input`` with ``real_input_path``'s;
bfloat16 ``_batched`` at [36, 4096, 1024, 64, 256] with ``batched_path``'s,
``_transform_batched_search`` at [14, ...] and
``_transform_batched_latent`` at [36, ...] with
``transform_batched_path``'s; float32 ``_f32_hybrid_ng`` and
``_f32_ng_eval`` at [18, ...] with ``ng_hybrid_path``'s and
``ng_evalonly_path``'s; ``_f32_edit``, the forward alone, at [1, ...] with
``edit_path``'s; ``_f32_sharded`` at [18, ...] with ``sharded_path``'s;
K2 and K3 a third time, ``_f32``, float32 at the cars
shapes with ``cars_ng_path``'s, which ``load_stylegan2`` built: each K2 and
K3 entry names its loader in ``launched_by``; the block convolution
kernel's pieces, ``block_conv`` (the 3x3s with K whole),
``block_conv_splitk_reduce`` and ``block_conv_1x1``, each ``_fwd`` and
``_bwd`` at its timed GenBlock shapes, with ``biggan_f32_path``'s calls and
how many of a pass's 48 at population 18 run that piece), and its StyleGAN2
routes, ``block_conv_sg2_3x3`` and ``block_conv_sg2_up``, each ``_fwd`` and
``_bwd`` at its timed shapes, with ``cars_ng_path``'s calls (FFHQ's shapes
run in no phase here: ``ffhq_path`` keeps the bf16 recipe, on cuDNN); the
card's ``nvidia-smi`` line and the result line.
It exits non-zero, printing no result, without a CUDA device or without the
package beside it.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense) and HBM3 bandwidth: the rate of
# the units a kernel's operations run on. K1 runs on the tensor cores, bf16
# at 989 TFLOP/s and f32 as 3xTF32, bound as if each f32 product cost one
# product at the 495 TFLOP/s TF32 rate; K2 and K3 use no tensor cores (f32
# at 67 TFLOP/s)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TENSOR_CORE_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12

FLAGSHIP = (18, 4096, 1024, 64, 256)   # n, q, k, d, dv at 256 px, pop 18
TRANSFORM_SEARCH = (7, 4096, 1024, 64, 256)  # the same at the search's pop 7
EDIT = (1, 4096, 1024, 64, 256)        # the editor's renders, one sample
BIGGAN128 = (18, 4096, 1024, 32, 128)  # the same at 128 px
RAGGED = (3, 100, 37, 5, 20)
# (atol = rtol) for the output and for the gradients, tests/test_attention.py
TOL = {"float32": (1e-5, 2e-4), "bfloat16": (2e-2, 5e-2)}
POP, GRAD_STEPS = 18, 30
SG2_POP = 22

FIR_TAPS = (0.25, 0.75, 0.75, 0.25)    # [1, 3, 3, 1] / 8 * sqrt(4)
FIR_PATH = ((22, 64, 513, 513), (1, 1))
FIR_RAGGED = ((3, 5, 37, 41), (2, 1))
# (rtol, atol) of the output and of the gradient
FIR_TOL = {"float32": ((0.0, 1e-5), (0.0, 1e-4)),
           "bfloat16": ((2.0 ** -7, 1e-5), (2.0 ** -7, 1e-5))}
FLUSH_BYTES = 128 * 2 ** 20           # more than the 50 MB L2
# a device-side wait of about 0.1 ms after the flush, so that the card is
# still busy when the host has prepared the timed launch: the host's time to
# launch stays outside the events
SLEEP_CYCLES = 200_000
MOD_PATH = (22, 64, 512, 512)
MOD_RAGGED = (3, 5, 7, 9)
# FFHQ-1024 under the recipe: a 2-sample chunk at the 1024 level
FFHQ_CHUNK = 2
FIR_FFHQ = ((FFHQ_CHUNK, 32, 1025, 1025), (1, 1))
MOD_FFHQ = (FFHQ_CHUNK, 32, 1024, 1024)
# (rtol, atol) of g_x and of g_s, tests/test_mod_backward.py
MOD_TOL = {"float32": ((1e-6, 0.0), (5e-5, 1e-5)),
           "bfloat16": ((2e-2, 1e-2), (2e-2, 1e-2))}
# BigGAN-deep-256's block convolutions at population 18, by the piece of the
# kernel each one runs: the two heaviest GenBlock 3x3s (block 7 at 64x64
# with 256 channels, block 11 at 256x256 with 64), block 0's 3x3 at 4x4
# (K split 16 ways, then splitk_reduce_kernel) and block 11's last 1x1 (the
# 16-byte route); outputs of unit scale, so K1's float32 tolerances (atol,
# rtol) hold them against float64 F.conv2d
BLOCK_CONV_TIMED = (("3x3", 7, "conv_1"), ("3x3", 11, "conv_1"),
                    ("splitk_reduce", 0, "conv_1"), ("1x1", 11, "conv_3"))
BLOCK_CONV_TOL = (1e-5, 2e-4)
# StyleGAN2's modulated convolutions timed in the kernels phase: (model,
# layer) as ``models/stylegan2.modulated_conv_shapes`` names them
SG2_CONV_TIMED = (("cars", "convs_7"), ("cars", "convs_13"),
                  ("cars", "convs_8"), ("ffhq", "convs_15"),
                  ("ffhq", "convs_14"))
# the transform search: the self-target is warped by T_STAR (s, tx, ty), and
# every generation refines z by 10 Adam steps; the entry point's 50 x 10
# search and 30 x 30 + 300 latent search cut to 5 x 10 and 2 x 10 + 30
T_STAR = (1.1, 0.25, -0.15)
TRANSFORM_STEPS = 10
TRANSFORM_SEARCH_GENS = 5
TRANSFORM_LATENT = (2, 30)        # generations, final Adam steps
# the batched entry point: 4 images of 4 classes at population 18 (72 rows)
# in chunks of 36, 3 of its 30 generations and 30 of its 300 final steps
BATCHED_M, BATCHED_MBS = 4, 36
BATCHED_LABELS = (153, 254, 1, 417)
BATCHED_SCHEDULE = (3, GRAD_STEPS, 30)
BATCHED = (BATCHED_MBS, 4096, 1024, 64, 256)    # K1 at a 36-row chunk
TRANSFORM_BATCHED_SEARCH = (14, 4096, 1024, 64, 256)   # 2 searches x pop 7
# the strategy-registry entry points, cut: the hybrid example's 30 x 50 +
# 300 to 3 x 50 + 100 (with 30 final steps the final loss stayed above
# generation 0's best after its 50 steps on the card: 0.000871 against
# 0.000637), the eval-only example's 1000 + 300 to 50 + 30, and the cars
# hybrid example's 30 x 50 + 300 to 2 x 10 + 30
NG_HYBRID_SCHEDULE = (3, 50, 100)
NG_EVAL_SCHEDULE = (50, 30)
CARS_NG_SCHEDULE = (2, 10, 30)
# the FFHQ entry point's 30 x 30 + 300, cut to 1 x 10 + 50: after 10 final
# steps the final loss stayed above generation 0's best on the card (0.567
# against 0.467); after 30 and 50 it was below (0.349 against 0.452, 0.280
# against 0.540)
FFHQ_ENTRY_SCHEDULE = (1, 10, 50)
# the sharded entry point's tell losses on the mesh against without one,
# one generation under deterministic algorithms
SHARDED_TELL_RTOL = 1e-6
# the edit example's GANSpace defaults (the reference's): feature rows and
# components. The card's components against the CPU's on the same draws,
# sign-aligned: component i within EDIT_COMPONENT_ATOL x max(1, EDIT_GAP /
# its relative gap to the nearest other singular value). Rounding turns a
# component within its near-degenerate neighbour's plane by about the
# rounding error over the gap (Davis-Kahan): both float32 runs stood
# 1.1e-3 to 1.7e-3 off float64 at a pair 3.6e-5 apart, and within 6.8e-4
# of each other at gaps of 5e-4 and more.
EDIT_PCA = (12800, 32)
EDIT_COMPONENT_ATOL = 1e-3
EDIT_GAP = 1e-3
# pack_pairs_step: the thin-channel limit that packs cars' 512 level (64
# channels), and the timed repetitions of its step
PACK_MAX_CH = 64
PACK_REPS = 10


# where the K2 and K3 launches of the kernels line come from: the model's
# loader in each phase
LAUNCHED_BY = {
    "main": "sg2_path (chip_smoke._build_stylegan2)",
    "ffhq_path": "ffhq_path (chip_smoke._build_ffhq)",
    "cars_ng": ("cars_ng_path (examples/common.load_stylegan2, the cars "
                "entry points' loader)")}


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=25, warmup=3):
    """Median ms of ``fn`` over ``reps`` launches, back to back. Before each,
    a device-side wait of about 0.1 ms covers the host's time to launch it,
    which stays outside the events (a 0.2 ms kernel behind a Python wrapper
    was otherwise timed with the wrapper)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_parts_ms(fn, reps=5):
    """Device ms a call of ``fn`` spends in each CUDA kernel it launches,
    by kernel name (the template's name), from ``torch.profiler`` over
    ``reps`` calls after one untraced call."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            found = re.search(r"([A-Za-z_]\w*)[<(]", evt.key.replace(
                "(anonymous namespace)::", ""))
            name = found.group(1) if found else evt.key[:80]
            parts[name] = (parts.get(name, 0.0)
                           + evt.self_device_time_total / 1e3 / reps)
    return parts


def max_err_within(a, b, tol, atol=None):
    """(max |a - b|, whether |a - b| <= atol + tol * |b| everywhere); atol
    defaults to tol."""
    a, b = a.detach().float(), b.detach().float()
    diff = (a - b).abs()
    atol = tol if atol is None else atol
    return float(diff.max()), bool((diff <= atol + tol * b.abs()).all())


def bound(bytes_moved, ops, dtype_name, peaks=PEAK_FLOPS):
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the peak rate for the type (``peaks``: the units the
    operations run on)."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peaks[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def phase_env():
    import torch
    info = {"phase": "env", "python": sys.version.split()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(), "nvidia_smi": smi_line()}
    emit(info)
    return info


def phase_build():
    from pix2latent_tpu_torch.utils.cuda_build import all_sources, build
    t0 = time.perf_counter()
    report = build(all_sources())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": report})


def _attention_case(shape, dtype, timed):
    import torch
    import torch.nn.functional as F
    from pix2latent_tpu_torch.ops import attention as A

    n, q, k, d, dv = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def mk(*s):
        return (0.5 * torch.randn(s, generator=gen, device="cuda")).to(dtype)

    theta, phi, g, cot = mk(n, q, d), mk(n, k, d), mk(n, k, dv), mk(n, q, dv)
    ins_k = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
    out_k = A.sagan_attention(*ins_k)
    grads_k = torch.autograd.grad(out_k, ins_k, cot)
    ins_r = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
    out_r = A.sagan_attention_reference(*ins_r)
    grads_r = torch.autograd.grad(out_r, ins_r, cot, retain_graph=True)
    torch.cuda.synchronize()

    name = str(dtype).replace("torch.", "")
    tol_o, tol_g = TOL[name]
    err_o, ok_o = max_err_within(out_k, out_r, tol_o)
    errs_g = [max_err_within(a, b, tol_g) for a, b in zip(grads_k, grads_r)]
    design = "tensor-core" if dtype == torch.bfloat16 else "3xtf32"
    case = {"kernel": "sagan_attention", "shape": list(shape), "dtype": name,
            "design": design, "tol_out": tol_o,
            "tol_grad": tol_g, "fwd_max_abs_err": err_o,
            "bwd_max_abs_err": max(e for e, _ in errs_g),
            "ok": ok_o and all(ok for _, ok in errs_g)}
    if not timed:
        return case

    o, m, l = A.kernel_forward(theta, phi, g)
    runs = []
    for _ in range(2):
        o2, m2, l2 = A.kernel_forward(theta, phi, g)
        runs.append((o2, m2, l2,
                     *A.kernel_backward(theta, phi, g, cot, o2, m2, l2)))
    case["deterministic"] = all(torch.equal(a, b) for a, b in zip(*runs))
    case["ok"] = case["ok"] and case["deterministic"]
    del runs
    case["fwd_ms"] = cuda_ms(lambda: A.kernel_forward(theta, phi, g))
    case["bwd_ms"] = cuda_ms(
        lambda: A.kernel_backward(theta, phi, g, cot, o, m, l))
    # the backward's device time by kernel; in float32 its dkv kernel
    # writes dS^T (an [n, k, q] f32 scratch) and its dq kernel reads it back
    case["bwd_kernels_ms"] = kernel_parts_ms(
        lambda: A.kernel_backward(theta, phi, g, cot, o, m, l))
    if dtype == torch.float32:
        case["ds_scratch_bytes"] = 4 * n * k * q
    case["plain_fwd_ms"] = cuda_ms(
        lambda: A.sagan_attention_reference(theta, phi, g))
    case["plain_bwd_ms"] = cuda_ms(
        lambda: torch.autograd.grad(out_r, ins_r, cot, retain_graph=True))
    case["library_fwd_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(theta, phi, g, scale=1.0))
    ins_l = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
    out_l = F.scaled_dot_product_attention(*ins_l, scale=1.0)
    case["library_bwd_ms"] = cuda_ms(
        lambda: torch.autograd.grad(out_l, ins_l, cot, retain_graph=True))
    grads_l = torch.autograd.grad(out_l, ins_l, cot, retain_graph=True)
    case["library_fwd_max_abs_err"] = max_err_within(out_l, out_r, tol_o)[0]
    case["library_bwd_max_abs_err"] = max(
        max_err_within(a, b, tol_g)[0] for a, b in zip(grads_l, grads_r))
    del grads_l

    # each input read once, each output written once; the f32 row
    # statistics (m, l) are an output of the forward and an input of the
    # backward
    size = 2 if dtype == torch.bfloat16 else 4
    stats = 2 * 4 * n * q
    bytes_fwd = size * (n * q * d + n * k * d + n * k * dv + n * q * dv) \
        + stats
    bytes_bwd = size * 2 * (n * q * d + n * k * d + n * k * dv) \
        + size * n * q * dv + stats
    ops_fwd = 2 * n * q * k * (d + dv)
    ops_bwd = 2 * n * q * k * (3 * d + 2 * dv)
    # the FLOPs the kernels do, tile padding included, as their source
    # counts them (float32: three tensor-core products each)
    work = A.kernel_work(n, q, k, d, dv, dtype)
    case["peak_flops"] = TENSOR_CORE_FLOPS[name]
    for key, b, f, f_done in (("fwd", bytes_fwd, ops_fwd, work[0]),
                              ("bwd", bytes_bwd, ops_bwd, work[1])):
        case[f"{key}_bound_ms"], case[f"{key}_bound_by"] = bound(
            b, f, name, TENSOR_CORE_FLOPS)
        case[f"{key}_bytes"], case[f"{key}_ops"] = b, f
        case[f"{key}_design_ops"] = f_done
    del o
    return case


def _randn(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _fir_case(shape, pad, dtype, timed):
    import torch
    import torch.nn.functional as F
    from pix2latent_tpu_torch.ops import fir_blur as FB

    n, c, h, w = shape
    k = len(FIR_TAPS)
    ho, wo = h + sum(pad) - k + 1, w + sum(pad) - k + 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = _randn(gen, (n, c, h, w), dtype)
    cot = _randn(gen, (n, c, ho, wo), dtype)
    taps = tuple(float(t) for t in FIR_TAPS)

    x_k = x.clone().requires_grad_(True)
    y_k = FB.fir_blur(x_k, taps, pad)
    (dx_k,) = torch.autograd.grad(y_k, x_k, cot)
    x_r = x.clone().requires_grad_(True)
    y_r = FB.fir_blur_reference(x_r, taps, pad)
    (dx_r,) = torch.autograd.grad(y_r, x_r, cot)
    torch.cuda.synchronize()

    name = str(dtype).replace("torch.", "")
    (rt_o, at_o), (rt_g, at_g) = FIR_TOL[name]
    err_o, ok_o = max_err_within(y_k, y_r, rt_o, at_o)
    err_g, ok_g = max_err_within(dx_k, dx_r, rt_g, at_g)
    case = {"kernel": "fir_blur", "shape": list(shape), "pad": list(pad),
            "dtype": name, "tol_out": [rt_o, at_o], "tol_grad": [rt_g, at_g],
            "fwd_max_abs_err": err_o, "bwd_max_abs_err": err_g,
            "ok": ok_o and ok_g and y_k.dtype == dtype and dx_k.dtype == dtype}
    if not timed:
        return case

    if dtype == torch.bfloat16:
        runs = [(FB.kernel_forward(x, taps, pad), FB.kernel_backward(cot, taps, pad))
                for _ in range(2)]
        case["deterministic"] = all(torch.equal(a, b) for a, b in zip(*runs))
        case["ok"] = case["ok"] and case["deterministic"]
        del runs
    adj_taps, adj_pad = FB.adjoint(taps, pad)
    case["fwd_ms"] = cuda_ms(lambda: FB.kernel_forward(x, taps, pad))
    case["bwd_ms"] = cuda_ms(lambda: FB.kernel_backward(cot, taps, pad))
    case["plain_fwd_ms"] = cuda_ms(lambda: FB.fir_blur_reference(x, taps, pad))
    case["plain_bwd_ms"] = cuda_ms(
        lambda: FB.fir_blur_reference(cot, adj_taps, adj_pad))
    # the library call: one depthwise conv with the 4x4 outer product (both
    # pads here are symmetric, so the conv pads)
    k2 = torch.outer(torch.tensor(taps), torch.tensor(taps)).to(
        device="cuda", dtype=dtype)
    weight = k2[None, None].repeat(c, 1, 1, 1)
    assert pad[0] == pad[1] and adj_pad[0] == adj_pad[1]
    case["library_fwd_ms"] = cuda_ms(
        lambda: F.conv2d(x, weight, padding=pad[0], groups=c))
    case["library_bwd_ms"] = cuda_ms(
        lambda: F.conv2d(cot, weight.flip(2, 3), padding=adj_pad[0],
                         groups=c))

    # each input read once, each output written once; 2 FLOPs per tap in
    # the column pass over the padded width and in the row pass
    size = 2 if dtype == torch.bfloat16 else 4
    bytes_ = size * n * c * (h * w + ho * wo)
    for key, rows, w_in, w_out, p in (("fwd", ho, w, wo, pad),
                                      ("bwd", h, wo, w, adj_pad)):
        ops = 2 * k * n * c * rows * (w_in + sum(p) + w_out)
        case[f"{key}_bound_ms"], case[f"{key}_bound_by"] = bound(bytes_, ops,
                                                                 name)
        case[f"{key}_bytes"], case[f"{key}_ops"] = bytes_, ops
    case["fwd_design_bytes"] = FB.kernel_work(x.shape, k, pad, dtype)
    case["bwd_design_bytes"] = FB.kernel_work(cot.shape, k, adj_pad, dtype)
    return case


def sg2_blur_levels(im_res=512, n=SG2_POP):
    """(r, x shape) of the blur after each up-conv of StyleGAN2 at ``im_res``
    on ``n`` samples: the transposed conv of a res r/2 input gives r + 1 rows
    and columns of ``channels_for(r)`` channels."""
    import math

    from pix2latent_tpu_torch.models.stylegan2 import channels_for
    return [(2 ** i, (n, channels_for(2 ** i), 2 ** i + 1, 2 ** i + 1))
            for i in range(3, int(math.log2(im_res)) + 1)]


def cold_ms(fn, flush, reps=15):
    """Median ms of ``fn`` over ``reps`` launches, each timed with CUDA
    events after the L2 is flushed (the flush, and a short device-side wait
    that covers the host's launch time, outside the events)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _fir_levels(dtype, levels, kernel="fir_levels"):
    """K2 at every level of a path (``sg2_blur_levels``), forward and
    adjoint: against the plain version, and timed cold (L2 flushed) beside
    the depthwise conv, the bound and the bytes the kernel's plan moves."""
    import torch
    import torch.nn.functional as F
    from pix2latent_tpu_torch.ops import fir_blur as FB

    name = str(dtype).replace("torch.", "")
    (rt_o, at_o), (rt_g, at_g) = FIR_TOL[name]
    size = 2 if dtype == torch.bfloat16 else 4
    taps = tuple(float(t) for t in FIR_TAPS)
    k, pad = len(taps), FIR_PATH[1]
    adj_taps, adj_pad = FB.adjoint(taps, pad)
    k2 = torch.outer(torch.tensor(taps), torch.tensor(taps))
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results, ok = [], True
    for r, shape in levels:
        n, c, h, w = shape
        x = _randn(gen, shape, dtype)
        cot = _randn(gen, (n, c, r, r), dtype)
        y, dx = FB.kernel_forward(x, taps, pad), FB.kernel_backward(cot, taps, pad)
        err_o, ok_o = max_err_within(y, FB.fir_blur_reference(x, taps, pad),
                                     rt_o, at_o)
        err_g, ok_g = max_err_within(
            dx, FB.fir_blur_reference(cot, adj_taps, adj_pad), rt_g, at_g)
        weight = k2.to(device="cuda", dtype=dtype)[None, None].repeat(c, 1, 1, 1)
        level = {"r": r, "shape": list(shape), "fwd_max_abs_err": err_o,
                 "bwd_max_abs_err": err_g, "ok": ok_o and ok_g}
        for key, fn, lib, b in (
                ("fwd", lambda: FB.kernel_forward(x, taps, pad),
                 lambda: F.conv2d(x, weight, padding=pad[0], groups=c), x),
                ("bwd", lambda: FB.kernel_backward(cot, taps, pad),
                 lambda: F.conv2d(cot, weight.flip(2, 3), padding=adj_pad[0],
                                  groups=c), cot)):
            level[f"{key}_ms"] = cold_ms(fn, flush)
            level[f"library_{key}_ms"] = cold_ms(lib, flush)
            rows, w_in, w_out, pd = (r, w, r, pad) if key == "fwd" else (
                h, r, w, adj_pad)
            level[f"{key}_bound_ms"] = bound(
                size * n * c * (h * w + r * r),
                2 * k * n * c * rows * (w_in + sum(pd) + w_out), name)[0]
            level[f"{key}_design_bytes"] = FB.kernel_work(
                b.shape, k, pad if key == "fwd" else adj_pad, dtype)
        ok = ok and level["ok"]
        results.append(level)
        del x, cot, y, dx, weight
    case = {"kernel": kernel, "dtype": name, "pad": list(pad),
            "tol_out": [rt_o, at_o], "tol_grad": [rt_g, at_g],
            "levels": results, "ok": ok and len(results) == len(levels)}
    for key in ("fwd", "bwd"):
        for field in (f"{key}_ms", f"library_{key}_ms", f"{key}_bound_ms"):
            case[f"sum_{field}"] = sum(lv[field] for lv in results)
    del flush
    return case


def _mod_case(shape, dtype, timed):
    import torch
    from pix2latent_tpu_torch.ops import mod_backward as MB

    n, c, h, w = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    g = _randn(gen, (n, c, h, w), dtype)
    x = _randn(gen, (n, c, h, w), dtype)
    s = (torch.rand((n, c), generator=gen, device="cuda") + 0.5).to(dtype)
    gx_k, gs_k = MB.fused_mod_backward(g, x, s)
    gx_r, gs_r = MB.mod_backward_reference(g, x, s)
    torch.cuda.synchronize()

    name = str(dtype).replace("torch.", "")
    (rt_x, at_x), (rt_s, at_s) = MOD_TOL[name]
    err_x, ok_x = max_err_within(gx_k, gx_r, rt_x, at_x)
    err_s, ok_s = max_err_within(gs_k, gs_r, rt_s, at_s)
    again = MB.fused_mod_backward(g, x, s)
    torch.cuda.synchronize()
    splits, threads, vec = MB.mod_backward_plan(
        n * c, h * w, itemsize=g.element_size(),
        aligned=all(t.data_ptr() % 16 == 0 for t in (g, x, gx_k)))
    case = {"kernel": "mod_backward", "shape": list(shape), "dtype": name,
            "tol_gx": [rt_x, at_x], "tol_gs": [rt_s, at_s],
            "gx_max_abs_err": err_x, "gs_max_abs_err": err_s,
            "max_abs_err": max(err_x, err_s),
            "gx_bitwise": torch.equal(gx_k, gx_r),
            "deterministic": (torch.equal(again[0], gx_k)
                              and torch.equal(again[1], gs_k)),
            "splits": splits, "threads": threads, "vec": vec,
            "blocks": n * c * splits}
    case["ok"] = (ok_x and ok_s and case["gx_bitwise"]
                  and case["deterministic"] and gx_k.dtype == dtype
                  and gs_k.dtype == torch.float32)
    if not timed:
        return case
    case["ms"] = cuda_ms(lambda: MB.kernel_mod_backward(g, x, s))
    case["plain_ms"] = cuda_ms(lambda: MB.mod_backward_reference(g, x, s))
    case["library_ms"] = None     # no single PyTorch call computes both
    case["composite_ms"] = cuda_ms(lambda: mod_composite(g, x, s))
    case["bound_ms"], case["bound_by"] = bound(*mod_bytes_ops(shape, dtype),
                                               name)
    case["bytes"], case["ops"] = mod_bytes_ops(shape, dtype)
    return case


def mod_composite(g, x, s):
    """The unfused backward of ``modulate(fused=False)``: autograd's
    ``g * s`` and the f32 sum ``(g * x).sum((2, 3))``, two PyTorch calls."""
    import torch
    return g * s[:, :, None, None], (g * x).sum((2, 3), dtype=torch.float32)


def mod_bytes_ops(shape, dtype):
    """K3's minimal bytes (g and x read, g_x written, s read, g_s written)
    and operations (g * s, g * x and the add)."""
    import torch
    n, c, h, w = shape
    size = 2 if dtype == torch.bfloat16 else 4
    return 3 * n * c * h * w * size + n * c * (size + 4), 3 * n * c * h * w


def _mod_levels(dtype):
    """K3 at each modulated-conv input of one FFHQ chunk: against its plain
    version (g_x bitwise, g_s within the tolerances), timed cold (L2 flushed)
    beside its bound, with sums over the chunk."""
    import torch
    from pix2latent_tpu_torch.models.stylegan2 import modulated_conv_inputs
    from pix2latent_tpu_torch.ops import mod_backward as MB

    name = str(dtype).replace("torch.", "")
    (rt_x, at_x), (rt_s, at_s) = MOD_TOL[name]
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results, ok = [], True
    for conv, shape in modulated_conv_inputs(1024, FFHQ_CHUNK):
        n, c, h, w = shape
        g, x = _randn(gen, shape, dtype), _randn(gen, shape, dtype)
        s = (torch.rand((n, c), generator=gen, device="cuda") + 0.5).to(dtype)
        gx, gs = MB.kernel_mod_backward(g, x, s)
        gx_r, gs_r = MB.mod_backward_reference(g, x, s)
        err_s, ok_s = max_err_within(gs, gs_r, rt_s, at_s)
        splits, _, _ = MB.mod_backward_plan(n * c, h * w,
                                            itemsize=g.element_size())
        level = {"conv": conv, "shape": list(shape), "splits": splits,
                 "gs_max_abs_err": err_s,
                 "ok": torch.equal(gx, gx_r) and ok_s,
                 "ms": cold_ms(lambda: MB.kernel_mod_backward(g, x, s), flush),
                 "composite_ms": cold_ms(lambda: mod_composite(g, x, s),
                                         flush),
                 "bound_ms": bound(*mod_bytes_ops(shape, dtype), name)[0]}
        ok = ok and level["ok"]
        results.append(level)
        del g, x, gx, gx_r
    case = {"kernel": "ffhq_mod_levels", "dtype": name, "levels": results,
            "ok": ok and len(results) == 26}
    for field in ("ms", "composite_ms", "bound_ms"):
        case[f"sum_{field}"] = sum(lv[field] for lv in results)
    del flush
    return case


def _block_conv_route(k, splits):
    """The piece of the block convolution kernel a call runs: ``1x1`` (the
    16-byte route), ``splitk_reduce`` (a 3x3 with K split, then reduced) or
    ``3x3`` (the 4-byte gather, K whole)."""
    return "1x1" if k == 1 else "splitk_reduce" if splits > 1 else "3x3"


def _genblock_shapes(rows=POP):
    """BigGAN-deep-256's GenBlock convolutions, read from a generator built
    on the ``meta`` device (no memory, no weights)."""
    import torch
    from pix2latent_tpu_torch.models.biggan import (BigGANDeepGenerator,
                                                    genblock_conv_shapes)
    with torch.device("meta"):
        generator = BigGANDeepGenerator("biggan-deep-256")
    return genblock_conv_shapes(generator, rows)


def _block_conv_case(route, block, layer, rows=POP):
    """The block convolution kernel at GenBlock ``block``'s ``layer`` at
    ``rows`` images, which runs ``route`` (``_block_conv_route``, checked):
    forward and input gradient against float64 F.conv2d,
    two calls bitwise equal; timed beside cuDNN (``_time_conv_case``)."""
    import torch
    import torch.nn.functional as F
    from p2l_bench.flops.roofline import conv_ops
    from pix2latent_tpu_torch.ops import block_conv as BC
    from pix2latent_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")      # float32 as the port runs it: TF32 off
    x_shape, w_shape = next((x, w) for b, l, x, w in _genblock_shapes(rows)
                            if (b, l) == (block, layer))
    n, cin, h, w = x_shape
    cout, _, k, _ = w_shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.randn(x_shape, generator=gen, device="cuda")
    wt = torch.randn(w_shape, generator=gen, device="cuda") / (cin * k * k) ** 0.5
    b = torch.randn(cout, generator=gen, device="cuda")
    g = torch.randn((n, cout, h, w), generator=gen, device="cuda")
    fwd_pack, bwd_pack = BC.packed_weights(wt)
    run_fwd = lambda: BC.kernel_conv(x, fwd_pack, b, k)
    run_bwd = lambda: BC.kernel_conv(g, bwd_pack, None, k)
    y, dx = run_fwd(), run_bwd()
    deterministic = torch.equal(y, run_fwd()) and torch.equal(dx, run_bwd())
    xd = x.double().requires_grad_(True)
    y_ref = F.conv2d(xd, wt.double(), b.double(), padding=k // 2)
    y_ref.backward(g.double())
    atol, rtol = BLOCK_CONV_TOL
    errs = {}
    for key, got, want in (("fwd", y, y_ref.detach()), ("bwd", dx, xd.grad)):
        err = (got.double() - want).abs()
        errs[key] = (float(err.max()), bool((err <= atol * max(
            1.0, float(want.abs().max())) + rtol * want.abs()).all()))
    del xd, y_ref
    torch.cuda.empty_cache()
    splits = {"fwd": BC.kernel_splits(n, fwd_pack.shape[-1], h, w, cout, k),
              "bwd": BC.kernel_splits(n, bwd_pack.shape[-1], h, w, cin, k)}
    case = {"kernel": "block_conv", "route": route, "block": block,
            "layer": layer, "x_shape": list(x_shape), "w_shape": list(w_shape),
            "dtype": "float32", "design": "3xtf32", "tol": [atol, rtol],
            "fwd_splits": splits["fwd"], "bwd_splits": splits["bwd"],
            "fwd_max_abs_err": errs["fwd"][0], "bwd_max_abs_err": errs["bwd"][0],
            "deterministic": deterministic}
    runs = all(_block_conv_route(k, splits[key]) == route for key in splits)
    case["ok"] = errs["fwd"][1] and errs["bwd"][1] and deterministic and runs
    pad = [k // 2, k // 2]
    cudnn_fwd = lambda: F.conv2d(x, wt, b, padding=k // 2)
    cudnn_bwd = lambda: torch.ops.aten.convolution_backward(
        g, x, wt, None, [1, 1], pad, [1, 1], False, [0, 0], 1,
        [True, False, False])
    _time_conv_case(case, (run_fwd, run_bwd), (cudnn_fwd, cudnn_bwd),
                    conv_ops(n, cin, cout, k, h, w),
                    4 * (x.numel() + wt.numel() + g.numel()))
    return case


def _time_conv_case(case, kernel, cudnn, ops, bytes_moved):
    """Times a block convolution case's ``kernel`` (forward, input
    gradient) beside ``cudnn``'s (its heuristic choice, the plain version,
    and under ``cudnn.benchmark``, as a library time) into ``case``, with
    the least time of the work (``p2l_bench/flops/roofline.least_ms``: x,
    the weight and y once, and the products once at the TF32 rate)."""
    import torch
    from p2l_bench.flops.roofline import least_ms

    case["fwd_ms"], case["bwd_ms"] = cuda_ms(kernel[0]), cuda_ms(kernel[1])
    case["plain_fwd_ms"], case["plain_bwd_ms"] = (cuda_ms(cudnn[0]),
                                                  cuda_ms(cudnn[1]))
    torch.backends.cudnn.benchmark = True
    try:
        case["library_fwd_ms"] = cuda_ms(cudnn[0], warmup=5)
        case["library_bwd_ms"] = cuda_ms(cudnn[1], warmup=5)
    finally:
        torch.backends.cudnn.benchmark = False
    for key in ("fwd", "bwd"):
        case[f"{key}_bound_ms"] = least_ms(bytes_moved, ops)
        case[f"{key}_bound_by"] = ("bytes" if bytes_moved / PEAK_BYTES
                                   > ops / TENSOR_CORE_FLOPS["float32"]
                                   else "operations")
        case[f"{key}_tflops"] = ops / case[f"{key}_ms"] / 1e9


def _sg2_conv_case(model, layer, rows=SG2_POP):
    """The block convolution kernel at StyleGAN2 ``model``'s modulated conv
    ``layer`` (``modulated_conv_shapes``) at ``rows`` samples: its stride-1
    route, or for an up-convolution its up route and the stride-2 gather of
    the input gradient; forward and input gradient against float64
    ``F.conv2d`` or ``F.conv_transpose2d`` (a few rows at a time), two calls
    bitwise equal; timed beside cuDNN (``_time_conv_case``)."""
    import torch
    import torch.nn.functional as F
    from p2l_bench.flops.roofline import conv_ops
    from pix2latent_tpu_torch.models.stylegan2 import (StyleGAN2,
                                                       StyleGAN2Generator,
                                                       modulated_conv_shapes)
    from pix2latent_tpu_torch.ops import block_conv as BC
    from pix2latent_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")      # float32 as the port runs it: TF32 off
    with torch.device("meta"):
        generator = StyleGAN2Generator(StyleGAN2.MODELS[model])
    up, x_shape, w_shape = next((u, x, w) for name, u, x, w in
                                modulated_conv_shapes(generator, rows)
                                if name == layer)
    n, cin, h, w = x_shape
    cout = w_shape[0]
    out = (2 * h + 1, 2 * w + 1) if up else (h, w)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.randn(x_shape, generator=gen, device="cuda")
    wt = torch.randn(w_shape, generator=gen, device="cuda") / (cin * 9) ** 0.5
    g = torch.randn((n, cout) + out, generator=gen, device="cuda")
    fwd_pack, bwd_pack = BC.scaled_packs(wt, 1.0, up)
    routes = (BC.UP, BC.UP_GRAD) if up else (BC.SAME, BC.SAME)
    run_fwd = lambda: BC.kernel_conv(x, fwd_pack, None, 3, routes[0])
    run_bwd = lambda: BC.kernel_conv(g, bwd_pack, None, 3, routes[1])
    y, dx = run_fwd(), run_bwd()
    deterministic = torch.equal(y, run_fwd()) and torch.equal(dx, run_bwd())
    atol, rtol = BLOCK_CONV_TOL
    errs = {"fwd": [0.0, True], "bwd": [0.0, True]}
    chunk = max(1, (1 << 27) // max(y[0].numel(), x[0].numel()))
    for i in range(0, n, chunk):
        xd = x[i:i + chunk].double().requires_grad_(True)
        y_ref = (F.conv_transpose2d(xd, wt.double().transpose(0, 1), stride=2)
                 if up else F.conv2d(xd, wt.double(), padding=1))
        y_ref.backward(g[i:i + chunk].double())
        for key, got, want in (("fwd", y[i:i + chunk], y_ref.detach()),
                               ("bwd", dx[i:i + chunk], xd.grad)):
            err = (got.double() - want).abs()
            errs[key][0] = max(errs[key][0], float(err.max()))
            errs[key][1] &= bool((err <= atol * max(
                1.0, float(want.abs().max())) + rtol * want.abs()).all())
            del err
        del xd, y_ref
    del y, dx
    torch.cuda.empty_cache()
    case = {"kernel": "block_conv", "route": "sg2_up" if up else "sg2_3x3",
            "model": model, "layer": layer, "x_shape": list(x_shape),
            "w_shape": list(w_shape), "dtype": "float32", "design": "3xtf32",
            "tol": [atol, rtol],
            "fwd_splits": BC.kernel_splits(n, fwd_pack.shape[-1], h, w, cout,
                                           3, routes[0]),
            "bwd_splits": BC.kernel_splits(n, bwd_pack.shape[-1], h, w, cin,
                                           3, routes[1]),
            "fwd_max_abs_err": errs["fwd"][0], "bwd_max_abs_err": errs["bwd"][0],
            "deterministic": deterministic}
    case["ok"] = errs["fwd"][1] and errs["bwd"][1] and deterministic
    if up:
        wT = wt.transpose(0, 1)
        cudnn_fwd = lambda: F.conv_transpose2d(x, wT, stride=2)
        cudnn_bwd = lambda: torch.ops.aten.convolution_backward(
            g, x, wT, None, [2, 2], [0, 0], [1, 1], True, [0, 0], 1,
            [True, False, False])
    else:
        cudnn_fwd = lambda: F.conv2d(x, wt, padding=1)
        cudnn_bwd = lambda: torch.ops.aten.convolution_backward(
            g, x, wt, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, False, False])
    _time_conv_case(case, (run_fwd, run_bwd), (cudnn_fwd, cudnn_bwd),
                    conv_ops(n, cin, cout, 3, h, w),
                    4 * (x.numel() + wt.numel() + g.numel()))
    del x, g
    torch.cuda.empty_cache()
    return case


def phase_kernels():
    import torch
    t0 = time.perf_counter()
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(_attention_case(FLAGSHIP, dtype, timed=True))
        cases.append(_attention_case(RAGGED, dtype, timed=False))
        cases.append(_attention_case(BIGGAN128, dtype, timed=True))
        if dtype == torch.float32:
            cases.append(_attention_case(TRANSFORM_SEARCH, dtype, timed=True))
            cases.append(_attention_case(EDIT, dtype, timed=True))
        else:
            cases.append(_attention_case(BATCHED, dtype, timed=True))
            cases.append(_attention_case(TRANSFORM_BATCHED_SEARCH, dtype,
                                         timed=True))
        torch.cuda.empty_cache()
        cases.append(_fir_case(*FIR_PATH, dtype, timed=True))
        cases.append(_fir_case(*FIR_RAGGED, dtype, timed=False))
        torch.cuda.empty_cache()
        cases.append(_fir_levels(dtype, sg2_blur_levels()))
        torch.cuda.empty_cache()
        cases.append(_mod_case(MOD_PATH, dtype, timed=True))
        cases.append(_mod_case(MOD_RAGGED, dtype, timed=False))
        torch.cuda.empty_cache()
        cases.append(dict(_fir_case(*FIR_FFHQ, dtype, timed=True),
                          path="ffhq_path"))
        cases.append(_fir_levels(dtype, sg2_blur_levels(1024, FFHQ_CHUNK),
                                 "ffhq_fir_levels"))
        cases.append(dict(_mod_case(MOD_FFHQ, dtype, timed=True),
                          path="ffhq_path"))
        cases.append(_mod_levels(dtype))
        torch.cuda.empty_cache()
    for route, block, layer in BLOCK_CONV_TIMED:
        cases.append(_block_conv_case(route, block, layer))
        torch.cuda.empty_cache()
    for model, layer in SG2_CONV_TIMED:
        cases.append(_sg2_conv_case(model, layer))
    emit({"phase": "kernels",
          "kernels": ["sagan_attention_fwd", "sagan_attention_bwd",
                      "fir_blur_fwd", "fir_blur_bwd", "mod_backward",
                      "block_conv_fwd", "block_conv_bwd",
                      "block_conv_splitk_reduce_fwd",
                      "block_conv_splitk_reduce_bwd",
                      "block_conv_1x1_fwd", "block_conv_1x1_bwd",
                      "block_conv_sg2_3x3_fwd", "block_conv_sg2_3x3_bwd",
                      "block_conv_sg2_up_fwd", "block_conv_sg2_up_bwd"],
          "cases": cases, "seconds": time.perf_counter() - t0})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return cases


# the one-card memory recipe of examples/invert_stylegan2_ffhq_basincma.py:
# synthesis blocks from 256 px recomputed in the backward, the population
# in microbatches of 2
FFHQ_RECIPE = {"remat_from_res": 256, "max_batch_size": 2}


def _ramp_target(res):
    """``bench.py``'s target, [res, res, 3] in [-1, 1]: a ramp keeps both
    loss terms active."""
    import numpy as np
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / (res - 1)
    return np.stack([xx, yy, 0.5 * (xx + yy)], axis=-1) * 2.0 - 1.0


def _build_biggan(dtype, device, res=256, seed=0):
    """(model, loss_fn, var_manager) of ``main_path``'s problem: the ramp
    through BigGAN-deep-``res`` under ProjectionLoss (masked L1 + 10 x
    LPIPS-alex), z searched by CMA (Clamp hook at 2.0, lr 0.05), the class
    embedding c by Adam (lr 0.01); random weights from ``seed``."""
    import warnings

    import numpy as np

    import pix2latent_tpu_torch.loss_functions as LF
    from pix2latent_tpu_torch import VariableManager, distribution, hooks
    from pix2latent_tpu_torch.models.biggan import BigGAN

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # random-init notices
        model = BigGAN(f"biggan-deep-{res}", dtype=dtype, seed=seed,
                       device=device)
        loss_fn = LF.ProjectionLoss(lpips_net="alex", beta=10.0, dtype=dtype,
                                    device=device)
    vm = VariableManager(seed=seed, device=device)
    vm.register("z", shape=(128,), var_type="input", grad_free=True,
                distribution=distribution.TruncatedNormalModulo(
                    sigma=1.0, trunc=2.0),
                learning_rate=0.05, hook_fn=hooks.Clamp(2.0))
    vm.register("c", shape=(128,), var_type="input", learning_rate=0.01,
                default=np.zeros((128,), np.float32))
    vm.register("target", shape=(res, res, 3), var_type="output",
                requires_grad=False, default=_ramp_target(res))
    vm.register("weight", shape=(res, res, 3), var_type="output",
                requires_grad=False, default=np.ones((res, res, 3), np.float32))
    return model, loss_fn, vm


def _build_stylegan2(dtype, device, seed=0, model="cars", remat_from_res=0):
    """(model, loss_fn, var_manager) of the StyleGAN2 problem of ``model``
    (``"cars"``: 512 px with the border mask, ``"ffhq"``: 1024 px): the ramp
    under the same loss, z searched by CMA (Normalize + NormalPerturb(0.05)
    hook, lr 0.05), both hand-written StyleGAN2 kernels on, synthesis
    blocks from ``remat_from_res`` recomputed in the backward.

    The weights are random from ``seed`` with the ``equalized`` scheme of
    ``models/stylegan2.py:_random_init_``: under the JAX package's own
    random init the image does not depend on z, so the search could not
    lower the loss."""
    import warnings

    import numpy as np

    import pix2latent_tpu_torch.loss_functions as LF
    from pix2latent_tpu_torch import VariableManager, hooks
    from pix2latent_tpu_torch.examples.common import cars_loss_mask
    from pix2latent_tpu_torch.models.stylegan2 import StyleGAN2

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # random-init notices
        net = StyleGAN2(model, search="z", dtype=dtype, seed=seed,
                        fused_mod_bwd=True, fir_kernel=True,
                        remat_from_res=remat_from_res, init="equalized",
                        device=device)
        loss_fn = LF.ProjectionLoss(lpips_net="alex", beta=10.0, dtype=dtype,
                                    device=device)
    res = net.im_res
    vm = VariableManager(seed=seed, device=device)
    vm.register("z", shape=(512,), var_type="input", grad_free=True,
                learning_rate=0.05,
                hook_fn=hooks.Compose(hooks.Normalize(),
                                      hooks.NormalPerturb(0.05)))
    vm.register("target", shape=(res, res, 3), var_type="output",
                requires_grad=False, default=_ramp_target(res))
    vm.register("weight", shape=(res, res, 3), var_type="output",
                requires_grad=False, default=np.ones((res, res, 3), np.float32))
    mask = cars_loss_mask(res, model)
    if mask is not None:
        vm.register("loss_mask", shape=(res, res, 3), var_type="output",
                    requires_grad=False, default=mask)
    return net, loss_fn, vm


def _build_ffhq(dtype, device, seed=0):
    """(model, loss_fn, var_manager) of ``ffhq_path``'s problem, with the
    recipe's ``remat_from_res`` (its ``max_batch_size`` belongs to the
    optimizer)."""
    return _build_stylegan2(dtype, device, seed, model="ffhq",
                            remat_from_res=FFHQ_RECIPE["remat_from_res"])


def phase_main_path(generations, final_steps):
    import math

    import torch
    from pix2latent_tpu_torch.ops import attention as A
    from pix2latent_tpu_torch.ops import block_conv as BC
    from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer

    model, loss_fn, vm = _build_biggan(torch.bfloat16, "cuda")
    opt = BasinCMAOptimizer(model, vm, loss_fn, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    A.reset_launch_counts()
    BC.reset_launch_counts()
    t0 = time.perf_counter()
    variables, outs, final = opt.optimize(generations, GRAD_STEPS,
                                          last_grad_steps=final_steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = A.launch_counts()
    conv_counts = BC.launch_counts()

    out = opt.out
    tell_mins = opt.losses
    final_min = float(final[0][1]["loss"].min())
    expect = {"fwd": generations * (GRAD_STEPS + 1) + final_steps,
              "bwd": generations * GRAD_STEPS + final_steps}
    # in bfloat16 every GenBlock convolution stays on F.conv2d (cuDNN)
    expect_conv = dict(dict.fromkeys(BC.launch_counts(), 0),
                       plain=4 * len(model.generator.layers) * expect["fwd"])
    steady = opt.gen_seconds[1:] or opt.gen_seconds
    gen_s = statistics.mean(steady)
    result = {
        "phase": "main_path", "model": "biggan-deep-256", "channel_width": 128,
        "dtype": "bfloat16", "population": opt.num_samples,
        "grad_steps": GRAD_STEPS, "generations": generations,
        "final_steps": final_steps,
        "shortened": ("no" if (generations, final_steps) == (30, 300) else
                      f"{generations} of 30 generations, {final_steps} of "
                      "300 final Adam steps"),
        "seconds": seconds, "gen_seconds": opt.gen_seconds,
        "seconds_per_generation": gen_s,
        "images_per_sec": opt.num_samples * GRAD_STEPS / gen_s,
        "tell_min_per_generation": tell_mins, "final_min_loss": final_min,
        "out_shape": list(out.shape), "collage_shape": list(outs[0].shape),
        "attention_launches": counts, "expected_launches": expect,
        "block_conv_calls": conv_counts, "expected_block_conv_calls": expect_conv,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(result)
    assert opt.num_samples == POP, opt.num_samples
    assert tuple(out.shape) == (POP, 256, 256, 3), out.shape
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert conv_counts == expect_conv, (conv_counts, expect_conv)
    assert math.isfinite(final_min) and final_min < tell_mins[0], (
        f"no convergence: first generation {tell_mins[0]}, final {final_min}")
    assert counts == expect, (counts, expect)
    assert counts["fwd"] > 0 and counts["bwd"] > 0
    return counts, result["images_per_sec"]


def _whole_step(phase, builder, inputs):
    """One float32 generator + loss forward and backward at population 2,
    on the card and on the CPU: relative errors of the per-sample losses
    and of the input gradients must be <= 1e-3."""
    import torch
    from pix2latent_tpu_torch.core.step import ExecutionCore

    def step(device):
        model, loss_fn, vm = builder(torch.float32, device)
        core = ExecutionCore(model, vm, loss_fn)
        variables = vm.initialize(2)
        variables["input"] = {name: t.to(device).requires_grad_(True)
                              for name, t in inputs.items()}
        variables = core._dedupe_outputs(variables)
        loss, per_sample, out = core._forward_loss(variables,
                                                   core.make_ctx(variables))
        loss.backward()
        return [per_sample.detach().cpu().double()] + [
            variables["input"][name].grad.cpu().double() for name in inputs]

    tol = 1e-3
    t0 = time.perf_counter()
    card, cpu = step("cuda"), step("cpu")
    names = ["loss"] + [f"d{name}" for name in inputs]
    rel = {name: float((a - b).norm() / b.norm().clamp_min(1e-30))
           for name, a, b in zip(names, card, cpu)}
    result = {"phase": phase, "dtype": "float32", "population": 2,
              "rel_err": rel, "tolerance": tol, "loss": card[0].tolist(),
              "grad_norms": {name: float(t.norm())
                             for name, t in zip(names[1:], card[1:])},
              "seconds": time.perf_counter() - t0}
    emit(result)
    assert all(v <= tol for v in rel.values()), rel


def phase_whole_step():
    import torch

    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    z = torch.fmod(torch.randn(2, 128, generator=gen), 2.0)
    c = 0.1 * torch.randn(2, 128, generator=gen)
    _whole_step("whole_step", _build_biggan, {"z": z, "c": c})


def phase_sg2_path(generations, final_steps):
    import math

    import torch
    from pix2latent_tpu_torch.ops import fir_blur as FB
    from pix2latent_tpu_torch.ops import mod_backward as MB
    from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer

    model, loss_fn, vm = _build_stylegan2(torch.bfloat16, "cuda")
    opt = BasinCMAOptimizer(model, vm, loss_fn, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FB.reset_launch_counts()
    MB.reset_launch_counts()
    t0 = time.perf_counter()
    variables, outs, final = opt.optimize(generations, GRAD_STEPS,
                                          last_grad_steps=final_steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"fir_blur_fwd": FB.launch_counts()["fwd"],
              "fir_blur_bwd": FB.launch_counts()["bwd"],
              "mod_backward": MB.launch_counts()["bwd"]}

    # 7 up-path blurs per forward and per backward (one per resolution
    # 8..512); 23 modulated convs per backward (conv1, to_rgb1 and three per
    # resolution); a tell forward blurs but runs no backward
    forwards = generations * (GRAD_STEPS + 1) + final_steps
    backwards = generations * GRAD_STEPS + final_steps
    expect = {"fir_blur_fwd": 7 * forwards, "fir_blur_bwd": 7 * backwards,
              "mod_backward": 23 * backwards}
    out = opt.out
    tell_mins = opt.losses
    final_min = float(final[0][1]["loss"].min())
    steady = opt.gen_seconds[1:] or opt.gen_seconds
    gen_s = statistics.mean(steady)
    result = {
        "phase": "sg2_path", "model": "stylegan2-cars-512",
        "channel_multiplier": 2, "dtype": "bfloat16",
        "population": opt.num_samples, "grad_steps": GRAD_STEPS,
        "generations": generations, "final_steps": final_steps,
        "shortened": ("no" if (generations, final_steps) == (30, 300) else
                      f"{generations} of 30 generations, {final_steps} of "
                      "300 final Adam steps"),
        "seconds": seconds, "gen_seconds": opt.gen_seconds,
        "seconds_per_generation": gen_s,
        "images_per_sec": opt.num_samples * GRAD_STEPS / gen_s,
        "tell_min_per_generation": tell_mins, "final_min_loss": final_min,
        "out_shape": list(out.shape), "collage_shape": list(outs[0].shape),
        "launches": counts, "expected_launches": expect,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(result)
    assert opt.num_samples == SG2_POP, opt.num_samples
    assert tuple(out.shape) == (SG2_POP, 512, 512, 3), out.shape
    assert bool(torch.isfinite(out).all())
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert math.isfinite(final_min) and final_min < tell_mins[0], (
        f"no convergence: first generation {tell_mins[0]}, final {final_min}")
    assert counts == expect, (counts, expect)
    assert all(v > 0 for v in counts.values()), counts
    return counts


def phase_sg2_whole_step():
    import torch

    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    _whole_step("sg2_whole_step", _build_stylegan2,
                {"z": torch.randn(2, 512, generator=gen)})


def ffhq_expected_launches(generations, final_steps, chunks,
                           steps=GRAD_STEPS):
    """K2 and K3 launches of ``ffhq_path`` (generations of ``steps`` inner
    steps), counted from the code: a step,
    a tell and a final step run the population in ``chunks`` microbatches.
    Per chunk, a forward blurs once per up-conv (8 levels, r = 8 .. 1024);
    a backward runs the 8 adjoint blurs, recomputes the forward of the
    blocks from 256 px (``remat_from_res``), whose up-convs blur again (r =
    256, 512, 1024: 3 forward launches), and runs one modulation backward
    per modulated conv: 26 (conv1, to_rgb1, and at each of the 8 levels the
    up-conv, the conv and to_rgb). A tell forward runs without gradients:
    no recompute, no backward."""
    backwards = chunks * (generations * steps + final_steps)
    forwards = chunks * (generations * (steps + 1) + final_steps)
    return {"fir_blur_fwd": 8 * forwards + 3 * backwards,
            "fir_blur_bwd": 8 * backwards, "mod_backward": 26 * backwards}


def _kernel_counts():
    from pix2latent_tpu_torch.ops import fir_blur as FB
    from pix2latent_tpu_torch.ops import mod_backward as MB
    return {"fir_blur_fwd": FB.launch_counts()["fwd"],
            "fir_blur_bwd": FB.launch_counts()["bwd"],
            "mod_backward": MB.launch_counts()["bwd"]}


def _sync_site():
    """Where a host sync was asked for: the innermost frame in this
    repository's package, as ``file:line``; the innermost frame of all,
    with its source line; and whether it was inside a fused generation
    (the ``generation`` of ``optimizers/cma_base.py``,
    ``optimizers/batched.py`` or ``transform/transform_optimizer.py``)."""
    import linecache
    import traceback

    stack = [f for f in traceback.extract_stack()      # not this script's
             if not f.filename.endswith(("warnings.py", "chip_smoke.py"))]
    ours = [f for f in stack if "pix2latent_tpu_torch" in f.filename]
    site = ours[-1] if ours else stack[-1]
    last = stack[-1]
    in_generation = any(
        f.name == "generation"
        and f.filename.endswith(("cma_base.py", "transform_optimizer.py",
                                 "batched.py"))
        for f in ours)
    return (f"{Path(site.filename).name}:{site.lineno}",
            f"{last.filename}:{last.lineno}: "
            f"{linecache.getline(last.filename, last.lineno).strip()}",
            in_generation)


def _eigh_site():
    """``cma.py:<line>`` of the CMA tell's ``eigh``, the one host sync a
    fused generation may make."""
    from pix2latent_tpu_torch.strategies import cma
    return "cma.py:{}".format(next(
        i + 1 for i, line in enumerate(
            Path(cma.__file__).read_text().splitlines())
        if "torch.linalg.eigh(C)" in line))


class _RecordSyncs:
    """A block run with ``torch.cuda``'s sync debug mode on: each host sync
    made in it goes to ``self.sites`` as :func:`_sync_site` gives it."""

    def __enter__(self):
        import warnings

        import torch
        self.sites = []
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("always")

        def hook(message, *args, **kwargs):
            if "called a synchronizing CUDA operation" in str(message):
                self.sites.append(_sync_site())
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode("default")
        self._warnings.__exit__(*exc)
        return False

    def count(self, in_generation):
        """{site: number of syncs there}, inside the fused generations or
        outside them."""
        sites = [s for s, _, g in self.sites if g == in_generation]
        return {site: sites.count(site) for site in sorted(set(sites))}


def phase_ffhq_path(generations, final_steps):
    import math
    import tempfile

    import torch
    from pix2latent_tpu_torch.ops import fir_blur as FB
    from pix2latent_tpu_torch.ops import mod_backward as MB
    from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer

    def make_opt():
        model, loss_fn, vm = _build_ffhq(torch.bfloat16, "cuda")
        opt = BasinCMAOptimizer(model, vm, loss_fn, seed=0, device="cuda",
                                max_batch_size=FFHQ_RECIPE["max_batch_size"])
        return model, opt

    model, opt = make_opt()
    chunks = -(-SG2_POP // FFHQ_RECIPE["max_batch_size"])
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "ffhq.npz")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FB.reset_launch_counts()
        MB.reset_launch_counts()
        t0 = time.perf_counter()
        with _RecordSyncs() as syncs:
            variables, outs, final = opt.optimize_fused(
                generations, GRAD_STEPS, last_grad_steps=final_steps,
                checkpoint_path=ckpt)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _kernel_counts()
        peak = torch.cuda.max_memory_allocated()
        first_state, first_z = opt.cma_state, variables["input"]["z"].detach()

        # resume: the meta loop and the final run are finished on disk
        _, opt2 = make_opt()
        FB.reset_launch_counts()
        MB.reset_launch_counts()
        t1 = time.perf_counter()
        variables2, _, final2 = opt2.optimize_fused(
            generations, GRAD_STEPS, last_grad_steps=final_steps,
            checkpoint_path=ckpt)
        torch.cuda.synchronize()
        resume = {"seconds": time.perf_counter() - t1,
                  "generations_run": len(opt2.gen_seconds),
                  "launches": _kernel_counts(),
                  "cma_state_equal": all(
                      torch.equal(a, b) for a, b in zip(opt2.cma_state,
                                                        first_state)),
                  "variables_equal": torch.equal(
                      variables2["input"]["z"].detach(), first_z),
                  "final_min_loss": float(final2[0][1]["loss"].min())}

    out = opt.out
    tell_mins = opt.losses
    final_min = float(final[0][1]["loss"].min())
    steady = opt.gen_seconds[1:] or opt.gen_seconds
    gen_s = statistics.mean(steady)
    expect = ffhq_expected_launches(generations, final_steps, chunks)
    g = model.generator
    sync_sites = syncs.count(in_generation=True)
    eigh_site = _eigh_site()
    result = {
        "phase": "ffhq_path", "model": "stylegan2-ffhq-1024",
        "channel_multiplier": 2, "w_layers": g.num_layers + 1,
        "noise_maps": g.num_layers, "dtype": "bfloat16",
        "population": opt.num_samples, "grad_steps": GRAD_STEPS,
        "remat_from_res": g.remat_from_res,
        "max_batch_size": opt.max_batch_size, "chunks_per_step": chunks,
        "driver": "optimize_fused", "generations": generations,
        "final_steps": final_steps,
        "schedule": (f"{generations} generations x {GRAD_STEPS} steps + "
                     f"{final_steps} final steps (the example: 30 x 30 + "
                     "300)"),
        "seconds": seconds, "gen_seconds": opt.gen_seconds,
        "seconds_per_generation": gen_s,
        "images_per_sec": opt.num_samples * GRAD_STEPS / gen_s,
        "tell_min_per_generation": tell_mins, "final_min_loss": final_min,
        "out_shape": list(out.shape), "collage_shape": list(outs[0].shape),
        "launches": counts, "expected_launches": expect,
        "syncs_in_fused_generations": sync_sites,
        "syncs_outside_generations": syncs.count(in_generation=False),
        "sync_frames": sorted({frame for _, frame, _ in syncs.sites}),
        "peak_memory_bytes": peak, "resume": resume}
    emit(result)
    assert opt.num_samples == SG2_POP, opt.num_samples
    assert bool(torch.isfinite(out).all())
    assert len(tell_mins) == generations, tell_mins
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert math.isfinite(final_min) and final_min < tell_mins[0], (
        f"no convergence: first generation {tell_mins[0]}, final {final_min}")
    assert counts == expect, (counts, expect)
    assert all(v > 0 for v in counts.values()), counts
    assert resume["generations_run"] == 0
    assert resume["launches"] == {"fir_blur_fwd": 8 * chunks,
                                  "fir_blur_bwd": 0, "mod_backward": 0}
    assert resume["cma_state_equal"] and resume["variables_equal"], resume
    assert math.isfinite(resume["final_min_loss"])
    # one eigh sync per generation, and no other sync
    assert sync_sites == {eigh_site: generations}, sync_sites
    assert (g.im_res, g.num_layers, g.remat_from_res, opt.max_batch_size) \
        == (1024, 17, 256, 2)
    assert tuple(out.shape) == (SG2_POP, 1024, 1024, 3), out.shape
    return counts


def phase_ffhq_whole_step():
    import torch

    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    _whole_step("ffhq_whole_step", _build_ffhq,
                {"z": torch.randn(2, 512, generator=gen)})


def phase_biggan_f32_path(generations, final_steps, cases, save_dir):
    """The BigGAN BasinCMA entry point's problem in float32, so K1 takes its
    float32 route; see the module docstring. The results go to
    ``save_dir`` through the entry point's ``finish``, beside the weights
    (``weights.npz``) and the best sample rendered with the population
    (``best_render.npy``), for ``edit_path``."""
    import math

    import numpy as np
    import torch
    from pix2latent_tpu_torch import VariableManager
    from pix2latent_tpu_torch.examples import common
    from pix2latent_tpu_torch.examples import invert_biggan_basincma as ex
    from pix2latent_tpu_torch.ops import attention as A
    from pix2latent_tpu_torch.ops import block_conv as BC
    from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer
    from pix2latent_tpu_torch.utils.params_io import (save_params_npz,
                                                      to_jax_params)

    args = ex.parser().parse_args(["--device", "cuda", "--save_dir",
                                   str(save_dir)])
    args.grad_free = True
    model = common.load_biggan(args)
    target, weight = common.load_target(args, model)
    vm = common.register_biggan_vars(VariableManager(device="cuda"), model,
                                     args, target, weight)
    opt = BasinCMAOptimizer(model, vm, common.make_loss(args),
                            max_batch_size=args.max_minibatch, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    BC.reset_launch_counts()
    t0 = time.perf_counter()
    variables, outs, final = opt.optimize(generations, GRAD_STEPS,
                                          last_grad_steps=final_steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = A.launch_counts()
    conv_counts = BC.launch_counts()

    full = ex.schedule(argparse.Namespace(smoke=False))
    out = opt.out
    tell_mins = opt.losses
    final_min = float(final[0][1]["loss"].min())
    expect = {"fwd": generations * (GRAD_STEPS + 1) + final_steps,
              "bwd": generations * GRAD_STEPS + final_steps}
    # every GenBlock convolution on the block convolution kernel: four a
    # block a forward and a backward, none on F.conv2d
    blocks = 4 * len(model.generator.layers)
    expect_conv = dict(dict.fromkeys(BC.launch_counts(), 0),
                       fwd=blocks * expect["fwd"], bwd=blocks * expect["bwd"])
    steady = opt.gen_seconds[1:] or opt.gen_seconds
    gen_s = statistics.mean(steady)
    # K1's float32 forward + backward at this shape, from the kernels phase,
    # against the seconds of an inner step (a generation's 30 steps and its
    # tell)
    k1 = next(c for c in cases if c["kernel"] == "sagan_attention"
              and c["dtype"] == "float32" and tuple(c["shape"]) == FLAGSHIP)
    step_ms = 1e3 * gen_s / GRAD_STEPS
    result = {
        "phase": "biggan_f32_path", "model": "biggan-deep-256",
        "entry_point": "pix2latent_tpu_torch/examples/invert_biggan_basincma.py",
        "channel_width": model.generator.ch, "dtype": "float32",
        "population": opt.num_samples, "grad_steps": GRAD_STEPS,
        "generations": generations, "final_steps": final_steps,
        "shortened": ("no" if (generations, GRAD_STEPS, final_steps) == full
                      else f"{generations} of {full[0]} generations, "
                      f"{final_steps} of {full[2]} final Adam steps"),
        "seconds": seconds, "gen_seconds": opt.gen_seconds,
        "seconds_per_generation": gen_s,
        "images_per_sec": opt.num_samples * GRAD_STEPS / gen_s,
        "step_ms": step_ms,
        "k1_f32_ms_per_step": k1["fwd_ms"] + k1["bwd_ms"],
        "k1_share_of_step": (k1["fwd_ms"] + k1["bwd_ms"]) / step_ms,
        "tell_min_per_generation": tell_mins, "final_min_loss": final_min,
        "out_shape": list(out.shape), "collage_shape": list(outs[0].shape),
        "attention_launches": counts, "expected_launches": expect,
        "block_conv_calls": conv_counts, "expected_block_conv_calls": expect_conv,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(result)
    assert opt.num_samples == POP, opt.num_samples
    assert model.generator.ch == 128 and model.generator.dtype == torch.float32
    assert tuple(out.shape) == (POP, 256, 256, 3), out.shape
    assert bool(torch.isfinite(out).all())
    assert len(tell_mins) == generations, tell_mins
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert math.isfinite(final_min) and final_min < tell_mins[0], (
        f"no convergence: first generation {tell_mins[0]}, final {final_min}")
    assert counts == expect, (counts, expect)
    assert counts["fwd"] > 0 and counts["bwd"] > 0
    assert conv_counts == expect_conv, (conv_counts, expect_conv)

    common.finish(args, opt, variables, outs, final, str(save_dir))
    save_params_npz(str(Path(save_dir) / "weights.npz"), to_jax_params(model))
    best = int(np.argmin(np.asarray(final[-1][1]["loss"]).reshape(-1)))
    with torch.no_grad():
        render = model(variables["input"]["z"], variables["input"]["c"])
    np.save(Path(save_dir) / "best_render.npy", render[best].cpu().numpy())
    return counts, conv_counts


def transform_expected_launches():
    """K1's float32 launches of ``transform_path``'s two phases, counted
    from the code. The search (``optimize_fused``): every generation, the
    last too, runs 10 inner steps (a forward and a backward each) and one
    tell forward, and the results bundle re-renders the final population
    (one forward). The latent search (``BasinCMAOptimizer.optimize``): 10
    inner steps and a tell a generation, then the final steps. No
    microbatches: one launch per forward or backward."""
    generations = TRANSFORM_SEARCH_GENS
    latent_generations, latent_final_steps = TRANSFORM_LATENT
    search = {"fwd": generations * (TRANSFORM_STEPS + 1) + 1,
              "bwd": generations * TRANSFORM_STEPS}
    latent = {"fwd": latent_generations * (TRANSFORM_STEPS + 1)
              + latent_final_steps,
              "bwd": latent_generations * TRANSFORM_STEPS
              + latent_final_steps}
    return search, latent


def _pre_align_case(ex, args):
    """The entry point's ``--mask_fp`` alignment through the API, on the
    card: a synthetic mask's box against BigGAN's object prior."""
    import torch
    from pix2latent_tpu_torch import VariableManager

    mask = torch.zeros(256, 256, 3, device="cuda")
    mask[48:176, 80:240] = 1.0
    target_tf, _ = ex.build_transforms(VariableManager(device="cuda"), args,
                                       mask=mask)
    t = target_tf.get_default_param()
    # rows 48..175 and columns 80..239: centers (48 + 127 // 2, 80 + 159 //
    # 2), sizes (127, 159) of 256; the prior's center (137, 127) / 255 and
    # size (213, 210) / 255; scale by the larger side
    s = (159 / 256) / (210 / 255)
    want = [s, 2 * (159 / 256 - 127 / 255), 2 * (111 / 256 - 137 / 255)]
    err = max(abs(a - b) for a, b in zip(t.tolist(), want))
    return {"t": t.tolist(), "expected": want, "max_abs_err": err,
            "device": str(t.device), "ok": err < 1e-6
            and t.device.type == "cuda"}


def phase_transform_path():
    """The BigGAN transform entry point's two phases in float32 on a
    misaligned self-target, at the schedules ``TRANSFORM_SEARCH_GENS`` and
    ``TRANSFORM_LATENT``; see the module docstring."""
    import math
    import tempfile

    import numpy as np
    import torch
    from pix2latent_tpu_torch import VariableManager
    from pix2latent_tpu_torch.examples import common
    from pix2latent_tpu_torch.examples import \
        invert_biggan_with_transform as ex
    from pix2latent_tpu_torch.ops import attention as A
    from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer
    from pix2latent_tpu_torch.transform import (SpatialTransform,
                                                TransformBasinCMAOptimizer)

    generations = TRANSFORM_SEARCH_GENS
    p2_generations, p2_final_steps = TRANSFORM_LATENT
    t_start = time.perf_counter()
    args = ex.parser().parse_args(["--device", "cuda"])
    args.grad_free = False
    model = common.load_biggan(args)
    aligned, _ = common.load_target(args, model)
    t_star = torch.tensor([T_STAR], device="cuda")
    target = SpatialTransform(device="cuda").transform(aligned[None],
                                                       t_star)[0]
    weight = torch.ones_like(target)

    def make_search():
        vm = common.register_biggan_vars(VariableManager(device="cuda"),
                                         model, args, target, weight)
        transforms = ex.build_transforms(vm, args)
        opt = TransformBasinCMAOptimizer(model, vm, common.make_loss(args),
                                         max_batch_size=args.max_minibatch,
                                         device="cuda")
        opt.register_transform(transforms[0], "t", "target")
        opt.register_transform(transforms[1], "t", "weight")
        opt.set_variable_propagation("z")
        return vm, transforms, opt

    vm, (target_tf, weight_tf), opt = make_search()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "search.npz")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        with _RecordSyncs() as syncs:
            opt.optimize_fused(generations, TRANSFORM_STEPS,
                               checkpoint_path=ckpt)
        torch.cuda.synchronize()
        search_seconds = time.perf_counter() - t0
        search_counts = A.launch_counts()
        search_peak = torch.cuda.max_memory_allocated()

        # resume: the whole search is on disk
        _, _, opt2 = make_search()
        A.reset_launch_counts()
        t1 = time.perf_counter()
        opt2.optimize_fused(generations, TRANSFORM_STEPS,
                            checkpoint_path=ckpt)
        torch.cuda.synchronize()
        resume = {"seconds": time.perf_counter() - t1,
                  "tell_generations_run": len(opt2.gen_seconds) - 1,
                  "launches": A.launch_counts(),
                  "candidate_equal": bool(np.array_equal(
                      opt2.get_candidate(), opt.get_candidate())),
                  "best_loss_equal": opt2._best_loss == opt._best_loss,
                  "cma_state_equal": all(
                      torch.equal(a, b) for a, b in zip(opt2.cma_state,
                                                        opt.cma_state))}

    candidate = opt.get_candidate()
    s0 = target_tf.get_default_param(as_tensor=False)
    effective = (s0 + target_tf.sensitivity * candidate).tolist()
    tell_mins = opt.losses
    steady = opt.gen_seconds[1:] or opt.gen_seconds
    search_gen_s = statistics.mean(steady)
    eigh_site = _eigh_site()
    in_gen = syncs.count(in_generation=True)
    frame_gap = float(np.abs(opt.final_tell - opt.loss).max()
                      / max(np.abs(opt.loss).max(), 1e-30))

    # phase 2: t frozen at the candidate, z by BasinCMA, both transforms
    vm.edit_variable("t", {"default": candidate, "grad_free": False})
    vm.edit_variable("z", {"learning_rate": args.lr, "grad_free": True})
    opt_b = BasinCMAOptimizer(model, vm, common.make_loss(args),
                              max_batch_size=args.max_minibatch,
                              device="cuda")
    opt_b.register_transform(target_tf, "t", "target")
    opt_b.register_transform(weight_tf, "t", "weight")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    t2 = time.perf_counter()
    variables, outs, final = opt_b.optimize(
        p2_generations, TRANSFORM_STEPS, last_grad_steps=p2_final_steps)
    torch.cuda.synchronize()
    latent_seconds = time.perf_counter() - t2
    latent_counts = A.launch_counts()
    latent_peak = torch.cuda.max_memory_allocated()
    latent_gen_s = statistics.mean(opt_b.gen_seconds[1:]
                                   or opt_b.gen_seconds)
    final_min = float(final[0][1]["loss"].min())
    out = opt_b.out
    pre_align = _pre_align_case(ex, args)

    expect_search, expect_latent = transform_expected_launches()
    result = {
        "phase": "transform_path", "model": "biggan-deep-256",
        "entry_point": ("pix2latent_tpu_torch/examples/"
                        "invert_biggan_with_transform.py"),
        "channel_width": model.generator.ch, "dtype": "float32",
        "t_star": list(T_STAR),
        "schedule": (f"search {generations} x {TRANSFORM_STEPS} (the "
                     f"example: 50 x 10); latent {p2_generations} x "
                     f"{TRANSFORM_STEPS} + {p2_final_steps} (the example's "
                     "basincma: 30 x 30 + 300)"),
        "search": {
            "driver": "TransformBasinCMAOptimizer.optimize_fused",
            "population": opt.num_samples, "seconds": search_seconds,
            "gen_seconds": opt.gen_seconds,
            "seconds_per_generation": search_gen_s,
            "images_per_sec": opt.num_samples * TRANSFORM_STEPS
            / search_gen_s,
            "tell_min_per_generation": tell_mins,
            "final_tell": opt.final_tell.tolist(),
            "final_inner_loss": opt.loss.tolist(),
            "frames_rel_gap": frame_gap,
            "candidate": candidate.tolist(), "effective_t": effective,
            "t_star_inverse": [1 / T_STAR[0], -T_STAR[1] / T_STAR[0],
                               -T_STAR[2] / T_STAR[0]],
            "launches": search_counts, "expected_launches": expect_search,
            "syncs_in_fused_generations": in_gen,
            "syncs_outside_generations": syncs.count(in_generation=False),
            "peak_memory_bytes": search_peak, "resume": resume},
        "latent": {
            "driver": "BasinCMAOptimizer.optimize",
            "population": opt_b.num_samples, "seconds": latent_seconds,
            "gen_seconds": opt_b.gen_seconds,
            "seconds_per_generation": latent_gen_s,
            "images_per_sec": opt_b.num_samples * TRANSFORM_STEPS
            / latent_gen_s,
            "tell_min_per_generation": opt_b.losses,
            "final_min_loss": final_min,
            "out_shape": list(out.shape),
            "collage_shape": list(outs[0].shape),
            "launches": latent_counts, "expected_launches": expect_latent,
            "peak_memory_bytes": latent_peak},
        "pre_align": pre_align,
        "seconds": time.perf_counter() - t_start}
    emit(result)
    assert model.generator.ch == 128 and model.generator.dtype == torch.float32
    assert opt.num_samples == 7 and opt_b.num_samples == POP
    assert len(tell_mins) == generations, tell_mins
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert tell_mins[-1] < tell_mins[0], (
        f"no progress: generation 0 {tell_mins[0]}, last {tell_mins[-1]}")
    assert frame_gap > 1e-3, ("the un-warped tell equals the warped-frame "
                              "loss", frame_gap)
    assert search_counts == expect_search, (search_counts, expect_search)
    assert latent_counts == expect_latent, (latent_counts, expect_latent)
    # one eigh sync in each generation that tells, and no other sync
    assert in_gen == {eigh_site: generations - 1}, in_gen
    assert resume["tell_generations_run"] == 0, resume
    assert resume["launches"] == {"fwd": 3, "bwd": 0}, resume
    assert resume["candidate_equal"] and resume["best_loss_equal"] \
        and resume["cma_state_equal"], resume
    assert len(opt_b.losses) == p2_generations
    assert all(math.isfinite(v) for v in opt_b.losses), opt_b.losses
    assert math.isfinite(final_min)
    assert tuple(out.shape) == (POP, 256, 256, 3), out.shape
    assert bool(torch.isfinite(out).all())
    assert pre_align["ok"], pre_align
    return search_counts, latent_counts


def phase_transform_whole_step():
    """One generation of the composed search (spatial + hue + brightness)
    with injected Δt, z and c at population 2, full width, float32, on the
    card and on the CPU: the warped targets and weights, one inner step's
    losses and gradients, and the un-warped tell after the Adam update must
    agree within rel 1e-3."""
    import torch
    from pix2latent_tpu_torch import VariableManager
    from pix2latent_tpu_torch.core.step import ExecutionCore
    from pix2latent_tpu_torch.examples import common
    from pix2latent_tpu_torch.examples import \
        invert_biggan_with_transform as ex

    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    z = torch.fmod(torch.randn(2, 128, generator=gen), 2.0)
    z_target = torch.fmod(torch.randn(1, 128, generator=gen), 2.0)
    dc = 0.1 * torch.randn(2, 128, generator=gen)
    dt = 0.5 * torch.randn(2, 5, generator=gen)

    def step(device):
        args = ex.parser().parse_args(
            ["--device", device, "--color_transform", "hue,brightness"])
        model = common.load_biggan(args)
        c = model.get_class_embedding(args.class_lbl)
        with torch.no_grad():
            target = model(z_target.to(device), c)[0]
        vm = common.register_biggan_vars(VariableManager(device=device),
                                         model, args, target,
                                         torch.ones_like(target))
        target_tf, weight_tf = ex.build_transforms(vm, args)
        core = ExecutionCore(model, vm, common.make_loss(args))
        core.register_transform(target_tf, "t", "target")
        core.register_transform(weight_tf, "t", "weight")
        variables = vm.initialize(2)
        variables["input"]["z"] = z.to(device)
        variables["input"]["c"] = c + dc.to(device)
        variables["transform"]["t"] = (
            target_tf.get_search_identity(as_tensor=True) + dt.to(device))
        variables = core._dedupe_outputs(core.apply_transforms(variables))
        warped = [variables["output"][k].detach().cpu().double()
                  for k in ("target", "weight")]
        ctx = core.make_ctx(variables)
        variables, optimizer = core.init_opt_state(variables)
        optimizer.zero_grad()
        loss, _ = core._forward_backward(variables, ctx)
        grads = [variables["input"][k].grad.cpu().double()
                 for k in ("z", "c")]
        optimizer.step()
        tell = core.tell_loss(variables, vm.generator, 1, ctx=ctx)
        return warped + [loss.cpu().double()] + grads + [tell.cpu().double()]

    tol = 1e-3
    t0 = time.perf_counter()
    card, cpu = step("cuda"), step("cpu")
    names = ["warped_target", "warped_weight", "loss", "dz", "dc", "tell"]
    rel = {name: float((a - b).norm() / b.norm().clamp_min(1e-30))
           for name, a, b in zip(names, card, cpu)}
    result = {"phase": "transform_whole_step", "dtype": "float32",
              "population": 2, "transforms": "spatial + hue + brightness",
              "rel_err": rel, "tolerance": tol, "loss": card[2].tolist(),
              "tell": card[5].tolist(),
              "seconds": time.perf_counter() - t0}
    emit(result)
    assert all(v <= tol for v in rel.values()), rel
    assert not torch.allclose(card[2], card[5], rtol=1e-2)


def _hf_biggan_state_dict(model, seed):
    """The weights of the port's ``model`` (a BigGAN-deep) as a
    ``pytorch_pretrained_biggan`` state dict, made here with numpy: HF's
    names (blocks and the attention layer in ``generator.layers.<i>``,
    ``generator.bn``, ``embeddings.weight``), every generator conv and
    linear under spectral norm as ``weight_orig`` and ``weight_u``. Each
    ``u`` is the direction of ``W W^T``'s top eigenvector from one power
    step on a random vector, scaled so that the converter's baked sigma is
    a factor ``s`` in [0.9, 1.1]: the baked weight is ``weight_orig / s``.
    Returns ``(state dict, {port name: s})``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    attn = model.generator.attn_pos
    sd, scales = {}, {}
    for name, p in model.state_dict().items():
        w = p.detach().cpu().numpy().astype(np.float32)
        parts = name.split(".")
        if parts[0] == "embeddings":
            sd["embeddings.weight"] = torch.tensor(w)
            continue
        head = parts[1]
        if head.startswith("block_"):
            i = int(head.split("_")[1])
            key = ".".join([f"generator.layers.{i + (i >= attn)}",
                            *parts[2:]])
        elif head.startswith("attn_"):
            conv = {"theta": "snconv1x1_theta", "phi": "snconv1x1_phi",
                    "g": "snconv1x1_g", "o_conv": "snconv1x1_o_conv"}
            rest = [conv.get(parts[2], parts[2]), *parts[3:]]
            key = ".".join([f"generator.layers.{attn}", *rest])
        elif head == "bn_out":
            key = ".".join(["generator.bn", *parts[2:]])
        else:
            key = name
        if key.endswith(".weight") and w.ndim >= 2:
            s = rng.uniform(0.9, 1.1)
            w_mat = w.reshape(w.shape[0], -1)
            u = w_mat @ (w_mat.T @ rng.randn(w.shape[0]).astype(np.float32))
            # the converter's sigma is ||W^T u||: make it s
            u = u * (s / np.linalg.norm(w_mat.T @ u))
            sd[key[:-len("weight")] + "weight_orig"] = torch.tensor(w)
            sd[key[:-len("weight")] + "weight_u"] = torch.tensor(
                u.astype(np.float32))
            scales[name] = s
        else:
            sd[key] = torch.tensor(w)
    return sd, scales


def phase_real_input_path(generations, final_steps):
    """The BigGAN entry point on files it reads, in float32; see the module
    docstring."""
    import math
    import tempfile

    import numpy as np
    import torch
    from pix2latent_tpu_torch import native
    from pix2latent_tpu_torch.examples import \
        invert_biggan_basincma as ex
    from pix2latent_tpu_torch.models.biggan import BigGAN
    from pix2latent_tpu_torch.scripts import convert
    from pix2latent_tpu_torch.utils import image, png

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the weights: a torch checkpoint of the full-width model, converted
        # by the CLI, loaded from both files
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = BigGAN("biggan-deep-256", seed=0, device="cpu")
        sd, scales = _hf_biggan_state_dict(ref, seed=1)
        torch.save(sd, tmp / "biggan.pth")
        del sd
        t0 = time.perf_counter()
        report = convert.main(["biggan", str(tmp / "biggan.pth"),
                               str(tmp / "biggan.npz")])
        convert_s = time.perf_counter() - t0
        from_pth = BigGAN("biggan-deep-256",
                          pretrained_path=str(tmp / "biggan.pth"),
                          device="cpu").state_dict()
        model = BigGAN("biggan-deep-256",
                       pretrained_path=str(tmp / "biggan.npz"),
                       device="cuda")
        loaded = {k: v.cpu() for k, v in model.state_dict().items()}
        same = all(torch.equal(from_pth[k], loaded[k]) for k in from_pth)
        baked_err = max(
            float(((loaded[k] - v.detach() / scales[k]).abs().max()
                   / v.detach().abs().max()))
            for k, v in ref.state_dict().items() if k in scales)
        del from_pth, ref

        # the target and a box mask as PNG files, read back
        gen = torch.Generator(device="cuda").manual_seed(3)
        with torch.no_grad():
            z = torch.randn((1, 128), generator=gen, device="cuda")
            rendered = model(z, model.get_class_embedding(153))[0]
        target_u8 = image.to_image(rendered)
        mask_u8 = np.zeros((256, 256), np.uint8)
        mask_u8[64:192, 48:208] = 255
        fp, mask_fp = str(tmp / "target.png"), str(tmp / "mask.png")
        image.save(fp, target_u8)
        image.save(mask_fp, mask_u8)
        png_equal = (np.array_equal(png.read_png(fp), target_u8)
                     and np.array_equal(png.read_png(mask_fp), mask_u8))
        read_back = image.read(fp, device="cuda")
        read_equal = bool(torch.equal(read_back, torch.as_tensor(
            2.0 * (target_u8.astype(np.float32) / 255.0) - 1.0,
            device="cuda")))

        # the entry point, on the files, at a shortened schedule
        save = tmp / "run"
        full = ex.schedule(argparse.Namespace(smoke=False))
        driver, counts, seconds, peak, syncs = _run_entry_point(
            ex, "BasinCMAOptimizer", (generations, GRAD_STEPS, final_steps),
            ["--fp", fp, "--mask_fp", mask_fp, "--checkpoint",
             str(tmp / "biggan.npz"), "--fused", "--save_dir", str(save),
             "--device", "cuda"])
        result = dict(np.load(save / "result.npz"))
        written = sorted(p.name for p in save.iterdir())

        # the best sample re-rendered, blended into the target by the
        # native solver
        best = int(np.argmin(result["loss"]))
        with torch.no_grad():
            out = model(torch.as_tensor(result["variables/input/z"][best:best + 1],
                                        device="cuda"),
                        torch.as_tensor(result["variables/input/c"][best:best + 1],
                                        device="cuda"))[0]
        # the target as 0..255 floats (its exact pixels), the output in
        # [0, 1], the mask in [0, 1]
        out01 = (out.float().cpu().numpy() + 1.0) / 2.0
        blended = image.poisson_blend(target_u8.astype(np.float32),
                                      mask_u8.astype(np.float32) / 255.0,
                                      out01)
        # the solver called directly: the box's center (127, 127) of rows
        # 64..191 and columns 48..207
        direct = native.seamless_clone(
            (out01 * 255.0).astype(np.uint8), target_u8, mask_u8,
            (127, 127))
        outside = mask_u8 == 0
        blend = {"shape": list(blended.shape), "dtype": str(blended.dtype),
                 "native_library": native.library_path().name,
                 "equals_native_solver": bool(np.array_equal(blended,
                                                             direct)),
                 "outside_mask_equals_target": bool(np.array_equal(
                     blended[outside], target_u8[outside])),
                 "inside_mask_changed": int((blended[~outside]
                                             != target_u8[~outside]).sum())}

    tell_mins = [float(v) for v in result["tell_min"]]
    final_min = float(result["loss"].min())
    gen_seconds = driver.gen_seconds
    gen_s = statistics.mean(gen_seconds[1:] or gen_seconds)
    expect = {"fwd": generations * (GRAD_STEPS + 1) + final_steps,
              "bwd": generations * GRAD_STEPS + final_steps}
    eigh_site = _eigh_site()
    in_gen = syncs.count(in_generation=True)
    res = {
        "phase": "real_input_path", "model": "biggan-deep-256",
        "entry_point": "pix2latent_tpu_torch/examples/invert_biggan_basincma.py",
        "channel_width": model.generator.ch, "dtype": "float32",
        "population": POP, "grad_steps": GRAD_STEPS,
        "generations": generations, "final_steps": final_steps,
        "shortened": (f"{generations} of {full[0]} generations, "
                      f"{final_steps} of {full[2]} final Adam steps"),
        "checkpoint": {"arrays": len(report), "convert_seconds": convert_s,
                       "pth_equals_npz": same,
                       "baked_rel_err": baked_err},
        "png_round_trip": png_equal, "read_equals_png": read_equal,
        "seconds": seconds, "gen_seconds": gen_seconds,
        "seconds_per_generation": gen_s,
        "images_per_sec": POP * GRAD_STEPS / gen_s,
        "peak_memory_bytes": peak,
        "tell_min_per_generation": tell_mins, "final_min_loss": final_min,
        "written": written, "attention_launches": counts,
        "expected_launches": expect,
        "syncs_in_fused_generations": in_gen,
        "make_video": "left out here: it needs cv2 or imageio; tier-1 "
                      "runs it (tests/test_torch_example_inputs.py)",
        "poisson_blend": blend,
        "phase_seconds": time.perf_counter() - t_start}
    emit(res)
    assert model.generator.ch == 128
    assert same, "the .pth and the converted .npz load different weights"
    assert baked_err < 1e-5, baked_err
    assert png_equal and read_equal
    assert len(tell_mins) == generations
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert math.isfinite(final_min) and final_min < tell_mins[0], (
        f"no convergence: first generation {tell_mins[0]}, final {final_min}")
    assert counts == expect, (counts, expect)
    assert in_gen == {eigh_site: generations}, in_gen
    assert {"out.jpg", "best.jpg", "result.npz"} <= set(written), written
    assert blend["shape"] == [256, 256, 3] and blend["dtype"] == "uint8"
    assert blend["equals_native_solver"], blend
    assert blend["outside_mask_equals_target"], blend
    assert blend["inside_mask_changed"] > 0, blend
    return counts


def _self_targets(m, labels, shifts=None):
    """``m`` images of the bf16 BigGAN-deep-256 of seed 0 (the batched
    examples' model), one a class label, optionally shifted (``t = [1,
    shift, 0.05]``), as uint8."""
    import warnings

    import torch
    from pix2latent_tpu_torch.models.biggan import BigGAN
    from pix2latent_tpu_torch.transform import SpatialTransform
    from pix2latent_tpu_torch.utils import image

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = BigGAN("biggan-deep-256", dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    c = torch.cat([model.get_class_embedding(lbl) for lbl in labels])
    with torch.no_grad():
        ims = model(torch.randn((m, 128), generator=gen, device="cuda"),
                    c).float()
        if shifts is not None:
            warp = SpatialTransform(sensitivity=1.0, device="cuda")
            ims = torch.cat([warp.transform(ims[i:i + 1], torch.tensor(
                [[1.0, float(s), 0.05]], device="cuda"))
                for i, s in enumerate(shifts)])
    out = [image.to_image(ims[i]) for i in range(m)]
    del model
    torch.cuda.empty_cache()
    return out


def phase_batched_path(main_images_per_sec):
    """``examples/invert_biggan_batched.py`` on PNG files; see the module
    docstring."""
    import tempfile

    import numpy as np
    import torch
    from pix2latent_tpu_torch.examples import invert_biggan_batched as ex
    from pix2latent_tpu_torch.ops import attention as A
    from pix2latent_tpu_torch.utils import image

    m, (generations, steps, final_steps) = BATCHED_M, BATCHED_SCHEDULE
    labels = BATCHED_LABELS
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fps = []
        for i, im in enumerate(_self_targets(m, labels)):
            fps.append(str(Path(tmp) / f"target_{i}.png"))
            image.save(fps[-1], im)
        full = ex.schedule(argparse.Namespace(smoke=False))
        ex_schedule = ex.schedule
        ex.schedule = lambda args: BATCHED_SCHEDULE
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            A.reset_launch_counts()
            t0 = time.perf_counter()
            with _RecordSyncs() as syncs:
                run = ex.main(["--fps", *fps, "--class_lbls",
                               *map(str, labels), "--max_batch_size",
                               str(BATCHED_MBS), "--save_dir",
                               str(Path(tmp) / "out"), "--device", "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = A.launch_counts()
            peak = torch.cuda.max_memory_allocated()
        finally:
            ex.schedule = ex_schedule
        written = sorted(p.name for p in (Path(tmp) / "out").iterdir())

    res, opt = run["result"], run["optimizer"]
    pop = opt.popsize
    curves = res["loss_curves"]
    final = res["loss"].float().cpu().numpy()
    steady = opt.gen_seconds[1:] or opt.gen_seconds
    gen_s = statistics.mean(steady)
    chunks = -(-m * pop // BATCHED_MBS)
    expect = {"fwd": generations * chunks * (steps + 1)
              + chunks * (final_steps + 1) + 1,
              "bwd": generations * chunks * steps + chunks * final_steps}
    eigh_site = _eigh_site()
    in_gen = syncs.count(in_generation=True)
    images_per_sec = m * pop * steps / gen_s
    result = {
        "phase": "batched_path", "model": "biggan-deep-256",
        "entry_point": "pix2latent_tpu_torch/examples/invert_biggan_batched.py",
        "channel_width": 128, "dtype": "bfloat16", "images": m,
        "class_labels": list(labels), "population": pop,
        "rows": m * pop, "max_batch_size": BATCHED_MBS, "chunks": chunks,
        "generations": generations, "grad_steps": steps,
        "final_steps": final_steps,
        "shortened": (f"{generations} of {full[0]} generations, "
                      f"{final_steps} of {full[2]} final Adam steps"),
        "seconds": seconds, "gen_seconds": opt.gen_seconds,
        "seconds_per_generation": gen_s,
        "images_per_sec": images_per_sec,
        "main_path_images_per_sec": main_images_per_sec,
        "loss_curves": curves.tolist(), "final_loss": final.tolist(),
        "written": written, "attention_launches": counts,
        "expected_launches": expect,
        "syncs_in_fused_generations": in_gen,
        "peak_memory_bytes": peak,
        "phase_seconds": time.perf_counter() - t_start}
    emit(result)
    assert pop == POP and curves.shape == (generations, m), curves.shape
    assert np.isfinite(curves).all() and np.isfinite(final).all()
    assert (final < curves[0]).all(), (final, curves[0])
    assert counts == expect, (counts, expect)
    assert in_gen == {eigh_site: generations}, in_gen
    assert {f"out_{i}.jpg" for i in range(m)} <= set(written), written
    return counts


def phase_transform_batched_path():
    """``examples/invert_biggan_transform_batched.py`` on shifted PNG
    files, at its ``--smoke`` schedule; see the module docstring."""
    import tempfile

    import numpy as np
    import torch
    from pix2latent_tpu_torch.examples import \
        invert_biggan_transform_batched as ex
    from pix2latent_tpu_torch.ops import attention as A
    from pix2latent_tpu_torch.transform import TransformBasinCMAOptimizer
    from pix2latent_tpu_torch.utils import image

    m, labels = 2, BATCHED_LABELS[:2]
    (p1_gens, p1_steps), (gens, steps, final_steps) = ex.schedule(
        argparse.Namespace(smoke=True))
    t_start = time.perf_counter()
    search_counts = {}
    search = TransformBasinCMAOptimizer.optimize_fused_batched

    def counted_search(self, *args, **kwargs):
        out = search(self, *args, **kwargs)
        torch.cuda.synchronize()
        search_counts.update(A.launch_counts())
        search_counts["seconds"] = time.perf_counter() - t0
        search_counts["gen_seconds"] = list(self.gen_seconds)
        search_counts["peak"] = torch.cuda.max_memory_allocated()
        A.reset_launch_counts()
        return out

    with tempfile.TemporaryDirectory() as tmp:
        fps = []
        for i, im in enumerate(_self_targets(m, labels,
                                             np.linspace(-0.3, 0.3, m))):
            fps.append(str(Path(tmp) / f"target_{i}.png"))
            image.save(fps[-1], im)
        TransformBasinCMAOptimizer.optimize_fused_batched = counted_search
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            A.reset_launch_counts()
            t0 = time.perf_counter()
            run = ex.main(["--smoke", "--fps", *fps, "--class_lbls",
                           *map(str, labels), "--save_dir",
                           str(Path(tmp) / "out"), "--device", "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            latent_counts = A.launch_counts()
            peak = torch.cuda.max_memory_allocated()
        finally:
            TransformBasinCMAOptimizer.optimize_fused_batched = search

    res1, res2 = run["search"], run["result"]
    p1, p2 = run["search_optimizer"], run["optimizer"]
    curves1 = res1["loss_curves"]
    gen_s1 = statistics.mean(search_counts["gen_seconds"][1:])
    gen_s2 = statistics.mean(p2.gen_seconds[1:] or p2.gen_seconds)
    expect_search = {"fwd": p1_gens * (p1_steps + 1),
                     "bwd": p1_gens * p1_steps}
    expect_latent = {"fwd": gens * (steps + 1) + final_steps + 2,
                     "bwd": gens * steps + final_steps}
    counts1 = {k: search_counts[k] for k in ("fwd", "bwd")}
    result = {
        "phase": "transform_batched_path", "model": "biggan-deep-256",
        "entry_point": ("pix2latent_tpu_torch/examples/"
                        "invert_biggan_transform_batched.py"),
        "channel_width": 128, "dtype": "bfloat16", "images": m,
        "schedule": (f"--smoke: search {p1_gens} x {p1_steps} at pop "
                     f"{p1.num_samples}, inversion {gens} x {steps} + "
                     f"{final_steps} at pop {p2.popsize} (the example: "
                     "50 x 10, 30 x 30 + 300)"),
        "search": {
            "rows": m * p1.num_samples,
            "seconds": search_counts["seconds"],
            "gen_seconds": search_counts["gen_seconds"],
            "images_per_sec": m * p1.num_samples * p1_steps / gen_s1,
            "loss_curves": curves1.tolist(),
            "best_loss": res1["best_loss"].tolist(),
            "candidate": res1["candidate"].tolist(),
            "launches": counts1, "expected_launches": expect_search,
            "peak_memory_bytes": search_counts["peak"]},
        "inversion": {
            "rows": m * p2.popsize, "gen_seconds": p2.gen_seconds,
            "images_per_sec": m * p2.popsize * steps / gen_s2,
            "loss_curves": res2["loss_curves"].tolist(),
            "final_loss": res2["loss"].float().cpu().numpy().tolist(),
            "launches": latent_counts, "expected_launches": expect_latent,
            "peak_memory_bytes": peak},
        "seconds": seconds,
        "phase_seconds": time.perf_counter() - t_start}
    emit(result)
    assert p1.num_samples == 7 and p2.popsize == POP
    assert curves1.shape == (p1_gens, m) and np.isfinite(curves1).all()
    assert (curves1[-1] < curves1[0]).all(), curves1
    assert np.isfinite(res2["loss_curves"]).all()
    assert np.isfinite(result["inversion"]["final_loss"]).all()
    assert counts1 == expect_search, (counts1, expect_search)
    assert latent_counts == expect_latent, (latent_counts, expect_latent)
    return counts1, latent_counts



def _run_entry_point(ex, driver, sched, argv, counts_of=None):
    """``ex.main(argv)`` on the card with ``ex.schedule`` swapped for
    ``sched`` and the driver class ``driver`` (an attribute of ``ex``)
    recorded, every kernel's counters set to 0 just before and read just
    after (``counts_of()``, K1's by default), and the host syncs recorded
    (:class:`_RecordSyncs`). Returns ``(driver instance, counts, seconds,
    peak bytes, syncs)``."""
    import torch
    from pix2latent_tpu_torch.ops import attention as A
    from pix2latent_tpu_torch.ops import fir_blur as FB
    from pix2latent_tpu_torch.ops import mod_backward as MB

    ex_schedule, ex_driver = ex.schedule, getattr(ex, driver)
    drivers = []

    class Recorded(ex_driver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            drivers.append(self)

    ex.schedule = lambda args: sched
    setattr(ex, driver, Recorded)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kernel in (A, FB, MB):
            kernel.reset_launch_counts()
        t0 = time.perf_counter()
        with _RecordSyncs() as syncs:
            ex.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = (counts_of or A.launch_counts)()
        peak = torch.cuda.max_memory_allocated()
    finally:
        ex.schedule = ex_schedule
        setattr(ex, driver, ex_driver)
    return drivers[0], counts, seconds, peak, syncs


def phase_ng_hybrid_path():
    """``examples/invert_biggan_hybrid_nevergrad.main`` with CMA, fused and
    resumed; see the module docstring."""
    import math
    import tempfile

    import numpy as np
    from pix2latent_tpu_torch.examples import \
        invert_biggan_hybrid_nevergrad as ex

    gens, steps, final_steps = NG_HYBRID_SCHEDULE
    full = ex.schedule(argparse.Namespace(smoke=False))
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--ng_method", "CMA", "--num_samples", str(POP), "--fused",
                "--resume", str(Path(tmp) / "run.npz"), "--save_dir",
                str(Path(tmp) / "out"), "--device", "cuda"]
        opt, counts, seconds, peak, syncs = _run_entry_point(
            ex, "HybridNevergradOptimizer", NG_HYBRID_SCHEDULE, argv)
        result = dict(np.load(Path(tmp) / "out" / "result.npz"))
        # the same command again: everything is on disk
        opt2, counts2, seconds2, _, _ = _run_entry_point(
            ex, "HybridNevergradOptimizer", NG_HYBRID_SCHEDULE, argv)
        again = dict(np.load(Path(tmp) / "out" / "result.npz"))

    tell_mins = [float(v) for v in result["tell_min"]]
    final_min = float(result["loss"].min())
    gen_s = statistics.mean(opt.gen_seconds[1:] or opt.gen_seconds)
    # one forward a step and a tell, one backward a step, and the forward
    # of load_target's synthetic self-target (one sample) before the search
    expect = {"fwd": gens * (steps + 1) + final_steps + 1,
              "bwd": gens * steps + final_steps}
    # the resumed run renders the target and evaluates its final population
    expect_resume = {"fwd": 2, "bwd": 0}
    eigh_site = _eigh_site()
    in_gen = syncs.count(in_generation=True)
    res = {
        "phase": "ng_hybrid_path", "model": "biggan-deep-256",
        "entry_point": ("pix2latent_tpu_torch/examples/"
                        "invert_biggan_hybrid_nevergrad.py"),
        "ng_method": "CMA", "strategy": type(opt.ng_strategy).__name__,
        "channel_width": opt.model.generator.ch, "dtype": "float32",
        "population": POP,
        "driver": "optimize_fused", "generations": gens, "grad_steps": steps,
        "final_steps": final_steps,
        "schedule": (f"{gens} x {steps} + {final_steps} (the example: "
                     f"{full[0]} x {full[1]} + {full[2]})"),
        "seconds": seconds, "gen_seconds": opt.gen_seconds,
        "seconds_per_generation": gen_s,
        "images_per_sec": POP * steps / gen_s,
        "peak_memory_bytes": peak,
        "tell_min_per_generation": tell_mins, "final_min_loss": final_min,
        "attention_launches": counts, "expected_launches": expect,
        "syncs_in_fused_generations": in_gen,
        "syncs_outside_generations": syncs.count(in_generation=False),
        "resume": {"seconds": seconds2,
                   "generations_run": len(opt2.gen_seconds),
                   "attention_launches": counts2,
                   "expected_launches": expect_resume,
                   "variables_equal": bool(np.array_equal(
                       again["variables/input/z"],
                       result["variables/input/z"]))},
        "phase_seconds": time.perf_counter() - t_start}
    emit(res)
    assert type(opt.ng_strategy).__name__ == "CMAStrategy"
    assert res["channel_width"] == 128, res["channel_width"]
    assert len(tell_mins) == gens
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert math.isfinite(final_min) and final_min < tell_mins[0], (
        f"no convergence: first generation {tell_mins[0]}, final {final_min}")
    assert counts == expect, (counts, expect)
    assert in_gen == {eigh_site: gens}, in_gen
    assert res["resume"]["generations_run"] == 0, res["resume"]
    assert counts2 == expect_resume, (counts2, expect_resume)
    assert res["resume"]["variables_equal"], res["resume"]
    return counts


def phase_ng_evalonly_path():
    """``examples/invert_biggan_nevergrad.main`` with TBPSA, fused; see the
    module docstring."""
    import math
    import tempfile

    import numpy as np
    from pix2latent_tpu_torch.examples import invert_biggan_nevergrad as ex

    gens, final_steps = NG_EVAL_SCHEDULE
    full = ex.schedule(argparse.Namespace(smoke=False))
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        opt, counts, seconds, peak, syncs = _run_entry_point(
            ex, "NevergradOptimizer", NG_EVAL_SCHEDULE,
            ["--ng_method", "TBPSA", "--num_samples", str(POP), "--fused",
             "--save_dir", str(Path(tmp) / "out"), "--device", "cuda"])
        result = dict(np.load(Path(tmp) / "out" / "result.npz"))

    tell_mins = [float(v) for v in result["tell_min"]]
    final_min = float(result["loss"].min())
    gen_s = statistics.mean(opt.gen_seconds[1:] or opt.gen_seconds)
    # one forward a generation, one forward and backward a final step, and
    # the forward of the synthetic self-target
    expect = {"fwd": gens + final_steps + 1, "bwd": final_steps}
    in_gen = syncs.count(in_generation=True)
    res = {
        "phase": "ng_evalonly_path", "model": "biggan-deep-256",
        "entry_point": ("pix2latent_tpu_torch/examples/"
                        "invert_biggan_nevergrad.py"),
        "ng_method": "TBPSA", "strategy": type(opt.ng_strategy).__name__,
        "channel_width": opt.model.generator.ch, "dtype": "float32",
        "population": POP,
        "driver": "optimize_fused", "generations": gens,
        "final_steps": final_steps,
        "schedule": (f"{gens} + {final_steps} (the example: {full[0]} + "
                     f"{full[1]})"),
        "seconds": seconds, "gen_seconds": opt.gen_seconds,
        "seconds_per_generation": gen_s,
        "evaluations_per_sec": POP / gen_s,
        "peak_memory_bytes": peak,
        "tell_min_per_generation": tell_mins,
        "min_tell_loss": min(tell_mins), "final_min_loss": final_min,
        "attention_launches": counts, "expected_launches": expect,
        "syncs_in_fused_generations": in_gen,
        "syncs_outside_generations": syncs.count(in_generation=False),
        "phase_seconds": time.perf_counter() - t_start}
    emit(res)
    assert type(opt.ng_strategy).__name__ == "TBPSAStrategy"
    assert res["channel_width"] == 128, res["channel_width"]
    assert len(tell_mins) == gens
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert math.isfinite(final_min)
    assert min(tell_mins[1:]) < tell_mins[0], tell_mins
    assert counts == expect, (counts, expect)
    # TBPSA has no eigh: nothing inside a generation waits for the card
    assert in_gen == {}, in_gen
    return counts


def _save_stylegan2_weights(model_name, path):
    """The ``init="equalized"`` weights of StyleGAN2 ``model_name`` from
    seed 0 (as ``sg2_path``'s), written by ``save_params_npz``: the
    ``--checkpoint`` of a StyleGAN2 entry point."""
    import warnings

    from pix2latent_tpu_torch.models.stylegan2 import StyleGAN2
    from pix2latent_tpu_torch.utils.params_io import (STYLEGAN2,
                                                      save_params_npz,
                                                      to_jax_params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # random-init notices
        model = StyleGAN2(model_name, seed=0, init="equalized", device="cpu")
    save_params_npz(str(path), to_jax_params(model.generator, STYLEGAN2))
    return str(path)


def _kernel_flags(model):
    """``(fir_kernel, fused_mod_bwd)`` of every up-conv blur and modulated
    conv of a StyleGAN2 model, as two sets."""
    from pix2latent_tpu_torch.models.stylegan2 import ModulatedConv
    convs = [m for m in model.generator.modules()
             if isinstance(m, ModulatedConv)]
    return ({m.blur._taps is not None for m in convs if m.up},
            {m.fused_mod_bwd for m in convs})


def phase_cars_ng_path(work_dir):
    """StyleGAN2-cars-512 in float32 through the hybrid driver's host loop
    with DiagonalCMA; see the module docstring."""
    import math

    import torch
    from pix2latent_tpu_torch.examples import common
    from pix2latent_tpu_torch.examples import \
        invert_stylegan2_cars_hybrid_ng as ex
    from pix2latent_tpu_torch.models.stylegan2 import (modulated_conv_inputs,
                                                       modulated_conv_shapes)
    from pix2latent_tpu_torch.ops import block_conv as BC
    from pix2latent_tpu_torch.ops import fir_blur as FB
    from pix2latent_tpu_torch.ops import mod_backward as MB
    from pix2latent_tpu_torch.optimizers import HybridNevergradOptimizer

    gens, steps, final_steps = CARS_NG_SCHEDULE
    full = ex.schedule(argparse.Namespace(smoke=False))
    t_start = time.perf_counter()
    weights = _save_stylegan2_weights("cars", Path(work_dir) / "cars.npz")
    args = ex.parser().parse_args(["--ng_method", "DiagonalCMA",
                                   "--num_samples", str(SG2_POP),
                                   "--checkpoint", weights,
                                   "--device", "cuda"])
    args.grad_free = True
    model, vm = common.stylegan2_problem(args)
    opt = HybridNevergradOptimizer(args.ng_method, model, vm,
                                   common.make_loss(args),
                                   max_batch_size=args.max_minibatch,
                                   device="cuda")
    dtypes = {m.dtype for m in model.generator.modules()
              if isinstance(getattr(m, "dtype", None), torch.dtype)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FB.reset_launch_counts()
    MB.reset_launch_counts()
    BC.reset_launch_counts()
    t0 = time.perf_counter()
    with _RecordSyncs() as syncs:
        variables, outs, final = opt.optimize(
            num_samples=SG2_POP, meta_steps=gens, grad_steps=steps,
            last_grad_steps=final_steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _kernel_counts()
    conv_counts = BC.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # each forward (an inner step, a tell, a final step) blurs once at each
    # up level, each backward runs the adjoint blurs and one modulation
    # backward per modulated conv
    levels = len(sg2_blur_levels(model.im_res))
    convs = len(modulated_conv_inputs(model.im_res, SG2_POP))
    forwards = gens * (steps + 1) + final_steps
    backwards = gens * steps + final_steps
    expect = {"fir_blur_fwd": levels * forwards,
              "fir_blur_bwd": levels * backwards,
              "mod_backward": convs * backwards}
    # in float32 every modulated 3x3 and up-convolution runs the block
    # convolution kernel, forward and input gradient; only the ToRGBs' 1x1s
    # (levels + 1 a forward) stay on F.conv2d
    shapes = modulated_conv_shapes(model.generator, SG2_POP)
    same = sum(1 for _, up, _, _ in shapes if not up)
    expect_conv = {"fwd": same * forwards, "bwd": same * backwards,
                   "up_fwd": levels * forwards, "up_bwd": levels * backwards,
                   "plain": (levels + 1) * forwards}
    tell_mins = opt.losses
    final_min = float(final[0][1]["loss"].min())
    gen_s = statistics.mean(opt.gen_seconds[1:] or opt.gen_seconds)
    eigh_site = _eigh_site()
    sites = {site for site, _, _ in syncs.sites}
    res = {
        "phase": "cars_ng_path", "model": "stylegan2-cars-512",
        "entry_point_functions": (
            "pix2latent_tpu_torch/examples/common.py: stylegan2_problem "
            "(load_stylegan2 of --checkpoint, load_target, "
            "register_stylegan2_vars, cars_loss_mask), make_loss"),
        "kernel_flags": {"fir_kernel": sorted(_kernel_flags(model)[0]),
                         "fused_mod_bwd": sorted(_kernel_flags(model)[1])},
        "ng_method": "DiagonalCMA", "strategy": type(opt.ng_strategy).__name__,
        "channel_multiplier": 2, "dtype": "float32", "population": SG2_POP,
        "driver": "optimize", "generations": gens, "grad_steps": steps,
        "final_steps": final_steps,
        "schedule": (f"{gens} x {steps} + {final_steps} (the example: "
                     f"{full[0]} x {full[1]} + {full[2]})"),
        "max_batch_size": opt.max_batch_size,
        "seconds": seconds, "gen_seconds": opt.gen_seconds,
        "seconds_per_generation": gen_s,
        "images_per_sec": SG2_POP * steps / gen_s,
        "peak_memory_bytes": peak,
        "tell_min_per_generation": tell_mins, "final_min_loss": final_min,
        "blur_levels": levels, "modulated_convs": convs,
        "launches": counts, "expected_launches": expect,
        "block_conv_calls": conv_counts,
        "expected_block_conv_calls": expect_conv,
        "host_syncs": len(syncs.sites), "eigh_syncs": sum(
            1 for site, _, _ in syncs.sites if site == eigh_site),
        "phase_seconds": time.perf_counter() - t_start}
    emit(res)
    assert dtypes == {torch.float32}, dtypes
    assert _kernel_flags(model) == ({True}, {True}), _kernel_flags(model)
    assert type(opt.ng_strategy).__name__ == "DiagonalCMAStrategy"
    assert tuple(opt.out.shape) == (SG2_POP, 512, 512, 3), opt.out.shape
    assert bool(torch.isfinite(opt.out).all())
    assert len(tell_mins) == gens
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert math.isfinite(final_min) and final_min < tell_mins[0], (
        f"no convergence: first generation {tell_mins[0]}, final {final_min}")
    assert (levels, convs, same) == (7, 23, 8)
    assert counts == expect, (counts, expect)
    assert conv_counts == expect_conv, (conv_counts, expect_conv)
    assert eigh_site not in sites, sites
    return dict(counts, block_conv=conv_counts)


def phase_ffhq_entry_path(work_dir):
    """``examples/invert_stylegan2_ffhq_basincma.main`` under its recipe on
    the equalized FFHQ weights as ``--checkpoint``; see the module
    docstring."""
    import math

    import numpy as np
    import torch
    from pix2latent_tpu_torch.examples import \
        invert_stylegan2_ffhq_basincma as ex

    gens, steps, final_steps = FFHQ_ENTRY_SCHEDULE
    full = ex.schedule(argparse.Namespace(smoke=False))
    t_start = time.perf_counter()
    weights = _save_stylegan2_weights("ffhq", Path(work_dir) / "ffhq.npz")
    out_dir = Path(work_dir) / "ffhq_out"
    opt, counts, seconds, peak, syncs = _run_entry_point(
        ex, "BasinCMAOptimizer", FFHQ_ENTRY_SCHEDULE,
        ["--checkpoint", weights, "--save_dir", str(out_dir),
         "--device", "cuda"], counts_of=_kernel_counts)
    result = dict(np.load(out_dir / "result.npz"))

    g = opt.model.generator
    chunks = -(-opt.num_samples // opt.max_batch_size)
    expect = ffhq_expected_launches(gens, final_steps, chunks, steps)
    # load_target renders the synthetic self-target, one sample without
    # gradients: one blur per up level
    expect["fir_blur_fwd"] += len(sg2_blur_levels(g.im_res))
    tell_mins = [float(v) for v in result["tell_min"]]
    final_min = float(result["loss"].min())
    gen_s = statistics.mean(opt.gen_seconds)
    dtypes = {m.dtype for m in g.modules()
              if isinstance(getattr(m, "dtype", None), torch.dtype)}
    res = {
        "phase": "ffhq_entry_path", "model": "stylegan2-ffhq-1024",
        "entry_point": ("pix2latent_tpu_torch/examples/"
                        "invert_stylegan2_ffhq_basincma.py"),
        "checkpoint": "init=equalized, seed 0, save_params_npz",
        "channel_multiplier": 2, "dtypes": sorted(str(d) for d in dtypes),
        "population": opt.num_samples, "remat_from_res": g.remat_from_res,
        "max_batch_size": opt.max_batch_size, "chunks_per_step": chunks,
        "kernel_flags": {"fir_kernel": sorted(_kernel_flags(opt.model)[0]),
                         "fused_mod_bwd": sorted(_kernel_flags(opt.model)[1])},
        "driver": "optimize", "generations": gens, "grad_steps": steps,
        "final_steps": final_steps,
        "schedule": (f"{gens} x {steps} + {final_steps} (the example: "
                     f"{full[0]} x {full[1]} + {full[2]})"),
        "seconds": seconds, "gen_seconds": opt.gen_seconds,
        "seconds_per_generation": gen_s,
        "images_per_sec": opt.num_samples * steps / gen_s,
        "peak_memory_bytes": peak,
        "tell_min_per_generation": tell_mins, "final_min_loss": final_min,
        "launches": counts, "expected_launches": expect,
        "phase_seconds": time.perf_counter() - t_start}
    emit(res)
    assert (g.im_res, g.num_layers, g.remat_from_res, opt.max_batch_size) \
        == (1024, 17, 256, 2)
    assert res["dtypes"] == ["torch.bfloat16"], res["dtypes"]
    assert _kernel_flags(opt.model) == ({True}, {True})
    assert opt.num_samples == SG2_POP, opt.num_samples
    assert len(tell_mins) == gens
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert math.isfinite(final_min) and final_min < tell_mins[0], (
        f"no convergence: first generation {tell_mins[0]}, final {final_min}")
    assert counts == expect, (counts, expect)
    return counts


def phase_edit_path(result_dir, work_dir):
    """``examples/edit_biggan.main`` on ``biggan_f32_path``'s results at
    the reference's GANSpace defaults; see the module docstring."""
    import numpy as np
    import torch
    from pix2latent_tpu_torch.edit import ganspace
    from pix2latent_tpu_torch.examples import edit_biggan as ex
    from pix2latent_tpu_torch.models.biggan import BigGAN
    from pix2latent_tpu_torch.ops import attention as A

    t_start = time.perf_counter()
    result_dir = Path(result_dir)
    weights = str(result_dir / "weights.npz")
    pca_samples, components = EDIT_PCA
    draws, pca = [], {}
    draw, components_of = ganspace._draw, ex.biggan_components

    def recorded_draw(generator, shape, device):
        t = draw(generator, shape, device)
        draws.append(t)
        return t

    def timed_components(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = components_of(*a, **k)
        torch.cuda.synchronize()
        pca["seconds"] = time.perf_counter() - t0
        pca["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        return u

    ganspace._draw, ex.biggan_components = recorded_draw, timed_components
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        editor, edits = ex.main([
            "--var_path", str(result_dir / "vars.npy"),
            "--checkpoint", weights, "--save_dir",
            str(Path(work_dir) / "edits"), "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = A.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        ganspace._draw, ex.biggan_components = draw, components_of

    # the best sample as the inversion rendered it with its population
    inverted = torch.as_tensor(np.load(result_dir / "best_render.npy"),
                               device="cuda")
    default = edits["original"]
    rel = float((default - inverted).norm() / inverted.norm())
    u = editor.components
    norms = u.norm(dim=1)

    # the same draws through the same function on the CPU, its singular
    # values kept for the gaps
    replay = iter(d.cpu() for d in draws)
    pca_lowrank, spectrum = ganspace.pca_lowrank, []

    def recorded_pca(*a, **k):
        s, v = pca_lowrank(*a, **k)
        spectrum.append(s.double())
        return s, v

    ganspace._draw = lambda generator, shape, device: next(replay)
    ganspace.pca_lowrank = recorded_pca
    try:
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cpu_model = BigGAN("biggan-deep-256", pretrained_path=weights,
                               device="cpu")
        t1 = time.perf_counter()
        u_cpu = ganspace.biggan_components(
            cpu_model, editor._c.cpu(), num_components=components,
            num_samples=pca_samples)
        cpu_seconds = time.perf_counter() - t1
    finally:
        ganspace._draw, ganspace.pca_lowrank = draw, pca_lowrank
    u_card = u.double().cpu()
    sign = torch.sign((u_card * u_cpu.double()).sum(dim=1, keepdim=True))
    comp_err = (u_card * sign - u_cpu.double()).abs().max(dim=1).values
    sv = spectrum[0]
    diffs = (sv[1:] - sv[:-1]).abs()
    gap = torch.minimum(torch.cat([diffs[:1], diffs]),
                        torch.cat([diffs, diffs[-1:]])) / sv
    comp_tol = EDIT_COMPONENT_ATOL * torch.clamp(EDIT_GAP / gap, min=1.0)
    edit_diff = {name: float((im - default).abs().max())
                 for name, im in edits.items() if name != "original"}
    res = {
        "phase": "edit_path", "model": "biggan-deep-256",
        "entry_point": "pix2latent_tpu_torch/examples/edit_biggan.py",
        "input": "biggan_f32_path's vars.npy (common.finish) and weights",
        "dtype": "float32", "best_index": editor._idx,
        "pca_samples": pca_samples, "components": list(u.shape),
        "pca_seconds": pca.get("seconds"),
        "pca_peak_memory_bytes": pca.get("peak_memory_bytes"),
        "cpu_pca_seconds": cpu_seconds, "seconds": seconds,
        "peak_memory_bytes": peak,
        "default_vs_inversion_rel_err": rel, "default_tolerance": 1e-3,
        "component_norms_minmax": [float(norms.min()), float(norms.max())],
        "components_vs_cpu_max_abs_err": comp_err.tolist(),
        "components_relative_gap": gap.tolist(),
        "components_tolerance": comp_tol.tolist(),
        "edit_max_abs_diff_from_default": edit_diff,
        "attention_launches": counts,
        "expected_launches": {"fwd": 3, "bwd": 0},
        "phase_seconds": time.perf_counter() - t_start}
    emit(res)
    assert tuple(default.shape) == (256, 256, 3), default.shape
    assert all(bool(torch.isfinite(im).all()) for im in edits.values())
    assert rel <= 1e-3, rel
    assert tuple(u.shape) == (components, 128), u.shape
    assert bool(torch.isfinite(u).all())
    assert float((norms - 1).abs().max()) <= 1e-5, norms
    assert bool(torch.isfinite(comp_err).all())
    assert bool((comp_err <= comp_tol).all()), (comp_err, comp_tol)
    assert all(v > 1e-3 for v in edit_diff.values()), edit_diff
    assert counts == {"fwd": 3, "bwd": 0}, counts
    return counts


def phase_pack_pairs_step():
    """One StyleGAN2-cars-512 step with and without ``pack_pairs``; see the
    module docstring."""
    import warnings

    import torch
    from pix2latent_tpu_torch.models.stylegan2 import StyleGAN2
    from pix2latent_tpu_torch.ops import fir_blur as FB
    from pix2latent_tpu_torch.ops import mod_backward as MB

    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    z = torch.randn((SG2_POP, 512), generator=gen, device="cuda")
    res = {"phase": "pack_pairs_step", "model": "stylegan2-cars-512",
           "population": SG2_POP, "pack_pairs_max_ch": PACK_MAX_CH,
           "packed_levels": [512], "fir_kernel": True,
           "fused_mod_bwd": False, "step": "generator forward, "
           "sum(out ** 2), z gradient"}
    for dtype in (torch.bfloat16, torch.float32):
        models = {}
        for packed in (0, PACK_MAX_CH):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                models[packed] = StyleGAN2(
                    "cars", seed=0, init="equalized", dtype=dtype,
                    fir_kernel=True, pack_pairs_max_ch=packed,
                    device="cuda")

        def step(model):
            zz = z.clone().requires_grad_(True)
            out = model.generator(zz)
            (g,) = torch.autograd.grad((out.float() ** 2).sum(), zz)
            return out.detach(), g

        name = str(dtype).replace("torch.", "")
        got = {}
        for packed, model in models.items():
            FB.reset_launch_counts()
            MB.reset_launch_counts()
            out, g = step(model)
            torch.cuda.synchronize()
            got[packed] = (out, g, dict(FB.launch_counts()),
                           MB.launch_counts()["bwd"])
        (a, ga, ka, ma), (b, gb, kb, mb) = got[0], got[PACK_MAX_CH]
        case = {"fir_blur_launches": {"unpacked": ka, "packed": kb},
                "mod_backward_launches": [ma, mb],
                "out_max_abs_err": float((a - b).abs().max()),
                "out_rel_err": float((a - b).norm() / a.norm()),
                "grad_max_abs_err": float((ga - gb).abs().max()),
                "grad_max_abs": float(ga.abs().max()),
                "grad_rel_err": float((ga - gb).norm() / ga.norm())}
        if dtype == torch.float32:
            # the tolerances of tests/test_stylegan2.py's packing tests
            case["tolerance"] = "out rtol 2e-4 atol 2e-4; grad 1e-4 x max"
            case["ok"] = bool(torch.allclose(b, a, rtol=2e-4, atol=2e-4)) \
                and case["grad_max_abs_err"] < 1e-4 * case["grad_max_abs"]
        else:
            # bfloat16 rounds each layer's output: relative norm errors
            # within the repo's bf16 bound for two StyleGAN2 paths
            case["tolerance"] = "out and grad rel 2e-2"
            case["ok"] = (case["out_rel_err"] <= 2e-2
                          and case["grad_rel_err"] <= 2e-2)
            for packed, model in models.items():
                case[f"{'packed' if packed else 'unpacked'}_ms"] = cuda_ms(
                    lambda m=model: step(m), reps=PACK_REPS, warmup=2)
        res[name] = case
        del models, got, a, b, ga, gb
        torch.cuda.empty_cache()
    res["phase_seconds"] = time.perf_counter() - t_start
    emit(res)
    for name in ("bfloat16", "float32"):
        case = res[name]
        assert case["ok"], (name, case)
        k = case["fir_blur_launches"]
        assert k["unpacked"] == k["packed"] == {"fwd": 7, "bwd": 7}, k
        assert case["mod_backward_launches"] == [0, 0], case
    return res

def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _sharded_vs_plain(opt, steps):
    """One generation (``steps`` inner steps and the tell) of ``opt``'s
    problem from seed 0, on a mesh of this process group and without one,
    under PyTorch's deterministic algorithms (restored after): the two
    tell losses."""
    import torch
    from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer
    from pix2latent_tpu_torch.parallel import make_mesh

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        tells = []
        for mesh in (make_mesh(devices="cuda"), None):
            o = BasinCMAOptimizer(opt.model, opt.var_manager, opt.loss_fn,
                                  max_batch_size=opt.max_batch_size,
                                  mesh=mesh, seed=0, device=opt.device)
            o.setup_cma(o.var_manager)
            loss, _ = o.refine_and_tell(o._ask_population(), steps, 0)
            tells.append(loss.cpu())
        return tells
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.backends.cudnn.benchmark = saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def phase_sharded_path():
    """``examples/invert_biggan_basincma_sharded.main`` over NCCL at world
    size 1, then one generation on the mesh against without one; see the
    module docstring."""
    import math

    import numpy as np
    import torch
    import torch.distributed as dist
    from pix2latent_tpu_torch.examples import \
        invert_biggan_basincma_sharded as ex
    from pix2latent_tpu_torch.parallel import mesh as PM

    gens, steps, final_steps = ex.schedule(argparse.Namespace(smoke=True))
    full = ex.schedule(argparse.Namespace(smoke=False))
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t_start = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--smoke", "--device", "cuda", "--save_dir",
                    str(Path(tmp) / "out")]
            PM.reset_gather_counts()
            opt, counts, seconds, peak, _ = _run_entry_point(
                ex, "BasinCMAOptimizer", (gens, steps, final_steps), argv)
            gathers = PM.gather_counts()
            backend, world = dist.get_backend(), dist.get_world_size()
            result = dict(np.load(Path(tmp) / "out" / "result.npz"))
        on_mesh, plain = _sharded_vs_plain(opt, steps)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    tell_mins = [float(v) for v in result["tell_min"]]
    final_min = float(result["loss"].min())
    gen_s = statistics.mean(opt.gen_seconds[1:] or opt.gen_seconds)
    # one forward a step and a tell, and the target's; one backward a step
    expect = {"fwd": gens * (steps + 1) + final_steps + 1,
              "bwd": gens * steps + final_steps}
    # one a generation (the tell losses), then the final z and c, images
    # and losses, and the host loop's tracked z and c
    expect_gathers = gens + 6
    rel = float(((on_mesh - plain).abs()
                 / plain.abs().clamp_min(1e-30)).max())
    res = {
        "phase": "sharded_path", "model": "biggan-deep-256",
        "entry_point": ("pix2latent_tpu_torch/examples/"
                        "invert_biggan_basincma_sharded.py"),
        "backend": backend, "world_size": world,
        "channel_width": opt.model.generator.ch, "dtype": "float32",
        "population": opt.num_samples, "generations": gens,
        "grad_steps": steps, "final_steps": final_steps,
        "schedule": (f"{gens} x {steps} + {final_steps} (--smoke; the "
                     f"example: {full[0]} x {full[1]} + {full[2]})"),
        "seconds": seconds, "gen_seconds": opt.gen_seconds,
        "seconds_per_generation": gen_s,
        "images_per_sec": opt.num_samples * steps / gen_s,
        "peak_memory_bytes": peak,
        "tell_min_per_generation": tell_mins, "final_min_loss": final_min,
        "attention_launches": counts, "expected_launches": expect,
        "gathers": gathers, "expected_gathers": expect_gathers,
        "mesh_vs_plain_tell_max_rel": rel,
        "mesh_vs_plain_bitwise": bool(torch.equal(on_mesh, plain)),
        "nvidia_smi": smi_line(),
        "phase_seconds": time.perf_counter() - t_start}
    emit(res)
    assert backend == "nccl" and world == 1, (backend, world)
    assert opt.num_samples == POP, opt.num_samples
    assert res["channel_width"] == 128, res["channel_width"]
    assert len(tell_mins) == gens, tell_mins
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert math.isfinite(final_min) and final_min < tell_mins[0], (
        f"no convergence: first generation {tell_mins[0]}, final {final_min}")
    assert counts == expect, (counts, expect)
    assert gathers["gathers"] == expect_gathers, (gathers, expect_gathers)
    assert on_mesh.shape == plain.shape == (POP,)
    assert bool(torch.isfinite(on_mesh).all())
    assert rel <= SHARDED_TELL_RTOL, (
        f"the mesh's tell losses are {rel} off the plain run's")
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the flagship's 30 generations + 300 final steps cut to 20 + 100, and
    # cars' to 10 + 100, to keep the script within about half its time limit
    # with the batched phases on a slow host
    ap.add_argument("--generations", type=int, default=20)
    ap.add_argument("--final-steps", type=int, default=100)
    ap.add_argument("--sg2-generations", type=int, default=10)
    ap.add_argument("--sg2-final-steps", type=int, default=100)
    ap.add_argument("--ffhq-generations", type=int, default=3)
    # a longer finish than a generation's 30 steps: at 30 the final loss
    # came within 1 % of the first generation's on the card
    ap.add_argument("--ffhq-final-steps", type=int, default=100)
    # the BigGAN entry point's 30 x 30 + 300 cut to about a minute
    ap.add_argument("--biggan-generations", type=int, default=3)
    ap.add_argument("--biggan-final-steps", type=int, default=30)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "pix2latent_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the pix2latent_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return _run_phases(args, t0, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run_phases(args, t0, work):
    import torch
    from pix2latent_tpu_torch.ops import block_conv as BC

    env = phase_env()
    phase_build()
    cases = phase_kernels()
    counts, main_images_per_sec = phase_main_path(args.generations,
                                                  args.final_steps)
    phase_whole_step()
    sg2_counts = phase_sg2_path(args.sg2_generations, args.sg2_final_steps)
    phase_sg2_whole_step()
    ffhq_counts = phase_ffhq_path(args.ffhq_generations,
                                  args.ffhq_final_steps)
    phase_ffhq_whole_step()
    biggan_results = Path(work) / "biggan_f32"
    f32_counts, conv_counts = phase_biggan_f32_path(args.biggan_generations,
                                       args.biggan_final_steps, cases,
                                       biggan_results)
    search_counts, latent_counts = phase_transform_path()
    phase_transform_whole_step()
    real_counts = phase_real_input_path(args.biggan_generations,
                                        args.biggan_final_steps)
    batched_counts = phase_batched_path(main_images_per_sec)
    tb_search_counts, tb_latent_counts = phase_transform_batched_path()
    hybrid_ng_counts = phase_ng_hybrid_path()
    eval_ng_counts = phase_ng_evalonly_path()
    cars_ng_counts = phase_cars_ng_path(work)
    phase_ffhq_entry_path(work)
    edit_counts = phase_edit_path(biggan_results, work)
    phase_pack_pairs_step()
    sharded_counts = phase_sharded_path()

    def timed(kernel, path, dtype="bfloat16", shape=FLAGSHIP):
        """The timed case at the path's shape."""
        return next(c for c in cases if c["kernel"] == kernel
                    and c["dtype"] == dtype
                    and ("ms" in c or "fwd_ms" in c)
                    and c.get("path", "main") == path
                    and (kernel != "sagan_attention"
                         or tuple(c["shape"]) == shape))

    kernels = []
    for kernel, path, suffix, launches, src, site in (
            ("sagan_attention", "main", "", counts, "sagan_attention.cu",
             {"fwd": "attention.py:131", "bwd": "attention.py:154"}),
            ("sagan_attention", "biggan_f32_path", "_f32", f32_counts,
             "sagan_attention.cu",
             {"fwd": "attention.py:131", "bwd": "attention.py:154"}),
            ("sagan_attention", "transform_search", "_f32_transform_search",
             search_counts, "sagan_attention.cu",
             {"fwd": "attention.py:131", "bwd": "attention.py:154"}),
            ("sagan_attention", "transform_latent", "_f32_transform_latent",
             latent_counts, "sagan_attention.cu",
             {"fwd": "attention.py:131", "bwd": "attention.py:154"}),
            ("sagan_attention", "real_input", "_f32_real_input",
             real_counts, "sagan_attention.cu",
             {"fwd": "attention.py:131", "bwd": "attention.py:154"}),
            ("sagan_attention", "batched", "_batched", batched_counts,
             "sagan_attention.cu",
             {"fwd": "attention.py:131", "bwd": "attention.py:154"}),
            ("sagan_attention", "transform_batched_search",
             "_transform_batched_search", tb_search_counts,
             "sagan_attention.cu",
             {"fwd": "attention.py:131", "bwd": "attention.py:154"}),
            ("sagan_attention", "transform_batched_latent",
             "_transform_batched_latent", tb_latent_counts,
             "sagan_attention.cu",
             {"fwd": "attention.py:131", "bwd": "attention.py:154"}),
            ("sagan_attention", "ng_hybrid", "_f32_hybrid_ng",
             hybrid_ng_counts, "sagan_attention.cu",
             {"fwd": "attention.py:131", "bwd": "attention.py:154"}),
            ("sagan_attention", "ng_eval", "_f32_ng_eval", eval_ng_counts,
             "sagan_attention.cu",
             {"fwd": "attention.py:131", "bwd": "attention.py:154"}),
            ("sagan_attention", "edit", "_f32_edit",
             {"fwd": edit_counts["fwd"]}, "sagan_attention.cu",
             {"fwd": "attention.py:131"}),
            ("sagan_attention", "sharded", "_f32_sharded", sharded_counts,
             "sagan_attention.cu",
             {"fwd": "attention.py:131", "bwd": "attention.py:154"}),
            ("fir_blur", "main", "", {"fwd": sg2_counts["fir_blur_fwd"],
                                      "bwd": sg2_counts["fir_blur_bwd"]},
             "fir_blur.cu", {"fwd": "pallas_fir.py:108",
                             "bwd": "pallas_fir.py:108"}),
            ("fir_blur", "ffhq_path", "_ffhq",
             {"fwd": ffhq_counts["fir_blur_fwd"],
              "bwd": ffhq_counts["fir_blur_bwd"]},
             "fir_blur.cu", {"fwd": "pallas_fir.py:108",
                             "bwd": "pallas_fir.py:108"}),
            ("fir_blur", "cars_ng", "_f32",
             {"fwd": cars_ng_counts["fir_blur_fwd"],
              "bwd": cars_ng_counts["fir_blur_bwd"]},
             "fir_blur.cu", {"fwd": "pallas_fir.py:108",
                             "bwd": "pallas_fir.py:108"})):
        if path == "transform_search":          # pop 7
            case = timed(kernel, "main", "float32", TRANSFORM_SEARCH)
        elif path == "edit":                    # one sample
            case = timed(kernel, "main", "float32", EDIT)
        elif path in ("biggan_f32_path", "transform_latent", "real_input",
                      "ng_hybrid", "ng_eval", "sharded",    # K1 f32, pop 18
                      "cars_ng"):               # K2 f32 at the cars shape
            case = timed(kernel, "main", "float32")
        elif path in ("batched", "transform_batched_latent"):   # 36 rows
            case = timed(kernel, "main", "bfloat16", BATCHED)
        elif path == "transform_batched_search":                # 14 rows
            case = timed(kernel, "main", "bfloat16", TRANSFORM_BATCHED_SEARCH)
        else:
            case = timed(kernel, path)
        for key in ("fwd", "bwd"):
            if key not in launches:             # the editor: forward only
                continue
            extra = ({"design": case["design"], "shape": case["shape"]}
                     if kernel == "sagan_attention"
                     else {"launched_by": LAUNCHED_BY[path]})
            kernels.append({
                "name": f"{kernel}_{key}{suffix}", "route": "cuda",
                "source": f"pix2latent_tpu_torch/csrc/{src}",
                "replaces": f"pix2latent_tpu/ops/{site[key]}",
                "launches": launches[key],
                "max_abs_err": case[f"{key}_max_abs_err"],
                "ms": case[f"{key}_ms"], "plain_ms": case[f"plain_{key}_ms"],
                "bound_ms": case[f"{key}_bound_ms"],
                "bound_by": case[f"{key}_bound_by"],
                "library_ms": case[f"library_{key}_ms"], **extra})
    for path, suffix, launches, dtype in (
            ("main", "", sg2_counts, "bfloat16"),
            ("ffhq_path", "_ffhq", ffhq_counts, "bfloat16"),
            ("main", "_f32", cars_ng_counts, "float32")):
        case = timed("mod_backward", path, dtype)
        kernels.append({
            "name": f"mod_backward{suffix}", "route": "cuda",
            "launched_by": LAUNCHED_BY[path if suffix != "_f32" else
                                       "cars_ng"],
            "source": "pix2latent_tpu_torch/csrc/mod_backward.cu",
            "replaces": "pix2latent_tpu/ops/mod_backward.py:97",
            "launches": launches["mod_backward"],
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"]})
    # how many of a forward's (and a backward's) 48 GenBlock convolutions at
    # population 18 run each piece of the block convolution kernel
    per_pass = {}
    for _, _, (n, cin, h, w), (cout, _, k, _) in _genblock_shapes():
        for key, m, c in (("fwd", cout, cin), ("bwd", cin, cout)):
            splits = BC.kernel_splits(n, -(-c // BC.BK) * BC.BK, h, w, m, k)
            route = _block_conv_route(k, splits)
            per_pass[route, key] = per_pass.get((route, key), 0) + 1
    for key in ("fwd", "bwd"):
        for case in (c for c in cases if c["kernel"] == "block_conv"
                     and "block" in c):
            name = ("block_conv" if case["route"] == "3x3"
                    else f"block_conv_{case['route']}")
            kernels.append({
                "name": f"{name}_{key}", "route": "cuda",
                "source": "pix2latent_tpu_torch/csrc/block_conv.cu",
                "replaces": "none (cuDNN's convolutions of GenBlock)",
                "launched_by": "biggan_f32_path (GenBlock, every block)",
                "launches": conv_counts[key],
                "of_48_a_pass": per_pass[case["route"], key],
                "shape": case["x_shape"],
                "weight": case["w_shape"], "splits": case[f"{key}_splits"],
                "max_abs_err": case[f"{key}_max_abs_err"],
                "ms": case[f"{key}_ms"], "plain_ms": case[f"plain_{key}_ms"],
                "bound_ms": case[f"{key}_bound_ms"],
                "bound_by": case[f"{key}_bound_by"],
                "library_ms": case[f"library_{key}_ms"]})
    for key in ("fwd", "bwd"):
        for case in (c for c in cases if c["kernel"] == "block_conv"
                     and c["route"].startswith("sg2")):
            up = case["route"] == "sg2_up"
            cars = case["model"] == "cars"
            kernels.append({
                "name": f"block_conv_{case['route']}_{key}", "route": "cuda",
                "source": "pix2latent_tpu_torch/csrc/block_conv.cu",
                "replaces": "none (cuDNN's convolutions of ModulatedConv)",
                "launched_by": ("cars_ng_path (ModulatedConv, float32)" if cars
                                else "none here (the ffhq1024-basincma cell)"),
                "launches": (cars_ng_counts["block_conv"][
                    ("up_" if up else "") + key] if cars else None),
                "model": case["model"], "layer": case["layer"],
                "shape": case["x_shape"], "weight": case["w_shape"],
                "splits": case[f"{key}_splits"],
                "max_abs_err": case[f"{key}_max_abs_err"],
                "ms": case[f"{key}_ms"], "plain_ms": case[f"plain_{key}_ms"],
                "bound_ms": case[f"{key}_bound_ms"],
                "bound_by": case[f"{key}_bound_by"],
                "library_ms": case[f"library_{key}_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
