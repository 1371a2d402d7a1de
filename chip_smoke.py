#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``microimagelib_tpu_torch/csrc/``
with nvcc (sm_90a, one nvcc per source, in parallel), then:

  1. compares the separable-conv kernel (K1, one launch a call) with its
     plain PyTorch version on the card, in all three epilogue modes, for
     six PSF/grid cases (max|diff| <= 1e-5 * max|ref|: both are fp32 FMAs,
     only the summation order differs), checks that two launches and each
     of the kernel's measurement switches give the same bits, and that the
     compiled launch plan is the host's;
  2. runs ``decon_singleview`` on a 512^3 volume with the 9^3 Gaussian
     PSF of bench.py, 10 iterations, on the separable route
     (MIL_CONV_SEP=1), and checks it against the ``torch.fft`` route
     (rtol 2e-4, atol 2e-4 * max) and that K1 launched exactly 20 times;
     prints the route MIL_CONV_SEP=auto takes there, K1's launch plan,
     registers and resident blocks, the peak device memory of one K1 call,
     its time against the z-shaped K7 copy at 512^3 and the time of each
     measurement switch; the route ladder: ms per RL iteration of the K1
     route for rank-1 Gaussians of tap costs 9 to 55 against the K3 and
     ``torch.fft`` routes, at 512^3 and at (192, 640, 640), failing where
     SEP_MAX_TAP_COST picks a route slower than ROUTE_GATE x the faster;
  3. the same for a 45-degree tilted (17, 9, 25) PSF on a (256, 512, 512)
     volume (rank > 1 with per-tap rolls; rtol/atol 5e-4);
  4. runs the deconSingleView CLI on a 200 x 512 x 512 16-bit TIFF (on
     the route auto takes);
  5. compares the FFT-convolution kernel (K3) with complex128
     ``torch.fft`` and with its fp32 plain version at 23 grids, odd
     factors 3 and 5 among them and every specialised length (64, 128,
     192, 256, 320, 384, 512, 576, 640, 704, 768, 1024) on every axis
     (max|diff| <= 1e-4 * max|ref|), checking that the kernel's radix
     plans and spectrum pitch are the host's and which axes took the
     length-specialised transforms, and printing each length's five
     instantiations' registers, spills, shared bytes and resident blocks;
     at (320, 512, 512) and (384, 512, 512) the five launches' device
     times (torch.profiler), each against the bytes it must move and the
     z-shaped K7 copy's rate; then K3 against ``torch.fft`` on a ladder
     of 22 grids by device time a call (10 calls queued behind a spinning
     kernel, CUDA events; 10 calls back to back beside it), the voxel count from which K3 wins on those
     whose every axis takes the specialised transform, and a gate: from
     2^21 voxels on, auto's route within 10% of the faster one, and K3
     wherever it wins on such a grid;
  6. runs ``decon_dualview`` on two (320, 512, 512) views with
     anisotropic 25^3 PSFs and Wiener-Butterworth back projectors, 2
     iterations, MIL_FFT_IMPL=pallas: exactly 8 K3 calls, no K1 launch,
     and within 2e-3 of the same run on ``torch.fft``;
  7. the same views with matched (flipped) PSFs, 10 iterations: the
     separable route (MIL_CONV_SEP=1), exactly 40 K1 launches, within 2e-4
     of the FFT route; the route auto takes;
  8. the genBackProjector and deconDualView CLIs on two 200 x 512 x 512
     16-bit TIFFs (grid (256, 512, 512), MIL_FFT_IMPL=pallas, so K3 runs);
  9. compares the registration kernels K5 (resample + NCC sums) and K4
     (the sums and their gradient in the matrix) with their plain
     versions at the five levels of Phase 10's pyramid and the fusion's
     (320, 512, 320), five matrices (ss, st within rtol 1e-5; gs, gt
     within 2e-4 x max|ref|; two launches bit for bit), checks that the
     compiled launch plan is the host's, that no instantiation spills and
     that a call launches one kernel, and prints per level the plan,
     registers, device time per launch, ms per call back to back, the
     wrapper's host microseconds per call and the bound;
 10. registers a (256, 512, 512) bead volume with its copy moved by the
     reg128 matrix of bench_all.py: ``reg3d``, choice 2, method 7, the
     automatic pyramid, default knobs. Checks NCC >= 0.95, the matrix
     within 0.5 voxel of the truth over the central half-box, each level's
     ladder in K9 with K4's and K5's bodies run at every level, at most
     LEVEL_HOST_CALLS K4/K5 launches from the host a level (the initial
     cost: no sync per evaluation), no ladder on the host loop and no
     plain-version call; prints each level's evaluations, launches, K4/K5
     device time per launch, the sums' ms and the rest of the level's
     time. Then ``reg3d`` choice 1 (the phasor) on the bead
     volume circularly shifted by two whole-voxel vectors, every |shift|
     under size/4 and x over it (the wraparound case): both shifts come
     back exactly; ``max3d_with_coords`` on three tied maxima returns the
     first in C order. Then the same pipeline at (128, 256, 256) on the kernels and
     on ``MIL_NCC_IMPL=gather``: NCC within 1e-3, translations within
     0.35 voxel;
 11. the reg3D CLI on two 200 x 512 x 512 16-bit TIFFs, -regc 2 -affm 7
     -bit 16 -otmx;
 12. compares the one-launch RL iteration kernel (K2) with its plain
     version (max|diff| <= 2e-5 x max|ref|) and with a K1 ratio launch
     followed by a K1 update launch (bit for bit) for the 9^3 bench PSF,
     the fusion PSFs (z reach 12 for view A, x reach 12 for view B) and a
     rank-2 pair at (64, 128, 128), (37, 96, 160), (83, 96, 160) (view A
     in 8-plane groups, the ratio in its ring) and (320, 512, 320); two
     launches give identical bits; the compiled plan is the host's; prints
     each launch's plan (groups, ratio store, grid), registers and spills;
     at the fusion grid times K2 against the K1 pair, prints the peak
     device memory of one call of each and checks that the ratio store is
     smaller than a volume;
 13. compares the N-probe NCC kernel (K6) with K5 (each probe bit for bit)
     and with its plain version (rtol 1e-5) for 8 probes along a line plus
     a 35-degree probe at every level shape of Phase 14's registration
     ((10, 16, 320) ... (320, 512, 320)) and at the five pyramid shapes of
     Phase 10, and times one 8-probe call against 8 K5 calls; K6's numbers
     in the kernels line are those of the largest level where Phase 14
     ran its body (in K9);
 14. runs ``fusion_dualview`` at full width: bead truth on the isotropic
     (320, 512, 320) grid, view A blurred along z and view B moved by the
     reg128 matrix, blurred along x and rotated, both sampled to raw
     (52, 512, 320) at 0.1625 / 1.0 um pixels; choice 2, method 7,
     matched PSFs, 10 iterations; (a) with MIL_CONV_SEP_FUSED=1
     MIL_REG_BATCH_LS=1 (20 K2 launches, no K1 launch, K6's body run in
     K9 and no K6 launch of its own, no plain call), (b) with both off
     (40 K1 launches or 40 K3 calls, as
     auto's route for the fusion PSFs says); (a) against (b): NCC within
     1e-3, matrices within 0.5 voxel; each within FUSION_TRUTH_VOXELS of
     the true matrix and at least the true matrix's NCC on the
     registration's own cost (the CPU test against the JAX package sets
     the distance); (a)'s ladders in K9 with K4's and K6's bodies run,
     (b)'s with K4's and K5's, no host-loop ladder in either; the decon of
     one registered pair with and without K2
     within 2e-4; per-step wall times, ms per dual-view iteration on K2,
     the K1 pair, K3 and ``torch.fft``, and per pyramid level the syncs,
     evaluations, device time per launch and host share with and without
     K6's body;
 15. the spimFusion CLI on the same views as 16-bit TIFFs, -bit 16 -otmx,
     with K2 and K6's body on (its ladders in K9 as (a)'s);
 16. compares the copy in K1's launch shapes (K7) with its plain version,
     bit for bit, in both geometries at 512^3 (shift 4) and at five
     smaller shapes, two of them off the chunk multiples and one with an
     nx that is not a multiple of 4; two launches
     give identical bits; holds it against ``torch.add(aux, v,
     alpha=1e-6)`` (within 1 ulp: that call need not round as one FMA)
     and times the three; then runs
     the roofline tool (``microimagelib_tpu_torch.tools.conv_roofline``)
     at 512^3 in-process, prints its lines and checks it printed every
     metric, each finite and positive, and that K1 and K7 launched in its
     run;
 17. the time-lapse batch at full width: (a) the end-to-end surrogate
     (``microimagelib_tpu_torch.tools.e2e_surrogate``) in-process, --xy 320
     (raw A (52, 320, 320), grid 320^3), 3 timepoints, regMode 2, bg 100,
     10 iterations, 16-bit MP_ZProj and MP_3D_Yaxis: the tool's checks
     (output tree, every final NCC > 0.5), the ladders in K9 (both bodies
     run, no host-loop ladder), the decon's
     kernel (auto's route for the surrogate's PSF) launched 40 times a
     timepoint, K8 launched once per rotating MIP and no plain MIP route
     called, no plain-version call; tp/min; the rotating MIP about y alone
     at 320^3 on auto's route (K8) and on the gather route. (b) Phase 14's raw views as 16-bit TIFFs for 2
     timepoints (t1: view B moved by BATCH_DRIFT) through regMode 3 from
     the 2-D MIP start (choice 4) and regMode 1 from the phasor start
     (choice 3, test image 0): each run's t0 matrix within
     FUSION_TRUTH_VOXELS of the truth and at least the truth's NCC on the
     registration's own cost, the two t0 matrices within
     BATCH_AGREE_VOXELS of each other. Per timepoint: the seconds of each
     stage (read, preprocess, registration, decon, MPs/MIPs, fetch, write,
     the card synchronized after each) and each kernel's launches; (b)'s
     ladders in K9. Every shape at which (a) and (b) launch K1, K3, K4,
     K5 or K9 (K9's under K4 and K5, whose bodies it runs) must be one at
     which Phase 1, 5 or 9 held that kernel against its plain version.
     Then (a) once more with no instrumentation: its tp/min is the batch's
     own.
 18. the beyond-HBM tiers (memory mode 2) at full size, after the
     pageable and pinned host <-> device rates: (a) single-view RL on a
     (696, 1016, 1016) volume, 2 iterations, streamed through host memory
     with mem_mode=2, then with mem_mode=-1 under MIL_HBM_BUDGET_MB=16384
     (a 16 GB card: records[0] must be 2, the streamed call's peak device
     memory under the budget), each within 2e-3 x max of mode 1 on the
     card on the same FFT (MIL_CONV_SEP=0, MIL_FFT_IMPL=xla); seconds per
     streamed iteration and the share of it the bytes moved take at the
     pinned rate; (b) the same for dual view at (320, 512, 512), the auto
     case under a 2 GB budget against mode 1's own route (2e-2); (c) the
     low-memory registration of a (768, 1024, 1024) bead pair moved by a
     whole-voxel translation under the 16 GB budget: a host-pooled coarse
     ladder on K4/K5, the streamed full-resolution polish and final
     transform; the coarse ladder in K9; within 0.5 voxel of the truth and
     1e-3 NCC of mode 1 on
     the same pair, the streamed transform bit-equal to the resident one,
     its peak memory under the budget; the peak factor of one streamed
     block against ``ops.affine.STREAM_PEAK_FACTOR``; then ``reg3d`` with
     the ``hybrid`` engine on Phase 10's (256, 512, 512) pair against the
     ``grad`` engine (1e-3 NCC, 0.5 voxel): every line minimization one
     K9 launch and one sync (no host-loop line), K5 launched only for the
     single evaluations and each level's initial cost, its seconds, lines
     and syncs printed; (d) the spimFusion CLI with -gm 2 on Phase 14's views against
     Phase 14 (b) (1e-3 NCC, 0.5 voxel, each within FUSION_TRUTH_VOXELS of
     the truth).
 19. the multi-device layer (``parallel/*``, ``ops/fft_sharded.py``) with
     every mesh place on the card (``make_mesh(..., devices=[cuda:0] *
     n)``; the shards run one after another there and every exchange is a
     device-to-device copy); every shard the layer lays out or gathers and
     every all-to-all must be on the card: (a) the pencil FFT at (320,
     512, 512) on 4 shards: ``conv_spec_pencil`` within 2e-4 x max of the
     resident ``torch.fft`` convolution, the round trip within 1e-5 x max,
     the bytes and time of one all_to_all; (b) ``rl_decon_single_sharded``
     at 512^3, bench PSF, 10 iterations, 8 shards (with and without
     const_initial), ``rl_decon_dual_sharded`` at (320, 512, 512) with the
     WB projectors, 2 iterations, 4 shards, and ``rl_decon_dual_batch_dp``
     on a (2, 2) mesh, each within rtol 2e-4, atol 2e-4 x max of the
     resident call on the torch.fft route; ms per iteration sharded and
     resident, peak memory per call; (c) ``fusion_step_multichip`` on
     Phase 14's isotropized views at (320, 512, 320), 2 timepoints on a
     (2, 4) mesh, through the footprint window and through the
     whole-source gather: ss, st within rtol 1e-5 of ``corr3d_partials``,
     the estimates within 2e-4 x max of ``rl_decon_dual``, with the
     one-place pencil's and K3's distance from torch.fft on the same views
     printed beside the gate; (d) ``reg3d_affine_sharded`` method 1 on
     Phase 10's beads moved by Phase 18 (c)'s whole-voxel translation (0.5
     voxel of the truth, 1e-3 NCC of ``reg3d_affine``), method 7 at (128,
     256, 256) on the REG_DOF pair (more than one window, NCC > 0.9); (e) the
     spimFusionBatch CLI under MIL_MESH=2,2 on Phase 17 (b)'s TIFFs,
     regMode 3: the ladders in K9, no K1/K3 launch (the decon runs on the
     pencil FFT), each Decon_t within rtol 2e-4, atol 2e-3 x max of the
     CLI without MIL_MESH; (f) two MIL_MULTIHOST=1 processes (gloo on a
     local port) on the card with (e)'s inputs: disjoint timepoint sets
     that cover the series, outputs within (e)'s gate of its one-process
     run, ProcessingLog.p1.txt.
 20. the decon entries on grids of the lengths specialised in K3 after
     128, 256, 320 and 512, on the route ``auto`` takes (K3 on x, y and
     z, the counts set to 0 just before each run): (a) ``decon_dualview``
     of two (360, 600, 600) views (grid (384, 640, 640)), the WB back
     projectors of Phase 6, 2 iterations, default memory mode (1): 8 K3
     calls; (b) ``decon_singleview`` of a (150, 600, 600) volume (grid
     (192, 640, 640)) with the tilted PSF of Phase 3, 10 iterations, on
     the FFT route (MIL_CONV_SEP pinned to 0 if auto took the separable
     one): 20 K3 calls; each within 2e-4 x max of the same call under
     MIL_FFT_IMPL=xla, with its peak device memory and ms per iteration
     on both routes.
 21. the rotating MIP's routes (``models/projections.py``): K8
     (``csrc/mip_rot.cu``: one warp a (frame, column, 32 rows) on a
     rows-last source, only the valid z' interval walked) against its
     plain version (the factored einsums over the tap tables) at (128,
     128, 128) and at (96, 100, 90), whose row counts (100 about y, 90
     about x) leave a partial warp, and against the
     gather route at (320, 320, 320) and (320, 512, 320), about both axes,
     36 frames, within 1e-5 x max; two launches bit for bit; K8's
     registers and spills (``kernel_attrs`` and ``nvcc -Xptxas -v``), its
     bound from the run's matrices, K8's time a call back to back, the
     times of each route's call alone (K8's with ``mip3d_params``' host
     work), the gather route and
     (at (128, 128, 128), where W fits) the one-hot matmul route, and the
     plain version once at (320, 320, 320); ``mip3d_params``' CUDA
     ``auto`` (K8) must be the fastest route timed at each shape.
 22. (run right after Phase 10) K9 (``csrc/reg_ladder.cu``, the ladder's
     optimizer stages on the card, one cooperative launch a stage) against
     its plain version, the host loop (one K4/K5 launch and one sync an
     evaluation), at every level of Phase 10's pyramid from the start
     Phase 10 gave it (its ladders' arguments recorded): evaluations
     within 20%, the final cost within 1e-4, the matrices within 0.05
     voxel over the central half-box; every evaluation's sums (the
     ``trace=`` hook) bit for bit a K4/K5 launch on its matrix; two K9 runs
     bit for bit; the same with MIL_REG_BATCH_LS=1 for both engines from
     the same start (K9's probe stages over K6's body against the host
     loop's K6 launches), every traced probe evaluation's sums bit for bit
     a K6 launch on its matrices, and its split against an 8-probe K6
     launch's device time; ``nvcc -Xptxas -v`` on ``reg_ladder.cu`` (compiled
     beside the library's build: its seconds, and each function's
     registers, frame and spills, the body's path apart from the
     optimizer's side; the eighteen stage kernels and eighteen rows must be
     there, six of them over K6's body); each of the eighteen stage
     kernels' registers, local bytes and resident blocks, and
     co-residency against each level's plan; per
     level the seconds, evaluations, device time and host share of both,
     and K9's split from the trace's stamps (medians of rows, the other
     blocks' and block 0's apart, hand-over, column sum and step, in µs,
     and the rows against a K4/K5 launch's device time at the level).
     Its agreement gates are reported when
     every other phase has run, and fail the run then. With
     ``MIL_SMOKE_DUMP=<dir>`` it saves its smaller levels there for
     ``tools/reg_ladder_witness.py`` (the JAX ladder on the CPU).

Phase 11's reg3D CLI must run its ladders in K9 (both bodies, no host-loop
ladder); Phases 14 (a) and 15 theirs in K9 with K6's body
(MIL_REG_BATCH_LS=1). The CLI phases (4, 8, 11, 15, 17, 18 (d), 19 (e))
must read and write their TIFFs
through the native codec only (``io.tiff.COUNTS``); Phase 11 prints the
reg3D CLI's TIFF seconds.

It prints the card's name and power limit beside every time, ms per RL
iteration for the K1, K2, K3 and ``torch.fft`` routes, one JSON line
describing each kernel (its time, its plain version's, the least time the
card could take for the same work, the time of the nearest PyTorch
library call (K8: its time is its wrapper back to back; also the gather
route's time, ``gather_route_ms``, and the factored route's call alone,
``mip3d_params``' host work included, ``route_ms``; K9: its time is the
ladders of Phase 10's levels, each called alone, summed, per level in
``ms_per_level``, its bound K4/K5's bound times the evaluations on each
body; K4, K5 and K6 count as launches their own only, and the evaluations
K9 ran on their bodies as ``k9_body_evals``; K9's ``k9_lines`` are the
hybrid engine's line launches in Phase 18 (c)),
its launches in Phase 17 (a), ``batch_launches``, in
Phase 18 (c), ``bhbm_launches``, and in Phase 19 (e), ``mesh_launches``), and
as its last line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
then nonzero and that line is not printed. Needs one CUDA device; there
is no CPU path.
"""

import atexit
import contextlib
import io
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from microimagelib_tpu_torch.cli import decon_dv, decon_sv, gen_bp, reg3d as reg3d_cli
from microimagelib_tpu_torch.cli import spim_fusion as fusion_cli
from microimagelib_tpu_torch.cli import spim_fusion_batch as PB_CLI
from microimagelib_tpu_torch.io import tiff as TIFF
from microimagelib_tpu_torch.io.tiff import readtifstack, readtifstack_16to16, writetifstack
from microimagelib_tpu_torch.io.tmx import read_tmx
from microimagelib_tpu_torch.kernels import build
from microimagelib_tpu_torch.kernels import conv_sep as K
from microimagelib_tpu_torch.kernels import corr as C
from microimagelib_tpu_torch.kernels import fft_ct as F
from microimagelib_tpu_torch.kernels import mip_rot as MR
from microimagelib_tpu_torch.kernels import pipe_copy as P
from microimagelib_tpu_torch.kernels import reg_ladder as RL
from microimagelib_tpu_torch.kernels import rl_fused as KF
from microimagelib_tpu_torch.models import batch as PB
from microimagelib_tpu_torch.models import decon_streamed as DS
from microimagelib_tpu_torch.models import deconvolution as D
from microimagelib_tpu_torch.models import fusion as FU
from microimagelib_tpu_torch.models import gen_backprojector
from microimagelib_tpu_torch.models import projections as PP
from microimagelib_tpu_torch.models import registration as R
from microimagelib_tpu_torch.models import registration_device as RD
from microimagelib_tpu_torch.models import registration_grad as RG
from microimagelib_tpu_torch.ops import affine as AF
from microimagelib_tpu_torch.ops import fft_sharded as FS
from microimagelib_tpu_torch.ops.affine import affine_transform_3d
from microimagelib_tpu_torch.ops.basics import (
    align_size_3d,
    max3d_with_coords,
    pad_stack_edge,
    rot_by_y_axis,
)
from microimagelib_tpu_torch.ops.conv_sep import plan_rl_fused, plan_sep
from microimagelib_tpu_torch.ops.matrix import dof_to_matrix
from microimagelib_tpu_torch.ops.resample import resize3d_separable
from microimagelib_tpu_torch.parallel import mesh as PM
from microimagelib_tpu_torch.parallel import sharded as PS
from microimagelib_tpu_torch.tools import conv_roofline
from microimagelib_tpu_torch.tools import e2e_surrogate as E2E

SEED = 0
N_ITERS = 10
DUAL_SHAPE = (320, 512, 512)
WB_ITERS = 2          # Guo 2020's count with Wiener-Butterworth projectors
REG_SHAPE = (256, 512, 512)
REG_DOF = [2.0, -1.5, 1.0, 2.0, -1.0, 1.5, 1, 1, 1]   # bench_all.py:122
FUSION_SHAPE = (320, 512, 320)   # isotropic grid of the diSPIM views
FUSION_RAW = (52, 512, 320)      # raw views: 1.0 um steps, 0.1625 um pixels
FUSION_PIXEL = (0.1625, 0.1625, 1.0)
FUSION_OFFSET = 100.0            # the raw views' camera offset (counts)
# the truth gate of Phase 14 (voxels from the true matrix over the central
# half-box): on these views at a reduced geometry both the port and the
# JAX package land 2.6-2.7 voxels off (tests/test_torch_fusion.py, CPU),
# rounded up to 3 for their spread from run to run
FUSION_TRUTH_VOXELS = 3.0
# Phase 10's phasor cases, (x, y, z) whole-voxel circular shifts of the
# (256, 512, 512) bead volume: every |shift| under size/4, then x over it
# (the wraparound case the box ZNCC decides)
PHASOR_SHIFTS = ((7, -12, 5), (150, 9, -4))
# Phase 17: the end-to-end surrogate's lateral extent and timepoints, and
# the drift (dof_to_matrix, 6 DOF) of view B at (b)'s second timepoint
E2E_XY = 320
E2E_TPS = 3
E2E_MIP_AXES = 1        # the surrogate saves the rotating MIP about y alone
BATCH_TPS = 2
BATCH_DRIFT = (0.6, -0.4, 0.1, 0.05, -0.03, 0.04, 1, 1, 1)
# the two (b) runs' first-timepoint matrices, voxels apart over the
# central half-box
BATCH_AGREE_VOXELS = 1.0
LADDER = (-2.618, -1.0, -0.382, 0.382, 1.0, 1.618, 2.618, 4.236)
# K2's small grids: the second with nz not a multiple of 8; the third with
# 8-plane groups, so that the ratio lives in the ring at nz off the group
K2_SMALL = ((64, 128, 128), (37, 96, 160), (83, 96, 160))
# Phase 10's pyramid level shapes (x = 128, 256, 512), which Phase 13 checks
# K6 at beside the fusion's own levels
REG_LEVELS = ((16, 32, 128), (32, 64, 256), (64, 128, 512), (128, 256, 512),
              REG_SHAPE)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# fp32 operations per valid voxel, counted from csrc/corr.cu: coordinates
# 6, box 6, floor and fractions 6, seven lerps 21, ss/st 4 (K5); the three
# derivative lerps 19 and the gradient sums 24 on top (K4)
CORR_OPS = {False: 43, True: 86}
# K7's (shape, shift) cases: the roofline's 512^3 with the bench plan's z
# reach; two shapes off the 8-plane run and the 1024-vector chunk, the last
# with nz - 1; one chunk; the TPU's shift at the CPU test's shape; an nx
# that is not a multiple of 4 (4-byte accesses)
PIPE_COPY_CASES = (((512, 512, 512), 4), ((24, 40, 100), 0), ((37, 96, 160), 36),
                   ((8, 16, 64), 0), ((32, 128, 128), 8), ((9, 7, 301), 3))
# Phase 18: the beyond-HBM shapes of the JAX package's round-5 probe
# (tools/hw_beyond_hbm.py: single-view RL (696, 1016, 1016), whose mode-1
# working set is ~18 GB, and a (768, 1024, 1024) registration pair), a
# 16 GB card's budget, the dual-view grid under a budget below its
# 9-volume working set, and the whole-voxel translation (z, y, x) of the
# registration pair
BHBM_DECON_SHAPE = (696, 1016, 1016)
BHBM_DECON_ITERS = 2
BHBM_BUDGET_MB = 16384
BHBM_DUAL_BUDGET_MB = 2048
BHBM_REG_SHAPE = (768, 1024, 1024)
BHBM_REG_SHIFT = (5, 9, 7)
HYBRID_SHAPE = REG_SHAPE
AF_IDENTITY = np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], np.float32)


def gauss3(p, s):
    z, y, x = (np.arange(n) - n // 2 for n in p)
    k = np.exp(-z[:, None, None] ** 2 / (2 * s[0] ** 2)
               - y[None, :, None] ** 2 / (2 * s[1] ** 2)
               - x[None, None, :] ** 2 / (2 * s[2] ** 2))
    return (k / k.sum()).astype(np.float32)


def bench_psf():
    """The 9^3 Gaussian of bench.py."""
    zz, yy, xx = np.meshgrid(*[np.arange(9) - 4] * 3, indexing="ij")
    psf = np.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / 4.5).astype(np.float32)
    return psf / psf.sum()


def tilted_psf(p=(17, 9, 25), sl=4.0, ss=1.2, st=1.2):
    """Anisotropic Gaussian tilted 45 degrees in the z-x plane: the
    measured light-sheet PSF class (as tests/test_conv_sep.py builds it)."""
    z, y, x = (np.arange(n) - n // 2 for n in p)
    zz, yy, xx = np.meshgrid(z, y, x, indexing="ij")
    u, w = (xx + zz) / np.sqrt(2.0), (xx - zz) / np.sqrt(2.0)
    k = np.exp(-u ** 2 / (2 * sl ** 2) - w ** 2 / (2 * ss ** 2)
               - yy ** 2 / (2 * st ** 2))
    return (k / k.sum()).astype(np.float32)


def flip(p):
    return np.ascontiguousarray(p[::-1, ::-1, ::-1])


@contextlib.contextmanager
def env(**kw):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up call, timed
    with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def alone_cuda_ms(fn, reps):
    """Mean ms of ``fn`` with the device idle before each call (CUDA events
    around each call alone), after one warm-up call."""
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def check_close(name, out, ref, rtol, atol_rel):
    out, ref = np.asarray(out), np.asarray(ref)
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {out.shape} != {ref.shape}")
    if not np.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    m = float(np.abs(ref).max())
    err = np.abs(out - ref)
    bad = err > atol_rel * m + rtol * np.abs(ref)
    print(f"  {name}: max|diff| {err.max():.6g} = {err.max() / m:.3g} x max|ref| "
          f"(rtol {rtol}, atol {atol_rel} x max)")
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} voxels out of tolerance")


def bound(nbytes, ops):
    """(ms, 'bytes' | 'operations'): the least time the card could take —
    the larger of the bytes over the memory rate and the fp32 operations
    over the fp32 rate (H100 SXM data sheet)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    k9_ptxas = K9Ptxas()
    atexit.register(k9_ptxas.stop)   # a phase that fails before 22 leaves no nvcc behind
    t = time.time()
    lib_path = build.build()
    print(f"built {lib_path.relative_to(build.BUILD_ROOT.parent.parent)} "
          f"in {time.time() - t:.1f} s")
    rng = np.random.default_rng(SEED)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- Phase 1: K1 against its plain version on the card -------------
    print("Phase 1: conv3_sep kernel vs conv3_sep_torch on the card")
    cases = [
        ("a bench 9^3 gaussian", bench_psf(), (64, 128, 128), {}),
        ("b tilted (17,9,25) + rolls", tilted_psf(), (32, 64, 256),
         dict(align=True, tol=1e-4)),
        ("c even 8^3", gauss3((8, 8, 8), (1.2, 1.2, 1.2)), (32, 64, 128), {}),
        ("d oversized (5,41,9) on ny=32", gauss3((5, 41, 9), (1.0, 4.0, 1.5)),
         (32, 32, 128), {}),
        ("e nx=100 (not /128)", bench_psf(), (24, 40, 100), {}),
        ("f fusion A 25 z taps, nz=37", fusion_psfs()[0], (37, 64, 96), {}),
    ]
    for name, psf, shape, kw in cases:
        plan = plan_sep(psf, shape, **kw)
        if plan is None:
            raise AssertionError(f"{name}: planner refused")
        if "rolls" in name and plan.rolls is None:
            raise AssertionError(f"{name}: no per-tap rolls planned")
        v = on_card(rng.random(shape, dtype=np.float32) * 100)
        aux = on_card(rng.random(shape, dtype=np.float32) + 0.5)
        host, compiled = K.plan_of(plan), k1_kernel_plan(plan)
        if host != compiled:
            raise AssertionError(f"{name}: kernel plan {compiled}, host {host}")
        for mode in ("plain", "ratio", "update"):
            before = K.LAUNCHES
            out = K.conv3_sep(v, plan, aux=aux, mode=mode)
            torch.cuda.synchronize()
            if K.LAUNCHES != before + 1:
                raise AssertionError(f"{name} {mode}: launch count did not rise")
            ref = K.conv3_sep_torch(v, plan, aux=aux, mode=mode)
            check_close(f"{name} rank {plan.rank} {mode}", out.cpu(), ref.cpu(),
                        0.0, 1e-5)
            for flags in K1_FORCED:
                if not torch.equal(out.view(torch.int32), K.conv3_sep(
                        v, plan, aux=aux, mode=mode, flags=flags).view(torch.int32)):
                    raise AssertionError(f"{name} {mode}: switches {flags} change the bits")
        CHECKED["K1"].add(shape)
        print(f"  {name}: plan {host}; two launches and the forced ring-less and "
              f"generic paths give the same bits")

    # ---- Phase 2: the headline configuration ---------------------------
    print(f"Phase 2: decon_singleview 512^3, bench PSF, {N_ITERS} iterations")
    psf = bench_psf()
    img = rng.random((512, 512, 512), dtype=np.float32) * 100 + 1
    with env(MIL_CONV_SEP="1"):
        fwd, bp = D._sep_plans(psf, flip(psf), img.shape)[1]
    route2 = auto_route([psf], img.shape, dev)
    print(f"  MIL_CONV_SEP=auto takes the {route2} route here (tap cost "
          f"{D.tap_cost(fwd)}, ceilings {D.SEP_MAX_TAP_COST})")
    if route2 != "separable":
        raise AssertionError(f"the default 512^3 decon takes the {route2} route, not K1")
    img_d = on_card(img)
    imgc = img_d.clamp_min(D.SMALLVALUE)
    est = imgc * 1.0
    kern = {}
    for mode, plan, aux in (("ratio", fwd, imgc), ("update", bp, est)):
        out = K.conv3_sep(est, plan, aux=aux, mode=mode)
        ref = K.conv3_sep_torch(est, plan, aux=aux, mode=mode)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check_close(f"K1 512^3 {mode}", out.cpu(), ref.cpu(), 0.0, 1e-5)
        kern[mode] = err
        del out, ref
    k_ms = cuda_ms(lambda: K.conv3_sep(est, fwd, aux=imgc, mode="ratio"), 20)
    p_ms = cuda_ms(lambda: K.conv3_sep_torch(est, fwd, aux=imgc, mode="ratio"), 3)
    print(f"  K1 at 512^3 (ratio mode): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
          f"[{card}]")
    k1_report(est, fwd, imgc, k_ms, card, "512^3")
    k1_lib_ms = conv3d_library_ms(est, psf, fwd, card)
    n_vox = est.numel()
    taps = fwd.nsteps + fwd.ty.shape[1] + fwd.tx.shape[1]
    k1_bound = bound(3 * 4 * n_vox, n_vox * (2 * fwd.rank * taps + 1))

    K.LAUNCHES = 0
    rec = np.zeros(10)
    with env(MIL_CONV_SEP="1"):
        out_k = D.decon_singleview(img, psf, n_iters=N_ITERS, device=dev,
                                   mem_mode=1, records=rec)
    main_launches = K.LAUNCHES
    print(f"  separable route: {main_launches} K1 launches, decon {rec[8]:.3f} s, "
          f"total {rec[9]:.3f} s (records {rec.tolist()})")
    if main_launches != 2 * N_ITERS:
        raise AssertionError(f"expected {2 * N_ITERS} K1 launches, got {main_launches}")
    with env(MIL_CONV_SEP="0", MIL_FFT_IMPL="xla"):
        out_f = D.decon_singleview(img, psf, n_iters=N_ITERS, device=dev, mem_mode=1)
    if K.LAUNCHES != main_launches:
        raise AssertionError("the FFT route launched K1")
    check_close("512^3 separable vs torch.fft route", out_k, out_f, 2e-4, 2e-4)
    del out_k, out_f, est
    iter_ms = rl_iteration_ms(img_d, psf, fwd, bp, card, "512^3")
    check_auto_route(route2, img.shape, dev, iter_ms["kernel_route"], iter_ms["k3_route"],
                     iter_ms["torch_fft_route"], "512^3")
    route_ladder(img_d, {"ct": iter_ms["k3_route"], "torch": iter_ms["torch_fft_route"]},
                 card, [gauss3(*c) for c in ROUTE_LADDER])
    del img_d, imgc
    torch.cuda.empty_cache()
    route_ladder_grid2(dev, card)

    # ---- Phase 3: the measured-PSF class -------------------------------
    print(f"Phase 3: decon_singleview (256, 512, 512), tilted PSF, {N_ITERS} iterations")
    tpsf = tilted_psf()
    img3 = rng.random((256, 512, 512), dtype=np.float32) * 100 + 1
    with env(MIL_CONV_SEP="1"):
        fwd3, bp3 = D._sep_plans(tpsf, flip(tpsf), img3.shape)[1]
    route3 = auto_route([tpsf], img3.shape, dev)
    print(f"  plans: fwd rank {fwd3.rank}, {fwd3.nsteps} z taps, "
          f"{fwd3.ty.shape[1]} y, {fwd3.tx.shape[1]} x taps, rolls "
          f"{fwd3.rolls is not None}; bp rank {bp3.rank}; MIL_CONV_SEP=auto takes the "
          f"{route3} route (tap cost {D.tap_cost(fwd3)})")
    if fwd3.rank < 2 or fwd3.rolls is None or bp3.rolls is None:
        raise AssertionError("the tilted PSF did not plan at rank > 1 with rolls")
    K.LAUNCHES = 0
    with env(MIL_CONV_SEP="1"):
        out_k = D.decon_singleview(img3, tpsf, n_iters=N_ITERS, device=dev, mem_mode=1)
    if K.LAUNCHES != 2 * N_ITERS:
        raise AssertionError(f"expected {2 * N_ITERS} K1 launches, got {K.LAUNCHES}")
    with env(MIL_CONV_SEP="0", MIL_FFT_IMPL="xla"):
        out_f = D.decon_singleview(img3, tpsf, n_iters=N_ITERS, device=dev, mem_mode=1)
    check_close("tilted separable vs torch.fft route", out_k, out_f, 5e-4, 5e-4)
    del out_k, out_f
    img3_d = on_card(img3)
    est3 = img3_d.clamp_min(D.SMALLVALUE)
    out = K.conv3_sep(est3, fwd3, aux=est3, mode="ratio")
    ref = K.conv3_sep_torch(est3, fwd3, aux=est3, mode="ratio")
    check_close("K1 tilted (256,512,512) ratio", out.cpu(), ref.cpu(), 0.0, 1e-5)
    del out, ref
    k3_ms = cuda_ms(lambda: K.conv3_sep(est3, fwd3, aux=est3, mode="ratio"), 10)
    p3_ms = cuda_ms(lambda: K.conv3_sep_torch(est3, fwd3, aux=est3, mode="ratio"), 2)
    print(f"  K1 at (256,512,512) tilted rank {fwd3.rank} (ratio mode): kernel "
          f"{k3_ms:.3f} ms, plain {p3_ms:.3f} ms [{card}]")
    k1_report(est3, fwd3, est3, k3_ms, card, "tilted (256,512,512)")
    ms3 = rl_iteration_ms(img3_d, tpsf, fwd3, bp3, card, "tilted (256,512,512)")
    check_auto_route(route3, img3.shape, dev, ms3["kernel_route"], ms3["k3_route"],
                     ms3["torch_fft_route"], "tilted (256,512,512)")
    del img3_d, est3

    # ---- Phase 4: the CLI ----------------------------------------------
    print("Phase 4: deconSingleView CLI, 200 x 512 x 512 16-bit TIFF")
    with tempfile.TemporaryDirectory() as tmp, native_tiff("Phase 4"):
        f_img, f_psf, f_out = (os.path.join(tmp, n) for n in
                               ("img.tif", "psf.tif", "out.tif"))
        writetifstack(f_img, rng.random((200, 512, 512), dtype=np.float32)
                      * 1000 + 100, 16)
        writetifstack(f_psf, psf, 32)
        route = auto_route([psf], D._fft_grid((200, 512, 512)), dev)
        before, before_ct = K.LAUNCHES, F.LAUNCHES
        rc = decon_sv.main(["-i", f_img, "-fp", f_psf, "-o", f_out,
                            "-it", str(N_ITERS), "-bit", "32"])
        if rc != 0:
            raise AssertionError(f"CLI returned {rc}")
        res, size = readtifstack(f_out)
        if res.shape != (200, 512, 512) or not np.isfinite(res).all():
            raise AssertionError(f"CLI output bad: shape {res.shape}")
        n1, n3 = K.LAUNCHES - before, F.LAUNCHES - before_ct
        if (n1, n3) != {"separable": (2 * N_ITERS, 0), "K3": (0, 2 * N_ITERS),
                        "torch.fft": (0, 0)}[route]:
            raise AssertionError(f"CLI: {n1} K1 launches, {n3} K3 calls on the {route} route")
        print(f"  CLI output {size} (x, y, z), finite, auto's {route} route: {n1} K1 "
              f"launches, {n3} K3 calls")
    torch.cuda.synchronize()

    ct = phase5_k3(dev, rng, card)
    ct_launches, psfs = phase6_dual_wb(dev, rng, card)
    phase7_dual_matched(dev, psfs, card)
    with native_tiff("Phase 8"):
        phase8_dual_cli(rng, psfs)
    torch.cuda.synchronize()
    corr = phase9_corr(dev, card)
    corr_launches, k9_calls = phase10_reg(dev, card)
    k9 = phase22_k9(dev, card, k9_calls, k9_ptxas)
    del k9_calls
    torch.cuda.empty_cache()
    with native_tiff("Phase 11"):
        phase11_reg_cli(dev)
    torch.cuda.synchronize()
    k2 = phase12_k2(dev, card)
    k6 = phase13_k6(dev, card)
    main14, views = phase14_fusion(dev, card)
    with native_tiff("Phase 15"):
        phase15_fusion_cli(views, card)
    torch.cuda.synchronize()
    k7 = phase16_roofline(dev, card)
    torch.cuda.synchronize()
    with native_tiff("Phase 17"):
        batch = phase17_batch(dev, card, views)
    torch.cuda.synchronize()
    bhbm = phase18_beyond_hbm(dev, card, main14, views)
    torch.cuda.synchronize()
    mesh = phase19_mesh(dev, card, views)
    torch.cuda.synchronize()
    phase20_new_lengths(dev, card)
    torch.cuda.synchronize()
    k8 = phase21_mip(dev, card)
    # K6 was held against K5 at every shape the fusion launched it at; its
    # JSON numbers are those of the largest such shape
    unchecked = set(main14["k6_shapes"]) - set(k6)
    if not main14["k6_shapes"] or unchecked:
        raise AssertionError(f"K6's body ran at {main14['k6_shapes']}, Phase 13 did not "
                             f"check {sorted(unchecked)}")
    k6_shape = max(main14["k6_shapes"], key=lambda s: int(np.prod(s)))
    print(f"K6's numbers below are at {k6_shape}, the largest level the fusion's "
          f"finisher ran K6's body at in K9 (of {main14['k6_shapes']})")
    k6 = k6[k6_shape]

    if k9["faults"]:
        raise AssertionError("Phase 22: " + "; ".join(k9["faults"]))
    print(f"iteration ms at 512^3 [{card}]: " + json.dumps(iter_ms))
    nz, ny, nx = DUAL_SHAPE
    n_ct, n_spec = nz * ny * nx, nz * ny * (nx // 2 + 1)
    k3_bound = bound(8 * n_ct + 8 * n_spec,
                     2 * 2.5 * n_ct * math.log2(n_ct) + 6 * n_spec)
    kernels = [{
        "name": "conv3_sep",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/conv_sep.cu",
        "replaces": "microimagelib_tpu/ops/conv_sep.py:506",
        "launches": main_launches,
        "max_abs_err": max(kern.values()),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": k1_lib_ms,
    }, {
        "name": "conv3_ct",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/fft_ct.cu",
        "replaces": "microimagelib_tpu/ops/fft_pallas.py:296",
        "launches": ct_launches,
        "max_abs_err": ct["max_abs_err"],
        "ms": ct["ms"],
        "plain_ms": ct["plain_ms"],
        "bound_ms": k3_bound[0],
        "bound_by": k3_bound[1],
        # conv3_ct_torch is the torch.fft library route itself
        "library_ms": ct["plain_ms"],
    }]
    for grad, name, line in ((False, "corr3d_partials", 112),
                             (True, "corr3d_grad", 380)):
        c = corr[grad]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "microimagelib_tpu_torch/csrc/corr.cu",
            "replaces": f"microimagelib_tpu/ops/pallas_corr.py:{line}",
            # its own launches on the main path (the initial cost); the
            # evaluations K9 ran on its body there are "k9_body_evals"
            "launches": corr_launches["K4" if grad else "K5"],
            "k9_body_evals": corr_launches["K9_K4" if grad else "K9_K5"],
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound"][0],
            "bound_by": c["bound"][1],
            "library_ms": None,   # no single PyTorch call computes the sums
            "device_ms_per_level": c["levels"],
        })
    kernels.insert(1, {
        "name": "rl_iter_fused",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/rl_fused.cu",
        "replaces": "microimagelib_tpu/ops/conv_sep.py:670",
        "launches": main14["k2"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound"][0],
        "bound_by": k2["bound"][1],
        "library_ms": None,   # no single PyTorch call computes an RL iteration
    })
    kernels.append({
        "name": "corr3d_partials_nprobe",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/corr.cu",
        "replaces": "microimagelib_tpu/ops/pallas_corr.py:242",
        # its own launches on the main path (none since K9 runs its body);
        # the evaluations K9 ran on its body there are "k9_body_evals"
        "launches": main14["k6"],
        "k9_body_evals": main14["k9_k6"],
        "max_abs_err": k6["max_abs_err"],
        "ms": k6["ms"],
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound"][0],
        "bound_by": k6["bound"][1],
        "library_ms": None,   # no single PyTorch call computes the sums
    })
    kernels.append({
        "name": "pipe_copy",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/pipe_copy.cu",
        "replaces": "tools/conv_roofline.py:130",
        "launches": k7["launches"],
        "max_abs_err": k7["max_abs_err"],
        "ms": k7["ms"],
        "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound"][0],
        "bound_by": k7["bound"][1],
        "library_ms": k7["library_ms"],
    })
    kernels.append({
        "name": "mip_rot",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/mip_rot.cu",
        # not a Pallas kernel: the JAX package's XLA factored route
        "replaces": "microimagelib_tpu/models/projections.py:277",
        "launches": batch["K8"],
        "max_abs_err": k8["max_abs_err"],
        # K8's wrapper back to back, as for K1-K7; the factored route's
        # call alone, mip3d_params' host work included, is "route_ms"
        "ms": k8["kernel_ms"],
        "plain_ms": k8["plain_ms"],
        "bound_ms": k8["bound"][0],
        "bound_by": k8["bound"][1],
        "library_ms": None,   # no single PyTorch call computes a rotating MIP
        "gather_route_ms": k8["gather_ms"],
        "route_ms": k8["ms"],
        "redesigned": "PR 16",
    })
    kernels.append({
        "name": "reg_ladder",
        "route": "cuda",
        "source": "microimagelib_tpu_torch/csrc/reg_ladder.cu",
        # not a Pallas kernel: the JAX package's jitted ladder (the L-BFGS
        # and Powell lax.while_loops over K4/K5), one device program
        "replaces": "microimagelib_tpu/models/registration_grad.py:111",
        "also_replaces": "microimagelib_tpu/models/registration_device.py:126",
        "launches": corr_launches["K9"],
        "evaluations": {"K4_body": corr_launches["K9_K4"],
                        "K5_body": corr_launches["K9_K5"],
                        "K6_body_phase14a": main14["k9_k6"]},
        # the line launches of Phase 18 (c)'s hybrid reg3d, one a line
        "k9_lines": bhbm["hybrid_lines"],
        # the largest entry of the ladder's matrix against the host loop's
        "max_abs_err": k9["max_abs_err"],
        "fret_abs_err": k9["fret_err"],
        # the ladders of Phase 10's five levels, each called alone (wall,
        # synchronized), summed; per level below
        "ms": k9["ms"],
        "plain_ms": k9["plain_ms"],
        # K4/K5's bound (Phase 9's model at the level's final matrix) times
        # the evaluations K9 ran on each body, summed over the levels
        "bound_ms": k9["bound"][0],
        "bound_by": k9["bound"][1],
        "library_ms": None,   # no PyTorch call runs an optimizer over the sums
        "ms_per_level": k9["levels"],
        # MIL_REG_BATCH_LS=1 at each level, both engines, against the host loop
        "probe_levels": k9["probe_levels"],
        # nvcc -Xptxas -v on reg_ladder.cu alone: its seconds, the body
        # path's registers and spills, the optimizer's frame
        "build_s": k9["build_s"],
        "ptxas": k9["ptxas"],
    })
    # the launches of Phase 17 (a), the batch's own path, beside each entry's
    # main-path count
    ids = {"conv3_sep": "K1", "rl_iter_fused": "K2", "conv3_ct": "K3",
           "corr3d_partials": "K5", "corr3d_grad": "K4",
           "corr3d_partials_nprobe": "K6", "pipe_copy": "K7", "mip_rot": "K8",
           "reg_ladder": "K9"}

    for k in kernels:
        kernel = ids[k["name"]]
        k["batch_launches"] = batch[kernel]
        # and of Phase 18 (c), the low-memory registration's coarse ladder
        k["bhbm_launches"] = bhbm[kernel]
        # and of Phase 19 (e), the batch CLI under MIL_MESH=2,2
        k["mesh_launches"] = mesh[kernel]
        if kernel in ("K4", "K5", "K6"):
            # the evaluations K9 ran on the body in those runs
            k["batch_k9_body_evals"] = batch[f"K9_{kernel}"]
            k["bhbm_k9_body_evals"] = bhbm[f"K9_{kernel}"]
            k["mesh_k9_body_evals"] = mesh[f"K9_{kernel}"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# Phase 5's gate grids: the first four, then the card test's grids that put
# 128, 256, 320 and 512 on each axis (and an odd row count), then the decon
# grids of Phase 17's (a) and (b), then grids that put each length
# specialised after those four on each axis (every row of the Latin square
# below holds three of them), an odd row count with x 704, and Phase 20's
# padded grids
K3_GRIDS = ((32, 32, 128), (64, 96, 128), DUAL_SHAPE, (256, 512, 512),
            (128, 256, 128), (320, 48, 512), (64, 512, 320), (256, 40, 256), (5, 3, 512),
            (512, 24, 64), (E2E_XY,) * 3, FUSION_SHAPE,
            (64, 768, 1024), (192, 704, 576), (384, 384, 640), (576, 576, 384),
            (640, 640, 192), (704, 64, 768), (768, 192, 704), (1024, 1024, 64),
            (5, 3, 704), (384, 640, 640), (192, 640, 640))
# grids, by voxel count, on which K3 is timed against torch.fft: the first
# version's eleven, one for each length specialised after 128, 256, 320
# and 512 on z with a 512^2 plane, and wide planes. Among those whose every
# axis takes the length-specialised transform, the smallest count from
# which K3 wins at that grid and every larger one is the FFT route's auto
# threshold (models/deconvolution.py CT_MIN_VOXELS)
K3_LADDER = ((128, 128, 128), (128, 128, 256), (64, 256, 256), (128, 256, 256),
             (128, 256, 512), (128, 512, 512), (256, 512, 512), DUAL_SHAPE,
             (64, 384, 384), (192, 384, 384), (384, 512, 512),
             (64, 512, 512), (192, 512, 512), (576, 512, 512), (640, 512, 512),
             (704, 512, 512), (768, 512, 512), (1024, 512, 512),
             (384, 384, 384), (256, 640, 640), (256, 768, 768), (128, 1024, 1024))
# Phase 5's ladder gate, from this many voxels on: auto's route within 10%
# of the faster one, and K3 wherever it wins on an all-specialised grid
K3_GATE_VOXELS = 2 ** 21
K3_GATE_SLACK = 1.10
# calls a ladder grid's device time is taken over
K3_LADDER_REPS = 10


# cycles the card spins before a device-timed run (~20 ms at the H100's
# clocks): the host enqueues the calls meanwhile, so the calls then run
# back to back at the card's own pace
QUEUE_AHEAD_CYCLES = 40_000_000


def device_ms_per_call(fn, reps):
    """Device ms of one call of ``fn``: ``reps`` calls enqueued behind a
    spinning kernel (``torch.cuda._sleep``), so that the host's launches
    are all queued before the first call starts, timed by CUDA events
    around the calls alone. The host's enqueue time must stay inside the
    spin (checked)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    spin_end.record()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    spun_out = spin_end.query()   # the spin over before the last call was queued
    end.synchronize()
    if spun_out:
        raise AssertionError("the host enqueued the calls slower than the card spun")
    return start.elapsed_time(end) / reps


def k3_inputs(shape, rng, dev):
    """A volume from ``rng`` and the OTF of a random PSF (seeded), on the card."""
    psf = np.random.default_rng(SEED).random(shape, dtype=np.float32)
    otf = torch.fft.rfftn(torch.from_numpy(psf / psf.sum()).to(dev)).contiguous()
    v = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100).to(dev)
    return v, otf


def phase5_k3(dev, rng, card):
    """K3 against complex128 torch.fft and its fp32 plain version at
    K3_GRIDS, with the axes that took the length-specialised path; the
    five launches' split at DUAL_SHAPE; the ladder and the threshold it
    gives. Returns the kernel's JSON numbers at DUAL_SHAPE and the
    threshold."""
    print("Phase 5: conv3_ct kernel vs complex128 torch.fft and conv3_ct_torch")
    res = {}
    lengths = sorted({n for shape in K3_GRIDS + K3_LADDER for n in shape})
    for n in lengths:   # the kernel's plan tables against the host's
        want = (F.spec_pitch(n), F.radix_plan(n) or ())
        if F.kernel_plan(n) != want:
            raise AssertionError(f"K3 length {n}: kernel plan {F.kernel_plan(n)}, "
                                 f"host {want}")
    print(f"  kernel plans and pitches match the host's at lengths {lengths}")
    # each specialised length's five instantiations, in launch order
    for n in (n for n in range(64, F.MAX_LEN + 1, 64) if F.radix_plan(n)):
        attrs = F.kernel_attrs((n, n, n))
        print(f"    length {n} {F.radix_plan(n)}: " + "; ".join(
            f"{a['registers']} reg {a['spill_bytes']} B spilled {a['threads']} thr "
            f"{a['static_smem'] + a['dynamic_smem']} B smem {a['blocks_per_sm']} blk/SM"
            for a in attrs))
    # the grids added after the first four draw from their own generator, so
    # the later phases' data stay as they were
    own = np.random.default_rng(SEED + 5)
    for i, shape in enumerate(K3_GRIDS):
        v, otf = k3_inputs(shape, rng if i < 4 else own, dev)
        before, spec_before = F.LAUNCHES, dict(F.LAUNCHES_SPECIALISED)
        out = F.conv3_ct(v, otf)
        torch.cuda.synchronize()
        if F.LAUNCHES != before + 1:
            raise AssertionError(f"K3 {shape}: launch count did not rise")
        rose = {a: F.LAUNCHES_SPECIALISED[a] - spec_before[a] for a in "xyz"}
        want = {a: int(F.radix_plan(n) is not None) for a, n in zip("zyx", shape)}
        if rose != want:
            raise AssertionError(f"K3 {shape}: specialised axes {rose}, expected {want}")
        ref = torch.fft.irfftn(torch.fft.rfftn(v.double()) * otf.to(torch.complex128),
                               s=shape).float()
        check_close(f"K3 {shape} (specialised {''.join(a for a in 'xyz' if rose[a]) or '-'})"
                    " vs complex128", out.cpu(), ref.cpu(), 0.0, 1e-4)
        del ref
        plain = F.conv3_ct_torch(v, otf)
        check_close(f"K3 {shape} vs conv3_ct_torch", out.cpu(), plain.cpu(), 0.0, 1e-4)
        CHECKED["K3"].add(shape)
        if shape == DUAL_SHAPE:
            res["max_abs_err"] = float((out - plain).abs().max())
        del out, plain, v, otf
        torch.cuda.empty_cache()
    split, timed = k3_split(dev, card)
    res.update(ms=timed["ms"], plain_ms=timed["plain_ms"], split=split)
    k3_split(dev, card, (384, 512, 512))

    # by device time: at ~0.05 ms a call, calls back to back time the host's
    # launches (five for K3) more than the card
    print(f"  K3 against torch.fft by grid (device ms a call: {K3_LADDER_REPS} calls "
          f"queued behind a spin, CUDA events; CUDA events over 10 calls back to back "
          f"beside it) [{card}]:")
    ladder, faults = [], []
    for shape in K3_LADDER:
        v, otf = k3_inputs(shape, own, dev)
        k_ev = cuda_ms(lambda: F.conv3_ct(v, otf), 10)
        t_ev = cuda_ms(lambda: F.conv3_ct_torch(v, otf), 10)
        k_ms = device_ms_per_call(lambda: F.conv3_ct(v, otf), K3_LADDER_REPS)
        t_ms = device_ms_per_call(lambda: F.conv3_ct_torch(v, otf), K3_LADDER_REPS)
        vox, full, auto = int(np.prod(shape)), F.ct_specialised(shape), D._fft_impl(shape, v)
        if full:
            ladder.append((vox, k_ms, t_ms))
        generic = "".join(a for a, n in zip("zyx", shape) if not F.radix_plan(n))
        print(f"    {shape} ({vox} voxels, generic axes "
              f"{generic or '-'}): K3 {k_ms:.3f} ms, torch.fft {t_ms:.3f} ms on the "
              f"device (events: {k_ev:.3f}, {t_ev:.3f}) "
              f"({'K3' if k_ms < t_ms else 'torch.fft'} wins; auto takes {auto})")
        taken, other = (k_ms, t_ms) if auto == "ct" else (t_ms, k_ms)
        if vox >= K3_GATE_VOXELS and taken > K3_GATE_SLACK * other:
            faults.append(f"{shape}: auto's {auto} route {taken:.3f} ms against {other:.3f}")
        if vox >= K3_GATE_VOXELS and full and k_ms < t_ms and auto != "ct":
            faults.append(f"{shape}: K3 wins ({k_ms:.3f} against {t_ms:.3f} ms), "
                          "auto takes torch.fft")
        del v, otf
        torch.cuda.empty_cache()
    ladder.sort()
    res["threshold"] = next((vox for i, (vox, _k, _t) in enumerate(ladder)
                             if all(k < t for _v, k, t in ladder[i:])), None)
    print(f"  on the all-specialised grids K3 wins from {res['threshold']} voxels on "
          f"(None: nowhere); the FFT route's auto default is {D.CT_MIN_VOXELS}")
    if faults:
        raise AssertionError("K3 ladder: " + "; ".join(faults))
    print(f"  from {K3_GATE_VOXELS} voxels on, auto takes a route within "
          f"{K3_GATE_SLACK:.2f}x the faster one, and K3 wherever it wins")
    return res


# K3's five launches in order, each with the kernel names that run it (the
# y launches of the first version shared one name, y_kernel)
K3_LAUNCHES = (("x forward", ("x_forward",)), ("y forward", ("y_forward", "y_kernel")),
               ("z x OTF", ("z_kernel",)), ("y inverse", ("y_inverse", "y_kernel")),
               ("x inverse", ("x_inverse",)))


def k3_launch_bytes(shape):
    """Bytes each of K3's five launches must move at ``shape``: v and out
    float32, the half spectrum and the OTF complex64, each read or written
    once per launch."""
    nz, ny, nx = shape
    vol, spec = 4 * nz * ny * nx, 8 * nz * ny * (nx // 2 + 1)
    return {"x forward": vol + spec, "y forward": 2 * spec, "z x OTF": 3 * spec,
            "y inverse": 2 * spec, "x inverse": spec + vol}


def k3_split(dev, card, shape=DUAL_SHAPE):
    """K3's five launches at ``shape``: device time per launch by
    torch.profiler (``device_split``), each launch's bytes and its rate
    against the z-shaped K7 copy timed at the same shape in this run; then
    K3 and ``torch.fft`` per call. Returns {launch: ms} and the call times."""
    prng = np.random.default_rng(SEED + 5)
    v = torch.from_numpy(prng.random(shape, dtype=np.float32) * 100).to(dev)
    otf = torch.fft.rfftn(v / v.sum()).contiguous()
    aux = v + 1
    ceil = 12 * v.numel() / (cuda_ms(lambda: P.pipe_copy(v, aux, 4, "z"), 20) * 1e-3)
    del aux
    rows = device_split(lambda: F.conv3_ct(v, otf), 10, f"K3 {shape}", card)
    nbytes = k3_launch_bytes(shape)
    split = {}
    print(f"  K3 {shape} by launch, against the z-shaped K7 copy's {ceil / 1e12:.3f} "
          f"TB/s at that shape [{card}]:")
    for launch, names in K3_LAUNCHES:
        hits = [ms for key, ms, _n in rows if any(n in key for n in names)]
        if len(hits) != 1:
            raise AssertionError(f"K3 split: {len(hits)} kernels for {launch}")
        ms = split[launch] = hits[0]
        rate = nbytes[launch] / (ms * 1e-3)
        print(f"    {launch}: {ms:.4f} ms, {nbytes[launch] / 1e6:.1f} MB, "
              f"{rate / 1e12:.3f} TB/s = {100 * rate / ceil:.1f}% of the copy")
    total = sum(nbytes.values())
    print(f"    five launches {sum(split.values()):.4f} ms for {total / 1e9:.3f} GB; "
          f"at the copy's rate {total / ceil * 1e3:.4f} ms")
    k_ms = cuda_ms(lambda: F.conv3_ct(v, otf), 10)
    t_ms = cuda_ms(lambda: F.conv3_ct_torch(v, otf), 10)
    print(f"  K3 {shape}: kernel {k_ms:.3f} ms, torch.fft {t_ms:.3f} ms per call [{card}]")
    attrs = F.kernel_attrs(shape)
    for (launch, _names), a in zip(K3_LAUNCHES, attrs):
        print(f"    {launch}: {a['registers']} registers ({a['spill_bytes']} bytes "
              f"spilled) a thread, {a['static_smem'] + a['dynamic_smem']} shared bytes "
              f"and {a['threads']} threads a block, {a['blocks_per_sm']} blocks "
              f"({a['blocks_per_sm'] * a['threads'] // 32} warps) per SM")
    del v, otf
    torch.cuda.empty_cache()
    return split, {"ms": k_ms, "plain_ms": t_ms, "copy_bps": ceil, "attrs": attrs}


def dual_psfs():
    """25^3 Gaussians, sigmas (z, y, x) (3.5, 1.2, 1.2) for view A and
    (1.2, 1.2, 3.5) for view B, and their Wiener-Butterworth back
    projectors (gen_backprojector's defaults)."""
    pa = gauss3((25, 25, 25), (3.5, 1.2, 1.2))
    pb = gauss3((25, 25, 25), (1.2, 1.2, 3.5))
    return pa, pb, gen_backprojector(pa), gen_backprojector(pb)


def phase6_dual_wb(dev, rng, card):
    """The slice's headline: dual view with WB back projectors on K3.
    Returns K3's launch count on that path and the PSFs."""
    print(f"Phase 6: decon_dualview {DUAL_SHAPE}, WB back projectors, "
          f"{WB_ITERS} iterations")
    psfs = pa, pb, wa, wb = dual_psfs()
    if D._sep_plans(pa, wa, DUAL_SHAPE) is not None:
        raise AssertionError("the planner accepted a WB back projector")
    a = rng.random(DUAL_SHAPE, dtype=np.float32) * 100 + 1
    b = rng.random(DUAL_SHAPE, dtype=np.float32) * 100 + 1
    K.LAUNCHES = 0
    F.LAUNCHES = 0
    rec = np.zeros(10)
    with env(MIL_FFT_IMPL="pallas"):   # K3 whatever the auto threshold
        out_k = D.decon_dualview(a, b, pa, pb, n_iters=WB_ITERS, psf_bp_a=wa,
                                 psf_bp_b=wb, device=dev, mem_mode=1, records=rec)
    ct_launches, sep_launches = F.LAUNCHES, K.LAUNCHES
    print(f"  K3 route: {ct_launches} K3 calls, {sep_launches} K1 launches, "
          f"decon {rec[8]:.3f} s (records {rec.tolist()}) [{card}]")
    if ct_launches != 4 * WB_ITERS or sep_launches != 0:
        raise AssertionError(f"expected {4 * WB_ITERS} K3 calls and no K1 launch, "
                             f"got {ct_launches} and {sep_launches}")
    rec_x = np.zeros(10)
    with env(MIL_FFT_IMPL="xla"):
        out_x = D.decon_dualview(a, b, pa, pb, n_iters=WB_ITERS, psf_bp_a=wa,
                                 psf_bp_b=wb, device=dev, mem_mode=1, records=rec_x)
    if F.LAUNCHES != ct_launches:
        raise AssertionError("the torch.fft route launched K3")
    print(f"  torch.fft route: decon {rec_x[8]:.3f} s (records {rec_x.tolist()}) "
          f"[{card}]")
    check_close("dual WB K3 vs torch.fft route", out_k, out_x, 2e-3, 2e-3)
    del out_k, out_x
    a_d, b_d = (torch.from_numpy(x).to(dev) for x in (a, b))
    otfs = [D.gen_otf(p, DUAL_SHAPE, device=dev) for p in (pa, pb, wa, wb)]
    ms = {impl: cuda_ms(lambda: D._rl_dual(a_d, b_d, *otfs, WB_ITERS, False, impl),
                        2) / WB_ITERS
          for impl in ("ct", "torch")}
    print(f"  ms per dual-view iteration {DUAL_SHAPE}, WB [{card}]: "
          f"K3 route {ms['ct']:.3f}, torch.fft route {ms['torch']:.3f}")
    del a_d, b_d, otfs
    torch.cuda.empty_cache()
    return ct_launches, psfs


def phase7_dual_matched(dev, psfs, card):
    """Matched (flipped) PSFs: the separable route, against the FFT route."""
    print(f"Phase 7: decon_dualview {DUAL_SHAPE}, matched PSFs, {N_ITERS} iterations")
    pa, pb = psfs[:2]
    rng = np.random.default_rng(SEED + 7)
    a = rng.random(DUAL_SHAPE, dtype=np.float32) * 100 + 1
    b = rng.random(DUAL_SHAPE, dtype=np.float32) * 100 + 1
    K.LAUNCHES = 0
    with env(MIL_CONV_SEP="1"):
        out_k = D.decon_dualview(a, b, pa, pb, n_iters=N_ITERS, device=dev, mem_mode=1)
    if K.LAUNCHES != 4 * N_ITERS:
        raise AssertionError(f"expected {4 * N_ITERS} K1 launches, got {K.LAUNCHES}")
    route7 = auto_route([pa, pb], DUAL_SHAPE, dev)
    print(f"  separable route: {K.LAUNCHES} K1 launches; MIL_CONV_SEP=auto takes the "
          f"{route7} route")
    before = F.LAUNCHES
    with env(MIL_CONV_SEP="0"):
        out_f = D.decon_dualview(a, b, pa, pb, n_iters=N_ITERS, device=dev, mem_mode=1)
    print(f"  FFT route: {F.LAUNCHES - before} K3 calls")
    check_close("dual matched separable vs FFT route", out_k, out_f, 2e-4, 2e-4)
    del out_k, out_f
    a_d, b_d = (torch.from_numpy(x).to(dev) for x in (a, b))
    with env(MIL_CONV_SEP="1"):
        plans = [p for psf in (pa, pb) for p in D._sep_plans(psf, flip(psf), DUAL_SHAPE)[1]]
    print(f"  tap costs {[D.tap_cost(p) for p in plans]}")
    otfs = [D.gen_otf(p, DUAL_SHAPE, device=dev) for p in (pa, pb, flip(pa), flip(pb))]
    ms = {"K1 route": cuda_ms(lambda: D._rl_dual_sep(a_d, b_d, *plans, N_ITERS,
                                                     False), 2) / N_ITERS}
    for name, impl in (("K3 route", "ct"), ("torch.fft route", "torch")):
        ms[name] = cuda_ms(lambda: D._rl_dual(a_d, b_d, *otfs, N_ITERS, False,
                                              impl), 2) / N_ITERS
    print(f"  ms per dual-view iteration {DUAL_SHAPE}, matched 25^3 [{card}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    check_auto_route(route7, DUAL_SHAPE, dev, ms["K1 route"], ms["K3 route"],
                     ms["torch.fft route"], "dual matched")
    del a_d, b_d, otfs
    torch.cuda.empty_cache()


def phase8_dual_cli(rng, psfs):
    """genBackProjector, then deconDualView -bp1 -bp2 on 16-bit TIFFs."""
    print(f"Phase 8: genBackProjector + deconDualView CLIs, 200 x 512 x 512 "
          f"16-bit TIFFs, {WB_ITERS} iterations")
    with tempfile.TemporaryDirectory() as tmp:
        f = {n: os.path.join(tmp, n + ".tif")
             for n in ("a", "b", "pa", "pb", "wa", "wb", "out")}
        base = rng.random((200, 512, 512), dtype=np.float32) * 1000 + 100
        writetifstack(f["a"], base, 16)
        writetifstack(f["b"], np.roll(base, 3, axis=2), 16)
        del base
        writetifstack(f["pa"], psfs[0], 32)
        writetifstack(f["pb"], psfs[1], 32)
        for src, dst in (("pa", "wa"), ("pb", "wb")):
            if gen_bp.main(["-fp", f[src], "-o", f[dst]]) != 0:
                raise AssertionError("genBackProjector failed")
        before_ct, before_sep = F.LAUNCHES, K.LAUNCHES
        t = time.time()
        with env(MIL_FFT_IMPL="pallas"):   # K3 whatever the auto threshold
            rc = decon_dv.main(["-i1", f["a"], "-i2", f["b"], "-fp1", f["pa"],
                                "-fp2", f["pb"], "-bp1", f["wa"], "-bp2", f["wb"],
                                "-o", f["out"], "-it", str(WB_ITERS), "-bit", "32"])
        wall = time.time() - t
        if rc != 0:
            raise AssertionError(f"deconDualView returned {rc}")
        res, size = readtifstack(f["out"])
        if res.shape != (200, 512, 512) or not np.isfinite(res).all():
            raise AssertionError(f"deconDualView output bad: shape {res.shape}")
        n_ct = F.LAUNCHES - before_ct
        if n_ct != 4 * WB_ITERS or K.LAUNCHES != before_sep:
            raise AssertionError(f"deconDualView: {n_ct} K3 calls, "
                                 f"{K.LAUNCHES - before_sep} K1 launches")
        print(f"  deconDualView output {size} (x, y, z), finite, {n_ct} K3 calls, "
              f"{wall:.3f} s in main()")


def conv3d_library_ms(v, psf, plan, card):
    """K1's library yardstick: one cuDNN ``F.conv3d`` (TF32 off) of the
    circularly padded volume with the flipped PSF, the plain-mode
    convolution K1 computes; its agreement with K1 is printed."""
    pz, py, px = psf.shape
    w = torch.from_numpy(flip(psf)).to(v.device)[None, None]
    # conv3d correlates: with the flipped PSF, output i reads v[i + k - b]
    # for b = p - 1 - p//2 before-padding, the PSF centre at p//2
    vp = torch.nn.functional.pad(v[None, None], (px - 1 - px // 2, px // 2,
                                                 py - 1 - py // 2, py // 2,
                                                 pz - 1 - pz // 2, pz // 2),
                                 mode="circular")
    out = torch.nn.functional.conv3d(vp, w)[0, 0]
    ref = K.conv3_sep(v, plan, mode="plain")
    err = float((out - ref).abs().max() / ref.abs().max())
    ms = cuda_ms(lambda: torch.nn.functional.conv3d(vp, w), 3)
    print(f"  library yardstick for K1: F.conv3d of the circularly padded 512^3 "
          f"volume, {ms:.3f} ms (differs from K1 plain mode by {err:.3g} x max) "
          f"[{card}]")
    del vp, out, ref
    torch.cuda.empty_cache()
    return ms


CORR_MATRICES = {
    "shift": np.array([1, 0, 0, 0.6, 0, 1, 0, -0.8, 0, 0, 1, 0.3], np.float32),
    "shear-scale": np.array([0.99, 0.05, 0, 0.2, -0.05, 0.99, 0, 0.1,
                             0, 0.02, 1.01, -0.4], np.float32),
    "rot10": dof_to_matrix([0.5, -0.3, 0.2, 10.0, 0, 0, 1, 1, 1], 6),
    "partly-outside": dof_to_matrix([6.0, -3.0, 2.0, 4.0, 0, 0, 1, 1, 1], 6),
    "reg128-truth": dof_to_matrix(REG_DOF, 6),
}


def host_us(fn, reps):
    """Host microseconds per call of ``fn`` with no sync between calls
    (the wrapper's issue cost while the device queue has room), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def call_device_ms(rows):
    """Device ms of one call from ``device_split``'s rows: each kernel's
    time per launch, summed (each kernel launches once a call)."""
    return sum(ms for _key, ms, _n in rows) if rows else float("nan")


def level_shapes(shape):
    """The shapes a registration of ``shape`` runs at: each level of the
    automatic pyramid (x stays 320: it pools only while it stays a multiple
    of 128), then full size."""
    return [tuple(s // k for s, k in zip(shape, f))
            for f in R.pyramid_levels(R._auto_pool_factors(shape))] + [tuple(shape)]


# Phase 10's grid for the kernel route against MIL_NCC_IMPL=gather
REG_ROUTE_SHAPE = (128, 256, 256)
# host launches of K4 and K5 a pyramid level may make beside its K9 ladder
# (the initial cost); an evaluation's sums come from K9
LEVEL_HOST_CALLS = 2
# Phase 22's gates, K9 against the host loop from the same start at each
# level: evaluations within 20%, final cost (-NCC) within 1e-4, matrices
# within 0.05 voxel over the central half-box
K9_EVALS_SLACK = 0.20
K9_NCC_TOL = 1e-4
K9_MATRIX_VOXELS = 0.05
K9_TRACE_CAP = 20000
# with MIL_SMOKE_DUMP set to a directory, Phase 22 saves each level of at
# most this many voxels (its pair, its ladder's arguments, K9's and the
# host loop's results) for tools/reg_ladder_witness.py
K9_DUMP_VOXELS = 1 << 20

# Phase 9's shapes: Phase 10's pyramid levels, then every level of the
# fusion's registration (Phases 14 and 17 (b)) and of the surrogate's
# (Phase 17 (a))
CORR_SHAPES = tuple(REG_LEVELS) + tuple(level_shapes(FUSION_SHAPE)) + tuple(
    level_shapes((E2E_XY,) * 3))
# the shapes at which Phases 1, 5 and 9 held K1, K3, K4 and K5 against their
# plain versions; Phase 17 fails if its runs launch one at another shape
CHECKED = {"K1": set(), "K3": set(), "K4": set(), "K5": set()}


def phase9_corr(dev, card):
    """K5 and K4 against their plain versions on the card at every level
    of Phase 10's pyramid and the fusion's full level; per level the
    launch plan (compiled = host mirror), the instantiation's registers,
    device time per launch (torch.profiler: one kernel a call), ms per
    call back to back (CUDA events), the wrapper's host microseconds per
    call and the bound. Returns, per kernel, the JSON numbers at REG_SHAPE
    and the device ms per launch at every shape."""
    print("Phase 9: corr3d kernels K5 (sums) and K4 (sums + gradient) vs "
          "their plain versions")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {False: {"levels": {}}, True: {"levels": {}}}
    for shape in CORR_SHAPES:
        prng = np.random.default_rng(SEED + 9)
        src = torch.from_numpy(prng.random(shape, dtype=np.float32)).to(dev)
        tgt = torch.from_numpy(prng.random(shape, dtype=np.float32)).to(dev)
        n_vox = src.numel()
        for grad in (False, True):
            name_k = "K4" if grad else "K5"
            plan = C.launch_plan(shape, grad, sms)
            if C.kernel_plan(shape, grad, sms) != plan:
                raise AssertionError(f"{name_k} {shape}: compiled plan "
                                     f"{C.kernel_plan(shape, grad, sms)} != {plan}")
            attrs = C.kernel_attrs(name_k, plan["vx"], plan["wide"])
            if attrs["spill_bytes"]:
                raise AssertionError(f"{name_k} {shape}: spills {attrs}")
            err = 0.0
            for name, m in CORR_MATRICES.items():
                before = (C.K4_LAUNCHES, C.K5_LAUNCHES)
                out = C.corr3d(src, tgt, m, grad=grad).cpu().numpy()
                if (C.K4_LAUNCHES - before[0], C.K5_LAUNCHES - before[1]) != \
                        ((1, 0) if grad else (0, 1)):
                    raise AssertionError("corr3d: launch count did not rise")
                again = C.corr3d(src, tgt, m, grad=grad).cpu().numpy()
                if not np.array_equal(out, again):
                    raise AssertionError(f"{name}: two launches differ")
                ref = C.corr3d_torch(src, tgt, m, grad=grad).cpu().numpy()
                rel = np.abs(out[:2] - ref[:2]) / np.abs(ref[:2])
                if rel.max() > 1e-5:
                    raise AssertionError(f"{shape} {name}: ss/st off by {rel}")
                g_err = 0.0
                if grad:
                    for lo, hi in ((2, 14), (14, 26)):
                        sc = np.abs(ref[lo:hi]).max()
                        g_err = max(g_err, np.abs(out[lo:hi] - ref[lo:hi]).max() / sc)
                    if g_err > 2e-4:
                        raise AssertionError(f"{shape} {name}: gradient off by "
                                             f"{g_err:.3g} x max")
                err = max(err, float(np.abs(out - ref).max()))
                CHECKED[name_k].add(shape)
                print(f"  {name_k} {shape} {name}: ss/st rel "
                      f"{rel.max():.3g}" + (f", gs/gt {g_err:.3g} x max" if grad
                                            else ""))
            m = CORR_MATRICES["reg128-truth"]

            def call():
                return C.corr3d(src, tgt, m, grad=grad)

            rows = device_split(call, 10, f"{name_k} at {shape}", card)
            if len(rows) > 1 or any("corr_kernel" not in r[0] for r in rows):
                raise AssertionError(f"{name_k} {shape}: a call launched {rows}, not one "
                                     "corr_kernel")
            dev_ms = call_device_ms(rows)
            ms = cuda_ms(call, 20)
            us = host_us(call, 50)
            plain_ms = cuda_ms(lambda: C.corr3d_torch(src, tgt, m, grad=grad), 2)
            valid = float(C.corr3d_torch(torch.ones_like(src), src, m)[0])
            b = bound(8 * valid, CORR_OPS[grad] * valid)
            print(f"  {name_k} at {shape}: plan vx {plan['vx']} steps {plan['steps']} "
                  f"blocks {plan['blocks']} wide {plan['wide']}, {attrs['registers']} "
                  f"registers, {attrs['blocks_per_sm']} blocks/SM; device {dev_ms:.4f} ms "
                  f"per launch, {ms:.4f} ms per call back to back (CUDA events), host "
                  f"{us:.1f} us per call, {8 * n_vox / dev_ms / 1e6:.1f} GB/s of src+tgt, "
                  f"plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}) [{card}]")
            res[grad]["levels"]["x".join(map(str, shape))] = dev_ms
            if shape == REG_SHAPE:
                res[grad].update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                  "bound": b})
        del src, tgt
        torch.cuda.empty_cache()
    return res


def device_split(fn, reps, label, card):
    """Device time per launch of each kernel ``fn`` launches, by
    torch.profiler, with the number of launches the trace holds out of the
    ``reps`` calls (a trace can miss some; printed, 'not measured' when the
    trace has none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):    # a trace late in a long process can come back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / 1e3 / e.count, e.count)
                for e in prof.key_averages() if e.device_time_total > 0 and e.count]
        if rows:
            break
    text = ", ".join(f"{k[:40]} {v:.4f} ms ({n} in the trace)" for k, v, n in
                     sorted(rows, key=lambda r: -r[1])) or "not measured"
    print(f"  {label}, device time per launch by kernel, {reps} calls: {text} [{card}]")
    return rows


def beads(shape, seed, dev, sigma=3.0):
    """bench_all.py's _blobs at ``shape``: 80 beads per 128^3 voxels in the
    central half of each axis, amplitudes 80-200, smoothed by a
    sum-normalized Gaussian (here with torch.fft on the card)."""
    rng = np.random.default_rng(seed)
    n = int(round(80 * np.prod(shape) / 128 ** 3))
    pos = [rng.integers(s // 4, 3 * s // 4, size=n) for s in shape]
    amp = rng.uniform(80, 200, size=n).astype(np.float32)
    vol = torch.zeros(shape, dtype=torch.float32, device=dev)
    vol[tuple(torch.from_numpy(p).to(dev) for p in pos)] = torch.from_numpy(amp).to(dev)
    g = 1.0
    for ax, s in enumerate(shape):
        d = torch.arange(s, dtype=torch.float64, device=dev)
        d = torch.minimum(d, s - d)          # circular distance to the origin
        k = torch.exp(-d * d / (2 * sigma ** 2))
        g = g * k.reshape([-1 if i == ax else 1 for i in range(3)])
    g = (g / g.sum()).float()
    return torch.fft.irfftn(torch.fft.rfftn(vol) * torch.fft.rfftn(g), s=shape)


def inverse12(m):
    a = np.vstack([np.asarray(m, np.float64).reshape(3, 4), [0, 0, 0, 1]])
    return np.linalg.inv(a)[:3].reshape(12)


def box_error(m, truth, shape):
    """Max distance (voxels) between where ``m`` and ``truth`` map the
    corners of the central half-box of ``shape`` (z, y, x)."""
    sz, sy, sx = shape
    pts = np.array([[x, y, z, 1.0] for x in (sx / 4, 3 * sx / 4)
                    for y in (sy / 4, 3 * sy / 4) for z in (sz / 4, 3 * sz / 4)])
    a = np.asarray(m, np.float64).reshape(3, 4)
    b = np.asarray(truth, np.float64).reshape(3, 4)
    return float(np.abs(pts @ a.T - pts @ b.T).max())


def phase10_reg(dev, card):
    """The slice at full width. Returns the main path's launch counts
    (``counts()``) and the ladders K9 ran, for Phase 22."""
    print(f"Phase 10: reg3d {REG_SHAPE}, choice 2, method 7, automatic pyramid "
          "(default knobs)")
    true_m = dof_to_matrix(REG_DOF, 6)
    vol = beads(REG_SHAPE, SEED, dev)
    moved = affine_transform_3d(vol, true_m, REG_SHAPE)
    levels = []

    def on_level(label, shape, secs):
        levels.append((label, shape, secs, counts()))

    torch.cuda.synchronize()
    zero_counts()
    t = time.time()
    with RL.record_ladders() as ladder_calls:
        reg, tmx, rec = R.reg3d(vol, moved, reg_choice=2, aff_method=7, device=dev,
                                as_device=True, on_level=on_level)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = counts()
    err = box_error(tmx, inverse12(true_m), REG_SHAPE)
    print(f"  reg3d: {wall:.3f} s, NCC {rec[3]:.6f} (initial {rec[1]:.6f}), "
          f"{int(rec[5])} full-resolution evaluations, launches {launches}, matrix "
          f"{np.round(tmx, 5).tolist()}, {err:.4f} voxel from the truth over the "
          f"central half-box [{card}]")
    if not np.isfinite(reg.sum().item()) or tuple(reg.shape) != REG_SHAPE:
        raise AssertionError("registered volume is not finite or has the wrong shape")
    if rec[3] < 0.95 or err > 0.5 or not on_k9(launches):
        raise AssertionError(f"registration failed: NCC {rec[3]}, {err} voxel, "
                             f"launches {launches}")
    if len(ladder_calls) != len(levels):
        raise AssertionError(f"{len(levels)} levels ran {len(ladder_calls)} K9 ladders")
    prev = dict.fromkeys(launches, 0)
    for (label, shape, secs, n), call in zip(levels, ladder_calls):
        d = {k: n[k] - prev[k] for k in n}
        prev = n
        e4, e5 = corr_runs(d, "K4"), corr_runs(d, "K5")
        # one ladder a level, in K9; the host launches K4/K5 a few times a
        # level (the initial cost), not once an evaluation
        if (d["K9"] < 1 or e4 == 0 or e5 == 0 or d["K4"] + d["K5"] > LEVEL_HOST_CALLS
                or d["ladder_plain"] or d["plain"]):
            raise AssertionError(f"level {label}: launches {d}")
        call["level"] = (label, tuple(shape), secs)
        src = R._mean_pool(vol, tuple(s // t for s, t in zip(REG_SHAPE, shape))) \
            if shape != REG_SHAPE else vol
        tgt = torch.roll(src, 1, 2).contiguous()
        m = R._tmx_full_to_coarse(tmx, tuple(s // t for s, t in zip(REG_SHAPE, shape)))
        t4 = cuda_ms(lambda: C.corr3d(src, tgt, m, grad=True), 10)
        t5 = cuda_ms(lambda: C.corr3d(src, tgt, m, grad=False), 10)
        g4, g5 = (call_device_ms(device_split(lambda: C.corr3d(src, tgt, m, grad=g), 10,
                                              f"K{4 if g else 5} level {label}", card))
                  for g in (True, False))
        kern_ms = e4 * g4 + e5 * g5
        call["k45_device_ms"] = (g4, g5)
        print(f"  level {label} {shape}: {e4 + e5} evaluations ({d['K9_K4']} on K4's and "
              f"{d['K9_K5']} on K5's body in {d['K9']} K9 launches; {d['K4']} K4 and "
              f"{d['K5']} K5 launches from the host), {secs:.3f} s, K4/K5 sums "
              f"{kern_ms / (e4 + e5):.4f} ms per evaluation (device K4 {g4:.4f}, K5 "
              f"{g5:.4f} ms per launch; back to back K4 {t4:.4f}, K5 {t5:.4f} ms per "
              f"call), {kern_ms:.3f} ms of the level, the rest of the level's time "
              f"{1 - kern_ms / 1e3 / secs:.3f} [{card}]")
    del reg, moved
    phasor_cases(vol, dev, card)
    del vol
    torch.cuda.empty_cache()

    shape = REG_ROUTE_SHAPE
    vol = beads(shape, SEED + 1, dev)
    moved = affine_transform_3d(vol, true_m, shape)
    out = {}
    for impl in ("auto", "gather"):
        before = counts()
        t = time.time()
        with env(MIL_NCC_IMPL=impl):
            _, tmx2, rec2 = R.reg3d(vol, moved, reg_choice=2, aff_method=7,
                                    device=dev, want_reg=False)
        n = {k: v - before[k] for k, v in counts().items()}
        kernels, plains = n["K4"] + n["K5"] + n["K9"], n["plain"]
        print(f"  {shape} MIL_NCC_IMPL={impl}: {time.time() - t:.3f} s, NCC "
              f"{rec2[3]:.6f}, launches {n}, "
              f"{box_error(tmx2, inverse12(true_m), shape):.4f} voxel from the "
              f"truth [{card}]")
        # auto: the ladders in K9; gather: the host loop on the plain versions
        if ((impl == "auto") != on_k9(n) or (impl == "gather") != (plains > 0)
                or (impl == "gather") != (n["ladder_plain"] > 0 and kernels == 0)):
            raise AssertionError(f"MIL_NCC_IMPL={impl} took the wrong route")
        out[impl] = (rec2[3], tmx2)
    if abs(out["auto"][0] - out["gather"][0]) > 1e-3 or \
            np.abs(out["auto"][1][[3, 7, 11]] - out["gather"][1][[3, 7, 11]]).max() > 0.35:
        raise AssertionError("kernel and plain routes disagree")
    del vol, moved
    torch.cuda.empty_cache()
    return launches, ladder_calls


def wall_s(fn, reps):
    """Least wall seconds of ``fn`` over ``reps`` calls, the card idle
    before each and synchronized after."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    return best


def kernel_device_ms(fn, names, label, card):
    """Device ms of one call of ``fn`` spent in the kernels whose names
    hold one of ``names`` (torch.profiler; each row's mean a launch times
    its launches in the trace)."""
    rows = device_split(fn, 1, label, card)
    return sum(ms * n for key, ms, n in rows if any(x in key for x in names))


class K9Ptxas:
    """``nvcc -Xptxas -v`` on K9's source (``csrc/reg_ladder.cu`` alone,
    with the library's flags), started beside the library's build and read
    in Phase 22."""

    def __init__(self):
        self._tmp = tempfile.TemporaryDirectory()
        t0 = time.time()
        self._proc = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *build.FILE_FLAGS["reg_ladder.cu"],
             "-Xptxas", "-v", "-c", str(build.CSRC_DIR / "reg_ladder.cu"), "-o",
             os.path.join(self._tmp.name, "reg_ladder.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._out = {}

        def wait():   # the compile's own seconds, whenever Phase 22 reads them
            self._out["text"] = self._proc.communicate()[0]
            self._out["secs"] = time.time() - t0

        self._waiter = threading.Thread(target=wait, daemon=True)
        self._waiter.start()

    def stop(self):
        if self._proc.poll() is None:
            self._proc.kill()
        self._waiter.join()
        self._tmp.cleanup()

    def result(self):
        """One dict a function (its mangled name, an entry's registers,
        stack frame and spill bytes), and the compile's seconds."""
        self._waiter.join(timeout=900)
        self._tmp.cleanup()
        if "secs" not in self._out:
            raise AssertionError("nvcc -Xptxas -v on reg_ladder.cu did not finish in 900 s")
        if self._proc.returncode:
            raise AssertionError("nvcc -Xptxas -v failed on reg_ladder.cu:\n"
                                 + self._out.get("text", ""))
        return k9_ptxas_funcs(self._out["text"]), self._out["secs"]


def k9_ptxas_funcs(text):
    """``nvcc -Xptxas -v``'s lines read as one dict a function."""
    funcs, name, entry = {}, None, None
    for ln in text.splitlines():
        m = re.search(r"(Compiling entry function|Function properties for) '?([\w$.]+)'?", ln)
        if m:
            name = m.group(2)
            funcs.setdefault(name, {"name": name, "registers": None})
            if m.group(1).startswith("Compiling"):
                entry = name
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                      r"spill loads", ln)
        if m and name:
            funcs[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            funcs[entry]["registers"] = int(m.group(1))
    return list(funcs.values())


def k9_body_path(fn):
    """True for a function on K9's body path: a stage kernel or the row of
    an instantiation (``stage_row``)."""
    return "reg_stage_kernel" in fn["name"] or "stage_row" in fn["name"]


def k9_probe_kernel(fn):
    """True for a stage kernel over K6's body (the mangled BODY = 2)."""
    return "reg_stage_kernelILi2E" in fn["name"]


def k9_kernel_key(fn):
    """A stage kernel's (BODY, VX, IDX) from its mangled name, as
    '<2, 4, int>'."""
    m = re.search(r"reg_stage_kernelILi(\d)ELi(\d)E([ix])E", fn["name"])
    return f"<{m.group(1)}, {m.group(2)}, {'int' if m.group(3) == 'i' else 'long long'}>"


K9_BODY_NAMES = {0: "Powell and the line, K5's body", 1: "L-BFGS, K4's body",
                 2: "Powell with probes, K6's body"}


def phase22_k9(dev, card, calls, ptxas):
    """K9 (``csrc/reg_ladder.cu``: the ladder's optimizer stages on the
    card) against its plain version (the host loop: one K4/K5 launch and
    one sync an evaluation) at every level of Phase 10's pyramid, from the
    start Phase 10 gave that level (the ladders it ran, recorded). Returns
    K9's JSON numbers."""
    print(f"Phase 22: K9 (reg_ladder) vs the host loop at every level of Phase 10's "
          f"pyramid [{card}]")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {"levels": {}, "probe_levels": {}, "ms": 0.0, "plain_ms": 0.0,
           "bound": [0.0, 0.0], "max_abs_err": 0.0, "fret_err": 0.0, "faults": []}
    funcs, res["build_s"] = ptxas.result()
    print(f"  nvcc -Xptxas -v on csrc/reg_ladder.cu alone (beside the library's build): "
          f"{res['build_s']:.1f} s [{card}]")
    for fn in funcs:
        print(f"    {fn['name']}: {fn['registers']} registers, {fn.get('stack')} B stack "
              f"frame, {fn.get('spill_stores')} B spill stores, {fn.get('spill_loads')} B "
              f"spill loads" + ("" if k9_body_path(fn) else " (the optimizer's side)"))
    body = [fn for fn in funcs if k9_body_path(fn)]
    spilled = [fn["name"] for fn in body if fn.get("spill_stores") or fn.get("spill_loads")]
    for part in ("reg_stage_kernel", "stage_row"):
        if len([fn for fn in body if part in fn["name"]]) != len(RL.INSTANTIATIONS):
            raise AssertionError(f"K9's body path: {[fn['name'] for fn in body]}")
    res["ptxas"] = {"body_spill_bytes": max((fn.get("spill_stores") or 0) for fn in body),
                    "body_spilled": len(spilled),
                    "body_registers": max(fn["registers"] or 0 for fn in body),
                    "optimizer_stack_bytes": max(fn.get("stack") or 0 for fn in funcs
                                                 if not k9_body_path(fn)),
                    # the six stage kernels over K6's body (BODY 2)
                    "probe_kernels": {k9_kernel_key(fn): [fn["registers"], fn.get("spill_stores"),
                                                          fn.get("spill_loads")]
                                      for fn in body if k9_probe_kernel(fn)}}
    if len(res["ptxas"]["probe_kernels"]) != 6:
        raise AssertionError(f"K9's probe stage kernels: {res['ptxas']['probe_kernels']}")
    for body_id, vx, wide in RL.INSTANTIATIONS:
        at = RL.kernel_attrs(body_id, vx, wide)
        print(f"  stage kernel <{body_id}, {vx}, {'long long' if wide else 'int'}> "
              f"({K9_BODY_NAMES[body_id]}): {at['registers']} registers, {at['spill_bytes']} "
              f"B local a thread (the optimizer's frame), {at['static_smem']} B shared, "
              f"{at['blocks_per_sm']} blocks/SM")
        if at["blocks_per_sm"] < C.RESIDENT[body_id == RL.BODIES["K4"]]:
            raise AssertionError(f"stage kernel {(body_id, vx, wide)} keeps "
                                 f"{at['blocks_per_sm']} blocks an SM")
    for call in calls:
        label, shape, _secs = call["level"]
        src, tgt = call["src"], call["tgt"]
        knobs = [call[k] for k in ("sd_t", "p_init12", "aff_method", "ftol", "it_limit",
                                   "engine", "finish", "finish_sweeps", "ls_max_iters",
                                   "ls_patience")]
        a = RL.args_of(call)
        for grad in (True, False):
            plan = C.launch_plan(shape, grad, sms)
            at = RL.kernel_attrs(grad, plan["vx"], plan["wide"])
            print(f"  level {label} {shape}: K9's {'L-BFGS (K4 body)' if grad else 'Powell (K5 body)'}"
                  f" stage kernel: {at['registers']} registers, {at['spill_bytes']} B local a "
                  f"thread, {at['static_smem']} B shared, {at['blocks_per_sm']} blocks/SM for "
                  f"a plan of {plan['blocks']} blocks on {sms} SMs")
            if at["blocks_per_sm"] * sms < plan["blocks"]:
                raise AssertionError(f"level {label}: K9's blocks are not co-resident")
        torch.cuda.synchronize()
        st, trace = RL.launch(src, tgt, a, trace_cap=K9_TRACE_CAP)
        n_ev = st.evals[0] + st.evals[1]
        if n_ev > K9_TRACE_CAP or len(trace) != n_ev or n_ev != st.nev:
            raise AssertionError(f"level {label}: {n_ev} evaluations, {len(trace)} traced, "
                                 f"nev {st.nev}")
        st2, _ = RL.launch(src, tgt, a)
        if bytes(st) != bytes(st2):
            raise AssertionError(f"level {label}: two K9 runs differ")
        split = {"all": RL.split_medians(trace), "K4": RL.split_medians(trace, 1),
                 "K5": RL.split_medians(trace, 0)}
        g45 = dict(zip(("K4", "K5"), call["k45_device_ms"]))
        for kind, sp in split.items():
            if not sp["n"]:
                continue
            vs = (f"; rows {sp['rows'] / 1e3 / g45[kind]:.2f}x a {kind} launch's device "
                  f"time ({g45[kind] * 1e3:.1f} us)" if kind in g45 else "")
            print(f"  level {label} {shape}: K9 split, medians of {sp['n']} {kind} "
                  f"evaluations (us): rows {sp['rows']:.2f} (release {sp['release']:.2f}; "
                  f"other blocks {sp['rows_others']:.2f}, block 0 {sp['rows_block0']:.2f}), "
                  f"hand-over {sp['handover']:.2f}, column sum {sp['colsum']:.2f}, step "
                  f"{sp['step']:.2f}, evaluation {sp['evaluation']:.2f}{vs} [{card}]")
        bad = 0
        for r in trace:
            g = bool(r[0])
            nv = 26 if g else 2
            out = C.corr3d(src, tgt, r[1:13].astype(np.float32), grad=g).cpu().numpy()
            bad += not np.array_equal(out.view(np.int64), r[13:13 + nv].view(np.int64))
        if bad:
            raise AssertionError(f"level {label}: {bad} of {n_ev} evaluations' sums differ "
                                 "from a K4/K5 launch on the same matrix")
        ref = RG.reg_ladder_host(src, tgt, *knobs)
        aff = np.array(st.aff, np.float32)
        d_ev = abs(st.nev - ref[3]) / ref[3]
        d_f = abs(float(st.fret) - float(ref[1]))
        d_m = box_error(aff, ref[0], shape)

        def k9():
            return RL.reg_ladder(src, tgt, *knobs)

        def host():
            return RG.reg_ladder_host(src, tgt, *knobs)

        k_s, h_s = wall_s(k9, 3), wall_s(host, 2)
        k_dev = kernel_device_ms(k9, ("reg_stage_kernel",), f"K9 level {label}", card)
        h_dev = kernel_device_ms(host, ("corr_kernel",), f"host loop level {label}", card)
        valid = float(C.corr3d(torch.ones_like(src), src, aff)[0])
        b4, b5 = (bound(8 * valid, CORR_OPS[g] * valid) for g in (True, False))
        lvl_bound = (st.evals[1] * b4[0] + st.evals[0] * b5[0],
                     b4[1] if st.evals[1] >= st.evals[0] else b5[1])
        print(f"  level {label} {shape}: K9 {k_s:.4f} s ({st.nev} evaluations: "
              f"{st.evals[1]} on K4's body, {st.evals[0]} on K5's; {RL.stage_count(a)} "
              f"launches; device {k_dev:.3f} ms, host share {1 - k_dev / 1e3 / k_s:.3f}), "
              f"host loop {h_s:.4f} s ({ref[3]} evaluations; K4/K5 device {h_dev:.3f} ms, "
              f"host share {1 - h_dev / 1e3 / h_s:.3f}); NCC {-float(st.fret):.7f} vs "
              f"{-float(ref[1]):.7f}, matrices {d_m:.4f} voxel apart, evaluations "
              f"{100 * d_ev:.1f}% apart; every evaluation's sums bit for bit a K4/K5 "
              f"launch, two K9 runs bit for bit; bound (K4/K5's bound x evaluations) "
              f"{lvl_bound[0]:.3f} ms [{card}]")
        if d_ev > K9_EVALS_SLACK or d_f > K9_NCC_TOL or d_m > K9_MATRIX_VOXELS:
            # reported when every phase has run (main raises on it)
            res["faults"].append(f"level {label}: K9 and the host loop disagree (evaluations "
                                 f"{100 * d_ev:.1f}% apart, NCC {d_f:.3g}, matrices "
                                 f"{d_m:.4f} voxel)")
            print(f"  FAIL: {res['faults'][-1]}")
        dump = os.environ.get("MIL_SMOKE_DUMP")
        if dump and math.prod(shape) <= K9_DUMP_VOXELS:
            os.makedirs(dump, exist_ok=True)
            args = dict(zip(("sd_t", "p_init12", "aff_method", "ftol", "it_limit", "engine",
                             "finish", "finish_sweeps", "ls_max_iters", "ls_patience"), knobs))
            args["p_init12"] = np.asarray(args["p_init12"], np.float32).tolist()
            np.savez_compressed(os.path.join(dump, "x".join(map(str, shape)) + ".npz"),
                                src=src.cpu().numpy(), tgt=tgt.cpu().numpy(),
                                knobs=json.dumps(args), label=str(label), k9_aff=aff,
                                k9_fret=np.float32(st.fret), k9_nev=st.nev, host_aff=ref[0],
                                host_fret=ref[1], host_nev=ref[3])
        key = "x".join(map(str, shape))
        res["levels"][key] = {"ms": k_s * 1e3, "plain_ms": h_s * 1e3, "device_ms": k_dev,
                              "plain_device_ms": h_dev, "evals": st.nev,
                              "plain_evals": int(ref[3]),
                              "split_us": {k: v for k, v in split.items() if v["n"]}}
        res["ms"] += k_s * 1e3
        res["plain_ms"] += h_s * 1e3
        res["bound"][0] += lvl_bound[0]
        res["bound"][1] = lvl_bound[1]
        res["max_abs_err"] = max(res["max_abs_err"], float(np.abs(aff - ref[0]).max()))
        res["fret_err"] = max(res["fret_err"], d_f)
        res["probe_levels"][key] = phase22_probes(call, knobs, sms, card, res)
    return res


def phase22_probes(call, knobs, sms, card, res):
    """Phase 22 at one level with MIL_REG_BATCH_LS=1: the ladder of both
    engines from the level's recorded start, K9 (its Powell stages over
    K6's body) against the host loop (one K6 launch and one sync a probe
    pass), with Phase 22's gates; every traced probe evaluation's sums bit
    for bit a K6 launch on its matrices; two K9 runs bit for bit; the split
    of K6's evaluations, the rows against a K6 launch's device time. Adds
    to ``res["faults"]``; returns the level's numbers per engine."""
    label, shape, _secs = call["level"]
    src, tgt = call["src"], call["tgt"]
    plan = C.launch_plan(shape, False, sms)
    at = RL.kernel_attrs(RL.BODIES["K6"], plan["vx"], plan["wide"])
    print(f"  level {label} {shape}: K9's probe stage kernel (K6 body, vx {plan['vx']}): "
          f"{at['registers']} registers, {at['spill_bytes']} B local a thread, "
          f"{at['static_smem']} B shared, {at['blocks_per_sm']} blocks/SM for a plan of "
          f"{plan['blocks']} blocks on {sms} SMs")
    if at["blocks_per_sm"] * sms < plan["blocks"]:
        raise AssertionError(f"level {label}: K9's probe blocks are not co-resident")
    out, k6_ms = {}, None
    for engine in ("grad", "device"):
        a = RL.args_of(call, engine=engine, batch_ls=True)
        kn = list(knobs)
        kn[5] = engine
        torch.cuda.synchronize()
        st, trace = RL.launch(src, tgt, a, trace_cap=K9_TRACE_CAP)
        n_ev = sum(st.evals)
        # a probe stage where the ladder has Powell stages: the device
        # engine's, the grad engine's finisher (off at some levels)
        probes = engine == "device" or bool(call["finish"])
        if (n_ev > K9_TRACE_CAP or len(trace) != n_ev or bool(st.evals[2]) != probes
                or st.evals[0]):
            raise AssertionError(f"level {label} {engine} batch_ls: evaluations {list(st.evals)},"
                                 f" {len(trace)} traced")
        st2, _ = RL.launch(src, tgt, a)
        if bytes(st) != bytes(st2):
            raise AssertionError(f"level {label} {engine} batch_ls: two K9 runs differ")
        bad, eights = 0, None
        for r in trace:
            mats, sums = RL.trace_matrices(r)
            if int(r[0]) == RL.BODIES["K6"]:
                got = C.corr3d_nprobe(src, tgt, mats).cpu().numpy().reshape(-1)
                if eights is None and len(mats) == 8:
                    eights = mats
            else:
                got = C.corr3d(src, tgt, mats[0], grad=bool(r[0])).cpu().numpy()
            bad += not np.array_equal(got.view(np.int64), sums.view(np.int64))
        if bad:
            raise AssertionError(f"level {label} {engine} batch_ls: {bad} of {n_ev} "
                                 "evaluations' sums differ from a K4/K6 launch")
        if k6_ms is None and eights is not None:
            k6_ms = call_device_ms(device_split(lambda: C.corr3d_nprobe(src, tgt, eights), 10,
                                                f"K6 level {label}", card))
        ref = RG.reg_ladder_host(src, tgt, *kn, batch_ls=True)
        aff = np.array(st.aff, np.float32)
        d_ev = abs(st.nev - ref[3]) / ref[3]
        d_f = abs(float(st.fret) - float(ref[1]))
        d_m = box_error(aff, ref[0], shape)
        same = (st.nev == ref[3] and np.float32(st.fret) == ref[1]
                and np.array_equal(aff, ref[0]))
        k_s = wall_s(lambda: RL.launch(src, tgt, a), 2)
        h_s = wall_s(lambda: RG.reg_ladder_host(src, tgt, *kn, batch_ls=True), 1)
        sp = RL.split_medians(trace, RL.BODIES["K6"])
        vs = (f"; rows {sp['rows'] / 1e3 / k6_ms:.2f}x an 8-probe K6 launch's device time "
              f"({k6_ms * 1e3:.1f} us)" if k6_ms and sp["n"] else "")
        print(f"  level {label} {shape} {engine} batch_ls: K9 {k_s:.4f} s ({st.nev} "
              f"evaluations: {st.evals[2]} K6 passes, {st.evals[1]} on K4's body; "
              f"{RL.stage_count(a)} launches), host loop {h_s:.4f} s ({ref[3]} evaluations); "
              f"NCC {-float(st.fret):.7f} vs {-float(ref[1]):.7f}, matrices {d_m:.4f} voxel "
              f"apart, bit for bit: {same}; every evaluation's sums bit for bit a K4/K6 "
              f"launch, two K9 runs bit for bit [{card}]")
        print(f"  level {label} {shape} {engine} batch_ls: K9 split, medians of {sp['n']} K6 "
              f"evaluations (us): rows {sp['rows']:.2f} (release {sp['release']:.2f}; other "
              f"blocks {sp['rows_others']:.2f}, block 0 {sp['rows_block0']:.2f}), hand-over "
              f"{sp['handover']:.2f}, column sum {sp['colsum']:.2f}, step {sp['step']:.2f}, "
              f"evaluation {sp['evaluation']:.2f}{vs} [{card}]")
        if d_ev > K9_EVALS_SLACK or d_f > K9_NCC_TOL or d_m > K9_MATRIX_VOXELS:
            res["faults"].append(f"level {label} {engine} batch_ls: K9 and the host loop "
                                 f"disagree (evaluations {100 * d_ev:.1f}% apart, NCC "
                                 f"{d_f:.3g}, matrices {d_m:.4f} voxel)")
            print(f"  FAIL: {res['faults'][-1]}")
        out[engine] = {"ms": k_s * 1e3, "plain_ms": h_s * 1e3, "evals": st.nev,
                       "k6_passes": st.evals[2], "plain_evals": int(ref[3]),
                       "bit_for_bit": bool(same), "k6_launch_ms": k6_ms, "split_us": sp}
    return out


def phasor_cases(vol, dev, card):
    """reg3d choice 1 on ``vol`` circularly shifted by each PHASOR_SHIFTS
    vector: the shift comes back exactly. Then max3d_with_coords on the
    card returns the first of tied maxima in C order, as torch.argmax's
    contract and the JAX package's jnp.argmax say."""
    sz, sy, sx = vol.shape
    for shift in PHASOR_SHIFTS:
        rolled = torch.roll(vol, shifts=(shift[2], shift[1], shift[0]), dims=(0, 1, 2))
        torch.cuda.synchronize()
        t = time.time()
        _, tmx, _ = R.reg3d(vol, rolled, reg_choice=1, device=dev, want_reg=False)
        wall = time.time() - t
        found = tuple(int(v) for v in (tmx[3], tmx[7], tmx[11]))
        wraps = [a for a, s, n in zip("xyz", shift, (sx, sy, sz)) if abs(s) > n // 4]
        print(f"  reg3d choice 1 (phasor) on the beads rolled by {shift} (x, y, z; past "
              f"size/4 on {wraps or 'no axis'}): found {found}, {wall:.3f} s [{card}]")
        if found != tuple(shift):
            raise AssertionError(f"phasor found {found}, the shift was {shift}")
        del rolled
    ties = torch.rand(vol.shape, device=dev)
    where = ((sz * 3 // 4, sy // 16, sx * 3 // 4), (sz // 8, sy - 12, 3),
             (sz // 8, sy - 13, sx - 1))
    for z, y, x in where:
        ties[z, y, x] = 2.0
    _, (x, y, z) = max3d_with_coords(ties)
    first = min(where)
    print(f"  max3d_with_coords on three tied maxima: (x, y, z) = ({int(x)}, {int(y)}, "
          f"{int(z)}), the first in C order is {first[::-1]}")
    if (int(z), int(y), int(x)) != first:
        raise AssertionError("max3d_with_coords did not return the first maximum on the card")


def phase11_reg_cli(dev):
    """reg3D CLI, -regc 2 -affm 7 -bit 16 -otmx, on 16-bit TIFFs."""
    shape = (200, 512, 512)
    print(f"Phase 11: reg3D CLI, two {shape[2]} x {shape[1]} x {shape[0]} "
          "16-bit TIFFs, -regc 2 -affm 7 -bit 16 -otmx")
    true_m = dof_to_matrix(REG_DOF, 6)
    vol = beads(shape, SEED + 2, dev) * 2000 + 100
    moved = affine_transform_3d(vol, true_m, shape)
    with tempfile.TemporaryDirectory() as tmp:
        f = {n: os.path.join(tmp, n) for n in ("t.tif", "s.tif", "r.tif", "m.tmx")}
        writetifstack(f["t.tif"], vol.cpu().numpy(), 16)
        writetifstack(f["s.tif"], moved.cpu().numpy(), 16)
        del vol, moved
        before = counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = reg3d_cli.main(["-t", f["t.tif"], "-s", f["s.tif"], "-o", f["r.tif"],
                                 "-regc", "2", "-affm", "7", "-bit", "16",
                                 "-otmx", f["m.tmx"], "-verbOFF"])
        if rc != 0:
            raise AssertionError(f"reg3D returned {rc}")
        for ln in buf.getvalue().splitlines():
            if "Time cost" in ln:
                print("  " + ln.strip("*").strip())
            if "image reading/writing" in ln:
                io_s = float(ln.split(":")[1].split()[0])
                print(f"  reg3D CLI TIFF seconds with the native codec: {io_s:.3f} s "
                      "(1.116 s on the NumPy codec: PERF.md section 5)")
        out, size = readtifstack_16to16(f["r.tif"])
        if out.shape != shape or out.dtype != np.uint16:
            raise AssertionError(f"reg3D output {out.shape} {out.dtype}")
        m = read_tmx(f["m.tmx"])
        err = box_error(m, inverse12(true_m), shape)
        n = {k: v - before[k] for k, v in counts().items()}
        print(f"  reg3D output {size} (x, y, z) uint16, launches {n}, matrix {err:.4f} "
              "voxel from the truth")
        if not on_k9(n) or err > 0.5:
            raise AssertionError("reg3D did not register on the kernels")
    torch.cuda.empty_cache()


def fusion_psfs():
    """The diSPIM views' 25^3 Gaussians: sigmas (z, y, x) (3.5, 1.2, 1.2)
    for view A (z reach 12 on the isotropic grid), (1.2, 1.2, 3.5) for B."""
    return (gauss3((25, 25, 25), (3.5, 1.2, 1.2)),
            gauss3((25, 25, 25), (1.2, 1.2, 3.5)))


def k2_bound(plan):
    """(ms, by) of one K2 launch: est and img read once, out written once;
    an fp32 multiply and add per tap and rank of both stages, plus the
    ratio, the product and the max per voxel."""
    n = int(np.prod(plan.shape))
    taps = sum(p.rank * (p.nsteps + p.ty.shape[1] + p.tx.shape[1])
               for p in (plan.fwd, plan.bp))
    return bound(3 * 4 * n, n * (2 * taps + 3))


def phase12_k2(dev, card):
    """K2 against its plain version and the K1 pair; its plan, peak memory
    and ms per launch at the fusion grid beside the K1 pair's. Returns K2's
    JSON numbers for view A's plan there."""
    print("Phase 12: rl_iter_fused kernel (K2) vs rl_iter_fused_torch and the K1 pair")
    pa, pb = fusion_psfs()
    r2 = gauss3((7, 9, 11), (1.0, 1.5, 2.0)) + 0.3 * gauss3((7, 9, 11), (2.0, 1.0, 0.8))
    # (name, psf, grid, group: 0 the plan's own)
    cases = [("bench 9^3", bench_psf(), K2_SMALL[0], 0),
             ("fusion A (z reach 12)", pa, K2_SMALL[0], 0),
             ("fusion B (x reach 12)", pb, K2_SMALL[0], 0),
             ("rank-2 pair", r2, K2_SMALL[0], 0),
             ("fusion A", pa, K2_SMALL[1], 0),
             ("fusion A, 8-plane groups", pa, K2_SMALL[2], 8),
             ("bench 9^3", bench_psf(), FUSION_SHAPE, 0),
             ("fusion A (z reach 12)", pa, FUSION_SHAPE, 0),
             ("fusion B (x reach 12)", pb, FUSION_SHAPE, 0)]
    res = {}
    for name, psf, shape, group in cases:
        plan = plan_rl_fused(psf, flip(psf), shape)
        if plan is None:
            raise AssertionError(f"{name} {shape}: plan_rl_fused refused")
        host, compiled = KF.launch_plan(plan, group=group), KF.kernel_plan(plan, group=group)
        if host != compiled:
            raise AssertionError(f"{name} {shape}: kernel plan {compiled}, host {host}")
        prng = np.random.default_rng(SEED + 12)
        est = torch.from_numpy(prng.random(shape, dtype=np.float32) * 100 + 1).to(dev)
        img = torch.from_numpy(prng.random(shape, dtype=np.float32) * 100 + 1).to(dev)
        before = KF.LAUNCHES
        out = KF.rl_iter_fused(est, img, plan, group=group)
        again = KF.rl_iter_fused(est, img, plan, group=group)
        torch.cuda.synchronize()
        if KF.LAUNCHES != before + 2:
            raise AssertionError(f"{name}: K2 launch count did not rise")
        if not torch.equal(out, again):
            raise AssertionError(f"{name} {shape}: two K2 launches differ")
        ref = KF.rl_iter_fused_torch(est, img, plan)
        err = float((out - ref).abs().max())
        m = float(ref.abs().max())
        del ref
        pair = K.conv3_sep(K.conv3_sep(est, plan.fwd, aux=img, mode="ratio"),
                           plan.bp, aux=est, mode="update")
        same = bool(torch.equal(out, pair))
        del out, again, pair
        attrs = KF.kernel_attrs(host)
        print(f"  {name} {shape}: ranks {plan.fwd.rank}/{plan.bp.rank}, z taps "
              f"{plan.fwd.nsteps}/{plan.bp.nsteps}, x taps {plan.fwd.tx.shape[1]}/"
              f"{plan.bp.tx.shape[1]}; vs plain {err:.6g} = {err / m:.3g} x max; "
              f"equals the K1 pair bit for bit: {same}; launch {KF.LAST_CONFIG}; "
              f"{attrs['registers']} registers ({attrs['spill_bytes']} bytes spilled)")
        if err > 2e-5 * m or not same:
            raise AssertionError(f"{name} {shape}: K2 disagrees")
        if shape == FUSION_SHAPE:
            torch.cuda.synchronize()
            t = time.perf_counter()
            KF.rl_iter_fused(est, img, plan)
            host_ms = (time.perf_counter() - t) * 1e3
            k_ms = cuda_ms(lambda: KF.rl_iter_fused(est, img, plan), 10)
            alone_ms = alone_cuda_ms(lambda: KF.rl_iter_fused(est, img, plan), 5)
            pair_ms = cuda_ms(lambda: K.conv3_sep(
                K.conv3_sep(est, plan.fwd, aux=img, mode="ratio"), plan.bp,
                aux=est, mode="update"), 10)
            plain_ms = cuda_ms(lambda: KF.rl_iter_fused_torch(est, img, plan), 2)
            peak = {}
            for what, fn in (("K2", lambda: KF.rl_iter_fused(est, img, plan)),
                             ("K1 pair", lambda: K.conv3_sep(
                                 K.conv3_sep(est, plan.fwd, aux=img, mode="ratio"),
                                 plan.bp, aux=est, mode="update"))):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                peak[what] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            b = k2_bound(plan)
            cfg = KF.LAST_CONFIG
            print(f"  K2 at {shape}, {name}: {k_ms:.4f} ms per launch ({alone_ms:.4f} "
                  f"ms for a launch alone), K1 ratio + update {pair_ms:.4f} ms "
                  f"({k_ms / pair_ms:.3f} x), plain {plain_ms:.3f} ms, bound "
                  f"{b[0]:.4f} ms ({b[1]}), {3 * 4 * est.numel() / k_ms / 1e6:.1f} GB/s "
                  f"of est + img + out; the launch call returns in {host_ms:.4f} ms "
                  f"on the host [{card}]")
            print(f"  K2 at {shape}, {name}: {cfg['group']}-plane groups, ratio store "
                  f"{cfg['head']} head planes + {cfg['ring']} ring planes = "
                  f"{cfg['store_bytes'] / 2 ** 20:.1f} MiB (ring {cfg['ring_bytes'] / 2 ** 20:.1f}"
                  f" MiB); peak device memory of one call {peak['K2']:.1f} MiB, of the "
                  f"K1 pair {peak['K1 pair']:.1f} MiB (out is "
                  f"{est.numel() * 4 / 2 ** 20:.1f} MiB) [{card}]")
            if cfg["store_bytes"] >= est.numel() * 4:
                raise AssertionError(f"{name}: the ratio store is a whole volume")
            if name.startswith("fusion A"):
                res = {"max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
                       "bound": b}
                device_split(lambda: KF.rl_iter_fused(est, img, plan), 5,
                             f"K2 at {shape}", card)
        del est, img
        torch.cuda.empty_cache()
    return res


def probe_matrices():
    """A line search's 8 probes (the ladder of ops/powell_device.py) along
    one direction from the reg128 truth, plus a wild 35-degree probe."""
    base = np.asarray(dof_to_matrix(REG_DOF, 6), np.float32)
    step = np.array([0.002, 0, 0.001, 0.5, 0, 0.001, 0, -0.3, 0, 0, 0.002, 0.2],
                    np.float32)
    mats = [base + np.float32(a) * step for a in LADDER]
    mats.append(np.asarray(dof_to_matrix([0, 0, 0, 35.0, 0, 0, 1, 1, 1], 6), np.float32))
    return np.stack(mats).astype(np.float32)


def phase13_k6(dev, card):
    """K6 against K5 per probe and its plain version at every level shape of
    the fusion's registration (Phase 14's main path) and at Phase 10's
    pyramid shapes; one 8-probe call against 8 K5 calls. Returns K6's JSON
    numbers per shape."""
    print("Phase 13: N-probe kernel (K6) vs K5 per probe and corr3d_nprobe_torch")
    mats = probe_matrices()
    eight = mats[:8]
    res = {}
    for shape in level_shapes(FUSION_SHAPE) + list(REG_LEVELS):
        prng = np.random.default_rng(SEED + 13)
        src = torch.from_numpy(prng.random(shape, dtype=np.float32)).to(dev)
        tgt = torch.from_numpy(prng.random(shape, dtype=np.float32)).to(dev)
        before = C.K6_LAUNCHES
        rows = C.corr3d_nprobe(src, tgt, mats).cpu().numpy()
        if C.K6_LAUNCHES - before != 2:     # 9 matrices: 8 + 1
            raise AssertionError("K6: launch count did not rise")
        if not np.array_equal(rows, C.corr3d_nprobe(src, tgt, mats).cpu().numpy()):
            raise AssertionError(f"K6 {shape}: two launches differ")
        for i, m in enumerate(mats):
            if not np.array_equal(rows[i], C.corr3d(src, tgt, m).cpu().numpy()):
                raise AssertionError(f"K6 {shape}: probe {i} differs from K5")
        plain = C.corr3d_nprobe_torch(src, tgt, mats).cpu().numpy()
        rel = float((np.abs(rows - plain) / np.abs(plain)).max())
        if rel > 1e-5:
            raise AssertionError(f"K6 {shape}: off its plain version by {rel}")
        k6_ms = cuda_ms(lambda: C.corr3d_nprobe(src, tgt, eight), 20)
        k5_ms = cuda_ms(lambda: [C.corr3d(src, tgt, m) for m in eight], 10)
        # as the optimizer calls them: one sync per call
        t = time.time()
        for _ in range(10):
            C.corr3d_nprobe(src, tgt, eight).cpu()
        k6_sync = (time.time() - t) * 100.0
        t = time.time()
        for _ in range(10):
            for m in eight:
                C.corr3d(src, tgt, m).cpu()
        k5_sync = (time.time() - t) * 100.0
        plain_ms = cuda_ms(lambda: C.corr3d_nprobe_torch(src, tgt, eight), 1)
        ones = torch.ones_like(src)
        valid = sum(float(C.corr3d_torch(ones, src, m)[0]) for m in eight)
        b = bound(8 * src.numel(), CORR_OPS[False] * valid)
        print(f"  K6 {shape}: 9 probes = K5 bit for bit, plain rel {rel:.3g}; 8 probes "
              f"{k6_ms:.4f} ms per call vs 8 K5 calls {k5_ms:.4f} ms (CUDA events), "
              f"{k6_sync:.4f} vs {k5_sync:.4f} ms with a sync per call (host clock); "
              f"plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}) [{card}]")
        res[shape] = {"max_abs_err": float(np.abs(rows - plain).max()), "ms": k6_ms,
                      "plain_ms": plain_ms, "bound": b}
        del src, tgt, ones
        torch.cuda.empty_cache()
    return res


def fusion_views(dev):
    """Raw views of a bead truth on the isotropic FUSION_SHAPE grid, as a
    diSPIM records them: A blurred by view A's PSF and sampled in z; B the
    truth moved by the reg128 matrix, blurred by view B's PSF, sampled
    along x (its detection axis) and turned +90 degrees about y, so that
    fusion's -90 degree turn and resample give it back on the isotropic
    grid unshifted. Both raw views are FUSION_RAW (1.0 um steps of
    0.1625 um pixels) in camera counts (x 2000 + 100). Returns
    (a_raw, b_raw) numpy float32."""
    pa, pb = fusion_psfs()
    truth = beads(FUSION_SHAPE, SEED + 14, dev)

    def blur(v, psf):
        otf = D.gen_otf(psf, FUSION_SHAPE, device=dev)
        return torch.fft.irfftn(torch.fft.rfftn(v) * otf, s=FUSION_SHAPE)

    a = resize3d_separable(blur(truth, pa), FUSION_RAW)
    moved = affine_transform_3d(truth, dof_to_matrix(REG_DOF, 6), FUSION_SHAPE)
    del truth
    nz, ny, nx = FUSION_SHAPE
    b = rot_by_y_axis(resize3d_separable(blur(moved, pb), (nz, ny, FUSION_RAW[0])), 1)
    del moved
    views = tuple((v * 2000 + FUSION_OFFSET).cpu().numpy() for v in (a, b))
    torch.cuda.empty_cache()
    return views


def reg_ncc(target, source, m):
    """The registration's own NCC of ``source`` moved by ``m`` against
    ``target`` (models/registration.py's cost: the mean-subtracted volumes'
    K5 sums, st / sqrt(ss) / sd of the target)."""
    src_ms, tgt_ms, _se2, st2 = R._reg_stats(source, target)
    ss, st = (float(v) for v in C.corr3d(src_ms, tgt_ms, np.asarray(m, np.float32)))
    return st / math.sqrt(ss) / math.sqrt(st2)


def zero_counts():
    K.LAUNCHES = KF.LAUNCHES = F.LAUNCHES = P.LAUNCHES = MR.LAUNCHES = 0
    F.LAUNCHES_SPECIALISED = dict.fromkeys("xyz", 0)
    C.K4_LAUNCHES = C.K5_LAUNCHES = C.K6_LAUNCHES = C.PLAIN_CALLS = 0
    RL.K9_LAUNCHES = RL.K9_EVALS_K4 = RL.K9_EVALS_K5 = RL.K9_EVALS_K6 = RL.K9_LINES = 0
    RG.HOST_LADDERS = RD.HOST_LADDERS = RD.HOST_LINES = 0


def counts():
    """The kernels' launch counters. K4, K5 and K6 count their own launches
    (the initial cost, the hybrid engine's start and extrapolation points,
    the host loop); K9 its stage launches (the hybrid engine's lines
    among them, K9_lines), K9_K4 / K9_K5 / K9_K6 the evaluations those
    launches ran on K4's / K5's / K6's body (a K6 pass: up to 8 matrices);
    ladder_plain the ladders run as a host loop, lines_plain the hybrid
    engine's lines run as a host loop, plain the K4/K5/K6 plain-version
    calls."""
    return {"K1": K.LAUNCHES, "K2": KF.LAUNCHES, "K3": F.LAUNCHES,
            "K4": C.K4_LAUNCHES, "K5": C.K5_LAUNCHES, "K6": C.K6_LAUNCHES,
            "K7": P.LAUNCHES, "K8": MR.LAUNCHES, "K9": RL.K9_LAUNCHES,
            "K9_K4": RL.K9_EVALS_K4, "K9_K5": RL.K9_EVALS_K5, "K9_K6": RL.K9_EVALS_K6,
            "K9_lines": RL.K9_LINES, "ladder_plain": RG.HOST_LADDERS + RD.HOST_LADDERS,
            "lines_plain": RD.HOST_LINES, "plain": C.PLAIN_CALLS}


def on_k9(n):
    """True where a run's registration ladders went through K9: K9 launched,
    with evaluations on both K4's and K5's bodies, no ladder on the host
    loop and no plain-version call."""
    return (n["K9"] > 0 and n["K9_K4"] > 0 and n["K9_K5"] > 0 and not n["ladder_plain"]
            and not n["plain"])


def corr_runs(n, kernel):
    """Passes of K4's (K5's, K6's) body in a run: its own launches and the
    evaluations K9 ran on it."""
    return n[kernel] + n[f"K9_{kernel}"]


def on_k9_probes(n):
    """True where a run's batch_ls ladders (MIL_REG_BATCH_LS=1, the grad
    engine) went through K9 with K6's body: K9 launched, with evaluations
    on K4's and K6's bodies, no K6 launch of its own, no ladder on the host
    loop and no plain-version call."""
    return (n["K9"] > 0 and n["K9_K4"] > 0 and n["K9_K6"] > 0 and not n["K6"]
            and not n["ladder_plain"] and not n["plain"])


FUSED_ON = {"MIL_CONV_SEP_FUSED": "1", "MIL_REG_BATCH_LS": "1"}
FUSED_OFF = {"MIL_CONV_SEP_FUSED": "0", "MIL_REG_BATCH_LS": "0"}


def phase14_fusion(dev, card):
    """The slice at full width: fusion_dualview with K2 and K6 on (the main
    path) and off. Returns the main run's K2 and K6 launch counts and the
    raw views."""
    print(f"Phase 14: fusion_dualview, raw views {FUSION_RAW} -> {FUSION_SHAPE}, "
          f"choice 2, method 7, {N_ITERS} iterations")
    pa, pb = fusion_psfs()
    t = time.time()
    a_raw, b_raw = fusion_views(dev)
    print(f"  views made in {time.time() - t:.3f} s")
    inv_true = inverse12(dof_to_matrix(REG_DOF, 6))
    route_b = auto_route([pa, pb], FUSION_SHAPE, dev)
    print(f"  MIL_CONV_SEP=auto takes the {route_b} route for the fusion PSFs")
    runs = {}
    for label, flags in (("a", FUSED_ON), ("b", FUSED_OFF)):
        torch.cuda.synchronize()
        rec = np.zeros(22)
        zero_counts()
        t = time.time()
        with env(**flags):
            decon, tmx, reg_b, a_iso = FU.fusion_dualview(
                a_raw, b_raw, pa, pb, FUSION_PIXEL, FUSION_PIXEL, -1, 2, 7,
                n_iters=N_ITERS, device=dev, mem_mode=1, records=rec)
        torch.cuda.synchronize()
        wall = time.time() - t
        n = counts()
        err = box_error(tmx, inv_true, FUSION_SHAPE)
        print(f"  ({label}) {flags}: {wall:.3f} s; steps: preprocess "
              f"{rec[21] - rec[7] - rec[20]:.3f} s, registration {rec[7]:.3f} s, "
              f"decon {rec[20]:.3f} s (iterations {rec[19]:.3f} s), total {rec[21]:.3f} s; "
              f"launches {n}; NCC {rec[3]:.6f} (initial {rec[1]:.6f}), "
              f"{err:.4f} voxel from the true matrix [{card}]")
        print(f"  ({label}) records {rec.tolist()}; matrix {np.round(tmx, 5).tolist()} "
              f"[{card}]")
        if decon.shape != FUSION_SHAPE or not np.isfinite(decon).all():
            raise AssertionError(f"({label}) fused volume bad: {decon.shape}")
        # (a): MIL_REG_BATCH_LS=1 runs the ladders in K9, the finisher's
        # line searches on K6's body (no K6 launch of its own, no host-loop
        # ladder); (b) runs them in K9 over K4/K5's bodies
        if label == "a" and (n["K2"] != 2 * N_ITERS or n["K1"] != 0
                             or not on_k9_probes(n)):
            raise AssertionError(f"(a) took the wrong kernels: {n}")
        want = {"separable": (4 * N_ITERS, 0), "K3": (0, 4 * N_ITERS),
                "torch.fft": (0, 0)}[route_b]
        if label == "b" and ((n["K1"], n["K3"]) != want or n["K2"] or n["K6"]
                             or not on_k9(n)):
            raise AssertionError(f"(b) took the wrong kernels for the {route_b} "
                                 f"route: {n}")
        runs[label] = (rec, tmx, reg_b, a_iso, n)
        del decon
    (rec_a, tmx_a, reg_b, a_iso, n_a), (rec_b, tmx_b, _, _, _) = runs["a"], runs["b"]
    runs_b_tmx, runs_b_ncc = tmx_b, rec_b[3]
    d_m = box_error(tmx_a, tmx_b, FUSION_SHAPE)
    print(f"  (a) vs (b): NCC {rec_a[3]:.6f} vs {rec_b[3]:.6f}, matrices {d_m:.4f} voxel "
          "apart over the central half-box")
    if abs(rec_a[3] - rec_b[3]) > 1e-3 or d_m > 0.5:
        raise AssertionError("the K6 and serial registrations disagree")
    # the truth gate (tests/test_torch_fusion.py's CPU check against the JAX
    # package): each run within FUSION_TRUTH_VOXELS of the true matrix, and
    # at least the true matrix's NCC on the registration's own cost
    views_iso = FU.preprocess_views(a_raw, b_raw, FUSION_PIXEL, FUSION_PIXEL, -1, dev,
                                    as_device=True)
    ncc_true = reg_ncc(*views_iso, inv_true)
    for label in ("a", "b"):
        tmx = runs[label][1]
        err, ncc = box_error(tmx, inv_true, FUSION_SHAPE), reg_ncc(*views_iso, tmx)
        print(f"  ({label}) truth gate: {err:.4f} voxel from the true matrix (gate "
              f"{FUSION_TRUTH_VOXELS}), NCC {ncc:.6f} at its matrix, {ncc_true:.6f} at "
              "the true one")
        if err > FUSION_TRUTH_VOXELS or ncc < ncc_true:
            raise AssertionError(f"({label}) the fusion's registration missed the truth "
                                 "gate")
    del views_iso
    outs = {}
    for label, flag in (("K2", "1"), ("K1 pair", "0")):
        with env(MIL_CONV_SEP_FUSED=flag, MIL_CONV_SEP="1"):
            outs[label] = D.decon_dualview(a_iso, reg_b, pa, pb, n_iters=N_ITERS,
                                           device=dev, mem_mode=1)
    check_close("decon of one registered pair, K2 vs K1 pair", outs["K2"],
                outs["K1 pair"], 2e-4, 2e-4)
    print(f"  bit for bit: {bool(np.array_equal(outs['K2'], outs['K1 pair']))}")
    del outs, runs

    a_d = torch.from_numpy(a_iso).to(dev)
    fa = plan_rl_fused(pa, flip(pa), FUSION_SHAPE)
    fb = plan_rl_fused(pb, flip(pb), FUSION_SHAPE)
    otfs = [D.gen_otf(p, FUSION_SHAPE, device=dev) for p in (pa, pb, flip(pa), flip(pb))]
    ms = {"K2": cuda_ms(lambda: D._rl_dual_sep_fused(a_d, reg_b, fa, fb, N_ITERS,
                                                      False), 2) / N_ITERS,
          "K1 pair": cuda_ms(lambda: D._rl_dual_sep(a_d, reg_b, fa.fwd, fa.bp, fb.fwd,
                                                    fb.bp, N_ITERS, False), 2) / N_ITERS,
          "K3": cuda_ms(lambda: D._rl_dual(a_d, reg_b, *otfs, N_ITERS, False,
                                           "ct"), 2) / N_ITERS,
          "torch.fft": cuda_ms(lambda: D._rl_dual(a_d, reg_b, *otfs, N_ITERS, False,
                                                  "torch"), 2) / N_ITERS}
    print(f"  ms per dual-view iteration {FUSION_SHAPE}, fusion PSFs [{card}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    check_auto_route(route_b, FUSION_SHAPE, dev, ms["K1 pair"], ms["K3"], ms["torch.fft"],
                     "fusion PSFs")
    del otfs, reg_b
    torch.cuda.empty_cache()
    k6_shapes = reg_levels(dev, a_raw, b_raw, card)
    return ({"k2": n_a["K2"], "k6": n_a["K6"], "k9_k6": n_a["K9_K6"], "k6_shapes": k6_shapes,
             "tmx_b": runs_b_tmx, "ncc_b": runs_b_ncc}, (a_raw, b_raw))


def reg_levels(dev, a_raw, b_raw, card):
    """Per pyramid level of the fusion's registration: syncs, evaluations
    and host share, with K6's body (MIL_REG_BATCH_LS=1) and without.
    Returns the shapes of the levels where K6's body ran (in K9)."""
    a_iso, b_iso = FU.preprocess_views(a_raw, b_raw, FUSION_PIXEL, FUSION_PIXEL, -1,
                                       dev, as_device=True)
    k6_shapes = []
    for label, flag in (("with K6", "1"), ("serial", "0")):
        levels = []

        def on_level(name, shape, secs):
            levels.append((name, shape, secs, counts()))

        torch.cuda.synchronize()
        zero_counts()
        t = time.time()
        with env(MIL_REG_BATCH_LS=flag):
            _, tmx, rec = R.reg3d(a_iso, b_iso, 2, 7, device=dev, want_reg=False,
                                  on_level=on_level)
        wall = time.time() - t
        print(f"  registration {label}: {wall:.3f} s, NCC {rec[3]:.6f}, launches "
              f"{counts()} [{card}]")
        prev = dict.fromkeys(counts(), 0)
        for name, shape, secs, n in levels:
            d = {k: n[k] - prev[k] for k in n}
            prev = n
            # K9 evaluations count with their bodies; a K9 ladder syncs once
            d4, d5, d6 = corr_runs(d, "K4"), corr_runs(d, "K5"), corr_runs(d, "K6")
            syncs = d["K4"] + d["K5"] + d["K6"] + (d["K9"] > 0)
            if d6:
                k6_shapes.append(tuple(shape))
            factor = tuple(s // t for s, t in zip(FUSION_SHAPE, shape))
            src = R._mean_pool(a_iso, factor) if shape != FUSION_SHAPE else a_iso
            tgt = torch.roll(src, 1, 2).contiguous()
            m = R._tmx_full_to_coarse(tmx, factor)
            eight = np.stack([m] * 8)
            t4, t5, t6 = (call_device_ms(device_split(fn, 10, f"{k} level {name}", card))
                          for k, fn in (("K4", lambda: C.corr3d(src, tgt, m, grad=True)),
                                        ("K5", lambda: C.corr3d(src, tgt, m, grad=False)),
                                        ("K6", lambda: C.corr3d_nprobe(src, tgt, eight))))
            kern_ms = d4 * t4 + d5 * t5 + d6 * t6
            print(f"    level {name} {shape}: {syncs} syncs, {d4 + d5 + d6} passes "
                  f"({d4} K4, {d5} K5, {d6} K6 of up to 8 matrices; {d['K9']} K9 "
                  f"launches), "
                  f"{secs:.3f} s, kernel "
                  f"{kern_ms:.3f} ms, host share {1 - kern_ms / 1e3 / secs:.3f} (device "
                  f"K4 {t4:.4f}, K5 {t5:.4f}, K6 {t6:.4f} ms per launch) [{card}]")
            del src, tgt
    del a_iso, b_iso
    torch.cuda.empty_cache()
    return k6_shapes


def phase15_fusion_cli(views, card):
    """spimFusion CLI on the Phase 14 views as 16-bit TIFFs, -bit 16 -otmx,
    with K2 and K6's body on (MIL_REG_BATCH_LS=1: in K9)."""
    print(f"Phase 15: spimFusion CLI, raw {FUSION_RAW[2]} x {FUSION_RAW[1]} x "
          f"{FUSION_RAW[0]} 16-bit TIFFs, -bit 16 -otmx, K2 and K6 on")
    pa, pb = fusion_psfs()
    with tempfile.TemporaryDirectory() as tmp:
        f = {n: os.path.join(tmp, n) for n in ("a.tif", "b.tif", "pa.tif", "pb.tif",
                                                 "out.tif", "m.tmx")}
        writetifstack(f["a.tif"], views[0], 16)
        writetifstack(f["b.tif"], views[1], 16)
        writetifstack(f["pa.tif"], pa, 32)
        writetifstack(f["pb.tif"], pb, 32)
        zero_counts()
        buf = io.StringIO()
        t = time.time()
        with env(**FUSED_ON), contextlib.redirect_stdout(buf):
            rc = fusion_cli.main(["-i1", f["a.tif"], "-i2", f["b.tif"], "-fp1", f["pa.tif"],
                                  "-fp2", f["pb.tif"], "-o", f["out.tif"], "-regc", "2",
                                  "-affm", "7", "-it", str(N_ITERS), "-bit", "16",
                                  "-otmx", f["m.tmx"], "-verbOFF"])
        wall = time.time() - t
        if rc != 0:
            raise AssertionError(f"spimFusion returned {rc}")
        for ln in buf.getvalue().splitlines():
            if "time cost" in ln.lower():
                print("  " + ln.strip("=* ").strip())
        out, size = readtifstack_16to16(f["out.tif"])
        n = counts()
        tmx = read_tmx(f["m.tmx"])
        err = box_error(tmx, inverse12(dof_to_matrix(REG_DOF, 6)), FUSION_SHAPE)
        print(f"  spimFusion output {size} (x, y, z) {out.dtype}, {wall:.3f} s in main(), "
              f"launches {n}, matrix {err:.4f} voxel from the true one [{card}]")
        if out.shape != FUSION_SHAPE or out.dtype != np.uint16 or not out.any():
            raise AssertionError(f"spimFusion output {out.shape} {out.dtype}")
        # the ladders in K9, the finisher's line searches on K6's body
        if n["K2"] != 2 * N_ITERS or n["K1"] or not on_k9_probes(n):
            raise AssertionError(f"spimFusion took the wrong kernels: {n}")
    torch.cuda.empty_cache()


def k7_times(v, aux, shift, card):
    """K7 at ``v``'s shape against ``torch.add(aux, v, alpha=1e-6)`` (the
    PyTorch call for the same function at shift 0, within 1 ulp: it need
    not round as one FMA), then ms per call of both geometries and that
    call (the least of three rounds in turns) and of the plain version."""
    n_vox = v.numel()
    lib = torch.add(aux, v, alpha=1e-6)
    d = (P.pipe_copy(v, aux, 0) - lib).abs()
    ulps = float((d / (torch.nextafter(lib.abs(), torch.full_like(lib, math.inf))
                       - lib.abs())).max())
    print(f"  torch.add(aux, v, alpha=1e-6) vs K7 at shift 0, {tuple(v.shape)}: "
          f"{int((d > 0).sum())} voxels differ, at most {ulps:.3g} ulp (tolerance 1 ulp)")
    if ulps > 1:
        raise AssertionError("K7 and torch.add differ by more than 1 ulp")
    del lib, d
    # three rounds of the two geometries and torch.add in turns, the least
    # of each: the card's clock drifts a few percent within a call
    rounds = [{**{g: cuda_ms(lambda: P.pipe_copy(v, aux, shift, g), 20) for g in P.GEOMETRIES},
               "add": cuda_ms(lambda: torch.add(aux, v, alpha=1e-6), 20)} for _ in range(3)]
    ms = {k: min(r[k] for r in rounds) for k in rounds[0]}
    lib_ms = ms["add"]
    plain_ms = cuda_ms(lambda: P.pipe_copy_torch(v, aux, shift), 2)
    b = bound(3 * 4 * n_vox, n_vox)
    print(f"  K7 at {tuple(v.shape)} shift {shift}: z geometry {ms['z']:.4f} ms "
          f"({12 * n_vox / ms['z'] / 1e6:.1f} GB/s), xy geometry {ms['xy']:.4f} ms "
          f"({12 * n_vox / ms['xy'] / 1e6:.1f} GB/s); torch.add {lib_ms:.4f} ms "
          f"({12 * n_vox / lib_ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]}) [{card}]")
    return {"ms": ms["xy"], "plain_ms": plain_ms, "bound": b, "library_ms": lib_ms}


def phase16_roofline(dev, card):
    """K7 against its plain version at PIPE_COPY_CASES and timed at 512^3;
    then the roofline tool at 512^3, its path's run, with the counts zeroed
    before it. Returns K7's JSON numbers."""
    print("Phase 16: pipe_copy kernel (K7) vs pipe_copy_torch; the conv_roofline "
          "tool at 512^3")
    t16 = time.time()
    err = 0.0
    for shape, shift in PIPE_COPY_CASES:
        prng = np.random.default_rng(SEED + 16)
        v = torch.from_numpy(prng.random(shape, dtype=np.float32) * 100 + 1).to(dev)
        aux = torch.from_numpy(prng.random(shape, dtype=np.float32) * 100 + 1).to(dev)
        ref = P.pipe_copy_torch(v, aux, shift)
        for geometry in P.GEOMETRIES:
            before = P.LAUNCHES
            out = P.pipe_copy(v, aux, shift, geometry)
            again = P.pipe_copy(v, aux, shift, geometry)
            torch.cuda.synchronize()
            if P.LAUNCHES != before + 2:
                raise AssertionError(f"K7 {shape}: launch count did not rise")
            if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"K7 {shape} {geometry}: two launches differ")
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"K7 {shape} shift {shift} {geometry}: differs "
                                     "from pipe_copy_torch")
            err = max(err, float((out - ref).abs().max()))
        print(f"  K7 {shape} shift {shift}: geometries z and xy equal pipe_copy_torch "
              "bit for bit, two launches identical")
        del out, again, ref
        if shape == (512, 512, 512):
            timed = k7_times(v, aux, shift, card)
        del v, aux
        torch.cuda.empty_cache()

    zero_counts()
    buf = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        rc = conv_roofline.main(["--size", "512"])
    torch.cuda.synchronize()
    wall = time.time() - t
    n = counts()
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print("  " + ln)
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    bad = [r["metric"] for r in rows if not (math.isfinite(r["value"]) and r["value"] > 0)]
    print(f"  conv_roofline: {len(rows)} metrics in {wall:.3f} s, launches {n}")
    if rc != 0 or [r["metric"] for r in rows] != list(conv_roofline.METRICS) or bad:
        raise AssertionError(f"conv_roofline: rc {rc}, {len(rows)} metrics, bad {bad}")
    if n["K7"] == 0 or n["K1"] == 0:
        raise AssertionError(f"conv_roofline did not run on K1 and K7: {n}")
    torch.cuda.empty_cache()
    print(f"  Phase 16 took {time.time() - t16:.3f} s")
    return dict(timed, launches=n["K7"], max_abs_err=err)


# the paths K1's switches force, each held bit for bit to the plan's own:
# z taps from device memory (no ring); the generic instantiation
K1_FORCED = (K.NO_RING, K.GENERIC)


def k1_kernel_plan(plan):
    """The compiled kernel's launch plan for ``plan`` on this card's SM count,
    beside which K.plan_of (the host's) must match."""
    dy0, dy1, dx0, dx1 = K._roll_span(plan)
    return K.kernel_plan(plan.shape, plan.rank, plan.nsteps, plan.ty.shape[1],
                         plan.tx.shape[1], dy1 - dy0, dx1 - dx0)


def auto_route(psfs, shape, dev):
    """The route MIL_CONV_SEP=auto takes on a CUDA volume of ``shape`` for
    these PSFs with their flips as back projectors: 'separable' where
    every view plans it, else the FFT route's convolution."""
    probe = torch.empty(0, device=dev)
    if all(D._sep_plans(p, flip(p), shape, probe) is not None for p in psfs):
        return "separable"
    return {"ct": "K3", "torch": "torch.fft"}[D._fft_impl(shape, probe)]


def check_auto_route(route, shape, dev, k1_ms, k3_ms, torch_ms, label):
    """Fail unless ``route`` (auto_route's word for what MIL_CONV_SEP=auto
    takes) is the faster, in this run, of the K1 route and the FFT route
    that _fft_impl takes on ``shape``."""
    fft = {"ct": "K3", "torch": "torch.fft"}[D._fft_impl(shape, torch.empty(0, device=dev))]
    fft_ms = k3_ms if fft == "K3" else torch_ms
    fastest = "separable" if k1_ms < fft_ms else fft
    print(f"  {label}: auto takes the {route} route; measured K1 {k1_ms:.3f} ms against "
          f"{fft} {fft_ms:.3f} ms an iteration")
    if route != fastest:
        raise AssertionError(f"{label}: auto takes the {route} route, the {fastest} route "
                             f"ran faster")


# Phase 2's route ladder: rank-1 Gaussians (size, sigmas) whose plans run
# K1's generic instantiation at tap costs 9 to 45 (the points that set
# SEP_MAX_TAP_COST's generic ceilings), and the dual-view PSF of view A
# (cost 55) on its specialised one; at 512^3 all of them, at LADDER_GRID2
# (Phase 20 (b)'s grid, of K3's length 640) the generic costs 9, 15, 21 and
# 33 and the specialised 27 (the bench PSF) and 55
ROUTE_LADDER = (((3, 3, 3), (0.6,) * 3), ((5, 5, 5), (0.8,) * 3),
                ((7, 7, 7), (1.1,) * 3), ((11, 11, 11), (1.6,) * 3),
                ((17, 9, 9), (2.5, 1.5, 1.5)), ((13, 13, 13), (2.0,) * 3),
                ((15, 15, 15), (2.2,) * 3), ((25, 25, 25), (3.5, 1.2, 1.2)))
LADDER_GRID2 = (192, 640, 640)
# the ladder's gate: the route the rule picks within this factor of the
# faster of K1 and each FFT route (routes within a few percent of each
# other swap between runs; Phase 5's ladder gate is the same 10%)
ROUTE_GATE = 1.10


def route_ladder(img_d, fft_ms, card, psfs):
    """ms per RL iteration of the K1 route for each PSF on the device image
    ``img_d``, beside the K3 and torch.fft routes' (``fft_ms``, keyed 'ct'
    and 'torch': PSF-independent), with the route sep_auto_takes picks
    against each FFT route. Fails where the pick is slower than ROUTE_GATE
    x the faster of the two (the rule's ceilings must then move)."""
    shape = tuple(img_d.shape)
    bad = []
    for psf in psfs:
        with env(MIL_CONV_SEP="1"):
            pair = D._sep_plans(psf, flip(psf), shape)[1]
        k1 = cuda_ms(lambda: D._rl_single_sep(img_d, *pair, 2, False), 2) / 2
        spec = all(D.k1_specialised(p) for p in pair)
        picks = {impl: D.sep_auto_takes(pair, impl) for impl in fft_ms}
        right = {impl: picks[impl] == (k1 < fft_ms[impl]) for impl in fft_ms}
        print(f"  route ladder {shape} {psf.shape}: tap cost {D.tap_cost(pair[0])}, "
              f"{'specialised' if spec else 'generic'}; K1 route {k1:.3f} ms an iteration "
              f"(K3 {fft_ms['ct']:.3f}, torch.fft {fft_ms['torch']:.3f}); auto takes K1 "
              f"against K3 {picks['ct']}, against torch.fft {picks['torch']}; "
              f"agrees with the times {right} [{card}]")
        for impl, pick in picks.items():
            taken = k1 if pick else fft_ms[impl]
            if taken > ROUTE_GATE * min(k1, fft_ms[impl]):
                bad.append((shape, psf.shape, D.tap_cost(pair[0]), impl))
    if bad:
        raise AssertionError(f"SEP_MAX_TAP_COST {D.SEP_MAX_TAP_COST} picks a route slower "
                             f"than {ROUTE_GATE} x the faster at {bad}")


def route_ladder_grid2(dev, card):
    """Phase 2's route ladder on LADDER_GRID2: the K3 and torch.fft routes'
    ms per iteration there, then route_ladder on the generic costs 9, 15,
    21 and 33 and the specialised 27 and 55."""
    rng = np.random.default_rng(SEED + 2)
    img_d = torch.from_numpy(rng.random(LADDER_GRID2, dtype=np.float32) * 100 + 1).to(dev)
    psf = bench_psf()
    otf = D.gen_otf(psf, LADDER_GRID2, device=dev)
    otf_bp = D.gen_otf(flip(psf), LADDER_GRID2, device=dev)
    fft_ms = {impl: cuda_ms(lambda: D._rl_single(img_d, otf, otf_bp, N_ITERS, False, impl),
                            2) / N_ITERS for impl in ("ct", "torch")}
    del otf, otf_bp
    route = D._fft_impl(LADDER_GRID2, img_d)
    print(f"  route ladder at {LADDER_GRID2}: the FFT route takes {route}; ms per RL "
          f"iteration K3 {fft_ms['ct']:.3f}, torch.fft {fft_ms['torch']:.3f} [{card}]")
    psfs = [gauss3(*c) for c in ROUTE_LADDER[:4]] + [psf, gauss3(*ROUTE_LADDER[-1])]
    route_ladder(img_d, fft_ms, card, psfs)
    del img_d
    torch.cuda.empty_cache()


def k1_report(v, plan, aux, k_ms, card, label):
    """K1 at ``v``'s shape in ratio mode: its launch plan and what the
    instantiation compiled to, the peak device memory of one call beside
    ``out``'s bytes, its time against the z-shaped K7 copy (read v and aux,
    write out: the traffic K1 needs) and the device time of its one launch
    (torch.profiler)."""
    pl = K.plan_of(plan)
    if pl != k1_kernel_plan(plan):
        raise AssertionError(f"K1 {label}: kernel plan {k1_kernel_plan(plan)}, host {pl}")
    attrs = K.kernel_attrs(pl)
    print(f"  K1 {label}: plan {pl}; {attrs['registers']} registers "
          f"({attrs['spill_bytes']} bytes spilled) a thread, {attrs['blocks_per_sm']} "
          f"resident blocks of {K.THREADS} threads per SM [{card}]")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = K.conv3_sep(v, plan, aux=aux, mode="ratio")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    out_bytes = out.numel() * 4
    del out
    print(f"  K1 {label}: one call's peak device memory {peak / 2 ** 20:.1f} MiB "
          f"(out is {out_bytes / 2 ** 20:.1f} MiB; the two-launch version added "
          f"{plan.rank} x {out_bytes / 2 ** 20:.1f} MiB of rank volumes)")
    if peak > out_bytes + 2 ** 20:
        raise AssertionError(f"K1 {label}: a call allocated {peak} bytes, out {out_bytes}")
    c_ms = cuda_ms(lambda: P.pipe_copy(v, aux, plan.b, "z"), 20)
    print(f"  K1 {label}: {k_ms:.4f} ms against the z-shaped K7 copy's {c_ms:.4f} ms "
          f"({12 * v.numel() / c_ms / 1e6:.1f} GB/s): {100 * c_ms / k_ms:.1f}% of the "
          f"copy ceiling [{card}]")
    device_split(lambda: K.conv3_sep(v, plan, aux=aux, mode="ratio"), 10, f"K1 {label}",
                 card)
    return c_ms


def rl_iteration_ms(img_d, psf, fwd, bp, card, label):
    """ms per RL iteration on the padded device image for the K1 route,
    the plain separable version, the K3 route and the ``torch.fft`` route
    (one card, one process, CUDA events)."""
    def sep():
        D._rl_single_sep(img_d, fwd, bp, N_ITERS, False)

    def plain():
        img = img_d.clamp_min(D.SMALLVALUE)
        est = img
        for _ in range(2):
            ratio = K.conv3_sep_torch(est, fwd, aux=img, mode="ratio")
            est = K.conv3_sep_torch(ratio, bp, aux=est, mode="update",
                                    smallvalue=D.SMALLVALUE)

    shape = tuple(img_d.shape)
    otf = D.gen_otf(psf, shape, device=img_d.device)
    otf_bp = D.gen_otf(flip(psf), shape, device=img_d.device)

    def fft(impl):
        return lambda: D._rl_single(img_d, otf, otf_bp, N_ITERS, False, impl)

    res = {"kernel_route": cuda_ms(sep, 2) / N_ITERS,
           "plain_separable": cuda_ms(plain, 1) / 2,
           "k3_route": cuda_ms(fft("ct"), 2) / N_ITERS,
           "torch_fft_route": cuda_ms(fft("torch"), 2) / N_ITERS}
    print(f"  ms per RL iteration, {label} [{card}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.items()))
    return res

STAGES = ("read", "wait", "preprocess", "registration", "decon", "mp", "fetch", "write")


class TimepointCounts:
    """Snapshots of the kernel counters at the start of each batch
    timepoint (the batch isotropizes every timepoint's views first), so a
    run's launches split by timepoint."""

    def __init__(self):
        self.snaps = []
        self._orig = PB.preprocess_views

    def __enter__(self):
        def snap(*args, **kw):
            torch.cuda.synchronize()
            self.snaps.append(counts())
            return self._orig(*args, **kw)

        PB.preprocess_views = snap
        return self

    def __exit__(self, *exc):
        PB.preprocess_views = self._orig

    def per_timepoint(self, total):
        """Launches between consecutive snapshots, the last to ``total``."""
        ends = self.snaps[1:] + [total]
        return [{k: e[k] - b[k] for k in total} for b, e in zip(self.snaps, ends)]


class LaunchShapes:
    """The shapes at which K1, K3, K4 and K5 launch while it is entered
    (their wrappers' ``_launch``, where each counts a launch), K9's ladders
    under K4 and K5 as they ran each body."""

    def __init__(self):
        self.shapes = {k: set() for k in CHECKED}
        self._orig = []

    def __enter__(self):
        for mod, kernel in ((K, lambda *a: "K1"), (F, lambda *a: "K3"),
                            (C, lambda src, tgt, tmx, grad: "K4" if grad else "K5")):
            def launch(*args, _orig=mod._launch, _kernel=kernel):
                self.shapes[_kernel(*args)].add(tuple(args[0].shape))
                return _orig(*args)

            self._orig.append((mod, "_launch", mod._launch))
            mod._launch = launch

        def ladder(src, tgt, args, trace_cap=0, _orig=RL.launch):
            out = _orig(src, tgt, args, trace_cap)
            for kernel, n in (("K5", out[0].evals[0]), ("K4", out[0].evals[1])):
                if n:
                    self.shapes[kernel].add(tuple(src.shape))
            return out

        self._orig.append((RL, "launch", RL.launch))
        RL.launch = ladder
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._orig:
            setattr(mod, name, orig)

    def check(self, label):
        """Fail unless every launch shape was held against the plain version."""
        unchecked = {k: sorted(v - CHECKED[k]) for k, v in self.shapes.items()
                     if v - CHECKED[k]}
        if unchecked:
            raise AssertionError(f"{label} launched kernels at shapes no phase held "
                                 f"against their plain versions: {unchecked}")
        print(f"  {label} launched at {({k: sorted(v) for k, v in self.shapes.items() if v})}"
              f", each held against its plain version in Phase 1, 5 or 9")


class PlainMips:
    """Counts the rotating MIP's plain routes (gather, one-hot matmul, the
    factored contraction) while it is entered."""

    def __init__(self):
        self.calls = 0
        self._orig = []

    def __enter__(self):
        for mod, name in ((PP, "_rotate_and_mip_all"), (PP, "_rotate_and_mip_all_matmul"),
                          (MR, "mip_rot_torch")):
            def counted(*args, _orig=getattr(mod, name), **kw):
                self.calls += 1
                return _orig(*args, **kw)

            self._orig.append((mod, name, getattr(mod, name)))
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._orig:
            setattr(mod, name, orig)


def print_timepoints(label, timings, launches, card):
    """Per timepoint the stage seconds of spim_fusion_batch's ``timings`` and
    the launches of TimepointCounts; regMode 1's test registration first."""
    if len(launches) > len(timings):
        t = min(timings)
        print(f"  ({label}) test registration on timepoint {t}: "
              f"{timings[t].get('test registration', 0.0):.3f} s; launches "
              f"{launches[0]} [{card}]")
        launches = launches[1:]
    for t, n in zip(sorted(timings), launches):
        st = timings[t]
        steps = ", ".join(f"{k} {st.get(k, 0.0):.3f}" for k in STAGES)
        print(f"  ({label}) timepoint {t}: seconds {steps}; launches {n} [{card}]")


def decon_launches(route, n_tp):
    """(K1, K3) launches of n_tp dual-view decons of N_ITERS iterations on
    auto's route: two K1 launches, or two K3 calls, per view and iteration."""
    return {"separable": (4 * N_ITERS * n_tp, 0), "K3": (0, 4 * N_ITERS * n_tp)}[route]


def write_series(tmp, views, dev):
    """Phase 14's raw views as a BATCH_TPS-timepoint series of 16-bit TIFFs
    under ``tmp`` (SPIMA/SPIMA_t.tif, SPIMB/SPIMB_t.tif; view B moved by
    BATCH_DRIFT from t = 1) and the fusion PSFs (pa.tif, pb.tif)."""
    pa, pb = fusion_psfs()
    for d in ("SPIMA", "SPIMB"):
        os.makedirs(os.path.join(tmp, d))
    a_raw, b_raw = views
    drifted = affine_transform_3d(torch.from_numpy(b_raw).to(dev),
                                  dof_to_matrix(BATCH_DRIFT, 6), b_raw.shape).cpu().numpy()
    for t in range(BATCH_TPS):
        writetifstack(os.path.join(tmp, "SPIMA", f"SPIMA_{t}.tif"), a_raw, 16)
        writetifstack(os.path.join(tmp, "SPIMB", f"SPIMB_{t}.tif"),
                      b_raw if t == 0 else drifted, 16)
    writetifstack(os.path.join(tmp, "pa.tif"), pa, 32)
    writetifstack(os.path.join(tmp, "pb.tif"), pb, 32)


def phase17_batch(dev, card, views):
    """The time-lapse batch at full width: (a) the end-to-end surrogate
    in-process, (b) Phase 14's views as a two-timepoint series through
    regMode 3 (2-D MIP start) and regMode 1 (phasor start). Returns the
    kernel launches of (a), the main path's run."""
    print(f"Phase 17: spimFusionBatch at full width [{card}]")
    # ---- (a) the end-to-end surrogate ----
    grid = (E2E_XY,) * 3
    route = auto_route([E2E.curved_tilted_psf()], grid, dev)
    print(f"  (a) e2e surrogate, --xy {E2E_XY} (raw A ({math.ceil(E2E_XY * 0.1625)}, "
          f"{E2E_XY}, {E2E_XY}), grid {grid}), {E2E_TPS} timepoints, regMode 2, bg "
          f"{E2E.BASELINE_OFFSET:g}, {N_ITERS} iterations, MP_ZProj + MP_3D_Yaxis 16-bit; "
          f"auto takes the {route} route for the curved PSF")
    if route == "torch.fft":
        raise AssertionError("(a): the batch decon would launch no kernel")
    timings = {}
    torch.cuda.synchronize()
    zero_counts()
    buf = io.StringIO()
    with TimepointCounts() as tc, LaunchShapes() as shapes_a, PlainMips() as plain_mips, \
            contextlib.redirect_stdout(buf):
        res = E2E.run(E2E_TPS, E2E_XY, device=dev, timings=timings)
    torch.cuda.synchronize()
    total = counts()
    for ln in buf.getvalue().splitlines():
        if "Time cost for current image" in ln or "Processed" in ln:
            print("  (a) " + ln.strip("."))
    per_tp = tc.per_timepoint(total)
    print(f"  (a) instrumented (stages synchronized): {res['wall_s']:.3f} s in the batch "
          f"for {E2E_TPS} timepoints, {res['tp_per_min']:.3f} tp/min (inputs built in "
          f"{res['build_s']:.3f} s); final NCCs {[round(v, 6) for v in res['nccs']]}; "
          f"launches {total} [{card}]")
    print_timepoints("a", timings, per_tp, card)
    k1, k3 = decon_launches(route, E2E_TPS)
    if (not on_k9(total) or total["K1"] != k1 or total["K3"] != k3
            or len(per_tp) != E2E_TPS):
        raise AssertionError(f"(a) took the wrong kernels for the {route} route: {total}")
    # one K8 launch per rotating MIP: the surrogate saves MP_3D_Yaxis alone
    if total["K8"] != E2E_TPS * E2E_MIP_AXES or plain_mips.calls:
        raise AssertionError(f"(a) rotating MIPs: {total['K8']} K8 launches for "
                             f"{E2E_TPS * E2E_MIP_AXES} MIPs, plain MIP calls "
                             f"{plain_mips.calls}")
    shapes_a.check("(a)")
    # the same run with no timings, no counter snapshots and no shape
    # records: the batch's own throughput
    with contextlib.redirect_stdout(io.StringIO()):
        res_own = E2E.run(E2E_TPS, E2E_XY, device=dev)
    print(f"  (a) uninstrumented, after the run above: {res_own['wall_s']:.3f} s in the "
          f"batch for {E2E_TPS} timepoints, {res_own['tp_per_min']:.3f} tp/min; final "
          f"NCCs {[round(v, 6) for v in res_own['nccs']]} [{card}]")
    est = torch.rand(grid, device=dev) * 100
    frames = PP.mip3d_frames(est, 2, 36)
    mip_ms = alone_cuda_ms(lambda: PP.mip3d_frames(est, 2, 36), 5)
    gather_ms = alone_cuda_ms(lambda: PP.mip3d_frames(est, 2, 36, impl="gather"), 1)
    tp_s = res_own["wall_s"] / E2E_TPS
    print(f"  rotating MIP about y alone at {grid}: 36 frames {tuple(frames.shape[1:])} "
          f"of the ({frames.shape[2]}, {frames.shape[1]}, {frames.shape[2]}) rotated grid, "
          f"{mip_ms:.3f} ms on auto's route (K8), {mip_ms / 1e3 / tp_s:.4f} of a "
          f"timepoint's {tp_s:.3f} s; the gather route {gather_ms:.3f} ms [{card}]")
    del est, frames
    torch.cuda.empty_cache()

    # ---- (b) Phase 14's views as a two-timepoint series ----
    pa, pb = fusion_psfs()
    route_b = auto_route([pa, pb], FUSION_SHAPE, dev)
    inv_true = inverse12(dof_to_matrix(REG_DOF, 6))
    t0_mats = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_series(tmp, views, dev)
        # the registration's own cost on the u16 views the batch reads
        views_iso = FU.preprocess_views(
            readtifstack(os.path.join(tmp, "SPIMA", "SPIMA_0.tif"))[0],
            readtifstack(os.path.join(tmp, "SPIMB", "SPIMB_0.tif"))[0],
            FUSION_PIXEL, FUSION_PIXEL, -1, dev, as_device=True)
        ncc_true = reg_ncc(*views_iso, inv_true)
        for label, reg_mode, flag in (("regMode 3, 2-D MIP start (choice 4)", 3, 3),
                                      ("regMode 1, phasor start (choice 3)", 1, 2)):
            out = os.path.join(tmp, f"out{reg_mode}")
            cfg = PB.BatchConfig(
                out_dir=out, in_dir1=os.path.join(tmp, "SPIMA"),
                in_dir2=os.path.join(tmp, "SPIMB"), name1="SPIMA_", name2="SPIMB_",
                img_start=0, img_end=BATCH_TPS - 1, img_interval=1, img_test=0,
                pixel1=FUSION_PIXEL, pixel2=FUSION_PIXEL, reg_mode=reg_mode,
                im_rotation=-1, flag_initial_tmx=flag, tmx_file="", ftol=1e-4,
                it_limit=3000, save_reg_a=False, save_reg_b=False,
                psf1_file=os.path.join(tmp, "pa.tif"), psf2_file=os.path.join(tmp, "pb.tif"),
                it_num_decon=N_ITERS, save_mp_z=True, save_mp_y=False, save_mp_x=False,
                save_3d_x=False, save_3d_y=False, bit_per_sample=16, query_device=False,
                device_num=0, verbose=False)
            timings = {}
            torch.cuda.synchronize()
            zero_counts()
            t = time.time()
            with TimepointCounts() as tc, LaunchShapes() as shapes_b:
                done = PB.spim_fusion_batch(cfg, device=dev, timings=timings)
            torch.cuda.synchronize()
            wall = time.time() - t
            n = counts()
            mats = [read_tmx(os.path.join(out, "TMX", f"Matrix_{i}.tmx"))
                    for i in range(BATCH_TPS)]
            err = box_error(mats[0], inv_true, FUSION_SHAPE)
            ncc = reg_ncc(*views_iso, mats[0])
            dec, _ = readtifstack_16to16(os.path.join(out, "Decon", "Decon_0.tif"))
            drift = box_error(mats[1], mats[0], FUSION_SHAPE)
            with open(os.path.join(out, "ProcessingLog.txt")) as f:
                nccs = re.findall(r"final cost function value: ([0-9.eE+-]+)", f.read())
            print(f"  (b) {label}, instrumented: {wall:.3f} s for {BATCH_TPS} timepoints "
                  f"({60 * BATCH_TPS / wall:.3f} tp/min); launches {n}; t0 matrix "
                  f"{err:.4f} voxel from the truth (gate {FUSION_TRUTH_VOXELS}), NCC "
                  f"{ncc:.6f} at it, {ncc_true:.6f} at the truth; t1 matrix {drift:.4f} "
                  f"voxel from t0's; final NCCs in the log {nccs} [{card}]")
            print_timepoints(f"b, regMode {reg_mode}", timings, tc.per_timepoint(n),
                             card)
            k1, k3 = decon_launches(route_b, BATCH_TPS)
            if (done != list(range(BATCH_TPS)) or dec.shape != FUSION_SHAPE or not dec.any()
                    or n["K1"] != k1 or n["K3"] != k3 or not on_k9(n)):
                raise AssertionError(f"(b) {label}: outputs {dec.shape} or kernels {n} wrong")
            if err > FUSION_TRUTH_VOXELS or ncc < ncc_true:
                raise AssertionError(f"(b) {label}: t0 matrix misses the truth gate")
            shapes_b.check(f"(b) regMode {reg_mode}")
            if reg_mode == 1 and not np.array_equal(mats[0], mats[1]):
                raise AssertionError("(b) regMode 1 did not apply one matrix to all")
            t0_mats[reg_mode] = mats[0]
        del views_iso
    apart = box_error(t0_mats[3], t0_mats[1], FUSION_SHAPE)
    print(f"  (b) the two runs' t0 matrices are {apart:.4f} voxel apart over the central "
          f"half-box (gate {BATCH_AGREE_VOXELS})")
    if apart > BATCH_AGREE_VOXELS:
        raise AssertionError("(b) the 2-D MIP and phasor starts disagree")
    torch.cuda.empty_cache()
    return total


@contextlib.contextmanager
def native_tiff(label):
    """Check that the block's TIFF reads and writes all went through the
    native codec (``io.tiff.COUNTS``), and that it read and wrote."""
    before = dict(TIFF.COUNTS)
    yield
    n = {k: TIFF.COUNTS[k] - before[k] for k in before}
    print(f"  {label} TIFF calls by codec: {n}")
    if n["numpy_read"] or n["numpy_write"] or not n["native_read"] or not n["native_write"]:
        raise AssertionError(f"{label}: TIFF I/O not all on the native codec: {n}")


def transfer_rates(dev, card, mib=1024):
    """Host <-> device GB/s of one ``mib`` MiB copy each way from pageable
    and from pinned host memory (the best of three)."""
    n = mib << 18
    d = torch.empty(n, device=dev)
    rates = {}
    for kind, pin in (("pageable", False), ("pinned", True)):
        h = torch.ones(n, pin_memory=pin)
        for way in ("H2D", "D2H"):
            best = math.inf
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if way == "H2D":
                    d.copy_(h, non_blocking=pin)
                else:
                    h.copy_(d, non_blocking=pin)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t)
            rates[f"{way} {kind}"] = 4 * n / best / 1e9
        del h
    del d
    print(f"  host <-> device, {mib} MiB copies [{card}]: "
          + ", ".join(f"{k} {v:.2f} GB/s" for k, v in rates.items()))
    return rates


def peak_since(dev, base):
    return torch.cuda.max_memory_allocated(dev) - base


def fresh_peak(dev):
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def streamed_iteration(stats, rates, card, label):
    """Print seconds per streamed RL iteration, its bytes and the share of
    it those bytes take at the pinned rates of this run."""
    iters = stats["iter_s"]
    h2d = (stats["h2d_bytes"] - stats["setup_h2d_bytes"]) / len(iters)
    d2h = (stats["d2h_bytes"] - stats["setup_d2h_bytes"]) / len(iters)
    s_it = sum(iters) / len(iters)
    xfer = h2d / (rates["H2D pinned"] * 1e9) + d2h / (rates["D2H pinned"] * 1e9)
    print(f"  {label}: {s_it:.3f} s per streamed iteration ({[round(t, 3) for t in iters]}), "
          f"{h2d / 1e9:.2f} GB to and {d2h / 1e9:.2f} GB from the card each, "
          f"{(h2d + d2h) / 1e9 / s_it:.2f} GB/s achieved; at the pinned rates the "
          f"transfers take {xfer:.3f} s = {100 * xfer / s_it:.1f}% of it [{card}]")
    return s_it, xfer / s_it


def block_peak_factors(dev, src, tgt, tmx, card):
    """Peak device bytes of one streamed block over its raw bytes (source
    window + output or target rows), for the transform and the NCC sums,
    at 1 and 4 output planes and at the 16 GB plan's block."""
    sz, sy, sx = src.shape
    m = np.asarray(tmx, np.float64).reshape(3, 4)
    plan = AF._stream_blocks(tmx, sz, sz, sy, sx, sy, sx, BHBM_BUDGET_MB * 1048576.0)
    worst = 0.0
    for n in (1, 4, plan[0][1]):
        z0 = sz // 2
        lo, hi = AF._zspan_for_rows(m, z0, z0 + n - 1, sy, sx, sz)
        raw = AF._block_bytes(n, lo, hi, sy * sx, sy * sx)
        for kind in ("transform", "ncc"):
            base = fresh_peak(dev)
            win = torch.from_numpy(src[lo:hi]).to(dev)
            if kind == "transform":
                out = AF.affine_transform_3d_window(win, tmx, (n, sy, sx), z0, lo, sz)
            else:
                out = AF.corr3d_partials_window(win, torch.from_numpy(tgt[z0:z0 + n]).to(dev),
                                                tmx, z0, lo, sz)
            torch.cuda.synchronize(dev)
            f = peak_since(dev, base) / raw
            del win, out
            worst = max(worst, f)
            print(f"  one streamed block, {kind}, {n} output planes, {hi - lo} source "
                  f"rows: peak {f:.2f} x its {raw / 1e6:.1f} MB raw bytes "
                  f"(STREAM_PEAK_FACTOR {AF.STREAM_PEAK_FACTOR}) [{card}]")
    if worst > AF.STREAM_PEAK_FACTOR:
        raise AssertionError(f"a streamed block peaked at {worst:.2f} x its raw bytes, "
                             f"over STREAM_PEAK_FACTOR {AF.STREAM_PEAK_FACTOR}")
    torch.cuda.empty_cache()
    return worst


def phase18_beyond_hbm(dev, card, main14, views):
    """The beyond-HBM tiers (memory mode 2) at full size. Returns the
    kernel launches of (c)'s low-memory registration."""
    print(f"Phase 18: the beyond-HBM tiers (memory mode 2) [{card}]")
    rates = transfer_rates(dev, card)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)

    def host_rand(shape):
        return (torch.rand(shape, generator=gen, device=dev) * 100 + 1).cpu().numpy()

    # ---- (a) streamed single-view RL ----
    shape = BHBM_DECON_SHAPE
    grid = D._fft_grid(shape)
    psf = bench_psf()
    print(f"  (a) decon_singleview {shape} (grid {grid}), bench 9^3 PSF, "
          f"{BHBM_DECON_ITERS} iterations; mode-1 working set "
          f"{D._workingset_bytes(grid) / 1e9:.2f} GB")
    img = host_rand(shape)
    t = time.time()
    with env(MIL_CONV_SEP="0", MIL_FFT_IMPL="xla"):
        ref = D.decon_singleview(img, psf, BHBM_DECON_ITERS, device=dev, mem_mode=1)
    print(f"  (a) mode 1 on the card (torch.fft route): {time.time() - t:.3f} s [{card}]")
    for label, mode, budget_mb in (("mem_mode=2", 2, None),
                                   (f"mem_mode=-1, MIL_HBM_BUDGET_MB={BHBM_BUDGET_MB}",
                                    -1, BHBM_BUDGET_MB)):
        rec = np.zeros(10)
        base = fresh_peak(dev)
        with env(**({"MIL_HBM_BUDGET_MB": str(budget_mb)} if budget_mb else {})):
            budget = D.hbm_budget_bytes(dev)
            t = time.time()
            out = D.decon_singleview(img, psf, BHBM_DECON_ITERS, device=dev,
                                     mem_mode=mode, records=rec)
        wall = time.time() - t
        peak = peak_since(dev, base)
        print(f"  (a) {label}: records[0] {rec[0]:g}, chunks (z, y) "
              f"{DS._chunk_counts(grid, budget)}, {wall:.3f} s (decon {rec[8]:.3f} s), "
              f"peak device memory {peak / 1e9:.3f} GB of a {budget / 1e9:.3f} GB budget "
              f"[{card}]")
        if rec[0] != 2 or peak > budget:
            raise AssertionError(f"(a) {label}: mode {rec[0]}, peak {peak} > {budget}")
        check_close(f"(a) {label} vs mode 1", out, ref, 0.0, 2e-3)
        del out
    del ref
    stats = {}
    with env(MIL_HBM_BUDGET_MB=str(BHBM_BUDGET_MB)):
        DS.rl_decon_single_streamed(DS.np_pad_stack_edge(img, grid), psf, flip(psf), 1,
                                    budget_bytes=D.hbm_budget_bytes(dev), device=dev,
                                    stats=stats)
    s_it_a, share_a = streamed_iteration(stats, rates, card, f"(a) {grid}, 16 GB budget")
    del img
    torch.cuda.empty_cache()

    # ---- (b) streamed dual-view RL ----
    pa, pb = gauss3((25, 25, 25), (3.5, 1.2, 1.2)), gauss3((25, 25, 25), (1.2, 1.2, 3.5))
    a, b = host_rand(DUAL_SHAPE), host_rand(DUAL_SHAPE)
    print(f"  (b) decon_dualview {DUAL_SHAPE}, the 25^3 dual-view PSFs, "
          f"{BHBM_DECON_ITERS} iterations; mode-1 working set "
          f"{D._workingset_bytes(DUAL_SHAPE, True) / 1e9:.2f} GB")
    with env(MIL_CONV_SEP="0", MIL_FFT_IMPL="xla"):
        ref_fft = D.decon_dualview(a, b, pa, pb, BHBM_DECON_ITERS, device=dev, mem_mode=1)
    ref_auto = D.decon_dualview(a, b, pa, pb, BHBM_DECON_ITERS, device=dev, mem_mode=1)
    for label, mode, budget_mb, ref, tol in (
            ("mem_mode=2", 2, None, ref_fft, 2e-3),
            (f"mem_mode=-1, MIL_HBM_BUDGET_MB={BHBM_DUAL_BUDGET_MB}", -1,
             BHBM_DUAL_BUDGET_MB, ref_auto, 2e-2)):
        rec = np.zeros(10)
        base = fresh_peak(dev)
        with env(**({"MIL_HBM_BUDGET_MB": str(budget_mb)} if budget_mb else {})):
            budget = D.hbm_budget_bytes(dev)
            out = D.decon_dualview(a, b, pa, pb, BHBM_DECON_ITERS, device=dev,
                                   mem_mode=mode, records=rec)
        peak = peak_since(dev, base)
        print(f"  (b) {label}: records[0] {rec[0]:g}, chunks (z, y) "
              f"{DS._chunk_counts(DUAL_SHAPE, budget)}, decon {rec[8]:.3f} s, peak "
              f"{peak / 1e9:.3f} GB of {budget / 1e9:.3f} GB [{card}]")
        if rec[0] != 2 or peak > budget:
            raise AssertionError(f"(b) {label}: mode {rec[0]}, peak {peak} > {budget}")
        check_close(f"(b) {label} vs mode 1 ({'torch.fft' if tol == 2e-3 else 'auto'} "
                    "route)", out, ref, 0.0, tol)
    stats = {}
    with env(MIL_HBM_BUDGET_MB=str(BHBM_DUAL_BUDGET_MB)):
        DS.rl_decon_dual_streamed(a, b, pa, pb, flip(pa), flip(pb), 1,
                                  budget_bytes=D.hbm_budget_bytes(dev), device=dev,
                                  stats=stats)
    streamed_iteration(stats, rates, card, f"(b) {DUAL_SHAPE}, 2 GB budget")
    del a, b, ref_fft, ref_auto
    torch.cuda.empty_cache()

    # ---- (c) low-memory registration, then the hybrid engine ----
    shape = BHBM_REG_SHAPE
    dz, dy, dx = BHBM_REG_SHIFT
    truth = dof_to_matrix([dx, dy, dz, 0, 0, 0, 1, 1, 1], 3)
    vol_d = beads(shape, SEED + 18, dev)
    vol = vol_d.cpu().numpy()
    moved = torch.roll(vol_d, BHBM_REG_SHIFT, dims=(0, 1, 2)).cpu().numpy()
    del vol_d
    torch.cuda.empty_cache()
    print(f"  (c) reg3d_affine {shape}, method 1, beads moved by (x, y, z) "
          f"({dx}, {dy}, {dz}) voxels; mode-1 working set {5 * 4 * np.prod(shape) / 1e9:.2f} GB")
    zero_counts()
    t = time.time()
    _, tmx1, rec1 = R.reg3d_affine(vol, moved, aff_method=1, device=dev, mem_mode=1,
                                   want_reg=False)
    n1 = counts()
    print(f"  (c) mode 1: {time.time() - t:.3f} s, NCC {rec1[3]:.6f}, "
          f"{box_error(tmx1, truth, shape):.4f} voxel from the truth, launches {n1} [{card}]")
    torch.cuda.empty_cache()
    with env(MIL_HBM_BUDGET_MB=str(BHBM_BUDGET_MB)):
        budget = D.hbm_budget_bytes(dev)
        mode, _ = R._reg_device(shape, -1, dev)
        if not R._beyond_budget(mode, shape, dev):
            raise AssertionError("(c) the pair fits the 16 GB budget")
        zero_counts()
        base = fresh_peak(dev)
        t = time.time()
        reg, tmx2, rec2 = R.reg3d_affine(vol, moved, aff_method=1, device=dev,
                                         mem_mode=-1)
        wall = time.time() - t
        peak = peak_since(dev, base)
    bhbm = counts()
    err = box_error(tmx2, truth, shape)
    # both matrices on mode 1's cost (the polish of method 1 scores the
    # source pre-transformed by the coarse matrix, whose zero fill differs)
    moved_d = torch.from_numpy(moved).to(dev)
    vol_d = torch.from_numpy(vol).to(dev)
    ncc1, ncc2 = reg_ncc(vol_d, moved_d, tmx1), reg_ncc(vol_d, moved_d, tmx2)
    del vol_d
    print(f"  (c) low-memory tier under {BHBM_BUDGET_MB} MB: {wall:.3f} s (iterations "
          f"{rec2[6]:.3f} s), coarse NCC {rec2[2]:.6f}, polished {rec2[3]:.6f}, "
          f"{int(rec2[5])} streamed evaluations at {rec2[4]:.1f} ms for the first, "
          f"{err:.4f} voxel from the truth, peak device memory {peak / 1e9:.3f} GB; "
          f"on mode 1's cost NCC {ncc2:.6f} vs mode 1's {ncc1:.6f}; coarse ladder "
          f"launches {bhbm}; matrix {np.round(tmx2, 5).tolist()} [{card}]")
    if err > 0.5 or abs(ncc2 - ncc1) > 1e-3 or peak > budget or not on_k9(bhbm):
        raise AssertionError("(c) the low-memory registration missed its gates")
    resident = affine_transform_3d(moved_d, tmx2, shape).cpu().numpy()
    del moved_d
    if not np.array_equal(resident.view(np.int32), reg.view(np.int32)):
        raise AssertionError("(c) the streamed final transform is not bit-equal to "
                             "affine_transform_3d")
    print("  (c) the streamed final transform equals affine_transform_3d bit for bit")
    del resident, reg
    torch.cuda.empty_cache()
    block_peak_factors(dev, moved, vol, tmx2, card)
    del vol, moved

    bhbm["hybrid_lines"] = hybrid_vs_grad(dev, card)
    phase18_fusion_cli(dev, card, main14, views)
    return bhbm


def hybrid_vs_grad(dev, card):
    """Phase 18 (c): ``reg3d`` (choice 2, method 7, the automatic pyramid)
    on Phase 10's pair at HYBRID_SHAPE with the ``hybrid`` engine against
    the ``grad`` engine: every line minimization of the hybrid engine one
    K9 launch (K9_lines) and one sync, K5 launched only for its start and
    extrapolation points (cost_eval_reg_device) and each level's initial
    cost. Returns the hybrid run's K9 lines."""
    true_m = dof_to_matrix(REG_DOF, 6)
    vol_d = beads(HYBRID_SHAPE, SEED, dev)
    moved_d = affine_transform_3d(vol_d, true_m, HYBRID_SHAPE)
    found = {}
    orig_eval = R.cost_eval_reg_device
    for engine in ("grad", "hybrid"):
        evals, levels = [0], []

        def cost_eval(*a, **kw):
            evals[0] += 1
            return orig_eval(*a, **kw)

        R.cost_eval_reg_device = cost_eval
        zero_counts()
        torch.cuda.synchronize()
        t = time.time()
        try:
            _, tmx, rec = R.reg3d(vol_d, moved_d, 2, 7, engine=engine, device=dev,
                                  mem_mode=1, want_reg=False,
                                  on_level=lambda *a: levels.append(a))
        finally:
            R.cost_eval_reg_device = orig_eval
        torch.cuda.synchronize()
        wall = time.time() - t
        n = counts()
        found[engine] = (tmx, rec[3], n, evals[0], len(levels))
        lines = n["K9_lines"]
        syncs = (n["K4"] + n["K5"] + n["K6"] + n["K9_lines"]
                 + (n["K9"] - n["K9_lines"] > 0) * len(levels))
        print(f"  (c) reg3d engine {engine} at {HYBRID_SHAPE}, method 7, pyramid: "
              f"{wall:.3f} s, NCC {rec[3]:.6f}, {int(rec[5])} evaluations at full "
              f"resolution, {lines} K9 lines ({n['K9_K5']} evaluations in them, "
              f"{n['K9_K5'] / max(lines, 1):.1f} a line), {evals[0]} single evaluations "
              f"(cost_eval_reg_device), {syncs} syncs in all (a K9 line: one launch, one "
              f"sync), launches {n} [{card}]")
    (tmx_g, ncc_g, _, _, _), (tmx_h, ncc_h, n_h, ev_h, lv_h) = found["grad"], found["hybrid"]
    apart = box_error(tmx_h, tmx_g, HYBRID_SHAPE)
    print(f"  (c) hybrid vs grad: NCC {ncc_h:.6f} vs {ncc_g:.6f}, matrices {apart:.4f} "
          "voxel apart")
    if (abs(ncc_h - ncc_g) > 1e-3 or apart > 0.5 or n_h["K4"] or n_h["plain"]
            or n_h["K9_lines"] < 1 or n_h["lines_plain"] or n_h["K9"] != n_h["K9_lines"]
            or n_h["K9_K4"] or n_h["K9_K6"] or n_h["K6"] or n_h["ladder_plain"]
            or not 0 < n_h["K5"] - ev_h <= LEVEL_HOST_CALLS * lv_h):
        raise AssertionError(f"(c) the hybrid engine disagrees with the grad engine or "
                             f"took the wrong kernels: {n_h}, {ev_h} single evaluations")
    del vol_d, moved_d
    torch.cuda.empty_cache()
    return n_h["K9_lines"]


def phase18_fusion_cli(dev, card, main14, views):
    """Phase 18 (d): the spimFusion CLI with -gm 2 on Phase 14's views
    against Phase 14 (b)."""
    print("  (d) spimFusion CLI -gm 2 on Phase 14's views, -bit 16 -otmx")
    pa, pb = fusion_psfs()
    with tempfile.TemporaryDirectory() as tmp, native_tiff("Phase 18 (d)"):
        f = {n: os.path.join(tmp, n) for n in ("a.tif", "b.tif", "pa.tif", "pb.tif",
                                                 "out.tif", "m.tmx")}
        writetifstack(f["a.tif"], views[0], 16)
        writetifstack(f["b.tif"], views[1], 16)
        writetifstack(f["pa.tif"], pa, 32)
        writetifstack(f["pb.tif"], pb, 32)
        zero_counts()
        buf = io.StringIO()
        t = time.time()
        with env(**FUSED_OFF), contextlib.redirect_stdout(buf):
            rc = fusion_cli.main(["-i1", f["a.tif"], "-i2", f["b.tif"], "-fp1", f["pa.tif"],
                                  "-fp2", f["pb.tif"], "-o", f["out.tif"], "-regc", "2",
                                  "-affm", "7", "-it", str(N_ITERS), "-bit", "16",
                                  "-gm", "2", "-otmx", f["m.tmx"], "-verbOFF"])
        wall = time.time() - t
        if rc != 0:
            raise AssertionError(f"spimFusion -gm 2 returned {rc}")
        out, size = readtifstack_16to16(f["out.tif"])
        tmx = read_tmx(f["m.tmx"])
    n = counts()
    inv_true = inverse12(dof_to_matrix(REG_DOF, 6))
    views_iso = FU.preprocess_views(*views, FUSION_PIXEL, FUSION_PIXEL, -1, dev,
                                    as_device=True)
    ncc_d, ncc_b = reg_ncc(*views_iso, tmx), reg_ncc(*views_iso, main14["tmx_b"])
    del views_iso
    apart = box_error(tmx, main14["tmx_b"], FUSION_SHAPE)
    errs = [box_error(m, inv_true, FUSION_SHAPE) for m in (tmx, main14["tmx_b"])]
    print(f"  (d) output {size} (x, y, z) {out.dtype}, {wall:.3f} s in main(), launches {n}; "
          f"NCC {ncc_d:.6f} vs Phase 14 (b)'s {ncc_b:.6f}, matrices {apart:.4f} voxel "
          f"apart, {errs[0]:.4f} and {errs[1]:.4f} voxel from the truth [{card}]")
    if (out.shape != FUSION_SHAPE or not out.any() or abs(ncc_d - ncc_b) > 1e-3
            or apart > 0.5 or max(errs) > FUSION_TRUTH_VOXELS or not on_k9(n)
            or n["K1"] or n["K2"] or n["K3"]):
        raise AssertionError("(d) the -gm 2 fusion missed its gates")
    torch.cuda.empty_cache()


# Phase 19: the multi-device layer on one card. Every mesh place is cuda:0:
# the shards run one after another there, and each exchange is a
# device-to-device copy.
MESH_FFT_SP = 4
MESH_SINGLE_SHAPE = (512, 512, 512)
MESH_SINGLE_SP = 8
MESH_DUAL_SP = 4
MESH_BATCH = (2, 2)        # (n_dp, n_sp)
MESH_FUSION = (2, 4)
MESH_FUSION_ITERS = 2
MESH_REG_SP = 4
MESH_REG7_SHAPE = (128, 256, 256)
MULTIHOST_TIMEOUT_S = 300
MULTIHOST_CHILD = ("import sys\n"
                   "from microimagelib_tpu_torch.cli import spim_fusion_batch as cli\n"
                   "sys.exit(cli.main(sys.argv[1:]))\n")


class ShardsOnCard:
    """While entered, record every shard the sharded layer lays out
    (``parallel.sharded``'s split and gather) and every all-to-all of the
    pencil FFT, with the bytes each moves; fail on a shard off the card."""

    def __init__(self):
        self.n_shards = 0
        self.a2a = []   # bytes of each all_to_all
        self._orig = []

    def _check(self, shards):
        bad = [tuple(t.shape) for t in shards if not t.is_cuda]
        if bad:
            raise AssertionError(f"shards off the card: {bad}")
        self.n_shards += len(shards)

    def __enter__(self):
        def split(x, axis, devices, _orig=PS.split):
            out = _orig(x, axis, devices)
            self._check(out)
            return out

        def gather(shards, axis, device=None, _orig=PS.gather):
            self._check(shards)
            return _orig(shards, axis, device)

        def all_to_all(shards, split_axis, concat_axis, _orig=FS.all_to_all):
            self._check(shards)
            self.a2a.append(sum(t.numel() * t.element_size() for t in shards))
            return _orig(shards, split_axis, concat_axis)

        for mod, name, fn in ((PS, "split", split), (PS, "gather", gather),
                              (FS, "all_to_all", all_to_all)):
            self._orig.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)


def card_mesh(dev, n_sp, n_dp=1):
    """A (n_dp, n_sp) mesh whose every place is ``dev``."""
    return PM.make_mesh(n_sp, n_dp, devices=[dev] * (n_sp * n_dp))


def peak_gb(dev, fn):
    """(result of ``fn()``, its peak device memory above the memory in use
    before it, GB)."""
    base = fresh_peak(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, peak_since(dev, base) / 1e9


def phase19_mesh(dev, card, views):
    """The multi-device layer (parallel/*, ops/fft_sharded.py) with every
    mesh place on the card. Returns the kernel launches of (e), the batch
    CLI under MIL_MESH: its main path."""
    print(f"Phase 19: the multi-device layer, every mesh place on {dev} [{card}]")
    with ShardsOnCard() as sc:
        mesh_fft(dev, card, sc)
        mesh_rl(dev, card)
        mesh_fusion_step(dev, card, views)
        mesh_registration(dev, card)
        with tempfile.TemporaryDirectory() as tmp:
            write_series(tmp, views, dev)
            launches, ref_out = mesh_batch_cli(dev, card, tmp)
            multihost_children(card, tmp, ref_out)
    print(f"  {sc.n_shards} shard tensors laid out or gathered, every one on the card")
    torch.cuda.empty_cache()
    return launches


def batch_argv(tmp, out):
    """spimFusionBatch's 34 arguments for write_series' TIFFs: regMode 3 from
    the 2-D MIP start (choice 4), MP_ZProj, 16-bit."""
    return [out, os.path.join(tmp, "SPIMA"), os.path.join(tmp, "SPIMB"), "SPIMA_", "SPIMB_",
            "0", str(BATCH_TPS - 1), "1", "0", *map(str, FUSION_PIXEL * 2), "3", "-1", "3",
            "none", "0.0001", "3000", "0", "0", os.path.join(tmp, "pa.tif"),
            os.path.join(tmp, "pb.tif"), str(N_ITERS), "0", "0", "1", "0", "0", "16", "0",
            "0"]


def mesh_fft(dev, card, sc):
    """(a) The pencil FFT at DUAL_SHAPE on MESH_FFT_SP shards."""
    nx = DUAL_SHAPE[2]
    rng = np.random.default_rng(SEED + 19)
    x = torch.from_numpy(rng.random(DUAL_SHAPE, dtype=np.float32) * 100 + 1).to(dev)
    otf = D.gen_otf(dual_psfs()[0], DUAL_SHAPE, device=dev)
    row = card_mesh(dev, MESH_FFT_SP).row(0)
    xs, otfs = PS.split(x, 0, row), PS.split(otf, 1, row)
    ref = torch.fft.irfftn(torch.fft.rfftn(x) * otf, s=DUAL_SHAPE)
    got = PS.gather(FS.conv_spec_pencil(xs, otfs, nx), 0)
    check_close(f"(a) conv_spec_pencil on {MESH_FFT_SP} shards vs resident torch.fft",
                got.cpu(), ref.cpu(), 0.0, 2e-4)
    back = PS.gather(FS.irfft3_pencil(FS.rfft3_pencil(xs), nx), 0)
    check_close("(a) irfft3_pencil(rfft3_pencil(x)) vs x", back.cpu(), x.cpu(), 0.0, 1e-5)
    del got, back
    pencils = [torch.fft.fft(torch.fft.rfft(t, dim=-1), dim=-2) for t in xs]
    n_a2a = len(sc.a2a)
    a2a_ms = cuda_ms(lambda: FS.all_to_all(pencils, -2, -3), 5)
    nbytes = sc.a2a[n_a2a]
    conv_ms = cuda_ms(lambda: FS.conv_spec_pencil(xs, otfs, nx), 3)
    res_ms = cuda_ms(lambda: torch.fft.irfftn(torch.fft.rfftn(x) * otf, s=DUAL_SHAPE), 3)
    print(f"  (a) one all_to_all of the forward spectrum moves {nbytes / 1e6:.1f} MB in "
          f"{a2a_ms:.3f} ms ({2 * nbytes / a2a_ms / 1e6:.1f} GB/s read + written); one "
          f"pencil convolution {conv_ms:.3f} ms (two all_to_alls) against the resident "
          f"torch.fft convolution's {res_ms:.3f} ms [{card}]")
    del x, otf, xs, otfs, pencils, ref
    torch.cuda.empty_cache()


def mesh_rl(dev, card):
    """(b) The sharded RL entries against the resident ones on the torch.fft
    route (the same FFT), rtol 2e-4, atol 2e-4 x max."""
    rng = np.random.default_rng(SEED + 191)
    psf = bench_psf()
    shape = MESH_SINGLE_SHAPE
    img = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100 + 1).to(dev)
    otf, bp = (D.gen_otf(p, shape, device=dev) for p in (psf, flip(psf)))
    mesh = card_mesh(dev, MESH_SINGLE_SP)
    for ci in (False, True):
        t = time.time()
        out, peak = peak_gb(dev, lambda: PS.rl_decon_single_sharded(img, otf, bp, N_ITERS,
                                                                    mesh, ci))
        wall = time.time() - t
        with env(MIL_CONV_SEP="0", MIL_FFT_IMPL="xla"):
            ref, peak_r = peak_gb(dev, lambda: D.rl_decon_single(img, otf, bp, N_ITERS, ci))
        print(f"  (b) rl_decon_single_sharded {shape}, bench 9^3 PSF, {N_ITERS} iterations, "
              f"{MESH_SINGLE_SP} shards, const_initial={ci}: {wall:.3f} s, peak "
              f"{peak:.3f} GB ({peak / MESH_SINGLE_SP:.3f} a shard) against the resident "
              f"call's {peak_r:.3f} GB [{card}]")
        check_close(f"(b) single sharded vs resident, const_initial={ci}", out.cpu(),
                    ref.cpu(), 2e-4, 2e-4)
        del out, ref
    row = mesh.row(0)
    sh = (PS._vol_shards(img, row), PS._spec_shards(otf, row), PS._spec_shards(bp, row))
    sh_ms = cuda_ms(lambda: PS._rl_single_local(*sh, 2, False, shape[2]), 2) / 2
    res_ms = cuda_ms(lambda: D._rl_single(img, otf, bp, 2, False, "torch"), 2) / 2
    print(f"  (b) ms per single-view iteration at {shape}: {MESH_SINGLE_SP} shards "
          f"{sh_ms:.3f}, resident torch.fft {res_ms:.3f} [{card}]")
    del img, otf, bp, sh
    torch.cuda.empty_cache()

    pa, pb, wa, wb = dual_psfs()
    a, b = (torch.from_numpy(rng.random(DUAL_SHAPE, dtype=np.float32) * 100 + 1).to(dev)
            for _ in range(2))
    otfs = [D.gen_otf(p, DUAL_SHAPE, device=dev) for p in (pa, pb, wa, wb)]
    mesh = card_mesh(dev, MESH_DUAL_SP)
    t = time.time()
    out, peak = peak_gb(dev, lambda: PS.rl_decon_dual_sharded(a, b, *otfs, WB_ITERS, mesh))
    wall = time.time() - t
    with env(MIL_FFT_IMPL="xla"):
        ref, peak_r = peak_gb(dev, lambda: D.rl_decon_dual(a, b, *otfs, WB_ITERS))
    print(f"  (b) rl_decon_dual_sharded {DUAL_SHAPE}, WB back projectors, {WB_ITERS} "
          f"iterations, {MESH_DUAL_SP} shards: {wall:.3f} s, peak {peak:.3f} GB against "
          f"{peak_r:.3f} GB resident [{card}]")
    check_close("(b) dual sharded vs resident", out.cpu(), ref.cpu(), 2e-4, 2e-4)
    del out
    row = mesh.row(0)
    sh = [PS._vol_shards(v, row) for v in (a, b)] + [PS._spec_shards(o, row) for o in otfs]
    sh_ms = cuda_ms(lambda: PS._rl_dual_local(*sh, 1, False, DUAL_SHAPE[2]), 2)
    res_ms = cuda_ms(lambda: D._rl_dual(a, b, *otfs, 1, False, "torch"), 2)
    print(f"  (b) ms per dual-view iteration at {DUAL_SHAPE}: {MESH_DUAL_SP} shards "
          f"{sh_ms:.3f}, resident torch.fft {res_ms:.3f} [{card}]")
    del sh
    n_dp, n_sp = MESH_BATCH
    imgs_a, imgs_b = torch.stack([a, b]), torch.stack([b, a * 0.5 + 1])
    t = time.time()
    out, peak = peak_gb(dev, lambda: PS.rl_decon_dual_batch_dp(
        imgs_a, imgs_b, *otfs, WB_ITERS, card_mesh(dev, n_sp, n_dp)))
    print(f"  (b) rl_decon_dual_batch_dp, 2 timepoints on a (dp {n_dp}, sp {n_sp}) mesh: "
          f"{time.time() - t:.3f} s, peak {peak:.3f} GB [{card}]")
    for i in range(2):
        with env(MIL_FFT_IMPL="xla"):
            ref = D.rl_decon_dual(imgs_a[i], imgs_b[i], *otfs, WB_ITERS)
        check_close(f"(b) batch_dp timepoint {i} vs its resident decon", out[i].cpu(),
                    ref.cpu(), 2e-4, 2e-4)
    del a, b, otfs, out, ref, imgs_a, imgs_b
    torch.cuda.empty_cache()


def mesh_fusion_step(dev, card, views):
    """(c) fusion_step_multichip on Phase 14's views, 2 timepoints on a
    MESH_FUSION mesh: once within the footprint's window, once with a z
    shift that forces the whole-source gather."""
    pa, pb = fusion_psfs()
    a_iso, b_iso = FU.preprocess_views(*views, FUSION_PIXEL, FUSION_PIXEL, -1, dev,
                                       as_device=True)
    if tuple(b_iso.shape) != tuple(a_iso.shape):
        b_iso = align_size_3d(b_iso, tuple(a_iso.shape))
    # on the FFT grid, as the batch pads them (FUSION_SHAPE is one)
    grid = D._fft_grid(tuple(a_iso.shape))
    a_iso, b_iso = (v if tuple(v.shape) == grid else pad_stack_edge(v, grid)
                    for v in (a_iso, b_iso))
    otfs = [D.gen_otf(p, grid, device=dev) for p in (pa, pb, flip(pa), flip(pb))]
    n_dp, n_sp = MESH_FUSION
    mesh = card_mesh(dev, n_sp, n_dp)
    truth = inverse12(dof_to_matrix(REG_DOF, 6)).astype(np.float32)
    factorization_readings(dev, a_iso, b_iso, otfs)
    far = truth.copy()
    far[11] += 0.8 * grid[0]
    imgs_a, imgs_b = torch.stack([a_iso, a_iso]), torch.stack([b_iso, b_iso])
    with env(MIL_FFT_IMPL="xla"):
        ref = D.rl_decon_dual(a_iso, b_iso, *otfs, MESH_FUSION_ITERS)
    for label, mats in (("footprint window", [truth, AF_IDENTITY]),
                        ("whole-source gather", [far, truth])):
        hops = max(AF.zslab_footprint_hops(m, grid, n_sp) for m in mats)
        branch = "all_gather" if hops >= n_sp - 1 else f"{hops}-hop window"
        t = time.time()
        est, ss, st = PS.fusion_step_multichip(mesh, imgs_a, imgs_b, *otfs, np.stack(mats),
                                               n_iters=MESH_FUSION_ITERS)
        torch.cuda.synchronize()
        print(f"  (c) fusion_step_multichip {grid}, 2 timepoints on a (dp {n_dp}, "
              f"sp {n_sp}) mesh, {MESH_FUSION_ITERS} iterations, {label}: the {branch} "
              f"branch ran, {time.time() - t:.3f} s [{card}]")
        if (label == "footprint window") == (hops >= n_sp - 1):
            raise AssertionError(f"(c) {label}: hops {hops} took the wrong branch")
        for i, m in enumerate(mats):
            ss0, st0 = (float(v) for v in AF.corr3d_partials(b_iso, a_iso, m))
            for name, v, v0 in (("ss", float(ss[i]), ss0), ("st", float(st[i]), st0)):
                if abs(v - v0) > 1e-5 * abs(v0):
                    raise AssertionError(f"(c) {label} t{i} {name} {v} vs {v0}")
            check_close(f"(c) {label} t{i} estimate vs rl_decon_dual", est[i].cpu(),
                        ref.cpu(), 0.0, 2e-4)
        print(f"  (c) {label}: ss, st within rtol 1e-5 of corr3d_partials on both "
              f"timepoints")
    del a_iso, b_iso, otfs, imgs_a, imgs_b, est, ref
    torch.cuda.empty_cache()


def factorization_readings(dev, a, b, otfs):
    """(c)'s views, zeros where isotropizing filled them, through
    MESH_FUSION_ITERS joint iterations on two other FFT factorizations, the
    one-place pencil FFT and the resident K3 route, each against the
    resident torch.fft (rfftn) route that (c) gates the fusion step on.
    Printed, not gated: how far RL's ratio on these views lets two
    factorizations' rounding drift apart."""
    with env(MIL_FFT_IMPL="xla"):
        ref = D.rl_decon_dual(a, b, *otfs, MESH_FUSION_ITERS)
        pencil = PS.rl_decon_dual_sharded(a, b, *otfs, MESH_FUSION_ITERS, card_mesh(dev, 1))
    with env(MIL_FFT_IMPL="pallas"):
        ct = D.rl_decon_dual(a, b, *otfs, MESH_FUSION_ITERS)
    m = float(ref.abs().max())
    print(f"  (c) the views hold zeros in {float((a == 0).float().mean()):.4f} (A) and "
          f"{float((b == 0).float().mean()):.4f} (B) of their voxels")
    for name, out in (("one-place pencil", pencil), ("resident K3", ct)):
        err = float((out - ref).abs().max())
        print(f"  (c) {name} vs resident torch.fft on the views, {MESH_FUSION_ITERS} "
              f"iterations: max|diff| {err:.6g} = {err / m:.3g} x max|ref| (reading, not "
              f"gated)")
    del ref, pencil, ct
    torch.cuda.empty_cache()


def mesh_registration(dev, card):
    """(d) reg3d_affine_sharded: method 1 on Phase 10's beads moved by Phase
    18 (c)'s whole-voxel translation; method 7 at MESH_REG7_SHAPE on the
    REG_DOF pair, whose search must use more than one window."""
    dz, dy, dx = BHBM_REG_SHIFT
    truth = dof_to_matrix([dx, dy, dz, 0, 0, 0, 1, 1, 1], 3)
    vol = beads(REG_SHAPE, SEED, dev)
    moved = torch.roll(vol, BHBM_REG_SHIFT, dims=(0, 1, 2))
    mesh = card_mesh(dev, MESH_REG_SP)
    stats = {}
    t = time.time()
    reg, tmx, rec = PS.reg3d_affine_sharded(mesh, vol, moved, aff_method=1, stats=stats)
    wall = time.time() - t
    _, tmx1, rec1 = R.reg3d_affine(vol, moved, aff_method=1, device=dev, mem_mode=1,
                                   want_reg=False)
    err = box_error(tmx, truth, REG_SHAPE)
    print(f"  (d) reg3d_affine_sharded {REG_SHAPE}, method 1, {MESH_REG_SP} shards: "
          f"{wall:.3f} s, NCC {rec[3]:.6f} (reg3d_affine {rec1[3]:.6f}), {err:.4f} voxel "
          f"from the truth, {int(rec[5])} evaluations, {rec[6] / rec[5] * 1e3:.3f} ms an "
          f"evaluation, windows {sorted(stats['cost_fn_keys'])} [{card}]")
    if err > 0.5 or abs(rec[3] - rec1[3]) > 1e-3 or reg.shape != REG_SHAPE:
        raise AssertionError("(d) method 1 missed its gates")
    del vol, moved, reg
    torch.cuda.empty_cache()
    vol = beads(MESH_REG7_SHAPE, SEED + 7, dev)
    m_true = dof_to_matrix(REG_DOF, 6)
    moved = affine_transform_3d(vol, m_true, MESH_REG7_SHAPE)
    stats = {}
    t = time.time()
    _, tmx, rec = PS.reg3d_affine_sharded(mesh, vol, moved, aff_method=7, ftol=5e-3,
                                          it_limit=500, stats=stats)
    wall = time.time() - t
    err = box_error(tmx, inverse12(m_true), MESH_REG7_SHAPE)
    keys = sorted(stats["cost_fn_keys"])
    print(f"  (d) reg3d_affine_sharded {MESH_REG7_SHAPE}, method 7, ftol 5e-3, it_limit "
          f"500: {wall:.3f} s, NCC {rec[3]:.6f}, {err:.4f} voxel from the truth, "
          f"{int(rec[5])} evaluations, {rec[6] / rec[5] * 1e3:.3f} ms an evaluation, "
          f"windows (hops, whole source) {keys} [{card}]")
    if len(keys) < 2 or rec[3] < 0.9:
        raise AssertionError(f"(d) method 7: windows {keys}, NCC {rec[3]}")
    del vol, moved
    torch.cuda.empty_cache()


def mesh_batch_cli(dev, card, tmp):
    """(e) The batch CLI under MIL_MESH=2,2 against the same CLI without it.
    Returns the mesh run's launches and the reference run's output tree."""
    ref_out, out = os.path.join(tmp, "ref"), os.path.join(tmp, "mesh")
    runs = {}
    with native_tiff("Phase 19 (e)"):
        for label, out_dir, mesh_env in (("without MIL_MESH", ref_out, None),
                                         ("MIL_MESH=2,2", out, "2,2")):
            timings = {}
            buf = io.StringIO()
            torch.cuda.synchronize()
            zero_counts()
            t = time.time()
            with (env(MIL_MESH=mesh_env) if mesh_env else contextlib.nullcontext()), \
                    TimepointCounts() as tc, LaunchShapes() as shapes, \
                    contextlib.redirect_stdout(buf):
                rc = PB_CLI.main(batch_argv(tmp, out_dir), timings=timings)
            torch.cuda.synchronize()
            wall = time.time() - t
            n = counts()
            if rc != 0:
                raise AssertionError(f"(e) {label}: the CLI returned {rc}")
            print(f"  (e) spimFusionBatch CLI {label}, regMode 3, {BATCH_TPS} timepoints: "
                  f"{wall:.3f} s, launches {n} [{card}]")
            print_timepoints(f"e, {label}", timings, tc.per_timepoint(n), card)
            shapes.check(f"(e) {label}")
            runs[label] = n
    with open(os.path.join(out, "ProcessingLog.txt")) as f:
        log = f.read()
    want = f"Device mesh (dp 2, sp 2): {', '.join([str(dev)] * 4)}"
    n = runs["MIL_MESH=2,2"]
    if want not in log or not on_k9(n) or n["K1"] or n["K3"]:
        raise AssertionError(f"(e) the mesh run took the wrong path: launches {n}")
    for t in range(BATCH_TPS):
        got = readtifstack(os.path.join(out, "Decon", f"Decon_{t}.tif"))[0]
        ref = readtifstack(os.path.join(ref_out, "Decon", f"Decon_{t}.tif"))[0]
        check_close(f"(e) Decon_{t} MIL_MESH=2,2 vs without", got, ref, 2e-4, 2e-3)
    return n, ref_out


def multihost_children(card, tmp, ref_out):
    """(f) Two processes with MIL_MULTIHOST=1 on the card, regMode 3, on (e)'s
    TIFFs: disjoint timepoint sets that cover the series, outputs equal to
    (e)'s one-process run, ProcessingLog.p1.txt."""
    out = os.path.join(tmp, "multihost")
    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "MIL_MESH"))}
    base["PYTHONPATH"] = os.pathsep.join([root, base.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    procs, logs = [], [os.path.join(tmp, f"process{pid}.log") for pid in range(2)]
    t = time.time()
    try:
        for pid in range(2):
            env_p = dict(base, MIL_MULTIHOST="1", JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                         JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
            # output to files: a full pipe would stall a child
            with open(logs[pid], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", MULTIHOST_CHILD, *batch_argv(tmp, out)],
                    env=env_p, cwd=root, stdout=f, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=MULTIHOST_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t
    for pid, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[pid]) as f:
                raise AssertionError(f"(f) process {pid} returned {p.returncode}:\n"
                                     f"{f.read()[-3000:]}")
    sets = []
    for log in ("ProcessingLog.txt", "ProcessingLog.p1.txt"):
        with open(os.path.join(out, log)) as f:
            sets.append({int(v) for v in re.findall(r"Image time point number: (\d+)",
                                                     f.read())})
    print(f"  (f) two MIL_MULTIHOST=1 processes on the card: {wall:.3f} s, timepoints "
          f"{sorted(sets[0])} and {sorted(sets[1])} [{card}]")
    if sets[0] & sets[1] or sets[0] | sets[1] != set(range(BATCH_TPS)):
        raise AssertionError(f"(f) timepoint sets {sets} are not a split of the series")
    for t in range(BATCH_TPS):
        got = readtifstack(os.path.join(out, "Decon", f"Decon_{t}.tif"))[0]
        ref = readtifstack(os.path.join(ref_out, "Decon", f"Decon_{t}.tif"))[0]
        check_close(f"(f) Decon_{t} two processes vs one", got, ref, 2e-4, 2e-3)


# Phase 20: raw shapes that the FFT size policy pads to grids of the lengths
# specialised after 128, 256, 320 and 512
P20_DUAL_RAW = (360, 600, 600)      # -> (384, 640, 640)
P20_SINGLE_RAW = (150, 600, 600)    # -> (192, 640, 640)


def phase20_new_lengths(dev, card):
    """The decon entries on grids of the new lengths, on the route auto
    takes (K3, every axis specialised), against MIL_FFT_IMPL=xla: (a) dual
    view with WB back projectors, (b) single view with the tilted PSF.
    Returns K3's calls in (a) and (b)."""
    print(f"Phase 20: the decon entries on the new lengths' grids [{card}]")
    pa, pb, wa, wb = dual_psfs()
    rng = np.random.default_rng(SEED + 20)
    a = rng.random(P20_DUAL_RAW, dtype=np.float32) * 100 + 1
    b = rng.random(P20_DUAL_RAW, dtype=np.float32) * 100 + 1
    grid = D._fft_grid(P20_DUAL_RAW)
    if D._sep_plans(pa, wa, grid) is not None:
        raise AssertionError("the planner accepted a WB back projector")

    def dual(rec):
        return D.decon_dualview(a, b, pa, pb, n_iters=WB_ITERS, psf_bp_a=wa,
                                psf_bp_b=wb, device=dev, records=rec)

    def dual_iters(impl):
        a_d, b_d = (pad_stack_edge(torch.from_numpy(x).to(dev), grid) for x in (a, b))
        otfs = [D.gen_otf(p, grid, device=dev) for p in (pa, pb, wa, wb)]
        return cuda_ms(lambda: D._rl_dual(a_d, b_d, *otfs, WB_ITERS, False, impl),
                       2) / WB_ITERS

    n_a = decon_on_both_routes(dev, card, f"(a) decon_dualview {P20_DUAL_RAW} -> {grid}, "
                               f"WB, {WB_ITERS} iterations", dual, grid, 4 * WB_ITERS,
                               dual_iters)
    del a, b
    tpsf = tilted_psf()
    img = rng.random(P20_SINGLE_RAW, dtype=np.float32) * 100 + 1
    grid = D._fft_grid(P20_SINGLE_RAW)
    sep = D._sep_plans(tpsf, flip(tpsf), grid, torch.empty(0, device=dev))
    print(f"  (b) MIL_CONV_SEP=auto on the tilted PSF at {grid}: "
          f"{'the separable route: pinned to 0' if sep else 'the FFT route'}")

    def single(rec):
        with env(**({"MIL_CONV_SEP": "0"} if sep else {})):
            return D.decon_singleview(img, tpsf, n_iters=N_ITERS, device=dev, records=rec)

    def single_iters(impl):
        img_d = pad_stack_edge(torch.from_numpy(img).to(dev), grid)
        otf = D.gen_otf(tpsf, grid, device=dev)
        otf_bp = D.gen_otf(flip(tpsf), grid, device=dev)
        return cuda_ms(lambda: D._rl_single(img_d, otf, otf_bp, N_ITERS, False, impl),
                       2) / N_ITERS

    n_b = decon_on_both_routes(dev, card, f"(b) decon_singleview {P20_SINGLE_RAW} -> "
                               f"{grid}, tilted PSF, {N_ITERS} iterations", single, grid,
                               2 * N_ITERS, single_iters)
    return n_a, n_b


def decon_on_both_routes(dev, card, label, run, grid, calls, iter_ms):
    """``run(records)`` on auto's route, which must be K3 with every axis
    specialised and ``calls`` K3 calls (the counts set to 0 just before),
    then under MIL_FFT_IMPL=xla (no K3 call), within 2e-4 x max of each
    other; the peak device memory of the first and ms per iteration of
    both routes (``iter_ms(impl)``). Returns the K3 calls."""
    if D._fft_impl(grid, torch.empty(0, device=dev)) != "ct" or not F.ct_specialised(grid):
        raise AssertionError(f"{label}: auto does not take K3 on {grid}")
    base = fresh_peak(dev)
    zero_counts()
    rec = np.zeros(10)
    out_k = run(rec)
    torch.cuda.synchronize()
    got, spec = counts(), dict(F.LAUNCHES_SPECIALISED)
    peak = peak_since(dev, base) / 1e9
    print(f"  {label}: memory mode {rec[0]:.0f}, decon {rec[8]:.3f} s, peak "
          f"{peak:.3f} GB; launches {got}, specialised {spec} [{card}]")
    if rec[0] != 1:
        raise AssertionError(f"{label}: memory mode {rec[0]}, expected 1")
    if got["K3"] != calls or spec != dict.fromkeys("xyz", calls) or got["K1"] or got["K2"]:
        raise AssertionError(f"{label}: expected {calls} K3 calls specialised on x, y "
                             f"and z, got {got}, {spec}")
    with env(MIL_FFT_IMPL="xla"):
        out_x = run(np.zeros(10))
    if F.LAUNCHES != calls:
        raise AssertionError(f"{label}: the torch.fft route launched K3")
    check_close(f"{label}: K3 route vs torch.fft route", out_k, out_x, 0.0, 2e-4)
    del out_k, out_x
    ms = {impl: iter_ms(impl) for impl in ("ct", "torch")}
    torch.cuda.empty_cache()
    print(f"  {label}: ms per iteration K3 route {ms['ct']:.3f}, torch.fft route "
          f"{ms['torch']:.3f} [{card}]")
    return calls


# Phase 21: the rotating MIP's routes. K8 against its plain version (the
# factored einsums) at a shape where the tap tables fit; against the gather
# route at the batch's grid and the fusion grid; the one-hot matmul route
# where its W fits the cap
MIP_PLAIN_SHAPE = (128, 128, 128)
# row counts that are not a multiple of a warp: 100 about y, 90 about x
MIP_PARTIAL_WARP_SHAPES = ((96, 100, 90),)
MIP_SHAPES = ((E2E_XY,) * 3, FUSION_SHAPE)
MIP_FRAMES = 36


def mip_bound(shape, p, r_axis):
    """K8's bound at ``shape``: the volume read once and the frames written
    once, against ``MR.OPS_PER_SAMPLE`` for every (frame, row, z', q)
    sample inside the joint validity box, counted from this run's matrices.
    Returns the bound and the sample count."""
    rows, na, nb, zo, po = MR.extents(shape, p["out_shape"], r_axis)
    inside = MR.samples_inside(MR.coefficients(p["mats"], r_axis), na, nb, zo, po)
    n = len(p["mats"])
    return (bound(4 * (rows * na * nb + n * rows * po), MR.OPS_PER_SAMPLE * inside * rows),
            inside * rows)


def k8_ptxas():
    """What ``nvcc -Xptxas -v`` says of K8: its registers and spill lines."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                              str(build.CSRC_DIR / "mip_rot.cu"), "-o",
                              os.path.join(tmp, "mip_rot.o")],
                             capture_output=True, text=True, timeout=300)
    if out.returncode:
        raise AssertionError("nvcc -Xptxas -v failed on mip_rot.cu:\n" + out.stderr)
    return [ln.split("info    :")[-1].strip() for ln in (out.stdout + out.stderr).splitlines()
            if "registers" in ln or "spill" in ln]


def phase21_mip(dev, card):
    """The rotating MIP's routes at full width: K8 against its plain version
    at MIP_PARTIAL_WARP_SHAPES and MIP_PLAIN_SHAPE and against the gather
    route at MIP_SHAPES, about
    both axes, within 1e-5 x max; each route's time, K8's bound, registers
    and spills; auto's CUDA route (K8) the fastest of the routes timed at
    each shape. Returns K8's numbers for the kernels line, at the batch's
    grid about y (the batch's own MIP)."""
    print(f"Phase 21: the rotating MIP's routes [{card}]")
    print(f"  K8 compiled to {MR.kernel_attrs()}; nvcc -Xptxas -v: {k8_ptxas()}")
    rng = np.random.default_rng(SEED + 21)
    res = {"max_abs_err": 0.0}

    def times(img, r_axis, routes):
        out = {}
        for route in routes:
            reps = 10 if route == "factored" else 1
            out[route] = alone_cuda_ms(
                lambda: PP.mip3d_frames(img, r_axis, MIP_FRAMES, impl=route), reps)
        return out

    def check_rule(shape, r_axis, ms):
        p = PP.mip3d_params(shape, r_axis, MIP_FRAMES, device=dev)
        fastest = min(ms, key=ms.get)
        print(f"  {shape} about {'xy'[r_axis - 1]}: ms {json.dumps(ms)}; auto takes "
              f"{p['impl']}, the fastest is {fastest} [{card}]")
        if p["impl"] != "factored" or fastest != "factored":
            raise AssertionError(f"{shape} r_axis {r_axis}: auto takes {p['impl']}, the "
                                 f"fastest route is {fastest}")

    for shape in MIP_PARTIAL_WARP_SHAPES:
        img = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100).to(dev)
        for r_axis in (1, 2):
            p = PP.mip3d_params(shape, r_axis, MIP_FRAMES, "factored", device=dev)
            rows, na, nb, zo, po = MR.extents(shape, p["out_shape"], r_axis)
            out = MR.mip_rot(img, p["mats"], p["out_shape"], r_axis)
            was, wbs = MR.tap_tables(p["mats"], zo, na, nb, po, p["chunk"], r_axis, dev)
            ref = MR.mip_rot_torch(img, was, wbs, r_axis, p["fgroup"])
            check_close(f"K8 vs mip_rot_torch at {shape} about {'xy'[r_axis - 1]} ({rows} "
                        f"rows: {rows % 32} in the last warp)", out.cpu(), ref.cpu(), 0.0, 1e-5)
            res["max_abs_err"] = max(res["max_abs_err"], float((out - ref).abs().max()))
            del out, ref, was, wbs
        del img
    shape = MIP_PLAIN_SHAPE
    img = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100).to(dev)
    for r_axis in (1, 2):
        p = PP.mip3d_params(shape, r_axis, MIP_FRAMES, "factored", device=dev)
        _rows, na, nb, zo, po = MR.extents(shape, p["out_shape"], r_axis)
        before = MR.LAUNCHES
        out = MR.mip_rot(img, p["mats"], p["out_shape"], r_axis)
        torch.cuda.synchronize()
        if MR.LAUNCHES != before + 1:
            raise AssertionError("K8: a call did not launch the kernel once")
        was, wbs = MR.tap_tables(p["mats"], zo, na, nb, po, p["chunk"], r_axis, dev)
        ref = MR.mip_rot_torch(img, was, wbs, r_axis, p["fgroup"])
        check_close(f"K8 vs mip_rot_torch at {shape} about {'xy'[r_axis - 1]} (chunk "
                    f"{p['chunk']}, fgroup {p['fgroup']})", out.cpu(), ref.cpu(), 0.0, 1e-5)
        res["max_abs_err"] = max(res["max_abs_err"], float((out - ref).abs().max()))
        if not torch.equal(out.view(torch.int32), MR.mip_rot(
                img, p["mats"], p["out_shape"], r_axis).view(torch.int32)):
            raise AssertionError("K8: two launches gave different bits")
        plain_ms = alone_cuda_ms(lambda: MR.mip_rot_torch(img, was, wbs, r_axis, p["fgroup"]),
                                 1)
        del was, wbs, ref
        w_bytes = na * nb * zo * po * 4
        ms = times(img, r_axis, ("factored", "gather", "matmul"))
        print(f"  {shape} about {'xy'[r_axis - 1]}: K8's plain version {plain_ms:.3f} ms; "
              f"the matmul route's W {w_bytes / 1e9:.3f} GB a frame [{card}]")
        check_rule(shape, r_axis, ms)
    del img
    torch.cuda.empty_cache()
    for shape in MIP_SHAPES:
        img = torch.from_numpy(rng.random(shape, dtype=np.float32) * 100).to(dev)
        for r_axis in (1, 2):
            p = PP.mip3d_params(shape, r_axis, MIP_FRAMES, "factored", device=dev)
            rows, na, nb, zo, po = MR.extents(shape, p["out_shape"], r_axis)
            out = MR.mip_rot(img, p["mats"], p["out_shape"], r_axis)
            ref = PP._rotate_and_mip_all(img, p["mats"], p["out_shape"])
            check_close(f"K8 vs the gather route at {shape} about {'xy'[r_axis - 1]}",
                        out.cpu(), ref.cpu(), 0.0, 1e-5)
            del out, ref
            ms = times(img, r_axis, ("factored", "gather"))
            k8_ms = cuda_ms(lambda: MR.mip_rot(img, p["mats"], p["out_shape"], r_axis), 10)
            (b_ms, b_by), inside = mip_bound(shape, p, r_axis)
            print(f"  {shape} about {'xy'[r_axis - 1]}: K8 {k8_ms:.3f} ms a call back to back "
                  f"(the route alone, mip3d_params' host work included, "
                  f"{ms['factored']:.3f} ms) against "
                  f"a bound of {b_ms:.4f} ms ({b_by}; {inside} samples inside the box, "
                  f"{inside / (MIP_FRAMES * rows * zo * po):.3f} of all); the matmul "
                  f"route, whose W would be {na * nb * zo * po * 4 / 1e9:.1f} GB a frame, "
                  f"is not timed [{card}]")
            check_rule(shape, r_axis, ms)
            if shape == (E2E_XY,) * 3 and r_axis == 2:
                res.update(ms=ms["factored"], kernel_ms=k8_ms, gather_ms=ms["gather"],
                           bound=(b_ms, b_by))
                was, wbs = MR.tap_tables(p["mats"], zo, na, nb, po, p["chunk"], r_axis, dev)
                torch.cuda.synchronize()
                t = time.time()
                MR.mip_rot_torch(img, was, wbs, r_axis, p["fgroup"])
                torch.cuda.synchronize()
                res["plain_ms"] = (time.time() - t) * 1e3
                print(f"  {shape} about y: K8's plain version {res['plain_ms']:.3f} ms "
                      f"(one call, host clock; chunk {p['chunk']}, fgroup {p['fgroup']}) "
                      f"[{card}]")
                del was, wbs
                torch.cuda.empty_cache()
        del img
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    sys.exit(main())
