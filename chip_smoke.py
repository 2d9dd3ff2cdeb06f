"""Smoke run of the PyTorch port on one CUDA GPU (an H100 / sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); no CUDA -> exit 2;
  2. build: compile the port's kernels (nerf2mesh_tpu_torch/csrc) with nvcc;
  3. kernels: K1 occ_lookup against its plain version and the unpacked
     grid on the sampler's cells (32768 rays of the bench scene's train
     views x 128 coarse candidates, the row's time; an eval round of 8192
     rays), on uniformly random cells and on a view that starts off a
     16-byte boundary, with pack_bits timed beside it; K2 inwin_fwd (at
     levels 0-6 and 0-8) and K3 inwin_bwd against their plain versions at
     the shapes the training step gives them,
     plus K2 + the residual against the plain hashgrid_encode; K3's global
     vector adds counted, and K3 on a hot spot (16 tiles inside one level-0
     lattice cell); K7 (the TPU's timing variants of K2, on no path):
     inwin_dense_deep, _const_rows and _four_tiles (wgmma, 3xTF32) on K2's
     points at levels 6 and 8, timed at 6 beside the dense product's floor
     and a torch.bmm yardstick of its contraction; K6 on a long run (2048 points in one level-15 block); K5
     winsort_fwd and K6 winsort_bwd against theirs on 2^18 uniform points
     (with out-of-bounds and block-edge points) at winsort levels 7-15,
     K5 also on 16 tight clusters, a 2^15-point run of one window, 4096 and
     128 points, a clamped tail, one level and 16 levels, plus K5 + its
     residual against hashgrid_encode; K4 sweep_fwd and K4b
     sweep_bwd (the ref table gradient) against their plain versions on
     2^18 points at the ref slice's table (uniform, out-of-bounds, on-edge
     and 1-ulp-from-edge points), K4b also on 2^18 points in 16 tight
     clusters, both at 40 and 70 levels and on a tiled grid; then K2-K6
     and K4b at the separate tables' channel counts, C = 1 and C = 2, on
     2^18 points at the full specs (K2/K3 at levels 0-8, K5/K6 at 7-15,
     K4/K4b at the ref slice's table), each against its plain version (the
     table gradients within atomic_tol_margin); times from
     CUDA events (the mean of 20 back-to-back runs), each beside its bound
     (bytes over 3.35 TB/s or fp32 flops over 67 TFLOP/s, whichever is
     larger; K7's is K2's at its level);
  4. slice: stage-0 training at bench.py's configuration on the in-memory
     256x256 x 24-view sphere scene; every loss finite, the loss falls, and
     K1-K3's launch counters are above 0 for the training run alone; after
     phase 5, PROFILE_STEPS more steps and one eval frame under
     torch.profiler (device
     busy time, idle share, kernels, top ops);
  5. eval: Trainer.evaluate on N_VAL val views at 256x256 before and after the
     phase-4 training; the PSNR after is finite and above the PSNR before,
     and K1 and K2 launch during each eval alone; ms per frame and march
     rounds;
  6. winsort: a fresh trainer at the same configuration with
     winsort_fine=True, stochastic_fine=False trains 64 steps (losses finite
     and falling, K5 and K6 launched by the training alone), then evaluates
     the val views (K5 launched by the eval alone); ms/step, rays/s,
     ms/frame and PSNR; PROFILE_STEPS more steps profiled;
  7. cli (Pillow blocked, as on a machine without it): the ref small-table
     slice through nerf2mesh_tpu_torch.main on a 256x256 blender scene
     written to a temporary directory (24 train, N_VAL val, 2 test views):
     CLI_STEPS steps at bench.py's flags with --grid_layout ref --log2_hashmap_size
     14 --mesh_visibility_culling --mcubes_reso 256, an eval and a
     checkpoint at step CLI_STEPS, the final val and test evals (PSNR, SSIM, LPIPS
     proxy), the test video and mesh_stage0/mesh_0.ply; every logged loss
     finite and falling, K1, K4 and K4b launched by the training, the
     block512 kernels never; the mesh not empty and at least half its
     vertices within 0.05 of the scene's analytic surface; then main --test
     reloads the checkpoint, and a fresh Trainer loaded from it reproduces
     the step-CLI_STEPS val PSNR within 1e-4 dB (PROFILE_STEPS more steps
     and one eval frame profiled); then main --stage 1 --refine --iters CLI_S1_STEPS (a
     refine at half of them, textures 1024^2): finite losses, overflow 0, K4 and K4b launched by
     the stage-1 training alone, mesh_stage1/ with the OBJ, MTL, JPEGs that
     decode and mlp.json's keys; main --stage 1 --test, and a fresh stage-1
     Trainer reproduces the stage-1 val PSNR within 1e-4 dB;
  8. stage1 (Pillow blocked): the phase-4 field trains MESH_FIELD_STEPS
     more steps, then
     save_mesh at S1_MCUBES^3 (cut from the default 512^3) with
     decimate_target 3e5 and visibility culling
     against the 24 train views; a stage-1 Trainer at bench.py's width
     with -O's stage-1 recipe (s1_shell 4, s1_stochastic, refine at -O's
     ratios, ssaa 2, full 256^2 crops) trains S1_STEPS steps: losses
     finite and falling, overflow 0, K2 and K3 launched by the stage-1
     steps alone, the val PSNR after S1_STEPS steps not more than 0.1 dB
     below the one after half of them (the gap to the field's stage-0 val
     PSNR printed, not gated); PROFILE_STEPS more steps profiled; K2 and
     K3 held
     against their plain versions on the arguments one more step gives
     them (4 shell layers); the rasterizer's
     forward + backward timed against a step; export_stage1 at texture
     S1_TEXTURE (cut from the default 4096).  Wall seconds of the density
     query, marching cubes, cull, clean + decimate, unwrap, bake, inpaint
     and the JPEGs; faces at each refine; peak memory.
  9. sdf: bench.py's stage-0 configuration with sdf=True (NeuS): the
     double-sphere pretrain (cut to SDF_PRETRAIN iterations), gated by
     sdf(0) < 0 < sdf(0.9, 0, 0); SDF_STEPS stage-0 steps (losses and eikonal
     terms finite, the loss falls, K1-K3 launched by these steps alone;
     ms/step, peak memory); the eval on the N_VAL val views (PSNR finite,
     ms per frame); PROFILE_STEPS steps profiled; K2 and K3 held against their plain
     versions on the arguments one more step gives them (the pool's
     points, and the FD normal's 6 taps of each as one call); save_mesh at
     256^3 (not empty, at least half its vertices within 0.05 of the
     analytic surface); a stage-1 Trainer under enable_offset_nerf_grad
     trains SDF_S1_STEPS steps (losses finite, overflow 0, K2/K3 launched
     by its steps, the offsets' last gradient finite and non-zero); on 32 more
     crops the field query's share of the offsets' gradient, K2/K3 held
     against plain at a crop's arguments, and on the crop of the largest
     share the passes with K2/K3 replaced by their plain versions (under
     PyTorch's deterministic algorithms: the image within K2's tolerance
     of the kernels', and, given the kernels' gradient at the image, the
     offsets' gradient within 1e-3 relative L2 of theirs) and with the
     barycentrics detached;
     export_stage1 at 1024.
 10. unbounded (Pillow blocked): a COLMAP capture written by
     generate_colmap_dataset (256x256, UNB_VIEWS views of the spheres
     inside a textured environment sphere, every 8th view val) through
     nerf2mesh_tpu_torch.main --data_format colmap at bench.py's width,
     in three runs, each mesh decimated to UNB_DECIMATE (the outer
     cascades to half): (a) the LLFF recipe (runall_llff.sh: -O's flags,
     fp16 included, but the visibility cull, --bound 4
     --enable_cam_near_far, 3 cascades, no sharpen phase): UNB_STEPS
     steps, the val eval, the inner
     mesh at UNB_MCUBES^3 and the outer cascades', then --stage 1 --iters
     UNB_S1_STEPS (-O's shell recipe, a
     refine at half of them), the export at UNB_TEXTURE^2 and a stage-1 reload
     that reproduces the recorded val PSNR within 1e-4 dB; (b) the 360
     recipe's geometry (runall_360.sh: --bound 16 --enable_cam_center
     --enable_cam_near_far --lambda_entropy 1e-3 --lambda_tv 2e-8, 5
     cascades): UNB360_STEPS steps, the eval and the meshes at
     UNB_SIDE_MCUBES^3; (c) (b) plus --contract (grid bound 2, 2
     cascades): CON_STEPS steps, the meshes, CON_S1_STEPS stage-1 steps
     (no refine) and the export at CON_TEXTURE^2.  Each run: logged losses
     finite and falling, val PSNR finite, K1-K3 launched by its training
     (K2/K3 by its stage-1 steps), K1 held exact and K2/K3 within phase 3's
     tolerances against their plain versions on one more step's arguments,
     and timed there beside phase 3's times; mesh_0.ply within the unit
     box and an outer cascade's mesh past it, within the bound; overflow 0;
     one OBJ a cascade.  Printed: ms/step and the idle share (PROFILE_STEPS
     profiled steps), the untrained marks' wall, eval ms and march rounds a frame,
     the val PSNR of the diffuse render (the eval shades "full" before
     diffuse_step), pack_bits ms at the run's cascades, the export stages'
     walls, peak memory.
 11. captures (Pillow, cv2 and sklearn blocked): a COLMAP capture written
     by generate_colmap_dataset as CAP_VIEWS 4:2:0 JPEGs at CAP_SIZE^2 (no
     images_4/, so --downscale 4 decodes each 1 MP file and resizes it to
     256^2) with depths/*.npy at CAP_DEPTH^2 (0.7 z + 0.3 of the analytic
     z-depth, 5% outlier pixels); its train split loaded once with the JPEG
     decode, the resizes and the RANSAC fits timed (the decode's ms per MP,
     gated at 0.5 s per MP) and each view's fit checked against the maps'
     affine (median view within 1% in a and c, 3/4 of the views in a);
     then three CLI runs at bench width with -O's fp16: (a) the
     runall_sdf_outdoor.sh recipe (-O's flags but the visibility cull,
     --sdf --bound 16 --scale CAP_SCALE --downscale 4 --enable_cam_center
     --enable_cam_near_far --enable_dense_depth --lambda_entropy 1e-3
     --lambda_normal 1e-1, contracted, 2 cascades): the pretrain cut to
     SDF_PRETRAIN, CAP_STEPS of the recipe's 30000 steps, the evals, the
     meshes at CAP_MCUBES^3 decimated to CAP_DECIMATE, then --stage 1
     --iters CAP_S1_STEPS (one refine, at half of them) and the export at
     CAP_TEXTURE^2; (b) the LLFF recipe with
     --enable_sparse_depth, CAP_SPARSE_STEPS steps; (c) a blender scene at
     OPT_SIZE^2 with -O's fp16 and --downscale 2 --train_split trainval
     --patch_size 4
     --color_space linear --trainable_density_grid --lambda_density 1e-4
     --ind_dim 4, OPT_STEPS steps and the evals.  Each run: logged losses
     finite and falling, evals finite, K1-K3 launched by its training and
     held (K1 exact, K2/K3 within phase 3's tolerances) at one more step's
     arguments, PROFILE_STEPS steps profiled (the loss "falls" when the mean of the
     last quarter of its steps is below the first quarter's: a patch step
     sees one view); the depth term zero at step 0 (its ramp)
     and non-zero on every later step that carries depth ((b): those whose
     sparse-depth draw is on; zero on the others); (a) mesh_0.ply not
     empty and within the unit box, stage 1 with overflow 0, K2/K3
     launched and held, one OBJ a cascade.
 12. hard: the hard proxy scene (data/synthetic.py HardScene: checker
     textures, 0.015-radius rods, glossy materials) at 256x256, 24 train
     and HARD_VAL val views, bench.py's stage-0 configuration at full width, in
     four runs: (a) the merged block512 table, HARD_STEPS steps; (b) the
     same with separate tables (sigma_table C = 1, color_table C = 2, by
     patching the trainer module's NetworkSpec: no CLI flag sets them),
     HARD_STEPS steps, K2 and K3 launched at C = 1 and C = 2 and held
     against their plain versions at one more step's arguments; (c)
     separate tables at --grid_layout ref --log2_hashmap_size 14,
     HARD_REF_STEPS steps, K4 and K4b launched at C = 1 and 2; (d)
     separate tables with winsort_fine, HARD_WS_STEPS steps, K5 and K6
     launched at C = 1 and 2.  Each run: every loss finite, the mean of the
     last 8 losses below the first 8's, the val evals finite and the PSNR
     after training above the PSNR before, no C = 3 launch under separate
     tables.  Printed: the val PSNR, ms/step and (PROFILE_STEPS profiled
     steps) idle
     share of (a) and (b) side by side.
 13. entry points (Pillow, cv2 and sklearn blocked in this process; the
     spawned ranks need none of them): (a) a DTU scene
     (data/synthetic.py generate_dtu_dataset: cameras_sphere.npz, image/,
     mask/ of DTU_VIEWS sphere-scene views at ENTRY_SIZE^2) through the CLI
     with --data_format dtu --vis_pose at bench width, DTU_STEPS steps:
     logged losses finite and falling, evals finite, poses.ply parsed (one
     frustum a training view), K1-K3 launched by its training; (b) two
     ranks on the one card (gloo), spawned as torchrun starts them (RANK,
     LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR and a free
     MASTER_PORT set; main's env:// init): in each, the CLI's main at
     bench width with num_rays split over the ranks, stage 0 resumed on
     every rank from the phase-8 field's checkpoint for DIST_STEPS steps
     (the grid updates, the evals, the checkpoints and the S1_MCUBES^3
     culled mesh export by rank 0 included), then stage 1 on that mesh for
     DIST_S1_STEPS steps with one refine and the export; the first
     stage-0 step's all-reduced gradient held against the mean of both
     ranks' gradients computed on rank 0 (tests/test_torch_slice.py's
     tolerances), rank 0's K1-K3 at that step and K2/K3 at the first
     stage-1 step against their plain versions (TOL); both ranks end with
     bit-equal parameters, grids and meshes and the same reduced losses,
     and one set of checkpoints, meshes and the stage-1 package is
     written; each rank's ms/step, the all-reduce's ms a step and its
     launches (K1-K3 in stage 0, K2/K3 in stage 1) printed; (c) the
     viewer (viewer.py) on a free port: VIEWER_FRAMES stage-0 frames of
     the phase-4 field over HTTP with the --viewer_train thread training
     it, each PNG decoded at the controller's size, the downscale moving,
     K1-K3 launched, then one more frame with K1 and K2 held against
     their plain versions at its arguments; then VIEWER_S1_FRAMES frames
     of phase 8's stage-1 state; the round trips printed against the 500
     ms budget; (d)
     entry()'s forward render on the card (K1, K2), then
     dryrun_multichip(2) (two gloo ranks on the card).
 14. checkpoints and codecs (Pillow, cv2, sklearn, orbax, tensorstore and
     zstandard blocked): (a) the phase-4 field (bench width: the block512
     C = 3 table, EMA, both Adam moments, the 128^3 density grid) saved
     under ckpt_backend "orbax", a fresh Trainer loaded from the .ocp:
     every array bit-equal, step and EMA count carried, the val PSNR
     within 1e-4 dB of the saved trainer's; a pickle-backend trainer finds
     the .ocp; the MiB written and the save and load walls beside the
     pickle path's on the same payload, each .ocp wall at most 2x the
     pickle one's; (b) the committed JAX .ocp fixtures
     (nerf2mesh_tpu_torch/fixtures/jax_stage0.ocp, zstd with Huffman
     literals and FSE sequences, and jax_stage0_zarr3.ocp, the same state
     through Orbax's zarr3 handler: sharded chunks, CRC-32C indexes) into
     a Trainer on the card, every leaf's SHA-256 the one JAX's restore
     gave, then one val frame of the zarr3 one's field (K1 and K2
     launched); (c) the committed progressive JPEG capture
     (fixtures/progressive, 12 views at 256^2), PNG kinds (fixtures/png)
     and BMP, TIFF, GIF and WebP variants with the (e) capture's frames
     and masks (fixtures/formats, fixtures/colmap_formats) decoded on the
     host, each array's SHA-256 Pillow's, each format's ms per MP (the
     fastest of DECODE_PASSES passes) printed and held to 500 (the PNG
     kinds, tiny, printed only); then main on the
     capture with --ckpt_backend orbax --n_ckpt 2 for CKPT_STEPS steps
     (every logged loss finite, K1-K3 launched and held against plain at
     one more step, two step .ocp directories left by the rolling window),
     main --test reloading ngp_stage0_latest.ocp, and a fresh Trainer
     reproducing the recorded val PSNR within 1e-4 dB; (d) in phase 8, a
     stage-1 .ocp round trip of its stage-1 state: offsets and topology
     restored, the val PSNR within 1e-4 dB; (e) main on the committed
     COLMAP capture fixtures/colmap_formats (16 views at 96^2: TIFF LZW,
     lossy WebP, lossless WebP and BMP frames, TIFF masks) at bench
     width, bound 4, FMT_STEPS steps: every logged loss finite, K1-K3
     launched by the training, --test, the val PSNR finite, K1-K3 held
     against plain at one more step; (f) the same on the committed
     capture fixtures/colmap_forms (arithmetic baseline and progressive,
     4:4:0, 4:1:1 and lossless JPEG, YCbCr JPEG-in-TIFF, BigTIFF, PPM,
     RLE TGA and QOI frames, PGM and QOI masks); (g) the same on the
     committed capture fixtures/colmap_jp2 (JPEG 2000 frames: JP2 and raw
     codestreams, reversible and irreversible, sYCC, tiles, layers,
     precincts, progression orders; grey .j2k masks); (h) the same on the
     committed capture fixtures/colmap_legacy (old-style JPEG TIFF in both
     forms, LZMA and zstd TIFF, planar YCbCr TIFF, SGI RLE at 8 and 16
     bits, PCX, DCX, ICO of a 32-bit BMP entry and CUR frames; SGI, PCX,
     LZMA TIFF and Group 4 masks, the last read as 0/1); (i) the same on
     the committed capture fixtures/colmap_textures (DDS DXT1, DXT5, BC7,
     BC6H_UF16 and 5:6:5 masked RGB, FTEX DXT1, BLP1 JPEG, BLP2 DXT5 and
     palette, PSD RGB PackBits and RGBA raw, and 24-bit bare DIB frames;
     PSD grey, DDS L, DDS BC4 and PSD bitmap masks, the last read as 0/1);
     (j) the same on the committed capture fixtures/colmap_misc (128^2:
     ICNS in each entry kind (PNG RGBA and RGB, JPEG 2000, RLE and raw
     24-bit with masks) and as Pillow writes it (read at 1024^2), IM RGB
     and RGB;L, SPIDER frames; MSP and XBM masks, read as 0/1); (k) the
     same on the committed capture fixtures/colmap_rare (128^2: SUN 24-bit
     raw and RLE, SUN 32-bit, PIXAR, GIMP brush RGBA, XPM RGB and IPTC
     band-merged frames; McIdas, IM Tools, FITS, XV thumbnail, FLI and XPM
     masks); the phase's wall and (e)'s to (k)'s printed.  (c) decodes the
     JPEG, TIFF, netpbm, TGA, QOI, JPEG 2000, SGI, PCX, DCX, ICO, CUR, DDS,
     FTEX, BLP, PSD, DIB, ICNS, IM, MSP, SPIDER, XBM, SUN, XPM, PIXAR,
     McIdas, GBR, IMT, XV thumbnail, FITS, FLI, PhotoCD (768 x 512) and
     IPTC variants (fixtures/formats, a 512^2 irreversible frame among
     them; legacy TIFF timed by codec: CCITT, old-style JPEG, ThunderScan,
     LZMA, zstd; DDS by codec: BC1-BC7, masked RGB, raw) and the (f)-(k)
     captures' frames and masks too, each format's ms per MP held to 500,
     and logs each format's read (open and read) and decode (from bytes)
     apart from the same fastest pass.
The kernels' "max_abs_err" is the largest over phase 3 and the holds at
phases 8's, 9's, 10's, 11's, 12's, 13's and 14's shapes.
The line before the last is the kernels' JSON record (launch counts from
each kernel's own path: phase 4 for K1-K3, phase 6's training for K5/K6,
phase 7's CLI run for K4 and K4b; K7 lies on no path, so its count from
phase 4 is 0; "stage1_launches": the stage-1 training's, phase 8 for K2
and K3, phase 7 for K4 and K4b; "sdf_launches" and "sdf_stage1_launches":
phase 9's stage-0 and stage-1 training's; "unbounded_launches": phase 10's
three stage-0 trainings' by run, "llff", "360" and "contract", and
"unbounded_stage1_launches" its two stage-1 trainings', "llff" and
"contract"; "captures_launches": phase 11's three stage-0 trainings' by
run, "outdoor", "sparse" and "options", and "captures_stage1_launches"
its stage-1 training's, "outdoor"; "hard_launches": phase 12's four
trainings' by run, "merged", "separate", "ref" and "winsort"; the C = 1
and C = 2 instantiations, "<name>_c1" and "<name>_c2", count their
launches in phase 12's run that reaches them: (b) for K2/K3, (c) for
K4/K4b, (d) for K5/K6; "dtu_launches": phase 13 (a)'s training;
"dist_launches": rank 0's in phase 13 (b), "stage0" and "stage1";
"viewer_launches": phase 13 (c)'s stage-0 serving, frames and training;
"ckpt_cli_launches": phase 14 (c)'s training through main;
"ckpt_zarr3_frame_launches": phase 14 (b)'s val frame of the zarr3
fixture; "ckpt_formats_cli_launches": phase 14 (e)'s training,
"ckpt_forms_cli_launches": phase 14 (f)'s, "ckpt_jp2_cli_launches":
phase 14 (g)'s, "ckpt_legacy_cli_launches": phase 14 (h)'s,
"ckpt_texture_cli_launches": phase 14 (i)'s, "ckpt_misc_cli_launches":
phase 14 (j)'s, "ckpt_rare_cli_launches": phase 14 (k)'s),
the last line the device record.  Imports only
the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
SLICE_STEPS = 128          # grid refresh at 0, slab updates at 16, 32, ...
TIMED_STEPS = 64           # steady-state window: the last TIMED_STEPS steps
WINSORT_STEPS = 64         # phase 6 (exact encode: K5/K6 in every step)
N_VAL = 2                  # val views of phases 4-9 and 11c (cut from 4)
WINSORT_LEVELS = tuple(range(7, 16))   # the gather levels at the full spec
KERNEL_POINTS = 2 ** 18    # phase 3: the point pool of a training step
CLI_STEPS = 256            # phase 7 (a field that marches to a mesh; cut
#                            from 512 for the time limit)
CLI_MCUBES = 256           # phase 7's marching grid
CLI_S1_STEPS = 16          # phase 7's stage 1 (a refine at half of them;
#                            cut from 64, then 32, for the time limit)
CLI_TEXTURE = 1024         # phase 7's texture side
S1_STEPS = 32              # phase 8 (cut from 128, then 64, for the time
#                            limit)
S1_MCUBES = 256            # phase 8's marching grid (the default 512)
S1_TEXTURE = 1024          # phase 8's texture side (the default 4096;
#                            2048 until PR 11)
MESH_FIELD_STEPS = 64      # phase 8: the phase-4 field trains on first
#                            (cut from 256, then 128)
PROFILE_STEPS = 2          # profiled steps of each profiled window (cut
#                            from 8, then 4 to pay for phase 14 (j): each
#                            profiled step costs 0.3-1 s of event handling)
SDF_PRETRAIN = 500         # phase 9's pretrain iterations (the CLI: 2000)
SDF_STEPS = 64             # phase 9's stage-0 steps (cut from 128 in PR 14
#                            for the time limit: its loss falls 10x by then)
SDF_MCUBES = 256           # phase 9's marching grid
SDF_S1_STEPS = 16          # phase 9's stage-1 steps (cut from 32)
SDF_SHARE_CROPS = 32       # phase 9's crops for the field's gradient share
UNB_VIEWS = 16             # phase 10's COLMAP capture (every 8th is val;
#                            cut from 32, then 24, for the time limit)
UNB_SIZE = 256             # its frames' side
UNB_STEPS = 64             # phase 10a (LLFF recipe, bound 4) stage-0 steps
#                            (256 until PR 11, 128 until PR 13)
UNB_MCUBES = 128           # phase 10a's inner marching grid (default 512;
#                            256 until PR 11)
UNB_S1_STEPS = 16          # phase 10a's stage 1 (cut from 64, then 32,
#                            for the time limit)
UNB_TEXTURE = 512          # phase 10a's texture side (default 4096; 1024
#                            until PR 11)
UNB360_STEPS = 64          # phase 10b (the 360 recipe's geometry, bound 16;
#                            128 until PR 11)
UNB_SIDE_MCUBES = 128      # phase 10b's and 10c's inner marching grid
UNB_DECIMATE = 3e4         # phase 10's decimate_target (default 3e5; cut
#                            from 6e4): the outer cascades get half
#                            each, and stage 1's face budget (87,381 at
#                            256^2) is shared
CON_STEPS = 64             # phase 10c (10b + --contract)
CON_S1_STEPS = 8           # phase 10c's stage 1 (cut from 16)
CON_TEXTURE = 512          # phase 10c's texture side
CAP_VIEWS = 16             # phase 11's JPEG capture (every 8th is val; cut
#                            from 32 in PR 14: writing it took 25 s)
CAP_SIZE = 1024            # its frames' side: 4:2:0 JPEGs, decoded at 1 MP
CAP_DEPTH = 384            # its depths/*.npy side
CAP_AFFINE = (0.7, 0.3)    # the maps are a * z + c of the analytic z-depth
CAP_OUTLIERS = 0.05        # with this share of outlier pixels
CAP_SCALE = 0.5            # --scale (runall_sdf_outdoor.sh: 0.2): cameras at
#                            1.4, the environment at 2.8, so the pretrain's
#                            outer shell (radius 2) lies in the points' box
#                            and the outer cascade is not empty (ROADMAP C)
CAP_STEPS = 64             # phase 11a: stage-0 steps of the 30000 of the
#                            recipe (its schedule, cut after 64 steps; 128
#                            before)
CAP_MCUBES = 128           # phase 11a's marching grid
CAP_DECIMATE = 3e4         # its decimate_target: the SDF's outer level is
#                            decimated to it too, and the two share stage
#                            1's face budget (87,381 at 256^2)
CAP_S1_STEPS = 16          # phase 11a's stage 1 (cut from 32)
CAP_TEXTURE = 512          # phase 11a's texture side
CAP_SPARSE_STEPS = 40      # phase 11b (the LLFF recipe + sparse depth;
#                            cut from 64 to pay for phase 14 (h), then 48
#                            to pay for phase 14 (k))
OPT_SIZE = 512             # phase 11c's blender scene side (--downscale 2)
OPT_STEPS = 40             # phase 11c (the A6 (d) options; cut from 64 to
#                            pay for phase 14 (h), then 48 for (k))
HARD_STEPS = 32            # phase 12 (a) and (b): the hard scene, merged and
#                            separate tables (cut from 256, then 128, for
#                            the time limit: whole runs took 1272 s, then
#                            over 1200 s on a slower host; then 64, to pay
#                            for phase 14 (i), then 40 for (k))
HARD_REF_STEPS = 32        # phase 12 (c): separate tables, ref 2^14 table
#                            (64 until phase 14 (i), 40 until (k))
HARD_WS_STEPS = 40         # phase 12 (d): separate tables, winsort_fine
#                            (its val PSNR rose 0.036 dB in 32 steps; 64
#                            until phase 14 (i))
HARD_VAL = 1               # phase 12's val views (cut from 4, then 2 in PR
#                            14, for the time limit: its 8 evals of 4 views
#                            took about 55 s of a run that passed 1200 s)
ENTRY_SIZE = 256           # phase 13 (a), (b): the scenes' side
DTU_VIEWS = 24             # phase 13 (a): every 8th is val (3), 21 train
DTU_STEPS = 48             # phase 13 (a): stage-0 steps through the CLI
#                            (64 until phase 14 (k))
DIST_STEPS = 32            # phase 13 (b): stage-0 steps on each of 2 ranks
DIST_S1_STEPS = 8          # phase 13 (b): stage-1 steps, a refine at half
DIST_TEXTURE = 512         # phase 13 (b): the stage-1 export's texture side
DIST_TIMEOUT = 600         # phase 13 (b): seconds the ranks may take
VIEWER_FRAMES = 8          # phase 13 (c): stage-0 frames over HTTP
VIEWER_S1_FRAMES = 2       # phase 13 (c): stage-1 frames
CKPT_STEPS = 32            # phase 14 (c): stage-0 steps through the CLI on
#                            the committed progressive capture
FMT_STEPS = 16             # phase 14 (e)-(k): stage-0 steps through the
#                            CLI on the committed captures in other formats
DECODE_PASSES = 3          # phase 14 (c): timed passes over the fixtures
TOL = {"occ_lookup": (0.0, 0.0), "inwin_fwd": (1e-5, 0.0),
       "inwin_bwd": (1e-5, 1e-4), "winsort_fwd": (1e-5, 0.0),
       "winsort_bwd": (1e-5, 1e-4), "sweep_fwd": (1e-5, 0.0),
       "sweep_bwd": (1e-5, 1e-4), "inwin_dense": (1e-5, 0.0),
       "encode": (1e-5, 1e-5)}
# the H100 SXM's published peaks (device memory; fp32 outside the tensor
# cores) for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12      # dense, on the tensor cores


def trilinear_flops(n_point_levels: int, channels: int = 3) -> int:
    """fp32 operations of a trilinear encode (or its gradient) over n
    (point, level) pairs, all 8 corners: the lattice position, fraction and
    1 - fraction (12), each corner's weight (2) and its channels' multiply
    and add (2C).  Integer index arithmetic is not counted."""
    return n_point_levels * (12 + 8 * (2 + 2 * channels))


def bound(nbytes: int, flops: int):
    """(least ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the fp32 operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_rows(spec, levels) -> int:
    return sum(int(spec.offsets[l + 1] - spec.offsets[l]) for l in levels)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print msg after the seconds since the script started."""
    print(f"{time.perf_counter() - T_START:7.1f} {msg}", flush=True)


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn over `reps` back-to-back runs between two CUDA
    events, after a warm-up run: the host enqueues ahead of the card, so a
    wrapper's own Python time shows only where it exceeds its kernel's."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def profile_region(fn, label: str, per: int = 1, top: int = 6):
    """Run fn once under torch.profiler and log the wall time, the device
    busy time (the sum of the kernels' durations on the one stream), the
    device's idle share, the kernel count and the ops with the most device
    time (host ops, by the device time of their own kernels: key_averages'
    self device time), each divided by `per` (steps or frames); says so
    when the profiler records no device time or is refused.  Reads the
    profiler's raw events: building its FunctionEvent tree costs about 50
    us of host time an event, tens of seconds for one profiled eval frame.
    Returns (wall ms, device busy ms) per step or frame, or None without
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:
        log(f"[profile] {label}: profiler refused ({e})")
        return None
    ops, kern = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kern.append((e.linked_correlation_id(), e.name(),
                         e.duration_ns()))
        elif e.linked_correlation_id() == 0:
            # a host op (the CUDA runtime's calls link to theirs)
            ops[e.correlation_id()] = e.name()
    busy = sum(k[2] for k in kern) / 1e6
    if not kern or busy <= 0:
        log(f"[profile] {label}: the profiler saw no device time")
        return None
    by_op = collections.Counter()
    for corr, name, ns in kern:
        by_op[ops.get(corr, name)[:48]] += ns / 1e6
    log(f"[profile] {label}: wall {wall / per:.2f} ms, device busy "
        f"{busy / per:.2f} ms, idle share {1 - busy / wall:.3f}, "
        f"{len(kern) / per:.0f} kernels, per {'step' if per > 1 else 'run'}"
        f" (profiled); top device time: " + "; ".join(
            f"{k} {t / per:.3f} ms ({t / busy:.1%})"
            for k, t in by_op.most_common(top)) + f"; the window took "
        f"{time.perf_counter() - t_all:.2f} s with the profiler's event "
        f"handling")
    return wall / per, busy / per


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; count {torch.cuda.device_count()}")
    return card, name


def phase_build():
    from nerf2mesh_tpu_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    path = kbuild.build(verbose=True)
    kbuild.load()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kbuild.build_seconds if kbuild.build_seconds else 'cached'})")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def boundary_points(spec, levels, rng, n_per_level=64):
    """Points whose lattice position x*scale+shift is an integer on a block
    edge (a multiple of 8, or 7 below one) or within 1 ulp of it, per level:
    where a floor computed two ways could disagree."""
    pts = []
    for l in levels:
        s = np.float32(spec.level_scale32(l))
        nb = int(spec.block_counts[l])
        for _ in range(n_per_level):
            p = rng.uniform(0.05, 0.95, 3).astype(np.float32)
            axis = rng.integers(3)
            g = 8 * rng.integers(1, max(nb - 1, 2)) - rng.integers(2)
            x = np.float32((g - np.float32(spec.shift)) / s)
            x = np.nextafter(x, np.float32(rng.choice([-1, 2])) * x) \
                if rng.random() < 0.6 else x
            p[axis] = np.clip(x, 0.0, 1.0)
            pts.append(p)
    return np.stack(pts)


def same_window_tile(spec, levels, rng):
    """(level, tile points [128, 3]) whose 2x2x2 block neighbourhood holds two
    slots with the same window id, on the first level of `levels` that has
    such a neighbourhood (at the full spec: level 8; levels 5-7 have none).
    The points spread over all 8 slots; one sits at the base corner."""
    from nerf2mesh_tpu_torch.ops.hashgrid import block_window
    slots = torch.tensor([[s & 1, (s >> 1) & 1, (s >> 2) & 1] for s in range(8)])
    for l in levels:
        nb = int(spec.block_counts[l])
        ax = torch.arange(nb - 1)
        b = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
        win = torch.sort(block_window(b[:, None, :] + slots[None], spec, l), 1)[0]
        hit = (win[:, 1:] == win[:, :-1]).any(1).nonzero()[:, 0]
        if len(hit):
            base = b[hit[0]].numpy()
            cells = 8 * base[None] + rng.uniform(0.0, 15.0, (128, 3))
            cells[0] = 8 * base + 0.25
            pts = ((cells - spec.shift) / spec.level_scale32(l)).astype(np.float32)
            return int(l), np.clip(pts, 0.0, 1.0)
    raise RuntimeError(f"no same-window slot pair on levels {levels}")


def coarse_cells(cfg, ds, views, pix, dev):
    """The occupancy grid cells that the sampler's coarse pass tests for the
    rays of pixels `pix` of ds's views `views` (numpy [N] each), at the
    trainer's render spec: int32 [N, Kc] (sampling.occupancy_index)."""
    from nerf2mesh_tpu_torch.data.rays import get_rays
    from nerf2mesh_tpu_torch.models.renderer import RenderSpec
    from nerf2mesh_tpu_torch.ops import sampling
    rs = RenderSpec(bound=cfg.bound, contract=cfg.contract,
                    grid_size=cfg.grid_size, min_near=cfg.min_near,
                    max_steps=cfg.max_steps, num_coarse=cfg.coarse_per_ray,
                    dt_gamma=cfg.dt_gamma)
    rays = get_rays(torch.from_numpy(ds.poses[views]).to(dev),
                    tuple(float(v) for v in ds.intrinsics_for(0)), ds.H, ds.W,
                    torch.from_numpy(pix).to(dev))
    aabb = torch.tensor([-rs.bound] * 3 + [rs.bound] * 3, device=dev)
    nears, fars = sampling.near_far_from_aabb(rays["rays_o"], rays["rays_d"],
                                              aabb, rs.min_near)
    _, dtc, xyz = sampling.coarse_candidates(
        rays["rays_o"], rays["rays_d"], nears, fars, rs.num_coarse,
        rs.grid_size, rs.bound, rs.dt_gamma, rs.max_steps)
    return sampling.occupancy_index(xyz, dtc, rs.bound, rs.contract,
                                    rs.cascades, rs.grid_size)[0]


def sampler_cells(dev, rng):
    """K1's indices on the sampler's path: (training: 32768 rays of random
    train views and pixels, an eval round: 8192 rays of val view 0, rows
    112-143), each [rays, 128], at bench.py's configuration."""
    cfg = bench_config()
    ds, val = scene(cfg)
    n = 32768
    train = coarse_cells(cfg, ds, rng.integers(0, ds.num_frames, n),
                         rng.integers(0, ds.H * ds.W, n), dev)
    pix = np.arange(112 * val.W, 144 * val.W)
    return train, coarse_cells(cfg, val, np.zeros(len(pix), np.int64), pix, dev)


def occ_kernel(dev, rng):
    """K1 against its plain version and the unpacked grid on a random 128^3
    grid: on the sampler's indices for a training step (the row's time) and
    an eval round, and on 32768 x 128 uniformly random cells; pack_bits,
    which repacks the grid before every K1 launch, timed beside it."""
    from nerf2mesh_tpu_torch.ops import occ_sweep
    H = 128
    occ = torch.from_numpy((rng.random((1, H, H, H)) < 0.3).astype(np.uint8)).to(dev)
    words = occ_sweep.pack_bits(occ)
    train, eval_round = sampler_cells(dev, rng)
    rand = torch.from_numpy(rng.integers(0, H ** 3, (32768, 128),
                                         dtype=np.int32)).to(dev)
    cases = {"sampler (training)": train, "sampler (eval round)": eval_round,
             "random": rand, "random, a view one element in":
             rand.reshape(-1)[1:4098]}
    for name, idx in cases.items():
        got = occ_sweep.occ_lookup(words, idx)
        want = occ_sweep.occ_lookup_plain(words, idx)
        direct = occ.reshape(-1)[idx.long()].to(torch.int32)
        err = int((got != want).sum()) + int((got != direct).sum())
        log(f"[kernels] K1 on {name} {list(idx.shape)}: {err} mismatching bits; "
            f"{cuda_time_ms(lambda: occ_sweep.occ_lookup(words, idx)):.4f} ms, "
            f"distinct cells {int(torch.unique(idx).numel())}")
        if err:
            raise AssertionError(f"K1 occ_lookup on {name}: {err} mismatching bits")
    log(f"[kernels] pack_bits of the {H}^3 grid: "
        f"{cuda_time_ms(lambda: occ_sweep.pack_bits(occ)):.4f} ms")
    return dict(
        name="occ_lookup", route="cuda",
        source="nerf2mesh_tpu_torch/csrc/occ_lookup.cu",
        replaces="nerf2mesh_tpu/ops/occ_sweep.py:51",
        max_abs_err=0.0,
        ms=cuda_time_ms(lambda: occ_sweep.occ_lookup(words, train)),
        plain_ms=cuda_time_ms(lambda: occ_sweep.occ_lookup_plain(words, train)),
        bound=bound(words.numel() * 4 + 2 * train.numel() * 4, 0))


def phase_kernels(dev):
    from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec, hashgrid_encode
    from nerf2mesh_tpu_torch.ops import splat_encode as se

    rng = np.random.default_rng(SEED)
    results = [occ_kernel(dev, rng)]

    # K2/K3: the full merged table, 2^18 points, kernel levels 0-8 (the
    # trainer starts with 0-6 and its probe can move finer levels over; 8 is
    # the first level with a same-window slot pair)
    spec = HashGridSpec(num_levels=16, level_dim=3, log2_hashmap_size=19,
                        desired_resolution=2048, layout="block512")
    levels = tuple(range(9))
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_size, 3))
                             .astype(np.float32)).to(dev)
    N = KERNEL_POINTS
    sl, tile = same_window_tile(spec, levels, rng)
    bnd = boundary_points(spec, levels, rng)
    n_bulk = N - 128 - len(bnd)
    d = rng.normal(size=(n_bulk // 2, 3))
    shell = 0.5 + 0.3 * d / np.linalg.norm(d, axis=1, keepdims=True) \
        + rng.normal(0, 0.01, (n_bulk // 2, 3))
    bulk = np.concatenate([shell, rng.uniform(0, 1, (n_bulk - n_bulk // 2, 3)),
                           bnd]).astype(np.float32)
    xb = torch.from_numpy(np.clip(bulk, 0, 1)).to(dev)
    perm, _ = se.morton_perm(xb)
    x = torch.cat([xb[perm], torch.from_numpy(tile).to(dev)]).contiguous()
    T = N // se.TILE
    metas = [se.tile_meta(x.reshape(T, se.TILE, 3), spec, l) for l in levels]
    bases = torch.stack([m[0] for m in metas]).contiguous()
    rows = torch.stack([m[1] for m in metas]).contiguous()
    last = rows[sl, -1]
    if len(set(last.tolist())) == 8:
        raise AssertionError("same-window tile lost its window collision")

    err2 = 0.0
    for lk in (7, 9):       # levels 0-6, where the trainer starts, and 0-8
        fargs = (table, x, bases[:lk].contiguous(), rows[:lk].contiguous(),
                 spec, levels[:lk])
        e = float((se.inwin_fwd(*fargs) - se.inwin_fwd_plain(*fargs))
                  .abs().max())
        log(f"[kernels] K2 at levels 0-{lk - 1}: max|err| {e:.3e}, "
            f"{cuda_time_ms(lambda: se.inwin_fwd(*fargs)):.4f} ms")
        err2 = max(err2, e)
    out_p = se.inwin_fwd_plain(table, x, bases, rows, spec, levels)
    g = torch.from_numpy(rng.normal(size=(N, len(levels), 3))
                         .astype(np.float32)).to(dev)
    bargs = (x, bases, rows, spec, levels, spec.table_size)
    dt_k = se.inwin_bwd(g, *bargs)
    err3 = float((dt_k - se.inwin_bwd_plain(g, *bargs)).abs().max())
    # atomics add each row's ~100s of terms in another order: the rtol is
    # taken relative to the row's sum of |terms| (atomic_tol_margin)
    tol3 = atomic_tol_margin(se.inwin_bwd, se.inwin_bwd_plain, g, bargs)
    log(f"[kernels] K2 max|err| {err2:.3e}; K3 max|err| {err3:.3e}; "
        f"in-window corner share "
        f"{float((out_p != 0).any(-1).float().mean()):.3f}")
    if not err2 <= TOL["inwin_fwd"][0]:
        raise AssertionError(f"K2 inwin_fwd disagrees: {err2}")
    if tol3 < 0:
        raise AssertionError(f"K3 inwin_bwd disagrees: {err3}")
    # the colliding slot pair's window rows got the gradient of both slots
    n_win_rows = int(dt_k[int(spec.offsets[sl]):int(spec.offsets[sl + 1])]
                     .abs().sum(-1).gt(0).sum())
    log(f"[kernels] same-window tile at level {sl}: rows {last.tolist()}, "
        f"{n_win_rows} table rows of the level touched")
    inwin_bwd_extra(dev, spec, levels, g, bargs)

    # K2 + residual == plain exact encode (kernel levels 0-8, gather 9-15)
    gather = tuple(range(9, 16))
    feat, cnt = se.splat_encode_raw(table, x, spec, gather_levels=gather)
    ref = hashgrid_encode(table, x, spec)
    err_enc = float((feat - ref).abs().max())
    log(f"[kernels] splat_encode_raw vs hashgrid_encode max|err| "
        f"{err_enc:.3e}; residual corners/level {cnt.tolist()}")
    atol, rtol = TOL["encode"]
    if not torch.allclose(feat, ref, atol=atol, rtol=rtol):
        raise AssertionError(f"K2 + residual != hashgrid_encode: {err_enc}")

    # bytes: each input read once (the table rows of the kernel's levels),
    # each output written once; the backward writes the whole [total, 3]
    # gradient its wrapper zeroes
    Lk = len(levels)
    meta = bases.numel() * 4 + rows.numel() * 4 + x.numel() * 4
    results.append(dict(
        name="inwin_fwd", route="cuda",
        source="nerf2mesh_tpu_torch/csrc/splat_inwin.cu",
        replaces="nerf2mesh_tpu/ops/splat_encode.py:234", max_abs_err=err2,
        ms=cuda_time_ms(lambda: se.inwin_fwd(table, x, bases, rows, spec, levels)),
        plain_ms=cuda_time_ms(
            lambda: se.inwin_fwd_plain(table, x, bases, rows, spec, levels)),
        bound=bound(level_rows(spec, levels) * 12 + meta + N * Lk * 12,
                    trilinear_flops(N * Lk))))
    results.append(dict(
        name="inwin_bwd", route="cuda",
        source="nerf2mesh_tpu_torch/csrc/splat_inwin.cu",
        replaces="nerf2mesh_tpu/ops/splat_encode.py:263", max_abs_err=err3,
        ms=cuda_time_ms(lambda: se.inwin_bwd(g, *bargs)),
        plain_ms=cuda_time_ms(lambda: se.inwin_bwd_plain(g, *bargs)),
        bound=bound(N * Lk * 12 + meta + spec.table_size * 12,
                    trilinear_flops(N * Lk))))
    results += dense_kernels(table, x, bases, rows, spec,
                             bound(level_rows(spec, (6,)) * 12 + (bases.numel()
                                   + rows.numel()) * 4 // Lk + x.numel() * 4
                                   + N * 12, trilinear_flops(N)))
    results += winsort_kernels(dev, spec, table, rng)
    results += sweep_kernel(dev, rng)
    results += channel_kernels(dev, rng)
    for r in results:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        r["library_ms"] = None      # no one PyTorch call computes these
        log(f"[kernels] {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return results


def dense_kernels(table, x, bases, rows, spec, k7_bound, level=6,
                  held=(6, 8)):
    """K7b, K7c and K7d (the TPU's timing variants of K2, on no path) on
    K2's points against their plain versions at each level of `held` (8 is
    the first level with a same-window slot pair, whose window is staged
    twice), and timed at `level` beside K2's bound there (the same work,
    whatever implements it), the dense product's own floor (its flops as
    three tf32 products on the tensor cores, and as one fp32 product on the
    fp32 cores) and torch.bmm of its operands (a yardstick of the
    contraction alone: no wx, no staging)."""
    from nerf2mesh_tpu_torch.ops import inwin_variants as iv
    variants = (("inwin_dense_deep", True, iv.inwin_dense_plain),
                ("inwin_dense_const_rows", False,
                 iv.inwin_dense_const_rows_plain),
                ("inwin_dense_four_tiles", True, iv.inwin_dense_plain))

    def args_of(l, with_rows):
        return ((table, x, bases[l], rows[l], spec, l) if with_rows
                else (table, x, bases[l], spec, l))
    errs = collections.defaultdict(float)
    for l in held:
        for name, with_rows, plain in variants:
            a = args_of(l, with_rows)
            err = float((getattr(iv, name)(*a) - plain(*a)).abs().max())
            log(f"[kernels] K7 {name} at level {l}: max|err| {err:.3e}")
            if not err <= TOL["inwin_dense"][0]:
                raise AssertionError(f"K7 {name} at level {l} disagrees: {err}")
            errs[name] = max(errs[name], err)
    N = x.shape[0]
    flops = 2 * 48 * 256 * N                 # [48, 256] x [256, 128] a tile
    log(f"[kernels] K7 dense product at level {level}: {flops / 1e9:.3f} "
        f"GFLOP; floor {3 * flops / TF32_FLOPS_PER_S * 1e3:.4f} ms as 3xTF32 "
        f"on the tensor cores, {flops / FP32_FLOPS_PER_S * 1e3:.4f} ms on the "
        f"fp32 cores; K2's bound at the level {k7_bound[0]:.4f} ms "
        f"({k7_bound[1]})")
    a, b, _ = iv.dense_operands(table, x, bases[level], rows[level], spec,
                                level)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            log(f"[kernels] K7 yardstick, contraction only, not the function: "
                f"torch.bmm {list(a.shape)} x {list(b.shape)} fp32 with "
                f"allow_tf32={tf32}: "
                f"{cuda_time_ms(lambda: torch.bmm(a, b)):.4f} ms")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    del a, b
    res = []
    for name, with_rows, plain in variants:
        fn, a = getattr(iv, name), args_of(level, with_rows)
        res.append(dict(
            name=name, route="cuda",
            source="nerf2mesh_tpu_torch/csrc/inwin_dense.cu",
            replaces="workspace/ab/microbench_kernel_variants.py:" + {
                "inwin_dense_deep": "64", "inwin_dense_const_rows": "109",
                "inwin_dense_four_tiles": "149"}[name],
            max_abs_err=errs[name], ms=cuda_time_ms(lambda: fn(*a)),
            plain_ms=cuda_time_ms(lambda: plain(*a)), bound=k7_bound))
    return res


def atomic_tol_margin(kernel, plain, g, args):
    """Least margin of a gradient kernel against its plain version: atol +
    rtol of each row's summed |terms| (the plain gradient of |g|), for g and
    for |g| (where every term is >= 0 and the bound is the plain allclose).
    Negative means a row disagrees.  The tolerance is TOL[kernel's name]."""
    atol, rtol = TOL[kernel.__name__]
    mag = plain(g.abs(), *args)
    return min(float((atol + rtol * mag - (kernel(g, *args) - plain(g, *args))
                      .abs()).min()),
               float((atol + rtol * mag - (kernel(g.abs(), *args) - mag)
                      .abs()).min()))


def touched_tol_share(kernel, plain, g, args):
    """The largest |kernel - plain| over its tolerance (atomic_tol_margin's)
    among the gradient entries some term reaches (the plain gradient of |g|
    above 0): how near the entries the kernel writes came to failing."""
    atol, rtol = TOL[kernel.__name__]
    mag = plain(g.abs(), *args)
    err = (kernel(g, *args) - plain(g, *args)).abs()
    hit = mag > 0
    return float((err[hit] / (atol + rtol * mag[hit])).max())


def inwin_bwd_extra(dev, spec, levels, g, bargs):
    """K3's global vector adds on the main input, counted by the plain
    corner walk; then K3 on the hot spot, 16 morton tiles inside one
    lattice cell of level 0, where every lane of every warp adds into the
    same 8 rows."""
    from nerf2mesh_tpu_torch.ops import splat_encode as se
    plain = se.inwin_bwd_plain
    adds = se.inwin_bwd_vector_adds(g, *bargs[:-1])
    inw = se._inwin_corners(*bargs[:-1])[2]
    scalar = 3 * int((inw & (g != 0).any(-1)[..., None]).sum())
    log(f"[kernels] K3 global vector adds {adds} (the scalar atomics they "
        f"replace: {scalar})")

    rng = np.random.default_rng(SEED + 1)
    s0 = spec.level_scale32(0)
    xh = torch.from_numpy(((7 + rng.uniform(0.01, 0.99, (2048, 3)) - spec.shift)
                           / s0).astype(np.float32)).to(dev)
    if not bool((torch.floor(xh * s0 + spec.shift) == 7).all()):
        raise AssertionError("hot spot left its level-0 cell")
    metas = [se.tile_meta(xh.reshape(-1, se.TILE, 3), spec, l) for l in levels]
    hargs = (xh, torch.stack([m[0] for m in metas]).contiguous(),
             torch.stack([m[1] for m in metas]).contiguous(), spec, levels,
             spec.table_size)
    gh = torch.from_numpy(rng.normal(size=(2048, len(levels), 3))
                          .astype(np.float32)).to(dev)
    margin = atomic_tol_margin(se.inwin_bwd, plain, gh, hargs)
    err = float((se.inwin_bwd(gh, *hargs) - plain(gh, *hargs)).abs().max())
    share = touched_tol_share(se.inwin_bwd, plain, gh, hargs)
    log(f"[kernels] K3 hot spot (16 tiles in one level-0 cell): max|err| "
        f"{err:.3e}; largest error over tolerance among touched entries "
        f"{share:.3f}")
    if margin < 0:
        raise AssertionError(f"K3 disagrees on the hot spot: {err}")


def winsort_long_run(dev, spec):
    """K6 on a long run: 2048 points inside one level-15 block (a window
    whose run spans 16 tiles, one owner block) and 2048 uniform points."""
    from nerf2mesh_tpu_torch.ops import splat_encode as se
    rng = np.random.default_rng(SEED + 2)
    s = np.float32(spec.level_scale32(15))
    pts = np.concatenate([(8 * 100 + rng.uniform(0.01, 7.99, (2048, 3))
                           - spec.shift) / s, rng.uniform(0, 1, (2048, 3))])
    xc = torch.from_numpy(pts.astype(np.float32)).to(dev)
    oob = torch.zeros(4096, dtype=torch.bool, device=dev)
    metas = [se.winsort_meta(xc, oob, spec, l) for l in WINSORT_LEVELS]
    perm = torch.stack([m[0] for m in metas]).to(torch.int32).contiguous()
    wins = torch.stack([m[1] for m in metas]).contiguous()
    slots = torch.stack([m[2] for m in metas]).contiguous()
    run = int((wins[-1] == wins[-1, perm[-1].long().argsort()[0]]).sum())
    g = torch.from_numpy(rng.normal(size=(4096, len(WINSORT_LEVELS), 3))
                         .astype(np.float32)).to(dev)
    args = (xc, perm, wins, slots, spec, WINSORT_LEVELS, spec.table_size)
    err = float((se.winsort_bwd(g, *args) - se.winsort_bwd_plain(g, *args))
                .abs().max())
    share = touched_tol_share(se.winsort_bwd, se.winsort_bwd_plain, g, args)
    log(f"[kernels] K6 long run ({run} points in one level-15 window): "
        f"max|err| {err:.3e}; largest error over tolerance among touched "
        f"entries {share:.3f}")
    if run < 2048 or atomic_tol_margin(se.winsort_bwd, se.winsort_bwd_plain,
                                       g, args) < 0:
        raise AssertionError(f"K6 disagrees on the long run: {err}")


def window_zero_block(spec, l, dev, rng):
    """An 8^3 block of level l, off the grid's faces, whose window id is 0
    (searched among 2^18 random blocks)."""
    from nerf2mesh_tpu_torch.ops.hashgrid import block_window
    nb = int(spec.block_counts[l])
    b = torch.from_numpy(rng.integers(1, nb - 1, (2 ** 18, 3))).to(dev)
    return b[(block_window(b, spec, l) == 0).nonzero()[0, 0]].cpu().numpy()


def winsort_fwd_cases(dev, spec, table, rng):
    """K5 against winsort_fwd_plain beyond the main input: 2^18 points in 16
    tight clusters, a run of 2^15 points in one level-15 window, 4096 and
    128 uniform points, a clamped tail (the last tile's last slot clamps
    from -1 to 0 while window 0 is a real window of level 15 whose run
    reaches into that tile), and one and 16 levels; returns the largest
    error."""
    from nerf2mesh_tpu_torch.ops import splat_encode as se
    s15 = np.float32(spec.level_scale32(15))
    c = rng.uniform(0.2, 0.8, (16, 3))
    zero = window_zero_block(spec, 15, dev, rng)
    cases = {
        "clusters": c[rng.integers(0, 16, KERNEL_POINTS)]
        + rng.normal(0, 0.002, (KERNEL_POINTS, 3)),
        "long_run": np.concatenate([
            (8 * 100 + rng.uniform(0.01, 7.99, (2 ** 15, 3)) - spec.shift) / s15,
            rng.uniform(0, 1, (2 ** 15, 3))]),
        "n4096": rng.uniform(0, 1, (4096, 3)),
        "n128": rng.uniform(0, 1, (128, 3)),
        "clamped_tail": np.concatenate([
            (8 * zero + rng.uniform(0.01, 7.99, (140, 3)) - spec.shift) / s15,
            rng.uniform(0, 1, (100, 3)), np.full((16, 3), 2.0)]),
        "lw1": rng.uniform(0, 1, (2 ** 16, 3)),
        "lw16": rng.uniform(0, 1, (2 ** 16, 3)),
    }
    worst = 0.0
    for name, pts in cases.items():
        levels = ((15,) if name == "lw1" else tuple(range(16))
                  if name == "lw16" else WINSORT_LEVELS)
        x = torch.from_numpy(pts.astype(np.float32)).to(dev)
        xc = x.clamp(0, 1).contiguous()
        oob = ((x < 0) | (x > 1)).any(-1)
        metas = [se.winsort_meta(xc, oob, spec, l) for l in levels]
        perm = torch.stack([m[0] for m in metas]).to(torch.int32).contiguous()
        wins = torch.stack([m[1] for m in metas]).contiguous()
        slots = torch.stack([m[2] for m in metas]).contiguous()
        if name == "clamped_tail":
            k = levels.index(15)
            if slots[k, -1].tolist() != [0, 0] or int((wins[k] == 0).sum()) < 140:
                raise AssertionError(f"clamped tail lost its shape: "
                                     f"{slots[k, -1].tolist()}")
        args = (table, xc, perm, wins, slots, spec, levels)
        err = float((se.winsort_fwd(*args) - se.winsort_fwd_plain(*args))
                    .abs().max())
        log(f"[kernels] K5 {name} ({x.shape[0]} points, {len(levels)} "
            f"levels): max|err| {err:.3e}")
        if not err <= TOL["winsort_fwd"][0]:
            raise AssertionError(f"K5 winsort_fwd disagrees on {name}: {err}")
        worst = max(worst, err)
    return worst


def winsort_kernels(dev, spec, table, rng):
    """K5/K6 on 2^18 uniform points (the fine-level regime: no spatial
    locality) at winsort levels 7-15, with out-of-bounds points and points on
    and 1 ulp from block edges."""
    from nerf2mesh_tpu_torch.ops.hashgrid import hashgrid_encode
    from nerf2mesh_tpu_torch.ops import splat_encode as se

    wl, N = WINSORT_LEVELS, KERNEL_POINTS
    bnd = boundary_points(spec, wl, rng)
    oobp = rng.uniform(0, 1, (64, 3))
    oobp[:32, 0], oobp[32:, 2] = 1.5, -0.2
    pts = np.concatenate([rng.uniform(0, 1, (N - len(bnd) - 64, 3)), bnd, oobp])
    x = torch.from_numpy(pts[rng.permutation(N)].astype(np.float32)).to(dev)
    xc = x.clamp(0, 1).contiguous()
    oob = ((x < 0) | (x > 1)).any(-1)
    metas = [se.winsort_meta(xc, oob, spec, l) for l in wl]
    perm = torch.stack([m[0] for m in metas]).to(torch.int32).contiguous()
    wins = torch.stack([m[1] for m in metas]).contiguous()
    slots = torch.stack([m[2] for m in metas]).contiguous()

    out_k = se.winsort_fwd(table, xc, perm, wins, slots, spec, wl)
    out_p = se.winsort_fwd_plain(table, xc, perm, wins, slots, spec, wl)
    err5 = float((out_k - out_p).abs().max())
    g = torch.from_numpy(rng.normal(size=(N, len(wl), 3))
                         .astype(np.float32)).to(dev)
    args = (xc, perm, wins, slots, spec, wl, spec.table_size)
    err6 = float((se.winsort_bwd(g, *args)
                  - se.winsort_bwd_plain(g, *args)).abs().max())
    tol6 = atomic_tol_margin(se.winsort_bwd, se.winsort_bwd_plain, g, args)
    share = float(torch.stack([m[3] for m in metas]).float().mean())
    log(f"[kernels] K5 max|err| {err5:.3e}; K6 max|err| {err6:.3e}; slotted "
        f"point share {share:.3f}; tiles with equal slots "
        f"{int((slots[..., 0] == slots[..., 1]).sum())} of "
        f"{slots.shape[0] * slots.shape[1]}")
    if not err5 <= TOL["winsort_fwd"][0]:
        raise AssertionError(f"K5 winsort_fwd disagrees: {err5}")
    if tol6 < 0:
        raise AssertionError(f"K6 winsort_bwd disagrees: {err6}")
    err5 = max(err5, winsort_fwd_cases(dev, spec, table, rng))
    winsort_long_run(dev, spec)

    feat, _ = se.splat_encode_raw(table, x, spec, gather_levels=wl,
                                  winsort_levels=wl)
    ref = hashgrid_encode(table, x, spec)
    err_enc = float((feat - ref).abs().max())
    log(f"[kernels] winsort splat_encode_raw vs hashgrid_encode max|err| "
        f"{err_enc:.3e}")
    atol, rtol = TOL["encode"]
    if not torch.allclose(feat, ref, atol=atol, rtol=rtol):
        raise AssertionError(f"K5 + residual != hashgrid_encode: {err_enc}")

    fwd = (table, xc, perm, wins, slots, spec, wl)
    Lw = len(wl)
    meta = (perm.numel() + wins.numel() + slots.numel()) * 4 + xc.numel() * 4
    return [
        dict(name="winsort_fwd", route="cuda",
             source="nerf2mesh_tpu_torch/csrc/splat_winsort.cu",
             replaces="nerf2mesh_tpu/ops/splat_encode.py:365",
             max_abs_err=err5,
             ms=cuda_time_ms(lambda: se.winsort_fwd(*fwd)),
             plain_ms=cuda_time_ms(lambda: se.winsort_fwd_plain(*fwd)),
             bound=bound(level_rows(spec, wl) * 12 + meta + N * Lw * 12,
                         trilinear_flops(N * Lw))),
        dict(name="winsort_bwd", route="cuda",
             source="nerf2mesh_tpu_torch/csrc/splat_winsort.cu",
             replaces="nerf2mesh_tpu/ops/splat_encode.py:397",
             max_abs_err=err6,
             ms=cuda_time_ms(lambda: se.winsort_bwd(g, *args)),
             plain_ms=cuda_time_ms(lambda: se.winsort_bwd_plain(g, *args)),
             bound=bound(N * Lw * 12 + meta + spec.table_size * 12,
                         trilinear_flops(N * Lw)))]


def ref_spec():
    """The ref slice's table: 16 levels at resolutions 16..2048, levels 0-1
    dense, 2-15 hashed at 2^14 rows (bench_config(grid_layout="ref",
    log2_hashmap_size=14))."""
    from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec
    return HashGridSpec(num_levels=16, level_dim=3, log2_hashmap_size=14,
                        desired_resolution=2048, layout="ref")


def sweep_bwd(g, table, x, spec):
    """K4b: the ref table gradient (kernels' call order, as in TOL)."""
    from nerf2mesh_tpu_torch.ops import pallas_encode as pe
    return pe.sweep_bwd(table, x, g, spec, need_dx=False)[0]


def sweep_bwd_plain(g, table, x, spec):
    from nerf2mesh_tpu_torch.ops import pallas_encode as pe
    return pe.sweep_bwd_plain(table, x, g, spec, need_dx=False)[0]


def sweep_kernel(dev, rng):
    """K4 and K4b on 2^18 points at the ref slice's table: uniform points,
    lattice edges (exact and 1 ulp off) at every level, coordinates 0 and
    1, the 1-ulp denormal below 0, 1 ulp above 1 and far outside; K4b also
    on 2^18 points in 16 tight clusters (thousands of adds to each coarse
    row); both at 40 and 70 levels (two launches: 64 levels, then 6) and on
    a tiled grid (whose dense levels wrap) on 4096 of those points."""
    from nerf2mesh_tpu_torch.ops import pallas_encode as pe
    from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec
    spec = ref_spec()
    if not pe.sweep_supported(spec) or spec.table_size != 248120:
        raise AssertionError(f"ref slice spec: {spec}")
    N, L = KERNEL_POINTS, spec.num_levels
    pts = rng.uniform(0, 1, (N, 3))
    k = 0
    for l in range(L):
        s = np.float32(spec.level_scale32(l))
        for _ in range(64):
            v = np.float32((rng.integers(1, int(s)) - np.float32(spec.shift)) / s)
            if rng.random() < 0.6:
                v = np.nextafter(v, np.float32(rng.choice([-1, 2])))
            pts[k, rng.integers(3)] = v
            k += 1
    tail = pts[N - 64:]
    tail[:8, 0], tail[8:16, 1] = 0.0, 1.0
    tail[16:24, 2] = np.nextafter(np.float32(0), np.float32(-1))
    tail[24:32, 0] = np.nextafter(np.float32(1), np.float32(2))
    tail[32:40, 1], tail[40:48, 2], tail[48:56] = 1.5, -0.2, 2.0
    x = torch.from_numpy(pts[rng.permutation(N)].astype(np.float32)).to(dev)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_size, 3))
                             .astype(np.float32)).to(dev)
    out_k = pe.sweep_fwd(table, x, spec)
    out_p = pe.sweep_fwd_plain(table, x, spec)
    err4 = float((out_k - out_p).abs().max())
    oob = ((x < 0) | (x > 1)).any(-1)
    log(f"[kernels] K4 max|err| {err4:.3e} over {N} points "
        f"({int(oob.sum())} out of bounds, all zero: "
        f"{not bool(out_k[oob].any())})")
    if not err4 <= TOL["sweep_fwd"][0] or bool(out_k[oob].any()):
        raise AssertionError(f"K4 sweep_fwd disagrees: {err4}")

    g = torch.from_numpy(rng.normal(size=(N, L * 3)).astype(np.float32)).to(dev)
    bargs = (table, x, spec)
    err4b = float((sweep_bwd(g, *bargs) - sweep_bwd_plain(g, *bargs))
                  .abs().max())
    margin = atomic_tol_margin(sweep_bwd, sweep_bwd_plain, g, bargs)
    centres = rng.uniform(0.2, 0.8, (16, 3))
    xc = torch.from_numpy(np.clip(centres[rng.integers(0, 16, N)]
                                  + rng.normal(0, 0.002, (N, 3)), 0, 1)
                          .astype(np.float32)).to(dev)
    cargs = (table, xc, spec)
    share_c = touched_tol_share(sweep_bwd, sweep_bwd_plain, g, cargs)
    margin_c = atomic_tol_margin(sweep_bwd, sweep_bwd_plain, g, cargs)
    log(f"[kernels] K4b max|err| {err4b:.3e} (uniform and boundary points); "
        f"16 clusters: largest error over tolerance among touched entries "
        f"{share_c:.3f}")
    if margin < 0 or margin_c < 0:
        raise AssertionError(f"K4b sweep_bwd disagrees: {err4b}, clusters "
                             f"{share_c}")
    for var in (dict(num_levels=40, log2_hashmap_size=14),
                dict(num_levels=70, log2_hashmap_size=14),
                dict(num_levels=6, log2_hashmap_size=12, gridtype="tiled")):
        vspec = HashGridSpec(**{**dict(level_dim=3, desired_resolution=2048,
                                       layout="ref"), **var})
        vt = torch.from_numpy(rng.uniform(-1, 1, (vspec.table_size, 3))
                              .astype(np.float32)).to(dev)
        verr = float((pe.sweep_fwd(vt, x[:4096], vspec)
                      - pe.sweep_fwd_plain(vt, x[:4096], vspec)).abs().max())
        vg = torch.from_numpy(rng.normal(size=(4096, vspec.num_levels * 3))
                              .astype(np.float32)).to(dev)
        vshare = touched_tol_share(sweep_bwd, sweep_bwd_plain, vg,
                                   (vt, x[:4096], vspec))
        log(f"[kernels] K4 at {var}: max|err| {verr:.3e}; K4b largest error "
            f"over tolerance {vshare:.3f}")
        if not verr <= TOL["sweep_fwd"][0]:
            raise AssertionError(f"K4 sweep_fwd disagrees at {var}: {verr}")
        if atomic_tol_margin(sweep_bwd, sweep_bwd_plain, vg,
                             (vt, x[:4096], vspec)) < 0:
            raise AssertionError(f"K4b sweep_bwd disagrees at {var}")
    # bytes: x once, the table once, the [N, L*3] features once; the
    # backward reads g and writes the whole gradient its wrapper zeroes
    return [dict(name="sweep_fwd", route="cuda",
                 source="nerf2mesh_tpu_torch/csrc/sweep_encode.cu",
                 replaces="nerf2mesh_tpu/ops/pallas_encode.py:68",
                 max_abs_err=err4,
                 ms=cuda_time_ms(lambda: pe.sweep_fwd(table, x, spec)),
                 plain_ms=cuda_time_ms(lambda: pe.sweep_fwd_plain(table, x,
                                                                  spec)),
                 bound=bound(N * 12 + spec.table_size * 12 + N * L * 12,
                             trilinear_flops(N * L))),
            dict(name="sweep_bwd", route="cuda",
                 source="nerf2mesh_tpu_torch/csrc/sweep_encode.cu",
                 replaces="nerf2mesh_tpu/ops/pallas_encode.py:212 (XLA)",
                 max_abs_err=err4b,
                 ms=cuda_time_ms(lambda: sweep_bwd(g, *bargs)),
                 plain_ms=cuda_time_ms(lambda: sweep_bwd_plain(g, *bargs)),
                 bound=bound(N * 12 + N * L * 12 + spec.table_size * 12,
                             trilinear_flops(N * L)))]


CHANNEL_SOURCES = {
    "inwin_fwd": ("nerf2mesh_tpu_torch/csrc/splat_inwin.cu",
                  "nerf2mesh_tpu/ops/splat_encode.py:234"),
    "inwin_bwd": ("nerf2mesh_tpu_torch/csrc/splat_inwin.cu",
                  "nerf2mesh_tpu/ops/splat_encode.py:263"),
    "winsort_fwd": ("nerf2mesh_tpu_torch/csrc/splat_winsort.cu",
                    "nerf2mesh_tpu/ops/splat_encode.py:365"),
    "winsort_bwd": ("nerf2mesh_tpu_torch/csrc/splat_winsort.cu",
                    "nerf2mesh_tpu/ops/splat_encode.py:397"),
    "sweep_fwd": ("nerf2mesh_tpu_torch/csrc/sweep_encode.cu",
                  "nerf2mesh_tpu/ops/pallas_encode.py:68"),
    "sweep_bwd": ("nerf2mesh_tpu_torch/csrc/sweep_encode.cu",
                  "nerf2mesh_tpu/ops/pallas_encode.py:212 (XLA)"),
}


def channel_kernels(dev, rng):
    """K2-K6 and K4b at the separate tables' channel counts, C = 1 (the
    density table) and C = 2 (the colour table), on 2^18 points at the
    full specs: K2/K3 at block512 levels 0-8 on morton-sorted shell,
    uniform and block-edge points; K5/K6 at winsort levels 7-15 on uniform,
    block-edge and out-of-bounds points; K4/K4b at the ref slice's table on
    uniform and lattice-edge points.  Each against its plain version (the
    table gradients by atomic_tol_margin), timed beside its bound (C
    channels: 4C bytes a row)."""
    from nerf2mesh_tpu_torch.ops import pallas_encode as pe
    from nerf2mesh_tpu_torch.ops import splat_encode as se
    from nerf2mesh_tpu_torch.ops.hashgrid import HashGridSpec
    N = KERNEL_POINTS
    full = HashGridSpec(num_levels=16, level_dim=3, log2_hashmap_size=19,
                        desired_resolution=2048, layout="block512")
    levels = tuple(range(9))
    bnd = boundary_points(full, levels, rng)
    d = rng.normal(size=(N // 2, 3))
    shell = 0.5 + 0.3 * d / np.linalg.norm(d, axis=1, keepdims=True)
    pts = np.concatenate([shell, rng.uniform(0, 1, (N // 2 - len(bnd), 3)),
                          bnd]).astype(np.float32)
    xk = torch.from_numpy(np.clip(pts, 0, 1)).to(dev)
    xk = xk[se.morton_perm(xk)[0]].contiguous()
    metas = [se.tile_meta(xk.reshape(-1, se.TILE, 3), full, l) for l in levels]
    kmeta = (torch.stack([m[0] for m in metas]).contiguous(),
             torch.stack([m[1] for m in metas]).contiguous())

    wl = WINSORT_LEVELS
    bnd = boundary_points(full, wl, rng)
    pts = np.concatenate([rng.uniform(0, 1, (N - len(bnd) - 64, 3)), bnd,
                          rng.uniform(1.2, 1.5, (64, 3))])
    xw = torch.from_numpy(pts[rng.permutation(N)].astype(np.float32)).to(dev)
    oob = ((xw < 0) | (xw > 1)).any(-1)
    xw = xw.clamp(0, 1).contiguous()
    metas = [se.winsort_meta(xw, oob, full, l) for l in wl]
    wmeta = (torch.stack([m[0] for m in metas]).to(torch.int32).contiguous(),
             torch.stack([m[1] for m in metas]).contiguous(),
             torch.stack([m[2] for m in metas]).contiguous())

    ref = ref_spec()
    pts = rng.uniform(0, 1, (N, 3))
    for l in range(ref.num_levels):
        s = np.float32(ref.level_scale32(l))
        k = rng.integers(0, N, 64)
        pts[k, rng.integers(0, 3, 64)] = np.nextafter(
            np.float32((rng.integers(1, int(s), 64) - np.float32(ref.shift))
                       / s), np.float32(2))
    xs = torch.from_numpy(pts.astype(np.float32)).to(dev)

    out = []
    for C in (1, 2):
        spec = dataclasses.replace(full, level_dim=C)
        rspec = dataclasses.replace(ref, level_dim=C)
        table = torch.from_numpy(rng.uniform(-1, 1, (spec.table_size, C))
                                 .astype(np.float32)).to(dev)
        rtable = torch.from_numpy(rng.uniform(-1, 1, (rspec.table_size, C))
                                  .astype(np.float32)).to(dev)
        cases = {}
        # K2/K3
        Lk = len(levels)
        fargs = (table, xk, *kmeta, spec, levels)
        bargs = (xk, *kmeta, spec, levels, spec.table_size)
        g = torch.from_numpy(rng.normal(size=(N, Lk, C)).astype(np.float32)
                             ).to(dev)
        meta = sum(t.numel() for t in kmeta) * 4 + xk.numel() * 4
        cases["inwin_fwd"] = (
            lambda: se.inwin_fwd(*fargs), lambda: se.inwin_fwd_plain(*fargs),
            None, bound(level_rows(spec, levels) * 4 * C + meta
                        + N * Lk * 4 * C, trilinear_flops(N * Lk, C)))
        cases["inwin_bwd"] = (
            lambda: se.inwin_bwd(g, *bargs),
            lambda: se.inwin_bwd_plain(g, *bargs),
            (se.inwin_bwd, se.inwin_bwd_plain, g, bargs),
            bound(N * Lk * 4 * C + meta + spec.table_size * 4 * C,
                  trilinear_flops(N * Lk, C)))
        # K5/K6
        Lw = len(wl)
        wfargs = (table, xw, *wmeta, spec, wl)
        wbargs = (xw, *wmeta, spec, wl, spec.table_size)
        gw = torch.from_numpy(rng.normal(size=(N, Lw, C)).astype(np.float32)
                              ).to(dev)
        meta = sum(t.numel() for t in wmeta) * 4 + xw.numel() * 4
        cases["winsort_fwd"] = (
            lambda: se.winsort_fwd(*wfargs),
            lambda: se.winsort_fwd_plain(*wfargs), None,
            bound(level_rows(spec, wl) * 4 * C + meta + N * Lw * 4 * C,
                  trilinear_flops(N * Lw, C)))
        cases["winsort_bwd"] = (
            lambda: se.winsort_bwd(gw, *wbargs),
            lambda: se.winsort_bwd_plain(gw, *wbargs),
            (se.winsort_bwd, se.winsort_bwd_plain, gw, wbargs),
            bound(N * Lw * 4 * C + meta + spec.table_size * 4 * C,
                  trilinear_flops(N * Lw, C)))
        # K4/K4b
        L = rspec.num_levels
        gs = torch.from_numpy(rng.normal(size=(N, L * C)).astype(np.float32)
                              ).to(dev)
        sargs = (rtable, xs, rspec)
        cases["sweep_fwd"] = (
            lambda: pe.sweep_fwd(*sargs), lambda: pe.sweep_fwd_plain(*sargs),
            None, bound(N * 12 + rspec.table_size * 4 * C + N * L * 4 * C,
                        trilinear_flops(N * L, C)))
        cases["sweep_bwd"] = (
            lambda: sweep_bwd(gs, *sargs), lambda: sweep_bwd_plain(gs, *sargs),
            (sweep_bwd, sweep_bwd_plain, gs, sargs),
            bound(N * 12 + N * L * 4 * C + rspec.table_size * 4 * C,
                  trilinear_flops(N * L, C)))
        for name, (fn, plain, grad_args, bnd_ms) in cases.items():
            err = float((fn() - plain()).abs().max())
            if grad_args is None:
                ok = err <= TOL[name][0]
            else:
                ok = atomic_tol_margin(*grad_args) >= 0
            log(f"[kernels] {name} at C={C}: max|err| {err:.3e}")
            if not ok:
                raise AssertionError(f"{name} at C={C} disagrees with its "
                                     f"plain version: {err}")
            src, rep_ = CHANNEL_SOURCES[name]
            out.append(dict(name=f"{name}_c{C}", route="cuda", source=src,
                            replaces=rep_, max_abs_err=err,
                            ms=cuda_time_ms(fn), plain_ms=cuda_time_ms(plain),
                            bound=bnd_ms))
    return out


# --------------------------------------------------------------------------
# phase 4: the slice
# --------------------------------------------------------------------------

def bench_config(**kw):
    """bench.py's stage-0 configuration, with the overrides kw."""
    from nerf2mesh_tpu_torch.config import Config
    base = dict(
        bound=1.0, scale=0.8, dt_gamma=0.0, iters=30000,
        num_rays=4096, num_points=2 ** 18, max_steps=1024,
        grid_size=128, diffuse_step=1000, random_image_batch=True,
        background="random", mark_untrained=True, adaptive_num_rays=True,
        stochastic_fine=True, seed=SEED)
    base.update(kw)
    return dataclasses.replace(Config(path=""), **base).finalize()


def scene(cfg):
    from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
    from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
    frames = render_synthetic_frames(H=256, W=256, n_train=24, n_val=N_VAL,
                                     n_test=0)
    return (dataset_from_frames(cfg, frames, "train"),
            dataset_from_frames(cfg, frames, "val"))


def train_window(trainer, ds, steps, timed):
    """Run `steps` training steps; returns (losses, ray buckets, gather
    routes, last metrics, ms/step and rays/s over the last `timed` steps,
    launch counts of the run alone)."""
    from nerf2mesh_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    losses, buckets, routes = [], [], []
    t_start, timed_rays = None, 0
    for s in range(steps):
        if s == steps - timed:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        nr = trainer._bucket(trainer.num_rays)
        m = trainer.train_steps(ds, 1)
        losses.append(m["loss"])
        buckets.append(nr)
        routes.append(trainer.net_spec.encode_gather_levels)
        if t_start is not None:
            timed_rays += nr
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    first, last8 = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    if not last8 < first:
        raise AssertionError(f"loss did not fall: first-8 mean {first}, "
                             f"last-8 mean {last8}")
    return (losses, buckets, routes, m, (t_end - t_start) / timed * 1e3,
            timed_rays / (t_end - t_start), launches)


def run_eval(trainer, val, name, must_launch):
    """Trainer.evaluate on the val views with the launch counts set to 0
    just before and read just after; returns (PSNR, ms/frame, launches)."""
    from nerf2mesh_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = trainer.evaluate(val, name=name, track_best=False)
    ms_frame = (time.perf_counter() - t0) / val.num_frames * 1e3
    launches = dict(kernels.LAUNCHES)
    psnr = float(res["PSNR"])
    log(f"[eval] {name}: PSNR {psnr:.4f}; {ms_frame:.1f} ms/frame "
        f"({val.H}x{val.W}); march rounds per frame "
        f"{trainer.stats['eval_rounds']}; launches {launches}")
    if not math.isfinite(psnr):
        raise AssertionError(f"{name}: PSNR {psnr}")
    for k in must_launch:
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} was not launched")
    return psnr, ms_frame, launches


def phase_slice(dev):
    """Phase 4 (128 training steps), with phase 5 (eval) around it;
    returns the training's launch counts and, for phase 8, the trainer and
    its train and val sets."""
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    cfg = bench_config()
    t0 = time.perf_counter()
    ds, val = scene(cfg)
    trainer = Trainer(cfg, device=dev)
    trainer.mark_untrained(ds)
    log(f"[slice] scene {ds.images.shape} + {val.images.shape} val + trainer "
        f"set up in {time.perf_counter() - t0:.1f} s; table "
        f"{tuple(trainer.params.table.shape)}")

    eval_launch = ("occ_lookup", "inwin_fwd")
    psnr0, ms0, _ = run_eval(trainer, val, "before", eval_launch)

    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    losses, buckets, routes, m, ms_step, rays_s, launches = train_window(
        trainer, ds, SLICE_STEPS, TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[slice] {SLICE_STEPS} steps in {time.perf_counter() - t_all:.1f} s;"
        f" losses first {np.round(losses[:4], 5).tolist()} last "
        f"{np.round(losses[-4:], 5).tolist()}")
    log(f"[slice] ray buckets {sorted(set(buckets))} (first {buckets[0]}, "
        f"last {buckets[-1]}); gather levels first {routes[0]} last "
        f"{routes[-1]}; last num_points {int(m['num_points'])}, pool "
        f"overflow {int(m['pool_overflow'])}")
    log(f"[slice] steady state (last {TIMED_STEPS} steps): {ms_step:.2f} "
        f"ms/step, {rays_s:.1f} rays/s; peak memory {peak:.2f} GiB; "
        f"launches {launches}")
    if len(set(buckets)) < 2:
        raise AssertionError(f"adaptive ray bucket never changed: {buckets}")
    for k in ("occ_lookup", "inwin_fwd", "inwin_bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the slice")

    psnr1, ms1, _ = run_eval(trainer, val, "after", eval_launch)
    if not psnr1 > psnr0:
        raise AssertionError(f"eval PSNR did not rise: {psnr0} -> {psnr1}")
    log(f"[eval] PSNR {psnr0:.4f} -> {psnr1:.4f} over {SLICE_STEPS} steps; "
        f"{ms0:.1f} -> {ms1:.1f} ms/frame")
    profile_region(lambda: trainer.train_steps(ds, PROFILE_STEPS),
                   f"block512 steps {SLICE_STEPS}-{SLICE_STEPS + PROFILE_STEPS}",
                   per=PROFILE_STEPS)
    profile_region(lambda: trainer.render_image(
        val.poses[0], val.intrinsics_for(0), val.H, val.W),
        "block512 eval frame")
    return launches, trainer, ds, val


def phase_winsort(dev):
    """Phase 6: exact winsort training (K5 forward, K6 table gradient) and
    its eval."""
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    cfg = bench_config(winsort_fine=True, stochastic_fine=False)
    ds, val = scene(cfg)
    trainer = Trainer(cfg, device=dev)
    trainer.mark_untrained(ds)
    if trainer.net_spec.encode_winsort_levels != WINSORT_LEVELS:
        raise AssertionError(
            f"winsort levels {trainer.net_spec.encode_winsort_levels}")
    t_all = time.perf_counter()
    losses, buckets, routes, m, ms_step, rays_s, launches = train_window(
        trainer, ds, WINSORT_STEPS, WINSORT_STEPS // 2)
    log(f"[winsort] {WINSORT_STEPS} steps in "
        f"{time.perf_counter() - t_all:.1f} s; losses first "
        f"{np.round(losses[:4], 5).tolist()} last "
        f"{np.round(losses[-4:], 5).tolist()}; buckets {sorted(set(buckets))};"
        f" gather (= winsort) levels last {routes[-1]}")
    log(f"[winsort] last {WINSORT_STEPS // 2} steps: {ms_step:.2f} ms/step, "
        f"{rays_s:.1f} rays/s; launches {launches}")
    for k in ("winsort_fwd", "winsort_bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by training")
    psnr, ms_frame, _ = run_eval(trainer, val, "winsort", ("winsort_fwd",))
    log(f"[winsort] eval PSNR {psnr:.4f}, {ms_frame:.1f} ms/frame")
    profile_region(lambda: trainer.train_steps(ds, PROFILE_STEPS),
                   f"winsort steps {WINSORT_STEPS}-"
                   f"{WINSORT_STEPS + PROFILE_STEPS}", per=PROFILE_STEPS)
    return launches


def cli_argv(scene_dir, workspace, **kw):
    """The CLI flags of bench_config(**kw) (path and workspace given)."""
    from nerf2mesh_tpu_torch.config import Config
    cfg, default = bench_config(**kw), Config()
    argv = [scene_dir, "--workspace", workspace]
    for f in dataclasses.fields(Config):
        v = getattr(cfg, f.name)
        if f.name in ("path", "workspace", "refine_steps") or v == getattr(
                default, f.name):
            continue
        if isinstance(v, bool):
            argv.append(f"--{f.name}" if v else f"--no-{f.name}")
        else:
            argv += [f"--{f.name}", str(v)]
    return argv


@contextlib.contextmanager
def no_modules(*names):
    """Run as on a machine without these packages (default Pillow): the
    port's PNG codec, its JPEG writer and decoder, its resize filters and
    its RANSAC take over."""
    names = names or ("PIL",)
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] in names}
    for n in names:
        sys.modules[n] = None
    try:
        yield
    finally:
        for n in names:
            del sys.modules[n]
        sys.modules.update(saved)


def counting(cls, name, into):
    """Wrap cls.name so that the kernel launches made inside its calls add
    up in `into`; returns the original for restore_counting."""
    from nerf2mesh_tpu_torch import kernels
    real = getattr(cls, name)

    def counted(self, *a, **k):
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        out = real(self, *a, **k)
        torch.cuda.synchronize()
        for key, v in kernels.LAUNCHES.items():
            into[key] = into.get(key, 0) + v - before[key]
        return out

    setattr(cls, name, counted)
    return real


def surface_share(path, scale, tol=0.05):
    """(vertices, faces, share of the vertices within tol of the sphere
    scene's analytic surface) of a PLY in the scene's scaled frame."""
    from nerf2mesh_tpu_torch.data.synthetic import SphereScene
    from nerf2mesh_tpu_torch.meshing.io import read_ply
    v, f = read_ply(path)
    if len(f) == 0:
        return len(v), 0, 0.0
    d = np.abs(SphereScene().sdf(v / scale) * scale)
    return len(v), len(f), float((d < tol).mean())


def check_stage1_package(out_dir, decode: bool):
    """The files renderer.html loads; JPEGs decoded (decode=True) or their
    headers read; mlp.json's keys.  Returns the texture shapes."""
    from nerf2mesh_tpu_torch.data.jpeg import decode_jpeg
    names = ("mesh_0.obj", "mesh_0.mtl", "feat0_0.jpg", "feat1_0.jpg",
             "mlp.json")
    missing = [n for n in names if not os.path.exists(os.path.join(out_dir, n))]
    if missing:
        raise AssertionError(f"stage-1 export lacks {missing}")
    shapes = []
    for n in ("feat0_0.jpg", "feat1_0.jpg"):
        with open(os.path.join(out_dir, n), "rb") as f:
            data = f.read()
        if decode:
            img = decode_jpeg(data)
            if img.ndim != 3 or img.shape[2] != 3 or img.std() == 0:
                raise AssertionError(f"{n}: decoded {img.shape}")
            shapes.append(img.shape)
        else:
            i = data.index(b"\xff\xc0")
            h, w = int.from_bytes(data[i + 5:i + 7], "big"), int.from_bytes(
                data[i + 7:i + 9], "big")
            if not (data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"):
                raise AssertionError(f"{n}: no SOI/EOI markers")
            shapes.append((h, w))
    with open(os.path.join(out_dir, "mlp.json")) as f:
        mlp = json.load(f)
    keys = {"net.0.weight", "net.1.weight", "bound", "cascade"}
    if not keys <= set(mlp) or len(mlp["net.0.weight"]) != 6:
        raise AssertionError(f"mlp.json keys {sorted(mlp)}")
    return shapes


def phase_cli(dev):
    """Phase 7: the ref small-table slice through nerf2mesh_tpu_torch.main:
    stage 0 with the culled mesh export, then stage 1 with a refine, the
    textured export, and --test; returns the launch counts of the stage-0
    run, with the stage-1 training's under "stage1_<kernel>"."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.config import parse_args
    from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
    from nerf2mesh_tpu_torch.data.synthetic import generate_synthetic_dataset
    from nerf2mesh_tpu_torch.main import main as cli_main
    from nerf2mesh_tpu_torch.utils.convert import read_jax_checkpoint
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_")
    try:
        t0 = time.perf_counter()
        scene_dir = generate_synthetic_dataset(
            os.path.join(tmp, "scene"), H=256, W=256, n_train=24,
            n_val=N_VAL, n_test=2)
        ws = os.path.join(tmp, "ws")
        flags = dict(grid_layout="ref", log2_hashmap_size=14,
                     iters=CLI_STEPS, n_eval=1, n_ckpt=1,
                     mesh_visibility_culling=True, mcubes_reso=CLI_MCUBES)
        argv = cli_argv(scene_dir, ws, **flags)
        cfg = parse_args(argv)
        want = dataclasses.replace(bench_config(**flags), path=scene_dir,
                                   workspace=ws)
        if dataclasses.asdict(cfg) != dataclasses.asdict(want):
            raise AssertionError(f"CLI flags {argv} != bench_config")
        log(f"[cli] scene written in {time.perf_counter() - t0:.1f} s; "
            f"main {' '.join(argv[1:])}")

        train_launches = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        real_train = counting(Trainer, "train", train_launches)
        try:
            t0 = time.perf_counter()
            trainer = cli_main(argv, device=dev)
            torch.cuda.synchronize()
            t_main = time.perf_counter() - t0
        finally:
            Trainer.train = real_train
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        tl = trainer.train_log
        losses = [e["loss"] for e in tl]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite logged loss: {losses}")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"loss did not fall: {losses}")
        a = next(e for e in tl if e["step"] >= CLI_STEPS // 2)
        b = tl[-1]
        ms_step = (b["seconds"] - a["seconds"]) / (b["step"] - a["step"]) * 1e3
        rays_s = (b["rays"] - a["rays"]) / (b["seconds"] - a["seconds"])
        log(f"[cli] main ran {t_main:.1f} s; logged losses "
            f"{np.round(losses, 5).tolist()}")
        log(f"[cli] steps {a['step']}-{b['step']}: {ms_step:.2f} ms/step, "
            f"{rays_s:.1f} rays/s; peak memory {peak:.2f} GiB; launches: "
            f"training {train_launches}, whole run {launches}")
        for key in ("occ_lookup", "sweep_fwd", "sweep_bwd"):
            if train_launches.get(key, 0) <= 0:
                raise AssertionError(f"{key} was not launched by training")
        for key in ("inwin_fwd", "inwin_bwd", "winsort_fwd", "winsort_bwd"):
            if launches[key]:
                raise AssertionError(f"{key} launched on the ref path")
        results = trainer.stats["results"]
        log(f"[cli] evals (step {CLI_STEPS} val, final val, test): {results}")
        if len(results) != 3 or not all(math.isfinite(v) for r in results
                                        for v in r.values()):
            raise AssertionError(f"evals: {results}")

        mesh0 = os.path.join(ws, "mesh_stage0", "mesh_0.ply")
        nv, nf, share = surface_share(mesh0, cfg.scale)
        log(f"[cli] mesh_0.ply at mcubes {CLI_MCUBES}: v={nv} f={nf}, "
            f"{share:.3f} of the vertices within 0.05 of the analytic "
            f"surface; stage seconds {trainer.stats['mesh_seconds']}")
        if nf == 0 or share < 0.5:
            raise AssertionError(f"mesh_0.ply: {nf} faces, surface share "
                                 f"{share}")

        ckpt = os.path.join(ws, "checkpoints", "ngp_stage0_latest.ckpt")
        step_ckpt = os.path.join(ws, "checkpoints",
                                 f"ngp_stage0_{CLI_STEPS:07d}.ckpt")
        videos = [v for v in ("test_frames.npz", "test_rgb.gif",
                              "test_rgb.mp4")
                  if os.path.exists(os.path.join(ws, v))]
        if not (os.path.exists(ckpt) and os.path.exists(step_ckpt)
                and videos):
            raise AssertionError(f"workspace lacks a checkpoint or video: "
                                 f"{sorted(os.listdir(ws))}")
        saved = read_jax_checkpoint(ckpt)
        psnr_saved = float(saved["stats"]["results"][0]["PSNR"])
        log(f"[cli] wrote {os.path.basename(step_ckpt)} "
            f"({os.path.getsize(step_ckpt) / 2 ** 20:.1f} MiB), video "
            f"{videos}; step-{CLI_STEPS} val PSNR {psnr_saved:.6f}")

        tester = cli_main(argv + ["--test", "--test_no_mesh"], device=dev)
        if tester.step != CLI_STEPS or not all(
                math.isfinite(v) for v in tester.stats["results"][0].values()):
            raise AssertionError(f"--test: step {tester.step}, "
                                 f"{tester.stats['results']}")

        fresh = Trainer(cfg, device=dev)
        if not fresh.load_checkpoint():
            raise AssertionError("no checkpoint to load")
        val = load_nerf_dataset(cfg, "val")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = fresh.evaluate(val, name="reload", track_best=False)
        ms_frame = (time.perf_counter() - t0) / val.num_frames * 1e3
        log(f"[cli] reloaded step {fresh.step}: val PSNR {res['PSNR']:.6f} vs "
            f"{psnr_saved:.6f} recorded; {ms_frame:.1f} ms/frame "
            f"({val.H}x{val.W}), march rounds {fresh.stats['eval_rounds']}, "
            f"launches {dict(kernels.LAUNCHES)}")
        if not abs(res["PSNR"] - psnr_saved) <= 1e-4:
            raise AssertionError(f"reloaded PSNR {res['PSNR']} != "
                                 f"{psnr_saved}")
        train = load_nerf_dataset(cfg, "train")
        profile_region(lambda: fresh.train_steps(train, PROFILE_STEPS),
                       f"ref steps {CLI_STEPS}-{CLI_STEPS + PROFILE_STEPS}",
                       per=PROFILE_STEPS)
        profile_region(lambda: fresh.render_image(
            val.poses[0], val.intrinsics_for(0), val.H, val.W),
            "ref eval frame")
        del fresh, tester, trainer

        # stage 1 on that mesh and checkpoint: a refine at half its steps, the
        # textured export, then --test and a reload
        s1_argv = argv + ["--stage", "1", "--refine", "--iters",
                          str(CLI_S1_STEPS), "--refine_steps_ratio", "0.5",
                          "--texture_size", str(CLI_TEXTURE)]
        s1_launches = {}
        real = counting(Trainer, "stage1_step", s1_launches)
        try:
            t0 = time.perf_counter()
            s1 = cli_main(s1_argv, device=dev)
            torch.cuda.synchronize()
            t_s1 = time.perf_counter() - t0
        finally:
            Trainer.stage1_step = real
        tl = s1.train_log
        log(f"[cli] stage 1 ran {t_s1:.1f} s: log {tl}; evals "
            f"{s1.stats['results']}; export seconds "
            f"{s1.stats['export_seconds']}; stage-1 training launches "
            f"{s1_launches}")
        if not all(math.isfinite(e["loss"]) for e in tl) or any(
                e["overflow"] for e in tl):
            raise AssertionError(f"stage-1 log: {tl}")
        for key in ("sweep_fwd", "sweep_bwd"):
            if s1_launches.get(key, 0) <= 0:
                raise AssertionError(f"{key} was not launched by stage 1")
        shapes = check_stage1_package(os.path.join(ws, "mesh_stage1"), True)
        log(f"[cli] mesh_stage1: {sorted(os.listdir(os.path.join(ws, 'mesh_stage1')))}"
            f", textures decoded {shapes}")
        s1_saved = read_jax_checkpoint(
            os.path.join(ws, "checkpoints", "ngp_stage1_latest.ckpt"))
        s1_psnr = float(s1_saved["stats"]["results"][0]["PSNR"])
        s1_test = cli_main(s1_argv + ["--test"], device=dev)
        if s1_test.step != CLI_S1_STEPS:
            raise AssertionError(f"stage-1 --test: step {s1_test.step}")
        s1_cfg = parse_args(s1_argv)
        s1_fresh = Trainer(s1_cfg, device=dev)
        s1_fresh.setup_stage1(load_nerf_dataset(s1_cfg, "train"))
        if not s1_fresh.load_checkpoint():
            raise AssertionError("no stage-1 checkpoint to load")
        res = s1_fresh.evaluate(val, name="s1_reload", track_best=False)
        log(f"[cli] stage-1 reload at step {s1_fresh.step}: val PSNR "
            f"{res['PSNR']:.6f} vs {s1_psnr:.6f} recorded")
        if not abs(res["PSNR"] - s1_psnr) <= 1e-4:
            raise AssertionError(f"stage-1 reloaded PSNR {res['PSNR']} != "
                                 f"{s1_psnr}")
        for key in kernels.LAUNCHES:
            launches["stage1_" + key] = s1_launches.get(key, 0)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 8: stage 1 at bench width (block512)
# --------------------------------------------------------------------------

def raster_share(trainer, ds, steps):
    """Device ms of rasterize_crop's forward + backward at the inputs of one
    stage-1 step (captured from the step), against the step's ms; both the
    mean of `steps` runs between CUDA events."""
    from nerf2mesh_tpu_torch.models import rasterizer, stage1
    images, poses, intr = trainer._prep_train_arrays(ds)
    mvps = torch.from_numpy(np.asarray(ds.mvps, np.float32)).to(trainer.device)
    seen = []
    real = stage1.rasterize_crop

    def grab(*a, **k):
        seen.append((a, k))
        return real(*a, **k)

    stage1.rasterize_crop = grab
    try:
        trainer.stage1_step(images, poses, mvps, intr)
    finally:
        stage1.rasterize_crop = real
    (clip, tris, origin, H, W, spec), kw = seen[0]
    clip = clip.detach()

    def fwd_bwd():
        c = clip.clone().requires_grad_(True)
        r = rasterizer.rasterize_crop(c, tris, origin, H, W, spec, **kw)
        (r["area"].sum() + r["bary"].sum() + r["depth"].sum()).backward()

    ms_raster = cuda_time_ms(fwd_bwd, reps=steps)
    ms_step = cuda_time_ms(lambda: trainer.stage1_step(images, poses, mvps,
                                                       intr), reps=steps)
    return ms_raster, ms_step, spec


def phase_stage1(dev, field, ds, val):
    """Phase 8: the phase-4 field's mesh at S1_MCUBES^3 with
    visibility culling, then stage 1 at bench width with -O's stage-1
    recipe; returns the stage-1 training's launch counts, K2's and K3's
    largest |err| against plain at a stage-1 step's shapes, and the stage-1
    trainer (phase 13's viewer renders it)."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.meshing.io import read_ply
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_s1_")
    try:
        t0 = time.perf_counter()
        field.train_steps(ds, MESH_FIELD_STEPS)
        torch.cuda.synchronize()
        log(f"[stage1] the phase-4 field trained {MESH_FIELD_STEPS} more "
            f"steps in {time.perf_counter() - t0:.1f} s (to step "
            f"{field.step})")
        psnr_stage0 = float(field.evaluate(val, name="mesh_field",
                                           track_best=False)["PSNR"])
        field.workspace = tmp
        field.cfg = dataclasses.replace(field.cfg, mesh_visibility_culling=True)
        field.save_checkpoint()
        t0 = time.perf_counter()
        secs = field.save_mesh(resolution=S1_MCUBES, decimate_target=3e5,
                               dataset=ds)
        t_mesh = time.perf_counter() - t0
        nv, nf, share = surface_share(
            os.path.join(tmp, "mesh_stage0", "mesh_0.ply"), field.cfg.scale)
        log(f"[stage1] save_mesh {S1_MCUBES}^3 in {t_mesh:.1f} s: v={nv} "
            f"f={nf}, "
            f"surface share {share:.3f}; seconds {secs}")
        if nf == 0:
            raise AssertionError("empty stage-0 mesh")

        cfg = bench_config(stage=1, iters=S1_STEPS, n_eval=2, n_ckpt=1,
                           refine=True, s1_shell=4, s1_stochastic=True,
                           mesh_visibility_culling=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        t1 = Trainer(cfg, device=dev, workspace=tmp)
        t1.setup_stage1(ds)
        if not t1.load_checkpoint(stage=0):
            raise AssertionError("no stage-0 checkpoint")
        log(f"[stage1] setup {time.perf_counter() - t0:.1f} s: mesh "
            f"v={t1.stage1_mesh.num_vertices} f={t1.stage1_mesh.num_faces}, "
            f"raster spec {t1._raster_spec()}, refine steps "
            f"{cfg.refine_steps}")

        launches = {}
        real = counting(Trainer, "stage1_step", launches)
        try:
            t0 = time.perf_counter()
            t1.train_stage1(ds, val)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
        finally:
            Trainer.stage1_step = real
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tl = t1.train_log
        losses = [e["loss"] for e in tl]
        psnrs = [r["PSNR"] for r in t1.stats["results"]]
        log(f"[stage1] {S1_STEPS} steps (evals included) in {t_train:.1f} s;"
            f" log {tl}; faces at the refines (step, before, after) "
            f"{t1.stats.get('refines')}; peak memory {peak:.2f} GiB; "
            f"launches {launches}")
        log(f"[stage1] val PSNR after {S1_STEPS // 2} and {S1_STEPS} steps: "
            f"{psnrs}; stage-0 val PSNR of the field {psnr_stage0:.4f} "
            f"(gap {psnrs[-1] - psnr_stage0:+.4f} dB, not gated)")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite stage-1 loss: {losses}")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"stage-1 loss did not fall: {losses}")
        if any(e["overflow"] for e in tl):
            raise AssertionError(f"raster overflow: {tl}")
        for key in ("inwin_fwd", "inwin_bwd"):
            if launches.get(key, 0) <= 0:
                raise AssertionError(f"{key} was not launched by stage 1")
        if len(psnrs) != 2 or not psnrs[1] >= psnrs[0] - 0.1:
            raise AssertionError(f"stage-1 val PSNR declined: {psnrs}")

        images, poses, intr = t1._prep_train_arrays(ds)
        mvps = torch.from_numpy(np.asarray(ds.mvps, np.float32)).to(dev)
        profile_region(lambda: [t1.stage1_step(images, poses, mvps, intr)
                                for _ in range(PROFILE_STEPS)],
                       f"stage-1 steps {S1_STEPS}-{S1_STEPS + PROFILE_STEPS}",
                       per=PROFILE_STEPS)
        calls = []
        with inwin_calls(calls):        # K2/K3 at one step's 4 shell layers
            t1.stage1_step(images, poses, mvps, intr)
        errs = hold_inwin(calls, "stage-1 step")
        ms_r, ms_s, spec = raster_share(t1, ds, PROFILE_STEPS)
        log(f"[stage1] rasterize_crop forward+backward {ms_r:.2f} ms of a "
            f"{ms_s:.2f} ms step ({ms_r / ms_s:.1%}; CUDA events, mean of "
            f"{PROFILE_STEPS}) at {spec}, faces {t1.stage1_mesh.num_faces}")

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        esecs = t1.export_stage1(resolution=S1_TEXTURE)
        t_exp = time.perf_counter() - t0
        shapes = check_stage1_package(os.path.join(tmp, "mesh_stage1"), False)
        v, f = read_ply(os.path.join(tmp, "mesh_stage0", "mesh_0_updated.ply"))
        log(f"[stage1] export_stage1({S1_TEXTURE}) in {t_exp:.1f} s: "
            f"seconds {esecs};"
            f" textures {shapes}; mesh v={len(v)} f={len(f)}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        stage1_ocp_round_trip(dev, t1, ds, val, tmp)
        return launches, errs, t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 9: SDF mode (NeuS) at bench width
# --------------------------------------------------------------------------

def sdf_window(trainer, ds, steps):
    """`steps` SDF training steps, each loss and eikonal term fetched;
    returns (losses, eikonal terms, ms/step, launches of the run alone,
    peak GiB)."""
    from nerf2mesh_tpu_torch import kernels
    losses, eiks = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = trainer.train_steps(ds, 1)
        losses.append(m["loss"])
        eiks.append(m["eikonal"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return ([float(v) for v in losses], [float(v) for v in eiks], ms,
            launches, peak)


@contextlib.contextmanager
def inwin_calls(calls=None, plain=False):
    """Within: K2's and K3's wrappers append each call's arguments to
    `calls` (if given) as (name, args), the tensors copied (the optimizer
    updates the table in place after the forward); with plain=True they
    compute with their plain versions instead of launching."""
    from nerf2mesh_tpu_torch.ops import splat_encode as se
    real = {"inwin_fwd": se.inwin_fwd, "inwin_bwd": se.inwin_bwd}
    use = ({"inwin_fwd": se.inwin_fwd_plain, "inwin_bwd": se.inwin_bwd_plain}
           if plain else real)

    def wrap(name):
        def call(*args):
            if calls is not None:
                calls.append((name, tuple(a.detach().clone()
                                          if torch.is_tensor(a) else a
                                          for a in args)))
            return use[name](*args)
        return call

    for name in real:
        setattr(se, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(se, name, fn)


def hold_inwin(calls, label, need=("inwin_fwd", "inwin_bwd")):
    """K2 and K3 against their plain versions on the arguments a path gave
    them (`calls` from inwin_calls): K2 within TOL, K3 by atomic_tol_margin.
    Fails if one of `need` was not called.  Returns {name: max |err|}."""
    from nerf2mesh_tpu_torch.ops import splat_encode as se
    errs = {}
    for name, args in calls:
        g_or_table, x, levels = args[0], args[1], args[5]
        if name == "inwin_fwd":
            err = float((se.inwin_fwd(*args) - se.inwin_fwd_plain(*args))
                        .abs().max())
            bad = not err <= TOL[name][0]
        else:
            err = float((se.inwin_bwd(*args) - se.inwin_bwd_plain(*args))
                        .abs().max())
            bad = atomic_tol_margin(se.inwin_bwd, se.inwin_bwd_plain,
                                    g_or_table, args[1:]) < 0
        most = int(torch.unique(x, dim=0, return_counts=True)[1].max())
        log(f"[kernels] {label}: {name} on the path's {x.shape[0]} points "
            f"(at most {most} at one position), levels {levels[0]}-"
            f"{levels[-1]}: max|err| {err:.3e}")
        if bad:
            raise AssertionError(f"{label}: {name} disagrees with its plain "
                                 f"version: {err}")
        errs[name] = max(errs.get(name, 0.0), err)
    for name in need:
        if name not in errs:
            raise AssertionError(f"{label}: {name} was not called")
    return errs


@contextlib.contextmanager
def bary_detached():
    """Within: stage 1's interpolated surface points take no gradient
    through the barycentrics' dependence on the vertex positions (only
    through the interpolation weights times the vertices)."""
    from nerf2mesh_tpu_torch.models import stage1
    real = stage1.interpolate
    stage1.interpolate = lambda attrs, rast, tris: real(
        attrs, dict(rast, bary=rast["bary"].detach()), tris)
    try:
        yield
    finally:
        stage1.interpolate = real


@contextlib.contextmanager
def deterministic():
    """Within: PyTorch's deterministic algorithms, so that the index adds
    and scatters of stage 1's rasterizer and of its backward sum in a fixed
    order (their atomics otherwise change a crop's offsets' gradient from
    one pass to the next: workspace/port/stage1_grad_repeat.py);
    an op without a deterministic implementation raises.  A stage-1 pass
    takes about four times as long within."""
    was = torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


class _ImageCotangent(torch.autograd.Function):
    """Identity on stage 1's rendered image that records the gradient
    reaching it, or replaces that gradient by the recorded one."""

    @staticmethod
    def forward(ctx, image, store, replay):
        ctx.store, ctx.replay = store, replay
        store["replayed" if replay else "image"] = image.detach().clone()
        return image.clone()

    @staticmethod
    def backward(ctx, g):
        if ctx.replay:
            return ctx.store["cotangent"], None, None
        ctx.store["cotangent"] = g.detach().clone()
        return g, None, None


@contextlib.contextmanager
def image_cotangent(store, replay=False):
    """Within: the gradient that reaches stage 1's rendered crop image
    (the loss's residual) is recorded in store["cotangent"], the image in
    store["image"]; with replay=True the recorded gradient goes on in its
    place, the image in store["replayed"].  Two passes then differ only in
    what lies between the image and the parameters."""
    from nerf2mesh_tpu_torch.models import stage1
    real = stage1.render_stage1_crop

    def render(*args, **kw):
        out = dict(real(*args, **kw))
        out["image"] = _ImageCotangent.apply(out["image"], store, replay)
        return out

    stage1.render_stage1_crop = render
    try:
        yield store
    finally:
        stage1.render_stage1_crop = real


def offsets_field_share(t1, ds, crops=SDF_SHARE_CROPS):
    """The field query's share of the offsets' gradient over `crops`
    stage-1 draws (no optimizer step): per draw |field| / |g(with)|, field =
    g(with) - g(without enable_offset_nerf_grad).  On the draw of the
    largest share, two witnesses: the same passes with K2/K3 replaced by
    their plain versions, and with the barycentrics detached
    (bary_detached).  The plain passes' images must lie within K2's
    tolerance of the kernels' and, given the kernels' passes' gradient at
    the image (image_cotangent), their gradients within 1e-3 relative L2.
    The draw's passes run under deterministic(); repeat_rel is a second
    kernels' pass's difference from the first.  free_plain_rel is the plain
    pass's difference on its own residual: where the field matches the
    target closely, a rounding of the colour moves the small residual by a
    large part of itself, and on this draw a few such pixels can carry the
    gradient.  K2/K3 are held against plain at the first draw's arguments.
    Returns (shares, the witnesses' record, {kernel: max |err|})."""
    images, poses, intr = t1._prep_train_arrays(ds)
    mvps = torch.from_numpy(np.asarray(ds.mvps, np.float32)).to(t1.device)
    B, H, W, _ = images.shape
    cfg = t1.cfg

    def grad(draws, flag, calls=None, plain=False, bary=True, det=True,
             cot=None, replay=False):
        t1.cfg = dataclasses.replace(cfg, enable_offset_nerf_grad=flag)
        t1.optimizer.zero_grad(set_to_none=True)
        with (deterministic() if det else contextlib.nullcontext()), (
                inwin_calls(calls, plain)), (
                contextlib.nullcontext() if bary else bary_detached()), (
                contextlib.nullcontext() if cot is None
                else image_cotangent(cot, replay)):
            loss, _, _, _ = t1._stage1_crop_loss(images, poses, mvps, intr,
                                                 draws)
            loss.backward()
        return t1.vertices_offsets.grad.detach().clone()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    calls, runs = [], []
    try:
        for i in range(crops):
            draws = t1.stage1_draw(B, H, W)
            g_with = grad(draws, True, calls if i == 0 else None, det=False)
            g_without = grad(draws, False, det=False)
            runs.append((float((g_with - g_without).norm() / g_with.norm()),
                         draws))
        share, draws = max(runs, key=lambda r: r[0])
        c_with, c_without = {}, {}
        g_with = grad(draws, True, cot=c_with)
        g_without = grad(draws, False, cot=c_without)
        field = g_with - g_without
        p_with = grad(draws, True, plain=True, cot=c_with, replay=True)
        p_without = grad(draws, False, plain=True, cot=c_without,
                         replay=True)
        p_field = p_with - p_without
        free = grad(draws, True, plain=True)
        repeat = grad(draws, True)
        nb_field = grad(draws, True, bary=False) - g_without
        errs = hold_inwin(calls, "sdf stage 1 (one crop)")
    finally:
        t1.cfg = cfg
        t1.optimizer.zero_grad(set_to_none=True)
    witness = dict(
        share=share, plain_share=float(p_field.norm() / p_with.norm()),
        plain_rel=rel(p_with, g_with), plain_field_rel=rel(p_field, field),
        image_err=max(float((c["replayed"] - c["image"]).abs().max())
                      for c in (c_with, c_without)),
        free_plain_rel=rel(free, g_with), repeat_rel=rel(repeat, g_with),
        detached_share=float(nb_field.norm() / (g_without + nb_field).norm()),
        field_max=float(field.abs().max()),
        detached_field_max=float(nb_field.abs().max()),
        rest_max=float(g_without.abs().max()))
    if not (witness["plain_rel"] <= 1e-3 and witness["plain_field_rel"] <= 1e-3
            and witness["image_err"] <= TOL["inwin_fwd"][0]):
        raise AssertionError(f"stage-1 offsets' gradient with the plain "
                             f"encode differs from the kernels': {witness}")
    return [r[0] for r in runs], witness, errs


def phase_sdf(dev):
    """Phase 9: SDF mode at bench width: pretrain, stage 0, eval, profile,
    the SDF mesh, stage 1 under enable_offset_nerf_grad and its export;
    returns the stage-0 training's launch counts, with the stage-1
    training's under "stage1_<kernel>", and K2's and K3's largest |err|
    against plain at this phase's shapes."""
    from nerf2mesh_tpu_torch.models.network import density
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_sdf_")
    try:
        cfg = bench_config(sdf=True)
        ds, val = scene(cfg)
        trainer = Trainer(cfg, device=dev, workspace=tmp)
        t0 = time.perf_counter()
        loss = trainer.sdf_pretrain(iters=SDF_PRETRAIN)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        with torch.no_grad():
            s = density(trainer.params, torch.tensor(
                [[0.0, 0.0, 0.0], [0.9, 0.0, 0.0]], device=dev),
                trainer.net_spec).tolist()
        log(f"[sdf] pretrain {SDF_PRETRAIN} iterations (cut from 2000) of "
            f"8192 points in {t_pre:.1f} s, last loss {loss:.6f}; sdf(0) "
            f"{s[0]:.4f}, sdf(0.9, 0, 0) {s[1]:.4f}")
        if not s[0] < 0 < s[1]:
            raise AssertionError(f"pretrain: sdf(0) {s[0]}, sdf(0.9) {s[1]}")

        trainer.mark_untrained(ds)
        losses, eiks, ms_step, launches, peak = sdf_window(
            trainer, ds, SDF_STEPS)
        log(f"[sdf] {SDF_STEPS} steps: {ms_step:.2f} ms/step (every step's "
            f"loss fetched); losses first {np.round(losses[:4], 5).tolist()} "
            f"last {np.round(losses[-4:], 5).tolist()}; eikonal first "
            f"{np.round(eiks[:2], 5).tolist()} last "
            f"{np.round(eiks[-2:], 5).tolist()}; peak memory {peak:.2f} GiB;"
            f" launches {launches}; rays {trainer.num_rays}")
        if not all(math.isfinite(v) for v in losses + eiks):
            raise AssertionError(f"non-finite SDF loss: {losses} {eiks}")
        first, last8 = np.mean(losses[:8]), np.mean(losses[-8:])
        if not last8 < first:
            raise AssertionError(f"SDF loss did not fall: first-8 mean "
                                 f"{first}, last-8 mean {last8}")
        for k in ("occ_lookup", "inwin_fwd", "inwin_bwd"):
            if launches[k] <= 0:
                raise AssertionError(f"{k} was not launched by SDF training")

        psnr, ms_frame, _ = run_eval(trainer, val, "sdf",
                                     ("occ_lookup", "inwin_fwd"))
        log(f"[sdf] eval PSNR {psnr:.4f}, {ms_frame:.1f} ms/frame")
        profile_region(lambda: trainer.train_steps(ds, PROFILE_STEPS),
                       f"sdf steps {SDF_STEPS}-{SDF_STEPS + PROFILE_STEPS}",
                       per=PROFILE_STEPS)
        # K2/K3 at one more step's shapes: the pool's points and the FD
        # normal's 6 taps of each (one call of 6N points)
        calls = []
        with inwin_calls(calls):
            trainer.train_steps(ds, 1)
        errs = hold_inwin(calls, "sdf step")

        trainer.save_checkpoint()
        t0 = time.perf_counter()
        secs = trainer.save_mesh(resolution=SDF_MCUBES, decimate_target=3e5)
        t_mesh = time.perf_counter() - t0
        nv, nf, share = surface_share(
            os.path.join(tmp, "mesh_stage0", "mesh_0.ply"), cfg.scale)
        log(f"[sdf] save_mesh {SDF_MCUBES}^3 in {t_mesh:.1f} s: v={nv} "
            f"f={nf}, surface share {share:.3f} (within 0.05); seconds "
            f"{secs}")
        if nf == 0 or share < 0.5:
            raise AssertionError(f"SDF mesh: {nf} faces, share {share}")

        cfg1 = bench_config(sdf=True, stage=1, iters=SDF_S1_STEPS, n_eval=1,
                            n_ckpt=1)
        t1 = Trainer(cfg1, device=dev, workspace=tmp)
        t1.setup_stage1(ds)
        if not t1.load_checkpoint(stage=0):
            raise AssertionError("no stage-0 checkpoint")
        s1_launches = {}
        real = counting(Trainer, "stage1_step", s1_launches)
        try:
            t0 = time.perf_counter()
            t1.train_stage1(ds)
            torch.cuda.synchronize()
            t_s1 = time.perf_counter() - t0
        finally:
            Trainer.stage1_step = real
        g = t1.vertices_offsets.grad
        tl = t1.train_log
        losses1 = [e["loss"] for e in tl]
        g_ok = bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
        shares, wit, errs1 = offsets_field_share(t1, ds)
        log(f"[sdf] stage 1 (enable_offset_nerf_grad, shell "
            f"{cfg1.s1_shell}, stochastic {cfg1.s1_stochastic}) "
            f"{SDF_S1_STEPS} steps in {t_s1:.1f} s ("
            f"{t_s1 / SDF_S1_STEPS * 1e3:.1f} ms a step, the checkpoint "
            f"included): log {tl}; offsets' last "
            f"gradient |g|max {float(g.abs().max()):.3e}, finite "
            f"{bool(torch.isfinite(g).all())}; the field query's share of "
            f"the offsets' gradient over {len(shares)} crops "
            f"{np.round(shares, 4).tolist()} (median "
            f"{np.median(shares):.4f}); on the crop of the largest: "
            f"{ {k: float(f'{v:.4g}') for k, v in wit.items()} } (plain_*: "
            f"K2/K3 replaced by their plain versions, given the kernels' "
            f"gradient at the image; free_plain_rel: on its own; "
            f"repeat_rel: the kernels' pass again; detached_*: the "
            f"barycentrics detached); launches {s1_launches}")
        if not all(math.isfinite(v) for v in losses1):
            raise AssertionError(f"non-finite SDF stage-1 loss: {losses1}")
        if any(e["overflow"] for e in tl):
            raise AssertionError(f"raster overflow: {tl}")
        if not g_ok:
            raise AssertionError("the offsets' gradient is zero or not "
                                 "finite")
        for k in ("inwin_fwd", "inwin_bwd"):
            if s1_launches.get(k, 0) <= 0:
                raise AssertionError(f"{k} was not launched by SDF stage 1")
        t0 = time.perf_counter()
        esecs = t1.export_stage1(resolution=CLI_TEXTURE)
        shapes = check_stage1_package(os.path.join(tmp, "mesh_stage1"),
                                      False)
        log(f"[sdf] export_stage1({CLI_TEXTURE}) in "
            f"{time.perf_counter() - t0:.1f} s: seconds {esecs}; textures "
            f"{shapes}")
        launches.update({"stage1_" + k: v for k, v in s1_launches.items()})
        return launches, {k: max(errs[k], errs1[k]) for k in errs}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 10: the unbounded-scene path (COLMAP, cascades, contraction)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def occ_calls(calls):
    """Within: the sampler's K1 wrapper appends each call's (words, idx) to
    `calls`, copied."""
    from nerf2mesh_tpu_torch.ops import sampling
    real = sampling.occ_lookup

    def call(words, idx):
        calls.append((words.clone(), idx.clone()))
        return real(words, idx)

    sampling.occ_lookup = call
    try:
        yield
    finally:
        sampling.occ_lookup = real


def hold_occ(occ, label) -> float:
    """K1 against its plain version, exactly, on the (words, idx) a path
    gave it (`occ` from occ_calls); fails if it was not called."""
    from nerf2mesh_tpu_torch.ops.occ_sweep import occ_lookup, occ_lookup_plain
    if not occ:
        raise AssertionError(f"{label}: occ_lookup was not called")
    n_bad = sum(int((occ_lookup(w, i) != occ_lookup_plain(w, i)).sum())
                for w, i in occ)
    if n_bad:
        raise AssertionError(f"{label}: occ_lookup disagrees on {n_bad} "
                             f"cells")
    return 0.0


def hold_step_kernels(trainer, ds, label, ref_ms, tag="[unbounded]"):
    """K1 (exact), K2 and K3 against their plain versions on the arguments
    one more training step gives them, and timed on the largest of each
    beside phase 3's times (ref_ms); pack_bits timed on the run's grid.
    Returns {name: max|err|}."""
    from nerf2mesh_tpu_torch.ops import splat_encode as se
    from nerf2mesh_tpu_torch.ops.occ_sweep import occ_lookup, pack_bits
    occ, calls = [], []
    with occ_calls(occ), inwin_calls(calls):
        trainer.train_steps(ds, 1)
    errs = hold_inwin(calls, label)
    errs["occ_lookup"] = hold_occ(occ, label)
    words, idx = max(occ, key=lambda c: c[1].numel())
    fwd = max((a for n, a in calls if n == "inwin_fwd"),
              key=lambda a: a[1].shape[0])
    bwd = max((a for n, a in calls if n == "inwin_bwd"),
              key=lambda a: a[1].shape[0])
    grid = trainer.render.occ_grid
    ms = {"occ_lookup": cuda_time_ms(lambda: occ_lookup(words, idx)),
          "inwin_fwd": cuda_time_ms(lambda: se.inwin_fwd(*fwd)),
          "inwin_bwd": cuda_time_ms(lambda: se.inwin_bwd(*bwd)),
          "pack_bits": cuda_time_ms(lambda: pack_bits(grid))}
    log(f"{tag} {label}: K1 exact on {len(occ)} calls; at this run's "
        f"arguments (K1 {idx.numel()} cells of {words.numel()} words, "
        f"{grid.shape[0]} cascades; K2 {fwd[1].shape[0]} points at levels "
        f"{fwd[5][0]}-{fwd[5][-1]}; K3 {bwd[1].shape[0]} points): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + "; phase 3's: " + ", ".join(f"{k} {ref_ms[k]:.4f} ms"
                                      for k in ("occ_lookup", "inwin_fwd",
                                                "inwin_bwd")))
    return errs


def unbounded_stage0(dev, scene_dir, ws, run, flags, ref_ms):
    """One stage-0 CLI run on the COLMAP capture at bench width; returns
    (the trainer, its argv, the training's launch counts, K1-K3's max|err|
    at its step's arguments)."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.config import parse_args
    from nerf2mesh_tpu_torch.data.colmap import load_colmap_dataset
    from nerf2mesh_tpu_torch.main import main as cli_main
    from nerf2mesh_tpu_torch.meshing.io import read_ply
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    # -O's flags but the visibility cull (and fp16 outside run (a), as the
    # bench's MLPs are fp32): with the cameras inside a cascade's box its
    # subdivision of the faces near them grows 4x a pass for 6 passes
    # (ROADMAP C)
    base = dict(data_format="colmap", scale=-1.0, n_eval=1, n_ckpt=1,
                test_no_video=True, refine=True, mcubes_reso=UNB_MCUBES,
                decimate_target=UNB_DECIMATE)
    argv = cli_argv(scene_dir, ws, **dict(base, **flags))
    cfg = parse_args(argv)
    log(f"[unbounded] {run}: main {' '.join(argv[1:])}")
    train_launches, t_mark = {}, []
    real_mark = Trainer.mark_untrained

    def timed_mark(self, dataset):
        t0 = time.perf_counter()
        real_mark(self, dataset)
        torch.cuda.synchronize()
        t_mark.append(time.perf_counter() - t0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    real = counting(Trainer, "train", train_launches)
    Trainer.mark_untrained = timed_mark
    try:
        t0 = time.perf_counter()
        trainer = cli_main(argv, device=dev)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
    finally:
        Trainer.train = real
        Trainer.mark_untrained = real_mark
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tl = trainer.train_log
    losses = [e["loss"] for e in tl]
    a, b = next(e for e in tl if e["step"] >= cfg.iters // 2), tl[-1]
    ms_step = (b["seconds"] - a["seconds"]) / (b["step"] - a["step"]) * 1e3
    log(f"[unbounded] {run}: main ran {t_main:.1f} s (mark_untrained "
        f"{t_mark} s, host numpy), {cfg.cascades} "
        f"cascades, grid bound {cfg.grid_bound}, aabb "
        f"{np.round(trainer._aabb, 4).tolist()}; logged losses "
        f"{np.round(losses, 5).tolist()}; steps {a['step']}-{b['step']}: "
        f"{ms_step:.2f} ms/step; peak memory {peak:.2f} GiB; evals "
        f"{trainer.stats['results']}; training launches {train_launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{run}: non-finite logged loss: {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"{run}: loss did not fall: {losses}")
    for key in ("occ_lookup", "inwin_fwd", "inwin_bwd"):
        if train_launches.get(key, 0) <= 0:
            raise AssertionError(f"{run}: {key} was not launched by training")
    if not all(math.isfinite(v) for r in trainer.stats["results"]
               for v in r.values()):
        raise AssertionError(f"{run}: evals {trainer.stats['results']}")

    mdir = os.path.join(ws, "mesh_stage0")
    meshes = {}
    for c in range(cfg.cascades):
        p = os.path.join(mdir, f"mesh_{c}.ply")
        if os.path.exists(p):
            v, f = read_ply(p)
            meshes[c] = (len(v), len(f), float(np.abs(v).max())
                         if len(v) else 0.0)
    log(f"[unbounded] {run}: meshes (cascade: vertices, faces, max|v|) "
        f"{meshes}; export seconds {trainer.stats['mesh_seconds']}")
    if 0 not in meshes or meshes[0][1] == 0 or meshes[0][2] > 1 + 1e-5:
        raise AssertionError(f"{run}: mesh_0.ply {meshes.get(0)}")
    outer = [m for c, m in meshes.items() if c > 0 and m[1] > 0]
    if not any(1.0 < m[2] <= cfg.bound + 1e-4 for m in outer):
        raise AssertionError(f"{run}: no outer cascade's mesh past the unit "
                             f"box within the bound: {meshes}")

    train, val = (load_colmap_dataset(cfg, "train"),
                  load_colmap_dataset(cfg, "val"))
    run_eval(trainer, val, f"unbounded {run}", ("occ_lookup", "inwin_fwd"))
    # before diffuse_step the eval's full shading adds the untrained
    # specular head; the diffuse render is what the steps have trained
    psnr_d = [float(-10 * np.log10(np.mean((trainer.render_image(
        val.poses[i], val.intrinsics_for(i), val.H, val.W,
        shading="diffuse")["image"] - val.images[i][..., :3] / 255.0) ** 2)))
        for i in range(val.num_frames)]
    log(f"[unbounded] {run}: val PSNR of the diffuse render "
        f"{np.round(psnr_d, 4).tolist()} (mean {np.mean(psnr_d):.4f})")
    profile_region(lambda: trainer.train_steps(train, PROFILE_STEPS),
                   f"unbounded {run} steps {cfg.iters}-"
                   f"{cfg.iters + PROFILE_STEPS}", per=PROFILE_STEPS)
    errs = hold_step_kernels(trainer, train, f"unbounded {run} step", ref_ms)
    return trainer, argv, train_launches, errs, meshes


def unbounded_stage1(dev, argv, run, s1_flags, texture, reload):
    """Stage 1 through the CLI over every cascade's mesh and its export;
    with reload, --test and a fresh stage-1 Trainer reproducing the
    recorded val PSNR.  Returns (stage-1 launches, K2/K3 max|err| on a
    step's arguments)."""
    from nerf2mesh_tpu_torch.config import parse_args
    from nerf2mesh_tpu_torch.data.colmap import load_colmap_dataset
    from nerf2mesh_tpu_torch.main import main as cli_main
    from nerf2mesh_tpu_torch.utils.convert import read_jax_checkpoint
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    s1_argv = argv + ["--stage", "1", "--texture_size", str(texture)] \
        + s1_flags
    cfg = parse_args(s1_argv)
    ws = cfg.workspace
    s1_launches = {}
    real = counting(Trainer, "stage1_step", s1_launches)
    try:
        t0 = time.perf_counter()
        s1 = cli_main(s1_argv, device=dev)
        torch.cuda.synchronize()
        t_s1 = time.perf_counter() - t0
    finally:
        Trainer.stage1_step = real
    tl = s1.train_log
    mesh = s1.stage1_mesh
    log(f"[unbounded] {run} stage 1 ran {t_s1:.1f} s over "
        f"{len(mesh.v_cumsum) - 1} cascades (faces "
        f"{np.diff(mesh.f_cumsum).tolist()}): log {tl}; refines "
        f"{s1.stats.get('refines')}; evals {s1.stats['results']}; export "
        f"seconds {s1.stats['export_seconds']}; stage-1 training launches "
        f"{s1_launches}")
    if not all(math.isfinite(e["loss"]) for e in tl) or any(
            e["overflow"] for e in tl):
        raise AssertionError(f"{run} stage-1 log: {tl}")
    for key in ("inwin_fwd", "inwin_bwd"):
        if s1_launches.get(key, 0) <= 0:
            raise AssertionError(f"{run}: {key} was not launched by stage 1")
    out = os.path.join(ws, "mesh_stage1")
    objs = sorted(n for n in os.listdir(out) if n.endswith(".obj"))
    want = [f"mesh_{c}.obj" for c in range(cfg.cascades)]
    with open(os.path.join(out, "mlp.json")) as f:
        mlp = json.load(f)
    if objs != want or mlp["cascade"] != cfg.cascades or \
            mlp["bound"] != cfg.grid_bound:
        raise AssertionError(f"{run}: export {objs}, mlp.json bound "
                             f"{mlp['bound']} cascade {mlp['cascade']}")
    check_stage1_package(out, True)
    ds = load_colmap_dataset(cfg, "train")
    images, poses, intr = s1._prep_train_arrays(ds)
    mvps = torch.from_numpy(np.asarray(ds.mvps, np.float32)).to(dev)
    calls = []
    with inwin_calls(calls):
        s1.stage1_step(images, poses, mvps, intr)
    errs = hold_inwin(calls, f"unbounded {run} stage-1 step")
    if reload:
        saved = read_jax_checkpoint(
            os.path.join(ws, "checkpoints", "ngp_stage1_latest.ckpt"))
        psnr = float(saved["stats"]["results"][0]["PSNR"])
        tester = cli_main(s1_argv + ["--test"], device=dev)
        fresh = Trainer(cfg, device=dev)
        fresh.setup_stage1(ds)
        if not fresh.load_checkpoint():
            raise AssertionError(f"{run}: no stage-1 checkpoint to load")
        res = fresh.evaluate(load_colmap_dataset(cfg, "val"),
                             name="s1_reload", track_best=False)
        log(f"[unbounded] {run} stage-1 --test at step {tester.step}; a "
            f"fresh Trainer at step {fresh.step}: val PSNR "
            f"{res['PSNR']:.6f} vs {psnr:.6f} recorded")
        if not abs(res["PSNR"] - psnr) <= 1e-4:
            raise AssertionError(f"{run}: stage-1 reloaded PSNR "
                                 f"{res['PSNR']} != {psnr}")
    return s1_launches, errs


def phase_unbounded(dev, ref_ms):
    """Phase 10: the COLMAP capture through the CLI in three runs (the LLFF
    recipe at bound 4 with stage 1, the 360 recipe's geometry at bound 16,
    and that contracted with stage 1); returns ({run: stage-0 training
    launches}, {run: stage-1 training launches}, K1-K3's max|err| at the
    runs' shapes)."""
    from nerf2mesh_tpu_torch.data.synthetic import generate_colmap_dataset

    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_unb_")
    try:
        t0 = time.perf_counter()
        scene_dir = generate_colmap_dataset(
            os.path.join(tmp, "scene"), H=UNB_SIZE, W=UNB_SIZE,
            n_images=UNB_VIEWS)
        log(f"[unbounded] COLMAP capture ({UNB_VIEWS} views at {UNB_SIZE}^2) "
            f"written in {time.perf_counter() - t0:.1f} s")
        launches, s1_launches, errs = {}, {}, {}

        def merge(e):
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)

        # (a) the LLFF recipe, then stage 1 with a refine and a reload
        ws = os.path.join(tmp, "llff")
        tr, argv, launches["llff"], e, _ = unbounded_stage0(
            dev, scene_dir, ws, "llff", dict(
                bound=4.0, enable_cam_near_far=True, iters=UNB_STEPS,
                fp16=True), ref_ms)
        merge(e)
        del tr
        s1_launches["llff"], e = unbounded_stage1(
            dev, argv, "llff", ["--iters", str(UNB_S1_STEPS), "--s1_shell",
                                "4", "--s1_stochastic",
                                "--refine_steps_ratio", "0.5"],
            UNB_TEXTURE, True)
        merge(e)

        # (b) the 360 recipe's geometry at bound 16
        flags360 = dict(bound=16.0, enable_cam_center=True,
                        enable_cam_near_far=True, lambda_entropy=1e-3,
                        lambda_tv=2e-8)
        tr, _, launches["360"], e, _ = unbounded_stage0(
            dev, scene_dir, os.path.join(tmp, "360"), "360",
            dict(flags360, iters=UNB360_STEPS, mcubes_reso=UNB_SIDE_MCUBES),
            ref_ms)
        merge(e)
        del tr

        # (c) (b) contracted, with stage 1 (no refines)
        tr, argv, launches["contract"], e, _ = unbounded_stage0(
            dev, scene_dir, os.path.join(tmp, "contract"), "contract",
            dict(flags360, contract=True, iters=CON_STEPS,
                 mcubes_reso=UNB_SIDE_MCUBES), ref_ms)
        merge(e)
        del tr
        s1_launches["contract"], e = unbounded_stage1(
            dev, [a for a in argv if a != "--refine"], "contract",
            ["--iters", str(CON_S1_STEPS), "--s1_shell", "4",
             "--s1_stochastic"],
            CON_TEXTURE, False)
        merge(e)
        return launches, s1_launches, errs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 11: real-capture input and the last trainer options
# --------------------------------------------------------------------------

# -O's flags but the visibility cull, which -O cannot turn off: the
# cameras sit inside the marched box (ROADMAP C)
O_FLAGS = dict(fp16=True, preload=True, mark_untrained=True,
               random_image_batch=True, adaptive_num_rays=True, refine=True)


@contextlib.contextmanager
def patched(cls, name, make):
    """Within: cls.name is make(the original)."""
    real = getattr(cls, name)
    setattr(cls, name, make(real))
    try:
        yield
    finally:
        setattr(cls, name, real)


@contextlib.contextmanager
def timed_calls(module, names, into):
    """Within: each module.name adds its calls' wall seconds to
    into[name]."""
    real = {n: getattr(module, n) for n in names}

    def wrap(n):
        def f(*a, **k):
            t0 = time.perf_counter()
            out = real[n](*a, **k)
            into[n] = into.get(n, 0.0) + time.perf_counter() - t0
            return out
        return f

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(module, n, f)


def capture_load(scene_dir, argv):
    """Load the capture's train split as the CLI does, timing the JPEG
    decode, the resizes and the RANSAC fits; check each view's fit against
    the maps' affine.  Returns the dataset."""
    from nerf2mesh_tpu_torch.config import parse_args
    from nerf2mesh_tpu_torch.data import colmap as colmap_mod
    from nerf2mesh_tpu_torch.data.resize import resize_linear
    walls = {}
    with timed_calls(colmap_mod, ("read_image", "resize_bicubic",
                                  "resize_linear", "fit_dense_depth"),
                     walls):
        t0 = time.perf_counter()
        ds = colmap_mod.load_colmap_dataset(parse_args(argv), "train")
        total = time.perf_counter() - t0
    mp = ds.num_frames * CAP_SIZE * CAP_SIZE / 2 ** 20
    log(f"[captures] load of {ds.num_frames} train views "
        f"({CAP_SIZE}^2 4:2:0 JPEGs -> {ds.W}x{ds.H}, {CAP_DEPTH}^2 depth "
        f"maps): {total:.3f} s, of which JPEG decode "
        f"{walls.get('read_image', 0):.3f} s "
        f"({walls.get('read_image', 0) / mp * 1e3:.2f} ms per MP over "
        f"{mp:.1f} MP), depth resize {walls.get('resize_linear', 0):.3f} s, "
        f"frame resize {walls.get('resize_bicubic', 0):.3f} s, RANSAC "
        f"{walls.get('fit_dense_depth', 0):.3f} s")
    if walls.get('read_image', 0) / mp > 0.5:
        raise AssertionError("JPEG decode above 0.5 s per MP")
    # each view's fit maps a * z + c to scale * z: scale / s = a, -b / s = c
    a_true, c_true = CAP_AFFINE
    ids = [i for i in range(CAP_VIEWS) if i % 8]
    errs = []
    for i, m in zip(ids, ds.dense_depth):
        raw = resize_linear(np.load(os.path.join(
            scene_dir, "depths", f"frame_{i:04d}.npy")), ds.W, ds.H)
        A = np.stack([raw.ravel(), np.ones(raw.size)], 1).astype(np.float64)
        s_, b_ = np.linalg.lstsq(A, m.ravel().astype(np.float64),
                                 rcond=None)[0]
        errs.append((abs(CAP_SCALE / s_ / a_true - 1),
                     abs(-b_ / s_ / c_true - 1)))
    e = np.array(errs)
    log(f"[captures] RANSAC's (a, c) relative errors a view: "
        f"{np.round(e, 5).tolist()}; median a {np.median(e[:, 0]):.5f}, "
        f"c {np.median(e[:, 1]):.5f}; views within 1% in a "
        f"{int((e[:, 0] <= 0.01).sum())}/{len(e)}, in c "
        f"{int((e[:, 1] <= 0.01).sum())}/{len(e)}")
    # JAX's sklearn fit on this capture misses 1% in a on 1-3 views and in
    # c on 8-9 of 28 (its sparse points crowd the spheres' silhouettes):
    # the median view and 3/4 of the views in a are held to 1%
    if not (np.median(e, axis=0).max() <= 0.01
            and (e[:, 0] <= 0.01).mean() >= 0.75):
        raise AssertionError(f"RANSAC fits: {e.tolist()}")
    return ds


def depth_steps(records, label, sparse):
    """The depth term of each recorded step: zero at step 0 (the ramp),
    non-zero on every later step that carries depth (dense: all; sparse:
    those whose use_sd draw is on) and zero on the others."""
    vals = [(float(m["depth_loss"]), None if u is None else bool(u))
            for m, u in records]
    carry = [v for v, u in vals[1:] if u in (None, True)]
    rest = [v for v, u in vals[1:] if u is False]
    log(f"[captures] {label}: depth term on {len(vals)} steps: "
        f"{len(carry)} carry depth (min {min(carry) if carry else None}), "
        f"{len(rest)} do not (max {max(rest) if rest else None})")
    if not carry or min(carry) <= 0 or any(rest) or not all(
            math.isfinite(v) for v, _ in vals):
        raise AssertionError(f"{label}: depth terms {vals}")


def capture_run(dev, argv, run, ref_ms, max_steps=None, sparse=False):
    """One stage-0 CLI run of phase 11 (training capped at max_steps, the
    SDF pretrain cut to SDF_PRETRAIN); gates its losses, evals, launches
    and depth terms, profiles PROFILE_STEPS steps and holds K1-K3 at one more step's
    arguments.  Returns (trainer, launches, K1-K3 max|err|)."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.config import parse_args
    from nerf2mesh_tpu_torch.main import main as cli_main
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    cfg = parse_args(argv)
    log(f"[captures] {run}: main {' '.join(argv[1:])}")
    launches, records, draws = {}, [], []

    def capped(real):
        # no eval inside the training: the CLI's final val eval follows it
        def f(self, ds, val=None, max_steps=None):
            return real(self, ds, None, max_steps=cap)
        return f

    def short_pretrain(real):
        return lambda self, *a, **k: real(self, iters=SDF_PRETRAIN)

    def recording_step(real):
        def f(self, *a, **k):
            m = real(self, *a, **k)
            records.append(m)
            return m
        return f

    def recording_draw(real):
        def f(self, *a, **k):
            d = real(self, *a, **k)
            draws.append(d.get("use_sd"))
            return d
        return f

    cap = max_steps or cfg.iters
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    real = counting(Trainer, "train", launches)
    try:
        with patched(Trainer, "sdf_pretrain", short_pretrain), \
                patched(Trainer, "train_step", recording_step), \
                patched(Trainer, "draw", recording_draw):
            Trainer.train = capped(Trainer.train)
            t0 = time.perf_counter()
            trainer = cli_main(argv, device=dev)
            torch.cuda.synchronize()
            t_main = time.perf_counter() - t0
    finally:
        Trainer.train = real
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tl = trainer.train_log
    losses = [e["loss"] for e in tl]
    half = next(e for e in tl if e["step"] >= cap // 2)
    ms_step = ((tl[-1]["seconds"] - half["seconds"])
               / (tl[-1]["step"] - half["step"]) * 1e3)
    log(f"[captures] {run}: main ran {t_main:.1f} s, {trainer.step} steps "
        f"({cfg.cascades} cascades, grid bound {cfg.grid_bound}, fp16 "
        f"{cfg.fp16}); logged losses {np.round(losses, 5).tolist()}; steps "
        f"{half['step']}-{tl[-1]['step']}: {ms_step:.2f} ms/step (logged "
        f"wall); peak memory {peak:.2f} GiB; evals "
        f"{trainer.stats['results']}; training launches {launches}")
    # every step's loss: a patch step sees one view, so the logged ones
    # (every cap // 10 steps) are noisy; the first and last quarters'
    # means are compared
    steps = [float(m["loss"]) for m in records[:cap]]
    q = max(1, cap // 4)
    log(f"[captures] {run}: mean loss of steps 1-{q} {np.mean(steps[:q]):.6f}, "
        f"of steps {cap - q + 1}-{cap} {np.mean(steps[-q:]):.6f}")
    if trainer.step != cap or not all(math.isfinite(v)
                                      for v in losses + steps):
        raise AssertionError(f"{run}: step {trainer.step}, losses {losses}")
    if not np.mean(steps[-q:]) < np.mean(steps[:q]):
        raise AssertionError(f"{run}: loss did not fall: {steps}")
    for key in ("occ_lookup", "inwin_fwd", "inwin_bwd"):
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"{run}: {key} was not launched by training")
    res = trainer.stats["results"]
    if not res or not all(math.isfinite(v) for r in res for v in r.values()):
        raise AssertionError(f"{run}: evals {res}")
    if cfg.enable_sparse_depth or cfg.enable_dense_depth:
        depth_steps(list(zip(records, draws))[:cap], run, sparse)
    ds = trainer._train_arrays_for
    profile_region(lambda: trainer.train_steps(ds, PROFILE_STEPS),
                   f"captures {run} steps {cap}-{cap + PROFILE_STEPS}",
                   per=PROFILE_STEPS)
    errs = hold_step_kernels(trainer, ds, f"captures {run} step", ref_ms)
    return trainer, launches, errs


def phase_captures(dev, ref_ms):
    """Phase 11: (a) the runall_sdf_outdoor.sh recipe on a JPEG + depth
    capture, stages 0 and 1; (b) the LLFF recipe with sparse depth; (c)
    the A6 (d) options on a blender scene; with Pillow, cv2 and sklearn
    blocked.  Returns ({run: stage-0 launches}, {run: stage-1 launches},
    K1-K3's max|err| at the runs' shapes)."""
    from nerf2mesh_tpu_torch.data.synthetic import (generate_colmap_dataset,
                                                    generate_synthetic_dataset)
    from nerf2mesh_tpu_torch.meshing.io import read_ply

    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_cap_")
    try:
        t0 = time.perf_counter()
        scene_dir = generate_colmap_dataset(
            os.path.join(tmp, "capture"), H=CAP_SIZE, W=CAP_SIZE,
            n_images=CAP_VIEWS, image_format="jpeg", jpeg_quality=95,
            jpeg_subsampling="4:2:0", depth_size=(CAP_DEPTH, CAP_DEPTH),
            depth_affine=CAP_AFFINE, depth_outliers=CAP_OUTLIERS)
        log(f"[captures] capture ({CAP_VIEWS} views, {CAP_SIZE}^2 4:2:0 "
            f"JPEGs, no images_4/, {CAP_DEPTH}^2 depth maps) written in "
            f"{time.perf_counter() - t0:.1f} s")
        launches, s1_launches, errs = {}, {}, {}

        def merge(e):
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)

        # (a) runall_sdf_outdoor.sh, stage 0 then stage 1
        flags = dict(O_FLAGS, sdf=True, data_format="colmap", bound=16.0,
                     scale=CAP_SCALE, downscale=4, enable_cam_center=True,
                     enable_cam_near_far=True, enable_dense_depth=True,
                     lambda_entropy=1e-3, lambda_normal=1e-1, n_eval=1,
                     n_ckpt=1, test_no_video=True, mcubes_reso=CAP_MCUBES,
                     decimate_target=CAP_DECIMATE)
        ws = os.path.join(tmp, "outdoor")
        argv = cli_argv(scene_dir, ws, **flags) + ["--ckpt", "scratch"]
        capture_load(scene_dir, argv)
        tr, launches["outdoor"], e = capture_run(dev, argv, "outdoor",
                                                 ref_ms, CAP_STEPS)
        merge(e)
        meshes = {}
        for c in range(tr.cfg.cascades):
            p = os.path.join(ws, "mesh_stage0", f"mesh_{c}.ply")
            if os.path.exists(p):
                v, f = read_ply(p)
                meshes[c] = (len(v), len(f), float(np.abs(v).max())
                             if len(v) else 0.0)
        log(f"[captures] outdoor: meshes (cascade: vertices, faces, max|v|) "
            f"{meshes}; export seconds {tr.stats['mesh_seconds']}")
        if 0 not in meshes or meshes[0][1] == 0 or meshes[0][2] > 1 + 1e-5:
            raise AssertionError(f"outdoor: mesh_0.ply {meshes.get(0)}")
        del tr
        argv = [a for a in argv if a not in ("--ckpt", "scratch")]
        s1_launches["outdoor"], e = unbounded_stage1(
            dev, argv, "outdoor", ["--iters", str(CAP_S1_STEPS),
                                   "--refine_steps_ratio", "0.5"],
            CAP_TEXTURE, False)
        merge(e)

        # (b) runall_llff.sh with sparse depth
        flags = dict(O_FLAGS, data_format="colmap", scale=-1.0, downscale=4,
                     bound=4.0, enable_cam_near_far=True,
                     enable_sparse_depth=True, iters=CAP_SPARSE_STEPS,
                     n_eval=1, n_ckpt=1, test_no_video=True,
                     test_no_mesh=True)
        tr, launches["sparse"], e = capture_run(
            dev, cli_argv(scene_dir, os.path.join(tmp, "sparse"), **flags),
            "sparse", ref_ms, sparse=True)
        merge(e)
        del tr

        # (c) the A6 (d) options on a blender scene
        t0 = time.perf_counter()
        blender = generate_synthetic_dataset(
            os.path.join(tmp, "blender"), H=OPT_SIZE, W=OPT_SIZE, n_train=24,
            n_val=N_VAL, n_test=2)
        log(f"[captures] blender scene ({OPT_SIZE}^2, 24 + {N_VAL} + 2 "
            f"views) written in {time.perf_counter() - t0:.1f} s")
        flags = dict(fp16=True, downscale=2, train_split="trainval",
                     patch_size=4,
                     color_space="linear", trainable_density_grid=True,
                     lambda_density=1e-4, ind_dim=4, iters=OPT_STEPS,
                     n_eval=1, n_ckpt=1, test_no_video=True,
                     test_no_mesh=True)
        tr, launches["options"], e = capture_run(
            dev, cli_argv(blender, os.path.join(tmp, "options"), **flags),
            "options", ref_ms)
        merge(e)
        if tuple(tr.params.individual_codes.shape) != (tr.cfg.ind_num, 4):
            raise AssertionError("options: no per-image codes")
        del tr
        return launches, s1_launches, errs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 12: the field options on the hard proxy scene
# --------------------------------------------------------------------------

def hard_scene(cfg):
    """The hard proxy scene (data/synthetic.py HardScene) at 256x256, 24
    train and HARD_VAL val views, in memory."""
    from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
    from nerf2mesh_tpu_torch.data.synthetic import (HardScene,
                                                    render_synthetic_frames)
    frames = render_synthetic_frames(HardScene(), H=256, W=256, n_train=24,
                                     n_val=HARD_VAL, n_test=0)
    return (dataset_from_frames(cfg, frames, "train"),
            dataset_from_frames(cfg, frames, "val"))


@contextlib.contextmanager
def separate_tables():
    """Within: the port's Trainer builds its field with separate density
    (C = 1) and colour (C = 2) tables; no CLI flag sets them, in either
    package."""
    import functools
    from nerf2mesh_tpu_torch.utils import trainer as ttr
    with patched(ttr, "NetworkSpec",
                 lambda real: functools.partial(real, separate_tables=True)):
        yield


def hard_run(dev, ds, val, run, steps, cfg_kw, must_launch, sep, marks):
    """One phase-12 training run on the hard scene: a fresh Trainer at
    bench.py's configuration with cfg_kw, its occupancy grid the untrained
    marks `marks` (a RenderState from mark_untrained on ds at the same
    render spec: the marks are a function of the views and that spec
    alone), the val eval before and after `steps` training steps (the PSNR
    must rise, the losses be finite and fall), the kernels of must_launch
    launched by the training alone, and with separate tables no C = 3
    launch.  Returns (trainer, record)."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.models.renderer import RenderState
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    cfg = bench_config(**cfg_kw)
    with (separate_tables() if sep else contextlib.nullcontext()):
        trainer = Trainer(cfg, device=dev)
    if trainer.net_spec.separate_tables != sep:
        raise AssertionError(f"{run}: separate_tables is not {sep}")
    if trainer.render_spec != marks[0]:
        raise AssertionError(f"{run}: render spec {trainer.render_spec} is "
                             f"not the marks' {marks[0]}")
    r = marks[1]
    trainer.render = RenderState(r.density_grid.clone(), r.occ_grid.clone(),
                                 r.mean_density.clone(), r.iter_density)
    shapes = {k: tuple(p.shape) for k, p in trainer.params.named_parameters()
              if k.endswith("table")}
    psnr0, _, _ = run_eval(trainer, val, f"hard_{run}_before", ())
    torch.cuda.reset_peak_memory_stats()
    losses, buckets, _, m, ms_step, rays_s, launches = train_window(
        trainer, ds, steps, min(TIMED_STEPS, steps // 2))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    psnr1, ms_frame, _ = run_eval(trainer, val, f"hard_{run}_after", ())
    log(f"[hard] ({run}) tables {shapes}; {steps} steps: losses first "
        f"{np.round(losses[:4], 5).tolist()} last "
        f"{np.round(losses[-4:], 5).tolist()}; {ms_step:.2f} ms/step, "
        f"{rays_s:.1f} rays/s, peak {peak:.2f} GiB; val PSNR {psnr0:.4f} -> "
        f"{psnr1:.4f} ({ms_frame:.1f} ms/frame); launches "
        + str({k: v for k, v in launches.items() if v}))
    if not psnr1 > psnr0:
        raise AssertionError(f"hard ({run}): val PSNR did not rise: "
                             f"{psnr0} -> {psnr1}")
    for k in must_launch:
        if launches[k] <= 0:
            raise AssertionError(f"hard ({run}): {k} was not launched")
    if sep and any(launches[f"{k}_c3"] for k in kernels.CHANNEL_KERNELS):
        raise AssertionError(f"hard ({run}): a C = 3 kernel launched with "
                             f"separate tables: {launches}")
    return trainer, dict(psnr=psnr1, psnr_before=psnr0, ms_step=ms_step,
                         launches=launches, buckets=buckets)


def hold_channels(calls, label):
    """hold_inwin on the calls of each channel count apart; returns
    {"<name>_c<C>": max|err|}."""
    errs = {}
    for C in (1, 2):
        sub = [(n, a) for n, a in calls if a[0].shape[-1] == C]
        for name, err in hold_inwin(sub, f"{label}, C={C}").items():
            errs[f"{name}_c{C}"] = err
    return errs


def phase_hard(dev):
    """Phase 12: the hard proxy scene at bench width: (a) the merged
    block512 table, (b) separate tables (K2/K3 at C = 1 and 2, held at one
    more step's arguments), (c) separate tables at the ref 2^14 table
    (K4/K4b at C = 1 and 2), (d) separate tables with winsort_fine (K5/K6
    at C = 1 and 2).  Returns ({run: launch counts}, {kernel: max|err|})."""
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    cfg = bench_config()
    t0 = time.perf_counter()
    ds, val = hard_scene(cfg)
    t1 = time.perf_counter()
    tr = Trainer(cfg, device=dev)
    tr.mark_untrained(ds)
    marks = (tr.render_spec, tr.render)
    del tr
    log(f"[hard] scene {ds.images.shape} + {val.images.shape} val rendered "
        f"in {t1 - t0:.1f} s, its untrained marks in "
        f"{time.perf_counter() - t1:.1f} s; alpha coverage "
        f"{float(ds.images[..., 3].astype(np.float32).mean() / 255):.3f}")
    rec, errs = {}, {}
    c12 = lambda *names: [f"{n}_c{c}" for n in names for c in (1, 2)]
    tr, rec["merged"] = hard_run(dev, ds, val, "a_merged", HARD_STEPS, {},
                                 ("occ_lookup", "inwin_fwd_c3",
                                  "inwin_bwd_c3"), False, marks)
    prof_a = profile_region(lambda: tr.train_steps(ds, PROFILE_STEPS),
                            "hard (a) merged steps", per=PROFILE_STEPS)
    del tr
    tr, rec["separate"] = hard_run(dev, ds, val, "b_separate", HARD_STEPS,
                                   {}, c12("inwin_fwd", "inwin_bwd"), True,
                                   marks)
    prof_b = profile_region(lambda: tr.train_steps(ds, PROFILE_STEPS),
                            "hard (b) separate steps", per=PROFILE_STEPS)
    calls = []
    with inwin_calls(calls):
        tr.train_steps(ds, 1)
    errs.update(hold_channels(calls, "hard (b)"))
    del tr
    for name, prof in (("merged", prof_a), ("separate", prof_b)):
        rec[name]["idle_share"] = (None if prof is None
                                   else 1 - prof[1] / prof[0])
    log("[hard] (a) merged vs (b) separate tables: val PSNR "
        f"{rec['merged']['psnr']:.4f} vs {rec['separate']['psnr']:.4f} dB; "
        f"{rec['merged']['ms_step']:.2f} vs {rec['separate']['ms_step']:.2f}"
        f" ms/step; idle share {rec['merged']['idle_share']} vs "
        f"{rec['separate']['idle_share']}")
    _, rec["ref"] = hard_run(dev, ds, val, "c_separate_ref",
                             HARD_REF_STEPS, dict(grid_layout="ref",
                                                  log2_hashmap_size=14),
                             c12("sweep_fwd", "sweep_bwd"), True, marks)
    _, rec["winsort"] = hard_run(dev, ds, val, "d_separate_winsort",
                                 HARD_WS_STEPS, dict(winsort_fine=True,
                                                     stochastic_fine=False),
                                 c12("winsort_fwd", "winsort_bwd"), True,
                                 marks)
    return {k: v["launches"] for k, v in rec.items()}, errs


# --------------------------------------------------------------------------
# phase 13: the remaining entry points (dtu, data-parallel ranks, the
# viewer, the entry analogue)
# --------------------------------------------------------------------------

def read_pose_ply(path):
    """(header lines, xyz [N, 3], rgb [N, 3]) of a --vis_pose PLY."""
    with open(path, "rb") as f:
        data = f.read()
    head, body = data.split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    n = int(next(ln for ln in lines if ln.startswith("element vertex"))
            .split()[-1])
    rec = np.frombuffer(body, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    if len(rec) != n or len(body) != 15 * n:
        raise AssertionError(f"{path}: {n} vertices declared, "
                             f"{len(body)} bytes of records")
    return lines, rec["xyz"], rec["rgb"]


def phase_dtu(dev):
    """Phase 13 (a): a DTU scene (cameras_sphere.npz, image/, mask/) of the
    sphere scene's views through the CLI with --data_format dtu
    --vis_pose at bench width; returns the training's launch counts."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.data.synthetic import generate_dtu_dataset
    from nerf2mesh_tpu_torch.main import main as cli_main
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_dtu_")
    try:
        t0 = time.perf_counter()
        root = generate_dtu_dataset(os.path.join(tmp, "scan"), H=ENTRY_SIZE,
                                    W=ENTRY_SIZE, n_views=DTU_VIEWS)
        ws = os.path.join(tmp, "ws")
        argv = cli_argv(root, ws, data_format="dtu", vis_pose=True,
                        iters=DTU_STEPS, n_eval=1, n_ckpt=1,
                        test_no_mesh=True, test_no_video=True)
        log(f"[dtu] {DTU_VIEWS} views written in "
            f"{time.perf_counter() - t0:.1f} s; main {' '.join(argv[1:])}")
        launches = {}
        kernels.reset_launches()
        real = counting(Trainer, "train", launches)
        try:
            t0 = time.perf_counter()
            trainer = cli_main(argv, device=dev)
            torch.cuda.synchronize()
            t_main = time.perf_counter() - t0
        finally:
            Trainer.train = real
        tl = trainer.train_log
        losses = [e["loss"] for e in tl]
        results = trainer.stats["results"]
        a, b = tl[len(tl) // 2], tl[-1]
        ms_step = (b["seconds"] - a["seconds"]) / (b["step"] - a["step"]) * 1e3
        lines, xyz, rgb = read_pose_ply(os.path.join(ws, "poses.ply"))
        n_cams = int((rgb == (0, 255, 0)).all(-1).sum()) // 64
        log(f"[dtu] main ran {t_main:.1f} s; logged losses "
            f"{np.round(losses, 5).tolist()}; steps {a['step']}-{b['step']}:"
            f" {ms_step:.2f} ms/step; evals {results}; poses.ply "
            f"{len(xyz)} points ({n_cams} cameras); training launches "
            f"{launches}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite logged loss: {losses}")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"dtu loss did not fall: {losses}")
        if not all(math.isfinite(v) for r in results for v in r.values()):
            raise AssertionError(f"dtu evals: {results}")
        n_train = DTU_VIEWS - len(range(0, DTU_VIEWS, 8))
        if n_cams != n_train or not np.isfinite(xyz).all():
            raise AssertionError(f"poses.ply: {n_cams} cameras for "
                                 f"{n_train} training views")
        for k in ("occ_lookup", "inwin_fwd", "inwin_bwd"):
            if launches.get(k, 0) <= 0:
                raise AssertionError(f"{k} was not launched by dtu training")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def grad_error(got: torch.Tensor, want: torch.Tensor, name: str) -> float:
    """max |got - want|, raising outside tests/test_torch_slice.py's
    tolerances: rtol 1e-3 with atol 1e-4 * max|want| (table) or 1e-6 *
    max|want| (MLPs), and the table within 1e-4 in relative L2."""
    scale = float(want.abs().max())
    atol = (1e-4 if "table" in name else 1e-6) * scale
    err = (got - want).abs()
    if bool((err > atol + 1e-3 * want.abs()).any()) or (
            "table" in name and float(err.norm()) > 1e-4 * float(
                want.norm())):
        raise AssertionError(f"{name}: the all-reduced gradient differs "
                             f"from the mean of the ranks' by "
                             f"{float(err.max())} (max |g| {scale})")
    return float(err.max())


@contextlib.contextmanager
def timed_grad_reduce(cuda: bool):
    """Within: each call of distributed.all_reduce_mean_grads appends to
    the yielded list a function that returns the call's ms.  On the card
    that is a pair of CUDA events on the current stream around the call
    (the wait for the other ranks included), with no host synchronisation,
    so the step keeps its overlap; read them after a synchronize.  On the
    CPU it is the host clock."""
    from nerf2mesh_tpu_torch.parallel import distributed
    real = distributed.all_reduce_mean_grads
    timings = []

    def timed(params):
        if cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            real(params)
            b.record()
            timings.append(lambda: a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            real(params)
            dt = (time.perf_counter() - t0) * 1e3
            timings.append(lambda: dt)

    distributed.all_reduce_mean_grads = timed
    try:
        yield timings
    finally:
        distributed.all_reduce_mean_grads = real


@contextlib.contextmanager
def uncounted():
    """Within: kernel launches are not counted (comparisons with the plain
    versions)."""
    from nerf2mesh_tpu_torch import kernels
    before = dict(kernels.LAUNCHES)
    try:
        yield
    finally:
        kernels.LAUNCHES.update(before)


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ms_per_step(log_entries):
    """ms a step between the first and the last of the logged entries
    (train_log's)."""
    a, b = log_entries[0], log_entries[-1]
    return (b["seconds"] - a["seconds"]) / (b["step"] - a["step"]) * 1e3


def _dist_rank(rank, n, port, workdir, argv0, argv1, device):
    """One rank of phase 13 (b), started as torchrun starts one: the CLI's
    main with argv0 (stage 0, resumed from the checkpoint in the
    workspace), then with argv1 (stage 1).  The first stage-0 step's
    all-reduced gradient is held against the mean of both ranks' gradients
    computed on rank 0, and rank 0's K1-K3 at that step and K2/K3 at the
    first stage-1 step against their plain versions; writes
    <workdir>/rank<r>.json."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch.distributed as dist

    from nerf2mesh_tpu_torch.main import main as cli_main
    from nerf2mesh_tpu_torch.parallel import distributed
    from nerf2mesh_tpu_torch.utils.trainer import Trainer

    cuda = device == "cuda"
    held = {"first_step_err": 0.0, "errs": {}}
    real_step, real_s1 = Trainer.train_step, Trainer.stage1_step

    def keep_errs(errs):
        for k, v in errs.items():
            held["errs"][k] = max(held["errs"].get(k, 0.0), v)

    def first_step(self, images, poses, intr, num_rays, dyn, draws=None,
                   **kw):
        Trainer.train_step = real_step
        per = num_rays // self.world
        if draws is None:
            draws = self.draw(per, *images.shape[:3])
        mean = None
        with uncounted():
            # rank 1's draws to rank 0 (gloo broadcasts CUDA tensors)
            theirs = {k: (v.clone() if rank == 1 else torch.empty_like(v))
                      for k, v in draws.items()}
            for k in sorted(theirs):
                dist.broadcast(theirs[k], 1)
            if rank == 0:
                grads = []
                for d in (draws, theirs):
                    self.optimizer.zero_grad(set_to_none=True)
                    loss, _ = self._loss_and_metrics(
                        self.params, self.render, images, poses, intr, dyn,
                        per, d, kw.get("cam_near_far"), kw.get("depth"))
                    loss.backward()
                    grads.append({k: (torch.zeros_like(p) if p.grad is None
                                      else p.grad.clone())
                                  for k, p in self.params.named_parameters()})
                mean = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}
                del grads
        occ, calls = [], []
        with occ_calls(occ), inwin_calls(calls):
            m = real_step(self, images, poses, intr, num_rays, dyn,
                          draws=draws, **kw)
        if rank == 0:
            with uncounted():
                held["first_step_err"] = max(
                    grad_error(p.grad, mean[k], k)
                    for k, p in self.params.named_parameters())
                keep_errs(hold_inwin(calls, "rank 0's stage-0 step"))
                keep_errs({"occ_lookup": hold_occ(occ,
                                                  "rank 0's stage-0 step")})
        return m

    def first_s1_step(self, *a, **k):
        Trainer.stage1_step = real_s1
        calls = []
        with inwin_calls(calls):
            m = real_s1(self, *a, **k)
        if rank == 0:
            with uncounted():
                keep_errs(hold_inwin(calls, "rank 0's stage-1 step"))
        return m

    launches0, launches1 = {}, {}
    real_train = counting(Trainer, "train", launches0)
    real_train1 = counting(Trainer, "train_stage1", launches1)
    Trainer.train_step, Trainer.stage1_step = first_step, first_s1_step
    try:
        with no_modules("PIL", "cv2", "sklearn"), \
                timed_grad_reduce(cuda) as reduce_ms:
            t = cli_main(argv0, device=device)
            n0 = len(reduce_ms)
            t0_log, steps0 = t.train_log, t.step
            digest0 = distributed.digest(
                list(t.params.parameters()) + list(t.ema_params.values())
                + [t.render.density_grid, t.render.occ_grid]).hex()
            del t
            t = cli_main(argv1, device=device)
        if cuda:
            torch.cuda.synchronize()
        reduce_ms = [f() for f in reduce_ms]
        refine = t.stats["refines"][0][0]
        s1_log = [e for e in t.train_log if e["step"] >= refine]
        res = dict(
            rank=rank, device=str(t.device), backend=dist.get_backend(),
            steps0=steps0, losses=[e["loss"] for e in t0_log],
            ms_step=ms_per_step(t0_log), steps_timed=(t0_log[0]["step"],
                                                      t0_log[-1]["step"]),
            rays_per_s=((t0_log[-1]["rays"] - t0_log[0]["rays"])
                        / (t0_log[-1]["seconds"] - t0_log[0]["seconds"])),
            allreduce_ms=sum(reduce_ms[:n0]) / max(n0, 1),
            s1_losses=[e["loss"] for e in t.train_log],
            s1_ms_step=ms_per_step(s1_log), s1_steps=(refine, t.step),
            s1_allreduce_ms=(sum(reduce_ms[n0:])
                             / max(len(reduce_ms) - n0, 1)),
            faces=[e["faces"] for e in t.train_log],
            refines=t.stats["refines"], digest0=digest0,
            digest1=distributed.digest(
                list(t._named_params().values())
                + [t.stage1_mesh.vertices, t.stage1_mesh.triangles]).hex(),
            launches0=launches0, launches1=launches1, **held)
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        Trainer.train, Trainer.train_stage1 = real_train, real_train1
        Trainer.train_step, Trainer.stage1_step = real_step, real_s1
        dist.destroy_process_group()


def phase_dist(dev, field):
    """Phase 13 (b): two ranks on the one card (gloo), spawned with
    torchrun's environment, each running the CLI's stage 0 from the
    phase-8 field's checkpoint and then stage 1; returns rank 0's launch
    counts of stage 0 and stage 1 and the largest |err| of its kernel
    holds."""
    import torch.multiprocessing as mp

    from nerf2mesh_tpu_torch.data.synthetic import generate_synthetic_dataset

    workdir = tempfile.mkdtemp(prefix="n2m_chip_smoke_dist_")
    try:
        t0 = time.perf_counter()
        scene_dir = generate_synthetic_dataset(
            os.path.join(workdir, "scene"), H=ENTRY_SIZE, W=ENTRY_SIZE,
            n_train=24, n_val=1, n_test=1)
        ws = os.path.join(workdir, "ws")
        field.workspace = ws
        field.save_checkpoint()
        start = field.step
        argv0 = cli_argv(scene_dir, ws, iters=start + DIST_STEPS, n_eval=1,
                         n_ckpt=1, test_no_video=True, mcubes_reso=S1_MCUBES,
                         mesh_visibility_culling=True)
        argv1 = cli_argv(scene_dir, ws, stage=1, iters=DIST_S1_STEPS,
                         n_eval=1, n_ckpt=1, refine=True, s1_shell=4,
                         s1_stochastic=True, texture_size=DIST_TEXTURE,
                         test_no_video=True, mcubes_reso=S1_MCUBES,
                         mesh_visibility_culling=True) + [
                             "--refine_steps_ratio", "0.5"]
        log(f"[dist] scene written and the phase-8 field (step {start}) "
            f"saved in {time.perf_counter() - t0:.1f} s; each rank runs main "
            f"{' '.join(argv0[1:])}, then main {' '.join(argv1[1:])}")
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        port = free_port()
        procs = [ctx.Process(target=_dist_rank,
                             args=(r, 2, port, workdir, argv0, argv1,
                                   dev.type))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(DIST_TIMEOUT)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if alive or any(codes):
            raise AssertionError(f"data-parallel ranks: exit codes {codes}"
                                 f"{' (timed out)' if alive else ''}")
        res = []
        for r in range(2):
            with open(os.path.join(workdir, f"rank{r}.json")) as fh:
                res.append(json.load(fh))
        for r in res:
            log(f"[dist] rank {r['rank']} on {r['device']} ({r['backend']}):"
                f" stage 0 steps {start}-{r['steps0']}, {r['ms_step']:.2f} "
                f"ms/step and {r['rays_per_s']:.0f} rays/s (both ranks') "
                f"over steps {r['steps_timed']} (the logged ones), "
                f"all-reduce {r['allreduce_ms']:.2f} ms/step; stage 1 "
                f"{r['s1_ms_step']:.2f} ms/step over steps {r['s1_steps']} "
                f"(after the refine), all-reduce {r['s1_allreduce_ms']:.2f}"
                f" ms/step; logged losses {np.round(r['losses'], 5)}; "
                f"stage-1 logged losses {np.round(r['s1_losses'], 5)}; faces"
                f" {r['faces']}, refines {r['refines']}; launches stage 0 "
                f"{r['launches0']}, stage 1 {r['launches1']}")
        log(f"[dist] 2 ranks ran in {time.perf_counter() - t0:.1f} s (spawn "
            f"included); first step: the all-reduced gradient within "
            f"{res[0]['first_step_err']:.3g} of the mean of both ranks' "
            f"gradients computed on rank 0; rank 0's kernels against their "
            f"plain versions at its first steps: {res[0]['errs']}")
        a, b = res
        if a["digest0"] != b["digest0"] or a["digest1"] != b["digest1"]:
            raise AssertionError("the ranks' parameters, grids or meshes "
                                 "differ")
        if a["losses"] != b["losses"] or a["s1_losses"] != b["s1_losses"]:
            raise AssertionError("the ranks' reduced losses differ")
        if len(a["refines"]) != 1 or a["refines"] != b["refines"]:
            raise AssertionError(f"stage 1 refines: {a['refines']}, "
                                 f"{b['refines']}")
        if a["steps0"] != start + DIST_STEPS:
            raise AssertionError(f"stage 0 ended at step {a['steps0']}, not "
                                 f"{start + DIST_STEPS}: the checkpoint was "
                                 f"not resumed")
        for r in res:
            for k in ("occ_lookup", "inwin_fwd", "inwin_bwd"):
                if r["launches0"].get(k, 0) <= 0:
                    raise AssertionError(f"rank {r['rank']}: {k} was not "
                                         f"launched by stage 0")
            for k in ("inwin_fwd", "inwin_bwd"):
                if r["launches1"].get(k, 0) <= 0:
                    raise AssertionError(f"rank {r['rank']}: {k} was not "
                                         f"launched by stage 1")
        ckpts = sorted(os.listdir(os.path.join(ws, "checkpoints")))
        for want in ("ngp_stage0_latest.ckpt", "ngp_stage1_latest.ckpt"):
            if want not in ckpts:
                raise AssertionError(f"no {want} in {ckpts}")
        nv, nf, share = surface_share(
            os.path.join(ws, "mesh_stage0", "mesh_0.ply"), field.cfg.scale)
        shapes = check_stage1_package(os.path.join(ws, "mesh_stage1"), False)
        log(f"[dist] rank 0 wrote checkpoints {ckpts}, the stage-0 mesh "
            f"(v={nv} f={nf}, surface share {share:.3f}) and the stage-1 "
            f"package (textures {shapes})")
        return a["launches0"], a["launches1"], a["errs"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def http_get(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.headers["Content-Type"], r.read()


def viewer_frames(viewer, n, label):
    """n frames over HTTP along an orbit: their decoded shapes, the round
    trip's ms each (lock waits included) and the downscale after each."""
    from nerf2mesh_tpu_torch.data.png import decode_png
    shapes, ms, scales = [], [], []
    for i in range(n):
        want = viewer.frame_shape()
        t0 = time.perf_counter()
        kind, png = http_get(viewer.port, f"/render?theta=1.1&phi="
                             f"{0.3 + 0.4 * i:.2f}&radius=2.5")
        ms.append((time.perf_counter() - t0) * 1e3)
        img = decode_png(png)
        if kind != "image/png" or img.shape != want + (3,) or img.std() == 0:
            raise AssertionError(f"{label} frame {i}: {kind} {img.shape} "
                                 f"(want {want}), std {img.std()}")
        shapes.append(img.shape[:2])
        scales.append(viewer.downscale)
    return shapes, ms, scales


def phase_viewer(dev, field, ds, val, t1):
    """Phase 13 (c): the viewer over HTTP: VIEWER_FRAMES stage-0 frames of
    the phase-4 field with --viewer_train's thread training it, then
    VIEWER_S1_FRAMES frames of phase 8's stage-1 state; returns the launch
    counts of the stage-0 serving (frames and training) and the largest
    |err| of K1 and K2 against their plain versions at one more stage-0
    frame's arguments."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.viewer import ViewerServer

    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_viewer_")
    try:
        field.workspace = tmp
        step0 = field.step
        torch.cuda.synchronize()
        kernels.reset_launches()
        v = ViewerServer(field, val, port=0, train_dataset=ds,
                         host="127.0.0.1")
        v.start()
        try:
            _, page = http_get(v.port, "/")
            if b"/render" not in page:
                raise AssertionError("the viewer's page")
            shapes, ms, scales = viewer_frames(v, VIEWER_FRAMES, "stage-0")
            status = json.loads(http_get(v.port, "/status")[1])
        finally:
            v.close()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        log(f"[viewer] stage 0: {VIEWER_FRAMES} frames, shapes {shapes}, "
            f"downscale after each {scales}, "
            f"round trips {np.round(ms, 1).tolist()} ms (budget "
            f"{v.budget_ms:.0f} ms; median {np.median(ms):.1f}); training "
            f"thread {step0} -> {field.step} steps, status {status}; "
            f"launches {launches}")
        if v.train_error is not None:
            raise AssertionError(f"viewer training: {v.train_error}")
        if set(scales) == {4}:
            raise AssertionError(f"the downscale did not move: {scales}")
        if field.step <= step0 or not os.path.exists(os.path.join(
                tmp, "checkpoints", "ngp_stage0_latest.ckpt")):
            raise AssertionError("the viewer's training thread did not run")
        for k in ("occ_lookup", "inwin_fwd", "inwin_bwd"):
            if launches[k] <= 0:
                raise AssertionError(f"{k} was not launched by the viewer")
        occ, calls = [], []
        with occ_calls(occ), inwin_calls(calls):
            v.render_frame(1.1, 0.3, 2.5)
        errs = hold_inwin(calls, "a viewer frame", need=("inwin_fwd",))
        errs["occ_lookup"] = hold_occ(occ, "a viewer frame")

        v1 = ViewerServer(t1, val, port=0, host="127.0.0.1")
        v1.start()
        try:
            shapes1, ms1, _ = viewer_frames(v1, VIEWER_S1_FRAMES, "stage-1")
        finally:
            v1.close()
        log(f"[viewer] stage 1: {VIEWER_S1_FRAMES} frames, shapes {shapes1},"
            f" round trips {np.round(ms1, 1).tolist()} ms")
        return launches, errs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_entry(dev):
    """Phase 13 (d): entry()'s forward render on the card, then
    dryrun_multichip(2) (two gloo ranks on the card)."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.entry import dryrun_multichip, entry
    fn, args = entry(dev)
    kernels.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if [tuple(o.shape) for o in out] != [(256, 3), (256,), (256,)] or not \
            all(bool(torch.isfinite(o).all()) for o in out):
        raise AssertionError(f"entry(): {[o.shape for o in out]}")
    if launches.get("occ_lookup", 0) <= 0 or launches.get("inwin_fwd",
                                                          0) <= 0:
        raise AssertionError(f"entry() launches {launches}")
    t0 = time.perf_counter()
    res = dryrun_multichip(2, device=dev.type)
    log(f"[entry] entry() on {out[0].device}: image mean "
        f"{float(out[0].mean()):.4f}, launches {launches}; "
        f"dryrun_multichip(2) in {time.perf_counter() - t0:.1f} s: {res}")
    for k in ("occ_lookup", "inwin_fwd", "inwin_bwd"):
        if res["launches"].get(k, 0) <= 0:
            raise AssertionError(f"dryrun_multichip: {k} not launched")


def phase_entry_points(dev, field, ds, val, t1):
    """Phase 13, with Pillow, cv2 and sklearn blocked: (a)-(d); returns
    the launch counts of (a), (b) (stage 0 and 1) and (c), and the largest
    |err| of the kernel holds of (b) and (c)."""
    t0 = time.perf_counter()
    dtu = phase_dtu(dev)
    log(f"[time] 13 (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dist0, dist1, dist_errs = phase_dist(dev, field)
    log(f"[time] 13 (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    viewer, viewer_errs = phase_viewer(dev, field, ds, val, t1)
    log(f"[time] 13 (c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_entry(dev)
    log(f"[time] 13 (d) {time.perf_counter() - t0:.1f} s")
    errs = {k: max(e.get(k, 0.0) for e in (dist_errs, viewer_errs))
            for k in set(dist_errs) | set(viewer_errs)}
    return dtu, {"stage0": dist0, "stage1": dist1}, viewer, errs


# --------------------------------------------------------------------------
# phase 14: checkpoints and codecs
# --------------------------------------------------------------------------
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "nerf2mesh_tpu_torch", "fixtures")


def sha(a) -> dict:
    """SHA-256 of an array's values (bool as 0/1), its dtype and shape."""
    a = np.asarray(a)
    v = a.astype(np.uint8) if a.dtype == bool else a
    return {"sha256": hashlib.sha256(np.ascontiguousarray(v).tobytes())
            .hexdigest(), "dtype": str(a.dtype), "shape": list(a.shape)}


def state_arrays(trainer) -> dict:
    """{dotted name: array} of a trainer's state as the JAX TrainState
    (Orbax's leaf names), the PRNG key left out: the port keeps none."""
    from nerf2mesh_tpu_torch.utils import orbax
    from nerf2mesh_tpu_torch.utils.convert import _RECORD_FIELDS, jax_state
    return {".".join(k for k, _ in keys): np.asarray(v)
            for keys, v in orbax.flatten(jax_state(trainer._payload()),
                                         _RECORD_FIELDS)
            if v is not orbax.MASKED and keys[0][0] != "key"}


def dir_mib(path) -> float:
    if os.path.isfile(path):
        return os.path.getsize(path) / 2 ** 20
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 2 ** 20


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stage1_ocp_round_trip(dev, t1, ds, val, ws):
    """Phase 14 (d), run in phase 8 on its stage-1 state: its .ocp, and a
    fresh stage-1 Trainer on the same mesh loaded from it."""
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    t1.cfg = dataclasses.replace(t1.cfg, ckpt_backend="orbax")
    psnr = float(t1.evaluate(val, name="s1_ocp_live",
                             track_best=False)["PSNR"])
    path, t_save = timed(t1.save_checkpoint)
    fresh = Trainer(t1.cfg, device=dev, workspace=ws)
    fresh.setup_stage1(ds)
    ok, t_load = timed(lambda: fresh.load_checkpoint(path))
    if not ok or fresh.step != t1.step:
        raise AssertionError(f"stage-1 .ocp: loaded {ok}, step "
                             f"{fresh.step} != {t1.step}")
    if (fresh._s1_real_shape != t1._s1_real_shape or not torch.equal(
            fresh.vertices_offsets, t1.vertices_offsets)):
        raise AssertionError(f"stage-1 .ocp: topology {fresh._s1_real_shape}"
                             f" vs {t1._s1_real_shape}, or offsets differ")
    got = float(fresh.evaluate(val, name="s1_ocp_reload",
                               track_best=False)["PSNR"])
    log(f"[ckpt] (d) stage-1 .ocp of phase 8's state ({dir_mib(path):.1f} "
        f"MiB, topology {t1._s1_real_shape}): save {t_save:.3f} s, load "
        f"{t_load:.3f} s; val PSNR {got:.6f} reloaded vs {psnr:.6f}")
    if not abs(got - psnr) <= 1e-4:
        raise AssertionError(f"stage-1 .ocp reload PSNR {got} != {psnr}")


def ckpt_full_width(dev, field, val):
    """Phase 14 (a): the phase-4 field's .ocp against its pickle."""
    from nerf2mesh_tpu_torch.utils import zstd
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    zstd._load()                       # the codec's build is not timed
    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_ocp_")
    try:
        ocp_ws, pk_ws = os.path.join(tmp, "ocp"), os.path.join(tmp, "pickle")
        cfg = dataclasses.replace(field.cfg, ckpt_backend="orbax")
        field.cfg, field.workspace = cfg, ocp_ws
        psnr = float(field.evaluate(val, name="ocp_live",
                                    track_best=False)["PSNR"])
        live = state_arrays(field)
        path, t_save = timed(field.save_checkpoint)
        fresh = Trainer(cfg, device=dev, workspace=ocp_ws)
        ok, t_load = timed(lambda: fresh.load_checkpoint(path))
        got = state_arrays(fresh)
        bad = [k for k in live if not (got[k].dtype == live[k].dtype
                                       and np.array_equal(got[k], live[k]))]
        if not ok or bad or fresh.step != field.step or (
                fresh.ema_count != field.ema_count):
            raise AssertionError(f".ocp round trip: loaded {ok}, arrays "
                                 f"differ {bad}, step {fresh.step} vs "
                                 f"{field.step}")
        psnr_got = float(fresh.evaluate(val, name="ocp_reload",
                                        track_best=False)["PSNR"])
        del fresh
        pk = Trainer(dataclasses.replace(cfg, ckpt_backend="pickle"),
                     device=dev, workspace=ocp_ws)
        if not pk.load_checkpoint() or pk.step != field.step:
            raise AssertionError("a pickle-backend trainer did not find the "
                                 ".ocp")
        del pk
        field.cfg = dataclasses.replace(cfg, ckpt_backend="pickle")
        field.workspace = pk_ws
        ppath, t_psave = timed(field.save_checkpoint)
        fresh = Trainer(field.cfg, device=dev, workspace=pk_ws)
        ok, t_pload = timed(lambda: fresh.load_checkpoint(ppath))
        del fresh
        n = sum(v.size for k, v in live.items() if k.split(".")[0] in (
            "params", "ema_params", "opt_state"))
        log(f"[ckpt] (a) step {field.step}, {n} parameter, EMA and moment "
            f"values: .ocp {dir_mib(path):.2f} MiB, save {t_save:.3f} s, "
            f"load {t_load:.3f} s; pickle {dir_mib(ppath):.2f} MiB, save "
            f"{t_psave:.3f} s, load {t_pload:.3f} s (each save writes the "
            f"step's and the _latest copy); every array bit-equal; val PSNR "
            f"{psnr_got:.6f} reloaded vs {psnr:.6f}")
        if not abs(psnr_got - psnr) <= 1e-4:
            raise AssertionError(f".ocp reload PSNR {psnr_got} != {psnr}")
        if not (t_save <= 2 * t_psave and t_load <= 2 * t_pload):
            raise AssertionError(f".ocp walls (save {t_save}, load {t_load})"
                                 f" over 2x the pickle's ({t_psave}, "
                                 f"{t_pload})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ckpt_jax_fixture(dev, val):
    """Phase 14 (b): the committed JAX .ocp fixtures (zarr v2, and the same
    state through Orbax's zarr3 handler) into a Trainer on the card, every
    leaf's hash JAX's; then one val frame of the zarr3 one, which must
    launch K1 and K2.  Returns that frame's launches."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.config import Config
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_fix_")
    try:
        for name in ("jax_stage0", "jax_stage0_zarr3"):
            with open(os.path.join(FIXTURES, name + ".json")) as f:
                want = json.load(f)
            cfg = dataclasses.replace(Config(), workspace=tmp,
                                      **want["config"]).finalize()
            t = Trainer(cfg, device=dev)
            ok, secs = timed(lambda: t.load_checkpoint(
                os.path.join(FIXTURES, name + ".ocp")))
            got = state_arrays(t)
            bad = [k for k, h in want["leaves"].items()
                   if k != "key" and sha(got[k]) != h]
            log(f"[ckpt] (b) the JAX fixture {name}.ocp: loaded {ok} in "
                f"{secs:.3f} s at step {t.step}; {len(want['leaves']) - 1} "
                f"leaves hashed, differing {bad}")
            if not ok or bad or t.step != want["steps"]:
                raise AssertionError(f"JAX fixture {name}: {ok}, {bad}, "
                                     f"step {t.step}")
        torch.cuda.synchronize()
        kernels.reset_launches()
        img = t.render_image(val.poses[0], val.intrinsics_for(0), val.H,
                             val.W)["image"]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        img = np.asarray(img)
        psnr = float(-10 * np.log10(np.mean(
            (img - val.images[0][..., :3] / 255.0) ** 2)))
        log(f"[ckpt] (b) one {val.H}x{val.W} val frame of the zarr3 "
            f"fixture's field: PSNR {psnr:.4f} (3 steps of training); "
            f"launches {launches}")
        if img.shape != (val.H, val.W, 3) or not np.isfinite(img).all():
            raise AssertionError(f"zarr3 fixture frame: {img.shape}")
        for key in ("occ_lookup", "inwin_fwd"):
            if launches.get(key, 0) <= 0:
                raise AssertionError(f"zarr3 fixture frame: {key} was not "
                                     "launched")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# file signatures -> format, in data/png.read_image's order; TGA has none
SIGNATURES = ((b"\x89PNG", "png"), (b"\xff\xd8", "jpeg"), (b"BM", "bmp"),
              (b"II*\0", "tiff"), (b"MM\0*", "tiff"), (b"II+\0", "tiff"),
              (b"GIF8", "gif"), (b"RIFF", "webp"), (b"qoif", "qoi"),
              (b"\xff\x4f\xff\x51", "jpeg2000"),
              (b"\x00\x00\x00\x0cjP", "jpeg2000"), (b"P", "netpbm")) + tuple(
    (struct.pack("<I", n), "dib") for n in (12, 40, 52, 56, 64, 108, 124)
) + ((b"BLP1", "blp"), (b"BLP2", "blp"), (b"\x00\x00\x02\x00", "cur"),
     (b"\x0a", "pcx"), (b"\xb1\x68\xde\x3a", "dcx"), (b"DDS ", "dds"),
     (b"FTEX", "ftex"), (b"\x00\x00\x01\x00", "ico"), (b"8BPS", "psd"),
     (b"\x01\xda", "sgi"), (b"icns", "icns"), (b"Image type", "im"),
     (b"DanM", "msp"), (b"LinS", "msp"), (b"#define", "xbm"))
# the (k) capture's formats, tried first ("P7 332" is not netpbm); FLI and
# GBR are told by fixture_format
RARE_SIGNATURES = ((b"P7 332", "xvthumb"), (b"/* XPM */", "xpm"),
                   (b"SIMPLE", "fits"), (b"\0" * 7 + b"\x04", "mcidas"),
                   (b"\x59\xa6\x6a\x95", "sun"), (b"\x80\xe8\0\0", "pixar"),
                   (b"\x1c", "iptc"), (b"* IM tools", "imt"),
                   (b"width ", "imt"))
# TIFF compressions timed apart in phase 14 (c)
TIFF_CODECS = {2: "tiff_ccitt", 3: "tiff_ccitt", 4: "tiff_ccitt",
               32771: "tiff_ccitt", 6: "tiff_ojpeg", 32809: "tiff_thunderscan",
               34925: "tiff_lzma", 50000: "tiff_zstd"}


def tiff_compression(data: bytes) -> int:
    """The Compression tag of a TIFF's first IFD (1 when absent)."""
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    (ifd,) = struct.unpack_from(bo + ("Q" if big else "I"), data,
                                8 if big else 4)
    (n,) = struct.unpack_from(bo + ("Q" if big else "H"), data, ifd)
    first, step = ifd + (8 if big else 2), 20 if big else 12
    for i in range(n):
        if struct.unpack_from(bo + "H", data, first + step * i)[0] == 259:
            return struct.unpack_from(bo + "H", data, first + step * i + 4 +
                                      (8 if big else 4))[0]
    return 1


def dds_codec(data: bytes) -> str:
    """A DDS file's format for phase 14 (c)'s rates: its BCn codec, "rgb"
    for masked RGB pixels, "raw" for bytes as stored."""
    from nerf2mesh_tpu_torch.data import dds
    n = dds.pixel_format(data)[0]
    return ("dds_" + dds.CODEC_NAMES[n] if n > 0 else
            "dds_rgb" if n == dds.RGB_MASKS else "dds_raw")


def fixture_format(rel: str, data: bytes) -> str:
    """A committed image's format for phase 14 (c)'s rates: a variant's
    directory under formats/ (uncompressed TGA shares CUR's first bytes),
    else its signature (a .spi frame is SPIDER); TIFF by its codec, DDS by
    its BCn codec."""
    parts = rel.split("/")
    if parts[0] == "formats" and len(parts) > 2:
        fmt = parts[1]
        if fmt == "pcx" and data[:4] == b"\xb1\x68\xde\x3a":
            fmt = "dcx"
        elif fmt == "ico" and data[:4] == b"\x00\x00\x02\x00":
            fmt = "cur"
    elif rel.endswith(".spi"):                # SPIDER has no signature
        fmt = "spider"
    elif data[4:6] in (b"\x11\xaf", b"\x12\xaf"):
        fmt = "fli"
    elif data[20:24] == b"GIMP":
        fmt = "gbr"
    else:
        fmt = next((n for sig, n in RARE_SIGNATURES + SIGNATURES
                    if data.startswith(sig)), "tga")
    if fmt == "tiff":
        fmt = TIFF_CODECS.get(tiff_compression(data), "tiff")
    elif fmt == "dds":
        fmt = dds_codec(data)
    return fmt


def decode_fixtures():
    """Phase 14 (c): the committed images decoded on the host, each array's
    hash Pillow's; the progressive JPEGs and each format's ms per MP held
    to the 500 ms bar, in the fastest of DECODE_PASSES passes over its
    files: the files are small, so a pass's time is mostly each call's
    fixed cost, which the host's other load moves by 2x between runs.
    read_image is timed on the path as a user calls it; its file read
    (png.read_bytes: open, fstat, read) is timed inside the same calls, so
    the log gives each format's read and decode (the rest) apart from the
    same fastest pass."""
    from nerf2mesh_tpu_torch.data import png
    from nerf2mesh_tpu_torch.data.png import read_image
    capture = os.path.join(FIXTURES, "progressive")
    kinds = (("progressive", capture), ("png", os.path.join(FIXTURES, "png")),
             ("formats", FIXTURES))
    real_read, reads = png.read_bytes, [0.0]

    def timed_read(path):
        t0 = time.perf_counter()
        data = real_read(path)
        reads[0] += time.perf_counter() - t0
        return data

    png.read_bytes = timed_read
    try:
        for kind, root in kinds:
            with open(os.path.join(FIXTURES, f"{kind}.json")) as f:
                want = json.load(f)
            by_format = {}
            for rel in want:
                with open(os.path.join(root, rel), "rb") as f:
                    by_format.setdefault(fixture_format(rel, f.read()),
                                         []).append(rel)
            for rels in by_format.values():  # builds each decoder untimed
                read_image(os.path.join(root, rels[0]))
            bad, rates, first, largest, split = [], {}, {}, {}, {}
            for fmt, rels in sorted(by_format.items()):
                passes, best, pixels = [], {}, {}
                for rep in range(DECODE_PASSES):
                    secs, px, reads[0] = 0.0, 0, 0.0
                    for rel in rels:
                        t0 = time.perf_counter()
                        img = read_image(os.path.join(root, rel))
                        dt = time.perf_counter() - t0
                        secs += dt
                        pixels[rel] = img.shape[0] * img.shape[1]
                        px += pixels[rel]
                        best[rel] = min(best.get(rel, math.inf), dt * 1e3)
                        if rep == 0 and sha(img) != want[rel]:
                            bad.append(rel)
                    passes.append((secs / (px / 1e6) * 1e3, secs, reads[0]))
                rate, secs, rd = min(passes)
                rates[fmt] = (len(rels), px, rate)
                first[fmt] = passes[0][0]
                # per file: read us, decode us; and their ms per MP
                split[fmt] = (round(rd / len(rels) * 1e6, 1),
                              round((secs - rd) / len(rels) * 1e6, 1),
                              round(rd / (px / 1e6) * 1e3, 2),
                              round((secs - rd) / (px / 1e6) * 1e3, 2))
                rel = max(rels, key=pixels.get)
                largest[fmt] = (rel, pixels[rel], round(best[rel], 3),
                                round(best[rel] / (pixels[rel] / 1e6), 2))
            log(f"[ckpt] (c) {len(want)} {kind} files decoded, differing "
                f"from Pillow's hashes: {bad}; per format (files, pixels, ms "
                f"per MP of the fastest of {DECODE_PASSES} passes against "
                f"the 500 ms bar): {rates}; the first pass's ms per MP "
                f"{first}; the fastest pass apart (read us a file, decode "
                f"us a file, read ms per MP, decode ms per MP): {split}; "
                f"each format's largest file (pixels, its fastest ms, ms per "
                f"MP): {largest}")
            slow = {f: r for f, r in rates.items() if r[2] > 500 and (
                kind == "formats" or f == "jpeg")}
            if bad or slow:
                raise AssertionError(f"{kind} decode: {bad}, over the bar "
                                     f"{slow}")
    finally:
        png.read_bytes = real_read


def ckpt_capture(dev, ref_ms):
    """Phase 14 (c): the committed images decoded, then the progressive
    capture through main with --ckpt_backend orbax, --test and a reload;
    returns the training's launches and K1-K3's errors at one step."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.config import parse_args
    from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
    from nerf2mesh_tpu_torch.main import main as cli_main
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    capture = os.path.join(FIXTURES, "progressive")
    decode_fixtures()
    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_cap_")
    try:
        ws = os.path.join(tmp, "ws")
        argv = cli_argv(capture, ws, iters=CKPT_STEPS, n_eval=1, n_ckpt=2,
                        ckpt_backend="orbax", test_no_mesh=True)
        cfg = parse_args(argv)
        launches = {}
        real = counting(Trainer, "train", launches)
        kernels.reset_launches()
        try:
            trainer, t_main = timed(lambda: cli_main(argv, device=dev))
        finally:
            Trainer.train = real
        losses = [e["loss"] for e in trainer.train_log]
        cdir = os.path.join(ws, "checkpoints")
        names = sorted(os.listdir(cdir))
        log(f"[ckpt] (c) main {' '.join(argv[1:])}: {t_main:.1f} s; logged "
            f"losses {np.round(losses, 5).tolist()}; evals "
            f"{trainer.stats['results']}; checkpoints {names}; training "
            f"launches {launches}")
        if not losses or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"capture losses: {losses}")
        for key in ("occ_lookup", "inwin_fwd", "inwin_bwd"):
            if launches.get(key, 0) <= 0:
                raise AssertionError(f"{key} was not launched by training")
        steps = [n for n in names if n.endswith(".ocp") and n[11:18].isdigit()]
        if len(steps) != 2 or not all(
                os.path.isdir(os.path.join(cdir, n)) for n in names):
            raise AssertionError(f"rolling window: {names}")
        with open(os.path.join(cdir, "ngp_stage0_latest.ocp",
                               "n2m_meta.json")) as f:
            saved = float(json.load(f)["stats"]["results"][0]["PSNR"])
        tester = cli_main(argv + ["--test"], device=dev)
        if tester.step != CKPT_STEPS:
            raise AssertionError(f"--test: step {tester.step}")
        fresh = Trainer(cfg, device=dev)
        if not fresh.load_checkpoint():
            raise AssertionError("no .ocp to load")
        val = load_nerf_dataset(cfg, "val")
        got = float(fresh.evaluate(val, name="reload",
                                   track_best=False)["PSNR"])
        log(f"[ckpt] (c) --test reloaded step {tester.step}; a fresh "
            f"Trainer's val PSNR {got:.6f} vs {saved:.6f} recorded")
        if not abs(got - saved) <= 1e-4:
            raise AssertionError(f"reloaded PSNR {got} != {saved}")
        errs = hold_step_kernels(fresh, load_nerf_dataset(cfg, "train"),
                                 "progressive capture step", ref_ms,
                                 "[ckpt] (c)")
        return launches, errs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ckpt_formats_capture(dev, ref_ms, name="colmap_formats", label="(e)",
                         masks="TIFF masks"):
    """Phase 14 (e): main on the committed COLMAP capture whose frames are
    TIFF (LZW), lossy and lossless WebP and BMP, with TIFF masks, at the
    bench's block512 C = 3 field: FMT_STEPS steps, every logged loss
    finite, K1-K3 launched by the training; --test; the val PSNR finite;
    K1-K3 held to their plain versions at one more step.  (f) is the same
    on fixtures/colmap_forms (name, label and masks name it).  Returns (the
    training's launches, K1-K3's max|err|)."""
    from nerf2mesh_tpu_torch import kernels
    from nerf2mesh_tpu_torch.config import parse_args
    from nerf2mesh_tpu_torch.data.colmap import load_colmap_dataset
    from nerf2mesh_tpu_torch.main import main as cli_main
    from nerf2mesh_tpu_torch.utils.trainer import Trainer
    capture = os.path.join(FIXTURES, name)
    tmp = tempfile.mkdtemp(prefix="n2m_chip_smoke_fmt_")
    try:
        ws = os.path.join(tmp, "ws")
        argv = cli_argv(capture, ws, data_format="colmap", scale=-1.0,
                        bound=4.0, enable_cam_near_far=True, iters=FMT_STEPS,
                        n_eval=1, n_ckpt=1, test_no_mesh=True,
                        test_no_video=True)
        cfg = parse_args(argv)
        launches = {}
        real = counting(Trainer, "train", launches)
        kernels.reset_launches()
        try:
            trainer, t_main = timed(lambda: cli_main(argv, device=dev))
        finally:
            Trainer.train = real
        losses = [e["loss"] for e in trainer.train_log]
        names = sorted(os.listdir(os.path.join(capture, "images")))
        log(f"[ckpt] {label} main {' '.join(argv[1:])}: {t_main:.1f} s on "
            f"{len(names)} frames ({sorted({n.rsplit('.', 1)[1] for n in names})}"
            f", {masks}); logged losses {np.round(losses, 5).tolist()}; "
            f"evals {trainer.stats['results']}; training launches {launches}")
        if not losses or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"formats capture losses: {losses}")
        for key in ("occ_lookup", "inwin_fwd", "inwin_bwd"):
            if launches.get(key, 0) <= 0:
                raise AssertionError(f"{key} was not launched by training")
        train = load_colmap_dataset(cfg, "train")
        if train.images.shape[-1] != 4:
            raise AssertionError("formats capture: the masks were not read")
        tester = cli_main(argv + ["--test"], device=dev)
        if tester.step != FMT_STEPS:
            raise AssertionError(f"--test: step {tester.step}")
        run_eval(trainer, load_colmap_dataset(cfg, "val"),
                 f"{name} capture", ("occ_lookup", "inwin_fwd"))
        errs = hold_step_kernels(trainer, train, f"{name} capture step",
                                 ref_ms, f"[ckpt] {label}")
        return launches, errs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_checkpoints(dev, field, val, ref_ms):
    """Phase 14: (a) the full-width .ocp round trip, (b) the JAX fixtures
    (zarr v2 and v3) and a frame of the zarr3 one, (c) the committed images
    and the progressive capture through main, (e)-(k) the captures in other
    formats (g: JPEG 2000, h: the legacy forms, i: the texture and layered
    forms, j: ICNS, IM, SPIDER, MSP and XBM, k: SUN, PIXAR, GBR, XPM, IPTC,
    McIdas, IMT, FITS, XV thumbnails and FLI) through main ((d) runs in
    phase 8); returns (b)'s frame launches, (c)'s, (e)'s, (f)'s, (g)'s,
    (h)'s, (i)'s, (j)'s and (k)'s training launches, and K1-K3's
    errors."""
    t0 = time.perf_counter()
    ckpt_full_width(dev, field, val)
    fixture_launches = ckpt_jax_fixture(dev, val)
    cap_launches, errs = ckpt_capture(dev, ref_ms)
    t_e = time.perf_counter()
    fmt_launches, fmt_errs = ckpt_formats_capture(dev, ref_ms)
    log(f"[ckpt] (e) wall {time.perf_counter() - t_e:.1f} s")
    t_f = time.perf_counter()
    forms_launches, forms_errs = ckpt_formats_capture(
        dev, ref_ms, "colmap_forms", "(f)", "PGM and QOI masks")
    log(f"[ckpt] (f) wall {time.perf_counter() - t_f:.1f} s")
    t_g = time.perf_counter()
    jp2_launches, jp2_errs = ckpt_formats_capture(
        dev, ref_ms, "colmap_jp2", "(g)", "JPEG 2000 masks")
    log(f"[ckpt] (g) wall {time.perf_counter() - t_g:.1f} s")
    t_h = time.perf_counter()
    legacy_launches, legacy_errs = ckpt_formats_capture(
        dev, ref_ms, "colmap_legacy", "(h)",
        "SGI, PCX, LZMA TIFF and Group 4 masks")
    log(f"[ckpt] (h) wall {time.perf_counter() - t_h:.1f} s")
    t_i = time.perf_counter()
    texture_launches, texture_errs = ckpt_formats_capture(
        dev, ref_ms, "colmap_textures", "(i)",
        "PSD grey, DDS L, DDS BC4 and PSD bitmap masks")
    log(f"[ckpt] (i) wall {time.perf_counter() - t_i:.1f} s")
    t_j = time.perf_counter()
    misc_launches, misc_errs = ckpt_formats_capture(
        dev, ref_ms, "colmap_misc", "(j)", "MSP and XBM masks")
    log(f"[ckpt] (j) wall {time.perf_counter() - t_j:.1f} s")
    t_k = time.perf_counter()
    rare_launches, rare_errs = ckpt_formats_capture(
        dev, ref_ms, "colmap_rare", "(k)",
        "McIdas, IMT, FITS, XV thumbnail, FLI and XPM masks")
    log(f"[ckpt] (k) wall {time.perf_counter() - t_k:.1f} s")
    log(f"[ckpt] phase 14 wall {time.perf_counter() - t0:.1f} s")
    for e in (fmt_errs, forms_errs, jp2_errs, legacy_errs, texture_errs,
              misc_errs, rare_errs):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
    return (fixture_launches, cap_launches, fmt_launches, forms_launches,
            jp2_launches, legacy_launches, texture_launches, misc_launches,
            rare_launches, errs)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    card, name = phase_device()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def lap(label):
        log(f"[time] {label} done at {time.perf_counter() - t_start:.1f} s")

    phase_build()
    results = phase_kernels(dev)
    lap("phases 2-3")
    launches, field, ds, val = phase_slice(dev)
    ws_launches = phase_winsort(dev)
    lap("phases 4-6")
    with no_modules():
        cli_launches = phase_cli(dev)
        lap("phase 7")
        s1_launches, s1_errs, s1_trainer = phase_stage1(dev, field, ds, val)
    lap("phase 8")
    sdf_launches, sdf_errs = phase_sdf(dev)
    lap("phase 9")
    with no_modules():
        unb_launches, unb_s1_launches, unb_errs = phase_unbounded(
            dev, {r["name"]: r["ms"] for r in results})
    lap("phase 10")
    with no_modules("PIL", "cv2", "sklearn"):
        cap_launches, cap_s1_launches, cap_errs = phase_captures(
            dev, {r["name"]: r["ms"] for r in results})
    lap("phase 11")
    hard_launches, hard_errs = phase_hard(dev)
    lap("phase 12")
    with no_modules("PIL", "cv2", "sklearn"):
        (dtu_launches, dist_launches, viewer_launches,
         entry_errs) = phase_entry_points(dev, field, ds, val, s1_trainer)
    del s1_trainer
    lap("phase 13")
    with no_modules("PIL", "cv2", "sklearn", "orbax", "tensorstore",
                    "zstandard"):
        (fix_launches, ckpt_launches, fmt_launches, forms_launches,
         jp2_launches, legacy_launches, texture_launches, misc_launches,
         rare_launches, ckpt_errs) = phase_checkpoints(
            dev, field, val, {r["name"]: r["ms"] for r in results})
    del field
    lap("phase 14")
    for r in results:
        # the largest error over phase 3 and the paths' own shapes
        r["max_abs_err"] = max([r["max_abs_err"]] + [
            e[r["name"]] for e in (s1_errs, sdf_errs, unb_errs, cap_errs,
                                   hard_errs, entry_errs, ckpt_errs)
            if r["name"] in e])
        # the C = 1 and 2 instantiations' path is phase 12's run that
        # reaches them
        path = ((hard_launches["winsort"] if r["name"].startswith("winsort")
                 else hard_launches["ref"] if r["name"].startswith("sweep")
                 else hard_launches["separate"])
                if r["name"][-3:] in ("_c1", "_c2") else
                ws_launches if r["name"].startswith("winsort") else
                cli_launches if r["name"].startswith("sweep") else launches)
        r["launches"] = path[r["name"]]
        r["stage1_launches"] = (cli_launches["stage1_" + r["name"]]
                                if r["name"].startswith("sweep") else
                                s1_launches.get(r["name"], 0))
        r["sdf_launches"] = sdf_launches.get(r["name"], 0)
        r["sdf_stage1_launches"] = sdf_launches.get("stage1_" + r["name"], 0)
        r["unbounded_launches"] = {k: v.get(r["name"], 0)
                                   for k, v in unb_launches.items()}
        r["unbounded_stage1_launches"] = {k: v.get(r["name"], 0)
                                          for k, v in unb_s1_launches.items()}
        r["captures_launches"] = {k: v.get(r["name"], 0)
                                  for k, v in cap_launches.items()}
        r["captures_stage1_launches"] = {k: v.get(r["name"], 0)
                                         for k, v in cap_s1_launches.items()}
        r["hard_launches"] = {k: v.get(r["name"], 0)
                              for k, v in hard_launches.items()}
        r["dtu_launches"] = dtu_launches.get(r["name"], 0)
        r["dist_launches"] = {k: v.get(r["name"], 0)
                              for k, v in dist_launches.items()}
        r["viewer_launches"] = viewer_launches.get(r["name"], 0)
        r["ckpt_cli_launches"] = ckpt_launches.get(r["name"], 0)
        r["ckpt_zarr3_frame_launches"] = fix_launches.get(r["name"], 0)
        r["ckpt_formats_cli_launches"] = fmt_launches.get(r["name"], 0)
        r["ckpt_forms_cli_launches"] = forms_launches.get(r["name"], 0)
        r["ckpt_jp2_cli_launches"] = jp2_launches.get(r["name"], 0)
        r["ckpt_legacy_cli_launches"] = legacy_launches.get(r["name"], 0)
        r["ckpt_texture_cli_launches"] = texture_launches.get(r["name"], 0)
        r["ckpt_misc_cli_launches"] = misc_launches.get(r["name"], 0)
        r["ckpt_rare_cli_launches"] = rare_launches.get(r["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches",
            "stage1_launches", "sdf_launches", "sdf_stage1_launches",
            "unbounded_launches", "unbounded_stage1_launches",
            "captures_launches", "captures_stage1_launches", "hard_launches",
            "dtu_launches", "dist_launches", "viewer_launches",
            "ckpt_cli_launches", "ckpt_zarr3_frame_launches",
            "ckpt_formats_cli_launches", "ckpt_forms_cli_launches",
            "ckpt_jp2_cli_launches", "ckpt_legacy_cli_launches",
            "ckpt_texture_cli_launches", "ckpt_misc_cli_launches",
            "ckpt_rare_cli_launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
