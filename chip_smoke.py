#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

The main path is SwinIR-M ×4 classical-SR inference (embed 180, depths
6×6, 6 heads, window 8, MLP ratio 2, pixelshuffle head, bf16) through the
port's two hand-written kernels: the fused Swin block and the fused
conv3x3 + residual tail; then training, then the rest of SwinIR's
inference routes: JPEG-CAR at window 7 (the window-block kernel), the
unfused route (the window-attention kernel) and SwinIR-L; then VRT video
SR through the TMSA mutual block, self block and DCNv2 kernels; then RVRT
video SR through the STL2 block, the 2-D Swin block and the guided
deformable attention kernels; then VRT-001 training with its alignment
sampled by the bilinear sampler's forward and backward kernels; then the
CNN zoo's inference (cuDNN and cuFFT, no hand-written kernel on its path)
and the port's timing CLIs; then training the CNN zoo and SwinIR's gray
denoising recipe from their option files; then RVRT-001 training through
the STL2, GDA and 2-D Swin block kernels; then SwinIR-L x4 GAN training on
the Swin-block kernels at C=240; then the face pipeline (GPEN,
RetinaFace, cv2-free alignment); then the SPECT fork (SPECT SwinIR through
cli/train_spect on the Swin-block kernels, DRUNet and RRDBNet-noUp in f32);
then scale-out and the native loader (data-parallel ranks, NCCL, tiled
inference, the profiler trace, cli.train on the native loader).
Phases, one flushed line each with its seconds:

  0 device      card name, power limit (nvidia-smi), torch and CUDA versions
  1 build       the kernels, from csrc/, one nvcc process per source, all
                at once, then one link (each one's seconds); each wrapper's
                layout mirror against its kernel's (the conv tail, the Swin
                block, its attention-only mode (kernel B: the plan at hidden
                width 0) and its backward, the window blocks'
                kair_win3d_plan at C=96, 120, 180 and RVRT's 144 and 192,
                the DCN kernel's kair_dcn_plan, the GDA kernel's
                kair_gda_plan); the window blocks', the DCN and the GDA
                kernels' registers and spills
  2 swin_block  kernel (wgmma, a bulk-copied weight ring two windows share)
                against its plain version at B=16, 128x128, C=180, at the
                main path's 1x64x72, on 1x56x72 (63 windows: the persistent
                walk's ragged end), and at SwinIR-L's width (B=4, 128x128,
                C=240, 8 heads, hidden 480), shifted and not, with the
                dropped-mask control
  3 conv3x3     the conv kernel (wgmma, weights staged by bulk copies) against
                its plain version at SwinIR-M's B=16 128x128 C=180 (phases 0
                and 4), the main path's LR 1x64x72, JPEG-CAR's 8x126x126 and
                C=60, with a wrong-phase control; at the SwinIR-M and JPEG-CAR
                shapes its ms and TFLOP/s beside F.conv2d + add and the bound
  4 main_path   a seeded KAIR-keyed state dict → .pth → cli.test.build_preset
                → test_pad → model on the card, for a 256x256 and a 256x280
                HR image (LR 64x64, and 64x70 padded to 64x72); kernel launch
                counts; output against the same weights run in f32 on the
                CPU, with a control that the comparison sees a dropped mask
  5 throughput  batch 16 of 128x128 LR: ms per forward, LR MP/s, MFU
  6 swin_bwd    the block backward kernel (wgmma, a bulk-copied weight
                ring two windows share, then a wgmma weight-grad pass)
                against its plain version at the training shape B=32, 48x48,
                C=180 (unshifted, with the mask), 1x48x56 (with the mask),
                the block's shift folded in (phase 4, control: the plain
                version at phase 5) and SwinIR-L's width (B=8 64x64, C=240,
                8 heads, hidden 480, phase 4): dx and the 13 parameter
                grads, with dropped-mask controls; two launches bit-equal;
                its time, bound, TFLOP/s, the plain version's and the
                forward kernel's times, and each pass's device time
  7 train       SwinIR-M x4 training from the shipped option file
                (options/swinir/train_swinir_sr_classical_x4.json) through
                config.parse → cli.train.build_trainer, bf16, batches of 32
                from the port's native loader (the file's use_native_loader,
                through make_train_loader) over seeded smooth PNGs: (a) one
                gradient on the card against the f32 CPU run on the same
                weights and a B=2 batch, with a dropped-mask control; (b) 2
                warm-up and 8 timed steps, 36 forward and 36 backward block
                launches per step and no conv kernel; (c) save, then resume
                in a fresh trainer with equal G, E and optimizer state; (d)
                device time per step by kernel, from torch.profiler, and
                the torch.roll calls a step
  8 swin_win    the window-block kernel (windows up to 8, padded to 64 rows)
                against its plain version: window 7 at B=8, 126x126, C=180,
                shifted (phase 3) and not; window 4 on 1x12x20, window 7 on
                1x21x35 and 1x49x63 (odd window counts, 63 the ragged end of
                a walk); dropped-mask control; time and bound
  9 window_msa  the window-attention kernel (the wgmma block's attention-only
                mode) against the composed window_msa at B=16, 128x128,
                C=180, with and without the mask and the qkv bias, at
                SwinIR-L's C=240, at window 7 (B=8 126x126, shifted and
                not) and at C=60; the same control; time and bound
 10 jpeg_car    KAIR's 006 JPEG-CAR SwinIR-M (color, window 7, img_range 255)
                from an option tree through define_g: B=8 of 126x126 on the
                card, 36 window-block and 7 conv launches, no composed
                block; image 0 against the f32 CPU run (also in gray
                levels) with the dropped-mask control; ms, LR MP/s, MFU;
                device time per forward by kernel, from torch.profiler
 11 unfused     SwinIR-M x4 through cli.test.build_preset with fuse off:
                36 window-attention launches per B=16 128x128 forward;
                against the fused forward and the f32 CPU run; its time
 12 swinir_l    KAIR's real-world SwinIR-L x4 (embed 240, depths 9x6, 8
                heads, 3conv, nearest+conv): 54 block launches per B=4
                128x128 forward; a 64x64 image against the f32 CPU run,
                the error after each stage and with the 3conv tails and the
                head's convs in f32; its time
 13 tmsa        the TMSA mutual block kernel (wgmma) against its plain
                version at VRT-001's stage 1 (1x6x64x64, C=120, 6 heads)
                unshifted and shifted (1,4,4), at stage 4 (1x6x8x8, shift
                (1,0,0)), on 1x4x40x72 (odd window counts) and at the
                training step's B=8 stage 1 (8x6x64x64); dropped-mask
                control; at B=1 and B=8 its time, TFLOP/s, bound and each
                pass's device time; the plain version's time
 14 self6       the self block kernel (wgmma): wd 6 at C=120 and C=180, wd 1
                at C=180, wd 2 on a 1x2x64x64 clip, shifted (0,4,4) and not,
                and the training step's B=8 calls (8x6x64x64, wd 6, C=120
                and C=180); the same control and timings
 15 dcn         the DCNv2 kernel (wgmma) against the composed gather route:
                VRT-001's call (120 -> 120, 12 groups, cg 10) at its four map
                sizes at N=1 (64x64 to 8x8: the tiles' groups split over
                blocks) and stage 1 at B=8, cg 15 (Cin 240 dg 16; Cin 360 dg
                24), cg 6 (Cin 96 dg 16) and an odd 1x20x28 (cg 8, Cout 72),
                offsets with taps outside the frame and fractional; control:
                the offsets dropped; times at the four sizes and at B=8, and
                the 70 calls of a VRT-001 clip from them
 16 vrt         KAIR's 001_VRT_videosr_bi_REDS_6frames from a seeded .pth
                through cli.test_video.build_task on a 1x6x64x64 clip: 42
                TMSA, 38 self and 70 DCN launches, no composed call; against
                the f32 CPU run (and out - base against its own max), the
                error after each stage, the dropped-mask control; ms per
                clip, frame-MP/s, MFU, device time by kernel and of the
                window-block passes
 17 stl2        the RVRT STL2 block (the wgmma passes' plain-MLP kind)
                against its plain version at
                RVRT-001's call (1x2x64x64, C=144, shift (0,4,4) and none),
                on 1x4x32x48 shift (1,4,4) and at C=192; the (1,8,8) block
                through the 2-D Swin kernel with its 3-D table (1x8x64x64);
                dropped-mask controls; time, bound and plain time
 18 gda         the GDA kernel (8 channels a thread, pixel tiles of one
                group a block) against the f32 gather route at RVRT-001's
                call (q 2x64x64x288, un-rotated K/V, 12 heads = groups)
                with offsets uniform over ±12 px (taps outside the frame
                and fractional) and flow-like (a smooth flow of up to ±8
                px plus ±1 px), at cg 32 (q
                2x64x64x384) and at the CLI tile's call (q 2x128x128x288),
                then at small sizes its other paths (1x3 taps; 4, 2 and 1
                channels a thread); control: the offsets dropped; the RVRT
                cases' device time (torch.profiler) and CUDA-event time
                beside their bound; the plain version's time
 19 rvrt        KAIR's 001_RVRT_videosr_bi_REDS_30frames from a seeded .pth
                through cli.test_video.build_task on a 1x8x64x64 clip: 4
                Swin-block, 64 STL2 and 12 GDA launches, no composed call;
                against the f32 CPU run (and out - base), the error after
                each branch, the dropped-mask control; ms per clip,
                frame-MP/s, MFU, device and host time by kernel (the STL2
                passes' and the GDA kernel's summed); one 1x16x128x128 tile
                (the CLI's default spatial tile): its GDA launches and time
 20 bilin       the bilinear sampler's forward and backward kernels against
                their plain version (f32 on the card) at VRT-001's stage-1
                call at batch 8 (G=96, 64x64, Cs=10, R=36,864; coordinates
                random over the frame, and VRT's own tap-major rows: pixel
                + 3x3 tap + an offset of up to 10 px), an RVRT GDA call
                (Cs=48) and an odd Cs=3 (the narrowest vectors), feat bf16
                and f32, taps fractional, in the zero ring, far outside and
                on integers (dfy, dfx exactly 0 there); control: coordinates
                moved by 0.37 px; times (the backward's whole call), bounds,
                the plain version's and F.grid_sample's forward and backward
 21 vrt_train   VRT-001 training from the shipped option file
                (options/vrt/001_train_vrt_videosr_bi_reds_6frames.json)
                through config.parse -> cli.train.build_trainer ->
                VideoTrainer, bf16, deform_impl "mxu", batches of 8 from the
                port's Loader over seeded moving 6-frame clips: (a) one
                gradient at B=1 against the f32 composed route on the card
                (over all, per part, the flow group), with a dropped-mask
                control; (b) 84 TMSA, 76 self, 70 + 70 bilinear launches per
                step (remat recomputes the blocks), no DCN launch, no composed
                call; (c) 2 warm-up and 3 timed steps: ms per step, clips/s,
                LR frame-MP/s, MFU, peak memory; (d) spynet and pa_deform
                bit-equal before fix_iter, the rest moved; (f) device time per
                step by kernel, of the window-block passes and of the
                sampler's kernels; (g) save and
                resume; (e) the option file's
                "auto" route (DCN kernel, composed backward) on the same
                batches
 22 cnn_zoo     the CNN zoo at full width, seeded weights (zoo_state_dict):
                DnCNN-17 gray, DnCNN-20 color blind, IRCNN color, FFDNet gray
                64/15 and color 96/12, SRMD 128/12, MSRResNet0 64/16, RRDB
                64/23 gc 32, IMDN 64/8, DRUNet color 64-512/4 and USRNet
                (8 iterations, h_nc 64, 64-512) through cli.test.build_preset
                from a .pth; DPSR 96/16, MSRResNet1 64/16 (options/
                train_msrresnet_psnr.json) and RRDBNet 64/23/32 through
                define_g; bf16 on the card against f32 on the CPU (64x64
                images for the denoisers, 32x32 LR for the SR models, 16x16
                LR for USRNet) within 2e-2 of max|ref|, no hand-written kernel
                launched; controls: σ 50 for 25 (FFDNet, DRUNet, SRMD),
                another kernel's PCA map (SRMD), kernels_12[11] transposed
                (USRNet), the weights of seed + 1 (the others); ms, MP/s,
                TFLOP/s and a device profile at 1x512x512 (denoisers),
                1x256x256 LR (x4 SR) and 1x128x128 LR (USRNet)
 23 timing_clis cli/challenge (MSRResNet0, 256x256), cli/video_bench --net
                vrt and --net rvrt, cli/bench (SwinIR-M x4, B=16 of
                128x128), then video_bench --net rvrt --compare --profile and
                bench --batch 1 --profile: each one's JSON lines, value > 0,
                mfu not null, a profile with device time
 24 train_zoo   (a) options/train_dncnn.json, train_ffdnet.json (plain2),
                train_msrresnet_psnr.json and train_usrnet.json (plain4)
                through config.parse -> cli.train.build_trainer at full
                width and the option's batch, f32 (cuDNN and cuFFT, TF32
                off), batches from the port's Loader over seeded smooth
                images (the datasets' read hooks: the card has no cv2): the
                gradient at B=2 against the f32 CPU run (relative norm
                <= 1e-4), with a control above the limit (the weights of
                seed + 1, FFDNet's σ map moved, USRNet's kernels
                transposed); USRNet's batches one scale factor each, two
                or more over the run; 1 warm-up and 3 timed steps, ms per
                step, device time and idle share from two profiled steps;
                (b) options/swinir/train_swinir_denoising_gray.json, bf16,
                B=8 of 128x128 gray, use_checkpoint: the gradient on a
                2x64x64 crop against the f32 CPU run (relative norm
                <= 8e-3 over all parameters, from this recipe's readings;
                phase 7's 0.1 per block parameter) with the dropped-mask
                control above both; 72 swin_block_2d (36 and 36
                recomputed), 36 backward and 0 conv-tail launches a step, no
                composed block; ms per step, busy ms and idle share; the
                block backward at B=2 128x128 against its plain version
 25 rvrt_train  RVRT-001's network (fuse_block on, deform_impl "auto") with
                the training fields of VRT-001's option file, bf16 autocast,
                B=4 clips of 8 frames at 64x64 LR (KAIR trains 30-frame
                clips; the clip is cut) from seeded moving clips: (a) the
                gradient at B=1 of 4 frames against the f32 composed route
                on the card (fuse_block off, gather), relative norm <= 2e-2
                over all and over the flow group, <= 4e-2 a part, with the
                GDA offsets at zero as the control above both over the flow
                group; (b) the block backward at C=144 (6 heads, hidden
                288), B=8 64x64, phases 0 and 4, within 2e-2 per tensor of
                its plain version; (c) 64 STL2, 12 GDA, 4 + 4 Swin block
                forward and backward launches a step, no composed call; (d)
                ms per step over 3 after 1, MFU from the analytic FLOP, peak
                memory, busy ms and idle share from two profiled steps, a
                remat step's launches (128 STL2, 8 Swin forward); (e) --dtype
                f32 refused naming the kernel
 26 gan_train SwinIR-L x4 (embed 240, depths 9x6, 8 heads, 3conv,
                nearest+conv) trained as a GAN against discriminator_unet
                (base 64, spectral norm) with the training fields of
                options/train_msrresnet_gan.json (l1 x1e-2, VGG19 layer 34
                x1 from a seeded torchvision-keyed .pth, ragan x5e-3, E_decay
                0.999, Adam 1e-4), bf16, B=16 of 256x256 HR on the 'sr'
                dataset over seeded images: (a) the gradient at B=1 against
                the f32 composed route on the card (the blocks' plain
                version), for the l1 pixel loss alone (<= 1e-2 over all,
                3e-2 the 54 blocks, 5e-2 a part; control: the shift mask
                dropped, above the blocks' limit) and for the whole step
                (G <= 4e-2 over all and 1e-1 a part, D <= 1e-1; controls:
                VGG's input norm off, D's fake batch the real one); (b) 54
                row-1 and 54 row-3 launches a G+D step, 54 and 0 a D-only
                step, no composed block; (c) ms a G+D and a D-only step
                (3 after 1), MFU from the analytic FLOP, peak memory, busy
                ms and idle share from two profiled steps; (d) --dtype f32
                passes the route check (phase 30's kernels); (e) through
                cli.train_gan for 2
                steps, then a resume to 3: the recipe above (--dtype bf16,
                --vgg, make_train_loader at B=16 of 256x256; 54 + 54
                launches a G update over both runs), then the shipped option
                file as it is (MSRResNet0, discriminator_vgg_96 with
                BatchNorm, f32)
 27 face        seeded KAIR-keyed GPEN-BFR-512 and RetinaFace-R50 .pth
                files: (b) enhance_faces on a 320x240 image with two given
                boxes and landmarks, GPEN bf16 on the card against f32 on
                the CPU (<= 5e-2 of max|ref|; control: demodulation off),
                RetinaFace's outputs likewise (control: the BGR means not
                subtracted); (a) cli.test_face end to end on a seeded PNG
                (--sr 2, the threshold under the detector's third score: 3
                faces); (c) GPEN's ms per 512x512 face
 28 spect       seeded SPECT scans ((2, 1024, 256) float32 .dat: H Poisson
                counts of a smooth phantom up to 150, L binomial_thin at
                1/8; 8 training, 2 validation, 2 test pairs) and the three
                experiments of options/spect generated by
                cli.config_generator (data roots, run folder, checkpoint
                intervals and val_2's eval_repoisson rewritten): (a) SPECT
                SwinIR (embed 180, 6x6, window 8, in_nc 2, no upsampler)
                bf16 at B=16 of 64x64, blocks by BLOCK_INIT: --dtype f32
                passes the route check; the first step's gradient
                against the f32 plain route on the card with the f32
                route's dL/dE fed to both (<= 8e-3 over all, 1e-1 a block
                parameter, phase 24's gray limits; controls: the shifted
                blocks one pixel off, the shift mask dropped) and with
                each route's own Charbonnier gradient (<= 1e-1 a block
                parameter); 36 row-1 + 36 row-3 launches a step, ms a
                step, peak memory, busy ms and idle share; (b)
                the EMA copy's bf16 evaluation forward of a 1x1024x256x2
                scan (36 row-1 + 7 row-2 launches) against the f32 plain
                route on the card (<= 2e-2 of max|ref|; control: no shift
                mask), its ms; (c) cli.train_spect --dtype bf16 for 4 steps
                with an evaluation at 2 and 4 (test, val_1, val_2 clean and
                re-Poissoned: seconds and launches each), the best-PSNR /
                SSIM files and 6 corr_*.png, then a resume to 5; (d)
                DRUNet (poisson loss, epsilon 1 count) and RRDBNet-noUp in
                f32 at B=32 of 64x64: the gradient at B=2 of 32x32 against
                the CPU's (<= 1e-4; control: seed + 1 weights), ms a step
 29 scale_out   (a) cli.device_check: the card, the 128x128 round trip, the
                mesh {data: 1, model: 1, tile: 1}; (b) cli.train from
                options/swinir/train_swinir_sr_classical_x4.json for 2 steps
                on 32 seeded 200x200 PNGs through the native loader (built
                in phase 1 beside nvcc; the log's native-loader line
                required), then ms a batch of 32 at H_size 192 of the native
                loader against the Python Loader (utils/png decode, MATLAB
                bicubic; host time), and the loader's RAM-cache build
                (utils/png decode, then the C++ bicubic) on 4 seeded
                DIV2K-sized 2040x1356 PNGs, filter 0 and every row Paeth
                (the decoded pixels equal to the written ones), scaled to
                DIV2K's 800 images; (c) data parallel at world 2 over gloo,
                both ranks on the card, through parallel.launch.spawn: one
                SwinIR-M x4 step at B=4 of 64x64 LR, the averaged gradient
                against one process on the whole batch (<= 1.5e-2, the x4
                training gate), rank 0's own gradient as the control above
                it, 36 row-1 + 36 row-3 launches a rank's step; (d) NCCL in
                a group of one rank: the step's gradient through the
                all-reduce bit-equal; (e) parallel.tiled's overlap bands at
                world 1 on a 1x128x128 LR image: equal to the monolithic
                forward, 36 + 7 launches; (f) utils/profiling.trace of one
                forward, whose top rows name the row-1 kernel
 30 f32         the f32 kernels (csrc/swin_block_f32.cu,
                swin_block_bwd_f32.cu, conv_block_f32.cu) against their f32
                plain versions on the card, each with the bf16 kernel on the
                same inputs as the control over the limit: (a) row 1 at
                B=16 128x128 C=180, phases 0 and 4, and C=240 B=4 (<= 1e-4
                of max|ref|); (b) row 4 at ws 7, B=8 126x126, and row 5 (the
                attention-only mode) at B=16 128x128 (<= 1e-4); (c) row 2 at
                B=16 128x128 (<= 1e-4), timed against F.conv2d f32 + add;
                (d) row 3 at B=32 48x48, C=180 and C=240 (<= 5e-4 per
                tensor); ms, plain ms and the f32 bound of each; (e)
                SwinIR-M x4 through cli.test.build_preset(dtype=f32) at B=16
                128x128: 36 + 7 f32 launches, no bf16 launch, no composed
                call, within 1e-4 of the f32 plain route on the card; ms a
                forward, LR MP/s and f32 MFU; the unfused route and JPEG-CAR
                in f32 (36 row-5, 36 row-4 + 7 row-2 launches); (f) one
                SwinIR-M x4 f32 step from the x4 recipe at its batch (32 of
                48x48 LR): 36 + 36 f32 launches, its gradient within 1e-3 of
                the f32 plain route (the bf16 step's over it), ms a step,
                peak memory, busy ms and idle share; (g) one JPEG-CAR
                SwinIR-M step at window 7 (126x126, batch cut to 2): a
                finite loss, no row-1 or row-3 launch, 36 composed calls

Any failed check raises and the script exits non-zero; a watchdog ends a
hung run with a traceback. The line before the last is one JSON object with
every kernel's numbers; the last line is {"ok": true, "device": {...}}.
Needs a CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import faulthandler
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

WATCHDOG_S = 700          # the whole run, build included (≈ 600-660 s)
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Times one phase and prints `phase <name>: <s> s | <what was checked>`."""

    def __init__(self, name: str):
        self.name = name
        self.notes = []

    def note(self, msg: str) -> None:
        self.notes.append(msg)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "FAILED" if exc_type else "ok"
        log(f"phase {self.name}: {dt:.2f} s {status} | " + "; ".join(self.notes))
        return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def ptxas_kernels(log_lines) -> list:
    """(kernel, registers, spill-store bytes) of each kernel in ptxas -v's
    output; the 3-D window blocks' and the GDA kernels by name (with a
    template instance's arguments), the others by their mangled names."""
    import re
    out, name = [], None
    for line in log_lines:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"((?:tmsa|self|stl2|gda)_[a-z_]*kernel)"
                          r"(I(?:L[ib]\d+E)+E)?", name)
            if k:
                args = re.findall(r"L[ib](\d+)E", k.group(2) or "")
                name = k.group(1) + (f"<{','.join(args)}>" if args else "")
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name is not None:
            spill = max(spill, int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    """Median device time of fn() over `reps` runs, by CUDA events
    (utils/timing, as the port's timing CLIs)."""
    from kair_tpu_torch.utils.timing import launch_ms
    return statistics.median(launch_ms(fn, reps, warmup))


def bound_ms(flops: float, nbytes: float, rate: str = "bf16"):
    """(least time in ms, what bounds it) at the H100 SXM's published peaks;
    ``rate`` "bf16" (tensor cores) or "fp32" (outside them) for the
    operations."""
    from kair_tpu_torch.utils.summary import PEAKS
    pk = PEAKS["H100 SXM"]
    t_ops = flops / (pk[f"{rate}_tflops"] * 1e12) * 1e3
    t_mem = nbytes / (pk["hbm_tbps"] * 1e12) * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def compare(got, ref):
    d = (got.float() - ref.float()).abs()
    ref_max = ref.float().abs().max().item()
    return d.max().item(), d.max().item() / max(ref_max, 1e-30), ref_max, \
        d.mean().item()


def swin_params(c: int, nh: int, hidden: int, gen, device, dtype, ws: int = 8):
    """Seeded block weights for a ws x ws window, scaled so the softmax is
    far from uniform and every term of the block moves the output."""
    import torch
    from kair_tpu_torch.ops.kernels.swin_block import SwinBlockParams

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen) * std + mean).to(device, dtype)

    return SwinBlockParams(
        qkv_weight=rnd(3 * c, c, std=0.1), qkv_bias=rnd(3 * c, std=0.1),
        proj_weight=rnd(c, c, std=0.05), proj_bias=rnd(c, std=0.1),
        rel_table=rnd((2 * ws - 1) ** 2, nh, std=0.5),
        norm1_weight=rnd(c, std=0.1, mean=1.0), norm1_bias=rnd(c, std=0.1),
        norm2_weight=rnd(c, std=0.1, mean=1.0), norm2_bias=rnd(c, std=0.1),
        fc1_weight=rnd(hidden, c, std=0.05), fc1_bias=rnd(hidden, std=0.1),
        fc2_weight=rnd(c, hidden, std=0.05), fc2_bias=rnd(c, std=0.1))


def phase_swin(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.swin_block import (pack_swin_block,
                                                        swin_block_2d,
                                                        swin_block_2d_reference)
    from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor
    from kair_tpu_torch.utils.summary import swinir_block_flops_per_token

    b, h, w, c, nh, hidden = 16, 128, 128, 180, 6, 360
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    p = swin_params(c, nh, hidden, gen, dev, torch.bfloat16)
    x = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    pk = pack_swin_block(p, nh)
    mask = shift_mask_tensor(h, w, 8, 4, dev)
    tol = 1e-2
    with Phase("2 swin_block") as ph:
        ph.note(f"B={b} {h}x{w} C={c} nh={nh} bf16; limit max_abs <= {tol} * "
                "max|ref| (qkv, probabilities and MLP hidden are stored in "
                "bf16, f32 accumulation; plain version in f32 from the same "
                "bf16 inputs)")
        # the main path's second image: LR 64x72, a width of 8 mod 16; and
        # 63 windows, an odd count (one warpgroup of the last pair idles)
        x72 = x[:1, :64, :72].contiguous()
        x56 = x[:1, :56, :72].contiguous()
        cases = [(x, 0, None), (x, 4, mask), (x, -4, None),
                 (x72, 4, shift_mask_tensor(64, 72, 8, 4, dev)),
                 (x56, 4, shift_mask_tensor(56, 72, 8, 4, dev))]
        errs = []
        for xin, phase, m in cases:
            got = swin_block_2d(xin, p, nh, m, phase, packed=pk)
            ref = swin_block_2d_reference(xin.float(), p, nh, m, phase)
            torch.cuda.synchronize()
            e_abs, e_rel, ref_max, e_mean = compare(got, ref)
            what = (f"{tuple(xin.shape[:3])} phase {phase:+d} mask="
                    f"{'shift' if m is not None else 'none'}")
            ph.note(f"{what}: max_abs {e_abs:.4g} max_rel {e_rel:.4g} mean_abs "
                    f"{e_mean:.3g} (max|ref| {ref_max:.3g})")
            require(e_rel <= tol, f"swin_block_2d {what} max_rel {e_rel:.4g} "
                    f"> {tol}")
            if m is not None:
                # the check must be able to see a dropped mask
                no_mask = swin_block_2d_reference(xin.float(), p, nh, None, phase)
                eff = (no_mask - ref).abs().max().item()
                ph.note(f"mask effect {eff:.3g}")
                require(eff > tol * ref_max and eff > 3 * e_abs,
                        "mask effect not above the limit and the kernel error")
            errs.append(e_abs)
        # SwinIR-L's width, whose shared-memory layout overlaps x1 with
        # q/k/v and the MLP hidden layer with the scores
        bl, cl, nhl, hl = 4, 240, 8, 480
        pl = swin_params(cl, nhl, hl, gen, dev, torch.bfloat16)
        xl = torch.randn(bl, h, w, cl, generator=gen).to(dev, torch.bfloat16)
        pkl = pack_swin_block(pl, nhl)
        for phase, m in ((0, None), (4, mask)):
            got = swin_block_2d(xl, pl, nhl, m, phase, packed=pkl)
            ref = swin_block_2d_reference(xl.float(), pl, nhl, m, phase)
            control = None if m is None else swin_block_2d_reference(
                xl.float(), pl, nhl, None, phase)
            errs.append(check_case(
                ph, f"C={cl} nh={nhl} hidden={hl} {tuple(xl.shape[:3])} phase "
                f"{phase:+d} mask={'shift' if m is not None else 'none'}",
                got, ref, tol, control))
        ms_l = cuda_ms(lambda: swin_block_2d(xl, pl, nhl, mask, 4, packed=pkl))
        flops_l = bl * h * w * swinir_block_flops_per_token(cl, nhl, 8, hl / cl)
        bms_l, by_l = bound_ms(flops_l, 2 * 2 * bl * h * w * cl + 4 * mask.numel()
                               + block_weight_bytes(cl, nhl, hl, 64))
        ph.note(f"C={cl} kernel {ms_l:.3f} ms (B={bl} shifted, median of 10); "
                f"bound {bms_l:.4f} ms ({by_l})")
        ms = cuda_ms(lambda: swin_block_2d(x, p, nh, mask, 4, packed=pk))
        plain_ms = cuda_ms(lambda: swin_block_2d_reference(
            x.float(), p, nh, mask, 4), warmup=1, reps=5)
        tokens = b * h * w
        flops = tokens * swinir_block_flops_per_token(c, nh, 8, hidden / c)
        weights = 2 * (3 * c * c + c * c + 2 * c * hidden) \
            + 4 * (3 * c + c + hidden + c + 4 * c) + 4 * nh * 64 * 64
        nbytes = 2 * 2 * tokens * c + weights + 4 * mask.numel()
        bms, by = bound_ms(flops, nbytes)
        ph.note(f"kernel {ms:.3f} ms (shifted, median of 10); plain f32 "
                f"{plain_ms:.3f} ms; bound {bms:.4f} ms ({by}); "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
    report.append(dict(
        name="swin_block_2d", route="cuda",
        source="kair_tpu_torch/csrc/swin_block_wgmma.cu",
        replaces="kair_tpu/ops/pallas/swin_block.py:701",
        launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))


def conv_case(b: int, h: int, w: int, c: int, gen, dev):
    """Seeded bf16 y, res, weight (std 1/sqrt(9C)), bias and the packed
    weight of one conv call."""
    import torch
    from kair_tpu_torch.ops.kernels.conv_block import pack_conv3x3
    y = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    res = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    wt = (torch.randn(c, c, 3, 3, generator=gen) / math.sqrt(9 * c)).to(
        dev, torch.bfloat16)
    bias = (torch.randn(c, generator=gen) * 0.1).to(dev, torch.bfloat16)
    return y, res, wt, bias, pack_conv3x3(wt)


def phase_conv(report: list) -> None:
    import torch
    import torch.nn.functional as F
    from kair_tpu_torch.ops.kernels.conv_block import (
        conv3x3_residual, conv3x3_residual_reference)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    tol = 1e-2
    # (what, B, H, W, C, phase, timed): SwinIR-M's tail (phases 0 and 4,
    # unshifted and shifted), the main path's LR 64x72 (a partial column
    # tile), JPEG-CAR's B=8 126x126 (ragged rows and columns), the
    # lightweight width C=60 (N chunk 64) and SwinIR-L's width C=240 (two N
    # chunks of 128, the epilogue from registers; no model path runs it, as
    # SwinIR-L's tails are 3conv, but the wrapper takes every even C)
    cases = (("SwinIR-M", 16, 128, 128, 180, 0, True),
             ("SwinIR-M", 16, 128, 128, 180, 4, False),
             ("main path LR", 1, 64, 72, 180, 4, False),
             ("JPEG-CAR", 8, 126, 126, 180, 3, True),
             ("lightweight", 16, 128, 128, 60, 4, False),
             ("SwinIR-L width", 8, 64, 72, 240, 4, False))
    with Phase("3 conv3x3") as ph:
        ph.note(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
                f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
                f"float32_matmul_precision={torch.get_float32_matmul_precision()}; "
                f"limit max_abs <= {tol} * max|ref| (bf16 output rounding, "
                "f32 accumulation in another order); control: the plain "
                "version at phase + 1 exceeds the limit")
        errs, row = [], None
        for what, b, h, w, c, phase, timed in cases:
            y, res, wt, bias, wpk = conv_case(b, h, w, c, gen, dev)
            got = conv3x3_residual(y, res, wt, bias, phase, packed_weight=wpk)
            ref = conv3x3_residual_reference(y.float(), res.float(), wt, bias,
                                             phase)
            wrong = conv3x3_residual_reference(y.float(), res.float(), wt,
                                               bias, phase + 1)
            torch.cuda.synchronize()
            e_abs, e_rel, ref_max, e_mean = compare(got, ref)
            c_rel = compare(wrong, ref)[1]
            shape = f"{what} {b}x{h}x{w} C={c} phase {phase}"
            ph.note(f"{shape}: max_abs {e_abs:.4g} max_rel {e_rel:.4g} "
                    f"mean_abs {e_mean:.3g} (max|ref| {ref_max:.3g}); control "
                    f"{c_rel:.4g}")
            require(e_rel <= tol, f"conv3x3_residual {shape} max_rel "
                    f"{e_rel:.4g} > {tol}")
            require(c_rel > tol, f"conv3x3_residual {shape}: the wrong-phase "
                    f"control {c_rel:.4g} is not above the limit")
            errs.append(e_abs)
            if not timed:
                continue
            ms = cuda_ms(lambda: conv3x3_residual(y, res, wt, bias, phase,
                                                  packed_weight=wpk))
            # yardstick only, never used by the port: cuDNN channels-last bf16
            y_cl, r_cl = y.permute(0, 3, 1, 2), res.permute(0, 3, 1, 2)
            lib_ms = cuda_ms(lambda: F.conv2d(y_cl, wt, bias, padding=1)
                             .add_(r_cl))
            flops = 2.0 * b * h * w * 9 * c * c
            nbytes = 3 * 2 * b * h * w * c + 2 * 9 * c * c + 2 * c
            bms, by = bound_ms(flops, nbytes)
            ph.note(f"{shape}: kernel {ms:.4f} ms, {flops / ms / 1e9:.1f} "
                    f"TFLOP/s; F.conv2d bf16 channels-last + add {lib_ms:.4f} "
                    f"ms; bound {bms:.4f} ms ({by}); kernel / cuDNN "
                    f"{ms / lib_ms:.3f}")
            if row is None:
                plain_ms = cuda_ms(lambda: conv3x3_residual_reference(
                    y.float(), res.float(), wt, bias, phase), warmup=1, reps=5)
                ph.note(f"{shape}: plain f32 {plain_ms:.3f} ms")
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                           library_ms=lib_ms)
    report.append(dict(
        name="conv3x3_residual", route="cuda",
        source="kair_tpu_torch/csrc/conv_block.cu",
        replaces="kair_tpu/ops/pallas/conv_block.py:94",
        launches=None, max_abs_err=max(errs), **row))


def smooth_image(h: int, w: int, seed: int):
    """Seeded smooth RGB uint8 image: a few low-frequency sinusoids."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64) / max(h, w)
    img = np.zeros((h, w, 3))
    for ch in range(3):
        acc = 0.5 * np.ones((h, w))
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 4.0, 2)
            ph = rng.uniform(0, 2 * np.pi)
            acc += rng.uniform(0.05, 0.15) * np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
        img[..., ch] = acc
    return np.uint8((np.clip(img, 0, 1) * 255).round())


# Block weights of the main path, drawn like swin_params: KAIR's own
# initialisation (Linear std 0.02) leaves the 36 blocks so close to the
# identity that a wrong block would not show in the output.
BLOCK_INIT = {"attn.qkv.weight": (0.0, 0.1), "attn.qkv.bias": (0.0, 0.1),
              "attn.proj.weight": (0.0, 0.05), "attn.proj.bias": (0.0, 0.1),
              "attn.relative_position_bias_table": (0.0, 0.5),
              "norm1.weight": (1.0, 0.1), "norm1.bias": (0.0, 0.1),
              "norm2.weight": (1.0, 0.1), "norm2.bias": (0.0, 0.1),
              "mlp.fc1.weight": (0.0, 0.05), "mlp.fc1.bias": (0.0, 0.1),
              "mlp.fc2.weight": (0.0, 0.05), "mlp.fc2.bias": (0.0, 0.1)}


def main_path_state_dict(seed: int) -> dict:
    """Seeded SwinIR-M x4 state dict with KAIR's key names: KAIR's
    initialisation, the Swin blocks' tensors redrawn by BLOCK_INIT."""
    import torch
    from kair_tpu_torch.cli.test import SWINIR_X4
    from kair_tpu_torch.models.swinir import SwinIR

    torch.manual_seed(seed)
    sd = SwinIR(img_size=64, **SWINIR_X4).state_dict()
    gen = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        if ".residual_group.blocks." in k:
            mean_std = BLOCK_INIT.get(k.split(".", 5)[-1])
            if mean_std is not None:
                sd[k] = torch.randn(v.shape, generator=gen) * mean_std[1] \
                    + mean_std[0]
    return sd


def cpu_forward_without_shift_mask(model, lr):
    """The f32 CPU forward with the shifted blocks' 0/-100 mask left out:
    the control that the main-path comparison can see one wrong term."""
    from kair_tpu_torch.cli.test import make_forward
    from kair_tpu_torch.eval.test_modes import test_pad
    from kair_tpu_torch.models import swinir as msw

    with_mask = msw.shift_mask_tensor
    msw.shift_mask_tensor = lambda *a: None
    try:
        return test_pad(make_forward(model), lr, modulo=8, sf=4)
    finally:
        msw.shift_mask_tensor = with_mask


def phase_main_path(report: list, build_dir) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.cli.test import build_preset, make_forward
    from kair_tpu_torch.eval.test_modes import test_pad
    from kair_tpu_torch.ops.kernels.conv_block import conv3x3_residual
    from kair_tpu_torch.ops.kernels.swin_block import swin_block_2d
    from kair_tpu_torch.utils import image as im

    tol = 2e-2
    with Phase("4 main_path") as ph:
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            path = f"{tmp}/swinir_m_x4_seed{SEED}.pth"
            torch.save({"params": main_path_state_dict(SEED)}, path)
            gpu_model, kind, n_ch = build_preset("swinir_classical_x4", path,
                                                 device="cuda",
                                                 dtype=torch.bfloat16)
            cpu_model, _, _ = build_preset("swinir_classical_x4", path,
                                           device="cpu", dtype=torch.float32)
        ph.note(f"SwinIR-M x4 ({sum(p.numel() for p in gpu_model.parameters())} "
                f"params, blocks drawn by BLOCK_INIT) bf16 on cuda; limit "
                f"max_abs <= {tol} * max|ref| against the f32 CPU run (bf16 "
                "activations through 36 blocks, 7 fused tails and the head); "
                "control: the CPU run without the shift mask must differ by "
                "more than the limit and 3x the error")
        # 256x256 HR, and a width whose LR (70) test_pad takes to 72 = 8 mod 16
        images = [(f"HR {hh}x{ww}", smooth_image(hh, ww, SEED + i))
                  for i, (hh, ww) in enumerate(((256, 256), (256, 280)))]
        swin_block_2d.launches = 0
        conv3x3_residual.launches = 0
        outs = []
        for n, (name, img_h) in enumerate(images, 1):
            lr = im.hwc_to_nhwc(im.imresize_np(im.uint2single(img_h), 1 / 4,
                                               True).astype(np.float32))
            e_gpu = test_pad(make_forward(gpu_model), lr, modulo=8, sf=4)
            torch.cuda.synchronize()
            n_swin, n_conv = swin_block_2d.launches, conv3x3_residual.launches
            require(n_swin == 36 * n and n_conv == 7 * n,
                    f"{name}: expected 36 swin and 7 conv launches per "
                    f"forward, got {n_swin}/{n_conv} after {n} forwards")
            outs.append((name, img_h, lr, e_gpu))
        for k in report:
            k["launches"] = n_swin if k["name"] == "swin_block_2d" else n_conv
        ph.note(f"launches in {len(images)} forwards: swin_block_2d {n_swin}, "
                f"conv3x3_residual {n_conv} (36 and 7 per forward)")

        for name, img_h, lr, e_gpu in outs:
            e_cpu = test_pad(make_forward(cpu_model), lr, modulo=8, sf=4)
            require(e_gpu.shape == (1,) + img_h.shape and np.isfinite(e_gpu).all(),
                    f"{name}: output shape {e_gpu.shape} or non-finite values")
            ref_max = np.abs(e_cpu).max()
            err = np.abs(e_gpu - e_cpu).max()
            effect = np.abs(cpu_forward_without_shift_mask(cpu_model, lr)
                            - e_cpu).max()
            psnr = im.calculate_psnr(im.nhwc_to_uint(e_gpu), img_h, border=4)
            ph.note(f"{name} (LR {lr.shape[1]}x{lr.shape[2]}): max_abs "
                    f"{err:.4g} max_rel {err / ref_max:.4g} mean_abs "
                    f"{np.abs(e_gpu - e_cpu).mean():.3g}; shift-mask effect "
                    f"max_rel {effect / ref_max:.4g}; PSNR vs HR {psnr:.2f} dB "
                    "(random weights: information only)")
            require(err <= tol * ref_max,
                    f"{name}: main path max_rel {err / ref_max:.4g} > {tol}")
            require(effect > tol * ref_max and effect > 3 * err,
                    f"{name}: the shift-mask control ({effect / ref_max:.4g}) "
                    "is not above the limit and 3x the error")


def phase_throughput(card: str) -> None:
    import torch
    from kair_tpu_torch.models.swinir import SwinIR
    from kair_tpu_torch.cli.test import SWINIR_X4
    from kair_tpu_torch.utils.summary import (peak_bf16_tflops,
                                              swinir_flops_per_lr_pixel)

    b, s = 16, 128
    with Phase("5 throughput") as ph:
        torch.manual_seed(SEED)
        model = SwinIR(img_size=64, **SWINIR_X4).to("cuda", torch.bfloat16).eval()
        x = torch.rand(b, s, s, 3, device="cuda").to(torch.bfloat16)
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(x), warmup=2, reps=10)
        mp_s = b * s * s / (ms / 1e3) / 1e6
        tflops = swinir_flops_per_lr_pixel() * b * s * s / (ms / 1e3) / 1e12
        peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
        mfu = tflops / peak if peak else None
        ph.note(f"SwinIR-M x4 bf16 B={b} {s}x{s} LR: ms_per_forward {ms:.2f}, "
                f"{mp_s:.4f} LR MP/s, {tflops:.1f} TFLOP/s, MFU "
                f"{'n/a' if mfu is None else f'{mfu:.4f}'} of the bf16 dense "
                f"peak [{card}]")
        require(math.isfinite(ms) and ms > 0, "throughput timing")


def bwd_pass_times(fn, runs: int = 5) -> dict:
    """Device ms per call of each kernel that ``fn`` launches (torch.profiler
    over ``runs`` calls, device events only), by kernel name."""
    import torch
    from kair_tpu_torch.utils.timing import device_trace, kernel_name
    fn()
    torch.cuda.synchronize()
    out: dict = {}
    for t, _, key in device_trace(lambda: [fn() for _ in range(runs)],
                                  runs)[1]:
        name = kernel_name(key)
        out[name] = out.get(name, 0.0) + t
    return out


def launch_device_ms(fn, prefix: str, runs: int = 10):
    """Mean device ms of one launch of the kernels whose names start with
    ``prefix`` over ``runs`` calls of fn (torch.profiler): their device time
    over the launches the profiler saw, so a launch it dropped does not
    lower the mean; None if it saw none."""
    import torch
    from kair_tpu_torch.utils.timing import kernel_name
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and kernel_name(ev.key).startswith(prefix)):
            dev_us = getattr(ev, "self_device_time_total", None)
            total += (ev.self_cuda_time_total if dev_us is None else dev_us)
            count += ev.count
    return total / 1e3 / count if count else None


def phase_swin_bwd(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.swin_block import (SwinBlockParams,
                                                        pack_swin_block,
                                                        swin_block_2d,
                                                        swin_block_2d_bwd,
                                                        swin_block_2d_bwd_reference)
    from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor
    from kair_tpu_torch.utils.summary import swinir_block_bwd_flops_per_token

    b, h, w, c, nh, hidden = 32, 48, 48, 180, 6, 360
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    # f32 parameters, as the trainer holds them; bf16 activations
    p = swin_params(c, nh, hidden, gen, dev, torch.float32)
    x = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    dy = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    x56 = torch.randn(1, 48, 56, c, generator=gen).to(dev, torch.bfloat16)
    dy56 = torch.randn(1, 48, 56, c, generator=gen).to(dev, torch.bfloat16)
    mask = shift_mask_tensor(h, w, 8, 4, dev)
    names = ("dx",) + SwinBlockParams._fields
    tol = 2e-2

    def check(ph, what, got, ref, control=None, control_what="mask"):
        """Every tensor within the limit; the control (the plain version
        with the mask dropped, or at the wrong phase) moves dx by more than
        the limit and 3x the error. Returns dx's max abs error."""
        (dx, g), (rdx, rg) = got, ref
        worst, worst_name, dx_abs = 0.0, "", 0.0
        for name, a, r in zip(names, (dx,) + tuple(g), (rdx,) + tuple(rg)):
            e_abs, e_rel, _, _ = compare(a, r)
            require(e_rel <= tol, f"swin_block_2d_bwd {what} {name}: max_rel "
                    f"{e_rel:.4g} > {tol}")
            if name == "dx":
                dx_abs = e_abs
            if e_rel > worst:
                worst, worst_name = e_rel, name
        note = f"{what}: worst max_rel {worst:.4g} ({worst_name})"
        if control is not None:
            eff = (control.float() - rdx.float()).abs().max().item()
            ref_max = rdx.float().abs().max().item()
            note += f"; {control_what} effect on dx max_rel {eff / ref_max:.4g}"
            require(eff > tol * ref_max and eff > 3 * dx_abs,
                    f"{what}: the {control_what} control is not above the "
                    "limit and 3x the error")
        ph.note(note)
        return dx_abs

    with Phase("6 swin_bwd") as ph:
        ph.note(f"B={b} {h}x{w} C={c} nh={nh}, bf16 x and dy, f32 parameters; "
                f"limit per tensor max_abs <= {tol} * max|ref| for dx and each "
                "of the 13 grads (bf16 operands and stored intermediates, f32 "
                "accumulation; plain version: autograd in f32 from the same "
                "inputs); controls: without the mask, or at phase + 1, the "
                "plain dx must differ by more than the limit and 3x the error")
        errs = []
        pkb = pack_swin_block(p, nh, folded=False)     # as the model caches it
        for xin, dyin, m in ((x, dy, None), (x, dy, mask),
                             (x56, dy56, shift_mask_tensor(48, 56, 8, 4, dev))):
            got = swin_block_2d_bwd(xin, dyin, p, nh, m, pkb)
            torch.cuda.synchronize()
            ref = swin_block_2d_bwd_reference(xin, dyin, p, nh, m)
            control = None if m is None else \
                swin_block_2d_bwd_reference(xin, dyin, p, nh, None)[0]
            errs.append(check(ph, f"{tuple(xin.shape[:3])} mask="
                              f"{'shift' if m is not None else 'none'}",
                              got, ref, control))
        # the block's shift folded into the read of x (phase 4, the mask of
        # the shifted block), against the plain roll -> backward -> roll back
        got = swin_block_2d_bwd(x, dy, p, nh, mask, pkb, 4)
        torch.cuda.synchronize()
        ref = swin_block_2d_bwd_reference(x, dy, p, nh, mask, 4)
        control = swin_block_2d_bwd_reference(x, dy, p, nh, mask, 5)[0]
        errs.append(check(ph, f"{(b, h, w)} phase 4 mask=shift", got, ref,
                          control, "phase + 1"))
        # two launches on the same inputs give the same bits
        again = swin_block_2d_bwd(x, dy, p, nh, mask, pkb, 4)
        same = torch.equal(got[0], again[0]) and all(
            torch.equal(u, v) for u, v in zip(got[1], again[1]) if u is not None)
        require(same, "two launches differ")
        ph.note("two launches: bit-equal dx and grads")
        # SwinIR-L's width, which the first design's layout could not hold
        bl, hl, cl, nhl, hidl = 8, 64, 240, 8, 480
        pl_ = swin_params(cl, nhl, hidl, gen, dev, torch.float32)
        xl = torch.randn(bl, hl, hl, cl, generator=gen).to(dev, torch.bfloat16)
        dyl = torch.randn(bl, hl, hl, cl, generator=gen).to(dev, torch.bfloat16)
        maskl = shift_mask_tensor(hl, hl, 8, 4, dev)
        pkl = pack_swin_block(pl_, nhl, folded=False)
        got = swin_block_2d_bwd(xl, dyl, pl_, nhl, maskl, pkl, 4)
        torch.cuda.synchronize()
        ref = swin_block_2d_bwd_reference(xl, dyl, pl_, nhl, maskl, 4)
        control = swin_block_2d_bwd_reference(xl, dyl, pl_, nhl, None, 4)[0]
        errs.append(check(ph, f"C={cl} nh={nhl} hidden={hidl} {(bl, hl, hl)} "
                          "phase 4 mask=shift", got, ref, control))
        ms_l = cuda_ms(lambda: swin_block_2d_bwd(xl, dyl, pl_, nhl, maskl, pkl, 4))
        flops_l = bl * hl * hl * swinir_block_bwd_flops_per_token(cl, 8, hidl / cl)
        ph.note(f"C={cl} kernel {ms_l:.3f} ms (B={bl} shifted, median of 10), "
                f"{flops_l / ms_l / 1e9:.1f} TFLOP/s")

        ms = cuda_ms(lambda: swin_block_2d_bwd(x, dy, p, nh, mask, pkb, 4))
        plain_ms = cuda_ms(lambda: swin_block_2d_bwd_reference(
            x, dy, p, nh, mask, 4), warmup=1, reps=5)
        pk = pack_swin_block(p, nh)
        fwd_ms = cuda_ms(lambda: swin_block_2d(x, p, nh, mask, 4, packed=pk))
        tokens = b * h * w
        flops = tokens * swinir_block_bwd_flops_per_token(c, 8, hidden / c)
        n_params = sum(t.numel() for t in p)
        # x and dy read, dx written (bf16); parameters read and grads written
        # (f32); the mask read
        nbytes = 3 * 2 * tokens * c + 2 * 4 * n_params + 4 * mask.numel()
        bms, by = bound_ms(flops, nbytes)
        ph.note(f"kernel {ms:.3f} ms (phase 4, median of 10); plain f32 "
                f"{plain_ms:.3f} ms; forward kernel at this shape {fwd_ms:.3f} "
                f"ms; bound {bms:.4f} ms ({by}); {flops / ms / 1e9:.1f} TFLOP/s; "
                "max_abs_err in the kernels line is dx's worst")
        # each pass on its own: pass 2 computes the four weight products
        # (2 FLOP x tokens x their weights), pass 1 the rest; pass 1 writes
        # the 2 (4C + 2 hidden + 128 nh) operand bytes a token that pass 2
        # reads
        by_kernel = bwd_pass_times(
            lambda: swin_block_2d_bwd(x, dy, p, nh, mask, pkb, 4))
        f2 = 2.0 * tokens * (3 * c * c + c * c + 2 * c * hidden)
        op_bytes = tokens * 2 * (4 * c + 2 * hidden + 128 * nh)
        for what, key, fl, nb in (
                ("pass 1", "swin_bwd_kernel", flops - f2,
                 3 * 2 * tokens * c + op_bytes),
                ("pass 2", "swin_wgrad_kernel", f2, op_bytes)):
            t = by_kernel.get(key, 0.0)
            require(t > 0, f"the profiler saw no {key}")
            pb, pby = bound_ms(fl, nb)
            ph.note(f"{what} ({key}) {t:.4f} ms device, {fl / t / 1e9:.1f} "
                    f"TFLOP/s, bound {pb:.4f} ms ({pby}: {fl / 1e9:.1f} GFLOP, "
                    f"{nb / 1e6:.1f} MB)")
        ph.note("ordered sums (sum_rows_kernel) "
                f"{by_kernel.get('sum_rows_kernel', 0.0):.4f} ms")
    report.append(dict(
        name="swin_block_2d_bwd", route="cuda",
        source="kair_tpu_torch/csrc/swin_block_bwd_wgmma.cu",
        replaces="kair_tpu/ops/pallas/swin_block.py:588",
        launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))


OPTION_FILE = "options/swinir/train_swinir_sr_classical_x4.json"


def train_options(tmp: str, option_file: str = OPTION_FILE):
    """A shipped option file, parsed by the port, with its output paths
    and image folder moved into `tmp`."""
    from kair_tpu_torch import config
    raw = config.load_json_with_comments(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), option_file))
    raw["path"]["root"] = os.path.join(tmp, "runs")
    raw["datasets"]["train"]["dataroot_H"] = os.path.join(tmp, "trainH")
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, os.path.basename(option_file))
    with open(path, "w") as f:
        json.dump(raw, f)
    return config.parse(path)


def seeded_train_weights(model, seed: int) -> dict:
    """The model's state dict with the Swin blocks' tensors redrawn by
    BLOCK_INIT, so that a wrong block term shows in the gradients."""
    import torch
    sd = model.state_dict()
    gen = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        mean_std = BLOCK_INIT.get(k.split(".", 5)[-1]) \
            if ".residual_group.blocks." in k else None
        if mean_std is not None:
            sd[k] = (torch.randn(v.shape, generator=gen) * mean_std[1]
                     + mean_std[0]).to(v)
    return sd


def grads_of(trainer, batch) -> dict:
    import torch
    trainer.compute_grads(batch)
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad)
            .detach().float().cpu() for n, p in trainer.model.named_parameters()}


def device_breakdown(fn, runs: int, ms: float, what: str,
                     host: bool = False, top: int = 8, count=(),
                     sums=()) -> str:
    """Device time per run of ``fn`` (which does ``runs`` runs) by kernel,
    from torch.profiler, device events only (a CPU op that launched a
    ctypes-bound kernel would count that kernel's time again), and the
    idle share against ``ms`` per run timed with CUDA events. ``host``
    adds the kernel launches per run and the host's busiest ops by their
    own CPU time (what keeps an idle card waiting); ``top`` kernels are
    listed; each op named in ``count`` adds its outermost calls per run;
    each kernel-name prefix in ``sums`` adds its kernels' device time per
    run, in all and by kernel. Without ``host`` or ``count`` the profiler
    records the device alone."""
    import torch
    from kair_tpu_torch.utils.timing import device_trace, kernel_name
    prof, rows = device_trace(fn, runs, cpu=host or bool(count))
    if not rows:
        return "the profiler saw no device time"
    busy = sum(r[0] for r in rows)
    out = (f"device time per {what} (profiler, {runs} runs): busy "
           f"{busy:.2f} ms of the {ms:.2f} ms {what}, idle share "
           f"{1 - busy / ms:.4f}; " + ", ".join(
               f"{kernel_name(name)} {t:.2f} ms x{n}"
               for t, n, name in rows[:top]))
    for prefix in sums:
        mine = {}
        for t, n, name in rows:
            if kernel_name(name).startswith(prefix):
                k = kernel_name(name)
                mine[k] = mine.get(k, 0.0) + t
        out += (f"; {prefix}* kernels {sum(mine.values()):.2f} ms per {what} ("
                + ", ".join(f"{k} {v:.2f}" for k, v in sorted(mine.items()))
                + ")")
    for op in count:
        # calls made by the program and by autograd, not the op's calls to
        # itself (a roll over two dims runs as two one-dim rolls)
        calls = sum(1 for ev in prof.events() if ev.name == op
                    and (ev.cpu_parent is None or ev.cpu_parent.name != op))
        out += f"; {op} {calls / runs:g} calls per {what}"
    if host:
        cpu = sorted(((ev.self_cpu_time_total / 1e3 / runs, ev.count // runs,
                       ev.key) for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CPU),
                     reverse=True)
        out += (f"; {sum(r[1] for r in rows)} kernel launches per {what}; "
                f"host self time per {what}: " + ", ".join(
                    f"{name[:40]} {t:.2f} ms x{n}" for t, n, name in cpu[:8]))
    return out


def write_seeded_pngs(root: str, n_images: int, seed: int,
                      size: int = 200) -> None:
    """``n_images`` smooth seeded PNGs in ``root`` (the card has no image
    set)."""
    from kair_tpu_torch.utils.png import write_png
    os.makedirs(root, exist_ok=True)
    for i in range(n_images):
        write_png(os.path.join(root, f"seed{i:03d}.png"),
                  smooth_image(size, size, seed + i))


def write_paeth_png(path: str, img) -> None:
    """An (H, W, 3) uint8 image as a PNG with every row Paeth-filtered:
    the filter a photo's encoder picks most, and the port's slowest
    decode (utils/png's anti-diagonal path)."""
    import struct
    import zlib
    import numpy as np
    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), cur[:-1]])
    left = np.hstack([np.zeros((h, c), np.int16), cur[:, :-c]])
    up_left = np.hstack([np.zeros((h, c), np.int16), up[:, :-c]])
    p = left + up - up_left
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
    pred = np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, up_left))
    rows = ((cur - pred) & 255).astype(np.uint8)
    raw = np.hstack([np.full((h, 1), 4, np.uint8), rows]).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def cache_build_seconds(root: str, n_images: int, seed: int, threads: int
                        ) -> dict:
    """The native loader's RAM-cache build for the main recipe (on-the-fly
    x4 bicubic) on ``n_images`` seeded DIV2K-sized (2040x1356) photo-like
    PNGs, once written with filter 0 and once with every row Paeth:
    seconds of the whole build, and of its utils/png decode alone (whose
    pixels must equal the written ones)."""
    import numpy as np
    from kair_tpu_torch.data import native_loader
    from kair_tpu_torch.utils.png import write_png
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    base = smooth_image(1356, 2040, seed).astype(np.int16)
    images = [np.clip(base + rng.randint(-6, 7, base.shape), 0, 255)
              .astype(np.uint8) for _ in range(n_images)]
    out = {}
    for kind, writer in (("filter 0", write_png), ("Paeth", write_paeth_png)):
        paths = [os.path.join(root, f"{kind[0]}{i}.png")
                 for i in range(n_images)]
        for p, img in zip(paths, images):
            writer(p, img)
        t0 = time.perf_counter()
        decoded = native_loader.read_images(paths, 3, threads)
        decode_s = time.perf_counter() - t0
        require(all(np.array_equal(a, b) for a, b in zip(decoded, images)),
                f"utils/png decoded the {kind} PNGs wrongly")
        del decoded
        t0 = time.perf_counter()
        loader = native_loader.NativePairLoader(None, paths, n_channels=3,
                                                n_threads=threads, bicubic_sf=4)
        build_s = time.perf_counter() - t0
        require(loader.n_pairs == n_images, f"{loader.n_pairs} pairs cached")
        del loader
        out[kind] = (build_s, decode_s)
    return out


def native_batches(ds_opt, n: int, n_images: int, seed: int, ph) -> list:
    """``n`` training batches of an option block with
    ``use_native_loader`` through ``make_train_loader``, which must give
    the native loader, over seeded PNGs written to its ``dataroot_H``."""
    from kair_tpu_torch.data.datasets import make_train_loader
    from kair_tpu_torch.data.native_loader import NativeEpochLoader
    write_seeded_pngs(ds_opt["dataroot_H"], n_images, seed)
    said: list = []
    loader = make_train_loader(ds_opt, ds_opt["dataloader_batch_size"],
                               seed=SEED, info=said.append)
    require(isinstance(loader, NativeEpochLoader),
            f"use_native_loader gave {type(loader).__name__}: {said}")
    ph.note(f"batches from the native loader ({said[-1]})")
    batches, epoch = [], 0
    while len(batches) < n:
        batches += list(loader.epoch(epoch))
        epoch += 1
    return batches[:n]


def rel_norm(a: dict, b: dict, names) -> float:
    import torch
    num = torch.sqrt(sum(((a[n] - b[n]) ** 2).sum() for n in names))
    den = torch.sqrt(sum((b[n] ** 2).sum() for n in names))
    return (num / den).item()


def phase_train(report: list, card: str, build_dir) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch import config
    from kair_tpu_torch.cli.train import build_trainer
    from kair_tpu_torch.models import swinir as msw
    from kair_tpu_torch.ops.kernels.conv_block import conv3x3_residual
    from kair_tpu_torch.ops.kernels.swin_block import (swin_block_2d,
                                                        swin_block_2d_bwd)
    from kair_tpu_torch.train.trainer import PlainTrainer
    from kair_tpu_torch.utils.summary import (peak_bf16_tflops,
                                              swinir_flops_per_lr_pixel)

    # measured by this phase on an H100 (PERF.md): 0.0075 over all
    # parameters and 0.035 at the worst block parameter (a relative-position
    # table). Dropping the mask moves the global norm by 0.025 (it touches
    # the border windows only) and a block parameter by 0.67: each limit
    # lies between the sound reading and the control's
    tol_global, tol_param = 1.5e-2, 1e-1
    warmup, timed = 2, 8
    with Phase("7 train") as ph, tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        opt = train_options(tmp)
        ds_opt = opt["datasets"]["train"]
        bs = ds_opt["dataloader_batch_size"]
        trainer = build_trainer(opt, dtype=torch.bfloat16)
        torch.manual_seed(SEED)
        sd = seeded_train_weights(trainer.model, SEED + 3)
        trainer.model.load_state_dict(sd)
        trainer.ema.load_state_dict(sd)
        net = opt["netG"]
        ph.note(f"{OPTION_FILE}: embed {net['embed_dim']}, depths "
                f"{net['depths']}, heads {net['num_heads']}, window "
                f"{net['window_size']}, batch {bs}, H_size {ds_opt['H_size']}, "
                f"{opt['train']['G_lossfn_type']}, Adam "
                f"{opt['train']['G_optimizer_lr']}, EMA {opt['train']['E_decay']}; "
                f"{sum(p.numel() for p in trainer.model.parameters())} params "
                "(blocks drawn by BLOCK_INIT)")
        batches = native_batches(ds_opt, warmup + timed, 64, SEED + 100,
                                 ph)
        hs, sf = ds_opt["H_size"], opt["scale"]
        lr_hw = batches[0]["L"].shape[1:3]
        require(batches[0]["L"].shape == (bs, hs // sf, hs // sf, 3)
                and batches[0]["H"].shape == (bs, hs, hs, 3),
                f"batch shapes {batches[0]['L'].shape} {batches[0]['H'].shape}")

        # (a) the gradient on the card against the f32 CPU run
        small = {k: v[:2] for k, v in batches[0].items()}
        g_card = grads_of(trainer, small)
        cpu = PlainTrainer(opt, device="cpu", dtype=torch.float32)
        cpu.model.load_state_dict(sd)
        g_cpu = grads_of(cpu, small)
        with_mask = msw.shift_mask_tensor
        msw.shift_mask_tensor = lambda *a: None
        try:
            g_nomask = grads_of(cpu, small)
        finally:
            msw.shift_mask_tensor = with_mask
        names = list(g_cpu)
        block = [n for n in names if ".residual_group.blocks." in n]
        err = rel_norm(g_card, g_cpu, names)
        per = {n: rel_norm(g_card, g_cpu, [n]) for n in block}
        worst = max(per, key=per.get)
        eff = {n: rel_norm(g_nomask, g_cpu, [n]) for n in block}
        eff_worst = max(eff, key=eff.get)
        eff_global = rel_norm(g_nomask, g_cpu, names)
        ph.note(f"(a) gradient, B=2, bf16 card vs f32 CPU: relative norm error "
                f"{err:.4g} over all parameters (limit {tol_global}), worst "
                f"block parameter {worst} {per[worst]:.4g} (limit {tol_param}); "
                f"control, the CPU run without the shift mask: "
                f"{eff_global:.4g} over all parameters, "
                f"{eff[eff_worst]:.4g} at {eff_worst}")
        require(err <= tol_global, f"gradient error {err:.4g} > {tol_global}")
        require(per[worst] <= tol_param,
                f"block parameter {worst}: {per[worst]:.4g} > {tol_param}")
        require(eff_global > tol_global,
                "the dropped-mask control is not above the global limit")
        require(eff[eff_worst] > tol_param and eff[eff_worst] > 3 * per[worst],
                "the dropped-mask control is not above the per-parameter limit "
                "and 3x the worst error")

        # (b) steps: one forward and one backward block launch per block
        swin_block_2d.launches = swin_block_2d_bwd.launches = 0
        conv3x3_residual.launches = 0
        losses = [trainer.train_step(bt)["G_loss"] for bt in batches[:warmup]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        losses += [trainer.train_step(bt)["G_loss"] for bt in batches[warmup:]]
        e.record()
        torch.cuda.synchronize()
        n_fwd, n_bwd = swin_block_2d.launches, swin_block_2d_bwd.launches
        n_conv = conv3x3_residual.launches
        steps, n_blocks = warmup + timed, sum(net["depths"])
        require(n_fwd == n_blocks * steps and n_bwd == n_blocks * steps
                and n_conv == 0,
                f"expected {n_blocks} forward, {n_blocks} backward and 0 conv "
                f"launches per step, got {n_fwd}/{n_bwd}/{n_conv} in {steps} "
                "steps")
        for k in report:
            if k["name"] == "swin_block_2d_bwd":
                k["launches"] = n_bwd
        loss_vals = [float(v) for v in losses]
        require(all(math.isfinite(v) for v in loss_vals), f"losses {loss_vals}")
        ms = s.elapsed_time(e) / timed
        peak_mem = torch.cuda.max_memory_allocated()
        lr_px = bs * lr_hw[0] * lr_hw[1]
        tflops = 3 * swinir_flops_per_lr_pixel() * lr_px / (ms / 1e3) / 1e12
        peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
        mfu = tflops / peak if peak else None
        ph.note(f"(b) launches in {steps} steps: swin_block_2d {n_fwd}, "
                f"swin_block_2d_bwd {n_bwd}, conv3x3_residual {n_conv}; losses "
                f"{loss_vals[0]:.4g} .. {loss_vals[-1]:.4g}; ms_per_step {ms:.2f} "
                f"(mean of {timed}, CUDA events), {bs / (ms / 1e3):.1f} patches/s, "
                f"{lr_px / (ms / 1e3) / 1e6:.4f} LR MP/s, training MFU "
                f"{'n/a' if mfu is None else f'{mfu:.4f}'} (3x the forward's "
                "analytic FLOP, recompute not counted); peak memory "
                f"{peak_mem / 2 ** 30:.2f} GiB [{card}]")

        # (d) where a step's device time goes: two more steps under the
        # profiler
        prof_steps = 2
        ph.note("(d) " + device_breakdown(
            lambda: [trainer.train_step(bt)
                     for bt in batches[warmup:warmup + prof_steps]],
            prof_steps, ms, "step", count=("aten::roll",)))

        # (c) save, then resume in a fresh trainer
        from kair_tpu_torch.ckpt import checkpoint as ck
        models = opt["path"]["models"]
        paths = trainer.save(models, trainer.step)
        fresh = build_trainer(opt, dtype=torch.bfloat16)
        step, g_path = config.find_last_checkpoint(models, "G")
        fresh.resume(g_path, step)
        require(step == trainer.step == fresh.step, f"resumed at {step}")
        for name, a, b in (("G", trainer.model.state_dict(), fresh.model.state_dict()),
                           ("E", trainer.ema.state_dict(), fresh.ema.state_dict())):
            require(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
                    f"resumed {name} differs")
        so, sf = ck.load(paths[-1]), fresh.optimizer.state_dict()
        require(so["param_groups"] == sf["param_groups"] and all(
            torch.equal(torch.as_tensor(v).cpu(), torch.as_tensor(sf["state"][i][k]).cpu())
            for i, st in so["state"].items() for k, v in st.items()),
            "resumed optimizer state differs")
        ph.note(f"(c) saved {', '.join(os.path.basename(p) for p in paths)}; "
                "a fresh trainer resumed with equal G, E and optimizer state")


def block_weight_bytes(c: int, nh: int, hidden: int, n: int) -> int:
    """Bytes of one block's parameters as the kernels read them: bf16
    matrices, f32 biases and LN vectors, the (nh, n, n) f32 score bias."""
    return (2 * (3 * c * c + c * c + 2 * c * hidden)
            + 4 * (3 * c + c + hidden + c + 4 * c) + 4 * nh * n * n)


def check_case(ph, what, got, ref, tol, control=None) -> float:
    """Require max|got − ref| ≤ tol · max|ref| and, given the plain version
    without the shift mask, that dropping it moves the result by more than
    the limit and 3x the error; note both. Returns the max abs error."""
    e_abs, e_rel, ref_max, e_mean = compare(got, ref)
    note = (f"{what}: max_abs {e_abs:.4g} max_rel {e_rel:.4g} mean_abs "
            f"{e_mean:.3g} (max|ref| {ref_max:.3g})")
    require(e_rel <= tol, f"{what}: max_rel {e_rel:.4g} > {tol}")
    if control is not None:
        eff = (control.float() - ref.float()).abs().max().item()
        note += f"; mask effect max_rel {eff / ref_max:.4g}"
        require(eff > tol * ref_max and eff > 3 * e_abs,
                f"{what}: the dropped-mask control is not above the limit and "
                "3x the error")
    ph.note(note)
    return e_abs


def phase_swin_win(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.swin_block import (pack_swin_block,
                                                        swin_block_2d,
                                                        swin_block_win_reference)
    from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor
    from kair_tpu_torch.utils.summary import swinir_block_flops_per_token

    c, nh, hidden = 180, 6, 360
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 4)
    p7 = swin_params(c, nh, hidden, gen, dev, bf, ws=7)
    p4 = swin_params(c, nh, hidden, gen, dev, bf, ws=4)
    x = torch.randn(8, 126, 126, c, generator=gen).to(dev, bf)
    x21 = torch.randn(1, 21, 35, c, generator=gen).to(dev, bf)
    x12 = torch.randn(1, 12, 20, c, generator=gen).to(dev, bf)
    x63 = torch.randn(1, 49, 63, c, generator=gen).to(dev, bf)
    mask = shift_mask_tensor(126, 126, 7, 3, dev)
    tol = 1e-2
    with Phase("8 swin_win") as ph:
        ph.note(f"window block kernel, C={c} nh={nh} bf16; limit max_abs <= "
                f"{tol} * max|ref| against the f32 plain version on the same "
                "bf16 inputs; control: the shifted cases' plain version "
                "without the mask")
        errs = []
        for xin, p, ws, phase in ((x, p7, 7, 3), (x, p7, 7, 0),
                                  (x21, p7, 7, 3), (x12, p4, 4, 2),
                                  (x63, p7, 7, 3)):
            h, w = xin.shape[1:3]
            m = shift_mask_tensor(h, w, ws, phase, dev)
            got = swin_block_2d(xin, p, nh, m, phase, ws,
                                packed=pack_swin_block(p, nh))
            ref = swin_block_win_reference(xin.float(), p, nh, m, phase, ws)
            torch.cuda.synchronize()
            control = None if m is None else swin_block_win_reference(
                xin.float(), p, nh, None, phase, ws)
            errs.append(check_case(
                ph, f"{tuple(xin.shape[:3])} ws {ws} ({(h // ws) * (w // ws)} "
                f"windows) phase {phase}", got, ref, tol, control))
        pk = pack_swin_block(p7, nh)
        ms = cuda_ms(lambda: swin_block_2d(x, p7, nh, mask, 3, 7, packed=pk))
        plain_ms = cuda_ms(lambda: swin_block_win_reference(
            x.float(), p7, nh, mask, 3, 7), warmup=1, reps=5)
        tokens = x.numel() // c
        flops = tokens * swinir_block_flops_per_token(c, nh, 7, hidden / c)
        nbytes = (2 * 2 * tokens * c + block_weight_bytes(c, nh, hidden, 49)
                  + 4 * mask.numel())
        bms, by = bound_ms(flops, nbytes)
        ph.note(f"kernel {ms:.3f} ms (B=8 126x126 ws 7 shifted, median of 10); "
                f"plain f32 {plain_ms:.3f} ms; bound {bms:.4f} ms ({by}, "
                f"{flops / 1e9:.1f} GFLOP on the real tokens), "
                f"{bms / ms:.4f} of it; {flops / ms / 1e9:.1f} TFLOP/s")
    report.append(dict(
        name="swin_block_win", route="cuda",
        source="kair_tpu_torch/csrc/swin_block_wgmma.cu",
        replaces="kair_tpu/ops/pallas/swin_block.py:843",
        launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))


def phase_window_msa(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.window_msa import (pack_window_msa,
                                                       shift_mask_tensor,
                                                       window_msa_win,
                                                       window_msa_win_reference)
    from kair_tpu_torch.utils.summary import window_msa_flops_per_token

    b, h, w, c, nh = 16, 128, 128, 180, 6
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 5)
    p = swin_params(c, nh, 2 * c, gen, dev, bf)
    y = torch.randn(b, h, w, c, generator=gen).to(dev, bf)
    mask = shift_mask_tensor(h, w, 8, 4, dev)
    tol = 1e-2

    def args(p, qkv_bias, m, phase, ws=8, f32=False):
        cast = (lambda t: None if t is None else t.float()) if f32 else \
            (lambda t: t)
        return (cast(p.qkv_weight), cast(qkv_bias), cast(p.proj_weight),
                cast(p.proj_bias), cast(p.rel_table), p.rel_table.shape[1], m,
                phase, ws)

    # SwinIR-L's width at window 8, JPEG-CAR's window 7 at C=180, and
    # SwinIR-light's C=60: (what, map, params, window, phase)
    p240 = swin_params(240, 8, 480, gen, dev, bf)
    p7 = swin_params(c, nh, 2 * c, gen, dev, bf, ws=7)
    p60 = swin_params(60, 6, 120, gen, dev, bf)
    widths = (("C=240 (SwinIR-L), B=4 128x128",
               torch.randn(4, 128, 128, 240, generator=gen).to(dev, bf), p240, 8, 4),
              ("C=180 ws 7 (JPEG-CAR), B=8 126x126",
               torch.randn(8, 126, 126, c, generator=gen).to(dev, bf), p7, 7, 3),
              ("C=180 ws 7, B=8 126x126",
               torch.randn(8, 126, 126, c, generator=gen).to(dev, bf), p7, 7, 0),
              ("C=60 (SwinIR-light), B=4 64x64",
               torch.randn(4, 64, 64, 60, generator=gen).to(dev, bf), p60, 8, 4))

    with Phase("9 window_msa") as ph:
        ph.note(f"window attention kernel (the wgmma block's attention-only "
                f"mode) on a bf16 B={b} {h}x{w} C={c} map, nh={nh}, and at "
                f"C=240, window 7 and C=60; limit max_abs <= {tol} * max|ref| "
                "against the composed window_msa in f32; control: the "
                "shifted cases' plain version without the mask")
        errs = []
        cases = [(f"C={c} phase {ph_} mask={'shift' if m is not None else 'none'}"
                  f" qkv_bias={'yes' if qb is not None else 'no'}", y, p, qb,
                  m, ph_, 8)
                 for qb, m, ph_ in ((p.qkv_bias, mask, 4), (p.qkv_bias, None, 0),
                                    (None, mask, 4))]
        cases += [(f"{what} phase {ph_}", x, pp, pp.qkv_bias,
                   shift_mask_tensor(x.shape[1], x.shape[2], ws, ph_, dev),
                   ph_, ws) for what, x, pp, ws, ph_ in widths]
        for what, x, pp, qb, m, ph_, ws in cases:
            pk = pack_window_msa(*args(pp, qb, m, ph_, ws)[:6])
            got = window_msa_win(x, *args(pp, qb, m, ph_, ws), packed=pk)
            ref = window_msa_win_reference(x.float(),
                                           *args(pp, qb, m, ph_, ws, True))
            torch.cuda.synchronize()
            control = None if m is None else window_msa_win_reference(
                x.float(), *args(pp, qb, None, ph_, ws, True))
            errs.append(check_case(ph, what, got, ref, tol, control))
        pk = pack_window_msa(*args(p, p.qkv_bias, mask, 4)[:6])
        ms = cuda_ms(lambda: window_msa_win(y, *args(p, p.qkv_bias, mask, 4),
                                            packed=pk))
        plain_ms = cuda_ms(lambda: window_msa_win_reference(
            y.float(), *args(p, p.qkv_bias, mask, 4, f32=True)), warmup=1,
            reps=5)
        tokens = b * h * w
        flops = tokens * window_msa_flops_per_token(c, 8)
        weights = 2 * 4 * c * c + 4 * 4 * c + 4 * nh * 64 * 64
        nbytes = 2 * 2 * tokens * c + weights + 4 * mask.numel()
        bms, by = bound_ms(flops, nbytes)
        bytes_ms = nbytes / 3.35e12 * 1e3
        ph.note(f"kernel {ms:.3f} ms (shifted, median of 10); plain f32 "
                f"{plain_ms:.3f} ms; bound {bms:.4f} ms ({by}; the bytes alone "
                f"{bytes_ms:.4f} ms), {bms / ms:.4f} of it; "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
        for what, x, pp, ws, ph_ in widths[:2]:
            m = shift_mask_tensor(x.shape[1], x.shape[2], ws, ph_, dev)
            pk = pack_window_msa(*args(pp, pp.qkv_bias, m, ph_, ws)[:6])
            t = cuda_ms(lambda: window_msa_win(
                x, *args(pp, pp.qkv_bias, m, ph_, ws), packed=pk))
            ph.note(f"{what} shifted: kernel {t:.3f} ms (median of 10)")
    report.append(dict(
        name="window_msa_win", route="cuda",
        source="kair_tpu_torch/csrc/swin_block_wgmma.cu",
        replaces="kair_tpu/ops/pallas/window_msa.py:271",
        launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))


def visible_state_dict(model, seed: int, he_convs=(), img_range: float = 1.0):
    """A seeded state dict in which the Swin blocks move the output: the
    blocks drawn by BLOCK_INIT (``seeded_train_weights``), the convs named
    in ``he_convs`` redrawn He-normal (std sqrt(2 / fan_in)), conv_first
    scaled by 1 / img_range and conv_last by img_range. Under KAIR's
    initialisation the blocks' share of the output is ~1e-3 both at
    img_range 255 (the body sees the input at 255x its scale) and behind
    the five small-gain convs of the nearest+conv head; no comparison could
    see a wrong block there."""
    import torch
    sd = seeded_train_weights(model, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for name in he_convs:
        v = sd[f"{name}.weight"]
        sd[f"{name}.weight"] = torch.randn(v.shape, generator=gen) * math.sqrt(
            2.0 / v[0].numel())
    if img_range != 1.0:
        sd["conv_first.weight"] = sd["conv_first.weight"] / img_range
        sd["conv_last.weight"] = sd["conv_last.weight"] * img_range
        sd["conv_last.bias"] = sd["conv_last.bias"] * img_range
    return sd


def cpu_without_shift_mask(fn):
    """fn() with the shifted blocks' 0/−100 mask left out of the model."""
    from kair_tpu_torch.models import swinir as msw
    with_mask = msw.shift_mask_tensor
    msw.shift_mask_tensor = lambda *a: None
    try:
        return fn()
    finally:
        msw.shift_mask_tensor = with_mask


class LaunchCount:
    """Zero every Swin-path kernel's launch count, bf16 and f32, and
    SwinIR's count of composed block calls (``SwinBlock.composed_calls``, a
    route the card takes only where the JAX package runs XLA), read them
    after."""

    def __enter__(self):
        from kair_tpu_torch.models import swinir as msw
        from kair_tpu_torch.ops.kernels import conv_block, swin_block, window_msa
        sb2, bwd = swin_block.swin_block_2d, swin_block.swin_block_2d_bwd
        msa, conv = window_msa.window_msa_win, conv_block.conv3x3_residual
        # kernel name → (wrapper, its count of that kernel's launches)
        self.fns = {"swin_block_2d": (sb2, "launches"),
                    "swin_block_win": (sb2, "launches_win"),
                    "window_msa_win": (msa, "launches"),
                    "conv3x3_residual": (conv, "launches"),
                    "swin_block_2d_bwd": (bwd, "launches"),
                    "swin_block_2d_f32": (sb2, "launches_f32"),
                    "swin_block_win_f32": (sb2, "launches_win_f32"),
                    "window_msa_win_f32": (msa, "launches_f32"),
                    "conv3x3_residual_f32": (conv, "launches_f32"),
                    "swin_block_2d_bwd_f32": (bwd, "launches_f32"),
                    "composed": (msw.SwinBlock, "composed_calls")}
        for f, attr in self.fns.values():
            setattr(f, attr, 0)
        return self

    def __exit__(self, *exc):
        self.counts = {n: getattr(f, attr) for n, (f, attr) in self.fns.items()}
        return False

    def expect(self, what: str, **want) -> str:
        got = {k: v for k, v in self.counts.items() if v}
        want = {k: v for k, v in want.items() if v}
        require(got == want, f"{what}: launches {got}, expected {want}")
        return ", ".join(f"{k} {v}" for k, v in self.counts.items())


def model_timing(ph, model, x, flops_per_px: float, card: str, what: str):
    """ms per forward (median of 10, CUDA events), LR MP/s and MFU;
    returns the ms."""
    import torch
    from kair_tpu_torch.utils.summary import peak_bf16_tflops
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(x), warmup=2, reps=10)
    b, h, w = x.shape[:3]
    tflops = flops_per_px * b * h * w / (ms / 1e3) / 1e12
    peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
    ph.note(f"{what}: ms_per_forward {ms:.2f}, {b * h * w / (ms / 1e3) / 1e6:.4f} "
            f"LR MP/s, {tflops:.1f} TFLOP/s, MFU "
            f"{'n/a' if not peak else f'{tflops / peak:.4f}'} of the bf16 "
            f"dense peak [{card}]")
    require(math.isfinite(ms) and ms > 0, f"{what} timing")
    return ms


def forward(model, x):
    import torch
    with torch.inference_mode():
        out = model(x)
    if x.is_cuda:
        torch.cuda.synchronize()
    return out.float().cpu()


# KAIR 006_CAR_DFWB_s126w7_SwinIR-M_jpeg{10,20,30,40} (main_test_swinir.py:
# 170-172), color, as an option tree's netG
JPEG_CAR_NET = {"net_type": "swinir", "upscale": 1, "in_nc": 3,
                "img_size": 126, "window_size": 7, "img_range": 255.0,
                "depths": [6] * 6, "embed_dim": 180, "num_heads": [6] * 6,
                "mlp_ratio": 2, "upsampler": "", "resi_connection": "1conv"}


def phase_jpeg_car(report: list, card: str) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.models.registry import define_g
    from kair_tpu_torch.utils.summary import swinir_flops_per_lr_pixel

    b, s, tol = 8, 126, 2e-2
    with Phase("10 jpeg_car") as ph:
        torch.manual_seed(SEED)
        cpu_model = define_g({"netG": dict(JPEG_CAR_NET)}).eval()
        sd = visible_state_dict(cpu_model, SEED + 6, img_range=255.0)
        cpu_model.load_state_dict(sd)
        gpu_model = define_g({"netG": dict(JPEG_CAR_NET)})
        gpu_model.load_state_dict(sd)
        gpu_model = gpu_model.to("cuda", torch.bfloat16).eval()
        ph.note("KAIR 006_CAR_DFWB_s126w7_SwinIR-M (color, embed 180, depths "
                "6x6, 6 heads, window 7, img_range 255) from an option tree "
                "through define_g, bf16 on cuda, blocks by BLOCK_INIT, "
                "conv_first / 255 and conv_last x 255 (visible_state_dict); "
                f"limit max_abs <= {tol} * max|ref| against the f32 CPU run on "
                "image 0; head normalisation and the image residual in f32")
        rng = np.random.RandomState(SEED + 7)
        imgs = np.stack([smooth_image(s, s, SEED + 200 + i) for i in range(b)])
        x = np.clip(imgs / 255.0 + rng.normal(0, 8 / 255, imgs.shape), 0, 1)
        x = torch.from_numpy(x.astype(np.float32))
        xg = x.to("cuda")
        with LaunchCount() as lc:
            out = forward(gpu_model, xg)
        counts = lc.expect("JPEG-CAR forward", swin_block_win=36,
                           conv3x3_residual=7)
        for k in report:
            if k["name"] == "swin_block_win":
                k["launches"] = lc.counts["swin_block_win"]
        ph.note(f"launches in one B={b} {s}x{s} forward: {counts}")
        require(out.shape == x.shape and torch.isfinite(out).all().item(),
                f"output {tuple(out.shape)} or non-finite values")
        ref = forward(cpu_model, x[:1])
        control = cpu_without_shift_mask(lambda: forward(cpu_model, x[:1]))
        e_abs = check_case(ph, f"image 0 ({s}x{s})", out[:1], ref, tol, control)
        ph.note(f"max error {e_abs * 255:.3f} gray levels (of 255)")
        ms = model_timing(ph, gpu_model, xg, swinir_flops_per_lr_pixel(
            window=7, upsampler="", upscale=1), card, f"B={b} {s}x{s}")

        def two_forwards():
            with torch.inference_mode():
                gpu_model(xg)
                gpu_model(xg)
        ph.note(device_breakdown(two_forwards, 2, ms, "forward"))


def phase_unfused(report: list, card: str, build_dir) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.cli.test import SWINIR_X4, build_preset
    from kair_tpu_torch.utils.summary import swinir_flops_per_lr_pixel

    b, s, tol = 16, 128, 2e-2
    with Phase("11 unfused") as ph:
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            path = f"{tmp}/swinir_m_x4_seed{SEED}.pth"
            torch.save({"params": main_path_state_dict(SEED)}, path)
            unfused, _, _ = build_preset("swinir_classical_x4", path, "cuda",
                                         torch.bfloat16, fuse=False)
            fused, _, _ = build_preset("swinir_classical_x4", path, "cuda",
                                       torch.bfloat16, fuse=True)
            cpu_model, _, _ = build_preset("swinir_classical_x4", path, "cpu",
                                           torch.float32, fuse=False)
        ph.note("SwinIR-M x4 (the main path's weights) through "
                "cli.test.build_preset with fuse off: LN1, window-attention "
                "kernel, residual, LN2 and MLP (cuBLAS), cuDNN tails; limit "
                f"max_abs <= {tol} * max|ref| against the fused forward on "
                "the batch and the f32 CPU run on a 64x64 crop, with the "
                "dropped-mask control")
        x = torch.rand(b, s, s, 3, generator=torch.Generator().manual_seed(SEED))
        xg = x.to("cuda")
        with LaunchCount() as lc:
            out = forward(unfused, xg)
        counts = lc.expect("unfused forward", window_msa_win=36)
        for k in report:
            if k["name"] == "window_msa_win":
                k["launches"] = lc.counts["window_msa_win"]
        ph.note(f"launches in one B={b} {s}x{s} forward: {counts}")
        require(out.shape == (b, 4 * s, 4 * s, 3) and torch.isfinite(out).all().item(),
                f"output {tuple(out.shape)} or non-finite values")
        check_case(ph, "against the fused forward", out, forward(fused, xg), tol)
        crop = x[:1, :64, :64].contiguous()
        ref = forward(cpu_model, crop)
        control = cpu_without_shift_mask(lambda: forward(cpu_model, crop))
        check_case(ph, "64x64 crop against f32 CPU", forward(unfused, crop.cuda()),
                   ref, tol, control)
        model_timing(ph, unfused, xg, swinir_flops_per_lr_pixel(), card,
                     f"unfused B={b} {s}x{s}")
        model_timing(ph, fused, xg, swinir_flops_per_lr_pixel(), card,
                     f"fused, same call, B={b} {s}x{s}")


# KAIR 003_realSR_BSRGAN_DFOWMFC_s64w8_SwinIR-L_x4_GAN (main_test_swinir.py)
SWINIR_L = dict(upscale=4, in_chans=3, embed_dim=240, depths=(6,) * 9,
                num_heads=(8,) * 9, window_size=8, mlp_ratio=2.0,
                upsampler="nearest+conv", resi_connection="3conv")
NEAREST_CONV_HEAD = ("conv_before_upsample.0", "conv_up1", "conv_up2",
                     "conv_hr", "conv_last")


# the modules whose outputs phase 12 compares stage by stage
SWINIR_L_STAGES = ("conv_first", *(f"layers.{i}" for i in range(9)), "norm",
                   "conv_after_body", *NEAREST_CONV_HEAD)
SWINIR_L_TAILS = (*(f"layers.{i}.conv" for i in range(9)), "conv_after_body")


class stage_outputs(dict):
    """While open, records the f32 CPU copy of each named module's output
    of the model's next forward."""

    def __init__(self, model, names):
        super().__init__()
        mods = dict(model.named_modules())
        self.hooks = [mods[n].register_forward_hook(
            lambda m, a, out, n=n: self.__setitem__(n, out.detach().float().cpu()))
            for n in names]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for hk in self.hooks:
            hk.remove()
        return False


def with_f32_modules(gpu_model, cpu_model, body=(), head=()):
    """A copy of the bf16 card model in which the named modules are the f32
    CPU model's, moved to the card, with their input cast to f32: each of
    ``body`` hands its output back in bf16 (the body's stream stays bf16),
    the ``head`` keeps f32 to the end."""
    import copy
    import torch
    model = copy.deepcopy(gpu_model)
    for name in (*body, *head):
        sub = copy.deepcopy(cpu_model.get_submodule(name)).to("cuda")
        sub.register_forward_pre_hook(lambda m, a: tuple(t.float() for t in a))
        if name in body:
            sub.register_forward_hook(lambda m, a, out: out.to(torch.bfloat16))
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, attr, sub)
    return model


def error_attribution(cpu_model, gpu_model, img, ref, ref_stages,
                      gpu_stages) -> str:
    """max_rel (of each tensor's own max|ref|) of the bf16 card run against
    the f32 CPU run after each stage, and of the output with the 3conv
    tails, the head's convs, both, or every conv computed in f32 on the
    card (what is left then is the Swin blocks' and LayerNorms')."""
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    parts = ["after " + ", ".join(f"{n} {rel(gpu_stages[n], ref_stages[n]):.4g}"
                                  for n in SWINIR_L_STAGES)]
    for what, body, head in (
            ("the 3conv tails", SWINIR_L_TAILS, ()),
            ("the head's convs", (), NEAREST_CONV_HEAD),
            ("tails and head", SWINIR_L_TAILS, NEAREST_CONV_HEAD),
            ("every conv", ("conv_first",) + SWINIR_L_TAILS, NEAREST_CONV_HEAD)):
        model = with_f32_modules(gpu_model, cpu_model, body, head)
        parts.append(f"output max_rel with {what} in f32 "
                     f"{rel(forward(model, img.cuda()), ref):.4g}")
    return "; ".join(parts)


def phase_swinir_l(card: str) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.models.swinir import SwinIR
    from kair_tpu_torch.utils.summary import swinir_flops_per_lr_pixel

    b, s, tol = 4, 128, 2e-2
    with Phase("12 swinir_l") as ph:
        torch.manual_seed(SEED)
        cpu_model = SwinIR(img_size=64, **SWINIR_L).eval()
        sd = visible_state_dict(cpu_model, SEED + 8, he_convs=NEAREST_CONV_HEAD)
        cpu_model.load_state_dict(sd)
        gpu_model = SwinIR(img_size=64, **SWINIR_L)
        gpu_model.load_state_dict(sd)
        gpu_model = gpu_model.to("cuda", torch.bfloat16).eval()
        ph.note(f"SwinIR-L x4 real-world SR ({sum(p.numel() for p in gpu_model.parameters())} "
                "params; embed 240, depths 9x6, 8 heads, window 8, 3conv, "
                "nearest+conv) bf16 on cuda; blocks by BLOCK_INIT, the head's "
                f"convs He-normal (visible_state_dict); limit max_abs <= {tol} "
                "* max|ref| against the f32 CPU run on a 64x64 image")
        x = torch.rand(b, s, s, 3, generator=torch.Generator().manual_seed(SEED + 9))
        xg = x.to("cuda")
        with LaunchCount() as lc:
            out = forward(gpu_model, xg)
        counts = lc.expect("SwinIR-L forward", swin_block_2d=54)
        ph.note(f"launches in one B={b} {s}x{s} forward: {counts}")
        require(out.shape == (b, 4 * s, 4 * s, 3) and torch.isfinite(out).all().item(),
                f"output {tuple(out.shape)} or non-finite values")
        img = torch.from_numpy(smooth_image(64, 64, SEED + 300).astype(np.float32)
                               / 255.0)[None]
        with stage_outputs(cpu_model, SWINIR_L_STAGES) as ref_stages:
            ref = forward(cpu_model, img)
        control = cpu_without_shift_mask(lambda: forward(cpu_model, img))
        with stage_outputs(gpu_model, SWINIR_L_STAGES) as gpu_stages:
            got = forward(gpu_model, img.cuda())
        check_case(ph, "64x64 image against f32 CPU", got, ref, tol, control)
        ph.note("where the error is: " + error_attribution(
            cpu_model, gpu_model, img, ref, ref_stages, gpu_stages))
        model_timing(ph, gpu_model, xg, swinir_flops_per_lr_pixel(
            240, (6,) * 9, 8, 8, 2.0, 64, 3, 4, "nearest+conv", "3conv"), card,
            f"B={b} {s}x{s}")


# ---------------------------------------------------------------------------
# VRT video SR (phases 13-16)
# ---------------------------------------------------------------------------

def win3d_params(c: int, nh: int, twd: int, mutual: bool, gen, device):
    """Seeded f32 weights of one VRT transformer block (KAIR layout), scaled
    so the scores are order 1, the rel-pos bias and the mask matter, and
    every term of the block moves the output."""
    import torch
    from kair_tpu_torch.ops.window3d import Tmsa3dParams, sine_position_encoding
    hid = 2 * c
    r = lambda *s, k=1.0: (torch.randn(*s, generator=gen) * k).to(device)
    s_in = c ** -0.5
    return Tmsa3dParams(
        r(3 * c, c, k=s_in), r(3 * c, k=0.1),
        r(3 * c, c, k=s_in) if mutual else None,
        r(3 * c, k=0.1) if mutual else None,
        r(c, (2 if mutual else 1) * c, k=0.5 * s_in), r(c, k=0.1),
        r((2 * twd - 1) * 225, nh),
        torch.from_numpy(sine_position_encoding(8, 8, c // 2)).to(device)
        if mutual else None,
        1 + r(c, k=0.1), r(c, k=0.1), 1 + r(c, k=0.1), r(c, k=0.1),
        r(hid, c, k=s_in), r(hid, k=0.1), r(hid, c, k=s_in), r(hid, k=0.1),
        r(c, hid, k=0.5 * hid ** -0.5), r(c, k=0.1))


def without_3d_mask(fn):
    """fn() with the composed 3-D blocks' shift mask replaced by zeros."""
    import torch
    from kair_tpu_torch.ops import window3d
    with_mask = window3d._mask_on
    window3d._mask_on = lambda dhw, ws, ss, dev: torch.zeros_like(
        with_mask(dhw, ws, ss, dev))
    try:
        return fn()
    finally:
        window3d._mask_on = with_mask


def win3d_weight_bytes(p) -> int:
    """Bytes of a block's parameters as the kernels read them: bf16
    matrices, f32 vectors and table."""
    mats = ("qkv_self_weight", "qkv_mut_weight", "proj_weight", "fc11_weight",
            "fc12_weight", "fc2_weight")
    return sum((2 if k in mats else 4) * t.numel()
               for k, t in p._asdict().items() if t is not None)


# the window blocks' pass kernels (csrc/window3d_wgmma.cu), by name prefix
WIN3D_PASSES = ("tmsa_", "self_", "stl2_")


def win3d_timing(ph, what: str, fn, tokens: int, flops_per_token: float,
                 weight_bytes: int, c: int) -> dict:
    """One call's time (median of 10 CUDA-event launches), TFLOP/s, bound
    and each pass's device time (torch.profiler) of a VRT window block."""
    ms = cuda_ms(fn)
    flops = tokens * flops_per_token
    bms, by = bound_ms(flops, 2 * 2 * tokens * c + weight_bytes)
    passes = bwd_pass_times(fn)
    ph.note(f"{what}: kernel {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s; "
            f"bound {bms:.4f} ms ({by}, {flops / 1e9:.2f} GFLOP), "
            f"{bms / ms:.4f} of it; passes " + ", ".join(
                f"{k} {v:.4f}" for k, v in passes.items()))
    return dict(ms=ms, bound_ms=bms, bound_by=by)


def phase_tmsa(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.win3d import pack_win3d_stages
    from kair_tpu_torch.ops.kernels.tmsa_block import (tmsa_block,
                                                       tmsa_block_reference)
    from kair_tpu_torch.utils.summary import tmsa_block_flops_per_token

    c, nh = 120, 6
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 13)
    p = win3d_params(c, nh, 2, True, gen, dev)
    pk = pack_win3d_stages(p, nh)
    x = torch.randn(1, 6, 64, 64, c, generator=gen).to(dev, bf)
    x4 = torch.randn(1, 6, 8, 8, c, generator=gen).to(dev, bf)
    xodd = torch.randn(1, 4, 40, 72, c, generator=gen).to(dev, bf)
    x8 = torch.randn(8, 6, 64, 64, c, generator=gen).to(dev, bf)
    tol = 1e-2
    with Phase("13 tmsa") as ph:
        ph.note(f"TMSA mutual block kernel (wgmma, csrc/window3d_wgmma.cu), "
                f"(2,8,8) windows, C={c} nh={nh} hidden {2 * c} bf16; limit "
                f"max_abs <= {tol} * max|ref| against the f32 plain version "
                "on the same bf16 inputs; control: the shifted cases' plain "
                "version without the mask")
        errs = []
        for xin, shift in ((x, (0, 0, 0)), (x, (1, 4, 4)), (x4, (1, 0, 0)),
                           (xodd, (1, 4, 4)), (x8, (1, 4, 4))):
            got = tmsa_block(xin, p, nh, shift, packed=pk)
            ref = tmsa_block_reference(xin.float(), p, nh, shift)
            torch.cuda.synchronize()
            control = None if not any(shift) else without_3d_mask(
                lambda: tmsa_block_reference(xin.float(), p, nh, shift))
            errs.append(check_case(ph, f"{tuple(xin.shape[:4])} shift {shift}",
                                   got, ref, tol, control))
            del got, ref, control
        fpt, wbytes = tmsa_block_flops_per_token(c), win3d_weight_bytes(p)
        t1 = win3d_timing(ph, "B=1 stage 1 (1x6x64x64, shift (1,4,4))",
                          lambda: tmsa_block(x, p, nh, (1, 4, 4), packed=pk),
                          x.numel() // c, fpt, wbytes, c)
        win3d_timing(ph, "B=8 stage 1 (8x6x64x64, the training step's call)",
                     lambda: tmsa_block(x8, p, nh, (1, 4, 4), packed=pk),
                     x8.numel() // c, fpt, wbytes, c)
        ms4 = cuda_ms(lambda: tmsa_block(x4, p, nh, (1, 0, 0), packed=pk))
        plain_ms = cuda_ms(lambda: tmsa_block_reference(
            x.float(), p, nh, (1, 4, 4)), warmup=1, reps=5)
        ph.note(f"{ms4:.4f} ms at stage 4 (1x6x8x8); plain f32 (B=1 stage 1) "
                f"{plain_ms:.3f} ms")
    report.append(dict(
        name="tmsa_block", route="cuda",
        source="kair_tpu_torch/csrc/window3d_wgmma.cu",
        replaces="kair_tpu/ops/pallas/tmsa_block.py:253",
        launches=None, max_abs_err=max(errs), plain_ms=plain_ms,
        library_ms=None, **t1))


def phase_self6(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.self6_block import (self6_block,
                                                        self6_block_reference)
    from kair_tpu_torch.ops.kernels.win3d import pack_win3d_stages
    from kair_tpu_torch.utils.summary import self_block_flops_per_token

    nh = 6
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 14)
    p120 = win3d_params(120, nh, 6, False, gen, dev)
    p180 = win3d_params(180, nh, 6, False, gen, dev)
    p180_1 = win3d_params(180, nh, 1, False, gen, dev)
    x120 = torch.randn(1, 6, 64, 64, 120, generator=gen).to(dev, bf)
    x180 = torch.randn(1, 6, 64, 64, 180, generator=gen).to(dev, bf)
    x2 = torch.randn(1, 2, 64, 64, 120, generator=gen).to(dev, bf)
    x8_120 = torch.randn(8, 6, 64, 64, 120, generator=gen).to(dev, bf)
    x8_180 = torch.randn(8, 6, 64, 64, 180, generator=gen).to(dev, bf)
    packs = {id(p): pack_win3d_stages(p, nh) for p in (p120, p180, p180_1)}
    tol = 1e-2
    with Phase("14 self6") as ph:
        ph.note(f"self-attention (wd,8,8) block kernel (wgmma, "
                f"csrc/window3d_wgmma.cu), {nh} heads, hidden 2C, bf16; limit "
                f"max_abs <= {tol} * max|ref| against the f32 plain version; "
                "control: the shifted cases without the mask")
        errs = []
        for xin, p, wd, shift in (
                (x120, p120, 6, (0, 4, 4)), (x120, p120, 6, (0, 0, 0)),
                (x180, p180, 6, (0, 4, 4)), (x180, p180, 6, (0, 0, 0)),
                (x180, p180_1, 1, (0, 4, 4)), (x180, p180_1, 1, (0, 0, 0)),
                (x2, p120, 2, (0, 4, 4)), (x8_120, p120, 6, (0, 4, 4)),
                (x8_180, p180, 6, (0, 4, 4))):
            got = self6_block(xin, p, nh, wd, shift, packed=packs[id(p)])
            ref = self6_block_reference(xin.float(), p, nh, wd, shift)
            torch.cuda.synchronize()
            control = None if not any(shift) else without_3d_mask(
                lambda: self6_block_reference(xin.float(), p, nh, wd, shift))
            errs.append(check_case(
                ph, f"{tuple(xin.shape)} wd {wd} shift {shift}", got, ref, tol,
                control))
            del got, ref, control
        timed = {}
        for what, xin, p, wd in (
                ("C=180 wd 6 B=1 (stage 8, 1x6x64x64)", x180, p180, 6),
                ("C=120 wd 6 B=1", x120, p120, 6),
                ("C=180 wd 1 B=1", x180, p180_1, 1),
                ("C=120 wd 6 B=8 (stage 1, the training step's call)",
                 x8_120, p120, 6),
                ("C=180 wd 6 B=8 (stage 8, the training step's call)",
                 x8_180, p180, 6)):
            c = xin.shape[-1]
            pk = packs[id(p)]
            timed[what] = win3d_timing(
                ph, what, lambda: self6_block(xin, p, nh, wd, (0, 4, 4),
                                              packed=pk),
                xin.numel() // c, self_block_flops_per_token(c, wd),
                win3d_weight_bytes(p), c)
        plain_ms = cuda_ms(lambda: self6_block_reference(
            x180.float(), p180, nh, 6, (0, 4, 4)), warmup=1, reps=5)
        ph.note(f"plain f32 (C=180 wd 6 B=1) {plain_ms:.3f} ms")
    report.append(dict(
        name="self6_block", route="cuda",
        source="kair_tpu_torch/csrc/window3d_wgmma.cu",
        replaces="kair_tpu/ops/pallas/self6_block.py:203",
        launches=None, max_abs_err=max(errs), plain_ms=plain_ms,
        library_ms=None, **timed["C=180 wd 6 B=1 (stage 8, 1x6x64x64)"]))


# (what, N, H, W, Cin, Cout, dg): VRT-001's DCN call (cg 10) at its four map
# sizes at N=1 (all four split their tiles' groups over blocks) and stage 1
# at the training step's B=8 (no split); presets 003-004 (cg 15) and 005-008
# (cg 6) at stage 1, preset 002 (cg 15, 24 groups) at 32x32; an odd map with
# a ragged last tile and Cout past one column tile
DCN_CASES = (
    ("VRT-001 stage 1 64x64", 1, 64, 64, 120, 120, 12),
    ("VRT-001 32x32", 1, 32, 32, 120, 120, 12),
    ("VRT-001 16x16", 1, 16, 16, 120, 120, 12),
    ("VRT-001 8x8", 1, 8, 8, 120, 120, 12),
    ("VRT-001 stage 1 B=8", 8, 64, 64, 120, 120, 12),
    ("cg 15 (Cin 240, dg 16) 64x64", 1, 64, 64, 240, 120, 16),
    ("cg 15 (Cin 360, dg 24) 32x32", 1, 32, 32, 360, 120, 24),
    ("cg 6 (Cin 96, dg 16) 64x64", 1, 64, 64, 96, 96, 16),
    ("cg 8, Cout 72, 1x20x28", 1, 20, 28, 24, 72, 3),
)


def dcn_inputs(n, h, w, cin, cout, dg, gen, dev):
    """Seeded DCN inputs on the card: bf16 x; offsets up to ±6 px with
    fractions (taps fall outside the frame and between pixels); the mask
    after a sigmoid; an f32 weight scaled to keep the output near 1."""
    import torch
    x = torch.randn(n, h, w, cin, generator=gen).to(dev, torch.bfloat16)
    off = (torch.rand(n, h, w, dg * 18, generator=gen) * 12 - 6).to(dev)
    mask = torch.sigmoid(torch.randn(n, h, w, dg * 9, generator=gen)).to(dev)
    weight = (torch.randn(cout, cin, 3, 3, generator=gen)
              * (9 * cin) ** -0.5).to(dev)
    bias = (torch.randn(cout, generator=gen) * 0.1).to(dev)
    return x, off, mask, weight, bias


def phase_dcn(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.dcn_block import (dcn_fused, dcn_reference,
                                                      dcn_splits,
                                                      pack_dcn_weight)
    from kair_tpu_torch.utils.summary import dcn_flops_per_pixel

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 15)
    tol = 1e-2
    with Phase("15 dcn") as ph:
        ph.note(f"DCNv2 kernel (wgmma), bf16 x, f32 offsets (up to ±6 px) and "
                f"mask; limit max_abs <= {tol} * max|ref| against the composed "
                "gather route in f32 on the same inputs; control: the same "
                "conv with the offsets dropped")
        errs, times = [], {}
        for what, n, h, w, cin, cout, dg in DCN_CASES:
            x, off, mask, weight, bias = dcn_inputs(n, h, w, cin, cout, dg,
                                                    gen, dev)
            pk = pack_dcn_weight(weight, dg)
            tiles, splits = dcn_splits(n, h, w, cin, dg, sms)
            fy = (torch.arange(h, device=dev)[None, :, None, None] - 1
                  + off[..., 0::2])
            outside = ((fy <= -1) | (fy >= h)).float().mean().item()
            got = dcn_fused(x, off, mask, weight, bias, dg, packed=pk)
            ref = dcn_reference(x.float(), off, mask, weight, bias, dg)
            control = dcn_reference(x.float(), torch.zeros_like(off), mask,
                                    weight, bias, dg)
            torch.cuda.synchronize()
            errs.append(check_case(
                ph, f"{what} ({n}x{h}x{w}, {cin}->{cout}, dg {dg}; {tiles} "
                f"tiles x {splits} splits; {outside:.3f} of the y taps outside "
                "the frame)", got, ref, tol, control))
            if n == 1 and (cin, dg) == (120, 12) or n == 8:
                fn = lambda: dcn_fused(x, off, mask, weight, bias, dg,
                                       packed=pk)
                ms = cuda_ms(fn, warmup=3, reps=20)
                dev_ms = sum(bwd_pass_times(fn, 20).values())
                flops = n * h * w * dcn_flops_per_pixel(cin, cout)
                nbytes = (2 * x.numel() + 4 * (off.numel() + mask.numel() + cout)
                          + 2 * weight.numel() + 2 * n * h * w * cout)
                bms, by = bound_ms(flops, nbytes)
                times[what] = dict(ms=ms, bound_ms=bms, bound_by=by,
                                   device_ms=dev_ms)
                if what == DCN_CASES[0][0]:
                    plain_ms = cuda_ms(lambda: dcn_reference(
                        x.float(), off, mask, weight, bias, dg), warmup=1,
                        reps=5)
        ph.note("kernel ms (a call's CUDA-event time, median of 20, the "
                "wrapper's host time included; and the device time of its "
                "kernels, torch.profiler over 20 calls; splits on this card's "
                f"{sms} SMs): " + ", ".join(
                    f"{k} {v['ms']:.4f}, device {v.pop('device_ms'):.4f} "
                    f"(bound {v['bound_ms']:.4f}, {v['bound_by']})"
                    for k, v in times.items()))
        # VRT-001's 70 calls a clip: 20 at each of 64, 32 and 16, 10 at 8
        clip = sum(k * times[f"VRT-001 {s}"]["ms"] for k, s in (
            (20, "stage 1 64x64"), (20, "32x32"), (20, "16x16"), (10, "8x8")))
        ph.note(f"VRT-001's 70 calls from these CUDA-event times: {clip:.3f} "
                f"ms a clip; plain f32 at stage 1 {plain_ms:.3f} ms")
    report.append(dict(
        name="dcn_fused", route="cuda",
        source="kair_tpu_torch/csrc/dcn_block.cu",
        replaces="kair_tpu/ops/pallas/dcn_block.py:140",
        launches=None, max_abs_err=max(errs), plain_ms=plain_ms,
        library_ms=None, **times[DCN_CASES[0][0]]))


# KAIR 001_VRT_videosr_bi_REDS_6frames (main_test_vrt.py:158-165), through
# cli.test_video.build_task; weights drawn so every block moves the output
# and the shift mask matters (KAIR's init, Linear std 0.02, leaves the 80
# blocks near the identity and the attention near uniform), and so the
# head's output is not small against the bilinear base
VRT_TASK = "001_VRT_videosr_bi_REDS_6frames"
VRT_INIT = {  # suffix: (mean, std · fan_in^-½) for weights, (mean, std)
    "attn.qkv_self.weight": (0.0, 1.2), "attn.qkv_mut.weight": (0.0, 1.2),
    "attn.qkv_self.bias": (0.0, 0.1), "attn.qkv_mut.bias": (0.0, 0.1),
    "attn.proj.weight": (0.0, 0.7), "attn.proj.bias": (0.0, 0.05),
    "attn.relative_position_bias_table": (0.0, 1.0),
    "norm1.weight": (1.0, 0.1), "norm1.bias": (0.0, 0.1),
    "norm2.weight": (1.0, 0.1), "norm2.bias": (0.0, 0.1),
    "mlp.fc11.weight": (0.0, 0.25), "mlp.fc12.weight": (0.0, 0.25),
    "mlp.fc2.weight": (0.0, 0.2), "conv_offset.6.weight": (0.0, 0.01),
    "conv_offset.6.bias": (0.0, 0.1), "conv_last.weight": (0.0, 0.3)}
# conv weights take their std as it is (the head's widths are fixed)
_FAN_IN_SCALED = ("qkv_self.weight", "qkv_mut.weight", "proj.weight",
                  "fc11.weight", "fc12.weight", "fc2.weight")


def vrt_state_dict(seed: int) -> dict:
    """A seeded KAIR-keyed state dict of VRT-001."""
    import torch
    from kair_tpu_torch.cli.test_video import VRT_TASKS
    from kair_tpu_torch.models.vrt import VRT
    torch.manual_seed(seed)
    model = VRT(**VRT_TASKS[VRT_TASK])
    gen = torch.Generator().manual_seed(seed + 1)
    sd = model.state_dict()
    for k, v in sd.items():
        for suffix, (mean, std) in VRT_INIT.items():
            if k.endswith(suffix):
                if suffix.endswith(_FAN_IN_SCALED):
                    std = std / math.sqrt(v.shape[1])
                sd[k] = mean + std * torch.randn(v.shape, generator=gen)
    return sd


def moving_clip(frames: int, h: int, w: int, seed: int):
    """(1, frames, h, w, 3) f32: a smooth image panned 2 px down and 1 px
    right per frame, with a little noise, so the flows are not zero."""
    import numpy as np
    img = smooth_image(h + 2 * frames, w + frames, seed) / 255.0
    clip = np.stack([img[2 * t:2 * t + h, t:t + w] for t in range(frames)])
    rng = np.random.RandomState(seed)
    clip = np.clip(clip + rng.normal(0, 2 / 255, clip.shape), 0, 1)
    return clip[None].astype(np.float32)


def vrt_stages(model) -> tuple:
    """VRT's stage outputs, for where an error arises: stage1-7, the
    stage-8 head and groups, the final norm."""
    return (*(f"stage{i}" for i in range(1, 8)), "stage8.0.2",
            *(f"stage8.{i}" for i in range(1, len(model.stage8))), "norm")


def phase_vrt(report: list, card: str) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.cli.test_video import VRT_TASKS, build_task
    from kair_tpu_torch.models import vrt as mvrt
    from kair_tpu_torch.ops.blocks import resize_bilinear
    from kair_tpu_torch.ops.kernels import dcn_block, self6_block, tmsa_block
    from kair_tpu_torch.ops.warp import modulated_deform_conv
    from kair_tpu_torch.utils.summary import peak_bf16_tflops, vrt_flops_per_clip

    tol, tol_res = 2e-2, 5e-2
    with Phase("16 vrt") as ph, tempfile.TemporaryDirectory() as tmp:
        cfg = VRT_TASKS[VRT_TASK]
        sd = vrt_state_dict(SEED + 16)
        path = os.path.join(tmp, "vrt001.pth")
        torch.save({"params": sd}, path)
        fwd, sf, ws, _ = build_task(VRT_TASK, path)
        model = fwd.model
        off6 = model.stage1.pa_deform.conv_offset[6].weight
        require(off6.abs().max().item() > 0, "pa_deform.conv_offset.6 is zero")
        ph.note(f"KAIR {VRT_TASK} (embed 120/180, depths 8x7 + 4x6, 6 heads, "
                "window (6,8,8), dg 12, pa_frames 2) from a seeded KAIR state "
                "dict (.pth) through cli.test_video.build_task, bf16 on cuda, "
                "SpyNet f32; conv_offset.6 nonzero: the offsets leave the "
                "flows and the mask leaves 0.5")
        lr = moving_clip(6, 64, 64, SEED + 17)
        xg = torch.from_numpy(lr).cuda()
        for f in (tmsa_block.tmsa_block, self6_block.self6_block,
                  dcn_block.dcn_fused):
            f.launches = 0
        mvrt.TMSA.composed_calls = 0
        modulated_deform_conv.composed_calls = 0
        out = fwd(lr)
        torch.cuda.synchronize()
        counts = dict(tmsa=tmsa_block.tmsa_block.launches,
                      self6=self6_block.self6_block.launches,
                      dcn=dcn_block.dcn_fused.launches,
                      composed_tmsa=mvrt.TMSA.composed_calls,
                      composed_deform=modulated_deform_conv.composed_calls)
        ph.note(f"launches in one 1x6x64x64 forward: {counts}")
        require(counts == dict(tmsa=42, self6=38, dcn=70, composed_tmsa=0,
                               composed_deform=0), f"launch counts {counts}")
        for k in report:
            k["launches"] = {"tmsa_block": counts["tmsa"],
                             "self6_block": counts["self6"],
                             "dcn_fused": counts["dcn"]}.get(k["name"],
                                                             k["launches"])
        require(out.shape == (1, 6, 256, 256, 3) and np.isfinite(out).all(),
                f"output {out.shape} or non-finite values")

        cpu = mvrt.VRT(**cfg)
        cpu.load_state_dict(sd, strict=True)
        cpu.eval()
        x = torch.from_numpy(lr)
        with stage_outputs(cpu, vrt_stages(cpu)) as ref_outs, torch.no_grad():
            ref = cpu(x)
        with torch.no_grad():
            control = without_3d_mask(lambda: cpu(x))
        base = resize_bilinear(x.reshape(6, 64, 64, 3), (256, 256)).reshape(
            1, 6, 256, 256, 3)
        got = torch.from_numpy(out)
        # where the error arises, stage by stage (each of its own max)
        with stage_outputs(model, vrt_stages(model)) as gpu_outs:
            fwd(lr)
        ph.note("error after each stage, of its own max: " + ", ".join(
            f"{n} {compare(gpu_outs[n], ref_outs[n])[1]:.4f}" for n in ref_outs))
        e_abs = check_case(ph, "1x6x64x64 output", got, ref, tol, control)
        r_abs, r_rel, r_max, _ = compare(got - base, ref - base)
        c_res = (control - ref).abs().max().item() / r_max
        ph.note(f"out - base: max_abs {r_abs:.4g} max_rel {r_rel:.4g} (max|ref - "
                f"base| {r_max:.3g}); mask effect max_rel {c_res:.4g}")
        require(r_rel <= tol_res, f"out - base max_rel {r_rel:.4g} > {tol_res}")
        require(c_res > tol_res and c_res > 3 * r_rel,
                "the dropped-mask control is not above the out - base limit")

        with torch.inference_mode():
            ms = cuda_ms(lambda: model(xg), warmup=2, reps=10)
        flops = vrt_flops_per_clip()
        peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
        tflops = flops / (ms / 1e3) / 1e12
        ph.note(f"ms_per_clip {ms:.2f} (CUDA events, median of 10 after 2 "
                f"warm-up), {6 * 64 * 64 / (ms / 1e3) / 1e6:.4f} LR frame-MP/s, "
                f"{flops / 1e12:.3f} TFLOP per clip (utils/summary), "
                f"{tflops:.1f} TFLOP/s, MFU "
                f"{'n/a' if not peak else f'{tflops / peak:.4f}'} [{card}]")

        def two_clips():
            with torch.inference_mode():
                model(xg)
                model(xg)
        ph.note(device_breakdown(two_clips, 2, ms, "clip", host=True, top=12,
                                 sums=WIN3D_PASSES + ("dcn_",)))


# ---------------------------------------------------------------------------
# RVRT video SR (phases 17-19)
# ---------------------------------------------------------------------------

def stl_params(c: int, nh: int, twd: int, gen, device):
    """Seeded f32 weights of one RVRT STL block (self-only, plain MLP), as
    ``win3d_params`` draws them."""
    p = win3d_params(c, nh, twd, False, gen, device)
    return p._replace(fc12_weight=None, fc12_bias=None)


def phase_stl2(report: list) -> None:
    import torch
    from kair_tpu_torch.models.vrt import TMSA
    from kair_tpu_torch.ops.kernels.stl2_block import (stl2_block,
                                                       stl2_block_reference)
    from kair_tpu_torch.ops.kernels.win3d import pack_win3d_stages
    from kair_tpu_torch.ops.window3d import tmsa_composed
    from kair_tpu_torch.utils.summary import stl_block_flops_per_token

    nh = 6
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 17)
    p144 = stl_params(144, nh, 2, gen, dev)
    p192 = stl_params(192, nh, 2, gen, dev)
    p1 = stl_params(144, nh, 1, gen, dev)
    x = torch.randn(1, 2, 64, 64, 144, generator=gen).to(dev, bf)
    x4 = torch.randn(1, 4, 32, 48, 144, generator=gen).to(dev, bf)
    x192 = torch.randn(1, 2, 64, 64, 192, generator=gen).to(dev, bf)
    x8 = torch.randn(1, 8, 64, 64, 144, generator=gen).to(dev, bf)
    tol = 1e-2
    with Phase("17 stl2") as ph:
        ph.note(f"RVRT STL2 block kernel, (2,8,8) windows, {nh} heads, hidden "
                f"2C, plain GELU MLP, bf16; limit max_abs <= {tol} * max|ref| "
                "against the f32 plain version (max-subtracted softmax) on the "
                "same bf16 inputs; control: the shifted cases without the mask")
        errs = []
        for xin, p, shift in ((x, p144, (0, 4, 4)), (x, p144, (0, 0, 0)),
                              (x4, p144, (1, 4, 4)), (x192, p192, (0, 4, 4))):
            got = stl2_block(xin, p, nh, shift,
                             packed=pack_win3d_stages(p, nh))
            ref = stl2_block_reference(xin.float(), p, nh, shift)
            torch.cuda.synchronize()
            control = None if not any(shift) else without_3d_mask(
                lambda: stl2_block_reference(xin.float(), p, nh, shift))
            errs.append(check_case(
                ph, f"{tuple(xin.shape)} shift {shift}", got, ref, tol, control))
        # the (1,8,8) STL blocks: the 2-D Swin block kernel on the 8 frames,
        # through the model's route, against the 3-D composed block
        blk = TMSA(144, nh, (1, 8, 8), (0, 4, 4), mut_attn=False, geglu=False)
        a, m = blk.attn, blk.mlp
        with torch.no_grad():
            for dst, src in ((a.qkv_self.weight, p1.qkv_self_weight),
                             (a.qkv_self.bias, p1.qkv_self_bias),
                             (a.proj.weight, p1.proj_weight),
                             (a.proj.bias, p1.proj_bias),
                             (a.relative_position_bias_table, p1.rel_table),
                             (blk.norm1.weight, p1.norm1_weight),
                             (blk.norm1.bias, p1.norm1_bias),
                             (blk.norm2.weight, p1.norm2_weight),
                             (blk.norm2.bias, p1.norm2_bias),
                             (m.fc1.weight, p1.fc11_weight),
                             (m.fc1.bias, p1.fc11_bias),
                             (m.fc2.weight, p1.fc2_weight),
                             (m.fc2.bias, p1.fc2_bias)):
                dst.copy_(src)
        blk = blk.to(dev, bf).eval()
        pb = blk.params()
        with torch.inference_mode():
            got = blk(x8)
        ref = tmsa_composed(x8.float(), pb.float(), nh, (1, 8, 8), (0, 4, 4))
        control = without_3d_mask(lambda: tmsa_composed(
            x8.float(), pb.float(), nh, (1, 8, 8), (0, 4, 4)))
        check_case(ph, "(1,8,8) block on 1x8x64x64 C=144 through swin_block_2d "
                   "(3-D table), shift (0,4,4)", got, ref, tol, control)
        pk = pack_win3d_stages(p144, nh)
        ms = cuda_ms(lambda: stl2_block(x, p144, nh, (0, 4, 4), packed=pk))
        passes = bwd_pass_times(
            lambda: stl2_block(x, p144, nh, (0, 4, 4), packed=pk), 20)
        plain_ms = cuda_ms(lambda: stl2_block_reference(
            x.float(), p144, nh, (0, 4, 4)), warmup=1, reps=5)
        tokens = x.numel() // 144
        flops = tokens * stl_block_flops_per_token(144, 128)
        nbytes = 2 * 2 * tokens * 144 + win3d_weight_bytes(p144)
        bms, by = bound_ms(flops, nbytes)
        with torch.inference_mode():
            ms1 = cuda_ms(lambda: blk(x8))
        ph.note(f"kernel {ms:.4f} ms (1x2x64x64 C=144 shifted, RVRT-001's call, "
                f"median of 10); plain f32 {plain_ms:.3f} ms; bound {bms:.4f} ms "
                f"({by}, {flops / 1e9:.3f} GFLOP), {bms / ms:.4f} of it; "
                f"{flops / ms / 1e9:.1f} TFLOP/s; device time of the passes "
                f"(torch.profiler, 20 calls) {sum(passes.values()):.4f} ms: "
                + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
                + f"; (1,8,8) block on 1x8x64x64 through swin_block_2d "
                f"{ms1:.4f} ms")
    report.append(dict(
        name="stl2_block", route="cuda",
        source="kair_tpu_torch/csrc/window3d_wgmma.cu",
        replaces="kair_tpu/ops/pallas/stl_block.py:110",
        launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))


def gda_offsets(kind: str, bq: int, clip: int, h: int, w: int, dg: int,
                taps: int, gen, dev):
    """(bq, clip, h, w, dg·taps·2) f32 offsets: "random" uniform over ±12
    px (taps outside the frame and between pixels); "flow" one smooth flow
    of up to ±8 px a (query frame, clip slot), the same for every group and
    tap, plus a residual uniform over ±1 px, as RVRT's 10·tanh(·) + flow
    gives (models/rvrt.py)."""
    import torch
    if kind == "random":
        return (torch.rand(bq, clip, h, w, dg * taps * 2, generator=gen) * 24
                - 12).to(dev)
    yy = torch.linspace(0, 1, h)[:, None]
    xx = torch.linspace(0, 1, w)[None, :]
    ph = torch.rand(bq, clip, 2, 3, generator=gen) * 6.283
    flow = torch.stack([
        torch.sin(3.1 * yy + 1.7 * xx + ph[:, :, d, 0, None, None])
        + 0.5 * torch.sin(5.3 * xx - 2.9 * yy + ph[:, :, d, 1, None, None])
        + 0.3 * torch.cos(7.1 * yy + ph[:, :, d, 2, None, None])
        for d in range(2)], -1)                      # (bq, clip, h, w, 2)
    flow = flow / flow.abs().amax(dim=(2, 3, 4), keepdim=True) * 8
    res = torch.rand(bq, clip, h, w, dg * taps, 2, generator=gen) * 2 - 1
    return (flow[:, :, :, :, None, :] + res).reshape(
        bq, clip, h, w, dg * taps * 2).to(dev)


def phase_gda(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.gda_block import (gda_fused, gda_plan,
                                                      gda_reference)
    from kair_tpu_torch.utils.summary import gda_flops_per_pixel

    b, t, clip = 1, 2, 2
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 18)
    tol = 1e-2
    # (what, H, W, C, groups, taps, offsets, timed): RVRT's calls, then the
    # kernel's other paths at small sizes: taps other than 3x3, and the
    # narrow vectors (4, 2 and 1 channels a thread) a group's width forces
    cases = (("RVRT-001's call, random", 64, 64, 288, 12, (3, 3), "random",
              True),
             ("RVRT-001's call, flow-like", 64, 64, 288, 12, (3, 3), "flow",
              True),
             ("cg 32 (C=192 presets), random", 64, 64, 384, 12, (3, 3),
              "random", True),
             ("the CLI tile's call, random", 128, 128, 288, 12, (3, 3),
              "random", True),
             ("1x3 taps, cg 24", 24, 20, 48, 2, (1, 3), "random", False),
             ("cg 12", 24, 20, 36, 3, (3, 3), "random", False),
             ("cg 10", 24, 20, 30, 3, (3, 3), "flow", False),
             ("cg 5", 24, 20, 20, 4, (3, 3), "random", False))
    first = None
    with Phase("18 gda") as ph:
        ph.note(f"GDA kernel (heads = groups, clip {clip}, {t} query frames "
                "a KV clip, un-rotated K/V), bf16 q/k/v, f32 offsets; limit "
                f"max_abs <= {tol} * max|ref| against the composed gather "
                "route in f32; control: the offsets dropped; times: device "
                "(torch.profiler, the mean launch of 10 calls) and CUDA "
                "events (median of 10, the wrapper's host time included)")
        for what, h, w, c2, dg, kern, kind, timed in cases:
            taps = kern[0] * kern[1]
            q = torch.randn(b * t, h, w, c2, generator=gen).to(dev, bf)
            k = torch.randn(b, clip, h, w, c2, generator=gen).to(dev, bf)
            v = torch.randn(b, clip, h, w, c2, generator=gen).to(dev, bf)
            off = gda_offsets(kind, b * t, clip, h, w, dg, taps, gen, dev)
            ky = (torch.arange(taps, device=dev) // kern[1]
                  - kern[0] // 2).repeat(clip * dg)
            fy = (torch.arange(h, device=dev)[None, None, :, None, None]
                  + ky.view(clip, dg * taps)[None, :, None, None, :]
                  + off[..., 0::2])
            outside = ((fy <= -1) | (fy >= h)).float().mean().item()
            frac = (off.frac().abs() > 0.01).float().mean().item()
            fn = lambda: gda_fused(q, k, v, off, kern, dg, dg)
            got = fn()
            ref = gda_reference(q.float(), k.float(), v.float(), off, kern,
                                dg, dg)
            control = gda_reference(q.float(), k.float(), v.float(),
                                    torch.zeros_like(off), kern, dg, dg)
            torch.cuda.synchronize()
            pl = gda_plan(c2, dg, h, w)
            err = check_case(ph, f"{what}, q {b * t}x{h}x{w}x{c2}, {kern[0]}x"
                             f"{kern[1]} taps, {pl.vec} channels a thread: "
                             f"{outside:.3f} of the y taps outside the frame, "
                             f"{frac:.3f} fractional", got, ref, tol, control)
            del ref, control
            if timed:
                ms = cuda_ms(fn)
                dev_ms = launch_device_ms(fn, "gda_")
                flops = b * t * h * w * gda_flops_per_pixel(c2, clip * taps)
                nbytes = (2 * (2 * q.numel() + k.numel() + v.numel())
                          + 4 * off.numel())
                bms, by = bound_ms(flops, nbytes, rate="fp32")
                note = (f"{what}: device "
                        + (f"{dev_ms:.4f} ms" if dev_ms else "not measured "
                           "(the profiler saw no launch)")
                        + f", events {ms:.4f} ms; bound {bms:.4f} ms ({by}: "
                        f"{flops / 1e9:.3f} GFLOP at the f32 rate, "
                        f"{nbytes / 1e6:.2f} MB), {bms / (dev_ms or ms):.4f} "
                        f"of it on {'device' if dev_ms else 'event'} time")
                if first is None:
                    plain_ms = cuda_ms(lambda: gda_reference(
                        q.float(), k.float(), v.float(), off, kern, dg, dg),
                        warmup=1, reps=5)
                    note += f"; plain f32 {plain_ms:.3f} ms"
                    first = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by)
                ph.note(note)
            del q, k, v, off, got
    report.append(dict(
        name="gda_fused", route="cuda",
        source="kair_tpu_torch/csrc/gda_block.cu",
        replaces="kair_tpu/ops/pallas/gda_block.py:178",
        launches=None, library_ms=None, **first))


# KAIR 001_RVRT_videosr_bi_REDS_30frames (main_test_rvrt.py:141-147) through
# cli.test_video.build_task, weights drawn as VRT_INIT draws them, the
# offset nets' last conv nonzero so the offsets leave the flows
RVRT_TASK = "001_RVRT_videosr_bi_REDS_30frames"
RVRT_INIT = {**{k: v for k, v in VRT_INIT.items() if not k.startswith(
                 ("mlp.", "conv_offset", "attn.qkv_mut"))},
             "mlp.fc1.weight": (0.0, 0.5), "mlp.fc2.weight": (0.0, 0.3),
             "conv_offset.10.weight": (0.0, 0.01),
             "conv_offset.10.bias": (0.0, 0.1)}
_RVRT_FAN_IN = _FAN_IN_SCALED + ("fc1.weight",)
RVRT_BRANCHES = ("feat_extract", "backbone.backward_1", "backbone.forward_1",
                 "backbone.backward_2", "backbone.forward_2", "reconstruction")


def rvrt_state_dict(seed: int) -> dict:
    """A seeded KAIR-keyed state dict of RVRT-001."""
    import torch
    from kair_tpu_torch.cli.test_video import RVRT_TASKS
    from kair_tpu_torch.models.rvrt import RVRT
    torch.manual_seed(seed)
    sd = RVRT(**RVRT_TASKS[RVRT_TASK]).state_dict()
    gen = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        for suffix, (mean, std) in RVRT_INIT.items():
            if k.endswith(suffix):
                if suffix.endswith(_RVRT_FAN_IN):
                    std = std / math.sqrt(v.shape[1])
                sd[k] = mean + std * torch.randn(v.shape, generator=gen)
    return sd


def without_rvrt_masks(fn):
    """fn() with the shift mask left out of RVRT's blocks: the composed 3-D
    blocks' and the (1, 8, 8) blocks' 2-D one."""
    from kair_tpu_torch.models import vrt as mvrt
    with_mask = mvrt.shift_mask_tensor
    mvrt.shift_mask_tensor = lambda *a: None
    try:
        return without_3d_mask(fn)
    finally:
        mvrt.shift_mask_tensor = with_mask


def phase_rvrt(report: list, card: str) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.cli.test_video import RVRT_TASKS, build_task
    from kair_tpu_torch.models import vrt as mvrt
    from kair_tpu_torch.models.rvrt import RVRT
    from kair_tpu_torch.ops.blocks import resize_bilinear
    from kair_tpu_torch.ops.deform_attn import deform_attention
    from kair_tpu_torch.ops.kernels import gda_block, stl2_block, swin_block
    from kair_tpu_torch.utils.summary import peak_bf16_tflops, rvrt_flops_per_clip

    tol, tol_res = 2e-2, 5e-2
    d, s = 8, 64
    with Phase("19 rvrt") as ph, tempfile.TemporaryDirectory() as tmp:
        cfg = RVRT_TASKS[RVRT_TASK]
        sd = rvrt_state_dict(SEED + 19)
        path = os.path.join(tmp, "rvrt001.pth")
        torch.save({"params": sd}, path)
        fwd, sf, ws, _ = build_task(RVRT_TASK, path)
        model = fwd.model
        ph.note(f"KAIR {RVRT_TASK} (embed 144, num_blocks (1,2,1), depths "
                "(2,2,2), 6 heads, window (2,8,8), clip 2, 12 groups = heads) "
                "from a seeded KAIR state dict (.pth) through cli.test_video."
                "build_task, bf16 on cuda, SpyNet and the offsets f32; "
                "conv_offset.10 nonzero: the offsets leave the flows")
        lr = moving_clip(d, s, s, SEED + 20)
        xg = torch.from_numpy(lr).cuda()
        # the main path: every count to 0 just before it, read just after
        for f, attr in ((swin_block.swin_block_2d, "launches"),
                        (swin_block.swin_block_2d, "launches_win"),
                        (stl2_block.stl2_block, "launches"),
                        (gda_block.gda_fused, "launches")):
            setattr(f, attr, 0)
        mvrt.TMSA.composed_calls = 0
        deform_attention.composed_calls = 0
        out = fwd(lr)
        torch.cuda.synchronize()
        counts = dict(swin=swin_block.swin_block_2d.launches,
                      swin_win=swin_block.swin_block_2d.launches_win,
                      stl2=stl2_block.stl2_block.launches,
                      gda=gda_block.gda_fused.launches,
                      composed_tmsa=mvrt.TMSA.composed_calls,
                      composed_deform=deform_attention.composed_calls)
        ph.note(f"launches in one 1x{d}x{s}x{s} forward: {counts}")
        require(counts == dict(swin=4, swin_win=0, stl2=64, gda=12,
                               composed_tmsa=0, composed_deform=0),
                f"launch counts {counts}")
        for k in report:
            k["launches"] = {"stl2_block": counts["stl2"],
                             "gda_fused": counts["gda"]}.get(k["name"],
                                                             k["launches"])
        require(out.shape == (1, d, 4 * s, 4 * s, 3) and np.isfinite(out).all(),
                f"output {out.shape} or non-finite values")

        cpu = RVRT(**cfg)
        cpu.load_state_dict(sd, strict=True)
        cpu.eval()
        x = torch.from_numpy(lr)
        with stage_outputs(cpu, RVRT_BRANCHES) as ref_outs, torch.no_grad():
            ref = cpu(x)
        with torch.no_grad():
            control = without_rvrt_masks(lambda: cpu(x))
        base = resize_bilinear(x.reshape(d, s, s, 3), (4 * s, 4 * s)).reshape(
            1, d, 4 * s, 4 * s, 3)
        got = torch.from_numpy(out)
        with stage_outputs(model, RVRT_BRANCHES) as gpu_outs:
            fwd(lr)
        ph.note("error after each branch (its last clip), of its own max: "
                + ", ".join(f"{n} {compare(gpu_outs[n], ref_outs[n])[1]:.4f}"
                            for n in ref_outs))
        check_case(ph, f"1x{d}x{s}x{s} output", got, ref, tol, control)
        r_abs, r_rel, r_max, _ = compare(got - base, ref - base)
        c_res = (control - ref).abs().max().item() / r_max
        ph.note(f"out - base: max_abs {r_abs:.4g} max_rel {r_rel:.4g} (max|ref - "
                f"base| {r_max:.3g}); mask effect max_rel {c_res:.4g}")
        require(r_rel <= tol_res, f"out - base max_rel {r_rel:.4g} > {tol_res}")
        require(c_res > tol_res and c_res > 3 * r_rel,
                "the dropped-mask control is not above the out - base limit")

        with torch.inference_mode():
            ms = cuda_ms(lambda: model(xg), warmup=2, reps=10)
        flops = rvrt_flops_per_clip(d, s, s)
        peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
        tflops = flops / (ms / 1e3) / 1e12
        ph.note(f"ms_per_clip {ms:.2f} (1x{d}x{s}x{s}, CUDA events, median of "
                f"10 after 2 warm-up), {d * s * s / (ms / 1e3) / 1e6:.4f} LR "
                f"frame-MP/s, {flops / 1e12:.4f} TFLOP per clip (utils/summary)"
                f", {tflops:.1f} TFLOP/s, MFU "
                f"{'n/a' if not peak else f'{tflops / peak:.4f}'} [{card}]")

        def two_clips():
            with torch.inference_mode():
                model(xg)
                model(xg)
        ph.note(device_breakdown(two_clips, 2, ms, "clip", host=True, top=12,
                                 sums=WIN3D_PASSES + ("gda_",)))
        # the CLI's default spatial tile (--tile 40 128 128 on 16 frames)
        xt = torch.from_numpy(moving_clip(16, 128, 128, SEED + 21)).cuda()
        torch.cuda.reset_peak_memory_stats()
        gda_block.gda_fused.launches = 0
        with torch.inference_mode():
            model(xt)
        ph.note(f"GDA launches in one 1x16x128x128 tile: "
                f"{gda_block.gda_fused.launches}")
        with torch.inference_mode():
            ms_t = cuda_ms(lambda: model(xt), warmup=0, reps=3)
        tflops_t = rvrt_flops_per_clip(16, 128, 128) / (ms_t / 1e3) / 1e12
        ph.note(f"1x16x128x128 tile: {ms_t:.2f} ms (median of 3), "
                f"{16 * 128 * 128 / (ms_t / 1e3) / 1e6:.4f} LR frame-MP/s, MFU "
                f"{'n/a' if not peak else f'{tflops_t / peak:.4f}'}; peak "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# ---------------------------------------------------------------------------
# VRT-001 training on the "mxu" alignment route (phases 20-21)
# ---------------------------------------------------------------------------

def bilin_coords(g: int, r: int, h: int, w: int, gen, device):
    """(fy, fx) f32 (G, R): mostly fractional taps over the frame and its
    zero ring, an eighth far outside, an eighth of the rows on exact
    integers (y on the first eighth, x on the second)."""
    import torch
    fy = torch.rand(g, r, generator=gen) * (h + 4) - 2.5
    fx = torch.rand(g, r, generator=gen) * (w + 4) - 2.5
    far = slice(r // 4, r // 4 + r // 8)
    fy[:, far] = fy[:, far] * 6 - 3 * h
    fx[:, far] = fx[:, far] * 6 - 3 * w
    fy[:, :r // 8] = fy[:, :r // 8].round()
    fx[:, r // 8:r // 4] = fx[:, r // 8:r // 4].round()
    return fy.to(device), fx.to(device)


def tap_major_coords(g: int, r: int, h: int, w: int, gen, device,
                     reach: float = 10.0):
    """(fy, fx) f32 (G, R = 9·H·W) as VRT's DCN samples a slab
    (ops/warp.deform_columns_mxu): rows tap-major, each tap's H·W output
    pixels in order, at the pixel plus its 3x3 tap (padding 1) plus an
    offset of up to ±reach px (VRT's max_residue_magnitude), drawn from the
    seed; an eighth of the rows on integer y, the next eighth on integer x."""
    import torch
    assert r == 9 * h * w
    tap = torch.arange(9)
    fy = (torch.arange(h, dtype=torch.float32)[None, :, None]
          + (tap // 3 - 1).float()[:, None, None]).expand(9, h, w).reshape(1, r)
    fx = (torch.arange(w, dtype=torch.float32)[None, None, :]
          + (tap % 3 - 1).float()[:, None, None]).expand(9, h, w).reshape(1, r)
    fy = fy + (torch.rand(g, r, generator=gen) * 2 - 1) * reach
    fx = fx + (torch.rand(g, r, generator=gen) * 2 - 1) * reach
    fy[:, :r // 8] = fy[:, :r // 8].round()
    fx[:, r // 8:r // 4] = fx[:, r // 8:r // 4].round()
    return fy.to(device), fx.to(device)


def phase_bilin(report: list) -> dict:
    """The bilinear sampler's forward and backward kernels against their
    plain version (f32 on the card) at VRT-001's stage-1 call at the option
    file's batch 8 (random coordinates over the frame, and VRT's own
    tap-major rows) and at an RVRT GDA call; returns the two report rows
    (VRT-001's call, random coordinates)."""
    import torch
    from kair_tpu_torch.ops.kernels.bilin_sample import (
        bilinear_bwd, bilinear_bwd_reference, bilinear_fwd, bilinear_reference,
        bwd_tiles, vector_bytes)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 20)
    limits = {torch.bfloat16: (1e-2, 2e-2), torch.float32: (1e-5, 1e-5)}
    shapes = (("VRT-001 stage 1, B=8 (12 groups of 120)", 96, 64, 64, 10,
               9 * 64 * 64, bilin_coords),
              ("VRT-001 stage 1, B=8, tap-major rows (offsets <= 10 px)", 96,
               64, 64, 10, 9 * 64 * 64, tap_major_coords),
              ("RVRT-001 GDA (k|v of a 24-channel group)", 48, 64, 64, 48,
               9 * 64 * 64, bilin_coords),
              ("odd Cs (2- and 4-byte vectors)", 24, 64, 64, 3, 9 * 64 * 64,
               bilin_coords))
    rows = {}
    with Phase("20 bilin") as ph:
        ph.note("limits: forward max_rel <= 1e-2 (bf16) / 1e-5 (f32), each "
                "backward tensor <= 2e-2 (bf16) / 1e-5 (f32) of its max|ref| "
                "against the plain version in f32 (dfeat is summed in f32 "
                "per pixel over a list whose order, set by integer atomics, "
                "varies from run to run); dfy (dfx) "
                "exactly 0 on integer y (x) rows; control: the plain version "
                "at coordinates moved by 0.37 px exceeds every limit")
        for what, g, h, w, cs, r, coords in shapes:
            fy, fx = coords(g, r, h, w, gen, dev)
            for dt in (torch.bfloat16, torch.float32):
                tol_f, tol_b = limits[dt]
                feat = torch.randn(g, h, w, cs, generator=gen).to(dev, dt)
                dout = torch.randn(g, r, cs, generator=gen).to(dev, dt)
                got = bilinear_fwd(feat, fy, fx)
                gb = bilinear_bwd(feat, fy, fx, dout)
                ref = bilinear_reference(feat.float(), fy, fx)
                rb = bilinear_bwd_reference(feat.float(), fy, fx, dout.float())
                moved = (bilinear_reference(feat.float(), fy + 0.37, fx + 0.37),
                         *bilinear_bwd_reference(feat.float(), fy + 0.37,
                                                 fx + 0.37, dout.float()))
                torch.cuda.synchronize()
                errs, ctrl = [], []
                for name, a, b, c, tol in zip(
                        ("out", "dfeat", "dfy", "dfx"), (got, *gb), (ref, *rb),
                        moved, (tol_f, tol_b, tol_b, tol_b)):
                    e_abs, e_rel, ref_max, _ = compare(a, b)
                    c_rel = (c - b).abs().max().item() / ref_max
                    require(e_rel <= tol, f"{what} {dt} {name}: max_rel "
                            f"{e_rel:.4g} > {tol}")
                    require(c_rel > tol and c_rel > 3 * e_rel,
                            f"{what} {dt} {name}: the moved-coordinate control "
                            f"{c_rel:.4g} is not above the limit and 3x the "
                            "error")
                    errs.append((name, e_abs, e_rel))
                    ctrl.append(c_rel)
                require(bool((gb[1][:, :r // 8] == 0).all())
                        and bool((gb[2][:, r // 8:r // 4] == 0).all()),
                        f"{what} {dt}: dfy/dfx not 0 on integer coordinates")
                ph.note(f"{what} G={g} {h}x{w} Cs={cs} R={r} {dt}: " + ", ".join(
                    f"{n} max_rel {e:.3g}" for n, _, e in errs)
                    + "; control max_rel " + "/".join(f"{c:.3g}" for c in ctrl))
                if dt != torch.bfloat16:
                    continue
                # times at the main path's type; the library yardstick is
                # F.grid_sample (bilinear, zeros, align_corners) and its
                # backward on the NCHW layout, its grid in the input's type
                # (it takes no other)
                ms_f = cuda_ms(lambda: bilinear_fwd(feat, fy, fx))
                ms_b = cuda_ms(lambda: bilinear_bwd(feat, fy, fx, dout))
                plain_f = cuda_ms(lambda: bilinear_reference(feat, fy, fx),
                                  warmup=1, reps=5)
                plain_b = cuda_ms(lambda: bilinear_bwd_reference(
                    feat, fy, fx, dout), warmup=1, reps=5)
                inp = feat.permute(0, 3, 1, 2).contiguous()
                grid = torch.stack([2 * fx / (w - 1) - 1, 2 * fy / (h - 1) - 1],
                                   -1)[:, None].to(dt).contiguous()
                gout = dout.permute(0, 2, 1)[:, :, None].contiguous()
                lib_f = cuda_ms(lambda: torch.nn.functional.grid_sample(
                    inp, grid, mode="bilinear", padding_mode="zeros",
                    align_corners=True))
                lib_b = cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                    gout, inp, grid, 0, 0, True, [True, True]))
                fb = feat.element_size()
                n_in = g * h * w * cs * fb + 2 * g * r * 4
                bytes_f = n_in + g * r * cs * fb
                bytes_b = n_in + g * r * cs * fb + g * h * w * cs * fb + 2 * g * r * 4
                ops_f = g * r * (8.0 * cs + 12)
                ops_b = g * r * (24.0 * cs + 12)
                (bf, byf), (bb, byb) = (bound_ms(ops_f, bytes_f, "fp32"),
                                        bound_ms(ops_b, bytes_b, "fp32"))
                vec = vector_bytes(cs, feat.element_size())
                tiles = bwd_tiles(g, h, w, cs, vec // feat.element_size(),
                                  feat.element_size())
                ph.note(f"{what}, bf16, {vec}-byte vectors, backward windows "
                        f"{tiles[0]}x{tiles[1]}x{tiles[2]}: forward {ms_f:.4f} ms (plain f32 "
                        f"{plain_f:.3f}, grid_sample {lib_f:.4f}, bound "
                        f"{bf:.4f} ({byf}, {bytes_f / 1e6:.1f} MB), {bf / ms_f:.4f} "
                        f"of it); backward {ms_b:.4f} ms (plain {plain_b:.3f}, "
                        f"grid_sampler_2d_backward {lib_b:.4f}, bound {bb:.4f} "
                        f"({byb}, {bytes_b / 1e6:.1f} MB), {bb / ms_b:.4f} of it)")
                if "fwd" not in rows:
                    rows["fwd"] = dict(
                        name="bilinear_fwd", route="cuda",
                        source="kair_tpu_torch/csrc/bilin_sample.cu",
                        replaces="kair_tpu/ops/pallas/bilin_mm.py:197",
                        launches=None, max_abs_err=errs[0][1], ms=ms_f,
                        plain_ms=plain_f, bound_ms=bf, bound_by=byf,
                        library_ms=lib_f)
                    rows["bwd"] = dict(
                        name="bilinear_bwd", route="cuda",
                        source="kair_tpu_torch/csrc/bilin_sample.cu",
                        replaces="kair_tpu/ops/pallas/bilin_mm.py:312",
                        launches=None,
                        max_abs_err=max(e for _, e, _ in errs[1:]), ms=ms_b,
                        plain_ms=plain_b, bound_ms=bb, bound_by=byb,
                        library_ms=lib_b)
    report += [rows["fwd"], rows["bwd"]]
    return rows


VRT_TRAIN_OPTION = "options/vrt/001_train_vrt_videosr_bi_reds_6frames.json"
# phase 21 (a): limits on the relative norm of the gradient error (over all
# parameters and over the flow group; at any one part of the network). Read
# on an H100 (PERF.md, PR 9): 0.0123 over all, 0.0263 over the flow group,
# 0.0636 at the worst part (stage 4); the control without the shift masks
# 0.160, 0.405 and 0.096-0.745 by part
TRAIN_GRAD_LIMITS = (5e-2, 1.5e-1)


def vrt_train_options(tmp: str, deform: str):
    """The shipped VRT-001 option file, parsed by the port, its output paths
    and clip folders moved into `tmp`, ``deform_impl`` set to `deform`."""
    from kair_tpu_torch import config
    raw = config.load_json_with_comments(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), VRT_TRAIN_OPTION))
    raw["path"]["root"] = os.path.join(tmp, "runs")
    train = raw["datasets"]["train"]
    train["dataroot_gt"] = os.path.join(tmp, "gt")
    train["dataroot_lq"] = os.path.join(tmp, "lq")
    train["meta_info_file"] = None
    del raw["datasets"]["test"]          # REDS4 is not in the repository
    raw["netG"]["deform_impl"] = deform
    path = os.path.join(tmp, f"vrt001_{deform}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return config.parse(path)


def seeded_clip_dataset(ds_opt, tmp: str, clips: int = 4, frames: int = 12,
                        size: int = 320):
    """The port's VideoRecurrentTrainDataset over `clips` seeded moving
    clips: empty frame files name the frames in `tmp` (the folder scan), and
    the ``read_uint`` hook draws each frame (the card has no cv2): a smooth
    image panned 2 px down and 1 px right per frame, the LQ frame its 4x4
    block mean."""
    import numpy as np
    from kair_tpu_torch.data.dataset_video import VideoRecurrentTrainDataset
    for sub in ("gt", "lq"):
        for c in range(clips):
            d = os.path.join(tmp, sub, f"{c:03d}")
            os.makedirs(d, exist_ok=True)
            for t in range(frames):
                open(os.path.join(d, f"{t:08d}.png"), "w").close()
    sf = ds_opt["scale"]

    class SeededClips(VideoRecurrentTrainDataset):
        cache: dict = {}
        images: dict = {}

        def read_uint(self, path):
            if path not in self.cache:
                parts = str(path).split(os.sep)
                sub, clip, t = parts[-3], int(parts[-2]), int(parts[-1][:8])
                if clip not in self.images:
                    self.images[clip] = smooth_image(size + 2 * frames,
                                                     size + frames,
                                                     SEED + 210 + clip)
                gt = self.images[clip][2 * t:2 * t + size, t:t + size]
                if sub == "lq":
                    gt = gt.reshape(size // sf, sf, size // sf, sf, 3).mean(
                        (1, 3)).round().astype(np.uint8)
                self.cache[path] = gt
            return self.cache[path]

    return SeededClips(ds_opt)


def param_groups_rel(a: dict, b: dict) -> dict:
    """The relative gradient norm by part of VRT: SpyNet, each stage, stage
    8, the rest; and over the flow group (spynet, pa_deform) and all."""
    parts = {}
    for n in b:
        head = n.split(".")[0]
        key = head if head.startswith(("stage", "spynet")) else "rest"
        parts.setdefault(key, []).append(n)
    out = {k: rel_norm(a, b, v) for k, v in sorted(parts.items())}
    out["flow group"] = rel_norm(a, b, [n for n in b
                                        if "spynet" in n or "deform" in n])
    out["all"] = rel_norm(a, b, list(b))
    return out


def model_grads(model, loss_fn, batch) -> dict:
    """f32 gradients of loss_fn(model(L), H) for every parameter (zeros where
    a parameter takes none)."""
    import torch
    model.zero_grad(set_to_none=True)
    dev = next(model.parameters()).device
    loss = loss_fn(model(torch.from_numpy(batch["L"]).to(dev)).float(),
                   torch.from_numpy(batch["H"]).to(dev))
    loss.backward()
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad)
            .detach().float().cpu() for n, p in model.named_parameters()}


def phase_vrt_train(report: list, card: str, build_dir) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch import config
    from kair_tpu_torch.cli.train import build_trainer
    from kair_tpu_torch.data.base import Loader
    from kair_tpu_torch.models import vrt as mvrt
    from kair_tpu_torch.models.registry import define_g
    from kair_tpu_torch.ops.kernels import (bilin_sample, dcn_block,
                                            self6_block, tmsa_block)
    from kair_tpu_torch.ops.warp import modulated_deform_conv
    from kair_tpu_torch.train.video import VideoTrainer
    from kair_tpu_torch.utils.summary import peak_bf16_tflops, vrt_flops_per_clip

    tol_global, tol_part = TRAIN_GRAD_LIMITS
    warmup, timed = 2, 3
    counters = ((tmsa_block.tmsa_block, "tmsa"), (self6_block.self6_block, "self6"),
                (bilin_sample.bilinear_fwd, "bilin_fwd"),
                (bilin_sample.bilinear_bwd, "bilin_bwd"),
                (dcn_block.dcn_fused, "dcn"))

    def zero_counts():
        for f, _ in counters:
            f.launches = 0
        mvrt.TMSA.composed_calls = 0
        modulated_deform_conv.composed_calls = 0

    def read_counts():
        out = {k: f.launches for f, k in counters}
        out["composed_tmsa"] = mvrt.TMSA.composed_calls
        out["composed_deform"] = modulated_deform_conv.composed_calls
        return out

    def timed_steps(trainer, batches, warmup=warmup, timed=timed):
        for bt in batches[:warmup]:
            trainer.train_step(bt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        losses = [trainer.train_step(bt)["G_loss"]
                  for bt in batches[warmup:warmup + timed]]
        e.record()
        torch.cuda.synchronize()
        counts = read_counts()
        vals = [float(v) for v in losses]
        require(all(math.isfinite(v) for v in vals), f"losses {vals}")
        return s.elapsed_time(e) / timed, counts, vals, \
            torch.cuda.max_memory_allocated()

    with Phase("21 vrt_train") as ph, \
            tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        opt = vrt_train_options(tmp, "mxu")
        ds_opt = opt["datasets"]["train"]
        bs, net, ot = ds_opt["dataloader_batch_size"], opt["netG"], opt["train"]
        trainer = build_trainer(opt, dtype=torch.bfloat16)
        require(isinstance(trainer, VideoTrainer), f"{type(trainer).__name__}")
        sd = vrt_state_dict(SEED + 21)
        trainer.model.load_state_dict(sd, strict=True)
        ph.note(f"{VRT_TRAIN_OPTION} through config.parse -> cli.train."
                f"build_trainer -> VideoTrainer, bf16 autocast over f32: embed "
                f"{net['embed_dims'][0]}x7 + {net['embed_dims'][-1]}x6, depths "
                f"{net['depths']}, window {net['window_size']}, dg "
                f"{net['deformable_groups']}, use_checkpoint_attn "
                f"{net['use_checkpoint_attn']}, deform_impl 'mxu' (the option "
                f"file's 'auto' in (e)); {ot['G_lossfn_type']}, Adam "
                f"{ot['G_optimizer_lr']}, fix_iter {ot['fix_iter']} over "
                f"{ot['fix_keys']} at x{ot['fix_lr_mul']}; "
                f"{sum(p.numel() for p in trainer.model.parameters())} params "
                "drawn by VRT_INIT (conv_offset.6 nonzero: fractional taps)")
        loader = Loader(seeded_clip_dataset(ds_opt, tmp), bs, seed=SEED)
        batches, epoch = [], 0
        while len(batches) < warmup + timed + 1:
            batches += [{k: v for k, v in bt.items() if isinstance(v, np.ndarray)}
                        for bt in loader.epoch(epoch)]
            epoch += 1
        gs, sf, nf = ds_opt["gt_size"], opt["scale"], ds_opt["num_frame"]
        require(batches[0]["L"].shape == (bs, nf, gs // sf, gs // sf, 3)
                and batches[0]["H"].shape == (bs, nf, gs, gs, 3),
                f"batch shapes {batches[0]['L'].shape} {batches[0]['H'].shape}")

        # (a) one gradient at B=1 against the f32 composed route on the card
        small = {k: v[:1] for k, v in batches[0].items()}
        g_card = grads_of(trainer, small)
        ref_opt = {**opt, "netG": {**net, "fuse_block": False,
                                   "deform_impl": "gather"}}
        ref = define_g(ref_opt).cuda().train()
        ref.load_state_dict(sd, strict=True)
        g_ref = model_grads(ref, trainer.loss_fn, small)
        g_ctrl = without_3d_mask(lambda: model_grads(ref, trainer.loss_fn, small))
        del ref
        err, ctrl = param_groups_rel(g_card, g_ref), param_groups_rel(g_ctrl, g_ref)
        worst = max((k for k in err if k not in ("all", "flow group")),
                    key=err.get)
        ph.note("(a) gradient at B=1, bf16 kernels vs the f32 composed route "
                "(fuse_block off, gather sampler) on the card, relative norm: "
                + ", ".join(f"{k} {v:.4g}" for k, v in err.items())
                + f" (limits {tol_global} over all and the flow group, "
                f"{tol_part} a part); control, the f32 route without the shift "
                "masks: " + ", ".join(f"{k} {v:.4g}" for k, v in ctrl.items()))
        require(err["all"] <= tol_global and err["flow group"] <= tol_global,
                f"gradient error {err['all']:.4g} / flow group "
                f"{err['flow group']:.4g} > {tol_global}")
        require(err[worst] <= tol_part, f"{worst}: {err[worst]:.4g} > {tol_part}")
        require(all(ctrl[k] > tol_global and ctrl[k] > 3 * err[k]
                    for k in ("all", "flow group")),
                "the dropped-mask control is not above the global limit and 3x "
                "the error, over all and over the flow group")

        # (b)-(d) the main path: timed steps on the mxu route
        flow = {n: p.detach().clone() for n, p in trainer.model.named_parameters()
                if "spynet" in n or "deform" in n}
        rest = {n: p.detach().clone() for n, p in trainer.model.named_parameters()
                if n not in flow}
        ms, counts, losses, mem = timed_steps(trainer, batches)
        per = {k: v // timed for k, v in counts.items()}
        want = dict(tmsa=84, self6=76, bilin_fwd=70, bilin_bwd=70, dcn=0,
                    composed_tmsa=0, composed_deform=0)
        ph.note(f"(b) launches per step over {timed} timed steps: {per} "
                "(TMSA and self: 42 + 38 forward and as many again in the "
                "remat recompute; their backward is the composed route's "
                "autograd)")
        require(per == want and all(v % timed == 0 for v in counts.values()),
                f"launch counts {counts} in {timed} steps, want {want} per step")
        for k in report:
            if k["name"] == "bilinear_fwd":
                k["launches"] = counts["bilin_fwd"]
            elif k["name"] == "bilinear_bwd":
                k["launches"] = counts["bilin_bwd"]
        lr_px = bs * nf * (gs // sf) ** 2
        flops = 3 * vrt_flops_per_clip(frames=nf, h=gs // sf, w=gs // sf) * bs
        peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
        mfu = flops / (ms / 1e3) / 1e12 / peak if peak else None
        ph.note(f"(c) mxu route, batch {bs} of {nf}x{gs // sf}x{gs // sf}: "
                f"losses {losses[0]:.4g} .. {losses[-1]:.4g}; ms_per_step "
                f"{ms:.2f} (mean of {timed} after {warmup} warm-up, CUDA "
                f"events), {bs / (ms / 1e3):.3f} clips/s, "
                f"{lr_px / (ms / 1e3) / 1e6:.4f} LR frame-MP/s, training MFU "
                f"{'n/a' if mfu is None else f'{mfu:.4f}'} (3x the "
                f"{flops / 3 / bs / 1e12:.3f} TFLOP forward per clip, "
                f"recompute not counted); peak memory {mem / 2 ** 30:.2f} GiB "
                f"[{card}]")
        params = dict(trainer.model.named_parameters())
        frozen = all(torch.equal(params[n], v) for n, v in flow.items())
        moved = sum(not torch.equal(params[n], v) for n, v in rest.items())
        ph.note(f"(d) after {warmup + timed} updates (fix_iter "
                f"{ot['fix_iter']}): {len(flow)} flow-group tensors bit-equal: "
                f"{frozen}; {moved} of {len(rest)} other tensors moved")
        require(frozen and moved == len(rest),
                "the flow group moved or another parameter did not")

        # (f) where a step's device time goes
        ph.note("(f) " + device_breakdown(
            lambda: trainer.train_step(batches[warmup]), 1, ms, "step",
            top=16, sums=WIN3D_PASSES + ("bilin_",)))

        # (g) save, then resume in a fresh trainer
        models = opt["path"]["models"]
        paths = trainer.save(models, trainer.step)
        fresh = build_trainer(opt, dtype=torch.bfloat16)
        step, g_path = config.find_last_checkpoint(models, "G")
        fresh.resume(g_path, step)
        a, b = trainer.model.state_dict(), fresh.model.state_dict()
        require(step == trainer.step == fresh.step and a.keys() == b.keys()
                and all(torch.equal(a[k], b[k]) for k in a),
                f"resumed model differs (step {step})")
        so, sf_ = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
        require(so["param_groups"] == sf_["param_groups"] and all(
            torch.equal(v.cpu(), sf_["state"][i][k].cpu())
            for i, st in so["state"].items() for k, v in st.items()),
            "resumed optimizer state differs")
        ph.note(f"(g) saved {', '.join(os.path.basename(p) for p in paths)}; "
                "a fresh trainer resumed with equal parameters and optimizer "
                "state (both groups)")
        del trainer, fresh
        torch.cuda.empty_cache()

        # (e) the option file's own "auto" route: the DCN kernel forward
        # with the composed route's backward
        auto = build_trainer(vrt_train_options(tmp, "auto"),
                             dtype=torch.bfloat16)
        auto.model.load_state_dict(sd, strict=True)
        # one warm-up and two timed steps: a step is ≈ 5 s on this route,
        # and the script keeps within its time
        ms_a, counts_a, losses_a, mem_a = timed_steps(auto, batches, 1, 2)
        per_a = {k: v // 2 for k, v in counts_a.items()}
        want_a = {**want, "bilin_fwd": 0, "bilin_bwd": 0, "dcn": 70}
        require(per_a == want_a, f"auto route counts {counts_a}, want {want_a}")
        ph.note(f"(e) 'auto' route (DCN kernel, composed backward), same "
                f"batches: launches per step {per_a}; ms_per_step {ms_a:.2f} "
                f"(mean of 2 after 1) "
                f"against mxu {ms:.2f}; peak memory {mem_a / 2 ** 30:.2f} GiB")
        del auto
        torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# The CNN zoo and the timing CLIs (phases 22-23)
# ---------------------------------------------------------------------------

# label, built from (a cli/test preset, or an option tree through define_g),
# forward kind, image channels, control ("seed": the weights of seed + 1;
# "sigma": σ 50 for 25; "pca": another kernel's PCA map; "kernel":
# kernels_12[11] transposed), conditioning channels of the head conv
ZOO = (
    ("DnCNN-17 gray", "dncnn_25", "plain", 1, ("seed",)),
    ("DnCNN-20 color blind", "dncnn_color_blind", "plain", 3, ("seed",)),
    ("IRCNN color", "ircnn_color", "plain", 3, ("seed",)),
    ("FFDNet gray 64/15", "ffdnet_gray", "ffdnet", 1, ("sigma",)),
    ("FFDNet color 96/12", "ffdnet_color", "ffdnet", 3, ("sigma",)),
    ("SRMD 128/12", "srmd_x4", "srmd", 3, ("sigma", "pca")),
    ("DPSR 96/16", {"net_type": "dpsr"}, "dpsr", 3, ("seed",)),
    ("MSRResNet0 64/16", "msrresnet_x4", "sr4", 3, ("seed",)),
    ("MSRResNet1 64/16", "options/train_msrresnet_psnr.json", "sr4", 3,
     ("seed",)),
    ("RRDB 64/23 gc 32 (ESRGAN)", "rrdb_x4", "sr4", 3, ("seed",)),
    ("RRDBNet 64/23/32", {"net_type": "rrdbnet"}, "sr4", 3, ("seed",)),
    ("IMDN 64/8", "imdn_x4", "sr4", 3, ("seed",)),
    ("DRUNet color 64-512/4", "drunet_color", "drunet", 3, ("sigma",)),
    ("USRNet 8 iters h_nc 64, 64-512", "usrnet", "usrnet", 3, ("kernel",)),
)
# (reference map on the CPU, timed map on the card): the denoisers' image,
# the SR models' LR image
ZOO_SIZES = {"plain": (64, 512), "ffdnet": (64, 512), "drunet": (64, 512),
             "srmd": (32, 256), "dpsr": (32, 256), "sr4": (32, 256),
             "usrnet": (16, 128)}
# head-conv input channels a conditioning map feeds, and how much their
# seeded weights are raised so that the map moves the output (σ is 0.1,
# the image about 0.5)
COND_BOOST = {"sigma": 16.0, "pca": 4.0}


def zoo_model(source, state_dict=None):
    """(f32 CPU model) of a ZOO entry: a cli/test preset, an option file's
    netG or an option tree, through define_g."""
    from kair_tpu_torch.cli.test import preset_model
    from kair_tpu_torch.config import load_json_with_comments
    from kair_tpu_torch.models.registry import define_g
    if isinstance(source, dict):
        model = define_g({"netG": dict(source)})
    elif source.endswith(".json"):
        model = define_g({"netG": load_json_with_comments(source)["netG"]})
    else:
        model = preset_model(source, state_dict or {})[0]
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.eval()


def zoo_inputs(kind: str, ch: int, size: int, seed: int, sigma: float = 25,
               pca_kernel=None, blur=None):
    """The model's CPU input tensors for one forward kind, from a seeded
    smooth image: noisy images (+ the σ map) for the denoisers, LR images
    (+ the degradation maps) for the SR models."""
    import numpy as np
    import torch
    from kair_tpu_torch.degrade import sisr
    img = smooth_image(size, size, seed)[..., :ch].astype(np.float32) / 255
    s = sigma / 255.0
    if kind in ("plain", "ffdnet", "drunet"):
        img = img + np.random.RandomState(seed).normal(0, s, img.shape)
    else:
        # texture, as a natural LR image has (and which the blur kernel's
        # direction acts on, for USRNet)
        img = img + np.random.RandomState(seed).normal(0, 0.1, img.shape)
    x = torch.from_numpy(img[None].astype(np.float32))
    smap = torch.full((1, size, size, 1), s)
    if kind == "ffdnet":
        return (x, torch.full((1, 1, 1, 1), s))
    if kind == "drunet":
        return (torch.cat([x, smap], -1),)
    if kind == "dpsr":
        return (torch.cat([x, smap], -1),)
    if kind == "srmd":
        k = sisr.anisotropic_gaussian(15, np.pi, 0.1, 0.1) \
            if pca_kernel is None else pca_kernel
        pca = torch.from_numpy(sisr.pca_project(k, sisr.load_srmd_pca()))
        return (torch.cat([x, pca.view(1, 1, 1, 15).expand(1, size, size, 15),
                           smap], -1),)
    if kind == "usrnet":
        k = sisr.load_kernels_12()[11] if blur is None else blur
        k = torch.from_numpy((k / k.sum()).astype(np.float32))
        return (x, k[None, :, :, None], 4, torch.zeros(1, 1, 1, 1))
    return (x,)


def zoo_last_conv(model, kind: str):
    import torch.nn as nn
    if kind == "usrnet":
        return model.p.m_tail
    return [m for m in model.modules()
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))][-1]


def zoo_state_dict(source, kind: str, ch: int, seed: int, cond=()) -> dict:
    """Seeded weights in which every layer moves the output: convs
    He-normal (std sqrt(2 / fan_in)), those inside a residual unit scaled
    by 0.1 as ESRGAN initialises its trunk (the residual stream stays near
    the unit scale through 16-28 units), biases 0.01-normal; USRNet at its
    own seeded initialisation (eight unrolled priors would compound a
    larger gain). The head conv's conditioning channels are raised by
    COND_BOOST; then the last conv is scaled so that the part of the output
    it makes has a spread of 0.1 on the reference input and, but for the
    residual denoisers (x − n), shifted to an image-like mean of 0.5 (twice
    for USRNet, whose last conv also feeds the next iteration)."""
    import torch
    from kair_tpu_torch.models.rrdbnet import DenseBlock5C
    from kair_tpu_torch.models.srresnet import ResidualBlockNoBN
    from kair_tpu_torch.ops import blocks
    units = (blocks.ResBlock, blocks.ResidualDenseBlock5C, blocks.IMDBlock,
             DenseBlock5C, ResidualBlockNoBN)
    torch.manual_seed(seed)
    model = zoo_model(source)
    gen = torch.Generator().manual_seed(seed)
    convs = (torch.nn.Conv2d, torch.nn.ConvTranspose2d)
    with torch.no_grad():
        if kind != "usrnet":
            for m in model.modules():
                if isinstance(m, convs):
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                                   * math.sqrt(2 / m.weight[0].numel()))
                    if m.bias is not None:
                        m.bias.copy_(torch.randn(m.bias.shape, generator=gen)
                                     * 0.01)
            for u in model.modules():
                if isinstance(u, units):
                    for m in u.modules():
                        if isinstance(m, convs):
                            m.weight.mul_(0.1)
        head = next(m for m in model.modules() if isinstance(m, convs))
        for c in cond:
            if c in COND_BOOST:
                first = {"sigma": head.in_channels - 1, "pca": 3}[c]
                n = 1 if c == "sigma" else 15
                head.weight[:, first:first + n] *= COND_BOOST[c]
        args = zoo_inputs(kind, ch, ZOO_SIZES[kind][0], seed)
        last = zoo_last_conv(model, kind)
        for _ in range(2 if kind == "usrnet" else 1):
            out1 = model(*args)
            w = last.weight.clone()
            last.weight.zero_()
            out0 = model(*args)
            last.weight.copy_(w * (0.1 / (out1 - out0).std().item()))
            if kind == "plain":
                continue
            # an image-like output: mean 0.5, by the bias or, where the
            # last conv has none, on its centre tap (each input channel's
            # weight moved by the sign of its mean)
            seen = []
            hook = last.register_forward_hook(
                lambda m, i, o: seen.append(i[0].mean((0, 1, 2))))
            shift = 0.5 - model(*args).mean().item()
            hook.remove()
            if last.bias is not None:
                last.bias.add_(shift)
            else:
                k, m = last.kernel_size[0] // 2, seen[-1]
                last.weight[:, :, k, k] += shift * m.sign() / m.abs().sum()
    return {k: v.clone() for k, v in model.state_dict().items()}


def zoo_drift(gpu, cpu, args, dev: str = "cuda", points: int = 8) -> str:
    """Where a bf16 model's error grows: max_abs / max|ref| of each conv's
    output along the forward (and of the model's output) against the f32
    CPU model ``cpu``, for ``gpu`` (bf16 on ``dev``), for ``cpu`` in f32 on
    ``dev`` with TF32 off (is the card's conv right?) and in bf16 on the
    CPU (is the error bf16's own?), at ``points`` convs spaced along the
    forward and the last; and whether two bf16 forwards on ``dev`` are
    bit-equal."""
    import copy
    import torch
    import torch.nn as nn

    def trace(model, device):
        outs = []
        hooks = [m.register_forward_hook(
            lambda m, i, o, name=name: outs.append((name, o.float().cpu())))
            for name, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
        try:
            with torch.inference_mode():
                out = model(*[a.to(device) if torch.is_tensor(a) else a
                              for a in args])
        finally:
            for h in hooks:
                h.remove()
        return outs + [("output", out.float().cpu())]

    ref = trace(cpu, "cpu")
    bf_dev = trace(gpu, dev)
    bit_equal = all(torch.equal(a[1], b[1])
                    for a, b in zip(bf_dev, trace(gpu, dev)))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32_dev = trace(copy.deepcopy(cpu).to(dev), dev)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    bf_cpu = trace(copy.deepcopy(cpu).to(torch.bfloat16), "cpu")
    n = len(ref)
    picks = sorted({round(i * (n - 2) / (points - 1)) for i in range(points)}
                   | {n - 1})
    cols = []
    for i in picks:
        name, r = ref[i]
        m = max(r.abs().max().item(), 1e-30)
        e = [(run[i][1] - r).abs().max().item() / m
             for run in (bf_dev, f32_dev, bf_cpu)]
        cols.append(f"{i + 1 if i < n - 1 else 'out'} {name} "
                    f"{e[0]:.4g}/{e[1]:.2g}/{e[2]:.4g}")
    return (f"drift along {n - 1} convs (max_abs/max|ref| against f32 CPU: "
            f"bf16 {dev} / f32 {dev} no TF32 / bf16 cpu): " + ", ".join(cols)
            + f"; two bf16 {dev} forwards bit-equal: {bit_equal}")


def card_forward(model, args):
    """NHWC f32 CPU tensor out of the model on the card."""
    import torch
    dev = [a.cuda() if torch.is_tensor(a) else a for a in args]
    with torch.inference_mode():
        out = model(*dev)
    torch.cuda.synchronize()
    return out.float().cpu()


def phase_zoo(card: str) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.cli.challenge import count_flops
    from kair_tpu_torch.cli.test import build_preset
    from kair_tpu_torch.degrade import sisr
    from kair_tpu_torch.utils.summary import peak_bf16_tflops

    tol = 2e-2
    peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
    with Phase("22 cnn_zoo") as ph, tempfile.TemporaryDirectory() as tmp:
        ph.note("each model with seeded weights (zoo_state_dict), bf16 on cuda "
                "(cuDNN convs, USRNet's data step f32/complex64 on cuFFT) "
                "against f32 on the CPU; limit max_abs <= "
                f"{tol} * max|ref|; each control must exceed it and 3x the "
                "error; presets through cli.test.build_preset from a .pth, the "
                "others through define_g; times: CUDA events, median of 10 "
                f"after 2 warm-ups, convolution FLOP by FlopCounterMode [{card}]")
        worst = []
        for i, (label, source, kind, ch, controls) in enumerate(ZOO):
            seed = SEED + 220 + i
            sd = zoo_state_dict(source, kind, ch, seed, controls)
            cpu = zoo_model(source, sd)
            if isinstance(source, str) and not source.endswith(".json"):
                path = os.path.join(tmp, f"{source}.pth")
                torch.save(sd, path)
                gpu, _, _ = build_preset(source, path)
            else:
                gpu = zoo_model(source, sd).to("cuda", torch.bfloat16)
            ref_size, time_size = ZOO_SIZES[kind]
            args = zoo_inputs(kind, ch, ref_size, seed)
            with LaunchCount() as lc:
                got = card_forward(gpu, args)
            lc.expect(label)           # no hand-written kernel on this path
            with torch.no_grad():
                ref = cpu(*args).float()
            e_abs, e_rel, ref_max, _ = compare(got, ref)
            require(got.shape == ref.shape and torch.isfinite(got).all().item(),
                    f"{label}: output {tuple(got.shape)} or non-finite values")
            require(e_rel <= tol, f"{label}: max_rel {e_rel:.4g} > {tol}")
            if e_rel > tol / 2:        # a thin margin: where does it grow?
                ph.note(f"{label}: " + zoo_drift(gpu, cpu, args))
            effects = []
            for c in controls:
                if c == "seed":
                    alt = zoo_model(source, zoo_state_dict(source, kind, ch,
                                                           seed + 1, controls))
                    cargs = args
                else:
                    alt = cpu
                    cargs = zoo_inputs(
                        kind, ch, ref_size, seed, sigma=50 if c == "sigma" else 25,
                        pca_kernel=sisr.anisotropic_gaussian(15, np.pi / 4, 6, 1)
                        if c == "pca" else None,
                        blur=sisr.load_kernels_12()[11].T if c == "kernel"
                        else None)
                with torch.no_grad():
                    eff = (alt(*cargs).float() - ref).abs().max().item()
                require(eff > tol * ref_max and eff > 3 * e_abs,
                        f"{label}: the {c} control ({eff / ref_max:.4g}) is not "
                        "above the limit and 3x the error")
                effects.append(f"{c} {eff / ref_max:.4g}")
            worst.append((e_rel, label))
            targs = [a.cuda() if torch.is_tensor(a) else a
                     for a in zoo_inputs(kind, ch, time_size, seed)]
            with torch.inference_mode():
                ms = cuda_ms(lambda: gpu(*targs), warmup=2, reps=10)
            flops = count_flops(gpu, *targs)
            tflops = flops / (ms / 1e3) / 1e12

            def two_forwards():
                with torch.inference_mode():
                    gpu(*targs)
                    gpu(*targs)
            ph.note(f"{label}: {tuple(ref.shape)} max_abs {e_abs:.4g} max_rel "
                    f"{e_rel:.4g} (max|ref| {ref_max:.3g}), control "
                    f"{', '.join(effects)}; 1x{time_size}x{time_size}"
                    f"{' LR' if kind not in ('plain', 'ffdnet', 'drunet') else ''}"
                    f": {ms:.3f} ms, {time_size ** 2 / (ms / 1e3) / 1e6:.3f} MP/s,"
                    f" {tflops:.1f} TFLOP/s (MFU "
                    f"{'n/a' if not peak else f'{tflops / peak:.4f}'}); "
                    + device_breakdown(two_forwards, 2, ms, "forward",
                                       host=True, top=4))
            del gpu, cpu
        ph.note(f"largest max_rel {max(worst)[0]:.4g} ({max(worst)[1]})")


def phase_timing_clis(card: str) -> None:
    import contextlib
    import io
    import torch
    from kair_tpu_torch.cli import bench, challenge, video_bench

    runs = (("cli/challenge", lambda: [challenge.main([])]),
            ("cli/video_bench --net vrt",
             lambda: video_bench.main(["--net", "vrt"])),
            ("cli/video_bench --net rvrt",
             lambda: video_bench.main(["--net", "rvrt"])),
            ("cli/bench", lambda: [bench.main([])]),
            # the optional flags: every deform route in turns, profiles
            ("cli/video_bench --net rvrt --compare --profile",
             lambda: video_bench.main(["--net", "rvrt", "--compare", "--k",
                                       "2", "--profile"])),
            ("cli/bench --batch 1 --profile",
             lambda: [bench.main(["--batch", "1", "--profile"])]))
    with Phase("23 timing_clis") as ph:
        for what, run in runs:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                reps = run()
            lines = buf.getvalue().strip().splitlines()
            require([json.loads(l) for l in lines] == reps,
                    f"{what}: printed lines differ from its result")
            for rep in reps:
                require(rep["value"] > 0 and rep["mfu"] is not None,
                        f"{what}: value {rep['value']} mfu {rep['mfu']}")
                if "--profile" in what:
                    require(rep["profile"]["busy_ms"] is not None,
                            f"{what}: the profiler saw no device time")
                ph.note(f"{what}: " + json.dumps(rep))
            torch.cuda.empty_cache()
        ph.note(f"[{card}]")


ZOO_TRAIN = (
    # (label, option file, gradient control)
    ("DnCNN-17 gray", "options/train_dncnn.json", "seed"),
    ("FFDNet color 96/12", "options/train_ffdnet.json", "sigma"),
    ("MSRResNet1 x4", "options/train_msrresnet_psnr.json", "seed"),
    ("USRNet", "options/train_usrnet.json", "kernel"),
)
GRAY_OPTION = "options/swinir/train_swinir_denoising_gray.json"


def seeded_dataset(ds_opt, n_images: int, seed: int, size: int = 200,
                   distinct: int = 64):
    """The option block's dataset class (``define_dataset``'s) over
    ``n_images`` smooth images seeded from ``seed`` on (``distinct`` of
    them, repeated):
    its two file-system hooks, ``image_paths`` and ``read_uint``, replaced,
    since the card has no image set and no cv2."""
    from kair_tpu_torch.data.datasets import dataset_class
    cache: dict = {}

    class Seeded(dataset_class(ds_opt)):
        def image_paths(self, root):
            return [f"{root}/seed{i}.png" for i in range(n_images)]

        def read_uint(self, path):
            i = int(path.rsplit("seed", 1)[1].split(".")[0]) % distinct
            if i not in cache:
                cache[i] = smooth_image(size, size, seed + i)
            return cache[i][..., :self.n_channels].copy()

    return Seeded(ds_opt)


def loader_batches(ds_opt, n: int, n_images: int = 0,
                   seed: int = SEED + 300) -> list:
    """``n`` training batches of the option block's seeded dataset (images
    from ``seed`` on) through the port's Loader, epoch after epoch (a
    dataset that raises stops here, with its traceback)."""
    from kair_tpu_torch.data.base import Loader
    bs = ds_opt["dataloader_batch_size"]
    loader = Loader(seeded_dataset(ds_opt, n_images or bs, seed), bs,
                    seed=SEED)
    batches, epoch = [], 0
    while len(batches) < n:
        batches += list(loader.epoch(epoch))
        epoch += 1
    return batches[:n]


def timed_steps(trainer, batches, warmup: int = 1):
    """(ms per step over the batches after ``warmup``, CUDA events; the
    losses, all of them finite)."""
    import torch
    losses = [trainer.train_step(bt)["G_loss"] for bt in batches[:warmup]]
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    losses += [trainer.train_step(bt)["G_loss"] for bt in batches[warmup:]]
    e.record()
    torch.cuda.synchronize()
    vals = [float(v) for v in losses]
    require(all(math.isfinite(v) for v in vals), f"losses {vals}")
    return s.elapsed_time(e) / (len(batches) - warmup), vals


def zoo_train_case(ph, label: str, option_file: str, control: str, tmp: str,
                   seed: int, card: str) -> None:
    """One zoo option file on the card in f32: the gradient against the
    CPU's, with its control; 1 warm-up and 3 timed steps; two profiled."""
    import numpy as np
    import torch
    from kair_tpu_torch.cli.train import build_trainer

    tol = 1e-4
    opt = train_options(os.path.join(tmp, label.split()[0]), option_file)
    ds_opt = opt["datasets"]["train"]
    bs = ds_opt["dataloader_batch_size"]
    torch.manual_seed(seed)
    trainer = build_trainer(opt, dtype=torch.float32)
    require(trainer.dtype == torch.float32, f"{label}: trainer dtype")
    if control == "sigma":
        # the σ map is one input channel of the head conv: raised as in
        # phase 22 (COND_BOOST), so that a σ change moves the gradient
        head = next(m for m in trainer.model.modules()
                    if isinstance(m, torch.nn.Conv2d))
        with torch.no_grad():
            head.weight[:, -1] *= COND_BOOST["sigma"]
    net = opt["netG"]
    batches = loader_batches(ds_opt, 4)
    shapes = {k: tuple(v.shape) for k, v in batches[0].items()
              if isinstance(v, np.ndarray)}
    extra = ""
    if "sf" in batches[0]:
        sfs = [bt["sf"] for bt in batches]
        require(all(len(set(v)) == 1 for v in sfs),
                f"{label}: a batch mixes scale factors: {sfs}")
        require(len({v[0] for v in sfs}) >= 2,
                f"{label}: one scale factor in all batches: {sfs}")
        extra = (f"; scale factors a batch {[v[0] for v in sfs]}, L "
                 f"{[tuple(bt['L'].shape[1:3]) for bt in batches]}")

    # the gradient at B=2: card f32 (no TF32) against the CPU's f32
    small = {k: v[:2] for k, v in batches[0].items()}
    g_card = grads_of(trainer, small)
    cpu = build_trainer(opt, dtype=torch.float32, device="cpu")
    cpu.model.load_state_dict(trainer.model.state_dict())
    g_cpu = grads_of(cpu, small)
    names = list(g_cpu)
    err = rel_norm(g_card, g_cpu, names)
    if control == "seed":
        torch.manual_seed(seed + 1)
        alt, alt_batch, what = build_trainer(opt, dtype=torch.float32,
                                             device="cpu"), small, "seed + 1"
    elif control == "sigma":
        alt, what = cpu, "σ map of level 255 − σ"
        alt_batch = {**small, "C": np.float32(1) - small["C"]}
    else:
        alt, what = cpu, "kernels transposed"
        alt_batch = {**small, "k": np.ascontiguousarray(
            small["k"].transpose(0, 2, 1, 3))}
    eff = rel_norm(grads_of(alt, alt_batch), g_cpu, names)
    del cpu, alt
    ph.note(f"{label} ({option_file}: {net['net_type']}, "
            f"{sum(p.numel() for p in trainer.model.parameters())} params, "
            f"{type(trainer).__name__} {opt.get('model')}, batch {bs}, "
            f"{shapes}{extra}): gradient B=2 f32 card vs CPU relative norm "
            f"{err:.4g} (limit {tol}), control ({what}) {eff:.4g}")
    require(err <= tol, f"{label}: gradient error {err:.4g} > {tol}")
    require(eff > tol and eff > 3 * err,
            f"{label}: the {what} control ({eff:.4g}) is not above the limit "
            "and 3x the error")

    ms, losses = timed_steps(trainer, batches)
    prof = device_breakdown(lambda: [trainer.train_step(bt)
                                     for bt in batches[1:3]], 2, ms, "step",
                            top=4)
    ph.note(f"{label}: losses {losses[0]:.4g} .. {losses[-1]:.4g}; "
            f"ms_per_step {ms:.2f} (f32, mean of 3 after 1, CUDA events), "
            f"{bs / (ms / 1e3):.1f} patches/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; {prof} "
            f"[{card}]")
    torch.cuda.reset_peak_memory_stats()
    del trainer
    torch.cuda.empty_cache()


def phase_train_zoo(card: str, build_dir) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.cli.train import build_trainer
    from kair_tpu_torch.ops.kernels.swin_block import swin_block_2d_bwd
    from kair_tpu_torch.train.trainer import PlainTrainer

    with Phase("24 train_zoo") as ph, \
            tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        # (a) the zoo's option files in f32, cuDNN and cuFFT
        for i, (label, option_file, control) in enumerate(ZOO_TRAIN):
            zoo_train_case(ph, label, option_file, control, tmp,
                           SEED + 240 + i, card)

        # (b) SwinIR-M gray denoising, bf16, use_checkpoint
        # the global limit from this recipe's readings on an H100
        # (PERF.md): 0.0058 sound, 0.0117 without the shift mask (the mask
        # acts at the border windows only, so it moves this net's gradient
        # less than phase 7's x4 net's, 0.025); per block parameter
        # phase 7's limit
        tol_global, tol_param = 8e-3, 1e-1
        opt = train_options(os.path.join(tmp, "gray"), GRAY_OPTION)
        ds_opt, net = opt["datasets"]["train"], opt["netG"]
        bs = ds_opt["dataloader_batch_size"]
        torch.manual_seed(SEED + 250)        # the convs and norms outside the blocks
        trainer = build_trainer(opt, dtype=torch.bfloat16)
        sd = seeded_train_weights(trainer.model, SEED + 250)
        trainer.model.load_state_dict(sd)
        trainer.ema.load_state_dict(sd)
        batches = loader_batches(ds_opt, 4, n_images=16)
        require(batches[0]["L"].shape == (bs, ds_opt["H_size"],
                                          ds_opt["H_size"], 1),
                f"gray batch {batches[0]['L'].shape}")
        # the gradient on a 64x64 crop of two patches
        small = {k: np.ascontiguousarray(batches[0][k][:2, :64, :64])
                 for k in ("L", "H")}
        g_card = grads_of(trainer, small)
        cpu = PlainTrainer(opt, device="cpu", dtype=torch.float32)
        cpu.model.load_state_dict(sd)
        g_cpu = grads_of(cpu, small)
        g_nomask = cpu_without_shift_mask(lambda: grads_of(cpu, small))
        del cpu
        names = list(g_cpu)
        block = [n for n in names if ".residual_group.blocks." in n]
        err = rel_norm(g_card, g_cpu, names)
        per = {n: rel_norm(g_card, g_cpu, [n]) for n in block}
        worst = max(per, key=per.get)
        eff = {n: rel_norm(g_nomask, g_cpu, [n]) for n in block}
        eff_worst = max(eff, key=eff.get)
        eff_global = rel_norm(g_nomask, g_cpu, names)
        ph.note(f"SwinIR-M gray denoising ({GRAY_OPTION}: embed "
                f"{net['embed_dim']}, depths {net['depths']}, window "
                f"{net['window_size']}, use_checkpoint "
                f"{net['use_checkpoint']}, batch {bs} of {ds_opt['H_size']}² "
                f"gray, sigma {ds_opt['sigma']}, "
                f"{opt['train']['G_lossfn_type']}): gradient on a 2x64x64 "
                f"crop, bf16 card vs f32 CPU, relative norm {err:.4g} (limit "
                f"{tol_global}), worst block parameter {worst} "
                f"{per[worst]:.4g} (limit {tol_param}); control without the "
                f"shift mask {eff_global:.4g} over all, "
                f"{eff[eff_worst]:.4g} at {eff_worst}")
        require(err <= tol_global, f"gray gradient error {err:.4g} > "
                f"{tol_global}")
        require(per[worst] <= tol_param,
                f"gray block parameter {worst}: {per[worst]:.4g} > {tol_param}")
        require(eff_global > tol_global,
                f"gray: the dropped-mask control ({eff_global:.4g}) is not "
                "above the global limit")
        require(eff[eff_worst] > tol_param and eff[eff_worst] > 3 * per[worst],
                "gray: the dropped-mask control is not above the "
                "per-parameter limit and 3x the worst error")
        # steps: 36 forward launches and 36 recomputed under
        # use_checkpoint, 36 backward, no conv kernel, no composed block
        steps, n_blocks = len(batches), sum(net["depths"])
        swin_block_2d_bwd.launches = 0
        with LaunchCount() as lc:
            ms, losses = timed_steps(trainer, batches)
        n_bwd = swin_block_2d_bwd.launches
        prof = device_breakdown(lambda: [trainer.train_step(bt)
                                         for bt in batches[1:3]], 2, ms,
                                "step", sums=("swin_",))
        counts = ", ".join(f"{k} {v}" for k, v in lc.counts.items())
        ph.note(f"SwinIR-M gray denoising: launches in {steps} steps: {counts}, "
                f"swin_block_2d_bwd {n_bwd} (per step {2 * n_blocks} forward "
                f"with the recompute, {n_blocks} backward, 0 conv tail); "
                f"losses {losses[0]:.4g} .. {losses[-1]:.4g}; ms_per_step "
                f"{ms:.2f} (bf16, mean of 3 after 1, CUDA events), "
                f"{bs / (ms / 1e3):.1f} patches/s, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                f"{prof} [{card}]")
        lc.expect("gray training", swin_block_2d=2 * n_blocks * steps,
                  swin_block_2d_bwd=n_blocks * steps)
        require(n_bwd == n_blocks * steps,
                f"gray training: {n_bwd} backward launches in {steps} steps")
        del trainer
        torch.cuda.empty_cache()

        # row 3 at the gray step's 128x128 map, B=2, against its plain
        # version, phase 4 (the shifted block), with the dropped-mask control
        ph.note(row3_case(2, 128, 180, 6, 360, 4, SEED + 251, "mask"))


def row3_case(b: int, h: int, c: int, nh: int, hidden: int, phase: int,
              seed: int, control: str) -> str:
    """Row 3 (``swin_block_2d_bwd``) on seeded bf16 x and dy (B, h, h, C)
    and f32 parameters against its plain version at ``phase`` (the shift
    mask where the phase is not 0): every tensor within 2e-2 of its own
    max; the control ("mask": the plain dx without the mask, "phase": at
    phase + 1) moves dx by more than the limit and 3x the error."""
    import torch
    from kair_tpu_torch.ops.kernels.swin_block import (
        SwinBlockParams, pack_swin_block, swin_block_2d_bwd,
        swin_block_2d_bwd_reference)
    from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor
    tol = 2e-2
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    p = swin_params(c, nh, hidden, gen, dev, torch.float32)
    x = torch.randn(b, h, h, c, generator=gen).to(dev, torch.bfloat16)
    dy = torch.randn(b, h, h, c, generator=gen).to(dev, torch.bfloat16)
    mask = shift_mask_tensor(h, h, 8, 4, dev) if phase else None
    got = swin_block_2d_bwd(x, dy, p, nh, mask,
                            pack_swin_block(p, nh, folded=False), phase)
    torch.cuda.synchronize()
    ref = swin_block_2d_bwd_reference(x, dy, p, nh, mask, phase)
    ctl_dx = (swin_block_2d_bwd_reference(x, dy, p, nh, None, phase)
              if control == "mask" else
              swin_block_2d_bwd_reference(x, dy, p, nh, mask, phase + 1))[0]
    what = f"row 3 at B={b} {h}x{h} C={c} {nh} heads hidden {hidden} " \
           f"phase {phase}"
    worst_rel, worst_name, dx_abs = 0.0, "", 0.0
    for name, a, r in zip(("dx",) + SwinBlockParams._fields,
                          (got[0],) + tuple(got[1]), (ref[0],) + tuple(ref[1])):
        e_abs, e_rel, _, _ = compare(a, r)
        require(e_rel <= tol, f"{what} {name}: max_rel {e_rel:.4g} > {tol}")
        if name == "dx":
            dx_abs = e_abs
        if e_rel > worst_rel:
            worst_rel, worst_name = e_rel, name
    ctl = (ctl_dx.float() - ref[0].float()).abs().max().item()
    ref_max = ref[0].float().abs().max().item()
    require(ctl > tol * ref_max and ctl > 3 * dx_abs,
            f"{what}: the {control} control is not above the limit and 3x "
            "the error")
    return (f"{what} against its plain version: worst max_rel "
            f"{worst_rel:.4g} ({worst_name}, limit {tol} per tensor), "
            f"{control} control's effect on dx max_rel {ctl / ref_max:.4g}")


# ---------------------------------------------------------------------------
# RVRT-001 training through its kernels (phase 25)
# ---------------------------------------------------------------------------

# relative gradient norm, bf16 kernels against the f32 composed route: over
# all parameters and the flow group, and the worst part (set from this
# phase's readings on an H100: 0.00925 / 0.0122 and 0.0136 at
# deform_align.backward_2; PERF.md)
RVRT_TRAIN_GRAD_LIMITS = (2e-2, 4e-2)
RVRT_TRAIN_BATCH, RVRT_TRAIN_FRAMES = 4, 8


def rvrt_train_options(tmp: str):
    """The training fields of the shipped VRT-001 option file with RVRT's
    network (``net_type`` "rvrt": the RVRT-001 defaults, ``fuse_block`` on,
    ``deform_impl`` "auto"), clips of RVRT_TRAIN_FRAMES frames,
    RVRT_TRAIN_BATCH a batch, paths in `tmp`."""
    from kair_tpu_torch import config
    raw = config.load_json_with_comments(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), VRT_TRAIN_OPTION))
    raw["task"] = "rvrt_001_train"
    raw["path"]["root"] = os.path.join(tmp, "runs")
    train = raw["datasets"]["train"]
    train.update(dataroot_gt=os.path.join(tmp, "gt"),
                 dataroot_lq=os.path.join(tmp, "lq"), meta_info_file=None,
                 num_frame=RVRT_TRAIN_FRAMES,
                 dataloader_batch_size=RVRT_TRAIN_BATCH)
    del raw["datasets"]["test"]
    raw["netG"] = {"net_type": "rvrt", "fuse_block": True,
                   "deform_impl": "auto", "use_checkpoint_attn": False}
    path = os.path.join(tmp, "rvrt001.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return config.parse(path)


def rvrt_param_parts(names) -> dict:
    """RVRT's parameter names by part: SpyNet, feat_extract, each branch's
    backbone and deform_align, reconstruction, the rest."""
    parts: dict = {}
    for n in names:
        head = n.split(".")
        key = ".".join(head[:2]) if head[0] in ("backbone", "deform_align") \
            else head[0] if head[0] in ("spynet", "feat_extract",
                                        "reconstruction") else "rest"
        parts.setdefault(key, []).append(n)
    return parts


def without_gda_offsets(fn):
    """fn() with RVRT's guided deformable attention at zero offsets: every
    tap at its own pixel, the flows and the offset nets left out."""
    from kair_tpu_torch.models import rvrt as mrvrt
    with_offsets = mrvrt.deform_attention
    mrvrt.deform_attention = lambda q, k, v, off, *a: with_offsets(
        q, k, v, off * 0, *a)
    try:
        return fn()
    finally:
        mrvrt.deform_attention = with_offsets


def composed_backward_times(b: int, d: int, s: int) -> str:
    """ms of one ``gda_train`` and one ``stl2_block_train`` call at RVRT-001
    training's shapes (B clips of d frames at s x s; GDA on B·2 query
    frames of 288 channels, flow-like offsets; STL2 on (B, 2, s, s, 144)),
    forward and backward timed apart with CUDA events (median of 3 after
    1), under bf16 autocast as in a step."""
    import torch
    from kair_tpu_torch.ops.kernels import gda_block, stl2_block
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 254)
    bf = torch.bfloat16
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev, bf)
    q, k, v = rnd(2 * b, s, s, 288), rnd(b, 2, s, s, 288), rnd(b, 2, s, s, 288)
    off = gda_offsets("flow", 2 * b, 2, s, s, 12, 9, gen, dev)
    x = rnd(b, 2, s, s, 144)
    p = stl_params(144, 6, 2, gen, dev)
    p = p._replace(**{k_: t.requires_grad_() for k_, t in p._asdict().items()
                      if t is not None})

    def times(fwd):
        f_ms, b_ms = [], []
        for _ in range(4):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            with torch.autocast("cuda", torch.bfloat16):
                e[0].record()
                y = fwd()
                e[1].record()
            y.float().square().mean().backward()
            e[2].record()
            torch.cuda.synchronize()
            f_ms.append(e[0].elapsed_time(e[1]))
            b_ms.append(e[1].elapsed_time(e[2]))
        return statistics.median(f_ms[1:]), statistics.median(b_ms[1:])
    leaves = [t.requires_grad_() for t in (q, k, v, off)]
    g_f, g_b = times(lambda: gda_block.gda_train(*leaves, (3, 3), 12, 12))
    s_f, s_b = times(lambda: stl2_block.stl2_block_train(
        x.requires_grad_(), p, 6, (1, 4, 4)))
    return (f"one GDA call ({2 * b}x{s}x{s}x288, 2 slots, 9 taps, 12 groups): "
            f"forward {g_f:.2f} ms, composed backward {g_b:.2f} ms (x12 a "
            f"step: {12 * g_b:.1f} ms); one STL2 call ({b}x2x{s}x{s}x144, "
            f"shifted): forward {s_f:.2f} ms, composed backward {s_b:.2f} ms "
            f"(x64 a step: {64 * s_b:.1f} ms)")


def phase_rvrt_train(report: list, card: str, build_dir) -> None:
    import itertools
    import torch
    from kair_tpu_torch.cli.train import build_trainer
    from kair_tpu_torch.data.base import Loader
    from kair_tpu_torch.models import vrt as mvrt
    from kair_tpu_torch.models.registry import define_g
    from kair_tpu_torch.ops.deform_attn import deform_attention
    from kair_tpu_torch.ops.kernels import gda_block, stl2_block, swin_block
    from kair_tpu_torch.train.trainer import bf16_only_route
    from kair_tpu_torch.train.video import VideoTrainer
    from kair_tpu_torch.utils.summary import peak_bf16_tflops, rvrt_flops_per_clip

    tol_global, tol_part = RVRT_TRAIN_GRAD_LIMITS
    timed = 3
    counters = ((stl2_block.stl2_block, "launches", "stl2"),
                (gda_block.gda_fused, "launches", "gda"),
                (swin_block.swin_block_2d, "launches", "swin"),
                (swin_block.swin_block_2d, "launches_win", "swin_win"),
                (swin_block.swin_block_2d_bwd, "launches", "swin_bwd"))

    def zero_counts():
        for f, attr, _ in counters:
            setattr(f, attr, 0)
        mvrt.TMSA.composed_calls = 0
        deform_attention.composed_calls = 0

    def read_counts():
        out = {k: getattr(f, attr) for f, attr, k in counters}
        out["composed_tmsa"] = mvrt.TMSA.composed_calls
        out["composed_deform"] = deform_attention.composed_calls
        return out

    t0 = time.perf_counter()
    lap = lambda: f" [{time.perf_counter() - t0:.1f} s into the phase]"
    with Phase("25 rvrt_train") as ph, \
            tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        opt = rvrt_train_options(tmp)
        ds_opt, ot = opt["datasets"]["train"], opt["train"]
        bs, nf, gs, sf = (RVRT_TRAIN_BATCH, RVRT_TRAIN_FRAMES,
                          ds_opt["gt_size"], opt["scale"])
        trainer = build_trainer(opt, dtype=torch.bfloat16)
        require(isinstance(trainer, VideoTrainer), f"{type(trainer).__name__}")
        sd = rvrt_state_dict(SEED + 25)
        trainer.model.load_state_dict(sd, strict=True)
        n_params = sum(p.numel() for p in trainer.model.parameters())
        ph.note(f"RVRT-001's network (embed 144, num_blocks (1,2,1), depths "
                "(2,2,2), 6 heads, window (2,8,8), clip 2, 12 groups = 12 "
                "attention heads, fuse_block on, deform_impl 'auto') with the "
                f"training fields of {VRT_TRAIN_OPTION} through cli.train."
                f"build_trainer -> VideoTrainer, bf16 autocast over f32: "
                f"{ot['G_lossfn_type']}, Adam {ot['G_optimizer_lr']}, fix_iter "
                f"{ot['fix_iter']} over {ot['fix_keys']}; {n_params} params "
                f"seeded by RVRT_INIT; B={bs} clips of {nf} frames at "
                f"{gs // sf}x{gs // sf} LR (KAIR trains 30-frame clips: the "
                "clip length is cut, a longer clip is a longer loop over the "
                "same kernels)")
        loader = Loader(seeded_clip_dataset(ds_opt, tmp, clips=2), bs,
                        seed=SEED)
        batches = [{k: v for k, v in bt.items() if hasattr(v, "shape")}
                   for bt in itertools.islice(loader.epoch(0), 6)]
        require(len(batches) == 6
                and batches[0]["L"].shape == (bs, nf, gs // sf, gs // sf, 3)
                and batches[0]["H"].shape == (bs, nf, gs, gs, 3),
                f"{len(batches)} batches, shapes {batches[0]['L'].shape} "
                f"{batches[0]['H'].shape}")

        # (e) every kernel of the training route is bf16 only: f32 refuses
        kernels = {m.bf16_only_kernel() for m in trainer.model.modules()
                   if hasattr(m, "bf16_only_kernel")} - {None}
        require(kernels == {"kair_win3d_block", "kair_gda",
                            "swin_block_2d and swin_block_2d_bwd"},
                f"bf16-only kernels {kernels}")
        try:
            build_trainer(opt, dtype=torch.float32)
            refusal = None
        except NotImplementedError as e:
            refusal = str(e)
        require(refusal is not None and bf16_only_route(trainer.model)
                in refusal, f"--dtype f32 on the card: {refusal}")
        ph.note(f"(e) --dtype f32 refused before any work: '{refusal[:160]}'; "
                f"the route's bf16-only kernels {sorted(kernels)}" + lap())

        # (a) one gradient at B=1 of a 4-frame clip against the f32 composed
        # route on the card (fuse_block off, the gather route)
        small = {k: v[:1, :4] for k, v in batches[0].items()}
        zero_counts()
        g_card = grads_of(trainer, small)
        fwd_counts = read_counts()
        ref = define_g({**opt, "netG": {**opt["netG"], "fuse_block": False,
                                        "deform_impl": "gather"}})
        ref = ref.cuda().train()
        ref.load_state_dict(sd, strict=True)
        g_ref = model_grads(ref, trainer.loss_fn, small)
        g_ctrl = without_gda_offsets(
            lambda: model_grads(ref, trainer.loss_fn, small))
        del ref
        torch.cuda.empty_cache()
        parts = rvrt_param_parts(g_ref)
        flow = [n for n in g_ref if "spynet" in n or "deform" in n]
        err = {k: rel_norm(g_card, g_ref, v) for k, v in parts.items()}
        ctrl = {k: rel_norm(g_ctrl, g_ref, v) for k, v in parts.items()}
        for d, g in ((err, g_card), (ctrl, g_ctrl)):
            d["flow group"] = rel_norm(g, g_ref, flow)
            d["all"] = rel_norm(g, g_ref, list(g_ref))
        worst = max((k for k in parts), key=err.get)
        ph.note(f"(a) gradient at B=1 of 4 frames, bf16 kernels vs the f32 "
                f"composed route (fuse_block off, gather) on the card, "
                f"relative norm: " + ", ".join(f"{k} {v:.4g}"
                                               for k, v in err.items())
                + f" (limits {tol_global} over all and the flow group, "
                f"{tol_part} a part; worst {worst}); control, the f32 route "
                "with the GDA offsets at zero: "
                + ", ".join(f"{k} {v:.4g}" for k, v in ctrl.items())
                + f"; launches in that step {fwd_counts}" + lap())
        require(err["all"] <= tol_global and err["flow group"] <= tol_global,
                f"gradient error {err['all']:.4g} / flow group "
                f"{err['flow group']:.4g} > {tol_global}")
        require(err[worst] <= tol_part, f"{worst}: {err[worst]:.4g} > {tol_part}")
        # the offsets reach the flow group's gradients (SpyNet's through
        # the flows in them, the offset nets'); the blocks' barely move
        moved = max(parts, key=lambda k: ctrl[k] / max(err[k], 1e-12))
        require(ctrl["flow group"] > tol_global
                and ctrl["flow group"] > 3 * err["flow group"],
                "the zero-offset control is not above the global limit and 3x "
                "the error over the flow group")
        require(ctrl[moved] > tol_part and ctrl[moved] > 3 * err[moved],
                f"the zero-offset control at {moved} is not above the part "
                "limit and 3x the error")

        # (b) row 3 at RVRT's width (C=144, 6 heads of 24, hidden 288) at
        # the (1, 8, 8) blocks' shape in this step, B·D = 8 maps of 64x64
        ph.note("(b) " + row3_case(8, 64, 144, 6, 288, 0, SEED + 252, "phase"))
        ph.note("(b) " + row3_case(8, 64, 144, 6, 288, 4, SEED + 253, "mask")
                + lap())

        # (c)-(d) the main path: one warm-up step, then timed steps
        trainer.train_step(batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        losses = [trainer.train_step(bt)["G_loss"] for bt in batches[1:1 + timed]]
        e.record()
        torch.cuda.synchronize()
        counts = read_counts()
        ms = s.elapsed_time(e) / timed
        mem = torch.cuda.max_memory_allocated()
        vals = [float(v) for v in losses]
        require(all(math.isfinite(v) for v in vals), f"losses {vals}")
        per = {k: v // timed for k, v in counts.items()}
        want = dict(stl2=64, gda=12, swin=4, swin_win=0, swin_bwd=4,
                    composed_tmsa=0, composed_deform=0)
        ph.note(f"(c) launches per step over {timed} timed steps: {per} (STL2 "
                "and GDA forwards, their backward the composed routes' "
                "autograd; the (1, 8, 8) blocks forward and backward)")
        require(per == want and all(v % timed == 0 for v in counts.values()),
                f"launch counts {counts} in {timed} steps, want {want} a step")
        for k in report:
            if k["name"] in ("stl2_block", "gda_fused", "swin_block_2d",
                             "swin_block_2d_bwd"):
                k["rvrt_train_launches_per_step"] = per[{
                    "stl2_block": "stl2", "gda_fused": "gda",
                    "swin_block_2d": "swin",
                    "swin_block_2d_bwd": "swin_bwd"}[k["name"]]]
        flops = 3 * rvrt_flops_per_clip(nf, gs // sf, gs // sf) * bs
        peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
        mfu = flops / (ms / 1e3) / 1e12 / peak if peak else None
        ph.note(f"(d) batch {bs} of {nf}x{gs // sf}x{gs // sf}: losses "
                f"{vals[0]:.4g} .. {vals[-1]:.4g}; ms_per_step {ms:.2f} (mean "
                f"of {timed} after 1 warm-up, CUDA events), "
                f"{bs / (ms / 1e3):.3f} clips/s, training MFU "
                f"{'n/a' if mfu is None else f'{mfu:.4f}'} against {peak} "
                f"TFLOP/s (3x the {flops / 3 / bs / 1e12:.4f} TFLOP analytic "
                f"forward a clip, utils/summary); peak memory "
                f"{mem / 2 ** 30:.2f} GiB [{card}]" + lap())
        ph.note("(d) " + device_breakdown(
            lambda: [trainer.train_step(bt) for bt in batches[4:6]], 2, ms,
            "step", top=10, sums=WIN3D_PASSES + ("gda_", "swin_")) + lap())

        # what the composed backwards cost: one GDA and one STL2 call of
        # this step's shapes, forward (the kernel) and backward apart
        ph.note("(d) " + composed_backward_times(bs, nf, gs // sf) + lap())

        # remat (use_checkpoint_attn): the STL blocks' forwards run again
        # in the backward, the (1, 8, 8) backward kernel once
        for m in trainer.model.modules():
            if isinstance(m, mvrt.TMSAG):
                m.remat = True
        zero_counts()
        trainer.train_step(batches[5])
        torch.cuda.synchronize()
        rc = read_counts()
        want_r = {**want, "stl2": 128, "swin": 8}
        ph.note(f"remat step launches {rc}")
        require(rc == want_r, f"remat launches {rc}, want {want_r}")
        del trainer
        torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# GAN training of SwinIR-L x4 (phase 26)
# ---------------------------------------------------------------------------

GAN_OPTION = "options/train_msrresnet_gan.json"
# relative gradient norms against the f32 composed route, set from this
# phase's readings on an H100: the pixel loss alone (G over all, the 54 blocks together, the
# worst part; read 0.0044, 0.0148, 0.0170) and the whole GAN step (G over
# all, G's worst part, D; read 0.0235, 0.0635, 0.0200)
GAN_PIXEL_LIMITS = (1e-2, 3e-2, 5e-2)
GAN_STEP_LIMITS = (4e-2, 1e-1, 1e-1)
GAN_BATCH, GAN_H = 16, 256
# KAIR's real-world SR GAN recipes' discriminator
GAN_NETD = {"net_type": "discriminator_unet", "in_nc": 3, "base_nc": 64}


def gan_options(tmp: str, net_g=None, net_d=None, h_size=None,
                name: str = "gan.json"):
    """The shipped GAN option file with paths in `tmp` (its runs under
    ``tmp/runs_<name>``); ``net_g``, ``net_d`` and ``h_size`` replace its
    networks and patch size when given."""
    from kair_tpu_torch import config
    raw = config.load_json_with_comments(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), GAN_OPTION))
    raw["path"]["root"] = os.path.join(tmp, "runs_" + name.split(".")[0])
    raw["path"]["pretrained_netG"] = None
    if net_g is not None:
        raw["netG"] = net_g
    if net_d is not None:
        raw["netD"] = net_d
    if h_size is not None:
        raw["datasets"]["train"]["H_size"] = h_size
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path, config.parse(path, is_train=True)


def seeded_vgg19(path: str, seed: int) -> dict:
    """A torchvision-keyed vgg19 ``features`` state dict (convs He-normal
    by fan-out, as torchvision initialises them, biases 0), written to
    ``path``."""
    import torch
    from kair_tpu_torch.models.vgg import VGG19Features
    gen = torch.Generator().manual_seed(seed)
    sd = VGG19Features((34,)).state_dict()
    for k, v in sd.items():
        sd[k] = torch.zeros_like(v) if k.endswith("bias") else torch.randn(
            v.shape, generator=gen) * math.sqrt(2.0 / (v.shape[0] * 9))
    torch.save(sd, path)
    return sd


def swinir_l_parts(names) -> dict:
    """SwinIR-L's parameter names by part: conv_first, each RSTB, the last
    norm and conv_after_body, the nearest+conv head."""
    parts: dict = {}
    for n in names:
        head = n.split(".")
        key = ".".join(head[:2]) if head[0] == "layers" else head[0] \
            if head[0] in ("conv_first", "norm", "conv_after_body") else "head"
        parts.setdefault(key, []).append(n)
    return parts


class composed_swin_blocks:
    """While open, SwinIR's training blocks run the block kernels' plain
    version (composed PyTorch, autograd through it) instead of
    ``swin_block_train``, on whatever device: the f32 reference route;
    ``phase_off`` moves every shifted block's read that many pixels
    further (a control: a block reading its shifted windows one pixel
    off)."""

    def __init__(self, phase_off: int = 0):
        self.phase_off = phase_off

    def __enter__(self):
        from kair_tpu_torch.models import swinir as msw
        self.msw, self.fn = msw, msw.swin_block_train
        off = self.phase_off
        msw.swin_block_train = lambda x, p, nh, mask, packed=None, \
            packed_bwd=None, phase=0: msw.swin_block_win_reference(
                x, p, nh, mask, phase=phase + off if phase else 0, ws=8)
        return self

    def __exit__(self, *exc):
        self.msw.swin_block_train = self.fn
        return False


def gan_grads(trainer, batch, u0) -> tuple:
    """G's and D's f32 gradients of one step from the spectral vectors
    ``u0`` (restored after)."""
    import torch
    from kair_tpu_torch.models.discriminator import load_spectral_vectors
    load_spectral_vectors(trainer.model_d, u0)
    trainer.compute_grads(batch, update_g=True)
    out = tuple({n: (torch.zeros_like(p) if p.grad is None else p.grad)
                 .detach().float().cpu() for n, p in m.named_parameters()}
                for m in (trainer.model, trainer.model_d))
    load_spectral_vectors(trainer.model_d, u0)
    return out


def d_grads_on(trainer, batch, fake, u0) -> dict:
    """D's f32 gradients of its update with ``fake`` as the fake batch,
    from the spectral vectors ``u0`` (restored after)."""
    import torch
    from kair_tpu_torch.models.discriminator import load_spectral_vectors
    from kair_tpu_torch.train.trainer import _tensor
    load_spectral_vectors(trainer.model_d, u0)
    trainer.optimizer_d.zero_grad(set_to_none=True)
    h = _tensor(batch["H"], trainer.device).float()
    trainer._d_loss(h, h if fake is None else fake)[0].backward()
    load_spectral_vectors(trainer.model_d, u0)
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad)
            .detach().float().cpu() for n, p in trainer.model_d.named_parameters()}


def pixel_grads(trainer, batch) -> dict:
    """G's f32 gradients of the l1 pixel loss alone (the blocks' share of
    the step, without the perceptual and adversarial terms)."""
    import torch
    from kair_tpu_torch.train.trainer import _tensor
    trainer.optimizer.zero_grad(set_to_none=True)
    with trainer._autocast():
        e = trainer.model(*trainer._args(batch))
    h = _tensor(batch["H"], trainer.device).float()
    (e.float() - h).abs().mean().backward()
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad)
            .detach().float().cpu() for n, p in trainer.model.named_parameters()}


def conv_flops(model, *inputs) -> float:
    """Multiply-add FLOP (x2) of every convolution in one forward of
    ``model`` (nn.Conv2d and the discriminators' SNConv), from their output
    shapes."""
    import torch
    from kair_tpu_torch.models.discriminator import SNConv
    total = [0.0]

    def hook(m, a, out):
        total[0] += 2.0 * out.numel() * m.weight[0].numel()
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, SNConv))]
    with torch.no_grad():
        model(*inputs)
    for h in hooks:
        h.remove()
    return total[0]


def phase_gan_train(report: list, card: str, build_dir) -> None:
    import copy
    import itertools
    import torch
    from kair_tpu_torch.cli import train_gan
    from kair_tpu_torch.data import datasets as mdatasets
    from kair_tpu_torch.data.base import Loader
    from kair_tpu_torch.models import swinir as msw
    from kair_tpu_torch.models.discriminator import spectral_vectors
    from kair_tpu_torch.ops.kernels import swin_block
    from kair_tpu_torch.train.gan import GanTrainer
    from kair_tpu_torch.train.select import define_trainer
    from kair_tpu_torch.train.trainer import bf16_only_route
    from kair_tpu_torch.utils.summary import (peak_bf16_tflops,
                                              swinir_flops_per_lr_pixel)

    px_all, px_blocks, px_part = GAN_PIXEL_LIMITS
    st_all, st_part, st_d = GAN_STEP_LIMITS
    t0 = time.perf_counter()
    lap = lambda: f" [{time.perf_counter() - t0:.1f} s into the phase]"
    counters = ((swin_block.swin_block_2d, "launches", "row1"),
                (swin_block.swin_block_2d, "launches_win", "row1_win"),
                (swin_block.swin_block_2d_bwd, "launches", "row3"))
    composed = [0]
    ref_fn = msw.swin_block_win_reference

    def counted(*a, **kw):
        composed[0] += 1
        return ref_fn(*a, **kw)

    def zero_counts():
        for f, attr, _ in counters:
            setattr(f, attr, 0)
        composed[0] = 0

    def read_counts():
        out = {k: getattr(f, attr) for f, attr, k in counters}
        out["composed"] = composed[0]
        return out

    with Phase("26 gan_train") as ph, \
            tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        torch.manual_seed(SEED + 26)
        net_g = {"net_type": "swinir", "upscale": 4, "in_nc": 3,
                 "img_size": 64, "window_size": 8, "img_range": 1.0,
                 "depths": [6] * 9, "embed_dim": 240, "num_heads": [8] * 9,
                 "mlp_ratio": 2, "upsampler": "nearest+conv",
                 "resi_connection": "3conv", "fuse_block": True}
        _, opt = gan_options(tmp, net_g, GAN_NETD, GAN_H)
        ot, ds_opt = opt["train"], opt["datasets"]["train"]
        vgg_sd = seeded_vgg19(os.path.join(tmp, "vgg19.pth"), SEED + 260)
        trainer = define_trainer(opt, dtype=torch.bfloat16, vgg_state=vgg_sd)
        require(isinstance(trainer, GanTrainer), type(trainer).__name__)
        sd = seeded_train_weights(trainer.model, SEED + 261)
        trainer.model.load_state_dict(sd)
        trainer.ema.load_state_dict(sd)
        n_g = sum(p.numel() for p in trainer.model.parameters())
        n_d = sum(p.numel() for p in trainer.model_d.parameters())
        ph.note(f"SwinIR-L x4 (embed 240, depths 9x6, 8 heads, window 8, "
                f"3conv, nearest+conv, {n_g} params, blocks by BLOCK_INIT) "
                f"against discriminator_unet (base 64, spectral norm, {n_d} "
                f"params) with the training fields of {GAN_OPTION}: "
                f"{ot['G_lossfn_type']} pixel x{ot['G_lossfn_weight']}, VGG19 "
                f"layer {ot['F_feature_layer']} l1 x{ot['F_lossfn_weight']} "
                f"(seeded torchvision-keyed .pth through vgg_state), "
                f"{ot['gan_type']} x{ot['D_lossfn_weight']}, E_decay "
                f"{ot['E_decay']}, Adam {ot['G_optimizer_lr']} / "
                f"{ot['D_optimizer_lr']}; B={GAN_BATCH} of {GAN_H}x{GAN_H} HR "
                f"(64x64 LR; the file's H_size 96 gives a 24-pixel LR patch), "
                "dataset 'sr' on seeded smooth images (blindsr needs cv2), "
                "no warm start; bf16 autocast over f32")

        # (d) f32 passes the route check: the G's blocks run the f32
        # kernels (phase 30)
        where = bf16_only_route(trainer.model)
        require(where is None, f"--dtype f32 on the card: {where}")
        ph.note("(d) --dtype f32: no bf16-only route in the G (its blocks "
                "take the f32 kernels, phase 30)" + lap())

        dataset = seeded_dataset(ds_opt, 64, SEED + 262, size=320)
        loader = Loader(dataset, GAN_BATCH, seed=SEED)
        batches = [{k: v for k, v in bt.items() if hasattr(v, "shape")}
                   for bt in itertools.islice(loader.epoch(0), 4)]
        batches += [{k: v for k, v in bt.items() if hasattr(v, "shape")}
                    for bt in itertools.islice(loader.epoch(1), 4)]
        require(len(batches) == 8
                and batches[0]["L"].shape == (GAN_BATCH, 64, 64, 3)
                and batches[0]["H"].shape == (GAN_BATCH, GAN_H, GAN_H, 3),
                f"{len(batches)} batches, {batches[0]['L'].shape}")

        # (a) one step's G and D gradients at B=1, bf16 kernels against the
        # f32 composed route on the card
        small = {k: v[:1] for k, v in batches[0].items()}
        u0 = spectral_vectors(trainer.model_d)
        zero_counts()
        msw.swin_block_win_reference = counted
        try:
            g_card, d_card = gan_grads(trainer, small, u0)
        finally:
            msw.swin_block_win_reference = ref_fn
        grad_counts = read_counts()
        p_card = pixel_grads(trainer, small)
        ref = copy.copy(trainer)
        ref.dtype = torch.float32
        with composed_swin_blocks():
            g_ref, d_ref = gan_grads(ref, small, u0)
            p_ref = pixel_grads(ref, small)
            p_ctl = cpu_without_shift_mask(lambda: pixel_grads(ref, small))
            ref.vgg.use_input_norm = False
            g_ctl, _ = gan_grads(ref, small, u0)
            ref.vgg.use_input_norm = True
            d_ctl = d_grads_on(ref, small, None, u0)
        parts = swinir_l_parts(g_ref)
        blocks = [n for n in g_ref if n.startswith("layers.")]

        def by_part(a, b):
            out = {k: rel_norm(a, b, v) for k, v in parts.items()}
            out["blocks"] = rel_norm(a, b, blocks)
            out["all"] = rel_norm(a, b, list(b))
            return out
        fmt = lambda d: ", ".join(f"{k} {v:.4g}" for k, v in d.items())
        perr, pctl = by_part(p_card, p_ref), by_part(p_ctl, p_ref)
        pworst = max(parts, key=perr.get)
        ph.note(f"(a) gradient at B=1 (64x64 LR), bf16 kernels vs the f32 "
                "composed route on the card, relative norm. The l1 pixel loss "
                "alone (the kernels' share): " + fmt(perr) + f" (limits "
                f"{px_all} over all, {px_blocks} the 54 blocks, {px_part} a "
                f"part; worst {pworst}); control, the f32 route without the "
                "shift mask: " + fmt(pctl) + lap())
        require(perr["all"] <= px_all and perr["blocks"] <= px_blocks
                and perr[pworst] <= px_part,
                f"pixel-loss gradient {perr['all']:.4g} / blocks "
                f"{perr['blocks']:.4g} / {pworst} {perr[pworst]:.4g}")
        require(pctl["blocks"] > px_blocks
                and pctl["blocks"] > 3 * perr["blocks"],
                "the dropped-mask control is not above the blocks' limit and "
                "3x their error")
        err, ctl = by_part(g_card, g_ref), by_part(g_ctl, g_ref)
        err["D"] = rel_norm(d_card, d_ref, list(d_ref))
        ctl["D"] = rel_norm(d_ctl, d_ref, list(d_ref))
        worst = max(parts, key=err.get)
        ph.note("(a) the whole GAN step (pixel + VGG + ragan, VGG and D "
                "under autocast): " + fmt(err) + f" (limits {st_all} G over "
                f"all, {st_part} a part of G, {st_d} D; worst {worst}); "
                "controls, the f32 route with VGG's input norm off (G) and "
                "with D's fake batch the real one (D): " + fmt(ctl)
                + f"; launches in that step {grad_counts}" + lap())
        require(err["all"] <= st_all and err[worst] <= st_part
                and err["D"] <= st_d,
                f"GAN-step gradient G {err['all']:.4g}, {worst} "
                f"{err[worst]:.4g}, D {err['D']:.4g}")
        require(ctl["all"] > st_all and ctl["all"] > 3 * err["all"]
                and ctl[worst] > st_part and ctl[worst] > 3 * err[worst]
                and ctl["D"] > st_d and ctl["D"] > 3 * err["D"],
                "a GAN-step control is not above its limit and 3x the error")
        require(grad_counts == {"row1": 54, "row1_win": 0, "row3": 54,
                                "composed": 0},
                f"launches in the gradient step {grad_counts}")
        del ref
        torch.cuda.empty_cache()

        # (b)-(c) the main path: B=16 steps
        trainer.train_step(batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed = 3

        def run(bts, update_g):
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            ms_ = [trainer.train_step(bt, update_g=update_g) for bt in bts]
            e.record()
            torch.cuda.synchronize()
            vals = [float(m["D_total"]) for m in ms_]
            require(all(math.isfinite(v) for v in vals), f"D losses {vals}")
            return s.elapsed_time(e) / len(bts), ms_

        zero_counts()
        msw.swin_block_win_reference = counted
        try:
            ms_gd, m_gd = run(batches[1:1 + timed], True)
            per_g = {k: v // timed for k, v in read_counts().items()}
            zero_counts()
            ms_d, _ = run(batches[4:4 + timed], False)
            per_d = {k: v // timed for k, v in read_counts().items()}
        finally:
            msw.swin_block_win_reference = ref_fn
        mem = torch.cuda.max_memory_allocated()
        ph.note(f"(b) launches per G+D step over {timed}: {per_g}; per "
                f"D-only step (G's forward for E): {per_d}")
        require(per_g == {"row1": 54, "row1_win": 0, "row3": 54,
                          "composed": 0}
                and per_d == {"row1": 54, "row1_win": 0, "row3": 0,
                              "composed": 0},
                f"launches {per_g} / {per_d}")
        for k in report:
            if k["name"] in ("swin_block_2d", "swin_block_2d_bwd"):
                k["gan_train_launches_per_g_update"] = per_g[
                    "row1" if k["name"] == "swin_block_2d" else "row3"]
        g_fwd = swinir_flops_per_lr_pixel(
            240, (6,) * 9, 8, 8, 2.0, 64, 3, 4, "nearest+conv", "3conv") \
            * 64 * 64 * GAN_BATCH
        h1 = torch.zeros(1, GAN_H, GAN_H, 3, device="cuda")
        vgg_fwd = conv_flops(trainer.vgg, h1) * GAN_BATCH
        d_fwd = conv_flops(copy.deepcopy(trainer.model_d), h1) * GAN_BATCH
        # G: forward + backward; VGG: E and H forward, E's input gradient;
        # D: G's pass (E forward + input gradient, H forward for ragan),
        # D's real and fake passes forward and backward
        flops_gd = 3 * g_fwd + 3 * vgg_fwd + 9 * d_fwd
        flops_d = g_fwd + 6 * d_fwd
        peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
        mfu = lambda f, ms: f / (ms / 1e3) / 1e12 / peak if peak else None
        fmt = lambda v: "n/a" if v is None else f"{v:.4f}"
        ph.note(f"(c) B={GAN_BATCH}: G+D step {ms_gd:.2f} ms (mean of "
                f"{timed} after 1, CUDA events), D-only step (G forward + D "
                f"update) {ms_d:.2f} ms; so the G update about "
                f"{ms_gd - ms_d:.2f} ms past G's forward; losses G "
                f"{float(m_gd[-1]['G_loss']):.4g}, F "
                f"{float(m_gd[-1]['F_loss']):.4g}, D_loss "
                f"{float(m_gd[-1]['D_loss']):.4g}, D_total "
                f"{float(m_gd[-1]['D_total']):.4g}; analytic FLOP a G+D step "
                f"{flops_gd / 1e12:.3f} T (G forward {g_fwd / 1e12:.3f}, VGG "
                f"forward {vgg_fwd / 1e12:.3f}, D forward {d_fwd / 1e12:.3f}; "
                f"x3, x3, x9), MFU {fmt(mfu(flops_gd, ms_gd))}; D-only "
                f"{flops_d / 1e12:.3f} T, MFU {fmt(mfu(flops_d, ms_d))} "
                f"against {peak} TFLOP/s; peak memory {mem / 2 ** 30:.2f} "
                f"GiB [{card}]" + lap())
        ph.note("(c) " + device_breakdown(
            lambda: [trainer.train_step(bt, update_g=True)
                     for bt in batches[6:8]], 2, ms_gd, "G+D step", top=10,
            sums=("swin_", "sm90", "sm80")) + lap())
        del trainer
        torch.cuda.empty_cache()

        # (e) cli.train_gan: first the recipe above (SwinIR-L, the U-Net D,
        # bf16, B=16 of 256x256, --vgg loaded by torch.load), 2 steps then a
        # resume to 3, its launches counted over both runs; then the shipped
        # option file as it is (MSRResNet0, the VGG-style D with BatchNorm,
        # f32), likewise
        vgg_path = os.path.join(tmp, "vgg19.pth")
        runs = (("recipe", gan_options(tmp, net_g, GAN_NETD, GAN_H,
                                       name="recipe.json"),
                 ["--dtype", "bf16"], GAN_BATCH * 2, 320),
                ("shipped", gan_options(tmp, name="shipped.json"), [],
                 16 * 2, 200))
        made = mdatasets.define_dataset
        for key, (path, opt_e), extra, n_img, size in runs:
            def seeded_define(ds, n_img=n_img, size=size):
                return seeded_dataset(ds, n_img, SEED + 263, size=size)
            mdatasets.define_dataset = seeded_define
            train_gan.define_dataset = seeded_define
            zero_counts()
            msw.swin_block_win_reference = counted
            try:
                argv = ["--opt", path, "--vgg", vgg_path] + extra
                t1 = train_gan.main(argv=argv + ["--max_steps", "2"])
                first = (t1.step, t1.g_updates, t1.dtype)
                del t1
                t2 = train_gan.main(argv=argv + ["--max_steps", "3"])
            finally:
                mdatasets.define_dataset = made
                train_gan.define_dataset = made
                msw.swin_block_win_reference = ref_fn
            counts = read_counts()
            models = opt_e["path"]["models"]
            files = sorted(os.listdir(models))
            g3 = torch.load(os.path.join(models, "3_G.pth"), weights_only=True)
            require(all(torch.isfinite(v).all() for v in g3.values()
                        if v.is_floating_point()), f"{key}: 3_G.pth not finite")
            require(first[:2] == (2, 2) and t2.step == 3 and t2.g_updates == 3
                    and all(f"{s}_{tag}.pth" in files for s in (2, 3)
                            for tag in ("G", "D", "E", "optimizerG",
                                        "optimizerD")),
                    f"{key} GAN file: steps {first[0]}/{t2.step}, G updates "
                    f"{first[1]}/{t2.g_updates}, files {files}")
            if key == "recipe":
                n_up = 3
                require(first[2] == t2.dtype == torch.bfloat16
                        and counts == {"row1": 54 * n_up, "row1_win": 0,
                                       "row3": 54 * n_up, "composed": 0},
                        f"cli.train_gan SwinIR-L: dtype {t2.dtype}, launches "
                        f"{counts} over {n_up} G updates")
                ph.note(f"(e) cli.train_gan --dtype bf16 --vgg on the recipe "
                        f"(SwinIR-L x4, discriminator_unet, B="
                        f"{opt_e['datasets']['train']['dataloader_batch_size']}"
                        f" of {opt_e['datasets']['train']['H_size']}x"
                        f"{opt_e['datasets']['train']['H_size']} HR through "
                        "make_train_loader): 2 steps, then a resume to 3 "
                        f"({len(files)} checkpoint files); launches over the "
                        f"{n_up} G+D steps {counts}" + lap())
            else:
                bn = t2.model_d.bn1
                require(int(bn.num_batches_tracked) == 12
                        and first[2] == t2.dtype == torch.float32,
                        f"shipped GAN file: bn1 batches "
                        f"{int(bn.num_batches_tracked)}, dtype {t2.dtype}")
                ph.note(f"(e) {GAN_OPTION} as shipped (MSRResNet0 64/16, "
                        f"discriminator_vgg_96 with BatchNorm, ragan, f32, B="
                        f"{opt_e['datasets']['train']['dataloader_batch_size']}"
                        f" of 96x96 HR) through cli.train_gan: 2 steps, then a "
                        f"resume to 3 ({files}); D's bn1 saw "
                        f"{int(bn.num_batches_tracked)} training batches (4 a "
                        "ragan step)" + lap())
            del t2
            torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# The face slice (phase 27)
# ---------------------------------------------------------------------------

# max_abs / max|ref|, bf16 on the card vs f32 on the CPU: GPEN-512 read
# 0.0190 and 0.0313 on two faces on an H100 (about 20 convolutions of
# 512-1024 channels in bf16), its control (demodulation off) 5.6
FACE_LIMIT = 5e-2


def seeded_face_models(tmp: str, seed: int):
    """KAIR-keyed GPEN-BFR-512 (size 512, style 512, 8 MLP layers, channel
    multiplier 2; StyleGAN2's own initialisation, noise weights 0.2 so the
    encoder's maps reach the output) and RetinaFace-R50 (torchvision's
    initialisation) ``.pth`` files in ``tmp``; their paths."""
    import torch
    from kair_tpu_torch.models.gpen import FullGenerator
    from kair_tpu_torch.models.retinaface import RetinaFace
    torch.manual_seed(seed)
    sd = FullGenerator(size=512, style_dim=512, n_mlp=8,
                       channel_multiplier=2).state_dict()
    for k in sd:
        if k.endswith("noise.weight"):
            sd[k] = torch.full_like(sd[k], 0.2)
    gpen = os.path.join(tmp, "GPEN-BFR-512.pth")
    torch.save(sd, gpen)
    retina = os.path.join(tmp, "RetinaFace-R50.pth")
    torch.save({"module." + k: v for k, v in RetinaFace().state_dict().items()},
               retina)
    return gpen, retina


def synthetic_faces(size: int = 512):
    """A 320x240 seeded image with two faces' boxes and five landmarks (the
    template moved and scaled), one under 100 px (the small-face filter)."""
    import numpy as np
    from kair_tpu_torch.utils.alignfaces import get_reference_facial_points
    tmpl = get_reference_facial_points((size, size), 0.25, (0, 0), True)
    boxes, lms = [], []
    for scale, tx, ty, score in ((0.12, 40, 30, 0.98), (0.35, 150, 60, 0.95)):
        pts = tmpl * scale + np.array([tx, ty])
        boxes.append([*(pts.min(0) - 8), *(pts.max(0) + 8), score])
        lms.append(np.concatenate([pts[:, 0], pts[:, 1]]))
    return (smooth_image(240, 320, SEED + 271), np.float32(boxes),
            np.float32(lms))


def phase_face(card: str, build_dir) -> None:
    import copy
    import numpy as np
    import torch
    from kair_tpu_torch.cli import test_face
    from kair_tpu_torch.eval.face_pipeline import (enhance_faces,
                                                   make_gpen_enhancer,
                                                   make_retinaface_detector)
    from kair_tpu_torch.models import gpen as mgpen
    from kair_tpu_torch.models.gpen import FullGenerator
    from kair_tpu_torch.models.retinaface import load_retinaface
    from kair_tpu_torch.utils.png import read_png, write_png

    with Phase("27 face") as ph, \
            tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        gpen_path, retina_path = seeded_face_models(tmp, SEED + 270)
        cpu_g = FullGenerator(512, 512, 8, 2).eval()
        cpu_g.load_state_dict(torch.load(gpen_path, weights_only=True))
        gpu_g = copy.deepcopy(cpu_g).to("cuda", torch.bfloat16)
        ph.note(f"GPEN-BFR-512 (size 512, style 512, n_mlp 8, multiplier 2, "
                f"{sum(p.numel() for p in cpu_g.parameters())} params) and "
                "RetinaFace-R50 from seeded KAIR-keyed .pth files; the card "
                "runs both in bf16 (modulation and demodulation in f32), "
                "the warps and blending are utils/cv_ops on the host")

        # (b) enhance_faces with given boxes and landmarks: bf16 on the card
        # against the same run in f32 on the CPU
        img, boxes, lms = synthetic_faces()
        det = lambda bgr: (boxes, lms)
        raw = {}

        class Recording(torch.nn.Module):
            """The GPEN model, its outputs kept under ``key``."""

            def __init__(self, model, key):
                super().__init__()
                self.model, self.key = model, key

            def forward(self, x):
                y = self.model(x)
                raw.setdefault(self.key, []).append((x.float().cpu(),
                                                     y.float().cpu()))
                return y

        recording = lambda model, key: make_gpen_enhancer(
            Recording(model, key))
        out_g, _, ef_g = enhance_faces(img, det, recording(gpu_g, "gpu"))
        out_c, _, ef_c = enhance_faces(img, det, recording(cpu_g, "cpu"))
        # the control: the CPU's first face without demodulation
        for m in cpu_g.modules():
            if isinstance(m, mgpen.ModulatedConv2d):
                m.demodulate = False
        with torch.inference_mode():
            ctls = [compare(cpu_g(raw["cpu"][0][0]), raw["cpu"][0][1])[1]]
        errs = [compare(g[1], c[1])[1] for g, c in zip(raw["gpu"], raw["cpu"])]
        img_diff = np.abs(out_g.astype(int) - out_c).max()
        ph.note(f"(b) enhance_faces, 2 faces of a 320x240 image: GPEN's "
                f"output bf16 on the card vs f32 on the CPU max_abs / "
                f"max|ref| {', '.join(f'{e:.4g}' for e in errs)} (limit "
                f"{FACE_LIMIT}); control, the f32 run of the first face "
                "without demodulation: "
                f"{', '.join(f'{c:.4g}' for c in ctls)}; the blended images "
                f"differ by at most {img_diff} levels, the enhanced faces by "
                f"{max(np.abs(a.astype(int) - b).max() for a, b in zip(ef_g, ef_c))}")
        require(len(errs) == 2 and max(errs) <= FACE_LIMIT,
                f"GPEN bf16 error {errs}")
        require(min(ctls) > FACE_LIMIT and min(ctls) > 3 * max(errs),
                f"the control {ctls} is not above the limit and 3x the error")

        # the detector: bf16 on the card against f32 on the CPU
        cpu_r = load_retinaface(retina_path)
        gpu_r = copy.deepcopy(cpu_r).to("cuda", torch.bfloat16)
        x = torch.from_numpy(img[None, :, :, ::-1].astype(np.float32)
                             - np.float32([104, 117, 123]))
        with torch.inference_mode():
            r_g = [t.float().cpu() for t in gpu_r(x.cuda().to(torch.bfloat16))]
            r_c = cpu_r(x)
            r_ctl = cpu_r(x + torch.tensor([104.0, 117.0, 123.0]))
        r_err = [compare(g, c)[1] for g, c in zip(r_g, r_c)]
        r_ctl = [compare(g, c)[1] for g, c in zip(r_ctl, r_c)]
        ph.note(f"RetinaFace boxes / scores / landmarks bf16 vs f32 "
                f"{', '.join(f'{e:.4g}' for e in r_err)} (limit {FACE_LIMIT}); "
                "control, the f32 run without the BGR means subtracted: "
                + ", ".join(f"{e:.4g}" for e in r_ctl))
        require(max(r_err) <= FACE_LIMIT and min(r_ctl) > 3 * max(r_err),
                f"RetinaFace {r_err}, control {r_ctl}")

        # (a) cli.test_face end to end: a 128x128 seeded PNG, upscaled x2;
        # the threshold set under the detector's third score
        src = os.path.join(tmp, "in")
        os.makedirs(src)
        write_png(os.path.join(src, "face.png"), smooth_image(128, 128,
                                                              SEED + 272))
        up = test_face.read_rgb(os.path.join(src, "face.png"))
        from kair_tpu_torch.utils import cv_ops
        up = cv_ops.resize_linear(up, (256, 256))
        dets, _ = make_retinaface_detector(gpu_r, 0.0)(cv_ops.rgb_bgr(up))
        thr = float(np.sort(dets[:, 4])[-3]) - 1e-6
        t0 = time.perf_counter()
        res = test_face.main([
            "--input", src, "--output", os.path.join(tmp, "out"),
            "--retinaface", retina_path, "--gpen", gpen_path,
            "--threshold", f"{thr}", "--save_faces"])
        dt = time.perf_counter() - t0
        (name, out, n_faces), = res
        back = read_png(os.path.join(tmp, "out", "face_enhanced.png"))
        require(n_faces == 3 and out.shape == (256, 256, 3)
                and np.array_equal(back, out),
                f"cli.test_face: {n_faces} faces, {out.shape}")
        ph.note(f"(a) cli.test_face on a 128x128 PNG (--sr 2, threshold "
                f"{thr:.6f}: the detector's third score): {n_faces} faces "
                f"enhanced and pasted back, "
                f"{sorted(os.listdir(os.path.join(tmp, 'out')))} in "
                f"{dt:.2f} s (models loaded, host warps included)")

        # (c) GPEN's time per 512x512 face, bf16, batch 1
        xg = torch.randn(1, 512, 512, 3, generator=torch.Generator()
                         .manual_seed(SEED + 273)).to("cuda", torch.bfloat16)
        with torch.inference_mode():
            ms = cuda_ms(lambda: gpu_g(xg))
        ph.note(f"(c) GPEN-BFR-512 {ms:.2f} ms per 512x512 face (median of "
                f"10, CUDA events, bf16, batch 1) [{card}]")
        del gpu_g, gpu_r
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The SPECT fork (phase 28)
# ---------------------------------------------------------------------------

SPECT_DIR = "options/spect"
SPECT_SETS = {"train": 8, "val": 2, "test": 2}
# the template's test and val_2 sets read indices 96-99 of a 100-scan
# folder, the training set indices 0-95
SPECT_TEST_START = 96
SPECT_TRAIN_ITEMS = 32
# the gradient of the first SwinIR step against the f32 plain route: the
# limits phase 24 holds the gray recipe to (over all, a block parameter);
# read 0.005806 and 0.03214 on an H100 with one cotangent fed to both
SPECT_GRAD_LIMITS = (8e-3, 1e-1)
# the bf16 evaluation forward against the f32 plain route, max_abs over
# max|ref| (PERF.md §2's model gate)
SPECT_EVAL_LIMIT = 2e-2
# the CNNs' gradient at B=2, card f32 against the CPU's (phase 24's limit)
SPECT_CNN_LIMIT = 1e-4


def spect_phantom(rng, peak: float = 150.0):
    """A smooth seeded count rate (1024, 256, 2), up to ``peak``: a few
    Gaussian blobs a view."""
    import numpy as np
    yy, xx = np.mgrid[:1024, :256] / np.array([1024.0, 256.0])[:, None, None]
    rate = np.zeros((1024, 256, 2))
    for c in range(2):
        for _ in range(5):
            cy, cx, s = rng.random(), rng.random(), 0.05 + 0.2 * rng.random()
            rate[..., c] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / s ** 2)
    return rate / rate.max() * peak


def write_spect_sets(root: str, seed: int) -> dict:
    """Seeded SPECT scans as the fork's raw (2, 1024, 256) float32 .dat
    files: H Poisson counts of a smooth phantom up to about 150, L
    ``binomial_thin`` of H at 1/8 (the template's "speed": 8). 8 training,
    2 validation and 2 test pairs; the training folders list the 8 pairs
    4 times by symlinks (32 items: batches of 32 need them), the test
    folders put their pairs at indices 96-97 behind 96 symlinks, where the
    template's indices read them. Returns {set: (H folder, L folder)}."""
    import numpy as np
    from kair_tpu_torch.data.dataset_spect import write_spect_dat
    from kair_tpu_torch.utils.spect import binomial_thin
    rng = np.random.default_rng(seed)
    pairs = {}
    for name, n in SPECT_SETS.items():
        for i in range(n):
            h = rng.poisson(spect_phantom(rng)).astype(np.float32)
            l = binomial_thin(h, 1 / 8, rng)
            for kind, img in (("H", h), ("L", l)):
                os.makedirs(os.path.join(root, "scans", kind), exist_ok=True)
                path = os.path.join(root, "scans", kind, f"{name}{i}.dat")
                write_spect_dat(path, img)
                pairs.setdefault((name, kind), []).append(path)
    dirs = {}
    for name in SPECT_SETS:
        for kind in ("H", "L"):
            d = os.path.join(root, f"{name}{kind}")
            os.makedirs(d)
            files = pairs[(name, kind)]
            if name == "train":
                links = [files[i % len(files)]
                         for i in range(SPECT_TRAIN_ITEMS)]
            elif name == "test":
                links = [pairs[("train", kind)][0]] * SPECT_TEST_START + files
            else:
                links = files
            for i, f in enumerate(links):
                os.symlink(f, os.path.join(d, f"s{i:03d}.dat"))
        dirs[name] = (os.path.join(root, f"{name}H"),
                      os.path.join(root, f"{name}L"))
    return dirs


def spect_option_files(tmp: str, dirs: dict, test_every: int = 2,
                       poisson=()) -> dict:
    """The three experiments of options/spect generated by the port's
    config_generator, then in the generated copies: the data roots, the
    run folder, the checkpoint intervals (print 1, save and test every
    ``test_every``), ``eval_repoisson`` on val_2 (the template sets it
    nowhere); the experiments named in ``poisson`` train on the poisson
    loss at an epsilon of 1 count. Returns {experiment: path}."""
    from kair_tpu_torch import config
    from kair_tpu_torch.cli.config_generator import generate_all
    here = os.path.dirname(os.path.abspath(__file__))
    args = [os.path.join(here, SPECT_DIR, f) for f in (
        "base_template.json", "network_configs.json",
        "experiment_configs.json")]
    out = {}
    for name, path in generate_all(*args, os.path.join(tmp, "generated")
                                   ).items():
        raw = config.load_json_with_comments(path)
        raw["path"]["root"] = os.path.join(tmp, "runs")
        ds = raw["datasets"]
        for key, which in (("train", "train"), ("test", "test"),
                           ("val_1", "val"), ("val_2", "test")):
            ds[key]["dataroot_H"], ds[key]["dataroot_L"] = dirs[which]
        ds["val_2"]["eval_repoisson"] = True
        raw["train"].update(checkpoint_print=1, checkpoint_save=test_every,
                            checkpoint_test=test_every)
        if name in poisson:
            raw["train"].update(G_lossfn_type="poisson", G_poisson_epsilon=1.0)
        out[name] = os.path.join(tmp, f"{name}.json")
        with open(out[name], "w") as f:
            json.dump(raw, f)
    return out


def loss_grads(trainer, batch, cot=None) -> tuple:
    """(G's f32 gradients, the output E in f32) of the trainer's loss on
    ``batch``, or of ``E · cot`` when a cotangent dL/dE is given."""
    import torch
    from kair_tpu_torch.train.trainer import _tensor
    trainer.optimizer.zero_grad(set_to_none=True)
    with trainer._autocast():
        e = trainer.model(*trainer._args(batch)).float()
    if cot is None:
        h = _tensor(batch["H"], trainer.device).float()
        (trainer.loss_weight * trainer.loss_fn(e, h)).backward()
    else:
        e.backward(cot)
    return ({n: (torch.zeros_like(p) if p.grad is None else p.grad)
             .detach().float().cpu()
             for n, p in trainer.model.named_parameters()}, e.detach())


def spect_batches(ds_opt, n: int, seed: int) -> list:
    """``n`` training batches of the option block's dataset (the files on
    disk) through the port's Loader, epoch after epoch."""
    from kair_tpu_torch.data.base import Loader
    from kair_tpu_torch.data.datasets import define_dataset
    loader = Loader(define_dataset(ds_opt), ds_opt["dataloader_batch_size"],
                    seed=seed)
    out, epoch = [], 0
    while len(out) < n:
        out += [{k: v for k, v in bt.items() if k in ("L", "H")}
                for bt in loader.epoch(epoch)]
        epoch += 1
    return out[:n]


def spect_cnn_case(ph, name: str, path: str, card: str, seed: int) -> None:
    """A SPECT CNN from its generated option file in f32 at the file's
    batch: the gradient at B=2 (32x32 crops) on the card against the CPU's
    within SPECT_CNN_LIMIT, the weights of seed + 1 on the card as the
    control; 1 warm-up and 3 timed steps."""
    import numpy as np
    import torch
    from kair_tpu_torch import config
    from kair_tpu_torch.train.select import define_trainer

    opt = config.parse(path, is_train=True)
    ds_opt, ot = opt["datasets"]["train"], opt["train"]
    torch.manual_seed(seed)
    trainer = define_trainer(opt, dtype=torch.float32)
    batches = spect_batches(ds_opt, 4, SEED)
    small = {k: np.ascontiguousarray(v[:2, :32, :32])
             for k, v in batches[0].items()}
    g_card = grads_of(trainer, small)
    cpu = define_trainer(opt, dtype=torch.float32, device="cpu")
    cpu.model.load_state_dict(trainer.model.state_dict())
    g_cpu = grads_of(cpu, small)
    del cpu
    torch.manual_seed(seed + 1)
    alt = define_trainer(opt, dtype=torch.float32)
    names = list(g_cpu)
    err = rel_norm(g_card, g_cpu, names)
    eff = rel_norm(grads_of(alt, small), g_cpu, names)
    del alt
    loss = ot["G_lossfn_type"] + (
        f" (epsilon {ot['G_poisson_epsilon']})"
        if ot["G_lossfn_type"] == "poisson" else "")
    ph.note(f"{name} ({opt['netG']['net_type']}, in_nc "
            f"{opt['netG']['in_nc']}, "
            f"{sum(p.numel() for p in trainer.model.parameters())} params, "
            f"{loss}): gradient B=2 of 32x32, f32 card vs CPU relative norm "
            f"{err:.4g} (limit {SPECT_CNN_LIMIT}), control (seed + 1 "
            f"weights) {eff:.4g}")
    require(err <= SPECT_CNN_LIMIT, f"{name}: gradient error {err:.4g}")
    require(eff > SPECT_CNN_LIMIT and eff > 3 * err,
            f"{name}: the seed + 1 control {eff:.4g} is not above the limit "
            "and 3x the error")
    torch.cuda.reset_peak_memory_stats()
    ms, losses = timed_steps(trainer, batches)
    bs = ds_opt["dataloader_batch_size"]
    require(batches[0]["L"].shape == (bs, 64, 64, 2),
            f"{name}: batch {batches[0]['L'].shape}")
    ph.note(f"{name}: f32 B={bs} of 64x64x2, losses {losses[0]:.4g} .. "
            f"{losses[-1]:.4g}; ms_per_step {ms:.2f} (mean of 3 after 1, "
            f"CUDA events), {bs / (ms / 1e3):.1f} patches/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    del trainer
    torch.cuda.empty_cache()


def phase_spect(report: list, card: str, build_dir) -> None:
    import copy
    import numpy as np
    import torch
    from kair_tpu_torch import config
    from kair_tpu_torch.cli import train_spect
    from kair_tpu_torch.ops.kernels import conv_block, swin_block
    from kair_tpu_torch.train.select import define_trainer
    from kair_tpu_torch.train.trainer import bf16_only_route

    lo_all, lo_param = SPECT_GRAD_LIMITS
    t0 = time.perf_counter()
    lap = lambda: f" [{time.perf_counter() - t0:.1f} s into the phase]"
    with Phase("28 spect") as ph, \
            tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        dirs = write_spect_sets(os.path.join(tmp, "data"), SEED + 280)
        paths = spect_option_files(tmp, dirs,
                                   poisson=("drunet_psnr_8x_linear",))
        ph.note(f"seeded scans (2, 1024, 256) float32: H Poisson counts of "
                f"a smooth phantom up to 150, L binomial_thin at 1/8; "
                f"{SPECT_SETS} pairs; option files from options/spect by "
                f"cli.config_generator: {sorted(paths)}" + lap())

        # (a) SPECT SwinIR: bf16, the generated file's batch 16 of 64x64
        opt = config.parse(paths["swinir_psnr_8x_linear"], is_train=True)
        net, ds_opt = opt["netG"], opt["datasets"]["train"]
        bs = ds_opt["dataloader_batch_size"]
        torch.manual_seed(SEED + 280)
        trainer = define_trainer(opt, dtype=torch.bfloat16)
        where = bf16_only_route(trainer.model)
        require(where is None, f"--dtype f32 on the card: {where}")
        sd = seeded_train_weights(trainer.model, SEED + 281)
        trainer.model.load_state_dict(sd)
        trainer.ema.load_state_dict(sd)
        batches = spect_batches(ds_opt, 4, SEED)
        require(batches[0]["L"].shape == (bs, 64, 64, 2),
                f"SPECT batch {batches[0]['L'].shape}")
        n_blocks = sum(net["depths"])
        ph.note(f"(a) SPECT SwinIR (embed {net['embed_dim']}, depths "
                f"{net['depths']}, {net['num_heads'][0]} heads, window "
                f"{net['window_size']}, in_nc {net['in_nc']}, upsampler "
                f"{net['upsampler']}, "
                f"{sum(p.numel() for p in trainer.model.parameters())} "
                f"params, blocks by BLOCK_INIT), "
                f"{opt['train']['G_lossfn_type']} loss, batch {bs} of 64x64x2; "
                "--dtype f32: no bf16-only route (the f32 kernels, phase 30)"
                + lap())

        # the first step's gradient: bf16 kernels against the f32 plain
        # route on the card. Charbonnier at eps 1e-9 is sign(E - H)
        # wherever |E - H| > 3e-5: where bf16 moves E across H, dL/dE
        # flips, and the whole step's gradient carries that noise. So the
        # kernels are held to the f32 route with one cotangent, the f32
        # route's dL/dE, fed to both backwards (control over all: the
        # shifted blocks reading one pixel off; a block parameter: no
        # shift mask, which hardly moves the norm over all, held by
        # conv_first, the tails and the LayerNorms), and each route's own
        # loss gradient a block parameter.
        b0 = batches[0]
        h0 = torch.from_numpy(b0["H"]).cuda()
        g_card, e_card = loss_grads(trainer, b0)
        ref = copy.copy(trainer)
        ref.dtype = torch.float32
        with composed_swin_blocks():
            g_ref, e_ref = loss_grads(ref, b0)
            e_leaf = e_ref.clone().requires_grad_(True)
            trainer.loss_fn(e_leaf, h0).backward()
            cot = e_leaf.grad * trainer.loss_weight
            c_ref, _ = loss_grads(ref, b0, cot)
            c_ctl, _ = cpu_without_shift_mask(lambda: loss_grads(ref, b0, cot))
            g_ctl, _ = cpu_without_shift_mask(lambda: loss_grads(ref, b0))
        with composed_swin_blocks(phase_off=1):
            c_off, _ = loss_grads(ref, b0, cot)
        c_card, _ = loss_grads(trainer, b0, cot)
        del ref
        flips = ((e_card - h0).sign() != (e_ref - h0).sign()).float().mean()
        names = list(g_ref)
        block = [n for n in names if ".residual_group.blocks." in n]

        def held(card_g, ref_g, ctl_g):
            per = {n: rel_norm(card_g, ref_g, [n]) for n in block}
            eff = {n: rel_norm(ctl_g, ref_g, [n]) for n in block}
            worst, eff_worst = max(per, key=per.get), max(eff, key=eff.get)
            return (rel_norm(card_g, ref_g, names), worst, per[worst],
                    rel_norm(ctl_g, ref_g, names), eff_worst, eff[eff_worst])
        c_all, c_w, c_wv, cc_all, cc_w, cc_wv = held(c_card, c_ref, c_ctl)
        g_all, g_w, g_wv, gc_all, gc_w, gc_wv = held(g_card, g_ref, g_ctl)
        co_all = rel_norm(c_off, c_ref, names)
        ph.note(f"(a) first step's gradient at B={bs}, bf16 card vs the f32 "
                f"plain route on the card, relative norm; with the f32 "
                f"route's dL/dE fed to both: {c_all:.4g} over all (limit "
                f"{lo_all}), worst block parameter {c_w} {c_wv:.4g} (limit "
                f"{lo_param}); controls: without the shift mask "
                f"{cc_all:.4g} over all, {cc_wv:.4g} at {cc_w}; the shifted "
                f"blocks reading one pixel off {co_all:.4g} over all. Each "
                f"route's own loss "
                f"gradient: {g_all:.4g} over all, worst block parameter "
                f"{g_w} {g_wv:.4g} (limit {lo_param}), control {gc_all:.4g} "
                f"/ {gc_wv:.4g} at {gc_w}; sign(E - H) differs at "
                f"{flips.item():.4f} of the pixels [{card}]" + lap())
        require(c_all <= lo_all and c_wv <= lo_param,
                f"SPECT gradient {c_all:.4g} / {c_w} {c_wv:.4g}")
        require(co_all > lo_all and co_all > 3 * c_all,
                "SPECT: the one-pixel-off control is not above the limit and "
                "3x the error over all")
        require(cc_wv > lo_param and cc_wv > 3 * c_wv,
                "SPECT: the dropped-mask control is not above the block "
                "parameter limit and 3x the worst error")
        require(g_wv <= lo_param and gc_wv > lo_param and gc_wv > 3 * g_wv,
                f"SPECT loss gradient {g_w} {g_wv:.4g}, control {gc_wv:.4g}")
        del g_card, g_ref, g_ctl, c_card, c_ref, c_ctl, c_off

        # steps: 36 row-1 and 36 row-3 launches a step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        swin_block.swin_block_2d_bwd.launches = 0
        with LaunchCount() as lc:
            ms, losses = timed_steps(trainer, batches)
        n_bwd = swin_block.swin_block_2d_bwd.launches
        mem = torch.cuda.max_memory_allocated()
        steps = len(batches)
        lc.expect("SPECT training", swin_block_2d=n_blocks * steps,
                  swin_block_2d_bwd=n_blocks * steps)
        require(n_bwd == n_blocks * steps,
                f"SPECT training: {n_bwd} backward launches in {steps} steps")
        per_step = {"swin_block_2d": lc.counts["swin_block_2d"] // steps,
                    "swin_block_2d_bwd": n_bwd // steps}
        for k in report:
            if k["name"] in per_step:
                k["spect_train_launches_per_step"] = per_step[k["name"]]
        prof = device_breakdown(lambda: [trainer.train_step(bt)
                                         for bt in batches[1:3]], 2, ms,
                                "step", sums=("swin_",))
        ph.note(f"(a) launches in {steps} steps: swin_block_2d "
                f"{lc.counts['swin_block_2d']}, swin_block_2d_bwd {n_bwd}, "
                f"conv tail {lc.counts['conv3x3_residual']}, composed "
                f"{lc.counts['composed']} ({n_blocks} + {n_blocks} a step); "
                f"losses {losses[0]:.4g} .. {losses[-1]:.4g}; ms_per_step "
                f"{ms:.2f} (bf16, mean of 3 after 1, CUDA events), "
                f"{bs / (ms / 1e3):.1f} patches/s, peak memory "
                f"{mem / 2 ** 30:.2f} GiB (no use_checkpoint); {prof} "
                f"[{card}]" + lap())

        # (b) the evaluation forward on a full 1024x256 scan: the EMA copy
        # in bf16 through rows 1 and 2 against the f32 plain route
        from kair_tpu_torch.data.dataset_spect import DatasetSPECT
        val = DatasetSPECT(opt["datasets"]["val_1"])
        lq = val.get_example(0, None)["L"][None]
        with LaunchCount() as lc:
            out = trainer.eval_step({"L": lq}, use_ema=True)
        lc.expect("SPECT evaluation forward", swin_block_2d=n_blocks,
                  conv3x3_residual=len(net["depths"]) + 1)
        ref_m = copy.deepcopy(trainer.ema).float().train()
        x = torch.from_numpy(lq).cuda()
        with torch.no_grad(), composed_swin_blocks():
            want = ref_m(x)
            ctl = cpu_without_shift_mask(lambda: ref_m(x))
        del ref_m
        _, rel, ref_max, _ = compare(out, want)
        _, rel_ctl, _, _ = compare(ctl, want)
        _, rel_res, _, _ = compare(out - x, want - x)
        ph.note(f"(b) evaluation forward 1x1024x256x2 (128 x 32 windows, "
                f"the shift mask at both edges): {n_blocks} swin_block_2d + "
                f"{len(net['depths']) + 1} conv tail launches, bf16 vs the "
                f"f32 plain route on the card max_abs / max|ref| {rel:.4g} "
                f"(limit {SPECT_EVAL_LIMIT}; max|ref| {ref_max:.4g}; on the "
                f"network's residual out - L {rel_res:.4g}); control without "
                f"the shift mask {rel_ctl:.4g} [{card}]" + lap())
        require(torch.isfinite(out).all().item()
                and out.shape == (1, 1024, 256, 2), f"eval out {out.shape}")
        require(rel <= SPECT_EVAL_LIMIT, f"SPECT eval error {rel:.4g}")
        require(rel_ctl > SPECT_EVAL_LIMIT and rel_ctl > 3 * rel,
                f"SPECT eval control {rel_ctl:.4g} is not above the limit "
                "and 3x the error")
        model_bf16 = copy.deepcopy(trainer.ema).to(torch.bfloat16).eval()
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: model_bf16(x), warmup=1, reps=5)
        del model_bf16, trainer
        torch.cuda.empty_cache()
        ph.note(f"(b) evaluation forward {fwd_ms:.2f} ms a 1024x256 scan "
                f"(median of 5, CUDA events, bf16) [{card}]")

        # (c) cli.train_spect --dtype bf16: 4 steps with an evaluation at
        # 2 and 4 (every test* / val* set, val_2 also re-Poissoned), then a
        # resume to 5; each evaluation timed and its launches counted
        evals, run = [], train_spect.run_evals

        def timed_evals(*a, **kw):
            n1 = swin_block.swin_block_2d.launches
            n2 = conv_block.conv3x3_residual.launches
            t1 = time.perf_counter()
            m = run(*a, **kw)
            evals.append((time.perf_counter() - t1,
                          swin_block.swin_block_2d.launches - n1,
                          conv_block.conv3x3_residual.launches - n2, m))
            return m
        path = paths["swinir_psnr_8x_linear"]
        train_spect.run_evals = timed_evals
        try:
            with LaunchCount() as lc:
                swin_block.swin_block_2d_bwd.launches = 0
                t1 = train_spect.main(argv=["--opt", path, "--dtype", "bf16",
                                            "--max_steps", "4"])
                first = (t1.step, t1.dtype)
                del t1
                t2 = train_spect.main(argv=["--opt", path, "--dtype", "bf16",
                                            "--max_steps", "5"])
                n_bwd = swin_block.swin_block_2d_bwd.launches
        finally:
            train_spect.run_evals = run
        step2 = t2.step
        del t2
        torch.cuda.empty_cache()
        task = config.parse(path)["path"]["task"]
        models = os.path.join(task, "models")
        n_img = sum(len(DatasetSPECT(opt["datasets"][k])) * (
            2 if opt["datasets"][k].get("eval_repoisson") else 1)
            for k in opt["datasets"] if k.startswith(("test", "val")))
        with open(os.path.join(task, "metrics.csv")) as f:
            csv_lines = f.read().strip().splitlines()
        plots = sorted(f for f in os.listdir(task) if f.startswith("corr_"))
        best = sorted(os.listdir(os.path.join(models, "bestmodel")))
        secs = ", ".join(f"{s:.2f} s ({a} + {c} launches)"
                         for s, a, c, _ in evals)
        ph.note(f"(c) cli.train_spect --dtype bf16: 4 steps, then a resume "
                f"to {step2}; {len(evals)} evaluations of {n_img} scans "
                f"each (test, val_1, val_2 clean and re-Poissoned): {secs}; "
                f"metrics.csv {len(csv_lines) - 1} rows x "
                f"{len(csv_lines[0].split(','))} columns; best files {best}; "
                f"plots {plots[:2]} and {len(plots) - 2} more; launches over "
                f"both runs {lc.counts}, swin_block_2d_bwd {n_bwd} [{card}]"
                + lap())
        last = evals[-1][3]
        require(first == (4, torch.bfloat16) and step2 == 5,
                f"cli.train_spect steps {first} / {step2}")
        require(len(evals) == 2 and all(
            a == n_blocks * n_img and c == (len(net["depths"]) + 1) * n_img
            for _, a, c, _ in evals),
            f"evaluation launches {[(a, c) for _, a, c, _ in evals]}")
        # the last evaluation's launches a scan, as cli.train_spect made them
        _, a_last, c_last, _ = evals[-1]
        per_scan = {"swin_block_2d": a_last // n_img,
                    "conv3x3_residual": c_last // n_img}
        for k in report:
            if k["name"] in per_scan:
                k["spect_eval_launches_per_scan"] = per_scan[k["name"]]
        require(lc.counts["swin_block_2d"] == n_blocks * (5 + 2 * n_img)
                and n_bwd == n_blocks * 5 and lc.counts["composed"] == 0,
                f"cli.train_spect launches {lc.counts}, backward {n_bwd}")
        require(len(csv_lines) == 3 and all(np.isfinite(v) for v in
                                            last.values())
                and "val_2_poisson_pll" in last and "test_psnr" in last
                and last["test_loss"] > 0,
                f"metrics {last}")
        require(best == ["best_psnr_E.pth", "best_psnr_G.pth",
                         "best_ssim_E.pth", "best_ssim_G.pth"]
                and len(plots) == 6 and {"4_G.pth", "5_G.pth"} <= set(
                    os.listdir(models)), f"files {best} {plots}")
        ph.note("(c) the last evaluation: " + ", ".join(
            f"{k} {v:.4g}" for k, v in last.items()
            if k.startswith(("test_", "val_2_poisson_"))))

        # (d) DRUNet (on the poisson loss) and RRDBNet-noUp in f32
        spect_cnn_case(ph, "DRUNet", paths["drunet_psnr_8x_linear"], card,
                       SEED + 282)
        spect_cnn_case(ph, "RRDBNet-noUp", paths["rrdbnet_psnr_8x_linear"],
                       card, SEED + 283)
        ph.note("done" + lap())


SCALE_OUT_TOL = 1.5e-2     # the SwinIR x4 training gate (PERF.md §2)


def dp_rank_step(option_path: str, sd: dict, batch: dict,
                 t_spawn: float) -> dict:
    """One rank's SwinIR-M x4 training step under a ('data',) mesh over
    the group (run by launch.spawn): its launches, its own gradient before
    the average (rank 0's, the control), the averaged one, then the update;
    the seconds from the spawn to each stage."""
    stages = {"started": time.time() - t_spawn}
    import torch
    import torch.distributed as dist
    from kair_tpu_torch import config
    from kair_tpu_torch.cli.train import build_trainer
    from kair_tpu_torch.ops.kernels.swin_block import (swin_block_2d,
                                                        swin_block_2d_bwd)
    from kair_tpu_torch.parallel.mesh import make_mesh, shard_batch
    trainer = build_trainer(config.parse(option_path), dtype=torch.bfloat16)
    trainer.model.load_state_dict(sd)
    stages["built"] = time.time() - t_spawn
    mesh = make_mesh(data=dist.get_world_size())
    trainer.use_mesh(mesh)
    stages["replicated"] = time.time() - t_spawn
    mine = shard_batch(mesh, batch)
    swin_block_2d.launches = swin_block_2d_bwd.launches = 0
    loss = trainer.compute_grads(mine)
    torch.cuda.synchronize()
    launches = (swin_block_2d.launches, swin_block_2d_bwd.launches)
    # numpy, not tensors: a tensor result would be shared through this
    # process's memory after it exits
    grads = lambda: {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                     .detach().float().cpu().numpy()
                     for n, p in trainer.model.named_parameters()}
    rank0 = dist.get_rank() == 0
    local = grads() if rank0 else None
    t0 = time.perf_counter()
    trainer.average_grads([loss])
    torch.cuda.synchronize()
    reduce_ms = (time.perf_counter() - t0) * 1e3
    averaged = grads() if rank0 else None
    trainer.apply_update()
    torch.cuda.synchronize()
    stages["stepped"] = time.time() - t_spawn
    return {"launches": launches, "local": local, "averaged": averaged,
            "reduce_ms": reduce_ms, "backend": dist.get_backend(),
            "stages": stages,
            "device": str(next(trainer.model.parameters()).device)}


def nccl_rank_step(option_path: str, sd: dict, batch: dict) -> dict:
    """In a group of one rank over NCCL: one step's gradient, then the
    same gradient through the mesh's all-reduce, which must leave it bit
    for bit."""
    import torch
    import torch.distributed as dist
    from kair_tpu_torch import config
    from kair_tpu_torch.cli.train import build_trainer
    from kair_tpu_torch.parallel.mesh import make_mesh
    trainer = build_trainer(config.parse(option_path), dtype=torch.bfloat16)
    trainer.model.load_state_dict(sd)
    trainer.use_mesh(make_mesh())
    loss = trainer.compute_grads(batch)
    params = [p for p in trainer.model.parameters() if p.grad is not None]
    before = [p.grad.clone() for p in params]
    trainer.average_grads([loss])
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "tensors": len(params),
            "equal": all(torch.equal(a, p.grad) for a, p in zip(before, params)),
            "moved": max(float((a.float() - p.grad.float()).abs().max())
                         for a, p in zip(before, params))}


def phase_scale_out(report: list, card: str, build_dir) -> None:
    """Phase 29: device_check, the native loader through cli.train on the
    main recipe, data parallel at world 2 (gloo, both ranks on the card)
    and NCCL at world 1, tiled SwinIR-M inference, a profiler trace."""
    import contextlib
    import io
    import logging
    import numpy as np
    import torch
    from kair_tpu_torch import config
    from kair_tpu_torch.cli import device_check
    from kair_tpu_torch.cli import train as cli_train
    from kair_tpu_torch.cli.test import build_preset
    from kair_tpu_torch.data import native_loader
    from kair_tpu_torch.data.base import Loader
    from kair_tpu_torch.data.datasets import DatasetSR
    from kair_tpu_torch.ops.kernels.conv_block import conv3x3_residual
    from kair_tpu_torch.ops.kernels.swin_block import swin_block_2d
    from kair_tpu_torch.parallel import launch
    from kair_tpu_torch.parallel.mesh import make_mesh
    from kair_tpu_torch.parallel.tiled import make_sharded_tiled_fn
    from kair_tpu_torch.utils import profiling
    from kair_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()

    def lap() -> str:
        return f" [{time.perf_counter() - t_phase:.1f} s]"

    with Phase("29 scale_out") as ph, \
            tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        # (a) the environment check
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            device_check.main([])
        out = buf.getvalue()
        require(torch.cuda.get_device_name(0) in out
                and "tensor round-trip: OK" in out
                and "mesh: {'data': 1, 'model': 1, 'tile': 1}" in out
                and out.strip().endswith("OK"), f"device_check said {out!r}")
        ph.note("(a) cli.device_check: " + "; ".join(
            l.strip() for l in out.strip().splitlines()[:4]) + lap())

        # (b) the native loader through cli.train on the main recipe
        from kair_tpu_torch import config as cfg
        raw = cfg.load_json_with_comments(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), OPTION_FILE))
        raw["path"]["root"] = os.path.join(tmp, "runs")
        raw["datasets"]["train"]["dataroot_H"] = os.path.join(tmp, "trainH")
        raw["datasets"].pop("test", None)
        opt_path = os.path.join(tmp, "train_x4.json")
        with open(opt_path, "w") as f:
            json.dump(raw, f)
        ds_opt = config.parse(opt_path)["datasets"]["train"]
        write_seeded_pngs(ds_opt["dataroot_H"], 32, SEED + 290)
        logger = logging.getLogger("train")
        for h in list(logger.handlers):
            logger.removeHandler(h)
        t0 = time.perf_counter()
        trainer = cli_train.main(argv=["--opt", opt_path, "--max_steps", "2"])
        train_s = time.perf_counter() - t0
        task = config.parse(opt_path)["path"]["task"]
        with open(os.path.join(task, "train.log")) as f:
            log_text = f.read()
        native_line = [l for l in log_text.splitlines()
                       if "(native C++ loader)" in l]
        require(trainer is not None and trainer.step == 2 and native_line
                and os.path.exists(os.path.join(task, "models", "2_G.pth")),
                f"cli.train on {OPTION_FILE}: step {getattr(trainer, 'step', None)},"
                f" native-loader line {native_line}")
        del trainer
        torch.cuda.empty_cache()
        bs, hs = ds_opt["dataloader_batch_size"], ds_opt["H_size"]
        native = native_loader.NativeEpochLoader(ds_opt, bs, seed=SEED)
        it = iter(native.epoch(0))
        next(it)
        t0 = time.perf_counter()
        n_native = 0
        for e in range(1, 4):
            for _ in native.epoch(e):
                n_native += 1
        native_ms = (time.perf_counter() - t0) * 1e3 / n_native

        class PngSR(DatasetSR):          # the Python path on the card: no cv2
            def read_uint(self, path):
                return read_png(path)
        py = Loader(PngSR(ds_opt), bs, seed=SEED)
        t0 = time.perf_counter()
        next(iter(py.epoch(0)))
        python_ms = (time.perf_counter() - t0) * 1e3
        ph.note(f"(b) native loader: g++ {native_loader.build_seconds or 0:.1f}"
                f" s in phase 1; cli.train {OPTION_FILE} (batch {bs}, H_size "
                f"{hs}, 32 seeded 200x200 PNGs, use_native_loader) 2 steps in "
                f"{train_s:.1f} s, log: '{native_line[0].split(' : ')[-1]}'; "
                f"ms a batch of {bs}: native {native_ms:.2f} (mean of "
                f"{n_native}), Python Loader {python_ms:.2f} (one batch: "
                f"utils/png decode, MATLAB bicubic, crop and augment an item; "
                f"host time) [{card}]" + lap())
        threads = ds_opt.get("dataloader_num_workers") or 8
        n_div = 4
        cache = cache_build_seconds(os.path.join(tmp, "div2k_sized"), n_div,
                                    SEED + 310, threads)
        ph.note(f"(b) RAM-cache build ({threads} threads, x4 bicubic) of "
                f"{n_div} seeded 2040x1356 PNGs: " + "; ".join(
                    f"{kind} {b:.2f} s (utils/png decode alone {d:.2f} s), "
                    f"x{800 // n_div} for DIV2K's 800 images {b * 800 / n_div:.0f}"
                    f" s" for kind, (b, d) in cache.items())
                + f" (host time) [{card}]" + lap())

        # (c) data parallel at world 2 over gloo, both ranks on the card
        rng = np.random.RandomState(SEED + 291)
        batch = {"L": np.stack([smooth_image(64, 64, SEED + 292 + i)
                                for i in range(4)]).astype(np.float32) / 255,
                 "H": np.stack([smooth_image(256, 256, SEED + 296 + i)
                                for i in range(4)]).astype(np.float32) / 255}
        batch["L"] += rng.rand(*batch["L"].shape).astype(np.float32) * 0.02
        opt = config.parse(opt_path)
        one = cli_train.build_trainer(opt, dtype=torch.bfloat16)
        sd = {k: v.cpu() for k, v in seeded_train_weights(
            one.model, SEED + 3).items()}
        one.model.load_state_dict(sd)
        g_one = grads_of(one, batch)
        del one
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch.spawn(dp_rank_step, 2, backend="gloo", device="cuda",
                             init_method="file://" + os.path.join(tmp, "dp2"),
                             args=(opt_path, sd, batch, time.time()))
        dp_s = time.perf_counter() - t0
        r0 = {k: ({n: torch.from_numpy(v) for n, v in g.items()}
                  if k in ("local", "averaged") else g)
              for k, g in ranks[0].items()}
        names = list(g_one)
        err = rel_norm(r0["averaged"], g_one, names)
        ctrl = rel_norm(r0["local"], g_one, names)
        per_rank = [r["launches"] for r in ranks]
        ph.note(f"(c) SwinIR-M x4 step at B=4 of 64x64 LR on 2 ranks "
                f"({r0['backend']}, {ranks[0]['device']} and "
                f"{ranks[1]['device']}; spawn and step {dp_s:.1f} s; the "
                f"all-reduce {r0['reduce_ms']:.1f} ms): averaged gradient vs "
                f"one process on the whole batch, relative norm {err:.4g} "
                f"(limit {SCALE_OUT_TOL}); control, rank 0's own gradient "
                f"{ctrl:.4g}; launches a rank's step (row 1, row 3) "
                f"{per_rank}; rank 0's seconds from the spawn: " + ", ".join(
                    f"{k} {v:.1f}" for k, v in r0["stages"].items()) + lap())
        require(all(l == (36, 36) for l in per_rank),
                f"launches a rank's step {per_rank}, expected 36 + 36")
        require(err <= SCALE_OUT_TOL, f"data-parallel gradient {err:.4g} > "
                f"{SCALE_OUT_TOL}")
        require(ctrl > SCALE_OUT_TOL and ctrl > 3 * err,
                f"the control ({ctrl:.4g}) is not above the limit and 3x "
                f"the error")
        for k in report:
            if k["name"] in ("swin_block_2d", "swin_block_2d_bwd"):
                k["dp_launches_per_rank_step"] = per_rank[0][
                    k["name"] == "swin_block_2d_bwd"]
        del ranks, r0

        # (d) NCCL at world 1, in this process (a spawn costs ~20 s)
        small = {k: v[:2] for k, v in batch.items()}
        torch.distributed.init_process_group(
            "nccl", init_method="file://" + os.path.join(tmp, "nccl1"),
            world_size=1, rank=0)
        try:
            nc = nccl_rank_step(opt_path, sd, small)
        finally:
            torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()
        ph.note(f"(d) {nc['backend']} at world {nc['world']}: {nc['tensors']} "
                f"gradient tensors through the all-reduce, bit-equal "
                f"{nc['equal']} (max move {nc['moved']:.3g})" + lap())
        require(nc["backend"] == "nccl" and nc["world"] == 1 and nc["equal"],
                f"NCCL at world 1: {nc}")

        # (e) tiled SwinIR-M x4 inference at world 1, (f) its trace
        pth = os.path.join(tmp, "swinir_m_x4.pth")
        torch.save({"params": main_path_state_dict(SEED)}, pth)
        model, _, _ = build_preset("swinir_classical_x4", pth, device="cuda",
                                   dtype=torch.bfloat16)
        x = torch.from_numpy(smooth_image(128, 128, SEED + 300)[None]
                             .astype(np.float32) / 255).to("cuda",
                                                            torch.bfloat16)
        tiled = make_sharded_tiled_fn(model, make_mesh(), halo=16, sf=4)
        with torch.inference_mode():
            whole = model(x)
            swin_block_2d.launches = conv3x3_residual.launches = 0
            y = tiled(x)
            torch.cuda.synchronize()
            n_tiled = (swin_block_2d.launches, conv3x3_residual.launches)
        require(n_tiled == (36, 7) and torch.equal(y, whole)
                and y.shape == (1, 512, 512, 3),
                f"tiled forward: launches {n_tiled}, equal "
                f"{torch.equal(y, whole)}, shape {tuple(y.shape)}")
        ph.note(f"(e) make_sharded_tiled_fn at world 1 on a 1x128x128 LR "
                f"image: equal to the monolithic forward, launches (row 1, "
                f"row 2) {n_tiled}" + lap())
        for k in report:
            if k["name"] in ("swin_block_2d", "conv3x3_residual"):
                k["tiled_launches_per_forward"] = n_tiled[
                    k["name"] == "conv3x3_residual"]
        prof_dir = os.path.join(tmp, "trace")
        with torch.inference_mode(), profiling.trace(prof_dir):
            model(x)
        rows = profiling.summarize_trace(prof_dir, top=5)
        ph.note("(f) utils/profiling.trace of one forward, top rows: " + ", ".join(
            f"{n[:40]} {us:.0f} us x{c}" for n, us, c in rows) + lap())
        require(rows and any("swin_block_wg" in n for n, _, _ in rows),
                f"the trace's top rows {rows} name no row-1 kernel")


# ---------------------------------------------------------------------------
# f32 on the card (phase 30)
# ---------------------------------------------------------------------------

# limits of phase 30: the f32 kernels against their f32 plain versions on
# the card (sums in another order; no bf16 anywhere), per tensor for the
# backward; the training step's gradient against the f32 plain route
F32_FWD_TOL, F32_BWD_TOL, F32_STEP_TOL = 1e-4, 5e-4, 1e-3
# KAIR 006_CAR's training geometry: 126x126 HR patches (window 7); the
# training fields of OPTION_FILE, batch cut from 32 to 2 to fit the phase
JPEG_CAR_TRAIN_BATCH = 2


class plain_inference:
    """While open, SwinIR's inference blocks and tails run the kernels'
    plain versions on whatever device (the f32 plain route on the card)."""

    def __enter__(self):
        from kair_tpu_torch.models import swinir as msw
        from kair_tpu_torch.ops import blocks
        from kair_tpu_torch.ops.kernels import conv_block, window_msa
        from kair_tpu_torch.ops.kernels import swin_block as sb
        self.saved = [(msw, "swin_block_2d", msw.swin_block_2d),
                      (msw, "window_msa_win", msw.window_msa_win),
                      (blocks, "conv3x3_residual", blocks.conv3x3_residual)]
        msw.swin_block_2d = lambda x, p, nh, mask=None, phase=0, ws=8, \
            packed=None: sb.swin_block_win_reference(x, p, nh, mask, phase, ws)
        msw.window_msa_win = lambda *a, packed=None: \
            window_msa.window_msa_win_reference(*a)
        blocks.conv3x3_residual = lambda y, res, w, b, phase=0, \
            packed_weight=None: conv_block.conv3x3_residual_reference(
                y, res, w, b, phase)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def f32_check(ph, what: str, got, ref, tol: float, control=None) -> float:
    """max|got − ref| ≤ tol · max|ref|; the control (the bf16 kernel on the
    same inputs) must be over the limit. Returns the max abs error."""
    e_abs, e_rel, ref_max, _ = compare(got, ref)
    note = f"{what}: max_rel {e_rel:.4g} (max|ref| {ref_max:.4g})"
    require(e_rel <= tol, f"{what}: max_rel {e_rel:.4g} > {tol}")
    if control is not None:
        c_rel = compare(control, ref)[1]
        note += f"; bf16 control {c_rel:.4g}"
        require(c_rel > tol, f"{what}: the bf16 control {c_rel:.4g} is not "
                "over the limit")
    ph.note(note)
    return e_abs


def grad_rel(a, b) -> dict:
    """Per tensor ‖a − b‖ / ‖b‖ of two backward results (dx, grads)."""
    import torch
    out = {"dx": ((a[0].float() - b[0].float()).norm()
                  / b[0].float().norm()).item()}
    for name, g, r in zip(b[1]._fields, a[1], b[1]):
        if r is not None:
            out[name] = ((g.float() - r.float()).norm()
                         / max(r.float().norm().item(), 1e-30)).item()
    return out


def phase_f32(report: list, card: str, build_dir) -> None:
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F
    from kair_tpu_torch.cli.test import build_preset
    from kair_tpu_torch.models.registry import define_g
    from kair_tpu_torch.ops.kernels import conv_block as cb
    from kair_tpu_torch.ops.kernels import swin_block as sb
    from kair_tpu_torch.ops.kernels import window_msa as wm
    from kair_tpu_torch.train.select import define_trainer
    from kair_tpu_torch.utils.summary import (PEAKS, swinir_block_bwd_flops_per_token,
                                              swinir_block_flops_per_token,
                                              swinir_flops_per_lr_pixel,
                                              window_msa_flops_per_token)

    dev, f32 = torch.device("cuda"), torch.float32
    gen = torch.Generator().manual_seed(SEED + 300)
    t_phase = time.perf_counter()

    def lap() -> str:
        return f" [{time.perf_counter() - t_phase:.1f} s]"

    def f32_bound(flops, nbytes):
        return bound_ms(flops, nbytes, rate="fp32")

    entries = {}
    with Phase("30 f32") as ph:
        ph.note(f"TF32 off (phase 0); limits {F32_FWD_TOL} x max|ref| "
                f"(forward kernels), {F32_BWD_TOL} per tensor (backward), "
                f"{F32_STEP_TOL} over all (a training step's gradient), each "
                "against the f32 plain version or route on the card; controls "
                "the bf16 kernels on the same inputs [" + card + "]")
        # (a) row 1 in f32, B=16 128x128 C=180, and C=240
        b, h, c, nh, hid = 16, 128, 180, 6, 360
        p = swin_params(c, nh, hid, gen, dev, f32)
        x = torch.randn(b, h, h, c, generator=gen).to(dev)
        pk, pk16 = sb.pack_swin_block_f32(p, nh), sb.pack_swin_block(p, nh)
        mask = wm.shift_mask_tensor(h, h, 8, 4, dev)
        errs = []
        for phase, m in ((0, None), (4, mask)):
            got = sb.swin_block_2d(x, p, nh, m, phase, packed=pk)
            ref = sb.swin_block_win_reference(x, p, nh, m, phase)
            ctl = sb.swin_block_2d(x.to(torch.bfloat16), p, nh, m, phase,
                                   packed=pk16)
            errs.append(f32_check(ph, f"(a) row 1 B={b} {h}x{h} C={c} phase "
                                  f"{phase}", got, ref, F32_FWD_TOL, ctl))
        del got, ref, ctl
        ms = cuda_ms(lambda: sb.swin_block_2d(x, p, nh, mask, 4, packed=pk))
        plain_ms = cuda_ms(lambda: sb.swin_block_win_reference(
            x, p, nh, mask, 4), warmup=1, reps=5)
        tokens = b * h * h
        flops = tokens * swinir_block_flops_per_token(c, nh, 8, hid / c)
        n_par = sum(t.numel() for t in p)
        bms, by = f32_bound(flops, 2 * 4 * tokens * c + 4 * n_par
                            + 4 * mask.numel())
        ph.note(f"(a) row 1 f32 {ms:.3f} ms (shifted, median of 10), "
                f"{flops / ms / 1e9:.2f} TFLOP/s; plain f32 {plain_ms:.3f} ms; "
                f"bound {bms:.4f} ms ({by}, {flops / 1e9:.1f} GFLOP at 67 "
                "TFLOP/s f32)" + lap())
        entries["swin_block_2d_f32"] = dict(
            source="kair_tpu_torch/csrc/swin_block_f32.cu",
            replaces="kair_tpu/ops/pallas/swin_block.py:701", max_abs_err=max(errs),
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
        # (b) row 5, the attention-only mode, at the same inputs
        y = F.layer_norm(x, (c,), p.norm1_weight, p.norm1_bias)
        msa_args = (p.qkv_weight, p.qkv_bias, p.proj_weight, p.proj_bias,
                    p.rel_table, nh, mask, 4)
        pkm = sb.pack_attn_f32(*msa_args[:6])
        got = wm.window_msa_win(y, *msa_args, packed=pkm)
        ref = wm.window_msa_win_reference(y, *msa_args)
        ctl = wm.window_msa_win(y.to(torch.bfloat16), *msa_args)
        e5 = f32_check(ph, f"(b) row 5 B={b} {h}x{h} C={c} phase 4", got, ref,
                       F32_FWD_TOL, ctl)
        del got, ref, ctl, x
        ms5 = cuda_ms(lambda: wm.window_msa_win(y, *msa_args, packed=pkm))
        plain5 = cuda_ms(lambda: wm.window_msa_win_reference(y, *msa_args),
                         warmup=1, reps=5)
        fl5 = tokens * window_msa_flops_per_token(c, 8)
        b5, by5 = f32_bound(fl5, 2 * 4 * tokens * c + 4 * (4 * c * c + 4 * c)
                            + 4 * mask.numel())
        ph.note(f"(b) row 5 f32 {ms5:.3f} ms, plain {plain5:.3f} ms, bound "
                f"{b5:.4f} ms ({by5})" + lap())
        entries["window_msa_win_f32"] = dict(
            source="kair_tpu_torch/csrc/swin_block_f32.cu",
            replaces="kair_tpu/ops/pallas/window_msa.py:271", max_abs_err=e5,
            ms=ms5, plain_ms=plain5, bound_ms=b5, bound_by=by5, library_ms=None)
        del y
        # C=240 (SwinIR-L), B=4
        pl_ = swin_params(240, 8, 480, gen, dev, f32)
        xl = torch.randn(4, h, h, 240, generator=gen).to(dev)
        got = sb.swin_block_2d(xl, pl_, 8, mask, 4)
        ref = sb.swin_block_win_reference(xl, pl_, 8, mask, 4)
        ctl = sb.swin_block_2d(xl.to(torch.bfloat16), pl_, 8, mask, 4)
        errs.append(f32_check(ph, f"(a) row 1 B=4 {h}x{h} C=240 phase 4", got,
                              ref, F32_FWD_TOL, ctl))
        pkl = sb.pack_swin_block_f32(pl_, 8)
        ph.note(f"(a) C=240 {cuda_ms(lambda: sb.swin_block_2d(xl, pl_, 8, mask, 4, packed=pkl)):.3f} ms"
                + lap())
        del got, ref, ctl, xl
        # (b) row 4 at ws 7, B=8 126x126 (JPEG-CAR's geometry)
        b4, s4 = 8, 126
        p7 = swin_params(c, nh, hid, gen, dev, f32, ws=7)
        x7 = torch.randn(b4, s4, s4, c, generator=gen).to(dev)
        m7 = wm.shift_mask_tensor(s4, s4, 7, 3, dev)
        pk7 = sb.pack_swin_block_f32(p7, nh)
        e4 = 0.0
        for phase, m in ((0, None), (3, m7)):
            got = sb.swin_block_2d(x7, p7, nh, m, phase, 7, packed=pk7)
            ref = sb.swin_block_win_reference(x7, p7, nh, m, phase, 7)
            ctl = sb.swin_block_2d(x7.to(torch.bfloat16), p7, nh, m, phase, 7)
            e4 = max(e4, f32_check(ph, f"(b) row 4 ws 7 B={b4} {s4}x{s4} "
                                   f"phase {phase}", got, ref, F32_FWD_TOL, ctl))
        del got, ref, ctl
        ms4 = cuda_ms(lambda: sb.swin_block_2d(x7, p7, nh, m7, 3, 7, packed=pk7))
        plain4 = cuda_ms(lambda: sb.swin_block_win_reference(x7, p7, nh, m7, 3, 7),
                         warmup=1, reps=5)
        fl4 = b4 * s4 * s4 * swinir_block_flops_per_token(c, nh, 7, hid / c)
        b4ms, by4 = f32_bound(fl4, 2 * 4 * b4 * s4 * s4 * c + 4 * n_par
                              + 4 * m7.numel())
        ph.note(f"(b) row 4 f32 {ms4:.3f} ms (shifted), plain {plain4:.3f} ms, "
                f"bound {b4ms:.4f} ms ({by4}, on the real tokens)" + lap())
        entries["swin_block_win_f32"] = dict(
            source="kair_tpu_torch/csrc/swin_block_f32.cu",
            replaces="kair_tpu/ops/pallas/swin_block.py:843", max_abs_err=e4,
            ms=ms4, plain_ms=plain4, bound_ms=b4ms, bound_by=by4, library_ms=None)
        del x7
        # (c) row 2 in f32, B=16 128x128 C=180, against F.conv2d f32 + add
        yc = torch.randn(b, h, h, c, generator=gen).to(dev)
        rc = torch.randn(b, h, h, c, generator=gen).to(dev)
        wc = (torch.randn(c, c, 3, 3, generator=gen) * 0.05).to(dev)
        bc = torch.randn(c, generator=gen).to(dev)
        wpk = cb.pack_conv3x3_f32(wc)
        got = cb.conv3x3_residual(yc, rc, wc, bc, 4, wpk)
        ref = cb.conv3x3_residual_reference(yc, rc, wc, bc, 4)
        ctl = cb.conv3x3_residual(yc.to(torch.bfloat16), rc.to(torch.bfloat16),
                                  wc, bc, 4)
        e2 = f32_check(ph, f"(c) row 2 B={b} {h}x{h} C={c} phase 4", got, ref,
                       F32_FWD_TOL, ctl)
        del got, ref, ctl
        ms2 = cuda_ms(lambda: cb.conv3x3_residual(yc, rc, wc, bc, 4, wpk))
        plain2 = cuda_ms(lambda: cb.conv3x3_residual_reference(yc, rc, wc, bc, 4),
                         warmup=1, reps=5)
        yn = yc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        rn = rc.permute(0, 3, 1, 2)
        lib2 = cuda_ms(lambda: F.conv2d(yn, wc, bc, padding=1).add_(rn))
        fl2 = 2.0 * b * h * h * c * 9 * c
        b2ms, by2 = f32_bound(fl2, 3 * 4 * b * h * h * c + 4 * (9 * c * c + c))
        ph.note(f"(c) row 2 f32 {ms2:.3f} ms, {fl2 / ms2 / 1e9:.2f} TFLOP/s; "
                f"plain {plain2:.3f} ms; F.conv2d f32 (TF32 off, channels-last) "
                f"+ add {lib2:.3f} ms; bound {b2ms:.4f} ms ({by2})" + lap())
        entries["conv3x3_residual_f32"] = dict(
            source="kair_tpu_torch/csrc/conv_block_f32.cu",
            replaces="kair_tpu/ops/pallas/conv_block.py:94", max_abs_err=e2,
            ms=ms2, plain_ms=plain2, bound_ms=b2ms, bound_by=by2,
            library_ms=lib2)
        del yc, rc, yn, rn
        # (d) row 3 in f32: B=32 48x48 at C=180 and C=240
        e3 = 0.0
        for cc, nn, hh in ((180, 6, 360), (240, 8, 480)):
            pb = swin_params(cc, nn, hh, gen, dev, f32)
            xb = torch.randn(32, 48, 48, cc, generator=gen).to(dev)
            dyb = torch.randn(32, 48, 48, cc, generator=gen).to(dev)
            mb = wm.shift_mask_tensor(48, 48, 8, 4, dev)
            pkb = sb.pack_swin_block_f32(pb, nn)
            got = sb.swin_block_2d_bwd(xb, dyb, pb, nn, mb, pkb, 4)
            ref = sb.swin_block_2d_bwd_reference(xb, dyb, pb, nn, mb, 4)
            ctl = sb.swin_block_2d_bwd(xb.to(torch.bfloat16),
                                       dyb.to(torch.bfloat16), pb, nn, mb,
                                       sb.pack_swin_block(pb, nn, folded=False), 4)
            rel, rel_ctl = grad_rel(got, ref), grad_rel(ctl, ref)
            worst = max(rel, key=rel.get)
            ph.note(f"(d) row 3 B=32 48x48 C={cc} phase 4: worst tensor {worst} "
                    f"{rel[worst]:.4g} (limit {F32_BWD_TOL}), dx {rel['dx']:.4g}; "
                    f"bf16 control worst {max(rel_ctl.values()):.4g}" + lap())
            require(rel[worst] <= F32_BWD_TOL, f"row 3 C={cc}: {worst} "
                    f"{rel[worst]:.4g} > {F32_BWD_TOL}")
            require(max(rel_ctl.values()) > F32_BWD_TOL,
                    f"row 3 C={cc}: the bf16 control is not over the limit")
            e3 = max(e3, (got[0] - ref[0]).abs().max().item())
            if cc == 180:
                ms3 = cuda_ms(lambda: sb.swin_block_2d_bwd(xb, dyb, pb, nn, mb,
                                                           pkb, 4))
                plain3 = cuda_ms(lambda: sb.swin_block_2d_bwd_reference(
                    xb, dyb, pb, nn, mb, 4), warmup=1, reps=5)
                tok3 = 32 * 48 * 48
                fl3 = tok3 * swinir_block_bwd_flops_per_token(cc, 8, hh / cc)
                n3 = sum(t.numel() for t in pb)
                b3ms, by3 = f32_bound(fl3, 3 * 4 * tok3 * cc + 2 * 4 * n3
                                      + 4 * mb.numel())
                ph.note(f"(d) row 3 f32 {ms3:.3f} ms, {fl3 / ms3 / 1e9:.2f} "
                        f"TFLOP/s; plain {plain3:.3f} ms; bound {b3ms:.4f} ms "
                        f"({by3}, {fl3 / 1e9:.1f} GFLOP)")
            del got, ref, ctl, xb, dyb
        entries["swin_block_2d_bwd_f32"] = dict(
            source="kair_tpu_torch/csrc/swin_block_bwd_f32.cu",
            replaces="kair_tpu/ops/pallas/swin_block.py:588", max_abs_err=e3,
            ms=ms3, plain_ms=plain3, bound_ms=b3ms, bound_by=by3,
            library_ms=None)
        torch.cuda.empty_cache()

        # (e) SwinIR-M x4 in f32 through cli/test's build_preset
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            path = f"{tmp}/swinir_m_x4_seed{SEED}.pth"
            torch.save({"params": main_path_state_dict(SEED)}, path)
            model, _, _ = build_preset("swinir_classical_x4", path, "cuda", f32)
            unfused, _, _ = build_preset("swinir_classical_x4", path, "cuda",
                                         f32, fuse=False)
        xin = torch.rand(b, h, h, 3, generator=gen).to(dev)
        with LaunchCount() as lc, torch.inference_mode():
            out = model(xin)
            torch.cuda.synchronize()
        counts = lc.expect("f32 SwinIR-M forward", swin_block_2d_f32=36,
                           conv3x3_residual_f32=7)
        n_fwd = dict(lc.counts)
        with torch.inference_mode(), plain_inference():
            want = model(xin)
        e_rel = compare(out, want)[1]
        ph.note(f"(e) SwinIR-M x4 f32 (cli/test build_preset, dtype f32) "
                f"B={b} {h}x{h}: launches {counts}; "
                f"against the f32 plain route on the card max_rel "
                f"{e_rel:.4g} (limit {F32_FWD_TOL})" + lap())
        require(out.shape == (b, 4 * h, 4 * h, 3)
                and torch.isfinite(out).all().item(), f"output {out.shape}")
        require(e_rel <= F32_FWD_TOL, f"SwinIR-M f32 max_rel {e_rel:.4g}")
        del out, want
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: model(xin), warmup=1, reps=3)
        tfl = swinir_flops_per_lr_pixel() * b * h * h / (fwd_ms / 1e3) / 1e12
        ph.note(f"(e) ms_per_forward {fwd_ms:.2f} (median of 3), "
                f"{b * h * h / (fwd_ms / 1e3) / 1e6:.4f} LR MP/s, "
                f"{tfl:.2f} TFLOP/s, f32 MFU {tfl / PEAKS['H100 SXM']['fp32_tflops']:.4f}"
                " of 67 TFLOP/s" + lap())
        for k in ("swin_block_2d_f32", "conv3x3_residual_f32"):
            entries[k]["launches"] = n_fwd[k]
        # the unfused route (row 5) and JPEG-CAR (row 4) in f32, B=2
        jcar = define_g({"netG": dict(JPEG_CAR_NET)})
        jcar.load_state_dict(visible_state_dict(jcar, SEED + 301,
                                                img_range=255.0))
        jcar = jcar.to(dev).eval()
        with LaunchCount() as lc, torch.inference_mode():
            o5 = unfused(xin[:2])
            o4 = jcar(torch.rand(2, 126, 126, 3, generator=gen).to(dev))
            torch.cuda.synchronize()
        c2 = lc.expect("unfused and JPEG-CAR f32 forwards",
                       window_msa_win_f32=36, swin_block_win_f32=36,
                       conv3x3_residual_f32=7)
        require(torch.isfinite(o5).all().item()
                and torch.isfinite(o4).all().item(),
                "unfused and JPEG-CAR f32 forwards: non-finite output")
        for k in ("window_msa_win_f32", "swin_block_win_f32"):
            entries[k]["launches"] = lc.counts[k]
        ph.note(f"(e) the unfused route and JPEG-CAR (ws 7) in f32 at B=2: "
                f"launches {c2}" + lap())
        del model, unfused, jcar, o4, o5, xin
        torch.cuda.empty_cache()

        # (f) one SwinIR-M x4 f32 training step at the recipe's batch
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            opt = train_options(tmp)
            ds_opt = opt["datasets"]["train"]
            bs = ds_opt["dataloader_batch_size"]
            trainer = define_trainer(opt, dtype=f32)
            require(trainer.dtype == f32, f"trainer dtype {trainer.dtype}")
            sd = seeded_train_weights(trainer.model, SEED + 302)
            trainer.model.load_state_dict(sd)
            rng = np.random.RandomState(SEED + 303)
            hs = ds_opt["H_size"]
            batches = [{"L": rng.rand(bs, hs // 4, hs // 4, 3).astype(np.float32),
                        "H": rng.rand(bs, hs, hs, 3).astype(np.float32)}
                       for _ in range(3)]
            with LaunchCount() as lc:
                g_card, _ = loss_grads(trainer, batches[0])
                torch.cuda.synchronize()
            c3 = lc.expect("f32 training step", swin_block_2d_f32=36,
                           swin_block_2d_bwd_f32=36)
            n_step = dict(lc.counts)
            with composed_swin_blocks():
                g_ref, _ = loss_grads(trainer, batches[0])
            bf = copy.copy(trainer)
            bf.dtype = torch.bfloat16
            g_bf, _ = loss_grads(bf, batches[0])
            names = list(g_ref)
            err, err_bf = rel_norm(g_card, g_ref, names), rel_norm(g_bf, g_ref, names)
            ph.note(f"(f) {OPTION_FILE} at its batch {bs} of {hs // 4}x{hs // 4} "
                    f"LR in f32 (define_trainer dtype f32): launches {c3} a "
                    f"step; gradient against the f32 plain route on the card "
                    f"{err:.4g} over all (limit {F32_STEP_TOL}), the bf16 "
                    f"step's {err_bf:.4g}" + lap())
            require(err <= F32_STEP_TOL, f"f32 step gradient {err:.4g}")
            require(err_bf > F32_STEP_TOL, f"the bf16 control {err_bf:.4g}")
            entries["swin_block_2d_bwd_f32"]["launches"] = \
                n_step["swin_block_2d_bwd_f32"]
            del g_card, g_ref, g_bf, bf
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms_step, losses = timed_steps(trainer, batches)
            mem = torch.cuda.max_memory_allocated()
            prof = device_breakdown(lambda: trainer.train_step(batches[1]), 1,
                                    ms_step, "step", sums=("swin_",))
            ph.note(f"(f) ms_per_step {ms_step:.2f} (mean of 2 after 1, CUDA "
                    f"events), losses {losses[0]:.4g} .. {losses[-1]:.4g}, peak "
                    f"memory {mem / 2 ** 30:.2f} GiB; {prof}" + lap())
            # the f32 trainer evaluates its f32 model on the f32 kernels
            with LaunchCount() as lc:
                e = trainer.eval_step({"L": batches[0]["L"][:2]})
                torch.cuda.synchronize()
            ce = lc.expect("the f32 trainer's eval_step", swin_block_2d_f32=36,
                           conv3x3_residual_f32=7)
            require(e.shape == (2, hs, hs, 3) and torch.isfinite(e).all().item(),
                    f"f32 eval_step output {tuple(e.shape)}")
            ph.note(f"(f) eval_step of the f32 trainer, 2 LR patches: {ce}"
                    + lap())
            del trainer, batches, e
            torch.cuda.empty_cache()

            # (g) one JPEG-CAR SwinIR-M training step at window 7 (composed)
            opt["netG"] = dict(JPEG_CAR_NET)
            opt["scale"] = 1
            trainer = define_trainer(opt, dtype=f32)
            h7 = rng.rand(JPEG_CAR_TRAIN_BATCH, 126, 126, 3).astype(np.float32)
            batch = {"L": np.clip(h7 + rng.normal(0, 0.05, h7.shape), 0, 1)
                     .astype(np.float32), "H": h7}
            with LaunchCount() as lc:
                loss = float(trainer.train_step(batch)["G_loss"])
                torch.cuda.synchronize()
            c4 = lc.expect("JPEG-CAR training step", composed=36)
            ph.note(f"(g) JPEG-CAR SwinIR-M (window 7, 126x126, the x4 "
                    f"recipe's training fields, batch cut from {bs} to "
                    f"{JPEG_CAR_TRAIN_BATCH}) f32 step: loss {loss:.4g}, "
                    f"counts {c4}" + lap())
            require(math.isfinite(loss), f"JPEG-CAR training step: loss {loss}")
            del trainer
            torch.cuda.empty_cache()
    for name, e in entries.items():
        report.append(dict(name=name, route="cuda", **e))


def phase_build() -> None:
    """Phase 1: build the kernels, check the layout mirrors, print ptxas."""
    import threading
    from kair_tpu_torch.data import native_loader
    from kair_tpu_torch.ops.kernels import _build
    with Phase("1 build") as ph:
        # the native loader's g++ beside the kernels' nvcc processes
        loader_error: list = []

        def build_loader():
            try:
                native_loader.build()
            except Exception as e:          # reported below, with the phase
                loader_error.append(e)
        loader = threading.Thread(target=build_loader)
        loader.start()
        lib = _build.library()
        loader.join()
        if loader_error:
            raise loader_error[0]
        ph.note(f"native loader {native_loader.library_path().name}: g++ "
                + (f"{native_loader.build_seconds:.1f} s"
                   if native_loader.build_seconds else "already built"))
        secs = _build.build_seconds
        ph.note(f"{_build.library_path().name}: {len(_build.sources())} "
                "sources, one nvcc process each, all at once, then one link: "
                + (", ".join(f"{k} {v:.1f} s" for k, v in sorted(
                    secs.items(), key=lambda kv: -kv[1]))
                   if secs else "already built"))
        # ptxas -v: one "Used N registers" and one spill line per kernel
        log_lines = _build.build_log().splitlines()
        regs = [int(l.split("Used ")[1].split()[0]) for l in log_lines
                if "Used " in l and "registers" in l]
        spills = sum(int(l.split("bytes spill stores")[0].split(",")[-1])
                     for l in log_lines if "bytes spill stores" in l)
        ph.note(f"ptxas: {len(regs)} kernels, registers {min(regs, default=0)}"
                f"-{max(regs, default=0)} per thread, {spills} bytes of spill "
                "stores in all")
        ph.note(f"shared memory per block: conv {lib.kair_conv3x3_shared_bytes(180)} B")
        from kair_tpu_torch.ops.kernels import conv_block
        for c in (6, 60, 180, 240, 370):
            plan = (ctypes.c_int * 4)()
            lib.kair_conv3x3_plan(c, plan)
            mirror = (*conv_block.conv_plan(c), conv_block.stage_bytes(c))
            require(tuple(plan) == mirror and lib.kair_conv3x3_shared_bytes(c)
                    == conv_block.shared_bytes(c),
                    f"conv plan mirror differs from the kernel at C={c}")
        ph.note("conv plan (NT, N chunks, K chunks, stage bytes) at C=180: "
                f"{conv_block.conv_plan(180)} {conv_block.stage_bytes(180)} B; "
                "the Python mirror equals the kernel's at C=6, 60, 180, 240, 370")
        # the wrappers' checks mirror the kernels' layout arithmetic
        from kair_tpu_torch.ops.kernels.swin_block import (block_plan,
                                                            bwd_plan)
        from kair_tpu_torch.ops.kernels.window_msa import shared_bytes
        for c, nh, hp in ((24, 4, 48), (60, 6, 128), (144, 6, 288),
                          (180, 6, 368), (240, 8, 480)):
            # kernel B, the block's attention-only mode, is its plan at HP 0
            plans = []
            for h_ in (hp, 0):
                plan = (ctypes.c_int * 5)()
                lib.kair_swin_block_plan(c, nh, h_, plan)
                bp = block_plan(c, nh, h_)
                require(tuple(plan) == (bp.nt, bp.kc, bp.ring, bp.stages,
                                        bp.slot)
                        and lib.kair_swin_block_shared_bytes(c, nh, h_)
                        == bp.smem,
                        f"block plan mirror differs at C={c} HP={h_}")
                plans.append(bp)
            bp, att = plans
            bwd = (ctypes.c_int * 10)()
            lib.kair_swin_bwd_plan(c, nh, hp, bwd)
            bw = bwd_plan(c, nh, hp)
            require(att.smem == shared_bytes(c, nh)
                    and tuple(bwd) == (bw.smem, bw.nt, bw.stages, bw.slot,
                                       bw.scratch, sum(bw.op_rows), bw.nb,
                                       bw.items, bw.total, bw.wgrad_smem),
                    f"shared-memory mirror differs from the kernels at C={c}")
            ph.note(f"C={c}, {nh} heads: block {bp.smem} B (NT {bp.nt}, ring "
                    f"{bp.ring} x {bp.slot} B, {bp.stages} stages a window "
                    f"pair), attention only {att.smem} B ({att.stages} stages "
                    f"a window pair), backward {bw.smem} B ({bw.stages} "
                    f"stages a window pair) + {bw.wgrad_smem} B (weight grads, "
                    f"{bw.items} items of 128 x {bw.nb})")
        # the f32 kernels' layouts (csrc/swin_block_f32.cu,
        # swin_block_bwd_f32.cu, conv_block_f32.cu)
        from kair_tpu_torch.ops.kernels.swin_block import (bwd_f32_plan,
                                                            f32_plan)
        for c, nh, hid, ws in ((24, 4, 48, 8), (180, 6, 360, 8),
                               (180, 6, 360, 7), (240, 8, 480, 8),
                               (60, 6, 120, 4)):
            plan = (ctypes.c_int * 4)()
            lib.kair_swin_f32_plan(c, nh, 32, ws, plan)
            require(tuple(plan) == tuple(f32_plan(c, nh, ws)),
                    f"f32 block plan mirror differs at C={c} ws {ws}: "
                    f"{tuple(plan)} vs {tuple(f32_plan(c, nh, ws))}")
            lib.kair_swin_bwd_f32_plan(c, nh, 32, hid, plan)
            require(tuple(plan) == tuple(bwd_f32_plan(c, nh, hid))[:4],
                    f"f32 backward plan mirror differs at C={c}: "
                    f"{tuple(plan)} vs {tuple(bwd_f32_plan(c, nh, hid))[:4]}")
            require(lib.kair_conv3x3_f32_shared_bytes(c)
                    == conv_block.f32_shared_bytes(c),
                    f"f32 conv shared-memory mirror differs at C={c}")
        ph.note(f"the f32 plans equal the kernels' at 5 geometries; SwinIR-M "
                f"{f32_plan(180, 6, 8).smem} B forward, "
                f"{bwd_f32_plan(180, 6, 360).smem} B backward pass 1, "
                f"SwinIR-L {f32_plan(240, 8, 8).smem} / "
                f"{bwd_f32_plan(240, 8, 480).smem} B; f32 kernels (ptxas): "
                + ", ".join(f"{n} {r} regs {sp} B spill" for n, r, sp in
                            ptxas_kernels(log_lines) if "f32" in n
                            or "sum_parts" in n))
        from kair_tpu_torch.ops.kernels.win3d import kind, win3d_plan
        names = {0: "self", 1: "TMSA", 2: "STL2"}
        for mutual, plain, c, nh, wd, twd in (
                (True, False, 96, 6, 2, 2), (True, False, 120, 6, 2, 2),
                (True, False, 24, 2, 2, 2), (False, False, 96, 6, 6, 6),
                (False, False, 120, 6, 8, 8), (False, False, 180, 6, 6, 6),
                (False, False, 180, 6, 1, 1), (False, False, 180, 6, 4, 8),
                (False, False, 192, 6, 6, 6), (True, False, 180, 6, 2, 2),
                (False, True, 144, 6, 2, 2), (False, True, 192, 6, 2, 2),
                (False, True, 24, 2, 2, 2), (False, True, 200, 8, 2, 2)):
            plan = (ctypes.c_int * 17)()
            lib.kair_win3d_plan(kind(mutual, plain), c, nh, 2 * c, wd, twd,
                                plan)
            pl = win3d_plan(mutual, c, nh, 2 * c, wd, twd, plain)
            require(tuple(plan) == tuple(int(v) for v in pl),
                    f"window block plan mirror differs at C={c} wd {wd}: "
                    f"{tuple(plan)} vs {tuple(pl)}")
            if pl.fits and c >= 96:
                ph.note(f"{names[kind(mutual, plain)]} block C={c} wd {wd}: "
                        f"NT {pl.nt}, q/k {pl.hdp}, v {pl.vdp}, "
                        f"{pl.stages1} + {pl.stages3} stages an item, shared "
                        f"memory {pl.smem1} / {pl.smem2} / {pl.smem3} B")
        ph.note("the window blocks' plan mirror equals kair_win3d_plan at 14 "
                "geometries (a self block at C=192, a C=180 TMSA block and an "
                "STL2 block at C=200 refused by both)")
        ptx = ptxas_kernels(log_lines)
        ph.note("window-block kernels (ptxas): " + ", ".join(
            f"{n} {r} regs {sp} B spill" for n, r, sp in ptx
            if n.startswith(WIN3D_PASSES)))
        from kair_tpu_torch.ops.kernels.dcn_block import dcn_plan
        for cin, cout, dg in ((120, 120, 12), (240, 120, 16), (360, 120, 24),
                              (96, 96, 16), (24, 72, 3), (300, 200, 1),
                              (40, 250, 2)):
            plan = (ctypes.c_int * 8)()
            lib.kair_dcn_plan(cin, cout, dg, plan)
            require(tuple(plan) == tuple(dcn_plan(cin, cout, dg)),
                    f"DCN plan mirror differs at Cin {cin} Cout {cout} dg "
                    f"{dg}: {tuple(plan)} vs {tuple(dcn_plan(cin, cout, dg))}")
        pl = dcn_plan(120, 120, 12)
        ph.note(f"the DCN plan mirror equals kair_dcn_plan at 7 geometries; "
                f"VRT-001's: {pl.kmax} columns a chunk, {pl.cpg} chunk a "
                f"group, ring slot {pl.stage_bytes} B, {pl.smem} B of shared "
                "memory a block; DCN kernels (ptxas): " + ", ".join(
                    f"{n} {r} regs {sp} B spill" for n, r, sp in ptx
                    if "dcn_" in n))
        from kair_tpu_torch.ops.kernels.gda_block import gda_plan
        for c, dg, k, clip, h, w, align in (
                (288, 12, 9, 2, 64, 64, 16), (384, 12, 9, 2, 64, 64, 16),
                (288, 12, 9, 2, 128, 128, 16), (48, 2, 9, 2, 13, 11, 16),
                (30, 3, 9, 2, 7, 17, 16), (20, 4, 9, 1, 9, 10, 16),
                (288, 12, 9, 2, 64, 64, 2), (32, 2, 3, 1, 5, 3, 8)):
            plan = (ctypes.c_int * 7)()
            want = tuple(gda_plan(c, dg, h, w, align))
            require(lib.kair_gda_plan(c, dg, k, clip, h, w, align, plan) == 0
                    and tuple(plan) == want,
                    f"GDA plan mirror differs at C={c} dg {dg} {h}x{w} align "
                    f"{align}: {tuple(plan)} vs {want}")
        require(lib.kair_gda_plan(33 * 4, 4, 9, 2, 8, 8, 16, plan) != 0,
                "the GDA plan took 33 channels a group")
        ph.note(f"the GDA plan mirror equals kair_gda_plan at 8 geometries; "
                f"RVRT-001's: {gda_plan(288, 12, 64, 64)}; GDA kernels "
                "(ptxas): " + ", ".join(f"{n} {r} regs {sp} B spill"
                                        for n, r, sp in ptx if "gda_" in n))
        # the sampler backward's scratch (the windows' row counts, starts and
        # lists) and its window pass's shared memory; the windows' bound
        from kair_tpu_torch.ops.kernels import bilin_sample as bs
        for g, h, w, cs, r, es, vec in ((96, 64, 64, 10, 9 * 64 * 64, 2, 4),
                                        (48, 64, 64, 48, 9 * 64 * 64, 2, 16),
                                        (48, 64, 64, 48, 9 * 64 * 64, 4, 16),
                                        (24, 64, 64, 3, 9 * 64 * 64, 2, 2),
                                        (7, 33, 65, 7, 100, 4, 4)):
            th, tw, tc = bs.bwd_tiles(g, h, w, cs, vec // es, es)
            want = bs.bwd_scratch_bytes(g, h, w, r, th, tw)
            got = lib.kair_bilin_bwd_scratch_bytes(g, h, w, cs, r, int(es == 2),
                                                   vec, th, tw, tc)
            require(got == want, f"sampler backward scratch mirror differs at "
                    f"G={g} {h}x{w} Cs={cs}: {got} vs {want}")
            want = bs.bwd_shared_bytes(th, tw, tc, es)
            got = lib.kair_bilin_bwd_shared_bytes(g, h, w, cs, r, int(es == 2),
                                                  vec, th, tw, tc)
            require(got == want, f"sampler backward shared-memory mirror "
                    f"differs at G={g} {h}x{w} Cs={cs}: {got} vs {want}")
        # BWD_MAX_WINDOWS windows a slab are taken, one more refused
        for nwy, ok in ((bs.BWD_MAX_WINDOWS // 8, True),
                        (bs.BWD_MAX_WINDOWS // 8 + 1, False)):
            got = lib.kair_bilin_bwd_scratch_bytes(1, nwy, 8, 2, 1, 1, 4, 1, 1, 2)
            require((got >= 0) == ok, f"sampler backward: {nwy * 8} windows a "
                    f"slab {'refused' if ok else 'taken'} (BWD_MAX_WINDOWS "
                    f"{bs.BWD_MAX_WINDOWS})")
        vrt = bs.bwd_tiles(96, 64, 64, 10, 2, 2)
        ph.note("sampler backward: the scratch and shared-memory mirrors equal "
                "kair_bilin_bwd_scratch_bytes / kair_bilin_bwd_shared_bytes at "
                f"5 geometries, and {bs.BWD_MAX_WINDOWS} windows a slab are the "
                f"most it takes; VRT-001's stage-1 windows {vrt}, "
                f"{bs.bwd_shared_bytes(*vrt, 2)} B of shared memory a block, "
                f"{bs.bwd_scratch_bytes(96, 64, 64, 9 * 64 * 64, *vrt[:2])} B "
                "of scratch")


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    report: list = []
    with Phase("0 device") as ph:
        if not torch.cuda.is_available():
            ph.note("torch.cuda.is_available() is False")
            raise RuntimeError("no CUDA device: chip_smoke needs an NVIDIA card")
        card = nvidia_smi()
        log(card)
        ph.note(f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
                f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                f"python {sys.version.split()[0]}")
        # the plain references are f32: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    from kair_tpu_torch.ops.kernels import _build
    phase_build()
    phase_swin(report)
    phase_conv(report)
    phase_main_path(report, _build.BUILD_DIR)
    phase_throughput(card)
    phase_swin_bwd(report)
    phase_train(report, card, _build.BUILD_DIR)
    phase_swin_win(report)
    phase_window_msa(report)
    phase_jpeg_car(report, card)
    phase_unfused(report, card, _build.BUILD_DIR)
    phase_swinir_l(card)
    phase_tmsa(report)
    phase_self6(report)
    phase_dcn(report)
    phase_vrt(report, card)
    phase_stl2(report)
    phase_gda(report)
    phase_rvrt(report, card)
    phase_bilin(report)
    phase_vrt_train(report, card, _build.BUILD_DIR)
    phase_zoo(card)
    phase_timing_clis(card)
    phase_train_zoo(card, _build.BUILD_DIR)
    phase_rvrt_train(report, card, _build.BUILD_DIR)
    phase_gan_train(report, card, _build.BUILD_DIR)
    phase_face(card, _build.BUILD_DIR)
    phase_spect(report, card, _build.BUILD_DIR)
    phase_scale_out(report, card, _build.BUILD_DIR)
    phase_f32(report, card, _build.BUILD_DIR)
    faulthandler.cancel_dump_traceback_later()

    log(card)
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
