"""Video restoration testing entry (counterpart of
``kair_tpu/cli/test_video.py``; KAIR main_test_vrt.py:24-157 and
main_test_rvrt.py:24-140): pick a VRT or RVRT task preset, load the released
KAIR ``.pth`` as it is, choose the test dataset from the folder name, run
temporally and spatially tiled inference (``eval/video_test``), report
PSNR/SSIM (and on the Y channel).

    python -m kair_tpu_torch.cli.test_video \
        --task 001_VRT_videosr_bi_REDS_6frames \
        --model_path model_zoo/vrt/001_VRT_videosr_bi_REDS_6frames.pth \
        --folder_lq testsets/REDS4/sharp_bicubic --folder_gt testsets/REDS4/GT \
        --tile 40 128 128 --tile_overlap 2 20 20
    python -m kair_tpu_torch.cli.test_video \
        --task 001_RVRT_videosr_bi_REDS_30frames \
        --model_path model_zoo/rvrt/001_RVRT_videosr_bi_REDS_30frames.pth \
        --folder_lq testsets/REDS4/sharp_bicubic --folder_gt testsets/REDS4/GT

Runs on the card in bf16 through the port's kernels (VRT: the TMSA and self
blocks, the DCN; RVRT: the STL blocks, the 2-D Swin block, the GDA) unless
``--device cpu`` (f32, their plain versions); ``--fuse off`` and
``--deform gather`` take the composed routes, the JAX package's XLA routes;
``--deform mxu`` samples the alignment through the bilinear sampler kernels.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from kair_tpu_torch import default_device

# task → VRT configuration (KAIR main_test_vrt.py:158-253)
VRT_TASKS = {
    "001_VRT_videosr_bi_REDS_6frames": dict(
        upscale=4, window_size=(6, 8, 8), depths=(8,) * 7 + (4,) * 6,
        embed_dims=(120,) * 7 + (180,) * 6, num_heads=(6,) * 13,
        pa_frames=2, deformable_groups=12),
    "002_VRT_videosr_bi_REDS_16frames": dict(
        upscale=4, window_size=(8, 8, 8), depths=(8,) * 7 + (4,) * 6,
        embed_dims=(120,) * 7 + (180,) * 6, num_heads=(6,) * 13,
        pa_frames=6, deformable_groups=24),
    "003_VRT_videosr_bi_Vimeo_7frames": dict(
        upscale=4, window_size=(8, 8, 8), depths=(8,) * 7 + (4,) * 6,
        embed_dims=(120,) * 7 + (180,) * 6, num_heads=(6,) * 13,
        pa_frames=4, deformable_groups=16),
    "004_VRT_videosr_bd_Vimeo_7frames": dict(
        upscale=4, window_size=(8, 8, 8), depths=(8,) * 7 + (4,) * 6,
        embed_dims=(120,) * 7 + (180,) * 6, num_heads=(6,) * 13,
        pa_frames=4, deformable_groups=16),
    "005_VRT_videodeblurring_DVD": dict(
        upscale=1, window_size=(6, 8, 8), depths=(8,) * 7 + (4,) * 4,
        embed_dims=(96,) * 7 + (120,) * 4, num_heads=(6,) * 11,
        pa_frames=2, deformable_groups=16),
    "006_VRT_videodeblurring_GoPro": dict(
        upscale=1, window_size=(6, 8, 8), depths=(8,) * 7 + (4,) * 4,
        embed_dims=(96,) * 7 + (120,) * 4, num_heads=(6,) * 11,
        pa_frames=2, deformable_groups=16),
    "007_VRT_videodeblurring_REDS": dict(
        upscale=1, window_size=(6, 8, 8), depths=(8,) * 7 + (4,) * 4,
        embed_dims=(96,) * 7 + (120,) * 4, num_heads=(6,) * 11,
        pa_frames=2, deformable_groups=16),
    "008_VRT_videodenoising_DAVIS": dict(
        upscale=1, window_size=(6, 8, 8), depths=(8,) * 7 + (4,) * 4,
        embed_dims=(96,) * 7 + (120,) * 4, num_heads=(6,) * 11,
        pa_frames=2, deformable_groups=16, nonblind_denoising=True),
    "009_VRT_videofi_Vimeo_4frames": dict(
        upscale=1, out_chans=3, img_size=(4, 256, 256), window_size=(4, 8, 8),
        depths=(8,) * 7 + (4,) * 4, embed_dims=(96,) * 7 + (120,) * 4,
        num_heads=(6,) * 11, pa_frames=0, indep_reconsts=()),
}

# task → RVRT configuration (KAIR main_test_rvrt.py:141-198)
_RVRT_SR = dict(upscale=4, clip_size=2, window_size=(2, 8, 8),
                num_blocks=(1, 2, 1), depths=(2, 2, 2),
                embed_dims=(144, 144, 144), num_heads=(6, 6, 6),
                inputconv_groups=(1, 1, 1, 1, 1, 1), deformable_groups=12,
                attention_heads=12)
_RVRT_DEBLUR = dict(_RVRT_SR, upscale=1, embed_dims=(192, 192, 192),
                    inputconv_groups=(1, 3, 3, 3, 3, 3))
RVRT_TASKS = {
    "001_RVRT_videosr_bi_REDS_30frames": _RVRT_SR,
    "002_RVRT_videosr_bi_Vimeo_14frames": _RVRT_SR,
    "003_RVRT_videosr_bd_Vimeo_14frames": _RVRT_SR,
    "004_RVRT_videodeblurring_DVD_16frames": _RVRT_DEBLUR,
    "005_RVRT_videodeblurring_GoPro_16frames": _RVRT_DEBLUR,
    "006_RVRT_videodenoising_DAVIS_16frames": dict(
        _RVRT_DEBLUR, inputconv_groups=(1, 3, 4, 6, 8, 4),
        nonblind_denoising=True),
}


def build_task(task: str, model_path: str, device: Optional[str] = None,
               fuse: bool = True, deform: str = "auto"):
    """(forward, scale, window_size, nonblind) for a task preset. The VRT or
    RVRT is loaded from the KAIR ``.pth`` at ``model_path`` (strict) and
    moved to ``device``: bf16 on the card, which the kernels take, f32 on
    the CPU (SpyNet stays f32). ``forward`` maps an NDHWC float32 numpy clip
    to the restored clip; ``forward.model`` is the module. ``deform`` is the
    DCN's route for VRT, the GDA's for RVRT."""
    from kair_tpu_torch.ckpt.torch_convert import load_torch_state_dict
    from kair_tpu_torch.models.rvrt import RVRT
    from kair_tpu_torch.models.vrt import VRT, cast_for_inference

    if task not in VRT_TASKS and task not in RVRT_TASKS:
        raise KeyError(f"unknown task '{task}'; known tasks: "
                       f"{sorted(VRT_TASKS) + sorted(RVRT_TASKS)}")
    dev = default_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    net, cfg = (VRT, VRT_TASKS[task]) if task in VRT_TASKS else \
        (RVRT, RVRT_TASKS[task])
    model = net(**cfg, fuse_block=fuse, deform_impl=deform)
    sd = load_torch_state_dict(model_path, "params")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    model = cast_for_inference(model, dev, dtype)

    def fwd(a: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
            return model(x).float().cpu().numpy()
    fwd.model = model
    return fwd, cfg["upscale"], cfg["window_size"], \
        bool(cfg.get("nonblind_denoising"))


def select_dataset(args):
    """Dataset choice from the folder names (KAIR main_test_vrt.py:46-70)."""
    from kair_tpu_torch.data import dataset_video as dv

    lq = (args.folder_lq or "").lower()
    if "vimeo" in lq:
        meta = args.meta_info_file or os.path.join(
            os.path.dirname(args.folder_gt or args.folder_lq), "meta.txt")
        if "videofi" in args.task:
            return dv.VideoTestVimeo90KDataset({
                "dataroot_gt": args.folder_gt, "dataroot_lq": args.folder_gt,
                "meta_info_file": meta, "pad_sequence": False,
                "num_frame": 7, "temporal_scale": 2})
        return dv.VideoTestVimeo90KDataset({
            "dataroot_gt": args.folder_gt, "dataroot_lq": args.folder_lq,
            "meta_info_file": meta, "pad_sequence": True, "num_frame": 7})
    if "videofi" in args.task:
        for name, cls in (("davis", dv.VFI_DAVIS), ("ucf101", dv.VFI_UCF101),
                          ("vid4", dv.VFI_Vid4)):
            if name in lq:
                return cls(args.folder_gt)
    if args.folder_gt is not None:
        return dv.VideoRecurrentTestDataset({
            "dataroot_gt": args.folder_gt, "dataroot_lq": args.folder_lq,
            "sigma": args.sigma})
    return dv.SingleVideoRecurrentTestDataset({"dataroot_lq": args.folder_lq})


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", type=str,
                        default="001_VRT_videosr_bi_REDS_6frames")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--sigma", type=int, default=0,
                        help="noise level for non-blind denoising tasks")
    parser.add_argument("--folder_lq", type=str, required=True)
    parser.add_argument("--folder_gt", type=str, default=None)
    parser.add_argument("--meta_info_file", type=str, default=None)
    parser.add_argument("--tile", type=int, nargs="+", default=[40, 128, 128],
                        help="[frames, h, w]; 0 to test that axis whole")
    parser.add_argument("--tile_overlap", type=int, nargs="+",
                        default=[2, 20, 20])
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--fuse", choices=["on", "off"], default="on",
                        help="the window block kernels (on) or the composed "
                             "blocks (off)")
    parser.add_argument("--deform", choices=["auto", "fused", "gather", "mxu"],
                        default="auto",
                        help="VRT's DCN or RVRT's GDA route: the kernel "
                             "(fused; auto on the card), the composed "
                             "gather, or the bilinear sampler kernels (mxu)")
    parser.add_argument("--save_result", action="store_true")
    parser.add_argument("--results", type=str, default="results")
    args = parser.parse_args(argv)

    from kair_tpu_torch.eval import video_test
    from kair_tpu_torch.utils import image as im
    from kair_tpu_torch.utils.logger import setup_logger

    logger = setup_logger("test_video")
    fwd, scale, window_size, nonblind = build_task(
        args.task, args.model_path, device=args.device,
        fuse=args.fuse == "on", deform=args.deform)
    if nonblind and args.sigma == 0:
        logger.warning("task %s is non-blind denoising but --sigma is 0; "
                       "pass e.g. --sigma 10", args.task)
    dataset = select_dataset(args)
    if len(dataset) == 0:
        raise SystemExit(f"No dataset found at {args.folder_lq}")

    save_dir = os.path.join(args.results, args.task)
    totals = {"psnr": [], "ssim": [], "psnr_y": [], "ssim_y": []}
    for idx in range(len(dataset)):
        ex = dataset.get_example(idx, None)
        lq, gt = ex["L"][None], ex.get("H")
        out = video_test.test_video(fwd, lq, sf=scale, window_size=window_size,
                                    num_frame_testing=args.tile[0],
                                    num_frame_overlapping=args.tile_overlap[0],
                                    size_patch_testing=args.tile[1],
                                    patch_overlap=args.tile_overlap[1])
        if "videofi" in args.task:
            out = out[:, :1]                      # KAIR :93-95
        elif "videosr" in args.task and "vimeo" in args.folder_lq.lower():
            out = out[:, 3:4]                     # the centre frame only

        folder = str(ex.get("folder", idx))
        per = {"psnr": [], "ssim": [], "psnr_y": [], "ssim_y": []}
        for i in range(out.shape[1]):
            img = im.nhwc_to_uint(out[:, i])
            if args.save_result:
                os.makedirs(os.path.join(save_dir, folder), exist_ok=True)
                im.imsave(img, os.path.join(save_dir, folder, f"{i:08d}.png"))
            if gt is not None:
                img_gt = (np.clip(gt[i], 0, 1) * 255.0).round().astype(np.uint8)
                per["psnr"].append(im.calculate_psnr(img, img_gt, border=0))
                per["ssim"].append(im.calculate_ssim(img, img_gt, border=0))
                y = im.rgb2ycbcr(img.astype(np.float32) / 255.0) * 255.0
                y_gt = im.rgb2ycbcr(img_gt.astype(np.float32) / 255.0) * 255.0
                per["psnr_y"].append(im.calculate_psnr(y, y_gt, border=0))
                per["ssim_y"].append(im.calculate_ssim(y, y_gt, border=0))
        if gt is not None:
            means = {k: float(np.mean(v)) for k, v in per.items()}
            for k in totals:
                totals[k].append(means[k])
            logger.info(
                f"Testing {folder:20s} ({idx:2d}/{len(dataset)}) - "
                f"PSNR: {means['psnr']:.2f} dB; SSIM: {means['ssim']:.4f}; "
                f"PSNR_Y: {means['psnr_y']:.2f} dB; "
                f"SSIM_Y: {means['ssim_y']:.4f}")
        else:
            logger.info(f"Testing {folder:20s} ({idx:2d}/{len(dataset)})")

    if totals["psnr"]:
        avg = {k: float(np.mean(v)) for k, v in totals.items()}
        logger.info(
            f"{save_dir} -- Average PSNR: {avg['psnr']:.2f} dB; "
            f"SSIM: {avg['ssim']:.4f}; PSNR_Y: {avg['psnr_y']:.2f} dB; "
            f"SSIM_Y: {avg['ssim_y']:.4f}")
        return avg
    return None


if __name__ == "__main__":
    main()
