"""Testing entry point (counterpart of ``kair_tpu/cli/test.py``; reference
``main_test_*.py``): load a KAIR ``.pth``, apply the preset's seeded
degradation protocol to every image of a test set, run the model, report
per-image and average PSNR/SSIM.

    python -m kair_tpu_torch.cli.test --model_name dncnn_25 \
        --model_path model_zoo/dncnn_25.pth --testset_dir testsets/set12 \
        --noise_level_img 25
    python -m kair_tpu_torch.cli.test --model_name swinir_classical_x4 \
        --model_path model_zoo/001_classicalSR_DF2K_s64w8_SwinIR-M_x4.pth \
        --testset_dir testsets/Set5/HR [--x8] [--fuse auto|on|off]

The presets mirror the reference test scripts' networks
(``kair_tpu/cli/test.py:35-103``) with their forward kinds and protocols:
``plain`` (DnCNN, IRCNN), ``ffdnet`` and ``drunet`` denoise seeded AWGN of
``--noise_level_img`` (the latter two given the σ map); ``srmd`` is
bicubic ×4 with the PCA degradation map; ``usrnet`` the ``kernels_12[0]``
wrap blur and ×4 subsampling; ``sr4`` (MSRResNet, RRDB, IMDN, SwinIR)
bicubic ×4. ``--border`` applies to the denoisers; the SR kinds shave
their scale.

Runs on the card in bf16 unless ``--dtype f32`` is given (the f32
kernels, TF32 off for cuBLAS and cuDNN: ``exact_f32``; what the JAX CLI
always runs) or ``--device cpu`` (f32, the plain versions of the
kernels). ``--x8`` is the 8-fold self-ensemble (mode 3 of
``eval/test_modes.test_mode``); ``--fuse`` picks SwinIR's fused block
kernels (on) or its unfused route with the window-attention kernel (off);
auto is on where a card is present.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from kair_tpu_torch import default_device, exact_f32

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
SWINIR_X4 = dict(upscale=4, in_chans=3, embed_dim=180, depths=(6,) * 6,
                 num_heads=(6,) * 6, window_size=8, mlp_ratio=2.0,
                 upsampler="pixelshuffle", resi_connection="1conv")

BLIND_DNCNN = ("dncnn_gray_blind", "dncnn_color_blind", "dncnn3")


def _img_size_of(sd) -> int:
    """KAIR's training resolution, read off a shifted block's attn_mask
    ((img_size/8)² windows); 64 when the checkpoint has none."""
    for k, v in sd.items():
        if k.endswith(".attn_mask"):
            return int(round(np.sqrt(v.shape[0]))) * 8
    return 64


def preset_model(model_name: str, sd: dict, fuse: bool = True
                 ) -> Tuple[torch.nn.Module, str, int]:
    """(f32 model on the CPU, forward_kind, n_channels) of a zoo name, the
    network built at the preset's width; ``sd`` is the checkpoint (read for
    SwinIR's training size and DRUNet's biases)."""
    from kair_tpu_torch.models import (dncnn, drunet, ffdnet, imdn, rrdbnet,
                                       srresnet, swinir, usrnet)
    n = 3 if "color" in model_name else 1
    if model_name.startswith("dncnn"):
        nb = 20 if model_name in BLIND_DNCNN else 17
        return dncnn.DnCNN(n, n, 64, nb, "R"), "plain", n
    if model_name.startswith("ffdnet"):
        color = n == 3
        return ffdnet.FFDNet(n, n, 96 if color else 64, 12 if color else 15,
                             "R"), "ffdnet", n
    if model_name.startswith("drunet"):
        # released DRUNets are bias-free; a tree from the JAX package has
        # biases (its UNetRes defaults to bias=True)
        return drunet.UNetRes(n + 1, n, (64, 128, 256, 512), 4,
                              bias="m_head.bias" in sd), "drunet", n
    if model_name.startswith("swinir"):
        # classical x4 (main_test_swinir.py:130-140), as in the JAX preset
        return swinir.SwinIR(img_size=_img_size_of(sd), fuse_block=fuse,
                             **SWINIR_X4), "sr4", 3
    if model_name.startswith("msrresnet"):
        return srresnet.MSRResNet0(3, 3, 64, 16, 4, "R", "upconv"), "sr4", 3
    if model_name.startswith("rrdb"):
        return rrdbnet.RRDB(3, 3, 64, 23, 32, 4, "L", "upconv"), "sr4", 3
    if model_name.startswith("imdn"):
        return imdn.IMDN(3, 3, 64, 8, 4, "L", "pixelshuffle"), "sr4", 3
    if model_name.startswith("srmd"):
        return srresnet.SRMD(19, 3, 128, 12, 4, "R", "pixelshuffle"), "srmd", 3
    if model_name.startswith("usrnet"):
        tiny = "tiny" in model_name
        return usrnet.USRNet(
            n_iter=6 if tiny else 8, h_nc=32 if tiny else 64,
            nc=(16, 32, 64, 64) if tiny else (64, 128, 256, 512),
            nb=2), "usrnet", 3
    if model_name.startswith("ircnn"):
        return dncnn.IRCNN(n, n, 64), "plain", n
    raise NotImplementedError(f"model preset [{model_name}]")


def build_preset(model_name: str, model_path: str,
                 device: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, fuse: bool = True
                 ) -> Tuple[torch.nn.Module, str, int]:
    """(model, forward_kind, n_channels) for a released zoo name; the model
    is loaded from ``model_path`` (strict), moved to ``device`` in ``dtype``
    (bf16 on the card, f32 on the CPU by default) and set to eval mode.
    ``fuse``: SwinIR's fused block kernels, or its unfused route."""
    from kair_tpu_torch.ckpt.torch_convert import load_torch_state_dict

    dev = default_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    sd = load_torch_state_dict(
        model_path, "params" if model_name.startswith("swinir") else None)
    model, kind, n_channels = preset_model(model_name, sd, fuse)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.to(device=dev, dtype=dtype).eval(), kind, n_channels


def make_forward(model: torch.nn.Module, sigma: Optional[float] = None):
    """NHWC float32 numpy batch → NHWC float32 numpy output, on the model's
    device (the model takes the f32 input into its weights' type);
    ``sigma``: FFDNet's noise level, given as its (N, 1, 1, 1) input."""
    p = next(model.parameters())

    def fwd(a: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(p.device)
            if sigma is None:
                return model(x).float().cpu().numpy()
            s = torch.full((x.shape[0], 1, 1, 1), sigma, device=p.device)
            return model(x, s).float().cpu().numpy()
    return fwd


def usrnet_forward(model: torch.nn.Module, x: np.ndarray, k: np.ndarray,
                   sf: int) -> np.ndarray:
    """USRNet on an NHWC LR batch with blur ``k`` (kh, kw), noise level 0;
    the LR image edge-padded to even sizes (HR multiples of 8 for the
    prior) and the output cropped back."""
    p = next(model.parameters())
    h, w = x.shape[1:3]
    x = np.pad(x, ((0, 0), (0, h % 2), (0, w % 2), (0, 0)), mode="edge")
    with torch.inference_mode():
        e = model(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(p.device),
                  torch.from_numpy(k[None, :, :, None]).to(p.device), sf,
                  torch.zeros(1, 1, 1, 1, device=p.device))
    return e.float().cpu().numpy()[:, :h * sf, :w * sf]


def degrade(kind: str, img_h: np.ndarray, noise: float):
    """(img_h, LR input, shave border or None for ``--border``, sf, blur
    kernel) of one image under the preset kind's protocol
    (``kair_tpu/cli/test.py:134-181``)."""
    from kair_tpu_torch.degrade import sisr
    from kair_tpu_torch.utils import image as im

    if kind in ("plain", "ffdnet", "drunet"):
        # seeded AWGN (main_test_dncnn.py:151-152)
        np.random.seed(seed=0)
        img_l = im.uint2single(img_h)
        img_l = img_l + np.random.normal(0, noise, img_l.shape)
        if kind == "drunet":
            img_l = np.concatenate(
                [img_l, np.full(img_l.shape[:2] + (1,), noise, np.float32)], -1)
        return img_h, img_l, None, 1, None
    if kind == "usrnet":
        # the kernels_12 validation kernel (reference dataset_usrnet.py:105-112)
        from scipy import ndimage
        k = sisr.load_kernels_12()[0]
        k = (k / k.sum()).astype(np.float32)
        img_h = im.modcrop(img_h, 4)
        img_l = ndimage.convolve(im.uint2single(img_h),
                                 k[:, :, None].astype(np.float64),
                                 mode="wrap")[::4, ::4]
        return img_h, img_l, 4, 4, k
    img_h = im.modcrop(img_h, 4)
    img_l = im.imresize_np(im.uint2single(img_h), 1 / 4, True)
    if kind == "srmd":
        # bicubic degradation with the published PCA basis (main_test_srmd.py)
        k = sisr.anisotropic_gaussian(15, np.pi, 0.1, 0.1)
        m_vec = np.concatenate([sisr.pca_project(k, sisr.load_srmd_pca()),
                                [noise]])
        m_map = np.broadcast_to(m_vec.astype(np.float32),
                                img_l.shape[:2] + (m_vec.size,))
        img_l = np.concatenate([img_l.astype(np.float32), m_map], -1)
    return img_h, img_l, 4, 4, None


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", type=str, default="dncnn_25")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--testset_dir", type=str, required=True)
    parser.add_argument("--results", type=str, default=None)
    parser.add_argument("--noise_level_img", type=int, default=25)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--border", type=int, default=0,
                        help="shaved border of the denoisers' PSNR/SSIM")
    parser.add_argument("--x8", action="store_true")
    parser.add_argument("--fuse", choices=["auto", "on", "off"],
                        default="auto",
                        help="fused Swin block kernels (swinir): auto = on "
                             "when a card is present")
    parser.add_argument("--dtype", choices=list(DTYPES), default=None,
                        help="bf16 (the card's default) or f32 (the CPU's "
                             "default; the JAX CLI's only one)")
    args = parser.parse_args(argv)
    dtype = DTYPES.get(args.dtype)
    exact_f32(args.device, dtype)

    from kair_tpu_torch.eval.test_modes import test_mode
    from kair_tpu_torch.utils import image as im
    from kair_tpu_torch.utils.logger import setup_logger

    logger = setup_logger("test")
    fuse = args.fuse == "on" or (args.fuse == "auto"
                                 and default_device(args.device).type == "cuda")
    model, kind, n_channels = build_preset(args.model_name, args.model_path,
                                           device=args.device, dtype=dtype,
                                           fuse=fuse)
    noise = args.noise_level_img / 255.0
    fwd = make_forward(model, noise if kind == "ffdnet" else None)

    psnrs, ssims = [], []
    for path in im.get_image_paths(args.testset_dir):
        img_h, img_l, border, sf, k = degrade(
            kind, im.imread_uint(path, n_channels), noise)
        border = args.border if border is None else border
        x = im.hwc_to_nhwc(img_l.astype(np.float32))
        if kind == "usrnet":
            e = usrnet_forward(model, x, k, sf)
        else:
            e = test_mode(fwd, x, mode=3 if args.x8 else 1, sf=sf,
                          modulo=8 if kind in ("drunet", "sr4") else 1)
        img_e = im.nhwc_to_uint(e)
        psnr = im.calculate_psnr(img_e, img_h.squeeze(), border=border)
        ssim = im.calculate_ssim(img_e, img_h.squeeze(), border=border)
        psnrs.append(psnr)
        ssims.append(ssim)
        logger.info(f"{os.path.basename(path):>16s} - PSNR: {psnr:.2f} dB; "
                    f"SSIM: {ssim:.4f}.")
        if args.results:
            os.makedirs(args.results, exist_ok=True)
            im.imsave(img_e, os.path.join(args.results, os.path.basename(path)))

    logger.info(f"Average PSNR/SSIM - {args.model_name} - "
                f"PSNR: {np.mean(psnrs):.2f} dB; SSIM: {np.mean(ssims):.4f}")
    return float(np.mean(psnrs)), float(np.mean(ssims))


if __name__ == "__main__":
    main()
