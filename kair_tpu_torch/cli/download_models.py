"""Pretrained-model downloader (counterpart of
``kair_tpu/cli/download_models.py``; reference
main_download_pretrained_models.py:52-130): released torch checkpoints
into model_zoo/, which the port loads as they are. Where the download
fails (a machine without network), it prints the URL to fetch by hand
and where to put the file.

    python -m kair_tpu_torch.cli.download_models --models dncnn_25 swinir_classical_sr_x4
"""

from __future__ import annotations

import argparse
import os

_KAIR = "https://github.com/cszn/KAIR/releases/download/v1.0/{}"
_SWINIR = "https://github.com/JingyunLiang/SwinIR/releases/download/v0.0/{}"
_VRT = "https://github.com/JingyunLiang/VRT/releases/download/v0.0/{}"
_RVRT = "https://github.com/JingyunLiang/RVRT/releases/download/v0.0/{}"

# model name → (filename, release url template); mirrors the reference's
# method_model_zoo table (main_download_pretrained_models.py:60-113)
ZOO = {
    # DnCNN family
    "dncnn_15": ("dncnn_15.pth", _KAIR),
    "dncnn_25": ("dncnn_25.pth", _KAIR),
    "dncnn_50": ("dncnn_50.pth", _KAIR),
    "dncnn_gray_blind": ("dncnn_gray_blind.pth", _KAIR),
    "dncnn_color_blind": ("dncnn_color_blind.pth", _KAIR),
    "dncnn3": ("dncnn3.pth", _KAIR),
    "ircnn_gray": ("ircnn_gray.pth", _KAIR),
    "ircnn_color": ("ircnn_color.pth", _KAIR),
    # FFDNet
    "ffdnet_gray": ("ffdnet_gray.pth", _KAIR),
    "ffdnet_color": ("ffdnet_color.pth", _KAIR),
    "ffdnet_gray_clip": ("ffdnet_gray_clip.pth", _KAIR),
    "ffdnet_color_clip": ("ffdnet_color_clip.pth", _KAIR),
    # SRMD / DPSR
    "srmdnf_x2": ("srmdnf_x2.pth", _KAIR), "srmdnf_x3": ("srmdnf_x3.pth", _KAIR),
    "srmdnf_x4": ("srmdnf_x4.pth", _KAIR),
    "srmd_x2": ("srmd_x2.pth", _KAIR), "srmd_x3": ("srmd_x3.pth", _KAIR),
    "srmd_x4": ("srmd_x4.pth", _KAIR),
    "dpsr_x4_gan": ("dpsr_x4_gan.pth", _KAIR),
    # SR baselines
    "msrresnet_x4_psnr": ("msrresnet_x4_psnr.pth", _KAIR),
    "msrresnet_x4_gan": ("msrresnet_x4_gan.pth", _KAIR),
    "rrdb_x4_psnr": ("rrdb_x4_psnr.pth", _KAIR),
    "rrdb_x4_esrgan": ("rrdb_x4_esrgan.pth", _KAIR),
    "imdn_x4": ("imdn_x4.pth", _KAIR),
    # USRNet
    "usrnet": ("usrnet.pth", _KAIR), "usrnet_tiny": ("usrnet_tiny.pth", _KAIR),
    "usrgan": ("usrgan.pth", _KAIR), "usrgan_tiny": ("usrgan_tiny.pth", _KAIR),
    # DRUNet
    "drunet_gray": ("drunet_gray.pth", _KAIR),
    "drunet_color": ("drunet_color.pth", _KAIR),
    # BSRGAN
    "bsrgan": ("BSRGAN.pth", _KAIR),
    # SwinIR (subset; any release asset name works via --file)
    "swinir_classical_sr_x4": (
        "001_classicalSR_DF2K_s64w8_SwinIR-M_x4.pth", _SWINIR),
    "swinir_lightweight_sr_x4": (
        "002_lightweightSR_DIV2K_s64w8_SwinIR-S_x4.pth", _SWINIR),
    "swinir_real_sr_x4": (
        "003_realSR_BSRGAN_DFO_s64w8_SwinIR-M_x4_GAN.pth", _SWINIR),
    "swinir_gray_dn_25": (
        "004_grayDN_DFWB_s128w8_SwinIR-M_noise25.pth", _SWINIR),
    "swinir_color_dn_25": (
        "005_colorDN_DFWB_s128w8_SwinIR-M_noise25.pth", _SWINIR),
    # VRT / RVRT / SpyNet
    "vrt_videosr_reds_6frames": (
        "001_VRT_videosr_bi_REDS_6frames.pth", _VRT),
    "rvrt_videosr_reds_30frames": (
        "001_RVRT_videosr_bi_REDS_30frames.pth", _RVRT),
    "spynet": ("spynet_sintel_final-3d2a1287.pth", _VRT),
    # GPEN
    "gpen_512": ("GPEN-512.pth", _KAIR),
}


def download(model_name: str, model_dir: str = "model_zoo",
             file: str = None) -> str:
    if file:
        filename, url_tmpl = file, _KAIR
    else:
        if model_name not in ZOO:
            raise KeyError(f"unknown model '{model_name}'; known: "
                           f"{sorted(ZOO)[:8]}... (or pass --file)")
        filename, url_tmpl = ZOO[model_name]
    url = url_tmpl.format(filename)
    os.makedirs(model_dir, exist_ok=True)
    dest = os.path.join(model_dir, filename)
    if os.path.exists(dest):
        print(f"{dest} already exists")
        return dest
    try:
        import urllib.request

        print(f"downloading {url} -> {dest}")
        urllib.request.urlretrieve(url, dest)
        return dest
    except (OSError, ValueError) as e:
        print(f"download failed ({e}); fetch manually:\n  {url}\n"
              f"and place it at {dest}")
        return url


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--models", nargs="+", default=["dncnn_25"])
    p.add_argument("--model_dir", default="model_zoo")
    p.add_argument("--file", default=None)
    args = p.parse_args(argv)
    for m in args.models:
        download(m, args.model_dir, args.file)


if __name__ == "__main__":
    main()
