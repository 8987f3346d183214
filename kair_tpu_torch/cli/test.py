"""Testing entry point (counterpart of ``kair_tpu/cli/test.py``; reference
``main_test_*.py``): load a KAIR ``.pth``, apply the bicubic ×4 degradation
to every image of a test set, run the model through ``test_pad``, report
per-image and average PSNR/SSIM.

    python -m kair_tpu_torch.cli.test --model_name swinir_classical_x4 \
        --model_path model_zoo/001_classicalSR_DF2K_s64w8_SwinIR-M_x4.pth \
        --testset_dir testsets/Set5/HR

Runs on the card (bf16) unless ``--device cpu`` is given (f32, the plain
versions of the kernels). This slice ports the SwinIR presets; the other
zoo names raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from kair_tpu_torch import default_device

SWINIR_X4 = dict(upscale=4, in_chans=3, embed_dim=180, depths=(6,) * 6,
                 num_heads=(6,) * 6, window_size=8, mlp_ratio=2.0,
                 upsampler="pixelshuffle", resi_connection="1conv")

LATER_SLICES = {
    "dncnn": "CNN zoo", "ffdnet": "CNN zoo", "drunet": "CNN zoo",
    "msrresnet": "CNN zoo", "rrdb": "CNN zoo", "imdn": "CNN zoo",
    "srmd": "CNN zoo", "usrnet": "CNN zoo", "ircnn": "CNN zoo",
}


def _img_size_of(sd) -> int:
    """KAIR's training resolution, read off a shifted block's attn_mask
    ((img_size/8)² windows); 64 when the checkpoint has none."""
    for k, v in sd.items():
        if k.endswith(".attn_mask"):
            return int(round(np.sqrt(v.shape[0]))) * 8
    return 64


def build_preset(model_name: str, model_path: str,
                 device: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None
                 ) -> Tuple[torch.nn.Module, str, int]:
    """(model, forward_kind, n_channels) for a released zoo name; the model
    is loaded from ``model_path``, moved to ``device`` in ``dtype`` (bf16 on
    the card, f32 on the CPU by default) and set to eval mode."""
    from kair_tpu_torch.ckpt.torch_convert import load_torch_state_dict
    from kair_tpu_torch.models.swinir import SwinIR

    dev = default_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if model_name.startswith("swinir"):
        # classical x4 (main_test_swinir.py:130-140), as in the JAX preset
        sd = load_torch_state_dict(model_path, "params")
        model = SwinIR(img_size=_img_size_of(sd), **SWINIR_X4)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        return model.to(device=dev, dtype=dtype).eval(), "sr4", 3
    for prefix, slice_name in LATER_SLICES.items():
        if model_name.startswith(prefix):
            raise NotImplementedError(
                f"model preset [{model_name}] belongs to the {slice_name} "
                "slice of the port, not ported yet")
    raise NotImplementedError(f"model preset [{model_name}]")


def make_forward(model: torch.nn.Module):
    """NHWC float32 numpy batch → NHWC float32 numpy output, on the model's
    device and dtype."""
    p = next(model.parameters())

    def fwd(a: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(a)).to(p.device, p.dtype)
            return model(x).float().cpu().numpy()
    return fwd


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", type=str, default="swinir_classical_x4")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--testset_dir", type=str, required=True)
    parser.add_argument("--results", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--border", type=int, default=4)
    args = parser.parse_args(argv)

    from kair_tpu_torch.eval.test_modes import test_pad
    from kair_tpu_torch.utils import image as im
    from kair_tpu_torch.utils.logger import setup_logger

    logger = setup_logger("test")
    model, _, n_channels = build_preset(args.model_name, args.model_path,
                                        device=args.device)
    fwd = make_forward(model)
    sf = 4

    psnrs, ssims = [], []
    for path in im.get_image_paths(args.testset_dir):
        img_h = im.modcrop(im.imread_uint(path, n_channels), sf)
        img_l = im.imresize_np(im.uint2single(img_h), 1 / sf, True)
        e = test_pad(fwd, im.hwc_to_nhwc(img_l.astype(np.float32)),
                     modulo=8, sf=sf)
        img_e = im.nhwc_to_uint(e)
        psnr = im.calculate_psnr(img_e, img_h.squeeze(), border=args.border)
        ssim = im.calculate_ssim(img_e, img_h.squeeze(), border=args.border)
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
