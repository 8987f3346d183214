"""Blind face enhancement: RetinaFace detect → align → GPEN → paste back
(counterpart of ``kair_tpu/cli/test_face.py``; reference
main_test_face_enhancement.py).

    python -m kair_tpu_torch.cli.test_face --input testsets/real_faces \
        --output results/faces --retinaface model_zoo/RetinaFace-R50.pth \
        --gpen model_zoo/GPEN-BFR-512.pth [--size 512] [--sr 2]

Both ``.pth`` files load as released (KAIR's keys). The networks run on
the card in bf16 (``--device cpu``: f32 on the CPU); the alignment, warps and blending are ``utils/cv_ops``' cv2-free
versions. PNG files are read and written by ``utils/png``; other input
formats go through ``utils/image.imread_uint``, which needs cv2.
"""

from __future__ import annotations

import argparse
import os
import numpy as np
import torch

from kair_tpu_torch import default_device

def build_enhancer(retinaface_path: str, gpen_path: str, size: int = 512,
                   channel_multiplier: int = 2, threshold: float = 0.9,
                   device=None):
    """(detector, enhancer) callables for ``eval.face_pipeline.
    enhance_faces`` from the two local checkpoints; bf16 on the card and
    f32 on the CPU."""
    from kair_tpu_torch.eval.face_pipeline import (make_gpen_enhancer,
                                                   make_retinaface_detector)
    from kair_tpu_torch.models.gpen import FullGenerator
    from kair_tpu_torch.models.retinaface import load_retinaface

    dev = default_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    det = load_retinaface(retinaface_path).to(dev, dtype)
    gpen = FullGenerator(size=size, style_dim=512, n_mlp=8,
                         channel_multiplier=channel_multiplier)
    sd = torch.load(gpen_path, map_location="cpu", weights_only=True)
    gpen.load_state_dict({k[7:] if k.startswith("module.") else k: v
                          for k, v in sd.items()})
    gpen = gpen.to(dev, dtype).eval()
    return make_retinaface_detector(det, threshold), \
        make_gpen_enhancer(gpen, size)


def read_rgb(path: str) -> np.ndarray:
    """An RGB uint8 image: PNG by ``utils/png``, other formats by
    ``utils/image.imread_uint`` (which needs cv2)."""
    if path.lower().endswith(".png"):
        from kair_tpu_torch.utils.png import read_png
        img = read_png(path)
        return np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img
    from kair_tpu_torch.utils.image import imread_uint
    return imread_uint(path, 3)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="image file or dir")
    parser.add_argument("--output", default="results/face_enhancement")
    parser.add_argument("--retinaface", default="model_zoo/RetinaFace-R50.pth")
    parser.add_argument("--gpen", default="model_zoo/GPEN-BFR-512.pth")
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--channel_multiplier", type=int, default=2)
    parser.add_argument("--threshold", type=float, default=0.9)
    parser.add_argument("--sr", type=float, default=2.0,
                        help="pre-upscale factor (the reference resizes 2x "
                             "before enhancement, "
                             "main_test_face_enhancement.py:162)")
    parser.add_argument("--save_faces", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from kair_tpu_torch.eval.face_pipeline import enhance_faces
    from kair_tpu_torch.utils import cv_ops
    from kair_tpu_torch.utils.logger import setup_logger
    from kair_tpu_torch.utils.png import write_png

    logger = setup_logger("kair_tpu_torch.test_face")
    for p in (args.retinaface, args.gpen):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"weights not found: {p}: pass RetinaFace-R50.pth and "
                "GPEN-BFR-512.pth with --retinaface / --gpen")
    detector, enhancer = build_enhancer(
        args.retinaface, args.gpen, args.size, args.channel_multiplier,
        args.threshold, args.device)
    os.makedirs(args.output, exist_ok=True)

    if os.path.isdir(args.input):
        exts = (".png", ".jpg", ".jpeg", ".bmp")
        paths = sorted(os.path.join(args.input, f)
                       for f in os.listdir(args.input)
                       if f.lower().endswith(exts))
    else:
        paths = [args.input]

    results = []
    for idx, path in enumerate(paths):
        name = os.path.splitext(os.path.basename(path))[0]
        img = read_rgb(path)
        if args.sr and args.sr != 1.0:
            img = cv_ops.resize_linear(img, (0, 0), fx=args.sr, fy=args.sr)
        out, orig_faces, enhanced_faces = enhance_faces(
            img, detector, enhancer, size=args.size, threshold=args.threshold)
        logger.info(f"{idx + 1:4d} -> {name}: {len(orig_faces)} face(s)")
        write_png(os.path.join(args.output, name + "_enhanced.png"), out)
        write_png(os.path.join(args.output, name + "_comparison.png"),
                  np.hstack([img, out]))
        if args.save_faces:
            for m, (ef, of) in enumerate(zip(enhanced_faces, orig_faces)):
                of = cv_ops.resize_linear(of, ef.shape[:2])
                write_png(os.path.join(args.output, f"{name}_face{m:02d}.png"),
                          np.hstack([of, ef]))
        results.append((name, out, len(orig_faces)))
    return results


if __name__ == "__main__":
    main()
