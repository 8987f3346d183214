"""Build a packed-frame store from an image folder tree (counterpart of
``kair_tpu/cli/make_framepack.py``; KAIR's lmdb preparation,
utils/utils_lmdb.py:9-130).

    python -m kair_tpu_torch.cli.make_framepack \
        --data_path trainsets/REDS/train_sharp \
        --pack_path trainsets/REDS/train_sharp.fpk

Keys are relative paths without extension (e.g. "000/00000000"), matching
the reference's lmdb key convention (dataset_video_train.py:148-149), so
the video training sets read the pack with
    "io_backend": {"type": "framepack"}
in either package.
"""

from __future__ import annotations

import argparse
import os


def scan_images(data_path: str, exts=(".png", ".jpg", ".jpeg", ".bmp")):
    paths = []
    for root, _, files in os.walk(data_path):
        rel = os.path.relpath(root, data_path)
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in exts:
                paths.append(f if rel == "." else os.path.join(rel, f))
    return sorted(paths)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True)
    p.add_argument("--pack_path", required=True,
                   help="output directory; must end with .fpk")
    p.add_argument("--compress_level", type=int, default=1)
    p.add_argument("--n_thread", type=int, default=8)
    args = p.parse_args(argv)

    from kair_tpu_torch.data.framepack import make_framepack_from_imgs

    img_paths = scan_images(args.data_path)
    if not img_paths:
        raise SystemExit(f"no images found under {args.data_path}")
    keys = [os.path.splitext(p)[0].replace(os.sep, "/") for p in img_paths]
    make_framepack_from_imgs(args.data_path, args.pack_path, img_paths, keys,
                             compress_level=args.compress_level,
                             n_thread=args.n_thread)


if __name__ == "__main__":
    main()
