"""Write a meta_info txt for the video datasets (counterpart of
``kair_tpu/cli/make_meta_info.py``; KAIR's shipped data/meta_info/*.txt
lists, meta_info_REDS_GT.txt etc., read by dataset_video_train.py:64-76).

Each line: "<clip> <frame_count> (<h>,<w>,<c>) <start_frame>" for
REDS-style trees, or "<clip>/<seq> <frame_count> (<h>,<w>,<c>)" for
Vimeo-style clip/sequence trees.

    python -m kair_tpu_torch.cli.make_meta_info --data_path trainsets/REDS/GT \
        --out data/meta_info/meta_info_REDS_GT.txt
"""

from __future__ import annotations

import argparse
import os
import re


def _frame_dirs(data_path: str):
    """Yield (key, dir) for leaf directories that contain images."""
    exts = (".png", ".jpg", ".jpeg", ".bmp")
    for root, dirs, files in os.walk(data_path):
        if any(f.lower().endswith(exts) for f in files):
            rel = os.path.relpath(root, data_path)
            yield ("" if rel == "." else rel.replace(os.sep, "/")), root


def scan_clip(d: str):
    """(frame_count, (h, w, c), start_frame) for one frame folder."""
    import cv2

    names = sorted(f for f in os.listdir(d)
                   if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    if not names:
        return None
    img = cv2.imread(os.path.join(d, names[0]), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cannot read {os.path.join(d, names[0])}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    m = re.match(r"(\d+)", os.path.splitext(names[0])[0].split("im")[-1])
    start = int(m.group(1)) if m else 0
    return len(names), (h, w, c), start


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--with_start", action="store_true",
                   help="append the start frame index (REDS-style lists)")
    args = p.parse_args(argv)

    lines = []
    for key, d in sorted(_frame_dirs(args.data_path)):
        info = scan_clip(d)
        if info is None:
            continue
        n, (h, w, c), start = info
        line = f"{key} {n} ({h},{w},{c})"
        if args.with_start:
            line += f" {start}"
        lines.append(line)
    if not lines:
        raise SystemExit(f"no frame folders found under {args.data_path}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} clips to {args.out}")


if __name__ == "__main__":
    main()
