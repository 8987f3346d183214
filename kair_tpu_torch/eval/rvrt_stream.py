"""Chunked RVRT inference for long videos (counterpart of
``kair_tpu/eval/rvrt_stream.py``; KAIR's CPU feature cache,
``network_rvrt.py:1115-1155``).

The monolithic forward keeps every branch's features for all T frames on
the card. Here the clip-recurrent propagation runs with the produced clips
kept in host memory: only the carried clip, the current clip's inputs and
the flows it needs are on the card, so device memory is O(clip) instead of
O(T). The shallow features and the flows are made clip by clip and pair by
pair, and the reconstruction clip by clip; every stage is per frame or per
clip, so the result equals the forward's (the same ops in the same order).
"""

from __future__ import annotations

import numpy as np
import torch


def rvrt_forward_streamed(model, lqs: np.ndarray) -> np.ndarray:
    """Run an RVRT (``models/rvrt.py``, already on its device and in its
    type) on (N, T, H, W, C) float32 frames with per-clip device
    residency; returns (N, T, sH, sW, 3) float32."""
    from kair_tpu_torch.models.rvrt import ORDER
    dev = model.conv_last.weight.device
    clip = model.clip_size
    x = torch.from_numpy(np.ascontiguousarray(lqs, np.float32))
    n, t = x.shape[:2]
    if t % clip:
        raise ValueError(f"{t} frames do not divide into clips of {clip}")
    host = lambda a: a.cpu()
    card = lambda a: a.to(dev)
    clips = [x[:, i:i + clip] for i in range(0, t, clip)]
    with torch.inference_mode():
        feats = {"shallow": [host(model.shallow(card(c))) for c in clips]}
        fb, ff = [], []
        for j in range(t - 1):
            a, b = (model.flow_frames(card(x[:, i:i + 1]))[:, 0]
                    for i in (j, j + 1))
            fb.append(host(model.flows(a, b)))
            ff.append(host(model.flows(b, a)))
        model.propagate(feats, fb, ff, keep=host, fetch=card)
        outs = [host(model.reconstruct(
            card(torch.cat([feats[k][i] for k in ("shallow",) + ORDER], -1)),
            card(c))) for i, c in enumerate(clips)]
    return torch.cat(outs, 1).numpy()
