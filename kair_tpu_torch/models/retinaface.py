"""RetinaFace-R50 face detection for the GPEN pipeline (counterpart of
``kair_tpu/models/retinaface.py``; reference retinaface/facemodels/
retinaface.py:48-145, net.py FPN/SSH, layers/functions/prior_box.py:7-34,
utils_faces/box_utils.py:209-247, nms/py_cpu_nms.py:10-38).

torchvision's ResNet-50 trunk → FPN → SSH contexts → class, box and
landmark heads, in the RetinaFace-R50 checkpoint's keys (``body.layer1.0.
conv1.weight``, ``fpn.output1.0.weight``, ``ssh1.conv3X3.0.weight``,
``ClassHead.0.conv1x1.weight``, …): ``load_retinaface`` loads a released
``.pth`` (a ``module.`` prefix stripped) as it is. NHWC in, cuDNN convs;
the FPN's upsampling is ``F.interpolate(mode="nearest")`` as the
reference's (the JAX package resizes with half-pixel centres, which agrees
at the exact ×2 steps of inputs whose sides are multiples of 32). Anchors,
decoding and NMS are host-side numpy, copies of the JAX package's.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

CFG_RE50 = {
    "min_sizes": [[16, 32], [64, 128], [256, 512]],
    "steps": [8, 16, 32],
    "variance": [0.1, 0.2],
    "clip": False,
    "in_channel": 256,
    "out_channel": 256,
}


def conv_bn(in_ch: int, out_ch: int, k: int = 3, stride: int = 1,
            leaky: float = 0.0, relu: bool = True) -> nn.Sequential:
    """net.py conv_bn / conv_bn1X1 / conv_bn_no_relu: conv (no bias), BN,
    then LeakyReLU(leaky) (ReLU at 0) unless ``relu`` is False."""
    layers = [nn.Conv2d(in_ch, out_ch, k, stride, k // 2, bias=False),
              nn.BatchNorm2d(out_ch)]
    if relu:
        layers.append(nn.LeakyReLU(leaky) if leaky > 0 else nn.ReLU())
    return nn.Sequential(*layers)


class Bottleneck(nn.Module):
    """torchvision's ResNet bottleneck (1x1 → 3x3 with the stride → 1x1,
    expansion 4)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_ch, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet50Body(nn.Module):
    """Layers 1-4 of torchvision's resnet50; returns layers 2, 3 and 4."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_ch = 64
        for li, (planes, blocks, stride) in enumerate(
                [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]):
            layer = [Bottleneck(in_ch, planes, stride, downsample=True)]
            layer += [Bottleneck(planes * 4, planes) for _ in range(blocks - 1)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
            in_ch = planes * 4

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            if li >= 2:
                outs.append(x)
        return outs


class FPN(nn.Module):
    """reference net.py:68-100."""

    def __init__(self, in_channels: List[int], out_channels: int = 256):
        super().__init__()
        leaky = 0.1 if out_channels <= 64 else 0.0
        self.output1 = conv_bn(in_channels[0], out_channels, 1, leaky=leaky)
        self.output2 = conv_bn(in_channels[1], out_channels, 1, leaky=leaky)
        self.output3 = conv_bn(in_channels[2], out_channels, 1, leaky=leaky)
        self.merge1 = conv_bn(out_channels, out_channels, leaky=leaky)
        self.merge2 = conv_bn(out_channels, out_channels, leaky=leaky)

    def forward(self, feats):
        o1, o2, o3 = (self.output1(feats[0]), self.output2(feats[1]),
                      self.output3(feats[2]))
        o2 = self.merge2(o2 + F.interpolate(o3, size=o2.shape[2:],
                                            mode="nearest"))
        o1 = self.merge1(o1 + F.interpolate(o2, size=o1.shape[2:],
                                            mode="nearest"))
        return [o1, o2, o3]


class SSH(nn.Module):
    """reference net.py:40-66."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        leaky = 0.1 if out_ch <= 64 else 0.0
        self.conv3X3 = conv_bn(in_ch, out_ch // 2, relu=False)
        self.conv5X5_1 = conv_bn(in_ch, out_ch // 4, leaky=leaky)
        self.conv5X5_2 = conv_bn(out_ch // 4, out_ch // 4, relu=False)
        self.conv7X7_2 = conv_bn(out_ch // 4, out_ch // 4, leaky=leaky)
        self.conv7x7_3 = conv_bn(out_ch // 4, out_ch // 4, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5_1 = self.conv5X5_1(x)
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1),
                                 self.conv7x7_3(self.conv7X7_2(c5_1))], 1))


class _Head(nn.Module):
    def __init__(self, in_ch: int, n_out: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(in_ch, n_out, 1)


class RetinaFace(nn.Module):
    """reference facemodels/retinaface.py:48-145 (ResNet50 config): NHWC
    BGR (means subtracted) → (boxes (B, A, 4), class scores after softmax
    (B, A, 2), landmarks (B, A, 10))."""

    def __init__(self, out_channel: int = 256, num_anchors: int = 2):
        super().__init__()
        self.body = ResNet50Body()
        self.fpn = FPN([512, 1024, 2048], out_channel)
        for i in (1, 2, 3):
            setattr(self, f"ssh{i}", SSH(out_channel, out_channel))
        self.ClassHead = nn.ModuleList(_Head(out_channel, num_anchors * 2)
                                       for _ in range(3))
        self.BboxHead = nn.ModuleList(_Head(out_channel, num_anchors * 4)
                                      for _ in range(3))
        self.LandmarkHead = nn.ModuleList(_Head(out_channel, num_anchors * 10)
                                          for _ in range(3))

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2).to(self.body.conv1.weight.dtype)
        fpn = self.fpn(self.body(x))
        feats = [getattr(self, f"ssh{i + 1}")(f) for i, f in enumerate(fpn)]

        def head(heads, n):
            return torch.cat([h.conv1x1(f).permute(0, 2, 3, 1).reshape(
                f.shape[0], -1, n) for h, f in zip(heads, feats)], 1).float()
        return (head(self.BboxHead, 4),
                F.softmax(head(self.ClassHead, 2), dim=-1),
                head(self.LandmarkHead, 10))


def load_retinaface(path: str, map_location="cpu") -> RetinaFace:
    """A RetinaFace-R50 ``.pth`` (tensors only; a ``module.`` prefix
    stripped) in a new model."""
    sd = torch.load(path, map_location=map_location, weights_only=True)
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    model = RetinaFace()
    model.load_state_dict(sd)
    return model.eval()


# ----------------------------------------------------------------------------
# anchors / decode / NMS (host-side numpy; reference prior_box.py +
# box_utils.py; copies of the JAX package's)
# ----------------------------------------------------------------------------

def prior_box(image_size: Tuple[int, int], cfg: dict = CFG_RE50) -> np.ndarray:
    anchors = []
    fmaps = [[math.ceil(image_size[0] / s), math.ceil(image_size[1] / s)]
             for s in cfg["steps"]]
    for k, f in enumerate(fmaps):
        for i, j in product(range(f[0]), range(f[1])):
            for min_size in cfg["min_sizes"][k]:
                s_kx = min_size / image_size[1]
                s_ky = min_size / image_size[0]
                cx = (j + 0.5) * cfg["steps"][k] / image_size[1]
                cy = (i + 0.5) * cfg["steps"][k] / image_size[0]
                anchors.append([cx, cy, s_kx, s_ky])
    out = np.asarray(anchors, np.float32)
    if cfg["clip"]:
        out = np.clip(out, 0, 1)
    return out


def decode_boxes(loc: np.ndarray, priors: np.ndarray, variances) -> np.ndarray:
    boxes = np.concatenate([
        priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:],
        priors[:, 2:] * np.exp(loc[:, 2:] * variances[1])], axis=1)
    boxes[:, :2] -= boxes[:, 2:] / 2
    boxes[:, 2:] += boxes[:, :2]
    return boxes


def decode_landms(pre: np.ndarray, priors: np.ndarray, variances) -> np.ndarray:
    return np.concatenate(
        [priors[:, :2] + pre[:, 2 * i: 2 * i + 2] * variances[0] * priors[:, 2:]
         for i in range(5)], axis=1)


def nms(dets: np.ndarray, thresh: float) -> List[int]:
    """reference py_cpu_nms.py:10-38."""
    x1, y1, x2, y2, scores = (dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3],
                              dets[:, 4])
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= thresh]
    return keep


def detect_faces(apply_fn: Callable, img_bgr_float: np.ndarray,
                 cfg: dict = CFG_RE50, confidence_threshold: float = 0.9,
                 nms_threshold: float = 0.4, top_k: int = 5000,
                 keep_top_k: int = 750):
    """Detection (reference retinaface_detection.py:63-139): subtract the
    (104, 117, 123) BGR means, forward, decode, filter, NMS. ``apply_fn``:
    NHWC float32 numpy batch → (boxes, scores, landmarks), numpy or
    tensors."""
    h, w = img_bgr_float.shape[:2]
    x = img_bgr_float - np.array([104.0, 117.0, 123.0], np.float32)
    loc, conf, landms = apply_fn(x[None].astype(np.float32))
    loc, conf, landms = (np.asarray(t.detach().cpu() if hasattr(t, "detach")
                                    else t)[0] for t in (loc, conf, landms))
    priors = prior_box((h, w), cfg)
    boxes = decode_boxes(loc, priors, cfg["variance"]) * \
        np.array([w, h, w, h], np.float32)
    lms = decode_landms(landms, priors, cfg["variance"]) * \
        np.array([w, h] * 5, np.float32)
    scores = conf[:, 1]
    inds = scores > confidence_threshold
    boxes, lms, scores = boxes[inds], lms[inds], scores[inds]
    order = scores.argsort()[::-1][:top_k]
    boxes, lms, scores = boxes[order], lms[order], scores[order]
    dets = np.hstack([boxes, scores[:, None]]).astype(np.float32)
    keep = nms(dets, nms_threshold)
    return dets[keep][:keep_top_k], lms[keep][:keep_top_k]
