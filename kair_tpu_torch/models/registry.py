"""Network registry: opt['netG'] → torch module (counterpart of
``kair_tpu/models/registry.py``; reference models/select_network.py:16-274).

Keyed by the same ``net_type`` strings and hyper-parameter keys as the
reference option files. This slice of the port builds SwinIR; every other
network raises NotImplementedError naming the slice that brings it.
"""

from __future__ import annotations

import torch.nn as nn

LATER_SLICES = {
    "dncnn": "CNN zoo", "fdncnn": "CNN zoo", "ircnn": "CNN zoo",
    "ffdnet": "CNN zoo", "srmd": "CNN zoo", "dpsr": "CNN zoo",
    "msrresnet0": "CNN zoo", "msrresnet1": "CNN zoo", "rrdb": "CNN zoo",
    "rrdbnet": "CNN zoo", "rrdbnet_no_up": "CNN zoo", "imdn": "CNN zoo",
    "drunet": "CNN zoo", "usrnet": "CNN zoo",
    "vrt": "video", "rvrt": "video", "spynet": "video",
}


def _get(o, key, default=None):
    v = o.get(key)
    return default if v is None else v


def define_g(opt: dict) -> nn.Module:
    """Build the generator (f32 parameters) from a parsed option tree
    (reference select_network.py:16-274)."""
    o = opt["netG"]
    t = o["net_type"]
    if t == "swinir":
        from kair_tpu_torch.models.swinir import SwinIR
        # fuse_block absent or true: the fused block kernels (KAIR's own
        # option files carry no such key); false: the unfused route, whose
        # attention always runs its kernel on the card, so use_pallas, the
        # JAX switch for that kernel, is accepted and needs no effect here
        return SwinIR(
            img_size=_get(o, "img_size", 64),
            in_chans=_get(o, "in_nc", 3),
            embed_dim=_get(o, "embed_dim", 96),
            depths=tuple(_get(o, "depths", [6, 6, 6, 6])),
            num_heads=tuple(_get(o, "num_heads", [6, 6, 6, 6])),
            window_size=_get(o, "window_size", 7),
            mlp_ratio=_get(o, "mlp_ratio", 4.0),
            upscale=_get(o, "upscale", 1),
            img_range=_get(o, "img_range", 1.0),
            upsampler=_get(o, "upsampler", ""),
            resi_connection=_get(o, "resi_connection", "1conv"),
            use_checkpoint=bool(_get(o, "use_checkpoint", False)),
            fuse_block=bool(_get(o, "fuse_block", True)))
    if t in LATER_SLICES:
        raise NotImplementedError(
            f"netG [{t}] belongs to the {LATER_SLICES[t]} slice of the port, "
            "not ported yet")
    raise NotImplementedError(f"netG [{t}] is not implemented yet")
