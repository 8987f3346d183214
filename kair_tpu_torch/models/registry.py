"""Network registry: opt['netG'] → torch module (counterpart of
``kair_tpu/models/registry.py``; reference models/select_network.py:16-274).

Keyed by the same ``net_type`` strings and hyper-parameter keys as the
reference option files. The port builds the CNN zoo, SwinIR, VRT and RVRT;
SpyNet alone raises NotImplementedError naming the slice that brings it.
"""

from __future__ import annotations

import torch.nn as nn

LATER_SLICES = {"spynet": "video", "discriminator_patchgan": "GAN",
                "discriminator_unet": "GAN", "discriminator_vgg_96": "GAN",
                "discriminator_vgg_128": "GAN", "discriminator_vgg_192": "GAN"}


def _get(o, key, default=None):
    v = o.get(key)
    return default if v is None else v


def define_g(opt: dict) -> nn.Module:
    """Build the generator (f32 parameters) from a parsed option tree
    (reference select_network.py:16-274)."""
    o = opt["netG"]
    t = o["net_type"]
    if t == "dncnn":
        from kair_tpu_torch.models.dncnn import DnCNN
        return DnCNN(_get(o, "in_nc", 1), _get(o, "out_nc", 1),
                     _get(o, "nc", 64), _get(o, "nb", 17),
                     _get(o, "act_mode", "BR"))
    if t == "fdncnn":
        from kair_tpu_torch.models.dncnn import FDnCNN
        return FDnCNN(_get(o, "in_nc", 2), _get(o, "out_nc", 1),
                      _get(o, "nc", 64), _get(o, "nb", 20),
                      _get(o, "act_mode", "R"))
    if t == "ircnn":
        from kair_tpu_torch.models.dncnn import IRCNN
        return IRCNN(_get(o, "in_nc", 1), _get(o, "out_nc", 1),
                     _get(o, "nc", 64))
    if t == "ffdnet":
        from kair_tpu_torch.models.ffdnet import FFDNet
        return FFDNet(_get(o, "in_nc", 1), _get(o, "out_nc", 1),
                      _get(o, "nc", 64), _get(o, "nb", 15),
                      _get(o, "act_mode", "R"))
    if t == "srmd":
        from kair_tpu_torch.models.srresnet import SRMD
        return SRMD(_get(o, "in_nc", 19), _get(o, "out_nc", 3),
                    _get(o, "nc", 128), _get(o, "nb", 12), _get(o, "scale", 4),
                    _get(o, "act_mode", "R"),
                    _get(o, "upsample_mode", "pixelshuffle"))
    if t in ("dpsr", "msrresnet0"):
        from kair_tpu_torch.models.srresnet import MSRResNet0
        dpsr = t == "dpsr"
        return MSRResNet0(_get(o, "in_nc", 4 if dpsr else 3),
                          _get(o, "out_nc", 3), _get(o, "nc", 96 if dpsr else 64),
                          _get(o, "nb", 16), _get(o, "scale", 4),
                          _get(o, "act_mode", "R"),
                          _get(o, "upsample_mode",
                               "pixelshuffle" if dpsr else "upconv"))
    if t == "msrresnet1":
        from kair_tpu_torch.models.srresnet import MSRResNet1
        return MSRResNet1(_get(o, "in_nc", 3), _get(o, "out_nc", 3),
                          _get(o, "nc", 64), _get(o, "nb", 16),
                          _get(o, "scale", 4))
    if t == "rrdb":
        from kair_tpu_torch.models.rrdbnet import RRDB
        return RRDB(_get(o, "in_nc", 3), _get(o, "out_nc", 3),
                    _get(o, "nc", 64), _get(o, "nb", 23), _get(o, "gc", 32),
                    _get(o, "scale", 4), _get(o, "act_mode", "L"),
                    _get(o, "upsample_mode", "upconv"))
    if t == "rrdbnet":
        from kair_tpu_torch.models.rrdbnet import RRDBNet
        return RRDBNet(_get(o, "in_nc", 3), _get(o, "out_nc", 3),
                       _get(o, "nf", 64), _get(o, "nb", 23), _get(o, "gc", 32),
                       _get(o, "sf", 4))
    if t == "rrdbnet_no_up":
        from kair_tpu_torch.models.rrdbnet import RRDBNetNoUp
        return RRDBNetNoUp(_get(o, "in_nc", 3), _get(o, "out_nc", 3),
                           _get(o, "nf", 64), _get(o, "nb", 23),
                           _get(o, "gc", 32))
    if t == "imdn":
        from kair_tpu_torch.models.imdn import IMDN
        return IMDN(_get(o, "in_nc", 3), _get(o, "out_nc", 3),
                    _get(o, "nc", 64), _get(o, "nb", 8), _get(o, "scale", 4),
                    _get(o, "act_mode", "L"),
                    _get(o, "upsample_mode", "pixelshuffle"))
    if t == "drunet":
        from kair_tpu_torch.models.drunet import UNetRes
        return UNetRes(_get(o, "in_nc", 3), _get(o, "out_nc", 3),
                       tuple(_get(o, "nc", [64, 128, 256, 512])),
                       _get(o, "nb", 4), _get(o, "act_mode", "R"),
                       _get(o, "downsample_mode", "strideconv"),
                       _get(o, "upsample_mode", "convtranspose"),
                       _get(o, "bias", True))
    if t == "usrnet":
        from kair_tpu_torch.models.usrnet import USRNet
        return USRNet(_get(o, "n_iter", 8), _get(o, "h_nc", 64),
                      _get(o, "in_nc", 4), _get(o, "out_nc", 3),
                      tuple(_get(o, "nc", [64, 128, 256, 512])),
                      _get(o, "nb", 2), _get(o, "act_mode", "R"),
                      _get(o, "downsample_mode", "strideconv"),
                      _get(o, "upsample_mode", "convtranspose"))
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
    if t == "vrt":
        from kair_tpu_torch.models.vrt import VRT
        # fuse_block absent or true: the TMSA and self block kernels;
        # deform_impl absent: "auto", the DCN kernel on the card;
        # use_checkpoint_attn: recompute the block pairs in training (the
        # JAX package's remat; use_checkpoint_ffn is not read there either)
        depths = tuple(_get(o, "depths", [8] * 7 + [4] * 6))
        return VRT(upscale=_get(o, "upscale", 4),
                   in_chans=_get(o, "in_nc", 3), out_chans=_get(o, "out_nc", 3),
                   img_size=tuple(_get(o, "img_size", [6, 64, 64])),
                   window_size=tuple(_get(o, "window_size", [6, 8, 8])),
                   depths=depths,
                   indep_reconsts=o.get("indep_reconsts"),
                   embed_dims=tuple(_get(o, "embed_dims",
                                         [120] * 7 + [180] * 6)),
                   num_heads=tuple(_get(o, "num_heads", [6] * len(depths))),
                   pa_frames=_get(o, "pa_frames", 2),
                   deformable_groups=_get(o, "deformable_groups", 16),
                   nonblind_denoising=bool(_get(o, "nonblind_denoising",
                                                False)),
                   fuse_block=bool(_get(o, "fuse_block", True)),
                   deform_impl=_get(o, "deform_impl", "auto"),
                   remat=bool(_get(o, "use_checkpoint_attn", False)))
    if t == "rvrt":
        from kair_tpu_torch.models.rvrt import RVRT
        # as for VRT: fuse_block absent or true, the STL block kernels;
        # deform_impl absent, "auto" (the GDA kernel on the card);
        # use_checkpoint_attn, the STL block pairs recomputed in training
        return RVRT(upscale=_get(o, "upscale", 4),
                    clip_size=_get(o, "clip_size", 2),
                    window_size=tuple(_get(o, "window_size", [2, 8, 8])),
                    num_blocks=tuple(_get(o, "num_blocks", [1, 2, 1])),
                    depths=tuple(_get(o, "depths", [2, 2, 2])),
                    embed_dims=tuple(_get(o, "embed_dims", [144, 144, 144])),
                    num_heads=tuple(_get(o, "num_heads", [6, 6, 6])),
                    inputconv_groups=tuple(_get(o, "inputconv_groups",
                                                [1] * 6)),
                    deformable_groups=_get(o, "deformable_groups", 12),
                    attention_heads=_get(o, "attention_heads", 12),
                    attention_window=tuple(_get(o, "attention_window", [3, 3])),
                    nonblind_denoising=bool(_get(o, "nonblind_denoising",
                                                 False)),
                    fuse_block=bool(_get(o, "fuse_block", True)),
                    deform_impl=_get(o, "deform_impl", "auto"),
                    remat=bool(_get(o, "use_checkpoint_attn", False)))
    if t in LATER_SLICES:
        raise NotImplementedError(
            f"netG [{t}] belongs to the {LATER_SLICES[t]} slice of the port, "
            "not ported yet")
    raise NotImplementedError(f"netG [{t}] is not implemented yet")
