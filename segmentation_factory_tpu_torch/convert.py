"""JAX variables -> the port's ``state_dict``.

Inverse of ``segmentation_factory_tpu/convert.py``'s converters, which map
the reference ``state_dict`` to the JAX tree: ``convert_mit`` (:56-95),
``convert_segformer_head`` (:98-124), ``convert_convnext`` (:139-170),
``convert_uperhead`` (:188-218), ``convert_fpnhead`` (:1005-1027) and
``convert_mobilenetv4`` (:1111-1166), as ``convert_full_model`` (:545-575)
composes them, and ``convert_msdeformattn`` /
``convert_deformable_encoder_layer`` (:795-814) inside the Mask2Former
head, whose other names have no JAX converter (``pixel_decoder_tree``,
``masked_decoder_tree``). The port's keys are the reference's, so a reference
``.pth`` loads as it is and this function carries JAX weights
(``{"params", "batch_stats"}`` as numpy arrays) across:

- Dense kernel (in, out) -> Linear weight (out, in);
- Conv kernel (kh, kw, in, out) -> (out, in, kh, kw);
- depthwise kernel (3, 3, 1, HC) -> (HC, 1, 3, 3);
- the classifier Dense (E, NC) -> the 1x1 conv ``linear_pred`` (NC, E, 1, 1);
- BatchNorm ``batch_stats`` mean/var -> running_mean/running_var (the
  backbone's under ``batch_stats["backbone"]``, the head's under
  ``batch_stats["decode_head"]``);
- a ``ConvModule`` (``Conv_0`` + ``BatchNorm_0/BatchNorm_0``) -> a conv and a
  BatchNorm under the reference's names for them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(sd, key, p) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{key}.bias"] = _t(p["bias"])


def _conv(sd, key, p) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _ln(sd, key, p) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _mit(sd, bb: Mapping) -> None:
    for i in range(1, 5):
        pe = bb[f"patch_embed{i}"]
        _conv(sd, f"backbone.patch_embed{i}.proj", pe["Conv_0"])
        _ln(sd, f"backbone.patch_embed{i}.norm", pe["LayerNorm_0"])
        j = 0
        while f"block{i}_{j}" in bb:
            blk, r = bb[f"block{i}_{j}"], f"backbone.block{i}.{j}"
            _ln(sd, f"{r}.norm1", blk["norm1"])
            _ln(sd, f"{r}.norm2", blk["norm2"])
            attn = blk["SRAttention_0"]
            for name in ("q", "kv", "proj"):
                _linear(sd, f"{r}.attn.{name}", attn[name])
            if "sr" in attn:
                _conv(sd, f"{r}.attn.sr", attn["sr"])
                _ln(sd, f"{r}.attn.norm", attn["sr_norm"])
            mix = blk["MixFFN_0"]
            _linear(sd, f"{r}.mlp.fc1", mix["fc1"])
            _linear(sd, f"{r}.mlp.fc2", mix["fc2"])
            _conv(sd, f"{r}.mlp.dwconv.dwconv", mix["dwconv"])
            j += 1
        _ln(sd, f"backbone.norm{i}", bb[f"norm{i}"])


def _bn(sd, key, p, stats) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(stats["mean"])
    sd[f"{key}.running_var"] = _t(stats["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv_module(sd, p: Mapping, s: Mapping, conv_key: str, bn_key: str) -> None:
    """A JAX ``ConvModule``'s params ``p`` and stats ``s`` -> ``conv_key`` and
    ``bn_key``."""
    _conv(sd, conv_key, p["Conv_0"])
    _bn(sd, bn_key, p["BatchNorm_0"]["BatchNorm_0"], s["BatchNorm_0"]["BatchNorm_0"])


def _convnext(sd, bb: Mapping) -> None:
    r = "backbone.downsample_layers"
    _conv(sd, f"{r}.0.0", bb["stem"])
    _ln(sd, f"{r}.0.1", bb["stem_norm"])
    for i in range(1, 4):
        _ln(sd, f"{r}.{i}.0", bb[f"down_norm{i}"])
        _conv(sd, f"{r}.{i}.1", bb[f"down{i}"])
    for i in range(4):
        j = 0
        while f"block{i}_{j}" in bb:
            blk, key = bb[f"block{i}_{j}"], f"backbone.stages.{i}.{j}"
            _conv(sd, f"{key}.dwconv", blk["dwconv"])
            _ln(sd, f"{key}.norm", blk["norm"])
            _linear(sd, f"{key}.pwconv1", blk["pwconv1"])
            _linear(sd, f"{key}.pwconv2", blk["pwconv2"])
            sd[f"{key}.gamma"] = _t(blk["gamma"])
            j += 1
        _ln(sd, f"backbone.norm{i}", bb[f"out_norm{i}"])


_UIB = (("start_dw", "dw_start"), ("expand", "pw_exp"), ("middle_dw", "dw_mid"),
        ("project", "pw_proj"))


def _mobilenetv4(sd, bb: Mapping, bs: Mapping) -> None:
    _conv_module(sd, bb["conv0_0"], bs["conv0_0"], "backbone.conv_stem", "backbone.bn1")
    for s in range(4):
        j = 0
        while f"layer{s + 1}_{j}" in bb:
            name, key = f"layer{s + 1}_{j}", f"backbone.blocks.{s}.{j}"
            p, st = bb[name], bs[name]
            if "Conv_0" in p:  # convbn
                _conv_module(sd, p, st, f"{key}.conv", f"{key}.bn1")
            elif "ConvModule_0" in p:  # FusedIB
                _conv_module(sd, p["ConvModule_0"], st["ConvModule_0"], f"{key}.conv_exp",
                             f"{key}.bn1")
                _conv_module(sd, p["ConvModule_1"], st["ConvModule_1"], f"{key}.conv_pwl",
                             f"{key}.bn2")
            else:  # UIB
                if "layer_scale" in p:
                    raise NotImplementedError("MobileNetV4's hybrid variants are not ported")
                for jax_name, ref in _UIB:
                    if jax_name in p:
                        _conv_module(sd, p[jax_name], st[jax_name], f"{key}.{ref}.conv",
                                     f"{key}.{ref}.bn")
            j += 1


def _classifier(sd, key, p) -> None:
    """A float32 Dense classifier (E, NC) -> the 1x1 conv (NC, E, 1, 1)."""
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None, None])
    sd[f"{key}.bias"] = _t(p["bias"])


def _uperhead(sd, hp: Mapping, hs: Mapping) -> None:
    r = "decode_head"
    ppm_p, ppm_s = hp["ppm"], hs["ppm"]
    n = sum(k.startswith("ConvModule_") for k in ppm_p) - 1  # the scales, then the bottleneck
    for k in range(n + 1):
        key = f"{r}.ppm.stages.{k}.1" if k < n else f"{r}.ppm.bottleneck"
        _conv_module(sd, ppm_p[f"ConvModule_{k}"], ppm_s[f"ConvModule_{k}"], f"{key}.0",
                     f"{key}.1")
    i = 0
    while f"lateral{i}" in hp:
        for jax_name, ref in ((f"lateral{i}", f"fpn_in.{i}"), (f"fpn{i}", f"fpn_out.{i}")):
            _conv_module(sd, hp[jax_name], hs[jax_name], f"{r}.{ref}.0", f"{r}.{ref}.1")
        i += 1
    _conv_module(sd, hp["bottleneck"], hs["bottleneck"], f"{r}.bottleneck.0",
                 f"{r}.bottleneck.1")
    _classifier(sd, f"{r}.conv_seg", hp["conv_seg"])


def _fpnhead(sd, hp: Mapping, hs: Mapping) -> None:
    r = "decode_head"
    i = 0
    while f"lateral{i}" in hp:
        _conv_module(sd, hp[f"lateral{i}"], hs[f"lateral{i}"], f"{r}.lateral_convs.{i}.0",
                     f"{r}.lateral_convs.{i}.1")
        if i:
            _conv_module(sd, hp[f"smooth{i}"], hs[f"smooth{i}"], f"{r}.output_convs.{i}.0",
                         f"{r}.output_convs.{i}.1")
        i += 1
    _classifier(sd, f"{r}.conv_seg", hp["conv_seg"])


def _segformer_head(sd, hp: Mapping, hs: Mapping) -> None:
    i = 1
    while f"linear_c{i}" in hp:
        _linear(sd, f"decode_head.linear_c{i}.proj", hp[f"linear_c{i}"])
        i += 1
    fuse = hp["linear_fuse"]
    _conv(sd, "decode_head.linear_fuse.conv", fuse["Conv_0"])
    _bn(sd, "decode_head.linear_fuse.bn", fuse["BatchNorm_0"]["BatchNorm_0"],
        hs["linear_fuse"]["BatchNorm_0"]["BatchNorm_0"])
    _classifier(sd, "decode_head.linear_pred", hp["linear_pred"])


def pixel_decoder_tree(sd, pd: Mapping, r: str) -> None:
    """A JAX ``MSDeformAttnPixelDecoder``'s params -> the port's names under
    ``r`` (``models/layers/msdeformattn.py``). flax names its GroupNorms in
    creation order: the input projections' first, then the laterals'."""
    sd[f"{r}level_embed"] = _t(pd["level_embed"])
    n_top = pd["level_embed"].shape[0]
    for i in range(n_top):
        _conv(sd, f"{r}input_proj.{i}.0", pd[f"input_proj{i}"])
        _ln(sd, f"{r}input_proj.{i}.1", pd[f"GroupNorm_{i}"])
    i = 0
    while f"encoder{i}" in pd:
        encoder_layer_tree(sd, pd[f"encoder{i}"], f"{r}encoder.{i}.")
        i += 1
    j = 0
    while f"lateral{j}" in pd:
        _conv(sd, f"{r}lateral_convs.{j}.0", pd[f"lateral{j}"])
        _ln(sd, f"{r}lateral_convs.{j}.1", pd[f"GroupNorm_{n_top + j}"])
        out = pd[f"output_conv{j}"]
        _conv(sd, f"{r}output_convs.{j}.0", out["Conv_0"])
        _ln(sd, f"{r}output_convs.{j}.1", out["GroupNorm_0"]["GroupNorm_0"])
        j += 1
    _conv(sd, f"{r}mask_features", pd["mask_features"])


def msdeformattn_tree(sd, p: Mapping, r: str) -> None:
    """A JAX ``MSDeformAttn``'s params -> the reference's names under ``r``."""
    for name in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
        _linear(sd, f"{r}{name}", p[name])


def encoder_layer_tree(sd, p: Mapping, r: str) -> None:
    """A JAX ``DeformableEncoderLayer``'s params -> the reference's names
    under ``r`` (the inverse of ``convert_deformable_encoder_layer``)."""
    msdeformattn_tree(sd, p["MSDeformAttn_0"], f"{r}self_attn.")
    _ln(sd, f"{r}norm1", p["LayerNorm_0"])
    _linear(sd, f"{r}linear1", p["Dense_0"])
    _linear(sd, f"{r}linear2", p["Dense_1"])
    _ln(sd, f"{r}norm2", p["LayerNorm_1"])


def masked_decoder_tree(sd, td: Mapping, r: str) -> None:
    """A JAX ``MultiScaleMaskedTransformerDecoder``'s params -> the port's
    names under ``r`` (``models/layers/mask_decoders.py``)."""
    for name in ("level_embed", "query_feat", "query_embed"):
        sd[f"{r}{name}"] = _t(td[name])
    _ln(sd, f"{r}decoder_norm", td["decoder_norm"])
    _linear(sd, f"{r}class_embed", td["class_embed"])
    k = 0
    while f"Dense_{k}" in td["mask_embed"]:
        _linear(sd, f"{r}mask_embed.layers.{k}", td["mask_embed"][f"Dense_{k}"])
        k += 1
    i = 0
    while f"layer{i}" in td:
        lay, key = td[f"layer{i}"], f"{r}layers.{i}"
        for attn in ("cross_attn", "self_attn"):
            for name in ("q", "k", "v", "proj"):
                _linear(sd, f"{key}.{attn}.{name}", lay[attn][name])
        for n in range(3):
            _ln(sd, f"{key}.norm{n + 1}", lay[f"LayerNorm_{n}"])
        _linear(sd, f"{key}.linear1", lay["Dense_0"])
        _linear(sd, f"{key}.linear2", lay["Dense_1"])
        i += 1


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a JAX ``SegmentationModel`` (arrays,
    numpy or JAX) of MiT, ConvNeXt or MobileNetV4 (conv variants) with
    SegFormerHead, UPerHead, FPNHead or Mask2FormerHead -> the port's ``state_dict`` (float32
    CPU tensors). The family is read from the tree's names."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    bb, hp, hs = params["backbone"], params["decode_head"], stats.get("decode_head", {})
    sd: Dict[str, torch.Tensor] = {}
    if "patch_embed1" in bb:
        _mit(sd, bb)
    elif "stem" in bb:
        _convnext(sd, bb)
    elif "conv0_0" in bb:
        _mobilenetv4(sd, bb, stats["backbone"])
    else:
        raise NotImplementedError(f"no converter of this backbone is ported: {sorted(bb)[:4]}")
    if "linear_fuse" in hp:
        _segformer_head(sd, hp, hs)
    elif "ppm" in hp:
        _uperhead(sd, hp, hs)
    elif "smooth1" in hp:
        _fpnhead(sd, hp, hs)
    elif "pixel_decoder" in hp:  # Mask2FormerHead: no batch statistics
        pixel_decoder_tree(sd, hp["pixel_decoder"], "decode_head.pixel_decoder.")
        masked_decoder_tree(sd, hp["transformer_decoder"], "decode_head.transformer_decoder.")
    else:
        raise NotImplementedError(f"no converter of this head is ported: {sorted(hp)[:4]}")
    return sd
