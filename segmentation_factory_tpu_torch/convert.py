"""JAX variables -> the port's ``state_dict``.

Inverse of ``segmentation_factory_tpu/convert.py``'s converters, which map
the reference ``state_dict`` to the JAX tree: ``convert_mit`` (:56-95),
``convert_segformer_head`` (:98-124), ``convert_convnext`` (:139-170),
``convert_uperhead`` (:188-218), ``convert_fpnhead`` (:1005-1027),
``convert_mobilenetv4`` (:1111-1166), ``convert_convnextv2`` (:173-186),
``convert_resnet`` (:817-841), ``convert_deeplabv3`` (:974-1002),
``convert_convformer`` (:393-445), ``convert_poolformer_like``
(:448-482), ``convert_efficientvit_b`` / ``_l`` (:311-386),
``convert_efficientvitseg`` (:1029-1093), ``convert_mobilenetv2``
(:578-624), ``convert_casvit`` (:630-711), ``convert_crossformer``
(:485-530), ``convert_iformer`` (:712-771) and ``convert_kat``
(:1168-1252), as ``convert_full_model``
(:545-575) composes them, and
``convert_msdeformattn`` /
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
- RandomMixing's ``constants`` ``mix`` -> the buffer
  ``token_mixer.random_matrix`` (no JAX converter names it);
- GRN's (C,) gamma / beta -> the reference's (1, 1, 1, C);
- a ``ConvModule`` (``Conv_0`` + ``BatchNorm_0/BatchNorm_0``) -> a conv and a
  BatchNorm under the reference's names for them;
- LiteMLA's qkv and aggregation kernels, whose output channels the JAX
  package holds as [all q | all k | all v], -> the reference's per-head
  [q | k | v] blocks (the inverse of ``_litemla_perm``, :272-284);
- flax ``MultiHeadDotProductAttention``'s per-head ``query`` / ``key`` /
  ``value`` kernels (D, heads, d) -> KAT's fused ``qkv`` (3D, D), its
  ``out`` kernel (heads, d, D) -> ``proj`` (the inverse of ``convert_kat``);
- flax ``ConvTranspose`` kernels (kh, kw, in, out) -> torch's (in, out, kh,
  kw), spatially flipped (flax correlates the dilated input with the
  kernel as it is, ``F.conv_transpose2d`` with it flipped);
- iFormer's ``RepDWBlock`` and KAT's pyramid adapter, which no JAX
  converter names, -> the JAX names under the reference's keys.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(sd, key, p) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
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
            if "grn" in blk:  # ConvNeXtV2
                for name in ("gamma", "beta"):
                    sd[f"{key}.grn.{name}"] = _t(np.asarray(blk["grn"][name]).reshape(1, 1, 1, -1))
            else:
                sd[f"{key}.gamma"] = _t(blk["gamma"])
            j += 1
        _ln(sd, f"backbone.norm{i}", bb[f"out_norm{i}"])


def _scale(sd, key, p) -> None:
    """A scale-only norm -> its ``weight``."""
    sd[f"{key}.weight"] = _t(p["scale"])


def _star(sd, key, p) -> None:
    sd[f"{key}.scale"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _metaformer(sd, bb: Mapping, consts: Mapping) -> None:
    r = "backbone.downsample_layers"
    _conv(sd, f"{r}.0.conv", bb["stem"])
    _scale(sd, f"{r}.0.post_norm", bb["stem_norm"])
    for i in range(1, 4):
        _scale(sd, f"{r}.{i}.pre_norm", bb[f"down_norm{i}"])
        _conv(sd, f"{r}.{i}.conv", bb[f"down{i}"])
    for i in range(4):
        j = 0
        while f"block{i}_{j}" in bb:
            name, key = f"block{i}_{j}", f"backbone.stages.{i}.{j}"
            blk = bb[name]
            _scale(sd, f"{key}.norm1", blk["norm1"])
            _scale(sd, f"{key}.norm2", blk["norm2"])
            _linear(sd, f"{key}.mlp.fc1", blk["Dense_0"])
            _star(sd, f"{key}.mlp.act", blk["mlp_act"])
            _linear(sd, f"{key}.mlp.fc2", blk["Dense_1"])
            for k in (1, 2):
                if f"res_scale{k}" in blk:
                    sd[f"{key}.res_scale{k}.scale"] = _t(blk[f"res_scale{k}"])
            mixer, mk = blk.get("token_mixer", {}), f"{key}.token_mixer"
            if "pw1" in mixer:  # SepConv
                _linear(sd, f"{mk}.pwconv1", mixer["pw1"])
                _star(sd, f"{mk}.act1", mixer["act1"])
                _conv(sd, f"{mk}.dwconv", mixer["dw"])
                _linear(sd, f"{mk}.pwconv2", mixer["pw2"])
            elif "Dense_0" in mixer:  # VanillaAttention
                _linear(sd, f"{mk}.qkv", mixer["Dense_0"])
                _linear(sd, f"{mk}.proj", mixer["Dense_1"])
            mix = consts.get(name, {}).get("token_mixer", {}).get("mix")
            if mix is not None:  # RandomMixing
                sd[f"{mk}.random_matrix"] = _t(mix)
            j += 1


def _resnet(sd, bb: Mapping, bs: Mapping) -> None:
    _conv_module(sd, bb["stem"], bs["stem"], "backbone.conv1", "backbone.bn1")
    i = 1
    while f"layer{i}_0" in bb:
        j = 0
        while f"layer{i}_{j}" in bb:
            name, key = f"layer{i}_{j}", f"backbone.layer{i}.{j}"
            p, st = bb[name], bs[name]
            for k in range(3):
                _conv_module(sd, p[f"ConvModule_{k}"], st[f"ConvModule_{k}"],
                             f"{key}.conv{k + 1}", f"{key}.bn{k + 1}")
            if "downsample" in p:
                _conv_module(sd, p["downsample"], st["downsample"], f"{key}.downsample.0",
                             f"{key}.downsample.1")
            j += 1
        i += 1


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


def _evit_convlayer(sd, key, p: Mapping, s: Mapping) -> None:
    """A JAX ``ConvModule`` -> the reference's ConvLayer ``{conv, norm}``
    (no norm where the module has none)."""
    _conv(sd, f"{key}.conv", p["Conv_0"])
    if "BatchNorm_0" in p:
        _bn(sd, f"{key}.norm", p["BatchNorm_0"]["BatchNorm_0"], s["BatchNorm_0"]["BatchNorm_0"])


def _evit_convs(sd, key, p: Mapping, s: Mapping) -> None:
    """A DSConv / MBConv / FusedMBConv / ResBlock: each of its ConvModules."""
    for name, sub in p.items():
        _evit_convlayer(sd, f"{key}.{name}", sub, s.get(name, {}))


def _evit_block(sd, key, p: Mapping, s: Mapping) -> None:
    """A residual conv block (under ``main``) or an attention block: LiteMLA
    under ``context_module.main``, its MBConv under ``local_module.main``.
    The head dim is the aggregation's group width (its pointwise kernel's
    third axis)."""
    if "context" not in p:
        _evit_convs(sd, f"{key}.main", p, s)
        return
    ctx, r = p["context"], f"{key}.context_module.main"
    d = np.asarray(ctx["aggreg5_pw"]["kernel"]).shape[2]
    t = np.asarray(ctx["qkv"]["kernel"]).shape[-1] // 3
    heads = t // d
    # jax[..., i] = ref[..., perm[i]] (JAX convert.py:272-284), so ref = jax[..., argsort(perm)]
    perm = np.asarray([h * 3 * d + part * d + j for part in range(3) for h in range(heads)
                       for j in range(d)])
    inv = np.argsort(perm)
    for name, ref in (("qkv", "qkv.conv"), ("aggreg5_dw", "aggreg.0.0"),
                      ("aggreg5_pw", "aggreg.0.1")):
        _conv(sd, f"{r}.{ref}", {"kernel": np.asarray(ctx[name]["kernel"])[..., inv]})
    _evit_convlayer(sd, f"{r}.proj", ctx["proj"], s["context"]["proj"])
    _evit_convs(sd, f"{key}.local_module.main", p["local"], s.get("local", {}))


def _efficientvit(sd, bb: Mapping, bs: Mapping) -> None:
    """The b-series (``stem_0`` a DSConv: ``input_stem`` + ``stages.0-3``)
    or the L-series (``stem_0`` a ResBlock: ``stages.0-4``)."""
    large = "conv1" in bb.get("stem_0", {})
    r = "backbone.stages.0" if large else "backbone.input_stem"
    _evit_convlayer(sd, f"{r}.op_list.0", bb["stem_conv"], bs["stem_conv"])
    i = 0
    while f"stem_{i}" in bb:
        _evit_convs(sd, f"{r}.op_list.{i + 1}.main", bb[f"stem_{i}"], bs.get(f"stem_{i}", {}))
        i += 1
    for st in range(1, 5):
        r = f"backbone.stages.{st if large else st - 1}.op_list"
        first = 0
        if f"stage{st}_down" in bb:
            _evit_convs(sd, f"{r}.0.main", bb[f"stage{st}_down"], bs.get(f"stage{st}_down", {}))
            first = 1
        j = 0
        while f"stage{st}_{j}" in bb:
            name = f"stage{st}_{j}"
            _evit_block(sd, f"{r}.{j + first}", bb[name], bs.get(name, {}))
            j += 1


def _evit_seg_head(sd, hp: Mapping, hs: Mapping) -> None:
    r = "decode_head"
    for i in range(3):
        key = f"{r}.input_ops.{2 - i}" + ("" if i == 0 else ".op_list.0")
        _evit_convlayer(sd, key, hp[f"input{i}"], hs[f"input{i}"])
    j = 0
    while f"middle{j}" in hp:
        _evit_convs(sd, f"{r}.middle.op_list.{j}.main", hp[f"middle{j}"], hs[f"middle{j}"])
        j += 1
    out = f"{r}.output_ops.0.op_list"
    k = 0
    if "final_expand" in hp:
        _evit_convlayer(sd, f"{out}.0", hp["final_expand"], hs["final_expand"])
        k = 1
    _classifier(sd, f"{out}.{k}.conv", hp["conv_seg"])


def _mobilenet(sd, bb: Mapping, bs: Mapping) -> None:
    _conv_module(sd, bb["ConvModule_0"], bs["ConvModule_0"], "backbone.features.0.0",
                 "backbone.features.0.1")
    i = 1
    while f"block{i}" in bb:
        p, st, key = bb[f"block{i}"], bs[f"block{i}"], f"backbone.features.{i}"
        n = sum(k.startswith("ConvModule_") for k in p) - 1  # the last one is the projection
        for k in range(n):
            _conv_module(sd, p[f"ConvModule_{k}"], st[f"ConvModule_{k}"], f"{key}.conv.{k}.0",
                         f"{key}.conv.{k}.1")
        _conv_module(sd, p[f"ConvModule_{n}"], st[f"ConvModule_{n}"], f"{key}.conv.{n}",
                     f"{key}.conv.{n + 1}")
        if "SqueezeExcite_0" in p:
            _conv(sd, f"{key}.se.fc1", p["SqueezeExcite_0"]["Conv_0"])
            _conv(sd, f"{key}.se.fc2", p["SqueezeExcite_0"]["Conv_1"])
        i += 1


def _casvit(sd, bb: Mapping, bs: Mapping) -> None:
    r = "backbone"
    _conv_module(sd, bb["stem1"], bs["stem1"], f"{r}.patch_embed.0", f"{r}.patch_embed.1")
    _conv_module(sd, bb["stem2"], bs["stem2"], f"{r}.patch_embed.3", f"{r}.patch_embed.4")
    for st in range(4):
        j = 0
        while f"block{st}_{j}" in bb:
            p, s, key = bb[f"block{st}_{j}"], bs[f"block{st}_{j}"], f"{r}.network.{2 * st}.{j}"
            lp = f"{key}.local_perception.network"
            _conv(sd, f"{lp}.0", p["Conv_0"])
            _bn(sd, f"{lp}.1", p["BatchNorm_0"], s["BatchNorm_0"])
            _conv(sd, f"{lp}.2", p["Conv_1"])
            _conv(sd, f"{lp}.4", p["Conv_2"])
            _bn(sd, f"{key}.norm1", p["norm1"], s["norm1"])
            _bn(sd, f"{key}.norm2", p["norm2"], s["norm2"])
            a, sa = p["attn"], s["attn"]
            for name in ("qkv", "dwc", "proj"):
                _conv(sd, f"{key}.attn.{name}", a[name])
            for x in ("q", "k"):
                sp = a[f"{x}_spatial"]
                _conv_module(sd, sp["ConvModule_0"], sa[f"{x}_spatial"]["ConvModule_0"],
                             f"{key}.attn.oper_{x}.0.block.0", f"{key}.attn.oper_{x}.0.block.1")
                _conv(sd, f"{key}.attn.oper_{x}.0.block.3", sp["Conv_0"])
                _conv(sd, f"{key}.attn.oper_{x}.1.block.1", a[f"{x}_channel"]["Conv_0"])
            for k, name in enumerate(("fc1", "fc2")):
                _classifier(sd, f"{key}.mlp.{name}", p[f"Dense_{k}"])
            j += 1
        _bn(sd, f"{r}.norm{2 * st}", bb[f"out_norm{st}"], bs[f"out_norm{st}"])
        if f"down{st + 1}" in bb:
            _conv(sd, f"{r}.network.{2 * st + 1}.proj", bb[f"down{st + 1}"])
            _bn(sd, f"{r}.network.{2 * st + 1}.norm", bb[f"down_norm{st + 1}"],
                bs[f"down_norm{st + 1}"])


def _crossformer(sd, bb: Mapping) -> None:
    r, pe = "backbone", bb["patch_embed"]
    i = 0
    while f"proj{i}" in pe:
        _conv(sd, f"{r}.patch_embed.projs.{i}", pe[f"proj{i}"])
        i += 1
    _ln(sd, f"{r}.patch_embed.norm", pe["LayerNorm_0"])
    for s in range(4):
        j = 0
        while f"block{s}_{j}" in bb:
            blk, key = bb[f"block{s}_{j}"], f"{r}.layers.{s}.blocks.{j}"
            for name in ("norm1", "norm2", "norm_cpe"):
                if name in blk:
                    _ln(sd, f"{key}.{name}", blk[name])
            if "cpe" in blk:
                _conv(sd, f"{key}.cpe", blk["cpe"])
            a = blk["attn"]
            _linear(sd, f"{key}.attn.qkv", a["qkv"])
            _linear(sd, f"{key}.attn.proj", a["proj"])
            if "pos" in a:
                pos, pk = a["pos"], f"{key}.attn.pos"
                _linear(sd, f"{pk}.pos_proj", pos["Dense_0"])
                for k in range(3):
                    _ln(sd, f"{pk}.pos{k + 1}.0", pos[f"LayerNorm_{k}"])
                    _linear(sd, f"{pk}.pos{k + 1}.2", pos[f"Dense_{k + 1}"])
            _linear(sd, f"{key}.mlp.fc1", blk["Dense_0"])
            _linear(sd, f"{key}.mlp.fc2", blk["Dense_1"])
            j += 1
        if f"merge{s + 1}" in bb:
            m, key = bb[f"merge{s + 1}"], f"{r}.layers.{s}.downsample"
            _ln(sd, f"{key}.norm", m["LayerNorm_0"])
            i = 0
            while f"proj{i}" in m:
                _conv(sd, f"{key}.reductions.{i}", m[f"proj{i}"])
                i += 1


def _iformer(sd, bb: Mapping, bs: Mapping) -> None:
    def cb(p, s, key):  # a JAX ConvModule -> the reference's Conv2d_BN {c, bn}
        _conv_module(sd, p, s, f"{key}.c", f"{key}.bn")

    r = "backbone.downsample_layers"
    for name, key in (("stem1", f"{r}.0.0"), ("stem2_exp", f"{r}.0.2.conv_exp_bn1"),
                      ("stem2_pwl", f"{r}.0.2.conv_pwl_bn2"), ("down1", f"{r}.1.0"),
                      ("down2", f"{r}.2.0"), ("down3", f"{r}.3.0")):
        cb(bb[name], bs[name], key)
    for s in range(4):
        j = 0
        while f"block{s}_{j}" in bb:
            p, st = bb[f"block{s}_{j}"], bs[f"block{s}_{j}"]
            key = f"backbone.stages.{s}.{j}.block"
            if "mixer" in p:  # ConvBlock
                m = f"{key}.token_channel_mixer.m"
                if "dw_big" in p["mixer"]:  # RepDWBlock: a bare flax BatchNorm
                    _conv(sd, f"{m}.0.dw_big", p["mixer"]["dw_big"])
                    _conv(sd, f"{m}.0.dw_small", p["mixer"]["dw_small"])
                    _bn(sd, f"{m}.0.bn", p["mixer"]["bn"], st["mixer"]["bn"])
                else:
                    cb(p["mixer"], st["mixer"], f"{m}.0")
                cb(p["pw1"], st["pw1"], f"{m}.1")
                cb(p["pw2"], st["pw2"], f"{m}.3")
            elif "cpe" in p:
                cb(p["cpe"], st["cpe"], f"{key}.cpe.m")
            elif "attn" in p:  # SHMABlock
                for name in ("v_gate", "q", "k", "proj"):
                    cb(p["attn"][name], st["attn"][name], f"{key}.token_channel_mixer.m.{name}")
            else:  # FFN2d
                cb(p["pw1"], st["pw1"], f"{key}.channel_mixer.m.0")
                cb(p["pw2"], st["pw2"], f"{key}.channel_mixer.m.2")
            j += 1


def _conv_transpose(sd, key, p) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    sd[f"{key}.bias"] = _t(p["bias"])


def _kat(sd, bb: Mapping) -> None:
    r = "backbone"
    _conv(sd, f"{r}.patch_embed.proj", bb["patch_embed"])
    sd[f"{r}.pos_embed"] = _t(bb["pos_embed"])
    i = 0
    while f"block{i}" in bb:
        blk, key = bb[f"block{i}"], f"{r}.blocks.{i}"
        _ln(sd, f"{key}.norm1", blk["norm1"])
        _ln(sd, f"{key}.norm2", blk["norm2"])
        a = blk["attn"]
        d = np.asarray(a["query"]["kernel"]).shape[0]
        sd[f"{key}.attn.qkv.weight"] = _t(np.concatenate(
            [np.asarray(a[n]["kernel"]).reshape(d, d).T for n in ("query", "key", "value")]))
        sd[f"{key}.attn.qkv.bias"] = _t(np.concatenate(
            [np.asarray(a[n]["bias"]).reshape(d) for n in ("query", "key", "value")]))
        sd[f"{key}.attn.proj.weight"] = _t(np.asarray(a["out"]["kernel"]).reshape(d, d).T)
        sd[f"{key}.attn.proj.bias"] = _t(a["out"]["bias"])
        for jax_name, ref in (("rational1", "act1"), ("rational", "act2")):
            sd[f"{key}.mlp.{ref}.weight_numerator"] = _t(blk[jax_name]["a"])
            sd[f"{key}.mlp.{ref}.weight_denominator"] = _t(blk[jax_name]["b"])
        _linear(sd, f"{key}.mlp.fc1", blk["fc1"])
        _linear(sd, f"{key}.mlp.fc2", blk["fc2"])
        i += 1
    _ln(sd, f"{r}.norm", bb["norm"])
    if "up2a" in bb:  # the pyramid adapter
        for name in ("up2a", "up2b", "up1"):
            _conv_transpose(sd, f"{r}.{name}", bb[name])
        _ln(sd, f"{r}.up2a_norm", bb["LayerNorm_0"])
        _conv(sd, f"{r}.down1", bb["down1"])


def _classifier(sd, key, p) -> None:
    """A Dense (E, NC) -> the 1x1 conv (NC, E, 1, 1): a float32 classifier,
    CAS-ViT's MLP."""
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


def _deeplabv3(sd, hp: Mapping, hs: Mapping) -> None:
    r, ap, ast = "decode_head.head.aspp", hp["aspp"], hs["aspp"]
    keys = ["b0.", "b1.block.", "b2.block.", "b3.block.", "b4.gap.", "project."]
    for k, key in enumerate(keys):
        cb = ("1", "2") if key == "b4.gap." else ("0", "1")
        _conv_module(sd, ap[f"ConvModule_{k}"], ast[f"ConvModule_{k}"], f"{r}.{key}{cb[0]}",
                     f"{r}.{key}{cb[1]}")
    r = "decode_head.head.block"
    _conv_module(sd, hp["ConvModule_0"], hs["ConvModule_0"], f"{r}.0", f"{r}.1")
    _classifier(sd, f"{r}.4", hp["conv_seg"])
    r = "decode_head.auxlayer.block"
    _conv_module(sd, hp["aux"]["ConvModule_0"], hs["aux"]["ConvModule_0"], f"{r}.0", f"{r}.1")
    _classifier(sd, f"{r}.4", hp["aux"]["Dense_0"])


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
    """``{"params", "batch_stats", "constants"}`` of a JAX
    ``SegmentationModel`` (arrays, numpy or JAX) of MiT, ConvNeXt(V2),
    MobileNetV4 (conv variants), ResNet, a MetaFormer, EfficientViT,
    MobileNetV2 / V3 or CAS-ViT with SegFormerHead, UPerHead, FPNHead,
    DeepLabV3, Mask2FormerHead or the EfficientViT-Seg head -> the port's
    ``state_dict`` (float32 CPU tensors). The family is read from the
    tree's names (CAS-ViT by its ``stem1``, before ConvNeXt's ``out_norm0``:
    the two trees share ``down_norm{i}`` and ``out_norm{i}``)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    bb, hp, hs = params["backbone"], params["decode_head"], stats.get("decode_head", {})
    sd: Dict[str, torch.Tensor] = {}
    if "patch_embed1" in bb:
        _mit(sd, bb)
    elif "conv0_0" in bb:
        _mobilenetv4(sd, bb, stats["backbone"])
    elif "layer1_0" in bb:
        _resnet(sd, bb, stats["backbone"])
    elif "stem2_exp" in bb:  # iFormer (its stem1 is CAS-ViT's name too)
        _iformer(sd, bb, stats["backbone"])
    elif "merge1" in bb and "block0_0" in bb:
        _crossformer(sd, bb)
    elif "pos_embed" in bb:
        _kat(sd, bb)
    elif "stem1" in bb:  # CAS-ViT (its down_norm / out_norm names are ConvNeXt's too)
        _casvit(sd, bb, stats["backbone"])
    elif "stem_conv" in bb:
        _efficientvit(sd, bb, stats["backbone"])
    elif "block1" in bb and "ConvModule_0" in bb:
        _mobilenet(sd, bb, stats["backbone"])
    elif "out_norm0" in bb:
        _convnext(sd, bb)
    elif "stem" in bb:
        _metaformer(sd, bb, variables.get("constants", {}).get("backbone", {}))
    else:
        raise NotImplementedError(f"no converter of this backbone is ported: {sorted(bb)[:4]}")
    if "linear_fuse" in hp:
        _segformer_head(sd, hp, hs)
    elif "ppm" in hp:
        _uperhead(sd, hp, hs)
    elif "smooth1" in hp:
        _fpnhead(sd, hp, hs)
    elif "aspp" in hp:
        _deeplabv3(sd, hp, hs)
    elif "input0" in hp:
        _evit_seg_head(sd, hp, hs)
    elif "pixel_decoder" in hp:  # Mask2FormerHead: no batch statistics
        pixel_decoder_tree(sd, hp["pixel_decoder"], "decode_head.pixel_decoder.")
        masked_decoder_tree(sd, hp["transformer_decoder"], "decode_head.transformer_decoder.")
    else:
        raise NotImplementedError(f"no converter of this head is ported: {sorted(hp)[:4]}")
    return sd
