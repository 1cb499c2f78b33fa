"""JAX variables -> the port's ``state_dict`` (MiT + SegFormerHead).

Inverse of ``segmentation_factory_tpu/convert.py`` ``convert_mit`` (:56-95)
and ``convert_segformer_head`` (:98-124), which map the reference
``state_dict`` to the JAX tree. The port's keys are the reference's, so a
reference ``.pth`` loads as it is and this function carries JAX weights
(``{"params", "batch_stats"}`` as numpy arrays) across:

- Dense kernel (in, out) -> Linear weight (out, in);
- Conv kernel (kh, kw, in, out) -> (out, in, kh, kw);
- depthwise kernel (3, 3, 1, HC) -> (HC, 1, 3, 3);
- the classifier Dense (E, NC) -> the 1x1 conv ``linear_pred`` (NC, E, 1, 1);
- BatchNorm ``batch_stats`` mean/var -> running_mean/running_var.
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


def _segformer_head(sd, hp: Mapping, hs: Mapping) -> None:
    i = 1
    while f"linear_c{i}" in hp:
        _linear(sd, f"decode_head.linear_c{i}.proj", hp[f"linear_c{i}"])
        i += 1
    fuse = hp["linear_fuse"]
    _conv(sd, "decode_head.linear_fuse.conv", fuse["Conv_0"])
    bn = fuse["BatchNorm_0"]["BatchNorm_0"]
    stats = hs["linear_fuse"]["BatchNorm_0"]["BatchNorm_0"]
    key = "decode_head.linear_fuse.bn"
    sd[f"{key}.weight"] = _t(bn["scale"])
    sd[f"{key}.bias"] = _t(bn["bias"])
    sd[f"{key}.running_mean"] = _t(stats["mean"])
    sd[f"{key}.running_var"] = _t(stats["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    pred = hp["linear_pred"]
    sd["decode_head.linear_pred.weight"] = _t(np.asarray(pred["kernel"]).T[:, :, None, None])
    sd["decode_head.linear_pred.bias"] = _t(pred["bias"])


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of the JAX MiT + SegFormerHead
    ``SegmentationModel`` (arrays, numpy or JAX) -> the port's
    ``state_dict`` (float32 CPU tensors)."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _mit(sd, params["backbone"])
    _segformer_head(sd, params["decode_head"], variables["batch_stats"]["decode_head"])
    return sd
