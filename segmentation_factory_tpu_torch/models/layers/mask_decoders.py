"""Mask2Former's masked transformer decoder and semantic inference.

Port of ``segmentation_factory_tpu/models/layers/mask_decoders.py``:
``Mask2FormerDecoderLayer`` (:71-92), ``MultiScaleMaskedTransformerDecoder``
(:95-182) and ``semantic_inference`` (:185-190). MaskFormer's
``StandardTransformerDecoder`` is not ported.

Before each layer the attention mask comes from the previous prediction's
mask logits: resized in float32 to the layer's level by ``resize``
(align_corners=False, no antialias), then blocked where sigmoid < 0.5, and
a query that would block every key is unblocked (:146-158). Types follow
JAX's promotion, which torch shares: a compute-dtype map plus the float32
``level_embed`` gives float32 memories, the float32 queries meet the
compute-dtype projections, the LayerNorms round to the compute dtype, and
the class head and ``mask_embed`` run in float32.

Parameter names follow the JAX tree (``level_embed``, ``query_feat``,
``query_embed``, ``decoder_norm``, ``class_embed``, ``mask_embed``,
``layers.{i}.{cross_attn, self_attn}``), with the reference's ``norm1-3``
and ``linear1-2`` for the layers' LayerNorms and FFN.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from segmentation_factory_tpu_torch.models.layers.common import resize
from segmentation_factory_tpu_torch.models.layers.norm import CastLayerNorm
from segmentation_factory_tpu_torch.models.modules.position_encoding import (
    sine_position_encoding,
)
from segmentation_factory_tpu_torch.models.modules.transformer import (
    MLPHead,
    MultiheadAttention,
    dense,
)


class Mask2FormerDecoderLayer(nn.Module):
    """Masked cross-attention -> self-attention -> FFN, each post-norm."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_dim: int = 2048, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.cross_attn = MultiheadAttention(dim, num_heads, dtype)
        self.norm1 = CastLayerNorm(dim, dtype)
        self.self_attn = MultiheadAttention(dim, num_heads, dtype)
        self.norm2 = CastLayerNorm(dim, dtype)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm3 = CastLayerNorm(dim, dtype)

    def forward(self, tgt, memory, query_pos, pos, attn_mask):
        y = self.cross_attn(tgt + query_pos, memory + pos, memory, attn_mask=attn_mask)
        tgt = self.norm1(tgt + y)
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        y = dense(torch.relu(dense(tgt, self.linear1, self.dtype)), self.linear2, self.dtype)
        return self.norm3(tgt + y)


class MultiScaleMaskedTransformerDecoder(nn.Module):
    """The pixel decoder's maps (coarsest first) and mask features ->
    {'pred_logits' (B, Q, K + 1), 'pred_masks' (B, Q, H/4, W/4), both
    float32, 'aux_outputs': the predictions before each layer}; layer i
    attends to level i mod L."""

    def __init__(self, num_classes: int, dim: int = 256, num_queries: int = 100,
                 num_layers: int = 9, num_heads: int = 8, mask_dim: int = 256,
                 n_levels: int = 3, dtype=torch.bfloat16):
        super().__init__()
        self.num_queries, self.dim, self.n_levels = num_queries, dim, n_levels
        self.level_embed = nn.Parameter(torch.zeros(n_levels, dim))
        self.query_feat = nn.Parameter(torch.zeros(num_queries, dim))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, dim))
        self.layers = nn.ModuleList(Mask2FormerDecoderLayer(dim, num_heads, dtype=dtype)
                                    for _ in range(num_layers))
        self.decoder_norm = CastLayerNorm(dim, dtype)
        self.class_embed = nn.Linear(dim, num_classes + 1)
        self.mask_embed = MLPHead(dim, dim, mask_dim, 3, dtype=torch.float32)

    def draw_embeddings(self, generator: torch.Generator) -> None:
        """``level_embed``, ``query_feat`` and ``query_embed`` from
        normal(1.0) (flax ``initializers.normal``)."""
        with torch.no_grad():
            for p in (self.level_embed, self.query_feat, self.query_embed):
                p.copy_(torch.randn(p.shape, generator=generator))

    def _predict(self, tgt, mask_features):
        x = self.decoder_norm(tgt).float()
        logits = dense(x, self.class_embed, torch.float32)
        masks = torch.einsum("bqc,bhwc->bqhw", self.mask_embed(x), mask_features)
        return logits, masks

    def forward(self, multi_scale_feats: List[torch.Tensor], mask_features: torch.Tensor):
        b, nq, dim = mask_features.shape[0], self.num_queries, self.dim
        memories, poss, shapes = [], [], []
        for i, f in enumerate(multi_scale_feats):
            h, w = f.shape[1], f.shape[2]
            mem = f.reshape(b, h * w, dim) + self.level_embed[i]
            pos = sine_position_encoding(h, w, dim // 2, dtype=mem.dtype, device=f.device)
            memories.append(mem)
            poss.append(pos.reshape(1, h * w, dim).expand(b, -1, -1))
            shapes.append((h, w))
        tgt = self.query_feat[None].expand(b, nq, dim)
        qpos = self.query_embed[None].expand(b, nq, dim)
        logits, masks = self._predict(tgt, mask_features)
        aux = [(logits, masks)]
        for i, layer in enumerate(self.layers):
            li = i % len(shapes)
            h, w = shapes[li]
            m = resize(masks.float().permute(0, 2, 3, 1), (h, w)).permute(0, 3, 1, 2)
            blocked = torch.sigmoid(m).reshape(b, nq, h * w) < 0.5
            blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
            tgt = layer(tgt, memories[li], qpos.to(memories[li].dtype), poss[li], blocked[:, None])
            logits, masks = self._predict(tgt, mask_features)
            aux.append((logits, masks))
        return {"pred_logits": logits, "pred_masks": masks,
                "aux_outputs": [{"pred_logits": lg, "pred_masks": mk} for lg, mk in aux[:-1]]}


def semantic_inference(pred_logits: torch.Tensor, pred_masks: torch.Tensor) -> torch.Tensor:
    """sum over queries of softmax(class)[:K] * sigmoid(mask): (B, H, W, K)."""
    probs = torch.softmax(pred_logits, dim=-1)[..., :-1]
    return torch.einsum("bqk,bqhw->bhwk", probs, torch.sigmoid(pred_masks))
