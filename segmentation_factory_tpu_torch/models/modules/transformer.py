"""Attention and MLP blocks of the Mask2Former decoder.

Port of ``segmentation_factory_tpu/models/modules/transformer.py``:
``MultiheadAttention`` (:17-44) and ``MLPHead`` (:143-155), in plain
PyTorch. Weights are float32 and each Linear runs in the module's compute
dtype, as flax's ``nn.Dense(dtype=...)``. The attention logits are cast to
float32, blocked entries take -1e9 through ``where`` (True = blocked, no
additive mask), the softmax runs in float32 and is cast to the compute
dtype before the product with v. Parameter names are the JAX tree's (``q``,
``k``, ``v``, ``proj``; ``MLPHead.layers`` as DETR's MLP).
``TransformerEncoderLayer`` / ``TransformerDecoderLayer`` (MaskFormer's
decoder) are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """``lin`` with its input and weights cast to ``dtype`` (flax
    ``nn.Dense(dtype=dtype)``)."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class MultiheadAttention(nn.Module):
    """query (B, Nq, C), key / value (B, Nk, C) -> (B, Nq, C);
    ``attn_mask`` (broadcastable to (B, heads, Nq, Nk)) True where blocked."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, query, key, value, attn_mask: Optional[torch.Tensor] = None):
        h, dt = self.num_heads, self.dtype
        d = self.dim // h
        b, nq, _ = query.shape
        nk = key.shape[1]
        q = dense(query, self.q, dt).reshape(b, nq, h, d)
        k = dense(key, self.k, dt).reshape(b, nk, h, d)
        v = dense(value, self.v, dt).reshape(b, nk, h, d)
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5).float()
        if attn_mask is not None:
            logits = torch.where(attn_mask, torch.tensor(-1e9, device=logits.device), logits)
        attn = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, nq, self.dim)
        return dense(out, self.proj, dt)


class MLPHead(nn.Module):
    """``layers`` Linears, ReLU after all but the last (DETR's FFN head)."""

    def __init__(self, in_dim: int, hidden: int, out: int, layers: int = 3,
                 dtype=torch.float32):
        super().__init__()
        dims = [in_dim] + [hidden] * (layers - 1) + [out]
        self.layers = nn.ModuleList(nn.Linear(a, c) for a, c in zip(dims[:-1], dims[1:]))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = dense(x, lin, self.dtype)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x
