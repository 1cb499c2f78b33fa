"""K1: spatial-reduction attention, softmax(q kᵀ · scale) v per batch·head.

Port of ``segmentation_factory_tpu/ops/pallas_attention.py``: the entry
``sra_attention`` (:245-275) and its TPU kernel ``_forward`` (:77, body
``_kernel`` :60). The CUDA kernel is ``csrc/sra_attention.cu``;
``sra_attention_plain`` is the plain version (the ``_reference`` einsum,
:53-57, softmax in float32). Forward only: the backward is training work.
"""

from __future__ import annotations

import torch

from segmentation_factory_tpu_torch.ops import _build

_ARGTYPES = [_build.VOIDP] * 4 + [_build.INT] * 5 + [
    _build.FLOAT, _build.INT, _build.VOIDP]
HEAD_DIMS = (32, 64)


def sra_attention_plain(q, k, v, scale: float):
    """(B, N, H, D) x (B, M, H, D) einsum attention in q's dtype, softmax
    in float32."""
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v)


def sra_attention(q, k, v, scale: float):
    """Multi-head SRA attention, q (B, N, H, D), k and v (B, M, H, D),
    output (B, N, H, D) in q's dtype. CUDA tensors go through the kernel
    (float32 or bfloat16, D in ``HEAD_DIMS``); CPU tensors through the
    plain version."""
    if q.device.type == "cpu":
        return sra_attention_plain(q, k, v, scale)
    b, n, h, d = q.shape
    m = k.shape[1]
    _build.check_cuda(q, "q")
    _build.check_cuda(k, "k", (b, m, h, d), q.dtype)
    _build.check_cuda(v, "v", (b, m, h, d), q.dtype)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if m < 1 or n < 1:
        raise ValueError("empty sequence")
    out = torch.empty_like(q)
    _build.launch(
        "sra_attention", "sft_sra_attention", _ARGTYPES,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, n, m, h, d, float(scale), _build.DTYPE_CODE[q.dtype],
        _build.stream_ptr(q),
    )
    sra_attention.launches += 1
    return out


sra_attention.launches = 0
