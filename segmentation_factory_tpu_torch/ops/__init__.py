"""The serving path's kernels (K1, K2, K5, K8), each beside its plain version.

Importing this package builds nothing: a kernel is compiled and loaded on
its first launch (``_build``).
"""

from segmentation_factory_tpu_torch.ops import (
    mixffn,
    resize_argmax,
    resize_sum,
    sra_attention,
)

# each kernel's wrapper, whose ``launches`` attribute counts its launches
KERNELS = {
    "sra_attention": sra_attention.sra_attention,
    "mixffn": mixffn.mixffn_apply,
    "resize_sum": resize_sum.resize_sum,
    "resize_argmax": resize_argmax.resize_argmax_to,
}

__all__ = ["KERNELS", "mixffn", "resize_argmax", "resize_sum", "sra_attention"]
