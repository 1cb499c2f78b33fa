"""The main path's kernels, each beside its plain version: K1f/K1b (SRA
attention), K2f/K2b (Mix-FFN), K3f/K3b and K4f/K4b (the fused MiT
attention and FFN half-blocks), K5f/K5b (the decode head's upsample+sum),
K6f/K6b (the head's training tail: BatchNorm on batch statistics, ReLU,
channel dropout, float32 classifier), K7f/K7b (the upsample fused with CE /
OHEM-CE and dice), K8 (the final upsample+argmax) and K9f/K9b (the
multi-scale deformable attention of Mask2Former's pixel decoder).

Importing this package builds nothing: a kernel is compiled and loaded on
its first launch (``_build``). It registers the forward kernels of the
serving path as operators of the ``sft`` namespace (``_build.register_op``),
each beside its wrapper (``sft::sra_attention_fwd``, ``mixffn_fwd``,
``attn_block_fwd``, ``ffn_block_fwd``, ``resize_sum_fwd``,
``resize_argmax``, ``ms_deform_attn``): a wrapper's call without a gradient goes through its op,
which launches the kernel on the card, runs the plain version on the CPU
and has a fake implementation, so ``torch.export`` keeps the kernels in
the traced graph (``export.py``).
"""

from segmentation_factory_tpu_torch.ops import (
    block,
    head_tail,
    lowres_loss,
    mixffn,
    msdeform,
    resize_argmax,
    resize_sum,
    sra_attention,
)

# each kernel's wrapper, whose ``launches`` attribute counts its launches
KERNELS = {
    "sra_attention": sra_attention.sra_attention,
    "sra_attention_bwd": sra_attention.sra_attention_bwd,
    "mixffn": mixffn.mixffn_apply,
    "mixffn_bwd": mixffn.mixffn_bwd,
    "attn_block": block.attn_block_apply,
    "attn_block_bwd": block.attn_block_bwd,
    "ffn_block": block.ffn_block_apply,
    "ffn_block_bwd": block.ffn_block_bwd,
    "resize_sum": resize_sum.resize_sum,
    "resize_sum_bwd": resize_sum.resize_sum_bwd,
    "head_tail": head_tail.head_tail_train,
    "head_tail_bwd": head_tail.head_tail_bwd,
    "lowres_loss_fwd": lowres_loss.lowres_loss_fwd,
    "lowres_loss_bwd": lowres_loss.lowres_loss_bwd,
    "resize_argmax": resize_argmax.resize_argmax_to,
    "ms_deform_attn": msdeform.ms_deform_attn,
    "ms_deform_attn_bwd": msdeform.ms_deform_attn_bwd,
}

__all__ = ["KERNELS", "block", "head_tail", "lowres_loss", "mixffn", "msdeform", "resize_argmax", "resize_sum", "sra_attention"]
