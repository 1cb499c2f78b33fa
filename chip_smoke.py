#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU — serving and
training — and hold every kernel against its plain PyTorch version.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
imports nothing of JAX or of ``segmentation_factory_tpu``. Phases, one JSON
line each:

1. device — card name and power limit, torch/CUDA versions, kernel build
   time (all eleven sources of ``ops/csrc``, ``_build.SOURCES``, compiled at
   first use, one nvcc each, started together), ptxas's registers and
   spills (K5f's, K5b's, K6's, K7's, K8's and K9's by function);
2. check — each kernel at the main path's shapes (MiT-B2 + SegFormerHead,
   batch 2, 1024², 19 classes) against its plain version in float32 and
   bfloat16: the forward kernels on their outputs, the backward kernels
   (K1b, K2b, K3b, K4b, K5b, K6b, K7b) on the gradients of autograd through
   the plain versions, K6f on the logits and the batch statistics, K7f on
   the loss map and the dice partials; the half-blocks K3/K4 at stages 1-3
   with one image's drop-path factor 0; K1 and K3 also at MiT-B0's head dim
   32 (its widths and heads on the same maps), K3 and K4 at MiT-B0's widths
   C = 32 / 64 / 160 / 256 (stage 4 too); K2f also at MiT-B0's widths, at
   config #4's stage 4 (a 7 x 7 map, batch 24) and phase by phase (fc1 and
   fc2 on the GEMM's NN form, the stencil) at stage 4; K6 also at config
   #1's head (16 images at 128², E = 256, 21 classes) and config #4's (24
   images at 56², E = 768, 9 classes); K5f (its values) and K5b also at
   config #1's and config #4's pyramids and one that does not divide, K7b
   at those configs' shapes, sizes that do not divide, ADE20K's 150
   classes and with tiles cut by the image's edge around an all-void block,
   K7f (its loss map and dice partials, and the partials' bits across two
   calls) and K8 (its labels equal to the plain version's everywhere, float32
   and bf16) at the same shapes (``transpose_checks``); the GEMM of the
   Mix-FFN backward (K2b / K4b, and K3b's products) at stage 3's products;
   K7f, K7b (the fused CE + dice criterion's gradient) and K8 on the logits
   pinned config #2's model (ConvNeXt-T + UPerHead, bf16) hands them in a
   training and an eval forward of its batch (16 images at 512², 150
   classes), and K8 on config #3's (MobileNetV4-M + FPNHead, 2 classes)
   (``pinned_checks``); K1f / K1b at config #4's stage 4 (24 images,
   N = M = 49, 8 heads), K3f / K3b and K4f / K4b at its stages 1-3 (M = 49;
   K4f's 64-pixel tiles cut by the map's edge at 28² and 14²) and K2b at its
   7 x 7 stage 4 (``config4_checks``);
3. serve — ``build_model("mit_b2", "segformerhead", 19)`` at full width
   (E=768), seeded weights, bfloat16, in the fused configuration (the
   default): ``predict_step`` on a few batches and ``eval_step`` on one,
   with launch counts per forward (``PER_FORWARD``) and the label maps
   against the same weights run through the plain versions;
4. train — the same model, OHEM + dice, AdamW + AGC 0.02 + the cosine
   schedule of pinned config #5, a few ``train_step`` calls on one fixed
   synthetic batch: launch counts per step (``PER_STEP``), a finite and
   falling loss, the launches per step of the phases (K2f's
   ``FFN_FWD_PHASES``, the Mix-FFN backward's ``FFN_BWD_PHASES_PER_STEP``,
   K3b's ``ATTN_BWD_PHASES_PER_STEP``, K1b's own calls of its core and K7f's
   two launches, ``K7F_PHASES``, summed in ``PHASES_PER_STEP``), and one
   float32 step through the kernels against
   the same step through the plain versions (loss and every parameter's
   gradient);
5. serve_per_op, train_per_op — phases 3 and 4 with
   ``fused_blocks=False`` (K1/K2 in every block), fewer train steps;
5b. m2f — MiT-B2 + Mask2FormerHead (E = 768: 8 heads of D = 96, 6
   pixel-decoder layers, 9 decoder layers, 100 queries), 512², batch 4,
   19 classes, bf16: K9f / K9b against their plain versions in float32
   and bf16 at the slice's shapes, at D = 32, at ragged level sizes, with
   offsets of up to 40 pixels (``wide``: K9b's windows outgrown) and at
   D = 256, with locations on the maps' edges and far outside [0, 1], and
   two K9b calls' d(value) (atomics: equal to rounding, not to the bit)
   (``k9_checks``); ``predict_step`` / ``eval_step`` with launches per
   forward (``M2F_PER_FORWARD``) and float32 labels against the plain
   versions; ``M2F_STEPS`` train steps of CE + dice (K7) and of the
   Hungarian mask loss on one fixed batch (the bench cell's AdamW + AGC +
   cosine with 100 warm-up steps), launches per step (``M2F_PER_STEP``),
   a finite, falling loss (for the mask loss, some later step below the
   first: it jumps where a matching switches), one float32 step's loss and
   gradients and three steps' losses through the kernels against the plain
   versions; K9's times (events, kernel time, bound, plain,
   ``F.grid_sample`` per level), the corner rows they gather from L2 and
   K9b's routes (the share of rows summed in a window, the 16-byte
   reductions into d(value)); profiles of a predict and a train step;
5c. zoo — model A, ``caformer_s18`` + ``uperhead`` on config #2's file
   (ADE20K, 150 classes, E = 128), and model B, ``resnet50`` +
   ``deeplabv3`` on config #1's (VOC, 21 classes, E = 768; the loss on its
   [main, aux] outputs weighted (1, 0.4)), both 512², batch 16, bf16:
   K1f / K1b at N = M with head dim 32 (model A's stages 3 and 4,
   caformer_b36's 24 heads, the ragged 576 and 144 tokens of a 0.75x eval,
   the 4096 of a 1024² eval) and K7f / K7b / K8 at an upsampling ratio of
   32 (random logits and model B's own, its aux output too) against their
   plain versions (``zoo_checks``); each model's ``predict_step`` /
   ``eval_step`` (launches per forward ``ZOO_PER_FORWARD``: K1f 12 for A,
   K8 1) with float32 labels against the plain versions, a few train steps
   (launches per step ``ZOO_PER_STEP``: K1f / K1b 12 for A, K7f / K7b 2
   for B) with a finite, falling loss and one float32 step's loss and
   gradients against the plain versions; one predict and one train step of
   IdentityFormer-S12, RandFormer-S12 (also at 384² and 768², its mixing
   matrices resampled), PoolFormerV2-S12, ConvFormer-S18 and
   ConvNeXtV2-atto + UPerHead (``zoo_variants``); models A and B through
   ``engine.loop.Trainer`` on ADE20K and VOC JPEG trees (``trainer_run``:
   one short epoch, the eval, a checkpoint and its resume, the launches);
   the slice's times (``zoo_times``: K1f / K1b at model A's shapes beside
   SDPA, K7f / K7b / K8 at ratio 32), predict and train images/s;
6. files — the port's readers on the card's host against the committed
   fixtures' manifest (``tests/torch_fixtures``, written with PIL and h5py
   by ``tools/torch_fixtures.py``): seven JPEGs (baseline 4:2:0,
   progressive, 4:4:4 q90, 4:2:2 with restarts, greyscale, Kvasir's image
   and mask) decoded by ``data/jpeg.py`` with their sha256 equal to PIL's,
   PIL's bilinear shrink of two of them, the Synapse case read by
   ``data/hdf5.py``; each decode's ms and megapixels a second, the host
   engine's build seconds;
7. trainer — ``engine.loop.Trainer`` on the files of pinned configs #5,
   #1, #2, #3 and #4 (``TRAINER_CONFIGS``) and #3 again with Kvasir's
   preset recipe, each at its classes, size and batch (halved only on
   running out of memory): #1, #2 and #3 read their own manifests (VOC,
   ADEChallengeData2016, Kvasir-SEG) on a tree of the JPEG fixtures with
   label PNGs written in a temporary directory (``jpeg_tree``; the val
   images larger than the 512² canvas, so the eval loader shrinks them as
   PIL does), #5 synthetic data, #4 a Synapse tree of 512² slices read by
   ``SynapseCT`` through its train recipe and val cases for its per-case
   dice (``synapse_data``), and #1 again with ``model.head =
   "mask2formerhead"`` (MiT-B0: K9 at D = 32): one short epoch
   through the loader and the device-side augmentation, the config's eval
   protocol, a checkpoint and its resume;
   images/s with the loader, the loader's wait per step, a profiled train
   step and ``predict_step`` at the config's batch, and each config's
   launches read right after its run against ``trainer_expected`` (K6 once
   a step with SegFormerHead, K7f / K7b once a step where the loss is
   fused, K8 once an eval batch of the whole-image protocol; for config #4,
   whose val split the Trainer scores per case (``Trainer.volumetric``),
   every MiT and K5 kernel by step and eval window, K8 never);
7b. options — the Trainer's options on config #5's model (MiT-B2 +
   SegFormerHead, 1024², fused): three SGD updates with the backbone
   checkpointed (``remat``) in bf16 and in float32, each update's
   gradients against two plain backwards from the same state (the same
   loss and running statistics; float32 within PERF.md §2's gradient bar,
   bf16 within ``REMAT_NOISE`` times the plain backwards' own distance,
   which K1b / K2b's atomics make), with the bf16 launch counts a step
   (``PER_STEP_REMAT``: the backbone's forward kernels twice); the peak
   memory and a step's wall ms at the config's batch of 8 with and without
   remat; ``grad_accum = 2`` under SGD + poly + the global-norm clip (the parameters move at every second micro-step, the
   update count and the rate follow); a finetune + freeze from that run's
   checkpoint (frozen parameters bit-identical); the pretrained backbone
   from a ``.pth`` the phase writes (every tensor loaded, none skipped);
   the plateau Trainer over three short epochs (the rate falls after every
   eval whose mIoU does not rise); each of the 23 optimizers three updates
   on config #1's model on the card against the CPU, and one update's
   event ms on config #5's parameters;
8. entry — config #5's serving entry points, same model and weights format:
   ``SemSeg(ckpt_dir=...)`` loads the best of two checkpoints (not the
   latest); ``export.export_model`` at a dynamic batch, loaded and called at
   batch 1 and 2, the program's launches per forward (``PER_FORWARD``
   without K8: its forward ops are registered ``sft::`` ops), its bf16
   logits within the export check's 5e-2 of the live model and its labels
   agreeing outside near-ties; ``validate.main`` on 4 synthetic 1024² images
   whole, ms_flip and through the exported program (its confusion matrix
   within twice the near-ties of the live whole run's logits from that
   run's); ``predict.main --tta --dataset cityscapes --draw-names`` on a
   1024 x 2048 PNG written by the port's codec; K1f-K5f on the inputs the
   model gives them at TTA's largest scale (1792 x 3584 and 1792²) against
   their plain versions under the check phase's bars; one TTA prediction at
   256 x 512 in float32 against the plain versions; ``predict.main --tta``
   on a JPEG fixture; ``validate.main --dataset synapse`` on the committed
   ``.npy.h5`` case against ``infer.evaluate_volumes``; the Mask2Former
   slice's ``.pt2`` (its graph holds ``sft::ms_deform_attn``, its launches
   a forward, its labels at batch 1 and 4 against the live model's) and
   the zoo's model A's (``sft::sra_attention_fwd``, 12 a forward); export
   and load seconds, the exported and the live forward at batch 2 (events
   and kernel time), and the host cost of a registered op's dispatch;
9. times — per kernel and shape, the CUDA-event time and the profiler's
   kernel time (``kernel_trace``) beside the plain version's, the library
   call's where one exists (both ways) and the bound; K2f's, K2b's, K4b's,
   K1b's and K3b's kernel time per phase and stage, K6f's per step
   (statistics, logits), K6b's per pass and K7f's per launch (blocks,
   finish), grouped from the same trace (``phases_of``); K5f's, K5b's,
   K6f's, K7b's, K7f's and K8's launch geometry; K7f, K7b and K8 at
   config #2's shapes too (150 classes) and K1f, K1b, K3f, K3b, K4f and K4b
   at config #4's (``config4_times``), outside the per-step totals;
   predict and train
   images/s of both configurations; a profile of one predict and one train
   step of the fused configuration.

Then the ``kernels`` summary line, the ``nvidia-smi`` name/power line and,
last, ``{"ok": true, "device": ...}``. Any failed phase makes the exit code
1 and suppresses the last line; so does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.nn.functional as F

B, IMG, NC = 2, 1024, 19
DEV = "cuda"
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PEAK_F32 = 67e12    # H100 SXM float32 FLOP/s outside the tensor cores (K6's products)
# exponentials a second on the SFUs: 16 a clock on each of 132 SMs at the
# H100 SXM's 1980 MHz boost clock (data sheet); K7f's bound by operations
PEAK_SFU = 132 * 16 * 1.98e9
HBM = 3.35e12       # bytes/s
REL_F32 = 1e-4      # float32: the kernel reorders the plain version's sums
AGREE = 0.999       # label-map agreement bar
TIE_GAP = 1e-5      # argmax near-tie in float32 logits
LOSS_REL = 1e-4     # float32 train step, kernels vs plain: the loss
# ... and each parameter's gradient: within GRAD_REL of its largest plain
# entry (the kernels reorder float32 sums, with atomics in K1b/K2b, through
# 16 blocks; the OHEM keep-set may flip at the k-th value for a few pixels)
# plus GRAD_ABS of the model's largest gradient entry (gradients that are
# zero but for rounding: biases feeding the train-mode BatchNorm)
GRAD_REL = 1e-3
GRAD_ABS = 1e-6
IGNORE = 255
TRAIN_STEPS = 6
TRAIN_STEPS_PER_OP = 3
TRAINER_STEPS = 6   # the trainer phase's one short epoch
CONFIG5 = "configs/cityscapes_mit_b2_segformer_1024.json"
CONFIG2 = "configs/ade20k_convnext_tiny_upernet_512.json"
CONFIG3 = "configs/kvasir_mobilenetv4_fpn_512.json"
CONFIG4 = "configs/synapse_mit_b2_segformer_224.json"
# the pinned configs the trainer phase runs: #5 (the main path), #1, #2, #3, #4
CONFIG1 = "configs/voc_mit_b0_segformer_512.json"
TRAINER_CONFIGS = [CONFIG5, CONFIG1, CONFIG2, CONFIG3, CONFIG4]
# config #4's synthetic Synapse data: train slices and val cases of 512²
SYNAPSE_SLICE, SYNAPSE_CASES = 512, (16, 16)
# the committed file fixtures (tools/torch_fixtures.py) and the images of
# configs #1-#3's trees: the train files cycle through FIXTURE_IMAGES, the
# val files are the two larger than the 512² eval canvas (the PIL shrink runs)
FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_fixtures"
FIXTURE_IMAGES = ["voc_500x375_q75_420.jpg", "voc_500x333_progressive.jpg",
                  "ade_683x512_q90_444.jpg", "portrait_768x1024_422_restart.jpg",
                  "coco_640x480_grey.jpg", "kvasir_622x529.jpg"]
VAL_IMAGES = ["ade_683x512_q90_444.jpg", "portrait_768x1024_422_restart.jpg"]
KVASIR_MASK = {"kvasir_622x529.jpg": "kvasir_622x529_mask.jpg"}
DECODE_RUNS = 5     # phase files: a decode's time is the median of these
WARMUP = 1500       # pinned config #5: cosine, 1500 warm-up steps, lr 1e-3

# (dim, heads, depth) per MiT-B2 stage; stage i maps are IMG/4/2^i wide and
# its reduced K/V map IMG/32 (M = 1024 at 1024²)
STAGES = [(64, 1, 3), (128, 2, 4), (320, 5, 6), (512, 8, 3)]
# (dim, heads) per MiT-B0 stage: head dim 32 on the same maps
B0_STAGES = [(32, 1), (64, 2), (160, 5), (256, 8)]


def side(stage: int, img: int = IMG) -> int:
    return img // 4 >> stage


def kv_side(img: int = IMG) -> int:
    return img // 32


_CSRC = "segmentation_factory_tpu_torch/ops/csrc/"
_TPU = "segmentation_factory_tpu/ops/"
SOURCES = {
    "sra_attention": (_CSRC + "sra_attention.cu", _TPU + "pallas_attention.py:77"),
    "sra_attention_bwd": (_CSRC + "sra_attention_bwd.cu", _TPU + "pallas_attention.py:164"),
    "mixffn": (_CSRC + "mixffn.cu", _TPU + "pallas_ffn.py:304"),
    "mixffn_bwd": (_CSRC + "mixffn_bwd.cu", _TPU + "pallas_ffn.py:351"),
    "attn_block": (_CSRC + "attn_block.cu", _TPU + "pallas_block.py:268"),
    "attn_block_bwd": (_CSRC + "sra_attention_bwd.cu", _TPU + "pallas_block.py:303"),
    "ffn_block": (_CSRC + "mixffn.cu", _TPU + "pallas_block.py:641"),
    "ffn_block_bwd": (_CSRC + "mixffn_bwd.cu", _TPU + "pallas_block.py:691"),
    "resize_sum": (_CSRC + "resize_sum.cu", _TPU + "pallas_resize_sum.py:109"),
    "resize_sum_bwd": (_CSRC + "resize_sum_bwd.cu", _TPU + "pallas_resize_sum.py:239"),
    "head_tail": (_CSRC + "head_tail.cu", _TPU + "pallas_head_tail.py:161"),
    "head_tail_bwd": (_CSRC + "head_tail.cu", _TPU + "pallas_head_tail.py:216"),
    "lowres_loss_fwd": (_CSRC + "lowres_loss.cu", _TPU + "pallas_loss.py:261"),
    "lowres_loss_bwd": (_CSRC + "lowres_loss.cu", _TPU + "pallas_loss.py:292"),
    "resize_argmax": (_CSRC + "resize_argmax.cu", _TPU + "pallas_loss.py:377"),
    # not a Pallas function: XLA gathers and a custom VJP (msdeform.py:20-26)
    "ms_deform_attn": (_CSRC + "ms_deform_attn.cu", _TPU + "msdeform.py:181"),
    "ms_deform_attn_bwd": (_CSRC + "ms_deform_attn.cu", _TPU + "msdeform.py:205"),
}
# launches of one train step and of one predict forward, in the fused
# configuration (13 blocks of stages 1-3 as K3 + K4, the 3 of stage 4 per-op)
# and in the per-op one (K1 + K2 in all 16)
PER_STEP = {"sra_attention": 3, "sra_attention_bwd": 3, "mixffn": 3, "mixffn_bwd": 3,
            "attn_block": 13, "attn_block_bwd": 13, "ffn_block": 13, "ffn_block_bwd": 13,
            "resize_sum": 1, "resize_sum_bwd": 1, "head_tail": 1, "head_tail_bwd": 1,
            "lowres_loss_fwd": 1, "lowres_loss_bwd": 1, "resize_argmax": 0,
            "ms_deform_attn": 0, "ms_deform_attn_bwd": 0}
PER_FORWARD = {"sra_attention": 3, "mixffn": 3, "attn_block": 13, "ffn_block": 13,
               "resize_sum": 1, "resize_argmax": 1}
PER_STEP_PER_OP = dict(PER_STEP, sra_attention=16, sra_attention_bwd=16, mixffn=16,
                       mixffn_bwd=16, attn_block=0, attn_block_bwd=0, ffn_block=0,
                       ffn_block_bwd=0)
PER_FORWARD_PER_OP = dict(PER_FORWARD, sra_attention=16, mixffn=16, attn_block=0, ffn_block=0)
# the phases of K2f (ops/mixffn.py ffn_fwd), launched by each K2f call: fc1
# and fc2 (ffn_fc, the GEMM's NN form; ops/csrc/sm90.cuh) around the stencil
FFN_FWD_PHASES = {"ffn_fc": 2, "ffn_stencil": 1}


def ffn_fwd_phases(calls):
    """The launches of K2f's phases in ``calls`` K2f calls."""
    return {k: n * calls for k, n in FFN_FWD_PHASES.items()}


# the phases of the Mix-FFN backward (ops/mixffn.py ffn_bwd), launched by
# each of the 16 K2b / K4b calls of a train step: prep, the fc1 recompute
# (NN GEMM) and g W2^T (NT), the tile kernel, two TN GEMMs (dW1, dW2), dln
# (NT), and in K4b's 13 fused calls the LN backward
FFN_BWD_PHASES_PER_STEP = {"ffn_bwd_prep": 16, "gemm_nn": 16, "gemm_nt": 32,
                           "ffn_bwd_tile": 16, "gemm_tn": 32, "ln_bwd": 13}
FFN_BWD_PHASES_PER_STEP_PER_OP = dict(FFN_BWD_PHASES_PER_STEP, ln_bwd=0)
# the phases of K3b (ops/block.py attn_bwd), launched by each of its 13
# calls of a fused train step: prep (LN1, dz), q (NT GEMM), doh and dln (NN),
# K1b's attention-backward core, two TN GEMMs (dWq, dWo), the LN backward
ATTN_BWD_PHASES_PER_STEP = {"ffn_bwd_prep": 13, "gemm_nt": 13, "gemm_nn": 26,
                            "sra_attention_bwd_core": 13, "gemm_tn": 26, "ln_bwd": 13}
ATTN_BWD_PHASES_PER_STEP_PER_OP = dict.fromkeys(ATTN_BWD_PHASES_PER_STEP, 0)
# K1b's own calls of its core: 3 a fused step (stage 4), 16 per-op
K1B_CORE_PER_STEP = {"sra_attention_bwd_core": 3}
K1B_CORE_PER_STEP_PER_OP = {"sra_attention_bwd_core": 16}
# K7f's two launches (ops/lowres_loss.py): each block's dice partials and the
# loss map, then the sum over each image's blocks; one K7f call a step
K7F_PHASES = {"fwd_blocks": 1, "fwd_finish": 1}


def add_counts(*shares):
    """The expected launches of each phase: the sum of its callers' shares."""
    out = {}
    for share in shares:
        for k, n in share.items():
            out[k] = out.get(k, 0) + n
    return out


BWD_PHASES_PER_STEP = add_counts(FFN_BWD_PHASES_PER_STEP, ATTN_BWD_PHASES_PER_STEP,
                                 K1B_CORE_PER_STEP)
BWD_PHASES_PER_STEP_PER_OP = add_counts(FFN_BWD_PHASES_PER_STEP_PER_OP,
                                        ATTN_BWD_PHASES_PER_STEP_PER_OP,
                                        K1B_CORE_PER_STEP_PER_OP)
# every phase's launches a train step: K2f's (3 calls fused, 16 per-op) and
# the backwards'
PHASES_PER_STEP = add_counts(ffn_fwd_phases(PER_STEP["mixffn"]), BWD_PHASES_PER_STEP,
                             K7F_PHASES)
PHASES_PER_STEP_PER_OP = add_counts(ffn_fwd_phases(PER_STEP_PER_OP["mixffn"]),
                                    BWD_PHASES_PER_STEP_PER_OP, K7F_PHASES)

# a train step with the backbone checkpointed (``remat``): its forward
# kernels (K1f / K2f at stage 4, K3f / K4f) launch again in the backward
REMAT_FWD = ("sra_attention", "mixffn", "attn_block", "ffn_block")
PER_STEP_REMAT = {k: n * (2 if k in REMAT_FWD else 1) for k, n in PER_STEP.items()}
PHASES_PER_STEP_REMAT = add_counts(ffn_fwd_phases(PER_STEP_REMAT["mixffn"]), BWD_PHASES_PER_STEP,
                                   K7F_PHASES)
OPTIONS_STEPS = 3   # phase options: updates with and without remat
# bf16 remat gradients: relative L2 distance from a plain backward within this
# many times two plain backwards' own (K1b / K2b's atomics; about 1.6e-3 on
# config #5, and remat's 0.9-1.1 times that)
REMAT_NOISE = 2.0
OPTIONS_BATCH = 8   # config #5's own batch: the peak memory with and without remat
OPTIONS_EPOCHS = 3  # the plateau Trainer's short epochs


def phase_function(name):
    """The wrapper of a phase, whose ``launches`` counts it."""
    from segmentation_factory_tpu_torch.ops import lowres_loss, mixffn, sra_attention

    if name in K7F_PHASES:
        return getattr(lowres_loss, name)
    return getattr(sra_attention if name == "sra_attention_bwd_core" else mixffn, name)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unavailable"


def cuda_ms(fn, min_time=0.3, max_iters=200) -> float:
    """Mean device time of ``fn()`` in ms over a run of launches after a
    warm-up, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max_iters, max(3, min_time * 1e3 / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16):
    """(bound in ms, what bounds it, operations' ms, bytes' ms)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", t_ops, t_bytes


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# ------------------------------------------------------------------ inputs


def gen(seed):
    return torch.Generator(device=DEV).manual_seed(seed)


def randn(shape, g, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device=DEV) * scale).to(dtype)


def attn_inputs(stage, dtype, b0=False, batch=B, img=IMG):
    """K1's q, k, v at MiT-B2's stage (head dim 64) or MiT-B0's (32), for
    ``batch`` images of ``img``² (the main path's, or config #4's)."""
    heads, d = (B0_STAGES[stage][1], 32) if b0 else (STAGES[stage][1], 64)
    n, m = side(stage, img) ** 2, kv_side(img) ** 2
    g = gen(10 + stage + 200 * b0)
    q = randn((batch, n, heads, d), g, dtype=dtype)
    k = randn((batch, m, heads, d), g, dtype=dtype)
    v = randn((batch, m, heads, d), g, dtype=dtype)
    return q, k, v


def ffn_inputs(stage, dtype, b0=False, batch=B, s=None, seed=20):
    """K2's y, w1, b1, dw, db, w2, b2 at MiT-B2's stage (or MiT-B0's), on
    the stage's map at 1024² (or an s x s one)."""
    c, s = (B0_STAGES if b0 else STAGES)[stage][0], s or side(stage)
    hc = 4 * c
    g = gen(seed + stage + 200 * b0)
    return [randn(shape, g, sc, dtype) for shape, sc in [
        ((batch, s, s, c), 1.0), ((c, hc), c ** -0.5), ((hc,), 0.1),
        ((3, 3, 1, hc), 1 / 3), ((hc,), 0.1), ((hc, c), hc ** -0.5), ((c,), 0.1)]]


# config #4 (Synapse, MiT-B2 at 224², batch 24): stage 4 is a 7 x 7 map,
# where K2f's tiles are partial, and every stage's reduced K/V map is 7 x 7:
# M = 49 keys in a 64-row tile
SYNAPSE_BATCH, SYNAPSE_IMG = 24, 224
SYNAPSE_S4 = SYNAPSE_IMG // 32


def block_fac(batch=B):
    """Drop-path factors of the half-block checks: image 0 dropped, the
    others kept at rate 0.2."""
    return torch.tensor([0.0] + [1.25] * (batch - 1), device=DEV)


def attn_block_inputs(stage, dtype, b0=False, batch=B, img=IMG):
    """K3's inputs at stage ``stage`` of MiT-B2 (or of MiT-B0), for
    ``batch`` images of ``img``²: x, k, v, lg, lb, wq, bq, wo, bo (lg, lb
    float32)."""
    c, s, m = (B0_STAGES if b0 else STAGES)[stage][0], side(stage, img), kv_side(img) ** 2
    g = gen(110 + stage + 200 * b0)
    return [randn((batch, s, s, c), g, dtype=dtype), randn((batch, m, c), g, 0.5, dtype),
            randn((batch, m, c), g, 0.5, dtype), 1 + randn((c,), g, 0.2),
            randn((c,), g, 0.1), randn((c, c), g, c ** -0.5, dtype),
            randn((c,), g, 0.1, dtype), randn((c, c), g, c ** -0.5, dtype),
            randn((c,), g, 0.1, dtype)]


def ffn_block_inputs(stage, dtype, b0=False, batch=B, img=IMG):
    """K4's inputs, for ``batch`` images of ``img``²: x, lg, lb (float32),
    then K2's weights."""
    x, *w = ffn_inputs(stage, dtype, b0, batch=batch, s=side(stage, img))
    c = x.shape[-1]
    g = gen(120 + stage + 200 * b0)
    return [x, 1 + randn((c,), g, 0.2), randn((c,), g, 0.1), *w]


def sum_inputs(dtype):
    g = gen(30)
    # top level first, as the head passes them
    return [randn((B, side(i), side(i), 768), g, dtype=dtype) for i in (3, 2, 1, 0)]


def argmax_inputs(dtype):
    return randn((B, IMG // 4, IMG // 4, NC), gen(40), 2.0, dtype)


TAIL_SIDE, TAIL_E = IMG // 4, 768  # the fuse tensor of the train cell
# config #1's head (VOC, MiT-B0 at 512², batch 16): E = 256, 21 classes;
# config #4's (Synapse, MiT-B2 at 224², batch 24): E = 768, 9 classes
VOC_TAIL = (16, 512 // 4, 256, 21)
SYNAPSE_TAIL = (24, 224 // 4, 768, 9)


def tail_inputs(dtype, b=B, side_=TAIL_SIDE, e=TAIL_E, nc=NC, seed=170):
    """K6's inputs at the train cell's shape (or b images of side_² pixels,
    e channels, nc classes): s (in ``dtype``), gamma, beta, the classifier
    (NC, E, 1, 1) and its bias (float32). s takes the
    integers -4..4 (exact in bf16) and beta puts each channel's ReLU kink
    midway between two of its normalized levels, so every BatchNorm output
    lies at least 0.5 * gamma * rsig from it: the kernel and the plain
    version sum the batch statistics in different orders, and on random
    inputs a value within rounding of the kink takes the ReLU's two sides in
    the two versions (its gradient then differs by its whole size)."""
    g = gen(seed)
    s = torch.randint(-4, 5, (b, side_, side_, e), generator=g, device=DEV).float()
    gamma = 1 + randn((e,), g, 0.2)
    sd = s.double()
    mean = sd.mean((0, 1, 2))
    rsig = torch.rsqrt((sd * sd).mean((0, 1, 2)) - mean * mean + 1e-5)
    k0 = torch.randint(-3, 3, (e,), generator=g, device=DEV)
    beta = (-gamma.double() * (k0 + 0.5 - mean) * rsig).float()
    return [s.to(dtype), gamma, beta, randn((nc, e, 1, 1), g, e ** -0.5), randn((nc,), g, 0.1)]


def tail_mask(b=B, e=TAIL_E):
    """A channel-dropout mask (B, E): keep 0.9, scaled by 1 / 0.9."""
    return (torch.rand((b, e), generator=gen(171), device=DEV) < 0.9).float() / 0.9


def loss_labels():
    """(B, IMG, IMG) int32 labels in 128-pixel blocks of the 19 classes, the
    top 16 rows void."""
    idx = torch.arange(IMG, device=DEV) // 128
    lab = ((idx[:, None] * 8 + idx[None, :]) % NC).to(torch.int32).expand(B, IMG, IMG)
    lab = lab.contiguous()
    lab[:, :16] = IGNORE
    return lab


def train_batch():
    """A fixed learnable batch: each pixel's colour is its class's colour
    plus noise."""
    g = gen(500)
    lab = loss_labels()
    palette = torch.randn((NC + 1, 3), generator=g, device=DEV)
    img = palette[lab.clamp_max(NC).long()] + 0.5 * torch.randn((B, IMG, IMG, 3), generator=g,
                                                                 device=DEV)
    return {"image": img, "label": lab}


# ------------------------------------------------------------------ phases


def check_pair(kernel, plain, make, rel=REL_F32):
    """Float32: kernel within ``rel`` x max|ref| of the plain version.
    bfloat16: the kernel's error against the float32 plain version on the
    same bf16-valued inputs within twice the plain bf16 version's own error,
    or one bf16 ulp of max|ref| (2^-7), whichever is larger."""
    x32 = make(torch.float32)
    ref = plain(*x32)
    got = kernel(*x32)
    err32 = max_err(got, ref)
    scale = ref.float().abs().max().item()
    ok32 = bool(torch.isfinite(got).all()) and err32 <= rel * scale
    x16 = make(torch.bfloat16)
    ref16 = plain(*[t.float() for t in x16])
    err_k = max_err(kernel(*x16), ref16)
    err_p = max_err(plain(*x16), ref16)
    bar16 = max(2 * err_p, 2 ** -7 * ref16.abs().max().item())
    torch.cuda.synchronize()
    return {"f32_max_abs_err": err32, "f32_max_rel_err": err32 / max(scale, 1e-30),
            "f32_bar": rel * scale, "bf16_max_abs_err": err_k,
            "bf16_plain_err": err_p, "bf16_bar": bar16, "ok": ok32 and err_k <= bar16}


def grads(fn, args, g):
    """Gradients of sum(fn(*args) * g) with respect to every arg."""
    args = [a.detach().requires_grad_() for a in args]
    return torch.autograd.grad(fn(*args), args, g)


def check_grads(kernel, plain, make, rel=REL_F32):
    """The gradients of ``kernel`` (through its autograd Function, i.e. the
    backward kernel) against autograd through ``plain``, for ``make(dtype)``
    -> (inputs, cotangent). Float32: each gradient within ``rel`` x its
    largest plain entry. bfloat16: each within twice the plain bf16
    version's own error from float32 truth, or 2^-7 of the largest truth."""
    x32, g32 = make(torch.float32)
    got, want = grads(kernel, x32, g32), grads(plain, x32, g32)
    errs = [max_err(a, b) for a, b in zip(got, want)]
    scales = [b.float().abs().max().item() for b in want]
    ok32 = all(bool(torch.isfinite(a).all()) and e <= rel * sc
               for a, e, sc in zip(got, errs, scales))
    del got, want
    x16, g16 = make(torch.bfloat16)
    truth = grads(plain, [x.float() for x in x16], g16.float())
    got = grads(kernel, x16, g16)
    base = grads(plain, x16, g16)
    errs_k = [max_err(a, t) for a, t in zip(got, truth)]
    errs_p = [max_err(a, t) for a, t in zip(base, truth)]
    bars = [max(2 * ep, 2 ** -7 * t.float().abs().max().item()) for ep, t in zip(errs_p, truth)]
    torch.cuda.synchronize()
    return {"f32_max_abs_err": max(errs),
            "f32_max_rel_err": max(e / max(sc, 1e-30) for e, sc in zip(errs, scales)),
            "bf16_max_abs_err": max(errs_k), "bf16_plain_err": max(errs_p),
            "bf16_ok_each": [ek <= b for ek, b in zip(errs_k, bars)],
            "ok": ok32 and all(ek <= b for ek, b in zip(errs_k, bars))}


def bwd_inputs(make_fwd, out_shape, seed):
    """(inputs, cotangent) for a backward check: ``make_fwd``'s inputs and a
    random cotangent of the output's shape."""
    def make(dtype):
        x = make_fwd(dtype)
        return x, randn(out_shape(x), gen(seed), dtype=dtype)
    return make


# K5b and K7b at other configurations' shapes: config #1 (VOC, MiT-B0 at
# 512², batch 16: E = 256, 21 classes), config #4 (Synapse, 224², batch 24:
# E = 768, 9 classes), sizes that do not divide, ADE20K's 150 classes, and
# tiles cut by the image's edge (40 x 37 is no multiple of the 16 x 16 tile)
K5B_SHAPES = {"voc": (16, (128, 128), [(64, 64), (32, 32), (16, 16)], 256),
              "synapse": (24, (56, 56), [(28, 28), (14, 14), (7, 7)], 768),
              "ragged": (2, (50, 53), [(25, 26), (13, 14), (7, 8)], 64)}
K7B_SHAPES = {"voc": (16, 128, 128, 21, 512, 512), "synapse": (24, 56, 56, 9, 224, 224),
              "ragged": (2, 63, 47, 19, 250, 190), "ade": (2, 32, 32, 150, 128, 128),
              "edge_void": (2, 40, 37, 19, 160, 148)}


def loss_bwd_inputs(b, c, hh, ww, seed):
    """K7b's labels (random classes, the top rows void, an all-void block
    at the last image's bottom-right corner, three labels outside [0, C)),
    a weight map zero at void pixels, and dcoef."""
    g = gen(seed)
    lab = torch.randint(0, c, (b, hh, ww), generator=g, device=DEV, dtype=torch.int32)
    lab[:, :max(1, hh // 16)] = IGNORE
    lab[-1, -(hh // 4):, -(ww // 3):] = IGNORE
    lab[0, -1, :3] = c + 2
    wmap = torch.rand((b, hh, ww), generator=g, device=DEV) / lab.numel() * (lab != IGNORE)
    return lab, wmap, randn((b, 2, c), g, 0.01)


def transpose_checks(K5, K7, K8):
    """K5f (its values, against the plain version) and K5b (through K5's
    autograd Function, against autograd through the plain version) at
    ``K5B_SHAPES``; K7b (alone, against ``lowres_loss_bwd_plain``), K7f
    (its loss map and dice partials against ``lowres_loss_plain``, the
    partials' bits across two calls) and K8 (equal to
    ``resize_argmax_plain`` everywhere) at ``K7B_SHAPES``."""
    res = {}
    for i, (name, (b, hw, levels, e)) in enumerate(K5B_SHAPES.items()):
        def make(dt, b=b, hw=hw, levels=levels, e=e, seed=190 + i):
            g = gen(seed)
            zs = [randn((b, *hw, e), g, dtype=dt)] + [randn((b, h, w, e), g, dtype=dt)
                                                      for h, w in levels]
            return zs, randn((b, *hw, e), g, dtype=dt)
        res[f"resize_sum:{name}"] = check_pair(
            lambda *z: K5.resize_sum(list(z)), lambda *z: K5.resize_sum_plain(list(z)),
            lambda dt, make=make: make(dt)[0])
        res[f"resize_sum_bwd:{name}"] = check_grads(
            lambda *z: K5.resize_sum(list(z)), lambda *z: K5.resize_sum_plain(list(z)), make)
    for i, (name, (b, hl, wl, c, hh, ww)) in enumerate(K7B_SHAPES.items()):
        lab, wmap, dcoef = loss_bwd_inputs(b, c, hh, ww, 200 + i)
        make = lambda dt, b=b, hl=hl, wl=wl, c=c, i=i: [  # noqa: E731
            randn((b, hl, wl, c), gen(210 + i), 2.0, dt)]
        res[f"lowres_loss_bwd:{name}"] = check_pair(
            lambda lo: K7.lowres_loss_bwd(lo, lab, wmap, dcoef),
            lambda lo: K7.lowres_loss_bwd_plain(lo, lab, wmap, dcoef), make)
        res.update(loss_fwd_checks(K7, lab, make, name))
        res[f"resize_argmax:{name}"] = argmax_check(K8, make, (hh, ww))
        del lab, wmap, dcoef
    return res


def gemm_checks(K2):
    """The Mix-FFN backward's GEMM at stage 3's products (C = 320, HC =
    1280, P = 8192 pixels): fc1 recomputed with its bias (NN), dln (NT), dW1
    (TN, stored transposed) and dW2 (TN): name -> (kernel, plain, make)."""
    c, p = STAGES[2][0], B * side(2) ** 2
    hc = 4 * c
    zeros = lambda *s: torch.zeros(s, device=DEV)
    mk = lambda seed, *shapes: lambda dt: [randn(s, gen(seed), 1.0, dt) for s in shapes]
    return {
        "h1": (lambda a, b, bias: K2.gemm_nn(a, b, bias),
               lambda a, b, bias: K2.gemm_nn_plain(a, b, bias), mk(180, (p, c), (c, hc), (hc,))),
        "dW1": (lambda a, b: K2.gemm_tn(a, b, zeros(c, hc), True),
                lambda a, b: K2.gemm_tn_plain(a, b, zeros(c, hc), True), mk(181, (p, hc), (p, c))),
        "dW2": (lambda a, b: K2.gemm_tn(a, b, zeros(hc, c)),
                lambda a, b: K2.gemm_tn_plain(a, b, zeros(hc, c)), mk(182, (p, hc), (p, c))),
        "dln": (lambda a, b: K2.gemm_nt(a, b), lambda a, b: K2.gemm_nt_plain(a, b),
                mk(183, (p, hc), (c, hc))),
    }


def ffn_phase_checks(K2):
    """K2f's phases at the main path's stage 4 (C = 512, HC = 2048, 32², batch
    2), each against its plain version on the same inputs: fc1 and fc2
    (``ffn_fc``, the GEMM's NN form with its bias, rounded once) and the
    stencil (``ffn_stencil``)."""
    c, s = STAGES[3][0], side(3)
    hc, p = 4 * c, B * s * s
    mk = lambda seed, *shapes: lambda dt: [randn(sh, gen(seed), sc, dt)  # noqa: E731
                                           for sh, sc in shapes]
    return {
        "ffn_fc:fc1_s4": check_pair(K2.ffn_fc, K2.ffn_fc_plain,
                                    mk(190, ((p, c), 1.0), ((c, hc), c ** -0.5), ((hc,), 0.1))),
        "ffn_stencil:s4": check_pair(K2.ffn_stencil, K2.ffn_stencil_plain,
                                     mk(191, ((B, s, s, hc), 1.0), ((3, 3, 1, hc), 1 / 3),
                                        ((hc,), 0.1))),
        "ffn_fc:fc2_s4": check_pair(K2.ffn_fc, K2.ffn_fc_plain,
                                    mk(192, ((p, hc), 1.0), ((hc, c), hc ** -0.5), ((c,), 0.1))),
    }


EDGE_S = 0.005  # idle seconds between the profiler's record window and any kernel
TRACE_FAILED = "the profiler kept no {n} matching calls in {tries} sessions"


def _matching_calls(evs, n):
    """``n`` consecutive calls that ran the same kernels, from a session's
    device events in start order: the longest sequence that a window of the
    events repeats ``n`` times, or None."""
    names = [e.name for e in evs]
    for k in range(len(names) // n, 0, -1):
        for off in range(len(names) - n * k + 1):
            first = names[off:off + k]
            if all(names[off + i * k:off + (i + 1) * k] == first for i in range(1, n)):
                return [evs[off + i * k:off + (i + 1) * k] for i in range(n)]
    return None


def kernel_trace(fn, n=5, tries=4):
    """The kernels one call of ``fn`` runs on the card, in launch order, as
    (name, ms), ms the profiler's kernel time averaged over ``n`` calls:
    without the host's gaps between launches, which CUDA events count where
    the host is the slower side. The profiler keeps only kernels that fall
    inside its record window on the host's clock, onto which it maps the
    card's, so a call at an edge may be lost or a warm-up kernel kept: the
    window records ``n + 2`` calls after one warm-up call, its edges kept
    clear of any kernel (``EDGE_S``, four times wider at each retry), and
    ``n`` consecutive calls with the same kernels are taken from inside it
    (``_matching_calls``). None after ``tries`` sessions without them."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kernel = torch.autograd.DeviceType.CUDA
    active = n + 2
    for attempt in range(tries):
        edge = EDGE_S * 4 ** attempt
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=active, repeat=1)) as prof:
            for i in range(active + 1):
                fn()
                torch.cuda.synchronize()
                if i in (0, active):
                    time.sleep(edge)
                prof.step()
                if i == 0:
                    time.sleep(edge)
        # device-side events, less the steps' annotations mirrored on the card
        evs = sorted((e for e in prof.events() if e.device_type == kernel
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
        calls = _matching_calls(evs, n)
        if calls:
            return [(calls[0][j].name, sum(c[j].time_range.elapsed_us() for c in calls) / n / 1e3)
                    for j in range(len(calls[0]))]
    return None


def device_ms(trace):
    """A call's kernel time in ms from its ``kernel_trace`` (None if none)."""
    return None if trace is None else sum(ms for _, ms in trace)


def phases_of(trace, first_nt="fc1_and_gW2_gemms"):
    """A call's kernel time by phase, in ms, grouped from its
    ``kernel_trace``: K2f (``ops/mixffn.py`` ffn_fwd: its two NN GEMMs are
    fc1 and fc2, around the stencil), K2b / K4b (ffn_bwd), K3b
    (``ops/block.py`` attn_bwd, ``first_nt="q_and_doh_gemms"``), K1b, K6f's
    two steps (statistics: the partial sums and the kernel that finishes
    them; logits), K6b's two passes or K7f's two launches (blocks, finish).
    Of a backward's NT and NN GEMM launches the first two
    are fc1 and g W2^T (K3b: q and doh), the third dln; the TN GEMM's two are
    dW1 and dW2 (dWq and dWo); K1b's core is its dq and dk/dv kernels;
    "torch" are PyTorch's own kernels (the sums' zero fills, K1b's casts of
    dk and dv, K6b's division of its sums by N)."""
    if trace is None:
        return None
    forward = any("ffn_stencil_kernel" in name for name, _ in trace)
    out, nt = {}, 0
    for name, ms in trace:
        if "ffn_stencil_kernel" in name:
            phase = "stencil"
        elif "ffn_bwd_prep_kernel" in name:
            phase = "prep"
        elif "ffn_bwd_tile_kernel" in name:
            phase = "tile"
        elif "ffn_bwd_ln_kernel" in name:
            phase = "ln_backward"
        elif "gemm_wgmma_kernel<1>" in name:  # TN
            phase = "weight_gradient_gemms"
        elif "gemm_wgmma_kernel" in name:     # NT or NN
            if forward:
                phase = "fc1" if nt == 0 else "fc2"
            else:
                phase = first_nt if nt < 2 else "dln_gemm"
            nt += 1
        elif "dq_kernel" in name:
            phase = "attention_dq"
        elif "dkdv_kernel" in name:
            phase = "attention_dkdv"
        elif "bwd_reduce_kernel" in name:
            phase = "reduce_pass"
        elif "bwd_ds_kernel" in name:
            phase = "ds_pass"
        elif "stats_kernel" in name or "stats_finish_kernel" in name:
            phase = "statistics"
        elif "logits_kernel" in name:
            phase = "logits"
        elif "loss_fwd_finish_kernel" in name:
            phase = "finish"
        elif "loss_fwd_kernel" in name or "loss_fwd_lanes_kernel" in name:
            phase = "blocks"
        else:
            phase = "torch"
        out[phase] = out.get(phase, 0.0) + ms
    return out


def argmax_check(K8, make=lambda dt: [argmax_inputs(dt)], out_hw=(IMG, IMG)):
    """K8 against ``resize_argmax_plain`` on ``make(dtype)``'s logits: the
    front end samples the plain version's logits bit for bit, so the labels
    must be equal at every pixel, near-ties included, float32 and bf16."""
    from segmentation_factory_tpu_torch.models.layers import resize

    out = {}
    ok = True
    for dt in (torch.float32, torch.bfloat16):
        (lo,) = make(dt)
        got = K8.resize_argmax_to(lo, out_hw)
        want = K8.resize_argmax_plain(lo, out_hw)
        top = torch.topk(resize(lo.float(), out_hw), 2, dim=-1).values
        tie = (top[..., 0] - top[..., 1]) < TIE_GAP
        diff = got != want
        name = "f32" if dt == torch.float32 else "bf16"
        out[f"{name}_mismatch_outside_ties"] = int((diff & ~tie).sum())
        out[f"{name}_mismatch"] = int(diff.sum())
        out[f"{name}_near_ties"] = int(tie.sum())
        out[f"{name}_max_abs_err"] = float((got - want).abs().max())
        ok = ok and out[f"{name}_mismatch"] == 0 and got.dtype == torch.int32
        del top, tie
    out["ok"] = ok
    return out


def loss_fwd_checks(K7, lab, make, tag):
    """K7f's loss map and dice partials against ``lowres_loss_plain``
    (``check_pair``'s bars), and its partials and loss map the same bits in
    two calls (no atomics)."""
    res = {}
    for j, part in enumerate(("loss_map", "dice_partials")):
        res[f"lowres_loss_fwd:{part}_{tag}"] = check_pair(
            lambda lo, j=j: K7.lowres_loss_fwd(lo, lab)[j],
            lambda lo, j=j: K7.lowres_loss_plain(lo, lab)[j], make)
    same = True
    for dt in (torch.float32, torch.bfloat16):
        (lo,) = make(dt)
        (la, pa), (lb, pb) = K7.lowres_loss_fwd(lo, lab), K7.lowres_loss_fwd(lo, lab)
        same = same and torch.equal(pa, pb) and torch.equal(la, lb)
    torch.cuda.synchronize()
    res[f"lowres_loss_fwd:deterministic_{tag}"] = {"same_bits_f32_bf16": same, "ok": same}
    return res


def pinned_logits(path, train=True):
    """The head-resolution logits a pinned config's model hands the loss and
    K8: ``build_model`` at the config's backbone, head, classes and width,
    bfloat16, weights from the config's seed, on the config's batch of
    ``Synthetic`` images of its classes and size (normalized as the
    Trainer's eval). Returns (the training forward's float32 logits, as
    ``train_step`` hands K7f / K7b, or None; the eval forward's, as
    ``predict_step`` hands K8; the int32 labels)."""
    import numpy as np

    from segmentation_factory_tpu_torch import build_model
    from segmentation_factory_tpu_torch.config import TrainConfig
    from segmentation_factory_tpu_torch.data.datasets import Synthetic
    from segmentation_factory_tpu_torch.data.transforms import preprocess_eval

    with open(Path(__file__).resolve().parent / path) as f:
        cfg = TrainConfig.from_json(f.read())
    m, d = cfg.model, cfg.data
    ds = Synthetic(m.num_classes, d.img_size, length=d.batch_size, seed=0)
    imgs, labs = zip(*(ds.load(i) for i in range(len(ds))))
    x = preprocess_eval(torch.from_numpy(np.stack(imgs)).to(DEV))
    lab = torch.from_numpy(np.stack(labs)).to(DEV, torch.int32)
    model = build_model(m.backbone, m.head, m.num_classes, embed_dim=m.embed_dim, device=DEV,
                        seed=cfg.seed)
    with torch.no_grad():
        lo_eval = model(x, resize_output=False)
        lo_train = None
        if train:
            lo_train = model.train()(x, resize_output=False, generator=gen(cfg.seed + 1))
    del model, x
    torch.cuda.empty_cache()
    return lo_train, lo_eval, lab


def pinned_checks(K7, K8):
    """K7f (loss map and dice partials, and their bits across two calls),
    K7b (the fused criterion's gradient, CE + dice as config #2 trains) and
    K8 on the logits config #2's model hands them (16 images at 512², 150
    classes), and K8 on config #3's (2 classes), against the plain versions
    under the bars above; the bf16 cases take the same logits cast."""
    res = {}
    lo_train, lo_eval, lab = pinned_logits(CONFIG2)
    res.update(loss_fwd_checks(K7, lab, lambda dt: [lo_train.to(dt)], "config2"))
    res["lowres_loss_bwd:config2"] = check_grads(
        lambda lo: K7.lowres_criterion(lo, lab, IGNORE, True, "ce"),
        lambda lo: K7.fused_criterion_plain(lo, lab, "ce", True, IGNORE),
        lambda dt: ([lo_train.to(dt)], torch.ones((), device=DEV)))
    res["resize_argmax:config2"] = argmax_check(K8, lambda dt: [lo_eval.to(dt)],
                                                tuple(lab.shape[1:]))
    res["resize_argmax:config2"]["logits"] = list(lo_eval.shape)
    del lo_train, lo_eval, lab
    _, lo_eval, lab = pinned_logits(CONFIG3, train=False)
    res["resize_argmax:config3"] = argmax_check(K8, lambda dt: [lo_eval.to(dt)],
                                                tuple(lab.shape[1:]))
    res["resize_argmax:config3"]["logits"] = list(lo_eval.shape)
    del lo_eval, lab
    torch.cuda.empty_cache()
    return res


def config4_checks(K1, K2, K3):
    """K1f / K1b at config #4's stage 4 (24 images, N = M = 49, 8 heads of
    64), K3f / K3b and K4f / K4b at its stages 1-3 (56², 28², 14² maps, M =
    49, image 0 dropped) and K2b at its 7 x 7 stage 4, float32 and bf16: the
    49 keys sit in a 64-row tile, so each check also holds the masking of
    the tile's last 15 rows and that no tile reads the next image's or
    head's rows; K4f's 64-pixel tiles (of one image each) are cut by the
    map's edge at 28² and 14², which no main-path map does."""
    geo = {"batch": SYNAPSE_BATCH, "img": SYNAPSE_IMG}
    res = {}
    k1 = lambda q, k, v: K1.sra_attention(q, k, v, 0.125)  # noqa: E731
    p1 = lambda q, k, v: K1.sra_attention_plain(q, k, v, 0.125)  # noqa: E731
    res["sra_attention:s4_config4"] = check_pair(k1, p1, lambda dt: attn_inputs(3, dt, **geo))
    res["sra_attention_bwd:s4_config4"] = check_grads(
        k1, p1, bwd_inputs(lambda dt: attn_inputs(3, dt, **geo), lambda x: x[0].shape, 1040))
    res["mixffn_bwd:s4_7x7"] = check_grads(
        K2.mixffn_apply, K2.mixffn_plain,
        bwd_inputs(lambda dt: ffn_inputs(3, dt, batch=SYNAPSE_BATCH, s=SYNAPSE_S4, seed=1020),
                   lambda x: x[0].shape, 1030))
    fac = block_fac(SYNAPSE_BATCH)
    for i in range(3):
        heads = STAGES[i][1]
        k3 = lambda *a, h=heads: K3.attn_block_apply(*a, fac, h, 0.125)  # noqa: E731
        p3 = lambda *a, h=heads: K3.attn_block_plain(*a, fac, h, 0.125)  # noqa: E731
        make = lambda dt, i=i: attn_block_inputs(i, dt, **geo)  # noqa: E731
        res[f"attn_block:s{i + 1}_config4"] = check_pair(k3, p3, make)
        res[f"attn_block_bwd:s{i + 1}_config4"] = check_grads(
            k3, p3, bwd_inputs(make, lambda x: x[0].shape, 1050 + i))
        k4 = lambda *a: K3.ffn_block_apply(*a, fac)  # noqa: E731
        p4 = lambda *a: K3.ffn_block_plain(*a, fac)  # noqa: E731
        make = lambda dt, i=i: ffn_block_inputs(i, dt, **geo)  # noqa: E731
        res[f"ffn_block:s{i + 1}_config4"] = check_pair(k4, p4, make)
        res[f"ffn_block_bwd:s{i + 1}_config4"] = check_grads(
            k4, p4, bwd_inputs(make, lambda x: x[0].shape, 1060 + i))
    torch.cuda.empty_cache()
    return res


def phase_check(ops):
    K1, K2, K3, K5, K7, K8, K6 = ops
    res = {"phase": "check"}
    for i in range(4):
        res[f"sra_attention:s{i + 1}"] = check_pair(
            lambda q, k, v: K1.sra_attention(q, k, v, 0.125),
            lambda q, k, v: K1.sra_attention_plain(q, k, v, 0.125),
            lambda dt, i=i: attn_inputs(i, dt))
        res[f"sra_attention_bwd:s{i + 1}"] = check_grads(
            lambda q, k, v: K1.sra_attention(q, k, v, 0.125),
            lambda q, k, v: K1.sra_attention_plain(q, k, v, 0.125),
            bwd_inputs(lambda dt, i=i: attn_inputs(i, dt), lambda x: x[0].shape, 50 + i))
        res[f"mixffn:s{i + 1}"] = check_pair(
            K2.mixffn_apply, K2.mixffn_plain, lambda dt, i=i: ffn_inputs(i, dt))
        res[f"mixffn_bwd:s{i + 1}"] = check_grads(
            K2.mixffn_apply, K2.mixffn_plain,
            bwd_inputs(lambda dt, i=i: ffn_inputs(i, dt), lambda x: x[0].shape, 60 + i))
        res[f"mixffn:s{i + 1}_b0"] = check_pair(
            K2.mixffn_apply, K2.mixffn_plain, lambda dt, i=i: ffn_inputs(i, dt, b0=True))
        # MiT-B0: head dim 32
        sc = 32 ** -0.5
        res[f"sra_attention:s{i + 1}_d32"] = check_pair(
            lambda q, k, v: K1.sra_attention(q, k, v, sc),
            lambda q, k, v: K1.sra_attention_plain(q, k, v, sc),
            lambda dt, i=i: attn_inputs(i, dt, b0=True))
        res[f"sra_attention_bwd:s{i + 1}_d32"] = check_grads(
            lambda q, k, v: K1.sra_attention(q, k, v, sc),
            lambda q, k, v: K1.sra_attention_plain(q, k, v, sc),
            bwd_inputs(lambda dt, i=i: attn_inputs(i, dt, b0=True), lambda x: x[0].shape,
                       250 + i))
    # K2f at config #4's stage 4 (7 x 7, batch 24), and its phases at the
    # main path's stage 4, each against its plain version
    res["mixffn:s4_7x7"] = check_pair(
        K2.mixffn_apply, K2.mixffn_plain,
        lambda dt: ffn_inputs(3, dt, batch=SYNAPSE_BATCH, s=SYNAPSE_S4, seed=1020))
    res.update(ffn_phase_checks(K2))
    res.update(config4_checks(K1, K2, K3))
    fac = block_fac()
    # MiT-B2 at stages 1-3; MiT-B0 at all four (its stage 4, C = 256 with M
    # = N, is within K3's and K4's widths)
    for i, b0 in [(i, b0) for i in range(4) for b0 in (False, True) if b0 or i < 3]:
        heads = (B0_STAGES if b0 else STAGES)[i][1]
        sc, tag = (32 ** -0.5, "_d32") if b0 else (0.125, "")
        k3 = lambda *a, h=heads, sc=sc: K3.attn_block_apply(*a, fac, h, sc)
        p3 = lambda *a, h=heads, sc=sc: K3.attn_block_plain(*a, fac, h, sc)
        res[f"attn_block:s{i + 1}{tag}"] = check_pair(
            k3, p3, lambda dt, i=i, b0=b0: attn_block_inputs(i, dt, b0))
        res[f"attn_block_bwd:s{i + 1}{tag}"] = check_grads(
            k3, p3, bwd_inputs(lambda dt, i=i, b0=b0: attn_block_inputs(i, dt, b0),
                               lambda x: x[0].shape, 130 + i + 200 * b0))
        tag = "_b0" if b0 else ""
        k4 = lambda *a: K3.ffn_block_apply(*a, fac)
        p4 = lambda *a: K3.ffn_block_plain(*a, fac)
        res[f"ffn_block:s{i + 1}{tag}"] = check_pair(
            k4, p4, lambda dt, i=i, b0=b0: ffn_block_inputs(i, dt, b0))
        res[f"ffn_block_bwd:s{i + 1}{tag}"] = check_grads(
            k4, p4, bwd_inputs(lambda dt, i=i, b0=b0: ffn_block_inputs(i, dt, b0),
                               lambda x: x[0].shape, 140 + i + 200 * b0))
    for name, (kern, plain, make) in gemm_checks(K2).items():
        res[f"ffn_bwd_gemm:{name}"] = check_pair(kern, plain, make)
    res["resize_sum:head"] = check_pair(lambda *z: K5.resize_sum(list(z)),
                                   lambda *z: K5.resize_sum_plain(list(z)), sum_inputs)
    res["resize_sum_bwd:head"] = check_grads(
        lambda *z: K5.resize_sum(list(z)), lambda *z: K5.resize_sum_plain(list(z)),
        bwd_inputs(sum_inputs, lambda x: x[-1].shape, 70))
    dm = tail_mask()
    for j, name in enumerate(("logits", "mean", "var")):
        res[f"head_tail:{name}"] = check_pair(
            lambda *a, j=j: K6.head_tail_train(*a[:3], dm, *a[3:], 1e-5)[j],
            lambda *a, j=j: K6.head_tail_plain(*a[:3], dm, *a[3:], 1e-5)[j], tail_inputs)
    # the logits' cotangent stays float32 (the logits are float32 in both)
    res["head_tail_bwd:train"] = check_grads(
        lambda *a: K6.head_tail_train(*a[:3], dm, *a[3:], 1e-5)[0],
        lambda *a: K6.head_tail_plain(*a[:3], dm, *a[3:], 1e-5)[0],
        lambda dt: (tail_inputs(dt), randn((B, TAIL_SIDE, TAIL_SIDE, NC), gen(172))))
    # config #1's head (16 images at 128², E = 256, 21 classes) and config
    # #4's (24 images at 56², E = 768, 9 classes)
    for tag, (vb, vs, ve, vnc), seed in (("voc", VOC_TAIL, 174), ("synapse", SYNAPSE_TAIL, 176)):
        dm = tail_mask(vb, ve)
        make = lambda dt, vb=vb, vs=vs, ve=ve, vnc=vnc, seed=seed: tail_inputs(  # noqa: E731
            dt, vb, vs, ve, vnc, seed=seed)
        for j, name in enumerate(("logits", "mean", "var")):
            res[f"head_tail:{name}_{tag}"] = check_pair(
                lambda *a, j=j, dm=dm: K6.head_tail_train(*a[:3], dm, *a[3:], 1e-5)[j],
                lambda *a, j=j, dm=dm: K6.head_tail_plain(*a[:3], dm, *a[3:], 1e-5)[j], make)
        res[f"head_tail_bwd:{tag}"] = check_grads(
            lambda *a, dm=dm: K6.head_tail_train(*a[:3], dm, *a[3:], 1e-5)[0],
            lambda *a, dm=dm: K6.head_tail_plain(*a[:3], dm, *a[3:], 1e-5)[0],
            lambda dt, make=make, vb=vb, vs=vs, vnc=vnc, seed=seed: (
                make(dt), randn((vb, vs, vs, vnc), gen(seed + 1))))
        del dm
    lab = loss_labels()
    res.update(loss_fwd_checks(K7, lab, lambda dt: [argmax_inputs(dt)], "head"))
    for lt in ("ce", "ohem"):
        res[f"lowres_loss_bwd:{lt}"] = check_grads(
            lambda lo, lt=lt: K7.lowres_criterion(lo, lab, IGNORE, True, lt),
            lambda lo, lt=lt: K7.fused_criterion_plain(lo, lab, lt, True, IGNORE),
            lambda dt: ([argmax_inputs(dt)], torch.ones((), device=DEV)))
    lab, wmap, dcoef = loss_bwd_inputs(B, NC, IMG, IMG, 199)
    res["lowres_loss_bwd:head"] = check_pair(
        lambda lo: K7.lowres_loss_bwd(lo, lab, wmap, dcoef),
        lambda lo: K7.lowres_loss_bwd_plain(lo, lab, wmap, dcoef),
        lambda dt: [argmax_inputs(dt)])
    del lab, wmap, dcoef
    res.update(transpose_checks(K5, K7, K8))
    res["resize_argmax:head"] = argmax_check(K8)
    res.update(pinned_checks(K7, K8))
    res["ok"] = all(v["ok"] for v in res.values() if isinstance(v, dict))
    return res


@contextlib.contextmanager
def plain_path():
    """Route the model through the plain versions (the comparison run)."""
    from segmentation_factory_tpu_torch.engine import steps
    from segmentation_factory_tpu_torch.models.backbones import metaformer, mit
    from segmentation_factory_tpu_torch.models.heads import segformer
    from segmentation_factory_tpu_torch.models.layers import msdeformattn
    from segmentation_factory_tpu_torch.ops import (
        block, head_tail, lowres_loss, mixffn, msdeform, resize_argmax, resize_sum,
        sra_attention)

    def plain_criterion(lo, labels, ignore_index=IGNORE, use_dice=True, loss_type="ce",
                        class_weights=None):
        key = loss_type.lower().replace("_", "")
        return lowres_loss.fused_criterion_plain(lo, labels, key, use_dice, ignore_index,
                                                 class_weights)

    patches = [(mit, "sra_attention", sra_attention.sra_attention_plain),
               (metaformer, "sra_attention", sra_attention.sra_attention_plain),
               (mit, "mixffn_apply", mixffn.mixffn_plain),
               (mit, "attn_block_apply", block.attn_block_plain),
               (mit, "ffn_block_apply", block.ffn_block_plain),
               (segformer, "resize_sum", resize_sum.resize_sum_plain),
               (segformer, "head_tail_train", head_tail.head_tail_plain),
               (steps, "resize_argmax_to", resize_argmax.resize_argmax_plain),
               (msdeformattn, "ms_deform_attn", msdeform.ms_deform_attn_plain),
               (lowres_loss, "lowres_criterion", plain_criterion)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, f in patches:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def images(seed):
    g = gen(seed)
    img = torch.randn((B, IMG, IMG, 3), generator=g, device=DEV)
    lab = torch.randint(0, NC, (B, IMG, IMG), generator=g, device=DEV, dtype=torch.int32)
    lab[:, :16] = 255
    return img, lab


def agreement(a, b, logits=None):
    same = (a == b)
    res = {"agree": float(same.float().mean())}
    if logits is not None:
        top = torch.topk(logits, 2, dim=-1).values
        gap = top[..., 0] - top[..., 1]
        res["gap_median"] = float(gap.median())
        res["disagree_gap_max"] = float(gap[~same].max()) if (~same).any() else 0.0
    return res


def phase_serve(KERNELS, fused=True, n_predict=3):
    from segmentation_factory_tpu_torch import build_model
    from segmentation_factory_tpu_torch.engine import eval_step, predict_step
    from segmentation_factory_tpu_torch.metrics import compute_metrics
    from segmentation_factory_tpu_torch.models.layers import resize
    from segmentation_factory_tpu_torch.ops import mixffn

    phases = {k: getattr(mixffn, k) for k in FFN_FWD_PHASES}
    res = {"phase": "serve" if fused else "serve_per_op", "model": "mit_b2+segformerhead",
           "fused_blocks": fused, "embed_dim": 768, "batch": B, "image": IMG, "classes": NC,
           "dtype": "bfloat16"}
    model = build_model("mit_b2", "segformerhead", NC, seed=0, device=DEV,
                        fused_blocks=fused)  # bf16
    batches = [images(100 + i) for i in range(n_predict)]
    eval_img, eval_lab = images(200)
    predict_step(model, batches[0][0])  # first launches load the libraries
    torch.cuda.synchronize()

    for fn in (*KERNELS.values(), *phases.values()):
        fn.launches = 0
    preds = [predict_step(model, img) for img, _ in batches]
    hist = eval_step(model, {"image": eval_img, "label": eval_lab},
                     torch.zeros((NC, NC), dtype=torch.int64, device=DEV))
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    phase_counts = {k: fn.launches for k, fn in phases.items()}
    forwards = n_predict + 1
    res["launches"] = counts
    res["phase_launches"] = phase_counts
    res["forwards"] = forwards
    want = PER_FORWARD if fused else PER_FORWARD_PER_OP
    res["launches_ok"] = (all(counts[k] == want.get(k, 0) * forwards for k in counts)
                          and phase_counts == ffn_fwd_phases(want["mixffn"] * forwards))
    shapes_ok = all(p.shape == (B, IMG, IMG) and p.dtype == torch.int32
                    and int(p.min()) >= 0 and int(p.max()) < NC for p in preds)
    valid = int((eval_lab < NC).sum())
    res["hist_total"] = int(hist.sum())
    res["hist_ok"] = res["hist_total"] == valid
    res["mIoU_random_weights"] = compute_metrics(hist)["mIoU"]

    # the same weights in float32: kernels, then plain versions, on the card
    m32 = build_model("mit_b2", "segformerhead", NC, dtype=torch.float32, seed=0, device=DEV,
                      fused_blocks=fused)
    img0 = batches[0][0]
    with torch.inference_mode():
        lo_k = m32(img0, resize_output=False)
        lab_k32 = predict_step(m32, img0)
        with plain_path():
            lo_p = m32(img0, resize_output=False)
            lab_p32 = predict_step(m32, img0)
        lo_16 = model(img0, resize_output=False)
        up_p = resize(lo_p, (IMG, IMG))
    res["f32_kernels_vs_plain"] = agreement(lab_k32, lab_p32, up_p)
    res["f32_logits_max_abs_err"] = max_err(lo_k, lo_p)
    res["logit_scale"] = float(lo_p.abs().max())
    res["bf16_vs_f32_plain"] = agreement(preds[0], lab_p32, up_p)
    res["bf16_logits_max_abs_err"] = max_err(lo_16, lo_p)
    # bf16 labels may differ from the float32 ones only where the float32
    # top-2 gap is within twice the measured bf16 logit error (the upsample
    # is a convex combination, so it cannot grow that error)
    bf16_ok = (res["bf16_vs_f32_plain"]["disagree_gap_max"]
               <= 2 * res["bf16_logits_max_abs_err"])
    finite = bool(torch.isfinite(lo_16).all() and torch.isfinite(lo_k).all())
    res["ok"] = (res["launches_ok"] and shapes_ok and res["hist_ok"] and finite
                 and res["f32_kernels_vs_plain"]["agree"] >= AGREE and bf16_ok)
    del m32, up_p
    return res, model, counts


def make_trainer(dtype=torch.bfloat16, fused=True, remat=False):
    """MiT-B2 + SegFormerHead and config #5's optimizer from its first
    update: AdamW, weight decay 1e-4, AGC 0.02, cosine to lr 1e-3 after
    1500 warm-up steps from 1e-6. ``remat`` checkpoints the backbone."""
    from segmentation_factory_tpu_torch import build_model
    from segmentation_factory_tpu_torch.engine import create_optimizer
    from segmentation_factory_tpu_torch.schedule import create_schedule

    model = build_model("mit_b2", "segformerhead", NC, dtype=dtype, seed=0, device=DEV,
                        fused_blocks=fused, remat=remat)
    sched = create_schedule("cosine", 1e-3, total_steps=300 * 372, warmup_steps=WARMUP,
                            warmup_lr_init=1e-6, min_lr=1e-5)
    opt = create_optimizer("adamw", sched, weight_decay=1e-4, clip_grad=0.02, clip_mode="agc",
                           params=model.named_parameters())
    return model, opt


def phase_train(KERNELS, fused=True, n_steps=TRAIN_STEPS):
    from segmentation_factory_tpu_torch.engine import compute_loss, train_step

    phases = {k: phase_function(k) for k in PHASES_PER_STEP}

    res = {"phase": "train" if fused else "train_per_op", "model": "mit_b2+segformerhead",
           "fused_blocks": fused, "embed_dim": 768, "batch": B,
           "image": IMG, "classes": NC, "dtype": "bfloat16", "params": "float32",
           "loss": "ohem+dice", "optimizer": "adamw wd 1e-4, agc 0.02",
           "schedule": f"cosine lr 1e-3, warmup {WARMUP} from 1e-6, from update 0",
           "noise": "the same drop-path and dropout draws every step"}
    model, opt = make_trainer(fused=fused)
    batch = train_batch()

    def step():
        # one fixed draw of the random masks, so that the loss trajectory
        # shows the updates and not the masks' noise
        g = torch.Generator(device=DEV).manual_seed(0)
        return train_step(model, opt, batch, generator=g, loss_type="ohem", use_dice=True)

    losses, lrs, skipped, counts, phase_counts = [], [], [], [], []
    for _ in range(n_steps):
        for fn in (*KERNELS.values(), *phases.values()):
            fn.launches = 0
        out = step()
        torch.cuda.synchronize()
        counts.append({k: fn.launches for k, fn in KERNELS.items()})
        phase_counts.append({k: fn.launches for k, fn in phases.items()})
        losses.append(float(out["loss"]))
        lrs.append(float(out["lr"]))
        skipped.append(int(out["skipped_nonfinite"]))
    res.update(losses=losses, lrs=lrs, skipped=skipped, launches_per_step=counts,
               phase_launches_per_step=phase_counts)
    want = PHASES_PER_STEP if fused else PHASES_PER_STEP_PER_OP
    res["launches_ok"] = (all(c == (PER_STEP if fused else PER_STEP_PER_OP) for c in counts)
                          and all(c == want for c in phase_counts))
    finite = all(math.isfinite(v) for v in losses) and not any(skipped)
    res["loss_falls"] = losses[-1] < losses[0]

    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    res["train_images_per_s"] = n * B / (time.perf_counter() - t0)
    res["profile"] = profile_step(step) if fused else None
    del model, opt

    # float32: one step's loss and gradients through the kernels, then through
    # the plain versions, on the same weights, batch and noise
    m32, _ = make_trainer(torch.float32, fused)
    m32.train()
    noise = m32.sample_noise(B, torch.Generator(device=DEV).manual_seed(1))
    params = [p for _, p in m32.named_parameters()]

    def loss_and_grads():
        logits = m32(batch["image"], resize_output=False, noise=noise)
        loss = compute_loss(logits, batch["label"], IGNORE, "ohem", True)
        return loss.detach(), torch.autograd.grad(loss, params)

    lk, gk = loss_and_grads()
    with plain_path():
        lp, gp = loss_and_grads()
    res["f32_loss_kernels"], res["f32_loss_plain"] = float(lk), float(lp)
    res["f32_loss_rel_err"] = abs(float(lk) - float(lp)) / abs(float(lp))
    grads = grad_check(m32, gk, gp)
    res["f32_grad_worst_err_over_bar"] = grads["worst_err_over_bar"]
    res["f32_grad_worst_param"] = grads["worst_param"]
    res["f32_grad_bar"] = {"rel": GRAD_REL, "abs_of_largest": GRAD_ABS}
    res["ok"] = (res["launches_ok"] and finite and res["loss_falls"]
                 and res["f32_loss_rel_err"] <= LOSS_REL and grads["ok"])
    return res


def grad_check(model, gk, gp):
    """Each parameter's float32 gradient through the kernels (``gk``) against
    the plain versions' (``gp``, a zero tensor where a parameter has no
    gradient in either) under phase train's bar: within ``GRAD_REL`` of its
    largest plain entry plus ``GRAD_ABS`` of the model's largest. Returns
    the verdict, the worst error over its bar and its parameter, the count
    of tensors over their bars and the relative L2 distance of all the
    gradients from the plain ones."""
    zero = lambda g, p: torch.zeros_like(p) if g is None else g  # noqa: E731
    params = [p for _, p in model.named_parameters()]
    gk = [zero(g, p) for g, p in zip(gk, params)]
    gp = [zero(g, p) for g, p in zip(gp, params)]
    floor = GRAD_ABS * max(b.abs().max().item() for b in gp)
    worst, worst_name, over = 0.0, None, 0
    for (name, _), a, b in zip(model.named_parameters(), gk, gp):
        ratio = max_err(a, b) / (GRAD_REL * b.abs().max().item() + floor)
        over += ratio > 1
        if ratio > worst:
            worst, worst_name = ratio, name
    dist = math.sqrt(sum(float(((a - b).double() ** 2).sum()) for a, b in zip(gk, gp)))
    norm = math.sqrt(sum(float((b.double() ** 2).sum()) for b in gp))
    return {"ok": over == 0, "worst_err_over_bar": worst, "worst_param": worst_name,
            "over_bar": over, "total": len(gp), "rel_l2": dist / norm}


def train_turns(n=3):
    """Train images/s of the two configurations in turns (fused, per-op,
    per-op, fused), each ``n`` steps of the train cell's step."""
    from segmentation_factory_tpu_torch.engine import train_step

    batch = train_batch()
    steps = {}
    for fused in (True, False):
        model, opt = make_trainer(fused=fused)
        steps[fused] = lambda m=model, o=opt: train_step(
            m, o, batch, generator=torch.Generator(device=DEV).manual_seed(0),
            loss_type="ohem", use_dice=True)
        steps[fused]()  # warm
    torch.cuda.synchronize()
    ips = []
    for fused in (True, False, False, True):
        t0 = time.perf_counter()
        for _ in range(n):
            steps[fused]()
        torch.cuda.synchronize()
        ips.append(n * B / (time.perf_counter() - t0))
    return ips


def phase_times(ops, model, model_per_op):
    K1, K2, K3, K5, K7, K8, K6 = ops
    from segmentation_factory_tpu_torch.engine import predict_step

    per_shape, by_phase = [], []
    totals, totals_per_op = {}, {}

    def add(name, shape, per_fwd, kern, plain, lib, flops, nbytes, per_op=None, peak=PEAK_BF16,
            total=True):
        """One kernel at one shape; ``per_fwd`` its launches per step (per
        forward for K8) in the fused configuration, ``per_op`` in the per-op
        one (the same when None); ``peak`` the FLOP/s its products run at.
        Times the kernel and the library call both by CUDA events ("ms",
        "library_ms") and by the profiler's kernel time ("device_ms",
        "library_device_ms"); returns the kernel's ``kernel_trace``. A shape
        of another config (``total=False``) stays out of the main path's
        totals."""
        trace = kernel_trace(kern)
        times = {"ms": cuda_ms(kern), "device_ms": device_ms(trace), "plain_ms": cuda_ms(plain),
                 "library_ms": None, "library_device_ms": None}
        lib_trace = None
        if lib is not None:
            lib_trace = kernel_trace(lib)
            times.update(library_ms=cuda_ms(lib), library_device_ms=device_ms(lib_trace))
        failed = [k for k, t in (("device_ms", trace), ("library_device_ms", lib_trace))
                  if t is None and (k == "device_ms" or lib is not None)]
        b_ms, by, ops_ms, bytes_ms = bound_ms(flops, nbytes, peak)
        per_op = per_fwd if per_op is None else per_op
        per_shape.append({"kernel": name, "shape": shape, "launches_per_step": per_fwd,
                          "launches_per_step_per_op": per_op, **times, "bound_ms": b_ms,
                          "bound_by": by, "peak_flops": peak,
                          "null_because": {k: TRACE_FAILED.format(n=5, tries=4)
                                           for k in failed} or None})
        for tot, n in ((totals, per_fwd), (totals_per_op, per_op)) if total else ():
            t = tot.setdefault(name, {**{k: None if v is None else 0.0 for k, v in times.items()},
                                      "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0})
            # a total is None once one of its shapes' times is
            for k, v in times.items():
                t[k] = None if t[k] is None or v is None else t[k] + n * v
            t["bound_ms"] += n * b_ms
            t["ops_ms"] += n * ops_ms
            t["bytes_ms"] += n * bytes_ms
        return trace

    bf = torch.bfloat16

    def backward_of(fn, args, g):
        """A closure running only the backward of ``fn`` through autograd."""
        args = [a.detach().requires_grad_() for a in args]
        out = fn(*args)
        return lambda: torch.autograd.grad(out, args, g, retain_graph=True)

    for i, (dim, heads, depth) in enumerate(STAGES):
        fused_n = depth if i == 3 else 0  # K1/K2 launches in the fused configuration
        q, k, v = attn_inputs(i, bf)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        n, m, s = side(i) ** 2, kv_side() ** 2, side(i)
        shape = f"q(2,{n},{heads},64) kv(2,{m},{heads},64) bf16"
        add("sra_attention", shape, fused_n,
            lambda: K1.sra_attention(q, k, v, 0.125),
            lambda: K1.sra_attention_plain(q, k, v, 0.125),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=0.125),
            4.0 * B * heads * n * m * 64, 2 * (2 * q.numel() + k.numel() + v.numel()),
            depth)
        g = randn(q.shape, gen(80 + i), dtype=bf)
        lse = torch.empty((B, heads, n), dtype=torch.float32, device=DEV)
        o = K1._forward(q, k, v, 0.125, lse)
        trace = add("sra_attention_bwd", shape, fused_n,
            lambda: K1.sra_attention_bwd(q, k, v, o, lse, g, 0.125),
            backward_of(lambda *a: K1.sra_attention_plain(*a, 0.125), [q, k, v], g),
            backward_of(lambda *a: F.scaled_dot_product_attention(*a, scale=0.125),
                        [qt, kt, vt], g.transpose(1, 2).contiguous()),
            10.0 * B * heads * n * m * 64,
            2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(), depth)
        by_phase.append({"kernel": "sra_attention_bwd", "stage": i + 1,
                         "device_ms": phases_of(trace)})
        del q, k, v, qt, kt, vt, g, o, lse
        args = ffn_inputs(i, bf)
        c, hc, p = dim, 4 * dim, B * s * s
        trace = add("mixffn", f"y(2,{s},{s},{c}) hc={hc} bf16", fused_n,
                    lambda: K2.mixffn_apply(*args), lambda: K2.mixffn_plain(*args), None,
                    p * (4.0 * c * hc + 18.0 * hc), 2 * (2 * args[0].numel() + sum(
                        t.numel() for t in args[1:])), depth)
        # beyond the bound's bytes, the phases write h and g and read them
        # back: 2 bytes each way, P HC elements each
        hg_bytes = 2 * 2 * 2 * p * hc
        by_phase.append({"kernel": "mixffn", "stage": i + 1, "device_ms": phases_of(trace),
                         "h_g_bytes": hg_bytes, "h_g_ms_at_hbm": hg_bytes / HBM * 1e3})
        g = randn(args[0].shape, gen(90 + i), dtype=bf)
        wbytes = sum(t.numel() for t in args[1:])
        trace = add("mixffn_bwd", f"y(2,{s},{s},{c}) hc={hc} bf16", fused_n,
                    lambda: K2.mixffn_bwd(*args[:6], g), backward_of(K2.mixffn_plain, args, g),
                    None, p * (10.0 * c * hc + 60.0 * hc),
                    2 * 3 * args[0].numel() + 2 * wbytes + 4 * wbytes, depth)
        by_phase.append({"kernel": "mixffn_bwd", "stage": i + 1,
                         "device_ms": phases_of(trace)})
        del args, g
        if i == 3:  # stage 4 stays per-op
            continue
        # K3 / K4: the products each function needs. K3f: q proj, S, PV, out
        # proj; K3b (o and lse saved by K3f): q recompute, doh, dWo, dWq, dln,
        # S, dP, dV, dQ, dK; K4f: fc1, fc2; K4b as K2b: fc1 recompute, g W2^T,
        # dW2, dW1, dln. Bytes: each input read and each output written once
        # (the parameters' gradients in float32)
        fac = block_fac()
        a3 = attn_block_inputs(i, bf)
        x, kk = a3[0], a3[1]
        wb = 2 * (2 * dim * dim + 2 * dim) + 8 * dim
        shape = f"x(2,{s},{s},{dim}) kv(2,{m},{dim}) heads={heads} bf16"
        add("attn_block", shape, depth,
            lambda: K3.attn_block_apply(*a3, fac, heads, 0.125),
            lambda: K3.attn_block_plain(*a3, fac, heads, 0.125), None,
            4.0 * B * n * m * dim + 4.0 * B * n * dim * dim,
            2 * (2 * x.numel() + 2 * kk.numel()) + wb + 4 * B, 0)
        g = randn(x.shape, gen(150 + i), dtype=bf)
        o = torch.empty_like(x)
        lse = torch.empty((B, heads, n), dtype=torch.float32, device=DEV)
        K3._attn_forward(*a3, fac, heads, 0.125, o, lse)
        trace = add("attn_block_bwd", shape, depth,
            lambda: K3.attn_block_bwd(*a3[:8], fac, g, o, lse, heads, 0.125),
            backward_of(lambda *a: K3.attn_block_plain(*a, fac, heads, 0.125), a3, g), None,
            B * n * (10.0 * dim * dim + 10.0 * m * dim),
            2 * (4 * x.numel() + 2 * kk.numel()) + 4 * (2 * kk.numel() + lse.numel())
            + wb + 2 * wb, 0)
        by_phase.append({"kernel": "attn_block_bwd", "stage": i + 1,
                         "device_ms": phases_of(trace, "q_and_doh_gemms")})
        del a3, x, kk, g, o, lse
        a4 = ffn_block_inputs(i, bf)
        wbytes = 2 * sum(t.numel() for t in a4[3:]) + 8 * dim
        shape = f"x(2,{s},{s},{dim}) hc={hc} bf16"
        add("ffn_block", shape, depth, lambda: K3.ffn_block_apply(*a4, fac),
            lambda: K3.ffn_block_plain(*a4, fac), None,
            p * (4.0 * dim * hc + 20.0 * hc), 2 * 2 * a4[0].numel() + wbytes + 4 * B, 0)
        g = randn(a4[0].shape, gen(160 + i), dtype=bf)
        trace = add("ffn_block_bwd", shape, depth,
                    lambda: K3.ffn_block_bwd(*a4[:8], fac, g),
                    backward_of(lambda *a: K3.ffn_block_plain(*a, fac), a4, g), None,
                    p * (10.0 * dim * hc + 60.0 * hc), 2 * 3 * a4[0].numel() + 3 * wbytes, 0)
        by_phase.append({"kernel": "ffn_block_bwd", "stage": i + 1,
                         "device_ms": phases_of(trace)})
        del a4, g
    config4_times(add, by_phase, K1, K3, backward_of)
    levels = sum_inputs(bf)
    out_el = levels[-1].numel()
    add("resize_sum", f"4 levels -> {tuple(levels[-1].shape)} bf16", 1,
        lambda: K5.resize_sum(levels), lambda: K5.resize_sum_plain(levels), None,
        9.0 * out_el * (len(levels) - 1),
        2 * (sum(z.numel() for z in levels) + out_el))
    g = randn(levels[-1].shape, gen(95), dtype=bf)
    shapes = [tuple(z.shape) for z in levels]
    small = sum(z.numel() for z in levels[:-1])
    add("resize_sum_bwd", f"{tuple(g.shape)} -> 3 smaller levels bf16", 1,
        lambda: K5.resize_sum_bwd(g, shapes),
        backward_of(lambda *z: K5.resize_sum_plain(list(z)), levels, g), None,
        9.0 * out_el * (len(levels) - 1), 2 * (out_el + small))
    del levels, g
    # K6 at the train cell's shape: the products the function needs (the
    # classifier forward; dW and dy3 = dl W backward) at the float32 peak;
    # bytes: s and the logits forward, s, dl and ds backward
    ta, dm = tail_inputs(bf), tail_mask()
    n_pix = B * TAIL_SIDE * TAIL_SIDE
    prod = 2.0 * n_pix * TAIL_E * NC
    s_bytes, l_bytes = 2 * ta[0].numel(), 4 * n_pix * NC
    w_bytes = 4 * (3 * TAIL_E + 2 * NC * TAIL_E + 2 * NC + B * TAIL_E)
    shape = f"s(2,{TAIL_SIDE},{TAIL_SIDE},{TAIL_E}) bf16 -> ({B},{TAIL_SIDE},{TAIL_SIDE},{NC}) f32"
    trace = add("head_tail", shape, 1, lambda: K6.head_tail_train(*ta[:3], dm, *ta[3:], 1e-5),
                lambda: K6.head_tail_plain(*ta[:3], dm, *ta[3:], 1e-5), None,
                prod + 8.0 * n_pix * TAIL_E, s_bytes + l_bytes + w_bytes, peak=PEAK_F32)
    by_phase.append({"kernel": "head_tail", "stage": None, "device_ms": phases_of(trace)})
    g = randn((B, TAIL_SIDE, TAIL_SIDE, NC), gen(173))
    mean, var = K6.stats_plain(ta[0])
    rsig = torch.rsqrt(var + 1e-5)
    trace = add("head_tail_bwd", shape, 1,
                lambda: K6.head_tail_bwd(*ta[:3], dm, ta[3], mean, rsig, g),
                backward_of(lambda *a: K6.head_tail_plain(*a[:3], dm, *a[3:], 1e-5)[0], ta, g),
                None, 2 * prod + 12.0 * n_pix * TAIL_E, 2 * s_bytes + l_bytes + 2 * w_bytes,
                peak=PEAK_F32)
    by_phase.append({"kernel": "head_tail_bwd", "stage": None, "device_ms": phases_of(trace)})
    del ta, dm, g, mean, var, rsig
    lo, lab = argmax_inputs(torch.float32), loss_labels()
    pix = lab.numel()
    loss_map, parts = K7.lowres_loss_fwd(lo, lab)
    _, wmap = K7.ce_scalar_and_weights(loss_map, lab != IGNORE, "ohem", lab)
    dcoef = torch.stack(K7.dice_coefs(parts[:, 0], parts[:, 1], parts[:, 2]), 1).contiguous()
    # K7f's bound by operations: its exponentials, one a (pixel, class), on
    # the SFUs
    trace = add("lowres_loss_fwd", f"{tuple(lo.shape)} f32 -> ({B},{IMG},{IMG}) + dice sums", 1,
                lambda: K7.lowres_loss_fwd(lo, lab), lambda: K7.lowres_loss_plain(lo, lab), None,
                pix * NC, 4 * lo.numel() + 4 * pix + 4 * pix + 4 * parts.numel(),
                peak=PEAK_SFU)
    by_phase.append({"kernel": "lowres_loss_fwd", "stage": None, "device_ms": phases_of(trace)})
    # K7b's by operations: the exponentials of each fine pixel's softmax
    add("lowres_loss_bwd", f"({B},{IMG},{IMG}) -> {tuple(lo.shape)} f32", 1,
        lambda: K7.lowres_loss_bwd(lo, lab, wmap, dcoef),
        lambda: K7.lowres_loss_bwd_plain(lo, lab, wmap, dcoef), None,
        pix * NC, 4 * lo.numel() + 4 * pix + 4 * pix + 4 * lo.numel(), peak=PEAK_SFU)
    del lo, lab, loss_map, parts, wmap, dcoef
    # K7f, K7b and K8 at config #2's shapes (16 images at 512², 150 classes,
    # CE + dice), outside the main path's totals
    cb, cs, cnc = 16, 512, 150
    lo = randn((cb, cs // 4, cs // 4, cnc), gen(97), 2.0)
    lab = (torch.arange(cs, device=DEV)[:, None] // 32 * 16
           + torch.arange(cs, device=DEV)[None, :] // 32) % cnc
    lab = lab.to(torch.int32).expand(cb, cs, cs).contiguous()
    pix = lab.numel()
    loss_map, parts = K7.lowres_loss_fwd(lo, lab)
    _, wmap = K7.ce_scalar_and_weights(loss_map, lab != IGNORE, "ce", lab)
    dcoef = torch.stack(K7.dice_coefs(parts[:, 0], parts[:, 1], parts[:, 2]), 1).contiguous()
    tag = "config #2"
    trace = add("lowres_loss_fwd", f"{tag}: {tuple(lo.shape)} f32 -> ({cb},{cs},{cs}) + dice sums",
                0, lambda: K7.lowres_loss_fwd(lo, lab), lambda: K7.lowres_loss_plain(lo, lab),
                None, pix * cnc, 4 * lo.numel() + 4 * pix + 4 * pix + 4 * parts.numel(),
                peak=PEAK_SFU, total=False)
    by_phase.append({"kernel": "lowres_loss_fwd", "stage": tag, "device_ms": phases_of(trace)})
    add("lowres_loss_bwd", f"{tag}: ({cb},{cs},{cs}) -> {tuple(lo.shape)} f32", 0,
        lambda: K7.lowres_loss_bwd(lo, lab, wmap, dcoef),
        lambda: K7.lowres_loss_bwd_plain(lo, lab, wmap, dcoef), None,
        pix * cnc, 4 * lo.numel() + 4 * pix + 4 * pix + 4 * lo.numel(), peak=PEAK_SFU,
        total=False)
    add("resize_argmax", f"{tag}: {tuple(lo.shape)} f32 -> ({cb},{cs},{cs}) int32", 0,
        lambda: K8.resize_argmax_to(lo, (cs, cs)), lambda: K8.resize_argmax_plain(lo, (cs, cs)),
        None, pix * cnc * 8.0, 4 * lo.numel() + 4 * pix, total=False)
    config2_geometry = {"lowres_loss_fwd": K7.fwd_geometry(lo, lab)[0],
                        "resize_argmax": K8.geometry(lo, (cs, cs))[0]}
    del lo, lab, loss_map, parts, wmap, dcoef
    # K5f's bands, spans and slabs, K5b's bands (g's read factor), K7b's
    # tiles (softmaxes a fine pixel), K6f's launches, K7f's and K8's bands
    # and spans
    from segmentation_factory_tpu_torch.ops import transpose_geometry as TG
    small = tuple((side(i), side(i)) for i in (1, 2, 3))
    fg = TG.sum_fwd_geometry(side(0), side(0), small, 768, 2)
    sg = TG.sum_bwd_geometry(side(0), side(0), small, 768)
    lg = TG.loss_bwd_geometry(side(0), side(0), IMG, IMG, NC, 4)
    lo, lab = argmax_inputs(torch.float32), loss_labels()

    def rows_layout(rg, kernel, b=B):  # as the wrapper takes it on this card
        lay = getattr(rg, kernel)
        return {"bands": lay.bands, "band": lay.rows, "span": lay.cols,
                "pixels_a_thread": lay.pixels, "threads": lay.threads, "smem": lay.smem,
                "blocks": b * lay.bands * lay.spans, "source_cols_a_span": lay.wmax,
                "ring": rg.ring, "pairs": rg.pairs, "read_factor": rg.read_factor}

    geometry = {
        "resize_sum": {"vec": fg.vec, "groups": fg.groups, "cols": fg.cols, "rows": fg.rows,
                       "threads": TG.SUMF_THREADS, "smem": fg.smem,
                       "blocks": 768 // (fg.vec * fg.groups) * fg.spans * fg.bands * B,
                       "read_factor": fg.read_factor},
        "head_tail": K6.fwd_plan((B, TAIL_SIDE, TAIL_SIDE, TAIL_E), NC, bf),
        "resize_sum_bwd": {"bands": sg.bands, "band": sg.band, "cols": sg.cols,
                           "quads": sg.quads, "threads": sg.threads,
                           "blocks": 768 // 4 // sg.quads * sg.bands * B,
                           "read_factor": sg.read_factor},
        "lowres_loss_bwd": {"tile": lg.tile, "rows": lg.rows, "region_w": lg.region_w,
                            "threads": lg.threads, "smem": lg.smem,
                            "blocks": B * -(-side(0) // lg.tile[0]) * -(-side(0) // lg.tile[1]),
                            "recompute": lg.recompute},
        "lowres_loss_fwd": rows_layout(K7.fwd_geometry(lo, lab)[0], "loss"),
        "resize_argmax": rows_layout(K8.geometry(lo, (IMG, IMG))[0], "argmax"),
        "lowres_loss_fwd_config2": rows_layout(config2_geometry["lowres_loss_fwd"], "loss", cb),
        "resize_argmax_config2": rows_layout(config2_geometry["resize_argmax"], "argmax", cb)}
    del lab
    add("resize_argmax", f"{tuple(lo.shape)} f32 -> ({B},{IMG},{IMG}) int32", 1,
        lambda: K8.resize_argmax_to(lo, (IMG, IMG)),
        lambda: K8.resize_argmax_plain(lo, (IMG, IMG)), None,
        B * IMG * IMG * NC * 8.0, 4 * lo.numel() + 4 * B * IMG * IMG)
    del lo

    imgs = images(300)[0]

    def predict_ips(m, n=5):
        predict_step(m, imgs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            predict_step(m, imgs)
        torch.cuda.synchronize()
        return n * B / (time.perf_counter() - t0)

    # the two configurations in turns: fused, per-op, per-op, fused
    ips = [predict_ips(m) for m in (model, model_per_op, model_per_op, model)]
    profile = profile_step(lambda: predict_step(model, imgs))
    tips = train_turns()
    return {"phase": "times", "shapes": per_shape, "phases": by_phase,
            "transpose_geometry": geometry,
            "per_step": totals,
            "per_step_per_op": totals_per_op,
            "predict_images_per_s": (ips[0] + ips[3]) / 2,
            "predict_images_per_s_per_op": (ips[1] + ips[2]) / 2, "predict_turns": ips,
            "train_images_per_s": (tips[0] + tips[3]) / 2,
            "train_images_per_s_per_op": (tips[1] + tips[2]) / 2, "train_turns": tips,
            "profile_predict": profile, "ok": True}, totals


def config4_times(add, by_phase, K1, K3, backward_of):
    """K1f / K1b at config #4's stage 4 and K3f / K3b, K4f / K4b at its
    stages 1-3 (24 images at 224², M = 49, bf16), by ``phase_times``' ``add``
    with the main path's bound formulas, outside its totals; launches as a
    step of config #4 gives them."""
    bf, b4, img = torch.bfloat16, SYNAPSE_BATCH, SYNAPSE_IMG
    geo = {"batch": b4, "img": img}
    m = kv_side(img) ** 2
    tag = "config #4"
    q, k, v = attn_inputs(3, bf, **geo)
    heads, n = q.shape[2], q.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    shape = f"{tag}: q({b4},{n},{heads},64) kv({b4},{m},{heads},64) bf16"
    add("sra_attention", shape, 3, lambda: K1.sra_attention(q, k, v, 0.125),
        lambda: K1.sra_attention_plain(q, k, v, 0.125),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=0.125),
        4.0 * b4 * heads * n * m * 64, 2 * (2 * q.numel() + k.numel() + v.numel()), total=False)
    g = randn(q.shape, gen(1080), dtype=bf)
    lse = torch.empty((b4, heads, n), dtype=torch.float32, device=DEV)
    o = K1._forward(q, k, v, 0.125, lse)
    trace = add("sra_attention_bwd", shape, 3,
                lambda: K1.sra_attention_bwd(q, k, v, o, lse, g, 0.125),
                backward_of(lambda *a: K1.sra_attention_plain(*a, 0.125), [q, k, v], g),
                backward_of(lambda *a: F.scaled_dot_product_attention(*a, scale=0.125),
                            [qt, kt, vt], g.transpose(1, 2).contiguous()),
                10.0 * b4 * heads * n * m * 64,
                2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(), total=False)
    by_phase.append({"kernel": "sra_attention_bwd", "stage": f"{tag} 4",
                     "device_ms": phases_of(trace)})
    del q, k, v, qt, kt, vt, g, o, lse
    fac = block_fac(b4)
    for i, (dim, heads, depth) in enumerate(STAGES[:3]):
        a3 = attn_block_inputs(i, bf, **geo)
        x, kk = a3[0], a3[1]
        s, n = x.shape[1], x.shape[1] * x.shape[2]
        wb = 2 * (2 * dim * dim + 2 * dim) + 8 * dim
        shape = f"{tag}: x({b4},{s},{s},{dim}) kv({b4},{m},{dim}) heads={heads} bf16"
        add("attn_block", shape, depth, lambda: K3.attn_block_apply(*a3, fac, heads, 0.125),
            lambda: K3.attn_block_plain(*a3, fac, heads, 0.125), None,
            4.0 * b4 * n * m * dim + 4.0 * b4 * n * dim * dim,
            2 * (2 * x.numel() + 2 * kk.numel()) + wb + 4 * b4, total=False)
        g = randn(x.shape, gen(1090 + i), dtype=bf)
        o = torch.empty_like(x)
        lse = torch.empty((b4, heads, n), dtype=torch.float32, device=DEV)
        K3._attn_forward(*a3, fac, heads, 0.125, o, lse)
        trace = add("attn_block_bwd", shape, depth,
                    lambda: K3.attn_block_bwd(*a3[:8], fac, g, o, lse, heads, 0.125),
                    backward_of(lambda *a: K3.attn_block_plain(*a, fac, heads, 0.125), a3, g),
                    None, b4 * n * (10.0 * dim * dim + 10.0 * m * dim),
                    2 * (4 * x.numel() + 2 * kk.numel()) + 4 * (2 * kk.numel() + lse.numel())
                    + wb + 2 * wb, total=False)
        by_phase.append({"kernel": "attn_block_bwd", "stage": f"{tag} {i + 1}",
                         "device_ms": phases_of(trace, "q_and_doh_gemms")})
        del a3, x, kk, g, o, lse
        a4 = ffn_block_inputs(i, bf, **geo)
        hc, p = 4 * dim, b4 * n
        wbytes = 2 * sum(t.numel() for t in a4[3:]) + 8 * dim
        shape = f"{tag}: x({b4},{s},{s},{dim}) hc={hc} bf16"
        add("ffn_block", shape, depth, lambda: K3.ffn_block_apply(*a4, fac),
            lambda: K3.ffn_block_plain(*a4, fac), None,
            p * (4.0 * dim * hc + 20.0 * hc), 2 * 2 * a4[0].numel() + wbytes + 4 * b4,
            total=False)
        g = randn(a4[0].shape, gen(1100 + i), dtype=bf)
        trace = add("ffn_block_bwd", shape, depth, lambda: K3.ffn_block_bwd(*a4[:8], fac, g),
                    backward_of(lambda *a: K3.ffn_block_plain(*a, fac), a4, g), None,
                    p * (10.0 * dim * hc + 60.0 * hc), 2 * 3 * a4[0].numel() + 3 * wbytes,
                    total=False)
        by_phase.append({"kernel": "ffn_block_bwd", "stage": f"{tag} {i + 1}",
                         "device_ms": phases_of(trace)})
        del a4, g
    torch.cuda.empty_cache()


def sha256(a) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def phase_files():
    """The port's file readers on the card's host against the committed
    fixtures' manifest (``tests/torch_fixtures``, written with PIL and h5py
    by ``tools/torch_fixtures.py``): every JPEG decoded by ``data/jpeg.py``,
    its samples' sha256 equal to PIL's; PIL's bilinear shrink of two of
    them (``native.resize_image``) likewise; the Synapse case read by
    ``data/hdf5.py``, equal to h5py's read. The host engine's build (g++, at
    first use) and each decode's time: the median of ``DECODE_RUNS`` after
    the checked one, and its megapixels a second."""
    import os

    from segmentation_factory_tpu_torch.data import hdf5, jpeg, native

    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    t0 = time.perf_counter()
    native.lib()
    res = {"phase": "files", "engine_build_s": time.perf_counter() - t0,
           "host_cpus": os.cpu_count(), "decodes": [], "bilinear": [], "hdf5": []}
    for e in manifest["jpeg"]:
        path = FIXTURES / e["file"]
        data = path.read_bytes()
        img = jpeg.read_jpeg(str(path))
        runs = []
        for _ in range(DECODE_RUNS):
            t = time.perf_counter()
            jpeg.decode(data)
            runs.append(time.perf_counter() - t)
        ms = sorted(runs)[len(runs) // 2] * 1e3
        mp = img.shape[0] * img.shape[1] / 1e6
        res["decodes"].append({"file": e["file"], "bytes": len(data), "shape": list(img.shape),
                               "equal": list(img.shape) == e["shape"]
                               and sha256(img) == e["sha256"],
                               "ms": ms, "mp_per_s": mp / ms * 1e3})
    for e in manifest["bilinear"]:
        rgb = jpeg.read_rgb(str(FIXTURES / e["file"]))
        t = time.perf_counter()
        small = native.resize_image(rgb, tuple(e["size"]))
        res["bilinear"].append({"file": e["file"], "size": e["size"],
                                "ms": (time.perf_counter() - t) * 1e3,
                                "equal": sha256(small) == e["sha256"]})
    for e in manifest["hdf5"]:
        for key, want in e["datasets"].items():
            a = hdf5.read_dataset(str(FIXTURES / e["file"]), key)
            res["hdf5"].append({"file": e["file"], "dataset": key, "shape": list(a.shape),
                                "equal": str(a.dtype) == want["dtype"]
                                and sha256(a) == want["sha256"]})
    total_mp = sum(d["shape"][0] * d["shape"][1] for d in res["decodes"]) / 1e6
    res["decode_mp_per_s"] = total_mp / sum(d["ms"] for d in res["decodes"]) * 1e3
    res["ok"] = all(d["equal"] for k in ("decodes", "bilinear", "hdf5") for d in res[k])
    return res


def blobs_label(h: int, w: int, classes, seed: int):
    """(h, w) uint8 label map of discs of ids drawn from ``classes`` on
    ``classes[0]``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.ogrid[:h, :w]
    lbl = np.full((h, w), classes[0], np.uint8)
    for k in rng.choice(classes[1:], 6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.05, 0.25) * min(h, w)
        lbl[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = k
    return lbl


def jpeg_tree(dataset: str, root: Path, n_train: int) -> None:
    """A VOC / ADEChallengeData2016 / Kvasir-SEG tree under ``root`` as its
    manifest reads it: the JPEG fixtures linked under ``n_train`` train names
    (``FIXTURE_IMAGES`` in turn) and val names (``VAL_IMAGES``; Kvasir's
    seeded split of ``n_train * 5 // 4`` pairs takes a fifth to val), label
    PNGs written by the port's codec (VOC ids 0-20 and 255 at the border,
    ADE20K 0-150, Kvasir masks 0 / 255 in 3 channels; Kvasir's own image
    takes its mask JPEG)."""
    import numpy as np

    from segmentation_factory_tpu_torch.data.png import write_png

    manifest = {e["file"]: e for e in json.loads((FIXTURES / "manifest.json").read_text())["jpeg"]}
    labels = {}
    for k, name in enumerate(FIXTURE_IMAGES):
        h, w = manifest[name]["shape"][:2]
        out = root / "_labels" / f"{Path(name).stem}.png"
        out.parent.mkdir(parents=True, exist_ok=True)
        if dataset == "voc":
            lbl = blobs_label(h, w, list(range(21)), k)
            lbl[:3], lbl[-3:], lbl[:, :3], lbl[:, -3:] = 255, 255, 255, 255
        elif dataset == "ade20k":
            lbl = blobs_label(h, w, list(range(151)), k)
        else:
            lbl = np.repeat((blobs_label(h, w, [0, 255], k))[..., None], 3, axis=-1)
        write_png(str(out), lbl)
        mask = dataset == "kvasir" and name in KVASIR_MASK
        labels[name] = FIXTURES / KVASIR_MASK[name] if mask else out

    def link(src: Path, dst: Path) -> None:
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.symlink_to(src)

    if dataset == "kvasir":
        for i in range(n_train * 5 // 4):
            img = FIXTURE_IMAGES[i % len(FIXTURE_IMAGES)]
            link(FIXTURES / img, root / "Kvasir-SEG" / "images" / f"k{i:04d}.jpg")
            link(labels[img], root / "Kvasir-SEG" / "masks" / f"k{i:04d}.jpg")
        return
    split = [("train" if dataset == "voc" else "training", FIXTURE_IMAGES, n_train),
             ("val" if dataset == "voc" else "validation", VAL_IMAGES, len(VAL_IMAGES))]
    for part, images, n in split:
        names = [f"{part}_{i:06d}" for i in range(n)]
        for i, name in enumerate(names):
            img = images[i % len(images)]
            if dataset == "voc":
                base = root / "VOCdevkit" / "VOC2012"
                link(FIXTURES / img, base / "JPEGImages" / f"{name}.jpg")
                link(labels[img], base / "SegmentationClass" / f"{name}.png")
            else:
                link(FIXTURES / img, root / "images" / part / f"{name}.jpg")
                link(labels[img], root / "annotations" / part / f"{name}.png")
        if dataset == "voc":
            lists = root / "VOCdevkit" / "VOC2012" / "ImageSets" / "Segmentation"
            lists.mkdir(parents=True, exist_ok=True)
            (lists / f"{part}.txt").write_text("\n".join(names) + "\n")


# the datasets whose files the trainer phase writes from the JPEG fixtures
JPEG_DATASETS = ("voc", "ade20k", "kvasir")


def trainer_expected(cfg, steps: int, eval_batches: int, eval_forwards: int = 0,
                     volumetric: bool = False):
    """The launches a config's trainer run must show: K7f and K7b once a
    step where the loss takes the fused path (CE / OHEM at head
    resolution), else never; K8 once an eval batch under the ``whole``
    protocol (``predict_step``), never under ``ms_flip`` or ``slide`` (they
    resize the logits in the model) nor in a ``volumetric`` per-case eval;
    K6f / K6b once a step with SegFormerHead; with Mask2FormerHead K9f
    six times a step and a forward of the eval and K9b six times a step
    (its 6 pixel-decoder layers), no K5 or K6; with DeepLabV3 K7f / K7b
    twice a step (its aux output); with CAFormer K1f once an attention
    block a step and a forward of the whole-image eval, K1b once an
    attention block a step (``attention_blocks``); and no MiT, K5 or K6
    kernel for another family. For a volumetric run (config #4: MiT-B2, fused)
    every MiT and K5 kernel too: the backwards ``PER_STEP`` a step, the
    forwards ``PER_STEP`` a step and ``PER_FORWARD`` in each of the eval's
    ``eval_forwards`` windows."""
    fused = cfg.loss_type.lower().replace("_", "") in ("ce", "crossentropy", "ohem",
                                                        "ohemcrossentropy")
    losses = steps * fused * (2 if cfg.model.head == "deeplabv3" else 1)
    whole = cfg.eval.protocol == "whole" and not volumetric
    want = {"lowres_loss_fwd": losses, "lowres_loss_bwd": losses,
            "resize_argmax": eval_batches if whole else 0}
    attn = attention_blocks(cfg.model.backbone)
    if attn:
        want.update(sra_attention=attn * (steps + (eval_batches if whole else 0)),
                    sra_attention_bwd=attn * steps)
    if volumetric:
        want.update({k: steps * PER_STEP[k] + eval_forwards * PER_FORWARD.get(k, 0)
                     for k in SOURCES if k.startswith(("sra_", "mixffn", "attn_", "ffn_",
                                                       "resize_sum"))})
    no_k9 = {"ms_deform_attn": 0, "ms_deform_attn_bwd": 0}
    if cfg.model.head == "segformerhead":
        return dict(want, head_tail=steps, head_tail_bwd=steps, **no_k9)
    if cfg.model.head == "mask2formerhead":
        forwards = steps + (eval_batches if cfg.eval.protocol == "whole" else 0)
        return dict(want, ms_deform_attn=M2F_LAYERS * forwards,
                    ms_deform_attn_bwd=M2F_LAYERS * steps,
                    **dict.fromkeys(("resize_sum", "resize_sum_bwd", "head_tail",
                                     "head_tail_bwd"), 0))
    return {**dict.fromkeys(SOURCES, 0), **want}


def synapse_data(root: str, batch: int):
    """Config #4's data as the Trainer reads it: a Synapse tree under
    ``root`` of ``batch * TRAINER_STEPS`` train slices
    (``lists/train.txt``, ``train_npz/*.npz`` of 512² float32 images in [0,
    1] and labels 0-8, ``Synthetic``'s blobs from seed 0) through
    ``SynapseCT``, and a val set whose ``volumes()`` yields
    ``SYNAPSE_CASES`` cases of 512² slices (``Synthetic``'s blobs, seed 1),
    as the per-case eval takes them (the card's machine writes no HDF5; the
    port's reader is held on the CPU)."""
    import numpy as np

    from segmentation_factory_tpu_torch.data.datasets import SegDataset, Synthetic, SynapseCT

    n, size = batch * TRAINER_STEPS, SYNAPSE_SLICE
    root = Path(root)
    (root / "lists").mkdir(parents=True)
    (root / "train_npz").mkdir()
    blobs = Synthetic(9, size, length=n, seed=0)
    names = [f"case{i // 100:04d}_slice{i % 100:03d}" for i in range(n)]
    for i, name in enumerate(names):
        img, lbl = blobs.load(i)
        np.savez(root / "train_npz" / f"{name}.npz", image=img[..., 0].astype(np.float32) / 255,
                 label=lbl.astype(np.float32))
    (root / "lists" / "train.txt").write_text("\n".join(names) + "\n")

    class Volumes(SegDataset):
        CLASSES, PALETTE = SynapseCT.CLASSES, SynapseCT.PALETTE

        def __init__(self):
            super().__init__()
            self.pairs = [(f"case{c:04d}", "") for c in range(len(SYNAPSE_CASES))]
            self.blobs = Synthetic(9, size, length=sum(SYNAPSE_CASES), seed=1)

        def volumes(self):
            first = 0
            for (name, _), d in zip(self.pairs, SYNAPSE_CASES):
                pairs = [self.blobs.load(first + j) for j in range(d)]
                first += d
                yield (name, np.stack([p[0][..., 0] for p in pairs]).astype(np.float32) / 255,
                       np.stack([p[1] for p in pairs]).astype(np.int32))

    return SynapseCT(str(root), "train"), Volumes()


def eval_windows(cfg) -> int:
    """The forwards of config #4's per-case eval: each case's groups of 8
    slices, each slid in windows of the eval crop (``infer.slide_inference``'s
    grid)."""
    crop = cfg.eval.crop or cfg.data.img_size
    stride = crop * 2 // 3
    grid = max(math.ceil((SYNAPSE_SLICE - crop) / stride) + 1, 1) ** 2
    return sum(-(-d // 8) for d in SYNAPSE_CASES) * grid


def trainer_run(KERNELS, path, model=None, **dataset_kwargs):
    """One pinned config through ``engine.loop.Trainer``: the file as it is
    (its ``model`` entries replaced by those of the dict ``model`` when
    given, e.g. the head or the backbone),
    one short epoch of ``TRAINER_STEPS`` steps, a temporary output
    directory, and the config's batch halved only if it does not fit the
    card. Its data: configs #1-#3 their own manifests (``build_dataset`` of
    the config's dataset, with ``dataset_kwargs``) on a JPEG tree written
    from the fixtures (``jpeg_tree``), config #4 a Synapse tree
    (``synapse_data``), config #5 synthetic data at its classes and size
    (train seed 0, val seed 1 with 2 images). ``fit`` trains through the
    loader, evaluates with the config's protocol and saves a checkpoint; a
    second Trainer resumes it. Then the device time of one train step on
    the loader's first batch and of one ``predict_step`` at the config's
    size and batch (``profile_step``). The launch counts are reset just
    before ``fit`` and read just after it."""
    import tempfile

    from segmentation_factory_tpu_torch.config import TrainConfig
    from segmentation_factory_tpu_torch.data.datasets import Synthetic, build_dataset
    from segmentation_factory_tpu_torch.engine import predict_step
    from segmentation_factory_tpu_torch.engine.loop import Trainer

    with open(Path(__file__).resolve().parent / path) as f:
        text = f.read()
    if model is not None:
        data = json.loads(text)
        data["model"].update(model)
        text = json.dumps(data)
    base = TrainConfig.from_json(text)
    nc, size = base.model.num_classes, base.data.img_size
    batch, cut = base.data.batch_size, []
    while True:
        tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_")
        cfg = TrainConfig.from_json(text)
        cfg.output_dir, cfg.data.batch_size = tmp.name, batch
        synapse = cfg.data.dataset.lower() == "synapse"
        files = cfg.data.dataset.lower() in JPEG_DATASETS
        if synapse:
            data = synapse_data(f"{tmp.name}/data", batch)
        elif files:
            cfg.data.data_root = f"{tmp.name}/data"
            jpeg_tree(cfg.data.dataset.lower(), Path(cfg.data.data_root), batch * TRAINER_STEPS)
            data = tuple(build_dataset(cfg.data.dataset, cfg.data.data_root, split,
                                       **dataset_kwargs) for split in ("train", "val"))
        else:
            data = (Synthetic(nc, size, length=batch * TRAINER_STEPS, seed=0),
                    Synthetic(nc, size, length=2, seed=1))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer = Trainer(cfg, *data, device=DEV)
            for fn in KERNELS.values():
                fn.launches = 0
            best = trainer.fit(1)
            break
        except torch.cuda.OutOfMemoryError as exc:
            cut.append({"batch": batch, "error": str(exc)[:300]})
            trainer = None
            tmp.cleanup()
            if batch == 1:
                raise
            batch //= 2
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(trainer.results_path) as f:
        (stats,) = [json.loads(s) for s in f]
    steps = trainer.step
    # the Trainer's own rule: a val split with volumes() is scored per case
    volumetric = trainer.volumetric
    windows = eval_windows(cfg) if volumetric else 0
    want = trainer_expected(cfg, steps, len(trainer.val_loader), windows, volumetric)
    m = cfg.model
    n_eval = sum(SYNAPSE_CASES) if volumetric else len(data[1])
    if synapse:
        described = (f"SynapseCT on {len(data[0])} synthetic {SYNAPSE_SLICE}² slices, the "
                     f"Synapse recipe to {size}²; {len(SYNAPSE_CASES)} val cases of "
                     f"{SYNAPSE_CASES} slices")
    elif files:
        described = (f"{type(data[0]).__name__}({dataset_kwargs or ''}) on a JPEG tree of the "
                     f"fixtures: {len(data[0])} train / {len(data[1])} val files"
                     + (", its own recipe" if hasattr(data[0], "train_augment") else ""))
    else:
        described = f"synthetic {nc} classes, {size}²"
    res = {"config": path, "dataset_kwargs": dataset_kwargs, "model": f"{m.backbone}+{m.head}",
           "classes": nc, "dataset": described, "loss": cfg.loss_type,
           "use_dice": cfg.use_dice, "batch": batch, "batch_cut": cut, "steps": steps,
           "peak_memory_gb": peak_gb,
           "train_images_per_s_with_loader": stats["images_per_s"],
           "train_seconds": stats["seconds"], "loader_wait_s_per_step": stats["data_wait_s"],
           "loader_wait_share": stats["data_wait_s"] * stats["steps"] / stats["seconds"],
           "train_loss": stats["train_loss"],
           "eval_protocol": "per-case dice, slid" if volumetric else cfg.eval.protocol,
           "eval_images": n_eval, "eval_forwards": windows or None, "mIoU": stats["mIoU"],
           "aAcc": stats["aAcc"], "eval_seconds_per_image": stats["eval_seconds"] / n_eval,
           "launches": counts, "launches_expected": want,
           "launches_as_expected": all(counts[k] == n for k, n in want.items())}
    # every step applied its update (a non-finite loss skips it), and the
    # epoch's logged losses are finite
    res["applied_updates"] = int(trainer.optimizer.count)
    finite = (res["applied_updates"] == steps and math.isfinite(stats["train_loss"])
              and math.isfinite(stats["mIoU"]))
    saved = trainer.ckpt.latest_step()
    resumed = Trainer(cfg, *data, device=DEV)
    sd_a, sd_b = trainer.model.state_dict(), resumed.model.state_dict()
    same = (resumed.step == saved == steps and resumed.best == best
            and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
            and all(torch.equal(getattr(trainer.optimizer, k), getattr(resumed.optimizer, k))
                    for k in ("mu", "nu", "count")))
    res.update(saved_step=saved, resumed_step=resumed.step, resume_equal=same)
    del resumed
    # one more step of the loader's first batch, profiled after a warm step:
    # the step's wall on the host's clock against its device time
    trainer.train_loader.set_epoch(0)
    first = next(iter(trainer.train_loader))
    res["profile_train_step"] = profile_step(lambda: trainer.train_step(first))
    x = torch.randn((batch, size, size, 3), generator=gen(600), device=DEV)
    res["profile_predict"] = profile_step(lambda: predict_step(trainer.model.eval(), x))
    res["ok"] = (finite and same and res["launches_as_expected"] and stats["steps"] == steps)
    del trainer, x
    tmp.cleanup()
    torch.cuda.empty_cache()
    return res, counts


def phase_trainer(KERNELS):
    """``trainer_run`` on each of ``TRAINER_CONFIGS``, then config #3 again
    with Kvasir's preset recipe (``preset_recipe=True``) and config #1 with
    ``model.head = "mask2formerhead"`` (MiT-B0: K9 at head dim 32, through
    the loader, the eval and the resume); each run's launches are read
    right after it."""
    runs, counts = [], []
    for path, kwargs, model in ([(p, {}, None) for p in TRAINER_CONFIGS]
                                + [(CONFIG3, {"preset_recipe": True}, None),
                                   (CONFIG1, {}, {"head": "mask2formerhead"})]):
        res, c = trainer_run(KERNELS, path, model, **kwargs)
        runs.append(res)
        counts.append(c)
    return {"phase": "trainer", "configs": runs, "ok": all(r["ok"] for r in runs)}, counts


def options_remat(KERNELS):
    """Config #5's model (MiT-B2 + SegFormerHead, 1024², batch 2, fused)
    ``OPTIONS_STEPS`` SGD updates with the backbone checkpointed (Nesterov,
    momentum 0.9, lr 1e-2, weight decay 1e-4, OHEM + dice, the same
    drop-path and dropout draws), in bf16 and in float32. Before each
    update the gradients are taken from the same state twice without remat
    and once with it, the running statistics put back in between, and the
    update applies the remat gradients: the steps are compared one at a
    time, so that no difference compounds. The forward is deterministic, so
    the loss and the BatchNorm running statistics (``num_batches_tracked``
    one more a step) must equal the plain run's. K1b's and K2b's atomics
    make two plain bf16 backwards differ by several times PERF.md §2's
    gradient bar, so in bf16 the remat gradients are held, in relative L2
    norm, to ``REMAT_NOISE`` times the two plain backwards' own distance,
    and in float32 each gradient to §2's bar (``GRAD_REL`` of its largest
    plain entry plus ``GRAD_ABS`` of the model's largest). The bf16 run's
    launches every step: ``PER_STEP_REMAT`` (the backbone's forward kernels
    twice), ``PHASES_PER_STEP_REMAT``, and ``PER_STEP`` without remat."""
    from segmentation_factory_tpu_torch import build_model
    from segmentation_factory_tpu_torch.engine import compute_loss, create_optimizer
    from segmentation_factory_tpu_torch.schedule import create_schedule

    batch = train_batch()
    images, labels = batch["image"].float(), batch["label"].to(torch.int32)
    phases = {k: phase_function(k) for k in PHASES_PER_STEP}
    res = {"config": CONFIG5, "model": "mit_b2+segformerhead", "batch": B, "image": IMG,
           "fused_blocks": True, "loss": "ohem+dice",
           "optimizer": "sgd nesterov momentum 0.9, lr 1e-2, wd 1e-4, no clip",
           "steps": OPTIONS_STEPS, "compared": "each update from one shared state"}
    ok, remat_counts = True, []
    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        model = build_model("mit_b2", "segformerhead", NC, dtype=dtype, seed=0, device=DEV,
                            remat=True)
        opt = create_optimizer("sgd", create_schedule("constant", 1e-2, 1), weight_decay=1e-4,
                               momentum=0.9, clip_grad=None, params=model.named_parameters())
        names = [n for n, _ in model.named_parameters()]
        bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
        rows = []
        for i in range(OPTIONS_STEPS):
            start = [(b.running_mean.clone(), b.running_var.clone(),
                      b.num_batches_tracked.clone()) for b in bns]

            def backward(remat):
                for b, (m, v, n) in zip(bns, start):
                    b.running_mean.copy_(m)
                    b.running_var.copy_(v)
                    b.num_batches_tracked.copy_(n)
                for fn in (*KERNELS.values(), *phases.values()):
                    fn.launches = 0
                model.remat = remat
                model.train()
                logits = model(images, resize_output=False, generator=gen(10 + i))
                loss = compute_loss(logits, labels, IGNORE, "ohem", True)
                g = torch.autograd.grad(loss, opt.params, allow_unused=True)
                torch.cuda.synchronize()
                return {"loss": loss.item(),
                        "grads": [torch.zeros_like(p) if x is None else x.detach().float()
                                  for p, x in zip(opt.params, g)],
                        "stats": [(b.running_mean.clone(), b.running_var.clone(),
                                   b.num_batches_tracked.clone()) for b in bns],
                        "counts": {k: fn.launches for k, fn in KERNELS.items()},
                        "phase_counts": {k: fn.launches for k, fn in phases.items()}}

            pa, pb, r = backward(False), backward(False), backward(True)
            gmax = max(x.abs().max().item() for x in pa["grads"])
            ratios = [max_err(x, y) / (GRAD_REL * y.abs().max().item() + GRAD_ABS * gmax)
                      for x, y in zip(r["grads"], pa["grads"])]
            worst = max(range(len(ratios)), key=ratios.__getitem__)

            def rel_l2(xs, ys):
                return math.sqrt(sum(((x - y) ** 2).sum().item() for x, y in zip(xs, ys))
                                 / sum((y ** 2).sum().item() for y in ys))

            row = {"losses": [pa["loss"], pb["loss"], r["loss"]],
                   "loss_bit_equal": pa["loss"] == pb["loss"] == r["loss"],
                   "grad_rel_l2_remat": rel_l2(r["grads"], pa["grads"]),
                   "grad_rel_l2_plain_spread": rel_l2(pb["grads"], pa["grads"]),
                   "grad_worst_err_over_bar": ratios[worst], "grad_worst": names[worst],
                   "running_stats_max_rel_err": max(
                       [max_err(x, y) / max(y.abs().max().item(), 1e-30)
                        for s, t in zip(r["stats"], pa["stats"]) for x, y in zip(s[:2], t[:2])]
                       or [0.0]),
                   "tracked_once": all(int(s[2]) == int(t[2]) + 1
                                       for s, t in zip(r["stats"], start)),
                   "launches_remat": r["counts"], "phase_launches_remat": r["phase_counts"],
                   "launches_plain": pa["counts"]}
            grads_ok = (row["grad_rel_l2_remat"] <= REMAT_NOISE * row["grad_rel_l2_plain_spread"]
                        if key == "bf16" else row["grad_worst_err_over_bar"] <= 1.0)
            row["ok"] = (grads_ok and math.isfinite(r["loss"])
                         and abs(r["loss"] - pa["loss"]) <= LOSS_REL * abs(pa["loss"])
                         and row["running_stats_max_rel_err"] <= REL_F32 and row["tracked_once"])
            if key == "bf16":
                row["launches_ok"] = (r["counts"] == PER_STEP_REMAT
                                      and r["phase_counts"] == PHASES_PER_STEP_REMAT
                                      and pa["counts"] == pb["counts"] == PER_STEP
                                      and pa["phase_counts"] == PHASES_PER_STEP)
                row["ok"] = row["ok"] and row["launches_ok"]
                remat_counts.append(r["counts"])
            rows.append(row)
            ok = ok and row["ok"]
            # the update takes the remat gradients and running statistics
            for b, (m, v, n) in zip(bns, r["stats"]):
                b.running_mean.copy_(m)
                b.running_var.copy_(v)
                b.num_batches_tracked.copy_(n)
            opt.step(r["grads"])
            del pa, pb, r
        res[key] = rows
        del model, opt
        torch.cuda.empty_cache()
    res["ok"] = ok
    return res, remat_counts


def options_memory():
    """Config #5's train step at its own batch (``OPTIONS_BATCH`` images of
    1024², AdamW + AGC + cosine) with and without remat: the peak memory
    (``max_memory_allocated`` over a warm step and a timed one) and the
    timed step's wall ms; an out-of-memory is recorded, not raised."""
    from segmentation_factory_tpu_torch.engine import train_step

    g = gen(510)
    lab = loss_labels().repeat(OPTIONS_BATCH // B, 1, 1)
    batch = {"image": torch.randn((OPTIONS_BATCH, IMG, IMG, 3), generator=g, device=DEV),
             "label": lab}
    out = {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        model, opt = make_trainer(remat=remat)
        torch.cuda.reset_peak_memory_stats()
        try:
            for timed in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(model, opt, batch, generator=gen(11), loss_type="ohem", use_dice=True)
                torch.cuda.synchronize()
            out["remat" if remat else "plain"] = {
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                "step_ms": (time.perf_counter() - t0) * 1e3}
        except torch.cuda.OutOfMemoryError as exc:
            out["remat" if remat else "plain"] = {"out_of_memory": str(exc)[:300]}
        del model, opt
    torch.cuda.empty_cache()
    return out


def options_accum_finetune_pretrained(tmp: str):
    """On config #5's model (bf16, fused, batch 2): four micro-steps of
    ``grad_accum = 2`` under SGD + poly + the global-norm clip (the
    parameters move only at the second and the fourth, the update count and
    the rate follow), a checkpoint of the result; a fresh model finetuned
    from that checkpoint with freeze, two AdamW steps (every non-classifier
    parameter bit-identical to the checkpoint's, the classifier moved); a
    third model's backbone from a ``.pth`` of the first's (every tensor
    loaded, none skipped)."""
    from segmentation_factory_tpu_torch import build_model
    from segmentation_factory_tpu_torch.checkpoint import (
        CheckpointManager,
        is_classifier,
        load_for_finetune,
        load_pretrained_backbone,
    )
    from segmentation_factory_tpu_torch.engine import create_optimizer, train_step
    from segmentation_factory_tpu_torch.schedule import create_schedule

    batch = train_batch()
    model = build_model("mit_b2", "segformerhead", NC, seed=0, device=DEV)
    sched = create_schedule("poly", 1e-2, 10, power=0.9, min_lr=0.0)
    opt = create_optimizer("sgd", sched, weight_decay=1e-4, momentum=0.9, clip_grad=1.0,
                           clip_mode="norm", params=model.named_parameters(), grad_accum=2)
    moved, counts, lrs = [], [], []
    prev = opt.flat.clone()
    for i in range(4):
        out = train_step(model, opt, batch, generator=gen(20 + i), loss_type="ohem",
                         use_dice=True)
        torch.cuda.synchronize()
        moved.append(not torch.equal(opt.flat, prev))
        prev = opt.flat.clone()
        counts.append(int(opt.count))
        lrs.append(float(out["lr"]))
    want_lrs = [float(sched(i // 2)) for i in range(4)]
    accum = {"optimizer": "sgd nesterov 0.9, poly lr 1e-2 power 0.9, wd 1e-4, norm clip 1.0",
             "grad_accum": 2, "params_moved": moved, "update_counts": counts, "lrs": lrs,
             "lrs_expected": want_lrs, "mini_step": int(opt.mini_step)}
    accum["ok"] = (moved == [False, True, False, True] and counts == [0, 1, 1, 2]
                   and all(abs(a - b) <= 1e-6 * b for a, b in zip(lrs, want_lrs))
                   and accum["mini_step"] == 0)
    ckpt = f"{tmp}/ckpt"
    CheckpointManager(ckpt).save(4, model, opt, {"mIoU": 1.0})
    src = {n: p.detach().clone() for n, p in model.named_parameters()}
    backbone = {k: v.detach().cpu() for k, v in model.backbone.state_dict().items()}
    del model, opt, prev

    ft = build_model("mit_b2", "segformerhead", NC, seed=1, device=DEV)
    kept = load_for_finetune(ft, ckpt)
    trainable = [is_classifier(n) for n, _ in ft.named_parameters()]
    opt = create_optimizer("adamw", create_schedule("constant", 1e-3, 1), weight_decay=1e-4,
                           clip_grad=0.02, clip_mode="agc", params=ft.named_parameters(),
                           trainable=trainable)
    for i in range(2):
        train_step(ft, opt, batch, generator=gen(30 + i), loss_type="ohem", use_dice=True)
    torch.cuda.synchronize()
    frozen = [n for n, t in zip(src, trainable) if not t]
    finetune = {"from": "the accumulation run's checkpoint", "kept_fresh": kept,
                "trainable": [n for n, t in zip(src, trainable) if t], "frozen": len(frozen),
                "steps": 2, "update_count": int(opt.count)}
    fp = dict(ft.named_parameters())
    finetune["frozen_bit_identical"] = all(torch.equal(fp[n], src[n]) for n in frozen)
    finetune["classifier_moved"] = all(not torch.equal(fp[n], src[n]) for n in finetune["trainable"])
    finetune["ok"] = (finetune["frozen_bit_identical"] and finetune["classifier_moved"]
                      and len(finetune["trainable"]) == 2 and finetune["update_count"] == 2)
    del ft, opt, fp, src

    pth = f"{tmp}/mit_b2_backbone.pth"
    torch.save(backbone, pth)
    pre = build_model("mit_b2", "segformerhead", NC, seed=2, device=DEV)
    loaded, skipped = load_pretrained_backbone(pre, pth)
    got = pre.backbone.state_dict()
    pretrained = {"tensors": len(backbone), "loaded": len(loaded), "skipped": len(skipped),
                  "equal": all(torch.equal(got[k].cpu(), v) for k, v in backbone.items())}
    pretrained["ok"] = (pretrained["loaded"] == len(backbone) and not skipped
                        and pretrained["equal"])
    del pre, got
    torch.cuda.empty_cache()
    return accum, finetune, pretrained


def options_plateau(tmp: str):
    """Config #5's file through ``engine.loop.Trainer`` with the plateau
    schedule (patience 0, factor 0.1, min_lr 0, base lr 1e-6: the weights
    barely move, so the mIoU is slow to rise) over ``OPTIONS_EPOCHS`` short
    epochs of 2 steps at batch 2 on synthetic 1024² data, its ms_flip eval
    on 2 images: the rate falls after every eval whose mIoU does not rise
    above the best, and the next epoch's updates take it."""
    from segmentation_factory_tpu_torch.config import TrainConfig
    from segmentation_factory_tpu_torch.data.datasets import Synthetic
    from segmentation_factory_tpu_torch.engine.loop import Trainer

    cfg = TrainConfig.from_json((Path(__file__).resolve().parent / CONFIG5).read_text())
    cfg.output_dir, cfg.data.batch_size = f"{tmp}/plateau", B
    cfg.data.img_size = cfg.eval.size = cfg.eval.crop = IMG  # the config's own 1024²
    cfg.optim.sched, cfg.optim.sched_kwargs = "plateau", {"patience": 0, "factor": 0.1}
    cfg.optim.lr, cfg.optim.min_lr, cfg.optim.epochs = 1e-6, 0.0, OPTIONS_EPOCHS
    trainer = Trainer(cfg, Synthetic(NC, IMG, length=2 * B, seed=0),
                      Synthetic(NC, IMG, length=2, seed=1), device=DEV)
    step_lrs = []
    real = trainer.train_step

    def step(batch):
        out = real(batch)
        step_lrs.append(float(out["lr"]))
        return out

    trainer.train_step = step
    trainer.fit()
    with open(trainer.results_path) as f:
        lines = [json.loads(s) for s in f]
    best, lr, want, falls = None, cfg.optim.lr, [], 0
    for ln in lines:
        if best is None or ln["mIoU"] > best:
            best = ln["mIoU"]
        else:
            lr, falls = max(lr * 0.1, 0.0), falls + 1
        want.append(lr)
    per_epoch = [step_lrs[2 * e:2 * e + 2] for e in range(OPTIONS_EPOCHS)]
    res = {"epochs": OPTIONS_EPOCHS, "mIoU": [ln["mIoU"] for ln in lines],
           "lr_after_eval": [ln["lr"] for ln in lines], "lr_expected": want, "falls": falls,
           "step_lrs": step_lrs, "optimizer_plateau_lr": float(trainer.optimizer.plateau_lr)}
    res["ok"] = (len(lines) == OPTIONS_EPOCHS
                 and all(abs(a - b) <= 1e-6 * b for a, b in zip(res["lr_after_eval"], want))
                 and all(abs(v - r) <= 1e-6 * r for e, r in enumerate([cfg.optim.lr] + want[:-1])
                         for v in per_epoch[e])
                 and abs(res["optimizer_plateau_lr"] - want[-1]) <= 1e-6 * want[-1]
                 and all(math.isfinite(ln["train_loss"]) for ln in lines))
    del trainer
    torch.cuda.empty_cache()
    return res


def options_optimizers():
    """Each of the 23 optimizers three updates on config #1's model
    (MiT-B0 + SegFormerHead, 21 classes, float32 parameters) on the card and
    on the CPU, from the same weights and gradients (normal, scales 1e-3 to
    1e-1 by tensor; AGC 0.02, weight decay 1e-2, cosine from 1e-4 to 1e-3):
    the largest difference and the elements beyond 1e-5 of the largest |p|
    (at most 1e-6 of them: a sign-based rule such as lion flips where its
    argument is 0 but for rounding); then one update's event ms on config
    #5's parameters (MiT-B2, 27.5M) on the card."""
    from segmentation_factory_tpu_torch import build_model
    from segmentation_factory_tpu_torch.engine import OPTIMIZERS, create_optimizer
    from segmentation_factory_tpu_torch.schedule import create_schedule

    def sched():
        return create_schedule("cosine", 1e-3, 100, warmup_steps=1, warmup_lr_init=1e-4,
                               min_lr=1e-5)

    named = list(build_model("mit_b0", "segformerhead", 21, device="cpu", seed=0)
                 .named_parameters())
    g = torch.Generator().manual_seed(700)
    grads = [[torch.randn(p.shape, generator=g) * 10 ** (-3 + 2 * torch.rand((), generator=g))
              for _, p in named] for _ in range(3)]
    n_elems = sum(p.numel() for _, p in named)
    big = list(build_model("mit_b2", "segformerhead", NC, device=DEV, seed=0).named_parameters())
    big_grads = [torch.randn(p.shape, generator=gen(710), device=DEV) * 1e-3 for _, p in big]
    rows = []
    for name in OPTIMIZERS:
        runs = {}
        for dev in ("cpu", DEV):
            params = [(n, torch.nn.Parameter(p.detach().clone().to(dev))) for n, p in named]
            opt = create_optimizer(name, sched(), weight_decay=1e-2, momentum=0.9,
                                   clip_grad=0.02, clip_mode="agc", params=params)
            for gs in grads:
                opt.step([x.to(dev) for x in gs])
            runs[dev] = [p.detach().cpu() for _, p in params]
        scale = max(p.abs().max().item() for p in runs["cpu"])
        err = max(max_err(a, b) for a, b in zip(runs[DEV], runs["cpu"]))
        beyond = sum(int(((a - b).abs() > 1e-5 * scale).sum()) for a, b in zip(runs[DEV],
                                                                                runs["cpu"]))
        params = [(n, torch.nn.Parameter(p.detach().clone())) for n, p in big]
        opt = create_optimizer(name, sched(), weight_decay=1e-2, momentum=0.9, clip_grad=0.02,
                               clip_mode="agc", params=params)
        ms = cuda_ms(lambda: opt.step(big_grads))
        rows.append({"name": name, "max_abs_err": err, "largest_abs_p": scale,
                     "elements_beyond_bar": beyond, "ms_mit_b2": ms,
                     "ok": beyond <= 1e-6 * n_elems and math.isfinite(err)})
        del params, opt
    del big, big_grads
    torch.cuda.empty_cache()
    return rows


def phase_options(KERNELS):
    """The Trainer's options on the card (``options_*``): remat against no
    remat with its launch counts, the peak memory at config #5's batch with
    and without it, gradient accumulation, finetune + freeze, the
    pretrained backbone, the plateau Trainer and the 23 optimizers. The
    remat run's launches (read right after each step) go to the kernels
    line."""
    import tempfile

    res = {"phase": "options"}
    res["remat"], counts = options_remat(KERNELS)
    res["memory"] = options_memory()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_options_") as tmp:
        res["accum"], res["finetune"], res["pretrained"] = options_accum_finetune_pretrained(tmp)
        res["plateau"] = options_plateau(tmp)
    res["optimizers"] = options_optimizers()
    res["ok"] = (all(res[k]["ok"] for k in ("remat", "accum", "finetune", "pretrained",
                                            "plateau"))
                 and "peak_memory_gb" in res["memory"].get("remat", {})
                 and all(r["ok"] for r in res["optimizers"]))
    return res, counts


@contextlib.contextmanager
def synthetic_val(length, size, seed=1):
    """``build_dataset("synthetic", ...)`` gives ``length`` images of
    ``size``² (the CLIs' synthetic set is 64 of 512² by default)."""
    import functools

    from segmentation_factory_tpu_torch.data import datasets

    saved = datasets.DATASETS["synthetic"]
    datasets.DATASETS["synthetic"] = (functools.partial(datasets.Synthetic, size=size,
                                                        length=length, seed=seed), saved[1])
    try:
        yield
    finally:
        datasets.DATASETS["synthetic"] = saved


def host_us(fn, n=2000) -> float:
    """Host microseconds a call of ``fn``, ``n`` calls then a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


# the forward wrappers the model calls by name, and the kernel each launches
MODEL_WRAPPERS = {"sra_attention": "sra_attention", "mixffn_apply": "mixffn",
                  "attn_block_apply": "attn_block", "ffn_block_apply": "ffn_block",
                  "resize_sum": "resize_sum"}


def _detached(a):
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    if isinstance(a, (list, tuple)):
        return [_detached(t) for t in a]
    return a


def _shapes(a):
    if isinstance(a, torch.Tensor):
        return tuple(a.shape)
    if isinstance(a, (list, tuple)):
        return tuple(_shapes(t) for t in a)
    return None


@contextlib.contextmanager
def kernel_inputs(store):
    """Route the model's calls of the forward wrappers (K1f-K5f) through
    recorders that keep, in ``store`` {(kernel, shapes): arguments}, a copy
    of the arguments of each kernel's first call at each shape."""
    from segmentation_factory_tpu_torch.models.backbones import mit
    from segmentation_factory_tpu_torch.models.heads import segformer

    def recorder(kernel, f):
        def call(*args):
            store.setdefault((kernel, _shapes(args)), _detached(args))
            return f(*args)
        return call

    saved = [(m, n, getattr(m, n)) for m in (mit, segformer) for n in MODEL_WRAPPERS
             if hasattr(m, n)]
    for m, n, f in saved:
        setattr(m, n, recorder(MODEL_WRAPPERS[n], f))
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


PLAIN_SCORES = 1 << 28  # float32 attention scores a chunk of a plain attention (1 GiB)


def recorded_check(kernel, args):
    """``check_pair`` of one recorded wrapper call: the kernel on the
    recorded bf16 inputs (and on their float32 casts) against its plain
    version, under the check phase's bars. The plain attentions run in
    chunks of query rows (each row's output depends on its own row and on
    K / V alone) of at most ``PLAIN_SCORES`` scores."""
    from segmentation_factory_tpu_torch.ops import block, mixffn, resize_sum, sra_attention

    def attn_rows(x, k, v, *rest):
        b, hh, w, _ = x.shape
        rows = max(1, PLAIN_SCORES // (b * w * rest[-2] * k.shape[1]))
        return torch.cat([block.attn_block_plain(x[:, i:i + rows], k, v, *rest)
                          for i in range(0, hh, rows)], 1)

    def attn_tokens(q, k, v, sc):
        b, n, h, _ = q.shape
        step = max(1, PLAIN_SCORES // (b * h * k.shape[1]))
        return torch.cat([sra_attention.sra_attention_plain(q[:, i:i + step], k, v, sc)
                          for i in range(0, n, step)], 1)

    if kernel == "resize_sum":
        tensors = args[0]
        kern = lambda *z: resize_sum.resize_sum(list(z))  # noqa: E731
        plain = lambda *z: resize_sum.resize_sum_plain(list(z))  # noqa: E731
    elif kernel == "sra_attention":
        tensors, sc = args[:3], args[3]
        kern = lambda q, k, v: sra_attention.sra_attention(q, k, v, sc)  # noqa: E731
        plain = lambda q, k, v: attn_tokens(q, k, v, sc)  # noqa: E731
    elif kernel == "attn_block":
        tensors, extra = args[:10], args[10:]
        kern = lambda *a: block.attn_block_apply(*a, *extra)  # noqa: E731
        plain = lambda *a: attn_rows(*a, *extra)  # noqa: E731
    else:
        tensors = args
        kern, plain = {"mixffn": (mixffn.mixffn_apply, mixffn.mixffn_plain),
                       "ffn_block": (block.ffn_block_apply, block.ffn_block_plain)}[kernel]
    # the compute-dtype tensors take ``dt``; LN affines and drop-path
    # factors stay float32, as the wrappers take them
    make = lambda dt: [t.to(dt) if t.dtype == torch.bfloat16 else t  # noqa: E731
                       for t in tensors]
    with torch.inference_mode():
        return check_pair(kern, plain, make)


@contextlib.contextmanager
def kept_logits(store):
    """Keep a copy of each (logits, labels, ignore index) that
    ``validate.main`` passes to ``update_confusion_matrix``."""
    from segmentation_factory_tpu_torch import metrics

    f = metrics.update_confusion_matrix

    def keep(hist, logits, labels, ignore_index=IGNORE):
        store.append((logits.float().clone(), labels.clone(), ignore_index))
        return f(hist, logits, labels, ignore_index)

    metrics.update_confusion_matrix = keep
    try:
        yield
    finally:
        metrics.update_confusion_matrix = f


def phase_entry(KERNELS):
    """Config #5's serving entry points (MiT-B2 + SegFormerHead, 19
    classes, E = 768, 1024², bf16, fused): a checkpoint directory whose best
    step is not its latest, loaded by ``SemSeg(ckpt_dir=...)``;
    ``export.export_model`` at a dynamic batch, loaded and called at batch 1
    and 2, its launches per forward (``PER_FORWARD`` without K8) and its
    logits against the live model's; ``validate.main`` on a synthetic val
    set of 4 images (batch 2) whole, ms_flip and through the exported
    program; ``predict.main --tta --dataset cityscapes --draw-names`` on a
    1024 x 2048 PNG written by the port's codec; K1f-K5f at TTA's scale
    1.75 on recorded inputs against their plain versions; one TTA
    prediction at 256 x 512 in float32 through the kernels and through the
    plain versions; ``predict.main --tta`` on a JPEG fixture (VOC's 500 x
    375); ``validate.main --dataset synapse`` (config #4's MiT-B2, 9
    classes, seeded weights) on a tree holding the committed ``.npy.h5``
    case, its per-case dice equal to ``infer.evaluate_volumes`` on the same
    model; the host cost of a registered op's dispatch. Every path's
    launches are read with the counts reset just before it."""
    import tempfile
    import types

    import numpy as np

    from segmentation_factory_tpu_torch import build_model, export, predict, validate
    from segmentation_factory_tpu_torch.checkpoint import CheckpointManager
    from segmentation_factory_tpu_torch.data.datasets import SynapseCT
    from segmentation_factory_tpu_torch.data.png import read_png, write_png
    from segmentation_factory_tpu_torch.infer import (SemSeg, evaluate_volumes,
                                                      multi_scale_flip_inference, preprocess)
    from segmentation_factory_tpu_torch.ops import mixffn, sra_attention

    phases = {k: getattr(mixffn, k) for k in FFN_FWD_PHASES}
    per_forward = dict(PER_FORWARD, resize_argmax=0)
    res = {"phase": "entry", "model": "mit_b2+segformerhead", "embed_dim": 768, "image": IMG,
           "classes": NC, "dtype": "bfloat16", "fused_blocks": True}
    paths = []  # each path's launches
    checks = {}

    def counted(name, fn, forwards):
        for f in (*KERNELS.values(), *phases.values()):
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in KERNELS.items()}
        paths.append(counts)
        phase_counts = {k: f.launches for k, f in phases.items()}
        res[f"launches_{name}"] = counts
        checks[f"launches_{name}"] = (
            all(counts[k] == per_forward.get(k, 0) * forwards for k in counts)
            and phase_counts == ffn_fwd_phases(per_forward["mixffn"] * forwards))
        return out

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_entry_")
    root = Path(tmp.name)
    # 1. two checkpoints of seeded weights; the best (mIoU 50) is not the latest
    ckpt = str(root / "ckpt")
    mngr = CheckpointManager(ckpt)
    no_optimizer = types.SimpleNamespace(state_dict=dict)
    x2 = images(400)[0]
    # (the models are made outside inference mode: export traces their parameters)
    logits = []
    for step, seed, miou in ((1, 1, 50.0), (2, 2, 10.0)):
        model = build_model("mit_b2", "segformerhead", NC, seed=seed, device=DEV)
        mngr.save(step, model, no_optimizer, {"mIoU": miou})
        with torch.inference_mode():
            logits.append(model(x2))
        del model
    want, other = logits
    seg = SemSeg("mit_b2", "segformerhead", NC, img_size=IMG, device=DEV, ckpt_dir=ckpt)
    with torch.inference_mode():
        live = seg.model(x2)
    res.update(best_step=mngr.best_step(), latest_step=mngr.latest_step(),
               loaded_best_max_abs_err=max_err(live, want),
               latest_vs_best_max_abs_err=max_err(other, want))
    checks["loads_best"] = (res["best_step"] == 1 and res["latest_step"] == 2
                            and bool(torch.equal(live, want)) and not torch.equal(other, want))
    del want, other, logits

    # 2. the export at a dynamic batch, loaded and called at batch 1 and 2
    art = str(root / "mit_b2_1024.pt2")
    t0 = time.perf_counter()
    export.export_model(seg.model, IMG, art)
    res["export_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog = export.load_exported(art).module()
    res["load_s"] = time.perf_counter() - t0
    with torch.inference_mode():
        out1 = prog(x2[:1])
        out2 = counted("exported_forward", lambda: prog(x2), 1)
        res["exported_shapes"] = [list(out1.shape), list(out2.shape)]
        # 3-4. its logits and labels against the live model's
        res["exported_vs_live_max_abs_err"] = max_err(out2, live)
        res["exported_b1_vs_live_max_abs_err"] = max_err(out1, live[:1])
        top = torch.topk(live, 2, dim=-1).values
        clear = (top[..., 0] - top[..., 1]) > max(TIE_GAP, 2 * res["exported_vs_live_max_abs_err"])
        same = out2.argmax(-1) == live.argmax(-1)
        res["exported_label_agree_outside_ties"] = float(same[clear].float().mean())
        res["near_tie_share"] = 1 - float(clear.float().mean())
        ok, diff = export.validate_export(seg.model, art, IMG)
        res["validate_export"] = {"ok": ok, "max_abs_diff": diff}
        # 8. the exported and the live forward at batch 2: events and kernel time
        res["exported_forward_ms"] = cuda_ms(lambda: prog(x2))
        res["live_forward_ms"] = cuda_ms(lambda: seg.model(x2))
        res["exported_forward_device_ms"] = device_ms(kernel_trace(lambda: prog(x2)))
        res["live_forward_device_ms"] = device_ms(kernel_trace(lambda: seg.model(x2)))
    checks["exported"] = (out1.shape == (1, IMG, IMG, NC) and out2.shape == (B, IMG, IMG, NC)
                          and bool(torch.isfinite(out2).all())
                          and res["exported_vs_live_max_abs_err"] <= export.BF16_ATOL
                          and res["exported_b1_vs_live_max_abs_err"] <= export.BF16_ATOL
                          and res["exported_label_agree_outside_ties"] >= AGREE and ok)
    del out1, out2, live, top, clear, same

    # 5. validate: whole, ms_flip and the exported program, 4 images at 1024²
    common = ["--dataset", "synthetic", "--backbone", "mit_b2", "--nb-classes", str(NC),
              "--img-size", str(IMG), "--batch-size", str(B), "--ckpt", ckpt, "--workers", "4"]
    hists, kept = {}, {"whole": [], "ms_flip": [], "artifact": []}
    with synthetic_val(4, IMG):
        for name, extra, forwards in (("whole", [], 2), ("ms_flip", ["--tta"], 2 * 12),
                                      ("artifact", ["--export-artifact", art], 2)):
            t0 = time.perf_counter()
            with kept_logits(kept[name]):
                m = counted(f"validate_{name}", lambda: validate.main(common + extra), forwards)
            res[f"validate_{name}"] = {"mIoU": m["mIoU"], "aAcc": m["aAcc"],
                                       "seconds": time.perf_counter() - t0,
                                       "pixels": int(m["hist"].sum())}
            hists[name] = m["hist"]
    pixels = int(hists["whole"].sum())
    # the artifact's matrix against the live whole run's: each label that
    # differs moves one count between two cells, and may differ only at a
    # near-tie of the live logits (top-2 gap within twice the two runs'
    # largest logit difference) on a pixel that is counted
    live_lo = torch.cat([lo for lo, _, _ in kept["whole"]])
    art_lo = torch.cat([lo for lo, _, _ in kept["artifact"]])
    lab = torch.cat([lb for _, lb, _ in kept["whole"]])
    counted_px = (lab >= 0) & (lab < NC) & (lab != kept["whole"][0][2])
    err = max_err(art_lo, live_lo)
    top = torch.topk(live_lo, 2, dim=-1).values
    ties = int((((top[..., 0] - top[..., 1]) <= max(TIE_GAP, 2 * err)) & counted_px).sum())
    res["artifact_vs_whole_logits_max_abs_err"] = err
    res["whole_near_ties"] = ties
    res["artifact_vs_whole_hist_l1"] = int(np.abs(hists["artifact"] - hists["whole"]).sum())
    res["ms_flip_prob_sum_max_err"] = max(
        float(((p.sum(-1) - 1).abs()).max()) for p, _, _ in kept["ms_flip"])
    checks["validate"] = (pixels == 4 * IMG * IMG and int(hists["ms_flip"].sum()) == pixels
                          and int(counted_px.sum()) == pixels
                          and res["artifact_vs_whole_hist_l1"] <= 2 * ties
                          and res["ms_flip_prob_sum_max_err"] <= 1e-4)
    del kept, live_lo, art_lo, lab, counted_px, top

    # 6. predict --tta on Cityscapes' frame size, written and read by the codec
    frame = (255 * torch.rand((IMG, 2 * IMG, 3), generator=gen(401), device=DEV)).to(
        torch.uint8).cpu().numpy()
    src, out_dir = root / "frame.png", root / "predicted"
    write_png(str(src), frame)
    t0 = time.perf_counter()
    maps = counted("predict_tta", lambda: predict.main(
        ["--backbone", "mit_b2", "--nb-classes", str(NC), "--dataset", "cityscapes",
         "--ckpt", ckpt, "--input", str(src), "--output", str(out_dir),
         "--img-size", str(IMG), "--tta", "--draw-names"]), 12)
    res["predict_tta_seconds"] = time.perf_counter() - t0
    back = read_png(str(out_dir / "frame.png"))
    seg_map = maps[str(src)]
    res["predict_tta"] = {"output_shape": list(back.shape), "map_shape": list(seg_map.shape),
                          "classes_present": int(len(np.unique(seg_map)))}
    checks["predict"] = (back.shape == (IMG, 2 * IMG, 3) and seg_map.shape == (IMG, 2 * IMG)
                         and 0 <= seg_map.min() and seg_map.max() < NC)
    # 6a. predict --tta on a JPEG fixture (VOC's 500 x 375 4:2:0), read by the
    # port's decoder; the overlay is written as a PNG of its name + ".png"
    src = FIXTURES / FIXTURE_IMAGES[0]
    t0 = time.perf_counter()
    maps = counted("predict_tta_jpeg", lambda: predict.main(
        ["--backbone", "mit_b2", "--nb-classes", str(NC), "--dataset", "cityscapes",
         "--ckpt", ckpt, "--input", str(src), "--output", str(out_dir),
         "--img-size", str(IMG), "--tta"]), 12)
    res["predict_tta_jpeg_seconds"] = time.perf_counter() - t0
    back = read_png(str(out_dir / f"{src.name}.png"))
    seg_map = maps[str(src)]
    res["predict_tta_jpeg"] = {"input": src.name, "output_shape": list(back.shape),
                               "map_shape": list(seg_map.shape),
                               "classes_present": int(len(np.unique(seg_map)))}
    checks["predict_jpeg"] = (back.shape == (375, 500, 3) and seg_map.shape == (375, 500)
                              and 0 <= seg_map.min() and seg_map.max() < NC)
    del prog

    # 6b. the kernels at TTA's largest scale (1.75): each wrapper's first
    # call at each shape in one forward of the frame (1792 x 3584, batch 1)
    # and of validate's batch (1792², batch 2), the recorded inputs through
    # the kernel and through its plain version under the check phase's bars
    frame_in = torch.from_numpy(preprocess(frame, IMG)[0]).to(DEV)
    for tag, x in (("predict", frame_in), ("validate", images(402)[0])):
        calls = {}
        with kernel_inputs(calls):
            multi_scale_flip_inference(seg.forward, x, NC, scales=(1.75,), flip=False)
        got = {}
        for (kernel, shapes), args in calls.items():
            first = shapes[0][0] if kernel == "resize_sum" else shapes[0]
            got[f"{kernel}:{'x'.join(map(str, first))}"] = recorded_check(kernel, args)
        res[f"tta_1.75_{tag}_kernels_vs_plain"] = got
        per = [k.split(":")[0] for k in got]
        checks[f"tta_1.75_{tag}_kernels"] = (
            all(v["ok"] for v in got.values())
            and {k: per.count(k) for k in set(per)} == {"sra_attention": 1, "mixffn": 1,
                                                        "attn_block": 3, "ffn_block": 3,
                                                        "resize_sum": 1})
        del calls, got
    del seg, frame_in

    # 7. one TTA prediction at 256 x 512, float32: kernels against plain versions
    small = frame[::4, ::4].copy()
    f32 = SemSeg("mit_b2", "segformerhead", NC, img_size=IMG // 4, dtype=torch.float32,
                 device=DEV, ckpt_dir=ckpt)
    lab_k = counted("tta_256x512", lambda: f32.predict(small, tta=True)[0], 12)
    with plain_path():
        lab_p = f32.predict(small, tta=True)[0]
    res["tta_256x512_f32_kernels_vs_plain_agree"] = float((lab_k == lab_p).mean())
    checks["tta_plain"] = res["tta_256x512_f32_kernels_vs_plain_agree"] >= AGREE
    del f32

    # 8. validate --dataset synapse (config #4's model, seeded weights, 224
    # crop) on a tree that holds the committed .npy.h5 case, read by
    # data/hdf5.py: its per-case dice against infer.evaluate_volumes on the
    # same model and volumes, here on the card
    syn = root / "synapse"
    (syn / "lists").mkdir(parents=True)
    (syn / "test_vol_h5").mkdir()
    (syn / "test_vol_h5" / "case0001.npy.h5").symlink_to(FIXTURES / "case0001.npy.h5")
    (syn / "lists" / "test_vol.txt").write_text("case0001\n")
    t0 = time.perf_counter()
    m = counted("validate_synapse", lambda: validate.main(
        ["--dataset", "synapse", "--data-root", str(syn), "--backbone", "mit_b2",
         "--nb-classes", "9", "--img-size", "224"]), 1)
    res["validate_synapse_seconds"] = time.perf_counter() - t0
    same = SemSeg("mit_b2", "segformerhead", 9, img_size=224, dtype=validate.DTYPE, device=DEV)
    want = evaluate_volumes(same.forward, SynapseCT(str(syn), "val").volumes(), 9, crop=224,
                            device=DEV)
    res["validate_synapse"] = {"per_case": m["per_case"], "mean_dice_fg": m["mean_dice_fg"],
                               "evaluate_volumes_per_case": want["per_case"]}
    checks["validate_synapse"] = m == want and list(m["per_case"]) == ["case0001"]
    del same

    # 9. the Mask2Former slice exported: its program holds sft::ms_deform_attn
    # and runs K9f six times a forward; its labels against the live model's
    res["m2f_export"], m2f_counts = slice_export(
        KERNELS, root, m2f_model(), "mit_b2+mask2formerhead", "ms_deform_attn", M2F_PER_FORWARD,
        M2F_B, M2F_IMG, NC, 740)
    paths.append(m2f_counts)
    checks["m2f_export"] = res["m2f_export"]["ok"]

    # 10. the zoo's model A (CAFormer-S18 + UPerHead) exported: its program
    # holds sft::sra_attention_fwd and runs K1f twelve times a forward
    res["zoo_export"], zoo_counts = slice_export(
        KERNELS, root, zoo_model("A"), "caformer_s18+uperhead", "sra_attention_fwd",
        ZOO_PER_FORWARD["A"], 4, ZOO_IMG, ZOO_MODELS["A"]["classes"], 1240)
    paths.append(zoo_counts)
    checks["zoo_export"] = res["zoo_export"]["ok"]

    # the host cost of a registered op: K1f at a tiny shape, where the host
    # is slower than the kernel, the op against the wrapper's own checks and
    # launch, in turns (direct, op, op, direct)
    q = torch.randn((1, 64, 1, 64), device=DEV, dtype=torch.bfloat16)
    direct = lambda: (sra_attention._check(q, q, q), sra_attention._forward(q, q, q, 0.125))  # noqa: E731
    op = lambda: sra_attention.sra_attention_fwd(q, q, q, 0.125)  # noqa: E731
    host_us(direct, 200)
    turns = [host_us(f) for f in (direct, op, op, direct)]
    res["dispatch_us_turns"] = turns
    res["op_dispatch_us"] = (turns[1] + turns[2] - turns[0] - turns[3]) / 2
    res["wrapper_calls_per_forward"] = sum(per_forward.values())
    res["op_dispatch_us_per_forward"] = res["op_dispatch_us"] * res["wrapper_calls_per_forward"]
    res["checks"] = {k: bool(v) for k, v in checks.items()}
    res["ok"] = all(res["checks"].values())
    tmp.cleanup()
    return res, paths


# ------------------------------------------------------------------ Mask2Former (phase m2f)

# the slice: MiT-B2 + Mask2FormerHead (E = 768: 8 heads of D = 96, 6
# pixel-decoder layers, 9 decoder layers, 100 queries), 512², batch 4, 19
# classes, bf16, fused MiT (the JAX package's bench cell mit_b2_mask2former_512)
M2F_B, M2F_IMG, M2F_STEPS, M2F_WARMUP = 4, 512, 6, 100
M2F_LAYERS = 6  # K9f and K9b launches a train step, K9f a predict
# K9 at the slice's shapes (the encoder's queries are every pixel of the
# three levels: strides 32, 16, 8), at MiT-B0's head dim 32 (config #1's
# D), at ragged level sizes, with offsets of up to 40 pixels (``wide``: a
# trained model's points far from their reference) and at head dim 256;
# (batch, levels, heads, head dim, points, offsets' reach in pixels)
_M2F_LEVELS = ((16, 16), (32, 32), (64, 64))
K9_SHAPES = {"slice": (M2F_B, _M2F_LEVELS, 8, 96, 4, 4),
             "d32": (2, _M2F_LEVELS, 8, 32, 4, 4),
             "ragged": (2, ((7, 9), (13, 17), (25, 33)), 8, 96, 4, 4),
             "wide": (2, _M2F_LEVELS, 8, 96, 4, 40),
             "d256": (2, _M2F_LEVELS, 8, 256, 4, 4)}


def k9_inputs(dtype, b, levels, m, d, p, px, seed):
    """K9's inputs as the pixel decoder gives them: value (B, S, M, D) in
    ``dtype``, float32 locations at every pixel centre of every level plus
    offsets of up to ``px`` pixels of the level, float32 weights softmaxed
    over L * P. Some queries sample on the map's edge (0 and 1), some far
    outside [0, 1] (-2.5, 3.5)."""
    g = gen(seed)
    s, n = sum(h * w for h, w in levels), len(levels)
    from segmentation_factory_tpu_torch.models.layers.msdeformattn import reference_point_grid

    ref = reference_point_grid(levels, DEV)  # (S, L, 2)
    wh = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32, device=DEV)
    off = (torch.rand((b, s, m, n, p, 2), generator=g, device=DEV) * 2 - 1) * px / wh[:, None]
    loc = ref[None, :, None, :, None, :] + off
    loc[:, ::97, :, :, 0] = 0.0
    loc[:, 1::97, :, :, 1] = 1.0
    loc[:, 2::193] = -2.5
    loc[:, 3::193] = 3.5
    attn = torch.softmax(torch.randn((b, s, m, n * p), generator=g, device=DEV), -1)
    value = torch.randn((b, s, m, d), generator=g, device=DEV).to(dtype)
    return [value, loc.contiguous(), attn.reshape(b, s, m, n, p).contiguous()]


def k9_grid_sample(value, levels, loc, attn):
    """The reference's debug composition of K9's function
    (ms_deform_attn_func.py:41-61): ``F.grid_sample`` per level (L calls),
    then the weighted sum; the library yardstick, used nowhere in the port."""
    b, s, m, d = value.shape
    q, n, p = loc.shape[1], loc.shape[3], loc.shape[4]
    out, off = 0, 0
    for lvl, (h, w) in enumerate(levels):
        v = value[:, off:off + h * w].permute(0, 2, 3, 1).reshape(b * m, d, h, w)
        grid = (2 * loc[:, :, :, lvl] - 1).permute(0, 2, 1, 3, 4).reshape(b * m, q, p, 2)
        smp = F.grid_sample(v.to(loc.dtype), grid, mode="bilinear", padding_mode="zeros",
                            align_corners=False)  # (B M, D, Q, P)
        wl = attn[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * m, 1, q, p)
        out = out + (smp * wl).sum(-1)
        off += h * w
    return out.reshape(b, m, d, q).permute(0, 3, 1, 2).reshape(b, q, m * d)


def k9_checks(K9):
    """K9f (the op) and K9b (through K9's autograd Function) against the
    plain version and autograd through it, float32 and bf16, at
    ``K9_SHAPES``."""
    res = {}
    for tag, (b, levels, m, d, p, px) in K9_SHAPES.items():
        make = lambda dt, b=b, levels=levels, m=m, d=d, p=p, px=px, tag=tag: (  # noqa: E731
            k9_inputs(dt, b, levels, m, d, p, px, 900 + len(tag)))
        kern = lambda v, l, a, levels=levels: K9.ms_deform_attn(v, levels, l, a)  # noqa: E731
        plain = lambda v, l, a, levels=levels: K9.ms_deform_attn_plain(v, levels, l, a)  # noqa: E731
        with torch.no_grad():
            res[f"ms_deform_attn:{tag}"] = check_pair(kern, plain, make)
        q = sum(h * w for h, w in levels)
        res[f"ms_deform_attn_bwd:{tag}"] = check_grads(
            kern, plain, lambda dt, make=make, b=b, q=q, m=m, d=d: (
                make(dt), randn((b, q, m * d), gen(950))))
    # d(value) by atomics: two calls agree to rounding, not to the bit
    v, loc, attn = k9_inputs(torch.float32, *K9_SHAPES["slice"], seed=960)
    levels = K9_SHAPES["slice"][1]
    g = randn((v.shape[0], loc.shape[1], v.shape[2] * v.shape[3]), gen(961))
    d1 = K9.ms_deform_attn_bwd(v, levels, loc, attn, g)[0]
    d2 = K9.ms_deform_attn_bwd(v, levels, loc, attn, g)[0]
    torch.cuda.synchronize()
    res["ms_deform_attn_bwd:dvalue_repeat"] = {
        "max_abs_diff": max_err(d1, d2), "bit_equal": bool(torch.equal(d1, d2)),
        "ok": max_err(d1, d2) <= REL_F32 * d1.abs().max().item()}
    return res


def block_batch(n, size, nc, rows, seed, classes=None):
    """A fixed learnable batch of ``n`` images of ``size``²: 32-pixel blocks
    of the ``nc`` classes (block (i, j) of class ``(rows * i + j) % nc``),
    each pixel its class's colour plus noise, the top 8 rows void. With
    ``classes``, each image is a scene of its own, as a segmentation
    dataset's are: ``classes`` of the ``nc`` drawn for it (block (i, j) of
    its ``(rows * i + j) % classes``-th), every other image transposed, and
    its own palette (the shared one plus a perturbation of each colour and
    a cast of the whole image). A train-mode BatchNorm over pooled features
    (UPerHead's 1 x 1 and 2 x 2 bins, DeepLabV3's image pool) then sees
    images that differ by more than pixel noise."""
    g = gen(seed)
    idx = torch.arange(size, device=DEV) // 32
    lab = (idx[:, None] * rows + idx[None, :]).expand(n, -1, -1) % (classes or nc)
    palette = torch.randn((nc + 1, 3), generator=g, device=DEV).expand(n, -1, -1)
    if classes:
        own = torch.stack([torch.randperm(nc, generator=g, device=DEV)[:classes]
                           for _ in range(n)])
        lab = own.gather(1, lab.reshape(n, -1)).reshape(n, size, size)
        lab = torch.where((torch.arange(n, device=DEV) % 2 == 1)[:, None, None],
                          lab.transpose(1, 2), lab)
        palette = (palette + 0.5 * torch.randn((n, nc + 1, 3), generator=g, device=DEV)
                   + 0.5 * torch.randn((n, 1, 3), generator=g, device=DEV))
    lab = lab.to(torch.int32).contiguous()
    lab[:, :8] = IGNORE
    colour = palette[torch.arange(n, device=DEV)[:, None, None], lab.clamp_max(nc).long()]
    img = colour + 0.5 * torch.randn((n, size, size, 3), generator=g, device=DEV)
    return {"image": img, "label": lab}


def m2f_batch(seed=700):
    """The slice's fixed learnable batch: ``block_batch`` of the 19 classes."""
    return block_batch(M2F_B, M2F_IMG, NC, 5, seed)


def m2f_model(dtype=torch.bfloat16, **head_kwargs):
    from segmentation_factory_tpu_torch import build_model

    return build_model("mit_b2", "mask2formerhead", NC, dtype=dtype, seed=0, device=DEV,
                       head_kwargs=head_kwargs or None)


M2F_PER_FORWARD = {"sra_attention": 3, "mixffn": 3, "attn_block": 13, "ffn_block": 13,
                   "ms_deform_attn": M2F_LAYERS, "resize_argmax": 1}
M2F_PER_STEP = {"sra_attention": 3, "sra_attention_bwd": 3, "mixffn": 3, "mixffn_bwd": 3,
                "attn_block": 13, "attn_block_bwd": 13, "ffn_block": 13, "ffn_block_bwd": 13,
                "ms_deform_attn": M2F_LAYERS, "ms_deform_attn_bwd": M2F_LAYERS,
                "lowres_loss_fwd": 1, "lowres_loss_bwd": 1}


def m2f_serve(KERNELS):
    """``predict_step`` on 3 batches and ``eval_step`` on one (bf16), the
    launches per forward; float32 labels through the kernels against the
    plain versions; the bf16 labels against the float32 plain ones outside
    near-ties (``phase_serve``'s bars)."""
    from segmentation_factory_tpu_torch.engine import eval_step, predict_step
    from segmentation_factory_tpu_torch.models.layers import resize

    res = {}
    model = m2f_model()
    x = [torch.randn((M2F_B, M2F_IMG, M2F_IMG, 3), generator=gen(710 + i), device=DEV)
         for i in range(3)]
    lab = m2f_batch(720)["label"]
    predict_step(model, x[0])
    torch.cuda.synchronize()
    for fn in KERNELS.values():
        fn.launches = 0
    preds = [predict_step(model, xi) for xi in x]
    hist = eval_step(model, {"image": x[0], "label": lab},
                     torch.zeros((NC, NC), dtype=torch.int64, device=DEV))
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    res["launches"], res["forwards"] = counts, 4
    res["launches_ok"] = all(counts[k] == M2F_PER_FORWARD.get(k, 0) * 4 for k in counts)
    res["shapes_ok"] = all(p.shape == (M2F_B, M2F_IMG, M2F_IMG) and p.dtype == torch.int32
                           and int(p.min()) >= 0 and int(p.max()) < NC for p in preds)
    res["hist_ok"] = int(hist.sum()) == int((lab < NC).sum())
    m32 = m2f_model(torch.float32)
    with torch.inference_mode():
        lo_k = m32(x[0], resize_output=False)
        lab_k = predict_step(m32, x[0])
        with plain_path():
            lo_p = m32(x[0], resize_output=False)
            lab_p = predict_step(m32, x[0])
        lo_16 = model(x[0], resize_output=False)
        up_p = resize(lo_p, (M2F_IMG, M2F_IMG))
    res["f32_kernels_vs_plain"] = agreement(lab_k, lab_p, up_p)
    res["f32_logits_max_abs_err"] = max_err(lo_k, lo_p)
    res["bf16_vs_f32_plain"] = agreement(preds[0], lab_p, up_p)
    res["bf16_logits_max_abs_err"] = max_err(lo_16, lo_p)
    finite = bool(torch.isfinite(lo_16).all() and torch.isfinite(lo_k).all())
    res["ok"] = (res["launches_ok"] and res["shapes_ok"] and res["hist_ok"] and finite
                 and res["f32_kernels_vs_plain"]["agree"] >= AGREE
                 and (res["bf16_vs_f32_plain"]["disagree_gap_max"]
                      <= 2 * res["bf16_logits_max_abs_err"]))
    del m32, up_p
    return res, model, counts


def m2f_train(KERNELS, mask_loss):
    """``M2F_STEPS`` train steps on one fixed batch (the bench cell's
    optimizer: AdamW wd 1e-4, AGC 0.02, cosine to 1e-3 after 100 warm-up
    steps from 1e-6): CE + dice on the semantic log-probabilities (K7), or
    the Hungarian mask loss; each step's launches; a finite, falling loss;
    a profile of one step."""
    from segmentation_factory_tpu_torch.engine import create_optimizer, train_step
    from segmentation_factory_tpu_torch.schedule import create_schedule

    model = m2f_model(**({"mask_loss": True} if mask_loss else {}))
    opt = create_optimizer("adamw", create_schedule(
        "cosine", 1e-3, total_steps=160 * 100, warmup_steps=M2F_WARMUP, warmup_lr_init=1e-6,
        min_lr=1e-5), weight_decay=1e-4, clip_grad=0.02, clip_mode="agc",
        params=model.named_parameters())
    batch = m2f_batch()
    torch.cuda.reset_peak_memory_stats()
    want = dict(M2F_PER_STEP, lowres_loss_fwd=0, lowres_loss_bwd=0) if mask_loss else M2F_PER_STEP

    def step():
        return train_step(model, opt, batch, generator=torch.Generator(device=DEV).manual_seed(0),
                          loss_type="ce", use_dice=True)

    losses, counts, skipped = [], [], []
    t0 = time.perf_counter()
    for _ in range(M2F_STEPS):
        for fn in KERNELS.values():
            fn.launches = 0
        out = step()
        torch.cuda.synchronize()
        counts.append({k: fn.launches for k, fn in KERNELS.items()})
        losses.append(float(out["loss"]))
        skipped.append(int(out["skipped_nonfinite"]))
    seconds = time.perf_counter() - t0
    # CE + dice: the last loss below the first. The mask loss jumps where
    # the matching or a query's all-blocked attention mask switches (the
    # plain versions' float32 trajectory jumps at the same steps: its
    # ``f32_kernels_vs_plain``), so it falls where a later loss is below
    # the first
    falls = (min(losses[1:]) if mask_loss else losses[-1]) < losses[0]
    res = {"loss": "mask2former (Hungarian)" if mask_loss else "ce+dice", "losses": losses,
           "skipped": skipped, "launches_per_step": counts,
           "launches_ok": all(all(c[k] == want.get(k, 0) for k in c) for c in counts),
           "loss_falls": falls,
           "train_images_per_s": M2F_STEPS * M2F_B / seconds,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    res["profile"] = profile_step(step)
    del model, opt
    res["f32_kernels_vs_plain"] = m2f_f32_step(mask_loss, batch)
    res["ok"] = (res["launches_ok"] and res["loss_falls"] and not any(skipped)
                 and all(math.isfinite(v) for v in losses) and res["f32_kernels_vs_plain"]["ok"])
    return res, counts


def m2f_f32_step(mask_loss, batch):
    """One float32 step's loss and gradients through the kernels and through
    the plain versions (``plain_path``), same weights, batch and
    drop-path draw, under phase ``train``'s bars (the loss within
    ``LOSS_REL``, each gradient within ``GRAD_REL`` of its largest plain
    entry plus ``GRAD_ABS`` of the model's largest); then ``M2F_STEPS``
    steps of each from the same start, their losses side by side (the
    first three within ``LOSS_REL``)."""
    from segmentation_factory_tpu_torch.engine import compute_loss, create_optimizer, train_step
    from segmentation_factory_tpu_torch.schedule import create_schedule

    kw = {"mask_loss": True} if mask_loss else {}
    m32 = m2f_model(torch.float32, **kw).train()
    noise = m32.sample_noise(M2F_B, torch.Generator(device=DEV).manual_seed(1))
    params = [p for _, p in m32.named_parameters()]

    def loss_and_grads():
        out = m32(batch["image"], resize_output=False, noise=noise)
        loss = compute_loss(out, batch["label"], IGNORE, "ce", True)
        return loss.detach(), torch.autograd.grad(loss, params, allow_unused=True)

    lk, gk = loss_and_grads()
    with plain_path():
        lp, gp = loss_and_grads()
    res = {"loss_kernels": float(lk), "loss_plain": float(lp),
           "loss_rel_err": abs(float(lk) - float(lp)) / abs(float(lp))}
    grads = grad_check(m32, gk, gp)
    res.update(grad_worst_err_over_bar=grads["worst_err_over_bar"],
               grad_worst_param=grads["worst_param"])
    del m32, gk, gp, params
    trajectories = {}
    for route in ("kernels", "plain"):
        model = m2f_model(torch.float32, **kw)
        opt = create_optimizer("adamw", create_schedule(
            "cosine", 1e-3, total_steps=160 * 100, warmup_steps=M2F_WARMUP,
            warmup_lr_init=1e-6, min_lr=1e-5), weight_decay=1e-4, clip_grad=0.02,
            clip_mode="agc", params=model.named_parameters())
        ctx = plain_path() if route == "plain" else contextlib.nullcontext()
        with ctx:
            trajectories[route] = [float(train_step(
                model, opt, batch, generator=torch.Generator(device=DEV).manual_seed(0),
                loss_type="ce", use_dice=True)["loss"]) for _ in range(M2F_STEPS)]
        del model, opt
    res["losses_kernels"], res["losses_plain"] = trajectories["kernels"], trajectories["plain"]
    # the first three steps, before a rounding difference can switch a
    # matching or an attention mask
    res["first_steps_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(
        trajectories["kernels"][:3], trajectories["plain"][:3]))
    res["ok"] = (res["loss_rel_err"] <= LOSS_REL and grads["ok"]
                 and res["first_steps_rel_err"] <= LOSS_REL)
    return res


def k9_gathers(K9, levels, loc, v, backward):
    """What K9's kernels move besides the bound's bytes: the corner rows
    they gather (4 L P an item, each D values of value's dtype, read from
    L2 since value fits in it; a corner outside its map is loaded clamped
    and weighted 0) and their bytes against value's size. For K9b, its plan
    (``K9.bwd_plan``): the share of blocks' levels, of points and of
    in-bounds corner rows that take the shared-memory window and the
    straight route, and the 16-byte vector reductions into d(value): the
    straight rows' and each window pixel's one (a window pixel no corner
    reached adds nothing)."""
    b, s, m, d = v.shape
    rows = loc.numel() // 2 * 4
    out = {"corner_rows": rows, "l2_gather_bytes": rows * d * v.element_size(),
           "times_value_bytes": rows / (b * s * m)}
    if not backward:
        return out
    plan = K9.bwd_plan(levels, loc, d)
    qt, cap, _ = K9.window_geometry(d)
    q, p = loc.shape[1], loc.shape[4]
    inb, via, xy, _ = K9.plan_routes(plan, levels, loc)
    inside, window_rows = int(inb.sum()), int(via.sum())
    points_window = int(via.any(-1).sum())  # points with a corner in their window
    # window pixels some corner reached: one reduction a 16 bytes each
    b_i = torch.arange(b, device=DEV).view(b, 1, 1, 1, 1, 1)
    m_i = torch.arange(m, device=DEV).view(1, 1, m, 1, 1, 1)
    t_i = (torch.arange(q, device=DEV) // qt).view(1, q, 1, 1, 1, 1)
    l_i = torch.arange(len(levels), device=DEV).view(1, 1, 1, -1, 1, 1)
    side = max(max(h, w) for h, w in levels)
    key = ((((b_i * m + m_i) * plan["tiles"] + t_i) * len(levels) + l_i) * side
           + xy[..., 1]) * side + xy[..., 0]
    pixels = int(torch.unique(key[via]).numel())
    straight = inside - window_rows
    points = b * q * m * len(levels) * p
    out.update({
        "in_bounds_rows": inside, "queries_a_block": qt, "window_pixels": cap,
        "route_share": {
            "blocks_levels_window": plan["windowed"].float().mean().item(),
            "points_window": points_window / points,
            "points_straight_only": 1 - points_window / points,
            "rows_window": window_rows / inside, "rows_straight": straight / inside},
        "dvalue_reductions_16B": (straight + pixels) * d // 4,
        "dvalue_reductions_16B_all_straight": inside * d // 4,
        "dvalue_reduction_bytes": (straight + pixels) * d * 4})
    return out


def k9_times(K9):
    """K9f and K9b at the slice's shapes: CUDA events and kernel time, the
    plain version's events, the grid_sample composition's events and kernel
    time (forward; its autograd for K9b), the bound (each input read once,
    each output written once; the operations at the float32 rate)."""
    b, levels, m, d, p, px = K9_SHAPES["slice"]
    v, loc, attn = k9_inputs(torch.bfloat16, b, levels, m, d, p, px, 970)
    q, n = loc.shape[1], len(levels)
    g = randn((b, q, m * d), gen(971))
    fwd = lambda: K9.ms_deform_attn(v, levels, loc, attn)  # noqa: E731
    plain = lambda: K9.ms_deform_attn_plain(v, levels, loc, attn)  # noqa: E731
    lib = lambda: k9_grid_sample(v, levels, loc, attn)  # noqa: E731
    bwd = lambda: K9.ms_deform_attn_bwd(v, levels, loc, attn, g)  # noqa: E731
    plain_b = lambda: K9.ms_deform_attn_bwd_plain(v, levels, loc, attn, g)  # noqa: E731
    args = [t.detach().requires_grad_() for t in (v, loc, attn)]
    lib_out = k9_grid_sample(*args[:1], levels, *args[1:])
    lib_b = lambda: torch.autograd.grad(lib_out, args, g, retain_graph=True)  # noqa: E731
    points = b * q * m * n * p
    in_bytes = v.numel() * v.element_size() + 4 * loc.numel() + 4 * attn.numel()
    out = {}
    # K9b's outputs have its inputs' sizes and dtypes: d(value), d(loc), d(attn)
    cases = (("ms_deform_attn", fwd, plain, lib, in_bytes + 4 * b * q * m * d),
             ("ms_deform_attn_bwd", bwd, plain_b, None, in_bytes + 4 * g.numel() + in_bytes))
    for name, kern, pl, lb, nbytes in cases:
        # a point's 4 corners: K9f an FMA a channel; K9b a dot with g and
        # the scaled row added into d(value), an FMA and a multiply-add
        flops = points * 4 * d * (2 if name == "ms_deform_attn" else 4)
        trace = kernel_trace(kern)
        lib_fn = lb if lb is not None else lib_b
        lib_trace = kernel_trace(lib_fn)
        b_ms, by, ops_ms, bytes_ms = bound_ms(flops, nbytes, PEAK_F32)
        out[name] = {"shape": f"value {tuple(v.shape)} bf16, loc {tuple(loc.shape)} f32",
                     "gathers": k9_gathers(K9, levels, loc, v, name == "ms_deform_attn_bwd"),
                     "ms": cuda_ms(kern), "device_ms": device_ms(trace),
                     "plain_ms": cuda_ms(pl),
                     "library_ms": cuda_ms(lib_fn), "library_device_ms": device_ms(lib_trace),
                     "library": ("F.grid_sample per level (3 calls) + the weighted sum"
                                 + ("" if lb is not None else ", its autograd")),
                     "bound_ms": b_ms, "bound_by": by, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                     "bytes": nbytes, "flops": flops, "kernels": trace}
    return out


def phase_m2f(KERNELS):
    """The slice on the card: K9 against its plain version (``k9_checks``),
    serving (``m2f_serve``), both training routes (``m2f_train``), K9's
    times (``k9_times``), the predict's profile. Returns the phase, its
    launches by path and K9's per-step totals for the ``kernels`` line."""
    from segmentation_factory_tpu_torch.engine import predict_step
    from segmentation_factory_tpu_torch.ops import msdeform as K9

    res = {"phase": "m2f", "model": "mit_b2+mask2formerhead", "embed_dim": 768, "heads": 8,
           "head_dim": 96, "pixel_layers": M2F_LAYERS, "decoder_layers": 9, "queries": 100,
           "batch": M2F_B, "image": M2F_IMG, "classes": NC, "dtype": "bfloat16"}
    t = time.perf_counter()
    res["checks"] = k9_checks(K9)
    res["checks_seconds"] = time.perf_counter() - t
    paths = []
    res["serve"], model, served = m2f_serve(KERNELS)
    paths.append(served)
    x = torch.randn((M2F_B, M2F_IMG, M2F_IMG, 3), generator=gen(730), device=DEV)
    res["profile_predict"] = profile_step(lambda: predict_step(model, x))
    del model
    for mask_loss in (False, True):
        key = "train_mask_loss" if mask_loss else "train_ce_dice"
        res[key], counts = m2f_train(KERNELS, mask_loss)
        paths.extend(counts)
    res["times"] = k9_times(K9)
    totals = {name: {**{k: (None if t[k] is None else M2F_LAYERS * t[k])
                        for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                  "library_device_ms")},
                     **{k: M2F_LAYERS * t[k] for k in ("bound_ms", "ops_ms", "bytes_ms")}}
              for name, t in res["times"].items()}
    res["ok"] = (all(v["ok"] for v in res["checks"].values()) and res["serve"]["ok"]
                 and res["train_ce_dice"]["ok"] and res["train_mask_loss"]["ok"])
    return res, paths, totals


def slice_export(KERNELS, root, model, desc, op, per_forward, batch, img, nc, seed):
    """A slice's model (bf16) through ``export.export_model`` at a dynamic
    batch: its graph holds the ``sft::`` forward op ``op``; loaded and
    called at batch 1 and ``batch``, its launches a forward
    (``per_forward`` without K8: the program returns logits), its logits
    within the export check's 5e-2 of the live model's at the same batch
    and its labels equal outside near-ties."""
    from segmentation_factory_tpu_torch import export

    res = {"model": desc, "image": img, "batch": batch, "dtype": "bfloat16"}
    art = str(root / f"{desc.replace('+', '_')}_{img}.pt2")
    t0 = time.perf_counter()
    program = export.export_model(model, img, art)
    res["export_s"] = time.perf_counter() - t0
    ops = sorted({str(n.target) for n in program.graph.nodes
                  if n.op == "call_function" and str(n.target).startswith("sft.")})
    res["graph_sft_ops"] = ops
    t0 = time.perf_counter()
    prog = export.load_exported(art).module()
    res["load_s"] = time.perf_counter() - t0
    x = torch.randn((batch, img, img, 3), generator=gen(seed), device=DEV)
    with torch.inference_mode():
        live, live1 = model(x), model(x[:1])
        out1 = prog(x[:1])
        for fn in KERNELS.values():
            fn.launches = 0
        out = prog(x)
        torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    want = dict(per_forward, resize_argmax=0)
    res["launches"] = counts
    res["launches_ok"] = all(counts[k] == want.get(k, 0) for k in counts)
    res["exported_vs_live_max_abs_err"] = max_err(out, live)
    res["exported_b1_vs_live_max_abs_err"] = max_err(out1, live1)
    agree = {}
    # each batch against the live model at that batch: bf16 products at
    # another batch may round otherwise
    for tag, got, ref in ((f"b{batch}", out, live), ("b1", out1, live1)):
        # near-ties: the live top-2 gap within twice the largest difference
        # of the live top class's logit (Mask2Former's: its log-probability;
        # the clip at 1e-6 makes unlikely classes' differ more in bf16)
        top = torch.topk(ref.float(), 2, dim=-1)
        pick = top.indices[..., :1]
        err = max_err(got.float().gather(-1, pick), ref.float().gather(-1, pick))
        clear = (top.values[..., 0] - top.values[..., 1]) > max(TIE_GAP, 2 * err)
        same = got.argmax(-1) == ref.argmax(-1)
        agree[tag] = {"top_class_max_abs_err": err, "near_tie_share": 1 - float(clear.float().mean()),
                      "label_agree_outside_ties": float(same[clear].float().mean())}
    res["agreement"] = agree
    res["ok"] = (f"sft.{op}.default" in ops and res["launches_ok"]
                 and tuple(out.shape) == (batch, img, img, nc)
                 and tuple(out1.shape) == (1, img, img, nc)
                 and bool(torch.isfinite(out).all())
                 and res["exported_vs_live_max_abs_err"] <= export.BF16_ATOL
                 and res["exported_b1_vs_live_max_abs_err"] <= export.BF16_ATOL
                 and all(a["label_agree_outside_ties"] >= AGREE for a in agree.values()))
    del prog, program, live, live1, out, out1
    torch.cuda.empty_cache()
    return res, counts


# ------------------------------------------------------------------ the zoo (phase zoo)

# model A: caformer_s18 + uperhead on config #2's file (ADE20K, 150 classes,
# E = 128, CE + dice, AdamW wd 0.05); model B: resnet50 + deeplabv3 on config
# #1's (VOC, 21 classes, E = 768 by the default rule, AdamW wd 1e-4, the
# loss on [main, aux] weighted (1, 0.4)); both 512², batch 16, bf16, AGC 0.02
# and the cosine schedule to 1e-3 (warm-up cut to 100 steps from 1e-6, as
# phase m2f's, so that a few steps move the loss)
ZOO_B, ZOO_IMG, ZOO_STEPS, ZOO_WARMUP = 16, 512, 4, 100
ZOO_MODELS = {
    "A": {"config": CONFIG2, "model": {"backbone": "caformer_s18"}, "classes": 150,
          "embed_dim": 128, "weight_decay": 0.05},
    "B": {"config": CONFIG1, "model": {"backbone": "resnet50", "head": "deeplabv3",
                                       "embed_dim": None},
          "classes": 21, "embed_dim": None, "weight_decay": 1e-4},
}
# CAFormer-S18's 9 + 3 attention blocks (stages 3-4) launch K1f a forward
# and K1b a step each; DeepLabV3's aux output takes K7f / K7b a second time
ZOO_PER_FORWARD = {"A": {"sra_attention": 12, "resize_argmax": 1}, "B": {"resize_argmax": 1}}
ZOO_PER_STEP = {"A": {"sra_attention": 12, "sra_attention_bwd": 12, "lowres_loss_fwd": 1,
                      "lowres_loss_bwd": 1},
                "B": {"lowres_loss_fwd": 2, "lowres_loss_bwd": 2}}
# K1 at N = M with head dim 32: (batch, tokens, heads) of model A's stage 3
# and 4 at 512² and batch 16, caformer_b36's stage 4 (24 heads), the ragged
# 24² / 12² maps of a 0.75x eval of 512² (576 and 144 tokens: partial
# 64-row tiles) and stage 3 of a 1024² eval (4096 tokens)
ZOO_ATTN = {"s18_s3": (16, 1024, 10), "s18_s4": (16, 256, 16), "b36_s4": (16, 256, 24),
            "ragged_576": (2, 576, 10), "ragged_144": (2, 144, 16),
            "eval1024_s3": (1, 4096, 10)}
ZOO_VARIANTS = ("identityformer_s12", "randformer_s12", "poolformerv2_s12", "convformer_s18",
                "convnextv2_atto")


def attention_blocks(backbone: str) -> int:
    """K1 launches a forward of ``backbone``: CAFormer's stage-3 and -4
    blocks, 0 for any other."""
    from segmentation_factory_tpu_torch.models.backbones.metaformer import metaformer_settings

    family, _, variant = backbone.partition("_")
    if family != "caformer":
        return 0
    depths = metaformer_settings(family, variant.split("_")[0])[1]
    return depths[2] + depths[3]


def zoo_model(key, dtype=torch.bfloat16, backbone=None):
    """Model ``key``'s network (or ``backbone`` with model A's head, classes
    and width), seeded, built for ``ZOO_IMG``²."""
    from segmentation_factory_tpu_torch import build_model

    spec = ZOO_MODELS[key]
    m = spec["model"]
    return build_model(backbone or m["backbone"], m.get("head", "uperhead"), spec["classes"],
                       embed_dim=spec["embed_dim"], dtype=dtype, seed=0, device=DEV,
                       img_size=ZOO_IMG)


def zoo_optimizer(model, key):
    from segmentation_factory_tpu_torch.engine import create_optimizer
    from segmentation_factory_tpu_torch.schedule import create_schedule

    sched = create_schedule("cosine", 1e-3, total_steps=130 * 1263, warmup_steps=ZOO_WARMUP,
                            warmup_lr_init=1e-6, min_lr=1e-5)
    return create_optimizer("adamw", sched, weight_decay=ZOO_MODELS[key]["weight_decay"],
                            clip_grad=0.02, clip_mode="agc", params=model.named_parameters())


def zoo_batch(nc, batch=None, seed=1200):
    """``block_batch`` of ``batch`` (``ZOO_B``) images of ``ZOO_IMG``², each
    a scene of 8 classes of its own."""
    return block_batch(batch or ZOO_B, ZOO_IMG, nc, 7, seed, classes=8)


def zoo_attn_inputs(b, n, heads, dtype, seed):
    g = gen(seed)
    return [randn((b, n, heads, 32), g, dtype=dtype) for _ in range(3)]


def zoo_checks(K1, K7, K8):
    """K1f / K1b at ``ZOO_ATTN``'s shapes (N = M, head dim 32) and K7f / K7b
    / K8 at an upsampling ratio of 32 (16 images of 16 x 16 logits, 21
    classes, to 512² labels with void pixels), then on the logits model B
    hands them in a training forward (its main and aux outputs) and an
    eval forward, against the plain versions under phase check's bars."""
    res = {}
    sc = 32 ** -0.5
    k1 = lambda q, k, v: K1.sra_attention(q, k, v, sc)  # noqa: E731
    p1 = lambda q, k, v: K1.sra_attention_plain(q, k, v, sc)  # noqa: E731
    for j, (tag, (b, n, heads)) in enumerate(ZOO_ATTN.items()):
        make = lambda dt, b=b, n=n, h=heads, j=j: zoo_attn_inputs(b, n, h, dt, 1300 + j)  # noqa: E731
        res[f"sra_attention:zoo_{tag}"] = check_pair(k1, p1, make)
        res[f"sra_attention_bwd:zoo_{tag}"] = check_grads(
            k1, p1, bwd_inputs(make, lambda x: x[0].shape, 1320 + j))
        torch.cuda.empty_cache()
    lab = zoo_batch(21, seed=1340)["label"]
    lab[:, ZOO_IMG // 5:ZOO_IMG // 4, ZOO_IMG // 3:ZOO_IMG // 2] = IGNORE  # a void block
    lo = randn((ZOO_B, ZOO_IMG // 32, ZOO_IMG // 32, 21), gen(1341), 2.0)
    res.update(zoo_loss_checks(K7, K8, lab, lo, lo, "ratio32"))
    del lo
    # model B's own logits: a training forward ([main, aux] at stride 32)
    # and an eval forward, bf16, on a batch of its classes
    model = zoo_model("B")
    batch = zoo_batch(21, seed=1342)
    with torch.no_grad():
        lo_eval = model(batch["image"], resize_output=False)
        main, aux = model.train()(batch["image"], resize_output=False, generator=gen(1343))
    del model
    res.update(zoo_loss_checks(K7, K8, batch["label"], main.float(), lo_eval.float(),
                               "model_b_main"))
    res.update(zoo_loss_checks(K7, None, batch["label"], aux.float(), None, "model_b_aux"))
    del main, aux, lo_eval, batch
    torch.cuda.empty_cache()
    return res


def zoo_loss_checks(K7, K8, lab, lo_train, lo_eval, tag):
    """K7f (loss map, dice partials, their bits across two calls) and K7b
    (the fused CE + dice criterion's gradient) on ``lo_train``, K8 on
    ``lo_eval`` (unless None), against the plain versions."""
    res = loss_fwd_checks(K7, lab, lambda dt: [lo_train.to(dt)], tag)
    res[f"lowres_loss_bwd:{tag}"] = check_grads(
        lambda lo: K7.lowres_criterion(lo, lab, IGNORE, True, "ce"),
        lambda lo: K7.fused_criterion_plain(lo, lab, "ce", True, IGNORE),
        lambda dt: ([lo_train.to(dt)], torch.ones((), device=DEV)))
    if K8 is not None and lo_eval is not None:
        res[f"resize_argmax:{tag}"] = argmax_check(K8, lambda dt: [lo_eval.to(dt)],
                                                   tuple(lab.shape[1:]))
        res[f"resize_argmax:{tag}"]["logits"] = list(lo_eval.shape)
    return res


def zoo_serve(KERNELS, key):
    """Model ``key``: ``predict_step`` on 2 batches and ``eval_step`` on one
    (bf16), the launches per forward (``ZOO_PER_FORWARD``); float32 labels
    through the kernels against the plain versions, and the bf16 labels
    against the float32 plain ones outside near-ties (phase serve's bars);
    predict images/s."""
    from segmentation_factory_tpu_torch.engine import eval_step, predict_step
    from segmentation_factory_tpu_torch.models.layers import resize

    nc = ZOO_MODELS[key]["classes"]
    res = {}
    model = zoo_model(key)
    x = [torch.randn((ZOO_B, ZOO_IMG, ZOO_IMG, 3), generator=gen(1400 + i), device=DEV)
         for i in range(2)]
    lab = zoo_batch(nc, seed=1410)["label"]
    predict_step(model, x[0])
    torch.cuda.synchronize()
    for fn in KERNELS.values():
        fn.launches = 0
    preds = [predict_step(model, xi) for xi in x]
    hist = eval_step(model, {"image": x[0], "label": lab},
                     torch.zeros((nc, nc), dtype=torch.int64, device=DEV))
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    res["launches"], res["forwards"] = counts, 3
    res["launches_ok"] = all(counts[k] == ZOO_PER_FORWARD[key].get(k, 0) * 3 for k in counts)
    res["shapes_ok"] = all(p.shape == (ZOO_B, ZOO_IMG, ZOO_IMG) and p.dtype == torch.int32
                           and int(p.min()) >= 0 and int(p.max()) < nc for p in preds)
    res["hist_ok"] = int(hist.sum()) == int((lab < nc).sum())
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        predict_step(model, x[1])
    torch.cuda.synchronize()
    res["predict_images_per_s"] = n * ZOO_B / (time.perf_counter() - t0)
    res["profile_predict"] = profile_step(lambda: predict_step(model, x[1]))
    m32 = zoo_model(key, torch.float32)
    with torch.inference_mode():
        lo_k = m32(x[0], resize_output=False)
        lab_k = predict_step(m32, x[0])
        with plain_path():
            lo_p = m32(x[0], resize_output=False)
            lab_p = predict_step(m32, x[0])
        lo_16 = model(x[0], resize_output=False)
        up_p = resize(lo_p, (ZOO_IMG, ZOO_IMG))
    res["f32_kernels_vs_plain"] = agreement(lab_k, lab_p, up_p)
    res["f32_logits_max_abs_err"] = max_err(lo_k, lo_p)
    res["bf16_vs_f32_plain"] = agreement(preds[0], lab_p, up_p)
    res["bf16_logits_max_abs_err"] = max_err(lo_16, lo_p)
    finite = bool(torch.isfinite(lo_16).all() and torch.isfinite(lo_k).all())
    res["ok"] = (res["launches_ok"] and res["shapes_ok"] and res["hist_ok"] and finite
                 and res["f32_kernels_vs_plain"]["agree"] >= AGREE
                 and (res["bf16_vs_f32_plain"]["disagree_gap_max"]
                      <= 2 * res["bf16_logits_max_abs_err"]))
    del m32, model, up_p, lo_k, lo_p, lo_16
    torch.cuda.empty_cache()
    return res, counts


def zoo_train(KERNELS, key):
    """Model ``key``: ``ZOO_STEPS`` train steps of CE + dice on one fixed
    batch, the launches per step (``ZOO_PER_STEP``), a finite, falling
    loss, train images/s and a profile of one step; then one float32 step
    on the same weights, batch and noise: the loss through the kernels
    against the plain versions (``plain_path``) within ``LOSS_REL``, and
    every gradient through the kernels against the plain backwards on the
    kernels' own forward (``plain_backward``) under phase train's bar
    (``grad_check``). The gradients of the whole plain route are reported
    beside it, not held to that bar: in these models at initialisation a
    change of every input pixel by one unit in the last place already moves
    some of them past it (``plain_1ulp``), so a difference of rounding in
    the forward, which the kernels' forwards make, is amplified there
    beyond anything the kernels decide."""
    from segmentation_factory_tpu_torch.engine import compute_loss, train_step

    nc = ZOO_MODELS[key]["classes"]
    model = zoo_model(key)
    opt = zoo_optimizer(model, key)
    batch = zoo_batch(nc)
    torch.cuda.reset_peak_memory_stats()

    def step():
        return train_step(model, opt, batch, generator=torch.Generator(device=DEV).manual_seed(0),
                          loss_type="ce", use_dice=True)

    losses, counts, skipped = [], [], []
    for _ in range(ZOO_STEPS):
        for fn in KERNELS.values():
            fn.launches = 0
        out = step()
        torch.cuda.synchronize()
        counts.append({k: fn.launches for k, fn in KERNELS.items()})
        losses.append(float(out["loss"]))
        skipped.append(int(out["skipped_nonfinite"]))
    t0 = time.perf_counter()
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    res = {"loss": "ce+dice" + (" on [main, aux] (1, 0.4)" if key == "B" else ""),
           "losses": losses, "skipped": skipped, "launches_per_step": counts,
           "launches_ok": all(all(c[k] == ZOO_PER_STEP[key].get(k, 0) for k in c)
                              for c in counts),
           "loss_falls": losses[-1] < losses[0],
           "train_images_per_s": 2 * ZOO_B / (time.perf_counter() - t0),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    res["profile"] = profile_step(step)
    del model, opt

    m32 = zoo_model(key, torch.float32).train()
    noise = m32.sample_noise(ZOO_B, torch.Generator(device=DEV).manual_seed(1),
                             (ZOO_IMG, ZOO_IMG))
    params = [p for _, p in m32.named_parameters()]

    def loss_and_grads(x):
        out = m32(x, resize_output=False, noise=noise)
        loss = compute_loss(out, batch["label"], IGNORE, "ce", True)
        return loss.detach(), torch.autograd.grad(loss, params, allow_unused=True)

    x = batch["image"]
    lk, gk = loss_and_grads(x)
    with plain_backward():
        _, gb = loss_and_grads(x)
    grads = grad_check(m32, gk, gb)
    with plain_path():
        lp, gp = loss_and_grads(x)
        _, gu = loss_and_grads(torch.nextafter(x, torch.full_like(x, math.inf)))
    res.update(f32_loss_kernels=float(lk), f32_loss_plain=float(lp),
               f32_loss_rel_err=abs(float(lk) - float(lp)) / abs(float(lp)),
               f32_grads_vs_plain_backward=grads,
               f32_grad_bar={"rel": GRAD_REL, "abs_of_largest": GRAD_ABS},
               f32_grads_vs_plain_route={"kernels": grad_check(m32, gk, gp),
                                         "plain_1ulp": grad_check(m32, gu, gp)})
    res["ok"] = (res["launches_ok"] and res["loss_falls"] and not any(skipped)
                 and all(math.isfinite(v) for v in losses)
                 and res["f32_loss_rel_err"] <= LOSS_REL and grads["ok"])
    del m32, gk, gb, gp, gu, params
    torch.cuda.empty_cache()
    return res, counts


@contextlib.contextmanager
def plain_backward():
    """Keep the kernels' forwards (K1f, K7f) and take the plain versions of
    their backwards (K1b, K7b) from the forwards' own saved outputs."""
    from segmentation_factory_tpu_torch.ops import lowres_loss
    from segmentation_factory_tpu_torch.ops import sra_attention as K1

    def k1b_plain(q, k, v, out, lse, g, scale):
        dq, dk, dv, _, _ = K1.sra_attention_bwd_plain(q, k, v, out, g, lse, scale)
        return dq, dk.to(k.dtype), dv.to(v.dtype)

    saved = K1.sra_attention_bwd, lowres_loss.lowres_loss_bwd
    K1.sra_attention_bwd, lowres_loss.lowres_loss_bwd = k1b_plain, lowres_loss.lowres_loss_bwd_plain
    try:
        yield
    finally:
        K1.sra_attention_bwd, lowres_loss.lowres_loss_bwd = saved


def zoo_variants(KERNELS):
    """One predict and one train step of each of ``ZOO_VARIANTS`` + UPerHead
    (model A's head, classes and width) at 512², batch 2, bf16: finite
    outputs of the expected shapes, the K7 / K8 launches and no K1;
    RandFormer-S12 (built for 512²) also predicts at 384² and 768², through
    its resampled mixing matrices."""
    from segmentation_factory_tpu_torch.engine import predict_step, train_step

    out = {}
    nc = ZOO_MODELS["A"]["classes"]
    batch = zoo_batch(nc, batch=2, seed=1500)
    for name in ZOO_VARIANTS:
        model = zoo_model("A", backbone=name)
        opt = zoo_optimizer(model, "A")
        for fn in KERNELS.values():
            fn.launches = 0
        pred = predict_step(model, batch["image"])
        step = train_step(model, opt, batch, generator=torch.Generator(device=DEV).manual_seed(0),
                          loss_type="ce", use_dice=True)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in KERNELS.items()}
        want = {"resize_argmax": 1, "lowres_loss_fwd": 1, "lowres_loss_bwd": 1}
        r = {"loss": float(step["loss"]), "launches": counts,
             "launches_ok": all(counts[k] == want.get(k, 0) for k in counts),
             "pred_ok": pred.shape == (2, ZOO_IMG, ZOO_IMG) and int(pred.max()) < nc}
        sizes_ok = True
        if name.startswith("randformer"):
            for s in (384, 768):
                p = predict_step(model.eval(), torch.randn((1, s, s, 3), generator=gen(1510 + s),
                                                           device=DEV))
                sizes_ok = sizes_ok and p.shape == (1, s, s) and int(p.max()) < nc
            r["resampled_384_768_ok"] = sizes_ok
        r["ok"] = (r["launches_ok"] and r["pred_ok"] and sizes_ok and math.isfinite(r["loss"])
                   and not int(step["skipped_nonfinite"]))
        out[name] = r
        del model, opt
        torch.cuda.empty_cache()
    return out


def zoo_times(K1, K7, K8):
    """K1f / K1b at model A's two shapes (bf16) and K7f / K7b / K8 at ratio
    32 (model B's 16 x 16 x 21 logits to 512², float32): CUDA events, the
    profiler's kernel time, the plain version's events, the library call's
    (``F.scaled_dot_product_attention`` and its autograd for K1) and the
    bound (K1f 4·B·H·N·M·D FLOPs, K1b 10·, at the bf16 peak; K7 the
    exponentials on the SFUs, K8 8 operations a pixel and class; each
    input read once and each output written once)."""
    out = []

    def add(name, shape, kern, plain, lib, flops, nbytes, peak):
        trace = kernel_trace(kern)
        row = {"kernel": name, "shape": shape, "ms": cuda_ms(kern), "device_ms": device_ms(trace),
               "plain_ms": cuda_ms(plain), "library_ms": None, "library_device_ms": None}
        if lib is not None:
            row.update(library_ms=cuda_ms(lib), library_device_ms=device_ms(kernel_trace(lib)))
        b_ms, by, ops_ms, bytes_ms = bound_ms(flops, nbytes, peak)
        row.update(bound_ms=b_ms, bound_by=by, ops_ms=ops_ms, bytes_ms=bytes_ms)
        out.append(row)

    def backward_of(fn, args, g):
        args = [a.detach().requires_grad_() for a in args]
        o = fn(*args)
        return lambda: torch.autograd.grad(o, args, g, retain_graph=True)

    sc, bf = 32 ** -0.5, torch.bfloat16
    for j, tag in enumerate(("s18_s3", "s18_s4")):
        b, n, heads = ZOO_ATTN[tag]
        q, k, v = zoo_attn_inputs(b, n, heads, bf, 1600 + j)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        shape = f"model A {tag}: q=k=v({b},{n},{heads},32) bf16"
        add("sra_attention", shape, lambda: K1.sra_attention(q, k, v, sc),
            lambda: K1.sra_attention_plain(q, k, v, sc),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=sc),
            4.0 * b * heads * n * n * 32, 2 * 4 * q.numel(), PEAK_BF16)
        g = randn(q.shape, gen(1610 + j), dtype=bf)
        lse = torch.empty((b, heads, n), dtype=torch.float32, device=DEV)
        o = K1._forward(q, k, v, sc, lse)
        add("sra_attention_bwd", shape, lambda: K1.sra_attention_bwd(q, k, v, o, lse, g, sc),
            backward_of(lambda *a: K1.sra_attention_plain(*a, sc), [q, k, v], g),
            backward_of(lambda *a: F.scaled_dot_product_attention(*a, scale=sc), [qt, kt, vt],
                        g.transpose(1, 2).contiguous()),
            10.0 * b * heads * n * n * 32, 2 * 8 * q.numel() + 4 * lse.numel(), PEAK_BF16)
        del q, k, v, qt, kt, vt, g, lse, o
        torch.cuda.empty_cache()
    lab = zoo_batch(21, seed=1620)["label"]
    lo = randn((ZOO_B, ZOO_IMG // 32, ZOO_IMG // 32, 21), gen(1621), 2.0)
    pix, nc = lab.numel(), 21
    loss_map, parts = K7.lowres_loss_fwd(lo, lab)
    _, wmap = K7.ce_scalar_and_weights(loss_map, lab != IGNORE, "ce", lab)
    dcoef = torch.stack(K7.dice_coefs(parts[:, 0], parts[:, 1], parts[:, 2]), 1).contiguous()
    tag = "ratio 32"
    add("lowres_loss_fwd", f"{tag}: {tuple(lo.shape)} f32 -> ({ZOO_B},{ZOO_IMG},{ZOO_IMG})",
        lambda: K7.lowres_loss_fwd(lo, lab), lambda: K7.lowres_loss_plain(lo, lab), None,
        pix * nc, 4 * lo.numel() + 4 * pix + 4 * pix + 4 * parts.numel(), PEAK_SFU)
    add("lowres_loss_bwd", f"{tag}: ({ZOO_B},{ZOO_IMG},{ZOO_IMG}) -> {tuple(lo.shape)} f32",
        lambda: K7.lowres_loss_bwd(lo, lab, wmap, dcoef),
        lambda: K7.lowres_loss_bwd_plain(lo, lab, wmap, dcoef), None,
        pix * nc, 4 * lo.numel() + 4 * pix + 4 * pix + 4 * lo.numel(), PEAK_SFU)
    add("resize_argmax", f"{tag}: {tuple(lo.shape)} f32 -> ({ZOO_B},{ZOO_IMG},{ZOO_IMG}) int32",
        lambda: K8.resize_argmax_to(lo, (ZOO_IMG, ZOO_IMG)),
        lambda: K8.resize_argmax_plain(lo, (ZOO_IMG, ZOO_IMG)), None,
        pix * nc * 8.0, 4 * lo.numel() + 4 * pix, PEAK_BF16)
    del lo, lab, loss_map, parts, wmap, dcoef
    torch.cuda.empty_cache()
    return out


def phase_zoo(KERNELS):
    """The zoo slice on the card: K1 at N = M with head dim 32 and K7 / K8
    at ratio 32 against their plain versions (``zoo_checks``); models A
    and B served (``zoo_serve``) and trained (``zoo_train``); the
    MetaFormer and ConvNeXtV2 variants a step each (``zoo_variants``);
    models A and B through ``engine.loop.Trainer`` on the ADE20K and VOC
    JPEG trees (``trainer_run``); the slice's times (``zoo_times``).
    Returns the phase and its launches by path."""
    from segmentation_factory_tpu_torch.ops import lowres_loss as K7
    from segmentation_factory_tpu_torch.ops import resize_argmax as K8
    from segmentation_factory_tpu_torch.ops import sra_attention as K1

    res = {"phase": "zoo", "batch": ZOO_B, "image": ZOO_IMG, "dtype": "bfloat16",
           "models": {k: {"config": v["config"], **v["model"]} for k, v in ZOO_MODELS.items()}}
    t = time.perf_counter()
    res["checks"] = zoo_checks(K1, K7, K8)
    res["checks_seconds"] = time.perf_counter() - t
    paths, oks = [], []
    for key in ZOO_MODELS:
        res[f"serve_{key}"], counts = zoo_serve(KERNELS, key)
        paths.append(counts)
        res[f"train_{key}"], counts = zoo_train(KERNELS, key)
        paths.extend(counts)
        oks += [res[f"serve_{key}"]["ok"], res[f"train_{key}"]["ok"]]
    res["variants"] = zoo_variants(KERNELS)
    runs = []
    for key, spec in ZOO_MODELS.items():
        run, counts = trainer_run(KERNELS, spec["config"], spec["model"])
        runs.append(run)
        paths.append(counts)
    res["trainer"] = runs
    res["times"] = zoo_times(K1, K7, K8)
    res["ok"] = (all(v["ok"] for v in res["checks"].values()) and all(oks)
                 and all(v["ok"] for v in res["variants"].values())
                 and all(r["ok"] for r in runs))
    return res, paths


def profile_step(step, top=15):
    """Device time of one call of ``step`` by kernel (torch.profiler): where
    the time goes, and the device's idle share of the call's wall time. A
    diagnostic: a profiler that records no device time is reported, not
    failed."""
    from torch.profiler import ProfilerActivity, profile

    step()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel = torch.autograd.DeviceType.CUDA  # device-side events only, not the ops that launch them
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == kernel and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "top": [{"name": k[:90], "ms": ms, "calls": c} for k, ms, c in rows[:top]]}


def ptxas_by_function(log: str):
    """``-Xptxas -v``'s registers, stack frame and spills for each entry
    function of one source's build log, its name demangled where c++filt
    is there."""
    out, fn = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif fn and ("stack frame" in ln or "Used" in ln):
            out.append((fn, ln.split(":", 1)[-1].strip()))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(f for f, _ in out),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
    except OSError:
        names = []
    if len(names) != len(out):
        names = [f for f, _ in out]
    return [f"{n[:110]}: {v}" for n, (_, v) in zip(names, out)]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases", default="",
                   help="comma-separated phases to run (default: all); a partial run "
                        "prints no final ok line")
    p.add_argument("--out", default=None,
                   help="also write each phase's JSON line to OUT/<phase>.json")
    args = p.parse_args(argv)
    only = [x for x in args.phases.split(",") if x]
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from segmentation_factory_tpu_torch.ops import (
            KERNELS, _build, block, head_tail, lowres_loss, mixffn, resize_argmax, resize_sum,
            sra_attention)
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []
    t0 = time.perf_counter()
    try:
        logs = _build.build(verbose=True)
    except RuntimeError as exc:
        emit({"phase": "device", "gpu": smi, "ok": False, "error": str(exc)[-4000:]})
        return 1
    # registers and spills, and any wgmma serialized or arrive injected (C75..)
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "C75" in ln]
    device = {"phase": "device", "gpu": smi, "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
              "ptxas": ptxas, "ptxas_by_function": {
                  k: ptxas_by_function(logs.get(k, ""))
                  for k in ("resize_sum", "resize_sum_bwd", "head_tail", "lowres_loss",
                            "resize_argmax", "ms_deform_attn")},
              "ok": True}
    emit(device)
    if args.out:
        (Path(args.out) / "device.json").write_text(json.dumps(device))
    ops = (sra_attention, mixffn, block, resize_sum, lowres_loss, resize_argmax, head_tail)
    results = {}
    models = {}
    k9_totals = {}
    counts = []  # launches of every path, each read right after it ran
    for name, fn in [("check", lambda: phase_check(ops)),
                     ("serve", lambda: phase_serve(KERNELS)),
                     ("train", lambda: phase_train(KERNELS)),
                     ("serve_per_op", lambda: phase_serve(KERNELS, fused=False)),
                     ("train_per_op", lambda: phase_train(KERNELS, False, TRAIN_STEPS_PER_OP)),
                     ("m2f", lambda: phase_m2f(KERNELS)),
                     ("zoo", lambda: phase_zoo(KERNELS)),
                     ("files", phase_files),
                     ("trainer", lambda: phase_trainer(KERNELS)),
                     ("options", lambda: phase_options(KERNELS)),
                     ("entry", lambda: phase_entry(KERNELS)),
                     ("times", lambda: phase_times(
                         ops, models.get("serve"), models.get("serve_per_op")))]:
        if only and name not in only:
            continue
        t = time.perf_counter()
        try:
            out = fn()
            if name.startswith("serve"):
                out, models[name], served = out
                counts.append(served)
            elif name == "trainer":
                out, trained = out
                counts.extend(trained)
            elif name == "options":
                out, stepped = out
                counts.extend(stepped)
            elif name == "entry":
                out, served = out
                counts.extend(served)
            elif name == "m2f":
                out, paths, k9_totals = out
                counts.extend(paths)
            elif name == "zoo":
                out, paths = out
                counts.extend(paths)
            elif name.startswith("train"):
                counts.extend(out["launches_per_step"])
            elif name == "times":
                out, results["totals"] = out
        except Exception as exc:  # a phase that raises is a failed phase
            out = {"phase": name, "ok": False, "error": repr(exc),
                   "trace": traceback.format_exc()[-3000:]}
        out["seconds"] = time.perf_counter() - t
        out["gpu"] = smi
        results[name] = out
        emit(out)
        if args.out:
            (Path(args.out) / f"{name}.json").write_text(json.dumps(out))
        if not out["ok"]:
            failed.append(name)
        if name.startswith("serve") and name not in models:
            break
    checked = dict(results.get("check", {}), **results.get("m2f", {}).get("checks", {}),
                   **results.get("zoo", {}).get("checks", {}))
    check = {k.split(":")[0]: [] for k in checked if ":" in k}
    for k, v in checked.items():
        if ":" in k:
            check[k.split(":")[0]].append(v)
    totals = dict(results.get("totals", {}), **k9_totals)
    line = []
    for name in SOURCES:
        src, rep = SOURCES[name]
        t = totals.get(name, {})
        errs = [v["f32_max_abs_err"] for v in check.get(name, []) if "f32_max_abs_err" in v]
        checked = [v["ok"] for v in check.get(name, [])]
        line.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "status": "pass" if checked and all(checked) else "fail",
                     "launches": sum(c.get(name, 0) for c in counts),
                     "max_abs_err": max(errs) if errs else None,
                     "ms": t.get("ms"), "device_ms": t.get("device_ms"),
                     "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
                     "bound_by": ("operations" if t.get("ops_ms", 0) >= t.get("bytes_ms", 0)
                                  else "bytes"),
                     "library_ms": t.get("library_ms"),
                     "library_device_ms": t.get("library_device_ms")})
    emit({"kernels": line})
    if args.out:
        (Path(args.out) / "kernels.json").write_text(json.dumps({"kernels": line}))
    print(smi, flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if only:
        print(f"chip_smoke: ran only {only}", file=sys.stderr)
        return 3
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
