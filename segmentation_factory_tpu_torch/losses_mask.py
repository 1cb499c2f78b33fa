"""Mask-classification (Mask2Former) training loss for semantic segmentation.

Port of ``segmentation_factory_tpu/losses_mask.py``: ``semantic_targets``
(:25-48), ``_pair_costs`` (:51-70), ``greedy_match`` (:73-97),
``hungarian_match`` (:100-114) and ``mask2former_loss`` (:120-192). The
labels become one soft target mask a class at the prediction's resolution;
each prediction (the final one and the decoder's aux outputs) is matched to
the present classes by the pair costs, and supervised by class CE (no-object
weighted 0.1), sigmoid BCE and dice on the matched masks.

The matching is exact: ``scipy.optimize.linear_sum_assignment`` on the host
(the JAX package runs optax's assignment on the device, with the same
optimum), absent classes' columns at cost 1e6 and set to -1 after. A step
gathers every cost matrix it needs (final + aux, times the batch) into one
device-to-host copy and returns the assignments in one copy: this host
round trip in the middle of the step is what stands in the way of
capturing the training step as a CUDA graph. ``greedy_match`` is the
sequential greedy matcher, on the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from segmentation_factory_tpu_torch.losses import one_hot, sigmoid_bce

ABSENT_COST = 1e6  # an absent class's column (hungarian_match, :110)


def _linear_resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) float32 weights of ``jax.image.resize(..., "linear")``
    along one axis (``compute_weight_mat`` with its triangle kernel):
    half-pixel sample positions, the kernel widened by 1 / scale when
    shrinking (antialias), each output's weights normalised to sum 1, and
    samples outside the input zeroed."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, **f32)[:, None]).abs() / kernel_scale
    weights = (1.0 - x.abs()).clamp_min(0.0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).t()


def semantic_targets(labels: torch.Tensor, num_classes: int, pred_hw: Tuple[int, int],
                     ignore_index: int = 255):
    """labels (B, H, W) -> (target masks (B, C, h, w) float32 in [0, 1],
    present (B, C)). Soft masks at the prediction's resolution: the exact
    area mean where (h, w) divides (H, W), else the antialiased linear
    resize of ``jax.image.resize``."""
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    oh = one_hot(safe, num_classes) * valid[..., None]
    b, h, w, c = oh.shape
    ph, pw = int(pred_hw[0]), int(pred_hw[1])
    if (h, w) != (ph, pw):
        if h % ph == 0 and w % pw == 0:
            oh = oh.reshape(b, ph, h // ph, pw, w // pw, c).mean((2, 4))
        else:
            wy = _linear_resize_weights(h, ph, labels.device)
            wx = _linear_resize_weights(w, pw, labels.device)
            oh = torch.einsum("bhwc,ph,qw->bpqc", oh, wy, wx)
    present = oh.sum((1, 2)) > 0
    return oh.permute(0, 3, 1, 2), present


def _pair_costs(pred_logits, pred_masks, target_masks, class_cost: float = 2.0,
                bce_cost: float = 5.0, dice_cost: float = 5.0) -> torch.Tensor:
    """(B, Q, C) matching costs: -p(class), the BCE of the mask against
    each target (split into its positive and negative parts) and 1 - dice."""
    probs = torch.softmax(pred_logits.float(), dim=-1)
    c = target_masks.shape[1]
    pm = pred_masks.float()
    b, q = pm.shape[:2]
    n = pm.shape[2] * pm.shape[3]
    zero = torch.zeros((), device=pm.device)
    pos = torch.logaddexp(-pm, zero).reshape(b, q, n)  # -log sigmoid
    neg = torch.logaddexp(pm, zero).reshape(b, q, n)  # -log(1 - sigmoid)
    t = target_masks.reshape(target_masks.shape[0], c, n)
    cost_bce = (torch.einsum("bqn,bcn->bqc", pos, t)
                + torch.einsum("bqn,bcn->bqc", neg, 1.0 - t)) / n
    sig = torch.sigmoid(pm).reshape(b, q, n)
    inter = torch.einsum("bqn,bcn->bqc", sig, t)
    denom = sig.sum(-1)[:, :, None] + t.sum(-1)[:, None, :]
    cost_dice = 1.0 - (2.0 * inter + 1.0) / (denom + 1.0)
    return class_cost * -probs[..., :c] + bce_cost * cost_bce + dice_cost * cost_dice


def _greedy_one(cost: torch.Tensor, target_valid: torch.Tensor) -> torch.Tensor:
    q, c = cost.shape
    big = 1e9
    cost = torch.where(target_valid[None, :], cost, torch.full_like(cost, big))
    assign = torch.full((c,), -1, dtype=torch.long, device=cost.device)
    for _ in range(min(q, c)):
        flat = torch.argmin(cost.reshape(-1))
        qi, ci = flat // c, flat % c
        found = cost[qi, ci] < big
        assign = torch.where(found & (torch.arange(c, device=cost.device) == ci), qi, assign)
        cost = torch.where(found & ((torch.arange(q, device=cost.device) == qi)[:, None]
                                    | (torch.arange(c, device=cost.device) == ci)[None, :]),
                           torch.full_like(cost, big), cost)
    return torch.where(target_valid, assign, torch.full_like(assign, -1))


def greedy_match(cost: torch.Tensor, target_valid: torch.Tensor) -> torch.Tensor:
    """Sequential greedy assignment of each cost matrix in cost (..., Q, C)
    with target_valid (..., C): per target the query index, -1 for an
    absent target, int64; each query used at most once. On the cost's
    device, without host copies."""
    c = cost.shape[-1]
    flat = [_greedy_one(m, v) for m, v in zip(cost.reshape(-1, *cost.shape[-2:]),
                                              target_valid.reshape(-1, c))]
    return torch.stack(flat).reshape(target_valid.shape)


def hungarian_match(cost: torch.Tensor, target_valid: torch.Tensor) -> torch.Tensor:
    """Exact linear assignment of each cost matrix in cost (..., Q, C) with
    target_valid (..., C): ``greedy_match``'s contract. The masked costs go
    to the host in one copy, ``linear_sum_assignment`` runs on each matrix
    there, and the assignments come back in one copy."""
    from scipy.optimize import linear_sum_assignment

    masked = torch.where(target_valid[..., None, :], cost.detach().float(),
                         torch.full_like(cost, ABSENT_COST, dtype=torch.float32))
    host = masked.cpu().numpy()
    q, c = host.shape[-2:]
    flat = host.reshape(-1, q, c)
    out = np.full((flat.shape[0], c), -1, dtype=np.int64)
    for i, mat in enumerate(flat):
        rows, cols = linear_sum_assignment(mat)
        out[i, cols] = rows
    assign = torch.from_numpy(out.reshape(host.shape[:-2] + (c,))).to(cost.device)
    return torch.where(target_valid, assign, torch.full_like(assign, -1))


MATCHERS = {"hungarian": hungarian_match, "greedy": greedy_match}


def _single_loss(pred_logits, pred_masks, tm, present, assign, num_classes: int,
                 class_weight: float, bce_weight: float, dice_weight: float,
                 no_object_weight: float) -> torch.Tensor:
    """The loss of one prediction under its assignment (B, C)."""
    b, qn = pred_logits.shape[:2]
    # matched queries -> their class, the others no-object; unmatched
    # targets (-1) are routed past the end and dropped
    qidx = torch.where(assign >= 0, assign, torch.full_like(assign, qn))
    cls_ids = torch.arange(num_classes, device=assign.device).expand(b, num_classes)
    tgt = torch.full((b, qn + 1), num_classes, dtype=torch.long, device=assign.device)
    tgt = tgt.scatter(1, qidx, cls_ids)[:, :qn]
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    ce = -logp.gather(-1, tgt[..., None])[..., 0]
    w = torch.where(tgt == num_classes, torch.full_like(ce, no_object_weight),
                    torch.ones_like(ce))
    cls_loss = (ce * w).sum() / w.sum()
    # masks: only matched pairs (a present target left unmatched must not
    # supervise query 0's mask through the clamp below)
    present = present & (assign >= 0)
    h, w_ = pred_masks.shape[2:4]
    pm = pred_masks.float().gather(
        1, assign.clamp_min(0)[:, :, None, None].expand(b, assign.shape[1], h, w_))
    n_present = present.sum().float().clamp_min(1.0)
    bce_loss = (sigmoid_bce(pm, tm).mean((2, 3)) * present).sum() / n_present
    sig = torch.sigmoid(pm)
    inter = (sig * tm).sum((2, 3))
    denom = sig.sum((2, 3)) + tm.sum((2, 3))
    dice = 1.0 - (2.0 * inter + 1.0) / (denom + 1.0)
    dice_loss = (dice * present).sum() / n_present
    return class_weight * cls_loss + bce_weight * bce_loss + dice_weight * dice_loss


def mask2former_loss(outputs: Dict, labels: torch.Tensor, num_classes: int,
                     ignore_index: int = 255, class_weight: float = 2.0,
                     bce_weight: float = 5.0, dice_weight: float = 5.0,
                     no_object_weight: float = 0.1, aux_weight: float = 1.0,
                     matcher: str = "hungarian") -> torch.Tensor:
    """Total float32 loss over the final prediction plus ``aux_weight``
    times each aux output's. ``matcher``: 'hungarian' (exact, the
    reference recipe's) or 'greedy'. Every prediction's matching is
    computed first, in one call of the matcher."""
    match = MATCHERS[matcher]
    preds = [(outputs["pred_logits"], outputs["pred_masks"])] + [
        (a["pred_logits"], a["pred_masks"]) for a in outputs.get("aux_outputs", [])]
    targets = {}
    for _, pm in preds:
        hw = tuple(pm.shape[2:4])
        if hw not in targets:
            targets[hw] = semantic_targets(labels, num_classes, hw, ignore_index)
    with torch.no_grad():
        costs = torch.stack([_pair_costs(pl, pm, targets[tuple(pm.shape[2:4])][0],
                                         class_weight, bce_weight, dice_weight)
                             for pl, pm in preds])
        present = torch.stack([targets[tuple(pm.shape[2:4])][1] for _, pm in preds])
        assign = match(costs, present)
    total = None
    for i, (pl, pm) in enumerate(preds):
        tm, pres = targets[tuple(pm.shape[2:4])]
        loss = _single_loss(pl, pm, tm, pres, assign[i], num_classes, class_weight,
                            bce_weight, dice_weight, no_object_weight)
        total = loss if total is None else total + aux_weight * loss
    return total
