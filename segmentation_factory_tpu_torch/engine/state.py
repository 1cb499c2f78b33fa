"""Optimizer construction: AdamW behind adaptive gradient clipping.

Port of ``segmentation_factory_tpu/engine/state.py`` ``_clip_transform``,
``_wd_mask`` and ``create_optimizer`` (:37-58, :223-267) for the ``adamw``
entry that pinned config #5 uses, with optax's semantics (optax 0.2):

- ``adaptive_grad_clip(clip)``: each unit of a gradient whose norm is at
  least ``clip * max(||p_unit||, 1e-3)`` is scaled down to that norm. The
  units are optax's ``unitwise_norm`` axes carried into torch layouts: a
  Dense kernel (in, out) reduces over axis 0, i.e. axis 1 of the torch
  (out, in) weight; an HWIO conv kernel over (0, 1, 2), i.e. (1, 2, 3) of
  an OIHW weight; a tensor with at most one non-unit axis over all of it.
- ``adamw(schedule, b1, b2, eps, weight_decay, mask)``: bias-corrected
  moments, eps outside the square root, decoupled decay added before the
  learning rate (p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)), the
  schedule read at the update count before the update.
- the no-decay mask: decay only tensors with more than one axis (no
  biases, no norm scales — all of which are 1-D here).

Parameters and moments are float32 and updated in place. The optimizer
moves the parameters into one flat buffer (each parameter becomes a view of
it, starting 16-byte aligned as the kernels' vector loads need), so an
update is a few dozen whole-buffer launches instead of dozens per
parameter; AGC's units are contiguous runs of that buffer, summed with
``segment_reduce``. Create it after the model is on its device. An update
takes a 0-d bool ``apply`` tensor: where it is false nothing changes (the
train step's non-finite skip), without a host synchronisation.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import torch

ALIGN = 4  # elements: every parameter's slot in the flat buffer starts 16-byte aligned


def unit_size(x: torch.Tensor) -> int:
    """Elements per unit of optax's ``unitwise_norm`` carried into torch
    layouts; a unit is a contiguous run of the row-major tensor."""
    if sum(s > 1 for s in x.shape) <= 1:
        return x.numel()  # scalars and vectors: the whole tensor
    if x.dim() in (2, 4):  # Linear (out, in) / conv OIHW: one unit per output
        return x.numel() // x.shape[0]
    raise ValueError(f"no unit-wise norm for shape {tuple(x.shape)}")


class AdamW:
    """optax.chain(adaptive_grad_clip(clip_grad), adamw(...)) over a list
    of named parameters. State: ``count`` (a 0-d int32 tensor of applied
    updates), ``mu`` and ``nu`` (flat float32, like ``flat``)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 schedule: Callable, weight_decay: float = 1e-4,
                 clip_grad: Optional[float] = 0.02, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.decay = [p.dim() > 1 for p in self.params]
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.b1, self.b2, self.eps = b1, b2, eps
        dev = self.params[0].device
        # zero padding after each parameter; it stays zero (zero gradient,
        # no decay) and forms its own AGC units
        self.pads = [torch.zeros((-p.numel()) % ALIGN, device=dev) for p in self.params]
        with torch.no_grad():
            self.flat = torch.cat([t for p, pad in zip(self.params, self.pads)
                                   for t in (p.detach().float().reshape(-1), pad)])
            at = 0
            for p, pad in zip(self.params, self.pads):
                p.data = self.flat[at:at + p.numel()].view_as(p)
                at += p.numel() + pad.numel()
        units = []
        for p, pad in zip(self.params, self.pads):
            units += [unit_size(p)] * (p.numel() // unit_size(p)) + [pad.numel()] * (pad.numel() > 0)
        self.units = torch.tensor(units, device=dev)
        self.decay_mask = torch.cat([t for p, d, pad in zip(self.params, self.decay, self.pads)
                                     for t in (torch.full((p.numel(),), float(d), device=dev),
                                               pad)])
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)

    def state_dict(self) -> dict:
        """The optimizer's state: the moments, the update count and the
        parameter names they belong to (the parameters themselves are the
        model's)."""
        return {"names": list(self.names), "mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s moments and count; raises unless it was
        taken from an optimizer over the same named parameters."""
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state is for other parameters")
        dev = self.flat.device
        with torch.no_grad():
            for key in ("mu", "nu"):
                src = torch.as_tensor(state[key], device=dev, dtype=torch.float32)
                if src.shape != self.flat.shape:
                    raise ValueError(f"{key}: shape {tuple(src.shape)} != {tuple(self.flat.shape)}")
                setattr(self, key, src.clone())
            self.count = torch.as_tensor(state["count"], device=dev, dtype=torch.int32).clone()

    def _unit_norm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.segment_reduce(x * x, "sum", lengths=self.units, unsafe=True))

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], apply: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update from ``grads`` (aligned with the parameters); returns
        the learning rate it used. Where ``apply`` is false the parameters
        and the state keep their values."""
        lr = self.schedule(self.count).to(self.count.device)
        t = (self.count + 1).float()
        g = torch.cat([t for x, pad in zip(grads, self.pads)
                       for t in (x.reshape(-1).float(), pad)])
        p = self.flat
        if self.clip_grad:
            g_norm = self._unit_norm(g)
            max_norm = self.clip_grad * self._unit_norm(p).clamp_min(1e-3)
            scale = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                                max_norm / g_norm.clamp_min(1e-6))
            g = g * torch.repeat_interleave(scale, self.units, output_size=g.numel())
        mu = (1.0 - self.b1) * g + self.b1 * self.mu
        nu = (1.0 - self.b2) * (g * g) + self.b2 * self.nu
        u = (mu / (1.0 - self.b1 ** t)) / (torch.sqrt(nu / (1.0 - self.b2 ** t)) + self.eps)
        if self.weight_decay:
            u = u + self.weight_decay * p * self.decay_mask
        new = p + (-lr) * u
        if apply is None:
            p.copy_(new)
            self.mu, self.nu = mu, nu
            self.count = self.count + 1
        else:
            p.copy_(torch.where(apply, new, p))
            self.mu = torch.where(apply, mu, self.mu)
            self.nu = torch.where(apply, nu, self.nu)
            self.count = self.count + apply.int()
        return lr


def create_optimizer(opt: str, schedule: Callable, weight_decay: float = 1e-4,
                     clip_grad: Optional[float] = 0.02, clip_mode: str = "agc",
                     params: Optional[Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                     eps: Optional[float] = None,
                     betas: Optional[Tuple[float, float]] = None) -> AdamW:
    """The optimizer of ``create_optimizer`` (state.py:223-267) for
    ``opt="adamw"`` with ``clip_mode="agc"`` (or no clip); ``params`` are
    the model's ``named_parameters()``; ``eps`` and ``betas`` default to
    optax's 1e-8 and (0.9, 0.999). Other names are not ported yet."""
    if opt.lower() != "adamw":
        raise KeyError(f"optimizer {opt!r} is not ported; available: ['adamw']")
    if clip_grad and clip_mode.lower() != "agc":
        raise KeyError(f"clip_mode {clip_mode!r} is not ported; available: ['agc']")
    if params is None:
        raise ValueError("pass the model's named_parameters() as `params`")
    b1, b2 = betas or (0.9, 0.999)
    return AdamW(params, schedule, weight_decay=weight_decay, clip_grad=clip_grad, b1=b1, b2=b2,
                 eps=1e-8 if eps is None else eps)
