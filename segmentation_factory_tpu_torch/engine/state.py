"""Optimizers, gradient clipping, gradient accumulation and BatchNorm
recalibration.

Port of ``segmentation_factory_tpu/engine/state.py`` (``_clip_transform``,
``_wd_mask``, ``recalibrate_bn``, ``_build_core``, ``OPTIMIZERS``,
``create_optimizer``: :37-267) and of ``engine/optimizers.py`` (AdamP,
SGDP), with optax 0.2's formulas, which differ from ``torch.optim``'s in
places. The 23 names of the timm ``--opt`` surface fall in three groups:

- decoupled decay under the no-decay mask (``p -= lr * (u + wd * p)``):
  adamw, nadamw, adamaxw, lamb, lion, adamp, sgdp;
- coupled L2 under the same mask (``g += wd * p`` before the statistics):
  adam, nadam, radam, adamax, adabelief, sgd / nesterov (Nesterov),
  momentum (heavy ball), adadelta, adagrad, rmsprop (eps outside the
  sqrt), rmsproptf (eps inside, ones init), yogi;
- their own decay on every tensor: novograd (timm's betas 0.95 / 0.98
  unless given), lars, adafactor (``weight_decay_rate``).

The no-decay mask decays only tensors with more than one axis (no biases,
no norm scales). Each default eps is optax's for that name; the schedule
is read at the update count before the update.

Clip modes, before the rule: ``agc`` (optax ``adaptive_grad_clip``: each
unit of a gradient whose norm is at least ``clip * max(||p_unit||, 1e-3)``
is scaled down to it; the units are optax's ``unitwise_norm`` axes carried
into torch layouts: one per output of a Linear or conv), ``norm``
(``clip_by_global_norm``) and ``value`` (``clip``).

Parameters and state are float32. The optimizer moves the parameters into
one flat buffer (each parameter becomes a view of it, starting 16-byte
aligned as the kernels' vector loads need; the zero padding between them
stays zero and changes no norm), so an update is a few dozen whole-buffer
launches. Statistics of a whole tensor (lamb's and lars's trust ratios,
novograd's second moment) are ``segment_reduce`` sums over each
parameter's run of the buffer. AdamP's and SGDP's channel view and
adafactor's factored moments are taken in the JAX package's layout of the
tensor (a Linear's (out, in) weight is a Dense (in, out) kernel there, a
conv's OIHW an HWIO kernel, a 1x1 conv classifier a Dense (E, NC)), so the
rows and the factored axes are the JAX package's.

``grad_accum = k`` is ``optax.MultiSteps``: a running mean of k micro-step
gradients, and the clip and the rule once on the mean at the k-th; the
parameters do not move in between. ``trainable`` freezes the others after
the whole chain (JAX ``masked(set_to_zero())``): their statistics run on,
their values stay bit for bit. A ``PlateauSchedule`` runs the rule at lr 1
and scales the update by the plateau rate (``set_plateau_lr``) times the
warm-up fraction, as the JAX optimizer's injected stage does.

An update takes a 0-d bool ``apply`` tensor: where it is false nothing
changes (the train step's non-finite skip, the accumulator included),
without a host synchronisation.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from segmentation_factory_tpu_torch.checkpoint import is_classifier
from segmentation_factory_tpu_torch.schedule import PlateauSchedule

ALIGN = 4  # elements: every parameter's slot in the flat buffer starts 16-byte aligned

OPTIMIZERS = (
    "adamw", "nadamw", "adamaxw", "lamb", "lion", "adamp", "sgdp",
    "adam", "nadam", "radam", "adamax", "adabelief",
    "sgd", "momentum", "nesterov",
    "adadelta", "adagrad", "rmsprop", "rmsproptf",
    "novograd", "lars", "yogi", "adafactor",
)
DECOUPLED = ("adamw", "nadamw", "adamaxw", "lamb", "lion", "adamp", "sgdp")
OWN_DECAY = ("novograd", "lars", "adafactor")
CLIP_MODES = ("agc", "norm", "value")
# optax's default eps of each name that takes --opt-eps (others: 1e-8)
DEFAULT_EPS = {"lamb": 1e-6, "adabelief": 1e-16, "adadelta": 1e-6, "rmsproptf": 1e-10,
               "yogi": 1e-3}
# names whose eps is optax's own whatever --opt-eps says (state.py:93-180)
FIXED_EPS = {"novograd": 1e-6, "sgdp": 1e-8, "lars": 0.0, "adafactor": 1e-30, "adagrad": 1e-7}
# the flat per-element state of each rule, and its initial value
SLOTS = {
    "adamw": {"mu": 0.0, "nu": 0.0}, "nadamw": {"mu": 0.0, "nu": 0.0},
    "adamaxw": {"mu": 0.0, "nu": 0.0}, "lamb": {"mu": 0.0, "nu": 0.0},
    "lion": {"mu": 0.0}, "adamp": {"mu": 0.0, "nu": 0.0}, "sgdp": {"buf": 0.0},
    "adam": {"mu": 0.0, "nu": 0.0}, "nadam": {"mu": 0.0, "nu": 0.0},
    "radam": {"mu": 0.0, "nu": 0.0}, "adamax": {"mu": 0.0, "nu": 0.0},
    "adabelief": {"mu": 0.0, "nu": 0.0}, "sgd": {"trace": 0.0}, "nesterov": {"trace": 0.0},
    "momentum": {"trace": 0.0}, "adadelta": {"e_g": 0.0, "e_x": 0.0},
    "adagrad": {"sum_of_squares": 0.1}, "rmsprop": {"nu": 0.0, "trace": 0.0},
    "rmsproptf": {"nu": 1.0, "trace": 0.0}, "novograd": {"mu": 0.0}, "lars": {"trace": 0.0},
    "yogi": {"mu": 1e-6, "nu": 1e-6}, "adafactor": {},
}


def unit_size(x: torch.Tensor) -> int:
    """Elements per unit of optax's ``unitwise_norm`` carried into torch
    layouts; a unit is a contiguous run of the row-major tensor."""
    if sum(s > 1 for s in x.shape) <= 1:
        return x.numel()  # scalars and vectors: the whole tensor
    if x.dim() in (2, 4):  # Linear (out, in) / conv OIHW: one unit per output
        return x.numel() // x.shape[0]
    raise ValueError(f"no unit-wise norm for shape {tuple(x.shape)}")


def jax_layout(name: str, shape: Sequence[int]) -> str:
    """How the JAX package holds the parameter ``name``: ``linear`` (a
    Linear's (out, in) weight is a Dense (in, out) kernel), ``conv`` (OIHW
    -> HWIO), ``classifier`` (the 1x1 conv ``linear_pred`` / ``conv_seg``
    is a Dense (E, NC)) or ``same`` (vectors and the raw parameters, such
    as Mask2Former's embeddings)."""
    if not (name == "weight" or name.endswith(".weight")):
        return "same"
    if len(shape) == 2:
        return "linear"
    if len(shape) == 4:
        if is_classifier(name) and tuple(shape[2:]) == (1, 1):
            return "classifier"
        return "conv"
    return "same"


def to_jax(x: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "linear":
        return x.t()
    if layout == "conv":
        return x.permute(2, 3, 1, 0)
    if layout == "classifier":
        return x.reshape(x.shape[0], -1).t()
    return x


def from_jax(y: torch.Tensor, layout: str, shape) -> torch.Tensor:
    if layout == "linear":
        return y.t()
    if layout == "conv":
        return y.permute(3, 2, 0, 1)
    if layout == "classifier":
        return y.t().reshape(shape)
    return y


def factored_dims(shape: Sequence[int], min_dim: int = 128) -> Optional[Tuple[int, int]]:
    """optax ``_factored_dims`` of a JAX-layout shape: the axes of the second
    largest and the largest size, when the former is at least ``min_dim``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def _project(p, g, perturb, delta: float, wd_ratio: float, eps: float):
    """AdamP's tangent projection (optimizers.py:27-68) of a JAX-layout
    tensor: the channel view (rows along axis 0) where its largest
    |cos(g, p)| is below delta / sqrt(row length), else the layer view
    (one row) under the same test, else ``perturb`` as it is. Returns the
    projection and the decay's ratio (``wd_ratio`` where one fired)."""
    if p.dim() < 2:
        return perturb, torch.ones((), device=p.device)

    def stats(x2, y2):
        dot = (x2 * y2).sum(1)
        return (dot.abs() / (x2.norm(dim=1) * y2.norm(dim=1) + eps)).max()

    def projected(pv):
        pn = pv / (pv.norm(dim=1, keepdim=True) + eps)
        t = perturb.reshape(pv.shape)
        return (t - pn * (pn * t).sum(1, keepdim=True)).reshape(p.shape)

    pc, gc = p.reshape(p.shape[0], -1), g.reshape(p.shape[0], -1)
    pl, gl = p.reshape(1, -1), g.reshape(1, -1)
    cond_c = stats(gc, pc) < delta / pc.shape[1] ** 0.5
    cond_l = stats(gl, pl) < delta / pl.shape[1] ** 0.5
    out = torch.where(cond_c, projected(pc), torch.where(cond_l, projected(pl), perturb))
    ratio = torch.where(cond_c | cond_l, torch.tensor(wd_ratio, device=p.device),
                        torch.ones((), device=p.device))
    return out, ratio


class FlatOptimizer:
    """optax.chain(clip, rule) over a list of named parameters, optionally
    under ``MultiSteps(k)`` and a freeze mask. State: ``count`` (a 0-d int32
    tensor of applied updates), the rule's flat float32 slots (``SLOTS``;
    attributes, e.g. ``mu`` and ``nu``), novograd's per-tensor ``seg_nu``,
    adafactor's per-tensor ``v_row`` / ``v_col`` / ``v`` (JAX layout), and
    under accumulation ``acc`` and ``mini_step``."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], rule: str,
                 schedule: Callable, weight_decay: float = 1e-4, momentum: float = 0.9,
                 clip_grad: Optional[float] = 0.02, clip_mode: str = "agc",
                 eps: Optional[float] = None, betas: Optional[Tuple[float, float]] = None,
                 grad_accum: int = 1, trainable: Optional[Sequence[bool]] = None):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.rule = rule
        self.decay = [p.dim() > 1 for p in self.params]
        self.layouts = [jax_layout(n, p.shape) for n, p in named]
        self.schedule = schedule
        self.plateau = isinstance(schedule, PlateauSchedule)
        self.weight_decay, self.momentum = weight_decay, momentum
        self.clip_grad, self.clip_mode = clip_grad, clip_mode.lower()
        b1, b2 = betas or ((0.95, 0.98) if rule == "novograd" else
                           (0.9, 0.99) if rule == "lion" else (0.9, 0.999))
        self.b1, self.b2 = b1, b2
        self.eps = FIXED_EPS.get(rule, DEFAULT_EPS.get(rule, 1e-8) if eps is None else eps)
        self.k = max(int(grad_accum), 1)
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
        # one segment per parameter, its padding included (zeros: no norm changes)
        self.segments = torch.tensor([p.numel() + pad.numel()
                                      for p, pad in zip(self.params, self.pads)], device=dev)

        def per_element(values):
            return torch.cat([t for p, v, pad in zip(self.params, values, self.pads)
                              for t in (torch.full((p.numel(),), float(v), device=dev), pad)])

        self.decay_mask = per_element(self.decay)
        self.trainable = None if trainable is None else [bool(m) for m in trainable]
        self.train_mask = None if trainable is None else per_element(trainable).bool()
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        for key, init in SLOTS[rule].items():  # zero in the padding, so it stays zero
            setattr(self, key, per_element([init] * len(self.params)))
        if rule == "novograd":
            self.seg_nu = torch.zeros(len(self.params), device=dev)
        if rule == "adafactor":
            self.v_row, self.v_col, self.v = [], [], []
            for p, layout in zip(self.params, self.layouts):
                shape = tuple(to_jax(p, layout).shape)
                dims = factored_dims(shape)
                if dims is None:
                    self.v_row.append(torch.zeros(1, device=dev))
                    self.v_col.append(torch.zeros(1, device=dev))
                    self.v.append(torch.zeros(shape, device=dev))
                else:
                    d1, d0 = dims
                    self.v_row.append(torch.zeros(np.delete(shape, d0).tolist(), device=dev))
                    self.v_col.append(torch.zeros(np.delete(shape, d1).tolist(), device=dev))
                    self.v.append(torch.zeros(1, device=dev))
        if self.k > 1:
            self.acc = torch.zeros_like(self.flat)
            self.mini_step = torch.zeros((), dtype=torch.int32, device=dev)
        self.plateau_lr = torch.tensor(float(schedule.lr) if self.plateau else 0.0, device=dev)

    # ---------------------------------------------------------------- state

    def _state_keys(self) -> List[str]:
        keys = ["count", *SLOTS[self.rule]]
        if self.rule == "novograd":
            keys.append("seg_nu")
        if self.k > 1:
            keys += ["acc", "mini_step"]
        if self.plateau:
            keys.append("plateau_lr")
        return keys

    def state_dict(self) -> dict:
        """The optimizer's state (the parameters themselves are the
        model's), with the rule's name and the parameter names it is for."""
        state = {"names": list(self.names), "rule": self.rule,
                 **{k: getattr(self, k) for k in self._state_keys()}}
        if self.rule == "adafactor":
            state.update(v_row=list(self.v_row), v_col=list(self.v_col), v=list(self.v))
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s state; raises unless it was taken from
        an optimizer of the same rule over the same named parameters."""
        if list(state["names"]) != self.names:
            raise ValueError("optimizer state is for other parameters")
        if state.get("rule", "adamw") != self.rule:
            raise ValueError(f"optimizer state is of {state.get('rule')!r}, not {self.rule!r}")
        dev = self.flat.device

        def restored(src, like):
            src = torch.as_tensor(src, device=dev).to(like.dtype)
            if src.shape != like.shape:
                raise ValueError(f"shape {tuple(src.shape)} != {tuple(like.shape)}")
            return src.clone()

        with torch.no_grad():
            for key in self._state_keys():
                setattr(self, key, restored(state[key], getattr(self, key)))
            if self.rule == "adafactor":
                for key in ("v_row", "v_col", "v"):
                    setattr(self, key, [restored(s, t) for s, t in zip(state[key],
                                                                       getattr(self, key))])

    def set_plateau_lr(self, lr: float) -> None:
        """The plateau rate of the following updates (JAX ``set_plateau_lr``)."""
        self.plateau_lr.fill_(float(lr))

    # ------------------------------------------------------------- helpers

    def _seg_sum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(x, "sum", lengths=self.segments, unsafe=True)

    def _per_elem(self, v: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(v, self.segments, output_size=self.flat.numel())

    def _seg_norm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self._seg_sum(x * x))

    def _unit_norm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.segment_reduce(x * x, "sum", lengths=self.units, unsafe=True))

    def _views(self, x: torch.Tensor) -> List[torch.Tensor]:
        """JAX-layout views of each parameter's run of a flat tensor."""
        out, at = [], 0
        for p, pad, layout in zip(self.params, self.pads, self.layouts):
            out.append(to_jax(x[at:at + p.numel()].view(p.shape), layout))
            at += p.numel() + pad.numel()
        return out

    def _flatten(self, xs: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat([t for x, p, pad, layout in zip(xs, self.params, self.pads, self.layouts)
                          for t in (from_jax(x, layout, p.shape).reshape(-1), pad)])

    def _clip(self, g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        c = self.clip_grad
        if self.clip_mode == "agc":
            g_norm = self._unit_norm(g)
            max_norm = c * self._unit_norm(p).clamp_min(1e-3)
            scale = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                                max_norm / g_norm.clamp_min(1e-6))
            return g * torch.repeat_interleave(scale, self.units, output_size=g.numel())
        if self.clip_mode == "norm":
            g_norm = torch.sqrt((g * g).sum())
            return torch.where(g_norm < c, g, (g / g_norm) * c)
        return g.clamp(-c, c)

    # --------------------------------------------------------------- rules

    def _rule(self, g, p, lr, t) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The update ``delta`` (p_new = p + delta) of ``self.rule`` from the
        clipped gradient, and its new state; ``t`` is the float32 update
        count after this update (optax's ``count_inc``)."""
        r, b1, b2, eps, wd = self.rule, self.b1, self.b2, self.eps, self.weight_decay
        dm = self.decay_mask
        if r not in DECOUPLED and r not in OWN_DECAY and wd:
            g = g + wd * p * dm  # coupled L2 (optax add_decayed_weights, masked)
        new = {}
        if r in ("adamw", "nadamw", "lamb", "adam", "nadam", "radam", "adamp"):
            mu = (1.0 - b1) * g + b1 * self.mu
            nu = (1.0 - b2) * (g * g) + b2 * self.nu
            new.update(mu=mu, nu=nu)
            bc2 = 1.0 - b2 ** t
            if r == "adamp":  # optimizers.py:108-131
                perturb = mu / (1.0 - b1 ** t) / (torch.sqrt(nu / bc2) + eps)
                return self._projected(p, g, perturb, lr, wd, 1.0), new
            if r in ("nadamw", "nadam"):
                m_hat = b1 * (mu / (1.0 - b1 ** (t + 1.0))) + (1.0 - b1) * (g / (1.0 - b1 ** t))
            else:
                m_hat = mu / (1.0 - b1 ** t)
            u = m_hat / (torch.sqrt(nu / bc2) + eps)
            if r == "radam":
                ro_inf = 2.0 / (1.0 - b2) - 1.0
                b2t = b2 ** t
                ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
                rect = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                u = torch.where(ro >= 5.0, rect * m_hat / (torch.sqrt(nu / bc2) + eps), m_hat)
        elif r in ("adamaxw", "adamax"):
            mu = (1.0 - b1) * g + b1 * self.mu
            nu = torch.maximum(g.abs() + eps, b2 * self.nu)
            new.update(mu=mu, nu=nu)
            u = mu / (1.0 - b1 ** t) / nu
        elif r == "lion":
            u = torch.sign((1.0 - b1) * g + b1 * self.mu)
            new["mu"] = (1.0 - b2) * g + b2 * self.mu
        elif r == "adabelief":
            mu = (1.0 - b1) * g + b1 * self.mu
            nu = (1.0 - b2) * ((g - mu) ** 2) + b2 * self.nu + 1e-16  # eps_root
            new.update(mu=mu, nu=nu)
            u = (mu / (1.0 - b1 ** t)) / (torch.sqrt(nu / (1.0 - b2 ** t)) + eps)
        elif r == "yogi":
            mu = (1.0 - b1) * g + b1 * self.mu
            g2 = g * g
            nu = self.nu - (1.0 - b2) * torch.sign(self.nu - g2) * g2
            new.update(mu=mu, nu=nu)
            u = (mu / (1.0 - b1 ** t)) / (torch.sqrt(nu / (1.0 - b2 ** t)) + eps)
        elif r in ("sgd", "nesterov", "momentum"):
            tr = g + self.momentum * self.trace
            new["trace"] = tr
            u = g + self.momentum * tr if r != "momentum" else tr
        elif r == "sgdp":  # optimizers.py:154-186
            buf = self.momentum * self.buf + g
            new["buf"] = buf
            return self._projected(p, g, g + self.momentum * buf, lr, wd,
                                   1.0 - self.momentum), new
        elif r == "adadelta":
            e_g = 0.1 * (g * g) + 0.9 * self.e_g
            u = torch.sqrt(self.e_x + eps) / torch.sqrt(e_g + eps) * g
            new.update(e_g=e_g, e_x=0.1 * (u * u) + 0.9 * self.e_x)
        elif r == "adagrad":
            s = g * g + self.sum_of_squares
            new["sum_of_squares"] = s
            u = torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s)) * g
        elif r in ("rmsprop", "rmsproptf"):
            nu = 0.1 * (g * g) + 0.9 * self.nu
            new["nu"] = nu
            scaling = torch.rsqrt(nu + eps) if r == "rmsproptf" else 1.0 / (torch.sqrt(nu) + eps)
            delta = (scaling * g) * -lr
            if self.momentum:  # optax.rmsprop's trace after the learning rate
                delta = delta + self.momentum * self.trace
                new["trace"] = delta
            return delta, new
        elif r == "novograd":
            first = self.count == 0
            gn2 = torch.sqrt(self._seg_sum(g * g)) ** 2
            seg_nu = torch.where(first, gn2, (1.0 - b2) * gn2 + b2 * self.seg_nu)
            add = g / (torch.sqrt(self._per_elem(seg_nu)) + eps) + wd * p
            u = torch.where(first, add, b1 * self.mu + add)
            new.update(mu=u, seg_nu=seg_nu)
        elif r == "lars":
            u = g + wd * p
            pn, un = self._per_elem(self._seg_norm(p)), self._per_elem(self._seg_norm(u))
            ratio = 0.001 * pn / (un + eps)
            u = u * torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(ratio), ratio)
            delta = u * -lr + self.momentum * self.trace
            new["trace"] = delta
            return delta, new
        elif r == "adafactor":
            return self._adafactor(g, p, lr, t, new), new
        else:
            raise KeyError(r)
        if r in DECOUPLED and wd:
            u = u + wd * p * dm
        if r == "lamb":
            pn, un = self._per_elem(self._seg_norm(p)), self._per_elem(self._seg_norm(u))
            u = u * torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(pn), pn / un)
        return u * -lr, new

    def _projected(self, p, g, perturb, lr, wd, decay_div):
        """AdamP / SGDP's update of each tensor from its projected
        ``perturb``: -lr * perturb - lr * wd * ratio * mask / decay_div * p."""
        out = []
        for pv, gv, tv, d in zip(self._views(p), self._views(g), self._views(perturb),
                                 self.decay):
            tv, ratio = _project(pv, gv, tv, 0.1, 0.1, self.eps)
            upd = -lr * tv
            if wd:
                upd = upd - (lr * wd * ratio * float(d) / decay_div) * pv
            out.append(upd)
        return self._flatten(out)

    def _adafactor(self, g, p, lr, t, new):
        """optax.adafactor(lr, weight_decay_rate=wd or None) of each tensor:
        factored (or full) second moments with decay 1 - t^-0.8, block-RMS
        clip at 1, the learning rate, the parameter's RMS (at least 1e-3),
        then the decay, added unscaled."""
        rate = 1.0 - t ** -0.8
        out, v_row, v_col, v = [], [], [], []
        for i, (pv, gv) in enumerate(zip(self._views(p), self._views(g))):
            g2 = gv * gv + 1e-30
            dims = factored_dims(tuple(gv.shape))
            if dims is not None:
                d1, d0 = dims
                vr = rate * self.v_row[i] + (1.0 - rate) * g2.mean(d0)
                vc = rate * self.v_col[i] + (1.0 - rate) * g2.mean(d1)
                rmean = vr.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
                u = gv * ((vr / rmean) ** -0.5).unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
                v_row.append(vr), v_col.append(vc), v.append(self.v[i])
            else:
                vv = rate * self.v[i] + (1.0 - rate) * g2
                u = gv * vv ** -0.5
                v_row.append(self.v_row[i]), v_col.append(self.v_col[i]), v.append(vv)
            u = u / torch.clamp_min(torch.sqrt((u * u).mean()), 1.0)
            u = u * lr
            rms = torch.sqrt((pv * pv).mean())
            u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
            if self.weight_decay:
                u = u + self.weight_decay * pv
            out.append(u * -1.0)
        new.update(v_row=v_row, v_col=v_col, v=v)
        return self._flatten(out)

    # ---------------------------------------------------------------- step

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], apply: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One micro-step from ``grads`` (aligned with the parameters): an
        update, or under accumulation one more gradient into the mean and an
        update at every k-th. Returns the learning rate of the update (the
        next one under accumulation). Where ``apply`` is false the
        parameters and the state keep their values."""
        dev = self.count.device
        g = torch.cat([t for x, pad in zip(grads, self.pads) for t in (x.reshape(-1).float(), pad)])
        emit = None
        if self.k > 1:
            acc = self.acc + (g - self.acc) / (self.mini_step + 1)
            emit = self.mini_step == self.k - 1
            g = acc
        p = self.flat
        if self.plateau:
            lr = self.plateau_lr * self.schedule.warmup_fraction(self.count).to(dev)
            core_lr = 1.0
        else:
            lr = core_lr = self.schedule(self.count).to(dev)
        t = (self.count + 1).float()
        if self.clip_grad:
            g = self._clip(g, p)
        delta, new = self._rule(g, p, core_lr, t)
        if self.plateau:
            delta = delta * self.plateau_lr * self.schedule.warmup_fraction(self.count).to(dev)
        upd = p + delta
        if self.train_mask is not None:
            upd = torch.where(self.train_mask, upd, p)
        go = apply if emit is None else (emit if apply is None else apply & emit)
        if go is None:
            p.copy_(upd)
            for k, v in new.items():
                setattr(self, k, v)
            self.count = self.count + 1
        else:
            p.copy_(torch.where(go, upd, p))
            for k, v in new.items():
                old = getattr(self, k)
                if isinstance(v, list):
                    setattr(self, k, [torch.where(go, a, b) for a, b in zip(v, old)])
                else:
                    setattr(self, k, torch.where(go, v, old))
            self.count = self.count + go.int()
        if self.k > 1:
            ok = torch.ones((), dtype=torch.bool, device=dev) if apply is None else apply
            self.acc = torch.where(ok, torch.where(emit, torch.zeros_like(acc), acc), self.acc)
            self.mini_step = torch.where(ok, (self.mini_step + 1) % self.k, self.mini_step)
        return lr


def create_optimizer(opt: str, schedule: Callable, weight_decay: float = 1e-4,
                     momentum: float = 0.9, clip_grad: Optional[float] = 0.02,
                     clip_mode: str = "agc",
                     params: Optional[Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                     eps: Optional[float] = None, betas: Optional[Tuple[float, float]] = None,
                     grad_accum: int = 1,
                     trainable: Optional[Sequence[bool]] = None) -> FlatOptimizer:
    """The optimizer of ``create_optimizer`` (state.py:223-267) by its timm
    ``--opt`` name (``OPTIMIZERS``), behind the ``agc`` / ``norm`` /
    ``value`` clip (or none); ``params`` are the model's
    ``named_parameters()``; ``schedule`` a step -> lr callable or a
    ``PlateauSchedule``; ``grad_accum`` k > 1 accumulates k micro-steps
    (``optax.MultiSteps``); ``trainable`` (one bool a parameter) freezes
    the others."""
    name = opt.lower()
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {opt!r}; available: {sorted(OPTIMIZERS)}")
    if clip_grad and clip_mode.lower() not in CLIP_MODES:
        raise ValueError(f"unknown clip_mode {clip_mode!r}")
    if params is None:
        raise ValueError("pass the model's named_parameters() as `params`")
    return FlatOptimizer(params, name, schedule, weight_decay=weight_decay, momentum=momentum,
                         clip_grad=clip_grad, clip_mode=clip_mode, eps=eps, betas=betas,
                         grad_accum=grad_accum, trainable=trainable)


@torch.no_grad()
def recalibrate_bn(model: torch.nn.Module, batches, num_steps: int = 50) -> torch.nn.Module:
    """Re-estimate every BatchNorm's running statistics over ``batches``
    (state.py:61-90): training-mode forwards, no parameter update, the same
    drop-path and dropout draws (generator seed 0) for every batch. Batches
    are (B, H, W, 3) normalized images or dicts with ``"image"``. Returns
    ``model``, in the mode it was in."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    if not bns:
        return model
    was_training = model.training
    dev = next(model.parameters()).device
    model.train()
    for i, batch in enumerate(batches):
        if i >= num_steps:
            break
        images = batch["image"] if isinstance(batch, dict) else batch
        images = torch.as_tensor(images).to(dev).float()
        model(images, resize_output=False,
              generator=torch.Generator(device=dev).manual_seed(0))
    model.train(was_training)
    return model
