"""Name -> factory registries for backbones and heads.

Own copy of ``segmentation_factory_tpu/registry.py``. A backbone factory
is ``(dtype, img_size, **options) -> (nn.Module, channels)``, ``channels``
being the widths of the feature pyramid it returns and ``img_size`` the
square input size the model is built for (only MetaFormer's RandomMixing
has state that it sizes; the other families ignore it); a head factory is ``(channels, num_classes, embed_dim, dtype, **kwargs) ->
nn.Module``. A name of a family the port lacks (``NOT_PORTED``) raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict

BACKBONES: Dict[str, Callable] = {}
HEADS: Dict[str, Callable] = {}
# families of the JAX registry that the port does not have: their names
# raise NotImplementedError, any other unknown name KeyError
NOT_PORTED = ("maskrcnnsegmentationhead",)


def _register(table: Dict[str, Callable], kind: str, name: str):
    def deco(fn: Callable) -> Callable:
        key = name.lower()
        if key in table:
            raise KeyError(f"{kind} {key!r} already registered")
        table[key] = fn
        return fn

    return deco


def register_backbone(name: str):
    return _register(BACKBONES, "backbone", name)


def register_head(name: str):
    return _register(HEADS, "head", name)


def _ensure_zoo_imported() -> None:
    import segmentation_factory_tpu_torch.models.backbones  # noqa: F401
    import segmentation_factory_tpu_torch.models.heads  # noqa: F401


def _lookup(table: Dict[str, Callable], kind: str, name: str) -> Callable:
    _ensure_zoo_imported()
    key = name.lower()
    if key not in table:
        if key.split("_")[0] in NOT_PORTED:
            raise NotImplementedError(f"{kind} {name!r} is not ported: its family "
                                      f"{key.split('_')[0]!r} has no port yet")
        raise KeyError(f"unknown {kind} {name!r}; available: {sorted(table)}")
    return table[key]


def get_backbone(name: str, **kwargs):
    return _lookup(BACKBONES, "backbone", name)(**kwargs)


def get_head(name: str, **kwargs):
    return _lookup(HEADS, "head", name)(**kwargs)
