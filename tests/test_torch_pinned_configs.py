"""Pinned configs #2 (ConvNeXt-T + UPerHead, ADE20K) and #3 (MobileNetV4-M +
FPNHead, Kvasir) through the port against the JAX package, on the CPU: the
registry builds every pinned (backbone, head) pair; ``from_jax_variables``
inverts the JAX ``convert_full_model`` on each family's JAX init; the
port's ``Trainer`` runs each config file.

Each config file is read as it is and shrunk in size, steps and batch only
(``Synthetic`` data at the config's classes, 32², batch 8: the JAX
Trainer's batch must divide over the 8 CPU devices of the test session).
Both Trainers compute in the config's bfloat16, so their confusion
matrices are held equal outside near-ties: pixels whose float32 top-2 gap
is within twice the two models' largest logit difference. The conversion
round trip is exact.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import config as jconfig
from segmentation_factory_tpu.convert import convert_full_model
from segmentation_factory_tpu.data import Synthetic as JaxSynthetic
from segmentation_factory_tpu.engine import loop as jloop
from segmentation_factory_tpu_torch import build_model, config
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.data.datasets import Synthetic
from segmentation_factory_tpu_torch.data.transforms import preprocess_eval
from segmentation_factory_tpu_torch.engine import loop as tloop
from segmentation_factory_tpu_torch.models.build import SegmentationModel, default_embed_dim
from segmentation_factory_tpu_torch.registry import BACKBONES, HEADS

from _torch_port import two_torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"convnext_uperhead": "ade20k_convnext_tiny_upernet_512.json",
           "mobilenetv4_fpn": "kvasir_mobilenetv4_fpn_512.json"}
SIZE, BATCH = 32, 8


def test_registry_builds_every_pinned_pair():
    """Every pinned config's (backbone, head) pair builds (on the meta
    device: the modules and their shapes, no weights); the ported names are
    registered; ``fused_blocks`` is MiT's choice alone."""
    for path in sorted((REPO / "configs").glob("*.json")):
        m = json.loads(path.read_text())["model"]
        with torch.device("meta"):
            model = SegmentationModel(m["backbone"], m["head"], m["num_classes"],
                                      embed_dim=m["embed_dim"])
        assert model.decode_head.embed_dim == (m["embed_dim"]
                                               or default_embed_dim(m["backbone"])), path.name
    for name in ("convnext_tiny", "convnext_small", "convnext_base", "convnext_large",
                 "convnext_xlarge", "mobilenetv4_small", "mobilenetv4_medium",
                 "mobilenetv4_large", "mobilenetv4_samll"):
        assert name in BACKBONES, name
    assert {"uperhead", "fpnhead", "segformerhead"} <= set(HEADS)
    with pytest.raises(ValueError, match="fused_blocks"):
        with torch.device("meta"):
            SegmentationModel("convnext_tiny", "uperhead", 150, fused_blocks=False)


def _config(cls, name, out):
    cfg = cls.TrainConfig.from_json((REPO / "configs" / CONFIGS[name]).read_text())
    cfg.output_dir = str(out)
    cfg.data.dataset, cfg.data.img_size, cfg.data.batch_size = "synthetic", SIZE, BATCH
    cfg.data.num_workers = 2
    return cfg


def _data(cls, nc):
    return (cls(num_classes=nc, size=SIZE, length=2 * BATCH, seed=0),
            cls(num_classes=nc, size=SIZE, length=2, seed=1))


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_run(request, tmp_path_factory):
    """The JAX Trainer on the config: its initial variables and its eval's
    confusion matrix."""
    name = request.param
    cfg = _config(jconfig, name, tmp_path_factory.mktemp(f"jax_{name}"))
    hists = {}
    with pytest.MonkeyPatch.context() as mp:
        real = jloop.compute_metrics
        mp.setattr(jloop, "compute_metrics", lambda h: (hists.setdefault("h", np.asarray(h)),
                                                        real(h))[1])
        jt = jloop.Trainer(cfg, *_data(JaxSynthetic, cfg.model.num_classes))
        jt.evaluate()
    jt.ckpt.close()
    variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    return name, cfg, jt.model, variables, hists["h"]


def test_from_jax_variables_inverts_convert_full_model(jax_run):
    """The JAX init: ``from_jax_variables`` then the JAX
    ``convert_full_model`` give back every leaf of params and batch_stats
    exactly, and the port loads the state_dict strictly."""
    _, cfg, _, variables, _ = jax_run
    m = cfg.model
    sd = from_jax_variables(variables)
    back = convert_full_model({k: v.numpy() for k, v in sd.items()}, m.backbone, m.head)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf), err_msg=str(path))
    port = build_model(m.backbone, m.head, m.num_classes, embed_dim=m.embed_dim,
                       dtype=torch.float32, device="cpu")
    port.load_state_dict(sd, strict=True)


def test_trainer_runs_pinned_config(jax_run, tmp_path, monkeypatch):
    """The port's Trainer on the config file: its eval at the JAX Trainer's
    initial weights gives the JAX Trainer's confusion matrix outside
    near-ties; then one epoch of 2 steps (the config's loss, augmentation
    and optimizer), its eval, a checkpoint."""
    name, jcfg, jmodel, variables, want_hist = jax_run
    hists = {}
    real = tloop.compute_metrics
    monkeypatch.setattr(tloop, "compute_metrics",
                        lambda h: (hists.setdefault("h", np.asarray(h)), real(h))[1])
    cfg = _config(config, name, tmp_path)
    tt = tloop.Trainer(cfg, *_data(Synthetic, cfg.model.num_classes), device="cpu")
    tt.model.load_state_dict(from_jax_variables(variables))
    tt.evaluate()
    assert hists["h"].sum() == 2 * SIZE * SIZE

    x = torch.cat([preprocess_eval(torch.as_tensor(b["image"])) for b in tt.val_loader])
    with torch.inference_mode():
        got = tt.model(x).float().numpy()
    forward = jax.jit(lambda v, images: jmodel.apply(v, images, train=False))
    want = np.asarray(forward(variables, x.numpy()), np.float32)
    top2 = np.sort(want, axis=-1)[..., -2:]
    ties = (top2[..., 1] - top2[..., 0]) <= max(1e-5, 2 * np.abs(got - want).max())
    assert not np.any((got.argmax(-1) != want.argmax(-1)) & ~ties)
    assert np.abs(hists["h"] - want_hist).sum() <= 2 * ties.sum()

    best = tt.fit(1)
    assert tt.step == 2 and tt.ckpt.latest_step() == 2 and np.isfinite(best["mIoU"])
    assert int(tt.optimizer.count) == 2
