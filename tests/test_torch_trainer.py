"""The port's training data path against the JAX package on the CPU:
configs, the synthetic dataset, the Loader and device-side augmentation
(the eval protocols and ``Trainer.evaluate``: ``test_torch_trainer_eval.py``;
``fit``, checkpoints with resume, the CLI and the refusal of a
multi-device mesh: ``test_torch_trainer_fit.py``; the other options:
``test_torch_trainer_options.py``).

Tolerances: configs, datasets, Loader batches and labels are compared
exactly. Augmented images within 1e-4 (float32; the contrast's grey mean is
a reordered sum over the image).
"""

import dataclasses
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segmentation_factory_tpu import config as jconfig
from segmentation_factory_tpu.data import Loader as JaxLoader
from segmentation_factory_tpu.data import Synthetic as JaxSynthetic
from segmentation_factory_tpu.data import augment_batch as jax_augment_batch
from segmentation_factory_tpu.data import random_scale_crop as jax_random_scale_crop
from segmentation_factory_tpu_torch import config
from segmentation_factory_tpu_torch.data.datasets import Synthetic, build_dataset
from segmentation_factory_tpu_torch.data.pipeline import Loader, prefetch_to_device
from segmentation_factory_tpu_torch.data.transforms import (
    augment_batch,
    draw_augment,
    random_scale_crop,
)

from _torch_port import two_torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_configs_parse_like_jax(path):
    text = path.read_text()
    got = config.TrainConfig.from_json(text)
    want = jconfig.TrainConfig.from_json(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert config.TrainConfig.from_json(got.to_json()) == got


def test_synthetic_load_identical(tmp_path):
    port, ref = Synthetic(5, size=40, length=3, seed=3), JaxSynthetic(5, size=40, length=3, seed=3)
    assert len(port) == len(ref) and port.num_classes == ref.num_classes == 5
    np.testing.assert_array_equal(port.PALETTE, ref.PALETTE)
    for i in range(3):
        for a, b in zip(port.load(i), ref.load(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert isinstance(build_dataset("synthetic", "./data", "train", num_classes=4), Synthetic)
    # a file-backed dataset builds; its JPEG images load as PIL decodes them
    for sub in ("images", "annotations"):
        (tmp_path / sub / "training").mkdir(parents=True)
    Image.fromarray(port.load(0)[0]).save(tmp_path / "images" / "training" / "a.jpg", "JPEG")
    Image.fromarray(port.load(0)[1].astype(np.uint8)).save(
        tmp_path / "annotations" / "training" / "a.png")
    ade = build_dataset("ade20k", str(tmp_path), "train")
    img, lbl = ade.load(0)
    want = np.asarray(Image.open(tmp_path / "images" / "training" / "a.jpg").convert("RGB"))
    np.testing.assert_array_equal(img, want)
    np.testing.assert_array_equal(lbl, ade.encode_label(port.load(0)[1]))


@pytest.fixture
def jax_engine():
    """The JAX package's transform engine, loaded: without it the JAX Loader
    falls back to PIL. Another test process may be writing the library at
    first use, so a failed load is retried for a while."""
    from segmentation_factory_tpu import native as jax_native

    for _ in range(30):
        if jax_native.available():
            return
        jax_native._build_error = None
        time.sleep(1.0)
    pytest.fail("the JAX package's transform engine does not load")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_loader_batches_bit_identical(train, jax_engine):
    """Two epochs of a 7-sample set in batches of 3: the train loader's
    shuffle and scale-crop draws, the eval loader's padding to a larger
    canvas and its ignore-labelled padding of the last batch."""
    kw = dict(batch_size=3, crop=24, train=train, scale_range=(0.5, 2.0), seed=5, num_workers=2,
              eval_hw=(48, 48))
    port = Loader(Synthetic(4, size=40, length=7, seed=1), **kw)
    ref = JaxLoader(JaxSynthetic(4, size=40, length=7, seed=1), shard_id=0, num_shards=1, **kw)
    assert len(port) == len(ref) == (2 if train else 3)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for key in ("image", "label"):
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])


def test_random_scale_crop_matches_jax(jax_engine):
    img, lbl = Synthetic(4, size=40, length=1, seed=2).load(0)
    for seed in range(4):
        got = random_scale_crop(img, lbl, 24, rng=np.random.default_rng(seed))
        want = jax_random_scale_crop(img, lbl, 24, rng=np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_prefetch_to_device_keeps_order_and_raises():
    batches = [{"x": np.full((2,), i, np.int32)} for i in range(5)]
    got = [int(b["x"][0]) for b in prefetch_to_device(iter(batches), "cpu")]
    assert got == list(range(5))

    def failing():
        yield {"x": np.zeros(1)}
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(prefetch_to_device(failing(), "cpu"))


def test_augment_batch_matches_jax_draws():
    """The port's augmentation fed the flips, jitter factors and op orders
    the JAX function draws from its key; and ``draw_augment``'s layout."""
    rng = np.random.default_rng(0)
    b, j = 4, 0.5
    imgs = rng.integers(0, 256, (b, 12, 10, 3)).astype(np.uint8)
    lbls = rng.integers(0, 5, (b, 12, 10)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    want_i, want_l = jax_augment_batch(key, jnp.asarray(imgs), jnp.asarray(lbls), hflip=True,
                                       vflip=True, color_jitter=j)
    k_flip, k_vflip, k_b, k_c, k_s, k_order = jax.random.split(key, 6)
    shape = (b, 1, 1, 1)
    draws = {
        "hflip": jax.random.bernoulli(k_flip, 0.5, shape),
        "vflip": jax.random.bernoulli(k_vflip, 0.5, shape),
        "brightness": jax.random.uniform(k_b, shape, minval=1 - j, maxval=1 + j),
        "contrast": jax.random.uniform(k_c, shape, minval=1 - j, maxval=1 + j),
        "saturation": jax.random.uniform(k_s, shape, minval=1 - j, maxval=1 + j),
        "order": jax.vmap(lambda k: jax.random.permutation(k, 3))(jax.random.split(k_order, b)),
    }
    draws = {k: torch.from_numpy(np.array(v).reshape(b, -1).squeeze(1) if k != "order"
                                 else np.array(v)) for k, v in draws.items()}
    got_i, got_l = augment_batch(torch.from_numpy(imgs), torch.from_numpy(lbls), draws)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0, atol=1e-4)

    d = draw_augment(torch.Generator().manual_seed(0), 6, vflip=True, color_jitter=j)
    assert sorted(d) == ["brightness", "contrast", "hflip", "order", "saturation", "vflip"]
    assert d["hflip"].dtype == torch.bool and d["order"].shape == (6, 3)
    assert (d["order"].sort(1).values == torch.arange(3)).all()
    assert ((d["contrast"] >= 1 - j) & (d["contrast"] <= 1 + j)).all()
    assert sorted(draw_augment(torch.Generator(), 2, color_jitter=0.0)) == ["hflip"]
