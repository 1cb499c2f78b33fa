"""Pinned config #4's data and eval path on the CPU against PIL and the JAX
package: the host engine's bicubic and PIL-nearest resizes against PIL,
its rotation against the JAX engine's, ``synapse_train_augment`` and a
Synapse ``Loader`` epoch against the JAX functions, ``dice_per_case``
against JAX's, and ``evaluate_volumes`` on one MiT-B0 (converted weights,
float32) against the JAX function.

Tolerances: resizes, rotations, recipes, batches and dice of the same
label maps are exact. ``evaluate_volumes``' label maps are equal outside
near-ties (pixels whose top-2 JAX logit gap is under 1e-4, where reordered
float32 sums may flip the argmax); where none flips, its dice equal the
JAX function's within 1e-6 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segmentation_factory_tpu import infer as jinfer
from segmentation_factory_tpu import metrics as jmetrics
from segmentation_factory_tpu import native as jax_native
from segmentation_factory_tpu.convert import convert_full_model
from segmentation_factory_tpu.data import Loader as JaxLoader
from segmentation_factory_tpu.data import datasets as jds
from segmentation_factory_tpu.data.transforms import synapse_train_augment as jax_augment
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu_torch import build_model, infer
from segmentation_factory_tpu_torch.data import datasets as tds
from segmentation_factory_tpu_torch.data import native
from segmentation_factory_tpu_torch.data.pipeline import Loader
from segmentation_factory_tpu_torch.data.transforms import synapse_train_augment
from segmentation_factory_tpu_torch.metrics import dice_per_case

from _torch_port import load_numpy, random_state_dict, two_torch_threads  # noqa: F401

# (source h, w) -> (output h, w); the last only for the nearest rule
SIZES = [((512, 512), (224, 224)), ((200, 300), (224, 224)), ((90, 100), (224, 224)),
         ((311, 57), (100, 224))]
GAP = 1e-4


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX package's engine, loaded: without it the JAX recipe rotates
    with PIL. Another process may be writing the library at first use."""
    import time

    for _ in range(30):
        if jax_native.available():
            return
        jax_native._build_error = None
        time.sleep(1.0)
    pytest.fail("the JAX package's transform engine does not load")


def _photo(h, w, seed):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([3 * xx + yy, 5 * yy, 2 * (xx + yy)], -1)
    img = img + np.random.default_rng(seed).integers(0, 40, (h, w, 3))
    return (img % 256).astype(np.uint8)


@pytest.mark.parametrize("src,dst", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_bicubic_equals_pil(src, dst):
    img = _photo(*src, seed=src[0])
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BICUBIC))
    np.testing.assert_array_equal(native.resize_bicubic_u8(img, dst), want)


@pytest.mark.parametrize("src,dst", SIZES + [((512, 512), (97, 333))],
                         ids=lambda s: "x".join(map(str, s)))
def test_nearest_equals_pil(src, dst):
    lbl = np.random.default_rng(src[1]).integers(-5, 300, src).astype(np.int32)
    want = np.asarray(Image.fromarray(lbl).resize(dst[::-1], Image.NEAREST))
    np.testing.assert_array_equal(native.resize_nearest_pil_i32(lbl, dst), want)


def test_nearest_is_not_the_loaders_rule():
    """PIL's nearest rule is not the train scale-crop's at 512² -> 224²
    (``batch_scale_crop`` at scale 224 / 512, the whole canvas cropped); the
    eval shrink, ``resize_pair``, takes PIL's."""
    lbl = np.arange(512 * 512, dtype=np.int32).reshape(512, 512)
    img = np.zeros((512, 512, 3), np.uint8)
    pil = native.resize_nearest_pil_i32(lbl, (224, 224))
    _, train = native.batch_scale_crop(img[None], lbl[None], np.asarray([224 / 512], np.float32),
                                       np.zeros(1, np.int32), np.zeros(1, np.int32), 224,
                                       num_threads=1)
    assert (train[0] != pil).any()
    np.testing.assert_array_equal(native.resize_pair(img, lbl, (224, 224))[1], pil)


@pytest.mark.parametrize("angle", [-19.37, 0.0, 7.5, 20.0])
@pytest.mark.parametrize("nearest", [True, False], ids=["nearest", "bilinear"])
def test_rotate_pair_equals_jax_engine(angle, nearest, jax_engine):
    img = _photo(61, 48, seed=3)
    lbl = np.random.default_rng(4).integers(0, 9, (61, 48)).astype(np.int32)
    got = native.rotate_pair(img, lbl, angle, nearest_img=nearest, img_fill=7, lbl_fill=255)
    want = jax_native.rotate_pair(img, lbl, angle, nearest_img=nearest, img_fill=7, lbl_fill=255)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_synapse_train_augment_equals_jax(jax_engine):
    """32 seeds: each branch (rot90 + flip, rotation, neither) is taken."""
    img = _photo(120, 100, seed=5)
    lbl = np.random.default_rng(6).integers(0, 9, (120, 100)).astype(np.int32)
    for seed in range(32):
        got = synapse_train_augment(img, lbl, np.random.default_rng(seed), (64, 64))
        want = jax_augment(img, lbl, np.random.default_rng(seed), (64, 64))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w.astype(g.dtype))
    same = synapse_train_augment(img, lbl, np.random.default_rng(1), (120, 100))
    np.testing.assert_array_equal(same[1], jax_augment(img, lbl, np.random.default_rng(1),
                                                       (120, 100))[1])


def _synapse_tree(root, n_slices=7, side=40, cases=((6, 48, 48), (3, 96, 96)), seed=0):
    import h5py

    rng = np.random.default_rng(seed)
    for sub in ("lists", "train_npz", "test_vol_h5"):
        os.makedirs(root / sub, exist_ok=True)
    names = [f"case0005_slice{i:03d}" for i in range(n_slices)]
    yy, xx = np.mgrid[0:side, 0:side]
    for i, n in enumerate(names):
        lbl = ((yy // 10 + xx // 13 + i) % 9).astype(np.float32)
        img = (lbl / 9 + rng.normal(0, 0.05, lbl.shape)).astype(np.float32)
        np.savez(root / "train_npz" / f"{n}.npz", image=img, label=lbl)
    (root / "lists" / "train.txt").write_text("\n".join(names) + "\n")
    vols = []
    for c, (d, h, w) in enumerate(cases):
        yy, xx = np.mgrid[0:h, 0:w]
        lbl = np.stack([((yy // 12 + xx // 16 + k) % 5) * (k % 3 != 2) for k in range(d)])
        img = np.clip(lbl / 5 + rng.normal(0, 0.1, lbl.shape), 0, 1).astype(np.float32)
        with h5py.File(root / "test_vol_h5" / f"case{c:04d}.npy.h5", "w") as f:
            f["image"], f["label"] = img, lbl.astype(np.float32)
        vols.append(f"case{c:04d}")
    (root / "lists" / "test_vol.txt").write_text("\n".join(vols) + "\n")
    return str(root)


def test_synapse_loader_epochs_equal_jax(tmp_path, jax_engine):
    """Two epochs of 7 slices in batches of 3 through each package's
    ``SynapseCT`` and ``Loader``: the recipe runs sample by sample."""
    root = _synapse_tree(tmp_path)
    kw = dict(batch_size=3, crop=24, train=True, seed=5, num_workers=2)
    port = Loader(tds.SynapseCT(root, "train"), **kw)
    ref = JaxLoader(jds.SynapseCT(root, "train"), shard_id=0, num_shards=1, **kw)
    assert len(port) == len(ref) == 2
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for g, w in zip(list(port), list(ref)):
            for key in ("image", "label"):
                assert g[key].dtype == w[key].dtype and g[key].shape == (3, 24, 24, 3)[
                    :g[key].ndim]
                np.testing.assert_array_equal(g[key], w[key])


def test_dice_per_case_equals_jax():
    rng = np.random.default_rng(7)
    preds = rng.integers(0, 6, (3, 17, 19)).astype(np.int32)  # classes 6-8 never predicted
    labels = rng.integers(0, 5, (3, 17, 19)).astype(np.int32)  # 5-8 absent from the truth
    labels[0, :4] = 255
    preds[1, :3] = 7
    for nc in (9, 4):
        got = dice_per_case(torch.from_numpy(preds), torch.from_numpy(labels), nc)
        want = np.asarray(jmetrics.dice_per_case(jnp.asarray(preds), jnp.asarray(labels), nc))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
    assert got.numpy()[-1] != 1.0 and dice_per_case(torch.zeros(4), torch.zeros(4), 3)[2] == 1.0


@pytest.fixture(scope="module")
def b0():
    nc = 5
    port = build_model("mit_b0", "segformerhead", nc, dtype=torch.float32, device="cpu")
    sd = random_state_dict(port, seed=31)
    load_numpy(port, sd)
    jmodel = jax_build_model("mit_b0", "segformerhead", nc, dtype=jnp.float32)
    return nc, port, jmodel, convert_full_model(sd, "mit_b0", "segformerhead")


def test_evaluate_volumes_equals_jax(b0, tmp_path, monkeypatch):
    """Two cases, 6 slices of 48² (one window) and 3 of 96² (a 64² crop
    slides 2 x 2 windows), groups of 4 slices padded: the port against the
    JAX function with the same model, the JAX slide by ``_slide_impl``."""
    nc, port, jmodel, variables = b0
    root = _synapse_tree(tmp_path)
    jfwd = jax.jit(lambda x: jmodel.apply(variables, x, train=False))
    jlogits, preds = [], {"port": [], "jax": []}

    def jforward(x):
        out = jinfer._slide_impl(jfwd, x, nc, 64) if x.shape[1] > 64 else jfwd(x)
        jlogits.append(np.asarray(out))
        return out

    real_j, real_t = jmetrics.dice_per_case, infer.dice_per_case
    monkeypatch.setattr(jmetrics, "dice_per_case",
                        lambda p, t, c: (preds["jax"].append(np.asarray(p)), real_j(p, t, c))[1])
    monkeypatch.setattr(infer, "dice_per_case",
                        lambda p, t, c: (preds["port"].append(p.numpy()), real_t(p, t, c))[1])
    want = jinfer.evaluate_volumes(jforward, jds.SynapseCT(root, "val").volumes(), nc,
                                   crop=1 << 30, batch_slices=4)
    with torch.inference_mode():
        got = infer.evaluate_volumes(port, tds.SynapseCT(root, "val").volumes(), nc, crop=64,
                                     batch_slices=4, device="cpu")
    flips = 0
    for case, (p, j) in enumerate(zip(preds["port"], preds["jax"])):
        logits = np.concatenate(jlogits[:2] if case == 0 else jlogits[2:])[:len(j)]
        top2 = np.sort(logits, axis=-1)[..., -2:]
        ties = (top2[..., 1] - top2[..., 0]) < GAP
        assert p.shape == j.shape and not np.any((p != j) & ~ties)
        flips += int((p != j).sum())
    assert sorted(got) == sorted(want) and list(got["per_case"]) == ["case0000", "case0001"]
    if not flips:
        np.testing.assert_allclose(got["mean_dice_fg"], want["mean_dice_fg"], rtol=1e-6)
        np.testing.assert_allclose(got["per_class_dice"], want["per_class_dice"], rtol=1e-6)
        np.testing.assert_allclose(list(got["per_case"].values()),
                                   list(want["per_case"].values()), rtol=1e-6)
