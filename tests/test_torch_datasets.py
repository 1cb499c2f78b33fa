"""The port's file-backed dataset manifests against the JAX package's, on
trees the tests write: Cityscapes, VOC (its list variants), ADE20K,
COCO-Stuff, Kvasir + CVC-ClinicDB (its seeded split) and Synapse (the
``.npz`` train slices and the ``.npy.h5`` val volumes, written by h5py).

Images are PNG, also under ``.jpg`` names (PIL opens a file by its content,
and so does the port), and real JPEGs: on JPEG trees of VOC, ADE20K,
COCO-Stuff and Kvasir-SEG (JPEG masks too; with and without its preset
recipe) the port's ``Loader`` gives the JAX ``Loader``'s train and eval
batches, eval images larger than the canvas shrunk as PIL shrinks them.
``kvasir_train_augment`` is held against the JAX function on 8 seeds. A
CMYK JPEG and a BMP raise "not ported". Pairs, loaded images and labels,
label encodings over all 256 values, volumes and batches are compared
exactly.
"""

import os
import time

import h5py
import numpy as np
import pytest
from PIL import Image

from segmentation_factory_tpu.data import Loader as JaxLoader
from segmentation_factory_tpu.data import datasets as jds
from segmentation_factory_tpu.data.transforms import kvasir_train_augment as jax_kvasir_augment
from segmentation_factory_tpu_torch.data import datasets as tds
from segmentation_factory_tpu_torch.data.pipeline import Loader
from segmentation_factory_tpu_torch.data.transforms import kvasir_train_augment

from _torch_port import two_torch_threads  # noqa: F401  (autouse)


def _img(seed, h=20, w=26):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


def _save(path, arr, mode=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    im = Image.fromarray(arr)
    if mode == "P":
        im = im.convert("P")
        im.putpalette(tds.voc_colormap().ravel().tolist())
    im.save(path, format="PNG")


def _lbl(seed, hi, h=20, w=26):
    return np.random.default_rng(seed).integers(0, hi, (h, w)).astype(np.uint8)


def _same(port, ref):
    """Equal pairs, classes and every sample."""
    assert port.pairs == ref.pairs and len(port) == len(ref) > 0
    assert tuple(port.CLASSES) == tuple(ref.CLASSES)
    for i in range(len(ref)):
        for a, b in zip(port.load(i), ref.load(i)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _encodes_alike(port, ref):
    values = np.arange(256, dtype=np.int32).reshape(16, 16)
    np.testing.assert_array_equal(port.encode_label(values.copy()), ref.encode_label(values.copy()))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("data")
    # Cityscapes: two cities, label ids 0..40
    for k, (city, n) in enumerate([("aachen", "aachen_000000_000019"),
                                   ("bonn", "bonn_000001_000019"),
                                   ("aachen", "aachen_000002_000019")]):
        _save(f"{r}/cityscapes/leftImg8bit/train/{city}/{n}_leftImg8bit.png", _img(k))
        _save(f"{r}/cityscapes/gtFine/train/{city}/{n}_gtFine_labelIds.png", _lbl(k, 41))
    # VOC: JPEGImages (PNG content under .jpg), both mask directories
    voc = f"{r}/voc/VOCdevkit/VOC2012"
    names = [f"2007_00{i:04d}" for i in range(5)]
    for k, n in enumerate(names):
        _save(f"{voc}/JPEGImages/{n}.jpg", _img(10 + k))
        lbl = _lbl(10 + k, 21)
        lbl[0] = 255
        _save(f"{voc}/SegmentationClass/{n}.png", lbl, mode="P")
        _save(f"{voc}/SegmentationClassAug/{n}.png", _lbl(20 + k, 21))
    os.makedirs(f"{voc}/ImageSets/Segmentation")
    with open(f"{voc}/ImageSets/Segmentation/train.txt", "w") as f:
        f.write("\n".join(names[:2]) + "\n")
    with open(f"{voc}/ImageSets/Segmentation/val.txt", "w") as f:
        f.write("\n".join(names[3:]) + "\n\n")
    with open(f"{r}/voc/train_aug.txt", "w") as f:  # the "path path" variant, at the root
        f.write("".join(f"/JPEGImages/{n}.jpg /SegmentationClassAug/{n}.png\n"
                        for n in names[1:4]))
    # ADE20K and COCO-Stuff: images/<split>/*.jpg, annotations/<split>/*.png
    for sub, split, hi in (("ade", "training", 151), ("coco", "train2017", 256)):
        for k in range(3):
            _save(f"{r}/{sub}/images/{split}/im{k}.jpg", _img(30 + k))
            _save(f"{r}/{sub}/annotations/{split}/im{k}.png", _lbl(30 + k, hi))
    # Kvasir-SEG (RGB masks under .jpg names) and CVC-ClinicDB (grey masks)
    for k in range(6):
        _save(f"{r}/kvasir/Kvasir-SEG/images/k{k}.jpg", _img(40 + k))
        _save(f"{r}/kvasir/Kvasir-SEG/masks/k{k}.jpg", _img(50 + k))
    for k in range(5):
        _save(f"{r}/kvasir/CVC-ClinicDB/images/{k + 1}.png", _img(60 + k))
        _save(f"{r}/kvasir/CVC-ClinicDB/masks/{k + 1}.png", _lbl(60 + k, 256))
    # Synapse: train slices and val volumes
    syn = f"{r}/synapse"
    os.makedirs(f"{syn}/lists")
    os.makedirs(f"{syn}/train_npz")
    os.makedirs(f"{syn}/test_vol_h5")
    rng = np.random.default_rng(70)
    slices = [f"case0005_slice{i:03d}" for i in range(3)]
    for n in slices:
        image = rng.uniform(-0.05, 1.05, (24, 24)).astype(np.float32)
        image[0, :4] = [0.5 / 255, 1.0, 254.9999 / 255, 0.0]
        np.savez(f"{syn}/train_npz/{n}.npz", image=image,
                 label=rng.integers(0, 9, (24, 24)).astype(np.float32))
    cases = ["case0001", "case0002"]
    for n in cases:
        with h5py.File(f"{syn}/test_vol_h5/{n}.npy.h5", "w") as f:
            f["image"] = rng.uniform(0, 1, (4, 24, 24)).astype(np.float32)
            f["label"] = rng.integers(0, 9, (4, 24, 24)).astype(np.float32)
    with open(f"{syn}/lists/train.txt", "w") as f:
        f.write("\n".join(slices) + "\n")
    with open(f"{syn}/lists/test_vol.txt", "w") as f:
        f.write("\n".join(cases) + "\n")
    return str(r)


@pytest.mark.parametrize("split", ["train", "val"])
def test_cityscapes_matches_jax(root, split):
    if split == "val":  # an empty split lists nothing in either
        assert tds.Cityscapes(f"{root}/cityscapes", "val").pairs == []
        return
    port = tds.build_dataset("cityscapes", f"{root}/cityscapes", split)
    ref = jds.build_dataset("cityscapes", f"{root}/cityscapes", split)
    _same(port, ref)
    _encodes_alike(port, ref)


@pytest.mark.parametrize("split,year", [("train", "2012"), ("val", "2012"),
                                        ("train", "2012_aug"), ("val", "2012_aug")])
def test_voc_matches_jax(root, split, year):
    port = tds.VOCSegmentation(f"{root}/voc", split, year)
    ref = jds.VOCSegmentation(f"{root}/voc", split, year)
    _same(port, ref)


def test_voc_aug_list_variants(root, tmp_path):
    """The aug list beside the dataset and in VOC2012, its bare-name and "path path"
    lines; the aug masks absent (the plain list); the aug list absent (a
    warning and the plain list)."""
    base = f"{root}/voc/VOCdevkit/VOC2012"
    port = tds.VOCSegmentation(f"{root}/voc", "train")
    assert [os.path.basename(p) for p, _ in port.pairs] == [
        f"2007_00{i:04d}.jpg" for i in range(1, 4)]
    assert all("SegmentationClassAug" in m for _, m in port.pairs)
    plain = tmp_path / "VOC2012"
    os.makedirs(plain)
    for sub in ("JPEGImages", "SegmentationClass", "ImageSets"):
        os.symlink(f"{base}/{sub}", plain / sub)
    port, ref = tds.VOCSegmentation(str(plain), "train"), jds.VOCSegmentation(str(plain), "train")
    assert port.pairs == ref.pairs and all("SegmentationClass/" in m for _, m in port.pairs)
    os.symlink(f"{base}/SegmentationClassAug", plain / "SegmentationClassAug")
    with pytest.warns(UserWarning, match="train_aug.txt not found"):
        port = tds.VOCSegmentation(str(plain), "train")
    with pytest.warns(UserWarning):
        ref = jds.VOCSegmentation(str(plain), "train")
    assert port.pairs == ref.pairs and len(port) == 2
    with open(plain / "train_aug.txt", "w") as f:
        f.write("2007_000004\n\n2007_000000 extra\n")
    port, ref = tds.VOCSegmentation(str(plain), "train"), jds.VOCSegmentation(str(plain), "train")
    assert port.pairs == ref.pairs and len(port) == 2
    _same(port, ref)


@pytest.mark.parametrize("name,sub,split", [("ade20k", "ade", "train"),
                                            ("cocostuff", "coco", "train")])
def test_ade20k_and_cocostuff_match_jax(root, name, sub, split):
    port = tds.build_dataset(name, f"{root}/{sub}", split)
    ref = jds.build_dataset(name, f"{root}/{sub}", split)
    _same(port, ref)
    _encodes_alike(port, ref)
    np.testing.assert_array_equal(port.PALETTE, ref.PALETTE)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("split", ["train", "val"])
def test_kvasir_split_matches_jax(root, split, seed):
    port = tds.KvasirClinicDB(f"{root}/kvasir", split, val_frac=0.3, seed=seed)
    ref = jds.KvasirClinicDB(f"{root}/kvasir", split, val_frac=0.3, seed=seed)
    _same(port, ref)
    _encodes_alike(port, ref)
    rgb = np.random.default_rng(seed).integers(0, 256, (5, 7, 3))
    np.testing.assert_array_equal(port.encode_label(rgb), ref.encode_label(rgb))
    # the preset recipe: the same split, and the same recipe on a sample
    port = tds.KvasirClinicDB(f"{root}/kvasir", split, val_frac=0.3, seed=seed,
                              preset_recipe=True)
    ref = jds.KvasirClinicDB(f"{root}/kvasir", split, val_frac=0.3, seed=seed,
                             preset_recipe=True)
    _same(port, ref)
    img, lbl = port.load(0)
    got = port.train_augment(img, lbl, np.random.default_rng(seed), (16, 16))
    want = ref.train_augment(img, lbl, np.random.default_rng(seed), (16, 16))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_synapse_slices_and_volumes_match_jax(root):
    port = tds.build_dataset("synapse", f"{root}/synapse", "train")
    ref = jds.build_dataset("synapse", f"{root}/synapse", "train")
    _same(port, ref)
    assert port.load(0)[0][0, :4, 0].tolist() == [0, 255, 254, 0]
    port_val = tds.build_dataset("synapse", f"{root}/synapse", "val")
    ref_val = jds.build_dataset("synapse", f"{root}/synapse", "val")
    assert port_val.pairs == ref_val.pairs and len(port_val) == 2
    got, want = list(port_val.volumes()), list(ref_val.volumes())
    assert len(got) == len(want) == 2
    for (n1, i1, l1), (n2, i2, l2) in zip(got, want):
        assert n1 == n2 and i1.dtype == i2.dtype and l1.dtype == l2.dtype == np.int32
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(l1, l2)
    with pytest.raises(IndexError, match="volumetric"):
        port_val.load(0)


def test_jpeg_raises_not_ported(tmp_path):
    """The formats that still raise: a CMYK JPEG (the decoder's refusal) and
    a BMP (no reader), also under a ``.png`` name."""
    path = tmp_path / "photo.jpg"
    Image.fromarray(_img(80)).convert("CMYK").save(path, format="JPEG")
    with pytest.raises(NotImplementedError, match="CMYK.*not ported"):
        tds.imread(str(path))
    with pytest.raises(NotImplementedError, match="CMYK.*not ported"):
        tds.maskread(str(path))
    bmp = tmp_path / "x.png"
    Image.fromarray(_img(81)).save(bmp, format="BMP")
    with pytest.raises(NotImplementedError, match="not ported"):
        tds.imread(str(bmp))
    with pytest.raises(NotImplementedError, match="not ported"):
        tds.maskread(str(bmp))


@pytest.fixture
def jax_engine():
    """The JAX package's transform engine, loaded: without it the JAX Loader
    falls back to PIL for its train scale-crop. Another test process may be
    writing the library at first use, so a failed load is retried."""
    from segmentation_factory_tpu import native as jax_native

    for _ in range(30):
        if jax_native.available():
            return
        jax_native._build_error = None
        time.sleep(1.0)
    pytest.fail("the JAX package's transform engine does not load")


def _photo(seed, h, w):
    """(h, w, 3) uint8 with smooth fields, edges and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(xx / 5 + seed), 128 + 80 * np.cos(yy / 4), 3 * xx + yy], -1)
    img[(yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2] = rng.integers(0, 256, 3)
    return (np.clip(img + rng.normal(0, 10, img.shape), 0, 255) % 256).astype(np.uint8)


def _jpeg(path, arr, **opts):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path, format="JPEG", **opts)


# (height, width) and PIL save options: larger and smaller than the 48² eval
# canvas, 4:2:0 / 4:4:4 / progressive / restarts
JPEG_SHAPES = [((60, 80), {}), ((40, 52), {"subsampling": 0, "quality": 90}),
               ((72, 50), {"progressive": True}), ((48, 48), {"restart_marker_rows": 1}),
               ((35, 61), {"quality": 60})]


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    """JPEG trees of VOC (2012 lists, palette masks), ADE20K, COCO-Stuff
    (one greyscale image) and Kvasir-SEG (3-component JPEG masks)."""
    r = str(tmp_path_factory.mktemp("jpeg"))
    voc = f"{r}/voc/VOC2012"
    names = [f"2008_{i:06d}" for i in range(len(JPEG_SHAPES) + 1)]
    for k, n in enumerate(names):
        (h, w), opts = JPEG_SHAPES[k % len(JPEG_SHAPES)]
        _jpeg(f"{voc}/JPEGImages/{n}.jpg", _photo(k, h, w), **opts)
        lbl = _lbl(k, 21, h, w)
        lbl[:2] = 255
        _save(f"{voc}/SegmentationClass/{n}.png", lbl, mode="P")
    os.makedirs(f"{voc}/ImageSets/Segmentation")
    with open(f"{voc}/ImageSets/Segmentation/train.txt", "w") as f:
        f.write("\n".join(names[:4]) + "\n")
    with open(f"{voc}/ImageSets/Segmentation/val.txt", "w") as f:
        f.write("\n".join(names[3:]) + "\n")
    for sub, splits, hi in (("ade", ("training", "validation"), 151),
                            ("coco", ("train2017", "val2017"), 256)):
        for s, split in enumerate(splits):
            for k, ((h, w), opts) in enumerate(JPEG_SHAPES[s:s + 4]):
                img = _photo(20 + k, h, w)
                _jpeg(f"{r}/{sub}/images/{split}/im{k}.jpg",
                      img[..., 0] if sub == "coco" and k == 1 else img, **opts)
                _save(f"{r}/{sub}/annotations/{split}/im{k}.png", _lbl(20 + k, hi, h, w))
    for k in range(10):
        (h, w), opts = JPEG_SHAPES[k % len(JPEG_SHAPES)]
        _jpeg(f"{r}/kvasir/Kvasir-SEG/images/k{k}.jpg", _photo(40 + k, h, w), **opts)
        yy, xx = np.mgrid[0:h, 0:w]
        disc = (yy - h / 2) ** 2 + (xx - w / 2 - k) ** 2 < (h / 3) ** 2
        _jpeg(f"{r}/kvasir/Kvasir-SEG/masks/k{k}.jpg",
              np.repeat((disc * 255).astype(np.uint8)[..., None], 3, -1))
    return r


LOADER_TREES = {"voc": ("voc", "voc/VOC2012", {"year": "2012"}),
                "ade20k": ("ade20k", "ade", {}), "cocostuff": ("cocostuff", "coco", {}),
                "kvasir": ("kvasir", "kvasir", {}),
                "kvasir_preset": ("kvasir", "kvasir", {"preset_recipe": True})}


@pytest.mark.parametrize("tree", sorted(LOADER_TREES))
def test_loader_batches_equal_jax_on_jpeg_trees(jpeg_root, tree, jax_engine):
    """Two train epochs (the engine's scale-crop, or Kvasir's preset recipe)
    and the eval batches (images shrunk to the 48² canvas by PIL's bilinear
    and nearest, or padded) of the port's Loader against the JAX Loader's,
    on the same JPEG tree; the samples themselves against the JAX
    dataset's."""
    name, sub, kwargs = LOADER_TREES[tree]
    kw = dict(batch_size=2, crop=32, scale_range=(0.5, 2.0), seed=3, num_workers=2,
              eval_hw=(48, 48))
    for split, train in (("train", True), ("val", False)):
        port = tds.build_dataset(name, f"{jpeg_root}/{sub}", split, **kwargs)
        ref = jds.build_dataset(name, f"{jpeg_root}/{sub}", split, **kwargs)
        _same(port, ref)
        ours = Loader(port, train=train, **kw)
        theirs = JaxLoader(ref, train=train, shard_id=0, num_shards=1, **kw)
        for epoch in (0, 1) if train else (0,):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for key in ("image", "label"):
                    assert g[key].dtype == w[key].dtype
                    np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("seed", range(8))
def test_kvasir_train_augment_matches_jax(seed):
    """The short-side draw and PIL resizes, both flips and the padded crop,
    on an image whose short side the draw may take below or above the
    crop."""
    img = _photo(seed, 37, 53)
    lbl = (np.random.default_rng(seed).integers(0, 2, (37, 53))).astype(np.int32)
    got = kvasir_train_augment(img, lbl, np.random.default_rng(seed), (40, 40))
    want = jax_kvasir_augment(img, lbl, np.random.default_rng(seed), (40, 40))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
