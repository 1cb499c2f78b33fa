"""The port's file-backed dataset manifests against the JAX package's, on
trees the tests write: Cityscapes, VOC (its list variants), ADE20K,
COCO-Stuff, Kvasir + CVC-ClinicDB (its seeded split) and Synapse (the
``.npz`` train slices and the ``.npy.h5`` val volumes, written by h5py).

Images are PNG, also under ``.jpg`` names (PIL opens a file by its content,
and so does the port); a real JPEG raises "not ported" in the port. Pairs,
loaded images and labels, label encodings over all 256 values and volumes
are compared exactly.
"""

import os

import h5py
import numpy as np
import pytest
from PIL import Image

from segmentation_factory_tpu.data import datasets as jds
from segmentation_factory_tpu_torch.data import datasets as tds


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
    with pytest.raises(NotImplementedError, match="not ported"):
        tds.KvasirClinicDB(f"{root}/kvasir", split, preset_recipe=True)


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
    path = tmp_path / "photo.jpg"
    Image.fromarray(_img(80)).save(path, format="JPEG")
    with pytest.raises(NotImplementedError, match="JPEG decoding is not ported"):
        tds._imread(str(path))
    with pytest.raises(NotImplementedError, match="JPEG decoding is not ported"):
        tds._maskread(str(path))
    bmp = tmp_path / "x.png"
    Image.fromarray(_img(81)).save(bmp, format="BMP")
    with pytest.raises(NotImplementedError, match="not ported"):
        tds._imread(str(bmp))
