"""The committed file fixtures (``tests/torch_fixtures/``, written by
``tools/torch_fixtures.py``) and their manifest.

``chip_smoke.py`` phase ``files`` holds the port's decoders on the card's
host to the manifest's hashes, where there is no PIL and no h5py. Here the
manifest is held against PIL's and h5py's own reads of the committed files,
so those hashes are PIL's and h5py's truth, and the port's reads against
the same hashes (tolerance 0).
"""

import hashlib
import json
from pathlib import Path

import h5py
import numpy as np
import pytest
from PIL import Image

from segmentation_factory_tpu_torch.data import hdf5, jpeg, native

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
JPEGS = {e["file"]: e for e in MANIFEST["jpeg"]}
SHRINKS = {e["file"]: e for e in MANIFEST["bilinear"]}


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_fixtures_are_small_and_listed():
    files = {p.name for p in FIXTURES.iterdir()}
    listed = set(JPEGS) | {e["file"] for e in MANIFEST["hdf5"]} | {"manifest.json"}
    assert files == listed
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1 << 20
    assert set(SHRINKS) <= set(JPEGS)


@pytest.mark.parametrize("name", sorted(JPEGS))
def test_jpeg_manifest_is_pil_and_the_port(name):
    entry, path = JPEGS[name], str(FIXTURES / name)
    with Image.open(path) as im:
        assert im.mode == entry["mode"]
        want = np.asarray(im)
    assert list(want.shape) == entry["shape"] and _sha(want) == entry["sha256"]
    got = jpeg.read_jpeg(path)
    assert got.shape == want.shape and _sha(got) == entry["sha256"]


@pytest.mark.parametrize("name", sorted(SHRINKS))
def test_bilinear_shrink_manifest_is_pil_and_the_port(name):
    entry, path = SHRINKS[name], str(FIXTURES / name)
    h, w = entry["size"]
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB").resize((w, h), Image.BILINEAR))
    assert _sha(want) == entry["sha256"]
    assert _sha(native.resize_image(jpeg.read_rgb(path), (h, w))) == entry["sha256"]


def test_hdf5_manifest_is_h5py_and_the_port():
    for entry in MANIFEST["hdf5"]:
        path = str(FIXTURES / entry["file"])
        with h5py.File(path, "r") as f:
            for key, want in entry["datasets"].items():
                a = f[key][()]
                assert str(a.dtype) == want["dtype"] and list(a.shape) == want["shape"]
                assert _sha(a) == want["sha256"]
                got = hdf5.read_dataset(path, key)
                assert got.dtype == a.dtype and _sha(got) == want["sha256"]
