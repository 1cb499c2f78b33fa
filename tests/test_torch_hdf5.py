"""The port's HDF5 reader (``data/hdf5.py``) against h5py on the CPU: files
that h5py writes with its default settings read equal to h5py's arrays, in
the stored dtype and shape; what the reader does not take raises "not
ported". All exact.
"""

import h5py
import numpy as np
import pytest

from segmentation_factory_tpu_torch.data import hdf5


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(size=shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), shape,
                        endpoint=True).astype(dt)


# (dtype, shape, create_dataset options): contiguous, chunked + gzip, chunked
# + gzip + shuffle with partial edge chunks, 2-D and 3-D, both byte orders
CASES = {
    "f4_contiguous_3d": ("<f4", (4, 37, 41), {}),
    "f8_contiguous_2d": ("<f8", (23, 17), {}),
    "u1_contiguous_2d": ("u1", (31, 45), {}),
    "i2_contiguous_3d": ("<i2", (3, 20, 9), {}),
    "be_f4_contiguous": (">f4", (6, 11), {}),
    "be_i4_gzip": (">i4", (5, 33, 29), {"compression": "gzip", "chunks": (2, 16, 16)}),
    "f4_gzip_3d": ("<f4", (5, 40, 40), {"compression": "gzip"}),
    "u1_gzip_shuffle_edges": ("u1", (7, 50, 35), {"compression": "gzip", "shuffle": True,
                                                  "chunks": (3, 16, 16)}),
    "f8_gzip_shuffle_edges": ("<f8", (19, 23), {"compression": "gzip", "shuffle": True,
                                                "chunks": (8, 8)}),
    "i2_gzip9_shuffle": ("<i2", (6, 30, 31), {"compression": "gzip", "compression_opts": 9,
                                              "shuffle": True, "chunks": (4, 7, 5)}),
    "be_u2_shuffle_only": (">u2", (9, 14), {"shuffle": True, "chunks": (4, 4)}),
    "i8_chunked_raw": ("<i8", (10, 10), {"chunks": (3, 3)}),
}


@pytest.fixture(scope="module")
def h5file(tmp_path_factory):
    path = tmp_path_factory.mktemp("h5") / "all.h5"
    arrays = {name: _array(dt, shape, seed=i)
              for i, (name, (dt, shape, _)) in enumerate(CASES.items())}
    with h5py.File(path, "w") as f:
        for name, (_, _, opts) in CASES.items():
            f.create_dataset(name, data=arrays[name], **opts)
        grp = f.create_group("case/inner")
        grp.create_dataset("label", data=arrays["i2_contiguous_3d"], compression="gzip")
        f["case"].create_dataset("image", data=arrays["f4_contiguous_3d"])
    return str(path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_read_dataset_equals_h5py(h5file, name):
    got = hdf5.read_dataset(h5file, name)
    with h5py.File(h5file, "r") as f:
        want = np.asarray(f[name])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["case/image", "case/inner/label", "/case/inner/label"])
def test_paths_through_groups(h5file, name):
    with h5py.File(h5file, "r") as f:
        want = np.asarray(f[name])
    got = hdf5.read_dataset(h5file, name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError):
        hdf5.read_dataset(h5file, "case/missing")


def test_large_groups_and_synapse_layout(tmp_path):
    """A root group of 300 members (its B-tree more than one level deep)
    and a Synapse case file as the dataset's own files are laid out
    (``image`` float32, ``label`` float32 volumes)."""
    path = tmp_path / "many.h5"
    with h5py.File(path, "w") as f:
        for i in range(300):
            f[f"m{i:03d}"] = np.arange(i % 7 + 1, dtype=np.int32) * i
    for i in (0, 17, 149, 299):
        np.testing.assert_array_equal(hdf5.read_dataset(str(path), f"m{i:03d}"),
                                      np.arange(i % 7 + 1, dtype=np.int32) * i)
    vol = tmp_path / "case0001.npy.h5"
    img = _array("<f4", (6, 64, 64), seed=9)
    lbl = np.random.default_rng(9).integers(0, 9, (6, 64, 64)).astype(np.float32)
    with h5py.File(vol, "w") as f:
        f["image"], f["label"] = img, lbl
    np.testing.assert_array_equal(hdf5.read_dataset(str(vol), "image"), img)
    np.testing.assert_array_equal(hdf5.read_dataset(str(vol), "label"), lbl)


def _latest(path):
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.zeros((3, 3), np.float32)


def _lzf(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.zeros((8, 8), np.float32), compression="lzf")


def _fletcher32(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.zeros((8, 8), np.float32), fletcher32=True)


def _compound(path):
    with h5py.File(path, "w") as f:
        f["x"] = np.zeros(4, dtype=[("a", "<i4"), ("b", "<f4")])


def _compact(path):
    with h5py.File(path, "w") as f:
        space = h5py.h5s.create_simple((4,))
        plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        plist.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_INT32, space, plist)


@pytest.mark.parametrize("write", [_latest, _lzf, _fletcher32, _compound, _compact],
                         ids=["libver_latest", "lzf", "fletcher32", "compound", "compact"])
def test_unported_features_raise(write, tmp_path):
    path = tmp_path / "x.h5"
    write(path)
    with pytest.raises(NotImplementedError, match="not ported"):
        hdf5.read_dataset(str(path), "x")


def test_not_hdf5_raises(tmp_path):
    path = tmp_path / "x.h5"
    path.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.read_dataset(str(path), "x")
