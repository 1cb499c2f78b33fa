"""The port's ``predict.main``, ``infer.preprocess`` and
``SemSeg(ckpt_dir=...)`` on the CPU against the JAX package.

One MiT-B0 + SegFormerHead (4 classes, float32) on the same weights in both
packages (``_torch_cli.b0``). Tolerances: label maps equal except at pixels
whose top-2 JAX logit gap is under 1e-4, where reordered float32 sums may
flip the argmax. The preprocessed image equals the JAX one (the host
engine resizes as PIL's bilinear does), enlarged or shrunk.
``predict.main`` on a JPEG input reads it as PIL does.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from segmentation_factory_tpu import infer as jinfer
from segmentation_factory_tpu_torch import build_model, infer, predict
from segmentation_factory_tpu_torch.data.png import write_png

from _torch_cli import CPU, GAP, NC, SIZE, b0, float32_clis, save  # noqa: F401  (fixtures)
from _torch_port import two_torch_threads  # noqa: F401  (autouse)


def _jax_semseg(jmodel, variables):
    """A JAX ``SemSeg`` on the test's float32 model and weights, without
    its own initialisation (its palette: the same seeded draw)."""
    seg = jinfer.SemSeg.__new__(jinfer.SemSeg)
    seg.model, seg.variables, seg.num_classes, seg.img_size = jmodel, variables, NC, SIZE
    seg.palette = np.random.default_rng(0).integers(0, 255, (NC, 3)).astype(np.uint8)
    seg._forward = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    return seg


def test_predict_matches_jax_semseg(b0, tmp_path):
    ckpt, jmodel, variables = b0
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    img = np.stack([4 * xx, 4 * yy, 2 * (xx + yy)], -1) + np.random.default_rng(3).integers(
        0, 16, (SIZE, SIZE, 3))
    img = img.clip(0, 255).astype(np.uint8)
    src = tmp_path / "in.png"
    write_png(str(src), img)
    maps = predict.main(["--nb-classes", str(NC), "--ckpt", ckpt, "--input", str(src),
                         "--output", str(tmp_path / "out"), "--img-size", str(SIZE), *CPU])
    got = maps[str(src)]
    jseg = _jax_semseg(jmodel, variables)
    want, _ = jseg.predict(img)
    logits = np.asarray(jseg.forward(jinfer.preprocess(img, SIZE)[0]))
    top = np.sort(logits[0], axis=-1)
    ties = (top[..., -1] - top[..., -2]) < GAP
    assert got.shape == want.shape == (SIZE, SIZE) and got.dtype == np.int32
    assert ties.mean() < 1e-3
    np.testing.assert_array_equal(got[~ties], want[~ties])
    # the written overlay, decoded by PIL, is the port's overlay of its map
    palette = np.random.default_rng(0).integers(0, 255, (NC, 3)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out" / "in.png")),
                                  infer.overlay(img, infer.colorize(got, palette)))


def test_predict_jpeg_matches_jax_semseg(b0, tmp_path):
    """``predict.main`` on a progressive 4:2:0 JPEG larger than the image
    size (so ``preprocess`` shrinks it) against the JAX ``SemSeg`` on PIL's
    decode of the file, as the root ``predict.py`` reads it; the overlay is
    written as ``in.jpg.png`` (the port writes PNG only)."""
    ckpt, jmodel, variables = b0
    h, w = 90, 120
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([3 * xx, 4 * yy, 2 * (xx + yy)], -1) + np.random.default_rng(4).integers(
        0, 16, (h, w, 3))
    src = tmp_path / "in.jpg"
    Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(src, "JPEG", progressive=True)
    maps = predict.main(["--nb-classes", str(NC), "--ckpt", ckpt, "--input", str(src),
                         "--output", str(tmp_path / "out"), "--img-size", str(SIZE), *CPU])
    got = maps[str(src)]
    decoded = np.asarray(Image.open(src).convert("RGB"), np.uint8)
    jseg = _jax_semseg(jmodel, variables)
    want, _ = jseg.predict(decoded)
    # the labels are the argmax of the logits resized to the file's size
    logits = jinfer.resize(jseg.forward(jinfer.preprocess(decoded, SIZE)[0]), (h, w))
    top = np.sort(np.asarray(logits)[0], axis=-1)
    ties = (top[..., -1] - top[..., -2]) < GAP
    assert got.shape == want.shape == (h, w) and got.dtype == np.int32
    assert ties.mean() < 1e-3
    np.testing.assert_array_equal(got[~ties], want[~ties])
    palette = np.random.default_rng(0).integers(0, 255, (NC, 3)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out" / "in.jpg.png")),
                                  infer.overlay(decoded, infer.colorize(got, palette)))


def test_predict_directory_keeps_each_inputs_name(b0, tmp_path):
    """A JPEG and a PNG of one stem in one ``--input`` directory each get
    their own overlay (``a.jpg.png``, ``a.png``): neither overwrites the
    other."""
    ckpt, _, _ = b0
    rng = np.random.default_rng(5)
    src = tmp_path / "in"
    src.mkdir()
    Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), np.uint8)).save(src / "a.jpg")
    write_png(str(src / "a.png"), rng.integers(0, 255, (SIZE, SIZE, 3), np.uint8))
    maps = predict.main(["--nb-classes", str(NC), "--ckpt", ckpt, "--input", str(src),
                         "--output", str(tmp_path / "out"), "--img-size", str(SIZE), *CPU])
    assert sorted(os.listdir(tmp_path / "out")) == ["a.jpg.png", "a.png"]
    palette = np.random.default_rng(0).integers(0, 255, (NC, 3)).astype(np.uint8)
    for name in ("a.jpg", "a.png"):
        decoded = np.asarray(Image.open(src / name).convert("RGB"), np.uint8)
        overlay = infer.overlay(decoded, infer.colorize(maps[str(src / name)], palette))
        out = tmp_path / "out" / (name if name.endswith(".png") else name + ".png")
        np.testing.assert_array_equal(np.asarray(Image.open(out)), overlay)


@pytest.mark.parametrize("hw", [(50, 90), (33, 47), (97, 61), (64, 64), (150, 130)])
def test_preprocess_size_rule_and_values_match_jax(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3)).astype(np.uint8)
    got, orig = infer.preprocess(img, SIZE)
    want, jorig = jinfer.preprocess(img, SIZE)
    want = np.asarray(want)
    assert got.shape == want.shape and orig == jorig == hw
    assert got.dtype == np.float32
    # enlarged (the short side goes up to 64), shrunk (150 x 130 -> 96 x 64:
    # PIL's antialiased bilinear) or left as it is, the same float32 values
    np.testing.assert_array_equal(got, want)


def test_semseg_loads_the_best_then_the_latest_checkpoint(tmp_path):
    """The constructor's ``ckpt_dir`` loads the best step; ``load`` the
    latest where no mIoU was recorded, and raises without a checkpoint."""
    model = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu")
    states = [{k: v + 0.01 * i if v.is_floating_point() else v
               for k, v in model.state_dict().items()} for i in range(3)]
    for name, metrics in (("best", ({"mIoU": 50.0}, {"mIoU": 10.0})), ("latest", ({}, {}))):
        for step in (1, 2):
            model.load_state_dict(states[step])
            save(tmp_path / name, step, model, metrics[step - 1])
    seg = infer.SemSeg("mit_b0", "segformerhead", NC, img_size=SIZE, dtype=torch.float32,
                       device="cpu", ckpt_dir=str(tmp_path / "best"))
    got = seg.model.state_dict()
    assert all(torch.equal(got[k], states[1][k]) for k in got)
    seg.load(str(tmp_path / "latest"))
    got = seg.model.state_dict()
    assert all(torch.equal(got[k], states[2][k]) for k in got)
    (tmp_path / "empty").mkdir()
    for missing in ("empty", "absent"):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            seg.load(str(tmp_path / missing))
    assert not (tmp_path / "absent").exists()


