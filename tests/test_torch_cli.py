"""The port's serving entry points on the CPU against the JAX package:
``validate.main`` (whole, slide and multi-scale + flip), ``predict.main``,
``infer.preprocess``, ``SemSeg(ckpt_dir=...)``, ``export_model.main`` and
the refusals of what is not ported; ``predict.main`` and
``export_model.main`` on a ConvNeXt + UPerHead checkpoint too.

One MiT-B0 + SegFormerHead (4 classes, float32) on the same weights in both
packages; the port reads them from a checkpoint directory of its own
format. The synthetic val set is 4 images at the canvas size (64²), so
neither Loader resizes (the JAX one would shrink with PIL).

Tolerances: confusion matrices and label maps equal except at pixels whose
top-2 JAX logit gap is under 1e-4 (probability gap under 1e-5 for ms_flip,
whose probabilities agree within 1e-5), where reordered float32 sums may
flip the argmax; each flip moves one count between two cells. The
preprocessed image equals the JAX one (the host engine resizes as PIL's
bilinear does), enlarged or shrunk. ``predict.main`` on a JPEG input
reads it as PIL does.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segmentation_factory_tpu import infer as jinfer
from segmentation_factory_tpu import metrics as jmetrics
from segmentation_factory_tpu.convert import convert_full_model
from segmentation_factory_tpu.data import Loader as JaxLoader
from segmentation_factory_tpu.data import Synthetic as JaxSynthetic
from segmentation_factory_tpu.data import preprocess_eval as jax_preprocess_eval
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu_torch import build_model, export_model, infer, predict, validate
from segmentation_factory_tpu_torch.checkpoint import CheckpointManager
from segmentation_factory_tpu_torch.data import datasets
from segmentation_factory_tpu_torch.data.png import write_png
from segmentation_factory_tpu_torch.export import load_exported

from _torch_port import load_numpy, random_state_dict

NC, SIZE, GAP, PROB_GAP = 4, 64, 1e-4, 1e-5
NO_OPTIMIZER = types.SimpleNamespace(state_dict=dict)
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def float32_clis(monkeypatch):
    """The CLIs compute in bfloat16, as the pinned configs do; the JAX side
    of these comparisons is float32."""
    for cli in (validate, predict, export_model):
        monkeypatch.setattr(cli, "DTYPE", torch.float32)


def _save(directory, step, model, metrics):
    CheckpointManager(str(directory)).save(step, model, NO_OPTIMIZER, metrics)


@pytest.fixture(scope="module")
def b0(tmp_path_factory):
    """(checkpoint directory of the port's weights, JAX model, JAX
    variables) on the same weights."""
    port = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu")
    sd = random_state_dict(port, seed=21)
    load_numpy(port, sd)
    ckpt = tmp_path_factory.mktemp("ckpt")
    _save(ckpt, 3, port, {"mIoU": 1.0})
    jmodel = jax_build_model("mit_b0", "segformerhead", NC, dtype=jnp.float32)
    return str(ckpt), jmodel, convert_full_model(sd, "mit_b0", "segformerhead")


def _hist_within_ties(got, want, ties):
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64)).sum()
    assert diff <= 2 * ties, (diff, ties)


PROTOCOLS = {"whole": [], "slide": ["--slide", "--crop", "32"], "ms_flip": ["--tta"]}


@pytest.mark.parametrize("protocol", sorted(PROTOCOLS))
def test_validate_matches_jax(b0, protocol, monkeypatch):
    """The confusion matrix of ``validate.main`` against the JAX
    composition of the root ``validate.py`` (its Loader's batches, its
    forward, ``update_confusion_matrix``); ms_flip at scales 0.75 and 1.0
    on both sides (each JAX scale is a compile)."""
    ckpt, jmodel, variables = b0
    scales = (0.75, 1.0)
    monkeypatch.setitem(datasets.DATASETS, "synthetic",
                        (functools.partial(datasets.Synthetic, size=SIZE, length=4, seed=1), 8))
    monkeypatch.setattr(infer, "multi_scale_flip_inference",
                        functools.partial(infer.multi_scale_flip_inference, scales=scales))
    m = validate.main(["--dataset", "synthetic", "--nb-classes", str(NC), "--img-size", str(SIZE),
                       "--batch-size", "2", "--ckpt", ckpt, "--workers", "2", *CPU,
                       *PROTOCOLS[protocol]])

    jfwd = jax.jit(lambda x: jmodel.apply(variables, x, train=False))
    loader = JaxLoader(JaxSynthetic(NC, size=SIZE, length=4, seed=1), 2, SIZE, train=False,
                       eval_hw=(SIZE, SIZE), num_workers=2, shard_id=0, num_shards=1)
    hist = jnp.zeros((NC, NC), jnp.uint32)
    ties = 0
    for batch in loader:
        x = jax_preprocess_eval(jnp.asarray(batch["image"]))
        if protocol == "ms_flip":
            out = jinfer.multi_scale_flip_inference(jfwd, x, NC, scales=scales)
        elif protocol == "slide":
            out = jinfer._slide_impl(jfwd, x, NC, 32)
        else:
            out = jfwd(x)
        hist = jmetrics.update_confusion_matrix(hist, out, jnp.asarray(batch["label"]))
        top = np.sort(np.asarray(out), axis=-1)
        gap = PROB_GAP if protocol == "ms_flip" else GAP
        ties += int(((top[..., -1] - top[..., -2]) < gap).sum())
    assert ties < 1e-3 * 4 * SIZE * SIZE
    assert m["hist"].sum() == 4 * SIZE * SIZE
    _hist_within_ties(m["hist"], np.asarray(hist), ties)
    if not ties:
        np.testing.assert_array_equal(m["hist"], np.asarray(hist))


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
            _save(tmp_path / name, step, model, metrics[step - 1])
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


def test_export_model_main_writes_a_loadable_program(b0, tmp_path, capsys):
    """Its check loads the written program and holds it against the live
    model (``export.validate_export``)."""
    out = tmp_path / "m.pt2"
    assert export_model.main(["--nb-classes", str(NC), "--img-size", "32", "--ckpt", b0[0],
                              "--out", str(out), *CPU]) == 0
    assert out.is_file() and "parity check: OK" in capsys.readouterr().out


def test_convnext_uperhead_checkpoint_predicts_and_exports(tmp_path):
    """Config #2's family through the CLIs: ``predict.main`` and
    ``export_model.main`` on a ConvNeXt-T + UPerHead checkpoint (5 classes,
    32²). The program holds no ``sft::`` op (no forward kernel of the port
    is on this family's eval forward) and, reloaded, gives the live model's
    logits at a batch of 2 within 1e-5 of their largest; the predicted map
    is the live logits' argmax."""
    nc, size = 5, 32
    port = build_model("convnext_tiny", "uperhead", nc, dtype=torch.float32, device="cpu")
    load_numpy(port, random_state_dict(port, seed=23))
    _save(tmp_path / "ckpt", 1, port, {"mIoU": 1.0})
    args = ["--backbone", "convnext_tiny", "--head", "uperhead", "--nb-classes", str(nc),
            "--ckpt", str(tmp_path / "ckpt"), "--img-size", str(size), *CPU]
    img = np.random.default_rng(24).integers(0, 256, (size, size, 3)).astype(np.uint8)
    src = tmp_path / "in.png"
    write_png(str(src), img)
    maps = predict.main([*args, "--input", str(src), "--output", str(tmp_path / "out")])
    out = tmp_path / "m.pt2"
    assert export_model.main([*args, "--out", str(out), "--skip-validate"]) == 0
    program = load_exported(str(out))
    assert not any("sft" in str(n.target) for n in program.graph.nodes)
    x = torch.from_numpy(np.random.default_rng(25).normal(size=(2, size, size, 3)).astype(
        np.float32))
    x[0] = torch.from_numpy(infer.preprocess(img, size)[0][0])
    with torch.inference_mode():
        live = port.eval()(x)
        got = program.module()(x)
    np.testing.assert_allclose(got.numpy(), live.numpy(), rtol=0,
                               atol=1e-5 * float(live.abs().max()))
    np.testing.assert_array_equal(maps[str(src)], live[0].argmax(-1).numpy())


def _jpeg(tmp_path):
    """A CMYK JPEG: the decoder's refusal."""
    path = tmp_path / "in.jpg"
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).convert("CMYK").save(path, "JPEG")
    return str(path)


REFUSALS = {
    "savedmodel": lambda tmp: export_model.main(["--nb-classes", str(NC), "--format",
                                                 "savedmodel", *CPU]),
    "jpeg": lambda tmp: predict.main(["--nb-classes", str(NC), "--input", _jpeg(tmp),
                                      "--output", str(tmp / "out"), "--img-size", "32", *CPU]),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_unported_paths_raise(what, tmp_path):
    with pytest.raises(NotImplementedError, match="not ported"):
        REFUSALS[what](tmp_path)


def test_validate_synapse_prints_evaluate_volumes(b0, tmp_path, capsys):
    """``validate --dataset synapse`` on a tree of two h5py-written cases
    (64² slices, a 32² crop: the slide runs) prints ``evaluate_volumes``'
    result for the same model, without the per-case entries."""
    import h5py

    ckpt, _, _ = b0
    rng = np.random.default_rng(26)
    (tmp_path / "lists").mkdir()
    (tmp_path / "test_vol_h5").mkdir()
    for name, d in (("case0001", 3), ("case0002", 2)):
        with h5py.File(tmp_path / "test_vol_h5" / f"{name}.npy.h5", "w") as f:
            f["image"] = rng.uniform(0, 1, (d, SIZE, SIZE)).astype(np.float32)
            f["label"] = rng.integers(0, NC, (d, SIZE, SIZE)).astype(np.float32)
    (tmp_path / "lists" / "test_vol.txt").write_text("case0001\ncase0002\n")
    m = validate.main(["--dataset", "synapse", "--data-root", str(tmp_path), "--nb-classes",
                       str(NC), "--img-size", "32", "--ckpt", ckpt, *CPU])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    seg = infer.SemSeg("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu",
                       ckpt_dir=ckpt)
    want = infer.evaluate_volumes(seg.forward, datasets.SynapseCT(str(tmp_path), "val").volumes(),
                                  NC, crop=32, device="cpu")
    assert m == want and len(want["per_case"]) == 2
    assert printed == str({k: v for k, v in want.items() if k != "per_case"})


@pytest.mark.parametrize("flag", [["--tta"], ["--slide"], ["--dataset", "synapse"]])
def test_export_artifact_refuses_other_resolutions(flag):
    """As the JAX CLI: the program serves one spatial size."""
    with pytest.raises(SystemExit, match="fixed-spatial-shape"):
        validate.main(["--export-artifact", "unused.pt2", *flag, *CPU])
