"""The port's ``export_model.main`` on the CPU, on MiT-B0 and on a ConvNeXt
+ UPerHead checkpoint (with ``predict.main``), and the refusals of what is
not ported (a SavedModel, a CMYK JPEG).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from segmentation_factory_tpu_torch import build_model, export_model, infer, predict
from segmentation_factory_tpu_torch.data.png import write_png
from segmentation_factory_tpu_torch.export import load_exported

from _torch_cli import CPU, NC, b0, float32_clis, save  # noqa: F401  (fixtures)
from _torch_port import load_numpy, random_state_dict, two_torch_threads  # noqa: F401


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
    save(tmp_path / "ckpt", 1, port, {"mIoU": 1.0})
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


