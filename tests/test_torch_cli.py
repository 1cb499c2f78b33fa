"""The port's ``validate.main`` on the CPU against the JAX package: whole,
slide and multi-scale + flip confusion matrices, ``--dataset synapse``
against ``evaluate_volumes``, and ``--export-artifact``'s refusal of other
resolutions (prediction: ``test_torch_cli_predict.py``; export and
refusals: ``test_torch_cli_export.py``).

One MiT-B0 + SegFormerHead (4 classes, float32) on the same weights in both
packages (``_torch_cli.b0``); the port reads them from a checkpoint
directory of its own format. The synthetic val set is 4 images at the
canvas size (64²), so neither Loader resizes (the JAX one would shrink with
PIL).

Tolerances: confusion matrices equal except at pixels whose top-2 JAX
logit gap is under 1e-4 (probability gap under 1e-5 for ms_flip, whose
probabilities agree within 1e-5), where reordered float32 sums may flip
the argmax; each flip moves one count between two cells.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import infer as jinfer
from segmentation_factory_tpu import metrics as jmetrics
from segmentation_factory_tpu.data import Loader as JaxLoader
from segmentation_factory_tpu.data import Synthetic as JaxSynthetic
from segmentation_factory_tpu.data import preprocess_eval as jax_preprocess_eval
from segmentation_factory_tpu_torch import infer, validate
from segmentation_factory_tpu_torch.data import datasets

from _torch_cli import CPU, GAP, NC, PROB_GAP, SIZE, b0, float32_clis  # noqa: F401  (fixtures)
from _torch_port import two_torch_threads  # noqa: F401  (autouse)


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
