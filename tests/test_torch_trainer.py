"""The port's training entry point against the JAX package on the CPU:
configs, the synthetic dataset, the Loader, device-side augmentation, the
slide and multi-scale + flip eval protocols, ``Trainer.evaluate``,
checkpoints with resume, the CLI, and the refusal of a multi-device mesh
(the other options: ``test_torch_trainer_options.py``).

Tolerances: configs, datasets, Loader batches, labels and confusion
matrices are compared exactly. Augmented images within 1e-4 (float32; the
contrast's grey mean is a reordered sum over the image). Slide logits
within 1e-4 of their largest entry and multi-scale + flip probabilities
within 1e-5 (the same float32 model on converted weights, reordered sums).
A resumed run repeats the uninterrupted run's next step exactly: the same
process, the same CPU kernels, the same draws.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segmentation_factory_tpu import config as jconfig
from segmentation_factory_tpu import infer as jinfer
from segmentation_factory_tpu.convert import convert_full_model
from segmentation_factory_tpu.data import Loader as JaxLoader
from segmentation_factory_tpu.data import Synthetic as JaxSynthetic
from segmentation_factory_tpu.data import augment_batch as jax_augment_batch
from segmentation_factory_tpu.data import random_scale_crop as jax_random_scale_crop
from segmentation_factory_tpu.engine import loop as jloop
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu_torch import build_model, config
from segmentation_factory_tpu_torch import infer as tinfer
from segmentation_factory_tpu_torch.checkpoint import CheckpointManager
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.data.datasets import Synthetic, build_dataset
from segmentation_factory_tpu_torch.data.pipeline import Loader, prefetch_to_device
from segmentation_factory_tpu_torch.data.transforms import (
    augment_batch,
    draw_augment,
    random_scale_crop,
)
from segmentation_factory_tpu_torch.engine import create_optimizer
from segmentation_factory_tpu_torch.engine import loop as tloop
from segmentation_factory_tpu_torch.schedule import create_schedule

from _torch_port import load_numpy, random_state_dict

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


def _b0_pair(nc, seed):
    port = build_model("mit_b0", "segformerhead", nc, dtype=torch.float32, device="cpu")
    sd = random_state_dict(port, seed=seed)
    load_numpy(port, sd)
    jmodel = jax_build_model("mit_b0", "segformerhead", nc, dtype=jnp.float32)
    return port, jmodel, convert_full_model(sd, "mit_b0", "segformerhead")


def test_slide_and_ms_flip_match_jax(monkeypatch):
    """MiT-B0 at 64², crop 32 (3 x 3 windows): slide logits and the
    multi-scale + flip probabilities, scales 0.5 (one forward) and 1.0
    (slid). The JAX window loop runs eagerly (``_slide_impl``) around one
    jitted forward."""
    nc = 4
    port, jmodel, variables = _b0_pair(nc, seed=50)
    img = np.random.default_rng(51).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jfwd = jax.jit(lambda x: jmodel.apply(variables, x, train=False))
    monkeypatch.setattr(jinfer, "slide_inference", jinfer._slide_impl)
    want_slide = np.asarray(jinfer._slide_impl(jfwd, jnp.asarray(img), nc, 32))
    want_ms = np.asarray(jinfer.multi_scale_flip_inference(jfwd, jnp.asarray(img), nc,
                                                           scales=(0.5, 1.0), crop=32))
    x = torch.from_numpy(img)
    with torch.inference_mode():
        got_slide = tinfer.slide_inference(port, x, nc, 32).numpy()
        got_ms = tinfer.multi_scale_flip_inference(port, x, nc, scales=(0.5, 1.0), crop=32)
    assert got_slide.shape == want_slide.shape == (1, 64, 64, nc)
    np.testing.assert_allclose(got_slide, want_slide, rtol=0,
                               atol=1e-4 * np.abs(want_slide).max())
    np.testing.assert_allclose(got_ms.numpy(), want_ms, rtol=0, atol=1e-5)


def _tiny_cfg(cls, out, epochs=1, **data):
    return cls.TrainConfig(
        model=cls.ModelConfig(backbone="mit_b0", head="segformerhead", num_classes=4,
                              compute_dtype="float32"),
        data=cls.DataConfig(dataset="synthetic", img_size=32, batch_size=8, val_batch_size=8,
                            num_workers=2, **data),
        optim=cls.OptimConfig(lr=3e-3, epochs=epochs, warmup_steps=2),
        output_dir=str(out), print_freq=1)


def _datasets(cls):
    return cls(num_classes=4, size=32, length=16, seed=0), cls(num_classes=4, size=32, length=8,
                                                               seed=9)


def test_trainer_evaluate_same_confusion_matrix_as_jax(tmp_path, monkeypatch):
    """The port's Trainer loaded with the JAX Trainer's initial weights:
    the whole-image eval's confusion matrix, pixel for pixel."""
    hists = {}

    def capture(module, key):
        real = module.compute_metrics

        def metrics(h):
            hists[key] = np.asarray(h)
            return real(h)

        monkeypatch.setattr(module, "compute_metrics", metrics)

    capture(jloop, "jax")
    capture(tloop, "port")
    jt = jloop.Trainer(_tiny_cfg(jconfig, tmp_path / "jax"), *_datasets(JaxSynthetic))
    want = jt.evaluate()
    jt.ckpt.close()
    tt = tloop.Trainer(_tiny_cfg(config, tmp_path / "port"), *_datasets(Synthetic), device="cpu")
    tt.model.load_state_dict(from_jax_variables(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    got = tt.evaluate()
    assert hists["port"].sum() == 8 * 32 * 32
    np.testing.assert_array_equal(hists["port"], hists["jax"])
    assert got["mIoU"] == pytest.approx(want["mIoU"], abs=1e-9)


def test_fit_then_resume_repeats_the_next_step(tmp_path):
    """One epoch (2 steps) of ``fit`` saves a checkpoint; a second Trainer
    on the same output directory resumes at step 2 with the same parameters
    and optimizer state, and its next step equals the first Trainer's."""
    cfg = _tiny_cfg(config, tmp_path)
    a = tloop.Trainer(cfg, *_datasets(Synthetic), device="cpu")
    best = a.fit(1)
    assert a.step == 2 and a.ckpt.latest_step() == 2 == a.ckpt.best_step()
    lines = [json.loads(s) for s in open(a.results_path)]
    assert len(lines) == 1 and math.isfinite(lines[0]["train_loss"])
    assert (tmp_path / "model.txt").exists() and (tmp_path / "logs" / "scalars.jsonl").exists()

    b = tloop.Trainer(cfg, *_datasets(Synthetic), device="cpu")
    assert b.step == 2 and b.best == best
    sd_a, sd_b = a.model.state_dict(), b.model.state_dict()
    for k in sd_a:
        torch.testing.assert_close(sd_b[k], sd_a[k], rtol=0, atol=0)
    for k in ("mu", "nu", "count"):
        torch.testing.assert_close(getattr(b.optimizer, k), getattr(a.optimizer, k), rtol=0,
                                   atol=0)

    a.train_loader.set_epoch(1)
    batch = next(iter(a.train_loader))
    ma, mb = a.train_step(batch), b.train_step(batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        torch.testing.assert_close(pb, pa, rtol=0, atol=0, msg=name)
    assert b.fit(1) == best  # nothing left to train: the run is complete


def test_checkpoint_manager_keeps_the_best_two(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = create_optimizer("adamw", create_schedule("cosine", 1e-3, total_steps=10),
                           params=model.named_parameters())
    mngr = CheckpointManager(str(tmp_path))
    assert mngr.latest_step() is None and mngr.restore(model) == (None, {})
    for step, miou in ((1, 5.0), (2, 9.0), (3, 7.0), (4, 7.0)):
        with torch.no_grad():
            model.weight.fill_(step)
        mngr.save(step, model, opt, {"mIoU": miou})
    assert mngr.steps() == [2, 4] and mngr.best_step() == 2 and mngr.latest_step() == 4
    assert mngr.restore(model, opt, step=2) == (2, {"mIoU": 9.0})
    assert float(model.weight[0, 0].detach()) == 2.0
    other = torch.nn.Linear(3, 2)
    opt2 = create_optimizer("adamw", create_schedule("cosine", 1e-3, total_steps=10),
                            params=[("w", other.weight), ("b", other.bias)])
    with pytest.raises(ValueError, match="other parameters"):
        opt2.load_state_dict(opt.state_dict())


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["mesh", "mesh_tp"])
def test_trainer_refuses_unported_options(tmp_path, mesh):
    """A mesh of more than one device (data or tensor parallel) is the one
    option the port does not run; one device, ``(1, 1)``, runs."""
    cfg = _tiny_cfg(config, tmp_path)
    cfg.mesh_shape = mesh
    with pytest.raises(NotImplementedError, match="not ported"):
        tloop.Trainer(cfg, *_datasets(Synthetic), device="cpu")


def test_cli_trains_on_the_cpu(tmp_path):
    """``python -m segmentation_factory_tpu_torch.train`` on the synthetic
    set (64 images of 512², cropped to 32²): one epoch of 8 steps, an eval,
    a checkpoint; then ``--eval`` resumes it."""
    out = tmp_path / "run"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    args = [sys.executable, "-m", "segmentation_factory_tpu_torch.train", "--dataset",
            "synthetic", "--backbone", "mit_b0", "--img-size", "32", "--batch-size", "8",
            "--epochs", "1", "--warmup-steps", "1", "--workers", "2", "--print-freq", "4",
            "--output-dir", str(out), "--device", "cpu"]
    res = subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    (line,) = [json.loads(s) for s in open(out / "results.jsonl")]
    assert line["steps"] == 8 and math.isfinite(line["train_loss"]) and 0 <= line["mIoU"] <= 100
    assert sorted(os.listdir(out / "ckpt")) == ["step_8.pt"]
    assert json.loads((out / "config.json").read_text())["data"]["img_size"] == 32
    res = subprocess.run(args + ["--eval"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "resumed from step 8" in res.stdout
