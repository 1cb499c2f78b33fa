"""The port's eval protocols and ``Trainer.evaluate`` against the JAX
package on the CPU: slide logits and multi-scale + flip probabilities of
MiT-B0, and the whole-image eval's confusion matrix of the port's Trainer
loaded with the JAX Trainer's initial weights.

Tolerances: confusion matrices exactly. Slide logits within 1e-4 of their
largest entry and multi-scale + flip probabilities within 1e-5 (the same
float32 model on converted weights, reordered sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import config as jconfig
from segmentation_factory_tpu import infer as jinfer
from segmentation_factory_tpu.convert import convert_full_model
from segmentation_factory_tpu.data import Synthetic as JaxSynthetic
from segmentation_factory_tpu.engine import loop as jloop
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu_torch import build_model, config
from segmentation_factory_tpu_torch import infer as tinfer
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.data.datasets import Synthetic
from segmentation_factory_tpu_torch.engine import loop as tloop

from _torch_port import load_numpy, random_state_dict, two_torch_threads  # noqa: F401
from _torch_trainer import tiny_cfg, tiny_datasets


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
    jt = jloop.Trainer(tiny_cfg(jconfig, tmp_path / "jax"), *tiny_datasets(JaxSynthetic))
    want = jt.evaluate()
    jt.ckpt.close()
    tt = tloop.Trainer(tiny_cfg(config, tmp_path / "port"), *tiny_datasets(Synthetic),
                       device="cpu")
    tt.model.load_state_dict(from_jax_variables(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    got = tt.evaluate()
    assert hists["port"].sum() == 8 * 32 * 32
    np.testing.assert_array_equal(hists["port"], hists["jax"])
    assert got["mIoU"] == pytest.approx(want["mIoU"], abs=1e-9)
