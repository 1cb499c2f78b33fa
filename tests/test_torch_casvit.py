"""CAS-ViT (RCViT) against the JAX package, on the CPU.

Weights are numpy, drawn for the port's reference-layout ``state_dict``
(``_torch_port.random_state_dict``) and carried to the JAX tree by the JAX
package's ``convert_casvit`` (and ``convert_fpnhead``). In training the
port takes the JAX drop-path factors: ``DropPath`` is wrapped to record
each call's factor (``recorded_drop_path``). The BatchNorms that the JAX
package creates as bare flax ``nn.BatchNorm``s keep flax's momentum 0.99,
those inside ConvModules 0.9. Tolerances: float32 outputs within 1e-4 of
the JAX output's largest magnitude, gradients within 1e-3 of each
parameter's largest JAX entry plus 1e-6 of the model's largest, BatchNorm
running statistics within 1e-4 of each tensor's largest entry.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import convert as JCV
from segmentation_factory_tpu.models import build as jbuild
from segmentation_factory_tpu.models.backbones import casvit as JCAS
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu.registry import BACKBONES as J_BACKBONES
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.models.backbones import casvit as C
from segmentation_factory_tpu_torch.models.build import SegmentationModel
from segmentation_factory_tpu_torch.models.layers import drop_path_rates
from segmentation_factory_tpu_torch.registry import BACKBONES

from _torch_port import (
    jax_vjp,
    jit_apply,
    load_numpy,
    random_state_dict,
    rel_close,
    strip,
    torch_vjp,
    trees_close,
)
from _torch_port import two_torch_threads  # noqa: F401  (autouse)

E, NC = 32, 5
GRAD_FLOOR = 1e-6
RATE = 0.2  # the drop-path rate of the training tests


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _stats_close(got_tree, want_tree):
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got_tree):
        ref = np.asarray(want[path])
        np.testing.assert_allclose(np.asarray(leaf), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture
def recorded_drop_path(monkeypatch):
    """Every active ``DropPath`` call appends its (B,) float32 factor
    (1 / keep or 0) to the returned list; the call draws and applies its
    mask as the original does."""
    factors = []

    def call(self, x, deterministic=True):
        if self.rate == 0.0 or deterministic:
            return x
        keep = 1.0 - self.rate
        rng = self.make_rng("droppath")
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = jax.random.bernoulli(rng, keep, shape)
        factors.append(jnp.where(mask, 1.0 / keep, 0.0).reshape(-1).astype(jnp.float32))
        return jnp.where(mask, x / keep, jnp.zeros_like(x)).astype(x.dtype)

    monkeypatch.setattr(JC.DropPath, "__call__", call)
    return factors


def _jax_model(sd, layers):
    bb = JCV.convert_casvit(strip(sd, "backbone."), layers)
    hp, hs = JCV.convert_fpnhead(strip(sd, "decode_head."), num_levels=4)
    return {"params": {"backbone": bb["params"], "decode_head": hp},
            "batch_stats": {"backbone": bb["batch_stats"], "decode_head": hs}}


# ---------------------------------------------------------------- modules


def _block_tree(sd, prefix):
    """One AdditiveBlock's JAX (params, batch_stats): ``convert_casvit``'s
    ``block0_0`` of a one-block tree holding only its keys."""
    layers = [1, 0, 0, 0]
    full = {**{k.replace(prefix, "network.0.0."): v for k, v in sd.items()},
            **_stub_rest(sd)}
    out = JCV.convert_casvit(full, layers)
    return out["params"]["block0_0"], out["batch_stats"]["block0_0"]


def _stub_rest(sd):
    """Zero stems, downsamples and output norms (``convert_casvit`` reads
    them; the block test uses only ``block0_0``)."""
    c = next(v for k, v in sd.items() if k.endswith("norm1.weight")).shape[0]
    out = {}
    for conv, bn, cin, cout in (("patch_embed.0", "patch_embed.1", 3, 1),
                                ("patch_embed.3", "patch_embed.4", 1, c)):
        out[f"{conv}.weight"] = np.zeros((cout, cin, 3, 3), np.float32)
        out.update(_bn_keys(bn, cout))
    for i in (0, 2, 4, 6):
        out.update(_bn_keys(f"norm{i}", c))
    for i in (1, 3, 5):
        out[f"network.{i}.proj.weight"] = np.zeros((c, c, 3, 3), np.float32)
        out.update(_bn_keys(f"network.{i}.norm", c))
    return out


def _bn_keys(prefix, c):
    return {f"{prefix}.{k}": np.ones((c,), np.float32) for k in
            ("weight", "bias", "running_mean", "running_var")}


@pytest.mark.parametrize("train", [False, True])
def test_additive_block_matches_jax(recorded_drop_path, train):
    """One AdditiveBlock (48 channels, drop path 0.2 in training): its
    output and the gradients of a random projection of it; in training the
    JAX drop-path factors and every BatchNorm's running statistics after the
    step (the local, ``norm1`` and ``norm2`` ones at momentum 0.99, the
    spatial gates' at 0.9)."""
    c = 48
    port = C.AdditiveBlock(c, drop_path_rate=RATE, dtype=torch.float32).train(train)
    sd = {f"blk.{k}": v for k, v in random_state_dict(port, seed=1).items()}
    load_numpy(port, strip(sd, "blk."))
    params, stats = _block_tree(sd, "blk.")
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, 7, 6, c))
    cts = [_normal(rng, (2, 7, 6, c))]
    kw = (dict(train=True, mutable=["batch_stats"], rngs={"droppath": jax.random.PRNGKey(3)})
          if train else dict(train=False))
    out, gp, gx, extra = jax_vjp(JCAS.AdditiveBlock(drop_path=RATE, dtype=jnp.float32),
                                 {"params": params, "batch_stats": stats}, x, cts,
                                 record=recorded_drop_path, **kw)
    factors = (torch.stack([torch.from_numpy(np.array(f)) for f in extra["record"]])
               if train else None)
    assert len(extra["record"]) == (2 if train else 0)
    got, got_gp, got_gx = torch_vjp(port, x, cts, factors)
    rel_close(got[0], out)
    rel_close(got_gx, gx, 1e-3)
    back = _block_tree({**sd, **{f"blk.{k}": v for k, v in got_gp.items()}}, "blk.")[0]
    trees_close(back, gp, of_largest=GRAD_FLOOR)
    if train:
        new = {f"blk.{k}": v.numpy() for k, v in port.state_dict().items() if "running" in k}
        _stats_close(_block_tree({**sd, **new}, "blk.")[1], extra["state"]["batch_stats"])
        assert port.norm1.momentum == 0.01 and port.attn.oper_q[0].block._modules["1"].momentum == 0.1


# ---------------------------------------------------------------- the model


def _port_model(train, rate):
    port = SegmentationModel("rcvit_xs", "fpnhead", NC, embed_dim=E,
                             dtype=torch.float32).train(train)
    rates = [r for stage in drop_path_rates(rate, C.CASVIT_SETTINGS["xs"][0]) for r in stage]
    for blk, r in zip(port.backbone.blocks(), rates):
        blk.drop_path_rate = r
    return port


@pytest.mark.parametrize("train", [False, True])
def test_rcvit_fpnhead_matches_jax(monkeypatch, recorded_drop_path, train):
    """``rcvit_xs`` + ``fpnhead`` (E = 32, 5 classes) at 64²: the stride-4
    logits; in training with drop path 0.2 (its factors the JAX ones, fed
    through ``noise``; the head's dropout off on both sides), the gradients
    of a random projection of them with respect to every parameter and the
    image, and every BatchNorm's running statistics after the step."""
    layers = C.CASVIT_SETTINGS["xs"][0]
    port = _port_model(train, RATE)
    sd = random_state_dict(port, seed=4)
    load_numpy(port, sd)
    variables = _jax_model(sd, layers)
    rng = np.random.default_rng(5)
    x = _normal(rng, (2, 64, 64, 3))
    jm = jbuild.SegmentationModel("rcvit_xs", "fpnhead", NC, embed_dim=E, dtype=jnp.float32,
                                  backbone_kwargs={"drop_path_rate": RATE})
    if not train:
        want = jit_apply(jm, variables, jnp.asarray(x), train=False, resize_output=False)
        with torch.no_grad():
            got = port(torch.from_numpy(x), resize_output=False)
        assert got.shape == (2, 16, 16, NC)
        rel_close(got.numpy(), want)
        return
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    cts = [_normal(rng, (2, 16, 16, NC))]
    out, gp, gx, extra = jax_vjp(jm, variables, x, cts, record=recorded_drop_path,
                                 resize_output=False, train=True, mutable=["batch_stats"],
                                 rngs={"droppath": jax.random.PRNGKey(6)})
    # one factor a branch of each block with a rate above 0 (all but the first)
    it = iter(extra["record"])
    factors = torch.stack([
        torch.stack([torch.from_numpy(np.array(next(it))) for _ in range(2)])
        if blk.drop_path_rate > 0 else torch.ones((2, 2)) for blk in port.backbone.blocks()])
    assert next(it, None) is None and len(extra["record"]) == 2 * (sum(layers) - 1)
    got, got_gp, got_gx = torch_vjp(port, x, cts, resize_output=False,
                                    noise={"drop_path": factors, "dropout": None})
    rel_close(got[0], out)
    rel_close(got_gx, gx, 1e-3)
    trees_close(_jax_model({**sd, **got_gp}, layers)["params"], gp, of_largest=GRAD_FLOOR)
    new = {k: v.numpy() for k, v in port.state_dict().items() if "running" in k}
    _stats_close(_jax_model({**sd, **new}, layers)["batch_stats"], extra["state"]["batch_stats"])


def test_sample_noise_covers_drop_path():
    """``sample_noise`` draws (blocks, 2, batch) drop-path factors at each
    block's rate: ones for a rate of 0, else 0 or 1 / keep."""
    port = _port_model(True, RATE)
    noise = port.sample_noise(3, torch.Generator().manual_seed(0), (64, 64))
    f = noise["drop_path"]
    assert tuple(f.shape) == (10, 2, 3)
    for blk, fb in zip(port.backbone.blocks(), f):
        if blk.drop_path_rate == 0:
            assert torch.equal(fb, torch.ones_like(fb))
        else:
            keep = 1.0 - blk.drop_path_rate
            assert set(fb.flatten().tolist()) <= {0.0, float(torch.tensor(1.0) / keep)}


@pytest.mark.parametrize("variant", ["xs", "s", "m", "t"])
def test_from_jax_variables_round_trips(variant):
    """Port weights (``rcvit_<v>`` + ``fpnhead``, E = 768 by the default
    rule) -> the JAX tree -> ``from_jax_variables`` gives the port's
    ``state_dict`` back bit for bit (dispatched as CAS-ViT, not as
    ConvNeXt, whose tree shares ``down_norm{i}`` / ``out_norm{i}``); the JAX
    tree's shapes are the JAX model's (``jax.eval_shape`` of its init)."""
    name = f"rcvit_{variant}"
    port = SegmentationModel(name, "fpnhead", NC, dtype=torch.float32)
    sd = random_state_dict(port, seed=7)
    variables = _jax_model(sd, C.CASVIT_SETTINGS[variant][0])
    jm = jbuild.SegmentationModel(name, "fpnhead", NC, dtype=jnp.float32)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    assert (jax.tree_util.tree_map(np.shape, variables)
            == jax.tree_util.tree_map(lambda a: a.shape, dict(want)))
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert BACKBONES[name](dtype=torch.float32)[1] == J_BACKBONES[name]()[1]
