"""iFormer against the JAX package, on the CPU.

With ``use_reparam`` (the default, ``RepDWBlock``: no reference keys, no
JAX converter) the JAX model's own init is filled with numpy draws and
carried to the port by ``from_jax_variables``; with ``use_reparam=False``
the port's reference-layout weights (``_torch_port.random_state_dict``)
go to the JAX tree by the JAX package's ``convert_full_model``. Both sides
compute in float32. In training the port takes the JAX drop-path factors
(``DropPath`` wrapped to record each call's factor). Tolerances: outputs
within 1e-4 of the JAX output's largest magnitude, gradients within 1e-3
of each tensor's largest JAX entry plus 1e-6 of the model's largest
(``GRAD_FLOOR``), BatchNorm running statistics within 1e-4 of each
tensor's largest entry (RepDWBlock's bare flax BatchNorm at momentum 0.99,
the ConvModules' at 0.9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import convert as JCV
from segmentation_factory_tpu.models import build as jbuild
from segmentation_factory_tpu.models.backbones import iformer as JIF
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu_torch import convert as PC
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.models.backbones import iformer as IF
from segmentation_factory_tpu_torch.models.build import SegmentationModel

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

NC, E = 5, 32
GRAD_FLOOR = 1e-6
RATE = 0.2
SIZE = 64
DIMS = [16, 32, 48, 64]
_C = [("conv", 7, 3)]
# a cut schedule of each kind: conv blocks and attention triplets; the
# _faster split at the first stage-3 SHMA (16² windows of a 4 x 4 map: 240
# zero tokens in each) merged by a later one, with an FFN and a CPE on the
# windowed stream; the same schedule sliced so that the stage ends
# windowed (merged there) and the next triplet straddles stages 3 and 4
_FASTER = _C * 3 + IF._triplet(2, 2, wsp=True, ws=16) + IF._triplet(2, 2, wre=True, ws=16) \
    + _C + IF._triplet(4, 2)
SCHEDULES = {
    "cut": ([1, 1, 4, 3], _C * 3 + IF._triplet(2, 2) + IF._triplet(4, 2)),
    "faster": ([1, 1, 7, 4], _FASTER),
    "straddle": ([1, 1, 5, 6], _FASTER),
}


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture
def recorded_drop_path(monkeypatch):
    """Every active ``DropPath`` call appends its (B,) float32 factor."""
    factors = []

    def call(self, x, deterministic=True):
        if self.rate == 0.0 or deterministic:
            return x
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("droppath"), keep,
                                    (x.shape[0],) + (1,) * (x.ndim - 1))
        factors.append(jnp.where(mask, 1.0 / keep, 0.0).reshape(-1).astype(jnp.float32))
        return jnp.where(mask, x / keep, jnp.zeros_like(x)).astype(x.dtype)

    monkeypatch.setattr(JC.DropPath, "__call__", call)
    return factors


def _filled(shapes, seed):
    """numpy draws of a JAX variables' shapes: kernels N(0, 1/fan_in),
    biases and means N(0, 0.1²), scales 1 + N(0, 0.1²), variances in [0.5,
    1.5)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        if leaf.ndim == 1:
            base = 1.0 if "scale" in name else 0.0
            return (base + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _to_port(params, stats):
    """A JAX iFormer tree (params or their gradients, with batch_stats)
    under the port's keys, by ``from_jax_variables``' backbone mapping."""
    sd = {}
    PC._iformer(sd, params, stats)
    return {k: v.numpy() for k, v in strip(sd, "backbone.").items()}


def _pair(kind, rate=0.0, use_reparam=True):
    depths, schedule = SCHEDULES[kind]
    jm = JIF.iFormer(depths=depths, dims=DIMS, schedule=tuple(schedule), drop_path_rate=rate,
                     use_reparam=use_reparam, dtype=jnp.float32)
    port = IF.iFormer(depths, DIMS, schedule, rate, use_reparam, torch.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    variables = _filled(shapes, 1)
    load_numpy(port, _to_port(variables["params"], variables["batch_stats"]))
    return jm, port, variables


@pytest.mark.parametrize("kind,train,size", [("cut", False, SIZE), ("cut", True, SIZE),
                                             ("faster", False, SIZE), ("faster", True, 256),
                                             ("straddle", True, 256)])
def test_iformer_backbone_matches_jax(recorded_drop_path, kind, train, size):
    """Narrow iFormers (dims 16-64, depths cut; RepDWBlocks): the four
    features and the gradients of a random projection of them with respect
    to every parameter and the image; in training (drop path 0.2, linear in
    the flat schedule with the CPE entries counted) with the JAX factors,
    and every BatchNorm's running statistics after the step. The _faster
    schedules train at 256² (a 16 x 16 stage-3 map, one window): in
    training, windows that are mostly zero padding make the BatchNorms'
    fast variance E[x²] - E[x]² cancel, and at 64² JAX's own float32
    features differ from its float64 ones by 2.5e-4 of their largest (and
    still 5.8e-5 at 448², 23 % padding), so the padded windows are held in
    eval, at 64²."""
    jm, port, variables = _pair(kind, RATE)
    port.train(train)
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, size, size, 3))
    cts = [_normal(rng, (2, size // s, size // s, c)) for s, c in zip((4, 8, 16, 32), DIMS)]
    kw = (dict(train=True, mutable=["batch_stats"], rngs={"droppath": jax.random.PRNGKey(3)})
          if train else dict(train=False))
    out, gp, gx, extra = jax_vjp(jm, variables, x, cts, record=recorded_drop_path, **kw)
    factors = None
    if train:
        it = iter(extra["record"])
        factors = torch.stack([torch.from_numpy(np.array(next(it)))
                               if k[0] != "cpe" and r > 0 else torch.ones(2)
                               for k, r in zip(port.kinds, port.rates)])
        assert next(it, None) is None
    got, got_gp, got_gx = torch_vjp(port, x, cts, factors)
    for a, b in zip(got, out):
        rel_close(a, b)
    rel_close(got_gx, gx, 1e-3)
    want_gp = {k: v for k, v in _to_port(gp, variables["batch_stats"]).items()
               if "running" not in k and "num_batches" not in k}
    trees_close(got_gp, want_gp, of_largest=GRAD_FLOOR)
    if train:
        new = _to_port(variables["params"], extra["state"]["batch_stats"])
        for k, v in port.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), new[k], rtol=0,
                                           atol=1e-4 * np.abs(new[k]).max(), err_msg=k)
        rep = port.stages[0][0].block.token_channel_mixer.m._modules["0"]
        assert rep.bn.momentum == 0.01
        assert port.stages[0][0].block.token_channel_mixer.m._modules["1"].bn.momentum == 0.1


def test_reparameterize_matches_jax():
    """``reparameterize_iformer`` on the port's ``state_dict`` against the
    JAX function on the JAX tree (every folded tensor within 1e-6 of its
    largest entry); the port's eval features after it within 1e-4 of its
    unfused ones (that BN's rsqrt(1 + eps) is all that differs), and equal
    to the JAX model's after the JAX fold."""
    jm, port, variables = _pair("cut")
    port.eval()
    x = _normal(np.random.default_rng(4), (2, SIZE, SIZE, 3))
    with torch.no_grad():
        before = port(torch.from_numpy(x))
    sd = port.state_dict()
    fused = IF.reparameterize_iformer(sd)
    p2, s2 = JIF.reparameterize_iformer(variables["params"], variables["batch_stats"])
    want = _to_port(p2, s2)
    assert set(fused) == set(want)
    folded = sum(k.endswith("dw_big.weight") for k in fused)
    assert folded == sum(k[0] == "conv" for k in port.kinds)
    for k, v in fused.items():
        w = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-6 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)
    port.load_state_dict(fused)
    with torch.no_grad():
        after = port(torch.from_numpy(x))
    jax_after = jit_apply(jm, {"params": p2, "batch_stats": s2}, jnp.asarray(x), train=False)
    for a, b, j in zip(after, before, jax_after):
        rel_close(a.numpy(), b.numpy())
        rel_close(a.numpy(), j)


def test_iformer_t_plain_through_convert_full_model():
    """``iformer_t`` with ``use_reparam=False`` (the reference's plain
    depthwise convs) + ``fpnhead`` (E = 32): the port's weights through the
    JAX ``convert_full_model`` give the JAX model's eval logits at 64², and
    ``from_jax_variables`` gives them back bit for bit."""
    name, bkw = "iformer_t", {"use_reparam": False}
    port = SegmentationModel(name, "fpnhead", NC, embed_dim=E, dtype=torch.float32,
                             backbone_kwargs=bkw).eval()
    sd = random_state_dict(port, seed=5)
    load_numpy(port, sd)
    variables = JCV.convert_full_model(sd, name, "fpnhead")
    jm = jbuild.SegmentationModel(name, "fpnhead", NC, embed_dim=E, dtype=jnp.float32,
                                  backbone_kwargs=bkw)
    x = _normal(np.random.default_rng(6), (2, SIZE, SIZE, 3))
    want = jit_apply(jm, variables, jnp.asarray(x), train=False, resize_output=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x), resize_output=False)
    rel_close(got.numpy(), want)
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_from_jax_variables_keeps_casvit_and_iformer_apart():
    """Both JAX trees have a ``stem1``: ``from_jax_variables`` reads
    iFormer by its ``stem2_exp`` and CAS-ViT otherwise, each tree's keys
    the port's model's (``convert_full_model`` of the port's weights)."""
    for name in ("iformer_t", "rcvit_xs"):
        bkw = {"use_reparam": False} if name.startswith("iformer") else None
        port = SegmentationModel(name, "fpnhead", NC, embed_dim=E, dtype=torch.float32,
                                 backbone_kwargs=bkw)
        sd = random_state_dict(port, seed=7)
        variables = JCV.convert_full_model(sd, name, "fpnhead")
        assert "stem1" in variables["params"]["backbone"]
        assert set(from_jax_variables(variables)) == set(sd)


def test_sample_noise_covers_the_flat_schedule():
    """(blocks, batch) factors: one row a schedule entry at
    np.linspace(0, rate, blocks), CPE rows ones; none drawn at the default
    rate 0."""
    port = SegmentationModel("iformer_t", "fpnhead", NC, embed_dim=E, dtype=torch.float32,
                             backbone_kwargs={"drop_path_rate": RATE}).train()
    f = port.sample_noise(3, torch.Generator().manual_seed(0), (SIZE, SIZE))["drop_path"]
    bb = port.backbone
    assert tuple(f.shape) == (26, 3) and bb.rates == list(np.linspace(0, RATE, 26))
    for (kind, *_), row in zip(bb.kinds, f):
        if kind == "cpe":
            assert torch.equal(row, torch.ones(3))
    default = SegmentationModel("iformer_t", "fpnhead", NC, embed_dim=E, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(default.train().sample_noise(2, g)["drop_path"], torch.ones((26, 2)))
