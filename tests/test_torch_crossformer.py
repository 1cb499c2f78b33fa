"""CrossFormer / CrossFormer++ against the JAX package, on the CPU.

Weights are numpy, drawn for the port's reference-layout ``state_dict``
(``_torch_port.random_state_dict``) and carried to the JAX tree by the JAX
package's ``convert_crossformer`` (whole models) or the same mapping of
one module's keys (``_attn_tree``, ``_block_tree``); where no JAX converter
names a module (``cel``'s extra kernels, ``use_cpe``'s conv and norm) the
JAX model's own init is filled with numpy draws and carried to the port by
``from_jax_variables``. Both sides compute in float32. In training the
port takes the JAX drop-path factors: ``DropPath`` is wrapped to record
each call's factor. Tolerances: outputs within 1e-4 of the JAX output's
largest magnitude, gradients within 1e-3 of each tensor's largest JAX
entry plus 1e-6 of the module's or model's largest (``GRAD_FLOOR``: the
position bias's last bias adds one constant to every score of a head, so
the softmax makes its gradient 0 but for rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import convert as JCV
from segmentation_factory_tpu.models import build as jbuild
from segmentation_factory_tpu.models.backbones import crossformer as JCF
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu_torch import convert as PC
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.models.backbones import crossformer as CF
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
RATE = 0.2  # the drop-path rate of the training tests


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _dpb_tree(sd, p):
    out = {"Dense_0": JCV.t_linear(sd, f"{p}.pos_proj")}
    for k in range(3):
        out[f"LayerNorm_{k}"] = JCV.t_ln(sd, f"{p}.pos{k + 1}.0")
        out[f"Dense_{k + 1}"] = JCV.t_linear(sd, f"{p}.pos{k + 1}.2")
    return out


def _attn_tree(sd, p=""):
    out = {"qkv": JCV.t_linear(sd, f"{p}qkv"), "proj": JCV.t_linear(sd, f"{p}proj")}
    if f"{p}pos.pos_proj.weight" in sd:
        out["pos"] = _dpb_tree(sd, f"{p}pos")
    return out


def _block_tree(sd):
    """One CrossFormerBlock's JAX params (``convert_crossformer``'s block)."""
    out = {"norm1": JCV.t_ln(sd, "norm1"), "attn": _attn_tree(sd, "attn."),
           "norm2": JCV.t_ln(sd, "norm2"), "Dense_0": JCV.t_linear(sd, "mlp.fc1"),
           "Dense_1": JCV.t_linear(sd, "mlp.fc2")}
    if "cpe.weight" in sd:
        out["cpe"], out["norm_cpe"] = JCV.t_conv(sd, "cpe"), JCV.t_ln(sd, "norm_cpe")
    return out


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
        mask = jax.random.bernoulli(self.make_rng("droppath"), keep,
                                    (x.shape[0],) + (1,) * (x.ndim - 1))
        factors.append(jnp.where(mask, 1.0 / keep, 0.0).reshape(-1).astype(jnp.float32))
        return jnp.where(mask, x / keep, jnp.zeros_like(x)).astype(x.dtype)

    monkeypatch.setattr(JC.DropPath, "__call__", call)
    return factors


def _group_mask(valid_hw, g):
    """(groups, 1, G²) additive mask of SDA groups over a padded map whose
    top-left ``valid_hw`` is the image, as the JAX block builds it."""
    hp = wp = 2 * g
    valid = np.zeros((hp, wp), np.float32)
    valid[:valid_hw[0], :valid_hw[1]] = 1.0
    vm = valid.reshape(2, g, 2, g).transpose(0, 2, 1, 3).reshape(4, g * g)
    return np.where(vm[:, None, :] > 0, 0.0, JCF.NEG_INF).astype(np.float32)


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("masked", [False, True])
def test_group_attention_matches_jax(masked):
    """GroupAttention (32 channels, 4 heads, G = 4, the dynamic position
    bias on) over 2 images x 4 groups: output and the gradients of a random
    projection of it; with the -1e9 additive mask of a 5 x 7 map padded to
    8 x 8 (whole rows of padding, every key of a group of the last row
    masked: those rows must take the same uniform weights as JAX's)."""
    c, heads, g = 32, 4, 4
    port = CF.GroupAttention(c, heads, dtype=torch.float32)
    sd = random_state_dict(port, seed=1)
    load_numpy(port, sd)
    rng = np.random.default_rng(2)
    x = _normal(rng, (8, g * g, c))
    cts = [_normal(rng, (8, g * g, c))]
    mask = np.tile(_group_mask((5, 3), g), (2, 1, 1)) if masked else None
    kw = {"attn_mask": jnp.asarray(mask)} if masked else {}
    out, gp, gx, _ = jax_vjp(JCF.GroupAttention(c, heads, g, dtype=jnp.float32),
                             {"params": _attn_tree(sd)}, x, cts, **kw)
    got, got_gp, got_gx = torch_vjp(port, x, cts, g,
                                    None if mask is None else torch.from_numpy(mask))
    rel_close(got[0], out)
    rel_close(got_gx, gx, 1e-3)
    trees_close(_attn_tree({**sd, **got_gp}), gp, of_largest=GRAD_FLOOR)


@pytest.mark.parametrize("case", ["sda", "lda", "fallback", "cpe"])
def test_block_partitions_match_jax(case):
    """One CrossFormerBlock (48 channels, 3 heads): SDA on a 13 x 16 map (G
    7, padded to 14 x 21), LDA on 16 x 16 (G 7, I 8: padded to 56 x 56, as
    CrossFormer's stage 1 at 64²), the small-map fallback on 5 x 9 (one
    group of 9², the interval ignored) and ``use_cpe`` (no position bias)
    under LDA at interval 2; output and the gradients of a random
    projection of it with respect to every parameter and the input."""
    c, heads = 48, 3
    hw, lsda, interval, cpe = {"sda": ((13, 16), 0, 8, False), "lda": ((16, 16), 1, 8, False),
                               "fallback": ((5, 9), 1, 8, False),
                               "cpe": ((16, 16), 1, 2, True)}[case]
    port = CF.CrossFormerBlock(c, heads, 7, interval, lsda, use_cpe=cpe, dtype=torch.float32)
    assert port.grouping(*hw) == {"sda": (7, 1, False), "lda": (7, 8, True),
                                  "fallback": (9, 1, False), "cpe": (7, 2, True)}[case]
    sd = random_state_dict(port, seed=3)
    load_numpy(port, sd)
    rng = np.random.default_rng(4)
    x = _normal(rng, (2, *hw, c))
    cts = [_normal(rng, (2, *hw, c))]
    jm = JCF.CrossFormerBlock(c, heads, 7, interval, lsda, use_cpe=cpe, dtype=jnp.float32)
    out, gp, gx, _ = jax_vjp(jm, {"params": _block_tree(sd)}, x, cts)
    got, got_gp, got_gx = torch_vjp(port, x, cts)
    rel_close(got[0], out)
    rel_close(got_gx, gx, 1e-3)
    trees_close(_block_tree({**sd, **got_gp}), gp, of_largest=GRAD_FLOOR)


def test_linear_group_schedule_matches_jax():
    """CrossFormer++'s ``linear`` group sizes of every variant's depths."""
    for _, depths, *_ in CF.CROSSFORMERPP_SETTINGS.values():
        assert CF.linear_group_schedule(depths) == JCF.linear_group_schedule(depths)


# ---------------------------------------------------------------- backbones


def _jax_init_tree(jm, size, seed):
    """The JAX model's init at (1, size, size, 3), every leaf drawn anew:
    kernels N(0, 1/fan_in), biases N(0, 0.1²), scales 1 + N(0, 0.1²)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if leaf.ndim == 1:
            base = 1.0 if "scale" in name else 0.0
            return (base + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


NARROW = {
    # depths cut; embed dim 32: (settings, kwargs, size)
    "crossformer_64": ((32, [2, 2, 1, 1], [1, 2, 4, 8], [7, 7, 7, 7], [8, 4, 2, 1]), {}, 64),
    "crossformerpp_256": ((32, [1, 1, 2, 1], [1, 2, 4, 8], [4, 4, 14, 7], [4, 4, 1, 1]), {}, 256),
    "cel_cpe_linear_64": ((32, [2, 1, 2, 1], [1, 2, 4, 8], None, [4, 4, 1, 1]),
                          {"use_cpe": True, "stem_kernels": (4, 8, 16, 32),
                           "merge_kernels": (2, 4)}, 64),
}


@pytest.mark.parametrize("case", list(NARROW))
def test_narrow_backbone_matches_jax(case):
    """Narrow backbones (embed dim 32, depths cut): CrossFormer's G 7 / I
    8 at 64² (stage 1's LDA pads 16 to 56, stages 3-4 take the fallback),
    CrossFormer++'s G 14 at stage 3 of 256² (16², padded to 28) and 7 at
    stage 4, and ``cel`` + ``use_cpe`` + the ``linear`` schedule at 64²
    (weights from the JAX init, carried by ``from_jax_variables``); the
    four features and the gradients of a random projection of them with
    respect to every parameter and the image."""
    (dim, depths, heads, groups, intervals), kw, size = NARROW[case]
    groups = groups or CF.linear_group_schedule(depths)
    jm = JCF.CrossFormer(dim, depths, heads, groups, intervals, drop_path_rate=0.0,
                         dtype=jnp.float32, **kw)
    port = CF.CrossFormer(dim, depths, heads, groups, intervals, drop_path_rate=0.0,
                          dtype=torch.float32, **kw)
    if case.startswith("cel"):
        params = _jax_init_tree(jm, size, 5)["params"]
        load_numpy(port, _port_keys(params))
    else:
        sd = random_state_dict(port, seed=5)
        load_numpy(port, sd)
        params = JCV.convert_crossformer(sd, depths)
    rng = np.random.default_rng(6)
    x = _normal(rng, (2, size, size, 3))
    cts = [_normal(rng, (2, size // s, size // s, dim * s // 4)) for s in (4, 8, 16, 32)]
    out, gp, gx, _ = jax_vjp(jm, {"params": params}, x, cts)
    got, got_gp, got_gx = torch_vjp(port, x, cts)
    for a, b in zip(got, out):
        rel_close(a, b)
    rel_close(got_gx, gx, 1e-3)
    trees_close(got_gp, _port_keys(gp), of_largest=GRAD_FLOOR)


def _port_keys(tree):
    """A JAX CrossFormer tree (params or their gradients) under the port's
    keys, by ``from_jax_variables``' backbone mapping."""
    sd = {}
    PC._crossformer(sd, tree)
    return {k: v.numpy() for k, v in strip(sd, "backbone.").items()}


# ---------------------------------------------------------------- the model


# 4 images: the PPM's 1 x 1 scale normalises over the batch alone, and over
# 2 images its training-mode BatchNorm maps every pair to +-1, whose
# gradients are rounding (either framework's)
B_MODEL = 4
TINY_CUT = (64, [1, 1, 2, 2], [2, 4, 8, 16], [7, 7, 7, 7], [8, 4, 2, 1])


@pytest.mark.parametrize("train", [False, True])
def test_crossformer_uperhead_matches_jax(monkeypatch, recorded_drop_path, train):
    """``crossformer_tiny`` (its depths cut to 1, 1, 2, 2 on both sides) +
    ``uperhead`` (E = 32, 5 classes), 4 images at 64², drop path 0.2 through
    ``backbone_kwargs``: the stride-4 logits; in training (the factors the
    JAX ones, fed through ``noise``, one row a branch of each block; the
    head's dropout off on both sides) the gradients of a random projection
    of them with respect to every parameter and the image."""
    import flax.linen as fnn

    name = "crossformer_tiny"
    monkeypatch.setitem(CF.CROSSFORMER_SETTINGS, "tiny", TINY_CUT)
    monkeypatch.setitem(JCF.CROSSFORMER_SETTINGS, "tiny", TINY_CUT)
    depths = TINY_CUT[1]
    port = SegmentationModel(name, "uperhead", NC, embed_dim=E, dtype=torch.float32,
                             backbone_kwargs={"drop_path_rate": RATE}).train(train)
    sd = random_state_dict(port, seed=7)
    load_numpy(port, sd)
    variables = JCV.convert_full_model(sd, name, "uperhead")
    jm = jbuild.SegmentationModel(name, "uperhead", NC, embed_dim=E, dtype=jnp.float32,
                                  backbone_kwargs={"drop_path_rate": RATE})
    rng = np.random.default_rng(8)
    x = _normal(rng, (B_MODEL, 64, 64, 3))
    if not train:
        want = jit_apply(jm, variables, jnp.asarray(x), train=False, resize_output=False)
        with torch.no_grad():
            got = port(torch.from_numpy(x), resize_output=False)
        assert got.shape == (B_MODEL, 16, 16, NC)
        rel_close(got.numpy(), want)
        return
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    cts = [_normal(rng, (B_MODEL, 16, 16, NC))]
    out, gp, gx, extra = jax_vjp(jm, variables, x, cts, record=recorded_drop_path,
                                 resize_output=False, train=True, mutable=["batch_stats"],
                                 rngs={"droppath": jax.random.PRNGKey(9)})
    it = iter(extra["record"])
    factors = torch.stack([
        torch.stack([torch.from_numpy(np.array(next(it))) for _ in range(2)])
        if blk.drop_path_rate > 0 else torch.ones((2, B_MODEL)) for blk in port.backbone.blocks()])
    assert next(it, None) is None and len(extra["record"]) == 2 * (sum(depths) - 1)
    got, got_gp, got_gx = torch_vjp(port, x, cts, resize_output=False,
                                    noise={"drop_path": factors, "dropout": None})
    rel_close(got[0], out)
    rel_close(got_gx, gx, 1e-3)
    trees_close(JCV.convert_full_model({**sd, **got_gp}, name, "uperhead")["params"], gp,
                of_largest=GRAD_FLOOR)


def test_sample_noise_and_feature_sizes():
    """``sample_noise`` draws (blocks, 2, batch) factors at the default rate
    0.1 (ones at the first block); the features round down at a size 32
    does not divide (the stem's and merges' unpadded convs)."""
    port = SegmentationModel("crossformer_tiny", "uperhead", NC, embed_dim=E,
                             dtype=torch.float32).train()
    f = port.sample_noise(3, torch.Generator().manual_seed(0), (64, 64))["drop_path"]
    assert tuple(f.shape) == (16, 2, 3) and torch.equal(f[0], torch.ones((2, 3)))
    assert port.backbone.blocks()[-1].drop_path_rate == pytest.approx(0.1)
    with torch.no_grad():
        feats = port.eval().backbone(torch.zeros((1, 100, 70, 3)))
    assert [tuple(t.shape[1:3]) for t in feats] == port.feature_sizes(100, 70)
    assert port.feature_sizes(100, 70) == [(25, 17), (12, 8), (6, 4), (3, 2)]


@pytest.mark.parametrize("name", ["crossformer_small", "crossformerpp_small"])
def test_from_jax_variables_round_trips(name):
    """Port weights -> ``convert_full_model`` -> ``from_jax_variables``
    gives the port's ``state_dict`` back bit for bit (dispatched as
    CrossFormer by ``merge1`` and ``block0_0``). That the converted trees
    are the JAX model's, the model tests above show by applying it to
    them."""
    port = SegmentationModel(name, "uperhead", NC, dtype=torch.float32)
    sd = random_state_dict(port, seed=10)
    back = from_jax_variables(JCV.convert_full_model(sd, name, "uperhead"))
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
