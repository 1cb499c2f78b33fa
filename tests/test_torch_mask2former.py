"""MiT + Mask2Former (``mask2formerhead``) against the JAX package, on the CPU.

Weights are numpy, drawn for the JAX tree (``_m2f.random_tree``: shapes by
``jax.eval_shape``, deformable offsets a few pixels away from the point
grid) and carried to the port by ``convert.from_jax_variables`` (its module
helpers for single modules). The JAX side is built in float32
(``dtype=jnp.float32``); its forwards are jitted. Tolerance: 1e-4 of the
reference's largest entry (float32 sums in another order), for values and
for gradients. In bfloat16 the port's error from the JAX float32 logits is
at most twice the JAX bfloat16 logits' own (the two frameworks round bf16
products and sums at different places). Also: the port's init rule, the
Trainer on a tiny Synthetic config with ``model.head = "mask2formerhead"``,
and ``train`` / ``validate`` taking the head.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu.models.layers import common as JC
from segmentation_factory_tpu.models.layers import mask_decoders as JMD
from segmentation_factory_tpu.models.layers import msdeformattn as JMS
from segmentation_factory_tpu.models.modules.position_encoding import (
    sine_position_encoding as jax_sine,
)
from segmentation_factory_tpu_torch import build_model, config, convert, train, validate
from segmentation_factory_tpu_torch.data import datasets
from segmentation_factory_tpu_torch.data.datasets import Synthetic
from segmentation_factory_tpu_torch.engine import compute_loss
from segmentation_factory_tpu_torch.engine import loop as tloop
from segmentation_factory_tpu_torch.models.layers import mask_decoders as MD
from segmentation_factory_tpu_torch.models.layers import msdeformattn as MS
from segmentation_factory_tpu_torch.models.layers.norm import GroupNorm
from segmentation_factory_tpu_torch.models.modules.position_encoding import (
    sine_position_encoding,
)

from _m2f import no_noise, random_tree
from _torch_port import two_torch_threads  # noqa: F401  (autouse)

NC, SIZE = 7, 64
HK = dict(pixel_layers=2, decoder_layers=3, num_queries=10)
REL = 1e-4


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


def _module_case(module, args, seed, levels):
    """Random weights for a JAX module (its shapes by eval_shape) and its
    jitted float32 output on ``args`` and the static ``levels``."""
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, levels), *args)
    params = random_tree(shapes["params"], seed)
    out = jax.jit(lambda v, *a: module.apply(v, *a, levels))({"params": params}, *args)
    return params, out


def _load(port, sd):
    port.load_state_dict(sd, strict=True)
    return port


# ---------------------------------------------------------------- pieces


def test_position_encoding_grid_and_offset_bias_match_jax():
    for h, w, n in ((5, 7, 16), (8, 8, 64), (1, 3, 8)):
        want = jax.jit(functools.partial(jax_sine, h, w, n))()
        _close(sine_position_encoding(h, w, n).numpy(), want, rel=1e-6)
    shapes = ((3, 5), (2, 2), (1, 1))
    got = MS.reference_point_grid(shapes)
    np.testing.assert_allclose(got.numpy(), np.asarray(JMS.reference_point_grid(shapes)),
                               rtol=0, atol=1e-7)
    assert got.shape == (20, 3, 2)
    want = JMS._offset_bias_init(8, 3, 4)(None, (8 * 3 * 4 * 2,))
    np.testing.assert_array_equal(MS.offset_bias(8, 3, 4), np.asarray(want))


LEVELS = ((4, 4), (3, 5), (2, 2))


def _attn_inputs(seed, dim=64, q=10):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in LEVELS)
    return (_normal(rng, (2, q, dim)), rng.uniform(0, 1, (2, q, 3, 2)).astype(np.float32),
            _normal(rng, (2, s, dim)))


def test_msdeformattn_matches_jax():
    query, ref, value = _attn_inputs(1)
    jm = JMS.MSDeformAttn(dim=64, n_levels=3, n_heads=8, n_points=4, dtype=jnp.float32)
    params, want = _module_case(jm, (query, ref, value), 2, LEVELS)
    sd = {}
    convert.msdeformattn_tree(sd, params, "")
    port = _load(MS.MSDeformAttn(64, 3, 8, 4, dtype=torch.float32), sd)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (query, ref, value)), LEVELS)
    _close(_np(got), want)


def test_encoder_layer_matches_jax():
    _, _, src = _attn_inputs(3)
    rng = np.random.default_rng(4)
    pos = _normal(rng, src.shape)
    ref = np.asarray(MS.reference_point_grid(LEVELS)[None].expand(2, -1, -1, -1))
    jm = JMS.DeformableEncoderLayer(64, 8, 4, 3, dtype=jnp.float32)
    params, want = _module_case(jm, (src, pos, ref), 5, LEVELS)
    sd = {}
    convert.encoder_layer_tree(sd, params, "")
    port = _load(MS.DeformableEncoderLayer(64, 8, 4, 3, dtype=torch.float32), sd)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (src, pos, ref)), LEVELS)
    _close(_np(got), want)


PYRAMID = (16, 32, 48, 64)


def test_pixel_decoder_matches_jax_with_both_groupnorm_eps():
    """The decoder over a 16² .. 2² pyramid. The lateral's input is scaled
    by 1e-3 and the output conv's weights by 1e-3, so that both GroupNorms
    see variances near their epsilons (1e-6 raw, 1e-5 through
    ``ConvModule(norm="gn")``): the port with the two swapped misses."""
    rng = np.random.default_rng(6)
    feats = [_normal(rng, (2, 16 >> i, 16 >> i, c)) for i, c in enumerate(PYRAMID)]
    feats[0] *= 1e-3
    jm = JMS.MSDeformAttnPixelDecoder(channels=list(PYRAMID), dim=64, mask_dim=64, n_layers=1,
                                      dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), feats)
    params = random_tree(shapes["params"], 7)
    params["output_conv0"]["Conv_0"]["kernel"] *= 1e-3
    params["output_conv0"]["Conv_0"]["bias"] *= 1e-3
    want_mf, want_ms = jax.jit(jm.apply)({"params": params}, feats)
    sd = {}
    convert.pixel_decoder_tree(sd, params, "")
    port = _load(MS.MSDeformAttnPixelDecoder(PYRAMID, 64, 64, n_layers=1, dtype=torch.float32),
                 sd)
    assert port.input_proj[0][1].eps == port.lateral_convs[0][1].eps == 1e-6
    assert port.output_convs[0]._modules["1"].eps == 1e-5
    tf = [torch.from_numpy(f) for f in feats]
    with torch.no_grad():
        mf, ms = port(tf)
    assert mf.dtype == torch.float32 and [m.shape[1] for m in ms] == [2, 4, 8]
    _close(_np(mf), want_mf)
    for g, w in zip(ms, want_ms):
        _close(_np(g), w)
    for norm, eps in ((port.lateral_convs[0][1], 1e-5), (port.output_convs[0]._modules["1"], 1e-6)):
        saved, norm.eps = norm.eps, eps
        with torch.no_grad():
            swapped = port(tf)[0]
        norm.eps = saved
        err = np.abs(_np(swapped) - np.asarray(want_mf)).max()
        assert err > 100 * REL * np.abs(np.asarray(want_mf)).max(), (eps, err)


def test_masked_decoder_matches_jax_with_a_query_that_blocks_every_key():
    """Three layers over three levels. The mask features' channel 0 is 1
    everywhere, so the last mask-embedding bias of that channel shifts every
    query's mask logits by a constant: it is set to minus the median of the
    queries' largest first-level logit, so that about half the queries
    block every key before layer 0 (and are unblocked) and the others
    block some."""
    rng = np.random.default_rng(8)
    ms = [_normal(rng, (2, s, s, 64)) for s in (2, 4, 8)]
    mf = _normal(rng, (2, 16, 16, 64))
    mf[..., 0] = 1.0
    jm = JMD.MultiScaleMaskedTransformerDecoder(num_classes=5, dim=64, num_queries=6,
                                                num_layers=3, mask_dim=64, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), ms, mf)
    params = random_tree(shapes["params"], 9)
    port = MD.MultiScaleMaskedTransformerDecoder(5, 64, 6, 3, mask_dim=64, dtype=torch.float32)
    sd = {}
    convert.masked_decoder_tree(sd, params, "")
    _load(port, sd)
    tms, tmf = [torch.from_numpy(m) for m in ms], torch.from_numpy(mf)
    with torch.no_grad():
        _, masks = port._predict(port.query_feat[None].expand(2, -1, -1), tmf)
        first = JC.resize(jnp.asarray(_np(masks).transpose(0, 2, 3, 1)), (2, 2))
        top = np.asarray(first).max(axis=(1, 2))  # (B, Q)
        shift = -float(np.median(top))
    params["mask_embed"]["Dense_2"]["bias"][0] += shift
    sd["mask_embed.layers.2.bias"][0] += shift
    _load(port, sd)
    blocked = (top + shift) < 0.0  # every key blocked: sigmoid < 0.5 everywhere
    assert 0 < blocked.sum() < blocked.size
    want = jax.jit(jm.apply)({"params": params}, ms, mf)
    with torch.no_grad():
        got = port(tms, tmf)
    _close(_np(got["pred_logits"]), want["pred_logits"])
    _close(_np(got["pred_masks"]), want["pred_masks"])
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 3
    for g, w in zip(got["aux_outputs"], want["aux_outputs"]):
        _close(_np(g["pred_logits"]), w["pred_logits"])
        _close(_np(g["pred_masks"]), w["pred_masks"])


def test_semantic_inference_matches_jax():
    rng = np.random.default_rng(10)
    logits, masks = _normal(rng, (2, 6, 5)), _normal(rng, (2, 6, 8, 9), 3.0)
    got = MD.semantic_inference(torch.from_numpy(logits), torch.from_numpy(masks))
    _close(got.numpy(), JMD.semantic_inference(logits, masks), rel=1e-6)


# ---------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def m2f():
    """MiT-B0 + mask2formerhead at 64² (2 pixel-decoder layers, 3 decoder
    layers, 10 queries): the JAX variables, the port's state_dict, an input
    batch, and the JAX head-resolution log-probabilities in float32 and
    bfloat16."""
    jm = jax_build_model("mit_b0", "mask2formerhead", NC, dtype=jnp.float32, head_kwargs=HK,
                         backbone_kwargs={"drop_path_rate": 0.0})
    rng = np.random.default_rng(11)
    x = _normal(rng, (2, SIZE, SIZE, 3))
    lab = rng.integers(0, NC, (2, SIZE, SIZE)).astype(np.int32)
    lab[:, :4] = 255
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": random_tree(shapes["params"], 12)}
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        m = jax_build_model("mit_b0", "mask2formerhead", NC, dtype=dt, head_kwargs=HK)
        fwd = jax.jit(functools.partial(m.apply, train=False, resize_output=False))
        out[name] = np.asarray(fwd(variables, jnp.asarray(x)), np.float32)
    return jm, variables, convert.from_jax_variables(variables), x, lab, out


def _port(sd, dtype=torch.float32, **kw):
    model = build_model("mit_b0", "mask2formerhead", NC, dtype=dtype, device="cpu",
                        head_kwargs=dict(HK, **kw))
    return _load(model, sd)


def test_head_and_model_match_jax(m2f):
    """The head's stride-4 log-probabilities and the model's output resized
    to the input, eval."""
    _, _, sd, x, _, want = m2f
    port = _port(sd)
    with torch.no_grad():
        lo = port(torch.from_numpy(x), resize_output=False)
        full = port(torch.from_numpy(x))
    assert lo.shape == (2, SIZE // 4, SIZE // 4, NC) and lo.dtype == torch.float32
    _close(_np(lo), want["f32"])
    _close(_np(full), JC.resize(jnp.asarray(want["f32"]), (SIZE, SIZE)))
    assert float(lo.max()) <= 0.0 and float(lo.min()) >= math.log(1e-6) - 1e-6


def test_bf16_forward_within_twice_jax_bf16(m2f):
    _, _, sd, x, _, want = m2f
    port = _port(sd, torch.bfloat16)
    with torch.no_grad():
        got = _np(port(torch.from_numpy(x), resize_output=False))
    err = np.abs(got - want["f32"]).max()
    err_jax = np.abs(want["bf16"] - want["f32"]).max()
    assert np.isfinite(got).all() and 0 < err <= 2 * err_jax, (err, err_jax)


def test_ce_dice_gradients_match_jax(m2f):
    """The CE + dice loss of the training forward (head resolution, the
    fused upsample's plain version) and every parameter's gradient, each
    within 1e-4 of its largest JAX entry; the attention's key biases, whose
    gradient is zero in exact arithmetic (a softmax does not see a shift
    common to a query's logits), are rounding noise on both sides, under
    1e-6 of the model's largest gradient entry."""
    jm, variables, sd, x, lab, _ = m2f

    def loss_fn(params):
        lo = jm.apply({"params": params}, jnp.asarray(x), train=True, resize_output=False)
        return jsteps.compute_loss(lo, jnp.asarray(lab), 255, "ce", True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = convert.from_jax_variables({"params": want_grads})
    port = _port(sd).train()
    logits = port(torch.from_numpy(x), resize_output=False, noise=no_noise(port, 2))
    loss = compute_loss(logits, torch.from_numpy(lab), 255, "ce", True)
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    assert set(names) == set(want)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, g in zip(names, grads):
        w = want[name].numpy()
        if name.endswith("attn.k.bias"):
            assert max(np.abs(w).max(), float(g.abs().max())) <= 1e-6 * top, name
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=REL * np.abs(w).max(),
                                   err_msg=name)


def test_init_keeps_the_head_own_inits():
    """``build_model``'s seeded init leaves MSDeformAttn's zero offset and
    weight kernels and its point-grid bias as the JAX init makes them, and
    draws the embeddings from normal(1.0); GroupNorms start at scale 1,
    bias 0; every other Linear is drawn (no zero kernel left)."""
    model = build_model("mit_b0", "mask2formerhead", NC, dtype=torch.float32, device="cpu",
                        head_kwargs=HK, seed=3)
    jm = JMS.MSDeformAttn(dim=256, n_levels=3, n_heads=8, n_points=4, dtype=jnp.float32)
    query, ref, value = _attn_inputs(13, dim=256, q=4)
    jp = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a, LEVELS))(query, ref, value)
    jp = jp["params"]
    head = model.decode_head
    for layer in head.pixel_decoder.encoder:
        att = layer.self_attn
        for name in ("sampling_offsets", "attention_weights"):
            lin = getattr(att, name)
            np.testing.assert_array_equal(lin.weight.detach().numpy().T, jp[name]["kernel"])
            np.testing.assert_array_equal(lin.bias.detach().numpy(), jp[name]["bias"])
        assert att.value_proj.weight.abs().min() >= 0 and att.value_proj.weight.std() > 0
    embeds = [head.pixel_decoder.level_embed, head.transformer_decoder.level_embed,
              head.transformer_decoder.query_feat, head.transformer_decoder.query_embed]
    drawn = torch.cat([e.detach().reshape(-1) for e in embeds])
    assert 0.9 < float(drawn.std()) < 1.1 and abs(float(drawn.mean())) < 0.1
    for mod in head.modules():
        if isinstance(mod, GroupNorm):
            assert torch.equal(mod.weight, torch.ones_like(mod.weight))
            assert torch.equal(mod.bias, torch.zeros_like(mod.bias))
        if isinstance(mod, torch.nn.Linear) and not getattr(mod, "keep_init", False):
            assert float(mod.weight.detach().abs().max()) > 0
    again = build_model("mit_b0", "mask2formerhead", NC, dtype=torch.float32, device="cpu",
                        head_kwargs=HK, seed=3)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------- entry points


def _tiny_cfg(out):
    return config.TrainConfig(
        model=config.ModelConfig(backbone="mit_b0", head="mask2formerhead", num_classes=4,
                                 compute_dtype="float32"),
        data=config.DataConfig(dataset="synthetic", img_size=32, batch_size=4, val_batch_size=4,
                               num_workers=2),
        optim=config.OptimConfig(lr=1e-3, epochs=1, warmup_steps=1),
        output_dir=str(out), print_freq=1)


def test_trainer_fits_and_resumes_mask2former(tmp_path):
    """The Trainer with ``model.head = "mask2formerhead"`` (its default
    depth: 6 pixel-decoder layers, 9 decoder layers, 100 queries): one
    epoch of 2 steps on the CE + dice path, the whole-image eval, a
    checkpoint, and a second Trainer resuming it with the same weights."""
    cfg = _tiny_cfg(tmp_path)
    data = (Synthetic(4, size=32, length=8, seed=0), Synthetic(4, size=32, length=4, seed=1))
    a = tloop.Trainer(cfg, *data, device="cpu")
    best = a.fit(1)
    (line,) = [json.loads(s) for s in open(a.results_path)]
    assert a.step == 2 and math.isfinite(line["train_loss"]) and 0 <= line["mIoU"] <= 100
    assert int(a.optimizer.count) == 2
    b = tloop.Trainer(cfg, *data, device="cpu")
    assert b.step == 2 and b.best == best
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k


def test_train_and_validate_clis_take_the_head(tmp_path, monkeypatch):
    """``train.main --head mask2formerhead`` trains and checkpoints;
    ``validate.main`` with the same head scores that checkpoint (the
    float32 CLI, synthetic images of 32²)."""
    monkeypatch.setitem(datasets.DATASETS, "synthetic",
                        (functools.partial(datasets.Synthetic, size=32, length=4, seed=1), 4))
    monkeypatch.setattr(validate, "DTYPE", torch.float32)
    out = tmp_path / "run"
    train.main(["--dataset", "synthetic", "--backbone", "mit_b0", "--head", "mask2formerhead",
                "--img-size", "32", "--batch-size", "4", "--epochs", "1", "--warmup-steps", "1",
                "--workers", "2", "--output-dir", str(out), "--device", "cpu"])
    (line,) = [json.loads(s) for s in open(out / "results.jsonl")]
    assert line["steps"] == 1 and math.isfinite(line["train_loss"])
    m = validate.main(["--dataset", "synthetic", "--backbone", "mit_b0", "--head",
                       "mask2formerhead", "--nb-classes", "4", "--img-size", "32",
                       "--batch-size", "2", "--workers", "2", "--ckpt", str(out / "ckpt"),
                       "--device", "cpu"])
    assert m["hist"].sum() == 4 * 32 * 32
