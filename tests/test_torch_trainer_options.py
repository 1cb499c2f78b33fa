"""The Trainer's options of the port against the JAX package on the CPU:
gradient accumulation against ``optax.MultiSteps`` under the JAX
``train_step`` (with a non-finite micro-step), finetune + freeze from a
reference ``.pth`` and from a port checkpoint directory against
``load_params_for_finetune``, the pretrained backbone against
``merge_backbone_pretrained``, remat (MobileNetV4 against the JAX
``remat=True`` model; MiT against the port without it, bit for bit),
``recalibrate_bn``, the plateau schedule in ``Trainer.fit`` and the CLI
flags of all of them.

Weights are numpy (``_torch_port.random_state_dict``) and reach the JAX
tree through the JAX package's converters; drop-path and dropout are off
(JAX rates 0, port factors and masks of ones) where the two are compared.
Tolerances: losses 1e-4 relative and parameters within 1e-5 of the
largest |p| after four SGD updates (reordered float32 sums in a MiT-B0,
amplified by four updates); MobileNetV4's loss 1e-5 relative, gradients
within 1e-2 of the largest gradient entry (this net's gradients are
ill-conditioned in float32: an input change of 1e-6 relative moves the
stem's by 4.6e-3 of that entry, on either framework alone; BatchNorm
biases that feed a BatchNorm have gradients that are 0 but for
rounding), running statistics within 1e-4 of each tensor's largest entry
(as in ``test_torch_mobilenetv4.py``); merged and loaded weights, frozen
parameters and remat against no remat exactly.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segmentation_factory_tpu import convert as JCV
from segmentation_factory_tpu import schedule as JS
from segmentation_factory_tpu.checkpoint import load_params_for_finetune
from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.engine.state import TrainState
from segmentation_factory_tpu.engine.state import create_optimizer as j_create_optimizer
from segmentation_factory_tpu.engine.state import recalibrate_bn as j_recalibrate_bn
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu_torch import build_model, config, schedule
from segmentation_factory_tpu_torch import train as tcli
from segmentation_factory_tpu_torch.checkpoint import CheckpointManager, load_pretrained_backbone
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.data.datasets import Synthetic
from segmentation_factory_tpu_torch.engine import (
    compute_loss,
    create_optimizer,
    recalibrate_bn,
    train_step,
)
from segmentation_factory_tpu_torch.engine import loop as tloop

from _torch_port import load_numpy, random_state_dict
from _torch_port import two_torch_threads  # noqa: F401  (autouse)

NC = 19
MIT_NO_NOISE = dict(backbone_kwargs={"drop_path_rate": 0.0}, head_kwargs={"dropout": 0.0})
MNV4 = ("mobilenetv4_small", "fpnhead")


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _batches(n, seed, nc, size=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lbl = rng.integers(0, nc, (2, size, size)).astype(np.int32)
        lbl[:, :4] = 255
        out.append((_normal(rng, (2, size, size, 3)), lbl))
    return out


def _ones(model, batch=2):
    noise = {"dropout": torch.ones((batch, model.decode_head.embed_dim))}
    if hasattr(model.backbone, "drop_path_factors"):
        noise["drop_path"] = torch.ones((len(model.backbone.blocks()), 2, batch))
    return noise


def _port(backbone, head, nc, sd, **kw):
    return load_numpy(build_model(backbone, head, nc, dtype=torch.float32, device="cpu", **kw), sd)


def _as_port(params, stats):
    return from_jax_variables({"params": params, "batch_stats": stats})


def _same_state(model, want, skip=("num_batches_tracked",)):
    for k, v in model.state_dict().items():
        if not k.endswith(skip):
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)


@pytest.fixture(scope="module")
def mit():
    """MiT-B0 + SegFormerHead weights as numpy and as JAX variables."""
    port = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu",
                       fused_blocks=False)
    sd = random_state_dict(port, seed=5)
    return sd, JCV.convert_full_model(sd, "mit_b0", "segformerhead")


@pytest.fixture(scope="module")
def mnv4():
    port = build_model(*MNV4, 2, dtype=torch.float32, device="cpu")
    sd = random_state_dict(port, seed=19)
    return sd, JCV.convert_full_model(sd, *MNV4)


# ---------------------------------------------------------- accumulation


def test_grad_accum_matches_multisteps(mit):
    """MiT-B0 at 64², batch 2, CE + dice, SGD (Nesterov, momentum 0.9,
    coupled L2 1e-4) behind the global-norm clip on a poly schedule, k = 2:
    nine micro-steps, the fourth non-finite, so four updates. The
    parameters move only at every second applied micro-step."""
    sd, variables = mit
    batches = _batches(9, 31, NC)
    batches[3][0][1, 7, 7, 0] = np.nan
    kw = dict(warmup_steps=1, warmup_lr_init=1e-3, min_lr=0.0, power=0.9)

    jm = jax_build_model("mit_b0", "segformerhead", NC, dtype=jnp.float32, **MIT_NO_NOISE)
    sched = JS.create_schedule("poly", 0.05, 4, **kw)
    tx = j_create_optimizer("sgd", sched, weight_decay=1e-4, momentum=0.9, clip_grad=1.0,
                            clip_mode="norm", params=variables["params"])
    tx = optax.MultiSteps(tx, every_k_schedule=2)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), apply_fn=jm.apply, tx=tx)
    step = jax.jit(functools.partial(jsteps.train_step, loss_type="ce", use_dice=True))
    want = []
    for img, lbl in batches:
        state, metrics = step(state, {"image": jnp.asarray(img), "label": jnp.asarray(lbl)},
                              jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))

    model = _port("mit_b0", "segformerhead", NC, sd, fused_blocks=False)
    opt = create_optimizer("sgd", schedule.create_schedule("poly", 0.05, 4, **kw),
                           weight_decay=1e-4, momentum=0.9, clip_grad=1.0, clip_mode="norm",
                           params=model.named_parameters(), grad_accum=2)
    first = {k: v.clone() for k, v in model.state_dict().items()}
    got, skipped, counts = [], [], []
    for i, (img, lbl) in enumerate(batches):
        out = train_step(model, opt, {"image": img, "label": lbl}, noise=_ones(model),
                         loss_type="ce", use_dice=True)
        got.append(float(out["loss"]))
        skipped.append(int(out["skipped_nonfinite"]))
        counts.append(int(opt.count))
        if i == 0:  # the first micro-step moves no parameter (its BatchNorm statistics do)
            for name, p in model.named_parameters():
                assert torch.equal(p, first[name]), name
    assert skipped == [0, 0, 0, 1, 0, 0, 0, 0, 0]
    assert counts == [0, 1, 1, 1, 2, 2, 3, 3, 4] and int(opt.mini_step) == 0
    assert np.isnan(got[3]) and np.isnan(want[3])
    ok = [i for i in range(9) if i != 3]
    np.testing.assert_allclose([got[i] for i in ok], [want[i] for i in ok], rtol=1e-4)
    want_sd = _as_port(state.params, state.batch_stats)
    scale = max(float(v.abs().max()) for v in want_sd.values())
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=0, atol=1e-5 * scale,
                                       err_msg=k)


# ------------------------------------------------------ finetune / freeze


def _tiny_cfg(out, epochs=1, **model):
    return config.TrainConfig(
        model=config.ModelConfig(backbone="mit_b0", head="segformerhead", num_classes=4,
                                 compute_dtype="float32", **model),
        data=config.DataConfig(dataset="synthetic", img_size=32, batch_size=8, val_batch_size=8,
                               num_workers=2),
        optim=config.OptimConfig(lr=3e-3, epochs=epochs, warmup_steps=2),
        output_dir=str(out), print_freq=1)


def _datasets():
    return (Synthetic(num_classes=4, size=32, length=16, seed=0),
            Synthetic(num_classes=4, size=32, length=8, seed=9))


def _jax_tree_drop(tree, path):
    *head, leaf = path
    for k in head:
        tree = tree[k]
    del tree[leaf]


@pytest.mark.parametrize("source", ["pth", "ckpt_dir"])
def test_finetune_and_freeze_match_jax(tmp_path, source):
    """The Trainer's fresh MiT-B0 (4 classes) finetuned from a 5-class
    model: a reference ``.pth`` (``model_state``-wrapped, one key missing,
    one of another shape) with freeze, or a port checkpoint directory (its
    best of two steps) without. The merged weights equal the JAX package's
    ``load_params_for_finetune``; after two steps under freeze every
    non-classifier parameter is bit-identical and the classifier moved."""
    src = build_model("mit_b0", "segformerhead", 5, dtype=torch.float32, device="cpu")
    sd_src = random_state_dict(src, seed=11)
    tree = JCV.convert_full_model(sd_src, "mit_b0", "segformerhead")
    if source == "pth":
        path = str(tmp_path / "src.pth")
        pth = {k: torch.from_numpy(np.array(v)) for k, v in sd_src.items()}
        del pth["backbone.block1.0.attn.q.bias"]
        pth["backbone.norm4.weight"] = torch.ones(7)
        _jax_tree_drop(tree["params"], ("backbone", "block1_0", "SRAttention_0", "q", "bias"))
        tree["params"]["backbone"]["norm4"]["scale"] = np.ones(7, np.float32)
        torch.save({"model_state": pth}, path)
        freeze = True
    else:
        path = str(tmp_path / "src_ckpt")
        mngr = CheckpointManager(path)
        opt = create_optimizer("adamw", lambda t: torch.tensor(1e-3),
                               params=src.named_parameters())
        load_numpy(src, sd_src)
        mngr.save(2, src, opt, {"mIoU": 3.0})  # the best
        with torch.no_grad():
            src.decode_head.linear_fuse.conv.weight.add_(1.0)
        mngr.save(4, src, opt, {"mIoU": 1.0})
        freeze = False

    fresh = build_model("mit_b0", "segformerhead", 4, dtype=torch.float32, device="cpu", seed=0)
    mine = JCV.convert_full_model({k: v.numpy() for k, v in fresh.state_dict().items()},
                                  "mit_b0", "segformerhead")
    params, trainable = load_params_for_finetune(mine["params"], tree["params"], freeze=freeze)
    stats, _ = load_params_for_finetune(mine["batch_stats"], tree["batch_stats"])

    cfg = _tiny_cfg(tmp_path / "run", finetune=path, freeze=freeze)
    t = tloop.Trainer(cfg, *_datasets(), device="cpu")
    _same_state(t.model, _as_port(params, stats))
    if not freeze:
        assert t.optimizer.trainable is None
        return
    leaves = jax.tree_util.tree_flatten_with_path(trainable)[0]
    want_trainable = sorted(jax.tree_util.keystr(path) for path, m in leaves if m)
    got_trainable = sorted(n for (n, _), m in zip(t.model.named_parameters(),
                                                  t.optimizer.trainable) if m)
    assert len(got_trainable) == len(want_trainable) == 2
    assert all("linear_pred" in n for n in got_trainable + want_trainable)
    before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    batch = next(iter(t.train_loader))
    for _ in range(2):
        assert int(t.train_step(batch)["skipped_nonfinite"]) == 0
    for n, p in t.model.named_parameters():
        if "linear_pred" in n:
            assert not torch.equal(p, before[n]), n
        else:
            assert torch.equal(p, before[n]), n
    assert int(t.optimizer.count) == 2


# --------------------------------------------------- pretrained backbone


def test_pretrained_backbone_matches_jax(tmp_path, mnv4):
    """MobileNetV4-S's backbone from a reference ``.pth`` (BatchNorm running
    statistics included, one scale of another shape): the loaded and
    skipped counts and the resulting weights equal the JAX package's
    ``merge_backbone_pretrained``."""
    sd, variables = mnv4
    model = _port(*MNV4, 2, sd)
    src = random_state_dict(model.backbone, seed=23)
    src["blocks.1.0.bn1.weight"] = np.ones(3, np.float32)
    path = str(tmp_path / "backbone.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in src.items()}, path)

    jtree = JCV.convert_backbone(JCV.load_torch_checkpoint(path), MNV4[0])
    params = jax.tree_util.tree_map(lambda x: x, variables["params"])
    stats = jax.tree_util.tree_map(lambda x: x, variables["batch_stats"])
    want_loaded, want_skipped = JCV.merge_backbone_pretrained(params, stats, jtree)

    loaded, skipped = load_pretrained_backbone(model, path)
    assert len(loaded) == len(want_loaded) > 100
    assert len(skipped) == len(want_skipped) == 1
    _same_state(model, _as_port(params, stats))


# ----------------------------------------------------------------- remat


def _loss_and_grads(model, img, lbl, noise):
    model.train()
    logits = model(torch.from_numpy(img), resize_output=False, noise=noise)
    loss = compute_loss(logits, torch.from_numpy(lbl), 255, "ce", True)
    params = [p for _, p in model.named_parameters()]
    return loss, torch.autograd.grad(loss, params)


def _bns(model):
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]


def test_remat_mobilenetv4_matches_jax(mnv4):
    """One step's loss, gradients and BatchNorm running statistics of
    MobileNetV4-S + FPNHead at 64² with the backbone checkpointed, against
    the JAX ``remat=True`` model's; the statistics are updated once (and
    equal the port's without remat bit for bit)."""
    sd, variables = mnv4
    img, lbl = _batches(1, 41, 2)[0]
    jm = jax_build_model(*MNV4, 2, dtype=jnp.float32, head_kwargs={"dropout": 0.0}, remat=True)

    def loss_fn(params):
        logits, new = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(img), train=True, resize_output=False,
                               rngs={"dropout": jax.random.PRNGKey(0),
                                     "droppath": jax.random.PRNGKey(0)},
                               mutable=["batch_stats"])
        loss = jsteps.compute_loss(logits, jnp.asarray(lbl), 255, "ce", True)
        return loss, new["batch_stats"]

    (want_loss, want_bs), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    want_grads = _as_port(want_g, variables["batch_stats"])
    want_stats = _as_port(variables["params"], want_bs)

    runs = {}
    for remat in (True, False):
        model = _port(*MNV4, 2, sd, remat=remat)
        loss, grads = _loss_and_grads(model, img, lbl, _ones(model))
        runs[remat] = (model, loss, grads)
    model, loss, grads = runs[True]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    bar = 1e-2 * max(float(want_grads[n].abs().max()) for n in names)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[n].numpy(), rtol=0, atol=bar, err_msg=n)
    plain = dict(_bns(runs[False][0]))
    for name, bn in _bns(model):
        assert int(bn.num_batches_tracked) == 1, name
        for key in ("running_mean", "running_var"):
            got, w = getattr(bn, key).numpy(), want_stats[f"{name}.{key}"].numpy()
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{name}.{key}")
            assert torch.equal(getattr(bn, key), getattr(plain[name], key)), name
    for g, h in zip(grads, runs[False][2]):
        torch.testing.assert_close(g, h, rtol=0, atol=0)


def test_remat_mit_is_the_step_without_it(mit):
    """MiT-B0 + SegFormerHead, one training forward and backward with
    random drop-path factors and dropout mask: with the backbone
    checkpointed, the loss, every gradient and the head's BatchNorm
    statistics equal those without, bit for bit."""
    sd, _ = mit
    img, lbl = _batches(1, 43, NC)[0]
    out = {}
    for remat in (False, True):
        model = _port("mit_b0", "segformerhead", NC, sd, fused_blocks=False, remat=remat)
        noise = model.sample_noise(2, torch.Generator().manual_seed(3))
        loss, grads = _loss_and_grads(model, img, lbl, noise)
        out[remat] = (loss, grads, model.state_dict())
    assert float(out[True][0]) == float(out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in out[False][2].items():
        torch.testing.assert_close(out[True][2][k], v, rtol=0, atol=0, msg=k)


# ------------------------------------------------------- recalibrate_bn


def test_recalibrate_bn_matches_jax(mnv4):
    """Two of three batches (``num_steps=2``) through the training forward:
    every running statistic against the JAX ``recalibrate_bn``; the
    parameters are untouched and the model stays in eval mode."""
    sd, variables = mnv4
    images = [img for img, _ in _batches(3, 47, 2)]
    jm = jax_build_model(*MNV4, 2, dtype=jnp.float32, head_kwargs={"dropout": 0.0})
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=(), apply_fn=jm.apply,
                       tx=optax.identity())
    state = j_recalibrate_bn(state, [jnp.asarray(x) for x in images], num_steps=2)
    want = _as_port(variables["params"], state.batch_stats)

    model = _port(*MNV4, 2, sd)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    recalibrate_bn(model, [{"image": x} for x in images], num_steps=2)
    assert not model.training
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]), n
    for name, bn in _bns(model):
        assert int(bn.num_batches_tracked) == 2, name
        for key in ("running_mean", "running_var"):
            w = want[f"{name}.{key}"].numpy()
            np.testing.assert_allclose(getattr(bn, key).numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(), err_msg=f"{name}.{key}")


# ------------------------------------------------------ plateau and CLI


def test_plateau_trainer_lowers_the_rate(tmp_path, monkeypatch):
    """Three epochs of ``fit`` on the plateau schedule with patience 0 and
    an mIoU that does not rise: the rate falls tenfold after the second and
    the third eval, and the third epoch's updates take the first fall."""
    cfg = _tiny_cfg(tmp_path, epochs=3)
    cfg.optim.sched = "plateau"
    cfg.optim.sched_kwargs = {"patience": 0, "factor": 0.1}
    t = tloop.Trainer(cfg, *_datasets(), device="cpu")
    metrics = {"mIoU": 5.0, "mF1": 5.0, "mAcc": 5.0, "aAcc": 5.0}
    monkeypatch.setattr(t, "evaluate", lambda: metrics)
    lrs = []
    real = t.train_step

    def step(batch):
        out = real(batch)
        lrs.append(float(out["lr"]))
        return out

    monkeypatch.setattr(t, "train_step", step)
    t.fit()
    lines = [json.loads(s) for s in open(t.results_path)]
    assert [ln["lr"] for ln in lines] == pytest.approx([3e-3, 3e-4, 3e-5])
    assert lrs == pytest.approx([3e-3] * 4 + [3e-4] * 2)
    assert float(t.optimizer.plateau_lr) == pytest.approx(3e-5)


def test_cli_runs_the_options(tmp_path, capsys):
    """``train.main`` on the synthetic set at 32², one epoch with
    ``--grad-accum 2 --remat --pretrained-backbone --finetune
    --freeze-layers --sched plateau --lr-noise --mesh 1,1`` (the plateau
    schedule takes no noise): one update every two steps, every backbone
    tensor loaded, and no parameter moved but the classifier's from the
    finetune ``.pth``."""
    src = build_model("mit_b0", "segformerhead", 8, dtype=torch.float32, device="cpu", seed=4)
    want = src.state_dict()
    full, backbone = str(tmp_path / "full.pth"), str(tmp_path / "mit_b0.pth")
    torch.save({"state_dict": want}, full)
    torch.save({k[len("backbone."):]: v for k, v in want.items() if k.startswith("backbone.")},
               backbone)
    out = tmp_path / "run"
    tcli.main(["--dataset", "synthetic", "--backbone", "mit_b0", "--img-size", "32",
               "--batch-size", "8", "--epochs", "1", "--warmup-steps", "1", "--workers", "2",
               "--print-freq", "4", "--device", "cpu", "--grad-accum", "2", "--remat",
               "--pretrained-backbone", backbone, "--finetune", full, "--freeze-layers",
               "--sched", "plateau", "--patience-epochs", "0", "--lr-noise", "1", "3",
               "--mesh", "1,1", "--output-dir", str(out)])
    assert "tensors loaded, 0 skipped" in capsys.readouterr().out
    (line,) = [json.loads(s) for s in open(out / "results.jsonl")]
    assert line["steps"] == 8 and line["lr"] == 1e-3
    state = torch.load(out / "ckpt" / "step_8.pt", weights_only=True)
    assert int(state["optimizer"]["count"]) == 4 and int(state["optimizer"]["mini_step"]) == 0
    for k, v in state["model"].items():
        if k.endswith(("weight", "bias")) and "linear_pred" not in k:
            assert torch.equal(v, want[k]), k
    assert not torch.equal(state["model"]["decode_head.linear_pred.weight"],
                           want["decode_head.linear_pred.weight"])
