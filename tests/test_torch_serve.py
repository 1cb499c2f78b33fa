"""The serving slice as a whole against the JAX package, on the CPU: model
logits, ``predict_step`` label maps and ``eval_step`` confusion matrices on
the same weights, the weights bridge both ways, the predictor, and the
port's independence from JAX.

Tolerances: logits 1e-4 (float32 through a whole MiT-B0 + head, sums
ordered differently); label maps equal except at pixels whose top-2 logit
gap is under 1e-4, where that reordering may flip the argmax.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu import infer as jinfer
from segmentation_factory_tpu import metrics as jmetrics
from segmentation_factory_tpu.convert import convert_full_model
from segmentation_factory_tpu.engine import steps as jsteps
from segmentation_factory_tpu.engine.state import TrainState
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu_torch import build_model
from segmentation_factory_tpu_torch.convert import from_jax_variables
from segmentation_factory_tpu_torch.engine import eval_step, predict_step
from segmentation_factory_tpu_torch.infer import SemSeg, postprocess
from segmentation_factory_tpu_torch.metrics import compute_metrics

from _torch_port import random_state_dict, two_torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "segmentation_factory_tpu_torch"
NC = 5
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GAP = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(port model, its numpy state_dict, JAX model, JAX variables) on the
    same weights: MiT-B0 + SegFormerHead, float32."""
    port = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu",
                        fused_blocks=False)
    sd = random_state_dict(port, seed=0)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    variables = convert_full_model(sd, "mit_b0", "segformerhead")
    jmodel = jax_build_model("mit_b0", "segformerhead", NC, dtype=jnp.float32)
    return port, sd, jmodel, variables


def _batch(seed=1, size=64):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    label = rng.integers(0, NC, (2, size, size)).astype(np.int32)
    label[:, :4] = 255  # ignored rows
    label[0, -2:] = NC + 3  # out-of-range labels count nowhere
    return image, label


def _jax_state(jmodel, variables):
    return TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                      batch_stats=variables["batch_stats"], opt_state=None,
                      apply_fn=jmodel.apply, tx=None)


def _near_tie(logits):
    top = np.sort(logits, axis=-1)
    return (top[..., -1] - top[..., -2]) < GAP


def test_logits_match_jax(pair):
    port, _, jmodel, variables = pair
    image, _ = _batch()
    fwd = jax.jit(lambda v, x, r: jmodel.apply(v, x, train=False, resize_output=r),
                  static_argnums=2)
    with torch.no_grad():
        for resize_output in (True, False):
            got = port(torch.from_numpy(image), resize_output=resize_output)
            want = np.asarray(fwd(variables, jnp.asarray(image), resize_output))
            assert got.shape == want.shape and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_predict_and_eval_steps_match_jax(pair):
    port, _, jmodel, variables = pair
    state = _jax_state(jmodel, variables)
    image, label = _batch()
    want = np.asarray(jax.jit(jsteps.predict_step)(state, jnp.asarray(image)))
    got = predict_step(port, image)
    assert got.dtype == torch.int32 and got.shape == (2, 64, 64)
    logits = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(image)))
    ties = _near_tie(logits)
    assert ties.mean() < 1e-3
    np.testing.assert_array_equal(got.numpy()[~ties], want[~ties])

    hist0 = jnp.zeros((NC, NC), jnp.uint32)
    want_hist = np.asarray(jax.jit(jsteps.eval_step)(
        state, {"image": jnp.asarray(image), "label": jnp.asarray(label)}, hist0))
    hist = eval_step(port, {"image": image, "label": label},
                     torch.zeros((NC, NC), dtype=torch.int64))
    # each flipped near-tie pixel moves one count between two cells
    assert np.abs(hist.numpy() - want_hist.astype(np.int64)).sum() <= 2 * ties.sum()
    valid = (label < NC).sum()
    assert int(hist.sum()) == valid
    if not ties.any():
        np.testing.assert_array_equal(hist.numpy(), want_hist)
    np.testing.assert_equal(compute_metrics(want_hist), jmetrics.compute_metrics(want_hist))


def test_from_jax_variables_round_trip(pair):
    port, sd, jmodel, variables = pair
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    # the other direction: JAX's own initialisation carried into the port
    image, _ = _batch(seed=2)
    key = jax.random.PRNGKey(3)
    init = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        {"params": key, "dropout": key, "droppath": key}, jnp.zeros((1, 64, 64, 3)))
    init = jax.tree_util.tree_map(np.asarray, dict(init))
    fresh = build_model("mit_b0", "segformerhead", NC, dtype=torch.float32, device="cpu",
                        fused_blocks=False)
    fresh.load_state_dict(from_jax_variables(init))
    with torch.no_grad():
        got = fresh(torch.from_numpy(image))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(init, jnp.asarray(image))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_semseg_predicts_on_cpu(pair):
    port, sd, _, _ = pair
    seg = SemSeg("mit_b0", "segformerhead", NC, state_dict=port.state_dict(),
                 img_size=64, dtype=torch.float32, device="cpu")
    image_u8 = np.random.default_rng(4).integers(0, 255, (50, 90, 3)).astype(np.uint8)
    mask, over = seg.predict(image_u8)
    assert mask.shape == (50, 90) and mask.dtype == np.int32
    assert over.shape == (50, 90, 3) and over.dtype == np.uint8
    assert mask.min() >= 0 and mask.max() < NC
    # postprocess (a downsample here) against the JAX function on the same logits
    logits = np.random.default_rng(5).normal(size=(1, 96, 160, NC)).astype(np.float32)
    np.testing.assert_array_equal(postprocess(torch.from_numpy(logits), (50, 90)),
                                  jinfer.postprocess(jnp.asarray(logits), (50, 90)))


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("mit_b0", "segformerhead", NC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemSeg("mit_b0", "segformerhead", NC)


# the machine with the card has none of these: the port reads files without
# PIL (data/png.py) and h5py (data/hdf5.py)
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "segmentation_factory_tpu", "h5py",
              "PIL")


def _package_modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def test_import_scan_covers_the_zoo():
    """The scans below walk every module of the package, the zoo's newer
    families among them."""
    names = {name for name, _ in _package_modules()}
    zoo = "segmentation_factory_tpu_torch.models."
    assert {zoo + m for m in ("backbones.metaformer", "backbones.resnet",
                              "backbones.convnextv2", "heads.deeplabv3")} <= names


def test_package_imports_no_jax_ast():
    bad = []
    for name, path in [*_package_modules(), ("chip_smoke", REPO / "chip_smoke.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            roots = []
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                roots = [node.module.split(".")[0]]
            bad += [(name, r) for r in roots if r in _FORBIDDEN]
    assert not bad


def test_package_imports_no_jax_at_runtime():
    mods = [name for name, _ in _package_modules()]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m.split('.')[0] in "
        + repr(_FORBIDDEN) + "]\n"
        + "print(len(sys.modules)); assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
