"""The port's export (``segmentation_factory_tpu_torch.export``) against the
live port model and the JAX package, on the CPU.

One MiT-B1 + SegFormerHead (4 classes, 64², float32, the fused MiT
configuration) is exported once at a dynamic batch and loaded once for the
module. MiT-B1 and not MiT-B0: its stage 4 is 512 wide, so it runs per-op
as in config #5's MiT-B2 and the program holds all five forward ops (K3f
and K4f in the 6 blocks of stages 1-3, K1f and K2f in the 2 of stage 4, K5f
in the head); every MiT-B0 block is fused.

Tolerances: the program against the live port model within 1e-5 of the
largest logit (the same ops on the same CPU); against the JAX
``model.apply(train=False)`` within 1e-4 of it (float32 through the whole
network, sums ordered differently).
"""

import collections
import copy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_factory_tpu.convert import convert_full_model
from segmentation_factory_tpu.models import build_model as jax_build_model
from segmentation_factory_tpu_torch import build_model
from segmentation_factory_tpu_torch.export import export_model, load_exported, validate_export

from _torch_port import load_numpy, random_state_dict

REPO = Path(__file__).resolve().parents[1]
NC, SIZE = 4, 64
# the sft:: ops of one MiT-B1 + SegFormerHead forward, fused configuration
OPS = {"sft.attn_block_fwd.default": 6, "sft.ffn_block_fwd.default": 6,
       "sft.sra_attention_fwd.default": 2, "sft.mixffn_fwd.default": 2,
       "sft.resize_sum_fwd.default": 1}
# aten ops of a kernel's plain version that must not stand in for it
PLAIN_ONLY = ("softmax", "gelu", "einsum", "bmm", "scaled_dot_product_attention")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(port model, path of its .pt2, the loaded program's module, JAX
    forward) on the same weights."""
    port = build_model("mit_b1", "segformerhead", NC, dtype=torch.float32, device="cpu")
    sd = random_state_dict(port, seed=13)
    load_numpy(port, sd)
    path = str(tmp_path_factory.mktemp("export") / "mit_b1.pt2")
    export_model(port, SIZE, path)
    jmodel = jax_build_model("mit_b1", "segformerhead", NC, dtype=jnp.float32)
    variables = convert_full_model(sd, "mit_b1", "segformerhead")
    jfwd = jax.jit(lambda x: jmodel.apply(variables, x, train=False))
    return port, path, load_exported(path).module(), jfwd


def test_program_holds_the_kernels_ops(exported):
    _, path, program, _ = exported
    targets = collections.Counter(str(n.target) for n in program.graph.nodes
                                  if n.op == "call_function")
    assert {k: v for k, v in targets.items() if k.startswith("sft.")} == OPS
    assert not [t for t in targets if any(p in t for p in PLAIN_ONLY)]


@pytest.mark.parametrize("batch", [1, 3])
def test_program_matches_live_model_and_jax(exported, batch):
    port, _, program, jfwd = exported
    x = np.random.default_rng(batch).normal(size=(batch, SIZE, SIZE, 3)).astype(np.float32)
    with torch.inference_mode():
        got = program(torch.from_numpy(x)).numpy()
        live = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jfwd(jnp.asarray(x)))
    assert got.shape == want.shape == (batch, SIZE, SIZE, NC)
    np.testing.assert_allclose(got, live, rtol=0, atol=1e-5 * np.abs(live).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_program_loads_in_a_fresh_process(exported):
    """Only ``segmentation_factory_tpu_torch.export`` imported: loading
    registers the ops the program needs."""
    code = ("import torch\n"
            "from segmentation_factory_tpu_torch.export import load_exported\n"
            f"out = load_exported({exported[1]!r}).module()(torch.zeros(2, {SIZE}, {SIZE}, 3))\n"
            "print(tuple(out.shape), bool(torch.isfinite(out).all()))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[-2] == f"(2, {SIZE}, {SIZE}, {NC}) True"


def test_validate_export_passes_then_fails_on_changed_weights(exported):
    port, path, _, _ = exported
    ok, diff = validate_export(port, path, SIZE)
    assert ok and diff <= 1e-5
    changed = copy.deepcopy(port)
    with torch.no_grad():
        changed.decode_head.linear_pred.bias += 0.5
    ok, diff = validate_export(changed, path, SIZE)
    assert not ok and diff == pytest.approx(0.5, rel=1e-5)
