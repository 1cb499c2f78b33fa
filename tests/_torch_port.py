"""Shared helpers of the tests/test_torch_*.py parity tests: seeded numpy
weights for a port module, carried to both frameworks."""

import numpy as np
import pytest
import torch


def random_state_dict(module: torch.nn.Module, seed: int) -> dict:
    """numpy float32 weights of ``module``'s shapes: kernels ~ N(0, 1/fan_in),
    biases ~ N(0, 0.1^2), norm scales ~ 1 + N(0, 0.1^2), running means
    ~ N(0, 0.1^2), running variances in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in module.state_dict().items():
        shape = tuple(t.shape)
        if key.endswith("num_batches_tracked"):
            out[key] = np.zeros((), np.int64)
        elif key.endswith("running_var"):
            out[key] = (0.5 + rng.random(shape)).astype(np.float32)
        elif key.endswith(("bias", "running_mean")):
            out[key] = (0.1 * rng.normal(size=shape)).astype(np.float32)
        elif len(shape) == 1:  # LayerNorm / BatchNorm scale
            out[key] = (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            out[key] = (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    return out


def load_numpy(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return module


def strip(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads for a module's tests (autouse where imported):
    the model-level parity tests run as fast on two as on eight alone, and
    under the suite's parallel workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
