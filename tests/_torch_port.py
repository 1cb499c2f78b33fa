"""Shared helpers of the tests/test_torch_*.py parity tests: seeded numpy
weights for a port module, carried to both frameworks; float32 closeness
of outputs and gradient trees."""

import functools

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


def rel_close(got, want, rel=1e-4):
    """``got`` within ``rel`` of the largest magnitude of ``want``."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


def jit_apply(module, variables, *args, **kwargs):
    """``module.apply`` compiled (an eager flax apply dispatches op by op)."""
    import jax

    return jax.jit(functools.partial(module.apply, **kwargs))(variables, *args)


def jax_vjp(module, variables, x, cts, record=None, **kwargs):
    """``module.apply(variables, x, **kwargs)``'s outputs and the gradients
    of sum(out_i * ct_i) with respect to the params and x, in one compiled
    call: (outputs, d params, d x, extras) as numpy. ``extras``: the
    updated collections where ``kwargs`` has ``mutable``, and the values
    that the apply appended to the list ``record`` (e.g. dropout masks)."""
    import jax
    import jax.numpy as jnp

    def f(params, x):
        if record is not None:
            record.clear()
        out = module.apply({**variables, "params": params}, x, **kwargs)
        state = None
        if kwargs.get("mutable"):
            out, state = out
        outs = out if isinstance(out, (list, tuple)) else [out]
        total = sum(jnp.sum(o * c) for o, c in zip(outs, cts))
        return total, (out, state, list(record or []))

    (_, (out, state, rec)), (gp, gx) = jax.jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return as_np(out), as_np(gp), np.asarray(gx), {"state": as_np(state), "record": as_np(rec)}


def torch_vjp(module, x, cts, *args, **kwargs):
    """The port's counterpart of ``jax_vjp``: (outputs, {key: d param} as
    numpy under the ``state_dict`` keys, d x)."""
    xt = torch.from_numpy(np.array(x)).requires_grad_()
    out = module(xt, *args, **kwargs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    total = sum((o.float() * torch.from_numpy(np.asarray(c))).sum() for o, c in zip(outs, cts))
    names = [n for n, p in module.named_parameters() if p.requires_grad]
    params = [p for p in module.parameters() if p.requires_grad]
    grads = torch.autograd.grad(total, params + [xt], allow_unused=True)
    gp = {n: (np.zeros(tuple(p.shape), np.float32) if g is None else g.numpy())
          for n, p, g in zip(names, params, grads[:-1])}
    return [o.detach().numpy() for o in outs], gp, grads[-1].numpy()


def trees_close(got, want, rel=1e-3, of_largest=0.0):
    """Every leaf of ``got`` within ``rel`` of the largest entry of its
    ``want`` leaf (the same tree structure, numpy leaves), plus
    ``of_largest`` of the largest entry of all of ``want``."""
    import jax

    paths_g = jax.tree_util.tree_flatten_with_path(got)[0]
    want_d = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(paths_g) == len(want_d), (len(paths_g), len(want_d))
    floor = of_largest * max(float(np.abs(np.asarray(w)).max()) for w in want_d.values())
    for path, g in paths_g:
        w = np.asarray(want_d[path], np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32).reshape(w.shape), w, rtol=0,
                                   atol=rel * np.abs(w).max() + floor + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))
