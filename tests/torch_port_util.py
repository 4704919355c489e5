"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py)."""
import jax
import numpy as np


def _fill(tree, rng, path=()):
    """Random numpy params for a tree of shapes: kernels U(+-1/sqrt(fan_in)),
    norm scales near 1, biases and position embeddings near 0 (not the ones
    and zeros of the JAX initialisers, which would hide a wrong mapping)."""
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out[key] = _fill(value, rng, path + (key,))
            continue
        shape = value.shape
        if key == "kernel":
            core = shape[1:] if "attns" in path else shape  # vmap's modality axis
            arr = rng.uniform(-1, 1, shape) / np.sqrt(np.prod(core[:-1]))
        elif key == "scale":
            arr = 1 + 0.2 * rng.randn(*shape)
        else:
            arr = 0.2 * rng.randn(*shape)
        out[key] = arr.astype(np.float32)
    return out


def random_jax_params(module, x, rng):
    """Params of flax ``module`` for input ``x``, shaped by tracing (not
    compiling) its ``init`` with ``jax.eval_shape``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return _fill(shapes.get("params", {}), rng)
