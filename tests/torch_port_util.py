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


def _stats(tree, rng):
    return {key: _stats(value, rng) if hasattr(value, "items") else (
        (0.3 * rng.randn(*value.shape)) if key == "mean"
        else (0.5 + rng.rand(*value.shape))).astype(np.float32)
        for key, value in tree.items()}


def random_jax_variables(module, x, rng):
    """``{"params", "batch_stats"}`` of flax ``module`` for input ``x``:
    params as ``random_jax_params``, running means N(0, 0.3) and variances
    U(0.5, 1.5) (not the zeros and ones of a fresh model, which would hide a
    wrong mapping or an eval mode that reads the batch)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return {"params": _fill(shapes["params"], rng),
            "batch_stats": _stats(shapes.get("batch_stats", {}), rng)}


def transbts_channel_keep(jmodel, variables, x, rng_key):
    """The keep mask (N, 1, 1, 1, C) of the channel dropout that JAX's
    TransBTS encoder draws in a training apply with ``rngs={"dropout":
    rng_key}``: read off the input of ``EnBlock1`` (zero exactly on the
    dropped channels), caught with ``flax.linen.intercept_methods``."""
    from flax import linen as nn

    seen = []

    def catch(next_fun, args, kwargs, context):
        if context.module.name == "EnBlock1" and context.method_name == "__call__":
            seen.append(args[0])
        return next_fun(*args, **kwargs)

    @jax.jit
    def enblock1_input(v, x, key):
        with nn.intercept_methods(catch):
            jmodel.apply(v, x, train=True, mutable=["batch_stats"], rngs={"dropout": key})
        return seen[0]

    h = np.asarray(enblock1_input(variables, x, rng_key), np.float32)
    return (h != 0).any(axis=tuple(range(1, h.ndim - 1)), keepdims=True)
