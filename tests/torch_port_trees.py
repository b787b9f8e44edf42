"""Parameter trees in the JAX package's layout, filled from numpy, for the
port's parity tests.

The tree's structure comes from ``jax.eval_shape`` of the model's own
``init`` (traced, never compiled); its leaves come from a numpy RandomState:
kaiming fan-in kernels, BatchNorm scales and biases around identity, and
non-trivial running statistics. Drawing them with ``jax.random`` would
compile one program per leaf shape, tens of seconds on the CPU.
"""

import jax
import numpy as np


def numpy_tree(spec, cfg, rng, spread=0.2, stats=0.5):
    """(params, state) for ``spec.init(key, cfg)``'s tree, from ``rng``."""
    params, state = jax.eval_shape(lambda: spec.init(jax.random.PRNGKey(0), cfg))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            w = rng.randn(*shape) * np.sqrt(2.0 / (shape[0] * shape[1]))
        elif name == "weight":
            w = 1 + spread * rng.randn(*shape)
        elif name == "bias":
            w = 0.5 * spread * rng.randn(*shape)
        elif name == "mean":
            w = stats * rng.rand(*shape)
        elif name == "var":
            w = 1 + stats * rng.rand(*shape)
        else:
            raise KeyError(f"unexpected leaf {jax.tree_util.keystr(path)}")
        return w.astype(np.float32)

    return (jax.tree_util.tree_map_with_path(fill, params),
            jax.tree_util.tree_map_with_path(fill, state))
