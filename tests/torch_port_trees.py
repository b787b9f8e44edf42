"""Parameter trees in the JAX package's layout, filled from numpy, and one
model's forward through both packages, for the port's parity tests.

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


def random_clouds(rng, counts, D, span):
    """Integer coordinates of len(counts) clouds: counts[b] distinct rows in
    [0, span)^D each, in random order."""
    out = []
    for n in counts:
        c = np.unique(rng.randint(0, span, (3 * n, D)), axis=0)
        rng.shuffle(c)
        assert len(c) >= n
        out.append(c[:n].astype(np.int32))
    return out


def jax_grids(clouds, cap):
    """The clouds as one batched JAX ``Grid`` [B, cap, D] (padding far out)."""
    from deepglobalregistration_tpu.ops.sparse_grid import Grid

    coords = np.full((len(clouds), cap, clouds[0].shape[1]), 32766, np.int32)
    for b, c in enumerate(clouds):
        coords[b, :len(c)] = c
    return Grid(jax.numpy.asarray(coords),
                jax.numpy.asarray([len(c) for c in clouds], jax.numpy.int32))


def port_grid(clouds):
    """The clouds as the port's batched grid [sum N, 1 + D] (column 0 = b)."""
    import torch

    return torch.cat([torch.cat([torch.full((len(c), 1), b, dtype=torch.int64),
                                 torch.from_numpy(c).long()], 1)
                      for b, c in enumerate(clouds)])


def forward_both(name, D=3, counts=(300, 260), span=14, cap=512, seed=0,
                 conv1_kernel_size=3, out_channels=8, jax_fold=False,
                 port_fold=False):
    """One model's f32 forward in both packages on the same random clouds,
    features and ``numpy_tree`` weights (level shrink 1 so that no JAX level
    truncates). BN is live unless ``jax_fold`` / ``port_fold`` runs that
    package's ``fold_batch_norms`` first. Returns (port rows, JAX rows), each
    [sum N, C]."""
    import torch

    from deepglobalregistration_tpu.models import load_model as jload
    from deepglobalregistration_tpu_torch.models import load_model
    from deepglobalregistration_tpu_torch.models.unet_plan import build_unet_plan
    from deepglobalregistration_tpu_torch.utils import convert

    rng = np.random.RandomState(seed)
    clouds = random_clouds(rng, counts, D, span)
    feats = [rng.rand(n, 1).astype(np.float32) for n in counts]
    kw = dict(conv1_kernel_size=conv1_kernel_size, normalize_feature=True, D=D)
    jspec = jload(name)
    jcfg = jspec.make_config(1, out_channels, **kw)
    params, state = numpy_tree(jspec, jcfg, rng)
    jparams, jstate = params, state
    if jax_fold:
        from deepglobalregistration_tpu.utils.fold_bn import fold_batch_norms

        jparams, jstate, jcfg = fold_batch_norms(params, state, jcfg)
    padded = np.zeros((len(counts), cap, 1), np.float32)
    for b, f in enumerate(feats):
        padded[b, :len(f)] = f

    @jax.jit
    def forward(grids, x):
        plan = jax.vmap(jspec.build_plan, in_axes=(0, None, None))(grids, jcfg, 1)
        return jspec.apply(jparams, jstate, jcfg, plan, x, train=False)[0], plan.overflow

    out, overflow = forward(jax_grids(clouds, cap), jax.numpy.asarray(padded))
    assert not np.any(np.asarray(overflow))
    ref = np.concatenate([np.asarray(out[b])[:n] for b, n in enumerate(counts)])

    spec = load_model(name)
    cfg = spec.make_config(1, out_channels, **kw)
    if port_fold:
        from deepglobalregistration_tpu_torch.utils.fold_bn import fold_batch_norms

        params, state, cfg = fold_batch_norms(params, state, cfg)
    net = spec.module(cfg)
    net.load_state_dict(convert.from_jax_params(params, state, cfg))
    plan = build_unet_plan(port_grid(clouds), len(counts), conv1_kernel_size,
                           cfg.region_type, cfg.levels, with_pooling=cfg.with_pooling)
    got = net(plan, torch.from_numpy(np.concatenate(feats))).numpy()
    return got, ref
