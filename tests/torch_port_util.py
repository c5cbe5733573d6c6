"""Helpers of the port's parity tests: JAX weights, perturbed so that BN
folding and eps matter, carried into a port module."""

import contextlib

import jax
import numpy as np
from flax import traverse_util

from tscd_torch.utils.convert import state_dict_from_flax


def perturb(variables, seed=0):
    """Random BN statistics, scales and biases on top of a flax init."""
    rng = np.random.default_rng(seed)
    out = {}
    for coll, tree in variables.items():
        flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, tree))
        new = {}
        for k, v in flat.items():
            if k[-1] in ("mean", "bias"):
                v = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k[-1] in ("var", "scale"):
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            new[k] = v
        out[coll] = traverse_util.unflatten_dict(new)
    return out


def carry(jmod, pmod, *init_args, **init_kw):
    """Initialises the JAX module, perturbs it and loads the same weights
    into the port module; returns the JAX variables."""
    init = jax.jit(lambda key: jmod.init(key, *init_args, **init_kw))
    variables = perturb(init(jax.random.PRNGKey(0)))
    pmod.load_state_dict(state_dict_from_flax(variables, pmod.state_dict()))
    return variables


def seeded_variables(jmod, seed, *init_args, **init_kw):
    """Variables of the flax module `jmod` without compiling its init: the
    tree from jax.eval_shape, then seeded values, kernels normal with
    variance 1/fan_in (flax's lecun-normal, untruncated), biases and BN
    means N(0, 0.1), scales and BN variances U(0.5, 1.5) (as `perturb`)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *init_args, **init_kw))
    rng = np.random.default_rng(seed)
    out = {}
    for coll, tree in shapes.items():
        new = {}
        for k, s in traverse_util.flatten_dict(tree).items():
            if k[-1] == "kernel":
                v = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
            elif k[-1] in ("mean", "bias"):
                v = rng.normal(0, 0.1, s.shape)
            elif k[-1] in ("var", "scale"):
                v = rng.uniform(0.5, 1.5, s.shape)
            else:
                raise ValueError(f"no seeded init for {k}")
            new[k] = v.astype(np.float32)
        out[coll] = traverse_util.unflatten_dict(new)
    return out


def labels_near(rng, boxes, n_frames, num_classes, slots=8, size=128):
    """(n_frames, slots, 5) [cls, cx, cy, w, h] gts: on each frame f <
    len(boxes), one near each of boxes[f] ((k, 4) xyxy proposals: centres
    a pixel or two off, sizes 10-40% larger, so that the refined losses
    see fg and no IoU sits on a kink of its loss), then 1-4 random ones
    a frame."""
    lab = np.zeros((n_frames, slots, 5), np.float32)
    for f in range(n_frames):
        rows = []
        if f < len(boxes):
            b = np.asarray(boxes[f], np.float64)
            c = np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], -1)
            c[:, :2] += rng.uniform(-2, 2, c[:, :2].shape)
            c[:, 2:] *= rng.uniform(1.1, 1.4, c[:, 2:].shape)
            rows += list(c)
        for _ in range(int(rng.integers(1, slots - len(rows) + 1))):
            rows.append(np.concatenate([rng.uniform(12, size - 12, 2), rng.uniform(10, 80, 2)]))
        for i, r in enumerate(rows[:slots]):
            lab[f, i] = np.concatenate([[rng.integers(0, num_classes)], r])
    return lab


def _pairwise_stats(x, axes, dtype, axis_name=None, axis_index_groups=None,
                    use_mean=True, use_fast_variance=True, mask=None,
                    force_float32_reductions=True):
    """flax's `_compute_stats` (normalization.py) for the case BatchNorm
    runs: fp32, mean and fast variance E[x^2] - E[x]^2 floored at 0, each
    mean a tree of sums of 8 (zeros padded to a power of 8, then cut by 8
    at each level), no mask, no axis name."""
    import jax.numpy as jnp
    assert use_mean and use_fast_variance and mask is None and axis_name is None
    x = x.astype(jnp.float32)
    axes = tuple(a % x.ndim for a in (axes if isinstance(axes, (tuple, list)) else (axes,)))
    keep = [a for a in range(x.ndim) if a not in axes]
    flat = jnp.transpose(x, list(axes) + keep).reshape((-1,) + tuple(x.shape[a] for a in keep))
    n = flat.shape[0]
    size = 8 ** int(np.ceil(np.log(n) / np.log(8) - 1e-9))

    def mean(v):
        # each level behind an optimization barrier: XLA would fold a
        # reduce of a reduce into one reduce, in its own order
        v = jnp.concatenate([v, jnp.zeros((size - n,) + v.shape[1:], v.dtype)])
        while v.shape[0] > 1:
            v = jax.lax.optimization_barrier(v.reshape((8, v.shape[0] // 8) + v.shape[1:]).sum(0))
        return v[0] / n
    mu, mu2 = mean(flat), mean(flat * flat)
    return mu, jnp.maximum(0.0, mu2 - mu * mu)


@contextlib.contextmanager
def pairwise_batch_stats():
    """A context in which flax's BatchNorm sums its batch statistics
    in a tree of 8-way sums (`_pairwise_stats`), near torch's accuracy,
    instead of in XLA:CPU's order. XLA's fp32 means err by about 1e-6 of their value,
    and the fast variance turns that into up to 2e-4 of a channel's
    variance where its mean is ten times its spread (noise frames through
    the stem); the tree's means are ten times closer to float64's.
    Jit inside it: a trace made outside keeps XLA's sums."""
    from flax.linen import normalization
    orig = normalization._compute_stats
    normalization._compute_stats = _pairwise_stats
    try:
        yield
    finally:
        normalization._compute_stats = orig


def seeded_tree(jmod, seed, *init_args, **init_kw):
    """`seeded_like` over the flax module's variables (from jax.eval_shape
    of its init)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *init_args, **init_kw))
    return seeded_like(shapes, seed)


def seeded_like(shapes, seed):
    """Seeded values for a {'params', 'batch_stats'} tree of arrays or
    shapes, as `seeded_variables` draws them and for the other backbones'
    leaves too, in fp32: kernels normal with variance 1/fan_in, biases and
    BN means N(0, 0.1), scales, BN variances and FocalNet's layerscale
    gammas U(0.5, 1.5) (so that the residual branches weigh in), Swin's
    relative-position tables N(0, 1) (so that a wrong offset shows)."""
    rng = np.random.default_rng(seed)
    out = {}
    for coll, tree in shapes.items():
        new = {}
        for k, s in traverse_util.flatten_dict(tree).items():
            normal = rng.standard_normal(s.shape, np.float32)
            if k[-1] == "kernel":
                v = normal / np.float32(np.sqrt(np.prod(s.shape[:-1])))
            elif k[-1] in ("mean", "bias"):
                v = normal * np.float32(0.1)
            elif k[-1] in ("var", "scale", "gamma_1", "gamma_2"):
                v = rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
            elif k[-1] == "relative_position_bias_table":
                v = normal
            else:
                raise ValueError(f"no seeded init for {k}")
            new[k] = v
        out[coll] = traverse_util.unflatten_dict(new)
    return out


def assert_close(got, want, what, tol=1e-4):
    """got within `tol` of want's largest absolute value (shapes equal)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), f"{what}: {err} of {np.abs(want).max()}"
