"""Helpers of the port's parity tests: JAX weights, perturbed so that BN
folding and eps matter, carried into a port module."""

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
