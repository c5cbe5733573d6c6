"""Chains bench.py:section_train's step at its _TINY shape (depth 0.33,
width 0.25, P = 20, 2 + 2 frames, 128 px, its seeded frames and six
boxes a frame, a constant LR of 0.01, the backbone frozen and its
gradient stopped, fix_bn) for a number of steps on the CPU: JAX at fp32
and at bf16, and the port at fp32 and at bf16, all four from the same
fp32 weights (bench's flax init, PRNGKey(0)) and on the same window,
each step's state the one before it returned, as bench's donated chain.
JAX's bf16 attention is its Pallas kernel in interpret mode, as on its
TPU (see tests/test_torch_port_train_bf16.py).

Prints one JSON line: each run's loss terms a step and the largest
|trained parameter| after it, and the port's distance from JAX at each
dtype a step.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_port_chained_steps.py [--steps 10]
"""

import argparse
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tscd_tpu.models import aggregation as jagg
from tscd_tpu.models.tscd import TSCD as JTSCD
from tscd_tpu.ops.pallas import fused_attention as jfa
from tscd_tpu.train.ema import ema_update as jema
from tscd_tpu.train.losses import tscd_loss as jloss
from tscd_tpu.train.optim import build_sgd
from tscd_tpu.train.step import init_train_state as jinit_state
from tscd_torch.models.tscd import TSCD
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.train.optim import GroupedSGD
from tscd_torch.train.step import init_train_state, train_step
from tscd_torch.utils.convert import state_dict_from_flax

H = 128
L, F = 2, 4                    # bench.py:443 at _TINY
NUM_CLASSES, DEPTH, WIDTH, P, HEADS = 30, 0.33, 0.25, 20, 4
STRIDES = (8, 16, 32)
LR = 0.01
FREEZE = ("backbone",)


class _TPUBackend:
    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@contextlib.contextmanager
def on_the_tpu_path():
    """JAX's attention call site takes its Pallas kernel (interpret mode)."""
    saved = jagg.jax, jfa.fused_dual_attention
    fused = jfa.fused_dual_attention
    jagg.jax = _TPUBackend()
    jfa.fused_dual_attention = lambda *a, scale=25.0: fused(*a, scale, True)
    try:
        yield
    finally:
        jagg.jax, jfa.fused_dual_attention = saved


def bench_inputs():
    """bench.py:445-457 at _TINY."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (F, H, H, 3)).astype(np.float32)
    te = np.asarray(get_timing_signal_1d(np.arange(F, dtype=np.float32), 256), np.float32)
    labels = np.zeros((F, 40, 5), np.float32)
    for f in range(F):
        for g in range(6):
            wh = rng.uniform(12, 48, 2)
            cxy = rng.uniform(wh / 2, H - wh / 2)
            labels[f, g] = [rng.integers(0, 30), *cxy, *wh]
    return x, te, labels


def jax_model(dtype):
    return JTSCD(num_classes=NUM_CLASSES, depth=DEPTH, width=WIDTH, num_proposals=P,
                 heads=HEADS, dtype=dtype, stop_backbone_grad=True)


def jax_chain(variables, x, te, labels, dtype, steps):
    """bench.py:466-482's step (losses kept), jitted, chained."""
    model = jax_model(dtype)
    tx = build_sgd(lambda i: LR, freeze_prefixes=FREEZE)
    state = jinit_state(variables, tx)

    def step(s):
        def loss_fn(p):
            losses = jloss(model.apply({"params": p, "batch_stats": s.batch_stats},
                                       x, te, L, F - L, False), labels, STRIDES, L)
            return losses["total_loss"], losses
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(s.params)
        updates, opt_state = tx.update(grads, s.opt_state, s.params)
        params = optax.apply_updates(s.params, updates)
        ns = s.step + 1
        return s._replace(params=params, opt_state=opt_state,
                         ema_params=jema(s.ema_params, params, ns), step=ns), losses

    path = on_the_tpu_path() if dtype == jnp.bfloat16 else contextlib.nullcontext()
    rows, params = [], []
    with path:
        fn = jax.jit(step)
        for _ in range(steps):
            state, losses = fn(state)
            rows.append({k: float(v) for k, v in losses.items()})
            params.append({"params": jax.device_get(state.params)})
    return rows, params


def port_chain(sd32, x, te, labels, dtype, steps):
    model = TSCD(num_classes=NUM_CLASSES, depth=DEPTH, width=WIDTH, num_proposals=P,
                 heads=HEADS, stop_backbone_grad=True, device="cpu", dtype=dtype)
    model.load_state_dict(sd32)
    opt = GroupedSGD(model.named_parameters(), lambda i: LR, freeze_prefixes=FREEZE,
                     masters=sd32)
    st = init_train_state(model, opt)
    xt, tet, lt = (torch.as_tensor(a) for a in (x, te, labels))
    rows, params = [], []
    for _ in range(steps):
        losses = train_step(st, xt, lt, tet, L, F - L)
        rows.append({k: float(v) for k, v in losses.items()})
        params.append({k: v.detach().clone() for k, v in st.model_state().items()})
    return rows, params


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    x, te, labels = bench_inputs()
    variables = jax.jit(lambda: jax_model(jnp.float32).init(
        jax.random.PRNGKey(0), x, te, L, F - L))()
    variables = jax.device_get(variables)
    tmpl = TSCD(num_classes=NUM_CLASSES, depth=DEPTH, width=WIDTH, num_proposals=P,
                heads=HEADS, device="cpu").state_dict()
    sd32 = state_dict_from_flax(variables, tmpl)
    trained = [k for k in tmpl if not k.startswith("backbone") and "running_" not in k
               and not k.endswith("num_batches_tracked")]
    out = {"shape": "bench.py _TINY: depth 0.33 width 0.25 P 20, 2+2 frames, 128 px, LR 0.01",
           "steps": args.steps}
    port_params = {}
    for name, jdt, pdt in (("fp32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jrows, jparams = jax_chain(variables, x, te, labels, jdt, args.steps)
        prows, pparams = port_chain(sd32, x, te, labels, pdt, args.steps)
        jsd = [state_dict_from_flax({**p, "batch_stats": variables["batch_stats"]}, tmpl)
               for p in jparams]
        out[f"jax_{name}"] = [{"total_loss": r["total_loss"], "conf_loss": r["conf_loss"],
                               "max_trained_param": max(float(s[k].abs().max()) for k in trained)}
                              for r, s in zip(jrows, jsd)]
        out[f"port_{name}"] = [{"total_loss": r["total_loss"], "conf_loss": r["conf_loss"],
                                "max_trained_param": max(float(s[k].abs().max()) for k in trained)}
                               for r, s in zip(prows, pparams)]
        out[f"port_vs_jax_{name}_max_param_diff"] = [
            max(float((p[k].double() - j[k].double()).abs().max()) for k in trained)
            for p, j in zip(pparams, jsd)]
        port_params[name] = (jsd, pparams)
    out["jax_bf16_vs_fp32_max_param_diff"] = [
        max(float((a[k].double() - b[k].double()).abs().max()) for k in trained)
        for a, b in zip(port_params["bf16"][0], port_params["fp32"][0])]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
