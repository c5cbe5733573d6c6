"""YOLOv8 of the port (`models.yolov8`), its TAL assigner (`ops.tal`),
CIoU (`ops.boxes.ciou_xyxy`) and DFL loss (`train.v8_losses`) against the
JAX package on the CPU.

JAX's variables come from the module's shapes (`jax.eval_shape`, no init
compile) with seeded values (`torch_port_util.seeded_variables`); the
port's converter carries them into the port, whose names are JAX's flax
names one to one. JAX's side is jitted.

Tolerances: fp32 both sides, another summation order: each output within
1e-4 of its largest absolute value (TOL), each gradient within 1e-4 of
its largest absolute value; TAL's masks and matched gts exactly, its
scores within 1e-5; train-mode BN with JAX's batch statistics summed in
a tree (`torch_port_util.pairwise_batch_stats`), as the port's other
train-mode comparisons. bf16: the port's mean distance from the bf16 JAX
model within BF16_SPREAD x JAX's own bf16-to-fp32 mean distance (as
tests/test_torch_port_backbones.py holds whole bf16 networks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscd_tpu.models import yolov8 as jv8
from tscd_tpu.ops.boxes import ciou_xyxy as jciou
from tscd_tpu.ops.tal import tal_assign_batch as jtal
from tscd_tpu.train.v8_losses import yolov8_loss as jloss
from tscd_torch.models import yolov8 as pv8
from tscd_torch.ops.boxes import ciou_xyxy
from tscd_torch.ops.tal import tal_assign_batch
from tscd_torch.train.v8_losses import yolov8_loss
from tscd_torch.utils.convert import flatten_tree, flax_from_state_dict, state_dict_from_flax
from torch_port_util import assert_close, pairwise_batch_stats, seeded_variables

TOL = 1e-4
BF16_SPREAD = 2.0
CFG = dict(num_classes=6, depth=0.33, width=0.25)
T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE = 256


def labels():
    """test_tal.py's labels at 4x the size (for 256 px frames) and a large
    box on each frame, so that every level has foreground: (2, 10, 5)
    [cls, cx, cy, w, h] pixels."""
    lab = np.zeros((2, 10, 5), np.float32)
    lab[0, 0] = [1, 128, 128, 120, 96]
    lab[0, 1] = [3, 48, 160, 56, 64]
    lab[0, 2] = [2, 140, 120, 220, 200]
    lab[1, 0] = [5, 200, 80, 80, 80]
    lab[1, 1] = [4, 120, 140, 192, 224]
    return lab


@pytest.fixture(scope="module")
def yolov8():
    """JAX's YOLOv8 (6 classes, depth 0.33, width 0.25), its seeded
    variables, the port's model carrying them, 2 frames at 256 px. Smaller
    frames leave train-mode BN few values a channel on the coarse maps,
    and fp32 noise then reaches the gradients' tolerance on both sides
    (each side against the port in float64, largest share of a gradient's
    largest value: 1.6e-4 at 128 px, 6e-5 at 256 px)."""
    x = np.random.RandomState(0).uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    jm = jv8.YOLOv8(**CFG)
    variables = seeded_variables(jm, 1, jnp.asarray(x), False, False)
    # each level's DFL bins peaked near `m` bins a side (boxes of about
    # 2 m strides: 128, 192 and 192 px), so that TAL finds foreground on
    # every level for the labels' boxes (random bins predict 120, 240 and
    # 480 px boxes, and only stride 8 would match)
    bins = np.arange(16, dtype=np.float32)
    for k, m in enumerate((8.0, 6.0, 3.0)):
        variables["params"]["head"][f"reg_pred_{k}"]["bias"] = np.tile(-(bins - m) ** 2 / 4, 4)
    pm = pv8.YOLOv8(**CFG, device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    return jm, variables, pm, x


def test_yolov8_forward_and_decode_match_jax(yolov8):
    jm, variables, pm, x = yolov8
    want = jax.jit(lambda v, a: jm.apply(v, a, False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm(T(x))
    assert got["hw"] == [tuple(h) for h in want["hw"]] == [(32, 32), (16, 16), (8, 8)]
    assert_close(got["outputs"].numpy(), want["outputs"], "raw outputs")
    assert_close(got["decoded"].numpy(), want["decoded"], "decoded")
    back = flax_from_state_dict(pm.state_dict())
    for coll in ("params", "batch_stats"):
        a, b = flatten_tree(back[coll]), flatten_tree(variables[coll])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=str(k))


def test_yolov8_bf16_matches_jax(yolov8):
    jm, variables, _, x = yolov8
    run = lambda m: np.asarray(jax.jit(lambda v, a: m.apply(v, a, False))(  # noqa: E731
        variables, jnp.asarray(x))["outputs"], np.float32)
    w32, w16 = run(jm), run(jv8.YOLOv8(**CFG, dtype=jnp.bfloat16))
    p16 = pv8.YOLOv8(**CFG, dtype=torch.bfloat16, device="cpu")
    p16.load_state_dict(state_dict_from_flax(variables, p16.state_dict()))
    with torch.no_grad():
        out = p16(T(x))
    assert out["outputs"].dtype == torch.bfloat16 and out["decoded"].dtype == torch.float32
    gap = float(np.abs(out["outputs"].float().numpy() - w16).mean())
    spread = float(np.abs(w16 - w32).mean())
    assert 0 < gap <= BF16_SPREAD * spread, (gap, spread)


def test_ciou_and_its_gradient_match_jax():
    """Aligned boxes, some disjoint, some nested, some flat (height
    under eps): CIoU and d(sum w CIoU)/d(pred, target), alpha held
    constant in both."""
    rng = np.random.default_rng(2)
    c = rng.uniform(0, 60, (64, 2))
    wh = rng.uniform(1, 30, (64, 2))
    wh[:4, 1] = 0.0
    pred = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    c2 = c + rng.normal(0, 8, c.shape)
    wh2 = wh * rng.uniform(0.5, 1.5, wh.shape) + 0.5
    target = np.concatenate([c2 - wh2 / 2, c2 + wh2 / 2], -1).astype(np.float32)
    w = rng.normal(size=64).astype(np.float32)
    f = jax.jit(jax.value_and_grad(lambda p, t: jnp.sum(jciou(p, t) * w), (0, 1)))
    want, (gp, gt) = f(jnp.asarray(pred), jnp.asarray(target))
    p, t = T(pred).requires_grad_(), T(target).requires_grad_()
    got = ciou_xyxy(p, t)
    assert_close(got.detach().numpy(), jciou(jnp.asarray(pred), jnp.asarray(target)), "ciou")
    (got * T(w)).sum().backward()
    assert_close(p.grad.numpy(), gp, "d/d pred")
    assert_close(t.grad.numpy(), gt, "d/d target")


def tal_case(seed, A=120, G=9, C=6):
    """test_tal.py's seeded case (seed 7): A anchors, G gts (the last two
    padding), C classes."""
    rng = np.random.RandomState(seed)
    axy = rng.uniform(5, 95, (A, 2)).astype(np.float32)
    bc = np.stack([rng.uniform(10, 90, A), rng.uniform(10, 90, A),
                   rng.uniform(5, 40, A), rng.uniform(5, 40, A)], -1)
    boxes = np.concatenate([bc[:, :2] - bc[:, 2:] / 2, bc[:, :2] + bc[:, 2:] / 2],
                           -1).astype(np.float32)
    gc = np.stack([rng.uniform(20, 80, G), rng.uniform(20, 80, G),
                   rng.uniform(15, 50, G), rng.uniform(15, 50, G)], -1)
    gts = np.concatenate([gc[:, :2] - gc[:, 2:] / 2, gc[:, :2] + gc[:, 2:] / 2],
                         -1).astype(np.float32)
    gt_cls = rng.randint(0, C, G)
    gt_valid = np.ones(G, bool)
    gt_valid[-2:] = False
    gts[-2:] = 0.0
    scores = rng.uniform(0.01, 0.99, (A, C)).astype(np.float32)
    return scores, boxes, gts, gt_cls, gt_valid, axy


@pytest.mark.parametrize("seeds", [(7,), (7, 8)], ids=["test_tal_case", "batch_of_2"])
def test_tal_matches_jax(seeds):
    cases = [tal_case(s) for s in seeds]
    axy = cases[0][-1]
    stack = [np.stack([c[i] for c in cases]) for i in range(5)]
    want = jax.jit(jtal, static_argnums=6)(*map(jnp.asarray, stack), jnp.asarray(axy), 6)
    got = tal_assign_batch(*map(T, stack), T(axy), 6)
    assert int(got.fg_mask.sum()) > 10
    for name in ("fg_mask", "matched_gt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.target_boxes.numpy(), np.asarray(want.target_boxes))
    np.testing.assert_array_equal(got.num_fg.numpy(), np.asarray(want.num_fg))
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores),
                               rtol=0, atol=1e-5)


def test_yolov8_loss_and_gradients_match_jax(yolov8):
    """yolov8_loss of a train-mode forward (BN on the batch's statistics)
    on test_tal.py's labels: every part and num_fg, and d total / d every
    parameter against jax.grad."""
    jm, variables, pm, x = yolov8
    lab = labels()
    rest = {k: v for k, v in variables.items() if k != "params"}

    def jtotal(params):
        out, _ = jm.apply({"params": params, **rest}, jnp.asarray(x), True, decode=False,
                          mutable=["batch_stats"])
        parts = jloss(out, jnp.asarray(lab))
        return parts["total_loss"], parts

    with pairwise_batch_stats():
        (_, want), grads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(variables["params"])
    pm.train()
    try:
        parts = yolov8_loss(pm(T(x), train=True, decode=False), T(lab))
        parts["total_loss"].backward()
    finally:
        pm.eval()
    assert float(parts["num_fg"]) > 0
    for k in ("total_loss", "iou_loss", "cls_loss", "dfl_loss", "num_fg"):
        np.testing.assert_allclose(float(parts[k].detach()), float(want[k]), rtol=TOL, err_msg=k)
    named = dict(pm.named_parameters())
    gwant = state_dict_from_flax({"params": grads}, named)
    for n, p in named.items():
        assert float(np.abs(gwant[n].numpy()).max()) > 0, f"no gradient reaches {n}"
        assert_close(p.grad.numpy(), gwant[n].numpy(), f"d total / d {n}")
    pm.zero_grad(set_to_none=True)
