"""The port's still-image YOLOX (stage 1 of the OVIS recipe) against the
JAX package on the CPU, at the selftest width (depth 0.33, width 0.125),
5 classes, weights and inputs made from numpy seeds:

  - the YOLOX forward: raw outputs and `decoded` within 1e-4 relative
    (1e-5 absolute);
  - postprocess_dense element for element (the same anchors picked, their
    boxes, scores and classes equal), over 4200 anchors so that the top
    2048 cap and the NMS kernel's plain version at (2, 2048) run, at the
    IoU thresholds of yolox_l (0.65) and yoloxl_ovis (0.5);
  - yolox_loss, with and without the L1 term, each term within 1e-5
    relative;
  - one train step (train-mode BN, grouped SGD, EMA of the parameters and
    statistics) with the L1 term off, and with it on and grad_accum 2,
    against make_yolox_train_step (jitted; its batch statistics summed
    pairwise, `torch_port_util.pairwise_batch_stats`): losses 1e-4
    relative, parameters, running statistics and EMA within 1e-4 of the
    largest update plus the value's fp32 spacing;
  - the train CLI for one epoch (mosaic and mixup), resumed from its
    checkpoint (epoch, update count, momentum), and the eval CLI on a
    synthetic COCO set (as tests/test_e2e_still.py builds one), the eval
    CLI's AP (all 12 stats) equal to JAX's COCOEvaluator's on the same
    weights within 1e-4, and the detections of a batch equal to JAX's as
    sets (classes exactly, boxes and scores 1e-4).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscd_tpu.models.yolox import YOLOX as JYOLOX
from tscd_tpu.ops.postprocess import postprocess_dense_batch as jpost
from tscd_tpu.train import lr as jlr
from tscd_tpu.train.losses import yolox_loss as jloss
from tscd_tpu.train.optim import build_sgd
from tscd_tpu.train.step import init_train_state as jinit, make_yolox_train_step
from tscd_torch.exp.yolox_base import YOLOXExp
from tscd_torch.models.yolox import YOLOX
from tscd_torch.ops.postprocess import postprocess_dense
from tscd_torch.train.losses import yolox_loss
from tscd_torch.train.step import init_train_state, yolox_train_step
from tscd_torch.utils.convert import state_dict_from_flax
from torch_port_util import pairwise_batch_stats, seeded_variables

C, DEPTH, WIDTH = 5, 0.33, 0.125
H, W, B = 64, 96, 4
STRIDES = (8, 16, 32)
ITERS, STEP = 10, 12      # a schedule of 10 iterations an epoch; the step past warm-up
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jm():
    return JYOLOX(num_classes=C, depth=DEPTH, width=WIDTH)


@pytest.fixture(scope="module")
def variables(jm):
    return seeded_variables(jm, 0, jnp.zeros((B, H, W, 3), jnp.float32), False, False)


def _port(variables):
    pm = YOLOX(C, DEPTH, WIDTH, device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    return pm


def _images(seed, n=B):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, 3)).astype(np.float32)


def _labels(seed, n=B, g=6):
    """(n, g, 5) [cls, cx, cy, w, h]: 1-5 gts an image, the rest zero."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((n, g, 5), np.float32)
    for b in range(n):
        for i in range(int(rng.integers(1, g))):
            wh = rng.uniform(8, 40, 2)
            lab[b, i] = [rng.integers(0, C), rng.uniform(wh[0] / 2, W - wh[0] / 2),
                         rng.uniform(wh[1] / 2, H - wh[1] / 2), *wh]
    return lab


@pytest.fixture(scope="module")
def forward(jm, variables):
    x = _images(1)
    out = jax.jit(lambda v, x: jm.apply(v, x, False, True))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port(variables)(torch.as_tensor(x), decode=True)
    return out, got


def test_yolox_forward_matches_jax(forward):
    out, got = forward
    assert got["hw"] == [tuple(int(v) for v in h) for h in out["hw"]]
    for k in ("outputs", "decoded"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(out[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("nms_thre", [0.65, 0.5])
def test_postprocess_dense_matches_jax(nms_thre):
    rng = np.random.default_rng(2)
    A = 4200
    xy = rng.uniform(0, 600, (2, A, 2))
    wh = rng.uniform(4, 120, (2, A, 2))
    scores = rng.uniform(0, 1, (2, A, 1 + C)) ** 2
    scores[:, ::7, 1] = scores[:, ::7, 2]                 # class ties: the first wins
    dec = np.concatenate([xy, wh, scores], -1).astype(np.float32)
    want = jax.jit(jpost, static_argnums=(1, 2, 3, 4))(jnp.asarray(dec), C, 0.01, nms_thre, 100)
    got = postprocess_dense(torch.as_tensor(dec), C, 0.01, nms_thre, 100)
    mask = np.asarray(want.mask)
    assert np.array_equal(got.mask.numpy(), mask) and mask.sum(1).min() == 100
    for name in ("boxes", "obj", "score", "cls_id"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.array_equal(g[mask], w[mask]), name


@pytest.mark.parametrize("use_l1", [False, True])
def test_yolox_loss_matches_jax(forward, use_l1):
    out, _ = forward
    raw = np.asarray(out["outputs"])
    hw = [tuple(int(v) for v in h) for h in out["hw"]]
    lab = _labels(3)
    want = jax.jit(functools.partial(jloss, hw=hw, strides=STRIDES, use_l1=use_l1))(
        jnp.asarray(raw), jnp.asarray(lab))
    got = yolox_loss(torch.as_tensor(raw), torch.as_tensor(lab), hw, STRIDES, use_l1)
    assert float(got["num_fg"]) > 0 and (float(got["l1_loss"]) > 0) == use_l1
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)


def _exp():
    exp = YOLOXExp()
    exp.max_epoch, exp.warmup_epochs, exp.no_aug_epochs, exp.batch_size = 4, 1, 1, B
    return exp


@functools.lru_cache(maxsize=None)
def _jax_step(use_l1, accum):
    exp = _exp()
    s = jlr.yolox_warm_cos_lr(exp.basic_lr_per_img * exp.batch_size, exp.min_lr_ratio,
                              ITERS * exp.max_epoch, ITERS * exp.warmup_epochs, exp.warmup_lr,
                              ITERS * exp.no_aug_epochs)
    tx = build_sgd(lambda i: s(i + STEP))
    step = jax.jit(make_yolox_train_step(JYOLOX(num_classes=C, depth=DEPTH, width=WIDTH), tx,
                                         use_l1=use_l1, ema_decay=exp.ema_decay,
                                         grad_accum=accum))
    return tx, step


def _max(ts):
    return max(float(t.abs().max()) for t in ts)


def _close_update(got, want, before, names, tol=1e-4):
    dmax = _max([want[k].double() - before[k].double() for k in names])
    assert dmax > 0
    for k in names:
        bound = tol * dmax + np.spacing(np.abs(want[k].numpy()))
        err = np.abs(got[k].double().numpy() - want[k].double().numpy())
        assert np.all(err <= bound), (k, float((err - bound).max()))


@pytest.mark.parametrize("use_l1,accum", [(False, 1), (True, 2)])
def test_yolox_train_step_matches_jax(variables, use_l1, accum):
    x, lab = _images(4), _labels(5)
    tx, step = _jax_step(use_l1, accum)
    st = jinit(variables, tx)._replace(step=jnp.asarray(STEP, jnp.int32))
    with pairwise_batch_stats():
        new, jl = step(st, jnp.asarray(x), jnp.asarray(lab))
    pm = _port(variables)
    tmpl = pm.state_dict()
    before = {k: v.clone() for k, v in tmpl.items()}
    exp = _exp()
    opt = exp.get_optimizer(pm, ITERS)
    opt.count = STEP
    state = init_train_state(pm, opt, exp.ema_decay)
    losses = yolox_train_step(state, torch.as_tensor(x), torch.as_tensor(lab), use_l1=use_l1,
                              grad_accum=accum)
    for k, v in jl.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    names = [n for n, _ in pm.named_parameters()]
    want = state_dict_from_flax({"params": new.params, "batch_stats": new.batch_stats}, tmpl)
    want_ema = state_dict_from_flax({"params": new.ema_params,
                                     "batch_stats": new.ema_batch_stats}, tmpl)
    after, ema = pm.state_dict(), state.ema.state_dict()
    _close_update(after, want, before, names)
    _close_update({k: ema[k] for k in names}, want_ema, before, names)
    running = [k for k in want if ".running_" in k]
    assert len(running) > 50
    for k in running:
        for got, w in ((after[k], want[k]), (ema[k], want_ema[k])):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                       atol=1e-4 * float(w.abs().max()), err_msg=k)
        assert not torch.equal(after[k], before[k])


def _make_coco(root, n_imgs=8, size=(96, 128), n_categories=2):
    import cv2
    h, w = size
    os.makedirs(os.path.join(root, "train2017"), exist_ok=True)
    images, annotations = [], []
    for i in range(n_imgs):
        fn = f"{i:012d}.jpg"
        img = np.full((h, w, 3), 80, np.uint8)
        x0, y0 = 15 + 3 * i, 10 + 2 * i
        cv2.rectangle(img, (x0, y0), (x0 + 40, y0 + 30), (255, 255, 255), -1)
        cv2.imwrite(os.path.join(root, "train2017", fn), img)
        images.append({"id": i, "file_name": fn, "width": w, "height": h})
        annotations.append({"id": i + 1, "image_id": i, "category_id": 1 + i % n_categories,
                            "bbox": [x0, y0, 40, 30], "area": 1200, "iscrowd": 0})
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": c + 1, "name": f"cat{c}"} for c in range(n_categories)]}
    for name in ("instances_train2017.json", "instances_val2017.json"):
        with open(os.path.join(root, "annotations", name), "w") as f:
            json.dump(coco, f)
    return root


_EXP_BODY = """
        self.depth, self.width = 0.33, 0.125
        self.num_classes = 2
        self.input_size = self.test_size = (96, 128)
        self.batch_size = 4
        self.max_epoch = 1
        self.no_aug_epochs = 0
        self.eval_interval = 10
        self.data_dir = {root!r}
        self.train_name = self.val_name = "train2017"
        self.output_dir = {out!r}
        self.exp_name = "tiny_still"
        self.test_conf = 1e-6
        self.seed = 0
"""


def test_train_and_eval_clis_match_jax(tmp_path):
    """The train CLI runs an epoch on a synthetic COCO set; the eval CLI
    scores its checkpoint as JAX's COCOEvaluator scores the same weights."""
    from tscd_tpu.core.trainer import Trainer as JTrainer
    from tscd_tpu.exp.yolox_base import Exp as JExp
    from tscd_torch.tools import eval as peval
    from tscd_torch.tools import train as ptrain
    from tscd_torch.utils.convert import flax_from_state_dict
    root = _make_coco(str(tmp_path / "coco"))
    out = str(tmp_path / "out")
    body = _EXP_BODY.format(root=root, out=out)
    exp_file = tmp_path / "tiny_still.py"
    exp_file.write_text("from tscd_torch.exp.yolox_base import YOLOXExp\n"
                        "class Exp(YOLOXExp):\n    def __init__(self):\n"
                        "        super().__init__()" + body)
    state = ptrain.main(["-f", str(exp_file), "--device", "cpu"])
    assert state.step == 2
    ckpt = os.path.join(out, "tiny_still", "latest_ckpt.pth")
    trace = {k: v.clone() for k, v in state.optimizer.trace.items()}
    # --resume continues at epoch 1 with the saved momentum and update count
    from tscd_torch.exp import get_exp
    resumed = get_exp(str(exp_file)).merge(["max_epoch", "2", "output_dir", str(tmp_path / "r")])
    tr = resumed.get_trainer(type("Args", (), {"ckpt": ckpt, "resume": True})(), device="cpu")
    tr.iters_per_epoch = 2
    tr._init_state()
    assert tr.start_epoch == 1 and tr.state.step == 2
    assert all(torch.equal(tr.state.optimizer.trace[k], v) for k, v in trace.items())
    got = peval.main(["-f", str(exp_file), "-c", ckpt, "--device", "cpu", "-b", "3"])

    jexp = JExp()
    for line in body.strip().splitlines():
        exec(line.strip(), {"self": jexp})
    sd = torch.load(ckpt, weights_only=True)["model"]
    variables = jax.tree_util.tree_map(jnp.asarray, flax_from_state_dict(sd))
    ev = jexp.get_evaluator()
    ev.batch_size = 3
    jpredict = JTrainer(jexp).make_predict_fn(variables)
    want = ev.evaluate(jpredict, log=lambda *a: None)
    assert len(want["stats"]) == 12          # predictions were scored
    # the detections themselves, on the evaluator's first batch
    from tscd_torch.core.trainer import make_predict_fn
    from tscd_torch.data.transforms import letterbox
    pm = YOLOX(2, 0.33, 0.125, device="cpu")
    pm.load_state_dict(sd)
    imgs = np.stack([letterbox(ev.dataset.pull_item(i)[0], (96, 128))[0] for i in range(3)])
    rows = make_predict_fn(pm, 2, 1e-6, jexp.nmsthre)(imgs)
    jrows = jpredict(imgs)
    assert sum(len(r) for r in rows) > 0
    # as sets: these near-uniform scores tie within float noise, so their
    # order (not the set NMS keeps) may differ
    def ordered(r):
        return r[np.lexsort((np.round(r[:, 1], 2), np.round(r[:, 0], 2), r[:, 6]))]
    for g, w in zip(rows, jrows):
        g, w = ordered(g), ordered(w)
        assert g.shape == w.shape and np.array_equal(g[:, 6], w[:, 6])
        np.testing.assert_allclose(g[:, :6], w[:, :6], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["stats"], want["stats"], atol=1e-4)
    for k in ("mAP", "AP50"):
        assert abs(got[k] - want[k]) <= 1e-4, k
