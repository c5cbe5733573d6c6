"""The port's online YOLOV path (the bank, the merge, the online head,
YOLOVOnline and its window, the streaming entry point, FrameBatcher)
against the JAX package on the CPU, at the size of tests/test_online_batch
.py (depth 0.33, width 0.125, 64 px, P = 8, 2 heads, 5 classes), on
frames and weights from numpy seeds (JAX's parameter tree carried across
by utils.convert):

  - bank_push / bank_push_local across a ring wrap, `ran` on and off:
    every field exactly (the pushes copy);
  - local_agg_merge with a row that overlaps no bank box and with an
    empty local bank: 1e-5 (fp32 in another order);
  - a stream of 9 frames through YOLOVOnline with init_online_bank(3 x
    P): each frame's refined cls logits (1e-4 of the largest), proposals
    (anchors, validity exactly), `use_refined`, every field of the bank
    (1e-4; pointers, counts and masks exactly) and the demo's selected
    detections (masks and classes exactly, the rest 1e-4) against JAX's
    jitted step, and the merge against the local bank taking part;
  - window(K = 4) against 4 single calls (1e-4) and against JAX's window;
  - OnlineStream: its steps equal the model's, a full batch its
    window_step, a partial batch frame by frame (the bank as after single
    steps);
  - FrameBatcher's flush cases, as tests/test_online_batch.py;
  - the online model's JAX parameter tree round-trips through
    utils.convert, and the exp builds it as the online demo does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscd_tpu.models import yolov_heads as jyh
from tscd_tpu.models.yolov import YOLOVOnline as JYOLOVOnline
from tscd_tpu.models.yolov import yolov_eval_postprocess as jpost
from tscd_torch.core.online import OnlineStream, select_refined
from tscd_torch.core.predict import detection_rows
from tscd_torch.exp import get_exp_by_name
from tscd_torch.models import yolov_heads as pyh
from tscd_torch.models.yolov import YOLOVOnline
from tscd_torch.utils.batcher import FrameBatcher
from tscd_torch.utils.convert import flatten_tree, flax_from_state_dict, state_dict_from_flax
from torch_port_util import seeded_variables

T = torch.as_tensor
C, P, WIDTH, HEADS, H = 5, 8, 0.125, 2, 64
HID = int(256 * WIDTH)
BANK = 3 * P
FIELDS = jyh.OnlineBank._fields


def close(got, want, tol=1e-4, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=tol * max(1.0, float(np.abs(want).max(initial=0))),
                               rtol=tol, err_msg=msg)


def same_bank(pbank, jbank, tol=1e-4, msg=""):
    assert pyh.OnlineBank._fields == FIELDS
    for name, p, j in zip(FIELDS, pbank, jbank):
        j = np.asarray(j)
        assert tuple(p.shape) == j.shape, (msg, name)
        if j.dtype.kind in "biu":
            assert np.array_equal(p.numpy(), j), (msg, name)
        else:
            close(p, j, tol, f"{msg} {name}")


def test_bank_fields_and_dtypes_match_jax():
    p, j = pyh.init_online_bank(BANK, HID), jyh.init_online_bank(BANK, HID)
    for name, a, b in zip(FIELDS, p, j):
        assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype), name
    same_bank(p, j)


def test_bank_push_and_push_local_across_a_wrap():
    """5 pushes of P rows into rings of 3 P (the main ring wraps after 3,
    the local ring holds what `ran` lets in): every field, exactly."""
    rng = np.random.default_rng(0)
    jb, pb = jyh.init_online_bank(BANK, HID), pyh.init_online_bank(BANK, HID)
    for step, ran in enumerate([False, True, True, False, True]):
        feats = [rng.normal(size=(P, HID)).astype(np.float32) for _ in range(2)]
        cs, fs = (rng.uniform(0, 1, P).astype(np.float32) for _ in range(2))
        valid = rng.uniform(size=P) < 0.7
        msa = rng.normal(size=(P, 4 * HID)).astype(np.float32)
        boxes = rng.uniform(0, 64, (P, 4)).astype(np.float32)
        jb = jyh.bank_push(jb, *map(jnp.asarray, (*feats, cs, fs, valid)))
        jb = jyh.bank_push_local(jb, *map(jnp.asarray, (msa, boxes, cs, fs, valid)),
                                 jnp.asarray(ran))
        pb = pyh.bank_push(pb, *map(T, (*feats, cs, fs, valid)))
        pb = pyh.bank_push_local(pb, *map(T, (msa, boxes, cs, fs, valid)), T(ran))
        same_bank(pb, jb, tol=0, msg=f"push {step}")
    assert int(pb.ptr) == (5 * P) % BANK and int(pb.frames) == 5
    assert int(pb.l_ptr) == (3 * P) % BANK


@pytest.mark.parametrize("case", ["zero-overlap row", "empty local bank"])
def test_local_agg_merge_matches_jax(case):
    rng = np.random.default_rng(1)
    M, D = 16, 4 * HID
    feats = rng.normal(size=(P, D)).astype(np.float32)
    local = rng.normal(size=(M, D)).astype(np.float32)
    c = rng.uniform(10, 50, (P, 2))
    boxes = np.concatenate([c - 8, c + 8], -1).astype(np.float32)
    lb = np.concatenate([np.repeat(boxes, 2, 0)[:M, :2] + rng.uniform(-3, 3, (M, 2)),
                         np.repeat(boxes, 2, 0)[:M, 2:]], -1).astype(np.float32)
    boxes[0] = [200, 200, 210, 210]                  # row 0 overlaps no bank box
    cs, fs = (rng.uniform(0.1, 1, P).astype(np.float32) for _ in range(2))
    lcs, lfs = (rng.uniform(0.1, 1, M).astype(np.float32) for _ in range(2))
    lvalid = (rng.uniform(size=M) < 0.8) if case == "zero-overlap row" else np.zeros(M, bool)
    args = (feats, boxes, cs, fs, local, lb, lcs, lfs, lvalid)
    want = np.asarray(jyh.local_agg_merge(*map(jnp.asarray, args)))
    got = pyh.local_agg_merge(*map(T, args)).numpy()
    close(got, want, 1e-5)
    np.testing.assert_allclose(got[0], feats[0], rtol=1e-6)    # its own features
    if case == "empty local bank":
        np.testing.assert_allclose(got, feats, rtol=1e-6)
    else:
        assert np.abs(got[1:] - feats[1:]).max() > 1e-3


# -- the model, streamed ---------------------------------------------------

def _frames(n, seed=3):
    """A moving scene: one seeded image shifted a pixel a frame, plus
    noise, so the proposals of neighbouring frames overlap."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H, H + n, 3))
    return np.stack([base[:, f:f + H] + rng.normal(0, 4, (H, H, 3))
                     for f in range(n)]).clip(0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def online():
    """JAX's YOLOVOnline and the port's on one seeded parameter tree, and
    JAX's jitted step (the model, then the demo's selection) and window."""
    jm = JYOLOVOnline(num_classes=C, depth=0.33, width=WIDTH, num_proposals=P, heads=HEADS)
    bank0 = jyh.init_online_bank(BANK, HID)
    variables = seeded_variables(jm, 8, jnp.zeros((1, H, H, 3)), bank0)
    pm = YOLOVOnline(num_classes=C, depth=0.33, width=WIDTH, num_proposals=P, heads=HEADS,
                     device="cpu")
    sd = state_dict_from_flax(variables, pm.state_dict())
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)

    def select(out, n):
        refined, original = jpost(out, n, C)
        use = out["use_refined"].reshape(-1)
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(use.reshape((-1,) + (1,) * (a.ndim - 1)), a, b),
            refined, original)

    @jax.jit
    def step(v, x, bank):
        out = jm.apply(v, x, bank)
        return out, select(out, 1)

    @jax.jit
    def window(v, xs, bank):
        out, bank = jm.apply(v, xs, bank, method=JYOLOVOnline.window)
        return out, bank, select(out, xs.shape[0])

    return jm, variables, pm, step, window


def _same_dets(got, want, msg=""):
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask)), msg
    assert np.array_equal(got.cls_id.numpy(), np.asarray(want.cls_id)), msg
    for name in ("boxes", "obj", "score"):
        close(getattr(got, name), getattr(want, name), msg=f"{msg} {name}")


def test_online_stream_matches_jax_frame_by_frame(online, monkeypatch):
    """9 frames, banks of 3 P rows (the main ring wraps at frame 4, the
    local at frame 6): the port equals JAX at every frame, bank included,
    and the merge against the local bank moves some frame's features."""
    _, variables, pm, step, _ = online
    moved = []
    real = pyh.local_agg_merge

    def merge(features, *a):
        out = real(features, *a)
        moved.append(float((out - features).abs().max()))
        return out
    monkeypatch.setattr(pyh, "local_agg_merge", merge)
    frames = _frames(9)
    jbank, pbank = jyh.init_online_bank(BANK, HID), pyh.init_online_bank(BANK, HID)
    for f in range(len(frames)):
        jout, jsel = step(variables, jnp.asarray(frames[f:f + 1]), jbank)
        with torch.no_grad():
            out = pm(T(frames[f:f + 1]), pbank)
        jbank, pbank = jout["bank"], out["bank"]
        msg = f"frame {f}"
        assert bool(out["use_refined"]) == bool(jout["use_refined"]) == (f >= 2), msg
        for name in ("idx", "valid"):
            assert np.array_equal(getattr(out["proposals"], name).numpy(),
                                  np.asarray(getattr(jout["proposals"], name))), msg
        close(out["refined_cls_logits"], jout["refined_cls_logits"], msg=msg)
        same_bank(pbank, jbank, msg=msg)
        _same_dets(select_refined(out, 1, C), jsel, msg)
    assert int(pbank.frames) == 9 and int(pbank.ptr) == (9 * P) % BANK
    assert len(moved) == 9 and max(moved[3:]) > 1e-3, moved


def test_window_of_4_equals_4_steps_and_jax(online):
    """window(K = 4) twice from an empty bank: the outputs and the bank
    equal 8 single calls (1e-4) and JAX's window."""
    _, variables, pm, step, window = online
    frames = _frames(8, seed=4)
    pbank = pyh.init_online_bank(BANK, HID)
    singles = []
    with torch.no_grad():
        for f in range(8):
            o = pm(T(frames[f:f + 1]), pbank)
            pbank = o["bank"]
            singles.append(o)
    wbank, jbank = pyh.init_online_bank(BANK, HID), jyh.init_online_bank(BANK, HID)
    for w in range(2):
        xs = frames[4 * w:4 * w + 4]
        with torch.no_grad():
            out, wbank = pm.window(T(xs), wbank)
        jout, jbank, jsel = window(variables, jnp.asarray(xs), jbank)
        one = singles[4 * w:4 * w + 4]
        close(out["refined_cls_logits"], torch.cat([o["refined_cls_logits"] for o in one]))
        close(out["refined_cls_logits"], jout["refined_cls_logits"], msg=f"window {w}")
        assert out["use_refined"].tolist() == [bool(o["use_refined"]) for o in one] \
            == np.asarray(jout["use_refined"]).tolist()
        assert out["proposals"].boxes.shape == (4, P, 4) and out["hw"] == one[0]["hw"]
        same_bank(wbank, jbank, msg=f"window {w}")
        _same_dets(select_refined(out, 4, C), jsel, f"window {w}")
    same_bank(wbank, [t.numpy() for t in pbank], msg="window vs singles")


def test_online_stream_steps_batches_and_partial_batches(online):
    """OnlineStream on the CPU: its steps equal the model's calls with the
    demo's selection; a full batch of 4 equals its window_step and four
    steps; a partial batch of 3 runs frame by frame, leaving the bank as
    three steps do."""
    _, _, pm, _, _ = online
    frames = _frames(11, seed=5)
    ref = OnlineStream(pm, bank_frames=3, batch=4)
    batched = OnlineStream(pm, bank_frames=3, batch=4)
    assert batched.bank.cls_feat.shape == (BANK, HID)
    want = [ref.step(frames[f]) for f in range(11)]
    assert [bool(u) for _, u in want] == [f >= 2 for f in range(11)]
    want = [d for d, _ in want]
    got = batched.run_batch(list(frames[:4])) + batched.run_batch(list(frames[4:8])) \
        + batched.run_batch(list(frames[8:]))
    assert len(got) == 11
    for f, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.mask.numpy(), w.mask.numpy()), f
        for a, b in zip(g, w):
            close(a, b, msg=f"frame {f}")
    for a, b in zip(batched.bank, ref.bank):
        close(a, b)
    rows = detection_rows(got[0])
    assert len(rows) == 1 and rows[0].shape[1] == 7


# -- FrameBatcher (tests/test_online_batch.py:19-61) -------------------------

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("case", ["size", "age", "age from the oldest", "drain"])
def test_frame_batcher_flushes_as_jax(case):
    from tscd_tpu.utils.batcher import FrameBatcher as JFrameBatcher

    def drive(cls):
        clk = FakeClock()
        b = cls(3 if case == "size" else 8, max_wait_ms=25.0, clock=clk)
        seen = []
        for i, dt in enumerate([0.0, 0.010, 0.016, 0.010, 0.010]):
            clk.t += dt
            seen += [b.push(i), b.poll(), len(b)]
        seen.append(b.flush() if case == "drain" else b.poll())
        seen.append(b.flush())
        return seen
    assert drive(FrameBatcher) == drive(JFrameBatcher)
    with pytest.raises(ValueError):
        FrameBatcher(0)


# -- weights and the exp -----------------------------------------------------

def test_online_parameter_tree_round_trips(online):
    """JAX's online variables (`backbone`, `head/towers`, `head/trans/msa/
    qkv_*`, `linear1`, `linear2`, `cls_pred`) into the port's state_dict
    and back, every leaf exactly."""
    _, variables, pm, _, _ = online
    back = flax_from_state_dict(pm.state_dict())
    for c in ("params", "batch_stats"):
        want, got = flatten_tree(variables.get(c, {})), flatten_tree(back[c])
        assert set(got) == set(want), (c, sorted(set(got) ^ set(want))[:6])
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    assert ("head", "trans", "msa", "qkv_cls", "kernel") in flatten_tree(back["params"])


def test_exp_builds_the_online_model_as_the_demo():
    """tools/yolov_demo_online.py:56-61: num_classes, depth, width, P =
    minimal_limit, heads, sim_thresh; the stream's bank of 31 frames."""
    exp = get_exp_by_name("yolov_l")
    exp.minimal_limit = 12
    exp.width, exp.depth = 0.25, 0.33
    m = exp.get_online_model(device="cpu")
    assert (m.num_classes, m.head.num_proposals, m.head.hidden) == (30, 12, 64)
    assert m.head.trans.msa.num_heads == exp.heads and m.head.sim_thresh == exp.sim_thresh
    st = OnlineStream(m)
    assert st.bank.cls_feat.shape == (31 * 12, 64) and st.bank.msa_feat.shape == (31 * 12, 256)
