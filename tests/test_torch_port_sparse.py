"""The proposal-patch video towers of the port (models/sparse_towers.py)
against JAX's `sparse_vid_tower_features` and the port's own dense
towers, on the CPU, on inputs made from numpy seeds:

  - the features at JAX's border and level anchors
    (tests/test_sparse_towers.py:91-106: corners, edges, centres, the
    cross-level boundaries), three levels of 8 channels, random BN
    statistics made positive so that conv(0) != 0 and the out-of-map
    masking matters: against JAX's sparse path and against the dense
    maps, with JAX's tolerances (rtol 1e-4, atol 1e-5; the edge features,
    a product of two convs, rtol 1e-3);
  - the whole head with `sparse_vid_towers` (mca and mca_aware, whose edge
    block reads every frame) against jitted JAX's sparse head, 1e-4, and
    against the port's dense head;
  - the gate: train-mode BN (`stats` given) and vid_cls / vid_reg off take
    the dense towers, as JAX's `not train` gate does;
  - a fix_bn stage-2 step through the patches: the video towers' and edge
    blocks' gradients equal the dense path's within 1e-4 of the largest;
  - WaveletsHFBlock on the block-aligned 4x4 patch of every position of a
    map equals the block on the map at that position, which the patch
    holds in its interior.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tscd_tpu.models.blocks import BaseConv as JBaseConv
from tscd_tpu.models import tscd_head as jhead
from tscd_tpu.models.sparse_towers import sparse_vid_tower_features as jsparse
from tscd_tpu.ops.wavelets import WaveletsHFBlock as JWavelets
from tscd_torch.exp.tscd_large import selftest_exp
from tscd_torch.models import tscd_head as phead
from tscd_torch.models.blocks import BaseConv
from tscd_torch.models.sparse_towers import extract_patches, sparse_vid_tower_features
from tscd_torch.models.tscd import random_init_
from tscd_torch.models.yolo_head import flatten_levels
from tscd_torch.ops.position import get_timing_signal_1d
from tscd_torch.ops.wavelets import WaveletsHFBlock
from tscd_torch.train.losses import tscd_loss
from tscd_torch.utils.convert import state_dict_from_flax
from torch_port_util import labels_near, seeded_variables

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = torch.as_tensor
HID = 8
HWS = [(8, 8), (4, 4), (2, 2)]
A0, A1 = 64, 16
# tests/test_sparse_towers.py:91-99
BORDER_IDX = np.array([
    [0, 7, 56, 63, 9, 35, A0 + 0, A0 + 3, A0 + 15, A0 + A1 + 0],
    [A0 + A1 + 3, A0 + A1 + 1, 1, 8, 62, 27, A0 + 5, 36, 18, 54],
    [63, 0, A0 + 12, A0 + A1 + 2, 44, 2, 16, 30, A0 + 10, 5],
])


class JTowers(fnn.Module):
    """Three levels of video towers and edge blocks, named as JAX's head
    names them, so that the port's names carry them."""

    @fnn.compact
    def __call__(self, stems, idx, lframe, edge_all):
        cls_mods = [[JBaseConv(HID, 3, 1, name=f"cls_conv2_{k}_{i}") for i in range(2)]
                    for k in range(3)]
        reg_mods = [[JBaseConv(HID, 3, 1, name=f"reg_conv2_{k}_{i}") for i in range(2)]
                    for k in range(3)]
        edge_mods = [JWavelets(name=f"edge_{k}") for k in range(3)]
        hw = [(s.shape[1], s.shape[2]) for s in stems]
        return jsparse(stems, hw, idx, cls_mods, reg_mods, edge_mods, lframe, edge_all)


class PTowers(torch.nn.Module):
    def __init__(self):
        super().__init__()

        def tower():
            return torch.nn.Sequential(BaseConv(HID, HID, 3), BaseConv(HID, HID, 3))

        self.cls_convs2 = torch.nn.ModuleList(tower() for _ in range(3))
        self.reg_convs2 = torch.nn.ModuleList(tower() for _ in range(3))
        self.edge_enhance_reg = torch.nn.ModuleList(
            torch.nn.Sequential(WaveletsHFBlock(HID)) for _ in range(3))

    def dense(self, stems, idx, lframe, edge_all):
        def maps(towers):
            out = []
            for t, s in zip(towers, stems):
                for m in t:
                    s = m(s)
                out.append(s)
            return out
        cls_maps, reg_maps = maps(self.cls_convs2), maps(self.reg_convs2)
        edges = [e(r if edge_all else r[:lframe]) for e, r in zip(self.edge_enhance_reg, reg_maps)]
        fe = idx if edge_all else idx[:lframe]
        take = lambda maps, i: torch.gather(   # noqa: E731
            flatten_levels(maps), 1, i[..., None].expand(*i.shape, HID))
        return take(cls_maps, idx), take(reg_maps, idx), take(edges, fe)


def _positive_bn(variables, rng):
    """JAX's `_randomize` (test_sparse_towers.py:63-76): every leaf N(0.1,
    0.35), the 1-d ones (BN and conv biases) made positive."""
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    out = []
    for leaf in leaves:
        val = rng.normal(0.1, 0.35, leaf.shape)
        if leaf.ndim == 1:
            val = np.abs(val) + 0.1
        out.append(np.asarray(val, np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.mark.parametrize("edge_all", [False, True])
def test_sparse_features_match_jax_and_dense_at_borders(edge_all):
    rng = np.random.default_rng(0)
    Fr, lframe = BORDER_IDX.shape[0], 2
    stems = [rng.normal(size=(Fr, h, w, HID)).astype(np.float32) for h, w in HWS]
    jm = JTowers()
    args = ([jnp.asarray(s) for s in stems], jnp.asarray(BORDER_IDX, jnp.int32), lframe,
            edge_all)
    variables = _positive_bn(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args)),
                             rng)
    jc, jr, je = jax.jit(lambda v, s, i: jm.apply(v, s, i, lframe, edge_all))(
        variables, args[0], args[1])
    pm = PTowers().eval()
    pm.load_state_dict(state_dict_from_flax(variables, pm.state_dict()))
    ps = [T(s).permute(0, 3, 1, 2) for s in stems]
    idx = T(BORDER_IDX)
    with torch.no_grad():
        sc, sr, se = sparse_vid_tower_features(ps, idx, pm.cls_convs2, pm.reg_convs2,
                                               pm.edge_enhance_reg, lframe, edge_all)
        dc, dr, de = pm.dense(ps, idx, lframe, edge_all)
    assert se.shape == de.shape == (Fr if edge_all else lframe, 10, HID)
    for got, want, rtol in ((sc, jc, 1e-4), (sr, jr, 1e-4), (se, je, 1e-3)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=1e-5)
    for got, want, rtol in ((sc, dc, 1e-4), (sr, dr, 1e-4), (se, de, 1e-3)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=1e-5)


F, L = 4, 1
FPN = [(16, 16, 32), (8, 8, 64), (4, 4, 128)]


@pytest.mark.parametrize("agg_type", ["mca", "mca_aware"])
def test_sparse_head_matches_jax_and_the_dense_head(agg_type):
    rng = np.random.default_rng(1)
    xin = [rng.normal(size=(F,) + s).astype(np.float32) for s in FPN]
    te = get_timing_signal_1d(np.arange(F, dtype=np.float32), 256).astype(np.float32)
    knobs = dict(agg_type=agg_type, sparse_vid_towers=True)
    jm = jhead.TSCDHead(num_classes=30, width=0.125, num_proposals=6, **knobs)
    jx = [jnp.asarray(x) for x in xin]
    variables = seeded_variables(jm, 0, jx, jnp.asarray(te), L, F - L)
    jout = jax.jit(lambda v, xs: jm.apply(v, xs, jnp.asarray(te), L, F - L))(variables, jx)
    sparse = phead.TSCDHead(30, width=0.125, num_proposals=6, **knobs).eval()
    dense = phead.TSCDHead(30, width=0.125, num_proposals=6, agg_type=agg_type).eval()
    sd = state_dict_from_flax(variables, sparse.state_dict())
    sparse.load_state_dict(sd)
    dense.load_state_dict(sd)
    xs = [T(x).permute(0, 3, 1, 2) for x in xin]
    with torch.no_grad():
        out, ref = sparse(xs, T(te), L), dense(xs, T(te), L)
    assert np.array_equal(np.asarray(jout["proposals"].idx), out["proposals"].idx.numpy())
    for k in ("refined_cls_logits", "matcher_obj_logits", "matcher_reg_offsets",
              "refined_boxes"):
        want = np.asarray(jout[k])
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(out[k].numpy(), want, rtol=1e-4, atol=tol, err_msg=k)
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=tol,
                                   err_msg=f"dense {k}")


def test_sparse_gate_takes_the_dense_towers(monkeypatch):
    """Train-mode BN, or a video tower switched off, runs the dense maps."""
    calls = []
    monkeypatch.setattr(phead, "sparse_vid_tower_features",
                        lambda *a, **k: calls.append(1) or sparse_vid_tower_features(*a, **k))
    rng = np.random.default_rng(2)
    xs = [T(rng.normal(size=(F,) + s).astype(np.float32)).permute(0, 3, 1, 2) for s in FPN]
    te = T(get_timing_signal_1d(np.arange(F, dtype=np.float32), 256)).float()
    for knobs, stats, want in ((dict(), None, 1), (dict(), {}, 0),
                               (dict(vid_cls=False), None, 0), (dict(vid_reg=False), None, 0)):
        calls.clear()
        head = phead.TSCDHead(30, width=0.125, num_proposals=6, sparse_vid_towers=True,
                              **knobs).eval()
        with torch.no_grad():
            head(xs, te, L, stats=stats)
        assert len(calls) == want, (knobs, stats)


def test_fix_bn_step_gradients_through_the_patches_equal_dense():
    """A fix_bn stage-2 forward and backward (BN on running statistics,
    as JAX's fix_bn step) through the sparse and the dense path from the
    same weights: the video towers' and edge blocks' gradients within 1e-4
    of the largest."""
    exp = selftest_exp()
    Lt, Gt = exp.lframe, exp.gframe
    Ft = Lt + Gt
    rng = np.random.default_rng(3)
    x = T(rng.integers(0, 256, (Ft, 128, 128, 3)).astype(np.float32))
    te = T(get_timing_signal_1d(np.arange(Ft, dtype=np.float32), 256)).float()
    dense = random_init_(exp.get_model(device="cpu"), 3)
    with torch.no_grad():                    # BN that moves conv(0) off 0
        for name, b in dense.state_dict().items():
            if "bn." in name and name.endswith(("bias", "running_mean")):
                b.copy_(T(rng.normal(0.1, 0.3, b.shape)))
        boxes = dense(x, te, Lt, Gt)["proposals"].boxes[:Lt, :3].numpy()
    lab = T(labels_near(rng, boxes, Ft, exp.num_classes))
    exp.sparse_vid_towers = True
    sparse = exp.get_model(device="cpu")
    sparse.load_state_dict(dense.state_dict())
    grads = []
    for m in (dense, sparse):
        m.train()
        out = m(x, te, Lt, Gt, labels=lab)
        tscd_loss(out, lab, (8, 16, 32), Lt)["total_loss"].backward()
        grads.append({n: p.grad for n, p in m.named_parameters() if p.grad is not None})
    towers = [n for n in grads[0] if n.startswith(("head.cls_convs2", "head.reg_convs2",
                                                   "head.edge_enhance_reg"))]
    assert len(towers) == 3 * (2 * 6 + 4) and set(grads[0]) == set(grads[1])
    gmax = max(float(g.abs().max()) for g in grads[0].values())
    assert max(float(grads[0][n].abs().max()) for n in towers) > 1e-3 * gmax
    for n, g in grads[0].items():
        np.testing.assert_allclose(grads[1][n].numpy(), g.numpy(), rtol=0, atol=1e-4 * gmax,
                                   err_msg=n)


@pytest.mark.parametrize("hw", [(8, 8), (6, 10)])
def test_edge_block_on_aligned_patches_equals_the_map(hw):
    """For every position (y, x) of a map, the block on the zero-padded
    4x4 patch at (2 floor((y-1)/2), 2 floor((x-1)/2)), read at (y, x),
    equals the block on the map, and (y, x) lies in the patch's interior
    rows and columns 1-2."""
    h, w = hw
    rng = np.random.default_rng(4)
    block = WaveletsHFBlock(HID)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(T(rng.normal(0, 0.5, p.shape).astype(np.float32)))
    x = T(rng.normal(size=(2, HID, h, w)).astype(np.float32))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    y = T(np.broadcast_to(ys.reshape(1, -1), (2, h * w)).copy())
    xx = T(np.broadcast_to(xs.reshape(1, -1), (2, h * w)).copy())
    sy = 2 * torch.div(y - 1, 2, rounding_mode="floor")
    sx = 2 * torch.div(xx - 1, 2, rounding_mode="floor")
    dy, dx = y - sy, xx - sx
    assert set(dy.unique().tolist()) == set(dx.unique().tolist()) == {1, 2}
    with torch.no_grad():
        patches = extract_patches(x, sy, sx, 4, 2)               # (2 h w, C, 4, 4)
        got = block(patches)
        got = got.reshape(2, h * w, HID, 16)[
            torch.arange(2)[:, None], torch.arange(h * w)[None], :, (dy * 4 + dx)]
        want = block(x).reshape(2, HID, h * w).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
