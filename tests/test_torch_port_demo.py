"""The demo tools of the port (tscd_torch/tools: tscd_demo, vid_demo,
vid_demo_wpost, yolov_demo_online, demo, repp) and models/build.py on the
CPU. The slice as a whole: JAX's tools/tscd_demo.py and the port's run at
the selftest size on the same fixture frames from one msgpack checkpoint,
each tool's frames caught at its writer (JAX's cv2.VideoWriter patched
here); the detections each hands to `vis` agree, and the port's `vis` of
JAX's detections is JAX's frame byte for byte."""

import importlib.util
import os
import pickle
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from tscd_torch.data.image import imdecode, imencode_jpeg, imread
from tscd_torch.utils.video import read_mp4

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX0 = os.path.join(REPO, "tscd_torch", "data", "fixtures", "vid", "Data", "VID", "val",
                    "fix0")
SELFTEST_EXP = os.path.join(REPO, "YOLOX_outputs", "validate_ref", "selftest_exp.py")
SELFTEST_CKPT = os.path.join(REPO, "YOLOX_outputs", "validate_ref", "converted_ckpt.msgpack")
N_FRAMES = 5
# JAX's window (XLA:CPU) and the port's (torch) sum in other orders: the
# detections agree within 1e-4 relative in the letterboxed frame, so within
# 1e-4 of the frame's largest coordinate (x1 = cx - w / 2 cancels) once
# divided by the letterbox ratio; scores 1e-4
BOX_SHARE, ATOL, RTOL = 1e-4, 1e-4, 1e-4


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    for f in sorted(os.listdir(FIX0))[:N_FRAMES]:
        shutil.copyfile(os.path.join(FIX0, f), d / f)
    return str(d)


class _Recorder:
    """Wraps a vis function: records (frame before drawing, boxes, scores,
    class ids, conf, names) of each call."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, img, boxes, scores, cls_ids, conf=0.5, class_names=None):
        self.calls.append((img.copy(), np.array(boxes, np.float64), np.array(scores, np.float64),
                           np.array(cls_ids), conf, class_names))
        return self.fn(img, boxes, scores, cls_ids, conf, class_names)


class _Writer:
    frames = []

    def __init__(self, path, fourcc, fps, size):
        self.size = size

    def write(self, frame):
        _Writer.frames.append(frame.copy())

    def release(self):
        pass


@pytest.fixture(scope="module")
def both_demos(frames_dir, tmp_path_factory):
    """JAX's and the port's tscd_demo on the same frames and checkpoint,
    traj_linking and --post on: (JAX's vis calls and written frames, the
    port's vis calls and result)."""
    import tscd_tpu.utils.visualize as jvis
    import tscd_torch.utils.visualize as pvis
    out = tmp_path_factory.mktemp("demo_out")
    mp = pytest.MonkeyPatch()
    try:
        jrec, prec = _Recorder(jvis.vis), _Recorder(pvis.vis)
        mp.setattr(jvis, "vis", jrec)
        mp.setattr(pvis, "vis", prec)
        mp.setattr(cv2, "VideoWriter", _Writer)
        _Writer.frames = []
        spec = importlib.util.spec_from_file_location(
            "jax_tscd_demo_tool", os.path.join(REPO, "tools", "tscd_demo.py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        mp.setattr(sys, "argv", ["tscd_demo.py", "-f", SELFTEST_EXP, "-c", SELFTEST_CKPT,
                                 "--path", frames_dir, "--post", "--conf", "0.01",
                                 "--output_dir", str(out / "jax"), "traj_linking", "True"])
        mp.chdir(REPO)
        tool.main()
        jax_frames = list(_Writer.frames)
        from tscd_torch.tools import tscd_demo
        res = tscd_demo.main(["--exp", "selftest", "-c", SELFTEST_CKPT, "--path", frames_dir,
                              "--device", "cpu", "--post", "--conf", "0.01", "--output_dir",
                              str(out / "port"), "traj_linking", "True"])
    finally:
        mp.undo()
    return jrec.calls, jax_frames, prec.calls, res


def test_tscd_demo_detections_match_jax(both_demos):
    """The detections each tool hands to vis, frame by frame, as sets:
    classes exactly, boxes within 1e-4 of the frame's largest coordinate,
    scores within atol 1e-4 + rtol 1e-4; the same conf and class names."""
    jcalls, _, pcalls, res = both_demos
    assert len(jcalls) == len(pcalls) == N_FRAMES
    n = 0
    for (_, jb, js, jc, jconf, jnames), (_, pb, ps, pc, pconf, pnames) in zip(jcalls, pcalls):
        assert (jconf, list(jnames)) == (pconf, list(pnames))
        assert len(jb) == len(pb)
        tol = BOX_SHARE * max(1.0, float(np.abs(jb).max())) if len(jb) else 0
        free = list(range(len(pb)))
        for b, s, c in zip(jb, js, jc):
            hit = next((i for i in free if pc[i] == c and np.allclose(pb[i], b, atol=tol, rtol=RTOL)
                        and np.isclose(ps[i], s, atol=ATOL, rtol=RTOL)), None)
            assert hit is not None, (b, s, c)
            free.remove(hit)
            n += 1
    assert n > 0
    assert len(res["dets"]) == N_FRAMES


def test_tscd_demo_port_draws_jax_frames(both_demos):
    """The port's vis of JAX's detections on the frame JAX drew on is the
    frame JAX handed to its writer, byte for byte."""
    from tscd_torch.utils.visualize import vis
    jcalls, jax_frames, _, _ = both_demos
    assert len(jax_frames) == N_FRAMES
    for (img, boxes, scores, cls_ids, conf, names), want in zip(jcalls, jax_frames):
        got = vis(img.copy(), boxes.astype(np.float32), scores.astype(np.float32), cls_ids,
                  conf, names)
        np.testing.assert_array_equal(got, want)


def test_tscd_demo_writes_mjpeg_mp4(both_demos):
    """The port's .mp4: one JPEG sample a frame, each the encoder's bytes of
    the frame it drew, 25 frames a second."""
    _, _, _, res = both_demos
    m = read_mp4(res["path"])
    assert (m["codec"], m["object_type"], m["fps"]) == ("mp4v", 0x6C, 25.0)
    assert len(m["samples"]) == N_FRAMES
    for s, f in zip(m["samples"], res["frames"]):
        assert s == imencode_jpeg(f)
        assert imdecode(s).shape == f.shape


@pytest.fixture(scope="module")
def yolov_ckpts(tmp_path_factory):
    """Seeded yolov_selftest weights as JAX-layout msgpack checkpoints:
    (YOLOV's, the online model's)."""
    from tscd_torch.exp import get_exp
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.train.checkpoint import save_checkpoint
    d = str(tmp_path_factory.mktemp("ckpt"))
    exp = get_exp(exp_name="yolov_selftest")
    offline = random_init_(exp.get_model(device="cpu"), 0)
    online = random_init_(exp.get_online_model(device="cpu"), 0)
    return (save_checkpoint({"model": offline.state_dict()}, d, name="yolov.msgpack"),
            save_checkpoint({"model": online.state_dict()}, d, name="online.msgpack"))


@pytest.mark.parametrize("wpost", [False, True])
def test_vid_demo_gmode(frames_dir, yolov_ckpts, tmp_path, wpost):
    """vid_demo (and vid_demo_wpost, REPP on) on a YOLOV exp with lframe 0:
    chunks of G frames, the last padded; every frame drawn and written."""
    from tscd_torch.tools import vid_demo, vid_demo_wpost
    argv = ["--exp", "yolov_selftest", "-c", yolov_ckpts[0], "--path", frames_dir,
            "--device", "cpu", "--conf", "0.001", "--output_dir", str(tmp_path)]
    res = (vid_demo_wpost if wpost else vid_demo).main(argv)
    assert all(d is not None for d in res["dets"]) and len(res["dets"]) == N_FRAMES
    assert res["drawn"] > 0
    assert len(read_mp4(res["path"])["samples"]) == N_FRAMES


def test_vid_demo_local_windows_chunking():
    """With local frames, len // L windows of L consecutive local frames and
    G global ones from random.Random(42), as tools/vid_demo.py:186-201."""
    import random
    from types import SimpleNamespace

    from tscd_torch.tools.vid_demo import run_windows
    calls = []

    def predict(imgs, te, resume, state):
        calls.append((imgs[:, 0, 0, 0].tolist(), resume))
        return [np.full((1, 7), imgs[k, 0, 0, 0], np.float32) for k in range(2)], state

    processed = np.arange(7, dtype=np.float32)[:, None, None, None] * np.ones((7, 1, 1, 3))
    dets = run_windows(SimpleNamespace(lframe_val=2, gframe_val=2), [None] * 7, processed,
                       predict)
    rng = random.Random(42)
    want = []
    for ci in range(3):
        li = [2 * ci, 2 * ci + 1]
        pool = [i for i in range(7) if i not in li]
        want.append((li + [rng.choice(pool) for _ in range(2)], ci != 0))
    assert calls == [([float(i) for i in idx], r) for idx, r in want]
    assert [d is None for d in dets] == [False] * 6 + [True]


@pytest.mark.parametrize("K", [1, 3])
def test_yolov_demo_online_matches_online_stream(frames_dir, yolov_ckpts, tmp_path, K):
    """yolov_demo_online at --online-batch K (3 over 5 frames: a full batch
    and a tail of 2): batches as the FrameBatcher flushes them, and each
    frame's detections equal to OnlineStream's run_batch on the same frames
    (the same code on the CPU: exactly)."""
    from tscd_torch.core.online import OnlineStream
    from tscd_torch.core.predict import detection_rows
    from tscd_torch.data.transforms import letterbox
    from tscd_torch.exp import get_exp
    from tscd_torch.tools import yolov_demo_online
    from tscd_torch.tools.tscd_eval import load_weights
    from tscd_torch.utils.video import read_frames
    res = yolov_demo_online.main(["--exp", "yolov_selftest", "-c", yolov_ckpts[1], "--path",
                                  frames_dir, "--device", "cpu", "--conf", "0.001",
                                  "--online-batch", str(K), "--max-wait-ms", "1e9",
                                  "--output_dir", str(tmp_path)])
    assert res["batches"] == ([1] * N_FRAMES if K == 1 else [3, 2])
    exp = get_exp(exp_name="yolov_selftest")
    model = exp.get_online_model(device="cpu")
    load_weights(model, yolov_ckpts[1])
    stream = OnlineStream(model, bank_frames=31, batch=K)
    xs = [letterbox(f, exp.test_size, dtype=np.uint8)[0] for f in read_frames(frames_dir)]
    want, i = [], 0
    for b in res["batches"]:
        want += [detection_rows(d)[0] for d in stream.run_batch(xs[i:i + b])]
        i += b
    assert len(want) == len(res["dets"]) == N_FRAMES
    for got, w in zip(res["dets"], want):
        np.testing.assert_array_equal(got, w)
    assert len(read_mp4(res["path"])["samples"]) == N_FRAMES


def test_demo_image_saves_drawn_jpeg(frames_dir, tmp_path):
    """demo image on a YOLOX exp: the saved file is the drawn image's JPEG;
    video and webcam raise naming cv2.VideoCapture, --int8 raises."""
    from tscd_torch.tools import demo
    frame = os.path.join(frames_dir, sorted(os.listdir(frames_dir))[0])
    (f, drawn, boxes, scores, cls_ids, ms), = demo.main(
        ["image", "-n", "ovis_still_selftest", "--path", frame, "--device", "cpu",
         "--save_result", "--conf", "0.0", "output_dir", str(tmp_path)])
    saved = tmp_path / "ovis_still_selftest" / "vis_res" / os.path.basename(frame)
    assert saved.read_bytes() == imencode_jpeg(drawn)
    assert len(boxes) == len(scores) == len(cls_ids) > 0
    for mode in ("video", "webcam"):
        with pytest.raises(NotImplementedError, match="VideoCapture"):
            demo.main([mode, "-n", "ovis_still_selftest", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="int8"):
        demo.main(["image", "-n", "ovis_still_selftest", "--device", "cpu", "--int8"])


def test_demo_tools_refuse_what_is_not_ported(frames_dir, tmp_path):
    """A video file in place of a frame directory raises naming
    cv2.VideoCapture; --int8 / --int8-calib raise naming queue 1 item 9; a
    tool with no --device asks for the card."""
    from tscd_torch.tools import tscd_demo, vid_demo
    base = ["--exp", "selftest", "-c", SELFTEST_CKPT, "--output_dir", str(tmp_path)]
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="VideoCapture"):
        tscd_demo.main(base + ["--path", str(video), "--device", "cpu"])
    for flag in (["--int8"], ["--int8-calib", "2"]):
        with pytest.raises(NotImplementedError, match="item 9"):
            vid_demo.main(base + ["--path", frames_dir, "--device", "cpu"] + flag)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tscd_demo.main(base + ["--path", frames_dir])


def test_models_build():
    """create_yolox_model (nano through x; nano depthwise) and create_model,
    yolov7 and yolov8 among its names."""
    from tscd_torch.models.build import _YOLOX_CFG, create_model, create_yolox_model
    from tscd_torch.models.yolov import YOLOVOnline
    nano, sd = create_yolox_model("yolox_nano", num_classes=3, device="cpu")
    assert sd is None and nano.num_classes == 3
    assert any("dconv" in k for k in nano.state_dict())
    assert set(_YOLOX_CFG) == {f"yolox-{s}" for s in ("nano", "tiny", "s", "m", "l", "x")}
    online = create_model("yolov-online", num_classes=4, depth=0.33, width=0.125,
                          num_proposals=4, heads=2, device="cpu")
    assert isinstance(online, YOLOVOnline)
    from tscd_torch.models.elan import YOLOv7
    from tscd_torch.models.yolov8 import YOLOv8
    assert isinstance(create_model("yolov7", num_classes=3, arch="tiny", device="cpu"), YOLOv7)
    assert isinstance(create_model("yolov8", num_classes=3, depth=0.33, width=0.25,
                                   device="cpu"), YOLOv8)


def test_repp_tool_matches_jax(tmp_path):
    """tscd_torch.tools.repp against JAX's tools/REPP.py on a seeded imdb
    pickle: the same COCO predictions, rescored imdb and motion result."""
    from tscd_torch.tools import repp as prepp
    rng = np.random.default_rng(3)
    preds, gts = {}, {}
    for v in range(2):
        frames, g = {}, {}
        base = rng.uniform(20, 200, (3, 2))
        for f in range(6):
            dets = []
            for k in range(3):
                x, y = base[k] + f * 2 + rng.normal(0, 1, 2)
                s = rng.dirichlet(np.ones(4)) * rng.uniform(0.3, 1)
                dets.append({"bbox": [float(x), float(y), 40.0, 30.0], "scores": s,
                             "image_id": f"v{v}/{f:06d}"})
            frames[f"{f:06d}"] = dets
            g[f"{f:06d}"] = np.array([[*(base[0] + f * 2), *(base[0] + f * 2 + [40, 30]), 1]])
        preds[f"v{v}"], gts[f"v{v}"] = frames, g
    pk, gk = tmp_path / "preds.pkl", tmp_path / "gts.pkl"
    pk.write_bytes(pickle.dumps(preds))
    gk.write_bytes(pickle.dumps(gts))
    spec = importlib.util.spec_from_file_location("jax_repp_tool",
                                                  os.path.join(REPO, "tools", "REPP.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args = ["--predictions", str(pk), "--post", "--evaluate", "--annotations", str(gk),
            "--min_tubelet_score", "0.1"]
    mp = pytest.MonkeyPatch()
    printed = []
    try:
        mp.setattr(sys, "argv", ["REPP.py", *args, "--out", str(tmp_path / "j.json"),
                                 "--imdb_out", str(tmp_path / "j.pkl")])
        mp.setattr("builtins.print", lambda *a, **k: printed.append(a))
        tool.main()
    finally:
        mp.undo()
    res = prepp.main([*args, "--out", str(tmp_path / "p.json"),
                      "--imdb_out", str(tmp_path / "p.pkl")])
    assert (tmp_path / "j.json").read_text() == (tmp_path / "p.json").read_text()
    assert len(res["coco"]) > 0
    jimdb = pickle.loads((tmp_path / "j.pkl").read_bytes())
    pimdb = pickle.loads((tmp_path / "p.pkl").read_bytes())
    assert jimdb.keys() == pimdb.keys()
    for v in jimdb:
        for name in jimdb[v]:
            for a, b in zip(jimdb[v][name], pimdb[v][name]):
                np.testing.assert_array_equal(np.asarray(a["bbox"]), np.asarray(b["bbox"]))
                np.testing.assert_array_equal(a["scores"], b["scores"])
    assert printed[-1][0] == res["motion"]
