"""The port's VID data path against the JAX package's, on the CPU:
sequence construction under one seed, the fixture's XML annotations, the
fixture's windows from both WindowLoaders (selftest: 1 + 3 frames,
128 px, uint8) and a frame resize, all equal exactly (the port's image ops
give cv2's pixels). Also: with cv2 unimportable the port reads the
fixtures' frames to JAX's pixels; the train collate with HSV jitter and
flip equals JAX's given the same draws; multiscale_resize equals JAX's on
a float32 window of JAX's own train loader.
"""

import glob
import os
import random
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tscd_tpu.data import vid as jvid
from tscd_torch.data import vid as pvid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "YOLOX_outputs", "validate_ref", "vid")
VAL_SEQ = os.path.join(FIXTURE, "val_seq.npy")


def _videos(n=2, length=12):
    return [[f"v{v}/{i:06d}.JPEG" for i in range(length)] for v in range(n)]


# the cases of tests/test_vid_datasets.py, plus the short-video (formal)
# and gl branches
_SEQ_CASES = {
    "random_local_global": (_videos(), dict(lframe=2, gframe=3, mode="random", val=True)),
    "gframe_only": (_videos(), dict(lframe=0, gframe=4, mode="random", val=True)),
    "uniform": (_videos(1), dict(lframe=0, gframe=4, mode="uniform", val=True)),
    "traj_linking": (_videos(1), dict(lframe=4, gframe=2, mode="random",
                                      traj_linking=True, val=True)),
    "training_caps": (_videos(1, 400), dict(
        lframe=4, gframe=2, mode="random", training=True, seq_cap_per_video=15,
        label_counts={p: 1 for p in _videos(1, 400)[0]})),
    "short_formal": (_videos(2, 5), dict(lframe=1, gframe=31, mode="random",
                                         formal=True, val=True)),
    "gl": (_videos(2, 9), dict(lframe=2, gframe=3, mode="gl", val=True, tnum=5)),
    "local_stride": (_videos(1, 12), dict(lframe=2, gframe=0, mode="random",
                                          local_stride=3, val=True)),
}


@pytest.mark.parametrize("case", sorted(_SEQ_CASES))
def test_build_sequences_matches_jax(case):
    videos, kw = _SEQ_CASES[case]
    got = pvid.build_sequences(videos, rng=random.Random(7), **kw)
    want = jvid.build_sequences(videos, rng=random.Random(7), **kw)
    assert got and got == want


@pytest.mark.parametrize("img_size", [(128, 128), (576, 576)])
def test_parse_vid_xml_matches_jax(img_size):
    xmls = sorted(glob.glob(os.path.join(FIXTURE, "Annotations", "VID", "val", "*", "*.xml")))
    assert len(xmls) == 16
    n = 0
    for x in xmls:
        got, want = pvid.parse_vid_xml(x, img_size), jvid.parse_vid_xml(x, img_size)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        n += len(got)
    assert n > 0


def _datasets(img_size=(128, 128), lframe=1, gframe=3):
    kw = dict(img_size=img_size, lframe=lframe, gframe=gframe, val=True,
              mode="random", dataset_pth=FIXTURE, formal=True)
    random.seed(0)
    port = pvid.VIDDataset(VAL_SEQ, **kw)
    random.seed(0)
    ref = jvid.VIDDataset(VAL_SEQ, training=False, **kw)
    return port, ref


def test_window_loaders_give_the_same_uint8_windows():
    port, ref = _datasets()
    assert port.res == ref.res and len(port.res) == 16
    got = list(pvid.WindowLoader(port, img_dtype=np.uint8))
    want = list(jvid.WindowLoader(ref, shuffle=False, max_labels=120,
                                  img_dtype=np.uint8))
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert g["imgs"].dtype == np.uint8 and g["imgs"].shape == (4, 128, 128, 3)
        assert np.array_equal(g["imgs"], w["imgs"])
        assert np.array_equal(g["labels"], w["labels"])
        assert g["time_embedding"].dtype == w["time_embedding"].dtype
        assert np.array_equal(g["time_embedding"], w["time_embedding"])
        assert g["infos"] == w["infos"] and g["paths"] == w["paths"]
    assert any(g["labels"].any() for g in got)


def test_load_frame_resize_matches_jax():
    port, ref = _datasets(img_size=(96, 96))
    for path in (port.videos[0][0], port.videos[1][5]):
        (gi, ga, gs), (wi, wa, ws) = port.load_frame(path), ref.load_frame(path)
        assert gi.dtype == np.uint8 and gi.shape == wi.shape
        assert max(gi.shape[:2]) == 96 and gs == ws and max(gs) > 96
        assert np.array_equal(gi, wi) and np.array_equal(ga, wa)


def test_loader_raises_what_load_frame_raises():
    port, _ = _datasets()

    class Broken:
        img_size, res = port.img_size, port.res

        def load_frame(self, path):
            raise OSError(f"cannot read {path}")

        frame_index = port.frame_index

    with pytest.raises(OSError, match="cannot read"):
        next(iter(pvid.WindowLoader(Broken())))


def test_without_cv2_load_frame_equals_jax_pixels(tmp_path):
    """The port's load_frame in a process where cv2 cannot be imported, on
    both fixtures (128 px frames to 96 px; 720p frames to 576 px), against
    JAX's load_frame here."""
    new = os.path.join(REPO, "tscd_torch", "data", "fixtures", "vid")
    cases = [(VAL_SEQ, FIXTURE, 96), (os.path.join(new, "val_seq.npy"), new, 576)]
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from tscd_torch.data import vid\n"
        f"out = {{}}\n"
        f"for i, (seq, root, size) in enumerate({cases!r}):\n"
        "    ds = vid.VIDDataset(seq, img_size=(size, size), lframe=1, gframe=3,\n"
        "                        dataset_pth=root, formal=True)\n"
        "    for v in ds.videos:\n"
        "        for p in (v[0], v[-1]):\n"
        "            img, annos, hw = ds.load_frame(p)\n"
        "            out[f'{i}|{p}'] = img\n"
        f"np.savez({str(tmp_path / 'frames.npz')!r}, **out)\n"
        "print('read', len(out))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = np.load(tmp_path / "frames.npz")
    assert r.stdout.strip() == f"read {len(got.files)}" and len(got.files) == 6
    for key in got.files:
        i, path = key.split("|", 1)
        seq, root, size = cases[int(i)]
        ref = jvid.VIDDataset(seq, img_size=(size, size), lframe=1, gframe=3, val=True,
                              dataset_pth=root, formal=True)
        want = ref.load_frame(path)[0]
        assert got[key].shape == want.shape and np.array_equal(got[key], want), key
        assert max(want.shape[:2]) == size


class _Draws:
    """A generator that hands out fixed draws: `random()` the coins, then
    `uniform` and `integers` the gains' two factors."""

    def __init__(self, coins, uniform, ints):
        self.coins, self.u, self.i = list(coins), np.asarray(uniform), np.asarray(ints)

    def random(self):
        return self.coins.pop(0)

    def uniform(self, lo, hi, n):
        assert (lo, hi, n) == (-1, 1, 3)
        return self.u

    def integers(self, lo, hi, n):
        assert (lo, hi, n) == (0, 2, 3)
        return self.i


class _Frames:
    img_size = (128, 128)

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.paths = [f"v/{i:06d}.JPEG" for i in range(4)]
        self.frames = {p: rng.integers(0, 256, (72, 128, 3), dtype=np.uint8) for p in self.paths}
        self.annos = {p: np.array([[10, 5, 60, 40, 3], [70, 20, 120, 70, 7]], np.float32)
                      for p in self.paths}

    def load_frame(self, p):
        return self.frames[p], self.annos[p].copy(), (720, 1280)

    def frame_index(self, p):
        return int(os.path.splitext(os.path.basename(p))[0])


@pytest.mark.parametrize("coins,uniform,ints", [
    ((0.3, 0.2), (0.9, -0.7, 0.4), (1, 1, 1)),       # jitter and flip
    ((0.3, 0.8), (-0.95, 0.2, -1.0), (1, 0, 1)),     # jitter, no flip
    ((0.99, 0.1), (0.0, 0.0, 0.0), (0, 0, 0)),       # flip only (hsv_prob 0.5)
], ids=["hsv_flip", "hsv", "flip"])
def test_train_collate_with_hsv_and_flip_matches_jax(monkeypatch, coins, uniform, ints):
    ds = _Frames()
    kw = dict(train_time_index=True, cxcywh=True, augment=True, hsv_prob=0.5, flip_prob=0.5)
    jcoins = list(coins)
    monkeypatch.setattr(jvid.random, "random", lambda: jcoins.pop(0))
    monkeypatch.setattr(jvid.np.random, "uniform", lambda lo, hi, n: np.asarray(uniform))
    monkeypatch.setattr(jvid.np.random, "randint", lambda lo, hi, n: np.asarray(ints))
    want = jvid.collate_window(ds, ds.paths, 120, **kw)
    assert not jcoins
    with ThreadPoolExecutor(2) as pool:
        got = pvid.collate_window(ds, ds.paths, pool, 120, np.uint8,
                                  rng=_Draws(coins, uniform, ints), **kw)
        plain = pvid.collate_window(ds, ds.paths, pool, 120, np.uint8,
                                    train_time_index=True, cxcywh=True)
    assert np.array_equal(got["imgs"].astype(np.float32), want["imgs"])
    assert np.array_equal(got["labels"], want["labels"])
    assert np.array_equal(got["time_embedding"], want["time_embedding"])
    assert not np.array_equal(got["imgs"], plain["imgs"])
    assert all(np.array_equal(ds.frames[p], _Frames().frames[p]) for p in ds.paths)


NEW_FIXTURE = os.path.join(REPO, "tscd_torch", "data", "fixtures", "vid")


@pytest.fixture(scope="module")
def jax_train_window():
    """A window of JAX's own train loader as JAX's trainer gets it: float32
    (the loader's default), HSV-jittered and flipped, 1 + 1 frames of the
    720p fixture letterboxed to 576 px."""
    random.seed(3)
    ds = jvid.VIDDataset(os.path.join(NEW_FIXTURE, "val_seq.npy"), img_size=(576, 576),
                         lframe=1, gframe=1, val=True, mode="random",
                         dataset_pth=NEW_FIXTURE, formal=True, training=False)
    np.random.seed(3)
    loader = jvid.WindowLoader(ds, shuffle=False, max_labels=120, train_time_index=True,
                               cxcywh=True, augment=True, hsv_prob=1.0, flip_prob=0.5)
    window = next(iter(loader))
    assert window["imgs"].dtype == np.float32 and window["imgs"].shape == (2, 576, 576, 3)
    return window


@pytest.mark.parametrize("target", [(384, 384), (640, 640), (576, 576)])
def test_multiscale_resize_matches_jax(jax_train_window, target):
    """The port resizes its uint8 window to JAX's float32 frames bit for bit
    (JAX's cv2.resize of a float32 window gives fractional values), and
    scales the labels alike."""
    imgs, labels = jax_train_window["imgs"], jax_train_window["labels"]
    assert labels.any()
    window = imgs.astype(np.uint8)
    assert np.array_equal(window.astype(np.float32), imgs)
    want_i, want_l = jvid.multiscale_resize(imgs, labels, target)
    got_i, got_l = pvid.multiscale_resize(window, labels, target)
    assert got_i.shape == (2, *target, 3)
    if target == (576, 576):
        assert got_i is window
    else:
        assert got_i.dtype == np.float32 and (got_i != np.round(got_i)).any()
    assert np.array_equal(np.asarray(got_i, np.float32), want_i)
    assert np.array_equal(got_l, want_l)
