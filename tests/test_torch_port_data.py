"""The port's VID val data path against the JAX package's, on the CPU:
sequence construction under one seed, the fixture's XML annotations, the
fixture's windows from both WindowLoaders (selftest: 1 + 3 frames,
128 px, uint8) and a frame resize, all equal exactly (the same cv2 calls
and numpy arithmetic on both sides). Also: without cv2 the module still
imports and reading a frame raises.
"""

import glob
import os
import random
import subprocess
import sys

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


def test_without_cv2_the_module_imports_and_load_frame_raises():
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "import random\n"
        "from tscd_torch.data import vid\n"
        f"ds = vid.VIDDataset({VAL_SEQ!r}, img_size=(128, 128), lframe=1, gframe=3,\n"
        f"                    dataset_pth={FIXTURE!r}, formal=True)\n"
        "try:\n"
        "    ds.load_frame(ds.res[0][0])\n"
        "except ImportError as e:\n"
        "    assert 'cv2' in str(e), e\n"
        "    print('raised')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "raised"
