"""The port's image and video output (tscd_torch/data/image.py:
imencode_jpeg, imwrite over csrc/host/image.cpp; tscd_torch/utils/video.py:
VideoWriter, read_mp4, read_frames) against cv2 5.0.0: the JPEG bytes equal
cv2.imencode(".jpg") at its defaults, and cv2.VideoCapture reads the
Motion JPEG MP4 back."""

import os

import cv2
import numpy as np
import pytest

from tscd_torch.data.image import imdecode, imencode_jpeg, imread, imwrite
from tscd_torch.utils.video import VideoWriter, read_frames, read_mp4

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX0 = os.path.join(REPO, "tscd_torch", "data", "fixtures", "vid", "Data", "VID", "val",
                    "fix0")


def _cv2_jpeg(img):
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("shape", [(1, 1), (15, 17), (33, 47), (720, 1280), (16, 16),
                                   (17, 15), (2, 31), (8, 9)])
def test_jpeg_noise_like_cv2(shape):
    """Seeded noise (every edge case of the 4:2:0 MCU grid: sides under,
    at and past multiples of 8 and 16) and flat images."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    assert imencode_jpeg(img) == _cv2_jpeg(img)
    for v in (0, 128, 255):
        flat = np.full((*shape, 3), v, np.uint8)
        assert imencode_jpeg(flat) == _cv2_jpeg(flat)


def test_jpeg_fixture_frames_like_cv2():
    """The 720p fixture frames (decoded), a strided view of one and a crop
    of odd size: cv2's bytes, and the port's decoder reads them back as
    cv2 does."""
    files = sorted(os.listdir(FIX0))
    for f in files[::8]:
        img = imread(os.path.join(FIX0, f))
        data = imencode_jpeg(img)
        assert data == _cv2_jpeg(img)
        np.testing.assert_array_equal(imdecode(data),
                                      cv2.imdecode(np.frombuffer(data, np.uint8), 1))
    img = imread(os.path.join(FIX0, files[1]))
    crop = img[7:700:2, 13:1001]
    assert not crop.flags.c_contiguous
    assert imencode_jpeg(crop) == _cv2_jpeg(np.ascontiguousarray(crop))


def test_imwrite(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (33, 47, 3), dtype=np.uint8)
    for name in ("a.jpg", "b.JPEG"):
        imwrite(str(tmp_path / name), img)
        assert (tmp_path / name).read_bytes() == _cv2_jpeg(img)
    with pytest.raises(ValueError, match="JPEG"):
        imwrite(str(tmp_path / "c.png"), img)
    with pytest.raises(ValueError):
        imencode_jpeg(img[..., 0])


def test_mp4_reads_back_through_cv2(tmp_path):
    """VideoWriter's file: cv2.VideoCapture opens it as MJPG at 25 frames/s
    with the frame count and size; read_mp4 parses it into the samples,
    each the encoder's bytes of its frame, each decoding through cv2 as
    through the port."""
    frames = [imread(os.path.join(FIX0, f)) for f in sorted(os.listdir(FIX0))[:6]]
    path = str(tmp_path / "out.mp4")
    with VideoWriter(path, 25, (frames[0].shape[1], frames[0].shape[0])) as w:
        for f in frames:
            w.write(f)
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    fourcc = int(cap.get(cv2.CAP_PROP_FOURCC))
    assert fourcc.to_bytes(4, "little") == b"MJPG"
    assert cap.get(cv2.CAP_PROP_FPS) == 25.0
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(frames)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        assert frame.shape == frames[0].shape
        n += 1
    assert n == len(frames)
    m = read_mp4(path)
    assert (m["codec"], m["object_type"], m["width"], m["height"], m["fps"]) == \
        ("mp4v", 0x6C, 1280, 720, 25.0)
    assert len(m["samples"]) == len(frames)
    for s, f in zip(m["samples"], frames):
        assert s == imencode_jpeg(f)
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(s, np.uint8), 1), imdecode(s))


def test_video_writer_checks(tmp_path):
    path = str(tmp_path / "x.mp4")
    w = VideoWriter(path, 25, (16, 8))
    with pytest.raises(ValueError, match="frame"):
        w.write(np.zeros((16, 8, 3), np.uint8))
    w.release()
    assert read_mp4(path)["samples"] == []
    with pytest.raises(ValueError):
        VideoWriter(str(tmp_path / "y.mp4"), 0, (16, 8))


def test_read_frames(tmp_path):
    """A directory's JPEG frames in name order, as cv2.imread reads them; a
    video file raises naming cv2.VideoCapture; a PNG raises."""
    got = list(read_frames(FIX0))
    files = sorted(os.listdir(FIX0))
    assert len(got) == len(files)
    np.testing.assert_array_equal(got[5], cv2.imread(os.path.join(FIX0, files[5])))
    with pytest.raises(NotImplementedError, match="VideoCapture"):
        list(read_frames(os.path.join(FIX0, files[0])))
    (tmp_path / "a.png").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="JPEG"):
        list(read_frames(str(tmp_path)))
