"""UCF101's PyAV loader of the PyTorch port (ddmi_tpu_torch/data/video.py)
against the JAX package's, on the CPU.  PyAV is not installed here, so a
stub `av` module in sys.modules serves both packages synthetic frames: a
few clips of other lengths (one shorter than the window, so its last
frame repeats) and non-square sizes (so the centre crop cuts).  The
batches agree bit for bit on one seed; without `av` both raise
ImportError.
"""

import sys
import types

import numpy as np
import pytest

pytest.importorskip("PIL")

FRAMES, RES = 4, 16
SIZES = {"a.avi": (7, 40, 30), "b.mp4": (3, 24, 36), "c.mkv": (9, 32, 32), "d.avi": (5, 20, 28)}


def _stub_av():
    """A module with PyAV's `open(path)` -> container, whose
    `decode(container.streams.video[0])` yields frames with `to_image()`:
    seeded RGB noise, the count and size by file name."""
    from PIL import Image

    class Frame:
        def __init__(self, arr):
            self.arr = arr

        def to_image(self):
            return Image.fromarray(self.arr)

    class Container:
        def __init__(self, path):
            name = path.rsplit("/", 1)[-1]
            n, w, h = SIZES[name]
            rng = np.random.default_rng(sorted(SIZES).index(name))
            self.frames = [Frame(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
                           for _ in range(n)]
            self.streams = types.SimpleNamespace(video=["stream0"])

        def decode(self, stream):
            assert stream == "stream0"
            return iter(self.frames)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    return types.SimpleNamespace(open=Container)


@pytest.fixture
def clips(tmp_path, monkeypatch):
    for i, name in enumerate(sorted(SIZES)):
        d = tmp_path / f"class{i % 2}"
        d.mkdir(exist_ok=True)
        (d / name).write_bytes(b"")
    (tmp_path / "notes.txt").write_text("not a clip")
    monkeypatch.setitem(sys.modules, "av", _stub_av())
    return str(tmp_path)


def test_ucf101_batches_match_jax(clips):
    """make_video_dataset('ucf101', ...) of both packages on the same files
    and seed: the same batches, bit for bit ((2, 4, 16, 16, 3) float32 in
    [0, 1]); another seed gives others."""
    from ddmi_tpu.data.video import make_video_dataset as jax_make
    from ddmi_tpu_torch.data.video import UCF101VideoDataset, make_video_dataset

    kw = dict(frames=FRAMES, resolution=RES, seed=3, workers=2)
    ours, ref = make_video_dataset("ucf101", clips, 2, **kw), jax_make("UCF101", clips, 2, **kw)
    assert isinstance(ours, UCF101VideoDataset) and len(ours) == len(ref) == 2
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == (2, FRAMES, RES, RES, 3)
        assert 0.0 <= a.min() and a.max() <= 1.0
        assert np.array_equal(a, b)
    other = list(make_video_dataset("ucf101", clips, 2, **dict(kw, seed=4)))
    assert not all(np.array_equal(a, b) for a, b in zip(got, other))


def test_ucf101_needs_pyav(tmp_path, monkeypatch):
    """Without `av` both packages raise ImportError when the dataset is
    built, naming the frame-folder loader."""
    from ddmi_tpu.data.video import make_video_dataset as jax_make
    from ddmi_tpu_torch.data.video import make_video_dataset

    monkeypatch.setitem(sys.modules, "av", None)
    for make in (make_video_dataset, jax_make):
        with pytest.raises(ImportError, match="VideoFrameFolderDataset"):
            make("ucf101", str(tmp_path), 2)
