"""The port's native crop (``theanompi_torch.native``) against the
reference's numpy loop, on the CPU.

- ``crop_mirror_batch`` gives the bytes of the numpy per-image loop, for
  uint8 and fp32 batches, and refuses crops that leave the images;
- the port's ``random_crop_mirror`` and ``pad_crop_mirror`` (C crop) give
  the reference's bytes with the reference's C helper switched off (its
  numpy loop), and the port's numpy fallback gives them too;
- the library is built once and cached under
  ``theanompi_torch/native/_build/``, and a build writes nothing under
  ``theanompi_tpu/``;
- a failed build says so in one line on stderr, and the loaders fall
  back to the numpy loop.
"""

import os

import numpy as np
import pytest

from theanompi_tpu import native as ref_native
from theanompi_tpu.models.data import cifar10 as RC
from theanompi_tpu.models.data import imagenet as RI

from theanompi_torch import native
from theanompi_torch.models.data import cifar10 as C
from theanompi_torch.models.data import imagenet as I

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy_loop(src, out_h, out_w, ys, xs, flips):
    res = np.empty((src.shape[0], out_h, out_w, src.shape[3]), src.dtype)
    for i in range(src.shape[0]):
        img = src[i, ys[i]: ys[i] + out_h, xs[i]: xs[i] + out_w]
        res[i] = img[:, ::-1] if flips[i] else img
    return res


@pytest.fixture
def ref_numpy_loop(monkeypatch):
    """The reference's loaders on their numpy loop (its C helper off)."""
    monkeypatch.setattr(ref_native, "crop_mirror_batch",
                        lambda *a, **k: None)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_crop_mirror_batch_equals_the_numpy_loop(dtype):
    assert native.available(), "cc is on this machine: the build must work"
    rng = np.random.RandomState(0)
    src = (rng.rand(16, 40, 36, 3) * 255).astype(dtype)
    ys = rng.randint(0, 9, 16)
    xs = rng.randint(0, 5, 16)
    flips = rng.rand(16) < 0.5
    got = native.crop_mirror_batch(src, 32, 32, ys, xs, flips)
    assert got.dtype == dtype and got.shape == (16, 32, 32, 3)
    np.testing.assert_array_equal(got, _numpy_loop(src, 32, 32, ys, xs,
                                                   flips))


def test_crops_outside_the_images_are_refused():
    src = np.zeros((2, 10, 10, 3), np.uint8)
    ok = np.zeros(2, np.int64)
    for ys, xs, flips in ((np.array([0, 3]), ok, ok),   # 3 + 8 > 10
                          (ok, np.array([-1, 0]), ok),
                          (ok, np.zeros(3, np.int64), ok)):
        with pytest.raises(ValueError, match="offsets"):
            native.crop_mirror_batch(src, 8, 8, ys, xs, flips)
    assert native.crop_mirror_batch(src, 8, 8, np.array([2, 0]), ok,
                                    ok).shape == (2, 8, 8, 3)


def test_loaders_equal_the_reference_numpy_loop(ref_numpy_loop,
                                                monkeypatch):
    rng = np.random.RandomState(3)
    x32 = rng.rand(8, 32, 32, 3).astype(np.float32)
    x48 = (rng.rand(8, 48, 48, 3) * 255).astype(np.uint8)
    ref = (RC.pad_crop_mirror(x32, np.random.RandomState(7)),
           RI.random_crop_mirror(x48, 40, np.random.RandomState(7)))
    fast = (C.pad_crop_mirror(x32, np.random.RandomState(7)),
            I.random_crop_mirror(x48, 40, np.random.RandomState(7)))
    monkeypatch.setattr(native, "crop_mirror_batch", lambda *a, **k: None)
    slow = (C.pad_crop_mirror(x32, np.random.RandomState(7)),
            I.random_crop_mirror(x48, 40, np.random.RandomState(7)))
    for r, f, s in zip(ref, fast, slow):
        assert f.dtype == r.dtype
        np.testing.assert_array_equal(f, r)
        np.testing.assert_array_equal(s, r)


def test_build_is_cached_under_the_ports_build_dir():
    handle = native.lib()
    assert handle is not None and native.lib() is handle
    assert native._SO == os.path.join(REPO, "theanompi_torch", "native",
                                      "_build", "libaugment.so")
    assert os.path.exists(native._SO)
    before = os.path.getmtime(native._SO)
    # a fresh load (as a new process makes) finds the library built
    assert native._build() == native._SO
    assert os.path.getmtime(native._SO) == before


def test_a_build_writes_nothing_under_the_reference(monkeypatch):
    port_build = os.path.join(REPO, "theanompi_torch", "native", "_build")
    assert native._SRC == os.path.join(REPO, "theanompi_torch", "native",
                                       "augment.c")
    calls = []
    run = native.subprocess.run

    def recording(cmd, **kw):
        calls.append(list(cmd))
        return run(cmd, **kw)

    # force a rebuild (the library older than its source) and watch it
    os.utime(native._SO, (0, 0))
    monkeypatch.setattr(native.subprocess, "run", recording)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.lib() is not None
    assert len(calls) == 1, calls
    out = calls[0][calls[0].index("-o") + 1]
    assert os.path.dirname(out) == port_build
    assert native._SRC in calls[0]
    assert not any("theanompi_tpu" in a for a in calls[0])
    assert os.path.getmtime(native._SO) >= os.path.getmtime(native._SRC)
    assert not [f for f in os.listdir(port_build) if f.endswith(".tmp")]


def test_a_failed_build_says_so_and_falls_back(monkeypatch, tmp_path,
                                               capsys, ref_numpy_loop):
    def no_compiler(*a, **k):
        raise FileNotFoundError("no such compiler")

    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    monkeypatch.setattr(native, "_SO", str(tmp_path / "libaugment.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.lib() is None and not native.available()
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "numpy loop" in err[0], err
    x = (np.random.RandomState(1).rand(4, 20, 20, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        I.random_crop_mirror(x, 16, np.random.RandomState(2)),
        RI.random_crop_mirror(x, 16, np.random.RandomState(2)))
