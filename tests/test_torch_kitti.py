"""The port's KITTI reader, its native loader and prefetcher, and the KITTI
layout writer against plo_tpu's: the loader cases of tests/test_native.py on
plo_tpu_torch.native, the reader's functions on a written layout, and the
writer's files. Every comparison is exact (the same bytes read, the same
float64 arithmetic).

plo_tpu's scans are read through its NumPy loader (its documented fallback,
the same arrays): its C++ prefetcher sets the stop flag outside the mutex,
so closing one can lose the worker's wakeup and hang in join()
(test_prefetcher_close_never_hangs pins the port's repair), and a hang
would stall the run."""
import os

import numpy as np
import pytest

from plo_tpu import native as jax_native
from plo_tpu.io import kitti as jax_kitti
from plo_tpu.io import synthetic as jax_synthetic
from plo_tpu_torch import native
from plo_tpu_torch.io import kitti, synthetic

N_FRAMES = 3


@pytest.fixture
def jax_numpy_loader(monkeypatch):
    monkeypatch.setattr(jax_native, "_ensure_built", lambda: None)


def write_bin(path, n, seed=0):
    data = np.random.default_rng(seed).random((n, 4)).astype(np.float32)
    data.tofile(path)
    return data


def test_native_loader_builds():
    assert native.library() is not None
    assert os.path.exists(native.LIBRARY)


def test_load_bin_padded(tmp_path):
    p = str(tmp_path / "a.bin")
    data = write_bin(p, 100)
    out, n = native.load_bin_padded(p, 128)
    assert n == 100
    np.testing.assert_array_equal(out[:100], data)
    assert (out[100:] == 0).all()


def test_load_bin_truncates(tmp_path):
    p = str(tmp_path / "b.bin")
    data = write_bin(p, 200)
    out, n = native.load_bin_padded(p, 128)
    assert n == 128
    np.testing.assert_array_equal(out, data[:128])


def test_load_bin_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.load_bin_padded(str(tmp_path / "missing.bin"), 16)


def test_prefetcher_order_and_contents(tmp_path, jax_numpy_loader):
    paths, datas = [], []
    for i in range(5):
        p = str(tmp_path / f"{i:06d}.bin")
        datas.append(write_bin(p, 50 + i, seed=i))
        paths.append(p)
    pf = native.ScanPrefetcher(paths, capacity=64)
    got = list(pf)
    pf.close()
    assert len(got) == 5
    for i, (arr, n) in enumerate(got):
        assert n == 50 + i
        np.testing.assert_array_equal(arr[:n], datas[i])
        assert (arr[n:] == 0).all()
    # The same scans as plo_tpu's prefetcher.
    ref = list(jax_native.ScanPrefetcher(paths, capacity=64))
    for (a, n), (b, m) in zip(got, ref):
        assert n == m
        np.testing.assert_array_equal(a, b)


def test_prefetcher_closed_early_joins(tmp_path):
    paths = [str(tmp_path / f"{i:06d}.bin") for i in range(4)]
    for i, p in enumerate(paths):
        write_bin(p, 10, seed=i)
    pf = native.ScanPrefetcher(paths, capacity=16)
    next(pf)
    pf.close()
    with pytest.raises(StopIteration):
        next(pf)


_CYCLES = """
import sys
from plo_tpu_torch import native
paths = sys.argv[1:]
for k in range(3000):
    pf = native.ScanPrefetcher(paths, 16)
    list(pf) if k % 2 else next(pf)
    pf.close()
print("closed 3000 times")
"""


def test_prefetcher_close_never_hangs(tmp_path):
    """3,000 prefetchers, each closed at the end of its files or after one:
    close() joins the thread every time. (Setting the stop flag outside the
    mutex lost the wakeup of a worker about to wait, and join() hung; a
    child process, so such a hang fails here instead of stalling the run.)"""
    import subprocess
    import sys
    paths = [str(tmp_path / f"{i:06d}.bin") for i in range(3)]
    for i, p in enumerate(paths):
        write_bin(p, 8, seed=i)
    native.library()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _CYCLES, *paths], capture_output=True,
                          text=True, timeout=120, cwd=repo,
                          env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 0 and "closed 3000 times" in proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """The same sequence written by the port's write_kitti_layout and by
    plo_tpu's (one scan larger than the capacity the tests read with)."""
    scans, gt = synthetic.synthetic_sequence(N_FRAMES, n_scans=16, azimuth_steps=180,
                                             speed=0.5, yaw_rate=0.01, seed=4)
    roots = {}
    for name, mod in (("port", synthetic), ("jax", jax_synthetic)):
        roots[name] = str(tmp_path_factory.mktemp(name))
        mod.write_kitti_layout(roots[name], scans, gt, seq="07")
    return roots, scans, gt


def test_write_kitti_layout_files_byte_equal(layouts):
    roots, _, _ = layouts
    rel = [os.path.join("poses", "07.txt"), os.path.join("sequences", "07", "calib.txt")]
    rel += [os.path.join("sequences", "07", "velodyne", f"{i:06d}.bin") for i in range(N_FRAMES)]
    listing = {r: sorted(os.path.relpath(os.path.join(d, f), r)
                         for d, _, fs in os.walk(r) for f in fs) for r in roots.values()}
    assert listing[roots["port"]] == listing[roots["jax"]] == sorted(rel)
    for r in rel:
        with open(os.path.join(roots["port"], r), "rb") as a, \
                open(os.path.join(roots["jax"], r), "rb") as b:
            assert a.read() == b.read(), r


def test_reader_matches_jax(layouts):
    roots, _, gt = layouts
    root = roots["port"]
    poses = kitti.read_poses(os.path.join(root, "poses", "07.txt"))
    np.testing.assert_array_equal(poses, jax_kitti.read_poses(os.path.join(root, "poses", "07.txt")))
    calib = os.path.join(root, "sequences", "07", "calib.txt")
    tr = kitti.read_calib_tr(calib)
    np.testing.assert_array_equal(tr, jax_kitti.read_calib_tr(calib))
    velo = kitti.poses_to_velodyne_frame(poses, tr)
    np.testing.assert_array_equal(velo, jax_kitti.poses_to_velodyne_frame(poses, tr))
    np.testing.assert_allclose(velo, gt, atol=1e-8)   # the calib round trip


@pytest.mark.parametrize("capacity", [None, 2000, 1 << 14], ids=["numpy", "cut", "padded"])
@pytest.mark.parametrize("start,count", [(0, None), (1, 2)])
def test_scan_iterator_matches_jax(layouts, capacity, start, count, jax_numpy_loader):
    """With a capacity through the prefetcher (one below a scan's size cuts
    it), without it with NumPy: the same indices and points as plo_tpu's."""
    roots, scans, _ = layouts
    root = roots["port"]
    got = list(kitti.kitti_scan_iterator(root, "07", start=start, count=count, capacity=capacity))
    ref = list(jax_kitti.kitti_scan_iterator(root, "07", start=start, count=count,
                                             capacity=capacity))
    assert [i for i, _ in got] == [i for i, _ in ref] == list(range(start, N_FRAMES))[:count]
    for (_, a), (_, b), s in zip(got, ref, scans[start:]):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, s[:capacity])
