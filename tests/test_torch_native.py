"""The port's native library (``crowdmod_tpu_torch.native``, built with g++
into ``crowdmod_tpu_torch/_build/``) and the ``.cmb`` sidecar of its pickle
loader, on the CPU: each function against its numpy twin and against the
JAX package's function; ``.cmb`` files of either package read in the other;
a corrupt sidecar is rebuilt; ``CROWDMOD_CMB_CACHE=0`` writes none; a
failed build raises with the compiler's message (no numpy fallback)."""

import os
import pickle

import numpy as np
import pytest

from crowdmod_tpu import native as jax_native
from crowdmod_tpu.data import ingest as jax_ingest
from crowdmod_tpu_torch import native
from crowdmod_tpu_torch.data import ingest
from crowdmod_tpu_torch.native import build


def test_native_builds_into_the_port_build_dir():
    assert native.native_available()
    path = build.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "crowdmod_tpu_torch"


@pytest.mark.parametrize("shape", [(5, 4, 6, 9, 11), (1, 3, 12, 36, 8), (0, 4, 2, 2, 3)])
def test_transpose_equals_twin_and_jax(shape):
    a = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    out = native.transpose_to_native(a)
    assert out.flags["C_CONTIGUOUS"] and out.shape == shape[:1] + shape[4:] + shape[2:4] + shape[1:2]
    np.testing.assert_array_equal(out, native.transpose_to_native_reference(a))
    np.testing.assert_array_equal(out, jax_native.transpose_to_native(a))


def test_gather_windows_equals_twin_and_jax():
    rng = np.random.default_rng(1)
    raw = rng.normal(size=(4, 20, 6, 9, 3)).astype(np.float32)
    seq, t0 = np.array([0, 2, 3, 1, 2]), np.array([0, 5, 12, 7, 12])
    out = native.gather_windows(raw, seq, t0, window=8)
    assert out.shape == (5, 8, 6, 9, 3)
    np.testing.assert_array_equal(out, native.gather_windows_reference(raw, seq, t0, 8))
    np.testing.assert_array_equal(out, jax_native.gather_windows(raw, seq, t0, window=8))
    for bad_seq, bad_t0 in (([4], [0]), ([0], [13]), ([-1], [0])):  # checked before C runs
        with pytest.raises(ValueError, match="outside"):
            native.gather_windows(raw, np.array(bad_seq), np.array(bad_t0), window=8)


def test_bin_frames_equals_twin_and_jax():
    rng = np.random.default_rng(2)
    n = 300
    lu = (38.2789, -15.8076)
    x, y = rng.uniform(37, 76, n), rng.uniform(-17, -2, n)  # some off the grid
    vx, vy = rng.normal(0, 1, n), rng.normal(0, 1, n)
    vn = np.hypot(vx, vy)
    offsets = np.array([0, 100, 100, 300])  # the middle frame is empty
    geo = dict(rows=12, cols=36, dx=1.0, dy=1.0, lu=lu)
    out = native.bin_frames(x, y, vx, vy, vn, offsets, **geo)
    assert out.shape == (3, 12, 36, 4) and not out[1].any() and out[..., 0].sum() > 100
    np.testing.assert_allclose(out, native.bin_frames_reference(x, y, vx, vy, vn, offsets, **geo),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out, jax_native.bin_frames(x, y, vx, vy, vn, offsets, **geo))
    for bad in ([0, 100, 50, 300], [0, 301]):
        with pytest.raises(ValueError, match="do not split"):
            native.bin_frames(x, y, vx, vy, vn, np.array(bad), **geo)


@pytest.mark.parametrize("writer", ["port", "port twin", "jax"])
def test_cmb_files_read_in_both_packages(tmp_path, writer):
    a = np.random.default_rng(3).normal(size=(3, 4, 5, 2)).astype(np.float32)
    p = str(tmp_path / "t.cmb")
    {"port": native.write_tensor, "port twin": native.write_tensor_reference,
     "jax": jax_native.write_tensor}[writer](p, a)
    for read in (native.read_tensor, native.read_tensor_reference, jax_native.read_tensor):
        b = read(p)
        assert b.shape == a.shape
        np.testing.assert_array_equal(a, b)


def test_cmb_reads_refuse_missing_and_truncated_files(tmp_path):
    p = tmp_path / "t.cmb"
    native.write_tensor(str(p), np.ones((4, 5), np.float32))
    p.write_bytes(p.read_bytes()[:-8])
    for read in (native.read_tensor, native.read_tensor_reference):
        with pytest.raises(OSError):
            read(str(p))
        with pytest.raises(OSError):
            read(str(tmp_path / "missing.cmb"))


def _pickle(path, arr):
    with open(path, "wb") as f:
        pickle.dump(arr, f)


def test_load_pickles_writes_then_reads_the_sidecar(tmp_path, monkeypatch):
    monkeypatch.delenv("CROWDMOD_CMB_CACHE", raising=False)
    h, w, L = 4, 6, 10
    arrs = [np.random.default_rng(k).normal(size=(n, 4, h, w, L)).astype(np.float32)
            for k, n in enumerate((3, 2))]
    files = []
    for k, a in enumerate(arrs):
        _pickle(tmp_path / f"{k}.pkl", a)
        files.append((str(tmp_path / f"{k}.pkl"), len(a)))
    first, stats = ingest.load_pickles(files, 3, (h, w, L))
    assert all(os.path.exists(p + ".cmb") for p, _ in files)
    # The second load reads the sidecars: a pickle that no longer unpickles
    # (but is not newer than its sidecar) is never opened.
    for p, _ in files:
        mtime = os.path.getmtime(p + ".cmb")
        open(p, "wb").write(b"not a pickle")
        os.utime(p, (mtime - 10, mtime - 10))
    second, stats2 = ingest.load_pickles(files, 3, (h, w, L))
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(stats, stats2)
    want = np.concatenate(arrs).transpose(0, 4, 2, 3, 1)[..., :3]
    np.testing.assert_array_equal(first, want)
    jax_first, jax_stats = jax_ingest.load_pickles(files, 3, (h, w, L))  # the port's sidecars
    np.testing.assert_array_equal(jax_first, first)
    np.testing.assert_array_equal(jax_stats, stats)


def test_jax_sidecar_reads_in_the_port(tmp_path, monkeypatch):
    monkeypatch.delenv("CROWDMOD_CMB_CACHE", raising=False)
    arr = np.random.default_rng(5).normal(size=(2, 4, 3, 5, 6)).astype(np.float32)
    p = str(tmp_path / "j.pkl")
    _pickle(p, arr)
    want = jax_ingest.load_pickle_native(p, mprops_count=3)  # writes the sidecar
    assert os.path.exists(p + ".cmb")
    _pickle(p, np.zeros_like(arr))  # not read while the sidecar is newer
    os.utime(p, (os.path.getmtime(p + ".cmb") - 10,) * 2)
    np.testing.assert_array_equal(ingest.load_pickle_native(p, mprops_count=3), want)


def test_corrupt_sidecar_is_rebuilt(tmp_path, monkeypatch):
    monkeypatch.delenv("CROWDMOD_CMB_CACHE", raising=False)
    arr = np.arange(4 * 4 * 3 * 2 * 5, dtype=np.float32).reshape(4, 4, 3, 2, 5)
    p = tmp_path / "d.pkl"
    _pickle(p, arr)
    good = ingest.load_pickle_native(str(p), mprops_count=4)
    cmb = str(p) + ".cmb"
    data = open(cmb, "rb").read()
    open(cmb, "wb").write(data[: len(data) // 2])  # truncated mid-payload
    os.utime(cmb)  # still newer than the pickle
    np.testing.assert_array_equal(ingest.load_pickle_native(str(p), mprops_count=4), good)
    np.testing.assert_array_equal(native.read_tensor(cmb), arr)  # rebuilt whole
    np.testing.assert_array_equal(good, jax_ingest.load_pickle_native(str(p), mprops_count=4))


def test_cache_off_writes_no_sidecar(tmp_path, monkeypatch):
    monkeypatch.setenv("CROWDMOD_CMB_CACHE", "0")
    arr = np.ones((2, 4, 3, 2, 5), np.float32)
    p = str(tmp_path / "x.pkl")
    _pickle(p, arr)
    out, _ = ingest.load_pickles([(p, 2)], 4, (3, 2, 5))
    assert not os.path.exists(p + ".cmb")
    np.testing.assert_array_equal(out, arr.transpose(0, 4, 2, 3, 1))


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(build, "SRC", broken)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_loaded", [])
    with pytest.raises(RuntimeError, match=r"(?s)broken\.cpp failed .*error"):
        native.transpose_to_native(np.zeros((1, 1, 1, 1, 1), np.float32))
    assert not native.native_available()
    assert not list((tmp_path / "_build").glob("*"))  # no half-written library
