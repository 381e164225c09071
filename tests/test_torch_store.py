"""The port's data layer against cone_tpu's, on the CPU: the native .cfs
reader (cone_tpu_torch/csrc/feature_store.cpp through
data/native_store.py), the pure-numpy reader, the LMDB reader, the
`convert-store` and `reformat` commands and the reformatters.

Limits: exact. The readers return equal arrays (values, dtype, shape) and
equal padded batches and lengths; convert-store writes the same bytes as
cone_tpu's CLI; reformat writes the same rows. The LMDB database is a
dict-backed stand-in for the `lmdb` module (this machine has no lmdb),
put into sys.modules for both packages.
"""

import io
import json
import os
import subprocess
import sys
import types

import h5py
import numpy as np
import pytest
import torch

from cone_tpu.cli import main as j_main
from cone_tpu.data import reformat as j_reformat
from cone_tpu.data.native_store import NativePackedStore as JNativePackedStore
from cone_tpu.data.store import LmdbArrayStore as JLmdbArrayStore
from cone_tpu_torch.cli import main as t_main
from cone_tpu_torch.data import reformat
from cone_tpu_torch.data.native_store import NativePackedStore, load_reader
from cone_tpu_torch.data.store import (
    InMemoryArrayStore, LmdbArrayStore, PackedArrayStore, open_array_store, write_packed_store,
)
from cone_tpu_torch.kernels import build
from cone_tpu_torch.utils.io import load_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _items(dtype, n=23, dim=24, seed=0):
    rng = np.random.default_rng(seed)
    items = {f"vid_{i}": rng.normal(size=(int(rng.integers(1, 80)), dim)).astype(dtype)
             for i in range(n)}
    items["one_row"] = rng.normal(size=(1, dim)).astype(dtype)
    items["ключ_utf8"] = rng.normal(size=(3, dim)).astype(dtype)
    return items


@pytest.fixture(scope="module", params=[np.float32, np.float16], ids=["f32", "f16"])
def store(request, tmp_path_factory):
    items = _items(request.param)
    path = str(tmp_path_factory.mktemp("cfs") / "feat.cfs")
    write_packed_store(path, items)
    return path, items


def _readers(path):
    return {"native": NativePackedStore(path), "python": PackedArrayStore(path),
            "cone_tpu": JNativePackedStore(path)}


# ------------------------------------------------------------ readers

def test_readers_agree_on_every_key(store):
    path, items = store
    readers = _readers(path)
    for name, r in readers.items():
        assert list(r.keys()) == list(items), name
        assert r.dim == 24 and r.dtype == next(iter(items.values())).dtype, name
        for k, v in items.items():
            got = r.get(k)
            assert got.dtype == v.dtype and got.shape == v.shape, (name, k)
            np.testing.assert_array_equal(got, v, err_msg=f"{name} {k}")
        assert "vid_0" in r and "missing" not in r


@pytest.mark.parametrize("max_rows", [0, 1, 50, 200])
def test_read_batch_padding_and_lengths_agree(store, max_rows):
    path, items = store
    keys = ["vid_3", "vid_7", "missing", "vid_0", "one_row", "ключ_utf8", "vid_3"]
    outs = {name: r.read_batch(keys, max_rows) for name, r in _readers(path).items()}
    want_len = np.array([0 if k == "missing" else min(len(items[k]), max_rows) for k in keys])
    for name, (out, lengths) in outs.items():
        assert out.shape == (len(keys), max_rows, 24) and out.dtype == items["vid_0"].dtype
        assert lengths.dtype == np.int64
        np.testing.assert_array_equal(lengths, want_len, err_msg=name)
        for i, k in enumerate(keys):
            n = want_len[i]
            if n:
                np.testing.assert_array_equal(out[i, :n], items[k][:n])
            assert not out[i, n:].any(), (name, k)
    np.testing.assert_array_equal(outs["native"][0], outs["cone_tpu"][0])


def test_missing_key_raises_key_error(store):
    path, _ = store
    for name, r in _readers(path).items():
        with pytest.raises(KeyError):
            r.get("missing")
    with pytest.raises(ValueError, match="NUL"):
        NativePackedStore(path).read_batch(["a\0b"], 4)


def test_prefetch_churns_while_reads_stay_exact(store):
    path, items = store
    for r in (NativePackedStore(path, prefetch_threads=3), JNativePackedStore(path, 3)):
        r.prefetch(list(items) + ["missing"])
        for k, v in items.items():
            np.testing.assert_array_equal(r.get(k), v)
        r.prefetch([])
    NativePackedStore(path, prefetch_threads=0).prefetch(list(items))   # no workers: a no-op


def test_native_reader_refuses_a_truncated_or_foreign_file(store, tmp_path):
    path, _ = store
    data = open(path, "rb").read()
    for name, blob in [("truncated", data[: len(data) // 2]), ("header", data[:20]),
                       ("foreign", b"NOPE" + data[4:]), ("empty", b"")]:
        bad = tmp_path / f"{name}.cfs"
        bad.write_bytes(blob)
        with pytest.raises(OSError, match="refused"):
            NativePackedStore(str(bad))
    with pytest.raises(OSError, match="refused"):
        NativePackedStore(str(tmp_path / "absent.cfs"))


def test_open_array_store_maps_each_source(store, tmp_path, monkeypatch):
    path, items = store
    assert isinstance(open_array_store(dict(items)), InMemoryArrayStore)
    assert isinstance(open_array_store(path), NativePackedStore)
    assert isinstance(open_array_store(path, reader="python"), PackedArrayStore)
    with pytest.raises(ValueError, match="reader"):
        open_array_store(path, reader="mmap")
    monkeypatch.setitem(sys.modules, "lmdb", _fake_lmdb({}))
    assert isinstance(open_array_store(str(tmp_path)), LmdbArrayStore)


def test_open_array_store_starts_no_prefetch_threads(store):
    """The dataset only calls get: open_array_store's native store holds no
    prefetch workers, while a caller that asks for them gets them."""
    path, _ = store
    load_reader()

    def n_threads():
        return len(os.listdir("/proc/self/task"))

    before = n_threads()
    idle = open_array_store(path)
    assert n_threads() == before
    busy = NativePackedStore(path, prefetch_threads=3)
    assert n_threads() == before + 3
    busy.close()
    idle.close()
    assert n_threads() == before


def test_second_open_reuses_the_built_library(store, monkeypatch):
    """The library is built once per process (load_library is cached) and
    once per source on disk (a second process finds the file)."""
    path, _ = store
    NativePackedStore(path)
    lib_path = build.host_library_path("feature_store")
    assert lib_path.exists()
    mtime = lib_path.stat().st_mtime_ns
    calls = []
    monkeypatch.setattr(build, "build_host", lambda name: calls.append(name))
    assert load_reader() is load_reader()
    NativePackedStore(path).get("vid_0")
    assert calls == [] and build.load_library.cache_info().hits >= 2
    monkeypatch.undo()
    build.load_library.cache_clear()
    assert build.build_host("feature_store") == lib_path
    assert lib_path.stat().st_mtime_ns == mtime   # found, not rebuilt


def test_importing_the_readers_builds_nothing(tmp_path):
    code = ("import cone_tpu_torch.data.native_store, cone_tpu_torch.data.store\n"
            "from cone_tpu_torch.kernels import build\n"
            "assert build.load_library.cache_info().currsize == 0\n"
            "assert 'feature_store' not in build.kernel_names()\n"
            "assert not any(p.name.startswith('feature_store') for p in\n"
            "    build.CSRC_DIR.glob('*.cu*'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_host_library_hash_covers_source_and_flags(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "x.cpp").write_text("int f() { return 1; }\n")
    a = build.host_library_path("x")
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ("-g",))
    b = build.host_library_path("x")
    (tmp_path / "x.cpp").write_text("int f() { return 2; }\n")
    c = build.host_library_path("x")
    assert len({a, b, c}) == 3
    assert "-march=native" not in build.CXX_FLAGS


def test_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path / "src")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "broken.cpp").write_text("int f() { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        build.build_host("broken")
    assert not list((tmp_path / "out").glob("*.so"))   # nothing half-written is left


# --------------------------------------------------------------- LMDB

def _npz(arr, key="features"):
    buf = io.BytesIO()
    np.savez(buf, **{key: arr})
    return buf.getvalue()


def _fake_lmdb(db: dict):
    """A stand-in for the `lmdb` module over a dict {bytes key: bytes}: the
    calls both packages make (open, begin, get, cursor)."""

    class Txn:
        def get(self, key):
            return db.get(bytes(key))

        def cursor(self):
            return iter(sorted(db.items()))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Env:
        def begin(self, buffers=False):
            return Txn()

    mod = types.ModuleType("lmdb")
    mod.open = lambda path, readonly, create, readahead: Env()
    return mod


@pytest.fixture
def lmdb_db():
    rng = np.random.default_rng(3)
    arrays = {f"clip_{i}": rng.normal(size=(int(rng.integers(2, 40)), 16)).astype(
        np.float64 if i % 2 else np.float16) for i in range(6)}
    return arrays, {k.encode(): _npz(v) for k, v in arrays.items()}


def test_lmdb_reader_equals_cone_tpu(lmdb_db, monkeypatch, tmp_path):
    arrays, db = lmdb_db
    monkeypatch.setitem(sys.modules, "lmdb", _fake_lmdb(db))
    got, want = LmdbArrayStore(str(tmp_path)), JLmdbArrayStore(str(tmp_path))
    assert got.keys() == want.keys() == sorted(arrays)
    for k, v in arrays.items():
        a, b = got.get(k), want.get(k)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, v.astype(np.float32))
        assert k in got
    assert "missing" not in got
    for r in (got, want):
        with pytest.raises(KeyError):
            r.get("missing")


def test_lmdb_reader_without_lmdb_names_convert_store(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "lmdb", None)   # import lmdb raises ImportError
    with pytest.raises(ImportError, match="convert-store --format lmdb"):
        LmdbArrayStore(str(tmp_path))
    with pytest.raises(ImportError, match="cone_tpu_torch convert-store"):
        open_array_store(str(tmp_path))


# ------------------------------------------------------- convert-store

@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """One feature set as an h5 file, an npy directory (with a 1-D CLS
    vector and a float64 array) and a pt directory."""
    root = tmp_path_factory.mktemp("convert")
    rng = np.random.default_rng(1)
    (root / "npy").mkdir()
    (root / "pt").mkdir()
    with h5py.File(root / "f.h5", "w") as f:
        for i in range(5):
            f[f"vid_{i}"] = rng.normal(size=(int(rng.integers(2, 60)), 32))
    for i in range(5):
        arr = rng.normal(size=(int(rng.integers(2, 60)), 32)).astype(np.float32)
        np.save(root / "npy" / f"vid_{i}.npy", arr.astype(np.float64 if i == 2 else np.float32))
        torch.save(torch.from_numpy(arr).half() if i == 3 else torch.from_numpy(arr),
                   root / "pt" / f"vid_{i}.pt")
    np.save(root / "npy" / "q_cls.npy", rng.normal(size=32).astype(np.float32))
    (root / "npy" / "notes.txt").write_text("not a feature file")
    return root


@pytest.mark.parametrize("fmt,src", [("h5", "f.h5"), ("npy_dir", "npy"), ("pt_dir", "pt")])
def test_convert_store_writes_cone_tpus_bytes(sources, fmt, src, capsys):
    out_t, out_j = sources / f"t_{fmt}.cfs", sources / f"j_{fmt}.cfs"
    t_main(["convert-store", "--input", str(sources / src), "--output", str(out_t),
            "--format", fmt])
    j_main(["convert-store", "--input", str(sources / src), "--output", str(out_j),
            "--format", fmt])
    out = capsys.readouterr().out
    assert out_t.read_bytes() == out_j.read_bytes()
    n = {"h5": 5, "npy_dir": 6, "pt_dir": 5}[fmt]
    assert f"wrote {n} entries to {out_t}" in out
    store = NativePackedStore(str(out_t))
    assert store.dtype == np.float32 and len(store.keys()) == n
    if fmt == "npy_dir":
        assert store.get("q_cls").shape == (1, 32)   # a 1-D vector: one (1, D) row


def test_convert_store_from_lmdb_writes_cone_tpus_bytes(lmdb_db, monkeypatch, tmp_path):
    arrays, db = lmdb_db
    monkeypatch.setitem(sys.modules, "lmdb", _fake_lmdb(db))
    for main, out in ((t_main, "t.cfs"), (j_main, "j.cfs")):
        main(["convert-store", "--input", str(tmp_path), "--output", str(tmp_path / out),
              "--format", "lmdb"])
    assert (tmp_path / "t.cfs").read_bytes() == (tmp_path / "j.cfs").read_bytes()
    store = PackedArrayStore(str(tmp_path / "t.cfs"))
    np.testing.assert_array_equal(store.get("clip_1"), arrays["clip_1"].astype(np.float32))


def test_convert_store_refuses_an_empty_source(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="empty store"):
        t_main(["convert-store", "--input", str(tmp_path / "empty"), "--output",
                str(tmp_path / "x.cfs"), "--format", "npy_dir"])


# ------------------------------------------------------------ reformat

def _ego4d_challenge(seed=0):
    """A nested Ego4D-NLQ json with the cases the filters look at: empty
    queries, zero-length spans, starts past the clip's end, spans covering
    the whole clip, and fractional clip bounds."""
    rng = np.random.default_rng(seed)
    videos = []
    for v in range(3):
        clips = []
        for c in range(2):
            start = round(float(rng.uniform(0, 100)), 2)
            dur = float(rng.choice([480.0, 300.5, 479.9]))
            anns = []
            for a in range(2):
                queries = []
                for q in range(4):
                    kind = rng.integers(6)
                    s = round(float(rng.uniform(0, dur)), 2)
                    e = min(dur, s + round(float(rng.uniform(1, 60)), 2))
                    if kind == 0:
                        s, e = 5.0, dur - 10.0          # no negative window
                    elif kind == 1:
                        e = s                           # zero length
                    elif kind == 2:
                        s, e = dur + 1.0, dur + 5.0     # starts past the end
                    queries.append({"query": "" if kind == 3 and q == 0 else f"q {v}{c}{a}{q}",
                                    "clip_start_sec": s, "clip_end_sec": e})
                anns.append({"annotation_uid": f"ann{v}{c}{a}", "language_queries": queries})
            clips.append({"clip_uid": f"clip{v}{c}", "video_start_sec": start,
                          "video_end_sec": start + dur, "annotations": anns})
        videos.append({"video_uid": f"video{v}", "clips": clips})
    return {"version": "1.0", "videos": videos}


def _mad_split(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(20):
        dur = float(rng.uniform(3000, 8000))
        s = float(rng.uniform(-20, dur + 20))
        e = s if i % 5 == 0 else s + float(rng.uniform(1, 30))
        out[f"mad_{i}"] = {"sentence": f"sentence {i}", "movie_duration": dur,
                           "movie": f"movie{i % 4}", "timestamps": [s, e]}
    return out


def test_reformatters_give_cone_tpus_rows():
    raw = _ego4d_challenge()
    for test_split in (False, True):
        rows = reformat.reformat_ego4d(raw, test_split=test_split)
        assert rows == j_reformat.reformat_ego4d(raw, test_split=test_split)
    rows = reformat.reformat_ego4d(raw)
    kept = reformat.filter_train_ego4d(rows)
    assert kept == j_reformat.filter_train_ego4d(rows) and 0 < len(kept) < len(rows)
    mad = reformat.reformat_mad(_mad_split())
    assert mad == j_reformat.reformat_mad(_mad_split())
    kept = reformat.filter_train_mad(mad)
    assert kept == j_reformat.filter_train_mad(mad) and 0 < len(kept) < len(mad)
    assert reformat.ego4d_flat_to_nested(rows) == j_reformat.ego4d_flat_to_nested(rows)
    assert [reformat.normalize_sec(x) for x in (0.49, 0.5, 10.4, 490.6)] == [0, 1, 10, 491]


@pytest.mark.parametrize("dset,flags", [
    ("ego4d", []), ("ego4d", ["--filter_train"]), ("ego4d", ["--test_split"]),
    ("mad", []), ("mad", ["--filter_train"]),
])
def test_reformat_cli_writes_cone_tpus_file(tmp_path, capsys, dset, flags):
    src = tmp_path / "in.json"
    src.write_text(json.dumps(_ego4d_challenge() if dset == "ego4d" else _mad_split()))
    for main, out in ((t_main, "t.jsonl"), (j_main, "j.jsonl")):
        main(["reformat", "--dset", dset, "--input", str(src), "--output",
              str(tmp_path / out)] + flags)
    t_out, j_out = capsys.readouterr().out.splitlines()
    assert t_out.replace("t.jsonl", "j.jsonl") == j_out
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    rows = load_jsonl(str(tmp_path / "t.jsonl"))
    assert rows and all(("timestamps" in r) != ("--test_split" in flags) for r in rows)
