"""The port's own copies of cone_tpu's host modules agree with the
originals: config JSON in both directions and the presets, the packed
.cfs store format both ways, the synthetic corpus, the dataset's
normalized features and the prefetch thread."""

import dataclasses
import json

import numpy as np
import pytest

from cone_tpu import config as jconfig
from cone_tpu.data import make_synthetic_dataset as j_make_synthetic
from cone_tpu.data.store import PackedArrayStore as JPackedArrayStore
from cone_tpu.data.store import write_packed_store as j_write_packed_store
from cone_tpu.utils.io import l2_normalize as j_l2_normalize
from cone_tpu.utils.io import min_max_normalize as j_min_max_normalize
from cone_tpu_torch import config
from cone_tpu_torch.data import PackedArrayStore, make_synthetic_dataset, write_packed_store
from cone_tpu_torch.data.prefetch import prefetch_iterator
from cone_tpu_torch.utils.io import l2_normalize, load_jsonl, min_max_normalize, save_jsonl


@pytest.mark.parametrize("preset", ["ConeConfig", "ego4d_config", "mad_config"])
def test_config_json_round_trips_across_packages(preset):
    ours = getattr(config, preset)()
    theirs = getattr(jconfig, preset)()
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())
    assert config.ConeConfig.from_json(theirs.to_json()) == ours
    assert jconfig.ConeConfig.from_json(ours.to_json()) == theirs


def test_config_section_fields_match_cone_tpu():
    for name in ("ModelConfig", "TanConfig", "LossConfig", "DataConfig", "TrainConfig",
                 "EvalConfig"):
        ours = {f.name: f.default for f in dataclasses.fields(getattr(config, name))}
        theirs = {f.name: f.default for f in dataclasses.fields(getattr(jconfig, name))}
        assert ours == theirs, name


def test_config_unknown_keys(tmp_path):
    raw = json.loads(config.ConeConfig().to_json())
    raw["eval"]["no_such_knob"] = 1
    with pytest.warns(UserWarning):
        assert config.ConeConfig.from_json(json.dumps(raw)) == config.ConeConfig()
    with pytest.raises(ValueError):
        config.ConeConfig.from_json(json.dumps(raw), strict=True)
    path = tmp_path / "config.json"
    config.mad_config().save(str(path))
    assert config.ConeConfig.load(str(path)) == config.mad_config()


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_packed_store_format_both_ways(tmp_path, rng, dtype):
    items = {f"v{i}": rng.normal(size=(5 + i, 6)).astype(dtype) for i in range(4)}
    items["cls"] = rng.normal(size=6).astype(dtype)
    ours, theirs = tmp_path / "ours.cfs", tmp_path / "theirs.cfs"
    write_packed_store(str(ours), items)
    j_write_packed_store(str(theirs), items)
    assert ours.read_bytes() == theirs.read_bytes()
    for store in (PackedArrayStore(str(theirs)), JPackedArrayStore(str(ours))):
        assert set(store.keys()) == set(items)
        for k, v in items.items():
            np.testing.assert_array_equal(store.get(k).reshape(v.shape), v)


def test_packed_store_rejects_bad_input(tmp_path):
    with pytest.raises(ValueError):
        write_packed_store(str(tmp_path / "e.cfs"), {})
    with pytest.raises(ValueError):
        write_packed_store(str(tmp_path / "m.cfs"), {"a": np.zeros((2, 3), np.float32),
                                                     "b": np.zeros((2, 4), np.float32)})
    (tmp_path / "x.cfs").write_bytes(b"NOPE" + bytes(40))
    with pytest.raises(ValueError):
        PackedArrayStore(str(tmp_path / "x.cfs"))


def test_synthetic_dataset_matches_cone_tpu():
    kw = dict(n_videos=3, queries_per_video=4, ctx_l_range=(100, 200), dim=16, seed=9)
    ours = make_synthetic_dataset(config.DataConfig(max_v_l=32), **kw)
    theirs = j_make_synthetic(jconfig.DataConfig(max_v_l=32), **kw)
    assert [dataclasses.asdict(e) for e in ours.examples] == \
        [dataclasses.asdict(e) for e in theirs.examples]
    for v in ours.video_ids:
        for a, b in zip(ours.video_features(v), theirs.video_features(v)):
            np.testing.assert_array_equal(a, b)
    for e in ours.examples:
        for a, b in zip(ours.query_features(e.query_id), theirs.query_features(e.query_id)):
            np.testing.assert_array_equal(a, b)


def test_normalize_helpers_and_jsonl(tmp_path, rng):
    x = rng.normal(size=(7, 5)).astype(np.float32)
    np.testing.assert_array_equal(l2_normalize(x), j_l2_normalize(x))
    vals = list(rng.normal(size=9))
    assert min_max_normalize(vals) == j_min_max_normalize(vals)
    assert min_max_normalize([2.0, 2.0]) == [2.0, 2.0]
    rows = [{"query_id": "a", "x": 1}, {"query_id": "b", "x": [1, 2]}]
    save_jsonl(rows, str(tmp_path / "r.jsonl"))
    assert load_jsonl(str(tmp_path / "r.jsonl")) == rows


def test_video_cache_fifo_bound_keeps_pinned():
    cfg = dataclasses.replace(config.DataConfig(max_v_l=32), max_cached_videos=2)
    ds = make_synthetic_dataset(cfg, n_videos=4, queries_per_video=1, dim=8, seed=1)
    ds.pin_video("live", np.zeros((3, 8), np.float32), np.zeros((3, 8), np.float32))
    for v in ds.video_ids:
        ds.video_features(v)
    assert "live" in ds._vid_cache and len(ds._vid_cache) <= 3


def test_prefetch_iterator_order_and_errors():
    assert list(prefetch_iterator(iter(range(50)), depth=2)) == list(range(50))

    def boom():
        yield 1
        raise KeyError("x")

    with pytest.raises(KeyError):
        list(prefetch_iterator(boom()))
    it = prefetch_iterator(iter(range(1000)), depth=1)
    assert next(it) == 0
    it.close()  # abandoning the iterator releases the worker
