"""`InferencePipeline._assemble` (cone_tpu_torch/eval/pipeline.py): the
fetched arrays of a fused pass -> per-query ranklists and moments, held
equal (`==`, types included) to the plain per-element loop kept below as
the reference, on hand-built arrays that go through `_fetch` as a pass's
outputs do, and on the arrays of real `run_fused` passes. The file imports
neither jax nor cone_tpu.
"""

import numpy as np
import pytest
import torch

from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig
from cone_tpu_torch.data import QueryExample, make_synthetic_dataset
from cone_tpu_torch.eval.pipeline import MODALITIES, InferencePipeline, _fetch
from cone_tpu_torch.models.cone import ConeModel

K = 5  # eval.max_after_nms


def reference_assemble(groups, results):
    """One Python conversion per window id and per moment number."""
    ranklists = {}
    out = {name: [] for name in MODALITIES}
    for group, (order, _, k_sp, k_sc, k_va) in zip(groups, results):
        for v, (chunk, n_win, _) in enumerate(group):
            for j, ex in enumerate(chunk):
                ranklists[ex.query_id] = [int(w) for w in order[v, j] if w < n_win]
                for m, name in enumerate(MODALITIES):
                    n = int(k_va[m, v, j].sum())
                    times = [[float(k_sp[m, v, j, i, 0]), float(k_sp[m, v, j, i, 1]),
                              float(k_sc[m, v, j, i])] for i in range(n)]
                    out[name].append(dict(
                        query_id=ex.query_id, query=ex.query, video_id=ex.video_id,
                        clip_id=ex.clip_id, predicted_times=times))
    return out, ranklists


def assemble(groups, results):
    return InferencePipeline._assemble(object.__new__(InferencePipeline), groups, results)


def assert_same(got, want):
    assert got == want
    (out, ranklists), (want_out, want_ranklists) = got, want
    assert list(ranklists) == list(want_ranklists)
    for name in MODALITIES:
        assert [r["query_id"] for r in out[name]] == [r["query_id"] for r in want_out[name]]
        for r in out[name]:
            for t in r["predicted_times"]:
                assert type(t) is list and len(t) == 3
                assert all(type(x) is float for x in t)
    assert all(type(w) is int for rank in ranklists.values() for w in rank)


def dispatch(rng, items, vb, qc, n_w):
    """A group of `items` (n_win, n_queries, kept counts (3, n_queries))
    padded to `vb` items of `qc` query rows -> (group, device outputs).
    Window ids >= n_win fall anywhere in a row; kept slots lead each row,
    and every slot past them holds a stale value."""
    group = []
    k_va = torch.zeros(3, vb, qc, K, dtype=torch.bool)
    for v, (n_win, nq, kept) in enumerate(items):
        chunk = [QueryExample(f"v{n_w}_{v}_q{j}", f"query {j}", f"vid{v}", f"clip{v}",
                              [0, 0], 0.0) for j in range(nq)]
        group.append((chunk, n_win, f"clip{v}"))
        for m in range(3):
            for j in range(nq):
                k_va[m, v, j, : kept[m][j]] = True
    order = torch.from_numpy(np.stack([rng.permutation(n_w) for _ in range(vb * qc)])
                             ).reshape(vb, qc, n_w)
    win_valid = torch.ones(vb, qc, 4, dtype=torch.bool)
    k_sp = torch.from_numpy(rng.normal(scale=900.0, size=(3, vb, qc, K, 2)).astype(np.float32))
    k_sc = torch.from_numpy(rng.normal(size=(3, vb, qc, K)).astype(np.float32))
    return group, (order, win_valid, k_sp, k_sc, k_va)


def hand_built():
    rng = np.random.default_rng(7)
    full = [[K] * 4, [3, 0, 5, 1], [0, 0, 0, 0]]
    return [
        # two items, full chunks, ids >= n_win mid-row (n_win < n_w)
        dispatch(rng, [(9, 4, full), (12, 4, [[1, 2, 3, 4]] * 3)], vb=2, qc=4, n_w=14),
        # one real item of two (a padded item) and a chunk of 2 of 4 rows
        dispatch(rng, [(20, 2, [[0, 4], [K, 2], [1, 0]])], vb=2, qc=4, n_w=20),
        # another bucket: a different n_w, n_win < n_w, a chunk of 1 row
        dispatch(rng, [(31, 3, [[2, 2, 0], [K, 1, 3], [0, 5, 4]]), (40, 1, [[1], [0], [K]])],
                 vb=2, qc=4, n_w=45),
    ]


def test_assemble_equals_the_per_element_loop_on_hand_built_arrays():
    built = hand_built()
    groups = [g for g, _ in built]
    results = _fetch([res for _, res in built])
    got, want = assemble(groups, results), reference_assemble(groups, results)
    assert_same(got, want)
    _, ranklists = got
    # the cases hold: ids past n_win mid-row, 0 and fewer than K kept moments
    assert any(any(w >= 9 for w in results[0][0][0, j, :-5]) for j in range(4))
    assert len(ranklists["v14_0_q0"]) == 9 and len(ranklists["v45_1_q0"]) == 40
    counts = {len(r["predicted_times"]) for name in MODALITIES for r in got[0][name]}
    assert counts == {0, 1, 2, 3, 4, K}
    assert len(ranklists) == 4 + 4 + 2 + 3 + 1


def _cfg(**eval_kw):
    dim = 16
    return ConeConfig(
        model=ModelConfig(hidden_dim=16, nheads=2, enc_layers=1, dec_layers=1,
                          dim_feedforward=32, t_feat_dim=dim, v_motion_feat_dim=dim,
                          v_appear_feat_dim=dim, max_q_l=8, max_v_l=16),
        data=DataConfig(max_v_l=16, max_q_l=8, clip_length=1.0, topk_window=4,
                        max_ctx_l=160, max_windows=5),
        eval=EvalConfig(nms_thd=0.5, max_after_nms=K, **eval_kw))


@pytest.mark.parametrize("eval_kw", [
    dict(query_chunk=4, video_batch=1),
    dict(query_chunk=4, video_batch=2, ctx_buckets=(96, 160)),
    dict(query_chunk=3, video_batch=3, ctx_buckets=(96, 160)),
], ids=["vb1", "vb2-buckets", "vb3-buckets"])
def test_run_fused_assembles_as_the_per_element_loop(monkeypatch, eval_kw):
    """Whole passes over ragged videos in two buckets, padded chunks and
    padded group items: `run_fused` returns what the reference loop makes
    of the same fetched arrays."""
    torch.manual_seed(0)
    cfg = _cfg(**eval_kw)
    ds = make_synthetic_dataset(cfg.data, n_videos=5, queries_per_video=5,
                                ctx_l_range=(40, 150), dim=16, seed=3)
    pipe = InferencePipeline(ConeModel(cfg.model, device="cpu"), ds, cfg, device="cpu")
    seen = []
    orig = InferencePipeline._assemble

    def spy(self, groups, results):
        seen.append(reference_assemble(groups, results))
        return orig(self, groups, results)

    monkeypatch.setattr(InferencePipeline, "_assemble", spy)
    got = pipe.run_fused()
    assert_same(got, seen[0])
    assert len(got[1]) == 25
    assert {len(r["predicted_times"]) for r in got[0]["fusion"]} - {0}
