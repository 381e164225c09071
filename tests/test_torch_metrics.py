"""The port's metrics, submission writers and ensemble
(cone_tpu_torch/eval/{metrics,submission,ensemble}.py, utils/io.ascii_table)
against cone_tpu's on the same seeded inputs (equal outputs), and against
the reference-generated fixture tests/golden/eval_ensemble_golden.json."""

import json
import os

import numpy as np
import pytest

from cone_tpu.eval import ensemble as j_ens
from cone_tpu.eval import metrics as j_met
from cone_tpu.eval import submission as j_sub
from cone_tpu.utils import io as j_io
from cone_tpu_torch.eval import ensemble as t_ens
from cone_tpu_torch.eval import metrics as t_met
from cone_tpu_torch.eval import submission as t_sub
from cone_tpu_torch.utils import io as t_io

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "eval_ensemble_golden.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _submission(seed, n=12, rows=7, dur=300.0):
    """(submission rows [st, ed, prop, match, fused], flat GT) from a seed."""
    rng = np.random.default_rng(seed)
    sub, gt = [], []
    for i in range(n):
        st = rng.uniform(0, dur - 30, rows)
        ed = st + rng.uniform(0.5, 30, rows)
        sc = np.sort(rng.uniform(0, 2, (rows, 3)), axis=0)[::-1]
        qid = f"anno{i // 3}_{i % 3}"
        sub.append(dict(query_id=qid, query=f"q {i}", video_id=f"v{i // 4}",
                        clip_id=f"c{i // 4}",
                        predicted_times=np.round(np.c_[st, ed, sc], 4).tolist()))
        g0 = float(rng.uniform(0, dur - 20))
        # every third GT sits on a predicted span so that some recalls are non-zero
        span = [float(st[i % rows]), float(ed[i % rows])] if i % 3 == 0 else [g0, g0 + 15.0]
        gt.append(dict(query_id=qid, timestamps=span))
    return sub, gt


def test_hull_iou_equal():
    rng = np.random.default_rng(0)
    pred = np.sort(rng.uniform(0, 50, (9, 2)), axis=1)
    gt = np.sort(rng.uniform(0, 50, (4, 2)), axis=1)
    pred[0] = gt[0]
    pred[1] = [3.0, 3.0]  # empty span
    np.testing.assert_array_equal(t_met.hull_iou(pred, gt), j_met.hull_iou(pred, gt))


@pytest.mark.parametrize("match_number", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_recall_table_and_miou_equal(seed, match_number):
    sub, gt = _submission(seed)
    if not match_number:
        sub, gt = sub[:-2], gt[1:]
    thresholds, topk = [0.1, 0.3, 0.5], [1, 5, 10]
    got = t_met.evaluate_recall_table(sub, gt, thresholds, topk, match_number=match_number)
    want = j_met.evaluate_recall_table(sub, gt, thresholds, topk, match_number=match_number)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0
    assert t_met.mean_first_iou(sub, gt) == j_met.mean_first_iou(sub, gt)
    assert (t_met.display_recall_table(got, thresholds, topk, title="T", mIoU=0.1234)
            == j_met.display_recall_table(want, thresholds, topk, title="T", mIoU=0.1234))
    assert (t_met.display_recall_table(got, thresholds, topk)
            == j_met.display_recall_table(want, thresholds, topk))


def test_recall_table_refuses_mismatched_query_sets():
    sub, gt = _submission(0)
    with pytest.raises(AssertionError):
        t_met.evaluate_recall_table(sub[:-1], gt, [0.3], [1])


@pytest.mark.parametrize("match_number", [True, False])
def test_window_ranklist_recall_equal(match_number):
    rng = np.random.default_rng(2)
    _, gt = _submission(2)
    ranklists = {g["query_id"]: rng.permutation(16).tolist() for g in gt}
    if not match_number:
        ranklists.pop(gt[0]["query_id"])
    topk = [1, 5, 10, 30]
    got = t_met.evaluate_window_ranklists(ranklists, gt, topk, 0.535, 90,
                                          match_number=match_number)
    want = j_met.evaluate_window_ranklists(ranklists, gt, topk, 0.535, 90,
                                           match_number=match_number)
    np.testing.assert_array_equal(got, want)
    assert got[-1] > 0
    assert (t_met.display_window_results(got, topk, title="Window Pre-filtering")
            == j_met.display_window_results(want, topk, title="Window Pre-filtering"))


def test_ego4d_evaluator_equal_and_golden(golden):
    g = golden["ego4d"]
    args = (g["predictions"], g["ground_truth"], g["thresholds"], g["topK"])
    results, miou = t_met.evaluate_ego4d_nlq(*args)
    j_results, j_miou = j_met.evaluate_ego4d_nlq(*args)
    np.testing.assert_array_equal(results, j_results)
    assert miou == j_miou
    np.testing.assert_allclose(results, np.asarray(g["results"]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(miou, g["mIoU"], rtol=0, atol=1e-12)
    assert (t_met.display_ego4d_results(results, miou, g["thresholds"], g["topK"], title="E")
            == j_met.display_ego4d_results(j_results, j_miou, g["thresholds"], g["topK"],
                                           title="E"))


def test_mad_evaluator_golden(golden):
    g = golden["mad"]
    recall = t_met.evaluate_recall_table(g["submission"], g["ground_truth"],
                                         g["thresholds"], g["topK"])
    # the reference accumulates in float32 torch; this evaluator in float64 numpy
    np.testing.assert_allclose(recall, np.asarray(g["recall"]), rtol=0, atol=1e-6)


def test_ensemble_golden_and_equal(golden):
    g = golden["ensemble"]
    kw = dict(max_input=g["max_input"], top1_max_input=g["top1_max_input"])
    out = t_ens.ensemble_predictions(g["submissions"], **kw)
    assert len(out) == len(g["fused"])
    for got, exp in zip(out, g["fused"]):
        np.testing.assert_allclose(got["predicted_times"], exp["predicted_times"],
                                   rtol=0, atol=1e-9)
    assert out == j_ens.ensemble_predictions(g["submissions"], **kw)


@pytest.mark.parametrize("max_input,top1", [(4, 1), (2, 2)])
def test_ensemble_equal_on_seeded_submissions(max_input, top1):
    subs = [_submission(s)[0] for s in (3, 4, 5)]
    got = t_ens.ensemble_predictions(subs, max_input=max_input, top1_max_input=top1)
    want = j_ens.ensemble_predictions(subs, max_input=max_input, top1_max_input=top1)
    assert got == want and all(len(r["predicted_times"]) == 5 for r in got)
    rows = subs[0][0]["predicted_times"] + subs[1][0]["predicted_times"]
    assert t_ens.top1_generator(rows) == j_ens.top1_generator(rows)


@pytest.mark.parametrize("dset", ["ego4d", "mad"])
def test_submission_writers_equal(tmp_path, dset):
    sub, _ = _submission(6)
    assert t_sub.to_ego4d_challenge(sub) == j_sub.to_ego4d_challenge(sub)
    ext = "json" if dset == "ego4d" else "jsonl"
    t_path, j_path = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    t_sub.write_submission(sub, str(t_path), dset)
    j_sub.write_submission(sub, str(j_path), dset)
    assert t_path.read_bytes() == j_path.read_bytes() and t_path.stat().st_size > 0


def test_io_helpers_equal(tmp_path):
    rows = [["Rank@1\nmIoU@0.3", "Rank@5\nmIoU@0.3", "mIoU"], ["12.50", "3.00"]]
    for title in (None, "Fusion"):
        assert t_io.ascii_table(rows, title) == j_io.ascii_table(rows, title)
    vals = [0.3, 1.5, -2.0, 1.5]
    assert t_io.min_max_normalize(vals) == j_io.min_max_normalize(vals)
    assert t_io.min_max_normalize([2.0, 2.0]) == [2.0, 2.0]
    data = [{"a": 1, "b": [1.5, 2]}, {"a": 2, "b": []}]
    t_io.save_jsonl(data, str(tmp_path / "t.jsonl"))
    j_io.save_jsonl(data, str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert t_io.load_jsonl(str(tmp_path / "j.jsonl")) == data
