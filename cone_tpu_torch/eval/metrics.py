"""Official metric implementations (numpy), semantics-identical to the
challenge evaluators the reference vendors:

  * Ego4D-NLQ recall@K x IoU + mIoU (standalone_eval/evaluate_ego4d_nlq.py)
  * MAD recall@K x IoU table (standalone_eval/evaluate_mad.py)
  * coarse window-ranklist recall (standalone_eval/evaluate_pre_filtered_window.py)

All three use the challenge convention IoU = inter / hull (union taken as
max(ed) - min(st)), and the strict `overlap > threshold` comparison.
"""

from __future__ import annotations

import math

import numpy as np

from cone_tpu_torch.utils.io import ascii_table


def hull_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N, 2) x (M, 2) -> (N, M) IoU with hull union."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    inter = np.maximum(
        0.0,
        np.minimum(pred[:, 1, None], gt[None, :, 1])
        - np.maximum(pred[:, 0, None], gt[None, :, 0]),
    )
    union = np.maximum(
        0.0,
        np.maximum(pred[:, 1, None], gt[None, :, 1])
        - np.minimum(pred[:, 0, None], gt[None, :, 0]),
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union > 0, inter / union, 0.0)
    return out


# ---------------------------------------------------------------- Ego4D ----

def evaluate_ego4d_nlq(predictions, ground_truth, thresholds, topK):
    """Args mirror the challenge evaluator: predictions are dicts with
    clip_uid / annotation_uid / query_idx / predicted_times; ground_truth is
    the nested challenge json. Returns (results[t][k], mIoU)."""
    gt_dict = {}
    for video in ground_truth["videos"]:
        for clip in video["clips"]:
            for ann in clip["annotations"]:
                gt_dict[(clip["clip_uid"], ann["annotation_uid"])] = ann

    results = np.zeros((len(thresholds), len(topK), len(predictions)), bool)
    average_iou = []
    for n, pred in enumerate(predictions):
        ann = gt_dict[(pred["clip_uid"], pred["annotation_uid"])]
        q = ann["language_queries"][pred["query_idx"]]
        gt_span = np.array([[q["clip_start_sec"], q["clip_end_sec"]]])
        times = np.asarray(pred["predicted_times"], np.float64)[:, :2]
        overlap = hull_iou(times, gt_span)[:, 0]
        average_iou.append(overlap[0] if len(overlap) else 0.0)
        for t, thd in enumerate(thresholds):
            hit = overlap > thd
            for k, kk in enumerate(topK):
                results[t, k, n] = hit[:kk].any()
    return results.mean(-1), float(np.mean(average_iou))


def display_ego4d_results(results, mIoU, thresholds, topK, title=None):
    header = [f"Rank@{k}\nmIoU@{t}" for k in topK for t in thresholds] + ["mIoU"]
    row = [
        f"{100 * results[t][k]:.02f}"
        for k in range(len(topK))
        for t in range(len(thresholds))
    ] + [f"{100 * mIoU:.02f}"]
    return ascii_table([header, row], title)


# ------------------------------------------------------------------ MAD ----

def evaluate_recall_table(submission, ground_truth, thresholds, topK,
                          match_number=True):
    """Flat-jsonl evaluator (MAD-style): submission rows have query_id +
    predicted_times, GT rows have query_id + timestamps. Returns
    recall[k][t]."""
    pred_qids = {e["query_id"] for e in submission}
    gt_qids = {e["query_id"] for e in ground_truth}
    if match_number:
        assert pred_qids == gt_qids, "qids in GT and submission must match"
    else:
        shared = pred_qids & gt_qids
        submission = [e for e in submission if e["query_id"] in shared]
        ground_truth = [e for e in ground_truth if e["query_id"] in shared]

    truth = {d["query_id"]: d["timestamps"] for d in ground_truth}
    # float32 end to end: the reference MAD evaluator builds default torch
    # tensors (evaluate_mad.py:33-58), so strict `>` verdicts at threshold
    # boundaries are float32 decisions (the ego4d evaluator below is numpy
    # float64, matching ITS reference)
    thresholds = np.asarray(thresholds, np.float32)
    topK = np.asarray(topK)
    recall = np.zeros((len(topK), len(thresholds)))
    max_k = topK.max()
    for row in submission:
        gt = np.asarray(truth[row["query_id"]], np.float32)[None, :2]
        times = np.asarray(row["predicted_times"], np.float32)[:max_k, :2]
        ious = hull_iou(times, gt)[:, 0]
        hits = ious[:, None] > thresholds[None, :]  # (P, T)
        for i, r in enumerate(topK):
            recall[i] += hits[:r].any(0)
    return recall / max(len(submission), 1)


def mean_first_iou(submission, ground_truth) -> float:
    """mIoU of each query's FIRST prediction vs its GT span — the ego4d
    evaluator's mIoU (standalone_eval/evaluate_ego4d_nlq.py:95-106 appends
    overlap[0] per query), computed on flat-jsonl rows."""
    truth = {d["query_id"]: d["timestamps"] for d in ground_truth}
    vals = []
    for row in submission:
        if row["query_id"] not in truth:
            continue
        gt = np.asarray(truth[row["query_id"]], np.float64)[None, :2]
        times = np.asarray(row["predicted_times"], np.float64)[:1, :2]
        iou = hull_iou(times, gt)[:, 0]
        vals.append(float(iou[0]) if len(iou) else 0.0)
    return float(np.mean(vals)) if vals else 0.0


def display_recall_table(results, thresholds, topK, title=None, mIoU=None):
    """Recall table; with `mIoU` set, appends the reference's trailing mIoU
    column (evaluate_ego4d_nlq.py display_results:21-38)."""
    header = [f"Rank@{k}\nmIoU@{t:.1f}" for k in topK for t in thresholds]
    row = [
        f"{100 * results[k][t]:.02f}"
        for k in range(len(topK))
        for t in range(len(thresholds))
    ]
    if mIoU is not None:
        header = header + ["mIoU"]
        row = row + [f"{100 * mIoU:.02f}"]
    return ascii_table([header, row], title)


# -------------------------------------------------------- window recall ----

def evaluate_window_ranklists(query_id2windowidx, ground_truth, topK,
                              clip_length, max_v_l, match_number=True):
    """Coarse-stage recall: does the top-r window ranklist contain any
    GT-overlapping window id (ids recomputed from timestamps with the same
    stride math as training)."""
    pred_qids = set(query_id2windowidx)
    gt_qids = {e["query_id"] for e in ground_truth}
    if match_number:
        assert pred_qids == gt_qids
    else:
        shared = pred_qids & gt_qids
        query_id2windowidx = {k: v for k, v in query_id2windowidx.items() if k in shared}
        ground_truth = [e for e in ground_truth if e["query_id"] in shared]

    stride = int(max_v_l / 2)
    truth = {}
    for meta in ground_truth:
        start = meta["timestamps"][0] / clip_length
        end = meta["timestamps"][1] / clip_length
        truth[meta["query_id"]] = set(
            range(math.floor(start / stride), math.ceil(end / stride) + 1)
        )

    topK = np.asarray(topK)
    recall = np.zeros(len(topK))
    max_k = topK.max()
    for qid, ranklist in query_id2windowidx.items():
        good = truth[qid]
        hits = np.array([w in good for w in ranklist[:max_k]])
        for i, r in enumerate(topK):
            recall[i] += hits[:r].any()
    return recall / max(len(query_id2windowidx), 1)


def display_window_results(results, topK, title=None):
    header = [f"Rank@{k}" for k in topK]
    row = [f"{100 * results[i]:.02f}" for i in range(len(topK))]
    return ascii_table([header, row], title)
