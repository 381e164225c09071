"""Multi-model prediction ensembling (ECCV'22 challenge recipe).

Functional equivalent of ECCV_2022_workshop/ensemble.py: concatenate the
top-`max_input` predictions of each model, synthesize an extra top-1 by
clustering proposal centers (distance < 2s), NMS at 0.5, pad to exactly 5.

Input rows are submission dicts whose predicted_times rows end with the
fusion score (as written by the inference pipeline: [st, ed, prop, match,
fused]).
"""

from __future__ import annotations

from collections import defaultdict
from typing import List

from cone_tpu_torch.ops.nms import temporal_nms_host


def _nms_pad5(rows: List[List[float]], score_idx: int) -> List[List[float]]:
    """Sort desc by rows[score_idx], NMS 0.5, keep/pad to exactly 5
    (ensemble.py:7-27)."""
    moments = sorted(
        ([r[0], r[1], r[score_idx]] for r in rows), key=lambda x: x[2], reverse=True
    )
    kept = temporal_nms_host(moments, nms_thd=0.5, max_after_nms=5)
    while len(kept) < 5:
        kept.append(kept[-1])
    return [[m[0], m[1]] for m in kept[:5]]


def top1_generator(rows: List[List[float]]) -> List[List[float]]:
    """Cluster proposal centers within distance 2; per cluster emit a new
    proposal averaging the middle member and the max-score member, scored by
    the cluster's score sum (ensemble.py:30-101)."""
    center_dict = {}
    for item in rows:
        center = (item[0] + item[1]) / 2
        center_dict[center] = [item[0], item[1], item[-1]]
    centers = sorted(center_dict)

    clusters = defaultdict(list)
    idx, cluster = 0, 0
    clusters[cluster].append(centers[0])
    idx = 1
    while idx < len(centers):
        cur, prev = centers[idx], centers[idx - 1]
        while cur - prev < 2:
            clusters[cluster].append(cur)
            prev = cur
            idx += 1
            if idx == len(centers):
                break
            cur = centers[idx]
        if idx == len(centers):
            break
        cluster += 1
        clusters[cluster].append(cur)
        idx += 1

    out = []
    for members in clusters.values():
        scores = [center_dict[c][-1] for c in members]
        total = sum(scores)
        max_prop = center_dict[members[max(range(len(scores)), key=scores.__getitem__)]]
        if len(members) % 2 == 0:
            h = len(members) // 2
            a, b = center_dict[members[h]], center_dict[members[h - 1]]
            middle = a if a[-1] > b[-1] else b
        else:
            middle = center_dict[members[(len(members) - 1) // 2]]
        new = [(m + x) / 2 for m, x in zip(middle, max_prop)]
        new += [0, total]
        out.append(new)
    return sorted(out, key=lambda x: x[-1], reverse=True)


def ensemble_predictions(
    submissions: List[List[dict]],
    max_input: int = 4,
    top1_max_input: int = 1,
    score_idx: int = 4,
) -> List[dict]:
    """Fuse N models' submissions (aligned by position, like the reference's
    zip over three prediction files, ensemble.py:115-141)."""
    assert len(submissions) >= 2
    n = len(submissions[0])
    assert all(len(s) == n for s in submissions)

    out = []
    for items in zip(*submissions):
        top1_in = []
        for item in items:
            top1_in.extend(item["predicted_times"][:top1_max_input])
        synthesized = top1_generator(top1_in)

        fused = dict(items[0])
        rows = []
        for item in items:
            rows.extend(item["predicted_times"][:max_input])
        rows.extend(synthesized)
        fused["predicted_times"] = _nms_pad5(rows, score_idx)
        out.append(fused)
    return out
