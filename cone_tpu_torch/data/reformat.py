"""Dataset reformatters + train-split filters, the port's own copy of the
JAX package's (cone_tpu/data/reformat.py), row for row the same:
  * Ego4D-NLQ nested challenge json -> flat rows (data/reformat_data.py:14-39);
  * MAD dict json -> flat rows (data/reformat_data.py:42-54);
  * train filtering that drops degenerate and no-negative-window samples
    (data/process_train_split.py:11-63);
  * flat Ego4D rows -> the minimal nested GT the official evaluator reads.

The flat schema is the one GroundingDataset consumes:
    {query, query_id, duration, clip_id, video_id, timestamps}
"""

from __future__ import annotations

from typing import List


def normalize_sec(sec: float) -> int:
    """Seconds rounded half up to a whole second."""
    return int(sec + 0.5)


def reformat_ego4d(split_data: dict, test_split: bool = False) -> List[dict]:
    """Nested Ego4D-NLQ json -> flat rows; query_id = '{anno_uid}_{q_idx}'."""
    rows = []
    for video in split_data["videos"]:
        for clip in video["clips"]:
            clip_start = normalize_sec(clip["video_start_sec"])
            clip_end = normalize_sec(clip["video_end_sec"])
            for ann in clip["annotations"]:
                for q_idx, q in enumerate(ann["language_queries"]):
                    if not q.get("query"):
                        continue
                    row = {
                        "query": q["query"],
                        "query_id": f"{ann['annotation_uid']}_{q_idx}",
                        "duration": clip_end - clip_start,
                        "clip_id": clip["clip_uid"],
                        "video_id": video["video_uid"],
                        "clip_video_start_end": [clip_start, clip_end],
                    }
                    if not test_split:
                        row["timestamps"] = [q["clip_start_sec"], q["clip_end_sec"]]
                    rows.append(row)
    return rows


def reformat_mad(split_data: dict) -> List[dict]:
    """MAD dict-of-queries json -> flat rows."""
    return [
        {
            "query": v["sentence"],
            "query_id": k,
            "duration": v["movie_duration"],
            "clip_id": v["movie"],
            "video_id": v["movie"],
            "timestamps": v["timestamps"],
        }
        for k, v in split_data.items()
    ]


def filter_train_mad(rows: List[dict]) -> List[dict]:
    """Drop MAD train rows with a start outside the movie or an empty span."""
    out = []
    for item in rows:
        start, end = item["timestamps"]
        if start < 0 or start >= item["duration"] or start == end:
            continue
        out.append(item)
    return out


# The reference drops ego4d samples whose GT covers nearly the whole clip
# (no negative window possible): start < 120s AND end > duration - 60s,
# plus a float-safety fudge on the right edge (479.895/480).
_EDGE_FUDGE = 479.895 / 480


def filter_train_ego4d(rows: List[dict]) -> List[dict]:
    """Drop Ego4D train rows with a start at the clip's end, an empty span,
    or a span that leaves no negative window."""
    out = []
    for item in rows:
        se = item.get("clip_video_start_end")
        duration = (se[1] - se[0]) if se else item["duration"]
        start, end = item["timestamps"]
        if start >= duration or start >= duration * _EDGE_FUDGE:
            continue
        if start == end:
            continue
        if start < 120 and end > duration - 60:
            continue
        out.append(item)
    return out


def ego4d_flat_to_nested(rows: List[dict]) -> dict:
    """Flat rows -> the minimal nested challenge GT that evaluate_ego4d_nlq
    reads, where only a flat jsonl is at hand."""
    videos = {}
    anns = {}
    for r in rows:
        vid = videos.setdefault(r["video_id"], {"video_uid": r["video_id"], "clips": {}})
        clip = vid["clips"].setdefault(
            r["clip_id"], {"clip_uid": r["clip_id"], "annotations": {}}
        )
        anno_uid, q_idx = r["query_id"].rsplit("_", 1)
        ann = clip["annotations"].setdefault(
            anno_uid, {"annotation_uid": anno_uid, "language_queries": {}}
        )
        ann["language_queries"][int(q_idx)] = {
            "query": r.get("query", ""),
            "clip_start_sec": r["timestamps"][0],
            "clip_end_sec": r["timestamps"][1],
        }
    out = {"videos": []}
    for vid in videos.values():
        clips = []
        for clip in vid["clips"].values():
            annotations = []
            for ann in clip["annotations"].values():
                n = max(ann["language_queries"]) + 1
                queries = [
                    ann["language_queries"].get(i, {"query": ""}) for i in range(n)
                ]
                annotations.append(
                    {"annotation_uid": ann["annotation_uid"],
                     "language_queries": queries}
                )
            clips.append({"clip_uid": clip["clip_uid"], "annotations": annotations})
        out["videos"].append({"video_uid": vid["video_uid"], "clips": clips})
    return out
