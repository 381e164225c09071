"""Submission file writers: Ego4D challenge json + MAD jsonl.

Reference formats: cone/inference.py:130-166 (ego4d: query_id
'{annotation_uid}_{query_idx}' splits into the challenge record; wrapper
dict with version/challenge keys at :391-398) and :169-202 (mad jsonl).
"""

from __future__ import annotations

import json
from typing import List

from cone_tpu_torch.utils.io import save_jsonl


def to_ego4d_challenge(submission: List[dict]) -> dict:
    results = []
    for row in submission:
        anno_uid, q_idx = row["query_id"].rsplit("_", 1)
        results.append(
            {
                "query_idx": int(q_idx),
                "annotation_uid": anno_uid,
                "predicted_times": [t[:2] for t in row["predicted_times"]],
                "clip_uid": row["clip_id"],
            }
        )
    return {
        "version": "1.0",
        "challenge": "ego4d_nlq_challenge",
        "results": results,
    }


def write_submission(submission: List[dict], path: str, dset_name: str) -> str:
    if dset_name == "ego4d":
        with open(path, "w") as f:
            json.dump(to_ego4d_challenge(submission), f)
    else:
        save_jsonl(
            [
                {
                    "query_id": r["query_id"],
                    "predicted_times": [t[:2] for t in r["predicted_times"]],
                    "video_id": r["video_id"],
                }
                for r in submission
            ],
            path,
        )
    return path
