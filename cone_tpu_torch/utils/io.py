"""Small host utilities: json/jsonl io and normalization
(counterparts of utils/basic_utils.py in the reference)."""

from __future__ import annotations

import json

import numpy as np


def load_json(path):
    with open(path) as f:
        return json.load(f)


def save_json(obj, path, pretty=False):
    with open(path, "w") as f:
        if pretty:
            json.dump(obj, f, indent=2, sort_keys=True)
        else:
            json.dump(obj, f)


def load_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def save_jsonl(rows, path):
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows))


def l2_normalize(x: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Row-wise L2 normalization with the reference's additive-eps
    convention (utils/basic_utils.py:97)."""
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


def min_max_normalize(values):
    """Min-max rescale a list to [0, 1]; identity when constant
    (utils/basic_utils.py:10-20)."""
    amin, amax = min(values), max(values)
    if amin == amax:
        return list(values)
    return [(v - amin) / (amax - amin) for v in values]
