"""Small host utilities: json/jsonl io, normalization, a running meter and
ascii tables (counterparts of utils/basic_utils.py in the reference; the ascii table
stands in for its terminaltables dependency)."""

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


class AverageMeter:
    """Running avg/max/min tracker (utils/basic_utils.py:133)."""

    def __init__(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.max = -float("inf")
        self.min = float("inf")

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.max = max(self.max, val)
        self.min = min(self.min, val)

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def ascii_table(rows, title=None) -> str:
    """Minimal centered ascii table, same shape as the reference's
    terminaltables output."""
    ncol = max(len(r) for r in rows)
    cells = [[str(c).split("\n") for c in r] + [[""]] * (ncol - len(r)) for r in rows]
    widths = [0] * ncol
    for r in cells:
        for j, lines in enumerate(r):
            widths[j] = max(widths[j], max(len(x) for x in lines))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    top = sep if not title else "+" + title + "-" * max(0, len(sep) - 2 - len(title)) + "+"
    out = [top]
    for r in cells:
        height = max(len(lines) for lines in r)
        for k in range(height):
            line = "|"
            for j, lines in enumerate(r):
                cell = lines[k] if k < len(lines) else ""
                line += " " + cell.center(widths[j]) + " |"
            out.append(line)
        out.append(sep)
    return "\n".join(out)
