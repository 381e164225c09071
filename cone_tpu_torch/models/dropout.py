"""Dropout whose masks are drawn for the global batch.

cone_tpu draws every row's dropout mask from one key for the whole global
batch (cone_tpu/train/loop.py:396-405, :427), so its N-process run is its
single run. `RowDropout` does the same here: in training mode each call
draws a uniform mask of the global batch's shape from one generator and
keeps this rank's row block of it. Every tensor that reaches dropout in
the CONE model is batch-first, rows on dim 0: (B, H, Lq, Lk) attention
weights and (B, L, D) activations.

The train step (train/step.py) seeds one generator per step from
(train.seed, global step) and runs its forwards inside
`global_rows(generator, n_rows, offset)`; every rank consumes the same
stream, and one process is the one-rank case. Outside that context (a
forward in training mode outside the train step) a call draws the local
rows from torch's global generator, as nn.Dropout does.

RowDropout has no parameters and no buffers, so it takes nn.Dropout's
place without changing a state-dict name (`net.1` stays `net.1`).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import numpy as np
import torch
from torch import nn

# (generator, global row count, this rank's first row) of the running step
_ROWS: contextvars.ContextVar = contextvars.ContextVar("dropout_rows", default=None)


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed of one train step: the same on every
    rank, distinct across steps."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])


@contextlib.contextmanager
def global_rows(generator: Optional[torch.Generator], n_rows: int, offset: int):
    """Within the block, every RowDropout draws its mask for `n_rows` rows
    from `generator` and keeps rows offset : offset + its batch."""
    token = _ROWS.set((generator, n_rows, offset))
    try:
        yield
    finally:
        _ROWS.reset(token)


class RowDropout(nn.Module):
    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout probability {p} is not in [0, 1]")
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        rows = _ROWS.get()
        gen, n_rows, lo = (None, x.shape[0], 0) if rows is None else rows
        if lo + x.shape[0] > n_rows:
            raise ValueError(f"rows {lo}:{lo + x.shape[0]} outside a global batch of {n_rows}")
        u = torch.rand((n_rows,) + tuple(x.shape[1:]), generator=gen, device=x.device,
                       dtype=x.dtype)[lo : lo + x.shape[0]]
        scale = 0.0 if self.p == 1.0 else 1.0 / (1.0 - self.p)
        return x * (u >= self.p).to(x.dtype) * scale

    def extra_repr(self) -> str:
        return f"p={self.p}"
