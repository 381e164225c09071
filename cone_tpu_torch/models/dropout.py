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
stream, and one process is the one-rank case. A multiscale rank holds two
blocks of the global [standard x B ; extra x 3B] batch (data/multiscale.py),
its standard rows and their extra rows: it names both as (first row, count)
pairs and keeps each block's rows of the mask drawn for all 4B. Outside
that context (a forward in training mode outside the train step) a call
draws the local rows from torch's global generator, as nn.Dropout does.

Tensor parallel: inside a sharded attention block or FFN a rank holds
only its heads (dim 1 of the attention weights) or its hidden units (dim 2
of the FFN hidden), so the call names that slice (`shard`, given per call:
one layer's dropout module also drops the full-width residuals). The mask
is still drawn at the full width, and the rank keeps its rows and its
slice of it: every rank consumes the same stream, and a (dp, tp) run draws
the single process's masks, as cone_tpu's threefry masks are the same
under any sharding.

RowDropout has no parameters and no buffers, so it takes nn.Dropout's
place without changing a state-dict name (`net.1` stays `net.1`).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

# (generator, global row count, this rank's first row or row blocks) of the
# running step
_ROWS: contextvars.ContextVar = contextvars.ContextVar("dropout_rows", default=None)


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed of one train step: the same on every
    rank, distinct across steps."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])


@contextlib.contextmanager
def global_rows(generator: Optional[torch.Generator], n_rows: int,
                offset: Union[int, Sequence[Tuple[int, int]]]):
    """Within the block, every RowDropout draws its mask for `n_rows` rows
    from `generator` and keeps rows offset : offset + its batch, or, for
    `offset` a sequence of (first row, count) blocks, those rows block by
    block (their counts sum to its batch)."""
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

    def forward(self, x: torch.Tensor, shard: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
        """shard: (dim, full size, this rank's first index) when x holds a
        slice of dim `dim` (tensor parallel)."""
        if not self.training or self.p == 0.0:
            return x
        rows = _ROWS.get()
        gen, n_rows, blocks = (None, x.shape[0], 0) if rows is None else rows
        if isinstance(blocks, int):
            blocks = ((blocks, x.shape[0]),)
        if sum(n for _, n in blocks) != x.shape[0]:
            raise ValueError(f"row blocks {blocks} do not hold a batch of {x.shape[0]}")
        for lo, n in blocks:
            if lo < 0 or lo + n > n_rows:
                raise ValueError(f"rows {lo}:{lo + n} outside a global batch of {n_rows}")
        shape = [n_rows] + list(x.shape[1:])
        if shard is not None:
            shape[shard[0]] = shard[1]
        # float32 uniforms whatever x's dtype (flax's bernoulli draws in
        # float32): a bfloat16 run keeps the float32 run's masks
        u = torch.rand(shape, generator=gen, device=x.device, dtype=torch.float32)
        parts = [u[lo : lo + n] for lo, n in blocks]
        u = parts[0] if len(parts) == 1 else torch.cat(parts)
        if shard is not None:
            u = u.narrow(shard[0], shard[2], x.shape[shard[0]])
        scale = 0.0 if self.p == 1.0 else 1.0 / (1.0 - self.p)
        return x * (u >= self.p).to(x.dtype) * scale

    def extra_repr(self) -> str:
        return f"p={self.p}"
