"""The data-parallel layout of a training batch (cone_tpu/parallel/mesh.py).

cone_tpu lays a global batch over a device mesh, each process owning the
contiguous row block of its devices (`shard_batch`). Here a rank is one
device, so the layout is one row block per rank; the model is replicated
(every rank builds it from the same seed). The mesh's second axis, Megatron
tensor parallelism (`mesh._TP_RULES`), is not ported.
"""

from __future__ import annotations

from typing import Tuple


def row_block(bsz: int, rank: int, world: int) -> Tuple[int, int]:
    """(lo, hi): the contiguous rows of a global batch of `bsz` that `rank`
    of `world` owns."""
    if bsz % world:
        raise ValueError(f"global batch {bsz} must divide by the {world} ranks")
    per = bsz // world
    return rank * per, (rank + 1) * per


def tp_size(tp_devices: int) -> int:
    """The tensor-parallel width: 1, the only one the port runs."""
    if tp_devices > 1:
        raise NotImplementedError(
            "tensor parallel training (train.tp_devices > 1) is not ported yet: "
            "ROADMAP Queue 1 item 11 (data parallelism is: train --mesh/--distributed)")
    return 1
