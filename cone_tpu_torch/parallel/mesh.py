"""The layout of a training run over ranks (cone_tpu/parallel/mesh.py): the
data-parallel row blocks of a global batch and the Megatron tensor-parallel
shards of the transformer.

The grid. cone_tpu lays its devices out as a (dp, tp) mesh with tp the
inner, adjacent axis (`make_mesh`: `reshape(n // tp, tp)`). Here a rank is
one device, so rank r sits at (dp = r // tp, tp = r % tp): the tp ranks of
one dp slot are adjacent, hold the same rows of every global batch and
each holds a shard of the transformer's matmuls.

The shards (`_TP_RULES`, torch names; a torch Linear's weight is (out, in)):
column-parallel producers, `in_proj_weight` / `in_proj_bias` of every
attention block and `linear1.weight` / `linear1.bias` of every FFN, split
their outputs (dim 0); row-parallel consumers, `out_proj.weight` and
`linear2.weight`, split their inputs (dim 1). Everything else is
replicated: LayerNorms, heads, input projections, embeddings, and the
row-parallel biases, which are added once after the sum.

The layout is the port's own, head-aligned. cone_tpu splits the packed
(D, 3D) kernel by contiguous columns and lets GSPMD reshard around the head
reshape. Here rank t owns rows [t D/tp, (t+1) D/tp) of each of the q, k and
v thirds of `in_proj_weight` (its nhead/tp heads) and the matching column
block of `out_proj.weight`, which gives one all-reduce forward per attention
block and one per FFN (models/transformer.py). An attention pair shards
only when nhead divides by tp, an FFN pair only when dim_feedforward does;
otherwise the pair stays replicated, as cone_tpu's `param_shardings`
replicates a leaf that does not divide. What is held against cone_tpu is
results, not layout: the trajectory of a (dp, tp) run is the single
process's.

`shard_state_dict` and `gather_state_dict` carry full
reference-named tensors to this rank's blocks and back, for the weights and
for the optimizer's moments (`shard_optimizer_state`,
`gather_optimizer_state`): checkpoints hold full tensors, whatever the tp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import torch
from torch import nn


def row_block(bsz: int, rank: int, world: int) -> Tuple[int, int]:
    """(lo, hi): the contiguous rows of a global batch of `bsz` that `rank`
    of `world` owns."""
    if bsz % world:
        raise ValueError(f"global batch {bsz} must divide by the {world} ranks")
    per = bsz // world
    return rank * per, (rank + 1) * per


def tp_size(tp_devices: int, world: int) -> int:
    """The tensor-parallel width of a run of `world` ranks."""
    if tp_devices < 1:
        raise ValueError(f"train.tp_devices must be at least 1, not {tp_devices}")
    if world % tp_devices:
        raise ValueError(
            f"the {world} rank(s) do not divide by train.tp_devices={tp_devices}: tensor "
            "parallel training runs over `train --distributed` with a multiple of that "
            "many processes")
    return tp_devices


def grid_coords(rank: int, tp: int) -> Tuple[int, int]:
    """(dp, tp) coordinates of `rank` on a grid of tp-wide rows."""
    return rank // tp, rank % tp


@dataclass(frozen=True)
class Shard:
    """A tensor split along `dim`, seen as `parts` equal chunks (the q, k, v
    thirds of a packed projection); rank t holds block t of each chunk."""
    dim: int
    parts: int = 1


COLUMN, ROW, QKV = Shard(0), Shard(1), Shard(0, 3)

# (name suffix, shard, what must divide by tp: the head count or the width)
_TP_RULES = (
    ("in_proj_weight", QKV, "heads"),
    ("in_proj_bias", QKV, "heads"),
    ("out_proj.weight", ROW, "heads"),
    ("linear1.weight", COLUMN, "width"),
    ("linear1.bias", COLUMN, "width"),
    ("linear2.weight", ROW, "width"),
)


def param_shardings(shapes: Mapping[str, Sequence[int]], tp: int,
                    nhead: int) -> Dict[str, Shard]:
    """name -> Shard of every tensor in `shapes` (a state dict or its shapes)
    that a rule shards at width tp; the rest are replicated. nhead is the
    transformer's head count (every attention block has it)."""
    out = {}
    if tp <= 1:
        return out
    for name, shape in shapes.items():
        shape = tuple(getattr(shape, "shape", shape))
        for suffix, shard, unit in _TP_RULES:
            if name.endswith(suffix):
                n = nhead if unit == "heads" else shape[shard.dim] // shard.parts
                if n % tp == 0:
                    out[name] = shard
                break
    return out


def shard_tensor(full: torch.Tensor, shard: Shard, rank: int, tp: int) -> torch.Tensor:
    """This rank's block of each of the shard's chunks, concatenated."""
    return torch.cat([c.chunk(tp, shard.dim)[rank]
                      for c in full.chunk(shard.parts, shard.dim)], shard.dim)


def unshard_tensor(pieces: Sequence[torch.Tensor], shard: Shard) -> torch.Tensor:
    """The inverse of shard_tensor over every rank's block, in tp order."""
    chunks = [p.chunk(shard.parts, shard.dim) for p in pieces]
    return torch.cat([chunks[t][j] for j in range(shard.parts) for t in range(len(pieces))],
                     shard.dim)


def shard_state_dict(sd: Mapping[str, torch.Tensor], layout: Mapping[str, Shard],
                     rank: int, tp: int) -> Dict[str, torch.Tensor]:
    return {k: shard_tensor(v, layout[k], rank, tp) if k in layout else v
            for k, v in sd.items()}


def _gather(tensors: Dict, layout_of: Dict, tp) -> Dict:
    """{key: local tensor} -> {key: full tensor}: the sharded ones (keys in
    layout_of) through one all-gather over the tp group, in key order."""
    keys = [k for k in tensors if k in layout_of]
    out = dict(tensors)
    if not keys:
        return out
    flat = torch.cat([tensors[k].detach().reshape(-1).float() for k in keys])
    pieces = tp.all_gather(flat)
    sizes = [tensors[k].numel() for k in keys]
    per_rank = [p.split(sizes) for p in pieces]
    for i, k in enumerate(keys):
        t = tensors[k]
        out[k] = unshard_tensor([r[i].view(t.shape).to(t.dtype) for r in per_rank],
                                layout_of[k])
    return out


def gather_state_dict(sd: Mapping[str, torch.Tensor], layout: Mapping[str, Shard],
                      tp) -> Dict[str, torch.Tensor]:
    """This rank's state dict -> the full one, on every rank of its tp group
    (a collective: every tp rank calls it)."""
    return _gather(dict(sd), dict(layout), tp)


def optimizer_param_names(optimizer: torch.optim.Optimizer, model: nn.Module) -> List[str]:
    """The model's parameter name of each index in the optimizer's state dict."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _moments(osd, names, layout):
    return {(i, k): v for i, s in osd["state"].items() for k, v in s.items()
            if names[i] in layout and torch.is_tensor(v) and v.dim() > 0}


def shard_optimizer_state(osd: dict, names: Sequence[str], layout: Mapping[str, Shard],
                          rank: int, tp: int) -> dict:
    """A full optimizer state dict -> this rank's: each sharded parameter's
    moments (exp_avg, exp_avg_sq) cut as the parameter is; the step counts
    and the groups as they are."""
    moments = _moments(osd, names, layout)
    state = {i: {k: shard_tensor(v, layout[names[i]], rank, tp) if (i, k) in moments else v
                 for k, v in s.items()}
             for i, s in osd["state"].items()}
    return {"state": state, "param_groups": osd["param_groups"]}


def gather_optimizer_state(osd: dict, names: Sequence[str], layout: Mapping[str, Shard],
                           tp) -> dict:
    """This rank's optimizer state dict -> the full one (a collective)."""
    local = _moments(osd, names, layout)
    full = _gather(local, {key: layout[names[key[0]]] for key in local}, tp)
    state = {i: {k: full.get((i, k), v) for k, v in s.items()}
             for i, s in osd["state"].items()}
    return {"state": state, "param_groups": osd["param_groups"]}


def shard_model(model: nn.Module, tp) -> Dict[str, Shard]:
    """Cut `model`'s transformer to this rank's shards in place and route
    the modules that hold them through the tp group (`tp`, a
    distributed.TensorParallel); returns the layout. Each sharded
    parameter is a new Parameter flagged `tp_sharded` (the grad-norm counts
    its square over the tp group); build the optimizer after this call."""
    from cone_tpu_torch.models.transformer import MultiheadAttention

    heads = {m.nhead for m in model.modules() if isinstance(m, MultiheadAttention)}
    if not heads:
        return {}
    if len(heads) > 1:
        raise ValueError(f"attention blocks of different head counts {sorted(heads)}")
    layout = param_shardings({n: p.shape for n, p in model.named_parameters()}, tp.size,
                             heads.pop())
    modules = dict(model.named_modules())
    for name, shard in layout.items():
        owner, attr = name.rsplit(".", 1)
        old = getattr(modules[owner], attr)
        new = nn.Parameter(shard_tensor(old.detach(), shard, tp.rank, tp.size),
                           requires_grad=old.requires_grad)
        new.tp_sharded = True
        setattr(modules[owner], attr, new)
        # the module that computes on the shard: the attention block that
        # owns the in-projection, the layer that owns linear1
        if attr == "in_proj_weight":
            modules[owner].tp = tp
        elif name.endswith("linear1.weight"):
            modules[owner.rsplit(".", 1)[0]].tp = tp
    return layout
