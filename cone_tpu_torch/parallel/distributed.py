"""Data parallelism over torch.distributed: process-group setup, work
sharding, metadata gathers, and the reductions of the global-batch loss
(cone_tpu/parallel/distributed.py).

cone_tpu shards a batch over an in-process device mesh and over a
multi-process cluster. Torch runs one process per device, so here a rank
is the unit of data parallelism and both forms are ranks of one group:

  * training: every rank builds only its contiguous row block of each
    global batch (parallel/mesh.row_block), computes its exact share of
    the global batch's loss (models/losses.py, through `GroupReduce`), and
    one coalesced all-reduce sums the gradients before the clip;
  * evaluation and corpus search: videos shard by rank (`shard_by_process`,
    strided), each rank grounds its own, and the small result rows merge
    (`all_gather_rows`), so every rank holds the full metric table.

Backends (`rank_layout`, from every rank's host name and card count):
NCCL when each rank has a card of its own, that is when no host runs more
ranks than it has cards; gloo on the CPU and when ranks share a card (NCCL
refuses two ranks on one device).
Metadata (result rows, control scalars) travels over a gloo group on the
CPU, never over the NCCL communicator the gradients use.

Tensor parallelism (train.tp_devices > 1, parallel/mesh.py): `grid` makes
every dp group and every tp group of the (dp, tp) grid of ranks and returns
this rank's `GroupReduce` over its dp group (the global-batch loss and the
gradient sum run over dp: the tp ranks of one dp slot hold the same rows)
and its `TensorParallel` over its tp group, whose two autograd functions are
Megatron's `f` (identity forward, all-reduce backward: `copy_in`) and `g`
(all-reduce forward, identity backward: `reduce_out`). `clip_grad_norm_`
counts a sharded parameter's square over the tp group and a replicated
one once, so the clip sees the single process's norm.

Every function here is a passthrough when no group is initialized; with a
group of one rank the collectives still run (each is then an exact copy).
"""

from __future__ import annotations

import functools
import json
import socket
from collections import Counter
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cone_tpu_torch.parallel.mesh import grid_coords, tp_size
from cone_tpu_torch.utils.device import resolve_device
from cone_tpu_torch.utils.trace import span

# one limit for the rendezvous and for every collective: a rank that fails
# or lags beyond it fails the run instead of hanging it
TIMEOUT_S = 300

# the CPU gloo group that carries metadata (the default group when it is
# gloo), and every rank's (host name, card count) from the rendezvous
_ctrl = {"group": None, "hosts": None}


def rank_layout(hosts: Sequence[Tuple[str, int]], rank: int,
                device_type: str) -> Tuple[int, str]:
    """(local rank, backend) of `rank` from every rank's (host name, card
    count), listed in rank order. The local rank counts the earlier ranks on
    the same host. NCCL needs a card per rank: it is chosen on cards when no
    host runs more ranks than it has cards, else gloo (NCCL refuses two ranks
    on one device); gloo on the CPU. Every rank sees the same list, so every
    rank picks the same backend."""
    host = hosts[rank][0]
    local_rank = sum(h == host for h, _ in hosts[:rank])
    if device_type != "cuda":
        return local_rank, "gloo"
    ranks_on = Counter(h for h, _ in hosts)
    fits = all(ranks_on[h] <= cards for h, cards in hosts)
    return local_rank, "nccl" if fits else "gloo"


def _gather_hosts(store, rank: int, world: int, n_cards: int,
                  host: Optional[str] = None) -> List[Tuple[str, int]]:
    """Every rank's (host name, card count) in rank order, over the
    rendezvous store (before any process group exists)."""
    store = dist.PrefixStore("cone_tpu_torch/hosts", store)
    store.set(str(rank), json.dumps([host or socket.gethostname(), n_cards]))
    return [tuple(json.loads(store.get(str(r)))) for r in range(world)]


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the process group; returns this rank's device.

    coordinator "host:port" with num_processes and process_id: a TCP
    rendezvous at that address (rank 0 serves it). No coordinator and
    num_processes 1: a group of this one rank. Neither: torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).

    After the rendezvous every rank publishes its host name and card count
    on the store, and `rank_layout` turns the list into the rank's local
    rank and the group's backend. The rank's device is cuda:(local rank %
    card count) for device "cuda", the CPU only for device "cpu"."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already initialized")
    dev = resolve_device(device)
    timeout = timedelta(seconds=timeout_s)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        store, rnk, world = next(dist.rendezvous(f"tcp://{coordinator}", process_id,
                                                 num_processes, timeout=timeout))
    elif num_processes == 1:
        store, rnk, world = dist.HashStore(), 0, 1
    elif num_processes is None and process_id is None:
        store, rnk, world = next(dist.rendezvous("env://", timeout=timeout))
    else:
        raise ValueError("num_processes > 1 and process_id need a coordinator")
    store.set_timeout(timeout)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    _ctrl["hosts"] = _gather_hosts(store, rnk, world, n_cards)
    local_rank, backend = rank_layout(_ctrl["hosts"], rnk, dev.type)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rnk, world_size=world, timeout=timeout)
    _ctrl["group"] = (dist.group.WORLD if backend == "gloo"
                      else dist.new_group(backend="gloo", timeout=timeout))
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _ctrl["group"] = _ctrl["hosts"] = None


def n_hosts() -> int:
    """The hosts the group's ranks run on, from the host names gathered at
    the rendezvous; 1 with no group."""
    return len({h for h, _ in _ctrl["hosts"]}) if _ctrl["hosts"] else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def barrier(tag: str = "sync") -> None:
    """Align every rank (over the CPU control group). Every rank must call
    it the same number of times in the same order."""
    if not dist.is_initialized():
        return
    try:
        dist.barrier(group=_ctrl["group"])
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed on rank {rank()}: {e}") from e


def shard_by_process(items: Sequence) -> List:
    """This rank's strided shard of a global work list (videos, queries).
    Strided, not contiguous, so a corpus sorted by length balances."""
    return list(items[rank()::world_size()])


def all_gather_obj(obj) -> List:
    """One picklable object per rank, gathered over the CPU control group;
    every rank returns the list in rank order. Metadata only: result rows
    and control scalars, never a tensor path."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=_ctrl["group"])
    return out


def all_gather_rows(rows: List) -> List:
    """Every rank's list of rows, concatenated in rank order on every rank."""
    return [r for part in all_gather_obj(rows) for r in part]


def assert_same_across_processes(value: float, what: str = "value") -> None:
    """A scalar that drives control flow (the stop score, the resume state,
    the plateau's lr) must agree on every rank or the ranks diverge."""
    vals = np.asarray(all_gather_obj(float(value)), np.float64)
    if not np.allclose(vals, vals[0], rtol=1e-6, atol=1e-9):
        raise RuntimeError(f"{what} diverged across ranks: {vals.tolist()}")


class _GatherRows(torch.autograd.Function):
    """Differentiable gather of equal row blocks: each rank writes its rows
    into a zero buffer at its offset and the buffers are summed. The
    backward sums the incoming gradients over ranks and keeps this rank's
    rows, so every rank's terms that read these rows send their gradient
    home. Built on all-reduce alone, which every backend offers on every
    device."""

    @staticmethod
    def forward(ctx, x, reduce):
        ctx.reduce = reduce
        b = x.shape[0]
        buf = x.new_zeros((reduce.world * b,) + tuple(x.shape[1:]))
        buf[reduce.rank * b:(reduce.rank + 1) * b] = x
        return reduce.sum(buf)

    @staticmethod
    def backward(ctx, grad):
        reduce = ctx.reduce
        b = grad.shape[0] // reduce.world
        return reduce.sum(grad.contiguous())[reduce.rank * b:(reduce.rank + 1) * b], None


class GroupReduce:
    """The reductions that make a rank's loss its exact share of the global
    batch's loss, and its gradients sum to the global gradient.

    The rule (models/losses.py): the global loss is L = sum_r l_r, where l_r
    reads this rank's rows plus global quantities: the span count, summed
    over ranks (`sum`), and the other ranks' embedding rows, gathered with a
    backward that routes their gradient home (`gather_rows`). Then
    dL/dtheta = sum_r dl_r/dtheta as computed on rank r, which is what
    `sum_grads` forms before the clip, so the clip sees the global norm.

    `all_reduce(t)` sums a tensor over ranks in place; None is one rank with
    no group (every method is then the identity)."""

    def __init__(self, rank: int = 0, world: int = 1,
                 all_reduce: Optional[Callable[[torch.Tensor], None]] = None):
        self.rank, self.world, self._all_reduce = rank, world, all_reduce

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over ranks (a new tensor; `t` is left as it was)."""
        if self._all_reduce is None:
            return t
        out = t.detach().clone()
        self._all_reduce(out)
        return out

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(b, ...) row blocks of every rank -> (world * b, ...) in rank order."""
        if self._all_reduce is None:
            return x
        return _GatherRows.apply(x, self)

    def sum_grads(self, params) -> None:
        """Sum the gradients of `params` over ranks in one coalesced
        all-reduce (span `cone.step.allreduce`); parameters without a
        gradient (the same on every rank) are left out of it (the train
        step gives them a zero gradient after the clip)."""
        grads = [p.grad for p in params if p.grad is not None]
        if self._all_reduce is None or not grads:
            return
        with span("step.allreduce"):
            flat = torch.cat([g.reshape(-1) for g in grads])
            self._all_reduce(flat)
            # one multi-tensor copy back, not a copy launch per parameter
            torch._foreach_copy_(grads, [part.view_as(g) for g, part in
                                         zip(grads, flat.split([g.numel() for g in grads]))])


LOCAL = GroupReduce()


def batch_reduce() -> GroupReduce:
    """The reductions over the initialized group, else LOCAL."""
    if not dist.is_initialized():
        return LOCAL
    return GroupReduce(rank(), world_size(), dist.all_reduce)


class _CopyIn(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient summed over the tp
    group backward (each rank's heads or FFN block add their share)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.sum(grad.contiguous()), None


class _ReduceOut(torch.autograd.Function):
    """Megatron's g: the partial products summed over the tp group forward,
    the identity backward (every rank holds the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TensorParallel:
    """One rank's place on the tp axis: `rank` of `size`, with `all_reduce(t)`
    (in place) and `all_gather(t)` (-> the size ranks' tensors in tp order)
    over its tp group. `sizes` counts the all-reduces by (elements, bytes
    per element) until cleared (tools/dist_worker.py reads it a step)."""

    def __init__(self, rank: int, size: int, all_reduce: Callable[[torch.Tensor], None],
                 all_gather: Callable[[torch.Tensor], List[torch.Tensor]]):
        self.rank, self.size = rank, size
        self._all_reduce, self.all_gather = all_reduce, all_gather
        self.sizes = Counter()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the tp group (a new tensor)."""
        out = t.detach().clone()
        self._all_reduce(out)
        self.sizes[(out.numel(), out.element_size())] += 1
        return out

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self)


def _all_gather(t: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def grid(tp_devices: int) -> Tuple[GroupReduce, Optional[TensorParallel]]:
    """(the reductions over this rank's dp group, its TensorParallel or None)
    on the (world // tp, tp) grid of the initialized group (parallel/mesh.py
    `grid_coords`). tp 1: `batch_reduce()` and None. Every rank creates
    every dp and tp group, in the same order, as new_group requires."""
    world = world_size()
    tp = tp_size(tp_devices, world)
    if tp == 1:
        return batch_reduce(), None
    dp = world // tp
    tp_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp))) for d in range(dp)]
    dp_groups = [dist.new_group(list(range(t, world, tp))) for t in range(tp)]
    dp_rank, tp_rank = grid_coords(rank(), tp)
    dp_group, tp_group = dp_groups[tp_rank], tp_groups[dp_rank]
    reduce = GroupReduce(dp_rank, dp, functools.partial(dist.all_reduce, group=dp_group))
    tensor = TensorParallel(tp_rank, tp, functools.partial(dist.all_reduce, group=tp_group),
                            functools.partial(_all_gather, group=tp_group, size=tp))
    return reduce, tensor


def clip_grad_norm_(params, max_norm: float, tp: Optional[TensorParallel] = None):
    """torch.nn.utils.clip_grad_norm_ over the model a tp group holds: the
    global norm of the gradients before the clip, with each sharded
    parameter's (flag `tp_sharded`, parallel/mesh.shard_model) square summed
    over the tp group and each replicated one counted once; the gradients
    scaled by min(1, max_norm / (norm + 1e-6)) as torch scales them."""
    if tp is None:
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    sq = torch.stack(torch._foreach_norm(grads)).square()
    sharded = torch.tensor([getattr(p, "tp_sharded", False) for p in params],
                           device=sq.device)
    total = (tp.sum(sq[sharded].sum()) + sq[~sharded].sum()).sqrt()
    coef = (max_norm / (total + 1e-6)).clamp(max=1.0)
    torch._foreach_mul_(grads, coef)
    return total
