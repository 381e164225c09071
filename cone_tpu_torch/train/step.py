"""The training step (cone/train.py:53-89): positive-window forward,
negative-window forward, the GT-proposal matching forward once the adapter
is on, the criterion, the backward, the global-norm clip and the AdamW
update. The adapter gate (`epoch >= start_epoch_for_adapter`,
cone/train.py:73-78) is an argument of each call.

Data parallel (`reduce` over a group, parallel/distributed.GroupReduce):
the batch is this rank's row block, the criterion its share of the global
batch's loss, and one coalesced all-reduce sums the gradients after the
backward, so the clip sees the global norm and every rank takes the same
update. The metrics a step returns are the global batch's. Dropout masks
are drawn for the global batch from one generator seeded per step from
(train.seed, global step), and each rank keeps its row block of them
(models/dropout.py), so N ranks take the single run's steps with dropout
on too. A multiscale rank's batch is two blocks of the global one, its
standard rows and their extra rows (`rank_row_blocks`): every criterion
term holds per row, so the shares stay exact, and the adapter's InfoNCE
gathers the standard rows alone.

At model.compute_dtype bfloat16 the forwards compute in bfloat16 over the
float32 parameters (models/transformer.py), so every gradient is float32;
the criterion, the gradient norm, the clip and AdamW stay float32, with no
loss scaling and no autocast, as in cone_tpu/train/step.py.

On one CUDA card, with no group of several ranks and no tensor parallel
(`graphs_apply`), the step's device work before the update is captured
once per adapter gate and batch shape as a CUDA graph and replayed, so a
step costs the host one graph launch instead of some 1 700 kernel
launches through the modules and autograd (`make_train_step`).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from cone_tpu_torch.config import ConeConfig
from cone_tpu_torch.models.dropout import global_rows, step_seed
from cone_tpu_torch.models.losses import compute_losses, loss_weight_dict, total_loss
from cone_tpu_torch.ops.pooling import matching_embeds_gt
from cone_tpu_torch.parallel.distributed import LOCAL, GroupReduce, clip_grad_norm_
from cone_tpu_torch.train.optim import zero_missing_grads
from cone_tpu_torch.utils.trace import span


@span("data.to_device")
def batch_to_device(batch: dict, device) -> dict:
    """A TrainLoader batch (numpy) as tensors on `device`; integer arrays
    become int64, the index type of gather. Tensors pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v)
        out[k] = v.to(device, non_blocking=True)
    return out


def rank_row_blocks(batch: dict, reduce: GroupReduce) -> tuple:
    """This rank's (first row, count) blocks of the global batch's motion
    rows: its standard rows (those with a query_cls) and, in a multiscale
    batch, their extra rows after the global batch's standard rows
    (data/multiscale.py: [standard x B ; extra x 3B])."""
    std = len(batch["query_cls"])
    extra = len(batch["query_tokens"]) - std
    blocks = ((reduce.rank * std, std), (reduce.world * std + reduce.rank * extra, extra))
    return tuple(b for b in blocks if b[1])


def global_terms(losses: dict, reduce: GroupReduce) -> dict:
    """Per-term shares -> the global batch's terms (detached), in one
    all-reduce."""
    total = reduce.sum(torch.stack([v.detach().float() for v in losses.values()]))
    return dict(zip(losses, total.unbind()))


def make_loss_fn(model, cfg: ConeConfig, reduce: GroupReduce = LOCAL):
    """loss_fn(batch, adapter_on) -> (total, per-term losses), on tensors on
    the model's device, in whatever mode the model is in: the train step
    (dropout on) and the eval-split loss pass (dropout off, the reference's
    criterion.eval() stance, cone/inference.py:32-34) share it. With a
    group, both are this rank's shares."""
    weights = loss_weight_dict(cfg.loss, cfg.model.dec_layers)

    def loss_fn(batch: dict, adapter_on: bool):
        pos_out = model(batch["query_tokens"], batch["query_mask"],
                        batch["pos_motion"], batch["pos_mask"])
        neg_out = None
        if cfg.loss.neg_loss:
            neg_out = model(batch["query_tokens"], batch["query_mask"],
                            batch["neg_motion"], batch["neg_mask"])
            neg_out["vid_mask"] = batch["neg_mask"]
        if adapter_on and cfg.loss.adapter_loss:
            pos_out["adapter_embeds"] = matching_embeds_gt(
                model.adapt, batch["query_cls"], batch["pos_appear"], batch["prop_start"],
                batch["prop_end"])
        targets = {"span_labels": batch["span_labels"], "span_mask": batch["span_mask"],
                   "saliency_pos": batch["sal_pos"], "saliency_neg": batch["sal_neg"]}
        losses = compute_losses(pos_out, targets, neg_out, cfg.loss, reduce)
        total = total_loss(losses, weights)
        losses["loss_overall"] = total
        return total, losses

    return loss_fn


def graphs_apply(device, reduce: GroupReduce = LOCAL, tp=None) -> bool:
    """Whether the train step replays its device work as CUDA graphs: on a
    CUDA device, with one rank and no tensor parallel. A step of several
    ranks (their collectives) or of tp shards, and every CPU step, runs
    eagerly."""
    return torch.device(device).type == "cuda" and reduce.world == 1 and tp is None


# one captured step: its input buffers, the graph, the metrics' names and
# stacked output, and the gradients its backward writes
_Graph = collections.namedtuple("_Graph", "inputs graph names out grads")


def make_train_step(model, optimizer, scheduler, cfg: ConeConfig,
                    reduce: GroupReduce = LOCAL, tp=None, graphs=None):
    """train_step(batch, adapter_on) -> metrics: every criterion term,
    loss_overall and grad_norm (the global gradient norm before the clip),
    as 0-d tensors on the device; the model is in train mode for the step.
    Parameters without a gradient in a step (the adapter before it is
    switched on, an unused text position table) stay out of the gradient
    all-reduce and the norm, then take a zero gradient, so AdamW decays
    them and counts the step as cone_tpu's optax does (train/optim.py).
    Tensor parallel (`tp`, a distributed.TensorParallel; the model cut by
    parallel/mesh.shard_model, `reduce` over the dp group): the norm sums
    the shards' squares over the tp group.

    The step's two forwards draw their dropout masks, in call order, from
    one generator on the model's device, seeded from (train.seed, global
    step); the global step is the lr schedule's step count, which a
    resumed run restores. The masks cover the global batch (this rank's
    rows times the ranks) and the rank keeps its row block.

    CUDA graphs (`graphs`, default `graphs_apply(device, reduce, tp)`;
    False runs the eager step on a card too, the graphs' reference in the
    card tests and tools/bench_train.py): the forwards, the backward, the
    clip and the metrics' stack are captured once per (adapter_on, the
    batch's shapes and dtypes), after one eager warm-up on a side stream
    that updates nothing, and each step copies its batch into the graph's
    input buffers, seeds the generator, which the graph reads at replay,
    and replays it; AdamW and the lr schedule step eagerly on the
    gradients the graph wrote, so the masks, the update and the optimizer
    state are the eager step's. The graphs read the parameters and write
    their gradients by address: AdamW and load_state_dict write the
    weights in place, and a step whose parameters moved to new storage
    (`param.data = ...`, a module moved to another device or dtype) drops
    every graph and captures again. The returned metrics are a copy, which
    the next replay leaves alone. `train_step.counts` counts captures, the
    warm-ups before them, replays and eager steps."""
    loss_fn = make_loss_fn(model, cfg, reduce)
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    clip = cfg.train.grad_clip if cfg.train.grad_clip > 0 else float("inf")
    gen = torch.Generator(device=device)
    if graphs is None:
        graphs = graphs_apply(device, reduce, tp)
    counts = {"captures": 0, "warmups": 0, "replays": 0, "eager": 0}
    captured = {}          # (adapter_on, batch shapes and dtypes) -> _Graph
    addresses = []         # the parameters' storage the graphs read

    def seed():
        gen.manual_seed(step_seed(cfg.train.seed, scheduler.last_epoch))

    def forward_backward(batch: dict, adapter_on: bool) -> dict:
        """The step's device work before the update, drawing from `gen`."""
        with span("step.forward"):
            with global_rows(gen, len(batch["query_tokens"]) * reduce.world,
                             rank_row_blocks(batch, reduce)):
                total, losses = loss_fn(batch, adapter_on)
        with span("step.backward"):
            optimizer.zero_grad(set_to_none=True)
            total.backward()
        with span("step.clip"):
            reduce.sum_grads(params)
            # the pre-clip norm (torch's own clip, cone/train.py:87-88)
            grad_norm = clip_grad_norm_(params, clip, tp)
            zero_missing_grads(params)
        metrics = global_terms(losses, reduce)
        metrics["grad_norm"] = grad_norm
        return metrics

    def update():
        with span("step.update"):
            optimizer.step()
            scheduler.step()

    def capture(batch: dict, adapter_on: bool) -> _Graph:
        """torch's whole-network recipe: an eager warm-up on a side stream
        (lazy tables such as ops/matching.permutations' fill there), the
        gradients dropped, then the capture."""
        inputs = {k: v.clone() for k, v in batch.items()}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            forward_backward(inputs, adapter_on)
        torch.cuda.current_stream(device).wait_stream(side)
        counts["warmups"] += 1
        optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        # thread_local: the loader's thread copies batches meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            metrics = forward_backward(inputs, adapter_on)
            out = torch.stack(list(metrics.values()))
        counts["captures"] += 1
        return _Graph(inputs, graph, list(metrics), out, [p.grad for p in params])

    def replay(batch: dict, adapter_on: bool) -> dict:
        now = [p.data_ptr() for p in params]
        if now != addresses:
            captured.clear()
            addresses[:] = now
        key = (adapter_on,) + tuple((k, v.shape, v.dtype) for k, v in batch.items())
        g = captured.get(key)
        if g is None:
            with span("step.capture"):
                g = captured[key] = capture(batch, adapter_on)
        with span("step.replay"):
            torch._foreach_copy_(list(g.inputs.values()), [batch[k] for k in g.inputs])
            seed()
            g.graph.replay()
        for p, grad in zip(params, g.grads):   # this graph's, after another's replay
            p.grad = grad
        counts["replays"] += 1
        update()
        return dict(zip(g.names, g.out.clone().unbind()))

    def eager(batch: dict, adapter_on: bool) -> dict:
        seed()
        metrics = forward_backward(batch, adapter_on)
        update()
        counts["eager"] += 1
        return metrics

    run = replay if graphs else eager

    @span("step")
    def train_step(batch: dict, adapter_on: bool = False) -> dict:
        model.train()
        return run(batch_to_device(batch, device), adapter_on)

    train_step.counts = counts
    return train_step


def make_eval_loss_step(model, cfg: ConeConfig, reduce: GroupReduce = LOCAL):
    """eval_loss_step(batch, adapter_on) -> per-term losses of the global
    batch: the criterion forward-only on eval-split windows, the model in
    eval mode (restored after) under torch.no_grad(). The eval-loss curves
    the reference prepares for TensorBoard in eval_epoch
    (cone/inference.py:30-36, 96-98)."""
    loss_fn = make_loss_fn(model, cfg, reduce)
    device = next(model.parameters()).device

    def eval_loss_step(batch: dict, adapter_on: bool = False) -> dict:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                _, losses = loss_fn(batch_to_device(batch, device), adapter_on)
        finally:
            model.train(was_training)
        return global_terms(losses, reduce)

    return eval_loss_step


@span("step.readback")
def to_floats(metrics: dict) -> dict:
    """0-d device tensors -> Python floats in one device-to-host transfer."""
    if not metrics:
        return {}
    host = torch.stack([v.float() for v in metrics.values()]).cpu().tolist()
    return dict(zip(metrics, host))
