"""Optimizers of both families.

CONE: AdamW with a reduced-lr adapter group and a step lr decay. The
reference's setup (cone/inference.py:511-523): AdamW at lr 1e-4 and
weight decay 1e-4 on every parameter, the adapter's parameters at
lr * coef_lr, and a StepLR that multiplies the lr by 0.1 every `lr_drop`
epochs, here counted per optimizer step as the JAX package's `step_lr`
does. Gradients are clipped to a global norm of `grad_clip` before the
update (cone/train.py:87-88), in the train step.

2D-TAN: Adam with its L2 weight decay and a ReduceLROnPlateau on the eval
stop score (cone_2dtan/moment_localization/train.py:143-147), gradients
clipped to a global norm of 10 in the train step (train/tan_step.py).

Parameters without a gradient in a step (the adapter before
start_epoch_for_adapter, an unused text position table) step as in
cone_tpu, whose optax chains see a zero gradient for them: the train steps
give each a zero gradient after the clip (`zero_missing_grads`), so AdamW
decays it and Adam's L2 decay moves it, and every parameter's step count is
optax's shared count. The original CONE and 2D-TAN recipes, on torch's
optimizers, skip such a parameter; this is cone_tpu's departure from them,
which the port shares.
"""

from __future__ import annotations

import torch

from cone_tpu_torch.config import TrainConfig


def step_lr_factor(step: int, lr_drop_epochs: int, steps_per_epoch: int) -> float:
    """0.1 ** (epoch // lr_drop) for the update with index `step`."""
    epoch = step // max(steps_per_epoch, 1)
    return 0.1 ** (epoch // lr_drop_epochs)


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: int):
    """(AdamW, LambdaLR): a "base" group at cfg.lr and an "adapter" group
    (parameter names containing "adapter_layer") at cfg.lr * cfg.coef_lr,
    both with weight decay cfg.wd; the scheduler steps once per update."""
    groups = {"base": [], "adapter": []}
    for name, p in model.named_parameters():
        groups["adapter" if "adapter_layer" in name else "base"].append(p)
    scale = {"base": 1.0, "adapter": cfg.coef_lr}
    opt = torch.optim.AdamW(
        [{"params": ps, "lr": cfg.lr * scale[g], "name": g} for g, ps in groups.items() if ps],
        lr=cfg.lr, weight_decay=cfg.wd)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: step_lr_factor(step, cfg.lr_drop, steps_per_epoch))
    return opt, sched


def make_tan_optimizer(model: torch.nn.Module, cfg: TrainConfig):
    """(Adam, ReduceLROnPlateau) for the TAN family.

    The reference's Adam(lr, betas=(0.9, 0.999), weight_decay): L2 decay
    added to the (already clipped) gradient before the moments, not
    AdamW's decoupled decay; the lr falls by `plateau_factor` after more
    than `plateau_patience` evals whose stop score did not rise by more
    than 1e-4 relative (torch's rel-mode max; lib/core/config.py:75-76).
    The scheduler's `best` and `num_bad_epochs` travel in the checkpoints'
    extra state (train/loop.py), its lr in the optimizer's."""
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                           weight_decay=cfg.wd)
    plateau = torch.optim.lr_scheduler.ReduceLROnPlateau(
        opt, mode="max", factor=cfg.plateau_factor, patience=cfg.plateau_patience,
        threshold=1e-4, threshold_mode="rel")
    return opt, plateau


def zero_missing_grads(params) -> None:
    """A zero gradient for each of `params` that has none (module
    docstring): the update cone_tpu's optax chains make for it."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
