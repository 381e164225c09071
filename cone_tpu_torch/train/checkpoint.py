"""Workdir checkpoints: the config snapshot, the weights and the training
state.

A workdir holds `config.json` (the ConeConfig the model was trained with)
and `model_<tag>.ckpt`, a torch file under the reference's parameter names
(cone/model.py), in the reference's own checkpoint layout
(cone/train.py:184-191):

    {"model": state_dict, "optimizer": AdamW state, "lr_scheduler": ...,
     "epoch": n, "extra": {"best_score": ..., "es_cnt": ...}}

A 2D-TAN workdir holds CONE_TAN names; its weights load from the port's
own `train` or from a reference CONE_TAN state dict (`module.` prefixes
and the golden fixtures' compact names taken too).

A JAX workdir (cone_tpu's `train`) holds `model_<tag>.msgpack` instead:
`load_model` reads it when there is no `model_<tag>.ckpt`, and
`load_params` takes one too (or a raw {"params": ...} file of
tools/convert_ckpt.py --out), for both families (train/jax_workdir.py).
Only the weights cross: the optax optimizer state and the lr schedule
have no counterpart here, so a JAX workdir is evaluated, served or
warm-started from, not resumed.
A reference CONE checkpoint loads as it is, weights-only: its
`{"model", "optimizer", "lr_scheduler", "epoch", "opt"}` (no "extra"), with
`opt` the reference's argparse.Namespace (which holds a torch.device),
through `load_model`, `load_params` and `CheckpointManager.restore`.
Tags follow the reference's three flavours (cone/train.py:181-223): `best`
on a stop-score improvement, `latest` at every eval, periodic `e{NNNN}`.
`extra` carries the early-stop counters, so a resumed run does not re-arm
a fresh patience window, and for 2D-TAN the plateau controller's
`plateau_best` and `plateau_num_bad` (its only copy: a TAN checkpoint has
no "lr_scheduler").

Data parallel: the workdir is shared by every rank; rank 0 writes (the
config and each checkpoint), the others wait at a barrier after the rename,
and every rank restores. Tensor parallel: the files hold the full tensors,
gathered from the tp shards before the save (train/loop.py), so they read
as a one-process run's at any tp.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import torch

from cone_tpu_torch.config import ConeConfig
from cone_tpu_torch.convert import load_reference_state_dict, load_reference_tan_state_dict
from cone_tpu_torch.models.tan import ConeTanModel
from cone_tpu_torch.parallel import distributed
from cone_tpu_torch.train.jax_workdir import read_msgpack, state_dict_from_jax


def load_config(workdir: str) -> ConeConfig:
    return ConeConfig.load(os.path.join(workdir, "config.json"))


def checkpoint_path(workdir: str, tag: str) -> str:
    return os.path.join(workdir, f"model_{tag}.ckpt")


def jax_checkpoint_path(workdir: str, tag: str) -> str:
    return os.path.join(workdir, f"model_{tag}.msgpack")


# what a reference checkpoint pickles beyond tensors and containers: its
# options (`opt`, cone/train.py:184-191), whose torch.device the
# weights-only unpickler takes already; any other class is refused
_SAFE_GLOBALS = [argparse.Namespace]


def _read(path: str) -> dict:
    with torch.serialization.safe_globals(_SAFE_GLOBALS):
        return torch.load(path, map_location="cpu", weights_only=True)


def _load_weights(model: torch.nn.Module, raw) -> None:
    """Strict load of a reference-named file into a model of either family."""
    tan = isinstance(model, ConeTanModel)
    model.load_state_dict((load_reference_tan_state_dict if tan
                           else load_reference_state_dict)(raw))


def _load_file(path: str, model: torch.nn.Module):
    """Strict load of a torch file, or of a flax-msgpack file (by its
    .msgpack suffix), into `model`; returns the file's decoded contents."""
    if path.endswith(".msgpack"):
        raw = read_msgpack(path)
        model.load_state_dict(state_dict_from_jax(raw, model))
    else:
        raw = _read(path)
        _load_weights(model, raw)
    return raw


def load_model(workdir: str, tag: str = "best", device="cuda", cfg: ConeConfig = None):
    """(model, epoch): the configured family's model on `device` with the
    weights of `model_<tag>.ckpt`, or else of a JAX workdir's
    `model_<tag>.msgpack` (strict load), in eval mode. `cfg` defaults to
    the workdir's config.json."""
    from cone_tpu_torch.train.loop import build_family

    cfg = load_config(workdir) if cfg is None else cfg
    path = checkpoint_path(workdir, tag)
    if not os.path.exists(path):
        path = jax_checkpoint_path(workdir, tag)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{workdir} holds neither model_{tag}.ckpt (the port's or the reference's) "
            f"nor model_{tag}.msgpack (the JAX package's)")
    model = build_family(cfg, seed=0, device=device)
    raw = _load_file(path, model)
    epoch = int(raw["epoch"]) if isinstance(raw, dict) and "epoch" in raw else 0
    return model.eval(), epoch


def load_params(path: str, model: torch.nn.Module) -> None:
    """Weights-only warm start: load a reference-named torch file (a
    CheckpointManager file or a reference checkpoint), or a flax-msgpack
    file (a JAX workdir's model_<tag>.msgpack, or tools/convert_ckpt.py
    --out's raw {"params": ...}), into `model` (strict). Optimizer and
    epoch state in the file are ignored (the reference's --resume without
    --resume_all, cone/config.py:63-66)."""
    _load_file(path, model)


class CheckpointManager:
    """best / latest / periodic checkpoints of one workdir; writes
    config.json at construction when given a config (rank 0)."""

    def __init__(self, workdir: str, cfg: Optional[ConeConfig] = None):
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        if cfg is not None and distributed.is_main():
            cfg.save(os.path.join(workdir, "config.json"))

    def save(self, tag: str, model: torch.nn.Module, optimizer=None, scheduler=None,
             epoch: int = 0, extra: Optional[Dict[str, float]] = None) -> str:
        """Write model_<tag>.ckpt atomically (a temporary file, then
        os.replace) on rank 0; every rank returns once it is in place.
        `optimizer` is an optimizer or its state dict (a tensor-parallel
        run passes the gathered one)."""
        path = checkpoint_path(self.workdir, tag)
        if distributed.is_main():
            state = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     "epoch": int(epoch),
                     "extra": {k: float(v) for k, v in (extra or {}).items()}}
            if optimizer is not None:
                state["optimizer"] = (optimizer if isinstance(optimizer, dict)
                                      else optimizer.state_dict())
            if scheduler is not None:
                state["lr_scheduler"] = scheduler.state_dict()
            torch.save(state, path + ".tmp")
            os.replace(path + ".tmp", path)
        distributed.barrier(f"checkpoint {tag}")
        return path

    def restore(self, tag: str, model: torch.nn.Module, optimizer=None, scheduler=None,
                steps_per_epoch: Optional[int] = None):
        """Load model_<tag>.ckpt into `model` (and `optimizer`, `scheduler`
        where given and saved); returns (epoch, extra), extra {} for files
        written without one (a reference checkpoint). The reference's
        StepLR counts epochs where the port's schedule counts updates: its
        state becomes the port's update count, which needs
        `steps_per_epoch`."""
        raw = _read(checkpoint_path(self.workdir, tag))
        _load_weights(model, raw)
        if optimizer is not None and "optimizer" in raw:
            optimizer.load_state_dict(raw["optimizer"])
        if scheduler is not None and "lr_scheduler" in raw:
            state = raw["lr_scheduler"]
            if "lr_lambdas" in state:   # the port's LambdaLR
                scheduler.load_state_dict(state)
            elif steps_per_epoch is None:
                raise ValueError(f"model_{tag}.ckpt holds the reference's epoch-counted "
                                 "StepLR: restore needs steps_per_epoch to resume it")
            else:
                scheduler.last_epoch = int(state["last_epoch"]) * steps_per_epoch
        return int(raw.get("epoch", 0)), {k: float(v) for k, v in raw.get("extra", {}).items()}

    def exists(self, tag: str) -> bool:
        return os.path.exists(checkpoint_path(self.workdir, tag))
