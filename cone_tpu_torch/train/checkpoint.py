"""Workdir checkpoints, read side: the config snapshot and the weights.

A workdir holds `config.json` (the ConeConfig the model was trained with)
and `model_<tag>.ckpt`, a torch file {"model": state_dict, "epoch": n}
under the reference's parameter names (cone/model.py). That is the format
of the reference's own checkpoints and of `tools/convert_ckpt.py --export`,
which writes one from a JAX workdir. Saving, optimizer state and the
early-stop counters come with training.
"""

from __future__ import annotations

import os

import torch

from cone_tpu_torch.config import ConeConfig
from cone_tpu_torch.convert import load_reference_state_dict


def load_config(workdir: str) -> ConeConfig:
    return ConeConfig.load(os.path.join(workdir, "config.json"))


def checkpoint_path(workdir: str, tag: str) -> str:
    return os.path.join(workdir, f"model_{tag}.ckpt")


def load_model(workdir: str, tag: str = "best", device="cuda", cfg: ConeConfig = None):
    """(model, epoch): the configured family's model on `device` with the
    weights of `model_<tag>.ckpt` (strict load). `cfg` defaults to the
    workdir's config.json."""
    from cone_tpu_torch.train.loop import build_family

    cfg = load_config(workdir) if cfg is None else cfg
    path = checkpoint_path(workdir, tag)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: the port reads reference-named torch checkpoints; "
            "make one from a JAX workdir with tools/convert_ckpt.py --export "
            f"--workdir <workdir> --ckpt {tag} --out {path}")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    model = build_family(cfg, seed=0, device=device)
    model.load_state_dict(load_reference_state_dict(raw))
    epoch = int(raw["epoch"]) if isinstance(raw, dict) and "epoch" in raw else 0
    return model.eval(), epoch
