"""Replay the reference's training fixture through the port's train step.

tests/golden/train_trajectory.npz holds the reference's initial weights
(`w0::`), one batch, its per-step total loss, criterion terms and pre-clip
gradient norm, and its weights after 4 steps (`w::`) of its own recipe
(cone/train.py:53-89 with the grouped AdamW of cone/inference.py:511-523,
dropout off, adapter on). The port runs the same 4 steps from the same
weights and is held within tests/test_train_parity.py's limits:

    loss_overall  2e-3 x max(1, |ref|)     grad_norm  2e-3 x ref
    each term     3e-3 x max(1, |ref|)     weights    5e-4 absolute

    python -m cone_tpu_torch.tools.golden_train [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden", "train_trajectory.npz")
TERMS = ("loss_span", "loss_giou", "loss_label", "loss_saliency", "loss_adapter",
         "loss_span_0", "loss_giou_0", "loss_label_0")
LIMITS = {"loss_overall": 2e-3, "grad_norm": 2e-3, "terms": 3e-3, "weights": 5e-4}


def replay(g: dict, device="cuda"):
    """The fixture's steps through make_train_step on `device`; returns
    (per-step metrics as floats, final state dict on the host)."""
    from cone_tpu_torch.config import ConeConfig, ModelConfig, TrainConfig
    from cone_tpu_torch.convert import load_reference_state_dict
    from cone_tpu_torch.models.cone import ConeModel
    from cone_tpu_torch.train.optim import make_optimizer
    from cone_tpu_torch.train.step import make_train_step, to_floats

    cfg = ConeConfig(
        model=ModelConfig(t_feat_dim=36, v_motion_feat_dim=40, v_appear_feat_dim=36,
                          hidden_dim=256, nheads=8, enc_layers=2, dec_layers=2,
                          dim_feedforward=1024, max_q_l=20, max_v_l=20, dropout=0.0,
                          input_dropout=0.0),
        train=TrainConfig(lr=float(g["lr"]), coef_lr=float(g["coef_lr"]), wd=float(g["wd"]),
                          grad_clip=float(g["grad_clip"]), lr_drop=120))
    model = ConeModel(cfg.model, device=device)
    model.load_state_dict(load_reference_state_dict(
        {k[len("w0::"):]: v for k, v in g.items() if k.startswith("w0::")}))
    # lr_drop 120 epochs x 10 000 steps an epoch >> 4 steps: a constant lr,
    # like the reference's StepLR inside epoch 0
    opt, sched = make_optimizer(model, cfg.train, steps_per_epoch=10_000)
    step = make_train_step(model, opt, sched, cfg)
    batch = {
        "query_tokens": g["src_txt"], "query_mask": g["src_txt_mask"],
        "pos_motion": g["src_vid"], "pos_mask": g["src_vid_mask"],
        "neg_motion": g["neg_vid"], "neg_mask": g["neg_mask"],
        "query_cls": g["cls_txt"], "pos_appear": g["vid_appear"],
        "prop_start": g["prop_start"], "prop_end": g["prop_end"],
        "span_labels": g["tgt_spans"],
        "span_mask": np.ones(g["tgt_spans"].shape[:2], np.float32),
        "sal_pos": g["sal_pos"], "sal_neg": g["sal_neg"],
    }
    steps = [to_floats(step(batch, True)) for _ in range(int(g["n_steps"]))]
    return steps, {k: v.cpu().numpy() for k, v in model.state_dict().items()}


def worst_errors(g: dict, steps, final) -> dict:
    """The worst error of each quantity in the units of LIMITS, with the
    parameter that has the worst weight difference."""
    out = {"loss_overall": 0.0, "grad_norm": 0.0, "terms": 0.0, "weights": 0.0,
           "worst_weight": ""}
    for i, m in enumerate(steps):
        ref = float(g[f"step{i}_loss_overall"])
        out["loss_overall"] = max(out["loss_overall"],
                                  abs(m["loss_overall"] - ref) / max(1.0, abs(ref)))
        ref = float(g[f"step{i}_grad_norm"])
        out["grad_norm"] = max(out["grad_norm"], abs(m["grad_norm"] - ref) / ref)
        for key in TERMS:
            ref = float(g[f"step{i}_{key}"])
            out["terms"] = max(out["terms"], abs(m[key] - ref) / max(1.0, abs(ref)))
    want = {k[len("w::"):]: v for k, v in g.items() if k.startswith("w::")}
    if set(want) != set(final):
        raise ValueError(f"weights differ in names: {sorted(set(want) ^ set(final))}")
    for k, v in want.items():
        diff = float(np.abs(final[k] - v).max())
        if diff > out["weights"]:
            out["weights"], out["worst_weight"] = diff, k
    return out


def check(device="cuda", path: str = FIXTURE) -> dict:
    """Replay and compare; raises beyond LIMITS, returns the worst errors."""
    g = dict(np.load(path).items())
    worst = worst_errors(g, *replay(g, device))
    bad = [k for k in LIMITS if worst[k] >= LIMITS[k]]
    if bad:
        raise RuntimeError(f"golden training trajectory beyond its limits in {bad}: {worst}")
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from cone_tpu_torch.utils.device import resolve_device

    print(check(str(resolve_device(args.device))))


if __name__ == "__main__":
    main()
