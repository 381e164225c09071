"""Replay the reference 2D-TAN training fixture through the port's TAN
train step.

tests/golden/tan_train_trajectory.npz holds the reference CONE_TAN modules'
initial weights (`w0::`, the fixture's compact names), one batch, its
per-step total loss, loss terms and pre-clip gradient norm, and its weights
after 4 steps (`w::`) of the reference recipe (positive scaled-IoU BCE +
negative-window BCE + adapter_w x adapter NCE, clip_grad_norm_(10), Adam
with a nonzero L2 weight decay; cone_2dtan/moment_localization/
train.py:143-145, 256-288, 457-458). The port runs the same 4 steps from
the same weights, adapter on, and is held within
tests/test_tan_train_parity.py's limits:

    each loss and grad_norm  2e-3 x max(1, |ref|)     weights  5e-4 absolute

and, since 4 Adam steps at lr 1e-4 move no weight by more than about 4e-4
(a missing update would pass the weight limit), each parameter's update
(final minus `w0::` weights) within 1e-3 of the reference's in norm:

    |upd - upd_ref| / |upd_ref|  1e-3

    python -m cone_tpu_torch.tools.golden_tan_train [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden", "tan_train_trajectory.npz")
KEYS = ("loss_overall", "loss_bce", "loss_neg_bce", "loss_adapter", "grad_norm")
LIMITS = {"losses": 2e-3, "grad_norm": 2e-3, "weights": 5e-4, "update": 1e-3}


def fixture_config(g: dict):
    """The fixture's geometry: a 64x64 map at hidden 64, 48-d tokens."""
    from cone_tpu_torch.config import TanConfig, TrainConfig

    tan = TanConfig(num_clips=64, hidden_size=64, v_feat_dim=64, t_feat_dim=48,
                    txt_hidden_size=64, map_hidden_sizes=(64, 64, 64, 64),
                    temperature=float(g["temperature"]))
    return tan, TrainConfig(lr=float(g["lr"]), wd=float(g["wd"]))


def fixture_batch(g: dict, num_clips: int) -> dict:
    """The fixture's batch as the loader would give it: GT spans in clips
    become normalized (center, width) labels over a window of num_clips."""
    spans = np.asarray(g["gt_spans"], np.float64)
    c = (spans[:, 0] + spans[:, 1]) / 2 / num_clips
    w = (spans[:, 1] - spans[:, 0]) / num_clips
    return {
        "query_tokens": g["tok"], "query_mask": g["tok_mask"],
        "pos_motion": g["vis"], "neg_motion": g["neg_vis"],
        "span_labels": np.stack([c, w], -1)[:, None, :].astype(np.float32),
        "video_length": np.full(len(spans), num_clips, np.int32),
        "query_cls": g["cls_txt"], "pos_appear": g["vid_appear"],
        "prop_start": g["prop_start"], "prop_end": g["prop_end"],
    }


def replay(g: dict, device="cuda"):
    """The fixture's steps through make_tan_train_step on `device`; returns
    (per-step metrics as floats, final state dict on the host)."""
    from cone_tpu_torch.convert import load_reference_tan_state_dict
    from cone_tpu_torch.models.tan import ConeTanModel
    from cone_tpu_torch.train.optim import make_tan_optimizer
    from cone_tpu_torch.train.step import to_floats
    from cone_tpu_torch.train.tan_step import make_tan_train_step

    tan, tcfg = fixture_config(g)
    model = ConeTanModel(tan, device=device)
    model.load_state_dict(load_reference_tan_state_dict(
        {k[len("w0::"):]: v for k, v in g.items() if k.startswith("w0::")}))
    opt, _ = make_tan_optimizer(model, tcfg)
    step = make_tan_train_step(model, opt, tan, use_neg_loss=True,
                               adapter_loss_coef=float(g["adapter_w"]))
    batch = fixture_batch(g, tan.num_clips)
    steps = [to_floats(step(batch, True)) for _ in range(int(g["n_steps"]))]
    return steps, {k: v.cpu().numpy() for k, v in model.state_dict().items()}


def worst_errors(g: dict, steps, final) -> dict:
    """The worst error of each quantity in the units of LIMITS, with the
    parameters that have the worst weight and update differences."""
    from cone_tpu_torch.convert import load_reference_tan_state_dict

    out = {"losses": 0.0, "grad_norm": 0.0, "weights": 0.0, "worst_weight": "",
           "update": 0.0, "worst_update": ""}
    for i, m in enumerate(steps):
        for key in KEYS:
            ref = float(g[f"step{i}_{key}"])
            err = abs(m[key] - ref) / max(1.0, abs(ref))
            unit = "grad_norm" if key == "grad_norm" else "losses"
            out[unit] = max(out[unit], err)
    want, start = ({k: v.numpy() for k, v in load_reference_tan_state_dict(
        {k[len(p):]: v for k, v in g.items() if k.startswith(p)}).items()}
        for p in ("w::", "w0::"))
    if set(want) != set(final):
        raise ValueError(f"weights differ in names: {sorted(set(want) ^ set(final))}")
    for k, v in want.items():
        diff = float(np.abs(final[k] - v).max())
        if diff > out["weights"]:
            out["weights"], out["worst_weight"] = diff, k
        upd_ref = v - start[k]
        rel = float(np.linalg.norm(final[k] - v) / max(np.linalg.norm(upd_ref), 1e-30))
        if rel > out["update"]:
            out["update"], out["worst_update"] = rel, k
    return out


def check(device="cuda", path: str = FIXTURE) -> dict:
    """Replay and compare; raises beyond LIMITS, returns the worst errors."""
    g = dict(np.load(path).items())
    worst = worst_errors(g, *replay(g, device))
    bad = [k for k in LIMITS if worst[k] >= LIMITS[k]]
    if bad:
        raise RuntimeError(f"golden TAN training trajectory beyond its limits in {bad}: {worst}")
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from cone_tpu_torch.utils.device import resolve_device

    print(check(str(resolve_device(args.device))))


if __name__ == "__main__":
    main()
