"""Model construction and evaluation (the read side of cone/train.py:
eval every N epochs = inference + recall tables). The training loop itself
is not ported yet.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from cone_tpu_torch.config import ConeConfig
from cone_tpu_torch.data.dataset import GroundingDataset
from cone_tpu_torch.eval.metrics import (
    display_recall_table,
    display_window_results,
    evaluate_recall_table,
    evaluate_window_ranklists,
    mean_first_iou,
)
from cone_tpu_torch.eval.pipeline import make_pipeline
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.utils.device import resolve_device


def _stop_score(recall_table, dset_name: str) -> float:
    """recall_table is (topK, thresholds) with topK=[1,5,...] rows; the
    early-stopping score is the mean of the R@1 row for both datasets
    (cone/train.py:175-178)."""
    del dset_name
    return float(np.mean(recall_table[0]))


def build_family(cfg: ConeConfig, seed: int, device="cuda"):
    """A freshly initialised model of the configured family on `device`.
    The initialisation draws from `seed` and leaves the global generators
    untouched."""
    if cfg.model.model_family == "tan":
        raise NotImplementedError(
            "the 2D-TAN family is not ported yet: ROADMAP Queue 1 item 10")
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        return ConeModel(cfg.model, device=dev)


def evaluate(model, eval_ds: GroundingDataset, cfg: ConeConfig,
             host_postproc: bool = True, fused: bool = False, device="cuda"):
    """Run inference + metrics on a flat-jsonl-style GT (the dataset's own
    examples). Returns a dict with the submissions and ranklists, the recall
    table per modality, the window recall and their printable tables."""
    if cfg.train.debug:
        # smoke mode: one query chunk end to end (the GT below comes from the
        # same truncated example list, so the tables stay consistent)
        eval_ds = copy.copy(eval_ds)
        eval_ds.examples = eval_ds.examples[: max(cfg.eval.query_chunk, 8)]
    pipe = make_pipeline(model, eval_ds, cfg, device=device)
    subs, ranklists = pipe.run(host_postproc=host_postproc and not fused, fused=fused)
    gt = [dict(query_id=e.query_id, timestamps=e.timestamps) for e in eval_ds.examples]
    if cfg.data.dset_name == "mad":
        thresholds, topk = [0.1, 0.3, 0.5], [1, 5, 10, 50, 100]
        window_topk = [1, 5, 10, 30, 50, 100, 200]
    else:
        thresholds, topk = [0.3, 0.5], [1, 5, 10, 50, 100]
        window_topk = [1, 5, 10, 30, 50]

    out = {"submissions": subs, "ranklists": ranklists, "tables": {}}
    out["window_recall"] = evaluate_window_ranklists(
        ranklists, gt, window_topk, cfg.data.clip_length, cfg.data.max_v_l)
    out["tables"]["window"] = display_window_results(
        out["window_recall"], window_topk, title="Window Pre-filtering")
    # ego4d evals also report mIoU of the first prediction alongside recall
    # (cone/inference.py:440-444 via evaluate_ego4d_nlq.py:95-117)
    with_miou = cfg.data.dset_name != "mad"
    for name in subs:
        rec = evaluate_recall_table(subs[name], gt, thresholds, topk)
        out[f"recall_{name}"] = rec
        miou = mean_first_iou(subs[name], gt) if with_miou else None
        if miou is not None:
            out[f"miou_{name}"] = miou
        out["tables"][name] = display_recall_table(
            rec, thresholds, topk, title=name.capitalize(), mIoU=miou)
    # eval_modality selects which score variant drives early stopping
    # (cone/config.py:123, inference.py:479-493); "clip" is the value the
    # reference's own dispatch checks for the matching modality
    modality = {"both": "fusion", "proposal": "proposal",
                "matching": "matching", "clip": "matching"}[cfg.eval.eval_modality]
    primary = (f"recall_{modality}" if f"recall_{modality}" in out
               else f"recall_{list(subs)[0]}")
    out["stop_score"] = _stop_score(out[primary], cfg.data.dset_name)
    return out
