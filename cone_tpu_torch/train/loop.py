"""The training loop (cone/train.py:122-229): epochs of train steps,
evaluation every `eval_epoch_interval` epochs through the inference
pipeline, early stopping, best/latest/periodic checkpoints, per-stage
timing meters and the jsonl metrics log. Also model construction and
evaluation, which the inference entry points share.

The stop score is the mean of the R@1 row, at IoU {0.3, 0.5} for Ego4D and
{0.1, 0.3, 0.5} for MAD (cone/train.py:174-179).

Both families: CONE (AdamW with a step lr decay, train/step.py) and
2D-TAN (Adam with a plateau-controlled lr, train/tan_step.py), picked by
model.model_family. One process on one device, or data parallel over the
ranks of an initialized torch.distributed group (parallel/distributed.py):
each rank trains on its row block of every global batch with the global
batch's loss, evaluates its strided share of the videos and gathers the
rows, so every rank holds the same weights, metrics and early-stop state.
Not ported yet, each raising where it would be asked for: tensor parallel
training (ROADMAP Queue 1 item 11) and the multiscale loader (item 14,
CONE-only). `train.rng_impl` chooses a JAX PRNG and has no counterpart
here: dropout masks are drawn for the global batch from a generator the
train step seeds per step from (train.seed, global step), and each rank
keeps its rows (models/dropout.py), as cone_tpu draws every row's mask
from one global key; so a data-parallel run equals a single-process one
with dropout on.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import subprocess
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from cone_tpu_torch.config import ConeConfig, check_tan_geometry
from cone_tpu_torch.data.dataset import GroundingDataset, TrainLoader
from cone_tpu_torch.data.prefetch import prefetch_iterator
from cone_tpu_torch.eval.metrics import (
    display_recall_table,
    display_window_results,
    evaluate_recall_table,
    evaluate_window_ranklists,
    mean_first_iou,
)
from cone_tpu_torch.eval.pipeline import make_pipeline
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.models.tan import ConeTanModel
from cone_tpu_torch.parallel import distributed
from cone_tpu_torch.parallel.mesh import row_block, tp_size
from cone_tpu_torch.train.checkpoint import CheckpointManager, load_params
from cone_tpu_torch.train.optim import make_optimizer, make_tan_optimizer
from cone_tpu_torch.train.step import (
    batch_to_device,
    make_eval_loss_step,
    make_train_step,
    to_floats,
)
from cone_tpu_torch.train.tan_step import make_tan_eval_loss_step, make_tan_train_step
from cone_tpu_torch.utils.device import resolve_device
from cone_tpu_torch.utils.io import AverageMeter, save_jsonl
from cone_tpu_torch.utils.logging import MetricLogger


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
    dev = resolve_device(device)
    tan = cfg.model.model_family == "tan"
    if tan:
        check_tan_geometry(cfg.tan, cfg.data.max_v_l)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        return ConeTanModel(cfg.tan, device=dev) if tan else ConeModel(cfg.model, device=dev)


def evaluate(model, eval_ds: GroundingDataset, cfg: ConeConfig,
             host_postproc: bool = True, fused: bool = False, device="cuda"):
    """Run inference + metrics on a flat-jsonl-style GT (the dataset's own
    examples). Returns a dict with the submissions and ranklists, the recall
    table per modality, the window recall and their printable tables. The
    model runs in eval mode and is handed back in the mode it came in.

    In a process group the videos shard by rank (strided over the sorted
    clip ids), each rank grounds its own, and the submission rows and
    ranklists are gathered, so every rank returns the full table
    (cone_tpu/train/loop.py:110-131)."""
    if cfg.train.debug:
        # smoke mode: one query chunk end to end (the GT below comes from the
        # same truncated example list, so the tables stay consistent)
        eval_ds = copy.copy(eval_ds)
        eval_ds.examples = eval_ds.examples[: max(cfg.eval.query_chunk, 8)]
    device = resolve_device(device)
    mine = set(distributed.shard_by_process(sorted({e.clip_id for e in eval_ds.examples})))
    ds_local = copy.copy(eval_ds)
    ds_local.examples = [e for e in eval_ds.examples if e.clip_id in mine]
    subs, ranklists = {}, {}
    was_training = model.training
    try:
        if ds_local.examples:   # a rank may hold no video when ranks outnumber them
            pipe = make_pipeline(model, ds_local, cfg, device=device)
            subs, ranklists = pipe.run(host_postproc=host_postproc and not fused, fused=fused)
    finally:
        model.train(was_training)
    parts = distributed.all_gather_obj((subs, ranklists))
    if len(parts) > 1:
        subs = {name: [r for p in parts for r in p[0].get(name, [])]
                for name in dict.fromkeys(n for p in parts for n in p[0])}
        ranklists = {q: r for p in parts for q, r in p[1].items()}
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


def eval_criterion_losses(eval_loss_fn, eval_ds: GroundingDataset, cfg: ConeConfig,
                          adapter_on: bool) -> dict:
    """Criterion terms on the eval split: the windowed batches the train
    step consumes, sampled with a fixed seed (seed, epoch 0) so every eval
    scores the same windows and the curves compare across epochs (the
    reference's eval-loss channel, cone/inference.py:30-36, 96-98). In a
    process group each rank builds its row block of every batch and the
    step returns the global batch's terms: the batches are the single
    run's, so their size must divide by the ranks (row_block raises)."""
    bsz = _eval_loss_bsz(cfg, eval_ds)
    if bsz == 0:
        return {}
    lo, hi = row_block(bsz, distributed.rank(), distributed.world_size())
    batches = TrainLoader(eval_ds, bsz=bsz, seed=cfg.train.seed).epoch(0, lo, hi)
    if cfg.train.debug:
        batches = itertools.islice(batches, 2)
    meters = defaultdict(AverageMeter)
    for batch in batches:
        for k, v in to_floats(eval_loss_fn(batch, adapter_on)).items():
            meters[k].update(v)
    return {k: m.avg for k, m in meters.items()}


def _eval_loss_bsz(cfg: ConeConfig, eval_ds: GroundingDataset) -> int:
    return min(cfg.train.bsz, len(eval_ds))


def _snapshot_code_version(workdir: str) -> None:
    """Provenance: the commit and the uncommitted diff of the code that ran
    (the reference zips its source tree per run, cone/config.py:205-211).
    Best effort: nothing is written where git or the repository is missing."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                              capture_output=True, text=True, timeout=10)
        diff = subprocess.run(["git", "diff", "HEAD"], cwd=root,
                              capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return
    if head.returncode != 0:
        return
    with open(os.path.join(workdir, "code_version.txt"), "w") as f:
        f.write(head.stdout)
        if diff.stdout:
            f.write("\n--- uncommitted diff ---\n")
            f.write(diff.stdout)


def device_seconds(events) -> float:
    """Device time summed over the CUDA events of a torch.profiler run's
    key_averages(), without the spans of user annotations (such as the
    optimizer's step range), which would count their kernels twice."""
    total = 0.0
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            t = getattr(e, "self_device_time_total", None)
            total += e.self_cuda_time_total if t is None else t
    return total / 1e6


def check_supported(cfg: ConeConfig) -> None:
    """Raise for a configuration the port cannot train, before any work."""
    if cfg.model.model_family == "tan":
        check_tan_geometry(cfg.tan, cfg.data.max_v_l)
    if cfg.train.multiscale and cfg.model.model_family == "tan":
        raise ValueError("train.multiscale is CONE-only")
    if cfg.train.multiscale:
        raise NotImplementedError(
            "train.multiscale (the multiscale loader) is not ported yet: "
            "ROADMAP Queue 1 item 14")
    tp_size(cfg.train.tp_devices)


def train(cfg: ConeConfig, train_ds: GroundingDataset, eval_ds: Optional[GroundingDataset],
          workdir: str, profile: bool = False, init_ckpt: Optional[str] = None,
          device="cuda", tensorboard: bool = False):
    """Train a model of the configured family on one device, or data
    parallel over the initialized process group (module docstring; the
    caller passes the rank's device); returns (model, history), one record
    per epoch, the same on every rank.

    A workdir that holds a `latest` checkpoint resumes from it: weights,
    optimizer and lr schedule (the TAN plateau controller's best score and
    bad-eval count, from the checkpoint's extra state), epoch and the
    early-stop counters.
    init_ckpt: weights-only warm start from a reference-named torch file
    (the reference's --resume without --resume_all, cone/config.py:63-66),
    ignored when the run resumes. profile: trace the first epoch with
    torch.profiler into <workdir>/profile (rank 0). Dropout draws from the
    train step's generator (train/step.py); torch's global generator is
    seeded with train.seed on every rank for the run, and the caller's
    generators are left as they were. A data-parallel run needs a workdir
    every rank shares."""
    check_supported(cfg)
    dev = resolve_device(device)
    rank, world = distributed.rank(), distributed.world_size()
    lo, hi = row_block(cfg.train.bsz, rank, world)
    reduce = distributed.batch_reduce()
    os.makedirs(workdir, exist_ok=True)
    ckpt = CheckpointManager(workdir, cfg)
    logger = MetricLogger(workdir, tensorboard=tensorboard)
    if distributed.is_main():
        _snapshot_code_version(workdir)
    logger.log_hparams(json.loads(cfg.to_json()),
                       parallel={"world_size": world, "backend": distributed.backend()})

    model = build_family(cfg, seed=cfg.train.seed, device=dev)
    if init_ckpt and not ckpt.exists("latest"):
        load_params(init_ckpt, model)
        print(f"warm start: weights from {init_ckpt}")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.model.model_family}, {n_params:,} parameters on {dev}"
          + (f", rank {rank} of {world} ({distributed.backend()})"
             if distributed.backend() else ""))
    loader = TrainLoader(train_ds, bsz=cfg.train.bsz, seed=cfg.train.seed)
    if loader.steps_per_epoch() == 0:
        raise ValueError(f"{len(train_ds)} training examples make no batch of {cfg.train.bsz}")
    tan = cfg.model.model_family == "tan"
    plateau = None
    if tan:
        # Adam + ReduceLROnPlateau on the stop score
        # (cone_2dtan/moment_localization/train.py:143-147)
        optimizer, plateau = make_tan_optimizer(model, cfg.train)
        scheduler = None   # the plateau's state travels in `extra`, as cone_tpu's does
        step_fn = make_tan_train_step(model, optimizer, cfg.tan, cfg.loss.neg_loss,
                                      cfg.loss.adapter_loss_coef, reduce)
    else:
        optimizer, scheduler = make_optimizer(model, cfg.train, loader.steps_per_epoch())
        step_fn = make_train_step(model, optimizer, scheduler, cfg, reduce)
    eval_loss_fn = None
    if eval_ds is not None and cfg.eval.criterion_losses:
        eval_loss_fn = (make_tan_eval_loss_step(model, cfg.tan, cfg.loss.neg_loss,
                                                cfg.loss.adapter_loss_coef, reduce)
                        if tan else make_eval_loss_step(model, cfg, reduce))
        n_eval = _eval_loss_bsz(cfg, eval_ds)
        if n_eval % world:   # refused before any work, not at the first eval epoch
            raise ValueError(f"the eval-loss batch, min(train.bsz, eval examples) = {n_eval}, "
                             f"must divide by the {world} ranks")

    start_epoch, best_score, es_cnt = 0, 0.0, 0
    distributed.assert_same_across_processes(
        float(ckpt.exists("latest")),
        "resume state (a data-parallel run needs a workdir every rank shares)")
    if ckpt.exists("latest"):
        epoch, extra = ckpt.restore("latest", model, optimizer, scheduler)
        start_epoch = epoch + 1
        best_score = extra.get("best_score", 0.0)
        es_cnt = int(extra.get("es_cnt", 0))
        if plateau is not None:   # its lr came back with the optimizer's state
            plateau.best = extra["plateau_best"]
            plateau.num_bad_epochs = int(extra["plateau_num_bad"])
        print(f"resumed from epoch {start_epoch}")
    if world > 1:   # every rank built the same model from the same seed and files
        distributed.assert_same_across_processes(
            sum(float(p.detach().abs().sum()) for p in model.parameters()), "initial weights")

    def save(tag, epoch):
        extra = {"best_score": best_score, "es_cnt": es_cnt}
        if plateau is not None:
            extra.update(plateau_best=plateau.best, plateau_num_bad=plateau.num_bad_epochs)
        ckpt.save(tag, model, optimizer, scheduler, epoch, extra=extra)

    history = []
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(cfg.train.seed)
        for epoch in range(start_epoch, cfg.train.n_epoch):
            distributed.barrier(f"epoch {epoch}")
            meters = defaultdict(AverageMeter)
            loss_meters = defaultdict(AverageMeter)
            adapter_on = cfg.loss.adapter_loss and epoch >= cfg.train.start_epoch_for_adapter
            batches = loader.epoch(epoch, lo, hi)
            if cfg.train.debug:
                batches = itertools.islice(batches, 3)
            prof = None
            if profile and epoch == start_epoch and distributed.is_main():
                acts = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            t_epoch = t_load = time.time()
            step_times = []
            # batches are sampled and copied to the device on a background
            # thread while the step before runs
            for batch in prefetch_iterator(batch_to_device(b, dev) for b in batches):
                meters["dataloading_time"].update(time.time() - t_load)
                t0 = time.time()
                metrics = to_floats(step_fn(batch, adapter_on))  # waits for the step
                step_times.append(time.time() - t0)
                meters["step_time"].update(step_times[-1])
                for k, v in metrics.items():
                    loss_meters[k].update(v)
                t_load = time.time()
            epoch_log = {"epoch": epoch + 1,
                         **{k: m.avg for k, m in loss_meters.items()},
                         **{k: m.avg for k, m in meters.items()}}
            if prof is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                wall = time.time() - t_epoch
                prof.stop()
                os.makedirs(os.path.join(workdir, "profile"), exist_ok=True)
                prof.export_chrome_trace(os.path.join(workdir, "profile", "trace.json"))
                print(f"profiled epoch {epoch + 1}: wall {wall:.4f} s (profiler on), trace in "
                      f"{os.path.join(workdir, 'profile')}")
                if dev.type == "cuda":
                    busy = device_seconds(prof.key_averages())
                    epoch_log["profile_device_s"] = busy
                    epoch_log["profile_wall_s"] = wall
                    print(f"device time {busy:.4f} s, busy share {busy / wall:.4f}")
            logger.log_train_epoch(epoch_log)
            epoch_log["step_times"] = step_times
            history.append(epoch_log)

            if eval_ds is not None and (epoch + 1) % cfg.train.eval_epoch_interval == 0:
                t0 = time.time()
                # eval.fused_train_eval picks the fused device path over the
                # staged one with the reference-exact host post-processing
                fused = cfg.eval.fused_train_eval
                res = evaluate(model, eval_ds, cfg, host_postproc=not fused, fused=fused,
                               device=dev)
                score = res["stop_score"]
                distributed.assert_same_across_processes(score, "stop score")
                eval_losses = None
                if eval_loss_fn is not None:
                    eval_losses = eval_criterion_losses(eval_loss_fn, eval_ds, cfg, adapter_on)
                    epoch_log.update({f"eval_{k}": v for k, v in eval_losses.items()})
                lr_now = None
                if plateau is not None:
                    plateau.step(score)
                    lr_now = epoch_log["lr"] = optimizer.param_groups[0]["lr"]
                    distributed.assert_same_across_processes(lr_now, "plateau lr")
                epoch_log["eval_seconds"] = time.time() - t0
                for t in res["tables"].values():
                    logger.log_text(t)
                logger.log_eval(epoch + 1, score, lr=lr_now, losses=eval_losses)
                if distributed.is_main():
                    save_jsonl(res["submissions"]["fusion"],
                               os.path.join(workdir, "latest_preds.jsonl"))
                if score > best_score:
                    best_score, es_cnt = score, 0
                    save("best", epoch)
                    if distributed.is_main():
                        save_jsonl(res["submissions"]["fusion"],
                                   os.path.join(workdir, "best_preds.jsonl"))
                else:
                    es_cnt += 1
                    if cfg.train.max_es_cnt != -1 and es_cnt > cfg.train.max_es_cnt:
                        logger.log_text(f"Early stop at epoch {epoch}")
                        break
                save("latest", epoch)

            if (epoch + 1) % cfg.train.save_interval == 0 or (epoch + 1) % cfg.train.lr_drop == 0:
                save(f"e{epoch:04d}", epoch)
    logger.close()
    return model, history
