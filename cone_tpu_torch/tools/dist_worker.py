"""One rank of a data-parallel run: train, evaluate, search the sharded
library, dump a JSON summary (the port's counterpart of
tests/dist_worker.py).

    python -m cone_tpu_torch.tools.dist_worker --out PREFIX --width narrow \\
        --device cpu --coordinator 127.0.0.1:PORT --num_processes 2 --process_id I

writes PREFIX.<rank>.json; the ranks share the training workdir
PREFIX.workdir. Without --coordinator it runs as one process with
no group: the single-process run the ranks are held to (`run()` is that
run when called in-process). Every rank:

  1. trains (train/loop.train) on its row block of each global batch, 2
     epochs with an eval epoch through the sharded evaluate;
  2. evaluates the trained model (fused, videos sharded by rank, rows and
     ranklists gathered), with the plain coarse stage's window scores of
     every query, so that a differing ranklist can be told from a near-tie;
  3. searches a corpus library sharded by rank (CorpusRetriever over the
     rank's strided share of the videos, fresh seeded weights);
  4. at the narrow width, one 2D-TAN train step on its row block.

With --tp K (train.tp_devices, a world of a multiple of K ranks) the ranks
train on the (world / K, K) grid of tensor parallelism and steps 3-4 are
left out (the library and 2D-TAN have nothing to shard). With --multiscale
step 1 trains one epoch of the ECCV'22 multiscale recipe, adapter on, and
steps 3-4 are left out.

    python -m cone_tpu_torch.tools.dist_worker --out PREFIX --steps N \
        [--config CFG.json] [--init W.pt] ...

runs N train steps (train/step.make_train_step on the batches of epochs
0, 1, ..., adapter on; the multiscale loader's under train.multiscale) on
this rank's cell of the grid of the config's train.tp_devices instead
(`train_steps`): per-step metrics, the final
weights gathered to full tensors (rank 0 writes PREFIX.state.pt), the
shard shapes of the weights and of AdamW's moments, whether the gathered
state shards back to this rank's bit for bit, and the tp all-reduces of a
step with their bytes and ms.

Widths: "narrow" is tests/dist_worker_cfg.py's problem (hidden 64, 4 videos
x 4 queries, bsz 8); "ego4d" is the Ego4D preset's full width (hidden 256,
8 heads, 2+2 layers, FFN 1024, 256-d features) at bsz 32 over 8 videos x 8
queries of 1 500-2 304 clips. Both train with the preset's dropouts (0.1,
input 0.5): the masks are drawn for the global batch and each rank keeps
its rows (models/dropout.py), so the ranks take the single run's steps.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from cone_tpu_torch.config import (
    ConeConfig, DataConfig, EvalConfig, ModelConfig, TanConfig, TrainConfig, ego4d_config,
)
from cone_tpu_torch.data import TrainLoader, make_synthetic_dataset
from cone_tpu_torch.data.multiscale import MultiscaleTrainLoader
from cone_tpu_torch.parallel import distributed

N_CORPUS_QUERIES = 6


def problem(width: str, cfg: ConeConfig = None):
    """(cfg, dataset) of a width, the dataset made for `cfg` when given (a
    config of the same feature widths); the same on every rank."""
    if width == "narrow":
        dim = 32
        cfg = cfg or ConeConfig(
            model=ModelConfig(hidden_dim=64, nheads=4, dim_feedforward=128, t_feat_dim=dim,
                              v_motion_feat_dim=dim, v_appear_feat_dim=dim, max_q_l=8,
                              max_v_l=32),
            data=DataConfig(dset_name="synthetic", max_v_l=32, max_q_l=8, clip_length=1.0,
                            topk_window=5, max_ctx_l=256, max_windows=5),
            train=TrainConfig(bsz=8, n_epoch=2, eval_epoch_interval=2, lr=3e-4,
                              start_epoch_for_adapter=1, save_interval=100),
            eval=EvalConfig(query_chunk=4, use_pallas_coarse=True))
        return cfg, make_synthetic_dataset(cfg.data, n_videos=4, queries_per_video=4,
                                           ctx_l_range=(100, 200), dim=dim, signal=3.0,
                                           seed=7)
    assert width == "ego4d", width
    if cfg is None:
        cfg = ego4d_config()
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, dset_name="synthetic"),
            train=dataclasses.replace(cfg.train, bsz=32, n_epoch=2, eval_epoch_interval=2,
                                      start_epoch_for_adapter=1),
            eval=dataclasses.replace(cfg.eval, use_pallas_coarse=True))
    return cfg, make_synthetic_dataset(cfg.data, n_videos=8, queries_per_video=8,
                                       ctx_l_range=(1500, 2305),
                                       dim=cfg.model.v_appear_feat_dim, signal=3.0, seed=1)


def tan_problem():
    """A 2D-TAN geometry small enough for the CPU (tests/test_tan_loop.py's:
    a 32x32 map, hidden 48) and one global batch of 8."""
    dim, nc = 32, 32
    cfg = ConeConfig(
        model=ModelConfig(model_family="tan", t_feat_dim=dim, v_appear_feat_dim=dim,
                          v_motion_feat_dim=dim, max_q_l=8, max_v_l=nc),
        tan=TanConfig(num_clips=nc, hidden_size=48, v_feat_dim=dim, t_feat_dim=dim,
                      txt_hidden_size=48, lstm_layers=2, num_scale_layers=(8, 4),
                      map_hidden_sizes=(48, 48), map_kernel_sizes=(5, 5), map_paddings=(4, 0),
                      proposal_top_k=5),
        data=DataConfig(dset_name="synthetic", max_v_l=nc, max_q_l=8, clip_length=1.0,
                        topk_window=4, max_ctx_l=256),
        train=TrainConfig(bsz=8, lr=3e-4, wd=1e-4))
    ds = make_synthetic_dataset(cfg.data, n_videos=4, queries_per_video=4, ctx_l_range=(90, 180),
                                dim=dim, signal=3.0, seed=9)
    return cfg, ds


def tan_step(device) -> dict:
    """One 2D-TAN train step (adapter on) on this rank's rows of one batch."""
    from cone_tpu_torch.convert import load_reference_tan_state_dict, random_reference_tan_state_dict
    from cone_tpu_torch.models.tan import ConeTanModel
    from cone_tpu_torch.parallel.mesh import row_block
    from cone_tpu_torch.train.optim import make_tan_optimizer
    from cone_tpu_torch.train.step import to_floats
    from cone_tpu_torch.train.tan_step import make_tan_train_step

    cfg, ds = tan_problem()
    model = ConeTanModel(cfg.tan, device=device)
    model.load_state_dict(load_reference_tan_state_dict(
        random_reference_tan_state_dict(cfg.tan, seed=5)))
    w0 = [p.detach().clone() for p in model.parameters()]
    opt, _ = make_tan_optimizer(model, cfg.train)
    step = make_tan_train_step(model, opt, cfg.tan, adapter_loss_coef=0.1,
                               reduce=distributed.batch_reduce())
    lo, hi = row_block(cfg.train.bsz, distributed.rank(), distributed.world_size())
    batch = next(TrainLoader(ds, bsz=cfg.train.bsz, seed=0).epoch(0, lo, hi))
    out = to_floats(step(batch, True))
    out["param_sum"] = param_sum(model)
    out["update_abs_sum"] = float(sum((p.detach() - w).abs().sum()
                                      for p, w in zip(model.parameters(), w0)))
    return out


def param_sum(model) -> float:
    return float(sum(p.detach().abs().sum().double() for p in model.parameters()))


def window_scores(model, cfg, ds, device) -> dict:
    """{query_id: window scores in window order} of this rank's videos, from
    the plain coarse stage (kernel off), for telling near-ties apart."""
    from cone_tpu_torch.eval.pipeline import InferencePipeline

    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, use_pallas_coarse=False))
    mine = set(distributed.shard_by_process(sorted(ds.video_ids)))
    pipe = InferencePipeline(model, ds, cfg, device=device)
    out = {e.query_id: video_window_scores(pipe, e.clip_id, ds.query_features(e.query_id)[1])
           .tolist() for e in ds.examples if e.clip_id in mine}
    return {q: s for part in distributed.all_gather_obj(out) for q, s in part.items()}


@torch.inference_mode()
def video_window_scores(pipe, clip_id: str, cls: np.ndarray) -> np.ndarray:
    """One video's plain coarse window scores (the pipeline's adapter, no
    kernel) for one (D,) query CLS row, in window order."""
    from cone_tpu_torch.ops.windows import coarse_window_scores, num_windows

    appear, a_scale, _, _, ctx_l = pipe.resident.get(clip_id)
    adapted = pipe._adapt(pipe.resident.decode(appear, a_scale))[None]
    s, _ = coarse_window_scores(adapted, torch.from_numpy(cls).to(pipe.device)[None, None],
                                torch.tensor([ctx_l], device=pipe.device), pipe.stride,
                                num_windows(ctx_l, pipe.stride))
    return s[0, 0].cpu().numpy()


def dispatches(cfg, ds) -> int:
    """Coarse dispatches of this rank's share of an eval: one per (video,
    query chunk)."""
    mine = set(distributed.shard_by_process(sorted(ds.video_ids)))
    qc = cfg.eval.query_chunk
    return sum(-(-sum(e.clip_id == v for e in ds.examples) // qc) for v in mine)


def allreduce_ms(numel: int, device, iters: int = 20, all_reduce=dist.all_reduce) -> float:
    """Host ms of one all-reduce of `numel` float32 (the step's coalesced
    gradient buffer), synchronised."""
    buf = torch.ones(numel, device=device)
    for i in range(iters + 3):
        if i == 3:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        all_reduce(buf)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def tp_allreduce_cost(tensor, device) -> dict:
    """The tp all-reduces counted in `tensor.sizes` (one step's): calls,
    bytes, and the ms they take, each size timed alone over the tp group."""
    ms = sum(n * allreduce_ms(numel * size // 4, device, iters=5,
                              all_reduce=tensor._all_reduce)
             for (numel, size), n in sorted(tensor.sizes.items()))
    return {"calls": sum(tensor.sizes.values()),
            "bytes": sum(numel * size * n for (numel, size), n in tensor.sizes.items()),
            "ms": ms}


def train_steps(width: str, device, n_steps: int, cfg: ConeConfig = None,
                init: str = None, state_path: str = None) -> dict:
    """The --steps run of the module docstring on `device` under the
    initialized group, or alone with none; returns this rank's summary."""
    from cone_tpu_torch.parallel import mesh
    from cone_tpu_torch.parallel.mesh import row_block
    from cone_tpu_torch.train.checkpoint import load_params
    from cone_tpu_torch.train.loop import build_family
    from cone_tpu_torch.train.optim import make_optimizer
    from cone_tpu_torch.train.step import make_train_step, to_floats

    device = torch.device(device)
    cfg, ds = problem(width, cfg)
    reduce, tensor = distributed.grid(cfg.train.tp_devices)
    model = build_family(cfg, seed=cfg.train.seed, device=device)
    if init:
        load_params(init, model)
    local, layout = model, {}
    if tensor is not None:
        local = copy.deepcopy(model)
        layout = mesh.shard_model(local, tensor)
    loader = (MultiscaleTrainLoader if cfg.train.multiscale else TrainLoader)(
        ds, bsz=cfg.train.bsz, seed=cfg.train.seed)
    opt, sched = make_optimizer(local, cfg.train, loader.steps_per_epoch())
    step = make_train_step(local, opt, sched, cfg, reduce, tensor)
    lo, hi = row_block(cfg.train.bsz, reduce.rank, reduce.world)
    out = {"rank": distributed.rank(), "world": distributed.world_size(),
           "backend": distributed.backend(), "device": str(device),
           "tp": tensor.size if tensor else 1, "dp": reduce.world, "metrics": [],
           "step_ms": []}
    batches = itertools.chain.from_iterable(loader.epoch(e, lo, hi) for e in itertools.count())
    for batch in itertools.islice(batches, n_steps):
        if tensor is not None:
            tensor.sizes.clear()
        t0 = time.perf_counter()
        out["metrics"].append(to_floats(step(batch, True)))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    state = local.state_dict()
    if tensor is not None:
        out["tp_allreduce"] = tp_allreduce_cost(tensor, device)   # the last step's
        names = mesh.optimizer_param_names(opt, local)
        osd = opt.state_dict()
        full_osd = mesh.gather_optimizer_state(osd, names, layout, tensor)
        state = mesh.gather_state_dict(local.state_dict(), layout, tensor)
        back = mesh.shard_state_dict(state, layout, tensor.rank, tensor.size)
        back_osd = mesh.shard_optimizer_state(full_osd, names, layout, tensor.rank,
                                              tensor.size)
        out["roundtrip_exact"] = (
            all(torch.equal(back[k], v) for k, v in local.state_dict().items())
            and all(torch.equal(back_osd["state"][i][k], v) for i, s in osd["state"].items()
                    for k, v in s.items()))
        out["shard_shapes"] = {k: list(v.shape) for k, v in local.state_dict().items()
                               if k in layout}
        out["moment_shapes"] = {names[i]: [list(s["exp_avg"].shape),
                                           list(s["exp_avg_sq"].shape)]
                                for i, s in osd["state"].items() if names[i] in layout}
        out["full_moment_shapes"] = {names[i]: list(s["exp_avg"].shape)
                                     for i, s in full_osd["state"].items()
                                     if names[i] in layout}
        # tp ranks of one slot hold the same replicated weights
        rep = float(sum(v.double().abs().sum() for k, v in local.state_dict().items()
                        if k not in layout))
        distributed.assert_same_across_processes(rep, "replicated weights")
    out["param_sum"] = float(sum(v.double().abs().sum() for v in state.values()))
    if state_path and distributed.is_main():
        torch.save({k: v.detach().cpu() for k, v in state.items()}, state_path)
    return out


def run(width: str, device, workdir: str, tp: int = 1, multiscale: bool = False) -> dict:
    """Steps 1-4 of the module docstring on `device` under the initialized
    group, or alone with none, on the grid of `tp`; returns this rank's
    summary. `multiscale`: `train` takes the ECCV'22 multiscale loader for
    one epoch with the adapter on (an eval epoch at its end), then steps 1-2
    only."""
    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.serve.corpus import CorpusRetriever
    from cone_tpu_torch.train.loop import build_family, evaluate, train

    device = torch.device(device)
    cfg, ds = problem(width)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, tp_devices=tp))
    if multiscale:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, multiscale=True, n_epoch=1, eval_epoch_interval=1,
            start_epoch_for_adapter=0))
    out = {"rank": distributed.rank(), "world": distributed.world_size(),
           "backend": distributed.backend(), "device": str(device), "tp": tp,
           "dispatches": dispatches(cfg, ds)}

    co.coarse_segment_max.launches = 0
    t0 = time.perf_counter()
    model, history = train(cfg, ds, ds, workdir, device=device)
    out["train_s"] = time.perf_counter() - t0
    out["train_launches"] = co.coarse_segment_max.launches
    out["losses"] = [h["loss_overall"] for h in history]
    out["terms"] = [{k: v for k, v in h.items() if k.startswith(("loss", "eval_loss"))}
                    for h in history]
    out["grad_norms"] = [h["grad_norm"] for h in history]
    out["step_ms"] = [t * 1e3 for h in history for t in h["step_times"]]
    out["param_sum"] = param_sum(model)
    if distributed.backend() and tp == 1 and not multiscale:
        # the gradients the last step all-reduced: a parameter with none (the
        # unused text position table) takes a zero one after the all-reduce
        numel = sum(p.numel() for p in model.parameters()
                    if p.grad is not None and bool(p.grad.any()))
        out["allreduce_bytes"] = 4 * numel
        out["allreduce_ms"] = allreduce_ms(numel, device)

    co.coarse_segment_max.launches = 0
    res = evaluate(model, ds, cfg, host_postproc=False, fused=True, device=device)
    out["eval_launches"] = co.coarse_segment_max.launches
    out["eval_stop_score"] = res["stop_score"]
    out["rows"] = {m: {r["query_id"]: r["predicted_times"] for r in rows}
                   for m, rows in res["submissions"].items()}
    out["ranklists"] = res["ranklists"]
    out["window_scores"] = window_scores(model, cfg, ds, device)
    if tp > 1 or multiscale:
        return out

    # the library: fresh seeded weights, so a whole-library run needs no training
    cmodel = build_family(cfg, seed=cfg.train.seed, device=device)
    retr = CorpusRetriever(cmodel, cfg, dataset=None, fine_chunk=4, device=device)
    for cid in distributed.shard_by_process(sorted(ds.video_ids)):
        retr.add_video(cid, ds.video_features(cid)[0])
    toks, cls = zip(*(ds.query_features(e.query_id) for e in ds.examples[:N_CORPUS_QUERIES]))
    hits = retr.search_batch(list(toks), np.stack(cls), top_moments=5)
    out["corpus_hits"] = [[[h["video_id"], h["span"][0], h["span"][1], h["fused"]]
                           for h in per_q] for per_q in hits]
    if width == "narrow":
        out["tan"] = tan_step(device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="summary path prefix: PREFIX.<rank>.json")
    ap.add_argument("--width", choices=("narrow", "ego4d"), default="narrow")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--coordinator")
    ap.add_argument("--num_processes", type=int)
    ap.add_argument("--process_id", type=int)
    ap.add_argument("--timeout_s", type=float, default=distributed.TIMEOUT_S)
    ap.add_argument("--tp", type=int, default=1, help="train.tp_devices of the run")
    ap.add_argument("--multiscale", action="store_true",
                    help="train with train.multiscale, one epoch (run's `multiscale`)")
    ap.add_argument("--steps", type=int, default=0,
                    help="run this many train steps only (train_steps)")
    ap.add_argument("--config", help="--steps: a ConeConfig json in place of the width's")
    ap.add_argument("--init", help="--steps: initial weights (a reference-named torch file)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)   # ranks share the host's cores
    dev = torch.device(args.device)
    if args.coordinator:
        dev = distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                                     device=args.device, timeout_s=args.timeout_s)
    try:
        if args.steps:
            cfg = ConeConfig.load(args.config) if args.config else None
            out = train_steps(args.width, dev, args.steps, cfg, args.init,
                              args.out + ".state.pt")
        else:
            out = run(args.width, dev, args.out + ".workdir", args.tp,   # shared workdir
                      args.multiscale)
    finally:
        distributed.shutdown()
    with open(f"{args.out}.{out['rank']}.json", "w") as f:
        json.dump(out, f)
    print(f"rank {out['rank']} of {out['world']} ({out['backend']}): ok", flush=True)


if __name__ == "__main__":
    main()
