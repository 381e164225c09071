"""Time the CONE train step on one device and say where its time goes.

    python -m cone_tpu_torch.tools.bench_train [--bsz 32] [--steps 20] [--device cuda]

At the Ego4D preset's full width (random weights from the seed, dropout
on, the adapter on), on batches of a planted-signal synthetic set copied
to the device beforehand, so the loader is out of the measurement:
  1. the step as `train` runs it (make_train_step, its metrics read back to
     the host): host-clock ms per step, median over --steps, with the
     batches staged beforehand and with the loader sampling and copying
     them on a background thread meanwhile, as `train` does;
  2. the same work cut into phases, each ended by a synchronize: the two
     forwards, the criterion (matchers included), the backward, the clip,
     the AdamW update with the lr schedule;
  3. torch.profiler over --steps steps: device time per step and its share
     of the wall, kernel launches per step, and the ops with the most host
     time and the kernels with the most device time;
  4. utils/perf.train_perf_report on the pre-staged step time: FLOPs a
     sample, samples/s and the MFU against the card's peak for the preset's
     compute dtype.
Ends with one JSON line of the numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time

import numpy as np
import torch


def run(bsz: int = 32, steps: int = 20, device="cuda", seed: int = 0) -> dict:
    from cone_tpu_torch.config import ego4d_config
    from cone_tpu_torch.data import TrainLoader, make_synthetic_dataset
    from cone_tpu_torch.data.prefetch import prefetch_iterator
    from cone_tpu_torch.models.losses import compute_losses, loss_weight_dict, total_loss
    from cone_tpu_torch.ops.pooling import matching_embeds_gt
    from cone_tpu_torch.train.loop import build_family, device_seconds
    from cone_tpu_torch.train.optim import make_optimizer
    from cone_tpu_torch.train.step import batch_to_device, make_train_step, to_floats
    from cone_tpu_torch.utils.device import resolve_device
    from cone_tpu_torch.utils.perf import device_fence, train_perf_report

    dev = resolve_device(device)
    cfg = ego4d_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, bsz=bsz))
    ds = make_synthetic_dataset(cfg.data, n_videos=8, queries_per_video=max(4, bsz // 2),
                                ctx_l_range=(1500, 2305), dim=cfg.model.v_appear_feat_dim,
                                signal=3.0, seed=seed)
    loader = TrainLoader(ds, bsz=bsz, seed=seed)
    batches = [batch_to_device(b, dev) for b in loader.epoch(0)]
    model = build_family(cfg, seed=seed, device=dev)
    opt, sched = make_optimizer(model, cfg.train, loader.steps_per_epoch())
    step = make_train_step(model, opt, sched, cfg)
    params = [p for p in model.parameters() if p.requires_grad]
    weights = loss_weight_dict(cfg.loss, cfg.model.dec_layers)
    torch.manual_seed(seed)

    def batch(i):
        return batches[i % len(batches)]

    for i in range(3):  # warm: allocator, cuBLAS handles, AdamW state
        to_floats(step(batch(i), True))
    device_fence(dev)

    walls = []
    for i in range(steps):
        t0 = time.perf_counter()
        to_floats(step(batch(i), True))
        walls.append(time.perf_counter() - t0)

    # the same steps with the loader as `train` runs it: batches sampled and
    # copied to the device on a background thread while the step runs
    def sampled():
        for e in itertools.count():
            yield from (batch_to_device(b, dev) for b in loader.epoch(e))

    loaded = []
    it = prefetch_iterator(sampled())
    next(it)
    for _ in range(steps):
        b = next(it)
        t0 = time.perf_counter()
        to_floats(step(b, True))
        loaded.append(time.perf_counter() - t0)
    it.close()

    phases = {k: [] for k in ("forwards", "criterion", "backward", "clip", "update")}
    for i in range(steps):
        b = batch(i)
        model.train()
        t0 = time.perf_counter()
        pos = model(b["query_tokens"], b["query_mask"], b["pos_motion"], b["pos_mask"])
        neg = model(b["query_tokens"], b["query_mask"], b["neg_motion"], b["neg_mask"])
        neg["vid_mask"] = b["neg_mask"]
        pos["adapter_embeds"] = matching_embeds_gt(
            model.adapt, b["query_cls"], b["pos_appear"], b["prop_start"], b["prop_end"])
        device_fence(dev)
        t1 = time.perf_counter()
        losses = compute_losses(pos, {"span_labels": b["span_labels"],
                                      "span_mask": b["span_mask"],
                                      "saliency_pos": b["sal_pos"],
                                      "saliency_neg": b["sal_neg"]}, neg, cfg.loss)
        total = total_loss(losses, weights)
        device_fence(dev)
        t2 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        total.backward()
        device_fence(dev)
        t3 = time.perf_counter()
        torch.nn.utils.clip_grad_norm_(params, cfg.train.grad_clip)
        device_fence(dev)
        t4 = time.perf_counter()
        opt.step()
        sched.step()
        device_fence(dev)
        t5 = time.perf_counter()
        for k, a, z in zip(phases, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
            phases[k].append(z - a)

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            to_floats(step(batch(i), True))
        device_fence(dev)
        prof_wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev_evts = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]

    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t

    device_s = device_seconds(avgs)
    launches = sum(e.count for e in avgs if e.key.startswith("cudaLaunch"))
    top_host = sorted((e for e in avgs if e.key.startswith("aten::")),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    top_dev = sorted(dev_evts, key=dev_us, reverse=True)[:12]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {
        "device": name,
        "bsz": bsz, "steps": steps,
        "step_ms_median": float(np.median(walls)) * 1e3,
        "step_ms_min": float(np.min(walls)) * 1e3,
        "step_ms_median_loader_thread": float(np.median(loaded)) * 1e3,
        "phase_ms_median": {k: float(np.median(v)) * 1e3 for k, v in phases.items()},
        "profiled_wall_ms_per_step": prof_wall / steps * 1e3,
        "device_ms_per_step": device_s / steps * 1e3,
        "busy_share": device_s / prof_wall,
        "kernel_launches_per_step": launches / steps,
        "top_host_ops": [(e.key, e.count // steps, round(e.self_cpu_time_total / steps / 1e3, 3))
                         for e in top_host],
        "top_device_kernels": [(e.key[:90], e.count // steps, round(dev_us(e) / steps / 1e3, 3))
                               for e in top_dev],
    }
    if dev.type == "cuda":
        # the MFU needs the card's peaks: a CPU run has none to divide by
        out["perf"] = train_perf_report(cfg, bsz / float(np.median(walls)), chip=name)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bsz", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.bsz, args.steps, args.device)
    print(f"train step at Ego4D width, bsz {res['bsz']}, on {res['device']}: median "
          f"{res['step_ms_median']:.2f} ms (min {res['step_ms_min']:.2f}) over {res['steps']} "
          f"steps, {res['step_ms_median_loader_thread']:.2f} ms with the loader on its thread; "
          f"phases (each synchronized) "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in res["phase_ms_median"].items()))
    print(f"profiled: {res['profiled_wall_ms_per_step']:.2f} ms wall, "
          f"{res['device_ms_per_step']:.2f} ms device per step (busy share "
          f"{res['busy_share']:.3f}), {res['kernel_launches_per_step']:.0f} kernel launches "
          f"per step")
    if "perf" in res:
        rep = res["perf"]
        print(f"train MFU on the pre-staged step: {rep['train_mfu']:.4f} "
              f"({rep['flops_per_sample'] / 1e9:.3f} GFLOP a sample, "
              f"{rep['train_samples_per_sec']} samples/s, {rep['chip']})")
    for name, rows in (("host time by op", res["top_host_ops"]),
                       ("device time by kernel", res["top_device_kernels"])):
        print(f"{name} (name, calls per step, ms per step):")
        for row in rows:
            print(f"  {row}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
