#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cone_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # also print a device-time breakdown

Phases, each of which raises (exit code != 0) on failure:
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, TF32
     off for matmuls and cuDNN;
  2. build every CUDA kernel under cone_tpu_torch/csrc/ (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version at the main path's shape
     (Ego4D), at MAD scale and at edge cases: error, window-ranklist
     agreement, kernel / plain / library times beside the analytic bound;
  4. the main path: fused CONE inference (InferencePipeline.run(fused=True))
     at the full width of the Ego4D preset, random seeded weights loaded
     under the reference's names, a synthetic corpus; launch counts, the
     ranklists with the kernel off, the staged host-postprocessed path, and
     the repo's golden end-to-end fixture on the card;
  5. one JSON line per kernel summary, then {"ok": true, "device": ...}.

Imports nothing of JAX or of the cone_tpu package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 1e-5          # kernel vs plain: fp32 sums in another order
SPAN_ATOL, SCORE_ATOL = 1e-3, 2e-3   # tests/test_e2e_inference_parity.py:110-113


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_peaks(name: str):
    """(bytes/s, fp32 non-tensor-core FLOP/s) at the full power limit, from
    NVIDIA's data sheets."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100" in name:
        return 3.35e12, 67e12
    raise RuntimeError(f"no peak table for {name!r}")


def cuda_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def coarse_case(label, b, q, l_pad, d, stride, ctx, peaks, iters, gen):
    """Kernel vs plain on one shape; returns the measurements."""
    import torch
    import torch.nn.functional as F

    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.ops.windows import num_windows

    dev = torch.device("cuda")
    feats = torch.randn(b, l_pad, d, generator=gen, device=dev)
    feats = feats / feats.norm(dim=-1, keepdim=True)
    for i, c in enumerate(ctx):
        feats[i, c:] = 0
    cls = torch.randn(b, q, d, generator=gen, device=dev)
    cls = cls / cls.norm(dim=-1, keepdim=True)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)

    got = co.coarse_segment_max(feats, cls, ctx_t, stride)
    torch.cuda.synchronize()
    want = co.coarse_segment_max_plain(feats, cls, ctx_t, stride)
    n_seg = -(-l_pad // stride)
    check(got.shape == want.shape == (b, q, n_seg), f"{label}: shape {tuple(got.shape)}")
    seg_valid = (torch.arange(n_seg, device=dev)[None, :]
                 < (ctx_t[:, None] + stride - 1) // stride)[:, None, :].expand_as(got)
    err = (got - want).abs()[seg_valid].max().item()
    scale = max(1.0, want[seg_valid].abs().max().item())
    check(err <= REL_TOL * scale, f"{label}: max abs err {err} > {REL_TOL} x {scale}")
    check(bool((got[~seg_valid] <= co.NEG_INF / 2).all()), f"{label}: past-ctx segment not -1e30")
    check(torch.isfinite(got[seg_valid]).all().item(), f"{label}: non-finite segment max")

    # window ranklists from the two segment maxima
    max_w = num_windows(l_pad, stride)
    s_k, valid = co.window_scores_from_segment_max(got, ctx_t[:, None], stride, max_w)
    s_p, _ = co.window_scores_from_segment_max(want, ctx_t[:, None], stride, max_w)
    o_k = torch.argsort(-s_k, dim=-1, stable=True)
    o_p = torch.argsort(-s_p, dim=-1, stable=True)
    flips = int((o_k != o_p).sum().item())
    if flips:
        # the kernel's order, scored by the plain version, must still be
        # descending up to the tolerance: only near-ties may swap
        ps = torch.gather(s_p, -1, o_k)
        tol = REL_TOL * ps.abs().clamp(min=1.0)
        check(bool((ps[..., :-1] >= ps[..., 1:] - tol[..., 1:]).all()),
              f"{label}: window ranklists differ beyond near-ties")

    ms = cuda_ms(lambda: co.coarse_segment_max(feats, cls, ctx_t, stride), iters)
    plain_ms = cuda_ms(lambda: co.coarse_segment_max_plain(feats, cls, ctx_t, stride), iters)
    library_ms = cuda_ms(lambda: F.max_pool1d(torch.matmul(cls, feats.mT), stride, stride,
                                              ceil_mode=True), iters)
    frames = sum(min(c, l_pad) for c in ctx)
    nbytes = 4 * (frames * d + b * q * d + b + b * q * n_seg)
    flops = 2 * q * frames * d
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
    res = dict(label=label, B=b, Q=q, L=l_pad, D=d, stride=stride, ctx_l=list(ctx),
               max_abs_err=err, window_flips=flips, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"coarse_segment_max {label}: B={b} Q={q} L={l_pad} D={d} stride={stride} "
          f"ctx_l={list(ctx)[:4]} max_abs_err={err:.3e} window_flips={flips} "
          f"kernel={ms * 1e3:.2f}us plain={plain_ms * 1e3:.2f}us "
          f"library(matmul+max_pool1d)={library_ms * 1e3:.2f}us "
          f"bound={res['bound_ms'] * 1e3:.2f}us ({res['bound_by']})", flush=True)
    return res


def _self_device_us(evt):
    t = getattr(evt, "self_device_time_total", None)
    return evt.self_cuda_time_total if t is None else t


def profile_breakdown(pipe, n_q):
    """torch.profiler over one warm fused run: device time by op and the
    busy share of the run's wall; then the coarse kernel's device time per
    launch at the Ego4D and MAD shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cone_tpu_torch.ops import coarse as co

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.time()
        pipe.run(host_postproc=False, fused=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
    avgs = prof.key_averages()
    busy = sum(_self_device_us(e) for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    print(avgs.table(sort_by="self_cuda_time_total", row_limit=30))
    print(f"profiled fused run: {n_q} queries, wall {wall:.4f} s (profiler on), device time "
          f"{busy:.4f} s, busy share {busy / wall:.3f}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, q, l_pad, d, stride in (("ego4d", 32, 2304, 256, 45), ("mad", 32, 36864, 512, 62)):
        feats = torch.randn(1, l_pad, d, generator=gen, device="cuda")
        cls = torch.randn(1, q, d, generator=gen, device="cuda")
        ctx = torch.tensor([l_pad - 1], dtype=torch.int32, device="cuda")
        co.coarse_segment_max(feats, cls, ctx, stride)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(50):
                co.coarse_segment_max(feats, cls, ctx, stride)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if "coarse_segment_max_kernel" in e.key]
        check(ev, "profiler recorded no coarse_segment_max_kernel launch")
        print(f"coarse_segment_max {label}: device time per launch "
              f"{_self_device_us(ev[0]) / ev[0].count:.2f} us over {ev[0].count} launches "
              "(torch.profiler)", flush=True)


def golden_on_card():
    """tests/golden/e2e_inference.npz through the fused and staged paths
    on the card with the kernel on: exact window ranklists, all three
    modalities within the parity test's tolerances."""
    import numpy as np

    from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig
    from cone_tpu_torch.convert import load_reference_state_dict
    from cone_tpu_torch.data import GroundingDataset, InMemoryArrayStore, QueryExample, TextFeatureStore
    from cone_tpu_torch.eval.pipeline import InferencePipeline
    from cone_tpu_torch.models.cone import ConeModel

    g = dict(np.load(os.path.join(REPO, "tests", "golden", "e2e_inference.npz")).items())
    max_v_l, topk, dim = g["meta"].tolist()
    cfg = ConeConfig(
        model=ModelConfig(t_feat_dim=dim, v_motion_feat_dim=dim, v_appear_feat_dim=dim,
                          max_q_l=8, max_v_l=max_v_l),
        data=DataConfig(max_v_l=max_v_l, max_q_l=8, clip_length=float(g["clip_len"]),
                        topk_window=topk, max_ctx_l=160, normalize_v=False,
                        normalize_t=False),
        eval=EvalConfig(nms_thd=0.5, max_after_nms=5, max_before_nms=200, query_chunk=3,
                        use_pallas_coarse=True))
    qids = sorted(k[4:] for k in g if k.startswith("tok_"))
    ds = GroundingDataset(
        [QueryExample(q, "", q.split("_")[0], q.split("_")[0], [0, 0], 0.0) for q in qids],
        InMemoryArrayStore({k[6:]: g[k] for k in g if k.startswith("video_")}),
        TextFeatureStore(InMemoryArrayStore({q: g[f"tok_{q}"] for q in qids}),
                         InMemoryArrayStore({q: g[f"cls_{q}"][None] for q in qids})),
        cfg.data)
    model = ConeModel(cfg.model, device="cuda")
    model.load_state_dict(load_reference_state_dict({k: v for k, v in g.items()
                                                     if k.startswith("w::")}))
    pipe = InferencePipeline(model, ds, cfg, device="cuda")
    for fused in (True, False):
        subs, ranklists = pipe.run(host_postproc=not fused, fused=fused)
        for q in qids:
            check(ranklists[q] == g[f"{q}_ranklist"].tolist(), f"golden {q}: ranklist")
        for name, col in (("fusion", 4), ("proposal", 2), ("matching", 3)):
            by_qid = {r["query_id"]: r for r in subs[name]}
            for q in qids:
                want = g[f"{q}_{name}"]
                got = np.asarray(by_qid[q]["predicted_times"], np.float64)
                check(got.shape[0] == want.shape[0], f"golden {q} {name}: {got.shape}")
                check(np.abs(got[:, :2] - want[:, :2]).max() <= SPAN_ATOL,
                      f"golden {q} {name}: spans")
                check(np.abs(got[:, 2] - want[:, col if fused else 2]).max() <= SCORE_ATOL,
                      f"golden {q} {name}: scores")
    print(f"golden e2e_inference.npz on the card: {len(qids)} queries, ranklists exact, "
          "3 modalities within tolerance (fused and staged)", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler device-time breakdown of one fused run")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import cone_tpu_torch

    check(os.path.dirname(os.path.dirname(os.path.abspath(cone_tpu_torch.__file__))) == REPO,
          f"cone_tpu_torch imported from {cone_tpu_torch.__file__}, not from {REPO}")
    import numpy as np

    from cone_tpu_torch.config import ego4d_config
    from cone_tpu_torch.convert import load_reference_state_dict, random_reference_state_dict
    from cone_tpu_torch.data.synthetic import make_synthetic_dataset
    from cone_tpu_torch.eval.pipeline import InferencePipeline
    from cone_tpu_torch.kernels import build
    from cone_tpu_torch.models.cone import ConeModel
    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.ops.windows import num_windows, window_scores_from_frame_scores

    # 1. the card
    t_start = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name!r} "
          f"count {torch.cuda.device_count()}; TF32 off: "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    peaks = card_peaks(name)

    # 2. build
    t0 = time.time()
    libs = build.build()
    print(f"built {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'} in "
          f"{time.time() - t0:.1f} s:", flush=True)
    for kname, path in libs.items():
        print(f"  {kname}: {os.path.relpath(path, REPO)}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    # 3. kernel vs plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        coarse_case("ego4d", 1, 32, 2304, 256, 45, [2243], peaks, 500, gen),
        coarse_case("ego4d-video-batch", 4, 32, 2304, 256, 45, [2240, 2241, 2244, 2245],
                    peaks, 200, gen),
        coarse_case("mad", 1, 32, 36864, 512, 62, [36000], peaks, 100, gen),
        coarse_case("ctx<stride", 2, 8, 90, 64, 45, [30, 7], peaks, 20, gen),
        coarse_case("ctx=k*stride", 2, 32, 2304, 256, 45, [2250 - 45, 900], peaks, 20, gen),
        coarse_case("ctx=last-frame", 1, 32, 2304, 256, 45, [2304], peaks, 20, gen),
        coarse_case("q>32,ragged-tail", 1, 40, 1000, 128, 62, [999], peaks, 20, gen),
    ]
    main_case = cases[0]

    # 4. the main path: fused CONE inference at Ego4D width
    cfg = ego4d_config()
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, query_chunk=32, use_pallas_coarse=True))
    n_videos, qpv = 4, 64
    t0 = time.time()
    ds = make_synthetic_dataset(cfg.data, n_videos=n_videos, queries_per_video=qpv,
                                ctx_l_range=(2240, 2246), dim=cfg.model.v_appear_feat_dim,
                                seed=0)
    model = ConeModel(cfg.model, device="cuda")
    model.load_state_dict(load_reference_state_dict(random_reference_state_dict(cfg.model, seed=0)))
    pipe = InferencePipeline(model, ds, cfg, device="cuda")
    qc = cfg.eval.query_chunk
    dispatches = sum(-(-len([e for e in ds.examples if e.clip_id == v]) // qc)
                     for v in ds.video_ids)
    print(f"main path: Ego4D preset full width (hidden {cfg.model.hidden_dim}, "
          f"{cfg.model.nheads} heads, {cfg.model.enc_layers}+{cfg.model.dec_layers} layers, "
          f"FFN {cfg.model.dim_feedforward}, {cfg.model.num_queries} queries; max_v_l "
          f"{cfg.data.max_v_l}, topk {cfg.data.topk_window}, max_ctx_l {cfg.data.max_ctx_l}), "
          f"{n_videos} videos x {qpv} queries, ctx_l "
          f"{[len(ds.video_features(v)[0]) for v in ds.video_ids]}, set-up {time.time() - t0:.1f} s",
          flush=True)

    co.coarse_segment_max.launches = 0
    t0 = time.time()
    subs, ranklists = pipe.run(host_postproc=False, fused=True)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = co.coarse_segment_max.launches
    print(f"main path fused run: {first_s:.3f} s; coarse_segment_max launches {launches} "
          f"for {dispatches} dispatches", flush=True)
    check(launches == dispatches, f"kernel launched {launches} times, want {dispatches}")

    n_q = len(ds.examples)
    for m in ("fusion", "proposal", "matching"):
        rows = {r["query_id"]: r for r in subs[m]}
        check(len(rows) == n_q, f"{m}: {len(rows)} of {n_q} queries")
        for r in rows.values():
            t = np.asarray(r["predicted_times"], np.float64)
            check(t.ndim == 2 and t.shape[1] == 3 and 1 <= len(t) <= cfg.eval.max_after_nms
                  and np.isfinite(t).all() and (t[:, 1] >= t[:, 0]).all(),
                  f"{m} {r['query_id']}: bad moments {t.tolist()}")
    for v in ds.video_ids:
        n_win = num_windows(len(ds.video_features(v)[0]), pipe.stride)
        for e in ds.examples:
            if e.clip_id == v:
                check(sorted(ranklists[e.query_id]) == list(range(n_win)),
                      f"{e.query_id}: ranklist is not a permutation of the {n_win} windows")

    walls = []
    for _ in range(3):
        t0 = time.time()
        pipe.run(host_postproc=False, fused=True)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    print(f"main path warm fused runs: {[round(w, 4) for w in walls]} s -> "
          f"{n_q / min(walls):.1f} queries/s best, {n_q / float(np.median(walls)):.1f} median "
          f"({n_q} queries, {dispatches} dispatches) on {name} [{smi}]", flush=True)

    # kernel off: the plain coarse path must give the same ranklists
    cfg_off = cfg.replace(eval=dataclasses.replace(cfg.eval, use_pallas_coarse=False))
    pipe_off = InferencePipeline(model, ds, cfg_off, device="cuda")
    _, ranklists_off = pipe_off.run(host_postproc=False, fused=True)
    diff = [q for q in ranklists if ranklists[q] != ranklists_off[q]]
    near_tie_flips = 0
    for qid in diff:
        # allowed only where the plain scores of the swapped windows tie
        ex = next(e for e in ds.examples if e.query_id == qid)
        appear, a_scale, _, _, ctx_l = pipe_off._device_video(ex.clip_id)
        with torch.inference_mode():
            adapted = pipe_off._adapt(pipe_off._decode(appear, a_scale))[None]
            cls = torch.from_numpy(ds.query_features(qid)[1]).cuda()[None, None]
            s, _ = window_scores_from_frame_scores(
                cls @ adapted.transpose(1, 2), torch.tensor([[ctx_l]], device="cuda"),
                pipe_off.stride, num_windows(ctx_l, pipe_off.stride))
        s = s[0, 0].cpu().numpy()[ranklists[qid]]
        check(bool((s[:-1] >= s[1:] - REL_TOL * np.maximum(1.0, np.abs(s[1:]))).all()),
              f"{qid}: ranklists with the kernel on/off differ beyond near-ties")
        near_tie_flips += sum(a != b for a, b in zip(ranklists[qid], ranklists_off[qid]))
    print(f"ranklists kernel on vs off: {n_q - len(diff)}/{n_q} identical, "
          f"{near_tie_flips} near-tie flips", flush=True)

    # staged path with the reference-exact host post-processing
    subs_s, ranklists_s = pipe.run(host_postproc=True)
    check(ranklists_s == ranklists, "staged ranklists differ from fused")
    worst = [0.0, 0.0]
    for m, col in (("fusion", 4), ("proposal", 2), ("matching", 3)):
        fused_rows = {r["query_id"]: np.asarray(r["predicted_times"], np.float64) for r in subs[m]}
        for r in subs_s[m]:
            want = np.asarray(r["predicted_times"], np.float64)
            got = fused_rows[r["query_id"]]
            check(got.shape[0] == want.shape[0],
                  f"{m} {r['query_id']}: {got.shape[0]} fused vs {want.shape[0]} staged moments")
            worst[0] = max(worst[0], float(np.abs(got[:, :2] - want[:, :2]).max()))
            worst[1] = max(worst[1], float(np.abs(got[:, 2] - want[:, col]).max()))
    check(worst[0] <= SPAN_ATOL and worst[1] <= SCORE_ATOL,
          f"fused vs staged: span err {worst[0]}, score err {worst[1]}")
    print(f"fused vs staged host postproc: all 3 modalities, max span err {worst[0]:.2e} "
          f"(<= {SPAN_ATOL}), max score err {worst[1]:.2e} (<= {SCORE_ATOL})", flush=True)

    golden_on_card()

    if args.profile:
        profile_breakdown(pipe, n_q)

    kernels = [dict(
        name="coarse_segment_max", route="cuda",
        source="cone_tpu_torch/csrc/coarse_segment_max.cu",
        replaces="cone_tpu/ops/pallas_coarse.py:66", launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=main_case["ms"], plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
        bound_by=main_case["bound_by"], library_ms=main_case["library_ms"])]
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
