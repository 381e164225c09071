#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cone_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # also print a device-time breakdown

Phases, each of which raises (exit code != 0) on failure:
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, TF32
     off for matmuls and cuDNN;
  2. build every CUDA kernel under cone_tpu_torch/csrc/ (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version at its path's shape, at
     MAD scale and at the seams of its tiling: error, window-ranklist
     agreement (near-tie flips counted), kernel / plain / library times
     beside the analytic bound, device time per launch from torch.profiler.
     The coarse kernel at the Ego4D and MAD shapes, at the 2D-TAN strides
     32 and 64 (segments of whole 16-frame tiles) and with every template
     instance; the attention kernel through its own entry point
     (cone_tpu_torch.tools.bench_attn.run) at B 640, L 110, D 256, H 8 in
     float32 and bfloat16;
  4. the main path: fused CONE inference (InferencePipeline.run(fused=True))
     at the full width of the Ego4D preset, random seeded weights loaded
     under the reference's names, a synthetic corpus; launch counts, the
     ranklists with the kernel off, the staged host-postprocessed path, and
     the repo's golden end-to-end fixture on the card;
  5. the path that serves, at the same width: a MomentService over a
     library of 16 videos behind its HTTP server, every endpoint over real
     HTTP, answers held against direct calls, warm latencies;
  6. the `infer --fused` CLI on a synthetic workdir written to a temporary
     directory, held against the main-path run on the same data;
  7. training: the reference's golden 4-step trajectory on the card within
     its limits, then `train` at the Ego4D preset's full width, bsz 32, 3
     epochs with one eval epoch through the coarse kernel: finite, falling
     losses, one kernel launch per eval dispatch, the best checkpoint
     answering as the module in memory; step times and the profiled first
     epoch's device busy share;
  8. the 2D-TAN family: the golden fixtures tan_forward*.npz and the 4-step
     tan_train_trajectory.npz on the card; fused TAN inference at
     tan_ego4d's full width through the coarse kernel (launches, ranklists
     kernel on vs off, fused vs staged, device time and its convolution
     share); `train` at the tan_ego4d preset, bsz 32, 2 epochs of 2 steps
     with an eval epoch and its plateau step;
  9. data parallelism at the Ego4D preset's full width: (a) `train
     --distributed` as a group of one rank over NCCL, dropouts 0, held to
     the non-distributed `train` of the same seed within 1e-6; (b) two ranks
     sharing the card over gloo (cone_tpu_torch/tools/dist_worker.py, 16 rows
     each of bsz 32) at the preset's dropouts (0.1, input 0.5), held to each
     other and to the single-process run: losses, grad norms, weights, the
     gathered evaluation, the rank-sharded library, one coarse launch per
     dispatch on each rank; ms per step and the gradient all-reduce's bytes
     and ms;
 10. the feature towers and the demo path, with seeded weights in the
     released layouts, a word-hash tokenizer at CLIP's ids and CLIP's image
     normalisation defined here, so that the phase needs no transformers:
     (a) CLIP ViT-B/32 and the CLIP text tower at full width, card vs CPU,
     frames/s and queries/s beside the float32 bound; (b) EgoVLP ViT-B/16 at
     full width, card vs CPU, the golden egovlp_tower.npz on the card,
     extract_egovlp_video over 64 clips from a checkpoint file, clips/s
     beside the bound; (c) the demo (MomentPredictor, clip backend, tower
     engine) over a 2-minute video at 5 fps (a real ffmpeg decode of a lavfi
     testsrc clip when ffmpeg is on PATH, else seeded frames at the decode
     seam) at the MAD preset's full width with the coarse kernel on: coarse
     launches per query and the shape they ran at (the kernel is then held
     against its plain version and timed at that shape), cold and warm
     times (the warm call hits the feature
     cache), moments against the CPU localizer on the card's features,
     ranklists against the CPU and the kernel off up to near-tie flips; (d)
     `serve --text_backend clip`'s service over HTTP: raw-text /search ==
     the feature-carrying /search;
 11. one JSON line with every kernel's summary, then {"ok": true, "device": ...}.

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
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REL_TOL = 1e-5          # kernel vs plain: fp32 sums in another order
SPAN_ATOL, SCORE_ATOL = 1e-3, 2e-3   # tests/test_e2e_inference_parity.py:110-113


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def coarse_case(label, b, q, l_pad, d, stride, ctx, peaks, iters, gen, spb=None):
    """Kernel vs plain on one shape; returns the measurements. `spb`
    overrides the plan's segments per block, to land on a run's seams;
    iters 0 checks without timing."""
    import torch
    import torch.nn.functional as F

    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.ops.windows import num_windows
    from cone_tpu_torch.tools.bench_kernels import fmt_us, kernel_device_us
    from cone_tpu_torch.utils.device import cuda_ms

    dev = torch.device("cuda")
    feats = torch.randn(b, l_pad, d, generator=gen, device=dev)
    feats = feats / feats.norm(dim=-1, keepdim=True)
    for i, c in enumerate(ctx):
        feats[i, c:] = 0
    cls = torch.randn(b, q, d, generator=gen, device=dev)
    cls = cls / cls.norm(dim=-1, keepdim=True)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)

    got = co.coarse_segment_max(feats, cls, ctx_t, stride, spb)
    torch.cuda.synchronize()
    want = co.coarse_segment_max_plain(feats, cls, ctx_t, stride)
    n_seg = -(-l_pad // stride)
    spb = co.plan(n_seg, b)["segs_per_block"] if spb is None else spb
    ntw = co.layout(q, d, l_pad, stride, spb)["ntw"]    # the template instance launched
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

    if not iters:
        print(f"coarse_segment_max {label}: B={b} Q={q} L={l_pad} D={d} stride={stride} "
              f"ctx_l={list(ctx)[:4]} segs_per_block={spb} instance={ntw} "
              f"max_abs_err={err:.3e} window_flips={flips}", flush=True)
        return dict(label=label, max_abs_err=err, window_flips=flips, ntw=ntw)
    ms = cuda_ms(lambda: co.coarse_segment_max(feats, cls, ctx_t, stride), iters)
    plain_ms = cuda_ms(lambda: co.coarse_segment_max_plain(feats, cls, ctx_t, stride), iters)
    library_ms = cuda_ms(lambda: F.max_pool1d(torch.matmul(cls, feats.mT), stride, stride,
                                              ceil_mode=True), iters)
    device_us = kernel_device_us(lambda: co.coarse_segment_max(feats, cls, ctx_t, stride),
                                 "coarse_segment_max_kernel", 50)
    frames = sum(min(c, l_pad) for c in ctx)
    nbytes = 4 * (frames * d + b * q * d + b + b * q * n_seg)
    flops = 2 * q * frames * d
    t_bytes, t_ops = nbytes / peaks["bytes"] * 1e3, flops / peaks["float32"] * 1e3
    res = dict(label=label, B=b, Q=q, L=l_pad, D=d, stride=stride, ctx_l=list(ctx), ntw=ntw,
               max_abs_err=err, window_flips=flips, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, device_us=device_us, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"coarse_segment_max {label}: B={b} Q={q} L={l_pad} D={d} stride={stride} "
          f"ctx_l={list(ctx)[:4]} segs_per_block={spb} instance={ntw} max_abs_err={err:.3e} "
          f"window_flips={flips} kernel={ms * 1e3:.2f}us (device {fmt_us(device_us)} per "
          f"launch, torch.profiler) plain={plain_ms * 1e3:.2f}us "
          f"library(matmul+max_pool1d)={library_ms * 1e3:.2f}us "
          f"bound={res['bound_ms'] * 1e3:.2f}us ({res['bound_by']})", flush=True)
    return res


def attention_phase():
    """The attention kernel through its own entry point
    (cone_tpu_torch.tools.bench_attn.run) at the tool's shape in float32 and
    bfloat16, with its launch count read around exactly that call; then the
    edge cases against the plain version. Returns (run results, launches,
    max abs error per dtype over all cases)."""
    import torch

    from cone_tpu_torch.ops import attention as at
    from cone_tpu_torch.tools import bench_attn
    from cone_tpu_torch.tools.bench_kernels import fmt_us, kernel_device_us

    at.masked_attention.launches = 0
    res = bench_attn.run(device="cuda", seed=0)
    launches = at.masked_attention.launches
    b, l, d, h = res["shapes"]
    for name, r in res["results"].items():
        dtype = getattr(torch, name)
        q, k, v, mask = bench_attn.make_inputs(b, l, l, d, dtype, "cuda")
        r["device_us"] = kernel_device_us(lambda: at.masked_attention(q, k, v, mask, h),
                                          "masked_attention_kernel")
        print(f"masked_attention {name}: B={b} L={l} D={d} H={h} max_abs_err="
              f"{r['max_abs_err']:.3e} (tol {r['tol']:.1e}) kernel={r['ms'] * 1e3:.2f}us "
              f"(device {fmt_us(r['device_us'])} per launch, torch.profiler) "
              f"plain={r['plain_ms'] * 1e3:.2f}us library(sdpa, additive mask)="
              f"{r['library_ms'] * 1e3:.2f}us (its err {r['library_max_abs_err']:.1e}) "
              f"bound={r['bound_ms'] * 1e3:.2f}us ({r['bound_by']}: {r['bytes']} bytes, "
              f"{r['flops']} flops)", flush=True)
    check(launches > 0, "bench_attn.run launched no masked_attention kernel")
    print(f"masked_attention launches on its entry point's run: {launches}", flush=True)

    worst = {name: r["max_abs_err"] for name, r in res["results"].items()}
    edge = [  # label, B, Lq, Lk, D, H, mask edit
        ("fully-masked-row", 4, 110, 110, 256, 8, "mask_row"),
        ("lens=L", 4, 110, 110, 256, 8, "mask_none"),
        ("no-mask", 4, 110, 110, 256, 8, "none"),
        ("Lq5/Lk110", 640, 5, 110, 256, 8, None),
        ("hd16", 3, 110, 110, 128, 8, None),
        ("hd64", 3, 110, 110, 256, 4, None),
        ("B3", 3, 110, 110, 256, 8, None),
        ("L1", 3, 1, 1, 256, 8, None),
        ("3-query-chunks/Lk256", 2, 300, 256, 256, 8, None),
        ("hd48", 2, 130, 40, 144, 3, None),
    ]
    # Lq and Lk on either side of the 16-row tiles, at every head width; a
    # fully masked window among the others. float32 beyond 128 keys of width
    # 128 is beyond a block's shared memory: the wrapper refuses it (checked in
    # tests/test_torch_cuda.py), so that one combination is left out
    for hd in (16, 32, 64, 128):
        for n in (15, 16, 17, 111, 112, 113, 256):
            for lq, lk in ((n, n), (n, 110), (110, n)):
                edge.append((f"hd{hd}/Lq{lq}/Lk{lk}", 3, lq, lk, 2 * hd, 2, "mask_row"))
    n_seam = 0
    for label, eb, lq, lk, ed, eh, edit in edge:
        for dtype in (torch.float32, torch.bfloat16):
            if at.smem_bytes(lq, lk, ed // eh, eh, 4 if dtype == torch.float32 else 2) \
                    > at.MAX_SMEM_BYTES:
                check(dtype == torch.float32 and ed // eh == 128 and lk > 128,
                      f"{label}: unexpected shared-memory refusal")
                continue
            q, k, v, mask = bench_attn.make_inputs(eb, lq, lk, ed, dtype, "cuda", seed=1)
            if edit == "mask_row":
                mask[1] = True
            elif edit == "mask_none":
                mask[:] = False
            elif edit == "none":
                mask = None
            err, tol, got = bench_attn.compare(q, k, v, mask, eh)  # raises beyond tol
            if edit == "mask_row":
                # uniform weights over all keys: finite, the mean of v
                want = v[1].float().mean(0).expand(lq, ed)
                check(float((got[1].float() - want).abs().max()) <= tol,
                      f"{label}: fully masked row is not the mean of v")
            name = str(dtype).split(".")[-1]
            worst[name] = max(worst[name], err)
            if label.startswith("hd") and "/" in label:
                n_seam += 1     # 160 of these: one summary line below
                continue
            print(f"masked_attention {label} {name}: B={eb} Lq={lq} Lk={lk} D={ed} H={eh} "
                  f"max_abs_err={err:.3e} (tol {tol:.1e})", flush=True)
    print(f"masked_attention tile seams: {n_seam} cases (Lq, Lk in 15 16 17 111 112 113 256 "
          f"x head width 16 32 64 128 x 2 types, a fully masked window in each) within "
          f"tolerance; worst max_abs_err float32 {worst['float32']:.3e}, bfloat16 "
          f"{worst['bfloat16']:.3e}", flush=True)
    return res, launches, worst


def _well_formed(moments, top_moments, videos, label):
    import numpy as np

    check(isinstance(moments, list) and 1 <= len(moments) <= top_moments,
          f"{label}: {len(moments)} moments, want 1..{top_moments}")
    fused = [m["fused"] for m in moments]
    check(fused == sorted(fused, reverse=True), f"{label}: not fusion-ranked")
    for m in moments:
        vals = [*m["span"], m["prop"], m["match"], m["fused"]]
        check(np.isfinite(vals).all() and m["span"][1] >= m["span"][0]
              and m["video_id"] in videos, f"{label}: bad moment {m}")


def serving_phase(model, cfg, card, device="cuda"):
    """A MomentService on the card at the main path's width behind its HTTP
    server: a library of 16 synthetic videos of 1 500-2 304 clips, every
    endpoint over real HTTP (urllib), the answers held against direct calls
    on the service and against each other, warm latencies. `device` is
    there to rehearse the phase on the CPU at a narrow width; main() runs
    it on the card."""
    import base64
    import urllib.request

    import numpy as np
    import torch

    from cone_tpu_torch.ops import attention as at
    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.serve.server import MomentService, make_server

    dim, tdim = cfg.model.v_appear_feat_dim, cfg.model.t_feat_dim
    rng = np.random.default_rng(7)
    videos = {f"lib_{i:02d}": rng.normal(size=(int(rng.integers(1500, 2305)), dim))
              .astype(np.float32) for i in range(16)}
    queries = []
    for i in range(8):  # query i is planted in video 2 i
        cls = rng.normal(size=dim).astype(np.float32)
        cls /= np.linalg.norm(cls)
        vid = f"lib_{2 * i:02d}"
        st = int(rng.integers(100, len(videos[vid]) - 200))
        videos[vid][st : st + 40] += 8.0 * cls
        tok = rng.normal(size=(int(rng.integers(5, 13)), tdim)).astype(np.float32)
        queries.append(dict(tok=tok, cls=cls, video=vid, text=f"planted query {i}"))
    one_shot = rng.normal(size=(2243, dim)).astype(np.float32)

    errors = []
    old_hook = threading.excepthook
    threading.excepthook = lambda a: errors.append(a)
    t0 = time.time()
    svc = MomentService(model, cfg, device=device)
    srv = make_server(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, name="moment-http", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def call(path, payload=None):
        data = payload if isinstance(payload, bytes) or payload is None \
            else json.dumps(payload).encode()
        req = urllib.request.Request(base + path, data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            check(r.status == 200, f"{path}: HTTP {r.status}")
            return json.loads(r.read())

    def b64(a):
        return base64.b64encode(np.ascontiguousarray(a, "<f4").tobytes()).decode()

    def q_json(q, **kw):
        return dict(token_features=q["tok"].tolist(), cls_feature=q["cls"].tolist(),
                    query=q["text"], **kw)

    def q_b64(q, **kw):
        return dict(token_features_b64=b64(q["tok"]), token_shape=list(q["tok"].shape),
                    cls_feature_b64=b64(q["cls"]), query=q["text"], **kw)

    def median_s(fn, n=5):
        fn()  # warm
        walls = []
        for _ in range(n):
            t = time.time()
            fn()
            walls.append(time.time() - t)
        return float(np.median(walls)), walls

    try:
        hz = call("/healthz")
        check(hz == {"ok": True, "backend": device, "videos": 0}, f"/healthz: {hz}")
        # library: three videos over HTTP, the rest directly, one grown by /append_video
        names = sorted(videos)
        for cid in names[:3]:
            r = call("/add_video", dict(clip_id=cid, features=videos[cid].tolist()))
            check(r == {"ok": True, "clip_id": cid, "clips": len(videos[cid])}, f"/add_video {r}")
        for cid in names[3:-1]:
            svc.retriever.add_video(cid, videos[cid])
        last = names[-1]
        svc.retriever.add_video(last, videos[last][:-200])
        r = call("/append_video", dict(clip_id=last, features=videos[last][-200:].tolist()))
        check(r["clips"] == len(videos[last]), f"/append_video: {r}")
        check(call("/healthz")["videos"] == 16, "library is not 16 videos")
        print(f"serving: MomentService on {device}, 16 videos of "
              f"{min(map(len, videos.values()))}-{max(map(len, videos.values()))} clips "
              f"({sum(map(len, videos.values()))} in all), set-up {time.time() - t0:.1f} s",
              flush=True)

        at_before = at.masked_attention.launches
        # /search: JSON and base64 features, against a direct call on the service
        singles = []
        for q in queries:
            got = call("/search", q_json(q))["moments"]
            check(got == call("/search", q_b64(q))["moments"],
                  f"{q['text']}: JSON and base64 features answer differently")
            direct = json.loads(json.dumps(svc.search(q_b64(q))["moments"]))
            check(got == direct, f"{q['text']}: HTTP answer differs from the direct call")
            _well_formed(got, 10, videos, q["text"])
            ranked = svc.retriever.rank_videos(q["cls"])
            check(ranked[0][0] == q["video"],
                  f"{q['text']}: planted video {q['video']} ranks {ranked[:3]}")
            top2 = call("/search", q_b64(q, search_windows=2, top_moments=3))["moments"]
            _well_formed(top2, 3, videos, q["text"] + " (2 windows)")
            check({m["video_id"] for m in top2} == {q["video"]},
                  f"{q['text']}: the two best windows are not in the planted video")
            singles.append(got)
        # /search_batch of 8 equals the eight single answers
        batch_payload = dict(queries=[q_b64(q) for q in queries])
        batch = call("/search_batch", batch_payload)["results"]
        check([r["moments"] for r in batch] == singles,
              "/search_batch differs from the eight single /search answers")
        # /localize: one 2 243-clip video, through the coarse kernel
        loc_payload = json.dumps(dict(video_features=one_shot.tolist(),
                                      **q_json(queries[0]))).encode()
        co_before = co.coarse_segment_max.launches
        loc = call("/localize", loc_payload)["moments"]
        check(co.coarse_segment_max.launches > co_before,
              "/localize launched no coarse_segment_max kernel")
        check(1 <= len(loc) <= cfg.eval.max_after_nms, f"/localize: {len(loc)} moments")
        for row in loc:
            check(len(row) == 5 and np.isfinite(row).all() and row[1] >= row[0],
                  f"/localize: bad moment {row}")
        direct = svc.localizer.localize(one_shot, queries[0]["tok"], queries[0]["cls"],
                                        query=queries[0]["text"])
        check(loc == [[float(x) for x in row] for row in direct],
              "/localize over HTTP differs from the direct call")

        # latencies, warm, medians of 5
        s_med, _ = median_s(lambda: call("/search", q_b64(queries[1])))
        b_med, _ = median_s(lambda: call("/search_batch", batch_payload))
        l_med, _ = median_s(lambda: call("/localize", loc_payload))
        d_med, _ = median_s(lambda: svc.localizer.localize(
            one_shot, queries[0]["tok"], queries[0]["cls"]))
        print(f"serving warm latency (median of 5, host clock, over HTTP on localhost): "
              f"/search {s_med * 1e3:.2f} ms, /search_batch of 8 {b_med * 1e3:.2f} ms "
              f"({8 / b_med:.1f} queries/s), /localize (2243 clips as JSON text) "
              f"{l_med * 1e3:.2f} ms, of which the localizer itself {d_med * 1e3:.2f} ms "
              f"[{card}]", flush=True)

        # persistence and eviction
        with tempfile.TemporaryDirectory() as tmp:
            r = call("/save_corpus", dict(dir=tmp))
            check(r["videos"] == 16, f"/save_corpus: {r}")
            gone = queries[2]["video"]
            r = call("/remove_video", dict(clip_id=gone))
            check(r["videos"] == 15, f"/remove_video: {r}")
            after = call("/search", q_b64(queries[2]))["moments"]
            _well_formed(after, 10, videos, "after /remove_video")
            check(all(m["video_id"] != gone for m in after), "removed video still answers")
            r = call("/load_corpus", dict(dir=tmp))
            check(r == {"ok": True, "videos_loaded": 16, "videos": 16}, f"/load_corpus: {r}")
        reloaded = [call("/search", q_b64(q))["moments"] for q in queries]
        check(reloaded == singles, "answers after /save_corpus + /load_corpus differ")
        stats = call("/stats")
        check(stats["videos"] == 16 and stats["total_clips"] == sum(map(len, videos.values()))
              and stats["requests"]["search_batch"] >= 7 and stats["requests"]["localize"] >= 7,
              f"/stats: {stats}")
        check(at.masked_attention.launches == at_before,
              "the serving path launched the attention kernel")
        print(f"serving: /healthz /add_video /append_video /search (JSON, base64) "
              f"/search_batch /localize /remove_video /save_corpus /load_corpus /stats ok; "
              f"batch == singles, HTTP == direct, save+load == before, planted video first; "
              f"requests {stats['requests']}", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        threading.excepthook = old_hook
    check(not thread.is_alive(), "the HTTP server thread did not stop")
    check(not errors, f"a thread failed: {[repr(e.exc_value) for e in errors]}")
    del svc
    torch.cuda.empty_cache()
    return dict(search_ms=s_med * 1e3, search_batch8_ms=b_med * 1e3, localize_ms=l_med * 1e3,
                localize_direct_ms=d_med * 1e3)


def infer_phase(model, cfg, ds, ranklists, device="cuda"):
    """`cone_tpu_torch.cli infer --fused` in-process on a synthetic workdir
    (.cfs stores, config.json, model_best.ckpt) holding the main path's
    data and weights: the output files, and ranklists equal to the main
    path's run."""
    import torch

    from cone_tpu_torch import cli
    from cone_tpu_torch.data.store import write_packed_store
    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.utils.io import load_jsonl, save_jsonl

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        text = os.path.join(tmp, "features", "text")
        os.makedirs(text)
        write_packed_store(os.path.join(tmp, "features", "video.cfs"),
                           {v: ds.appear.get(v) for v in ds.video_ids})
        write_packed_store(os.path.join(text, "tokens.cfs"),
                           {e.query_id: ds.text.get_tokens(e.query_id) for e in ds.examples})
        write_packed_store(os.path.join(text, "cls.cfs"),
                           {e.query_id: ds.text.get_cls(e.query_id)[None] for e in ds.examples})
        jsonl = os.path.join(tmp, "eval.jsonl")
        save_jsonl([dataclasses.asdict(e) for e in ds.examples], jsonl)
        run, out = os.path.join(tmp, "run"), os.path.join(tmp, "results")
        os.makedirs(run)
        # the challenge writer of dset_name "ego4d" parses annotation ids out
        # of the query ids; the synthetic ids have none
        cfg.replace(data=dataclasses.replace(
            cfg.data, dset_name="synthetic", eval_path=jsonl, t_feat_dir=text,
            appearance_feat_dir=os.path.join(tmp, "features", "video.cfs"))
        ).save(os.path.join(run, "config.json"))
        torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}, "epoch": 0},
                   os.path.join(run, "model_best.ckpt"))
        before = co.coarse_segment_max.launches
        cli.main(["infer", "--workdir", run, "--fused", "--save_all", "--results_dir", out,
                  "--device", device])
        torch.cuda.synchronize()
        launched = co.coarse_segment_max.launches - before
        want = {"inference_best_preds.jsonl", "inference_best_proposal_preds.jsonl",
                "inference_best_matching_preds.jsonl", "inference_best_windows.jsonl",
                "submission_synthetic_best.jsonl"}
        check(set(os.listdir(out)) == want, f"infer wrote {sorted(os.listdir(out))}")
        got = {r["query_id"]: r["ranklist"]
               for r in load_jsonl(os.path.join(out, "inference_best_windows.jsonl"))}
        check(got == ranklists, "infer --fused ranklists differ from the main-path run")
        for name in want - {"inference_best_windows.jsonl"}:
            rows = load_jsonl(os.path.join(out, name))
            check(len(rows) == len(ds.examples) and all(r["predicted_times"] for r in rows),
                  f"{name}: {len(rows)} rows")
    check(launched > 0, "infer --fused launched no coarse_segment_max kernel")
    print(f"infer --fused CLI on a synthetic workdir: {len(want)} files, "
          f"{len(got)} ranklists equal to the main path's, {launched} coarse kernel "
          f"launches, {time.time() - t0:.1f} s", flush=True)


def training_phase(card, device="cuda"):
    """Training on the card: the reference's golden 4-step trajectory
    (tests/golden/train_trajectory.npz) within its limits, then `train` at
    the Ego4D preset's full width, bsz 32, on a planted-signal synthetic set
    of 8 videos x 32 queries (8 steps an epoch): 3 epochs, the adapter on
    from the second (both step variants), the first epoch profiled, one
    eval epoch through the coarse kernel. Checks: finite losses that fall,
    one coarse kernel launch per eval dispatch, the `best` checkpoint
    answering as the trained module in memory, the module back in train
    mode. `device` is there to rehearse the phase on the CPU; main() runs it
    on the card. Returns (measurements, coarse launches)."""
    import numpy as np
    import torch

    from cone_tpu_torch.config import ego4d_config
    from cone_tpu_torch.data.synthetic import make_synthetic_dataset
    from cone_tpu_torch.eval.pipeline import InferencePipeline
    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.tools import golden_train
    from cone_tpu_torch.train.checkpoint import load_model
    from cone_tpu_torch.train.loop import train

    t0 = time.time()
    worst = golden_train.check(device=device)
    print(f"golden train_trajectory.npz on {device}: 4 steps, worst loss err "
          f"{worst['loss_overall']:.2e} (< {golden_train.LIMITS['loss_overall']} rel), grad norm "
          f"{worst['grad_norm']:.2e} (< {golden_train.LIMITS['grad_norm']} rel), terms "
          f"{worst['terms']:.2e} (< {golden_train.LIMITS['terms']}), weights "
          f"{worst['weights']:.2e} (< {golden_train.LIMITS['weights']} abs, "
          f"{worst['worst_weight']}), {time.time() - t0:.1f} s", flush=True)

    cfg = ego4d_config()
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, dset_name="synthetic"),
        train=dataclasses.replace(cfg.train, bsz=32, n_epoch=3, start_epoch_for_adapter=1,
                                  eval_epoch_interval=3),
        eval=dataclasses.replace(cfg.eval, use_pallas_coarse=True))
    n_videos, qpv = 8, 32
    ds = make_synthetic_dataset(cfg.data, n_videos=n_videos, queries_per_video=qpv,
                                ctx_l_range=(1500, 2305), dim=cfg.model.v_appear_feat_dim,
                                signal=3.0, seed=1)
    qc = cfg.eval.query_chunk
    dispatches = n_videos * -(-qpv // qc)
    with tempfile.TemporaryDirectory() as workdir:
        co.coarse_segment_max.launches = 0
        t0 = time.time()
        model, history = train(cfg, ds, ds, workdir, profile=True, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        train_s = time.time() - t0
        launches = co.coarse_segment_max.launches
        check(model.training, "the trained module is not in train mode after the eval epoch")
        check(len(history) == 3 and all(len(h["step_times"]) == 8 for h in history),
              f"history: {[(h['epoch'], len(h['step_times'])) for h in history]}")
        for h in history:
            bad = {k: v for k, v in h.items() if k.startswith(("loss", "eval_loss", "grad_norm"))
                   and not np.isfinite(v)}
            check(not bad, f"epoch {h['epoch']}: non-finite {bad}")
        # the adapter term joins the total from epoch 2 (start_epoch_for_adapter
        # 1): the total without it must fall from the first epoch to the last
        coef = cfg.loss.adapter_loss_coef
        rest = [h["loss_overall"] - coef * h.get("loss_adapter", 0.0) for h in history]
        check(rest[-1] < rest[0], f"loss without the adapter term did not fall: {rest}")
        want = dispatches if device == "cuda" else 0  # the CPU runs the plain version
        check(launches == want,
              f"eval epoch launched coarse_segment_max {launches} times, want {want}")
        check(history[2]["eval_loss_overall"] > 0 and "eval_seconds" in history[2],
              "the eval epoch logged no eval losses")

        # the best checkpoint answers as the module in memory
        check(os.path.exists(os.path.join(workdir, "model_best.ckpt")),
              "no best checkpoint: the eval's stop score was 0")
        loaded, epoch = load_model(workdir, "best", device=device)
        check(epoch == 2, f"best checkpoint from epoch {epoch}, want 2")
        co.coarse_segment_max.launches = 0
        subs_m, rank_m = InferencePipeline(model, ds, cfg, device=device).run(
            host_postproc=False, fused=True)
        subs_l, rank_l = InferencePipeline(loaded, ds, cfg, device=device).run(
            host_postproc=False, fused=True)
        extra_launches = co.coarse_segment_max.launches
        check(rank_m == rank_l, "the best checkpoint ranks windows differently")
        diff = 0.0
        for name in subs_m:
            rows_l = {r["query_id"]: r["predicted_times"] for r in subs_l[name]}
            for r in subs_m[name]:
                a, b = np.asarray(r["predicted_times"]), np.asarray(rows_l[r["query_id"]])
                check(a.shape == b.shape, f"{name} {r['query_id']}: {a.shape} vs {b.shape}")
                diff = max(diff, float(np.abs(a - b).max()) if a.size else 0.0)
        check(diff <= 1e-6, f"best checkpoint's moments differ by {diff}")
        model.train()
        profile_files = os.listdir(os.path.join(workdir, "profile"))
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            evals = [r for r in map(json.loads, f) if r["kind"] == "eval"]
        check(len(evals) == 1, f"{len(evals)} eval records, want 1")

    steps = [t for h in history for t in h["step_times"]]
    warm = [t for h in history[1:] for t in h["step_times"]]
    med = float(np.median(warm))
    meas = dict(first_step_ms=steps[0] * 1e3, warm_step_ms_median=med * 1e3,
                steps_per_s=1.0 / med, eval_seconds=history[2]["eval_seconds"],
                train_seconds=train_s, eval_dispatches=dispatches, loss_first=rest[0],
                loss_last=rest[-1], stop_score=evals[0]["stop_score"],
                loader_wait_ms=float(np.mean([h["dataloading_time"] for h in history[1:]])) * 1e3)
    if "profile_device_s" in history[0]:
        meas["profiled_epoch_device_s"] = history[0]["profile_device_s"]
        meas["profiled_epoch_wall_s"] = history[0]["profile_wall_s"]
        meas["profiled_epoch_busy_share"] = (history[0]["profile_device_s"]
                                             / history[0]["profile_wall_s"])
    print(f"train at Ego4D width (hidden {cfg.model.hidden_dim}, {cfg.model.nheads} heads, "
          f"{cfg.model.enc_layers}+{cfg.model.dec_layers} layers, FFN "
          f"{cfg.model.dim_feedforward}), bsz 32, {n_videos} videos x {qpv} queries: 3 epochs "
          f"of 8 steps in {train_s:.2f} s; losses finite, loss without the adapter term "
          f"{rest[0]:.4f} -> {rest[-1]:.4f}, adapter {history[1]['loss_adapter']:.4f} -> "
          f"{history[2]['loss_adapter']:.4f}; eval epoch {history[2]['eval_seconds']:.3f} s with "
          f"{launches} coarse_segment_max launches for {dispatches} dispatches; best "
          f"checkpoint == module in memory (ranklists exact, moments within {diff:.1e}, "
          f"{extra_launches} launches in that check); profile files {profile_files}",
          flush=True)
    print(f"train step times (host clock, each step ends in a device-to-host read of its "
          f"metrics): first {steps[0] * 1e3:.2f} ms, warm median {med * 1e3:.2f} ms over the "
          f"{len(warm)} steps after the first epoch -> {1.0 / med:.2f} steps/s (the step "
          f"waited {meas['loader_wait_ms']:.2f} ms a batch for the loader); profiled first "
          f"epoch busy share {meas.get('profiled_epoch_busy_share', float('nan')):.4f} "
          f"[{card}]", flush=True)
    return meas, launches


def near_tie_flips(pipe_off, ds, ranklists, ranklists_off):
    """Ranklists with the coarse kernel on against the plain path's: where
    they differ, the kernel's order scored by the plain version must still
    descend up to REL_TOL (only near-ties may swap). Returns (identical
    queries, window flips)."""
    import numpy as np
    import torch

    from cone_tpu_torch.ops.windows import num_windows, window_scores_from_frame_scores

    diff = [q for q in ranklists if ranklists[q] != ranklists_off[q]]
    flips = 0
    for qid in diff:
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
        flips += sum(a != b for a, b in zip(ranklists[qid], ranklists_off[qid]))
    return len(ranklists) - len(diff), flips


def fused_vs_staged(subs, subs_s):
    """Worst (span, score) differences of the fused run's moments from the
    staged run's with host post-processing, all three modalities."""
    import numpy as np

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
    return worst


def well_formed_runs(subs, n_q, max_after_nms, label):
    import numpy as np

    for m in ("fusion", "proposal", "matching"):
        rows = {r["query_id"]: r for r in subs[m]}
        check(len(rows) == n_q, f"{label} {m}: {len(rows)} of {n_q} queries")
        for r in rows.values():
            t = np.asarray(r["predicted_times"], np.float64)
            check(t.ndim == 2 and t.shape[1] == 3 and 1 <= len(t) <= max_after_nms
                  and np.isfinite(t).all() and (t[:, 1] >= t[:, 0]).all(),
                  f"{label} {m} {r['query_id']}: bad moments {t.tolist()}")


TAN_GOLDEN_ATOL = 3e-4   # tests/test_tan_parity.py


def tan_goldens(device="cuda"):
    """The 2D-TAN fixtures on the card: tan_forward.npz and
    tan_forward_stride2.npz through the port's model (map mask exact, scores
    atol 3e-4; the stride-2 top-1 decode atol 1e-5, through the pipeline's
    own cell selection on the card, from the fixture's scores as
    tests/test_tan_parity.py decodes them), then tan_train_trajectory.npz
    replayed for its 4 steps (cone_tpu_torch/tools/golden_tan_train.py:
    losses and grad norm 2e-3 relative, weights 5e-4 absolute, each
    parameter's update 1e-3 relative in norm)."""
    import numpy as np
    import torch

    from cone_tpu_torch.config import TanConfig
    from cone_tpu_torch.convert import load_reference_tan_state_dict
    from cone_tpu_torch.eval.tan_pipeline import top_k_ref_order
    from cone_tpu_torch.models.tan import ConeTanModel
    from cone_tpu_torch.tools import golden_tan_train

    t0 = time.time()
    base = dict(num_clips=64, hidden_size=64, v_feat_dim=64, t_feat_dim=48, txt_hidden_size=64,
                map_hidden_sizes=(64, 64, 64, 64))
    errs = {}
    for name, kw in (("tan_forward", {}),
                     ("tan_forward_stride2", dict(frame_kernel=2, frame_stride=2,
                                                  adapter_module="none"))):
        g = dict(np.load(os.path.join(REPO, "tests", "golden", name + ".npz")).items())
        model = ConeTanModel(TanConfig(**base, **kw), device=device)
        model.load_state_dict(load_reference_tan_state_dict(
            {k: v for k, v in g.items() if k.startswith("w::")}))
        with torch.no_grad():
            scores, mask = model(*(torch.from_numpy(g[k]).to(device)
                                   for k in ("tok", "tok_mask", "vis")))
        check(np.array_equal(mask.cpu().numpy(), g["map_mask"]), f"{name}: map mask differs")
        errs[name] = float(np.abs(scores.cpu().numpy() - g["scores"]).max())
        check(errs[name] <= TAN_GOLDEN_ATOL, f"{name}: scores off by {errs[name]}")
        if "decoded_top1" in g:
            masked = torch.where(torch.from_numpy(g["map_mask"]).to(device) > 0,
                                 torch.from_numpy(g["scores"]).to(device), -torch.inf)
            _, idx = top_k_ref_order(masked.reshape(len(g["scores"]), -1), 1)
            cells = torch.stack([idx // 64, idx % 64 + 1], dim=-1).float()
            dec = ((cells * 2 + int(g["video_start"])) * float(g["clip_len"]))[:, 0]
            errs["decoded_top1"] = float(np.abs(dec.cpu().numpy() - g["decoded_top1"]).max())
            check(errs["decoded_top1"] <= 1e-5, f"{name}: decode off by {errs['decoded_top1']}")
    worst = golden_tan_train.check(device=device)
    print(f"golden tan_forward.npz / tan_forward_stride2.npz on {device}: map masks exact, "
          f"scores max abs err {errs['tan_forward']:.2e} / {errs['tan_forward_stride2']:.2e} "
          f"(<= {TAN_GOLDEN_ATOL}), stride-2 decode {errs['decoded_top1']:.1e} (<= 1e-5); "
          f"tan_train_trajectory.npz 4 steps: worst loss err {worst['losses']:.2e} (< "
          f"{golden_tan_train.LIMITS['losses']} rel), grad norm {worst['grad_norm']:.2e}, "
          f"weights {worst['weights']:.2e} (< {golden_tan_train.LIMITS['weights']} abs, "
          f"{worst['worst_weight']}), updates {worst['update']:.2e} (< "
          f"{golden_tan_train.LIMITS['update']} rel, {worst['worst_update']}), "
          f"{time.time() - t0:.1f} s", flush=True)
    return dict(goldens=errs, train_trajectory=worst)


def tan_corpus(cfg, n_videos, qpv, seed):
    """A planted-signal synthetic corpus at the TAN preset's widths: videos
    and query CLS at v_appear_feat_dim, token features at t_feat_dim (768-d
    RoBERTa at tan_ego4d), ctx_l 2 240-2 245."""
    import numpy as np

    from cone_tpu_torch.data import InMemoryArrayStore, TextFeatureStore
    from cone_tpu_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset(cfg.data, n_videos=n_videos, queries_per_video=qpv,
                                ctx_l_range=(2240, 2246), dim=cfg.model.v_appear_feat_dim,
                                signal=3.0, seed=seed)
    rng = np.random.default_rng(seed + 1)
    toks = {e.query_id: rng.normal(size=(len(ds.text.get_tokens(e.query_id)),
                                          cfg.model.t_feat_dim)).astype(np.float32)
            for e in ds.examples}
    ds.text = TextFeatureStore(InMemoryArrayStore(toks), ds.text.cls)
    return ds


def _device_us(evt, self_only):
    name = ("self_" if self_only else "") + "device_time_total"
    t = getattr(evt, name, None)
    return getattr(evt, name.replace("device", "cuda")) if t is None else t


def device_breakdown(fn):
    """torch.profiler over one call of fn: (wall s with the profiler on,
    device s, {op: device s of the kernels it launched itself} for the
    convolution, LSTM and linear ops, the key_averages table). Self time:
    an op's total also counts the profiler's "Command Buffer Full" spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    avgs = prof.key_averages()
    busy = sum(_device_us(e, True) for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    ops = {}
    for e in avgs:
        if e.key in ("aten::cudnn_convolution", "aten::convolution_backward", "aten::_cudnn_rnn",
                     "aten::_cudnn_rnn_backward", "aten::addmm", "aten::mm", "aten::bmm"):
            ops[e.key] = _device_us(e, True) / 1e6
    return wall, busy, ops, avgs.table(sort_by="self_cuda_time_total", row_limit=12)


def tan_inference_phase(card, device="cuda"):
    """Fused 2D-TAN inference at tan_ego4d's full width (hidden 256, a
    3-layer LSTM of 256 over 768-d tokens, 256-d video, 64x64 map of 1 104
    valid cells, four 9x9 map convs of 256 channels, topk_window 20,
    PRE_NMS_POOL 128, proposal_top_k 10), random seeded weights under the
    reference's CONE_TAN names, the coarse kernel on (stride 32), over 2
    videos x 8 queries at ctx_l about 2 240 with query_chunk 8: 160 windows
    a dispatch, 2 dispatches a run (the cut is in queries: about 40 TFLOP a
    dispatch). Checks: one coarse launch per dispatch, well-formed moments,
    kernel-on vs kernel-off ranklists (near-tie flips counted), fused vs
    staged within the parity limits. Returns (measurements, launches)."""
    import numpy as np
    import torch

    from cone_tpu_torch.config import tan_ego4d_config
    from cone_tpu_torch.convert import load_reference_tan_state_dict, random_reference_tan_state_dict
    from cone_tpu_torch.eval.pipeline import make_pipeline
    from cone_tpu_torch.eval.tan_pipeline import TanInferencePipeline
    from cone_tpu_torch.models.tan import ConeTanModel
    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.ops.windows import num_windows

    cfg = tan_ego4d_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, dset_name="synthetic"),
                      eval=dataclasses.replace(cfg.eval, query_chunk=8, use_pallas_coarse=True))
    n_videos, qpv = 2, 8
    t0 = time.time()
    ds = tan_corpus(cfg, n_videos, qpv, seed=0)
    model = ConeTanModel(cfg.tan, device=device)
    model.load_state_dict(load_reference_tan_state_dict(
        random_reference_tan_state_dict(cfg.tan, seed=0)))
    pipe = make_pipeline(model, ds, cfg, device=device)
    check(isinstance(pipe, TanInferencePipeline), "make_pipeline built no TAN pipeline")
    dispatches = n_videos * -(-qpv // cfg.eval.query_chunk)
    windows = dispatches * cfg.eval.query_chunk * cfg.data.topk_window
    print(f"TAN path: tan_ego4d full width (hidden {cfg.tan.hidden_size}, LSTM "
          f"{cfg.tan.lstm_layers}x{cfg.tan.txt_hidden_size} over {cfg.tan.t_feat_dim}-d tokens, "
          f"{cfg.tan.num_clips}x{cfg.tan.num_clips} map with {int(model.map_mask.sum())} cells, "
          f"map convs {cfg.tan.map_kernel_sizes} x {cfg.tan.map_hidden_sizes}; topk_window "
          f"{cfg.data.topk_window}, proposal_top_k {cfg.tan.proposal_top_k}, coarse stride "
          f"{pipe.stride}), {n_videos} videos x {qpv} queries, ctx_l "
          f"{[len(ds.video_features(v)[0]) for v in ds.video_ids]}, {windows} windows a run, "
          f"set-up {time.time() - t0:.1f} s", flush=True)

    co.coarse_segment_max.launches = 0
    t0 = time.time()
    subs, ranklists = pipe.run(host_postproc=False, fused=True)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = co.coarse_segment_max.launches
    check(launches == dispatches,
          f"TAN path launched coarse_segment_max {launches} times, want {dispatches}")
    n_q = len(ds.examples)
    well_formed_runs(subs, n_q, cfg.eval.max_after_nms, "TAN path")
    for e in ds.examples:
        n_win = num_windows(len(ds.video_features(e.clip_id)[0]), pipe.stride)
        check(sorted(ranklists[e.query_id]) == list(range(n_win)),
              f"{e.query_id}: ranklist is not a permutation of the {n_win} windows")
    walls = []
    for _ in range(2):
        t0 = time.time()
        pipe.run(host_postproc=False, fused=True)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    prof_wall, busy, ops, table = device_breakdown(
        lambda: pipe.run(host_postproc=False, fused=True))
    conv_s = ops.get("aten::cudnn_convolution", 0.0)
    print(table)
    print(f"TAN fused run: first {first_s:.3f} s, warm {[round(w, 4) for w in walls]} s "
          f"({n_q} queries, {dispatches} dispatches, {launches} coarse launches); profiled run: "
          f"wall {prof_wall:.4f} s, device {busy:.4f} s (busy share {busy / prof_wall:.3f}), "
          f"convolutions {conv_s:.4f} s ({conv_s / busy if busy else float('nan'):.3f} of the "
          f"device), LSTM {ops.get('aten::_cudnn_rnn', 0.0):.4f} s [{card}]", flush=True)

    cfg_off = cfg.replace(eval=dataclasses.replace(cfg.eval, use_pallas_coarse=False))
    _, ranklists_off = make_pipeline(model, ds, cfg_off, device=device).run(
        host_postproc=False, fused=True)
    same, flips = near_tie_flips(make_pipeline(model, ds, cfg_off, device=device), ds,
                                 ranklists, ranklists_off)
    # the staged path with the device post-processing (the fused path's float32
    # NMS). Map cells sit on a clip grid: spans of 32 and 64 clips from one
    # start have an IoU of exactly 0.5 = nms_thd, where the host's float64 NMS
    # and the device's float32 one may decide `iou > nms_thd` apart, so the
    # host path is counted, not held (tests/test_torch_tan_pipeline.py)
    subs_d, ranklists_d = pipe.run(host_postproc=False)
    check(ranklists_d == ranklists, "TAN staged ranklists differ from fused")
    worst = [0.0, 0.0]
    by_qid = {r["query_id"]: np.asarray(r["predicted_times"], np.float64) for r in subs_d["fusion"]}
    for r in subs["fusion"]:
        got, want = np.asarray(r["predicted_times"], np.float64), by_qid[r["query_id"]]
        check(got.shape == want.shape, f"TAN {r['query_id']}: {got.shape} fused vs {want.shape}")
        worst = [max(worst[0], float(np.abs(got[:, :2] - want[:, :2]).max())),
                 max(worst[1], float(np.abs(got[:, 2] - want[:, 2]).max()))]
    check(worst[0] <= SPAN_ATOL and worst[1] <= SCORE_ATOL,
          f"TAN fused vs staged: span err {worst[0]}, score err {worst[1]}")
    subs_h, _ = pipe.run(host_postproc=True)
    host_same = 0
    for m, col in (("fusion", 4), ("proposal", 2), ("matching", 3)):
        fused_rows = {r["query_id"]: np.asarray(r["predicted_times"], np.float64) for r in subs[m]}
        for r in subs_h[m]:
            want, got = np.asarray(r["predicted_times"], np.float64), fused_rows[r["query_id"]]
            host_same += bool(got.shape[0] == want.shape[0]
                              and np.abs(got[:, :2] - want[:, :2]).max() <= SPAN_ATOL
                              and np.abs(got[:, 2] - want[:, col]).max() <= SCORE_ATOL)
    print(f"TAN ranklists kernel on vs off: {same}/{n_q} identical, {flips} near-tie flips; "
          f"fused vs staged device postproc: max span err {worst[0]:.2e} (<= {SPAN_ATOL}), max "
          f"score err {worst[1]:.2e} (<= {SCORE_ATOL}); host postproc agrees on {host_same} of "
          f"{3 * n_q} (query, modality) rows", flush=True)
    del pipe, model
    torch.cuda.empty_cache()
    return dict(first_run_s=first_s, warm_run_s=walls, profiled_wall_s=prof_wall,
                device_s=busy, conv_device_s=conv_s, conv_share=conv_s / busy if busy else None,
                lstm_device_s=ops.get("aten::_cudnn_rnn", 0.0), windows_per_run=windows,
                dispatches=dispatches, near_tie_flips=flips, fused_vs_staged=worst,
                host_rows_agreeing=host_same, rows=3 * n_q), launches


def tan_training_phase(card, device="cuda"):
    """`train` at the tan_ego4d preset as `train --preset tan_ego4d
    --synthetic --debug` resolves it (synthetic tokens at the video width,
    8 videos x 8 queries), bsz 32: 2 epochs of 2 steps, the adapter on from
    the second (both step variants), one eval epoch through the coarse
    kernel (debug: one query chunk, one dispatch) with the eval-split
    losses and a plateau step. Checks: finite losses, one coarse launch,
    the plateau state in the `latest` checkpoint, the module back in train
    mode. Returns (measurements, coarse launches)."""
    import numpy as np
    import torch

    from cone_tpu_torch.config import tan_ego4d_config
    from cone_tpu_torch.data.synthetic import make_synthetic_dataset
    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.train.loop import train

    cfg = tan_ego4d_config()
    dim = cfg.model.v_appear_feat_dim
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, t_feat_dim=dim),
        tan=dataclasses.replace(cfg.tan, t_feat_dim=dim),
        data=dataclasses.replace(cfg.data, dset_name="synthetic"),
        train=dataclasses.replace(cfg.train, n_epoch=2, eval_epoch_interval=2,
                                  start_epoch_for_adapter=1, debug=True),
        eval=dataclasses.replace(cfg.eval, query_chunk=8, use_pallas_coarse=True))
    ds = make_synthetic_dataset(cfg.data, n_videos=8, queries_per_video=8, dim=dim, seed=0)
    with tempfile.TemporaryDirectory() as workdir:
        co.coarse_segment_max.launches = 0
        t0 = time.time()
        model, history = train(cfg, ds, ds, workdir, device=device)
        torch.cuda.synchronize()
        train_s = time.time() - t0
        launches = co.coarse_segment_max.launches
        check(model.training, "the TAN module is not in train mode after the eval epoch")
        check(len(history) == 2 and all(len(h["step_times"]) == 2 for h in history),
              f"history: {[(h['epoch'], len(h['step_times'])) for h in history]}")
        for h in history:
            bad = {k: v for k, v in h.items() if k.startswith(("loss", "eval_loss", "grad_norm"))
                   and not np.isfinite(v)}
            check(not bad, f"TAN epoch {h['epoch']}: non-finite {bad}")
        check("loss_adapter" not in history[0] and "loss_adapter" in history[1],
              "the adapter term is not off in epoch 1 and on in epoch 2")
        check(launches == 1, f"TAN eval epoch launched coarse_segment_max {launches} times, want 1")
        check(history[1]["eval_loss_overall"] > 0 and "lr" in history[1],
              "the TAN eval epoch logged no eval losses or lr")
        extra = torch.load(os.path.join(workdir, "model_latest.ckpt"), map_location="cpu",
                           weights_only=True)["extra"]
        check({"plateau_best", "plateau_num_bad"} <= set(extra),
              f"no plateau state in the latest checkpoint: {extra}")
    # one more step, profiled: device time and the convolutions' share
    from cone_tpu_torch.data.dataset import TrainLoader
    from cone_tpu_torch.train.optim import make_tan_optimizer
    from cone_tpu_torch.train.step import batch_to_device, to_floats
    from cone_tpu_torch.train.tan_step import make_tan_train_step

    step = make_tan_train_step(model, make_tan_optimizer(model, cfg.train)[0], cfg.tan,
                               cfg.loss.neg_loss, cfg.loss.adapter_loss_coef)
    batch = batch_to_device(next(TrainLoader(ds, bsz=cfg.train.bsz, seed=1).epoch(0)), device)
    to_floats(step(batch, True))   # warm: the new optimizer's state
    prof_wall, busy, ops, table = device_breakdown(lambda: to_floats(step(batch, True)))
    conv_s = ops.get("aten::cudnn_convolution", 0.0) + ops.get("aten::convolution_backward", 0.0)
    print(table)
    print(f"TAN train step, profiled: wall {prof_wall:.4f} s, device {busy:.4f} s (busy share "
          f"{busy / prof_wall:.3f}), convolutions forward and backward {conv_s:.4f} s "
          f"({conv_s / busy if busy else float('nan'):.3f} of the device) [{card}]", flush=True)
    steps = [t for h in history for t in h["step_times"]]
    warm = history[1]["step_times"]
    print(f"train --preset tan_ego4d (synthetic, bsz {cfg.train.bsz}): 2 epochs of 2 steps in "
          f"{train_s:.2f} s; losses finite, bce {history[0]['loss_bce']:.4f} -> "
          f"{history[1]['loss_bce']:.4f}, adapter {history[1]['loss_adapter']:.4f} in epoch 2; "
          f"eval epoch {history[1]['eval_seconds']:.3f} s with {launches} coarse launch, stop "
          f"score {extra['best_score']:.3f}, plateau best {extra['plateau_best']:.3f}, lr "
          f"{history[1]['lr']:.2e}; step times (host clock, each ends in reading its metrics): "
          f"first {steps[0] * 1e3:.2f} ms, warm {[round(t * 1e3, 2) for t in warm]} ms [{card}]",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return dict(first_step_ms=steps[0] * 1e3, warm_step_ms=[t * 1e3 for t in warm],
                train_seconds=train_s, eval_seconds=history[1]["eval_seconds"],
                profiled_step_wall_s=prof_wall, step_device_s=busy, step_conv_device_s=conv_s,
                step_conv_share=conv_s / busy if busy else None), launches


PAR_WORLD1_RTOL = 1e-6                 # one rank over NCCL: the same arithmetic
PAR_RTOL = 2e-4                        # tests/test_multiprocess.py:140-160


def _rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _median_warm_ms(step_ms, per_epoch):
    import numpy as np

    return float(np.median(step_ms[per_epoch:]))


def parallel_phase(card):
    """Data parallelism on the card at the Ego4D preset's full width (hidden
    256, 8 heads, 2+2 layers, FFN 1024, 256-d features), bsz 32, 2 epochs x
    2 steps and one eval epoch through the coarse kernel.
    (a) `train --distributed` (127.0.0.1 rendezvous, one rank: NCCL) against
    `train` without it, through the CLI in this process on its synthetic
    set, dropouts 0: losses and weights within 1e-6 relative. (b) two ranks
    on cuda:0 over gloo, spawned as cone_tpu_torch/tools/dist_worker.py
    processes, against dist_worker.run in this process with no group (8
    videos x 8 queries of 1 500-2 304 clips), at the preset's dropouts (0.1,
    input 0.5): the masks are drawn for the global batch and each rank keeps
    its rows. A failed rank fails the phase. (c) the
    step's time with and without a one-rank NCCL group, 10 warm steps a
    variant taken in turns (cone_tpu_torch/tools/bench_dp_step.py). Returns
    (measurements, coarse launches by run)."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from cone_tpu_torch import cli
    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.parallel import distributed
    from cone_tpu_torch.tools import bench_dp_step, dist_worker

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    t_phase = time.time()
    sets = ["model.dropout=0", "model.input_dropout=0", "train.bsz=32", "train.n_epoch=2",
            "train.eval_epoch_interval=2", "train.start_epoch_for_adapter=1",
            "eval.use_pallas_coarse=true", "data.dset_name=synthetic"]
    argv = ["train", "--synthetic", "--device", "cuda"] + [x for kv in sets
                                                           for x in ("--set", kv)]
    meas, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) one rank over NCCL against no group
        runs = {}
        for tag, extra in (("plain", []), ("nccl_world1", [
                "--distributed", "--coordinator", f"127.0.0.1:{free_port()}",
                "--num_processes", "1", "--process_id", "0"])):
            wd = os.path.join(tmp, tag)
            co.coarse_segment_max.launches = 0
            model, history = cli.main(argv + ["--workdir", wd] + extra)
            launches[tag] = co.coarse_segment_max.launches
            check(not dist.is_initialized(), f"{tag}: the CLI left its process group open")
            with open(os.path.join(wd, "metrics.jsonl")) as f:
                parallel = json.loads(f.readline())["parallel"]
            state = torch.load(os.path.join(wd, "model_latest.ckpt"), weights_only=True)["model"]
            runs[tag] = dict(history=history, parallel=parallel, state=state,
                             grad_numel=sum(p.numel() for p in model.parameters()
                                            if p.grad is not None))
            del model
        plain, one = runs["plain"], runs["nccl_world1"]
        check(plain["parallel"] == {"world_size": 1, "backend": None}
              and one["parallel"] == {"world_size": 1, "backend": "nccl"},
              f"layouts {plain['parallel']} / {one['parallel']}")
        loss_err = max(_rel(hn[k], hp[k]) for hp, hn in zip(plain["history"], one["history"])
                       for k in hp if k.startswith(("loss", "eval_loss", "grad_norm")))
        w_err = max(float((one["state"][k] - v).abs().max()) / max(1.0, float(v.abs().max()))
                    for k, v in plain["state"].items())
        n_eval = 8   # the CLI's synthetic set: 8 videos of 8 queries, one query chunk each
        check(launches["plain"] == launches["nccl_world1"] == n_eval,
              f"coarse launches {launches}, want {n_eval} (one per eval dispatch)")
        check(loss_err <= PAR_WORLD1_RTOL and w_err <= PAR_WORLD1_RTOL,
              f"world-1 NCCL vs non-distributed: losses {loss_err}, weights {w_err}")
        dev = distributed.initialize(num_processes=1, process_id=0, device="cuda")
        try:
            nccl_ms = dist_worker.allreduce_ms(one["grad_numel"], dev)
        finally:
            distributed.shutdown()
        meas["world1_nccl"] = dict(
            max_rel_err_losses=loss_err, max_rel_err_weights=w_err,
            step_ms_plain=_median_warm_ms([t * 1e3 for h in plain["history"]
                                           for t in h["step_times"]], 2),
            step_ms_nccl_world1=_median_warm_ms([t * 1e3 for h in one["history"]
                                                 for t in h["step_times"]], 2),
            allreduce_bytes=4 * one["grad_numel"], allreduce_ms=nccl_ms,
            coarse_launches=launches["nccl_world1"], dispatches=n_eval)
        print(f"parallel (a): train --distributed, one rank over NCCL vs train: losses, "
              f"criterion terms and grad norms max rel err {loss_err:.2e}, weights "
              f"{w_err:.2e} (<= {PAR_WORLD1_RTOL}); coarse launches {launches} for {n_eval} "
              f"dispatches each", flush=True)

        # (b) two ranks sharing the card over gloo, against one process
        single = dist_worker.run("ego4d", torch.device("cuda"), os.path.join(tmp, "single"))
        launches["single"] = single["train_launches"] + single["eval_launches"]
        prefix = os.path.join(tmp, "ranks")
        port = free_port()
        env = dict(os.environ, PYTHONPATH=REPO)
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "cone_tpu_torch.tools.dist_worker", "--out", prefix,
             "--width", "ego4d", "--device", "cuda", "--coordinator", f"127.0.0.1:{port}",
             "--num_processes", "2", "--process_id", str(i), "--timeout_s", "300"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(2)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.time() - t0
        for i, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"rank {i} exited {p.returncode}:\n{log[-4000:]}")
        a, b = (json.load(open(f"{prefix}.{i}.json")) for i in range(2))

    for r in (a, b):
        check(r["backend"] == "gloo" and r["device"] == "cuda:0"
              and r["world"] == 2,
              f"rank {r['rank']}: {r['backend']} on {r['device']}, world {r['world']}")
        check(r["train_launches"] == r["eval_launches"] == r["dispatches"],
              f"rank {r['rank']}: coarse launches train {r['train_launches']} / eval "
              f"{r['eval_launches']}, want {r['dispatches']} (its dispatches)")
        launches[f"gloo_rank{r['rank']}"] = r["train_launches"] + r["eval_launches"]
    agree = max(_rel(a[k], b[k]) for k in ("losses", "grad_norms", "param_sum"))
    check(agree <= PAR_WORLD1_RTOL and a["corpus_hits"] == b["corpus_hits"]
          and a["rows"] == b["rows"] and a["ranklists"] == b["ranklists"],
          f"the two ranks disagree (losses/grad norms/weights {agree})")
    vs_single = {k: _rel(a[k], single[k]) for k in ("losses", "grad_norms", "param_sum")}
    check(max(vs_single.values()) <= PAR_RTOL, f"2 ranks vs one process: {vs_single}")

    # the gathered evaluation against the single run's
    n_q = len(single["ranklists"])
    span_err = score_err = 0.0
    flips = 0
    for m, rows in single["rows"].items():
        check(set(a["rows"][m]) == set(rows) and len(rows) == n_q,
              f"{m}: {len(a['rows'][m])} gathered rows for {n_q} queries")
        for q, want in rows.items():
            got, want = np.asarray(a["rows"][m][q]), np.asarray(want)
            check(got.shape == want.shape, f"{m} {q}: {got.shape} vs {want.shape}")
            if got.size:
                span_err = max(span_err, float(np.abs(got[:, :2] - want[:, :2]).max()))
                score_err = max(score_err, float(np.abs(got[:, 2] - want[:, 2]).max()))
    check(span_err <= SPAN_ATOL and score_err <= SCORE_ATOL,
          f"gathered eval vs single: spans {span_err}, scores {score_err}")
    for q, want in single["ranklists"].items():
        got = a["ranklists"][q]
        if got != want:   # only near-ties may swap: the single run's scores in this order
            s = np.asarray(single["window_scores"][q])[got]
            check(bool((s[:-1] >= s[1:] - REL_TOL * np.maximum(1.0, np.abs(s[1:]))).all()),
                  f"{q}: gathered ranklist differs beyond near-ties")
            flips += sum(x != y for x, y in zip(got, want))
    # the rank-sharded library against the whole library
    lib_span = lib_fused = 0.0
    for got, want in zip(a["corpus_hits"], single["corpus_hits"]):
        check([g[0] for g in got] == [w[0] for w in want], "sharded library: video order")
        for g, w in zip(got, want):
            lib_span = max(lib_span, abs(g[1] - w[1]), abs(g[2] - w[2]))
            lib_fused = max(lib_fused, abs(g[3] - w[3]))
    check(len(a["corpus_hits"]) == len(single["corpus_hits"]) and lib_span <= 1e-4
          and lib_fused <= 1e-3, f"sharded library: spans {lib_span}, fused {lib_fused}")

    meas["world2_gloo_shared_card"] = dict(
        note="two ranks sharing one card over gloo: a correctness run, not a scaling figure",
        ranks_agree_max_rel=agree, vs_single_max_rel=vs_single, eval_span_err=span_err,
        eval_score_err=score_err, ranklist_near_tie_flips=flips, library_span_err=lib_span,
        library_fused_err=lib_fused, step_ms_single=_median_warm_ms(single["step_ms"], 2),
        step_ms_rank0=_median_warm_ms(a["step_ms"], 2),
        step_ms_rank1=_median_warm_ms(b["step_ms"], 2), allreduce_bytes=a["allreduce_bytes"],
        allreduce_ms_rank0=a["allreduce_ms"], allreduce_ms_rank1=b["allreduce_ms"],
        dispatches={0: a["dispatches"], 1: b["dispatches"]}, ranks_wall_s=ranks_s)
    w1, w2 = meas["world1_nccl"], meas["world2_gloo_shared_card"]
    print(f"parallel (b): 2 gloo ranks on cuda:0, 16 rows each: ranks agree within {agree:.1e}; "
          f"vs one process losses {vs_single['losses']:.2e}, grad norms "
          f"{vs_single['grad_norms']:.2e}, weights {vs_single['param_sum']:.2e} (<= {PAR_RTOL}); "
          f"gathered eval {n_q} queries, spans {span_err:.2e}, scores {score_err:.2e}, "
          f"{flips} near-tie ranklist flips; sharded library spans {lib_span:.1e}, fused "
          f"{lib_fused:.1e}; coarse launches == dispatches on each rank "
          f"({a['dispatches']}, {b['dispatches']})", flush=True)
    print(f"parallel timings [{card}] (host clock, median of the 2 warm steps of epoch 2 "
          f"in each run): ms per step "
          f"non-distributed {w1['step_ms_plain']:.2f} (CLI set) / {w2['step_ms_single']:.2f} "
          f"(worker set), world-1 NCCL {w1['step_ms_nccl_world1']:.2f}, world-2 gloo on one "
          f"card {w2['step_ms_rank0']:.2f} / {w2['step_ms_rank1']:.2f} (a correctness run, not "
          f"a scaling figure); gradient all-reduce {w1['allreduce_bytes']} bytes: NCCL world 1 "
          f"{w1['allreduce_ms']:.3f} ms, gloo world 2 {w2['allreduce_ms_rank0']:.3f} ms; "
          f"phase so far {time.time() - t_phase:.1f} s", flush=True)

    # the step's time with and without the group, over more steps, in turns
    t0 = time.time()
    turns = bench_dp_step.run(steps=5, rounds=2, device="cuda", profile=False)
    check(turns["backend"] == "nccl", f"bench_dp_step's group: {turns['backend']}")
    meas["step_in_turns"] = {k: turns[k] for k in (
        "steps_per_variant", "step_ms_median", "step_ms_min", "collectives", "pieces_ms")}
    med = turns["step_ms_median"]
    print(f"parallel step in turns [{card}] (cone_tpu_torch/tools/bench_dp_step.py, "
          f"{turns['steps_per_variant']} warm steps a variant, host clock): median ms plain "
          f"{med['plain']:.2f}, data-parallel path without collectives {med['noop']:.2f}, "
          f"world-1 NCCL gradient all-reduce only {med['group_grads']:.2f}, world-1 NCCL "
          f"{med['group']:.2f}; collectives {turns['collectives']}; {time.time() - t0:.1f} s; "
          f"phase {time.time() - t_phase:.1f} s", flush=True)
    return meas, launches


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)   # CLIP's image normalisation
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
TOWER_TOL = 1e-4          # card vs CPU, projected features: times max(1, largest |feature|)
EGOVLP_GOLDEN_ATOL = 2e-4   # tests/test_egovlp_parity.py


class WordHashTokenizer:
    """A stand-in for CLIP's tokenizer at its real ids (bos 49406, eos
    49407, context 77; words crc32-hashed into 1..49405, pad 0), called as
    a transformers tokenizer is, with neither transformers nor vocabulary
    files installed."""

    bos, eos, vocab = 49406, 49407, 49405

    def __init__(self, context=77):
        self.context = context

    def __call__(self, texts, padding=True, max_length=None, truncation=True,
                 return_tensors="np"):
        import zlib

        import numpy as np

        cap = max_length or self.context
        rows = []
        for t in texts:
            ids = [self.bos] + [zlib.crc32(w.encode()) % self.vocab + 1
                                for w in t.lower().split()] + [self.eos]
            rows.append(ids[: cap - 1] + [self.eos] if truncation and len(ids) > cap else ids)
        width = cap if padding == "max_length" else max(map(len, rows))
        ids = np.zeros((len(rows), width), np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)], mask[i, : len(r)] = r, 1
        out = {"input_ids": ids, "attention_mask": mask}
        if return_tensors == "pt":
            import torch

            out = {k: torch.from_numpy(v) for k, v in out.items()}
        return out


def clip_processor(images, return_tensors="np"):
    """CLIP's image processor for frames already decoded at 224 x 224:
    rescale to [0, 1], normalise with CLIP's mean and std, NCHW."""
    import numpy as np

    x = np.stack(images).astype(np.float32) / 255.0
    x = (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)
    return {"pixel_values": np.ascontiguousarray(x.transpose(0, 3, 1, 2))}


def vit_flops(tokens, dim, mlp, layers):
    """Operations of a pre-LN ViT's blocks: q, k, v, out projections, the
    MLP, and the two attention products over all tokens."""
    return layers * (8 * tokens * dim * dim + 4 * tokens * dim * mlp + 4 * tokens * tokens * dim)


def clip_image_flops(c):
    n = (c.image_size // c.patch_size) ** 2
    return (vit_flops(n + 1, c.hidden_size, c.intermediate_size, c.num_layers)
            + 2 * n * 3 * c.patch_size ** 2 * c.hidden_size + 2 * c.hidden_size * c.projection_dim)


def clip_query_flops(c):
    return (vit_flops(c.context_length, c.hidden_size, c.intermediate_size, c.num_layers)
            + 2 * c.hidden_size * c.projection_dim)


def egovlp_clip_flops(c):
    """Operations of one clip through the divided space-time tower: two
    attentions' projections and the MLP over every token, the temporal
    groups (n groups of f queries over f + 1 keys), the spatial ones (f
    groups of n over n + 1), the CLS rows over every token, the patch
    embedding and the projection."""
    n, f, d = (c.img_size // c.patch_size) ** 2, c.num_frames, c.embed_dim
    t, mlp = 1 + f * n, int(d * c.mlp_ratio)
    attn = 4 * d * (n * f * (f + 1) + f * n * (n + 1) + 2 * t)
    block = 16 * t * d * d + 4 * t * d * mlp + attn
    return (c.depth * block + 2 * f * n * 3 * c.patch_size ** 2 * d
            + 2 * d * c.projection_dim)


def _param_bytes(module):
    return 4 * sum(p.numel() for p in module.parameters())


def _bound_ms(nbytes, flops, peaks):
    t_bytes, t_ops = nbytes / peaks["bytes"] * 1e3, flops / peaks["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _card_vs_cpu(got, want, label):
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{label}: {got.shape} vs {want.shape}")
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    check(err <= TOWER_TOL * scale,
          f"{label}: card vs CPU max abs err {err} > {TOWER_TOL} x {scale}")
    return err, scale


def _descends(scores, order, tol=REL_TOL):
    import numpy as np

    s = np.asarray(scores)[list(order)]
    return bool((s[:-1] >= s[1:] - tol * np.maximum(1.0, np.abs(s[1:]))).all())


def towers_phase(card, peaks):
    """The feature towers and the demo path on the card (module docstring,
    phase 10). Returns (measurements, coarse launches of the demo, the
    (B, L, Q, D, stride, ctx_l) the demo launched the coarse kernel at)."""
    import shutil
    import urllib.request

    import numpy as np
    import torch

    import cone_tpu_torch.eval.pipeline as pipeline_mod
    from cone_tpu_torch.config import mad_config
    from cone_tpu_torch.convert import (
        egovlp_state_dict, load_reference_state_dict, random_clip_text_state_dict,
        random_clip_vision_state_dict, random_egovlp_state_dict, random_reference_state_dict)
    from cone_tpu_torch.data.store import PackedArrayStore
    from cone_tpu_torch.extract import video as xv
    from cone_tpu_torch.extract.egovlp_video import egovlp_clips, extract_egovlp_video
    from cone_tpu_torch.extract.text import clip_text_encoder
    from cone_tpu_torch.models.clip import (
        ClipTextConfig, ClipTextTower, ClipVisionConfig, ClipVisionTower)
    from cone_tpu_torch.models.cone import ConeModel
    from cone_tpu_torch.models.egovlp import EgoVlpConfig, EgoVlpVideoTower
    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.serve.localizer import OnlineLocalizer
    from cone_tpu_torch.serve.predictor import MomentPredictor
    from cone_tpu_torch.serve.server import MomentService, make_server
    from cone_tpu_torch.ops.windows import num_windows, window_scores_from_frame_scores
    from cone_tpu_torch.utils.device import cuda_ms
    from cone_tpu_torch.utils.io import l2_normalize

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    t_phase = time.time()
    meas = {}
    rng = np.random.default_rng(0)

    def pair(tower_cls, cfg, sd):
        out = []
        for d in (dev, "cpu"):
            m = tower_cls(cfg, device=d)
            m.load_state_dict(load_reference_state_dict(sd))
            out.append(m.eval())
        return out

    # (a) CLIP ViT-B/32 and the text tower at full width, seeded HF-layout weights
    vcfg, tcfg = ClipVisionConfig(), ClipTextConfig()
    vision, vision_cpu = pair(ClipVisionTower, vcfg, random_clip_vision_state_dict(vcfg, 0))
    text, text_cpu = pair(ClipTextTower, tcfg, random_clip_text_state_dict(tcfg, 1))
    frames = rng.integers(0, 256, (64, 224, 224, 3), np.uint8)
    px = torch.from_numpy(clip_processor(list(frames))["pixel_values"])
    with torch.inference_mode():
        got = vision(px[:4].to(dev)).cpu().numpy()
        want = vision_cpu(px[:4]).numpy()
    v_err, v_scale = _card_vs_cpu(got, want, "CLIP vision")
    tok = WordHashTokenizer()
    queries = ["a person opens the fridge door", "the car drives away down the road",
               "someone picks up a red cup from the table", "two people shake hands"]
    t_card = clip_text_encoder(text, tok, 4, dev)(queries)
    t_cpu = clip_text_encoder(text_cpu, tok, 4, "cpu")(queries)
    c_err, c_scale = _card_vs_cpu(t_card[1], t_cpu[1], "CLIP text cls")
    k_err = max(_card_vs_cpu(a, b, "CLIP text tokens")[0] for a, b in zip(t_card[0], t_cpu[0]))
    px64 = px.to(dev)
    with torch.inference_mode():
        v_ms = cuda_ms(lambda: vision(px64), 5, warmup=2)
    img_flops = clip_image_flops(vcfg)
    v_bound, v_by = _bound_ms(
        _param_bytes(vision) + px64.numel() * 4 + 64 * vcfg.projection_dim * 4,
        64 * img_flops, peaks)
    ids = torch.from_numpy(tok(queries * 16, padding="max_length")["input_ids"]).to(dev)
    eot = (ids != 0).sum(1) - 1
    with torch.inference_mode():
        t_ms = cuda_ms(lambda: text(ids, eot), 5, warmup=2)
    t_bound, t_by = _bound_ms(_param_bytes(text) + ids.numel() * 8
                              + 64 * tcfg.context_length * tcfg.hidden_size * 4,
                              64 * clip_query_flops(tcfg), peaks)
    meas["clip"] = dict(vision_err=v_err, vision_scale=v_scale, text_cls_err=c_err,
                        text_token_err=k_err, tol=TOWER_TOL, image_gflop=img_flops / 1e9,
                        query_gflop=clip_query_flops(tcfg) / 1e9, batch64_ms=v_ms,
                        frames_per_s=64 / v_ms * 1e3, bound_ms=v_bound, bound_by=v_by,
                        bound_frames_per_s=64 / v_bound * 1e3, text64_ms=t_ms,
                        queries_per_s=64 / t_ms * 1e3, text_bound_ms=t_bound)
    print(f"towers (a): CLIP vision {vcfg} and text {tcfg}, seeded HF-layout weights; card vs "
          f"CPU: image features max abs err "
          f"{v_err:.2e} (<= {TOWER_TOL} x {v_scale:.2f}) on 4 frames, text cls {c_err:.2e}, "
          f"tokens {k_err:.2e} on 4 queries; 64-frame batch {v_ms:.3f} ms -> "
          f"{64 / v_ms * 1e3:.1f} frames/s, bound {v_bound:.3f} ms ({v_by}: "
          f"{img_flops / 1e9:.2f} GFLOP an image at the float32 peak) -> "
          f"{64 / v_bound * 1e3:.1f} frames/s; 64 queries {t_ms:.3f} ms -> "
          f"{64 / t_ms * 1e3:.1f} queries/s, bound {t_bound:.3f} ms ({t_by}, "
          f"{clip_query_flops(tcfg) / 1e9:.2f} GFLOP a query); {time.time() - t_phase:.1f} s "
          f"into the phase [{card}]", flush=True)
    del vision_cpu, text_cpu, px64

    # (b) EgoVLP ViT-B/16 at full width: card vs CPU, the golden fixture, extraction
    ecfg = EgoVlpConfig()
    esd = random_egovlp_state_dict(ecfg, 2)
    ego, ego_cpu = pair(EgoVlpVideoTower, ecfg, esd)
    es = ecfg.img_size
    clips = torch.from_numpy(rng.normal(size=(8, ecfg.num_frames, 3, es, es)).astype(np.float32))
    with torch.inference_mode():
        got = ego(clips[:2].to(dev)).cpu().numpy()
        want = ego_cpu(clips[:2]).numpy()
    e_err, e_scale = _card_vs_cpu(got, want, "EgoVLP")
    del ego_cpu
    g = dict(np.load(os.path.join(REPO, "tests", "golden", "egovlp_tower.npz")).items())
    img, patch, dim, depth, heads, nf, proj = g["cfg"].tolist()
    gcfg = EgoVlpConfig(img_size=img, patch_size=patch, embed_dim=dim, depth=depth,
                        num_heads=heads, num_frames=nf, projection_dim=proj)
    gt = EgoVlpVideoTower(gcfg, device=dev)
    gt.load_state_dict(egovlp_state_dict({k[3:]: v for k, v in g.items() if k.startswith("w::")},
                                         gcfg))
    with torch.inference_mode():
        g_err = float(np.abs(gt.eval()(torch.from_numpy(g["frames"]).to(dev)).cpu().numpy()
                             - g["projected"]).max())
    check(g_err <= EGOVLP_GOLDEN_ATOL, f"golden egovlp_tower.npz on the card: {g_err}")
    x8 = clips.to(dev)
    with torch.inference_mode():
        e_ms = cuda_ms(lambda: ego(x8), 3, warmup=1)
    clip_flops = egovlp_clip_flops(ecfg)
    e_bound, e_by = _bound_ms(_param_bytes(ego) + x8.numel() * 4 + 8 * ecfg.projection_dim * 4,
                              8 * clip_flops, peaks)
    del x8
    n_clips = 64
    decoded = rng.integers(0, 256, (ecfg.num_frames * n_clips, es, es, 3), np.uint8)
    real_decode = xv.decode_frames
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "egovlp.pth")
        torch.save({"state_dict": {"module." + k: torch.from_numpy(v) for k, v in esd.items()}},
                   ckpt)
        out = os.path.join(tmp, "egovlp.cfs")
        xv.decode_frames = lambda path, fps, size=224: decoded
        try:
            t0 = time.time()
            extract_egovlp_video({"movie": "movie.mp4"}, out, ckpt, clip_batch=8, cfg=ecfg,
                                 frames_per_clip=ecfg.num_frames, device=dev)
            sync()
            x_s = time.time() - t0
        finally:
            xv.decode_frames = real_decode
        feats = PackedArrayStore(out).get("movie")
    check(feats.shape == (n_clips, ecfg.projection_dim) and np.isfinite(feats).all(),
          f"extract_egovlp_video store: {feats.shape}")
    clip0 = egovlp_clips(decoded[: ecfg.num_frames], ecfg.num_frames)   # (1, F, H, W, 3)
    with torch.inference_mode():
        first = ego(torch.from_numpy(clip0.transpose(0, 1, 4, 2, 3).copy()).to(dev)).cpu().numpy()
    x_err = float(np.abs(first[0] - feats[0]).max())
    check(x_err <= TOWER_TOL * max(1.0, float(np.abs(first).max())),
          f"the extracted first clip differs from the tower's forward by {x_err}")
    meas["egovlp"] = dict(card_vs_cpu_err=e_err, scale=e_scale, golden_err=g_err,
                          clip_gflop=clip_flops / 1e9, batch8_ms=e_ms,
                          clips_per_s=8 / e_ms * 1e3, bound_ms=e_bound, bound_by=e_by,
                          bound_clips_per_s=8 / e_bound * 1e3, extract_clips=n_clips,
                          extract_s=x_s, extract_clips_per_s=n_clips / x_s)
    print(f"towers (b): EgoVLP {ecfg} ({1 + ecfg.num_frames * (es // ecfg.patch_size) ** 2} "
          f"tokens), seeded weights; card vs CPU max abs err {e_err:.2e} (<= "
          f"{TOWER_TOL} x {e_scale:.2f}) on 2 clips; golden egovlp_tower.npz on the card "
          f"{g_err:.2e} (<= {EGOVLP_GOLDEN_ATOL}); 8-clip batch {e_ms:.3f} ms -> "
          f"{8 / e_ms * 1e3:.1f} clips/s, bound {e_bound:.3f} ms ({e_by}: "
          f"{clip_flops / 1e9:.1f} GFLOP a clip) -> {8 / e_bound * 1e3:.1f} clips/s; "
          f"extract_egovlp_video of {n_clips} clips (clip_batch 8, checkpoint file, decode "
          f"injected) {x_s:.3f} s -> {n_clips / x_s:.1f} clips/s end to end, store read back "
          f"({feats.shape}); {time.time() - t_phase:.1f} s into the phase [{card}]", flush=True)
    del ego, gt
    torch.cuda.empty_cache()

    # (c) the demo path at the MAD preset's full width, the coarse kernel on
    cfg = mad_config()
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, use_pallas_coarse=True))
    model = ConeModel(cfg.model, device=dev)
    wsd = load_reference_state_dict(random_reference_state_dict(cfg.model, seed=3))
    model.load_state_dict(wsd)
    fps, seconds = 1.0 / cfg.data.clip_length, 120
    tmp = tempfile.mkdtemp()
    try:
        movie = os.path.join(tmp, "demo.mp4")
        if shutil.which("ffmpeg"):
            subprocess.run(["ffmpeg", "-nostdin", "-loglevel", "error", "-f", "lavfi", "-i",
                            f"testsrc=duration={seconds}:size=320x240:rate=25", "-c:v",
                            "mpeg4", "-q:v", "5", movie], check=True, timeout=300)
            source = "ffmpeg decode of a lavfi testsrc clip"
            decode = None
        else:
            demo_frames = rng.integers(0, 256, (int(seconds * fps), 224, 224, 3), np.uint8)
            decode = lambda path, fps_, size=224: demo_frames   # noqa: E731
            source = "seeded frames injected at extract.video.decode_frames (no ffmpeg on PATH)"
        decode_calls = []
        inner = decode or real_decode

        def counted(path, fps_, size=224):
            t0 = time.time()
            out = inner(path, fps_, size)
            decode_calls.append(time.time() - t0)
            return out
        xv.decode_frames = counted
        # the shapes the demo launches the coarse kernel at, for main()'s
        # kernel-vs-plain check and timing at the same shape
        coarse_shapes = set()
        real_coarse = pipeline_mod.coarse_segment_max

        def recorded(feats, cls, ctx_l, stride, *a, **kw):
            coarse_shapes.add((*feats.shape[:2], cls.shape[1], feats.shape[2], int(stride)))
            return real_coarse(feats, cls, ctx_l, stride, *a, **kw)
        pipeline_mod.coarse_segment_max = recorded
        tower_calls = []
        hook = vision.register_forward_hook(lambda *a: tower_calls.append(1))
        try:
            proc_s = []

            def timed_processor(images, return_tensors="np"):
                t0 = time.time()
                out = clip_processor(images, return_tensors)
                proc_s.append(time.time() - t0)
                return out
            pred = MomentPredictor(model, cfg, backend="clip", engine="tower",
                                   clip_models={"vision": vision, "text": text,
                                                "processor": timed_processor, "tokenizer": tok},
                                   cache_dir=os.path.join(tmp, "cache"), device=dev)
            # time the predictor's two extraction steps inside localize_moment
            spans_s = {"video": [], "text": []}
            for name in ("video", "text"):
                def timed(arg, fn=getattr(pred, f"{name}_features"), name=name):
                    t0 = time.time()
                    out = fn(arg)
                    sync()
                    spans_s[name].append(time.time() - t0)
                    return out
                setattr(pred, f"{name}_features", timed)
            demo_q = queries
            per_query = []
            results = []
            for i, q in enumerate(demo_q):
                co.coarse_segment_max.launches = 0
                t0 = time.time()
                moments = pred.localize_moment(movie, q)
                sync()
                wall = time.time() - t0
                per_query.append(dict(wall_s=wall, launches=co.coarse_segment_max.launches,
                                      tower_forwards=len(tower_calls),
                                      video_s=spans_s["video"][-1], text_s=spans_s["text"][-1],
                                      localize_s=wall - spans_s["video"][-1]
                                      - spans_s["text"][-1]))
                results.append(moments)
            cold = per_query[0]
            video = pred.video_features(movie)
            n_frames = len(video)
            check(n_frames >= int(seconds * fps) - 2, f"demo decoded {n_frames} frames")
            check(len(decode_calls) == 1
                  and all(p["tower_forwards"] == cold["tower_forwards"] for p in per_query),
                  f"warm calls decoded or ran the vision tower again: {per_query}, "
                  f"{len(decode_calls)} decodes")
            check(all(p["launches"] >= 1 for p in per_query),
                  f"a demo query launched no coarse kernel: {per_query}")
            check(len(coarse_shapes) == 1,
                  f"the demo launched the coarse kernel at {sorted(coarse_shapes)}, want one shape")
            (b_, l_pad, q_, d_, stride_), = coarse_shapes
            coarse_shape = (b_, l_pad, q_, d_, stride_, [n_frames] * b_)
            # the same features through the localizer on the CPU, and on the card
            # with the kernel off. The CPU's fine stage takes one query a
            # dispatch (the preset's 32 pad it to 960 windows, seconds on a
            # CPU); a query's windows do not see the padding
            model_cpu = ConeModel(cfg.model, device="cpu")
            model_cpu.load_state_dict(wsd)
            loc_cpu = OnlineLocalizer(
                model_cpu, cfg.replace(eval=dataclasses.replace(cfg.eval, query_chunk=1)),
                device="cpu")
            # the demo again with the kernel off: the same cached features
            cfg_off = cfg.replace(eval=dataclasses.replace(cfg.eval, use_pallas_coarse=False))
            pred_off = MomentPredictor(model, cfg_off, backend="clip", engine="tower",
                                       clip_models=pred._clip_models,
                                       cache_dir=os.path.join(tmp, "cache"), device=dev)
            loc_off = pred_off.localizer
            vn = l2_normalize(video)
            span_err = score_err = 0.0
            flips_cpu = flips_off = 0
            t_text, t_loc = [], []
            for q, moments in zip(demo_q, results):
                t0 = time.time()
                tk, cl = pred.text_features(q)
                t_text.append(time.time() - t0)
                args = (vn, l2_normalize(tk), l2_normalize(cl[None])[0])
                t0 = time.time()
                card_m, card_rl = pred.localizer.localize_ranked(*args, query=q)
                sync()
                t_loc.append(time.time() - t0)
                check(card_m == moments, f"{q}: localize_ranked differs from the demo's answer")
                cpu_m, cpu_rl = loc_cpu.localize_ranked(*args, query=q)
                off_m, off_rl = loc_off.localize_ranked(*args, query=q)
                check(pred_off.localize_moment(movie, q) == off_m,
                      f"{q}: the demo with the kernel off differs from its localizer")
                a, b = np.asarray(card_m, np.float64), np.asarray(cpu_m, np.float64)
                check(a.shape == b.shape and len(a) >= 1, f"{q}: {a.shape} vs CPU {b.shape}")
                span_err = max(span_err, float(np.abs(a[:, :2] - b[:, :2]).max()))
                score_err = max(score_err, float(np.abs(a[:, 2:] - b[:, 2:]).max()))
                # the plain path's window scores order both ranklists: only
                # near-ties may swap
                pipe = loc_off.pipe
                appear, a_scale, _, _, ctx_l = pipe._device_video("v0")
                with torch.inference_mode():
                    adapted = pipe._adapt(pipe._decode(appear, a_scale))[None]
                    clsq = torch.from_numpy(args[2]).to(dev)[None, None]
                    s, _ = window_scores_from_frame_scores(
                        clsq @ adapted.transpose(1, 2), torch.tensor([[ctx_l]], device=dev),
                        pipe.stride, num_windows(ctx_l, pipe.stride))
                s = s[0, 0].cpu().numpy()
                for other, rl in (("CPU", cpu_rl), ("kernel off", off_rl)):
                    if rl != card_rl:
                        check(_descends(s, card_rl) and _descends(s, rl),
                              f"{q}: ranklists card vs {other} differ beyond near-ties")
                flips_cpu += sum(x != y for x, y in zip(card_rl, cpu_rl))
                flips_off += sum(x != y for x, y in zip(card_rl, off_rl))
            check(span_err <= SPAN_ATOL and score_err <= SCORE_ATOL,
                  f"demo on the card vs the CPU localizer: spans {span_err}, scores {score_err}")
            check(len(decode_calls) == 1 and len(tower_calls) == cold["tower_forwards"],
                  "the demo with the kernel off decoded or ran the vision tower again")
            launches = sum(p["launches"] for p in per_query)
            warm = [p["wall_s"] for p in per_query[1:]]
            meas["demo"] = dict(
                source=source, frames=n_frames, fps=fps, queries=len(demo_q),
                cold_s=cold["wall_s"], warm_s=warm, decode_s=decode_calls[0],
                cold_video_s=cold["video_s"], preprocess_s=float(sum(proc_s)),
                cold_text_s=cold["text_s"], cold_localize_s=cold["localize_s"],
                warm_video_s=[p["video_s"] for p in per_query[1:]],
                warm_text_s=[p["text_s"] for p in per_query[1:]],
                warm_localize_s=[p["localize_s"] for p in per_query[1:]],
                text_s=float(np.median(t_text)), localize_s=float(np.median(t_loc)),
                coarse_launches_per_query=[p["launches"] for p in per_query],
                coarse_shape=dict(B=b_, L=l_pad, Q=q_, D=d_, stride=stride_, ctx_l=n_frames),
                span_err_vs_cpu=span_err, score_err_vs_cpu=score_err,
                ranklist_flips_vs_cpu=flips_cpu, ranklist_flips_kernel_off=flips_off,
                vision_forwards=per_query[0]["tower_forwards"])
            print(f"towers (c): demo at the MAD preset's full width (512-d video, text and "
                  f"CLS, hidden {cfg.model.hidden_dim}, random seeded weights, coarse kernel "
                  f"on): a {seconds} s video at {fps:g} fps, {n_frames} frames ({source}), "
                  f"padded to the {min(b for b in cfg.eval.ctx_buckets if b >= n_frames)} "
                  f"bucket; {len(demo_q)} queries: coarse launches per query "
                  f"{meas['demo']['coarse_launches_per_query']} at B {b_}, L {l_pad}, Q {q_}, "
                  f"D {d_}, stride {stride_}; cold query {cold['wall_s']:.3f} s"
                  f" = video features {cold['video_s']:.3f} s (decode {decode_calls[0]:.3f} s, "
                  f"host preprocessing {sum(proc_s):.3f} s, the rest {cold['tower_forwards']} "
                  f"vision forwards and copies) + text {cold['text_s'] * 1e3:.2f} ms + localize "
                  f"{cold['localize_s'] * 1e3:.2f} ms; warm queries "
                  f"{[round(w, 4) for w in warm]} s (feature cache hit, no decode, no vision "
                  f"forward: video {[round(p['video_s'] * 1e3, 2) for p in per_query[1:]]} ms, "
                  f"text {[round(p['text_s'] * 1e3, 2) for p in per_query[1:]]} ms, localize "
                  f"{[round(p['localize_s'] * 1e3, 2) for p in per_query[1:]]} ms); again on "
                  f"the same features: text {meas['demo']['text_s'] * 1e3:.2f} ms, localize "
                  f"{meas['demo']['localize_s'] * 1e3:.2f} ms (medians, host clock); vs "
                  f"the CPU localizer on the card's features: spans {span_err:.2e} (<= "
                  f"{SPAN_ATOL}), scores {score_err:.2e} (<= {SCORE_ATOL}), {flips_cpu} near-tie "
                  f"ranklist flips; kernel off: {flips_off} near-tie flips; "
                  f"{time.time() - t_phase:.1f} s into the phase [{card}]", flush=True)

            # (d) serve --text_backend clip: raw text over HTTP == features
            svc = MomentService(model, cfg, text_encoder=pred.text_features, device=dev)
            svc.retriever.add_video("demo", video)
            srv = make_server(svc, host="127.0.0.1", port=0)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            try:
                base = f"http://127.0.0.1:{srv.server_address[1]}"

                def call(payload):
                    req = urllib.request.Request(base + "/search",
                                                 data=json.dumps(payload).encode(),
                                                 headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=300) as r:
                        return json.loads(r.read())["moments"]
                for q in demo_q:
                    tk, cl = pred.text_features(q)
                    raw = call(dict(query=q))
                    check(raw and raw == call(dict(query=q, token_features=tk.tolist(),
                                                   cls_feature=cl.tolist())),
                          f"{q}: raw-text /search differs from the feature-carrying one")
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=30)
            check(not thread.is_alive(), "the HTTP server thread did not stop")
            print(f"towers (d): MomentService(text_encoder=MomentPredictor.text_features) "
                  f"behind make_server: {len(demo_q)} raw-text /search answers equal the "
                  f"feature-carrying ones; phase {time.time() - t_phase:.1f} s", flush=True)
        finally:
            hook.remove()
            xv.decode_frames = real_decode
            pipeline_mod.coarse_segment_max = real_coarse
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model, vision, text
    torch.cuda.empty_cache()
    return meas, launches, coarse_shape


def _self_device_us(evt):
    t = getattr(evt, "self_device_time_total", None)
    return evt.self_cuda_time_total if t is None else t


def profile_breakdown(pipe, n_q):
    """torch.profiler over one warm fused run: device time by op and the
    busy share of the run's wall. (The kernels' own device time per launch
    is printed by phase 3 in every run.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    from cone_tpu_torch.ops import attention as at
    from cone_tpu_torch.ops import coarse as co
    from cone_tpu_torch.utils.device import card_peaks
    from cone_tpu_torch.ops.windows import num_windows

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
        # the seams of the kernel's tiling: runs of segments, 16-frame tiles,
        # 32-column chunks, and every template instance (query tiles per item)
        coarse_case("segment-straddles-tile", 1, 32, 720, 64, 45, [700], peaks, 0, gen, 3),
        coarse_case("run-ends-at-ctx", 1, 32, 720, 64, 45, [8 * 45 - 20], peaks, 0, gen, 4),
        coarse_case("run-ends-at-ctx-exactly", 1, 32, 720, 64, 45, [8 * 45], peaks, 0, gen, 4),
        coarse_case("n_seg-not-multiple-of-run", 1, 32, 720, 64, 45, [700], peaks, 0, gen, 5),
        coarse_case("one-block-per-video", 1, 32, 720, 64, 45, [700], peaks, 0, gen, 16),
        coarse_case("q5", 3, 5, 520, 64, 45, [500, 90, 1], peaks, 0, gen, 2),
        coarse_case("q40", 1, 40, 520, 64, 45, [500], peaks, 0, gen, 4),
        coarse_case("q100", 1, 100, 520, 64, 62, [500], peaks, 0, gen, 3),
        coarse_case("q128", 1, 128, 330, 128, 62, [300], peaks, 0, gen, 2),
        coarse_case("b3-unequal-ctx-d512", 3, 32, 1600, 512, 62, [1500, 707, 62], peaks, 0, gen, 4),
        coarse_case("mad-video-batch", 3, 32, 36864, 512, 62, [36000, 20000, 36864], peaks, 0, gen),
        coarse_case("stride7", 1, 16, 330, 64, 7, [300], peaks, 0, gen, 9),
        coarse_case("d100", 1, 32, 330, 100, 45, [300], peaks, 0, gen, 2),
        coarse_case("one-frame-video", 2, 8, 330, 64, 45, [1, 300], peaks, 0, gen, 2),
        # the 2D-TAN strides 32 (tan_ego4d) and 64 (tan_mad): segments of whole
        # 16-frame tiles, runs of whole tiles
        coarse_case("ego4d-tan-q8", 1, 8, 2304, 256, 32, [2241], peaks, 500, gen),
        coarse_case("ego4d-tan", 1, 32, 2304, 256, 32, [2241], peaks, 500, gen),
        coarse_case("tan-mad", 1, 32, 36864, 512, 64, [36000], peaks, 100, gen),
        coarse_case("tan-video-batch-ctx-on-segment", 2, 32, 2304, 256, 32, [2304, 2240],
                    peaks, 0, gen),
        coarse_case("tan-run-ends-at-ctx-on-tile", 1, 32, 1024, 512, 64, [448], peaks, 0, gen, 7),
        coarse_case("tan-ctx-a-tile-short", 1, 32, 1024, 512, 64, [432], peaks, 0, gen, 3),
        coarse_case("tan-two-segments", 2, 8, 64, 64, 32, [64, 31], peaks, 0, gen, 1),
    ]
    main_case, mad_case = cases[0], cases[2]
    tan_cases = {c["label"]: c for c in cases if c["label"] in ("ego4d-tan-q8", "ego4d-tan",
                                                                  "tan-mad")}
    check({c["ntw"] for c in cases} == {1, 2, 4, 8, 16},
          f"coarse cases reached instances {sorted({c['ntw'] for c in cases})}, want all five")
    print(f"coarse_segment_max: {len(cases)} cases, {sum(c['window_flips'] for c in cases)} "
          f"window near-tie flips in all, worst max_abs_err "
          f"{max(c['max_abs_err'] for c in cases):.3e}", flush=True)
    attn, attn_launches, attn_err = attention_phase()

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
    at.masked_attention.launches = 0
    t0 = time.time()
    subs, ranklists = pipe.run(host_postproc=False, fused=True)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = co.coarse_segment_max.launches
    print(f"main path fused run: {first_s:.3f} s; coarse_segment_max launches {launches} "
          f"for {dispatches} dispatches", flush=True)
    check(launches == dispatches, f"kernel launched {launches} times, want {dispatches}")
    check(at.masked_attention.launches == 0,
          "the inference path launched the attention kernel (the model is not routed through it)")

    n_q = len(ds.examples)
    well_formed_runs(subs, n_q, cfg.eval.max_after_nms, "main path")
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
    same, flips = near_tie_flips(pipe_off, ds, ranklists, ranklists_off)
    print(f"ranklists kernel on vs off: {same}/{n_q} identical, {flips} near-tie flips",
          flush=True)

    # staged path with the reference-exact host post-processing
    subs_s, ranklists_s = pipe.run(host_postproc=True)
    check(ranklists_s == ranklists, "staged ranklists differ from fused")
    worst = fused_vs_staged(subs, subs_s)
    print(f"fused vs staged host postproc: all 3 modalities, max span err {worst[0]:.2e} "
          f"(<= {SPAN_ATOL}), max score err {worst[1]:.2e} (<= {SCORE_ATOL})", flush=True)

    golden_on_card()

    serving = serving_phase(model, cfg, smi)
    infer_phase(model, cfg, ds, ranklists)
    training, train_launches = training_phase(smi)
    check(train_launches > 0, "the training phase launched no coarse_segment_max kernel")

    # 8. the 2D-TAN family: goldens, inference and training at tan_ego4d width
    tan = tan_goldens()
    tan["inference"], tan_launches = tan_inference_phase(smi)
    tan["training"], tan_train_launches = tan_training_phase(smi)

    # 9. data parallelism
    parallel, par_launches = parallel_phase(smi)

    # 10. the feature towers and the demo path
    towers, demo_launches, (b, l_pad, q, d, stride, ctx) = towers_phase(smi, peaks)
    # the kernel against its plain version, and timed, at the shape the demo
    # launched it at
    demo_case = coarse_case("mad-demo", b, q, l_pad, d, stride, ctx, peaks, 500, gen)
    cases.append(demo_case)

    if args.profile:
        profile_breakdown(pipe, n_q)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_us")
    kernels = [dict(
        name="coarse_segment_max", route="cuda",
        source="cone_tpu_torch/csrc/coarse_segment_max.cu",
        replaces="cone_tpu/ops/pallas_coarse.py:66",
        launches=(launches + train_launches + tan_launches + tan_train_launches
                  + sum(par_launches.values()) + demo_launches),
        launches_by_path={"inference": launches, "train_eval": train_launches,
                          "tan_inference": tan_launches, "tan_train_eval": tan_train_launches,
                          **{f"parallel_{k}": v for k, v in par_launches.items()},
                          "demo": demo_launches},
        max_abs_err=max(c["max_abs_err"] for c in cases),
        window_flips=sum(c["window_flips"] for c in cases),
        shape="ego4d: B 1, Q 32, L 2304, D 256, stride 45",
        **{k: main_case[k] for k in keys},
        mad=dict(shape="B 1, Q 32, L 36864, D 512, stride 62",
                 max_abs_err=mad_case["max_abs_err"], **{k: mad_case[k] for k in keys}),
        tan={label: dict(shape=f"B {c['B']}, Q {c['Q']}, L {c['L']}, D {c['D']}, stride "
                               f"{c['stride']}", max_abs_err=c["max_abs_err"],
                         **{k: c[k] for k in keys}) for label, c in tan_cases.items()},
        demo=dict(shape=f"B {b}, Q {q}, L {l_pad}, D {d}, stride {stride}, ctx_l {ctx[0]}",
                  launches=demo_launches,
                  max_abs_err=demo_case["max_abs_err"], **{k: demo_case[k] for k in keys}))]
    a32, a16 = attn["results"]["float32"], attn["results"]["bfloat16"]
    kernels.append(dict(
        name="masked_attention", route="cuda",
        source="cone_tpu_torch/csrc/masked_attention.cu",
        replaces="tools/bench_attn.py:79", launches=attn_launches,
        max_abs_err=attn_err["float32"], dtype="float32", shape=attn["shapes"],
        **{k: a32[k] for k in keys},
        bfloat16=dict(max_abs_err=attn_err["bfloat16"], **{k: a16[k] for k in keys})))
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"serving_latency_ms": serving, "training": training, "tan": tan,
                      "parallel": parallel, "towers": towers, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
