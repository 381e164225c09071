"""Command-line entry points: train / infer / eval / ensemble / serve /
demo / extract-text / extract-video / reformat / convert-store.

    python -m cone_tpu_torch <command> ... [--device cuda]

Counterparts of the reference's cone/inference.py CLI and its standalone
evaluators, driven by the workdir's typed ConeConfig (config.json); any
field can be overridden with --set section.field=value. Commands that run
the model take --device (default cuda: without a card they raise; pass
--device cpu to run on the CPU).

Inputs: feature stores (data/store.py open_array_store: a packed .cfs file
through the native C++ reader, or a reference LMDB directory; the text
feature directory holds tokens.cfs and cls.cfs) and a workdir with config.json
and model_<tag>.ckpt, a reference-named torch checkpoint, or a JAX
workdir's model_<tag>.msgpack, read directly (train/checkpoint.py).
`reformat` turns the challenge json into the flat jsonl the dataset reads
and `convert-store` turns LMDB, h5, npy or pt features into a .cfs file
(the h5py and lmdb imports happen only in their branches).

`train` starts from a preset (ego4d, mad, their bfloat16 from-scratch
variants ego4d_scratch, mad_scratch, and the 2D-TAN family's tan_ego4d,
tan_mad) or a --config file, writes its workdir (config.json, checkpoints,
logs) and trains on one device (`--set train.multiscale=true`: the ECCV'22
multiscale loader; with --distributed on the ranks of one host, refused
across hosts), or data parallel over ranks
(parallel/distributed.py), one process each:

    train --distributed --coordinator HOST:PORT --num_processes N --process_id I
    torchrun --nproc_per_node N -m cone_tpu_torch train --distributed
    train --mesh      # a group of this one rank, on this device

Ranks train on row blocks of each global batch with the global batch's
loss and share the workdir; rank 0 writes it. Backends, from every rank's
host name and card count after the rendezvous: NCCL when no host runs
more ranks than it has cards, gloo on the CPU (--device cpu) and when
ranks share a card. With `--set train.tp_devices=K` (`--distributed`, a
multiple of K processes) the ranks form a (N / K, K) grid: Megatron tensor
parallelism of the transformer over each K adjacent ranks, data
parallelism across them (parallel/mesh.py); the checkpoints hold full
tensors. A 2D-TAN workdir infers and serves like a CONE one.

`demo` (a video file and query texts -> ranked moments), `extract-video`,
`extract-text` and `serve --text_backend` run the feature towers on the
device (extract/, serve/predictor.py). Their engines: "tower" (default) is
the port's own module (models/clip.py), the counterpart of cone_tpu's
"flax"; "hf" is the transformers torch model, the counterpart of its
"torch". Both load released weights through transformers by name.

`--debug_nans` (before the command) runs it under torch's anomaly mode
with its NaN check: the first backward op that produces a NaN raises,
naming its forward op (cone_tpu's --debug_nans).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os


def _apply_overrides(cfg, sets):
    for kv in sets or []:
        key, val = kv.split("=", 1)
        section, field = key.split(".", 1)
        sec = getattr(cfg, section)
        cur = getattr(sec, field)
        if isinstance(cur, bool):
            val = val.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(val)
        elif isinstance(cur, float):
            val = float(val)
        elif isinstance(cur, tuple):  # comma-separated, e.g. tan.map_hidden_sizes=64,64
            elem = type(cur[0]) if cur else int
            val = tuple(elem(x) for x in val.split(",") if x)
        cfg = cfg.replace(**{section: dataclasses.replace(sec, **{field: val})})
    return cfg


def _open_dataset(cfg, data_path, reader="native"):
    from cone_tpu_torch.data.dataset import GroundingDataset
    from cone_tpu_torch.data.store import TextFeatureStore, open_array_store

    d = cfg.data
    appear = open_array_store(d.appearance_feat_dir, reader)
    motion = None
    if d.motion_feat_dir and d.motion_feat_dir != d.appearance_feat_dir:
        motion = open_array_store(d.motion_feat_dir, reader)
    text = TextFeatureStore(
        open_array_store(os.path.join(d.t_feat_dir, "tokens.cfs"), reader),
        open_array_store(os.path.join(d.t_feat_dir, "cls.cfs"), reader),
    )
    return GroundingDataset(data_path, appear, text, d, video_motion_store=motion)


PRESETS = ("ego4d", "ego4d_scratch", "mad", "mad_scratch", "tan_ego4d", "tan_mad")


def _load_cfg(args):
    from cone_tpu_torch import config as C

    if args.config:
        # a user-supplied file: unknown keys are typos, fail loudly
        cfg = C.ConeConfig.load(args.config, strict=True)
    else:
        cfg = getattr(C, f"{args.preset}_config")()
    return _apply_overrides(cfg, args.set)


def cmd_train(args):
    from cone_tpu_torch.parallel import distributed

    layout = [f"--{k}" for k in ("coordinator", "num_processes", "process_id")
              if getattr(args, k) is not None]
    if layout and not args.distributed:
        raise SystemExit(f"{' '.join(layout)} need --distributed")
    cfg = _load_cfg(args)
    if args.debug:
        cfg = _apply_overrides(cfg, ["train.debug=true"])
    if cfg.train.tp_devices > 1 and not args.distributed and not args.dump_config:
        raise SystemExit(
            f"train.tp_devices={cfg.train.tp_devices} (tensor parallel) needs --distributed "
            "with a multiple of that many processes" + (", not --mesh" if args.mesh else ""))
    if not args.dump_config:   # before any data is read or a rank joins
        from cone_tpu_torch.train.loop import check_supported

        world = args.num_processes
        if world is None and args.distributed:   # torchrun's environment
            world = int(os.environ.get("WORLD_SIZE", 1))
        check_supported(cfg, world or 1)
    if args.dump_config or not (args.distributed or args.mesh):
        return _train(args, cfg, args.device)
    if args.distributed:
        dev = distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                                     device=args.device)
    else:
        dev = distributed.initialize(num_processes=1, process_id=0, device=args.device)
    try:
        print(f"rank {distributed.rank()} of {distributed.world_size()} on {dev} "
              f"({distributed.backend()})", flush=True)
        return _train(args, cfg, dev)
    finally:
        distributed.shutdown()


def _train(args, cfg, device):
    from cone_tpu_torch.train.loop import train

    if args.train_path:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, train_path=args.train_path))
    if args.eval_path:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, eval_path=args.eval_path))
    if args.dump_config:
        # the resolved config (preset, --config, --set, --debug, --*_path),
        # written without training
        os.makedirs(os.path.dirname(args.dump_config) or ".", exist_ok=True)
        cfg.save(args.dump_config)
        print(f"wrote resolved config to {args.dump_config}")
        return
    if args.synthetic:
        from cone_tpu_torch.data import make_synthetic_dataset

        dim = cfg.model.v_appear_feat_dim
        if cfg.model.t_feat_dim != dim:
            # synthetic text features share the appearance dim (the matching
            # branch needs cls dim == appearance dim), so presets with wider
            # tokens (tan_ego4d's 768-d RoBERTa) shrink to it for smoke runs
            cfg = cfg.replace(model=dataclasses.replace(cfg.model, t_feat_dim=dim),
                              tan=dataclasses.replace(cfg.tan, t_feat_dim=dim))
        train_ds = make_synthetic_dataset(cfg.data, n_videos=8, queries_per_video=8,
                                          dim=dim, seed=0)
        eval_ds = train_ds
    else:
        train_ds = _open_dataset(cfg, cfg.data.train_path)
        eval_ds = (_open_dataset(cfg, cfg.data.eval_path)
                   if cfg.data.eval_path else None)
    if cfg.data.train_data_ratio != 1.0:
        # a train-split-only downsample (the reference's --train_data_ratio,
        # cone/config.py:29-32); --synthetic aliases the splits, so the eval
        # split keeps its own full list
        if eval_ds is train_ds:
            eval_ds = copy.copy(train_ds)
            eval_ds.examples = list(train_ds.examples)
        n = int(len(train_ds.examples) * cfg.data.train_data_ratio)
        train_ds.examples = train_ds.examples[:n]
        print(f"train_data_ratio={cfg.data.train_data_ratio}: {n} train samples")
    return train(cfg, train_ds, eval_ds, args.workdir, profile=args.profile,
                 init_ckpt=args.init_ckpt, device=device, tensorboard=args.tensorboard)


def _restore(args, cfg):
    from cone_tpu_torch.train.checkpoint import load_model

    model, epoch = load_model(args.workdir, args.ckpt, device=args.device, cfg=cfg)
    print(f"restored '{args.ckpt}' (epoch {epoch})")
    return model


def cmd_infer(args):
    from cone_tpu_torch.train.checkpoint import load_config
    from cone_tpu_torch.train.loop import build_family, evaluate
    from cone_tpu_torch.utils.io import save_jsonl

    cfg = _apply_overrides(load_config(args.workdir), args.set)
    if args.untrained:
        # the reference's --eval_untrained debug flag (cone/config.py:62):
        # score the fresh-init model, no checkpoint needed
        model = build_family(cfg, seed=cfg.train.seed, device=args.device)
        print("evaluating UNTRAINED (fresh-init) weights")
    else:
        model = _restore(args, cfg)

    eval_ds = _open_dataset(cfg, args.eval_path or cfg.data.eval_path)
    res = evaluate(model, eval_ds, cfg, host_postproc=not args.fast_postproc,
                   fused=args.fused, device=args.device)
    for t in res["tables"].values():
        print(t)
    # --results_dir redirects all outputs away from the train workdir (the
    # reference's --eval_results_dir, cone/config.py:233, :195-196)
    out_dir = args.results_dir or args.workdir
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"inference_{args.ckpt}_preds.jsonl")
    save_jsonl(res["submissions"]["fusion"], out)
    print(f"wrote {out}")
    if args.save_all:
        # all three scoring modalities (the reference's --save_all,
        # cone/config.py:124 + inference.py:322-331 ablation outputs)
        for name in ("proposal", "matching"):
            if name in res["submissions"]:
                p = os.path.join(out_dir,
                                 f"inference_{args.ckpt}_{name}_preds.jsonl")
                save_jsonl(res["submissions"][name], p)
                print(f"wrote {p}")
    # coarse-stage ranklists, evaluable standalone via `eval --ranklists`
    # (the reference saves these for evaluate_pre_filtered_window.py)
    rank_out = os.path.join(out_dir, f"inference_{args.ckpt}_windows.jsonl")
    save_jsonl(
        [{"query_id": q, "ranklist": [int(w) for w in r]}
         for q, r in res["ranklists"].items()],
        rank_out,
    )
    print(f"wrote {rank_out}")

    from cone_tpu_torch.eval.submission import to_ego4d_challenge, write_submission

    sub_path = os.path.join(
        out_dir,
        f"submission_{cfg.data.dset_name}_{args.ckpt}."
        + ("json" if cfg.data.dset_name == "ego4d" else "jsonl"),
    )
    write_submission(res["submissions"]["fusion"], sub_path, cfg.data.dset_name)
    print(f"wrote {sub_path}")

    if args.ego4d_gt:
        from cone_tpu_torch.eval.metrics import display_ego4d_results, evaluate_ego4d_nlq
        from cone_tpu_torch.utils.io import load_json

        gt = load_json(args.ego4d_gt)
        preds = to_ego4d_challenge(res["submissions"]["fusion"])["results"]
        results, miou = evaluate_ego4d_nlq(preds, gt, [0.3, 0.5], [1, 5, 10, 50, 100])
        print(display_ego4d_results(results, miou, [0.3, 0.5],
                                    [1, 5, 10, 50, 100], title="Official Ego4D"))


def cmd_eval(args):
    """Standalone metric evaluation over submission files, the counterpart
    of the reference's standalone_eval CLIs (evaluate_ego4d_nlq.py:140-171,
    evaluate_mad.py:119-150): recall tables from files alone, no model or
    features needed."""
    if not args.ranklists and not args.submission:
        raise SystemExit("--submission is required (unless --ranklists)")
    from cone_tpu_torch.eval.metrics import (
        display_ego4d_results, display_recall_table, evaluate_ego4d_nlq,
        evaluate_recall_table, mean_first_iou,
    )
    from cone_tpu_torch.utils.io import load_json, load_jsonl

    if args.thresholds:
        thresholds = [float(x) for x in args.thresholds]
    else:
        thresholds = [0.1, 0.3, 0.5] if args.dset == "mad" else [0.3, 0.5]
    topk = [int(x) for x in args.topK] if args.topK else [1, 5, 10, 50, 100]

    if args.ranklists:
        # coarse-stage window recall from a saved ranklist file (the
        # reference's evaluate_pre_filtered_window.py standalone CLI)
        from cone_tpu_torch.eval.metrics import (
            display_window_results, evaluate_window_ranklists,
        )

        assert args.gt, "window-recall eval needs --gt (flat jsonl)"
        gt = load_jsonl(args.gt)
        ranklists = {r["query_id"]: r["ranklist"]
                     for r in load_jsonl(args.ranklists)}
        wtopk = [int(x) for x in args.topK] if args.topK else [1, 5, 10, 30, 50]
        rec = evaluate_window_ranklists(
            ranklists, gt, wtopk, args.clip_length, args.max_v_l,
            match_number=not args.no_match_number)
        table = display_window_results(
            rec, wtopk, title=args.title or "Window Pre-filtering")
        print(table)
        if args.out:
            with open(args.out, "a") as f:
                f.write(table + "\n")
        if args.expect:
            # window-recall metrics are R<k> (no IoU threshold)
            _expect_diff(args.expect, args.expect_tol,
                         {f"R{k}": 100 * float(rec[i])
                          for i, k in enumerate(wtopk)})
        return

    assert args.gt or args.ego4d_gt, "need --gt (flat jsonl) or --ego4d_gt"
    if args.ego4d_gt:
        # nested challenge GT json + challenge-format submission json
        gt = load_json(args.ego4d_gt)
        sub = load_json(args.submission)
        preds = sub["results"] if isinstance(sub, dict) else sub
        results, miou = evaluate_ego4d_nlq(preds, gt, thresholds, topk)
        table = display_ego4d_results(results, miou, thresholds, topk,
                                      title=args.title or "Official Ego4D")
        computed = {(k, t): 100 * float(results[ti][ki])
                    for ki, k in enumerate(topk)
                    for ti, t in enumerate(thresholds)}
    else:
        # flat jsonl GT (query_id + timestamps) + flat submission jsonl
        gt = load_jsonl(args.gt)
        sub = load_jsonl(args.submission)
        recall = evaluate_recall_table(sub, gt, thresholds, topk,
                                       match_number=not args.no_match_number)
        miou = mean_first_iou(sub, gt) if args.dset == "ego4d" else None
        table = display_recall_table(recall, thresholds, topk,
                                     title=args.title, mIoU=miou)
        computed = {(k, t): 100 * float(recall[ki][ti])
                    for ki, k in enumerate(topk)
                    for ti, t in enumerate(thresholds)}
    print(table)
    if args.out:
        with open(args.out, "a") as f:
            f.write(table + "\n")
    if args.expect:
        named = {f"R{k}@{t:g}": v for (k, t), v in computed.items()}
        if miou is not None:
            named["mIoU"] = 100 * float(miou)
        _expect_diff(args.expect, args.expect_tol, named)


def _expect_diff(expect: str, tol: float, computed: dict):
    """--expect parity diff against a published row: comma-separated
    <name>=<percent> entries where <name> is a key of the computed table:
    R<k>@<t> (recall tables), R<k> (window recall), or mIoU. Prints one
    ok/FAIL line per entry; SystemExit on any miss."""
    fails = []
    for item in expect.split(","):
        name, want = item.split("=")
        name = name.strip()
        if name.lower() == "miou":
            key = "mIoU"
        elif "@" in name and name.startswith("R"):
            kk, tt = name[1:].split("@")  # normalize R1@0.30 -> R1@0.3
            key = f"R{int(kk)}@{float(tt):g}"
        else:
            key = name
        assert key in computed, (
            f"--expect {name}: not in the computed table "
            f"(available: {', '.join(computed)})")
        got = computed[key]
        delta = got - float(want)
        line = f"{name}: got {got:.2f}, expected {float(want):.2f} " \
               f"(delta {delta:+.2f}, tol {tol})"
        print(("  ok   " if abs(delta) <= tol else "  FAIL ") + line)
        if abs(delta) > tol:
            fails.append(name)
    if fails:
        raise SystemExit(f"parity check FAILED: {', '.join(fails)}")
    print("parity check PASSED")


def cmd_ensemble(args):
    """Fuse N models' prediction jsonls (ECCV'22 challenge recipe,
    ECCV_2022_workshop/ensemble.py:104-146). Rows are aligned by query_id
    (the reference zips three files written in the same order; sorting by
    query_id makes that robust to file order)."""
    from cone_tpu_torch.eval.ensemble import ensemble_predictions
    from cone_tpu_torch.utils.io import load_jsonl, save_jsonl

    subs = [sorted(load_jsonl(p), key=lambda r: str(r["query_id"]))
            for p in args.inputs]
    qids = [tuple(r["query_id"] for r in s) for s in subs]
    assert all(q == qids[0] for q in qids), "inputs cover different query sets"
    fused = ensemble_predictions(subs, max_input=args.max_input,
                                 top1_max_input=args.top1_max_input)
    save_jsonl(fused, args.output)
    print(f"wrote {len(fused)} fused rows to {args.output}")


def cmd_serve(args):
    """HTTP serving front end over a trained workdir (serve/server.py):
    /search across the resident corpus, /localize for one-shot videos,
    /add_video, /healthz, /stats. With --text_backend, requests may carry
    the query text alone: the predictor's text tower encodes it on the
    device."""
    from cone_tpu_torch.serve.server import MomentService, make_server
    from cone_tpu_torch.train.checkpoint import load_config

    _refuse_unused(args, args.text_backend, "--text_backend",
                   {"clip": ["egovlp_checkpoint"], "egovlp": ["text_engine"],
                    None: ["text_engine", "egovlp_checkpoint"]})
    cfg = _apply_overrides(load_config(args.workdir), args.set)
    model = _restore(args, cfg)
    ds = _open_dataset(cfg, args.preload_path) if args.preload_path else None
    encoder = None
    if args.text_backend:
        from cone_tpu_torch.serve.predictor import MomentPredictor

        pred = MomentPredictor(model, cfg, backend=args.text_backend,
                               egovlp_checkpoint=args.egovlp_checkpoint,
                               engine=args.text_engine or "tower", device=args.device)
        encoder = pred.text_features
    service = MomentService(model, cfg, text_encoder=encoder, dataset=ds,
                            batch_window_ms=args.batch_window_ms,
                            max_batch=args.max_batch, device=args.device)
    if args.load_corpus:
        n = service.retriever.load_corpus(args.load_corpus)
        print(f"loaded {n} videos from {args.load_corpus}")
    srv = make_server(service, host=args.host, port=args.port)
    print(f"serving {len(service.retriever.clip_ids)} videos on "
          f"http://{srv.server_address[0]}:{srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


def cmd_demo(args):
    """The reference's demo (run_on_video/run.py run_example): one video
    file + query texts -> ranked moments printed, one block per query.
    Extracted video features cache to --cache_dir like the reference's .pt
    cache (run.py:30-38)."""
    from cone_tpu_torch.serve.predictor import MomentPredictor
    from cone_tpu_torch.train.checkpoint import load_config

    _refuse_unused(args, args.backend, "--backend",
                   {"clip": ["egovlp_checkpoint"], "egovlp": ["clip_engine"]})
    cfg = _apply_overrides(load_config(args.workdir), args.set)
    model = _restore(args, cfg)
    pred = MomentPredictor(model, cfg, backend=args.backend,
                           engine=args.clip_engine or "tower",
                           egovlp_checkpoint=args.egovlp_checkpoint,
                           cache_dir=args.cache_dir, device=args.device)
    for query in args.query:
        print("text_query: ", query)
        moments = pred.localize_moment(args.video, query, top_k=args.top_k)
        # the reference's output block (run.py:59-62); rows are
        # [st, ed, prop, match, fusion], fusion-ranked
        print("-----------------------------prediction"
              "------------------------------------")
        for i, m in enumerate(moments):
            print("Rank %d, moment boundary in seconds: %.4f %.4f, score: %.4f"
                  % (i + 1, m[0], m[1], m[4]))
    return pred


def cmd_extract_video(args):
    """Video files -> one packed .cfs of clip features: CLIP frames
    (the reference's feature_extraction/clip_extractor.py) or EgoVLP clips
    (run_on_video/egovlp_extrator.py), on the device."""
    _refuse_unused(args, args.backend, "--backend",
                   {"clip": ["checkpoint"], "egovlp": ["engine", "model"]})
    videos = {}
    for spec in args.videos:
        if "=" in spec:
            clip_id, path = spec.split("=", 1)
        else:
            clip_id, path = os.path.splitext(os.path.basename(spec))[0], spec
        if clip_id in videos:
            raise SystemExit(f"duplicate clip_id {clip_id!r} ({videos[clip_id]} vs {path}):"
                             " disambiguate with explicit clip_id=path specs")
        videos[clip_id] = path
    if args.backend == "egovlp":
        from cone_tpu_torch.extract.egovlp_video import extract_egovlp_video

        if not args.checkpoint:
            raise SystemExit("--checkpoint is required for --backend egovlp")
        extract_egovlp_video(videos, args.out, args.checkpoint,
                             fps=args.fps if args.fps is not None else 1.875,
                             clip_batch=args.batch_size if args.batch_size is not None else 8,
                             device=args.device)
    else:
        from cone_tpu_torch.extract.video import extract_clip_video

        extract_clip_video(videos, args.out,
                           model_name=args.model or "openai/clip-vit-base-patch32",
                           fps=args.fps if args.fps is not None else 5.0,
                           batch_size=args.batch_size if args.batch_size is not None else 64,
                           device=args.device, engine=args.engine or "tower")
    print(f"wrote {len(videos)} video feature rows to {args.out}")


def cmd_extract_text(args):
    """A query jsonl -> tokens.cfs + cls.cfs (CLIP, RoBERTa or EgoVLP's
    DistilBERT text tower), on the device."""
    from cone_tpu_torch.extract import text as tx

    _refuse_unused(args, args.backend, "--backend",
                   {"clip": ["checkpoint"], "roberta": ["engine", "checkpoint"],
                    "egovlp": ["engine"]})
    if args.backend == "clip":
        tx.extract_clip_text(args.input, args.out,
                             model_name=args.model or "openai/clip-vit-base-patch32",
                             device=args.device, engine=args.engine or "tower")
    elif args.backend == "roberta":
        tx.extract_roberta_text(args.input, args.out, model_name=args.model or "roberta-base",
                                device=args.device)
    else:
        if not args.checkpoint:
            raise SystemExit("--checkpoint is required for --backend egovlp")
        tx.extract_egovlp_text(args.input, args.out, args.checkpoint,
                               model_name=args.model or "distilbert-base-uncased",
                               device=args.device)
    print(f"wrote text stores to {args.out}")


def cmd_reformat(args):
    """Challenge json -> flat jsonl (data/reformat.py): Ego4D-NLQ's nested
    json or MAD's dict json, optionally with the train-split filter."""
    from cone_tpu_torch.data import reformat
    from cone_tpu_torch.utils.io import load_json, save_jsonl

    raw = load_json(args.input)
    if args.dset == "ego4d":
        rows = reformat.reformat_ego4d(raw, test_split=args.test_split)
        if args.filter_train:
            rows = reformat.filter_train_ego4d(rows)
    else:
        rows = reformat.reformat_mad(raw)
        if args.filter_train:
            rows = reformat.filter_train_mad(rows)
    save_jsonl(rows, args.output)
    print(f"wrote {len(rows)} rows to {args.output}")


def cmd_convert_store(args):
    """LMDB / h5 / npy-dir / pt-dir features -> one packed .cfs store, the
    same bytes as the JAX package's convert-store (the reference's
    feature_extraction/misc converters). Every array is float32; a 1-D
    .npy (a query's CLS vector) becomes one (1, D) row."""
    import numpy as np

    from cone_tpu_torch.data.store import LmdbArrayStore, write_packed_store

    items = {}
    src = args.input
    if args.format == "lmdb":
        store = LmdbArrayStore(src, array_key=args.array_key)
        for k in store.keys():
            items[k] = store.get(k)
    elif args.format == "h5":
        import h5py   # optional: only this branch needs it

        with h5py.File(src, "r") as f:
            for k in f.keys():
                items[k] = np.asarray(f[k], np.float32)
    elif args.format == "npy_dir":
        for name in sorted(os.listdir(src)):
            if name.endswith(".npy"):
                arr = np.load(os.path.join(src, name)).astype(np.float32)
                items[os.path.splitext(name)[0]] = arr[None] if arr.ndim == 1 else arr
    else:
        import torch

        for name in sorted(os.listdir(src)):
            if name.endswith(".pt"):
                t = torch.load(os.path.join(src, name), map_location="cpu", weights_only=True)
                items[os.path.splitext(name)[0]] = t.float().numpy()
    write_packed_store(args.output, items)
    print(f"wrote {len(items)} entries to {args.output}")


ENGINE_HELP = ("tower = the port's CLIP module (cone_tpu's flax), hf = the transformers"
               " torch model (cone_tpu's torch); both run on --device")


def _refuse_unused(args, backend, flag, unused):
    """Refuse the options that `backend` would ignore ({backend: [dest]})
    rather than run without them."""
    given = [f"--{dest}" for dest in unused.get(backend, []) if getattr(args, dest) is not None]
    if given:
        raise SystemExit(f"{', '.join(given)}: not used with {flag} {backend}" if backend
                         else f"{', '.join(given)}: not used without {flag}")


WORKDIR_HELP = ("config.json + model_<tag>.ckpt (the port's train, or a reference torch"
                " checkpoint), or a JAX workdir's model_<tag>.msgpack")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="cone_tpu_torch")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd anomaly mode with its NaN check: fail at the backward"
                        " op that first produces a NaN, naming its forward op (the 2D-TAN"
                        " reference's set_detect_anomaly, cone_2dtan/moment_localization/"
                        "train.py:28). Slow; debugging only")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a CONE or 2D-TAN model")
    t.add_argument("--config", help="a config json (strict: unknown keys raise)")
    t.add_argument("--preset", choices=PRESETS, default="ego4d",
                   help="ego4d, mad (float32, the reference geometry), their"
                        " from-scratch variants ego4d_scratch, mad_scratch (2 heads,"
                        " bfloat16 compute), and the 2D-TAN tan_ego4d, tan_mad")
    t.add_argument("--set", action="append", metavar="SEC.FIELD=VAL")
    t.add_argument("--workdir", required=True)
    t.add_argument("--train_path")
    t.add_argument("--eval_path")
    t.add_argument("--synthetic", action="store_true",
                   help="train on generated synthetic data (smoke runs)")
    t.add_argument("--debug", action="store_true",
                   help="smoke mode: 3 batches per epoch, one query chunk per eval"
                        " (the reference's --debug, cone/config.py:27-28)")
    t.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of the first epoch into <workdir>/profile:"
                        " every thread, with the program's cone.* spans (utils/trace.py)")
    t.add_argument("--init_ckpt",
                   help="weights-only warm start from a reference-named torch file or a"
                        " JAX checkpoint (.msgpack: a workdir's model_<tag>.msgpack or"
                        " tools/convert_ckpt.py --out's params file)")
    t.add_argument("--dump_config", metavar="PATH",
                   help="resolve preset/--config/--set, write the config json to PATH"
                        " and exit (no training)")
    t.add_argument("--tensorboard", action="store_true",
                   help="also write a TensorBoard log (needs the tensorboard package)")
    t.add_argument("--mesh", action="store_true",
                   help="data parallel over a group of this one rank (no --distributed)")
    t.add_argument("--distributed", action="store_true",
                   help="data parallel: this process is one rank; with --coordinator,"
                        " --num_processes and --process_id, or torchrun's environment;"
                        " the workdir must be shared by every rank")
    t.add_argument("--coordinator", help="rendezvous host:port (rank 0 listens there)")
    t.add_argument("--num_processes", type=int)
    t.add_argument("--process_id", type=int)
    _add_device(t)
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("infer", help="evaluate a checkpoint")
    i.add_argument("--workdir", required=True, help=WORKDIR_HELP)
    i.add_argument("--ckpt", default="best")
    i.add_argument("--eval_path")
    i.add_argument("--set", action="append", metavar="SEC.FIELD=VAL")
    i.add_argument("--fast_postproc", action="store_true",
                   help="batched on-device fusion+NMS instead of the"
                        " reference-exact host path")
    i.add_argument("--ego4d_gt",
                   help="official nested Ego4D GT json: also run the"
                        " challenge evaluator")
    i.add_argument("--fused", action="store_true",
                   help="fused inference (fastest; device postproc, all"
                        " three scoring modalities)")
    i.add_argument("--results_dir",
                   help="write predictions/submissions here instead of the"
                        " workdir (reference --eval_results_dir)")
    i.add_argument("--save_all", action="store_true",
                   help="also write the proposal/matching modality"
                        " prediction files (reference --save_all)")
    i.add_argument("--untrained", action="store_true",
                   help="evaluate fresh-init weights, no checkpoint"
                        " (reference --eval_untrained, cone/config.py:62)")
    _add_device(i)
    i.set_defaults(fn=cmd_infer)

    s = sub.add_parser("serve", help="HTTP moment-retrieval server over a"
                                     " trained workdir")
    s.add_argument("--workdir", required=True, help=WORKDIR_HELP)
    s.add_argument("--ckpt", default="best")
    s.add_argument("--set", action="append", metavar="SEC.FIELD=VAL")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--preload_path",
                   help="jsonl whose videos preload into the corpus (uses"
                        " the workdir config's feature stores)")
    s.add_argument("--text_backend", choices=["clip", "egovlp"],
                   help="accept raw-text queries, encoded on the device (omit:"
                        " requests must carry token/cls features)")
    s.add_argument("--text_engine", choices=["tower", "hf"],
                   help="--text_backend clip: " + ENGINE_HELP + " (default tower)")
    s.add_argument("--egovlp_checkpoint", help="released egovlp.pth (--text_backend egovlp)")
    s.add_argument("--batch_window_ms", type=float, default=0.0,
                   help="dynamic /search micro-batching: concurrent requests"
                        " arriving within this window share one device sweep"
                        " (0 = off, one dispatch per request)")
    s.add_argument("--max_batch", type=int, default=32,
                   help="micro-batching cap per device sweep")
    s.add_argument("--load_corpus",
                   help="directory written by /save_corpus (or"
                        " CorpusRetriever.save_corpus) to rebuild the"
                        " serving library from at startup")
    _add_device(s)
    s.set_defaults(fn=cmd_serve)

    d = sub.add_parser("demo", help="video file + query text -> ranked"
                       " moments (the reference's run_on_video/run.py)")
    d.add_argument("--workdir", required=True, help=WORKDIR_HELP)
    d.add_argument("--ckpt", default="best")
    d.add_argument("--set", action="append", metavar="SEC.FIELD=VAL")
    d.add_argument("--video", required=True, help="video file (ffmpeg)")
    d.add_argument("--query", action="append", required=True,
                   help="query text; repeat for several queries")
    d.add_argument("--backend", choices=["clip", "egovlp"], default="egovlp",
                   help="feature backbone (the reference demo is EgoVLP)")
    d.add_argument("--clip_engine", choices=["tower", "hf"],
                   help="--backend clip: " + ENGINE_HELP + " (default tower)")
    d.add_argument("--egovlp_checkpoint", help="released egovlp.pth (--backend egovlp)")
    d.add_argument("--cache_dir", default="feature_cache",
                   help="extracted-feature cache (run.py:30-38)")
    d.add_argument("--top_k", type=int, help="moments to print per query")
    _add_device(d)
    d.set_defaults(fn=cmd_demo)

    e = sub.add_parser("extract-text", help="query jsonl -> text feature stores")
    e.add_argument("--input", required=True, help="query jsonl")
    e.add_argument("--out", required=True, help="output dir (tokens.cfs + cls.cfs)")
    e.add_argument("--backend", choices=["clip", "roberta", "egovlp"], required=True)
    e.add_argument("--model", help="transformers model name")
    e.add_argument("--checkpoint", help="EgoVLP checkpoint (its txt_proj)")
    e.add_argument("--engine", choices=["tower", "hf"],
                   help="--backend clip: " + ENGINE_HELP + " (default tower); RoBERTa and"
                        " DistilBERT always run the transformers model")
    _add_device(e)
    e.set_defaults(fn=cmd_extract_text)

    ev = sub.add_parser("extract-video", help="video files -> clip-feature .cfs store")
    ev.add_argument("--videos", required=True, nargs="+",
                    help="clip_id=path pairs, or bare paths (id = basename)")
    ev.add_argument("--out", required=True, help="output .cfs path")
    ev.add_argument("--backend", choices=["clip", "egovlp"], default="clip")
    ev.add_argument("--checkpoint", help="EgoVLP .pth (--backend egovlp)")
    ev.add_argument("--model", help="transformers CLIP model name")
    ev.add_argument("--fps", type=float,
                    help="default: 5 frames/s for clip (MAD-style, train_mad.sh), 1.875"
                         " for egovlp")
    ev.add_argument("--batch_size", type=int,
                    help="default: 64 frames (clip) / 8 clips (egovlp)")
    ev.add_argument("--engine", choices=["tower", "hf"],
                    help="--backend clip: " + ENGINE_HELP + " (default tower)")
    _add_device(ev)
    ev.set_defaults(fn=cmd_extract_video)

    v = sub.add_parser("eval", help="recall tables from submission files"
                                    " (standalone, no model)")
    v.add_argument("--submission",
                   help="prediction jsonl (flat) or challenge json (ego4d"
                        " official, with --ego4d_gt); not used in"
                        " --ranklists mode")
    v.add_argument("--gt", help="flat GT jsonl (query_id + timestamps)")
    v.add_argument("--ego4d_gt", help="official nested Ego4D GT json")
    v.add_argument("--dset", choices=["ego4d", "mad"], default="ego4d",
                   help="default thresholds (ego4d: 0.3/0.5 + mIoU;"
                        " mad: 0.1/0.3/0.5)")
    v.add_argument("--thresholds", nargs="+")
    v.add_argument("--topK", nargs="+")
    v.add_argument("--no_match_number", action="store_true",
                   help="evaluate the intersection of query ids instead of"
                        " requiring identical sets")
    v.add_argument("--ranklists",
                   help="window-ranklist jsonl (from `infer`): report"
                        " coarse-stage window recall instead"
                        " (evaluate_pre_filtered_window.py)")
    v.add_argument("--clip_length", type=float, default=0.535,
                   help="seconds per clip (window-recall mode)")
    v.add_argument("--max_v_l", type=int, default=90,
                   help="window length in clips (window-recall mode)")
    v.add_argument("--title")
    v.add_argument("--out", help="append the table to this file")
    v.add_argument("--expect",
                   help="parity diff: comma list of R<k>@<t>=<percent> /"
                        " mIoU=<percent> (e.g. the reference README row"
                        " 'R1@0.3=14.15,R5@0.3=30.33'); exits nonzero if"
                        " any metric is off by more than --expect_tol")
    v.add_argument("--expect_tol", type=float, default=0.5,
                   help="absolute tolerance in recall points for --expect")
    v.set_defaults(fn=cmd_eval)

    n = sub.add_parser("ensemble", help="fuse N prediction jsonls"
                                        " (ECCV'22 recipe)")
    n.add_argument("--inputs", nargs="+", required=True,
                   help="2+ prediction jsonls (from `infer`)")
    n.add_argument("--output", required=True)
    n.add_argument("--max_input", type=int, default=4,
                   help="top-N rows taken from each model")
    n.add_argument("--top1_max_input", type=int, default=1,
                   help="rows per model fed to the clustered top-1 synthesis")
    n.set_defaults(fn=cmd_ensemble)

    r = sub.add_parser("reformat", help="challenge json -> flat jsonl")
    r.add_argument("--dset", choices=["ego4d", "mad"], required=True)
    r.add_argument("--input", required=True)
    r.add_argument("--output", required=True)
    r.add_argument("--test_split", action="store_true")
    r.add_argument("--filter_train", action="store_true")
    r.set_defaults(fn=cmd_reformat)

    c = sub.add_parser("convert-store", help="features -> packed .cfs store")
    c.add_argument("--input", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--format", choices=["lmdb", "h5", "npy_dir", "pt_dir"], required=True)
    c.add_argument("--array_key", default="features")
    c.set_defaults(fn=cmd_convert_store)

    args = p.parse_args(argv)
    if args.debug_nans:
        import torch

        with torch.autograd.detect_anomaly(check_nan=True):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    main()
