"""The real-data recall-parity runbook through the port: given the released
assets (the eval annotations, the video and query feature stores, a trained
reference CONE checkpoint), convert, infer and diff the recall table
against the published row, every stage through the port's own CLI
(cone_tpu_torch.cli). The counterpart of scripts/parity_ego4d.sh and
scripts/parity_mad.sh (docs/REAL_DATA.md), with the same positional order
and defaults.

    python -m cone_tpu_torch.tools.parity {ego4d|mad} WORKDIR GT CKPT \\
        VIDEO_SRC TOKENS_SRC CLS_SRC [--src_format lmdb|npy_dir|pt_dir|h5|cfs] \\
        [--expect ROW] [--expect_tol T] [--preset P] [--set K=V ...] \\
        [--device cuda|cpu]

  GT          ego4d: the official nested challenge json (also the eval GT);
              mad: the flat eval jsonl (query_id + timestamps; `reformat
              --dset mad` turns the raw MAD json into one)
  CKPT        the reference's torch checkpoint (model_best.ckpt, its five
              keys {model, optimizer, lr_scheduler, epoch, opt})
  VIDEO_SRC, TOKENS_SRC, CLS_SRC   feature sources in --src_format (cfs:
              already-converted stores, linked in place)
  --expect    the row to diff (R<k>@<t>=<pct>, comma separated); default
              the published row of the dataset
  --preset    a preset name (default: the dataset's) or a config json

Stages: (1) `reformat` of the challenge json (Ego4D only); (2)
`convert-store` of the three sources into WORKDIR/features; (3) `train
--dump_config` at the preset into WORKDIR/run/config.json; (4) the
checkpoint copied beside it as model_reference.ckpt, which the port reads
as it is (train/checkpoint.py: no converter); (5) `infer --ckpt reference
--save_all` (Ego4D: with --ego4d_gt, the official evaluator); (6) `eval
--expect`. Exits nonzero when a stage fails or the diff misses.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional, Sequence

from cone_tpu_torch import cli

# the published rows (scripts/parity_ego4d.sh, scripts/parity_mad.sh)
EXPECT = {"ego4d": "R1@0.3=14.15,R5@0.3=30.33,R1@0.5=8.18,R5@0.5=18.02",
          "mad": "R1@0.3=6.73,R5@0.3=15.20,R10@0.3=20.07,R50@0.3=32.09"}
SRC_FORMATS = ("lmdb", "npy_dir", "pt_dir", "h5", "cfs")
CKPT_TAG = "reference"


def _store(src: str, dst: str, src_format: str) -> None:
    if src_format == "cfs":
        if os.path.lexists(dst):
            os.remove(dst)
        os.symlink(os.path.realpath(src), dst)
    else:
        cli.main(["convert-store", "--format", src_format, "--input", src, "--output", dst])


def run(dset: str, workdir: str, gt: str, ckpt: str, video_src: str, tokens_src: str,
        cls_src: str, src_format: str = "lmdb", expect: Optional[str] = None,
        expect_tol: float = 0.5, preset: Optional[str] = None, sets: Sequence[str] = (),
        device: str = "cuda") -> str:
    """The six stages of the module docstring; returns the run directory.
    A failed stage raises, and a missed diff raises SystemExit."""
    if dset not in EXPECT:
        raise ValueError(f"dataset {dset!r}: ego4d or mad")
    if src_format not in SRC_FORMATS:
        raise ValueError(f"--src_format {src_format!r}: one of {', '.join(SRC_FORMATS)}")
    feat, run_dir = os.path.join(workdir, "features"), os.path.join(workdir, "run")
    os.makedirs(os.path.join(feat, "text"), exist_ok=True)

    # 1. the challenge json -> the flat eval jsonl (MAD arrives flat)
    eval_path = gt
    if dset == "ego4d":
        eval_path = os.path.join(workdir, "val.jsonl")
        cli.main(["reformat", "--dset", "ego4d", "--input", gt, "--output", eval_path])

    # 2. the feature sources -> packed .cfs stores
    video = os.path.join(feat, "video.cfs")
    _store(video_src, video, src_format)
    _store(tokens_src, os.path.join(feat, "text", "tokens.cfs"), src_format)
    _store(cls_src, os.path.join(feat, "text", "cls.cfs"), src_format)

    # 3. the resolved config of the preset, pointed at the stores
    preset = preset or dset
    cfg_arg = ["--config", preset] if os.path.isfile(preset) else ["--preset", preset]
    overrides = [f"data.appearance_feat_dir={video}",
                 f"data.t_feat_dir={os.path.join(feat, 'text')}", *sets]
    cli.main(["train", *cfg_arg, "--workdir", run_dir, "--dump_config",
              os.path.join(run_dir, "config.json")]
             + [x for kv in overrides for x in ("--set", kv)])

    # 4. the reference checkpoint beside it, read as it is
    shutil.copyfile(ckpt, os.path.join(run_dir, f"model_{CKPT_TAG}.ckpt"))

    # 5. inference with every modality's file (Ego4D: the official evaluator too)
    infer = ["infer", "--workdir", run_dir, "--ckpt", CKPT_TAG, "--eval_path", eval_path,
             "--save_all", "--device", device]
    cli.main(infer + (["--ego4d_gt", gt] if dset == "ego4d" else []))

    # 6. the recall table against the expected row
    expect = ["--expect", expect or EXPECT[dset], "--expect_tol", str(expect_tol)]
    if dset == "ego4d":
        cli.main(["eval", "--submission",
                  os.path.join(run_dir, f"submission_ego4d_{CKPT_TAG}.json"),
                  "--ego4d_gt", gt] + expect)
    else:
        cli.main(["eval", "--dset", "mad", "--submission",
                  os.path.join(run_dir, f"inference_{CKPT_TAG}_preds.jsonl"),
                  "--gt", gt] + expect)
    return run_dir


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m cone_tpu_torch.tools.parity",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("dset", choices=sorted(EXPECT))
    ap.add_argument("workdir", help="output directory (created)")
    ap.add_argument("gt", help="ego4d: the nested challenge json; mad: the flat eval jsonl")
    ap.add_argument("ckpt", help="the reference's torch checkpoint")
    ap.add_argument("video_src")
    ap.add_argument("tokens_src")
    ap.add_argument("cls_src")
    ap.add_argument("--src_format", choices=SRC_FORMATS, default="lmdb")
    ap.add_argument("--expect", help="default: the dataset's published row")
    ap.add_argument("--expect_tol", type=float, default=0.5,
                    help="absolute tolerance in recall points")
    ap.add_argument("--preset", help="preset name or config json (default: the dataset's)")
    ap.add_argument("--set", action="append", default=[], metavar="SEC.FIELD=VAL",
                    help="config overrides of the dumped config")
    ap.add_argument("--device", default="cuda",
                    help="torch device of `infer` (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    run(args.dset, args.workdir, args.gt, args.ckpt, args.video_src, args.tokens_src,
        args.cls_src, args.src_format, args.expect, args.expect_tol, args.preset, args.set,
        args.device)


if __name__ == "__main__":
    main()
