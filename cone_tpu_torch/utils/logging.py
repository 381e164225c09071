"""Training logs: timestamped text files and an append-only jsonl stream.

The reference's TensorBoard writer, train.log.txt and eval tables files
(cone/train.py:105-119, 127-146) become `metrics.jsonl` (records of kind
"hparams", "train_epoch" and "eval"), `train.log.txt` and
`eval_results.txt`, the same files as the JAX package's MetricLogger. A
TensorBoard writer is attached on request (`tensorboard=True`) when the
package is importable; importing it can pull in TensorFlow, which takes
tens of seconds, so it is off by default. Data parallel: rank 0 writes,
the other ranks' loggers write nothing (every rank holds the global
metrics).
"""

from __future__ import annotations

import json
import os
import time

from cone_tpu_torch.parallel import distributed


class MetricLogger:
    def __init__(self, workdir: str, tensorboard: bool = False):
        self.workdir = workdir
        self.enabled = distributed.is_main()
        os.makedirs(workdir, exist_ok=True)
        self.jsonl_path = os.path.join(workdir, "metrics.jsonl")
        self.text_path = os.path.join(workdir, "train.log.txt")
        self.eval_path = os.path.join(workdir, "eval_results.txt")
        self._tb = None
        if tensorboard and self.enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("tensorboard is not installed: no TensorBoard log")
            else:
                self._tb = SummaryWriter(os.path.join(workdir, "tensorboard_log"))

    def _append(self, path: str, text: str) -> None:
        if not self.enabled:
            return
        with open(path, "a") as f:
            f.write(text + "\n")

    def log_train_epoch(self, record: dict) -> None:
        self._append(self.jsonl_path,
                     json.dumps({"ts": time.time(), "kind": "train_epoch", **record}))
        losses = " ".join(f"{k} {v:.4f}" for k, v in record.items()
                          if isinstance(v, float) and k.startswith("loss"))
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
        self._append(self.text_path, f"{stamp} [Epoch] {record['epoch']:03d} [Loss] {losses}")
        if self._tb:
            for k, v in record.items():
                if isinstance(v, (int, float)) and k != "epoch":
                    self._tb.add_scalar(f"Train/{k}", v, record["epoch"])

    def log_eval(self, epoch: int, stop_score: float, lr: float = None,
                 losses: dict = None) -> None:
        """losses: eval-split criterion terms, also logged as Eval/{k}
        scalars (the reference's eval-loss channel, cone/inference.py:96-98)."""
        rec = {"ts": time.time(), "kind": "eval", "epoch": epoch, "stop_score": stop_score}
        if lr is not None:
            rec["lr"] = lr
        if losses:
            rec.update({f"eval_{k}": float(v) for k, v in losses.items()})
        self._append(self.jsonl_path, json.dumps(rec))
        if self._tb:
            self._tb.add_scalar("Eval/stop_score", stop_score, epoch)
            if lr is not None:
                self._tb.add_scalar("Train/lr", lr, epoch)
            for k, v in (losses or {}).items():
                self._tb.add_scalar(f"Eval/{k}", float(v), epoch)

    def log_text(self, text: str) -> None:
        self._append(self.eval_path, text)

    def log_hparams(self, cfg_dict: dict, parallel: dict = None) -> None:
        """The run's hyperparameters, once at the start of training (the
        reference writes them to TensorBoard as a markdown table,
        cone/train.py:128), and its data-parallel layout."""
        self._append(self.jsonl_path,
                     json.dumps({"ts": time.time(), "kind": "hparams", "config": cfg_dict,
                                 "parallel": parallel}))
        if self._tb:
            flat = _flatten(cfg_dict)
            md = "| key | value |\n|---|---|\n" + "\n".join(
                f"| {k} | {v} |" for k, v in sorted(flat.items()))
            self._tb.add_text("hyperparameters", md)

    def close(self) -> None:
        if self._tb:
            self._tb.close()


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out
