"""Data-parallel training: `train.py`'s loop on every rank of a group of
`ranks` processes, one card a rank, the gradients summed by the program's
all-reduce (`parallel/distributed.GroupReduce.sum_grads`, NCCL where every
rank has a card of its own, gloo on the CPU).

Mix parameters: `train.py`'s, and ranks. Each rank trains the recipe's
`train.bsz` rows of every global batch of ranks x bsz (its row block,
`parallel/mesh.row_block`); the dropout masks are drawn for the global
batch and each rank keeps its rows (`train/step.py`), so the group's step
is the one-process step over the global batch.

Rank 0 runs in the harness's process and starts ranks 1 .. ranks-1 as
processes of this module (`python -m benchmark.traffic.train_dp`), which
rebuild the cell from the same seed and step until rank 0's count of
steps. The steps' own collectives keep the ranks in step; nothing else
passes between them while they train. Once its windows are over, rank 0
writes to every other rank's standard input the count of steps it has
run plus one, and runs that last step: a rank that began it before reading
the count finds rank 0 in it, and no rank begins the step after. Each
rank feeds its loader's row block in its own loop, on an intra-op thread
pool of its share of the host's cores. The check is `train.py`'s on rank
0, the reference taking the whole global batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import select
import socket
import subprocess
import sys

import torch

from benchmark.traffic import train as base

# a rank that fails or lags beyond this many seconds fails the run
TIMEOUT_S = 180


def _no_allreduce(drv):
    """Each rank updates with its own rows' gradient: the all-reduce of
    the gradients is left out."""
    drv.reduce.sum_grads = lambda params: None


FAULTS = {"state_unchanged": base.FAULTS["state_unchanged"],
          "half_batch": base.FAULTS["half_batch"], "no_allreduce": _no_allreduce}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Driver(base.Driver):
    def __init__(self, ctx, rank: int = 0, coordinator: str | None = None):
        super().__init__(ctx)
        self.world = int(ctx.mix["ranks"])
        self.rank = rank
        self.coordinator = coordinator
        self.cfg = self.cfg.replace(train=dataclasses.replace(
            self.cfg.train, bsz=self.cfg.train.bsz * self.world))
        self.workers = []

    def setup(self):
        from cone_tpu_torch.data.dataset import TrainLoader
        from cone_tpu_torch.parallel import distributed
        from cone_tpu_torch.parallel.mesh import row_block
        from cone_tpu_torch.train.optim import make_optimizer
        from cone_tpu_torch.train.step import make_train_step

        from benchmark.data import make_corpus, seeded_state_dict
        from benchmark.traffic import program_dataset, program_model

        ctx, cfg = self.ctx, self.cfg
        if ctx.device.type == "cuda":
            torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // self.world))
        if self.rank == 0:
            self.coordinator = f"127.0.0.1:{_free_port()}"
            self._start_workers()
        dev = distributed.initialize(coordinator=self.coordinator, num_processes=self.world,
                                     process_id=self.rank, device=ctx.device.type,
                                     timeout_s=TIMEOUT_S)
        if self.rank == 0 and dev != ctx.device:
            raise RuntimeError(f"rank 0 runs on {dev}, the harness measures {ctx.device}")
        ctx.device = dev
        self.reduce = distributed.batch_reduce()
        self.corpus = make_corpus(ctx.mix, ctx.seed, cfg.model.v_appear_feat_dim,
                                  cfg.model.t_feat_dim, cfg.data.max_v_l, dev)
        params = seeded_state_dict(cfg.model, ctx.seed, dev)
        self.w0 = {k: v.clone() for k, v in params.items()}
        ds = program_dataset(self.corpus, cfg.data)
        for clip in ds.video_ids:     # the loader's normalised-video cache, filled once
            ds.video_features(clip)
        self.model = program_model(cfg, params, dev)
        self.loader = TrainLoader(ds, bsz=cfg.train.bsz, seed=cfg.train.seed)
        self.rows = row_block(cfg.train.bsz, self.rank, self.world)
        self.spe = self.loader.steps_per_epoch()
        self.opt, sched = make_optimizer(self.model, cfg.train, self.spe)
        self.step_fn = make_train_step(self.model, self.opt, sched, cfg, self.reduce)
        self.adapter_on = cfg.loss.adapter_loss and \
            int(ctx.mix["first_epoch"]) >= cfg.train.start_epoch_for_adapter
        if ctx.fault:
            FAULTS[ctx.fault](self)
        ctx.tracer.wrap(self, "step_fn", "step")
        self.epoch = int(ctx.mix["first_epoch"])
        self.done = []
        self._open_epoch()
        if self.rank == 0:
            self.start = [self._step_judged() for _ in range(int(ctx.mix["check_steps"]))]

    def _start_workers(self):
        from benchmark import manifest

        spec = {"cell": self.ctx.cell["name"], "seed": int(self.ctx.seed),
                "device": self.ctx.device.type, "coordinator": self.coordinator,
                "fault": self.ctx.fault, "config": self.ctx.cfg.to_json(), "mix": self.ctx.mix}
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(manifest.ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        for r in range(1, self.world):
            self.workers.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.traffic.train_dp", "--rank", str(r),
                 "--spec", json.dumps(spec)], cwd=str(manifest.ROOT), env=env,
                stdout=sys.stderr, stdin=subprocess.PIPE, text=True))

    def _open_epoch(self):
        from cone_tpu_torch.data.prefetch import prefetch_iterator
        from cone_tpu_torch.train.step import batch_to_device

        dev = self.ctx.device
        self.feed = prefetch_iterator(batch_to_device(b, dev)
                                      for b in self.loader.epoch(self.epoch, *self.rows))
        self.in_epoch = 0

    def follow(self):
        """A rank above 0: step until rank 0's count of steps, polling its
        standard input for the count before each step."""
        last = None
        while last is None or len(self.done) < last:
            if last is None and select.select([sys.stdin], [], [], 0)[0]:
                line = sys.stdin.readline()
                if not line:
                    raise RuntimeError("rank 0 closed the group without a count of steps")
                last = int(line)
                if len(self.done) > last:
                    raise RuntimeError(f"rank {self.rank} ran {len(self.done)} steps, "
                                       f"rank 0 {last}")
                continue
            self._step()

    def release(self):
        from cone_tpu_torch.parallel import distributed

        if self.rank == 0 and self.workers:
            last = len(self.done) + 1
            for w in self.workers:
                w.stdin.write(f"{last}\n")
                w.stdin.close()
            self._step()     # the step a rank may have begun before it read the count
        self.feed.close()       # the loader's thread stops at its next batch
        distributed.shutdown()
        for w in self.workers:
            if w.wait(timeout=TIMEOUT_S):
                raise RuntimeError(f"a rank exited with {w.returncode}")
        self.workers = []
        super().release()


def main(argv=None):
    """One rank above 0 of a cell's group, as rank 0 starts it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--spec", required=True)
    args = ap.parse_args(argv)
    spec = json.loads(args.spec)

    from cone_tpu_torch.config import ConeConfig

    from benchmark import manifest
    from benchmark.harness import RunContext
    from benchmark.trace import NoTracer

    cell = manifest.cell(manifest.load(), spec["cell"])
    cfg = ConeConfig.from_json(spec["config"], strict=True)
    if spec["device"] == "cpu":
        torch.set_num_threads(2)
    ctx = RunContext(cell=cell, cfg=cfg, mix=spec["mix"], seed=spec["seed"],
                     device=torch.device(spec["device"]), tracer=NoTracer(), fault=spec["fault"])
    drv = Driver(ctx, rank=args.rank, coordinator=spec["coordinator"])
    drv.setup()
    drv.follow()
    drv.release()
    # leave at once: the loader's daemon thread may still be finishing a
    # batch, which a normal interpreter teardown can abort in
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
