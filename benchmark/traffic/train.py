"""Training: the loop body of `train/loop.train` from the benchmark's files,
as a training user's card-hours buy it.

    for batch in prefetch_iterator(batch_to_device(b) for b in TrainLoader.epoch(e)):
        metrics = to_floats(step_fn(batch, adapter_on))

Mix parameters: the corpus (videos, frames, queries_per_video,
query_tokens, signal, `benchmark/data.py`); first_epoch (the loader's epoch
the run starts at; the adapter is on from the recipe's
start_epoch_for_adapter); check_steps (the steps set-up runs and the reference follows);
trace_seconds (the traced window's length). Dropout is on. No evaluation
and no checkpoint runs in the window.

Set-up builds one training step (model, AdamW, step schedule) from the
seed, normalises every video into the loader's cache, and drives the step
through its first `check_steps` steps by the window's own feed; the window
continues the same feed with the same object. The check holds two stages
against the plain reference (`judge_start`, `judge_window`):

  * the start: the reference follows the first steps from the seeded
    weights; compared are the first step's loss and change;
  * a step of the window: before the first step that begins once half the
    window has passed, the model's and AdamW's state are copied; the
    reference takes that one step from the copy (the batch and the dropout
    draw it rebuilds from the seed and the step's number, its own AdamW
    over the copied moments and the step count the benchmark kept), and
    its loss terms, gradient norm before the clip and change are
    compared. The reference follows the program from the program's own
    state here: the start is the stage checked alone.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import counts
from benchmark.data import make_corpus, seeded_state_dict
from benchmark.reference import train as ref
from benchmark.traffic import program_dataset, program_model, reference_precision


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        # the run's seed drives the loader's order and the dropout masks
        self.cfg = ctx.cfg.replace(train=dataclasses.replace(ctx.cfg.train, seed=int(ctx.seed)))

    def setup(self):
        from cone_tpu_torch.data.dataset import TrainLoader
        from cone_tpu_torch.train.optim import make_optimizer
        from cone_tpu_torch.train.step import make_train_step

        ctx, cfg = self.ctx, self.cfg
        self.corpus = make_corpus(ctx.mix, ctx.seed, cfg.model.v_appear_feat_dim,
                                  cfg.model.t_feat_dim, cfg.data.max_v_l, ctx.device)
        params = seeded_state_dict(cfg.model, ctx.seed, ctx.device)
        self.w0 = {k: v.clone() for k, v in params.items()}
        ds = program_dataset(self.corpus, cfg.data)
        for clip in ds.video_ids:     # the loader's normalised-video cache, filled once
            ds.video_features(clip)
        self.model = program_model(cfg, params, ctx.device)
        self.loader = TrainLoader(ds, bsz=cfg.train.bsz, seed=cfg.train.seed)
        self.spe = self.loader.steps_per_epoch()
        self.opt, sched = make_optimizer(self.model, cfg.train, self.spe)
        self.step_fn = make_train_step(self.model, self.opt, sched, cfg)
        self.adapter_on = cfg.loss.adapter_loss and \
            int(ctx.mix["first_epoch"]) >= cfg.train.start_epoch_for_adapter
        if ctx.fault:
            FAULTS[ctx.fault](self)
        ctx.tracer.wrap(self, "step_fn", "step")
        self.epoch = int(ctx.mix["first_epoch"])
        self.done = []                 # (epoch, step in epoch) of every step run
        self._open_epoch()
        self.start = [self._step_judged() for _ in range(int(ctx.mix["check_steps"]))]

    def _state(self) -> dict:
        """A copy of the program's weights and AdamW moments."""
        st = self.opt.state

        def moment(p, key):
            return st[p][key].detach().clone() if p in st else torch.zeros_like(p)

        names = dict(self.model.named_parameters())
        return {"params": {k: v.detach().clone() for k, v in self.model.state_dict().items()},
                "m": {k: moment(p, "exp_avg") for k, p in names.items()},
                "v": {k: moment(p, "exp_avg_sq") for k, p in names.items()}}

    def _step_judged(self) -> dict:
        """One step of the feed, with the state before and after it."""
        t, before = len(self.done), self._state()
        metrics = self._step()
        return {"t": t, "at": self.done[-1], "before": before, "metrics": metrics,
                "after": self._state()}

    def _open_epoch(self):
        from cone_tpu_torch.data.prefetch import prefetch_iterator
        from cone_tpu_torch.train.step import batch_to_device

        dev = self.ctx.device
        self.feed = prefetch_iterator(batch_to_device(b, dev)
                                      for b in self.loader.epoch(self.epoch))
        self.in_epoch = 0

    def _step(self) -> dict:
        from cone_tpu_torch.train.step import to_floats

        with self.ctx.tracer.span("loader_wait"):
            batch = next(self.feed, None)
        if batch is None:
            self.epoch += 1
            self._open_epoch()
            with self.ctx.tracer.span("loader_wait"):
                batch = next(self.feed)
        metrics = to_floats(self.step_fn(batch, self.adapter_on))
        self.done.append((self.epoch, self.in_epoch))
        self.in_epoch += 1
        return metrics

    def window(self, seconds: float) -> dict:
        limit = min(seconds, float(self.ctx.mix["trace_seconds"])) \
            if self.ctx.tracer.active else seconds
        first = len(self.done)
        failed = 0
        self.judged = None
        t0 = time.perf_counter()
        while (now := time.perf_counter() - t0) < limit:
            if self.judged is None and now >= limit / 2:
                self.judged = self._step_judged()
                metrics = self.judged["metrics"]
            else:
                metrics = self._step()
            failed += not np.isfinite(metrics["loss_overall"])
        elapsed = time.perf_counter() - t0
        steps = len(self.done) - first
        if self.judged is None:      # no step began in the window's second half
            self.judged = self._step_judged()
        self._count_work(self.done[first:first + steps])
        self.ctx.work.update(steps=steps, units=steps, elapsed_s=elapsed)
        return {"metrics": {"train_samples_per_s": steps * self.cfg.train.bsz / elapsed},
                "attempted": steps, "failed": failed}

    def _count_work(self, done):
        """The samples the window trained, each counted at its own tokens."""
        cfg, bsz = self.cfg, self.cfg.train.bsz
        pk = counts.peaks(torch.cuda.get_device_name(self.ctx.device)) \
            if self.ctx.device.type == "cuda" else dict(counts.H100_PEAKS)
        n_tok = np.minimum(self.corpus.n_tok, cfg.data.max_q_l)
        orders, flops = {}, 0.0
        for epoch, step in done:
            if epoch not in orders:
                orders[epoch] = np.random.default_rng((cfg.train.seed, epoch)).permutation(
                    len(self.corpus.query_ids))
            for i in orders[epoch][step * bsz:(step + 1) * bsz]:
                flops += counts.train_sample_flops(cfg, int(n_tok[i]), bsz, self.adapter_on)
        self.ctx.work.update(flops=flops, peak_flops=pk[cfg.model.compute_dtype])

    def release(self):
        del self.step_fn, self.opt, self.model, self.feed

    # ------------------------------------------------------------ check

    def _examples(self):
        if not hasattr(self, "examples"):
            self.examples = ref.Examples(self.corpus, self.cfg.data)
        return self.examples

    def _reference_start(self, tf32: bool):
        cfg, dev = self.cfg, self.ctx.device
        reference_precision(dev, tf32)
        steps = ref.train_steps({k: v.clone() for k, v in self.w0.items()}, cfg,
                                self._examples(), cfg.train.seed,
                                int(self.ctx.mix["first_epoch"]), int(self.ctx.mix["check_steps"]),
                                self.adapter_on, self.spe, dev)
        reference_precision(dev, False)
        return steps

    def _reference_window(self, tf32: bool):
        """The reference's step from the copy taken before the judged step."""
        cfg, dev, j = self.cfg, self.ctx.device, self.judged
        reference_precision(dev, tf32)
        params = {k: v.clone() for k, v in j["before"]["params"].items()}
        opt = ref.AdamW(params, cfg.train, m=j["before"]["m"], v=j["before"]["v"], t=j["t"])
        out = ref.one_step(params, opt, cfg, self._examples(), cfg.train.seed, *j["at"],
                           self.adapter_on, self.spe, dev)
        reference_precision(dev, False)
        return out

    def check(self) -> dict:
        self.detail = {"program": {}, "control": {}}
        return {**judge_start(self._reference_start(False), self.w0, self.start,
                              self.detail["program"]),
                **judge_window(self._reference_window(False), self.judged, self.cfg.loss,
                               self.detail["program"])}

    def control(self) -> dict:
        """The reference in TF32 in the program's place, at both stages."""
        got = self._reference_start(True)
        start = [{"metrics": {"loss_overall": s["loss"]},
                  "after": {"params": s["params"], "m": _moments_of(s["grads"])}}
                 for s in got]
        w = self._reference_window(True)
        b1 = ref.AdamW.BETAS[0]
        m = {k: b1 * self.judged["before"]["m"][k] + (1 - b1) * g for k, g in w["grads"].items()}
        judged = dict(self.judged, metrics={**w["terms"], "grad_norm": w["grad_norm"]},
                      after={"params": w["params"], "m": m})
        return {**judge_start(self._reference_start(False), self.w0, start,
                              self.detail["control"]),
                **judge_window(self._reference_window(False), judged, self.cfg.loss,
                               self.detail["control"])}


def _moments_of(grads: dict) -> dict:
    """AdamW's first moment after one step on `grads`."""
    return {k: (1 - ref.AdamW.BETAS[0]) * g for k, g in grads.items()}


def _grad_as_adamw_got_it(m_after: dict, m_before: dict) -> dict:
    """The gradient of one update, read back from the first moment before
    and after it with the reference's beta1."""
    b1 = ref.AdamW.BETAS[0]
    return {k: (m_after[k] - b1 * m_before[k]) / (1 - b1) for k in m_after}


def _leaf_gaps(ref_norms: dict, norms: dict, keep) -> dict:
    """Each kept parameter's gap between the program's and the reference's
    norm, over the larger of the reference's norm of that parameter and of
    the median parameter's."""
    med = float(np.median([ref_norms[k] for k in keep]))
    return {k: abs(norms[k] - ref_norms[k]) / max(ref_norms[k], med) for k in keep}


def _changes(w_after, w_before, keep) -> dict:
    return {k: float((w_after[k] - w_before[k]).norm()) for k in keep}


def _kept(ref_grads: dict):
    """(gradient norms, kept parameters): those whose reference gradient is
    at least a thousandth of the median parameter's (the others, nought to
    rounding, are moved by round-off and decay alone)."""
    rg = {k: float(v.norm()) for k, v in ref_grads.items()}
    med = float(np.median(list(rg.values())))
    return rg, [k for k in rg if rg[k] >= 1e-3 * med]


def judge_start(ref_steps, w0, start, detail=None) -> dict:
    """The first step from the seeded weights: loss_gap, the relative gap
    of its weighted loss; median_change_gap, at the median kept parameter,
    the gap between the program's and the reference's norm of its change
    over the step, over the larger of the reference's norm of that
    parameter's change and of the median parameter's. `detail` receives
    what is read and not compared (PERF.md says why): each step's loss
    gap, the same change gaps after each step at the worst and the median
    parameter, grad_gap (the worst parameter's gap of norms of the first
    gradient as AdamW got it, its first moment over 1 - beta1) and, of
    step 1, the entries whose change has the other sign than the
    reference's."""
    rel = [abs(s["metrics"]["loss_overall"] - r["loss"]) / abs(r["loss"])
           for s, r in zip(start, ref_steps)]
    rg, keep = _kept(ref_steps[0]["grads"])
    gaps = [_leaf_gaps(_changes(r["params"], w0, keep),
                       _changes(s["after"]["params"], w0, keep), keep)
            for r, s in zip(ref_steps, start)]
    if detail is not None:
        zeros = {k: torch.zeros_like(v) for k, v in ref_steps[0]["grads"].items()}
        g1 = {k: float(v.norm()) for k, v in
              _grad_as_adamw_got_it(start[0]["after"]["m"], zeros).items()}
        flips = {k: (torch.sign(start[0]["after"]["params"][k] - w0[k])
                     != torch.sign(ref_steps[0]["params"][k] - w0[k])) for k in keep}
        g_abs = torch.cat([ref_steps[0]["grads"][k].abs().flatten() for k in keep])
        flipped = torch.cat([ref_steps[0]["grads"][k].abs()[flips[k]] for k in keep])
        detail.update(
            step_loss_gaps=rel, grad_gap=max(_leaf_gaps(rg, g1, list(rg)).values()),
            median_change_gaps=[float(np.median(list(g.values()))) for g in gaps],
            worst_change_gaps=[max(g.values()) for g in gaps],
            worst_change=[max(g, key=g.get) for g in gaps],
            left_out=[k for k in rg if k not in keep],
            step1_sign_flips=int(flipped.numel()), step1_entries=int(g_abs.numel()),
            step1_flipped_grad_max=float(flipped.max()) if flipped.numel() else 0.0,
            step1_grad_median=float(g_abs.median()))
    return {"loss_gap": rel[0], "median_change_gap": float(np.median(list(gaps[0].values())))}


def judge_window(ref_step, judged, loss_cfg, detail=None) -> dict:
    """The judged step of the window, from the copy taken before it:
    window_loss_gap, the largest gap of a weighted criterion term (and of
    the total) over the reference's total; window_grad_norm_gap, the
    relative gap of the gradient norm before the clip;
    window_median_change_gap, at the median kept parameter, the gap of
    norms of its change over the step. `detail` receives the worst
    parameter's gaps, read and not compared: of the gradient as AdamW got
    it ((exp_avg after - beta1 exp_avg before) / (1 - beta1)) and of the
    change."""
    got = judged["metrics"]
    total = abs(ref_step["terms"]["loss_overall"])
    loss_gaps = {k: ref.term_weight(k, loss_cfg) * abs(got.get(k, np.inf) - r) / total
                 for k, r in ref_step["terms"].items()}
    rg, keep = _kept(ref_step["grads"])
    w0 = judged["before"]["params"]
    change = _leaf_gaps(_changes(ref_step["params"], w0, keep),
                        _changes(judged["after"]["params"], w0, keep), keep)
    if detail is not None:
        g = {k: float(v.norm()) for k, v in _grad_as_adamw_got_it(
            judged["after"]["m"], judged["before"]["m"]).items()}
        grad_gaps = _leaf_gaps(rg, g, list(rg))
        detail.update(window_step=judged["t"], window_at=list(judged["at"]),
                      window_loss_term=max(loss_gaps, key=loss_gaps.get),
                      window_grad_gap=max(grad_gaps.values()),
                      window_worst_grad=max(grad_gaps, key=grad_gaps.get),
                      window_change_gap=max(change.values()),
                      window_worst_change=max(change, key=change.get))
    return {"window_loss_gap": max(loss_gaps.values()),
            "window_grad_norm_gap": abs(float(got["grad_norm"]) - ref_step["grad_norm"])
            / ref_step["grad_norm"],
            "window_median_change_gap": float(np.median(list(change.values())))}


# ------------------------------------------------------- planted faults

def _state_unchanged(drv):
    """The optimizer's step leaves the weights as they were."""
    drv.opt.step = lambda *a, **k: None


def _half_batch(drv):
    """The step trains on the first half of each batch's rows."""
    fn = drv.step_fn

    def wrapped(batch, adapter_on=False):
        h = len(batch["query_tokens"]) // 2
        return fn({k: v[:h] for k, v in batch.items()}, adapter_on)

    drv.step_fn = wrapped


def _moments_reset(drv):
    """AdamW's moments and step count start over at every step: its first
    step's update, lr times about the sign of the gradient, at each."""
    fn = drv.step_fn

    def wrapped(batch, adapter_on=False):
        drv.opt.state.clear()
        return fn(batch, adapter_on)

    drv.step_fn = wrapped


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "moments_reset": _moments_reset}
