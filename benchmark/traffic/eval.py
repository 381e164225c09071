"""Offline grounding: whole `InferencePipeline.run_fused` passes over a
corpus (`eval/pipeline.make_pipeline`), as an evaluation or a
batch-indexing user runs them.

Mix parameters: videos, frames [lo, hi], queries_per_video [lo, hi],
query_tokens [lo, hi], signal (the corpus, `benchmark/data.py`);
check_queries (the sample the reference judges); trace_seconds (a traced
run times whole passes until this much has passed).

The window runs passes until `--seconds` have passed; the rate is the
queries whose three modalities' moments reached the host over the time
from the window's start to the end of the last pass. The check samples
queries from the last pass, from the seed.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from benchmark import counts
from benchmark.data import make_corpus, seeded_state_dict, sub_seed
from benchmark.reference import grounding as ref
from benchmark.traffic import program_dataset, program_model, reference_precision

MODALITIES = ref.MODALITIES
SPAN_TOL, SCORE_TOL = 1e-3, 2e-3   # seconds; fused, proposal and matching scores


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg

    # ------------------------------------------------------------ set-up

    def setup(self):
        ctx, cfg = self.ctx, self.cfg
        self.corpus = make_corpus(ctx.mix, ctx.seed, cfg.model.v_appear_feat_dim,
                                  cfg.model.t_feat_dim, cfg.data.max_v_l, ctx.device)
        params = seeded_state_dict(cfg.model, ctx.seed, ctx.device)
        self.ref_params = {k: v.clone() for k, v in params.items()}
        from cone_tpu_torch.eval.pipeline import make_pipeline

        self.pipe = make_pipeline(program_model(cfg, params, ctx.device),
                                  program_dataset(self.corpus, cfg.data), cfg,
                                  device=ctx.device)
        for attr, span in (("_fused", "dispatch"), ("_adapt", "adapt"),
                           ("_coarse", "coarse"), ("_fine", "fine")):
            ctx.tracer.wrap(self.pipe, attr, span)
        if ctx.fault:
            FAULTS[ctx.fault](self.pipe)
        self._count_work()
        self.pipe.run_fused()   # uploads the corpus, builds the kernel, warms every shape

    def _count_work(self):
        """What one pass needs (`benchmark/counts.py`)."""
        cfg, c = self.cfg, self.corpus
        pk = counts.peaks(torch.cuda.get_device_name(self.ctx.device)) \
            if self.ctx.device.type == "cuda" else dict(counts.H100_PEAKS)
        stride = cfg.data.max_v_l // 2
        qc = cfg.eval.query_chunk
        flops, bound, launches = 0.0, 0.0, 0
        for v, ctx_l in enumerate(c.ctx):
            qs = c.queries_of(v)
            flops += counts.eval_video_flops(cfg, int(ctx_l))
            flops += sum(counts.eval_query_flops(cfg, int(ctx_l), int(c.n_tok[q])) for q in qs)
            for i in range(0, len(qs), qc):
                n_q = len(qs[i:i + qc])
                bound += counts.coarse_bound_s(int(ctx_l), n_q, cfg.model.v_appear_feat_dim,
                                               -(-int(ctx_l) // stride), pk)[0]
                launches += 1
        dtype = cfg.model.compute_dtype
        self.pass_work = {"queries": len(c.query_ids), "flops": flops, "coarse_bound_s": bound,
                          "coarse_launches": launches, "peak_flops": pk[dtype]}

    # ------------------------------------------------------------ window

    def window(self, seconds: float) -> dict:
        limit = min(seconds, float(self.ctx.mix["trace_seconds"])) \
            if self.ctx.tracer.active else seconds
        n_q = len(self.corpus.query_ids)
        passes, failed = 0, 0
        t0 = time.perf_counter()
        while True:
            with self.ctx.tracer.span("pass"):
                out, ranks = self.pipe.run_fused()
            passes += 1
            got = {r["query_id"] for r in out["fusion"]}
            failed += n_q - len(got & set(self.corpus.query_ids))
            if time.perf_counter() - t0 >= limit:
                break
        elapsed = time.perf_counter() - t0
        self.out, self.ranks = out, ranks
        self.ctx.work.update({k: v * passes if k in ("queries", "flops", "coarse_bound_s",
                                                     "coarse_launches") else v
                              for k, v in self.pass_work.items()})
        self.ctx.work.update(passes=passes, units=passes * n_q, elapsed_s=elapsed)
        return {"metrics": {"queries_per_s": passes * n_q / elapsed},
                "attempted": passes * n_q, "failed": failed}

    def release(self):
        del self.pipe

    # ------------------------------------------------------------ check

    def sample(self) -> np.ndarray:
        n_q = len(self.corpus.query_ids)
        rng = np.random.default_rng(sub_seed(self.ctx.seed, "check"))
        return np.sort(rng.choice(n_q, size=min(int(self.ctx.mix["check_queries"]), n_q),
                                  replace=False))

    def check(self) -> dict:
        moments = {name: {r["query_id"]: r["predicted_times"] for r in self.out[name]}
                   for name in MODALITIES}
        return judge(self.cfg, self.corpus, self.ref_params, self.sample(), self.ranks,
                     moments, self.ctx.device)

    def control(self) -> dict:
        return control(self.cfg, self.corpus, self.ref_params, self.sample(), self.ctx.device)


def reference_outputs(cfg, corpus, params, sample, device, tf32=False, ranks=None):
    """The reference over the sampled queries: per query its window scores
    (numpy) and, over the top-K windows of `ranks` (the program's ranking,
    or the reference's own when None), its kept moments of each modality."""
    reference_precision(device, tf32)
    stride = cfg.data.max_v_l // 2
    k = cfg.data.topk_window
    by_video = defaultdict(list)
    for q in sample:
        by_video[int(corpus.video[q])].append(int(q))
    scores, kept, order = {}, {}, {}
    with torch.no_grad():
        for v, qs in by_video.items():
            raw = torch.from_numpy(corpus.feats[v]).to(device)
            cls = torch.from_numpy(corpus.cls[qs]).to(device)
            s = ref.coarse_scores(params, cfg.model, raw, cls, stride)
            own = ref.ranking(s).cpu().numpy()
            s = s.cpu().numpy()
            items = []
            for i, q in enumerate(qs):
                qid = corpus.query_ids[q]
                scores[qid] = s[i]
                order[qid] = own[i].tolist()
                rank = order[qid] if ranks is None else ranks.get(qid, [])
                wins = torch.tensor(rank[:k], dtype=torch.long, device=device)
                items.append((torch.from_numpy(corpus.tokens[q]).to(device), cls[i], wins))
            for q, (sec, prob, match) in zip(qs, ref.fine(params, cfg.model, cfg.data, raw, items)):
                kept[corpus.query_ids[q]] = ref.post(sec, prob, match, cfg.eval)
    reference_precision(device, False)
    return scores, kept, order


def judge(cfg, corpus, params, sample, ranks, moments, device) -> dict:
    """rank_gap: the largest reference-score gap of the program's window
    ranking (`reference/grounding.ranklist_gap`); moment_mismatch: the
    share of sampled (query, modality) whose kept moments differ from the
    reference's beyond 1e-3 s or 2e-3 in score, the reference's fine stage
    run over the program's top-K windows."""
    scores, kept, _ = reference_outputs(cfg, corpus, params, sample, device, ranks=ranks)
    gap, bad, n = 0.0, 0, 0
    for qid, s in scores.items():
        gap = max(gap, ref.ranklist_gap(s, ranks.get(qid, [])))
        for name in MODALITIES:
            got = moments[name].get(qid)
            n += 1
            bad += got is None or ref.moments_differ(got, kept[qid][name], SPAN_TOL, SCORE_TOL)
    return {"rank_gap": gap, "moment_mismatch": bad / max(n, 1)}


def control(cfg, corpus, params, sample, device) -> dict:
    """The control: the reference in TF32 put in the program's place,
    judged as the program is."""
    _, kept, order = reference_outputs(cfg, corpus, params, sample, device, tf32=True)
    moments = {name: {q: kept[q][name] for q in kept} for name in MODALITIES}
    return judge(cfg, corpus, params, sample, order, moments, device)


# ------------------------------------------------------- planted faults

def _answer_altered(pipe):
    """A kept moment of each dispatch's first query moved by 1 s where the
    fused dispatch produces it."""
    fused = pipe._fused

    def wrapped(*a):
        order, win_valid, k_sp, k_sc, k_va = fused(*a)
        k_sp = k_sp.clone()
        k_sp[:, :, 0, 0] += 1.0
        return order, win_valid, k_sp, k_sc, k_va

    pipe._fused = wrapped


def _half_batch(pipe):
    """The fine stage runs the first half of each query's windows and hands
    their results to the other half."""
    fine = pipe._fine

    def wrapped(appear, motion, ctx, win_idx, toks, tmask, cls):
        k = win_idx.shape[2]
        h = max(1, k // 2)
        out = fine(appear, motion, ctx, win_idx[:, :, :h], toks, tmask, cls)
        return tuple(torch.cat([o] * -(-k // h), dim=2)[:, :, :k] for o in out)

    pipe._fine = wrapped


FAULTS = {"answer": _answer_altered, "half_batch": _half_batch}
