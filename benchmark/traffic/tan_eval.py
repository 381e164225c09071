"""Offline grounding with the 2D-TAN head: whole `run_fused` passes of the
pipeline `eval/pipeline.make_pipeline` builds for a TAN configuration
(`eval/tan_pipeline.TanInferencePipeline`), as `eval.py` drives CONE's.

Mix parameters and the window are `eval.py`'s. The differences:

  * the weights: the TAN model's own table (`reference/tan.param_shapes`),
    from one uniform draw on the device (`seeded_state_dict`);
  * the work: `benchmark/tan_counts.py` (the map over the dense grid cuDNN
    computes, the text, matching and the coarse product), and the coarse
    kernel's least time and launches as `eval.py` counts them;
  * the spans of a traced run: besides `eval.py`'s, `bench.tan_text` around
    the LSTM (the model's `fusion_layer.textual_encoder`), `bench.tan_map`
    around the model's forward (the text inside it; the readers take it
    out) and `bench.tan_window_nms` around `tan_pipeline.within_window_nms`;
  * the check: `reference/tan.py` over the program's top-K windows, which
    decides the 0.4 s grid's IoU ties in the configuration's float32.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from benchmark import counts, tan_counts
from benchmark.data import generator, make_corpus
from benchmark.reference import grounding
from benchmark.reference import tan as ref
from benchmark.traffic import eval as base
from benchmark.traffic import program_dataset, reference_precision

MODALITIES = grounding.MODALITIES
SPAN_TOL, SCORE_TOL = base.SPAN_TOL, base.SCORE_TOL
FAULTS = base.FAULTS
PRED_GAIN = 30.0


def seeded_state_dict(t, seed: int, device) -> dict:
    """The TAN model's parameters from one uniform draw u in [-1, 1) on the
    device: a weight u * sqrt(3 / fan_in) (variance 1 / fan_in); a map
    convolution's k^2 times that (variance k^2 / C_in: the count
    renormalisation divides each output by up to k^2 cells, and a smaller
    draw shrinks the map to its biases); the prediction's PRED_GAIN times
    (a map's logits then spread by about 1 over its cells, and its best
    cells lie apart by about 1e-3 in probability, not by a few ulps); the
    LSTM's and every bias u / sqrt(fan_in), torch's default bound."""
    shapes = ref.param_shapes(t)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    u = torch.rand(sum(sizes), generator=generator(seed, device, "weights"), device=device)
    u = u * 2 - 1
    out, pos = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        x = u[pos:pos + n].view(shape)
        pos += n
        if "textual_encoder" in name:
            x = x / t.txt_hidden_size ** 0.5
        elif name.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            x = x * (3.0 / fan_in) ** 0.5
            if name.startswith("map_layer"):
                x = x * float(shape[-1] * shape[-2])
            elif name.startswith("pred_layer"):
                x = x * PRED_GAIN
        else:
            fan_in = int(np.prod(shapes[name[:-len("bias")] + "weight"][1:]))
            x = x / fan_in ** 0.5
        out[name] = x.contiguous()
    return out


class Driver(base.Driver):
    def setup(self):
        from cone_tpu_torch.eval import tan_pipeline
        from cone_tpu_torch.eval.pipeline import make_pipeline
        from cone_tpu_torch.models.tan import ConeTanModel

        ctx, cfg = self.ctx, self.cfg
        self.corpus = make_corpus(ctx.mix, ctx.seed, cfg.tan.v_feat_dim, cfg.tan.t_feat_dim,
                                  cfg.data.max_v_l, ctx.device)
        params = seeded_state_dict(cfg.tan, ctx.seed, ctx.device)
        self.ref_params = {k: v.clone() for k, v in params.items()}
        model = ConeTanModel(cfg.tan, device=ctx.device)
        model.load_state_dict(params, strict=True)
        self.pipe = make_pipeline(model, program_dataset(self.corpus, cfg.data), cfg,
                                  device=ctx.device)
        for attr, span in (("_fused", "dispatch"), ("_coarse", "coarse"), ("_fine", "fine")):
            ctx.tracer.wrap(self.pipe, attr, span)
        ctx.tracer.wrap(self.pipe.model, "forward", "tan_map")
        ctx.tracer.wrap(self.pipe.model.fusion_layer.textual_encoder, "forward", "tan_text")
        self._nms = (tan_pipeline, "within_window_nms", tan_pipeline.within_window_nms)
        ctx.tracer.wrap(tan_pipeline, "within_window_nms", "tan_window_nms")
        if ctx.fault:
            FAULTS[ctx.fault](self.pipe)
        self._count_work()
        self.pipe.run_fused()   # uploads the corpus, builds the kernel, warms every shape

    def _count_work(self):
        """What one pass needs (`benchmark/tan_counts.py`): every real query
        and its windows; `tan_map_flops` the maps alone; the coarse
        kernel's least time and launches (`counts.coarse_bound_s`, one
        launch a query chunk of a film), as `eval.py` counts them."""
        cfg, c = self.cfg, self.corpus
        pk = counts.peaks(torch.cuda.get_device_name(self.ctx.device)) \
            if self.ctx.device.type == "cuda" else dict(counts.H100_PEAKS)
        stride = cfg.data.max_v_l // 2
        qc = cfg.eval.query_chunk
        flops = sum(tan_counts.query_flops(cfg, int(c.ctx[c.video[q]]), int(c.n_tok[q]))
                    for q in range(len(c.query_ids)))
        windows = sum(min(cfg.data.topk_window, -(-int(c.ctx[c.video[q]]) // stride) + 1)
                      for q in range(len(c.query_ids)))
        bound, launches = 0.0, 0
        for v, ctx_l in enumerate(c.ctx):
            qs = c.queries_of(v)
            for i in range(0, len(qs), qc):
                bound += counts.coarse_bound_s(int(ctx_l), len(qs[i:i + qc]), cfg.tan.v_feat_dim,
                                               -(-int(ctx_l) // stride), pk)[0]
                launches += 1
        self.pass_work = {"queries": len(c.query_ids), "flops": flops,
                          "tan_map_flops": windows * tan_counts.map_flops(cfg.tan),
                          "coarse_bound_s": bound, "coarse_launches": launches,
                          "peak_flops": pk["float32"]}

    def window(self, seconds: float) -> dict:
        out = super().window(seconds)
        self.ctx.work["tan_map_flops"] = self.pass_work["tan_map_flops"] * self.ctx.work["passes"]
        return out

    def release(self):
        setattr(*self._nms)
        del self.pipe

    # ------------------------------------------------------------ check

    def check(self) -> dict:
        moments = {name: {r["query_id"]: r["predicted_times"] for r in self.out[name]}
                   for name in MODALITIES}
        self.detail = {}
        return judge(self.cfg, self.corpus, self.ref_params, self.sample(), self.ranks,
                     moments, self.ctx.device, self.detail)

    def control(self) -> dict:
        _, kept, order = reference_outputs(self.cfg, self.corpus, self.ref_params,
                                           self.sample(), self.ctx.device, tf32=True)
        moments = {name: {q: kept[q][name] for q in kept} for name in MODALITIES}
        return judge(self.cfg, self.corpus, self.ref_params, self.sample(), order, moments,
                     self.ctx.device)


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
            s = ref.coarse_scores(raw, cls, stride)
            own = grounding.ranking(s).cpu().numpy()
            s = s.cpu().numpy()
            items = []
            for i, q in enumerate(qs):
                qid = corpus.query_ids[q]
                scores[qid] = s[i]
                order[qid] = own[i].tolist()
                rank = order[qid] if ranks is None else ranks.get(qid, [])
                wins = torch.tensor(rank[:k], dtype=torch.long, device=device)
                items.append((torch.from_numpy(corpus.tokens[q]).to(device), cls[i], wins))
            outs = ref.fine(params, cfg.tan, cfg.data, raw, items, cfg.tan.proposal_top_k)
            for q, cand in zip(qs, outs):
                kept[corpus.query_ids[q]] = ref.post(*cand, cfg.eval, device)
    reference_precision(device, False)
    return scores, kept, order


def judge(cfg, corpus, params, sample, ranks, moments, device, detail=None) -> dict:
    """`eval.judge`'s two numbers against this reference: rank_gap, the
    largest reference-score gap of the program's window ranking;
    moment_mismatch, the share of sampled (query, modality) whose kept
    moments differ from the reference's beyond 1e-3 s or 2e-3 in score.
    `detail` receives each differing pair's two lists."""
    scores, kept, _ = reference_outputs(cfg, corpus, params, sample, device, ranks=ranks)
    gap, bad, n = 0.0, [], 0
    for qid, s in scores.items():
        gap = max(gap, grounding.ranklist_gap(s, ranks.get(qid, [])))
        for name in MODALITIES:
            got = moments[name].get(qid)
            n += 1
            if got is None or grounding.moments_differ(got, kept[qid][name], SPAN_TOL,
                                                       SCORE_TOL):
                bad.append({"query": qid, "modality": name, "program": got,
                            "reference": kept[qid][name]})
    if detail is not None:
        detail["mismatched"] = bad
    return {"rank_gap": gap, "moment_mismatch": len(bad) / max(n, 1)}
