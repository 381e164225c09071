"""Serving: single-query `POST /search` requests to the program's HTTP
service (`serve/server.make_server` over a `MomentService` on localhost in
this process) at a fixed open-loop rate, as independent users send them.

Mix parameters: the library (videos, frames, signal, `benchmark/data.py`)
and the request pool (queries_per_video x videos distinct queries of
query_tokens tokens); rate (requests/s, fixed in the mix: 0.8 of the
highest rate the port sustained in `benchmark/sweep_rate.py`); top_moments;
clients (sending threads); check_requests (the sample the reference
judges); warm_requests; trace_seconds.

Arrivals: the window's N = rate x seconds requests are due at the
cumulative sums of N exponential gaps taken at fixed quantiles, in one
fixed order (the same schedule for every seed: the order of the gaps sets
the bursts, and so the tail), scaled to end at the window's close; each
request is a pool query drawn from the seed. A request is
timed from when it was due to its complete response; the window waits for
every request due in it, up to a minute past the close; one that fails or
never finishes counts as failed and sits past every latency in the tail.
"""

from __future__ import annotations

import base64
import http.client
import json
import sys
import threading
import time

import numpy as np
import torch

from benchmark.data import make_corpus, seeded_state_dict, sub_seed
from benchmark.reference import search as ref
from benchmark.reference.grounding import l2n
from benchmark.traffic import program_model, reference_precision

SPAN_TOL, SCORE_TOL = 1e-3, 2e-3
GRACE_S = 60.0


def arrivals(rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of round(rate x seconds)
    requests: exponential gaps at fixed quantiles, in one fixed order."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = np.random.default_rng(sub_seed(0, "arrivals")).permutation(gaps)
    t = np.cumsum(gaps)
    return t / t[-1] * seconds * (n - 0.5) / n


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg

    def setup(self):
        from cone_tpu_torch.serve.server import MomentService, make_server

        ctx, cfg, mix = self.ctx, self.cfg, self.ctx.mix
        self.corpus = c = make_corpus(mix, ctx.seed, cfg.model.v_appear_feat_dim,
                                      cfg.model.t_feat_dim, cfg.data.max_v_l, ctx.device)
        params = seeded_state_dict(cfg.model, ctx.seed, ctx.device)
        self.ref_params = {k: v.clone() for k, v in params.items()}
        self.service = MomentService(program_model(cfg, params, ctx.device), cfg,
                                     device=ctx.device)
        for vid, feats in zip(c.video_ids, c.feats):
            self.service.retriever.add_video(vid, feats)
        # what a client sends: its extractor's normalised token rows and CLS
        self.toks = [l2n(torch.from_numpy(t)).numpy().astype("<f4") for t in c.tokens]
        self.clss = l2n(torch.from_numpy(c.cls)).numpy().astype("<f4")
        self.bodies = [json.dumps({
            "token_features_b64": base64.b64encode(t.tobytes()).decode(),
            "token_shape": list(t.shape),
            "cls_feature_b64": base64.b64encode(self.clss[i].tobytes()).decode(),
            "top_moments": int(mix["top_moments"])}).encode() for i, t in enumerate(self.toks)]
        self.server = make_server(self.service)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        # no spans: the service's handler threads are not the thread the
        # profiler runs on, and its callbacks are the thread's own; a traced
        # run reads the device's operations and the service's counters
        if ctx.fault:
            FAULTS[ctx.fault](self.service)
        rng = np.random.default_rng(sub_seed(ctx.seed, "warm"))
        for q in rng.choice(len(self.bodies), int(mix["warm_requests"]), replace=False):
            status, _ = self._post(int(q))
            if status != 200:
                raise RuntimeError(f"warm-up /search answered {status}")

    def _post(self, q: int):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=GRACE_S)
        try:
            conn.request("POST", "/search", body=self.bodies[q],
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def _stats(self) -> dict:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=GRACE_S)
        try:
            conn.request("GET", "/stats")
            return json.loads(conn.getresponse().read())
        finally:
            conn.close()

    def offer(self, rate: float, seconds: float, seed: int) -> dict:
        """Send the open-loop schedule; returns the latencies (inf for a
        failure), the queries, the answers and the sending delays."""
        due = arrivals(rate, seconds)
        n = len(due)
        pick = np.random.default_rng(sub_seed(seed, "requests")).integers(
            0, len(self.bodies), n)
        lat = np.full(n, np.inf)
        late = np.zeros(n)
        answers = [None] * n
        nxt = [0]
        lock = threading.Lock()
        t0 = time.perf_counter()

        def client():
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= n or time.perf_counter() > t0 + seconds + GRACE_S:
                    return
                wait = t0 + due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent = time.perf_counter()
                late[i] = sent - t0 - due[i]
                try:
                    status, body = self._post(int(pick[i]))
                except OSError:
                    continue
                if status == 200:
                    lat[i] = time.perf_counter() - t0 - due[i]
                    answers[i] = json.loads(body)["moments"]

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(int(self.ctx.mix["clients"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(0.0, t0 + seconds + GRACE_S - time.perf_counter()))
        return {"lat": lat, "pick": pick, "answers": answers, "late": late,
                "elapsed": time.perf_counter() - t0}

    def window(self, seconds: float) -> dict:
        limit = min(seconds, float(self.ctx.mix["trace_seconds"])) \
            if self.ctx.tracer.active else seconds
        before = self._stats()
        got = self.offer(float(self.ctx.mix["rate"]), limit, self.ctx.seed)
        after = self._stats()
        lat = got["lat"]
        done = np.isfinite(lat)
        self.pick, self.answers = got["pick"], got["answers"]
        p95 = float(np.percentile(lat, 95)) if done.all() else \
            float(np.sort(np.where(done, lat, np.inf))[int(np.ceil(0.95 * len(lat))) - 1])
        n_w = after["requests"].get("search", 0) - before["requests"].get("search", 0)
        mean = (after["mean_latency_s"]["search"] * after["requests"]["search"]
                - before["mean_latency_s"].get("search", 0) * before["requests"].get("search", 0))
        self.ctx.work.update(requests=int(done.sum()), service_ms=1e3 * mean / max(n_w, 1),
                             max_late_ms=1e3 * float(got["late"].max()))
        print(f"serve: {len(lat)} due, {int(done.sum())} answered, sending at most "
              f"{self.ctx.work['max_late_ms']:.3f} ms late", file=sys.stderr, flush=True)
        return {"metrics": {"search_p95_ms": 1e3 * p95}, "attempted": len(lat),
                "failed": int((~done).sum())}

    def release(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=GRACE_S)
        del self.service, self.server

    # ------------------------------------------------------------ check

    def sample(self) -> list:
        done = [i for i, a in enumerate(self.answers) if a is not None]
        rng = np.random.default_rng(sub_seed(self.ctx.seed, "check"))
        k = min(int(self.ctx.mix["check_requests"]), len(done))
        return sorted(rng.choice(done, k, replace=False).tolist()) if k else []

    def _reference(self, picks, tf32: bool):
        dev, cfg, c = self.ctx.device, self.cfg, self.corpus
        reference_precision(dev, tf32)
        with torch.no_grad():
            adapted = ref.adapted_library(self.ref_params, cfg.model, c.feats, dev)
            out = [ref.search(self.ref_params, cfg, c.video_ids, c.feats, adapted,
                              self.toks[q], self.clss[q], int(self.ctx.mix["top_moments"]), dev)
                   for q in picks]
        reference_precision(dev, False)
        return out

    def check(self) -> dict:
        idx = self.sample()
        want = self._reference([int(self.pick[i]) for i in idx], tf32=False)
        bad = sum(ref.answers_differ(self.answers[i], w, SPAN_TOL, SCORE_TOL)
                  for i, w in zip(idx, want))
        return {"answer_mismatch": bad / max(len(idx), 1)}

    def control(self) -> dict:
        idx = self.sample()
        picks = [int(self.pick[i]) for i in idx]
        want = self._reference(picks, tf32=False)
        got = self._reference(picks, tf32=True)
        bad = sum(ref.answers_differ(a, w, SPAN_TOL, SCORE_TOL) for a, w in zip(got, want))
        return {"answer_mismatch": bad / max(len(idx), 1)}


def _answer_altered(service):
    """The first moment of every answer moved by 1 s where the retriever
    produces it."""
    post = service.retriever._postprocess

    def wrapped(*a, **k):
        out = post(*a, **k)
        if out:
            st, ed = out[0]["span"]
            out[0]["span"] = (st + 1.0, ed + 1.0)
        return out

    service.retriever._postprocess = wrapped


FAULTS = {"answer": _answer_altered}
