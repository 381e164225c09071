"""HTTP serving front end: JSON in, ranked moments out.

The reference stops at a Python demo script (run_on_video/run.py); this is
the deployment-shaped counterpart - a threaded stdlib HTTP server wrapping
the serving paths (OnlineLocalizer for one-shot videos, CorpusRetriever
for the resident library), with health/stats endpoints and a single device
lock: request handlers run in ThreadingHTTPServer threads and the
micro-batcher in its own, all on the default stream, and the lock keeps
their device work apart. torch.inference_mode() is thread-local, so it is
entered inside each call that touches the model (as pipe.run and
search_batch do), never once at construction.

Endpoints (all JSON):
  GET  /healthz    {"ok", "backend", "videos"}
  GET  /stats      request counters, per-endpoint mean latency and mean
                   wait for the device lock (mean_queue_s), corpus size,
                   the corpus search's fine stage ("fine": windows refined,
                   dispatches)
  POST /add_video  {"clip_id", "features": [[...]], "motion_features"?}
  POST /append_video {"clip_id", "features", "motion_features"?}
                   (streaming ingest: grow a resident video's timeline)
  POST /remove_video {"clip_id"}       evict from the serving library
  POST /save_corpus  {"dir"}           persist the library (.cfs stores)
  POST /load_corpus  {"dir"}           rebuild a saved library
  POST /search     {"token_features", "cls_feature", "query"?,
                    "top_moments"?, "search_windows"?,
                    "adaptive_margin"?}                  -> corpus ranking
  POST /search_batch {"queries": [...per-query dicts...],
                    "top_moments"?, "search_windows"?}   -> batched ranking
  POST /localize   {"video_features", "token_features", "cls_feature",
                    "query"?, "top_k"?}                  -> one-video moments
`token_features`/`cls_feature` may be omitted when the service was built
with a text encoder (then pass "query" text alone). Bulk clients should
send features binary: `token_features_b64` (base64 LE float32) +
`token_shape` [Lq, Dt] + `cls_feature_b64`: decimal-text JSON costs
about four times the bytes.

With `batch_window_ms > 0` (cli serve --batch_window_ms) concurrent
/search requests micro-batch server-side: the first arrival opens a short
window and everything inside it shares one device sweep, so independent
clients get /search_batch throughput without coordinating.

No third-party server dependency: stdlib http.server is enough because the
device lock serializes the hot path anyway; front-line TLS/auth belongs on
whatever proxy fronts the pod.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

import numpy as np

from cone_tpu_torch.utils.device import resolve_device
from cone_tpu_torch.utils.trace import span


class _MicroBatcher:
    """Dynamic server-side batching for /search.

    Concurrent single-query requests coalesce into ONE device sweep
    (retriever.search_batch, pinned equal to per-query search by
    tests/test_torch_serve.py): the first arrival opens a window of
    `window_s`, everything that lands inside it (up to `max_batch`) shares
    the coarse scans, each query keeping fine dispatches of its own. This is what
    /search_batch gives cooperating bulk clients, without requiring clients
    to coordinate. Requests with different (search_windows, top_moments)
    options split into per-signature sub-batches.
    """

    def __init__(self, service: "MomentService", window_s: float,
                 max_batch: int):
        import queue

        self.service = service
        self.window_s = window_s
        self.max_batch = max_batch
        self._q: "queue.Queue" = queue.Queue()
        self.batches = 0
        self.batched_queries = 0
        threading.Thread(target=self._loop, daemon=True,
                         name="search-microbatcher").start()

    def submit(self, tok, cls, query, search_windows, top_moments,
               adaptive_margin):
        done, locked = threading.Event(), threading.Event()
        slot: dict = {"since": time.time(), "locked": locked}
        with span("serve.queue"):
            self._q.put((tok, cls, query,
                         (search_windows, top_moments, adaptive_margin),
                         done, slot))
            locked.wait()
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _loop(self):
        import queue

        while True:
            batch = [self._q.get()]
            deadline = time.time() + self.window_s
            while len(batch) < self.max_batch:
                left = deadline - time.time()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                by_opts = defaultdict(list)
                for item in batch:
                    by_opts[item[3]].append(item)
            except Exception as e:  # unhashable options - endpoint coercion
                for *_, done, slot in batch:  # makes this unreachable, but a
                    slot["error"] = e         # dead batcher thread would hang
                    slot["locked"].set()      # every later /search forever
                    done.set()
                continue
            for (sw, tm, am), items in by_opts.items():
                svc = self.service
                slots = [it[5] for it in items]
                try:
                    results = svc._locked(
                        "search",
                        lambda: svc.retriever.search_batch(
                            [it[0] for it in items],
                            np.stack([it[1] for it in items]),
                            queries=[it[2] for it in items],
                            search_windows=sw, top_moments=tm,
                            adaptive_margin=am),
                        since=sum(s["since"] for s in slots) / len(slots),
                        waiting=[s["locked"] for s in slots])
                except Exception as e:  # propagate to every waiter
                    for *_, done, slot in items:
                        slot["error"] = e
                        slot["locked"].set()
                        done.set()
                else:
                    self.batches += 1
                    self.batched_queries += len(items)
                    for it, res in zip(items, results):
                        it[5]["result"] = res
                        it[4].set()


class MomentService:
    """Request-level wrapper over the serving components.

    text_encoder: optional `query_text -> (token_feats (Lq, Dt),
    cls_feat (Dt,))` letting clients
    send raw text instead of features.

    batch_window_ms > 0 enables dynamic /search micro-batching: the first
    request opens a collection window and concurrent requests share one
    device sweep (see _MicroBatcher). 0 (default) keeps one dispatch per
    request - the latency-optimal setting for a single client.
    """

    def __init__(self, model, cfg, text_encoder: Optional[Callable] = None,
                 dataset=None, batch_window_ms: float = 0.0,
                 max_batch: int = 32, device="cuda"):
        from cone_tpu_torch.serve.corpus import CorpusRetriever
        from cone_tpu_torch.serve.localizer import OnlineLocalizer

        self.device = resolve_device(device)
        self.retriever = CorpusRetriever(model, cfg, dataset=dataset,
                                         device=self.device)
        self.localizer = OnlineLocalizer(model, cfg, device=self.device)
        self.text_encoder = text_encoder
        if text_encoder is not None:
            # fail fast (and warm the encoder): a text backend whose dims
            # don't match the served model would otherwise die per-request
            # deep in the pipeline's staging buffers. tokens feed the
            # transformer (t_feat_dim); cls feeds the matching branch
            # (v_appear_feat_dim) - see docs/DATA.md on the pairing.
            tok, cls = text_encoder("warmup")
            td, cd = np.asarray(tok).shape[-1], np.asarray(cls).shape[-1]
            assert td == cfg.model.t_feat_dim and cd == cfg.model.v_appear_feat_dim, (
                f"text encoder produces {td}-d tokens / {cd}-d cls but the"
                f" model expects t_feat_dim={cfg.model.t_feat_dim} /"
                f" v_appear_feat_dim={cfg.model.v_appear_feat_dim} - pick a"
                " --text_backend matching the features the model trained on")
        self._device_lock = threading.Lock()
        self._counts = defaultdict(int)
        self._lat_sum = defaultdict(float)
        self._queue_sum = defaultdict(float)
        self.batcher = (_MicroBatcher(self, batch_window_ms / 1e3, max_batch)
                        if batch_window_ms > 0 else None)

    # ------------------------------------------------------------ helpers

    def _text(self, payload) -> Tuple[np.ndarray, np.ndarray]:
        if "token_features_b64" in payload:
            # binary features: base64 little-endian float32, row-major.
            # Decimal-text JSON costs about 4x the bytes.
            import base64

            tok = np.frombuffer(
                base64.b64decode(payload["token_features_b64"]), "<f4",
            ).reshape(payload["token_shape"]).astype(np.float32)
            cls = np.frombuffer(
                base64.b64decode(payload["cls_feature_b64"]), "<f4",
            ).astype(np.float32)
            return tok, cls
        if "token_features" in payload and "cls_feature" in payload:
            return (np.asarray(payload["token_features"], np.float32),
                    np.asarray(payload["cls_feature"], np.float32))
        assert self.text_encoder is not None, (
            "no token_features/cls_feature in request and the service has"
            " no text encoder")
        tok, cls = self.text_encoder(payload["query"])
        return np.asarray(tok, np.float32), np.asarray(cls, np.float32)

    def _locked(self, name: str, fn, since=None, waiting=()):
        """fn() under the device lock, counted and timed as endpoint `name`
        (span `serve.<name>`); its queue is the wait from `since` (default:
        now) to taking the lock, and each event of `waiting` is set once
        the lock is taken."""
        if since is None:
            since = time.time()
            with span("serve.queue"):
                self._device_lock.acquire()
        else:  # the requests' own threads keep serve.queue open until `waiting` is set
            self._device_lock.acquire()
        try:
            t0 = time.time()
            self._queue_sum[name] += t0 - since
            for ev in waiting:
                ev.set()
            try:
                with span("serve." + name):
                    return fn()
            finally:
                self._counts[name] += 1
                self._lat_sum[name] += time.time() - t0
        finally:
            self._device_lock.release()

    # ---------------------------------------------------------- endpoints

    def healthz(self) -> dict:
        return {"ok": True, "backend": self.device.type,
                "videos": len(self.retriever.clip_ids)}

    def stats(self) -> dict:
        lat = {k: round(self._lat_sum[k] / max(self._counts[k], 1), 4)
               for k in self._counts}
        queue = {k: round(self._queue_sum[k] / max(self._counts[k], 1), 4)
                 for k in self._counts}
        r = self.retriever
        out = {"requests": dict(self._counts), "mean_latency_s": lat, "mean_queue_s": queue,
               "videos": len(r.clip_ids), "total_clips": r.total_clips(),
               "fine": {"windows": r.fine_windows, "dispatches": r.fine_dispatches}}
        if self.batcher is not None:
            b = self.batcher
            out["dynamic_batching"] = {
                "batches": b.batches, "batched_queries": b.batched_queries,
                "mean_batch": round(b.batched_queries / max(b.batches, 1), 2)}
        return out

    def add_video(self, payload: dict) -> dict:
        feats = np.asarray(payload["features"], np.float32)
        motion = payload.get("motion_features")
        motion = None if motion is None else np.asarray(motion, np.float32)
        self._locked("add_video", lambda: self.retriever.add_video(
            payload["clip_id"], feats, motion_feats=motion))
        return {"ok": True, "clip_id": payload["clip_id"],
                "clips": len(feats)}

    def append_video(self, payload: dict) -> dict:
        """Streaming ingest: grow a resident video's timeline (live feeds);
        searches after this see the extended video."""
        feats = np.asarray(payload["features"], np.float32)
        motion = payload.get("motion_features")
        motion = None if motion is None else np.asarray(motion, np.float32)
        n = self._locked("append_video", lambda: self.retriever.append_video(
            payload["clip_id"], feats, motion_feats=motion))
        return {"ok": True, "clip_id": payload["clip_id"], "clips": n}

    def remove_video(self, payload: dict) -> dict:
        """Evict a video from the serving library (device memory reclaimed
        at the next search's restack)."""
        self._locked("remove_video",
                     lambda: self.retriever.remove_video(payload["clip_id"]))
        return {"ok": True, "clip_id": payload["clip_id"],
                "videos": len(self.retriever.clip_ids)}

    def save_corpus(self, payload: dict) -> dict:
        """Persist the resident library to `dir` (server-side path) - the
        durability path for live-ingested videos."""
        n = self._locked("save_corpus",
                         lambda: self.retriever.save_corpus(payload["dir"]))
        return {"ok": True, "videos": n, "dir": payload["dir"]}

    def load_corpus(self, payload: dict) -> dict:
        n = self._locked("load_corpus",
                         lambda: self.retriever.load_corpus(payload["dir"]))
        return {"ok": True, "videos_loaded": n,
                "videos": len(self.retriever.clip_ids)}

    def search(self, payload: dict) -> dict:
        tok, cls = self._text(payload)
        # coerce BEFORE submit: an unhashable search_windows (e.g. a list)
        # reaching the batcher's by-options grouping would kill the batcher
        # thread and hang every later /search - fail the request here (400)
        sw = payload.get("search_windows")
        sw = None if sw is None else int(sw)
        tm = int(payload.get("top_moments", 10))
        am = payload.get("adaptive_margin")
        am = None if am is None else float(am)
        if self.batcher is not None:
            moments = self.batcher.submit(tok, cls, payload.get("query", ""),
                                          sw, tm, am)
        else:
            moments = self._locked("search", lambda: self.retriever.search(
                tok, cls, query=payload.get("query", ""),
                search_windows=sw, top_moments=tm, adaptive_margin=am))
        for m in moments:  # tuples -> lists for JSON
            m["span"] = [float(m["span"][0]), float(m["span"][1])]
        return {"moments": moments}

    def search_batch(self, payload: dict) -> dict:
        """Batched corpus search: {"queries": [{"token_features",
        "cls_feature"} | {"query"}...], "top_moments"?, "search_windows"?}.
        All queries share the per-bucket coarse scans, and each query's
        windows run packed in fine dispatches of its own - the throughput
        surface for bulk clients
        (one sweep over the corpus instead of one per request)."""
        rows = payload["queries"]
        toks, clss = [], []
        for row in rows:
            tok, cls = self._text(row)
            toks.append(tok)
            clss.append(cls)
        am = payload.get("adaptive_margin")
        sw = payload.get("search_windows")
        results = self._locked(
            "search_batch",
            lambda: self.retriever.search_batch(
                toks, np.stack(clss),
                queries=[r.get("query", "") for r in rows],
                search_windows=None if sw is None else int(sw),
                top_moments=int(payload.get("top_moments", 10)),
                adaptive_margin=None if am is None else float(am)))
        for moments in results:
            for m in moments:
                m["span"] = [float(m["span"][0]), float(m["span"][1])]
        return {"results": [{"moments": m} for m in results]}

    def localize(self, payload: dict) -> dict:
        tok, cls = self._text(payload)
        vid = np.asarray(payload["video_features"], np.float32)
        tk = payload.get("top_k")
        times = self._locked("localize", lambda: self.localizer.localize(
            vid, tok, cls, query=payload.get("query", ""),
            top_k=None if tk is None else int(tk)))
        return {"moments": [[float(x) for x in row] for row in times]}

    def handle(self, method: str, path: str, payload: Optional[dict]):
        """Route one request; returns (status, body dict)."""
        try:
            if method == "GET" and path == "/healthz":
                return 200, self.healthz()
            if method == "GET" and path == "/stats":
                return 200, self.stats()
            if method == "POST" and path == "/add_video":
                return 200, self.add_video(payload)
            if method == "POST" and path == "/append_video":
                return 200, self.append_video(payload)
            if method == "POST" and path == "/remove_video":
                return 200, self.remove_video(payload)
            if method == "POST" and path == "/save_corpus":
                return 200, self.save_corpus(payload)
            if method == "POST" and path == "/load_corpus":
                return 200, self.load_corpus(payload)
            if method == "POST" and path == "/search":
                return 200, self.search(payload)
            if method == "POST" and path == "/search_batch":
                return 200, self.search_batch(payload)
            if method == "POST" and path == "/localize":
                return 200, self.localize(payload)
            return 404, {"error": f"no route {method} {path}"}
        except (KeyError, AssertionError, ValueError, TypeError,
                OSError) as e:
            # TypeError covers malformed binary fields (non-string b64,
            # non-list token_shape); OSError covers save/load_corpus paths
            # - same 400 as other bad payloads
            return 400, {"error": f"{type(e).__name__}: {e}"}


def make_server(service: MomentService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; .server_address[1] has the bound
    port (pass port=0 for an ephemeral one). Run with serve_forever()."""

    class Handler(BaseHTTPRequestHandler):
        @span("serve.reply")
        def _reply(self, status: int, body: dict):
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._reply(*service.handle("GET", self.path, None))

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                self._reply(400, {"error": f"bad json: {e}"})
                return
            self._reply(*service.handle("POST", self.path, payload))

        def log_message(self, *a):  # quiet; /stats carries the counters
            pass

    return ThreadingHTTPServer((host, port), Handler)
