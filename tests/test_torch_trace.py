"""The program's spans (cone_tpu_torch/utils/trace.py) on the CPU: off by
default and then free of profiler events; on under torch.profiler with
every thread profiled, the fused pass, the train step and the HTTP service
emit their phases on the threads that run them, properly nested, on the
clock of `time.time_ns()`; outputs are the same bits either way. One
`cuda` test holds the device side: a kernel launched inside a span on a
thread other than the main one falls to that span in the benchmark's
`TraceView`. The file imports neither jax nor cone_tpu.
"""

import base64
import json
import sys
import threading
import time
import urllib.request
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity

from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig, TrainConfig
from cone_tpu_torch.data import TrainLoader, make_synthetic_dataset
from cone_tpu_torch.data.prefetch import prefetch_iterator
from cone_tpu_torch.eval.pipeline import InferencePipeline
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.serve.server import MomentService, make_server
from cone_tpu_torch.train.optim import make_optimizer
from cone_tpu_torch.train.step import batch_to_device, make_train_step, to_floats
from cone_tpu_torch.utils import trace

DIM = 16
EVAL_SPANS = {"fused", "fused.adapt", "fused.coarse", "fused.fine", "fused.post",
              "pipeline.stage", "pipeline.fetch", "pipeline.assemble", "prefetch.wait"}
STEP_SPANS = {"step", "step.forward", "step.backward", "step.clip", "step.update",
              "step.readback", "data.to_device"}
CORPUS_SPANS = {"corpus.scan", "corpus.merge", "corpus.fine", "corpus.post"}


@pytest.fixture(autouse=True)
def one_thread_tracing_off():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert not trace.enabled()
    try:
        yield
    finally:
        trace.enable(False)
        torch.set_num_threads(threads)


def _cfg():
    return ConeConfig(
        model=ModelConfig(hidden_dim=16, nheads=2, enc_layers=1, dec_layers=1,
                          dim_feedforward=32, t_feat_dim=DIM, v_motion_feat_dim=DIM,
                          v_appear_feat_dim=DIM, max_q_l=8, max_v_l=16),
        data=DataConfig(max_v_l=16, max_q_l=8, clip_length=1.0, topk_window=4,
                        max_ctx_l=128, max_windows=5),
        eval=EvalConfig(query_chunk=4, nms_thd=0.5, max_after_nms=5),
        train=TrainConfig(lr=1e-4, bsz=4))


def _dataset(cfg):
    return make_synthetic_dataset(cfg.data, n_videos=3, queries_per_video=5,
                                  ctx_l_range=(60, 120), dim=DIM, seed=0)


def _model(cfg, seed=0):
    torch.manual_seed(seed)
    return ConeModel(cfg.model, device="cpu")


class Spans:
    """The `cone.` events of one profiled call: (name, profiler thread id,
    start_ns, end_ns) each."""

    def __init__(self, events):
        self.all = [(e.name()[len(trace.PREFIX):], e.start_thread_id(), e.start_ns(),
                     e.start_ns() + e.duration_ns())
                    for e in events if e.name().startswith(trace.PREFIX)]

    def names(self):
        return {s[0] for s in self.all}

    def of(self, name):
        return [s for s in self.all if s[0] == name]

    def threads(self, name):
        return {s[1] for s in self.of(name)}

    def inside(self, child, parent):
        """Every `child` lies within a `parent` on its own thread."""
        return all(any(p[1] == c[1] and p[2] <= c[2] and c[3] <= p[3] for p in self.of(parent))
                   for c in self.of(child))

    def nested(self):
        """No two spans of one thread overlap without one holding the other."""
        by_thread = defaultdict(list)
        for s in self.all:
            by_thread[s[1]].append(s)
        for lst in by_thread.values():
            lst.sort(key=lambda s: (s[2], -s[3]))
            stack = []
            for s in lst:
                while stack and stack[-1][3] <= s[2]:
                    stack.pop()
                if stack and s[3] > stack[-1][3]:
                    return False
                stack.append(s)
        return True


def _profiled(fn, spans_on=True):
    """(fn(), Spans) under a CPU profiler of every thread."""
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        trace.enable(spans_on)
        try:
            out = fn()
        finally:
            trace.enable(False)
    return out, Spans(prof.profiler.kineto_results.events())


def test_off_is_one_shared_no_op_span_and_the_profile_holds_no_cone_event():
    with trace.span("fused") as entered:
        assert entered is None
    assert trace.span("fused") is trace.span("fused")
    assert not isinstance(trace.span("fused"), torch.profiler.record_function)
    cfg = _cfg()
    pipe = InferencePipeline(_model(cfg), _dataset(cfg), cfg, device="cpu")
    _, spans = _profiled(pipe.run_fused, spans_on=False)
    assert spans.all == []
    trace.enable(True)
    assert isinstance(trace.span("fused"), torch.profiler.record_function)


def test_a_decorated_function_checks_the_flag_at_each_call():
    @trace.span("demo")
    def f(x):
        return x + 1

    assert f(1) == 2 and f.__name__ == "f"
    out, spans = _profiled(lambda: f(2))
    assert out == 3 and [s[0] for s in spans.all] == ["demo"]
    _, spans = _profiled(lambda: f(2), spans_on=False)
    assert spans.all == []


def test_run_fused_emits_every_eval_span_on_its_thread():
    cfg = _cfg()
    pipe = InferencePipeline(_model(cfg), _dataset(cfg), cfg, device="cpu")
    pipe.run_fused()
    _, spans = _profiled(pipe.run_fused)
    assert spans.names() == EVAL_SPANS
    n = len(spans.of("fused"))
    assert n == 6 and len(spans.of("pipeline.stage")) == n   # 3 videos x 2 chunks
    assert len(spans.of("pipeline.fetch")) == len(spans.of("pipeline.assemble")) == 1
    main = spans.threads("fused")
    assert len(main) == 1 and spans.threads("pipeline.stage").isdisjoint(main)
    assert spans.threads("prefetch.wait") == main == spans.threads("pipeline.assemble")
    for child in ("fused.adapt", "fused.coarse", "fused.fine", "fused.post"):
        assert len(spans.of(child)) == n and spans.inside(child, "fused")
    assert spans.nested()


def test_train_step_and_readback_emit_the_step_spans():
    cfg = _cfg()
    ds = _dataset(cfg)
    model = _model(cfg)
    opt, sched = make_optimizer(model, cfg.train, steps_per_epoch=4)
    step = make_train_step(model, opt, sched, cfg)

    def two_steps():
        feed = prefetch_iterator(batch_to_device(b, "cpu")
                                 for b in TrainLoader(ds, bsz=4, seed=0).epoch(0))
        try:
            return [to_floats(step(next(feed), True)) for _ in range(2)]
        finally:
            feed.close()

    _, spans = _profiled(two_steps)
    assert spans.names() == STEP_SPANS | {"prefetch.wait"}
    main = spans.threads("step")
    assert len(spans.of("step")) == 2 and len(main) == 1
    for child in ("step.forward", "step.backward", "step.clip", "step.update"):
        assert len(spans.of(child)) == 2 and spans.inside(child, "step")
    assert spans.threads("step.readback") == main
    # the loader's thread copies the batches; inside the step they pass through
    assert spans.threads("data.to_device") - main
    assert spans.nested()


def _b64(a):
    return base64.b64encode(np.ascontiguousarray(a, "<f4").tobytes()).decode()


@pytest.fixture(scope="module")
def library():
    rng = np.random.default_rng(3)
    videos = {f"v{i}": rng.normal(size=(int(rng.integers(40, 90)), DIM)).astype(np.float32)
              for i in range(3)}
    queries = [dict(token_features_b64=_b64(rng.normal(size=(6, DIM))), token_shape=[6, DIM],
                    cls_feature_b64=_b64(rng.normal(size=DIM)), top_moments=3)
               for _ in range(3)]
    return videos, queries


def _serve(library, batch_window_ms, send):
    """send(call) against a live HTTP service over `library`, then /stats."""
    videos, _ = library
    cfg = _cfg()
    svc = MomentService(_model(cfg), cfg, batch_window_ms=batch_window_ms, device="cpu")
    for cid, feats in videos.items():
        svc.retriever.add_video(cid, feats)
    srv = make_server(svc)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def call(path, payload=None):
        req = urllib.request.Request(
            base + path, data=None if payload is None else json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        return send(call), call("/stats")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


@pytest.mark.parametrize("batch_window_ms", [0.0, 20.0])
def test_search_over_http_emits_serving_and_corpus_spans(library, batch_window_ms):
    _, queries = library

    def send(call):
        call("/search", queries[0])   # warm: the library stacks
        return _profiled(lambda: call("/search", queries[1]))

    (answer, spans), stats = _serve(library, batch_window_ms, send)
    assert answer["moments"]
    assert spans.names() == {"serve.queue", "serve.search", "serve.reply"} | CORPUS_SPANS
    handler = spans.threads("serve.reply")
    assert len(handler) == 1 and len(spans.of("serve.queue")) == 1
    assert spans.threads("serve.queue") == handler
    # the device work runs on the handler's thread, or the micro-batcher's
    worker = spans.threads("serve.search")
    assert (worker == handler) == (batch_window_ms == 0.0)
    for name in CORPUS_SPANS:
        assert spans.threads(name) == worker and spans.inside(name, "serve.search")
    assert spans.nested()
    assert stats["requests"]["search"] == 2
    assert set(stats["mean_queue_s"]) == set(stats["requests"])
    assert 0 <= stats["mean_queue_s"]["search"] <= stats["mean_latency_s"]["search"] + 1.0


def test_concurrent_searches_through_the_micro_batcher_all_return(library):
    """More clients than cores, the interpreter switching threads often:
    each request's queue hand-off (submit, the batch taking the lock, the
    answer) completes, every answer is the one a lone request gets, and
    the counters add up."""
    videos, queries = library
    cfg = _cfg()
    svc = MomentService(_model(cfg), cfg, batch_window_ms=5.0, max_batch=4, device="cpu")
    for cid, feats in videos.items():
        svc.retriever.add_video(cid, feats)
    want = [svc.handle("POST", "/search", q) for q in queries]
    n = 24
    got = [None] * n

    def client(i):
        got[i] = svc.handle("POST", "/search", queries[i % len(queries)])

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert all(g == want[i % len(queries)] and g[0] == 200 for i, g in enumerate(got))
    stats = svc.stats()
    assert stats["dynamic_batching"]["batched_queries"] == n + len(queries)
    assert stats["requests"]["search"] == stats["dynamic_batching"]["batches"]
    assert 0 <= stats["mean_queue_s"]["search"] < 120


def test_outputs_are_the_same_bits_with_tracing_on_and_off(library):
    cfg = _cfg()
    pipe = InferencePipeline(_model(cfg), _dataset(cfg), cfg, device="cpu")
    off = pipe.run_fused()
    on, _ = _profiled(pipe.run_fused)
    assert json.dumps(on) == json.dumps(off)

    def steps(traced):
        model = _model(cfg, seed=1)
        opt, sched = make_optimizer(model, cfg.train, steps_per_epoch=4)
        step = make_train_step(model, opt, sched, cfg)
        batches = TrainLoader(_dataset(cfg), bsz=4, seed=0).epoch(0)
        run = lambda: [to_floats(step(next(batches), True)) for _ in range(2)]  # noqa: E731
        metrics = _profiled(run)[0] if traced else run()
        return metrics, model.state_dict()

    (m_off, w_off), (m_on, w_on) = steps(False), steps(True)
    assert m_on == m_off
    assert all(torch.equal(w_on[k], w_off[k]) for k in w_off)

    _, queries = library
    got = _serve(library, 0.0, lambda call: (
        call("/search", queries[2]), _profiled(lambda: call("/search", queries[2]))[0]))[0]
    assert got[0] == got[1]


def test_a_span_starts_on_the_clock_of_time_ns():
    def inside():
        with trace.span("clock"):
            return time.time_ns()

    t_ns, spans = _profiled(inside)
    (start,) = [s[2] for s in spans.of("clock")]
    assert abs(start - t_ns) <= 1_000_000


@pytest.mark.cuda
def test_a_kernel_launched_in_a_span_off_the_main_thread_gets_its_device_time():
    """The benchmark's TraceView, given the program's spans of every
    thread, puts a kernel launched on another thread inside that thread's
    open span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the span's device time comes from CUPTI")
    from benchmark.trace import TraceView

    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum().item()

    def launch():
        with trace.span("worker"):
            for _ in range(4):
                y = x @ x
            torch.cuda.synchronize()
        return y

    def work():
        with trace.span("main"):
            t = threading.Thread(target=launch)
            t.start()
            t.join(timeout=60)
        assert not t.is_alive()

    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        trace.enable(True)
        work()
        trace.enable(False)
    ops, runtime, spans = [], {}, defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type().name == "CUDA":   # the spans' device-side copies left out
            if not e.is_user_annotation():
                ops.append((name, e.start_ns(), e.duration_ns(), "kernel", e.correlation_id()))
        elif name.startswith(trace.PREFIX):
            spans[e.start_thread_id()].append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                               name))
        elif name.startswith("cu"):
            runtime[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    (main,), (worker,) = ({tid for tid, lst in spans.items() if any(s[2] == f"cone.{n}"
                                                                      for s in lst)}
                          for n in ("main", "worker"))
    assert main != worker
    view = TraceView.build(1.0, ops, runtime, spans)
    gemm = sum(o[2] for o in ops if "gemm" in o[0].lower())
    assert gemm > 0 and view.span_device_ns["cone.worker"] >= gemm
    assert view.span_device_ns.get("cone.main", 0) == 0
