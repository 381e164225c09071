"""The port's FLOP and byte models, reports and fused device time
(cone_tpu_torch/utils/perf.py) against cone_tpu/utils/perf.py, and its
counts against torch's own count of the port's modules.

  * every FLOP and byte field equals cone_tpu's, preset by preset and
    variant by variant, to 1e-12 relative;
  * each report's MFU and device-memory share is FLOPs (or bytes) x rate /
    the H100's published peak, to its 4-dp rounding, and every other key
    is cone_tpu's;
  * torch.utils.flop_counter.FlopCounterMode over the port's ConeModel and
    ConeTanModel forwards (meta device, full preset width: no arithmetic
    is done) and one CONE train step (the CPU at full width, bsz 4: the
    criterion's matcher reads values) lands within a stated limit of the
    analytic count;
  * device_time_fused on a CPU pipeline (host clock): positive times, one
    warm pass and `repeats` timed ones, and run_fused unchanged after it.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import cone_tpu.config as jconfig
from cone_tpu.utils import perf as jperf
from cone_tpu_torch import config
from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig, TanConfig
from cone_tpu_torch.convert import (
    load_reference_state_dict,
    load_reference_tan_state_dict,
    random_reference_state_dict,
    random_reference_tan_state_dict,
)
from cone_tpu_torch.data import TrainLoader, make_synthetic_dataset
from cone_tpu_torch.eval.pipeline import make_pipeline
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.models.tan import ConeTanModel
from cone_tpu_torch.train.loop import build_family
from cone_tpu_torch.train.optim import make_optimizer
from cone_tpu_torch.train.step import batch_to_device, make_train_step, to_floats
from cone_tpu_torch.utils import perf

H100 = "NVIDIA H100 80GB HBM3"
# NVIDIA's data sheet, H100 SXM, dense: float32 outside the tensor cores,
# bfloat16 in them, HBM3 bytes/s
H100_FP32, H100_BF16, H100_BYTES = 67e12, 989e12, 3.35e12
# FlopCounterMode's count over the analytic one, |1 - ratio|, measured:
# 2.7e-3 for a ConeModel window forward (the whole gap: the analytic model
# counts the span head's last layer, hidden -> 2, as hidden x hidden,
# 650 240 FLOPs a decoder layer at Ego4D); 1.5e-5 for a TAN window forward
# (the whole gap: the 1-channel count convolutions, which the port
# precomputes into buffers); 5.0e-3 for a train step (the head as above,
# and 2.3e-3 where the backward is not exactly twice the forward)
FORWARD_RTOL, TAN_RTOL, TRAIN_RTOL = 1e-2, 1e-3, 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Eager ops on the CPU beside the other test workers (as in
    tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replace(cfg, **sections):
    return dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k), **v)
                                       for k, v in sections.items()})


# id -> (preset, section overrides, ctx_pad, adapter_on)
CASES = {
    "ego4d": ("ego4d", {}, 2304, True),
    "ego4d_scratch": ("ego4d_scratch", {}, 2304, True),
    "mad": ("mad", {}, 65536, True),
    "mad_bucket_8192": ("mad", {}, 8192, True),
    "mad_scratch": ("mad_scratch", {}, 36864, True),
    "tan_ego4d": ("tan_ego4d", {}, 2304, True),
    "tan_mad": ("tan_mad", {}, 65536, True),
    "ego4d_corpus_bfloat16": ("ego4d", {"eval": {"corpus_dtype": "bfloat16"}}, 2304, True),
    "ego4d_corpus_int8": ("ego4d", {"eval": {"corpus_dtype": "int8"}}, 2304, True),
    "mad_corpus_int8_bucket_36864": ("mad", {"eval": {"corpus_dtype": "int8"}}, 36864, True),
    "ego4d_neg_loss_off": ("ego4d", {"loss": {"neg_loss": False}}, 2304, True),
    "ego4d_adapter_off": ("ego4d", {}, 2304, False),
    "tan_ego4d_sparse_conv": ("tan_ego4d", {"tan": {"prop_module": "sparse_conv"}}, 2304, True),
}


def _both(preset, overrides):
    """The preset from each package's own constructor, with the same
    overrides: (port config, cone_tpu config)."""
    return (_replace(getattr(config, f"{preset}_config")(), **overrides),
            _replace(getattr(jconfig, f"{preset}_config")(), **overrides))


@pytest.mark.parametrize("case", sorted(CASES))
def test_flop_and_byte_models_equal_cone_tpus(case):
    preset, overrides, ctx_pad, adapter_on = CASES[case]
    cfg, jcfg = _both(preset, overrides)
    assert perf._window_forward_flops(cfg.model) == pytest.approx(
        jperf._window_forward_flops(jcfg.model), rel=1e-12)
    got, want = perf.cone_flops_per_query(cfg, ctx_pad), jperf.cone_flops_per_query(jcfg, ctx_pad)
    for field in ("coarse_per_query", "fine_per_query", "adapt_per_video", "bytes_per_query",
                  "per_query"):
        assert getattr(got, field) == pytest.approx(getattr(want, field), rel=1e-12), field
    assert perf.tan_flops_per_query(cfg) == pytest.approx(jperf.tan_flops_per_query(jcfg),
                                                          rel=1e-12)
    assert perf.cone_train_flops_per_sample(cfg, adapter_on) == pytest.approx(
        jperf.cone_train_flops_per_sample(jcfg, adapter_on), rel=1e-12)


def _within_rounding(got, exact):
    """A 4-dp rounding of `exact`."""
    return abs(got - exact) <= 0.5e-4 * (1 + 1e-9)


@pytest.mark.parametrize("preset", ["ego4d", "ego4d_scratch", "mad", "mad_scratch"])
def test_perf_and_train_reports_against_the_h100_peaks(preset):
    cfg, jcfg = _both(preset, {})
    peak = H100_BF16 if cfg.model.compute_dtype == "bfloat16" else H100_FP32
    ctx_pad, n_q, dev_s, wall_qps = cfg.data.max_ctx_l, 256, 4.4e-4, 1800.0
    rep = perf.perf_report(cfg, ctx_pad, n_q, dev_s, wall_qps, chip=H100)
    fb = perf.cone_flops_per_query(cfg, ctx_pad)
    assert _within_rounding(rep["mfu"], fb.per_query / dev_s / peak)
    assert _within_rounding(rep["hbm_util"], fb.bytes_per_query / dev_s / H100_BYTES)
    assert rep["mfu"] > 0 and rep["hbm_util"] > 0 and rep["chip"] == H100
    want = jperf.perf_report(jcfg, ctx_pad, n_q, dev_s, wall_qps)
    assert set(rep) == set(want)
    assert {k: v for k, v in rep.items() if k not in ("mfu", "hbm_util", "chip")} == \
        pytest.approx({k: v for k, v in want.items() if k not in ("mfu", "hbm_util", "chip")},
                      rel=1e-12)

    sps = 32 / 0.0612
    rep = perf.train_perf_report(cfg, sps, chip=H100)
    assert _within_rounding(rep["train_mfu"],
                            perf.cone_train_flops_per_sample(cfg) * sps / peak)
    assert rep["train_mfu"] > 0 and rep["chip"] == H100
    want = jperf.train_perf_report(jcfg, sps)
    assert set(rep) == set(want)
    assert {k: v for k, v in rep.items() if k not in ("train_mfu", "chip")} == \
        pytest.approx({k: v for k, v in want.items() if k not in ("train_mfu", "chip")},
                      rel=1e-12)


@pytest.mark.parametrize("preset", ["tan_ego4d", "tan_mad"])
def test_tan_report_against_the_h100_float32_peak(preset):
    cfg, jcfg = _both(preset, {})
    dev_s = 0.185
    rep = perf.tan_perf_report(cfg, dev_s, chip=H100)
    assert _within_rounding(rep["tan_mfu"],
                            perf.tan_flops_per_query(cfg)["per_query"] / dev_s / H100_FP32)
    assert 0 < rep["tan_mfu"] <= 1 and rep["chip"] == H100
    want = jperf.tan_perf_report(jcfg, dev_s)
    assert set(rep) == set(want)
    assert {k: v for k, v in rep.items() if k not in ("tan_mfu", "chip")} == \
        pytest.approx({k: v for k, v in want.items() if k not in ("tan_mfu", "chip")},
                      rel=1e-12)


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


# (preset, window) -> the count over _window_forward_flops's core. "model":
# model.max_v_l frames, the window the analytic model counts; "pipeline":
# data.max_v_l frames, the window the fused pipeline and the train step give
# the model. At MAD both packages' presets leave model.max_v_l at 90 under
# 125-frame windows, so cone_tpu's count misses the forward by 32 %: pinned
# here (ROADMAP Queue 3), the arithmetic stays cone_tpu's.
CONE_FORWARD = {("ego4d", "model"): 1.0, ("mad", "model"): 1.0, ("mad", "pipeline"): 1.3222}
MAD_PIN_RTOL = 1e-4


@pytest.mark.parametrize("preset,window", sorted(CONE_FORWARD))
def test_cone_forward_count_matches_the_window_model(preset, window):
    """One window forward of the port's ConeModel at the preset's full
    width, counted on the meta device, against _window_forward_flops's
    core. (Ego4D's two windows are one: model.max_v_l == data.max_v_l.)"""
    cfg = getattr(config, f"{preset}_config")()
    m = cfg.model
    lv, lq = (m.max_v_l, m.max_q_l) if window == "model" else (cfg.data.max_v_l,
                                                              cfg.data.max_q_l)
    model = ConeModel(m, device="meta").eval()
    b = 2
    args = (torch.empty(b, lq, m.t_feat_dim, device="meta"), torch.ones(b, lq, device="meta"),
            torch.empty(b, lv, m.v_motion_feat_dim, device="meta"),
            torch.ones(b, lv, device="meta"))
    ratio = _counted(lambda: model(*args)) / b / perf._window_forward_flops(m)["core"]
    want = CONE_FORWARD[preset, window]
    assert abs(ratio / want - 1) <= (FORWARD_RTOL if want == 1.0 else MAD_PIN_RTOL), ratio


@pytest.mark.parametrize("preset", ["tan_ego4d", "tan_mad"])
def test_tan_forward_count_matches_the_window_model(preset):
    """One window forward of the port's ConeTanModel at the preset's full
    width, counted on the meta device, against tan_flops_per_query's
    window parts less the matching branch (not part of the forward)."""
    cfg = getattr(config, f"{preset}_config")()
    t = cfg.tan
    model = ConeTanModel(t, device="meta").eval()
    args = (torch.empty(1, cfg.data.max_q_l, t.t_feat_dim, device="meta"),
            torch.ones(1, cfg.data.max_q_l, device="meta"),
            torch.empty(1, t.num_clips * t.frame_stride, t.v_feat_dim, device="meta"))
    parts = perf.tan_flops_per_query(cfg)
    want = (parts["per_query"] - parts["matching"]) / cfg.data.topk_window
    ratio = _counted(lambda: model(*args)) / want
    assert abs(1 - ratio) <= TAN_RTOL, ratio


@pytest.mark.parametrize("adapter_on", [True, False], ids=["adapter_on", "adapter_off"])
def test_train_step_count_matches_the_sample_model(adapter_on):
    """One CONE train step (two forwards, the adapter's matching when on,
    the criterion, backward, clip, AdamW) at the Ego4D preset's full width,
    bsz 4, counted on the CPU, against cone_train_flops_per_sample."""
    bsz = 4
    cfg = _replace(config.ego4d_config(), train={"bsz": bsz})
    ds = make_synthetic_dataset(cfg.data, n_videos=2, queries_per_video=bsz,
                                ctx_l_range=(200, 300), dim=cfg.model.v_appear_feat_dim, seed=0)
    loader = TrainLoader(ds, bsz=bsz, seed=0)
    batch = batch_to_device(next(loader.epoch(0)), torch.device("cpu"))
    model = build_family(cfg, seed=0, device="cpu")
    opt, sched = make_optimizer(model, cfg.train, loader.steps_per_epoch())
    step = make_train_step(model, opt, sched, cfg)
    ratio = (_counted(lambda: to_floats(step(batch, adapter_on))) / bsz
             / perf.cone_train_flops_per_sample(cfg, adapter_on=adapter_on))
    assert abs(1 - ratio) <= TRAIN_RTOL, ratio


def _narrow(family):
    """A narrow pipeline on the CPU: 2 videos x 3 queries, query_chunk 2, so
    4 fused dispatches a pass."""
    dim = 32
    data = DataConfig(dset_name="synthetic", max_v_l=32, max_q_l=8, topk_window=4,
                      max_ctx_l=256)
    ev = EvalConfig(query_chunk=2, use_pallas_coarse=True)
    if family == "tan":
        cfg = ConeConfig(
            model=ModelConfig(model_family="tan", t_feat_dim=dim, v_appear_feat_dim=dim,
                              v_motion_feat_dim=dim, max_q_l=8, max_v_l=32),
            tan=TanConfig(num_clips=32, hidden_size=32, v_feat_dim=dim, t_feat_dim=dim,
                          txt_hidden_size=32, lstm_layers=1, num_scale_layers=(8, 4),
                          map_hidden_sizes=(32,), map_kernel_sizes=(5,), map_paddings=(2,),
                          proposal_top_k=5),
            data=data, eval=ev)
        model = ConeTanModel(cfg.tan, device="cpu")
        model.load_state_dict(load_reference_tan_state_dict(
            random_reference_tan_state_dict(cfg.tan, seed=0)))
    else:
        cfg = ConeConfig(model=ModelConfig(hidden_dim=32, nheads=4, dim_feedforward=64,
                                           t_feat_dim=dim, v_motion_feat_dim=dim,
                                           v_appear_feat_dim=dim, max_q_l=8, max_v_l=32),
                         data=data, eval=ev)
        model = ConeModel(cfg.model, device="cpu")
        model.load_state_dict(load_reference_state_dict(
            random_reference_state_dict(cfg.model, seed=0)))
    ds = make_synthetic_dataset(cfg.data, n_videos=2, queries_per_video=3,
                                ctx_l_range=(90, 180), dim=dim, signal=3.0, seed=4)
    return make_pipeline(model, ds, cfg, device="cpu"), len(ds.examples)


@pytest.mark.parametrize("family", ["cone", "tan"])
def test_device_time_fused_on_a_cpu_pipeline(monkeypatch, family):
    pipe, n_q = _narrow(family)
    before = pipe.run_fused()
    calls = []
    fused = pipe._fused

    def counted(*inputs):
        calls.append(len(inputs))
        return fused(*inputs)

    monkeypatch.setattr(pipe, "_fused", counted)
    repeats, groups = 3, 4
    per_q, per_pass = perf.device_time_fused(pipe, n_q, repeats=repeats)
    assert per_q > 0 and per_pass > 0 and per_q == pytest.approx(per_pass / n_q)
    assert len(calls) == (repeats + 1) * groups
    monkeypatch.undo()
    assert pipe.run_fused() == before


def test_device_fence_and_its_latency_on_the_cpu():
    assert perf.device_fence("cpu") is None
    lat = perf.sync_latency("cpu", trials=2)
    assert 0 <= lat < 1.0 and np.isfinite(lat)
