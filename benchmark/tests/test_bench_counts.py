"""The benchmark's FLOP counts against `torch.utils.flop_counter.FlopCounterMode`
on the port itself, at each configuration's widths with few queries.

Evaluated at the padded sizes the port computes (every chunk row, every
window frame, `max_q_l` tokens, the padded video), the counts must equal
what FlopCounterMode sees within 1 %: the count leaves out two products
whose input has no gradient in the train step (the first decoder layer's
value projection of zeros and the adapter's input gradient), a few
hundredths of a percent."""

from __future__ import annotations


import pytest
import torch

from benchmark import counts, manifest
from benchmark.harness import build_config
from benchmark.traffic import program_model
from benchmark.data import seeded_state_dict

TOL = 0.01


def cfg_of(name, **over):
    return build_config(manifest.config_file(manifest.load(), name), over)


@pytest.mark.parametrize("name, l_pad", [("cone_ego4d", 2304), ("cone_mad", 8192)])
def test_fused_dispatch_count(name, l_pad):
    from torch.utils.flop_counter import FlopCounterMode

    from cone_tpu_torch.eval.pipeline import InferencePipeline

    cfg = cfg_of(name, eval={"query_chunk": 2, "use_pallas_coarse": False})
    m, data = cfg.model, cfg.data
    torch.manual_seed(0)
    model = program_model(cfg, seeded_state_dict(m, 1, "cpu"), "cpu").requires_grad_(False)
    pipe = InferencePipeline(model, None, cfg, device="cpu")
    q = cfg.eval.query_chunk
    feats = torch.nn.functional.normalize(torch.randn(1, l_pad, m.v_appear_feat_dim), dim=-1)
    ctx = torch.tensor([l_pad - 7], dtype=torch.int32)
    toks = torch.randn(1, q, data.max_q_l, m.t_feat_dim)
    tmask = torch.ones(1, q, data.max_q_l)
    cls = torch.nn.functional.normalize(torch.randn(1, q, m.v_appear_feat_dim), dim=-1)
    with FlopCounterMode(display=False) as fc:
        pipe._fused(feats, None, feats, None, ctx, toks, tmask, cls)
    w = counts.window_forward_flops(m, data.max_v_l, data.max_q_l)
    want = (q * 2 * l_pad * m.v_appear_feat_dim + counts.adapter_flops(m, l_pad)
            + q * data.topk_window * (w["core"] + w["matching"]))
    assert fc.get_total_flops() == pytest.approx(want, rel=TOL)


def test_train_step_count():
    from torch.utils.flop_counter import FlopCounterMode

    from cone_tpu_torch.data.dataset import TrainLoader
    from cone_tpu_torch.train.optim import make_optimizer
    from cone_tpu_torch.train.step import make_train_step

    from benchmark.data import make_corpus
    from benchmark.traffic import program_dataset

    cfg = cfg_of("cone_ego4d", train={"bsz": 4})
    c = make_corpus({"videos": 2, "frames": [400, 400], "queries_per_video": [4, 4],
                     "query_tokens": [20, 20], "signal": 1.0}, 3, 256, 256, 90, "cpu")
    model = program_model(cfg, seeded_state_dict(cfg.model, 3, "cpu"), "cpu")
    loader = TrainLoader(program_dataset(c, cfg.data), bsz=4, seed=3)
    opt, sched = make_optimizer(model, cfg.train, loader.steps_per_epoch())
    step = make_train_step(model, opt, sched, cfg)
    batch = next(loader.epoch(30))
    with FlopCounterMode(display=False) as fc:
        step(batch, True)
    want = 4 * counts.train_sample_flops(cfg, cfg.data.max_q_l, 4, True)
    assert fc.get_total_flops() == pytest.approx(want, rel=TOL)


def test_shares_are_held_to_the_tensor_core_peaks():
    pk = counts.peaks("NVIDIA H100 80GB HBM3")
    assert pk["float32"] == 495e12 and pk["bfloat16"] == 989e12 and pk["bytes"] == 3.35e12
    with pytest.raises(RuntimeError):
        counts.peaks("NVIDIA A100-SXM4-80GB")


def test_counts_take_real_work_only():
    """A real query counts its own tokens and data.max_v_l frames; the
    adapter counts a video's valid frames once."""
    cfg = cfg_of("cone_mad")
    w = counts.window_forward_flops(cfg.model, 125, 9)
    assert counts.eval_query_flops(cfg, 30000, 9) == pytest.approx(
        2 * 30000 * 512 + 30 * (w["core"] + w["matching"]))
    assert counts.eval_video_flops(cfg, 30000) == counts.adapter_flops(cfg.model, 30000)
    assert counts.eval_query_flops(cfg, 30000, 9) < counts.eval_query_flops(cfg, 30000, 20)
    t, kind = counts.coarse_bound_s(900, 11, 256, 20, counts.H100_PEAKS)
    assert kind == "bytes" and t == pytest.approx(4 * (900 * 256 + 11 * 256 + 11 * 20) / 3.35e12)
