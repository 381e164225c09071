"""The traffic generators: deterministic in the seed, true to their stated
parameters, the same work for every seed; the reference's batches are the
program's loader's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import manifest
from benchmark.data import make_corpus, seeded_state_dict
from benchmark.traffic.serve import arrivals

MIX = {"videos": 12, "frames": [300, 400], "queries_per_video": [6, 16],
       "query_tokens": [5, 20], "signal": 1.0}


def corpus(seed, mix=MIX):
    return make_corpus(mix, seed, 16, 24, 90, torch.device("cpu"))


def test_same_seed_same_corpus():
    a, b = corpus(2**33 + 1), corpus(2**33 + 1)
    assert a.query_ids == b.query_ids and np.array_equal(a.ctx, b.ctx)
    assert all(np.array_equal(x, y) for x, y in zip(a.feats, b.feats))
    assert all(np.array_equal(x, y) for x, y in zip(a.tokens, b.tokens))
    assert np.array_equal(a.cls, b.cls) and np.array_equal(a.gt, b.gt)


def test_other_seed_same_sizes_other_content():
    a, b = corpus(11), corpus(12)
    assert sorted(a.ctx) == sorted(b.ctx)
    assert sorted(np.bincount(a.video)) == sorted(np.bincount(b.video))
    assert sorted(a.n_tok) == sorted(b.n_tok)
    assert not np.array_equal(a.feats[0][:10], b.feats[0][:10])


def test_stated_parameters():
    c = corpus(5)
    assert len(c.video_ids) == 12 and len(c.feats) == 12
    assert c.ctx.min() == 300 and c.ctx.max() == 400
    per = np.bincount(c.video)
    assert per.min() == 6 and per.max() == 16 and per.sum() == len(c.query_ids) == 132
    assert c.n_tok.min() == 5 and c.n_tok.max() == 20
    assert all(len(f) == n for f, n in zip(c.feats, c.ctx))
    assert (c.gt[:, 1] - c.gt[:, 0] >= 4).all() and (c.gt[:, 1] <= c.ctx[c.video]).all()


@pytest.mark.parametrize("traffic", ["nlq-val", "mad-test", "nlq-train", "mad-search"])
def test_committed_mixes_state_their_sizes(traffic):
    """The committed mixes: the Ego4D mixes average 11 queries a clip, MAD
    films fall in the two largest buckets."""
    mix = manifest.traffic(traffic)
    qpv = np.rint(np.linspace(*mix["queries_per_video"], mix["videos"]))
    if traffic.startswith("nlq"):
        assert qpv.mean() == 11 and mix["frames"] == [880, 900]
    else:
        assert 24576 < mix["frames"][0] and mix["frames"][1] <= 49152


def test_arrivals_fixed_count_and_schedule():
    a = arrivals(20.0, 30.0)
    assert len(a) == 600 and np.array_equal(a, arrivals(20.0, 30.0))
    assert (np.diff(a) > 0).all() and 0 < a[0] and a[-1] < 30.0
    gaps = np.diff(np.r_[0, a])
    assert gaps.mean() == pytest.approx(30.0 / 600, rel=0.01)
    assert np.std(gaps) == pytest.approx(gaps.mean(), rel=0.15)   # exponential: sd = mean


def test_seeded_weights_deterministic():
    from cone_tpu_torch.config import ego4d_config

    m = ego4d_config().model
    a, b = seeded_state_dict(m, 3, "cpu"), seeded_state_dict(m, 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["class_embed.weight"], seeded_state_dict(m, 4, "cpu")["class_embed.weight"])


def test_reference_batches_are_the_loaders():
    """The reference's own copy of the loader's sampling gives the program's
    TrainLoader batch, row for row."""
    from cone_tpu_torch.config import DataConfig
    from cone_tpu_torch.data.dataset import TrainLoader

    from benchmark.reference.train import Examples
    from benchmark.traffic import program_dataset

    data = DataConfig(max_v_l=90, clip_length=0.535, max_ctx_l=2304)
    c = corpus(77)
    got = next(TrainLoader(program_dataset(c, data), bsz=8, seed=77).epoch(30))
    want = Examples(c, data).batch(77, 30, 0, 8, "cpu")
    pairs = {"query_tokens": "tok", "query_mask": "tok_mask", "query_cls": "cls",
             "pos_motion": "pos", "pos_mask": "pos_mask", "neg_motion": "neg",
             "neg_mask": "neg_mask", "span_labels": "spans", "span_mask": "span_mask",
             "prop_start": "prop_start", "prop_end": "prop_end"}
    for k, r in pairs.items():
        assert np.allclose(got[k], want[r].numpy().reshape(got[k].shape), atol=1e-6), k
    assert np.array_equal(got["sal_pos"][:, 0], want["sal_pos"].numpy())
    assert np.array_equal(got["sal_neg"][:, 0], want["sal_neg"].numpy())
