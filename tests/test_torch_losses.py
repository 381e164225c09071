"""The port's matcher and criterion (cone_tpu_torch/ops/matching.py,
cone_tpu_torch/models/losses.py) against cone_tpu's and the reference's.

  * hungarian_match: equal to scipy's linear_sum_assignment (optimal cost)
    and to cone_tpu's assignment, padded targets and exact ties included
    (the lexicographically smallest optimal permutation wins in both);
  * matcher_cost and every compute_losses term against cone_tpu on the
    same seeded inputs: 1e-5 relative (fp32 sums in another order);
  * tests/golden/cone_multispan.npz criterion terms within
    test_multispan_parity.py's 5e-4;
  * a zero-width prediction matched to a padded slot: loss and gradient
    finite (the double-where before the gIoU).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from cone_tpu.config import LossConfig as JLossConfig
from cone_tpu.models import losses as jlosses
from cone_tpu.ops import matching as jmatching
from cone_tpu_torch.config import LossConfig, ModelConfig
from cone_tpu_torch.convert import load_reference_state_dict
from cone_tpu_torch.models import losses
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.ops import matching

REL = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cone_multispan.npz")


# cone_tpu's criterion compiled once per structure: op-by-op dispatch of its
# many small ops costs seconds per call on the CPU
_j_compute_losses = jax.jit(jlosses.compute_losses, static_argnums=(3,))
_j_hungarian_match = jax.jit(jmatching.hungarian_match)


def _close(got, want, rel=REL, what=""):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * max(1.0, abs(want)), (what, got, want)


def _outputs(rng, b, nq, lv, n_aux=1, degenerate=False):
    """A model-output dict of numpy arrays: sigmoid spans, logits, saliency,
    aux layers and the adapter's two unit-norm (B, 8) sides."""
    def layer():
        spans = 1 / (1 + np.exp(-rng.normal(size=(b, nq, 2))))
        if degenerate:
            spans[..., 1] = 0.0
        return {"pred_spans": spans.astype(np.float32),
                "pred_logits": rng.normal(size=(b, nq, 2)).astype(np.float32)}
    out = layer()
    out["saliency_scores"] = rng.normal(size=(b, lv)).astype(np.float32)
    out["aux_outputs"] = [layer() for _ in range(n_aux)]
    out["adapter_embeds"] = list(_unit_rows(rng, 2, b, 8))
    return out


def _unit_rows(rng, *shape):
    x = rng.normal(size=shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _jax_outputs(out):
    """cone_tpu's criterion takes the adapter's (B, B) logits_per_video,
    prop @ text.T, where the port takes the two sides."""
    o = {k: v for k, v in out.items() if k != "adapter_embeds"}
    if "adapter_embeds" in out:
        prop, text = out["adapter_embeds"]
        o["logits_per_video"] = prop @ text.T
    return _jax(o)


def _targets(rng, b, nt, lv, n_pairs=2):
    mask = np.zeros((b, nt), np.float32)
    for i in range(b):
        mask[i, : rng.integers(1, nt + 1)] = 1
    spans = np.stack([rng.uniform(0.1, 0.9, (b, nt)), rng.uniform(0.05, 0.5, (b, nt))], -1)
    spans = (spans * mask[..., None]).astype(np.float32)  # padded slots are (0, 0)
    return {"span_labels": spans, "span_mask": mask,
            "saliency_pos": rng.integers(0, lv, (b, n_pairs)).astype(np.int32),
            "saliency_neg": rng.integers(0, lv, (b, n_pairs)).astype(np.int32)}


def _to(tree, conv):
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, conv) for v in tree]
    return conv(tree)


def _torch(tree):
    return _to(tree, lambda a: torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a))


def _jax(tree):
    return _to(tree, jnp.asarray)


# ---------------------------------------------------------------- matcher

@pytest.mark.parametrize("nq,nt", [(2, 2), (5, 3), (5, 5), (6, 4)])
def test_hungarian_match_is_optimal_and_equals_cone_tpu(nq, nt):
    rng = np.random.default_rng(nq * 10 + nt)
    b = 16
    cost = rng.normal(size=(b, nq, nt)).astype(np.float32)
    mask = np.ones((b, nt), np.float32)
    for i in range(b):
        mask[i, rng.integers(1, nt + 1):] = 0  # padded targets
    cost[mask[:, None, :].repeat(nq, 1) == 0] = 1e6  # must not steer the match
    got = matching.hungarian_match(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
    want = np.asarray(_j_hungarian_match(jnp.asarray(cost), jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    for i in range(b):
        real = np.flatnonzero(mask[i])
        assert len(set(got[i, real])) == len(real)  # one query per target
        rows, cols = linear_sum_assignment(cost[i][:, real])
        assert np.isclose(cost[i, got[i, real], real].sum(), cost[i][rows, cols].sum(),
                          rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nq", [2, 5, 6])
def test_hungarian_match_exact_ties_pick_the_smallest_permutation(nq):
    """All-equal costs: every permutation is optimal, and the identity (the
    lexicographically smallest) wins in both packages; a two-way tie in one
    column picks the lower query."""
    nt = min(nq, 3)
    flat = np.ones((2, nq, nt), np.float32)
    mask = np.array([[1] * nt, [1] + [0] * (nt - 1)], np.float32)
    got = matching.hungarian_match(torch.from_numpy(flat), torch.from_numpy(mask)).numpy()
    want = np.asarray(_j_hungarian_match(jnp.asarray(flat), jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.arange(nt))
    tie = np.full((1, nq, 1), 5.0, np.float32)
    tie[0, [nq - 1, 1], 0] = 0.0  # queries 1 and nq-1 tie at the optimum
    got = matching.hungarian_match(torch.from_numpy(tie), torch.ones(1, 1)).numpy()
    assert got.tolist() == [[1]]
    assert np.asarray(_j_hungarian_match(jnp.asarray(tie), jnp.ones((1, 1)))).tolist() \
        == [[1]]


def test_matcher_cost_equals_cone_tpu():
    rng = np.random.default_rng(3)
    out = _outputs(rng, 6, 5, 20, degenerate=False)
    tgt = _targets(rng, 6, 5, 20)
    kw = dict(cost_span=10.0, cost_giou=1.0, cost_class=4.0)
    got = matching.matcher_cost(torch.from_numpy(out["pred_spans"]),
                                torch.from_numpy(out["pred_logits"]),
                                torch.from_numpy(tgt["span_labels"]),
                                tgt_mask=torch.from_numpy(tgt["span_mask"]), **kw).numpy()
    want = np.asarray(jax.jit(jmatching.matcher_cost)(
        jnp.asarray(out["pred_spans"]), jnp.asarray(out["pred_logits"]),
        jnp.asarray(tgt["span_labels"]), tgt_mask=jnp.asarray(tgt["span_mask"]), **kw))
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL)


# ------------------------------------------------------------- criterion

@pytest.mark.parametrize("case", ["full", "no_neg", "no_aux", "degenerate", "label_only"])
def test_compute_losses_equal_cone_tpu(case):
    rng = np.random.default_rng(["full", "no_neg", "no_aux", "degenerate",
                                 "label_only"].index(case))
    b, nq, nt, lv = 6, 5, 5, 24
    out = _outputs(rng, b, nq, lv, n_aux=2, degenerate=case == "degenerate")
    neg = _outputs(rng, b, nq, lv)
    del neg["adapter_embeds"]
    neg["vid_mask"] = (np.arange(lv)[None] < rng.integers(5, lv, (b, 1))).astype(np.float32)
    tgt = None if case == "label_only" else _targets(rng, b, nt, lv)
    cfg = dict(aux_loss=case != "no_aux")
    neg = None if case == "no_neg" else neg
    got = losses.compute_losses(_torch(out), None if tgt is None else _torch(tgt),
                                None if neg is None else _torch(neg), LossConfig(**cfg))
    want = _j_compute_losses(_jax_outputs(out), None if tgt is None else _jax(tgt),
                             None if neg is None else _jax(neg), JLossConfig(**cfg))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], what=k)
    weights = losses.loss_weight_dict(LossConfig(**cfg), 3)
    assert weights == jlosses.loss_weight_dict(JLossConfig(**cfg), 3)
    _close(losses.total_loss(got, weights), jlosses.total_loss(want, weights), what="total")


def test_weighted_ce_divides_by_the_element_count():
    logits = torch.tensor([[[2.0, -1.0], [0.5, 0.3], [-1.0, 1.0]]])
    labels = torch.tensor([[0, 1, 1]])
    nll = -logits.log_softmax(-1).gather(-1, labels[..., None])[..., 0]
    want = (nll * torch.tensor([1.0, 0.1, 0.1])).sum() / 3
    torch.testing.assert_close(losses._weighted_ce(logits, labels, 0.1), want)


def test_label_scatter_lets_the_real_target_win():
    """A padded target assigned to the same query as a real one must leave
    that query foreground, whatever the write order."""
    out = {"pred_logits": torch.zeros(1, 3, 2)}
    for assign in ([[0, 0]], [[1, 1]]):
        a = torch.tensor(assign)
        for mask in ([[1.0, 0.0]],):
            loss, _ = losses._label_loss(out, a, torch.tensor(mask), None, 0.1)
            nll = float(np.log(2.0))
            _close(loss, (nll + 0.1 * nll + 0.1 * nll) / 3, what=str(assign))


def test_giou_finite_with_degenerate_pred_on_padded_slot():
    """A sigmoid width that is exactly 0, matched to a padded (0, 0) target
    slot, makes gIoU 0/0 without the safe span: the loss and its gradient
    must be finite (test_multispan_parity.py's case, on the port)."""
    nq = 5
    spans = torch.zeros(1, nq, 2, requires_grad=True)
    outputs = {"pred_spans": spans, "pred_logits": torch.zeros(1, nq, 2),
               "saliency_scores": torch.zeros(1, 8), "aux_outputs": []}
    targets = {"span_labels": torch.tensor([[[0.5, 0.4], [0.0, 0.0], [0.0, 0.0]]]),
               "span_mask": torch.tensor([[1.0, 0.0, 0.0]]),
               "saliency_pos": torch.zeros(1, 2, dtype=torch.int64),
               "saliency_neg": torch.ones(1, 2, dtype=torch.int64)}
    got = losses.compute_losses(outputs, targets, None, LossConfig())
    assert all(torch.isfinite(v) for v in got.values())
    got["loss_giou"].backward()
    got = {k: v.detach() for k, v in got.items()}
    assert torch.isfinite(spans.grad).all()
    want = _j_compute_losses(_jax({k: v.detach().numpy() if torch.is_tensor(v) else v
                                   for k, v in outputs.items()}),
                             _jax({k: v.numpy() for k, v in targets.items()}),
                             None, JLossConfig())
    for k in want:
        _close(got[k], want[k], what=k)


def test_adapter_nce_equals_cone_tpu():
    """The adapter InfoNCE from the two unit-norm sides (one rank, no
    group) against cone_tpu's over their (B, B) matrix."""
    prop, text = _unit_rows(np.random.default_rng(5), 2, 7, 16)
    _close(losses.adapter_nce_share(torch.from_numpy(prop), torch.from_numpy(text), 0.07),
           jlosses.adapter_nce_loss(jnp.asarray(prop @ text.T), 0.07))


def test_multispan_golden_criterion():
    """tests/golden/cone_multispan.npz: the reference's criterion terms on
    its own forward with ragged multi-span targets, within
    test_multispan_parity.py's 5e-4."""
    g = dict(np.load(GOLDEN).items())
    cfg = ModelConfig(t_feat_dim=36, v_motion_feat_dim=40, v_appear_feat_dim=36,
                      max_q_l=20, max_v_l=20)
    model = ConeModel(cfg, device="cpu").eval()
    model.load_state_dict(load_reference_state_dict(
        {k: v for k, v in g.items() if k.startswith("w::")}))
    with torch.no_grad():
        out = model(*(torch.from_numpy(g[k]) for k in
                      ("src_txt", "src_txt_mask", "src_vid", "src_vid_mask")))
        got = losses.compute_losses(out, {
            "span_labels": torch.from_numpy(g["tgt_spans"]),
            "span_mask": torch.from_numpy(g["span_mask"]),
            "saliency_pos": torch.from_numpy(g["sal_pos"]),
            "saliency_neg": torch.from_numpy(g["sal_neg"])}, None, LossConfig())
    for key in ["loss_span", "loss_giou", "loss_label", "loss_saliency",
                "loss_span_0", "loss_giou_0", "loss_label_0"]:
        assert abs(float(got[key]) - float(g[f"loss_{key}"])) < 5e-4, key


def test_gradients_equal_cone_tpu():
    """d(total)/d(outputs) through the matcher-selected terms, against
    jax.grad of cone_tpu's criterion: 1e-5 relative to the largest entry."""
    rng = np.random.default_rng(11)
    b, nq, nt, lv = 4, 5, 3, 16
    out = _outputs(rng, b, nq, lv, n_aux=1)
    tgt = _targets(rng, b, nt, lv)
    cfg = LossConfig()
    weights = losses.loss_weight_dict(cfg, 2)
    t_out = _torch(out)
    leaves = [t_out["pred_spans"], t_out["pred_logits"], t_out["saliency_scores"],
              *t_out["adapter_embeds"]]
    for x in leaves:
        x.requires_grad_(True)
    losses.total_loss(losses.compute_losses(t_out, _torch(tgt), None, cfg), weights).backward()

    def f(spans, logits, sal, prop, text):
        o = dict(_jax_outputs(out), pred_spans=spans, pred_logits=logits, saliency_scores=sal,
                 logits_per_video=prop @ text.T)
        return jlosses.total_loss(jlosses.compute_losses(o, _jax(tgt), None, JLossConfig()),
                                  weights)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(out[k]) for k in ("pred_spans", "pred_logits", "saliency_scores")),
        *(jnp.asarray(x) for x in out["adapter_embeds"]))
    for x, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=0,
                                   atol=REL * max(1.0, np.abs(w).max()))
