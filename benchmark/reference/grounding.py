"""Coarse-to-fine grounding of one query in one video (cone/inference.py),
plain: the coarse window scores and ranking, the fine forward over chosen
windows, and the host post-processing (4-dp rounding, min-max fusion,
dedup, NMS) of the three modalities.

Windows over a video of `ctx` frames (cone/ego4d_mad_dataloader.py):
stride s = max_v_l // 2, n_win = ceil(ctx / s) + 1, and window i holds the
frames [max((i - 1) s, 0), min((i - 1) s + max_v_l, ctx)) in the fine
stage. The coarse stage scores window i by the largest frame score over
the stride segments i - 1 and i, clipped to the video (the reference
loop, cone/inference.py:290-295).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import cone

MODALITIES = ("fusion", "proposal", "matching")


def l2n(x, eps=1e-5):
    """Row L2 normalisation with the reference's additive eps."""
    return x / (x.norm(dim=-1, keepdim=True) + eps)


def adapted_video(params, m, raw):
    """(ctx, D) raw features -> the coarse stage's adapted unit rows."""
    a = cone.adapt(params, m, l2n(raw))
    n = a.norm(dim=-1, keepdim=True)
    return a / torch.where(n == 0, 1.0, n)


def window_scores(frame_scores, stride: int):
    """(Q, ctx) frame scores -> (Q, n_win) window scores."""
    q, ctx = frame_scores.shape
    h = -(-ctx // stride)
    pad = h * stride - ctx
    fs = torch.nn.functional.pad(frame_scores, (0, pad), value=-1e30)
    seg = fs.view(q, h, stride).amax(-1)
    i = torch.arange(h + 1, device=fs.device)
    j1 = (i - 1).clamp(0, h - 1)
    j2 = i.clamp(0, h - 1)
    return torch.maximum(seg[:, j1], seg[:, j2])


def coarse_scores(params, m, raw_video, raw_cls, stride: int, block: int = 256):
    """Window scores (Q, n_win) of each query's CLS over the video, in
    blocks of queries."""
    a = adapted_video(params, m, raw_video)
    outs = []
    for i in range(0, len(raw_cls), block):
        outs.append(window_scores(l2n(raw_cls[i:i + block]) @ a.T, stride))
    return torch.cat(outs)


def ranking(scores):
    """Stable descending order of each row."""
    return torch.argsort(-scores, dim=-1, stable=True)


def gather_windows(feats, win_ids, stride: int, max_v_l: int):
    """(ctx, D) features, (N,) window ids -> windows (N, max_v_l, D) zeroed
    past their end, mask (N, max_v_l), start (N,), length (N,)."""
    ctx = feats.shape[0]
    start = ((win_ids - 1) * stride).clamp(min=0)
    end = torch.clamp((win_ids - 1) * stride + max_v_l, max=ctx)
    pos = start[:, None] + torch.arange(max_v_l, device=feats.device)
    mask = (pos < end[:, None]).float()
    win = feats[pos.clamp(max=ctx - 1)] * mask[..., None]
    return win, mask, start, end - start


def query_tokens(raw_tok, max_q_l: int):
    """(n, Dt) raw tokens -> normalised tokens padded to max_q_l, mask."""
    t = l2n(raw_tok)[:max_q_l]
    out = torch.zeros(max_q_l, t.shape[1], device=t.device)
    out[: len(t)] = t
    mask = torch.zeros(max_q_l, device=t.device)
    mask[: len(t)] = 1
    return out, mask


def fine(params, m, data, raw_video, items, block: int = 1024):
    """items: [(raw_tok (n, Dt), raw_cls (D,), win_ids (K,) long)] of one
    video. Returns per item (spans_sec (K, NQ, 2), prob (K, NQ),
    match (K, NQ)) as numpy arrays, the windows in blocks."""
    stride = data.max_v_l // 2
    feats = l2n(raw_video)
    rows = []
    for tok, cls, wins in items:
        t, tm = query_tokens(tok, data.max_q_l)
        for w in wins.tolist():
            rows.append((t, tm, l2n(cls[None])[0], w))
    outs = []
    for i in range(0, len(rows), block):
        part = rows[i:i + block]
        w = torch.tensor([r[3] for r in part], device=feats.device)
        win, wmask, wstart, wlen = gather_windows(feats, w, stride, data.max_v_l)
        t = torch.stack([r[0] for r in part])
        tm = torch.stack([r[1] for r in part])
        cls = torch.stack([r[2] for r in part])
        out = cone.forward(params, m, t, tm, win, wmask)
        prob = torch.softmax(out["pred_logits"], dim=-1)[..., 0]
        match = cone.matching_pred(params, m, cls, win, wmask, out["pred_spans"])
        sec = (cone.cxw_to_xx(out["pred_spans"]) * wlen[:, None, None].float()
               + wstart[:, None, None].float()) * data.clip_length
        outs.append((sec.cpu().numpy(), prob.cpu().numpy(), match.cpu().numpy()))
    sec = np.concatenate([o[0] for o in outs])
    prob = np.concatenate([o[1] for o in outs])
    match = np.concatenate([o[2] for o in outs])
    res, pos = [], 0
    for _, _, wins in items:
        k = len(wins)
        res.append((sec[pos:pos + k], prob[pos:pos + k], match[pos:pos + k]))
        pos += k
    return res


def r4(v: float) -> float:
    return float(f"{v:.4f}")


def min_max(values):
    lo, hi = min(values), max(values)
    if lo == hi:
        return list(values)
    return [(v - lo) / (hi - lo) for v in values]


def nms(preds, thd: float, max_after: int):
    """Greedy NMS over [st, ed, score] with the hull union
    max(ed) - min(st) (utils/temporal_nms.py)."""
    if len(preds) == 1:
        return list(preds)
    preds = sorted(preds, key=lambda x: x[2], reverse=True)
    spans = np.asarray([p[:2] for p in preds], dtype=np.float64)
    alive = np.ones(len(preds), dtype=bool)
    idx = np.arange(len(preds))
    kept = []
    while alive.sum() > 1 and len(kept) < max_after:
        cur = idx[alive][0]
        rest = idx[alive][1:]
        inter = np.maximum(0.0, np.minimum(spans[cur, 1], spans[rest, 1])
                           - np.maximum(spans[cur, 0], spans[rest, 0]))
        union = np.maximum(spans[cur, 1], spans[rest, 1]) - np.minimum(spans[cur, 0],
                                                                        spans[rest, 0])
        iou = np.where(union != 0, inter / np.where(union != 0, union, 1.0), 0.0)
        alive[rest[iou > thd]] = False
        alive[cur] = False
        kept.append(cur)
    if len(kept) < max_after and alive.sum() >= 1:
        kept.append(idx[alive][0])
    return [preds[i] for i in kept]


def post(sec, prob, match, ev):
    """One query's (K, NQ) candidates, windows in ranked order -> the kept
    [st, ed, score] moments of each modality (cone/inference.py:70-217):
    proposals by fg probability within each window, values rounded to 4
    dp, min-max fusion, dedup of equal spans (the last one's scores at the
    first one's place), NMS on the top max_before_nms."""
    cands = []
    for w in range(prob.shape[0]):
        entries = [[float(sec[w, q, 0]), float(sec[w, q, 1]), float(prob[w, q]),
                    float(match[w, q])] for q in range(prob.shape[1])]
        entries.sort(key=lambda e: e[2], reverse=True)
        cands.extend([[r4(v) for v in e] for e in entries])
    if not cands:
        cands = [[0.0, 0.0, 0.0, 0.0]]
    pn = min_max([c[2] for c in cands])
    mn = min_max([c[3] for c in cands])
    ret = {}
    for c, p, q in zip(cands, pn, mn):
        ret[(c[0], c[1])] = [c[2], c[3], p + q]
    out = {}
    for name, i in (("proposal", 0), ("matching", 1), ("fusion", 2)):
        moments = [[st, ed, v[i]] for (st, ed), v in ret.items()]
        moments.sort(key=lambda x: x[2], reverse=True)
        if ev.nms_thd != -1:
            kept = nms(moments[: ev.max_before_nms], ev.nms_thd, ev.max_after_nms)
        else:
            kept = moments[: ev.max_after_nms]
        out[name] = kept
    return out


def ranklist_gap(ref_scores: np.ndarray, ranklist) -> float:
    """How far the program's ranking falls below the reference's: over the
    ranks k, the largest (reference's k-th best score) - (reference's score
    of the program's k-th window). 0 for the reference's own order; any
    ranking that is not a permutation of the video's windows reads inf."""
    n = len(ref_scores)
    r = np.asarray(ranklist, dtype=np.int64)
    if len(r) != n or not np.array_equal(np.sort(r), np.arange(n)):
        return float("inf")
    best = np.sort(ref_scores)[::-1]
    return float(np.max(best - ref_scores[r]))


def moments_differ(got, want, span_tol: float, score_tol: float) -> bool:
    """True where two kept lists differ: another count, or a moment whose
    start, end or score is farther apart than the tolerances."""
    if len(got) != len(want):
        return True
    for g, w in zip(got, want):
        if abs(g[0] - w[0]) > span_tol or abs(g[1] - w[1]) > span_tol \
                or abs(g[2] - w[2]) > score_tol:
            return True
    return False
