"""Corpus search of one query over a library of videos, plain: the
adapted library's window scores, the global top-k (video, window) merge
under the total order (score descending, video id, window), the fine
forward over the chosen windows, 4-dp rounding, min-max fusion over the
query's corpus-wide candidates, NMS within each video and one ranking by
the fused score (the port's corpus retrieval semantics; the published
CONE grounds per annotation, and its scoring inside each stage is the
same).
"""

from __future__ import annotations

import torch

from benchmark.reference import cone
from benchmark.reference import grounding as g


def adapted_library(params, m, raw_videos, device):
    """[(ctx, D) adapted unit rows on the device] of each video."""
    return [g.adapted_video(params, m, torch.from_numpy(v).to(device)) for v in raw_videos]


def search(params, cfg, ids, raw_videos, adapted, raw_tok, raw_cls, top_moments, device,
           search_windows=None):
    """The ranked moments [{video_id, span, prop, match, fused}] of one
    query. ids, raw_videos, adapted: the library in any order."""
    data, ev = cfg.data, cfg.eval
    stride = data.max_v_l // 2
    k = data.topk_window if search_windows is None else search_windows
    cls = torch.from_numpy(raw_cls).to(device)
    cls = cls / cls.norm().clamp(min=1e-12)
    cands = []
    for vid, a in zip(ids, adapted):
        s = g.window_scores((cls[None] @ a.T), stride)[0].cpu().numpy()
        cands.extend((float(s[w]), vid, w) for w in range(len(s)))
    chosen = {}
    for _, vid, w in sorted(cands, key=lambda t: (-t[0], t[1], t[2]))[:k]:
        chosen.setdefault(vid, []).append(w)
    rows = []
    tok = torch.from_numpy(raw_tok[: data.max_q_l]).to(device)
    t, tm = _tokens(tok, data.max_q_l)
    for vid, wins in chosen.items():
        feats = g.l2n(torch.from_numpy(raw_videos[ids.index(vid)]).to(device))
        w = torch.tensor(wins, device=device)
        win, wmask, wstart, wlen = g.gather_windows(feats, w, stride, data.max_v_l)
        n = len(wins)
        out = cone.forward(params, cfg.model, t[None].expand(n, -1, -1),
                           tm[None].expand(n, -1), win, wmask)
        prob = torch.softmax(out["pred_logits"], -1)[..., 0]
        match = cone.matching_pred(params, cfg.model, cls[None].expand(n, -1), win, wmask,
                                   out["pred_spans"])
        sec = (cone.cxw_to_xx(out["pred_spans"]) * wlen[:, None, None].float()
               + wstart[:, None, None].float()) * data.clip_length
        sec, prob, match = sec.cpu().numpy(), prob.cpu().numpy(), match.cpu().numpy()
        for i in range(n):
            for p in range(prob.shape[1]):
                rows.append([vid, g.r4(sec[i, p, 0]), g.r4(sec[i, p, 1]), g.r4(prob[i, p]),
                             g.r4(match[i, p])])
    if not rows:
        return []
    pn = g.min_max([r[3] for r in rows])
    mn = g.min_max([r[4] for r in rows])
    by_vid = {}
    for r, a, b in zip(rows, pn, mn):
        by_vid.setdefault(r[0], []).append([r[1], r[2], a + b, r[3], r[4]])
    out = []
    for vid, moments in by_vid.items():
        moments.sort(key=lambda x: -x[2])
        kept = g.nms([x[:3] for x in moments][: ev.max_before_nms], ev.nms_thd, top_moments)
        scores = {(x[0], x[1]): (x[3], x[4], x[2]) for x in moments}
        for st, ed, _ in kept:
            pr, ma, fu = scores[(st, ed)]
            out.append(dict(video_id=vid, span=[st, ed], prop=pr, match=ma, fused=fu))
    out.sort(key=lambda d: -d["fused"])
    return out[:top_moments]


def _tokens(tok, max_q_l):
    """The token features as the request sends them, padded to max_q_l."""
    out = torch.zeros(max_q_l, tok.shape[1], device=tok.device)
    out[: len(tok)] = tok
    mask = torch.zeros(max_q_l, device=tok.device)
    mask[: len(tok)] = 1
    return out, mask


def answers_differ(got, want, span_tol: float, score_tol: float) -> bool:
    """True where two ranked answers differ: another count, another video,
    or a span or score farther apart than the tolerances."""
    if len(got) != len(want):
        return True
    for a, b in zip(got, want):
        if a["video_id"] != b["video_id"] \
                or abs(a["span"][0] - b["span"][0]) > span_tol \
                or abs(a["span"][1] - b["span"][1]) > span_tol \
                or any(abs(a[k] - b[k]) > score_tol for k in ("prop", "match", "fused")):
            return True
    return False
