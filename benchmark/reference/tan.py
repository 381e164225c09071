"""2D-TAN inside CONE's windows, plain: the model as CONE ships it for MAD
(cone_2dtan: lib/models/cone_tan.py, frame_modules/frame_pool.py,
prop_modules/sparse.py, fusion_modules/base_fusion.py,
map_modules/map_conv.py; experiments/mad/
2D-TAN-64x64-K9L4-pool-sw-0.5bias-nms-con-match.yaml), its test-time
decoding (moment_localization/test.py, lib/core/eval.py) and CONE's score
fusion, as plain functions over a state dict.

  * coarse: window scores of the raw L2-normalised features, no adapter
    (`grounding.window_scores` over stride max_v_l // 2);
  * a window: its 128 frames through the 1x1 frame conv, ReLU and an
    average pool of 2 (64 map cells); the sparse max-pool map, filled by
    the cascade the yaml's NUM_SCALE_LAYERS gives, written out below;
  * the query: the LSTM's gate equations over the query's own tokens, both
    torch biases, the output at the last token, then tex_linear;
  * BaseFusion (the query vector times the 1x1-conv'd map, F.normalize over
    channels, times the map mask), the four convolutions each followed by
    ReLU and the count renormalisation of map_modules/__init__.py, the 1x1
    prediction, sigmoid times the map mask;
  * the within-window NMS at 0.3 (IoU over the standard union on cells
    [s, e + 1]) keeping 10 cells, their seconds, and the matching score
    (the cosine of the query's CLS with the mean L2-normalised frame over
    the cell's frames);
  * `post`: 4-dp rounding, min-max fusion, the dict dedup and the greedy
    NMS at 0.5 over the standard union, 5 kept, of each modality.

Departures from the published code, which the program shares:

  * the within-window NMS scans the 128 best cells of a window's map
    (test.py:242-289 scans the whole map until it holds 10 survivors), so a
    map whose best 128 cells cluster keeps fewer than 10;
  * seconds, rounding, fusion and IoU are float32, the precision the
    configuration states; the published numpy code forms them in float64.
    A candidate's seconds are (cell * frame_stride + window_start) *
    clip_length in float32; 4-dp rounding splits off the integer part
    (floor, then round((x - floor) * 1e4) / 1e4, half to even), so the
    fraction is rounded at MAD's magnitudes too; an IoU is inter /
    ((he - hs) + (ed - st) - inter). Every span lies on a grid (the 0.4 s
    of two frames, window starts at multiples of 12.8 s), so IoUs of
    exactly 1/2 are common, and the float32 arithmetic decides each of
    them as the program's does, where a float64 decision would go either
    way. The elementwise operations run as torch operations on the
    device the reference runs on, in the program's order.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.grounding import l2n, window_scores

WITHIN_NMS_THD = 0.3        # TEST.NMS_THRESH_WITHIN_WINDOW
POOL = 128                  # cells the within-window NMS scans


def param_shapes(t) -> "OrderedDict[str, tuple]":
    """Every parameter of CONE_TAN with the sparse max-pool map and no
    adapter, by its state-dict name. t: the config's `tan` section."""
    h, th = t.hidden_size, t.txt_hidden_size
    out = OrderedDict()
    out["frame_layer.vis_conv.weight"] = (h, t.v_feat_dim, 1)
    out["frame_layer.vis_conv.bias"] = (h,)
    for i in range(t.lstm_layers):
        fan = t.t_feat_dim if i == 0 else th
        out[f"fusion_layer.textual_encoder.weight_ih_l{i}"] = (4 * th, fan)
        out[f"fusion_layer.textual_encoder.weight_hh_l{i}"] = (4 * th, th)
        out[f"fusion_layer.textual_encoder.bias_ih_l{i}"] = (4 * th,)
        out[f"fusion_layer.textual_encoder.bias_hh_l{i}"] = (4 * th,)
    out["fusion_layer.tex_linear.weight"] = (h, th)
    out["fusion_layer.tex_linear.bias"] = (h,)
    out["fusion_layer.vis_conv.weight"] = (h, h, 1, 1)
    out["fusion_layer.vis_conv.bias"] = (h,)
    sizes = [h] + list(t.map_hidden_sizes)
    for i, k in enumerate(t.map_kernel_sizes):
        out[f"map_layer.convs.{i}.weight"] = (sizes[i + 1], sizes[i], k, k)
        out[f"map_layer.convs.{i}.bias"] = (sizes[i + 1],)
    out["pred_layer.weight"] = (1, sizes[-1], 1, 1)
    out["pred_layer.bias"] = (1,)
    return out


def map_cascade(num_clips: int, num_scale_layers):
    """The sparse map's pooling stages (prop_modules/sparse.py): scale 0
    starts with a max pool (1, 1), every later scale with (3, 2), each then
    (2, 1) to its NUM_SCALE_LAYERS; stage i of a scale fills the cells
    (s, s + acc + i * stride) for s = 0, stride, ... below num_clips - acc -
    i * stride. Returns [(kernel, stride, start cells, end cells)]."""
    stages, acc, stride = [], 0, 1
    for scale, n_layers in enumerate(num_scale_layers):
        layers = [(1, 1) if scale == 0 else (3, 2)] + [(2, 1)] * (n_layers - 1)
        for i, (k, s) in enumerate(layers):
            stride *= s
            starts = list(range(0, num_clips - acc - i * stride, stride))
            stages.append((k, s, starts, [x + acc + i * stride for x in starts]))
        acc += stride * (len(layers) + 1)
    return stages


def map_mask(num_clips: int, num_scale_layers, device) -> torch.Tensor:
    mask = torch.zeros(num_clips, num_clips, device=device)
    for _, _, s, e in map_cascade(num_clips, num_scale_layers):
        mask[s, e] = 1.0
    return mask


def sparse_map(x, num_clips: int, num_scale_layers):
    """(N, C, num_clips) pooled frames -> (N, C, S, E) map."""
    out = x.new_zeros(*x.shape[:2], num_clips, num_clips)
    for k, s, starts, ends in map_cascade(num_clips, num_scale_layers):
        x = F.max_pool1d(x, k, s)
        if x.shape[-1] != len(starts):
            raise ValueError("the cascade does not fit num_clips")
        out[:, :, starts, ends] = x
    return out


def lstm_last(params, t, tokens):
    """(n, Dt) tokens of one query -> (txt_hidden,) output of the last
    layer at its last token: i, f, g, o = W_ih x + b_ih + W_hh h + b_hh;
    c = sigmoid(f) c + sigmoid(i) tanh(g); h = sigmoid(o) tanh(c)."""
    x = tokens
    for layer in range(t.lstm_layers):
        p = f"fusion_layer.textual_encoder.{{}}_l{layer}"
        w_ih, w_hh = params[p.format("weight_ih")], params[p.format("weight_hh")]
        b = params[p.format("bias_ih")] + params[p.format("bias_hh")]
        pre = x @ w_ih.T + b
        h = x.new_zeros(t.txt_hidden_size)
        c = x.new_zeros(t.txt_hidden_size)
        outs = []
        for step in range(len(x)):
            i, f, g, o = (pre[step] + w_hh @ h).chunk(4)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs)
    return x[-1]


def _conv_counts(mask, t):
    """Each convolution's 1 / (valid cells its kernel saw), 0 where none
    (map_modules/__init__.py get_padded_mask_and_weight)."""
    m = mask[None, None]
    out = []
    for k, p in zip(t.map_kernel_sizes, t.map_paddings):
        count = torch.round(F.conv2d(m, torch.ones(1, 1, k, k, device=m.device), padding=p))
        w = torch.where(count > 0, 1.0 / count.clamp(min=1.0), torch.zeros_like(count))
        out.append(w)
        m = (w > 0).float()
    return out


def score_maps(params, t, win, txt, mask):
    """win (N, frames, Dv) L2-normalised window features, txt (N, H) query
    vectors -> (N, S, E) cell probabilities."""
    x = F.conv1d(win.transpose(1, 2), params["frame_layer.vis_conv.weight"],
                 params["frame_layer.vis_conv.bias"])
    x = F.avg_pool1d(F.relu(x), t.frame_kernel, t.frame_stride)
    map_h = sparse_map(x, t.num_clips, t.num_scale_layers)
    vis = F.conv2d(map_h, params["fusion_layer.vis_conv.weight"],
                   params["fusion_layer.vis_conv.bias"])
    fused = F.normalize(txt[:, :, None, None] * vis, dim=1) * mask
    for i, (p, w) in enumerate(zip(t.map_paddings, _conv_counts(mask, t))):
        fused = F.relu(F.conv2d(fused, params[f"map_layer.convs.{i}.weight"],
                                params[f"map_layer.convs.{i}.bias"], padding=p)) * w
    pred = F.conv2d(fused, params["pred_layer.weight"], params["pred_layer.bias"])[:, 0]
    return torch.sigmoid(pred * mask) * mask


def window_nms(prob, num_clips: int, top_p: int):
    """One window's (S * E,) probabilities -> the kept cells [(s, e + 1,
    prob)] in kept order: the POOL best cells (ties to the higher flat
    index, np.argsort(ravel())[::-1]), valid (prob > 0), then
    moment_localization's nms: take the best left, drop every cell whose
    IoU with it passes WITHIN_NMS_THD, until top_p are kept."""
    p = prob.cpu().numpy()
    order = np.argsort(p, kind="stable")[::-1][:POOL]
    order = order[p[order] > 0]
    s = (order // num_clips).astype(np.float32)
    e = (order % num_clips + 1).astype(np.float32)
    kept, alive = [], np.ones(len(order), bool)
    for i in range(len(order)):
        if not alive[i]:
            continue
        kept.append((int(s[i]), int(e[i]), float(p[order[i]])))
        if len(kept) == top_p:
            break
        inter = np.maximum(np.float32(0), np.minimum(e[i], e) - np.maximum(s[i], s))
        union = (e[i] - s[i]) + (e - s) - inter
        alive &= ~(inter / union > np.float32(WITHIN_NMS_THD))
    return kept


def matching(appear, cls, start, end):
    """Cosine of the unit CLS with the mean L2-normalised frame of
    appear[start:end) of the window, per kept cell; an empty span scores 0."""
    pos = torch.arange(appear.shape[0], device=appear.device)
    seg = ((pos >= start[:, None]) & (pos < end[:, None])).float()
    pooled = (seg @ appear) / seg.sum(-1, keepdim=True).clamp(min=1.0)
    n = pooled.norm(dim=-1, keepdim=True)
    pooled = torch.where(n > 0, pooled / torch.where(n > 0, n, 1.0), torch.zeros_like(pooled))
    return pooled @ (cls / cls.norm())


def coarse_scores(raw_video, raw_cls, stride: int, block: int = 256):
    """Window scores (Q, n_win): each query's L2-normalised CLS against the
    L2-normalised frames, adapter off."""
    v = l2n(raw_video)
    return torch.cat([window_scores(l2n(raw_cls[i:i + block]) @ v.T, stride)
                      for i in range(0, len(raw_cls), block)])


def seconds(start, end, t, wstart, clip_length: float):
    """Cells [start, end) of a window starting at frame `wstart` -> float32
    seconds, (cell * frame_stride + wstart) * clip_length."""
    cells = torch.stack([start, end], dim=-1).float()
    return (cells * t.frame_stride + wstart) * clip_length


def fine(params, t, data, raw_video, items, top_p: int, block: int = 64):
    """items: [(raw_tok (n, Dt), raw_cls (D,), win_ids (K,) long)] of one
    video. Returns per item (sec (K, top_p, 2), prob, match (K, top_p),
    valid (K, top_p)) as numpy arrays, the windows in blocks."""
    stride = data.max_v_l // 2
    feats = l2n(raw_video)
    ctx = feats.shape[0]
    mask = map_mask(t.num_clips, t.num_scale_layers, feats.device)
    rows = []
    for tok, cls, wins in items:
        txt = lstm_last(params, t, l2n(tok)[:data.max_q_l])
        txt = txt @ params["fusion_layer.tex_linear.weight"].T \
            + params["fusion_layer.tex_linear.bias"]
        rows.extend((txt, l2n(cls[None])[0], int(w)) for w in wins.tolist())
    k_all = len(rows)
    sec = np.zeros((k_all, top_p, 2), np.float32)
    prob = np.zeros((k_all, top_p), np.float32)
    match = np.zeros((k_all, top_p), np.float32)
    valid = np.zeros((k_all, top_p), bool)
    pos = torch.arange(data.max_v_l, device=feats.device)
    for b0 in range(0, k_all, block):
        part = rows[b0:b0 + block]
        w = torch.tensor([r[2] for r in part], device=feats.device)
        start = ((w - 1) * stride).clamp(min=0)
        end = torch.clamp((w - 1) * stride + data.max_v_l, max=ctx)
        idx = start[:, None] + pos
        wmask = (idx < end[:, None]).float()
        win = feats[idx.clamp(max=ctx - 1)] * wmask[..., None]
        probs = score_maps(params, t, win, torch.stack([r[0] for r in part]), mask)
        for j, r in enumerate(part):
            kept = window_nms(probs[j].reshape(-1), t.num_clips, top_p)
            if not kept:
                continue
            n = len(kept)
            s = torch.tensor([c[0] for c in kept], device=feats.device)
            e = torch.tensor([c[1] for c in kept], device=feats.device)
            sc = seconds(s, e, t, start[j].float(), data.clip_length)
            m = matching(win[j], r[1], s * t.frame_stride, e * t.frame_stride)
            sec[b0 + j, :n] = sc.cpu().numpy()
            prob[b0 + j, :n] = [c[2] for c in kept]
            match[b0 + j, :n] = m.cpu().numpy()
            valid[b0 + j, :n] = True
    res, at = [], 0
    for _, _, wins in items:
        k = len(wins)
        res.append((sec[at:at + k], prob[at:at + k], match[at:at + k], valid[at:at + k]))
        at += k
    return res


def round4(x):
    """4-dp rounding of a float32 tensor with the integer part split off."""
    i = torch.floor(x)
    return i + torch.round((x - i) * 1e4) / 1e4


def min_max(x):
    lo, hi = x.min(), x.max()
    rng = hi - lo
    return x if float(rng) <= 0 else (x - lo) / rng


def nms(spans, scores, thd: float, max_after: int):
    """Greedy NMS over the standard union (lib/core/eval.py nms): spans (P,
    2) and scores (P,) float32 tensors in score order -> kept positions."""
    st, ed = spans[:, 0], spans[:, 1]
    inter = (torch.minimum(ed[:, None], ed[None, :])
             - torch.maximum(st[:, None], st[None, :])).clamp(min=0)
    union = (ed - st)[:, None] + (ed - st)[None, :] - inter
    iou = torch.where(union != 0, inter / torch.where(union == 0, 1.0, union),
                      torch.zeros_like(inter))
    over = (iou > thd).cpu().numpy()
    kept, alive = [], np.ones(len(st), bool)
    for i in range(len(st)):
        if alive[i]:
            kept.append(i)
            if len(kept) == max_after:
                break
            alive &= ~over[i]
    return kept


def post(sec, prob, match, valid, ev, device):
    """One query's (K, P) candidates, windows in ranked order -> the kept
    [st, ed, score] moments of each modality: within each window by
    probability (stable), rounded to 4 dp, min-max fusion, the dict dedup
    (the first occurrence's place, the last one's scores), NMS on the best
    max_before_nms."""
    rows = []
    for w in range(prob.shape[0]):
        order = [q for q in np.argsort(-prob[w], kind="stable") if valid[w, q]]
        rows.extend((w, q) for q in order)
    if not rows:
        return {name: [] for name in ("fusion", "proposal", "matching")}
    ws, qs = np.asarray(rows).T
    sp = round4(torch.from_numpy(sec[ws, qs]).to(device))
    pr = round4(torch.from_numpy(prob[ws, qs]).to(device))
    ma = round4(torch.from_numpy(match[ws, qs]).to(device))
    fused = min_max(pr) + min_max(ma)
    keys = [tuple(k) for k in sp.cpu().numpy().tolist()]
    first, last = {}, {}
    for i, key in enumerate(keys):
        first.setdefault(key, i)
        last[key] = i
    slots = sorted(first.values())
    at_last = [last[keys[i]] for i in slots]
    out = {}
    for name, vals in (("proposal", pr), ("matching", ma), ("fusion", fused)):
        v = vals[at_last].cpu().numpy().tolist()
        order = sorted(range(len(slots)), key=lambda j: v[j], reverse=True)[:ev.max_before_nms]
        spans = sp[[slots[j] for j in order]]
        kept = nms(spans, vals[[at_last[j] for j in order]], ev.nms_thd, ev.max_after_nms)
        host = spans.cpu().numpy().tolist()
        out[name] = [[host[i][0], host[i][1], v[order[i]]] for i in kept]
    return out
