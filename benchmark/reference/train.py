"""One CONE training step, plain (cone/train.py:53-89, cone/model.py:213-425,
cone/matcher.py, cone/ego4d_mad_dataloader.py:160-227):

  * the batch: the epoch's shuffled order and each example's positive and
    negative window, span label and saliency frames, drawn with numpy from
    (seed, epoch) and (seed, epoch, example) as the published loader's
    seeding contract states;
  * the positive and negative window forwards with dropout (masks drawn in
    layer order from one generator seeded from (seed, step));
  * the criterion: Hungarian-matched span L1 and gIoU (scipy's assignment
    over each sample's real targets), foreground/background cross entropy
    with the negative window's queries as background, the intra- and
    inter-window saliency hinges, the adapter's InfoNCE, and the span,
    gIoU and label terms of each earlier decoder layer;
  * the backward, the global-norm clip, a zero gradient for a parameter
    without one, AdamW with the adapter's lr group.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from benchmark.reference import cone

FG, BG = 0, 1


def l2n_np(x, eps=1e-5):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed of one step."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])


class Examples:
    """The corpus as the loader sees it: normalised video rows, tokens and
    CLS, ground truth in seconds."""

    def __init__(self, corpus, data):
        self.data = data
        self.videos = [l2n_np(f.astype(np.float32)) for f in corpus.feats]
        self.corpus = corpus

    def __len__(self):
        return len(self.corpus.query_ids)

    def sample(self, i: int, rng: np.random.Generator) -> dict:
        data, c = self.data, self.corpus
        stride = data.max_v_l // 2
        tok = l2n_np(c.tokens[i].astype(np.float32))[: data.max_q_l]
        cls = l2n_np(c.cls[i].astype(np.float32))
        feats = self.videos[c.video[i]]
        ctx_l = len(feats)
        n_win = math.ceil(ctx_l / stride) + 1
        ts = [float(c.gt[i, 0] * data.clip_length), float(c.gt[i, 1] * data.clip_length)]
        start = min(ctx_l, ts[0] / data.clip_length)
        end = min(ctx_l, ts[1] / data.clip_length)
        pos_ids = np.arange(math.floor(start / stride), math.ceil(end / stride) + 1)
        neg_pool = sorted(set(range(n_win)) - set(pos_ids.tolist()))
        x = pos_ids - pos_ids.mean()
        w = np.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)
        idx = int(rng.choice(pos_ids, p=w / w.sum()))
        w_start = max((idx - 1) * stride, 0)
        w_end = min((idx - 1) * stride + data.max_v_l, ctx_l)
        w_len = w_end - w_start
        start_pos = max((idx - 1) * stride, start) - w_start
        end_pos = min((idx - 1) * stride + data.max_v_l, end) - w_start
        st_n, ed_n = start_pos / w_len, end_pos / w_len
        rel = list(range(math.floor(start_pos), math.ceil(end_pos))) or [math.floor(start_pos)]
        easy = sorted(set(range(w_len)) - set(rel)) or [0]
        sal_pos = int(rng.choice(rel))
        sal_neg = int(rng.choice(easy))
        nidx = int(neg_pool[rng.integers(len(neg_pool))])
        n_start = max((nidx - 1) * stride, 0)
        n_end = min((nidx - 1) * stride + data.max_v_l, ctx_l)

        def pad(x):
            out = np.zeros((data.max_v_l, x.shape[1]), np.float32)
            out[: len(x)] = x
            m = np.zeros(data.max_v_l, np.float32)
            m[: len(x)] = 1
            return out, m

        pos, pos_mask = pad(feats[w_start:w_end])
        neg, neg_mask = pad(feats[n_start:n_end])
        q = np.zeros((data.max_q_l, tok.shape[1]), np.float32)
        q[: len(tok)] = tok
        q_mask = np.zeros(data.max_q_l, np.float32)
        q_mask[: len(tok)] = 1
        spans = np.zeros((data.max_windows, 2), np.float32)
        spans[0] = [(st_n + ed_n) / 2, ed_n - st_n]
        span_mask = np.zeros(data.max_windows, np.float32)
        span_mask[0] = 1
        return dict(tok=q, tok_mask=q_mask, cls=cls, pos=pos, pos_mask=pos_mask, neg=neg,
                    neg_mask=neg_mask, spans=spans, span_mask=span_mask,
                    prop_start=math.floor(start_pos), prop_end=math.ceil(end_pos),
                    sal_pos=sal_pos, sal_neg=sal_neg)

    def batch(self, seed: int, epoch: int, step: int, bsz: int, device) -> dict:
        order = np.random.default_rng((seed, epoch)).permutation(len(self))
        idxs = order[step * bsz:(step + 1) * bsz]
        rows = [self.sample(int(i), np.random.default_rng((seed, epoch, int(i)))) for i in idxs]
        out = {}
        for k in rows[0]:
            a = np.stack([np.asarray(r[k]) for r in rows])
            t = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)
            out[k] = t.to(device)
        return out


def _giou(a, b):
    """gIoU of paired xx spans (..., 2)."""
    inter = (torch.minimum(a[..., 1], b[..., 1]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    union = (a[..., 1] - a[..., 0]) + (b[..., 1] - b[..., 0]) - inter
    encl = (torch.maximum(a[..., 1], b[..., 1]) - torch.minimum(a[..., 0], b[..., 0])).clamp(min=0)
    return inter / union - (encl - union) / encl


def _match(spans, logits, tgt, tmask, loss_cfg):
    """The query of each real target, per sample (scipy's assignment over
    the matcher's cost). Returns a list of (target rows, query rows)."""
    prob = torch.softmax(logits, -1)[..., FG]
    out = []
    for b in range(spans.shape[0]):
        real = torch.nonzero(tmask[b] > 0)[:, 0]
        t = tgt[b, real]
        l1 = (spans[b][:, None, :] - t[None, :, :]).abs().sum(-1)
        px, tx = cone.cxw_to_xx(spans[b]), cone.cxw_to_xx(t)
        g = _giou(px[:, None, :].expand(-1, len(t), -1), tx[None, :, :].expand(len(px), -1, -1))
        cost = loss_cfg.set_cost_span * l1 - loss_cfg.set_cost_giou * g \
            - loss_cfg.set_cost_class * prob[b][:, None]
        qi, ti = linear_sum_assignment(cost.detach().cpu().numpy())
        out.append((real[torch.as_tensor(ti, device=spans.device)],
                    torch.as_tensor(qi, device=spans.device)))
    return out


def _layer_terms(spans, logits, neg_logits, batch, loss_cfg):
    tgt, tmask = batch["spans"], batch["span_mask"]
    n = tmask.sum().clamp(min=1.0)
    assign = _match(spans, logits, tgt, tmask, loss_cfg)
    l1, giou = 0.0, 0.0
    fg = torch.zeros(logits.shape[:2], dtype=torch.bool, device=logits.device)
    for b, (ti, qi) in enumerate(assign):
        src, t = spans[b, qi], tgt[b, ti]
        l1 = l1 + (src - t).abs().sum()
        giou = giou + (1 - _giou(cone.cxw_to_xx(src), cone.cxw_to_xx(t))).sum()
        fg[b, qi] = True
    all_logits = torch.cat([logits, neg_logits], dim=1)
    labels = torch.cat([torch.where(fg, FG, BG), torch.full_like(fg, BG, dtype=torch.long)], 1)
    nll = torch.nn.functional.cross_entropy(all_logits.flatten(0, 1), labels.flatten(),
                                            reduction="none")
    w = torch.where(labels.flatten() == FG, 1.0, loss_cfg.eos_coef)
    return {"span": l1 / (2.0 * n), "giou": giou / n, "label": (w * nll).mean()}


def losses(params, cfg, batch, adapter_on: bool, drop) -> dict:
    """Every weighted criterion term of one batch and their sum."""
    m, lc = cfg.model, cfg.loss
    pos = cone.forward(params, m, batch["tok"], batch["tok_mask"], batch["pos"],
                       batch["pos_mask"], drop)
    neg = cone.forward(params, m, batch["tok"], batch["tok_mask"], batch["neg"],
                       batch["neg_mask"], drop)
    out = {}
    main = _layer_terms(pos["pred_spans"], pos["pred_logits"], neg["pred_logits"], batch, lc)
    out.update({f"loss_{k}": v for k, v in main.items()})
    sal = pos["saliency"]
    b = sal.shape[0]
    sp = sal.gather(1, batch["sal_pos"][:, None])
    sn = sal.gather(1, batch["sal_neg"][:, None])
    intra = (lc.saliency_margin + sn - sp).clamp(min=0).sum() / b * 2
    neg_max = torch.where(batch["neg_mask"] > 0, neg["saliency"], -1e30).amax(1, keepdim=True)
    inter = (lc.saliency_margin + neg_max - sp).clamp(min=0).sum() / b * 2
    out["loss_saliency"] = intra + inter
    if adapter_on and lc.adapter_loss:
        prop, text = cone.matching_gt_embeds(params, m, batch["cls"], batch["pos"],
                                             batch["prop_start"], batch["prop_end"])
        logits = prop @ text.T / lc.temperature
        diag = torch.arange(b, device=logits.device)
        out["loss_adapter"] = (-logits.log_softmax(-1)[diag, diag].mean()
                               - logits.T.log_softmax(-1)[diag, diag].mean()) / 2
    if lc.aux_loss:
        for i, (lg, sp_) in enumerate(pos["aux"]):
            t = _layer_terms(sp_, lg, neg["pred_logits"], batch, lc)
            out.update({f"loss_{k}_{i}": v for k, v in t.items()})
    total = 0.0
    for k, v in out.items():
        total = total + term_weight(k, lc) * v
    out["loss_overall"] = total
    return out


class AdamW:
    """torch.optim.AdamW's update (decoupled decay, bias-corrected moments)
    with two lr groups: names holding `adapter_layer` at lr * coef_lr."""

    BETAS = (0.9, 0.999)   # torch's defaults, which cone/train.py keeps

    def __init__(self, params: dict, tc, m=None, v=None, t=0, eps=1e-8):
        """Fresh moments, or those of a state (m, v after t updates)."""
        self.tc, self.betas, self.eps = tc, self.BETAS, eps
        self.m = {k: m[k].clone() if m else torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: v[k].clone() if v else torch.zeros_like(p) for k, p in params.items()}
        self.t = t

    def lr(self, name: str, steps_per_epoch: int) -> float:
        scale = self.tc.coef_lr if "adapter_layer" in name else 1.0
        epoch = self.t // max(steps_per_epoch, 1)
        return self.tc.lr * scale * 0.1 ** (epoch // self.tc.lr_drop)

    @torch.no_grad()
    def step(self, params: dict, grads: dict, steps_per_epoch: int) -> None:
        b1, b2 = self.betas
        lrs = {k: self.lr(k, steps_per_epoch) for k in params}
        self.t += 1
        for k, p in params.items():
            g, lr = grads[k], lrs[k]
            p.mul_(1 - lr * self.tc.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** self.t))


def term_weight(name: str, loss_cfg) -> float:
    """The criterion's weight of a term of `losses` (1 for loss_overall)."""
    if name == "loss_overall":
        return 1.0
    return {"span": loss_cfg.span_loss_coef, "giou": loss_cfg.giou_loss_coef,
            "label": loss_cfg.label_loss_coef, "saliency": loss_cfg.lw_saliency,
            "adapter": loss_cfg.adapter_loss_coef}[name.split("_")[1]]


def one_step(params: dict, opt: AdamW, cfg, examples: Examples, seed: int, epoch: int,
             in_epoch: int, adapter_on: bool, steps_per_epoch: int, device) -> dict:
    """The update opt.t + 1 (0-based global step opt.t) on the batch of
    step `in_epoch` of loader epoch `epoch`, `params` updated in place:
    each criterion term, the gradient norm before the clip, the gradients
    after it, as AdamW gets them, and the parameters after the step."""
    batch = examples.batch(seed, epoch, in_epoch, cfg.train.bsz, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, opt.t))
    for p in params.values():
        p.requires_grad_(True)
        p.grad = None
    terms = losses(params, cfg, batch, adapter_on, cone.Dropout(gen))
    terms["loss_overall"].backward()
    clip = cfg.train.grad_clip if cfg.train.grad_clip > 0 else float("inf")
    with torch.no_grad():
        have = [p for p in params.values() if p.grad is not None]
        norm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in have)).float()
        coef = min(1.0, clip / (float(norm) + 1e-6))
        grads = {k: (p.grad * coef if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
    for p in params.values():
        p.requires_grad_(False)
        p.grad = None
    opt.step(params, grads, steps_per_epoch)
    return {"loss": float(terms["loss_overall"].detach()),
            "terms": {k: float(v.detach()) for k, v in terms.items()},
            "grad_norm": float(norm), "grads": grads,
            "params": {k: p.detach().clone() for k, p in params.items()}}


def train_steps(params: dict, cfg, examples: Examples, seed: int, epoch: int, n_steps: int,
                adapter_on: bool, steps_per_epoch: int, device):
    """The first n_steps of a run (global steps 0..n_steps-1, the first
    steps of loader epoch `epoch`) from `params`, updated in place: one
    `one_step` record each."""
    opt = AdamW(params, cfg.train)
    return [one_step(params, opt, cfg, examples, seed, epoch, step, adapter_on,
                     steps_per_epoch, device) for step in range(n_steps)]
