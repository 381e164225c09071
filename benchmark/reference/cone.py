"""The CONE model (cone/model.py, cone/transformer.py,
cone/position_encoding.py) as plain functions over a state dict.

`params` is a dict of float32 tensors under the reference's state-dict
names; `m` is the config's `model` section (any object with its fields).
The transformer is post-norm (pre-norm on request), positional embeddings
are added to queries and keys, never to values, key padding enters the
logits as -1e30, and the decoder returns every layer through the shared
final LayerNorm.

Dropout: `drop` is None at inference. In training it is a `Dropout` that
draws each mask as one uniform tensor of the activation's shape from the
step's generator, in the order the layers run: the same stream, the same
order and the same shapes as the published dropout points, so a program
that draws its masks the same way is compared mask for mask.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch

NEG = -1e30
LN_EPS = 1e-5


def param_shapes(m) -> "OrderedDict[str, tuple]":
    """Every parameter of the model, by its reference name, in order."""
    d, f, nq = m.hidden_dim, m.dim_feedforward, m.num_queries
    out = OrderedDict()

    def linear(name, i, o):
        out[f"{name}.weight"] = (o, i)
        out[f"{name}.bias"] = (o,)

    def norm(name, dim):
        out[f"{name}.weight"] = (dim,)
        out[f"{name}.bias"] = (dim,)

    for branch, in_dim in (("input_txt_proj", m.t_feat_dim), ("input_vid_proj", m.v_motion_feat_dim)):
        for i in range(m.n_input_proj):
            norm(f"{branch}.{i}.LayerNorm", in_dim if i == 0 else d)
            linear(f"{branch}.{i}.net.1", in_dim if i == 0 else d, d)

    def attn(name):
        out[f"{name}.in_proj_weight"] = (3 * d, d)
        out[f"{name}.in_proj_bias"] = (3 * d,)
        linear(f"{name}.out_proj", d, d)

    for i in range(m.enc_layers):
        p = f"transformer.encoder.layers.{i}"
        attn(f"{p}.self_attn")
        linear(f"{p}.linear1", d, f)
        linear(f"{p}.linear2", f, d)
        norm(f"{p}.norm1", d)
        norm(f"{p}.norm2", d)
    for i in range(m.dec_layers):
        p = f"transformer.decoder.layers.{i}"
        attn(f"{p}.self_attn")
        attn(f"{p}.multihead_attn")
        linear(f"{p}.linear1", d, f)
        linear(f"{p}.linear2", f, d)
        for j in (1, 2, 3):
            norm(f"{p}.norm{j}", d)
    norm("transformer.decoder.norm", d)
    out["query_embed.weight"] = (nq, d)
    linear("span_embed.layers.0", d, d)
    linear("span_embed.layers.1", d, d)
    linear("span_embed.layers.2", d, 2)
    linear("class_embed", d, 2)
    linear("saliency_proj", d, 1)
    out["txt_position_embed.position_embeddings.weight"] = (m.max_q_l, d)
    norm("txt_position_embed.LayerNorm", d)
    if m.adapter_module == "linear":
        linear("adapter_layer.layers.0", m.v_appear_feat_dim, d)
        linear("adapter_layer.layers.1", d, m.v_appear_feat_dim)
    return out


class Dropout:
    """Masks drawn from one generator in call order: u ~ U[0, 1) of the
    activation's shape, kept where u >= p, scaled by 1 / (1 - p)."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator

    def __call__(self, x, p):
        if p == 0.0:
            return x
        u = torch.rand(x.shape, generator=self.gen, device=x.device, dtype=torch.float32)
        return x * (u >= p).to(x.dtype) * (1.0 / (1.0 - p))


def _lin(params, name, x):
    return x @ params[f"{name}.weight"].T + params[f"{name}.bias"]


def _ln(params, name, x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * params[f"{name}.weight"] + params[f"{name}.bias"]


def _mha(params, name, m, q_in, k_in, v_in, key_pad, drop):
    d, h = m.hidden_dim, m.nheads
    w, b = params[f"{name}.in_proj_weight"], params[f"{name}.in_proj_bias"]
    q = q_in @ w[:d].T + b[:d]
    k = k_in @ w[d:2 * d].T + b[d:2 * d]
    v = v_in @ w[2 * d:].T + b[2 * d:]

    def heads(x):
        return x.reshape(x.shape[0], x.shape[1], h, d // h).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    logits = (q * (d // h) ** -0.5) @ k.transpose(-1, -2)
    if key_pad is not None:
        logits = logits.masked_fill(key_pad[:, None, None, :], NEG)
    weights = torch.softmax(logits, dim=-1)
    if drop is not None:
        weights = drop(weights, m.dropout)
    out = (weights @ v).transpose(1, 2).reshape(q_in.shape[0], q_in.shape[1], d)
    return _lin(params, f"{name}.out_proj", out)


def _ffn(params, name, m, x, drop):
    hid = torch.relu(_lin(params, f"{name}.linear1", x))
    if drop is not None:
        hid = drop(hid, m.dropout)
    return _lin(params, f"{name}.linear2", hid)


def _d(drop, x, p):
    return x if drop is None else drop(x, p)


def sine_embedding(mask, num_feats, temperature=10000.0):
    """The normalised 1-D sine embedding of the valid positions."""
    x = mask.float().cumsum(1)
    x = x / (x[:, -1:] + 1e-6) * (2 * math.pi)
    i = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.div(i, 2, rounding_mode="floor") / num_feats)
    pos = x[:, :, None] / dim_t
    return torch.stack([pos[:, :, 0::2].sin(), pos[:, :, 1::2].cos()], dim=3).flatten(2)


def _proj(params, branch, m, x, drop):
    for i in range(m.n_input_proj):
        x = _ln(params, f"{branch}.{i}.LayerNorm", x)
        x = _lin(params, f"{branch}.{i}.net.1", _d(drop, x, m.input_dropout))
        if i < m.n_input_proj - 1:
            x = torch.relu(x)
    return x


def forward(params, m, txt, txt_mask, vid, vid_mask, drop=None):
    """txt (B, Lq, Dt), txt_mask (B, Lq), vid (B, Lv, Dv), vid_mask (B, Lv),
    masks 1 = valid. Returns pred_logits (B, NQ, 2), pred_spans (B, NQ, 2)
    (sigmoid cxw), saliency (B, Lv), aux [(logits, spans)] of the earlier
    decoder layers."""
    v = _proj(params, "input_vid_proj", m, vid, drop)
    t = _proj(params, "input_txt_proj", m, txt, drop)
    src = torch.cat([v, t], dim=1)
    key_pad = ~torch.cat([vid_mask, txt_mask], dim=1).bool()
    pos_t = (_d(drop, _ln(params, "txt_position_embed.LayerNorm",
                          t + params["txt_position_embed.position_embeddings.weight"][: t.shape[1]]),
                m.input_dropout)
             if m.use_txt_pos else torch.zeros_like(t))
    pos = torch.cat([sine_embedding(vid_mask, m.hidden_dim), pos_t], dim=1)

    x = src
    for i in range(m.enc_layers):
        p = f"transformer.encoder.layers.{i}"
        if m.pre_norm:
            x2 = _ln(params, f"{p}.norm1", x)
            x = x + _d(drop, _mha(params, f"{p}.self_attn", m, x2 + pos, x2 + pos, x2, key_pad,
                                  drop), m.dropout)
            x = x + _d(drop, _ffn(params, p, m, _ln(params, f"{p}.norm2", x), drop), m.dropout)
        else:
            x = _ln(params, f"{p}.norm1", x + _d(drop, _mha(
                params, f"{p}.self_attn", m, x + pos, x + pos, x, key_pad, drop), m.dropout))
            x = _ln(params, f"{p}.norm2", x + _d(drop, _ffn(params, p, m, x, drop), m.dropout))
    memory = x
    query_pos = params["query_embed.weight"][None].expand(src.shape[0], -1, -1)
    tgt = torch.zeros_like(query_pos)
    hs = []
    for i in range(m.dec_layers):
        p = f"transformer.decoder.layers.{i}"
        if m.pre_norm:
            t2 = _ln(params, f"{p}.norm1", tgt)
            tgt = tgt + _d(drop, _mha(params, f"{p}.self_attn", m, t2 + query_pos,
                                      t2 + query_pos, t2, None, drop), m.dropout)
            t2 = _ln(params, f"{p}.norm2", tgt)
            tgt = tgt + _d(drop, _mha(params, f"{p}.multihead_attn", m, t2 + query_pos,
                                      memory + pos, memory, key_pad, drop), m.dropout)
            tgt = tgt + _d(drop, _ffn(params, p, m, _ln(params, f"{p}.norm3", tgt), drop),
                           m.dropout)
        else:
            tgt = _ln(params, f"{p}.norm1", tgt + _d(drop, _mha(
                params, f"{p}.self_attn", m, tgt + query_pos, tgt + query_pos, tgt, None, drop),
                m.dropout))
            tgt = _ln(params, f"{p}.norm2", tgt + _d(drop, _mha(
                params, f"{p}.multihead_attn", m, tgt + query_pos, memory + pos, memory,
                key_pad, drop), m.dropout))
            tgt = _ln(params, f"{p}.norm3", tgt + _d(drop, _ffn(params, p, m, tgt, drop),
                                                      m.dropout))
        hs.append(_ln(params, "transformer.decoder.norm", tgt))
    logits, spans = [], []
    for h in hs:
        logits.append(_lin(params, "class_embed", h))
        s = torch.relu(_lin(params, "span_embed.layers.0", h))
        s = torch.relu(_lin(params, "span_embed.layers.1", s))
        spans.append(torch.sigmoid(_lin(params, "span_embed.layers.2", s)))
    saliency = _lin(params, "saliency_proj", memory[:, : vid.shape[1]])[..., 0]
    return {"pred_logits": logits[-1], "pred_spans": spans[-1], "saliency": saliency,
            "aux": list(zip(logits[:-1], spans[:-1]))}


def adapt(params, m, x):
    """The residual adapter: x + MLP(x)."""
    if m.adapter_module != "linear":
        return x
    h = torch.relu(_lin(params, "adapter_layer.layers.0", x))
    return x + _lin(params, "adapter_layer.layers.1", h)


def cxw_to_xx(s):
    return torch.stack([s[..., 0] - 0.5 * s[..., 1], s[..., 0] + 0.5 * s[..., 1]], dim=-1)


def segment_mean(feats, start, end):
    """Mean of feats[b, start[b, k]:end[b, k]] for every (b, k); an empty
    segment gives zeros."""
    pos = torch.arange(feats.shape[1], device=feats.device)
    seg = ((pos >= start[..., None]) & (pos < end[..., None])).float()
    return (seg @ feats) / seg.sum(-1, keepdim=True).clamp(min=1.0)


def matching_pred(params, m, cls, appear, appear_mask, spans_cxw):
    """Cosine between each predicted proposal's adapted mean feature and the
    query's CLS (cone/model.py:178-210); an empty proposal scores 0."""
    dur = appear_mask.sum(-1)
    xx = cxw_to_xx(spans_cxw) * dur[:, None, None]
    start = torch.floor(xx[..., 0]).clamp(min=0.0)
    end = torch.ceil(xx[..., 1])
    pooled = adapt(params, m, segment_mean(appear, start, end))
    n = pooled.norm(dim=-1, keepdim=True)
    pooled = torch.where(n > 0, pooled / torch.where(n > 0, n, 1.0), torch.zeros_like(pooled))
    text = cls / cls.norm(dim=-1, keepdim=True)
    return (pooled * text[:, None, :]).sum(-1)


def matching_gt_embeds(params, m, cls, appear, start, end):
    """Unit-norm adapted GT-proposal features and text CLS (cone/model.py:130-148)."""
    text = cls / cls.norm(dim=1, keepdim=True)
    pooled = segment_mean(appear, start[:, None], end[:, None])[:, 0]
    prop = adapt(params, m, pooled)
    return prop / prop.norm(dim=1, keepdim=True), text
