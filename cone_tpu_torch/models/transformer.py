"""DETR-style transformer, batch-major (B, L, D) (cone/transformer.py:18-353).

Post-norm by default, pre-norm on request; positional embeddings are added
to queries and keys, never to values; the decoder returns every layer's
output through the shared final LayerNorm. Parameter names are the
reference's torch state-dict names (`encoder.layers.0.self_attn.in_proj_weight`,
`decoder.norm.weight`, ...), so reference checkpoints load directly.

Attention is an explicit matmul + softmax with key padding as an additive
-1e30 (transformer.py:91-94 of the JAX package): a boolean mask in
scaled_dot_product_attention would turn fully masked rows into NaN.
Dropout draws its masks for the global batch (models/dropout.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cone_tpu_torch.models.dropout import RowDropout

NEG_INF = -1e30
LN_EPS = 1e-5


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed (3D, D) in-proj with
    row blocks [q | k | v]), computed with only the rows each input needs."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.1,
                 device=None):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model, device=device))
        self.out_proj = nn.Linear(d_model, d_model, device=device)
        self.dropout = RowDropout(dropout)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value,
                key_padding_mask: Optional[torch.Tensor] = None):
        """query (B, Lq, D), key/value (B, Lk, D), key_padding_mask (B, Lk)
        True = ignore. Self-attention (query is key) projects q and k in
        one matmul."""
        d, h = self.d_model, self.nhead
        w, bias = self.in_proj_weight, self.in_proj_bias
        if query is key:
            q, k = F.linear(query, w[: 2 * d], bias[: 2 * d]).split(d, dim=-1)
        else:
            q = F.linear(query, w[:d], bias[:d])
            k = F.linear(key, w[d : 2 * d], bias[d : 2 * d])
        v = F.linear(value, w[2 * d :], bias[2 * d :])

        def split(x):
            b, l, _ = x.shape
            return x.reshape(b, l, h, d // h).transpose(1, 2)  # (B, H, L, hd)

        q, k, v = split(q), split(k), split(v)
        logits = (q * (d // h) ** -0.5) @ k.transpose(-1, -2)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        weights = self.dropout(torch.softmax(logits, dim=-1))
        out = (weights @ v).transpose(1, 2)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], d))


class EncoderLayer(nn.Module):
    """cone/transformer.py:211-268."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout, pre_norm=False,
                 device=None):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = MultiheadAttention(d_model, nhead, dropout, device=device)
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.dropout = RowDropout(dropout)

    def _ffn(self, x):
        return self.linear2(self.dropout(F.relu(self.linear1(x))))

    def forward(self, src, key_padding_mask, pos):
        if self.pre_norm:
            src2 = self.norm1(src)
            qk = src2 + pos
            src = src + self.dropout(self.self_attn(qk, qk, src2, key_padding_mask))
            return src + self.dropout(self._ffn(self.norm2(src)))
        qk = src + pos
        src = self.norm1(src + self.dropout(self.self_attn(qk, qk, src, key_padding_mask)))
        return self.norm2(src + self.dropout(self._ffn(src)))


class DecoderLayer(nn.Module):
    """cone/transformer.py:271-353."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout, pre_norm=False,
                 device=None):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = MultiheadAttention(d_model, nhead, dropout, device=device)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout, device=device)
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.dropout = RowDropout(dropout)

    def _ffn(self, x):
        return self.linear2(self.dropout(F.relu(self.linear1(x))))

    def forward(self, tgt, memory, memory_key_padding_mask, pos, query_pos):
        drop = self.dropout
        if self.pre_norm:
            tgt2 = self.norm1(tgt)
            qk = tgt2 + query_pos
            tgt = tgt + drop(self.self_attn(qk, qk, tgt2))
            tgt2 = self.norm2(tgt)
            tgt = tgt + drop(self.multihead_attn(tgt2 + query_pos, memory + pos, memory,
                                                 memory_key_padding_mask))
            return tgt + drop(self._ffn(self.norm3(tgt)))
        qk = tgt + query_pos
        tgt = self.norm1(tgt + drop(self.self_attn(qk, qk, tgt)))
        tgt = self.norm2(tgt + drop(self.multihead_attn(
            tgt + query_pos, memory + pos, memory, memory_key_padding_mask)))
        return self.norm3(tgt + drop(self._ffn(tgt)))


class _Stack(nn.Module):
    """`layers` + optional final `norm`: the reference's TransformerEncoder /
    TransformerDecoder containers, kept for their state-dict names."""

    def __init__(self, layers, norm: Optional[nn.LayerNorm]):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class DetrTransformer(nn.Module):
    """Encoder + decoder returning all intermediate decoder states
    (cone/transformer.py:18-73, return_intermediate_dec=True)."""

    def __init__(self, d_model=256, nhead=8, num_encoder_layers=2,
                 num_decoder_layers=2, dim_feedforward=1024, dropout=0.1,
                 pre_norm=False, device=None):
        super().__init__()
        self.pre_norm = pre_norm
        self.encoder = _Stack(
            [EncoderLayer(d_model, nhead, dim_feedforward, dropout, pre_norm, device)
             for _ in range(num_encoder_layers)],
            nn.LayerNorm(d_model, eps=LN_EPS, device=device) if pre_norm else None)
        self.decoder = _Stack(
            [DecoderLayer(d_model, nhead, dim_feedforward, dropout, pre_norm, device)
             for _ in range(num_decoder_layers)],
            nn.LayerNorm(d_model, eps=LN_EPS, device=device))
        for p in self.parameters():
            if p.dim() > 1:
                nn.init.xavier_uniform_(p)

    def forward(self, src, mask, query_embed, pos_embed):
        """src (B, L, D); mask (B, L) 1 = valid; query_embed (NQ, D);
        pos_embed (B, L, D). Returns hs (n_dec, B, NQ, D), memory (B, L, D)."""
        key_padding = ~mask.bool()
        out = src
        for layer in self.encoder.layers:
            out = layer(out, key_padding, pos_embed)
        if self.encoder.norm is not None:
            out = self.encoder.norm(out)
        memory = out

        query_pos = query_embed[None].expand(src.shape[0], -1, -1)
        tgt = torch.zeros_like(query_pos)
        intermediate = []
        for layer in self.decoder.layers:
            tgt = layer(tgt, memory, key_padding, pos_embed, query_pos)
            intermediate.append(self.decoder.norm(tgt))
        return torch.stack(intermediate), memory
