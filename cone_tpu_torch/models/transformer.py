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

Compute dtype (model.compute_dtype), flax's semantics op by op, not
torch.autocast's: parameters stay float32; a `Dense` (and the packed
in-projection) casts its input, weight and bias to the compute dtype and
returns that dtype (`dense`); logits, the mask, softmax and the attention
dropout stay in it; every `LayerNorm` computes in float32 and returns
float32, as flax's LayerNorm without a dtype does; residual adds promote
as jnp's do (bfloat16 + float32 is float32). In float32 every cast is a
no-op.

Tensor parallel (parallel/mesh.shard_model sets `tp` on the modules whose
matmuls it shards): an attention block computes its nhead/tp local heads
(its rows of each q, k, v third of the in-projection) and an FFN its
dim_feedforward/tp hidden units; each takes its input through Megatron's
`f` and sums its row-parallel product over the tp group with `g`
(parallel/distributed.TensorParallel), the bias added once after the sum
(`row_parallel_dense`). The logit scale stays (D/nhead)^-0.5, and the
dropout masks inside the block are the full-width ones of which the rank
keeps its heads or hidden units (models/dropout.py), so a (dp, tp) run
draws the single process's masks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cone_tpu_torch.models.dropout import RowDropout

NEG_INF = -1e30
LN_EPS = 1e-5


def dense(x, weight, bias, dtype):
    """flax's nn.Dense(dtype=...) over float32 parameters: x, the weight and
    the bias cast to `dtype`, the product rounded to it and the bias added
    in it, two roundings as XLA's dot and add make them. One rounding (the
    bias fused into the product) reads no closer to cone_tpu's bfloat16
    path than float32 compute does (PERF.md section 2). float32 fuses."""
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    return F.linear(x.to(dtype), weight.to(dtype)) + bias.to(dtype)


def row_parallel_dense(x, weight, bias, dtype, tp):
    """`dense` with x and the weight split along the inputs over the tp
    group: the partial products summed by `tp.reduce_out`, then the bias.
    In bfloat16 the partials are products of bfloat16 operands summed in
    float32 and rounded once after the sum, as one device's bfloat16 GEMM
    accumulates in float32 and rounds once (rounding each shard's partial
    first, as GSPMD would, adds tp roundings that one device never makes)."""
    if dtype == torch.float32:
        return tp.reduce_out(F.linear(x, weight)) + bias
    partial = F.linear(x.to(dtype).float(), weight.to(dtype).float())
    return tp.reduce_out(partial).to(dtype) + bias.to(dtype)


class Dense(nn.Linear):
    """nn.Linear computed in `compute_dtype` (`dense`). The state-dict names
    are nn.Linear's."""

    def __init__(self, in_features, out_features, compute_dtype=torch.float32,
                 device=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return dense(x, self.weight, self.bias, self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm that computes in float32 and returns float32 whatever
    the input's dtype: flax's nn.LayerNorm over float32 parameters."""

    def __init__(self, dim, device=None):
        super().__init__(dim, eps=LN_EPS, device=device)

    def forward(self, x):
        return super().forward(x.float())


def softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis in x's dtype. In bfloat16 the
    shifted exponentials, their sum and the quotient are each rounded to
    bfloat16, as jnp rounds them; float32 takes torch.softmax."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(-1, keepdim=True).detach())
    return e / e.sum(-1, keepdim=True)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed (3D, D) in-proj with
    row blocks [q | k | v]), computed with only the rows each input needs."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.1,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.compute_dtype = compute_dtype
        # the logit scale rounded to the compute dtype, as jnp rounds a
        # weakly typed scalar
        self.scale = torch.tensor((d_model // nhead) ** -0.5, dtype=compute_dtype).item()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model, device=device))
        self.out_proj = Dense(d_model, d_model, compute_dtype, device=device)
        self.dropout = RowDropout(dropout)
        self.tp = None   # parallel/mesh.shard_model: this rank's heads only
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value,
                key_padding_mask: Optional[torch.Tensor] = None):
        """query (B, Lq, D), key/value (B, Lk, D), key_padding_mask (B, Lk)
        True = ignore. Self-attention (query is key) projects q and k in
        one matmul."""
        h, dt, tp = self.nhead, self.compute_dtype, self.tp
        if tp is not None:
            self_attn = query is key
            query, value = tp.copy_in(query), tp.copy_in(value)
            key = query if self_attn else tp.copy_in(key)
            h //= tp.size
        d = self.in_proj_weight.shape[0] // 3   # this rank's width
        w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        if query is key:
            q, k = dense(query, w[: 2 * d], bias[: 2 * d], dt).split(d, dim=-1)
        else:
            q = dense(query, w[:d], bias[:d], dt)
            k = dense(key, w[d : 2 * d], bias[d : 2 * d], dt)
        v = dense(value, w[2 * d :], bias[2 * d :], dt)

        def split(x):
            b, l, _ = x.shape
            return x.reshape(b, l, h, d // h).transpose(1, 2)  # (B, H, L, hd)

        q, k, v = split(q), split(k), split(v)
        logits = (q * self.scale) @ k.transpose(-1, -2)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        heads = None if tp is None else (1, self.nhead, tp.rank * h)
        weights = self.dropout(softmax(logits), heads)
        out = (weights @ v).transpose(1, 2)
        out = out.reshape(out.shape[0], out.shape[1], d)
        if tp is None:
            return self.out_proj(out)
        return row_parallel_dense(out, self.out_proj.weight, self.out_proj.bias, dt, tp)


class _FFNLayer(nn.Module):
    """The feed-forward block shared by both layer types: linear1, ReLU,
    dropout, linear2; under tensor parallelism (`tp`) on this rank's
    dim_feedforward/tp hidden units."""

    def _init_ffn(self, d_model, dim_feedforward, dropout, compute_dtype, device):
        self.dim_feedforward = dim_feedforward
        self.linear1 = Dense(d_model, dim_feedforward, compute_dtype, device)
        self.linear2 = Dense(dim_feedforward, d_model, compute_dtype, device)
        self.dropout = RowDropout(dropout)
        self.tp = None   # parallel/mesh.shard_model: this rank's hidden units only

    def _ffn(self, x):
        tp = self.tp
        if tp is None:
            return self.linear2(self.dropout(F.relu(self.linear1(x))))
        hidden = F.relu(self.linear1(tp.copy_in(x)))
        hidden = self.dropout(hidden, (2, self.dim_feedforward, tp.rank * hidden.shape[2]))
        return row_parallel_dense(hidden, self.linear2.weight, self.linear2.bias,
                                  self.linear2.compute_dtype, tp)


class EncoderLayer(_FFNLayer):
    """cone/transformer.py:211-268."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout, pre_norm=False,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = MultiheadAttention(d_model, nhead, dropout, compute_dtype, device)
        self._init_ffn(d_model, dim_feedforward, dropout, compute_dtype, device)
        self.norm1 = LayerNorm(d_model, device)
        self.norm2 = LayerNorm(d_model, device)

    def forward(self, src, key_padding_mask, pos):
        if self.pre_norm:
            src2 = self.norm1(src)
            qk = src2 + pos
            src = src + self.dropout(self.self_attn(qk, qk, src2, key_padding_mask))
            return src + self.dropout(self._ffn(self.norm2(src)))
        qk = src + pos
        src = self.norm1(src + self.dropout(self.self_attn(qk, qk, src, key_padding_mask)))
        return self.norm2(src + self.dropout(self._ffn(src)))


class DecoderLayer(_FFNLayer):
    """cone/transformer.py:271-353."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout, pre_norm=False,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = MultiheadAttention(d_model, nhead, dropout, compute_dtype, device)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout, compute_dtype,
                                                 device)
        self._init_ffn(d_model, dim_feedforward, dropout, compute_dtype, device)
        self.norm1 = LayerNorm(d_model, device)
        self.norm2 = LayerNorm(d_model, device)
        self.norm3 = LayerNorm(d_model, device)

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

    def __init__(self, layers, norm: Optional[LayerNorm]):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class DetrTransformer(nn.Module):
    """Encoder + decoder returning all intermediate decoder states
    (cone/transformer.py:18-73, return_intermediate_dec=True)."""

    def __init__(self, d_model=256, nhead=8, num_encoder_layers=2,
                 num_decoder_layers=2, dim_feedforward=1024, dropout=0.1,
                 pre_norm=False, compute_dtype=torch.float32, device=None):
        super().__init__()
        self.pre_norm = pre_norm
        self.encoder = _Stack(
            [EncoderLayer(d_model, nhead, dim_feedforward, dropout, pre_norm, compute_dtype,
                          device)
             for _ in range(num_encoder_layers)],
            LayerNorm(d_model, device) if pre_norm else None)
        self.decoder = _Stack(
            [DecoderLayer(d_model, nhead, dim_feedforward, dropout, pre_norm, compute_dtype,
                          device)
             for _ in range(num_decoder_layers)],
            LayerNorm(d_model, device))
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
