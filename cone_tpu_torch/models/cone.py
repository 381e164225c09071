"""The CONE grounding model (cone/model.py:16-210) as a torch nn.Module.

A Moment-DETR-style encoder-decoder over the [video ; text] token sequence
with learnable moment queries, plus the appearance-branch residual adapter
and the proposal <-> query matching head. The batch is (windows x queries)
flattened: windows are rows. Parameter names are the reference's
state-dict names, so `load_state_dict` takes a reference checkpoint or a
golden fixture's `w::` tensors as they are.

model.compute_dtype is applied as cone_tpu applies it (models/transformer.py):
every Dense runs in it, every LayerNorm and the sine and text position
embeddings in float32; the span sigmoid runs in the compute dtype, before
the outputs are cast to float32. Parameters stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cone_tpu_torch.config import ModelConfig
from cone_tpu_torch.models.dropout import RowDropout
from cone_tpu_torch.models.transformer import Dense, DetrTransformer, LayerNorm
from cone_tpu_torch.ops.pooling import (
    matching_scores_pred,
    matching_sim_gt,
    proposal_mean_pool,
)
from cone_tpu_torch.utils.device import resolve_device


def sine_position_embedding(mask: torch.Tensor, num_pos_feats: int,
                            temperature: float = 10000.0) -> torch.Tensor:
    """1-D sine embedding from a (B, L) validity mask, normalized to 2*pi
    (cone/position_encoding.py:35-72). The position is cumsum(mask), so
    padded slots repeat the last valid position. Returns (B, L, F) with sin
    of the even features and cos of the odd ones interleaved."""
    x_embed = mask.float().cumsum(1)
    x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    return torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()],
                       dim=3).flatten(2)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid in x's dtype: in bfloat16 XLA's 1 / (1 + exp(-x)),
    each step rounded to bfloat16; float32 takes torch.sigmoid."""
    if x.dtype == torch.float32:
        return x.sigmoid()
    return 1 / (1 + torch.exp(-x))


class LinearLayer(nn.Module):
    """[LayerNorm ->] Dropout -> Linear [-> ReLU] (cone/model.py:443-465);
    `net` = (RowDropout, Linear), hence the reference's `net.1` names."""

    def __init__(self, in_dim, out_dim, layer_norm=True, dropout=0.1, relu=True,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.relu = relu
        self.LayerNorm = LayerNorm(in_dim, device) if layer_norm else None
        self.net = nn.Sequential(RowDropout(dropout),
                                 Dense(in_dim, out_dim, compute_dtype, device))

    def forward(self, x):
        if self.LayerNorm is not None:
            x = self.LayerNorm(x)
        x = self.net(x)
        return F.relu(x) if self.relu else x


class MLP(nn.Module):
    """Plain ReLU MLP (cone/model.py:428-440)."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Dense(i, o, compute_dtype, device) for i, o in zip(dims, outs))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class TrainableTextPos(nn.Module):
    """Learned text position embedding (cone/position_encoding.py:10-32)."""

    def __init__(self, max_len, hidden, dropout, device=None):
        super().__init__()
        self.position_embeddings = nn.Embedding(max_len, hidden, device=device)
        self.LayerNorm = LayerNorm(hidden, device)
        self.dropout = RowDropout(dropout)

    def forward(self, x):
        table = self.position_embeddings.weight[: x.shape[1]]
        return self.dropout(self.LayerNorm(x + table[None]))


class ConeModel(nn.Module):
    """CONE: span prediction + saliency + proposal-query matching.

      forward             Moment-DETR forward over one window batch
                          (cone/model.py:82-128)
      clip_matching_gt    GT-proposal matching logits (cone/model.py:130-148)
      clip_matching_pred  predicted-proposal matching scores at inference
                          (cone/model.py:149-152, 178-210)
      adapt               residual adapter on appearance features, used by
                          the coarse stage (cone/inference.py:254-258)

    `txt_position_embed` always exists, as in the reference model, and is
    used only with cfg.use_txt_pos. model.seq_pad_multiple, a layout pad of
    the JAX package that changes no valid output, is not applied here.
    model.compute_dtype "float32" or "bfloat16" (module docstring).
    """

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        c = cfg
        dt = getattr(torch, c.compute_dtype)
        relu_args = [True, True, True]
        relu_args[c.n_input_proj - 1] = False

        def proj(in_dim):
            return nn.Sequential(*[
                LinearLayer(in_dim if i == 0 else c.hidden_dim, c.hidden_dim,
                            layer_norm=True, dropout=c.input_dropout,
                            relu=relu_args[i], compute_dtype=dt, device=dev)
                for i in range(c.n_input_proj)])

        self.input_txt_proj = proj(c.t_feat_dim)
        self.input_vid_proj = proj(c.v_motion_feat_dim)
        self.transformer = DetrTransformer(
            c.hidden_dim, c.nheads, c.enc_layers, c.dec_layers,
            c.dim_feedforward, c.dropout, c.pre_norm, dt, device=dev)
        self.query_embed = nn.Embedding(c.num_queries, c.hidden_dim, device=dev)
        self.span_embed = MLP(c.hidden_dim, c.hidden_dim, 2, 3, dt, device=dev)
        self.class_embed = Dense(c.hidden_dim, 2, dt, device=dev)
        self.saliency_proj = Dense(c.hidden_dim, 1, dt, device=dev)
        self.txt_position_embed = TrainableTextPos(
            c.max_q_l, c.hidden_dim, c.input_dropout, device=dev)
        self.adapter_layer = (
            MLP(c.v_appear_feat_dim, c.hidden_dim, c.v_appear_feat_dim, 2, dt, device=dev)
            if c.adapter_module == "linear" else None)

    def forward(self, src_txt, src_txt_mask, src_vid_motion, src_vid_motion_mask):
        """src_txt (B, Lq, Dt), src_txt_mask (B, Lq) 1 = valid,
        src_vid_motion (B, Lv, Dv), src_vid_motion_mask (B, Lv).

        Returns dict: pred_logits (B, NQ, 2), pred_spans (B, NQ, 2) sigmoid
        cxw, saliency_scores (B, Lv), aux_outputs: [{pred_logits,
        pred_spans}] per earlier decoder layer; all float32."""
        c = self.cfg
        vid = self.input_vid_proj(src_vid_motion)
        txt = self.input_txt_proj(src_txt)
        src = torch.cat([vid, txt], dim=1)
        mask = torch.cat([src_vid_motion_mask, src_txt_mask], dim=1)
        pos_vid = sine_position_embedding(src_vid_motion_mask, c.hidden_dim)
        pos_txt = self.txt_position_embed(txt) if c.use_txt_pos else torch.zeros_like(txt)
        pos = torch.cat([pos_vid, pos_txt], dim=1)

        hs, memory = self.transformer(src, mask, self.query_embed.weight, pos)
        outputs_class = self.class_embed(hs).float()
        outputs_coord = self.span_embed(hs)
        if c.span_loss_type == "l1":
            outputs_coord = sigmoid(outputs_coord)   # in the compute dtype
        outputs_coord = outputs_coord.float()
        vid_mem = memory[:, : src_vid_motion.shape[1]]
        return {
            "pred_logits": outputs_class[-1],
            "pred_spans": outputs_coord[-1],
            "saliency_scores": self.saliency_proj(vid_mem)[..., 0].float(),
            "aux_outputs": [{"pred_logits": a, "pred_spans": b}
                            for a, b in zip(outputs_class[:-1], outputs_coord[:-1])],
        }

    def adapt(self, feat):
        """Residual adapter: adapter(x) + x (cone/model.py:171-174)."""
        if self.adapter_layer is None:
            return feat
        return self.adapter_layer(feat) + feat

    def clip_matching_gt(self, src_cls_txt, src_vid_appear, proposal_start,
                         proposal_end):
        """(B, B) logits_per_video between GT-proposal features and text CLS."""
        return matching_sim_gt(self.adapt, src_cls_txt, src_vid_appear,
                               proposal_start, proposal_end)

    def clip_matching_pred(self, src_cls_txt, src_vid_appear, src_vid_appear_mask,
                           pred_spans_cxw):
        """(B, NQ) cosine similarity per predicted proposal."""
        pooled = proposal_mean_pool(src_vid_appear, src_vid_appear_mask, pred_spans_cxw)
        return matching_scores_pred(self.adapt, src_cls_txt, pooled)
