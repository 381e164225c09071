"""CONE-TAN: the 2D-TAN base model inside the CONE window machinery, as
torch nn.Modules (cone_tpu/models/tan.py; cone_2dtan/lib/models
cone_tan.py:11-119).

frame conv + pool -> sparse multi-scale 2D proposal map (start x end) ->
LSTM-encoded query fused by an L2-normalized Hadamard product -> stacked
mask-renormalized 2D convs -> 1-channel score map. The matching / adapter
branch is CONE's (the same residual-adapter mean-pool head).

Layout: channel-first inside, as the reference and cuDNN keep it ((B, C, L)
sequences, (B, C, S, E) maps); the public `forward` takes the JAX
package's (B, L, D) visual input and returns (scores (B, S, E),
map_mask (S, E)). Parameter names are the reference's CONE_TAN state-dict
names (frame_layer.vis_conv, fusion_layer.textual_encoder.weight_ih_l{i},
map_layer.convs.{i}, pred_layer, adapter_layer.layers.{i},
prop_layer.layers.{s}.{i}); every derived tensor (map mask, scatter indices,
count renormalization) is a non-persistent buffer built once per module.

The convolutions, the LSTM and the linears compute in full float32 on the
card: resolving a CUDA device (utils/device.resolve_device, which the
constructor and every entry point call) switches TF32 off, where cuDNN's
default would run the dominant 9x9 convs in it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cone_tpu_torch.config import TanConfig
from cone_tpu_torch.models.cone import MLP
from cone_tpu_torch.ops.pooling import (
    masked_segment_mean,
    matching_scores_pred,
    matching_sim_gt,
)
from cone_tpu_torch.utils.device import resolve_device
from cone_tpu_torch.utils.trace import span


def sparse_map_layout(num_clips: int, num_scale_layers: Sequence[int]):
    """Static bookkeeping of the multi-scale pooling cascade.

    Returns a list of per-(scale, layer) records:
        (scale_idx, layer_idx, kernel, stride, pool_ok, ori_s_idxs, ori_e_idxs)
    where ori_{s,e}_idxs are the (start, end) cells of the full
    (num_clips x num_clips) map this pooling stage fills
    (sparse.py:43-66 + recover_to_original_map :105-125).

    Degenerate geometries (small num_clips, deep scale stacks) follow the
    reference's try/except (sparse.py:28-31), which guards only the pool
    op: a stage whose pool succeeds still advances x even when its scatter
    range is empty (pool_ok=True, empty index lists), and a stage whose
    pool would fail (input shorter than the kernel) leaves x unchanged
    (pool_ok=False) but still scatters the stale x into any in-map cells.
    Stages where both the pool fails and the scatter is empty are dropped.
    """
    records = []
    length = num_clips
    acum_layers = 0
    stride = 1
    for scale_idx, num_layer in enumerate(num_scale_layers):
        layers = [(1, 1) if scale_idx == 0 else (3, 2)] + [(2, 1)] * (num_layer - 1)
        scale_len = length // layers[0][1]
        for i, (k, s) in enumerate(layers):
            pool_ok = length >= k  # torch raises on an empty pool output
            if pool_ok:
                length = (length - k) // s + 1
            stride = stride * s
            n = scale_len - i
            ori_s = list(range(0, num_clips - acum_layers - i * stride, stride))
            ori_e = [s_idx + acum_layers + i * stride for s_idx in ori_s]
            # the (possibly stale) sequence may be shorter than the scatter
            # range at the edge; trim to what exists
            n = max(0, min(n, length, len(ori_s)))
            if n > 0 or pool_ok:
                records.append((scale_idx, i, k, s, pool_ok, ori_s[:n], ori_e[:n]))
        acum_layers += stride * (len(layers) + 1)
    return records


def sparse_map_mask(num_clips: int, num_scale_layers: Sequence[int]) -> np.ndarray:
    mask = np.zeros((num_clips, num_clips), np.float32)
    for rec in sparse_map_layout(num_clips, num_scale_layers):
        mask[rec[5], rec[6]] = 1
    return mask


class _MapScatter(nn.Module):
    """Writes the cascade's stage outputs into the (start, end) map: one
    index assignment over the flattened map at static cells."""

    def __init__(self, num_clips: int, cells, device=None):
        super().__init__()
        self.num_clips = num_clips
        flat = [s * num_clips + e for s, e in cells]
        if len(set(flat)) != len(flat):
            raise ValueError("two stages of the cascade fill the same map cell")
        self.mask_np = np.zeros(num_clips * num_clips, np.float32)
        self.mask_np[flat] = 1.0
        self.mask_np = self.mask_np.reshape(num_clips, num_clips)
        self.register_buffer("cells", torch.tensor(flat, dtype=torch.long, device=device),
                             persistent=False)
        self.register_buffer("mask", torch.tensor(self.mask_np, device=device),
                             persistent=False)

    def forward(self, parts):
        vals = torch.cat(parts, dim=-1)                   # (B, C, cells)
        out = vals.new_zeros(*vals.shape[:-1], self.num_clips * self.num_clips)
        out[..., self.cells] = vals
        return out.view(*vals.shape[:-1], self.num_clips, self.num_clips)


class SparsePropMaxPool(nn.Module):
    """(B, C, L) -> ((B, C, L, L) sparse map, (L, L) static mask)
    (prop_modules/sparse.py:6-66)."""

    def __init__(self, num_clips: int, num_scale_layers: Sequence[int], device=None):
        super().__init__()
        layout = sparse_map_layout(num_clips, tuple(num_scale_layers))
        self._stages = [(k, s, ok, len(si)) for _, _, k, s, ok, si, _ in layout]
        self.scatter = _MapScatter(
            num_clips, [c for r in layout for c in zip(r[5], r[6])], device)

    def forward(self, x):
        parts = []
        for k, s, pool_ok, n in self._stages:
            if pool_ok and (k, s) != (1, 1):
                x = F.max_pool1d(x, k, s)
            if n:
                parts.append(x[..., :n])
        return self.scatter(parts), self.scatter.mask


class PropMaxPool(nn.Module):
    """Dense 2D proposal map: diagonal `dig` fills cell (s, s + dig)
    (prop_modules/dense.py:4-26)."""

    def __init__(self, num_clips: int, num_layers: int, device=None):
        super().__init__()
        self.num_layers = num_layers
        self._n = [max(num_clips - dig, 0) for dig in range(num_layers)]
        self.scatter = _MapScatter(
            num_clips, [(s, s + dig) for dig in range(num_layers)
                        for s in range(num_clips - dig)], device)

    def forward(self, x):
        parts = []
        for dig, n in enumerate(self._n):
            if dig > 0:
                x = F.max_pool1d(x, 2, 1)
            if n:
                parts.append(x[..., :n])
        return self.scatter(parts), self.scatter.mask


class SparsePropConv(nn.Module):
    """Conv variant of the sparse cascade (prop_modules/sparse.py:69-125):
    the same scatter layout, learned Conv1d stages `layers.{scale}.{layer}`
    instead of max pools. A stage the reference's try/except skips keeps
    its (unused) conv, as the reference module does."""

    def __init__(self, num_clips: int, num_scale_layers: Sequence[int], hidden_size: int,
                 device=None):
        super().__init__()
        layout = sparse_map_layout(num_clips, tuple(num_scale_layers))

        def conv(si, i):
            k, s = ((1, 1) if si == 0 else (3, 2)) if i == 0 else (2, 1)
            return nn.Conv1d(hidden_size, hidden_size, k, s, device=device)

        self.layers = nn.ModuleList(
            nn.ModuleList(conv(si, i) for i in range(num_layer))
            for si, num_layer in enumerate(num_scale_layers))
        self._stages = [(si, i, ok, len(s)) for si, i, _, _, ok, s, _ in layout]
        self.scatter = _MapScatter(
            num_clips, [c for r in layout for c in zip(r[5], r[6])], device)

    def forward(self, x):
        parts = []
        for si, i, pool_ok, n in self._stages:
            if pool_ok:
                x = self.layers[si][i](x)
            if n:
                parts.append(x[..., :n])
        return self.scatter(parts), self.scatter.mask


class FrameAvgPool(nn.Module):
    """1x1 conv + ReLU + average pool (frame_modules/frame_pool.py:4-19)."""

    def __init__(self, input_size: int, hidden_size: int, kernel: int = 1, stride: int = 1,
                 device=None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.vis_conv = nn.Conv1d(input_size, hidden_size, 1, 1, device=device)

    def forward(self, x):
        x = F.relu(self.vis_conv(x))
        if (self.kernel, self.stride) == (1, 1):
            return x
        return F.avg_pool1d(x, self.kernel, self.stride)


class FrameMaxPool(nn.Module):
    """1x1 conv + ReLU + max pool of kernel = stride
    (frame_modules/frame_pool.py:21-30)."""

    def __init__(self, input_size: int, hidden_size: int, stride: int = 1, device=None):
        super().__init__()
        self.stride = stride
        self.vis_conv = nn.Conv1d(input_size, hidden_size, 1, 1, device=device)

    def forward(self, x):
        x = F.relu(self.vis_conv(x))
        return x if self.stride == 1 else F.max_pool1d(x, self.stride, self.stride)


class LstmTextEncoder(nn.LSTM):
    """The stacked unidirectional LSTM of base_fusion.py:18-22, returning
    the output at the last valid token, max(sum(mask) - 1, 0); a query with
    no valid token gives zeros. One nn.LSTM, so its weights are the
    reference's weight_ih_l{i} / weight_hh_l{i} / bias_*_l{i}. (The JAX
    package masks each layer's output before the next layer; with prefix
    masks that changes no output at or before the last valid token.)"""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, device=None):
        super().__init__(input_size, hidden_size, num_layers=num_layers, batch_first=True,
                         device=device)

    def forward(self, tokens, mask):
        out, _ = super().forward(tokens)
        last = (mask.sum(-1).long() - 1).clamp(min=0)
        rows = torch.arange(out.shape[0], device=out.device)
        return out[rows, last] * mask[rows, last][:, None]


class BaseFusion(nn.Module):
    """The query's last LSTM state x the 1x1-conv'd map, L2-normalized over
    channels and masked (fusion_modules/base_fusion.py:6-26)."""

    def __init__(self, hidden_size: int, txt_input_size: int, txt_hidden_size: int,
                 lstm_layers: int, device=None):
        super().__init__()
        self.textual_encoder = LstmTextEncoder(txt_input_size, txt_hidden_size, lstm_layers,
                                               device=device)
        self.tex_linear = nn.Linear(txt_hidden_size, hidden_size, device=device)
        self.vis_conv = nn.Conv2d(hidden_size, hidden_size, 1, 1, device=device)

    def forward(self, tokens, tok_mask, map_h, map_mask):
        return self.fuse(self.encode_text(tokens, tok_mask), map_h, map_mask)

    def encode_text(self, tokens, tok_mask):
        """(B, Lq, Dt) tokens -> (B, H) query vectors: the LSTM's last valid
        output through tex_linear."""
        return self.tex_linear(self.textual_encoder(tokens, tok_mask))

    def fuse(self, txt, map_h, map_mask):
        """(B, H) query vectors x the 1x1-conv'd (B, H, S, E) map."""
        fused = txt[:, :, None, None] * self.vis_conv(map_h)
        # safe L2 normalize: a zero cell stays 0 and gets no NaN gradient
        # (rsqrt of 0 behind a where would still poison the backward)
        n2 = (fused * fused).sum(1, keepdim=True)
        pos = n2 > 0
        fused = torch.where(pos, fused * torch.rsqrt(torch.where(pos, n2, 1.0)), 0.0)
        return fused * map_mask


class MapConv(nn.Module):
    """Stacked mask-renormalized 2D convs (map_modules/map_conv.py:6-33):
    after conv i, each cell is divided by how many valid cells its kernel
    saw (map_modules/__init__.py:3-17), and cells that saw none are zeroed.
    The renormalization depends on the static map mask alone, so it is a
    buffer per conv."""

    def __init__(self, input_size: int, hidden_sizes, kernel_sizes, paddings, map_mask,
                 device=None):
        super().__init__()
        sizes = [input_size] + list(hidden_sizes)
        self.convs = nn.ModuleList(
            nn.Conv2d(sizes[i], sizes[i + 1], k, 1, p, device=device)
            for i, (k, p) in enumerate(zip(kernel_sizes, paddings)))
        m = torch.as_tensor(np.asarray(map_mask), dtype=torch.float64)[None, None]
        for i, (k, p) in enumerate(zip(kernel_sizes, paddings)):
            count = torch.round(F.conv2d(m, torch.ones(1, 1, k, k, dtype=torch.float64),
                                         padding=p))
            weight = torch.where(count > 0, 1.0 / torch.where(count > 0, count, 1.0), 0.0)
            self.register_buffer(f"weight_{i}", weight.float().to(device), persistent=False)
            m = (weight > 0).double()

    def forward(self, x):
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x)) * getattr(self, f"weight_{i}")
        return x


class ConeTanModel(nn.Module):
    """CONE_TAN: the 2D score-map head + the shared matching/adapter branch.

      forward             (scores (B, S, E), map_mask (S, E)) from tokens
                          (B, Lq, Dt), their mask (B, Lq) and the raw window
                          (B, num_clips * frame_stride, Dv); spans
                          `cone.tan.text` (the LSTM and tex_linear) and
                          `cone.tan.map` (frame pool to prediction)
      adapt               residual adapter on appearance features
      clip_matching_gt    GT-proposal matching logits (B, B)
      clip_matching_pred  (B, K) matching scores of integer proposals
    """

    def __init__(self, cfg: TanConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = c = cfg
        if c.frame_module == "max":
            self.frame_layer = FrameMaxPool(c.v_feat_dim, c.hidden_size, c.frame_stride,
                                            device=dev)
        else:
            self.frame_layer = FrameAvgPool(c.v_feat_dim, c.hidden_size, c.frame_kernel,
                                            c.frame_stride, device=dev)
        if c.prop_module == "sparse_conv":
            self.prop_layer = SparsePropConv(c.num_clips, c.num_scale_layers, c.hidden_size,
                                             device=dev)
        elif c.prop_module == "dense_pool":
            self.prop_layer = PropMaxPool(c.num_clips, c.dense_num_layers, device=dev)
        else:
            self.prop_layer = SparsePropMaxPool(c.num_clips, c.num_scale_layers, device=dev)
        self.fusion_layer = BaseFusion(c.hidden_size, c.t_feat_dim, c.txt_hidden_size,
                                       c.lstm_layers, device=dev)
        self.map_layer = MapConv(c.hidden_size, c.map_hidden_sizes, c.map_kernel_sizes,
                                 c.map_paddings, self.prop_layer.scatter.mask_np,
                                 device=dev)
        self.pred_layer = nn.Conv2d(c.map_hidden_sizes[-1], 1, 1, 1, device=dev)
        self.adapter_layer = (MLP(c.v_feat_dim, c.hidden_size, c.v_feat_dim, 2, device=dev)
                              if c.adapter_module == "linear" else None)

    @property
    def map_mask(self) -> torch.Tensor:
        return self.prop_layer.scatter.mask

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self.fusion_layer.textual_encoder.flatten_parameters()
        return out

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        out = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.fusion_layer.textual_encoder.flatten_parameters()
        return out

    def forward(self, tokens, tok_mask, visual_input):
        with span("tan.text"):
            txt = self.fusion_layer.encode_text(tokens, tok_mask)
        with span("tan.map"):
            vis_h = self.frame_layer(visual_input.transpose(1, 2))
            map_h, map_mask = self.prop_layer(vis_h)
            fused = self.fusion_layer.fuse(txt, map_h, map_mask)
            pred = self.pred_layer(self.map_layer(fused))[:, 0] * map_mask
        return pred, map_mask

    def adapt(self, feat):
        """Residual adapter: adapter(x) + x (cone_tan.py:88-92)."""
        if self.adapter_layer is None:
            return feat
        return self.adapter_layer(feat) + feat

    def clip_matching_gt(self, src_cls_txt, src_vid_appear, proposal_start, proposal_end):
        return matching_sim_gt(self.adapt, src_cls_txt, src_vid_appear,
                               proposal_start, proposal_end)

    def clip_matching_pred(self, src_cls_txt, src_vid_appear, proposal_start, proposal_end):
        """Integer proposal cells in clip units (B, K) -> (B, K) scores."""
        pooled = masked_segment_mean(src_vid_appear, proposal_start, proposal_end)
        return matching_scores_pred(self.adapt, src_cls_txt, pooled)


def bce_rescale_loss(scores, map_mask, targets, min_iou: float = 0.3,
                     max_iou: float = 0.7, bias: float = 0.5):
    """Scaled-IoU BCE over the valid map cells (loss.py:5-44).

    scores (B, S, E) raw logits; targets (B, S, E) IoU values in [0, 1].
    Returns (loss, joint_prob)."""
    joint_prob = torch.sigmoid(scores) * map_mask
    target_prob = (targets - min_iou) * (1 - bias) / (max_iou - min_iou)
    target_prob = torch.where(target_prob > 0, target_prob + bias, target_prob)
    target_prob = target_prob.clamp(0.0, 1.0)
    eps = 1e-12
    bce = -(target_prob * torch.log(joint_prob.clamp(eps, 1.0))
            + (1 - target_prob) * torch.log((1 - joint_prob).clamp(eps, 1.0)))
    bce = bce * map_mask
    return bce.sum() / (map_mask.sum() * scores.shape[0]), joint_prob


def iou_target_map(num_clips: int, start_pos: float, end_pos: float) -> np.ndarray:
    """IoU (hull-union convention, lib/core/eval.py:9-27) of every map cell
    [s, e+1] vs the window-local GT span (lib/datasets/ego4d.py:133-141)."""
    s = np.arange(num_clips, dtype=np.float64)[:, None]
    e = np.arange(1, num_clips + 1, dtype=np.float64)[None, :]
    inter = np.maximum(0.0, np.minimum(e, end_pos) - np.maximum(s, start_pos))
    union = np.maximum(0.0, np.maximum(e, end_pos) - np.minimum(s, start_pos))
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union > 0, inter / union, 0.0)
    return out.astype(np.float32)
