"""EgoVLP video tower: the Frozen-in-Time space-time ViT as torch modules,
the port's counterpart of cone_tpu/models/egovlp.py.

run_on_video/egovlp/video_transformer.py (SpaceTimeTransformer) plus the
FrozenInTime video head (run_on_video/egovlp/model.py:63-78, compute_video
:183-186): a ViT-B/16 whose blocks run divided attention, temporal
(each patch position attends across frames) then spatial (each frame's
patches attend within the frame), with the CLS token attending to every
token in both, then a linear projection to the 256-d clip feature the
grounding stack consumes.

Parameter names are the reference's (`video_model.patch_embed.proj.*`,
`video_model.{cls_token,pos_embed,temporal_embed}`,
`video_model.blocks.{i}.{norm1,norm2,norm3,attn,timeattn,mlp}.*`,
`video_model.norm.*`, `vid_proj.*`); convert.load_egovlp_state_dict reads a
released checkpoint into them. Input is (B, F, 3, H, W).

Divided attention is computed as regrouped batched matmuls: the patch
tokens are grouped (by frame for the spatial kind, by patch position for
the temporal kind), each group's keys and values are its own tokens plus
the CLS key and value, and one batched product per step covers every
group. cone_tpu computes the tower in XLA, not Pallas: no hand kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cone_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class EgoVlpConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_frames: int = 4
    projection_dim: int = 256


class VarAttention(nn.Module):
    """Divided attention over one axis, CLS attending to all
    (video_transformer.py:80-137). Tokens are [CLS, (f, n) frame-major
    patches]. `over_time=False` groups by frame (spatial attention over a
    frame's n patches); `over_time=True` groups by patch position
    (temporal attention over the f frames at a position)."""

    def __init__(self, dim: int, num_heads: int, over_time: bool, device=None):
        super().__init__()
        self.num_heads, self.over_time = num_heads, over_time
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, f: int, n: int) -> torch.Tensor:
        b, tokens, d = x.shape
        h = self.num_heads
        hd = d // h
        q, k, v = (self.qkv(x).reshape(b, tokens, 3, h, hd)
                   .permute(2, 0, 3, 1, 4).unbind(0))            # (B, H, T, hd) each
        q = q * hd ** -0.5

        # CLS attends to everything, itself included
        cls_out = torch.softmax(q[:, :, :1] @ k.transpose(-1, -2), dim=-1) @ v

        def groups(t):   # (B, H, f*n, hd) -> (B, H, groups, seq, hd)
            t = t.reshape(b, h, f, n, hd)
            return t.transpose(2, 3) if self.over_time else t

        qg, kg, vg = groups(q[:, :, 1:]), groups(k[:, :, 1:]), groups(v[:, :, 1:])
        g = qg.shape[2]
        kg = torch.cat([k[:, :, None, :1].expand(b, h, g, 1, hd), kg], dim=3)
        vg = torch.cat([v[:, :, None, :1].expand(b, h, g, 1, hd), vg], dim=3)
        out = torch.softmax(qg @ kg.transpose(-1, -2), dim=-1) @ vg   # (B, H, g, seq, hd)
        if self.over_time:
            out = out.transpose(2, 3)
        out = torch.cat([cls_out, out.reshape(b, h, f * n, hd)], dim=2)
        return self.proj(out.transpose(1, 2).reshape(b, tokens, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))   # exact (erf) GELU


class SpaceTimeBlock(nn.Module):
    """timeattn(norm3) -> time residual -> spatial attn(norm1) of the time
    residual, added to the ORIGINAL x (frozen-in-time style,
    video_transformer.py:163-177) -> MLP(norm2)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = VarAttention(dim, num_heads, over_time=False, device=device)
        self.timeattn = VarAttention(dim, num_heads, over_time=True, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS, device=device)

    def forward(self, x, f: int, n: int):
        time_residual = x + self.timeattn(self.norm3(x), f, n)
        space_residual = x + self.attn(self.norm1(time_residual), f, n)
        return space_residual + self.mlp(self.norm2(space_residual))


class _PatchEmbed(nn.Module):
    def __init__(self, c: EgoVlpConfig, device=None):
        super().__init__()
        self.proj = nn.Conv2d(3, c.embed_dim, c.patch_size, stride=c.patch_size, device=device)


class SpaceTimeTransformer(nn.Module):
    """(B, F, 3, H, W) frames -> (B, embed_dim) CLS feature."""

    def __init__(self, cfg: EgoVlpConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        n = (c.img_size // c.patch_size) ** 2
        self.patch_embed = _PatchEmbed(c, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.embed_dim, device=device))
        self.pos_embed = nn.Parameter(torch.randn(1, n + 1, c.embed_dim, device=device) * 0.02)
        self.temporal_embed = nn.Parameter(torch.zeros(1, c.num_frames, c.embed_dim,
                                                       device=device))
        self.blocks = nn.ModuleList(SpaceTimeBlock(c.embed_dim, c.num_heads, c.mlp_ratio, device)
                                    for _ in range(c.depth))
        self.norm = nn.LayerNorm(c.embed_dim, eps=LN_EPS, device=device)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        b, f = frames.shape[:2]
        x = self.patch_embed.proj(frames.flatten(0, 1))        # (B*F, D, h, w)
        n = x.shape[2] * x.shape[3]
        x = x.flatten(2).transpose(1, 2).reshape(b, f * n, -1)
        x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)
        # spatial pos tiled per frame, temporal embed repeated within a frame
        # (video_transformer.py:311-320)
        tile_pos = self.pos_embed[:, 1:].repeat(1, self.cfg.num_frames, 1)
        tile_time = self.temporal_embed.repeat_interleave(n, dim=1)
        total = torch.cat([self.pos_embed[:, :1], tile_pos + tile_time], dim=1)
        x = x + total[:, : x.shape[1]]
        for blk in self.blocks:
            x = blk(x, f, n)
        return self.norm(x)[:, 0]


class EgoVlpVideoTower(nn.Module):
    """SpaceTimeTransformer + the FrozenInTime 'minimal' video projection
    (model.py:69-71): clips of frames -> 256-d clip features."""

    def __init__(self, cfg: EgoVlpConfig = EgoVlpConfig(), device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.video_model = SpaceTimeTransformer(cfg, dev)
        self.vid_proj = nn.Linear(cfg.embed_dim, cfg.projection_dim, device=dev)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return self.vid_proj(self.video_model(frames))


def inflate_temporal_embed(embed: np.ndarray, num_frames: int,
                           load_temporal_fix: str = "zeros") -> np.ndarray:
    """Reconcile a checkpoint temporal_embed (1, F_ckpt, D) with a tower of
    `num_frames`, as the reference's `_inflate_positional_embeds`
    (run_on_video/egovlp/model.py:137-169):

    - more frames in the checkpoint -> the first `num_frames`;
    - fewer + 'zeros' (the reference default, model.py:15) -> the loaded
      rows, the rest zero;
    - fewer + 'bilinear' -> F.interpolate(mode='bilinear',
      align_corners=True): the embed axis keeps its size, so it is linear
      interpolation along frames at positions i*(F_ckpt-1)/(F_new-1);
    - fewer + 'interp' -> ValueError: the reference passes
      align_corners=True with mode='nearest', which torch rejects.
    """
    f_ckpt = embed.shape[1]
    if f_ckpt == num_frames:
        return embed
    if f_ckpt > num_frames:
        return embed[:, :num_frames].copy()
    if load_temporal_fix == "zeros":
        out = np.zeros((embed.shape[0], num_frames, embed.shape[2]), dtype=embed.dtype)
        out[:, :f_ckpt] = embed
        return out
    if load_temporal_fix == "bilinear":
        if f_ckpt == 1:
            return np.broadcast_to(embed, (embed.shape[0], num_frames, embed.shape[2])).copy()
        src = np.arange(num_frames) * (f_ckpt - 1) / (num_frames - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, f_ckpt - 1)
        frac = (src - lo).astype(np.float32)[None, :, None]
        return (embed[:, lo] * (1.0 - frac) + embed[:, hi] * frac).astype(embed.dtype)
    if load_temporal_fix == "interp":
        raise ValueError(
            "load_temporal_fix='interp' maps to torch mode='nearest' with "
            "align_corners=True, which torch rejects (the reference path is "
            "unloadable); use 'zeros' or 'bilinear'")
    raise NotImplementedError(f"load_temporal_fix={load_temporal_fix!r}")
