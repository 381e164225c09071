"""CLIP towers (vision and text) as torch modules, the port's counterpart of
cone_tpu/models/clip.py: the reference's vendored OpenAI CLIP
(feature_extraction/clip/model.py: `encode_image` :336-337, `encode_text`
:339-352) in the HuggingFace weight layout.

Parameter names are HF's, as in the released weights
(`vision_model.embeddings.patch_embedding.weight`,
`vision_model.pre_layrnorm.*` in HF's spelling,
`...encoder.layers.{i}.self_attn.{q,k,v,out}_proj.*`, `...mlp.fc{1,2}.*`,
`visual_projection.weight`, `text_model.*`, `text_projection.weight`), so

    tower.load_state_dict(hf_model.state_dict())

loads a `CLIPVisionModelWithProjection` / `CLIPTextModelWithProjection`
checkpoint with no converter. Pixels are NCHW, HF's layout.

Feature semantics match the reference:
  * image feature  = visual_projection(post_layernorm(CLS))
  * token features = final_layer_norm(hidden states), applied once
                     (clip/model.py:346, `ln_final` exactly once)
  * text cls (EOT) = text_projection(token features at the EOT position)

Attention is an explicit matmul + softmax, masked with the dtype's
finfo.min (causal for text, plus an optional key-valid mask), like the
rest of the port's models. cone_tpu computes these towers in XLA, not in
Pallas, so there is no hand kernel here: the large products are
torch.matmul / F.linear.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from cone_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation (HF `hidden_act="quick_gelu"`)."""
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    """Multi-head self-attention in HF's CLIPAttention layout (separate
    q/k/v/out projections, the scale on q)."""

    def __init__(self, dim: int, num_heads: int, causal: bool = False, device=None):
        super().__init__()
        self.dim, self.num_heads, self.causal = dim, num_heads, causal
        self.q_proj = nn.Linear(dim, dim, device=device)
        self.k_proj = nn.Linear(dim, dim, device=device)
        self.v_proj = nn.Linear(dim, dim, device=device)
        self.out_proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, L, D); valid (B, L) True = a real token (key-side mask)."""
        b, l, d = x.shape
        h = self.num_heads
        hd = d // h

        def heads(t):
            return t.reshape(b, l, h, hd).transpose(1, 2)   # (B, H, L, hd)

        q = heads(self.q_proj(x)) * hd ** -0.5
        k, v = heads(self.k_proj(x)), heads(self.v_proj(x))
        sim = q @ k.transpose(-1, -2)
        neg = torch.finfo(sim.dtype).min
        if self.causal:
            upper = torch.ones(l, l, dtype=torch.bool, device=x.device).triu(1)
            sim = sim.masked_fill(upper, neg)
        if valid is not None:
            sim = sim.masked_fill(~valid.bool()[:, None, None, :], neg)
        out = torch.softmax(sim, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, l, d))


class ClipMlp(nn.Module):
    def __init__(self, dim: int, intermediate: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, intermediate, device=device)
        self.fc2 = nn.Linear(intermediate, dim, device=device)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class ClipEncoderLayer(nn.Module):
    """Pre-LN block: x + attn(LN1(x)); x + mlp(LN2(x)) with quick_gelu."""

    def __init__(self, dim, num_heads, intermediate, eps, causal=False, device=None):
        super().__init__()
        self.self_attn = ClipAttention(dim, num_heads, causal, device=device)
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps, device=device)
        self.mlp = ClipMlp(dim, intermediate, device=device)
        self.layer_norm2 = nn.LayerNorm(dim, eps=eps, device=device)

    def forward(self, x, valid=None):
        x = x + self.self_attn(self.layer_norm1(x), valid)
        return x + self.mlp(self.layer_norm2(x))


class ClipEncoder(nn.Module):
    """`layers`: HF's CLIPEncoder container, kept for its state-dict names."""

    def __init__(self, dim, num_heads, intermediate, eps, num_layers, causal, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            ClipEncoderLayer(dim, num_heads, intermediate, eps, causal, device)
            for _ in range(num_layers))

    def forward(self, x, valid=None):
        for layer in self.layers:
            x = layer(x, valid)
        return x


class _VisionEmbeddings(nn.Module):
    def __init__(self, c: ClipVisionConfig, device=None):
        super().__init__()
        n = (c.image_size // c.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.randn(c.hidden_size, device=device) * 0.02)
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size,
                                         bias=False, device=device)
        self.position_embedding = nn.Embedding(n + 1, c.hidden_size, device=device)

    def forward(self, pixels):
        x = self.patch_embedding(pixels).flatten(2).transpose(1, 2)   # (B, n, D)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class _VisionTransformer(nn.Module):
    def __init__(self, c: ClipVisionConfig, device=None):
        super().__init__()
        self.embeddings = _VisionEmbeddings(c, device)
        self.pre_layrnorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, device=device)
        self.encoder = ClipEncoder(c.hidden_size, c.num_heads, c.intermediate_size,
                                   c.layer_norm_eps, c.num_layers, False, device)
        self.post_layernorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, device=device)


class ClipVisionTower(nn.Module):
    """(B, 3, H, W) preprocessed pixels -> (B, projection_dim) image
    features (the reference's `encode_image`, clip/model.py:336-337)."""

    def __init__(self, cfg: ClipVisionConfig = ClipVisionConfig(), device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg, dev)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False,
                                           device=dev)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        x = vm.encoder(vm.pre_layrnorm(vm.embeddings(pixels)))
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


class _TextEmbeddings(nn.Module):
    def __init__(self, c: ClipTextConfig, device=None):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size, device=device)
        self.position_embedding = nn.Embedding(c.context_length, c.hidden_size, device=device)

    def forward(self, ids):
        return self.token_embedding(ids) + self.position_embedding.weight[None, : ids.shape[1]]


class _TextTransformer(nn.Module):
    def __init__(self, c: ClipTextConfig, device=None):
        super().__init__()
        self.embeddings = _TextEmbeddings(c, device)
        self.encoder = ClipEncoder(c.hidden_size, c.num_heads, c.intermediate_size,
                                   c.layer_norm_eps, c.num_layers, True, device)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, device=device)


class ClipTextTower(nn.Module):
    """(B, L) token ids + (B,) EOT positions [+ (B, L) validity] ->
    (token features (B, L, D), projected EOT cls (B, projection_dim)).

    Token features are `final_layer_norm` hidden states, applied once like
    the reference's `ln_final` (clip/model.py:346); the EOT feature goes
    through `text_projection` (:350)."""

    def __init__(self, cfg: ClipTextConfig = ClipTextConfig(), device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg, dev)
        self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False,
                                         device=dev)

    def forward(self, ids: torch.Tensor, eot_idx: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        tm = self.text_model
        x = tm.final_layer_norm(tm.encoder(tm.embeddings(ids), valid))
        eot = x[torch.arange(len(x), device=x.device), eot_idx.long()]
        return x, self.text_projection(eot)


def _check_act(hf_cfg):
    act = getattr(hf_cfg, "hidden_act", "quick_gelu")
    if act != "quick_gelu":
        raise NotImplementedError(f"hidden_act={act!r}: the towers compute quick_gelu (CLIP's)")


def vision_config_from_hf(hf_cfg) -> ClipVisionConfig:
    """A transformers CLIPVisionConfig (or a CLIPConfig's vision_config)."""
    _check_act(hf_cfg)
    return ClipVisionConfig(
        image_size=hf_cfg.image_size, patch_size=hf_cfg.patch_size,
        hidden_size=hf_cfg.hidden_size, num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads, intermediate_size=hf_cfg.intermediate_size,
        projection_dim=hf_cfg.projection_dim, layer_norm_eps=hf_cfg.layer_norm_eps)


def text_config_from_hf(hf_cfg) -> ClipTextConfig:
    """A transformers CLIPTextConfig (or a CLIPConfig's text_config)."""
    _check_act(hf_cfg)
    return ClipTextConfig(
        vocab_size=hf_cfg.vocab_size, context_length=hf_cfg.max_position_embeddings,
        hidden_size=hf_cfg.hidden_size, num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads, intermediate_size=hf_cfg.intermediate_size,
        projection_dim=hf_cfg.projection_dim, layer_norm_eps=hf_cfg.layer_norm_eps)


def as_vision_tower(model, device) -> ClipVisionTower:
    """A ClipVisionTower on `device` in eval mode: `model` itself, or one
    built from a transformers CLIPVisionModelWithProjection's config and
    weights."""
    if not isinstance(model, ClipVisionTower):
        tower = ClipVisionTower(vision_config_from_hf(model.config), device="meta")
        tower.load_state_dict(model.state_dict(), assign=True)
        model = tower
    return model.to(resolve_device(device)).eval()


def as_text_tower(model, device) -> ClipTextTower:
    """A ClipTextTower on `device` in eval mode: `model` itself, or one
    built from a transformers CLIPTextModelWithProjection's config and
    weights."""
    if not isinstance(model, ClipTextTower):
        tower = ClipTextTower(text_config_from_hf(model.config), device="meta")
        tower.load_state_dict(model.state_dict(), assign=True)
        model = tower
    return model.to(resolve_device(device)).eval()
