"""Weights across packages: the JAX package's flax param tree <-> the
reference's torch state-dict names that the port's modules use.

The mapping is purely structural: dense kernels transpose ((in, out) <->
torch's (out, in)), LayerNorm scale <-> weight, and attention in-projections
stay packed ((D, 3D) kernel <-> (3D, D) in_proj_weight).

    params_from_jax(params_np, model_cfg) -> state_dict (torch tensors)
    params_to_jax(state_dict, model_cfg)  -> params (numpy tree)
    load_reference_state_dict(sd)         -> state_dict (torch tensors)
    random_reference_state_dict(cfg, seed) -> numpy state dict

and the same for the 2D-TAN family (models/tan.py, the reference's
CONE_TAN names): tan_params_from_jax, tan_params_to_jax,
load_reference_tan_state_dict, random_reference_tan_state_dict. Conv
kernels transpose between flax's (k..., in, out) and torch's
(out, in, k...); the LSTM maps as tools/convert_tan_ckpt.py:72-84 does.

The feature towers (models/clip.py, models/egovlp.py):
clip_vision_params_from_jax, clip_text_params_from_jax,
egovlp_params_from_jax (cone_tpu trees -> the port's state dicts; the
patch convs' HWIO kernels become OIHW); read_egovlp_checkpoint,
egovlp_state_dict and load_egovlp_state_dict (a released EgoVLP
checkpoint -> the tower's state dict); random_clip_vision_state_dict,
random_clip_text_state_dict, random_egovlp_state_dict.
"""

from __future__ import annotations

import numpy as np
import torch

from cone_tpu_torch.config import ModelConfig, TanConfig


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _dense(out, name, p):
    out[f"{name}.weight"] = _np(p["kernel"]).T
    out[f"{name}.bias"] = _np(p["bias"])


def _ln(out, name, p):
    out[f"{name}.weight"] = _np(p["scale"])
    out[f"{name}.bias"] = _np(p["bias"])


def _attn(out, name, p):
    out[f"{name}.in_proj_weight"] = _np(p["in_proj"]["kernel"]).T
    out[f"{name}.in_proj_bias"] = _np(p["in_proj"]["bias"])
    _dense(out, f"{name}.out_proj", p["out_proj"])


def _layer(out, name, p):
    _attn(out, f"{name}.self_attn", p["self_attn"])
    _dense(out, f"{name}.linear1", p["ffn"]["linear1"])
    _dense(out, f"{name}.linear2", p["ffn"]["linear2"])
    _ln(out, f"{name}.norm1", p["norm1"])
    _ln(out, f"{name}.norm2", p["norm2"])
    if "multihead_attn" in p:
        _attn(out, f"{name}.multihead_attn", p["multihead_attn"])
        _ln(out, f"{name}.norm3", p["norm3"])


def _mlp(out, name, p):
    for key, layer in p.items():
        _dense(out, f"{name}.layers.{key.split('_')[1]}", layer)


def params_from_jax(params, cfg: ModelConfig) -> dict:
    """JAX ConeModel param tree (numpy or jax arrays) -> the port's state
    dict of float32 torch tensors, loadable with a strict load_state_dict.
    With use_txt_pos=False the tree has no text position embedding; the
    port's model owns one all the same (as the reference does), so it gets
    torch's fresh-init values: zero table, unit LayerNorm."""
    out: dict = {}
    for i in range(cfg.n_input_proj):
        for branch in ("input_txt_proj", "input_vid_proj"):
            p = params[f"{branch}_{i}"]
            _dense(out, f"{branch}.{i}.net.1", p["linear"])
            _ln(out, f"{branch}.{i}.LayerNorm", p["LayerNorm"])
    tr = params["transformer"]
    for i in range(cfg.enc_layers):
        _layer(out, f"transformer.encoder.layers.{i}", tr[f"encoder_layer_{i}"])
    if "encoder_norm" in tr:
        _ln(out, "transformer.encoder.norm", tr["encoder_norm"])
    for i in range(cfg.dec_layers):
        _layer(out, f"transformer.decoder.layers.{i}", tr[f"decoder_layer_{i}"])
    _ln(out, "transformer.decoder.norm", tr["decoder_norm"])
    out["query_embed.weight"] = _np(params["query_embed"])
    _mlp(out, "span_embed", params["span_embed"])
    _dense(out, "class_embed", params["class_embed"])
    _dense(out, "saliency_proj", params["saliency_proj"])
    if cfg.adapter_module == "linear":
        _mlp(out, "adapter_layer", params["adapter_layer"])
    if "txt_position_embed" in params:
        tp = params["txt_position_embed"]
        out["txt_position_embed.position_embeddings.weight"] = _np(tp["position_embeddings"])
        _ln(out, "txt_position_embed.LayerNorm", tp["LayerNorm"])
    else:
        out["txt_position_embed.position_embeddings.weight"] = np.zeros(
            (cfg.max_q_l, cfg.hidden_dim), np.float32)
        out["txt_position_embed.LayerNorm.weight"] = np.ones(cfg.hidden_dim, np.float32)
        out["txt_position_embed.LayerNorm.bias"] = np.zeros(cfg.hidden_dim, np.float32)
    return load_reference_state_dict(out)


def _inv_dense(sd, name):
    return {"kernel": sd[f"{name}.weight"].T.copy(), "bias": sd[f"{name}.bias"].copy()}


def _inv_ln(sd, name):
    return {"scale": sd[f"{name}.weight"].copy(), "bias": sd[f"{name}.bias"].copy()}


def _inv_attn(sd, name):
    return {"in_proj": {"kernel": sd[f"{name}.in_proj_weight"].T.copy(),
                        "bias": sd[f"{name}.in_proj_bias"].copy()},
            "out_proj": _inv_dense(sd, f"{name}.out_proj")}


def _inv_layer(sd, name, decoder):
    p = {"self_attn": _inv_attn(sd, f"{name}.self_attn"),
         "ffn": {"linear1": _inv_dense(sd, f"{name}.linear1"),
                 "linear2": _inv_dense(sd, f"{name}.linear2")},
         "norm1": _inv_ln(sd, f"{name}.norm1"),
         "norm2": _inv_ln(sd, f"{name}.norm2")}
    if decoder:
        p["multihead_attn"] = _inv_attn(sd, f"{name}.multihead_attn")
        p["norm3"] = _inv_ln(sd, f"{name}.norm3")
    return p


def params_to_jax(state_dict, cfg: ModelConfig) -> dict:
    """The inverse of params_from_jax: the port's (or a reference) state
    dict -> the JAX ConeModel param tree of numpy arrays."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in state_dict.items()}
    params = {}
    for i in range(cfg.n_input_proj):
        for branch in ("input_txt_proj", "input_vid_proj"):
            params[f"{branch}_{i}"] = {
                "linear": _inv_dense(sd, f"{branch}.{i}.net.1"),
                "LayerNorm": _inv_ln(sd, f"{branch}.{i}.LayerNorm")}
    tr = {f"encoder_layer_{i}": _inv_layer(sd, f"transformer.encoder.layers.{i}", False)
          for i in range(cfg.enc_layers)}
    if cfg.pre_norm:
        tr["encoder_norm"] = _inv_ln(sd, "transformer.encoder.norm")
    for i in range(cfg.dec_layers):
        tr[f"decoder_layer_{i}"] = _inv_layer(sd, f"transformer.decoder.layers.{i}", True)
    tr["decoder_norm"] = _inv_ln(sd, "transformer.decoder.norm")
    params["transformer"] = tr
    params["query_embed"] = sd["query_embed.weight"].copy()
    params["span_embed"] = {f"layer_{i}": _inv_dense(sd, f"span_embed.layers.{i}")
                            for i in range(3)}
    params["class_embed"] = _inv_dense(sd, "class_embed")
    params["saliency_proj"] = _inv_dense(sd, "saliency_proj")
    if cfg.adapter_module == "linear":
        params["adapter_layer"] = {f"layer_{i}": _inv_dense(sd, f"adapter_layer.layers.{i}")
                                   for i in range(2)}
    if cfg.use_txt_pos:
        params["txt_position_embed"] = {
            "position_embeddings":
                sd["txt_position_embed.position_embeddings.weight"].copy(),
            "LayerNorm": _inv_ln(sd, "txt_position_embed.LayerNorm")}
    return params


def load_reference_state_dict(sd) -> dict:
    """A reference-named state dict as float32 torch tensors: a golden
    fixture's `w::` arrays (prefix stripped or not), a reference `.ckpt`'s
    {"model": state_dict}, numpy arrays or tensors."""
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    out = {}
    for k, v in sd.items():
        k = k[3:] if k.startswith("w::") else k
        t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        out[k] = t.to(torch.float32).contiguous()
    return out


def random_reference_state_dict(cfg: ModelConfig, seed: int = 0) -> dict:
    """Seeded random weights under the reference's names, as numpy arrays:
    matrices scaled normal (Glorot variance), LayerNorm weights near 1,
    biases and embeddings small. For runs that need a full-width model and
    no checkpoint."""
    from cone_tpu_torch.models.cone import ConeModel

    return _random_weights(ConeModel(cfg, device="meta").state_dict(), seed)


def _random_weights(state_dict: dict, seed: int) -> dict:
    shapes = {k: tuple(v.shape) for k, v in state_dict.items()}
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if name == "query_embed.weight":
            w = rng.normal(size=shape)
        elif len(shape) == 2 and "position_embeddings" not in name:
            w = rng.normal(size=shape) * np.sqrt(2.0 / sum(shape))
        elif len(shape) >= 3:   # a conv kernel (out, in, k...)
            field = int(np.prod(shape[2:]))
            w = rng.normal(size=shape) * np.sqrt(2.0 / ((shape[0] + shape[1]) * field))
        elif name.endswith("weight") and ("norm" in name or "LayerNorm" in name):
            w = 1.0 + 0.05 * rng.normal(size=shape)
        else:
            w = 0.02 * rng.normal(size=shape)
        out[name] = w.astype(np.float32)
    return out


# ----------------------------------------------------------- 2D-TAN family

_GATES = "ifgo"   # torch's LSTM gate order, the flax cell's gate names
# the compact names of the reference-generated golden fixtures
# (tools/gen_golden_tan*.py) -> the reference's CONE_TAN names
_TAN_RENAMES = (("frame.", "frame_layer."), ("fusion.", "fusion_layer."),
                ("mapconv.convs.", "map_layer.convs."), ("pred.", "pred_layer."),
                ("adapter.", "adapter_layer."), ("prop.", "prop_layer."))


def _conv(out, name, p, perm):
    out[f"{name}.weight"] = _np(p["kernel"]).transpose(perm)
    out[f"{name}.bias"] = _np(p["bias"])


def _conv1x1(out, name, p, n_spatial):
    k = _np(p["kernel"]).T                      # (out, in)
    out[f"{name}.weight"] = k.reshape(k.shape + (1,) * n_spatial)
    out[f"{name}.bias"] = _np(p["bias"])


def _sparse_conv_shapes(cfg: TanConfig):
    """(scale, layer) -> kernel size of SparsePropConv's convs."""
    return {(s, i): ((1 if s == 0 else 3) if i == 0 else 2)
            for s, n in enumerate(cfg.num_scale_layers) for i in range(n)}


def tan_params_from_jax(params, cfg: TanConfig) -> dict:
    """JAX ConeTanModel param tree (numpy or jax arrays) -> the port's state
    dict of float32 torch tensors, loadable with a strict load_state_dict.

    The flax LSTM cell's input denses carry no bias and its hidden denses
    carry the sum of torch's two biases; the sum goes to bias_ih and
    bias_hh is zero (torch's pair has no unique inverse; only the sum acts).
    A sparse_conv stage that the cascade skips has no flax params; its
    unused torch conv gets zeros."""
    out: dict = {}
    _conv1x1(out, "frame_layer.vis_conv", params["frame_layer"]["vis_conv"], 1)
    fu = params["fusion_layer"]
    for i in range(cfg.lstm_layers):
        p = fu["textual_encoder"][f"lstm_{i}"]
        name = "fusion_layer.textual_encoder"
        out[f"{name}.weight_ih_l{i}"] = np.concatenate(
            [_np(p[f"i{g}"]["kernel"]).T for g in _GATES])
        out[f"{name}.weight_hh_l{i}"] = np.concatenate(
            [_np(p[f"h{g}"]["kernel"]).T for g in _GATES])
        out[f"{name}.bias_ih_l{i}"] = np.concatenate([_np(p[f"h{g}"]["bias"]) for g in _GATES])
        out[f"{name}.bias_hh_l{i}"] = np.zeros_like(out[f"{name}.bias_ih_l{i}"])
    _dense(out, "fusion_layer.tex_linear", fu["tex_linear"])
    _conv1x1(out, "fusion_layer.vis_conv", fu["vis_conv"], 2)
    for i in range(len(cfg.map_hidden_sizes)):
        _conv(out, f"map_layer.convs.{i}", params["map_layer"][f"conv_{i}"], (3, 2, 0, 1))
    _conv1x1(out, "pred_layer", params["pred_layer"], 2)
    if cfg.adapter_module == "linear":
        _mlp(out, "adapter_layer", params["adapter_layer"])
    if cfg.prop_module == "sparse_conv":
        h = cfg.hidden_size
        for (s, i), k in _sparse_conv_shapes(cfg).items():
            p = params["prop_layer"].get(f"conv_{s}_{i}")
            if p is None:
                out[f"prop_layer.layers.{s}.{i}.weight"] = np.zeros((h, h, k), np.float32)
                out[f"prop_layer.layers.{s}.{i}.bias"] = np.zeros(h, np.float32)
            else:
                _conv(out, f"prop_layer.layers.{s}.{i}", p, (2, 1, 0))
    return load_reference_state_dict(out)


def _inv_conv(sd, name, perm):
    return {"kernel": sd[f"{name}.weight"].transpose(perm).copy(),
            "bias": sd[f"{name}.bias"].copy()}


def _inv_conv1x1(sd, name):
    w = sd[f"{name}.weight"]
    return {"kernel": w.reshape(w.shape[:2]).T.copy(), "bias": sd[f"{name}.bias"].copy()}


def tan_params_to_jax(state_dict, cfg: TanConfig) -> dict:
    """The port's (or a reference CONE_TAN) state dict -> the JAX
    ConeTanModel param tree of numpy arrays. Both torch LSTM biases sum
    into the flax hidden denses. sparse_conv convs of stages the cascade
    skips are left out, as flax never creates them."""
    from cone_tpu_torch.models.tan import sparse_map_layout

    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in load_reference_tan_state_dict(state_dict).items()}
    enc = "fusion_layer.textual_encoder"
    lstm = {}
    for i in range(cfg.lstm_layers):
        w_ih, w_hh = sd[f"{enc}.weight_ih_l{i}"], sd[f"{enc}.weight_hh_l{i}"]
        b = sd[f"{enc}.bias_ih_l{i}"] + sd[f"{enc}.bias_hh_l{i}"]
        h = w_hh.shape[1]
        cell = {}
        for j, g in enumerate(_GATES):
            sl = slice(j * h, (j + 1) * h)
            cell[f"i{g}"] = {"kernel": w_ih[sl].T.copy()}
            cell[f"h{g}"] = {"kernel": w_hh[sl].T.copy(), "bias": b[sl].copy()}
        lstm[f"lstm_{i}"] = cell
    params = {
        "frame_layer": {"vis_conv": _inv_conv1x1(sd, "frame_layer.vis_conv")},
        "fusion_layer": {"textual_encoder": lstm,
                         "tex_linear": _inv_dense(sd, "fusion_layer.tex_linear"),
                         "vis_conv": _inv_conv1x1(sd, "fusion_layer.vis_conv")},
        "map_layer": {f"conv_{i}": _inv_conv(sd, f"map_layer.convs.{i}", (2, 3, 1, 0))
                      for i in range(len(cfg.map_hidden_sizes))},
        "pred_layer": _inv_conv1x1(sd, "pred_layer"),
    }
    if cfg.adapter_module == "linear":
        params["adapter_layer"] = {f"layer_{i}": _inv_dense(sd, f"adapter_layer.layers.{i}")
                                   for i in range(2)}
    if cfg.prop_module == "sparse_conv":
        used = [(r[0], r[1]) for r in sparse_map_layout(cfg.num_clips, cfg.num_scale_layers)
                if r[4]]
        params["prop_layer"] = {f"conv_{s}_{i}": _inv_conv(sd, f"prop_layer.layers.{s}.{i}",
                                                           (2, 1, 0)) for s, i in used}
    return params


def load_reference_tan_state_dict(sd) -> dict:
    """A CONE_TAN state dict as float32 torch tensors under the reference's
    names. Takes a real `CONE_TAN.state_dict()` (a bare dict or under
    "model" / "state_dict"), with or without the `module.` prefix of
    nn.DataParallel, and the compact names of the golden fixtures
    (frame., fusion., mapconv., pred., adapter., prop.), as
    tools/convert_tan_ckpt.py:34-50 canonicalizes them."""
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    out = {}
    for k, v in load_reference_state_dict(sd).items():
        k = k[len("module."):] if k.startswith("module.") else k
        for old, new in _TAN_RENAMES:
            if k.startswith(old):
                k = new + k[len(old):]
                break
        out[k] = v
    return out


def random_reference_tan_state_dict(cfg: TanConfig, seed: int = 0) -> dict:
    """Seeded random CONE_TAN weights under the reference's names, as numpy
    arrays, scaled as random_reference_state_dict scales them; conv kernels
    by fan-in and fan-out over their whole receptive field. The map convs'
    kernels are then multiplied by their area: MapConv divides each cell by
    the count of valid cells its kernel saw, and without this four 9x9 convs
    shrink the map by about 81^4, leaving every cell at the prediction bias
    and the ranking to rounding."""
    from cone_tpu_torch.models.tan import ConeTanModel

    out = _random_weights(ConeTanModel(cfg, device="meta").state_dict(), seed)
    for i, k in enumerate(cfg.map_kernel_sizes):
        out[f"map_layer.convs.{i}.weight"] *= k * k
    return out


# ------------------------------------------------------- feature towers

def _clip_layers(out, prefix, params):
    for key in sorted(k for k in params if k.startswith("layer_")):
        p, name = params[key], f"{prefix}.layers.{key.split('_')[1]}"
        _ln(out, f"{name}.layer_norm1", p["layer_norm1"])
        _ln(out, f"{name}.layer_norm2", p["layer_norm2"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(out, f"{name}.self_attn.{proj}", p["self_attn"][proj])
        _dense(out, f"{name}.mlp.fc1", p["fc1"])
        _dense(out, f"{name}.mlp.fc2", p["fc2"])


def clip_vision_params_from_jax(params) -> dict:
    """cone_tpu ClipVisionTower params (numpy or jax arrays) -> the port's
    ClipVisionTower state dict (HF names) of float32 torch tensors. The
    patch conv's HWIO kernel becomes OIHW."""
    vm = "vision_model"
    out = {f"{vm}.embeddings.patch_embedding.weight":
           _np(params["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1),
           f"{vm}.embeddings.class_embedding": _np(params["class_embedding"]),
           f"{vm}.embeddings.position_embedding.weight": _np(params["position_embedding"]),
           "visual_projection.weight": _np(params["visual_projection"]["kernel"]).T}
    _ln(out, f"{vm}.pre_layrnorm", params["pre_layernorm"])
    _ln(out, f"{vm}.post_layernorm", params["post_layernorm"])
    _clip_layers(out, f"{vm}.encoder", params)
    return load_reference_state_dict(out)


def clip_text_params_from_jax(params) -> dict:
    """cone_tpu ClipTextTower params -> the port's ClipTextTower state dict
    (HF names) of float32 torch tensors."""
    tm = "text_model"
    out = {f"{tm}.embeddings.token_embedding.weight": _np(params["token_embedding"]),
           f"{tm}.embeddings.position_embedding.weight": _np(params["position_embedding"]),
           "text_projection.weight": _np(params["text_projection"]["kernel"]).T}
    _ln(out, f"{tm}.final_layer_norm", params["final_layer_norm"])
    _clip_layers(out, f"{tm}.encoder", params)
    return load_reference_state_dict(out)


def egovlp_params_from_jax(params) -> dict:
    """cone_tpu EgoVlpVideoTower params ({"video_model", "vid_proj"}) -> the
    port's EgoVlpVideoTower state dict (the reference's names) of float32
    torch tensors."""
    p, vm = params["video_model"], "video_model"
    out = {f"{vm}.patch_embed.proj.weight": _np(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1),
           f"{vm}.patch_embed.proj.bias": _np(p["patch_embed"]["bias"]),
           f"{vm}.cls_token": _np(p["cls_token"]), f"{vm}.pos_embed": _np(p["pos_embed"]),
           f"{vm}.temporal_embed": _np(p["temporal_embed"])}
    _ln(out, f"{vm}.norm", p["norm"])
    for key in sorted(k for k in p if k.startswith("block_")):
        blk, name = p[key], f"{vm}.blocks.{key.split('_')[1]}"
        for norm in ("norm1", "norm2", "norm3"):
            _ln(out, f"{name}.{norm}", blk[norm])
        for attn in ("attn", "timeattn"):
            _dense(out, f"{name}.{attn}.qkv", blk[attn]["qkv"])
            _dense(out, f"{name}.{attn}.proj", blk[attn]["proj"])
        _dense(out, f"{name}.mlp.fc1", blk["mlp"]["fc1"])
        _dense(out, f"{name}.mlp.fc2", blk["mlp"]["fc2"])
    _dense(out, "vid_proj", params["vid_proj"])
    return load_reference_state_dict(out)


def _shim_parse_config():
    """The released EgoVLP checkpoint pickles a `parse_config.ConfigParser`
    object; a stand-in module lets torch.load unpickle it (the reason the
    reference ships parse_config.py, its header says so, :1-5)."""
    import sys
    import types

    if "parse_config" in sys.modules:
        return
    mod = types.ModuleType("parse_config")

    class ConfigParser:   # attributes restored straight from the pickle
        def __init__(self, *a, **k):
            pass

    mod.ConfigParser = ConfigParser
    sys.modules["parse_config"] = mod


def read_egovlp_checkpoint(path: str) -> dict:
    """A released EgoVLP checkpoint -> its state dict of tensors (names as
    saved). The one place the port unpickles it: with the parse_config shim
    and weights_only=False, since the file pickles a ConfigParser object
    (unpickling runs code: load only checkpoints you trust)."""
    _shim_parse_config()
    state = torch.load(path, map_location="cpu", weights_only=False)
    sd = state.get("state_dict", state)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def egovlp_state_dict(sd, cfg, load_temporal_fix: str = "zeros") -> dict:
    """A reference FrozenInTime state dict (`video_model.*`, `vid_proj.*` or
    `vid_proj.0.*`, optional `module.` prefixes, tensors or numpy arrays;
    other keys such as the text model's are left out) -> the port's
    EgoVlpVideoTower state dict for `cfg` (models/egovlp.EgoVlpConfig).

    The reference's checkpoint-compat shim (egovlp/model.py:137-178): a
    temporal_embed of another frame count is truncated, zero-filled or
    interpolated (models/egovlp.inflate_temporal_embed), and a pos_embed of
    another spatial resolution raises NotImplementedError."""
    from cone_tpu_torch.models.egovlp import inflate_temporal_embed

    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    sd = {(k.replace("vid_proj.0.", "vid_proj.", 1) if k.startswith("vid_proj.0.") else k): v
          for k, v in sd.items() if k.startswith(("video_model.", "vid_proj."))}
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in sd.items()}
    n_tokens = (cfg.img_size // cfg.patch_size) ** 2 + 1
    if sd["video_model.pos_embed"].shape[1] != n_tokens:
        raise NotImplementedError(
            "Loading models with different spatial resolution / patch number not supported "
            f"(checkpoint {sd['video_model.pos_embed'].shape[1]} tokens, model {n_tokens})")
    sd["video_model.temporal_embed"] = inflate_temporal_embed(
        sd["video_model.temporal_embed"], cfg.num_frames, load_temporal_fix)
    keep = {f"video_model.{k}" for k in ("patch_embed.proj.weight", "patch_embed.proj.bias",
                                         "cls_token", "pos_embed", "temporal_embed",
                                         "norm.weight", "norm.bias")}
    keep |= {"vid_proj.weight", "vid_proj.bias"}
    keep |= {k for k in sd if k.startswith("video_model.blocks.")
             and int(k.split(".")[2]) < cfg.depth}
    return load_reference_state_dict({k: v for k, v in sd.items() if k in keep})


def load_egovlp_state_dict(path: str, cfg, load_temporal_fix: str = "zeros") -> dict:
    """A released EgoVLP checkpoint file -> the port's EgoVlpVideoTower
    state dict for `cfg` (read_egovlp_checkpoint, then egovlp_state_dict);
    the counterpart of cone_tpu's load_egovlp_params."""
    return egovlp_state_dict(read_egovlp_checkpoint(path), cfg, load_temporal_fix)


def random_clip_vision_state_dict(cfg, seed: int = 0) -> dict:
    """Seeded random ClipVisionTower weights (HF names, numpy arrays), scaled
    as random_reference_state_dict scales them."""
    from cone_tpu_torch.models.clip import ClipVisionTower

    return _random_weights(ClipVisionTower(cfg, device="meta").state_dict(), seed)


def random_clip_text_state_dict(cfg, seed: int = 0) -> dict:
    """Seeded random ClipTextTower weights (HF names, numpy arrays)."""
    from cone_tpu_torch.models.clip import ClipTextTower

    return _random_weights(ClipTextTower(cfg, device="meta").state_dict(), seed)


def random_egovlp_state_dict(cfg, seed: int = 0) -> dict:
    """Seeded random EgoVlpVideoTower weights (the reference's names, numpy
    arrays)."""
    from cone_tpu_torch.models.egovlp import EgoVlpVideoTower

    return _random_weights(EgoVlpVideoTower(cfg, device="meta").state_dict(), seed)
