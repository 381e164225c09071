"""Weights across packages: the JAX package's flax param tree <-> the
reference's torch state-dict names that the port's modules use.

The mapping is purely structural: dense kernels transpose ((in, out) <->
torch's (out, in)), LayerNorm scale <-> weight, and attention in-projections
stay packed ((D, 3D) kernel <-> (3D, D) in_proj_weight).

    params_from_jax(params_np, model_cfg) -> state_dict (torch tensors)
    params_to_jax(state_dict, model_cfg)  -> params (numpy tree)
    load_reference_state_dict(sd)         -> state_dict (torch tensors)
    random_reference_state_dict(cfg, seed) -> numpy state dict
"""

from __future__ import annotations

import numpy as np
import torch

from cone_tpu_torch.config import ModelConfig


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

    shapes = {k: tuple(v.shape) for k, v in ConeModel(cfg, device="meta").state_dict().items()}
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if name == "query_embed.weight":
            w = rng.normal(size=shape)
        elif len(shape) == 2 and "position_embeddings" not in name:
            w = rng.normal(size=shape) * np.sqrt(2.0 / sum(shape))
        elif name.endswith("weight") and ("norm" in name or "LayerNorm" in name):
            w = 1.0 + 0.05 * rng.normal(size=shape)
        else:
            w = 0.02 * rng.normal(size=shape)
        out[name] = w.astype(np.float32)
    return out
