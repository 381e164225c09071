"""Offline text feature extraction -> packed .cfs stores, the port's
counterpart of cone_tpu/extract/text.py.

Tokenization stays on the host; the text towers run on `device` (default
the card). Writes the two stores the data layer reads (`tokens.cfs` +
`cls.cfs`), with the reference's feature semantics:

  * CLIP (feature_extraction/mad_clip_text_extractor.py,
    ego4d_clip_token_extractor.py): token features = final-layernorm hidden
    states with SOT/EOT stripped; cls = the EOT feature through the text
    projection. Engine "tower" runs the port's ClipTextTower
    (models/clip.py) at context 77, EOT = length - 1; engine "hf" the
    transformers CLIPTextModelWithProjection.
  * RoBERTa (feature_extraction/ego4d_roberta_token_extractor.py): token
    features = last_hidden_state with the special tokens stripped; cls =
    the mean of those rows.
  * EgoVLP's text tower (run_on_video/egovlp_extrator.py:139-150):
    DistilBERT token states (CLS/SEP stripped) + the checkpoint's txt_proj
    applied to the CLS state.

RoBERTa and DistilBERT run transformers' torch classes on `device` (the
port has no module of its own for them). `transformers` is imported only
where a model or tokenizer must be loaded by name.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from cone_tpu_torch.data.store import write_packed_store
from cone_tpu_torch.extract.video import check_engine
from cone_tpu_torch.utils.device import resolve_device
from cone_tpu_torch.utils.io import load_jsonl


def _write_stores(out_dir: str, tokens: Dict[str, np.ndarray],
                  cls: Dict[str, np.ndarray]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    write_packed_store(os.path.join(out_dir, "tokens.cfs"), tokens)
    write_packed_store(os.path.join(out_dir, "cls.cfs"),
                       {k: v[None] if v.ndim == 1 else v for k, v in cls.items()})


def _queries(jsonl_path: str) -> List[Tuple[str, str]]:
    return [(r["query_id"], r["query"]) for r in load_jsonl(jsonl_path)]


def _encoded(tokenizer, texts, dev, **kw) -> dict:
    """Tokenizer output as tensors on `dev`."""
    enc = tokenizer(texts, return_tensors="pt", **kw)
    return {k: v.to(dev) for k, v in enc.items()}


def clip_text_models(model_name: str, model=None, tokenizer=None):
    """(text model, tokenizer): the ones passed in, or transformers'
    released ones loaded by name."""
    if model is None or tokenizer is None:
        from transformers import CLIPTextModelWithProjection, CLIPTokenizerFast

        tokenizer = tokenizer or CLIPTokenizerFast.from_pretrained(model_name)
        model = model or CLIPTextModelWithProjection.from_pretrained(model_name)
    return model, tokenizer


def _tower_text_encoder(model, tokenizer, batch_size: int, dev):
    """The tower engine: the port's ClipTextTower at fixed (batch_size,
    context) shapes; a short last batch is padded with repeated rows. The
    reference tokenizes at the fixed context length (clip_extractor.py:47)
    and its CLIP masks causally only, so padding cannot leak left."""
    from cone_tpu_torch.models.clip import as_text_tower

    tower = as_text_tower(model, dev)
    ctx = tower.cfg.context_length

    def encode(texts):
        out_tokens, out_cls = [], []
        for i in range(0, len(texts), batch_size):
            chunk = list(texts[i : i + batch_size])
            enc = tokenizer(chunk, padding="max_length", max_length=ctx, truncation=True,
                            return_tensors="np")
            ids = np.asarray(enc["input_ids"], np.int64)
            lengths = np.asarray(enc["attention_mask"]).sum(1).astype(np.int64)
            if len(chunk) < batch_size:
                reps = batch_size - len(chunk)
                ids = np.concatenate([ids, np.repeat(ids[-1:], reps, 0)])
                lengths = np.concatenate([lengths, np.repeat(lengths[-1:], reps)])
            with torch.inference_mode():
                toks, emb = tower(torch.from_numpy(ids).to(dev),
                                  torch.from_numpy(lengths - 1).to(dev))
            toks, emb = toks.float().cpu().numpy(), emb.float().cpu().numpy()
            for j in range(len(chunk)):
                out_tokens.append(toks[j, 1 : lengths[j] - 1].copy())
                out_cls.append(emb[j])
        return out_tokens, np.stack(out_cls)

    return encode


def _hf_text_encoder(model, tokenizer, batch_size: int, dev):
    """The hf engine: the transformers model, batches padded to their
    longest query. last_hidden_state is already final_layer_norm'd, the
    reference's single ln_final (feature_extraction/clip/model.py:346)."""
    if not hasattr(model, "config"):
        raise ValueError("engine 'hf' runs a transformers model; this one is the port's tower")
    model = model.to(dev).eval()

    def encode(texts):
        out_tokens, out_cls = [], []
        for i in range(0, len(texts), batch_size):
            enc = _encoded(tokenizer, list(texts[i : i + batch_size]), dev, padding=True,
                           truncation=True)
            with torch.inference_mode():
                out = model(**enc)
            hidden = out.last_hidden_state.float().cpu().numpy()
            emb = out.text_embeds.float().cpu().numpy()
            for j, n in enumerate(enc["attention_mask"].sum(1).tolist()):
                out_tokens.append(hidden[j, 1 : n - 1].copy())   # strip SOT + EOT
                out_cls.append(emb[j])
        return out_tokens, np.stack(out_cls)

    return encode


def clip_text_encoder(model, tokenizer, batch_size: int, device, engine: str = "tower"):
    """texts -> (token feature list, SOT/EOT stripped; (N, D) cls) on
    `device`. `model` is a transformers text model, or for the tower engine
    also a ClipTextTower. Shared by offline extraction and the serving
    predictor."""
    check_engine(engine)
    dev = resolve_device(device)
    make = _tower_text_encoder if engine == "tower" else _hf_text_encoder
    return make(model, tokenizer, batch_size, dev)


def extract_clip_text(jsonl_path: str, out_dir: str,
                      model_name: str = "openai/clip-vit-base-patch32", batch_size: int = 60,
                      device="cuda", engine: str = "tower", _model=None,
                      _tokenizer=None) -> None:
    """CLIP text features of a query jsonl. `_model` (a transformers text
    model, or for the tower engine a ClipTextTower) and `_tokenizer`
    inject preloaded instances."""
    check_engine(engine)
    resolve_device(device)
    model, tokenizer = clip_text_models(model_name, _model, _tokenizer)
    encode = clip_text_encoder(model, tokenizer, batch_size, device, engine)
    rows = _queries(jsonl_path)
    toks, cls = encode([q for _, q in rows])
    _write_stores(out_dir, {qid: t for (qid, _), t in zip(rows, toks)},
                  {qid: c for (qid, _), c in zip(rows, cls)})


def hf_text_models(model_name: str, model=None, tokenizer=None):
    """(AutoModel, AutoTokenizer) of a transformers text model: the ones
    passed in, or loaded by name."""
    if model is None or tokenizer is None:
        from transformers import AutoModel, AutoTokenizer

        tokenizer = tokenizer or AutoTokenizer.from_pretrained(model_name)
        model = model or AutoModel.from_pretrained(model_name)
    return model, tokenizer


def _hidden_rows(model, tokenizer, rows, batch_size, dev):
    """Yield (query_id, (L, D) last_hidden_state on the device, true
    length), batches padded to their longest query."""
    model = model.to(dev).eval()
    for i in range(0, len(rows), batch_size):
        chunk = rows[i : i + batch_size]
        enc = _encoded(tokenizer, [q for _, q in chunk], dev, padding=True, truncation=True)
        with torch.inference_mode():
            hidden = model(**enc).last_hidden_state
        for j, n in enumerate(enc["attention_mask"].sum(1).tolist()):
            yield chunk[j][0], hidden[j], n


def extract_roberta_text(jsonl_path: str, out_dir: str, model_name: str = "roberta-base",
                         batch_size: int = 32, device="cuda", _model=None,
                         _tokenizer=None) -> None:
    """RoBERTa token features (<s> and </s> stripped,
    ego4d_roberta_token_extractor.py:107-120) and their mean as cls."""
    dev = resolve_device(device)
    model, tokenizer = hf_text_models(model_name, _model, _tokenizer)
    tokens, cls = {}, {}
    for qid, hidden, n in _hidden_rows(model, tokenizer, _queries(jsonl_path), batch_size, dev):
        tok = hidden[1 : n - 1].float().cpu().numpy()
        tokens[qid], cls[qid] = tok, tok.mean(0)
    _write_stores(out_dir, tokens, cls)


def egovlp_text_encoder(model, tokenizer, checkpoint: str, batch_size: int, device):
    """texts -> (DistilBERT token feature list, CLS/SEP stripped; (N, D)
    cls = the checkpoint's txt_proj of the CLS state) on `device`: EgoVLP's
    text tower (egovlp_extrator.py:139-150). Shared by offline extraction
    and the serving predictor."""
    from cone_tpu_torch.convert import read_egovlp_checkpoint

    dev = resolve_device(device)
    sd = read_egovlp_checkpoint(checkpoint)
    w = next(v for k, v in sd.items() if "txt_proj" in k and k.endswith("weight")).float().to(dev)
    b = next(v for k, v in sd.items() if "txt_proj" in k and k.endswith("bias")).float().to(dev)

    def encode(texts):
        tokens, cls = [], []
        for _, hidden, n in _hidden_rows(model, tokenizer, list(enumerate(texts)), batch_size,
                                         dev):
            tokens.append(hidden[1 : n - 1].float().cpu().numpy())
            cls.append((hidden[0] @ w.T + b).float().cpu().numpy())
        return tokens, np.stack(cls)

    return encode


def extract_egovlp_text(jsonl_path: str, out_dir: str, checkpoint: str,
                        model_name: str = "distilbert-base-uncased", batch_size: int = 32,
                        device="cuda", _model=None, _tokenizer=None) -> None:
    """EgoVLP's text tower over a query jsonl (egovlp_text_encoder)."""
    resolve_device(device)
    model, tokenizer = hf_text_models(model_name, _model, _tokenizer)
    encode = egovlp_text_encoder(model, tokenizer, checkpoint, batch_size, device)
    rows = _queries(jsonl_path)
    toks, cls = encode([q for _, q in rows])
    _write_stores(out_dir, {qid: t for (qid, _), t in zip(rows, toks)},
                  {qid: c for (qid, _), c in zip(rows, cls)})
