"""End-to-end demo predictor: video file + query text -> ranked moments,
the port's counterpart of cone_tpu/serve/predictor.py and of the
reference's run_on_video/run.py CONEPredictor: extract the clip features
(cached to disk like the reference's .pt cache, run.py:30-38), extract the
text features, localize with the batched pipeline (serve/localizer.py).

Two extraction backends, both on `device` (default the card):

  * "clip": the CLIP towers. engine "tower" runs the port's towers
    (models/clip.py), engine "hf" the transformers models; ffmpeg decode,
    image preprocessing and tokenization stay on the host.
  * "egovlp": the reference demo's backbone (run_on_video/run.py:10-40,
    egovlp_extrator.py:99-150): video through the port's EgoVlpVideoTower
    (models/egovlp.py), text as DistilBERT token states + the
    checkpoint's txt_proj of the CLS state (transformers' torch class).
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np

from cone_tpu_torch.config import ConeConfig
from cone_tpu_torch.extract import video as xv
from cone_tpu_torch.serve.localizer import OnlineLocalizer
from cone_tpu_torch.utils.device import resolve_device
from cone_tpu_torch.utils.io import l2_normalize

BACKENDS = ("clip", "egovlp")
CLIP_FRAME_BATCH = 64   # frames a vision forward
EGOVLP_CLIP_BATCH = 8   # clips a video-tower forward


class MomentPredictor:
    def __init__(self, model, cfg: ConeConfig, backend: str = "clip",
                 clip_model_name: str = "openai/clip-vit-base-patch32",
                 fps: Optional[float] = None, cache_dir: str = "feature_cache",
                 egovlp_checkpoint: Optional[str] = None, egovlp_cfg=None,
                 egovlp_state_dict: Optional[dict] = None,
                 text_model_name: str = "distilbert-base-uncased",
                 frames_per_clip: int = 4, engine: str = "tower",
                 clip_models: Optional[dict] = None, device="cuda"):
        """backend="egovlp": `egovlp_checkpoint` (the released .pth; both
        towers' weights come from it) or, for the video tower, a ready
        `egovlp_state_dict` of the port's names with its `egovlp_cfg`.
        `fps` is the CLIP frame rate or the EgoVLP clip rate (default
        1 / data.clip_length); EgoVLP decodes frames_per_clip frames a clip
        (egovlp_extrator.py:120-135).

        backend="clip": `engine` "tower" (the port's modules) or "hf"
        (transformers'); `clip_models` injects {"vision", "text",
        "processor", "tokenizer"}, where vision and text are the port's
        towers or transformers models (tests, a pre-warmed server, a
        machine without transformers)."""
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        xv.check_engine(engine)
        self.cfg, self.backend, self.engine = cfg, backend, engine
        self.device = resolve_device(device)
        self.localizer = OnlineLocalizer(model, cfg, device=self.device)
        self.clip_model_name = clip_model_name
        self.fps = fps if fps is not None else 1.0 / cfg.data.clip_length
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self.frames_per_clip = frames_per_clip
        self.text_model_name = text_model_name
        self.egovlp_checkpoint = egovlp_checkpoint
        if egovlp_cfg is None and backend == "egovlp":
            from cone_tpu_torch.models.egovlp import EgoVlpConfig

            egovlp_cfg = EgoVlpConfig()
        self.egovlp_cfg = egovlp_cfg
        self._egovlp_sd = egovlp_state_dict
        self._clip_models = clip_models or {}
        self._video_encoder = None
        self._text_encoder = None

    # ---- video features ---------------------------------------------------

    def _video_cache_path(self, video_path: str) -> str:
        # the engine is part of the key: the two engines agree only to a
        # tolerance, so serving one engine's cached features for the other
        # would defeat exactness comparisons
        tag = (f"clip:{self.clip_model_name}:{self.engine}" if self.backend == "clip"
               else f"egovlp:{self.egovlp_checkpoint}:{self.frames_per_clip}:{self.egovlp_cfg}")
        key = hashlib.sha1(f"{os.path.abspath(video_path)}:{tag}:{self.fps}".encode()
                           ).hexdigest()[:16]
        return os.path.join(self.cache_dir, f"vid_{key}.npy")

    def _make_video_encoder(self):
        """frames (T, H, W, 3) uint8 -> (rows, D) features on the device."""
        if self.backend == "egovlp":
            from cone_tpu_torch.extract.egovlp_video import (
                egovlp_clips, egovlp_video_encoder, load_egovlp_tower)

            tower = load_egovlp_tower(self.egovlp_cfg, self.device, self.egovlp_checkpoint,
                                      self._egovlp_sd)
            encode = egovlp_video_encoder(tower, EGOVLP_CLIP_BATCH)
            return lambda frames: encode(egovlp_clips(frames, self.frames_per_clip))
        vision, processor = xv.clip_image_models(
            self.clip_model_name, self._clip_models.get("vision"),
            self._clip_models.get("processor"))
        return xv.clip_frame_encoder(vision, processor, CLIP_FRAME_BATCH, self.device,
                                     self.engine)

    def video_features(self, video_path: str) -> np.ndarray:
        """(clips, D) features of a video file, from the cache when this
        video was extracted before with the same backend, engine, fps and
        geometry."""
        cache = self._video_cache_path(video_path)
        if os.path.exists(cache):
            return np.load(cache)
        if self._video_encoder is None:
            self._video_encoder = self._make_video_encoder()
        if self.backend == "egovlp":
            e = self.egovlp_cfg
            frames = xv.decode_frames(video_path, self.fps * self.frames_per_clip,
                                      size=e.img_size)
        else:
            frames = xv.decode_frames(video_path, self.fps)
        out = self._video_encoder(frames).astype(np.float32)
        np.save(cache, out)
        return out

    # ---- text features ----------------------------------------------------

    def _make_text_encoder(self):
        """query -> (tokens (L, Dt), cls (D,)) numpy."""
        from cone_tpu_torch.extract import text as tx

        if self.backend == "egovlp":
            if not self.egovlp_checkpoint:
                raise ValueError("backend 'egovlp' encodes text with the checkpoint's txt_proj:"
                                 " pass egovlp_checkpoint")
            model, tokenizer = tx.hf_text_models(self.text_model_name)
            encode = tx.egovlp_text_encoder(model, tokenizer, self.egovlp_checkpoint, 1,
                                            self.device)
        else:
            model, tokenizer = tx.clip_text_models(
                self.clip_model_name, self._clip_models.get("text"),
                self._clip_models.get("tokenizer"))
            encode = tx.clip_text_encoder(model, tokenizer, 1, self.device, self.engine)

        def encode_one(query):
            toks, cls = encode([query])
            return toks[0], cls[0]
        return encode_one

    def text_features(self, query: str):
        """(token features (L, Dt), cls (D,)) of one query, unnormalised: the
        text encoder of `serve --text_backend`."""
        if self._text_encoder is None:
            self._text_encoder = self._make_text_encoder()
        return self._text_encoder(query)

    # ---- end to end -------------------------------------------------------

    def localize_moment(self, video_path: str, query: str,
                        top_k: Optional[int] = None) -> List[List[float]]:
        """[[st_sec, ed_sec, prop, match, fusion], ...] ranked by fusion
        (run_on_video/run.py:52-70)."""
        video = l2_normalize(self.video_features(video_path))
        tokens, cls = self.text_features(query)
        # a backbone whose dims differ from the model's fails here with a
        # readable message (the probe of serve/server.py's MomentService):
        # tokens feed the transformer (t_feat_dim), cls and video the
        # matching branch (v_appear_feat_dim)
        td, cd, vd = np.asarray(tokens).shape[-1], np.asarray(cls).shape[-1], video.shape[-1]
        m = self.cfg.model
        if not (td == m.t_feat_dim and cd == m.v_appear_feat_dim
                and vd == m.v_appear_feat_dim and vd == m.v_motion_feat_dim):
            raise ValueError(
                f"backend '{self.backend}' produces {td}-d tokens / {cd}-d cls / {vd}-d video"
                f" but the model expects t_feat_dim={m.t_feat_dim} / v_appear_feat_dim="
                f"{m.v_appear_feat_dim} / v_motion_feat_dim={m.v_motion_feat_dim} (the demo"
                " serves one stream to both branches): pick the backend matching the"
                " features the checkpoint trained on")
        return self.localizer.localize(video, l2_normalize(tokens), l2_normalize(cls[None])[0],
                                       query=query, top_k=top_k)
