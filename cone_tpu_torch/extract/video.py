"""Offline video clip-feature extraction -> packed .cfs store, the port's
counterpart of cone_tpu/extract/video.py.

CLIP image features at a fixed fps, as the reference pipeline extracts
them (feature_extraction/clip_extractor.py:100-176): ffmpeg decodes frames
at `fps` through a subprocess pipe, the frames go through the CLIP vision
tower in batches, one row per frame.

Decode and CLIP's image preprocessing stay on the host. The tower runs on
`device` (default the card) with one of two engines:

  * "tower": the port's ClipVisionTower (models/clip.py), built from the
    HF model's config and weights (or passed in ready), at a fixed batch;
  * "hf": the transformers CLIPVisionModelWithProjection itself.

`transformers` is imported only where a model or processor must be loaded
by name. The EgoVLP video tower is driven by extract/egovlp_video.py.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict

import numpy as np
import torch

from cone_tpu_torch.data.store import write_packed_store
from cone_tpu_torch.utils.device import resolve_device

ENGINES = ("tower", "hf")


def decode_frames(video_path: str, fps: float, size: int = 224) -> np.ndarray:
    """ffmpeg -> (T, size, size, 3) uint8 RGB frames at `fps`. A missing
    ffmpeg binary or a failed decode raises."""
    cmd = ["ffmpeg", "-nostdin", "-i", video_path, "-vf", f"fps={fps},scale={size}:{size}",
           "-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:1", "-loglevel", "error"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    n = len(raw) // (size * size * 3)
    return np.frombuffer(raw[: n * size * size * 3], np.uint8).reshape(n, size, size, 3)


def check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: one of {ENGINES} (tower = the port's module, "
                         "hf = the transformers model)")


def _tower_encoder(model, batch_size: int, dev):
    """(B, 3, H, W) preprocessed pixels (numpy) -> (B, D) image features
    (numpy float32) through the port's ClipVisionTower, at a fixed batch: a
    short last batch is padded with repeated frames."""
    from cone_tpu_torch.models.clip import as_vision_tower

    tower = as_vision_tower(model, dev)

    def encode(pixels: np.ndarray) -> np.ndarray:
        n = pixels.shape[0]
        if n < batch_size:
            pixels = np.concatenate([pixels, np.repeat(pixels[-1:], batch_size - n, 0)])
        with torch.inference_mode():
            out = tower(torch.from_numpy(np.ascontiguousarray(pixels, np.float32)).to(dev))
        return out[:n].float().cpu().numpy()

    return encode


def _hf_encoder(model, dev):
    """Pixels (numpy) -> image features through the transformers model."""
    if not hasattr(model, "config"):
        raise ValueError("engine 'hf' runs a transformers model; this one is the port's tower")
    model = model.to(dev).eval()

    def encode(pixels: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = model(pixel_values=torch.from_numpy(np.asarray(pixels, np.float32)).to(dev))
        return out.image_embeds.float().cpu().numpy()

    return encode


def clip_frame_encoder(model, processor, batch_size: int, device, engine: str = "tower"):
    """(T, H, W, 3) uint8 frames -> (T, D) float32 image features on
    `device`, `batch_size` frames a forward. `model` is a transformers
    vision model, or for the tower engine also a ClipVisionTower;
    `processor` is called as processor(images=frames,
    return_tensors="np")["pixel_values"]."""
    check_engine(engine)
    dev = resolve_device(device)
    encode = _tower_encoder(model, batch_size, dev) if engine == "tower" else _hf_encoder(model, dev)

    def frames_to_features(frames: np.ndarray) -> np.ndarray:
        return np.concatenate([
            encode(processor(images=list(frames[i : i + batch_size]),
                             return_tensors="np")["pixel_values"])
            for i in range(0, len(frames), batch_size)]).astype(np.float32)

    return frames_to_features


def clip_image_models(model_name: str, model=None, processor=None):
    """(vision model, image processor): the ones passed in, or transformers'
    released ones loaded by name."""
    if model is None or processor is None:
        from transformers import CLIPImageProcessor, CLIPVisionModelWithProjection

        processor = processor or CLIPImageProcessor.from_pretrained(model_name)
        model = model or CLIPVisionModelWithProjection.from_pretrained(model_name)
    return model, processor


def extract_clip_video(videos: Dict[str, str], out_path: str,
                       model_name: str = "openai/clip-vit-base-patch32", fps: float = 5.0,
                       batch_size: int = 64, device="cuda", engine: str = "tower",
                       _model=None, _processor=None) -> None:
    """videos: {clip_id: video file} -> one .cfs store of (T, D) rows.
    `_model` (a transformers vision model, or for the tower engine a
    ClipVisionTower) and `_processor` (called as
    processor(images=frames, return_tensors="np")["pixel_values"]) inject
    preloaded instances."""
    check_engine(engine)
    resolve_device(device)
    model, processor = clip_image_models(model_name, _model, _processor)
    encode = clip_frame_encoder(model, processor, batch_size, device, engine)
    items = {clip_id: encode(decode_frames(path, fps)) for clip_id, path in videos.items()}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_packed_store(out_path, items)
