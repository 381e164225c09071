"""EgoVLP clip-feature extraction on the device, the port's counterpart of
cone_tpu/extract/egovlp_video.py.

The reference extracts EgoVLP features with torch (run_on_video/
egovlp_extrator.py:114-137: frames at 1.875 fps, 4 frames a clip). Here the
port's EgoVlpVideoTower (models/egovlp.py) runs on `device`; frames come
from ffmpeg (extract/video.decode_frames). Normalisation is the reference
VideoLoader's (egovlp_extrator.py:74-90): 224 px, scaled to [0, 1], the
ImageNet mean and std.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cone_tpu_torch.data.store import write_packed_store
from cone_tpu_torch.extract import video
from cone_tpu_torch.models.egovlp import EgoVlpConfig, EgoVlpVideoTower
from cone_tpu_torch.utils.device import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def egovlp_clips(frames: np.ndarray, frames_per_clip: int) -> np.ndarray:
    """(T, H, W, 3) uint8 frames -> (T // frames_per_clip, frames_per_clip,
    H, W, 3) normalised float32 clips (a ragged tail of frames is left
    out)."""
    t = len(frames) // frames_per_clip * frames_per_clip
    clips = frames[:t].reshape((-1, frames_per_clip) + frames.shape[1:])
    return (clips.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def load_egovlp_tower(cfg: EgoVlpConfig, device, checkpoint_path: Optional[str] = None,
                      state_dict: Optional[dict] = None,
                      load_temporal_fix: str = "zeros") -> EgoVlpVideoTower:
    """The video tower in eval mode on `device`, with the weights of a
    released checkpoint (convert.load_egovlp_state_dict) or a ready state
    dict of the port's names."""
    from cone_tpu_torch.convert import load_egovlp_state_dict, load_reference_state_dict

    if state_dict is None:
        if not checkpoint_path:
            raise ValueError("the EgoVLP tower needs a checkpoint or a state dict")
        state_dict = load_egovlp_state_dict(checkpoint_path, cfg, load_temporal_fix)
    tower = EgoVlpVideoTower(cfg, device=device)
    tower.load_state_dict(load_reference_state_dict(state_dict))
    return tower.eval()


def egovlp_video_encoder(tower: EgoVlpVideoTower, clip_batch: int):
    """(N, F, H, W, 3) normalised clips (numpy) -> (N, D) clip features
    (numpy float32), `clip_batch` clips a forward; a short last batch is
    padded with zeros."""
    dev = next(tower.parameters()).device

    def encode(clips: np.ndarray) -> np.ndarray:
        feats = []
        for i in range(0, len(clips), clip_batch):
            batch = clips[i : i + clip_batch]
            n = len(batch)
            if n < clip_batch:
                batch = np.concatenate(
                    [batch, np.zeros((clip_batch - n,) + batch.shape[1:], np.float32)])
            x = torch.from_numpy(np.ascontiguousarray(batch)).to(dev).permute(0, 1, 4, 2, 3)
            with torch.inference_mode():
                feats.append(tower(x)[:n].float().cpu().numpy())
        return np.concatenate(feats)

    return encode


def extract_egovlp_video(videos: Dict[str, str], out_path: str, checkpoint_path: str,
                         fps: float = 1.875,
                         frames_per_clip: int = 4, clip_batch: int = 8,
                         cfg: Optional[EgoVlpConfig] = None, device="cuda") -> None:
    """videos: {clip_id: path} -> .cfs store of (T_clips, 256) features
    (`cfg` default: EgoVlpConfig(), the released ViT-B/16 at 4 frames). A
    video shorter than one clip is skipped with a warning."""
    cfg = cfg if cfg is not None else EgoVlpConfig()
    dev = resolve_device(device)
    encode = egovlp_video_encoder(load_egovlp_tower(cfg, dev, checkpoint_path), clip_batch)
    items = {}
    for clip_id, path in videos.items():
        frames = video.decode_frames(path, fps, size=cfg.img_size)
        if len(frames) < frames_per_clip:
            # shorter than one clip window: skip it loudly rather than lose
            # every other video of the run
            print(f"WARNING: {clip_id} ({path}): {len(frames)} frames"
                  f" < frames_per_clip={frames_per_clip}; skipped")
            continue
        items[clip_id] = encode(egovlp_clips(frames, frames_per_clip)).astype(np.float32)
    write_packed_store(out_path, items)
