"""The device-resident video library: how a video lives on the card.

A video's host features (data/dataset.py, L2-normalized) pad with zeros to
the smallest eval.ctx_buckets entry that fits (else data.max_ctx_l),
encode per eval.corpus_dtype (float32, bfloat16, or int8 with a per-frame
symmetric max-abs scale), upload once and stay until dropped. The fused
pipeline (eval/pipeline.py) and the corpus retriever (serve/corpus.py) both
read videos through here, one at a time or stacked along a leading video
axis.

A single-stream video's motion IS its appearance tensor, and its motion
scale its appearance scale, in one video and in a stack alike: a consumer
tests `motion is appear` and runs the stream once.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from cone_tpu_torch.config import ConeConfig
from cone_tpu_torch.data.dataset import GroundingDataset


class DeviceVideo(NamedTuple):
    """One video on the device, or a stack of them with a leading (V,) axis
    (`ResidentVideos.stack`, whose ctx_l is then a (V,) int32 tensor)."""

    appear: torch.Tensor             # (L_pad, D) encoded per eval.corpus_dtype
    a_scale: Optional[torch.Tensor]  # (L_pad, 1) int8 scale, else None
    motion: torch.Tensor             # the appear tensor itself when single-stream
    m_scale: Optional[torch.Tensor]
    ctx_l: Union[int, torch.Tensor]  # real clips; the rest is zero padding


class ResidentVideos:
    """The padded, encoded device copies of a dataset's videos, keyed by
    clip id."""

    def __init__(self, dataset: GroundingDataset, cfg: ConeConfig, device):
        self.ds = dataset
        self.cfg = cfg
        self.device = device
        self._dev_cache: Dict[str, DeviceVideo] = {}

    def __len__(self) -> int:
        """Videos held one by one (a stack's copies are the caller's)."""
        return len(self._dev_cache)

    @staticmethod
    def decode(x, scale):
        """Encoded features back to fp32: float32/bfloat16 carry no scale;
        int8 carries its per-frame scale (..., L, 1)."""
        x = x.float()
        return x if scale is None else x * scale

    def bucket_len(self, ctx_l: int) -> int:
        """The smallest ctx bucket that fits, else max_ctx_l."""
        for b in sorted(self.cfg.eval.ctx_buckets):
            if ctx_l <= b:
                return int(b)
        return self.cfg.data.max_ctx_l

    def _encode_corpus(self, x, l_pad: int):
        """One (L, D) host array zero-padded to l_pad rows and encoded per
        eval.corpus_dtype -> (tensor, scale): scale is None for
        float32/bfloat16 and the per-frame (l_pad, 1) symmetric max-abs
        scale for int8 (zero rows get scale 1, so padding decodes to
        zeros)."""
        x_np = np.zeros((l_pad, x.shape[1]), np.float32)
        x_np[: len(x)] = x
        dt = self.cfg.eval.corpus_dtype
        if dt == "int8":
            scale = np.abs(x_np).max(axis=1, keepdims=True) / 127.0
            scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
            q = np.clip(np.rint(x_np / scale), -127, 127).astype(np.int8)
            return (torch.from_numpy(q).to(self.device),
                    torch.from_numpy(scale).to(self.device))
        t = torch.from_numpy(x_np).to(self.device)
        if dt == "bfloat16":
            return t.to(torch.bfloat16), None
        if dt != "float32":
            raise ValueError(f"unknown eval.corpus_dtype {dt!r}")
        return t, None

    def get(self, clip_id: str) -> DeviceVideo:
        """The video's device copy, uploaded at its first use."""
        if clip_id not in self._dev_cache:
            appear, motion = self.ds.video_features(clip_id)
            ctx_l = len(appear)
            max_ctx = self.cfg.data.max_ctx_l
            if ctx_l > max_ctx:
                raise ValueError(f"{clip_id}: {ctx_l} clips > data.max_ctx_l {max_ctx}")
            l_pad = self.bucket_len(ctx_l)
            a = self._encode_corpus(appear, l_pad)
            m = a if motion is appear else self._encode_corpus(motion, l_pad)
            self._dev_cache[clip_id] = DeviceVideo(*a, *m, ctx_l)
        return self._dev_cache[clip_id]

    def stack(self, clip_ids) -> DeviceVideo:
        """The videos of one bucket stacked along a leading (V,) axis, ctx_l
        a (V,) int32 tensor; motion (and its scale) is the appearance stack
        itself when every video is single-stream."""
        vids = [self.get(c) for c in clip_ids]
        appear = torch.stack([v.appear for v in vids])
        a_scale = None if vids[0].a_scale is None else torch.stack([v.a_scale for v in vids])
        if all(v.motion is v.appear for v in vids):
            motion, m_scale = appear, a_scale
        else:
            motion = torch.stack([v.motion for v in vids])
            m_scale = None if vids[0].m_scale is None else torch.stack([v.m_scale for v in vids])
        ctx = torch.from_numpy(np.asarray([v.ctx_l for v in vids], np.int32)).to(self.device)
        return DeviceVideo(appear, a_scale, motion, m_scale, ctx)

    def drop(self, clip_id: str) -> None:
        """Forget one video's device copy; the next get() uploads it anew."""
        self._dev_cache.pop(clip_id, None)

    def clear(self) -> None:
        self._dev_cache.clear()

    def resident_clips(self, clip_ids) -> int:
        """Clips of the given videos whose features the dataset holds."""
        return sum(len(v[0]) for v in map(self.ds.cached_video, clip_ids) if v is not None)
