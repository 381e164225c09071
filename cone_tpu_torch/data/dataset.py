"""Grounding dataset, inference half: queries + feature stores, with the
reference's L2 normalization (cone/ego4d_mad_dataloader.py:73-111).
Train-side window sampling is not ported yet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from cone_tpu_torch.config import DataConfig
from cone_tpu_torch.data.store import FeatureStore, TextFeatureStore
from cone_tpu_torch.utils.io import l2_normalize, load_jsonl


@dataclass
class QueryExample:
    """One jsonl line (query_id, query, video_id, clip_id, timestamps,
    duration)."""

    query_id: str
    query: str
    video_id: str
    clip_id: str
    timestamps: List[float]  # [start_sec, end_sec]
    duration: float

    @classmethod
    def from_dict(cls, d: dict) -> "QueryExample":
        return cls(
            query_id=d["query_id"], query=d.get("query", ""),
            video_id=d.get("video_id", d["clip_id"]), clip_id=d["clip_id"],
            timestamps=list(d.get("timestamps", [0.0, 0.0])),
            duration=float(d.get("duration", 0.0)),
        )


class GroundingDataset:
    """Queries + feature stores."""

    def __init__(self, examples, video_appear_store: FeatureStore,
                 text_store: TextFeatureStore, cfg: DataConfig,
                 video_motion_store: Optional[FeatureStore] = None):
        if isinstance(examples, str):
            examples = load_jsonl(examples)
        self.examples = [
            e if isinstance(e, QueryExample) else QueryExample.from_dict(e)
            for e in examples
        ]
        if cfg.data_ratio != 1.0:
            self.examples = self.examples[: int(len(self.examples) * cfg.data_ratio)]
        self.appear = video_appear_store
        self.motion = video_motion_store or video_appear_store
        self.same_visual = video_motion_store is None
        self.text = text_store
        self.cfg = cfg
        self.stride = cfg.max_v_l // 2
        self._vid_cache: Dict[str, tuple] = {}
        self._pinned: set = set()

    def __len__(self):
        return len(self.examples)

    @property
    def video_ids(self) -> List[str]:
        return list(dict.fromkeys(e.clip_id for e in self.examples))

    def video_features(self, clip_id: str):
        """(appearance, motion) L2-normalized (Lv, D) float32 arrays; motion
        is the appearance array itself when there is no motion store."""
        if clip_id not in self._vid_cache:
            ap = self.appear.get(clip_id).astype(np.float32)
            if self.cfg.normalize_v:
                ap = l2_normalize(ap)
            if self.same_visual:
                mo = ap
            else:
                mo = self.motion.get(clip_id).astype(np.float32)
                if self.cfg.normalize_v:
                    mo = l2_normalize(mo)
            limit = self.cfg.max_cached_videos
            if limit and len(self._vid_cache) >= limit:
                # FIFO eviction of the oldest unpinned entry
                for k in self._vid_cache:
                    if k not in self._pinned:
                        self._vid_cache.pop(k)
                        break
            self._vid_cache[clip_id] = (ap, mo)
        return self._vid_cache[clip_id]

    def pin_video(self, clip_id: str, ap: np.ndarray, mo: np.ndarray) -> None:
        """Install (already-normalized) features for a video that has no
        backing store entry; exempt from cache eviction."""
        self._vid_cache[clip_id] = (ap, mo)
        self._pinned.add(clip_id)

    def prefetch_videos(self, clip_ids) -> None:
        """Hint the backing stores to page-warm upcoming videos (no-op for
        stores without a `prefetch` method)."""
        for store in {id(self.appear): self.appear, id(self.motion): self.motion}.values():
            fn = getattr(store, "prefetch", None)
            if fn is not None:
                fn([c for c in clip_ids if c not in self._vid_cache])

    def query_features(self, qid: str):
        """(tokens (<=max_q_l, Dt), cls (D,)) L2-normalized."""
        tok = self.text.get_tokens(qid).astype(np.float32)[: self.cfg.max_q_l]
        if self.cfg.normalize_t:
            tok = l2_normalize(tok)
        cls = l2_normalize(self.text.get_cls(qid).astype(np.float32))
        return tok, cls
