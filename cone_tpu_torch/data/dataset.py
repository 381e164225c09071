"""Grounding dataset: queries + feature stores with the reference's L2
normalization (cone/ego4d_mad_dataloader.py:73-111), and host-side training
window sampling into fixed-shape batches.

Train-side sampling follows the reference policy
(cone/ego4d_mad_dataloader.py:160-227):
  * positive windows = all sliding windows overlapping the GT span,
  * ONE positive drawn with Gaussian weights centred on the middle window,
  * the window-local span label in normalized (center, width),
  * 1 random saliency frame inside the GT + 1 outside,
  * ONE random negative (non-overlapping) window.
Sampling runs on the host with seeded numpy Generators, under the same
seeding contract as the JAX package's TrainLoader, so both packages build
the same batches bit for bit.
"""

from __future__ import annotations

import math
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


def gaussian_window_choice(pos_ids: np.ndarray, rng: np.random.Generator) -> int:
    """Pick one positive window, weighting middle windows higher with a
    standard-normal pdf over (id - mean) (cone/ego4d_mad_dataloader.py:177-181)."""
    x = pos_ids - pos_ids.mean()
    w = np.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)
    w = w / w.sum()
    return int(rng.choice(pos_ids, p=w))


class GroundingDataset:
    """Queries + feature stores + window geometry."""

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

    def evict_video(self, clip_id: str) -> None:
        """Drop one video's cached features and its pin; a video with a
        backing store entry reads again at its next use."""
        self._vid_cache.pop(clip_id, None)
        self._pinned.discard(clip_id)

    def cached_video(self, clip_id: str):
        """The cached (appearance, motion) of a video, else None; reads no
        store."""
        return self._vid_cache.get(clip_id)

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

    def sample_negative_window(self, index: int, rng: np.random.Generator):
        """One padded standard-size negative window of the motion stream,
        ((max_v_l, D) features, (max_v_l,) mask): what a multiscale extra
        row needs, without building a full training sample. One draw from
        `rng`, as cone_tpu's GroundingDataset.sample_negative_window makes."""
        cfg = self.cfg
        ex = self.examples[index]
        stride = self.stride
        _, motion = self.video_features(ex.clip_id)
        ctx_l = len(motion)
        n_win = math.ceil(ctx_l / stride) + 1
        start = min(ctx_l, ex.timestamps[0] / cfg.clip_length)
        end = min(ctx_l, ex.timestamps[1] / cfg.clip_length)
        pos_ids = np.arange(math.floor(start / stride), math.ceil(end / stride) + 1)
        neg_pool = sorted(set(range(n_win)) - set(pos_ids.tolist()))
        if not neg_pool:
            raise ValueError(f"{ex.query_id}: no negative window")
        nidx = int(neg_pool[rng.integers(len(neg_pool))])
        n_start = max((nidx - 1) * stride, 0)
        n_end = min((nidx - 1) * stride + cfg.max_v_l, ctx_l)
        sl = motion[n_start:n_end]
        out = np.zeros((cfg.max_v_l, motion.shape[1]), np.float32)
        out[: len(sl)] = sl
        m = np.zeros(cfg.max_v_l, np.float32)
        m[: len(sl)] = 1
        return out, m

    def sample_train(self, index: int, rng: np.random.Generator) -> dict:
        """One training example -> a dict of fixed-shape numpy arrays."""
        cfg = self.cfg
        ex = self.examples[index]
        stride = self.stride
        tok, cls = self.query_features(ex.query_id)
        appear, motion = self.video_features(ex.clip_id)
        ctx_l = len(appear)
        n_win = math.ceil(ctx_l / stride) + 1

        start = min(ctx_l, ex.timestamps[0] / cfg.clip_length)
        end = min(ctx_l, ex.timestamps[1] / cfg.clip_length)
        if not start < end:
            raise ValueError(f"{ex.query_id}: empty GT span ({start}, {end}) in clips")
        pos_ids = np.arange(math.floor(start / stride), math.ceil(end / stride) + 1)
        neg_pool = sorted(set(range(n_win)) - set(pos_ids.tolist()))
        if not neg_pool:
            raise ValueError(f"{ex.query_id}: no negative window")

        idx = gaussian_window_choice(pos_ids, rng)
        w_start = max((idx - 1) * stride, 0)
        w_end = min((idx - 1) * stride + cfg.max_v_l, ctx_l)
        w_len = w_end - w_start

        # window-local GT span, normalized cxw over the window length
        start_pos = max((idx - 1) * stride, start) - w_start
        end_pos = min((idx - 1) * stride + cfg.max_v_l, end) - w_start
        st_n, ed_n = start_pos / w_len, end_pos / w_len
        span = np.array([(st_n + ed_n) / 2, ed_n - st_n], np.float32)

        # saliency frames
        rel = list(range(math.floor(start_pos), math.ceil(end_pos))) or [math.floor(start_pos)]
        easy_neg = sorted(set(range(w_len)) - set(rel)) or [0]
        sal_pos = int(rng.choice(rel))
        sal_neg = int(rng.choice(easy_neg))

        # negative window
        nidx = int(neg_pool[rng.integers(len(neg_pool))])
        n_start = max((nidx - 1) * stride, 0)
        n_end = min((nidx - 1) * stride + cfg.max_v_l, ctx_l)

        def pad_v(x):
            out = np.zeros((cfg.max_v_l, x.shape[1]), np.float32)
            out[: len(x)] = x
            m = np.zeros(cfg.max_v_l, np.float32)
            m[: len(x)] = 1
            return out, m

        pos_motion, pos_mask = pad_v(motion[w_start:w_end])
        pos_appear, _ = pad_v(appear[w_start:w_end])
        neg_motion, neg_mask = pad_v(motion[n_start:n_end])
        neg_appear, _ = pad_v(appear[n_start:n_end])

        q = np.zeros((cfg.max_q_l, tok.shape[1]), np.float32)
        q[: len(tok)] = tok
        q_mask = np.zeros(cfg.max_q_l, np.float32)
        q_mask[: len(tok)] = 1
        if cfg.txt_drop_ratio > 0:
            # zero round(L * ratio) random token rows (train-time text dropout,
            # cone/config.py:113-114, Moment-DETR's random_drop_rows); the mask
            # stays 1: rows are blanked, not removed
            n_drop = round(len(tok) * cfg.txt_drop_ratio)
            if n_drop > 0:
                q[rng.choice(len(tok), size=n_drop, replace=False)] = 0.0

        span_labels = np.zeros((cfg.max_windows, 2), np.float32)
        span_labels[0] = span
        span_mask = np.zeros(cfg.max_windows, np.float32)
        span_mask[0] = 1
        return dict(
            query_tokens=q, query_mask=q_mask, query_cls=cls,
            pos_motion=pos_motion, pos_appear=pos_appear, pos_mask=pos_mask,
            neg_motion=neg_motion, neg_appear=neg_appear, neg_mask=neg_mask,
            span_labels=span_labels, span_mask=span_mask,
            prop_start=np.int32(math.floor(start_pos)),
            prop_end=np.int32(math.ceil(end_pos)),
            sal_pos=np.array([sal_pos], np.int32),
            sal_neg=np.array([sal_neg], np.int32),
            video_start=np.int32(w_start), video_length=np.int32(w_len),
        )


class TrainLoader:
    """Shuffled, seeded epoch iterator of stacked fixed-shape batches; the
    ragged tail is dropped so every step has the same shape.

    Seeding contract: the epoch's order comes from
    default_rng((seed, epoch)) and each sample from its own
    default_rng((seed, epoch, example index)), so any row block of a batch
    can be built alone and equals the rows of a whole-batch build."""

    def __init__(self, dataset: GroundingDataset, bsz: int, seed: int = 2018):
        self.ds = dataset
        self.bsz = bsz
        self.seed = seed

    def steps_per_epoch(self):
        return len(self.ds) // self.bsz

    def epoch(self, epoch_i: int, lo: int = 0, hi: Optional[int] = None):
        """Yield this epoch's batches; `lo:hi` builds only that row slice of
        each batch."""
        order = np.random.default_rng((self.seed, epoch_i)).permutation(len(self.ds))
        for b in range(self.steps_per_epoch()):
            idxs = order[b * self.bsz : (b + 1) * self.bsz][lo:hi]
            if not len(idxs):
                raise ValueError(f"empty batch slice {lo}:{hi} of bsz {self.bsz}")
            samples = [self.ds.sample_train(
                int(i), np.random.default_rng((self.seed, epoch_i, int(i)))) for i in idxs]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
