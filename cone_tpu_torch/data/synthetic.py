"""Synthetic grounding data with a planted signal: clips inside each GT
moment point toward the query's CLS direction, so the coarse ranking has
real structure. Same generator, same seed -> same arrays as the JAX
package's `make_synthetic_dataset`."""

from __future__ import annotations

import numpy as np

from cone_tpu_torch.config import DataConfig
from cone_tpu_torch.data.dataset import GroundingDataset, QueryExample
from cone_tpu_torch.data.store import InMemoryArrayStore, TextFeatureStore
from cone_tpu_torch.utils.io import l2_normalize


def make_synthetic_dataset(
    cfg: DataConfig,
    n_videos: int = 4,
    queries_per_video: int = 3,
    ctx_l_range=(200, 400),
    dim: int = 64,
    txt_dim: int = None,
    q_len_range=(5, 13),
    signal: float = 1.0,
    seed: int = 0,
) -> GroundingDataset:
    """An in-memory GroundingDataset. txt_dim defaults to `dim` (the
    matching branch needs text CLS dim == appearance dim)."""
    txt_dim = txt_dim or dim
    if txt_dim != dim:
        raise ValueError("matching branch needs text dim == appearance dim")
    rng = np.random.default_rng(seed)
    vids, toks, clss, examples = {}, {}, {}, []
    for v in range(n_videos):
        vid = f"video_{v}"
        ctx_l = int(rng.integers(*ctx_l_range))
        feats = rng.normal(size=(ctx_l, dim)).astype(np.float32)
        for q in range(queries_per_video):
            qid = f"{vid}_q{q}"
            cls_dir = rng.normal(size=dim).astype(np.float32)
            cls_dir /= np.linalg.norm(cls_dir)
            # GT moment away from the edges so a negative window exists
            dur_clips = int(rng.integers(4, max(5, cfg.max_v_l // 2)))
            st = int(rng.integers(0, max(1, ctx_l - dur_clips - cfg.max_v_l)))
            ed = st + dur_clips
            feats[st:ed] += signal * cls_dir
            tok_len = int(rng.integers(*q_len_range))
            toks[qid] = rng.normal(size=(tok_len, txt_dim)).astype(np.float32)
            clss[qid] = cls_dir[None]
            examples.append(QueryExample(
                query_id=qid, query=f"synthetic query {qid}", video_id=vid,
                clip_id=vid,
                timestamps=[st * cfg.clip_length, ed * cfg.clip_length],
                duration=ctx_l * cfg.clip_length,
            ))
        vids[vid] = l2_normalize(feats)

    text = TextFeatureStore(InMemoryArrayStore(toks), InMemoryArrayStore(clss))
    return GroundingDataset(examples, InMemoryArrayStore(vids), text, cfg)
