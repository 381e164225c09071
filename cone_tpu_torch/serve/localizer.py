"""Online serving: raw feature arrays in, ranked moments out.

Counterpart of run_on_video/cone_localizator.py: no Dataset/DataLoader. One
call takes a video's clip features and a query's token/CLS features and
returns the top moments. It reuses the batched inference pipeline, so all
top-k windows go through ONE forward.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from cone_tpu_torch.config import ConeConfig
from cone_tpu_torch.data.dataset import GroundingDataset, QueryExample
from cone_tpu_torch.data.store import InMemoryArrayStore, TextFeatureStore
from cone_tpu_torch.eval.pipeline import make_pipeline


class OnlineLocalizer:
    def __init__(self, model, cfg: ConeConfig, device="cuda"):
        self.cfg = cfg
        # bootstrap the pipeline with a placeholder dataset; per-request
        # datasets are swapped in (shapes depend on the config only)
        ds = self._make_ds(
            np.zeros((2, cfg.model.v_appear_feat_dim), np.float32),
            np.zeros((1, cfg.model.t_feat_dim), np.float32),
            # cls = matching-branch feature: appearance dim, not token dim
            np.zeros((cfg.model.v_appear_feat_dim,), np.float32),
            "warmup",
        )
        self.pipe = make_pipeline(model, ds, cfg, device=device)

    def _make_ds(self, video_feats, token_feats, cls_feat, query: str):
        cfg = self.cfg
        ex = QueryExample(
            query_id="q0", query=query, video_id="v0", clip_id="v0",
            timestamps=[0.0, 0.0],
            duration=len(video_feats) * cfg.data.clip_length,
        )
        text = TextFeatureStore(
            InMemoryArrayStore({"q0": np.asarray(token_feats, np.float32)}),
            InMemoryArrayStore({"q0": np.asarray(cls_feat, np.float32)[None]}),
        )
        return GroundingDataset(
            [ex], InMemoryArrayStore({"v0": np.asarray(video_feats, np.float32)}),
            text, cfg.data,
        )

    def localize(
        self,
        video_feats: np.ndarray,   # (L, D) clip features
        token_feats: np.ndarray,   # (Lq, Dt) query token features
        cls_feat: np.ndarray,      # (Dt,) holistic query feature
        query: str = "",
        top_k: Optional[int] = None,
    ) -> List[List[float]]:
        """Returns up to max_after_nms moments [st_sec, ed_sec, prop_score,
        match_score, fusion_score], fusion-ranked (cone_localizator.py:200-219)."""
        return self.localize_ranked(video_feats, token_feats, cls_feat, query, top_k)[0]

    def localize_ranked(self, video_feats, token_feats, cls_feat, query: str = "",
                        top_k: Optional[int] = None) -> Tuple[List[List[float]], List[int]]:
        """(moments as `localize` returns them, the coarse stage's window
        ranklist)."""
        assert len(video_feats) <= self.cfg.data.max_ctx_l, (
            f"video too long: {len(video_feats)} > max_ctx_l="
            f"{self.cfg.data.max_ctx_l}"
        )
        # long queries truncate like the dataset path (tokenizers cap at
        # max_q_l); without this a long query dies deep in the pipeline
        # with an opaque broadcast error
        token_feats = np.asarray(token_feats)[: self.cfg.data.max_q_l]
        # the resident videos key by clip_id ("v0" every request): reset them
        # so a new request never reuses the previous video's features
        self.pipe.reset(self._make_ds(video_feats, token_feats, cls_feat, query))
        subs, ranklists = self.pipe.run(host_postproc=True)
        times = subs["fusion"][0]["predicted_times"]
        return (times[:top_k] if top_k is not None else times), list(ranklists["q0"])
