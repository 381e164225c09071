"""Corpus-level moment retrieval: one query searched across EVERY resident
video.

The reference (and the per-video pipeline) always grounds a query in the
video named by its annotation (`clip_id`). With the corpus resident on the
device (eval/resident.py, optionally quantized via eval.corpus_dtype),
cross-video search is the same machinery pointed at all videos at once:

  1. coarse: the query's CLS feature scores every window of every resident
     video (one batched product + segment max per ctx bucket over the
     stacked corpus; all of them issued before one transfer to the host);
  2. global merge: top `search_windows` (video, window) pairs by coarse
     score across the whole corpus (host, tiny);
  3. fine: exactly the selected windows, gathered out of the stacked corpus
     and packed across videos and queries, through the pipeline's
     window-level fine forward (`_fine_windows`, which the per-video
     `_fine` runs too);
  4. post: reference-semantics scoring per video (min-max fusion over the
     query's candidate set, NMS *within* each video, since temporal IoU
     across videos means nothing), then one global ranking by fusion score.

No reference counterpart (cone/inference.py grounds per annotation); the
scoring math inside each stage is the per-video pipeline's, tested against
the reference. Results: [video_id, st, ed, prop, match, fusion].

A library sharded over ranks (parallel/distributed.py, one process per
device): each rank adds only its own movies and scans only those; the
per-query top-k (score, video, window) triples merge across ranks under the
same total order as one process, each rank fine-runs only its own chosen
windows, and the candidate rows merge before the min-max fusion, so every
rank returns the identical corpus-wide ranking, equal to one retriever
holding the whole library (cone_tpu/serve/corpus.py:551-557).
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from cone_tpu_torch.config import ConeConfig
from cone_tpu_torch.data.dataset import GroundingDataset
from cone_tpu_torch.data.store import (
    InMemoryArrayStore,
    PackedArrayStore,
    TextFeatureStore,
    write_packed_store,
)
from cone_tpu_torch.eval.pipeline import _fetch, make_pipeline
from cone_tpu_torch.ops.nms import temporal_nms_host
from cone_tpu_torch.ops.windows import coarse_window_scores, num_windows, slice_windows_flat
from cone_tpu_torch.parallel import distributed
from cone_tpu_torch.utils.io import l2_normalize, min_max_normalize
from cone_tpu_torch.utils.trace import span


class CorpusRetriever:
    """Search one query, or a batch, against all resident videos.

    Built on a dedicated `InferencePipeline`; video features upload once
    (encoded per eval.corpus_dtype, stacked per ctx bucket) and are shared
    across searches. `fine_chunk` bounds one fine dispatch to
    fine_chunk x data.topk_window windows (a batch's worth of fine work):
    each query's chosen windows, over every video they lie in, pack into as
    few dispatches of its own as that allows, with no padded slot.
    """

    def __init__(self, model, cfg: ConeConfig,
                 dataset: Optional[GroundingDataset] = None,
                 fine_chunk: int = 8, device="cuda"):
        self.cfg = cfg
        self.fine_chunk = fine_chunk
        ds = dataset if dataset is not None else self._empty_ds()
        self.pipe = make_pipeline(model, ds, cfg, device=device)
        self.clip_ids: List[str] = (
            sorted({e.clip_id for e in ds.examples}) if dataset is not None
            else []
        )
        if dataset is not None:
            # also admit videos the dataset knows but no example references
            try:
                self.clip_ids = sorted(set(self.clip_ids)
                                       | set(ds.appear.keys()))
            except (AttributeError, TypeError):
                pass
        self._stacked = None  # {bucket_len: (ids, ctx_ls, DeviceVideo stack)}
        self._row_of: Dict[str, tuple] = {}
        # the fine stage's work since construction (MomentService /stats
        # "fine"): windows refined and dispatches; every row of a dispatch is
        # a real window, none padded; host integers, no device sync
        self.fine_windows = self.fine_dispatches = 0

    def _empty_ds(self):
        text = TextFeatureStore(InMemoryArrayStore({}), InMemoryArrayStore({}))
        return GroundingDataset([], InMemoryArrayStore({}), text,
                                self.cfg.data)

    # -------------------------------------------------------------- corpus

    def _invalidate(self, clip_id: str) -> None:
        self.pipe.resident.drop(clip_id)
        self._stacked = None  # rebuild the stacked corpus lazily

    def add_video(self, clip_id: str, feats: np.ndarray,
                  motion_feats: Optional[np.ndarray] = None) -> None:
        """Add/replace one video's (L, D) clip features; uploads (encoded
        per eval.corpus_dtype) on first use. Features are L2-normalized
        like the dataset path (data/dataset.py video_features).

        `motion_feats` supplies the Moment-DETR branch's stream for
        dual-stream corpora (same_visual=False datasets); omitted, the
        appearance features serve both branches."""
        ap = np.asarray(feats, np.float32)
        if self.cfg.data.normalize_v:
            ap = l2_normalize(ap)
        if motion_feats is None:
            mo = ap
        else:
            mo = np.asarray(motion_feats, np.float32)
            assert len(mo) == len(ap), (clip_id, len(ap), len(mo))
            if self.cfg.data.normalize_v:
                mo = l2_normalize(mo)
        self.pipe.ds.pin_video(clip_id, ap, mo)  # eviction-exempt: no store
        self._invalidate(clip_id)
        if clip_id not in self.clip_ids:
            self.clip_ids.append(clip_id)

    def append_video(self, clip_id: str, feats: np.ndarray,
                     motion_feats: Optional[np.ndarray] = None) -> int:
        """Streaming ingest: extend a RESIDENT video's timeline with new
        (L_new, D) clip features (a live feed growing between searches).
        Bit-identical to add_video() of the full concatenation: only the
        new rows normalize, the grown video re-encodes and re-uploads lazily
        on the next search, and every earlier moment keeps its timestamps
        (windows are anchored at the video start). Returns the new length."""
        ap_old, mo_old = self.pipe.ds.video_features(clip_id)
        dual = mo_old is not ap_old
        assert not (dual and motion_feats is None), (
            f"{clip_id} is dual-stream: append needs motion_feats")
        ap_new = np.asarray(feats, np.float32)
        if self.cfg.data.normalize_v:
            ap_new = l2_normalize(ap_new)
        ap = np.concatenate([ap_old, ap_new])
        if dual or motion_feats is not None:
            mo_new = np.asarray(motion_feats, np.float32)
            assert len(mo_new) == len(ap_new), (clip_id, len(ap_new),
                                                len(mo_new))
            if self.cfg.data.normalize_v:
                mo_new = l2_normalize(mo_new)
            mo = np.concatenate([mo_old, mo_new])
        else:
            mo = ap
        assert len(ap) <= self.cfg.data.max_ctx_l, (
            f"{clip_id} grew past data.max_ctx_l "
            f"({len(ap)} > {self.cfg.data.max_ctx_l})")
        self.pipe.ds.pin_video(clip_id, ap, mo)
        self._invalidate(clip_id)
        return len(ap)

    def remove_video(self, clip_id: str) -> None:
        """Evict one video from the serving library (its share of device
        memory is reclaimed at the next search's lazy restack). Raises
        ValueError for ids not in the library. A dataset-backed video is
        only evicted from the LIBRARY: the backing store is untouched."""
        self.clip_ids.remove(clip_id)
        self.pipe.ds.evict_video(clip_id)
        self._invalidate(clip_id)

    def total_clips(self) -> int:
        """Clips of the library's videos whose features the dataset holds
        (MomentService /stats "total_clips")."""
        return self.pipe.resident.resident_clips(self.clip_ids)

    def save_corpus(self, dir_path: str) -> int:
        """Persist the resident library to packed .cfs stores
        (`appearance.cfs` + `motion.cfs` when dual-stream) so a server
        restart, or another replica, rebuilds it with load_corpus().
        Live-ingested videos (add_video/append_video) have no backing
        store; this is their durability path. Stored features are the
        normalized resident arrays, so the reload is bit-exact."""
        appear, motion = {}, {}
        for cid in self.clip_ids:
            ap, mo = self.pipe.ds.video_features(cid)
            appear[cid] = ap
            if mo is not ap:  # only truly dual videos carry a motion row;
                motion[cid] = mo  # single-stream ones reload as one array
        os.makedirs(dir_path, exist_ok=True)
        write_packed_store(os.path.join(dir_path, "appearance.cfs"), appear)
        if motion:
            write_packed_store(os.path.join(dir_path, "motion.cfs"), motion)
        return len(appear)

    def load_corpus(self, dir_path: str) -> int:
        """Rebuild a save_corpus() library: every stored video pins into
        the dataset cache exactly as saved (no re-normalization) and
        uploads lazily on the next search."""
        ap_store = PackedArrayStore(os.path.join(dir_path, "appearance.cfs"))
        mo_path = os.path.join(dir_path, "motion.cfs")
        mo_store = PackedArrayStore(mo_path) if os.path.exists(mo_path) else None
        for cid in sorted(ap_store.keys()):
            ap = np.ascontiguousarray(ap_store.get(cid), dtype=np.float32)
            mo = (np.ascontiguousarray(mo_store.get(cid), dtype=np.float32)
                  if mo_store is not None and cid in mo_store else ap)
            self.pipe.ds.pin_video(cid, ap, mo)
            self._invalidate(cid)
            if cid not in self.clip_ids:
                self.clip_ids.append(cid)
        return len(list(ap_store.keys()))

    # -------------------------------------------------------------- search

    def rank_videos(self, cls_feat: np.ndarray) -> List[tuple]:
        """Coarse-only corpus ranking: [(video_id, best_window_score)]
        descending. This is the retrieval signal (query-frame cosine via
        the trained adapter, cone/inference.py:276-299 generalized across
        videos); the fine stage refines *moments* within the shortlist."""
        scored = self._coarse_all(np.asarray(cls_feat, np.float32)[None])
        best = [
            (cid, float(np.max(scores[0][:num_windows(ctx_l, self.pipe.stride)])))
            for cid, ctx_l, scores in scored
        ]
        return sorted(distributed.all_gather_rows(best), key=lambda kv: -kv[1])

    def _ensure_stacked(self):
        """Group the corpus by padded bucket length into one stack a bucket
        (`ResidentVideos.stack`). The per-video device copies are dropped
        afterwards: the stack IS the resident corpus, and the fine stage
        slices its shortlisted movies back out of it. (The pipeline's own
        stack cache fills only in run_fused, which the retriever never
        calls, so the corpus is held once.)"""
        if self._stacked is not None:
            return self._stacked
        # a rank of a group may hold no shard (more ranks than movies), but
        # it still takes part in every merge
        assert self.clip_ids or distributed.world_size() > 1, \
            "corpus is empty: add_video() first"
        resident = self.pipe.resident
        by_bucket: Dict[int, List[str]] = {}
        for cid in self.clip_ids:
            by_bucket.setdefault(resident.get(cid).appear.shape[0], []).append(cid)
        stacked = {l_pad: (ids, [resident.get(c).ctx_l for c in ids], resident.stack(ids))
                   for l_pad, ids in sorted(by_bucket.items())}
        resident.clear()
        self._stacked = stacked
        # movie -> (its bucket, its row in the bucket's stack)
        self._row_of = {cid: (l_pad, i) for l_pad, (ids, *_) in stacked.items()
                        for i, cid in enumerate(ids)}
        return stacked

    @torch.inference_mode()
    @span("corpus.scan")
    def _coarse_all(self, cls_feats: np.ndarray):
        """(video_id, ctx_l, (Q, n_w) window scores) for every resident
        video: per ctx bucket, the pipeline's own decode + adapter (gated
        on the family's knob) + renormalize and ONE batched product over
        the stacked bucket for the whole query batch, then the per-window
        max; one transfer to the host. The (V, Q, Lb) frame scores never
        leave the device."""
        pipe = self.pipe
        clss = np.asarray(cls_feats, np.float32)
        norms = np.maximum(np.linalg.norm(clss, axis=-1, keepdims=True), 1e-12)
        clss_t = torch.from_numpy(np.ascontiguousarray(clss / norms)).to(pipe.device)
        pend = []
        for ids, ctxs, (A, S, _, _, ctx) in self._ensure_stacked().values():
            # the adapted bucket is a temporary: freed before the next bucket's
            scores, _ = coarse_window_scores(pipe._adapt(pipe.resident.decode(A, S)), clss_t,
                                             ctx, pipe.stride, num_windows(A.shape[1], pipe.stride))
            pend.append((ids, ctxs, (scores,)))
        fetched = _fetch([p[2] for p in pend])
        out = []
        for (ids, ctxs, _), (scores,) in zip(pend, fetched):
            out.extend((cid, ctx_l, scores[i])
                       for i, (cid, ctx_l) in enumerate(zip(ids, ctxs)))
        return out

    def search(self, token_feats: np.ndarray, cls_feat: np.ndarray,
               query: str = "", search_windows: Optional[int] = None,
               top_moments: int = 10,
               adaptive_margin: Optional[float] = None) -> List[Dict]:
        """Rank moments for ONE query across the whole corpus (see
        search_batch). token_feats: (Lq, Dt); cls_feat: (Dt,)."""
        return self.search_batch(
            [token_feats], np.asarray(cls_feat, np.float32)[None],
            queries=[query], search_windows=search_windows,
            top_moments=top_moments, adaptive_margin=adaptive_margin,
        )[0]

    @torch.inference_mode()
    def search_batch(self, token_feats_list, cls_feats: np.ndarray,
                     queries: Optional[List[str]] = None,
                     search_windows: Optional[int] = None,
                     top_moments: int = 10,
                     adaptive_margin: Optional[float] = None) -> List[List[Dict]]:
        """Rank moments for a BATCH of queries across the whole corpus.

        All queries share the per-bucket coarse scans (the pass over the
        resident corpus is paid once per batch, not per query), and the
        fine stage runs each query's chosen windows, whatever movie they
        lie in, packed into dispatches of its own of at most fine_chunk x
        topk_window windows, so a query's answer does not depend on the
        batch it came in.

        Args:
            token_feats_list: Q arrays of (Lq_i, Dt) query token features.
            cls_feats: (Q, Dt) holistic query features.
            search_windows: corpus-wide window budget per query (default:
                data.topk_window, the per-video budget).
            top_moments: moments returned per query.
            adaptive_margin: optional per-query budget shrink: only
                windows with coarse score >= (query's best - margin)
                refine, so concentrated queries cost a fraction of the
                budget. None (default) keeps the fixed-budget semantics.

        Returns: per query, a list of dicts {video_id, span (st, ed),
        prop, match, fused}, fusion-ranked across videos.
        """
        nq = len(token_feats_list)
        queries = queries or [""] * nq
        k = self.cfg.data.topk_window if search_windows is None else search_windows
        clss = np.asarray(cls_feats, np.float32)
        clss = clss / np.maximum(
            np.linalg.norm(clss, axis=-1, keepdims=True), 1e-12)

        # stage 1: every bucket scanned once for the whole query batch
        scored = self._coarse_all(clss)

        # stage 2: per-query global top-k (video, window) merge, vectorized
        with span("corpus.merge"):
            cols_scores, col_cid, col_w = [], [], []
            for cid, ctx_l, scores in scored:  # scores: (Q, n_w_padded)
                n_win = num_windows(ctx_l, self.pipe.stride)
                cols_scores.append(np.asarray(scores[:, :n_win]))
                col_cid.extend([cid] * n_win)
                col_w.extend(range(n_win))
            S = (np.concatenate(cols_scores, axis=1) if cols_scores
                 else np.zeros((nq, 0), np.float32))  # (Q, W_total)
            col_w = np.asarray(col_w)
            col_cid_arr = np.asarray(col_cid)
            kth = min(k, S.shape[1])
            # deterministic top-k under the (score desc, video, window) TOTAL
            # order: coarse scores tie exactly whenever 50%-overlapping windows
            # share their segment-max frame, so an argpartition-only cut would
            # pick arbitrary tie members, and a sharded library would disagree
            # with the whole one. argpartition to a 4x margin first (tie groups
            # are about 2-3 wide), then lexsort just the margin. The local top-k
            # holds this rank's part of the global one; the ranks' triples merge
            # under the same order.
            payload = []
            for qi in range(nq):
                if kth:
                    m = min(S.shape[1], max(4 * kth, kth + 64))
                    part = (np.argpartition(-S[qi], m - 1)[:m]
                            if m < S.shape[1] else np.arange(S.shape[1]))
                    order = part[np.lexsort(
                        (col_w[part], col_cid_arr[part], -S[qi, part]))]
                    sel = order[:kth]
                else:
                    sel = np.zeros(0, np.int64)
                payload.append([(float(S[qi, c]), col_cid[c], int(col_w[c])) for c in sel])
            gathered = distributed.all_gather_obj(payload)
            mine = set(self.clip_ids)
            chosen: List[Dict[str, List[int]]] = [dict() for _ in range(nq)]
            for qi in range(nq):
                merged = sorted((t for g in gathered for t in g[qi]),
                                key=lambda t: (-t[0], t[1], t[2]))[:k]
                if adaptive_margin is not None and merged:
                    # per-query adaptive budget: drop windows whose coarse score
                    # trails the query's best by more than the margin, so the
                    # fine stage scales with how concentrated the coarse signal
                    # is. The fusion min-max then normalizes over the surviving
                    # candidate set: an intentional difference from the
                    # fixed-budget reference scheme, opt-in per request.
                    floor = merged[0][0] - adaptive_margin
                    merged = [t for t in merged if t[0] >= floor]
                for _, cid, w in merged:
                    if cid in mine:
                        chosen[qi].setdefault(cid, []).append(int(w))

        # stage 3: fine over exactly the chosen windows. One row a real
        # (movie, query, window) triple. Each query's triples, in the order
        # it reached its movies and then window order, sort by ctx bucket and
        # cut into dispatches of at most fine_chunk x topk_window windows,
        # each one gather per bucket straight out of the resident stack and
        # one fine forward. A query never shares a dispatch, so its answer
        # runs the same shapes alone or in any batch; all are launched
        # before the one transfer to the host
        with span("corpus.fine"):
            stacked = self._ensure_stacked()
            toks = np.zeros((nq, self.cfg.data.max_q_l, self.cfg.model.t_feat_dim), np.float32)
            tmask = np.zeros((nq, self.cfg.data.max_q_l), np.float32)
            for qi, tok in enumerate(token_feats_list):
                n_tok = min(len(tok), self.cfg.data.max_q_l)
                toks[qi, :n_tok] = tok[:n_tok]
                tmask[qi, :n_tok] = 1
            query_rows = [self.pipe._to_device(x) for x in (toks, tmask, clss)]
            cap = self.fine_chunk * self.cfg.data.topk_window
            fine_pend = []
            for qi, ch in enumerate(chosen):
                wins = sorted(((cid, qi, w) for cid, ws in ch.items() for w in ws),
                              key=lambda t: self._row_of[t[0]][0])
                for d in range(0, len(wins), cap):
                    part = wins[d : d + cap]
                    fine_pend.append((part, self._fine_packed(stacked, part, *query_rows)))
            self.fine_windows += sum(len(part) for part, _ in fine_pend)
            self.fine_dispatches += len(fine_pend)
            fine_res = _fetch([f[1] for f in fine_pend])

        # stage 4: reference-semantics post-processing, per query
        with span("corpus.post"):
            at = {t: (res, r) for (part, _), res in zip(fine_pend, fine_res)
                  for r, t in enumerate(part)}
            rows: List[List[list]] = [[] for _ in range(nq)]
            # a query's rows movie by movie (first reached by the batch first),
            # then window order. A fine stage with empty candidate slots
            # (2D-TAN's within-window NMS) marks them in a 4th output,
            # cand_valid; cone_tpu's retriever ignores the mark, so the
            # suppressed cells in those slots stay candidates here
            for cid in dict.fromkeys(cid for ch in chosen for cid in ch):
                for qi, ch in enumerate(chosen):
                    for w in ch.get(cid, ()):
                        (spans_sec, prob, match, *_), r = at[(cid, qi, w)]
                        for p in range(prob.shape[1]):
                            rows[qi].append(
                                [cid, float(f"{spans_sec[r, p, 0]:.4f}"),
                                 float(f"{spans_sec[r, p, 1]:.4f}"),
                                 float(f"{prob[r, p]:.4f}"),
                                 float(f"{match[r, p]:.4f}")])
            # the min-max fusion must see the query's corpus-wide candidate set
            parts = distributed.all_gather_obj(rows)
            rows = [[r for g in parts for r in g[qi]] for qi in range(nq)]
            return [
                self._postprocess(rows[qi], queries[qi], top_moments)
                for qi in range(nq)
            ]

    def _fine_packed(self, stacked, wins, toks, tmask, cls):
        """One fine dispatch over `wins`, (movie, query, window) triples
        sorted by ctx bucket: per bucket one gather of its windows out of
        the stacked corpus (decoded after the gather), the buckets' windows
        concatenated, each window given its query's rows of the device
        (Q, ...) toks/tmask/cls. Returns the family's fine outputs, one row
        a triple, unfetched."""
        pipe, resident = self.pipe, self.pipe.resident
        video, win_idx, qidx = pipe._to_device(np.asarray(
            [(self._row_of[cid][1], w, qi) for cid, qi, w in wins], np.int64).T)
        parts, lo = [], 0
        for l_pad, grp in itertools.groupby(self._row_of[cid][0] for cid, _, _ in wins):
            hi = lo + len(list(grp))
            A, S, M, MS, ctx = stacked[l_pad][2]
            v = video[lo:hi]
            same = M is A  # single-stream: one gather
            (a, a_s, *mo), wmask, wstart, wlen = slice_windows_flat(
                (A, S) if same else (A, S, M, MS), v, win_idx[lo:hi], ctx[v], pipe.stride,
                self.cfg.data.max_v_l)
            ap = resident.decode(a, a_s)
            parts.append((ap, ap if same else resident.decode(*mo), wmask, wstart, wlen))
            lo = hi

        def cat(j):
            return parts[0][j] if len(parts) == 1 else torch.cat([p[j] for p in parts])

        ap = cat(0)
        mo = ap if all(p[1] is p[0] for p in parts) else cat(1)
        return pipe._fine_windows(ap, mo, cat(2), cat(3), cat(4), toks, tmask, cls,
                                  lambda x: x[qidx])

    def _postprocess(self, rows, query: str, top_moments: int) -> List[Dict]:
        """Min-max fusion over one query's corpus-wide candidate set, NMS
        within each video, one global fusion ranking (the per-video
        pipeline's reference semantics extended across videos)."""
        if not rows:
            return []
        prop_n = min_max_normalize([r[3] for r in rows])
        match_n = min_max_normalize([r[4] for r in rows])
        fused = [p + m for p, m in zip(prop_n, match_n)]

        by_vid: Dict[str, List] = {}
        for r, f in zip(rows, fused):
            by_vid.setdefault(r[0], []).append([r[1], r[2], f, r[3], r[4]])
        out = []
        for cid, moments in by_vid.items():
            moments.sort(key=lambda m: -m[2])
            kept = temporal_nms_host(
                [m[:3] for m in moments][: self.cfg.eval.max_before_nms],
                self.cfg.eval.nms_thd, top_moments,
                hull_union=self.pipe.nms_hull,
            )
            scores = {(m[0], m[1]): (m[3], m[4], m[2]) for m in moments}
            for st, ed, f in kept:
                pr, ma, fu = scores[(st, ed)]
                out.append(dict(video_id=cid, span=(st, ed), prop=pr,
                                match=ma, fused=fu, query=query))
        out.sort(key=lambda d: -d["fused"])
        return out[:top_moments]
