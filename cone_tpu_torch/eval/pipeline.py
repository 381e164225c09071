"""Coarse-to-fine inference pipeline (cone/inference.py:227-331) on torch.

  coarse:  adapted = adapter(feats) + feats, renormalized
           per-window max similarity: the hand-written segment-max kernel
           (eval.use_pallas_coarse) or the plain matmul + segment max
           ranklist = stable descending argsort of the window scores
  fine:    gather the top-K windows of every query of a chunk and run ONE
           Moment-DETR forward over all of them
  post:    the reference-exact host path (decimal rounding, dict dedup,
           numpy NMS) or the batched device path (fusion + dedup + NMS)

Videos pad to data.max_ctx_l (or the smallest eval.ctx_buckets entry that
fits). The fused path runs `eval.video_batch` (video, query-chunk) work
items per dispatch along a leading video axis, with every step on the
device and no host synchronisation until one transfer at the end.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from cone_tpu_torch.config import ConeConfig
from cone_tpu_torch.data.dataset import GroundingDataset
from cone_tpu_torch.data.prefetch import prefetch_iterator
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.ops.coarse import coarse_segment_max, window_scores_from_segment_max
from cone_tpu_torch.ops.nms import (
    _take,
    dedup_spans_device,
    temporal_nms_device,
    temporal_nms_host,
)
from cone_tpu_torch.ops.spans import round4_device, span_cxw_to_xx
from cone_tpu_torch.ops.windows import (
    num_windows,
    slice_windows,
    window_scores_from_frame_scores,
)
from cone_tpu_torch.utils.device import resolve_device
from cone_tpu_torch.utils.io import min_max_normalize

MODALITIES = ("fusion", "proposal", "matching")


def _minmax(x, valid):
    """Min-max normalize over each row's valid entries; rows whose valid
    range is empty or constant pass through unchanged."""
    lo = torch.where(valid, x, 1e30).amin(-1, keepdim=True)
    hi = torch.where(valid, x, -1e30).amax(-1, keepdim=True)
    rng = hi - lo
    return torch.where(rng > 0, (x - lo) / torch.where(rng == 0, 1.0, rng), x)


def _fetch(trees):
    """Move a list of tuples of device tensors to the host in ONE transfer:
    every tensor flattens into one float32 buffer (the integer and bool
    outputs here are small counts, exact in float32) and is cut back out on
    the host. Returns the same structure of numpy arrays."""
    flat = [t for tree in trees for t in tree]
    if not flat:
        return []
    host = torch.cat([t.reshape(-1).to(torch.float32) for t in flat]).cpu().numpy()
    out, pos = [], 0
    for tree in trees:
        arrs = []
        for t in tree:
            n = t.numel()
            a = host[pos : pos + n].reshape(tuple(t.shape))
            pos += n
            if t.dtype == torch.bool:
                a = a != 0
            elif not t.dtype.is_floating_point:
                a = a.astype(np.int64)
            arrs.append(a)
        out.append(tuple(arrs))
    return out


class InferencePipeline:
    # IoU convention for NMS: CONE uses the hull union (utils/temporal_nms.py)
    nms_hull: bool = True
    # cache the stacked per-group video tensors across runs; byte-bounded,
    # since entries duplicate the resident corpus on the device
    stack_cache: bool = True
    stack_cache_bytes: int = 2 << 30

    def __init__(self, model: ConeModel, dataset: GroundingDataset,
                 cfg: ConeConfig, device="cuda"):
        if cfg.model.model_family != "cone":
            raise NotImplementedError(
                f"model_family={cfg.model.model_family!r}: the port runs the CONE "
                "family only (2D-TAN is ROADMAP Queue 1 item 10)")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.ds = dataset
        self.cfg = cfg
        self.stride = cfg.data.max_v_l // 2
        self.max_ctx = cfg.data.max_ctx_l
        self.max_w = num_windows(self.max_ctx, self.stride)
        self._dev_cache: dict = {}
        self._stack_cache: dict = {}  # key -> (arrays, nbytes), LRU order

    # ------------------------------------------------------------ device fns

    @staticmethod
    def _decode(x, scale):
        """Corpus features back to fp32: float32/bfloat16 carry no scale;
        int8 carries its per-frame scale (..., L, 1)."""
        x = x.float()
        return x if scale is None else x * scale

    def _adapt(self, feats):
        """Adapter + renormalize for the coarse stage (cone/inference.py:254-258)."""
        if self.cfg.model.adapter_module != "linear":
            return feats
        out = self.model.adapt(feats)
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        return out / torch.where(norm == 0, 1.0, norm)

    def _coarse(self, adapted, ctx, cls):
        """adapted (B, L, D), ctx (B,) int32, cls (B, Q, D) -> ranked window
        ids (B, Q, n_w) and valid window counts (B, Q). n_w follows the
        padded length, so each ctx bucket ranks only its own windows."""
        max_w = num_windows(adapted.shape[1], self.stride)
        if self.cfg.eval.use_pallas_coarse:
            seg = coarse_segment_max(adapted.contiguous(), cls.contiguous(), ctx,
                                     self.stride)
            scores, valid = window_scores_from_segment_max(
                seg, ctx[:, None], self.stride, max_w)
        else:
            frame_scores = cls @ adapted.transpose(1, 2)
            scores, valid = window_scores_from_frame_scores(
                frame_scores, ctx[:, None], self.stride, max_w)
        order = torch.argsort(-scores, dim=-1, stable=True)
        return order, valid.sum(-1)

    def _fine(self, appear, motion, ctx, win_idx, toks, tmask, cls):
        """One forward over every (query, window) pair of the batch.

        appear/motion (B, L, D*), ctx (B,), win_idx (B, Qc, K), toks
        (B, Qc, Lq, Dt), tmask (B, Qc, Lq), cls (B, Qc, D). Returns per
        (B, Qc, K, NQ): proposal spans in seconds ((cxw->xx) * window_len +
        window_start) * clip_length, fg probabilities, matching scores."""
        cfg = self.cfg
        max_v_l = cfg.data.max_v_l
        b, qc, k = win_idx.shape
        ap, wmask, wstart, wlen = slice_windows(appear, win_idx, self.stride, max_v_l, ctx)
        mo = ap if motion is appear else slice_windows(
            motion, win_idx, self.stride, max_v_l, ctx)[0]
        n = b * qc * k

        def rep(x):  # (B, Qc, ...) -> (B*Qc*K, ...), each query K times
            return x[:, :, None].expand(b, qc, k, *x.shape[2:]).reshape(n, *x.shape[2:])

        ap, mo, wmask = (x.reshape(n, *x.shape[3:]) for x in (ap, mo, wmask))
        out = self.model(rep(toks), rep(tmask), mo, wmask)
        prob_fg = torch.softmax(out["pred_logits"], dim=-1)[..., 0]
        matching = self.model.clip_matching_pred(rep(cls), ap, wmask, out["pred_spans"])
        nq = prob_fg.shape[-1]
        xx = span_cxw_to_xx(out["pred_spans"])
        sec = (xx * wlen.reshape(-1)[:, None, None]
               + wstart.reshape(-1)[:, None, None]) * cfg.data.clip_length
        return (sec.reshape(b, qc, k, nq, 2), prob_fg.reshape(b, qc, k, nq),
                matching.reshape(b, qc, k, nq))

    def _fused(self, appear, a_scale, motion, m_scale, ctx, toks, tmask, cls):
        """The whole path for a group of (video, query-chunk) items: decode
        -> adapter -> coarse ranking -> top-K gather -> fine forward ->
        4-dp rounding -> min-max fusion -> dedup -> NMS of the three
        modalities stacked on one batch. Returns (order, win_valid,
        kept_spans (3, B, Qc, K, 2), kept_scores (3, B, Qc, K),
        kept_valid (3, B, Qc, K))."""
        cfg = self.cfg
        same = motion is appear
        appear = self._decode(appear, a_scale)
        motion = appear if same else self._decode(motion, m_scale)
        adapted = self._adapt(appear)
        order, n_valid = self._coarse(adapted, ctx, cls)
        win_idx = order[..., : cfg.data.topk_window]
        win_valid = win_idx < n_valid[..., None]  # ranked ids < n_win
        win_idx = torch.where(win_valid, win_idx, 0)
        spans_sec, prob, match = self._fine(appear, motion, ctx, win_idx, toks, tmask, cls)
        b, qc, k, p = prob.shape
        if not cfg.eval.no_sort_results:
            # the host candidate order: fg-prob descending within each window
            # (cone/inference.py:81-82), so dedup slots and NMS tie-breaks agree
            ordp = torch.argsort(-prob, dim=-1, stable=True)
            spans_sec = _take(spans_sec, ordp, -2)
            prob = torch.gather(prob, -1, ordp)
            match = torch.gather(match, -1, ordp)
        valid = win_valid.repeat_interleave(p, dim=-1)  # (B, Qc, K*P)
        sp = round4_device(spans_sec.reshape(b, qc, k * p, 2))
        pr = round4_device(prob.reshape(b, qc, k * p))
        ma = round4_device(match.reshape(b, qc, k * p))
        fused = _minmax(pr, valid) + _minmax(ma, valid)
        (fused, pr, ma), valid = dedup_spans_device(sp, (fused, pr, ma), valid)
        k_sp, k_sc, k_va = temporal_nms_device(
            sp.expand(3, *sp.shape), torch.stack([fused, pr, ma]),
            valid.expand(3, *valid.shape), cfg.eval.nms_thd,
            cfg.eval.max_after_nms, hull_union=self.nms_hull,
            max_before_nms=cfg.eval.max_before_nms)
        return order, win_valid, k_sp, k_sc, k_va

    def _device_post(self, spans_sec, prop, match, valid):
        """Batched device fusion + dedup + NMS on host-rounded candidates
        (fusion modality only)."""
        ev = self.cfg.eval
        fused = _minmax(prop, valid) + _minmax(match, valid)
        (fused,), dvalid = dedup_spans_device(spans_sec, (fused,), valid)
        return temporal_nms_device(spans_sec, fused, dvalid, ev.nms_thd,
                                   ev.max_after_nms, hull_union=self.nms_hull,
                                   max_before_nms=ev.max_before_nms)

    # -------------------------------------------------------------- staging

    def _bucket_len(self, ctx_l: int) -> int:
        """The smallest ctx bucket that fits, else max_ctx_l."""
        for b in sorted(self.cfg.eval.ctx_buckets):
            if ctx_l <= b:
                return int(b)
        return self.max_ctx

    def _padded_video(self, clip_id):
        appear, motion = self.ds.video_features(clip_id)
        ctx_l = len(appear)
        if ctx_l > self.max_ctx:
            raise ValueError(f"{clip_id}: {ctx_l} clips > data.max_ctx_l {self.max_ctx}")
        l_pad = self._bucket_len(ctx_l)

        def pad(x):
            out = np.zeros((l_pad, x.shape[1]), np.float32)
            out[:ctx_l] = x
            return out

        return pad(appear), (pad(motion) if motion is not appear else None), ctx_l

    def _encode_corpus(self, x_np):
        """Host encode of one padded (L, D) array into its device-resident
        form per eval.corpus_dtype -> (tensor, scale): scale is None for
        float32/bfloat16 and the per-frame (L, 1) symmetric max-abs scale
        for int8 (zero rows get scale 1, so padding decodes to zeros)."""
        dt = self.cfg.eval.corpus_dtype
        if dt == "int8":
            scale = np.abs(x_np).max(axis=1, keepdims=True) / 127.0
            scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
            q = np.clip(np.rint(x_np / scale), -127, 127).astype(np.int8)
            return (torch.from_numpy(q).to(self.device),
                    torch.from_numpy(scale).to(self.device))
        x = torch.from_numpy(x_np).to(self.device)
        if dt == "bfloat16":
            return x.to(torch.bfloat16), None
        if dt != "float32":
            raise ValueError(f"unknown eval.corpus_dtype {dt!r}")
        return x, None

    def _device_video(self, clip_id):
        """Device-resident padded features, uploaded once and shared by
        every stage: (appear, a_scale, motion, m_scale, ctx_l); motion is
        the appear tensor itself when the dataset has one visual stream."""
        if clip_id not in self._dev_cache:
            appear_np, motion_np, ctx_l = self._padded_video(clip_id)
            appear, a_scale = self._encode_corpus(appear_np)
            if motion_np is None:
                motion, m_scale = appear, a_scale
            else:
                motion, m_scale = self._encode_corpus(motion_np)
            self._dev_cache[clip_id] = (appear, a_scale, motion, m_scale, ctx_l)
        return self._dev_cache[clip_id]

    def clear_cache(self):
        self.ds._vid_cache.clear()
        self._dev_cache.clear()
        self._stack_cache.clear()

    def _chunk_queries(self, exs):
        """Pad a query chunk to query_chunk rows of fixed-shape arrays."""
        cfg = self.cfg
        qc = cfg.eval.query_chunk
        toks = np.zeros((qc, cfg.data.max_q_l, cfg.model.t_feat_dim), np.float32)
        tmask = np.zeros((qc, cfg.data.max_q_l), np.float32)
        # the CLS feature lives in the matching branch: appearance dim
        clss = np.zeros((qc, cfg.model.v_appear_feat_dim), np.float32)
        clss[:, 0] = 1.0  # padded rows: unit vector, avoids 0/0 downstream
        for j, ex in enumerate(exs):
            tok, cls = self.ds.query_features(ex.query_id)
            toks[j, : len(tok)] = tok
            tmask[j, : len(tok)] = 1
            clss[j] = cls
        return toks, tmask, clss

    def _queries_by_video(self):
        by_vid = defaultdict(list)
        for ex in self.ds.examples:
            by_vid[ex.clip_id].append(ex)
        return by_vid

    def _to_device(self, x_np):
        return torch.from_numpy(np.ascontiguousarray(x_np)).to(self.device)

    # ------------------------------------------------------------ run paths

    @torch.inference_mode()
    def run_fused(self):
        """Fused inference: one device pass per group of `eval.video_batch`
        (video, chunk) items, host staging of group n+1 on a background
        thread while group n runs, and one device-to-host transfer for all
        groups. Returns ({"fusion": [...], "proposal": [...],
        "matching": [...]}, ranklists)."""
        pending = []
        for group, inputs in prefetch_iterator(self._fused_groups(), depth=2):
            pending.append((group, self._fused(*inputs)))
        results = _fetch([res for _, res in pending])

        ranklists = {}
        out = {name: [] for name in MODALITIES}
        for (group, _), res in zip(pending, results):
            order, _, k_sp, k_sc, k_va = res
            for v, (chunk, n_win, _) in enumerate(group):
                for j, ex in enumerate(chunk):
                    ranklists[ex.query_id] = [int(w) for w in order[v, j] if w < n_win]
                    for m, name in enumerate(MODALITIES):
                        n = int(k_va[m, v, j].sum())
                        times = [[float(k_sp[m, v, j, i, 0]), float(k_sp[m, v, j, i, 1]),
                                  float(k_sc[m, v, j, i])] for i in range(n)]
                        out[name].append(dict(
                            query_id=ex.query_id, query=ex.query, video_id=ex.video_id,
                            clip_id=ex.clip_id, predicted_times=times))
        return out, ranklists

    def _fused_groups(self):
        """Yield (group, device_inputs) per fused dispatch.

        group = list of (query_chunk_examples, n_win, clip_id), at most
        eval.video_batch items sharing one padded bucket length;
        device_inputs = (appear, a_scale, motion, m_scale, ctx, toks,
        tmask, clss) with a leading video axis, padded to video_batch rows
        (padded rows repeat the first item with empty query chunks; their
        outputs are dropped)."""
        qc = self.cfg.eval.query_chunk
        vb = max(1, self.cfg.eval.video_batch)
        by_video = self._queries_by_video()
        self.ds.prefetch_videos(list(by_video))

        work = []
        for clip_id, exs in by_video.items():
            n_win = num_windows(self._device_video(clip_id)[4], self.stride)
            for i in range(0, len(exs), qc):
                work.append((exs[i : i + qc], n_win, clip_id))

        def bucket_of(w):
            return self._device_video(w[2])[0].shape[0]

        groups = []
        if self.cfg.eval.ctx_buckets:
            # contiguous same-bucket runs, each cut into vb-sized groups
            work.sort(key=bucket_of)
            run = []
            for w in work:
                if run and bucket_of(w) != bucket_of(run[0]):
                    groups.extend(run[i : i + vb] for i in range(0, len(run), vb))
                    run = []
                run.append(w)
            if run:
                groups.extend(run[i : i + vb] for i in range(0, len(run), vb))
        else:
            groups = [work[g : g + vb] for g in range(0, len(work), vb)]

        for group in groups:
            stacked = group + [group[0]] * (vb - len(group))
            key = tuple(c for _, _, c in stacked)
            ent = self._stack_cache.pop(key, None) if self.stack_cache else None
            if ent is None:
                vids = [self._device_video(c) for _, _, c in stacked]
                appear = torch.stack([v[0] for v in vids])
                a_scale = None if vids[0][1] is None else torch.stack([v[1] for v in vids])
                if all(v[2] is v[0] for v in vids):
                    motion, m_scale = appear, a_scale
                else:
                    motion = torch.stack([v[2] for v in vids])
                    m_scale = None if vids[0][3] is None else torch.stack([v[3] for v in vids])
                ctx = self._to_device(np.asarray([v[4] for v in vids], np.int32))
                hit = (appear, a_scale, motion, m_scale, ctx)
                nbytes = sum(t.numel() * t.element_size()
                             for t in {id(t): t for t in hit if t is not None}.values())
                ent = (hit, nbytes)
            if self.stack_cache:
                self._stack_cache[key] = ent  # re-insert = LRU touch
                total = sum(n for _, n in self._stack_cache.values())
                while total > self.stack_cache_bytes and len(self._stack_cache) > 1:
                    total -= self._stack_cache.pop(next(iter(self._stack_cache)))[1]
            qs = [self._chunk_queries(chunk if i < len(group) else [])
                  for i, (chunk, _, _) in enumerate(stacked)]
            toks, tmask, clss = (self._to_device(np.stack([q[i] for q in qs]))
                                 for i in range(3))
            yield group, (*ent[0], toks, tmask, clss)

    @torch.inference_mode()
    def coarse(self) -> Dict[str, List[int]]:
        """Window ranklist per query (cone/inference.py:239-299)."""
        qc = self.cfg.eval.query_chunk
        pending = []
        for clip_id, exs in self._queries_by_video().items():
            appear, a_scale, _, _, ctx_l = self._device_video(clip_id)
            adapted = self._adapt(self._decode(appear, a_scale))[None]
            ctx = self._to_device(np.asarray([ctx_l], np.int32))
            n_win = num_windows(ctx_l, self.stride)
            for i in range(0, len(exs), qc):
                chunk = exs[i : i + qc]
                cls = np.zeros((qc, self.cfg.model.v_appear_feat_dim), np.float32)
                for j, e in enumerate(chunk):
                    cls[j] = self.ds.query_features(e.query_id)[1]
                order, _ = self._coarse(adapted, ctx, self._to_device(cls)[None])
                pending.append((chunk, n_win, (order[0],)))
        ranklists = {}
        orders = _fetch([o for _, _, o in pending])
        for (chunk, n_win, _), (order,) in zip(pending, orders):
            for j, ex in enumerate(chunk):
                ranklists[ex.query_id] = [int(w) for w in order[j] if w < n_win]
        return ranklists

    @torch.inference_mode()
    def fine(self, ranklists: Dict[str, List[int]]):
        """Raw per-query candidates from the top-K windows; host staging of
        chunk n+1 overlaps chunk n on the device."""
        cfg = self.cfg
        qc, k = cfg.eval.query_chunk, cfg.data.topk_window

        def staged():
            for clip_id, exs in self._queries_by_video().items():
                appear, a_scale, motion, m_scale, ctx_l = self._device_video(clip_id)
                ctx = self._to_device(np.asarray([ctx_l], np.int32))
                for i in range(0, len(exs), qc):
                    chunk = exs[i : i + qc]
                    win_idx = np.zeros((qc, k), np.int64)
                    win_valid = np.zeros((qc, k), bool)
                    toks, tmask, clss = self._chunk_queries(chunk)
                    for j, ex in enumerate(chunk):
                        rank = ranklists[ex.query_id][:k]
                        win_idx[j, : len(rank)] = rank
                        win_valid[j, : len(rank)] = True
                    yield chunk, win_valid, (
                        appear, a_scale, motion, m_scale, ctx,
                        *(self._to_device(x[None]) for x in (win_idx, toks, tmask, clss)))

        pending = []
        for chunk, win_valid, inputs in prefetch_iterator(staged(), depth=2):
            appear, a_scale, motion, m_scale, ctx, win_idx, toks, tmask, clss = inputs
            ap = self._decode(appear, a_scale)[None]
            mo = ap if motion is appear else self._decode(motion, m_scale)[None]
            got = self._fine(ap, mo, ctx, win_idx, toks, tmask, clss)
            pending.append((chunk, win_valid, tuple(x[0] for x in got)))
        rows = []
        for (chunk, win_valid, _), (spans_sec, prob, match) in zip(
                pending, _fetch([g for _, _, g in pending])):
            for j, ex in enumerate(chunk):
                rows.append(dict(example=ex, spans_sec=spans_sec[j], prob=prob[j],
                                 match=match[j], win_valid=win_valid[j]))
        return rows

    # ------------------------------------------------------ post-processing

    def candidates_host(self, row) -> List[List[float]]:
        """One query's (K, NQ) grid as the reference's candidate list:
        windows in ranklist order, proposals by fg prob inside each window
        (unless eval.no_sort_results), values rounded to 4 dp
        (cone/inference.py:70-91)."""
        sort_results = not self.cfg.eval.no_sort_results
        cands = []
        for w in range(row["spans_sec"].shape[0]):
            if not row["win_valid"][w]:
                continue
            sec = row["spans_sec"][w]
            entries = [[float(sec[q, 0]), float(sec[q, 1]), float(row["prob"][w, q]),
                        float(row["match"][w, q])] for q in range(sec.shape[0])]
            if sort_results:
                entries.sort(key=lambda e: e[2], reverse=True)
            cands.extend([[float(f"{v:.4f}") for v in e] for e in entries])
        return cands

    def postprocess_host(self, rows):
        """Reference-exact fusion + NMS (cone/inference.py:103-217) ->
        {"fusion", "proposal", "matching"} submission rows."""
        cfg = self.cfg.eval
        subs = {name: [] for name in MODALITIES}
        for row in rows:
            ex = row["example"]
            cands = self.candidates_host(row) or [[0.0, 0.0, 0.0, 0.0]]
            prop_scores = min_max_normalize([c[2] for c in cands])
            match_scores = min_max_normalize([c[3] for c in cands])
            fused = [p + m for p, m in zip(prop_scores, match_scores)]
            # dedup by (st, ed), the last occurrence's scores win
            ret = {}
            for c, f in zip(cands, fused):
                ret[(c[0], c[1])] = [c[2], c[3], f]
            for name, idx in [("proposal", 0), ("matching", 1), ("fusion", 2)]:
                moments = [[st, ed, v[idx]] for (st, ed), v in ret.items()]
                moments.sort(key=lambda m: m[2], reverse=True)
                if cfg.nms_thd != -1:
                    kept = temporal_nms_host(moments[: cfg.max_before_nms], cfg.nms_thd,
                                             cfg.max_after_nms, hull_union=self.nms_hull)
                else:
                    kept = moments[: cfg.max_after_nms]
                times = [[m[0], m[1]] + ret[(m[0], m[1])] for m in kept]
                subs[name].append(dict(query_id=ex.query_id, query=ex.query,
                                       video_id=ex.video_id, clip_id=ex.clip_id,
                                       predicted_times=times))
        return subs

    @torch.inference_mode()
    def postprocess_device(self, rows):
        """Batched fusion + NMS on the device (fusion modality only)."""
        sort_results = not self.cfg.eval.no_sort_results
        spans, props, matches, valids, exs = [], [], [], [], []
        for row in rows:
            sec, prob, match = row["spans_sec"], row["prob"], row["match"]
            if sort_results:
                ordp = np.argsort(-prob, axis=-1, kind="stable")
                sec = np.take_along_axis(sec, ordp[..., None], axis=-2)
                prob = np.take_along_axis(prob, ordp, axis=-1)
                match = np.take_along_axis(match, ordp, axis=-1)
            k, nq = prob.shape
            spans.append(np.round(sec, 4).reshape(k * nq, 2))
            props.append(np.round(prob.reshape(-1), 4))
            matches.append(np.round(match.reshape(-1), 4))
            valids.append(np.repeat(row["win_valid"], nq))
            exs.append(row["example"])
        ((o_spans, o_scores, o_valid),) = _fetch([self._device_post(
            *(self._to_device(np.stack(x)) for x in (spans, props, matches, valids)))])
        out = []
        for i, ex in enumerate(exs):
            n = int(o_valid[i].sum())
            times = [[float(o_spans[i, j, 0]), float(o_spans[i, j, 1]),
                      float(o_scores[i, j])] for j in range(n)]
            out.append(dict(query_id=ex.query_id, query=ex.query, video_id=ex.video_id,
                            clip_id=ex.clip_id, predicted_times=times))
        return out

    def run(self, host_postproc: bool = True, fused: bool = False):
        if fused:
            if host_postproc:
                raise ValueError("the fused path post-processes on the device; "
                                 "pass host_postproc=False")
            return self.run_fused()
        ranklists = self.coarse()
        rows = self.fine(ranklists)
        if host_postproc:
            subs = self.postprocess_host(rows)
        else:
            subs = {"fusion": self.postprocess_device(rows)}
        return subs, ranklists


def make_pipeline(model, dataset, cfg: ConeConfig, device="cuda"):
    """Family-dispatching constructor: the CONE pipeline; the 2D-TAN family
    is not ported yet (ROADMAP Queue 1 item 10)."""
    if cfg.model.model_family == "tan":
        raise NotImplementedError(
            "2D-TAN inference is not ported yet: ROADMAP Queue 1 item 10 "
            "(2D-TAN family)")
    return InferencePipeline(model, dataset, cfg, device=device)
