"""Multi-scale variable-length window training sampler (the ECCV'22
leaderboard recipe, scripts/train_ego4d_leaderboard.sh).

Counterpart of cone/ego4d_dataloader_for_eccv2022_workshop.py:179-235: per
training example, besides the standard positive window, THREE extra windows
of random length (0.4-2x of the window size, always covering the GT span,
random placement) as additional Moment-DETR training rows. The matching
(adapter) branch keeps only the standard window.

Fixed-shape packing: every motion window (standard + extra) is padded to
2 * max_v_l clips (an extra window can reach twice the window size); the
appearance rows, query_cls and the proposal bounds stay at the B standard
rows. A batch is
    rows [0, B)        standard windows (with the appearance/adapter fields)
    rows [B, 4B)       extra multiscale windows
so the train step applies the adapter NCE to the first B rows.

Data parallel: a rank of a dp group takes the standard rows [lo, hi) and
their extra rows [B + 3 lo, B + 3 hi) (three consecutive rows an example),
in that order. The epoch's generator draws for every example in turn, so
every rank builds the whole batch and keeps its rows (its cost is the
whole batch's on every rank).

The draws are cone_tpu's (cone_tpu/data/multiscale.py), in the same order:
the epoch's generator default_rng((seed, epoch, 0x6D73)) shuffles and then
draws every extra window, saliency frame and negative window; each
standard row comes from default_rng((seed, epoch, example index)). So the
two packages build equal batches.
"""

from __future__ import annotations

import math

import numpy as np

from cone_tpu_torch.data.dataset import GroundingDataset, TrainLoader

RATIO_BANDS = [(0.4, 0.6), (0.6, 0.8), (0.8, 1.0)]
EPOCH_STREAM = 0x6D73   # "ms": the epoch generator's third seed word


def sample_multiscale_windows(ds: GroundingDataset, index: int, rng: np.random.Generator):
    """The 3 extra (start, end, nominal length) windows of one example
    (dataloader:183-205 geometry), one length and one placement draw each."""
    cfg = ds.cfg
    ex = ds.examples[index]
    stride = ds.stride
    ctx_l = len(ds.video_features(ex.clip_id)[0])
    start = min(ctx_l, ex.timestamps[0] / cfg.clip_length)
    end = min(ctx_l, ex.timestamps[1] / cfg.clip_length)

    out = []
    for lo, hi in RATIO_BANDS:
        gt_ratio = math.ceil(end - start) / stride
        min_ratio = min(lo, max(hi, gt_ratio))
        max_ratio = max(hi * 2, min(lo * 2, 2 * gt_ratio))
        window_length = int(stride * 2 * rng.uniform(min_ratio, max_ratio))

        rand_start_choice = max(0, math.ceil(end) - window_length)
        rand_end_choice = min(math.floor(start), ctx_l - window_length)
        lo_c, hi_c = sorted((rand_start_choice, rand_end_choice))
        new_start = int(rng.integers(lo_c, hi_c)) if lo_c < hi_c else lo_c
        # when ctx_l < window_length, rand_end_choice is negative and the
        # draw can land below 0: clamp (a negative slice would wrap)
        new_start = max(new_start, 0)
        new_end = min(new_start + window_length, ctx_l)
        out.append((new_start, new_end, window_length))
    return out


def _pad_rows(x: np.ndarray, length: int) -> np.ndarray:
    out = np.zeros((x.shape[0], length) + x.shape[2:], x.dtype)
    out[:, : x.shape[1]] = x
    return out


class MultiscaleTrainLoader(TrainLoader):
    """Batches with 4 windows per example: [standard x B ; extra x 3B]."""

    def epoch(self, epoch_i: int, lo: int = 0, hi=None):
        """Yield this epoch's batches, or of each the standard rows lo:hi
        followed by their extra rows (module docstring)."""
        hi = self.bsz if hi is None else hi
        if not 0 <= lo < hi <= self.bsz:
            raise ValueError(f"empty or outside batch slice {lo}:{hi} of bsz {self.bsz}")
        b = self.bsz
        for batch in self._batches(epoch_i):
            if (lo, hi) == (0, b):
                yield batch
                continue
            yield {k: v[lo:hi] if len(v) == b else np.concatenate(
                [v[lo:hi], v[b + 3 * lo : b + 3 * hi]]) for k, v in batch.items()}

    def _batches(self, epoch_i: int):
        cfg = self.ds.cfg
        pad_l = 2 * cfg.max_v_l
        rng = np.random.default_rng((self.seed, epoch_i, EPOCH_STREAM))
        order = rng.permutation(len(self.ds))
        dv = self.ds.video_features(self.ds.examples[0].clip_id)[1].shape[1]

        for b in range(self.steps_per_epoch()):
            idxs = order[b * self.bsz : (b + 1) * self.bsz]
            std = [self.ds.sample_train(int(i), np.random.default_rng((self.seed, epoch_i, int(i))))
                   for i in idxs]
            batch = {k: np.stack([s[k] for s in std]) for k in std[0]}

            extra = {k: [] for k in ("pos_motion", "pos_mask", "neg_motion", "neg_mask",
                                     "span_labels", "sal_pos", "sal_neg", "query_tokens",
                                     "query_mask")}
            for i in idxs:
                i = int(i)
                ex = self.ds.examples[i]
                motion = self.ds.video_features(ex.clip_id)[1]
                ctx_l = len(motion)
                start = min(ctx_l, ex.timestamps[0] / cfg.clip_length)
                end = min(ctx_l, ex.timestamps[1] / cfg.clip_length)
                tok, _ = self.ds.query_features(ex.query_id)
                q = np.zeros((cfg.max_q_l, tok.shape[1]), np.float32)
                q[: len(tok)] = tok
                qm = np.zeros(cfg.max_q_l, np.float32)
                qm[: len(tok)] = 1

                for w_start, w_end, w_len_nominal in sample_multiscale_windows(self.ds, i, rng):
                    w_len = w_end - w_start
                    n = min(w_len, pad_l)
                    m = np.zeros((pad_l, dv), np.float32)
                    m[:n] = motion[w_start : w_start + n]
                    msk = np.zeros(pad_l, np.float32)
                    msk[:n] = 1

                    start_pos = max(start - w_start, 0.0)
                    end_pos = min(end - w_start, float(w_len_nominal))
                    st_n = start_pos / max(w_len, 1)
                    ed_n = min(end_pos, w_len) / max(w_len, 1)
                    span = np.zeros((cfg.max_windows, 2), np.float32)
                    span[0] = [(st_n + ed_n) / 2, ed_n - st_n]

                    rel = list(range(int(math.floor(start_pos)),
                                     int(math.ceil(min(end_pos, w_len))))) or [
                        int(math.floor(start_pos))]
                    neg_pool = sorted(set(range(w_len)) - set(rel)) or [0]
                    salp = np.array([int(rng.choice(rel))], np.int32)
                    saln = np.array([int(rng.choice(neg_pool))], np.int32)

                    # a fresh standard-size negative window, padded to pad_l
                    nm, nmask = self.ds.sample_negative_window(i, rng)
                    extra["neg_motion"].append(_pad_rows(nm[None], pad_l)[0])
                    extra["neg_mask"].append(_pad_rows(nmask[None], pad_l)[0])
                    extra["pos_motion"].append(m)
                    extra["pos_mask"].append(msk)
                    extra["span_labels"].append(span)
                    extra["sal_pos"].append(salp)
                    extra["sal_neg"].append(saln)
                    extra["query_tokens"].append(q)
                    extra["query_mask"].append(qm)

            for k, rows in extra.items():
                std_rows = batch[k]
                if k in ("pos_motion", "pos_mask", "neg_motion", "neg_mask"):
                    std_rows = _pad_rows(std_rows, pad_l)
                batch[k] = np.concatenate([std_rows, np.stack(rows)])
            span_mask = np.zeros((len(extra["span_labels"]), cfg.max_windows), np.float32)
            span_mask[:, 0] = 1
            batch["span_mask"] = np.concatenate([batch["span_mask"], span_mask])
            yield batch
