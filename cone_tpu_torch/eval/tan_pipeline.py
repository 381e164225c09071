"""Coarse-to-fine inference with the CONE-TAN head
(cone_tpu/eval/tan_pipeline.py).

The coarse window ranking is the CONE pipeline's, the hand-written coarse
kernel included (one launch per dispatch with eval.use_pallas_coarse). The
fine stage scores every valid cell of each window's 2D proposal map,
suppresses overlapping cells inside the window (2D-TAN's
TEST.USE_NMS_WITHIN_WINDOW), keeps the top `proposal_top_k`, scores their
matching, and hands them to the same fusion + NMS post-processing
(cone_2dtan/lib/core/eval.py:123-264 uses CONE's score fusion).
"""

from __future__ import annotations

import torch

from cone_tpu_torch.config import ConeConfig, TanConfig, check_tan_geometry
from cone_tpu_torch.eval.pipeline import InferencePipeline
from cone_tpu_torch.models.tan import ConeTanModel
from cone_tpu_torch.ops.nms import temporal_nms_device
from cone_tpu_torch.utils.trace import span

# TEST.NMS_THRESH_WITHIN_WINDOW (cone_2dtan/lib/core/config.py:105)
NMS_THRESH_WITHIN_WINDOW = 0.3
# the within-window NMS runs over this many best cells of a window's map,
# as in the JAX package (cone_tpu/eval/tan_pipeline.py)
PRE_NMS_POOL = 128


def top_k_ref_order(x: torch.Tensor, k: int):
    """The k largest entries of each row with the reference's tie order:
    equal scores prefer the HIGHEST flat index (np.argsort(ravel())[::-1],
    moment_localization/test.py:275-276). torch.topk promises no order among
    ties, on the card least of all; a stable descending sort of the reversed
    row gives this order on every device. Returns (values, indices)."""
    vals, ridx = torch.sort(x.flip(-1), dim=-1, descending=True, stable=True)
    return vals[..., :k], x.shape[-1] - 1 - ridx[..., :k]


@span("tan.window_nms")
def within_window_nms(prob: torch.Tensor, num_clips: int, top_p: int):
    """(N, S * E) cell probabilities -> (spans in map cells (N, top_p, 2),
    their probabilities, valid (N, top_p)): greedy NMS at
    NMS_THRESH_WITHIN_WINDOW over the PRE_NMS_POOL best cells, as cone_tpu
    does. The reference scans the whole map until it holds top_p survivors
    (moment_localization/test.py:242-289), so a map whose best 128 cells
    cluster keeps fewer than top_p here (ROADMAP Queue 3)."""
    pool_prob, pool_idx = top_k_ref_order(prob, min(PRE_NMS_POOL, num_clips * num_clips))
    cells = torch.stack([pool_idx // num_clips, pool_idx % num_clips + 1], dim=-1).float()
    return temporal_nms_device(cells, pool_prob, pool_prob > 0, NMS_THRESH_WITHIN_WINDOW,
                               top_p, hull_union=False)


class TanInferencePipeline(InferencePipeline):
    nms_hull = False  # 2D-TAN's NMS uses the standard union IoU (eval.py:34-56)

    def __init__(self, model: ConeTanModel, dataset, cfg: ConeConfig,
                 tan_cfg: TanConfig, proposal_top_k: int = 10,
                 nms_within_window: bool = True, device="cuda"):
        """nms_within_window reproduces TEST.USE_NMS_WITHIN_WINDOW (yaml
        default True, moment_localization/test.py:285-289): overlapping
        cells inside a window are suppressed at NMS_THRESH_WITHIN_WINDOW,
        over the PRE_NMS_POOL best cells, before the top `proposal_top_k`
        are kept."""
        check_tan_geometry(tan_cfg, cfg.data.max_v_l)
        self.tan_cfg = tan_cfg
        self.proposal_top_k = proposal_top_k
        self.nms_within_window = nms_within_window
        super().__init__(model, dataset, cfg, device=device)

    def _adapter_on(self) -> bool:
        return self.tan_cfg.adapter_module == "linear"

    def _fine_windows(self, ap, mo, wmask, wstart, wlen, toks, tmask, cls, rep):
        """One score-map forward over N gathered windows (arguments as
        InferencePipeline._fine_windows; the map needs no frame mask or
        length); returns (spans in seconds, cell probabilities, matching
        scores, cand_valid), each per (N, proposal_top_k)."""
        cfg = self.cfg
        nc, stride_t, top_p = self.tan_cfg.num_clips, self.tan_cfg.frame_stride, \
            self.proposal_top_k
        n = ap.shape[0]
        scores, map_mask = self.model(rep(toks), rep(tmask), mo)
        # the model's own cell mask: invalid cells score 0, never 0.5, as the
        # reference's sigmoid(prediction) * map_mask (test.py:121-125)
        prob = (torch.sigmoid(scores) * map_mask).reshape(n, nc * nc)
        if self.nms_within_window:
            spans_clip, top_prob, cand_valid = within_window_nms(prob, nc, top_p)
        else:
            top_prob, top_idx = top_k_ref_order(prob, top_p)
            # cell (s, e) covers clips [s, e + 1)
            spans_clip = torch.stack([top_idx // nc, top_idx % nc + 1], dim=-1).float()
            cand_valid = top_prob > 0
        s_cell, e_cell = spans_clip[..., 0].long(), spans_clip[..., 1].long()
        # map cells -> raw clips: x TARGET_STRIDE (test.py:293,426); matching
        # pools the raw appearance window over the scaled proposal
        matching = self.model.clip_matching_pred(rep(cls), ap, s_cell * stride_t,
                                                 e_cell * stride_t)
        sec = (spans_clip * stride_t + wstart[:, None, None]) * cfg.data.clip_length
        return sec, top_prob, matching, cand_valid
