"""The benchmark's yardstick: matmul FLOPs and bytes the traffic needs, and
the card's peaks.

Copied from the program's `cone_tpu_torch/utils/perf.py` (the FLOP model
of a window forward) and `chip_smoke.py` (the coarse kernel's bound), and
corrected here:

  * a window counts `data.max_v_l` frames (the window the pipeline cuts)
    and the query's own tokens, not `model.max_v_l` and `max_q_l`;
  * only real queries, valid frames and valid videos count: the padded
    rows of a query chunk, the padded frames of a ctx bucket and the
    adapter run again for every chunk of one video are not work the
    traffic needs;
  * the train count is per sample: two window forwards, the GT-proposal
    matching, and a backward that computes exactly what autograd needs;
  * float32 is held to the TF32 dense peak of the card: a float32-accurate
    product on the tensor cores (the 3xTF32 of the coarse kernel) runs at
    or below it, so no share of a float32 path can read past 1.

A FLOP is one multiply or one add of a matmul (2*m*n*k per product).
Elementwise work, softmax, LayerNorm and the Hungarian matcher are not
counted.
"""

from __future__ import annotations

# Published dense peaks of one NVIDIA H100 SXM (80 GB HBM3), at its full
# 700 W power limit: TF32 and bfloat16 on the tensor cores, HBM bandwidth.
H100_PEAKS = {"float32": 495e12, "bfloat16": 989e12, "bytes": 3.35e12}


def peaks(device_name: str) -> dict:
    """The peak table of a card by its `torch.cuda.get_device_name()`."""
    if "H100" in device_name and "PCIe" not in device_name:
        return dict(H100_PEAKS)
    raise RuntimeError(f"no peak table for {device_name!r}")


def window_forward_flops(m, lv: int, lq: int) -> dict:
    """Matmul FLOPs of ONE window forward of the CONE model at `lv` video
    frames and `lq` query tokens, by part. m: the config's `model` section.

    core: input projections, encoder, decoder, the class and span heads of
    every decoder layer, the saliency head. matching: the predicted
    proposals' masked mean pool (a (NQ, lv) x (lv, D) product), the
    residual adapter on the pooled features and the cosine with the CLS."""
    d, f, nq = m.hidden_dim, m.dim_feedforward, m.num_queries
    dv, dt, da = m.v_motion_feat_dim, m.t_feat_dim, m.v_appear_feat_dim
    big_l = lv + lq
    proj = 2 * lv * (dv * d + d * d) + 2 * lq * (dt * d + d * d)
    enc_layer = 8 * big_l * d * d + 4 * big_l * big_l * d + 4 * big_l * d * f
    dec_layer = ((8 * nq * d * d + 4 * nq * nq * d)
                 + (4 * nq * d * d + 4 * big_l * d * d + 4 * nq * big_l * d)
                 + 4 * nq * d * f)
    heads = m.dec_layers * (2 * nq * d * 2 + 2 * nq * (d * d + d * d + d * 2)) + 2 * lv * d
    matching = 2 * nq * lv * da + 2 * nq * (da * d + d * da) + 2 * nq * da
    core = proj + m.enc_layers * enc_layer + m.dec_layers * dec_layer + heads
    return {"core": float(core), "matching": float(matching)}


def adapter_flops(m, frames: int) -> float:
    """The residual adapter (Dense da->d, Dense d->da) over `frames` rows."""
    return float(2 * frames * (m.v_appear_feat_dim * m.hidden_dim
                               + m.hidden_dim * m.v_appear_feat_dim))


def eval_query_flops(cfg, ctx_l: int, n_tok: int) -> float:
    """One real query through the fused pipeline: the coarse product over
    its video's valid frames and `data.topk_window` window forwards of
    `data.max_v_l` frames and its `n_tok` tokens. The adapter over the video
    is counted once per video (`eval_video_flops`)."""
    w = window_forward_flops(cfg.model, cfg.data.max_v_l, n_tok)
    coarse = 2 * ctx_l * cfg.model.v_appear_feat_dim
    return float(coarse + cfg.data.topk_window * (w["core"] + w["matching"]))


def eval_video_flops(cfg, ctx_l: int) -> float:
    """The coarse stage's adapter over one video's valid frames."""
    return adapter_flops(cfg.model, ctx_l)


def train_sample_flops(cfg, n_tok: int, bsz: int, adapter_on: bool) -> float:
    """One sample of a train step: the positive and the negative window
    forward (backward twice their matmul FLOPs: activation and weight
    gradients), and with the adapter on, the GT-proposal mean pool (no
    gradient flows into it), the adapter (forward and backward) and the
    InfoNCE over the batch (its two (B, D) x (D, B) products forward, one
    gradient each backward)."""
    m = cfg.model
    core = window_forward_flops(m, cfg.data.max_v_l, n_tok)["core"]
    windows = 2 if cfg.loss.neg_loss else 1
    total = 3 * windows * core
    if adapter_on and cfg.loss.adapter_loss:
        da = m.v_appear_feat_dim
        total += 2 * cfg.data.max_v_l * da + 3 * adapter_flops(m, 1) + 8 * bsz * da
    return float(total)


def coarse_bound_s(ctx_l: int, n_q: int, d: int, n_seg: int, pk: dict) -> tuple:
    """The least time of one coarse launch for one video: its valid frames,
    the real queries' CLS rows and their segment maxima read or written
    once, against the work of the product over those frames. Returns
    (seconds, "bytes" | "operations")."""
    nbytes = 4 * (ctx_l * d + n_q * d + n_q * n_seg)
    t_bytes = nbytes / pk["bytes"]
    t_ops = 2 * n_q * ctx_l * d / pk["float32"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
