"""Matmul FLOPs of 2D-TAN inside CONE's windows (`benchmark/reference/tan.py`),
the yardstick of `tan_map_roofline` and `mfu.tan`.

A FLOP is one multiply or one add of a product (2*m*n*k), as in
`benchmark/counts.py`. The map stack is counted over the dense grid cuDNN
computes: every cell of each convolution's output, the map's empty cells
and the padding's ring included (the count renormalisation zeroes them
after the product, it does not skip them). So a window's map is

  frame 1x1 conv      2 * frames * Dv * H
  fusion 1x1 conv     2 * S^2 * H * H
  map convolutions    2 * C_out * C_in * k^2 * out^2, out = S + 2 p - k + 1
                      (88, 80, 72, 64 at K9L4 with paddings 16/0/0/0)
  prediction          2 * S^2 * H

The query's LSTM (four gates, input and recurrent products a token a
layer) and tex_linear count once a query over its own tokens: the program
runs them again for every window, which is not work the traffic needs.
Matching counts the masked mean pool over the window's frames and the
cosine of each kept cell; the coarse stage the product of the CLS with
the film's valid frames. Elementwise work, the pools and the NMS are not
counted.
"""

from __future__ import annotations


def _out(s: int, k: int, p: int) -> int:
    return s + 2 * p - k + 1


def map_flops(t) -> float:
    """One window's map: frame conv to prediction (the work under
    `bench.tan_map`, less the query's text)."""
    h, s = t.hidden_size, t.num_clips
    frames = s * t.frame_stride
    total = 2 * frames * t.v_feat_dim * h + 2 * s * s * h * h
    c_in, size = h, s
    for c_out, k, p in zip(t.map_hidden_sizes, t.map_kernel_sizes, t.map_paddings):
        size = _out(size, k, p)
        total += 2 * c_out * c_in * k * k * size * size
        c_in = c_out
    return float(total + 2 * s * s * c_in)


def text_flops(t, n_tok: int) -> float:
    """One query's LSTM over its `n_tok` tokens and tex_linear."""
    th = t.txt_hidden_size
    lstm = sum(2 * n_tok * 4 * th * ((t.t_feat_dim if i == 0 else th) + th)
               for i in range(t.lstm_layers))
    return float(lstm + 2 * th * t.hidden_size)


def matching_flops(t, top_p: int) -> float:
    """One window's matching: the mean pool of each kept cell over the
    window's frames, and its cosine with the CLS."""
    frames = t.num_clips * t.frame_stride
    return float(2 * top_p * frames * t.v_feat_dim + 2 * top_p * t.v_feat_dim)


def query_flops(cfg, ctx_l: int, n_tok: int) -> float:
    """One query: the coarse product over its film's valid frames, its
    text, and `data.topk_window` windows of map and matching."""
    t = cfg.tan
    per_window = map_flops(t) + matching_flops(t, t.proposal_top_k)
    return float(2 * ctx_l * cfg.model.v_appear_feat_dim + text_flops(t, n_tok)
                 + cfg.data.topk_window * per_window)
