"""The benchmark's inputs, made from the run's seed: a planted-signal corpus
of videos and queries, and a seeded state dict.

The corpus generator is a parametrised copy of the program's
`data/synthetic.make_synthetic_dataset` (videos of Gaussian frame
features; each query's CLS is a unit direction added to the frames of its
ground-truth moment, so the coarse ranking has structure). It draws on the
device in a few large calls. The sizes (frames a video, queries a video,
tokens a query) are one fixed spread over the traffic's ranges for every
seed; the seed permutes which video or query gets which size and draws
the content. So two seeds do the same amount of work.

Weights: one uniform draw on the device for the whole model, cut into the
parameters by the reference's table (`reference/cone.param_shapes`):
Xavier-uniform matrices, LayerNorm scales near 1, small biases.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from benchmark.reference.cone import param_shapes


def sub_seed(seed: int, *tags) -> int:
    """A 64-bit seed for one use of the run's seed."""
    key = [int(seed)] + [sum(ord(c) << (8 * (i % 7)) for i, c in enumerate(str(t)))
                         for t in tags]
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


def generator(seed: int, device, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n whole sizes evenly over [lo, hi]; the same for every seed."""
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


@dataclass
class Corpus:
    """Raw (unnormalised) features, as a feature store would hold them.

    video_ids[v], ctx[v], feats[v] (ctx[v], D) float32 on the host;
    per query q: query_ids[q], video[q] (index), tokens[q] (n_tok, Dt),
    cls[q] (D,), gt[q] = (start, end) frames."""

    video_ids: List[str]
    ctx: np.ndarray
    feats: List[np.ndarray]
    query_ids: List[str]
    video: np.ndarray
    tokens: List[np.ndarray]
    cls: np.ndarray
    gt: np.ndarray

    @property
    def n_tok(self) -> np.ndarray:
        return np.asarray([len(t) for t in self.tokens])

    def queries_of(self, v: int) -> np.ndarray:
        return np.flatnonzero(self.video == v)


def make_corpus(mix: dict, seed: int, dim: int, txt_dim: int, max_v_l: int,
                device, tag: str = "corpus") -> Corpus:
    """mix: videos, frames [lo, hi], queries_per_video [lo, hi],
    query_tokens [lo, hi], signal. Ground-truth moments are 4 to
    max(5, max_v_l // 2) frames long and start at least a window before
    the video's end, as in the program's generator."""
    rng = np.random.default_rng(sub_seed(seed, tag, "sizes"))
    n_v = int(mix["videos"])
    ctx = rng.permutation(spread(*mix["frames"], n_v))
    per_video = rng.permutation(spread(*mix["queries_per_video"], n_v))
    n_q = int(per_video.sum())
    n_tok = rng.permutation(spread(*mix["query_tokens"], n_q))
    video = np.repeat(np.arange(n_v), per_video)
    dur = rng.integers(4, max(5, max_v_l // 2), size=n_q)
    room = np.maximum(1, ctx[video] - dur - max_v_l)
    start = (rng.random(n_q) * room).astype(np.int64)
    gt = np.stack([start, start + dur], axis=1)

    g = generator(seed, device, tag, "content")
    offsets = np.concatenate([[0], np.cumsum(ctx)])
    feats = torch.randn((int(offsets[-1]), dim), generator=g, device=device)
    cls = torch.randn((n_q, dim), generator=g, device=device)
    cls = cls / cls.norm(dim=-1, keepdim=True)
    toks = torch.randn((int(n_tok.sum()), txt_dim), generator=g, device=device)
    rows = np.concatenate([offsets[video[q]] + np.arange(gt[q, 0], gt[q, 1])
                           for q in range(n_q)])
    owner = np.repeat(np.arange(n_q), dur)
    feats.index_add_(0, torch.from_numpy(rows).to(device),
                     float(mix["signal"]) * cls[torch.from_numpy(owner).to(device)])

    feats_h, cls_h, toks_h = feats.cpu().numpy(), cls.cpu().numpy(), toks.cpu().numpy()
    tok_off = np.concatenate([[0], np.cumsum(n_tok)])
    video_ids = [f"video_{v}" for v in range(n_v)]
    qpos = np.zeros(n_v, np.int64)
    query_ids = []
    for q in range(n_q):
        v = video[q]
        query_ids.append(f"{video_ids[v]}_q{qpos[v]}")
        qpos[v] += 1
    return Corpus(
        video_ids=video_ids, ctx=ctx,
        feats=[feats_h[offsets[v]:offsets[v + 1]] for v in range(n_v)],
        query_ids=query_ids, video=video,
        tokens=[toks_h[tok_off[q]:tok_off[q + 1]] for q in range(n_q)],
        cls=cls_h, gt=gt)


def seeded_state_dict(m, seed: int, device) -> dict:
    """The model's parameters from one uniform draw on the device."""
    shapes = param_shapes(m)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    u = torch.rand(sum(sizes), generator=generator(seed, device, "weights"), device=device)
    u = u * 2 - 1
    out, pos = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        x = u[pos:pos + n].view(shape)
        pos += n
        if len(shape) == 2:
            x = x * (6.0 / (shape[0] + shape[1])) ** 0.5
        elif ("norm" in name or "LayerNorm" in name) and name.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.05 * x
        out[name] = x.contiguous()
    return out
