"""The corpus retriever's packed fine stage (cone_tpu_torch/serve/corpus.py
`_fine_packed`, ops/windows.py `slice_windows_flat`) on the CPU: the flat
window gather equals `slice_windows` window by window, bit for bit; the
packed forward equals the per-video `_fine` on the same windows; a query
runs exactly its chosen windows, in dispatches of its own of at most
fine_chunk x topk_window windows, the same alone as in any batch, and
`/stats` counts them. The answers themselves are
held against cone_tpu's in tests/test_torch_serve.py. The file imports
neither jax nor cone_tpu.
"""

import math

import numpy as np
import pytest
import torch

from cone_tpu_torch.config import ConeConfig, DataConfig, EvalConfig, ModelConfig
from cone_tpu_torch.models.cone import ConeModel
from cone_tpu_torch.ops.windows import num_windows, slice_windows, slice_windows_flat
from cone_tpu_torch.serve import corpus
from cone_tpu_torch.serve.corpus import CorpusRetriever
from cone_tpu_torch.serve.server import MomentService

DIM = 16
STRIDE, MAX_V_L = 8, 16


# ------------------------------------------------------------- the gather

def _stack(rng, lengths, l_pad, d=6, dtype=np.float32):
    x = np.zeros((len(lengths), l_pad, d), dtype)
    for v, n in enumerate(lengths):
        x[v, :n] = rng.normal(size=(n, d))
    return torch.from_numpy(x)


def _windows_of(lengths, pick):
    """(video, window) pairs of a stack: `pick(n_win)` windows a video."""
    return [(v, w) for v, n in enumerate(lengths) for w in pick(num_windows(n, STRIDE))]


def _flat(stacks, pairs, lengths):
    video = torch.tensor([v for v, _ in pairs])
    win = torch.tensor([w for _, w in pairs])
    ctx = torch.tensor(lengths, dtype=torch.int32)[video]
    return slice_windows_flat(stacks, video, win, ctx, STRIDE, MAX_V_L)


def _assert_each_window_equal(feats, pairs, lengths, got):
    out, mask, start, length = got
    for n, (v, w) in enumerate(pairs):
        want = slice_windows(feats[v], torch.tensor(w), STRIDE, MAX_V_L, lengths[v])
        for g, x in zip((out[0][n], mask[n], start[n], length[n]), want):
            assert g.dtype == x.dtype and torch.equal(g, x), (v, w)


@pytest.mark.parametrize("case", ["every_window", "window_zero", "last_partial_window"])
def test_flat_gather_equals_slice_windows(case):
    rng = np.random.default_rng(1)
    lengths = [37, 64, 45]  # 37 and 45 end in a partial window
    feats = _stack(rng, lengths, 64)
    pick = {"every_window": range,
            "window_zero": lambda n: [0],
            "last_partial_window": lambda n: [n - 1, n - 2]}[case]
    pairs = _windows_of(lengths, pick)
    got = _flat((feats,), pairs, lengths)
    _assert_each_window_equal(feats, pairs, lengths, got)
    if case == "last_partial_window":
        assert int(got[3][0]) == 37 - (num_windows(37, STRIDE) - 2) * STRIDE < MAX_V_L


def test_flat_gather_over_two_ctx_buckets():
    """Each bucket's windows gather out of its own stack; concatenated, they
    are the per-video slices in the packed order."""
    rng = np.random.default_rng(2)
    buckets = {64: [50, 64], 96: [70, 96, 81]}
    feats = {l_pad: _stack(rng, ls, l_pad) for l_pad, ls in buckets.items()}
    parts, want = [], []
    for l_pad, lengths in buckets.items():
        pairs = _windows_of(lengths, lambda n: [0, n // 2, n - 1])
        out, mask, start, length = _flat((feats[l_pad],), pairs, lengths)
        parts.append((out[0], mask, start, length))
        want += [slice_windows(feats[l_pad][v], torch.tensor(w), STRIDE, MAX_V_L, lengths[v])
                 for v, w in pairs]
    got = [torch.cat(x) for x in zip(*parts)]
    assert len(got[0]) == len(want) == 15
    for n, w in enumerate(want):
        for g, x in zip(got, w):
            assert torch.equal(g[n], x)


def test_flat_gather_decodes_int8_after_the_gather():
    """An int8 stack and its per-frame scales gather at the same rows; the
    decode of the gathered windows equals the windows of the decoded stack,
    bit for bit, and a None stack passes through."""
    rng = np.random.default_rng(3)
    lengths = [40, 64]
    q = torch.from_numpy(rng.integers(-127, 128, size=(2, 64, 6)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(0.001, 0.05, size=(2, 64, 1)).astype(np.float32))
    pairs = _windows_of(lengths, range)
    (a, s, none), mask, _, _ = _flat((q, scale, None), pairs, lengths)
    assert none is None and a.dtype == torch.float32
    after = a.float() * s
    decoded = q.float() * scale
    before = _flat((decoded,), pairs, lengths)[0][0]
    assert torch.equal(after, before)
    _assert_each_window_equal(decoded, pairs, lengths, _flat((decoded,), pairs, lengths))
    assert bool((after[mask == 0] == 0).all()) and bool((mask == 0).any())


# ------------------------------------------------------------ the packing

def _cfg(**eval_kw):
    return ConeConfig(
        model=ModelConfig(hidden_dim=16, nheads=2, enc_layers=1, dec_layers=1,
                          dim_feedforward=32, t_feat_dim=DIM, v_motion_feat_dim=DIM,
                          v_appear_feat_dim=DIM, max_q_l=8, max_v_l=MAX_V_L),
        data=DataConfig(max_v_l=MAX_V_L, max_q_l=8, clip_length=1.0, topk_window=4,
                        max_ctx_l=128),
        eval=EvalConfig(nms_thd=0.5, max_after_nms=5, **eval_kw))


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return ConeModel(_cfg().model, device="cpu").eval()


@pytest.fixture(scope="module")
def library():
    """6 videos of 40-120 clips and 5 queries, each planted in one video."""
    rng = np.random.default_rng(7)
    videos = {f"v{i}": rng.normal(size=(int(rng.integers(40, 120)), DIM)).astype(np.float32)
              for i in range(6)}
    motion = {c: rng.normal(size=v.shape).astype(np.float32) for c, v in videos.items()}
    queries = []
    for qi in range(5):
        cls = rng.normal(size=DIM).astype(np.float32)
        vid = f"v{qi}"
        st = int(rng.integers(0, len(videos[vid]) - 12))
        videos[vid][st : st + 8] += 2.0 * cls / np.linalg.norm(cls)
        queries.append((rng.normal(size=(int(rng.integers(3, 9)), DIM)).astype(np.float32),
                        cls))
    return videos, motion, queries


def _retriever(model, library, fine_chunk=8, dual=False, **eval_kw):
    videos, motion, _ = library
    r = CorpusRetriever(model, _cfg(**eval_kw), fine_chunk=fine_chunk, device="cpu")
    for cid, feats in videos.items():
        r.add_video(cid, feats, motion_feats=motion[cid] if dual else None)
    return r


class _Spy:
    """Records the triples and the window count of every fine dispatch."""

    def __init__(self, retriever):
        self.dispatches = []
        inner = retriever._fine_packed

        def packed(stacked, wins, *rest):
            out = inner(stacked, wins, *rest)
            self.dispatches.append((list(wins), out[1].shape[0]))
            return out

        retriever._fine_packed = packed


@pytest.mark.parametrize("kw", [dict(), dict(corpus_dtype="int8"), dict(corpus_dtype="bfloat16"),
                                dict(ctx_buckets=(64, 96)), dict(dual=True)],
                         ids=["float32", "int8", "bfloat16", "ctx_buckets", "dual_stream"])
def test_packed_forward_equals_the_per_video_fine(model, library, kw, monkeypatch):
    """Each packed row is the per-video `_fine` of its own (query, window):
    the gather, the decode after it and the query-index mapping are right
    for every corpus encoding, over ctx buckets and for two streams; a
    single-stream library gathers its one stream once."""
    _, _, queries = library
    r = _retriever(model, library, **kw)
    spy = _Spy(r)
    gathered = []

    def flat(stacks, *a):
        gathered.append(sum(x is not None for x in stacks))
        return slice_windows_flat(stacks, *a)

    monkeypatch.setattr(corpus, "slice_windows_flat", flat)
    toks = [q[0] for q in queries[:3]]
    r.search_batch(toks, np.stack([q[1] for q in queries[:3]]), search_windows=7)
    per_stream = 2 if kw.get("corpus_dtype") == "int8" else 1  # features (+ scales)
    assert gathered and set(gathered) == {per_stream * (2 if "dual" in kw else 1)}
    assert [n for _, n in spy.dispatches] == [7, 7, 7]
    wins = [t for part, _ in spy.dispatches for t in part]
    assert [qi for _, qi, _ in wins] == [0] * 7 + [1] * 7 + [2] * 7
    assert all(len({cid for cid, _, _ in part}) >= 2 for part, _ in spy.dispatches)
    if "ctx_buckets" in kw:
        assert len({r._row_of[cid][0] for cid, _, _ in wins}) >= 2
    stacked = r._ensure_stacked()
    clss = np.stack([q[1] / np.linalg.norm(q[1]) for q in queries[:3]]).astype(np.float32)
    toks_np = np.zeros((3, 8, DIM), np.float32)
    tmask_np = np.zeros((3, 8), np.float32)
    for qi, t in enumerate(toks):
        toks_np[qi, : len(t)], tmask_np[qi, : len(t)] = t, 1
    pipe = r.pipe
    with torch.inference_mode():
        packed = r._fine_packed(stacked, wins,
                                *(torch.from_numpy(x) for x in (toks_np, tmask_np, clss)))
        for row, (cid, qi, w) in enumerate(wins):
            l_pad, v = r._row_of[cid]
            _, ctxs, (A, S, M, MS, _) = stacked[l_pad]
            decode = pipe.resident.decode
            ap = decode(A[v], None if S is None else S[v])[None]
            mo = ap if M is A else decode(M[v], None if MS is None else MS[v])[None]
            one = pipe._fine(ap, mo, torch.tensor([ctxs[v]], dtype=torch.int32),
                             torch.tensor([[[w]]]),
                             *(torch.from_numpy(x[qi : qi + 1][None])
                               for x in (toks_np, tmask_np, clss)))
            for g, x in zip(packed, one):
                np.testing.assert_allclose(g[row].numpy(), x[0, 0, 0].numpy(),
                                           rtol=1e-5, atol=1e-6)


def test_one_search_is_one_dispatch_of_its_windows(model, library):
    """A /search whose windows lie in several videos runs one fine dispatch
    of exactly its `search_windows` windows, and /stats reports it."""
    _, _, queries = library
    videos = library[0]
    svc = MomentService(model, _cfg(), device="cpu")
    for cid, feats in videos.items():
        svc.retriever.add_video(cid, feats)
    spy = _Spy(svc.retriever)
    tok, cls = queries[1]
    for sw in (None, 9):
        body = dict(token_features=tok.tolist(), cls_feature=cls.tolist())
        if sw is not None:
            body["search_windows"] = sw
        status, got = svc.handle("POST", "/search", body)
        assert status == 200 and got["moments"]
    assert [n for _, n in spy.dispatches] == [4, 9]
    assert len({cid for cid, _, _ in spy.dispatches[1][0]}) >= 2
    status, stats = svc.handle("GET", "/stats", None)
    assert status == 200 and stats["fine"] == {"windows": 13, "dispatches": 2}


@pytest.mark.parametrize("fine_chunk,search_windows", [(1, 5), (1, 9), (2, 9), (3, 7)])
def test_batch_splits_by_window_count(model, library, fine_chunk, search_windows):
    """Each query's windows cut into ceil(windows / (fine_chunk x
    topk_window)) dispatches of its own, none larger, none padded; the
    answers are those of one dispatch a query and those of single
    searches."""
    _, _, queries = library
    toks, clss = [q[0] for q in queries], np.stack([q[1] for q in queries])
    r = _retriever(model, library, fine_chunk=fine_chunk)
    spy = _Spy(r)
    got = r.search_batch(toks, clss, search_windows=search_windows)
    cap = fine_chunk * 4
    sizes = [n for _, n in spy.dispatches]
    assert len(sizes) == len(queries) * math.ceil(search_windows / cap)
    assert max(sizes) <= cap and sum(sizes) == len(queries) * search_windows
    assert all(len({qi for _, qi, _ in part}) == 1 for part, _ in spy.dispatches)
    assert (r.fine_windows, r.fine_dispatches) == (sum(sizes), len(sizes))
    whole = _retriever(model, library, fine_chunk=64)
    assert whole.search_batch(toks, clss, search_windows=search_windows) == got
    assert whole.fine_dispatches == len(queries)
    assert got == [r.search(t, c, search_windows=search_windows) for t, c in zip(toks, clss)]


@pytest.mark.parametrize("search_windows", [4, 11])
def test_a_query_runs_the_same_dispatches_alone_and_in_a_batch(model, library,
                                                               search_windows):
    """A query's fine dispatches hold the same windows in the same order,
    whether it is searched alone or with others: the forward's shapes, and
    so its rounding on any device, do not depend on the batch."""
    _, _, queries = library
    toks, clss = [q[0] for q in queries], np.stack([q[1] for q in queries])
    r = _retriever(model, library, fine_chunk=2)
    spy = _Spy(r)
    r.search_batch(toks, clss, search_windows=search_windows)
    batched = [part for part, _ in spy.dispatches]
    spy.dispatches.clear()
    for qi in range(len(queries)):
        r.search_batch([toks[qi]], clss[qi : qi + 1], search_windows=search_windows)
    alone = [part for part, _ in spy.dispatches]
    assert len(batched) == len(alone) == len(queries) * math.ceil(search_windows / 8)
    for b, a in zip(batched, alone):
        assert [(cid, w) for cid, _, w in b] == [(cid, w) for cid, _, w in a]
        assert {qi for _, qi, _ in a} == {0}


def test_adaptive_margin_refines_only_the_surviving_windows(model, library):
    _, _, queries = library
    r = _retriever(model, library)
    tok, cls = queries[2]
    r.search(tok, cls, adaptive_margin=0.0, search_windows=12)
    assert 1 <= r.fine_windows < 12 and r.fine_dispatches == 1
