"""Traffic drivers, one per kind (`eval`, `train`, `serve`), each found by
the `kind` of a traffic mix. A driver makes the inputs from the seed,
builds the program's objects, runs the window, counts what it attempted
and what failed, and hands what the timed path produced to the check.

    Driver(ctx).setup()            inputs, weights, warm-up (set-up)
    Driver.window(seconds) -> {"metrics": {...}, "attempted", "failed"}
    Driver.release()               drop the program's state
    Driver.check() -> {number: value}   judged against the reference
"""

from __future__ import annotations


def program_dataset(corpus, data_cfg):
    """The program's GroundingDataset over an in-memory store of the
    corpus, as a feature store would hold it."""
    from cone_tpu_torch.data.dataset import GroundingDataset, QueryExample
    from cone_tpu_torch.data.store import InMemoryArrayStore, TextFeatureStore

    vids = dict(zip(corpus.video_ids, corpus.feats))
    toks = dict(zip(corpus.query_ids, corpus.tokens))
    clss = {q: corpus.cls[i][None] for i, q in enumerate(corpus.query_ids)}
    examples = []
    for i, qid in enumerate(corpus.query_ids):
        v = corpus.video_ids[corpus.video[i]]
        st, ed = corpus.gt[i]
        examples.append(QueryExample(
            query_id=qid, query=f"query {qid}", video_id=v, clip_id=v,
            timestamps=[float(st * data_cfg.clip_length), float(ed * data_cfg.clip_length)],
            duration=float(corpus.ctx[corpus.video[i]] * data_cfg.clip_length)))
    text = TextFeatureStore(InMemoryArrayStore(toks), InMemoryArrayStore(clss))
    return GroundingDataset(examples, InMemoryArrayStore(vids), text, data_cfg)


def program_model(cfg, params, device):
    """The program's CONE model holding the seeded weights."""
    from cone_tpu_torch.models.cone import ConeModel

    model = ConeModel(cfg.model, device=device)
    model.load_state_dict(params, strict=True)
    return model


def reference_precision(device, tf32: bool) -> None:
    """The reference's float32: TF32 off (the control turns it on)."""
    import torch

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
