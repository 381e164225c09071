"""Typed configuration: nested frozen dataclasses with a JSON round trip.

The port's own copy of the JAX package's configuration: the same six
sections, the same field names and defaults, so a saved `config.json`
parses in either package. `eval.use_pallas_coarse` keeps its name for that
reason; here it selects the hand-written CUDA coarse kernel
(ops/coarse.py) instead of the plain matmul + segment max.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 2
    dec_layers: int = 2
    dim_feedforward: int = 1024
    dropout: float = 0.1
    input_dropout: float = 0.5
    num_queries: int = 5
    t_feat_dim: int = 256          # EgoVLP text dim; 512 CLIP / 768 RoBERTa
    v_motion_feat_dim: int = 256   # Moment-DETR branch video dim
    v_appear_feat_dim: int = 256   # matching/adapter branch video dim
    n_input_proj: int = 2
    model_family: str = "cone"     # "cone" (Moment-DETR head) | "tan" (2D-TAN)
    use_txt_pos: bool = False
    pre_norm: bool = False
    adapter_module: str = "linear"  # "linear" | "none"
    span_loss_type: str = "l1"
    max_q_l: int = 20
    max_v_l: int = 90
    # transformer compute dtype ("float32" | "bfloat16"); params stay float32
    compute_dtype: str = "float32"
    # encoder sequence pad multiple. A layout pad of the JAX package: masked
    # positions change no valid output, so the port reads and ignores it.
    seq_pad_multiple: int = 1


@dataclass(frozen=True)
class TanConfig:
    """CONE-TAN (2D-TAN head) hyperparameters (the port does not run this
    family yet; the section exists so saved configs parse)."""

    num_clips: int = 64
    hidden_size: int = 256
    v_feat_dim: int = 256
    t_feat_dim: int = 768
    txt_hidden_size: int = 256
    lstm_layers: int = 3
    num_scale_layers: tuple = (16, 8, 8)
    map_hidden_sizes: tuple = (256, 256, 256, 256)
    map_kernel_sizes: tuple = (9, 9, 9, 9)
    map_paddings: tuple = (16, 0, 0, 0)
    frame_kernel: int = 1
    frame_stride: int = 1
    frame_module: str = "avg"
    prop_module: str = "sparse_pool"
    dense_num_layers: int = 16
    adapter_module: str = "linear"
    min_iou: float = 0.3
    max_iou: float = 0.7
    bias: float = 0.5
    temperature: float = 0.07
    proposal_top_k: int = 10


@dataclass(frozen=True)
class LossConfig:
    span_loss_coef: float = 10.0
    giou_loss_coef: float = 1.0
    label_loss_coef: float = 4.0
    adapter_loss_coef: float = 1.0
    lw_saliency: float = 1.0
    eos_coef: float = 0.1
    temperature: float = 0.07
    saliency_margin: float = 0.2
    set_cost_span: float = 10.0
    set_cost_giou: float = 1.0
    set_cost_class: float = 4.0
    aux_loss: bool = True
    neg_loss: bool = True
    adapter_loss: bool = True


@dataclass(frozen=True)
class DataConfig:
    dset_name: str = "ego4d"      # "ego4d" | "mad" | "synthetic"
    train_path: Optional[str] = None
    eval_path: Optional[str] = None
    eval_split_name: str = "val"
    motion_feat_dir: Optional[str] = None
    appearance_feat_dir: Optional[str] = None
    t_feat_dir: Optional[str] = None
    max_q_l: int = 20
    max_v_l: int = 90
    clip_length: float = 0.535    # seconds per clip feature (ego4d EgoVLP)
    max_windows: int = 5
    topk_window: int = 20
    data_ratio: float = 1.0
    train_data_ratio: float = 1.0
    normalize_v: bool = True
    normalize_t: bool = True
    txt_drop_ratio: float = 0.0
    # host RAM bound on cached normalized videos (FIFO); 0 = unbounded
    max_cached_videos: int = 0
    # static padded length for whole-video feature arrays (coarse stage)
    max_ctx_l: int = 2304


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    coef_lr: float = 0.1
    wd: float = 1e-4
    lr_drop: int = 120
    plateau_factor: float = 0.8
    plateau_patience: int = 20
    n_epoch: int = 150
    bsz: int = 32
    grad_clip: float = 0.1
    seed: int = 2018
    eval_epoch_interval: int = 3
    max_es_cnt: int = 10
    start_epoch_for_adapter: int = 30
    results_dir: str = "results"
    exp_id: str = "exp"
    save_interval: int = 50
    dp_devices: int = 1
    tp_devices: int = 1
    multiscale: bool = False
    debug: bool = False
    rng_impl: str = "threefry"


@dataclass(frozen=True)
class EvalConfig:
    nms_thd: float = 0.5
    max_before_nms: int = 200
    max_after_nms: int = 5
    eval_modality: str = "both"
    no_sort_results: bool = False
    criterion_losses: bool = True
    # queries per dispatch (fine stage and fused path)
    query_chunk: int = 32
    # context-length buckets: each video pads to the smallest bucket that
    # fits (else data.max_ctx_l). Empty = one max_ctx_l shape.
    ctx_buckets: tuple = ()
    # fused path: (video, query-chunk) work items per dispatch
    video_batch: int = 1
    # coarse stage through the hand-written coarse kernel (ops/coarse.py)
    # instead of the plain matmul + segment max
    use_pallas_coarse: bool = False
    fused_train_eval: bool = False
    # dtype of the device-resident video corpus: "float32" | "bfloat16" |
    # "int8" (symmetric per-frame scales); decoded to fp32 per dispatch
    corpus_dtype: str = "float32"


@dataclass(frozen=True)
class ConeConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    tan: TanConfig = field(default_factory=TanConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str, strict: bool = False) -> "ConeConfig":
        """Parse a config JSON. Unknown keys are dropped with a warning
        (saved configs round-trip across versions), or raise with
        strict=True."""
        raw = json.loads(s)
        eval_raw = raw.get("eval", {})
        if "ctx_buckets" in eval_raw:
            eval_raw["ctx_buckets"] = tuple(eval_raw["ctx_buckets"])
        tan_raw = raw.get("tan", {})
        for k in ("num_scale_layers", "map_hidden_sizes", "map_kernel_sizes",
                  "map_paddings"):
            if k in tan_raw:
                tan_raw[k] = tuple(tan_raw[k])

        def build(section_cls, section_raw, name):
            known = {f.name for f in dataclasses.fields(section_cls)}
            unknown = sorted(set(section_raw) - known)
            if unknown:
                if strict:
                    raise ValueError(
                        f"config section '{name}': unknown keys {unknown}")
                warnings.warn(
                    f"config section '{name}': ignoring unknown keys {unknown}")
            return section_cls(
                **{k: v for k, v in section_raw.items() if k in known})

        return cls(
            model=build(ModelConfig, raw.get("model", {}), "model"),
            loss=build(LossConfig, raw.get("loss", {}), "loss"),
            data=build(DataConfig, raw.get("data", {}), "data"),
            train=build(TrainConfig, raw.get("train", {}), "train"),
            eval=build(EvalConfig, raw.get("eval", {}), "eval"),
            tan=build(TanConfig, tan_raw, "tan"),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str, strict: bool = False) -> "ConeConfig":
        with open(path) as f:
            return cls.from_json(f.read(), strict=strict)

    def replace(self, **sections) -> "ConeConfig":
        return dataclasses.replace(self, **sections)


def ego4d_config() -> ConeConfig:
    """Canonical Ego4D-NLQ EgoVLP config (cone/scripts/train_ego4d.sh:19-36)."""
    return ConeConfig(
        model=ModelConfig(seq_pad_multiple=16),
        data=DataConfig(
            dset_name="ego4d", max_v_l=90, clip_length=0.535, topk_window=20,
            max_ctx_l=2304,
        ),
        train=TrainConfig(n_epoch=150, lr_drop=120, bsz=32,
                          start_epoch_for_adapter=30),
    )


def mad_config() -> ConeConfig:
    """Canonical MAD CLIP config (cone/scripts/train_mad.sh:20-42)."""
    return ConeConfig(
        model=ModelConfig(t_feat_dim=512, v_motion_feat_dim=512,
                          v_appear_feat_dim=512),
        loss=LossConfig(adapter_loss_coef=0.2),
        data=DataConfig(
            dset_name="mad", max_v_l=125, clip_length=0.2, topk_window=30,
            max_ctx_l=65536,
        ),
        train=TrainConfig(n_epoch=30, lr_drop=25, bsz=32, seed=2020),
        eval=EvalConfig(ctx_buckets=(8192, 16384, 24576, 36864, 49152),
                        fused_train_eval=True),
    )
