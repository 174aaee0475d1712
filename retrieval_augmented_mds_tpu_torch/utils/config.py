"""Typed config system: dataclasses hydrated from the YAML schema.

Counterpart of ``retrieval_augmented_mds_tpu/utils/config.py``, which
imports JAX through its RAGConfig, GenerationOptions and TrainHyper. This
module reads the SAME schema (field names, presets, defaults) into the
port's own dataclasses, so one YAML file drives either package. PyYAML is
imported only by `load_config`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..models.config import EncoderConfig, Seq2SeqConfig
from ..models.generate import GenerationOptions
from ..models.retriever_generator import RAGConfig


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    """Training knobs of `train.trainer.make_train_step` and
    `cli.build_tx`. ``remat``: False, True/"full" or
    "dots_with_no_batch_dims_saveable" (`models.core.maybe_remat`; other
    policy names raise). ``adam_8bit``: the 8-bit AdamW of
    `train.adam8bit`. ``adam_8bit_fused`` is accepted and has no effect:
    the port routes the 8-bit update by device (kernel K9 on the card, its
    plain version on the CPU), and both compute the same function."""

    lr: float = 3e-5
    warmup_steps: int = 1000
    total_steps: int = 100_000
    label_smoothing_eps: float = 0.1
    grad_clip: float | None = 0.1
    weight_decay: float = 0.0
    accumulate_steps: int = 1
    frozen_groups: tuple[str, ...] = ()
    save_every: int = 0
    remat: bool | str = False
    adam_mu_dtype: str | None = "bfloat16"
    adam_8bit: bool = False
    adam_8bit_fused: bool = False
    grad_group_norms: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"  # "synthetic" | "fixture" | "multi_x_science" | path
    dataset_mode: str = "original"  # original | aggregated | dual
    corpus_column: str = "ref_abstract"
    mips_dataset: str = "multi_x_science"
    mips_arxiv_path: str | None = None
    tokenizer: str | None = None  # HF name; None → hash tokenizer
    tokenizer_fallback: str = "error"
    doc_sep: str = "<DOC_SEP>"
    max_length: int = 1024
    query_max_length: int = 256
    decoder_max_length: int = 256
    memory_len: int = 128
    n_synthetic: int = 64
    source_memory: bool = False
    batch_size: int = 4
    mips_db_max_size: int | None = None
    cache_dir: str | None = None


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    factory: str = "Flat"
    metric: str = "ip"
    normalize: bool = False
    nprobe: int = 8
    train_size: int | None = None
    dtype: str = "bfloat16"
    rebuild_every: int = 650


@dataclasses.dataclass(frozen=True)
class RetrieverPretrainConfig:
    temperature: float = 1.0
    pooling_dim: int | None = None
    token_loss: bool = False
    pair_mode: str = "abstract"
    eval_k: int = 10
    hf_export: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int | None = None
    shard: int | None = None


@dataclasses.dataclass(frozen=True)
class LoggingConfig:
    log_dir: str = "./runs"
    run_name: str = "run"
    teams_webhook: str | None = None
    tensorboard: bool = False
    mlflow: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: RAGConfig
    train: TrainHyper = TrainHyper()
    generation: GenerationOptions = GenerationOptions()
    data: DataConfig = DataConfig()
    index: IndexConfig = IndexConfig()
    retriever: RetrieverPretrainConfig = RetrieverPretrainConfig()
    mesh: MeshConfig = MeshConfig()
    logging: LoggingConfig = LoggingConfig()
    seed: int = 0
    precision: str = "float32"  # or "bfloat16"
    max_steps: int = 100
    eval_every: int = 50
    eval_max_batches: int | None = None
    ckpt_dir: str | None = None
    baseline: str | None = None
    compilation_cache_dir: str | None = None


_REGISTRY = {
    "model": RAGConfig,
    "led": Seq2SeqConfig,
    "query_enc": EncoderConfig,
    "mips_enc": EncoderConfig,
    "memory_enc": EncoderConfig,
    "train": TrainHyper,
    "generation": GenerationOptions,
    "data": DataConfig,
    "index": IndexConfig,
    "retriever": RetrieverPretrainConfig,
    "mesh": MeshConfig,
    "logging": LoggingConfig,
}

_PRESETS = {
    "tiny": lambda: RAGConfig.tiny(),
    "led_base": lambda: RAGConfig(
        led=Seq2SeqConfig.led_base(),
        query_enc=EncoderConfig.longformer_base(),
        mips_enc=EncoderConfig.longformer_base(),
        memory_enc=EncoderConfig.longformer_base(),
    ),
    "led_large": lambda: RAGConfig(
        led=Seq2SeqConfig.led_large(),
        query_enc=EncoderConfig.longformer_large(),
        mips_enc=EncoderConfig.longformer_large(),
        memory_enc=EncoderConfig.longformer_large(),
    ),
}


def _hydrate(cls, d: dict[str, Any]):
    kwargs = {}
    fields = {f.name for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"{cls.__name__} has no field {k!r}")
        if isinstance(v, dict) and k in _REGISTRY:
            kwargs[k] = _hydrate(_REGISTRY[k], v)
        else:
            kwargs[k] = tuple(v) if isinstance(v, list) and k == "frozen_groups" else v
    return cls(**kwargs)


def config_from_dict(d: dict[str, Any]) -> ExperimentConfig:
    d = dict(d)
    model_d = dict(d.pop("model", {}))
    base = _PRESETS[model_d.pop("preset", "tiny")]()
    sub = {}
    for enc_key in ("led", "query_enc", "mips_enc", "memory_enc"):
        if enc_key in model_d:
            cur = dataclasses.asdict(getattr(base, enc_key))
            cur.update(model_d.pop(enc_key))
            sub[enc_key] = _REGISTRY[enc_key](**cur)
    model = dataclasses.replace(base, **sub, **model_d)
    rest = {
        k: _hydrate(_REGISTRY[k], v) if k in _REGISTRY and isinstance(v, dict) else v
        for k, v in d.items()
    }
    return ExperimentConfig(model=model, **rest)


def load_config(path: str) -> ExperimentConfig:
    import yaml

    with open(path) as f:
        return config_from_dict(yaml.safe_load(f) or {})
