"""Config system: dataclasses + YAML/CLI parsing.

Mirrors the knob surface of the reference config layer
(reference args.py:16-96) so reference YAML configs port 1:1,
while adding the framework's own knobs (dtype policy, index engine). This is
the PyTorch port's copy of the JAX package's config module: the same knobs,
so one YAML drives either package, plus `device`.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml

BEIR_DATASETS = (
    "trec-covid,nfcorpus,nq,hotpotqa,fiqa,arguana,webis-touche2020,"
    "dbpedia-entity,scidocs,fever,climate-fever,scifact,quora"
)
MIRACL_DATASETS = "bn,te,es,fr,id,hi,ru,ar,zh,fa,ja,fi,sw,ko,en"
TYDI_DATASETS = (
    "arabic,bengali,english,finnish,indonesian,japanese,korean,russian,swahili,telugu"
)
NANO_BEIR_DATASETS = (
    "NanoClimateFEVER,NanoDBPedia,NanoFEVER,NanoFiQA2018,NanoHotpotQA,"
    "NanoNFCorpus,NanoNQ,NanoQuoraRetrieval,NanoSCIDOCS,NanoArguAna,"
    "NanoSciFact,NanoTouche2020"
)


def _null(v):
    """Reference configs use the string "null" to mean None (args.py:65-72)."""
    return None if v == "null" else v


@dataclass
class ModelArguments:
    """Knob parity with reference ModelArguments (args.py:54-72)."""

    inf_free: bool = True
    model_name_or_path: Optional[str] = None
    tokenizer_name: Optional[str] = None
    idf_path: Optional[str] = None
    idf_requires_grad: bool = False
    prune_ratio: Optional[float] = None
    preprocess_func: Optional[str] = None
    use_l0: bool = False

    # --- framework extensions ---
    # Named architecture preset used when model_name_or_path is not a local
    # checkpoint directory ("mini" / "distill" / "base"); see models/bert.py.
    arch: Optional[str] = None
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Rematerialize transformer layers in the backward pass: ~1 extra forward
    # of FLOPs for O(layers) less activation memory (torch.utils.checkpoint
    # per layer, models/bert.py)
    remat: bool = False

    def __post_init__(self):
        self.idf_path = _null(self.idf_path)
        self.preprocess_func = _null(self.preprocess_func)
        if self.tokenizer_name is None:
            self.tokenizer_name = self.model_name_or_path


@dataclass
class DataArguments:
    """Knob parity with reference DataTrainingArguments (args.py:16-51)."""

    max_seq_length: int = 512
    eval_max_seq_length: int = 512
    train_file: Optional[str] = None
    train_file_dir: Optional[str] = None
    data_type: str = "kd"
    loss_types: List[str] = field(default_factory=lambda: ["kldiv"])
    beir_dir: str = "data/beir"
    miracl_dir: str = "mdata/miracl_eval"
    beir_datasets: str = BEIR_DATASETS
    miracl_datasets: str = MIRACL_DATASETS
    sample_num_one_query: int = 2
    use_in_batch_negatives: bool = False
    flops_d_lambda: float = 1e-3
    flops_d_T: float = 10000
    flops_q_lambda: Optional[float] = None
    flops_q_T: Optional[float] = None
    ranking_loss_weight: float = 1.0
    kd_ensemble_teacher_kwargs: Dict[str, Any] = field(default_factory=dict)
    idf_lr: Optional[float] = None
    first_rank_thresh: int = 10000
    use_two_phase: bool = False
    skip_ingest: bool = False
    do_search: bool = True
    query_prune: float = 0.0
    flops_threshold: Optional[int] = None
    swap_times: float = 0
    temperature: float = 1.0
    score_scale: float = 1.0

    # NanoBEIR-style per-checkpoint eval sweep (reference evaluate_beir.py
    # :365-378); empty = skip. Dataset names resolve under beir_dir or
    # "synthetic".
    nano_beir_datasets: str = ""

    # --- framework extensions ---
    # Metric cutoffs for the BEIR harness. The reference pins [1, 10]
    # (evaluate_beir.py:187-190); 100 is added so the north-star recall@100
    # (BASELINE.json) is actually produced. result_size (docs retrieved per
    # query) defaults to max(k_values) so every cutoff is meaningful; the
    # reference's fixed 15 is available by setting eval_result_size: 15.
    eval_k_values: List[int] = field(default_factory=lambda: [1, 10, 100])
    eval_result_size: Optional[int] = None
    # Pad-to buckets for tokenized batches (one batch shape per bucket).
    seq_buckets: List[int] = field(default_factory=lambda: [64, 128, 256, 512])
    # Mining bootstrap: build the mining index from idf-weighted bags of
    # tokens (no trained doc encoder needed) — see cli/mine.py.
    mine_doc_inf_free: bool = False
    # Index engine knobs for eval/mining (see index.engine.IndexConfig)
    index_engine: str = "auto"
    index_l_max: int = 256
    index_postings_cap: int = 2048
    index_query_batch: int = 64
    index_query_terms: int = 16
    # inverted engines: re-run uncertified queries on the exact scan so
    # every result is provably exact (IndexConfig.exact_escalate); eval
    # reports certified_frac/escalated_frac alongside NDCG. None = the
    # engine default (ON exactly when index_engine="auto" resolves to
    # inverted — auto keeps the scan's exact contract); True/False pin it.
    index_exact_escalate: Optional[bool] = None
    # two-phase mechanism for use_two_phase: "query" = the reference's
    # OpenSearch processor semantics (phase 1 scores tokens with weight >=
    # ratio * max, phase 2 rescores with the rest), "doc" = doc-side
    # impact pruning (see IndexConfig.two_phase_mode)
    index_two_phase_mode: str = "query"
    index_two_phase_ratio: float = 0.4
    # "docs" = corpus stripes per device; "queries" = replicated index,
    # query batch sharded (zero-collective hot path when the corpus fits
    # one device) — see IndexConfig.shard_by
    index_shard_by: str = "docs"
    # candidate-pool depth for the exact rescore (k1 = expand * k): deeper
    # pools tighten the certificate's cut term — see
    # IndexConfig.inverted_rescore_expand
    index_rescore_expand: int = 16
    # tiered adaptive postings depth: keep postings_ext_cap extra postings
    # for the few zipf-head tokens whose lists extend past the cap, read
    # them for the deep_slots largest bound contributors per query — see
    # IndexConfig.postings_ext_cap / deep_slots
    index_postings_ext_cap: int = 0
    index_deep_slots: int = 2


@dataclass
class MiningArguments:
    """Mirror of reference MiningArguments (args.py:76-79). NOTE: declared
    but never consumed by the reference either — demo_train_data.py reads
    `beir_datasets`. Kept so configs naming these knobs parse; cli/mine.py
    honors `mine_datasets` (falls back to `beir_datasets`) and `source`
    (overrides the mining model checkpoint)."""

    mine_datasets: Optional[str] = None
    source: Optional[str] = None

    def __post_init__(self):
        self.mine_datasets = _null(self.mine_datasets)
        self.source = _null(self.source)


@dataclass
class TrainingArguments:
    """The subset of HF TrainingArguments the reference recipes exercise,
    plus the framework's own knobs (train/trainer.py, cli/train_ir.py)."""

    output_dir: str = "output/run"
    per_device_train_batch_size: int = 8
    per_device_eval_batch_size: int = 50
    # HF TrainingArguments surface (reference args.py:6 inherits it): one
    # optimizer step per N microbatches, gradients averaged, so peak
    # activation memory is bounded by ONE microbatch (effective batch =
    # per_device * data-parallel size * this).
    gradient_accumulation_steps: int = 1
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    max_steps: int = 1000
    warmup_steps: int = 0
    lr_scheduler_type: str = "linear"
    max_grad_norm: Optional[float] = None
    logging_steps: int = 10
    save_strategy: str = "steps"
    save_steps: int = 500
    seed: int = 42
    fp16: bool = False  # accepted for config parity; compute_dtype rules
    bf16: bool = True
    log_level: str = "info"
    dataloader_drop_last: bool = True
    dataloader_num_workers: int = 0
    dataloader_pin_memory: bool = True
    dataloader_persistent_workers: bool = False
    dataloader_prefetch_factor: Optional[int] = None

    # --- framework extensions ---
    # Device the port runs on: "cuda" (the default; raises without a card)
    # or "cpu" on request (`--device cpu`). See core/device.py.
    device: str = "cuda"
    # Data-parallel mesh size, as in the JAX package: in one process
    # cli.train_ir trains over make_mesh(dp_size) of the visible cards
    # (-1: all; more than there are raises), and cli.evaluate_beir and
    # cli.mine shard their index over it (core/mesh.py::process_mesh).
    # Under a launch of more than one process each rank's mesh is its own
    # card, and dp_size must be -1 or WORLD_SIZE
    # (core/distributed.py::check_dp_size).
    dp_size: int = -1
    donate_state: bool = True
    profile_dir: Optional[str] = None
    # Resume from {output_dir}/train_state (the port's torch.save of model,
    # optimizer, schedule, step and loss moving average) — exact resume,
    # which the reference lacks (SURVEY §5). The data stream fast-forwards
    # to the restored step (epoch seed + in-epoch position), so the resumed
    # run sees the batch sequence an uninterrupted run would.
    resume: bool = False

    def __post_init__(self):
        self.max_grad_norm = _null(self.max_grad_norm)


_IGNORED_KEYS = {
    # HF TrainingArguments knobs that appear in reference YAMLs but have no
    # effect here (logged, not errors).
    "log_level_replica",
    "half_precision_backend",
    "save_safetensors",
    "save_total_limit",
}


def _split_fields(raw: Dict[str, Any]):
    leftovers = {}
    cls_fields = {
        "model": {f.name for f in dataclasses.fields(ModelArguments)},
        "data": {f.name for f in dataclasses.fields(DataArguments)},
        "train": {f.name for f in dataclasses.fields(TrainingArguments)},
        "mine": {f.name for f in dataclasses.fields(MiningArguments)},
    }
    buckets = {"model": {}, "data": {}, "train": {}, "mine": {}}
    for k, v in raw.items():
        placed = False
        for name, fields_ in cls_fields.items():
            if k in fields_:
                buckets[name][k] = v
                placed = True
                break
        if not placed and k not in _IGNORED_KEYS:
            leftovers[k] = v
    return buckets, leftovers


def _parse_flag_args(argv: List[str]) -> Dict[str, Any]:
    """`--key value` / `--key=value` flags -> raw config dict (the CLI-flag
    path of reference args.py:81-96 / run_ft_demo.sh). Values are YAML-typed
    ("true" -> bool, "0.05" -> float, "a,b" stays str for comma-list knobs)."""
    raw: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected --flag, got {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            val = argv[i + 1]
            i += 2
        else:  # bare --flag means true
            val = "true"
            i += 1
        try:
            raw[key.replace("-", "_")] = yaml.safe_load(val)
        except yaml.YAMLError:
            raw[key.replace("-", "_")] = val
    return raw


def _coerce_scalar_fields(bucket: Dict[str, Any], cls) -> None:
    """Cast string values into declared float/int/bool field types.

    YAML 1.1 (PyYAML) parses `2e-5` — scientific notation without a decimal
    point — as a STRING, and the reference relies on HfArgumentParser's
    field-type coercion to fix it up (args.py:81-96). Without this, a
    reference YAML's `learning_rate: 2e-5` reaches the optimizer as '2e-5'
    and crashes at trace time with an unrelated-looking TypeError."""
    for f in dataclasses.fields(cls):
        v = bucket.get(f.name)
        if not isinstance(v, str):
            continue
        t = str(f.type)
        if "List" in t or "Dict" in t or "str" in t:
            continue
        s = v.strip()
        if s.lower() in ("null", "none", ""):
            # "null" on an Optional numeric/bool knob means None (the
            # reference normalizes this per-field, args.py:65-72; doing it
            # by type covers every Optional knob)
            if "Optional" in t:
                bucket[f.name] = None
            continue
        try:
            if "bool" in t:
                if s.lower() in ("true", "yes", "1"):
                    bucket[f.name] = True
                elif s.lower() in ("false", "no", "0"):
                    bucket[f.name] = False
            elif "int" in t:
                bucket[f.name] = int(float(s))
            elif "float" in t:
                bucket[f.name] = float(s)
        except ValueError:
            pass  # leave it; the consumer raises with the field name


def _coerce_list_fields(bucket: Dict[str, Any], cls) -> None:
    """CLI flags arrive as scalars; List-typed dataclass fields take
    comma-split values ("--loss_types infonce,kldiv")."""
    for f in dataclasses.fields(cls):
        v = bucket.get(f.name)
        if v is None or not str(f.type).startswith("List"):
            continue
        if isinstance(v, (str, int, float)):
            parts = str(v).split(",")
            bucket[f.name] = [yaml.safe_load(p) for p in parts]


def parse_config(
    source: Optional[Any] = None,
    with_mining: bool = False,
):
    """Parse a YAML file path, a dict, or argv into the three arg groups.

    Reference parity (args.py:81-96): `python cli/train_ir.py cfg.yaml`
    consumes a single flat YAML; any other argv shape is parsed as
    `[cfg.yaml] --flag value ...` with flags overriding the YAML — so the
    reference's flag-driven invocations (run_ft_demo.sh) port unchanged.
    A dict input is used programmatically / in tests.
    """
    if source is None:
        argv = sys.argv[1:]
        if len(argv) == 1 and argv[0].endswith((".yaml", ".yml")):
            source = argv[0]
        else:
            raw_argv: Dict[str, Any] = {}
            if argv and not argv[0].startswith("--"):
                with open(argv[0]) as f:
                    raw_argv = yaml.safe_load(f) or {}
                argv = argv[1:]
            raw_argv.update(_parse_flag_args(argv))
            source = raw_argv
    if isinstance(source, str):
        with open(source) as f:
            raw = yaml.safe_load(f) or {}
    elif isinstance(source, dict):
        raw = dict(source)
    else:
        raise TypeError(f"unsupported config source: {type(source)}")

    buckets, leftovers = _split_fields(raw)
    if leftovers:
        import logging

        logging.getLogger(__name__).warning("unknown config keys ignored: %s", leftovers)

    for name, cls in (("model", ModelArguments), ("data", DataArguments),
                      ("train", TrainingArguments), ("mine", MiningArguments)):
        _coerce_list_fields(buckets[name], cls)
        _coerce_scalar_fields(buckets[name], cls)
    model_args = ModelArguments(**buckets["model"])
    data_args = DataArguments(**buckets["data"])
    training_args = TrainingArguments(**buckets["train"])
    os.makedirs(training_args.output_dir, exist_ok=True)
    if with_mining:
        return model_args, data_args, training_args, MiningArguments(**buckets["mine"])
    return model_args, data_args, training_args


def snapshot_config(model_args, data_args, training_args, path: str):
    """Write the resolved config into the output dir for reproducibility
    (reference: train_ir.py:33-44)."""
    blob = {
        "model_args": dataclasses.asdict(model_args),
        "data_args": dataclasses.asdict(data_args),
        "training_args": dataclasses.asdict(training_args),
    }
    with open(path, "w") as f:
        yaml.dump(blob, f, sort_keys=False)
