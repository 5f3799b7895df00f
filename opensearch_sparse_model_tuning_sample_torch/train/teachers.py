"""Teacher ensembles for knowledge distillation (kd-ensemble).

The port of the JAX package's `train/teachers.py` (reference
bi_encoder_wrapper.py):

  * sparse bi-encoder teacher: the MLM masked max-pool, log1p(relu), with
    the special-token columns zeroed (:12-35). On the card the max-pool is
    the ingest kernel (`BertForMaskedLM.mlm_maxpool` under no_grad);
  * dense bi-encoder teacher: the CLS (or masked-mean) embedding,
    L2-normalised (:38-59);
  * precomputed ("remote") teacher: embeddings fetched by id from the local
    mmap store (train/embedding_store.py) in place of DynamoDB (:62-88);
  * host teacher ("hf"): any architecture `transformers` loads, on the
    trainer's device, for checkpoints the native importer does not map;
  * per-teacher min-max score normalisation per query row, the ensemble
    mean, times score_scale (:133-146).

Teachers are frozen `BertForMaskedLM` modules in eval mode on the trainer's
device with `requires_grad_(False)`, owned by the ensemble and never by the
student: they stay out of the optimizer, the clip norm, the train state and
the checkpoints. Their reps come from plain functions under
`torch.no_grad()`, so the max-pool takes the ingest kernel, never the
training kernels, and keeps no residuals.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from ..core.device import DeviceLike, resolve_device
from ..models import bert as bert_mod
from ..models.bert import BertForMaskedLM
from ..models.tokenizer import WordPieceTokenizer, load_tokenizer
from ..ops.activations import pooled_activation, special_token_mask
from ..ops.losses import pair_scores

logger = logging.getLogger(__name__)


@dataclass
class Teacher:
    kind: str  # "sparse" | "dense" | "remote" | "hf"
    bert: Optional[BertForMaskedLM] = None  # frozen, sparse/dense only
    tokenizer: Any = None
    special_mask: Optional[torch.Tensor] = None  # [V] bool, sparse only
    model_id: Optional[str] = None
    # dense pooling: "cls" (reference DenseModel.get_dense_embedding,
    # bi_encoder_wrapper.py:43-48) or "mean" (sentence-transformers)
    pooling: str = "cls"
    host_model: Any = None  # HostTeacherModel for kind "hf"


@torch.no_grad()
def sparse_teacher_rep(bert: BertForMaskedLM, special_mask: torch.Tensor,
                       input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """MLM masked max-pool -> log1p(relu), special tokens zeroed: [B, V] fp32.
    The max-pool is the production head (`mlm_maxpool`: the head's
    activation, the untied decoder if any, an fp32 bias); under no_grad it
    launches the ingest kernel on the card and runs the plain version on the
    CPU."""
    hidden = bert.encode_hidden(input_ids, attention_mask)
    pooled = bert.mlm_maxpool(hidden, attention_mask)
    rep = pooled_activation(pooled)[:, : bert.cfg.vocab_size]
    return torch.where(special_mask[None, :], 0.0, rep)


@torch.no_grad()
def dense_teacher_rep(bert: BertForMaskedLM, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor, pooling: str = "cls") -> torch.Tensor:
    """Pooled sentence embedding [B, D] fp32, L2-normalised. "cls" is the
    reference's (bi_encoder_wrapper.py:43-48); "mean" the masked token mean."""
    hidden = bert.encode_hidden(input_ids, attention_mask).float()
    if pooling == "mean":
        m = attention_mask[:, :, None].float()
        pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
    elif pooling == "cls":
        pooled = hidden[:, 0, :]
    else:
        raise ValueError(f"unknown pooling {pooling!r} (use 'cls' or 'mean')")
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def teacher_rep(teacher: Teacher, features: Dict[str, torch.Tensor]) -> torch.Tensor:
    if teacher.kind == "sparse":
        return sparse_teacher_rep(teacher.bert, teacher.special_mask,
                                  features["input_ids"], features["attention_mask"])
    if teacher.kind == "dense":
        return dense_teacher_rep(teacher.bert, features["input_ids"],
                                 features["attention_mask"], pooling=teacher.pooling)
    if teacher.kind in ("remote", "hf"):
        # precomputed: prefetched from the store (remote), or computed by
        # host_precompute before the step (hf)
        return features["embeddings"].float()
    raise KeyError(teacher.kind)


class HostTeacherModel:
    """A teacher checkpoint the native importer cannot map, hosted through
    `transformers` (the reference loads any architecture with
    AutoModel(ForMaskedLM), bi_encoder_wrapper.py:19-20, 53-55; config_kd's
    gte-large-en-v1.5 is one). It tokenizes the batch's raw texts itself and
    runs on the trainer's device before the step; its [B, H] or [B, V] reps
    enter the step as precomputed embeddings. Local files only, no remote
    modeling code."""

    def __init__(self, model_dir: str, kind: str = "dense", pooling: str = "cls",
                 max_length: int = 512, device: DeviceLike = None):
        try:
            import transformers
        except ImportError as e:
            raise ImportError(
                "opensearch_sparse_model_tuning_sample_torch: a host teacher (kind 'hf', or "
                f"a checkpoint the native importer does not map: {model_dir}) needs the "
                "transformers package") from e
        self.kind = kind
        self.pooling = pooling
        self.max_length = max_length
        self.device = resolve_device(device)
        self.tokenizer = transformers.AutoTokenizer.from_pretrained(model_dir,
                                                                    local_files_only=True)
        if kind == "sparse":
            self.model = transformers.AutoModelForMaskedLM.from_pretrained(
                model_dir, local_files_only=True)
            self.special_ids = sorted({
                self.tokenizer.convert_tokens_to_ids(t)
                for t in self.tokenizer.special_tokens_map.values() if isinstance(t, str)})
        else:
            self.model = transformers.AutoModel.from_pretrained(model_dir,
                                                                local_files_only=True)
        self.model.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def encode(self, texts) -> torch.Tensor:
        f = self.tokenizer(list(texts), padding=True, truncation=True,
                           max_length=self.max_length, return_tensors="pt").to(self.device)
        out = self.model(**f)
        if self.kind == "sparse":
            # reference BiSparseModel.forward (bi_encoder_wrapper.py:28-35)
            values = (out[0] * f["attention_mask"].unsqueeze(-1)).max(dim=1).values
            values = torch.log1p(torch.relu(values))
            values[:, self.special_ids] = 0
            return values.float()
        hidden = out[0]
        if self.pooling == "mean":
            m = f["attention_mask"].unsqueeze(-1).float()
            pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)
        else:
            pooled = hidden[:, 0]
        return torch.nn.functional.normalize(pooled, p=2, dim=1).float()


def _teacher_on(teacher: Teacher, device: torch.device) -> Teacher:
    """A frozen copy of a teacher's module on `device` (precomputed and host
    teachers have none: their reps arrive as features)."""
    if teacher.bert is None:
        return teacher
    return dataclasses.replace(
        teacher, bert=copy.deepcopy(teacher.bert).to(device).requires_grad_(False),
        special_mask=None if teacher.special_mask is None else teacher.special_mask.to(device))


def minmax_normalize(score: torch.Tensor) -> torch.Tensor:
    """Per-query-row min-max normalisation (bi_encoder_wrapper.py:133-137),
    which makes teachers of different scales ensemble-able. A row whose
    scores tie normalises to 0."""
    mx = score.amax(dim=1, keepdim=True)
    mn = score.amin(dim=1, keepdim=True)
    return (score - mn) / (mx - mn + 1e-6)


class TeacherEnsemble:
    """The configured ensemble; `get_scores` runs inside the train step
    (reference BiEncoderWrapper.get_scores_batch,
    bi_encoder_wrapper.py:117-146)."""

    def __init__(self, teachers: List[Teacher], score_scale: float = 30.0,
                 use_in_batch_negatives: bool = False):
        if not teachers:
            raise ValueError("a teacher ensemble needs at least one teacher")
        self.teachers = teachers
        self.score_scale = score_scale
        self.use_in_batch_negatives = use_in_batch_negatives
        self._copies: Dict[torch.device, "TeacherEnsemble"] = {}

    @torch.no_grad()
    def reps(self, features_list: List[Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
        """Each teacher's reps of its features (one batch side), no
        gradient."""
        if len(features_list) != len(self.teachers):
            raise ValueError(f"{len(self.teachers)} teachers, features for "
                             f"{len(features_list)}")
        return [teacher_rep(t, f) for t, f in zip(self.teachers, features_list)]

    @torch.no_grad()
    def scores_from_reps(self, q_reps: List[torch.Tensor],
                         d_reps: List[torch.Tensor]) -> torch.Tensor:
        """[B, B*G] (in-batch negatives) or [B, G] fp32 teacher scores of the
        teachers' reps of the whole batch: each teacher's pair scores
        min-max normalised per row, their mean times score_scale. The fp32
        products run in fp32 on the card too: the port's device policy
        (core/device.py) keeps TF32 off."""
        scores = 0.0
        for q_rep, d_rep in zip(q_reps, d_reps):
            scores = scores + minmax_normalize(
                pair_scores(q_rep, d_rep, self.use_in_batch_negatives))
        return (scores / len(self.teachers) * self.score_scale).detach()

    def get_scores(self, q_features_list: List[Dict[str, torch.Tensor]],
                   d_features_list: List[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """The teacher scores of one whole batch: `scores_from_reps` of
        `reps`. (The train step gathers the reps of a rank's or a mesh
        position's rows between the two.)"""
        return self.scores_from_reps(self.reps(q_features_list), self.reps(d_features_list))

    def on(self, device: torch.device) -> "TeacherEnsemble":
        """This ensemble with its teachers' modules on `device`: itself on
        the teachers' own device, else frozen copies made once per device
        and kept (the positions of a mesh that share a device share them)."""
        device = torch.device(device)
        own = next((t.bert.embeddings.word_embeddings.device for t in self.teachers
                    if t.bert is not None), None)
        if own is None or own == device:
            return self
        if device not in self._copies:
            self._copies[device] = TeacherEnsemble(
                [_teacher_on(t, device) for t in self.teachers], self.score_scale,
                self.use_in_batch_negatives)
        return self._copies[device]

    @property
    def has_host(self) -> bool:
        return any(t.kind == "hf" for t in self.teachers)

    def host_precompute(self, batch: Dict) -> Dict:
        """Run the host teachers on the raw texts the collator attached,
        replacing their {"texts"} features with {"embeddings"} (the remote
        teachers' contract). The trainer calls it before the step."""
        if not self.has_host:
            return batch
        out = dict(batch)
        for key in ("teacher_q", "teacher_d"):
            feats = list(batch.get(key) or [])
            for i, t in enumerate(self.teachers):
                if t.kind == "hf" and i < len(feats) and "texts" in feats[i]:
                    feats[i] = {"embeddings": t.host_model.encode(feats[i]["texts"])}
            out[key] = feats
        return out


def _build_host_teacher(kind: str, model_id: str, pooling: str, max_length: int,
                        device: DeviceLike) -> Teacher:
    host_kind = "sparse" if kind == "sparse" else "dense"
    host = HostTeacherModel(model_id, kind=host_kind, pooling=pooling,
                            max_length=max_length, device=device)
    logger.info("teacher %s hosted through transformers on %s (%s, pooling=%s)",
                model_id, host.device, host_kind, pooling)
    return Teacher(kind="hf", model_id=model_id, pooling=pooling, host_model=host)


def build_teacher(kind: str, model_id: str, seed: int = 1, pooling: str = "cls",
                  max_length: int = 512, device: DeviceLike = None) -> Teacher:
    """One teacher from (a) a checkpoint dir in a layout the importer maps
    (bert, roberta, distilbert), (b) an arch preset name ("mini", "base",
    ...) for a random-init teacher drawn from `seed`, or (c) "store:<path>"
    / kind "remote" for precomputed embeddings. kind "hf", or a checkpoint
    dir the importer cannot map, is hosted through `transformers`; if that
    fails too, the error names both causes. Runs on the CUDA card unless
    `device="cpu"`."""
    from ..models import hf_import

    if kind == "remote" or model_id.startswith("store:"):
        return Teacher(kind="remote", model_id=model_id)
    if kind == "hf":
        return _build_host_teacher("dense", model_id, pooling, max_length, device)

    dev = resolve_device(device)
    if os.path.isdir(model_id):
        try:
            cfg, sd, _ = hf_import.load_checkpoint(model_id)
            if not isinstance(cfg, bert_mod.BertConfig):
                raise hf_import.UnsupportedArchitecture(
                    f"{cfg.model_type} teachers run through the host path")
            tokenizer = load_tokenizer(model_id)
        except (hf_import.UnsupportedArchitecture, FileNotFoundError, ValueError) as e:
            try:
                return _build_host_teacher(kind, model_id, pooling, max_length, device)
            except Exception as host_err:
                raise ValueError(
                    f"teacher {model_id!r} loads neither natively ({e}) nor through "
                    f"the host path ({host_err})") from e
    else:
        tokenizer = WordPieceTokenizer.from_pretrained(None)
        cfg = bert_mod.config_from_preset(model_id, vocab_size=tokenizer.vocab_size)
        sd = bert_mod.init_state_dict(cfg, seed)
    bert = bert_mod.from_state_dict(cfg, sd, dev).requires_grad_(False)
    smask = None
    if kind == "sparse":
        smask = special_token_mask(tokenizer.special_token_ids, cfg.vocab_size, dev)
    return Teacher(kind=kind, bert=bert, tokenizer=tokenizer,
                   special_mask=smask, model_id=model_id, pooling=pooling)


def build_ensemble(kd_kwargs: Dict[str, Any], use_in_batch_negatives: bool,
                   max_length: int = 512, device: DeviceLike = None) -> TeacherEnsemble:
    """From the kd_ensemble_teacher_kwargs config dict (reference
    trainer.py:158-167; config_kd.yaml:18-22), with the optional `pooling`
    list parallel to `types` (cls or mean per dense teacher). Teacher i's
    random init, if it is a preset, is drawn from seed 10 + i."""
    types, model_ids = kd_kwargs["types"], kd_kwargs["model_ids"]
    poolings = kd_kwargs.get("pooling") or ["cls"] * len(types)
    if not (len(types) == len(model_ids) == len(poolings)) or not types:
        raise ValueError(f"kd_ensemble_teacher_kwargs: {len(types)} types, "
                         f"{len(model_ids)} model_ids, {len(poolings)} poolings")
    teachers = [build_teacher(t, m, seed=10 + i, pooling=p, max_length=max_length,
                              device=device)
                for i, (t, m, p) in enumerate(zip(types, model_ids, poolings))]
    return TeacherEnsemble(teachers, score_scale=kd_kwargs.get("score_scale", 30),
                           use_in_batch_negatives=use_in_batch_negatives)
