"""Training traffic: the recipe's step through the port's data layer and
`Trainer.train_step`, on one card or over a mesh of cards in one process.

Set-up makes the rows (a query of `query_words` words, its positive and
`negatives` hard negatives of lognormal length) from the seed, the model
from the seed's weights, the port's collator, loader and Trainer; then it
drives that one Trainer through its first `compared_steps` steps with the
window's own call and feed, keeping what the output check compares (each
step's loss, the first gradient as AdamW's state holds it, the parameters
after the last of them, on every mesh position, and the collated token
ids), and warms up the batch shapes. The window goes on with the same
Trainer: one unit is one loader batch fetched (the span `lsr.data`) and one
`train_step` (`lsr.step`); the collated ids of `sampled_batches` window
steps, drawn from the seed, are kept.

Once the window has closed, the same Trainer runs `compared_steps` more
steps through the same call and feed, from a snapshot of its state
(parameters, AdamW's moments, the step count) taken at the window's end.
The output check runs the plain reference over both stretches: its own
tokenization of the same rows, in the order the loader's seeded shuffle
gives, the same dropout keys, float32 with TF32 off; the first stretch from
the seed's weights, the second from the snapshot (the program's state: the
reference can follow the window's steps only from there). Every kept batch's
ids and masks are held to the reference tokenizer's, exactly.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from .. import roofline
from ..gen import text as textgen
from ..reference import bert as ref_bert
from ..reference import train as ref_train
from ..reference.wordpiece import DATA, WordPiece
from .common import Base, HeadRange, free

TOKEN_KEYS = ("q_input_ids", "q_attention_mask", "d_input_ids", "d_attention_mask")


class Driver(Base):
    def __init__(self, cell):
        super().__init__(cell)
        t = self.t
        self.recipe = dict(t["recipe"])
        self.P = int(t.get("mesh_positions", 1))
        self.G = 1 + int(t["negatives"])
        self.B = int(self.recipe["per_device_train_batch_size"]) * self.P

    # ------------------------------------------------------------ inputs
    def make_rows(self):
        t, seed = self.t, self.cell.seed
        rng = np.random.default_rng(seed & (2**63 - 1))
        words = textgen.Words(t["zipf"])
        n = int(t["rows"])
        qlen = textgen.uniform_lengths(n, *t["query_words"], rng)
        dw = t["doc_words"]
        dlen = textgen.lognormal_lengths(n * self.G, dw["median"], dw["sigma"], dw["min"],
                                         dw["max"], rng)
        qs = textgen.make_texts(words, qlen, rng)
        ds = textgen.make_texts(words, dlen, rng)
        return [(qs[i], ds[i * self.G], ds[i * self.G + 1:(i + 1) * self.G]) for i in range(n)]

    # ------------------------------------------------------------ set-up
    def setup(self):
        from opensearch_sparse_model_tuning_sample_torch.core.config import parse_config
        from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh
        from opensearch_sparse_model_tuning_sample_torch.data.collator import build_collator
        from opensearch_sparse_model_tuning_sample_torch.data.loader import DataLoader, epochs
        from opensearch_sparse_model_tuning_sample_torch.ops.losses import build_loss_specs
        from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

        self.rows = self.make_rows()
        self.head = HeadRange(self.ranges, "maxpool_head_train")
        model = self.program_model(self.recipe.get("idf_path"))
        self.tmp = tempfile.TemporaryDirectory(prefix="lsr_bench_train_")
        margs, dargs, targs = parse_config({**self.recipe, "seed": self.cell.seed,
                                            "output_dir": self.tmp.name, "save_strategy": "no",
                                            "arch": None, "device": str(self.dev)})
        mesh = make_mesh(self.P, devices=self.devices[:self.P] if self.dev.type == "cpu"
                         else None)
        collator = build_collator(dargs.data_type, model.tokenizer, dargs.max_seq_length,
                                  seq_buckets=dargs.seq_buckets)
        if self.fault == "token":
            collator = _alter_tokens(collator)
        loader = DataLoader(self.rows, batch_size=self.B, collate_fn=collator,
                            drop_last=targs.dataloader_drop_last, seed=targs.seed,
                            prefetch=targs.dataloader_prefetch_factor or 0)
        self.trainer = Trainer(model, margs, dargs, targs, loss_specs=build_loss_specs(dargs),
                               mesh=mesh)
        self.undo = _plant(self.fault, self.trainer)
        self.it = epochs(loader, 1 << 62)
        self.per_epoch = len(loader)
        self.start = self.compared_steps()
        seen, steps = set(), 0
        w = self.t["warmup"]
        while steps < w["min_steps"] or (steps < w["max_steps"]
                                         and not set(w["buckets"]) <= seen):
            batch = next(self.it)
            seen.add(batch["d_input_ids"].shape[1])
            self.trainer.train_step(batch)
            steps += 1
        rng = np.random.default_rng((self.cell.seed + 7) & (2**63 - 1))
        self.sample = set(rng.choice(int(self.t["sample_window"]),
                                     size=int(self.t["sampled_batches"]), replace=False).tolist())
        self.n_units, self.kept = 0, []

    def moments(self) -> dict:
        """AdamW's state of the lead's parameters: the step count and the
        two moments (zeros where a step never reached AdamW)."""
        tr = self.trainer
        named = list(tr.model.bert.named_parameters())

        def get(key):
            return {n: tr.optimizer.state[p].get(key, torch.zeros_like(p)).detach().clone()
                    for n, p in named}

        return {"step": tr.step, "m": get("exp_avg"), "v": get("exp_avg_sq")}

    def compared_steps(self, snapshot: bool = False) -> dict:
        """`compared_steps` steps of the Trainer through the window's call
        and feed: each step's loss and batch, the gradient of the first as
        AdamW took it (from its moments before and after), the parameters
        after the last on every position; with `snapshot`, the state they
        started from."""
        tr = self.trainer
        beta1 = tr.optimizer.param_groups[0]["betas"][0]
        named = list(tr.model.bert.named_parameters())
        start = None
        if snapshot:
            start = {**self.moments(), "params": {n: p.detach().clone() for n, p in named}}
        m0 = start["m"] if snapshot else {n: torch.zeros_like(p) for n, p in named}
        losses, batches, g1 = [], [], None
        for j in range(int(self.t["compared_steps"])):
            batch = next(self.it)
            batches.append((tr.step, {k: batch[k] for k in TOKEN_KEYS}))
            metrics = tr.train_step(batch)
            losses.append(metrics["loss"].detach().clone())
            if j == 0:
                m1 = self.moments()["m"]
                g1 = {n: (m1[n] - beta1 * m0[n]) / (1 - beta1) for n, _ in named}
        params = [{n: p.detach().clone() for n, p in m.bert.named_parameters()}
                  for m in [tr.model, *tr.replicas]]
        return {"losses": [float(x) for x in losses], "g1": g1, "params": params,
                "batches": batches, "first_step": batches[0][0], "state": start}

    # ------------------------------------------------------------ window
    def unit(self) -> dict:
        t0 = time.perf_counter()
        with self.ranges("data"):
            batch = next(self.it)
        data_s = time.perf_counter() - t0
        tokens = batch["d_attention_mask"].sum(axis=1)
        if self.n_units in self.sample:
            self.kept.append((self.trainer.step, {k: batch[k] for k in TOKEN_KEYS}))
        self.n_units += 1
        with self.ranges("step"):
            self.trainer.train_step(batch)
        return {"steps": 1, "docs": int(tokens.shape[0]), "tokens": int(tokens.sum()),
                "flops": roofline.train_step_flops(self.m, tokens), "data_s": data_s,
                "head_flops": roofline.head_flops(tokens.sum(), self.m["hidden_size"],
                                                  self.m["vocab_size"])}

    def end_to_end(self, w) -> dict:
        return {"train_docs_per_s": w.total("docs") / w.seconds}

    def attempted(self, w) -> int:
        return int(w.total("steps"))

    # ------------------------------------------------------------ check
    def release(self):
        self.head.restore()
        self.undo()
        self.trainer = self.it = None
        self.tmp.cleanup()
        free(*self.devices)

    def rows_of(self, b: int) -> list:
        """The rows of the loader's global batch b: epoch e (from 1) is
        shuffled with the seed + e, its last partial batch dropped (a copy of
        `data/loader.py`'s order)."""
        e, i = divmod(b, self.per_epoch)
        perm = np.random.default_rng(self.cell.seed + e + 1).permutation(len(self.rows))
        return [self.rows[k] for k in perm[i * self.B:(i + 1) * self.B]]

    def tokenized(self, b: int, wp: WordPiece) -> dict:
        """The reference tokenizer's ids and masks of batch b, as the
        collator lays them out (docs group-major)."""
        rows, L = self.rows_of(b), int(self.recipe["max_seq_length"])
        qb = wp.batch([r[0] for r in rows], L)
        db = wp.batch([d for r in rows for d in (r[1], *r[2])], L)
        return {"q_input_ids": qb["input_ids"], "q_attention_mask": qb["attention_mask"],
                "d_input_ids": db["input_ids"], "d_attention_mask": db["attention_mask"]}

    def tokens_wrong(self, batches, wp: WordPiece) -> int:
        """Rows (queries and docs) of the kept batches whose ids or mask
        differ from the reference tokenizer's."""
        wrong = 0
        for b, got in batches:
            want = self.tokenized(b, wp)
            for side, n in (("q", self.B), ("d", self.B * self.G)):
                g_ids, g_m = (np.asarray(got[f"{side}_{k}"]) for k in ("input_ids",
                                                                      "attention_mask"))
                w_ids, w_m = want[f"{side}_input_ids"], want[f"{side}_attention_mask"]
                if g_ids.shape != w_ids.shape or g_m.shape != w_m.shape:
                    wrong += n
                    continue
                wrong += int(((g_ids != w_ids) | (g_m != w_m)).any(axis=1).sum())
        return wrong

    def reference(self, first_step: int, state=None, precision: str = "fp32") -> dict:
        """The plain reference over `compared_steps` steps from `first_step`:
        losses, the first gradient, the parameters after them. It starts from
        the seed's weights and AdamW's empty state, or from `state` (a
        snapshot of the program's parameters, moments and step count)."""
        ref_bert.set_precision()
        dev, seed, G, P = self.dev, self.cell.seed, self.G, self.P
        start = self.weights() if state is None else state["params"]
        w = {k: v.to(dev).clone().requires_grad_(True) for k, v in start.items()}
        names = list(w)
        enc = ref_bert.Encoder(self.m, w, precision)
        wp = WordPiece()
        idf = torch.from_numpy(np.load(f"{DATA}/idf.npy")).to(dev)
        opt = ref_train.AdamW(w, self.recipe, state)
        losses, g1 = [], None
        nq = self.B // P
        for j in range(first_step, first_step + int(self.t["compared_steps"])):
            tb = self.tokenized(j, wp)
            ids = torch.from_numpy(tb["d_input_ids"]).to(dev)
            mask = torch.from_numpy(tb["d_attention_mask"]).to(dev)
            d = torch.cat([enc.rep(ids[p * nq * G:(p + 1) * nq * G],
                                   mask[p * nq * G:(p + 1) * nq * G], (seed, j, 0, p, 0))
                           for p in range(P)])
            q = ref_bert.inf_free_rep(torch.from_numpy(tb["q_input_ids"]).to(dev), idf,
                                      wp.special_ids)
            loss = ref_train.recipe_loss(q, d, j, self.recipe)
            grads = torch.autograd.grad(loss, [w[k] for k in names])
            grads = {k: g.detach() for k, g in zip(names, grads)}
            if g1 is None:
                g1 = grads
            opt.step(grads)
            losses.append(float(loss.detach()))
        params = {k: v.detach() for k, v in w.items()}
        return {"losses": losses, "g1": g1, "params": [params] * P}

    def compare(self, prog: dict, ref: dict, p0: dict) -> dict:
        """loss_gap: the widest relative gap of a step's loss; grad_gap and
        change_gap: the worst leaf's gap of norms of the first gradient and of
        the parameters' change from `p0` (leaves whose reference gradient is
        under a thousandth of the median leaf's left out of the change)."""
        names = list(ref["g1"])
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
        grad_gap = max(ref_train.leaf_gaps(prog["g1"], ref["g1"], names))
        gn = {k: float(ref["g1"][k].double().norm()) for k in names}
        med = float(np.median(list(gn.values())))
        live = [k for k in names if gn[k] >= 1e-3 * med]
        change_gap = 0.0
        ref_d = {k: ref["params"][0][k] - p0[k].to(self.dev) for k in live}
        for pos in prog["params"]:
            prog_d = {k: pos[k].to(self.dev) - p0[k].to(self.dev) for k in live}
            change_gap = max(change_gap, max(ref_train.leaf_gaps(prog_d, ref_d, live)))
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}

    def stretches(self):
        """The window's end: the same Trainer's compared steps after the
        window, then the program freed. Returns both stretches and the kept
        batches."""
        end = self.compared_steps(snapshot=True)
        batches = self.start["batches"] + self.kept + end["batches"]
        start, self.start, self.kept = self.start, None, []
        self.release()
        return start, end, batches

    def readings(self) -> dict:
        start, end, batches = self.stretches()
        out = {"tokens_wrong": self.tokens_wrong(batches, WordPiece())}
        for tag, prog in (("start", start), ("end", end)):
            state = prog["state"]
            ref = self.reference(prog["first_step"], state)
            p0 = self.weights() if state is None else state["params"]
            out.update({f"{k}.{tag}": v for k, v in self.compare(prog, ref, p0).items()})
        return out

    def control(self) -> dict:
        """The fp8 reference in the program's place, against the float32 one,
        over both stretches."""
        start, end, _ = self.stretches()
        out = {}
        for tag, prog in (("start", start), ("end", end)):
            state = prog["state"]
            p0 = self.weights() if state is None else state["params"]
            got = self.reference(prog["first_step"], state, "fp8")
            out.update({f"{k}.{tag}": v for k, v in self.compare(
                got, self.reference(prog["first_step"], state), p0).items()})
        return out


def _alter_tokens(collator):
    """Fault: one token of every doc altered where the collator makes it."""
    def collate(rows):
        b = collator(rows)
        ids = b["d_input_ids"].copy()
        ids[:, 1] = (ids[:, 1] + 1) % 30522
        b["d_input_ids"] = ids
        return b
    return collate


def _plant(fault, trainer):
    """Faults planted in the program for the output check's own tests and
    readings; returns what undoes them."""
    from opensearch_sparse_model_tuning_sample_torch.train import trainer as tmod

    saved = (tmod.loss_from_rows, tmod.mesh_grad_sum)

    def undo():
        tmod.loss_from_rows, tmod.mesh_grad_sum = saved

    if fault is None or fault == "token":
        return undo

    if fault == "frozen":  # a step that leaves its state unchanged
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":  # half of the batch left out, the mean over the rest
        inner = tmod.loss_from_rows

        def half(rows, *a, **k):
            nq = rows["q"].shape[0] // 2
            g = rows["d"].shape[0] // rows["q"].shape[0]
            return inner({**rows, "q": rows["q"][:nq], "d": rows["d"][:nq * g]}, *a, **k)

        tmod.loss_from_rows = half
    elif fault == "no_exchange":  # the gradient sum between positions left out
        tmod.mesh_grad_sum = lambda *a, **k: None
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return undo
