"""Ingest with Moonlight-16B-A3B as the doc encoder: `drivers/ingest.py`'s
traffic (repeated calls of the port's `eval/beir.py::ingest`, each over one
whole corpus) on a Moonlight (deepseek_v3) configuration.

Set-up builds the program's model first (the port's preset whose sizes are
the configuration's, holding the seed's weights from
`weights_moonlight.py`, drawn on the card one tensor at a time), so a port
without Moonlight fails at once; then the corpora, as `drivers/ingest.py`
makes them, and the warm-up calls. Each unit returns, beside
`drivers/ingest.py`'s counts, the work of Moonlight's forward (`flops`, the
routed experts at k a token) and the least time of its routed experts and
of its causal attention cores (`moonlight_roofline.py`).

The output check, after the window, over `check_docs` docs of one call
drawn from the seed, at evenly spaced ranks of length. Under random weights
the model is chaotic: a bf16 rounding that moves one token's chosen set in
an early layer moves its later inputs, so run end to end the program's and
the float32 reference's choices part on about half of (token, layer) (0.49
on an H100), whatever kernels run. So the reference is held to the
program one layer at a time, from the program's own values (teacher
forcing): the drawn call's batches are run again as the timed call ran them
(the packer and the kernels are deterministic) with hooks that keep each
layer's input, and

  * `row_gap`, as in `drivers/ingest.py`: the call's stored rows against
    the reference's head over the program's last-layer output;
  * `layer_gap`: the widest over the layers and the check docs of a
    layer's update (output less input) against the reference layer's update
    from the same input, ‖Δ − Δ_ref‖ / ‖Δ_ref‖ over one doc's tokens, and
    of the embeddings the first layer takes against the reference's (the
    reference WordPiece's ids), token by token;
  * `route_miss`: the share of (token, expert layer) whose chosen set of
    experts differs from the reference router's on the same input;
  * `replay_miss`: the share of the check docs whose rows from the run
    again (its top `l_max` of each pooled rep, rounded to the stored
    bfloat16) differ from the timed call's stored rows: 0 shows that the
    values the reference was held to are the timed computation's.

Faults for the check's own tests and calibration: `bias` (the correction
bias left out of the choice), `norm` (the chosen weights not normalised),
`causal` (attention over every live key, the causal mask dropped), `rows`
(the combine leaves out the routed experts of each batch's first 16
positions: a fault of a few tokens of one doc a batch), `token`
(`drivers/ingest.py`'s: one token of every doc altered where the tokenizer
makes it).
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from .. import roofline
from .. import weights_moonlight as wm
from ..gen import text as textgen
from ..reference import moonlight as ref_ml
from ..reference.wordpiece import WordPiece
from ..trace import Ranges
from . import ingest
from . import moonlight_roofline as work
from .common import HeadRange


def preset_for(m: dict) -> str:
    """The port's Moonlight preset whose sizes are these model keys."""
    from opensearch_sparse_model_tuning_sample_torch.models import moonlight

    for name in moonlight.PRESETS:
        cfg = moonlight.config_from_preset(name)
        if all(getattr(cfg, k) == v for k, v in m.items()):
            return name
    raise KeyError(f"no Moonlight preset of the port has the sizes {m}")


class Driver(ingest.Driver):
    def __init__(self, cell):
        # not Base.__init__: its model_keys reads BERT and DistilBERT keys
        self.cell = cell
        self.m = wm.model_keys(cell.config)
        self.t = cell.traffic
        self.ranges = Ranges()
        self.devices = cell.devices()
        self.dev = self.devices[0]
        self.fault = cell.overrides.get("fault")
        self.compute = getattr(torch, cell.overrides.get("compute", "bfloat16"))
        self._unplant = None

    def weights(self, names=None):
        return wm.make_weights(self.m, self.cell.seed, self.dev, self.compute, names)

    def program_model(self):
        """The port's sparse encoder holding the seed's weights: the preset's
        module over `weights()` (taken as they are, not copied), the bundled
        tokenizer with its native path, its idf zero-padded to the model's
        vocab (as `build_model` pads it)."""
        from opensearch_sparse_model_tuning_sample_torch.core.device import resolve_device
        from opensearch_sparse_model_tuning_sample_torch.models import moonlight
        from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
        from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import (
            load_idf_weights, load_tokenizer)

        cfg = moonlight.config_from_preset(preset_for(self.m), compute_dtype=self.compute)
        bert = moonlight.from_state_dict(cfg, self.weights(), resolve_device(self.dev))
        tok = load_tokenizer(None)
        tok.try_attach_native()
        raw = np.asarray(load_idf_weights(None, tok), np.float32)
        idf = np.zeros(cfg.vocab_size, np.float32)
        idf[:min(len(raw), cfg.vocab_size)] = raw[:cfg.vocab_size]
        return se.SparseEncoderModel(cfg, bert, torch.from_numpy(idf), tok)

    def setup(self):
        from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig

        self.model = self.program_model()
        t, seed = self.t, self.cell.seed
        rng = np.random.default_rng(seed & (2**63 - 1))
        words = textgen.Words(t["zipf"])
        n, dw = int(t["corpus_docs"]), t["doc_words"]
        self.corpora, self.tokens = [], []
        for k in range(int(t["corpora"])):
            lens = textgen.lognormal_lengths(n, dw["median"], dw["sigma"], dw["min"], dw["max"],
                                             rng)
            texts = textgen.make_texts(words, lens, rng)
            self.corpora.append([(f"c{k}d{i}", s) for i, s in enumerate(texts)])
            self.tokens.append(textgen.token_counts(lens, int(t["max_length"])))
        self.head = HeadRange(self.ranges, "maxpool_head")
        self._unplant = _plant(self.fault, self.model)
        self.index_cfg = IndexConfig(engine=t["engine"], l_max=int(t["l_max"]))
        self.out = tempfile.TemporaryDirectory(prefix="lsr_bench_ingest_")
        self.calls = []
        for k in range(int(t["warmup_calls"])):
            self._ingest(k % len(self.corpora), f"warm{k}")

    def unit(self) -> dict:
        j = len(self.calls)
        k = j % len(self.corpora)
        with self.ranges("ingest"):
            index = self._ingest(k, f"c{j}")
        self.calls.append((k, index))
        tok = self.tokens[k]
        m = self.m
        return {"calls": 1, "docs": len(tok), "tokens": int(tok.sum()),
                "flops": work.forward_flops(m, tok),
                "head_flops": roofline.head_flops(tok.sum(), m["hidden_size"], m["vocab_size"]),
                "moe_bound_s": work.moe_bound_s(m, tok, int(self.t["batch_size"])),
                "attn_causal_bound_s": work.attn_bound_s(m, tok)}

    def release(self):
        if self._unplant is not None:
            self._unplant()
            self._unplant = None
        super().release()

    # ------------------------------------------------------------ check
    def check_docs(self):
        """The corpus of the call drawn from the seed (as `program_rows`
        draws it) and `check_docs` of its docs at evenly spaced ranks of
        length."""
        c = int(np.random.default_rng(self.cell.seed + 7).integers(len(self.calls)))
        k = self.calls[c][0]
        order = np.argsort(self.tokens[k], kind="stable")
        n = min(int(self.t["check_docs"]), len(order))
        return k, np.unique(order[np.linspace(0, len(order) - 1, n).round().astype(int)])

    def capture(self, k, sel) -> dict:
        """The program's own values inside the drawn call, for the docs
        `sel` of corpus k: the call's corpus packed again into the batches
        the timed call ran (the packer is deterministic, and so are the
        kernels and the batch shapes), the batches that hold those docs
        encoded again with hooks that keep, over the docs' live positions,
        each layer's input and the last layer's output (fp32) and each
        router's chosen experts, and the docs' top-`l_max` rows as the
        timed call took them. Returns {"docs": the doc indices in the
        order kept, "bounds": their token offsets, "xs": [layers + 1] of
        [N, D], "routes": [expert layers] of [N, k], "rows": (token ids,
        weights) [docs, l_max] on the host}."""
        from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se

        model, t = self.model, self.t
        enc = se.get_batch_encoder(model, max_length=int(t["max_length"]), do_count=True,
                                   scope=("ingest", 0, 1))
        texts = [s for _, s in self.corpora[k]]
        batches, pos, _ = enc._pack(texts, int(t["batch_size"]), runs_encoder=False)
        starts = np.cumsum([0] + [ids.shape[0] for ids, _ in batches])
        lens = self.tokens[k]
        layers = list(model.bert.layers)
        xs = [[] for _ in range(len(layers) + 1)]
        routes = [[] for layer in layers if hasattr(layer.mlp, "gate")]
        docs, bounds, rows, kept = [], [0], [], []
        l_max = min(int(t["l_max"]), model.vocab_size)

        def keep_input(i):
            return lambda mod, args: xs[i].append(args[0].reshape(-1, args[0].shape[-1])[rows[-1]]
                                                  .float())

        def keep_output(mod, args, out):
            xs[-1].append(out.reshape(-1, out.shape[-1])[rows[-1]].float())

        def keep_route(j):
            return lambda mod, args, out: routes[j].append(out[0][rows[-1]])

        hooks = [layer.register_forward_pre_hook(keep_input(i)) for i, layer in enumerate(layers)]
        hooks.append(layers[-1].register_forward_hook(keep_output))
        routers = [layer.mlp.gate for layer in layers if hasattr(layer.mlp, "gate")]
        hooks += [r.register_forward_hook(keep_route(j)) for j, r in enumerate(routers)]
        try:
            for b, (ids, mask) in enumerate(batches):
                here = [i for i in sel if starts[b] <= pos[i] < starts[b + 1]]
                if not here:
                    continue
                L = ids.shape[1]
                flat = [(pos[i] - starts[b]) * L + np.arange(lens[i]) for i in here]
                rows.append(torch.from_numpy(np.concatenate(flat)).to(self.dev))
                for i in here:
                    docs.append(i)
                    bounds.append(bounds[-1] + int(lens[i]))
                with torch.no_grad():
                    idx, vals = se._topk_rows(se.encode_doc(model, ids, mask), l_max)
                at = torch.as_tensor([pos[i] - starts[b] for i in here], device=idx.device)
                kept.append((idx[at].cpu().numpy(), vals[at].cpu()))
        finally:
            for h in hooks:
                h.remove()
        toks = np.concatenate([i for i, _ in kept])
        w = torch.cat([v for _, v in kept]).to(torch.bfloat16).float().numpy()
        return {"docs": np.asarray(docs), "bounds": bounds,
                "xs": [torch.cat(x) for x in xs], "routes": [torch.cat(r) for r in routes],
                "rows": (toks, w)}

    def _encoder(self, precision: str):
        return ref_ml.Encoder(self.m, lambda names: {n: t.float() for n, t in
                                                     self.weights(names).items()},
                              wm.layer_shapes, wm.outer_shapes, precision)

    def forced(self, cap: dict, precisions, visit):
        """The reference layer by layer from the program's own inputs
        (teacher forcing: each layer of each precision gets the program's
        input to it, so a difference does not carry on to the next layer),
        each layer's weights drawn once: visit(i, {precision: (output,
        chosen)}). Returns {precision: reps} from the program's last
        output."""
        encs = {p: self._encoder(p) for p in precisions}
        first = next(iter(encs.values()))
        xs, bounds = cap["xs"], cap["bounds"]
        with torch.no_grad():
            for i in range(self.m["num_hidden_layers"]):
                w = first.layer_weights(i)
                visit(i, {p: e.layer(i, xs[i], bounds, w) for p, e in encs.items()})
                del w
            return {p: e.head_reps(xs[-1], bounds) for p, e in encs.items()}

    def embed_gap(self, k, cap) -> float:
        """The widest over the check docs' tokens of ‖x0 − e‖ / ‖e‖, x0 the
        program's input to the first layer and e the reference's embedding
        of the reference WordPiece's ids (1 where the token counts differ)."""
        texts = [self.corpora[k][i][1] for i in cap["docs"]]
        b = WordPiece().batch(texts, int(self.t["max_length"]), buckets=None)
        ids = np.concatenate([b["input_ids"][i, :n] for i, n in
                              enumerate(b["attention_mask"].sum(1))])
        x0 = cap["xs"][0]
        if len(ids) != x0.shape[0]:
            return 1.0
        table = self.weights([s for s in wm.outer_shapes(self.m) if s[0] == "embed_tokens"])
        e = table["embed_tokens"].float()[torch.from_numpy(ids).to(self.dev).long()]
        return float(((x0 - e).norm(dim=-1) / e.norm(dim=-1).clamp_min(1e-30)).max())

    @staticmethod
    def route_miss(prog, ref) -> float:
        """The share of (token, expert layer) whose chosen sets differ."""
        miss = sum(int((p.sort(-1).values != r.sort(-1).values).any(-1).sum())
                   for p, r in zip(prog, ref))
        return miss / max(sum(p.shape[0] for p in prog), 1)

    @staticmethod
    def update_gap(x_in, got, want, bounds) -> float:
        """A layer's update got - x_in against want - x_in, doc by doc (the
        docs' tokens at `bounds`): the widest over the docs of ‖Δgot −
        Δwant‖ / ‖Δwant‖ over the doc's tokens."""
        at = torch.as_tensor(bounds, device=x_in.device)

        def per_doc(d):
            c = torch.cat([d.new_zeros(1), (d.double() ** 2).sum(-1).cumsum(0)])
            return (c[at[1:]] - c[at[:-1]]).sqrt()

        return float((per_doc(got - want) / per_doc(want - x_in).clamp_min(1e-30)).max())

    @staticmethod
    def replay_miss(stored, replayed) -> float:
        """The share of docs whose rows differ: the (token, weight) pairs of
        weight above 0 of the stored rows against the replayed ones."""
        def terms(t, w):
            return sorted((int(a), float(b)) for a, b in zip(t, w) if b > 0)

        (st, sw), (rt, rw) = stored, replayed
        miss = sum(terms(*a) != terms(*b) for a, b in zip(zip(st, sw), zip(rt, rw)))
        return miss / max(len(st), 1)

    def readings(self) -> dict:
        """row_gap: the timed call's stored rows of the check docs against
        the reference's head over the program's own last-layer output;
        layer_gap: the widest over the layers of `update_gap` between the
        program's layer output and the reference layer's from the same
        input; route_miss: the share of (token, expert layer) whose
        program-chosen set differs from the reference router's on the
        program's own input; replay_miss: the share of check docs whose
        rows from the run again differ from the timed call's."""
        k, sel = self.check_docs()
        _, toks, w = self.program_rows()
        cap = self.capture(k, sel)
        self.release()
        xs, gaps, ref_routes = cap["xs"], [], []

        def visit(i, outs):
            out, chosen = outs["fp32"]
            gaps.append(self.update_gap(xs[i], xs[i + 1], out, cap["bounds"]))
            if chosen is not None:
                ref_routes.append(chosen)

        reps = self.forced(cap, ["fp32"], visit)["fp32"]
        docs = cap["docs"]
        nums = self.compare(toks[docs], w[docs], [(np.arange(len(docs)), reps)])
        nums["layer_gap"] = max(gaps + [self.embed_gap(k, cap)])
        nums["route_miss"] = self.route_miss(cap["routes"], ref_routes)
        nums["replay_miss"] = self.replay_miss((toks[docs], w[docs]), cap["rows"])
        self.out.cleanup()
        return nums

    def control(self) -> dict:
        """The fp8 reference in the program's place, from the same inputs
        as the program's layers: its layers' outputs and chosen experts,
        and its own top-l_max rows (stored in bfloat16) from the last
        layer's output, against the float32 reference's."""
        k, sel = self.check_docs()
        cap = self.capture(k, sel)
        self.release()
        self.out.cleanup()
        xs, gaps, r8, r32 = cap["xs"], [], [], []

        def visit(i, outs):
            (o8, c8), (o32, c32) = outs["fp8"], outs["fp32"]
            gaps.append(self.update_gap(xs[i], o8, o32, cap["bounds"]))
            if c8 is not None:
                r8.append(c8)
                r32.append(c32)

        reps = self.forced(cap, ["fp8", "fp32"], visit)
        v, i = torch.topk(reps["fp8"], int(self.t["l_max"]), dim=1)
        w = torch.where(v > 0, v, 0.0).to(torch.bfloat16).float().cpu().numpy()
        nums = self.compare(i.cpu().numpy(), w, [(np.arange(len(w)), reps["fp32"])])
        nums["layer_gap"] = max(gaps)
        nums["route_miss"] = self.route_miss(r8, r32)
        return nums


def _plant(fault, model):
    """Faults planted in the program: `token` on the model's tokenizer, the
    others on module attributes of the port, put back by the returned
    function."""
    if fault is None:
        return None
    if fault == "token":
        ingest._plant(fault, model)
        return None
    from opensearch_sparse_model_tuning_sample_torch.models import moonlight
    from opensearch_sparse_model_tuning_sample_torch.ops import attention as at
    from opensearch_sparse_model_tuning_sample_torch.ops import moe

    if fault in ("bias", "norm"):
        inner = moe.route

        def route(u, w_gate, bias, top_k, scale):
            if fault == "bias":  # b left out of the choice
                return inner(u, w_gate, torch.zeros_like(bias), top_k, scale)
            chosen, _ = inner(u, w_gate, bias, top_k, scale)  # the weights not normalised
            s = torch.sigmoid(torch.matmul(u.float(), w_gate.float().t()))
            return chosen, s.gather(1, chosen) * scale

        mod, name, new = moe, "route", route
    elif fault == "rows":  # each batch's first 16 positions without their routed experts
        inner = moe.combine

        def combine(x, y, shared, pos, w):
            return inner(x, y, shared, pos, torch.cat([torch.zeros_like(w[:16]), w[16:]]))

        mod, name, new = moe, "combine", combine
    elif fault == "causal":  # every live key, before and after the query
        inner = moonlight.attention

        def attention(q, k, v, mask, window=0, causal=False):
            return at.attention_reference(q, k, v, mask)

        mod, name, new = moonlight, "attention", attention
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(mod, name, new)
    return lambda: setattr(mod, name, inner)
