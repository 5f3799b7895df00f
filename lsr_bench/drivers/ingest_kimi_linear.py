"""Ingest with Kimi-Linear-48B-A3B as the doc encoder: `drivers/ingest.py`'s
traffic (repeated calls of the port's `eval/beir.py::ingest`, each over one
whole corpus) on a Kimi Linear (kimi_linear) configuration, one card's share
of its experts (`weights_kimi_linear.py`).

It follows `ingest_moonlight.py`. Set-up builds the program's model first
(the port's preset whose sizes are the configuration's, holding the seed's
weights, drawn on the card one tensor at a time), so a port without Kimi
Linear fails at once; then the corpora and the warm-up calls. Each unit
returns, beside `drivers/ingest.py`'s counts, the forward's work (`flops`)
and the least time of the held experts, the MLA cores and the KDA mixers
(`kimi_linear_roofline.py`).

The output check holds the reference to the program one layer at a time,
from the program's own values, as `ingest_moonlight.py` does (random-weight
expert models are chaotic end to end), over `check_docs` docs of the call
drawn from the seed at evenly spaced ranks of length: `row_gap`,
`route_miss` and `replay_miss` as there, and `layer_gap` taken per doc and
per `gap_window`-token window of it, so that a fault in one stretch of a
long doc's recurrence is not diluted over its other tokens. The program's
values are kept on the host (the check docs' inputs to the 27 layers are
about 16 GB at 32k-token docs) and go to the card a layer at a time.

Faults for the check's own tests and calibration: `decay` (α applied after
the delta update, S_t = Diag(α_t)((I − β k kᵀ) S_{t−1} + β k vᵀ): run as the
sound kernel on the decay shifted one position later and q scaled by α),
`beta` (β left out of the erase term: the sound kernel with β 1 and β·v),
`conv` (the short convolutions see one position ahead), `share` (the
routed weights renormalised over the held experts alone), `causal` (MLA
over every live key) and `token` (`drivers/ingest.py`'s).
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from .. import roofline
from .. import weights_kimi_linear as wk
from ..gen import text as textgen
from ..reference import kimi_linear as ref_kl
from ..reference.wordpiece import WordPiece
from ..trace import Ranges
from . import ingest, ingest_moonlight
from . import kimi_linear_roofline as work
from .common import HeadRange


def preset_for(m: dict) -> str:
    """The port's Kimi Linear preset whose sizes are these model keys."""
    from opensearch_sparse_model_tuning_sample_torch.models import kimi_linear

    want = {**{k: v for k, v in m.items() if k in wk._KEYS}, "num_experts": m["n_routed"],
            "experts_held": m["num_experts"], "experts_first": m["experts_first"],
            "kda_layers": m["kda_layers"], "kda_num_heads": m["kda_num_heads"],
            "kda_head_dim": m["kda_head_dim"],
            "short_conv_kernel_size": m["short_conv_kernel_size"]}
    for name in kimi_linear.PRESETS:
        cfg = kimi_linear.config_from_preset(name)
        if all(getattr(cfg, k) == v for k, v in want.items()):
            return name
    raise KeyError(f"no Kimi Linear preset of the port has the sizes {want}")


class Driver(ingest_moonlight.Driver):
    def __init__(self, cell):
        # not the parent's __init__: it reads Moonlight's keys
        self.cell = cell
        self.m = wk.model_keys(cell.config)
        self.t = cell.traffic
        self.ranges = Ranges()
        self.devices = cell.devices()
        self.dev = self.devices[0]
        self.fault = cell.overrides.get("fault")
        self.compute = getattr(torch, cell.overrides.get("compute", "bfloat16"))
        self._unplant = None

    def weights(self, names=None):
        return wk.make_weights(self.m, self.cell.seed, self.dev, self.compute, names)

    def program_model(self):
        """The port's sparse encoder holding the seed's weights (taken as
        they are), the bundled tokenizer with its native path, its idf
        zero-padded to the model's vocab."""
        from opensearch_sparse_model_tuning_sample_torch.core.device import resolve_device
        from opensearch_sparse_model_tuning_sample_torch.models import kimi_linear
        from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
        from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import (
            load_idf_weights, load_tokenizer)

        cfg = kimi_linear.config_from_preset(preset_for(self.m), compute_dtype=self.compute)
        bert = kimi_linear.from_state_dict(cfg, self.weights(), resolve_device(self.dev))
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
                "attn_causal_bound_s": work.attn_causal_bound_s(m, tok),
                "attn_linear_bound_s": work.attn_linear_bound_s(m, tok)}

    # ------------------------------------------------------------ check
    def capture(self, k, sel) -> dict:
        """`ingest_moonlight.Driver.capture`, each layer's input and the last
        layer's output kept on the host as they are taken."""
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
        routers = [layer.mlp.gate for layer in layers if hasattr(layer.mlp, "gate")]
        routes = [[] for _ in routers]
        docs, bounds, rows, kept = [], [0], [], []
        l_max = min(int(t["l_max"]), model.vocab_size)

        def live(x):
            return x.reshape(-1, x.shape[-1])[rows[-1]].float().cpu()

        def keep_input(i):
            return lambda mod, args: xs[i].append(live(args[0]))

        def keep_output(mod, args, out):
            xs[-1].append(live(out))

        def keep_route(j):
            return lambda mod, args, out: routes[j].append(out[0][rows[-1]])

        hooks = [layer.register_forward_pre_hook(keep_input(i)) for i, layer in enumerate(layers)]
        hooks.append(layers[-1].register_forward_hook(keep_output))
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
        return ref_kl.Encoder(self.m, lambda names: {n: t.float() for n, t in
                                                     self.weights(names).items()},
                              wk.layer_shapes, wk.outer_shapes, precision)

    def forced(self, cap: dict, precisions, visit):
        """The reference layer by layer from the program's own inputs (each
        brought to the card for its layer), each layer's weights drawn once:
        visit(i, x_in, x_out, {precision: (output, chosen)}). Returns
        {precision: reps} from the program's last output."""
        encs = {p: self._encoder(p) for p in precisions}
        first = next(iter(encs.values()))
        xs, bounds = cap["xs"], cap["bounds"]
        with torch.no_grad():
            x = xs[0].to(self.dev)
            for i in range(self.m["num_hidden_layers"]):
                w = first.layer_weights(i)
                nxt = xs[i + 1].to(self.dev)
                visit(i, x, nxt, {p: e.layer(i, x, bounds, w) for p, e in encs.items()})
                del w
                x = nxt
            return {p: e.head_reps(x, bounds) for p, e in encs.items()}

    def windows(self, bounds):
        """Each doc's tokens cut in windows of `gap_window` tokens."""
        size = int(self.t["gap_window"])
        out = [0]
        for s, e in zip(bounds, bounds[1:]):
            out += list(range(s + size, e, size)) + [e]
        return out

    def embed_gap(self, k, cap) -> float:
        texts = [self.corpora[k][i][1] for i in cap["docs"]]
        b = WordPiece().batch(texts, int(self.t["max_length"]), buckets=None)
        ids = np.concatenate([b["input_ids"][i, :n] for i, n in
                              enumerate(b["attention_mask"].sum(1))])
        x0 = cap["xs"][0]
        if len(ids) != x0.shape[0]:
            return 1.0
        table = self.weights([s for s in wk.outer_shapes(self.m) if s[0] == "embed_tokens"])
        e = table["embed_tokens"].float()[torch.from_numpy(ids).to(self.dev).long()]
        x0 = x0.to(self.dev)
        return float(((x0 - e).norm(dim=-1) / e.norm(dim=-1).clamp_min(1e-30)).max())

    def readings(self) -> dict:
        """As `ingest_moonlight.Driver.readings`, `layer_gap` over windows
        of each doc."""
        k, sel = self.check_docs()
        _, toks, w = self.program_rows()
        cap = self.capture(k, sel)
        self.release()
        wins, gaps, ref_routes = self.windows(cap["bounds"]), [], []

        def visit(i, x_in, x_out, outs):
            out, chosen = outs["fp32"]
            gaps.append(self.update_gap(x_in, x_out, out, wins))
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
        as the program's layers, against the float32 reference."""
        k, sel = self.check_docs()
        cap = self.capture(k, sel)
        self.release()
        self.out.cleanup()
        wins, gaps, r8, r32 = self.windows(cap["bounds"]), [], [], []

        def visit(i, x_in, x_out, outs):
            (o8, c8), (o32, c32) = outs["fp8"], outs["fp32"]
            gaps.append(self.update_gap(x_in, o8, o32, wins))
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


def _causal_dropped(q, k, v, mask, window=0, causal=False, block=256):
    """MLA over every live key, before and after the query (the `causal`
    fault): fp32 logits of compute-dtype operands, a block of queries at a
    time."""
    B, L, H, hqk = q.shape
    out = torch.empty((B, L, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    kh, vh = k.transpose(1, 2).float(), v.transpose(1, 2).float()
    bias = torch.where(mask.bool(), 0.0, torch.finfo(torch.float32).min)[:, None, None, :]
    for q0 in range(0, L, block):
        qb = q[:, q0:q0 + block].transpose(1, 2).float()
        p = torch.softmax(qb @ kh.transpose(-1, -2) / hqk ** 0.5 + bias, dim=-1)
        out[:, q0:q0 + block] = (p.to(q.dtype).float() @ vh).transpose(1, 2).to(q.dtype)
    return out


def _plant(fault, model):
    """Faults planted in the program: `token` on the model's tokenizer, the
    others on module attributes of the port, put back by the returned
    function."""
    if fault is None:
        return None
    if fault == "token":
        ingest._plant(fault, model)
        return None
    from opensearch_sparse_model_tuning_sample_torch.models import kimi_linear, moonlight
    from opensearch_sparse_model_tuning_sample_torch.ops import moe

    if fault in ("decay", "beta"):
        inner = kimi_linear.kda

        def kda(q, k, v, g, beta, scale):
            if fault == "beta":  # (I − k kᵀ) D S + β k vᵀ
                return inner(q, k, (v.float() * beta[..., None]).to(v.dtype), g,
                             torch.ones_like(beta), scale)
            # D_t((I − β k kᵀ) S + β k vᵀ): R_t = D_t⁻¹ S_t follows the sound
            # rule with the decay one position later, and o_t = R_tᵀ (α_t q_t)
            shifted = torch.cat([torch.zeros_like(g[:, :1]), g[:, :-1]], dim=1)
            return inner((q.float() * g.exp()).to(q.dtype), k, v, shifted, beta, scale)

        mod, name, new = kimi_linear, "kda", kda
    elif fault == "conv":  # each position sees the next one too
        inner = kimi_linear.conv_silu

        def conv_silu(x, w, d, norm):
            return inner(torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1), w, d, norm)

        mod, name, new = kimi_linear, "conv_silu", conv_silu
    elif fault == "share":  # the weights renormalised over the held experts alone
        inner = moe.experts

        def experts(u, x, chosen, w, gate, up, down, shared, first=0):
            held = (chosen >= first) & (chosen < first + gate.shape[0])
            wh = torch.where(held, w, 0.0)
            scale = w.sum(-1, keepdim=True) / wh.sum(-1, keepdim=True).clamp_min(1e-20)
            return inner(u, x, chosen, w * scale, gate, up, down, shared, first)

        mod, name, new = moe, "experts", experts
    elif fault == "causal":
        inner = moonlight.attention
        mod, name, new = moonlight, "attention", _causal_dropped
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(mod, name, new)
    return lambda: setattr(mod, name, inner)
