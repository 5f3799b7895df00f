"""The port's Moonlight (`models/moonlight.py`, `ops/moe.py`, the causal kind
of `ops/attention.py`) on the CPU, against the benchmark's plain reference
(`lsr_bench/reference/moonlight.py`), at test widths with the published
structure: 4 layers (a dense layer 0, then expert layers of 8 experts, 2 a
token, 1 shared), D 64, 4 heads, MLA at kv rank 32 and rope / nope / v dims
16 / 16 / 16, vocab 512, seeded random weights, rows of lengths 5-40 with
padding.

  * encode_hidden and the reps against the reference, in float32 and bf16;
  * the router (the bias in the choice only, the normalisation, the 2.446
    scale), the expert layer against per-token dense evaluation, the
    permutation and combine deterministic;
  * causal receptive fields, the MLA shapes and the shared rope key;
  * build_model on both presets, the large preset's parameter count, the
    Trainer's refusal;
  * the benchmark's new cell at test widths: correct, the control and its
    faults not.
"""

import time

import numpy as np
import pytest
import torch

from lsr_bench import weights_moonlight as wm
from lsr_bench.reference import moonlight as ref_ml
from opensearch_sparse_model_tuning_sample_torch.models import moonlight
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import WordPieceTokenizer
from opensearch_sparse_model_tuning_sample_torch.ops import attention as at
from opensearch_sparse_model_tuning_sample_torch.ops import moe

torch.set_num_threads(2)

B, L = 4, 40
LENS = [40, 23, 5, 31]


def _cfg(compute=torch.float32, **kw):
    return moonlight.config_from_preset("moonlight-tiny", compute_dtype=compute, **kw)


def _model(cfg, seed=0):
    return moonlight.from_state_dict(cfg, moonlight.init_state_dict(cfg, seed), "cpu")


def _keys(cfg):
    return {k: getattr(cfg, k) for k in wm._KEYS}


def _ref(cfg, model, precision="fp32"):
    sd = {k: v.float() for k, v in model.state_dict().items()}
    return ref_ml.Encoder(_keys(cfg), lambda names: {n: sd[n] for n, _ in names},
                          wm.layer_shapes, wm.outer_shapes, precision)


def _batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 512, (B, L), generator=g)
    mask = (torch.arange(L)[None, :] < torch.tensor(LENS)[:, None]).to(torch.int32)
    return ids * mask, mask


def _docs(ids, mask):
    return [ids[i, : int(mask[i].sum())] for i in range(ids.shape[0])]


def _routes(model, ids, mask):
    """The program's chosen experts per expert layer over the live tokens."""
    got = []
    live = mask.reshape(-1).bool()
    hooks = [layer.mlp.gate.register_forward_hook(
        lambda mod, args, out: got.append(out[0][live])) for layer in model.layers
        if isinstance(layer.mlp, moonlight.MoE)]
    with torch.no_grad():
        model.encode_hidden(ids, mask)
    for h in hooks:
        h.remove()
    return got


def test_the_port_and_the_reference_agree_on_the_state_dict_names():
    cfg = _cfg()
    assert dict(wm.shapes(_keys(cfg))) == moonlight.state_dict_names(cfg)


# float32 compute: the two differ only in the order of fp32 sums (and the
# reference's per-doc, per-expert grouping). bfloat16 compute: every
# product's operands rounded to 8 bits of mantissa through 4 layers and the
# head, against O(1) hidden states (RMSNorm output) and logits; where a
# token's scores come within that rounding of a tie its chosen experts may
# differ (2-5 % of the tokens here), so bf16 is held on the tokens routed
# alike in every layer, which still attend to earlier tokens routed
# otherwise: 0.015-0.066 on four seeds, against up to 0.36 on a token
# routed otherwise.
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-1}


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_hidden_and_reps_match_the_reference(compute):
    cfg = _cfg(compute)
    model = _model(cfg)
    ids, mask = _batch()
    with torch.no_grad():
        hid = model.encode_hidden(ids, mask)
        rep = tse.encode_doc(tse.SparseEncoderModel(cfg, model, torch.ones(cfg.vocab_size),
                                                    WordPieceTokenizer.from_pretrained(None)),
                             ids, mask)
    ref = _ref(cfg, model)
    with torch.no_grad():
        rrep, ref_routes, xs = ref.run(_docs(ids, mask))
        rh = ref_ml.rms(xs[-1], model.norm.float(), cfg.rms_norm_eps)
    live = mask.bool()
    assert hid.dtype == compute
    got = hid.float()[live]
    routes = _routes(model, ids, mask)
    same = torch.stack([(a.sort(-1).values == b.sort(-1).values).all(-1)
                        for a, b in zip(routes, ref_routes)]).all(0)
    if compute == torch.float32:
        assert bool(same.all())
        assert float((got - rh).abs().max()) <= TOL[compute]
        assert float((rep - rrep).abs().max()) <= 1e-5
    else:
        assert float(same.float().mean()) >= 0.9
        assert float((got - rh).abs()[same].max()) <= TOL[compute]
        assert float((rep - rrep).abs().max()) <= TOL[compute] * float(rrep.abs().max())


def test_the_router_takes_the_bias_in_the_choice_only_and_normalises():
    """The chosen experts are the top k of s + b; the weights are s (not
    s + b) over the chosen, over their sum, times the scale. A bias that
    lifts a low-scoring expert into the choice puts it there at its own
    score's weight."""
    g = torch.Generator().manual_seed(0)
    u, w_gate = torch.randn((5, 16), generator=g), torch.randn((8, 16), generator=g)
    s = torch.sigmoid(u @ w_gate.t())
    low = int(s[0].argmin())
    bias = torch.zeros(8)
    bias[low] = 10.0
    chosen, w = moe.route(u, w_gate, bias, 2, 2.446)
    assert low in chosen[0].tolist() and all(low in c for c in chosen.tolist())
    want = s.gather(1, chosen)
    want = want / want.sum(-1, keepdim=True) * 2.446
    assert torch.allclose(w, want, atol=1e-6)
    assert torch.allclose(w.sum(-1), torch.full((5,), 2.446), atol=1e-5)
    plain, _ = moe.route(u, w_gate, torch.zeros(8), 2, 2.446)
    assert torch.equal(plain, torch.topk(s, 2, dim=-1).indices)


def test_the_expert_layer_equals_per_token_dense_evaluation():
    """moe.experts (route, permute, the grouped products, the combine) on a
    layer of the tiny model against each token evaluated alone: Σ_e w_e
    E_e(u) + S(u) over its chosen experts."""
    cfg = _cfg()
    model = _model(cfg, seed=2)
    layer = model.layers[1].mlp
    g = torch.Generator().manual_seed(1)
    u = torch.randn((37, cfg.hidden_size), generator=g)
    x = torch.randn((37, cfg.hidden_size), generator=g)
    with torch.no_grad():
        got = layer(x.clone(), u, torch.float32)
        chosen, w = layer.gate(u)
        ex = layer.experts
        want = x.clone()
        for t in range(37):
            want[t] += layer.shared_experts(u[t])
            for s in range(cfg.num_experts_per_tok):
                e = int(chosen[t, s])
                h = torch.nn.functional.silu(ex.gate_proj[e] @ u[t]) * (ex.up_proj[e] @ u[t])
                want[t] += w[t, s] * (ex.down_proj[e] @ h)
    assert float((got - want).abs().max()) <= 1e-5


def test_permutation_sorts_by_expert_and_the_combine_is_deterministic():
    g = torch.Generator().manual_seed(3)
    chosen = torch.stack([torch.randperm(8, generator=g)[:2] for _ in range(50)])
    token, offsets, pos = moe.permute(chosen, 8)
    flat = chosen.reshape(-1)
    assert offsets.tolist() == [0] + torch.cumsum(torch.bincount(flat, minlength=8), 0).tolist()
    for e in range(8):  # each group holds its expert's rows in token order
        rows = token[offsets[e]:offsets[e + 1]]
        assert bool((chosen[rows] == e).any(-1).all()) and bool((rows.diff() > 0).all())
    for t in range(50):  # pos names the sorted row of each (token, slot)
        for s in range(2):
            r = int(pos[t, s])
            assert int(token[r]) == t and offsets[chosen[t, s]] <= r < offsets[chosen[t, s] + 1]
    y = torch.randn((100, 16), generator=g)
    w = torch.rand((50, 2), generator=g)
    shared = torch.randn((50, 16), generator=g)
    a = moe.combine(torch.zeros(50, 16), y, shared, pos, w)
    b = moe.combine(torch.zeros(50, 16), y, shared, pos, w)
    assert torch.equal(a, b)
    want = shared + (w[:, :, None] * y[pos]).sum(1)
    assert torch.allclose(a, want, atol=1e-6)


@pytest.mark.parametrize("layer", [0, 2])
def test_a_token_moves_only_the_positions_at_or_after_it(layer):
    """The derivative of a layer's output along a change of token j alone
    (forward mode): the positions before j do not move, j and after do."""
    cfg = _cfg()
    model = _model(cfg, seed=4)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, L, cfg.hidden_size), generator=g)
    j = 20
    change = torch.zeros_like(x)
    change[0, j] = torch.randn(cfg.hidden_size, generator=g)
    mask = torch.ones((1, L), dtype=torch.int32)
    rope = model._rope_for(L, "cpu")
    with torch.no_grad():
        _, moved = torch.func.jvp(lambda y: model.layers[layer](y, mask, rope), (x,), (change,))
    moved = moved.abs().amax(-1)[0] > 0
    assert bool((moved == (torch.arange(L) >= j)).all()), moved.nonzero().flatten().tolist()


def test_mla_shapes_and_the_shared_rope_key():
    """The large preset's MLA weights are the published shapes; in a
    forward, every head's key takes the same rope part (one k_r for all
    heads), while its nope part and its query differ."""
    big = moonlight.state_dict_names(moonlight.config_from_preset("moonlight-16b-a3b"))
    p = "layers.3.self_attn."
    assert big[p + "q_proj"] == (16 * 192, 2048)
    assert big[p + "kv_a_proj_with_mqa"] == (512 + 64, 2048)
    assert big[p + "kv_a_layernorm"] == (512,)
    assert big[p + "kv_b_proj"] == (16 * 256, 512)
    assert big[p + "o_proj"] == (2048, 16 * 128)
    cfg = _cfg()
    model = _model(cfg, seed=5)
    seen = []
    inner = moonlight.attention

    def spy(q, k, v, mask, window=0, causal=False):
        seen.append((q, k, v, causal))
        return inner(q, k, v, mask, window, causal)

    ids, mask = _batch(4)
    moonlight.attention = spy
    try:
        with torch.no_grad():
            model.encode_hidden(ids, mask)
    finally:
        moonlight.attention = inner
    assert len(seen) == cfg.num_hidden_layers
    q, k, v, causal = seen[0]
    nope, rd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    assert causal and q.shape == k.shape == (B, L, 4, nope + rd) and v.shape == (B, L, 4, 16)
    assert bool((k[..., nope:] == k[:, :, :1, nope:]).all())
    assert not bool((k[..., :nope] == k[:, :, :1, :nope]).all())


def test_rope_is_the_pair_layout():
    """apply_rope equals rotating each pair (2i, 2i + 1) by position ·
    θ^(-2i/d), read out de-interleaved (dims i and i + d/2)."""
    d, n = 8, 5
    x = torch.randn((1, n, 1, d), generator=torch.Generator().manual_seed(6))
    cos, sin = moonlight.rope_tables(n, d, 50000.0, "cpu")
    got = moonlight.apply_rope(x, cos, sin)[0, :, 0]
    for t in range(n):
        for i in range(d // 2):
            ang = t * 50000.0 ** (-2 * i / d)
            a, b = float(x[0, t, 0, 2 * i]), float(x[0, t, 0, 2 * i + 1])
            want = (a * np.cos(ang) - b * np.sin(ang), a * np.sin(ang) + b * np.cos(ang))
            assert abs(float(got[t, i]) - want[0]) < 1e-5
            assert abs(float(got[t, i + d // 2]) - want[1]) < 1e-5


def test_build_model_on_both_presets_and_the_published_count():
    """The tiny preset builds and encodes on the CPU; the large one is the
    published config (its build draws 32 GB on a card: chip_smoke step 3d),
    15 960 110 208 parameters, or 15 959 983 744 without the RMSNorm
    scales (54 + 1 of D and 27 of the kv rank)."""
    model = tse.build_model(arch="moonlight-tiny", seed=3, device="cpu",
                            compute_dtype=torch.float32)
    assert isinstance(model.bert, moonlight.MoonlightForCausalLM)
    assert model.bert.lm_head.dtype == torch.float32
    assert model.bert.layers[1].mlp.gate.weight.dtype == torch.float32
    ids, mask = _batch(7)
    with torch.no_grad():
        assert tse.encode_doc(model, ids, mask).shape == (B, 512)
    bf16 = tse.build_model(arch="moonlight-tiny", seed=3, device="cpu")
    assert bf16.bert.lm_head.dtype == torch.bfloat16
    assert tse.build_model(arch="moonlight-tiny", seed=3, device="cpu",
                           param_dtype="bfloat16").bert.lm_head.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute dtype"):
        tse.build_model(arch="moonlight-tiny", seed=3, device="cpu", param_dtype=torch.float32)
    assert bf16.bert.layers[0].input_layernorm.dtype == torch.float32
    cfg = moonlight.config_from_preset("moonlight-16b-a3b")
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.n_routed_experts,
            cfg.num_experts_per_tok, cfg.moe_intermediate_size, cfg.intermediate_size,
            cfg.vocab_size, cfg.kv_lora_rank) == (2048, 27, 64, 6, 1408, 11264, 163840, 512)
    shapes = moonlight.state_dict_names(cfg)
    n = sum(int(np.prod(s)) for s in shapes.values())
    norms = sum(int(np.prod(s)) for k, s in shapes.items() if k.endswith("norm"))
    assert n == 15_960_110_208 and norms == 55 * 2048 + 27 * 512
    assert n - norms == 15_959_983_744
    assert n == wm.n_params(wm.model_keys(_published_config()))


def _published_config():
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "lsr_bench", "configs", "moonlight-16b-a3b.json")) as f:
        return json.load(f)


def test_the_trainer_refuses_a_moonlight_backbone():
    from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

    cfg = _cfg()
    model = tse.SparseEncoderModel(cfg, _model(cfg), torch.ones(cfg.vocab_size),
                                   WordPieceTokenizer.from_pretrained(None))
    with pytest.raises(NotImplementedError, match="Moonlight"):
        Trainer(model, None, None, None)


def test_causal_plain_attention_equals_dense_causal_attention():
    """The plain causal path computes the key tiles up to each query tile's
    diagonal and counts them: on the live rows it equals dense masked
    causal attention (float64), at q·k dim 32 and v dim 16."""
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    g = torch.Generator().manual_seed(9)
    n = 150
    q, k = (torch.randn((3, n, 2, 32), generator=g) for _ in range(2))
    v = torch.randn((3, n, 2, 16), generator=g)
    mask = (torch.arange(n)[None, :] < torch.tensor([n, 70, 9])[:, None]).int()
    before = tracing.counters().get("encoder.attn.pairs.causal", 0)
    got = at.attention(q, k, v, mask, causal=True)
    assert tracing.counters()["encoder.attn.pairs.causal"] - before == \
        at.computed_pairs(3, n, 0, causal=True) == 3 * 64 * 64 * (1 + 2 + 3)
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    ok = mask.bool()[:, None, None, :] & torch.ones((n, n), dtype=torch.bool).tril()
    p = torch.softmax(((qd @ kd.transpose(-1, -2)) / 32 ** 0.5).masked_fill(~ok, float("-inf")),
                      -1)
    want = (p @ vd).transpose(1, 2)
    assert float((got.double() - want).abs()[mask.bool()].max()) <= 1e-5


# the benchmark's cell at test widths: the WordPiece's vocab (the traffic's
# ids need it), 16 experts with 6 a token as published (so the weights'
# normalisation divides by about 3, as at full size)
_CPUTEST = dict(vocab_size=30522, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                intermediate_size=96, moe_intermediate_size=32, n_routed_experts=16,
                num_experts_per_tok=6, n_shared_experts=1, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=16, v_head_dim=16, max_position_embeddings=512)


def _tiny_cell(monkeypatch, compute="float32", fault=None):
    from lsr_bench import harness

    monkeypatch.setitem(moonlight.PRESETS, "moonlight-cputest", _CPUTEST)
    cell = harness.load_cell("moonlight-scifact-ingest")
    cell.config = {**cell.config, **_CPUTEST}
    cell.traffic = {**cell.traffic, "corpus_docs": 12, "corpora": 1, "batch_size": 4,
                    "max_length": 128, "check_docs": 8,
                    "doc_words": {"median": 40, "sigma": 0.5, "min": 5, "max": 200}}
    cell.device, cell.seed = "cpu", 2**31 + 77
    cell.overrides["compute"] = compute
    if fault:
        cell.overrides["fault"] = fault
    return cell


@pytest.mark.parametrize("compute,fault", [("float32", None), ("bfloat16", None),
                                           ("bfloat16", "bias"), ("bfloat16", "norm"),
                                           ("bfloat16", "causal"), ("bfloat16", "token"),
                                           ("bfloat16", "rows")])
def test_the_benchmark_cell_at_test_widths(monkeypatch, compute, fault):
    """`moonlight-scifact-ingest` cut to test widths and a short corpus on
    the CPU: in float32 its row_gap reads round-off alone and every token is
    routed as the reference routes it, layer by layer from the program's
    own inputs, and each layer's update reads round-off alone; in bfloat16
    it is correct; the run again gives the timed call's rows; each
    planted fault (b left out of the choice, the weights not normalised, the
    causal mask dropped, a token altered, the routed experts of each
    batch's first 16 positions left out) is not."""
    from lsr_bench import harness

    out = harness.run_cell(_tiny_cell(monkeypatch, compute, fault), 0.2, False,
                           time.perf_counter())
    checks = out["checks"]
    if fault:
        assert not out["correct"], checks
    else:
        assert out["correct"], checks
        assert checks["replay_miss"]["value"] == 0, checks
    if compute == "float32":
        assert checks["row_gap"]["value"] <= 1e-5 and checks["layer_gap"]["value"] <= 1e-5 \
            and checks["route_miss"]["value"] == 0, checks


def test_the_control_fails_a_limit(monkeypatch):
    from lsr_bench import harness

    cell = _tiny_cell(monkeypatch, "bfloat16")
    driver = harness.load_driver(cell)
    driver.setup()
    driver.unit()
    nums = driver.control()
    lim = cell.traffic["limits"]
    assert any(nums[k] > lim[k] for k in lim if k in nums), nums


def test_stored_rows_that_the_run_again_does_not_give_fail(monkeypatch):
    """One weight of one stored row of the drawn call altered after the
    window: the check's run again no longer gives the stored rows, so
    replay_miss reads that doc and the run is not correct."""
    from lsr_bench import harness
    from lsr_bench.drivers import ingest_moonlight

    inner = ingest_moonlight.Driver.program_rows

    def altered(self):
        k, toks, w = inner(self)
        first = self.check_docs()[1][0]
        w = w.copy()
        w[first, 0] *= 2.0
        return k, toks, w

    monkeypatch.setattr(ingest_moonlight.Driver, "program_rows", altered)
    out = harness.run_cell(_tiny_cell(monkeypatch, "bfloat16"), 0.2, False, time.perf_counter())
    assert not out["correct"] and out["checks"]["replay_miss"]["value"] > 0, out["checks"]


def test_the_faults_are_put_back():
    """A planted fault patches the port's module and the driver's release
    puts it back, so later models in the process run the sound code."""
    from lsr_bench.drivers import ingest_moonlight

    before = (moe.route, moonlight.attention)
    for fault in ("bias", "causal"):
        undo = ingest_moonlight._plant(fault, None)
        assert (moe.route, moonlight.attention) != before
        undo()
        assert (moe.route, moonlight.attention) == before
