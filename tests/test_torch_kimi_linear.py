"""The port's Kimi Linear (`models/kimi_linear.py`, `ops/kda.py`, the expert
share of `ops/moe.py`) on the CPU, against the benchmark's plain reference
(`lsr_bench/reference/kimi_linear.py`), at test widths with the published
structure: 4 layers (KDA, KDA, KDA, MLA; a dense layer 0, then expert
layers of 16 experts, 4 a token, 1 shared), D 64, KDA of 2 heads of 16,
MLA of 4 heads at kv rank 32 and nope / rope / v dims 16 / 16 / 16, vocab
512, seeded random weights, rows of lengths 1-150 with padding.

  * encode_hidden and the reps against the reference, in float32 and bf16;
  * KDA: the reference's chunked form against its token-by-token
    definition, and the port's plain chunked path against both, over a doc
    that ends mid-chunk, right padding, strong decay and a length of 1; the
    short convolution at a doc's start;
  * the share: the expert layer's outputs over a partition of the experts
    add up, the shared expert counted once, to the uncut layer, in the port
    and in the reference;
  * the MLA's NoPE switch leaves Moonlight's attention as it was, bit for
    bit;
  * build_model on the presets, the published parameter count, the
    Trainer's refusal;
  * the benchmark's new cell at test widths: correct, the control and each
    planted fault not.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from lsr_bench import weights_kimi_linear as wk
from lsr_bench.reference import kimi_linear as ref_kl
from opensearch_sparse_model_tuning_sample_torch.models import kimi_linear as kl
from opensearch_sparse_model_tuning_sample_torch.models import moonlight
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import WordPieceTokenizer
from opensearch_sparse_model_tuning_sample_torch.ops import kda as kda_op
from opensearch_sparse_model_tuning_sample_torch.ops import moe

torch.set_num_threads(2)

B, L = 4, 150
LENS = [150, 70, 1, 129]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(compute=torch.float32, **kw):
    return kl.config_from_preset("kimi-linear-tiny", compute_dtype=compute, **kw)


def _model(cfg, seed=0):
    return kl.from_state_dict(cfg, kl.init_state_dict(cfg, seed), "cpu")


def _keys(cfg):
    return {**{k: getattr(cfg, k) for k in wk._KEYS}, "num_experts": cfg.experts_held,
            "n_routed": cfg.num_experts, "experts_first": cfg.experts_first,
            "kda_layers": cfg.kda_layers, "kda_num_heads": cfg.kda_num_heads,
            "kda_head_dim": cfg.kda_head_dim, "short_conv_kernel_size": cfg.short_conv_kernel_size}


def _ref(cfg, model, precision="fp32", held=None):
    sd = {k: v.float() for k, v in model.state_dict().items()}
    return ref_kl.Encoder(_keys(cfg), lambda names: {n: sd[n] for n, _ in names},
                          wk.layer_shapes, wk.outer_shapes, precision, held=held)


def _batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 512, (B, L), generator=g)
    mask = (torch.arange(L)[None, :] < torch.tensor(LENS)[:, None]).to(torch.int32)
    return ids * mask, mask


def _docs(ids, mask):
    return [ids[i, : int(mask[i].sum())] for i in range(ids.shape[0])]


def _published():
    with open(os.path.join(ROOT, "lsr_bench", "configs", "kimi-linear-48b-a3b.json")) as f:
        return json.load(f)


def test_the_port_and_the_reference_agree_on_the_state_dict_names():
    cfg = _cfg()
    assert dict(wk.shapes(_keys(cfg))) == kl.state_dict_names(cfg)
    big = kl.config_from_preset("kimi-linear-48b-a3b-ep2")
    assert dict(wk.shapes(wk.model_keys(_published()))) == kl.state_dict_names(big)


# float32 compute: the two differ in the order of fp32 sums alone (the
# reference runs KDA's chunks by solving for T and MLA per doc); bf16: every
# product's operands rounded to 8 bits of mantissa, so a token whose scores
# come within that rounding of a tie may choose other experts, and bf16 is
# held on the tokens routed alike in every layer
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
        rrep, ref_routes, xs = _ref(cfg, model).run(_docs(ids, mask))
        rh = ref_kl.rms(xs[-1], model.norm.float(), cfg.rms_norm_eps)
    live = mask.bool()
    got = hid.float()[live]
    routes = []
    hooks = [layer.mlp.gate.register_forward_hook(lambda mod, a, out: routes.append(out[0][
        live.reshape(-1)])) for layer in model.layers if isinstance(layer.mlp, kl.MoE)]
    with torch.no_grad():
        model.encode_hidden(ids, mask)
    for h in hooks:
        h.remove()
    same = torch.stack([(a.sort(-1).values == b.sort(-1).values).all(-1)
                        for a, b in zip(routes, ref_routes)]).all(0)
    assert hid.dtype == compute
    if compute == torch.float32:
        assert bool(same.all())
        assert float((got - rh).abs().max()) <= TOL[compute]
        assert float((rep - rrep).abs().max()) <= 1e-5
    else:
        assert float(same.float().mean()) >= 0.9
        assert float((got - rh).abs()[same].max()) <= TOL[compute]


def _kda_inputs(Bk, Lk, H, dk, dv, A, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn((Bk, Lk, H, dk), generator=g,
                                                  dtype=torch.float64), dim=-1)
    k = torch.nn.functional.normalize(torch.randn((Bk, Lk, H, dk), generator=g,
                                                  dtype=torch.float64), dim=-1)
    v = torch.randn((Bk, Lk, H, dv), generator=g, dtype=torch.float64)
    gate = -A * torch.nn.functional.softplus(torch.randn((Bk, Lk, H, dk), generator=g,
                                                         dtype=torch.float64) - 1.0)
    beta = torch.sigmoid(torch.randn((Bk, Lk, H), generator=g, dtype=torch.float64))
    return q, k, v, gate, beta


@pytest.mark.parametrize("Lk,A", [(150, 1.0), (64, 1.0), (1, 1.0), (130, 16.0), (200, 60.0)],
                         ids=["mid_chunk", "one_chunk", "length_1", "strong_decay",
                              "past_fp32_exp"])
def test_chunked_kda_equals_the_recurrence(Lk, A):
    """The reference's chunked form and the port's plain path against the
    definition token by token, in float64, at a doc that ends mid-chunk,
    one whole chunk, a length of 1 and strong decay (A 16 and 60: exp(−Γ)
    alone would overflow fp32 within a chunk at the last)."""
    q, k, v, g, beta = _kda_inputs(2, Lk, 3, 16, 8, A, seed=Lk)
    want = ref_kl.kda_recurrent(q, k, v, g, beta, 0.25)
    if A > 16:  # a chunk's decay past exp's fp32 range
        assert float(-g[:, :64].sum(1).min()) > 88
    chunked = ref_kl.kda_chunked(q, k, v, g, beta, 0.25)
    port = kda_op.kda(q, k, v, g, beta, 0.25)
    assert port.dtype == torch.float64
    assert float((chunked - want).abs().max()) <= 1e-12
    assert float((port - want).abs().max()) <= 1e-12
    port32 = kda_op.kda(*(t.float() for t in (q, k, v, g, beta)), 0.25)
    assert port32.dtype == torch.float32
    assert float((port32.double() - want).abs().max()) <= 1e-5


def test_right_padding_never_reaches_a_doc():
    """A doc's output is the same alone and in a batch with a longer doc,
    whatever its padding holds (any q, k, v, and decays g ≤ 0, as the model
    makes them)."""
    q, k, v, g, beta = _kda_inputs(2, 150, 2, 16, 16, 4.0, seed=5)
    n = 90
    alone = kda_op.kda(q[1:, :n], k[1:, :n], v[1:, :n], g[1:, :n], beta[1:, :n], 0.25)
    for t in (q, k, v):
        t[1, n:] = torch.randn_like(t[1, n:]) * 100
    g[1, n:] = -torch.randn_like(g[1, n:]).abs() * 100
    batched = kda_op.kda(q, k, v, g, beta, 0.25)
    assert float((batched[1:, :n] - alone).abs().max()) <= 1e-12


def test_the_short_conv_sees_zeros_before_the_doc_and_nothing_after():
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn((2, 9, 5), generator=g), torch.rand((5, 4), generator=g) - 0.5
    got = kda_op.short_conv(x, w)
    for t in range(9):
        want = sum(w[:, s] * x[:, t - 3 + s] for s in range(4) if t - 3 + s >= 0)
        assert torch.allclose(got[:, t], want, atol=1e-6)
    assert torch.allclose(got[:, 0], w[:, 3] * x[:, 0])
    moved = x.clone()
    moved[:, 5:] += 1.0
    assert torch.equal(kda_op.short_conv(moved, w)[:, :5], got[:, :5])


def test_the_shares_of_a_partition_add_up_to_the_uncut_layer():
    """The expert layer holding experts 0-5, 6-9 and 10-15 of 16 (each
    share's weights drawn as the uncut layer's): the three outputs, less the
    shared expert twice, equal the uncut layer's, in the port and in the
    reference; and the port's share equals the reference's share."""
    cfg = _cfg()
    full = _model(cfg, seed=3)
    g = torch.Generator().manual_seed(4)
    u = torch.randn((37, cfg.hidden_size), generator=g)
    x = torch.randn((37, cfg.hidden_size), generator=g)
    shared = full.layers[1].mlp.shared_experts
    with torch.no_grad():
        want = full.layers[1].mlp(x.clone(), u, torch.float32)
        parts, refs = [], []
        for first, count in ((0, 6), (6, 4), (10, 6)):
            scfg = _cfg(experts_first=first, experts_held=count)
            part = _model(scfg, seed=3)
            got = part.layers[1].mlp(x.clone(), u, torch.float32)
            parts.append(got - x - shared(u))
            ref = _ref(scfg, part, held=(first, count))
            w = ref.layer_weights(1)
            out, _ = ref.moe(u, w, "layers.1.")
            refs.append(out)
            assert float((got - x - out).abs().max()) <= 1e-5
        total = x + shared(u) + sum(parts)
        ref_full = _ref(cfg, full)
        rout, _ = ref_full.moe(u, ref_full.layer_weights(1), "layers.1.")
    assert float((total - want).abs().max()) <= 1e-5
    assert float((sum(refs) - 2 * shared(u) - rout).abs().max()) <= 1e-5


def test_permute_sorts_absent_experts_past_the_held_groups():
    g = torch.Generator().manual_seed(3)
    chosen = torch.stack([torch.randperm(16, generator=g)[:4] for _ in range(30)])
    token, offsets, pos = moe.permute(chosen, 6, first=4)
    flat = chosen.reshape(-1)
    held = (flat >= 4) & (flat < 10)
    assert offsets.tolist() == [0] + torch.cumsum(
        torch.bincount(flat[held] - 4, minlength=6), 0).tolist()
    assert bool(((pos < 0) == ~held.view(30, 4)).all())
    for t in range(30):
        for s in range(4):
            r = int(pos[t, s])
            if r >= 0:
                e = int(chosen[t, s]) - 4
                assert int(token[r]) == t and offsets[e] <= r < offsets[e + 1]


def test_nope_switch_leaves_moonlights_attention_bit_equal():
    """Moonlight's attention block through the shared `mla` is the block as
    it was written before the switch (rotated q_rope and k_r), bit for bit;
    with no rope tables the same weights give other values."""
    cfg = moonlight.config_from_preset("moonlight-tiny", compute_dtype=torch.float32)
    model = moonlight.from_state_dict(cfg, moonlight.init_state_dict(cfg, 1), "cpu")
    layer, at = model.layers[1], model.layers[1].self_attn
    ids, mask = _batch(2)
    ids = ids % cfg.vocab_size
    x = torch.nn.functional.embedding(ids, model.embed_tokens).float()
    rope = model._rope_for(L, "cpu")
    with torch.no_grad():
        got = layer.attend(x, mask, rope)
        H, nope, rd = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        a = moonlight.rms_norm(x, layer.input_layernorm, cfg.rms_norm_eps)
        q = torch.matmul(a, at.q_proj.t()).view(B, L, H, nope + rd)
        ckv = torch.matmul(a, at.kv_a_proj_with_mqa.t())
        c, k_r = ckv.split([cfg.kv_lora_rank, rd], dim=-1)
        kv = torch.matmul(moonlight.rms_norm(c, at.kv_a_layernorm, cfg.rms_norm_eps),
                          at.kv_b_proj.t()).view(B, L, H, nope + cfg.v_head_dim)
        cos, sin = rope
        q_r = moonlight.apply_rope(q[..., nope:], cos, sin)
        k_r = moonlight.apply_rope(k_r.view(B, L, 1, rd), cos, sin).expand(B, L, H, rd)
        q = torch.cat([q[..., :nope], q_r], dim=-1)
        k = torch.cat([kv[..., :nope], k_r], dim=-1)
        ctx = moonlight.attention(q, k, kv[..., nope:], mask, causal=True)
        want = torch.matmul(ctx.reshape(B, L, H * cfg.v_head_dim), at.o_proj.t())
        nope_out = moonlight.mla(cfg, at, a, mask, None)
    assert torch.equal(got, want)
    assert not torch.equal(nope_out, want)


def test_build_model_on_the_presets_and_the_published_count():
    """The tiny preset builds and encodes on the CPU; the large one is the
    published config with 128 of 256 experts held: 25 567 470 464
    parameters here of the published 49 122 681 728, as the configuration
    file states."""
    model = tse.build_model(arch="kimi-linear-tiny", seed=3, device="cpu",
                            compute_dtype=torch.float32)
    assert isinstance(model.bert, kl.KimiLinearForCausalLM)
    ids, mask = _batch(7)
    with torch.no_grad():
        assert tse.encode_doc(model, ids, mask).shape == (B, 512)
    bf16 = tse.build_model(arch="kimi-linear-tiny", seed=3, device="cpu")
    assert bf16.bert.lm_head.dtype == torch.bfloat16
    assert bf16.bert.layers[0].self_attn.A_log.dtype == torch.float32
    assert bf16.bert.layers[1].mlp.gate.weight.dtype == torch.float32
    cfg = kl.config_from_preset("kimi-linear-48b-a3b-ep2")
    assert [i for i in range(27) if not cfg.is_kda(i)] == [3, 7, 11, 15, 19, 23, 26]
    assert (cfg.hidden_size, cfg.num_experts, cfg.experts_held, cfg.num_experts_per_token,
            cfg.moe_intermediate_size, cfg.intermediate_size, cfg.vocab_size) == \
        (2304, 256, 128, 8, 1024, 9216, 163840)
    n = sum(int(np.prod(s)) for s in kl.state_dict_names(cfg).values())
    whole = sum(int(np.prod(s)) for s in kl.state_dict_names(kl.KimiLinearConfig()).values())
    dep = _published()["deployment"]
    assert n == 25_567_470_464 == dep["parameters"] == wk.n_params(wk.model_keys(_published()))
    assert whole == 49_122_681_728 == dep["parameters_published"]


def test_the_trainer_refuses_a_kimi_linear_backbone():
    from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

    cfg = _cfg()
    model = tse.SparseEncoderModel(cfg, _model(cfg), torch.ones(cfg.vocab_size),
                                   WordPieceTokenizer.from_pretrained(None))
    with pytest.raises(NotImplementedError, match="Kimi Linear"):
        Trainer(model, None, None, None)


# the benchmark's cell at test widths: the WordPiece's vocab (the traffic's
# ids need it), 8 of 16 experts held, 4 a token
_CPUTEST = dict(vocab_size=30522, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                intermediate_size=96, moe_intermediate_size=32, num_experts=16,
                num_experts_per_token=4, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=16, v_head_dim=16, kda_layers=(1, 2, 3), kda_num_heads=2,
                kda_head_dim=16, experts_held=8)


def _tiny_cell(monkeypatch, compute="float32", fault=None):
    from lsr_bench import harness

    monkeypatch.setitem(kl.PRESETS, "kimi-linear-cputest", _CPUTEST)
    cell = harness.load_cell("kimi-linear-longdoc32k-ingest")
    la = {**cell.config["linear_attn_config"], "kda_layers": [1, 2, 3], "num_heads": 2,
          "head_dim": 16}
    keys = {k: v for k, v in _CPUTEST.items() if k in wk._KEYS}
    cell.config = {**cell.config, **keys, "num_experts": 8, "linear_attn_config": la,
                   "deployment": {**cell.config["deployment"], "num_experts_published": 16}}
    cell.traffic = {**cell.traffic, "corpus_docs": 8, "corpora": 1, "batch_size": 2,
                    "max_length": 256, "check_docs": 4, "gap_window": 64,
                    "doc_words": {"median": 100, "sigma": 0.6, "min": 20, "max": 400}}
    cell.device, cell.seed = "cpu", 2**31 + 91
    cell.overrides["compute"] = compute
    if fault:
        cell.overrides["fault"] = fault
    return cell


@pytest.mark.parametrize("compute,fault", [("float32", None), ("bfloat16", None),
                                           ("bfloat16", "decay"), ("bfloat16", "beta"),
                                           ("bfloat16", "conv"), ("bfloat16", "share"),
                                           ("bfloat16", "causal"), ("bfloat16", "token")])
def test_the_benchmark_cell_at_test_widths(monkeypatch, compute, fault):
    """`kimi-linear-longdoc32k-ingest` cut to test widths and a short corpus
    on the CPU: in float32 its readings are round-off alone, every token
    routed as the reference routes it; in bfloat16 it is correct and the
    run again gives the timed call's rows; each planted fault (α after the
    delta update, β left out of the erase, a conv that sees one position
    ahead, the weights renormalised over the held experts, MLA's causal mask
    dropped, a token altered) is not."""
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


def test_the_faults_are_put_back():
    from lsr_bench.drivers import ingest_kimi_linear

    before = (kl.kda, kl.conv_silu, moe.experts, moonlight.attention)
    for fault in ("decay", "beta", "conv", "share", "causal"):
        undo = ingest_kimi_linear._plant(fault, None)
        assert (kl.kda, kl.conv_silu, moe.experts, moonlight.attention) != before
        undo()
        assert (kl.kda, kl.conv_silu, moe.experts, moonlight.attention) == before


def test_the_roofline_counts():
    """The whole forward's operations per token at the published widths,
    the held experts at k·128/256 rows a token; the KDA and MLA bounds per
    doc."""
    from lsr_bench.drivers import kimi_linear_roofline as work
    from lsr_bench.roofline import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S

    m = wk.model_keys(_published())
    assert work.held_rows_per_token(m) == 4.0
    n = 30851
    assert work.attn_linear_bound_s(m, [n]) == pytest.approx(
        20 * n * 32 * 1540 / PEAK_BYTES_PER_S)
    ops = n * (n + 1) / 2 * 32 * 2 * 320
    assert work.attn_causal_bound_s(m, [n]) == pytest.approx(7 * ops / PEAK_BF16_FLOPS)
    assert work.forward_flops(m, [n]) > work.per_token_flops(m) * n
