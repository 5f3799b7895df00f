"""The port's spans and counters (`utils/tracing.py`) on the CPU, and the
benchmark's readers of them.

  * under a profiler, an ingest and a train step emit their named `lsr.*`
    spans, nested by the call structure; with none, no span makes a
    `record_function`;
  * `encoder.positions` and `encoder.tokens` equal a count from the
    tokenizer's own bucketed output, `encoder.batch_len.<L>` the lengths of
    the length-sorted chunks' batches, and `padding_share.ingest` a count
    from the cell's corpora and the chunk, sort and batch-length rules;
    `encoder.copy_out.async` and `encoder.copy_out.waited` (chunks resolved
    through a CUDA event) stay 0 on the CPU;
  * the counter views (`launch_counts`, `counts`, `mesh_counts`,
    `reset_counts`) return what they did before the registry;
  * the idle-share readers on a synthetic trace: each share, `None` on a
    trace without the program's spans, and the partition of idle_share;
    `lsr_bench/idle_split.py`'s split of each gap over the spans open
    during it.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from opensearch_sparse_model_tuning_sample_torch.core import config as tconfig
from opensearch_sparse_model_tuning_sample_torch.data.loader import DataLoader
from opensearch_sparse_model_tuning_sample_torch.eval.beir import ingest
from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp
from opensearch_sparse_model_tuning_sample_torch.parallel import collectives
from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer
from opensearch_sparse_model_tuning_sample_torch.utils import tracing

torch.set_num_threads(2)

WORDS = ("the capital of france is paris machine learning on tensor processing units sparse "
         "retrieval uses inverted indexes bert computes contextual token representations").split()
BATCH = 4  # ingest's chunk is 8 batches: 32 docs


def _tiny_model():
    return tse.build_model(arch="tiny", idf_path="assets/idf.npz", seed=0, device="cpu",
                           compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    return _tiny_model()


def _corpus(n, seed=0, lo=2, hi=90):
    r = np.random.default_rng(seed)
    return [(f"d{i}", " ".join(r.choice(WORDS, int(r.integers(lo, hi)))))
            for i in range(n)]


def _ingest(model, tmp_path, corpus):
    return ingest(corpus, model, str(tmp_path), "t", max_length=128, batch_size=BATCH,
                  index_cfg=IndexConfig(engine="sparse", l_max=16))


def _train_step(model, tmp_path):
    ma = tconfig.ModelArguments(inf_free=True, arch="tiny")
    da = tconfig.DataArguments(loss_types=["infonce"], use_in_batch_negatives=True,
                               flops_d_lambda=0.01, flops_d_T=10)
    ta = tconfig.TrainingArguments(output_dir=str(tmp_path), max_steps=2, warmup_steps=1,
                                   learning_rate=1e-3, logging_steps=1000, save_strategy="no",
                                   seed=0, device="cpu")
    tok = model.tokenizer
    texts = [t for _, t in _corpus(12, seed=1, hi=12)]

    def collate(rows):
        qf = tok(rows[:4], max_length=16, pad_to=16)
        df = tok(rows, max_length=24, pad_to=24)
        return {"q_input_ids": qf["input_ids"], "q_attention_mask": qf["attention_mask"],
                "d_input_ids": df["input_ids"], "d_attention_mask": df["attention_mask"]}

    loader = DataLoader(texts, batch_size=12, collate_fn=collate, seed=0)
    trainer = Trainer(model, ma, da, ta)
    trainer.train_step({k: torch.from_numpy(v) for k, v in next(iter(loader)).items()})


# the spans each path must emit, and (inner, outer) pairs that must nest
PATHS = {
    "ingest": ({"data.tokenize", "data.copy_in", "encoder.forward", "encoder.head",
                "encoder.topk", "encoder.copy_out", "index.add", "index.finalize",
                "index.stat"},
               [("encoder.head", "encoder.forward")]),
    "train_step": ({"train.encode", "train.loss", "train.backward", "train.optimizer",
                    "encoder.head", "data.collate"},
                   [("encoder.head", "train.encode")]),
}


def _run(path, model, tmp_path):
    if path == "ingest":
        _ingest(model, tmp_path, _corpus(40))
    else:
        _train_step(model, tmp_path)


def _spans(prof):
    """(start, end, thread, name) of the profiler's `lsr.*` host events."""
    return [(e.start_ns(), e.end_ns(), e.start_thread_id(), e.name()[len(tracing.PREFIX):])
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU and e.name().startswith(tracing.PREFIX)]


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_nest_under_a_profiler(path, model, tmp_path):
    fresh = _tiny_model() if path == "train_step" else model  # a step changes the weights
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(path, fresh, tmp_path)
    spans = _spans(prof)
    want, pairs = PATHS[path]
    assert want <= {s[3] for s in spans}, sorted({s[3] for s in spans})
    outer = {}
    for a in spans:  # two spans of a thread are disjoint or one holds the other
        for b in spans:
            if a is b or a[2] != b[2] or a[1] <= b[0] or b[1] <= a[0]:
                continue
            assert (b[0] <= a[0] and a[1] <= b[1]) or (a[0] <= b[0] and b[1] <= a[1]), (a, b)
            if b[0] <= a[0] and a[1] <= b[1]:
                outer.setdefault(a[3], set()).add(b[3])
    for inner, out in pairs:
        assert out in outer.get(inner, set()), (inner, outer.get(inner))
    # the copy to the card follows the tokenizer; it is not inside it
    assert "data.tokenize" not in outer.get("data.copy_in", set())


@pytest.mark.parametrize("path", list(PATHS))
def test_no_record_function_without_a_profiler(path, model, tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler recording")

    # the port's spans make theirs here (torch's optimizer makes its own
    # through torch.autograd.profiler, whatever the profiler's state)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("data.tokenize") is tracing.span("index.add")  # one null context
    fresh = _tiny_model() if path == "train_step" else model  # a step changes the weights
    _run(path, fresh, tmp_path)


def _sorted_batches(lengths, rows, width):
    """(rows, length) of each batch of a sorted chunk: its rows by length,
    cut into ceil(n / rows) batches, all of `rows` rows but the first,
    which holds what `rows` does not divide; each batch at the smallest
    multiple of 64 that holds its longest row (at least 64), capped at
    `width`."""
    rowlens = sorted(int(x) for x in lengths)
    parts = [rowlens[max(end - rows, 0):end] for end in range(len(rowlens), 0, -rows)][::-1]
    return [(len(p), min(max(64, -(-max(p) // 64) * 64), width)) for p in parts]


def test_encoder_counts_positions_and_tokens(model, tmp_path):
    """The positions the encoder runs (each batch of a length-sorted chunk
    at its own length, the chunk's first batch short) and the real tokens
    among them, against the tokenizer's own bucketed output of each 32-doc
    chunk. The CPU resolves no chunk through an event."""
    corpus = _corpus(75, seed=5, lo=1, hi=200)
    events = ["encoder.copy_out.async", "encoder.copy_out.waited"]
    tracing.reset(["encoder.positions", "encoder.tokens"] + events)
    _ingest(model, tmp_path, corpus)
    c = tracing.counters()
    assert all(c.get(k, 0) == 0 for k in events)
    positions = tokens = 0
    for s in range(0, len(corpus), 8 * BATCH):
        texts = [t for _, t in corpus[s:s + 8 * BATCH]]
        mask = model.tokenizer.encode_bucketed(texts, 128, [64, 128])["attention_mask"]
        positions += sum(r * L for r, L in _sorted_batches(mask.sum(1), BATCH, mask.shape[1]))
        tokens += int(mask.sum())
    assert (c["encoder.positions"], c["encoder.tokens"]) == (positions, tokens)
    assert tokens < positions


def test_encoder_counts_batches_by_length(model, tmp_path):
    """`encoder.batch_len.<L>` counts the batches the ingest path runs at
    each length: the counts sum to the number of batches, each L is a
    batch's own length, and some batch runs below its chunk's bucket."""
    corpus = _corpus(75, seed=5, lo=1, hi=200)
    tracing.reset([k for k in tracing.counters() if k.startswith("encoder.batch_len.")])
    _ingest(model, tmp_path, corpus)
    got = {int(k.rsplit(".", 1)[1]): v for k, v in tracing.counters().items()
           if k.startswith("encoder.batch_len.")}
    want, below = {}, 0
    for s in range(0, len(corpus), 8 * BATCH):
        texts = [t for _, t in corpus[s:s + 8 * BATCH]]
        mask = model.tokenizer.encode_bucketed(texts, 128, [64, 128])["attention_mask"]
        for _, L in _sorted_batches(mask.sum(1), BATCH, mask.shape[1]):
            want[L] = want.get(L, 0) + 1
            below += L < mask.shape[1]
    assert got == want
    assert sum(got.values()) == sum(
        -(-min(8 * BATCH, len(corpus) - s) // BATCH) for s in range(0, len(corpus), 8 * BATCH))
    assert below > 0 and set(got) <= {64, 128}


def test_padding_share_reads_the_cells_corpora():
    """The benchmark's ingest cell cut to the CPU: padding_share.ingest over
    the warm-up and two calls equals the share from the cell's token counts
    (words + [CLS] + [SEP], one wordpiece a word), its chunks of 8 batches
    sorted by length, the first batch of each short, and each batch at the
    smallest multiple of 64 that holds its longest doc, within the smallest
    bucket holding the chunk's longest doc."""
    from lsr_bench import harness

    cell = harness.load_cell("distil-ingest")
    cell.config = dict(cell.config, dim=128, n_layers=2, n_heads=2, hidden_dim=512)
    cell.traffic = dict(cell.traffic, corpus_docs=70, corpora=2, batch_size=8,
                        doc_words={"median": 30, "sigma": 0.6, "min": 4, "max": 120})
    cell.device, cell.seed = "cpu", 2**31 + 12345
    cell.overrides["compute"] = "float32"
    tracing.reset(["encoder.positions", "encoder.tokens"])
    driver = harness.load_driver(cell)
    driver.setup()
    for _ in range(2):
        driver.unit()
    run = harness.Run(cell, driver, harness.Half(), harness.Half(), None)
    got = harness.load_reader(harness.BENCH_DIR, "padding_share.ingest")(run)
    t = cell.traffic
    ch, L = 8 * t["batch_size"], t["max_length"]
    calls = [k % t["corpora"] for k in range(t["warmup_calls"])] + [0, 1]
    positions = tokens = 0
    for k in calls:
        tok = driver.tokens[k]
        for s in range(0, len(tok), ch):
            part = tok[s:s + ch]
            bucket = min(b for b in (64, 128, 256, 512, L) if b >= part.max())
            positions += sum(r * L for r, L in _sorted_batches(part, t["batch_size"], bucket))
            tokens += int(part.sum())
    assert got == pytest.approx(100.0 * (1.0 - tokens / positions), abs=0.01)
    assert 0 < got < 100
    driver.release()
    driver.out.cleanup()


def test_head_counter_views_read_as_before():
    h, w = torch.randn(2, 5, 8), torch.randn(30, 8)
    mask, bias = torch.ones(2, 5, dtype=torch.int32), torch.zeros(30)
    before = mp.launch_counts()
    assert set(before) == {"kernels", "plains"}
    assert set(before["kernels"]) == {f.__name__ for f in mp._KERNELS}
    assert set(before["plains"]) == {f.__name__ for f in mp._PLAINS}
    mp.maxpool_head(h, mask, w, bias)  # the plain version on the CPU, no launch
    after = mp.launch_counts()
    assert after["kernels"] == before["kernels"]
    assert after["plains"]["maxpool_head_reference"] == before["plains"][
        "maxpool_head_reference"] + 1
    mp.reset_launch_counts()
    assert all(v == 0 for part in mp.launch_counts().values() for v in part.values())


def test_collective_counter_views_read_as_before():
    collectives.reset_counts()
    assert collectives.counts() == {"all_gather_batch": 0, "all_reduce_grads": 0}
    assert collectives.mesh_counts() == {"mesh_gather": 0, "mesh_grad_sum": 0,
                                         "mesh_broadcast": 0}
    lead = [torch.nn.Parameter(torch.ones(3))]
    rep = [[torch.nn.Parameter(torch.ones(3))]]
    lead[0].grad, rep[0][0].grad = torch.ones(3), torch.ones(3)
    collectives.mesh_gather([torch.ones(2), torch.ones(2)], torch.device("cpu"))
    collectives.mesh_grad_sum(lead, rep)
    collectives.mesh_broadcast(lead, rep)
    merges = tracing.counters().get("collectives.merged_topk", 0)
    collectives.merged_topk([torch.ones(1, 2)], [torch.zeros(1, 2, dtype=torch.long)], 2)
    assert collectives.mesh_counts() == {"mesh_gather": 1, "mesh_grad_sum": 1,
                                         "mesh_broadcast": 1}
    assert collectives.counts() == {"all_gather_batch": 0, "all_reduce_grads": 0}
    assert tracing.counters()["collectives.merged_topk"] == merges + 1
    collectives.reset_counts()  # the train step's five, as before; not the merge
    assert collectives.mesh_counts() == {"mesh_gather": 0, "mesh_grad_sum": 0,
                                         "mesh_broadcast": 0}
    assert tracing.counters()["collectives.merged_topk"] == merges + 1


# ------------------------------------------------ the benchmark's readers


class Ev:
    """A profiler event as `lsr_bench/trace.py::read_events` reads one."""

    def __init__(self, name, dev, s, e, corr=0, link=0):
        self._v = (name, dev, s, e, corr, link)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def end_ns(self): return self._v[3]
    def duration_ns(self): return self._v[3] - self._v[2]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def start_thread_id(self): return 1
    def device_index(self): return 0
    def is_user_annotation(self): return False


CPU, GPU = DeviceType.CPU, DeviceType.CUDA
HARNESS = [
    Ev("lsr.ingest", CPU, 0, 900),
    Ev("lsr.head", CPU, 295, 380),
    Ev("aten::copy_", CPU, 105, 106, corr=10), Ev("aten::mm", CPU, 125, 126, corr=11),
    Ev("aten::head", CPU, 305, 306, corr=12), Ev("aten::copy_", CPU, 402, 403, corr=13),
    Ev("aten::copy_", CPU, 710, 711, corr=14),
    Ev("Memcpy HtoD", GPU, 106, 115, link=10), Ev("gemm", GPU, 130, 300, link=11),
    Ev("maxpool_head_kernel", GPU, 310, 350, link=12), Ev("Memcpy DtoH", GPU, 405, 420, link=13),
    Ev("Memcpy HtoD", GPU, 720, 760, link=14), Ev("late", GPU, 905, 910),
]
PROGRAM = [
    Ev("lsr.data.tokenize", CPU, 5, 100), Ev("lsr.data.copy_in", CPU, 100, 120),
    Ev("lsr.encoder.forward", CPU, 120, 400), Ev("lsr.encoder.head", CPU, 296, 379),
    Ev("lsr.encoder.copy_out", CPU, 400, 600), Ev("lsr.index.add", CPU, 600, 700),
    Ev("lsr.index.finalize", CPU, 700, 800),
]
# idle gaps of the card by the span open when each began (ns of a 1000 ns
# window): [0, 106) bare ingest; [115, 130) data.copy_in; [300, 310),
# [350, 405) encoder.head and [420, 720) encoder.copy_out; [760, 905)
# index.finalize; [910, 1000) outside
IDLE = {"data": 15, "encoder": 10 + 55 + 300, "index": 145}


def _reader_run(events):
    from lsr_bench import harness, trace

    tr = trace.read_events(events, 0, 1000, [0], 1000e-9)
    return harness, harness.Run(None, None, harness.Half(), harness.Half(), tr)


@pytest.mark.parametrize("layer", list(IDLE))
def test_idle_share_readers(layer):
    harness, run = _reader_run(HARNESS + PROGRAM)
    read = harness.load_reader(harness.BENCH_DIR, f"{layer}_idle_share.ingest")
    assert read(run) == pytest.approx(100.0 * IDLE[layer] / 1000)
    _, bare = _reader_run(HARNESS)  # the parent's trace: no span of the program
    assert read(bare) is None
    bare.trace = None
    assert read(bare) is None


def test_idle_shares_partition_idle_share():
    harness, run = _reader_run(HARNESS + PROGRAM)
    shares = sum(harness.load_reader(harness.BENCH_DIR, f"{k}_idle_share.ingest")(run)
                 for k in IDLE)
    idle = run.trace.idle_by_range
    assert idle["ingest"] == pytest.approx(106e-9) and "head" not in idle
    rest = 100.0 * (idle["ingest"] + idle["outside_ranges"]) / 1000e-9
    total = harness.load_reader(harness.BENCH_DIR, "idle_share.ingest")(run)
    assert shares + rest == pytest.approx(total) and total == pytest.approx(72.1)


def test_padding_share_reader_reads_the_counters():
    from lsr_bench import harness

    read = harness.load_reader(harness.BENCH_DIR, "padding_share.ingest")
    run = harness.Run(None, None, harness.Half(), harness.Half(), None)
    tracing.reset(["encoder.positions", "encoder.tokens"])
    assert read(run) is None
    tracing.count("encoder.positions", 2048)
    tracing.count("encoder.tokens", 512)
    assert read(run) == pytest.approx(75.0)


# where the host is during each gap: [0, 106) ingest 5, data.tokenize 95,
# data.copy_in 6; [115, 130) data.copy_in 5, encoder.forward 10; [300, 310)
# encoder.head 10; [350, 405) encoder.head 29, head 1, encoder.forward 20,
# encoder.copy_out 5; [420, 720) encoder.copy_out 180, index.add 100,
# index.finalize 20; [760, 905) index.finalize 40, ingest 100, outside 5;
# [910, 1000) outside 90 (ns)
DURING = {"data.": 95 + 11, "encoder.": 30 + 39 + 185, "index.": 100 + 60, "ingest": 105,
          "outside_ranges": 95}


def _split():
    from lsr_bench import idle_split

    spans, dev = idle_split.host_events(HARNESS + PROGRAM)
    return idle_split.split_gaps(spans, dev[0], 0, 1000)


@pytest.mark.parametrize("prefix", list(DURING))
def test_idle_split_books_each_instant_to_its_span(prefix):
    got = sum(v for k, v in _split().items() if k.startswith(prefix))
    assert got == pytest.approx(DURING[prefix] * 1e-9)


def test_idle_split_covers_the_idle_time():
    """The split's parts sum to the idle time, which the trace's rule books
    otherwise: the gap begun in encoder.copy_out lasts through index.add."""
    split = _split()
    _, run = _reader_run(HARNESS + PROGRAM)
    idle = run.trace.idle_by_range
    assert sum(split.values()) == pytest.approx(sum(idle.values()))
    assert split["head"] == pytest.approx(1e-9) and "index.add" not in idle
    assert split["index.add"] == pytest.approx(100e-9)


def _kernel_pairs(rows, L, window, global_tile=(128, 64), local_tile=(64, 64)):
    """The query-key pairs the attention kernel computes for [rows, L]: a
    global layer every (query tile, key tile) pair of the padded grid; a
    local one, for each 64-query tile from m0, the 64-key tiles from the
    one holding m0 - window to the one holding min(m0 + 63 + window, L - 1)."""
    if not window:
        bm, bn = global_tile
        return rows * (-(-L // bm) * bm) * (-(-L // bn) * bn)
    bm, bn = local_tile
    tiles = sum(min(m0 + bm - 1 + window, L - 1) // bn - max(m0 - window, 0) // bn + 1
                for m0 in range(0, L, bm))
    return rows * bm * bn * tiles


def test_modernbert_attention_spans_and_pair_counters(tmp_path):
    """A ModernBERT ingest under a profiler: each layer's attention core is
    the span `encoder.attn.global` or `encoder.attn.local` inside
    `encoder.forward`, and the counters `encoder.attn.pairs.*` add, for
    every batch the sorted chunks run (`encoder.batch_len.<L>`), its
    layers' kernel pairs at that length (padding and masked pairs
    included)."""
    (tmp_path / "vocab").mkdir()
    (tmp_path / "vocab" / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set(WORDS))) + "\n")
    model = tse.build_model(arch="modernbert-tiny", tokenizer_name=str(tmp_path / "vocab"),
                            seed=0, device="cpu", compute_dtype=torch.float32)
    cfg = model.cfg
    names = ["encoder.attn.pairs.global", "encoder.attn.pairs.local"]
    tracing.reset(names + [k for k in tracing.counters() if k.startswith("encoder.batch_len.")])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _ingest(model, tmp_path, _corpus(40, seed=3, lo=2, hi=150))
    spans = _spans(prof)
    forward = [s for s in spans if s[3] == "encoder.forward"]
    by_kind = {k: [s for s in spans if s[3] == "encoder.attn." + k] for k in ("global", "local")}
    layers = {"global": sum(cfg.is_global(i) for i in range(cfg.num_hidden_layers))}
    layers["local"] = cfg.num_hidden_layers - layers["global"]
    for kind, found in by_kind.items():
        assert len(found) == layers[kind] * len(forward)
        assert all(any(f[0] <= s[0] and s[1] <= f[1] for f in forward) for s in found)
    c = tracing.counters()
    batches = {int(k.rsplit(".", 1)[1]): v for k, v in c.items()
               if k.startswith("encoder.batch_len.")}
    for kind, window in (("global", 0), ("local", cfg.local_attention // 2)):
        want = sum(n * layers[kind] * _kernel_pairs(BATCH, L, window) for L, n in batches.items())
        assert c["encoder.attn.pairs." + kind] == want


def test_kimi_linear_spans_and_counters(tmp_path):
    """A Kimi Linear ingest under a profiler (the tiny preset: KDA, KDA, KDA,
    MLA; 16 experts, a share of 8 held): each KDA layer's mixer is the span
    `encoder.attn.linear` inside `encoder.forward`, the MLA layer's core
    `encoder.attn.causal`; `encoder.attn.tokens.linear` adds every KDA
    layer's positions, padding included; the plain KDA runs once a KDA
    layer and forward; `encoder.moe.experts_held` is the share, counted
    once at build."""
    (tmp_path / "vocab").mkdir()
    (tmp_path / "vocab" / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set(WORDS))) + "\n")
    from opensearch_sparse_model_tuning_sample_torch.models import kimi_linear

    tracing.reset()
    cfg = kimi_linear.config_from_preset("kimi-linear-tiny", compute_dtype=torch.float32,
                                         experts_held=8, experts_first=8)
    bert = kimi_linear.from_state_dict(cfg, kimi_linear.init_state_dict(cfg, 0), "cpu")
    tok = tse.load_tokenizer(str(tmp_path / "vocab"))
    model = tse.SparseEncoderModel(cfg, bert, torch.ones(cfg.vocab_size), tok)
    assert tracing.counters()["encoder.moe.experts_held"] == 8
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _ingest(model, tmp_path, _corpus(20, seed=4, lo=2, hi=150))
    spans = _spans(prof)
    forward = [s for s in spans if s[3] == "encoder.forward"]
    n_kda = sum(cfg.is_kda(i) for i in range(cfg.num_hidden_layers))
    for name, n in (("encoder.attn.linear", n_kda), ("encoder.attn.causal", 4 - n_kda)):
        found = [s for s in spans if s[3] == name]
        assert len(found) == n * len(forward) > 0
        assert all(any(f[0] <= s[0] and s[1] <= f[1] for f in forward) for s in found)
    c = tracing.counters()
    assert c["encoder.attn.tokens.linear"] == n_kda * c["encoder.positions"]
    assert c["kda.plain_calls.kda_chunked_reference"] == n_kda * len(forward)
    assert c["encoder.moe.experts_held"] == 8


def test_recorded_counts_stay_out_of_the_registry():
    """Inside `recording()` a thread's counts go to its own dict (nested
    recordings each to their own), another thread's to the registry; `add`
    adds a recorded dict back, as a CUDA graph's replay does."""
    import threading

    tracing.reset(["t.a", "t.b"])
    with tracing.recording() as outer:
        tracing.count("t.a", 2)
        with tracing.recording() as inner:
            tracing.count("t.b")
        worker = threading.Thread(target=tracing.count, args=("t.b", 5))
        worker.start()
        worker.join()
        tracing.count("t.a")
    assert outer == {"t.a": 3} and inner == {"t.b": 1}
    assert tracing.counters().get("t.a", 0) == 0 and tracing.counters()["t.b"] == 5
    tracing.add(outer)
    tracing.add(outer)
    assert tracing.counters()["t.a"] == 6
    tracing.reset(["t.a", "t.b"])
