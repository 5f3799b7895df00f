"""On-card smoke run of the PyTorch port: `python3 chip_smoke.py` on a machine
with one CUDA card (an NVIDIA H100).

It builds every kernel of the ported slice from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card at the shapes
the main path gives it (and on the main path's own first ingest batch), times
ablation builds of the head kernel to show where its time goes, drives the
main path once through the entry point a user calls (`cli.evaluate_beir.main`
on the `synthetic-rich` task at the full `mini` width, random weights from a
seed), and checks what comes out. Any failed check exits non-zero. The last
lines of output are the `kernels` JSON line, the card's name and power
limit, and `{"ok": true, "device": {...}}`.

Imports torch and the port only, never jax or the JAX package. Writes under
`output/chip_smoke/` and builds the kernels under `build/torch_kernels/`
(the ablation copies under `build/maxpool_ablation/`).
"""

import ctypes
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "output", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
TOL = 1e-3  # |kernel - plain| <= TOL * max(1, |plain|): fp32 sums in another order


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() over `iters` back-to-back runs, CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def maxpool_inputs(B, L, D, V, seed, dev):
    """bf16 h and w, fp32 bias, int32 mask: rows padded to a length in
    [L/2, L] as bucketed batches are, and the last row all masked."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(B, L, D, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(V, D, generator=g) * 0.05).to(dev, torch.bfloat16)
    bias = torch.randn(V, generator=g).to(dev)
    lens = torch.randint(L // 2, L + 1, (B,), generator=g)
    mask = (torch.arange(L)[None, :] < lens[:, None]).to(torch.int32)
    mask[-1] = 0
    return h, mask.to(dev), w, bias


def library_head(h, mask, w, bias):
    """The same function from PyTorch's own calls: one bf16 GEMM with fp32
    output over [B*L, D] x [D, V], bias, mask, amax. A yardstick only."""
    B, L, D = h.shape
    logits = torch.mm(h.reshape(B * L, D), w.t(), out_dtype=torch.float32) + bias
    return (logits.view(B, L, -1) * mask[:, :, None]).amax(dim=1)


def kernel_row(name, h, mask, w, bias):
    """Hold the kernel against its plain version on these inputs, check that
    two launches agree bit for bit, and time kernel, plain and library."""
    from opensearch_sparse_model_tuning_sample_torch.ops.maxpool import (
        maxpool_head, maxpool_head_reference)

    B, L, D = h.shape
    V = w.shape[0]
    got = maxpool_head(h, mask, w, bias)
    again = maxpool_head(h, mask, w, bias)
    ref = maxpool_head_reference(h, mask, w, bias)
    lib = library_head(h, mask, w, bias)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    check(bool((err <= TOL * ref.abs().clamp_min(1.0)).all()),
          f"maxpool_head vs plain at {name}: max |err| {float(err.max())}")
    check(torch.equal(got, again), f"two launches agree bit for bit at {name}")
    dead = ~mask.bool().any(dim=1)
    check(bool((got[dead] == 0).all()), "an all-masked row pools to exactly 0")
    check(bool(((lib - ref).abs() <= 2e-2 * ref.abs().clamp_min(1.0)).all()),
          "the library yardstick computes the same function")
    ms = cuda_ms(lambda: maxpool_head(h, mask, w, bias), iters=20)
    plain_ms = cuda_ms(lambda: maxpool_head_reference(h, mask, w, bias), iters=3)
    library_ms = cuda_ms(lambda: library_head(h, mask, w, bias), iters=5)
    # the work these inputs need: logits at unmasked positions only
    # (a masked position contributes exactly 0 without a product)
    flops = 2.0 * float(mask.sum()) * D * V
    nbytes = B * L * D * 2 + B * L * 4 + V * D * 2 + V * 4 + B * V * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    # what the kernel computes: every position of each 64-position chunk
    # that holds an unmasked one (the rest of the chunk is padding)
    pad = -L % 64
    live = torch.nn.functional.pad(mask.bool(), (0, pad)).view(B, -1, 64).any(dim=2)
    computed = float((live.unsqueeze(2) & (torch.arange(L + pad, device=h.device) < L)
                      .view(1, -1, 64)).sum())
    row = dict(
        shape=[B, L, D, V], max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        share_of_bound=max(t_ops, t_bytes) / ms, tflops=flops / ms / 1e9,
        mean_unmasked=float(mask.sum()) / B, computed_over_unmasked=computed / float(mask.sum()),
    )
    print(f"maxpool_head {name} B={B} L={L} D={D} V={V}: max|err| {row['max_abs_err']:.3g}, "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {row['tflops']:.1f} TFLOP/s, "
          f"share of bound {row['share_of_bound']:.3f}; mean unmasked length "
          f"{row['mean_unmasked']:.2f} of {L}, computed/unmasked positions "
          f"{row['computed_over_unmasked']:.3f}; two launches bit-equal", flush=True)
    return row


def phase_kernels(dev, shapes, batch):
    """Synthetic inputs at each shape, then the main path's own first ingest
    batch (`batch`: h, mask, w, bias from the mini encoder)."""
    rows = []
    for i, (B, L, D, V) in enumerate(shapes):
        h, mask, w, bias = maxpool_inputs(B, L, D, V, seed=i, dev=dev)
        rows.append(kernel_row("synthetic", h, mask, w, bias))
        del h, mask, w, bias
        torch.cuda.empty_cache()
    rows.append(kernel_row("main-path batch", *batch))
    rows[-1]["inputs"] = "main-path batch"
    return rows


def main_path_batch(model, texts, dev):
    """h, mask, w and bias of the head for `texts`, exactly as the encoder
    hands them to the kernel, and the time of the per-batch fp32 -> bf16
    cast of the decoder weight (models/bert.py, mlm_maxpool)."""
    from opensearch_sparse_model_tuning_sample_torch.models.sparse_encoder import BatchEncoder

    enc = BatchEncoder(model, max_length=512)
    feats = model.tokenizer.encode_bucketed(texts, 512, enc.seq_buckets)
    ids = torch.from_numpy(feats["input_ids"]).to(dev)
    mask = torch.from_numpy(feats["attention_mask"]).to(dev)
    bert = model.bert
    with torch.inference_mode():
        h = bert.head_hidden(bert.encode_hidden(ids, mask)).to(torch.bfloat16).contiguous()
        w = bert.decoder_weight().to(torch.bfloat16).contiguous()
        bias = bert.mlm_head.bias.detach().float().contiguous()
        cast_ms = cuda_ms(lambda: bert.decoder_weight().to(torch.bfloat16), iters=20)
    print(f"per-batch decoder weight cast fp32 -> bf16 {tuple(w.shape)}: {cast_ms:.4f} ms",
          flush=True)
    return (h, mask.to(torch.int32).contiguous(), w, bias), cast_ms


# (text in the source, its replacement) for each part that can be taken out
_EPILOGUE = (
    "      // accumulator register 4j + 2hh + e: vocab row warp*16 + g + 8hh of",
    "#pragma unroll\n      for (int mt = 0; mt < MT; ++mt) {\n"
    "        run[mt][0] = fmaxf(run[mt][0], acc[mt][0]);\n"
    "        run[mt][1] = fmaxf(run[mt][1], acc[mt][2]);\n      }\n      continue;\n"
    "      // accumulator register 4j + 2hh + e: vocab row warp*16 + g + 8hh of",
)
_H = [
    ("        mbar_wait(full + s * 8, ph);\n", ""),
    ("          if (lane == 0) mbar_arrive(empty + prev * 8);\n", ""),
    ("      if (lane == 0) mbar_arrive(empty + prev * 8);\n", ""),
    ("  for (int b = p; b < B; b += kConsumerWGs) {", "  for (int b = p; b < 0; b += kConsumerWGs) {"),
]
ABLATIONS = {"kernel": [], "no_epilogue": [_EPILOGUE], "no_h": _H, "mma_only": [_EPILOGUE] + _H}


def _ablation_source(edits):
    from opensearch_sparse_model_tuning_sample_torch.ops.kernel_build import SOURCES

    src = SOURCES["maxpool_head"].read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation anchor not found once in maxpool_head.cu: {old!r}")
        src = src.replace(old, new)
    return src


def _build_ablations(out_dir):
    from opensearch_sparse_model_tuning_sample_torch.ops.kernel_build import NVCC_FLAGS, _nvcc

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in ABLATIONS.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(_ablation_source(edits))
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.maxpool_head_bf16.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.maxpool_head_bf16.restype = i
        libs[name] = lib
    return libs


def phase_ablation(dev, shapes):
    """Where the head kernel's time goes: the kernel as built and three
    copies with a part taken out, each with the port's nvcc flags, timed at
    `shapes` (best of two passes, order A B C D D C B A). The copies compute
    wrong results on purpose; only their times mean anything:
      no_epilogue  the per-chunk epilogue (bias, mask, running max) cut to
                   one max per row: what the epilogue costs;
      no_h         no h box loaded or waited for (the products read a stale
                   ring): what streaming h through the rings costs;
      mma_only     both: the wgmma issue and the w tile load alone."""
    libs = _build_ablations(os.path.join(HERE, "build", "maxpool_ablation"))
    times = {}
    for i, (B, L, D, V) in enumerate(shapes):
        h, mask, w, bias = maxpool_inputs(B, L, D, V, seed=i, dev=dev)
        out = torch.empty(B, V, device=dev)

        def launch(lib):
            rc = lib.maxpool_head_bf16(h.data_ptr(), mask.data_ptr(), w.data_ptr(),
                                       bias.data_ptr(), out.data_ptr(), B, L, D, V,
                                       torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"ablation launch: CUDA error {rc}")

        best = {}
        for name in list(libs) + list(libs)[::-1]:
            ms = cuda_ms(lambda: launch(libs[name]), iters=20)
            best[name] = min(best.get(name, ms), ms)
        torch.cuda.synchronize()
        print(f"ablation B={B} L={L} D={D} V={V}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in best.items()), flush=True)
        times[f"{B}x{L}x{D}x{V}"] = best
    return times


class _IngestRate(logging.Handler):
    """Picks the docs/s out of eval.beir.ingest's log record."""

    def __init__(self):
        super().__init__()
        self.docs_per_s = None

    def emit(self, record):
        if record.msg.startswith("ingested %d docs"):
            self.docs_per_s = record.args[3]


def main_path_config(dev):
    return {
        "arch": "mini",
        "idf_path": os.path.join(HERE, "assets", "idf.npz"),
        "inf_free": True,
        "beir_datasets": "synthetic-rich",
        "eval_max_seq_length": 512,
        "per_device_eval_batch_size": 50,
        "index_engine": "auto",
        "output_dir": os.path.join(OUT, "eval"),
        "device": str(dev),
        "model_name_or_path": None,
    }


def brute_force_check(index_dir, q, hits, V, dev):
    """The scan's top-10 against a dense product over the index's stored
    (tok, w) rows: scores to 1e-4 relative, ids equal up to ties."""
    blob = np.load(os.path.join(index_dir, "index.npz"))
    doc_ids = json.load(open(os.path.join(index_dir, "doc_ids.json")))
    n = len(doc_ids)
    toks = torch.from_numpy(blob["tokens"][:n].astype(np.int64)).to(dev)
    w = torch.from_numpy(blob["weights_bf16"][:n].view(np.int16)).to(dev).view(torch.bfloat16).float()
    D = torch.zeros(n, V, device=dev).scatter_add_(1, toks, w)
    S = q @ D.t()
    bs, bi = S.topk(10, dim=1)
    bs, bi, S = bs.cpu().numpy(), bi.cpu().numpy(), S.cpu().numpy()
    pos = {d: i for i, d in enumerate(doc_ids)}
    n_hits = 0
    for qi, got in enumerate(hits):
        ref = [(doc_ids[i], s) for s, i in zip(bs[qi], bi[qi]) if s > 0]
        check(len(got) == len(ref), f"query {qi}: {len(got)} hits, brute force {len(ref)}")
        got_s = sorted(got.values(), reverse=True)
        check(np.allclose(got_s, [s for _, s in ref], rtol=1e-4, atol=0),
              f"query {qi}: scores differ from brute force")
        kth = ref[-1][1] if ref else 0.0
        for d, s in got.items():
            true = S[qi, pos[d]]
            check(abs(true - s) <= 1e-4 * abs(true) and true >= kth * (1 - 1e-4),
                  f"query {qi}: doc {d} is not in the brute-force top-10")
        n_hits += len(got)
    return n_hits


def encoder_check(model, texts, l_max, dev):
    """The encoder's top-l_max output with the kernel against the same
    encoder with the plain head."""
    from opensearch_sparse_model_tuning_sample_torch.models.sparse_encoder import BatchEncoder
    from opensearch_sparse_model_tuning_sample_torch.ops.activations import pooled_activation
    from opensearch_sparse_model_tuning_sample_torch.ops.maxpool import (
        maxpool_head, maxpool_head_reference)

    enc = BatchEncoder(model, max_length=512)
    enc_idx, enc_w = enc.encode_batch_sparse(texts, l_max=l_max)
    feats = model.tokenizer.encode_bucketed(texts, 512, enc.seq_buckets)
    ids = torch.from_numpy(feats["input_ids"]).to(dev)
    mask = torch.from_numpy(feats["attention_mask"]).to(dev)
    bert, V = model.bert, model.vocab_size
    with torch.inference_mode():
        h = bert.head_hidden(bert.encode_hidden(ids, mask)).to(torch.bfloat16).contiguous()
        args = (mask.to(torch.int32).contiguous(), bert.decoder_weight().to(torch.bfloat16).contiguous(),
                bert.mlm_head.bias.float().contiguous())
        pk, pr = maxpool_head(h, *args), maxpool_head_reference(h, *args)
        err = (pk - pr).abs()
        check(bool((err <= TOL * pr.abs().clamp_min(1.0)).all()),
              f"encoder head: kernel vs plain max |err| {float(err.max())}")
        wk, ik = pooled_activation(pk)[:, :V].topk(l_max, dim=1)
        wr, ir = pooled_activation(pr)[:, :V].topk(l_max, dim=1)
    check(bool(((wk - wr).abs() <= TOL * wr.clamp_min(1.0)).all()), "top-l_max weights differ")
    edge = wr[:, -1:] + 2 * TOL  # ids may swap only between near-ties
    for r in range(len(texts)):
        a = set(ik[r][wk[r] > edge[r]].tolist())
        b = set(ir[r][wr[r] > edge[r]].tolist())
        check(a == b, f"doc {r}: top-l_max ids differ beyond ties")
    # the encoder's own ingest output is the kernel's
    wk, ik = wk.cpu().numpy(), ik.cpu().numpy()
    check(np.array_equal(enc_w, np.where(wk > 0, wk, 0)), "encoder weights are the kernel's")
    check(np.array_equal(enc_idx[wk > 0], ik[wk > 0]), "encoder ids are the kernel's")
    return float(err.max())


def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    from opensearch_sparse_model_tuning_sample_torch.cli import evaluate_beir
    from opensearch_sparse_model_tuning_sample_torch.core.config import parse_config
    from opensearch_sparse_model_tuning_sample_torch.core.device import resolve_device
    from opensearch_sparse_model_tuning_sample_torch.data.datasets import (
        BEIRCorpusDataset, KeyValueDataset)
    from opensearch_sparse_model_tuning_sample_torch.eval.beir import resolve_dataset
    from opensearch_sparse_model_tuning_sample_torch.eval.beir import search as beir_search
    from opensearch_sparse_model_tuning_sample_torch.index.engine import SparseIndex
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
    from opensearch_sparse_model_tuning_sample_torch.ops import kernel_build
    from opensearch_sparse_model_tuning_sample_torch.ops.maxpool import maxpool_head

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = resolve_device("cuda")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build every kernel from this checkout's sources, in parallel
    t0 = time.time()
    built = kernel_build.build()
    for name, info in built.items():
        # registers, spills and shared memory per kernel, and any note that
        # ptxas serialized the wgmmas (C75xx)
        report = [ln.strip() for ln in info["log"].splitlines()
                  if "registers" in ln or "spill" in ln or "smem" in ln or "C75" in ln]
        print(f"built {name} in {info['seconds']:.1f} s; ptxas: {report}", flush=True)
    print(f"build phase {time.time() - t0:.1f} s", flush=True)

    # 3. each kernel against its plain version on the card. The main path's
    # ingest batches are B=50 at the L=64 bucket (synthetic-rich docs all
    # fit 64 tokens); 128 and 512 are the longer buckets; base is D=768.
    # The last row is the main path's own first batch, at real doc lengths.
    cfg = main_path_config(dev)
    model_args, data_args, training_args = parse_config(dict(cfg))
    corpus, queries, _ = resolve_dataset("synthetic-rich", data_args.beir_dir)
    docs = BEIRCorpusDataset(corpus)
    model = se.from_model_args(model_args, seed=training_args.seed, device=dev)
    shapes = [(50, 64, 256, 30592), (50, 128, 256, 30592), (50, 512, 256, 30592),
              (8, 512, 768, 30592)]
    t0 = time.time()
    batch, cast_ms = main_path_batch(
        model, [docs[i][1] for i in range(training_args.per_device_eval_batch_size)], dev)
    rows = phase_kernels(dev, shapes, batch)
    del batch
    print(f"kernel phase {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    ablation = phase_ablation(dev, shapes)
    print(f"ablation phase {time.time() - t0:.1f} s", flush=True)

    # 4. the main path: cli.evaluate_beir on synthetic-rich, mini, on the card
    os.makedirs(OUT, exist_ok=True)
    os.environ["METRICS_DIR"] = os.path.join(OUT, "metrics")
    rate = _IngestRate()
    logging.getLogger("opensearch_sparse_model_tuning_sample_torch.eval.beir").addHandler(rate)
    t0 = time.time()
    maxpool_head.launches = 0
    avg = evaluate_beir.main(dict(cfg))
    launches = maxpool_head.launches
    t_main = time.time() - t0
    n_docs = len(docs)
    n_batches = -(-n_docs // training_args.per_device_eval_batch_size)
    print(f"main path {t_main:.1f} s: {n_docs} docs, {len(queries)} queries, "
          f"maxpool_head launches {launches} for {n_batches} ingest batches", flush=True)
    check(launches >= n_batches, "the kernel ran for every ingest batch")
    check(0.0 <= avg["NDCG@10"] <= 1.0 and avg["flops"] > 0, "finite metrics")

    # the exact scan against brute force, all queries
    qd = KeyValueDataset(queries)
    enc = se.BatchEncoder(model, max_length=512)
    q, nq = enc.encode_chunk_device([qd[i][1] for i in range(len(qd))], inf_free=True, rows=50)
    q = q[:nq]
    index_dir = os.path.join(cfg["output_dir"], "beir_eval", "synthetic-rich.index")
    index = SparseIndex.load(index_dir, device=dev)
    hits = index.search(q, k=10)
    n_hits = brute_force_check(index_dir, q, hits, model.vocab_size, dev)
    print(f"exact scan top-10 equals brute force for all {nq} queries ({n_hits} hits)", flush=True)
    # the main path reads search q/s once, on the process's first search
    # call; the same call repeated on the warm process shows its spread
    warm_qps = [beir_search(queries, model, index, os.path.dirname(index_dir),
                            "synthetic-rich", max_length=512, batch_size=50,
                            result_size=100)["qps"] for _ in range(3)]
    print(f"search q/s repeated on the warm process: {warm_qps}", flush=True)
    enc_err = encoder_check(model, [docs[i][1] for i in range(256)], data_args.index_l_max, dev)
    print(f"encoder top-{data_args.index_l_max} with the kernel equals the plain head "
          f"for 256 docs (max |err| {enc_err:.3g})", flush=True)
    print(f"ingest {rate.docs_per_s:.1f} docs/s, search {avg['qps']:.1f} q/s, "
          f"NDCG@10 {avg['NDCG@10']:.5f} (random-init weights: not a quality figure); "
          f"card {card}", flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)

    main_row = rows[-1]  # the main path's own batch
    kernels = [{
        "name": "maxpool_head",
        "route": "cuda",
        "source": "opensearch_sparse_model_tuning_sample_torch/csrc/maxpool_head.cu",
        "replaces": "opensearch_sparse_model_tuning_sample_tpu/ops/pallas_maxpool.py:99",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "share_of_bound": main_row["share_of_bound"],
        "shape": main_row["shape"],
        "inputs": "main-path batch",
        "decoder_cast_ms": cast_ms,
        "ablation_ms": ablation,
        "all_shapes": rows,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
