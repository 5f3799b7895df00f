"""On-card smoke run of the PyTorch port: `python3 chip_smoke.py` on a machine
with one CUDA card (an NVIDIA H100).

It builds every kernel of the ported slice from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card at the shapes
the main path gives it, drives the main path once through the entry point a
user calls (`cli.evaluate_beir.main` on the `synthetic-rich` task at the full
`mini` width, random weights from a seed), and checks what comes out. Any
failed check exits non-zero. The last two lines of output are the `kernels`
JSON line (before it, the card's name and power limit) and
`{"ok": true, "device": {...}}`.

Imports torch and the port only, never jax or the JAX package. Writes under
`output/chip_smoke/` and builds the kernels under `build/torch_kernels/`.
"""

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


def phase_kernels(dev, shapes):
    from opensearch_sparse_model_tuning_sample_torch.ops.maxpool import (
        maxpool_head, maxpool_head_reference)

    rows = []
    for i, (B, L, D, V) in enumerate(shapes):
        h, mask, w, bias = maxpool_inputs(B, L, D, V, seed=i, dev=dev)
        got = maxpool_head(h, mask, w, bias)
        ref = maxpool_head_reference(h, mask, w, bias)
        lib = library_head(h, mask, w, bias)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        check(bool((err <= TOL * ref.abs().clamp_min(1.0)).all()),
              f"maxpool_head vs plain at {(B, L, D, V)}: max |err| {float(err.max())}")
        check(bool((got[-1] == 0).all()), "an all-masked row pools to exactly 0")
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
        rows.append(dict(
            shape=[B, L, D, V], max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
        ))
        print(f"maxpool_head B={B} L={L} D={D} V={V}: max|err| {rows[-1]['max_abs_err']:.3g}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
              f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        del h, mask, w, bias, got, ref, lib
        torch.cuda.empty_cache()
    return rows


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
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        print(f"built {name} in {info['seconds']:.1f} s; ptxas: {regs}", flush=True)
    print(f"build phase {time.time() - t0:.1f} s", flush=True)

    # 3. each kernel against its plain version on the card. The main path's
    # ingest batches are B=50 at the L=64 bucket (synthetic-rich docs all
    # fit 64 tokens); 128 and 512 are the longer buckets; base is D=768.
    shapes = [(50, 64, 256, 30592), (50, 128, 256, 30592), (50, 512, 256, 30592),
              (8, 512, 768, 30592)]
    t0 = time.time()
    rows = phase_kernels(dev, shapes)
    print(f"kernel phase {time.time() - t0:.1f} s", flush=True)

    # 4. the main path: cli.evaluate_beir on synthetic-rich, mini, on the card
    os.makedirs(OUT, exist_ok=True)
    os.environ["METRICS_DIR"] = os.path.join(OUT, "metrics")
    cfg = main_path_config(dev)
    rate = _IngestRate()
    logging.getLogger("opensearch_sparse_model_tuning_sample_torch.eval.beir").addHandler(rate)
    t0 = time.time()
    maxpool_head.launches = 0
    avg = evaluate_beir.main(dict(cfg))
    launches = maxpool_head.launches
    t_main = time.time() - t0
    model_args, data_args, training_args = parse_config(dict(cfg))
    corpus, queries, _ = resolve_dataset("synthetic-rich", data_args.beir_dir)
    n_docs = len(BEIRCorpusDataset(corpus))
    n_batches = -(-n_docs // training_args.per_device_eval_batch_size)
    print(f"main path {t_main:.1f} s: {n_docs} docs, {len(queries)} queries, "
          f"maxpool_head launches {launches} for {n_batches} ingest batches", flush=True)
    check(launches >= n_batches, "the kernel ran for every ingest batch")
    check(0.0 <= avg["NDCG@10"] <= 1.0 and avg["flops"] > 0, "finite metrics")

    # the exact scan against brute force, all queries
    model = se.from_model_args(model_args, seed=training_args.seed, device=dev)
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
    docs = BEIRCorpusDataset(corpus)
    enc_err = encoder_check(model, [docs[i][1] for i in range(256)], data_args.index_l_max, dev)
    print(f"encoder top-{data_args.index_l_max} with the kernel equals the plain head "
          f"for 256 docs (max |err| {enc_err:.3g})", flush=True)
    print(f"ingest {rate.docs_per_s:.1f} docs/s, search {avg['qps']:.1f} q/s, "
          f"NDCG@10 {avg['NDCG@10']:.5f} (random-init weights: not a quality figure); "
          f"card {card}", flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)

    main_row = rows[0]
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
        "shape": main_row["shape"],
        "all_shapes": rows,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
