"""On-card smoke run of the PyTorch port: `python3 chip_smoke.py` on a machine
with one CUDA card (an NVIDIA H100).

It builds every kernel of the ported slices from the sources in this
checkout (one nvcc per source, all at once), holds each kernel against its
plain PyTorch version on the card at the shapes the main path gives it (and
on the main path's own batches; the training forward's argmax also on exact
integer ties), times ablation builds of the head's two forward kernels to
show where their time goes, and drives the main path once through
the entry points a user calls, at the full `mini` width on the
`synthetic-rich` task: `cli.mine` -> `cli.train_ir` (the
`config_infonce_synthetic` recipe, 50 steps from a seeded random init) ->
`cli.evaluate_beir` on the exported `checkpoint-50`, then the serving path:
`cli.serve` (in this process, on a thread) over the evaluation's 20 000-doc
index and a 131 072-doc synthetic index built with the default engine
("auto": the inverted engine with exact escalation at that size), with a
write loop of raw-text `_bulk` requests (the ingest kernel), a 64-client
token burst, text searches (inference-free and full forward) and two-phase
searches, each response held to the same search in process and the burst's
top-10 to the exact scan; then `cli.evaluate_beir` again on the inverted
engine with exact escalation, its metrics held to the scan evaluation's and
its incrementally built postings to one build of the same rows; then
knowledge distillation: the `config_kd_synthetic` recipe through
`cli.train_ir` (two sparse teachers, the infonce run's checkpoint-50 and
checkpoint-25, scored in each step by the ingest kernel), `cli.make_kd_scores`
over 512 mined rows, the `config_l0_synthetic` recipe on its output and
`cli.evaluate_beir` of that, and RoBERTa- and DistilBERT-layout teachers
on the card against the CPU; then the multi-process launch: `cli.train_ir`
under `torchrun` at world size 1 on NCCL (held to the main path's run within
the run-to-run spread of two one-process runs), two `cli.evaluate_beir` ranks
and two `cli.mine` ranks on the one card (no process group: the filesystem
is their barrier; merged by rank 0 and held to the main path's evaluation
and mining), and `cli.prepare_msmarco` on a fixture made from the mined rows
with kd training on its output under `torchrun`; then the device mesh
inside one process (four positions: four cards when four are visible, else
four stripes on the one card): the scan of the 131 072 rows doc- and
query-sharded against the unsharded scan (per-stripe two-phase against
four unsharded stripe indexes), bench.py's 2 097 152-doc corpus on its
inverted configuration with exact escalation in both layouts against the
unsharded exact scan, `eval.beir.evaluate_datasets` of checkpoint-50 over
the mesh (scan and inverted engine) against the main path's evaluation,
and `merge_saved` of the two eval ranks' shards onto the mesh; then
training over the same mesh: the infonce recipe's full-width `mini`
student over the four positions against one position on the global batch
(5 steps), a kd step with checkpoint-50 and checkpoint-25 as teachers, and
a step with gradient accumulation, the mesh step timed against the
one-position step. It checks
what comes out, that every kernel of each path ran (launch counts, read
around each path) and that no plain version did, and that one whole train
step's gradients with the kernels equal those with the plain head. Any
failed check exits non-zero. `python3 chip_smoke.py --mesh-only` runs the
mesh's steps 12a, 12b and 13 alone (for a machine with four cards).
Between the head kernels and the main path it runs ModernBERT-large (step
3b): its fused attention, global and windowed, at the long-document
cell's batch shapes against the plain version, and `eval/beir.py::ingest`
of 16 of that cell's docs through `build_model`'s `modernbert-large`
preset, with its launch and pair counters; `python3 chip_smoke.py
--modernbert-only` runs that step alone. Step 3c times BERT's attention
through the same fused kernel at distil-ingest's batch shapes and the main
path's mini shape against BERT's plain chain and SDPA, and ingests 333
docs through the `distill` preset, every layer launching the kernel, the
full batches replaying the encoder stack's CUDA graphs (bit-equal to the
eager stack, timed against it on the host and on the card at each
length);
`python3 chip_smoke.py --bert-attention-only` runs it alone. Step 3d
times Moonlight-16B-A3B's kernels at its cell's shapes (the grouped
expert GEMMs, the combine, causal attention at q·k 192 and v 128, the
head at D 2 048 and V 163 840), each against its bound, its plain version
and a library call (the GEMMs also against a second launch's bits, with
ptxas's registers and spills for both), and ingests 32 docs through `build_model`'s `moonlight-16b-a3b`
preset with its launch counters; `python3 chip_smoke.py
--moonlight-only` runs it alone. Step 3e does the same for
Kimi-Linear-48B-A3B (KDA's chunked kernels at 32 heads of 128 over up to
32 768 positions, the held-expert share of the grouped GEMMs, causal MLA at
32 heads and 32k positions, the head at D 2 304) and ingests 4 docs of its
cell's lengths through `kimi-linear-48b-a3b-ep2`; `python3 chip_smoke.py
--kimi-linear-only` runs it alone. Every
inference path of the main run (the eval, serving, the kd teachers, the
eval ranks, the mesh eval) launches that kernel once a layer of each
encoder forward and takes no plain chain; training takes the plain chain
and launches none. The
last lines of output are the `serve:`, `inverted eval:`, `distill:`,
`distributed:`, `mesh:` and `mesh train:` lines, the `kernels` JSON line,
the card's name and power limit, and `{"ok": true, "device": {...}}`.

Imports torch and the port only, never jax or the JAX package. Writes under
`output/chip_smoke/` (there too `main_batches.pt`, the head's inputs on the
main path, which `compare_head_kernels.py` times other checkouts on) and
builds the kernels under `build/torch_kernels/` (the ablation copies under
`build/maxpool_ablation/`).
"""

import atexit
import ctypes
import json
import logging
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "output", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 outside
# the tensor cores, and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL = 1e-3  # |kernel - plain| <= TOL * max(1, |plain|): fp32 sums in another order
# a bf16 output (dW, dh) is an fp32 sum rounded once to the nearest bf16: on
# top of TOL, half a bf16 ulp at the kernel's value, at most 2^-8 |kernel|
BF16_HALF_ULP = 2.0 ** -8
TRAIN_STEPS = 50
# one whole train step, kernels against the plain head: per tensor
# |g_kernel - g_plain| <= GRAD_TOL |g_plain| + GRAD_FLOOR G (G the largest
# tensor gradient norm). Both round dh and dw to bf16 at the same place; the
# fp32 sums differ in order, which moves a bf16 rounding here and there, and
# the bf16 encoder backward carries that on. The floor covers gradients that
# are 0 in exact arithmetic (attention key biases) and hold rounding noise.
GRAD_TOL, GRAD_FLOOR = 2e-2, 1e-4
# and among the tensors with |g| > 1e-3 G, the worst relative error at most
GRAD_WORST = 5e-3


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters, warmup=2, sleep=True):
    """Mean device time of fn() over `iters` back-to-back runs, CUDA events.
    The stream first sleeps on the card for longer than the host takes to
    queue the runs (timed on the last warm-up pass), so the events time the
    card running them back to back, not the host's Python between them.
    With sleep=False the events run at the host's pace instead: a kernel
    shorter than its wrapper's Python then reads the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queue_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if sleep:
        torch.cuda._sleep(int(2e9 * (2 * queue_s + 1e-3)))  # cycles at up to 2 GHz
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
    return library_head_logits(h, mask, w, bias).amax(dim=1)


def library_head_logits(h, mask, w, bias):
    B, L, D = h.shape
    logits = torch.mm(h.reshape(B * L, D), w.t(), out_dtype=torch.float32) + bias
    return logits.view(B, L, -1) * mask[:, :, None]


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

    # the ids and mask of one batch of `texts`, at the length the encoder runs it
    [(ids, mask)], _, _ = BatchEncoder(model, max_length=512)._pack(texts, len(texts))
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
# in `chunk_products` (both kernels') and `produce`; in this order, as the
# last release's text lies inside the one before it
_H = [
    ("0);\n    mbar_wait(full + s * 8, ph);\n", "0);\n"),
    ("      if (lane == 0) mbar_arrive(empty + prev * 8);\n", ""),
    ("  if (lane == 0) mbar_arrive(empty + prev * 8);\n", ""),
    ("  for (int b = p; b < B; b += kConsumerWGs) {", "  for (int b = p; b < 0; b += kConsumerWGs) {"),
]
# the training forward's chunk epilogue (bias, mask, chunk max, position
# search, running max and index) cut to one max per row
_ARGMAX_EPILOGUE = (
    "  // training epilogue: register 4j + 2hh + e is row warp*16 + g + 8hh of",
    "#pragma unroll\n  for (int mt = 0; mt < MT; ++mt) {\n"
    "    run[mt][0] = fmaxf(run[mt][0], acc[mt][0]);\n"
    "    run[mt][1] = fmaxf(run[mt][1], acc[mt][2]);\n  }\n  return;\n"
    "  // training epilogue: register 4j + 2hh + e is row warp*16 + g + 8hh of",
)
# the ingest kernel held to a 128-row vocab tile, as the training forward
# was when it was a flag on the ingest kernel
_MT2 = ("constexpr int kIngestMaxMT = 4;", "constexpr int kIngestMaxMT = 2;")
# name: (entry point, edits); "ingest" is maxpool_head_bf16, "argmax" the
# training forward maxpool_head_argmax_bf16
ABLATIONS = {
    "kernel": ("ingest", []),
    "no_epilogue": ("ingest", [_EPILOGUE]),
    "no_h": ("ingest", _H),
    "mma_only": ("ingest", [_EPILOGUE] + _H),
    "ingest_mt2": ("ingest", [_MT2]),
    "argmax": ("argmax", []),
    "argmax_no_epilogue": ("argmax", [_ARGMAX_EPILOGUE]),
    "argmax_no_turns": ("argmax", [("const bool take_turns = stages >= kblocks;",
                                    "const bool take_turns = false;")]),
    "argmax_turns_always": ("argmax", [("const bool take_turns = stages >= kblocks;",
                                        "const bool take_turns = true;")]),
    "argmax_no_search": ("argmax", [(
        "        if (acc[mt][4 * (i >> 1) + 2 * hh + (i & 1)] == cm) p = 8 * (i >> 1) + (i & 1);\n",
        "")]),
}
INGEST_ABLATIONS = ("kernel", "no_epilogue", "no_h", "mma_only")
ARGMAX_ABLATIONS = ("kernel", "ingest_mt2", "argmax", "argmax_no_epilogue", "argmax_no_turns",
                    "argmax_turns_always", "argmax_no_search")


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
    sources = {name: _ablation_source(edits) for name, (_, edits) in ABLATIONS.items()}
    first = {}  # one build per distinct source ("kernel" and "argmax" share one)
    for name, src in sources.items():
        first.setdefault(src, name)
    procs = {}
    for src, name in first.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.maxpool_head_bf16.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.maxpool_head_bf16.restype = i
        lib.maxpool_head_argmax_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.maxpool_head_argmax_bf16.restype = i
        built[name] = lib
    return {name: built[first[src]] for name, src in sources.items()}


def ablation_times(libs, names, h, mask, w, bias):
    """Best of two passes (order A B C C B A) of each named copy on these
    inputs, ms."""
    B, L, D = h.shape
    V = w.shape[0]
    out = torch.empty(B, V, device=h.device)
    idx = torch.empty(B, V, dtype=torch.int32, device=h.device)

    def launch(name):
        lib, stream = libs[name], torch.cuda.current_stream().cuda_stream
        if ABLATIONS[name][0] == "argmax":
            rc = lib.maxpool_head_argmax_bf16(h.data_ptr(), mask.data_ptr(), w.data_ptr(),
                                              bias.data_ptr(), out.data_ptr(), idx.data_ptr(),
                                              B, L, D, V, stream)
        else:
            rc = lib.maxpool_head_bf16(h.data_ptr(), mask.data_ptr(), w.data_ptr(),
                                       bias.data_ptr(), out.data_ptr(), B, L, D, V, stream)
        check(rc == 0, f"ablation launch of {name}: CUDA error {rc}")

    best = {}
    for name in list(names) + list(names)[::-1]:
        ms = cuda_ms(lambda: launch(name), iters=20)
        best[name] = min(best.get(name, ms), ms)
    torch.cuda.synchronize()
    print(f"ablation B={B} L={L} D={D} V={V}: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in best.items()), flush=True)
    return best


def phase_ablation(dev, libs, shapes, names):
    """Where the head kernels' time goes: each kernel as built and copies
    with a part taken out or changed, each with the port's nvcc flags, timed
    at `shapes`. The copies compute wrong results on purpose; only their
    times mean anything:
      no_epilogue  the ingest kernel's per-chunk epilogue (bias, mask,
                   running max) cut to one max per row: what it costs;
      no_h         no h box loaded or waited for (the products read a stale
                   ring): what streaming h through the rings costs;
      mma_only     both: the wgmma issue and the w tile load alone;
      ingest_mt2   the ingest kernel at a 128-row vocab tile: against
                   `kernel`, what the smaller tile costs;
      argmax       the training forward as built: against `kernel`, what
                   the argmax costs;
      argmax_no_epilogue  its chunk epilogue cut to one max per row;
      argmax_no_turns     its warpgroups issue without taking turns;
      argmax_turns_always  turns also where a ring holds less than a
                   chunk (at D = 768: against `argmax`, why they are off);
      argmax_no_search    its epilogue without the position search."""
    times = {}
    for i, (B, L, D, V) in enumerate(shapes):
        h, mask, w, bias = maxpool_inputs(B, L, D, V, seed=i, dev=dev)
        times[f"{B}x{L}x{D}x{V}"] = ablation_times(libs, names, h, mask, w, bias)
        del h, mask, w, bias
    return times


def holey_inputs(B, L, D, V, seed, dev):
    """maxpool_inputs (lengths in [L/2, L], the last row all masked) with
    left padding in row 0 and every fifth position masked in row 1."""
    h, mask, w, bias = maxpool_inputs(B, L, D, V, seed, dev)
    mask[0, : L // 3] = 0
    mask[1, ::5] = 0
    return h, mask, w, bias


def library_scatter(g, idx, mask, L):
    """The dense [B, L, V] bf16 gradient of the masked logits: one scatter."""
    B, V = g.shape
    coef = (g * mask.gather(1, idx.long()).float()).to(torch.bfloat16)
    return torch.zeros(B, L, V, dtype=torch.bfloat16, device=g.device).scatter_(
        1, idx.long()[:, None, :], coef[:, None, :])


def library_bwd_w(g, idx, mask, h):
    """dw (bf16, as the kernel writes it), dbias from PyTorch's own calls:
    the scatter, one bf16 GEMM with fp32 output, its bf16 cast and a sum. A
    yardstick only."""
    B, L, D = h.shape
    s = library_scatter(g, idx, mask, L).view(B * L, -1)
    dw = torch.mm(s.t(), h.reshape(B * L, D), out_dtype=torch.float32).to(torch.bfloat16)
    return dw, s.sum(0, dtype=torch.float32)


def library_bwd_h(g, idx, mask, w):
    """dh (bf16) from PyTorch's own calls: the scatter, one bf16 GEMM with
    fp32 output and its bf16 cast."""
    B, L = mask.shape
    s = library_scatter(g, idx, mask, L).view(B * L, -1)
    return torch.mm(s, w, out_dtype=torch.float32).view(B, L, -1).to(torch.bfloat16)


def library_head_argmax(h, mask, w, bias):
    return library_head_logits(h, mask, w, bias).max(dim=1)


def value_at(h, mask, w, bias, idx):
    """mask * (h[b, idx[b, v]] . w[v] + bias[v]): the logit the argmax names."""
    out = torch.empty(idx.shape, device=h.device)
    wf = w.float()
    for b in range(h.shape[0]):
        li = idx[b].long()
        out[b] = ((h[b].float()[li] * wf).sum(1) + bias) * mask[b].float()[li]
    return out


def _close(got, ref, what, tol=TOL):
    err = (got - ref).abs()
    check(bool((err <= tol * ref.abs().clamp_min(1.0)).all()),
          f"{what}: max |err| {float(err.max())}")
    return float(err.max())


def _close_bf16(got, ref, what):
    """A bf16 output against an fp32 one: TOL for the sum's order plus half
    a bf16 ulp at the output's value. TOL's floor is the output's largest
    magnitude where that is under 1, so small gradients (the main-path
    batch's are ~1e-2) are held at their own scale and not at 1e-3."""
    got = got.float()
    err = (got - ref).abs()
    floor = min(1.0, float(ref.abs().max()))
    check(bool((err <= TOL * ref.abs().clamp_min(floor) + BF16_HALF_ULP * got.abs()).all()),
          f"{what}: max |err| {float(err.max())}")
    return float(err.max())


def check_buckets(g, idx, mask, what):
    """bwd_h's counting sort on the card equals the plain one exactly;
    returns nnz."""
    from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp

    off, v, coef = mp.maxpool_head_bwd_buckets(g, idx, mask)
    roff, rv, rcoef = mp.bucket_by_argmax_reference(g, idx, mask)
    nnz = int(roff[-1])
    check(torch.equal(off, roff) and torch.equal(v[:nnz], rv)
          and torch.equal(coef[:nnz].view(torch.int32), rcoef.view(torch.int32)),
          f"bwd_h's buckets equal the plain bucketing bit for bit at {what}")
    return nnz


def _bound(flops, peak_flops, nbytes):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def train_kernel_rows(name, h, mask, w, bias, g):
    """The three training kernels on these inputs against their plain
    versions, two launches of each bit-equal, and their times beside the
    plain version's, the library calls' and the bound. g is the upstream
    gradient of the pooled logits.

    Bounds: argmax forward, 2 * unmasked * D * V bf16 operations at 989
    TFLOP/s against h + mask + w + bias + out (fp32) + idx (int32) bytes at
    3.35 TB/s. bwd_w: 2 * nnz * D fp32 FMA operations at 67 TFLOP/s, nnz the
    (b, v) with coef = g * mask[b, idx] != 0, against the bytes it must
    move: g + idx + mask read whole, the h rows of the (b, l) that some
    nonzero coef names, dw (bf16, every row) + dbias written. bwd_h: the same
    operations against g + idx + mask, the w rows of the v that carry a
    nonzero coef in some doc, and dh (bf16). bwd_h's time covers both its
    parts (the counting sort and the reduce); bucket_ms is the counting sort
    alone."""
    from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp

    B, L, D = h.shape
    V = w.shape[0]
    pooled, idx = mp.maxpool_head_argmax(h, mask, w, bias)
    dw, dbias = mp.maxpool_head_bwd_w(g, idx, mask, h)
    dh = mp.maxpool_head_bwd_h(g, idx, mask, w)
    torch.cuda.synchronize()
    check(dw.dtype == dh.dtype == torch.bfloat16 and dbias.dtype == torch.float32,
          "the backward kernels write dw and dh in bf16, dbias in fp32")
    err_f = _close(pooled, mp.maxpool_head_reference(h, mask, w, bias), f"argmax forward at {name}")
    check(torch.equal(pooled, mp.maxpool_head(h, mask, w, bias)),
          f"the training forward's out is the ingest kernel's bit for bit at {name}")
    check(bool(((idx >= 0) & (idx < L)).all()), f"argmax positions in range at {name}")
    # near-ties may pick another position than the plain argmax: compare values
    _close(value_at(h, mask, w, bias, idx), pooled, f"logit at the kernel's argmax at {name}")
    rdw, rdbias = mp.maxpool_head_bwd_w_reference(g, idx, mask, h)
    err_w = max(_close_bf16(dw, rdw, f"bwd_w dw at {name}"),
                _close(dbias, rdbias, f"bwd_w dbias at {name}"))
    rdh = mp.maxpool_head_bwd_h_reference(g, idx, mask, w)
    err_h = _close_bf16(dh, rdh, f"bwd_h at {name}")
    nnz = check_buckets(g, idx, mask, name)
    dead = ~mask.bool().any(dim=1)
    check(bool((pooled[dead] == 0).all()) and bool((dh[mask == 0] == 0).all()),
          f"masked positions pool to 0 and get no gradient at {name}")
    check(torch.equal(mp.maxpool_head_argmax(h, mask, w, bias)[1], idx)
          and torch.equal(mp.maxpool_head_bwd_w(g, idx, mask, h)[0], dw)
          and torch.equal(mp.maxpool_head_bwd_h(g, idx, mask, w), dh),
          f"two launches of each training kernel agree bit for bit at {name}")
    del rdw, rdbias, rdh
    # the yardsticks round g * mask to bf16, and the true gradients cancel
    # much (a softmax's rows sum to 0), so they are held to the plain
    # version fed the same bf16-rounded g
    g16 = g.to(torch.bfloat16).float()
    _close_bf16(library_bwd_w(g, idx, mask, h)[0],
                mp.maxpool_head_bwd_w_reference(g16, idx, mask, h)[0],
                "the library yardstick computes the same dw")
    _close_bf16(library_bwd_h(g, idx, mask, w), mp.maxpool_head_bwd_h_reference(g16, idx, mask, w),
                "the library yardstick computes the same dh")
    torch.cuda.empty_cache()

    unmasked = float(mask.sum())
    nz = (g * mask.gather(1, idx.long())) != 0
    rows_v = int(nz.any(dim=0).sum())  # w rows that bwd_h must read
    rows_bl = int((torch.zeros(B, L, dtype=torch.int32, device=g.device)
                   .scatter_add_(1, idx.long(), nz.int()) > 0).sum())  # h rows for bwd_w
    fwd_bound = _bound(2.0 * unmasked * D * V, PEAK_BF16_FLOPS,
                       B * L * D * 2 + B * L * 4 + V * D * 2 + V * 4 + B * V * 8)
    w_bound = _bound(2.0 * nnz * D, PEAK_FP32_FLOPS,
                     B * V * 8 + B * L * 4 + rows_bl * D * 2 + V * D * 2 + V * 4)
    h_bound = _bound(2.0 * nnz * D, PEAK_FP32_FLOPS,
                     B * V * 8 + B * L * 4 + rows_v * D * 2 + B * L * D * 2)
    rows = {
        "maxpool_head_argmax": dict(
            max_abs_err=err_f, ms=cuda_ms(lambda: mp.maxpool_head_argmax(h, mask, w, bias), 20),
            plain_ms=cuda_ms(lambda: mp.maxpool_head_argmax_reference(h, mask, w, bias), 3),
            library_ms=cuda_ms(lambda: library_head_argmax(h, mask, w, bias), 5),
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1]),
        "maxpool_head_bwd_w": dict(
            max_abs_err=err_w, ms=cuda_ms(lambda: mp.maxpool_head_bwd_w(g, idx, mask, h), 20),
            plain_ms=cuda_ms(lambda: mp.maxpool_head_bwd_w_reference(g, idx, mask, h), 3),
            library_ms=cuda_ms(lambda: library_bwd_w(g, idx, mask, h), 5),
            bound_ms=w_bound[0], bound_by=w_bound[1]),
        "maxpool_head_bwd_h": dict(
            max_abs_err=err_h, ms=cuda_ms(lambda: mp.maxpool_head_bwd_h(g, idx, mask, w), 20),
            bucket_ms=cuda_ms(lambda: mp.maxpool_head_bwd_buckets(g, idx, mask), 20),
            plain_ms=cuda_ms(lambda: mp.maxpool_head_bwd_h_reference(g, idx, mask, w), 3),
            library_ms=cuda_ms(lambda: library_bwd_h(g, idx, mask, w), 5),
            bound_ms=h_bound[0], bound_by=h_bound[1]),
    }
    for k, r in rows.items():
        r.update(shape=[B, L, D, V], share_of_bound=r["bound_ms"] / r["ms"], inputs=name, nnz=nnz,
                 w_rows_read=rows_v, h_rows_read=rows_bl)
        extra = (f", of which the counting sort {r['bucket_ms']:.4f} ms" if "bucket_ms" in r
                 else "")
        print(f"{k} {name} B={B} L={L} D={D} V={V}: max|err| {r['max_abs_err']:.3g}, kernel "
              f"{r['ms']:.4f} ms{extra}, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share "
              f"of bound {r['share_of_bound']:.3f}; nonzero (b, v) gradients {nnz} of "
              f"{B * V}, in {rows_v} of {V} w rows and {rows_bl} of {B * L} h rows; "
              "two launches bit-equal", flush=True)
    return rows


def skewed_inputs(B, L, D, V, seed, dev):
    """maxpool_inputs where one position of each doc wins every v: w and
    bias >= 0, and h is 0 except at that position (b mod L/2, always unmasked), where
    it is > 0. bwd_h's worst case: one list per doc holds all its
    nonzero gradients."""
    h, mask, w, bias = maxpool_inputs(B, L, D, V, seed, dev)
    w, bias = w.abs(), bias.abs()  # so the hot logit beats a masked position's 0 too
    win = torch.arange(B, device=dev) % (L // 2)
    hot = h[torch.arange(B, device=dev), win].abs()
    h = torch.zeros_like(h)
    h[torch.arange(B, device=dev), win] = hot
    return h, mask, w, bias


def phase_train_kernels(dev, shapes):
    """Synthetic inputs at the training shapes: holey masks, an all-masked
    row, an upstream gradient with about half its entries 0 (as relu
    leaves it); then the first shape again with skewed inputs (one position
    of each doc wins every v)."""
    out = []
    cases = [(s, holey_inputs, "synthetic") for s in shapes] + [(shapes[0], skewed_inputs, "skewed")]
    for i, ((B, L, D, V), make, name) in enumerate(cases):
        h, mask, w, bias = make(B, L, D, V, seed=100 + i, dev=dev)
        gen = torch.Generator(device=dev).manual_seed(i)
        g = torch.randn(B, V, device=dev, generator=gen)
        g = g * (torch.rand(B, V, device=dev, generator=gen) < 0.5)
        out.append(train_kernel_rows(name, h, mask, w, bias, g))
        del h, mask, w, bias, g
        torch.cuda.empty_cache()
    return out


def tie_inputs(case, B, L, D, V, seed, dev):
    """h, w in {-1, 0, 1} and an integer bias: every logit is a small
    integer, exact in fp32 in any order, so ties are everywhere and the
    plain argmax is the exact answer. holey: holey_inputs' mask; chunk_tie:
    equal rows at positions 3 and 70 above the rest; quad_tie: equal rows
    at 2, 5 and 33, held by three lanes of a quad; negative: every logit
    < 0, so a masked position's 0 wins (row 0 a hole at 5, row 1 padded from
    40, row 2 all masked)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-1, 2, size=(B, L, D))
    w = rng.integers(-1, 2, size=(V, D))
    bias = rng.integers(-2, 3, size=V)
    mask = torch.ones(B, L, dtype=torch.int32)
    if case == "holey":
        mask = holey_inputs(B, L, 8, 8, seed, "cpu")[1]
    elif case == "chunk_tie":
        h[:, 3] = h[:, 70] = 32 * rng.integers(-1, 2, size=(B, D))
    elif case == "quad_tie":
        h[:, 2] = h[:, 5] = h[:, 33] = 32 * rng.integers(-1, 2, size=(B, D))
    elif case == "negative":
        h, w = np.abs(h), np.abs(w)
        bias = -(D + 1) - np.abs(bias)
        mask[0, 5] = 0
        mask[1, 40:] = 0
        mask[2] = 0
    return (torch.from_numpy(h).to(dev, torch.bfloat16), mask.to(dev),
            torch.from_numpy(w).to(dev, torch.bfloat16),
            torch.from_numpy(bias).to(dev, torch.float32))


# (case, B, L, D, V): the train step's shape; L = 100 (not a multiple of 64)
# with the unpadded vocab (a partial last tile); L = 512 (eight chunks); the
# two built ties; masked zeros over negative logits; D = 768
TIE_CASES = [("random", 45, 64, 256, 30592), ("random", 45, 100, 256, 30522),
             ("holey", 45, 512, 256, 30592), ("chunk_tie", 45, 128, 256, 30592),
             ("quad_tie", 45, 64, 256, 30592), ("negative", 8, 100, 256, 30522),
             ("random", 8, 512, 768, 30592)]


def phase_argmax_ties(dev):
    """The training forward on exact integer logits: idx equals the plain
    argmax exactly, out equals the plain version and the ingest kernel bit
    for bit, and two launches agree bit for bit."""
    from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp

    for i, (case, B, L, D, V) in enumerate(TIE_CASES):
        h, mask, w, bias = tie_inputs(case, B, L, D, V, seed=200 + i, dev=dev)
        pooled, idx = mp.maxpool_head_argmax(h, mask, w, bias)
        want, want_idx = mp.maxpool_head_argmax_reference(h, mask, w, bias)
        what = f"{case} [{B}, {L}, {D}, {V}]"
        check(torch.equal(idx, want_idx), f"training forward idx equals the plain argmax at {what}")
        check(torch.equal(pooled, want) and torch.equal(pooled, mp.maxpool_head(h, mask, w, bias)),
              f"training forward out equals the plain version and the ingest kernel at {what}")
        again = mp.maxpool_head_argmax(h, mask, w, bias)
        check(torch.equal(again[0], pooled) and torch.equal(again[1], idx),
              f"two launches of the training forward agree bit for bit at {what}")
        if case == "chunk_tie":
            check(int((idx == 3).sum()) > B * V // 4 and not bool((idx == 70).any()),
                  "the earlier chunk keeps a tie")
        if case == "quad_tie":
            check(int((idx == 2).sum()) > B * V // 4 and not bool(((idx == 5) | (idx == 33)).any()),
                  "the quad keeps the smallest tied position")
        if case == "negative":
            check(bool((idx[0] == 5).all() and (idx[1] == 40).all() and (idx[2] == 0).all())
                  and not bool(pooled[:3].any()), "a masked position's 0 beats negative logits")
        del h, mask, w, bias, pooled, idx, want, want_idx, again
    torch.cuda.empty_cache()
    print(f"training forward on {len(TIE_CASES)} exact-tie cases ("
          + ", ".join(f"{c} [{B}, {L}, {D}, {V}]" for c, B, L, D, V in TIE_CASES)
          + "): idx equals the plain argmax, out the plain version's and the ingest kernel's, "
          "two launches bit-equal", flush=True)


def smoke_recipe(dev, name="config_infonce_synthetic", **over):
    """configs/<name>.yaml as the smoke run uses it, written under
    output/chip_smoke/ with the overrides `over` (a dict updates the
    recipe's dict of that name). For the infonce recipe the
    smoke run's only change is the short warm-up (10 of 50 steps, where the
    recipe warms up over 200 of 2000); the rest is the run's length
    (max_steps 50, save_steps 25: checkpoint-25 and checkpoint-50, the
    distillation phase's two teachers), where it writes, and the card."""
    import yaml

    with open(os.path.join(HERE, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(idf_path=os.path.join(HERE, cfg["idf_path"]), device=str(dev))
    if name == "config_infonce_synthetic":
        cfg.update(max_steps=TRAIN_STEPS, warmup_steps=10, save_steps=TRAIN_STEPS // 2,
                   output_dir=os.path.join(OUT, "infonce_synthetic"))
    for k, v in over.items():
        if isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    path = os.path.join(OUT, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


class StepClock:
    """Host clock over train steps (first, last], synchronized at both ends,
    with the checkpoint saves inside the window taken out: patches
    Trainer.train_step and Trainer.save_checkpoint while it is entered."""

    def __init__(self, first, last):
        from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

        self.cls, self.first, self.last = Trainer, first, last
        self.start = self.end = None
        self.saving_s = 0.0

    def __enter__(self):
        step_fn, save_fn = self.orig = (self.cls.train_step, self.cls.save_checkpoint)
        clock = self

        def train_step(trainer, batch):
            if trainer.step == clock.first:
                torch.cuda.synchronize()
                clock.start = time.perf_counter()
            metrics = step_fn(trainer, batch)
            if trainer.step == clock.last:
                torch.cuda.synchronize()
                clock.end = time.perf_counter()
            return metrics

        def save_checkpoint(trainer, step):
            t0 = time.perf_counter()
            save_fn(trainer, step)
            if clock.start is not None and clock.end is None:
                clock.saving_s += time.perf_counter() - t0

        self.cls.train_step, self.cls.save_checkpoint = train_step, save_checkpoint
        return self

    def __exit__(self, *exc):
        self.cls.train_step, self.cls.save_checkpoint = self.orig

    def seconds(self):
        return self.end - self.start - self.saving_s


def reset_counters():
    from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
    from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp

    mp.reset_launch_counts()
    tbert.reset_attention_counts()


def read_counters():
    from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp

    c = mp.launch_counts()
    return c["kernels"], c["plains"]


def read_attention():
    """BERT's attention layer calls since reset_counters(): the fused
    kernel's launches and the plain chains (models/bert.py)."""
    from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert

    return tbert.attention_counts()


def ckpt_layers(ckpt):
    """The encoder layers of an exported checkpoint (its config.json)."""
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = json.load(f)
    return cfg.get("num_hidden_layers", cfg.get("n_layers"))


def check_attention(attn, layers, forwards, what):
    """Inference on the card: every layer of each of `forwards` encoder
    forwards (one maxpool_head launch each) launches the fused attention
    kernel once, and none takes BERT's plain chain."""
    want = {"attention_global_kernel": layers * forwards, "plain_chain": 0}
    check(attn == want, f"{what}: BERT attention {attn}, {want} expected")


class _IngestRate(logging.Handler):
    """Picks the docs/s out of eval.beir.ingest's log record."""

    def __init__(self):
        super().__init__()
        self.docs_per_s = None

    def emit(self, record):
        if record.msg.startswith("ingested %d docs"):
            self.docs_per_s = record.args[3]


def model_config(dev):
    """The random-init mini encoder the ingest-kernel phase reads its batch
    from (the first 50 synthetic-rich docs at the eval shapes)."""
    return {
        "arch": "mini",
        "idf_path": os.path.join(HERE, "assets", "idf.npz"),
        "inf_free": True,
        "beir_datasets": "synthetic-rich",
        "eval_max_seq_length": 512,
        "per_device_eval_batch_size": 50,
        "output_dir": os.path.join(OUT, "random_init"),
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
    enc_idx, enc_w = enc.resolve_chunk_sparse(*enc.encode_chunk_sparse_async(
        texts, l_max=l_max, rows=len(texts)))
    # the one batch the chunk ran, its rows in length order (text r is row
    # pos[r]): the encoder's rows are put in that order too
    [(ids, mask)], pos, _ = enc._pack(texts, len(texts))
    order = np.argsort(pos)
    enc_idx, enc_w = enc_idx[order], enc_w[order]
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


def phase_train_path(dev):
    """The main path through its entry points: cli.mine -> cli.train_ir ->
    cli.evaluate_beir on the exported checkpoint. The kernel and plain
    counters are set to 0 just before each part and read just after."""
    from opensearch_sparse_model_tuning_sample_torch.cli import evaluate_beir, mine, train_ir

    path, cfg = smoke_recipe(dev)
    out = {"cfg": cfg, "path": path}
    cwd = os.getcwd()
    os.chdir(OUT)  # cli.mine saves data/<name>_train under the working dir; train_file reads it
    try:
        t0 = time.time()
        reset_counters()
        rows = mine.main(path)
        out["mine"] = read_counters()
        out["mine_s"] = time.time() - t0
        check(len(rows) > 0 and os.path.isdir(cfg["train_file"]), "cli.mine saved training rows")
        print(f"cli.mine: {len(rows)} rows in {out['mine_s']:.1f} s; counters {out['mine']}",
              flush=True)

        t0 = time.time()
        with StepClock(10, TRAIN_STEPS) as clock:
            reset_counters()
            trainer = train_ir.main(path)
            out["train"] = read_counters()
            out["train_attention"] = read_attention()
        out["train_s"] = time.time() - t0

        t0 = time.time()
        reset_counters()
        out["avg"] = evaluate_beir.main(path)
        out["eval"] = read_counters()
        out["eval_attention"] = read_attention()
        out["eval_s"] = time.time() - t0
    finally:
        os.chdir(cwd)

    steps = trainer.step
    launches, plain = out["train"]
    print(f"cli.train_ir: {steps} steps in {out['train_s']:.1f} s; counters {out['train']}",
          flush=True)
    check(steps == TRAIN_STEPS, "the trainer took every step")
    for k in ("maxpool_head_argmax", "maxpool_head_bwd_w", "maxpool_head_bwd_h"):
        check(launches[k] == steps, f"{k} launched once per train step ({launches[k]})")
    for part in ("mine", "train", "eval"):
        check(not any(out[part][1].values()), f"no plain version ran in cli.{part}: {out[part][1]}")
    # training (dropout, autograd) takes BERT's plain attention chain, the
    # eval's ingest the fused kernel
    layers = trainer.model.cfg.num_hidden_layers
    attn = out["train_attention"]
    check(attn["attention_global_kernel"] == 0 and attn["plain_chain"] >= layers * steps,
          f"cli.train_ir: no attention kernel launch, the plain chain in every layer: {attn}")
    check_attention(out["eval_attention"], layers, out["eval"][0]["maxpool_head"],
                    "cli.evaluate_beir")
    hist = trainer.log_history
    for h in hist:
        check(all(np.isfinite(v) for v in h.values()), f"finite metrics at step {h['step']}")
    check(hist[0]["step"] == 1 and hist[-1]["step"] == steps, "logged at step 1 and the last")
    check(hist[-1]["ranking_loss"] < hist[0]["ranking_loss"],
          f"the ranking loss fell: {hist[0]['ranking_loss']:.5f} -> {hist[-1]['ranking_loss']:.5f}")
    ckpt = os.path.join(cfg["output_dir"], f"checkpoint-{steps}")
    for c in (ckpt, os.path.join(cfg["output_dir"], f"checkpoint-{steps // 2}")):
        for f in ("model.safetensors", "config.json", "vocab.txt"):
            check(os.path.exists(os.path.join(c, f)), f"checkpoint file {c}/{f}")
    check(os.path.exists(os.path.join(cfg["output_dir"], "train_state", "state.pt")),
          "the train state is saved")
    print("launches per train step: " + ", ".join(
        f"{k} {launches[k] / steps:g}" for k in ("maxpool_head_argmax", "maxpool_head_bwd_w",
                                                 "maxpool_head_bwd_h")), flush=True)
    docs = (TRAIN_STEPS - 10) * cfg["per_device_train_batch_size"] * (1 + cfg["sample_num_one_query"])
    out["docs_per_s"] = docs / clock.seconds()
    print(f"train: ranking loss {hist[0]['ranking_loss']:.5f} (step 1) -> "
          f"{hist[-1]['ranking_loss']:.5f} (step {steps}); {out['docs_per_s']:.1f} docs/s over "
          f"steps 10..{steps} ({docs} docs, host clock, synchronized); checkpoint {ckpt}",
          flush=True)
    out["trainer"], out["steps"], out["ckpt"] = trainer, steps, ckpt
    return out


def first_batch(trainer):
    """The trainer's first batch size of rows of its train file, through
    the collator its run used (with the run's teacher ensemble, if any)."""
    from opensearch_sparse_model_tuning_sample_torch.data.collator import build_collator
    from opensearch_sparse_model_tuning_sample_torch.data.datasets import load_dataset

    da = trainer.data_args
    ds = load_dataset(os.path.join(OUT, da.train_file), da.data_type,
                      sample_num_one_query=da.sample_num_one_query,
                      score_scale=da.score_scale)
    collator = build_collator(da.data_type, trainer.model.tokenizer, da.max_seq_length,
                              seq_buckets=da.seq_buckets,
                              teacher_tokenizer_ids=da.kd_ensemble_teacher_kwargs.get(
                                  "teacher_tokenizer_ids", []),
                              teacher_ensemble=trainer.teacher_ensemble)
    return collator([ds[i] for i in range(trainer.args.per_device_train_batch_size)])


def grad_check(trainer, dev):
    """One whole train step's gradients (the step's loss, dropout off, the
    trained parameters, the first batch of rows of the run's train file;
    with a teacher ensemble, its scores in the loss) with the kernels
    against the same step with the plain head: torch autograd of
    maxpool_head_reference. Also captures the head's inputs and upstream
    gradient on this main-path batch for the kernel rows."""
    from opensearch_sparse_model_tuning_sample_torch.core.mesh import batch_to
    from opensearch_sparse_model_tuning_sample_torch.models import bert as bert_mod
    from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp
    from opensearch_sparse_model_tuning_sample_torch.train.trainer import train_loss

    model, ma, da = trainer.model, trainer.model_args, trainer.data_args
    np_batch = first_batch(trainer)
    batch = batch_to(np_batch, trainer.device)

    captured = {}
    kernel_head = bert_mod.maxpool_head_train

    def capture(h, mask, w, bias):
        pooled = kernel_head(h, mask, w, bias)
        captured["args"] = (h.detach(), mask, w.detach(), bias.detach())
        pooled.register_hook(lambda g: captured.__setitem__("g", g.detach().float().contiguous()))
        return pooled

    def plain_head(h, mask, w, bias):
        return mp.maxpool_head_reference(h, mask, w, bias)

    grads, losses = {}, {}
    for name, head in (("kernels", capture), ("plain", plain_head)):
        bert_mod.maxpool_head_train = head
        try:
            model.zero_grad(set_to_none=True)
            loss, _ = train_loss(model, batch, trainer.step, trainer.loss_specs, ma, da,
                                 teacher_ensemble=trainer.teacher_ensemble)
            loss.backward()
        finally:
            bert_mod.maxpool_head_train = kernel_head
        losses[name] = loss.item()
        grads[name] = {k: p.grad.float().clone() for k, p in model.named_parameters()
                       if p.grad is not None}
    model.zero_grad(set_to_none=True)
    check(abs(losses["kernels"] - losses["plain"]) <= 1e-4 * abs(losses["plain"]),
          f"train-step loss, kernels {losses['kernels']} vs plain head {losses['plain']}")
    check(grads["kernels"].keys() == grads["plain"].keys(), "the same parameters get gradients")
    big = max(float(g.norm()) for g in grads["plain"].values())
    rel = {}
    for k, gp in grads["plain"].items():
        err = float((grads["kernels"][k] - gp).norm())
        check(err <= GRAD_TOL * float(gp.norm()) + GRAD_FLOOR * big,
              f"train-step gradient of {k}: |kernels - plain| {err:.3g}, |plain| {float(gp.norm()):.3g}")
        rel[k] = (err / max(float(gp.norm()), 1e-30), float(gp.norm()))
    top = sorted(rel.items(), key=lambda kv: -kv[1][0])[:4]
    above = max(r for r, n in rel.values() if n > 1e-3 * big)
    print(f"full-step gradient check: {len(rel)} tensors, loss {losses['kernels']:.6f} (kernels) "
          f"vs {losses['plain']:.6f} (plain head); worst relative errors "
          + ", ".join(f"{k} {r:.3g} (|g| {n:.3g})" for k, (r, n) in top)
          + f"; worst among tensors with |g| > 1e-3 G: {above:.3g} (tolerance {GRAD_TOL} + "
          f"{GRAD_FLOOR} G, G = {big:.3g})", flush=True)
    check(above <= GRAD_WORST, f"worst relative train-step gradient error {above:.3g} <= {GRAD_WORST}")

    # what in a (non-logging) train step makes the host wait for the card:
    # one more step of the loop's own train_step under CUDA's sync check
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.train_step(np_batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0][:120] for w in caught
             if str(w.message).startswith("called a synchronizing")]
    print(f"host syncs in one train step (CUDA's sync check, which its own notice calls a "
          f"prototype that may miss some): {len(syncs)} {sorted(set(syncs))}", flush=True)
    check(not syncs, "no host sync in a non-logging train step")
    return captured, above, np_batch


# the teacher ensemble's calls in a train step: its reps of the queries and
# of the docs (`reps` twice), then the scores: three ranges a step
TEACHER_STAGES = ("reps", "scores_from_reps")
TEACHER_RANGES = 3


def profile_steps(trainer, np_batch, step_ms, n=5):
    """Where a train step's time goes: `n` more steps of the loop's own
    train_step under torch.profiler. Prints the device operations' time by
    name (user annotations, which span other operations, left out), their
    count per step, the card's busy share of `step_ms`, the step time
    measured without the profiler (whose own host overhead inflates the
    wall time it sees), and the head's kernels' device time a step, by
    kernel (the forward; bwd_w; bwd_h's count, scan, scatter and reduce).
    With a teacher ensemble, its reps and scores run inside
    `kd_teacher_scores` ranges, whose host time and the device time of the
    operations they launched are read apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    ens = trainer.teacher_ensemble
    if ens is not None:  # the teachers' reps of a step's two sides and their scores
        for name in TEACHER_STAGES:
            def annotated(*args, _fn=getattr(ens, name), **kwargs):
                with record_function("kd_teacher_scores"):
                    return _fn(*args, **kwargs)

            setattr(ens, name, annotated)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                trainer.train_step(np_batch)
            torch.cuda.synchronize()
    finally:
        if ens is not None:
            for name in TEACHER_STAGES:
                delattr(ens, name)  # back to the class's methods
    wall_us = (time.perf_counter() - t0) * 1e6
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in on_card)
    launches = sum(e.count for e in on_card)
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:12]
    busy_ms = busy_us / n / 1e3
    print(f"profile of {n} train steps: the card busy {busy_ms:.3f} ms a step, "
          f"{busy_ms / step_ms:.3f} of the {step_ms:.2f} ms step measured without the profiler "
          f"({wall_us / n / 1e3:.2f} ms under it); {launches / n:.0f} device operations a step; "
          "by device time: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / n / 1e3:.4f} ms x{e.count // n}"
                      for e in top), flush=True)
    head = {}
    for e in on_card:
        found = re.search(r"maxpool_head(?:_argmax)?_kernel<[^>]*>|bwd_\w+|bucket_\w+", e.key)
        if found:
            head[found.group(0)] = head.get(found.group(0), 0.0) + e.self_device_time_total / n / 1e3
    print("head kernels a train step (torch.profiler device time): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in head.items()), flush=True)
    api = {e.key: e.count / n for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.key.startswith(("cuda", "cu"))}
    print("CUDA runtime and driver calls a train step: "
          + ", ".join(f"{k} {v:g}" for k, v in sorted(api.items(), key=lambda kv: -kv[1])),
          flush=True)
    out = {"step_ms": step_ms, "busy_ms": busy_ms, "busy_share": busy_ms / step_ms,
           "profiled_step_ms": wall_us / n / 1e3, "ops_per_step": launches / n,
           "head_kernels_ms": head}
    if ens is not None:
        teach = [e for e in prof.key_averages() if e.key == "kd_teacher_scores"
                 and e.device_type == DeviceType.CPU]
        check(len(teach) == 1 and teach[0].count == TEACHER_RANGES * n,
              "the teachers' ranges every step")
        out["teacher_host_ms"] = teach[0].cpu_time_total / n / 1e3
        out["teacher_device_ms"] = teach[0].device_time_total / n / 1e3
        print(f"teacher scores a train step: host {out['teacher_host_ms']:.3f} ms under the "
              f"profiler, the card busy {out['teacher_device_ms']:.3f} ms for them "
              f"({out['teacher_device_ms'] / max(busy_ms, 1e-9):.3f} of the step's busy time)", flush=True)
    return out


# the serving phase: bench.py's 128K headline corpus (bench.py:115-130) on
# the exact scan; raw-text _bulk requests of 50 docs; the token burst of
# 64 clients x 8 requests of make_queries(512, 30522, n_terms=6, seed=3)
BIG_DOCS, BIG_VOCAB = 131072, 30522
N_TEXT_BULKS, BULK_DOCS = 20, 50
BURST_CLIENTS, BURST_PER_CLIENT = 64, 8
N_TEXT_QUERIES = 8
# a token search on the card against the same search in process: the same
# sums, maybe reduced in another order at another batch shape
TOKENS_RTOL = 1e-6
# a text search: the same encoder forward at the same shape, then as above
TEXT_RTOL = 1e-5


def http(base, method, path, body=None, raw=None):
    """(status, JSON body) of one request."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def search_body(spec, size=10):
    return {"query": {"neural_sparse": {"text_sparse": spec}}, "size": size}


def bulk_lines(index, docs):
    lines = []
    for doc_id, source in docs:
        lines += [json.dumps({"index": {"_index": index, "_id": doc_id}}), json.dumps(source)]
    return ("\n".join(lines) + "\n").encode()


def ok_search(base, index, spec, size=10, suffix=""):
    code, resp = http(base, "POST", f"/{index}/_search{suffix}", search_body(spec, size))
    check(code == 200, f"search on {index}{suffix}: {code} {resp}")
    check("ext" not in resp, "an exact engine's response carries no exactness ext")
    return resp


def hits_of(resp):
    return {h["_id"]: h["_score"] for h in resp["hits"]["hits"]}


def check_same_hits(resp, ref, what, rtol):
    """A response's hits against the same search in process ({doc_id:
    score}): the same ids in the same order (a swap only between scores
    within rtol), scores within rtol."""
    got = [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]
    want = sorted(ref.items(), key=lambda kv: -kv[1])
    check(len(got) == len(want) == resp["hits"]["total"]["value"],
          f"{what}: {len(got)} hits, in process {len(want)}")
    for (gi, gs), (wi, ws) in zip(got, want):
        check(abs(gs - ws) <= rtol * abs(ws), f"{what}: score {gs}, in process {ws}")
        check(gi == wi or abs(ref.get(gi, float("inf")) - ws) <= rtol * abs(ws),
              f"{what}: {gi} in place of {wi}")


def build_big_index(dev):
    """bench.py's 128K corpus (make_corpus(131072, 30522, avg_terms=110,
    seed=1, l_max=128)) with the default engine, "auto": above 65 536 docs
    it resolves to the inverted engine with exact escalation, its postings
    built on the incremental build's thread by the native library. Saved
    in format 2 for the server."""
    from bench import make_corpus
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    path = os.path.join(OUT, "serve", "big.index")
    toks, ws = make_corpus(BIG_DOCS, BIG_VOCAB, avg_terms=110, seed=1, l_max=128)
    idx = SparseIndex(BIG_VOCAB, IndexConfig(l_max=128, block_docs=2048), device=dev)
    t0 = time.perf_counter()
    idx.add_topk([str(i) for i in range(BIG_DOCS)], toks, ws)
    idx.finalize()
    build_s = time.perf_counter() - t0
    check(idx.cfg.engine == "auto" and idx._engine == "inverted" and idx._exact_escalate,
          f"auto resolves to the inverted engine with exact escalation ({idx._engine})")
    check(idx.postings_source == "incremental", f"big postings by {idx.postings_source}")
    builds = tracing.counters()
    check(builds.get("postings.build.native", 0) > 0 and not builds.get("postings.build.numpy")
          and not builds.get("postings.merge.numpy"),
          f"the native postings build ran, never the numpy one: {builds}")
    print(f"big index: {BIG_DOCS} docs, engine auto -> {idx._engine} (exact escalation "
          f"{idx._exact_escalate}), postings {tuple(idx._post_docs.shape)} by the "
          f"{idx.postings_source} build, counters {builds}; add + finalize "
          f"{build_s:.2f} s", flush=True)
    idx.save(path)
    return path


def scan_twin(index, dev):
    """The exact `sparse` scan over the same stored rows as `index`."""
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex

    n = index.n_docs
    scan = SparseIndex(index.vocab_size, IndexConfig(
        engine="sparse", l_max=index.cfg.l_max, block_docs=index.cfg.block_docs,
        query_batch=index.cfg.query_batch, weight_dtype=index.cfg.weight_dtype), device=dev)
    scan.doc_ids = list(index.doc_ids)
    scan._tok_chunks = [index._tok_dev[:n].cpu().numpy().astype(np.int32)]
    scan._w_chunks = [index._docs_dev[:n].float().cpu().numpy()]
    scan.finalize()
    return scan


def check_same_topk(got, want, what, rtol=1e-5):
    """Per-query top-k maps against the exact scan's: ids equal in order
    but where two scores tie exactly, scores within rtol."""
    n_hits = 0
    for qi, (g, w) in enumerate(zip(got, want)):
        gl, wl = list(g.items()), list(w.items())
        check(len(gl) == len(wl), f"{what} query {qi}: {len(gl)} hits, scan {len(wl)}")
        for (gi, gs), (wi, ws) in zip(gl, wl):
            check(abs(gs - ws) <= rtol * abs(ws), f"{what} query {qi}: score {gs}, scan {ws}")
            check(gi == wi or w.get(gi) == ws, f"{what} query {qi}: {gi} in place of {wi}")
        n_hits += len(gl)
    return n_hits


def doc_mode_copy(index_dir):
    """The evaluation's saved index with two_phase_mode "doc" in its saved
    config, so the server holds an index in each two-phase mode."""
    path = os.path.join(OUT, "serve", "rich-doc.index")
    os.makedirs(path, exist_ok=True)
    for f in ("index.npz", "doc_ids.json"):
        shutil.copy(os.path.join(index_dir, f), path)
    with open(os.path.join(index_dir, "meta.json")) as f:
        meta = json.load(f)
    meta["cfg"]["two_phase_mode"] = "doc"
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def start_server(argv):
    """`cli.serve.main(argv)` on a daemon thread of this process (so the
    launch counters stay readable) on a free port; waits for /_health."""
    from opensearch_sparse_model_tuning_sample_torch.cli import serve as serve_cli

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    failed = []

    def run():
        try:
            serve_cli.main(argv + ["--port", str(port)])
        except (Exception, SystemExit) as e:  # noqa: BLE001 — reported below
            failed.append(e)

    threading.Thread(target=run, daemon=True, name="cli.serve").start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 300
    while time.time() < deadline:
        check(not failed, f"cli.serve failed: {failed[:1]!r}")
        try:
            if http(base, "GET", "/_health") == (200, {"status": "green"}):
                return base
        except OSError:
            time.sleep(0.2)
    raise RuntimeError("check failed: cli.serve never answered /_health")


def drive_server(base, texts, query_texts, q_tok, q_w, vocab):
    """Everything the serving phase sends, through HTTP only; returns what
    came back for the checks in process (check_serving)."""
    rec = {"text_bulks": [], "text": [], "full_forward": 0}
    # -- the write loop: raw-text _bulk requests, one of text_sparse docs,
    # _refresh, then a second round (reopen) of both kinds
    code, resp = http(base, "PUT", "/live", {"settings": {"index": {"engine": "sparse"}}})
    check(code == 200 and resp["acknowledged"], f"PUT /live: {code} {resp}")
    rare = [vocab[20000 + i] for i in range(20)]  # one token of its own per text_sparse doc

    def text_bulk(first):
        docs = [(f"t{first + i}", {"text": texts[first + i]}) for i in range(BULK_DOCS)]
        code, resp = http(base, "POST", "/_bulk", raw=bulk_lines("live", docs))
        check(code == 200 and resp["errors"] is False and len(resp["items"]) == BULK_DOCS,
              f"text _bulk from doc {first}: {code}")
        rec["text_bulks"].append([s["text"] for _, s in docs])

    def sparse_bulk(prefix, toks):
        docs = [(f"{prefix}{i}", {"text_sparse": {t: 50.0, "the": 1.0}}) for i, t in enumerate(toks)]
        code, resp = http(base, "POST", "/_bulk", raw=bulk_lines("live", docs))
        check(code == 200 and resp["errors"] is False, f"text_sparse _bulk {prefix}: {code}")

    t0 = time.perf_counter()
    for b in range(N_TEXT_BULKS):
        text_bulk(b * BULK_DOCS)
    sparse_bulk("s", rare[:10])
    check(http(base, "POST", "/live/_refresh")[0] == 200, "_refresh")
    text_bulk(N_TEXT_BULKS * BULK_DOCS)  # after the refresh: reopen
    sparse_bulk("u", rare[10:])
    rec["ingest_s"] = time.perf_counter() - t0
    n_live = (N_TEXT_BULKS + 1) * BULK_DOCS + 20
    check(http(base, "GET", "/")[1]["indexes"]["live"] == n_live, f"/live holds {n_live} docs")
    for prefix, toks in (("s", rare[:10]), ("u", rare[10:])):
        for i, t in enumerate(toks):
            top = ok_search(base, "live", {"query_tokens": {t: 1.0}}, size=3)["hits"]["hits"]
            check(top and top[0]["_id"] == f"{prefix}{i}", f"{prefix}{i} is found by its own token")
    # one raw-text doc of each round, searched by its own full-forward rep
    # (the _encode route), among all docs that share a term with it
    for doc in ("t5", f"t{N_TEXT_BULKS * BULK_DOCS + 5}"):
        code, emb = http(base, "POST", "/_encode",
                         {"texts": [texts[int(doc[1:])]], "inf_free": False})
        check(code == 200, f"_encode: {code}")
        rec["full_forward"] += 1
        top = dict(sorted(emb["embeddings"][0].items(), key=lambda kv: -kv[1])[:32])
        hits = hits_of(ok_search(base, "live", {"query_tokens": top}, size=n_live))
        check(doc in hits, f"{doc} is searchable after the second round")

    # -- the token burst on big: 64 clients, 8 requests each, size 10
    bodies = [search_body({"query_tokens": {vocab[int(t)]: float(w)
                                            for t, w in zip(q_tok[i], q_w[i]) if w > 0}})
              for i in range(len(q_tok))]
    for i in range(8):  # warm-up
        code, resp = http(base, "POST", "/big/_search", bodies[i])
        check(code == 200 and resp["ext"]["exactness"]["certified"] is True,
              f"warm-up search on big: {code}")

    def client(c):
        out = []
        for r in range(BURST_PER_CLIENT):
            i = c * BURST_PER_CLIENT + r
            t = time.perf_counter()
            code, resp = http(base, "POST", "/big/_search", bodies[i])
            out.append((i, code, resp, time.perf_counter() - t))
        return out

    stats0 = http(base, "GET", "/_stats")[1]["search_microbatch"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(BURST_CLIENTS) as ex:
        burst = sorted(x for part in ex.map(client, range(BURST_CLIENTS)) for x in part)
    rec["burst_s"] = time.perf_counter() - t0
    stats1 = http(base, "GET", "/_stats")[1]["search_microbatch"]
    for i, code, resp, _ in burst:
        check(code == 200 and resp.get("ext", {}).get("exactness", {}).get("certified") is True,
              f"burst request {i}: {code}, certified {resp.get('ext')}")
    rec["burst"] = burst
    rec["burst_stats"] = {k: stats1[k] - stats0[k] for k in ("requests", "engine_calls", "batches")}
    rec["burst_stats"]["max_batch_seen"] = stats1["max_batch_seen"]

    # -- text searches on rich, one at a time (a batch of 1, as in process),
    # exact then two-phase through a pipeline on an index in each mode
    for inf_free in (True, False):
        for t in query_texts:
            resp = ok_search(base, "rich", {"query_text": t, "inf_free": inf_free})
            rec["text"].append(("rich", t, inf_free, False, resp))
            rec["full_forward"] += not inf_free
    code, _ = http(base, "PUT", "/_search/pipeline/p", {"request_processors": [
        {"neural_sparse_two_phase_processor": {"tag": "neural-sparse"}}]})
    check(code == 200, "PUT /_search/pipeline/p")
    for index in ("rich", "richdoc"):
        for inf_free in (True, False):
            for t in query_texts:
                resp = ok_search(base, index, {"query_text": t, "inf_free": inf_free},
                                 suffix="?search_pipeline=p")
                rec["text"].append((index, t, inf_free, True, resp))
                rec["full_forward"] += not inf_free
    code, resp = http(base, "POST", "/rich/_search?search_pipeline=nope",
                      search_body({"query_text": query_texts[0]}))
    check(code == 400, f"an unknown search pipeline gets a 400 ({code})")
    return rec


def check_serving(dev, rec, dirs, ckpt):
    """The responses against the same searches in process, on second copies
    of the saved indexes and the checkpoint's encoder; the burst's top-10
    against brute force on 32 queries; the ingest kernel against its plain
    version on one served bulk's texts."""
    from opensearch_sparse_model_tuning_sample_torch.index.engine import SparseIndex
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se

    big = SparseIndex.load(dirs["big"], device=dev)
    check(big._engine == "inverted" and big._exact_escalate,
          "the saved big index loads as the inverted engine with exact escalation")
    scan = scan_twin(big, dev)
    q_tok, q_w = rec["q_tok"], rec["q_w"]
    ref = big.search_tokens(q_tok, q_w, k=10)
    cert, esc, scan_esc = big.last_certified, big.last_escalated, big.last_scan_escalated
    check(cert is not None and cert.all(), "every burst query is certified")
    want = scan.search_tokens(q_tok, q_w, k=10)
    n_scan = check_same_topk(ref, want, "inverted vs exact scan")
    engine = {
        "certified_share": float(1.0 - esc.mean()),  # by the base pass alone
        "deep_escalations": int((esc & ~scan_esc).sum()),
        "scan_escalations": int(scan_esc.sum()),
        "inverted": engine_call_profile(big, q_tok, q_w),
        "scan": engine_call_profile(scan, q_tok, q_w),
    }
    for i, _, resp, _ in rec["burst"]:
        check_same_hits(resp, ref[i], f"burst request {i}", TOKENS_RTOL)
    qd = np.zeros((32, BIG_VOCAB), np.float32)
    for i in range(32):
        np.add.at(qd[i], q_tok[i][q_w[i] > 0], q_w[i][q_w[i] > 0])
    n_bf = brute_force_check(dirs["big"], torch.from_numpy(qd).to(dev),
                             [hits_of(rec["burst"][i][2]) for i in range(32)], BIG_VOCAB, dev)
    print(f"serve: big inverted top-10 equals the exact scan for all {len(q_tok)} queries "
          f"({n_scan} hits); certified share {engine['certified_share']:.4f} by the base pass, "
          f"escalations {engine['deep_escalations']} to the deep tier and "
          f"{engine['scan_escalations']} to the scan, all certified after", flush=True)
    for name in ("inverted", "scan"):
        e = engine[name]
        print(f"serve: engine alone ({name}), {len(q_tok)} queries: {e['qps']:.1f} q/s, "
              f"{e['syncs_per_call']:g} host syncs a call; a 64-query call {e['call_ms']:.2f} ms, "
              f"card busy {e['busy_ms']:.2f} ms ({e['busy_share']:.3f}), "
              f"{e['ops_per_call']:.0f} device operations; top: {e['top_ops_ms']}", flush=True)
    del big, scan
    torch.cuda.empty_cache()

    model = se.build_model(model_name_or_path=ckpt,
                           idf_path=os.path.join(HERE, "assets", "idf.npz"), device=dev)
    enc = se.BatchEncoder(model, max_length=512, do_count=False)
    local = {name: SparseIndex.load(dirs[name], device=dev) for name in ("rich", "richdoc")}
    exact = {}
    overlap = {}
    for index, text, inf_free, two_phase, resp in rec["text"]:
        reps = enc.encode_batch_device([text], inf_free=inf_free)
        want = local[index].search(reps, k=10, two_phase=two_phase)[0]
        check_same_hits(resp, want, f"{index} text search (inf_free={inf_free}, "
                        f"two_phase={two_phase})", TEXT_RTOL)
        if not two_phase:
            exact[(text, inf_free)] = set(want)
        else:
            ex = exact[(text, inf_free)]
            key = f"{local[index].cfg.two_phase_mode}, inf_free={inf_free}"
            overlap.setdefault(key, []).append(len(ex & set(want)) / max(len(ex), 1))
    enc_err = encoder_check(model, rec["text_bulks"][0], 256, dev)
    return {"brute_force_hits": n_bf, "encoder_check_err": enc_err,
            "two_phase_overlap": {k: float(np.mean(v)) for k, v in overlap.items()},
            "engine": engine}


def engine_call_profile(index, q_tok, q_w, n=3, per_call=64):
    """The engine alone, in process: q/s of search_tokens over all of q_tok
    in one call (mean of n, each ending in the copy to the host) and the
    host syncs such a call makes; then one call of `per_call` queries: its
    host time (mean of n) and, from torch.profiler over n more, the card's
    busy time a call, the device operations a call and the top five."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    index.search_tokens(q_tok, q_w, k=10)
    syncs = index.host_syncs
    t0 = time.perf_counter()
    for _ in range(n):
        index.search_tokens(q_tok, q_w, k=10)
    qps = n * len(q_tok) / (time.perf_counter() - t0)
    out = {"queries": len(q_tok), "qps": qps, "syncs_per_call": (index.host_syncs - syncs) / n}
    q_tok, q_w = q_tok[:per_call], q_w[:per_call]
    index.search_tokens(q_tok, q_w, k=10)
    t0 = time.perf_counter()
    for _ in range(n):
        index.search_tokens(q_tok, q_w, k=10)
    call_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            index.search_tokens(q_tok, q_w, k=10)
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in on_card) / n / 1e3
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:5]
    out.update(queries_per_call=len(q_tok), call_ms=call_ms, busy_ms=busy_ms,
               busy_share=busy_ms / call_ms, ops_per_call=sum(e.count for e in on_card) / n,
               top_ops_ms={e.key[:50]: e.self_device_time_total / n / 1e3 for e in top})
    return out


def phase_serve(dev, ckpt, index_dir, texts, query_texts):
    """The serving path through `cli.serve`'s entry point on the card. The
    counters are set to 0 just before the server starts and read when the
    last request has come back, before any check in process."""
    from bench import make_queries
    from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer

    t0 = time.time()
    dirs = {"rich": index_dir, "richdoc": doc_mode_copy(index_dir), "big": build_big_index(dev)}
    torch.cuda.empty_cache()
    build_s = time.time() - t0
    tok = load_tokenizer(None)
    vocab = [tok.convert_id_to_token(i) for i in range(BIG_VOCAB)]
    check(len(set(vocab)) == BIG_VOCAB and all(tok.vocab[v] == i for i, v in enumerate(vocab)),
          "vocab strings name the token ids one to one")
    q_tok, q_w = make_queries(BURST_CLIENTS * BURST_PER_CLIENT, BIG_VOCAB, n_terms=6, seed=3)

    reset_counters()
    base = start_server(["--index", f"rich={dirs['rich']}", "--index", f"richdoc={dirs['richdoc']}",
                         "--index", f"big={dirs['big']}", "--model", ckpt,
                         "--batch-window-ms", "5", "--max-batch", "128"])
    rec = drive_server(base, texts, query_texts, q_tok, q_w, vocab)
    torch.cuda.synchronize()
    launches, plain = read_counters()
    attention = read_attention()
    check_attention(attention, ckpt_layers(ckpt), launches["maxpool_head"], "serving")
    drive_s = time.time() - t0 - build_s
    rec.update(q_tok=q_tok, q_w=q_w)
    n_text_bulks = len(rec["text_bulks"])
    print(f"serve: maxpool_head launches {launches['maxpool_head']} for {n_text_bulks} text _bulk "
          f"requests + {rec['full_forward']} full-forward encodes; plain calls {plain}", flush=True)
    check(launches["maxpool_head"] >= n_text_bulks + rec["full_forward"],
          "the ingest kernel ran for every text _bulk and full-forward query")
    check(not any(plain.values()), f"no plain version ran in the serving path: {plain}")
    out = check_serving(dev, rec, dirs, ckpt)
    lat = np.array([x[3] for x in rec["burst"]]) * 1e3
    out.update(
        launches=launches["maxpool_head"], attention=attention, text_bulks=n_text_bulks,
        full_forward=rec["full_forward"], ingest_docs_per_s=n_text_bulks * BULK_DOCS / rec["ingest_s"],
        burst_requests=len(rec["burst"]), burst_qps=len(rec["burst"]) / rec["burst_s"],
        p50_ms=float(np.percentile(lat, 50)), p95_ms=float(np.percentile(lat, 95)),
        stats=rec["burst_stats"], text_searches=len(rec["text"]), build_s=build_s,
        drive_s=drive_s, check_s=time.time() - t0 - build_s - drive_s)
    print(f"serve: {len(rec['burst'])} token searches on the {BIG_DOCS}-doc index equal the "
          f"search in process; top-10 equals brute force for 32 ({out['brute_force_hits']} hits); "
          f"{out['text_searches']} text searches on rich equal the search in process; "
          f"two-phase top-10 overlap with exact {out['two_phase_overlap']}; encoder check on a "
          f"served bulk max |err| {out['encoder_check_err']:.3g}", flush=True)
    return out


def phase_inverted_eval(dev, path):
    """`cli.evaluate_beir` of the 50-step checkpoint on synthetic-rich with
    `--index_engine inverted --index_exact_escalate true`, through its entry
    point. Its metrics must equal the scan evaluation's from this run; its
    index must be built by the incremental build on the card, with
    postings bit-equal to one build_postings of the rows it was fed; the
    ingest kernel must run for every batch and no plain version at all."""
    from opensearch_sparse_model_tuning_sample_torch.cli import evaluate_beir
    from opensearch_sparse_model_tuning_sample_torch.eval import beir
    from opensearch_sparse_model_tuning_sample_torch.index import inverted
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    ckpt = path["ckpt"]
    argv = ["evaluate_beir", path["path"], "--index_engine", "inverted",
            "--index_exact_escalate", "true", "--output_dir", os.path.join(OUT, "inverted_eval"),
            "--model_name_or_path", ckpt, "--tokenizer_name", ckpt]
    captured, fed = {}, []
    inc = inverted.IncrementalPostingsBuilder
    orig = (beir.ingest, inc.feed, inc.finish, sys.argv)

    def ingest(*a, **kw):
        captured["index"] = orig[0](*a, **kw)
        return captured["index"]

    def feed(self, toks, ws, off):
        fed.append((off, toks.copy(), ws.copy()))
        return orig[1](self, toks, ws, off)

    def finish(self):
        captured["postings"] = orig[2](self)
        return captured["postings"]

    builds = tracing.counters()
    beir.ingest, inc.feed, inc.finish, sys.argv = ingest, feed, finish, argv
    t0 = time.time()
    reset_counters()
    try:
        avg = evaluate_beir.main()
    finally:
        beir.ingest, inc.feed, inc.finish, sys.argv = orig
    launches, plain = read_counters()
    seconds = time.time() - t0
    index = captured["index"]
    n = index.n_docs
    check(index._engine == "inverted" and index._exact_escalate,
          "the eval's index is the inverted engine with exact escalation")
    check(index.postings_source == "incremental" and index.device.type == "cuda",
          f"the eval's postings came from the incremental build on the card "
          f"({index.postings_source}, {index.device})")
    fed.sort(key=lambda f: f[0])
    check([f[0] for f in fed] == list(np.cumsum([0] + [len(f[1]) for f in fed[:-1]]))
          and sum(len(f[1]) for f in fed) == n, "the incremental build took every row once, in order")
    one = inverted.build_postings(np.concatenate([f[1] for f in fed]),
                                  np.concatenate([f[2] for f in fed]), index.vocab_size,
                                  index._build_cap)
    pd, pw = captured["postings"]
    check(np.array_equal(pd, one[0]) and np.array_equal(pw.view(np.int32), one[1].view(np.int32)),
          "incremental postings bit-equal to the one-shot build of the same rows")
    check(np.array_equal(index._post_docs.cpu().numpy(), one[0]), "the card holds those postings")
    now = tracing.counters()
    check(now.get("postings.build.numpy", 0) == builds.get("postings.build.numpy", 0),
          f"no numpy postings build: {now}")
    n_batches = -(-n // path["cfg"]["per_device_eval_batch_size"])
    check(launches["maxpool_head"] >= n_batches, "the ingest kernel ran for every ingest batch")
    check(not any(plain.values()), f"no plain version ran in the inverted eval: {plain}")
    same = {k: (avg[k], path["avg"][k]) for k in path["avg"] if k != "qps"}
    check(all(a == b for a, b in same.values()), f"inverted eval metrics equal the scan's: {same}")
    check(avg["certified_frac"] == 1.0, f"every query certified ({avg['certified_frac']})")
    out = {"seconds": seconds, "docs": n, "postings": list(index._post_docs.shape),
           "fed_chunks": len(fed), "metrics": {k: v for k, v in avg.items()},
           "scan_metrics": path["avg"], "launches": launches["maxpool_head"]}
    print(f"inverted eval: {n} docs, postings {out['postings']} from the incremental build "
          f"({len(fed)} chunk(s)) bit-equal to one build; metrics equal the scan's "
          f"(NDCG@10 {avg['NDCG@10']:.5f}); certified_frac {avg['certified_frac']:.4f}, "
          f"escalated_frac {avg['escalated_frac']:.4f}; search {avg['qps']:.1f} q/s against the "
          f"scan's {path['avg']['qps']:.1f}; maxpool_head launches {launches['maxpool_head']}; "
          f"{seconds:.1f} s", flush=True)
    del captured, index
    torch.cuda.empty_cache()
    return out


# the distillation phase: the kd recipe's length and warm-up here, and the
# subset of the mined split that make_kd_scores scores (its flags are
# config_l0_synthetic.yaml:10-12's)
KD_STEPS, KD_WARMUP, KD_ROWS = 30, 5, 512
KD_LOG_STEPS = 10  # the loss is read at steps 1, 10, 20, 30
# card against CPU, bf16 encoders on both (cuBLAS and the CPU's GEMMs round
# at other places): reps, and raw scores relative to their row's largest
KD_REP_TOL = 3e-2
KD_SCORE_TOL = 2e-2
TEACHER_KERNELS = {"maxpool_head": 4}  # 2 sparse teachers x (queries, docs) a step
STUDENT_KERNELS = {"maxpool_head_argmax": 1, "maxpool_head_bwd_w": 1, "maxpool_head_bwd_h": 1}


def check_launches(counters, steps, per_step, what):
    launches, plain = counters
    for k, v in launches.items():
        want = per_step.get(k, 0) * steps
        check(v == want, f"{what}: {k} launched {v} times, {want} expected")
    check(not any(plain.values()), f"no plain version ran in {what}: {plain}")


def teacher_state_equals(ens, ckpts):
    """Each teacher's parameters, bit for bit, against the checkpoint it
    was built from."""
    from opensearch_sparse_model_tuning_sample_torch.models import hf_import

    for t, ckpt in zip(ens.teachers, ckpts):
        _, sd, _ = hf_import.load_checkpoint(ckpt)
        own = t.bert.state_dict()
        check(sorted(own) == sorted(sd) and all(
            torch.equal(own[k].cpu(), sd[k]) for k in sd), f"teacher {ckpt} is unchanged")


def minmax_tol(raw, rel, scale):
    """Ensemble scores' tolerance from the teachers' raw [B, N] scores: if
    each score, and so the row's min and max, moves by at most rel max|s|,
    a min-max normalised score moves by at most 4 rel max|s| / range;
    averaged over the teachers, times the score scale."""
    per = [4 * rel * s.abs().amax(1) / (s.amax(1) - s.amin(1)) for s in raw]
    return scale * torch.stack(per).mean(0)[:, None]


def kd_scores_check(trainer, np_batch):
    """One batch's ensemble scores on the card against the same ensemble
    built on the CPU from the same checkpoints."""
    from opensearch_sparse_model_tuning_sample_torch.core.mesh import batch_to
    from opensearch_sparse_model_tuning_sample_torch.ops.losses import pair_scores
    from opensearch_sparse_model_tuning_sample_torch.train.teachers import (
        build_ensemble, teacher_rep)

    da = trainer.data_args
    cpu = build_ensemble(da.kd_ensemble_teacher_kwargs, da.use_in_batch_negatives,
                         max_length=da.max_seq_length, device="cpu")
    card = trainer.teacher_ensemble
    on_card = batch_to(np_batch, trainer.device)
    on_cpu = {k: np_batch[k] for k in ("teacher_q", "teacher_d")}
    on_cpu = {k: [{n: torch.as_tensor(x) for n, x in f.items()} for f in v]
              for k, v in on_cpu.items()}
    got = card.get_scores(on_card["teacher_q"], on_card["teacher_d"]).cpu()
    want = cpu.get_scores(on_cpu["teacher_q"], on_cpu["teacher_d"])
    raw, raw_err = [], 0.0
    for i, (tc, tg) in enumerate(zip(cpu.teachers, card.teachers)):
        reps = [(teacher_rep(tc, on_cpu[k][i]), teacher_rep(tg, on_card[k][i]).cpu())
                for k in ("teacher_q", "teacher_d")]
        for a, b in reps:
            err = (a - b).abs()
            check(bool((err <= KD_REP_TOL * a.abs().clamp_min(1.0)).all()),
                  f"teacher {i} reps, card vs CPU: max |err| {float(err.max()):.3g}")
        s_cpu = pair_scores(reps[0][0], reps[1][0], card.use_in_batch_negatives)
        s_card = pair_scores(reps[0][1], reps[1][1], card.use_in_batch_negatives)
        rel = float(((s_card - s_cpu).abs() / s_cpu.abs().amax(1, keepdim=True)).max())
        check(rel <= KD_SCORE_TOL, f"teacher {i} raw scores, card vs CPU: {rel:.3g} of the row max")
        raw.append(s_cpu)
        raw_err = max(raw_err, rel)
    # the ensemble's arithmetic (min-max, mean, scale) on both devices: its
    # scores differ only as far as the raw scores' measured difference allows
    tol = minmax_tol(raw, raw_err, card.score_scale)
    err = (got - want).abs()
    check(bool((err <= tol).all()), f"ensemble scores, card vs CPU: max |err| {float(err.max()):.4g}")
    return {"max_abs_err": float(err.max()), "raw_rel_err": raw_err,
            "tol_min": float(tol.min()), "shape": list(got.shape)}


def phase_kd_train(dev, path):
    """(b) the kd recipe (config_kd_synthetic: two sparse teachers, the
    infonce run's checkpoint-50 and checkpoint-25, scored in the step;
    in-batch kldiv; the full-width mini student from random init) through
    cli.train_ir, 30 steps."""
    from opensearch_sparse_model_tuning_sample_torch.cli import train_ir
    from opensearch_sparse_model_tuning_sample_torch.core.mesh import batch_to

    teachers = [path["ckpt"], os.path.join(path["cfg"]["output_dir"],
                                            f"checkpoint-{TRAIN_STEPS // 2}")]
    kd_path, cfg = smoke_recipe(
        dev, "config_kd_synthetic", max_steps=KD_STEPS, warmup_steps=KD_WARMUP,
        save_steps=KD_STEPS, logging_steps=KD_LOG_STEPS, output_dir=os.path.join(OUT, "kd"),
        train_file=os.path.join(OUT, path["cfg"]["train_file"]),
        kd_ensemble_teacher_kwargs={"model_ids": teachers, "teacher_tokenizer_ids": teachers})
    t0 = time.time()
    with StepClock(KD_WARMUP, KD_STEPS) as clock:
        reset_counters()
        trainer = train_ir.main(kd_path)
        counters = read_counters()
        attention = read_attention()
    seconds = time.time() - t0
    steps = trainer.step
    check(steps == KD_STEPS, "the kd trainer took every step")
    check([t.kind for t in trainer.teacher_ensemble.teachers] == ["sparse", "sparse"]
          and all(t.bert.embeddings.word_embeddings.device.type == "cuda"
                  for t in trainer.teacher_ensemble.teachers), "two sparse teachers on the card")
    check_launches(counters, steps, {**TEACHER_KERNELS, **STUDENT_KERNELS}, "the kd run")
    # the teachers (no_grad) take the fused attention kernel, the student
    # (dropout, autograd) BERT's plain chain
    t_layers = {t.bert.cfg.num_hidden_layers for t in trainer.teacher_ensemble.teachers}
    check(len(t_layers) == 1 and attention["attention_global_kernel"]
          == t_layers.pop() * counters[0]["maxpool_head"] and attention["plain_chain"] > 0,
          f"the kd run: the teachers' attention through the kernel, the student's through "
          f"the plain chain: {attention}")
    teacher_state_equals(trainer.teacher_ensemble, teachers)
    hist = trainer.log_history
    check([h["step"] for h in hist] == [1] + list(range(KD_LOG_STEPS, steps + 1, KD_LOG_STEPS)),
          "the kd run logged at steps 1, 10, 20, 30")
    check(all(np.isfinite(v) for h in hist for v in h.values()), "finite kldiv loss at every log")
    ckpt = os.path.join(cfg["output_dir"], f"checkpoint-{steps}")
    check(os.path.exists(os.path.join(ckpt, "model.safetensors")), "the kd checkpoint")
    docs = (KD_STEPS - KD_WARMUP) * cfg["per_device_train_batch_size"] * (
        1 + cfg["sample_num_one_query"])
    docs_per_s = docs / clock.seconds()
    print(f"kd recipe: {steps} steps in {seconds:.1f} s; launches {counters[0]} (maxpool_head 4 "
          f"a step for the teachers, the training kernels 1 a step), plain {counters[1]}; kldiv "
          f"{hist[0]['ranking_loss']:.5f} (step 1) -> {hist[-1]['ranking_loss']:.5f} (step "
          f"{steps}); teachers bit-equal to their checkpoints; {docs_per_s:.1f} docs/s over steps "
          f"{KD_WARMUP}..{steps} (host clock, synchronized, saves excluded)", flush=True)

    captured, grad_worst, np_batch = grad_check(trainer, dev)
    scores = kd_scores_check(trainer, np_batch)
    print(f"kd teacher scores {scores['shape']}, card vs CPU: max |err| "
          f"{scores['max_abs_err']:.4g} (smallest row tolerance {scores['tol_min']:.4g}), raw "
          f"scores within {scores['raw_rel_err']:.3g} of the row max", flush=True)
    batch = batch_to(np_batch, trainer.device)
    ens = trainer.teacher_ensemble
    # at the host's pace: ~860 launches a call overflow the launch queue, so
    # cuda_ms's sleeping stream cannot time them on the card alone; the
    # profile below reads their device time
    teacher_host_ms = cuda_ms(lambda: ens.get_scores(batch["teacher_q"], batch["teacher_d"]),
                              iters=10, sleep=False)
    docs_per_step = cfg["per_device_train_batch_size"] * (1 + cfg["sample_num_one_query"])
    profile = profile_steps(trainer, np_batch, 1e3 * docs_per_step / docs_per_s)
    print(f"kd teacher scores alone (CUDA events at the host's pace): {teacher_host_ms:.3f} ms",
          flush=True)
    out = {"steps": steps, "seconds": seconds, "launches": counters[0], "attention": attention,
           "docs_per_s": docs_per_s,
           "log": hist, "grad_worst_rel_err": grad_worst, "scores": scores,
           "teacher_scores_host_ms": teacher_host_ms,
           "profile": profile, "teachers": teachers}
    del trainer, captured, batch
    torch.cuda.empty_cache()
    return out


def phase_kd_data(dev, path):
    """(c) cli.make_kd_scores with teacher checkpoint-50 over the first
    512 rows of the mined split (16 docs a query, 8 of them random),
    then 8 of its rows scored again in process on the CPU."""
    import datasets as hfds

    from opensearch_sparse_model_tuning_sample_torch.cli import make_kd_scores
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se

    root = os.path.join(OUT, "kd_data")
    posnegs, kd = os.path.join(root, f"posnegs_{KD_ROWS}"), os.path.join(root, "synthetic-rich_kd3")
    shutil.rmtree(root, ignore_errors=True)
    src = hfds.Dataset.load_from_disk(os.path.join(OUT, path["cfg"]["train_file"]))
    src.select(range(KD_ROWS)).save_to_disk(posnegs)
    t0 = time.time()
    reset_counters()
    rows = make_kd_scores.main(["--posnegs", posnegs, "--teacher", path["ckpt"], "--out", kd,
                                "--docs-per-query", "16", "--random-negs", "8",
                                "--device", str(dev)])
    counters = read_counters()
    seconds = time.time() - t0
    n_docs = sum(len(r["docs"]) for r in rows)
    check(len(rows) == KD_ROWS and all(len(r["docs"]) == 16 for r in rows),
          f"{len(rows)} kd rows of 16 docs")
    check_launches(counters, -(-n_docs // 64), {"maxpool_head": 1}, "cli.make_kd_scores")
    saved = hfds.Dataset.load_from_disk(kd)
    check(saved.num_rows == KD_ROWS and saved[0]["docs"] == rows[0]["docs"], "the kd rows saved")
    model = se.build_model(model_name_or_path=path["ckpt"], device="cpu")
    enc = se.BatchEncoder(model, max_length=256, do_count=False)
    worst = 0.0
    for r in saved.select(range(8)):
        q = enc.encode_batch([r["query"]], inf_free=True)[0]
        s = enc.encode_batch(r["docs"]) @ q
        rel = float(np.abs(s - np.array(r["scores"])).max() / np.abs(s).max())
        worst = max(worst, rel)
        check(rel <= KD_SCORE_TOL, f"kd scores, card vs CPU: {rel:.3g} of the row max")
        check(all(a >= b for a, b in zip(r["scores"], r["scores"][1:])), "rows rank-ordered")
    print(f"cli.make_kd_scores: {len(rows)} rows, {n_docs} docs in {seconds:.1f} s; launches "
          f"{counters[0]}, plain {counters[1]}; 8 rows rescored on the CPU within {worst:.3g} of "
          "the row max", flush=True)
    return {"rows": len(rows), "docs": n_docs, "seconds": seconds, "launches": counters[0],
            "cpu_rel_err": worst, "path": kd}


def phase_l0(dev, path, kd_data, n_docs):
    """(d) the L0 recipe (config_l0_synthetic: kldiv on (c)'s scores,
    double-log1p, the L0-thresholded FLOPS, batch 20 at max_seq_length
    256) from checkpoint-25 through cli.train_ir, 30 steps; (e) its
    checkpoint through cli.evaluate_beir on the exact scan."""
    from opensearch_sparse_model_tuning_sample_torch.cli import evaluate_beir, train_ir

    l0_path, cfg = smoke_recipe(
        dev, "config_l0_synthetic", max_steps=KD_STEPS, warmup_steps=KD_WARMUP,
        save_steps=KD_STEPS, logging_steps=KD_LOG_STEPS, output_dir=os.path.join(OUT, "l0"),
        index_engine="sparse",
        model_name_or_path=os.path.join(path["cfg"]["output_dir"], f"checkpoint-{TRAIN_STEPS // 2}"),
        train_file=kd_data["path"])
    t0 = time.time()
    reset_counters()
    trainer = train_ir.main(l0_path)
    counters = read_counters()
    train_s = time.time() - t0
    check(trainer.step == KD_STEPS and trainer.model.use_l0, "the L0 run took every step, use_l0")
    check_launches(counters, trainer.step, STUDENT_KERNELS, "the L0 run")
    hist = trainer.log_history
    check(all(np.isfinite(v) for h in hist for v in h.values()), "finite L0 loss at every log")
    print(f"L0 recipe: {trainer.step} steps in {train_s:.1f} s; launches {counters[0]}, plain "
          f"{counters[1]}; kldiv {hist[0]['ranking_loss']:.5f} -> {hist[-1]['ranking_loss']:.5f}, "
          f"d_flops {hist[0]['d_flops']:.4f} -> {hist[-1]['d_flops']:.4f}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    t0 = time.time()
    reset_counters()
    avg = evaluate_beir.main(l0_path)
    eval_counters = read_counters()
    eval_s = time.time() - t0
    launches = eval_counters[0]["maxpool_head"]
    check(launches >= -(-n_docs // cfg["per_device_eval_batch_size"])
          and not any(eval_counters[1].values()),
          f"the L0 eval ran the ingest kernel for every batch, no plain version: {eval_counters}")
    check(0.0 <= avg["NDCG@10"] <= 1.0 and np.isfinite(avg["flops"]) and avg["flops"] > 0,
          "finite L0 eval metrics")
    print(f"L0 eval (exact scan, checkpoint-{KD_STEPS}): NDCG@10 {avg['NDCG@10']:.5f}, "
          f"Recall@100 {avg.get('Recall@100', float('nan')):.5f}, FLOPS {avg['flops']:.4f}; "
          f"maxpool_head launches {launches}; {eval_s:.1f} s (correctness signals only)", flush=True)
    return {"train_s": train_s, "launches": counters[0], "log": hist, "eval_s": eval_s,
            "eval_launches": launches, "metrics": avg}

# (f): the two new layouts at the mini width, RoBERTa at its own vocab
NEW_LAYOUTS = {
    "roberta": dict(model_type="roberta", vocab_size=50265, position_style="from_pad_offset",
                    head_act="gelu", max_position_embeddings=514, type_vocab_size=1,
                    pad_token_id=1, layer_norm_eps=1e-5),
    "distilbert": dict(model_type="distilbert", vocab_size=30522, use_token_type=False,
                       type_vocab_size=1),
}


def phase_layouts(dev):
    """(f) a RoBERTa and a DistilBERT checkpoint written by the port's
    save_checkpoint from seeded mini-width weights, loaded back through
    hf_import.load_checkpoint, and their sparse (the ingest kernel) and
    dense (cls, mean) teacher reps on the card held to the CPU's on seeded
    token ids."""
    from opensearch_sparse_model_tuning_sample_torch.models import bert as bert_mod
    from opensearch_sparse_model_tuning_sample_torch.models import hf_import
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
    from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer
    from opensearch_sparse_model_tuning_sample_torch.ops.activations import special_token_mask
    from opensearch_sparse_model_tuning_sample_torch.train import teachers as tt

    out = {}
    for layout, fields in NEW_LAYOUTS.items():
        cfg = bert_mod.config_from_preset("mini", **fields)
        bert = bert_mod.from_state_dict(cfg, bert_mod.init_state_dict(cfg, 7), torch.device("cpu"))
        ckpt = os.path.join(OUT, "layouts", layout)
        hf_import.save_checkpoint(se.SparseEncoderModel(cfg, bert, torch.ones(cfg.vocab_size),
                                                        load_tokenizer(None)), ckpt)
        cfg2, sd, _ = hf_import.load_checkpoint(ckpt)
        check(cfg2.model_type == layout and cfg2.padded_vocab_size == cfg.padded_vocab_size,
              f"{layout} checkpoint loads back as {layout}")
        rng = np.random.default_rng(11)
        B, L = 16, 128
        lens = rng.integers(8, L + 1, size=B)
        mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
        ids = np.where(mask > 0, rng.integers(5, cfg2.vocab_size, size=(B, L)), cfg2.pad_token_id)
        reps = {}
        reset_counters()
        for d in ("cpu", dev):
            bert = bert_mod.from_state_dict(cfg2, sd, torch.device(d)).requires_grad_(False)
            smask = special_token_mask([0, 1, 2], cfg2.vocab_size, torch.device(d))
            x, m = torch.from_numpy(ids).to(d), torch.from_numpy(mask).to(d)
            reps[str(d)] = [tt.sparse_teacher_rep(bert, smask, x, m).cpu()] + [
                tt.dense_teacher_rep(bert, x, m, pooling=p).cpu() for p in ("cls", "mean")]
        launches, plain = read_counters()
        check(launches["maxpool_head"] == 1 and plain["maxpool_head_reference"] == 1,
              f"{layout}: the card's sparse rep ran the ingest kernel, the CPU's the plain head")
        errs = []
        for name, a, b in zip(("sparse", "dense cls", "dense mean"), reps[str(dev)], reps["cpu"]):
            err = (a - b).abs()
            check(bool((err <= KD_REP_TOL * b.abs().clamp_min(1.0)).all()),
                  f"{layout} {name} rep, card vs CPU: max |err| {float(err.max()):.3g}")
            errs.append(float(err.max()))
        out[layout] = {"vocab": cfg2.vocab_size, "padded_vocab": cfg2.padded_vocab_size,
                       "max_abs_err": dict(zip(("sparse", "dense_cls", "dense_mean"), errs))}
        print(f"{layout} checkpoint (mini, vocab {cfg2.vocab_size} padded to "
              f"{cfg2.padded_vocab_size}): sparse and dense reps on the card equal the CPU's "
              f"(max |err| {', '.join(f'{e:.3g}' for e in errs)})", flush=True)
    return out


def phase_distill(dev, path, n_docs):
    """The distillation phase, after the inverted eval: (b) the kd recipe,
    (c) its kd data, (d)-(e) the L0 recipe and its eval, (f) the new
    layouts. (a), the teachers' checkpoint-25 and checkpoint-50, came from
    the main path's infonce run."""
    t0 = time.time()
    kd = phase_kd_train(dev, path)
    kd_data = phase_kd_data(dev, path)
    l0 = phase_l0(dev, path, kd_data, n_docs)
    layouts = phase_layouts(dev)
    return {"kd": kd, "kd_data": kd_data, "l0": l0, "layouts": layouts,
            "seconds": time.time() - t0}

# step 11, the multi-process launch: 11a torchrun at world 1 on NCCL, 11b two
# cli.evaluate_beir ranks on the one card, 11c two cli.mine ranks, 11d the
# data CLIs and kd training under torchrun. NCCL refuses two ranks on one
# card, so 11b and 11c use no process group: their barrier is the
# filesystem, and --device cuda:0 puts both ranks on the card by request.
DIST = os.path.join(OUT, "dist")
DIST_TIMEOUT_S = 420
# 11a is held to the run-to-run spread of three one-process runs (the main
# path's and two repeats: the largest of their three pairwise differences),
# times this: a fourth draw of the spread may exceed the three seen
NOISE_FACTOR = 3.0
N_REPEATS = 2
KD_CLI_STEPS, KD_CLI_ROWS = 10, 64
MOJIBAKE = "café crème brûlée".encode("utf-8").decode("latin1")
MODULE = "opensearch_sparse_model_tuning_sample_torch.cli"


def dist_env(**extra):
    """The environment of a launched process: this checkout importable, no
    launch variables but `extra`, one host thread (the card does the work)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                        "OSSMT_COORDINATOR", "OSSMT_NUM_PROCESSES", "OSSMT_PROCESS_ID")}
    env.update(PYTHONPATH=HERE + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               **extra)
    return env


class Launched:
    """The processes of step 11, each logging to its own file; all are
    stopped at the end, whatever happened."""

    def __init__(self):
        self.procs = {}

    def start(self, name, cmd, cwd, env):
        os.makedirs(cwd, exist_ok=True)
        log = open(os.path.join(DIST, f"{name}.log"), "w")
        self.procs[name] = (subprocess.Popen(cmd, cwd=cwd, env=env, stdout=log,
                                             stderr=subprocess.STDOUT), log, time.time())

    def wait(self, name):
        """Wait for `name`; its exit code must be 0. Returns (log text, s)."""
        p, log, t0 = self.procs[name]
        try:
            rc = p.wait(timeout=max(1.0, t0 + DIST_TIMEOUT_S - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        seconds = time.time() - t0
        log.close()
        text = open(os.path.join(DIST, f"{name}.log")).read()
        if rc != 0:
            print(text[-4000:], flush=True)
        check(rc == 0, f"{name} exited {rc} after {seconds:.1f} s")
        return text, seconds

    def stop(self):
        for p, log, _ in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def logged_counts(text, rank):
    """The `rank r launch counts: {...}` line a CLI logs when it ends."""
    m = re.search(rf"rank {rank} launch counts: (\{{.*\}})", text)
    check(m is not None, f"rank {rank} logged its launch counts")
    return json.loads(m.group(1))


def dist_recipe(path, name, **over):
    """The main path's recipe with `over`, written as OUT/dist/<name>.yaml."""
    import yaml

    cfg = dict(path["cfg"], **over)
    p = os.path.join(DIST, f"{name}.yaml")
    with open(p, "w") as f:
        yaml.safe_dump(cfg, f)
    return p, cfg


def torchrun_cmd(yaml_path):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
            "-m", f"{MODULE}.train_ir", yaml_path]


def checkpoint_diff(a, b):
    """Max |w_a - w_b| over every tensor of two checkpoints, and max |w_a|."""
    from opensearch_sparse_model_tuning_sample_torch.models import hf_import

    _, sa, _ = hf_import.load_checkpoint(a)
    _, sb, _ = hf_import.load_checkpoint(b)
    check(sorted(sa) == sorted(sb), f"{a} and {b} hold the same tensors")
    diff = max(float((sa[k].float() - sb[k].float()).abs().max()) for k in sa)
    return diff, max(float(sa[k].float().abs().max()) for k in sa)


def ranking_losses(history, steps):
    by_step = {h["step"]: h["ranking_loss"] for h in history}
    check(all(s in by_step for s in steps), f"logged at steps {steps}")
    return [by_step[s] for s in steps]


def check_train_summary(summary, steps, gathers_per_step, what):
    """A torchrun run's run_summary.json: NCCL at world size 1, the gather
    and the gradient sum every step, each training kernel once a step, no
    plain version."""
    check(summary["backend"] == "nccl" and summary["world_size"] == 1
          and summary["device"] == "cuda:0", f"{what}: NCCL, world 1, cuda:0 ({summary['backend']}, "
          f"{summary['world_size']}, {summary['device']})")
    check(summary["steps"] == steps, f"{what}: {summary['steps']} steps")
    check(summary["collectives"] == {"all_gather_batch": gathers_per_step * steps,
                                     "all_reduce_grads": steps},
          f"{what}: the gather and the gradient sum ran every step: {summary['collectives']}")
    for k in STUDENT_KERNELS:
        check(summary["kernels"][k] == steps, f"{what}: {k} launched once a step "
              f"({summary['kernels'][k]})")
    check(not any(summary["plains"].values()), f"{what}: no plain version ran: "
          f"{summary['plains']}")


def mined_rows(path):
    import datasets as hfds

    return [dict(r) for r in hfds.Dataset.load_from_disk(path)]


def mining_diff(got, want, enc):
    """Rows of two minings as multisets of (query, pos, sorted negs). Rows
    that differ must differ only at a score tie: every neg in one row and
    not the other scores the row's cut-off (the lowest neg score), scored
    as the lexical index scores it (fp32 query, bf16 doc weights; every
    text encoded once, in batches)."""
    from collections import Counter, defaultdict

    def groups(rows):
        g = defaultdict(Counter)
        for r in rows:
            g[(r["query"], r["pos"])][tuple(sorted(r["negs"]))] += 1
        return g

    g_got, g_want = groups(got), groups(want)
    check(set(g_got) == set(g_want), "the same (query, pos) rows")
    pairs = []  # (query, negs of one, negs of the other)
    for key in g_want:
        if g_got[key] == g_want[key]:
            continue
        a, b = sorted(g_got[key].elements()), sorted(g_want[key].elements())
        check(len(a) == len(b), f"{key[0]!r}: as many rows")
        pairs += [(key[0], x, y) for x, y in zip(a, b) if x != y]
    if not pairs:
        return 0, 0.0

    def reps(texts, dtype):
        out = [enc.encode_batch_device(texts[i:i + 256], inf_free=True).to(dtype)
               for i in range(0, len(texts), 256)]
        return {t: i for i, t in enumerate(texts)}, torch.cat(out)

    q_pos, q_rep = reps(sorted({q for q, _, _ in pairs}), torch.float32)
    d_pos, d_rep = reps(sorted({t for _, x, y in pairs for t in x + y}), torch.bfloat16)
    worst = 0.0
    for q, negs_a, negs_b in pairs:
        texts = sorted(set(negs_a) | set(negs_b))
        s = (d_rep[[d_pos[t] for t in texts]].float() @ q_rep[q_pos[q]]).tolist()
        score = dict(zip(texts, s))
        cut = max(min(score[t] for t in negs_a), min(score[t] for t in negs_b))
        for t in set(negs_a) ^ set(negs_b):
            err = abs(score[t] - cut) / max(abs(cut), 1e-6)
            worst = max(worst, err)
            check(err <= 1e-5, f"{q!r}: a differing neg scores {score[t]:.6g}, the cut-off "
                  f"{cut:.6g}: not a tie")
    return len(pairs), worst


def kd_fixture(path, root):
    """An id-based hard-negative set from the main path's mined rows (the
    first KD_CLI_ROWS: the positive and 7 negatives, seeded decreasing
    scores, a first_rank column) as a `save_to_disk` dir, and a BEIR-format
    msmarco dir with their texts, one of them in mojibake."""
    import datasets as hfds

    rows = mined_rows(os.path.join(OUT, path["cfg"]["train_file"]))[:KD_CLI_ROWS]
    rng = np.random.default_rng(0)
    doc_ids, q_ids, hn = {}, {}, []
    for i, r in enumerate(rows):
        q_ids.setdefault(r["query"], f"q{len(q_ids)}")
        docs = [r["pos"]] + list(r["negs"][:7])
        for t in docs:
            doc_ids.setdefault(t, f"p{len(doc_ids)}")
        hn.append({"query": q_ids[r["query"]], "docs": [doc_ids[t] for t in docs],
                   "scores": sorted(rng.normal(size=len(docs)).astype(float) * 4, reverse=True),
                   "first_rank": int(rng.integers(0, 100))})
    fixed = rows[0]["pos"] + " café crème brûlée"
    texts = {pid: t for t, pid in doc_ids.items()}
    texts[doc_ids[rows[0]["pos"]]] = fixed.encode("utf-8").decode("latin1")
    ms = os.path.join(root, "msmarco")
    os.makedirs(os.path.join(ms, "qrels"), exist_ok=True)
    with open(os.path.join(ms, "corpus.jsonl"), "w", encoding="utf-8") as f:
        for pid, t in texts.items():
            f.write(json.dumps({"_id": pid, "title": "", "text": t}) + "\n")
    with open(os.path.join(ms, "queries.jsonl"), "w", encoding="utf-8") as f:
        for t, qid in q_ids.items():
            f.write(json.dumps({"_id": qid, "text": t}) + "\n")
    with open(os.path.join(ms, "qrels", "train.tsv"), "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for h in hn:
            f.write(f"{h['query']}\t{h['docs'][0]}\t1\n")
    hfds.Dataset.from_list(hn).save_to_disk(os.path.join(root, "hard_negatives"))
    return ms, os.path.join(root, "hard_negatives"), fixed, len(hn)


def phase_distributed(dev, path, n_docs, test_split):
    """Step 11: the multi-process launch. The launched processes run at
    once (the card has room for all five); the noise floor of 11a runs in
    this process meanwhile."""
    import datasets as hfds

    from opensearch_sparse_model_tuning_sample_torch.cli import prepare_msmarco, train_ir
    from opensearch_sparse_model_tuning_sample_torch.eval import trec_eval
    from opensearch_sparse_model_tuning_sample_torch.eval.beir import search as beir_search
    from opensearch_sparse_model_tuning_sample_torch.index.engine import SparseIndex
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se

    t_phase = time.time()
    shutil.rmtree(DIST, ignore_errors=True)
    os.makedirs(DIST)
    ckpt, cfg = path["ckpt"], path["cfg"]
    name = cfg["beir_datasets"].lower()
    # both ranks on the one card by request; torchrun's device from LOCAL_RANK
    rank_dev, run_dev = ("cuda:0", "cuda") if dev.type == "cuda" else ("cpu", "cpu")
    train_file = os.path.join(OUT, cfg["train_file"])
    run = Launched()
    try:
        # 11c first (the longest: each rank makes the train split on the host)
        mine_cwd = [os.path.join(DIST, f"mine_rank{r}") for r in range(2)]
        for r in range(2):
            run.start(f"mine_rank{r}", [sys.executable, "-m", f"{MODULE}.mine", path["path"],
                                        "--device", rank_dev, "--output_dir",
                                        os.path.join(DIST, "mine_out")],
                      mine_cwd[r], dist_env(RANK=str(r), WORLD_SIZE="2"))
        # 11b
        eval_out = os.path.join(DIST, "eval")
        for r in range(2):
            run.start(f"eval_rank{r}", [sys.executable, "-m", f"{MODULE}.evaluate_beir",
                                        path["path"], "--device", rank_dev, "--output_dir",
                                        eval_out, "--model_name_or_path", ckpt,
                                        "--tokenizer_name", ckpt],
                      DIST, dist_env(RANK=str(r), WORLD_SIZE="2",
                                     METRICS_DIR=os.path.join(DIST, "metrics")))
        # 11a: the main path's recipe and data; the device from LOCAL_RANK
        a_yaml, a_cfg = dist_recipe(path, "torchrun", device=run_dev, train_file=train_file,
                                    save_steps=TRAIN_STEPS,
                                    output_dir=os.path.join(DIST, "torchrun"))
        run.start("torchrun", torchrun_cmd(a_yaml), DIST, dist_env())
        # 11d: the data CLIs, then kd training on their output under torchrun
        root = os.path.join(DIST, "kd_cli")
        ms, hn, fixed, n_rows = kd_fixture(path, root)
        t0 = time.time()
        prep_rows = prepare_msmarco.main(["--hard-negatives", hn, "--msmarco-dir", ms,
                                          "--out", os.path.join(root, "msmarco_ft")])
        prep_s = time.time() - t0
        check(len(prep_rows) == n_rows and fixed in prep_rows[0]["docs"]
              and not any(MOJIBAKE in d for r in prep_rows for d in r["docs"]),
              "cli.prepare_msmarco joined the texts and repaired the mojibake")
        d_yaml, d_cfg = dist_recipe(
            path, "kd_cli", device=run_dev, data_type="kd", loss_types=["kldiv"],
            use_in_batch_negatives=False, sample_num_one_query=2, first_rank_thresh=80,
            train_file=os.path.join(root, "msmarco_ft"), max_steps=KD_CLI_STEPS, warmup_steps=2,
            logging_steps=1, save_steps=KD_CLI_STEPS, output_dir=os.path.join(DIST, "kd_train"))
        run.start("kd_torchrun", torchrun_cmd(d_yaml), DIST, dist_env())

        # the noise floor: the main path's run again, twice, in this process
        t0 = time.time()
        repeats = []
        for i in range(N_REPEATS):
            r_yaml, r_cfg = dist_recipe(path, f"repeat{i}", train_file=train_file,
                                        save_steps=TRAIN_STEPS,
                                        output_dir=os.path.join(DIST, f"repeat{i}"))
            repeats.append((train_ir.main(r_yaml).log_history,
                            os.path.join(r_cfg["output_dir"], f"checkpoint-{TRAIN_STEPS}")))
        repeat_s = time.time() - t0
        waited = {proc: run.wait(proc) for proc in
                  ("torchrun", "kd_torchrun", "eval_rank0", "eval_rank1", "mine_rank0",
                   "mine_rank1")}
    finally:
        run.stop()
    wall_s = time.time() - t_phase
    out = {"seconds_by_process": {k: v[1] for k, v in waited.items()},
           "prepare_msmarco_s": prep_s, "repeat_train_s": repeat_s}

    # 11a against the main path, within the run-to-run spread
    steps = [1, TRAIN_STEPS]
    summary = json.load(open(os.path.join(a_cfg["output_dir"], "run_summary.json")))
    check_train_summary(summary, TRAIN_STEPS, 2, "11a torchrun")
    runs = [(path["trainer"].log_history, ckpt)] + repeats  # the one-process runs
    losses = [ranking_losses(h, steps) for h, _ in runs]
    main_loss, rep_loss = losses[0], losses[1:]
    dist_loss = ranking_losses(summary["log_history"], steps)
    pairs = [(i, j) for i in range(len(runs)) for j in range(i + 1, len(runs))]
    floor_loss = max(max(abs(a - b) for a, b in zip(losses[i], losses[j])) for i, j in pairs)
    floor_w = max(checkpoint_diff(runs[i][1], runs[j][1])[0] for i, j in pairs)
    dist_loss_d = max(abs(a - b) for a, b in zip(dist_loss, main_loss))
    dist_w, w_max = checkpoint_diff(
        os.path.join(a_cfg["output_dir"], f"checkpoint-{TRAIN_STEPS}"), ckpt)
    out["11a"] = {"ranking_loss": {"main": main_loss, "repeats": rep_loss, "torchrun": dist_loss},
                  "noise_floor": {"loss": floor_loss, "weights": floor_w},
                  "torchrun_diff": {"loss": dist_loss_d, "weights": dist_w}, "w_max": w_max,
                  "collectives": summary["collectives"], "kernels": summary["kernels"]}
    print(f"11a torchrun (NCCL, world 1, cuda:0 from LOCAL_RANK): {TRAIN_STEPS} steps; ranking "
          f"loss at steps {steps} {dist_loss} against the main path's {main_loss} (repeats "
          f"{rep_loss}); |diff| {dist_loss_d:.3g} against the noise floor {floor_loss:.3g}; "
          f"checkpoint-{TRAIN_STEPS} max |diff| {dist_w:.3g} against the floor {floor_w:.3g} "
          f"(max |w| {w_max:.3g}); collectives {summary['collectives']}; kernels "
          f"{summary['kernels']}", flush=True)
    check(dist_loss_d <= NOISE_FACTOR * floor_loss,
          f"11a ranking loss within {NOISE_FACTOR:g} x the noise floor")
    check(dist_w <= NOISE_FACTOR * floor_w,
          f"11a checkpoint weights within {NOISE_FACTOR:g} x the noise floor")

    # 11b: two ranks' ingest, merged by rank 0, against the main path's eval
    texts = [waited[f"eval_rank{r}"][0] for r in range(2)]
    counts = [logged_counts(t, r) for r, t in enumerate(texts)]
    per_rank = [-(-len(range(r, n_docs, 2)) // cfg["per_device_eval_batch_size"])
                for r in range(2)]
    for r in range(2):
        k = counts[r]["kernels"]["maxpool_head"]
        check(per_rank[r] <= k <= 1.1 * per_rank[r],
              f"11b rank {r}: the ingest kernel for each of its {per_rank[r]} batches ({k})")
        check(not any(counts[r]["plains"].values()), f"11b rank {r}: no plain version")
        check_attention(counts[r]["attention"], ckpt_layers(ckpt), k, f"11b rank {r}")
    eval_dir = os.path.join(eval_out, "beir_eval")
    avg = json.load(open(os.path.join(eval_dir, "avg_res.json")))
    merged = SparseIndex.load(os.path.join(eval_dir, f"{name}.index"), device=dev)
    corpus, queries, qrels = test_split
    check(merged.n_docs == n_docs and sorted(merged.doc_ids) == sorted(corpus),
          f"11b: the merged index holds the corpus's {n_docs} doc ids")
    single = SparseIndex.load(os.path.join(cfg["output_dir"], "beir_eval", f"{name}.index"),
                              device=dev)
    model = se.build_model(model_name_or_path=ckpt, device=dev)
    k_values = [1, 10, 100]
    metrics = {}
    for which, index in (("two_ranks", merged), ("one_process", single)):
        res = beir_search(queries, model, index, os.path.join(cfg["output_dir"], "beir_eval"),
                          name, max_length=512, batch_size=50, result_size=100)
        ndcg, _map, recall, _ = trec_eval.evaluate(qrels, res["run_res"], k_values)
        metrics[which] = {**ndcg, **_map, **recall}
    stat_rel = abs(avg["flops"] - path["avg"]["flops"]) / path["avg"]["flops"]
    d_rel = abs(avg["d_length"] - path["avg"]["d_length"]) / path["avg"]["d_length"]
    metric_d = max(abs(metrics["two_ranks"][k] - metrics["one_process"][k])
                   for k in metrics["one_process"])
    avg_d = max(abs(avg[k] - path["avg"][k]) for k in ("NDCG@10", "Recall@100"))
    out["11b"] = {"launches": [c["kernels"]["maxpool_head"] for c in counts],
                  "attention": [c["attention"] for c in counts],
                  "flops_rel_diff": stat_rel, "d_length_rel_diff": d_rel,
                  "avg_res_max_diff": avg_d, "metrics_max_diff": metric_d,
                  "metrics": metrics["two_ranks"], "avg": avg}
    print(f"11b two cli.evaluate_beir ranks on cuda:0: maxpool_head launches "
          f"{out['11b']['launches']} (batches {per_rank}), plain 0; merged index {merged.n_docs} "
          f"docs; FLOPS {avg['flops']:.6f} against {path['avg']['flops']:.6f} (rel "
          f"{stat_rel:.3g}); NDCG@10/Recall@100 max |diff| {avg_d:.3g}; NDCG, MAP, Recall at "
          f"{k_values} on the merged index against the one-process index max |diff| "
          f"{metric_d:.3g}", flush=True)
    check(stat_rel <= 1e-6 and d_rel <= 1e-6, "11b: the corpus FLOPS statistic equals step 5's")
    check(avg_d <= 1e-4 and metric_d <= 1e-4, "11b: NDCG, MAP and Recall equal step 5's")
    del merged, single, model
    torch.cuda.empty_cache()

    # 11c: two cli.mine ranks against the main path's mining
    m_texts = [waited[f"mine_rank{r}"][0] for r in range(2)]
    m_counts = [logged_counts(t, r) for r, t in enumerate(m_texts)]
    check(not any(c["plains"][k] for c in m_counts for k in c["plains"]),
          "11c: no plain version ran")
    check(not os.path.exists(os.path.join(mine_cwd[1], "data")), "11c: rank 1 wrote no rows")
    got = mined_rows(os.path.join(mine_cwd[0], cfg["train_file"]))
    want = mined_rows(train_file)
    check(len(got) == len(want), f"11c: {len(got)} rows, step 5 mined {len(want)}")
    mine_model = se.build_model(arch=cfg["arch"], idf_path=cfg["idf_path"], device=dev)
    t0 = time.time()
    n_diff, tie_err = mining_diff(got, want, se.BatchEncoder(mine_model, max_length=512))
    tie_s = time.time() - t0
    out["11c"] = {"rows": len(got), "rows_differing": n_diff, "tie_rel_err": tie_err,
                  "tie_check_s": tie_s,
                  "launches": [c["kernels"] for c in m_counts]}
    print(f"11c two cli.mine ranks on cuda:0: rank 0 wrote {len(got)} rows, rank 1 none; "
          f"{len(got) - n_diff} equal step 5's as a multiset, {n_diff} differ only at an exact "
          f"score tie at the cut-off (scores within {tie_err:.3g}: the merged index lists rank "
          f"0's stripe first, so a tie takes another doc); launches "
          f"{m_counts[0]['kernels']} / {m_counts[1]['kernels']} (the lexical mining index "
          f"needs no kernel)", flush=True)
    del mine_model

    # 11d: the data CLIs and kd training on their rows
    summary = json.load(open(os.path.join(d_cfg["output_dir"], "run_summary.json")))
    check_train_summary(summary, KD_CLI_STEPS, 3, "11d kd torchrun")
    hist = summary["log_history"]
    check([h["step"] for h in hist] == list(range(1, KD_CLI_STEPS + 1))
          and all(np.isfinite(v) for h in hist for v in h.values()),
          "11d: a finite kldiv loss at every step")
    saved = hfds.Dataset.load_from_disk(os.path.join(root, "msmarco_ft"))
    check(saved.num_rows == n_rows and "first_rank" in saved.column_names, "11d: the kd rows")
    out["11d"] = {"rows": n_rows, "log": hist, "collectives": summary["collectives"],
                  "kernels": summary["kernels"]}
    print(f"11d cli.prepare_msmarco: {n_rows} rows in {prep_s:.1f} s, mojibake repaired; kd "
          f"(kldiv on the dataset's scores) under torchrun: {KD_CLI_STEPS} steps, loss "
          f"{hist[0]['ranking_loss']:.5f} -> {hist[-1]['ranking_loss']:.5f}; collectives "
          f"{summary['collectives']}; kernels {summary['kernels']}", flush=True)
    out["seconds"] = time.time() - t_phase
    out["launch_wall_s"] = wall_s
    print(f"distributed phase {out['seconds']:.1f} s (launched processes "
          + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds_by_process"].items())
          + f"; the {N_REPEATS} repeat runs {repeat_s:.1f} s)", flush=True)
    return out


# step 12, the device mesh inside one process: four mesh positions (four
# cards when four are visible, else four stripes on this card), each layout
# held to an unsharded index of the same rows on the same card
MESH_POSITIONS = 4
MESH_DOCS = 1 << 21  # bench.py's production-size corpus (bench.py:226-239)
MESH_QUERIES = 512
MESH_K = 10
# the scans add the same fp32 products per row in the same order on the
# same card, so their scores are expected bit-equal; where they are not,
# the step says so and holds them to this
MESH_SCAN_RTOL = 1e-6
MESH_INV_RTOL = 1e-5  # the certified inverted engine against the exact scan


class MeshCorpus:
    """bench.py's 2 097 152-doc corpus made in a process of its own, started
    when the script starts: making it takes about a minute of numpy sorts
    on one host core, which then overlaps steps 1-11 (the card is idle in
    it). Step 12b waits for the arrays (saved as .npy under OUT)."""

    def __init__(self):
        self.dir = os.path.join(OUT, "mesh")
        self.proc = None

    def start(self):
        os.makedirs(self.dir, exist_ok=True)
        code = ("import json, sys, time\n"
                "import numpy as np\n"
                f"sys.path.insert(0, {HERE!r})\n"
                "from bench import make_corpus\n"
                "t0 = time.perf_counter()\n"
                f"toks, ws = make_corpus({MESH_DOCS}, {BIG_VOCAB}, avg_terms=80, seed=2, "
                "l_max=96)\n"
                "s = time.perf_counter() - t0\n"
                f"np.save({os.path.join(self.dir, 'toks.tmp.npy')!r}, toks)\n"
                f"np.save({os.path.join(self.dir, 'ws.tmp.npy')!r}, ws)\n"
                "print(json.dumps({'seconds': s}))\n")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen([sys.executable, "-c", code], cwd=HERE, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.t0 = time.time()
        return self

    def result(self, timeout=600):
        """(toks, ws, seconds making them, seconds waited for them)."""
        t0 = time.time()
        out = self.proc.communicate(timeout=timeout)[0]
        waited = time.time() - t0
        check(self.proc.returncode == 0, f"the corpus process failed: {out[-2000:]}")
        seconds = json.loads(out.strip().splitlines()[-1])["seconds"]
        toks = np.load(os.path.join(self.dir, "toks.tmp.npy"))
        ws = np.load(os.path.join(self.dir, "ws.tmp.npy"))
        for f in ("toks.tmp.npy", "ws.tmp.npy"):
            os.remove(os.path.join(self.dir, f))
        return toks, ws, seconds, waited

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def make_mesh_for(dev):
    """make_mesh(4) over four visible cards, else four positions on `dev`."""
    from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh

    if dev.type == "cuda" and torch.cuda.device_count() >= MESH_POSITIONS:
        return make_mesh(MESH_POSITIONS), f"make_mesh({MESH_POSITIONS}): one stripe per card"
    return (make_mesh(devices=[dev] * MESH_POSITIONS),
            f"make_mesh(devices=[{dev}] * {MESH_POSITIONS}): the stripes share one card")


def topk_arrays(index, q, k, two_phase=None):
    """The index's raw (scores, global ids) of q's rows as numpy, batch by
    batch through its layout's scan (`two_phase`: None or a mode)."""
    parts = [index._scan(q[i:i + index._query_batch], k, two_phase)
             for i in range(0, q.shape[0], index._query_batch)]
    return (torch.cat([p[0] for p in parts]).cpu().numpy(),
            torch.cat([p[1] for p in parts]).cpu().numpy())


def same_arrays(got, want, rtol, what):
    """(bit-equal, max relative score difference) of two (scores, ids)
    pairs; ids must be equal, scores within rtol."""
    (gs, gi), (ws, wi) = got, want
    check(np.array_equal(gi, wi), f"{what}: ids equal the unsharded index's")
    fin = np.isfinite(ws)
    check(np.array_equal(np.isfinite(gs), fin), f"{what}: the same empty slots")
    rel = float(np.max(np.abs(gs[fin] - ws[fin]) / np.maximum(np.abs(ws[fin]), 1e-30),
                       initial=0.0))
    check(rel <= rtol, f"{what}: scores within {rtol:g} relative ({rel:.3g})")
    return bool(np.array_equal(gs, ws)), rel


def same_hits(got, want, what):
    check(len(got) == len(want) and all(list(g.items()) == list(w.items())
                                        for g, w in zip(got, want)), f"{what}: the same answers")


def timed_call(index, q_tok, q_w):
    """One checked search_tokens call (its answers and flags), then the host
    time of two more (each ends in the copy to the host), the host copies a
    call makes, and the card's busy share of one call from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    syncs = index.host_syncs
    hits = index.search_tokens(q_tok, q_w, k=MESH_K)
    flags = (index.last_certified.copy(), index.last_escalated.copy(),
             index.last_scan_escalated.copy())
    syncs = index.host_syncs - syncs
    t0 = time.perf_counter()
    for _ in range(2):
        index.search_tokens(q_tok, q_w, k=MESH_K)
    call_ms = (time.perf_counter() - t0) / 2 * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        index.search_tokens(q_tok, q_w, k=MESH_K)
    prof_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    # the busy share against the call's time without the profiler (tracing
    # every launch slows the host down)
    return hits, flags, {"host_syncs_per_call": syncs, "call_ms": call_ms,
                         "profiled_call_ms": prof_ms, "busy_ms": busy_ms,
                         "busy_share": busy_ms / call_ms,
                         "ops_per_call": sum(e.count for e in on_card)}


def built(devs, make):
    """(index, seconds, resident bytes, peak bytes) of make(), summed over
    the cards `devs` (torch.cuda.memory_allocated and
    max_memory_allocated)."""
    devs = sorted(set(devs), key=str)
    for d in devs:
        torch.cuda.synchronize(d)
    torch.cuda.empty_cache()
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    base = [torch.cuda.memory_allocated(d) for d in devs]
    t0 = time.perf_counter()
    index = make()
    for d in devs:
        torch.cuda.synchronize(d)
    seconds = time.perf_counter() - t0
    return (index, seconds, sum(torch.cuda.memory_allocated(d) - b for d, b in zip(devs, base)),
            sum(torch.cuda.max_memory_allocated(d) - b for d, b in zip(devs, base)))


def mesh_scan(dev, mesh):
    """12a: the scan of `big`'s 131 072 rows, unsharded, doc-sharded and
    query-sharded; per-stripe two-phase against four unsharded indexes of
    the stripes; the token entry; save and load with and without the mesh."""
    from bench import make_corpus, make_queries
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex
    from opensearch_sparse_model_tuning_sample_torch.parallel.collectives import merged_topk

    t0 = time.time()
    toks, ws = make_corpus(BIG_DOCS, BIG_VOCAB, avg_terms=110, seed=1, l_max=128)
    q_tok, q_w = make_queries(MESH_QUERIES, BIG_VOCAB, n_terms=6, seed=3)
    ids = [str(i) for i in range(BIG_DOCS)]
    # big's configuration (build_big_index), on the exact scan
    cfg = dict(engine="sparse", l_max=128, block_docs=2048, two_phase_mode="doc")

    def index(rows=(toks, ws), ids=ids, shard_by="docs", **place):
        ix = SparseIndex(BIG_VOCAB, IndexConfig(**cfg, shard_by=shard_by), **place)
        ix.add_topk(ids, *rows)
        ix.finalize()
        return ix

    single = index(device=dev)
    q = single._token_query(q_tok, q_w)
    want = topk_arrays(single, q, MESH_K)
    want_hits = single.search(q, k=MESH_K)
    out = {}
    for shard_by in ("docs", "queries"):
        ix = index(mesh=mesh, shard_by=shard_by)
        bit, rel = same_arrays(topk_arrays(ix, q, MESH_K), want, MESH_SCAN_RTOL,
                               f"12a {shard_by}-sharded scan")
        got = ix.search(q, k=MESH_K)
        check(all(list(g) == list(w) for g, w in zip(got, want_hits)),
              f"12a {shard_by}-sharded scan: search() ids equal the unsharded")
        out[shard_by] = {"bit_equal": bit, "max_rel": rel}
        if shard_by == "docs":
            sharded = ix
    # two-phase "doc" per stripe, against an independent composition: four
    # unsharded indexes of the stripes, two-phase on each, ids offset, merged
    offs = [st.offset for st in sharded._stripes]
    check(len(offs) == MESH_POSITIONS and offs[1] * MESH_POSITIONS >= BIG_DOCS,
          f"12a: {MESH_POSITIONS} doc stripes ({offs})")
    parts = [index(rows=(toks[o:o + offs[1]], ws[o:o + offs[1]]), ids=ids[o:o + offs[1]],
                   device=dev) for o in offs]
    comp_s, comp_i = [], []
    for b0 in range(0, MESH_QUERIES, sharded._query_batch):
        qb = q[b0:b0 + sharded._query_batch]
        res = [p._scan(qb, MESH_K, "doc") for p in parts]
        s_, i_ = merged_topk([r[0] for r in res],
                             [torch.where(r[1] >= 0, r[1] + o, -1)
                              for o, r in zip(offs, res)], MESH_K)
        comp_s.append(s_)
        comp_i.append(i_)
    comp = (torch.cat(comp_s).cpu().numpy(), torch.cat(comp_i).cpu().numpy())
    tp = topk_arrays(sharded, q, MESH_K, "doc")
    bit_tp, rel_tp = same_arrays(tp, comp, MESH_SCAN_RTOL, "12a doc-sharded two-phase")
    exact_overlap = float(np.mean([len(set(a) & set(b)) / max(len(b), 1) for a, b in zip(
        tp[1].tolist(), want[1].tolist())]))
    # the token entry on a mesh densifies and takes the mesh path
    same_hits(sharded.search_tokens(q_tok, q_w, k=MESH_K), sharded.search(q, k=MESH_K),
              "12a doc-sharded search_tokens against its dense entry")
    path = os.path.join(OUT, "mesh", "scan.index")
    sharded.save(path)
    want_hits = sharded.search(q, k=MESH_K)
    loaded_mesh = SparseIndex.load(path, mesh=mesh)
    check(loaded_mesh._stripes is not None, "12a: load(path, mesh) is doc-sharded")
    same_hits(loaded_mesh.search(q, k=MESH_K), want_hits, "12a load(path, mesh)")
    same_hits(SparseIndex.load(path, device=dev).search(q, k=MESH_K), want_hits,
              "12a load(path)")
    out.update(two_phase={"bit_equal": bit_tp, "max_rel": rel_tp,
                          "overlap_with_exact": exact_overlap},
               seconds=time.time() - t0)
    def scores(r):
        return "bit-equal" if r["bit_equal"] else f"within {r['max_rel']:.3g} relative"

    print(f"12a {BIG_DOCS}-doc scan, {MESH_QUERIES} queries, k={MESH_K}: doc-sharded ids equal "
          f"the unsharded scan's, scores {scores(out['docs'])}; query-sharded ids equal, "
          f"scores {scores(out['queries'])}; per-stripe two-phase (doc) ids equal the "
          f"composition of {MESH_POSITIONS} unsharded stripe indexes (scores "
          f"{scores(out['two_phase'])}; top-{MESH_K} overlap with exact "
          f"{exact_overlap:.4f}); search_tokens equals the dense "
          f"entry; save -> load(mesh) -> load() the same answers; {out['seconds']:.1f} s",
          flush=True)
    del single, sharded, parts, loaded_mesh, q
    torch.cuda.empty_cache()
    return out


def mesh_big(dev, mesh, corpus):
    """12b: bench.py's 2 097 152-doc corpus (from `corpus`, a MeshCorpus) on
    bench's inverted configuration with exact escalation, doc- and
    query-sharded over the mesh; every answer held to the unsharded exact
    scan's."""
    from bench import make_queries
    from opensearch_sparse_model_tuning_sample_torch.index import inverted
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex

    t0 = time.time()
    toks, ws, corpus_s, corpus_wait_s = corpus.result()
    check(toks.shape == (MESH_DOCS, 96), f"the corpus is bench.py's ({toks.shape})")
    load_s = time.time() - t0
    q_tok, q_w = make_queries(MESH_QUERIES, BIG_VOCAB, n_terms=6, seed=3)
    ids = [str(i) for i in range(MESH_DOCS)]
    # bench.py:228-239's inverted configuration (its query batch, 128)
    inv_cfg = dict(engine="inverted", l_max=96, block_docs=4096, query_batch=128,
                   weight_dtype="bfloat16", postings_cap=8192, query_terms=8,
                   inverted_rescore_expand=16, exact_escalate=True, postings_ext_cap=24576,
                   deep_slots=0, deep_escalate=True, incremental_postings=False)

    def make(cfg, **place):
        def go():
            ix = SparseIndex(BIG_VOCAB, IndexConfig(**cfg), **place)
            ix.add_topk(ids, toks, ws)
            ix.finalize()
            return ix
        return go

    scan_cfg = dict(engine="sparse", l_max=96, block_docs=4096, query_batch=128,
                    weight_dtype="bfloat16")
    scan, scan_s, scan_bytes, _ = built([dev], make(scan_cfg, device=dev))
    t1 = time.perf_counter()
    want = scan.search_tokens(q_tok, q_w, k=MESH_K)
    scan_ms = (time.perf_counter() - t1) * 1e3
    del scan
    torch.cuda.empty_cache()
    out = {"corpus_s": corpus_s, "corpus_wait_s": corpus_wait_s, "corpus_load_s": load_s,
           "scan": {"build_s": scan_s, "resident_bytes": scan_bytes,
                                          "call_ms": scan_ms}}
    for shard_by in ("docs", "queries"):
        ix, build_s, resident, peak = built(
            mesh.devices, make(dict(inv_cfg, shard_by=shard_by), mesh=mesh))
        t1 = time.perf_counter()
        hits, (cert, esc, scan_esc), timing = timed_call(ix, q_tok, q_w)
        timing["calls_s"] = time.perf_counter() - t1
        n_hits = check_same_topk(hits, want, f"12b {shard_by}-sharded", rtol=MESH_INV_RTOL)
        check(cert.all(), f"12b {shard_by}-sharded: every query certified after escalation")
        check(np.array_equal(esc, scan_esc), f"12b {shard_by}-sharded: escalation goes straight "
              "to the mesh's exact scan (no deep tier on a mesh)")
        # the escalated rows are the base pass's uncertified ones, but where
        # the k-th score and the bound lie within 2 CERT_MARGIN
        q = ix._token_query(q_tok, q_w)
        fns = ix._inverted_fns(MESH_K, False, "inverted")
        s, _, b = ix._in_batches(fns.base, q, fns.batch)
        kth, b = s[:, -1].float().cpu().numpy(), b.float().cpu().numpy()
        base_cert = inverted.certified_mask(kth, b) | ((q_w > 0).sum(axis=1) == 0)
        with np.errstate(invalid="ignore"):
            band = np.abs(kth - b) <= 2 * inverted.CERT_MARGIN * np.maximum(np.abs(kth),
                                                                              np.abs(b))
        off = (esc != ~base_cert) & ~band
        check(not off.any(), f"12b {shard_by}-sharded: escalated rows are the uncertified ones "
              f"outside 2 CERT_MARGIN ({int(off.sum())} differ)")
        timing["checks_s"] = time.perf_counter() - t1 - timing["calls_s"]
        out[shard_by] = dict(
            timing, build_s=build_s, resident_bytes=resident, build_peak_bytes=peak,
            postings_source=ix.postings_source, hits=n_hits,
            certified_before_escalation=float(1 - esc.mean()), escalated=int(esc.sum()),
            escalated_in_band=int((esc & band).sum()))
        t1 = time.perf_counter()
        del ix, q, s, b
        torch.cuda.empty_cache()
        out[shard_by]["free_s"] = time.perf_counter() - t1
    out["seconds"] = time.time() - t0
    for shard_by in ("docs", "queries"):
        r = out[shard_by]
        print(f"12b {MESH_DOCS}-doc inverted ({shard_by}-sharded, exact escalation): all "
              f"{MESH_QUERIES} answers equal the unsharded exact scan's ({r['hits']} hits, "
              f"rtol {MESH_INV_RTOL:g}); certified before escalation "
              f"{r['certified_before_escalation']:.4f}, {r['escalated']} rows escalated; host "
              f"syncs a call {r['host_syncs_per_call']}; a {MESH_QUERIES}-query call "
              f"{r['call_ms']:.1f} ms (host clock), busy {r['busy_ms']:.1f} ms "
              f"({r['busy_share']:.3f}; {r['profiled_call_ms']:.1f} ms profiled) over "
              f"{r['ops_per_call']} device operations; build {r['build_s']:.1f} s (postings "
              f"{r['postings_source']}), the calls {r['calls_s']:.1f} s, checks "
              f"{r['checks_s']:.1f} s, freeing {r['free_s']:.1f} s; "
              f"index on the card {r['resident_bytes'] / 2**30:.3f} GiB (peak during the build "
              f"{r['build_peak_bytes'] / 2**30:.3f} GiB)", flush=True)
    print(f"12b corpus made in {corpus_s:.1f} s by a process started with the script (waited "
          f"{corpus_wait_s:.1f} s, loaded in {load_s:.1f} s); unsharded exact scan: build {scan_s:.1f} s, "
          f"{scan_bytes / 2**30:.3f} GiB, a {MESH_QUERIES}-query call {scan_ms:.1f} ms; step "
          f"{out['seconds']:.1f} s", flush=True)
    return out


def mesh_eval(dev, mesh, path, test_split):
    """12c: eval.beir.evaluate_datasets of checkpoint-50 with the index over
    the mesh, doc-sharded on the scan and on the inverted engine with
    escalation; launches read around each; metrics against the main path's
    unsharded evaluation."""
    from opensearch_sparse_model_tuning_sample_torch.core.config import parse_config
    from opensearch_sparse_model_tuning_sample_torch.eval import beir, trec_eval
    from opensearch_sparse_model_tuning_sample_torch.index.engine import SparseIndex
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se

    t0 = time.time()
    corpus, queries, qrels = test_split
    ckpt, cfg = path["ckpt"], path["cfg"]
    name = cfg["beir_datasets"].lower()
    run_cfg = dict(cfg, model_name_or_path=ckpt, tokenizer_name=ckpt, device=str(dev))
    ma, _, ta = parse_config(dict(run_cfg))
    model = se.from_model_args(ma, seed=ta.seed, device=dev)  # as cli.evaluate_beir builds it
    one_dir = os.path.join(cfg["output_dir"], "beir_eval")
    single = SparseIndex.load(os.path.join(one_dir, f"{name}.index"), device=dev)
    k_values = [1, 10, 100]

    def metrics(index):
        res = beir.search(queries, model, index, one_dir, name, max_length=512,
                          batch_size=50, result_size=100)
        ndcg, _map, recall, _ = trec_eval.evaluate(qrels, res["run_res"], k_values)
        return {**ndcg, **_map, **recall}

    want = metrics(single)
    n_batches = -(-len(corpus) // cfg["per_device_eval_batch_size"])
    out = {}
    for run, over in (("docs_scan", {"index_engine": "sparse"}),
                      ("docs_inverted", {"index_engine": "inverted",
                                         "index_exact_escalate": True})):
        ma, da, ta = parse_config(dict(run_cfg, output_dir=os.path.join(OUT, "mesh", run),
                                       index_shard_by="docs", **over))
        captured = {}
        orig = beir.ingest

        def ingest(*a, **kw):
            captured["index"] = orig(*a, **kw)
            return captured["index"]

        beir.ingest = ingest
        t1 = time.time()
        reset_counters()
        try:
            avg = beir.evaluate_datasets([cfg["beir_datasets"]], lambda n: test_split, model, ma,
                                         da, ta, os.path.join(ta.output_dir, "beir_eval"),
                                         mesh=mesh)
        finally:
            beir.ingest = orig
        launches, plain = read_counters()
        attention = read_attention()
        seconds = time.time() - t1
        index = captured["index"]
        check(index.mesh is mesh and index._stripes is not None and not index._shard_queries,
              f"12c {run}: the eval's index is doc-sharded over the mesh")
        check(launches["maxpool_head"] == n_batches,
              f"12c {run}: {launches['maxpool_head']} maxpool_head launches for {n_batches} "
              "ingest batches")
        check(not any(plain.values()), f"12c {run}: no plain version ran: {plain}")
        check_attention(attention, ckpt_layers(ckpt), launches["maxpool_head"],
                        f"12c {run}")
        got = metrics(index)
        avg_d = {k: abs(avg[k] - path["avg"][k]) for k in path["avg"] if k != "qps"}
        met_d = max(abs(got[k] - want[k]) for k in want)
        check(all(v == 0 for v in avg_d.values()),
              f"12c {run}: NDCG@10, Recall@100 and FLOPS equal the unsharded eval's: {avg_d}")
        check(met_d == 0, f"12c {run}: NDCG, MAP and Recall at {k_values} equal ({met_d:.3g})")
        if over["index_engine"] == "inverted":
            check(avg["certified_frac"] == 1.0, f"12c {run}: every query certified")
        out[run] = {"launches": launches["maxpool_head"], "attention": attention,
                    "seconds": seconds,
                    "avg": avg, "metrics_max_diff": met_d, "engine": index._engine,
                    "postings_source": index.postings_source}
        print(f"12c evaluate_datasets over the mesh ({run}): {len(corpus)} docs, maxpool_head "
              f"launches {launches['maxpool_head']} (plain 0), NDCG@10 {avg['NDCG@10']:.5f}, "
              f"FLOPS {avg['flops']:.6f}: equal to the unsharded eval; NDCG, MAP and Recall at "
              f"{k_values} of a search of the mesh index equal the unsharded index's; search "
              f"{avg['qps']:.1f} q/s; {seconds:.1f} s", flush=True)
        del index, captured
    out["seconds"] = time.time() - t0
    del single, model
    torch.cuda.empty_cache()
    return out


def mesh_merge(dev, mesh):
    """12d: step 11b's two shard dirs merged onto the mesh, against their
    unsharded merge."""
    from bench import make_queries
    from opensearch_sparse_model_tuning_sample_torch.index.engine import SparseIndex

    t0 = time.time()
    eval_dir = os.path.join(DIST, "eval", "beir_eval")
    shards = sorted(os.path.join(eval_dir, d) for d in os.listdir(eval_dir)
                    if ".index.shard" in d and d.endswith("of2"))
    check(len(shards) == 2, f"12d: step 11b's two shard dirs ({shards})")
    onto = SparseIndex.merge_saved(shards, mesh=mesh)
    flat = SparseIndex.merge_saved(shards, device=dev)
    check(onto._stripes is not None and onto.doc_ids == flat.doc_ids,
          "12d: merge_saved onto the mesh is doc-sharded, with the merged ids")
    q_tok, q_w = make_queries(MESH_QUERIES, BIG_VOCAB, n_terms=6, seed=3)
    got, want = onto.search_tokens(q_tok, q_w, k=100), flat.search_tokens(q_tok, q_w, k=100)
    same_hits(got, want, "12d merge_saved(mesh) against the unsharded merge")
    out = {"docs": onto.n_docs, "hits": sum(len(h) for h in got), "seconds": time.time() - t0}
    print(f"12d merge_saved of step 11b's {len(shards)} shards onto the mesh: {onto.n_docs} docs; "
          f"{MESH_QUERIES} token queries, top-100 equal to the unsharded merge's "
          f"({out['hits']} hits); {out['seconds']:.1f} s", flush=True)
    del onto, flat
    torch.cuda.empty_cache()
    return out


def phase_mesh(dev, path, test_split, corpus):
    """Step 12: the device mesh inside one process."""
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    t0 = time.time()
    mesh, how = make_mesh_for(dev)
    print(f"mesh: {how}; devices {[str(d) for d in mesh.devices]}", flush=True)
    merges = tracing.counters().get("collectives.merged_topk", 0)
    out = {"mesh": how, "devices": [str(d) for d in mesh.devices]}
    out["12a"] = mesh_scan(dev, mesh)
    out["12b"] = mesh_big(dev, mesh, corpus)
    out["12c"] = mesh_eval(dev, mesh, path, test_split)
    out["12d"] = mesh_merge(dev, mesh)
    out["merged_topk_calls"] = tracing.counters().get("collectives.merged_topk", 0) - merges
    out["seconds"] = time.time() - t0
    print(f"mesh phase {out['seconds']:.1f} s (12a {out['12a']['seconds']:.1f}, 12b "
          f"{out['12b']['seconds']:.1f}, 12c {out['12c']['seconds']:.1f}, 12d "
          f"{out['12d']['seconds']:.1f}); merged_topk calls {out['merged_topk_calls']}",
          flush=True)
    return out



# step 13, training over the mesh: the infonce recipe's full-width mini
# student (per-device batch 15, docs at the L = 64 bucket as in step 5) over
# make_mesh_for's four positions against one position at the global batch,
# from the same weights with dropout off (the positions draw their own
# masks); a kd step of the kd recipe; a step with A = 2
MESH_TRAIN_DIR = os.path.join(OUT, "mesh_train")
MESH_TRAIN_STEPS = 5
MESH_LOSS_RTOL = 1e-3  # bf16 encoders at other GEMM shapes: the first step's loss
MESH_TIMED_STEPS = 5


def no_dropout(model):
    """The model with its dropout probabilities set to 0 (every module's
    config; replicas made later copy it)."""
    import dataclasses

    cfg = dataclasses.replace(model.cfg, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = cfg
    return model


def recipe_args(dev, name, **over):
    """configs/<name>.yaml's three argument groups, on `dev`, writing under
    MESH_TRAIN_DIR and saving nothing, with the overrides `over` (a dict
    updates the recipe's dict of that name)."""
    import yaml
    from opensearch_sparse_model_tuning_sample_torch.core.config import parse_config

    with open(os.path.join(HERE, "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(idf_path=os.path.join(HERE, cfg["idf_path"]), device=str(dev),
               output_dir=os.path.join(MESH_TRAIN_DIR, name), save_strategy="no")
    for k, v in over.items():
        if isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    return parse_config(cfg)


def mesh_train_rows(split):
    """(query, positive, 2 negatives) rows of synthetic-rich's 300 test
    queries: each query's judged doc, and two docs picked by its index."""
    corpus, queries, qrels = split
    ids = sorted(corpus)

    def text(d):
        return (corpus[d].get("title", "") + " " + corpus[d]["text"]).strip()

    rows = []
    for i, qid in enumerate(sorted(qrels)):
        pos = max(qrels[qid], key=qrels[qid].get)
        negs = [ids[(7919 * i + j * 104729) % len(ids)] for j in (1, 2)]
        rows.append((queries[qid], text(pos), [text(d) for d in negs]))
    return rows


def mesh_batches(trainer, rows, per_step, n):
    """n loader batches of `per_step` rows each, through the run's collator
    (with its teacher ensemble's features, if any)."""
    from opensearch_sparse_model_tuning_sample_torch.data.collator import build_collator

    da = trainer.data_args
    collator = build_collator(da.data_type, trainer.model.tokenizer, da.max_seq_length,
                              seq_buckets=da.seq_buckets,
                              teacher_tokenizer_ids=da.kd_ensemble_teacher_kwargs.get(
                                  "teacher_tokenizer_ids", []),
                              teacher_ensemble=trainer.teacher_ensemble)
    check(len(rows) >= per_step * n, f"{len(rows)} rows for {n} batches of {per_step}")
    return [collator(rows[k * per_step:(k + 1) * per_step]) for k in range(n)]


def trainer_pair(dev, mesh, args, ens=None):
    """(the mesh's trainer, a one-position trainer) from one random init of
    the recipe's student, dropout off."""
    from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
    from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

    ma, da, ta = args
    model = no_dropout(se.from_model_args(ma, seed=ta.seed, device=dev))
    twin = no_dropout(se.from_model_args(ma, seed=ta.seed, device=dev))
    check(all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 twin.state_dict().values())),
          "the two students start from the same weights")
    return (Trainer(model, ma, da, ta, teacher_ensemble=ens, mesh=mesh),
            Trainer(twin, ma, da, ta, teacher_ensemble=ens, mesh=make_mesh(devices=[dev])))


def counted_step(trainer, batch):
    """One train step with the kernel, plain and collective counters set to
    0 just before it and read just after: (metrics, launches, plain,
    collectives)."""
    from opensearch_sparse_model_tuning_sample_torch.parallel import collectives

    reset_counters()
    collectives.reset_counts()
    metrics = {k: float(v) for k, v in trainer.train_step(batch).items()}
    launches, plain = read_counters()
    return metrics, launches, plain, collectives.mesh_counts()


def check_mesh_step(trainer, counted, what, teachers=0):
    """A step's counters: each training kernel launched once per position
    per microbatch, the ingest kernel 2 x teachers per position per
    microbatch, no plain version, and (over more than one position) the
    mesh's gather, gradient sum and broadcast; then every replica
    bit-equal to the model."""
    _, launches, plain, coll = counted
    P, A = trainer.mesh.size, trainer.accum_steps
    for k in STUDENT_KERNELS:
        check(launches[k] == P * A, f"{what}: {k} launched {launches[k]} times, {P * A} "
              "expected (positions x microbatches)")
    check(launches["maxpool_head"] == 2 * teachers * P * A,
          f"{what}: the ingest kernel launched {launches['maxpool_head']} times, "
          f"{2 * teachers * P * A} expected")
    check(not any(plain.values()), f"{what}: no plain version ran: {plain}")
    if P > 1:
        check(coll["mesh_gather"] > 0 and coll["mesh_grad_sum"] == 1
              and coll["mesh_broadcast"] == 1,
              f"{what}: the mesh's gather, gradient sum and broadcast ran: {coll}")
        lead = dict(trainer.model.named_parameters())
        for r, replica in enumerate(trainer.replicas, 1):
            for k, p in replica.named_parameters():
                check(torch.equal(p, lead[k].to(p.device)),
                      f"{what}: position {r}'s {k} equals the model's")


def lead_grads(trainer):
    return {k: p.grad.float().clone() for k, p in trainer.model.named_parameters()
            if p.grad is not None}


def grads_close(got, want, what):
    """The full-step rule of grad_check: per tensor |g - g_ref| <= GRAD_TOL
    |g_ref| + GRAD_FLOOR G; returns the worst relative error among the
    tensors with |g| > 1e-3 G."""
    check(got.keys() == want.keys(), f"{what}: the same parameters get gradients")
    big = max(float(g.norm()) for g in want.values())
    worst = 0.0
    for k, w in want.items():
        err = float((got[k] - w).norm())
        check(err <= GRAD_TOL * float(w.norm()) + GRAD_FLOOR * big,
              f"{what}: gradient of {k}: |mesh - one| {err:.3g}, |one| {float(w.norm()):.3g}")
        if float(w.norm()) > 1e-3 * big:
            worst = max(worst, err / float(w.norm()))
    check(worst <= GRAD_WORST, f"{what}: worst relative gradient error {worst:.3g}")
    return worst


def rel_err(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def timed_steps(trainer, batches, n):
    """The card's clock over n train steps (CUDA events, synchronized at
    both ends), ms a step."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(n):
        trainer.train_step(batches[k % len(batches)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def mesh_train_infonce(dev, mesh, rows):
    """13a: 5 infonce steps over the mesh and at one position."""
    args = recipe_args(dev, "config_infonce_synthetic", max_steps=MESH_TRAIN_STEPS,
                       warmup_steps=1)
    pair = trainer_pair(dev, mesh, args)
    per_step = args[2].per_device_train_batch_size * mesh.size
    batches = mesh_batches(pair[0], rows, per_step, MESH_TRAIN_STEPS)
    losses, grads, counts = [[], []], [None, None], []
    for side, trainer in enumerate(pair):
        for k, batch in enumerate(batches):
            counted = counted_step(trainer, batch)
            check_mesh_step(trainer, counted, f"13a {'mesh' if side == 0 else 'one'} step {k}")
            losses[side].append(counted[0]["loss"])
            if k == 0:
                grads[side] = lead_grads(trainer)
                counts.append({"launches": counted[1], "collectives": counted[3]})
    check(all(np.isfinite(x) for x in losses[0] + losses[1]), "13a: finite losses")
    first = rel_err(losses[0][0], losses[1][0])
    check(first <= MESH_LOSS_RTOL, f"13a: first-step loss, mesh {losses[0][0]} vs one position "
          f"{losses[1][0]} ({first:.3g} relative)")
    worst = grads_close(grads[0], grads[1], "13a first step")
    print(f"13a: {MESH_TRAIN_STEPS} infonce steps of {per_step} queries x 3 docs; loss mesh vs "
          "one position: " + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(*losses))
          + f"; first step {first:.3g} relative; first-step gradients: worst relative "
          f"{worst:.3g} (tolerance {GRAD_TOL} + {GRAD_FLOOR} G); counters of the mesh's first "
          f"step {counts[0]}", flush=True)
    return pair, batches, {"losses_mesh": losses[0], "losses_one": losses[1],
                           "first_loss_rel_err": first, "grad_worst_rel_err": worst,
                           "first_step": counts[0], "queries_per_step": per_step}


def kd_teacher_capture(ens):
    """Patch the ensemble's `scores_from_reps` to keep its last inputs and
    output (the mesh's and one position's steps score on the lead)."""
    seen = {}
    scores_from_reps = ens.scores_from_reps

    def capture(q_reps, d_reps):
        out = scores_from_reps(q_reps, d_reps)
        seen.update(q=[r.float().cpu() for r in q_reps], d=[r.float().cpu() for r in d_reps],
                    scores=out.cpu())
        return out

    ens.scores_from_reps = capture
    return seen


def mesh_train_kd(dev, mesh, rows, teachers):
    """13b: one kd step of the kd recipe over the mesh and at one
    position, the teachers scoring at every position."""
    from opensearch_sparse_model_tuning_sample_torch.ops.losses import pair_scores
    from opensearch_sparse_model_tuning_sample_torch.train.teachers import build_ensemble

    args = recipe_args(dev, "config_kd_synthetic", max_steps=1, warmup_steps=0,
                       kd_ensemble_teacher_kwargs={"model_ids": teachers,
                                                   "teacher_tokenizer_ids": teachers})
    ma, da, ta = args
    ens = build_ensemble(da.kd_ensemble_teacher_kwargs, da.use_in_batch_negatives,
                         max_length=da.max_seq_length, device=dev)
    pair = trainer_pair(dev, mesh, args, ens)
    per_step = ta.per_device_train_batch_size * mesh.size
    batch = mesh_batches(pair[0], rows, per_step, 1)[0]
    seen = kd_teacher_capture(ens)
    got, want, counted = {}, {}, []
    try:
        for trainer, into in zip(pair, (got, want)):
            counted.append(counted_step(trainer, batch))
            check_mesh_step(trainer, counted[-1], "13b " + ("mesh" if into is got else "one"),
                            teachers=len(teachers))
            into.update(seen)
    finally:
        del ens.scores_from_reps  # back to the class's method
    raw, raw_err = [], 0.0
    for i in range(len(teachers)):
        for side in ("q", "d"):
            a, b = want[side][i], got[side][i]
            err = (a - b).abs()
            check(bool((err <= KD_REP_TOL * a.abs().clamp_min(1.0)).all()),
                  f"13b teacher {i} {side} reps, mesh vs one: max |err| {float(err.max()):.3g}")
        s_one = pair_scores(want["q"][i], want["d"][i], ens.use_in_batch_negatives)
        s_mesh = pair_scores(got["q"][i], got["d"][i], ens.use_in_batch_negatives)
        rel = float(((s_mesh - s_one).abs() / s_one.abs().amax(1, keepdim=True)).max())
        check(rel <= KD_SCORE_TOL, f"13b teacher {i} raw scores, mesh vs one: {rel:.3g}")
        raw.append(s_one)
        raw_err = max(raw_err, rel)
    tol = minmax_tol(raw, raw_err, ens.score_scale)
    err = (got["scores"] - want["scores"]).abs()
    check(got["scores"].shape == (per_step, per_step * 3), f"13b scores {got['scores'].shape}")
    check(bool((err <= tol).all()), f"13b ensemble scores, mesh vs one: max |err| "
          f"{float(err.max()):.4g}")
    losses = [c[0]["loss"] for c in counted]
    check(all(np.isfinite(losses)), "13b: finite kd losses")
    print(f"13b: one kd step of {per_step} queries, teachers {teachers}: ensemble scores "
          f"{list(got['scores'].shape)} mesh vs one position max |err| {float(err.max()):.4g} "
          f"(smallest row tolerance {float(tol.min()):.4g}; raw scores within {raw_err:.3g} of "
          f"the row max); kldiv loss {losses[0]:.6f} / {losses[1]:.6f}; mesh launches "
          f"{counted[0][1]}", flush=True)
    out = {"queries": per_step, "teachers": teachers, "scores_max_abs_err": float(err.max()),
           "raw_rel_err": raw_err, "tol_min": float(tol.min()), "losses": losses,
           "launches": counted[0][1], "collectives": counted[0][3]}
    del pair, ens
    return out


def mesh_train_accum(dev, mesh, rows):
    """13c: one infonce step with A = 2 over the mesh and at one position."""
    args = recipe_args(dev, "config_infonce_synthetic", max_steps=1, warmup_steps=0,
                       gradient_accumulation_steps=2)
    pair = trainer_pair(dev, mesh, args)
    per_step = args[2].per_device_train_batch_size * mesh.size * 2
    batch = mesh_batches(pair[0], rows, per_step, 1)[0]
    counted = [counted_step(t, batch) for t in pair]
    for trainer, c, what in zip(pair, counted, ("mesh", "one")):
        check_mesh_step(trainer, c, f"13c {what}")
    losses = [c[0]["loss"] for c in counted]
    rel = rel_err(*losses)
    check(rel <= MESH_LOSS_RTOL, f"13c: loss with A = 2, mesh {losses[0]} vs one {losses[1]}")
    print(f"13c: one step of {per_step} queries with A = 2: loss {losses[0]:.6f} (mesh) vs "
          f"{losses[1]:.6f} ({rel:.3g} relative); mesh launches {counted[0][1]}, collectives "
          f"{counted[0][3]}", flush=True)
    return {"queries": per_step, "losses": losses, "loss_rel_err": rel,
            "launches": counted[0][1], "collectives": counted[0][3]}


def phase_mesh_train(dev, split, teachers, card):
    """Step 13: training over the mesh inside one process (13a-13c), then
    (13e) the mesh step against the one-position step at the global batch
    on the card's clock, with the card's busy share."""
    t0 = time.time()
    mesh, how = make_mesh_for(dev)
    print(f"step 13, training over the mesh: {how}; devices {[str(d) for d in mesh.devices]}",
          flush=True)
    rows = mesh_train_rows(split)
    out = {"mesh": how, "devices": [str(d) for d in mesh.devices]}
    pair, batches, out["13a"] = mesh_train_infonce(dev, mesh, rows)
    timing = {}
    for name, trainer in zip(("mesh", "one"), pair):
        step_ms = timed_steps(trainer, batches, MESH_TIMED_STEPS)
        prof = profile_steps(trainer, batches[0], step_ms, n=3)
        timing[name] = {"step_ms": step_ms, "busy_ms": prof["busy_ms"],
                        "busy_share": prof["busy_share"], "ops_per_step": prof["ops_per_step"],
                        "docs_per_s": 1e3 * len(batches[0]["d_input_ids"]) / step_ms}
    out["13e"] = timing
    del pair, batches
    torch.cuda.empty_cache()
    out["13b"] = mesh_train_kd(dev, mesh, rows, teachers)
    out["13c"] = mesh_train_accum(dev, mesh, rows)
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t0
    out["card"] = card
    print(f"mesh train step {timing['mesh']['step_ms']:.3f} ms ({timing['mesh']['busy_share']:.3f} "
          f"busy) over {mesh.size} positions against {timing['one']['step_ms']:.3f} ms "
          f"({timing['one']['busy_share']:.3f} busy) at one position, "
          f"{out['13a']['queries_per_step']} queries a step (card's clock, CUDA events over "
          f"{MESH_TIMED_STEPS} steps; card {card}); step 13 {out['seconds']:.1f} s", flush=True)
    return out


# the ModernBERT cell's traffic: doc lengths in words, one wordpiece a word
LONGDOC = os.path.join(HERE, "lsr_bench", "traffic", "longdoc-4096.json")
# a (query, head) row of the fused attention against its plain version: the
# relative L2 gap of two bf16 roundings of the probabilities and two of the
# output, each 2^-8 (tests/test_torch_gpu.py derives them); a key tile of 64
# dropped from a row moves it by 12 % or more
ATTN_ROW_TOL, ATTN_MEAN_TOL = 2 ** -6, 2 ** -7


def longdoc_batches(seed, docs=64):
    """One ingest chunk of the ModernBERT cell's docs: lengths drawn as its
    traffic gives them (lognormal words, min and max, [CLS] and [SEP], cut
    at max_length), sorted and cut into batches as `BatchEncoder` runs a
    chunk, each at the smallest multiple of 64 holding its longest doc:
    [(L, doc lengths)]."""
    with open(LONGDOC) as f:
        t = json.load(f)
    dw, cap, bs = t["doc_words"], int(t["max_length"]), int(t["batch_size"])
    rng = np.random.default_rng(seed)
    words = np.clip(np.round(rng.lognormal(np.log(dw["median"]), dw["sigma"], docs)),
                    dw["min"], dw["max"])
    lens = np.sort(np.minimum(words + 2, cap).astype(np.int64))
    return [(int(-(-b[-1] // 64) * 64), b) for b in (lens[i:i + bs] for i in range(0, docs, bs))]


def attention_rows(dev, H=16, hd=64):
    """The fused attention of both kinds on the card against its plain
    version, at the shortest, a middle and the longest batch of one of the
    cell's chunks (8 rows, L up to 8 192, ModernBERT-large's 16 heads of
    64): each (query, head) row of the live queries within ATTN_ROW_TOL of
    its own scale, the mean within ATTN_MEAN_TOL, the launch counters
    (zeroed just before) showing one kernel launch, no plain call and
    `computed_pairs`; then each kernel's time against its bound."""
    from opensearch_sparse_model_tuning_sample_torch.ops import attention as at
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    batches = longdoc_batches(18)
    rows = []
    for L, lens in (batches[0], batches[len(batches) // 2], batches[-1]):
        g = torch.Generator(device=dev).manual_seed(L)
        qkv = torch.randn((len(lens), L, 3, H, hd), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        n = torch.as_tensor(lens, device=dev)
        mask = (torch.arange(L, device=dev)[None, :] < n[:, None]).to(torch.int32)
        for window in (0, 64):
            kind = "local" if window else "global"
            launch = "attn.launches.attention_" + ("window" if window else "global") + "_kernel"
            names = ["encoder.attn.pairs." + kind, launch, "attn.plain_calls.attention_reference"]
            tracing.reset(names)
            got = at.attention(q, k, v, mask, window)
            torch.cuda.synchronize()
            c = tracing.counters()
            what = f"attention {kind} [{len(lens)}, {L}, {H}, {hd}]"
            check(c.get(launch) == 1 and not c.get(names[2]), f"{what}: one launch, no plain call {c}")
            check(c.get(names[0]) == at.computed_pairs(len(lens), L, window),
                  f"{what}: pairs counted {c.get(names[0])}")
            ref = at.attention_reference(q, k, v, mask, window)
            live = mask.bool()
            gg, rr = got.float()[live], ref.float()[live]
            rel = (gg - rr).norm(dim=-1) / rr.norm(dim=-1)
            worst, mean = float(rel.max()), float(rel.mean())
            check(bool(torch.isfinite(got.float()).all()), f"{what}: finite")
            check(worst <= ATTN_ROW_TOL and mean <= ATTN_MEAN_TOL,
                  f"{what}: row gap worst {worst}, mean {mean}")
            del ref, gg, rr
            ms = cuda_ms(lambda: at.attention(q, k, v, mask, window), 5)
            nf = n.double()
            pairs = nf * nf if not window else torch.where(
                nf <= window + 1, nf * nf, nf * (2 * window + 1) - window * (window + 1))
            D = H * hd
            bound_s = float(torch.maximum(4 * pairs * D / PEAK_BF16_FLOPS,
                                          4 * nf * D * 2 / PEAK_BYTES_PER_S).sum())
            rows.append({"kind": kind, "shape": [len(lens), L, H, hd], "lens": lens.tolist(),
                         "row_gap_worst": worst, "row_gap_mean": mean, "ms": ms,
                         "bound_ms": bound_s * 1e3, "share_of_bound": bound_s * 1e3 / ms})
            print(f"modernbert attention: {json.dumps(rows[-1])}", flush=True)
        del qkv, q, k, v
    return rows


def phase_modernbert(dev):
    """ModernBERT-large through the cell's path: `build_model`'s preset on
    the card, `eval/beir.py::ingest` of 16 of the cell's docs (two chunks of
    8, batch 8, max_length 8 192), after the attention rows. Every batch
    launches the global kernel 10 times, the windowed one 18 times and the
    head kernel once, no plain version runs, the pair counters add the
    batches' `computed_pairs`, and every stored row is finite and holds
    terms."""
    from opensearch_sparse_model_tuning_sample_torch.eval.beir import ingest
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
    from opensearch_sparse_model_tuning_sample_torch.ops import attention as at
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    t0 = time.time()
    rows = attention_rows(dev)
    model = se.build_model(arch="modernbert-large", seed=0, device=dev)
    cfg = model.cfg
    words = [w for w in model.tokenizer.vocab if w.isalpha() and w.isascii() and len(w) > 2]
    rng = np.random.default_rng(18)
    lens = np.concatenate([b for _, b in longdoc_batches(19, docs=16)]) - 2
    corpus = [(f"d{i}", " ".join(rng.choice(words, int(n)))) for i, n in enumerate(lens)]
    tracing.reset()
    out = os.path.join(OUT, "modernbert")
    os.makedirs(out, exist_ok=True)
    with torch.no_grad():
        index = ingest(corpus, model, out, "longdoc", max_length=8192, batch_size=8,
                       index_cfg=IndexConfig(engine="sparse", l_max=256))
    torch.cuda.synchronize()
    c = tracing.counters()
    batches = {int(k.rsplit(".", 1)[1]): v for k, v in c.items()
               if k.startswith("encoder.batch_len.")}
    n_batches = sum(batches.values())
    glob = sum(cfg.is_global(i) for i in range(cfg.num_hidden_layers))
    want = {"attn.launches.attention_global_kernel": glob * n_batches,
            "attn.launches.attention_window_kernel": (cfg.num_hidden_layers - glob) * n_batches,
            "head.launches.maxpool_head": n_batches,
            "encoder.attn.pairs.global": sum(
                v * glob * at.computed_pairs(8, L, 0) for L, v in batches.items()),
            "encoder.attn.pairs.local": sum(
                v * (cfg.num_hidden_layers - glob) * at.computed_pairs(8, L, cfg.window(1))
                for L, v in batches.items())}
    for k, v in want.items():
        check(c.get(k) == v, f"modernbert ingest: {k} {c.get(k)}, {v} expected")
    plains = {k: v for k, v in c.items() if ".plain_calls." in k and v}
    check(not plains, f"modernbert ingest: no plain version ({plains})")
    w, _ = index._stored_rows()
    w = w[:index.n_docs].float()  # the stored rows, padded to whole blocks
    check(index.n_docs == len(corpus) and bool(torch.isfinite(w).all())
          and bool(((w > 0).sum(1) > 0).all()), "modernbert ingest: every row finite, with terms")
    res = {"attention": rows, "batches": batches, "docs": len(corpus),
           "counters": {k: c.get(k) for k in want}, "seconds": time.time() - t0}
    del model, index
    torch.cuda.empty_cache()
    return res


# (heads, L) of BERT's attention rows: distil-ingest's batches (50 rows of a
# length-sorted chunk at 128 ... 512 by 64, DistilBERT's 12 heads of 64),
# then the main path's mini model (4 heads of 64) at its eval's L = 64
# bucket and the longest, 512
BERT_ATTN_SHAPES = tuple((12, L) for L in range(128, 513, 64)) + ((4, 64), (4, 512))


def bert_attention_rows(dev, B=50, hd=64):
    """BERT's attention core at distil-ingest's batch shapes [50, L, 12, 64]
    and the main path's [50, L, 4, 64]: q, k, v as the projections give
    them (views of [B, L, H·hd]), live lengths drawn from (L - 64, L] as a
    sorted chunk's batch holds them (one row full). The fused kernel
    against BERT's plain chain on the live queries (each (query, head) row
    within ATTN_ROW_TOL of its own scale, the mean within ATTN_MEAN_TOL),
    then the kernel's time beside its bound (4·Σ n²·hd·H at 989 TFLOP/s
    against q, k, v, o once in bf16 at 3.35 TB/s, whichever is longer: the
    bytes at every L here, as the two cross near n = 590), the plain
    chain's and one SDPA call's (the library's yardstick, which the port
    never calls)."""
    import torch.nn.functional as F

    from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
    from opensearch_sparse_model_tuning_sample_torch.ops import attention as at

    rows = []
    for H, L in BERT_ATTN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(L)
        q, k, v = (torch.randn((B, L, H * hd), generator=g, device=dev).to(torch.bfloat16)
                   .view(B, L, H, hd) for _ in range(3))
        lens = np.random.default_rng(L).integers(max(L - 63, 1), L + 1, size=B)
        lens[-1] = L
        n = torch.as_tensor(lens, device=dev)
        mask = (torch.arange(L, device=dev)[None, :] < n[:, None]).to(torch.int32)
        got = at.attention(q, k, v, mask)
        plain = tbert.attention_chain(q, k, v, mask)
        live = mask.bool()
        gg, pp = got.float()[live], plain.float()[live]
        rel = (gg - pp).norm(dim=-1) / pp.norm(dim=-1)
        worst, mean = float(rel.max()), float(rel.mean())
        what = f"bert attention [{B}, {L}, {H}, {hd}]"
        check(bool(torch.isfinite(got.float()).all()), f"{what}: finite")
        check(worst <= ATTN_ROW_TOL and mean <= ATTN_MEAN_TOL,
              f"{what}: against the plain chain, row gap worst {worst}, mean {mean}")
        del gg, pp, plain
        kernel_ms = cuda_ms(lambda: at.attention(q, k, v, mask), 20)
        plain_ms = cuda_ms(lambda: tbert.attention_chain(q, k, v, mask), 5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        live4 = live[:, None, None, :]
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=live4), 20)
        nf = n.double()
        ops_s = 4 * nf * nf * H * hd / PEAK_BF16_FLOPS
        bytes_s = 4 * nf * H * hd * 2 / PEAK_BYTES_PER_S
        bound_s = float(torch.maximum(ops_s, bytes_s).sum())
        rows.append({"shape": [B, L, H, hd], "live": [int(lens.min()), int(lens.max())],
                     "row_gap_worst": worst, "row_gap_mean": mean, "kernel_ms": kernel_ms,
                     "bound_ms": bound_s * 1e3, "share_of_bound": bound_s * 1e3 / kernel_ms,
                     "bound_by": "bytes" if float(bytes_s.sum()) >= float(ops_s.sum())
                     else "operations",
                     "plain_chain_ms": plain_ms, "sdpa_ms": sdpa_ms})
        print(f"bert attention: {json.dumps(rows[-1])}", flush=True)
        del q, k, v, qt, kt, vt, got
    return rows


# the names under which the profiler records the host's launches onto the
# card (kernels, graphs, copies, fills), CUDA runtime and driver API alike
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def host_launches(fn):
    """(fn's result, the launch calls the profiler records while fn runs and
    the card finishes it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.name in LAUNCH_CALLS for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CPU)


def host_ms(fn, iters=5):
    """Mean host time of fn() over `iters` calls queued from an idle card:
    the Python and the launches, which a card that runs each call for
    longer than the host queues it never makes wait."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e3


def bert_graph_rows(dev, model, B=50):
    """BERT's encoder stack captured as a CUDA graph (`GraphRunner`) against
    the eager stack at distil-ingest's full batches [50, L], L 128-512 by 64
    (DistilBERT's widths, live lengths in (L - 64, L]): the hidden states
    equal bit for bit, then each one's host time a forward (`host_ms`), its
    device time (CUDA events, `cuda_ms` over 3 forwards: more eager ones
    than that fill the launch queue behind the sleep, and the host then
    paces the card) and the launch calls the profiler records for one
    forward."""
    bert = model.bert
    rows = []
    for L in range(128, 513, 64):
        g = torch.Generator().manual_seed(L)
        ids = torch.randint(1000, 30522, (B, L), generator=g).to(dev)
        lens = torch.randint(L - 63, L + 1, (B,), generator=g)
        lens[0] = L
        mask = (torch.arange(L)[None, :] < lens[:, None]).to(torch.int32).to(dev)
        with torch.inference_mode():
            def eager():
                return bert.encode_hidden(ids, mask)

            def graph():
                return bert.graph_runner(bert, ids, mask)

            want = eager()
            got = graph().clone()
            check(torch.equal(got, want), f"bert graph [{B}, {L}]: hidden states equal the "
                  f"eager stack's bit for bit (worst {float((got - want).abs().max())})")
            row = {"shape": [B, L], "eager_host_ms": host_ms(eager),
                   "graph_host_ms": host_ms(graph), "eager_device_ms": cuda_ms(eager, 3),
                   "graph_device_ms": cuda_ms(graph, 3),
                   "eager_launches": host_launches(eager)[1],
                   "graph_launches": host_launches(graph)[1]}
        print(f"bert graph: {json.dumps(row)}", flush=True)
        rows.append(row)
        del ids, mask, want, got
    return rows


def phase_bert_attention(dev):
    """BERT's attention on the card (step 3c): the rows above, then
    `eval/beir.py::ingest` of 333 docs (lengths as distil-ingest draws them,
    batch 50, max_length 512: one chunk, its first batch of 33 docs short)
    through `build_model`'s `distill` preset. Every batch launches the fused
    kernel once a layer and no layer takes the plain chain: the kernel's
    share of BERT's attention calls is 1. The six full batches replay the
    encoder stack's CUDA graphs and the short one runs it eagerly (the
    graphs' share of the batches, replays / (replays + eager), is 6/7),
    and the counts read as the eager stack's. Then the graphs against the
    eager stack at each full batch's shape (`bert_graph_rows`), and the same
    ingest again with every batch eager, for the launch calls of each."""
    from opensearch_sparse_model_tuning_sample_torch.eval.beir import ingest
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    t0 = time.time()
    rows = bert_attention_rows(dev)
    model = se.build_model(arch="distill", idf_path=os.path.join(HERE, "assets", "idf.npz"),
                           seed=0, device=dev)
    words = [w for w in model.tokenizer.vocab if w.isalpha() and w.isascii() and len(w) > 2]
    rng = np.random.default_rng(21)
    lens = np.clip(np.round(rng.lognormal(np.log(180), 0.6, 333)), 10, 700).astype(int)
    corpus = [(f"d{i}", " ".join(rng.choice(words, int(n)))) for i, n in enumerate(lens)]
    tracing.reset()
    out = os.path.join(OUT, "bert_attention")
    os.makedirs(out, exist_ok=True)

    def run(name):
        return ingest(corpus, model, out, name, max_length=512, batch_size=50,
                      index_cfg=IndexConfig(engine="sparse", l_max=256))

    index = run("distil")
    torch.cuda.synchronize()
    c = tracing.counters()
    batches = {int(k.rsplit(".", 1)[1]): v for k, v in c.items()
               if k.startswith("encoder.batch_len.")}
    layers = model.cfg.num_hidden_layers
    launches = c.get("attn.launches.attention_global_kernel", 0)
    plain = c.get("encoder.attn.plain_chain", 0)
    share = launches / max(launches + plain, 1)
    check(launches == layers * sum(batches.values()) and plain == 0 and share == 1.0
          and c.get("head.launches.maxpool_head") == sum(batches.values()),
          f"bert ingest: {launches} kernel launches and {plain} plain chains for "
          f"{sum(batches.values())} batches of {layers} layers")
    check(index.n_docs == len(corpus), "bert ingest: every doc stored")
    graph = {k.rsplit(".", 1)[1]: c.get(k, 0) for k in
             ("encoder.graph.captures", "encoder.graph.replays", "encoder.graph.eager")}
    graph["share"] = graph["replays"] / max(graph["replays"] + graph["eager"], 1)
    check(graph["replays"] == 6 and graph["eager"] == 1
          and 1 <= graph["captures"] <= len(batches),
          f"bert ingest: the six full batches replay graphs, the short one is eager ({graph})")
    stored = index._stored_rows()[0][:index.n_docs].float()
    graph_rows = bert_graph_rows(dev, model)
    _, graph["launch_calls"] = host_launches(lambda: run("distil_graph"))
    with mock.patch.object(se, "takes_graph", lambda device, batch_rows, rows: False):
        eager_index, graph["eager_launch_calls"] = host_launches(lambda: run("distil_eager"))
    check(torch.equal(eager_index._stored_rows()[0][:index.n_docs].float(), stored),
          "bert ingest: the rows stored with every batch eager equal the graphs' bit for bit")
    print(f"bert ingest graphs: {json.dumps(graph)}", flush=True)
    res = {"attention": rows, "batches": batches, "docs": len(corpus), "launches": launches,
           "plain_chain": plain, "kernel_share": share, "graph": graph,
           "graph_rows": graph_rows, "seconds": time.time() - t0}
    del model, index, eager_index
    torch.cuda.empty_cache()
    return res


def mesh_only(dev, card, mesh_corpus, t_start):
    """`python3 chip_smoke.py --mesh-only`: steps 12a, 12b and 13 alone
    (they need nothing of the main path but its kernels, which the trainer
    builds on first use), for a machine with four cards, where the mesh is
    make_mesh(4): one stripe, replica or training position per card."""
    mesh, how = make_mesh_for(dev)
    print(f"mesh: {how}; devices {[str(d) for d in mesh.devices]}", flush=True)
    out = {"mesh": how, "devices": [str(d) for d in mesh.devices],
           "12a": mesh_scan(dev, mesh), "12b": mesh_big(dev, mesh, mesh_corpus)}
    # step 13 with random-init teachers: the main path's checkpoints are not made here
    from opensearch_sparse_model_tuning_sample_torch.eval.beir import resolve_dataset

    mesh_train = phase_mesh_train(dev, resolve_dataset("synthetic-rich", ""), ["mini", "mini"],
                                  card)
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print("mesh: " + json.dumps(out))
    print("mesh train: " + json.dumps(mesh_train))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# the Moonlight cell's traffic: doc lengths in words, one wordpiece a word
SCIFACT_ML = os.path.join(HERE, "lsr_bench", "traffic", "scifact-384x64.json")


def moonlight_batch_lens(seed):
    """One full batch of the Moonlight cell's docs: 64 lengths drawn as its
    traffic gives them (lognormal words, min and max, [CLS] and [SEP], cut
    at max_length), sorted; the batch's L is the smallest multiple of 64
    holding the longest."""
    with open(SCIFACT_ML) as f:
        t = json.load(f)
    dw, cap = t["doc_words"], int(t["max_length"])
    rng = np.random.default_rng(seed)
    words = np.clip(np.round(rng.lognormal(np.log(dw["median"]), dw["sigma"],
                                           int(t["batch_size"]))), dw["min"], dw["max"])
    lens = np.sort(np.minimum(words + 2, cap).astype(np.int64))
    return int(-(-lens[-1] // 64) * 64), lens


def _rel_rows(got, ref):
    """Per row, the relative L2 gap of got to ref."""
    g, r = got.float(), ref.float()
    return (g - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-6)


def ptxas_resources(log, kernels):
    """Per kernel of `kernels` (names as in the trace), ptxas's registers and
    spill bytes from an nvcc log, and any note that it serialized the
    wgmmas (C75xx)."""
    res, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = next((k for k in kernels if k in m.group(1)), None)
            if name:  # a note may come before its function's entry
                res[name] = {"registers": None, "spill_stores": None, "spill_loads": None,
                             "notes": res.get(name, {}).get("notes", [])}
            continue
        for k in kernels:
            if "C75" in ln and k in ln:
                res.setdefault(k, {"notes": []})["notes"].append(ln.strip()[:200])
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            res[name]["spill_stores"], res[name]["spill_loads"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            res[name]["registers"] = int(m[1])
    return res


def expert_gemm_rows(u, token, gate, up, down, offsets):
    """The grouped expert GEMMs over the rows of `token` (sorted by expert,
    the held ones up to offsets[E]): gate-up reading each row's token from u
    in place, then down on its output. Each is held to the per-expert loop
    on the gathered rows (each row within 2^-7 of its norm) and to its own
    first launch (the same bits on a second one), and timed against its
    bound (operations at 989 TFLOP/s or the weights and rows at 3.35 TB/s,
    the larger), the plain loop and `torch._grouped_mm` (CUTLASS on
    `wgmma`, a yardstick the port never calls) on the gathered rows.
    Returns the two rows, each with ptxas's registers and spills for its
    kernel, and down's output."""
    from opensearch_sparse_model_tuning_sample_torch.ops import kernel_build
    from opensearch_sparse_model_tuning_sample_torch.ops import moe

    E, I, D = gate.shape
    R = int(offsets[-1])
    x = u.index_select(0, token[:R])  # the rows gathered: the plain loop's and the library's
    h = moe.expert_gate_up(u, token, gate, up, offsets)
    y = moe.expert_down(h, down, offsets)
    torch.cuda.synchronize()
    built = ptxas_resources(kernel_build.build_log("moe"), ["moe_gate_up_kernel",
                                                            "moe_down_kernel"])
    rows = []
    for name, got, plain, f, (a, wt), ops, nbytes in (
            ("moe_gate_up", h, lambda: moe.expert_gate_up_reference(x, gate, up, offsets),
             lambda: moe.expert_gate_up(u, token, gate, up, offsets),
             (x, torch.cat([gate, up], 1)), 2 * R * D * 2 * I,
             E * 2 * I * D * 2 + R * (D + I) * 2),
            ("moe_down", y, lambda: moe.expert_down_reference(h[:R], down, offsets),
             lambda: moe.expert_down(h, down, offsets), (h[:R], down), 2 * R * I * D,
             E * D * I * 2 + R * (I + D) * 2)):
        ref = plain()
        rel = _rel_rows(got[:R], ref)
        check(float(rel.max()) <= 2 ** -7, f"{name}: row gap {float(rel.max())}")
        check(torch.equal(f()[:R], got[:R]), f"{name}: the same bits on a second launch")
        ms = cuda_ms(f, 5)
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        lib_ms = None
        if hasattr(torch, "_grouped_mm"):
            try:  # rows [R, K] against [E, K, N], groups ending at offs
                wt = wt.transpose(1, 2)
                ends = offsets[1:].contiguous()
                lib_ms = cuda_ms(lambda: torch._grouped_mm(a, wt, offs=ends), 5)
            except (RuntimeError, TypeError) as e:
                lib_ms = f"torch._grouped_mm refused: {str(e).splitlines()[0][:120]}"
        bound = max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        rows.append({"kernel": name + "_kernel", "shape": [R, D, I, E], "ms": ms,
                     "bound_ms": bound, "share_of_bound": bound / ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "row_gap_worst": float(rel.max()),
                     "ptxas": built.get(name + "_kernel")})
        del ref
    del x, h
    return rows, y


def moonlight_rows(dev):
    """Moonlight's new kernels at the cell's shapes, each against its plain
    version for its answer and its time, its bound and one library call:
    the grouped expert GEMMs (gate-up with SiLU·mul, down) over one full
    batch's rows as the router splits them, against the per-expert loop
    and `torch._grouped_mm` (where this torch has it), each the same bits
    on a second launch, with ptxas's registers and spills for its kernel
    (`expert_gemm_rows`); the combine of those
    rows into the fp32 stream, against the slot loop (within 1e-5 a row,
    the same bits on a second launch) and `index_select` with a weighted
    sum, bound by its bytes; the causal attention
    at [64, L, 16, 192 | 128] against the plain path and SDPA with a
    boolean mask; the head at [64, L, 2 048, 163 840] (the streamed w tile)
    against the plain version on a slice of the vocab and cuBLAS's bf16
    logits with a masked max."""
    from opensearch_sparse_model_tuning_sample_torch.ops import attention as at
    from opensearch_sparse_model_tuning_sample_torch.ops import moe
    from opensearch_sparse_model_tuning_sample_torch.ops.maxpool import (maxpool_head,
                                                                          maxpool_head_reference)

    L, lens = moonlight_batch_lens(22)
    B, D, I, E, k, H, V = len(lens), 2048, 1408, 64, 6, 16, 163840
    n = torch.as_tensor(lens, device=dev)
    mask = (torch.arange(L, device=dev)[None, :] < n[:, None]).to(torch.int32)
    T = int(n.sum())
    g = torch.Generator(device=dev).manual_seed(22)
    rows = []
    # the experts: the rows of the batch's real tokens, routed by a random router
    u = torch.randn((T, D), generator=g, device=dev)
    chosen, w = moe.route(u, torch.randn((E, D), generator=g, device=dev) * 0.02,
                          torch.randn(E, generator=g, device=dev) * 0.02, k, 2.446)
    token, offsets, pos = moe.permute(chosen, E)
    ub = u.to(torch.bfloat16)
    gate, up = ((torch.randn((E, I, D), generator=g, device=dev) * 0.02).to(torch.bfloat16)
                for _ in range(2))
    down = (torch.randn((E, D, I), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    gemm_rows, y = expert_gemm_rows(ub, token, gate, up, down, offsets)
    for row in gemm_rows:
        rows.append(row)
        print(f"moonlight kernels: {json.dumps(row)}", flush=True)
    # the combine: the down rows above back into a random fp32 stream of the
    # batch's tokens, with a random shared-expert output
    x0 = torch.randn((T, D), generator=g, device=dev)
    shared = torch.randn((T, D), generator=g, device=dev).to(torch.bfloat16)
    got = moe.combine(x0.clone(), y, shared, pos, w)
    ref = moe.combine_reference(x0.clone(), y, shared, pos, w)
    rel = _rel_rows(got, ref)
    check(float(rel.max()) <= 1e-5, f"moe_combine: row gap {float(rel.max())}")
    check(torch.equal(moe.combine(x0.clone(), y, shared, pos, w), got),
          "moe_combine: the same bits on a second launch")
    xs = x0.clone()
    ms = cuda_ms(lambda: moe.combine(xs, y, shared, pos, w), 20)
    plain_ms = cuda_ms(lambda: moe.combine_reference(xs, y, shared, pos, w), 5)
    flat = pos.reshape(-1)

    def library():  # gather the k rows, weight them, sum, add
        rows_k = y.index_select(0, flat).view(T, k, D).float()
        xs.add_((rows_k * w[:, :, None]).sum(1) + shared.float())

    lib_ms = cuda_ms(library, 5)
    nbytes = T * k * D * 2 + T * D * 2 + 2 * T * D * 4 + T * k * (8 + 4)
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    rows.append({"kernel": "moe_combine_kernel", "shape": [T, D, k], "ms": ms, "bound_ms": bound,
                 "share_of_bound": bound / ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                 "row_gap_worst": float(rel.max())})
    print(f"moonlight kernels: {json.dumps(rows[-1])}", flush=True)
    del x0, xs, shared, got, ref
    del u, ub, gate, up, down, y
    # causal attention at MLA's dims
    q, kk = (torch.randn((B, L, H, 192), generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    v = torch.randn((B, L, H, 256), generator=g, device=dev).to(torch.bfloat16)[..., 128:]
    got = at.attention(q, kk, v, mask, causal=True)
    ref = at.attention_reference(q, kk, v, mask, causal=True)
    live = mask.bool()
    rel = _rel_rows(got[live], ref[live])
    check(float(rel.max()) <= ATTN_ROW_TOL and float(rel.mean()) <= ATTN_MEAN_TOL,
          f"causal attention: row gap worst {float(rel.max())}, mean {float(rel.mean())}")
    ms = cuda_ms(lambda: at.attention(q, kk, v, mask, causal=True), 5)
    plain_ms = cuda_ms(lambda: at.attention_reference(q, kk, v, mask, causal=True), 2)
    allowed = live[:, None, None, :] & torch.ones((L, L), dtype=torch.bool, device=dev).tril()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
    try:
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allowed), 5)
    except RuntimeError as e:
        lib_ms = f"SDPA refused: {str(e).splitlines()[0][:120]}"
    nf = n.double()
    bound = float(torch.maximum(nf * (nf + 1) / 2 * H * 2 * 320 / PEAK_BF16_FLOPS,
                                nf * H * 640 * 2 / PEAK_BYTES_PER_S).sum()) * 1e3
    rows.append({"kernel": "attention_causal_kernel", "shape": [B, L, H, 192, 128], "ms": ms,
                 "bound_ms": bound, "share_of_bound": bound / ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, "row_gap_worst": float(rel.max())})
    print(f"moonlight kernels: {json.dumps(rows[-1])}", flush=True)
    del q, kk, v, ref, allowed, qt, kt, vt
    # the head at D 2 048 over the whole vocab: the plain version on a slice
    hh = torch.randn((B, L, D), generator=g, device=dev).to(torch.bfloat16)
    wl = (torch.randn((V, D), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    bias = torch.zeros(V, device=dev)
    got = maxpool_head(hh, mask, wl, bias)
    cols = torch.arange(0, V, 80, device=dev)
    t0 = time.perf_counter()
    ref = maxpool_head_reference(hh, mask, wl[cols].contiguous(), bias[cols].contiguous())
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 * V / len(cols)
    err = (got[:, cols] - ref).abs()
    check(bool((err <= 1e-3 * ref.abs().clamp_min(1.0)).all()), f"head D 2048: {float(err.max())}")
    ms = cuda_ms(lambda: maxpool_head(hh, mask, wl, bias), 3)

    def library():
        m = mask.to(torch.bfloat16)[:, :, None]
        for b0 in range(0, B, 8):
            (torch.matmul(hh[b0:b0 + 8], wl.t()) * m[b0:b0 + 8]).amax(1)

    lib_ms = cuda_ms(library, 2)
    unmasked = int(n.sum())
    bound = max(2 * unmasked * D * V / PEAK_BF16_FLOPS,
                (V * D * 2 + B * L * D * 2 + B * V * 4) / PEAK_BYTES_PER_S) * 1e3
    rows.append({"kernel": "maxpool_head_stream_kernel", "shape": [B, L, D, V], "ms": ms,
                 "bound_ms": bound, "share_of_bound": bound / ms,
                 "plain_ms_scaled_from_slice": plain_ms, "library_ms": lib_ms,
                 "worst_gap": float(err.max())})
    print(f"moonlight kernels: {json.dumps(rows[-1])}", flush=True)
    del hh, wl
    torch.cuda.empty_cache()
    return rows


def phase_moonlight(dev):
    """Moonlight-16B-A3B through the cell's path (step 3d): the kernel rows
    above, then `build_model`'s `moonlight-16b-a3b` preset on the card (32
    GB, drawn a tensor at a time) and `eval/beir.py::ingest` of 32 of the
    cell's docs (batch 16, max_length 512). Every batch launches the causal
    attention kernel once a layer, the two grouped GEMMs and the combine
    once an expert layer and the head kernel once; no plain version runs;
    the rows counter adds k rows a position; every stored row is finite and
    holds terms."""
    from opensearch_sparse_model_tuning_sample_torch.eval.beir import ingest
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    t0 = time.time()
    rows = moonlight_rows(dev)
    model = se.build_model(arch="moonlight-16b-a3b", seed=0, device=dev)
    cfg = model.cfg
    held = torch.cuda.memory_allocated(dev)
    words = [w for w in model.tokenizer.vocab if w.isalpha() and w.isascii() and len(w) > 2]
    rng = np.random.default_rng(23)
    lens = np.concatenate([moonlight_batch_lens(24)[1][:16], moonlight_batch_lens(25)[1][:16]]) - 2
    corpus = [(f"d{i}", " ".join(rng.choice(words, int(x)))) for i, x in enumerate(lens)]
    tracing.reset()
    out = os.path.join(OUT, "moonlight")
    os.makedirs(out, exist_ok=True)
    t1 = time.time()
    index = ingest(corpus, model, out, "moonlight", max_length=512, batch_size=16,
                   index_cfg=IndexConfig(engine="sparse", l_max=256))
    torch.cuda.synchronize()
    ingest_s = time.time() - t1
    c = tracing.counters()
    nb = sum(v for k, v in c.items() if k.startswith("encoder.batch_len."))
    moe_layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
    want = {"attn.launches.attention_causal_kernel": cfg.num_hidden_layers * nb,
            "moe.launches.moe_gate_up_kernel": moe_layers * nb,
            "moe.launches.moe_down_kernel": moe_layers * nb,
            "moe.launches.moe_combine_kernel": moe_layers * nb,
            "head.launches.maxpool_head": nb,
            "encoder.moe.rows": moe_layers * cfg.num_experts_per_tok * c.get("encoder.positions")}
    for key, val in want.items():
        check(c.get(key) == val, f"moonlight ingest: {key} {c.get(key)}, {val} expected")
    plains = {key: val for key, val in c.items() if ".plain_calls." in key and val}
    check(not plains, f"moonlight ingest: no plain version ({plains})")
    w, _ = index._stored_rows()
    w = w[:index.n_docs].float()
    check(index.n_docs == len(corpus) and bool(torch.isfinite(w).all())
          and bool(((w > 0).sum(1) > 0).all()), "moonlight ingest: every row finite, with terms")
    res = {"kernels": rows, "held_bytes": held, "batches": nb, "docs": len(corpus),
           "ingest_s": ingest_s, "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "counters": {key: c.get(key) for key in want}, "seconds": time.time() - t0}
    del model, index
    torch.cuda.empty_cache()
    return res


# the Kimi Linear cell's traffic: doc lengths in words, one wordpiece a word
LONGDOC_KL = os.path.join(HERE, "lsr_bench", "traffic", "longdoc-12k-32k.json")


def kimi_linear_rows(dev):
    """Kimi Linear's kernels at its cell's shapes, each against its bound
    and its plain version: KDA's two kernels at 32 heads of dk = dv = 128
    over [1, L] for L 64, 4 096 and 32 768 and over the cell's largest batch
    [2, 30 912] (the bound `attn_linear_bound_s` counts: n·H·6·dk·dv
    operations against q, k, v, the decay's and the gate's pre-activations
    and o in bf16, β in fp32); the mixer's three elementwise kernels (the
    short conv with SiLU, with and without the L2 norm, the decay gate, the
    gated norm) over the largest batch [2, 30 912, 32 x 128], against their
    plain torch versions and their bytes; causal MLA at [1, 32 768, 32, 192
    | 128] and the head at [2, 30 912, 2 304, 163 840], each held to its
    plain version on sampled query rows or vocab columns; the held-expert
    GEMMs (128 of 256 experts, 8 a token) over the largest batch's rows, as
    in step 3d (`expert_gemm_rows`)."""
    from opensearch_sparse_model_tuning_sample_torch.ops import attention as at
    from opensearch_sparse_model_tuning_sample_torch.ops import kda as kda_op
    from opensearch_sparse_model_tuning_sample_torch.ops import moe
    from opensearch_sparse_model_tuning_sample_torch.ops.maxpool import (maxpool_head,
                                                                          maxpool_head_reference)

    g = torch.Generator(device=dev).manual_seed(25)
    H, d, rows = 32, 128, []
    for B, L, n in ((1, 64, [64]), (1, 4096, [4096]), (1, 32768, [32768]),
                    (2, 30912, [30853, 20928])):
        q, k = (torch.nn.functional.normalize(torch.randn((B, L, H, d), generator=g, device=dev),
                                              dim=-1).to(torch.bfloat16) for _ in range(2))
        v = torch.randn((B, L, H, d), generator=g, device=dev).to(torch.bfloat16)
        decay = -4.0 * torch.nn.functional.softplus(
            torch.randn((B, L, H, d), generator=g, device=dev) - 3.0)
        beta = torch.sigmoid(torch.randn((B, L, H), generator=g, device=dev))
        got = kda_op.kda(q, k, v, decay, beta, d ** -0.5)
        t0 = time.perf_counter()
        ref = kda_op.kda_chunked_reference(q, k, v, decay, beta, d ** -0.5)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (got - ref).abs() / ref.abs().amax(-1, keepdim=True).clamp_min(1e-6)
        check(float(err.max()) <= 1 / 32 and float(err.mean()) <= 1 / 512,
              f"kda [{B}, {L}]: worst {float(err.max())}, mean {float(err.mean())}")
        ms = cuda_ms(lambda: kda_op.kda(q, k, v, decay, beta, d ** -0.5), 3)
        nt = float(sum(n))
        bound = max(nt * H * 6 * d * d / PEAK_BF16_FLOPS,
                    nt * H * (2 * 6 * d + 4) / PEAK_BYTES_PER_S) * 1e3
        rows.append({"kernel": "kda_intra_kernel+kda_state_kernel", "shape": [B, L, H, d, d],
                     "ms": ms, "bound_ms": bound, "share_of_bound": bound / ms,
                     "plain_ms": plain_ms, "gap_worst": float(err.max()),
                     "gap_mean": float(err.mean())})
        print(f"kimi linear kernels: {json.dumps(rows[-1])}", flush=True)
        del q, k, v, decay, beta, got, ref, err
    torch.cuda.empty_cache()
    rows += kda_elementwise_rows(dev, g)
    # the held experts over the largest batch's real tokens
    T, D, I, E, held, kk = 30853 + 20928, 2304, 1024, 256, 128, 8
    u = torch.randn((T, D), generator=g, device=dev)
    chosen, w = moe.route(u, torch.randn((E, D), generator=g, device=dev) * 0.02,
                          torch.randn(E, generator=g, device=dev) * 0.02, kk, 2.446)
    u = u.to(torch.bfloat16)
    gate, up = ((torch.randn((held, I, D), generator=g, device=dev) * 0.02).to(torch.bfloat16)
                for _ in range(2))
    down = (torch.randn((held, D, I), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    token, offsets, pos = moe.permute(chosen, held, 0)
    gemm_rows, _ = expert_gemm_rows(u, token, gate, up, down, offsets)
    for row in gemm_rows:
        row["shape"] = [T * kk] + row["shape"]  # the rows routed, then the held ones
        rows.append(row)
        print(f"kimi linear kernels: {json.dumps(row)}", flush=True)
    del u, gate, up, down
    torch.cuda.empty_cache()
    # causal MLA at 32 heads over one 32k doc
    L = 32768
    q, k = (torch.randn((1, L, H, 192), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn((1, L, H, 128), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.ones((1, L), dtype=torch.int32, device=dev)
    got = at.attention(q, k, v, mask, causal=True)
    # the plain path's softmax on the query rows of four spread tiles, 8
    # heads at a time (the whole [L, L] would not fit)
    qrows = torch.cat([torch.arange(s, s + 64) for s in (0, 8192, 20480, L - 64)]).to(dev)
    qh, kh, vh = (t[0].transpose(0, 1).float() for t in (q, k, v))
    allowed = torch.arange(L, device=dev)[None, :] <= qrows[:, None]
    worst = 0.0
    for h0 in range(0, H, 8):
        logits = qh[h0:h0 + 8, qrows] @ kh[h0:h0 + 8].transpose(-1, -2) / 192 ** 0.5
        p = torch.softmax(logits.masked_fill(~allowed, float("-inf")), -1)
        ref = (p.to(torch.bfloat16).float() @ vh[h0:h0 + 8]).transpose(0, 1)
        worst = max(worst, float(_rel_rows(got[0, qrows, h0:h0 + 8], ref).max()))
    check(worst <= ATTN_ROW_TOL, f"causal attention at 32 heads, 32k: row gap {worst}")
    del qh, kh, vh, logits, p, ref, got
    ms = cuda_ms(lambda: at.attention(q, k, v, mask, causal=True), 3)
    bound = max(L * (L + 1) / 2 * H * 2 * 320 / PEAK_BF16_FLOPS,
                L * H * 640 * 2 / PEAK_BYTES_PER_S) * 1e3
    rows.append({"kernel": "attention_causal_kernel", "shape": [1, L, H, 192, 128], "ms": ms,
                 "bound_ms": bound, "share_of_bound": bound / ms, "row_gap_worst": worst,
                 "rows_checked": int(qrows.numel()) * H})
    print(f"kimi linear kernels: {json.dumps(rows[-1])}", flush=True)
    del q, k, v
    # the head at D 2 304 over the largest batch
    B, L, V = 2, 30912, 163840
    n = torch.tensor([30853, 20928], device=dev)
    mask = (torch.arange(L, device=dev)[None, :] < n[:, None]).to(torch.int32)
    hh = torch.randn((B, L, D), generator=g, device=dev).to(torch.bfloat16)
    wl = (torch.randn((V, D), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    bias = torch.zeros(V, device=dev)
    got = maxpool_head(hh, mask, wl, bias)
    cols = torch.cat([torch.arange(0, V, 163), torch.arange(V - 64, V)]).unique()[:1024].to(dev)
    ref = maxpool_head_reference(hh, mask, wl[cols].contiguous(), bias[cols].contiguous())
    err = (got[:, cols] - ref).abs()
    check(bool((err <= 1e-3 * ref.abs().clamp_min(1.0)).all()), f"head D 2304: {float(err.max())}")
    ms = cuda_ms(lambda: maxpool_head(hh, mask, wl, bias), 3)
    bound = max(2 * int(n.sum()) * D * V / PEAK_BF16_FLOPS,
                (V * D * 2 + B * L * D * 2 + B * V * 4) / PEAK_BYTES_PER_S) * 1e3
    rows.append({"kernel": "maxpool_head_stream_kernel", "shape": [B, L, D, V], "ms": ms,
                 "bound_ms": bound, "share_of_bound": bound / ms, "worst_gap": float(err.max()),
                 "cols_checked": int(cols.numel())})
    print(f"kimi linear kernels: {json.dumps(rows[-1])}", flush=True)
    del hh, wl
    torch.cuda.empty_cache()
    return rows


def kda_elementwise_rows(dev, g):
    """KDA's three elementwise kernels over the cell's largest batch [2, 30
    912] at 32 heads of 128, on inputs of the model's scales (projections
    of a unit-RMS stream by N(0, 0.02) weights, its A_log, dt_bias and conv
    ranges): `conv_silu` with and without the L2 norm (q and k; v), `decay`
    and `gated_norm`, each against its plain torch version on the same
    inputs (each (position, head) row within 2^-7 of its largest value where
    both round to bf16, 1e-4 where both stay in fp32) and its bytes read and
    written once at 3.35 TB/s."""
    from opensearch_sparse_model_tuning_sample_torch.ops import kda as kda_op

    B, L, H, d, K = 2, 30912, 32, 128, 4
    C, n, rows = H * d, B * L * H * d, []
    x = torch.randn((B, L, C), generator=g, device=dev).to(torch.bfloat16)
    wc = torch.rand((C, K), generator=g, device=dev) - 0.5
    f = torch.randn((B, L, C), generator=g, device=dev) * 0.2
    a_log = torch.log(1.0 + 15.0 * torch.rand(H, generator=g, device=dev))
    dt = torch.exp(math.log(1e-3) + torch.rand(C, generator=g, device=dev) * math.log(100.0))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    o = torch.randn((B, L, H, d), generator=g, device=dev)
    gate = torch.randn((B, L, C), generator=g, device=dev) * 0.2
    wn = 1.0 + 0.1 * torch.randn(d, generator=g, device=dev)
    for name, f_kernel, f_plain, tol, nbytes in (
            ("kda_conv_kernel (norm)", lambda: kda_op.conv_silu(x, wc, d, True),
             lambda: kda_op.conv_silu_reference(x, wc, d, True), 2 ** -7, n * (2 + 2)),
            ("kda_conv_kernel", lambda: kda_op.conv_silu(x, wc, d, False),
             lambda: kda_op.conv_silu_reference(x, wc, d, False), 2 ** -7, n * (2 + 2)),
            ("kda_gate_kernel", lambda: kda_op.decay(f, a_log, dt_bias, d),
             lambda: kda_op.decay_reference(f, a_log, dt_bias, d), 1e-4, n * (4 + 4)),
            ("kda_gated_norm_kernel",
             lambda: kda_op.gated_norm(o, wn, gate, 1e-5, torch.bfloat16),
             lambda: kda_op.gated_norm_reference(o, wn, gate, 1e-5, torch.bfloat16), 2 ** -7,
             n * (4 + 4 + 2))):
        got, ref = f_kernel().float(), f_plain().float()
        err = (got - ref).abs() / ref.abs().amax(-1, keepdim=True).clamp_min(1e-6)
        check(bool(torch.isfinite(got).all()) and float(err.max()) <= tol,
              f"{name}: row gap {float(err.max())} (limit {tol})")
        del got, ref
        ms = cuda_ms(f_kernel, 5)
        plain_ms = cuda_ms(f_plain, 3)
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        rows.append({"kernel": name, "shape": [B, L, H, d], "ms": ms, "bound_ms": bound,
                     "share_of_bound": bound / ms, "plain_ms": plain_ms,
                     "gap_worst": float(err.max())})
        print(f"kimi linear kernels: {json.dumps(rows[-1])}", flush=True)
        del err
    del x, wc, f, o, gate
    torch.cuda.empty_cache()
    return rows


def phase_kimi_linear(dev):
    """Kimi-Linear-48B-A3B through the cell's path (step 3e): the kernel rows
    above, then `build_model`'s `kimi-linear-48b-a3b-ep2` preset on the card
    (51 GB, 128 of 256 experts a layer, drawn a tensor at a time) and
    `eval/beir.py::ingest` of 4 docs at the cell's lengths (batch 2,
    max_length 32 768). Every batch launches the KDA kernels once a KDA
    layer (the conv kernel three times), the causal kernel once an MLA
    layer, the gate-up, down and combine kernels once an expert layer and the head once; no plain version runs;
    `encoder.attn.tokens.linear` adds the positions of every KDA layer;
    every stored row is finite and holds terms."""
    from opensearch_sparse_model_tuning_sample_torch.eval.beir import ingest
    from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    t0 = time.time()
    rows = kimi_linear_rows(dev)
    tracing.reset()
    model = se.build_model(arch="kimi-linear-48b-a3b-ep2", seed=0, device=dev)
    cfg = model.cfg
    held = torch.cuda.memory_allocated(dev)
    words = [w for w in model.tokenizer.vocab if w.isalpha() and w.isascii() and len(w) > 2]
    rng = np.random.default_rng(26)
    lens = [4895, 13504, 20926, 30851]
    corpus = [(f"d{i}", " ".join(rng.choice(words, int(x)))) for i, x in enumerate(lens)]
    out = os.path.join(OUT, "kimi_linear")
    os.makedirs(out, exist_ok=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.time()
    index = ingest(corpus, model, out, "kimi_linear", max_length=32768, batch_size=2,
                   index_cfg=IndexConfig(engine="sparse", l_max=256))
    torch.cuda.synchronize()
    ingest_s = time.time() - t1
    c = tracing.counters()
    nb = sum(v for key, v in c.items() if key.startswith("encoder.batch_len."))
    n_kda = sum(cfg.is_kda(i) for i in range(cfg.num_hidden_layers))
    moe_layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
    want = {"kda.launches.kda_intra_kernel": n_kda * nb,
            "kda.launches.kda_state_kernel": n_kda * nb,
            "kda.launches.kda_conv_kernel": 3 * n_kda * nb,
            "kda.launches.kda_gate_kernel": n_kda * nb,
            "kda.launches.kda_gated_norm_kernel": n_kda * nb,
            "attn.launches.attention_causal_kernel": (cfg.num_hidden_layers - n_kda) * nb,
            "moe.launches.moe_gate_up_kernel": moe_layers * nb,
            "moe.launches.moe_down_kernel": moe_layers * nb,
            "moe.launches.moe_combine_kernel": moe_layers * nb,
            "head.launches.maxpool_head": nb,
            "encoder.attn.tokens.linear": n_kda * c.get("encoder.positions", -1),
            "encoder.moe.experts_held": 128}
    for key, val in want.items():
        check(c.get(key) == val, f"kimi linear ingest: {key} {c.get(key)}, {val} expected")
    plains = {key: val for key, val in c.items() if ".plain_calls." in key and val}
    check(not plains, f"kimi linear ingest: no plain version ({plains})")
    w, _ = index._stored_rows()
    w = w[:index.n_docs].float()
    check(index.n_docs == len(corpus) and bool(torch.isfinite(w).all())
          and bool(((w > 0).sum(1) > 0).all()), "kimi linear ingest: every row finite, with terms")
    res = {"kernels": rows, "held_bytes": held, "batches": nb, "docs": len(corpus),
           "ingest_s": ingest_s, "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "counters": {key: c.get(key) for key in want}, "seconds": time.time() - t0}
    del model, index
    torch.cuda.empty_cache()
    return res


def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    only_mesh = sys.argv[1:] == ["--mesh-only"]
    only_modernbert = sys.argv[1:] == ["--modernbert-only"]
    only_bert_attention = sys.argv[1:] == ["--bert-attention-only"]
    only_moonlight = sys.argv[1:] == ["--moonlight-only"]
    only_kimi_linear = sys.argv[1:] == ["--kimi-linear-only"]
    sys.path.insert(0, HERE)
    from opensearch_sparse_model_tuning_sample_torch.cli.evaluate_beir import prepare_model_args
    from opensearch_sparse_model_tuning_sample_torch.core.config import parse_config
    from opensearch_sparse_model_tuning_sample_torch.core.device import resolve_device
    from opensearch_sparse_model_tuning_sample_torch.data.datasets import (
        BEIRCorpusDataset, KeyValueDataset)
    from opensearch_sparse_model_tuning_sample_torch.eval.beir import resolve_dataset
    from opensearch_sparse_model_tuning_sample_torch.eval.beir import search as beir_search
    from opensearch_sparse_model_tuning_sample_torch.index.engine import SparseIndex
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
    from opensearch_sparse_model_tuning_sample_torch.ops import kernel_build

    # 1. device
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    card = cards[0]
    dev = resolve_device("cuda")
    if only_modernbert or only_bert_attention or only_moonlight or only_kimi_linear:
        print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        if only_modernbert:
            print("modernbert: " + json.dumps(phase_modernbert(dev)), flush=True)
        elif only_moonlight:
            print("moonlight: " + json.dumps(phase_moonlight(dev)), flush=True)
        elif only_kimi_linear:
            print("kimi linear: " + json.dumps(phase_kimi_linear(dev)), flush=True)
        else:
            print("bert attention: " + json.dumps(phase_bert_attention(dev)), flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return
    # step 12's 2.1M-doc corpus, made on one host core while steps 1-11 run
    mesh_corpus = MeshCorpus().start()
    atexit.register(mesh_corpus.stop)
    if only_mesh:
        return mesh_only(dev, "; ".join(cards), mesh_corpus, t_start)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    import datasets
    import safetensors
    import yaml
    print(f"packages: datasets {datasets.__version__}, safetensors {safetensors.__version__}, "
          f"yaml {yaml.__version__}: the CLIs' own formats on the card", flush=True)

    # 2. build every kernel from this checkout's sources, in parallel
    t0 = time.time()
    built = kernel_build.build()
    for name, info in built.items():
        # registers, spills and shared memory per kernel, and any note that
        # ptxas serialized the wgmmas (C75xx)
        report = [ln.strip() for ln in info["log"].splitlines()
                  if "registers" in ln or "spill" in ln or "smem" in ln or "C75" in ln
                  or "Compiling entry" in ln]
        print(f"built {name} in {info['seconds']:.1f} s; ptxas: {report}", flush=True)
    print(f"build phase {time.time() - t0:.1f} s", flush=True)
    os.makedirs(OUT, exist_ok=True)
    os.environ["METRICS_DIR"] = os.path.join(OUT, "metrics")

    # 3. the ingest kernel against its plain version. The eval's ingest
    # batches are B=50 at the L=64 bucket (synthetic-rich docs all fit 64
    # tokens); 128 and 512 are the longer buckets; base is D=768. The last
    # row is the eval's own first batch (random-init mini), at real lengths.
    model_args, data_args, training_args = parse_config(model_config(dev))
    corpus, queries, qrels = resolve_dataset("synthetic-rich", data_args.beir_dir)
    docs = BEIRCorpusDataset(corpus)
    model = se.from_model_args(model_args, seed=training_args.seed, device=dev)
    shapes = [(50, 64, 256, 30592), (50, 128, 256, 30592), (50, 512, 256, 30592),
              (8, 512, 768, 30592)]
    t0 = time.time()
    batch, cast_ms = main_path_batch(
        model, [docs[i][1] for i in range(training_args.per_device_eval_batch_size)], dev)
    rows = phase_kernels(dev, shapes, batch)
    ingest_batch = [t.cpu() for t in batch]
    del batch, model
    print(f"kernel phase {time.time() - t0:.1f} s", flush=True)
    # 3b. ModernBERT-large: the fused attention of both kinds at the long-doc
    # cell's shapes against its plain version, then its ingest path
    print("modernbert: " + json.dumps(phase_modernbert(dev)), flush=True)
    # 3c. BERT's attention through the same kernel at distil-ingest's shapes,
    # then an ingest with its launch and plain-chain counters
    bert_attn = phase_bert_attention(dev)
    print("bert attention: " + json.dumps(bert_attn), flush=True)
    # 3d. Moonlight-16B-A3B: its expert GEMMs, causal attention and the head
    # at D 2 048 at the cell's shapes, then its ingest path
    print("moonlight: " + json.dumps(phase_moonlight(dev)), flush=True)
    # 3e. Kimi-Linear-48B-A3B: KDA's kernels, the held-expert share, causal MLA
    # at 32k and the head at D 2 304 at the cell's shapes, then its ingest path
    print("kimi linear: " + json.dumps(phase_kimi_linear(dev)), flush=True)
    # the training forward's ablations at the train step's L = 64 bucket, the
    # longest, L = 512 (eight chunks a doc), and D = 768 (2-stage rings); its
    # main-path batch later
    train_shapes = [(45, 64, 256, 30592), (45, 128, 256, 30592), (45, 512, 256, 30592),
                    (8, 512, 768, 30592)]
    t0 = time.time()
    libs = _build_ablations(os.path.join(HERE, "build", "maxpool_ablation"))
    ablation = phase_ablation(dev, libs, shapes, INGEST_ABLATIONS)
    ablation_argmax = phase_ablation(dev, libs, [train_shapes[i] for i in (0, 2, 3)],
                                     ARGMAX_ABLATIONS)
    print(f"ablation phase {time.time() - t0:.1f} s", flush=True)

    # 4. the training kernels against their plain versions: the train step's
    # doc batch is 15 queries x (1 pos + 2 negs) = 45 docs at L = 64; 128 and
    # 512 are the longer buckets; D = 768 the base width
    t0 = time.time()
    train_rows = phase_train_kernels(dev, train_shapes)
    phase_argmax_ties(dev)
    print(f"train-kernel phase {time.time() - t0:.1f} s", flush=True)

    # 5. the main path: mine -> train -> evaluate, through the entry points
    rate = _IngestRate()
    logging.getLogger("opensearch_sparse_model_tuning_sample_torch.eval.beir").addHandler(rate)
    t0 = time.time()
    path = phase_train_path(dev)
    print(f"main path {time.time() - t0:.1f} s (mine {path['mine_s']:.1f}, train "
          f"{path['train_s']:.1f}, evaluate {path['eval_s']:.1f})", flush=True)
    avg = path["avg"]
    launches = path["eval"][0]["maxpool_head"]
    n_docs = len(docs)
    n_batches = -(-n_docs // path["cfg"]["per_device_eval_batch_size"])
    print(f"evaluate: {n_docs} docs, {len(queries)} queries, maxpool_head launches {launches} "
          f"for {n_batches} ingest batches", flush=True)
    check(launches >= n_batches, "the ingest kernel ran for every ingest batch")
    check(0.0 <= avg["NDCG@10"] <= 1.0 and avg["flops"] > 0, "finite metrics")

    # 6. one whole train step with the kernels against the plain head, and
    # the training kernels on that main-path batch
    t0 = time.time()
    captured, grad_worst, np_batch = grad_check(path["trainer"], dev)
    docs_per_step = path["cfg"]["per_device_train_batch_size"] * (
        1 + path["cfg"]["sample_num_one_query"])
    profile = profile_steps(path["trainer"], np_batch, 1e3 * docs_per_step / path["docs_per_s"])
    main_train = train_kernel_rows("main-path batch", *captured["args"], captured["g"])
    ablation_argmax["main-path batch"] = ablation_times(libs, ARGMAX_ABLATIONS,
                                                        *captured["args"])
    # the head's inputs on the main path, for compare_head_kernels.py
    torch.save({"ingest": ingest_batch,
                "train": [t.cpu() for t in captured["args"] + (captured["g"],)]},
               os.path.join(OUT, "main_batches.pt"))
    print(f"gradient check and main-path train rows {time.time() - t0:.1f} s", flush=True)

    # 7. the exact scan of the trained checkpoint's index against brute force
    ma, da, ta = parse_config(path["path"])
    prepare_model_args(ma, ta.output_dir, ta.max_steps)
    check(ma.model_name_or_path == path["ckpt"], "evaluate_beir read the exported checkpoint")
    ckpt_model = se.from_model_args(ma, seed=ta.seed, device=dev)
    qd = KeyValueDataset(queries)
    enc = se.BatchEncoder(ckpt_model, max_length=512)
    q = enc.encode_batch_device([qd[i][1] for i in range(len(qd))], inf_free=True, rows=50)
    nq = q.shape[0]
    index_dir = os.path.join(ta.output_dir, "beir_eval", "synthetic-rich.index")
    index = SparseIndex.load(index_dir, device=dev)
    hits = index.search(q, k=10)
    n_hits = brute_force_check(index_dir, q, hits, ckpt_model.vocab_size, dev)
    print(f"exact scan top-10 equals brute force for all {nq} queries ({n_hits} hits)", flush=True)
    # the main path reads search q/s once, on the process's first search
    # call; the same call repeated on the warm process shows its spread
    warm_qps = [beir_search(queries, ckpt_model, index, os.path.dirname(index_dir),
                            "synthetic-rich", max_length=512, batch_size=50,
                            result_size=100)["qps"] for _ in range(3)]
    print(f"search q/s repeated on the warm process: {warm_qps}", flush=True)
    enc_err = encoder_check(ckpt_model, [docs[i][1] for i in range(256)], da.index_l_max, dev)
    print(f"encoder top-{da.index_l_max} with the kernel equals the plain head "
          f"for 256 docs (max |err| {enc_err:.3g})", flush=True)
    print(f"ingest {rate.docs_per_s:.1f} docs/s, search {avg['qps']:.1f} q/s, "
          f"NDCG@10 {avg['NDCG@10']:.5f} after {TRAIN_STEPS} steps from random init; "
          f"train {path['docs_per_s']:.1f} docs/s; card {card}", flush=True)
    del index, q
    torch.cuda.empty_cache()

    # 8. the serving path: cli.serve over this index and a 131 072-doc one
    t0 = time.time()
    serve_out = phase_serve(dev, path["ckpt"], index_dir, [docs[i][1] for i in range(1100)],
                            [qd[i][1] for i in range(N_TEXT_QUERIES)])
    serve_out.update(seconds=time.time() - t0, card=card)
    print(f"serving phase {serve_out['seconds']:.1f} s (indexes {serve_out['build_s']:.1f}, "
          f"requests {serve_out['drive_s']:.1f}, checks {serve_out['check_s']:.1f}); token burst "
          f"{serve_out['burst_qps']:.1f} q/s, p50 {serve_out['p50_ms']:.2f} ms, p95 "
          f"{serve_out['p95_ms']:.2f} ms, /_stats {serve_out['stats']} (host clock, card {card})",
          flush=True)

    # 9. the inverted engine on the evaluation path
    inv_eval = phase_inverted_eval(dev, path)

    # 10. knowledge distillation: the kd recipe with two sparse teachers,
    # make_kd_scores, the L0 recipe and its eval, the new layouts
    distill = phase_distill(dev, path, n_docs)
    print(f"distillation phase {distill['seconds']:.1f} s", flush=True)

    # 11. the multi-process launch: torchrun at world 1 on NCCL, two ranks'
    # eval ingest and mining on the card, the data CLIs
    dist_out = phase_distributed(dev, path, n_docs, (corpus, queries, qrels))

    # 12. the device mesh inside one process: the scan, bench.py's 2.1M-doc
    # corpus on the inverted engine, the eval and merge_saved over a mesh
    mesh_out = phase_mesh(dev, path, (corpus, queries, qrels), mesh_corpus)

    # 13. training over the mesh inside one process: the infonce recipe over
    # four positions against one position at the global batch, a kd step with
    # the main path's two checkpoints as teachers, a step with A = 2
    mesh_train = phase_mesh_train(
        dev, (corpus, queries, qrels),
        [path["ckpt"], os.path.join(path["cfg"]["output_dir"], f"checkpoint-{TRAIN_STEPS // 2}")],
        card)
    print(f"total {time.time() - t_start:.1f} s", flush=True)

    main_row = rows[-1]  # the eval's own first batch
    kernels = [{
        "name": "maxpool_head",
        "route": "cuda",
        "source": "opensearch_sparse_model_tuning_sample_torch/csrc/maxpool_head.cu",
        "replaces": "opensearch_sparse_model_tuning_sample_tpu/ops/pallas_maxpool.py:99",
        "launches": launches,
        "serve_launches": serve_out["launches"],
        "kd_launches": {"kd_teachers": distill["kd"]["launches"]["maxpool_head"],
                        "kd_teachers_per_step": distill["kd"]["launches"]["maxpool_head"]
                        / distill["kd"]["steps"],
                        "make_kd_scores": distill["kd_data"]["launches"]["maxpool_head"],
                        "l0_eval": distill["l0"]["eval_launches"]},
        "dist_launches": {"eval_rank0": dist_out["11b"]["launches"][0],
                          "eval_rank1": dist_out["11b"]["launches"][1],
                          "mine_rank0": dist_out["11c"]["launches"][0]["maxpool_head"],
                          "mine_rank1": dist_out["11c"]["launches"][1]["maxpool_head"]},
        "mesh_launches": {run: mesh_out["12c"][run]["launches"]
                          for run in ("docs_scan", "docs_inverted")},
        "mesh_train_launches": {"kd_step": mesh_train["13b"]["launches"]["maxpool_head"]},
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
    sources = {
        "maxpool_head_argmax": ("csrc/maxpool_head.cu",
                                "opensearch_sparse_model_tuning_sample_tpu/ops/pallas_maxpool.py:99"),
        "maxpool_head_bwd_w": ("csrc/maxpool_head_bwd.cu",
                               "opensearch_sparse_model_tuning_sample_tpu/models/bert.py:360"),
        "maxpool_head_bwd_h": ("csrc/maxpool_head_bwd.cu",
                               "opensearch_sparse_model_tuning_sample_tpu/models/bert.py:360"),
    }
    for name, (src, replaces) in sources.items():
        r = main_train[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"opensearch_sparse_model_tuning_sample_torch/{src}",
            "replaces": replaces,
            # the backward has no Pallas kernel: JAX differentiates its scan head
            "jax_counterpart": "pallas_call forward" if name.endswith("argmax")
            else "XLA autodiff of models/bert.py:360-402 mlm_maxpool",
            "launches": path["train"][0][name],
            "max_abs_err": max([r["max_abs_err"]] + [t[name]["max_abs_err"] for t in train_rows]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "share_of_bound": r["share_of_bound"], "shape": r["shape"],
            "inputs": "main-path batch",
            "launches_per_train_step": path["train"][0][name] / path["steps"],
            "kd_launches": {"kd": distill["kd"]["launches"][name],
                            "l0": distill["l0"]["launches"][name]},
            "dist_launches": {"torchrun": dist_out["11a"]["kernels"][name],
                              "kd_torchrun": dist_out["11d"]["kernels"][name]},
            "mesh_train_launches": {
                "infonce_step": mesh_train["13a"]["first_step"]["launches"][name],
                "kd_step": mesh_train["13b"]["launches"][name],
                "accumulation_step": mesh_train["13c"]["launches"][name]},
            **({"bucket_ms": r["bucket_ms"]} if "bucket_ms" in r else {}),
            **({"ablation_ms": ablation_argmax} if name.endswith("argmax") else {}),
            "nnz": r["nnz"],
            "all_shapes": [t[name] for t in train_rows] + [r],
        })
    # BERT's attention: the kernel's launches on every inference path of the
    # main run (the eval's counted from 0 just before it), none in training;
    # its times at the main path's eval shape from step 3c
    main_attn = next(r for r in bert_attn["attention"] if r["shape"][2] == 4)
    kernels.append({
        "name": "attention_global_kernel", "route": "cuda",
        "source": "opensearch_sparse_model_tuning_sample_torch/csrc/attention.cu",
        "replaces": None,
        "jax_counterpart": "XLA's fusion of the plain jnp attention of "
                           "opensearch_sparse_model_tuning_sample_tpu/models/bert.py",
        "launches": path["eval_attention"]["attention_global_kernel"],
        "plain_chain": path["eval_attention"]["plain_chain"],
        "train_launches": path["train_attention"]["attention_global_kernel"],
        "train_plain_chain": path["train_attention"]["plain_chain"],
        "serve_launches": serve_out["attention"]["attention_global_kernel"],
        "kd_launches": {"kd_teachers": distill["kd"]["attention"]["attention_global_kernel"],
                        "kd_student_plain_chain": distill["kd"]["attention"]["plain_chain"]},
        "dist_launches": {f"eval_rank{r}": a["attention_global_kernel"]
                          for r, a in enumerate(dist_out["11b"]["attention"])},
        "mesh_launches": {run: mesh_out["12c"][run]["attention"]["attention_global_kernel"]
                          for run in ("docs_scan", "docs_inverted")},
        "ingest_kernel_share": bert_attn["kernel_share"],
        "max_row_gap": max(r["row_gap_worst"] for r in bert_attn["attention"]),
        "ms": main_attn["kernel_ms"],
        "kernel_ms": main_attn["kernel_ms"],
        "plain_ms": main_attn["plain_chain_ms"],
        "bound_ms": main_attn["bound_ms"],
        "bound_by": main_attn["bound_by"],
        "library_ms": main_attn["sdpa_ms"],
        "share_of_bound": main_attn["share_of_bound"],
        "shape": main_attn["shape"],
        "inputs": "the main path's eval shape, random q, k, v",
        "all_shapes": bert_attn["attention"],
    })
    print("train path: " + json.dumps({
        "steps": path["steps"], "train_docs_per_s": path["docs_per_s"],
        "full_step_grad_worst_rel_err": grad_worst, "profile": profile,
        "log": path["trainer"].log_history, "ndcg_at_10": avg["NDCG@10"]}))
    print("serve: " + json.dumps(serve_out))
    print("inverted eval: " + json.dumps(inv_eval))
    print("distill: " + json.dumps(distill))
    print("distributed: " + json.dumps(dist_out))
    print("mesh: " + json.dumps(mesh_out))
    print("mesh train: " + json.dumps(mesh_train))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
