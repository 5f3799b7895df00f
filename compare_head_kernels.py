"""Time the max-pool head's kernels of several checkouts of this repo on the
same inputs, on one CUDA card:

    python3 compare_head_kernels.py INPUTS ROOT [ROOT ...]

INPUTS is the file that `chip_smoke.py` saves, `output/chip_smoke/
main_batches.pt`: the eval's first ingest batch (h, mask, w, bias) and one
train step's head inputs with their upstream gradient (h, mask, w, bias, g).
Each ROOT is a checkout of the repo (an older commit unpacked with `git
archive`, say). Each runs in a process of its own, in the order given (give
A B B A to compare two), builds its kernels from its own sources, and calls
its own wrappers: the ingest forward, the training forward (whose argmax the
backward takes), bwd_w and bwd_h. The backward is timed as each wrapper
returns it and through to the bf16 gradient that the autograd Function
hands on (a `.to(torch.bfloat16)` after the wrapper, a no-op where the
wrapper writes bf16).

Every time comes from `cuda_ms` of the `chip_smoke.py` beside this script,
twice: with the stream asleep on the card while the host queues the runs
(device time), and without (host-paced: a kernel shorter than its wrapper's
Python then reads the host's launch rate). Each output is held against its
checkout's plain version (the training forward's values, and the logit at
each position it names). The last line is a JSON object
{"runs": [{"root", "ms", "host_paced_ms", "max_abs_err"}, ...]}; before it,
the card's name and power limit.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_root(root, inputs):
    """Build and time one checkout's kernels; returns its run's dict."""
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from opensearch_sparse_model_tuning_sample_torch.ops import kernel_build
    from opensearch_sparse_model_tuning_sample_torch.ops import maxpool as mp

    if not mp.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {mp.__file__}, not the package under {root}")
    cs = _chip_smoke()
    kernel_build.build()
    dev = torch.device("cuda")
    saved = torch.load(inputs)
    ih, imask, iw, ibias = (t.to(dev) for t in saved["ingest"])
    h, mask, w, bias, g = (t.to(dev) for t in saved["train"])
    with torch.no_grad():
        pooled, idx = mp.maxpool_head_argmax(h, mask, w, bias)
        fns = {
            "maxpool_head": lambda: mp.maxpool_head(ih, imask, iw, ibias),
            "maxpool_head_argmax": lambda: mp.maxpool_head_argmax(h, mask, w, bias),
            "maxpool_head_bwd_w": lambda: mp.maxpool_head_bwd_w(g, idx, mask, h),
            "maxpool_head_bwd_w_to_bf16":
                lambda: mp.maxpool_head_bwd_w(g, idx, mask, h)[0].to(torch.bfloat16),
            "maxpool_head_bwd_h": lambda: mp.maxpool_head_bwd_h(g, idx, mask, w),
            "maxpool_head_bwd_h_to_bf16":
                lambda: mp.maxpool_head_bwd_h(g, idx, mask, w).to(torch.bfloat16),
        }
        err = {
            "maxpool_head": cs._close(fns["maxpool_head"](),
                                      mp.maxpool_head_reference(ih, imask, iw, ibias),
                                      f"maxpool_head of {root}"),
            # the values against the plain head, and the logit at each
            # argmax against the value (near-ties may name another position
            # than the plain argmax)
            "maxpool_head_argmax": max(
                cs._close(pooled, mp.maxpool_head_reference(h, mask, w, bias),
                          f"maxpool_head_argmax of {root}"),
                cs._close(cs.value_at(h, mask, w, bias, idx), pooled,
                          f"the logit at maxpool_head_argmax's positions of {root}")),
            "maxpool_head_bwd_w": cs._close_bf16(fns["maxpool_head_bwd_w_to_bf16"](),
                                                 mp.maxpool_head_bwd_w_reference(g, idx, mask, h)[0],
                                                 f"bwd_w of {root}"),
            "maxpool_head_bwd_h": cs._close_bf16(fns["maxpool_head_bwd_h_to_bf16"](),
                                                 mp.maxpool_head_bwd_h_reference(g, idx, mask, w),
                                                 f"bwd_h of {root}"),
        }
        ms = {k: cs.cuda_ms(f, iters=20) for k, f in fns.items()}
        host_paced = {k: cs.cuda_ms(f, iters=20, sleep=False) for k, f in fns.items()}
    return {"root": root, "ms": ms, "host_paced_ms": host_paced, "max_abs_err": err}


def main():
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(time_root(sys.argv[3], sys.argv[2])))
        return
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_head_kernels: no CUDA device")
    inputs, roots = sys.argv[1], sys.argv[2:]
    runs = []
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", inputs, root],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.exit(f"{root} failed:\n{out.stdout[-4000:]}{out.stderr[-4000:]}")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(f"{root}: " + ", ".join(
            f"{k} {v:.4f} ms (host-paced {run['host_paced_ms'][k]:.4f})" for k, v in run["ms"].items()),
            flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0])
    print(json.dumps({"runs": runs}))


if __name__ == "__main__":
    main()
