"""Query a saved index from the command line (the port of the JAX package's
`cli/search.py`; the reference delegates this to OpenSearch).

Build an index once (cli/evaluate_beir, or SparseIndex.save), then:

    python -m opensearch_sparse_model_tuning_sample_torch.cli.search \
        --index out/idx --model <ckpt> --queries queries.txt --k 10 \
        [--trec run.txt] [--two-phase] [--full-encode] [--device cpu]

`queries.txt`: one query per line, or TSV `qid\ttext`. Output: JSON lines
{qid, hits: {doc_id: score}} to stdout, optionally a TREC run file. Runs on
the CUDA card unless `--device cpu`, and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os

from ..core.device import resolve_device
from ..index.engine import SparseIndex
from ..models import sparse_encoder as se


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--index", required=True, help="SparseIndex.save() dir")
    p.add_argument("--model", default=None,
                   help="checkpoint dir (default: a seeded random `--arch` encoder)")
    p.add_argument("--arch", default="mini")
    p.add_argument("--idf", default=None, help="idf asset path (default bundled)")
    p.add_argument("--queries", required=True, help="text file: query per line or qid\\ttext")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--max-length", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--query-prune", type=float, default=0.0)
    p.add_argument("--two-phase", action="store_true")
    p.add_argument("--full-encode", action="store_true",
                   help="full model forward for queries instead of inf-free")
    p.add_argument("--trec", default=None, help="also write a TREC run file")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    model = se.build_model(
        model_name_or_path=args.model, arch=args.arch,
        idf_path=args.idf or os.path.join(repo, "assets", "idf.npz"), device=device,
    )
    index = SparseIndex.load(args.index, device=device)
    encoder = se.BatchEncoder(model, max_length=args.max_length, do_count=False)

    qids, texts = [], []
    with open(args.queries, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.rstrip("\n")
            if not line:
                continue
            if "\t" in line:
                qid, text = line.split("\t", 1)
            else:
                qid, text = f"q{i}", line
            qids.append(qid)
            texts.append(text)

    trec_f = open(args.trec, "w") if args.trec else None
    try:
        for s in range(0, len(texts), args.batch_size):
            reps = encoder.encode_batch_device(texts[s:s + args.batch_size],
                                               inf_free=not args.full_encode)
            hits = index.search(reps, k=args.k, query_prune=args.query_prune,
                                two_phase=args.two_phase)
            for qid, h in zip(qids[s:s + args.batch_size], hits):
                print(json.dumps({"qid": qid, "hits": h}))
                if trec_f:
                    for rank, (did, score) in enumerate(
                            sorted(h.items(), key=lambda kv: -kv[1]), 1):
                        # the JAX package's run tag, so the two packages'
                        # run files compare line for line
                        trec_f.write(f"{qid} Q0 {did} {rank} {score:.6f} sparse-tpu\n")
    finally:
        if trec_f:
            trec_f.close()


if __name__ == "__main__":
    main()
