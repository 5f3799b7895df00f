"""Host spans on the profiler's clock, and the process's counters.

`span(name)` marks a stretch of host code as the range `lsr.<name>`. It is
on exactly while a `torch.profiler` records on the calling thread: then it
is a `record_function`, a host event on the same timeline as the card's
operations, so a trace can place device work by the span that launched it
and an idle gap by the span the host was in when it began. Off, it returns
one shared null context after one check of the profiler's state, and makes
no `RecordFunction`. A span reads only host state: it adds no wait for the
device.

Span names are `<layer>.<what>` (`data.tokenize`, `encoder.copy_out`,
`index.add`, `train.backward`, ...); the profiler window of
`Trainer(profile_dir=...)` and the benchmark's traces show them.

`count(name, n)` adds to one of the process's integer counters (kernel
launches, collective calls, postings builds, encoder positions and
tokens, the ingest batches run at each length as `encoder.batch_len.<L>`,
the ingest chunks resolved through their own event as
`encoder.copy_out.async` and, of those, the ones still being copied when
resolved as `encoder.copy_out.waited`, BERT's attention layer calls that
took the plain chain and not the fused kernel as `encoder.attn.plain_chain`,
the query-key pairs each attention kind's launches compute as
`encoder.attn.pairs.global`, `.local` and `.causal`, the positions that
Kimi Linear's KDA mixers run (padding included, summed over its layers) as
`encoder.attn.tokens.linear`, an expert layer's token-expert rows as
`encoder.moe.rows`, counted on the host from the shapes, the experts each
expert layer holds as `encoder.moe.experts_held` (added once when a model
that holds a share is built), and each kernel's launches as
`<family>.launches.<kernel>`: `head.`, `attn.` (`attention_causal_kernel`
among them), `moe.` (`moe_gate_up_kernel`, `moe_down_kernel`,
`moe_combine_kernel`) and `kda.` (`kda_intra_kernel`, `kda_state_kernel`,
`kda_conv_kernel`, `kda_gate_kernel`, `kda_gated_norm_kernel`), with their plain versions' calls as
`<family>.plain_calls.<plain>`), and
BERT's CUDA graphs of its encoder stack (`models/bert.py::GraphRunner`) as
`encoder.graph.captures` and `encoder.graph.replays`, with the ingest
batches that ran the stack eagerly as `encoder.graph.eager`;
`counters()` returns them all, `reset()` sets them back. Inside
`recording()` the counts a thread raises go to a dict of its own and not to
the registry: a CUDA graph's capture keeps them, and `add` adds them again
at each replay.

The expert layer's spans (`ops/moe.py`) are `encoder.moe.route` (router,
top-k, weights), `encoder.moe.permute` (the sort, the gather of the rows,
the combine) and `encoder.moe.experts` (the grouped GEMMs); Moonlight's
and Kimi Linear's MLA cores run in `encoder.attn.causal`, and each of Kimi
Linear's KDA mixers (from the projections' outputs to the gated norm's
output before W_o) in `encoder.attn.linear`.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Iterable, Optional

import torch

PREFIX = "lsr."

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """The host range `lsr.<name>` while a profiler records, else a null
    context."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str):
    """Decorator: each call of the function in `span(name)`."""

    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            with span(name):
                return f(*args, **kwargs)

        return inner

    return wrap


_counts: Dict[str, int] = {}
# autograd runs the backward on one thread per device, and the head's
# backward kernels count their launches there
_lock = threading.Lock()
# the dict of the innermost `recording()` on each thread
_local = threading.local()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (created at 0)."""
    kept = getattr(_local, "kept", None)
    if kept is not None:
        kept[name] = kept.get(name, 0) + n
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def add(counts: Dict[str, int]) -> None:
    """Add each of `counts` to its counter."""
    with _lock:
        for name, n in counts.items():
            _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Within, the counts this thread raises go to the dict yielded, and
    not to the registry."""
    outer = getattr(_local, "kept", None)
    _local.kept = kept = {}
    try:
        yield kept
    finally:
        _local.kept = outer


def counters() -> Dict[str, int]:
    """A copy of every counter raised so far in this process."""
    with _lock:
        return dict(_counts)


def reset(names: Optional[Iterable[str]] = None) -> None:
    """Set the counters `names` (all of them by default) back to 0."""
    with _lock:
        if names is None:
            _counts.clear()
        else:
            for k in names:
                _counts.pop(k, None)
