"""The port's device mesh inside one process (`core/mesh.py`), its two mesh
collectives (`parallel/collectives.py::merged_topk`, `global_batch_fn`)
against the JAX package's inside `shard_map` on tests/conftest.py's
8-device CPU mesh, the CLIs' mesh, and `parallel/dryrun.py`.

Tolerances: none. Merged ids and scores are equal (ties included: both
keep the lower shard); the function of the global batch sums small
integers, which is exact in any order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from opensearch_sparse_model_tuning_sample_tpu.core import mesh as jmesh
from opensearch_sparse_model_tuning_sample_tpu.parallel import collectives as jcoll
from opensearch_sparse_model_tuning_sample_torch.core import mesh as tmesh
from opensearch_sparse_model_tuning_sample_torch.parallel import collectives as tcoll
from opensearch_sparse_model_tuning_sample_torch.parallel.dryrun import dryrun_multichip

torch.set_num_threads(2)

N = 8  # the JAX side's mesh8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cpu8():
    return tmesh.make_mesh(devices=["cpu"] * N)


def test_make_mesh_default_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(devices=["cuda"])  # a named card needs one too


def test_make_mesh_default_takes_every_visible_card_once(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = tmesh.make_mesh()
    assert m.devices == tuple(torch.device("cuda", i) for i in range(3))
    assert not m.repeats and jmesh.DATA_AXIS == tmesh.DATA_AXIS
    assert tmesh.make_mesh(2).devices == m.devices[:2]


def test_make_mesh_dp_size_beyond_the_devices_raises_as_jax(mesh8):
    with pytest.raises(ValueError, match="dp_size 9 > available devices 8"):
        jmesh.make_mesh(9)
    with pytest.raises(ValueError, match="dp_size 9 > available devices 8"):
        tmesh.make_mesh(9, devices=["cpu"] * N)


def test_make_mesh_repeats_only_what_the_caller_lists(cpu8):
    assert cpu8.size == N and cpu8.repeats and set(cpu8.devices) == {CPU}
    assert tmesh.make_mesh(3, devices=["cpu"] * N).size == 3
    assert not tmesh.make_mesh(devices=["cpu"]).repeats


def test_shard_rows_and_replicate(cpu8):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    parts = tmesh.shard_rows(cpu8, x)
    assert len(parts) == N and all(p.shape == (2, 3) for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    with pytest.raises(ValueError, match="do not split"):
        tmesh.shard_rows(cpu8, x[:15])
    reps = tmesh.replicate(cpu8, x)
    assert len(reps) == N and all(r is reps[0] for r in reps)  # one copy per device


def test_process_mesh_of_the_clis():
    # one process on the CPU: a one-CPU mesh (the single-device index)
    assert tmesh.process_mesh(CPU).devices == (CPU,)
    with pytest.raises(ValueError, match="dp_size 2"):
        tmesh.process_mesh(CPU, dp_size=2)
    # a rank of a launch: its own device, whatever dp_size says
    assert tmesh.process_mesh(CPU, dp_size=4, world_size=2).devices == (CPU,)


def _jax_merged(mesh8, scores, idx, k):
    fn = shard_map(lambda s, i: jcoll.merged_topk(s, i, k), mesh=mesh8,
                   in_specs=(P("data"), P("data")), out_specs=(P(), P()), check_vma=False)
    s, i = jax.jit(fn)(scores, idx)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_merged_topk_matches_jax(mesh8, ties):
    """Per-shard [B, k] lists (shard s holds rows [s*B, (s+1)*B) of the
    stacked arrays, as P("data") splits them): the port's merge of the
    shards' lists equals JAX's all-gather + lax.top_k, ids and order. With
    ties every shard's scores come from a few values, so equal scores span
    shards and the lower shard must win."""
    B, k = 3, 4
    rng = np.random.default_rng(1)
    if ties:
        scores = rng.choice([3.0, 2.0, 1.0], size=(N * B, k)).astype(np.float32)
        scores = -np.sort(-scores, axis=1)  # each shard's list is a top-k: descending
    else:
        scores = -np.sort(-rng.normal(size=(N * B, k)).astype(np.float32), axis=1)
    idx = (np.arange(N)[:, None, None] * 100 + rng.permutation(100)[:B * k].reshape(B, k)
           ).reshape(N * B, k).astype(np.int32)
    js, ji = _jax_merged(mesh8, scores, idx, k)
    ts, ti = tcoll.merged_topk(
        [torch.from_numpy(scores[s * B:(s + 1) * B]) for s in range(N)],
        [torch.from_numpy(idx[s * B:(s + 1) * B]) for s in range(N)], k)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(ti.numpy(), ji)


def _jfn(x, y):
    """One small function of the global batch: row sums times y's mean, and
    the column maxima."""
    return (x.sum(1) * y.mean(), jnp.max(x, axis=0)[None, :])


def _tfn(x, y):
    return (x.sum(1) * y.mean(), x.amax(0)[None, :])


@pytest.mark.parametrize("replicated_out", [True, False], ids=["replicated", "sharded_out"])
def test_global_batch_fn_matches_jax(mesh8, cpu8, replicated_out):
    # small integers: every sum is exact, whatever order either side adds in
    rng = np.random.default_rng(2)
    x = rng.integers(-5, 6, size=(16, 5)).astype(np.float32)
    y = rng.integers(-5, 6, size=(16,)).astype(np.float32)
    want = jcoll.global_batch_fn(_jfn, mesh8, replicated_out=replicated_out)(x, y)
    got = tcoll.global_batch_fn(_tfn, cpu8, replicated_out=replicated_out)(
        torch.from_numpy(x), torch.from_numpy(y))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_global_batch_fn_arity_rules_match_jax(mesh8, cpu8):
    for mod, m in ((jcoll, mesh8), (tcoll, cpu8)):
        with pytest.raises(TypeError, match="explicit n_args"):
            mod.global_batch_fn(lambda *a: a[0], m)
    # with n_args a *args callable is fine
    x = np.arange(16, dtype=np.float32)
    want = jcoll.global_batch_fn(lambda *a: a[0] * 2, mesh8, n_args=1)(x)
    got = tcoll.global_batch_fn(lambda *a: a[0] * 2, cpu8, n_args=1)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError, match="n_args=1"):
        tcoll.global_batch_fn(lambda a: a, cpu8)(torch.zeros(8), torch.zeros(8))


def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip(2)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): train step ok over 2 gloo ranks"), line
    assert "sharded search ok" in line and "query-sharded search ok" in line
