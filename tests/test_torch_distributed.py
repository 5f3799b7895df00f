"""The port's process-group wiring (`core/distributed.py`) and its
`all_gather_batch` (`parallel/collectives.py`), held to the JAX package's
`parallel/collectives.all_gather_batch` on the same inputs.

The gather runs on two gloo processes on the CPU, each with a timeout, with
OMP_NUM_THREADS=1. Forward: every rank sees the concat of both ranks' rows,
in rank order, equal to JAX's tiled all-gather over a 2-device mesh.
Backward: each rank gets its own slice of the incoming gradient, so the sum
over ranks is the gradient JAX's transpose (a psum-scatter) gives each
device's shard. Values are exact (no arithmetic but a copy and a slice).
"""

import datetime
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from opensearch_sparse_model_tuning_sample_tpu.core.mesh import DATA_AXIS, make_mesh
from opensearch_sparse_model_tuning_sample_tpu.parallel import collectives as jcoll
from opensearch_sparse_model_tuning_sample_torch.cli import train_ir
from opensearch_sparse_model_tuning_sample_torch.core import distributed
from test_torch_dist_train import spawn

ROWS, COLS = 3, 5

GATHER_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    from opensearch_sparse_model_tuning_sample_torch.core import distributed
    from opensearch_sparse_model_tuning_sample_torch.parallel import collectives

    out = sys.argv[1]
    assert distributed.maybe_init_distributed("cpu", timeout_s=60)
    rank = distributed.rank()
    assert distributed.backend() == "gloo" and distributed.world_size() == 2
    x = torch.from_numpy(np.load(os.path.join(out, "x.npy"))[rank]).requires_grad_(True)
    w = torch.from_numpy(np.load(os.path.join(out, "w.npy")))
    y = collectives.all_gather_batch(x)
    (y * w).sum().backward()
    with torch.no_grad():
        z = collectives.all_gather_batch(x * 2)
    assert not z.requires_grad
    distributed.barrier()
    np.savez(os.path.join(out, f"rank{rank}.npz"), y=y.detach().numpy(), grad=x.grad.numpy(),
             z=z.numpy())
    distributed.destroy()
""")


def test_all_gather_batch_on_two_gloo_ranks_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, ROWS, COLS)).astype(np.float32)  # [rank, rows, cols]
    w = rng.normal(size=(2 * ROWS, COLS)).astype(np.float32)  # d loss / d gathered
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "w.npy", w)
    spawn(GATHER_WORKER, [str(tmp_path)], timeout=90)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]

    mesh = make_mesh(2)

    def gathered_loss(xs):
        y = shard_map(lambda s: jcoll.all_gather_batch(s), mesh=mesh, in_specs=P(DATA_AXIS),
                      out_specs=P(), check_vma=False)(xs)
        return (y * w).sum(), y

    (_, want_y), want_g = jax.value_and_grad(gathered_loss, has_aux=True)(
        jnp.asarray(x.reshape(2 * ROWS, COLS)))
    for r in range(2):
        np.testing.assert_array_equal(got[r]["y"], np.asarray(want_y))  # rank order
        np.testing.assert_array_equal(got[r]["z"], 2 * x.reshape(2 * ROWS, COLS))
        # this rank's slice of the gradient of the (global) loss
        np.testing.assert_array_equal(got[r]["grad"], w[r * ROWS:(r + 1) * ROWS])
    # the ranks' slices together are JAX's gradient of the sharded input
    np.testing.assert_allclose(np.concatenate([g["grad"] for g in got]), np.asarray(want_g),
                               rtol=0, atol=0)


@pytest.mark.parametrize("env,want", [
    ({}, (0, 1, 0, None)),
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1"}, (1, 4, 1, None)),
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.2",
      "MASTER_PORT": "29500"}, (3, 4, 1, "tcp://10.0.0.2:29500")),
    ({"OSSMT_COORDINATOR": "127.0.0.1:1234", "OSSMT_NUM_PROCESSES": "2",
      "OSSMT_PROCESS_ID": "1"}, (1, 2, 1, "tcp://127.0.0.1:1234")),
])
def test_launch_env_reads_torchrun_and_the_jax_launcher(env, want):
    assert tuple(distributed.launch_env(env)) == want


@pytest.mark.parametrize("device,env,want", [
    (None, {"LOCAL_RANK": "3"}, "cuda:3"),
    ("cuda", {"LOCAL_RANK": "1"}, "cuda:1"),
    ("cuda:0", {"LOCAL_RANK": "1"}, "cuda:0"),  # two ranks on one card, by request
    ("cpu", {"LOCAL_RANK": "1"}, "cpu"),
])
def test_process_device_is_the_local_rank_unless_named(device, env, want):
    assert distributed.process_device(device, env) == want


@pytest.mark.parametrize("device,want", [("cuda:0", "nccl"), ("cuda", "nccl"), ("cpu", "gloo")])
def test_backend_follows_the_device(device, want):
    assert distributed.backend_for(device) == want


def test_no_rendezvous_means_no_group():
    assert not distributed.maybe_init_distributed("cpu", env={"RANK": "1", "WORLD_SIZE": "2"})
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("dp_size,world,ok", [(-1, 1, True), (-1, 8, True), (4, 4, True),
                                              (2, 1, False), (1, 2, False), (8, 4, False)])
def test_dp_size_must_be_the_world_size(dp_size, world, ok):
    if ok:
        distributed.check_dp_size(dp_size, world)
    else:
        with pytest.raises(ValueError, match="one\\s+process per card"):
            distributed.check_dp_size(dp_size, world)


def test_train_cli_refuses_a_dp_size_the_launch_does_not_have(tmp_path, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "OSSMT_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="dp_size=2"):
        train_ir.main({"arch": "tiny", "device": "cpu", "dp_size": 2,
                       "output_dir": str(tmp_path)})


def test_group_timeout_is_explicit(monkeypatch):
    """The group is made with the timeout given, so a rank that never
    arrives fails the run instead of hanging it."""
    seen = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    env = {"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}
    assert distributed.maybe_init_distributed("cpu", timeout_s=7, env=env)
    assert seen["backend"] == "gloo" and seen["timeout"] == datetime.timedelta(seconds=7)
    assert seen["rank"] == 0 and seen["world_size"] == 2
    assert seen["init_method"] == "tcp://127.0.0.1:1"
