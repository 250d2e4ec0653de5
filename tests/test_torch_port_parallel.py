"""The port's data-parallel plumbing (``parallel/mesh.py``) against the JAX
package's ``parallel.mesh``: the rank's rows of a global batch
(``shard_batch``, with ``leading_accum``), ``process_shard``, the rows
gathered to rank 0, the sum over the ranks with its backward, and the
split-membership rule of split batch norm (global row ``i`` belongs to
split ``i % s``: a rank's rows keep that only when its local batch divides
by ``s``, else training raises).

The ranks are 2 processes spawned by ``mesh.spawn`` over gloo on the CPU
(``tcp://localhost`` on a free port), as the JAX package's multi-process
test runs its ranks.  Every comparison is exact: rows are copies."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from coarse_fine_networks_tpu.parallel import make_mesh
from coarse_fine_networks_tpu.parallel import shard_batch as jshard_batch
from coarse_fine_networks_tpu.train.multigrid import LongCycleSchedule
from coarse_fine_networks_torch.parallel import mesh

import _torch_port_dp

torch.set_num_threads(2)

N = 8


@pytest.fixture(scope="module")
def ranks():
    return mesh.spawn(_torch_port_dp.rank_checks, 2, N, device="cpu")


def _jax_rows(arr, rank, world, axis=0):
    """Rank ``rank``'s rows of a JAX array sharded over the 8-device mesh:
    the shards of devices ``8/world·rank ...``, in device order (the JAX
    package's multi-process layout, ``host_local_rows``)."""
    per = len(jax.devices()) // world
    devs = jax.devices()[rank * per:(rank + 1) * per]
    shards = sorted((s for s in arr.addressable_shards if s.device in devs),
                    key=lambda s: s.index[axis].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=axis)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_shard_batch_rows_match_jax(world):
    """Rank r's rows (axis 0, and axis 1 with ``leading_accum``) are the
    rows the JAX mesh places on rank r's devices."""
    jm = make_mesh()
    a = np.arange(2 * 16 * 3, dtype=np.float32).reshape(2, 16, 3)
    ja = jshard_batch({"x": a[0]}, jm)["x"]
    jacc = jshard_batch({"x": a}, jm, leading_accum=True)["x"]
    for r in range(world):
        got = mesh.shard_batch({"x": torch.from_numpy(a[0])}, rank_=r,
                               world_=world)["x"].numpy()
        np.testing.assert_array_equal(got, _jax_rows(ja, r, world))
        got = mesh.shard_batch(torch.from_numpy(a), leading_accum=True,
                               rank_=r, world_=world).numpy()
        np.testing.assert_array_equal(got, _jax_rows(jacc, r, world, 1))
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch(torch.zeros(6), rank_=0, world_=4)


def test_outside_a_group_is_one_process():
    assert mesh.world() == 1 and mesh.rank() == 0
    assert mesh.process_shard() == (0, 1)
    x = torch.arange(4)
    assert mesh.shard_batch(x) is not None
    assert torch.equal(mesh.shard_batch(x), x)
    assert mesh.gather_rows(x) is x
    t = torch.ones(3)
    assert mesh.all_reduce_sum(t) is t


def test_spawned_ranks_rows_and_gather(ranks):
    """Each rank holds its contiguous rows (nested dicts too) and rank 0
    gathers the global batch in rank order; the others get None."""
    for r, out in enumerate(ranks):
        assert out["shard"] == (r, 2)
        assert out["backend"] == "gloo"
        rows = torch.arange(r * N // 2, (r + 1) * N // 2)
        assert torch.equal(out["rows"]["a"], rows)
        assert torch.equal(out["rows"]["b"]["c"], rows * 10)
        assert torch.equal(out["accum"],
                           torch.arange(2 * N).reshape(2, N)[:, rows])
    assert torch.equal(ranks[0]["gathered"]["a"], torch.arange(N))
    assert torch.equal(ranks[0]["gathered"]["b"]["c"], torch.arange(N) * 10)
    assert ranks[1]["gathered"] is None


def test_all_reduce_sum_and_its_backward(ranks):
    """``all_reduce_sum`` of ``rank + 1`` is 3 on both ranks; with each
    rank's loss ``(rank + 1)·total``, the gradient of rank r's input is the
    global loss's, Σ (rank + 1) = 3."""
    for out in ranks:
        assert out["total"] == 3.0
        assert out["grad"] == 3.0


def test_split_rule_raises_where_the_local_batch_does_not_divide(ranks):
    for out in ranks:
        assert out["raised"] is not None
        assert "(B/N) % num_splits" in out["raised"]


@pytest.mark.parametrize("world", [2, 4, 8])
def test_long_cycle_splits_hold_per_rank(world):
    """The long cycle's phases at the fine driver's base batch 8 (A: B64 /
    8 splits, B: B32 / 4, C: B16 / 2, D: B8 / 1) keep the split rule on
    2, 4 and 8 ranks."""
    sched = LongCycleSchedule(320, 224, 8)
    for epoch, phase in enumerate(sched.phases):
        b = sched.shapes(epoch)[2]
        assert (b // world) % phase.bn_split_scale == 0, (epoch, b, world)


def test_torchrun_environment_joins_its_group():
    """Two processes started as ``torchrun`` starts them (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` set) join that group
    through ``run_data_parallel`` (``mesh_devices = 2``, gloo on the CPU)
    instead of spawning ranks of their own."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = mesh.free_port()
    code = ("import json, sys; sys.path[:0] = [%r, %r]; "
            "import _torch_port_dp as d; print(json.dumps(d.torchrun_rank()))"
            % (os.path.dirname(here), here))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
        env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
        for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert got == [[r, 2, "gloo", 3.0] for r in range(2)]
