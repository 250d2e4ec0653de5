"""Sequence-parallel fusion (``parallel/sequence.py``): the reweight
aggregation with fine time sharded over 2 ranks (spawned over gloo on the
CPU) against ``ops.reweight.reweight_aggregate`` on the whole sequence and
against the JAX package's ``sequence_sharded_reweight`` on its mesh, with
``rtol=1e-5, atol=1e-6`` (partial sums added in another order); with each
rank's loss its share of the global loss, the gradient of each rank's feat
and gate shard equals that shard of the one-process gradient likewise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coarse_fine_networks_tpu.parallel import make_mesh
from coarse_fine_networks_tpu.parallel.sequence import \
    sequence_sharded_reweight as jseq
from coarse_fine_networks_tpu.parallel.sequence import \
    shard_time as jshard_time
from coarse_fine_networks_torch.ops import reweight_aggregate
from coarse_fine_networks_torch.parallel import (mesh,
                                                 sequence_sharded_reweight,
                                                 shard_time)

import _torch_port_dp as dp

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def inputs():
    return dp.reweight_inputs()


@pytest.fixture(scope="module")
def one_process(inputs):
    x = {k: torch.from_numpy(v) for k, v in inputs.items()}
    feat = x["feat"].clone().requires_grad_(True)
    gate = x["gate"].clone().requires_grad_(True)
    out = reweight_aggregate(feat, gate, x["align"], x["mask"])
    (out * x["w"]).sum().backward()
    return {"out": out.detach(), "dfeat": feat.grad, "dgate": gate.grad}


def test_outside_a_group_is_reweight_aggregate(inputs, one_process):
    x = {k: torch.from_numpy(v) for k, v in inputs.items()}
    got = sequence_sharded_reweight(x["feat"], x["gate"], x["align"],
                                    x["mask"])
    torch.testing.assert_close(got, one_process["out"], **TOL)


def test_two_ranks_equal_whole_sequence_and_jax(inputs, one_process):
    ranks = mesh.spawn(dp.sequence_reweight, 2, inputs, device="cpu")
    jm = make_mesh(2)
    j = {k: jshard_time(jnp.asarray(v), jm) for k, v in inputs.items()
         if k != "w"}
    jout = np.asarray(jseq(j["feat"], j["gate"], j["align"], j["mask"], jm))
    for r, got in enumerate(ranks):
        torch.testing.assert_close(got["out"], one_process["out"], **TOL)
        np.testing.assert_allclose(got["out"].numpy(), jout, **TOL)
        for k in ("dfeat", "dgate"):
            want = shard_time(one_process[k], r, 2)
            torch.testing.assert_close(got[k], want, **TOL, msg=k)


def test_shard_time_matches_jax(inputs):
    jm = make_mesh(2)
    j = jshard_time(jnp.asarray(inputs["feat"]), jm)
    for r in range(2):
        shard = next(s for s in j.addressable_shards
                     if s.device == jm.devices[r])
        np.testing.assert_array_equal(
            shard_time(torch.from_numpy(inputs["feat"]), r, 2).numpy(),
            np.asarray(shard.data))
