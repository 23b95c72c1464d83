"""PyTorch port: the mesh (``parallel/mesh.py``) against the JAX package's,
and kernels 1 and 3 with ``tile0``.

* ``create_mesh`` covers the ranks as the JAX function covers the devices,
  and raises the same error when it does not; ``shard_batch`` gives a rank
  the block that the JAX ``shard_batch`` puts on the same device; without
  a process group ``initialize_distributed`` does nothing and the process
  is the coordinator; on gloo CPU processes the collectives act within the
  data axis, a model axis included;
* the plain versions of kernels 1 and 3 with ``tile0 != 0`` against the
  JAX kernels in interpret mode with the same ``tile0``, and a rank's block
  run with its ``tile0`` equal to the whole call's block (what makes a
  data-parallel rollout the single-device one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from pingpong_tpu.config.schema import MeshConfig as JMeshConfig
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.ops.actor_rollout import pack_qnet as jpack_q
from pingpong_tpu.ops.actor_rollout import pallas_actor_rollout
from pingpong_tpu.ops.recurrent_rollout import pack_qnet_rnn as jpack_r
from pingpong_tpu.ops.recurrent_rollout import pack_rnn_sigma as jsigma
from pingpong_tpu.ops.recurrent_rollout import pallas_recurrent_rollout
from pingpong_tpu.parallel import mesh as jmesh
from pingpong_tpu_torch.checkpoint.serialize import (
    qnet_from_numpy,
    qnet_rnn_from_numpy,
)
from pingpong_tpu_torch.config.schema import MeshConfig
from pingpong_tpu_torch.env import pong as tpong
from pingpong_tpu_torch.ops import actor_rollout as tar
from pingpong_tpu_torch.ops import recurrent_rollout as trr
from pingpong_tpu_torch.parallel import mesh as tmesh
from tests import test_torch_actor_rollout as ta
from tests import test_torch_recurrent_rollout as tr
from tests.torch_dist import run_ranks


@pytest.mark.parametrize("num_data,num_model,world", [
    (-1, 1, 8), (-1, 2, 8), (4, 2, 8), (2, 1, 2), (-1, 1, 1),
    (3, 1, 8), (4, 3, 8), (-1, 3, 8),
])
def test_create_mesh_covers_like_jax(num_data, num_model, world):
    jcfg = JMeshConfig(num_data=num_data, num_model=num_model)
    tcfg = MeshConfig(num_data=num_data, num_model=num_model)
    try:
        want = dict(jmesh.create_mesh(jcfg, jax.devices()[:world]).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.create_mesh(tcfg, world=world)
        assert str(got.value) == str(e)
        return
    got = tmesh.create_mesh(tcfg, world=world)
    assert got.shape == want
    assert got.n_data == want["data"] and got.rank == 0


@pytest.mark.parametrize("n", [2, 4])
def test_shard_batch_is_the_jax_devices_block(n):
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(n, 1), ("data", "model"))
    x = np.arange(8 * 3 * 2, dtype=np.float32).reshape(24, 2)
    y = np.arange(24, dtype=np.int32)
    placed = jmesh.shard_batch({"x": x, "y": y}, mesh)
    for r in range(n):
        m = tmesh.Mesh(shape={"data": n, "model": 1}, rank=r)
        got = tmesh.shard_batch({"x": torch.from_numpy(x),
                                 "y": torch.from_numpy(y)}, m)
        for k in ("x", "y"):
            shard = next(s for s in placed[k].addressable_shards
                         if s.device == mesh.devices[r, 0])
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(shard.data))
        assert tmesh.data_sharding(m, 24) == slice(r * 24 // n,
                                                   (r + 1) * 24 // n)
    with pytest.raises(ValueError):
        tmesh.data_sharding(tmesh.Mesh(shape={"data": 5, "model": 1}), 24)


def test_single_process_is_the_coordinator_and_needs_no_group():
    tmesh.initialize_distributed()          # no torchrun environment
    assert not torch.distributed.is_initialized()
    assert tmesh.is_coordinator()
    assert tmesh.mesh_for_world(MeshConfig()) is None
    assert tmesh.broadcast_values([0.25, 1.0], None, "cpu") == [0.25, 1.0]


@pytest.mark.parametrize("n,num_model", [(2, 1), (4, 2)])
def test_collectives_over_the_data_axis(n, num_model, tmp_path):
    """On gloo CPU processes: ``replicate`` and ``broadcast_values`` give
    data rank 0's values, ``all_gather_cat`` concatenates in rank order,
    ``all_reduce_`` sums and takes the maximum, all within the data axis
    (the ranks that share a model index, ``num_model > 1``)."""
    res = run_ranks("collectives", n, tmp_path, dict(num_model=num_model))
    nd = n // num_model
    for rank, r in enumerate(res):
        m, d = rank % num_model, rank // num_model
        peers = [k * num_model + m for k in range(nd)]       # global ranks
        assert r["shape"] == {"data": nd, "model": num_model}
        assert r["data_rank"] == d
        x = lambda g: torch.arange(3, dtype=torch.float32) + 10 * g
        assert torch.equal(r["replicated"]["a"], x(peers[0]))
        assert torch.equal(r["replicated"]["b"][0],
                           torch.full((2,), float(peers[0])))
        assert r["values"] == [peers[0] + 0.5, 7.0]
        assert torch.equal(r["gathered"], torch.cat([x(g)[None]
                                                     for g in peers], 1))
        assert torch.equal(r["summed"], sum(x(g) for g in peers))
        assert torch.equal(r["maxed"], torch.stack(
            [x(g) * (-1) ** g for g in peers]).max(0).values)
        assert torch.equal(r["block"], torch.arange(12).view(nd, -1)[d])


# ---------------------------------------------------------------------------
# kernels 1 and 3 with tile0
# ---------------------------------------------------------------------------

def tstate(st, sl=slice(None)):
    return tpong.EnvState(*(torch.from_numpy(np.array(getattr(st, f))[sl])
                            for f in tpong.EnvState._fields))


def jstate(st, sl):
    return st._replace(**{f: getattr(st, f)[sl] for f in st._fields})


def assert_outputs(got, want, floats_atol=1e-5):
    """Rollout outputs equal: discrete exactly, floats within ``atol``
    (0: bit for bit)."""
    for g, w in zip(got, want):
        if isinstance(g, dict):
            for k in g:
                assert_outputs([g[k]], [w[k]], floats_atol)
        elif isinstance(g, tuple):
            assert_outputs(list(g), list(w), floats_atol)
        else:
            g, w = g.numpy(), np.asarray(w)
            if g.dtype.kind in "iub" or floats_atol == 0:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=floats_atol)


@pytest.mark.parametrize("n_slots,tile0", [(1, 1), (3, 5)])
def test_actor_rollout_tile0_matches_jax(n_slots, tile0):
    """Kernel 1's plain version on a block of 2 tiles as the tiles
    ``tile0, tile0 + 1`` of a batch, against the JAX kernel with the same
    ``tile0`` in interpret mode."""
    learner, members, st, opp, ret = ta.setup(n_slots, False, False,
                                              seed=4 + n_slots)
    sl = slice(0, 2 * ta.TILE)
    stack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *members)
    want = pallas_actor_rollout(
        jpong.env_params_from_config(ta.CFG), jstate(st, sl),
        jnp.asarray(opp[sl]), jnp.asarray(ret[sl]), jpack_q(learner),
        jpack_q(stack, mirror=True), seed=jnp.int32(424242),
        epsilon=jnp.float32(0.3), pool_size=jnp.int32(n_slots - 1),
        steps=ta.T, pool_ratio=0.33, max_episode_steps=4096,
        tile_rows=ta.TILE, tile0=tile0, interpret=True)
    got = tar.actor_rollout(
        tpong.env_params_from_config(ta.CFG), tstate(st, sl),
        torch.from_numpy(opp[sl]), torch.from_numpy(ret[sl]),
        tar.pack_qnet(qnet_from_numpy(ta.np_tree(learner))),
        tar.pack_qnet([qnet_from_numpy(ta.np_tree(m)) for m in members],
                      mirror=True),
        seed=424242, epsilon=0.3, steps=ta.T, max_episode_steps=4096,
        tile_rows=ta.TILE, tile0=tile0)
    assert_outputs(got[1:], want[1:])
    assert_outputs(list(got[0])[:-1], list(want[0])[:-1])
    # the global tile keys the draws: tile0 0 draws otherwise
    other = tar.actor_rollout(
        tpong.env_params_from_config(ta.CFG), tstate(st, sl),
        torch.from_numpy(opp[sl]), torch.from_numpy(ret[sl]),
        tar.pack_qnet(qnet_from_numpy(ta.np_tree(learner))),
        tar.pack_qnet([qnet_from_numpy(ta.np_tree(m)) for m in members],
                      mirror=True),
        seed=424242, epsilon=0.3, steps=ta.T, max_episode_steps=4096,
        tile_rows=ta.TILE)
    assert not torch.equal(other[3]["action"], got[3]["action"])


@pytest.mark.parametrize("tile0", [1, 3])
def test_recurrent_rollout_tile0_matches_jax(tile0):
    learner, members, st, opp, ret, hid = tr.setup(3, False, seed=21)
    sl = slice(0, tr.TILE)
    stack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *members)
    want = pallas_recurrent_rollout(
        jpong.env_params_from_config(tr.CFG), jstate(st, sl),
        jnp.asarray(opp[sl]), jnp.asarray(ret[sl]), jnp.asarray(hid[:, sl]),
        jpack_r(learner), jsigma(learner), jpack_r(stack, mirror=True),
        seed=jnp.int32(97531), epsilon=jnp.float32(0.3), steps=tr.T,
        max_episode_steps=4096, tile_rows=tr.TILE, tile0=tile0,
        interpret=True)
    tl = qnet_rnn_from_numpy(tr.np_tree(learner))
    got = trr.recurrent_rollout(
        tpong.env_params_from_config(tr.CFG), tstate(st, sl),
        torch.from_numpy(opp[sl]), torch.from_numpy(ret[sl]),
        torch.from_numpy(hid[:, sl].copy()), trr.pack_qnet_rnn(tl),
        trr.pack_rnn_sigma(tl),
        trr.pack_qnet_rnn([qnet_rnn_from_numpy(tr.np_tree(m))
                           for m in members], mirror=True),
        seed=97531, epsilon=0.3, steps=tr.T, max_episode_steps=4096,
        tile_rows=tr.TILE, tile0=tile0)
    assert_outputs(got[1:], want[1:])
    assert_outputs(list(got[0])[:-1], list(want[0])[:-1])


def block(x, r, n, dim=0):
    per = x.shape[dim] // n
    return x.narrow(dim, r * per, per)


@pytest.mark.parametrize("n", [2, 4])
def test_rank_blocks_equal_the_whole_call(n):
    """Each rank's block of kernel 1's and kernel 3's plain versions, run
    alone with ``tile0 = rank * local tiles``, equals the same block of the
    whole batch's call, bit for bit (the stats summed over the ranks)."""
    learner, members, st, opp, ret = ta.setup(3, True, False, seed=9)
    env = tpong.env_params_from_config(ta.CFG)
    lw = tar.pack_qnet(qnet_from_numpy(ta.np_tree(learner)))
    ow = tar.pack_qnet([qnet_from_numpy(ta.np_tree(m)) for m in members],
                       mirror=True)
    tile = ta.B // n // 2 if n == 2 else ta.B // n
    tile = min(tile, ta.TILE)
    kw = dict(seed=31337, epsilon=0.3, steps=ta.T, max_episode_steps=64,
              tile_rows=tile, member_shared_trunk=True)
    whole = tar.actor_rollout(env, tstate(st), torch.from_numpy(opp),
                              torch.from_numpy(ret), lw, ow, **kw)
    counts = torch.zeros_like(whole[4])
    for r in range(n):
        s = tstate(st)
        part = tar.actor_rollout(
            env, tpong.EnvState(*(block(x, r, n) for x in s)),
            block(torch.from_numpy(opp), r, n),
            block(torch.from_numpy(ret), r, n), lw, ow,
            tile0=r * (ta.B // n // tile), **kw)
        want = [tpong.EnvState(*(block(x, r, n) for x in whole[0])),
                block(whole[1], r, n), block(whole[2], r, n),
                {k: block(v, r, n, 1) for k, v in whole[3].items()}]
        assert_outputs(list(part[0]) + list(part[1:4]),
                       list(want[0]) + want[1:], floats_atol=0)
        np.testing.assert_array_equal(part[6].numpy(),
                                      block(whole[6], r, n).numpy())
        counts += part[4]
    assert torch.equal(counts, whole[4])

    learner, members, st, opp, ret, hid = tr.setup(3, False, seed=13)
    env = tpong.env_params_from_config(tr.CFG)
    tl = qnet_rnn_from_numpy(tr.np_tree(learner))
    args = (trr.pack_qnet_rnn(tl), trr.pack_rnn_sigma(tl), trr.pack_qnet_rnn(
        [qnet_rnn_from_numpy(tr.np_tree(m)) for m in members], mirror=True))
    tile = min(tr.TILE, tr.B // n)
    kw = dict(seed=2468, epsilon=0.3, steps=tr.T, max_episode_steps=64,
              tile_rows=tile)
    hid_t = torch.from_numpy(hid)
    whole = trr.recurrent_rollout(env, tstate(st), torch.from_numpy(opp),
                                  torch.from_numpy(ret), hid_t, *args, **kw)
    for r in range(n):
        s = tstate(st)
        part = trr.recurrent_rollout(
            env, tpong.EnvState(*(block(x, r, n) for x in s)),
            block(torch.from_numpy(opp), r, n),
            block(torch.from_numpy(ret), r, n),
            block(hid_t, r, n, 1).contiguous(), *args,
            tile0=r * (tr.B // n // tile), **kw)
        want = [tpong.EnvState(*(block(x, r, n) for x in whole[0])),
                block(whole[2], r, n), block(whole[3], r, n, 1),
                {k: block(v, r, n, 1) for k, v in whole[4].items()}]
        assert_outputs(list(part[0]) + [part[2], part[3], part[4]],
                       list(want[0]) + want[1:], floats_atol=0)
