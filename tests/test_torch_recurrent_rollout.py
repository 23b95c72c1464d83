"""PyTorch port: the plain recurrent rollout vs the JAX Pallas recurrent
kernel in interpret mode (same states, hidden streams, weights, seed and
epsilon; both draw from the counter hash), plus the packing helpers. The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``. Discrete outputs
and statistics must be equal; floats within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.config import EnvConfig
from pingpong_tpu.env import pong as jpong
from pingpong_tpu.models.qnet_rnn import qnet_rnn_init as jinit
from pingpong_tpu.ops.recurrent_rollout import pack_qnet_rnn as jpack
from pingpong_tpu.ops.recurrent_rollout import pack_rnn_sigma as jsigma
from pingpong_tpu.ops.recurrent_rollout import pallas_recurrent_rollout
from pingpong_tpu_torch.checkpoint.serialize import qnet_rnn_from_numpy
from pingpong_tpu_torch.env import pong as tpong
from pingpong_tpu_torch.ops import recurrent_rollout as trr
from pingpong_tpu_torch.train.dqn import bucket_opp_idx

B, TILE, T = 64, 32, 20
DIMS = dict(feature_dim=32, lstm_hidden_dim=16, head_hidden_dim=16)
H = DIMS["lstm_hidden_dim"]
CFG = EnvConfig(
    paddle_speed=0.03, magnus_factor=0.025, restitution=1.0, friction=0.6,
    ball_speed_range=(0.03, 0.05), spin_range=(-5, 5),
    speed_scale_every=1, speed_increment=0.1,
)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def zero_sigma_j(p):
    z = lambda l: l._replace(w_sigma=jnp.zeros_like(l.w_sigma),
                             b_sigma=jnp.zeros_like(l.b_sigma))
    return p._replace(shared=z(p.shared), fc_a=z(p.fc_a))


def setup(n_slots, eval_mode, seed):
    learner = jinit(jax.random.PRNGKey(seed), **DIMS)
    if eval_mode:
        learner = zero_sigma_j(learner)
    members = [jinit(jax.random.PRNGKey(seed + 1 + i), **DIMS)
               for i in range(n_slots)]
    st = jax.vmap(jpong.reset, in_axes=(None, 0))(
        jpong.env_params_from_config(CFG),
        jax.random.split(jax.random.PRNGKey(seed + 50), B))
    rng = np.random.default_rng(seed)
    # scores one point from the end, so that episodes end within the chunk
    st = st._replace(score_a=jnp.asarray(rng.integers(0, 3, B), jnp.int32),
                     score_b=jnp.asarray(rng.integers(1, 3, B), jnp.int32))
    opp = np.sort(rng.integers(0, n_slots, B)).astype(np.int32)
    ret = rng.choice([-1.0, 0.0, 1.0], B).astype(np.float32)
    hid = rng.uniform(-0.5, 0.5, (4 * H, B)).astype(np.float32)
    return learner, members, st, opp, ret, hid


@pytest.mark.parametrize("n_slots,eps,eval_mode,mes", [
    (1, 0.3, False, 10),       # empty pool, truncation cap
    (3, 0.3, False, 4096),     # three bucketed slots, mixed-member tiles
    (1, 0.0, True, 0),         # gate eval: greedy, no transitions
])
def test_plain_rollout_matches_jax_interpret(n_slots, eps, eval_mode, mes):
    learner, members, st, opp, ret, hid = setup(n_slots, eval_mode,
                                                seed=5 * n_slots)
    stack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *members)
    want = pallas_recurrent_rollout(
        jpong.env_params_from_config(CFG), st, jnp.asarray(opp),
        jnp.asarray(ret), jnp.asarray(hid), jpack(learner), jsigma(learner),
        jpack(stack, mirror=True), seed=jnp.int32(7654321),
        epsilon=jnp.float32(eps), steps=T, max_episode_steps=mes,
        tile_rows=TILE, interpret=True, emit_transitions=not eval_mode)
    tst = tpong.EnvState(*(torch.from_numpy(np.array(getattr(st, f)))
                           for f in tpong.EnvState._fields))
    tl = qnet_rnn_from_numpy(np_tree(learner))
    got = trr.recurrent_rollout(
        tpong.env_params_from_config(CFG), tst, torch.from_numpy(opp),
        torch.from_numpy(ret), torch.from_numpy(hid), trr.pack_qnet_rnn(tl),
        trr.pack_rnn_sigma(tl),
        trr.pack_qnet_rnn([qnet_rnn_from_numpy(np_tree(m)) for m in members],
                          mirror=True),
        seed=7654321, epsilon=eps, steps=T, max_episode_steps=mes,
        tile_rows=TILE, emit_transitions=not eval_mode)
    (js, jopp, jret, jhid, jtr, jcounts, jrsum, jended) = want
    (ts, topp, tret, thid, ttr, tcounts, trsum, tended) = got
    if not eval_mode:
        for k in ("action", "reward", "done"):
            np.testing.assert_array_equal(ttr[k].numpy(), np.asarray(jtr[k]),
                                          err_msg=k)
        np.testing.assert_allclose(ttr["obs"].numpy(), np.asarray(jtr["obs"]),
                                   rtol=0, atol=1e-5)
        assert int(np.asarray(jtr["done"]).sum()) > 0   # resets exercised
        assert len(set(np.asarray(jtr["action"]).ravel().tolist())) == 3
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(float(trsum), float(jrsum), atol=1e-5)
    np.testing.assert_array_equal(tended.numpy(), np.asarray(jended))
    np.testing.assert_array_equal(topp.numpy(), np.asarray(jopp))
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=1e-5)
    np.testing.assert_allclose(thid.numpy(), np.asarray(jhid), rtol=0,
                               atol=1e-5)
    for f in tpong.EnvState._fields[:-1]:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("mirror", [False, True])
def test_pack_qnet_rnn_matches_jax(mirror):
    members = [jinit(jax.random.PRNGKey(i), **DIMS) for i in range(2)]
    stack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *members)
    want = jpack(stack, mirror=mirror)
    ports = [qnet_rnn_from_numpy(np_tree(m)) for m in members]
    got = trr.pack_qnet_rnn(ports, mirror=mirror)
    for name in trr.PackedQNetRNN._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-7, err_msg=name)
    for name, a in zip(trr.RNNSigma._fields, jsigma(members[0])):
        np.testing.assert_array_equal(
            getattr(trr.pack_rnn_sigma(ports[0]), name).numpy(),
            np.asarray(a), err_msg=name)
    # the kernel's flat layout: one vector per net, widths recovered, each
    # of its ten sections padded to 32 floats (128 bytes)
    flat = trr.rnn_kernel_flat(got)
    F1, F, Hd, HH = trr.packed_dims(got)
    assert (F1, F, Hd, HH) == (16, 32, 16, 16)
    pad = lambda n: -(-n // 32) * 32
    assert flat.shape == (2, sum(pad(n) for n in (
        F1 * 8, F1, F, 4 * Hd, HH, 3 * HH, 3, F1 * F, (F + Hd) * 4 * Hd,
        Hd * HH)))
    assert trr.supports_kernel((64, 128, 128, 128))
    assert not trr.supports_kernel((64, 256, 128, 128))
    # widths off a multiple of 4 run with zero units added
    assert trr.supports_kernel((64, 128, 126, 128))
    assert trr.kernel_dims((25, 50, 126, 30)) == (28, 52, 128, 32)


def unpack_kernel_flat(flat, dims, trim=True):
    """Inverse of ``rnn_kernel_flat`` for one net, from ``net_layout``: the
    fields at the kernel's widths or, with ``trim``, at ``dims``, after
    checking that the units the kernel adds are zero."""
    F1, F, H, HH = trr.kernel_dims(dims)
    layout, length = trr.net_layout(dims)
    assert flat.shape == (length,)
    sec = lambda name, *shape: flat[layout[name][0]:layout[name][0]
                                    + layout[name][1]].reshape(shape)
    wat = torch.zeros((8, HH))
    wat[:3] = sec("wa", 3, HH)
    bat = torch.full((8, 1), trr.NEG_BIG)
    bat[:3] = sec("ba", 3, 1)
    full = trr.PackedQNetRNN(
        w1t=sec("w1", F1, 8), b1t=sec("b1", F1, 1),
        w2t=sec("w2", F1, F).T, b2t=sec("b2", F, 1),
        wght=sec("wg", F + H, H, 4).permute(2, 1, 0).reshape(4 * H, F + H),
        bgt=sec("bg", H, 4).T.reshape(4 * H, 1),
        wst=sec("ws", H, HH).T, bst=sec("bs", HH, 1), wat=wat, bat=bat)
    if not trim:
        return full
    f1, f, h, hh = dims
    cols = torch.cat([torch.arange(f), F + torch.arange(h)])
    out = trr.PackedQNetRNN(
        w1t=full.w1t[:f1], b1t=full.b1t[:f1], w2t=full.w2t[:f, :f1],
        b2t=full.b2t[:f],
        wght=full.wght.view(4, H, F + H)[:, :h][:, :, cols].reshape(
            4 * h, f + h),
        bgt=full.bgt.view(4, H, 1)[:, :h].reshape(4 * h, 1),
        wst=full.wst[:hh, :h], bst=full.bst[:hh], wat=full.wat[:, :hh],
        bat=full.bat)
    for name, a, b in zip(trr.PackedQNetRNN._fields, full, out):
        assert torch.count_nonzero(a) == torch.count_nonzero(b), name
    return out


def unpack_sigma_flat(sflat, dims):
    """The learner's sigmas back from ``sigma_kernel_flat``, at the
    kernel's widths."""
    _, _, H, HH = trr.kernel_dims(dims)
    slay, slen = trr.sigma_layout(dims)
    assert sflat.shape == (slen,)
    sec = lambda name, *shape: sflat[slay[name][0]:slay[name][0]
                                     + slay[name][1]].reshape(shape)
    wat, bat = torch.zeros((8, HH)), torch.zeros((8, 1))
    wat[:3] = sec("wa", 3, HH)
    bat[:3] = sec("ba", 3, 1)
    return trr.RNNSigma(wst_sigma=sec("ws", H, HH).T,
                        bst_sigma=sec("bs", HH, 1), wat_sigma=wat,
                        bat_sigma=bat)


ODD_WIDTHS = dict(feature_dim=50, lstm_hidden_dim=50, head_hidden_dim=30)


@pytest.mark.parametrize("mirror,widths", [
    (False, DIMS), (True, DIMS),
    (True, dict(feature_dim=128, lstm_hidden_dim=128, head_hidden_dim=128)),
    (True, ODD_WIDTHS)])
def test_kernel_flat_layout_round_trip(mirror, widths):
    """Every field of a packed net (and of the learner's sigmas) comes
    back exactly from the kernel's flat vector; sections start on 128
    bytes; padding, and the units added to widths off a multiple of 4, are
    zero."""
    gen = torch.Generator().manual_seed(3)
    from pingpong_tpu_torch.models.qnet_rnn import qnet_rnn_init

    nets = [qnet_rnn_init(gen, **widths) for _ in range(3)]
    packed = trr.pack_qnet_rnn(nets, mirror=mirror)
    dims = trr.packed_dims(packed)
    flat = trr.rnn_kernel_flat(packed)
    layout, length = trr.net_layout(dims)
    assert flat.shape == (3, length) and length % 32 == 0
    assert all(off % 32 == 0 for off, _ in layout.values())
    used = torch.zeros(length, dtype=torch.bool)
    for off, size in layout.values():
        used[off:off + size] = True
    assert not flat[:, ~used].any()
    for m in range(3):
        back = unpack_kernel_flat(flat[m], dims)
        for name in trr.PackedQNetRNN._fields:
            assert torch.equal(getattr(back, name),
                               getattr(packed, name)[m]), name
    sig = trr.pack_rnn_sigma(nets[0])
    back = unpack_sigma_flat(trr.sigma_kernel_flat(sig), dims)
    _, _, Hd, HH = dims
    assert torch.equal(back.wst_sigma[:HH, :Hd], sig.wst_sigma)
    assert torch.equal(back.bst_sigma[:HH], sig.bst_sigma)
    assert torch.equal(back.wat_sigma[:, :HH], sig.wat_sigma)
    assert torch.equal(back.bat_sigma, sig.bat_sigma)
    assert torch.count_nonzero(back.wst_sigma) == torch.count_nonzero(
        sig.wst_sigma)


@pytest.mark.parametrize("widths", [
    ODD_WIDTHS, dict(feature_dim=36, lstm_hidden_dim=18, head_hidden_dim=22)])
def test_added_zero_units_leave_the_rollout_unchanged(widths):
    """The kernel runs widths off a multiple of 4 with zero units added
    (``kernel_dims``). The plain rollout of the padded nets, read back from
    the kernel's flat vectors, gives the unpadded nets' result: the same
    discrete outputs, floats within 1e-5, and the added units' LSTM
    streams stay zero."""
    from pingpong_tpu_torch.models.qnet_rnn import qnet_rnn_init

    gen = torch.Generator().manual_seed(7)
    learner, *members = (qnet_rnn_init(gen, **widths) for _ in range(3))
    lw, sig = trr.pack_qnet_rnn(learner), trr.pack_rnn_sigma(learner)
    opp = trr.pack_qnet_rnn(members, mirror=True)
    dims = trr.packed_dims(lw)
    Hd, Hp = dims[2], trr.kernel_dims(dims)[2]
    assert trr.kernel_dims(dims) != dims
    lw_p = unpack_kernel_flat(trr.rnn_kernel_flat(lw), dims, trim=False)
    sig_p = unpack_sigma_flat(trr.sigma_kernel_flat(sig), dims)
    opp_flat = trr.rnn_kernel_flat(opp)
    opp_p = trr.PackedQNetRNN(*(torch.stack(f) for f in zip(*(
        unpack_kernel_flat(opp_flat[m], dims, trim=False)
        for m in range(2)))))
    params = tpong.env_params_from_config(CFG)
    state = tpong.reset(params, B, gen, torch.device("cpu"))
    rng = np.random.default_rng(7)
    opp_idx = torch.from_numpy(np.sort(rng.integers(0, 2, B)).astype(
        np.int32))
    hid = torch.from_numpy(rng.uniform(-0.5, 0.5, (4, Hd, B)).astype(
        np.float32))
    hid_p = torch.zeros((4, Hp, B))
    hid_p[:, :Hd] = hid
    kw = dict(seed=99, eps_i=300000, steps=T, max_episode_steps=10,
              tile_rows=TILE, emit_transitions=True)
    ret = torch.zeros(B)
    s0, r0, h0, t0, st0 = trr.recurrent_rollout_plain(
        params, state, opp_idx, ret, hid.reshape(4 * Hd, B), lw, sig, opp,
        **kw)
    s1, r1, h1, t1, st1 = trr.recurrent_rollout_plain(
        params, state, opp_idx, ret, hid_p.reshape(4 * Hp, B), lw_p, sig_p,
        opp_p, **kw)
    for k in ("action", "reward", "done"):
        assert torch.equal(t0[k], t1[k]), k
    assert int(t0["done"].sum()) > 0
    torch.testing.assert_close(t1["obs"], t0["obs"], rtol=0, atol=1e-5)
    assert torch.equal(st0, st1)
    h1 = h1.view(4, Hp, B)
    assert not h1[:, Hd:].any()
    torch.testing.assert_close(h1[:, :Hd].reshape(4 * Hd, B), h0, rtol=0,
                               atol=1e-5)
    for f in tpong.EnvState._fields[:-1]:
        torch.testing.assert_close(getattr(s1, f), getattr(s0, f), rtol=0,
                                   atol=1e-5)


def rebind(n_envs, pool_size, seed):
    """Half the envs (seeded) on the buckets of ``pool_size`` members, the
    rest on those of one fewer: the binding a pool change leaves."""
    moved = torch.from_numpy(
        np.random.default_rng(seed).permutation(n_envs) < n_envs // 2)
    return torch.where(moved, bucket_opp_idx(n_envs, 0.4, pool_size),
                       bucket_opp_idx(n_envs, 0.4, pool_size - 1))


@pytest.mark.parametrize("envs", [8, 16, 32])
@pytest.mark.parametrize("binding,n_slots,blocks_at_8", [
    ("train_2slot", 2, 129), ("pool16", 17, 141), ("rebind", 17, 136)])
def test_block_table(binding, n_slots, blocks_at_8, envs):
    """The kernel's env lists at the shipped train chunk (1024 envs, tiles
    of 512): every env in exactly one lane; a block holds one tile and one
    member; the block count is the sum over segments of ceil(n / envs)."""
    B, tile = 1024, 512
    opp = {"train_2slot": bucket_opp_idx(B, 0.4, 1),
           "pool16": bucket_opp_idx(B, 0.4, 16),
           "rebind": rebind(B, 16, 0)}[binding].to(torch.int32)
    counts = trr.segment_counts(opp, tile, n_slots)
    assert int(counts.sum()) == B
    n_blocks = int(trr.member_blocks(counts, envs).sum())
    assert n_blocks == int(((counts + envs - 1) // envs).sum())
    if envs == 8:
        assert n_blocks == blocks_at_8
    assert n_blocks <= trr.blocks_bound(B, tile, n_slots, envs)
    table = trr.block_table(opp, tile, envs, counts, n_blocks)
    assert table.shape == (n_blocks, 1 + envs)
    lanes = table[:, 1:]
    valid = lanes >= 0
    assert torch.equal(lanes[valid].sort().values,
                       torch.arange(B, dtype=torch.int32))
    member = table[:, :1].expand_as(lanes)
    assert torch.equal(opp[lanes[valid].long()], member[valid])
    tiles = torch.where(valid, lanes // tile, -1)
    first = tiles[:, :1].expand_as(tiles)
    assert bool((tiles == first)[valid].all())
    # lanes fill from 0, and only a segment's last block has idle lanes
    assert bool((valid[:, 1:] <= valid[:, :-1]).all())
