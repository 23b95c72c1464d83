"""PyTorch port: the plain fused DRQN update block vs the JAX Pallas update
kernel in interpret mode, over the four cases of the JAX kernel's own
parity test (``test_kernel_matches_autodiff``: no sync, hard syncs
mid-block, Polyak, a later step count), with the JAX suite's tolerances
(rtol 2e-5, atol 2e-6); and the plain hand backward vs ``torch.autograd``
of the same loss. Inputs are made with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pingpong_tpu.models.noisy import NoisyNoise as JNoisyNoise
from pingpong_tpu.models.qnet_rnn import QNetRNNNoise as JNoise
from pingpong_tpu.models.qnet_rnn import qnet_rnn_init as jinit
from pingpong_tpu.ops.drqn_update import (
    pack_upd_noise as jpack_noise,
    pack_upd_params as jpack,
    pallas_drqn_update_block,
    unpack_upd_params as junpack,
)
from pingpong_tpu_torch.checkpoint.serialize import qnet_rnn_from_numpy
from pingpong_tpu_torch.models.noisy import NoisyNoise
from pingpong_tpu_torch.models.qnet_rnn import QNetRNNNoise, qnet_rnn_to_flat
from pingpong_tpu_torch.ops import drqn_update as tdu

K, BS, T = 3, 8, 4
WIDTHS = dict(feature_dim=32, lstm_hidden_dim=16, head_hidden_dim=16)
DIMS = (16, 32, 16, 16)
HP = dict(lr=1e-3, clip=1.0, gamma=0.99)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = np_tree(jinit(jax.random.PRNGKey(seed), **WIDTHS))
    target = np_tree(jinit(jax.random.PRNGKey(seed + 1), **WIDTHS))

    def f(shape):
        x = rng.normal(size=shape).astype(np.float32)
        return np.sign(x) * np.sqrt(np.abs(x))

    noise = {}
    for name, n_in, n_out in (("shared", 16, 16), ("v", 16, 1), ("a", 16, 3)):
        e_in, e_out = f((K, n_in)), f((K, n_out))
        noise[name] = (e_in[:, :, None] * e_out[:, None, :], e_out)
    return dict(
        params=params, target=target, noise=noise,
        obs=rng.uniform(-1, 1, (K, BS, T, 7)).astype(np.float32),
        nxt=rng.uniform(-1, 1, (K, BS, T, 7)).astype(np.float32),
        act=rng.integers(0, 3, (K, BS)).astype(np.int32),
        rew=rng.normal(size=(K, BS)).astype(np.float32),
        done=rng.random((K, BS)) < 0.2, valid=rng.random((K, BS)) < 0.9)


def port_noise(inp):
    n = {k: (torch.from_numpy(w), torch.from_numpy(b))
         for k, (w, b) in inp["noise"].items()}
    return QNetRNNNoise(shared=NoisyNoise(*n["shared"]), v=NoisyNoise(*n["v"]),
                        a=NoisyNoise(*n["a"]))


def run_jax(inp, interval, tau, ts0):
    p = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    t = jax.tree_util.tree_map(jnp.asarray, inp["target"])
    n = {k: JNoisyNoise(jnp.asarray(w), jnp.asarray(b))
         for k, (w, b) in inp["noise"].items()}
    po, pt = jpack(p), jpack(t)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, po)
    o2, t2, m2, v2, losses, ts2 = pallas_drqn_update_block(
        jnp.int32(ts0), jnp.int32(ts0), jnp.asarray(inp["obs"]),
        jnp.asarray(inp["nxt"]), jnp.asarray(inp["act"]),
        jnp.asarray(inp["rew"]), jnp.asarray(inp["done"]),
        jnp.asarray(inp["valid"]),
        jpack_noise(JNoise(shared=n["shared"], v=n["v"], a=n["a"])),
        po, pt, zeros, zeros, K=K, bs=BS, T=T, interval=interval, tau=tau,
        interpret=True, **HP)
    flat = lambda u: np.asarray(ravel_pytree(junpack(u, p))[0])
    return dict(params=flat(o2), target=flat(t2), m=flat(m2), v=flat(v2),
                losses=np.asarray(losses), ts=int(ts2))


def run_port(inp, interval, tau, ts0):
    P = qnet_rnn_to_flat(qnet_rnn_from_numpy(inp["params"])).clone()
    Tg = qnet_rnn_to_flat(qnet_rnn_from_numpy(inp["target"])).clone()
    m, v = torch.zeros_like(P), torch.zeros_like(P)
    t = lambda k: torch.from_numpy(inp[k])
    losses = tdu.drqn_update_block(
        train_steps=ts0, adam_count=ts0, obs=t("obs"), next_obs=t("nxt"),
        action=t("act"), reward=t("rew"), done=t("done"), valid=t("valid"),
        noise=tdu.flat_noise(port_noise(inp)), params=P, target=Tg, m=m, v=v,
        dims=DIMS, interval=interval, tau=tau, **HP)
    return dict(params=P.numpy(), target=Tg.numpy(), m=m.numpy(),
                v=v.numpy(), losses=losses.numpy())


@pytest.mark.parametrize("interval,tau,ts0", [
    (10_000, 0.0, 0),     # no sync in the block
    (2, 0.0, 0),          # hard syncs mid-block
    (10_000, 0.05, 0),    # Polyak
    (10_000, 0.0, 123),   # bias correction at a later step count
])
def test_plain_update_matches_jax_interpret(interval, tau, ts0):
    inp = make_inputs()
    want = run_jax(inp, interval, tau, ts0)
    got = run_port(inp, interval, tau, ts0)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)
    for key in ("params", "target"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5, atol=2e-6,
                                   err_msg=key)
    # Adam's first steps normalise each gradient entry: moments compare
    # relative to their own scale
    np.testing.assert_allclose(got["m"], want["m"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got["v"], want["v"], rtol=1e-4, atol=1e-10)
    assert want["ts"] == ts0 + K
    init = qnet_rnn_to_flat(qnet_rnn_from_numpy(inp["params"])).numpy()
    assert np.abs(got["params"] - init).max() > 1e-4    # the block stepped


def test_hand_backward_matches_autograd():
    inp = make_inputs(3)
    ps, ns = tdu.param_slices(DIMS), tdu.noise_slices(DIMS)
    flat = qnet_rnn_to_flat(qnet_rnn_from_numpy(inp["params"])).double()
    target = qnet_rnn_to_flat(qnet_rnn_from_numpy(inp["target"])).double()
    noise = tdu.flat_noise(port_noise(inp)).double()
    t = lambda k: torch.from_numpy(inp[k])
    xt, nextt, meta = tdu.kernel_inputs(
        t("obs").double(), t("nxt").double(), t("act"), t("rew").double(),
        t("done"), t("valid"))
    x = xt[0].reshape(7, T, 2 * BS)[:, :, BS:].reshape(7, T * BS)
    qt = tdu._target_q(tdu._views(target, ps), x, T, BS)
    nz = tdu._views(noise[0], ns)

    def effective(P):
        return {"sw": P["ws"] + P["wss"] * nz["sw"],
                "sb": P["bs"] + P["bss"] * nz["sb"],
                "vw": P["wv"] + P["wvs"] * nz["vw"],
                "vb": P["bv"] + P["bvs"] * nz["vb"],
                "aw": P["wa"] + P["was"] * nz["aw"],
                "ab": P["ba"] + P["bas"] * nz["ab"]}

    P = tdu._views(flat, ps)
    loss, g = tdu.drqn_grad(P, effective(P), nz, xt[0], meta[0].double(), qt,
                            T, BS, HP["gamma"])
    want_flat = torch.cat([g[k].reshape(-1) for k in ps if k != "n"])

    leaf = flat.clone().requires_grad_(True)
    PA = tdu._views(leaf, ps)
    loss_a, _ = tdu.drqn_grad(PA, effective(PA), nz, xt[0], meta[0].double(),
                              qt, T, BS, HP["gamma"])
    loss_a.backward()
    torch.testing.assert_close(loss, loss_a.detach())
    torch.testing.assert_close(want_flat, leaf.grad, rtol=1e-9, atol=1e-12)
    assert float(want_flat.abs().max()) > 0


def test_layouts_match_jax():
    inp = make_inputs(5)
    jp = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    tp = qnet_rnn_from_numpy(inp["params"])
    got, want = tdu.pack_upd_params(tp), jpack(jp)
    for name in tdu.UpdParams._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    back = tdu.unpack_upd_params(got, tp)
    np.testing.assert_array_equal(qnet_rnn_to_flat(back).numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))
    assert tdu.param_slices(DIMS)["n"][0] == ravel_pytree(jp)[0].size
    n = {k: JNoisyNoise(jnp.asarray(w), jnp.asarray(b))
         for k, (w, b) in inp["noise"].items()}
    jn = jpack_noise(JNoise(shared=n["shared"], v=n["v"], a=n["a"]))
    tn = tdu.pack_upd_noise(port_noise(inp))
    for name in tdu.UpdNoise._fields:
        np.testing.assert_array_equal(getattr(tn, name).numpy(),
                                      np.asarray(getattr(jn, name)),
                                      err_msg=name)
    rows = tdu.flat_noise(port_noise(inp))
    assert rows.shape == (K, tdu.noise_slices(DIMS)["n"][0])
