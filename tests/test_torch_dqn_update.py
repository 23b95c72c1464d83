"""PyTorch port: the plain fused update block vs the JAX Pallas update
kernel in interpret mode, over the four cases of the JAX kernel's own
parity test (no sync, hard syncs mid-block with an offset clock, Polyak,
full backward). Inputs are made with numpy; sampled indices must match
exactly, parameters to rtol 2e-5, moments to rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pingpong_tpu.checkpoint.serialize import qnet_from_dict
from pingpong_tpu.models.noisy import NoisyNoise as JNoisyNoise
from pingpong_tpu.models.qnet import QNetNoise as JQNetNoise
from pingpong_tpu.ops.dqn_update import (
    pack_dqn_noise as jpack_noise,
    pack_dqn_params as jpack,
    pallas_dqn_update_block,
    unpack_dqn_params as junpack,
)
from pingpong_tpu.replay import per as jper
from pingpong_tpu_torch.checkpoint.serialize import qnet_to_numpy
from pingpong_tpu_torch.models.qnet import qnet_init
from pingpong_tpu_torch.ops import dqn_update as tdu

CAP, BS, K = 16384, 128, 3
HP = dict(lr=2.5e-4, gamma=0.99, alpha=0.6, per_eps=1e-6, beta_start=0.4,
          beta_frames=1000)
FRAME0 = 7


def make_inputs(seed=0, n_filled=512, bs=BS):
    rng = np.random.default_rng(seed)
    m = n_filled
    batch = jper.Transition(
        obs=jnp.asarray(rng.uniform(-1, 1, (m, 7)), jnp.float32),
        action=jnp.asarray(rng.integers(0, 3, m), jnp.int32),
        reward=jnp.asarray(rng.normal(size=m), jnp.float32),
        next_obs=jnp.asarray(rng.uniform(-1, 1, (m, 7)), jnp.float32),
        done=jnp.asarray(rng.random(m) < 0.2))
    buf = jper.per_push(jper.per_init(CAP, block=True), batch, HP["alpha"])
    prios = np.zeros(CAP, np.float32)
    prios[:m] = rng.uniform(0.1, 2.0, m)
    pa = np.where(prios > 0, prios ** np.float32(HP["alpha"]), 0).astype(
        np.float32)
    params = [qnet_to_numpy(qnet_init(torch.Generator().manual_seed(seed + i)))
              for i in (1, 2)]

    def fnoise(shape):
        x = rng.normal(size=shape).astype(np.float32)
        return np.sign(x) * np.sqrt(np.abs(x))

    ein_v, eout_v = fnoise((K, 64)), fnoise((K, 1))
    ein_a, eout_a = fnoise((K, 64)), fnoise((K, 3))
    noise = dict(v_w=ein_v[:, :, None] * eout_v[:, None, :], v_b=eout_v,
                 a_w=ein_a[:, :, None] * eout_a[:, None, :], a_b=eout_a)
    u01 = rng.random((K, bs)).astype(np.float32)
    return dict(data=np.asarray(buf.data), pa=pa, size=m, params=params,
                noise=noise, u01=u01, bs=bs)


def run_jax(inp, interval, tau, heads_only, ts0):
    p, t = (qnet_from_dict(d) for d in inp["params"])
    n = inp["noise"]
    noise = JQNetNoise(v=JNoisyNoise(jnp.asarray(n["v_w"]), jnp.asarray(n["v_b"])),
                       a=JNoisyNoise(jnp.asarray(n["a_w"]), jnp.asarray(n["a_b"])))
    po, pt = jpack(p), jpack(t)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, po)
    nc = CAP // 128
    pa = jnp.asarray(inp["pa"])
    out = pallas_dqn_update_block(
        jnp.int32(ts0), jnp.int32(0), jnp.int32(FRAME0),
        jnp.int32(inp["size"]), jnp.asarray(inp["u01"])[:, :, None],
        jpack_noise(noise), pa.reshape(nc, 128),
        pa.reshape(-1, 128).sum(axis=1).reshape(nc // 128, 128),
        po, pt, zeros, zeros, jnp.asarray(inp["data"]),
        K=K, bs=inp["bs"], interval=interval, tau=tau, heads_only=heads_only,
        interpret=True, **HP)
    (pa2, cs2, o2, t2, m2, v2, newp, idx, losses, ts2) = out
    flat = lambda u: np.asarray(ravel_pytree(junpack(u, p))[0])
    return dict(params=flat(o2), target=flat(t2), m=flat(m2), v=flat(v2),
                pa=np.asarray(pa2).reshape(-1),
                cs=np.asarray(cs2).reshape(-1), newp=np.asarray(newp),
                idx=np.asarray(idx), losses=np.asarray(losses),
                ts=int(ts2))


def run_port(inp, interval, tau, heads_only, ts0):
    from pingpong_tpu_torch.checkpoint.serialize import qnet_from_numpy
    from pingpong_tpu_torch.models.qnet import qnet_to_flat

    P, Tg = (qnet_to_flat(qnet_from_numpy(d)).clone() for d in inp["params"])
    n = inp["noise"]
    noise = torch.from_numpy(np.concatenate(
        [n["v_w"].reshape(K, -1), n["v_b"], n["a_w"].reshape(K, -1),
         n["a_b"]], axis=1))
    pa = torch.from_numpy(inp["pa"].copy())
    cs = pa.view(-1, 128).sum(dim=1)
    m, v = torch.zeros_like(P), torch.zeros_like(P)
    newp, idx, losses = tdu.dqn_update_block(
        train_steps=ts0, adam_count=0, frame_idx=FRAME0, size=inp["size"],
        u01=torch.from_numpy(inp["u01"]), noise=noise, p_alpha=pa,
        chunk_sums=cs, params=P, target=Tg, m=m, v=v,
        data=torch.from_numpy(inp["data"].copy()), K=K, bs=inp["bs"],
        interval=interval, tau=tau, heads_only=heads_only, **HP)
    return dict(params=P.numpy(), target=Tg.numpy(), m=m.numpy(),
                v=v.numpy(), pa=pa.numpy(), cs=cs.numpy(),
                newp=newp.numpy(), idx=idx.numpy(), losses=losses.numpy())


@pytest.mark.parametrize("interval,tau,heads_only,ts0", [
    (10_000, 0.0, True, 0),      # no sync in block, frozen features
    (2, 0.0, True, 1),           # hard syncs mid-block, offset clock
    (10_000, 0.05, True, 0),     # Polyak
    (10_000, 0.0, False, 0),     # full backward through the trunk
])
def test_plain_update_matches_jax_interpret(interval, tau, heads_only, ts0):
    inp = make_inputs()
    check_against_jax(inp, interval, tau, heads_only, ts0)
    # heads-only leaves the trunk bit-identical
    if heads_only:
        np.testing.assert_array_equal(
            run_port(inp, interval, tau, True, ts0)["params"]
            [:tdu.FEATURES_END],
            run_port(make_inputs(), interval, tau, True, ts0)["params"]
            [:tdu.FEATURES_END])


def test_plain_update_matches_jax_interpret_batch_512():
    """The largest batch both kernels take, hard syncs mid-block."""
    check_against_jax(make_inputs(seed=3, n_filled=1024, bs=512), 2, 0.0,
                      True, 1)


def check_against_jax(inp, interval, tau, heads_only, ts0):
    want = run_jax(inp, interval, tau, heads_only, ts0)
    got = run_port(inp, interval, tau, heads_only, ts0)
    np.testing.assert_array_equal(got["idx"], want["idx"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)
    for key, rtol, atol in (("params", 2e-5, 2e-6), ("target", 2e-5, 2e-6),
                            ("m", 1e-4, 1e-7), ("v", 1e-4, 1e-9),
                            ("pa", 1e-4, 1e-7), ("cs", 1e-4, 1e-6),
                            ("newp", 5e-5, 1e-9)):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=key)
    assert want["ts"] == ts0 + K


def test_supports_gate_and_layout():
    from pingpong_tpu.ops.dqn_update import supports_pallas_dqn_update
    from pingpong_tpu_torch.config import DQNConfig, load_config

    assert tdu.N_PARAMS == 5192 and tdu.N_NOISE == 260
    cfg = load_config("configs/qnet.yaml").dqn
    assert tdu.supports_fused_update(cfg)
    base = dict(batch_size=256, memory_size=1 << 20, num_envs=4096,
                rollout_length=64)
    for bs in (384, 512):   # the JAX kernel's largest batches
        c = DQNConfig(**{**base, "batch_size": bs})
        assert tdu.supports_fused_update(c) and supports_pallas_dqn_update(c)
    for kw in (dict(batch_size=100), dict(memory_size=1_000_000),
               dict(rollout_length=96), dict(batch_size=640)):
        c = DQNConfig(**{**base, **kw})
        assert not tdu.supports_fused_update(c)
        assert not supports_pallas_dqn_update(c)

