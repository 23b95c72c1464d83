"""PyTorch port: block-layout PER push and sample vs the JAX package, on
the same transitions (made with numpy) and the same uniforms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pingpong_tpu.replay import per as jper
from pingpong_tpu_torch.replay import per as tper

ALPHA = 0.6


def batch(rng, m):
    return dict(
        obs=rng.uniform(-1, 1, (m, 7)).astype(np.float32),
        action=rng.integers(0, 3, m).astype(np.int32),
        reward=rng.normal(size=m).astype(np.float32),
        next_obs=rng.uniform(-1, 1, (m, 7)).astype(np.float32),
        done=rng.random(m) < 0.2,
    )


def j_tr(b):
    return jper.Transition(**{k: jnp.asarray(v) for k, v in b.items()})


def t_tr(b):
    return tper.Transition(**{k: torch.from_numpy(v.copy())
                              for k, v in b.items()})


@pytest.mark.parametrize("m,pushes", [(2048, 3), (384, 5)])
def test_push_and_sample_match_jax(m, pushes):
    cap = 4096
    rng = np.random.default_rng(m)
    jb = jper.per_init(cap, block=True)
    tb = tper.per_init(cap, block=True)
    for i in range(pushes):
        b = batch(rng, m)
        jb = jper.per_push(jb, j_tr(b), ALPHA)
        tper.per_push(tb, t_tr(b), ALPHA)
        if i == 1:  # heterogeneous priorities before the next push's stamp
            pr = rng.uniform(0.1, 2.0, cap).astype(np.float32)
            pr[int(jb.size):] = 0.0
            pa = np.where(pr > 0, pr ** np.float32(ALPHA), 0).astype(
                np.float32)
            jb = jb._replace(prios=jnp.asarray(pr), p_alpha=jnp.asarray(pa),
                             chunk_sums=jnp.asarray(pa).reshape(-1, 128)
                             .sum(1))
            tb.prios.copy_(torch.from_numpy(pr))
            tb.p_alpha.copy_(torch.from_numpy(pa))
            tb.chunk_sums.copy_(torch.from_numpy(pa).view(-1, 128).sum(1))
    assert tb.pos == int(jb.pos) and tb.size == int(jb.size)
    np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
    np.testing.assert_array_equal(tb.prios.numpy(), np.asarray(jb.prios))
    np.testing.assert_allclose(tb.p_alpha.numpy(), np.asarray(jb.p_alpha),
                               rtol=1e-6)
    np.testing.assert_allclose(tb.chunk_sums.numpy(),
                               np.asarray(jb.chunk_sums), rtol=1e-6)
    for k in range(3):
        u = rng.random(256).astype(np.float32)
        beta = tper.beta_schedule(100 * k + 7, 0.4, 1000)
        jbeta = jper.beta_schedule(jnp.int32(100 * k + 7), 0.4, 1000)
        assert float(beta) == float(jbeta)
        js = jper.per_sample(jb, None, 256, jbeta, u01=jnp.asarray(u))
        ts = tper.per_sample(tb, 256, beta, torch.from_numpy(u))
        np.testing.assert_array_equal(ts.indices.numpy(),
                                      np.asarray(js.indices))
        np.testing.assert_allclose(ts.weights.numpy(), np.asarray(js.weights),
                                   rtol=0, atol=1e-6)
        for f in ("obs", "action", "reward", "next_obs", "done"):
            np.testing.assert_array_equal(getattr(ts.batch, f).numpy(),
                                          np.asarray(getattr(js.batch, f)))


def test_last_writer_wins_keeps_latest_value():
    idx = torch.tensor([5, 3, 5, 9, 3, 5])
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    slots, v = tper.last_writer_wins(idx, vals)
    got = dict(zip(slots.tolist(), v.tolist()))
    assert got == {3: 5.0, 5: 6.0, 9: 4.0}


def mask_last_writer_wins(idx, vals):
    """The dedup that sized its result on the host: the distinct slots and
    each one's last value, selected by a mask."""
    srt = torch.sort(idx, stable=True).indices
    si, sv = idx[srt], vals[srt]
    last = torch.ones_like(si, dtype=torch.bool)
    last[:-1] = si[:-1] != si[1:]
    return si[last], sv[last]


@pytest.mark.parametrize("n,slots", [(65536, 4096), (4096, 3), (1000, 1 << 20),
                                     (1, 8)])
def test_fixed_size_last_writer_wins_equals_the_mask_version(n, slots):
    """Scattered into the priorities, every slot gets the value the mask
    version leaves it, bit for bit, with many duplicates or few; so does
    the priority write-back of the autodiff and sharded routes."""
    gen = torch.Generator().manual_seed(n)
    idx = torch.randint(0, slots, (n,), generator=gen)
    vals = torch.rand((n,), generator=gen)
    cap = max(slots, 128)
    got, want = torch.zeros(cap), torch.zeros(cap)
    s, v = tper.last_writer_wins(idx, vals)
    assert s.shape == v.shape == (n,)
    got[s] = v
    ws, wv = mask_last_writer_wins(idx, vals)
    want[ws] = wv
    assert torch.equal(got, want)

    buf = tper.per_init(cap)
    buf.prios.copy_(torch.rand((cap,), generator=gen))
    buf.p_alpha.copy_(buf.prios ** 0.6)
    buf.chunk_sums.copy_(buf.p_alpha.view(-1, buf.chunk).sum(dim=1))
    ref = tper.PERBuffer(*(x.clone() for x in (buf.data, buf.prios,
                                              buf.p_alpha, buf.chunk_sums)))
    tper.per_update_priorities(buf, idx, vals, 0.6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tper, "last_writer_wins", mask_last_writer_wins)
        tper.per_update_priorities(ref, idx, vals, 0.6)
    for a, b in zip((buf.prios, buf.p_alpha, buf.chunk_sums),
                    (ref.prios, ref.p_alpha, ref.chunk_sums)):
        assert torch.equal(a, b)
