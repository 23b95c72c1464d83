"""Rainbow's agent on the port (``models/rainbow.py``, ``train/rainbow.py``,
``ops/c51_loss.py``'s plain version, ``selfplay/loop_rainbow.py``) against
the plain reference ``tests/rainbow_reference.py`` on seeded random weights
at a small size: streams of 32, 11 atoms, 8 envs, chunks of 4, 3-step
returns. Every tolerance is stated with its reason; each lies far below
what TF32 products (a 10-bit mantissa: relative errors near 1e-3) or an
update on half the batch (twice the gradient of each row) would give."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pingpong_tpu_torch.checkpoint.serialize import (
    params_from_dict,
    rainbow_to_dict,
)
from pingpong_tpu_torch.checkpoint.store import load_checkpoint
from pingpong_tpu_torch.config import apply_overrides, load_config
from pingpong_tpu_torch.models.rainbow import (
    RainbowNoise,
    rainbow_from_config,
    rainbow_logits,
    rainbow_q,
    rainbow_sample_noise,
    rainbow_to_flat,
)
from pingpong_tpu_torch.ops.c51_loss import _dz, c51_loss, c51_loss_plain
from pingpong_tpu_torch.replay.per import NStepRows
from pingpong_tpu_torch.selfplay.pool import load_pool
from pingpong_tpu_torch.train import rainbow as tr
from pingpong_tpu_torch.train.optim import ADAM_EPS, adam_
from tests import rainbow_reference as R

ROOT = Path(__file__).resolve().parent.parent
A, S, N, T, NSTEP = 11, 32, 8, 4, 3
SMALL = [f"dqn.num_atoms={A}", f"dqn.stream_hidden={S}",
         f"dqn.num_envs={N}", f"dqn.rollout_length={T}",
         f"dqn.n_step={NSTEP}", "dqn.batch_size=16",
         "dqn.memory_size=1024", "dqn.updates_per_iteration=3",
         "env.max_episode_steps=64"]


def small_cfg(*extra):
    return apply_overrides(load_config(ROOT / "configs/rainbow.yaml"),
                           SMALL + list(extra))


def ref_noise(noise: RainbowNoise):
    return {name: (f.ein, f.eout) for name, f in zip(R.NOISY, noise)}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward_matches_the_reference(mode):
    """Logits and Q of the net against the reference's on seeded weights
    (sigmas raised so that the noise moves the logits by order one). The
    same float32 products in the same order: agreement to 1e-6 of the
    logits' scale (TF32 would part near 1e-3)."""
    cfg = small_cfg().dqn
    gen = torch.Generator().manual_seed(11)
    net = rainbow_from_config(gen, dataclasses.replace(cfg,
                                                        noisy_sigma0=2.0))
    obs = torch.randn((64, 7), generator=gen)
    noise = rainbow_sample_noise(gen, net) if mode == "train" else None
    p = R.unflatten(rainbow_to_flat(net), A, S)
    ref = R.logits(p, obs, ref_noise(noise) if noise else None)
    got = rainbow_logits(net, obs, noise)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    z = R.support(A, cfg.v_min, cfg.v_max)
    torch.testing.assert_close(rainbow_q(net, obs, noise),
                               R.q_values(ref, z), rtol=0, atol=1e-6)
    if noise is not None:
        assert (got - rainbow_logits(net, obs)).abs().max() > 1e-2


def test_init_and_noise_follow_the_paper():
    """sigma = sigma0 / sqrt(fan_in), mu within 1 / sqrt(fan_in); the
    noise factors are f(x) = sign(x) sqrt|x| of standard normals, drawn
    layer by layer, in then out (the reference's draws exactly)."""
    cfg = small_cfg().dqn
    net = rainbow_from_config(torch.Generator().manual_seed(0), cfg)
    for name in R.NOISY:
        layer = getattr(net, name)
        fan_in = layer.w_mu.shape[0]
        assert torch.all(layer.w_sigma == cfg.noisy_sigma0 / fan_in ** 0.5)
        assert layer.w_mu.abs().max() <= 1 / fan_in ** 0.5
    got = rainbow_sample_noise(torch.Generator().manual_seed(5), net)
    ref = R.noise(torch.Generator().manual_seed(5), A, S)
    for name, f in zip(R.NOISY, got):
        assert torch.equal(f.ein, ref[name][0])
        assert torch.equal(f.eout, ref[name][1])


def chunk(gen, steps, done_at=()):
    """Random transitions ``(steps, N)`` with episode ends at ``(t, env)``
    pairs (and a few at random)."""
    done = torch.rand((steps, N), generator=gen) < 0.1
    for t, e in done_at:
        done[t, e] = True
    return dict(obs=torch.randn((steps, N, 7), generator=gen),
                action=torch.randint(0, 3, (steps, N), generator=gen,
                                     dtype=torch.int32),
                reward=torch.randn((steps, N), generator=gen),
                next_obs=torch.randn((steps, N, 7), generator=gen),
                done=done)


def test_nstep_fold_across_chunks_and_episode_ends():
    """Two chunks folded through the carry against a plain per-env loop
    over the whole stream: rows bit-equal (the returns sum in the same
    float32 order), the first chunk's first n-1 rows held back, the rest
    one row a step in time-major order. Ends land on a chunk boundary,
    inside a window and on its first step."""
    gen = torch.Generator().manual_seed(3)
    c1 = chunk(gen, T, done_at=[(3, 0), (2, 1)])
    c2 = chunk(gen, T, done_at=[(0, 2), (1, 3)])
    learner = tr.RainbowLearner(small_cfg().env, small_cfg().dqn, "cpu")
    carry = learner._empty_carry()
    rows1, carry = tr.nstep_fold(carry, c1, NSTEP, 0.99)
    rows2, carry = tr.nstep_fold(carry, c2, NSTEP, 0.99)
    skip = (NSTEP - 1) * N
    got = NStepRows(*(torch.cat([a[skip:], b]) for a, b in zip(rows1,
                                                                 rows2)))
    stream = {k: torch.cat([c1[k], c2[k]]) for k in c1}
    L = 2 * T
    i = 0
    for t in range(L - (NSTEP - 1)):
        for e in range(N):
            g, k, disc = R.nstep_env(stream["reward"][:, e].tolist(),
                                     stream["done"][:, e].tolist(), None, t,
                                     NSTEP, 0.99)
            assert got.ret[i].item() == g
            assert got.disc[i].item() == disc
            assert torch.equal(got.next_obs[i], stream["next_obs"][k, e])
            assert torch.equal(got.obs[i], stream["obs"][t, e])
            assert got.action[i].item() == stream["action"][t, e].item()
            i += 1
    assert i == got.ret.shape[0]
    assert torch.equal(carry.obs, c2["obs"][-(NSTEP - 1):])


def c51_case(bs=64, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((bs, A), generator=g) * 2
    p = torch.softmax(torch.randn((bs, A), generator=g) * 2, dim=-1)
    ret = (torch.rand((bs,), generator=g) * 2 - 1) * 15.0   # past both ends
    disc = torch.where(torch.rand((bs,), generator=g) < 0.3, 0.0,
                       float(np.float32(0.99 ** 3)))        # done rows: 0
    exact = torch.arange(bs) % 4 == 0                       # on an atom
    atom = torch.randint(0, A, (bs,), generator=g).float()
    ret = torch.where(exact, -10.0 + atom * _dz(A, -10.0, 10.0), ret)
    disc = torch.where(exact, 0.0, disc)
    w = torch.rand((bs,), generator=g) * 0.9 + 0.1
    return x, p, ret, disc, w, exact, atom


def test_c51_plain_matches_the_projection_and_autograd():
    """Kernel 6's plain version against the reference's floor/ceiling
    projection and autograd: atoms landing exactly on support points keep
    their whole mass there, returns past both ends clamp, done rows
    project the return alone. The two projections sum in another order
    (1e-6 of a loss near log A; the gradient's scale is w / bs)."""
    x, p, ret, disc, w, exact, atom = c51_case()
    loss, grad = c51_loss(x, p, ret, disc, w, -10.0, 10.0)
    m = R.project(p, ret, disc, A, -10.0, 10.0)
    ref_rows, ref_grad = R.c51_loss_and_grad(x, m, w)
    torch.testing.assert_close(loss, ref_rows, rtol=0, atol=2e-6)
    torch.testing.assert_close(grad, ref_grad, rtol=0, atol=1e-8)
    # an exact landing: all the mass on one atom, the loss -log p there
    i = int(torch.nonzero(exact)[0])
    torch.testing.assert_close(
        loss[i], -torch.log_softmax(x[i], -1)[int(atom[i])],
        rtol=0, atol=1e-6)
    # clamped at both ends: the mass of a far return sits on an end atom
    top = torch.full((1,), 40.0)
    low = torch.full((1,), -40.0)
    for r, end in ((top, A - 1), (low, 0)):
        mm = R.project(p[:1], r, torch.ones(1), A, -10.0, 10.0)
        assert mm[0, end].item() == pytest.approx(1.0, abs=1e-6)
        li, _ = c51_loss_plain(x[:1], p[:1], r, torch.ones(1), w[:1],
                               -10.0, 10.0)
        assert li.item() == pytest.approx(
            -torch.log_softmax(x[0], -1)[end].item(), abs=1e-5)
    # half the batch doubles each row's gradient: far outside 1e-8
    _, half = c51_loss_plain(x[:32], p[:32], ret[:32], disc[:32], w[:32],
                             -10.0, 10.0)
    assert (half - ref_grad[:32]).abs().max() > 1e-5


def filled_learner(*extra, seed=2**33 + 5):
    cfg = small_cfg(*extra)
    learner = tr.RainbowLearner(cfg.env, cfg.dqn, "cpu")
    state = learner.init_state(seed)
    opp = learner.prepare_opponents([learner.params_b(state)])
    for _ in range(3):
        state, _ = learner.train_iteration(state, opp, 0)
    return learner, state, opp


def test_one_update_matches_the_reference():
    """One update of the learner (sampled slots and weights taken from
    it) against the reference's: loss, gradient (the Adam first moment of
    a fresh optimizer is 0.1 of it), Adam with eps 1.5e-4, the priorities
    written and the hard target sync (interval 1). float32 in another
    order of the projection's sums and Adam's bias correction in double:
    1e-6 relative (TF32 or half the batch: 1e-3 and more)."""
    learner, state, _ = filled_learner("dqn.target_update_interval=1")
    cfg = learner.cfg
    state.opt_count = 0
    state.opt_mu.zero_()
    state.opt_nu.zero_()
    state.target = state.params + 1e-3 * torch.randn(
        state.params.shape, generator=torch.Generator().manual_seed(1))
    pre = dict(params=state.params.clone(), target=state.target.clone())
    gen = torch.Generator().manual_seed(4)
    u01, noise = learner._block_draws(gen)
    u01, noise = u01[:1], noise[:1]
    out = {}
    original = tr.rainbow_update_block

    def spy(*a, **kw):
        from pingpong_tpu_torch.replay import per as per_mod
        keep = per_mod.per_sample

        def sample(*sa, **skw):
            out["smp"] = keep(*sa, **skw)
            return out["smp"]
        tr.per_sample = sample
        try:
            return original(*a, **kw)
        finally:
            tr.per_sample = keep

    losses, idx = spy(learner, state, u01=u01, noise=noise, bs=cfg.batch_size)
    smp = out["smp"]
    b = smp.batch
    half = noise.shape[1] // 2
    from pingpong_tpu_torch.models.rainbow import noise_at, unpack_noise
    on = noise_at(unpack_noise(noise[:, :half], learner.template), 0)
    tg = noise_at(unpack_noise(noise[:, half:], learner.template), 0)
    loss, rows, g = R.update(pre["params"], pre["target"], dict(
        obs=b.obs, next_obs=b.next_obs, action=b.action.long(), ret=b.ret,
        disc=b.disc), smp.weights, ref_noise(on), ref_noise(tg), A, S,
        cfg.v_min, cfg.v_max)
    assert losses[0].item() == pytest.approx(loss.item(), rel=1e-6)
    torch.testing.assert_close(state.opt_mu, 0.1 * g, rtol=1e-5,
                               atol=1e-6 * g.abs().max().item())
    p1, _, _ = R.adam_step(pre["params"], g, torch.zeros_like(g),
                           torch.zeros_like(g), 1, cfg.lr, cfg.adam_eps)
    # the step is near lr (6.25e-5) a weight; the weights round once more
    # after it: two float32 ulps of a weight near 0.25, 1e-3 of the step
    step = state.params - pre["params"]
    torch.testing.assert_close(step, p1 - pre["params"], rtol=0, atol=6e-8)
    other = R.adam_step(pre["params"], g, torch.zeros_like(g),
                        torch.zeros_like(g), 1, cfg.lr, ADAM_EPS)[0]
    assert (step - (other - pre["params"])).abs().max() > 1e-6
    new = R.priorities(rows, cfg.per_alpha, cfg.per_eps)
    last = {int(s): k for k, s in enumerate(idx[0].tolist())}
    for slot, k in last.items():
        assert state.buffer.p_alpha[slot].item() == pytest.approx(
            new[k].item(), rel=1e-6)
    assert torch.equal(state.target, state.params)       # synced


def test_adam_default_eps_is_the_qnet_and_drqn_adam():
    """The QNet's and the DRQN's autodiff Adam passes no eps: the default
    is optax's 1e-8, the same bits as before the argument existed."""
    from benchmark.reference.frozen import optim as frozen

    g = torch.Generator().manual_seed(0)
    x, grad, m, v = (torch.randn((300,), generator=g) for _ in range(4))
    v = v.abs()
    outs = []
    for fn, kw in ((adam_, {}), (frozen.adam_, {}), (adam_, {"eps": 1e-8})):
        xs, ms, vs = x.clone(), m.clone(), v.clone()
        fn(xs, grad, ms, vs, 3, 1e-3, **kw)
        outs.append(torch.cat([xs, ms, vs]))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_learner_refuses_a_mesh():
    cfg = small_cfg()
    with pytest.raises(ValueError, match="one device"):
        tr.RainbowLearner(cfg.env, cfg.dqn, "cpu", mesh=object())


def test_state_round_trips_through_the_full_state_checkpoint(tmp_path):
    """The train state, the n-step carry included, saved and restored
    bit for bit."""
    from pingpong_tpu_torch.checkpoint.full_state import (
        autosave_full_state,
        restore_full_state,
    )

    learner, state, _ = filled_learner()
    assert state.carry_valid
    flat_a = learner.params_b(state)
    path = autosave_full_state(tmp_path / "latest", state,
                               rainbow_to_flat(flat_a),
                               torch.Generator(), {"generation": 1})
    got, _, _, _, _ = restore_full_state(
        path, learner.init_global_state(0), rainbow_to_flat(flat_a),
        torch.Generator(), None, device="cpu")
    assert got.carry_valid
    for a, b in zip(got.carry, state.carry):
        assert torch.equal(a, b)
    assert torch.equal(got.buffer.data, state.buffer.data)
    assert torch.equal(got.params, state.params)


def cli(workdir, *overrides):
    return subprocess.run(
        [sys.executable, "-m", "pingpong_tpu_torch.cli", "train", "--device",
         "cpu", "--config", "configs/rainbow.yaml", "--workdir",
         str(workdir), *SMALL, "dqn.selfplay.episodes_per_generation=6",
         "dqn.selfplay.eval_episodes=8", *overrides],
        cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_cli_train_promotes_faults_and_resumes(tmp_path):
    """``cli train --config configs/rainbow.yaml`` through a promotion
    (thresholds 0), then a fault (thresholds above 1, one try), then a
    rerun that restores the autosave; the checkpoints load back as
    Rainbow nets, bit for bit, and into the pool."""
    run = cli(tmp_path, "dqn.selfplay.max_generations=1",
              "dqn.selfplay.curr_win_threshold=0.0",
              "dqn.selfplay.pool_win_threshold=0.0",
              "dqn.save_latest_checkpoint_interval_steps=6")
    assert run.returncode == 0, run.stderr
    assert "done: 1/1 generations promoted" in run.stdout
    assert "[route:rainbow]" in run.stderr
    run = cli(tmp_path, "dqn.selfplay.max_generations=2",
              "dqn.selfplay.curr_win_threshold=2.0",
              "dqn.selfplay.max_retries_for_generation=1",
              "dqn.save_latest_checkpoint_interval_steps=6")
    assert run.returncode == 0, run.stderr
    events = [json.loads(line) for line in
              (tmp_path / "train_rainbow_metrics.jsonl").read_text()
              .splitlines()]
    kinds = [e["event"] for e in events]
    assert "promoted" in kinds and "fault" in kinds
    assert any(e["event"] == "restore" and e["tier"] == 0 for e in events)
    ck = tmp_path / "checkpoints"
    payload = load_checkpoint(ck / "rainbow5-1")
    assert payload["model_kind"] == "rainbow"
    net = params_from_dict(payload["params_b"])
    again = params_from_dict(rainbow_to_dict(net))
    assert torch.equal(rainbow_to_flat(net), rainbow_to_flat(again))
    assert net.n_atoms == A and net.v_min == -10.0
    assert (ck / "rainbow5-2_fault").exists()
    assert len(load_pool(ck, kind="rainbow")) == 2
    assert load_pool(ck, kind="qnet") == []


def test_traced_iteration_records_its_spans_and_the_same_bits():
    """``learner::nstep`` once a call, ``learner::c51`` once an update
    (counter ``learner::c51_rows`` = updates x batch), inside the learner's
    spans; a traced call computes the same bits as an untraced one."""
    from pingpong_tpu_torch.utils import trace

    states = []
    for on in (False, True):
        learner, state, opp = filled_learner()
        trace.drain()
        if on:
            trace.enable()
        try:
            state, m = learner.train_iteration(state, opp, 0)
        finally:
            trace.disable()
        states.append(state)
        drained = trace.summarize(trace.drain())
    spans, counters = drained["spans"], drained["counters"]
    assert spans["learner::nstep"]["count"] == 1
    assert spans["learner::c51"]["count"] == m.updates_run == 3
    assert counters["learner::c51_rows"] == 3 * 16
    a, b = states
    for x, y in ((a.params, b.params), (a.buffer.data, b.buffer.data),
                 (a.buffer.prios, b.buffer.prios), (a.carry.obs, b.carry.obs)):
        assert torch.equal(x, y)


def test_reset_learner_writes_into_the_state_tensors():
    """A fault's reset gives fresh weights, target, optimizer and an empty
    replay in the state's own storage (the card's graphs read it), equal
    to a fresh state's."""
    learner, state, _ = filled_learner()
    ptrs = [t.data_ptr() for t in (state.params, state.target, state.opt_mu,
                                   state.buffer.data, state.buffer.prios)]
    init = rainbow_from_config(torch.Generator().manual_seed(3),
                               learner.cfg)
    state = learner.reset_learner(state, init)
    fresh = learner.init_state(0, init)
    assert ptrs == [t.data_ptr() for t in (
        state.params, state.target, state.opt_mu, state.buffer.data,
        state.buffer.prios)]
    for a, b in ((state.params, fresh.params), (state.target, fresh.target),
                 (state.opt_mu, fresh.opt_mu), (state.opt_nu, fresh.opt_nu),
                 (state.buffer.data, fresh.buffer.data),
                 (state.buffer.prios, fresh.buffer.prios),
                 (state.buffer.p_alpha, fresh.buffer.p_alpha),
                 (state.buffer.chunk_sums, fresh.buffer.chunk_sums)):
        assert torch.equal(a, b)
    assert (state.buffer.size, state.buffer.pos, state.opt_count,
            state.train_steps, state.frame_idx) == (0, 0, 0, 0, 0)
    assert state.epsilon == fresh.epsilon and state.carry_valid
