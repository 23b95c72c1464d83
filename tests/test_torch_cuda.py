"""PyTorch port on the card: each CUDA kernel vs its plain PyTorch version
on the same inputs, the wrappers' argument checks, the QNet gate's own
operands vs module packs, and one iteration of each learner through its
two kernels. Every test needs an NVIDIA card and skips
without one. This file imports no JAX, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.) Tolerances are
those of ``chip_smoke.py``: the kernels contract float products into FMAs
where the CPU rounds twice, which can flip a rare compare."""

import dataclasses

import numpy as np
import pytest
import torch

from pingpong_tpu_torch.config import EnvConfig, load_config
from pingpong_tpu_torch.env.pong import EnvState, env_params_from_config, reset
from pingpong_tpu_torch.evaluation.fast_eval import (
    fused_win_rate,
    fused_win_rate_balanced,
)
from pingpong_tpu_torch.models.qnet import (
    qnet_copy,
    qnet_fold_noise,
    qnet_init,
    qnet_sample_noise,
    qnet_to_flat,
)
from pingpong_tpu_torch.models.qnet_rnn import (
    qnet_rnn_init,
    qnet_rnn_sample_noise,
    qnet_rnn_to_flat,
)
from pingpong_tpu_torch.ops import actor_rollout as tar
from pingpong_tpu_torch.ops import dqn_update as tdu
from pingpong_tpu_torch.ops import drqn_update as tdru
from pingpong_tpu_torch.ops import pong_kernel as tpk
from pingpong_tpu_torch.ops import recurrent_rollout as trr
from pingpong_tpu_torch.replay.per import Transition, per_init, per_push
from pingpong_tpu_torch.train.dqn import DQNLearner, bucket_opp_idx
from pingpong_tpu_torch.train.drqn import DRQNLearner
from pingpong_tpu_torch.utils import trace
from tests.test_torch_gate_packs import _zero_sigma

CONFIG = "configs/qnet.yaml"
B, TILE, T = 512, 128, 16
CAP, BS, K = 16384, 128, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (python -m pytest --noconftest "
                    "-m cuda tests/test_torch_cuda.py there)")
    return torch.device("cuda")


def opp_binding(n_slots, n_envs, seed, bucketed):
    """Each env's slot: sorted random draws, or the learners' contiguous
    buckets (the first 60 % on slot 0, the rest split over the others),
    which put several members in one block or group at the seams."""
    if bucketed:
        return bucket_opp_idx(n_envs, 0.4, n_slots - 1).numpy()
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, n_slots, n_envs)).astype(np.int32)


def actor_args(n_slots, shared, eval_mode, dev, seed=3, n_envs=B,
               tile_rows=TILE, bucketed=False):
    cfg = load_config(CONFIG)
    gen = torch.Generator().manual_seed(seed)
    learner = qnet_init(gen)
    if eval_mode:
        learner.fc_a.w_sigma.data.zero_()
        learner.fc_a.b_sigma.data.zero_()
    members = [qnet_init(gen) for _ in range(n_slots)]
    if shared:
        for p in members[1:]:
            p.feat1.load_state_dict(members[0].feat1.state_dict())
            p.feat2.load_state_dict(members[0].feat2.state_dict())
    opp = opp_binding(n_slots, n_envs, seed, bucketed)
    env_params = env_params_from_config(cfg.env)
    args = (env_params, reset(env_params, n_envs, gen, dev),
            torch.from_numpy(opp).to(dev), torch.zeros(n_envs, device=dev),
            tar.pack_qnet(learner.to(dev)),
            tar.pack_qnet([m.to(dev) for m in members], mirror=True))
    kw = dict(seed=1234567, eps_i=0 if eval_mode else 300000, steps=T,
              max_episode_steps=0 if eval_mode else 40, tile_rows=tile_rows,
              emit_transitions=not eval_mode, shared_trunk=shared)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots,shared,eval_mode", [
    (1, False, False), (3, True, False), (3, False, False), (1, False, True)])
def test_actor_kernel_matches_plain(cuda, n_slots, shared, eval_mode):
    check_actor_kernel(cuda, *actor_args(n_slots, shared, eval_mode, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b384_tile128", "b384_tile48",
                                  "17slot_shared_mixed"])
def test_actor_kernel_matches_plain_at_other_shapes(cuda, case):
    """384 envs in tiles of 128 or of 48, the least multiple of a block's
    16 envs above 32 (24 blocks); 17 heads-only slots bound in buckets, so
    blocks hold several members."""
    if case.startswith("b384_tile"):
        args, kw = actor_args(3, False, False, cuda, n_envs=384,
                              tile_rows=int(case[len("b384_tile"):]))
    else:
        args, kw = actor_args(17, True, False, cuda, bucketed=True)
        per_block = args[2].view(-1, 16)
        assert bool((per_block.amin(1) != per_block.amax(1)).any())
    check_actor_kernel(cuda, args, kw)


def check_actor_kernel(dev, args, kw):
    """The kernel against the plain version on the same inputs, at
    chip_smoke.py's tolerances."""
    eval_mode = not kw["emit_transitions"]
    n_envs = args[1].ball_x.shape[0]
    before = tar.KERNEL.launches
    sk, rk, tk, stk = tar.actor_rollout_cuda(*args, **kw)
    sp, rp, tp, stp = tar.actor_rollout_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tar.KERNEL.launches == before + 1
    ok = torch.ones(n_envs, dtype=torch.bool, device=dev)
    if not eval_mode:
        eq = ((tk["action"] == tp["action"]) & (tk["reward"] == tp["reward"])
              & (tk["done"] == tp["done"]))
        assert float(eq.float().mean()) >= 0.999
        ok = eq.all(dim=0)
        for k in ("obs", "next_obs"):
            torch.testing.assert_close(tk[k][:, ok], tp[k][:, ok], rtol=0,
                                       atol=1e-5)
    for f in ("score_a", "score_b", "bounce_count", "t"):
        assert float((getattr(sk, f) == getattr(sp, f)).float().mean()) \
            >= 0.999
    for f in ("ball_x", "ball_y", "ball_vx", "ball_vy", "spin"):
        torch.testing.assert_close(getattr(sk, f)[ok], getattr(sp, f)[ok],
                                   rtol=0, atol=1e-5)
    torch.testing.assert_close(stk[:7].sum(1), stp[:7].sum(1), rtol=0.01,
                               atol=1.0)


def update_kwargs(dev, heads_only, tau, interval, seed=2, bs=BS, updates=K):
    rng = np.random.default_rng(seed)
    buf = per_init(CAP, device=dev, block=True)
    m = 2048
    batch = (rng.uniform(-1, 1, (m, 7)).astype(np.float32),
             rng.integers(0, 3, m).astype(np.int32),
             rng.normal(size=m).astype(np.float32),
             rng.uniform(-1, 1, (m, 7)).astype(np.float32),
             rng.random(m) < 0.2)
    per_push(buf, Transition(*(torch.from_numpy(x).to(dev) for x in batch)),
             0.6)
    pr = np.zeros(CAP, np.float32)
    pr[:m] = rng.uniform(0.1, 2.0, m)
    pa = torch.from_numpy(pr ** np.float32(0.6)).to(dev)
    gen = torch.Generator().manual_seed(seed)
    params = qnet_to_flat(qnet_init(gen)).to(dev)
    noise = tdu.pack_dqn_noise(qnet_sample_noise(gen, qnet_init(gen),
                                                 batch=(updates,))).to(dev)
    return dict(ts0=1, count0=0, frame0=7, size=m,
                u01=torch.from_numpy(rng.random((updates, bs))
                                     .astype(np.float32))
                .to(dev), noise=noise, p_alpha=pa,
                chunk_sums=pa.view(-1, 128).sum(dim=1), params=params,
                target=params.clone(), m=torch.zeros_like(params),
                v=torch.zeros_like(params), data=buf.data, K=updates, bs=bs,
                lr=2.5e-4, gamma=0.99, interval=interval, tau=tau, alpha=0.6,
                per_eps=1e-6, beta_start=0.4, beta_frames=1000,
                heads_only=heads_only)


@pytest.mark.cuda
@pytest.mark.parametrize("heads_only,tau,interval,bs,updates", [
    (True, 0.0, 2, BS, K), (False, 0.0, 10_000, BS, K),
    (True, 0.05, 10_000, BS, K), (True, 0.0, 2, 512, K),
    (False, 0.0, 10_000, 512, K),
    # qnet.replay_heavy's block: 256 full-net updates, a hard sync at k 127
    (False, 0.0, 129, BS, 256)])
def test_update_kernel_matches_plain(cuda, heads_only, tau, interval, bs,
                                     updates):
    kk = update_kwargs(cuda, heads_only, tau, interval, bs=bs,
                       updates=updates)
    kp = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
          for k, v in kk.items()}
    before = tdu.KERNEL.launches
    nk, ik, lk = tdu.dqn_update_cuda(**kk)
    np_, ip, lp = tdu.dqn_update_plain(**kp)
    torch.cuda.synchronize()
    assert tdu.KERNEL.launches == before + 1
    assert torch.equal(ik[0], ip[0])
    assert float((ik == ip).float().mean()) >= 0.99
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-6)
    for key, atol in (("params", 1e-6), ("target", 1e-6), ("m", 1e-7),
                      ("v", 1e-9), ("chunk_sums", 1e-5)):
        torch.testing.assert_close(kk[key], kp[key], rtol=1e-4, atol=atol)


def run_twice(fn, kw):
    """Two launches on fresh copies of the same inputs: (outputs, inputs
    after the call) of each."""
    runs = []
    for _ in range(2):
        k = {a: (b.clone() if isinstance(b, torch.Tensor) else b)
             for a, b in kw.items()}
        out = fn(**k)
        torch.cuda.synchronize()
        runs.append((out if isinstance(out, tuple) else (out,), k))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("heads_only", [True, False])
def test_update_kernels_are_bit_reproducible(cuda, heads_only):
    """The cluster's and the cooperative launch's reductions run in a
    fixed order: two runs on the same inputs agree bit for bit."""
    (o1, k1), (o2, k2) = run_twice(tdu.dqn_update_cuda, update_kwargs(
        cuda, heads_only, 0.0, 2, bs=512))
    for a, b in zip(o1, o2):                  # newp, idx, losses
        assert torch.equal(a, b)
    for key in ("params", "target", "m", "v", "chunk_sums", "p_alpha"):
        assert torch.equal(k1[key], k2[key]), key
    (o1, k1), (o2, k2) = run_twice(tdru.drqn_update_cuda, drqn_update_kwargs(
        cuda, 9 if heads_only else 0, 10 if heads_only else 1000, 0.0))
    assert torch.equal(o1[0], o2[0])          # losses
    for key in ("params", "target", "m", "v"):
        assert torch.equal(k1[key], k2[key]), key


@pytest.mark.cuda
def test_rollout_kernels_are_bit_reproducible(cuda):
    """Both rollout kernels sum in a fixed order (loops and shuffle
    butterflies): two launches on the same inputs agree bit for bit, blocks
    of several members included."""
    for fn, (args, kw) in (
            (tar.actor_rollout_cuda, actor_args(3, False, False, cuda)),
            (tar.actor_rollout_cuda, actor_args(17, True, False, cuda,
                                                bucketed=True)),
            (trr.recurrent_rollout_cuda, rnn_args(3, False, cuda,
                                                  bucketed=True))):
        one, two = fn(*args, **kw), fn(*args, **kw)
        torch.cuda.synchronize()
        flat = lambda out: [t for x in out for t in (
            x.values() if isinstance(x, dict) else
            (x if isinstance(x, tuple) else (x,)))]
        for a, b in zip(flat(one), flat(two)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrappers_check_their_arguments(cuda):
    args, kw = actor_args(1, False, False, cuda)
    with pytest.raises(ValueError, match="tile_rows"):
        tar.actor_rollout_cuda(*args, **{**kw, "tile_rows": 40})
    bad_idx = args[2].to(torch.int64)
    with pytest.raises(ValueError, match="opp_idx"):
        tar.actor_rollout_cuda(*args[:2], bad_idx, *args[3:], **kw)
    kk = update_kwargs(cuda, True, 0.0, 2)
    with pytest.raises(ValueError, match="u01"):
        tdu.dqn_update_cuda(**{**kk, "u01": kk["u01"].double()})
    with pytest.raises(ValueError, match="params"):
        tdu.dqn_update_cuda(**{**kk, "params": kk["params"].cpu()})
    with pytest.raises(ValueError, match="batch <= 512"):
        tdu.dqn_update_cuda(**update_kwargs(cuda, True, 0.0, 2, bs=640))


def gate_test_net(kind, gen, dev):
    q = qnet_init(gen, device=dev)
    if kind == "folded":
        q = qnet_fold_noise(q, qnet_sample_noise(gen, q))
    elif kind == "sigmas":
        for layer in (q.fc_v, q.fc_a):
            for p in (layer.w_sigma, layer.b_sigma):
                p.data.copy_(torch.randn(p.shape, generator=gen))
    return q


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["init", "folded", "sigmas"])
def test_gate_packs_match_pack_qnet_on_the_card(cuda, kind):
    """The gathered gate packs equal the module packs on the card."""
    gen = torch.Generator().manual_seed(11)
    for _ in range(3):
        q = gate_test_net(kind, gen, cuda)
        flat = qnet_to_flat(q)
        assert flat.is_cuda
        assert torch.equal(tar.flat_seat_pack(flat, q), tar.packed_flat(
            tar.pack_qnet(_zero_sigma(q))))
        assert torch.equal(tar.flat_mirror_pack(flat, q), tar.packed_flat(
            tar.pack_qnet([q], mirror=True)))


def module_pack_seat(env_params, bottom, top, gen, min_episodes, n_envs,
                     chunk_steps, tile_rows, dev):
    """A gate seat through module copies, ``reset`` and the training
    rollout's wrapper (its packs and bounds read): what the gate's own
    operands have to reproduce. Returns (bottom_wins, draws, episodes)."""
    learner = tar.pack_qnet(_zero_sigma(bottom).to(dev))
    opp = tar.pack_qnet([qnet_copy(top).to(dev)], mirror=True)
    state = reset(env_params, n_envs, gen, dev)
    opp_idx = torch.zeros((n_envs,), dtype=torch.int32, device=dev)
    ep_ret = torch.zeros((n_envs,), dtype=torch.float32, device=dev)
    wins = draws = episodes = 0
    while episodes < min_episodes:
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
        state, opp_idx, ep_ret, _, stats, _, _ = tar.actor_rollout(
            env_params, state, opp_idx, ep_ret, learner, opp, seed=seed,
            epsilon=0.0, steps=chunk_steps, tile_rows=tile_rows,
            emit_transitions=False)
        s = stats.tolist()
        episodes += s[0] + s[2]
        wins += s[1] + s[3]
        draws += s[4]
    return wins, draws, episodes


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_steps,min_episodes", [(256, 1000),
                                                      (8, 4000)])
def test_gate_seats_match_module_packs_on_the_card(cuda, chunk_steps,
                                                  min_episodes):
    """Both gates from their own operands equal the same gates through
    module packs and the wrapper, bit for bit, generator state included
    (one chunk a seat, and several)."""
    env_params = env_params_from_config(load_config(CONFIG).env)
    gen = torch.Generator().manual_seed(5)
    a, b = gate_test_net("folded", gen, "cpu"), gate_test_net("init", gen,
                                                               "cpu")
    kw = dict(n_envs=4096, chunk_steps=chunk_steps, tile_rows=512)
    g1, g2 = (torch.Generator().manual_seed(2**33 + 5) for _ in range(2))
    got = fused_win_rate(env_params, a, b, g1, min_episodes, device=cuda,
                         **kw)
    wins, _, eps = module_pack_seat(env_params, b, a, g2, min_episodes,
                                    dev=cuda, **kw)
    assert got == (wins / eps, eps)
    got = fused_win_rate_balanced(env_params, a, b, g1, min_episodes,
                                  device=cuda, **kw)
    half = min_episodes // 2
    wins_b, _, eps_b = module_pack_seat(env_params, b, a, g2, half,
                                        dev=cuda, **kw)
    wins_a, draws_a, eps_a = module_pack_seat(env_params, a, b, g2, half,
                                              dev=cuda, **kw)
    rate_b, rate_a = wins_b / eps_b, (eps_a - wins_a - draws_a) / eps_a
    assert got == ((rate_b + rate_a) / 2, rate_b, rate_a, eps_b + eps_a)
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.cuda
def test_learner_iteration_runs_both_kernels(cuda):
    cfg = load_config(CONFIG)
    dq = dataclasses.replace(cfg.dqn, num_envs=B, rollout_length=T,
                             updates_per_iteration=K, batch_size=BS,
                             memory_size=CAP, pallas_tile_rows=TILE)
    learner = DQNLearner(cfg.env, dq)
    state = learner.init_state(0)
    opp = learner.prepare_opponents([learner.params_b(state)] * 2)
    assert opp.shared_trunk
    a0, u0 = tar.KERNEL.launches, tdu.KERNEL.launches
    state, m = learner.train_iteration(state, opp, 1)
    torch.cuda.synchronize()
    assert (tar.KERNEL.launches, tdu.KERNEL.launches) == (a0 + 1, u0 + 1)
    assert m.updates_run == K and np.isfinite(m.mean_loss)
    assert state.buffer.size == B * T and state.params.is_cuda


def replay_heavy_learner(dev, seed=2**33 + 3):
    """A learner at ``qnet.replay_heavy``'s shape (512 x 64, 256 full-net
    updates of 256, a 2^20 replay), a fresh state and a two-slot stack."""
    cfg = load_config(CONFIG)
    dq = dataclasses.replace(cfg.dqn, num_envs=512, rollout_length=64,
                             updates_per_iteration=256, batch_size=256,
                             train_heads_only=False)
    learner = DQNLearner(cfg.env, dq, device=dev)
    state = learner.init_state(seed)
    other = qnet_init(torch.Generator().manual_seed(seed + 1))
    return learner, state, learner.prepare_opponents(
        [learner.params_b(state), other])


def state_leaves(x):
    """Every tensor and number of a train state (the generator as its
    state), in field order."""
    if isinstance(x, torch.Generator):
        return [x.get_state()]
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x)
                for v in state_leaves(getattr(x, f.name))]
    if isinstance(x, tuple):
        return [v for y in x for v in state_leaves(y)]
    return [x]


@pytest.fixture
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.mark.cuda
def test_warm_learner_call_waits_once_and_never_syncs(cuda, tracer_off):
    """A warm call at ``qnet.replay_heavy``'s shape makes no synchronizing
    call and one host wait (``sync::readbacks``), and runs its update."""
    learner, state, opp = replay_heavy_learner(cuda)
    for _ in range(2):
        state, _ = learner.train_iteration(state, opp, 1)
    torch.cuda.synchronize()
    trace.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = learner.train_iteration(state, opp, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert trace.drain()["counters"] == {"sync::readbacks": 1}
    assert m.updates_run == 256 and np.isfinite(m.mean_loss)


@pytest.mark.cuda
def test_learner_calls_run_ahead_bit_equal_to_synchronized_calls(
        cuda, tracer_off):
    """Ten calls back to back equal the same ten calls with the card
    drained after each, state, metrics and generator bit for bit; at least
    8 of calls 2-10 launch kernel 1 while the previous update block runs
    (``learner::ahead``)."""
    (learner, own, opp), (ref_learner, ref, ref_opp) = (
        replay_heavy_learner(cuda) for _ in range(2))
    torch.cuda.synchronize()
    trace.enable()
    metrics = []
    for _ in range(10):
        own, m = learner.train_iteration(own, opp, 1)
        metrics.append(m)
    counters = trace.drain()["counters"]
    trace.disable()
    assert counters.get("learner::ahead", 0) >= 8
    assert counters["sync::readbacks"] == 10
    for m in metrics:
        ref, m_ref = ref_learner.train_iteration(ref, ref_opp, 1)
        torch.cuda.synchronize()
        assert m.updates_run == 256 and m == m_ref
        assert float(m.mean_loss) == float(m_ref.mean_loss)
    for a, b in zip(state_leaves(own), state_leaves(ref), strict=True):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.cuda
@pytest.mark.parametrize("slot", [2, -1])
def test_learner_call_refuses_a_slot_outside_the_stack(cuda, slot):
    learner, state, opp = replay_heavy_learner(cuda)
    opp = learner.prepare_opponents([learner.params_b(state)])
    state.opp_idx[7] = slot
    with pytest.raises(ValueError, match="opp_idx"):
        learner.train_iteration(state, opp, 0)
    torch.cuda.synchronize()


RNN_CONFIG = "configs/rnn.yaml"
RNN_WIDTHS = dict(feature_dim=64, lstm_hidden_dim=32, head_hidden_dim=32)
RNN_DIMS = (32, 64, 32, 32)


def rebind_binding(n_envs, pool_size, seed):
    """A pool change mid-training: a seeded random half of the envs on the
    buckets of ``pool_size`` members, the rest on those of one fewer."""
    moved = np.random.default_rng(seed).permutation(n_envs) < n_envs // 2
    return np.where(moved, bucket_opp_idx(n_envs, 0.4, pool_size).numpy(),
                    bucket_opp_idx(n_envs, 0.4, pool_size - 1).numpy())


def rnn_args(n_slots, eval_mode, dev, seed=5, n_envs=B, tile_rows=TILE,
             widths=RNN_WIDTHS, bucketed=False, opp=None):
    cfg = load_config(RNN_CONFIG)
    gen = torch.Generator().manual_seed(seed)
    learner, *members = (qnet_rnn_init(gen, **widths).to(dev)
                         for _ in range(1 + n_slots))
    if eval_mode:
        for layer in (learner.fc_a, learner.shared):
            layer.w_sigma.data.zero_()
            layer.b_sigma.data.zero_()
    rng = np.random.default_rng(seed)
    if opp is None:
        opp = opp_binding(n_slots, n_envs, seed, bucketed)
    hid = rng.uniform(-0.5, 0.5, (4 * widths["lstm_hidden_dim"], n_envs)
                      ).astype(np.float32)
    env_params = env_params_from_config(cfg.env)
    args = (env_params, reset(env_params, n_envs, gen, dev),
            torch.from_numpy(opp.astype(np.int32)).to(dev),
            torch.zeros(n_envs, device=dev),
            torch.from_numpy(hid).to(dev), trr.pack_qnet_rnn(learner),
            trr.pack_rnn_sigma(learner),
            trr.pack_qnet_rnn(members, mirror=True))
    kw = dict(seed=1234567, eps_i=0 if eval_mode else 300000, steps=T,
              max_episode_steps=0 if eval_mode else 40, tile_rows=tile_rows,
              emit_transitions=not eval_mode)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots,eval_mode", [(1, False), (3, False),
                                               (1, True)])
def test_recurrent_kernel_matches_plain(cuda, n_slots, eval_mode):
    check_recurrent_kernel(cuda, *rnn_args(n_slots, eval_mode, cuda))


CONFIG_WIDTHS = dict(feature_dim=128, lstm_hidden_dim=128,
                     head_hidden_dim=128)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "b1000_tile40", "small_widths", "3slot_bucketed_mixed", "b4096",
    "17slot_bucketed", "17slot_rebind", "b1000_tile40_3slot", "odd_widths"])
def test_recurrent_kernel_matches_plain_at_other_shapes(cuda, case):
    """1000 envs in tiles of 40; the smallest widths (F1 16, F 32, H 16, HH
    16: most of a row's lanes idle); widths off a multiple of 4 (F1 25, F
    50, H 50, HH 30: the kernel adds zero units); 3 slots bound in
    buckets, so 8-env runs of envs mix members; the bench's 4096 envs at
    the configs' widths
    (32 envs a block, 128 blocks); 17 slots in buckets and after a pool
    change (half the envs on the buckets of 16 members); 1000 envs in
    tiles of 40 bound to 3 slots in buckets."""
    if case == "b1000_tile40":
        args, kw = rnn_args(2, False, cuda, n_envs=1000, tile_rows=40)
    elif case == "small_widths":
        args, kw = rnn_args(2, False, cuda, widths=dict(
            feature_dim=32, lstm_hidden_dim=16, head_hidden_dim=16))
    elif case == "odd_widths":
        args, kw = rnn_args(2, False, cuda, widths=dict(
            feature_dim=50, lstm_hidden_dim=50, head_hidden_dim=30))
    elif case == "3slot_bucketed_mixed":
        args, kw = rnn_args(3, False, cuda, bucketed=True)
        per_block = args[2].view(-1, 8)
        assert bool((per_block.amin(1) != per_block.amax(1)).any())
    elif case == "b4096":
        args, kw = rnn_args(1, False, cuda, n_envs=4096, tile_rows=512,
                            widths=CONFIG_WIDTHS)
        plan = trr.launch_plan(args[2], 512, 1, trr.packed_dims(args[5]))
        assert plan.envs == 32
        assert trr.plan_counts(plan) == (0, 0, 128, 1)
    elif case == "17slot_bucketed":
        args, kw = rnn_args(17, False, cuda, n_envs=1024, tile_rows=512,
                            bucketed=True)
    elif case == "17slot_rebind":
        args, kw = rnn_args(17, False, cuda, n_envs=1024, tile_rows=512,
                            opp=rebind_binding(1024, 16, 9))
    else:
        args, kw = rnn_args(3, False, cuda, n_envs=1000, tile_rows=40,
                            bucketed=True)
    check_recurrent_kernel(cuda, args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("binding", ["17slot_rebind", "b1000_tile40"])
def test_block_table_kernel_matches_plain(cuda, binding):
    """The wrapper's block table, built on the card, equals the plain
    ``block_table``'s, with the block count and the range of opp_idx."""
    if binding == "17slot_rebind":
        opp, tile, n_slots = rebind_binding(1024, 16, 3), 512, 17
    else:
        opp, tile, n_slots = opp_binding(3, 1000, 4, True), 40, 3
    opp = torch.from_numpy(opp.astype(np.int32)).to(cuda)
    plan = trr.launch_plan(opp, tile, n_slots, RNN_DIMS)
    counts = trr.segment_counts(opp, tile, n_slots)
    want = trr.block_table(opp, tile, plan.envs, counts, plan.table.shape[0])
    assert torch.equal(plan.table, want)
    lo, hi, n_blocks, _ = trr.plan_counts(plan)
    assert (lo, hi) == (int(opp.min()), int(opp.max()))
    assert n_blocks == int(trr.member_blocks(counts, plan.envs).sum())


@pytest.mark.cuda
def test_recurrent_kernel_env_result_does_not_depend_on_its_block(cuda):
    """Two bindings that put the same envs (same member, same tile) in
    other blocks and lanes: those envs' outputs are bit-equal (the second
    call gets the opponents' flat stack from the caller, as the trainer
    and the gates pass it)."""
    opp1 = np.zeros(B, dtype=np.int32)
    opp2 = opp1.copy()
    opp2[:5] = 1          # shifts tile 0's member-0 envs by 5 lanes
    opp2[TILE:TILE + 3] = 1
    args1, kw = rnn_args(2, False, cuda, opp=opp1)
    args2, _ = rnn_args(2, False, cuda, opp=opp2)
    s1, r1, h1, t1, st1 = trr.recurrent_rollout_cuda(*args1, **kw)
    s2, r2, h2, t2, st2 = trr.recurrent_rollout_cuda(
        *args2, **kw, opponents_flat=trr.rnn_kernel_flat(args2[7]))
    torch.cuda.synchronize()
    same = torch.from_numpy(opp1 == opp2).to(cuda)
    for f in EnvState._fields[:-1]:
        assert torch.equal(getattr(s1, f)[same], getattr(s2, f)[same]), f
    assert torch.equal(r1[same], r2[same])
    assert torch.equal(h1[:, same], h2[:, same])
    assert torch.equal(st1[:, same], st2[:, same])
    for k in ("obs", "action", "reward", "done"):
        assert torch.equal(t1[k][:, same], t2[k][:, same]), k


def check_recurrent_kernel(dev, args, kw):
    """The kernel against the plain version on the same inputs, at
    chip_smoke.py's tolerances."""
    eval_mode = not kw["emit_transitions"]
    n_envs = args[1].ball_x.shape[0]
    before = trr.KERNEL.launches
    sk, rk, hk, tk, stk = trr.recurrent_rollout_cuda(*args, **kw)
    sp, rp, hp, tp, stp = trr.recurrent_rollout_plain(*args, **kw)
    torch.cuda.synchronize()
    assert trr.KERNEL.launches == before + 1
    ok = torch.ones(n_envs, dtype=torch.bool, device=dev)
    if not eval_mode:
        eq = ((tk["action"] == tp["action"]) & (tk["reward"] == tp["reward"])
              & (tk["done"] == tp["done"]))
        assert float(eq.float().mean()) >= 0.999
        ok = eq.all(dim=0)
        torch.testing.assert_close(tk["obs"][:, ok], tp["obs"][:, ok],
                                   rtol=0, atol=1e-5)
    for f in ("score_a", "score_b", "bounce_count", "t"):
        assert float((getattr(sk, f) == getattr(sp, f)).float().mean()) \
            >= 0.999
    for f in ("ball_x", "ball_y", "ball_vx", "ball_vy", "spin"):
        torch.testing.assert_close(getattr(sk, f)[ok], getattr(sp, f)[ok],
                                   rtol=0, atol=1e-5)
    torch.testing.assert_close(hk[:, ok], hp[:, ok], rtol=0, atol=1e-4)
    torch.testing.assert_close(stk[:7].sum(1), stp[:7].sum(1), rtol=0.01,
                               atol=1.0)


def drqn_update_kwargs(dev, ts0, interval, tau, seed=2, bs=16):
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    net, tgt = (qnet_rnn_init(gen, **RNN_WIDTHS) for _ in range(2))
    K_, T_ = (4, 4) if bs <= 64 else (2, 2)
    t = lambda x: torch.from_numpy(x).to(dev)
    obs = rng.uniform(-1, 1, (K_, bs, T_ + 1, 7)).astype(np.float32)
    xt, nextt, meta = tdru.kernel_inputs(
        t(obs[:, :, :T_].copy()), t(obs[:, :, 1:].copy()),
        t(rng.integers(0, 3, (K_, bs))), t(rng.normal(size=(K_, bs))
                                          .astype(np.float32)),
        t(rng.random((K_, bs)) < 0.2), t(rng.random((K_, bs)) < 0.9))
    params = qnet_rnn_to_flat(net).to(dev)
    return dict(ts0=ts0, count0=ts0, xt=xt, nextt=nextt, meta=meta,
                noise=tdru.flat_noise(qnet_rnn_sample_noise(
                    gen, net, batch=(K_,))).to(dev),
                params=params, target=qnet_rnn_to_flat(tgt).to(dev),
                m=torch.zeros_like(params), v=torch.zeros_like(params),
                dims=RNN_DIMS, K=K_, bs=bs, T=T_, lr=1e-3, clip=1.0,
                gamma=0.99, interval=interval, tau=tau)


@pytest.mark.cuda
@pytest.mark.parametrize("ts0,interval,tau,bs", [
    (0, 1000, 0.0, 16), (9, 10, 0.0, 16), (0, 1000, 0.05, 16),
    (0, 1000, 0.0, 528)])   # 528: a BPTT step's columns over all threads
def test_drqn_update_kernel_matches_plain(cuda, ts0, interval, tau, bs):
    kk = drqn_update_kwargs(cuda, ts0, interval, tau, bs=bs)
    kp = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
          for k, v in kk.items()}
    before = tdru.KERNEL.launches
    lk = tdru.drqn_update_cuda(**kk)
    lp = tdru.drqn_update_plain(**kp)
    torch.cuda.synchronize()
    assert tdru.KERNEL.launches == before + 1
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-6)
    for key in ("params", "target"):
        torch.testing.assert_close(kk[key], kp[key], rtol=1e-4, atol=1e-6)
    for key in ("m", "v"):
        torch.testing.assert_close(kk[key], kp[key], rtol=1e-3, atol=1e-9)


@pytest.mark.cuda
def test_recurrent_wrappers_check_their_arguments(cuda):
    args, kw = rnn_args(1, False, cuda)
    for tile_rows in (12, 36):   # not multiples of 8 envs a block
        with pytest.raises(ValueError, match="tile_rows"):
            trr.recurrent_rollout_cuda(*args, **{**kw, "tile_rows": tile_rows})
    with pytest.raises(ValueError, match="hid"):
        trr.recurrent_rollout_cuda(*args[:4], args[4][:8], *args[5:], **kw)
    flat = trr.rnn_kernel_flat(args[7])
    with pytest.raises(ValueError, match="opponents_flat"):
        trr.recurrent_rollout_cuda(*args, **kw, opponents_flat=flat[:, 1:])
    bad = args[2].clone()
    bad[7] = 1           # one slot only
    with pytest.raises(ValueError, match="opp_idx"):
        trr.recurrent_rollout_cuda(*args[:2], bad, *args[3:], **kw)
    torch.cuda.synchronize()
    kk = drqn_update_kwargs(cuda, 0, 1000, 0.0)
    with pytest.raises(ValueError, match="noise"):
        tdru.drqn_update_cuda(**{**kk, "noise": kk["noise"][:, 1:]})
    with pytest.raises(ValueError, match="widths"):
        tdru.drqn_update_cuda(**{**kk, "dims": (32, 256, 32, 32)})


@pytest.mark.cuda
def test_drqn_learner_iteration_runs_both_kernels(cuda):
    cfg = load_config(RNN_CONFIG)
    dq = dataclasses.replace(cfg.drqn, **RNN_WIDTHS, num_envs=B,
                             rollout_length=64, updates_per_iteration=4,
                             batch_size=16, trace_length=4, ring_len=256,
                             pallas_tile_rows=TILE, max_episode_steps=50,
                             min_episodes_for_training_start=1)
    learner = DRQNLearner(cfg.env, dq)
    state = learner.init_state(0)
    opp = learner.prepare_opponents([learner.params_b(state)] * 2)
    r0, u0 = trr.KERNEL.launches, tdru.KERNEL.launches
    for _ in range(4):
        state, m = learner.train_iteration(state, opp, 1)
    torch.cuda.synchronize()
    assert trr.KERNEL.launches == r0 + 4 and tdru.KERNEL.launches > u0
    assert m.updates_run == 4 and np.isfinite(m.mean_loss)
    assert state.params.is_cuda and state.buffer.ep_count > 16


# the headline bench's env (pingpong_tpu_torch/bench.py)
BENCH_ENV = EnvConfig(
    paddle_speed=0.03, magnus_factor=0.025, restitution=1.0, friction=0.6,
    ball_speed_range=(0.03, 0.05), spin_range=(-5, 5),
    speed_scale_every=1, speed_increment=0.1)


def pong_state(n, dev, seed):
    """Mid-rally states with scores up to 2, so serves run early."""
    rng = np.random.default_rng(seed)
    speed = rng.uniform(0.03, 0.05, n)
    ang = np.deg2rad(rng.uniform(30.0, 60.0, n)) * rng.choice([-1.0, 1.0], n)
    f = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)
    i = lambda hi: torch.from_numpy(rng.integers(0, hi, n)
                                    .astype(np.int32)).to(dev)
    return EnvState(
        ball_x=f(rng.uniform(0.1, 0.9, n)), ball_y=f(rng.uniform(0.2, 0.8, n)),
        ball_vx=f(speed * np.cos(ang)), ball_vy=f(speed * np.sin(ang)),
        spin=f(rng.uniform(-5.0, 5.0, n)),
        top_paddle_x=f(rng.uniform(0.1, 0.9, n)),
        bottom_paddle_x=f(rng.uniform(0.1, 0.9, n)), score_a=i(3),
        score_b=i(3), bounce_count=i(6), t=i(60),
        done=torch.zeros(n, dtype=torch.bool, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n,tile_rows", [(256, 1), (512, 2), (8192, 64)])
def test_pong_kernel_matches_plain(cuda, n, tile_rows):
    """A 64-step chunk: discrete fields and reward sums equal on >= 99.9 %
    of envs, floats within 1e-5 on those (chip_smoke.py's tolerances)."""
    params = env_params_from_config(BENCH_ENV)
    state = pong_state(n, cuda, tile_rows)
    before = tpk.KERNEL.launches
    sk, rk = tpk.pong_rollout_cuda(params, state, 64, 99,
                                   tile_rows=tile_rows)
    sp, rp = tpk.pong_rollout_plain(params, state, 64, 99,
                                    tile_rows=tile_rows)
    torch.cuda.synchronize()
    assert tpk.KERNEL.launches == before + 1
    ok = rk == rp
    for f in ("score_a", "score_b", "bounce_count", "t"):
        ok &= getattr(sk, f) == getattr(sp, f)
    assert float(ok.float().mean()) >= 0.999
    for f in ("ball_x", "ball_y", "ball_vx", "ball_vy", "spin",
              "top_paddle_x", "bottom_paddle_x"):
        torch.testing.assert_close(getattr(sk, f)[ok], getattr(sp, f)[ok],
                                   rtol=0, atol=1e-5)
    assert not bool(sk.done.any()) and float(rk.abs().sum()) > 0


@pytest.mark.cuda
def test_pong_wrapper_checks_its_arguments(cuda):
    params = env_params_from_config(BENCH_ENV)
    state = pong_state(256, cuda, 0)
    before = tpk.KERNEL.launches
    with pytest.raises(ValueError, match="ball_vx"):
        tpk.pong_rollout_cuda(params, state._replace(
            ball_vx=state.ball_vx.double()), 4, 0, tile_rows=1)
    strided = torch.zeros(512, device=cuda)[::2]
    with pytest.raises(ValueError, match="spin must be contiguous"):
        tpk.pong_rollout_cuda(params, state._replace(spin=strided), 4, 0,
                              tile_rows=1)
    with pytest.raises(ValueError, match="multiple of 8192"):
        tpk.pong_rollout_cuda(params, state, 4, 0)
    with pytest.raises(ValueError, match="score_a"):
        tpk.pong_rollout_cuda(params, state._replace(
            score_a=state.score_a.cpu()), 4, 0, tile_rows=1)
    assert tpk.KERNEL.launches == before


PONG_ENVS = {
    "bench": BENCH_ENV,                       # speed-up every hit
    "default": EnvConfig(),                   # every third hit, max_score 3
    # m and inertia below 2^-20: no Markstein division, every hit's
    # quotients recomputed by __fdiv_rn
    "tiny_mass": EnvConfig(ball_mass=1e-7),
}


def bit_equal(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("env", sorted(PONG_ENVS))
@pytest.mark.parametrize("n,tile_rows", [(256, 1), (512, 2), (8192, 64)])
def test_pong_kernel_is_bit_equal_to_plain(cuda, env, n, tile_rows):
    """A 300-step chunk from mid-rally states, at the smallest batches the
    tile rule admits and at a bench tile: every field and every reward sum
    bit for bit, at the bench's env, the default one and a tiny mass."""
    params = env_params_from_config(PONG_ENVS[env])
    state = pong_state(n, cuda, 7 + tile_rows)
    sk, rk = tpk.pong_rollout_cuda(params, state, 300, 5,
                                   tile_rows=tile_rows)
    sp, rp = tpk.pong_rollout_plain(params, state, 300, 5,
                                    tile_rows=tile_rows)
    torch.cuda.synchronize()
    assert bit_equal(rk, rp)
    for name in EnvState._fields:
        assert bit_equal(getattr(sk, name), getattr(sp, name)), name
    assert int((sp.t < 300).sum()) > 0       # some envs were served


@pytest.mark.cuda
@pytest.mark.parametrize("env", ["bench", "default"])
def test_pong_kernel_shortcuts_are_exact(cuda, env):
    """The kernel's division by m and by inertia equals __fdiv_rn on every
    float where it uses it, and its sine and cosine equal sinf and cosf on
    every float below 105615."""
    params = env_params_from_config(PONG_ENVS[env])
    counts = tpk.pong_exactness_check(params, cuda)
    assert counts[:2] == (0, 0) and counts[4:] == (0, 0)


@pytest.mark.cuda
def test_pong_kernel_is_bit_reproducible(cuda):
    params = env_params_from_config(BENCH_ENV)
    state = pong_state(8192, cuda, 3)
    (s1, r1), (s2, r2) = (tpk.pong_rollout_cuda(params, state, 256, 4)
                          for _ in range(2))
    torch.cuda.synchronize()
    assert bit_equal(r1, r2)
    assert all(bit_equal(a, b) for a, b in zip(s1, s2))


@pytest.mark.cuda
def test_pong_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    state = pong_state(256, cuda, 0)
    wide = env_params_from_config(dataclasses.replace(
        BENCH_ENV, ball_angle_intervals=((-6e6, -30.0), (30.0, 60.0))))
    before = tpk.KERNEL.launches
    with pytest.raises(ValueError, match="serve angles"):
        tpk.pong_rollout_cuda(wide, state, 4, 0, tile_rows=1)
    params = env_params_from_config(BENCH_ENV)
    with pytest.raises(ValueError, match="bot_tolerance"):
        tpk.pong_rollout_cuda(params, state, 4, 0, bot_tolerance=-0.01,
                              tile_rows=1)
    with pytest.raises(ValueError, match="2\\^24"):
        tpk.pong_rollout_cuda(params, state, (1 << 24) + 1, 0, tile_rows=1)
    assert tpk.KERNEL.launches == before


def c51_inputs(bs, n_atoms, seed, device):
    """Kernel 6's inputs: returns past both ends of the support, rows that
    land exactly on atoms (disc 0 and an atom's value), episode ends."""
    from pingpong_tpu_torch.ops.c51_loss import _dz

    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((bs, n_atoms), generator=g) * 2.0
    p = torch.softmax(torch.randn((bs, n_atoms), generator=g) * 2.0, dim=-1)
    ret = (torch.rand((bs,), generator=g) * 2.0 - 1.0) * 14.0
    disc = torch.where(torch.rand((bs,), generator=g) < 0.3, 0.0,
                       float(np.float32(0.99 ** 3)))
    on_atom = torch.arange(bs) % 4 == 0
    atom = torch.randint(0, n_atoms, (bs,), generator=g).float()
    ret = torch.where(on_atom, -10.0 + atom * _dz(n_atoms, -10.0, 10.0), ret)
    disc = torch.where(on_atom, 0.0, disc)
    w = torch.rand((bs,), generator=g) * 0.9 + 0.1
    return [x.to(device) for x in (logits, p, ret, disc, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n_atoms", [(256, 51), (37, 11), (8, 64)])
def test_c51_kernel_matches_plain(cuda, bs, n_atoms):
    """Kernel 6 against its plain version (the batch of rainbow.ladder,
    a ragged batch, the most atoms a warp takes): the projection sums in
    another order and the kernel's exp and log are CUDA's, so loss and
    gradient agree to float32 rounding of sums of 51 terms."""
    from pingpong_tpu_torch.ops import c51_loss as k6

    args = c51_inputs(bs, n_atoms, 7, cuda)
    before = k6.KERNEL.launches
    loss, grad = k6.c51_loss(*args, -10.0, 10.0)
    torch.cuda.synchronize()
    assert k6.KERNEL.launches == before + 1
    ref_loss, ref_grad = k6.c51_loss_plain(*(x.cpu() for x in args),
                                           -10.0, 10.0)
    torch.testing.assert_close(loss.cpu(), ref_loss, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(grad.cpu(), ref_grad, rtol=1e-4, atol=1e-9)
    again = k6.c51_loss(*args, -10.0, 10.0)
    assert bit_equal(loss, again[0]) and bit_equal(grad, again[1])


@pytest.mark.cuda
def test_adam_default_eps_is_unchanged_on_the_card(cuda):
    """The QNet's and the DRQN's autodiff Adam (no eps given) is the
    frozen copy's bit for bit, and an eps of optax's default is the same
    call; Rainbow's eps moves the step."""
    from benchmark.reference.frozen import optim as frozen
    from pingpong_tpu_torch.train.optim import ADAM_EPS, adam_

    g = torch.Generator().manual_seed(3)
    x, grad, m, v = (torch.randn((5192,), generator=g).to(cuda)
                     for _ in range(4))
    v = v.abs()
    runs = []
    for fn, kw in ((adam_, {}), (adam_, {"eps": ADAM_EPS}),
                   (frozen.adam_, {}), (adam_, {"eps": 1.5e-4})):
        xs, ms, vs = x.clone(), m.clone(), v.clone()
        fn(xs, grad, ms, vs, 7, 2.5e-4, **kw)
        runs.append((xs, ms, vs))
    for other in runs[1:3]:
        assert all(bit_equal(a, b) for a, b in zip(runs[0], other))
    assert not bit_equal(runs[0][0], runs[3][0])


@pytest.mark.cuda
def test_rainbow_update_graph_is_bit_equal_to_eager(cuda):
    """Rainbow's learner on the card: the rollout chunk and the update
    block replayed as CUDA graphs (from the second call on the same
    tensors) compute the bits the eager calls compute, over five calls at
    a reduced width with a fault's reset before the fourth, which keeps
    the graphs."""
    from pingpong_tpu_torch.config import apply_overrides
    from pingpong_tpu_torch.train.rainbow import RainbowLearner

    cfg = apply_overrides(load_config("configs/rainbow.yaml"), [
        "dqn.num_envs=64", "dqn.rollout_length=16", "dqn.batch_size=64",
        "dqn.memory_size=16384", "dqn.updates_per_iteration=8",
        "dqn.target_update_interval=12"])
    runs = []
    for graphs in (True, False):
        learner = RainbowLearner(cfg.env, cfg.dqn, cuda)
        learner.graphs = graphs
        state = learner.init_state(2**33 + 9)
        init = learner.params_b(state)
        opp = learner.prepare_opponents([init])
        losses, captured = [], []
        for i in range(5):
            if i == 3:   # a fault's reset keeps the graphs
                captured = [learner._block.graph, learner._chunk_buf
                            and learner._chunk_buf.graph]
                state = learner.reset_learner(state, init)
            state, m = learner.train_iteration(state, opp, 0)
            losses.append(m.mean_loss)
        assert (learner._block.graph is not None) == graphs
        assert captured == [learner._block.graph, learner._chunk_buf
                            and learner._chunk_buf.graph]
        assert (learner._chunk_buf is not None
                and learner._chunk_buf.graph is not None) == graphs
        runs.append((state, losses + [m.episodes, m.wins_vs_a, m.epsilon]))
    (a, la), (b, lb) = runs
    assert la == lb
    for x, y in ((a.params, b.params), (a.target, b.target),
                 (a.env_state.ball_x, b.env_state.ball_x),
                 (a.env_state.score_b, b.env_state.score_b),
                 (a.ep_return, b.ep_return), (a.carry.obs, b.carry.obs),
                 (a.buffer.data, b.buffer.data),
                 (a.opt_mu, b.opt_mu), (a.opt_nu, b.opt_nu),
                 (a.buffer.prios, b.buffer.prios),
                 (a.buffer.chunk_sums, b.buffer.chunk_sums)):
        assert bit_equal(x, y)
