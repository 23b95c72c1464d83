"""PyTorch port: the QNet gate's operands built straight in kernel 1's
layout (``evaluation/fast_eval.py``, ``ops/actor_rollout.py``).

The packs gathered from a raveled net equal ``packed_flat(pack_qnet(...))``
under ``torch.equal``; the gates return what the benchmark's frozen copy of
the gates returns and leave the generator in the same state; the QNet loop
packs B once a gate, A once a lifetime and the pool once a run, and reads
the card once a gate chunk."""

import dataclasses

import pytest
import torch

from benchmark.reference.frozen import env as frozen_env
from benchmark.reference.frozen import gates as frozen_gates
from benchmark.reference.frozen import qnet as frozen_qnet
from benchmark.tests.tiny import QNET as TINY_QNET
from pingpong_tpu_torch.config import apply_overrides, load_config
from pingpong_tpu_torch.env.pong import env_params_from_config
from pingpong_tpu_torch.evaluation.fast_eval import (
    fused_win_rate,
    fused_win_rate_balanced,
    gate_net,
)
from pingpong_tpu_torch.models.qnet import (
    QNet,
    qnet_copy,
    qnet_fold_noise,
    qnet_from_flat,
    qnet_init,
    qnet_sample_noise,
    qnet_to_flat,
)
from pingpong_tpu_torch.ops.actor_rollout import (
    flat_mirror_pack,
    flat_seat_pack,
    flat_train_pack,
    pack_qnet,
    packed_flat,
    unpack_flat,
)
from pingpong_tpu_torch.selfplay.loop import QNetSelfPlay
from pingpong_tpu_torch.utils import trace
from pingpong_tpu_torch.utils.metrics import MetricsLogger


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _zero_sigma(params: QNet) -> QNet:
    """A copy with the advantage head's sigmas zeroed: the learner seat's
    net, as the module packs take it."""
    out = qnet_copy(params)
    out.fc_a.w_sigma.data.zero_()
    out.fc_a.b_sigma.data.zero_()
    return out


def net(kind: str, seed: int):
    gen = torch.Generator().manual_seed(seed)
    q = qnet_init(gen)
    if kind == "folded":
        q = qnet_fold_noise(q, qnet_sample_noise(gen, q))
    elif kind == "sigmas":
        for layer in (q.fc_v, q.fc_a):
            for p in (layer.w_sigma, layer.b_sigma):
                p.data.copy_(torch.randn(p.shape, generator=gen))
    return q


# ---------------------------------------------------------------------------
# Packs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["init", "folded", "sigmas"])
def test_gathered_packs_equal_the_parents(kind, seed):
    q = net(kind, seed)
    flat = qnet_to_flat(q)
    seat = packed_flat(pack_qnet(_zero_sigma(q)))
    assert torch.equal(flat_seat_pack(flat, q), seat)
    # from a learner's flat parameters, as the learner's own net
    template = qnet_init(torch.Generator().manual_seed(0))
    params = flat.clone()
    assert torch.equal(flat_seat_pack(params, template),
                       packed_flat(pack_qnet(_zero_sigma(
                           qnet_from_flat(params, template)))))
    mirror = flat_mirror_pack(flat, q)
    assert mirror.shape == (1, seat.shape[0])
    assert torch.equal(mirror, packed_flat(pack_qnet([q], mirror=True)))
    # the plain version reads the fields back as pack_qnet laid them out
    for got, want in zip(unpack_flat(mirror), pack_qnet([q], mirror=True)):
        assert torch.equal(got, want) and got.stride() == want.stride()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["init", "folded", "sigmas"])
def test_training_seat_gather_equals_the_module_pack(kind, seed):
    """The training rollout's learner seat, sigmas kept, gathered from the
    learner's flat parameters as the module pack of its own net."""
    template = qnet_init(torch.Generator().manual_seed(0))
    params = qnet_to_flat(net(kind, seed))
    want = packed_flat(pack_qnet(qnet_from_flat(params, template)))
    got = flat_train_pack(params, template)
    assert torch.equal(got, want)
    for a, b in zip(unpack_flat(got), pack_qnet(qnet_from_flat(params,
                                                                template))):
        assert torch.equal(a, b) and a.stride() == b.stride()


def test_packs_refuse_other_widths():
    q = qnet_init(torch.Generator().manual_seed(0), hidden=32)
    with pytest.raises(ValueError, match="hidden=64"):
        flat_seat_pack(qnet_to_flat(q), q)


def test_gate_net_counts_a_pack_and_skips_an_unused_mirror():
    q = net("init", 0)
    trace.enable()
    packs = gate_net(qnet_to_flat(q), q, mirror=False)
    assert packs.mirror is None
    assert trace.drain()["counters"] == {"gate::packs": 1}


# ---------------------------------------------------------------------------
# Gates against the benchmark's frozen copy
# ---------------------------------------------------------------------------

ENV_CFG = load_config("configs/qnet.yaml").env


@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("chunk_steps,min_episodes", [(256, 8), (16, 200)],
                         ids=["one_chunk", "several_chunks"])
@pytest.mark.parametrize("seed", [3, 2**33 + 12345])
def test_gates_equal_the_frozen_reference(seed, chunk_steps, min_episodes,
                                          balanced):
    a, b = net("folded", seed % 1000), net("init", seed % 1000 + 1)
    like = frozen_qnet.qnet_init(torch.Generator().manual_seed(0))
    fa, fb = (frozen_qnet.qnet_from_flat(qnet_to_flat(x), like)
              for x in (a, b))
    kw = dict(min_episodes=min_episodes, n_envs=TINY_QNET["dqn.num_envs"],
              chunk_steps=chunk_steps,
              tile_rows=TINY_QNET["dqn.pallas_tile_rows"], device="cpu")
    gen, fgen = (torch.Generator().manual_seed(seed) for _ in range(2))
    trace.enable()
    if balanced:
        got = fused_win_rate_balanced(env_params_from_config(ENV_CFG), a, b,
                                      gen, **kw)
        want = frozen_gates.fused_win_rate_balanced(
            frozen_env.env_params_from_config(ENV_CFG), fa, fb, fgen, **kw)
    else:
        got = fused_win_rate(env_params_from_config(ENV_CFG), a, b, gen,
                             **kw)
        want = frozen_gates.fused_win_rate(
            frozen_env.env_params_from_config(ENV_CFG), fa, fb, fgen, **kw)
    assert got == want
    assert torch.equal(gen.get_state(), fgen.get_state())
    counters = trace.drain()["counters"]
    chunks = counters["gate::chunks"]
    seats = 2 if balanced else 1
    assert (chunks == seats) == (chunk_steps == 256) and chunks >= seats
    assert counters["sync::readbacks"] == chunks
    assert counters["gate::packs"] == 2


# ---------------------------------------------------------------------------
# The loop: packs follow A
# ---------------------------------------------------------------------------

class GateLog:
    """Each gate's generator state and B before it (after the try's last
    train call), the A it played, its win rate, and the tracer's records
    drained right after it."""

    def __init__(self, loop):
        self.loop = loop
        self.gates = []
        self.before = None
        inner = loop.learner.train_iteration

        def call(state, opp, pool_size, **kw):
            state, m = inner(state, opp, pool_size, **kw)
            self.before = (loop.gen.get_state(), state.params.clone())
            return state, m

        def log(record):
            real(record)
            self.on_event(record)

        real = loop.logger.log
        loop.learner.train_iteration = call
        loop.logger.log = log

    def on_event(self, record):
        if record["event"] == "eval":
            self.gates.append(dict(
                gen=self.before[0], params=self.before[1],
                a_play=self.loop.params_a_play, win=record["win_vs_A"],
                promoted=False, **trace.drain()))
        elif record["event"] == "promoted":
            self.gates[-1]["promoted"] = True
            # the next generation faults: tries until the retry limit
            loop = self.loop
            loop.cfg = dataclasses.replace(loop.cfg, selfplay=dataclasses
                                           .replace(loop.cfg.selfplay,
                                                    curr_win_threshold=1.1))


def run_logged(workdir, threshold, generations):
    cfg = apply_overrides(load_config("configs/qnet.yaml"), [
        f"{k}={v}" for k, v in {
            **TINY_QNET, "dqn.selfplay.max_generations": generations,
            "dqn.selfplay.max_retries_for_generation": 2,
            "dqn.selfplay.curr_win_threshold": threshold,
            "dqn.selfplay.pool_win_threshold": 0.0,
            "dqn.save_latest_checkpoint_interval_steps": 0}.items()])
    loop = QNetSelfPlay(cfg.env, cfg.dqn, workdir=str(workdir), seed=7,
                        logger=MetricsLogger(echo=False), device="cpu")
    log = GateLog(loop)
    trace.enable()
    loop.run()
    return loop, log.gates


def readbacks_match_chunks(gate):
    """Every read of the card inside a gate seat is its chunk's stats
    read: one a chunk."""
    spans = gate["spans"]
    seats = {s["id"] for s in spans if s["name"] == "gate::opponent"}
    reads = [s for s in spans if s["name"] == "sync::readback"
             and s["parent"] in seats]
    return len(reads) == gate["counters"]["gate::chunks"]


def test_loop_packs_follow_a_through_a_promotion_and_a_fault(tmp_path):
    loop, gates = run_logged(tmp_path, 0.0, 3)
    # generation 1 promoted at its gate; 2 and 3 fault after two tries
    assert [g["promoted"] for g in gates] == [True] + [False] * 4
    assert [r.promoted for r in loop.records] == [True, False, False]
    packs = [g["counters"].get("gate::packs", 0) for g in gates]
    hits = [g["counters"].get("gate::pack_hits", 0) for g in gates]
    # B every gate; A at its first gate and after the promotion, then
    # reused, across the fault after gate 3 too
    assert packs == [2, 2, 1, 1, 1]
    assert hits == [0, 0, 1, 1, 1]
    assert all(readbacks_match_chunks(g) for g in gates)
    assert gates[1]["a_play"] is not gates[0]["a_play"]
    assert all(g["a_play"] is gates[1]["a_play"] for g in gates[2:])
    # the gate after the promotion plays the new A: the frozen gate from
    # the same generator state gives the same win rate
    g = gates[1]
    like = frozen_qnet.qnet_init(torch.Generator().manual_seed(0))
    gen = torch.Generator()
    gen.set_state(g["gen"])
    n = loop.cfg.num_envs
    want, _ = frozen_gates.fused_win_rate(
        frozen_env.env_params_from_config(loop.env_cfg),
        frozen_qnet.qnet_from_flat(qnet_to_flat(g["a_play"]), like),
        frozen_qnet.qnet_from_flat(g["params"], like), gen,
        min_episodes=loop.cfg.selfplay.eval_episodes, n_envs=n,
        tile_rows=min(loop.cfg.pallas_tile_rows, n), device="cpu")
    assert g["win"] == want

    # a second run over these checkpoints: its pool (one promoted, two
    # faults) is packed once for the run
    loop2, gates2 = run_logged(tmp_path, 1.1, 1)
    assert len(loop2.pool) == 3
    assert [g["counters"].get("gate::packs", 0) for g in gates2] == [5, 1]
    assert [g["counters"].get("gate::pack_hits", 0)
            for g in gates2] == [0, 4]
    assert all(readbacks_match_chunks(g) for g in gates2)
