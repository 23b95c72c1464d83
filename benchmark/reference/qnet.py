"""Plain reference of the QNet generation loop (configuration family
``qnet``): the loop's start from the seed, a train iteration followed from
the program's state before it, and the greedy gate.

Everything is computed with the frozen copies in ``frozen/`` (plain
PyTorch, float32, TF32 off unless the control asks for it); nothing of
the program is imported. The inputs are the harness's: the configuration,
the seed and the program's state snapshots (dicts of tensors, see
``benchmark/harness.py::snapshot``).

What one iteration is, in the learner's own order (``train_iteration``):

1. from the state's host generator: the rollout seed; then the update
   block's head noise ``(K,)`` and its uniforms ``(K, bs)``;
2. the rollout chunk (kernel 1's plain version): both seats' forwards,
   epsilon-greedy by the counter hash, the env step and the auto-reset,
   against A alone (the pool is empty: a fresh run loads no checkpoint);
3. the chunk pushed into the prioritized replay at the current maximum
   priority; the update block (kernel 2's plain version) once the replay
   holds a batch.

The rollout and the update are followed apart: the update starts from the
rows the program pushed (read back from its replay, which the update does
not change), so a rollout that parts from the reference in one env does
not blur the update's numbers, and each stage is judged by itself.
"""

from __future__ import annotations

import statistics
import types
from typing import Dict, List

import numpy as np
import torch

from .common import (
    env_mismatch,
    generator_from,
    leaf_gap,
    leaf_spans,
    median_gap,
    precision,
    relative,
    rows_mismatch,
    to_device,
    worst,
)
from .frozen import actor as A
from .frozen import dqn_update as U
from .frozen import env as E
from .frozen import gates as G
from .frozen import per as PER
from .frozen import qnet as Q

CHUNK = 128


def _env_params(cfg: dict):
    return E.env_params_from_config(types.SimpleNamespace(**cfg["env"]))


def _template(device):
    return Q.qnet_init(torch.Generator().manual_seed(0), device=device)


def start(cfg: dict, seed: int, device) -> dict:
    """The loop's state before its first iteration, from the seed alone:
    the initial weights, the A that plays (with its one noise draw folded
    in when ``frozen_a_stale_noise``), the learner's generator and the
    reset envs."""
    d = cfg["dqn"]
    if d.get("init_model_path"):
        raise ValueError("the reference starts from random weights only")
    gen = torch.Generator().manual_seed(int(seed))
    init = Q.qnet_init(gen)
    a_play = init
    if d["selfplay"]["frozen_a_stale_noise"]:
        a_play = Q.qnet_fold_noise(init, Q.qnet_sample_noise(gen, init))
    learner_seed = int(torch.randint(0, 2**62, (1,), generator=gen))
    lgen = torch.Generator().manual_seed(learner_seed)
    env = E.reset(_env_params(cfg), d["num_envs"], lgen, device)
    return dict(params=Q.qnet_to_flat(init).to(device),
                a_play=Q.qnet_copy(a_play).to(device),
                loop_generator=gen.get_state(),
                generator=lgen.get_state(),
                env_state=env._asdict())


def start_gap(ref: dict, prog: dict, prog_loop_generator) -> float:
    """0 when the program's first state is the seed's, else the largest
    parameter difference, the share of envs that differ, or 1 for a
    generator in another state."""
    gaps = [float((prog["params"] - ref["params"]).abs().max()),
            env_mismatch(prog["env_state"], ref["env_state"])]
    same = (torch.equal(prog["generator"], ref["generator"])
            and torch.equal(prog_loop_generator, ref["loop_generator"]))
    return max(gaps + [0.0 if same else 1.0])


def follow(cfg: dict, pre: dict, post: dict, a_play, device,
           given=None, mode: str = "f32") -> dict:
    """One train iteration from the program's state ``pre``: the rollout
    from ``pre`` and the update from ``pre`` with the rows the program
    pushed (``post``'s replay). ``given``: the program's update block's
    outputs ``(raw priorities written (K, bs), sampled slots (K, bs),
    losses (K,))``; each update takes the program's slots and writes the
    program's priorities, so that a sample or a Double-DQN argmax that
    parts on a rounding does not carry the rest of the block onto other
    rows and weights. Returns the outputs compared: the envs and pushed
    rows after the chunk, the episode count, each update's loss, the slots
    the reference's own sampler picks and the priorities it would write,
    the parameters and the Adam first moment."""
    d = cfg["dqn"]
    pre, post = to_device(pre, device), to_device(post, device)
    n, T = d["num_envs"], d["rollout_length"]
    K, bs = d["updates_per_iteration"], d["batch_size"]
    if d["opponent_binding"] != "bucketed":
        raise ValueError("the reference follows bucketed binding only")
    ep = _env_params(cfg)
    template = _template(device)
    gen = generator_from(pre["generator"])
    with precision(mode):
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
        # every env plays A: the pool is empty, so every bucket is A's
        opp_idx = torch.zeros((n,), dtype=torch.int32, device=device)
        lw = A.pack_qnet(Q.qnet_from_flat(pre["params"], template))
        opp = A.pack_qnet([a_play], mirror=True)
        new_env, _, _, tr, counts, _, _ = A.actor_rollout(
            ep, E.EnvState(**pre["env_state"]), opp_idx, pre["ep_return"],
            lw, opp, seed=seed, epsilon=pre["epsilon"], steps=T,
            max_episode_steps=cfg["env"]["max_episode_steps"],
            tile_rows=min(d["pallas_tile_rows"], n), member_shared_trunk=True)
        counts = [int(c) for c in counts.tolist()]
        pushed = PER.pack_block_fields(PER.Transition(
            obs=tr["obs"].reshape(-1, 7), action=tr["action"].reshape(-1),
            reward=tr["reward"].reshape(-1),
            next_obs=tr["next_obs"].reshape(-1, 7),
            done=tr["done"].reshape(-1)))

        b = pre["buffer"]
        buf = PER.PERBuffer(data=b["data"].clone(), prios=b["prios"].clone(),
                            p_alpha=b["p_alpha"].clone(),
                            chunk_sums=b["chunk_sums"].clone(),
                            pos=b["pos"], size=b["size"])
        slot = (b["pos"] + torch.arange(T * n, device=device)) \
            % buf.capacity
        fields = post["buffer"]["data"][slot // CHUNK, :, slot % CHUNK]
        PER.per_push(buf, PER.decode_block_fields(fields, 7), d["per_alpha"])
        noise = U.pack_dqn_noise(Q.qnet_sample_noise(gen, template,
                                                     batch=(K,)))
        u01 = torch.rand((K, bs), generator=gen)
        params, mu = pre["params"].clone(), pre["opt_mu"].clone()
        losses = own = newp = torch.zeros((0,))
        follows = given is not None and tuple(given[1].shape) == (K, bs)
        if buf.size >= bs:
            newp, own, losses = U.dqn_update_plain(
                ts0=pre["train_steps"], count0=pre["opt_count"],
                frame0=pre["frame_idx"], size=buf.size,
                u01=u01.to(device), noise=noise.to(device),
                p_alpha=buf.p_alpha, chunk_sums=buf.chunk_sums,
                params=params, target=pre["target"].clone(), m=mu,
                v=pre["opt_nu"].clone(), data=buf.data, K=K, bs=bs,
                lr=d["lr"], gamma=d["gamma"],
                interval=d["target_update_interval"], tau=d["target_tau"],
                alpha=d["per_alpha"], per_eps=d["per_eps"],
                beta_start=d["per_beta_start"],
                beta_frames=d["per_beta_frames"],
                heads_only=d["train_heads_only"],
                given_idx=given[1].to(device) if follows else None,
                given_newp=given[0].to(device) if follows else None)
    return dict(env_state=new_env._asdict(), pushed=pushed,
                episodes=pre["episodes"] + counts[0] + counts[2],
                losses=losses.double().cpu(), idx=own.cpu(),
                newp=newp.double().cpu(), params=params, opt_mu=mu)


def action_gap(cfg: dict, pre: dict, rows: torch.Tensor, device) -> float:
    """How far the chunk's actions (``rows``: the pushed fields, time-major)
    lie from what the learner in ``pre`` chooses at the same observations:
    per env-step, an exploring step (by the counter hash) must take the
    hash's random action (else 1), a greedy one lies below the best
    advantage by that gap over the advantages' spread. The worst step's.
    The observations are the chunk's own, so a step that parted at a near
    tie does not carry its env's later steps with it."""
    d = cfg["dqn"]
    pre = to_device(pre, device)
    n, T = d["num_envs"], d["rollout_length"]
    tile = min(d["pallas_tile_rows"], n)
    gen = generator_from(pre["generator"])
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
    tr = PER.decode_block_fields(rows.to(device), 7)
    lw = A.pack_qnet(Q.qnet_from_flat(pre["params"], _template(device)))
    env = torch.arange(n, device=device)
    tiles, lane = env // tile, env % tile
    mix_tiles = A.tile_seed_mix(seed, n // tile, device)
    mix_env = mix_tiles[tiles]
    grid_r, grid_c = A._noise_grid(device)
    eps = float(np.float32(A.epsilon_to_int(pre["epsilon"]))
                * np.float32(1e-6))
    worst = 0.0
    with precision("f32"):
        for t in range(T):
            ctr = 16 * t
            sn = A.hash_noise(mix_tiles[:, None], ctr, 1, 2, grid_r, grid_c)
            ein, eout = sn[:, :A.HIDDEN], sn[:, A.HIDDEN:]
            wa = lw.wat_mu[:3] + lw.wat_sigma[:3] * (eout[:, :, None]
                                                     * ein[:, None, :])
            ba = lw.bat_mu[:3, 0] + lw.bat_sigma[:3, 0] * eout
            obs = tr.obs[t * n:(t + 1) * n]
            act = tr.action[t * n:(t + 1) * n].long()
            h2 = A._trunk(lw.w1t, lw.b1t, lw.w2t, lw.b2t, obs)
            adv = torch.einsum("bh,bah->ba", h2, wa[tiles]) + ba[tiles]
            explore = A.hash_u01(mix_env, ctr, 5, 0, lane) < eps
            rand = torch.clamp((A.hash_u01(mix_env, ctr, 6, 0, lane) * 3.0)
                               .to(torch.int64), 0, 2)
            top = adv.max(dim=1).values
            spread = torch.clamp(top - adv.min(dim=1).values, min=1e-30)
            greedy_gap = (top - adv.gather(1, act[:, None])[:, 0]) / spread
            gap = torch.where(explore, (act != rand).to(torch.float32),
                              greedy_gap)
            worst = max(worst, float(gap.max()))
    return worst


def gate(cfg: dict, capture: dict, a_play, device, mode: str = "f32"):
    """B's win rate against A in the loop's first gate, from the loop
    generator's state before it (``capture``: the learner's parameters
    and that state)."""
    d = cfg["dqn"]
    sp = d["selfplay"]
    n = d["num_envs"]
    gen = generator_from(capture["loop_generator"])
    b = Q.qnet_from_flat(capture["params"].to(device), _template(device))
    kw = dict(n_envs=min(n, 8192),
              tile_rows=min(d["pallas_tile_rows"], n, 8192), device=device)
    with precision(mode):
        if sp["swap_sides_eval"]:
            wr, _, _, _ = G.fused_win_rate_balanced(
                _env_params(cfg), a_play, b, gen,
                min_episodes=max(2, sp["eval_episodes"]), **kw)
        else:
            wr, _ = G.fused_win_rate(_env_params(cfg), a_play, b, gen,
                                     min_episodes=max(1, sp["eval_episodes"]),
                                     **kw)
    return float(wr)


def program_outputs(pre: dict, post: dict, metrics: dict, given,
                    device) -> dict:
    """The program's side of :func:`follow`'s outputs: the rows it pushed
    are read back from its replay at the slots of the chunk."""
    post = to_device(post, device)
    n, cap = post["env_state"]["t"].shape[0], post["buffer"]["prios"].shape[0]
    m = int(metrics["env_steps"])
    slot = (pre["buffer"]["pos"] + torch.arange(m, device=device)) % cap
    pushed = post["buffer"]["data"][slot // CHUNK, :, slot % CHUNK]
    return dict(env_state=post["env_state"], pushed=pushed,
                episodes=post["episodes"],
                losses=given[2].double(), idx=given[1],
                newp=given[0].double(),
                params=post["params"], opt_mu=post["opt_mu"])


def compare(steps: List[dict], ref_steps: List[dict], pres: List[dict],
            device, cfg: dict) -> Dict[str, float]:
    """The gaps of the followed iterations: the rollout's share of envs
    and pushed rows that differ (or the relative gap of the episode
    count), the worst step's :func:`action_gap`, the share of
    sampled slots where the reference's sampler parts from the program's,
    the median over the samples of the written priorities' relative gap
    and over the updates of the losses' relative gap (a Double-DQN argmax
    that flips on a rounding moves one sample's priority and one update's
    loss a long way, and nothing else), the first step's Adam first moment
    and each step's parameter change, by the worst leaf."""
    spans = leaf_spans((n, p.numel())
                       for n, p in _template("cpu").named_parameters())
    roll, loss, dparam, sample, act, prio, dmed = [], [], [], [], [], [], []
    grad = 0.0
    for i, (p, r, pre) in enumerate(zip(steps, ref_steps, pres)):
        act.append(action_gap(cfg, pre, p["pushed"], device))
        roll.append(max(env_mismatch(p["env_state"], r["env_state"]),
                        rows_mismatch(p["pushed"], r["pushed"]),
                        relative(p["episodes"], r["episodes"])))
        loss.append(median_gap(p["losses"], r["losses"]))
        prio.append(median_gap(p["newp"], r["newp"]))
        sample.append(float((p["idx"].long() != r["idx"].long())
                            .float().mean())
                      if p["idx"].shape == r["idx"].shape else 1.0)
        x0 = pre["params"].to(device)
        dparam.append(leaf_gap(p["params"] - x0, r["params"] - x0,
                               r["opt_mu"], spans))
        dmed.append(leaf_gap(p["params"] - x0, r["params"] - x0,
                             r["opt_mu"], spans, statistics.median))
        if i == 0:
            grad = leaf_gap(p["opt_mu"], r["opt_mu"], r["opt_mu"], spans)
    return dict(rollout_mismatch=worst(roll), action_gap=worst(act),
                sample_mismatch=worst(sample), prio_gap=worst(prio),
                loss_gap=worst(loss), grad_gap=grad,
                dparam_gap=worst(dparam), dparam_median_gap=worst(dmed))
