"""Plain reference of the DRQN generation loop (configuration family
``drqn``): the loop's start from the seed, a train iteration followed from
the program's state before it, and the greedy gate.

As ``qnet.py``, with the recurrent pieces of ``frozen/``: one iteration
is, in the learner's own order, the rollout seed from the state's host
generator; the recurrent rollout chunk (kernel 3's plain version) against
A alone, the opponent stream of the envs that ended in the last chunk
zeroed; the chunk pushed into the per-env sequence ring; then the update
block's head noise and window candidates from the generator, and, once
the ring has admitted more than ``batch_size *
min_episodes_for_training_start`` episodes, the update block (kernel 4's
plain version) on the sampled windows. An update does not touch the ring,
so the update is followed from the ring the program pushed, apart from
the rollout.
"""

from __future__ import annotations

import types
from typing import Dict, List

import numpy as np
import torch

from .common import (
    env_mismatch,
    generator_from,
    leaf_gap,
    leaf_spans,
    precision,
    relative,
    rows_mismatch,
    to_device,
    worst,
)
from .frozen import actor as A
from .frozen import drqn_update as DU
from .frozen import env as E
from .frozen import gates as G
from .frozen import qnet_rnn as QR
from .frozen import recurrent as R
from .frozen import sequence as S


def _env_params(cfg: dict):
    return E.env_params_from_config(types.SimpleNamespace(**cfg["env"]))


def _init(cfg: dict, generator, device="cpu"):
    d = cfg["drqn"]
    return QR.qnet_rnn_init(generator, feature_dim=d["feature_dim"],
                            lstm_hidden_dim=d["lstm_hidden_dim"],
                            lstm_layers=d["lstm_layers"],
                            head_hidden_dim=d["head_hidden_dim"]).to(device)


def _template(cfg: dict, device):
    return _init(cfg, torch.Generator().manual_seed(0), device)


def start(cfg: dict, seed: int, device) -> dict:
    """The loop's state before its first iteration, from the seed alone:
    the initial weights (A plays them too), the learner's generator, the
    reset envs and zero hidden states."""
    d = cfg["drqn"]
    if d.get("init_model_path_rnn"):
        raise ValueError("the reference starts from random weights only")
    gen = torch.Generator().manual_seed(int(seed))
    init = _init(cfg, gen)
    learner_seed = int(torch.randint(0, 2**62, (1,), generator=gen))
    lgen = torch.Generator().manual_seed(learner_seed)
    env = E.reset(_env_params(cfg), d["num_envs"], lgen, device)
    return dict(params=QR.qnet_rnn_to_flat(init).to(device),
                a_play=QR.qnet_rnn_copy(init).to(device),
                loop_generator=gen.get_state(),
                generator=lgen.get_state(),
                env_state=env._asdict())


def start_gap(ref: dict, prog: dict, prog_loop_generator) -> float:
    """As ``qnet.start_gap``; the program's hidden states must be zero."""
    gaps = [float((prog["params"] - ref["params"]).abs().max()),
            env_mismatch(prog["env_state"], ref["env_state"]),
            float(prog["hid"].abs().max())]
    same = (torch.equal(prog["generator"], ref["generator"])
            and torch.equal(prog_loop_generator, ref["loop_generator"]))
    return max(gaps + [0.0 if same else 1.0])


def follow(cfg: dict, pre: dict, post: dict, a_play, device,
           given=None, mode: str = "f32") -> dict:
    """One train iteration from the program's state ``pre``: the rollout
    from ``pre`` and the update on the ring the program pushed (``post``).
    Returns the outputs compared: the envs and hidden states after the
    chunk, the episode count, the block's mean loss, the parameters and
    the Adam first moment. ``given`` is unused: the windows are drawn from
    the generator, with nothing a rounding can flip."""
    d = cfg["drqn"]
    pre, post = to_device(pre, device), to_device(post, device)
    n, T = d["num_envs"], d["rollout_length"]
    K, bs, H = d["updates_per_iteration"], d["batch_size"], \
        d["lstm_hidden_dim"]
    if d["lstm_layers"] != 1 or d["burn_in_length"] or \
            d["episode_uniform_sampling"]:
        raise ValueError("the reference follows kernel 3 and 4's "
                         "architecture and window sampling only")
    template = _template(cfg, device)
    gen = generator_from(pre["generator"])
    with precision(mode):
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
        hid = pre["hid"].clone()
        hid[2 * H:] *= (~pre["ended"]).to(torch.float32)[None, :]
        learner = QR.qnet_rnn_from_flat(pre["params"], template)
        new_env, _, _, hid_out, tr, counts, _, _ = R.recurrent_rollout(
            _env_params(cfg), E.EnvState(**pre["env_state"]),
            pre["opp_idx"], pre["ep_return"], hid, R.pack_qnet_rnn(learner),
            R.pack_rnn_sigma(learner), R.pack_qnet_rnn([a_play], mirror=True),
            seed=seed, epsilon=pre["epsilon"], steps=T,
            max_episode_steps=d["max_episode_steps"],
            tile_rows=min(d["pallas_tile_rows"], n))
        counts = [int(c) for c in counts.tolist()]
        pushed = torch.cat([tr["obs"], tr["action"].float()[..., None],
                            tr["reward"][..., None],
                            tr["done"].float()[..., None]], -1).transpose(0, 1)

        ring = S.SeqReplay(**post["buffer"])
        noise = DU.flat_noise(QR.qnet_rnn_sample_noise(gen, template,
                                                       batch=(K,)))
        cand = S.draw_candidates(ring, gen, K * bs, d["trace_length"])
        params, mu = pre["params"].clone(), pre["opt_mu"].clone()
        loss = 0.0
        if ring.ep_count > bs * d["min_episodes_for_training_start"]:
            smp = S.seq_sample(ring, K * bs, d["trace_length"], *cand)
            shape = lambda x: x.reshape((K, bs) + x.shape[1:])
            losses = DU.drqn_update_block(
                train_steps=pre["train_steps"], adam_count=pre["opt_count"],
                obs=shape(smp.obs), next_obs=shape(smp.next_obs),
                action=shape(smp.action[:, -1]),
                reward=shape(smp.reward[:, -1]),
                done=shape(smp.done[:, -1]), valid=shape(smp.valid),
                noise=noise.to(device), params=params,
                target=pre["target"].clone(), m=mu,
                v=pre["opt_nu"].clone(),
                dims=(d["feature_dim"] // 2, d["feature_dim"], H,
                      d["head_hidden_dim"]),
                lr=d["lr"], clip=d["grad_clip_norm"], gamma=d["gamma"],
                interval=d["target_update_interval"], tau=d["target_tau"])
            loss = float(losses.sum()) / K
    return dict(env_state=new_env._asdict(), hid=hid_out, pushed=pushed,
                episodes=pre["episodes"] + counts[0] + counts[2],
                loss=loss, params=params, opt_mu=mu)


def action_gap(cfg: dict, pre: dict, rows: torch.Tensor, device) -> float:
    """As ``qnet.action_gap``, for the recurrent learner: ``rows (B, T,
    10)`` the chunk's ring rows (obs, action, reward, done); the learner's
    stream runs from ``pre``'s over the chunk's own observations and is
    zeroed after every step that ended an episode, as the kernel does."""
    d = cfg["drqn"]
    pre = to_device(pre, device)
    rows = rows.to(device)
    n, T, H = d["num_envs"], d["rollout_length"], d["lstm_hidden_dim"]
    tile = min(d["pallas_tile_rows"], n)
    gen = generator_from(pre["generator"])
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
    learner = QR.qnet_rnn_from_flat(pre["params"], _template(cfg, device))
    lw, sig = R.pack_qnet_rnn(learner), R.pack_rnn_sigma(learner)
    dims = R.packed_dims(lw)
    env = torch.arange(n, device=device)
    lane = env % tile
    mix_tiles = R.tile_seed_mix(seed, n // tile, device)
    mix_env = mix_tiles[env // tile]
    eps = float(np.float32(R.epsilon_to_int(pre["epsilon"]))
                * np.float32(1e-6))
    h, c = pre["hid"][:H].T, pre["hid"][H:2 * H].T
    worst = 0.0
    with precision("f32"):
        for t in range(T):
            ctr = 16 * t
            obs, act = rows[:, t, :7], rows[:, t, 7].long()
            heads = R._learner_heads(lw, sig, mix_tiles, ctr, dims)
            adv, h, c = R._rnn_advantage(lw, obs, h, c, heads)
            explore = A.hash_u01(mix_env, ctr, 5, 0, lane) < eps
            rand = torch.clamp((A.hash_u01(mix_env, ctr, 6, 0, lane) * 3.0)
                               .to(torch.int64), 0, 2)
            top = adv.max(dim=1).values
            spread = torch.clamp(top - adv.min(dim=1).values, min=1e-30)
            greedy_gap = (top - adv.gather(1, act[:, None])[:, 0]) / spread
            gap = torch.where(explore, (act != rand).to(torch.float32),
                              greedy_gap)
            worst = max(worst, float(gap.max()))
            keep = (rows[:, t, 9] < 0.5).to(torch.float32)[:, None]
            h, c = h * keep, c * keep
    return worst


def gate(cfg: dict, capture: dict, a_play, device, mode: str = "f32"):
    """B's win rate against A in the loop's first gate (kernel 3's plain
    version in gate mode), from the loop generator's state before it."""
    d = cfg["drqn"]
    sp = d["selfplay"]
    n = d["num_envs"]
    gen = generator_from(capture["loop_generator"])
    b = QR.qnet_rnn_from_flat(capture["params"].to(device),
                              _template(cfg, device))
    kw = dict(n_envs=min(n, 4096),
              tile_rows=min(d["pallas_tile_rows"], n, 4096),
              max_episode_steps=d["max_episode_steps"], device=device)
    per = max(2, sp["eval_episodes"])
    with precision(mode):
        if sp["swap_sides_eval"]:
            wr, _, _, _ = G.rnn_win_rate_balanced(
                _env_params(cfg), a_play, b, gen, min_episodes=per, **kw)
        else:
            wr, _ = G.rnn_win_rate(_env_params(cfg), a_play, b, gen,
                                   min_episodes=per, **kw)
    return float(wr)


def program_outputs(pre: dict, post: dict, metrics: dict, given,
                    device) -> dict:
    """The program's side of :func:`follow`'s outputs: the chunk it pushed
    is read back from its ring's columns of the chunk."""
    post = to_device(post, device)
    ring = post["buffer"]["data"]
    T = int(metrics["env_steps"]) // ring.shape[0]
    cols = (pre["buffer"]["cursor"] + torch.arange(T, device=device)) \
        % ring.shape[1]
    return dict(env_state=post["env_state"], hid=post["hid"],
                pushed=ring[:, cols],
                episodes=post["episodes"], loss=metrics["mean_loss"],
                params=post["params"], opt_mu=post["opt_mu"])


def compare(steps: List[dict], ref_steps: List[dict], pres: List[dict],
            device, cfg: dict) -> Dict[str, float]:
    """As ``qnet.compare``; the rollout's gap also counts the envs whose
    hidden states after the chunk differ by more than 1e-4."""
    spans = leaf_spans((n, p.numel())
                       for n, p in _template(cfg, "cpu").named_parameters())
    roll, loss, dparam, act = [], [], [], []
    grad = 0.0
    for i, (p, r, pre) in enumerate(zip(steps, ref_steps, pres)):
        act.append(action_gap(cfg, pre, p["pushed"], device))
        hid_bad = float(((p["hid"] - r["hid"]).abs().max(dim=0).values
                         > 1e-4).float().mean())
        roll.append(max(env_mismatch(p["env_state"], r["env_state"]),
                        rows_mismatch(p["pushed"], r["pushed"]), hid_bad,
                        relative(p["episodes"], r["episodes"])))
        loss.append(relative(p["loss"], r["loss"]))
        x0 = pre["params"].to(device)
        dparam.append(leaf_gap(p["params"] - x0, r["params"] - x0,
                               r["opt_mu"], spans))
        if i == 0:
            grad = leaf_gap(p["opt_mu"], r["opt_mu"], r["opt_mu"], spans)
    return dict(rollout_mismatch=worst(roll), action_gap=worst(act),
                loss_gap=worst(loss),
                grad_gap=grad, dparam_gap=worst(dparam))
