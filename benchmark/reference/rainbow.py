"""Plain reference of the Rainbow generation loop (configuration family
``rainbow``): the loop's start from the seed, a train iteration followed
from the program's state before it, and the first match-runner gate.

Plain PyTorch in float32 (TF32 off unless the control asks for it); it
imports nothing of the program and edits none of ``frozen/``, whose env
it steps. Departures from the paper (Hessel et al. 2018, arXiv:1710.02298),
all of them the configuration's: the 7 -> 64 -> 64 trunk in place of the
Atari conv torso, a batch of envs in lockstep with K updates an iteration
in place of one update every 4 frames, and the replay's priorities
``(loss + per_eps)^alpha`` with the loss the row's cross-entropy.

What one iteration is, in the learner's order:

1. from the state's host generator: the chunk's learner noise ``(T,)`` and
   its step draws (epsilon-greedy uniforms and actions, serves, re-binding
   uniforms and picks), then the update block's online noise ``(K,)``,
   target noise ``(K,)`` and uniforms ``(K, bs)``;
2. the chunk: A's greedy action (eval mode) against B's, greedy on the
   expected value of its distribution with the step's noise, the env step
   with auto-reset (the pool is empty: a fresh run loads no checkpoint);
3. the n-step rows of the chunk behind the state's carry, pushed into the
   row replay at its maximum priority; K updates: the sample, the online
   logits at ``(s_t, s_{t+n})``, the Double-DQN bootstrap action, the
   target's distribution there, the categorical projection (each atom
   split between its floor and ceiling, whole where it lands on one), the
   importance-weighted cross-entropy, its gradient by autograd, Adam with
   the configuration's epsilon, the priorities and the target sync.

The rollout and the update are followed apart, as for the QNet: the update
starts from the rows the program pushed.
"""

from __future__ import annotations

import math
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
from .frozen import env as E

# float32 products; the control turns TF32 on inside ``precision("tf32")``
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the precisions of (the rollout and the gate, the update block) a mode
# gives: "f32" and "tf32" everywhere, "tf32_update" (a control) TF32 in the
# update block alone
SPLIT = {"f32": ("f32", "f32"), "tf32": ("tf32", "tf32"),
         "tf32_update": ("f32", "tf32")}

OBS, HID, N_ACT = 7, 64, 3
NOISY = ("v1", "v2", "a1", "a2")
B1, B2 = 0.9, 0.999
MAX_STEPS = 20_000        # the match runner's cap of a gate's game


# ---------------------------------------------------------------------------
# The net
# ---------------------------------------------------------------------------

def shapes(d: dict) -> List[tuple]:
    """``(name, shape)`` of every parameter, in the flat vector's order."""
    A, S = d["num_atoms"], d["stream_hidden"]
    out = [("feat1.w", (OBS, HID)), ("feat1.b", (HID,)),
           ("feat2.w", (HID, HID)), ("feat2.b", (HID,))]
    for name, (i, o) in zip(NOISY, [(HID, S), (S, A), (HID, S),
                                    (S, N_ACT * A)]):
        out += [(f"{name}.w_mu", (i, o)), (f"{name}.w_sigma", (i, o)),
                (f"{name}.b_mu", (o,)), (f"{name}.b_sigma", (o,))]
    return out


def net_init(gen: torch.Generator, d: dict) -> Dict[str, torch.Tensor]:
    """Weights drawn layer by layer: ``U(+-1/sqrt(fan_in))`` for each
    weight then bias (mu of the noisy layers), sigma ``sigma0 /
    sqrt(fan_in)``."""
    p = {}
    for name, shape in shapes(d):
        fan_in = shape[0] if len(shape) == 2 else None
        if name.endswith(("w_sigma", "b_sigma")):
            i = p[name.split(".")[0] + ".w_mu"].shape[0]
            p[name] = torch.full(shape, d["noisy_sigma0"] / i ** 0.5)
            continue
        if fan_in is None:
            fan_in = p[name.split(".")[0] + (".w" if name.endswith(".b")
                                             else ".w_mu")].shape[0]
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        p[name] = (2.0 * u - 1.0) * (1.0 / fan_in ** 0.5)
    return p


def to_flat(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for v in p.values()])


def from_flat(flat: torch.Tensor, d: dict) -> Dict[str, torch.Tensor]:
    out, i = {}, 0
    for name, shape in shapes(d):
        n = math.prod(shape)
        out[name] = flat[i:i + n].view(shape)
        i += n
    return out


def noise_draw(gen: torch.Generator, d: dict, batch=()):
    """Factorised noise of the four noisy layers, ``{name: (ein, eout)}``,
    ``f(x) = sign(x) sqrt|x|`` of standard normals, ``in`` then ``out``."""
    A, S = d["num_atoms"], d["stream_hidden"]
    f = lambda x: torch.sign(x) * torch.sqrt(torch.abs(x))   # noqa: E731
    out = {}
    for name, (i, o) in zip(NOISY, [(HID, S), (S, A), (HID, S),
                                    (S, N_ACT * A)]):
        ein = f(torch.randn(tuple(batch) + (i,), generator=gen))
        eout = f(torch.randn(tuple(batch) + (o,), generator=gen))
        out[name] = (ein, eout)
    return out


def noise_at(noise, k, device):
    return {n: (a[k].to(device), b[k].to(device)) for n, (a, b)
            in noise.items()}


def logits(p, x, noise=None):
    """``x.shape[:-1] + (3, A)``; ``noise=None`` is eval mode."""
    def layer(name, h):
        w, b = p[name + ".w_mu"], p[name + ".b_mu"]
        if noise is not None:
            ein, eout = noise[name]
            w = w + p[name + ".w_sigma"] * torch.outer(ein, eout)
            b = b + p[name + ".b_sigma"] * eout
        return h @ w + b

    h = torch.relu(x @ p["feat1.w"] + p["feat1.b"])
    h = torch.relu(h @ p["feat2.w"] + p["feat2.b"])
    v = layer("v2", torch.relu(layer("v1", h)))
    a = layer("a2", torch.relu(layer("a1", h)))
    a = a.reshape(*a.shape[:-1], N_ACT, -1)
    return v[..., None, :] + a - a.mean(dim=-2, keepdim=True)


def atoms(d: dict, device) -> torch.Tensor:
    A = d["num_atoms"]
    dz = np.float32((d["v_max"] - d["v_min"]) / (A - 1))
    return (torch.arange(A, dtype=torch.float32) * float(dz)
            + float(np.float32(d["v_min"]))).to(device)


def q_values(lg, z):
    return (torch.softmax(lg, dim=-1) * z).sum(dim=-1)


def greedy(q):
    """Argmax over 3 actions, ties to the lowest index."""
    best = torch.zeros(q.shape[:-1], dtype=torch.int64, device=q.device)
    for a in (1, 2):
        best = torch.where(q[..., a] > q.gather(-1, best[..., None])[..., 0],
                           a, best)
    return best


# ---------------------------------------------------------------------------
# n-step rows, the projection, the loss, Adam
# ---------------------------------------------------------------------------

def nstep_rows(obs, action, reward, next_obs, done, n: int, gamma: float):
    """Stream ``(L, N, ...)`` -> the n-step rows starting at its first
    ``L - n + 1`` steps: return, bootstrap observation and discount, each
    start followed until its episode ends."""
    L = action.shape[0]
    rows = []
    for t in range(L - n + 1):
        g = torch.zeros_like(reward[t])
        alive = torch.ones_like(done[t])
        boot = next_obs[t]
        for k in range(n):
            g = g + torch.where(alive, reward[t + k] * float(
                np.float32(gamma ** k)), 0.0)
            boot = torch.where(alive[:, None], next_obs[t + k], boot)
            alive = alive & ~done[t + k]
        disc = torch.where(alive, float(np.float32(gamma ** n)), 0.0)
        rows.append(torch.cat([obs[t], boot, action[t].float()[:, None],
                               g[:, None], disc[:, None]], dim=1))
    return torch.stack(rows).reshape(-1, 2 * OBS + 3)


def project(p_next, ret, disc, d: dict):
    """Categorical projection of ``p_next (bs, A)`` shifted to ``clamp(ret
    + disc z)``: each atom's mass split between its floor and ceiling
    atoms, whole on one atom when it lands on it."""
    A, v_min, v_max = d["num_atoms"], d["v_min"], d["v_max"]
    z = atoms(d, p_next.device)
    dz = float(np.float32((v_max - v_min) / (A - 1)))
    tz = torch.clamp(ret[:, None] + disc[:, None] * z, v_min, v_max)
    b = (tz - v_min) / dz
    lo, hi = b.floor().long().clamp(0, A - 1), b.ceil().long().clamp(0, A - 1)
    m = torch.zeros_like(p_next)
    m.scatter_add_(1, lo, p_next * (hi.float() - b))
    m.scatter_add_(1, hi, p_next * (b - lo.float()))
    m.scatter_add_(1, lo, p_next * (lo == hi).float())
    return m


def adam(params, g, m, v, step: int, lr: float, eps: float) -> None:
    t = torch.tensor(float(step), device=params.device)
    bc1 = 1.0 - torch.exp(t * math.log(B1))
    bc2 = 1.0 - torch.exp(t * math.log(B2))
    m.copy_(m * B1 + g * (1.0 - B1))
    v.copy_(v * B2 + g * g * (1.0 - B2))
    params.copy_(params - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))


# ---------------------------------------------------------------------------
# The row replay
# ---------------------------------------------------------------------------

def _cumsum(x, dim=-1):
    return torch.cumsum(x.double(), dim=dim).float()


def chunk_of(capacity: int) -> int:
    c = 1
    while c < 128 and capacity % (c * 2) == 0:
        c *= 2
    return c


def push(buf: dict, rows: torch.Tensor, alpha: float) -> None:
    """Rows at the ring's cursor at the current maximum priority (1 when
    empty); the chunk sums recomputed."""
    cap = buf["prios"].shape[0]
    mx = buf["prios"].max() if buf["size"] > 0 else torch.tensor(
        1.0, device=rows.device)
    idx = (buf["pos"] + torch.arange(rows.shape[0], device=rows.device)) % cap
    buf["data"][idx] = rows
    buf["prios"][idx] = mx
    buf["p_alpha"][idx] = mx ** alpha
    buf["chunk_sums"].copy_(buf["p_alpha"].view(-1, chunk_of(cap)).sum(1))
    buf["pos"] = (buf["pos"] + rows.shape[0]) % cap
    buf["size"] = min(buf["size"] + rows.shape[0], cap)


def sample(buf: dict, u01: torch.Tensor) -> torch.Tensor:
    """Two-level inverse CDF: the chunk, then the slot in it."""
    cap = buf["prios"].shape[0]
    ch = chunk_of(cap)
    cdf = _cumsum(buf["chunk_sums"])
    u = u01 * cdf[-1]
    c = torch.clamp((cdf[None, :] < u[:, None]).sum(1), 0, cap // ch - 1)
    prev = torch.where(c > 0, cdf[torch.clamp(c - 1, min=0)], 0.0)
    rcdf = _cumsum(buf["p_alpha"].view(-1, ch)[c], dim=1)
    off = torch.clamp((rcdf < (u - prev)[:, None]).sum(1), 0, ch - 1)
    return torch.clamp(c * ch + off, 0, max(buf["size"] - 1, 0))


def is_weights(buf: dict, idx: torch.Tensor, beta) -> torch.Tensor:
    total = _cumsum(buf["chunk_sums"])[-1]
    probs = buf["p_alpha"][idx] / torch.clamp(total, min=1e-30)
    w = (float(buf["size"]) * torch.clamp(probs, min=1e-30)) ** (-beta)
    return w / torch.clamp(w.max(), min=1e-30)


def write_priorities(buf: dict, idx, loss, alpha: float, eps: float):
    """``(loss + eps)`` for the sampled slots, the last write of a slot
    kept; each touched chunk's sum moved by its slots' change."""
    cap = buf["prios"].shape[0]
    old = buf["p_alpha"][idx]
    newp = loss + eps
    order = torch.sort(idx, stable=True).indices
    si = idx[order]
    last = torch.searchsorted(si, si, right=True) - 1
    buf["prios"][si] = newp[order[last]]
    buf["p_alpha"][si] = newp[order[last]] ** alpha
    first = torch.ones_like(si, dtype=torch.bool)
    first[1:] = si[1:] != si[:-1]
    delta = torch.where(first, buf["p_alpha"][si] - old[order], 0.0)
    buf["chunk_sums"].index_add_(0, si // chunk_of(cap), delta)


def beta_at(frame: int, d: dict):
    f = torch.tensor(float(frame), dtype=torch.float32)
    return torch.clamp(d["per_beta_start"] + f * (1.0 - d["per_beta_start"])
                       / d["per_beta_frames"], max=1.0)


# ---------------------------------------------------------------------------
# The harness's functions
# ---------------------------------------------------------------------------

def _env_params(cfg: dict):
    return E.env_params_from_config(types.SimpleNamespace(**cfg["env"]))


def start(cfg: dict, seed: int, device) -> dict:
    """The loop's state before its first iteration, from the seed alone:
    the initial weights (also the A that plays), the learner's generator
    and the reset envs."""
    d = cfg["dqn"]
    if d.get("init_model_path"):
        raise ValueError("the reference starts from random weights only")
    gen = torch.Generator().manual_seed(int(seed))
    init = net_init(gen, d)
    learner_seed = int(torch.randint(0, 2**62, (1,), generator=gen))
    lgen = torch.Generator().manual_seed(learner_seed)
    env = E.reset(_env_params(cfg), d["num_envs"], lgen, device)
    return dict(params=to_flat(init).to(device),
                a_play={k: v.to(device) for k, v in init.items()},
                loop_generator=gen.get_state(), generator=lgen.get_state(),
                env_state=env._asdict())


def start_gap(ref: dict, prog: dict, prog_loop_generator) -> float:
    gaps = [float((prog["params"] - ref["params"]).abs().max()),
            env_mismatch(prog["env_state"], ref["env_state"]),
            0.0 if not prog["carry_valid"] else 1.0]
    same = (torch.equal(prog["generator"], ref["generator"])
            and torch.equal(prog_loop_generator, ref["loop_generator"]))
    return max(gaps + [0.0 if same else 1.0])


def _rollout(cfg, pre, a_play, gen, device):
    """The chunk from ``pre``: ``(env after, episodes, stream of the
    chunk's steps, learner noise)``."""
    d = cfg["dqn"]
    n, T = d["num_envs"], d["rollout_length"]
    ep = _env_params(cfg)
    z = atoms(d, device)
    noise = noise_draw(gen, d, (T,))
    explore = torch.rand((T, n), generator=gen)
    random_a = torch.randint(0, 3, (T, n), generator=gen, dtype=torch.int32)
    serve = torch.rand((T, 4, n), generator=gen)
    torch.rand((T, n), generator=gen)                     # re-binding gates
    torch.randint(0, 1, (T, n), generator=gen, dtype=torch.int32)  # picks
    p = from_flat(pre["params"], d)
    env = E.EnvState(**pre["env_state"])
    eps = np.float32(pre["epsilon"])
    episodes = 0
    stream = {k: [] for k in ("obs", "action", "reward", "next_obs", "done")}
    for t in range(T):
        obs_a, obs_b = E.observe_a(env), E.observe_b(env)
        act_a = greedy(q_values(logits(a_play, obs_a), z)).to(torch.int32)
        q = q_values(logits(p, obs_b, noise_at(noise, t, device)), z)
        act_b = torch.where(explore[t].to(device) < float(eps),
                            random_a[t].to(device),
                            greedy(q).to(torch.int32))
        env, out = E.step_autoreset_batch(
            ep, env, None, act_a, act_b, cfg["env"]["max_episode_steps"],
            u=serve[t].to(device))
        for k, x in zip(stream, (obs_b, act_b, out.reward_b, out.obs_b,
                                 out.done)):
            stream[k].append(x)
        nd = int(out.done.sum())
        episodes += nd
        eps = max(np.float32(d["min_epsilon"]),
                  eps * np.float32(d["epsilon_decay"]) ** np.float32(nd))
    return env, episodes, {k: torch.stack(v) for k, v in stream.items()}, \
        noise, float(eps)


def follow(cfg: dict, pre: dict, post: dict, a_play, device,
           given=None, mode: str = "f32") -> dict:
    """One train iteration from the program's state ``pre``: the chunk and
    its rows from ``pre``, the update from ``pre`` with the rows the
    program pushed (``post``'s replay), in the precisions ``SPLIT[mode]``
    gives. ``given``: the program's update
    block's ``(losses (K,), sampled slots (K, bs))``; each update takes the
    program's slots, so that a sample or a bootstrap argmax that parts on a
    rounding does not carry the rest of the block elsewhere. Returns the
    envs, pushed rows and carry after the chunk, the episode count, each
    update's loss, the slots the reference's own sampler picks, the
    priorities, the parameters and the Adam first moment."""
    d = cfg["dqn"]
    pre, post = to_device(pre, device), to_device(post, device)
    n_step, gamma = d["n_step"], d["gamma"]
    K, bs = d["updates_per_iteration"], d["batch_size"]
    gen = generator_from(pre["generator"])
    roll_mode, update_mode = SPLIT[mode]
    with precision(roll_mode):
        env, episodes, chunk, _, _ = _rollout(cfg, pre, a_play, gen, device)
        c = pre["carry"]
        s = {k: torch.cat([c[k], chunk[k]]) for k in chunk}
        rows = nstep_rows(s["obs"], s["action"], s["reward"], s["next_obs"],
                          s["done"], n_step, gamma)
        if not pre["carry_valid"]:
            rows = rows[(n_step - 1) * d["num_envs"]:]
        carry = {k: v[-(n_step - 1):] if n_step > 1 else v[:0]
                 for k, v in chunk.items()}
        on = noise_draw(gen, d, (K,))
        tg = noise_draw(gen, d, (K,))
        u01 = torch.rand((K, bs), generator=gen).to(device)

    with precision(update_mode):
        b = pre["buffer"]
        buf = {k: (v.clone() if torch.is_tensor(v) else v)
               for k, v in b.items()}
        m = rows.shape[0]
        slot = (b["pos"] + torch.arange(m, device=device)) \
            % b["prios"].shape[0]
        push(buf, post["buffer"]["data"][slot], d["per_alpha"])
        params, target = pre["params"].clone(), pre["target"].clone()
        mu, nu = pre["opt_mu"].clone(), pre["opt_nu"].clone()
        z = atoms(d, device)
        follows = given is not None and tuple(given[1].shape) == (K, bs)
        losses, own = [], []
        count, steps, frame = pre["opt_count"], pre["train_steps"], \
            pre["frame_idx"]
        if buf["size"] >= bs:
            ar = torch.arange(bs, device=device)
            for k in range(K):
                frame += 1
                beta = beta_at(frame, d)
                mine = sample(buf, u01[k])
                own.append(mine)
                idx = given[1][k].to(device).long() if follows else mine
                w = is_weights(buf, idx, beta)
                r = buf["data"][idx]
                obs, nxt = r[:, :OBS], r[:, OBS:2 * OBS]
                act = r[:, 2 * OBS].long()
                ret, disc = r[:, 2 * OBS + 1], r[:, 2 * OBS + 2]
                flat = params.detach().requires_grad_(True)
                lg = logits(from_flat(flat, d), torch.cat([obs, nxt]),
                            noise_at(on, k, device))
                with torch.no_grad():
                    a_star = greedy(q_values(lg[bs:], z))
                    lt = logits(from_flat(target, d), nxt,
                                noise_at(tg, k, device))
                    p_next = torch.softmax(lt[ar, a_star], dim=-1)
                    mproj = project(p_next, ret, disc, d)
                logp = torch.log_softmax(lg[:bs][ar, act], dim=-1)
                row = -(mproj * logp).sum(dim=-1)
                loss = (w * row).mean()
                (g,) = torch.autograd.grad(loss, flat)
                if d["train_heads_only"]:
                    g = g.clone()
                    g[:2 * HID + OBS * HID + HID * HID] = 0.0
                count += 1
                adam(params, g, mu, nu, count, d["lr"], d["adam_eps"])
                write_priorities(buf, idx, row.detach(), d["per_alpha"],
                                 d["per_eps"])
                steps += 1
                if d["target_tau"] > 0.0:
                    target = target + d["target_tau"] * (params - target)
                elif steps % d["target_update_interval"] == 0:
                    target = params.clone()
                losses.append(loss.detach())
    pushed = rows
    return dict(env_state=env._asdict(), pushed=pushed,
                carry=_pack_carry(carry), episodes=pre["episodes"] + episodes,
                losses=torch.stack(losses).double().cpu() if losses
                else torch.zeros((0,)),
                idx=torch.stack(own).cpu() if own else torch.zeros((0,)),
                prios=buf["prios"], params=params, opt_mu=mu)


def _pack_carry(c: dict) -> torch.Tensor:
    """A carry as rows ``(n - 1) * N`` of its fields."""
    n = c["action"].numel()
    return torch.cat([c["obs"].reshape(n, -1), c["next_obs"].reshape(n, -1),
                      c["action"].reshape(n, 1).float(),
                      c["reward"].reshape(n, 1),
                      c["done"].reshape(n, 1).float()], dim=1)


def program_outputs(pre: dict, post: dict, metrics: dict, given,
                    device) -> dict:
    """The program's side of :func:`follow`'s outputs; the rows it pushed
    are read back from its replay at the chunk's slots."""
    post = to_device(post, device)
    buf = post["buffer"]
    n1, n_envs = post["carry"]["action"].shape
    m = int(metrics["env_steps"]) - (0 if pre["carry_valid"] else n1 * n_envs)
    slot = (pre["buffer"]["pos"] + torch.arange(m, device=device)) \
        % buf["prios"].shape[0]
    return dict(env_state=post["env_state"], pushed=buf["data"][slot],
                carry=_pack_carry(post["carry"]), episodes=post["episodes"],
                losses=given[0].double(), idx=given[1], prios=buf["prios"],
                params=post["params"], opt_mu=post["opt_mu"])


def action_gap(cfg: dict, pre: dict, pushed: torch.Tensor,
               carry: torch.Tensor, device) -> float:
    """How far the chunk's actions lie from what the learner in ``pre``
    chooses at the same observations with the same noise: an exploring
    step must take its random action (else 1); a greedy one lies below the
    best Q by that gap over the Q's spread. The worst step's. The chunk's
    steps are the program's: its pushed rows that start in the chunk, then
    its carry after the chunk (:func:`_pack_carry`)."""
    d = cfg["dqn"]
    pre = to_device(pre, device)
    N, T = d["num_envs"], d["rollout_length"]
    n1 = carry.shape[0] // N
    gen = generator_from(pre["generator"])
    noise = noise_draw(gen, d, (T,))
    explore = torch.rand((T, N), generator=gen).to(device)
    random_a = torch.randint(0, 3, (T, N), generator=gen,
                             dtype=torch.int32).to(device)
    steps = torch.cat([pushed[(n1 * N if pre["carry_valid"] else 0):],
                       carry.to(device)]).reshape(T, N, -1)
    p = from_flat(pre["params"], d)
    z = atoms(d, device)
    eps = float(np.float32(pre["epsilon"]))
    gap = 0.0
    with precision("f32"):
        for t in range(T):
            act = steps[t, :, 2 * OBS].long()
            q = q_values(logits(p, steps[t, :, :OBS],
                                noise_at(noise, t, device)), z)
            top = q.max(dim=1).values
            spread = torch.clamp(top - q.min(dim=1).values, min=1e-30)
            g = (top - q.gather(1, act[:, None])[:, 0]) / spread
            g = torch.where(explore[t] < eps,
                            (act != random_a[t].long()).float(), g)
            gap = max(gap, float(g.max()))
    return gap


def gate(cfg: dict, capture: dict, a_play, device, mode: str = "f32"):
    """B's win rate against A in the loop's first gate, replayed from the
    loop generator's state before it: the games' opponent picks, their
    serves, then the games in lockstep, each frozen when it ends, a game
    still running at the cap decided by score."""
    d = cfg["dqn"]
    n = d["selfplay"]["eval_episodes"]
    if d["selfplay"]["swap_sides_eval"]:
        raise ValueError("the reference replays single-seat gates only")
    gen = generator_from(capture["loop_generator"])
    torch.randint(0, 1, (n,), generator=gen, dtype=torch.int32)
    ep = _env_params(cfg)
    z = atoms(d, device)
    pb = from_flat(capture["params"].to(device), d)
    with precision(SPLIT[mode][0]):
        state = E.reset(ep, n, gen, device)
        fin = torch.zeros((n,), dtype=torch.bool, device=device)
        win_b = torch.zeros_like(fin)
        t = 0
        while t < MAX_STEPS and not bool(fin.all()):
            act_a = greedy(q_values(logits(a_play, E.observe_a(state)), z))
            act_b = greedy(q_values(logits(pb, E.observe_b(state)), z))
            new, out = E.step(ep, state, act_a.to(torch.int32),
                              act_b.to(torch.int32))
            win_b = win_b | (out.done & ~fin & (out.reward_b > out.reward_a))
            state = E.EnvState(*(torch.where(fin, old, nw)
                                 for nw, old in zip(new, state)))
            fin = fin | out.done
            t += 1
        win_b = win_b | (~fin & (state.score_b > state.score_a))
    return float(win_b.float().mean())


def compare(steps: List[dict], ref_steps: List[dict], pres: List[dict],
            device, cfg: dict) -> Dict[str, float]:
    """The gaps of the followed iterations, as the QNet's
    (``benchmark/reference/qnet.py::compare``): the rollout's share of
    envs, pushed rows and carried steps that differ (or the episode count's
    relative gap), the worst step's action gap, the share of sampled slots
    where the reference's sampler parts from the program's, the median
    relative gap of the priorities of the touched slots and of the losses,
    the first block's Adam first moment and each block's parameter change
    by the worst (and the median) leaf."""
    d = cfg["dqn"]
    spans = leaf_spans((n, math.prod(s)) for n, s in shapes(d))
    roll, loss, dparam, sample_, prio, dmed = [], [], [], [], [], []
    act = []
    grad = 0.0
    for i, (p, r, pre) in enumerate(zip(steps, ref_steps, pres)):
        act.append(action_gap(cfg, pre, p["pushed"], p["carry"], device))
        roll.append(max(env_mismatch(p["env_state"], r["env_state"]),
                        rows_mismatch(p["pushed"], r["pushed"])
                        if p["pushed"].shape == r["pushed"].shape else 1.0,
                        rows_mismatch(p["carry"], r["carry"]),
                        relative(p["episodes"], r["episodes"])))
        loss.append(median_gap(p["losses"], r["losses"]))
        same = p["idx"].shape == r["idx"].shape
        sample_.append(float((p["idx"].long() != r["idx"].long())
                             .float().mean()) if same else 1.0)
        touched = p["idx"].reshape(-1).long().unique().to(device)
        prio.append(median_gap(p["prios"][touched], r["prios"][touched]))
        x0 = pre["params"].to(device)
        dparam.append(leaf_gap(p["params"] - x0, r["params"] - x0,
                               r["opt_mu"], spans))
        dmed.append(leaf_gap(p["params"] - x0, r["params"] - x0,
                             r["opt_mu"], spans, statistics.median))
        if i == 0:
            grad = leaf_gap(p["opt_mu"], r["opt_mu"], r["opt_mu"], spans)
    return dict(rollout_mismatch=worst(roll), action_gap=worst(act),
                sample_mismatch=worst(sample_),
                prio_gap=worst(prio), loss_gap=worst(loss), grad_gap=grad,
                dparam_gap=worst(dparam), dparam_median_gap=worst(dmed))
