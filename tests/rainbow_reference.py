"""Plain reference of Rainbow's learner for the port's CPU tests: the net's
forward, the n-step fold, the categorical projection, the loss and its
gradient, and one Adam step, in plain ``torch`` float32. It imports
nothing of the port, of the JAX package or of any kernel, and is written
from the paper (Hessel et al. 2018, arXiv:1710.02298), not from the port.

Departures from the paper, all of them the port's configuration's:

* the QNet's 7 -> 64 -> 64 trunk in place of the Atari conv torso;
* the target net draws its own noise (the paper leaves the target's noise
  unspecified); the online net draws one noise for ``s_t`` and ``s_t+n``;
* the priority is ``(loss + per_eps)^omega`` with the loss the row's
  cross-entropy (the paper: the KL divergence, the same up to the target's
  entropy, which the projection fixes);
* parameters are ``(in, out)`` matrices and live in one flat vector in the
  order feat1, feat2, v1, v2, a1, a2 (w_mu, w_sigma, b_mu, b_sigma each).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OBS, HID, N_ACT = 7, 64, 3
NOISY = ("v1", "v2", "a1", "a2")


def shapes(n_atoms: int, stream: int) -> List[Tuple[str, tuple]]:
    """``(name, shape)`` of every parameter, in the flat order."""
    out = [("feat1.w", (OBS, HID)), ("feat1.b", (HID,)),
           ("feat2.w", (HID, HID)), ("feat2.b", (HID,))]
    for name, (i, o) in zip(NOISY, [(HID, stream), (stream, n_atoms),
                                    (HID, stream),
                                    (stream, N_ACT * n_atoms)]):
        out += [(f"{name}.w_mu", (i, o)), (f"{name}.w_sigma", (i, o)),
                (f"{name}.b_mu", (o,)), (f"{name}.b_sigma", (o,))]
    return out


def unflatten(flat: torch.Tensor, n_atoms: int,
              stream: int) -> Dict[str, torch.Tensor]:
    out, i = {}, 0
    for name, shape in shapes(n_atoms, stream):
        k = math.prod(shape)
        out[name] = flat[i:i + k].view(shape)
        i += k
    return out


def noise(gen: torch.Generator, n_atoms: int, stream: int):
    """One factorised draw a noisy layer: ``(ein, eout)`` with ``f(x) =
    sign(x) sqrt|x|`` of standard normals, ``in`` then ``out``."""
    f = lambda x: torch.sign(x) * torch.sqrt(torch.abs(x))   # noqa: E731
    out = {}
    for name, (i, o) in zip(NOISY, [(HID, stream), (stream, n_atoms),
                                    (HID, stream),
                                    (stream, N_ACT * n_atoms)]):
        out[name] = (f(torch.randn((i,), generator=gen)),
                     f(torch.randn((o,), generator=gen)))
    return out


def logits(p: Dict[str, torch.Tensor], x: torch.Tensor, eps=None):
    """Atom logits ``(B, 3, A)``: ``v + a - mean_a a`` per atom; ``eps``
    the noise (None: mu weights only)."""
    def noisy(name, h):
        w, b = p[name + ".w_mu"], p[name + ".b_mu"]
        if eps is not None:
            ein, eout = eps[name]
            w = w + p[name + ".w_sigma"] * torch.outer(ein, eout)
            b = b + p[name + ".b_sigma"] * eout
        return h @ w + b

    h = torch.relu(x @ p["feat1.w"] + p["feat1.b"])
    h = torch.relu(h @ p["feat2.w"] + p["feat2.b"])
    v = noisy("v2", torch.relu(noisy("v1", h)))
    a = noisy("a2", torch.relu(noisy("a1", h))).reshape(x.shape[0], N_ACT, -1)
    return v[:, None, :] + a - a.mean(dim=1, keepdim=True)


def support(n_atoms: int, v_min: float, v_max: float) -> torch.Tensor:
    dz = float(np.float32((v_max - v_min) / (n_atoms - 1)))
    return torch.arange(n_atoms, dtype=torch.float32) * dz + v_min


def q_values(lg: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return (torch.softmax(lg, dim=-1) * z).sum(dim=-1)


def greedy(q: torch.Tensor) -> torch.Tensor:
    """Argmax over the actions, ties to the lowest index."""
    best = torch.zeros(q.shape[0], dtype=torch.int64)
    for a in range(1, q.shape[1]):
        best = torch.where(q[:, a] > q[torch.arange(q.shape[0]), best], a,
                           best)
    return best


def nstep_env(rewards: List[float], dones: List[bool], next_obs: List,
              t: int, n: int, gamma: float):
    """One env's n-step row from step ``t`` of its stream, by a loop:
    ``(G, index of the bootstrap observation, discount)``."""
    g, k_last = np.float32(0.0), t
    for k in range(n):
        g = np.float32(g + np.float32(gamma ** k) * np.float32(
            rewards[t + k]))
        k_last = t + k
        if dones[t + k]:
            return g, k_last, np.float32(0.0)
    return g, k_last, np.float32(gamma ** n)


def project(p_next: torch.Tensor, ret: torch.Tensor, disc: torch.Tensor,
            n_atoms: int, v_min: float, v_max: float) -> torch.Tensor:
    """The target ``p_next (bs, A)`` moved to ``clamp(ret + disc z)`` and
    projected: each atom's mass split between its floor and ceiling atoms
    by distance, whole on an atom it lands on exactly."""
    z = support(n_atoms, v_min, v_max)
    dz = float(np.float32((v_max - v_min) / (n_atoms - 1)))
    b = (torch.clamp(ret[:, None] + disc[:, None] * z, v_min, v_max)
         - v_min) / dz
    lo, hi = b.floor().long(), b.ceil().long()
    m = torch.zeros_like(p_next)
    m.scatter_add_(1, lo, p_next * (hi.float() - b))
    m.scatter_add_(1, hi, p_next * (b - lo.float()))
    m.scatter_add_(1, lo, p_next * (lo == hi).float())
    return m


def c51_loss_and_grad(x: torch.Tensor, m: torch.Tensor, w: torch.Tensor):
    """Row cross-entropies ``-sum m log softmax(x)`` and the gradient of
    their importance-weighted mean with respect to ``x``, by autograd."""
    x = x.detach().requires_grad_(True)
    rows = -(m * torch.log_softmax(x, dim=-1)).sum(dim=-1)
    (g,) = torch.autograd.grad((w * rows).mean(), x)
    return rows.detach(), g


def update(flat: torch.Tensor, target: torch.Tensor, batch: dict,
           w: torch.Tensor, eps_online, eps_target, n_atoms: int,
           stream: int, v_min: float, v_max: float):
    """One distributional Double-DQN step's loss, row losses and gradient
    with respect to the flat parameters (autograd end to end)."""
    z = support(n_atoms, v_min, v_max)
    bs = batch["obs"].shape[0]
    ar = torch.arange(bs)
    flat = flat.detach().requires_grad_(True)
    lg = logits(unflatten(flat, n_atoms, stream),
                torch.cat([batch["obs"], batch["next_obs"]]), eps_online)
    with torch.no_grad():
        a_star = greedy(q_values(lg[bs:], z))
        lt = logits(unflatten(target, n_atoms, stream), batch["next_obs"],
                    eps_target)
        m = project(torch.softmax(lt[ar, a_star], dim=-1), batch["ret"],
                    batch["disc"], n_atoms, v_min, v_max)
    rows = -(m * torch.log_softmax(lg[:bs][ar, batch["action"]], dim=-1)
             ).sum(dim=-1)
    loss = (w * rows).mean()
    (g,) = torch.autograd.grad(loss, flat)
    return loss.detach(), rows.detach(), g


def adam_step(params: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, step: int, lr: float,
              eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adam (b1 0.9, b2 0.999, bias-corrected, ``eps`` outside the root);
    returns new ``(params, m, v)``."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    mh = m / (1.0 - 0.9 ** step)
    vh = v / (1.0 - 0.999 ** step)
    return params - lr * mh / (torch.sqrt(vh) + eps), m, v


def priorities(rows: torch.Tensor, alpha: float,
               per_eps: float) -> torch.Tensor:
    """The replay's sampling weights of the sampled rows, ``(loss +
    eps)^alpha``."""
    return (rows + per_eps) ** alpha

