"""Kernel 6: Rainbow's categorical projection and cross-entropy, fused.

For each row of an update's batch: the target distribution ``p`` (the
target net's, at the Double-DQN bootstrap action) shifted to
``clamp(G + disc z_j, v_min, v_max)`` and projected onto the support, each
atom's mass split between its floor and ceiling atoms (whole on one atom
when it lands on it); the cross-entropy of the online logits ``x`` of the
row's action against that projection, and its gradient with respect to
``x`` in closed form, ``(w / bs) (softmax(x) - m)`` (the projection sums
to one). Returns ``(row losses (bs,), dlogits (bs, A))``; the batch loss
is ``mean(w loss)`` and the priorities are written from the row losses.

:func:`c51_loss_plain` is the PyTorch version (CPU tensors);
``csrc/c51_loss.cu`` is the kernel, one warp a row (CUDA tensors).
"""

from __future__ import annotations

import ctypes

import torch

from pingpong_tpu_torch.ops.build import (
    CudaKernel,
    check_cuda,
    ptr,
    stream_ptr,
)

MAX_ATOMS = 64


def _dz(n_atoms: int, v_min: float, v_max: float) -> torch.Tensor:
    return torch.tensor((v_max - v_min) / (n_atoms - 1), dtype=torch.float32)


def projection_positions(ret, disc, n_atoms: int, v_min: float,
                         v_max: float) -> torch.Tensor:
    """``(bs, A)``: where each shifted target atom lands on the support's
    grid, ``(clamp(G + disc z_j) - v_min) / dz``."""
    dz = _dz(n_atoms, v_min, v_max).to(ret.device)
    z = torch.arange(n_atoms, dtype=torch.float32, device=ret.device) * dz \
        + v_min
    tz = torch.clamp(ret[:, None] + disc[:, None] * z, v_min, v_max)
    return (tz - v_min) / dz


def c51_loss_plain(logits, p_target, ret, disc, weight, v_min: float,
                   v_max: float):
    """The PyTorch version of kernel 6 (see the module docstring)."""
    bs, n = logits.shape
    pos = projection_positions(ret, disc, n, v_min, v_max)
    i = torch.arange(n, dtype=torch.float32, device=logits.device)
    tri = torch.clamp(1.0 - (pos[:, :, None] - i).abs(), min=0.0)
    m = (p_target[:, :, None] * tri).sum(dim=1)
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    loss = -(m * logp).sum(dim=-1)
    scale = weight * torch.tensor(1.0 / bs, dtype=torch.float32)
    return loss, scale[:, None] * (torch.exp(logp) - m)


_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("c51_loss", "c51_loss_launch",
                    [_i, _i, _f, _f, _f, _f] + [_vp] * 8)


def c51_loss_cuda(logits, p_target, ret, disc, weight, v_min: float,
                  v_max: float):
    """Launch kernel 6; same contract as :func:`c51_loss_plain`."""
    bs, n = logits.shape
    if n > MAX_ATOMS or n < 2:
        raise ValueError(f"kernel 6 takes 2 to {MAX_ATOMS} atoms, got {n}")
    check_cuda("logits", logits, torch.float32, (bs, n))
    check_cuda("p_target", p_target, torch.float32, (bs, n))
    for name, t in (("ret", ret), ("disc", disc), ("weight", weight)):
        check_cuda(name, t, torch.float32, (bs,))
    loss = torch.empty((bs,), dtype=torch.float32, device=logits.device)
    dlogits = torch.empty_like(logits)
    KERNEL.launch(bs, n, v_min, v_max, float(_dz(n, v_min, v_max)),
                  float(torch.tensor(1.0 / bs, dtype=torch.float32)),
                  ptr(logits), ptr(p_target), ptr(ret), ptr(disc),
                  ptr(weight), ptr(loss), ptr(dlogits),
                  stream_ptr(logits.device))
    return loss, dlogits


def c51_loss(logits, p_target, ret, disc, weight, v_min: float,
             v_max: float):
    """Kernel 6 for CUDA tensors, its plain version for CPU tensors."""
    args = [t.contiguous() for t in (logits, p_target, ret, disc, weight)]
    if logits.is_cuda:
        return c51_loss_cuda(*args, v_min, v_max)
    return c51_loss_plain(*args, v_min, v_max)
