"""Fused DRQN actor rollout: a whole recurrent rollout chunk in one CUDA
launch.

Port of ``pingpong_tpu/ops/recurrent_rollout.py::pallas_recurrent_rollout``.
Per env and step: the bound opponent's recurrent forward (mu weights;
player A's mirrored view folded into the first layer by
:func:`pack_qnet_rnn`), the learner's recurrent forward with this step's
factorized noise on the shared and A heads (the V head is argmax-invariant
and skipped), epsilon-greedy, the env step with auto-reset, the zero-reset
of both LSTM streams on ``done``, the emission of obs / action / reward /
done (``next_obs`` is derived by the sequence ring) and the per-env
statistics. Hidden states travel as one ``(4H, B)`` block ``[h_b; c_b;
h_opp; c_opp]``, the JAX function's layout.

Two versions compute the same function:

* :func:`recurrent_rollout_plain`, step by step in PyTorch. It runs for
  tensors on the CPU (the tests hold it against the JAX kernel in
  interpret mode), and ``chip_smoke.py`` holds the kernel against it on
  the card;
* the CUDA kernel ``csrc/recurrent_rollout.cu``, launched for tensors on
  the card. There is no fallback between the two.

The kernel runs blocks of one opponent each: :func:`launch_plan` picks the
envs a block and builds the block table (the env list of every block, on
the card; :func:`block_table` is its plain version), and the nets travel
in the flat layouts of :func:`net_layout` and :func:`sigma_layout`, each
width padded with zero units to a multiple of 4 (:func:`kernel_dims`).

Random draws follow the JAX kernel's interpret path (``_rnn_kernel``):
the counter hash with ``seed_mix = seed ^ (tile * 747796405)``, the tile
global (``tile0`` + the local tile, for a rank's block of a data-parallel
batch), and ``ctr = 16 * step``; the learner noise of a step is one
factorized draw shared by a tile of ``tile_rows`` envs (``_draw_noise``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Union

import torch

from pingpong_tpu_torch.env.pong import EnvParams, EnvState
from pingpong_tpu_torch.models.qnet import argmax3
from pingpong_tpu_torch.models.qnet_rnn import QNetRNN
from pingpong_tpu_torch.ops.actor_rollout import (
    _MIRROR,
    NEG_BIG,
    env_step_plain,
    epsilon_to_int,
    explore_plain,
    hash_noise,
)
from pingpong_tpu_torch.ops.build import (
    CudaKernel,
    check_cuda,
    ptr,
    stream_ptr,
)
from pingpong_tpu_torch.ops.pong_kernel import _M32, EnvConsts, tile_seed_mix
from pingpong_tpu_torch.utils import trace

MAX_WIDTH = 128       # every width the kernel takes
CUDA_ENVS = 8         # the fewest envs a CUDA block takes; tile_rows must be
                      # a multiple
ENVS_CHOICES = (8, 16, 32)   # envs a block the kernel is built for
FLAT_ALIGN = 32       # floats: each section of the kernel's flat layouts
                      # starts on 128 bytes (bulk copies need 16)


class PackedQNetRNN(NamedTuple):
    """Transposed, padded mu weights of one QNetRNN, or a stack of them
    with a leading slot axis: the JAX package's layout. The V head is
    omitted; the LSTM biases are pre-summed (``bgt = b_ih + b_hh``); rows
    3-7 of the A head are padding, their ``bat`` -1e30."""

    w1t: torch.Tensor    # (..., F1, 8)
    b1t: torch.Tensor    # (..., F1, 1)
    w2t: torch.Tensor    # (..., F, F1)
    b2t: torch.Tensor    # (..., F, 1)
    wght: torch.Tensor   # (..., 4H, F+H)  [w_ih | w_hh]
    bgt: torch.Tensor    # (..., 4H, 1)
    wst: torch.Tensor    # (..., HH, H)   shared noisy mu
    bst: torch.Tensor    # (..., HH, 1)
    wat: torch.Tensor    # (..., 8, HH)
    bat: torch.Tensor    # (..., 8, 1)


class RNNSigma(NamedTuple):
    """The learner's noisy sigmas (opponents run mu only)."""

    wst_sigma: torch.Tensor  # (HH, H)
    bst_sigma: torch.Tensor  # (HH, 1)
    wat_sigma: torch.Tensor  # (8, HH)
    bat_sigma: torch.Tensor  # (8, 1)


def _pad_rows(x, rows, fill=0.0):
    out = torch.full((rows,) + tuple(x.shape[1:]), fill, dtype=torch.float32,
                     device=x.device)
    out[:x.shape[0]] = x
    return out


def pack_qnet_rnn(params: Union[QNetRNN, Sequence[QNetRNN]],
                  mirror: bool = False) -> PackedQNetRNN:
    """Pad and transpose one QNetRNN, or stack a sequence of them along a
    new leading slot axis. ``mirror=True`` folds player A's view into the
    first feature layer, so the net consumes player B's observation."""
    if not isinstance(params, QNetRNN):
        packs = [pack_qnet_rnn(p, mirror) for p in params]
        return PackedQNetRNN(*(torch.stack(f) for f in zip(*packs)))
    if len(params.lstm) != 1 or params.shared is None:
        raise ValueError("the recurrent kernel takes lstm_layers=1 with a "
                         "shared head")
    w1t = _pad_rows(params.feat1.w.detach(), 8).T.contiguous()   # (F1, 8)
    b1t = params.feat1.b.detach()[:, None].clone()
    if mirror:
        # w1t @ obs_a == (w1t @ M) @ obs_b + w1t[:, y]
        b1t = b1t + w1t[:, 1:2]
        w1t = w1t @ torch.as_tensor(_MIRROR, device=w1t.device)
    lstm = params.lstm[0]
    return PackedQNetRNN(
        w1t=w1t,
        b1t=b1t,
        w2t=params.feat2.w.detach().T.contiguous(),
        b2t=params.feat2.b.detach()[:, None].clone(),
        wght=torch.cat([lstm.w_ih.detach().T, lstm.w_hh.detach().T], dim=1),
        bgt=(lstm.b_ih.detach() + lstm.b_hh.detach())[:, None],
        wst=params.shared.w_mu.detach().T.contiguous(),
        bst=params.shared.b_mu.detach()[:, None].clone(),
        wat=_pad_rows(params.fc_a.w_mu.detach().T, 8),
        bat=_pad_rows(params.fc_a.b_mu.detach()[:, None], 8, fill=NEG_BIG),
    )


def pack_rnn_sigma(params: QNetRNN) -> RNNSigma:
    return RNNSigma(
        wst_sigma=params.shared.w_sigma.detach().T.contiguous(),
        bst_sigma=params.shared.b_sigma.detach()[:, None].clone(),
        wat_sigma=_pad_rows(params.fc_a.w_sigma.detach().T, 8),
        bat_sigma=_pad_rows(params.fc_a.b_sigma.detach()[:, None], 8),
    )


def supports_kernel(dims) -> bool:
    """Whether the kernel takes these (F1, F, H, HH) widths."""
    return max(dims) <= MAX_WIDTH and min(dims) > 0


def kernel_dims(dims):
    """The widths the kernel runs at: each rounded up to a multiple of 4,
    so a streamed row is a whole number of 16 bytes. The added units have
    zero weights and biases: their features and shared-head outputs are 0,
    their LSTM state stays 0 (c' = 0.5 c + 0.5 tanh 0), and they add
    nothing to any sum, so the result is that of the unpadded net."""
    return tuple(-(-d // 4) * 4 for d in dims)


def packed_dims(p: PackedQNetRNN):
    """(F1, F, H, HH) of a packed net."""
    return (p.w1t.shape[-2], p.w2t.shape[-2], p.wght.shape[-2] // 4,
            p.wst.shape[-2])


def _sections(fields):
    """``{name: (offset, size)}`` and the padded length of sections laid
    end to end, each starting on ``FLAT_ALIGN`` floats."""
    out, off = {}, 0
    for name, size in fields:
        out[name] = (off, size)
        off += -(-size // FLAT_ALIGN) * FLAT_ALIGN
    return out, off


def net_layout(dims):
    """The kernel's flat net (``csrc/recurrent_rollout.cu::Layout``) at the
    kernel's widths (:func:`kernel_dims` of ``dims``): the part it keeps
    resident (w1 (F1, 8), b1, b2, bg (H, 4), bs, wa (3, HH), ba (3)), then
    the part it streams (w2 (F1 in, F out), wg (F+H in, H units, 4 gates),
    ws (H in, HH out)). Returns ``({name: (offset, size)}, length)``; every
    section and the length are multiples of 128 bytes, so slot m of a stack
    starts on 128 bytes too."""
    F1, F, H, HH = kernel_dims(dims)
    return _sections([("w1", F1 * 8), ("b1", F1), ("b2", F), ("bg", 4 * H),
                      ("bs", HH), ("wa", 3 * HH), ("ba", 3), ("w2", F1 * F),
                      ("wg", (F + H) * 4 * H), ("ws", H * HH)])


def sigma_layout(dims):
    """The learner's sigmas in the kernel's layout, at the kernel's widths:
    bs, wa (3, HH), ba (3) resident, ws (H in, HH out) streamed."""
    _, _, H, HH = kernel_dims(dims)
    return _sections([("bs", HH), ("wa", 3 * HH), ("ba", 3), ("ws", H * HH)])


def _cat_flat(layout, lead, fields, device):
    """The sections of ``fields`` in ``layout``'s order, each followed by
    zeros up to its padded length: one ``cat``."""
    zeros = torch.zeros(lead + (FLAT_ALIGN,), dtype=torch.float32,
                        device=device)
    parts = []
    for name, (_, size) in layout.items():
        parts.append(fields[name].reshape(lead + (size,)))
        pad = -size % FLAT_ALIGN
        if pad:
            parts.append(zeros[..., :pad])
    return torch.cat(parts, dim=-1)


def _zero_pad(x, shape):
    """``x`` with its trailing dims zero-padded up to ``shape``."""
    if tuple(x.shape[-len(shape):]) == tuple(shape):
        return x
    out = x.new_zeros(x.shape[:-len(shape)] + tuple(shape))
    out[(...,) + tuple(slice(0, n) for n in x.shape[-len(shape):])] = x
    return out


def rnn_kernel_flat(p: PackedQNetRNN) -> torch.Tensor:
    """``(..., NET)`` contiguous vector per net in the CUDA kernel's layout
    (:func:`net_layout`), each width padded with zero units to the
    kernel's (:func:`kernel_dims`). The gates matrix is stored input-major
    and unit-major, ``wg[k, j, q] = wght[q H + j, k]``, so one 16-byte
    load gives unit j's four gates (i, f, g, o); ``bg`` likewise."""
    F1, F, H, HH = packed_dims(p)
    F1p, Fp, Hp, HHp = dims = kernel_dims((F1, F, H, HH))
    lead = p.w1t.shape[:-2]
    t = lambda x: x.transpose(-1, -2)
    gates = p.wght.reshape(lead + (4, H, F + H))
    gates = torch.cat([_zero_pad(gates[..., :F], (4, Hp, Fp)),
                       _zero_pad(gates[..., F:], (4, Hp, Hp))], dim=-1)
    wg = gates.permute(*range(len(lead)), -1, -2, -3)
    bg = t(_zero_pad(p.bgt[..., 0].reshape(lead + (4, H)), (4, Hp)))
    layout, _ = net_layout(dims)
    return _cat_flat(layout, lead, dict(
        w1=_zero_pad(p.w1t, (F1p, 8)), b1=_zero_pad(p.b1t, (F1p, 1)),
        b2=_zero_pad(p.b2t, (Fp, 1)), bg=bg, bs=_zero_pad(p.bst, (HHp, 1)),
        wa=_zero_pad(p.wat[..., :3, :], (3, HHp)), ba=p.bat[..., :3, :],
        w2=t(_zero_pad(p.w2t, (Fp, F1p))), wg=wg,
        ws=t(_zero_pad(p.wst, (HHp, Hp)))), p.w1t.device)


def sigma_kernel_flat(s: RNNSigma) -> torch.Tensor:
    """The learner's sigmas in the kernel's layout (:func:`sigma_layout`),
    zero-padded to the kernel's widths."""
    HH, H = s.wst_sigma.shape
    _, _, Hp, HHp = dims = kernel_dims((1, 1, H, HH))
    layout, _ = sigma_layout(dims)
    return _cat_flat(layout, (), dict(
        bs=_zero_pad(s.bst_sigma, (HHp, 1)),
        wa=_zero_pad(s.wat_sigma[:3], (3, HHp)), ba=s.bat_sigma[:3],
        ws=_zero_pad(s.wst_sigma, (HHp, Hp)).T), s.wst_sigma.device)


# ---------------------------------------------------------------------------
# Blocks of one opponent: the kernel's env lists
# ---------------------------------------------------------------------------

def segment_counts(opp_idx: torch.Tensor, tile_rows: int,
                   n_slots: int) -> torch.Tensor:
    """``(n_slots, tiles)`` env count of every (member, tile) segment
    (without a host synchronization)."""
    B = opp_idx.shape[0]
    n_tiles = B // tile_rows
    env = torch.arange(B, device=opp_idx.device)
    key = opp_idx.long() * n_tiles + env // tile_rows
    counts = torch.zeros(n_slots * n_tiles, dtype=torch.long,
                         device=opp_idx.device)
    return counts.index_add_(0, key, torch.ones_like(key)).view(
        n_slots, n_tiles)


def member_blocks(counts: torch.Tensor, envs: int):
    """Blocks of each member: every (member, tile) segment cut into blocks
    of at most ``envs`` envs."""
    return ((counts + envs - 1) // envs).sum(dim=1)


def blocks_bound(B: int, tile_rows: int, n_slots: int, envs: int) -> int:
    """The most blocks any binding of ``n_slots`` members can need: a tile
    split among k members needs at most ``tile_rows / envs + k - 1``
    blocks (``envs`` divides the tile)."""
    return B // envs + B // tile_rows * (min(n_slots, tile_rows) - 1)


def block_table(opp_idx: torch.Tensor, tile_rows: int, envs: int,
                counts: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The kernel's env lists, ``(n_rows, 1 + envs)`` i32 on the device of
    ``opp_idx``, without a host synchronization: row = [member, env ids in
    lane order], -1 on an idle lane. Envs go in order of (member, tile,
    index); each (member, tile) segment is cut into blocks of ``envs`` (the
    last one padded with idle lanes), so a block holds one tile and one
    member. ``counts`` is :func:`segment_counts`; the first
    ``member_blocks(counts).sum()`` rows are the blocks, ``n_rows`` at
    least that many (:func:`blocks_bound`)."""
    B = opp_idx.shape[0]
    dev = opp_idx.device
    n_slots, n_tiles = counts.shape
    env = torch.arange(B, device=dev)
    key = opp_idx.long() * n_tiles + env // tile_rows
    order = torch.argsort(key * B + env)
    seg_n = counts.reshape(-1).to(dev)
    seg_blocks = ((seg_n + envs - 1) // envs).view(n_slots, n_tiles)
    blocks = member_blocks(counts.to(dev), envs)
    member_end = torch.cumsum(blocks, 0)
    member_start = member_end - blocks
    seg_block0 = (member_start[:, None] + torch.cumsum(seg_blocks, 1)
                  - seg_blocks).reshape(-1)
    seg_env0 = torch.cumsum(seg_n, 0) - seg_n
    k = key[order]
    rank = env - seg_env0[k]
    table = torch.full((n_rows, 1 + envs), -1, dtype=torch.int32,
                       device=dev)
    table[:, 0] = torch.searchsorted(
        member_end, torch.arange(n_rows, device=dev), right=True)
    table[seg_block0[k] + rank // envs, 1 + rank % envs] = order.to(
        torch.int32)
    return table


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _rnn_advantage(w: PackedQNetRNN, obs7, h, c, heads=None):
    """Recurrent forward of one net on ``(B, ·)`` rows: ``(adv (B, 3), h',
    c')``. ``heads`` replaces the mu shared and A heads with one per tile
    of envs: ``(ws (tiles, HH, H), bs (tiles, HH), wa (tiles, 3, HH),
    ba (tiles, 3))``."""
    H = h.shape[-1]
    f1 = torch.relu(obs7 @ w.w1t[:, :7].T + w.b1t[:, 0])
    f2 = torch.relu(f1 @ w.w2t.T + w.b2t[:, 0])
    gates = torch.cat([f2, h], dim=-1) @ w.wght.T + w.bgt[:, 0]
    gi = torch.sigmoid(gates[:, 0:H])
    gf = torch.sigmoid(gates[:, H:2 * H])
    gg = torch.tanh(gates[:, 2 * H:3 * H])
    go = torch.sigmoid(gates[:, 3 * H:4 * H])
    c_new = gf * c + gi * gg
    h_new = go * torch.tanh(c_new)
    if heads is None:
        s = torch.relu(h_new @ w.wst.T + w.bst[:, 0])
        adv = s @ w.wat[:3].T + w.bat[:3, 0]
    else:
        ws, bs, wa, ba = heads
        n_tiles = ws.shape[0]
        ht = h_new.reshape(n_tiles, -1, H)
        s = torch.relu(ht @ ws.transpose(1, 2) + bs[:, None])
        adv = (s @ wa.transpose(1, 2) + ba[:, None]).reshape(-1, 3)
    return adv, h_new, c_new


def _learner_heads(lw: PackedQNetRNN, sig: RNNSigma, mix_tiles, ctr, dims):
    """Each tile's noisy shared and A head of one step, ``(tiles, ...)``
    (the JAX kernel's ``_draw_noise``)."""
    _, _, H, HH = dims
    dev = mix_tiles.device
    mix = mix_tiles[:, None]
    ein_s = hash_noise(mix, ctr, 10, 11, 0, torch.arange(H, device=dev))
    ein_a = hash_noise(mix, ctr, 10, 11, 1, torch.arange(HH, device=dev))
    eout_s = hash_noise(mix, ctr, 12, 13, torch.arange(HH, device=dev), 0)
    eout_a = hash_noise(mix, ctr, 12, 13, torch.arange(3, device=dev), 1)
    ws = lw.wst + sig.wst_sigma * (eout_s[:, :, None] * ein_s[:, None, :])
    bs = lw.bst[:, 0] + sig.bst_sigma[:, 0] * eout_s
    wa = lw.wat[:3] + sig.wat_sigma[:3] * (eout_a[:, :, None]
                                           * ein_a[:, None, :])
    ba = lw.bat[:3, 0] + sig.bat_sigma[:3, 0] * eout_a
    return ws, bs, wa, ba


def recurrent_rollout_plain(env_params: EnvParams, state: EnvState, opp_idx,
                            ep_return, hid, learner: PackedQNetRNN,
                            sigma: RNNSigma, opponents: PackedQNetRNN, *,
                            seed: int, eps_i: int, steps: int,
                            max_episode_steps: int, tile_rows: int,
                            emit_transitions: bool, tile0: int = 0):
    """Step-by-step version of the kernel. Returns ``(state, ep_return,
    hid (4H, B), transitions or None, stats (8, B))`` with transitions as
    four ``(T, B[, 7])`` tensors ``obs, action, reward, done``."""
    dev = state.ball_x.device
    B = state.ball_x.shape[0]
    dims = packed_dims(learner)
    H = dims[2]
    env = torch.arange(B, device=dev)
    lane = env % tile_rows
    mix_tiles = tile_seed_mix(seed, B // tile_rows, dev, tile0)
    mix_env = mix_tiles[env // tile_rows]
    pool_f = (opp_idx > 0).to(torch.float32)
    members = [int(m) for m in torch.unique(opp_idx).tolist()]
    h_b, c_b, h_o, c_o = (hid[i * H:(i + 1) * H].T for i in range(4))

    st = state
    ret = ep_return
    stats = torch.zeros((8, B), dtype=torch.float32, device=dev)
    tr = {k: [] for k in ("obs", "action", "reward", "done")}
    for s in range(steps):
        ctr = s * 16
        obs7 = torch.stack([st.ball_x, st.ball_y, st.ball_vx, st.ball_vy,
                            st.bottom_paddle_x, st.top_paddle_x, st.spin], -1)
        # the bound opponent: each member present runs over every env and
        # keeps its own envs' results (the TPU kernel's member loop)
        act_a = torch.zeros((B,), dtype=torch.int32, device=dev)
        h_on, c_on = h_o, c_o
        for m in members:
            ow = PackedQNetRNN(*(f[m] for f in opponents))
            adv, h_m, c_m = _rnn_advantage(ow, obs7, h_o, c_o)
            sel = (opp_idx == m)
            act_a = torch.where(sel, argmax3(adv), act_a)
            h_on = torch.where(sel[:, None], h_m, h_on)
            c_on = torch.where(sel[:, None], c_m, c_on)
        ws, bs, wa, ba = _learner_heads(learner, sigma, mix_tiles, ctr, dims)
        adv, h_b, c_b = _rnn_advantage(learner, obs7, h_b, c_b,
                                       (ws, bs, wa, ba))
        act_b = explore_plain(mix_env, lane, ctr, eps_i, argmax3(adv))
        _, reward, done, srow, st, ret = env_step_plain(
            env_params, st, ret, act_a, act_b, mix_env, lane, ctr,
            max_episode_steps, pool_f)
        if emit_transitions:
            tr["obs"].append(obs7)
            tr["action"].append(act_b)
            tr["reward"].append(reward)
            tr["done"].append(done)
        stats += srow
        keep = (~done)[:, None].to(torch.float32)
        h_b, c_b, h_o, c_o = (x * keep for x in (h_b, c_b, h_on, c_on))
    trans = ({k: torch.stack(v) for k, v in tr.items()}
             if emit_transitions else None)
    hid_out = torch.cat([h_b.T, c_b.T, h_o.T, c_o.T], dim=0)
    return st, ret, hid_out, trans, stats


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_vp, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "recurrent_rollout", "recurrent_rollout_launch",
    [ctypes.POINTER(EnvConsts)] + [_vp] * 16 + [_i] * 6 + [ctypes.c_uint]
    + [_i] * 5 + [_vp],
)


class KernelConfig(NamedTuple):
    """The launch shape of the kernel built for one envs-a-block size at
    given widths, as the CUDA runtime reports it for the card."""

    threads: int
    smem: int             # dynamic shared memory bytes a block
    stages: int           # weight-ring stages
    blocks_per_sm: int
    resident: int         # blocks resident at once on the card
    stage_floats: int


_CONFIGS = {}


def kernel_config(envs: int, dims) -> KernelConfig:
    """:class:`KernelConfig` of the kernel built for ``envs`` envs a block
    at the kernel's widths ``dims`` (cached)."""
    key = (envs, tuple(dims))
    if key not in _CONFIGS:
        fn = KERNEL.library_fn("recurrent_rollout_config",
                               [_i] * 5 + [ctypes.POINTER(ctypes.c_int)],
                               ctypes.c_int)
        out = (ctypes.c_int * 6)()
        rc = fn(envs, *dims, out)
        if rc != 0:
            raise RuntimeError(f"recurrent_rollout config ({envs} envs) "
                               f"failed: cudaError {rc}")
        _CONFIGS[key] = KernelConfig(*out)
    return _CONFIGS[key]


def check_tile_rows(tile_rows: int):
    """The kernel's one tile rule: ``tile_rows`` a multiple of
    ``CUDA_ENVS``. Returns the envs-a-block sizes that divide a tile, so a
    tile bound to one member fills its blocks."""
    if tile_rows % CUDA_ENVS:
        raise ValueError(f"tile_rows {tile_rows} must be a multiple of "
                         f"{CUDA_ENVS} on the card")
    return [e for e in ENVS_CHOICES if tile_rows % e == 0]


class LaunchPlan(NamedTuple):
    """How a chunk runs: ``envs`` envs a block, ``grid`` blocks walking the
    block table's rows in turn, and the table itself with ``info`` =
    [least opp_idx, greatest opp_idx, block count] (int32 on the card;
    :func:`plan_counts`)."""

    envs: int
    grid: int
    config: KernelConfig
    table: torch.Tensor
    info: torch.Tensor


def launch_plan(opp_idx: torch.Tensor, tile_rows: int, n_slots: int,
                dims) -> LaunchPlan:
    """Choose the envs a block: the fewest of :func:`check_tile_rows`'s
    whose :func:`blocks_bound` fits the card at once, else the most (the
    blocks then walk several rounds); and build the block table on the
    card (``block_table_kernel``, whose plain version is
    :func:`block_table`). ``dims``: the kernel's widths. The grid covers
    the bound; the kernel reads the exact block count from ``info``. No
    host synchronization."""
    choices = check_tile_rows(tile_rows)
    B, dev = opp_idx.shape[0], opp_idx.device
    for envs in choices:
        cfg = kernel_config(envs, dims)
        bound = blocks_bound(B, tile_rows, n_slots, envs)
        if bound <= cfg.resident:
            break
    if cfg.resident < 1:
        raise RuntimeError(f"recurrent_rollout: a block of {cfg.smem} "
                           f"bytes cannot be resident")
    table = torch.empty((bound, 1 + envs), dtype=torch.int32, device=dev)
    info = torch.empty(3, dtype=torch.int32, device=dev)
    scratch = torch.empty(B + n_slots * (B // tile_rows), dtype=torch.int32,
                          device=dev)
    build = KERNEL.library_fn("recurrent_rollout_table",
                              [_vp] + [_i] * 5 + [_vp] * 4, ctypes.c_int)
    rc = build(ptr(opp_idx), B, tile_rows, n_slots, envs, bound,
               ptr(table), ptr(info), ptr(scratch), stream_ptr(dev))
    if rc != 0:
        raise RuntimeError(f"recurrent_rollout table build failed: "
                           f"cudaError {rc}")
    return LaunchPlan(envs, min(bound, cfg.resident), cfg, table, info)


def plan_counts(plan: LaunchPlan):
    """``(least opp_idx, greatest opp_idx, blocks, rounds)`` of a plan
    (synchronizes)."""
    lo, hi, n_blocks = plan.info.tolist()
    return lo, hi, n_blocks, -(-n_blocks // plan.grid)


def recurrent_rollout_cuda(env_params: EnvParams, state: EnvState, opp_idx,
                           ep_return, hid, learner: PackedQNetRNN,
                           sigma: RNNSigma, opponents: PackedQNetRNN, *,
                           seed: int, eps_i: int, steps: int,
                           max_episode_steps: int, tile_rows: int,
                           emit_transitions: bool, tile0: int = 0,
                           opponents_flat: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel; same contract as
    :func:`recurrent_rollout_plain`. ``opponents_flat``:
    :func:`rnn_kernel_flat` of ``opponents``, for a caller that keeps one
    stack for many chunks (made here when None)."""
    dev = state.ball_x.device
    B = state.ball_x.shape[0]
    dims = packed_dims(learner)
    H = dims[2]
    if not supports_kernel(dims):
        raise ValueError(f"recurrent kernel takes widths <= {MAX_WIDTH}, "
                         f"got {dims}")
    check_tile_rows(tile_rows)
    kdims = kernel_dims(dims)
    Hp = kdims[2]
    lw = rnn_kernel_flat(learner)
    sw = sigma_kernel_flat(sigma)
    ow = (rnn_kernel_flat(opponents) if opponents_flat is None
          else opponents_flat)
    n_slots, net = opponents.w1t.shape[0], net_layout(dims)[1]
    check_cuda("learner", lw, torch.float32, (net,))
    check_cuda("sigma", sw, torch.float32, (sigma_layout(dims)[1],))
    check_cuda("opponents_flat", ow, torch.float32, (n_slots, net))
    check_cuda("opp_idx", opp_idx, torch.int32, (B,))
    check_cuda("hid", hid, torch.float32, (4 * H, B))
    if Hp != H:   # the added units' streams are zero
        hid = _zero_pad(hid.view(4, H, B), (Hp, B)).view(4 * Hp, B)
    f_in = torch.stack([state.ball_x, state.ball_y, state.ball_vx,
                        state.ball_vy, state.bottom_paddle_x,
                        state.top_paddle_x, state.spin, ep_return])
    i_in = torch.stack([state.score_a, state.score_b, state.bounce_count,
                        state.t, opp_idx])
    check_cuda("f_in", f_in, torch.float32, (8, B))
    check_cuda("i_in", i_in, torch.int32, (5, B))
    f_out = torch.empty_like(f_in)
    i_out = torch.empty_like(i_in)
    hid_out = torch.empty_like(hid)
    stats = torch.empty((8, B), dtype=torch.float32, device=dev)
    if emit_transitions:
        obs = torch.empty((steps, B, 7), dtype=torch.float32, device=dev)
        act = torch.empty((steps, B), dtype=torch.int32, device=dev)
        rew = torch.empty((steps, B), dtype=torch.float32, device=dev)
        dn = torch.empty((steps, B), dtype=torch.int32, device=dev)
        tr_ptrs = [ptr(t) for t in (obs, act, rew, dn)]
    else:
        tr_ptrs = [None] * 4
    consts = EnvConsts.build(env_params, max_episode_steps)
    plan = launch_plan(opp_idx, tile_rows, n_slots, kdims)
    # the table's members are clamped into the stack, so the chunk reads no
    # weights outside it; the range check waits for the table's counts only
    info = torch.empty(3, dtype=torch.int32, pin_memory=True)
    info.copy_(plan.info, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(dev))
    KERNEL.launch(ctypes.byref(consts), ptr(f_in), ptr(i_in), ptr(hid),
                  ptr(lw), ptr(sw), ptr(ow), ptr(f_out), ptr(i_out),
                  ptr(hid_out), *tr_ptrs, ptr(stats), ptr(plan.table),
                  ptr(plan.info), plan.envs, plan.grid, B, steps, tile_rows,
                  tile0, seed & _M32, eps_i, *kdims, stream_ptr(dev))
    trace.readback(copied, torch.cuda.Event.synchronize)
    lo, hi, _ = info.tolist()
    if lo < 0 or hi >= n_slots:
        raise ValueError(f"opp_idx outside [0, {n_slots})")
    if Hp != H:
        hid_out = hid_out.view(4, Hp, B)[:, :H].reshape(4 * H, B)
    new_state = EnvState(
        ball_x=f_out[0], ball_y=f_out[1], ball_vx=f_out[2], ball_vy=f_out[3],
        bottom_paddle_x=f_out[4], top_paddle_x=f_out[5], spin=f_out[6],
        score_a=i_out[0], score_b=i_out[1], bounce_count=i_out[2],
        t=i_out[3], done=torch.zeros((B,), dtype=torch.bool, device=dev),
    )
    trans = None
    if emit_transitions:
        trans = {"obs": obs, "action": act, "reward": rew, "done": dn.bool()}
    return new_state, f_out[7], hid_out, trans, stats


def recurrent_rollout(env_params: EnvParams, state: EnvState, opp_idx,
                      ep_return, hid, learner: PackedQNetRNN,
                      sigma: RNNSigma, opponents: PackedQNetRNN, *,
                      seed: int, epsilon: float, steps: int,
                      max_episode_steps: int = 0, tile_rows: int = 512,
                      tile0: int = 0, emit_transitions: bool = True,
                      opponents_flat: Optional[torch.Tensor] = None):
    """One recurrent rollout chunk. ``state`` is batched ``(B,)``,
    ``opp_idx (B,)`` i32 binds each env to a slot of the stacked
    ``opponents`` (fixed for the chunk; callers bucket envs by slot and
    zero the opponent stream of re-bound envs), ``hid (4H, B)`` carries
    ``[h_b; c_b; h_opp; c_opp]``, ``learner`` is one unmirrored net with
    its ``sigma``, ``opponents`` mirror-folded; ``opponents_flat``, for
    CUDA tensors, is :func:`rnn_kernel_flat` of ``opponents`` made once by
    a caller that keeps the stack for many chunks (else made per call).
    ``tile0`` is the global index of the first tile, which keys the hash
    (a rank's block of a data-parallel batch; 0 for a whole batch).

    Runs the CUDA kernel for CUDA tensors and the plain version for CPU
    tensors. Returns ``(state, opp_idx, ep_return, hid, transitions,
    stat_counts, ret_sum, ended)`` as the JAX function does:
    transitions a dict of ``(T, B[, 7])`` tensors ``obs, action, reward,
    done`` (None when ``emit_transitions`` is False), ``stat_counts`` i32
    ``[games_vs_a, wins_vs_a, games_vs_pool, wins_vs_pool, draws]``,
    ``ended (B,)`` bool = finished at least one episode in the chunk."""
    B = state.ball_x.shape[0]
    if B % tile_rows:
        raise ValueError(f"batch {B} must be a multiple of {tile_rows}")
    kw = dict(seed=int(seed), eps_i=epsilon_to_int(epsilon), steps=steps,
              max_episode_steps=int(max_episode_steps), tile_rows=tile_rows,
              tile0=int(tile0), emit_transitions=emit_transitions)
    if state.ball_x.is_cuda:
        kw["opponents_flat"] = opponents_flat
        run = recurrent_rollout_cuda
    else:
        run = recurrent_rollout_plain
    new_state, ret, hid_out, trans, stats = run(
        env_params, state, opp_idx, ep_return, hid, learner, sigma,
        opponents, **kw)
    totals = stats.sum(dim=1)
    stat_counts = totals[[0, 1, 2, 3, 6]].to(torch.int32)
    return (new_state, opp_idx, ret, hid_out, trans, stat_counts, totals[4],
            stats[5] > 0.0)
