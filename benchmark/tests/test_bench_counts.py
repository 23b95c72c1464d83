"""The kernels' operation and byte counts and the ``step_mfu`` FLOP count
against hand counts at tiny shapes, and the parameter counts they assume
against the reference's own nets."""

import math

import pytest
import torch

from benchmark.kernels import k1, k2, k3, k4
from benchmark.models import drqn as mdrqn
from benchmark.models import qnet as mqnet
from benchmark.peaks import F32_FLOPS, HBM_BYTES, bound_s
from benchmark.reference.frozen import qnet as Q
from benchmark.reference.frozen import qnet_rnn as QR

TINY_RNN = {"feature_dim": 32, "lstm_hidden_dim": 16, "head_hidden_dim": 16,
            "trace_length": 4, "updates_per_iteration": 2, "batch_size": 8,
            "target_tau": 0.0, "num_envs": 32, "rollout_length": 2,
            "pallas_tile_rows": 16}


def test_k1_by_hand():
    # 16 envs x 2 steps: two nets of 7*64 + 64*64 + 3*64 multiply-adds
    flops, nbytes = k1.cost(16, 2, True)
    assert flops == 2 * 2 * (448 + 4096 + 192) * 32
    # state in and out, statistics out, two packed nets, transitions out
    assert nbytes == 2 * 13 * 4 * 16 + 8 * 4 * 16 + 2 * 5776 * 4 \
        + 17 * 4 * 32
    assert k1.cost(16, 2, False)[1] == nbytes - 17 * 4 * 32


def test_k2_by_hand():
    flops, nbytes = k2.cost(bs=32, K=2, nc=2, heads_only=True)
    per_update = 3 * 32 * 9600 + 2 * 32 * 256 + 2 + 32 * 128 + 12 * 5192
    assert flops == 2 * per_update
    chunks = 2 * (1 - 0.5 ** 64)
    assert nbytes == pytest.approx(
        4 * 64 + 4 * 2 * 260 + 8 * 4 * 5192 + 4 * 2 + 512 * chunks
        + 68 * 64 + 4 * chunks + 8 * 64 + 8)
    full, _ = k2.cost(bs=32, K=2, nc=2, heads_only=False)
    assert full - flops == 2 * 32 * 2 * (256 + 2 * 4096 + 448)


def test_k3_by_hand():
    d = TINY_RNN
    flops, nbytes = k3.cost(d, B=32, T=2, tiles=2, emit=True)
    per_net = 2 * (7 * 16 + 16 * 32 + 48 * 64 + 16 * 16 + 16 * 3) + 160
    assert flops == 2 * per_net * 64 + 3 * (256 + 48) * 2 * 2
    net = 16 * 9 + 16 * 32 + 32 + 48 * 64 + 64 + 256 + 16 + 48 + 3
    assert nbytes == 2 * (13 + 64) * 4 * 32 + 8 * 4 * 32 \
        + 4 * (2 * net + 256 + 64 + 3) + 40 * 64


def test_k4_params_and_noise_match_the_net():
    for d in (TINY_RNN, {"feature_dim": 128, "lstm_hidden_dim": 128,
                         "head_hidden_dim": 128}):
        net = QR.qnet_rnn_init(torch.Generator().manual_seed(0),
                               feature_dim=d["feature_dim"],
                               lstm_hidden_dim=d["lstm_hidden_dim"],
                               lstm_layers=1,
                               head_hidden_dim=d["head_hidden_dim"])
        assert k4.n_params(d) == sum(p.numel() for p in net.parameters())
        noise = QR.qnet_rnn_sample_noise(torch.Generator(), net, batch=(1,))
        assert k4.n_noise(d) == sum(x.numel() for n in noise
                                    for x in (n.eps_w, n.eps_b))


def test_k2_params_match_the_net():
    net = Q.qnet_init(torch.Generator().manual_seed(0))
    assert k2.PARAMS == sum(p.numel() for p in net.parameters())


def test_bound_is_the_larger_time():
    assert bound_s(F32_FLOPS, 0) == 1.0
    assert bound_s(0, HBM_BYTES * 2) == 2.0


def test_step_mfu_flops_by_hand():
    q = {"train_heads_only": True}
    assert mqnet.forward_flops(q) == 2 * (7 * 64 + 64 * 64 + 2 * 64 * 4)
    assert mqnet.row_flops(q) == 3 * mqnet.forward_flops(q) + 2 * 2 * 256
    full = mqnet.row_flops({"train_heads_only": False})
    # the trunk: W2 and its input gradient, W1, and the heads' input gradient
    assert full - mqnet.row_flops(q) == 2 * (2 * 4096 + 448 + 256)
    d = TINY_RNN
    macs = 7 * 16 + 16 * 32 + 48 * 64 + 2 * 16 * 16 + 2 * 16 * 4
    assert mdrqn.forward_flops(d) == 2 * macs
    assert mdrqn.row_flops(d) == 4 * 2 * macs * 5
    assert math.isclose(mdrqn.forward_flops(
        {"feature_dim": 128, "lstm_hidden_dim": 128,
         "head_hidden_dim": 128}),
        2 * (448 + 8192 + 256 * 512 + 2 * 128 * 128 + 2 * 128 * 4))
