"""PyTorch port: the DRQN learner's autodiff update against
``DRQNLearner._update`` on the CPU for the nets kernel 4 does not take:
two LSTM layers with burn-in, no shared head, a width of 160 (the cases
of ``test_torch_drqn_autodiff.py`` with other nets, in a file of their
own to keep each file short)."""

import pytest

from tests.test_torch_drqn_autodiff import check_update_against_jax

NET_CASES = {
    "two_layers_burn4": dict(lstm_layers=2, burn_in_length=4),
    "no_shared_head": dict(head_hidden_dim=0),
    "width160": dict(lstm_hidden_dim=160, target_update_interval=3),
}


@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_autodiff_update_matches_jax_other_nets(case):
    check_update_against_jax(NET_CASES[case], seed=len(case))
