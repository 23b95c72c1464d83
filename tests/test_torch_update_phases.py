"""CPU tests of ``update_phases dqn``'s tooling: the instrumented copy of
kernel 2 and the inputs of its shapes. The kernel itself runs only on the
card (``tests/test_torch_cuda.py``)."""

import re
from pathlib import Path

import pytest
import torch

from pingpong_tpu_torch import update_phases as up
from pingpong_tpu_torch.ops.dqn_update import FEATURES_END, dqn_update_plain

DQN_SRC = (Path(up.__file__).resolve().parent / "csrc" /
           "dqn_update.cu").read_text()
TAG = re.compile(r"//\s*phase:\s*(.+?)\s*$")


def test_dqn_instrumented_copy_stamps_every_phase_tag():
    tags = [m.group(1) for line in DQN_SRC.splitlines()
            if (m := TAG.search(line))]
    text, names = up.instrument_dqn(DQN_SRC)
    assert list(names.values()) == tags
    assert {"update start", "B4 wait", "owner step", "push"} <= set(tags)
    lines = text.splitlines()
    for site in names:
        at = lines.index(f"STAMP({site});")
        assert TAG.search(lines[at - 1]).group(1) == names[site]
    assert sum(line.startswith("STAMP(") for line in lines) == len(tags)
    assert "st_read" in text


@pytest.mark.parametrize("heads_only,interval,syncs", [
    (True, 1000, []), (False, 200, [199])])
def test_dqn_phase_inputs(heads_only, interval, syncs):
    """The default block (K 64, heads only, no sync) and
    ``qnet.replay_heavy``'s (K 256, full net) with one hard sync inside,
    at a small capacity; the plain block trains the trunk only in the
    full net, and the target equals the parameters right after the sync."""
    K = 64 if heads_only else 256
    kw = up.inputs_dqn("cpu", K=K, cap=128 * 128, heads_only=heads_only,
                       interval=interval)
    assert kw["u01"].shape == (K, 256) and kw["noise"].shape == (K, 260)
    assert kw["data"].shape == (128, 16, 128) and kw["size"] == 128 * 128
    assert [k for k in range(K)
            if (kw["ts0"] + k + 1) % kw["interval"] == 0] == syncs
    run = up.fresh(kw)
    _, _, losses = dqn_update_plain(**run)
    assert bool(torch.isfinite(losses).all())
    trunk = slice(0, FEATURES_END)
    assert torch.equal(run["params"][trunk], kw["params"][trunk]) == \
        heads_only
    for k in syncs:
        part = {**up.fresh(kw), "K": k + 1, "u01": kw["u01"][:k + 1],
                "noise": kw["noise"][:k + 1]}
        dqn_update_plain(**part)
        assert torch.equal(part["target"], part["params"])
        assert not torch.equal(part["target"], kw["target"])
