"""PyTorch port: the debug utilities (``utils/debug.py``), as
``tests/test_orbax_and_debug.py`` holds the JAX package's:
``checked_env_step`` keeps the JAX call shape ``(error, (state, out))``
and its step equals the plain env step; ``error.throw()`` raises on a
non-finite ball state only; ``assert_finite_tree`` names the bad path;
``profile_trace`` writes a Chrome trace."""

import json
import math

import numpy as np
import pytest
import torch

from pingpong_tpu_torch.config import EnvConfig
from pingpong_tpu_torch.env import pong as tpong
from pingpong_tpu_torch.models.qnet import qnet_init
from pingpong_tpu_torch.utils.debug import (
    NONFINITE_STEP,
    assert_finite_tree,
    checked_env_step,
    profile_trace,
)

PARAMS = tpong.env_params_from_config(EnvConfig())


def state(n=4, seed=0):
    return tpong.reset(PARAMS, n, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("field", ["ball_x", "ball_vx", "ball_vy", "spin"])
def test_checked_env_step_flags_nonfinite(field):
    good = state()
    act = torch.ones((4,), dtype=torch.int32)
    err, (new, out) = checked_env_step(PARAMS, good, act, act)
    err.throw()  # no error
    assert err.get() is None
    want, want_out = tpong.step(PARAMS, good, act, act)
    for a, b in zip(new + out, want + want_out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    bad_value = getattr(good, field).clone()
    bad_value[2] = math.nan if field != "spin" else math.inf
    bad = good._replace(**{field: bad_value})
    err, _ = checked_env_step(PARAMS, bad, act, act)
    assert err.get() == NONFINITE_STEP
    with pytest.raises(FloatingPointError, match=NONFINITE_STEP):
        err.throw()


def test_assert_finite_tree():
    net = qnet_init(torch.Generator().manual_seed(0))
    assert_finite_tree({"a": torch.ones(3), "net": net, "s": state(),
                        "n": [np.ones(2), 3, "x", None]}, "ok")
    with pytest.raises(FloatingPointError, match=r"bad\['a'\]\[1\]"):
        assert_finite_tree({"a": [torch.ones(2),
                                  torch.tensor([1.0, math.inf])]}, "bad")
    with torch.no_grad():
        net.fc_a.w_mu[0, 0] = math.nan
    with pytest.raises(FloatingPointError, match=r"tree\.fc_a\.w_mu"):
        assert_finite_tree(net)
    with pytest.raises(FloatingPointError, match=r"st\.ball_vy"):
        s = state()
        assert_finite_tree(s._replace(ball_vy=s.ball_vy / 0.0 * 0.0), "st")
    with pytest.raises(FloatingPointError, match=r"arr\[0\]"):
        assert_finite_tree((np.array([np.nan]),), "arr")


def test_profile_trace_writes_a_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with profile_trace(str(log_dir)) as prof:
        s = state(64)
        act = torch.ones((64,), dtype=torch.int32)
        tpong.step(PARAMS, s, act, act)
    traces = list(log_dir.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert len(prof.key_averages()) > 0
