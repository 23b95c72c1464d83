"""QNet <-> plain dict / numpy conversion (port of the QNet part of
``pingpong_tpu/checkpoint/serialize.py``).

The dict schema is the JAX package's: ``{"kind": "qnet", "feat1": {"w",
"b"}, "feat2": {...}, "fc_v": {"w_mu", "w_sigma", "b_mu", "b_sigma"},
"fc_a": {...}}`` with ``(in, out)`` weights. Optimizer state is the list
``[count, mu, nu]`` of flat Adam over the raveled parameter vector, which
is what the JAX learner writes.
"""

from __future__ import annotations

import numpy as np
import torch

from pingpong_tpu_torch.models.noisy import Dense, NoisyLinear
from pingpong_tpu_torch.models.qnet import QNet

_DENSE = ("w", "b")
_NOISY = ("w_mu", "w_sigma", "b_mu", "b_sigma")
_LAYERS = (("feat1", _DENSE), ("feat2", _DENSE), ("fc_v", _NOISY),
           ("fc_a", _NOISY))


def _get(node, key):
    return node[key] if isinstance(node, dict) else getattr(node, key)


def qnet_to_numpy(params: QNet) -> dict:
    """Nested dict of float32 numpy arrays (the JAX ``QNetParams``
    layout, without the ``kind`` tag)."""
    return {
        name: {f: getattr(params, name).get_parameter(f).detach().cpu()
               .numpy().astype(np.float32) for f in fields}
        for name, fields in _LAYERS
    }


def qnet_from_numpy(d, device="cpu") -> QNet:
    """A QNet from the JAX layout as numpy arrays: a nested dict (as
    :func:`qnet_to_numpy` or a checkpoint gives) or a ``QNetParams``
    whose leaves are numpy arrays."""

    def t(x):
        return torch.tensor(np.asarray(x, np.float32)).to(device)

    layers = {}
    for name, fields in _LAYERS:
        sub = _get(d, name)
        cls = Dense if fields == _DENSE else NoisyLinear
        layers[name] = cls(*(t(_get(sub, f)) for f in fields))
    return QNet(**layers)


def qnet_to_dict(params: QNet) -> dict:
    return {"kind": "qnet", **qnet_to_numpy(params)}


def qnet_from_dict(d: dict, device="cpu") -> QNet:
    return qnet_from_numpy(d, device)


def params_from_dict(d: dict, device="cpu") -> QNet:
    kind = d.get("kind", "qnet")
    if kind != "qnet":
        raise ValueError(f"params kind {kind!r} is not supported by the "
                         "PyTorch port yet (only 'qnet')")
    return qnet_from_dict(d, device)


def opt_state_to_leaves(count: int, mu: torch.Tensor, nu: torch.Tensor):
    """Adam state -> ``[count, mu, nu]`` numpy leaves (optax order)."""
    return [np.asarray(count, np.int32), mu.detach().cpu().numpy(),
            nu.detach().cpu().numpy()]
