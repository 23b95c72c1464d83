"""QNet / QNetRNN <-> plain dict / numpy conversion (port of
``pingpong_tpu/checkpoint/serialize.py``).

The dict schemas are the JAX package's: ``{"kind": "qnet", "feat1": {"w",
"b"}, "feat2": {...}, "fc_v": {"w_mu", "w_sigma", "b_mu", "b_sigma"},
"fc_a": {...}}`` with ``(in, out)`` weights, and for ``"qnet_rnn"`` the
same plus ``"lstm": [{"w_ih", "w_hh", "b_ih", "b_hh"}, ...]`` and
``"shared"`` (a noisy layer, or None). Optimizer state is the list
``[count, mu, nu]`` of flat Adam over the raveled parameter vector, which
is what the JAX learner writes.
"""

from __future__ import annotations

import numpy as np
import torch

from pingpong_tpu_torch.models.noisy import Dense, NoisyLinear
from pingpong_tpu_torch.models.qnet import QNet
from pingpong_tpu_torch.models.qnet_rnn import LSTMLayer, QNetRNN

_DENSE = ("w", "b")
_NOISY = ("w_mu", "w_sigma", "b_mu", "b_sigma")
_LSTM = ("w_ih", "w_hh", "b_ih", "b_hh")
_LAYERS = (("feat1", _DENSE), ("feat2", _DENSE), ("fc_v", _NOISY),
           ("fc_a", _NOISY))


def _tensor(x, device) -> torch.Tensor:
    """A row-major float32 copy of ``x`` on ``device``. An ``.npz`` keeps
    an array's memory order, and the importers write transposed (Fortran
    order) weights: a strided parameter would make cuBLAS sum a forward
    in another order than the same weights in row-major order."""
    return torch.tensor(np.ascontiguousarray(x, np.float32)).to(device)


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
    layers = {}
    for name, fields in _LAYERS:
        sub = _get(d, name)
        cls = Dense if fields == _DENSE else NoisyLinear
        layers[name] = cls(*(_tensor(_get(sub, f), device) for f in fields))
    return QNet(**layers)


def qnet_to_dict(params: QNet) -> dict:
    return {"kind": "qnet", **qnet_to_numpy(params)}


def qnet_from_dict(d: dict, device="cpu") -> QNet:
    return qnet_from_numpy(d, device)


def _np(p) -> np.ndarray:
    return p.detach().cpu().numpy().astype(np.float32)


def _layer_to_numpy(layer, fields) -> dict:
    return {f: _np(layer.get_parameter(f)) for f in fields}


def qnet_rnn_to_numpy(params: QNetRNN) -> dict:
    """Nested dict of float32 numpy arrays in the JAX ``QNetRNNParams``
    layout (without the ``kind`` tag)."""
    shared = params.shared
    return {
        "feat1": _layer_to_numpy(params.feat1, _DENSE),
        "feat2": _layer_to_numpy(params.feat2, _DENSE),
        "lstm": [_layer_to_numpy(l, _LSTM) for l in params.lstm],
        "shared": (_layer_to_numpy(shared, _NOISY) if shared is not None
                   else None),
        "fc_v": _layer_to_numpy(params.fc_v, _NOISY),
        "fc_a": _layer_to_numpy(params.fc_a, _NOISY),
    }


def qnet_rnn_from_numpy(d, device="cpu") -> QNetRNN:
    """A QNetRNN from the JAX layout as numpy arrays: a nested dict (as
    :func:`qnet_rnn_to_numpy` or a checkpoint gives) or a
    ``QNetRNNParams`` whose leaves are numpy arrays."""
    def layer(cls, sub, fields):
        return cls(*(_tensor(_get(sub, f), device) for f in fields))

    shared = _get(d, "shared")
    return QNetRNN(
        feat1=layer(Dense, _get(d, "feat1"), _DENSE),
        feat2=layer(Dense, _get(d, "feat2"), _DENSE),
        lstm=[layer(LSTMLayer, l, _LSTM) for l in _get(d, "lstm")],
        shared=(layer(NoisyLinear, shared, _NOISY) if shared is not None
                else None),
        fc_v=layer(NoisyLinear, _get(d, "fc_v"), _NOISY),
        fc_a=layer(NoisyLinear, _get(d, "fc_a"), _NOISY),
    )


def qnet_rnn_to_dict(params: QNetRNN) -> dict:
    return {"kind": "qnet_rnn", **qnet_rnn_to_numpy(params)}


def qnet_rnn_from_dict(d: dict, device="cpu") -> QNetRNN:
    return qnet_rnn_from_numpy(d, device)


def params_from_dict(d: dict, device="cpu"):
    """A QNet or a QNetRNN, by the dict's ``kind`` tag."""
    kind = d.get("kind", "qnet")
    if kind == "qnet":
        return qnet_from_dict(d, device)
    if kind == "qnet_rnn":
        return qnet_rnn_from_dict(d, device)
    raise ValueError(f"unknown params kind {kind!r}")


def opt_state_to_leaves(count: int, mu: torch.Tensor, nu: torch.Tensor):
    """Adam state -> ``[count, mu, nu]`` numpy leaves (optax order)."""
    return [np.asarray(count, np.int32), mu.detach().cpu().numpy(),
            nu.detach().cpu().numpy()]
