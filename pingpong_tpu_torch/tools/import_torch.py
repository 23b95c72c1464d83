"""Import reference torch checkpoints (.pth) into the native format (port
of ``pingpong_tpu/tools/import_torch.py``; the converters are the same,
so for one ``.pth`` both packages write equal checkpoints).

Migration path for users of the reference
(``MaxChen228/pingpong-selfplay-ai``): converts every checkpoint schema the
reference's "universal loader" understands
(``tests/test_round_robin.py:117-187`` of the reference) into this
framework's typed checkpoint store, so existing agents drop straight into
tournaments, pools, and warm starts here.

Handled schemas:

* wrapper key chains ``modelB_state -> modelA_state -> modelB -> modelA ->
  model -> state_dict`` and bare flat state dicts;
* **legacy flat QNet** (``fc.0/fc.2/fc.4``) — migrated exactly like the
  reference does (test_round_robin.py:136-168): ``fc.0/fc.2`` become the
  feature trunk, the 3-way output layer ``fc.4`` becomes the advantage
  head's mu weights and its row-mean becomes the value head's mu, so the
  migrated dueling net computes *identically* ``Q = V + (A - mean A) =
  fc4(x)`` — verified by a torch-forward equality test. Sigma parameters
  are fresh-initialized at ``sigma_init`` (the legacy net had no noise);
* **dueling NoisyNet QNet** (``features.* / fc_V.* / fc_A.*``);
* **QNetRNN** (``features_extractor.* / lstm.* / fc_shared_head.* /
  fc_V / fc_A``), architecture inferred from tensor shapes (feature dim,
  LSTM hidden/layers, optional shared head).

torch tensors store linear weights as ``(out, in)``; the checkpoint
schema keeps ``(in, out)`` (plain ``x @ w``, the JAX layout) — everything
transposes on the way in. Noise buffers (``weight_epsilon``) are
dropped: noise here is drawn from an explicit generator, not checkpoint
state.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from pingpong_tpu_torch.checkpoint.store import save_checkpoint

SIGMA_INIT = 0.017

_WRAPPER_CHAIN = (
    "modelB_state", "modelA_state", "modelB", "modelA", "model", "state_dict"
)


def _to_np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _resolve_state_dicts(ckpt: Dict) -> Dict[str, Dict]:
    """Extract {role: state_dict} from a wrapper checkpoint (or treat the
    whole dict as one flat state dict)."""
    out = {}
    for key, role in (
        ("modelB_state", "b"), ("modelB", "b"),
        ("modelA_state", "a"), ("modelA", "a"),
        ("model", "b"), ("state_dict", "b"),
    ):
        if key in ckpt and role not in out and isinstance(ckpt[key], dict):
            out[role] = ckpt[key]
    if not out:
        # flat state dict? (keys look like layer names)
        if any(k.startswith(("fc", "features", "lstm")) for k in ckpt):
            out["b"] = ckpt
    return out


def _is_rnn(sd: Dict) -> bool:
    return any(k.startswith("lstm.") for k in sd)


def _noisy_from(sd: Dict, prefix: str) -> Dict:
    return {
        "w_mu": _to_np(sd[f"{prefix}.weight_mu"]).T,
        "w_sigma": _to_np(sd[f"{prefix}.weight_sigma"]).T,
        "b_mu": _to_np(sd[f"{prefix}.bias_mu"]),
        "b_sigma": _to_np(sd[f"{prefix}.bias_sigma"]),
    }


def _fresh_noisy(w_mu: np.ndarray, b_mu: np.ndarray) -> Dict:
    return {
        "w_mu": w_mu.astype(np.float32),
        "w_sigma": np.full_like(w_mu, SIGMA_INIT, dtype=np.float32),
        "b_mu": b_mu.astype(np.float32),
        "b_sigma": np.full_like(b_mu, SIGMA_INIT, dtype=np.float32),
    }


def convert_qnet_state(sd: Dict) -> Dict:
    """torch QNet state dict (legacy flat or dueling NoisyNet) -> params dict."""
    if "fc.0.weight" in sd:
        # legacy flat MLP: fc.0 -> feat1, fc.2 -> feat2, fc.4 -> dueling
        # split (ref test_round_robin.py:150-168)
        w4 = _to_np(sd["fc.4.weight"])          # (3, 64)
        b4 = _to_np(sd["fc.4.bias"])            # (3,)
        return {
            "kind": "qnet",
            "feat1": {"w": _to_np(sd["fc.0.weight"]).T,
                      "b": _to_np(sd["fc.0.bias"])},
            "feat2": {"w": _to_np(sd["fc.2.weight"]).T,
                      "b": _to_np(sd["fc.2.bias"])},
            "fc_a": _fresh_noisy(w4.T, b4),
            "fc_v": _fresh_noisy(
                w4.mean(axis=0, keepdims=True).T,   # (64, 1)
                b4.mean(keepdims=True),             # (1,)
            ),
        }
    if "features.0.weight" in sd:
        return {
            "kind": "qnet",
            "feat1": {"w": _to_np(sd["features.0.weight"]).T,
                      "b": _to_np(sd["features.0.bias"])},
            "feat2": {"w": _to_np(sd["features.2.weight"]).T,
                      "b": _to_np(sd["features.2.bias"])},
            "fc_v": _noisy_from(sd, "fc_V"),
            "fc_a": _noisy_from(sd, "fc_A"),
        }
    raise ValueError(f"unrecognized QNet schema: {sorted(sd)[:6]}...")


def convert_qnet_rnn_state(sd: Dict) -> Dict:
    layers = 0
    while f"lstm.weight_ih_l{layers}" in sd:
        layers += 1
    lstm = [
        {
            "w_ih": _to_np(sd[f"lstm.weight_ih_l{l}"]).T,
            "w_hh": _to_np(sd[f"lstm.weight_hh_l{l}"]).T,
            "b_ih": _to_np(sd[f"lstm.bias_ih_l{l}"]),
            "b_hh": _to_np(sd[f"lstm.bias_hh_l{l}"]),
        }
        for l in range(layers)
    ]
    shared = (
        _noisy_from(sd, "fc_shared_head.0")
        if "fc_shared_head.0.weight_mu" in sd
        else None
    )
    return {
        "kind": "qnet_rnn",
        "feat1": {"w": _to_np(sd["features_extractor.0.weight"]).T,
                  "b": _to_np(sd["features_extractor.0.bias"])},
        "feat2": {"w": _to_np(sd["features_extractor.2.weight"]).T,
                  "b": _to_np(sd["features_extractor.2.bias"])},
        "lstm": lstm,
        "shared": shared,
        "fc_v": _noisy_from(sd, "fc_V"),
        "fc_a": _noisy_from(sd, "fc_A"),
    }


def convert_state_dict(sd: Dict) -> Dict:
    return convert_qnet_rnn_state(sd) if _is_rnn(sd) else convert_qnet_state(sd)


def import_torch_checkpoint(src: str, dst: str) -> Path:
    """Convert one ``.pth`` file to a native checkpoint directory."""
    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{src}: unsupported checkpoint object {type(ckpt)}")
    roles = _resolve_state_dicts(ckpt)
    if not roles:
        raise ValueError(f"{src}: no state dict found under {_WRAPPER_CHAIN}")
    payload = {
        "imported_from": str(src),
        "model_kind": ("qnet_rnn" if _is_rnn(next(iter(roles.values())))
                       else "qnet"),
    }
    if "b" in roles:
        payload["params_b"] = convert_state_dict(roles["b"])
    if "a" in roles:
        payload["params_a"] = convert_state_dict(roles["a"])
    for scalar in ("epsilon", "episode", "generation", "train_steps_count"):
        if scalar in ckpt and isinstance(ckpt[scalar], (int, float)):
            payload[scalar if scalar != "train_steps_count" else "train_steps"] = (
                ckpt[scalar]
            )
    return save_checkpoint(dst, payload)


def import_torch_dir(src_dir: str, dst_dir: str) -> Dict[str, Optional[str]]:
    """Convert every ``.pth`` under ``src_dir``. Returns {name: dst|None}."""
    results: Dict[str, Optional[str]] = {}
    src_dir = Path(src_dir)
    dst_dir = Path(dst_dir)
    for pth in sorted(src_dir.glob("*.pth")):
        name = pth.stem
        try:
            out = import_torch_checkpoint(str(pth), str(dst_dir / name))
            results[name] = str(out)
        except Exception as e:
            print(f"[import-torch] skip {pth.name}: {e}")
            results[name] = None
    return results
