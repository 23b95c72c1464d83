"""QNetRNN: features 7 -> F/2 -> F, one LSTM of H, a shared noisy head H
-> HH, dueling V 1 and A 3 on the last step; updates on windows of T
steps."""


def _step_macs(d: dict) -> float:
    F1, F, H, HH = (d["feature_dim"] // 2, d["feature_dim"],
                    d["lstm_hidden_dim"], d["head_hidden_dim"])
    return 7 * F1 + F1 * F + (F + H) * 4 * H + 2 * (H * HH) + 2 * HH * 4


def forward_flops(d: dict) -> float:
    return 2.0 * _step_macs(d)


def row_flops(d: dict) -> float:
    """A window of T steps: the online forwards over obs and next obs, the
    target forward over next obs, and the backward through the obs window
    (twice the forward's multiply-adds)."""
    return d["trace_length"] * 2.0 * _step_macs(d) * (3 + 2)
