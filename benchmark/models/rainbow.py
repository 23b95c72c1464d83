"""Rainbow: trunk 7 -> 64 -> 64, noisy dueling streams of S (value S -> A,
advantage S -> 3A), A atoms (the noise products are counted as one
multiply-add a weight of a noisy layer, as ``qnet.py`` counts them)."""


def _noisy(d: dict) -> int:
    """Weights of the four noisy layers."""
    A, S = d["num_atoms"], d["stream_hidden"]
    return 64 * S + S * A + 64 * S + S * 3 * A


def forward_flops(d: dict) -> float:
    trunk = 7 * 64 + 64 * 64
    return 2.0 * (trunk + 2 * _noisy(d))


def c51_flops(A: int) -> float:
    """Kernel 6's operations on one row (``benchmark/kernels/k6.py``)."""
    return 24.0 * A


def row_flops(d: dict) -> float:
    """Online forwards on s_t and s_t+n, the target forward on s_t+n,
    kernel 6, and the backward from the logits of s_t: the noisy layers'
    mu and sigma gradients and the input gradients of the streams' second
    layers; with the full net also the input gradients of their first
    layers, the trunk's weight gradients and its second layer's input
    gradient."""
    A, S = d["num_atoms"], d["stream_hidden"]
    back = 2 * _noisy(d) + S * A + S * 3 * A
    if not d["train_heads_only"]:
        back += 2 * 64 * S + 7 * 64 + 64 * 64 + 64 * 64
    return 3 * forward_flops(d) + c51_flops(A) + 2.0 * back
