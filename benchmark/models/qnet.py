"""QNet: 7 -> 64 -> 64, dueling heads V 1 and A 3 (NoisyNet: the noise
products are counted as one multiply-add a weight)."""


def forward_flops(d: dict) -> float:
    trunk = 7 * 64 + 64 * 64
    heads = 64 * 4
    return 2.0 * (trunk + 2 * heads)


def row_flops(d: dict) -> float:
    """Online forwards on obs and next obs, the target forward on next
    obs, and the backward: the heads' weight gradients, and with the full
    net the trunk's weight and input gradients."""
    heads = 64 * 4
    back = 2 * heads if d["train_heads_only"] else \
        2 * heads + 2 * (64 * 64) + 7 * 64 + 64 * 4
    return 3 * forward_flops(d) + 2.0 * back
