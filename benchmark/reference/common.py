"""What the two references share: the precision switch of the control,
snapshots moved to the device, and the gaps that are compared.

Every gap is a number the harness holds against a limit of the cell
(``benchmark/limits/<cell>.json``). Leaf gaps follow one rule: per leaf
of the flat parameter vector, the gap between the program's norm and the
reference's norm, over the larger of the reference leaf's norm and the
median leaf's. Leaves whose reference gradient (the Adam first moment
after the step) is under a thousandth of the median leaf's are left out:
they move by round-off alone (the frozen trunk of a heads-only update,
say).
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

ENV_FLOAT = ("ball_x", "ball_y", "ball_vx", "ball_vy", "spin",
             "top_paddle_x", "bottom_paddle_x")
ENV_INT = ("score_a", "score_b", "bounce_count", "t", "done")


@contextlib.contextmanager
def precision(mode: str):
    """``"f32"``: float32 products with TF32 off (the configuration's
    precision); ``"tf32"``: TF32 products on the card (the control)."""
    if mode not in ("f32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def to_device(tree, device):
    """A snapshot (dicts of tensors and plain values) moved to ``device``;
    generator states stay on the host."""
    if isinstance(tree, dict):
        return {k: (v if k == "generator" else to_device(v, device))
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def generator_from(state: torch.Tensor) -> torch.Generator:
    gen = torch.Generator()
    gen.set_state(state)
    return gen


def leaf_spans(named: Iterable[Tuple[str, int]]) -> List[Tuple[str, int, int]]:
    """``(name, start, end)`` of each leaf in the flat vector."""
    out, o = [], 0
    for name, n in named:
        out.append((name, o, o + n))
        o += n
    return out


def leaf_norms(flat: torch.Tensor, spans) -> List[float]:
    return [float(torch.linalg.vector_norm(flat[a:b].double()))
            for _, a, b in spans]


def leaf_gap(prog: torch.Tensor, ref: torch.Tensor, ref_grad: torch.Tensor,
             spans, over=max) -> float:
    """The worst leaf's gap of norms (see the module docstring), or with
    ``over=statistics.median`` the median leaf's; leaves whose reference
    gradient is under 1e-3 of the median leaf's are left out."""
    g = leaf_norms(ref_grad, spans)
    g_med = statistics.median(g)
    keep = [i for i, x in enumerate(g) if x >= 1e-3 * g_med]
    p, r = leaf_norms(prog, spans), leaf_norms(ref, spans)
    r_med = statistics.median([r[i] for i in keep])
    return over([abs(p[i] - r[i]) / max(r[i], r_med, 1e-30) for i in keep])


def env_mismatch(prog: Dict[str, torch.Tensor],
                 ref: Dict[str, torch.Tensor]) -> float:
    """Share of envs whose state after the chunk differs: a discrete field
    unequal, or a float field off by more than 1e-5 (relative above 1)."""
    bad = None
    for k in ENV_FLOAT:
        a, b = prog[k].float(), ref[k].float()
        d = (a - b).abs() > 1e-5 * torch.clamp(b.abs(), min=1.0)
        bad = d if bad is None else bad | d
    for k in ENV_INT:
        bad = bad | (prog[k] != ref[k])
    return float(bad.float().mean())


def relative(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def worst(values: Sequence[float]) -> float:
    return max(values) if values else 0.0


def rows_mismatch(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of rows (last axis the fields) that differ by more than 1e-5
    (relative above 1) in any field."""
    d = (prog - ref).abs() > 1e-5 * torch.clamp(ref.abs(), min=1.0)
    return float(d.any(dim=-1).float().mean())


def median_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Median relative gap of two equal-shaped tensors (1 when the shapes
    differ, as when a block ran on part of its batch)."""
    if prog.shape != ref.shape:
        return 1.0
    gap = (prog.double() - ref.double()).abs() / ref.double().abs().clamp(
        min=1e-12)
    return float(gap.median())
