"""Kernel 6, Rainbow's fused categorical projection and cross-entropy
(``csrc/c51_loss.cu``), one launch over an update's batch of ``bs`` rows of
``A`` atoms.

Operations, per row, of the function (the floor/ceiling scatter of the
reference's ``project``; the kernel's all-pairs form of the projection is
extra work the bound does not count): the shifted support and its grid
positions (a multiply, an add, two compares, a subtract and a divide an
atom), the floor and ceiling atoms and their weights (a floor, a ceiling
and two subtracts an atom), the mass split onto them (two multiply-adds an
atom), the log-sum-exp (a compare, a subtract, an exponential and an add
an atom), the loss (a subtract and a multiply-add an atom) and the
gradient (an exponential, a subtract and a multiply an atom): ``24 A``.
Bytes: the logits and the target distribution in, the return, discount
and weight in, the loss and the gradient out, each once.
"""

from benchmark.peaks import bound_s as _bound

NAME = "c51_loss_kernel"


def cost(bs: int, A: int):
    flops = bs * 24 * A
    nbytes = 4 * bs * (2 * A + 3) + 4 * bs * (A + 1)
    return flops, nbytes


def bound_s(d: dict, cfg: dict, phase: str) -> float:
    return _bound(*cost(d["batch_size"], d["num_atoms"]))
