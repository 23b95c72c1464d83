"""One file a kernel: ``NAME``, a part of the kernel's name in the device
trace, and ``bound_s(d, cfg, phase)``, the least time of one launch in
``phase`` ("gate" for a gate's launch, else a train iteration's), counted
from the launch's shapes as the cell's configuration sets them: every
input byte read once, every output byte written once, the operations the
algorithm needs."""
