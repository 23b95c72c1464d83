"""One file a configuration family (the configuration file's
``reference`` name): ``forward_flops(d)``, the operations of one net's
forward for one env-step, and ``row_flops(d)``, those of one sampled
replay row in an update (the online forwards and backward and the target
forward it needs), from the widths alone, two operations a multiply-add.
``step_mfu`` counts with them, so its count holds whichever kernels do
the work."""
