"""Data parallelism of the port: the process group from the torchrun
environment (mesh.py) and what a rank needs on top of it (sharding.py):
the DDP wrap, ZeRO-1, a rank's shard of an eval set and the sum
reductions. Counterpart of mvlt_tpu/parallel/, whose data axis is one SPMD
program; here one process drives one rank. Tensor and sequence parallelism
are not ported."""
