"""Data and tensor parallelism of the port: the process group from the
torchrun environment and its data and model groups (mesh.py), what a data
rank needs on top of it (sharding.py: the DDP wrap, ZeRO-1, a rank's shard
of an eval set and the sum reductions) and the tensor-parallel shards and
operators (tensor.py). Counterpart of mvlt_tpu/parallel/, whose (data,
model) mesh is one SPMD program; here one process drives one rank.
Sequence parallelism is not ported."""
