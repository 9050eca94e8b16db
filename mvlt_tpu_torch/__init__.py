"""MVLT in PyTorch for NVIDIA Hopper: a port of the JAX package ``mvlt_tpu``.

It mirrors mvlt_tpu's layout (``config``, ``data``, ``models``, ``ops``,
``train``, ``eval``, ``utils``) and its public tensor layouts (NHWC images,
[B, N, C] token streams). Plain PyTorch runs everywhere; on a CUDA device
the blocks run hand-written kernels (``csrc/``), built with nvcc at first
use: two on the serving path, four (attention and LN-MLP, forward and
backward) on the training path. It imports neither JAX nor any module of
``mvlt_tpu``: what it needs of the JAX package's host code (configs,
tokenizer, the weight-name mapping) it keeps as its own copies, which the
tests pin to the originals.
"""
