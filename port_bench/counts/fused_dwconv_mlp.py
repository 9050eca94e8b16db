"""Kernel D: the MLP half of a v2 block (LN2, fc1, the 3x3 depthwise conv
over the visual rows, GELU, fc2 and residual). FLOPs of fc1, fc2 and the
conv's taps; bytes of x and the weights read once, the output written once."""

from port_bench.flops import nbytes


def count(x, hw, ln2_weight, ln2_bias, w1, b1, dw_weight, dw_bias, w2, b2, *, eps):
    b, n, d = x.shape
    h, w = hw
    hidden = w1.shape[0]
    flops = 2 * 2 * b * n * d * hidden + 2 * 9 * b * h * w * hidden
    return flops, nbytes(x, ln2_weight, ln2_bias, w1, b1, dw_weight, dw_bias, w2, b2) + nbytes(x)
