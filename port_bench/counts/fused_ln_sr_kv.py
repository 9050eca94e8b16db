"""Kernel A: LN1, the k = stride = sr conv over the visual rows and SR-LN, and
the joint K/V projection. FLOPs of the conv and the projection; bytes of the
stream, the weights and vectors read once and K, V written once."""

from port_bench.flops import nbytes


def count(x, hw, ln1_weight, ln1_bias, sr_weight, sr_bias, srn_weight, srn_bias, kv_weight,
          kv_bias, *, sr, heads, eps1, eps_sr):
    b, n, d = x.shape
    h, w = hw
    t = n - h * w
    p = (h // sr) * (w // sr) if sr > 1 else 0
    m = p + t if sr > 1 else n
    flops = 2 * b * m * d * 2 * d
    if sr > 1:
        flops += 2 * b * p * sr * sr * d * d
    out = 2 * b * m * d * x.element_size()
    return flops, nbytes(x, ln1_weight, ln1_bias, sr_weight if sr > 1 else None,
                         sr_bias if sr > 1 else None, srn_weight if sr > 1 else None,
                         srn_bias if sr > 1 else None, kv_weight, kv_bias) + out
