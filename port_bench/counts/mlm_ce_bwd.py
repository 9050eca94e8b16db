"""#15: the MLM cross entropy's backward. Its own work for the labeled rows,
without recomputing the logits: d_rows = dL E and d_table = dL^T rows,
2 R_labeled H V each. Bytes of rows, table, bias, labels, lse and g read
once; the fp32 d_rows, d_table and d_bias written once."""

from port_bench.flops import nbytes


def count(rows, table, bias, labels, lse, g):
    r, h = rows.shape
    v = table.shape[0]
    labeled = (labels >= 0).sum()
    return 4 * labeled * h * v, nbytes(rows, table, bias, labels, lse, g) + 4 * (r * h + v * h + v)
