"""#14: the MLM cross entropy through the tied vocabulary, the logits never
stored. Work that the inputs need: the labeled rows' logits (a row labeled
-1 needs none), 2 R_labeled H V; bytes of the rows, the table, the bias and
the labels read once, nll and lse written once. The labeled count stays a
device tensor until the window has closed."""

from port_bench.flops import nbytes


def count(rows, table, bias, labels):
    r, h = rows.shape
    v = table.shape[0]
    labeled = (labels >= 0).sum()
    return 2 * labeled * h * v, nbytes(rows, table, bias, labels) + 2 * r * 4
