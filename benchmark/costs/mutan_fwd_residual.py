"""Mutan's training form (csrc/mutan.cu): the forward of `mutan_fused`
that also writes the residual v = tanh(x @ W + b) [M, 5C] in bf16."""


def cost(s):
    m = s["bk"] * s["frames"] * s["n"]
    c, k, h = s["c"], s["k"], s["heads"]
    return (2 * m * k * h * c, 4 * m * h * c + 4 * m * c,
            m * k * 2 + k * h * c * 2 + h * c * 4 + s["bk"] * h * c * 4
            + m * c * 2 + m * h * c * 2)
