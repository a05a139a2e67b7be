"""Mutan forward (csrc/mutan.cu): x [M, K] @ W [K, 5C] + b, the tanh
chain, the head sum with the language row, tanh and the row l2norm, M = B
* frames * N rows.  (bf16 product FLOPs, f32 operations, bytes: each input
read once, each output written once.)"""


def cost(s):
    m = s["bk"] * s["frames"] * s["n"]
    c, k, h = s["c"], s["k"], s["heads"]
    return (2 * m * k * h * c, 4 * m * h * c + 4 * m * c,
            m * k * 2 + k * h * c * 2 + h * c * 4 + s["bk"] * h * c * 4
            + m * c * 2)
