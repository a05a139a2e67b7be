"""The graph message (csrc/graph_conv.cu): msg = w_aff [N, T] @ pooled
[T, C] per sample and its (sum, sum of squares)."""


def cost(s):
    m = s["bk"] * s["n"]
    c, t = s["c"], s["t"]
    return (2 * m * t * c, 3 * m * c,
            m * t * 2 + s["bk"] * t * c * 2 + m * c * 2)
