"""Mutan's weight gradient (csrc/mutan_bwd.cu): x^T [K, M] @ dz [M, 5C]
into an f32 [K, 5C]."""


def cost(s):
    m = s["bk"] * s["frames"] * s["n"]
    c, k, h = s["c"], s["k"], s["heads"]
    return (2 * m * k * h * c, 0,
            m * k * 2 + m * h * c * 2 + k * h * c * 4)
