"""The spatial graph's affinity (csrc/spa_affinity.cu): the node
projection x [M, C] @ Wg [C, A], its product with the words [T, A], the
relation scale and two softmaxes, M = B * N; one weight group."""


def cost(s):
    m = s["bk"] * s["n"]
    c, a, t, g = s["c"], s["a"], s["t"], s["groups"]
    return (2 * m * c * a + 2 * m * a * t, 2 * m * a + 12 * m * t,
            m * c * 2 + g * (c * a + a) * 2 + s["bk"] * t * a * 2
            + 2 * s["bk"] * t * 4 + 2 * m * t * 4)
