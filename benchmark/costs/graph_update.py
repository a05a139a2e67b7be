"""The graph update (csrc/graph_conv.cu): relu(x + LN1(msg)) @ W [C, C] +
b and its statistics; one weight group."""


def cost(s):
    m = s["bk"] * s["n"]
    c, g = s["c"], s["groups"]
    return (2 * m * c * c, 10 * m * c,
            3 * m * c * 2 + g * (c * c * 2 + c * 2 + 2 * c * 4))
