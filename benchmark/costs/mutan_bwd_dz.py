"""Mutan's dz pass (csrc/mutan_bwd.cu): per v entry the head sum, dz,
dlang and db (~9 operations), per output column tanh, the norm and the
l2norm's vjp (~12); reads v and the cotangent, writes dz, the language
and bias partials."""


def cost(s):
    m = s["bk"] * s["frames"] * s["n"]
    c, h = s["c"], s["heads"]
    return (0, 9 * m * h * c + 12 * m * c,
            2 * m * h * c * 2 + m * c * 2 + 2 * s["bk"] * h * c * 4
            + h * c * 4)
