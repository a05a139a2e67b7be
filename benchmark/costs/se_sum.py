"""The gated exchange's SE sum (csrc/se_sum.cu): per other level its
product [M, Cm] @ [Cm, Cm], bias, relu, gate and add, then the row
l2norm."""


def cost(s):
    m = s["bk"] * s["n"]
    cm, o = s["cm"], s["others"]
    return (2 * o * m * cm * cm, o * 5 * m * cm + 3 * m * cm,
            (2 + o) * m * cm * 2 + o * (cm * cm + cm + s["bk"] * cm) * 2)
