"""The ConvLSTM's gates (csrc/convlstm.cu): [x | h] [M, 2Cm] @ W [2Cm,
4Cm], the peepholes and the statistics of j, i and f."""


def cost(s):
    m = s["bk"] * s["n"]
    cm, n = s["cm"], s["n"]
    return (2 * m * 2 * cm * 4 * cm, 8 * m * cm,
            3 * m * cm * 2 + 2 * cm * 4 * cm * 2 + 2 * n * cm * 2
            + 4 * m * cm * 2)
