"""The ConvLSTM's cell update (csrc/convlstm.cu): three layer norms, tanh,
two sigmoids, the cell and output updates and their statistics, ~40
operations an element."""


def cost(s):
    m = s["bk"] * s["n"]
    cm, n = s["cm"], s["n"]
    return (0, 40 * m * cm, 4 * m * cm * 2 + m * cm * 2 + n * cm * 2
            + 2 * 5 * cm * 4 + 2 * m * cm * 2)
