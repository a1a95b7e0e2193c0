"""K3's share of its roofline (csrc/bilstm_train.cu, the train backward's bi-LSTM recurrence)
at the recipe's batch over W/4 steps (harness/kernels.py)."""

from harness.kernels import recurrence_roofline


def read(run):
    d = run.driver
    return recurrence_roofline(run, "k3", d.B, d.W // 4)
