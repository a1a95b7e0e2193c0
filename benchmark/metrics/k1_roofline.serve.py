"""K1's share of its roofline (csrc/bilstm_fwd.cu, the serving bi-LSTM
recurrence) at the cell's batch over W/4 steps (harness/kernels.py)."""

from harness.kernels import recurrence_roofline


def read(run):
    d = run.driver
    return recurrence_roofline(run, "k1", d.B, d.W // 4)
