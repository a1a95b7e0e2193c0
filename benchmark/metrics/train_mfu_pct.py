"""Train MFU: the reference's FLOPs a pano of a train step (forward with
dropout, losses, backward; the optimizer's adds left out:
harness/flops.py) times the panos stepped in the traced window, over the
window's seconds, against the H100's bf16 peak."""

from harness.flops import mfu_pct, train_flops_per_pano


def read(run):
    d = run.driver
    return mfu_pct(train_flops_per_pano(d.H, d.W) * d.panos, run.window_s)
