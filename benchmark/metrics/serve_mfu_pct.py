"""Serving MFU: the reference's FLOPs a pano (the dct4 decode and the
forward, every recurrence step: harness/flops.py) times the panos served
in the traced window, over the window's seconds, against the H100's bf16
peak."""

from harness.flops import mfu_pct, serve_flops_per_pano


def read(run):
    d = run.driver
    return mfu_pct(serve_flops_per_pano(d.H, d.W, d.dct) * d.panos,
                   run.window_s)
