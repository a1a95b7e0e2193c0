"""MFU of the single-pano serving program: the reference's FLOPs a pano
times the panos served in the traced window, over the seconds the device
was busy (at a fixed offered rate the window's own rate cannot move),
against the H100's bf16 peak."""

from harness.flops import mfu_pct, serve_flops_per_pano


def read(run):
    d = run.driver
    if run.busy_s <= 0:
        return None
    return mfu_pct(serve_flops_per_pano(d.H, d.W, d.dct) * d.panos,
                   run.busy_s)
