"""The SWG-Transformer's share of its roofline in the train step: the
least time its work could take on the card, max(ops / bf16 peak, bytes /
HBM peak) with the ops and bytes counted on the reference
(harness/lgt_flops.py), over its forward and backward stages' device
time a step (``device.swg_fwd`` and ``device.swg_bwd``). Not given where
the program's block counters over the window (``swg.window_blocks``,
``swg.global_blocks``) are not 4 of each kind a replay: the stages would
not be the stack's."""

import sys

from harness.flops import roofline_pct
from harness.lgt_flops import swg_bytes, swg_ops
from harness.program_spans import stage_ms
from reference.lgt import KINDS


def read(run):
    replays = run.launches.get("program.replays")
    window = run.launches.get("swg.window_blocks")
    glob = run.launches.get("swg.global_blocks")
    print(f"swg blocks over the window: window {window}, global {glob}, "
          f"replays {replays}", file=sys.stderr)
    if not replays or window != replays * (len(KINDS) - KINDS.count(
            "global")) or glob != replays * KINDS.count("global"):
        return None
    fwd, bwd = stage_ms(run, "swg_fwd"), stage_ms(run, "swg_bwd")
    if fwd is None or bwd is None:
        return None
    d = run.driver
    return roofline_pct(swg_ops(d.B, d.W), swg_bytes(d.B, d.W),
                        (fwd + bwd) / 1e3)
