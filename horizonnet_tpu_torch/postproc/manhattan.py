"""Greedy Manhattan wall commitment (host numpy), for general layouts.

Copy of the part of horizonnet_tpu/postproc/manhattan.py that the
general-layout serving tail runs (``Wall`` and ``_GreedyRing``; behaviour
of the reference's misc/post_proc.py:241-334). The JAX package's
``postproc/__init__.py`` imports its device module, which imports jax, so
the port keeps its own copy.
"""

import dataclasses

from ..geometry.equirect_host import x_u_solve_y, y_u_solve_x


@dataclasses.dataclass
class Wall:
    """One axis-aligned wall of the plan-view layout ring.

    ``axis`` 0 means the wall lies on a plan line x = ``value``; axis 1
    means y = ``value``. ``seg`` is the source column segment (-1 for
    walls synthesized during commitment), ``u0``/``u1`` the azimuths of
    the segment's edge columns. ``origin`` records how the wall got its
    final shape: "vote", "flipped" (axis forced to alternate) or
    "inferred" (synthesized from a committed neighbour's edge azimuth).
    """

    axis: int
    value: float
    score: float = 0.0
    seg: int = -1
    u0: float = -1.0
    u1: float = -1.0
    pending: bool = False
    origin: str = "vote"

    def corner_wall_at(self, u: float) -> "Wall":
        """The perpendicular wall through this wall's point at azimuth u
        (ref misc/post_proc.py:272-276)."""
        if self.axis == 0:
            return Wall(axis=1, value=x_u_solve_y(self.value, u),
                        origin="inferred")
        return Wall(axis=0, value=y_u_solve_x(self.value, u),
                    origin="inferred")


class _GreedyRing:
    """State machine committing a ring of candidate walls one at a time.

    ``run`` repeatedly commits the highest-score pending wall and
    reconciles it with its already-committed ring neighbours so wall axes
    alternate, with three moves in this priority:

    - DEFER:  conflict with one committed neighbour -> push the wall back
      to pending at score - 100; a second conflict (score < -1) triggers
      INSERT instead.
    - INSERT: synthesize the perpendicular wall implied by the committed
      neighbour's edge azimuth next to it (a new corner).
    - RESOLVE (both neighbours committed): three same-axis walls in a row
      flip the middle one (re-voting its value on the new axis); when the
      neighbours' axes differ the wall is replaced by the two walls its
      neighbours imply.

    Commit order, tie-breaks, penalties and insertion positions track the
    reference greedy (misc/post_proc.py:241-334).
    """

    def __init__(self, walls, seg_mean):
        """``seg_mean(seg, axis)`` -> mean plan coordinate of a segment's
        samples on one axis (the flip re-vote value); the serving path
        reads the means the device fit computed."""
        self.walls = list(walls)
        self._seg_mean = seg_mean

    def run(self):
        while True:
            i = self._best_pending()
            if i is None:
                return self.walls
            self.walls[i].pending = False
            self._reconcile(i)

    def _best_pending(self):
        """Highest-score pending wall; lowest index breaks ties."""
        best = None
        for i, w in enumerate(self.walls):
            if w.pending and (best is None
                              or w.score > self.walls[best].score):
                best = i
        return best

    def _reconcile(self, i):
        walls = self.walls
        prv = walls[(i - 1) % len(walls)]
        nxt = walls[(i + 1) % len(walls)]

        if prv.pending and nxt.pending:
            return  # neighbours unknown yet: nothing to reconcile

        if prv.pending or nxt.pending:
            committed = nxt if prv.pending else prv
            if committed.axis != walls[i].axis:
                return  # alternates fine
            if walls[i].score >= -1:
                # DEFER: retry later at a penalized score
                walls[i].pending = True
                walls[i].score -= 100
            elif not prv.pending:
                # INSERT before i, at prv's trailing edge azimuth
                walls.insert(i, prv.corner_wall_at(prv.u1))
            else:
                # INSERT after i, at nxt's leading edge azimuth
                walls.insert((i + 1) % len(walls),
                             nxt.corner_wall_at(nxt.u0))
            return

        # RESOLVE: both neighbours committed
        if prv.axis == nxt.axis:
            if walls[i].axis == prv.axis:
                # three same-axis walls in a row: flip the middle one and
                # re-vote its value on the new axis (plain segment mean)
                w = walls[i]
                w.axis = (w.axis + 1) % 2
                w.origin = "flipped"
                w.value = self._seg_mean(w.seg, w.axis)
        else:
            # neighbours differ: this span must contain a corner; replace
            # it with the two walls the neighbours' edge azimuths imply
            self.walls[i:i + 1] = [prv.corner_wall_at(prv.u1),
                                   nxt.corner_wall_at(nxt.u0)]
