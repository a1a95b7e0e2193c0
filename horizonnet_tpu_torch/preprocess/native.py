"""ctypes bindings for the C++ segment-merge engine (merge.cpp) and the
orthogonal-triple search (vote.cpp).

Copied from horizonnet_tpu/preprocess/native.py. Built with g++ on first
use into build/preprocess/ (``_build.py``). Compiled without fp-contraction
or fast-math so results track the numpy twins in lines.py and vanishing.py
to rounding error.
"""

import ctypes
import os

import numpy as np

from ._build import build_and_load

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "merge.cpp")
_lib = None
_VOTE_SRC = os.path.join(_DIR, "vote.cpp")
_vote_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # build_and_load serializes check+compile+dlopen and publishes the
    # .so atomically (the preprocess CLI races many threads into here)
    lib = build_and_load(_SRC, extra_flags=("-ffp-contract=off",
                                                  "-march=native"))
    lib.combine_edges_merge.restype = ctypes.c_int
    lib.combine_edges_merge.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int]
    _lib = lib
    return lib


def _load_vote():
    global _vote_lib
    if _vote_lib is not None:
        return _vote_lib
    lib = build_and_load(_VOTE_SRC,
                         extra_flags=("-ffp-contract=off",))
    D = ctypes.c_double
    lib.vote_search_triples.restype = None
    lib.vote_search_triples.argtypes = [
        ctypes.POINTER(D), ctypes.POINTER(D), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), D, D, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(D),
        ctypes.POINTER(D), ctypes.POINTER(D)]
    _vote_lib = lib
    return lib


def search_triples(bins, votes, check1, nonzero, orth_cos, third_cos,
                   force_unempty):
    """C++ orthogonal-triple search (vote.cpp); same contract as
    vanishing._search_triples_py: returns (best, vote_max, last_cost,
    last_angle)."""
    lib = _load_vote()
    D = ctypes.c_double
    bins = np.ascontiguousarray(bins, np.float64)
    votes = np.ascontiguousarray(votes, np.float64)
    check1 = np.ascontiguousarray(check1, np.int32)
    nz = np.ascontiguousarray(nonzero, np.uint8)
    best = (ctypes.c_int * 3)()
    vote_max = D()
    last_cost = D()
    last_angle = (D * 3)()
    lib.vote_search_triples(
        bins.ctypes.data_as(ctypes.POINTER(D)),
        votes.ctypes.data_as(ctypes.POINTER(D)), len(bins),
        check1.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(check1),
        nz.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        D(orth_cos), D(third_cos), int(force_unempty),
        best, ctypes.byref(vote_max), ctypes.byref(last_cost), last_angle)
    best = (int(best[0]), int(best[1]), int(best[2]))
    angle = np.array([last_angle[0], last_angle[1], last_angle[2]])
    if vote_max.value == 0.0:
        # nothing accepted: match the python initial state (scalars)
        return best, 0.0, 0, 0
    return best, float(vote_max.value), float(last_cost.value), angle


def merge_rounds(lines, rounds=3):
    """Run the sequential merge rounds on (N, 8) parameterized lines.

    Returns the surviving (M, 8) array (M <= N, original order).
    """
    lib = _load()
    # a copy: the engine compacts the rows in place (the JAX package's
    # binding passes the caller's array, so its combine_edges returns
    # originals overwritten by the merged rows)
    buf = np.array(lines, np.float64, order="C")
    if len(buf) == 0:
        return buf.reshape(0, 8)
    assert buf.shape[1] == 8, buf.shape
    m = lib.combine_edges_merge(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(buf), int(rounds))
    return buf[:m].copy()
