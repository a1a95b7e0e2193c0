"""Thread-safe first-use g++ builds of the preprocess's native libraries.

Counterpart of horizonnet_tpu/preprocess/_build.py. The preprocess CLI runs
panos on a thread pool and every native library (lsd, merge, vote, warp)
builds on its first call, so one process-wide lock covers check, build and
dlopen, and the compile lands in a temp file published with ``os.replace``
(atomic on POSIX): no thread or process ever loads a half-written library.

The libraries land in ``build/preprocess/`` at the repository root (listed
in .gitignore), named by a hash of the source and the flags, so an edited
source or a changed flag rebuilds and an unchanged one loads from the last
build; a ``-march=native`` library is also named by what that flag means
on the host, so a build for another CPU never loads. The flags stay the
JAX package's, library by library: on one machine the same source and
flags give results equal to the bit with its copies.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "preprocess")

_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _native_target():
    """What ``-march=native`` means to g++ on this host: a library built for
    another CPU's extensions must not load here."""
    proc = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True)
    return proc.stdout.encode()


def library_path(src, extra_flags=()):
    """Where ``src`` built with ``extra_flags`` lands under BUILD_DIR: named
    by a hash of the source, the flags and, under ``-march=native``, the
    host's target."""
    digest = hashlib.sha256(" ".join(extra_flags).encode() + b"\0")
    if "-march=native" in extra_flags:
        digest.update(_native_target())
    with open(src, "rb") as f:
        digest.update(f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_and_load(src, extra_flags=()):
    """Compile ``src`` with g++ unless its library exists, and dlopen it.

    Raises RuntimeError with g++'s output when the build fails.
    """
    lib_path = library_path(src, extra_flags)
    with _BUILD_LOCK:
        if not os.path.isfile(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    ["g++", "-O3", *extra_flags, "-shared", "-fPIC",
                     "-o", tmp, src], capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for {src}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return ctypes.CDLL(lib_path)
