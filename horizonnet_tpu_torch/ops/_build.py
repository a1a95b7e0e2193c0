"""Build a kernel source under ``csrc/`` with nvcc and load it with ctypes.

Each ``.cu`` file exposes a plain C interface, so it compiles in seconds
without PyTorch's headers. The shared library lands in ``build/kernels/``
at the repository root (listed in .gitignore), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads from the last build. Nothing is built when a module is imported:
the first call that launches a kernel builds it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc"))
    for path in cand:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def load_kernel_library(name):
    """Compile ``csrc/<name>.cu`` once and return the loaded ctypes CDLL.

    Raises RuntimeError with nvcc's output when the build fails.
    """
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        out = os.path.join(BUILD_DIR,
                           f"lib{name}_{digest.hexdigest()[:16]}.so")
        if not os.path.isfile(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(out)
        _loaded[name] = lib
        return lib
