"""Builds and loads the package's native libraries from its tracked sources.

* ``oracle``: the serial C++ reference algorithm and "%a" codec
  (``cc/oracle.cpp``, g++);
* ``chain_host``: the chain-frame arithmetic of the CUDA kernel built for
  the host (``cuda/chain_host.cpp``, g++), which the CPU tests drive;
* ``chain_cuda``: the CUDA chain-frame kernel and its XLA FFI handlers
  (``cuda/chain_kernel.cu``, nvcc for sm_90a).

Each library is written to ``build/lib<name>-<hash>.so`` next to this file,
where the hash covers the sources, the headers they include and the build
command.  A library is rebuilt exactly when that hash changes, so a stale
binary copied along with a working tree is never loaded.  Build everything
ahead of time with ``python -m stochquant.native`` (add ``chain_cuda``
on a machine with the CUDA toolkit).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "build")

_CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

#: name -> (sources, headers, compiler kind)
LIBS = {
    "oracle": (["cc/oracle.cpp"], [], "cxx"),
    "chain_host": (["cuda/chain_host.cpp"], ["cuda/chain_math.h"], "cxx"),
    "chain_cuda": (["cuda/chain_kernel.cu"], ["cuda/chain_math.h"], "nvcc"),
}

_loaded: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (default CUDA_HOME
    /usr/local/cuda), else ``nvcc`` on PATH.  Raises if neither exists."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "chain kernel cannot be built"
        )
    return found


def _command(name: str, out: str) -> list:
    sources, _, kind = LIBS[name]
    srcs = [os.path.join(_PKG, s) for s in sources]
    if kind == "cxx":
        cxx = os.environ.get("CXX", "g++")
        # no -march=native: a library must load on any x86-64 host it is
        # copied to; -ffp-contract=off keeps host rounding op by op
        return [cxx, *_CXX_FLAGS, "-ffp-contract=off", "-o", out, *srcs]
    import jax.ffi

    return [
        nvcc_path(), "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
        "-gencode", "arch=compute_90a,code=sm_90a",
        # no FMA contraction: XLA emits separate multiplies and adds, and
        # the kernel tracks the XLA path to rounding (cuda/chain_math.h)
        "-fmad=false",
        "-I", jax.ffi.include_dir(), "-o", out, *srcs,
    ]


def _digest(name: str) -> str:
    sources, headers, kind = LIBS[name]
    h = hashlib.sha256()
    for rel in sorted(sources + headers):
        h.update(rel.encode())
        with open(os.path.join(_PKG, rel), "rb") as fh:
            h.update(fh.read())
    # the command, minus paths that differ between checkouts
    cmd = _command(name, "OUT")
    h.update(" ".join(os.path.basename(c) for c in cmd).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    """Where library ``name`` lives for the current sources."""
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def build(name: str) -> str:
    """Build library ``name`` unless the current sources' build exists;
    returns its path.  A failed build raises with the compiler's output."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            _command(name, tmp), capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)  # atomic: concurrent builders race safely
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load library ``name`` (once per process)."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name))
    return _loaded[name]


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or [
        "oracle", "chain_host"
    ]
    for name in names:
        if name not in LIBS:
            raise SystemExit(f"unknown library {name!r}; known: {sorted(LIBS)}")
        print(build(name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
