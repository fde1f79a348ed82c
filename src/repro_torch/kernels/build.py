"""Build the CUDA kernels at first use and load them with ctypes.

Each source ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

into ``build/kernels/`` at the root of the checkout (listed in .gitignore).
The file name carries a hash of the source, the headers beside it and the
flags, so a library is rebuilt only when one of them changed. Stale builds
of all sources start together (one ``nvcc`` each) and are awaited together;
each lands under a temporary name and is renamed into place, so concurrent
processes never load a half-written library.

Nothing here runs at import, so every module of the port imports on a
machine without ``nvcc`` or a card (the CPU tests import them all).

    PYTHONPATH=src python3 -m repro_torch.kernels.build --resource-usage

builds the kernels and prints ptxas's registers, spills and shared memory
for every kernel (``nvcc -Xptxas -v``), and the dequant matmul's resident
blocks per SM on the card at hand.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("dequant_matmul", "paged_attention")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> list[str]:
    """Compile every stale library in ``names`` in parallel; returns the
    names that were compiled. Raises with nvcc's output on failure."""
    stale = [n for n in names if not library_path(n).exists()]
    if not stale:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in stale:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return stale


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry point returned a non-zero CUDA error code."""
    if code:
        msg = getattr(load(name), f"{name}_error_string")(code)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg.decode(errors='replace')})")


def resource_usage(names=SOURCES) -> str:
    """ptxas's report (registers, spills, shared memory) for every kernel in
    ``names``, from a compile with ``-Xptxas -v`` into a throwaway file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lines = []
    for name in names:
        tmp = BUILD_DIR / f"ptxas-{name}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
             str(SRC_DIR / f"{name}.cu")], capture_output=True, text=True)
        tmp.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        # "ptxas info" lines, and the stack-frame and spill line that
        # follows each function's properties
        lines += [f"{name}: {ln.strip()}" for ln in proc.stderr.splitlines()
                  if "ptxas info" in ln or "spill" in ln]
    return "\n".join(lines)


def dequant_matmul_blocks_per_sm(bits: int) -> int:
    """Resident blocks of the dequant-matmul kernel per SM on the current
    card (CUDA's occupancy calculator over its registers and shared
    memory)."""
    blocks = ctypes.c_int(0)
    fn = load("dequant_matmul").dequant_matmul_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    check("dequant_matmul", fn(bits, ctypes.byref(blocks)))
    return blocks.value


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--resource-usage", action="store_true",
                    help="print ptxas's report and the dequant matmul's "
                         "resident blocks per SM")
    args = ap.parse_args()
    print("compiled:", ", ".join(build()) or "none, cached")
    if args.resource_usage:
        print(resource_usage())
        for bits in (2, 3, 4, 8):
            print(f"dequant_matmul W{bits}: "
                  f"{dequant_matmul_blocks_per_sm(bits)} blocks per SM")


if __name__ == "__main__":
    main()
