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
for every kernel (``nvcc -Xptxas -v``), the resident blocks per SM of
both bodies of the dense kernels (1 and 3) and the clusters of 1-8 blocks
of the channel statistics (7) the card at hand holds at once.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch.analysis.sanitize import note_trace

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("dequant_matmul", "w8a8_matmul", "paged_attention",
           "expert_dequant_matmul", "expert_w8a8_matmul", "quantize_pack",
           "channel_stats")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def nvcc_command(src: Path, out: Path, *extra: str) -> list[str]:
    """The command that compiles ``src`` into the library ``out`` with
    this module's flags (and ``extra`` ones)."""
    return [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(out), str(src)]


def source_hash(paths, salt: bytes = b"") -> str:
    """16 hex digits of the sha256 of ``salt`` and the files' bytes, in
    the order given: the libraries' names and the tuner's template
    version (``kernels/template.py``)."""
    h = hashlib.sha256(salt)
    for path in paths:
        h.update(Path(path).read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    digest = source_hash([SRC_DIR / f"{name}.cu",
                          *sorted(SRC_DIR.glob("*.cuh"))],
                         " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> list[str]:
    """Compile every stale library in ``names`` in parallel; returns the
    names that were compiled. Raises with nvcc's output on failure."""
    stale = [n for n in names if not library_path(n).exists()]
    if not stale:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in stale:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(SRC_DIR / f"{name}.cu", tmp)
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
        note_trace("kernel_load", library=name)
        build((name,))
        lib = _loaded[name] = _open(name, library_path(name))
    return lib


def _open(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def library_from(name: str, path: Path):
    """Inside the block, the kernels of ``csrc/<name>.cu`` launch from
    the library at ``path`` (a variant's build, say) in place of the
    committed one."""
    saved = _loaded.get(name)
    _loaded[name] = _open(name, path)
    try:
        yield
    finally:
        if saved is None:
            _loaded.pop(name)
        else:
            _loaded[name] = saved


def check(name: str, code: int) -> None:
    """Raise if a C entry point returned a non-zero CUDA error code."""
    if code:
        msg = getattr(load(name), f"{name}_error_string")(code)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg.decode(errors='replace')})")


def resource_usage(names=SOURCES) -> str:
    """ptxas's report (registers, spills, shared memory) for every kernel in
    ``names``, from compiles with ``-Xptxas -v`` into throwaway files, all
    started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        tmp = BUILD_DIR / f"ptxas-{name}.{os.getpid()}.tmp"
        procs.append((name, tmp, subprocess.Popen(
            nvcc_command(SRC_DIR / f"{name}.cu", tmp, "-Xptxas", "-v"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    lines = []
    for name, tmp, proc in procs:
        _, err = proc.communicate()
        tmp.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        # "ptxas info" lines, and the stack-frame and spill line that
        # follows each function's properties
        lines += [f"{name}: {ln.strip()}" for ln in err.splitlines()
                  if "ptxas info" in ln or "spill" in ln]
    return "\n".join(lines)


def blocks_per_sm(name: str, body: int, bits: int) -> int:
    """Resident blocks per SM on the current card of dense kernel ``name``
    ("dequant_matmul" or "w8a8_matmul"), body 0 (streaming, 8 token rows
    a block) or 1 (the prefill tile), at ``bits`` with the scales of the
    model paths (CUDA's occupancy calculator over registers and shared
    memory)."""
    blocks = ctypes.c_int(0)
    fn = getattr(load(name), f"{name}_blocks_per_sm")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    check(name, fn(body, bits, ctypes.byref(blocks)))
    return blocks.value


def max_clusters(ranks: int, bf16: bool) -> int:
    """Clusters of ``ranks`` blocks of the channel-statistics kernel (7)
    that the current card holds at once (CUDA's occupancy calculator)."""
    clusters = ctypes.c_int(0)
    fn = load("channel_stats").channel_stats_max_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    check("channel_stats", fn(ranks, int(bf16), ctypes.byref(clusters)))
    return clusters.value


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--resource-usage", action="store_true",
                    help="print ptxas's report, the dense kernels' "
                         "resident blocks per SM and kernel 7's clusters")
    args = ap.parse_args()
    print("compiled:", ", ".join(build()) or "none, cached")
    if args.resource_usage:
        print(resource_usage())
        for name in ("dequant_matmul", "w8a8_matmul"):
            for body, label in ((0, "stream"), (1, "tile")):
                for bits in (2, 3, 4, 8):
                    print(f"{name} {label} W{bits}: "
                          f"{blocks_per_sm(name, body, bits)} blocks per SM")
        for bf16 in (False, True):
            print(f"channel_stats {'bf16' if bf16 else 'f32'}: clusters "
                  f"of 1-8 blocks at once: "
                  f"{[max_clusters(r, bf16) for r in range(1, 9)]}")


if __name__ == "__main__":
    main()
