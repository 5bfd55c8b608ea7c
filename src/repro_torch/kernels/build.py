"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled alone by
``nvcc`` into ``build/repro_torch/<name>-<hash>.so`` at the root of the
checkout (``.gitignore`` lists ``build/``), then loaded with ``ctypes``.  The
hash covers the source and the flags, so an edited source builds anew and an
unchanged one is reused.  Nothing here runs at import: the package imports
on a machine with no ``nvcc`` and no card.

``python -m repro_torch.kernels.build --ptxas [CSRC_DIR]`` prints, for every
kernel of every source (of ``CSRC_DIR``, by default this package's), the
registers and spill bytes that ``nvcc -Xptxas -v`` reports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("sched", "ssd_scan", "ssd_scan_bwd", "flash_attention", "flash_attention_bwd",
           "decode_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from the CUDA toolkit PyTorch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # deferred: heavy import

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    """Start one ``nvcc`` writing to a temporary file beside the target."""
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every named source that has no current library, one ``nvcc``
    each, all started together.  Returns the wall seconds spent; raises with
    the compiler's output if a build fails."""
    t0 = time.perf_counter()
    jobs: List[Tuple[str, subprocess.Popen, Path, Path]] = []
    try:
        for name in names:
            if not library_path(name).exists():
                jobs.append((name, *_start(name)))
        for name, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _declare(name, lib)
        _loaded[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "sched":
        lib.sched_events_launch.argtypes = [p, p, p, ctypes.c_longlong] + [p] * 6 + [i] * 4 + [p]
        lib.sched_events_launch.restype = i
        lib.sched_chain_probe_launch.argtypes = [p, p, i, i, p]
        lib.sched_chain_probe_launch.restype = i
    elif name == "ssd_scan":
        lib.ssd_scan_launch.argtypes = [p] * 11 + [i] * 8 + [p]
        lib.ssd_scan_launch.restype = i
        lib.ssd_scan_max_chunk.argtypes = []
        lib.ssd_scan_max_chunk.restype = i
    elif name == "ssd_scan_bwd":
        lib.ssd_scan_bwd_launch.argtypes = [p] * 17 + [i] * 8 + [p]
        lib.ssd_scan_bwd_launch.restype = i
        lib.ssd_scan_bwd_scratch_floats.argtypes = [i] * 7
        lib.ssd_scan_bwd_scratch_floats.restype = ctypes.c_longlong
    elif name == "flash_attention":
        lib.flash_attention_launch.argtypes = [p] * 5 + [i] * 12 + [f, p]
        lib.flash_attention_launch.restype = i
    elif name == "flash_attention_bwd":
        lib.flash_attention_bwd_launch.argtypes = [p] * 10 + [i] * 12 + [f, p]
        lib.flash_attention_bwd_launch.restype = i
    elif name == "decode_attention":
        lib.decode_attention_launch.argtypes = [p] * 7 + [i] * 12 + [f, p]
        lib.decode_attention_launch.restype = i
        lib.decode_attention_max_group.argtypes = []
        lib.decode_attention_max_group.restype = i
        lib.decode_attention_latent_launch.argtypes = [p] * 8 + [i] * 8 + [f, i, i, p]
        lib.decode_attention_latent_launch.restype = i


def ptxas_report(csrc: Path = CSRC, names: Iterable[str] = SOURCES) -> str:
    """The ``ptxas -v`` lines of each named source under ``csrc`` (its
    kernels' registers, stack frames and spill stores and loads), every
    source compiled at once with the build's flags into an object that is
    thrown away."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(name, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS[:-3], "-c", "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"{name}.o"), str(Path(csrc) / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for name in names]
        report = []
        for name, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
            keep = ("Compiling entry", "Function properties", "spill", "Used")
            report += [f"{name}: {line.strip()}" for line in log.splitlines()
                       if any(k in line for k in keep)]
    return "\n".join(report)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--ptxas"]:
        sys.exit("usage: python -m repro_torch.kernels.build --ptxas [CSRC_DIR]")
    print(ptxas_report(Path(sys.argv[2]) if len(sys.argv) > 2 else CSRC))
