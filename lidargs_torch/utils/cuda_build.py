"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports a plain C interface and is compiled on its
own into `build/lidargs_torch/lib<name>-<hash>.so` beside the package, for
Hopper (`sm_90a`). The hash covers the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing is built
at import: the first CUDA call of a kernel's wrapper builds it, and
`build()` builds several at once, one nvcc process per source, all started
together.

`launches` counts every launch that `launch` made, under its symbol: the
one record of the port's kernel launches. A CUDA graph counts at capture
only; `train/graphs.py` `StaticProgram` adds its capture's count at each
replay.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lidargs_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict = {}
launches: collections.Counter = collections.Counter()     # symbol -> launches made


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    src = csrc / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for hdr in sorted(csrc.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names, csrc: Path = CSRC) -> dict[str, Path]:
    """Compile every named source of `csrc` (the package's own by default)
    that is not built yet, one nvcc process per source, all at once. Writes
    each compiler log (registers, shared memory, spills) beside its library
    as `<lib>.log`. Raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n, csrc) for n in names}
    procs = []
    for n, lib in out.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(csrc / f"{n}.cu")]
        procs.append((n, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, lib, tmp, p in procs:
        log, _ = p.communicate()
        lib.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)          # atomic: a concurrent build of the same source is harmless
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list):
    """(launch function `symbol`, `lidargs_cuda_error_string`) of
    `csrc/<name>.cu`, with `argtypes` declared on the first and an int
    result on both: every kernel library exports a launch function that
    returns the cudaError_t of its launch, and the function that names it."""
    key = (name, symbol)
    if key not in _entries:
        lib = load(name)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.lidargs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lidargs_cuda_error_string.restype = ctypes.c_char_p
        _entries[key] = (fn, lib.lidargs_cuda_error_string)
    return _entries[key]


def launch(name: str, symbol: str, scalar_types: list, tensors, scalars) -> None:
    """Launch `symbol` of `csrc/<name>.cu` on the current stream of the
    first tensor's device, with the tensors' data pointers, then `scalars`
    (declared as `scalar_types`), then the stream, and count it in
    `launches`. Raises, counting nothing, if the launch returns an error (a
    refused launch never runs, and a later synchronize would not report
    it)."""
    fn, err_str = entry(name, symbol, [ctypes.c_void_p] * len(tensors) + scalar_types
                        + [ctypes.c_void_p])
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: {err_str(err).decode()}")
    launches[symbol] += 1
