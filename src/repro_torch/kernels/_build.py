"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, under ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), and loaded with ``ctypes``.  Every
C entry point takes ``void*`` pointers, ``int`` sizes and the CUDA
stream, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.

Libraries are named by a hash of their source and flags, so an edited
source is rebuilt and a stale library is never loaded.  ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

Kernels that need zeroed scratch shared by the calls of one stream (the
split-KV counters, the RG-LRU backward's sync words) take it from
:func:`workspace`, which never allocates inside a CUDA graph capture.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

# dtype codes shared with the C entry points
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_LIBS: dict = {}
_LOCK = threading.Lock()
build_seconds: dict = {}       # source stem -> seconds its nvcc took


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError("nvcc not found: the CUDA kernels need the "
                               "CUDA toolkit (looked on PATH and in "
                               "/usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)       # atomic: a concurrent loader sees all or none


def ptxas_usage(name: str, kernel: str) -> list:
    """What ``-Xptxas -v`` said of each instantiation of ``kernel`` in
    ``csrc/<name>.cu`` (built): [(template arguments, registers, shared
    memory bytes, spill store bytes, spill load bytes)]."""
    log = _lib_path(name).with_suffix(".log").read_text()
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            spills = (0, 0)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            args = ",".join(a or b for a, b in re.findall(
                r"Li(\d+)E|Lb(\d)E", cur.split(kernel, 1)[1]))
            rows.append((args, int(m.group(1)),
                         int(smem.group(1)) if smem else 0, *spills))
            cur = None
    return rows


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict:
    """Compile every kernel source (one ``nvcc`` each, all started
    together) and load them.  Returns {name: seconds nvcc took} for the
    sources that were built now."""
    with _LOCK:
        names = sources()
        started = {n: _start(n) for n in names}
        for n in names:
            _finish(n, started[n])
        for n in names:
            _load_built(n)
    return {n: build_seconds[n] for n in names if n in build_seconds}


def _load_built(name: str):
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def load_library(name: str):
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            _finish(name, _start(name))
            _load_built(name)
    return _LIBS[name]


def bind(name: str, fn: str, argtypes: list):
    """The C entry point ``fn`` of ``csrc/<name>.cu`` with its argtypes
    set (``c_void_p`` for pointers and the stream, ``c_int`` for sizes)."""
    f = getattr(load_library(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


#: {kernel: FLOPs} its wrapper stood for on meta tensors since the last
#: reset (``launch/dryrun.py`` adds them to what ``FlopCounterMode``
#: counts of the PyTorch operations around the kernels)
meta_flops: dict = {}


def on_meta(*tensors) -> bool:
    """Whether a wrapper was called on meta tensors (the dry run): it then
    launches nothing and returns empty meta outputs of the kernel's
    shapes, counting the kernel's FLOPs in :data:`meta_flops`."""
    return any(t is not None and t.is_meta for t in tensors)


def count_meta(name: str, flops) -> None:
    meta_flops[name] = meta_flops.get(name, 0) + int(flops)


def use_kernel(*tensors) -> bool:
    """Route of a wrapper call: True for CUDA tensors (the kernel), False
    for CPU tensors (the plain version).  Mixed or other devices raise."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_CAPTURE = threading.local()    # .stream: the stream a capture replays on
_OUTGROWN: list = []            # workspaces replaced by larger ones


@contextlib.contextmanager
def replay_stream(stream: int):
    """Inside the block :func:`workspace` hands out the buffers of
    ``stream``, the stream a CUDA graph captured in the block will replay
    on, in place of the capture stream's: the eager call before the
    capture made them, and the kernel leaves them zero, so the graph
    finds them zeroed at every replay."""
    _CAPTURE.stream = stream
    try:
        yield
    finally:
        _CAPTURE.stream = None


def workspace(table: dict, n: int, dtype, device, stream: int):
    """At least ``n`` zeroed elements of ``dtype`` that one kernel's calls
    on ``stream`` share (``table`` holds the kernel's buffers by device
    and stream; the stream orders the calls, and the kernel leaves the
    buffer zero).  Made once, or grown, outside any capture: a capture
    (:func:`replay_stream`) that would make one raises.  A buffer grown
    out stays allocated, as a captured graph may hold its address."""
    replay = getattr(_CAPTURE, "stream", None)
    if replay is not None:           # the legacy default stream is 0
        stream = replay
    key = (torch.device(device), stream)
    buf = table.get(key)
    if buf is None or buf.numel() < n:
        if key[0].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"a {n}-element kernel workspace would be made inside a CUDA "
                "graph capture: run the call once before capturing it")
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(n, dtype=dtype, device=device)
        table[key] = buf
    return buf


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
