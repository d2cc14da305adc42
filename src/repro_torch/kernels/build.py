"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``.
Libraries go to ``build/kernels/`` at the root of the checkout, named by
a hash of the sources and flags, so an unchanged kernel is built once
and a changed one is rebuilt.  :func:`build_all` starts one ``nvcc`` per
source at the same time and waits for all of them.

Nothing is built when this module is imported: the first launch of a
kernel (or an explicit :func:`build_all`) builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_attention", "q8_matmul", "q3k_matmul", "flash_prefill",
           "flash_decode", "q4_matmul", "q8_matmul_w8a8")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, tuple] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels are built on the machine with the card")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes at once.  Returns seconds per compiled name (0.0
    when it was already built); raises with the compiler's output on
    failure.  The ptxas report goes to ``<library>.log``."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        secs = {name: 0.0 for name in names}
        errors = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        return secs


def build_log(name: str) -> str:
    """The compiler's report (registers, shared memory, spills) for the
    current build of ``name``, or '' when it was not built here."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list):
    """``(lib, fn)`` for the C entry ``symbol`` of kernel ``name``, typed
    with ``argtypes`` (pointers and the stream as ``c_void_p``) and
    returning the CUDA error code as an int."""
    if symbol not in _entries:
        lib = load(name)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[symbol] = (lib, fn)
    return _entries[symbol]


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def launch(name: str, symbol: str, argtypes: list, device, *args) -> None:
    """Call the C entry ``symbol`` of kernel ``name`` with ``args`` and the
    current stream of ``device`` (a CUDA ``torch.device``) as its last
    argument, with that device current; raise on a CUDA error.  It takes
    the raw stream handle rather than building a ``torch.cuda.Stream``,
    and enters a device context only when another device is current: at
    decode shapes the host time of a call is the floor under a kernel's
    time on the main path."""
    lib, fn = entry(name, symbol, argtypes)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        code = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            code = fn(*args, stream)
    check(lib, symbol, code)


def aligned16(t):
    """``t`` contiguous with a 16-byte aligned start (the kernels' vector
    and cp.async copies), copying only when needed."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def expert_rows(t, align: int) -> tuple[torch.Tensor, int]:
    """An expert-major tensor (E, ...) as a 16-byte aligned buffer whose
    experts start ``stride`` elements apart, ``stride`` a multiple of
    ``align`` elements (16 bytes): ``(buffer, stride)``.  Copies into a
    padded buffer only when one expert's elements are not such a
    multiple."""
    t = aligned16(t)
    per = t[0].numel() if t.shape[0] else 0
    if per % align == 0:
        return t, per
    stride = -(-per // align) * align
    buf = torch.zeros((t.shape[0], stride), dtype=t.dtype, device=t.device)
    buf[:, :per] = t.reshape(t.shape[0], per)
    return buf, stride
