"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use, with its own ``nvcc`` process
(all started together), into ``build/repro_torch/<name>-<hash>.so`` at the
repository root, as a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o <lib> csrc/<name>.cu

The hash covers the source, every header in ``csrc/`` and the flags, so an
edited source rebuilds and an unchanged one loads the library already built.
Nothing here runs at import time: this module is imported on machines with
no CUDA toolkit, where only the kernels' plain versions run.

Every launch goes through :func:`launch`, which raises on a non-zero
``cudaError_t`` from the C entry and adds one to ``LAUNCHES[kernel]``
(``kernels.ops.LAUNCHES`` is the same counter).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: Kernel launches per kernel name, counted where each wrapper launches.
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C entry points per source: argument types (pointers and the stream as
#: c_void_p, or ctypes would cut them to 32 bits). Every entry returns the
#: launch's cudaError_t.
SIGNATURES = {
    "exemplar_eval": {
        "repro_fused_eval": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I,
                             _F, _F, _I, _I, _P],
        "repro_two_pass_eval": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                                _I, _F, _F, _I, _I, _P],
    },
    "marginal_gain": {
        "repro_gain_eval": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _F, _F,
                            _I, _I, _P],
        "repro_gain_update_eval": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                                   _F, _I, _F, _F, _I, _I, _P],
    },
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: Per source: seconds its build took in this process (0.0 when loaded from
#: an earlier build) and the compiler's resource report.
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of repro_torch build on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all in parallel. Raises with the compiler's output on a
    failed build. Returns :data:`BUILD_INFO`."""
    names = list(SIGNATURES) if names is None else list(names)
    with _LOCK:
        todo = [nm for nm in names
                if nm not in BUILD_INFO and not _lib_path(nm).exists()]
        for nm in names:
            if nm not in BUILD_INFO and nm not in todo:
                BUILD_INFO[nm] = {"seconds": 0.0, "log": ""}
        if not todo:
            return BUILD_INFO
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for nm in todo:
            out = _lib_path(nm)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{nm}.cu")]
            procs[nm] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out)
        failed = []
        for nm, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {nm}.cu (exit {proc.returncode})\n{log}")
                continue
            os.replace(tmp, out)
            BUILD_INFO[nm] = {"seconds": time.perf_counter() - t0, "log": log}
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return _LIBS[name]


#: Policy codes of the C entries (the template parameter P of csrc/tile.cuh).
POLICY_CODES = {"fp32": 0, "bf16": 1, "fp16": 2, "fp16_strict": 3}


def operand_code(dtype, policy) -> int:
    """C input-dtype code of the payload: float32, or the policy's own
    compute dtype (the kernels round to it in-tile either way)."""
    import torch

    if dtype == torch.float32:
        return 0
    if dtype == policy.compute_dtype:
        return {torch.float16: 1, torch.bfloat16: 2}[dtype]
    raise ValueError(
        f"kernel payload must be float32 or the {policy.name} compute dtype "
        f"{policy.compute_dtype}, got {dtype}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def launch(kernel: str, lib_name: str, fn: str, *args) -> None:
    """Call C entry ``fn`` of library ``lib_name``; raise if it reports a
    CUDA error, else count one launch of ``kernel``."""
    lib = library(lib_name)
    err = getattr(lib, fn)(*args)
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({err}: {msg})")
    LAUNCHES[kernel] += 1
