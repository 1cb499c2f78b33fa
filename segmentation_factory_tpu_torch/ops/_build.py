"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/torch_kernels/<name>-<hash>.so``
at the root of the checkout. The hash covers the source, the shared
headers and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. ``build()`` starts one ``nvcc`` per source at once.
A failed build raises; nothing falls back to the plain versions.

``register_op`` defines the forward kernels as operators of the ``sft``
namespace of one ``torch.library.Library``, each with three
implementations: the kernel for CUDA tensors, the plain version for CPU
ones and a fake one (an empty output) for ``torch.export``'s tracing. The
wrappers call them without a gradient. ``torch.library.custom_op`` would
define the same operators behind more Python layers, which cost about four
times this route's host time a call on the card's host (PERF.md §6).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("sra_attention", "sra_attention_bwd", "mixffn", "mixffn_bwd", "resize_sum",
           "resize_sum_bwd", "lowres_loss", "resize_argmax", "attn_block", "head_tail", "ms_deform_attn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# dtype codes shared with csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LIBRARY = torch.library.Library("sft", "DEF")  # the registered ops; alive as long as the module
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of segmentation_factory_tpu_torch cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, str]:
    """Compile every source in ``names`` that has no library for its
    current hash, one ``nvcc`` each, all started together. Returns the
    compiler output per compiled source (ptxas register and shared-memory
    report when ``verbose``)."""
    jobs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def function(lib_name: str, fn_name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``fn_name`` of ``csrc/<lib_name>.cu``, built and
    loaded on first use and typed once; it returns a ``cudaError_t`` as
    int."""
    fn = _FUNCS.get((lib_name, fn_name))
    if fn is not None:
        return fn
    with _LOCK:
        lib = _LIBS.get(lib_name)
        if lib is None:
            build([lib_name])
            lib = ctypes.CDLL(str(_target(lib_name)))
            lib.sft_error_string.argtypes = [ctypes.c_int]
            lib.sft_error_string.restype = ctypes.c_char_p
            _LIBS[lib_name] = lib
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(lib_name, fn_name)] = fn
    return fn


def launch(lib_name: str, fn_name: str, argtypes: Sequence, *args) -> None:
    """Call a kernel's C entry and raise on the ``cudaGetLastError()`` it
    returns (a refused launch never runs and a later synchronize would not
    report it)."""
    code = function(lib_name, fn_name, argtypes)(*args)
    if code != 0:
        msg = _LIBS[lib_name].sft_error_string(code).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {code} ({msg})")


def check_cuda(t: torch.Tensor, name: str, shape=None, dtype=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of float32 or
    bfloat16 (or ``dtype``), 16-byte aligned, of ``shape`` if given."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    allowed = (dtype,) if dtype is not None else tuple(DTYPE_CODE)
    if t.dtype not in allowed:
        raise TypeError(f"{name}: dtype {t.dtype} not in {allowed}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer must be 16-byte aligned")


def register_op(schema: str, cuda: Callable, cpu: Callable, fake: Callable):
    """Define ``sft::<schema>`` with ``cuda`` (the kernel), ``cpu`` (the
    plain version) and ``fake`` (an empty output of the right shape and
    dtype, never reading data) as its implementations; returns the op.
    Everything that reads a data pointer or a size as a Python int stays in
    ``cuda``, which fake tensors never reach."""
    name = schema.split("(")[0]
    LIBRARY.define(schema)
    LIBRARY.impl(name, cuda, "CUDA")
    LIBRARY.impl(name, cpu, "CPU")
    torch.library.register_fake(f"sft::{name}", fake, lib=LIBRARY)
    return getattr(torch.ops.sft, name).default


def check_device(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t`` is on the card or the CPU: a registered op would
    run its fake implementation on any other device (``meta``), and the
    wrappers take no device but those two."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: expected a CUDA tensor (or a CPU one, for the plain "
                         f"version), got {t.device}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def refuse_grad(name: str, *tensors) -> None:
    """Raise if a CUDA tensor of an op without a backward kernel needs a
    gradient: the kernel's output would carry none, and autograd would
    drop it without an error."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward kernel; call it under torch.no_grad()")


VOIDP = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
