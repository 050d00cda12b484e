"""Build the port's CUDA kernels from ``csrc/`` and bind them with ctypes.

One ``nvcc`` per ``csrc/*.cu``, all started together, compiles the sources
to objects, and one more links them into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds). The library
lands in ``raw2film_tpu_torch/_build/``, named by a hash of the
sources and flags, so a stale build is never loaded. It is built at first
use, inside the process that needs it; nothing is compiled at import.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.

Dispatch rule of every kernel wrapper (:func:`use_kernel`): a tensor on the
CPU takes the wrapper's plain PyTorch version; a CUDA tensor launches the
kernel or raises. The one exception is :func:`plain_reference`, an explicit
reference mode that runs the plain versions on the card so that a caller
can compare a whole render against them.
"""

from __future__ import annotations

import collections.abc
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from raw2film_tpu_torch.utils import trace

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# The main path's kernels. Each wrapper counts ``launch.<kernel>`` (in
# ``utils/trace.py``) where it launches its kernel, and nowhere else.
KERNELS = (
    "demosaic", "half_size", "pyramid_down", "sep_rank", "sep_rank_narrow", "pyramid_up_rows",
    "pyramid_up", "halation", "grain_apply", "grain_apply_bw", "grain_field", "conv_w", "conv_h",
    "print_encode", "exposure_sample", "develop",
)


class _Launches(collections.abc.MutableMapping):
    """Launch counts by kernel: a view of the ``launch.<kernel>`` running
    totals of ``utils/trace.py``, the one store."""

    def __getitem__(self, kernel: str) -> int:
        if kernel not in KERNELS:
            raise KeyError(kernel)
        return trace.COUNTS.get("launch." + kernel, 0)

    def __setitem__(self, kernel: str, n: int) -> None:
        if kernel not in KERNELS:
            raise KeyError(kernel)
        trace.COUNTS["launch." + kernel] = n

    def __delitem__(self, kernel: str) -> None:
        raise TypeError("a launch count is set, not deleted")

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self) -> int:
        return len(KERNELS)


launches = _Launches()

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    "r2f_demosaic": (_P, _I, _P, _I, _I, _I, _I, _I, _F, _F, _P, _I, _P),
    "r2f_half_size": (_P, _I, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    "r2f_exposure_sample": (_P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P, _I, _I, _P),
    "r2f_sep_rank": (_P, _P, _P, _P, _P, _P, _P),
    "r2f_hash_words": (_P, _P, _I, _I, _I, _I, _I, _U, _U, _P),
    "r2f_print_encode": (
        _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "r2f_box_downsample": (_P, _P, _I, _I, _I, _I, _F, _I, _P),
    "r2f_upsample_rows": (_P, _P, _I, _I, _I, _I, _P, _I, _P),
    "r2f_upsample": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
    "r2f_grain_apply": (_P, _P, _I, _I, _I, _I, _U, _U, _P, _P, _I, _I, _P),
    "r2f_grain_field": (_P, _I, _I, _I, _U, _U, _P, _I, _I, _P),
    "r2f_conv1d": (_P, _P, _I, _I, _I, _P, _P, _I, _I, _P),
    "r2f_halation": (_P, _P, _P, _P, _P, _P, _P),
    "r2f_develop": (_P, _P, _P, _I, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_mode = threading.local()
build_log = ""


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f)
        for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libr2f_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is missing; returns its path. The
    compiler's register and spill report is kept in ``build_log``. A
    compile is recorded as the span and counter ``kernels.build``."""
    out = library_path()
    if os.path.exists(out):
        return out
    with trace.stage_timer("kernels.build"):
        trace.count("kernels.build")
        _compile(out)
    return out


def _compile(out: str) -> None:
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in cus]
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, cu], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for cu, o in zip(cus, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    try:
        for cu, p, log in zip(cus, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {cu} ({p.returncode}):\n{log}")
        res = subprocess.run([_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs],
                             capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use; the load is recorded
    as the span ``kernels.load``."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock, trace.stage_timer("kernels.load"):
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.r2f_error_string.argtypes = [ctypes.c_int]
            handle.r2f_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().r2f_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device. PyTorch's own
    raw query (the one its generated kernels use) costs a fraction of
    ``torch.cuda.current_stream(...).cuda_stream``, which builds a Stream
    object on every call: on a small launch that was a quarter of the
    wrapper's host time."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


@contextlib.contextmanager
def plain_reference():
    """Run every kernel wrapper's plain version, also on CUDA tensors (this
    thread only). For checking the kernels against the plain path; it is
    never entered on the main path."""
    old = getattr(_mode, "plain", False)
    _mode.plain = True
    try:
        yield
    finally:
        _mode.plain = old


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensor). False: the plain version (CPU
    tensor, or inside :func:`plain_reference`). Other devices raise."""
    if t.is_cuda:
        return not getattr(_mode, "plain", False)
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def use_kernel_on(device) -> bool:
    """:func:`use_kernel` for a kernel that takes no input tensor (the grain
    field): the device its output goes to decides."""
    device = torch.device(device)
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return not getattr(_mode, "plain", False)


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Check what a kernel takes: dtype, shape, contiguity, device."""
    if (t.dtype is dtype and shape is None and t.is_cuda and t.is_contiguous()
            and t.get_device() == torch._C._cuda_getDevice()):
        return  # the common case, in few steps: small launches feel every microsecond
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    device = t.device
    if device.type != "cuda":
        raise ValueError(f"{name}: on {device}, want a CUDA device")
    current = torch._C._cuda_getDevice()  # CUDA is up: t lives there
    if device.index != current:
        raise ValueError(f"{name}: on {device}, but the current device is cuda:{current}")
