"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

All sources compile with nvcc, for ``sm_90a`` (Hopper), into ONE shared
library with a plain C interface, bound with ctypes — seconds to build,
against minutes for an extension that includes PyTorch's headers.  Each
``.cu`` file compiles in an nvcc process of its own, all started
together, and one more links the objects.  The build runs at the first
launch (never at import), into ``_build/`` next to the package, under a
name keyed by the hash of every source and header so an edited file
never loads a stale library.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:class:`Kernel` raises on a non-zero code and counts successful
launches, which is how a run proves the serving path went through the
kernels.

Under a CUDA-graph capture a launch goes to the capturing stream (the
current stream, which :meth:`Kernel.launch` reads at each call) and is
recorded into the graph.  The counts, here and inside the library
(:func:`attention_body_launches`), grow when the host issues a launch:
at capture, once per kernel node, and never at a replay.  A graph's
replays are counted by its owner
(:class:`hmvit_tpu_torch.graph_server.CompiledServer`).  Call
:func:`load_library` before any capture: the build runs nvcc processes
and loads a shared library, neither of which a capture allows.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of hmvit_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhmvit_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists:
    one nvcc per source, all running at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            objects.append(obj)
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        logs = [proc.communicate()[0] for proc in procs]
        failed = [log for proc, log in zip(procs, logs) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        if verbose:
            print("\n".join(logs))
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
                               *objects], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        os.replace(lib, out)
    return out


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Build (once per process) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build(verbose)))
        return _lib


class Kernel:
    """One C entry point of the library plus its launch count.

    ``n_ptrs`` leading pointer arguments, then ``n_ints`` int arguments,
    then the stream; the C function returns a cudaError_t.
    ``launches`` counts the launches the host issued: a CUDA-graph
    capture adds one per captured launch, a replay adds none;
    ``launches_by_key`` splits them by the ``key`` a caller passes (the
    stripe and plain window attention kernels: (tokens T of a window,
    operand type))."""

    def __init__(self, symbol: str, n_ptrs: int, n_ints: int):
        self.symbol = symbol
        self.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                         + [ctypes.c_void_p])
        self.launches = 0
        self.launches_by_key = {}
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(load_library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, tensors, ints, key=None):
        """Launch on the current stream of the tensors' device.  The host
        work is kept to what the launch needs (the raw stream handle, the
        arguments as plain ints that ctypes converts by ``argtypes``, the
        device switched only when it is not the current one): for the
        smaller kernels it is most of the time of one call."""
        dev = tensors[0].device
        if dev.type != "cuda" or any(
                t.device != dev or not t.is_contiguous() for t in tensors):
            layout = [(str(t.device), t.is_contiguous()) for t in tensors]
            raise ValueError(f"{self.symbol}: tensors must be contiguous and "
                             f"on one CUDA device, got {layout}")
        fn = self._fn or self._bind()
        index = dev.index
        args = [t.data_ptr() for t in tensors] + [int(i) for i in ints]
        if index == torch.cuda.current_device():
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(dev):
                rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.symbol} failed to launch: "
                               f"cudaError {rc}")
        self.launches += 1
        if key is not None:
            self.launches_by_key[key] = self.launches_by_key.get(key, 0) + 1


PAIR_WARP = Kernel("hm_pair_warp", n_ptrs=4, n_ints=10)
PAIR_WARP_RESIDENT = Kernel("hm_pair_warp_resident", n_ptrs=4, n_ints=10)
STRIPE_WINDOW_ATTENTION = Kernel("hm_stripe_window_attention",
                                 n_ptrs=5, n_ints=9)
PLAIN_WINDOW_ATTENTION = Kernel("hm_plain_window_attention",
                                n_ptrs=5, n_ints=9)
TYPED_WINDOW_ATTENTION = Kernel("hm_typed_window_attention",
                                n_ptrs=8, n_ints=7)
WARP_WINDOW_ATTENTION = Kernel("hm_warp_window_attention",
                               n_ptrs=7, n_ints=9)
SEGMENTED_MAX_SCAN = Kernel("hm_segmented_max_scan", n_ptrs=3, n_ints=4)
EXPAND_ROWS = Kernel("hm_expand_rows", n_ptrs=4, n_ints=2)
EXPAND_ROWS_V2 = Kernel("hm_expand_rows_v2", n_ptrs=4, n_ints=2)
MS_DEFORM_ATTN = Kernel("hm_ms_deform_attn", n_ptrs=4, n_ints=16)
# The fp32 CUDA-core form of the four attention kernels for bfloat16
# operands that the entry points above send to the tensor cores: for
# timing the two side by side, never on the serving path.
STRIPE_WINDOW_ATTENTION_SIMT = Kernel("hm_stripe_window_attention_simt",
                                      n_ptrs=5, n_ints=9)
PLAIN_WINDOW_ATTENTION_SIMT = Kernel("hm_plain_window_attention_simt",
                                     n_ptrs=5, n_ints=9)
TYPED_WINDOW_ATTENTION_SIMT = Kernel("hm_typed_window_attention_simt",
                                     n_ptrs=8, n_ints=7)
WARP_WINDOW_ATTENTION_SIMT = Kernel("hm_warp_window_attention_simt",
                                    n_ptrs=7, n_ints=9)
SIMT_KERNELS = (STRIPE_WINDOW_ATTENTION_SIMT, PLAIN_WINDOW_ATTENTION_SIMT,
                TYPED_WINDOW_ATTENTION_SIMT, WARP_WINDOW_ATTENTION_SIMT)
# The previous body of the pair-warp kernel (one thread per 8 channels of
# a pixel, no tile skip), with the same output bits: for timing the two
# side by side and as the bit anchor of both pair-warp kernels on the
# card, never on the serving path.
PAIR_WARP_PREVIOUS = Kernel("hm_pair_warp_previous", n_ptrs=4, n_ints=10)
# The previous body of the segmented max-scan (one thread per (row, 8
# channels) looking back a row at a time), with the same output bits on
# rows whose id is >= 0: for timing and as the on-card bit anchor, never
# on the serving path.
SEGMENTED_MAX_SCAN_PREVIOUS = Kernel("hm_segmented_max_scan_previous",
                                     n_ptrs=3, n_ints=4)
KERNELS = {"pair_warp": PAIR_WARP,
           "stripe_window_attention": STRIPE_WINDOW_ATTENTION,
           "plain_window_attention": PLAIN_WINDOW_ATTENTION,
           "warp_window_attention": WARP_WINDOW_ATTENTION,
           "pair_warp_resident": PAIR_WARP_RESIDENT,
           "typed_window_attention": TYPED_WINDOW_ATTENTION,
           "segmented_max_scan": SEGMENTED_MAX_SCAN,
           "expand_rows": EXPAND_ROWS,
           "expand_rows_v2": EXPAND_ROWS_V2,
           "ms_deform_attn": MS_DEFORM_ATTN}


# in the order the library counts them
ATTENTION_KERNELS = ("stripe_window_attention", "plain_window_attention",
                     "typed_window_attention", "warp_window_attention")
ATTENTION_BODIES = ("simt", "mma")


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0
        k.launches_by_key = {}
    if _lib is not None:
        _lib.hm_attention_body_reset()


def attention_body_launches() -> dict[str, dict[str, int]]:
    """Launches of each window-attention kernel by the body that ran
    them, counted inside the library where the choice is made: "simt" is
    the fp32 CUDA-core body, "mma" the bfloat16 tensor-core body.  As
    :attr:`Kernel.launches`, counted at capture, not at replay."""
    if _lib is None:
        return {name: dict.fromkeys(ATTENTION_BODIES, 0)
                for name in ATTENTION_KERNELS}
    return {name: {body: _lib.hm_attention_body_launches(k, b)
                   for b, body in enumerate(ATTENTION_BODIES)}
            for k, name in enumerate(ATTENTION_KERNELS)}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
