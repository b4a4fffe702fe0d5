"""Device, precision policy and the hand-written CUDA kernel loader.

Precision: TF32 would quantize the band FIR bank and the decimator input
inside cuDNN convolutions (the same class of fault as a reduced-precision
matrix pass quantizing the signal), so it is switched off for matmuls and
convolutions, and float32 matmuls run at "highest" precision.  The policy is
applied once, when the package is imported.

Kernels: each ``csrc/*.cu`` is compiled with ``nvcc`` on first use, all
in parallel, into the git-ignored ``_build/`` directory and linked as one
shared library with a plain C interface, loaded with ``ctypes``.  The build needs nothing outside the
package.  No compiler is looked for and nothing is built on import.
"""
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# -fmad=false: every kernel keeps the operation order of its plain PyTorch
# twin, whose elementwise ops each round separately; products that must be
# fused (the refinement's two-product) call fma() explicitly.
# No --use_fast_math: the refinement windows need correctly rounded cos.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false"]
# compile only: ptxas prints each kernel's registers, shared memory and
# spills, kept beside the library (kernel_resources)
PTXAS_REPORT = "-Xptxas=-v"


class LaunchCounter:
    """Launches of one CUDA kernel: its wrapper adds one where it launches
    the kernel, and nowhere else (the plain version does not count).
    Wrappers on several threads (one per device) count into the same
    ``launches``.

    A wrapper called while its thread's stream is being captured into a
    CUDA graph launches nothing: it adds to the thread's ``captured()``
    tally instead, and the graph adds what it captured to ``launches`` at
    each replay (:class:`..parallel.graphs.GraphCache`)."""

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def add(self, n: int = 1):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            self._local.captured = self.captured() + n
            return
        with self._lock:
            self.launches += n

    def captured(self) -> int:
        """The wrapper calls this thread has made under capture so far."""
        return getattr(self._local, "captured", 0)


# What one analysis stage may hold alive in temporaries before it blocks its
# work (bands, output samples, frames, voiced sections): 1 GiB, 1/80 of an
# 80 GB card's memory, so that a stage's leftovers, the allocator's cache
# and the stages after it stay far inside the card at any length.  The
# stages size their blocks from the shapes they are given, batch included.
STAGE_BYTES_BUDGET = 2 ** 30


def chunk_size(unit_bytes: int, count: int, budget: int = STAGE_BYTES_BUDGET):
    """How a stage whose temporaries hold ``unit_bytes`` for each of ``count``
    independent units (bands, samples, frames, sections) blocks its work:
    None where the whole fits ``budget``, else the units of one chunk.  A
    chunk gets half of the budget: the stage's result, which grows while
    the chunks run, and the chunks' own leftovers have the other half."""
    if unit_bytes * count <= budget:
        return None
    return max(1, budget // 2 // unit_bytes)

# float64's machine epsilon: the reference's guards add or floor at it, and
# the port keeps it in every working type (float32's own eps, 1.2e-7, lies
# above much of a speech spectrum).
F64_EPS = 2.220446049250313e-16


def resolve_device(device=None) -> torch.device:
    """``device``, or the GPU when it is None.  Without a GPU that raises:
    a run on the CPU is asked for by name, never fallen back to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: world_tpu_torch runs on the GPU "
                           "by default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def torch_dtype(dtype) -> torch.dtype:
    """Accept a torch dtype or a numpy-style name ("float32", "float64")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float64": torch.float64}[str(dtype)]


def scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim tensor of ``like``'s dtype on ``like``'s device."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def rdiv(v: float, x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded ``v / x``.  ``v / x`` with a Python ``v`` is
    ``x.reciprocal() * v`` in PyTorch, and a CUDA tensor divided by a Python
    scalar is multiplied by the scalar's reciprocal: both round twice."""
    return torch.div(scalar(v, x), x)


def sdiv(x: torch.Tensor, v: float) -> torch.Tensor:
    """The correctly rounded ``x / v`` on every device (see :func:`rdiv`)."""
    return torch.div(x, scalar(v, x))


def check_kernel_input(t: torch.Tensor, name: str, dtype: torch.dtype,
                       device: torch.device, ndim: int):
    """Raise unless ``t`` is a contiguous CUDA tensor of the kernel's type."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _library_path() -> Path:
    """The library's path in the build directory, named by a digest of the
    sources and the flags."""
    digest = hashlib.sha256()
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + [PTXAS_REPORT]).encode())
    return BUILD_DIR / f"libworld_kernels_{digest.hexdigest()[:16]}.so"


_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def kernel_library():
    """Build (once per source content) and load the kernel library.

    Returns ``(lib, build_seconds)``; build_seconds is 0.0 when an up-to-date
    library was already on disk.  Threads that ask together (one per device)
    wait for the one that builds."""
    with _BUILD_LOCK:
        return _build_and_load()


def _build_and_load():
    BUILD_DIR.mkdir(exist_ok=True)
    lib_path = _library_path()
    seconds = 0.0
    if not lib_path.exists():
        # one nvcc per source, all started together, then one link
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, PTXAS_REPORT, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        runs = []
        for proc in procs:
            out, err = proc.communicate()
            runs.append((proc.args, proc.returncode, out, err))
        if all(rc == 0 for _, rc, _, _ in runs):
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            runs.append((link.args, link.returncode, link.stdout, link.stderr))
        seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink(missing_ok=True)
        for args, rc, out, err in runs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(args)}\n"
                                   f"{out}\n{err}")
        # ptxas -v of each source: registers, shared memory and spills
        lib_path.with_suffix(".ptxas.txt").write_text(
            "".join(out + err for _, _, out, err in runs[:len(objs)]))
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"world_event_engine_{suffix}")
        # x, rows, n, tq, Q, pnum, qden, fs, tile, cap, pos, rank, tile_count,
        # out_f0, out_m, stream
        fn.argtypes = [P, I, I, P, I, I, I, D, I, I, P, P, P, P, P, P]
        fn.restype = I
        fn = getattr(lib, f"world_refine_dft_{suffix}")
        # seg, phase, f0, C, F, W, max_half, S, cos_tab, sin_tab, fs,
        # f0_floor, f0_ceil, out, stream
        fn.argtypes = [P, P, P, I, I, I, I, I, P, P, D, D, D, P, P]
        fn.restype = I
        fn = getattr(lib, f"world_extension_scan_{suffix}")
        # base, flags, limits, cands, rows, C, n, backward, allowed, out, stream
        fn.argtypes = [P, P, P, P, I, I, I, I, D, P, P]
        fn.restype = I
        fn = getattr(lib, f"world_extend_chains_{suffix}")
        # f0, origin, last, shift, cands, B, R, C, n, n_steps, allowed,
        # pos, val, act, shifted, stream
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, D, P, P, P, P, P]
        fn.restype = I
        fn = getattr(lib, f"world_merge_sections_{suffix}")
        # f0, cands, scores, starts, ends, val, act, order, st, ed, keep,
        # B, C, n, S, n_steps, c, f0_m, cur_st, cur_ed, started, stream
        fn.argtypes = [P] * 11 + [I] * 6 + [P] * 5
        fn.restype = I
        fn = getattr(lib, f"world_d4c_centroid_{suffix}")
        # slab, f0, t, twiddles, R, Ws, max_half, margin, N, fs, out, stream
        fn.argtypes = [P, P, P, P, I, I, I, I, I, D, P, P]
        fn.restype = I
        fn = getattr(lib, f"world_d4c_band_ap_{suffix}")
        # slab, centroid, f0, t, twiddles, window, band_first, R, Ws,
        # max_half, margin, N, fs, n_ap, wl, top_k, span, out, stream
        fn.argtypes = [P] * 7 + [I] * 5 + [D] + [I] * 4 + [P, P]
        fn.restype = I
        fn = getattr(lib, f"world_d4c_clusters_{suffix}")
        # N, max_half, span, rows, K6's blocks a frame (out), K7's (out)
        fn.argtypes = [I, I, I, I, P, P]
        fn.restype = I
        fn = getattr(lib, f"world_pulse_plan_{suffix}")
        # N, max_noise, grid (out), shared memory bytes (out), scratch items
        # a block (out)
        fn.argtypes = [I, I, P, P, P]
        fn.restype = I
        fn = getattr(lib, f"world_pulse_responses_{suffix}")
        # sp, ap, count, f1, f2, wa, wb, voiced, phase_step, gain, n_noise,
        # noise, dc_base, twiddles, B, P, F, N, max_noise, p_lo, p_hi,
        # p_own_hi, resp, scratch, live, stream
        fn.argtypes = [P] * 14 + [I] * 8 + [P] * 4
        fn.restype = I
        fn = getattr(lib, f"world_pulse_ola_{suffix}")
        # resp, starts, count, B, P, N, y_length, max_rank, p_lo, p_own_hi,
        # rows, y, stream
        fn.argtypes = [P, P, P] + [I] * 8 + [P, P]
        fn.restype = I
    return lib, seconds


def kernel_resources() -> list:
    """What ptxas reported for each kernel of the built library: one dict
    per entry function with its mangled ``name``, ``registers``,
    ``smem_bytes`` (static; dynamic shared memory is sized at launch),
    ``stack_bytes`` (local memory), ``spill_stores`` and ``spill_loads``
    (bytes)."""
    kernel_library()
    report = _library_path().with_suffix(".ptxas.txt").read_text()
    out, props = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            props = {"name": m.group(1), "registers": None, "smem_bytes": 0,
                     "stack_bytes": 0, "spill_stores": 0, "spill_loads": 0}
            out.append(props)
            continue
        if props is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            (props["stack_bytes"], props["spill_stores"],
             props["spill_loads"]) = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            props["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            props["smem_bytes"] = int(s.group(1)) if s else 0
    return out


# what a launcher returns for a geometry its kernel cannot hold: more
# dynamic shared memory than a block may opt in to (cudaFuncSetAttribute's
# cudaErrorInvalidValue) or a grid past its extents
# (cudaErrorInvalidConfiguration).  The launchers size shared memory and the
# grid from the shapes; nothing here repeats that sizing.
_GEOMETRY_ERRORS = (1, 9)


class KernelGeometryError(ValueError):
    """A kernel was asked for shapes it cannot hold; nothing was launched."""


def launch(name: str, dtype: torch.dtype, *args):
    """Call ``world_<name>_<f32|f64>`` on the current CUDA stream and raise on
    a launch error (the C function returns the CUDA error's code):
    :class:`KernelGeometryError` where the shapes are at fault, for the
    wrapper to name them, RuntimeError otherwise.

    Under CUDA graph capture the launchers' ``cudaFuncSetAttribute`` and
    occupancy queries are legal (they touch no stream), and their
    ``cudaGetLastError`` clears only the thread's last error: a capture
    that a launch voided stays voided on its stream, and the launch's code
    raises here, so the capture fails with it."""
    lib, _ = kernel_library()
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    # the current stream's handle, without building a torch.cuda.Stream
    # (that costs several microseconds a call, as much as a small kernel)
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    err = getattr(lib, f"world_{name}_{suffix}")(*args, stream)
    if err in _GEOMETRY_ERRORS:
        raise KernelGeometryError(f"world_{name}_{suffix}: cudaError {err}")
    if err != 0:
        raise RuntimeError(f"CUDA kernel world_{name}_{suffix} failed to "
                           f"launch: cudaError {err}")
