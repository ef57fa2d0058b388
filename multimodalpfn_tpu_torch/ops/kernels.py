"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ctypes. The build runs at the
first launch, never at import, so every module imports on a machine without
``nvcc`` or a card. The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.

Each C entry point launches on the stream it is given (the caller passes
PyTorch's current stream), allocates nothing, does not synchronise, and returns
``cudaGetLastError()`` after its launches; `check` turns a non-zero code into
an exception. `LAUNCHES` counts, per kernel, the wrapper calls that launched
it on the card (the CPU path of a wrapper is its plain version and is not
counted).
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(
    os.environ.get(
        "MMPFN_TORCH_BUILD_DIR", Path(__file__).resolve().parents[2] / "build" / "kernels"
    )
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

# kernel id -> launches through its wrapper since the last reset
LAUNCHES: dict[str, int] = {
    "K1": 0, "K2a": 0, "K2b": 0, "K3": 0, "K4": 0, "K5": 0, "K6a": 0, "K6b": 0,
    "K7": 0, "K7s": 0, "K8": 0, "K9": 0, "K10": 0, "K11": 0,
}

# Rows of the weight-gradient contractions per block: each chunk's float32
# partial sums land in their own slab of a workspace, and a second kernel adds
# the slabs in order, so the sums are the same bits on every run (no atomics).
WGRAD_ROWS = 2048

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # (x, wqkv_t, wout, out, b, t, s, e, h, d, dtype, device, stream)
    "mmpfn_feat_attn_ln_im": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # (x, wqkv_t, wout, out, rows, t, e, h, d, token_valid, dtype, device, stream)
    "mmpfn_feat_attn_ln": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # (x, wqkv_t, wout, out, masks, b, t, s, e, h, d, dtype, device, stream)
    "mmpfn_feat_attn_ln_im_masked": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # (x, wqkv_t, wout, out, masks, rows, t, e, h, d, rows_per_member, dtype, device, stream)
    "mmpfn_feat_attn_ln_masked": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # (q, k, v, o, lse, G, Sq, Skv, d, scale, dtype, device, stream)
    "mmpfn_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # (x, w1, w2, out, rows, e, nhid, dtype, device, stream)
    "mmpfn_mlp_ln": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # (a, b, c, M, N, K, dtype, device, stream)
    "mmpfn_proj_nt": [_P, _P, _P, _L, _I, _I, _I, _I, _P],
    # (qkv, o, lse, G, S, sep, h, d, dtype, device, stream)
    "mmpfn_item_attn": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # (x, o, wout, out, rows, e, hd, dtype, device, stream)
    "mmpfn_item_epilogue_ln": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # (x, wqkv, wout, g, qkv, o, u, du, du_c, do, dqkv, dx, dwqkv, dwout, work,
    #  b, t, s, e, h, d, wgrad_rows, dtype, device, stream)
    "mmpfn_feat_attn_bwd_im": [_P] * 15 + [_I] * 7 + [_I, _I, _P],
    # (x, wqkv, wout, g, qkv, o, u, du, du_c, do, dqkv, dx, dwqkv, dwout, work,
    #  rows, t, e, h, d, wgrad_rows, dtype, device, stream)
    "mmpfn_feat_attn_bwd": [_P] * 15 + [_I] * 6 + [_I, _I, _P],
    # (q, k, v, o, lse, do, do_c, delta, dq, dk, dv, G, Sq, Skv, d, scale,
    #  dtype, device, stream)
    "mmpfn_flash_bwd": [_P] * 11 + [_I] * 4 + [_F, _I, _I, _P],
    # (x, w1, w2, g, gz, gzg, u, du, du_c, dz, dx, dw1, dw2, work,
    #  rows, e, nhid, wgrad_rows, dtype, device, stream)
    "mmpfn_mlp_ln_bwd": [_P] * 14 + [_L, _I, _I, _I, _I, _I, _P],
    # (x, wext, do, lse, delta, dx_epi, qkv, dqkv, dx, dwext, work,
    #  G, S, sep, h, d, e, wgrad_rows, dtype, device, stream)
    "mmpfn_item_attn_bwd": [_P] * 11 + [_I] * 7 + [_I, _I, _P],
    # (x, o, wout, g, u, du_c, do32, do, delta, dw, work,
    #  rows, s, e, h, d, wgrad_rows, dtype, device, stream)
    "mmpfn_item_epilogue_bwd": [_P] * 11 + [_L, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmmpfn_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile the kernels into `library_path()` unless it exists: one
    ``nvcc -c`` per source, all started together, then one link. The library
    is written to a temporary name and renamed, so concurrent builders never
    load a half-written file. ``verbose`` prints ptxas' per-kernel registers
    and shared memory."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        procs = []
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", str(Path(objdir) / f"{src.stem}.o"), str(src)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors, logs = [], []
        for src, proc in procs:
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                errors.append(f"{src.name} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        if verbose:
            print("".join(logs))
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        objs = sorted(str(o) for o in Path(objdir).glob("*.o"))
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mmpfn_error_string.argtypes = [ctypes.c_int]
            lib.mmpfn_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero code returned by a C entry point."""
    if rc != 0:
        msg = library().mmpfn_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: {msg})")


def launch_args(t: torch.Tensor, kernel: str) -> tuple[int, int, int]:
    """(dtype code, device index, PyTorch's current stream) — the trailing
    arguments of every C entry point."""
    return dtype_code(t, kernel), t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor, kernel: str) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{kernel}: dtype {t.dtype} is not supported (float32 or bfloat16)") from None


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it, starting on a 16-byte boundary (the kernels read
    weights with vector loads; a view into a stacked tensor may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require_shape(kernel: str, name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def wgrad_workspace(rows: int, m: int, n: int, device) -> torch.Tensor:
    """The float32 partial sums of an (m, n) weight gradient over ``rows``
    rows: one slab per `WGRAD_ROWS` rows."""
    slabs = max(1, -(-rows // WGRAD_ROWS))
    return torch.empty((slabs, m, n), dtype=torch.float32, device=device)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def forbid_autograd(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel without a backward kernel would be differentiated:
    on the card its result carries no gradient, and its plain version is not
    differentiated in its place."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel: it serves inference only (run it under "
            "torch.no_grad(), or on CPU tensors, where its plain version is differentiable)"
        )


def require_cuda(kernel: str, *tensors: torch.Tensor) -> None:
    """Every operand on the same CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{kernel}: operands must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
