"""Build, load and launch the port's hand-written CUDA kernels.

The sources in `csrc/` have a plain C interface. At first use each is
compiled with `nvcc` for `sm_90a`, all at once in parallel, and the
objects are linked into one shared library in `build/torch_kernels/`
beside the package (listed in `.gitignore`), loaded with ctypes. The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt. There is no fallback: if `nvcc` or the card is missing,
`library()` raises.

Each wrapper that launches a kernel adds one to its entry of `LAUNCHES`
right where it launches, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# blend_probe.cu holds blend_probe_fwd (six modes), the two other blend
# probes a file each; the four pair-table kernels share pair_table.cu
SOURCES = ("tile_ranges_pack.cu", "blend_fwd.cu", "blend_fwd_export.cu", "blend_bwd.cu", "blend_probe.cu",
           "blend_probe_pair2.cu", "blend_probe_bwd.cu", "expand_gather.cu", "pair_table.cu")
# --fmad=false: no multiply-add contraction, so the kernels round each
# product and sum as the plain PyTorch versions do (parity first, speed later)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES = {
    "tile_ranges_pack": 0, "blend_fwd": 0, "blend_bwd": 0, "blend_fwd_export": 0,
    "blend_probe_fwd": 0, "blend_probe_fwd_pair2": 0, "blend_probe_bwd": 0, "expand_gather": 0,
    "realign_copy": 0, "window_gather_rows": 0, "window_gather_cols": 0, "xpose_cumsum": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # keys, order, pair_gid, table, M, ranges, gid_out, payload, stream
    "gsdf_tile_ranges_pack": (_P, _P, _P, _P, _L, _P, _P, _P, _P),
    # ranges, payload, M, num_tiles, grid_w, accum, log_t_eff, n_contrib,
    # ckpt, stream
    "gsdf_blend_fwd": (_P, _P, _L, _I, _I, _P, _P, _P, _P, _P),
    # ranges, payload, M, num_tiles, grid_w, log_exit, accum, log_t_eff,
    # n_contrib, ckpt, keep, stream
    "gsdf_blend_fwd_export": (_P, _P, _L, _I, _I, ctypes.c_float, _P, _P, _P, _P, _P, _P),
    # mismatches, stream: K4's live-range log1p against log1pf (a check,
    # not a kernel of the port)
    "gsdf_log1p_live_mismatches": (_P, _P),
    # ranges, payload, gid, M, num_tiles, grid_w, accum, n_contrib, ckpt,
    # ct_accum, ct_log_t_eff, grads, stream
    "gsdf_blend_bwd": (_P, _P, _P, _L, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # ranges, payload, M, num_tiles, grid_w, chunk, mode, accum, log_t_eff,
    # log_t_raw, n_done, stream
    "gsdf_blend_probe_fwd": (_P, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # ranges, payload, M, num_tiles, grid_w, chunk, accum, log_t_eff,
    # log_t_raw, n_done, stream
    "gsdf_blend_probe_fwd_pair2": (_P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P),
    # ranges, payload, M, num_tiles, grid_w, chunk, n_done, log_t_raw,
    # ct_accum, ct_log_t_eff, grads, stream
    "gsdf_blend_probe_bwd": (_P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    # table, lanes, g0, lr, MP, out, stream
    "gsdf_expand_gather": (_P, _L, _P, _P, _L, _P, _P),
    # tbl, ng, src, lanes, mpa, out, stream
    "gsdf_realign_copy": (_P, _I, _P, _L, _L, _P, _P),
    # ws, table, lanes, ranks, MP, win, cpc, out, stream
    "gsdf_window_gather_rows": (_P, _P, _L, _P, _L, _I, _I, _P, _P),
    "gsdf_window_gather_cols": (_P, _P, _L, _P, _L, _I, _I, _P, _P),
    # x, MP, scratch, scratch words, out, stream
    "gsdf_xpose_cumsum": (_P, _L, _P, _L, _P, _P),
}

_lib = None
build_info: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def build() -> Path:
    """Compile csrc/*.cu into one shared library unless it is already built:
    one `nvcc -c` per source, all started together, then one link."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    out = BUILD_DIR / f"libgsdf_torch_kernels-{h.hexdigest()[:16]}.so"
    if out.exists():
        log = out.with_suffix(".log")
        build_info.update(path=str(out), seconds=0.0, cached=True,
                          log=log.read_text() if log.exists() else "")
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}-{tag}.o" for s in SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)
        ]
        logs, failed = [], []
        for s, p in zip(SOURCES, procs):
            logs.append(p.communicate()[0])
            if p.returncode != 0:
                failed.append(f"{s} ({p.returncode})")
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    log += res.stdout + res.stderr
    # kept beside the library, for the ptxas lines of a later cached load
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=secs, cached=False, log=log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use). Raises without nvcc."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def runs_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version), False for a CUDA
    tensor (launch the kernel). Any other device raises."""
    kind = t.device.type
    if kind == "cpu":
        return True
    if kind == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`
    (a -1 in `shape` matches any size)."""
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s != -1 and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(entry: str, *args) -> None:
    """Call a C entry on the current stream; raise on a CUDA error."""
    fn = getattr(library(), entry)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


def ptxas_usage(log: str) -> dict[str, dict]:
    """Registers, spill bytes and shared memory of each kernel, from the
    `-Xptxas=-v` lines of a build log: {kernel name: {"registers",
    "spill_stores", "spill_loads", "smem"}}, the name read from the
    mangled entry, a template's instance named with its mangled arguments
    (`probe_fwd_kernel<Li4E>`)."""
    out: dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # _ZN<n>_GLOBAL__N__<hash>_<n>_<file>_cu_<8 hex><len><name>[I<args>E]...
            mangled = m.group(1)
            k = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            if k:
                cut = k.end() + int(k.group(1))
                cur = mangled[k.end(): cut]
                if mangled[cut:].startswith("I"):
                    cur += f"<{mangled[cut + 1: mangled.index('E', cut) + 1]}>"
            else:
                cur = mangled
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(m.group(1)) if m else 0
    return out
