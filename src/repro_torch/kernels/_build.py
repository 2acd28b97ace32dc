"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes) and loaded with ``ctypes``.  The library is built at first use
into ``build/repro_torch_kernels/`` at the repository root, under a name
keyed by a hash of the sources and flags, so a changed source rebuilds
and an unchanged one is loaded as it is.  The sources compile in
parallel, one ``nvcc`` process each, then link once.

Nothing here runs when a module is imported: the CPU tests import every
module on machines that have no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None     # wall time of the last build
ptxas_log: str = ""                    # register / smem report of it


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    return "nvcc"


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out: pathlib.Path) -> None:
    global build_seconds, ptxas_log
    t0 = time.perf_counter()
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = out.parent / f"{src.stem}-{out.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for src, p in zip(_sources(), procs):
        log, _ = p.communicate()
        logs.append(log)
        if p.returncode != 0:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    ptxas_log = "\n".join(logs)


def _declare(lib: ctypes.CDLL) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rt_fused_check.restype = I
    lib.rt_fused_check.argtypes = [
        P, LL, I, P, P, P,              # adj, adj stride, n_adj, mask,
        #                                 nmask, idx
        P, P, I, I,                     # q, p, kind, split
        P, P, P, P, P,                  # viol, full, part, nz, counts
        I, I, I, I, I, P]               # batch, n, w, threads, group, stream
    lib.rt_fused_select.restype = I
    lib.rt_fused_select.argtypes = [
        P, LL, I, P, P, P, I,           # adj, adj stride, n_adj, mask, idx,
        #                                 act, kind
        P, P,                           # out idx, out val
        I, I, I, I, I, P]               # batch, n, w, threads, group, stream
    lib.rt_intersect_count.restype = I
    lib.rt_intersect_count.argtypes = [
        P, LL, I, P, P, P,              # adj, adj stride, n_adj, mask, idx,
        #                                 counts
        I, I, I, I, I, P]               # batch, n, w, threads, group, stream
    lane_args = [
        P, P, P, P, P, P, I,            # scal_in, adj, order, rank, rc, lroot,
        #                                 ctx_batched
        P, P, P, P, P, P, P, P, P,      # tasks, lmask..out_r (inputs)
        P, P, P, P, P, P, P, P, P,      # scal, lmask..out_r (outputs)
        I, I, I, I, I, I, I, I, I,      # nu, wu, wv, depth, cap, t_len,
        #                                 m_real, order_mode, spc
        I, I, I, I, P]                  # threads, group, stage_adj, smem,
        #                                 stream
    lib.rt_resident_step.restype = I
    lib.rt_resident_step.argtypes = list(lane_args)
    lib.rt_resident_pool.restype = I
    lib.rt_resident_pool.argtypes = [P] + lane_args[:-1] + [I, P]
    #                                 board first, then lanes before stream
    lib.rt_flash_fwd.restype = I
    lib.rt_flash_fwd.argtypes = [
        P, P, P, P, P, I,               # q, k, v, o, lse, dtype
        I, I, I, I, I, I, I,            # heads, G, Sqp, Skp, sq, sk, hd
        ctypes.c_float, I, P]           # scale, causal, stream
    bwd_tail = [I, I, I, I, I, I, I,   # dtype, heads, G, Sqp, Skp, sq, sk
                I, ctypes.c_float, I, P]  # hd, scale, causal, stream
    lib.rt_flash_bwd_dq.restype = I
    lib.rt_flash_bwd_dq.argtypes = [
        P, P, P, P, P, P, P] + bwd_tail  # q, k, v, do, lse, dD, dq
    lib.rt_flash_bwd_dkv.restype = I
    lib.rt_flash_bwd_dkv.argtypes = [
        P, P, P, P, P, P, P, P] + bwd_tail  # q, k, v, do, lse, dD, dk, dv
    lib.rt_flash_bwd_fused.restype = I
    lib.rt_flash_bwd_fused.argtypes = [
        P, P, P, P, P, P, P, P, P,       # q, k, v, do, lse, dD, dq_acc, dk, dv
        I] + bwd_tail[1:]                # lse / dD row pitch, then as above
    lib.rt_flash_bwd_fused_smem.restype = I
    lib.rt_flash_bwd_fused_smem.argtypes = [I]     # hd
    lib.rt_error_string.restype = ctypes.c_char_p
    lib.rt_error_string.argtypes = [I]


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            out = BUILD_DIR / f"librepro_torch_{_digest()}.so"
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            _declare(lib)
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().rt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int | None:
    """Device address of an optional tensor operand (None -> NULL)."""
    return None if t is None else t.data_ptr()
