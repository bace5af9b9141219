"""Device resolution and the build-on-first-use loader of the CUDA kernels.

The port's entry points run on the card: ``device`` defaults to ``"cuda"``
and a missing GPU is an error, never a silent fall back to the CPU. Only a
caller that passes ``device="cpu"`` gets the CPU, where the kernel wrappers
take their plain PyTorch versions. ``meta`` tensors (the dry-run's, an
explicit request for shapes without data) take the plain versions too
(``PLAIN_DEVICES``); a CUDA tensor launches its kernel or raises.

The kernels are CUDA C++ sources with a plain C interface under
``kernels/csrc/``. Each source is compiled by ``nvcc`` into its own shared
library under ``<checkout>/build/torch_kernels/`` (named by the source's
content hash, so an edited source is rebuilt) and loaded with ``ctypes``.
``build_kernels`` starts one ``nvcc`` per source, all at once, and reports
each to ``obs.compiled.CompileWatch``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from repro_torch.obs.compiled import CompileWatch

__all__ = ["resolve_device", "build_kernels", "kernel_library",
           "KERNEL_SOURCES", "BUILD_DIR", "PLAIN_DEVICES"]

# Device types whose tensors the LM kernel wrappers hand to the plain
# versions: the CPU's, and meta tensors (shapes, no data).
PLAIN_DEVICES = ("cpu", "meta")

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "kernels" / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "torch_kernels"
KERNEL_SOURCES = ("policy_cost", "hedge_replay", "learner_replay",
                  "flash_attention", "ssd_scan")

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
# No fused multiply-add contraction in the cost and learner kernels: they
# round like their plain versions, one IEEE operation at a time, and agree
# with them bit for bit. The attention and SSD kernels contract freely.
EXACT_SOURCES = ("policy_cost", "hedge_replay", "learner_replay")


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on; raises without a GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch runs on a CUDA GPU (device={str(device)!r}) and "
            "none is visible; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                       "the CUDA kernels are built from source at first use")


def _library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernels(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together. Returns ``{name: compiler output}`` for the sources
    built by this call (``-Xptxas=-v``: registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        exact = ("-fmad=false",) if name in EXACT_SOURCES else ()
        cmd = [_nvcc(), *NVCC_FLAGS, *exact, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
        CompileWatch.note_build()
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=len(KERNEL_SOURCES))  # one per source
def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``kernels/csrc/<name>.cu`` (built on
    first use)."""
    build_kernels((name,))
    return ctypes.CDLL(str(_library_path(name)))
