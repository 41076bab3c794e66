"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` into ``build/kernels/<name>-<source hash>.so`` at the root of the
checkout, at first use, and rebuilt whenever the source changes; the
library is then loaded with ``ctypes``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: List[str]) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns each compiler log (the
    ``-Xptxas -v`` register and spill report); raises if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(logs[name])
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(failed)
            + ":\n"
            + "\n".join(logs[f] for f in failed)
        )
    return logs


def build_log(name: str) -> str:
    """The compiler log of the named kernel's present library."""
    return library_path(name).with_suffix(".log").read_text()


def resource_lines(log: str) -> List[str]:
    """One line per compiled kernel from a ``-Xptxas -v`` log: its name
    (template arguments as <0,1,..>), registers, shared and constant
    memory, stack frame and spills."""
    out = []
    name = spill = ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            known = re.search(r"([a-z]+_kernel_[a-z_]+)(?:I((?:L[bi]\d+E)+)E)?", name)
            if known:
                name = known.group(1)
                if known.group(2):
                    flags = re.findall(r"L[bi](\d+)E", known.group(2))
                    name += "<" + ",".join(flags) + ">"
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
