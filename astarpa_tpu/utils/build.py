"""Builds of the repository's native libraries, on the host that loads them.

Every library is compiled from tracked sources into
``<repo>/build/<name>/<key>/`` (gitignored), where ``key`` hashes the
sources, the compiler flags, the compiler's version and, for host code
tuned to the CPU, the host CPU's identity.  A library built on another
machine, or from other sources, therefore never matches and is never
loaded: the first use on a new host builds its own.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_ROOT = REPO_ROOT / "build"
# One build at a time per process: threads that ask for the same library
# wait for the first build instead of racing it on the same file.
_build_lock = threading.Lock()


def host_cpu_id() -> str:
    """Model name and feature flags of this host's CPU (Linux), else the
    machine and processor names."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        text = ""
    keep = []
    for key in ("model name", "flags"):
        for line in text.splitlines():
            if line.startswith(key):
                keep.append(line.split(":", 1)[1].strip())
                break
    return "\n".join(keep) or f"{platform.machine()} {platform.processor()}"


def tool_version(tool: str) -> str:
    """First line of ``tool --version``; raises RuntimeError if the tool
    is missing."""
    try:
        out = subprocess.run([tool, "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"{tool} is not usable here: {exc}") from exc
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def build_key(sources, flags, version: str, host: str = "") -> str:
    """Hex digest over the sources' bytes, the flags, the compiler version
    and the host identity."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).name.encode() + b"\0" + Path(src).read_bytes())
    for part in (*flags, version, host):
        h.update(b"\0" + str(part).encode())
    return h.hexdigest()[:16]


def build_library(name: str, key: str, compile_to) -> Path:
    """Path of ``lib<name>.so`` for ``key``, building it first if absent.

    ``compile_to(path)`` writes the library to ``path``; the result is
    moved into place atomically, so concurrent processes never load a
    half-written file, and threads of one process build it once.
    """
    out = BUILD_ROOT / name / key / f"lib{name}.so"
    with _build_lock:
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.part{os.getpid()}")
        try:
            compile_to(tmp)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out
