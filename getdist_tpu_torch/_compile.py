"""Compile a shared library from source at first use, once per source hash.

Both of the port's compiled parts build through :func:`build_once`: the
host C++ pass of ``_native`` (``g++``) and the CUDA kernels of
``ops/_cuda`` (``nvcc``). The library is named by a hash of its sources
and flags, so an edited source builds a new one, and it is written under
a name of the building process and then moved into place, so processes
that build at once never load a partial library. Nothing here runs at
import time.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

__all__ = ["build_once"]


def _start(cmd, name):
    try:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as err:
        raise RuntimeError(f"{Path(cmd[0]).name} could not run to build {name}: {err}") from err


def build_once(name, sources, flags, build_dir, steps):
    """``(path, seconds, log)`` of ``build_dir/lib<name>_<hash>.so``, the
    hash over ``sources`` and ``flags``; built first when it is missing
    (``seconds`` 0.0 and ``log`` empty when it was not).

    ``steps(out, tag)`` returns ``(commands, scratch)``: ``commands`` a
    list of steps run in order, each a list of commands (argument lists)
    started together, the last writing the library to ``out``; ``tag`` a
    string unique to this build and process for intermediate files, which
    ``scratch`` lists and which are removed afterwards. A command that
    fails raises ``RuntimeError`` with its output."""
    sources = [Path(s) for s in sources]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources) + " ".join(flags).encode()).hexdigest()[:16]
    path = Path(build_dir) / f"lib{name}_{digest}.so"
    if path.exists():
        return path, 0.0, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    commands, scratch = steps(tmp, f"{digest}.{os.getpid()}")
    t0 = time.perf_counter()
    logs = []
    try:
        for step in commands:
            procs = [_start(cmd, name) for cmd in step]
            outs = [proc.communicate()[0] for proc in procs]
            logs += outs
            failed = [
                f"{Path(cmd[0]).name} failed ({proc.returncode}) to build {name}:\n{out}"
                for cmd, proc, out in zip(step, procs, outs)
                if proc.returncode
            ]
            if failed:
                raise RuntimeError("\n".join(failed))
        os.replace(tmp, path)
    finally:
        for f in (tmp, *scratch):
            Path(f).unlink(missing_ok=True)
    return path, time.perf_counter() - t0, "\n".join(logs)
