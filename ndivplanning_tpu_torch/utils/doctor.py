"""Environment diagnosis; counterpart of ``ndivplanning_tpu/utils/doctor.py``.

One JSON report of what decides whether this install can train and serve
on the card: the versions of Python, torch and its CUDA, whether ``nvcc``
is on the path, whether the NDiv kernels' library is built for the
current source, the native host plane, and a backend probe.  The probe
never touches the card in the calling process: a tiny matmul runs in a
subprocess with a timeout, and healthy / unhealthy / timeout come back as
data instead of a hang.  Without a card the default probe is unhealthy:
it never falls back to the CPU (``probe_platform="cpu"`` asks for it).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

# Run in a fresh interpreter; prints one JSON line on success.
_PROBE_SRC = """
import json, platform, time
import torch
device = {device!r}
if device == "cuda" and not torch.cuda.is_available():
    raise SystemExit("CUDA is not available to torch " + torch.__version__)
t0 = time.perf_counter()
x = torch.ones((8, 8), device=device)
val = float((x @ x).sum())
elapsed = time.perf_counter() - t0
cuda = device == "cuda"
print(json.dumps({{
    "device": device,
    "device_name": (torch.cuda.get_device_name(0) if cuda
                    else platform.processor() or platform.machine()),
    "device_count": torch.cuda.device_count() if cuda else 1,
    "probe_value_ok": abs(val - 512.0) < 1e-3,
    "execute_fetch_s": round(elapsed, 3),
}}))
"""


def probe_backend(timeout_s: float = 120.0,
                  platform: str | None = None) -> dict:
    """The tiny matmul on ``cuda`` (or ``cpu`` with ``platform="cpu"``) in a
    subprocess: ``{"status": "healthy", ...}`` or ``{"status":
    "unhealthy"|"timeout", ...}``; never raises, never waits past
    ``timeout_s``."""
    device = "cpu" if platform == "cpu" else "cuda"
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC.format(device=device)],
            capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"status": "timeout", "device": device,
                "timeout_s": timeout_s,
                "hint": "the interpreter, torch's import or the device did "
                        "not answer in time; retry with a longer "
                        "--probe-timeout"}
    wall = round(time.perf_counter() - t0, 3)
    if r.returncode != 0:
        return {"status": "unhealthy", "device": device, "wall_s": wall,
                "stderr_tail": r.stderr.strip().splitlines()[-3:]}
    out = json.loads(r.stdout.strip().splitlines()[-1])
    return {"status": "healthy", "wall_s": wall, **out}


def doctor_report(probe: bool = True, probe_timeout_s: float = 120.0,
                  probe_platform: str | None = None) -> dict:
    """The full report: host introspection plus the optional subprocess
    probe (``healthy`` is set only when the probe ran)."""
    import torch

    import ndivplanning_tpu_torch
    from ndivplanning_tpu_torch.data import native
    from ndivplanning_tpu_torch.ops import ndiv_cuda

    lib = ndiv_cuda.library_path()
    report: dict = {
        "package_version": getattr(ndivplanning_tpu_torch, "__version__",
                                   "dev"),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": shutil.which("nvcc"),
        "ndiv_kernels": {"library": os.path.relpath(lib, os.path.dirname(
                             os.path.dirname(os.path.dirname(lib)))),
                         "built": os.path.exists(lib)},
        # The host plane builds on first use: availability builds it.
        "native_host_plane": {"available": bool(native.native_available()),
                              "lib_built": os.path.exists(
                                  native.library_path())},
    }
    if probe:
        report["backend_probe"] = probe_backend(probe_timeout_s,
                                                probe_platform)
        report["healthy"] = report["backend_probe"]["status"] == "healthy"
    return report
