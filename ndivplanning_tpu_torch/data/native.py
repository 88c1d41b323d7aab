"""ctypes binding of the native host-data library; counterpart of ``ndivplanning_tpu/data/native.py``.

``native/ndiv_host.cc`` rasterises scenes and checks recorded trajectories
for collisions on the host, multithreaded over the batch.  The port builds
its own copy with ``g++`` and ``native/Makefile``'s flags into
``ndivplanning_tpu_torch/_build/`` at first use, named by the hash of the
source and the flags, and moves it into place atomically.  A failed build
raises with the compiler's output: nothing falls back to NumPy.  The NumPy
versions (:func:`rasterize_scenes_numpy`, :func:`collision_mask_numpy`) are
the plain versions the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time

import numpy as np

from ndivplanning_tpu_torch.utils.compile_guard import record_compile

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "ndiv_host.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
# native/Makefile's CXXFLAGS and link step.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-Wextra",
             "-shared")

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where :func:`build` puts the library of the current source, compiler
    and flags."""
    with open(_SRC, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(
        src + " ".join((_cxx(), *CXX_FLAGS)).encode()).hexdigest()
    return os.path.join(_BUILD_DIR, f"libndivhost_{digest[:16]}.so")


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def build() -> str:
    """Compile ``native/ndiv_host.cc`` (once per source and flags hash);
    returns the library's path.  Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    cxx = _cxx()
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC],
                                  capture_output=True, text=True,
                                  timeout=300, check=False)
        except OSError as e:
            raise RuntimeError(f"{cxx} could not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build {_SRC}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    record_compile("native_build", os.path.basename(path),
                   time.perf_counter() - t0)
    return path


def load():
    """The built library, loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.ndiv_rasterize_scenes.argtypes = [
                _F32, _F32, _F32, _F32, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _F32, ctypes.c_int]
            lib.ndiv_rasterize_scenes.restype = None
            lib.ndiv_check_collisions.argtypes = [
                _F32, _F32, _F32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _U8, ctypes.c_int]
            lib.ndiv_check_collisions.restype = None
            _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the library builds and loads here; the entry points raise
    where it does not."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _as_f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.float32)


def _check_shapes(**arrays) -> None:
    """Raise unless each array has its expected shape: the library reads
    exactly these extents through raw pointers."""
    for name, (a, want) in arrays.items():
        if a.shape != want:
            raise ValueError(f"{name} has shape {a.shape}, want {want}")


def rasterize_scenes_host(obstacles, obstacle_mask, starts, goals,
                          size: int = 32, n_threads: int = 0) -> np.ndarray:
    """Scenes rasterised on the host: obstacles ``[B, MAX_OBS, 3]``, their
    mask ``[B, MAX_OBS]`` and starts, goals ``[B, 2]`` to ``[B, size, size,
    3]`` float32 images, as ``data/scenes.py::rasterize_batch`` draws them.
    ``n_threads=0`` uses every core."""
    obstacles, mask = _as_f32(obstacles), _as_f32(obstacle_mask)
    starts, goals = _as_f32(starts), _as_f32(goals)
    b, max_obs = mask.shape
    _check_shapes(obstacles=(obstacles, (b, max_obs, 3)),
                  starts=(starts, (b, 2)), goals=(goals, (b, 2)))
    out = np.empty((b, size, size, 3), np.float32)
    load().ndiv_rasterize_scenes(obstacles, mask, starts, goals, b, max_obs,
                                 size, out, n_threads)
    return out


def collision_mask_host(trajs, obstacles, obstacle_mask,
                        n_threads: int = 0) -> np.ndarray:
    """``[B]`` uint8, 1 where the polyline through the waypoints ``trajs [B,
    H, 2]`` (from the first waypoint) crosses a live obstacle disc of its
    scene: the swept-segment check of ``envs/pointmass.py``.  Filters
    recorded datasets."""
    trajs = _as_f32(trajs)
    obstacles, mask = _as_f32(obstacles), _as_f32(obstacle_mask)
    b, h = trajs.shape[:2]
    max_obs = mask.shape[1]
    _check_shapes(trajs=(trajs, (b, h, 2)),
                  obstacles=(obstacles, (b, max_obs, 3)),
                  obstacle_mask=(mask, (b, max_obs)))
    out = np.empty((b,), np.uint8)
    load().ndiv_check_collisions(trajs, obstacles, mask, b, h, max_obs, out,
                                 n_threads)
    return out


# ------------------------------------------------------- the plain versions


def rasterize_scenes_numpy(obstacles, obstacle_mask, starts, goals,
                           size: int = 32) -> np.ndarray:
    """:func:`rasterize_scenes_host` in NumPy."""
    obstacles, mask = _as_f32(obstacles), _as_f32(obstacle_mask)
    starts, goals = _as_f32(starts), _as_f32(goals)
    coords = (np.arange(size, dtype=np.float32) + 0.5) / size
    xs = coords[None, None, :, None]
    ys = coords[None, :, None, None]
    d2 = ((xs - obstacles[:, None, None, :, 0]) ** 2
          + (ys - obstacles[:, None, None, :, 1]) ** 2)
    r = obstacles[:, None, None, :, 2]
    inside = (d2 < r * r) & (mask[:, None, None, :] > 0.5)
    sigma = 1.5 / size

    def blob(p):
        d2p = ((xs[..., 0] - p[:, None, None, 0])
               ** 2 + (ys[..., 0] - p[:, None, None, 1]) ** 2)
        return np.exp(-d2p / (2.0 * sigma * sigma)).astype(np.float32)

    return np.stack([np.any(inside, axis=-1).astype(np.float32),
                     blob(starts), blob(goals)], axis=-1)


def collision_mask_numpy(trajs, obstacles, obstacle_mask) -> np.ndarray:
    """:func:`collision_mask_host` in NumPy: each segment (previous waypoint
    to waypoint) against each disc."""
    trajs = _as_f32(trajs)
    obstacles, mask = _as_f32(obstacles), _as_f32(obstacle_mask)
    prev = np.concatenate([trajs[:, :1], trajs[:, :-1]], axis=1)
    a = prev[:, :, None, :]  # [B, H, 1, 2]
    d = (trajs - prev)[:, :, None, :]
    c = obstacles[:, None, :, :2]  # [B, 1, MAX_OBS, 2]
    len2 = np.sum(d * d, axis=-1)
    t = np.clip(np.sum((c - a) * d, axis=-1) / np.maximum(len2, 1e-12),
                0.0, 1.0)[..., None]
    d2 = np.sum((c - (a + t * d)) ** 2, axis=-1)
    inside = (d2 < obstacles[:, None, :, 2] ** 2) & (mask[:, None, :] > 0.5)
    return np.any(inside, axis=(1, 2)).astype(np.uint8)
