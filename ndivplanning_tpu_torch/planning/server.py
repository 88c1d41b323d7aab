"""Planning server, a JSON-lines request loop over a trained model; counterpart of ``ndivplanning_tpu/planning/server.py``.

One process holds the model and answers scene requests on stdin/stdout,
one JSON object per line, with the JAX server's protocol:

Request:  {"start": [x, y], "goal": [x, y],
           "obstacles": [[cx, cy, r], ...],        (obstacles optional)
           "mpc": true}                             (optional: closed loop)
Response: {"best_traj": [[x, y] * horizon], "best_score": s,
           "best_reached": 0|1, "diverse_trajs": [...],
           "latency_ms": t, "batch_size": n}
MPC resp: {"path": [[x, y] * 64], "reached": 0|1, "collided": 0|1,
           "n_replans": 8, "latency_ms": t, "batch_size": n}

A line holding a JSON array of requests is answered with an array,
planned together; a burst of separate lines is drained without blocking
and coalesced.  ``stats`` answers the serving counters, ``reload``
swaps in the workdir's newest weights, ``quit`` ends the loop.  A
malformed request is answered with ``{"error": ...}`` at its own
position and the rest of its batch still plans.

Each dispatch plans a chunk of up to ``BUCKETS[-1]`` scenes with one
:func:`plan_batch` call (with ``refine``, the refiner's batched planner,
``planning/refine.py``), padded to the next bucket size with copies of
its first scene.  Closed-loop requests are split from plain ones at
parse time and run, after the plain ones, as bucketed
``mpc_rollout_batch`` episodes at the fixed
``MPC_TOTAL_STEPS`` / ``MPC_REPLAN_EVERY`` / ``MPC_CANDIDATES``.  Requests
are parsed and validated on the host; a chunk goes to the device as one
stacked copy and its answers come back as one.

Network serving (:func:`serve_tcp`) speaks the same protocol over TCP,
one connection per thread, each dispatch holding one process-wide lock
around its device work so that connections interleave a dispatch at a
time.  :class:`_CrossBatcher` plans requests of many connections in
shared dispatches, with admission control (``max_pending``) and a
queueing deadline (``deadline_ms``); :class:`BestWatcher` hot-swaps the
weights when a training run writes a new best checkpoint.  Nothing of the
JAX server is left unported here.
"""

from __future__ import annotations

import io
import json
import os
import queue
import select
import sys
import threading
import time
import traceback
from typing import IO, Callable

import torch

from ndivplanning_tpu_torch.data.scenes import rasterize_batch
from ndivplanning_tpu_torch.envs.types import MAX_OBSTACLES, Scene
from ndivplanning_tpu_torch.planning.mpc import mpc_rollout_batch
from ndivplanning_tpu_torch.planning.planner import plan_batch
from ndivplanning_tpu_torch.planning.refine import (
    REFINERS,
    noise_shape,
    plan_refined_batch,
)
from ndivplanning_tpu_torch.train.state import TrainState
from ndivplanning_tpu_torch.utils.config import Config

BUCKETS = (1, 2, 4, 8, 16)
# Closed-loop serving parameters are fixed, not per request (the JAX
# server's); other settings run ``plan --mpc`` with flags.
MPC_TOTAL_STEPS = 64
MPC_REPLAN_EVERY = 8
MPC_CANDIDATES = 256
# The refinements a server plans with, the JAX server's.
REFINES = ("none", *REFINERS)

# Process-level serving counters, answered on a ``stats`` line (the JAX
# server's keys): updated by every dispatch path, read by any connection.
_STATS_LOCK = threading.Lock()
SERVING_STATS = {"dispatches": 0, "requests": 0, "mpc_requests": 0,
                 "padded_slots": 0, "auto_reloads": 0, "started_at": None,
                 "shed_requests": 0, "expired_requests": 0}


# One dispatch's device work at a time in the process: eager launches from
# several connection threads would otherwise interleave one by one on the
# stream, where the JAX server interleaves whole dispatches.
_DISPATCH_LOCK = threading.Lock()


def _record_load_control(shed: int = 0, expired: int = 0) -> None:
    """Admission-control counters: requests refused at the queue's door
    (``overloaded``) and requests dropped at dispatch time for waiting past
    their queueing deadline (``deadline_exceeded``)."""
    with _STATS_LOCK:
        SERVING_STATS["shed_requests"] += shed
        SERVING_STATS["expired_requests"] += expired


def _record_dispatch(n_real: int, bucket: int, mpc: bool) -> None:
    with _STATS_LOCK:
        SERVING_STATS["dispatches"] += 1
        SERVING_STATS["requests"] += n_real
        if mpc:
            SERVING_STATS["mpc_requests"] += n_real
        SERVING_STATS["padded_slots"] += bucket - n_real
        if SERVING_STATS["started_at"] is None:
            SERVING_STATS["started_at"] = time.time()


def serving_stats() -> dict:
    """Snapshot of the serving counters: dispatches and requests, the
    closed-loop share, mean dispatch batch, pad overhead and uptime."""
    with _STATS_LOCK:
        s = dict(SERVING_STATS)
    d = max(s["dispatches"], 1)
    return {
        "dispatches": s["dispatches"],
        "requests": s["requests"],
        "mpc_requests": s["mpc_requests"],
        "auto_reloads": s["auto_reloads"],
        "shed_requests": s["shed_requests"],
        "expired_requests": s["expired_requests"],
        "mean_dispatch_batch": round(s["requests"] / d, 2),
        "pad_fraction": round(
            s["padded_slots"] / max(s["requests"] + s["padded_slots"], 1),
            3),
        "since_first_dispatch_s": (round(time.time() - s["started_at"], 1)
                                   if s["started_at"] else 0.0),
    }


def check_refine(refine: str) -> None:
    if refine not in REFINES:
        raise ValueError(f"unknown refine={refine!r}; choose from "
                         f"{list(REFINES)}")


class BestWatcher:
    """Auto-reload: watch a best-checkpoint marker and hot-load its weights.

    A daemon thread polls the marker file's ``(st_mtime_ns, st_size)``
    every ``poll_s`` seconds; on a change it calls ``reload_fn`` (the
    loader of the ``reload`` line), publishes the new state under a
    version counter and calls the registered ``on_swap`` callbacks (the
    cross-connection dispatcher).  Serving loops apply the swap at burst
    boundaries.  Swaps are counted as ``auto_reloads``.
    """

    def __init__(self, reload_fn, marker_path: str, poll_s: float = 2.0):
        self._reload = reload_fn
        self._marker = marker_path
        self._poll = poll_s
        self._lock = threading.Lock()
        self._state = None
        self._version = 0
        self._callbacks: list = []
        self._stop = threading.Event()
        self._last_sig = self._sig()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="best-watcher")
        self._thread.start()

    def _sig(self):
        try:
            st = os.stat(self._marker)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def current(self):
        """``(version, latest state or None)``: consumers remember the
        version they applied and read again when it moves."""
        with self._lock:
            return self._version, self._state

    def on_swap(self, fn) -> None:
        """Register a callback called with each newly loaded state."""
        with self._lock:
            self._callbacks.append(fn)

    def check_now(self) -> bool:
        """One poll and load (the thread's body; public so that tests poll
        deterministically).  True if the state was swapped."""
        sig = self._sig()
        if sig is None or sig == self._last_sig:
            return False
        try:
            new_state = self._reload()
        except Exception:  # noqa: BLE001 — keep watching
            traceback.print_exc(file=sys.stderr)
            return False  # _last_sig stays: the next poll tries again
        if new_state is None:
            return False  # a restore that found nothing: try again too
        self._last_sig = sig
        with self._lock:
            self._state = new_state
            self._version += 1
            callbacks = list(self._callbacks)
        for fn in callbacks:
            fn(new_state)
        with _STATS_LOCK:
            SERVING_STATS["auto_reloads"] += 1
        return True

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            self.check_now()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


def _condition_for(cfg: Config, scenes: Scene) -> torch.Tensor:
    """The raw conditions of scenes with any leading axes."""
    if cfg.conditioning == "image":
        return rasterize_batch(scenes, size=cfg.image_size)
    if cfg.conditioning == "startgoal":
        return torch.cat([scenes.start, scenes.goal], dim=-1)
    return scenes.start.new_zeros((*scenes.start.shape[:-1], 0))


def _serve_plan_program(cfg: Config, state: TrainState, scenes: Scene,
                        z: torch.Tensor, n_diverse: int, refine: str = "none"):
    """One dispatch: the chunk's conditions, then :func:`plan_batch`, or
    with a ``refine`` the refiner's batched planner (``z`` its noise)."""
    conditions = _condition_for(cfg, scenes)
    if refine != "none":
        return plan_refined_batch(cfg, state, scenes, conditions, refine,
                                  noise=z, n_diverse=n_diverse)[0]
    return plan_batch(cfg, state, scenes, conditions, n_diverse=n_diverse,
                      z=z)


def _serve_mpc_program(cfg: Config, state: TrainState, scenes: Scene,
                       z: torch.Tensor):
    """One closed-loop dispatch: the chunk's conditions, then
    ``mpc_rollout_batch`` at the serving parameters."""
    return mpc_rollout_batch(cfg, state, scenes, _condition_for(cfg, scenes),
                             total_steps=MPC_TOTAL_STEPS,
                             replan_every=MPC_REPLAN_EVERY,
                             n_candidates=MPC_CANDIDATES, z=z)


def _bucket_for(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


_SCENE_SPLIT = (2, 2, 3 * MAX_OBSTACLES, MAX_OBSTACLES)


def _to_device(scenes: Scene, device: torch.device) -> Scene:
    """Stacked host scenes on ``device`` in one copy."""
    flat = torch.cat([scenes.start, scenes.goal, scenes.obstacles.flatten(1),
                      scenes.obstacle_mask], dim=1).to(device)
    start, goal, obstacles, mask = flat.split(_SCENE_SPLIT, dim=1)
    return Scene(start=start, goal=goal,
                 obstacles=obstacles.reshape(-1, MAX_OBSTACLES, 3),
                 obstacle_mask=mask)


def _fetch(result) -> tuple:
    """A dispatch's answers on the host in one copy: best_traj ``[B, H,
    S]``, best_score, best_reached ``[B]`` and diverse_trajs ``[B, m, H,
    S]`` as numpy arrays."""
    b, m, h, s = result.diverse_trajs.shape
    flat = torch.cat([result.best_traj.reshape(b, -1),
                      result.best_score[:, None], result.best_reached[:, None],
                      result.diverse_trajs.reshape(b, -1)], dim=1).cpu()
    traj, score, reached, diverse = flat.split([h * s, 1, 1, m * h * s], 1)
    return (traj.reshape(b, h, s).numpy(), score[:, 0].numpy(),
            reached[:, 0].numpy(), diverse.reshape(b, m, h, s).numpy())


def _latent_shape(cfg: Config, refine: str = "none",
                 mpc: bool = False) -> tuple[int, ...]:
    """The latents of one scene of a dispatch: ``[N, zdim]`` for a plan,
    the refiner's noise for a refined one (``planning/refine.py``:
    ``[iters + 1, n, zdim]`` for CEM's draws, ``[n, zdim]`` for warm
    starts), ``[n_cycles, MPC_CANDIDATES, zdim]`` for a closed-loop
    episode."""
    if mpc:
        return (MPC_TOTAL_STEPS // MPC_REPLAN_EVERY, MPC_CANDIDATES,
                cfg.latent_dim)
    if refine != "none":
        return noise_shape(cfg, refine)
    return (cfg.n_candidates, cfg.latent_dim)


def _draw_latents(generator: torch.Generator, shape: tuple[int, ...]):
    """The default latent source: ``[bucket, *shape]`` normal draws from
    ``generator``, on its device."""
    def latents(bucket: int) -> torch.Tensor:
        return torch.randn((bucket, *shape), generator=generator,
                           device=generator.device)
    return latents


def handle_batch(cfg: Config, state: TrainState, requests: list,
                 generator: torch.Generator, n_diverse: int = 4,
                 refine: str = "none", arrivals: list[float] | None = None,
                 on_progress=None, out: list | None = None,
                 latents: Callable[[int], torch.Tensor] | None = None,
                 mpc_latents: Callable[[int], torch.Tensor] | None = None
                 ) -> list[dict]:
    """Plan for a list of scene requests in bucketed dispatches; returns one
    JSON-serialisable response per request.

    Plain requests go first, in :func:`plan_batch` dispatches (with a
    ``refine``, the refiner's), then the closed-loop (``"mpc": true``)
    ones in ``mpc_rollout_batch`` dispatches, so that an episode adds
    nothing to a plain request's latency.  A dispatch's latents come from
    ``latents(bucket)`` (plans) or ``mpc_latents(bucket)`` (episodes),
    called once per dispatch in order, ``[bucket, *_latent_shape(...)]``,
    or else are drawn from ``generator``.  ``arrivals`` (one
    ``time.perf_counter()`` per request) makes ``latency_ms`` each
    request's queue and service time.  ``on_progress`` is called after
    the parse pass and after every dispatch has filled its responses,
    and ``out`` is the list to fill in place (length ``len(requests)``).
    A malformed request gets an ``{"error": ...}`` entry at its position.
    """
    check_refine(refine)
    t_in = time.perf_counter()
    if arrivals is None:
        arrivals = [t_in] * len(requests)
    if out is None:
        out = [None] * len(requests)
    assert len(out) == len(requests)
    responses: list[dict | None] = out
    plain: tuple[list[Scene], list[int]] = ([], [])
    closed: tuple[list[Scene], list[int]] = ([], [])
    for i, req in enumerate(requests):
        try:
            scene = Scene.create(req["start"], req["goal"],
                                 req.get("obstacles"), device="cpu")
            group = closed if req.get("mpc") else plain
            group[0].append(scene)
            group[1].append(i)
        except Exception as e:  # noqa: BLE001 — isolated per request
            responses[i] = {"error": f"{type(e).__name__}: {e}"}
    if on_progress is not None:
        on_progress()
    if latents is None:
        latents = _draw_latents(generator, _latent_shape(cfg, refine))
    if mpc_latents is None:
        mpc_latents = _draw_latents(generator, _latent_shape(cfg, mpc=True))
    device = state.rng.device

    def answer(chunk_idx: list[int], bucket: int, fields) -> None:
        """Each request's response: ``fields(j)`` of its chunk slot, then
        its latency and bucket."""
        t_done = time.perf_counter()
        for j, i in enumerate(chunk_idx):
            responses[i] = {
                **fields(j),
                "latency_ms": round((t_done - arrivals[i]) * 1e3, 2),
                "batch_size": bucket,
            }
        if on_progress is not None:
            on_progress()

    def dispatch_plan(scene_b: Scene, bucket: int,
                      chunk_idx: list[int]) -> None:
        _record_dispatch(len(chunk_idx), bucket, mpc=False)
        with _DISPATCH_LOCK:
            z = latents(bucket).to(device)
            result = _serve_plan_program(cfg, state,
                                         _to_device(scene_b, device), z,
                                         n_diverse, refine)
            best_traj, best_score, best_reached, diverse = _fetch(result)
        answer(chunk_idx, bucket, lambda j: {
            "best_traj": best_traj[j].tolist(),
            "best_score": float(best_score[j]),
            "best_reached": float(best_reached[j]),
            "diverse_trajs": diverse[j].tolist()})

    def dispatch_mpc(scene_b: Scene, bucket: int,
                     chunk_idx: list[int]) -> None:
        _record_dispatch(len(chunk_idx), bucket, mpc=True)
        with _DISPATCH_LOCK:
            z = mpc_latents(bucket).to(device)
            result = _serve_mpc_program(cfg, state,
                                        _to_device(scene_b, device), z)
            path, reached, collided = _fetch_mpc(result)
        answer(chunk_idx, bucket, lambda j: {
            "path": path[j].tolist(), "reached": float(reached[j]),
            "collided": float(collided[j]), "n_replans": result.n_replans})

    _dispatch_buckets(*plain, dispatch_plan)
    _dispatch_buckets(*closed, dispatch_mpc)
    return responses


def _fetch_mpc(result) -> tuple:
    """A closed-loop dispatch's answers on the host in one copy: the paths
    ``[B, T, 2]`` and the reached and collided flags ``[B]``."""
    b, t, _ = result.positions.shape
    flat = torch.cat([result.positions.reshape(b, -1),
                      result.reached[:, None], result.collided[:, None]],
                     dim=1).cpu()
    path, reached, collided = flat.split([2 * t, 1, 1], 1)
    return (path.reshape(b, t, 2).numpy(), reached[:, 0].numpy(),
            collided[:, 0].numpy())


def _dispatch_buckets(scenes: list[Scene], idx: list[int], dispatch) -> None:
    """Chunk ``scenes`` into max-bucket groups, pad each chunk to its bucket
    size with copies of its first scene (their answers are dropped), stack
    it on the host and call ``dispatch(scene_b, bucket, chunk_idx)``."""
    max_bucket = BUCKETS[-1]
    for pos in range(0, len(scenes), max_bucket):
        chunk = scenes[pos:pos + max_bucket]
        bucket = _bucket_for(len(chunk))
        padded = chunk + [chunk[0]] * (bucket - len(chunk))
        dispatch(Scene.stack(padded), bucket, idx[pos:pos + max_bucket])


def handle_request(cfg: Config, state: TrainState, request: dict,
                   generator: torch.Generator, n_diverse: int = 4) -> dict:
    """Plan for one scene request (a bucket-1 dispatch)."""
    return handle_batch(cfg, state, [request], generator,
                        n_diverse=n_diverse)[0]


class _LineSource:
    """Line reader with an honest non-blocking drain.

    For real file descriptors the raw fd is read here (select + os.read
    into an own buffer): ``select`` on the fd while reading through the
    TextIOWrapper's ``readline`` misses lines the wrapper has already
    buffered, so a burst written at once would never coalesce.  Streams
    without a usable fd (StringIO) fall back to ``readline``, which never
    blocks there.
    """

    def __init__(self, stdin: IO[str]):
        self._stdin = stdin
        self._buf = b""
        self._eof = False
        try:
            self._fd: int | None = stdin.fileno()
        except (AttributeError, OSError, ValueError,
                io.UnsupportedOperation):
            self._fd = None

    def _pop_line(self) -> str | None:
        i = self._buf.find(b"\n")
        if i < 0:
            if self._eof and self._buf:
                line, self._buf = self._buf, b""
                return line.decode("utf-8", errors="replace")
            return None
        line, self._buf = self._buf[:i + 1], self._buf[i + 1:]
        return line.decode("utf-8", errors="replace")

    def _fill(self, block: bool) -> bool:
        """Read once from the fd into the buffer; False when no data was
        (or will be) available."""
        if self._eof:
            return False
        if not block:
            ready, _, _ = select.select([self._fd], [], [], 0)
            if not ready:
                return False
        chunk = os.read(self._fd, 65536)
        if chunk == b"":
            self._eof = True
            return False
        self._buf += chunk
        return True

    def readline(self) -> str:
        """Next line, blocking; '' at EOF."""
        if self._fd is None:
            return self._stdin.readline()
        while True:
            line = self._pop_line()
            if line is not None:
                return line
            if self._eof:
                return ""
            self._fill(block=True)

    def drain(self, max_n: int) -> list[str]:
        """Up to ``max_n`` lines available now, never blocking."""
        out: list[str] = []
        if self._fd is None:
            while len(out) < max_n:
                line = self._stdin.readline()
                if line == "":
                    break
                out.append(line)
            return out
        while len(out) < max_n:
            line = self._pop_line()
            if line is not None:
                out.append(line)
                continue
            if not self._fill(block=False):
                break
        return out


def warmup(cfg: Config, state: TrainState, n_diverse: int = 4,
           refine: str = "none", buckets=BUCKETS, mpc: bool = False) -> float:
    """One dispatch of every bucket size before traffic arrives (the CUDA
    context, cuBLAS and cuDNN handles, kernel loads and the allocator's
    blocks of each shape), and with ``mpc`` one closed-loop dispatch of
    each too; returns the seconds it took.  Its latents come from a
    generator of its own, so the served stream is unchanged."""
    generator = torch.Generator(device=state.rng.device).manual_seed(0)
    dummy = {"start": [0.1, 0.1], "goal": [0.9, 0.9],
             "obstacles": [[0.5, 0.5, 0.1]]}
    t0 = time.perf_counter()
    for b in buckets:
        handle_batch(cfg, state, [dict(dummy) for _ in range(b)], generator,
                     n_diverse=n_diverse, refine=refine)
        if mpc:
            handle_batch(cfg, state, [dict(dummy, mpc=True)
                                      for _ in range(b)], generator,
                         n_diverse=n_diverse, refine=refine)
    return time.perf_counter() - t0


class _ResponseWriter:
    """Response encode/write pipeline for :func:`serve`.

    With ``overlap=True`` a daemon thread pops finished responses off a
    queue and does the ``json.dumps`` and write, so encoding batch N
    overlaps reading and dispatching batch N+1.  Order is kept (one queue,
    one writer).  ``overlap=False`` writes synchronously.  An encode or
    write error is raised on the main thread at the next push or close,
    after which writes fall back to synchronous.
    """

    def __init__(self, stdout: IO[str], overlap: bool):
        self._stdout = stdout
        self._q: "queue.Queue[object]" = queue.Queue(maxsize=4)
        self._thread = None
        self._error: BaseException | None = None
        if overlap:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _write_one(self, response: object) -> None:
        self._stdout.write(json.dumps(response) + "\n")
        self._stdout.flush()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is _WRITER_DONE:
                return
            try:
                self._write_one(item)
            except BaseException as e:  # noqa: BLE001
                self._error = e
                return

    def _check(self) -> None:
        if self._error is not None:
            # The writer thread is dead: later pushes write synchronously
            # instead of blocking on a full queue nobody drains.
            self._thread = None
            err, self._error = self._error, None
            raise err

    def push(self, response: object) -> None:
        self._check()
        if self._thread is None:
            self._write_one(response)
        else:
            self._q.put(response)

    def close(self, timeout: float | None = None) -> None:
        """Flush and stop the writer thread; raises a pending write error.
        Never hangs on a dead thread: the stop marker is offered only while
        the thread lives, and a live one wedged on a full pipe is waited
        for up to ``timeout`` (None: indefinitely)."""
        t = self._thread
        if t is not None:
            deadline = (None if timeout is None
                        else time.perf_counter() + timeout)
            while t.is_alive():
                try:
                    self._q.put(_WRITER_DONE, timeout=0.1)
                    break
                except queue.Full:
                    if (deadline is not None
                            and time.perf_counter() >= deadline):
                        break
            t.join(timeout)
            self._thread = None
        self._check()


_WRITER_DONE = object()


class _Pending:
    """One request in flight through the :class:`_CrossBatcher`."""

    __slots__ = ("req", "arrival", "event", "result")

    def __init__(self, req: dict, arrival: float):
        self.req = req
        self.arrival = arrival
        self.event = threading.Event()
        self.result: dict | list | None = None


class _CrossBatcher:
    """Cross-connection dynamic batching for :func:`serve_tcp`.

    Every connection's requests go through one dispatcher thread, which
    drains whatever is queued, across connections, into shared
    :func:`handle_batch` calls: while dispatch N runs, new arrivals queue
    and ride dispatch N+1 together; an idle server adds no delay.  Answers
    complete one by one through ``handle_batch``'s ``on_progress``, so one
    client's closed-loop episode holds back no other client's plan.  The
    dispatcher owns the latent stream: one generator seeded with ``seed``
    on the state's device (per-connection seeds do not apply here).

    Admission control: ``max_pending`` bounds the requests admitted and
    not yet answered (queued or in flight); past it a burst is refused
    whole with ``{"error": "overloaded", "retry_ms": n}``, ``n`` an
    estimate of when the queue will have drained, counting ahead of this
    burst the requests shed before it and not yet drained (a dispatch
    drains ``max_pending`` of them): they come back too, and a burst of
    clients told one time would all come back at once to a queue that
    admits ``max_pending`` of them.  That count is forgotten once the
    latest hint given, and one dispatch more, have passed: a shed client
    that came back by then was admitted or shed (and counted) again, and
    one that gave up is not coming.  The staggered hint is the port's own;
    JAX's batcher tells every shed burst one time.  ``deadline_ms`` bounds
    how long an admitted request may queue: at dispatch time an older one
    is answered ``{"error": "deadline_exceeded", "waited_ms": w,
    "deadline_ms": d}``.  None (or 0) disables either.
    """

    def __init__(self, cfg: Config, state: TrainState, *,
                 n_diverse: int = 4, refine: str = "none", seed: int = 0,
                 max_batch: int = BUCKETS[-1],
                 max_pending: int | None = None,
                 deadline_ms: float | None = None):
        check_refine(refine)
        self._cfg = cfg
        self._state = state
        self._n_diverse = n_diverse
        self._refine = refine
        self._generator = torch.Generator(
            device=state.rng.device).manual_seed(seed)
        self._max = max_batch
        self._max_pending = max_pending
        self._deadline_s = (None if not deadline_ms
                            else float(deadline_ms) / 1000.0)
        self._pending_n = 0
        # Shed requests not yet drained by dispatches (the hint's queue),
        # and the perf_counter time past which none of them is due back.
        self._shed_n = 0
        self._shed_due = 0.0
        self._pending_lock = threading.Lock()
        # A 0.7/0.3 moving average of the dispatch time: the shed reply's
        # retry_ms hint.
        self._ema_dispatch_s = 0.05
        self._q: "queue.Queue[list[_Pending] | None]" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cross-batcher")
        self._thread.start()

    def _per_dispatch(self) -> int:
        return min(self._max, self._max_pending or self._max)

    def _retry_ms_hint(self, shed: int) -> int:
        """ms until the dispatches ahead of a burst of ``shed`` refused
        requests will have run: the pending requests and the ones shed
        before it and still due back, ``max_pending`` (or ``max_batch``) a
        dispatch."""
        now = time.perf_counter()
        with self._pending_lock:
            if now > self._shed_due:
                self._shed_n = 0
            n = self._pending_n + self._shed_n
            self._shed_n += shed
            dispatches_ahead = max(-(-n // self._per_dispatch()), 1)
            retry_s = dispatches_ahead * self._ema_dispatch_s
            self._shed_due = max(self._shed_due,
                                 now + retry_s + self._ema_dispatch_s)
        return max(int(retry_s * 1000), 1)

    def submit(self, reqs: list[dict], arrival: float) -> list[_Pending]:
        """Queue one connection's burst as a unit: it may share a dispatch
        with other bursts but is never split between admission and
        refusal.  After :meth:`close` a submit fails at once."""
        pendings = [_Pending(r, arrival) for r in reqs]
        if not pendings:
            return pendings
        if self._closed:
            self._fail(pendings, "server shutting down", counted=False)
            return pendings
        with self._pending_lock:
            # A burst past max_pending is still admitted when nothing is
            # pending (the dispatcher splits it into buckets): refused, a
            # plan_batch larger than the budget could never be served.
            over = (self._max_pending is not None
                    and self._pending_n > 0
                    and self._pending_n + len(pendings) > self._max_pending)
            if not over:
                self._pending_n += len(pendings)
        if over:
            retry = self._retry_ms_hint(len(pendings))
            _record_load_control(shed=len(pendings))
            for p in pendings:
                p.result = {"error": "overloaded", "retry_ms": retry}
                p.event.set()
            return pendings
        self._q.put(pendings)
        if self._closed and not self._thread.is_alive():
            # close() raced the put and the dispatcher is gone: fail what
            # is left here.
            while True:
                try:
                    rest = self._q.get_nowait()
                except queue.Empty:
                    break
                if rest is not None:
                    self._fail(rest, "server shutting down")
        return pendings

    def set_state(self, state: TrainState) -> None:
        """Swap the served weights (a ``reload`` line or the watcher): a
        reference swap; a dispatch in flight finishes on the old state."""
        self._state = state

    def close(self) -> None:
        """Stop the dispatcher after the bursts queued before the call;
        anything queued after it is failed, never left waiting."""
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=30)

    def _complete(self, p: _Pending, result) -> None:
        """Finish one admitted request: set its result and release its
        admission slot, exactly once (the check and the release under the
        lock, so that no completion path can release a slot twice)."""
        with self._pending_lock:
            if p.event.is_set():
                return
            if p.result is None:
                p.result = result
            self._pending_n -= 1
            p.event.set()

    def _fail(self, pendings: list[_Pending], msg: str,
              counted: bool = True) -> None:
        for p in pendings:
            if counted:
                self._complete(p, {"error": msg})
            else:  # refused before admission: no slot to release
                if p.result is None:
                    p.result = {"error": msg}
                p.event.set()

    def _run(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                # Shut down: fail whatever is still queued.
                while True:
                    try:
                        rest = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if rest is not None:
                        self._fail(rest, "server shutting down")
            batch = list(first)
            while len(batch) < self._max:
                try:
                    more = self._q.get_nowait()
                except queue.Empty:
                    break
                if more is None:
                    self._q.put(None)  # exit after this batch
                    break
                batch.extend(more)
            if self._deadline_s is not None:
                now = time.perf_counter()
                live = []
                n_expired = 0
                for p in batch:
                    waited = now - p.arrival
                    if waited > self._deadline_s:
                        n_expired += 1
                        self._complete(p, {
                            "error": "deadline_exceeded",
                            "waited_ms": round(waited * 1000.0, 1),
                            "deadline_ms": round(self._deadline_s * 1000.0,
                                                 1)})
                    else:
                        live.append(p)
                if n_expired:
                    _record_load_control(expired=n_expired)
                batch = live
            if batch:
                self._dispatch(batch)

    def _dispatch(self, batch: list[_Pending]) -> None:
        out: list = [None] * len(batch)
        done = [False] * len(batch)
        with self._pending_lock:
            self._shed_n = max(self._shed_n - self._per_dispatch(), 0)

        def progress() -> None:
            for i, p in enumerate(batch):
                if not done[i] and out[i] is not None:
                    done[i] = True
                    self._complete(p, out[i])

        t0 = time.perf_counter()
        try:
            handle_batch(self._cfg, self._state, [p.req for p in batch],
                         self._generator, n_diverse=self._n_diverse,
                         refine=self._refine,
                         arrivals=[p.arrival for p in batch],
                         on_progress=progress, out=out)
            progress()
            self._ema_dispatch_s = (0.7 * self._ema_dispatch_s
                                    + 0.3 * (time.perf_counter() - t0))
        except Exception as e:  # noqa: BLE001 — the dispatcher keeps serving
            traceback.print_exc(file=sys.stderr)
            for i, p in enumerate(batch):
                if not done[i]:
                    done[i] = True
                    self._complete(p, out[i] if out[i] is not None else
                                   {"error": f"{type(e).__name__}: {e}"})


def serve(cfg: Config, state: TrainState, stdin: IO[str] = sys.stdin,
          stdout: IO[str] = sys.stdout, seed: int = 0,
          max_coalesce: int = BUCKETS[-1], refine: str = "none",
          overlap: bool = True, batcher: _CrossBatcher | None = None,
          reload_fn=None, watcher: BestWatcher | None = None) -> int:
    """Blocking request loop; returns the number of lines answered.

    Latents are drawn from one generator seeded with ``seed`` on the
    state's device, so two servers with one seed answer one request
    sequence alike; with a ``batcher`` its dispatcher plans instead, from
    its own stream.  Up to ``max_coalesce`` lines waiting together are
    one burst.  ``reload_fn`` returns a fresh state for a ``reload`` line
    (or None when there is no checkpoint); a ``watcher``'s newest state
    replaces the served one at each burst's start.  ``overlap`` writes
    responses on a thread of their own (:class:`_ResponseWriter`)."""
    check_refine(refine)
    generator = torch.Generator(device=state.rng.device).manual_seed(seed)
    source = _LineSource(stdin)
    writer = _ResponseWriter(stdout, overlap)
    try:
        n = _serve_loop(cfg, state, source, writer, generator, reload_fn,
                        refine, max_coalesce=max_coalesce, batcher=batcher,
                        watcher=watcher)
    except BaseException:
        # Stop the writer without letting a second write error hide the
        # loop's own, and without hanging on a wedged pipe.
        try:
            writer.close(timeout=5.0)
        except Exception:  # noqa: BLE001
            pass
        raise
    writer.close()
    return n


def serve_tcp(cfg: Config, state: TrainState, host: str = "127.0.0.1",
              port: int = 0, seed: int = 0, refine: str = "none",
              overlap: bool = True, max_coalesce: int = BUCKETS[-1],
              cross_batch: bool = False, reload_fn=None,
              watcher: BestWatcher | None = None,
              max_pending: int | None = None,
              deadline_ms: float | None = None):
    """Network serving: the JSON-lines protocol over TCP.

    Returns a ``ThreadingTCPServer`` already bound (``port=0`` takes an
    ephemeral port: read ``server.server_address``) but not serving; the
    caller runs ``serve_forever()`` and, to stop, ``shutdown()`` and
    ``server_close()``.  ``server.lines_served`` sums the lines answered
    on every connection.

    Each connection runs :func:`serve`, its own burst coalescing
    included, on the shared state and on the state's device; connection
    ``i`` (in the order the handlers start) draws from ``seed + i``.  A
    dispatch holds ``_DISPATCH_LOCK`` around its device work, so
    connections interleave one dispatch at a time and each connection's
    answers do not depend on the others.  With ``cross_batch`` a shared
    :class:`_CrossBatcher` plans the requests of all connections in shared
    dispatches instead, with ``max_pending`` and ``deadline_ms`` as its
    admission control.  ``quit`` (or EOF) closes only its connection.
    """
    import itertools
    import socketserver

    conn_counter = itertools.count()
    batcher = (_CrossBatcher(cfg, state, refine=refine, seed=seed,
                             max_pending=max_pending,
                             deadline_ms=deadline_ms)
               if cross_batch else None)
    if watcher is not None and batcher is not None:
        watcher.on_swap(batcher.set_state)

    class _Handler(socketserver.StreamRequestHandler):
        def handle(self):
            conn_id = next(conn_counter)
            server._handler_threads.add(threading.current_thread())
            # Text views of the socket: _LineSource reads its fd raw.
            reader = self.connection.makefile("r", encoding="utf-8")
            writer = self.connection.makefile("w", encoding="utf-8")
            try:
                n = serve(cfg, state, stdin=reader, stdout=writer,
                          seed=seed + conn_id, refine=refine,
                          overlap=overlap, max_coalesce=max_coalesce,
                          batcher=batcher, reload_fn=reload_fn,
                          watcher=watcher)
                with server._lock:
                    server.lines_served += n
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away; nobody to answer
            finally:
                for f in (reader, writer):
                    try:
                        f.close()
                    except OSError:
                        pass
                server._handler_threads.discard(threading.current_thread())

    class _Server(socketserver.ThreadingTCPServer):
        # Daemon handlers: a hung client never blocks the process's exit.
        allow_reuse_address = True
        daemon_threads = True

        def server_close(self):
            super().server_close()
            # ThreadingMixIn joins no daemon handler, so a live
            # connection's lines_served would race the caller's read of
            # the total: give each live handler 2 s.  getattr: on a failed
            # bind socketserver calls this from __init__, before the
            # attributes exist, and the bind's own error must surface.
            for t in list(getattr(self, "_handler_threads", ())):
                if t is not threading.current_thread():
                    t.join(timeout=2.0)
            if batcher is not None:
                batcher.close()

    try:
        server = _Server((host, port), _Handler)
    except BaseException:
        if batcher is not None:
            batcher.close()
        raise
    server.lines_served = 0
    server._lock = threading.Lock()
    server._handler_threads = set()
    return server


def _serve_loop(cfg: Config, state: TrainState, source: _LineSource,
                writer: _ResponseWriter, generator: torch.Generator,
                reload_fn=None, refine: str = "none",
                max_coalesce: int = BUCKETS[-1],
                batcher: _CrossBatcher | None = None,
                watcher: BestWatcher | None = None) -> int:
    n = 0
    stop = False
    # Start from the watcher's newest state (a connection opened after a
    # swap serves the new weights) and look again at every burst.
    watch_ver = -1
    if watcher is not None:
        watch_ver, w_state = watcher.current()
        if w_state is not None:
            state = w_state

    def process_segment(seg_lines: list[str], t_arrive: float) -> None:
        """Parse, dispatch and write one reload-free run of burst lines."""
        nonlocal n, stop
        # One unit per answered line: (kind, payload, start, count), where
        # [start, start + count) is its slice of the flat request list.
        units: list[tuple[str, object, int, int]] = []
        flat: list[dict] = []
        for raw in seg_lines:
            if raw == "stats":
                # Answered at write time, in protocol order: a stats line
                # after requests of the same burst sees their dispatches.
                units.append(("info", None, len(flat), 0))
                continue
            if raw == "quit":
                # The rest of the burst was read already; answer it too.
                stop = True
                continue
            try:
                parsed = json.loads(raw)
            except Exception as e:  # noqa: BLE001
                units.append(("error",
                              {"error": f"{type(e).__name__}: {e}"},
                              len(flat), 0))
                continue
            if isinstance(parsed, list):
                units.append(("list", None, len(flat), len(parsed)))
                flat.extend(parsed)
            else:
                units.append(("single", None, len(flat), 1))
                flat.append(parsed)

        # Responses go out in line order as soon as they and every earlier
        # line's are ready; latency_ms is restamped when a response is
        # handed to the writer, so it includes any wait behind an earlier
        # line.
        answers: list = [None] * len(flat)
        next_unit = 0

        def flush_ready():
            nonlocal n, next_unit
            while next_unit < len(units):
                kind, payload, start, count = units[next_unit]
                chunk = answers[start:start + count]
                if any(r is None for r in chunk):
                    return
                t_now = time.perf_counter()
                for r in chunk:
                    if "latency_ms" in r:
                        r["latency_ms"] = round((t_now - t_arrive) * 1e3, 2)
                response = (serving_stats() if kind == "info"
                            else payload if kind == "error"
                            else chunk if kind == "list" else chunk[0])
                writer.push(response)
                n += 1
                next_unit += 1

        if flat:
            if batcher is not None:
                # The shared dispatcher plans the burst, perhaps beside
                # other connections' requests; answers are waited for in
                # protocol order, the only order they can be written in.
                for i, p in enumerate(batcher.submit(flat, t_arrive)):
                    p.event.wait()
                    answers[i] = p.result
                    flush_ready()
            else:
                handle_batch(cfg, state, flat, generator, refine=refine,
                             arrivals=[t_arrive] * len(flat),
                             on_progress=flush_ready, out=answers)
        flush_ready()

    while not stop:
        first = source.readline()
        if first == "":
            break
        if watcher is not None:
            ver, w_state = watcher.current()
            if ver != watch_ver:
                watch_ver = ver
                if w_state is not None:
                    state = w_state
        lines = [first] + source.drain(max_coalesce - 1)
        # One arrival stamp for the burst: every line was in the pipe when
        # the loop woke.
        t_arrive = time.perf_counter()
        # A ``reload`` line is a segment boundary: the lines before it plan
        # on the old weights, the lines after it on the new ones.
        segment: list[str] = []
        for raw in lines:
            raw = raw.strip()
            if not raw:
                continue
            if raw != "reload":
                segment.append(raw)
                continue
            process_segment(segment, t_arrive)
            segment = []
            if reload_fn is None:
                payload = {"error": "reload unavailable: server was "
                                    "started without a checkpoint "
                                    "source"}
            else:
                new_state = reload_fn()
                if new_state is None:
                    payload = {"error": "reload failed: no checkpoint "
                                        "found"}
                else:
                    state = new_state
                    if batcher is not None:
                        batcher.set_state(new_state)
                    payload = {"reloaded": True,
                               "step": int(new_state.step)}
            writer.push(payload)
            n += 1
        process_segment(segment, t_arrive)
    return n
