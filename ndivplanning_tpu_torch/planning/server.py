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
:func:`plan_batch` call (``refine="cem"``: ``plan_cem_batch``), padded to
the next bucket size with copies of its first scene.  Closed-loop
requests are split from plain ones at parse time and run, after the plain
ones, as bucketed ``mpc_rollout_batch`` episodes at the fixed
``MPC_TOTAL_STEPS`` / ``MPC_REPLAN_EVERY`` / ``MPC_CANDIDATES``.  Requests
are parsed and validated on the host; a chunk goes to the device as one
stacked copy and its answers come back as one.

Not ported yet, each raising ``NotImplementedError`` with its name: the
refiners other than CEM (``refine``), ``serve_tcp``, the cross-connection
batcher and the best-checkpoint watcher.
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
from typing import IO, Callable

import torch

from ndivplanning_tpu_torch.data.scenes import rasterize_batch
from ndivplanning_tpu_torch.envs.types import MAX_OBSTACLES, Scene
from ndivplanning_tpu_torch.planning.cem import cem_population, plan_cem_batch
from ndivplanning_tpu_torch.planning.mpc import mpc_rollout_batch
from ndivplanning_tpu_torch.planning.planner import plan_batch
from ndivplanning_tpu_torch.train.state import TrainState
from ndivplanning_tpu_torch.utils.config import Config

BUCKETS = (1, 2, 4, 8, 16)
# Closed-loop serving parameters are fixed, not per request (the JAX
# server's); other settings run ``plan --mpc`` with flags.
MPC_TOTAL_STEPS = 64
MPC_REPLAN_EVERY = 8
MPC_CANDIDATES = 256
# The refinements a server plans with (the JAX server's other refiners
# are not ported).
REFINES = ("none", "cem")

# Process-level serving counters, answered on a ``stats`` line.  The keys
# are the JAX server's; the ones of unported paths stay 0.
_STATS_LOCK = threading.Lock()
SERVING_STATS = {"dispatches": 0, "requests": 0, "mpc_requests": 0,
                 "padded_slots": 0, "auto_reloads": 0, "started_at": None,
                 "shed_requests": 0, "expired_requests": 0}


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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the torch server "
                               "yet")


def check_refine(refine: str) -> None:
    if refine not in REFINES:
        raise _not_ported(f"refine={refine!r}")


def serve_tcp(*args, **kwargs):
    raise _not_ported("serve_tcp (--tcp)")


class _CrossBatcher:
    def __init__(self, *args, **kwargs):
        raise _not_ported("_CrossBatcher (--cross-batch, --max-pending, "
                          "--deadline-ms)")


class BestWatcher:
    def __init__(self, *args, **kwargs):
        raise _not_ported("BestWatcher (--watch-best)")


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
    with ``refine="cem"`` ``plan_cem_batch`` (``z`` its noise)."""
    conditions = _condition_for(cfg, scenes)
    if refine == "cem":
        return plan_cem_batch(cfg, state, scenes, conditions,
                              n_diverse=n_diverse, eps=z)[0]
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
    ``[iters + 1, n, zdim]`` for a CEM plan's noise, ``[n_cycles,
    MPC_CANDIDATES, zdim]`` for a closed-loop episode."""
    if mpc:
        return (MPC_TOTAL_STEPS // MPC_REPLAN_EVERY, MPC_CANDIDATES,
                cfg.latent_dim)
    if refine == "cem":
        n, _, iters = cem_population(cfg)
        return (iters + 1, n, cfg.latent_dim)
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

    Plain requests go first, in :func:`plan_batch` dispatches (``refine=
    "cem"``: ``plan_cem_batch``), then the closed-loop (``"mpc": true``)
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
        z = latents(bucket).to(device)
        result = _serve_plan_program(cfg, state, _to_device(scene_b, device),
                                     z, n_diverse, refine)
        best_traj, best_score, best_reached, diverse = _fetch(result)
        answer(chunk_idx, bucket, lambda j: {
            "best_traj": best_traj[j].tolist(),
            "best_score": float(best_score[j]),
            "best_reached": float(best_reached[j]),
            "diverse_trajs": diverse[j].tolist()})

    def dispatch_mpc(scene_b: Scene, bucket: int,
                     chunk_idx: list[int]) -> None:
        _record_dispatch(len(chunk_idx), bucket, mpc=True)
        z = mpc_latents(bucket).to(device)
        result = _serve_mpc_program(cfg, state, _to_device(scene_b, device),
                                    z)
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


def serve(cfg: Config, state: TrainState, stdin: IO[str] = sys.stdin,
          stdout: IO[str] = sys.stdout, seed: int = 0, refine: str = "none",
          overlap: bool = True, reload_fn=None) -> int:
    """Blocking request loop; returns the number of lines answered.

    Latents are drawn from one generator seeded with ``seed`` on the
    state's device, so two servers with one seed answer one request
    sequence alike.  ``reload_fn`` returns a fresh state for a ``reload``
    line (or None when there is no checkpoint).  ``overlap`` writes
    responses on a thread of their own (:class:`_ResponseWriter`)."""
    check_refine(refine)
    generator = torch.Generator(device=state.rng.device).manual_seed(seed)
    source = _LineSource(stdin)
    writer = _ResponseWriter(stdout, overlap)
    try:
        n = _serve_loop(cfg, state, source, writer, generator, reload_fn,
                        refine)
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


def _serve_loop(cfg: Config, state: TrainState, source: _LineSource,
                writer: _ResponseWriter, generator: torch.Generator,
                reload_fn=None, refine: str = "none") -> int:
    n = 0
    stop = False

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
            handle_batch(cfg, state, flat, generator, refine=refine,
                         arrivals=[t_arrive] * len(flat),
                         on_progress=flush_ready, out=answers)
        flush_ready()

    while not stop:
        first = source.readline()
        if first == "":
            break
        lines = [first] + source.drain(BUCKETS[-1] - 1)
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
                    payload = {"reloaded": True,
                               "step": int(new_state.step)}
            writer.push(payload)
            n += 1
        process_segment(segment, t_arrive)
    return n
