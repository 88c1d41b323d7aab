"""Programmatic client of the planning server's JSON-lines protocol; the port's own copy of ``ndivplanning_tpu/planning/client.py``.

The server (``planning/server.py``) answers one JSON line per request
line over the stdin/stdout of a ``cli serve`` process.  This module owns
that transport, frames the protocol and maps error replies to exceptions:

    with PlanningClient.spawn(["--workdir", "checkpoints_torch/planning512"]) as c:
        resp = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
        paths = c.plan_batch(requests)          # one server dispatch
        episode = c.mpc(start=[0.1, 0.1], goal=[0.9, 0.9])   # closed loop

It needs the standard library only.  The TCP transport and the client's
retries of shed requests come with the torch server's ``serve_tcp`` and
raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import IO, Any


class ServerError(RuntimeError):
    """The server answered `{"error": ...}` for a request.

    Raised per-request: in a batch, only the failed positions raise /
    carry errors (`plan_batch(..., raise_on_error=False)` returns the
    raw per-position dicts instead).
    """


class PlanningClient:
    """One protocol connection: a writable line sink + readable source.

    Not thread-safe: the protocol answers in request order on one
    stream, so interleaved writers would mis-pair responses.
    """

    def __init__(self, reader: IO[str], writer: IO[str],
                 _owned: tuple = ()):
        self._reader = reader
        self._writer = writer
        self._owned = _owned  # child processes to end with us
        self._closed = False

    # -- constructors ----------------------------------------------------

    @classmethod
    def tcp(cls, host: str = "127.0.0.1", port: int = 7421,
            timeout: float | None = 600.0) -> "PlanningClient":
        """Connect to a ``cli serve --tcp`` server: not ported yet."""
        raise NotImplementedError(
            "PlanningClient.tcp: serve_tcp (--tcp) is not ported to the "
            "torch server yet")

    @classmethod
    def spawn(cls, serve_args: list[str], python: str = sys.executable,
              module: str = "ndivplanning_tpu_torch.cli",
              env: dict[str, str] | None = None) -> "PlanningClient":
        """Spawn `python -m ndivplanning_tpu_torch.cli serve <args>` and talk
        to it over its stdin/stdout pipes.  The child is terminated on
        ``close()`` if `quit` did not already end it.  ``module``/``env``
        exist for embedders (and tests) that wrap the CLI in their own
        entrypoint — e.g. one that pins the backend first."""
        proc = subprocess.Popen(
            [python, "-m", module, "serve", *serve_args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1, env=env)
        return cls(proc.stdout, proc.stdin, _owned=(proc,))

    # -- protocol --------------------------------------------------------

    def _send_line(self, line: str) -> Any:
        """One raw protocol line out, one JSON response line back."""
        if self._closed:
            raise RuntimeError("client is closed")
        self._writer.write(line + "\n")
        self._writer.flush()
        resp = self._reader.readline()
        if not resp:
            raise ConnectionError("server closed the connection")
        return json.loads(resp)

    def _round_trip(self, payload: Any) -> Any:
        return self._send_line(json.dumps(payload))

    @staticmethod
    def _raise_for_error(resp: Any) -> None:
        if isinstance(resp, dict) and "error" in resp:
            raise ServerError(resp["error"])

    def plan(self, start, goal, obstacles=None, *, mpc: bool = False,
             retries: int = 0, **extra) -> dict:
        """Plan one scene; returns the response dict (``best_traj``,
        ``best_score``, ..., or with ``mpc=True`` a closed-loop episode's
        ``path``, ``reached``, ``collided``, ``n_replans``, ...).  Raises
        :class:`ServerError` on an error reply.  Retrying shed requests
        (``retries > 0``) comes with ``serve_tcp``."""
        if retries:
            raise NotImplementedError(
                "PlanningClient.plan(retries=...): the overload path comes "
                "with serve_tcp, which is not ported to the torch server yet")
        req = {"start": list(start), "goal": list(goal), **extra}
        if obstacles is not None:
            req["obstacles"] = [list(o) for o in obstacles]
        if mpc:
            req["mpc"] = True
        resp = self._round_trip(req)
        self._raise_for_error(resp)
        return resp

    def plan_batch(self, requests: list[dict], *,
                   raise_on_error: bool = True) -> list[dict]:
        """Plan many scenes in ONE bucketed server dispatch (a JSON
        array line).  Error isolation is per-position: with
        ``raise_on_error`` (default) the first failed position raises;
        otherwise the raw per-position dicts come back and callers
        check for ``"error"`` themselves."""
        resp = self._round_trip(list(requests))
        if raise_on_error:
            for i, r in enumerate(resp):
                if isinstance(r, dict) and "error" in r:
                    try:
                        self._raise_for_error(r)
                    except ServerError as e:
                        e.args = (f"request {i}: {e.args[0]}",
                                  *e.args[1:])
                        raise
        return resp

    def send_lines(self, lines: list[str]) -> list:
        """Write raw protocol lines in one write, a burst the server may
        coalesce into shared dispatches, and read one response per line
        (so no `quit` among them)."""
        if self._closed:
            raise RuntimeError("client is closed")
        self._writer.write("".join(line + "\n" for line in lines))
        self._writer.flush()
        out = []
        for _ in lines:
            resp = self._reader.readline()
            if not resp:
                raise ConnectionError("server closed the connection")
            out.append(json.loads(resp))
        return out

    def mpc(self, start, goal, obstacles=None, **extra) -> dict:
        """Closed-loop episode (`path`, `reached`, `n_replans`, ...)."""
        return self.plan(start, goal, obstacles, mpc=True, **extra)

    def stats(self) -> dict:
        """Process-level serving counters (the `stats` protocol line):
        dispatches, requests, mean dispatch batch, pad fraction."""
        return self._send_line("stats")

    def reload(self) -> dict:
        """Hot-swap the server to its workdir's latest best checkpoint
        (the `reload` protocol line).  Returns
        ``{"reloaded": true, "step": N}`` or raises
        :class:`ServerError`."""
        resp = self._send_line("reload")
        self._raise_for_error(resp)
        return resp

    # -- lifecycle -------------------------------------------------------

    def close(self) -> list:
        """Send `quit`, let a spawned server finish and release the
        transport; returns the JSON lines the server wrote after `quit`
        (the CLI's ``{"served": N}``).  Idempotent: a second call
        returns []."""
        if self._closed:
            return []
        self._closed = True
        try:
            self._writer.write("quit\n")
            self._writer.flush()
        except (OSError, ValueError):
            pass  # transport already gone; still release resources
        tail = ""
        for proc in self._owned:
            try:
                tail, _ = proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        for f in (self._reader, self._writer):
            try:
                f.close()
            except Exception:  # noqa: BLE001
                pass
        return [json.loads(line) for line in (tail or "").splitlines()
                if line.strip()]

    def __enter__(self) -> "PlanningClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
