"""The port's ``PlanningClient``, the client half of the serving protocol,
on the CPU: the cases of the JAX package's ``tests/test_client.py``.

Every socket has a timeout and every thread is joined with one.
"""

import io
import json
import os
import threading

import pytest

import ndivplanning_tpu_torch.planning.client as client_mod
from ndivplanning_tpu_torch.planning import server as srv
from ndivplanning_tpu_torch.planning.client import (
    Overloaded,
    PlanningClient,
    ServerError,
)
from ndivplanning_tpu_torch.planning.server import serve, serve_tcp
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.utils.config import get_config

TIMEOUT = 60


def _cfg():
    return get_config("planning", batch_size=4, k=4, g_hidden=(32,),
                      d_hidden=(32,), cond_embed_dim=8, image_size=16,
                      n_candidates=32)


class _FakeReader:
    """A server that answers scripted replies, one a line."""

    def __init__(self, responses):
        self._resp = list(responses)

    def readline(self):
        return json.dumps(self._resp.pop(0)) + "\n"

    def close(self):
        pass


def test_client_tcp_plan_batch_and_errors():
    cfg = _cfg()
    server = serve_tcp(cfg, create_train_state(cfg, device="cpu"), port=0)
    host, port = server.server_address[:2]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with PlanningClient.tcp(host, port, timeout=TIMEOUT) as c:
            resp = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9],
                          obstacles=[[0.5, 0.5, 0.1]])
            assert len(resp["best_traj"]) == cfg.horizon
            out = c.plan_batch([
                {"start": [0.2, 0.2], "goal": [0.8, 0.8]},
                {"start": [0.3, 0.1], "goal": [0.7, 0.9]}])
            assert len(out) == 2 and all("best_score" in r for r in out)
            # Per-position error isolation surfaces as ServerError...
            with pytest.raises(ServerError, match="request 1"):
                c.plan_batch([{"start": [0.1, 0.1], "goal": [0.9, 0.9]},
                              {"goal": [0.9, 0.9]}])
            # ...or as raw dicts when the caller wants them.
            raw = c.plan_batch(
                [{"start": [0.1, 0.1], "goal": [0.9, 0.9]},
                 {"goal": [0.9, 0.9]}], raise_on_error=False)
            assert "best_score" in raw[0] and "error" in raw[1]
            with pytest.raises(ServerError):
                c.plan(start=[0.1], goal=[0.9, 0.9])  # bad shape
            # The connection is still healthy after error replies.
            assert "best_score" in c.plan(start=[0.2, 0.1],
                                          goal=[0.9, 0.9])
        # close() is idempotent, over TCP it returns no tail, and use
        # after it is a clear error.
        assert c.close() == []
        with pytest.raises(RuntimeError, match="closed"):
            c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
        assert c._owned[0].fileno() == -1  # the socket was closed
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    assert server.lines_served == 6


def test_client_over_pipes_with_mpc(monkeypatch):
    """The same client drives a serve() loop over raw OS pipes, a
    closed-loop request included."""
    monkeypatch.setattr(srv, "MPC_TOTAL_STEPS", 8)
    monkeypatch.setattr(srv, "MPC_REPLAN_EVERY", 4)
    monkeypatch.setattr(srv, "MPC_CANDIDATES", 8)
    cfg = _cfg()
    state = create_train_state(cfg, device="cpu")
    in_r, in_w = os.pipe()
    out_r, out_w = os.pipe()
    t = threading.Thread(
        target=serve, args=(cfg, state),
        kwargs={"stdin": os.fdopen(in_r, "r"),
                "stdout": os.fdopen(out_w, "w")}, daemon=True)
    t.start()
    with PlanningClient(os.fdopen(out_r, "r"), os.fdopen(in_w, "w")) as c:
        assert "best_score" in c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
        ep = c.mpc(start=[0.2, 0.1], goal=[0.9, 0.8])
        assert len(ep["path"]) == 8 and ep["n_replans"] == 2
    t.join(timeout=TIMEOUT)  # close() sent quit: the loop ended
    assert not t.is_alive()


def test_client_spawn_lifecycle(tmp_path):
    """spawn() owns a child process: requests round-trip over its pipes
    and close() reaps it (a stub server module)."""
    stub = tmp_path / "stub_cli.py"
    stub.write_text(
        "import json, sys\n"
        "assert sys.argv[1] == 'serve'\n"
        "for line in sys.stdin:\n"
        "    line = line.strip()\n"
        "    if line == 'quit':\n"
        "        break\n"
        "    req = json.loads(line)\n"
        "    print(json.dumps({'best_score': 1.0, 'echo': req}),"
        " flush=True)\n")
    c = PlanningClient.spawn(
        ["--preset", "x"], module="stub_cli",
        env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    resp = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
    assert resp["best_score"] == 1.0
    assert resp["echo"]["start"] == [0.1, 0.1]
    proc = c._owned[0]
    assert c.close() == []
    assert c.close() == []  # idempotent
    assert proc.poll() is not None  # reaped, not leaked


def test_client_overload_retry_honors_hint():
    """Overloaded and deadline replies raise the Overloaded subclass with
    the server's retry_ms; plan(retries=N) sleeps and sends again."""
    scripted = [
        {"error": "overloaded", "retry_ms": 1},
        {"error": "deadline_exceeded"},
        {"best_traj": [[0.1, 0.1]], "best_score": 0.5},
    ]
    writer = io.StringIO()
    c = PlanningClient(_FakeReader(scripted), writer)
    resp = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9], retries=2)
    assert resp["best_score"] == 0.5
    assert writer.getvalue().count("\n") == 3  # the first send, 2 retries

    c2 = PlanningClient(
        _FakeReader([{"error": "overloaded", "retry_ms": 7}]),
        io.StringIO())
    with pytest.raises(Overloaded) as exc:
        c2.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
    assert exc.value.retry_ms == 7
    assert isinstance(exc.value, ServerError)

    # Retries run out: the last shed escapes, after exactly `retries`.
    writer = io.StringIO()
    c3 = PlanningClient(_FakeReader([{"error": "deadline_exceeded"}] * 2),
                        writer)
    with pytest.raises(Overloaded, match="deadline_exceeded") as exc:
        c3.plan(start=[0.1, 0.1], goal=[0.9, 0.9], retries=1)
    assert exc.value.retry_ms == 0
    assert writer.getvalue().count("\n") == 2


def test_plan_batch_shed_raises_overloaded_with_position():
    """A shed position of a batch reply keeps its Overloaded type and
    retry_ms; other errors stay plain ServerErrors, position-tagged."""
    batch_reply = [{"best_traj": [[0.1, 0.1]], "best_score": 0.5},
                   {"error": "overloaded", "retry_ms": 9}]
    c = PlanningClient(_FakeReader([batch_reply]), io.StringIO())
    with pytest.raises(Overloaded) as exc:
        c.plan_batch([{"start": [0.1, 0.1], "goal": [0.9, 0.9]},
                      {"start": [0.2, 0.2], "goal": [0.8, 0.8]}])
    assert exc.value.retry_ms == 9
    assert "request 1" in str(exc.value)

    c2 = PlanningClient(_FakeReader([[{"error": "bad request: no start"}]]),
                        io.StringIO())
    with pytest.raises(ServerError, match="request 0") as exc:
        c2.plan_batch([{"goal": [0.9, 0.9]}])
    assert not isinstance(exc.value, Overloaded)


def test_client_retry_sleeps_exact_hint(monkeypatch):
    """The server's retry_ms is slept as given; 50 ms only for a reply
    without one (a deadline shed)."""
    slept = []
    monkeypatch.setattr(client_mod.time, "sleep", slept.append)
    scripted = [
        {"error": "overloaded", "retry_ms": 10},
        {"error": "deadline_exceeded"},
        {"best_traj": [[0.1, 0.1]], "best_score": 0.5},
    ]
    c = PlanningClient(_FakeReader(scripted), io.StringIO())
    resp = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9], retries=2)
    assert resp["best_score"] == 0.5
    assert slept == [0.010, 0.050]


def test_client_tcp_connect_timeout_and_refusal():
    """A port with no server behind it fails the connect at once."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # bound once, now nobody listens on it
    with pytest.raises(ConnectionRefusedError):
        PlanningClient.tcp("127.0.0.1", port, timeout=5)
