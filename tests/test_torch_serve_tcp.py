"""The torch port's network serving stack on the CPU.

``serve_tcp``'s answers are held against the JAX package's ``serve_tcp``
on the vendored planning512 model, both servers in this process on
ephemeral ports, the port replaying JAX's per-connection key chain
(``PRNGKey(seed + i)``, split once per burst, then ``handle_batch``'s
draws).  The cross-connection batcher runs one scripted submit sequence
beside JAX's, both with ``handle_batch`` stubbed, for the same dispatch
groupings, shed and expired sets and counters.  Then the TCP, batcher
and watcher cases of JAX's ``tests/test_server.py`` on a small random
model, the dispatch lock, and ``cli serve --tcp`` as a subprocess.

Every socket has a timeout and every thread is joined with one, so a
hang fails in seconds.
"""

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

import ndivplanning_tpu.planning.server as jax_srv
from ndivplanning_tpu_torch.cli import main
from ndivplanning_tpu_torch.planning import server as srv
from ndivplanning_tpu_torch.planning.client import PlanningClient
from ndivplanning_tpu_torch.planning.server import (
    BestWatcher,
    _CrossBatcher,
    serve,
    serve_tcp,
)
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.utils import checkpoint
from ndivplanning_tpu_torch.utils.config import get_config
from test_torch_server import N_PARITY, SCORE_TOL, jax_latents

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60  # seconds any socket read, join or wait may take


def _cfg():
    return get_config("planning", batch_size=4, k=4, g_hidden=(32,),
                      d_hidden=(32,), cond_embed_dim=8, image_size=16,
                      n_candidates=32)


def _state(cfg, seed=0):
    return create_train_state(cfg, seed=seed, device="cpu")


def _req(x=0.1, y=0.1):
    return {"start": [x, y], "goal": [0.9, 0.9]}


def _strip(obj):
    if isinstance(obj, list):
        return [_strip(o) for o in obj]
    return {k: v for k, v in obj.items() if k != "latency_ms"}


@contextlib.contextmanager
def running(server):
    """``server.serve_forever()`` on a thread; shut down and closed on
    exit.  Yields ``(host, port)``."""
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield server.server_address[:2]
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), "serve_forever did not stop"


def _tcp_lines(addr, payload, n_replies):
    """Send ``payload`` over a fresh connection and read ``n_replies``
    lines."""
    with socket.create_connection(addr, timeout=TIMEOUT) as s:
        s.sendall(payload.encode())
        f = s.makefile("r", encoding="utf-8")
        return [json.loads(f.readline()) for _ in range(n_replies)]


def _round_trips(addr, lines):
    """One connection: each line sent when the one before it is answered
    (so each is a burst of its own), ``quit`` last; the replies."""
    with socket.create_connection(addr, timeout=TIMEOUT) as s:
        f = s.makefile("rw", encoding="utf-8")
        out = []
        for line in lines:
            f.write(line + "\n")
            f.flush()
            if line != "quit":
                out.append(json.loads(f.readline()))
        return out


def _join_all(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


# -- against the JAX package ------------------------------------------------

PARITY_LINES = [
    json.dumps({"start": [0.1, 0.1], "goal": [0.9, 0.9],
                "obstacles": [[0.5, 0.5, 0.12], [0.3, 0.7, 0.08]]}),
    json.dumps([{"start": [0.2, 0.05], "goal": [0.85, 0.9]},
                {"start": [0.05, 0.3], "goal": [0.9, 0.6],
                 "obstacles": [[0.4, 0.5, 0.1], [0.7, 0.3, 0.1]]},
                {"start": [0.1, 0.2], "goal": [0.8, 0.9],
                 "obstacles": [[0.5, 0.5, 0.1]]}]),
    "not json",
    "stats",
]


def _assert_plan_close(got, want):
    assert got.keys() == want.keys()
    assert got["batch_size"] == want["batch_size"]
    assert got["best_reached"] == want["best_reached"]
    np.testing.assert_allclose(got["best_score"], want["best_score"],
                               **SCORE_TOL)
    for field in ("best_traj", "diverse_trajs"):
        np.testing.assert_allclose(np.asarray(got[field]),
                                   np.asarray(want[field]), **SCORE_TOL)


def test_serve_tcp_matches_jax_on_planning512(monkeypatch):
    """Two connections to JAX's ``serve_tcp`` and to the port's, one after
    the other, each line a round trip: connection 0 a single request, an
    array of 3, a malformed line, stats and quit; connection 1 a single
    request (its stream is ``seed + 1``'s).  The plans agree within
    SCORE_TOL, the error and stats lines in kind, and ``lines_served``."""
    from test_torch_checkpoint import jax_planning512, torch_planning512

    jcfg, jstate = jax_planning512()
    jcfg = jcfg.replace(n_candidates=N_PARITY)
    cfg, state = torch_planning512(n_candidates=N_PARITY)
    zdim = cfg.latent_dim
    chains = {}

    def replay(generator, shape):
        """JAX's per-connection chain: one split of PRNGKey(seed + i) per
        burst, then handle_batch's draws from the burst's key."""
        if tuple(shape) != (N_PARITY, zdim):
            return lambda bucket: pytest.fail(f"a draw of shape {shape}")
        seed = generator.initial_seed()
        key, sub = jax.random.split(
            chains.get(seed, jax.random.PRNGKey(seed)))
        chains[seed] = key
        return jax_latents(sub, N_PARITY, zdim)

    monkeypatch.setattr(srv, "_draw_latents", replay)
    sessions = ([*PARITY_LINES, "quit"], [PARITY_LINES[0], "quit"])
    replies, served = {}, {}
    for name, module, server in (
            ("jax", jax_srv, jax_srv.serve_tcp(jcfg, jstate, port=0)),
            ("torch", srv, serve_tcp(cfg, state, port=0))):
        before = module.serving_stats()
        with running(server) as addr:
            replies[name] = [_round_trips(addr, lines) for lines in sessions]
        served[name] = (server.lines_served, before)
    jax_replies, torch_replies = replies["jax"], replies["torch"]
    assert served["jax"][0] == served["torch"][0] == 5
    for jconn, tconn in zip(jax_replies, torch_replies):
        assert len(jconn) == len(tconn)
        for w, g in zip(jconn, tconn):
            if isinstance(w, list):
                assert len(g) == len(w) == 3
                for gi, wi in zip(g, w):
                    _assert_plan_close(gi, wi)
                    assert gi["batch_size"] == 4
            elif "best_traj" in w:
                _assert_plan_close(g, w)
            elif "error" in w:
                assert g["error"].split(":")[0] == w["error"].split(":")[0]
            else:  # stats: the same keys, the same deltas
                assert g.keys() == w.keys()
    for name, conn in replies.items():
        stats, before = conn[0][3], served[name][1]
        assert stats["dispatches"] - before["dispatches"] == 2
        assert stats["requests"] - before["requests"] == 4
    # The two connections drew from two streams.
    assert (jax_replies[0][0]["best_traj"] != jax_replies[1][0]["best_traj"])
    assert (torch_replies[0][0]["best_traj"]
            != torch_replies[1][0]["best_traj"])


def _batcher_script(module, monkeypatch, cfg, state):
    """One submit sequence through ``module._CrossBatcher`` with
    ``handle_batch`` stubbed and the first dispatch gated: the dispatch
    groupings (request ids), each id's reply, and the counters' deltas."""
    groups = []
    gate = threading.Event()
    hold = [True]  # gate the next dispatch

    def stub(cfg_, state_, reqs, key, **kw):
        groups.append([r["id"] for r in reqs])
        if hold:
            hold.pop()
            gate.wait(timeout=TIMEOUT)
        out = kw["out"]
        for i, r in enumerate(reqs):
            out[i] = {"id": r["id"], "batch_size": len(reqs)}
            kw["on_progress"]()
        return out

    def wait_dispatched(n):
        deadline = time.monotonic() + TIMEOUT
        while len(groups) < n:
            assert time.monotonic() < deadline, "the dispatcher stalled"
            time.sleep(0.001)

    monkeypatch.setattr(module, "handle_batch", stub)
    before = module.serving_stats()
    pendings = {}

    def submit(b, ids, stale=False):
        # A stale arrival has waited 10 s already: past any deadline here.
        arrival = time.perf_counter() - (10.0 if stale else 0.0)
        pendings.update(zip(ids, b.submit([{"id": i} for i in ids],
                                          arrival)))

    def wait_all():
        for i, p in pendings.items():
            assert p.event.wait(timeout=TIMEOUT), f"request {i} hung"

    b = module._CrossBatcher(cfg, state, max_pending=4, deadline_ms=1000)
    try:
        submit(b, [0])
        wait_dispatched(1)  # 0 in flight, held at the gate
        submit(b, [1, 2])  # admitted: 3 pending
        submit(b, [3], stale=True)  # admitted: 4 pending, expires
        submit(b, [4])  # shed: 5 > 4
        submit(b, [5, 6, 7])  # shed
        gate.set()
        wait_all()
        submit(b, list(range(8, 14)))  # idle: 6 > 4 admitted all the same
        wait_all()
    finally:
        gate.set()
        b.close()
    # No admission control: bursts queued behind a held dispatch are
    # drained while the batch is short of max_batch (16).
    gate.clear()
    hold.append(True)
    b = module._CrossBatcher(cfg, state)
    try:
        submit(b, [100])
        wait_dispatched(len(groups) + 1)
        for j in range(10):
            submit(b, [200 + 3 * j + m for m in range(3)])
        gate.set()
        wait_all()
    finally:
        gate.set()
        b.close()
    after = module.serving_stats()
    return (groups, {i: p.result for i, p in pendings.items()},
            {k: after[k] - before[k]
             for k in ("shed_requests", "expired_requests", "dispatches")})


def test_cross_batcher_matches_jax(monkeypatch):
    """One scripted submit sequence through JAX's batcher and the port's:
    the same dispatch groupings, shed and expired sets and counters."""
    cfg = _cfg()
    jax_run = _batcher_script(jax_srv, monkeypatch, None, None)
    torch_run = _batcher_script(srv, monkeypatch, cfg, _state(cfg))
    groups, results, deltas = torch_run
    assert groups == jax_run[0]
    assert groups == [[0], [1, 2], list(range(8, 14)), [100],
                      list(range(200, 218)), list(range(218, 230))]
    assert deltas == jax_run[2] == {"shed_requests": 4,
                                    "expired_requests": 1, "dispatches": 0}

    def kinds(res):
        return {i: (r.get("error", "plan"), sorted(r)) for i, r in
                res.items()}
    assert kinds(results) == kinds(jax_run[1])
    assert {i for i, r in results.items()
            if r.get("error") == "overloaded"} == {4, 5, 6, 7}
    assert {i for i, r in results.items()
            if r.get("error") == "deadline_exceeded"} == {3}
    for res in (results, jax_run[1]):
        assert all(res[i]["retry_ms"] >= 1 for i in (4, 5, 6, 7))
        assert res[3]["deadline_ms"] == 1000.0 and res[3]["waited_ms"] > 1e4
        assert res[9] == {"id": 9, "batch_size": 6}


# -- the JAX package's behaviours -------------------------------------------

def test_serve_tcp_round_trip():
    """TCP answers the JSON-lines protocol per connection, and
    ``lines_served`` sums over connections."""
    cfg = _cfg()
    server = serve_tcp(cfg, _state(cfg), port=0)
    with running(server) as addr:
        lines = _tcp_lines(addr, json.dumps(_req()) + "\nquit\n", 1)
        assert len(lines[0]["best_traj"]) == cfg.horizon
        out = _tcp_lines(addr, json.dumps(_req(0.2, 0.2)) + "\nquit\n", 1)
        assert "best_score" in out[0]
    assert server.lines_served == 2


def test_serve_tcp_error_isolation_and_disconnect():
    """A malformed line gets its own error over TCP, and a client that
    resets its connection mid-request leaves the server serving."""
    cfg = _cfg()
    server = serve_tcp(cfg, _state(cfg), port=0)
    with running(server) as addr:
        s = socket.create_connection(addr, timeout=TIMEOUT)
        s.sendall((json.dumps(_req()) + "\n").encode())
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     b"\x01\x00\x00\x00\x00\x00\x00\x00")  # RST on close
        s.close()
        lines = _tcp_lines(addr, "not json\n" + json.dumps(_req(0.2, 0.2))
                           + "\nquit\n", 2)
        assert "error" in lines[0]
        assert "best_score" in lines[1]


def test_serve_tcp_burst_coalesces_per_connection():
    """A burst written at once on a socket is read raw and planned in one
    dispatch, as on a pipe."""
    cfg = _cfg()
    server = serve_tcp(cfg, _state(cfg), port=0)
    with running(server) as addr:
        lines = _tcp_lines(addr, "".join(json.dumps(_req(0.1 * i)) + "\n"
                                         for i in range(1, 4)) + "quit\n", 3)
    assert [r["batch_size"] for r in lines] == [4, 4, 4]


def _gated_handle_batch(monkeypatch):
    """``srv.handle_batch`` held at a gate until released; returns (gate,
    the number of calls so far as a list)."""
    gate = threading.Event()
    calls = []
    real = srv.handle_batch

    def gated(*args, **kw):
        calls.append(1)
        gate.wait(timeout=TIMEOUT)
        return real(*args, **kw)

    monkeypatch.setattr(srv, "handle_batch", gated)
    return gate, calls


def _wait_for(cond, what):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


def test_cross_batcher_coalesces_across_submits(monkeypatch):
    """While dispatch N runs, submits of other connections queue and ride
    dispatch N+1 together, each answered with its own plan."""
    cfg = _cfg()
    sizes = []
    gate = threading.Event()
    real = srv.handle_batch

    def gated(cfg_, state_, reqs, gen, **kw):
        sizes.append(len(reqs))
        if len(sizes) == 1:
            gate.wait(timeout=TIMEOUT)
        return real(cfg_, state_, reqs, gen, **kw)

    monkeypatch.setattr(srv, "handle_batch", gated)
    b = _CrossBatcher(cfg, _state(cfg))
    try:
        first = b.submit([_req()], 0.0)
        _wait_for(lambda: sizes, "the first dispatch")
        later = [b.submit([_req(0.1 + 0.05 * i)], 0.0)[0] for i in range(5)]
        gate.set()
        for p in first + later:
            assert p.event.wait(timeout=TIMEOUT)
            assert "best_score" in p.result, p.result
        assert sizes == [1, 5]
        assert all(p.result["batch_size"] == 8 for p in later)
        assert len({tuple(p.result["best_traj"][0]) for p in later}) > 1
    finally:
        gate.set()
        b.close()


def test_serve_tcp_cross_batch_concurrent_clients():
    """Concurrent clients of a cross-batching server each get their own
    answer, a malformed request its own error."""
    cfg = _cfg()
    server = serve_tcp(cfg, _state(cfg), port=0, cross_batch=True)
    results = {}

    def client(i, addr):
        payload = (json.dumps({"goal": [0.9, 0.9]}) if i == 2
                   else json.dumps(_req(0.1 + 0.05 * i)))
        results[i] = _tcp_lines(addr, payload + "\nquit\n", 1)[0]

    with running(server) as addr:
        threads = [threading.Thread(target=client, args=(i, addr))
                   for i in range(6)]
        for t in threads:
            t.start()
        _join_all(threads)
    assert sorted(results) == list(range(6))
    assert "error" in results[2]
    firsts = {tuple(results[i]["best_traj"][0]) for i in (0, 1, 3, 4, 5)}
    assert len(firsts) > 1
    assert server.lines_served == 6


def test_cross_batcher_close_fails_queued_requests(monkeypatch):
    """``close()`` lets the bursts queued before it finish and fails a
    burst that arrives after it, leaving no connection waiting."""
    cfg = _cfg()
    gate, calls = _gated_handle_batch(monkeypatch)
    b = _CrossBatcher(cfg, _state(cfg))
    try:
        pre = b.submit([_req(0.2)], 0.0)[0]
        _wait_for(lambda: calls, "the first dispatch")
        closer = threading.Thread(target=b.close, daemon=True)
        closer.start()
        _wait_for(lambda: b._q.qsize() >= 1, "the stop marker")
        post = b.submit([_req(0.3)], 0.0)[0]
        gate.set()
        assert pre.event.wait(timeout=TIMEOUT)
        assert "best_score" in pre.result, pre.result
        assert post.event.wait(timeout=TIMEOUT)
        assert post.result == {"error": "server shutting down"}
        closer.join(timeout=TIMEOUT)
        assert not closer.is_alive()
        late = b.submit([_req(0.4)], 0.0)[0]  # after close: fails at once
        assert late.event.is_set() and "error" in late.result
    finally:
        gate.set()


def test_cross_batcher_survives_a_failed_dispatch(monkeypatch):
    """A dispatch that raises answers its own requests with the error; the
    dispatcher keeps serving the next ones and releases every slot."""
    cfg = _cfg()
    real = srv.handle_batch
    calls = []

    def failing_once(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device fell over")
        return real(*args, **kw)

    monkeypatch.setattr(srv, "handle_batch", failing_once)
    b = _CrossBatcher(cfg, _state(cfg), max_pending=2)
    try:
        bad = b.submit([_req(), _req(0.2)], time.perf_counter())
        for p in bad:
            assert p.event.wait(timeout=TIMEOUT)
            assert p.result == {"error": "RuntimeError: device fell over"}
        good = b.submit([_req(0.3), _req(0.4)], time.perf_counter())
        for p in good:
            assert p.event.wait(timeout=TIMEOUT)
            assert "best_score" in p.result
        assert b._pending_n == 0
    finally:
        b.close()


def test_stats_over_tcp_through_the_client():
    """The ``stats`` line over TCP through the client: process-wide
    counters that move by one dispatch per plan."""
    cfg = _cfg()
    server = serve_tcp(cfg, _state(cfg), port=0)
    with running(server) as (host, port):
        with PlanningClient.tcp(host, port, timeout=TIMEOUT) as c:
            before = c.stats()
            c.plan(start=[0.2, 0.1], goal=[0.9, 0.9])
            after = c.stats()
    assert after["dispatches"] == before["dispatches"] + 1
    assert after["requests"] == before["requests"] + 1


def _batcher_answers(cfg, state, n):
    """A fresh batcher's answers to ``_req()`` sent ``n`` times, each
    after the one before it was answered (a dispatch each)."""
    b = _CrossBatcher(cfg, state)
    out = []
    try:
        for _ in range(n):
            p = b.submit([_req()], 0.0)[0]
            assert p.event.wait(timeout=TIMEOUT)
            out.append(p.result)
    finally:
        b.close()
    return out


def test_reload_swaps_cross_batcher_state():
    """In cross-batch mode a ``reload`` swaps the dispatcher's state: a
    later connection plans on the new weights, bitwise a fresh batcher's
    second draw on them."""
    cfg = _cfg()
    state_a, state_b = _state(cfg, 0), _state(cfg, 1)
    server = serve_tcp(cfg, state_a, port=0, cross_batch=True,
                       reload_fn=lambda: state_b)
    with running(server) as (host, port):
        with PlanningClient.tcp(host, port, timeout=TIMEOUT) as c1:
            before = c1.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
            assert c1.reload() == {"reloaded": True, "step": 0}
        with PlanningClient.tcp(host, port, timeout=TIMEOUT) as c2:
            after = c2.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
    assert before["best_traj"] != after["best_traj"]
    assert _strip(after) == _strip(_batcher_answers(cfg, state_b, 2)[1])


def test_best_watcher_detects_marker_change(tmp_path):
    marker = tmp_path / "best_path.json"
    loads = []
    sentinel = object()

    def reload_fn():
        loads.append(1)
        return sentinel

    # A long poll: the thread sleeps and the test drives check_now().
    w = BestWatcher(reload_fn, str(marker), poll_s=3600.0)
    try:
        assert w.check_now() is False  # no marker yet
        assert w.current() == (0, None)
        marker.write_text('{"eval_path": "ema", "value": 0.5}')
        before = srv.SERVING_STATS["auto_reloads"]
        swaps = []
        w.on_swap(swaps.append)
        assert w.check_now() is True
        assert w.current() == (1, sentinel)
        assert swaps == [sentinel]
        assert srv.SERVING_STATS["auto_reloads"] == before + 1
        assert w.check_now() is False  # unchanged: no load
        assert loads == [1]
        marker.write_text('{"eval_path": "raw", "value": 0.75}')
        assert w.check_now() is True
        assert w.current()[0] == 2
    finally:
        w.stop()
    assert not w._thread.is_alive()


def test_best_watcher_retries_a_failed_load(tmp_path):
    """A load that raises or finds nothing leaves the marker unseen: the
    next poll loads again, and succeeds once the load does."""
    marker = tmp_path / "best_path.json"
    outcomes = [RuntimeError("half-written checkpoint"), None, "state"]
    calls = []

    def reload_fn():
        calls.append(1)
        out = outcomes.pop(0)
        if isinstance(out, Exception):
            raise out
        return out

    w = BestWatcher(reload_fn, str(marker), poll_s=3600.0)
    try:
        marker.write_text("{}")
        assert w.check_now() is False  # raised
        assert w.check_now() is False  # found nothing
        assert w.current() == (0, None)
        assert w.check_now() is True
        assert w.current() == (1, "state") and len(calls) == 3
        assert w.check_now() is False
    finally:
        w.stop()


def test_best_watcher_polls_on_its_thread(tmp_path):
    marker = tmp_path / "best_path.json"
    w = BestWatcher(lambda: "new", str(marker), poll_s=0.01)
    try:
        marker.write_text("{}")
        _wait_for(lambda: w.current()[0] == 1, "the watcher's poll")
        assert w.current() == (1, "new")
    finally:
        w.stop()
    assert not w._thread.is_alive()


def test_serve_uses_watcher_state(tmp_path):
    """A serving loop started after the watcher swapped answers from the
    new weights, not the boot state."""
    cfg = _cfg()
    state_boot, state_new = _state(cfg, 0), _state(cfg, 100)
    marker = tmp_path / "best_path.json"
    w = BestWatcher(lambda: state_new, str(marker), poll_s=3600.0)
    req = json.dumps(_req()) + "\nquit\n"

    def first_answer(state, **kw):
        out = io.StringIO()
        serve(cfg, state, stdin=io.StringIO(req), stdout=out, **kw)
        return json.loads(out.getvalue().splitlines()[0])

    try:
        marker.write_text("{}")
        assert w.check_now() is True
        got = first_answer(state_boot, watcher=w)
    finally:
        w.stop()
    want = first_answer(state_new)
    assert got["best_traj"] == want["best_traj"]
    assert first_answer(state_boot)["best_traj"] != want["best_traj"]


def test_watcher_swaps_mid_session_at_a_burst_boundary(tmp_path):
    """A swap while a connection is open applies from its next burst."""
    cfg = _cfg()
    state_a, state_b = _state(cfg, 0), _state(cfg, 1)
    marker = tmp_path / "best_path.json"
    w = BestWatcher(lambda: state_b, str(marker), poll_s=3600.0)
    server = serve_tcp(cfg, state_a, port=0, cross_batch=True, watcher=w)
    try:
        with running(server) as (host, port):
            with PlanningClient.tcp(host, port, timeout=TIMEOUT) as c:
                first = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
                marker.write_text("{}")
                assert w.check_now() is True
                second = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
                stats = c.stats()
    finally:
        w.stop()
    assert stats["auto_reloads"] >= 1
    # The dispatcher's second draw, on the new weights.
    want = _batcher_answers(cfg, state_b, 2)
    assert _strip(second) == _strip(want[1])
    assert _strip(first) != _strip(want[0])


def test_cross_batcher_sheds_over_max_pending(monkeypatch):
    """Past ``max_pending`` requests queued or in flight a submit is
    refused with ``overloaded`` and a retry hint; completions release the
    budget."""
    cfg = _cfg()
    gate, calls = _gated_handle_batch(monkeypatch)
    b = _CrossBatcher(cfg, _state(cfg), max_pending=2)
    try:
        shed_before = srv.SERVING_STATS["shed_requests"]
        first = b.submit([_req()], time.perf_counter())[0]
        _wait_for(lambda: calls, "the first dispatch")
        second = b.submit([_req(0.2)], time.perf_counter())[0]
        shed = b.submit([_req(0.3)], time.perf_counter())[0]
        assert shed.event.wait(timeout=TIMEOUT)
        assert shed.result["error"] == "overloaded"
        assert shed.result["retry_ms"] >= 1
        assert srv.SERVING_STATS["shed_requests"] == shed_before + 1
        gate.set()
        for p in (first, second):
            assert p.event.wait(timeout=TIMEOUT)
            assert "best_score" in p.result, p.result
        third = b.submit([_req(0.4)], time.perf_counter())[0]
        assert third.event.wait(timeout=TIMEOUT)
        assert "best_score" in third.result
    finally:
        gate.set()
        b.close()


def test_cross_batcher_staggers_retry_hints(monkeypatch):
    """Each shed burst is told when the dispatches ahead of it will have
    run, counting the requests shed before it and not yet drained,
    ``max_pending`` a dispatch: clients told to retry come back spread out
    instead of all at once.  A dispatch drains ``max_pending`` of them."""
    cfg = _cfg()
    gate, calls = _gated_handle_batch(monkeypatch)
    b = _CrossBatcher(cfg, _state(cfg), max_pending=2)
    try:
        first = b.submit([_req()], time.perf_counter())[0]
        _wait_for(lambda: calls, "the first dispatch")
        second = b.submit([_req(0.2)], time.perf_counter())[0]
        b._ema_dispatch_s = 0.1  # 100 ms a dispatch while the gate holds
        shed = [b.submit([_req(0.3)], time.perf_counter())[0]
                for _ in range(5)]
        assert [p.result["retry_ms"] for p in shed] == [100, 200, 200, 300,
                                                        300]
        gate.set()
        for p in (first, second):
            assert p.event.wait(timeout=TIMEOUT)
            assert "best_score" in p.result, p.result
        assert b._shed_n == 3  # second's dispatch drained 2 of the 5
    finally:
        gate.set()
        b.close()


def test_cross_batcher_forgets_sheds_past_their_hints(monkeypatch):
    """Shed clients that never come back do not inflate later hints: once
    the latest hint given and one dispatch more have passed, a new shed
    burst counts only what is pending."""
    cfg = _cfg()
    gate, calls = _gated_handle_batch(monkeypatch)
    b = _CrossBatcher(cfg, _state(cfg), max_pending=2)
    try:
        first = b.submit([_req()], time.perf_counter())[0]
        _wait_for(lambda: calls, "the first dispatch")
        second = b.submit([_req(0.2)], time.perf_counter())[0]
        b._ema_dispatch_s = 0.2  # 200 ms a dispatch while the gate holds
        shed = [b.submit([_req(0.3)], time.perf_counter())[0]
                for _ in range(4)]
        assert [p.result["retry_ms"] for p in shed] == [200, 400, 400, 600]
        assert b._shed_n == 4
        time.sleep(1.0)  # past the latest hint (600 ms) and a dispatch
        late = b.submit([_req(0.3)], time.perf_counter())[0]
        assert late.result["retry_ms"] == 200  # the 2 pending only
        assert b._shed_n == 1
        gate.set()
        for p in (first, second):
            assert p.event.wait(timeout=TIMEOUT)
            assert "best_score" in p.result, p.result
    finally:
        gate.set()
        b.close()


def test_cross_batcher_deadline_drops_stale(monkeypatch):
    """An admitted request that queued past ``deadline_ms`` is answered
    ``deadline_exceeded`` at dispatch time; the batcher keeps serving."""
    cfg = _cfg()
    gate, calls = _gated_handle_batch(monkeypatch)
    b = _CrossBatcher(cfg, _state(cfg), deadline_ms=30.0)
    try:
        expired_before = srv.SERVING_STATS["expired_requests"]
        first = b.submit([_req()], time.perf_counter())[0]
        _wait_for(lambda: calls, "the first dispatch")
        stale = b.submit([_req(0.2)], time.perf_counter())[0]
        time.sleep(0.1)
        gate.set()
        assert first.event.wait(timeout=TIMEOUT)
        assert "best_score" in first.result
        assert stale.event.wait(timeout=TIMEOUT)
        assert stale.result["error"] == "deadline_exceeded"
        assert stale.result["waited_ms"] > 30.0
        assert stale.result["deadline_ms"] == 30.0
        assert srv.SERVING_STATS["expired_requests"] == expired_before + 1
        fresh = b.submit([_req(0.3)], time.perf_counter())[0]
        assert fresh.event.wait(timeout=TIMEOUT)
        assert "best_score" in fresh.result
        assert b._pending_n == 0
    finally:
        gate.set()
        b.close()


def test_stats_exposes_load_control_counters():
    s = srv.serving_stats()
    assert "shed_requests" in s and "expired_requests" in s
    before = srv.serving_stats()
    srv._record_load_control(shed=2, expired=1)
    after = srv.serving_stats()
    assert after["shed_requests"] == before["shed_requests"] + 2
    assert after["expired_requests"] == before["expired_requests"] + 1


def test_cross_batcher_admits_oversized_burst_when_idle(monkeypatch):
    """A burst larger than ``max_pending`` is admitted when nothing is
    pending; with a request in flight the cap applies."""
    cfg = _cfg()
    state = _state(cfg)
    b = _CrossBatcher(cfg, state, max_pending=2)
    try:
        burst = b.submit([_req(0.1 * (i + 1)) for i in range(5)],
                         time.perf_counter())
        for p in burst:
            assert p.event.wait(timeout=TIMEOUT)
            assert "best_score" in p.result
    finally:
        b.close()
    gate, calls = _gated_handle_batch(monkeypatch)
    b = _CrossBatcher(cfg, state, max_pending=2)
    try:
        first = b.submit([_req()], time.perf_counter())[0]
        _wait_for(lambda: calls, "the first dispatch")
        shed = b.submit([_req(0.1 * (i + 1), 0.2) for i in range(5)],
                        time.perf_counter())
        for p in shed:
            assert p.event.wait(timeout=TIMEOUT)
            assert p.result["error"] == "overloaded"
        gate.set()
        assert first.event.wait(timeout=TIMEOUT)
        assert "best_score" in first.result
    finally:
        gate.set()
        b.close()


def test_serve_tcp_cross_batch_over_the_limit_answers_every_line():
    """Over TCP, every request of a shed burst carries the overload error
    in its own position; the burst admitted beside it plans."""
    cfg = _cfg()
    server = serve_tcp(cfg, _state(cfg), port=0, cross_batch=True,
                       max_pending=1)
    gate = threading.Event()
    real = srv.handle_batch
    calls = []

    def gated(*args, **kw):
        calls.append(1)
        gate.wait(timeout=TIMEOUT)
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(srv, "handle_batch", gated)
        with running(server) as (host, port):
            with PlanningClient.tcp(host, port, timeout=TIMEOUT) as c0, \
                    PlanningClient.tcp(host, port, timeout=TIMEOUT) as c1:
                answers = {}
                t = threading.Thread(target=lambda: answers.update(
                    first=c0.plan(start=[0.1, 0.1], goal=[0.9, 0.9])))
                t.start()
                _wait_for(lambda: calls, "the first dispatch")
                shed = c1.plan_batch([_req(0.2), _req(0.3)],
                                     raise_on_error=False)
                gate.set()
                _join_all([t])
    assert [r["error"] for r in shed] == ["overloaded"] * 2
    assert "best_score" in answers["first"]


def test_serve_tcp_bind_failure_closes_the_batcher():
    """A failed bind raises the bind's own error and leaves no dispatcher
    thread behind."""
    cfg = _cfg()
    state = _state(cfg)
    server = serve_tcp(cfg, state, port=0)
    try:
        _, port = server.server_address[:2]
        before = {t.name for t in threading.enumerate()}
        with pytest.raises(OSError) as err:
            serve_tcp(cfg, state, port=port, cross_batch=True)
        assert err.value.errno is not None
        _wait_for(lambda: sum(t.name == "cross-batcher"
                              for t in threading.enumerate())
                  <= sum(name == "cross-batcher" for name in before),
                  "the dispatcher to exit")
    finally:
        server.server_close()


def test_server_close_waits_for_a_live_connection(monkeypatch):
    """``server_close`` gives a connection still answering its last line
    time to finish, so ``lines_served`` counts it."""
    cfg = _cfg()
    real = srv.handle_batch

    def slow(*args, **kw):
        time.sleep(0.3)
        return real(*args, **kw)

    monkeypatch.setattr(srv, "handle_batch", slow)
    server = serve_tcp(cfg, _state(cfg), port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    s = socket.create_connection(server.server_address[:2], timeout=TIMEOUT)
    try:
        s.sendall((json.dumps(_req()) + "\nquit\n").encode())
        _wait_for(lambda: server._handler_threads, "the handler")
        server.shutdown()
        server.server_close()
        t.join(timeout=TIMEOUT)
        assert server.lines_served == 1
    finally:
        s.close()


# -- the dispatch lock ------------------------------------------------------

def _connect_in_order(addr):
    """A client whose connection has taken its id: the ``stats`` round
    trip returns once the server's handler runs, so connections opened
    one after another get ids 0, 1, ... in that order."""
    c = PlanningClient.tcp(*addr, timeout=TIMEOUT)
    c.stats()
    return c


def test_concurrent_connections_answer_what_each_answers_alone(monkeypatch):
    """Two connections driven at once answer bitwise what each answers on
    a fresh server alone, and no two dispatches overlap: each holds the
    process-wide lock around its device work."""
    cfg = _cfg()
    state = _state(cfg)
    lines = {0: [json.dumps(_req(0.1, 0.1)), json.dumps([_req(0.2, 0.1),
                                                         _req(0.3, 0.2)]),
                 json.dumps(_req(0.4, 0.1))],
             1: [json.dumps(_req(0.1, 0.3)), json.dumps(_req(0.2, 0.4)),
                 json.dumps([_req(0.3, 0.3)] * 3)]}
    real = srv._serve_plan_program
    spans = []

    def recorded(*args, **kw):
        assert srv._DISPATCH_LOCK.locked()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        time.sleep(0.005)  # widen the window an overlap would show in
        spans.append((t0, time.perf_counter()))
        return out

    monkeypatch.setattr(srv, "_serve_plan_program", recorded)

    def drive(addr, together):
        clients = [_connect_in_order(addr) for _ in (0, 1)]
        answers = {}

        def run(i):
            answers[i] = [clients[i]._send_line(line) for line in lines[i]]

        try:
            if together:
                threads = [threading.Thread(target=run, args=(i,))
                           for i in (0, 1)]
                for t in threads:
                    t.start()
                _join_all(threads)
            else:
                for i in (0, 1):
                    run(i)
        finally:
            for c in clients:
                c.close()
        return {i: _strip(a) for i, a in answers.items()}

    with running(serve_tcp(cfg, state, port=0)) as addr:
        together = drive(addr, together=True)
    with running(serve_tcp(cfg, state, port=0)) as addr:
        alone = drive(addr, together=False)
    assert together == alone
    assert together[0] != together[1]
    spans.sort()
    assert len(spans) == 12
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


# -- the CLI ----------------------------------------------------------------

SMALL_SETS = ["--set", "g_hidden=32", "--set", "d_hidden=32", "--set",
              "cond_embed_dim=8", "--set", "image_size=16", "--set",
              "n_candidates=32"]


@contextlib.contextmanager
def cli_tcp_server(workdir, *flags):
    """``cli serve --tcp 0`` as a subprocess on the CPU; yields (process,
    host, port) once it printed its ``listening`` line."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ndivplanning_tpu_torch.cli", "serve",
         "--preset", "planning", *SMALL_SETS, "--workdir", str(workdir),
         "--device", "cpu", "--tcp", "0", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        ready = {}
        reader = threading.Thread(target=lambda: ready.update(
            line=proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(timeout=120)
        assert ready.get("line"), (proc.poll(), "no listening line")
        host, port = json.loads(ready["line"])["listening"].rsplit(":", 1)
        yield proc, host, int(port)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=TIMEOUT)
        proc.stdout.close()
        proc.stderr.close()


def _interrupt(proc):
    """SIGINT, then the process's remaining stdout lines and exit code."""
    proc.send_signal(signal.SIGINT)
    out, _ = proc.communicate(timeout=TIMEOUT)
    return [json.loads(line) for line in out.splitlines()], proc.returncode


def test_cli_serve_tcp_listens_serves_and_reports_on_sigint(tmp_path):
    with cli_tcp_server(tmp_path) as (proc, host, port):
        with PlanningClient.tcp(host, port, timeout=TIMEOUT) as c:
            resp = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
            assert resp["batch_size"] == 1 and "best_traj" in resp
            assert "error" in c.send_lines(["not json"])[0]
        with PlanningClient.tcp(host, port, timeout=TIMEOUT) as c:
            assert len(c.plan_batch([_req(), _req(0.2)])) == 2
        lines, rc = _interrupt(proc)
    assert lines == [{"served": 3}] and rc == 0


def test_cli_serve_cross_batch_watch_best_swaps_weights(tmp_path):
    """``--cross-batch --max-pending --deadline-ms --watch-best
    --watch-poll`` wired together: a best checkpoint written under the
    workdir is picked up by the watcher and counted."""
    cfg = get_config("planning", g_hidden=(32,), d_hidden=(32,),
                     cond_embed_dim=8, image_size=16, n_candidates=32)
    with cli_tcp_server(tmp_path, "--cross-batch", "--max-pending", "8",
                        "--deadline-ms", "60000", "--watch-best",
                        "--watch-poll", "0.05") as (proc, host, port):
        with PlanningClient.tcp(host, port, timeout=TIMEOUT) as c:
            before = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
            state = create_train_state(cfg, seed=5, device="cpu")
            state.step = 7
            checkpoint.save_checkpoint(str(tmp_path / "best"), state)
            with open(tmp_path / "best" / "best_path.json", "w") as f:
                json.dump({"eval_path": "ema", "step": 7}, f)
            _wait_for(lambda: c.stats()["auto_reloads"] == 1,
                      "the watcher's reload")
            after = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
        lines, rc = _interrupt(proc)
    assert before["best_traj"] != after["best_traj"]
    assert rc == 0 and lines[-1]["served"] >= 3


def test_cli_watch_best_needs_a_workdir(capsys, monkeypatch, tmp_path):
    """With no workdir to watch (``--workdir ""``; without the flag the
    preset's default workdir is watched, as in the JAX CLI) the command
    exits 2 with the JAX CLI's message, before serving anything."""
    monkeypatch.chdir(tmp_path)
    assert main(["serve", "--watch-best", "--workdir", "", "--tcp", "0",
                 "--device", "cpu"]) == 2
    assert "--watch-best needs a --workdir" in capsys.readouterr().err


def test_cross_batcher_admission_budget_under_contention(monkeypatch):
    """More threads than cores submitting at once, with a short switch
    interval: the admitted requests never pass ``max_pending``, every
    request is answered once, and every slot is released."""
    cfg = _cfg()
    peak = [0]
    served = []

    def stub(cfg_, state_, reqs, gen, **kw):
        peak[0] = max(peak[0], b._pending_n)
        for i, r in enumerate(reqs):
            kw["out"][i] = {"id": r["id"]}
        served.extend(r["id"] for r in reqs)
        kw["on_progress"]()

    monkeypatch.setattr(srv, "handle_batch", stub)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    b = _CrossBatcher(cfg, _state(cfg), max_pending=8, max_batch=4)
    results = {}
    try:
        def client(c):
            for j in range(25):
                ids = [1000 * c + 10 * j + m for m in range(1 + j % 3)]
                for i, p in zip(ids, b.submit([{"id": i} for i in ids],
                                              time.perf_counter())):
                    assert p.event.wait(timeout=TIMEOUT)
                    results[i] = p.result

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range((os.cpu_count() or 1) + 2)]
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        sys.setswitchinterval(old)
        b.close()
    shed = {i for i, r in results.items() if r.get("error") == "overloaded"}
    assert sorted(served) == sorted(set(results) - shed)
    assert all(results[i] == {"id": i} for i in served)
    assert b._pending_n == 0
    assert peak[0] <= 8  # every burst is smaller than the cap
