"""The torch port's planning server on the CPU.

``handle_batch`` is held against the JAX package's on the vendored
planning512 model, with the latents drawn from JAX's own keys (its
threefry stream and torch's Philox never agree): ``split(key, 3)`` gives
the plan key, each dispatch chunk splits it once more and then into one
key per bucket slot, and each slot draws ``normal(k, (1, N, zdim))``.
Then one test for each behaviour of the JAX ``tests/test_server.py`` that
the port has, on a small random model.
"""

import io
import json
import os
import re
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ndivplanning_tpu.planning.server import handle_batch as jax_handle_batch
from ndivplanning_tpu_torch.planning import server as srv
from ndivplanning_tpu_torch.planning.server import (
    BUCKETS,
    _ResponseWriter,
    handle_batch,
    handle_request,
    serve,
    warmup,
)
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.utils.config import get_config

# Against JAX on planning512: scores and trajectories within 1e-4
# (float32 G and rollouts in two packages), picks and latches equal.
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
N_PARITY = 64  # candidates per scene in the JAX comparison


def _cfg():
    return get_config("planning", batch_size=4, k=4, g_hidden=(32,),
                      d_hidden=(32,), cond_embed_dim=8, image_size=16,
                      n_candidates=32)


def _state(cfg, seed=0):
    return create_train_state(cfg, seed=seed, device="cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _lines(stdout):
    return [json.loads(line) for line in stdout.getvalue().splitlines()]


def _serve(cfg, state, text, **kw):
    stdout = io.StringIO()
    served = serve(cfg, state, stdin=io.StringIO(text), stdout=stdout, **kw)
    return served, _lines(stdout)


def _req(x=0.1, y=0.1):
    return {"start": [x, y], "goal": [0.9, 0.9]}


def jax_latents(key, n, zdim):
    """The latent source that reproduces JAX handle_batch's draws."""
    _, chain, _ = jax.random.split(key, 3)
    chain = [chain]

    def latents(bucket):
        chain[0], sub = jax.random.split(chain[0])
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.normal(k, (1, n, zdim)))[0]
            for k in jax.random.split(sub, bucket)]))
    return latents


PARITY_REQUESTS = {
    1: [{"start": [0.1, 0.1], "goal": [0.9, 0.9],
         "obstacles": [[0.5, 0.5, 0.12], [0.3, 0.7, 0.08]]}],
    4: [{"start": [0.1, 0.1], "goal": [0.9, 0.9],
         "obstacles": [[0.5, 0.5, 0.12]]},
        {"start": [0.1], "goal": [0.9, 0.9]},  # malformed: isolated error
        {"start": [0.2, 0.05], "goal": [0.85, 0.9]},
        {"start": [0.05, 0.3], "goal": [0.9, 0.6],
         "obstacles": [[0.4, 0.5, 0.1], [0.7, 0.3, 0.1], [0.6, 0.7, 0.06]]}],
}


@pytest.mark.parametrize("bucket", sorted(PARITY_REQUESTS))
def test_handle_batch_matches_jax_on_planning512(bucket):
    from test_torch_checkpoint import jax_planning512, torch_planning512

    jcfg, jstate = jax_planning512()
    jcfg = jcfg.replace(n_candidates=N_PARITY)
    cfg, state = torch_planning512(n_candidates=N_PARITY)
    requests = PARITY_REQUESTS[bucket]
    key = jax.random.PRNGKey(7)
    want = jax_handle_batch(jcfg, jstate, requests, key)
    got = handle_batch(cfg, state, requests, _gen(),
                       latents=jax_latents(key, N_PARITY, cfg.latent_dim))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        if "error" in w:
            assert g["error"].split(":")[0] == w["error"].split(":")[0]
            continue
        assert g["batch_size"] == w["batch_size"] == bucket
        assert g["best_reached"] == w["best_reached"]
        np.testing.assert_allclose(g["best_score"], w["best_score"],
                                   **SCORE_TOL)
        for field in ("best_traj", "diverse_trajs"):
            np.testing.assert_allclose(np.asarray(g[field]),
                                       np.asarray(w[field]), **SCORE_TOL)
    assert sum("best_reached" in g and g["best_reached"] == 1.0
               for g in got) >= 1


def test_handle_request():
    cfg = _cfg()
    resp = handle_request(cfg, _state(cfg), {
        "start": [0.1, 0.1], "goal": [0.9, 0.9],
        "obstacles": [[0.5, 0.5, 0.1]]}, _gen())
    assert len(resp["best_traj"]) == cfg.horizon
    assert len(resp["diverse_trajs"]) == 4
    assert np.asarray(resp["diverse_trajs"]).shape == (4, cfg.horizon, 2)
    assert resp["batch_size"] == 1 and "latency_ms" in resp


def test_serve_loop_and_error_isolation():
    cfg = _cfg()
    served, lines = _serve(cfg, _state(cfg), json.dumps(_req()) + "\n"
                           + "not json\n" + json.dumps(_req(0.2, 0.2))
                           + "\nquit\n")
    assert served == 3
    assert "best_score" in lines[0]
    assert "error" in lines[1]
    assert "best_score" in lines[2]


def test_list_request_single_dispatch(monkeypatch):
    """A JSON-array line is planned in one dispatch and answered with an
    array."""
    cfg = _cfg()
    buckets = []
    real = srv._serve_plan_program
    monkeypatch.setattr(srv, "_serve_plan_program", lambda c, st, sc, *a:
                        buckets.append(sc.start.shape[0]) or real(c, st, sc,
                                                                  *a))
    reqs = [{"start": [0.1 * i, 0.1], "goal": [0.9, 0.9 - 0.05 * i]}
            for i in range(3)]
    served, lines = _serve(cfg, _state(cfg), json.dumps(reqs) + "\nquit\n")
    assert served == 1 and buckets == [4]
    assert isinstance(lines[0], list) and len(lines[0]) == 3
    for r in lines[0]:
        assert len(r["best_traj"]) == cfg.horizon
        assert r["batch_size"] == 4  # 3 requests pad to the 4-bucket


def test_burst_coalesces_16_scenes():
    cfg = _cfg()
    lines = [json.dumps(_req(0.05 + 0.05 * i)) for i in range(16)]
    served, outs = _serve(cfg, _state(cfg), "\n".join(lines) + "\nquit\n")
    assert served == 16 and len(outs) == 16
    assert all(o["batch_size"] == 16 for o in outs)
    # Distinct starts give distinct plans, not one broadcast answer.
    assert len({tuple(o["best_traj"][0]) for o in outs}) > 1


def test_batch_error_isolation():
    cfg = _cfg()
    out = handle_batch(cfg, _state(cfg), [_req(), {"goal": [0.9, 0.9]},
                                          _req(0.2, 0.2)], _gen())
    assert "best_score" in out[0]
    assert out[1] == {"error": "KeyError: 'start'"}
    assert "best_score" in out[2]


def test_empty_array_request():
    cfg = _cfg()
    served, lines = _serve(cfg, _state(cfg),
                           "[]\n" + json.dumps(_req()) + "\nquit\n")
    assert served == 2
    assert lines[0] == []
    assert "best_score" in lines[1]


def test_burst_coalesces_through_real_pipe():
    """A burst written to a real pipe in one write coalesces: the raw-fd
    reader sees lines a TextIOWrapper would hide in its buffer."""
    cfg = _cfg()
    r_fd, w_fd = os.pipe()
    lines = [json.dumps(_req(0.05 + 0.05 * i)) for i in range(4)]
    os.write(w_fd, ("\n".join(lines) + "\nquit\n").encode())
    os.close(w_fd)
    with os.fdopen(r_fd, "r") as stdin:
        stdout = io.StringIO()
        served = serve(cfg, _state(cfg), stdin=stdin, stdout=stdout)
    assert served == 4
    assert [o["batch_size"] for o in _lines(stdout)] == [4] * 4


def test_serve_survives_adversarial_lines():
    cfg = _cfg()
    bad_lines = [
        "{}",
        json.dumps({"start": [0.1], "goal": [0.9, 0.9]}),
        json.dumps({"start": "x", "goal": [0.9, 0.9]}),
        json.dumps({"start": [0.1, 0.1], "goal": [0.9, 0.9],
                    "obstacles": [[0.5]]}),
        json.dumps({"start": [0.1, 0.1], "goal": [0.9, 0.9],
                    "obstacles": [[0.5, 0.5, 0.1]] * 9}),
        json.dumps([1, 2, 3]),
        "null",
        "[",
        "\x00\xff garbage",
    ]
    served, lines = _serve(cfg, _state(cfg), "\n".join(
        bad_lines + [json.dumps(_req()), "quit"]) + "\n")
    assert served == len(lines) == len(bad_lines) + 1
    for reply in lines[:-1]:
        if isinstance(reply, list):
            assert all("error" in r for r in reply)
        else:
            assert "error" in reply
    assert "best_score" in lines[-1]


def test_warmup_dispatches_every_bucket(monkeypatch):
    """The port's counterpart of JAX's warmup_precompiles_all_buckets:
    there is no compile, so warmup runs one dispatch of every bucket size
    (each shape's handles, kernels and allocator blocks), with latents of
    its own: the served answers are those of a server that never warmed
    up."""
    cfg = _cfg()
    state = _state(cfg)
    text = (json.dumps(_req(0.3, 0.2)) + "\n"
            + json.dumps([_req(0.1 * i, 0.1) for i in range(5)]) + "\nquit\n")
    _, cold = _serve(cfg, state, text)
    buckets = []
    real = srv._serve_plan_program
    monkeypatch.setattr(srv, "_serve_plan_program", lambda c, st, sc, *a:
                        buckets.append(sc.start.shape[0]) or real(c, st, sc,
                                                                  *a))
    assert warmup(cfg, state) > 0
    assert buckets == list(BUCKETS)
    served, warm = _serve(cfg, state, text)
    # The burst's two lines share one dispatch: 6 requests, bucket 8.
    assert served == 2 and buckets[len(BUCKETS):] == [8]
    strip = lambda r: {k: v for k, v in r.items() if k != "latency_ms"}
    assert strip(warm[0]) == strip(cold[0])
    assert [strip(r) for r in warm[1]] == [strip(r) for r in cold[1]]


def test_per_request_latency_shows_queue_time():
    """A request planned in the second chunk of a burst larger than the
    largest bucket shows the first chunk's dispatch in its latency."""
    cfg = _cfg()
    state = _state(cfg)
    reqs = [_req() for _ in range(BUCKETS[-1] + 4)]  # chunks of 16 and 4
    handle_batch(cfg, state, reqs, _gen())
    resps = handle_batch(cfg, state, reqs, _gen(1))
    first = [r["latency_ms"] for r in resps[:BUCKETS[-1]]]
    second = [r["latency_ms"] for r in resps[BUCKETS[-1]:]]
    assert min(second) >= max(first) > 0
    assert {r["batch_size"] for r in resps} == {16, 4}


def test_serve_overlap_matches_synchronous():
    cfg = _cfg()
    state = _state(cfg)
    text = (json.dumps(_req()) + "\nnot json\n"
            + json.dumps([_req(0.2, 0.2), _req(0.3, 0.2)]) + "\nquit\n")

    def strip(obj):
        if isinstance(obj, list):
            return [strip(o) for o in obj]
        return {k: v for k, v in obj.items() if k != "latency_ms"}

    outs = []
    for overlap in (False, True):
        served, lines = _serve(cfg, state, text, overlap=overlap)
        assert served == len(lines) == 3
        outs.append(strip(lines))
    assert outs[0] == outs[1]


def test_response_writer_error_falls_back_synchronous():
    class FlakyOut:
        def __init__(self):
            self.fail = True
            self.lines = []

        def write(self, s):
            if self.fail:
                raise BrokenPipeError("client went away")
            self.lines.append(s)

        def flush(self):
            pass

    out = FlakyOut()
    w = _ResponseWriter(out, overlap=True)
    w.push({"a": 1})  # the writer thread dies on it
    deadline = time.time() + 5
    surfaced = False
    while time.time() < deadline:
        try:
            w.push({"a": 2})
        except BrokenPipeError:
            surfaced = True
            break
        time.sleep(0.01)
    assert surfaced, "the writer thread's error never surfaced"
    out.fail = False
    w.push({"a": 3})
    w.push({"a": 4})
    w.close()
    assert [json.loads(line) for line in out.lines] == [{"a": 3}, {"a": 4}]


def test_writer_close_does_not_hang_on_dead_thread_full_queue():
    class DeadPipe(io.StringIO):
        def write(self, s):
            raise OSError("client gone")

    w = _ResponseWriter(DeadPipe(), overlap=True)
    w._q.put({"a": 1})
    for _ in range(500):
        if not w._thread.is_alive():
            break
        time.sleep(0.01)
    assert not w._thread.is_alive()
    for i in range(4):  # fill the queue with nobody draining it
        w._q.put({"i": i}, timeout=1)
    t = threading.Thread(target=lambda: pytest.raises(OSError, w.close))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "close() hung on a dead writer thread"


def test_stats_protocol_line():
    """``stats`` answers the counters in protocol order: after a request
    of the same burst, it sees that request's dispatch."""
    cfg = _cfg()
    state = _state(cfg)
    before = srv.serving_stats()
    served, lines = _serve(cfg, state, json.dumps(_req()) + "\nstats\nquit\n")
    assert served == 2
    assert "best_score" in lines[0]
    first = lines[1]
    assert first["dispatches"] == before["dispatches"] + 1
    assert first["requests"] == before["requests"] + 1
    _, (_, second) = _serve(cfg, state, json.dumps([_req()] * 3)
                            + "\nstats\nquit\n")
    assert second["dispatches"] == first["dispatches"] + 1
    assert second["requests"] == first["requests"] + 3
    assert 0.0 < second["pad_fraction"] <= 1.0  # 3 requests in bucket 4
    assert second["mean_dispatch_batch"] >= 1.0
    assert set(second) == {"dispatches", "requests", "mpc_requests",
                           "auto_reloads", "shed_requests",
                           "expired_requests", "mean_dispatch_batch",
                           "pad_fraction", "since_first_dispatch_s"}


def test_reload_hot_swaps_weights():
    """``reload`` swaps the served weights mid-session: the request before
    it plans on the old weights, the one after on the new, drawing the next
    latents of the session's one stream; without a source it errs."""
    cfg = _cfg()
    state_a, state_b = _state(cfg, 0), _state(cfg, 1)
    state_b.step = 123
    req = json.dumps(_req())
    _, (base,) = _serve(cfg, state_a, req + "\nquit\n")
    _, (other,) = _serve(cfg, state_b, req + "\nquit\n")
    assert base["best_traj"] != other["best_traj"]
    served, lines = _serve(cfg, state_a, req + "\nreload\n" + req
                           + "\nquit\n", reload_fn=lambda: state_b)
    assert served == 3
    assert lines[0]["best_traj"] == base["best_traj"]
    assert lines[1] == {"reloaded": True, "step": 123}
    gen = _gen(0)
    handle_batch(cfg, state_a, [_req()], gen)  # the first segment's draw
    want = handle_batch(cfg, state_b, [_req()], gen)[0]
    assert lines[2]["best_traj"] == want["best_traj"]
    _, lines = _serve(cfg, state_a, "reload\n" + req + "\nquit\n")
    assert "error" in lines[0] and "best_traj" in lines[1]
    _, lines = _serve(cfg, state_a, "reload\n" + req + "\nquit\n",
                      reload_fn=lambda: None)
    assert "error" in lines[0] and "best_traj" in lines[1]


def test_two_servers_with_one_seed_answer_alike():
    cfg = _cfg()
    state = _state(cfg)
    text = (json.dumps(_req()) + "\n" + json.dumps([_req(0.2, 0.1)] * 3)
            + "\nquit\n")
    strip = lambda r: {k: v for k, v in r.items() if k != "latency_ms"}
    _, a = _serve(cfg, state, text, seed=3)
    _, b = _serve(cfg, state, text, seed=3)
    _, c = _serve(cfg, state, text, seed=4)
    assert strip(a[0]) == strip(b[0]) != strip(c[0])
    assert [strip(r) for r in a[1]] == [strip(r) for r in b[1]]


def test_unported_paths_raise_with_their_name():
    cfg = _cfg()
    state = _state(cfg)
    for refine in ("grad", "trajopt", "ilqr", "cem+trajopt"):
        with pytest.raises(NotImplementedError,
                           match=re.escape(f"refine={refine!r}")):
            handle_batch(cfg, state, [_req()], _gen(), refine=refine)
        with pytest.raises(NotImplementedError, match=re.escape(refine)):
            serve(cfg, state, stdin=io.StringIO("quit\n"),
                  stdout=io.StringIO(), refine=refine)
    with pytest.raises(NotImplementedError, match="serve_tcp"):
        srv.serve_tcp(cfg, state)
    with pytest.raises(NotImplementedError, match="--cross-batch"):
        srv._CrossBatcher(cfg, state)
    with pytest.raises(NotImplementedError, match="--watch-best"):
        srv.BestWatcher(lambda: None, "best_path.json")


# Closed-loop serving in the parity tests at a smaller episode (both
# servers read these module constants at dispatch time).
SMALL_MPC = {"MPC_TOTAL_STEPS": 32, "MPC_REPLAN_EVERY": 8,
             "MPC_CANDIDATES": 16}


def _small_mpc(monkeypatch, *modules):
    for module in modules:
        for name, value in SMALL_MPC.items():
            monkeypatch.setattr(module, name, value)


def jax_mpc_latents(key, n_cycles, n, zdim):
    """The latent source that reproduces JAX handle_batch's closed-loop
    draws: ``split(key, 3)`` gives the MPC key, each dispatch chunk splits
    it once more and then into one episode key per bucket slot."""
    from test_torch_mpc import jax_cycle_latents

    _, _, chain = jax.random.split(key, 3)
    chain = [chain]

    def latents(bucket):
        chain[0], sub = jax.random.split(chain[0])
        return torch.from_numpy(np.stack([
            jax_cycle_latents(k, n_cycles, n, zdim)
            for k in jax.random.split(sub, bucket)]))
    return latents


def jax_cem_latents(key, iters, n, zdim):
    """The noise source that reproduces JAX handle_batch's CEM draws (the
    plan key's chunks and slots, then each slot's iterations)."""
    from test_torch_cem import jax_cem_noise

    _, chain, _ = jax.random.split(key, 3)
    chain = [chain]

    def latents(bucket):
        chain[0], sub = jax.random.split(chain[0])
        return torch.from_numpy(np.stack([
            jax_cem_noise(k, iters, n, zdim)
            for k in jax.random.split(sub, bucket)]))
    return latents


MIXED_REQUESTS = [
    {"start": [0.1, 0.1], "goal": [0.9, 0.9],
     "obstacles": [[0.5, 0.5, 0.12]], "mpc": True},
    {"start": [0.2, 0.05], "goal": [0.85, 0.9]},
    {"start": [0.1], "goal": [0.9, 0.9], "mpc": True},  # malformed
    {"start": [0.05, 0.3], "goal": [0.9, 0.6], "mpc": True,
     "obstacles": [[0.4, 0.5, 0.1], [0.7, 0.3, 0.1]]},
]


def test_mpc_requests_match_jax_on_planning512(monkeypatch):
    """A mixed array of closed-loop and plain requests on planning512 with
    JAX's latents (32-step episodes, a replan every 8 from 16
    candidates): the same response keys, paths within SCORE_TOL, the
    flags and replans equal; the plain request as one-shot parity has it;
    the malformed one its own error."""
    import ndivplanning_tpu.planning.server as jax_srv
    from test_torch_checkpoint import jax_planning512, torch_planning512

    _small_mpc(monkeypatch, srv, jax_srv)
    jcfg, jstate = jax_planning512()
    jcfg = jcfg.replace(n_candidates=N_PARITY)
    cfg, state = torch_planning512(n_candidates=N_PARITY)
    key = jax.random.PRNGKey(8)
    want = jax_handle_batch(jcfg, jstate, MIXED_REQUESTS, key)
    got = handle_batch(cfg, state, MIXED_REQUESTS, _gen(),
                       latents=jax_latents(key, N_PARITY, cfg.latent_dim),
                       mpc_latents=jax_mpc_latents(key, 4, 16,
                                                   cfg.latent_dim))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        if "error" in w:
            assert g["error"].split(":")[0] == w["error"].split(":")[0]
            continue
        assert g["batch_size"] == w["batch_size"]
        if "path" in w:
            assert len(g["path"]) == 32 and g["n_replans"] == 4
            np.testing.assert_allclose(np.asarray(g["path"]),
                                       np.asarray(w["path"]), **SCORE_TOL)
            for field in ("reached", "collided", "n_replans"):
                assert g[field] == w[field], field
        else:
            np.testing.assert_allclose(g["best_score"], w["best_score"],
                                       **SCORE_TOL)
    assert [g["batch_size"] for g in got if "path" in g] == [2, 2]
    assert any(g.get("reached") == 1.0 for g in got)


def test_cem_refine_matches_jax_on_planning512():
    """``refine="cem"`` on planning512 with JAX's noise: best plans within
    SCORE_TOL, the reach flags equal (the diverse picks of a refined
    population are near-ties: tests/test_torch_cem.py)."""
    from ndivplanning_tpu_torch.planning.cem import cem_population
    from test_torch_checkpoint import jax_planning512, torch_planning512

    jcfg, jstate = jax_planning512()
    jcfg = jcfg.replace(n_candidates=N_PARITY)
    cfg, state = torch_planning512(n_candidates=N_PARITY)
    requests = PARITY_REQUESTS[4]
    key = jax.random.PRNGKey(11)
    want = jax_handle_batch(jcfg, jstate, requests, key, refine="cem")
    n, _, iters = cem_population(cfg)
    got = handle_batch(cfg, state, requests, _gen(), refine="cem",
                       latents=jax_cem_latents(key, iters, n,
                                               cfg.latent_dim))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        if "error" in w:
            continue
        assert g["best_reached"] == w["best_reached"]
        np.testing.assert_allclose(g["best_score"], w["best_score"],
                                   **SCORE_TOL)
        np.testing.assert_allclose(np.asarray(g["best_traj"]),
                                   np.asarray(w["best_traj"]), **SCORE_TOL)


def test_mpc_requests_are_counted_and_dispatched_after_plain_ones(
        monkeypatch):
    """Closed-loop requests split from plain ones at parse time: the plain
    ones dispatch first, the episodes after in their own buckets, and
    ``mpc_requests`` counts them."""
    cfg = _cfg()
    state = _state(cfg)
    _small_mpc(monkeypatch, srv)
    order = []
    for name in ("_serve_plan_program", "_serve_mpc_program"):
        real = getattr(srv, name)
        monkeypatch.setattr(srv, name, lambda c, st, sc, *a, _r=real,
                            _n=name: order.append((_n, sc.start.shape[0]))
                            or _r(c, st, sc, *a))
    before = srv.serving_stats()
    reqs = [dict(_req(0.1 * i, 0.1), mpc=True) for i in range(1, 4)]
    reqs.insert(1, _req())
    out = handle_batch(cfg, state, reqs, _gen())
    assert order == [("_serve_plan_program", 1), ("_serve_mpc_program", 4)]
    assert [set(r) for r in out] == [
        {"path", "reached", "collided", "n_replans", "latency_ms",
         "batch_size"}] * 1 + [{"best_traj", "best_score", "best_reached",
                                "diverse_trajs", "latency_ms",
                                "batch_size"}] + [
        {"path", "reached", "collided", "n_replans", "latency_ms",
         "batch_size"}] * 2
    assert np.asarray(out[0]["path"]).shape == (32, 2)
    after = srv.serving_stats()
    assert after["mpc_requests"] == before["mpc_requests"] + 3
    assert after["requests"] == before["requests"] + 4
    assert after["dispatches"] == before["dispatches"] + 2


def test_serve_answers_mpc_lines_and_warms_up_mpc_buckets(monkeypatch):
    """``warmup(mpc=True)`` adds a closed-loop dispatch of every bucket;
    ``serve`` answers ``"mpc": true`` lines and arrays in protocol order,
    and a server refining with CEM answers plain lines."""
    cfg = _cfg()
    state = _state(cfg)
    _small_mpc(monkeypatch, srv)
    buckets = []
    real = srv._serve_mpc_program
    monkeypatch.setattr(srv, "_serve_mpc_program", lambda c, st, sc, *a:
                        buckets.append(sc.start.shape[0]) or real(c, st, sc,
                                                                  *a))
    assert warmup(cfg, state, mpc=True) > 0
    assert buckets == list(BUCKETS)
    served, lines = _serve(cfg, state, json.dumps(dict(_req(), mpc=True))
                           + "\n" + json.dumps([_req(0.2, 0.1),
                                                dict(_req(0.3), mpc=True)])
                           + "\nstats\nquit\n")
    assert served == 3
    assert "path" in lines[0] and "best_score" in lines[1][0]
    assert "path" in lines[1][1] and lines[2]["mpc_requests"] >= 2
    served, lines = _serve(cfg, state, json.dumps(_req()) + "\nquit\n",
                           refine="cem")
    assert served == 1 and len(lines[0]["best_traj"]) == cfg.horizon
