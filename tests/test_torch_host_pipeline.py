"""The port's recorded-dataset path on the CPU: ``data/host_pipeline.py`` and
``train/loop.py::train_from_dataset``.

The ported behaviours of ``tests/test_host_pipeline.py`` (but the TPU
mesh's), then parity with the JAX package on the same numpy inputs: the
batch order, the split, the marker's fingerprint, the scenes and the npz
schema bitwise or equal, and 4 steps of JAX's ``train_from_dataset``
against the port's dataset runner fed JAX's latents, at
``tests/test_torch_train_step.py``'s tolerance.  Then what the port adds:
a resumed dataset run and the device-resident path bitwise the
uninterrupted streaming run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data import host_pipeline as jax_hp
from ndivplanning_tpu.train import loop as jax_loop
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.data.host_pipeline import (
    RECORD_KEYS,
    ArrayDataset,
    batch_from_arrays,
    epochs,
    prefetch_to_device,
    record_dataset,
    scenes_from_arrays,
    train_eval_split,
)
from ndivplanning_tpu_torch.data.tasks import make_task
from ndivplanning_tpu_torch.train import loop
from ndivplanning_tpu_torch.train.loop import train, train_from_dataset
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.train.step import train_step_impl
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.convert import train_state_from_flax
from tests.test_torch_loop import assert_states_bitwise_equal
from tests.test_torch_train_step import (
    _assert_metrics_close,
    _assert_state_close,
    _jax_tree,
)

SMALL = dict(batch_size=8, k=4, g_hidden=(32,), d_hidden=(32,),
             cond_embed_dim=8)


def _dataset(n=32):
    rng = np.random.default_rng(0)
    return ArrayDataset({
        "conditions": rng.normal(size=(n, 4)).astype(np.float32),
        "real_traj": rng.normal(size=(n, 32, 2)).astype(np.float32),
    })


def _sampled(cfg, n, seed=0):
    """``n`` rows of the port's task sampler as a dataset: without scenes
    for goalcond (rebuilt from the conditions), with them otherwise."""
    b = make_task(cfg).sample(torch.Generator().manual_seed(seed), n)
    arrays = {"conditions": b.conditions.numpy(),
              "real_traj": b.real_traj.numpy()}
    if cfg.conditioning != "startgoal":
        arrays.update({f"scene_{k}": getattr(b.scenes, k).numpy() for k in
                       ("start", "goal", "obstacles", "obstacle_mask")})
    return ArrayDataset(arrays)


def _rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _pointmass(**kw):
    return get_config("pointmass2d", **{**SMALL, **kw})


# --------------------------------------------- tests/test_host_pipeline.py


def test_epoch_covers_all_examples_once():
    ds = _dataset(32)
    seen = [b["conditions"] for b in ds.batches(8, seed=1)]
    assert all(c.shape == (8, 4) for c in seen)
    np.testing.assert_array_equal(
        np.sort(np.concatenate(seen)[:, 0]),
        np.sort(ds.arrays["conditions"][:, 0]))


def test_shuffle_deterministic_in_seed():
    ds = _dataset()

    def run(seed):
        return np.concatenate([b["conditions"]
                               for b in ds.batches(8, seed=seed)])

    np.testing.assert_array_equal(run(5), run(5))
    assert not np.array_equal(run(5), run(6))


def test_drop_remainder():
    ds = _dataset(30)
    assert len(list(ds.batches(8))) == 3
    assert sum(b["conditions"].shape[0]
               for b in ds.batches(8, drop_remainder=False)) == 30


def test_prefetch_to_device_yields_tensors():
    ds = _dataset(16)
    out = list(prefetch_to_device(ds.batches(8), device="cpu"))
    assert len(out) == 2
    assert isinstance(out[0]["real_traj"], torch.Tensor)
    np.testing.assert_array_equal(
        np.sort(torch.cat([b["conditions"] for b in out]).numpy()[:, 0]),
        np.sort(ds.arrays["conditions"][:, 0]))


def test_prefetch_stages_batches_and_scenes():
    cfg = get_config("goalcond", **SMALL)
    ds = _sampled(cfg, 16)
    host = [batch_from_arrays(b, "startgoal") for b in ds.batches(8)]
    got = list(prefetch_to_device(iter(host), buffer_size=1, device="cpu"))
    for a, b in zip(host, got):
        assert torch.equal(a.real_traj, b.real_traj)
        assert torch.equal(a.scenes.goal, b.scenes.goal)


def test_prefetch_propagates_producer_errors():
    def broken():
        yield {"a": np.zeros((2, 2), np.float32)}
        raise RuntimeError("corrupt record")

    stream = prefetch_to_device(broken(), device="cpu")
    next(stream)
    with pytest.raises(RuntimeError, match="corrupt record"):
        next(stream)


def test_prefetch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(prefetch_to_device(iter([np.zeros(2)])))


def test_multi_epoch_stream():
    assert len(list(epochs(_dataset(16), batch_size=8, num_epochs=3,
                           device="cpu"))) == 6


def test_npz_roundtrip(tmp_path):
    ds = _dataset(8)
    path = tmp_path / "data.npz"
    np.savez(path, **ds.arrays)
    loaded = ArrayDataset.from_npz(str(path))
    np.testing.assert_array_equal(loaded.arrays["real_traj"],
                                  ds.arrays["real_traj"])


def test_validation():
    with pytest.raises(ValueError):
        ArrayDataset({})
    with pytest.raises(ValueError):
        ArrayDataset({"a": np.zeros((3, 2)), "b": np.zeros((4, 2))})
    with pytest.raises(ValueError, match="eval_fraction"):
        train_eval_split(_dataset(8), 1.0)


def test_train_from_dataset():
    cfg = get_config("goalcond", **SMALL)
    state, metrics = train_from_dataset(cfg, _sampled(cfg, 32), num_epochs=2,
                                        device="cpu")
    assert state.step == 2 * (32 // 8)
    assert metrics and all(np.isfinite(v) for v in metrics.values())


def test_train_from_dataset_refuses_a_small_dataset():
    cfg = get_config("goalcond", **SMALL)
    with pytest.raises(ValueError, match="smaller than one batch"):
        train_from_dataset(cfg, _sampled(cfg, 4), 1, device="cpu")


def test_record_dataset_roundtrip(tmp_path):
    cfg = get_config("goalcond", **SMALL)
    path = str(tmp_path / "recorded.npz")
    stats = record_dataset(cfg, 40, path, device="cpu")
    assert stats["kept"] + stats["dropped"] == 40
    assert stats["kept"] >= 8  # goalcond scenes are obstacle-free
    state, _ = train_from_dataset(cfg, ArrayDataset.from_npz(path),
                                  num_epochs=1, device="cpu")
    assert state.step == stats["kept"] // 8


def test_record_dataset_filters_colliding_experts(tmp_path):
    cfg = get_config("imagecond", **SMALL, image_size=16,
                     encoder_features=(4,))
    path = str(tmp_path / "img.npz")
    stats = record_dataset(cfg, 64, path, seed=3, device="cpu")
    assert stats["dropped"] > 0 and stats["kept"] > 0
    ds = ArrayDataset.from_npz(path)
    from ndivplanning_tpu_torch.data.native import collision_mask_numpy

    assert not collision_mask_numpy(ds.arrays["real_traj"],
                                    ds.arrays["scene_obstacles"],
                                    ds.arrays["scene_obstacle_mask"]).any()
    everything = record_dataset(cfg, 64, str(tmp_path / "all.npz"), seed=3,
                                device="cpu", filter_collisions=False)
    assert everything == {"kept": 64, "dropped": 0}


def test_dataset_training_first_class(tmp_path):
    """record -> split -> train with the held-out eval against the true
    scenes, metrics and checkpoints -> a resumed run bitwise the
    uninterrupted one."""
    cfg = _pointmass(log_every=4, checkpoint_every=4, eval_every=4)
    path = str(tmp_path / "rec.npz")
    record_dataset(cfg, 80, path, device="cpu")
    ds = ArrayDataset.from_npz(path)
    assert set(ds.arrays) == set(RECORD_KEYS)
    train_ds, eval_ds = train_eval_split(ds, 0.2, seed=0)
    assert train_ds.size + eval_ds.size == ds.size
    steps_per_epoch = train_ds.size // cfg.batch_size

    wd1 = str(tmp_path / "full")
    full, _ = train_from_dataset(cfg, train_ds, 2, workdir=wd1,
                                 eval_dataset=eval_ds, device="cpu")
    assert full.step == 2 * steps_per_epoch
    rows = _rows(wd1)
    ev = [r for r in rows if r.get("kind") == "eval"]
    assert ev and "eval_success_rate" in ev[-1]
    assert "eval_collision_rate" in ev[-1]
    assert [r["step"] for r in ev] == list(range(4, full.step + 1, 4))

    wd2 = str(tmp_path / "resumed")
    first, _ = train_from_dataset(cfg, train_ds, 1, workdir=wd2,
                                  eval_dataset=eval_ds, device="cpu")
    assert first.step == steps_per_epoch
    resumed, _ = train_from_dataset(cfg, train_ds, 2, workdir=wd2,
                                    eval_dataset=eval_ds, device="cpu")
    assert_states_bitwise_equal(full, resumed)
    clocks = ("wall_s", "steps_per_sec")

    def tail(rows):
        return [{k: v for k, v in r.items() if k not in clocks}
                for r in rows if r["step"] > steps_per_epoch]

    assert tail(_rows(wd2)) == tail(rows)


def test_dataset_resume_rejects_foreign_workdir(tmp_path):
    cfg = _pointmass(log_every=4, checkpoint_every=4, eval_every=0)
    wd = str(tmp_path / "sampler_run")
    train(cfg, num_steps=4, workdir=wd, echo=False, device="cpu")
    path = str(tmp_path / "rec.npz")
    record_dataset(cfg, 32, path, device="cpu")
    ds = ArrayDataset.from_npz(path)
    state = create_train_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="dataset-run marker"):
        train_from_dataset(cfg, ds, 1, state=state, workdir=wd)
    assert state.step == 0  # refused before the checkpoint was loaded

    # Another recording of the same shape is refused by its content hash.
    wd2 = str(tmp_path / "dataset_run")
    train_from_dataset(cfg, ds, 1, workdir=wd2, device="cpu")
    record_dataset(cfg, 32, str(tmp_path / "other.npz"), seed=1,
                   device="cpu")
    other = ArrayDataset.from_npz(str(tmp_path / "other.npz"))
    with pytest.raises(ValueError, match="content_blake2b"):
        train_from_dataset(cfg, other, 2, workdir=wd2, device="cpu")


def test_legacy_marker_keys_stay_resumable(tmp_path):
    """A marker written before a field existed is compared on its own keys."""
    cfg = _pointmass(checkpoint_every=4, eval_every=0)
    ds = _sampled(cfg, 32)
    wd = str(tmp_path / "run")
    train_from_dataset(cfg, ds, 1, workdir=wd, device="cpu")
    marker = loop._dataset_marker_path(wd)
    with open(marker, encoding="utf-8") as f:
        old = json.load(f)
    del old["content_blake2b"]
    with open(marker, "w", encoding="utf-8") as f:
        json.dump(old, f)
    state, _ = train_from_dataset(cfg, ds, 2, workdir=wd, device="cpu")
    assert state.step == 8


def test_imagecond_record_train_eval_e2e(tmp_path):
    cfg = get_config("imagecond", batch_size=8, k=4, g_hidden=(16,),
                     d_hidden=(16,), cond_embed_dim=8, image_size=16,
                     encoder_features=(4,), log_every=4, eval_every=8,
                     checkpoint_every=0, workdir="")
    path = str(tmp_path / "img.npz")
    stats = record_dataset(cfg, 256, path, seed=3, device="cpu")
    assert stats["kept"] >= 32
    ds = ArrayDataset.from_npz(path)
    assert ds.arrays["conditions"].shape[1:] == (16, 16, 3)
    train_ds, eval_ds = train_eval_split(ds, 0.25, seed=1)
    state, last = train_from_dataset(cfg, train_ds, 2,
                                     workdir=str(tmp_path / "run"),
                                     eval_dataset=eval_ds, device="cpu")
    assert state.step == 2 * (train_ds.size // cfg.batch_size)
    assert np.isfinite(last["g_total"])
    assert any("eval_success_rate" in r for r in _rows(tmp_path / "run"))


def test_dataset_metrics_read_only_at_boundaries(tmp_path, monkeypatch):
    """The device's metrics are read once per log, checkpoint or eval
    boundary and at the run's end, never between them; how often they are
    read does not change the run."""
    path = str(tmp_path / "rec.npz")
    record_dataset(_pointmass(), 48, path, device="cpu")
    ds = ArrayDataset.from_npz(path)
    reads = []
    real = loop.host_floats

    def counting(values):
        reads.append(1)
        return real(values)

    monkeypatch.setattr(loop, "host_floats", counting)
    states = []
    for log_every, want in ((1000, 1), (3, 4), (5, 3)):
        reads[:] = []
        cfg = _pointmass(log_every=log_every, checkpoint_every=0,
                         eval_every=0)
        state, last = train_from_dataset(cfg, ds, 2, device="cpu")
        assert state.step == 12 and len(reads) == want, log_every
        assert np.isfinite(last["g_total"])
        states.append(state)
    for other in states[1:]:
        assert_states_bitwise_equal(states[0], other)


def test_batch_indices_match_batches():
    ds = _dataset(32)
    for idx, batch in zip(ds.batch_indices(8, seed=7),
                          ds.batches(8, seed=7)):
        np.testing.assert_array_equal(ds.arrays["conditions"][idx],
                                      batch["conditions"])


@pytest.mark.parametrize("preset", ["goalcond", "pointmass2d"])
def test_device_resident_matches_streaming(monkeypatch, preset):
    cfg = get_config(preset, **SMALL, log_every=3)
    ds = _sampled(cfg, 32)
    monkeypatch.setenv("NDIV_DATASET_DEVICE_MB", "0")  # streaming
    s_stream, m_stream = train_from_dataset(cfg, ds, 2, device="cpu")
    monkeypatch.setenv("NDIV_DATASET_DEVICE_MB", "512")  # device-resident
    s_dev, m_dev = train_from_dataset(cfg, ds, 2, device="cpu")
    assert s_stream.step == s_dev.step == 2 * (32 // 8)
    assert_states_bitwise_equal(s_stream, s_dev)
    assert {k: v for k, v in m_stream.items() if k != "steps_per_sec"} == {
        k: v for k, v in m_dev.items() if k != "steps_per_sec"}


def test_residency_counts_the_converted_batch(monkeypatch):
    """The residency gate sums the converted batch's bytes, the rebuilt
    scenes included, not the raw arrays' (4x here): a budget between the
    two streams."""
    import ndivplanning_tpu_torch.data.host_pipeline as hp

    cfg = get_config("goalcond", **{**SMALL, "batch_size": 2048},
                     horizon=4, log_every=4, eval_every=0)
    ds = _sampled(cfg, 16384)
    raw = sum(v.nbytes for v in ds.arrays.values())
    converted = hp.batch_nbytes(batch_from_arrays(ds.arrays, "startgoal"))
    budget_mb = 2
    assert raw < budget_mb << 20 < converted
    streamed = []
    prefetch = hp.prefetch_to_device

    def spy(*args, **kw):
        streamed.append(kw["device"])
        return prefetch(*args, **kw)

    monkeypatch.setattr(hp, "prefetch_to_device", spy)
    monkeypatch.setenv("NDIV_DATASET_DEVICE_MB", str(budget_mb))
    state, _ = train_from_dataset(cfg, ds, 1, device="cpu")
    assert streamed == [torch.device("cpu")] and state.step == 8
    monkeypatch.setenv("NDIV_DATASET_DEVICE_MB", "4")  # fits: resident
    train_from_dataset(cfg, ds, 1, device="cpu")
    assert len(streamed) == 1


# ----------------------------------------------- parity with the JAX package


def test_batch_order_and_split_are_jax_bitwise():
    arrays = _dataset(50).arrays
    port, jx = ArrayDataset(arrays), jax_hp.ArrayDataset(arrays)
    for seed in (0, 3):
        for drop in (True, False):
            for a, b in zip(port.batch_indices(8, seed=seed,
                                               drop_remainder=drop),
                            jx.batch_indices(8, seed=seed,
                                             drop_remainder=drop)):
                np.testing.assert_array_equal(a, b)
    for frac, seed in ((0.1, 0), (0.25, 7)):
        for p, j in zip(train_eval_split(port, frac, seed=seed),
                        jax_hp.train_eval_split(jx, frac, seed=seed)):
            assert p.arrays.keys() == j.arrays.keys()
            for k in p.arrays:
                np.testing.assert_array_equal(p.arrays[k], j.arrays[k])


def test_marker_fingerprint_is_jax_dict():
    arrays = {**_dataset(24).arrays,
              "scene_goal": np.ones((24, 2), np.float32)}
    cfg = get_config("goalcond", **SMALL, seed=5)
    jcfg = jax_get_config("goalcond", **SMALL, seed=5)
    assert loop._dataset_fingerprint(ArrayDataset(arrays), cfg) == \
        jax_loop._dataset_fingerprint(jax_hp.ArrayDataset(arrays), jcfg)


def test_scenes_from_arrays_match_jax(tmp_path):
    cfg = get_config("imagecond", **SMALL, image_size=16,
                     encoder_features=(4,))
    path = str(tmp_path / "rec.npz")
    record_dataset(cfg, 16, path, device="cpu", filter_collisions=False)
    recorded = ArrayDataset.from_npz(path).arrays
    bare = {"conditions": np.random.default_rng(0).uniform(
        size=(6, 4)).astype(np.float32)}
    for arrays, conditioning in ((recorded, "image"), (bare, "startgoal")):
        got = scenes_from_arrays(arrays, conditioning)
        want = jax_hp.scenes_from_arrays(arrays, conditioning)
        for name in ("start", "goal", "obstacles", "obstacle_mask"):
            w = np.asarray(getattr(want, name))
            g = getattr(got, name).numpy()
            assert g.dtype == w.dtype == np.float32, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    for fn in (scenes_from_arrays, jax_hp.scenes_from_arrays):
        with pytest.raises(ValueError, match="re-record"):
            fn(bare, "image")


@pytest.mark.parametrize("preset,kw", [
    ("goalcond", {}),
    ("imagecond", {"image_size": 16, "encoder_features": (4,)}),
    ("pointmass2d", {}),
])
def test_record_dataset_schema_is_jax(tmp_path, preset, kw):
    cfg = get_config(preset, **SMALL, **kw)
    jcfg = jax_get_config(preset, **SMALL, **kw)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    record_dataset(cfg, 24, ours, device="cpu")
    jax_hp.record_dataset(jcfg, 24, theirs)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(RECORD_KEYS)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].shape[1:] == b[k].shape[1:], k


def test_four_dataset_steps_match_jax(tmp_path):
    """JAX's train_from_dataset against the port's dataset runner on the
    same batch order, with JAX's latents: its ``split(state.rng)`` chain
    rebuilt."""
    kw = dict(batch_size=16, k=4, g_hidden=(32,), d_hidden=(32,),
              cond_embed_dim=8)
    cfg, jcfg = get_config("pointmass2d", **kw), jax_get_config(
        "pointmass2d", **kw)
    path = str(tmp_path / "rec.npz")
    record_dataset(cfg, 64, path, device="cpu")
    arrays = ArrayDataset.from_npz(path).arrays
    jstate = jax_create(jcfg)
    state = train_state_from_flax(cfg, _jax_tree(jstate), device="cpu")
    rng, zs = jstate.rng, []
    for _ in range(4):
        rng, k_z = jax.random.split(rng)
        zs.append(np.asarray(jax.random.normal(
            k_z, (cfg.batch_size, cfg.k, cfg.latent_dim), jnp.float32)))
    jstate, jlast = jax_loop.train_from_dataset(
        jcfg, jax_hp.ArrayDataset(arrays), num_epochs=1, state=jstate)
    assert int(jstate.step) == 4

    ds = ArrayDataset(arrays)
    batches = [batch_from_arrays({k: v[idx] for k, v in arrays.items()},
                                 cfg.conditioning)
               for idx in ds.batch_indices(cfg.batch_size, seed=cfg.seed)]
    for batch, z in zip(batches, zs):
        state, metrics = train_step_impl(cfg, state, batch,
                                         z=torch.tensor(z))
    _assert_metrics_close({k: float(v) for k, v in metrics.items()},
                          jlast, ("d_loss", "g_adv", "g_ndiv"))
    _assert_state_close(jstate, state, 4)
