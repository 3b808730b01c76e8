"""The port's checkpoint manager (``repro_torch.checkpointing``) and
fault-tolerance loop (``repro_torch.runtime.fault_tolerance``) against the
reference's on the CPU: the same manifest for the counterpart tree, a
reference-written checkpoint restored into the port bit for bit, bfloat16
round trips, and the reference's own checks (``tests/test_checkpoint.py``)
ported."""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import CheckpointManager as RCheckpointManager
from repro.optim.adamw import adamw_init as r_adamw_init
from repro_torch import tree as T
from repro_torch.checkpointing import CheckpointManager
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.fault_tolerance import (FailureInjector, ResilientLoop,
                                                 SimulatedFailure)


def _np_params():
    rng = np.random.default_rng(0)
    return {"embed": rng.normal(size=(3, 2)).astype(np.float32),
            "segments": ({"wq": rng.normal(size=(2, 2)).astype(np.float32)},
                         {"wq": rng.normal(size=(2, 2)).astype(np.float32)}),
            "final_norm": rng.normal(size=(2,)).astype(np.float32)}


def _pair(bf16_keys=("embed",)):
    """The counterpart (params, AdamW state) trees of both packages, the
    leaves named in ``bf16_keys`` in bfloat16 (the same values)."""
    tree = _np_params()
    rp = {k: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16 if k in bf16_keys else jnp.float32), v)
        for k, v in tree.items()}
    p = {k: T.tree_map(lambda a: torch.from_numpy(a).to(
        torch.bfloat16 if k in bf16_keys else torch.float32), v)
        for k, v in tree.items()}
    return (rp, r_adamw_init(rp)), (p, adamw_init(p))


def _zeros_like(tree):
    return T.tree_map(torch.zeros_like, tree)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy())
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


def test_manifest_equals_reference(tmp_path):
    (rtree, tree) = _pair()
    RCheckpointManager(str(tmp_path / "ref")).save(5, rtree, async_=False)
    CheckpointManager(str(tmp_path / "port")).save(5, tree, async_=False)
    want, got = _manifest(tmp_path / "ref", 5), _manifest(tmp_path / "port", 5)
    assert got == want
    keys = list(got["leaves"])
    assert {"0/embed", "0/segments/0/wq", "1/.step", "1/.mu/embed"} <= set(keys)
    assert got["leaves"]["0/embed"]["dtype"] == "bfloat16"


def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    """f32 and bf16 leaves written by the reference (bf16 as the 2-byte
    void array it saves) restore into the port's trees unchanged."""
    (rtree, tree) = _pair(bf16_keys=("embed", "final_norm"))
    RCheckpointManager(str(tmp_path)).save(7, rtree, async_=False)
    got, step = CheckpointManager(str(tmp_path)).restore(_zeros_like(tree))
    assert step == 7
    want = dict(T.leaves_with_paths(rtree))
    for key, leaf in T.leaves_with_paths(got):
        assert str(leaf.dtype).removeprefix("torch.") == str(want[key].dtype), key
        np.testing.assert_array_equal(_bits(leaf), _bits(want[key]), err_msg=key)


def test_port_bf16_checkpoint_restores(tmp_path):
    (_, tree) = _pair(bf16_keys=("embed", "segments", "final_norm"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree, async_=False)
    got, _ = mgr.restore(_zeros_like(tree))
    for (k, a), (_, b) in zip(T.leaves_with_paths(tree), T.leaves_with_paths(got)):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)


def test_reference_cannot_restore_its_own_bf16(tmp_path):
    """A fault of the reference, pinned (ROADMAP.md section 3): it saves a
    bf16 leaf as a void array and its restore cannot cast that back."""
    (rtree, _) = _pair()
    mgr = RCheckpointManager(str(tmp_path))
    mgr.save(1, rtree, async_=False)
    with pytest.raises(ValueError):
        mgr.restore(rtree)


# ------------------------------------------------------------------ tests/test_checkpoint.py, ported
def _tree(x=0.0):
    return {"a": torch.full((4, 3), x), "nested": {"b": torch.arange(5) + int(x)},
            "t": (torch.ones(2) * x, torch.zeros(1))}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(3.0)
    mgr.save(10, tree, async_=False)
    restored, step = mgr.restore(_tree(0.0))
    assert step == 10
    for a, b in zip(T.leaves(tree), T.leaves(restored)):
        assert torch.equal(a, b)


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(float(s)))
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    restored, step = mgr.restore(_tree())
    assert step == 4
    assert float(restored["a"][0, 0]) == 4.0


def test_save_snapshots_before_returning(tmp_path):
    """The async save copies each leaf before it returns: a later in-place
    change of the tree does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(1.0)
    mgr.save(1, tree)
    tree["a"].fill_(9.0)
    restored, _ = mgr.restore(_tree())
    assert float(restored["a"][0, 0]) == 1.0


def test_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, _tree(1.0), async_=False)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_resilient_loop_restarts(tmp_path):
    """Inject a failure mid-run: the loop restores and the final state is
    identical to a failure-free run (bitwise training restart contract)."""
    def step_fn(state, i):
        return T.tree_map(lambda x: x + 1.0, state)

    def run(fail_at):
        mgr = CheckpointManager(str(tmp_path / f"ck_{fail_at}"))
        loop = ResilientLoop(mgr, save_every=5)
        inj = FailureInjector(fail_at=(fail_at,)) if fail_at else None
        return loop.run(_tree(0.0), step_fn, 20, injector=inj)

    clean, info0 = run(None)
    failed, info1 = run(13)
    assert info0 == {"restarts": 0, "final_step": 20}
    assert info1 == {"restarts": 1, "final_step": 20}
    for a, b in zip(T.leaves(clean), T.leaves(failed)):
        assert torch.equal(a, b)


class _SlowWrites:
    """A manager whose async writes take a while, as a large checkpoint's do."""

    def _write(self, step, host):
        time.sleep(0.3)
        super()._write(step, host)


def _loop_restarts(mgr_cls, loop_cls, inj_cls, tmp_path, fail_at, save_every):
    resumed = []
    state = {"x": torch.zeros(2)} if loop_cls is ResilientLoop \
        else {"x": np.zeros(2, np.float32)}
    loop = loop_cls(mgr_cls(str(tmp_path)), save_every=save_every)
    out, info = loop.run(state, lambda s, i: {"x": s["x"] + 1}, 6,
                         injector=inj_cls(fail_at=(fail_at,)), on_restart=resumed.append)
    return float(out["x"][0]), info, resumed


def test_restart_finds_a_save_in_flight(tmp_path):
    """A failure while the last save is still being written resumes from
    that save; the reference's loop misses it and restarts cold (ROADMAP.md
    section 3)."""
    from repro.runtime import fault_tolerance as rft

    class Port(_SlowWrites, CheckpointManager):
        pass

    class Ref(_SlowWrites, RCheckpointManager):
        pass

    x, info, resumed = _loop_restarts(Port, ResilientLoop, FailureInjector,
                                      tmp_path / "port", fail_at=3, save_every=2)
    assert (x, info["restarts"], resumed) == (6.0, 1, [2])
    x, info, resumed = _loop_restarts(Ref, rft.ResilientLoop, rft.FailureInjector,
                                      tmp_path / "ref", fail_at=3, save_every=2)
    assert resumed == [0] and x == 9.0            # the reference's fault, pinned


def test_cold_restart_starts_from_the_initial_state(tmp_path):
    """A failure before any checkpoint restarts from the initial state; the
    reference's loop keeps the failed run's state and resets only the step
    (ROADMAP.md section 3)."""
    from repro.runtime import fault_tolerance as rft

    x, info, resumed = _loop_restarts(CheckpointManager, ResilientLoop, FailureInjector,
                                      tmp_path / "port", fail_at=3, save_every=10)
    assert (x, info["restarts"], resumed) == (6.0, 1, [0])
    x, _, _ = _loop_restarts(RCheckpointManager, rft.ResilientLoop, rft.FailureInjector,
                             tmp_path / "ref", fail_at=3, save_every=10)
    assert x == 9.0                                # the reference's fault, pinned


def test_injector_fires_once():
    inj = FailureInjector(fail_at=(2,))
    inj.maybe_fail(1)
    with pytest.raises(SimulatedFailure):
        inj.maybe_fail(2)
    inj.maybe_fail(2)


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree())
