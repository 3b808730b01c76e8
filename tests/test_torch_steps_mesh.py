"""The port's sharded steps in gloo worlds on the CPU, against the
reference's unsharded run on the same parameters.

Three worlds, each spawned once for the module from a script file
(``tests/torch_mesh_world.py``: one torch thread a rank, every case run in
one spawn, a timeout on each):

* 2×4 ``(data, model)``, 8 ranks: the four cells of
  ``tests/test_dryrun_small.py`` (granite-3-2b train, llama4-scout train,
  rwkv6-3b decode through the scan kernel's wrapper, zamba2-2.7b prefill
  through the scan and attention wrappers) at smoke size in float32,
  granite's train step again with ``seq_parallel``, and a narrow dense
  config with 16 query heads over 4 key heads (hd 16), so that the query
  heads shard over ``model`` (``q_shard``) and each rank's query heads
  meet their own key head, prefilled through the flash wrapper and
  decoded through the decode-attention and exit-head wrappers;
* 2×2×2 ``(pod, data, model)``: granite-3-2b train, as
  ``test_small_mesh_multipod``;
* 4 ranks: the same narrow config over 2 key heads on a 1×4 mesh (each
  rank's 4 query heads read one of the 2 replicated key heads, cut on the
  rank), and ``decode_step_batch(sharded=True)`` over a 1-D mesh of the
  world against ``sharded=False``.

Stated tolerances (float32 parameters, the reference's bf16 caches):
* train: loss and ``final_ce`` within 1e-5 relative; every parameter
  after the step within 1e-5 absolute; ``seq_parallel`` within 1e-6 of
  the step without it;
* prefill: the last hidden state within 1e-4 absolute;
* serve: the greedy tokens equal, unless the reference's top-2 margin of
  that row is below 1e-4;
* caches: every leaf within one bf16 step of the reference's (2^-7
  relative) plus 1e-5 absolute (the two frameworks round the new k/v and
  state to bf16 from float32 values that differ by up to ~1e-6, which a
  value near zero keeps), and laid out as the cache specs say after the
  step;
* sharded batched decode: hidden states and caches within 1e-5 of the
  unsharded call (a rank's one-row products sum in another order than
  the four-row ones).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShapeConfig as RShapeConfig
from repro.configs import get_smoke_config as ref_get_smoke
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.launch.steps import make_step as ref_make_step
from repro.models import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config

ROOT = Path(__file__).resolve().parents[1]
WORLD_SCRIPT = ROOT / "tests" / "torch_mesh_world.py"
WORLD_TIMEOUT = 600
SEQ, BATCH = 64, 8
TRAIN_KW = dict(peak_lr=1e-2, warmup=1, total_steps=10)
LOSS_RTOL = PARAM_TOL = 1e-5
HIDDEN_TOL = 1e-4
MARGIN_TOL = 1e-4
SEQ_PARALLEL_TOL = 1e-6
CACHE_RTOL = 2.0 ** -7
CACHE_ATOL = 1e-5
BATCH_TOL = 1e-5


def _configs(arch, kv=4):
    """(reference config, port config) of ``arch``'s smoke config; "gqa" is
    the narrow dense config of 16 query heads over ``kv`` key heads."""
    if arch == "gqa":
        kw = dict(name=f"gqa-16x{kv}", num_heads=16, num_kv_heads=kv)
        return (dataclasses.replace(ref_get_smoke("llama3.2-1b"), **kw),
                dataclasses.replace(get_smoke_config("llama3.2-1b"), **kw))
    return ref_get_smoke(arch), get_smoke_config(arch)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32)
                                  if jnp.issubdtype(x.dtype, jnp.floating)
                                  else np.asarray(x), tree)


def _cell(name, arch, kind, *, kv=4, step_kw=None, ref_kw=None):
    """(case for the world script, reference outputs) of one cell."""
    rcfg, cfg = _configs(arch, kv)
    rmodel = RefModel(rcfg)
    shape = RShapeConfig("t", SEQ, BATCH, kind)
    rparams = rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    batch = rmodel.make_inputs(shape, rng=jax.random.key(1))
    case = dict(name=name, kind=kind, cfg=cfg, seq=SEQ, batch_size=BATCH,
                params=jax.tree_util.tree_map(np.asarray, rparams),
                batch={k: np.asarray(v) for k, v in batch.items()},
                step_kw=dict(step_kw or {}))
    ref_kw = dict(ref_kw or {})
    if kind == "train":
        case["step_kw"].update(TRAIN_KW)
        ref_kw.update(TRAIN_KW)
    mesh = ref_host_mesh()
    step, abstract = ref_make_step(rmodel, mesh, shape, **ref_kw)
    with mesh:
        if kind == "train":
            p, _, met = step(rparams, ref_adamw.adamw_init(rparams), batch)
            ref = dict(loss=float(met["loss"]), final_ce=float(met["final_ce"]),
                       params=_np(p))
        elif kind == "prefill":
            h, c = step(rparams, batch)
            ref = dict(h=_np(h), cache=_np(c))
        else:
            _, cache0, _ = abstract()
            rng = np.random.default_rng(0)
            cache = jax.tree_util.tree_map(
                lambda s: jnp.asarray(0.5 * rng.standard_normal(s.shape), s.dtype), cache0)
            case["cache"] = _np(cache)
            h, _, _ = rmodel.decode_step(rparams, cache, batch["tokens"], batch["pos"])
            logits = np.asarray(rmodel.logits(rparams, h)[:, -1], np.float64)
            top2 = np.sort(logits, axis=-1)[:, -2:]
            tok, c = step(rparams, cache, batch)
            ref = dict(token=np.asarray(tok), cache=_np(c), margin=top2[:, 1] - top2[:, 0])
    return case, ref


def _run_world(tmp, tag, cases, world, mesh):
    cases_path, out_path = tmp / f"{tag}_cases.pt", tmp / f"{tag}_out.pt"
    torch.save(cases, cases_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(WORLD_SCRIPT), str(cases_path), str(out_path),
                          "--world", str(world), "--mesh", mesh],
                         capture_output=True, text=True, env=env, cwd=str(ROOT),
                         timeout=WORLD_TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(zip([c["name"] for c in cases], torch.load(out_path, weights_only=False)))


MESH_2x4 = [
    ("granite-train", "granite-3-2b", "train", {}),
    ("granite-train-sp", "granite-3-2b", "train", {"seq_parallel": True}),
    ("scout-train", "llama4-scout-17b-a16e", "train", {}),
    ("rwkv6-decode", "rwkv6-3b", "decode", {"use_kernel": True}),
    ("zamba2-prefill", "zamba2-2.7b", "prefill", {"use_kernel": True}),
    ("gqa-prefill", "gqa", "prefill", {"attn_impl": "kernel"}),
    ("gqa-decode", "gqa", "decode", {"use_exit_kernel": True,
                                     "with_exit_confidence": True}),
]
MESH_1x4 = [
    ("gqa2-prefill", "gqa", "prefill", {"attn_impl": "pallas"}),
    ("gqa2-decode", "gqa", "decode", {"use_exit_kernel": True,
                                      "with_exit_confidence": True}),
]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's results and the reference's, by case name."""
    tmp = tmp_path_factory.mktemp("worlds")
    refs, out = {}, {}

    def cells(table, kv=4):
        cases = []
        for name, arch, kind, kw in table:
            case, refs[name] = _cell(name, arch, kind, kv=kv, step_kw=kw)
            cases.append(case)
        return cases

    out.update(_run_world(tmp, "m2x4", cells(MESH_2x4), 8, "2,4"))
    out.update(_run_world(tmp, "m2x2x2", [dict(cells([MESH_2x4[0]])[0], name="granite-pod")],
                          8, "2,2,2"))
    refs["granite-pod"] = refs["granite-train"]
    rcfg, cfg = _configs("gqa", 2)
    rng = np.random.default_rng(3)
    batch_case = dict(name="batch-decode", kind="batch_decode", cfg=cfg, seq=16,
                      params=jax.tree_util.tree_map(
                          np.asarray, RefModel(rcfg).init_params(jax.random.key(2),
                                                                 dtype=jnp.float32)),
                      prompts=[rng.integers(0, cfg.vocab_size, 5).astype(np.int64)
                               for _ in range(4)])
    out.update(_run_world(tmp, "w4", cells(MESH_1x4, kv=2) + [batch_case], 4, "1,4"))
    return refs, out


TRAIN_CASES = ["granite-train", "granite-train-sp", "scout-train", "granite-pod"]


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_train_step_matches_reference(worlds, name):
    refs, out = worlds
    ref, got = refs[name], out[name]
    assert abs(got["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    assert abs(got["final_ce"] - ref["final_ce"]) <= LOSS_RTOL * abs(ref["final_ce"])
    want = dict(T.leaves_with_paths(ref["params"]))
    for key, p in T.leaves_with_paths(got["params"]):
        np.testing.assert_allclose(p, want[key], rtol=0, atol=PARAM_TOL, err_msg=key)
    assert got["param_placements"] == got["want_param_placements"]


def test_seq_parallel_equals_plain(worlds):
    _, out = worlds
    a, b = out["granite-train"], out["granite-train-sp"]
    assert abs(a["loss"] - b["loss"]) <= SEQ_PARALLEL_TOL
    for x, y in zip(T.leaves(a["params"]), T.leaves(b["params"])):
        np.testing.assert_allclose(x, y, rtol=0, atol=SEQ_PARALLEL_TOL)


def _hold_cache(ref, got):
    want = dict(T.leaves_with_paths(ref["cache"]))
    for key, c in T.leaves_with_paths(got["cache"]):
        np.testing.assert_allclose(c, want[key], rtol=CACHE_RTOL, atol=CACHE_ATOL,
                                   err_msg=key)
    assert got["cache_placements"] == got["want_cache_placements"]


@pytest.mark.parametrize("name", ["zamba2-prefill", "gqa-prefill", "gqa2-prefill"])
def test_prefill_step_matches_reference(worlds, name):
    refs, out = worlds
    np.testing.assert_allclose(out[name]["h"], refs[name]["h"], rtol=0, atol=HIDDEN_TOL)
    _hold_cache(refs[name], out[name])


@pytest.mark.parametrize("name", ["rwkv6-decode", "gqa-decode", "gqa2-decode"])
def test_serve_step_matches_reference(worlds, name):
    refs, out = worlds
    ref, got = refs[name], out[name]
    same = got["token"][:, 0] == ref["token"][:, 0]
    assert np.all(same | (ref["margin"] < MARGIN_TOL))
    _hold_cache(ref, got)


def test_sharded_batch_decode_equals_plain(worlds):
    _, out = worlds
    plain, sharded = out["batch-decode"][False], out["batch-decode"][True]
    assert len(plain) == len(sharded) == 4
    for (h0, c0), (h1, c1) in zip(plain, sharded):
        np.testing.assert_allclose(h1, h0, rtol=0, atol=BATCH_TOL)
        for x, y in zip(T.leaves(c0), T.leaves(c1)):
            np.testing.assert_allclose(y, x, rtol=0, atol=BATCH_TOL)


def test_sharded_params_hold_their_shard(worlds):
    """Each rank holds its own shard: the local parameter bytes of the 2×4
    granite step are under half the whole (FSDP over ``data`` alone
    halves every weight)."""
    refs, out = worlds
    whole = sum(np.asarray(x).nbytes for x in T.leaves(refs["granite-train"]["params"]))
    assert 0 < out["granite-train"]["param_bytes"] < whole / 2
