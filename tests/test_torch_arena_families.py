"""The MoE and VLM families through the port's arena, batched and serial
decode and the fleet with real decode, against the JAX package at smoke
size on the CPU: llama4-scout-17b-a16e (an MoE unit every layer),
llama4-maverick-400b-a17b (the pair unit attn0, ffn, attn1, moe) and
llava-next-mistral-7b's text backbone (the sim feeds no image prefix, as
the reference's does not).

* The arena suite of ``tests/test_torch_arena.py``, case for case: its
  test functions are collected here again, on this file's ``stacks``.  An
  MoE routes each batch row as a group of its own (the reference's groups
  are batch rows), so a masked arena row never takes an active row's
  expert capacity; hidden states are held at the suite's ``moe``/``vlm``
  tolerance, 2e-5 (attention runs).
* The real-decode fleet: ``tests/test_torch_fleet.py``'s comparison with
  the reference (summaries, streams by the margin rule, arena and decode
  counters), with the planner's arch set to scout and to llava, for the
  arena and for batched decode.
* llama4-maverick cut to 2 layers, one dense/MoE unit, as the card serves
  it (``chip_smoke.py`` phase 18): its segments are [0, 1], and the empty
  segment holds no weights.  An unstacked unit there (what ``stack=0``
  builds, and the reference builds) would be a second MoE layer the
  forward never reads, 32 GB in bf16 at full width, and its leading axes
  would be taken for the unit count: the reference's scan raises on it.
  The port's stack is held against the reference's one-segment stack of
  the same unit (``num_exits=0``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as ref_config
import repro_torch.sim.build as sim_build
from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import Model as RefModel
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from test_arena import _static_spec
from test_torch_arena import (  # noqa: F401  (the suite's cases, run on this file's stacks)
    build_stacks,
    one_torch_thread,
    test_arena_churn_equals_serial_and_reference,
    test_arena_counters_and_variant_budget,
    test_arena_free_list_bucket_and_pow2,
    test_arena_growth_slots_and_length,
    test_decode_step_batch_equals_serial,
    test_extract_after_admit_is_bitwise,
    test_mask_none_is_unchanged_decode,
    test_masked_rows_bitwise_unchanged_two_exit_groups,
)
from test_torch_fleet import (  # noqa: F401
    _port_run,
    _ref_run,
    hold_against_reference,
    reference_constants,
)

SCOUT, MAVERICK, LLAVA = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
                          "llava-next-mistral-7b")
HIDDEN_TOL = 2e-5


@pytest.fixture(scope="module", params=(SCOUT, MAVERICK, LLAVA))
def stacks(request):
    return build_stacks(request.param)


# ------------------------------------------------------------- the fleet
def _spec(arch, arena, *, batch=True):
    """The reference arena suite's static real-decode spec on ``arch``."""
    spec = _static_spec(arena, batch=batch)
    return dataclasses.replace(spec, planner=dataclasses.replace(spec.planner, arch=arch))


@pytest.fixture(scope="module", params=(SCOUT, LLAVA))
def fleet_runs(request):
    """(arch, the reference's runs arena on and batched with arena off, the
    port's serial run on the reference's parameters with its margins)."""
    arch = request.param
    refs = {"arena": _ref_run(_spec(arch, True)), "batched": _ref_run(_spec(arch, False))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sim_build, "PEAK_FLOPS", ref_config.PEAK_FLOPS_BF16)
        mp.setattr(sim_build, "HBM_BW", ref_config.HBM_BW)
        serial = _port_run(_spec(arch, False, batch=False), refs["arena"][3], margins=True)
    return arch, refs, serial


@pytest.mark.parametrize("strategy", ["arena", "batched"])
def test_family_fleet_equals_reference(fleet_runs, strategy):
    """Summaries, token streams and arena/decode counters equal the
    reference's on its parameters; the arena pads nothing."""
    arch, refs, serial = fleet_runs
    hold_against_reference(refs[strategy], serial, _spec(arch, strategy == "arena"),
                           strategy)


# ------------------------------------------------------------- two-layer maverick
def test_two_layer_maverick_has_an_empty_first_segment():
    """Segments [0, 1]: the first holds no weights and no cache; prefill
    and decode at the full exit equal the reference's one-segment stack of
    the same unit, and the exit before the unit reads the embedding."""
    cfg = dataclasses.replace(get_smoke_config(MAVERICK), num_layers=2)
    model = Model(cfg)
    assert model.segment_lengths() == [0, 1]
    params = model.init_params(torch.Generator().manual_seed(0), dtype=torch.float32,
                               device="cpu")
    assert all(x.numel() == 0 for x in T.leaves(params["segments"][0]))
    assert all(x.shape[0] == 1 for x in T.leaves(params["segments"][1]))

    rcfg = dataclasses.replace(ref_get_smoke(MAVERICK), num_layers=2, num_exits=0)
    rmodel = RefModel(rcfg)
    rparams = rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    one = params_from_numpy(dataclasses.replace(cfg, num_exits=0),
                            jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    params = dict(params, embed=one["embed"], final_norm=one["final_norm"],
                  segments=(params["segments"][0], one["segments"][0]))

    toks = np.random.default_rng(3).integers(0, 256, (2, 5)).astype(np.int32)
    rcache = rmodel.init_cache(2, 9, dtype=jnp.float32)
    cache = model.init_cache(2, 9, dtype=torch.float32, device="cpu")
    assert all(x.numel() == 0 for x in T.leaves(cache[0]))
    rh, rcache = rmodel.prefill(rparams, jnp.asarray(toks), rcache)
    h, cache = model.prefill(params, torch.from_numpy(toks), cache)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=HIDDEN_TOL, rtol=0)
    for pos in range(5, 8):
        tok = np.argmax(np.asarray(rmodel.logits(rparams, rh))[:, -1], -1)[:, None]
        rh, rcache, _ = rmodel.decode_step(rparams, rcache, jnp.asarray(tok, jnp.int32),
                                           jnp.int32(pos))
        h, cache, _ = model.decode_step(params, cache, torch.from_numpy(tok).int(), pos)
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=HIDDEN_TOL, rtol=0)
    h0, _, _ = model.decode_step(params, cache, torch.from_numpy(tok).int(), 8,
                                 exit_point=0)
    x = params["embed"][torch.from_numpy(tok).long()]
    want = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)
    torch.testing.assert_close(h0, want * params["exit_norms"][0], atol=1e-6, rtol=0)
