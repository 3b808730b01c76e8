"""The port's slot-resident decode arena and batched decode against its
serial decode and against the JAX package's ``DecodeArena``, at smoke size
on the CPU, for the three families the port serves: dense (llama3.2-1b),
ssm (rwkv6-3b) and hybrid (zamba2-2.7b).  The reference's parameters are
carried across with ``params_from_numpy``.

* churn: mixed exits, mixed prompt lengths, mid-stream admits and evicts
  and an extract -> re-admit of every resident request.  Arena tokens
  equal serial tokens, and the reference arena's tokens, except from a
  step where the serial token's top-2 logit margin is below MARGIN_TOL
  (then they are compared up to it); arena hidden states are allclose to
  serial ones (1e-5; 2e-5 where attention runs).  Torch does not promise
  the bit-identity across batch widths that the reference's arena has (a
  GEMM may reduce in another order at 4 rows than at 1).
* bitwise: every row outside an arena call's mask, over two exit groups
  in one round (K/V, recurrent state, the hybrid's shared K/V), and
  ``extract`` after ``admit``.
* mechanics: slot and length growth, the lowest-slot free list, a bad
  bucket, ``pow2``; the counters; ``decode_step_batch`` against serial
  with padding rows that share no storage with row 0.
"""
import jax
import numpy as np
import pytest
import torch

from repro.sim import PlannerSpec as RefPlannerSpec
from repro.sim.build import build_stack as ref_build_stack
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import _write_cache
from repro_torch.serving.arena import DecodeArena, pow2, tree_leaves, tree_map
from repro_torch.serving.engine import CoInferenceStepper
from repro_torch.sim import PlannerSpec
from repro_torch.sim.build import build_stack
from test_arena import _churn_tokens as ref_churn_tokens
from test_arena import _plan_from_seed

ARCHS = ("llama3.2-1b", "rwkv6-3b", "zamba2-2.7b")
MARGIN_TOL = 1e-4
# arena against serial hidden states, by family: 2e-5 where attention runs
# (the MoE and VLM families' cases run in test_torch_arena_families.py)
HIDDEN_TOL = {"dense": 2e-5, "ssm": 1e-5, "hybrid": 2e-5, "moe": 2e-5, "vlm": 2e-5}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs files
    side by side in worker processes on a shared CPU, where wall-clock
    tests in other files feel oversubscription."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def stacks(request):
    return build_stacks(request.param)


def build_stacks(arch):
    """(reference stack, port stack): the port's model on the CPU with the
    reference's parameters."""
    ref = ref_build_stack(RefPlannerSpec(arch=arch), with_model=True)
    port = build_stack(PlannerSpec(arch=arch), with_model=True,
                       with_params=False, device="cpu")
    port.params = params_from_numpy(
        port.cfg, jax.tree_util.tree_map(np.asarray, ref.params), device="cpu")
    return ref, port


def _prefill_row(stack, *, prompt_len, extra, seed):
    """One B=1 (cache, tok) row after a real prefill, on the prompt the
    reference's test draws for the same seed."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(
        rng.integers(0, stack.cfg.vocab_size, (1, prompt_len)).astype(np.int32))
    cache = stack.model.init_cache(1, prompt_len + extra + 1,
                                   dtype=torch.float32, device="cpu")
    h, cache = stack.model.prefill(stack.params, toks, cache)
    return cache, _argmax(stack, h)[:, None]


def _argmax(stack, h):
    logits = stack.model.logits(stack.params, h)
    return torch.argmax(logits[:, -1, :], -1).to(torch.int32)


def _margin(stack, h):
    top2 = stack.model.logits(stack.params, h)[:, -1].topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist()


def _snapshot(cache):
    return tree_map(lambda x: x.clone(), cache)


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def _port_churn(stack, plan, *, arena_slots, arena_len, handover_steps=()):
    """Decode ``plan`` rows (as the reference's ``_churn_tokens``) serially
    and through an arena with churn.  Returns (serial tokens, serial
    margins, serial hiddens, arena tokens, arena hiddens, arena stepper)."""
    rows = {i: _prefill_row(stack, prompt_len=p["prompt_len"], extra=p["extra"],
                            seed=1000 + i)
            for i, p in enumerate(plan)}
    horizon = max(p["start"] + p["steps"] for p in plan)

    def live(p, step):
        return p["start"] <= step < p["start"] + p["steps"]

    stepper_s = CoInferenceStepper(stack.model, stack.graph, stack.planner)
    serial = {i: [] for i in rows}
    margins = {i: [] for i in rows}
    hidden = {i: [] for i in rows}
    state = {i: (_snapshot(rows[i][0]), rows[i][1]) for i in rows}
    for step in range(horizon):
        for i, p in enumerate(plan):
            if not live(p, step):
                continue
            cache, tok = state[i]
            pos = p["prompt_len"] + (step - p["start"])
            h, cache = stepper_s.decode_fn(p["exit"])(stack.params, cache, tok, pos)
            tok = _argmax(stack, h)[:, None]
            serial[i].append(int(tok[0, 0]))
            margins[i].append(_margin(stack, h)[0])
            hidden[i].append(h)
            state[i] = (cache, tok)

    stepper_a = CoInferenceStepper(stack.model, stack.graph, stack.planner)
    arena = DecodeArena(stack.model, slots=arena_slots, length=arena_len,
                        dtype=torch.float32, stepper=stepper_a, device="cpu")
    got = {i: [] for i in rows}
    got_h = {i: [] for i in rows}
    toks = {i: rows[i][1] for i in rows}
    for step in range(horizon):
        for i, p in enumerate(plan):
            if step == p["start"]:
                arena.admit(i, rows[i][0])
        if step in handover_steps:
            resident = [i for i in rows if arena.has(i)]
            snaps = {i: arena.extract(i) for i in resident}
            for i in reversed(resident):
                arena.admit(i, snaps[i])
        items = [(p["exit"], arena.slot(i), toks[i],
                  p["prompt_len"] + (step - p["start"]))
                 for i, p in enumerate(plan) if live(p, step)]
        if items:
            nts, hs = {}, {}
            for group_rows, h_all in stepper_a.decode_step_arena(
                    stack.params, arena, items):
                nt = _argmax(stack, h_all)
                for _, slot, _, _ in group_rows:
                    nts[slot] = nt[slot:slot + 1][:, None]
                    hs[slot] = h_all[slot:slot + 1]
            for i, p in enumerate(plan):
                if live(p, step):
                    toks[i] = nts[arena.slot(i)]
                    got[i].append(int(toks[i][0, 0]))
                    got_h[i].append(hs[arena.slot(i)])
        for i, p in enumerate(plan):
            if step == p["start"] + p["steps"] - 1:
                arena.evict(i)
    return serial, margins, hidden, got, got_h, stepper_a


def _held_tokens(want, got, margins):
    """``got`` equals ``want`` request by request, up to the first step
    where they differ, and there ``want``'s token must be a near-tie (top-2
    margin below MARGIN_TOL).  Returns the number of steps held equal per
    request."""
    held = {}
    for i, w in want.items():
        g = got[i]
        assert len(g) == len(w), f"request {i}: {len(g)} tokens, want {len(w)}"
        k = next((j for j, (a, b) in enumerate(zip(w, g)) if a != b), len(w))
        if k < len(w):
            assert margins[i][k] < MARGIN_TOL, (
                f"request {i}: token {k} is {g[k]}, want {w[k]} at top-2 "
                f"margin {margins[i][k]}")
        held[i] = k
    return held


# ------------------------------------------------------------- churn
@pytest.mark.parametrize("seed,n,slots,length,handover", [
    (42, 4, 2, 4, (2,)),      # the reference's fixed-seed case
    (7, 3, 1, 4, (1,)),       # one slot to start: grows under churn
])
def test_arena_churn_equals_serial_and_reference(stacks, seed, n, slots,
                                                 length, handover):
    """Mixed exits and prompt lengths, mid-stream admits/evicts and an
    extract -> re-admit of everyone: the port's arena tokens equal its
    serial tokens and the reference arena's (margin rule), hidden states
    allclose to serial."""
    ref, port = stacks
    plan = _plan_from_seed(ref, seed, n)
    serial, margins, hidden, got, got_h, _ = _port_churn(
        port, plan, arena_slots=slots, arena_len=length, handover_steps=handover)
    held = _held_tokens(serial, got, margins)
    tol = HIDDEN_TOL[port.cfg.family]
    for i, k in held.items():
        for a, b in zip(hidden[i][:k + 1], got_h[i][:k + 1]):
            torch.testing.assert_close(b, a, atol=tol, rtol=0)
    ref_serial, ref_got = ref_churn_tokens(ref, plan, arena_slots=slots,
                                           arena_len=length,
                                           handover_steps=handover)
    assert ref_serial == ref_got                 # the reference's own pin
    _held_tokens(serial, ref_got, margins)


def test_arena_counters_and_variant_budget(stacks):
    """Three calls over two resident rows: one arena variant, masked rows
    counted for the occupancy metric, no padding."""
    _, port = stacks
    stepper = CoInferenceStepper(port.model, port.graph, port.planner)
    arena = DecodeArena(port.model, slots=4, length=16, dtype=torch.float32,
                        stepper=stepper, device="cpu")
    rows = [_prefill_row(port, prompt_len=4, extra=4, seed=i) for i in range(2)]
    for i, (cache, _) in enumerate(rows):
        arena.admit(i, cache)
    items = [(1, arena.slot(i), rows[i][1], 4) for i in range(2)]
    for _ in range(3):
        stepper.decode_step_arena(port.params, arena, items)
    st = stepper.cache_stats()
    assert st["arena"] == {"calls": 3, "tokens": 6, "masked_rows": 6,
                           "admits": 2, "evicts": 0, "grows": 0,
                           "occupancy": round(6 / 12, 4), "variants": 1}
    assert st["jit"]["variants"] == {"serial": 0, "batched": 0, "arena": 1}
    assert st["decode"]["padded_rows"] == 0


# ------------------------------------------------------------- bitwise
def test_masked_rows_bitwise_unchanged_two_exit_groups(stacks):
    """One round with two exit groups sweeps the arena in two calls with
    disjoint masks: each call leaves every row outside its mask bit for bit
    as it was (every leaf: K/V, recurrent state, shared K/V), and changes
    the rows inside it."""
    _, port = stacks
    stepper = CoInferenceStepper(port.model, port.graph, port.planner)
    arena = DecodeArena(port.model, slots=4, length=16, dtype=torch.float32,
                        stepper=stepper, device="cpu")
    rows = [_prefill_row(port, prompt_len=3 + i, extra=4, seed=20 + i)
            for i in range(3)]
    for i, (cache, _) in enumerate(rows):
        arena.admit(i, cache)
    last = port.graph.num_exits
    assert stepper.to_model_exit(1) != stepper.to_model_exit(last)
    exits = (1, last, 1)
    calls = []
    inner = stepper.decode_fn_arena

    def checked_fn(graph_exit, ar):
        fn = inner(graph_exit, ar)

        def run(p, cache, tok, pos, mask):
            before = _snapshot(cache)
            h, new = fn(p, cache, tok, pos, mask)
            keep = ~mask
            changed = False
            for b, a in zip(tree_leaves(before), tree_leaves(new)):
                assert torch.equal(b[:, keep], a[:, keep])
                changed |= not torch.equal(b[:, mask], a[:, mask])
            assert changed, "an arena call committed nothing"
            calls.append(mask.nonzero().flatten().tolist())
            return h, new
        return run

    stepper.decode_fn_arena = checked_fn
    for step in range(2):
        items = [(exits[i], arena.slot(i), rows[i][1], 3 + i + step)
                 for i in range(3)]
        stepper.decode_step_arena(port.params, arena, items)
    assert calls == [[0, 2], [1], [0, 2], [1]]
    # the fourth slot, never admitted, is still all zeros
    for leaf in tree_leaves(arena.cache):
        assert not leaf[:, 3].any()


def test_extract_after_admit_is_bitwise(stacks):
    """admit -> extract returns the admitted cache bit for bit, sliced back
    from the padded row, in storage of its own."""
    _, port = stacks
    cache, _ = _prefill_row(port, prompt_len=5, extra=3, seed=0)
    arena = DecodeArena(port.model, slots=2, length=32, dtype=torch.float32,
                        device="cpu")
    arena.admit("r", cache)
    out = arena.extract("r")
    _assert_trees_equal(cache, out)
    arena_ptrs = {leaf.untyped_storage().data_ptr() for leaf in tree_leaves(arena.cache)}
    assert not arena_ptrs & {x.untyped_storage().data_ptr() for x in tree_leaves(out)}
    assert not arena.has("r") and arena.active == 0


# ------------------------------------------------------------- mechanics
def test_arena_growth_slots_and_length(stacks):
    """Admitting past capacity doubles slots; a longer-than-arena cache
    re-buckets the length (for the families whose cache has a sequence
    axis); resident rows still extract bitwise."""
    _, port = stacks
    small, _ = _prefill_row(port, prompt_len=4, extra=2, seed=1)
    big, _ = _prefill_row(port, prompt_len=4, extra=40, seed=2)
    stepper = CoInferenceStepper(port.model, port.graph, port.planner)
    arena = DecodeArena(port.model, slots=1, length=4, dtype=torch.float32,
                        stepper=stepper, device="cpu")
    has_seq = port.cfg.family != "ssm"
    assert arena.slots == 1 and arena.length == 4
    arena.admit("a", small)                      # true len 7: len 4 -> 8
    assert arena.length == (8 if has_seq else 4)
    arena.admit("b", small)                      # slot growth: 1 -> 2
    assert arena.slots == 2
    arena.admit("c", big)                        # len 8 -> 64 and 2 -> 4
    assert arena.slots == 4 and arena.length == (64 if has_seq else 4)
    assert stepper.arena_grows == (4 if has_seq else 2)
    for rid, src in (("a", small), ("c", big)):
        _assert_trees_equal(src, arena.extract(rid))


def test_arena_free_list_bucket_and_pow2(stacks):
    """The free list hands out the lowest slot first; a bad bucket policy
    is refused; ``pow2`` rounds up to a power of two."""
    _, port = stacks
    cache, _ = _prefill_row(port, prompt_len=4, extra=2, seed=3)
    arena = DecodeArena(port.model, slots=4, length=16, dtype=torch.float32,
                        device="cpu")
    assert [arena.admit(r, cache) for r in "abc"] == [0, 1, 2]
    arena.evict("a")
    assert arena.admit("d", cache) == 0
    assert arena.slot("b") == 1
    with pytest.raises(ValueError, match="bucket"):
        DecodeArena(port.model, slots=1, length=4, dtype=torch.float32,
                    bucket="linear", device="cpu")
    assert [pow2(n) for n in (1, 2, 3, 4, 5, 8, 9, 17)] == \
        [1, 2, 4, 4, 8, 8, 16, 32]


def test_decode_step_batch_equals_serial(stacks):
    """Three congruent requests decode in one batched call padded to 4 rows
    with a copy of row 0: tokens (margin rule) and hidden states as the
    serial path's; no input cache is written (padding shares no storage
    with row 0), and every returned cache owns its storage."""
    _, port = stacks
    rows = [_prefill_row(port, prompt_len=5, extra=4, seed=40 + i)
            for i in range(3)]
    inputs = [_snapshot(c) for c, _ in rows]
    stepper = CoInferenceStepper(port.model, port.graph, port.planner)
    items = [(2, c, t, 5) for c, t in rows]
    outs = stepper.decode_step_batch(port.params, items)
    st = stepper.cache_stats()["decode"]
    assert (st["batched_calls"], st["batched_tokens"], st["padded_rows"],
            st["batched_max"]) == (1, 3, 1, 3)
    for (c, _), c0 in zip(rows, inputs):
        _assert_trees_equal(c0, c)
    ptrs = [{x.untyped_storage().data_ptr() for x in tree_leaves(new)}
            for _, new in outs]
    ptrs.append({x.untyped_storage().data_ptr() for c, _ in rows
                 for x in tree_leaves(c)})
    for a in range(len(ptrs)):
        for b in range(a + 1, len(ptrs)):
            assert not ptrs[a] & ptrs[b]
    serial = CoInferenceStepper(port.model, port.graph, port.planner)
    tol = HIDDEN_TOL[port.cfg.family]
    for c0, (_, t), (h, new) in zip(inputs, rows, outs):
        hs, cs = serial.decode_fn(2)(port.params, _snapshot(c0), t, 5)
        want, got = int(_argmax(port, hs)[0]), int(_argmax(port, h)[0])
        assert want == got or _margin(port, hs)[0] < MARGIN_TOL
        torch.testing.assert_close(h, hs, atol=tol, rtol=0)
        for x, y in zip(tree_leaves(cs), tree_leaves(new)):
            torch.testing.assert_close(y, x, atol=tol, rtol=0)


def test_mask_none_is_unchanged_decode(stacks):
    """``decode_step`` without a mask is the step it was: an all-true mask
    gives the same hidden state and cache bit for bit."""
    _, port = stacks
    cache, tok = _prefill_row(port, prompt_len=5, extra=3, seed=5)
    c1, c2 = _snapshot(cache), _snapshot(cache)
    pos = torch.tensor([5])
    h1, n1, _ = port.model.decode_step(port.params, c1, tok, pos)
    h2, n2, _ = port.model.decode_step(port.params, c2, tok, pos,
                                       mask=torch.tensor([True]))
    assert torch.equal(h1, h2)
    _assert_trees_equal(n1, n2)


def test_masked_commit_takes_row_positions():
    """The masked commit writes one token a row at [B] positions and keeps
    the rows outside the mask; a mask with one shared int position is
    refused, not applied."""
    buf = torch.zeros(2, 4, 1, 3)
    val = torch.ones(2, 1, 1, 3)
    mask = torch.tensor([True, False])
    with pytest.raises(ValueError):
        _write_cache(buf, val, 1, mask)
    assert buf.eq(0).all()
    _write_cache(buf, val, torch.tensor([1, 2]), mask)
    assert buf[0, 1].eq(1).all() and buf[0].sum() == 3 and buf[1].eq(0).all()
