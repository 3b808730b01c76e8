"""The comparison that decides ``correct``.

After the window, with the program's state freed, the reference re-derives each
window batch's decode exits (Edgent's plan and deadline demotion on the virtual
clock) and runs a sample of the served requests, drawn from the seed with the
longest among them, over its padded prompt and the tokens the program fed each
decode step, at the depth each step ran.  The sample holds at least the
configuration's ``check_picks`` picked tokens; it favours short prompts, whose
rows cost the reference least, since every row's pad positions are worked out
once for all rows.  Compared, each against its limit:

* ``logit_gap``: the widest gap by which a token the program picked (after the
  prefill, and after every decode step, at its exit) lies below the reference's
  best logit at that position;
* ``exit_mismatches``: decode steps whose exit differs from the re-derived one;
* ``rows_lost``: sampled requests the program served in no row of its batch, or
  whose served tokens are not the tokens its exit head picked.

The reference reads the program's outputs (the picked tokens, the exits, the
served tokens, which row holds a request) only to judge them.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from portbench.reference import common as C
from portbench.reference import plan as P


@dataclass
class Served:
    """One window batch as the program served it (host values)."""
    requests: list            # traffic.Request, as handed to serve()
    link_idx: int             # the link's index when the batch started
    rows: np.ndarray          # [B, L] the prompts the prefill received
    exits: List[int]          # the exit of each decode step (1 = first segment)
    picks: np.ndarray         # [steps + 1, B] tokens the exit head picked
    served: Dict[int, list]   # rid -> the tokens serve() returned


def reference_exits(cfg: dict, mix: dict, trace, b: Served) -> List[int]:
    tiers = P.Tiers(cfg, mix["batch"])
    L = max(len(r.prompt) for r in b.requests)
    steps = max(r.max_new_tokens for r in b.requests)
    return P.batch_exits(tiers, mix["planner_slo_s"], L, steps,
                         min(r.slo_s for r in b.requests), trace, b.link_idx)


def find_row(b: Served, req) -> Optional[int]:
    """The row of the program's batch that holds ``req``'s prompt, left-padded."""
    L, n = b.rows.shape[1], len(req.prompt)
    for i in range(b.rows.shape[0]):
        if n <= L and np.array_equal(b.rows[i, L - n:], req.prompt) and not b.rows[i, :L - n].any():
            return i
    return None


def sample(batches: Sequence[Served], picks: int, seed: int):
    """(batch, request) pairs holding at least ``picks`` picked tokens (a request's
    are its batch's decode steps and one more): the longest prompt, then requests
    drawn from the seed without replacement, each with a weight of one over the
    square of its prompt's length."""
    pairs = [(b, r) for b in batches for r in b.requests]
    longest = max(range(len(pairs)), key=lambda i: (len(pairs[i][1].prompt), -i))
    rng = np.random.default_rng([seed, 3])
    lens = np.array([len(r.prompt) for _, r in pairs], np.float64)
    # weighted draws without replacement: order by u ** (1 / weight), largest
    # first, through its logarithm
    order = np.argsort(-np.log(rng.random(len(pairs))) * lens ** 2, kind="stable")
    out, n = [], 0
    for i in [longest] + [int(i) for i in order if i != longest]:
        if n >= picks:
            break
        b = pairs[i][0]
        out.append(pairs[i])
        n += 1 + max(r.max_new_tokens for r in b.requests)
    return out


def ref_row(cfg: dict, b: Served, req, exits: List[int], row_picks) -> C.Row:
    """The reference's row: the prompt left-padded to the batch's longest, then the
    token fed to each decode step; the prefill's pick leaves the last prompt
    position at full depth, step j's at position L + j at its exit."""
    n_seg = len(P.segment_lengths(cfg))
    L = max(len(r.prompt) for r in b.requests)
    steps = len(exits)
    tokens = np.zeros(L + steps, np.int64)
    tokens[L - len(req.prompt):L] = req.prompt
    tokens[L:] = row_picks[:steps]
    depth = np.full(L + steps, n_seg, np.int64)
    depth[L:] = exits
    picks = [(L - 1, n_seg)] + [(L + j, exits[j]) for j in range(steps)]
    return C.Row(tokens, depth, picks, L - len(req.prompt))


def model(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


@dataclass
class Job:
    """A sampled request as the reference runs it, with the tokens the program
    picked at each of its pick positions."""
    row: C.Row
    picked: List[int]


def prepare(cfg: dict, mix: dict, batches: Sequence[Served], trace, seed: int,
            picks: int):
    """(exit mismatches, rows lost, the sampled jobs): the exits re-derived for
    every window batch and compared, and the sample's rows located."""
    exit_bad, ref_exits = 0, {}
    for b in batches:
        want = reference_exits(cfg, mix, trace, b)
        ref_exits[id(b)] = want
        exit_bad += sum(int(x != y) for x, y in zip(want, b.exits)) + abs(len(want) - len(b.exits))
    lost, jobs = 0, []
    for b, req in sample(batches, picks, seed):
        i = find_row(b, req)
        if i is None:
            lost += 1
            continue
        row_picks = [int(t) for t in b.picks[:, i]]
        if [int(t) for t in b.served.get(req.rid, [])] != row_picks[1:1 + req.max_new_tokens]:
            lost += 1
        jobs.append(Job(ref_row(cfg, b, req, ref_exits[id(b)], row_picks), row_picks))
    return exit_bad, lost, jobs


def widest_gap(ref_logits, tokens) -> float:
    """The widest gap by which ``tokens`` lie below the best of their logits."""
    return max((float(lg.max() - lg[t]) for lg, t in zip(ref_logits, tokens)), default=0.0)


def reference_logits(cfg: dict, params: dict, jobs: Sequence[Job], precision="f32"):
    """Each job's logits at its pick positions, the reference in ``precision``; the
    rows' pad positions are worked out once, over the longest pad."""
    C.exact_matmul()
    fam, mm = model(cfg), C.Matmul(precision)
    embed = params["embed"].float()
    pad = max((j.row.pad for j in jobs), default=0)
    prefix = fam.pad_prefix(cfg, params, pad, mm, embed) if pad else None
    out = [fam.row_logits(cfg, params, j.row, mm, embed, prefix) for j in jobs]
    del embed, prefix
    return out


def check(cfg: dict, mix: dict, params: dict, batches: Sequence[Served], trace,
          seed: int, limits: dict, keep: Optional[dict] = None) -> dict:
    """Every compared number with its limit, and ``correct``.  ``keep`` (a dict)
    receives the jobs and their float32 logits, for the control."""
    exit_bad, lost, jobs = prepare(cfg, mix, batches, trace, seed, cfg["check_picks"])
    ref = reference_logits(cfg, params, jobs)
    gap = max((widest_gap(r, j.picked) for r, j in zip(ref, jobs)), default=0.0)
    if keep is not None:
        keep.update(jobs=jobs, ref=ref)
    checks = {"logit_gap": (gap, limits["logit_gap"]),
              "exit_mismatches": (exit_bad, 0),
              "rows_lost": (lost, 0)}
    return {"checks": checks, "picks_compared": sum(len(j.picked) for j in jobs),
            "correct": all(v <= lim for v, lim in checks.values())}


def control_gap(cfg: dict, params: dict, jobs: Sequence[Job], ref) -> float:
    """The control: the reference in float8 e4m3 matmuls, put in the program's place
    over the same rows.  At each pick position, the gap in the float32 reference's
    logits of the token the float8 logits put first; the widest."""
    low = reference_logits(cfg, params, jobs, "fp8")
    return max((widest_gap(r, [int(x.argmax()) for x in l]) for r, l in zip(ref, low)),
               default=0.0)
