"""Bayesian Online Change-point Detection (Adams & MacKay 2007), used by
Algorithm 3 to detect bandwidth-state transitions (paper Sec. IV-C).

Gaussian observation model with unknown mean and variance
(Normal-Inverse-Gamma conjugate prior -> Student-t predictive), constant
hazard H = 1/lambda.  The run-length posterior is maintained online; a
change point is declared when the MAP run length drops.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from numpy import vectorize

_lgamma = vectorize(__import__("math").lgamma)


def _student_t_logpdf(x, df, loc, scale):
    z = (x - loc) / scale
    return (_lgamma((df + 1) / 2) - _lgamma(df / 2)
            - 0.5 * (np.log(df) + np.log(np.pi)) - np.log(scale)
            - (df + 1) / 2 * np.log1p(z * z / df))


# ---------------------------------------------------------------- run tables
# The NIG posterior's kappa/alpha arrays are *pure functions of the run
# length*: kappa[i] follows kappa0, kappa0+1, ... and alpha[i] follows
# alpha0, alpha0+0.5, ... regardless of the data.  Every lgamma/log term of
# the Student-t predictive that depends only on them is therefore a fixed
# per-index table, shared by all detectors with the same prior — the fleet
# runs one BOCD per device, and evaluating lgamma per element per update
# (via np.vectorize) dominated the mobility hot path.  Tables are built with
# the *same recurrences and elementwise ops* as the original update, so the
# fast path below is bit-identical to it (pinned by tests/test_bocd.py).
_TABLES: Dict[Tuple[float, float], dict] = {}


def _run_tables(alpha0: float, kappa0: float, n: int) -> dict:
    tab = _TABLES.get((alpha0, kappa0))
    if tab is not None and tab["n"] >= n:
        return tab
    m = max(n, 128, 2 * tab["n"] if tab is not None else 0)
    alpha_l, kappa_l = [alpha0], [kappa0]
    for _ in range(m - 1):                 # the exact += recurrences the
        alpha_l.append(alpha_l[-1] + 0.5)  # posterior update used to apply
        kappa_l.append(kappa_l[-1] + 1)
    alpha = np.array(alpha_l)
    kappa = np.array(kappa_l)
    df = 2 * alpha
    halfdfp1 = (df + 1) / 2
    tab = {
        "n": m,
        "alpha": alpha,
        "kappa": kappa,
        "df": df,
        "halfdfp1": halfdfp1,
        # lgamma((df+1)/2) - lgamma(df/2) - 0.5*(log(df) + log(pi)): the
        # data-independent prefix of the Student-t logpdf, in its exact
        # left-to-right accumulation order
        "const": (_lgamma(halfdfp1) - _lgamma(df / 2)
                  - 0.5 * (np.log(df) + np.log(np.pi))),
        "k1": kappa + 1,                   # kappa + 1
        "ak": alpha * kappa,               # alpha * kappa
        "t2k1": 2 * (kappa + 1),           # 2 * (kappa + 1)
    }
    _TABLES[(alpha0, kappa0)] = tab
    return tab


@dataclass
class BOCD:
    hazard: float = 1 / 50.0        # expected segment length lambda = 50
    mu0: float = 0.0
    kappa0: float = 1.0
    alpha0: float = 1.0
    beta0: float = 1.0
    max_run: int = 512
    trunc: float = 1e-6

    def __post_init__(self):
        self.reset()

    def reset(self):
        self.t = 0
        self.r_prob = np.array([1.0])           # P(r_t | x_1..t)
        self.mu = np.array([self.mu0])
        self.beta = np.array([self.beta0])
        self.map_run = 0

    # kappa/alpha are pure functions of the run-length index (see
    # _run_tables); only the current length is state.  The views keep the
    # pre-table attribute API intact.
    @property
    def kappa(self) -> np.ndarray:
        return _run_tables(self.alpha0, self.kappa0,
                           len(self.r_prob))["kappa"][: len(self.r_prob)]

    @property
    def alpha(self) -> np.ndarray:
        return _run_tables(self.alpha0, self.kappa0,
                           len(self.r_prob))["alpha"][: len(self.r_prob)]

    def update(self, x: float) -> bool:
        """Ingest one measurement; returns True when a change point fires.

        Every lgamma/log term that depends only on the run-length index
        comes from :func:`_run_tables`; the remaining ops accumulate the
        identical floats in the identical order as the pre-table
        implementation (bit-exact — tests/test_bocd.py pins a trace)."""
        n = len(self.r_prob)
        tab = _run_tables(self.alpha0, self.kappa0, n)
        kappa, k1 = tab["kappa"][:n], tab["k1"][:n]
        scale = np.sqrt(self.beta * k1 / tab["ak"][:n])
        z = (x - self.mu) / scale
        logpred = (tab["const"][:n] - np.log(scale)
                   - tab["halfdfp1"][:n] * np.log1p(z * z / tab["df"][:n]))
        pred = np.exp(logpred - logpred.max())
        pred = pred * np.exp(logpred.max())     # unnormalized predictive

        growth = self.r_prob * pred * (1 - self.hazard)
        cp = float(np.sum(self.r_prob * pred * self.hazard))
        new_r = np.concatenate([[cp], growth])
        s = new_r.sum()
        if s <= 0 or not np.isfinite(s):
            new_r = np.zeros_like(new_r)
            new_r[0] = 1.0
        else:
            new_r = new_r / s

        # posterior parameter update (kappa/alpha advance implicitly with
        # the array length)
        mu_new = np.concatenate([[self.mu0], (kappa * self.mu + x) / k1])
        beta_new = np.concatenate([
            [self.beta0],
            self.beta + kappa * (x - self.mu) ** 2 / tab["t2k1"][:n]])

        # truncate tail for O(max_run) updates: run lengths beyond the cap
        # collapse into the boundary (standard SOR truncation; indices stay
        # equal to run lengths so MAP-collapse detection remains valid)
        if len(new_r) > self.max_run:
            new_r = new_r[: self.max_run]
            mu_new = mu_new[: self.max_run]
            beta_new = beta_new[: self.max_run]
            s = new_r.sum()
            new_r = new_r / s if s > 0 else np.eye(len(new_r))[0]

        prev_map = self.map_run
        self.r_prob, self.mu, self.beta = new_r, mu_new, beta_new
        self.map_run = int(np.argmax(self.r_prob))
        self.t += 1
        # change point: MAP run length collapsed
        return self.map_run < prev_map - 2 or (self.map_run == 0 and prev_map > 3)

    @property
    def state_mean(self) -> float:
        """Posterior mean of the current segment (MAP run length)."""
        return float(self.mu[self.map_run])


class BOCDBank:
    """``n`` independent :class:`BOCD` detectors with a shared prior,
    updated in lockstep as one batch of 2-D numpy ops.

    The fleet simulator samples *every* device's bandwidth on the same
    virtual-time grid, so all per-device run-length posteriors always have
    the same length — rows of ``[n, run_length]`` matrices.  One batched
    update replaces ``n`` sequential :meth:`BOCD.update` calls; every row is
    bit-identical to the detector it replaces (numpy applies the same
    elementwise ops and the same pairwise reductions along the last axis —
    pinned by tests/test_bocd.py::test_bank_matches_scalar_detectors).
    """

    def __init__(self, n: int, hazard: float = 1 / 50.0, mu0: float = 0.0,
                 kappa0: float = 1.0, alpha0: float = 1.0, beta0: float = 1.0,
                 max_run: int = 512):
        self.n = n
        self.hazard, self.max_run = hazard, max_run
        self.mu0, self.kappa0 = mu0, kappa0
        self.alpha0, self.beta0 = alpha0, beta0
        self.t = 0
        self.r_prob = np.ones((n, 1))
        self.mu = np.full((n, 1), mu0)
        self.beta = np.full((n, 1), beta0)
        self.map_run = np.zeros(n, dtype=int)

    def update(self, x: np.ndarray) -> np.ndarray:
        """Ingest one measurement per detector (``x``: ``[n]``); returns a
        boolean ``[n]`` — which detectors fired a change point."""
        m = self.r_prob.shape[1]
        tab = _run_tables(self.alpha0, self.kappa0, m)
        kappa, k1 = tab["kappa"][:m], tab["k1"][:m]
        xc = np.asarray(x, dtype=float)[:, None]
        scale = np.sqrt(self.beta * k1 / tab["ak"][:m])
        z = (xc - self.mu) / scale
        logpred = (tab["const"][:m] - np.log(scale)
                   - tab["halfdfp1"][:m] * np.log1p(z * z / tab["df"][:m]))
        lmax = logpred.max(axis=1)
        pred = np.exp(logpred - lmax[:, None])
        pred = pred * np.exp(lmax)[:, None]     # unnormalized predictive

        growth = self.r_prob * pred * (1 - self.hazard)
        cp = (self.r_prob * pred * self.hazard).sum(axis=1)
        new_r = np.concatenate([cp[:, None], growth], axis=1)
        s = new_r.sum(axis=1)
        bad = (s <= 0) | ~np.isfinite(s)
        with np.errstate(divide="ignore", invalid="ignore"):
            new_r = new_r / s[:, None]
        mu_new = np.concatenate(
            [np.full((self.n, 1), self.mu0), (kappa * self.mu + xc) / k1],
            axis=1)
        beta_new = np.concatenate(
            [np.full((self.n, 1), self.beta0),
             self.beta + kappa * (xc - self.mu) ** 2 / tab["t2k1"][:m]],
            axis=1)

        if new_r.shape[1] > self.max_run:       # SOR truncation, all rows
            new_r = new_r[:, : self.max_run]
            mu_new = mu_new[:, : self.max_run]
            beta_new = beta_new[:, : self.max_run]
            s = new_r.sum(axis=1)
            with np.errstate(divide="ignore", invalid="ignore"):
                new_r = new_r / s[:, None]
            bad = bad | ~(s > 0)        # mirrors the scalar `if s > 0` gate
        if bad.any():
            new_r[bad] = 0.0
            new_r[bad, 0] = 1.0

        prev_map = self.map_run
        self.r_prob, self.mu, self.beta = new_r, mu_new, beta_new
        self.map_run = new_r.argmax(axis=1)
        self.t += 1
        return (self.map_run < prev_map - 2) | \
            ((self.map_run == 0) & (prev_map > 3))


class BandwidthStateDetector:
    """D(B_{1..t}) of Algorithm 3: wraps BOCD, exposes the current bandwidth
    state (segment mean) and change flags."""

    def __init__(self, hazard: float = 1 / 50.0):
        self.bocd = BOCD(hazard=hazard)
        self.history: List[float] = []
        self.changes: List[int] = []

    def update(self, bandwidth: float) -> float:
        changed = self.bocd.update(float(bandwidth))
        self.history.append(float(bandwidth))
        if changed:
            self.changes.append(len(self.history) - 1)
        return self.bocd.state_mean

    @property
    def current_state(self) -> float:
        return self.bocd.state_mean
