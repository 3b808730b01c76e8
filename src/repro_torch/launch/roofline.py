"""Roofline terms from the dry run's records (the counterpart of
``src/repro/launch/roofline.py``), on the port's H100 constants.

Per (arch x shape) on the single-pod mesh:

    compute    = per-device FLOPs / peak
    memory     = per-device bytes / hbm_bw
    collective = per-device link bytes / link_bw

plus MODEL_FLOPS = 6*N*D (training; 2*N*D forward-only) with N = (active)
params and D = tokens, and the useful-compute ratio MODEL_FLOPS / (FLOPs x
chips).  The arithmetic is the reference's; the defaults are the port's
constants (``repro_torch.config``, NVIDIA's H100 SXM data sheet at 700 W):
``PEAK_FLOPS_BF16`` 989e12 FLOP/s, ``HBM_BW`` 3.35e12 B/s, and for the
collective term ``NVLINK_BW``, 450e9 B/s each way per card.  NVLink joins
the 8 GPUs of one node; a 16-wide ``model`` axis spans two 8-GPU nodes, so
its collectives cross the slower inter-node network and the NVLink term is
a lower bound there.  The dry run's costs are per device already
(:mod:`repro_torch.launch.dryrun`), and every term here is computed from
constants and shapes: none is measured.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

from repro_torch.config import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, SHAPES
from repro_torch.configs import get_config

DEFAULT_RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun.json"


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    useful_ratio: float
    bottleneck: str
    roofline_fraction: float      # model-useful time / dominant term

    def dominant(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs for the cell: 6*N*D train, 2*N*D inference."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def terms_from_record(rec: dict, *, chips: Optional[int] = None,
                      peak: float = PEAK_FLOPS_BF16, hbm: float = HBM_BW,
                      link: float = NVLINK_BW) -> RooflineTerms:
    chips = chips or rec["chips"]
    flops = float(rec.get("flops_walked") or rec["flops"])
    byts = float(rec.get("bytes_walked") or rec["bytes_accessed"])
    coll = float(rec["collectives"]["total_link_bytes"])
    compute = flops / peak
    memory = byts / hbm
    collective = coll / link
    mf = model_flops(rec["arch"], rec["shape"])
    useful = mf / max(flops * chips, 1.0)
    dom = max(compute, memory, collective)
    name = ("compute" if dom == compute else
            "memory" if dom == memory else "collective")
    ideal = mf / (chips * peak)
    return RooflineTerms(
        arch=rec["arch"], shape=rec["shape"],
        compute_s=compute, memory_s=memory, collective_s=collective,
        model_flops=mf, hlo_flops=flops * chips, useful_ratio=useful,
        bottleneck=name, roofline_fraction=ideal / max(dom, 1e-30))


def load_results(path) -> Dict[str, dict]:
    with open(path) as f:
        return json.load(f)


def report(path, mesh: str = "single", tag: str = "", **constants) -> str:
    """The roofline table of the records in ``path`` on ``mesh``;
    ``constants`` (``peak``, ``hbm``, ``link``) replace the H100's."""
    results = load_results(path)
    lines = [
        f"{'arch':26s} {'shape':12s} {'compute_s':>11s} {'memory_s':>11s} "
        f"{'collect_s':>11s} {'bottleneck':>10s} {'useful':>7s} {'roofline%':>9s}"]
    for key, rec in sorted(results.items()):
        parts = key.split("|")
        if len(parts) < 3 or parts[2] != mesh:
            continue
        if (len(parts) > 3) != bool(tag) or (tag and parts[3] != tag):
            continue
        if rec.get("status") == "skipped":
            lines.append(f"{parts[0]:26s} {parts[1]:12s} {'skipped: ' + rec['reason']}")
            continue
        if rec.get("status") != "ok":
            lines.append(f"{parts[0]:26s} {parts[1]:12s} ERROR")
            continue
        t = terms_from_record(rec, **constants)
        lines.append(
            f"{t.arch:26s} {t.shape:12s} {t.compute_s:11.4e} {t.memory_s:11.4e} "
            f"{t.collective_s:11.4e} {t.bottleneck:>10s} {t.useful_ratio:7.3f} "
            f"{100*t.roofline_fraction:8.1f}%")
    return "\n".join(lines)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(DEFAULT_RESULTS))
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    print(report(args.results, args.mesh, args.tag))
