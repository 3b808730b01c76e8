"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on the
production mesh, with no device (the counterpart of
``src/repro/launch/dryrun.py``).

The reference lowers and compiles each step for 512 forced host devices.
Here each cell starts a ``fake`` process group of 256 (16×16) or 512
(2×16×16) ranks in this process (``torch.testing``'s ``FakeStore``: every
collective returns at once, no data moves), builds the production mesh,
and runs the step once as rank 0 on ``Model.abstract_params()`` /
``make_inputs(abstract=True)``: ``meta`` tensors, so nothing is allocated
or computed and only shapes flow.  A decode cell's ``pos`` is the concrete
``seq_len - 1`` (the cache write needs its value).  Per cell the record has
the reference's schema:

* ``flops``, ``bytes_accessed`` (= ``flops_walked``, ``bytes_walked``) and
  ``bytes_literal``: per-device costs of the local ops
  (:mod:`repro_torch.launch.hlo_cost`);
* ``collectives``: count, result bytes and ring link bytes by kind
  (:func:`_link_bytes`, the reference's), ``total_bytes`` and
  ``total_link_bytes``: the gathers and reductions DTensor and the port's
  explicit redistributions issue, per device;
* ``memory.argument_bytes`` / ``output_bytes``: the step's local argument
  and output shard bytes; ``temp_bytes``, ``alias_bytes`` and
  ``generated_code_bytes`` are ``null`` (an eager run on meta tensors has
  no allocator peak, no donation and no compiled program);
* ``analytic_state_bytes_per_chip``: the reference's formula.

Every number is computed from shapes; none is measured.  Results append
to ``build/dryrun.json`` (reruns skip done cells).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun.json"


def _link_bytes(kind: str, result: int, g: int) -> float:
    """Per-device ring traffic for one execution, from the result size."""
    g = max(g, 2)
    if kind == "all-gather":
        return result * (g - 1) / g            # operand = result/g, send (g-1) shards
    if kind == "reduce-scatter":
        return result * (g - 1)                # operand = result*g
    if kind == "all-reduce":
        return 2.0 * result * (g - 1) / g
    return result * (g - 1) / g if kind == "all-to-all" else float(result)


def fake_world(size: int):
    """A ``fake`` default process group of ``size`` ranks, this process
    rank 0 (any other default group is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _tree_bytes(tree) -> int:
    from repro_torch import tree as T
    return sum(x.numel() * x.element_size() for x in T.leaves(tree)
               if hasattr(x, "numel"))


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, exit_point=None,
             moe_dispatch="einsum", attn_impl="auto", ce_chunk=512, scan_chunk=16,
             kv_quant=False, seq_parallel=False, extra_tag="") -> dict:
    """One cell's record on the production mesh (``multi_pod``: 2×16×16)."""
    from repro_torch.config import SHAPES, cell_applicable
    from repro_torch.configs import get_config
    from repro_torch.models.api import Model

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": reason}
    return run_model_cell(Model(cfg), shape, _production(multi_pod),
                          arch=arch, shape_name=shape_name, exit_point=exit_point,
                          moe_dispatch=moe_dispatch, attn_impl=attn_impl,
                          ce_chunk=ce_chunk, scan_chunk=scan_chunk, kv_quant=kv_quant,
                          seq_parallel=seq_parallel, extra_tag=extra_tag)


def _production(multi_pod: bool):
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


def run_model_cell(model, shape, mesh, *, arch=None, shape_name=None, exit_point=None,
                   moe_dispatch="einsum", attn_impl="auto", ce_chunk=512,
                   scan_chunk=16, kv_quant=False, seq_parallel=False,
                   extra_tag="") -> dict:
    """The dry-run record of one step of ``model`` at ``shape`` on ``mesh``."""
    import torch
    from repro_torch import tree as T
    from repro_torch.launch.hlo_cost import CostCounter
    from repro_torch.launch.mesh import distribute, local_bytes
    from repro_torch.launch.steps import batch_specs, cache_sharding_axes, make_step
    from repro_torch.optim.adamw import AdamWState

    if shape.kind == "train":
        kw = dict(moe_dispatch=moe_dispatch, attn_impl=attn_impl, ce_chunk=ce_chunk,
                  scan_chunk=scan_chunk, seq_parallel=seq_parallel)
    elif shape.kind == "prefill":
        kw = dict(moe_dispatch=moe_dispatch, attn_impl=attn_impl)
    else:
        kw = dict(moe_dispatch=moe_dispatch, exit_point=exit_point, kv_quant=kv_quant)
    step, abstract_inputs = make_step(model, mesh, shape, **kw)
    inputs = list(abstract_inputs())
    batch = dict(inputs[-1])
    if "pos" in batch:
        batch["pos"] = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
    inputs[-1] = batch
    cfg = model.cfg
    pspecs = model.param_specs()
    specs = [pspecs]
    if shape.kind == "train":
        specs.append(AdamWState(step=T.P(), mu=pspecs, nu=pspecs))
    elif shape.kind == "decode":
        baxes, saxes = cache_sharding_axes(shape, mesh)
        specs.append(model.cache_specs(batch_axes=baxes, seq_axes=saxes, quant=kv_quant))
    specs.append(batch_specs(cfg, shape, mesh))
    placed = [distribute(x, s, mesh) for x, s in zip(inputs, specs)]
    t0 = time.perf_counter()
    with CostCounter() as cost:
        out = step(*placed)
    t_step = time.perf_counter() - t0
    n_chips = mesh.size()
    pbytes = _tree_bytes(model.abstract_params())
    state = pbytes
    if shape.kind == "train":
        state += 2 * 4 * (pbytes // 2) + pbytes          # f32 moments + grads
    else:
        state += _tree_bytes(model.init_cache(shape.global_batch, shape.seq_len,
                                              device="meta", enc_len=shape.seq_len))
    mesh_name = "x".join(str(s) for s in mesh.shape)
    return {
        "status": "ok",
        "arch": arch or cfg.name, "shape": shape_name or shape.name,
        "mesh": mesh_name, "chips": n_chips,
        "step_s": t_step,
        "flops": cost.flops,
        "bytes_accessed": cost.bytes_walked,
        "flops_walked": cost.flops,
        "bytes_walked": cost.bytes_walked,
        "bytes_literal": cost.bytes_literal,
        "collectives": cost.collective_stats(),
        "memory": {
            "argument_bytes": sum(local_bytes(x) for x in placed),
            "output_bytes": local_bytes(out),
            "temp_bytes": None,
            "alias_bytes": None,
            "generated_code_bytes": None,
        },
        "analytic_state_bytes_per_chip": state // n_chips,
        "tag": extra_tag,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--exit-point", type=int, default=None)
    ap.add_argument("--moe-dispatch", default="einsum")
    ap.add_argument("--attn-impl", default="auto")
    ap.add_argument("--ce-chunk", type=int, default=512)
    ap.add_argument("--scan-chunk", type=int, default=16)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    from repro_torch.config import SHAPES
    from repro_torch.configs import ARCH_IDS

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s, mp) for a in ARCH_IDS for s in SHAPES for mp in meshes]
    else:
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    n_ok = n_skip = n_fail = 0
    for arch, shape, mp in cells:
        key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
        if args.tag:
            key += f"|{args.tag}"
        if key in results and results[key].get("status") in ("ok", "skipped") \
                and not args.force:
            print(f"[cached] {key}: {results[key]['status']}")
            n_ok += results[key]["status"] == "ok"
            n_skip += results[key]["status"] == "skipped"
            continue
        print(f"[run] {key} ...", flush=True)
        try:
            r = run_cell(arch, shape, mp, exit_point=args.exit_point,
                         moe_dispatch=args.moe_dispatch, attn_impl=args.attn_impl,
                         ce_chunk=args.ce_chunk, scan_chunk=args.scan_chunk,
                         kv_quant=args.kv_quant, seq_parallel=args.seq_parallel,
                         extra_tag=args.tag)
        except Exception as e:  # record and continue
            r = {"status": "error", "error": f"{type(e).__name__}: {e}",
                 "trace": traceback.format_exc()[-2000:]}
        results[key] = r
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        if r["status"] == "ok":
            n_ok += 1
            print(f"    ok: step={r['step_s']:.1f}s flops={r['flops']:.3e} "
                  f"coll={r['collectives']['total_bytes']:.3e}B", flush=True)
        elif r["status"] == "skipped":
            n_skip += 1
            print(f"    skipped: {r['reason']}", flush=True)
        else:
            n_fail += 1
            print(f"    ERROR: {r['error']}", flush=True)
    print(f"\ndone: ok={n_ok} skipped={n_skip} failed={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
