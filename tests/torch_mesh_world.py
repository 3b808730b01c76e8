"""Run sharded steps of the port in a gloo world on the CPU.

    python tests/torch_mesh_world.py CASES OUT --world N [--mesh 2,4 | 2,2,2]

spawns N processes (one torch thread each), joins them into a gloo world
through a file store, builds the mesh (``(data, model)`` for two dims,
``(pod, data, model)`` for three; no mesh for ``--mesh 0``) and runs every
case of ``CASES`` (a ``torch.save`` of a list of dicts) on every rank.
Rank 0 writes a list of results, one per case, to ``OUT``.  A case is:

* ``kind`` "train" / "prefill" / "decode": ``cfg``, ``params`` (numpy
  tree), ``batch`` (numpy dict) and, for decode, ``cache`` (numpy tree);
  optional ``step_kw``.  The step's outputs come back whole (gathered), with
  the placements of the cache leaves, the placements the specs ask for,
  and the local shard bytes of the parameters.
* ``kind`` "batch_decode": ``decode_step_batch(sharded=True)`` of a
  ``CoInferenceStepper`` over the world, and the same call with
  ``sharded=False``, on ``prompts`` prefilled one by one.

The pytest files that drive this script hold the results against the
reference.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _tree_np(tree):
    from repro_torch import tree as T

    def full(x):
        if x is None:
            return None
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        return x.detach().float().numpy() if x.is_floating_point() else x.detach().numpy()
    return T.tree_map(full, tree)


def _torch(tree):
    import numpy as np
    import torch
    from repro_torch import tree as T
    return T.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _placements(tree):
    from repro_torch import tree as T
    return [str(tuple(x.placements)) for x in T.leaves(tree)]


def run_case(case, mesh):
    from repro_torch import tree as T
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models.api import Model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim.adamw import adamw_init

    kind = case["kind"]
    if kind == "batch_decode":
        return batch_decode(case)
    cfg = case["cfg"]
    model = Model(cfg)
    shape = ShapeConfig("t", case["seq"], case["batch_size"], kind)
    params = params_from_numpy(cfg, case["params"], device="cpu")
    batch = _torch(case["batch"])
    step, _ = steps.make_step(model, mesh, shape, **case.get("step_kw", {}))
    out = {"param_bytes": M.local_bytes(M.distribute(params, model.param_specs(), mesh))}
    if kind == "train":
        p, opt, met = step(params, adamw_init(params), batch)
        out.update(loss=float(met["loss"]), final_ce=float(met["final_ce"]),
                   params=_tree_np(p),
                   param_placements=_placements(p),
                   want_param_placements=[str(M.placements(s, mesh)) for s in
                                          T.leaves(model.param_specs())])
        return out
    baxes, saxes = steps.cache_sharding_axes(shape, mesh)
    want = [str(M.placements(s, mesh)) for s in T.leaves(model.cache_specs(
        batch_axes=baxes, seq_axes=saxes, quant=case.get("step_kw", {}).get("kv_quant", False)))]
    if kind == "prefill":
        h, cache = step(params, batch)
        out.update(h=_tree_np(h))
    else:
        cache = _torch(case["cache"])
        cache = T.tree_map(lambda c, r: c.to(r.dtype), cache, model.init_cache(
            shape.global_batch, shape.seq_len, device="cpu", enc_len=shape.seq_len))
        tok, cache = step(params, cache, batch)
        out.update(token=_tree_np(tok))
    out.update(cache=_tree_np(cache), cache_placements=_placements(cache),
               want_cache_placements=want)
    return out


def batch_decode(case):
    """``decode_step_batch`` over ``rows`` congruent requests with and
    without ``sharded``, from the same prefilled caches."""
    import types
    import torch
    from repro_torch.models.api import Model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serving.engine import CoInferenceStepper

    cfg = case["cfg"]
    model = Model(cfg)
    params = params_from_numpy(cfg, case["params"], device="cpu")
    items = []
    for prompt in case["prompts"]:
        tokens = torch.from_numpy(prompt)[None]
        cache = model.init_cache(1, case["seq"], dtype=torch.float32, device="cpu")
        h, cache = model.prefill(params, tokens, cache)
        tok = model.logits(params, h)[:, -1].argmax(-1, keepdim=True)
        items.append((None, cache, tok, tokens.shape[1]))
    out = {}
    for sharded in (False, True):
        stepper = CoInferenceStepper(model, types.SimpleNamespace(num_exits=model.num_segments),
                                     None)
        res = stepper.decode_step_batch(params, items, sharded=sharded)
        out[sharded] = [(_tree_np(h), _tree_np(c)) for h, c in res]
    return out


def rank_main(rank, world, mesh_shape, store_path, cases_path, out_path, timeout):
    import faulthandler
    import torch
    torch.set_num_threads(1)
    # a rank stuck in a collective prints every thread's stack and exits
    faulthandler.dump_traceback_later(timeout, exit=True)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    try:
        mesh = None
        if mesh_shape:
            names = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
            mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
        cases = torch.load(cases_path, weights_only=False)
        results = [run_case(c, mesh) for c in cases]
        if rank == 0:
            torch.save(results, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cases")
    ap.add_argument("out")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--mesh", default="0")
    ap.add_argument("--timeout", type=float, default=500.0,
                    help="seconds after which every rank dumps its stack and exits")
    args = ap.parse_args()
    mesh_shape = tuple(int(x) for x in args.mesh.split(",")) if args.mesh != "0" else ()
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(args.world, mesh_shape, os.path.join(tmp, "store"),
                                  args.cases, args.out, args.timeout),
                 nprocs=args.world, join=True)


if __name__ == "__main__":
    main()
