"""Run the port's reduced models sharded over 4 gloo ranks (dp2 x tp2) and
print how far their logits are from the unsharded forward's.

    python tests/torch_mesh_worker.py CASE [CASE ...]

A case is ``ARCH[:kv1][+grad]``. 
Each rank builds the same float32 model from seed 0, runs it unsharded,
then places its parameters as DTensors by ``rules_for_config`` on a
(2, 2) ``("data", "model")`` mesh and runs the same tokens (batch-sharded)
under ``use_sharding``. ``:kv1`` cuts the KV heads to 1, so that they do
not divide the model axis (the GQA case of ``heads_local``); ``+grad``
compares the training loss's gradients of every parameter instead of the
logits. Each case prints ``CASE max_abs_err=<float>``, the largest over
the ranks. Imports no JAX (``tests/test_torch_launch.py`` runs it in a subprocess).
"""
import dataclasses
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _case(arch, mesh):
    """The largest |sharded - unsharded| of one case on this rank."""
    from repro_torch.launch.mesh import rules_for_config
    from repro_torch.models import registry
    from repro_torch.sharding.specs import (distribute, distribute_params,
                                            placements_for, use_sharding)
    from repro_torch.train.loop import make_grad_fn, trainable
    arch, grad = arch.removesuffix("+grad"), arch.endswith("+grad")
    name, _, variant = arch.partition(":")
    cfg = registry.load_config(name).reduced()
    if variant == "kv1":
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    model = registry.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 16), generator=g)
             for k in ("tokens", "labels")}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((4, cfg.encoder_frames, cfg.d_model),
                                      generator=g)
    rules = rules_for_config(cfg, mesh)

    def run(b):
        if grad:
            grads = make_grad_fn(cfg)(trainable(model), b)[0]
            return {n: g.detach() for n, g in grads.items()}
        with torch.no_grad():
            return {"logits": registry.forward(model, b)[0]}

    want = run(batch)
    distribute_params(model, mesh, rules)
    with use_sharding(mesh, rules):
        got = run({k: distribute(v, mesh, placements_for(
            mesh, rules.spec_for(("batch",) + (None,) * (v.ndim - 1))))
            for k, v in batch.items()})
    return max((got[n].full_tensor() - want[n]).abs().max().item()
               for n in want)


def _rank(rank, cases, port, out):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)    # 4 ranks on one host's cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        for arch in cases:
            err = torch.tensor([_case(arch, mesh)])
            dist.all_reduce(err, op=dist.ReduceOp.MAX)
            if rank == 0:
                out.put((arch, err.item()))
    finally:
        dist.destroy_process_group()


def main(cases) -> int:
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    mp.start_processes(_rank, args=(cases, _free_port(), out), nprocs=WORLD,
                       start_method="spawn")
    for _ in cases:
        arch, err = out.get()
        print(f"{arch} max_abs_err={err}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
